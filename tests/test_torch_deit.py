"""The port's DeiT path (the paper's headline setting, at micro scale)
against the JAX package on the CPU: vision and frame batches, the train
launcher's ``cls`` data, the train step on ``cls`` batches, the forward,
growth deit-micro -> deit-micro-big and its operator steps, and the
grown launcher run.

Params and operator params are made by JAX and converted with
``from_jax``; batches come from the data modules of both packages, seeded.
f32 tolerance 2e-5 (the frameworks sum in different orders) unless a test
says otherwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import F32_ATOL, jax_params, port_config
from repro.configs.base import get_config as jax_get_config
from repro.core import grow as jgrow
from repro.data import synthetic as jsynthetic
from repro.launch import train as jax_train
from repro.models import get_family as jax_family
from repro.optim import OptimizerConfig as JaxOptimizerConfig
from repro.optim import make_optimizer as jax_make_optimizer
from repro.optim import schedules as jschedules
from repro.train.steps import make_grow_step as jax_make_grow_step
from repro.train.steps import make_train_step as jax_make_train_step
from repro_torch.convert import from_jax, to_numpy
from repro_torch.core import grow
from repro_torch.data import frames_batch, vision_batch
from repro_torch.launch import train as launch_train
from repro_torch.models import get_family
from repro_torch.optim import OptimizerConfig, make_optimizer, schedules
from repro_torch.train.steps import make_grow_step, make_train_step
from repro_torch.utils.pytree import tree_flatten_with_paths

SRC, TGT = "deit-micro", "deit-micro-big"


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_trees_close(got, want, atol=F32_ATOL):
    g = dict(tree_flatten_with_paths(to_numpy(got)))
    w = dict(tree_flatten_with_paths(_np_tree(want)))
    assert g.keys() == w.keys()
    for path in w:
        assert g[path].shape == w[path].shape, path
        np.testing.assert_allclose(g[path], w[path], atol=atol, err_msg=path)


def _cls_batches(name, n, batch=4, seed=0, start_step=0):
    """JAX's own ``data_for`` batches of a ``cls`` config (numpy)."""
    it = jax_train.data_for(jax_get_config(name), batch, None, seed=seed,
                            start_step=start_step)
    return [next(it) for _ in range(n)]


def _tensors(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _same_bytes(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k


@pytest.mark.parametrize("seed,step,shard,args", [
    (0, 0, 0, (16, 3, 32, 8)), (3, 7, 1, (1000, 2, 224, 16)),
    (11, 2, 5, (10, 5, 48, 16))])
def test_vision_batch_byte_identical(seed, step, shard, args):
    _same_bytes(vision_batch(*args, seed=seed, step=step, shard=shard),
                jsynthetic.vision_batch(*args, seed=seed, step=step,
                                        shard=shard))


@pytest.mark.parametrize("seed,step,shard,args", [
    (0, 0, 0, (24, 31, 2, 16)), (5, 9, 2, (64, 997, 3, 40))])
def test_frames_batch_byte_identical(seed, step, shard, args):
    _same_bytes(frames_batch(*args, seed=seed, step=step, shard=shard),
                jsynthetic.frames_batch(*args, seed=seed, step=step,
                                        shard=shard))


@pytest.mark.parametrize("start_step", [0, 5])
def test_data_for_cls_equals_jax(start_step):
    """The launcher's vision batches for deit-micro (patches cut to
    ``continuous_inputs`` and ``learned_pos - 1``) from ``start_step``."""
    cfg = port_config(jax_get_config(SRC))
    it = launch_train.data_for(cfg, 3, None, seed=2, start_step=start_step)
    want = _cls_batches(SRC, 3, batch=3, seed=2, start_step=start_step)
    for w in want:
        got = next(it)
        _same_bytes(got, w)
    assert want[0]["inputs"].shape == (3, 64, 48)


def test_cls_train_step_follows_jax():
    """Three deit-micro steps (warmup-cosine, clipping) on JAX's own
    ``data_for`` batches: every step's metrics equal JAX's (1e-5 relative)
    and the final params agree to 1e-4, the trajectory tolerances of
    test_torch_train.  One microbatch takes no split, so a ``cls`` batch
    (no "tokens") trains."""
    jcfg = jax_get_config(SRC)
    params = jax_params(jcfg, seed=5)
    jopt, opt = JaxOptimizerConfig(lr=3e-3), OptimizerConfig(lr=3e-3)
    jsched = jschedules.linear_warmup_cosine(3e-3, 1, 3)
    sched = schedules.linear_warmup_cosine(3e-3, 1, 3)
    jinit, _ = jax_make_optimizer(jopt, jsched)
    init, _ = make_optimizer(opt, sched)
    jstep = jax.jit(jax_make_train_step(jcfg, jopt, jsched))
    step = make_train_step(port_config(jcfg), opt, sched)
    jp, js = params, jinit(params)
    tp = from_jax(params)
    ts = init(tp)
    for i, b in enumerate(_cls_batches(SRC, 3, seed=6)):
        jp, js, jm = jstep(jp, js, jax.tree.map(jnp.asarray, b),
                           jnp.int32(i + 1))
        tp, ts, tm = step(tp, ts, _tensors(b), i + 1)
        assert tm.keys() == jm.keys() == {"loss", "acc", "grad_norm", "lr"}
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-5, err_msg=f"step {i} {k}")
    _assert_trees_close(tp, jp, atol=1e-4)


def test_microbatched_cls_batch_raises_in_both_packages():
    """Past one microbatch both packages read the global batch size from
    "tokens", so a ``cls`` batch raises ``KeyError: 'tokens'`` in each (a
    reference fault, ROADMAP §3)."""
    jcfg = jax_get_config(SRC)
    params = jax_params(jcfg, seed=1)
    b = _cls_batches(SRC, 1)[0]
    jopt = JaxOptimizerConfig()
    jstep = jax_make_train_step(jcfg, jopt, n_microbatches=2)
    with pytest.raises(KeyError, match="tokens"):
        jstep(params, jax_make_optimizer(jopt)[0](params),
              jax.tree.map(jnp.asarray, b), jnp.int32(1))
    opt = OptimizerConfig()
    tp = from_jax(params)
    step = make_train_step(port_config(jcfg), opt, n_microbatches=2)
    with pytest.raises(KeyError, match="tokens"):
        step(tp, make_optimizer(opt)[0](tp), _tensors(b), 1)


@pytest.mark.parametrize("name", [SRC, TGT])
def test_deit_forward_equals_jax(name):
    """Logits (B, n_classes) on vision batches, every leaf redrawn (2e-5)."""
    jcfg = jax_get_config(name)
    params = jax_params(jcfg, seed=3, randomize=True)
    b = _cls_batches(name, 1, batch=3, seed=4)[0]
    want, _ = jax_family(jcfg).forward(params, jax.tree.map(jnp.asarray, b),
                                       jcfg)
    cfg = port_config(jcfg)
    got, _ = get_family(cfg).forward(from_jax(params), _tensors(b), cfg)
    assert got.shape == (3, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_ATOL)


@pytest.mark.parametrize("method", ["mango", "bert2bert"])
def test_deit_growth_equals_jax(method):
    """deit-micro -> deit-micro-big with JAX's operator params; the width
    leaves (``in_proj``, ``cls_token``, ``pos_embed``, ``head``) grow with
    the blocks (2e-5)."""
    js, jt = jax_get_config(SRC), jax_get_config(TGT)
    src = jax_params(js, seed=1, randomize=True)
    jgop, jop = jgrow.build(method, js, jt, rank=1)
    want = jgrow.grow_params(jgop, jop, src)
    gop, _ = grow.build(method, port_config(js), port_config(jt), rank=1,
                        device="cpu")
    got = grow.grow_params(gop, from_jax(_np_tree(jop)), from_jax(src))
    _assert_trees_close(got, want)
    assert got["in_proj"].shape == (48, 128)
    assert got["cls_token"].shape == (128,)
    assert got["head"].shape == (128, 16)


def test_deit_grow_steps_follow_jax():
    """Two ``make_grow_step`` updates on vision batches: loss and grad norm
    (1e-5 and 1e-4 relative) and the operator (1e-4) equal JAX's."""
    js, jt = jax_get_config(SRC), jax_get_config(TGT)
    src = jax_params(js, seed=2)
    jgop, jop = jgrow.build("mango", js, jt, rank=1)
    jopt = JaxOptimizerConfig(lr=1e-3)
    jinit, _ = jax_make_optimizer(jopt)
    jstep = jax.jit(jax_make_grow_step(jgop, jt, jopt))
    gop, _ = grow.build("mango", port_config(js), port_config(jt), rank=1,
                        device="cpu")
    opt = OptimizerConfig(lr=1e-3)
    step = make_grow_step(gop, port_config(jt), opt)
    op_params, tsrc = from_jax(_np_tree(jop)), from_jax(src)
    state, jstate = make_optimizer(opt)[0](op_params), jinit(jop)
    for i, b in enumerate(_cls_batches(TGT, 2, seed=7)):
        jop, jstate, jm = jstep(jop, jstate, src,
                                jax.tree.map(jnp.asarray, b),
                                jnp.int32(i + 1))
        op_params, state, m = step(op_params, state, tsrc, _tensors(b),
                                   i + 1)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
    _assert_trees_close(op_params, jop, atol=1e-4)


def test_train_launcher_grows_deit_on_cpu():
    """``train`` grows deit-micro-big from deit-micro (two operator steps)
    and trains it three steps on vision batches: finite losses."""
    logs = []
    params, hist = launch_train.train(
        TGT, grow_from=SRC, grow_steps=2, steps=3, batch=4, log_every=1,
        device="cpu", log_fn=logs.append)
    assert any(m.startswith("[grow] mango operator trained 2 steps")
               for m in logs)
    assert [h["step"] for h in hist] == [0, 1, 2]
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert params["head"].shape == (128, 16)
