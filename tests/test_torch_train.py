"""The port's training path against the JAX package on the CPU: losses,
AdamW (bare and configurable, schedule included), the train and eval
steps, and the train launcher.

Params are made by JAX and converted with ``from_jax``; other inputs come
from seeded numpy.  Tolerances are stated per test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import F32_ATOL, jax_params, port_config
from repro.configs.base import get_config as jax_get_config
from repro.models import get_family as jax_family
from repro.optim import OptimizerConfig as JaxOptimizerConfig
from repro.optim import adamw as jadamw
from repro.optim import schedules as jschedules
from repro.train import loss as jloss
from repro.train.steps import make_eval_step as jax_make_eval_step
from repro.train.steps import make_train_step as jax_make_train_step
from repro_torch.convert import from_jax, to_numpy
from repro_torch.data import lm_data_iter
from repro_torch.launch import train as launch_train
from repro_torch.optim import OptimizerConfig, adamw, schedules
from repro_torch.train import loss
from repro_torch.train.steps import make_eval_step, make_train_step
from repro_torch.utils.pytree import tree_flatten_with_paths, tree_map


def _close_trees(got, want, **tol):
    g = dict(tree_flatten_with_paths(to_numpy(got)))
    w = dict(tree_flatten_with_paths(jax.tree.map(np.asarray, want)))
    assert g.keys() == w.keys()
    for path in w:
        np.testing.assert_allclose(g[path].astype(np.float32),
                                   w[path].astype(np.float32), err_msg=path,
                                   **tol)


@pytest.mark.parametrize("causal,masked", [(True, False), (False, True),
                                           (False, False)])
def test_lm_loss_equals_jax(causal, masked):
    """z-loss 1e-4 and an f32 logsumexp; the non-causal (encoder) stream
    with and without a mask (f32, 1e-6 relative)."""
    rng = np.random.default_rng(0)
    logits = (3 * rng.standard_normal((3, 9, 37))).astype(np.float32)
    batch = {"tokens": rng.integers(0, 37, (3, 9)).astype(np.int32)}
    if masked:
        batch["mask"] = (rng.random((3, 9)) < 0.3).astype(np.float32)
    jcfg = jax_get_config("gpt-micro").replace(causal=causal)
    want_l, want_m = jloss.lm_loss(jnp.asarray(logits), {"moe_aux": 0.0},
                                   {k: jnp.asarray(v)
                                    for k, v in batch.items()}, jcfg)
    got_l, got_m = loss.lm_loss(torch.from_numpy(logits), {"moe_aux": 0.0},
                                {k: torch.from_numpy(v)
                                 for k, v in batch.items()},
                                port_config(jcfg))
    assert got_m.keys() == want_m.keys()
    for k in want_m:
        np.testing.assert_allclose(float(got_m[k]), float(want_m[k]),
                                   rtol=1e-6)
    np.testing.assert_allclose(float(got_l), float(want_l), rtol=1e-6)


def test_cls_loss_equals_jax():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((6, 10)).astype(np.float32)
    labels = rng.integers(0, 10, (6,)).astype(np.int32)
    jcfg = jax_get_config("deit-micro")
    _, want = jloss.cls_loss(jnp.asarray(logits), {},
                             {"labels": jnp.asarray(labels)}, jcfg)
    _, got = loss.loss_for(port_config(jcfg))(
        torch.from_numpy(logits), {}, {"labels": torch.from_numpy(labels)},
        port_config(jcfg))
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6)


def test_schedules_equal_jax():
    """Warmup then cosine, and plain cosine, at every step (1e-6 relative:
    the reference computes in f32)."""
    pairs = [(jschedules.linear_warmup_cosine(3e-4, 20, 100),
              schedules.linear_warmup_cosine(3e-4, 20, 100)),
             (jschedules.cosine_schedule(1e-3, 50, 0.2),
              schedules.cosine_schedule(1e-3, 50, 0.2))]
    for want, got in pairs:
        for step in range(0, 121, 7):
            np.testing.assert_allclose(got(step),
                                       float(want(jnp.float32(step))),
                                       rtol=1e-6)


def _opt_inputs(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    params = {"a": {"w": rng.standard_normal((5, 7)).astype(dtype)},
              "b": rng.standard_normal((11,)).astype(dtype)}
    grads = [jax.tree.map(lambda p: (0.5 * rng.standard_normal(p.shape))
                          .astype(dtype), params) for _ in range(3)]
    return params, grads


@pytest.mark.parametrize("kind", ["clip+schedule", "no-clip",
                                  "bf16 moments+master"])
def test_make_optimizer_equals_jax(kind):
    """Three updates: params, state and the grad_norm/lr metrics equal JAX's
    (f32 1e-6; bf16 moments 1e-2, one bf16 rounding)."""
    kw = {"clip+schedule": dict(clip_norm=0.5),
          "no-clip": dict(clip_norm=None),
          "bf16 moments+master": dict(moment_dtype="bfloat16",
                                      master_weights=True)}[kind]
    sched = kind == "clip+schedule"
    params, grads = _opt_inputs(2)
    jinit, jupd = jadamw.make_optimizer(
        JaxOptimizerConfig(lr=1e-2, **kw),
        jschedules.linear_warmup_cosine(1e-2, 2, 10) if sched else None)
    init, upd = adamw.make_optimizer(
        OptimizerConfig(lr=1e-2, **kw),
        schedules.linear_warmup_cosine(1e-2, 2, 10) if sched else None)
    jp, js = params, jinit(params)
    tp = from_jax(params)
    ts = init(tp)
    tol = dict(atol=1e-6, rtol=1e-6) if "bf16" not in kind else \
        dict(atol=1e-2, rtol=1e-2)
    for step, g in enumerate(grads, 1):
        jp, js, jm = jupd(jp, js, g, jnp.int32(step))
        tp, ts, tm = upd(tp, ts, from_jax(g), step)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
    _close_trees(tp, jp, atol=1e-6, rtol=1e-6)
    _close_trees(ts, js, **tol)


@pytest.mark.parametrize("kind", ["clip+schedule", "bf16 moments+master"])
def test_sliced_update_equals_the_whole_leaf_update(monkeypatch, kind):
    """A leaf past ``SLICE_ELEMS`` updates a slice of its leading axis at
    a time (the largest xlstm-1.3b leaves would otherwise hold several
    2.8 GB temporaries): three updates equal the whole-leaf route bit for
    bit, clipped and with bf16 moments and a master copy alike; 0-d and
    1-d leaves update whole."""
    kw = {"clip+schedule": dict(clip_norm=0.5),
          "bf16 moments+master": dict(moment_dtype="bfloat16",
                                      master_weights=True)}[kind]
    params, grads = _opt_inputs(4)
    runs = []
    for limit in (adamw.SLICE_ELEMS, 7):
        monkeypatch.setattr(adamw, "SLICE_ELEMS", limit)
        init, upd = adamw.make_optimizer(
            OptimizerConfig(lr=1e-2, **kw),
            schedules.linear_warmup_cosine(1e-2, 2, 10))
        tp = from_jax(params)
        ts = init(tp)
        for step, g in enumerate(grads, 1):
            tp, ts, _ = upd(tp, ts, from_jax(g), step)
        runs.append({"params": tp, "state": ts})
    assert any(len(adamw._slices(t)) > 1
               for _, t in tree_flatten_with_paths(runs[1]["params"]))
    for (pa, a), (pb, b) in zip(tree_flatten_with_paths(runs[0]),
                                tree_flatten_with_paths(runs[1])):
        assert pa == pb and torch.equal(a, b), pa


def test_bare_adamw_equals_jax():
    params, grads = _opt_inputs(3)
    jp, js = params, jadamw.adamw_init(params)
    tp = from_jax(params)
    ts = adamw.adamw_init(tp)
    for step, g in enumerate(grads, 1):
        jp, js = jadamw.adamw_update(jp, js, g, jnp.int32(step), lr=1e-2,
                                     weight_decay=1e-2)
        tp, ts = adamw.adamw_update(tp, ts, from_jax(g), step, lr=1e-2,
                                    weight_decay=1e-2)
    _close_trees(tp, jp, atol=1e-6, rtol=1e-6)
    _close_trees(ts, js, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("n_micro", [1, 2])
def test_train_step_follows_jax(n_micro):
    """20 gpt-micro steps on ``lm_data_iter`` with warmup-cosine and
    clipping: every step's loss, ce, grad_norm and lr equal JAX's (1e-5
    relative) and the final params agree to 1e-4 (Adam's per-leaf
    normalisation lifts rounding in near-zero gradients to lr scale)."""
    jcfg = jax_get_config("gpt-micro")
    cfg = port_config(jcfg)
    params = jax_params(jcfg, seed=5)
    jopt, opt = JaxOptimizerConfig(lr=3e-3), OptimizerConfig(lr=3e-3)
    jsched = jschedules.linear_warmup_cosine(3e-3, 5, 20)
    sched = schedules.linear_warmup_cosine(3e-3, 5, 20)
    jinit, _ = jadamw.make_optimizer(jopt, jsched)
    init, _ = adamw.make_optimizer(opt, sched)
    jstep = jax.jit(jax_make_train_step(jcfg, jopt, jsched,
                                        n_microbatches=n_micro))
    step = make_train_step(cfg, opt, sched, n_microbatches=n_micro)
    jp, js = params, jinit(params)
    tp = from_jax(params)
    ts = init(tp)
    data = lm_data_iter(cfg.vocab_size, 4, 32, seed=6)
    for i in range(20):
        b = next(data)
        jp, js, jm = jstep(jp, js, {"tokens": jnp.asarray(b["tokens"])},
                           jnp.int32(i + 1))
        tp, ts, tm = step(tp, ts, {"tokens": torch.from_numpy(b["tokens"])},
                          i + 1)
        assert tm.keys() == jm.keys() == {"loss", "ce", "grad_norm", "lr"}
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-5, err_msg=f"step {i} {k}")
    _close_trees(tp, jp, atol=1e-4)


def test_train_step_grad_transform_equals_jax():
    """``grad_transform`` sees the microbatch-averaged f32 grads once per
    step; halving them gives JAX's params (no clipping; 1e-4, as Adam's
    first step is lr x the gradient's sign and rounding can flip a
    near-zero gradient's)."""
    jcfg = jax_get_config("gpt-micro")
    params = jax_params(jcfg, seed=7)
    toks = next(lm_data_iter(jcfg.vocab_size, 4, 16, seed=1))["tokens"]
    jopt = JaxOptimizerConfig(clip_norm=None)
    jinit, _ = jadamw.make_optimizer(jopt)
    jstep = jax_make_train_step(
        jcfg, jopt, n_microbatches=2,
        grad_transform=lambda g: jax.tree.map(lambda x: 0.5 * x, g))
    want, _, _ = jstep(params, jinit(params), {"tokens": jnp.asarray(toks)},
                       jnp.int32(1))
    seen = []

    def halve(grads):
        seen.append(grads)
        return tree_map(lambda x: 0.5 * x, grads)

    opt = OptimizerConfig(clip_norm=None)
    init, _ = adamw.make_optimizer(opt)
    tp = from_jax(params)
    step = make_train_step(port_config(jcfg), opt, n_microbatches=2,
                           grad_transform=halve)
    got, _, _ = step(tp, init(tp), {"tokens": torch.from_numpy(toks)}, 1)
    assert len(seen) == 1 and seen[0]["embed"].dtype == torch.float32
    _close_trees(got, want, atol=1e-4)


def test_eval_step_equals_jax():
    jcfg = jax_get_config("gpt-micro-big")
    params = jax_params(jcfg, seed=8, randomize=True)
    toks = np.random.default_rng(9).integers(0, jcfg.vocab_size, (3, 20)) \
        .astype(np.int32)
    want = jax_make_eval_step(jcfg)(params, {"tokens": jnp.asarray(toks)})
    got = make_eval_step(port_config(jcfg))(
        from_jax(params), {"tokens": torch.from_numpy(toks)})
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   atol=F32_ATOL, rtol=1e-6)


def test_train_launcher_runs_on_cpu_and_history_drops():
    """``train`` on the CPU: fresh and grown; the loss falls over 30 steps
    of gpt-micro."""
    _, hist = launch_train.train("gpt-micro", steps=30, batch=4, seq=32,
                                 lr=3e-3, warmup=5, log_every=29,
                                 device="cpu", log_fn=lambda *_: None)
    assert [h["step"] for h in hist] == [0, 29]
    assert hist[-1]["loss"] < hist[0]["loss"]
    params, hist = launch_train.train(
        "gpt-micro-big", steps=2, batch=2, seq=16, grow_from="gpt-micro",
        grow_steps=2, device="cpu", log_fn=lambda *_: None)
    assert params["embed"].shape == (997, 128)
    assert np.isfinite(hist[-1]["loss"])


@pytest.mark.parametrize("opt_kw", [{}, {"clip_norm": None},
                                    {"moment_dtype": "bfloat16",
                                     "master_weights": True}])
def test_train_step_updates_in_place_as_jax_donates(opt_kw):
    """The step updates params and moments in place and returns the trees
    it was given (the reference launcher's step donates them), leaves the
    grads it saw unscaled, and follows JAX's step over four steps of
    warmup-cosine: metrics 1e-5 relative, params 1e-4 (as in
    ``test_train_step_follows_jax``), moments 1e-4 (bf16 moments 1e-2,
    one bf16 rounding)."""
    jcfg = jax_get_config("gpt-micro")
    cfg = port_config(jcfg)
    params = jax_params(jcfg, seed=11)
    jopt, opt = JaxOptimizerConfig(lr=3e-3, **opt_kw), \
        OptimizerConfig(lr=3e-3, **opt_kw)
    jsched = jschedules.linear_warmup_cosine(3e-3, 2, 4)
    sched = schedules.linear_warmup_cosine(3e-3, 2, 4)
    jinit, _ = jadamw.make_optimizer(jopt, jsched)
    init, _ = adamw.make_optimizer(opt, sched)
    jstep = jax.jit(jax_make_train_step(jcfg, jopt, jsched))
    seen = []

    def keep(grads):
        seen.append(tree_map(torch.clone, grads))
        seen.append(grads)
        return grads

    step = make_train_step(cfg, opt, sched, grad_transform=keep)
    jp, js = params, jinit(params)
    tp = from_jax(params)
    ts = init(tp)
    data = lm_data_iter(cfg.vocab_size, 4, 16, seed=12)
    for i in range(4):
        b = next(data)
        jp, js, jm = jstep(jp, js, {"tokens": jnp.asarray(b["tokens"])},
                           jnp.int32(i + 1))
        new_p, new_s, tm = step(tp, ts, {"tokens": torch.from_numpy(
            b["tokens"])}, i + 1)
        assert new_p is tp and new_s is ts
        before, after = seen[-2:]
        for path, g in tree_flatten_with_paths(before):
            assert torch.equal(g, dict(tree_flatten_with_paths(after))[path])
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-5, err_msg=f"step {i} {k}")
    _close_trees(tp, jp, atol=1e-4)
    tol = 1e-2 if "moment_dtype" in opt_kw else 1e-4
    _close_trees(ts, js, atol=tol, rtol=tol)
