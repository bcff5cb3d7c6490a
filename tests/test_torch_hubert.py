"""hubert (continuous inputs, non-causal) in the port against the JAX
package (CPU).

hubert-xlarge-smoke's forward over ``frames_batch`` frames (its learned
positions ignore a three-row ``positions``, as JAX's do), the encoder's
masked loss (the current unit at each masked frame, no shift), one train
step and a few through the train launcher's batches, the Mango operator
steps (Eq. 7), and growth by every method into 4 x 128.  Neither package
serves it: the serving probe and the serve launcher refuse it in JAX's
words.  The train launcher hands it frames; JAX's hands it token chains,
which its forward cannot embed.  Params are JAX's init redrawn from
seeded numpy and converted; f32 logits and losses agree within
``F32_ATOL``.
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import F32_ATOL, port_config, redrawn_params
from repro.configs.base import get_config as jax_get_config
from repro.core import grow as jgrow
from repro.data.synthetic import frames_batch as jax_frames_batch
from repro.launch import serve as jax_launch_serve
from repro.launch import train as jax_launch_train
from repro.models import get_family as jax_family
from repro.optim import OptimizerConfig as JaxOptimizerConfig
from repro.optim import make_optimizer as jax_make_optimizer
from repro.train.loss import loss_for as jax_loss_for
from repro.train.loss import lm_loss as jax_lm_loss
from repro.train.steps import make_train_step as jax_make_train_step
from repro_torch.configs import get_config
from repro_torch.convert import from_jax, to_numpy
from repro_torch.core import grow
from repro_torch.data import frames_batch
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import serve_supported, transformer
from repro_torch.optim import OptimizerConfig, make_optimizer
from repro_torch.train.loss import lm_loss, loss_for
from repro_torch.train.steps import make_train_step
from repro_torch.utils.pytree import tree_flatten_with_paths

SMOKE = "hubert-xlarge-smoke"


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, atol=F32_ATOL, err_msg=""):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               err_msg=err_msg)


def _tree_close(got, want, atol=F32_ATOL):
    g = dict(tree_flatten_with_paths(to_numpy(got)))
    w = dict(tree_flatten_with_paths(jax.tree.map(np.asarray, want)))
    assert g.keys() == w.keys()
    for path in w:
        np.testing.assert_allclose(g[path], w[path], atol=atol, err_msg=path)


_MODEL = {}


def _model():
    if not _MODEL:
        jcfg = jax_get_config(SMOKE)
        _MODEL["m"] = (jcfg, port_config(jcfg), *redrawn_params(jcfg))
    return _MODEL["m"]


def _frames(cfg, B=2, S=24, seed=0, step=0):
    """A ``frames_batch`` as (numpy batch for JAX, tensors for the port);
    both packages draw it byte for byte alike."""
    b = jax_frames_batch(cfg.continuous_inputs, cfg.vocab_size, B, S,
                         seed=seed, step=step)
    return {k: jnp.asarray(v) for k, v in b.items()}, {
        k: _t(v) for k, v in b.items()}


def test_forward_matches_jax():
    """Logits over frames within F32_ATOL of JAX's; a three-row
    ``positions`` reaches no learned-position lookup (both packages then
    use arange), so the logits do not change."""
    jcfg, cfg, jp, tp = _model()
    jb, tb = _frames(cfg)
    want = jax_family(jcfg).forward(jp, jb, jcfg)[0]
    got, aux = transformer.forward(tp, tb, cfg)
    assert got.shape == (2, 24, cfg.vocab_size) and aux == {"moe_aux": 0.0}
    _close(got, want)
    pos3 = np.broadcast_to(np.arange(24, dtype=np.int32)[::-1],
                           (3, 2, 24)).copy()
    got3 = transformer.forward(tp, dict(tb, positions=_t(pos3)), cfg)[0]
    assert torch.equal(got3, got)
    _close(got3, jax_family(jcfg).forward(
        jp, dict(jb, positions=jnp.asarray(pos3)), jcfg)[0])


@pytest.mark.parametrize("masked", [False, True])
def test_encoder_loss_matches_jax(masked):
    """The non-causal LM loss predicts each frame's own unit (no shift),
    over the masked frames where a mask is given: loss and ce within
    2e-6 relative of JAX's."""
    jcfg, cfg, jp, tp = _model()
    jb, tb = _frames(cfg, seed=1)
    if masked:
        mask = (np.random.default_rng(2).random((2, 24)) < 0.3).astype(
            np.float32)
        jb, tb = dict(jb, mask=jnp.asarray(mask)), dict(tb, mask=_t(mask))
    jl, jaux = jax_family(jcfg).forward(jp, jb, jcfg)
    _, jm = jax_lm_loss(jl, jaux, jb, jcfg)
    tl, taux = transformer.forward(tp, tb, cfg)
    _, tm = lm_loss(tl, taux, tb, cfg)
    assert set(tm) == set(jm) == {"ce", "loss"}
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=2e-6,
                                   err_msg=k)


def test_train_step_matches_jax():
    """One AdamW step on a masked frames batch: loss, ce and grad_norm
    within 2e-5 relative, the gradients within F32_ATOL, the updated
    params within 1e-5 at lr 1e-4 (a gradient near Adam's eps turns a
    rounding difference into a step difference of up to lr)."""
    jcfg, cfg, jp, _ = _model()
    jb, tb = _frames(cfg, seed=3)
    mask = (np.random.default_rng(4).random((2, 24)) < 0.5).astype(
        np.float32)
    jb, tb = dict(jb, mask=jnp.asarray(mask)), dict(tb, mask=_t(mask))
    seen = {}

    def keep(side):
        def fn(grads):
            seen[side] = grads
            return grads
        return fn

    jopt = JaxOptimizerConfig(lr=1e-4)
    jinit, _ = jax_make_optimizer(jopt)
    jnew, _, jm = jax_make_train_step(jcfg, jopt, grad_transform=keep(
        "jax"))(jp, jinit(jp), jb, jnp.int32(1))
    opt = OptimizerConfig(lr=1e-4)
    init, _ = make_optimizer(opt)
    params = from_jax(jp)
    new, _, tm = make_train_step(cfg, opt, grad_transform=keep("port"))(
        params, init(params), tb, 1)
    assert tm.keys() == jm.keys()
    for k in ("loss", "ce", "grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=2e-5,
                                   err_msg=k)
    _tree_close(seen["port"], seen["jax"])
    _tree_close(new, jnew, atol=1e-5)


def test_train_steps_on_the_launchers_batches_match_jax():
    """The port's train launcher hands hubert ``frames_batch`` frames
    (JAX's hands it token chains: its forward then raises KeyError
    'inputs'); five steps of both packages' train steps on those batches,
    warmup-cosine and clipping: every step's metrics within 1e-5
    relative, the final params within 1e-4."""
    from repro.optim import schedules as jschedules
    from repro_torch.optim import schedules

    jcfg, cfg, jp, _ = _model()
    assert "inputs" not in next(jax_launch_train.data_for(jcfg, 2, 16))
    data = launch_train.data_for(cfg, 2, 16, seed=6)
    want = jax_frames_batch(cfg.continuous_inputs, cfg.vocab_size, 2, 16,
                            seed=6, step=0)
    first = next(data)
    assert first.keys() == want.keys() == {"inputs", "tokens"}
    for k in want:
        np.testing.assert_array_equal(first[k], want[k])
    jsched = jschedules.linear_warmup_cosine(3e-3, 2, 5)
    sched = schedules.linear_warmup_cosine(3e-3, 2, 5)
    jopt, opt = JaxOptimizerConfig(lr=3e-3), OptimizerConfig(lr=3e-3)
    jinit, _ = jax_make_optimizer(jopt, jsched)
    init, _ = make_optimizer(opt, sched)
    jstep = jax.jit(jax_make_train_step(jcfg, jopt, jsched))
    step = make_train_step(cfg, opt, sched)
    jparams, jstate = jp, jinit(jp)
    tparams = from_jax(jp)
    tstate = init(tparams)
    b = first
    for i in range(5):
        jparams, jstate, jm = jstep(jparams, jstate, {
            k: jnp.asarray(v) for k, v in b.items()}, jnp.int32(i + 1))
        tparams, tstate, tm = step(tparams, tstate, {
            k: _t(v) for k, v in b.items()}, i + 1)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-5, err_msg=f"step {i} {k}")
        b = next(data)
    _tree_close(tparams, jparams, atol=1e-4)


def test_train_launcher_trains_and_grows_hubert_on_cpu():
    """The launcher trains hubert-xlarge-smoke on frames, and grows it
    from itself by Mango: finite losses in the history."""
    _, hist = launch_train.train(SMOKE, steps=3, batch=2, seq=16,
                                 log_every=1, device="cpu",
                                 log_fn=lambda *a: None)
    assert len(hist) == 3 and all(np.isfinite(h["loss"]) for h in hist)
    _, hist = launch_train.train(SMOKE, steps=2, batch=2, seq=16,
                                 log_every=1, device="cpu", grow_from=SMOKE,
                                 grow_steps=2, log_fn=lambda *a: None)
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)


def _grow_pair(method):
    """hubert-xlarge-smoke (2 x 64) into 4 x 128 (8 heads of 16, the frame
    projection and learned positions widened too); StackBERT, which only
    grows depth, into 4 x 64."""
    js = jax_get_config(SMOKE)
    if method == "stackbert":
        return js, js.replace(name="hubert-smoke-deep", n_layers=4)
    return js, js.replace(name="hubert-smoke-big", n_layers=4, d_model=128,
                          n_heads=8, n_kv_heads=8, d_ff=320)


@pytest.mark.parametrize("method", jgrow.METHODS)
def test_grow_params_equals_jax(method):
    """Each method grows converted hubert smoke weights as JAX does
    (leaves within 1e-5: ``in_proj`` and ``pos_embed`` included), with
    JAX's operator params and trainable count; the grown encoder's
    logits over frames equal JAX's."""
    js, jt = _grow_pair(method)
    src = redrawn_params(js, seed=1)[0]
    jgop, jop = jgrow.build(method, js, jt, rank=1)
    want = jgrow.grow_params(jgop, jop, src)
    gop, _ = grow.build(method, port_config(js), port_config(jt), rank=1,
                        device="cpu")
    op_params = from_jax(jax.tree.map(np.asarray, jop))
    got = grow.grow_params(gop, op_params, from_jax(src))
    _tree_close(got, want, atol=1e-5)
    assert grow.operator_param_count(gop, op_params) == \
        jgrow.operator_param_count(jgop, jop)
    assert gop.trainable == jgop.trainable
    jb, tb = _frames(jt, seed=7)
    _close(transformer.forward(got, tb, port_config(jt))[0],
           jax_family(jt).forward(want, jb, jt)[0], atol=1e-4)


def test_operator_steps_follow_jax():
    """Three bare-AdamW Mango operator steps (Eq. 7) into 4 x 128 on
    frames batches: losses within 2e-5 relative, the trained operator
    within 1e-4."""
    js, jt = _grow_pair("mango")
    ts, tt = port_config(js), port_config(jt)
    src = redrawn_params(js, seed=4)[0]
    jgop, jop = jgrow.build("mango", js, jt, rank=1)
    jfam, jloss = jax_family(jt), jax_loss_for(jt)
    batches = [_frames(jt, seed=9, step=i) for i in range(3)]

    def jax_op_loss(big, b):
        logits, aux = jfam.forward(big, b, jt)
        return jloss(logits, aux, b, jt)[0]

    op0 = from_jax(jax.tree.map(np.asarray, jop))
    jop, jlosses = jgrow.train_operator(
        jgop, jop, src, jax_op_loss, iter(b[0] for b in batches), steps=3)
    gop, _ = grow.build("mango", ts, tt, rank=1, device="cpu")
    loss = loss_for(tt)

    def op_loss(big, b):
        logits, aux = transformer.forward(big, b, tt)
        return loss(logits, aux, b, tt)[0]

    op, losses = grow.train_operator(gop, op0, from_jax(src), op_loss,
                                     iter(b[1] for b in batches), steps=3)
    np.testing.assert_allclose(losses, jlosses, rtol=2e-5)
    _tree_close(op, jop, atol=1e-4)


def test_serving_refused_as_jax_refuses(monkeypatch):
    """Neither package serves an encoder over continuous inputs: the
    probe's answer and the serve launcher's refusal equal JAX's."""
    jcfg, cfg = jax_get_config(SMOKE), get_config(SMOKE)
    assert serve_supported(cfg) == jax_family(jcfg).serve_supported(jcfg)
    assert not serve_supported(cfg)[0]
    argv = ["--arch", SMOKE, "--engine", "continuous"]
    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    with pytest.raises(SystemExit) as want:
        jax_launch_serve.main()
    with pytest.raises(SystemExit) as got:
        launch_serve.main(argv + ["--device", "cpu"])
    # the list of servable configs follows each package's registry, which
    # other test files of the same process may have grown (train_100m's)
    head = "Servable registered configs: "
    got_head, got_list = str(got.value).split(head)
    want_head, want_list = str(want.value).split(head)
    assert got_head == want_head
    assert "requires a causal token LM" in got_head
    for names in (got_list, want_list):
        assert SMOKE not in names and "qwen2-vl-72b-smoke" in names


def test_frames_batch_feeds_the_full_width_encoder_shape():
    """hubert-xlarge's frames are 1,280 wide, as ``in_proj`` takes them;
    its forward at a cut depth gives finite logits over 504 units."""
    cfg = get_config("hubert-xlarge").replace(
        n_layers=1, param_dtype="float32", compute_dtype="float32")
    params = transformer.init(torch.Generator().manual_seed(0), cfg)
    assert tuple(params["in_proj"].shape) == (1280, 1280)
    b = frames_batch(cfg.continuous_inputs, cfg.vocab_size, 1, 8, seed=0)
    with torch.no_grad():
        logits = transformer.forward(params, {"inputs": _t(b["inputs"])},
                                     cfg)[0]
    assert logits.shape == (1, 8, 504) and bool(torch.isfinite(logits).all())
