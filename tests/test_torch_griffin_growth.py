"""Griffin growth and training in the port against the JAX package on the
CPU: ``griffin.param_shapes`` (the meta-device init) against JAX's
``eval_shape``, the packing plans of the griffin pair (griffin-micro ->
griffin-micro-big), every growth method, the operator's Eq. 7 steps, the
train step, the train launcher grown from one checkpoint, and the scan's
backward (``ref.rglru_scan_bwd_ref``, which ``ops.RglruScan`` runs on the
CPU) against autograd through the plain forward.

Params and operator params are made by JAX and converted with
``from_jax``; other inputs come from seeded numpy.  f32 tolerance 2e-5
(the frameworks sum in different orders) unless a test says otherwise.
"""
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import F32_ATOL, jax_params, port_config
from repro.configs.base import get_config as jax_get_config
from repro.core import grow as jgrow
from repro.core import packing as jpacking
from repro.launch import train as jax_train
from repro.models import get_family as jax_family
from repro.optim import OptimizerConfig as JaxOptimizerConfig
from repro.optim import make_optimizer as jax_make_optimizer
from repro.train.loss import loss_for as jax_loss_for
from repro.train.steps import make_train_step as jax_make_train_step
from repro_torch.convert import from_jax, to_numpy
from repro_torch.core import grow, packing
from repro_torch.data import lm_data_iter
from repro_torch.kernels import ops, ref
from repro_torch.launch import train as launch_train
from repro_torch.models import get_family, griffin
from repro_torch.optim import OptimizerConfig, make_optimizer
from repro_torch.train.loss import loss_for
from repro_torch.train.steps import make_train_step
from repro_torch.utils.pytree import tree_flatten_with_paths, tree_map

SRC, TGT = "griffin-micro", "griffin-micro-big"


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_trees_close(got, want, atol=F32_ATOL):
    g = dict(tree_flatten_with_paths(to_numpy(got)))
    w = dict(tree_flatten_with_paths(_np_tree(want)))
    assert g.keys() == w.keys()
    for path in w:
        assert g[path].shape == w[path].shape, path
        np.testing.assert_allclose(g[path], w[path], atol=atol, err_msg=path)


def _cfgs(method="mango"):
    """(jax src, jax tgt, port src, port tgt); StackBERT grows depth only,
    so its target is griffin-micro at twice the depth."""
    js = jax_get_config(SRC)
    jt = js.replace(name="deep", n_layers=2 * js.n_layers) \
        if method == "stackbert" else jax_get_config(TGT)
    return js, jt, port_config(js), port_config(jt)


def _jax_shapes(jcfg):
    return jax.eval_shape(lambda: jax_family(jcfg).init(
        jax.random.PRNGKey(0), jcfg))


@pytest.mark.parametrize("name", [SRC, TGT, "recurrentgemma-2b",
                                  "recurrentgemma-2b-smoke"])
def test_param_shapes_equal_jax_eval_shape(name):
    """The meta-device init's tree and shapes are JAX's ``eval_shape``'s
    (recurrentgemma-2b's 2.7 B parameters: nothing is drawn)."""
    jcfg = jax_get_config(name)
    want = {p: tuple(s.shape) for p, s in
            tree_flatten_with_paths(jax.tree.map(lambda s: s, _jax_shapes(
                jcfg)))}
    got = dict(tree_flatten_with_paths(
        griffin.param_shapes(port_config(jcfg))))
    assert {p: tuple(s) for p, s in got.items()} == want


def _plan_rows(plan):
    return ([(g.name, g.n_layers,
              [(s.path, s.kind, tuple(s.leaf_shape), s.ti, s.tj, s.expert)
               for s in g.slots],
              [(v.path, tuple(v.leaf_shape)) for v in g.vectors])
             for g in plan.groups],
            [(w.path, tuple(w.leaf_shape)) for w in plan.widths], plan.d_model)


@pytest.mark.parametrize("name", [SRC, TGT])
def test_build_plan_equals_jax(name):
    """Griffin's block groups (rec_blocks, attn_blocks), slot for slot, the
    block-diagonal gates included, and its vector and width leaves."""
    jcfg = jax_get_config(name)
    cfg = port_config(jcfg)
    want = jpacking.build_plan(jcfg, _jax_shapes(jcfg))
    got = packing.build_plan(cfg, griffin.param_shapes(cfg))
    assert [g.name for g in got.groups] == ["rec_blocks", "attn_blocks"]
    assert _plan_rows(got) == _plan_rows(want)


@pytest.mark.parametrize("method", jgrow.METHODS)
def test_grow_params_equals_jax(method):
    """Every method grows converted griffin-micro weights into
    griffin-micro-big (StackBERT: into a griffin-micro of twice the depth)
    as JAX does, with JAX's operator params and trainable count."""
    js, jt, ts, tt = _cfgs(method)
    src = jax_params(js, seed=1)
    jgop, jop = jgrow.build(method, js, jt, rank=1)
    want = jgrow.grow_params(jgop, jop, src)
    gop, _ = grow.build(method, ts, tt, rank=1, device="cpu")
    op_params = from_jax(_np_tree(jop))
    got = grow.grow_params(gop, op_params, from_jax(src))
    _assert_trees_close(got, want)
    assert grow.operator_param_count(gop, op_params) == \
        jgrow.operator_param_count(jgop, jop)
    assert gop.trainable == jgop.trainable


def test_stackbert_refuses_the_width_pair_as_jax_does():
    """StackBERT grows depth only: both packages refuse griffin-micro ->
    griffin-micro-big."""
    js, jt = jax_get_config(SRC), jax_get_config(TGT)
    with pytest.raises(AssertionError, match="StackBERT only grows depth"):
        jgrow.build("stackbert", js, jt, rank=1)
    with pytest.raises(ValueError, match="StackBERT only grows depth"):
        grow.build("stackbert", port_config(js), port_config(jt), rank=1,
                   device="cpu")


def _batches(vocab, seed, n, batch=2, seq=24):
    it = lm_data_iter(vocab, batch, seq, seed=seed)
    return [next(it) for _ in range(n)]


@pytest.mark.parametrize("method", ["mango", "ligo"])
def test_train_operator_follows_jax(method):
    """Three bare-AdamW operator steps (Eq. 7) over griffin: the losses
    (2e-5 relative) and the trained operator (1e-4) equal JAX's."""
    js, jt, ts, tt = _cfgs(method)
    src = jax_params(js, seed=4)
    jgop, jop = jgrow.build(method, js, jt, rank=1)
    jfam, jloss = jax_family(jt), jax_loss_for(jt)
    batches = _batches(tt.vocab_size, 9, 3)

    def jax_op_loss(big, b):
        logits, aux = jfam.forward(big, b, jt)
        return jloss(logits, aux, b, jt)[0]

    op0 = from_jax(_np_tree(jop))
    jop, jlosses = jgrow.train_operator(
        jgop, jop, src, jax_op_loss,
        iter({"tokens": jnp.asarray(b["tokens"])} for b in batches), steps=3)
    gop, _ = grow.build(method, ts, tt, rank=1, device="cpu")
    fam, loss = get_family(tt), loss_for(tt)

    def op_loss(big, b):
        logits, aux = fam.forward(big, b, tt)
        return loss(logits, aux, b, tt)[0]

    op_params, losses = grow.train_operator(gop, op0, from_jax(src), op_loss,
                                            iter(batches), steps=3)
    np.testing.assert_allclose(losses, jlosses, rtol=2e-5)
    _assert_trees_close(op_params, jop, atol=1e-4)


def test_train_step_loss_and_grads_equal_jax():
    """One griffin-micro-big train step (the scan's backward through
    ``ops.RglruScan``): loss, ce and grad_norm equal JAX's (2e-5
    relative), and the gradients seen by ``grad_transform`` equal JAX's
    (2e-5)."""
    jcfg = jax_get_config(TGT)
    params = jax_params(jcfg, seed=5)
    toks = next(lm_data_iter(jcfg.vocab_size, 2, 24, seed=6))["tokens"]
    seen = {}

    def keep(side):
        def fn(grads):
            seen[side] = grads
            return grads
        return fn

    jopt = JaxOptimizerConfig(lr=1e-3)
    jinit, _ = jax_make_optimizer(jopt)
    jstep = jax_make_train_step(jcfg, jopt, grad_transform=keep("jax"))
    _, _, jm = jstep(params, jinit(params), {"tokens": jnp.asarray(toks)},
                     jnp.int32(1))
    opt = OptimizerConfig(lr=1e-3)
    init, _ = make_optimizer(opt)
    tp = from_jax(params)
    step = make_train_step(port_config(jcfg), opt, grad_transform=keep(
        "port"))
    _, _, tm = step(tp, init(tp), {"tokens": torch.from_numpy(toks)}, 1)
    for k in ("loss", "ce", "grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=2e-5,
                                   err_msg=k)
    _assert_trees_close(seen["port"], seen["jax"])


def _scan_inputs(rng, B, S, W):
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (B, S, W)).astype(np.float32))
    b = torch.from_numpy(0.1 * rng.standard_normal((B, S, W)).astype(
        np.float32))
    g = torch.from_numpy(rng.standard_normal((B, S, W)).astype(np.float32))
    h0 = torch.from_numpy(rng.standard_normal((B, W)).astype(np.float32))
    return a, b, g, h0


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scan_bwd_ref_equals_autograd_of_the_plain_forward(with_h0, dtype):
    """``rglru_scan_bwd_ref`` on the forward's float32 h, and
    ``ops.rglru_scan``'s gradient (``RglruScan``), equal autograd through
    ``rglru_scan_ref`` bit for bit: each product and each two-term sum is
    rounded once on both routes."""
    a, b, g, h0 = _scan_inputs(np.random.default_rng(0), 2, 19, 12)
    a, b, g = a.to(dtype), b.to(dtype), g.to(dtype)
    h0 = h0 if with_h0 else None
    ins = [a.clone().requires_grad_(), b.clone().requires_grad_()] + (
        [h0.clone().requires_grad_()] if with_h0 else [])
    want = torch.autograd.grad(
        ref.rglru_scan_ref(ins[0], ins[1], ins[2] if with_h0 else None),
        ins, g)
    h32 = ref.rglru_scan_ref(a.float(), b.float(), h0)
    da, db, dh0 = ref.rglru_scan_bwd_ref(a, g, h32, h0)
    got = [da, db] + ([dh0] if with_h0 else [])
    ins = [t.detach().clone().requires_grad_() for t in ins]
    out = ops.rglru_scan(ins[0], ins[1], ins[2] if with_h0 else None)
    assert out.grad_fn is not None and "RglruScan" in type(
        out.grad_fn).__name__
    got_ops = torch.autograd.grad(out, ins, g)
    for x, y, z in zip(got, got_ops, want):
        assert x.dtype == y.dtype == z.dtype
        assert torch.equal(x, z) and torch.equal(y, z)


def test_scan_bwd_through_rglru_parallel_with_valid_mask():
    """``rglru_parallel`` over a bucketed admission (frozen tails: a = 1,
    b = 0 past each row's length) with h0: gradients of y, the gates and
    h0 through ``RglruScan`` equal autograd through the plain forward."""
    cfg = port_config(jax_get_config(SRC))
    p = from_jax(jax_params(jax_get_config(SRC), seed=2))
    bp = {k: p["rec_blocks"][k][0] for k in ("w_a", "b_a", "w_i", "b_i",
                                             "lam")}
    rng = np.random.default_rng(3)
    B, S, W = 3, 10, cfg.lru_width
    y0 = torch.from_numpy(rng.standard_normal((B, S, W)).astype(np.float32))
    h00 = torch.from_numpy(rng.standard_normal((B, W)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((B, S, W)).astype(np.float32))
    valid = torch.arange(S)[None] < torch.tensor([10, 4, 7])[:, None]

    def grads(scan):
        y, h0 = y0.clone().requires_grad_(), h00.clone().requires_grad_()
        lam = bp["lam"].clone().requires_grad_()
        bp2 = dict(bp, lam=lam)
        orig = ops.rglru_scan
        ops.rglru_scan = scan
        try:
            h, last = griffin.rglru_parallel(y, bp2, h0=h0, valid=valid)
        finally:
            ops.rglru_scan = orig
        return torch.autograd.grad((h * g).sum() + last.sum(), [y, h0, lam])

    want = grads(ref.rglru_scan_ref)
    got = grads(ops.rglru_scan)
    for x, z in zip(got, want):
        torch.testing.assert_close(x, z, atol=1e-6, rtol=1e-6)


def test_train_launcher_grows_griffin_from_a_checkpoint_as_jax_does(
        tmp_path, monkeypatch):
    """JAX pretrains griffin-micro two steps into ``<root>/griffin-micro``
    (the reference's on-disk format); both launchers then grow
    griffin-micro-big from that checkpoint (the sibling rule), train the
    Mango operator 2 steps (its noise set to 0 in both, so they start from
    one operator) and the grown model 3 steps: the histories agree (1e-4
    relative)."""
    for mod in (jgrow, grow):
        orig = mod.build
        monkeypatch.setattr(mod, "build", lambda *a, _o=orig, **k: _o(
            *a, **{**k, "noise": 0.0}))
    kw = dict(steps=2, batch=2, seq=24, log_every=1, ckpt_every=2)
    jax_train.train(SRC, ckpt_dir=str(tmp_path / "jax" / SRC),
                    log_fn=lambda *_: None, **kw)
    shutil.copytree(tmp_path / "jax" / SRC, tmp_path / "port" / SRC)
    (tmp_path / "jax" / TGT).mkdir()  # the reference's sibling stat
    grow_kw = dict(steps=3, batch=2, seq=24, log_every=1, grow_from=SRC,
                   grow_steps=2)
    jlogs, logs = [], []
    _, jhist = jax_train.train(TGT, ckpt_dir=str(tmp_path / "jax" / TGT),
                               log_fn=jlogs.append, **grow_kw)
    _, hist = launch_train.train(TGT, ckpt_dir=str(tmp_path / "port" / TGT),
                                 device="cpu", log_fn=logs.append, **grow_kw)
    assert any("source weights from" in m and m.endswith("@ step 2")
               for m in logs)
    assert any("source weights from" in m for m in jlogs)
    assert [h["step"] for h in hist] == [h["step"] for h in jhist]
    for h, jh in zip(hist, jhist):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(h[k], jh[k], rtol=1e-4,
                                       err_msg=f"step {h['step']} {k}")


def test_train_launcher_grows_griffin_without_a_checkpoint():
    """The port's launcher grows griffin-micro-big from a
    fresh griffin-micro (Mango, 2 operator steps) and trains it."""
    logs = []
    params, hist = launch_train.train(
        TGT, steps=2, batch=2, seq=32, grow_from=SRC, grow_steps=2,
        log_every=1, device="cpu", log_fn=logs.append)
    assert params["embed"].shape[1] == port_config(jax_get_config(TGT)) \
        .d_model
    assert any(m.startswith("[grow] mango operator trained 2 steps")
               for m in logs)
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert tree_map(lambda t: t.device.type, params)["embed"] == "cpu"
