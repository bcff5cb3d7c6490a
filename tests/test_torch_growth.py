"""The port's growth path against the JAX package on the CPU: packing, the
Eq. 6 contraction (the sandwich route at rank 1, the einsum chain above),
every growth method, operator training (Eq. 7) and the quickstart claim.

Params and operator params are made by JAX and converted with
``from_jax``; other inputs come from seeded numpy.  f32 tolerance 2e-5
(the frameworks sum in different orders) unless a test says otherwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import F32_ATOL, jax_params, port_config
from repro.configs.base import get_config as jax_get_config
from repro.core import grow as jgrow
from repro.core import mango as jmango
from repro.core import packing as jpacking
from repro.kernels import ops as jops
from repro.models import get_family as jax_family
from repro.optim import OptimizerConfig as JaxOptimizerConfig
from repro.train.loss import loss_for as jax_loss_for
from repro.train.steps import make_grow_step as jax_make_grow_step
from repro_torch.configs import get_config
from repro_torch.convert import from_jax, to_numpy
from repro_torch.core import grow, mango, packing
from repro_torch.data import lm_data_iter
from repro_torch.kernels import ops, ref
from repro_torch.kernels.tr_sandwich import tr_sandwich as cuda_sandwich
from repro_torch.models import get_family
from repro_torch.optim import OptimizerConfig, make_optimizer
from repro_torch.train.loss import loss_for
from repro_torch.train.steps import make_eval_step, make_grow_step, \
    make_train_step
from repro_torch.utils.pytree import tree_flatten_with_paths, tree_leaves

SRC, TGT = "gpt-micro", "gpt-micro-big"


def _cfgs(method="mango"):
    """(jax src, jax tgt, port src, port tgt); StackBERT grows depth only."""
    js = jax_get_config(SRC)
    jt = js.replace(name="deep", n_layers=8) if method == "stackbert" \
        else jax_get_config(TGT)
    return js, jt, port_config(js), port_config(jt)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_trees_close(got, want, atol=F32_ATOL, rtol=0.0):
    g = dict(tree_flatten_with_paths(to_numpy(got)))
    w = dict(tree_flatten_with_paths(_np_tree(want)))
    assert g.keys() == w.keys()
    for path in w:
        assert g[path].shape == w[path].shape, path
        np.testing.assert_allclose(g[path], w[path], atol=atol, rtol=rtol,
                                   err_msg=path)


def _plan_rows(plan):
    return ([(g.name, g.n_layers,
              [(s.path, s.kind, tuple(s.leaf_shape), s.ti, s.tj, s.expert)
               for s in g.slots],
              [(v.path, tuple(v.leaf_shape)) for v in g.vectors])
             for g in plan.groups],
            [(w.path, tuple(w.leaf_shape)) for w in plan.widths], plan.d_model)


def _synthetic_tree(rng):
    """A group with an expert leaf, a block-diagonal gate, a plain matrix
    and a vector, beside a global leaf; d_model 16."""
    def rnd(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    return {"moe_blocks": {"experts": {"w_up": rnd(2, 3, 16, 40)},
                           "gate": rnd(2, 4, 4, 4), "proj": rnd(2, 20, 24),
                           "norm": {"scale": rnd(2, 16)}},
            "embed": rnd(10, 16)}


def _plan_case(name):
    """(jax plan, port plan, numpy params) for a model config or the
    synthetic tree."""
    if name == "synthetic":
        tree = _synthetic_tree(np.random.default_rng(0))
        jcfg = jax_get_config(SRC).replace(d_model=16)
        return (jpacking.build_plan(jcfg, tree),
                packing.build_plan(port_config(jcfg),
                                   jax.tree.map(np.shape, tree)), tree)
    jcfg = jax_get_config(name)
    shapes = jax.eval_shape(lambda: jax_family(jcfg).init(
        jax.random.PRNGKey(0), jcfg))
    cfg = port_config(jcfg)
    return (jpacking.build_plan(jcfg, shapes),
            packing.build_plan(cfg, get_family(cfg).param_shapes(cfg)),
            jax_params(jcfg))


@pytest.mark.parametrize("name", [SRC, "gpt-base", "synthetic"])
def test_build_plan_slot_order_equals_jax(name):
    """Slots, vectors and width leaves in the reference's sorted-path
    order; gpt-base's shapes come from the meta device, nothing drawn."""
    want, got, _ = _plan_case(name)
    assert _plan_rows(got) == _plan_rows(want)


@pytest.mark.parametrize("name", [SRC, "synthetic"])
def test_pack_and_unpack_group_equal_jax(name):
    """pack_group gives JAX's (B, D, D, L) tensor (expert and block-diagonal
    tiles included) and unpack_group of it gives back the leaves."""
    jplan, plan, tree = _plan_case(name)
    for jg, g in zip(jplan.groups, plan.groups):
        want = jpacking.pack_group(jg, tree[jg.name], jplan.d_model)
        got = packing.pack_group(g, from_jax(tree[g.name]), plan.d_model)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        back_j = jpacking.unpack_group(jg, want, tree[jg.name], jplan.d_model)
        back = packing.unpack_group(g, got, jax.tree.map(np.shape,
                                                         tree[g.name]),
                                    plan.d_model)
        assert back.keys() == back_j.keys()
        for path in back:
            np.testing.assert_array_equal(back[path].numpy(),
                                          np.asarray(back_j[path]))
            np.testing.assert_array_equal(
                back[path].numpy(), jpacking._get(tree[g.name], path))


@pytest.mark.parametrize("rank", [1, 2])
def test_contract_equals_jax(rank):
    """Rank 1 takes the sandwich route, rank 2 the einsum chain; both equal
    JAX's chain and its single-einsum reference, and the port's own."""
    js, jt, _, _ = _cfgs()
    dims = jmango.build_operator(js, jt, rank=rank).dims("dense_blocks")
    rng = np.random.default_rng(rank)
    M1 = rng.standard_normal((dims["B1"], dims["I1"], dims["O1"],
                              dims["L1"])).astype(np.float32) * 0.02
    cores = _np_tree(jmango.init_cores(jax.random.PRNGKey(rank), dims, rank,
                                       noise=0.05))
    want = np.asarray(jmango.contract(jnp.asarray(M1), cores))
    want_ref = np.asarray(jmango.contract_reference(jnp.asarray(M1), cores))
    tcores = from_jax(cores)
    got = mango.contract(torch.from_numpy(M1), tcores)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL)
    np.testing.assert_allclose(got.numpy(), want_ref, atol=F32_ATOL)
    np.testing.assert_allclose(
        mango.contract_reference(torch.from_numpy(M1), tcores).numpy(),
        want_ref, atol=F32_ATOL)


@pytest.mark.parametrize("rank", [1, 3, (1, 2, 3, 4)])
def test_contract_flops_equal_jax(rank):
    for src, tgt in ((SRC, TGT), ("gpt-small", "gpt-base")):
        js, jt = jax_get_config(src), jax_get_config(tgt)
        dims = jmango.build_operator(js, jt).dims("dense_blocks")
        assert mango.contract_flops(dims, rank) == \
            jmango.contract_flops(dims, rank)


def test_tr_sandwich_plain_matches_pallas_and_cpu_skips_the_kernel():
    """The plain version against the Pallas kernel in interpret mode (f32,
    128-multiples as that kernel requires); CPU tensors never reach the
    CUDA wrapper, which refuses them."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 128, 128)).astype(np.float32)
    a_i = (0.05 * rng.standard_normal((128, 256))).astype(np.float32)
    a_o = (0.05 * rng.standard_normal((128, 128))).astype(np.float32)
    want = jops.tr_sandwich(jnp.asarray(x), jnp.asarray(a_i),
                            jnp.asarray(a_o), mode="interpret")
    n0 = cuda_sandwich.launches
    got = ops.tr_sandwich(*map(torch.from_numpy, (x, a_i, a_o)))
    assert cuda_sandwich.launches == n0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_ATOL)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_sandwich(*map(torch.from_numpy, (x, a_i, a_o)))


@pytest.mark.parametrize("x_grad", [False, True])
def test_tr_sandwich_grads_equal_autograd_of_plain(x_grad):
    """``ops.TrSandwich``'s hand-written backward against autograd of the
    plain einsum (f32, 1e-5); dX only when x needs it."""
    rng = np.random.default_rng(4)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((3, 12, 10), (12, 20), (10, 14), (3, 20, 14))]
    x, a_i, a_o, dy = map(torch.from_numpy, arrs)

    def grads(fn):
        ins = [x.clone().requires_grad_(x_grad), a_i.clone().requires_grad_(),
               a_o.clone().requires_grad_()]
        need = ins if x_grad else ins[1:]
        return torch.autograd.grad(fn(*ins), need, dy)

    got = grads(ops.tr_sandwich)
    want = grads(lambda *t: torch.einsum("nio,ij,om->njm", *t))
    assert len(got) == (3 if x_grad else 2)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(ref.tr_sandwich_ref(x, a_i, a_o),
                               torch.einsum("nio,ij,om->njm", x, a_i, a_o))


@pytest.mark.parametrize("method", jgrow.METHODS)
def test_grow_params_equals_jax(method):
    """Every method grows converted gpt-micro weights into gpt-micro-big
    (StackBERT: into an 8-layer gpt-micro) as JAX does, with JAX's
    operator params and trainable count."""
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


def test_port_operator_init_matches_reference_structure():
    """The port's own build (noise from a torch.Generator) has JAX's tree,
    shapes and, at noise 0, JAX's values."""
    js, jt, ts, tt = _cfgs()
    _, jop = jgrow.build("mango", js, jt, rank=2, noise=0.0)
    _, op = grow.build("mango", ts, tt, rank=2, noise=0.0, device="cpu")
    _assert_trees_close(op, jop, atol=0.0)
    _, op_noisy = grow.build("mango", ts, tt, rank=2,
                             gen=torch.Generator().manual_seed(5))
    noise = op_noisy["groups"]["dense_blocks"]["S_B"] - \
        op["groups"]["dense_blocks"]["S_B"]
    assert 0.005 < float(noise.std()) < 0.02


def _small_batches(vocab, seed, n, batch=4, seq=16):
    it = lm_data_iter(vocab, batch, seq, seed=seed)
    return [next(it) for _ in range(n)]


def test_grow_step_follows_jax():
    """Five ``make_grow_step`` updates (clipped AdamW on the whole operator
    tree): per-step loss and grad norm, and the final operator, equal
    JAX's (loss 1e-5 relative; operator 1e-4 absolute after five Adam
    steps of lr 1e-3, where rounding in near-zero gradients can flip an
    update's sign)."""
    js, jt, ts, tt = _cfgs()
    src = jax_params(js, seed=2)
    jgop, jop = jgrow.build("mango", js, jt, rank=1)
    jopt = JaxOptimizerConfig(lr=1e-3)
    from repro.optim import make_optimizer as jax_make_optimizer
    jinit, _ = jax_make_optimizer(jopt)
    jstep = jax.jit(jax_make_grow_step(jgop, jt, jopt),
                    static_argnums=())
    gop, _ = grow.build("mango", ts, tt, rank=1, device="cpu")
    opt = OptimizerConfig(lr=1e-3)
    init_fn, _ = make_optimizer(opt)
    step = make_grow_step(gop, tt, opt)
    op_params, tsrc = from_jax(_np_tree(jop)), from_jax(src)
    state = init_fn(op_params)
    jstate = jinit(jop)
    for i, b in enumerate(_small_batches(tt.vocab_size, 7, 5)):
        jop, jstate, jm = jstep(jop, jstate, src, {"tokens": b["tokens"]},
                                jnp.int32(i + 1))
        op_params, state, m = step(op_params, state, tsrc,
                                   {"tokens": torch.from_numpy(b["tokens"])},
                                   i + 1)
        assert m.keys() == jm.keys()
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
    _assert_trees_close(op_params, jop, atol=1e-4)


def test_grow_step_microbatches_match_one_batch():
    """Two microbatches average to the one-batch grads (f32, 1e-5)."""
    _, _, ts, tt = _cfgs()
    gop, op0 = grow.build("mango", ts, tt, rank=1, device="cpu")
    src = from_jax(jax_params(jax_get_config(SRC), seed=3))
    b = {"tokens": torch.from_numpy(_small_batches(tt.vocab_size, 8, 1)[0]
                                    ["tokens"])}
    opt = OptimizerConfig(lr=1e-3, clip_norm=None)
    init_fn, _ = make_optimizer(opt)
    outs = [make_grow_step(gop, tt, opt, n_microbatches=n)(
        op0, init_fn(op0), src, b, 1) for n in (1, 2)]
    np.testing.assert_allclose(float(outs[1][2]["grad_norm"]),
                               float(outs[0][2]["grad_norm"]), rtol=1e-5)
    _assert_trees_close(outs[1][0], to_numpy(outs[0][0]), atol=1e-5)


@pytest.mark.parametrize("method", ["mango", "ligo"])
def test_train_operator_follows_jax(method):
    """Five bare-AdamW operator steps (no clipping): the loss trajectory
    (1e-5 relative) and the trained operator (1e-4) equal JAX's."""
    js, jt, ts, tt = _cfgs(method)
    src = jax_params(js, seed=4)
    jgop, jop = jgrow.build(method, js, jt, rank=1)
    jfam, jloss = jax_family(jt), jax_loss_for(jt)
    batches = _small_batches(tt.vocab_size, 9, 5)

    def jax_op_loss(big, b):
        logits, aux = jfam.forward(big, b, jt)
        return jloss(logits, aux, b, jt)[0]

    jop, jlosses = jgrow.train_operator(
        jgop, jop, src, jax_op_loss,
        iter({"tokens": jnp.asarray(b["tokens"])} for b in batches), steps=5)

    gop, _ = grow.build(method, ts, tt, rank=1, device="cpu")
    fam, loss = get_family(tt), loss_for(tt)

    def op_loss(big, b):
        logits, aux = fam.forward(big, b, tt)
        return loss(logits, aux, b, tt)[0]

    op_params, losses = grow.train_operator(
        gop, from_jax(_np_tree(jgrow.build(method, js, jt, rank=1)[1])),
        from_jax(src), op_loss, iter(batches), steps=5)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    _assert_trees_close(op_params, jop, atol=1e-4)


def test_frozen_methods_do_not_train():
    _, _, ts, tt = _cfgs()
    gop, op = grow.build("bert2bert", ts, tt, device="cpu")
    out, losses = grow.train_operator(gop, op, None, None, iter(()), steps=3)
    assert out is op and losses == []


def test_build_runs_on_cuda_unless_asked_for_cpu(monkeypatch):
    """``grow.build`` without a generator builds on CUDA by default, and so
    raises ``resolve_device``'s error where there is none; ``device="cpu"``
    builds on the CPU."""
    _, _, ts, tt = _cfgs()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        grow.build("mango", ts, tt)
    _, op = grow.build("mango", ts, tt, device="cpu")
    assert {t.device.type for t in tree_leaves(op)} == {"cpu"}


def test_quickstart_grown_beats_scratch():
    """The paper's loop at micro scale on the CPU, as
    ``examples/quickstart.py`` runs it: pretrain gpt-micro, train the Mango
    operator a few steps, grow; the grown gpt-micro-big starts below a
    scratch init on a held-out batch (60 + 10 steps here against the
    example's 120 + 25, to keep the test short)."""
    cfg_s, cfg_t = get_config(SRC), get_config(TGT)
    gen = torch.Generator().manual_seed(0)
    small = get_family(cfg_s).init(gen, cfg_s)
    opt = OptimizerConfig(lr=1e-3)
    init_fn, _ = make_optimizer(opt)
    state, step = init_fn(small), make_train_step(cfg_s, opt)
    data = lm_data_iter(cfg_s.vocab_size, 8, 64, seed=0)
    for s in range(60):
        b = {k: torch.from_numpy(v) for k, v in next(data).items()}
        small, state, _ = step(small, state, b, s + 1)

    gop, op_params = grow.build("mango", cfg_s, cfg_t, rank=1, device="cpu")
    fam, loss = get_family(cfg_t), loss_for(cfg_t)

    def op_loss(big, b):
        logits, aux = fam.forward(big, b, cfg_t)
        return loss(logits, aux, b, cfg_t)[0]

    op_params, losses = grow.train_operator(
        gop, op_params, small, op_loss,
        lm_data_iter(cfg_t.vocab_size, 8, 64, seed=3), steps=10, lr=2e-3)
    assert losses[-1] < losses[0]
    with torch.no_grad():
        big = grow.grow_params(gop, op_params, small)
    scratch = fam.init(torch.Generator().manual_seed(99), cfg_t)
    ev = make_eval_step(cfg_t)
    b = {k: torch.from_numpy(v) for k, v in next(lm_data_iter(
        cfg_t.vocab_size, 8, 64, seed=50)).items()}
    l_grown, l_scratch = float(ev(big, b)["loss"]), float(ev(scratch, b)
                                                        ["loss"])
    assert l_grown < l_scratch, (l_grown, l_scratch)
