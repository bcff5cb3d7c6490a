"""Card-only tests of the port (``-m gpu``): each CUDA kernel against its
plain version, the wrappers' refusals, the engine (plain and speculative,
dense and paged pools; the transformer and griffin) and the growth
contraction on the card.

This file imports neither JAX nor the JAX package, so it also runs on a
GPU machine without JAX:
    PYTHONPATH=src python -m pytest -q -m gpu --noconftest \
        tests/test_torch_gpu.py
Without a card every test skips (decided in the ``cuda_device`` fixture,
never at import or collection).
"""
import warnings

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core import grow as growlib
from repro_torch.core import mango, packing
from repro_torch.data import lm_batch
from repro_torch.kernels import decode_attention as kda
from repro_torch.kernels import ops, ref
from repro_torch.kernels.decode_attention import (
    chunk_verify_attention as cuda_chunk,
)
from repro_torch.kernels.decode_attention import (
    decode_attention as cuda_decode,
)
from repro_torch.kernels.decode_attention import (
    paged_chunk_verify_attention as cuda_paged_chunk,
)
from repro_torch.kernels.decode_attention import (
    paged_ring_decode_attention as cuda_paged_ring,
)
from repro_torch.kernels.decode_attention import (
    paged_slot_decode_attention as cuda_paged_slot,
)
from repro_torch.kernels.decode_attention import (
    ring_decode_attention as cuda_ring,
)
from repro_torch.kernels.decode_attention import (
    slot_decode_attention as cuda_slot,
)
from repro_torch.kernels.flash_attention import flash_attention as cuda_flash
from repro_torch.kernels.rglru_scan import rglru_scan as cuda_scan
from repro_torch.kernels.tr_sandwich import tr_sandwich as cuda_sandwich
from repro_torch.launch.serve import build_params, generate
from repro_torch.models import griffin, transformer
from repro_torch.serve import (
    ContinuousBatchingEngine,
    Request,
    SpeculativeConfig,
)

F32_ATOL = 2e-5  # f32: kernel and plain version sum in different orders
# bf16 outputs carry 8 mantissa bits: one rounding step is ~4e-3 at |out|
# near 1.  Measured on an H100 at gpt-base's shapes: 2.0e-3 (flash),
# 4.9e-4 (slot decode)
BF16_TOL = dict(atol=5e-3, rtol=1e-2)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _cuda_rand(dev, dtype, *shape):
    g = torch.Generator(device=dev).manual_seed(sum(shape))
    return torch.randn(*shape, generator=g, device=dev).to(dtype)


def _tol(dtype):
    if dtype == torch.bfloat16:
        return BF16_TOL
    return dict(atol=F32_ATOL, rtol=1e-4)


@pytest.mark.parametrize("B,H,KV,S,hd,dtype,causal", [
    (8, 12, 12, 512, 64, torch.float32, True),
    (2, 16, 4, 300, 128, torch.float32, True),
    (2, 8, 2, 100, 64, torch.float32, False),
    (2, 12, 12, 256, 64, torch.bfloat16, True),
    (1, 8, 2, 33, 128, torch.bfloat16, True),
])
def test_cuda_flash_matches_plain(cuda_device, B, H, KV, S, hd, dtype,
                                  causal):
    q = _cuda_rand(cuda_device, dtype, B, S, H, hd).transpose(1, 2)
    k = _cuda_rand(cuda_device, dtype, B, S + 1, KV, hd)[:, :S].transpose(1, 2)
    v = _cuda_rand(cuda_device, dtype, B, S, KV, hd).transpose(1, 2)
    n0 = cuda_flash.launches
    got = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert cuda_flash.launches == n0 + 1
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("S", [63, 65, 129])
def test_cuda_flash_tile_edges_match_plain(cuda_device, S, hd, dtype):
    """Query and key tiles that end one short of or one past a 64-row (and
    32- / 64-key) edge, G 8, and k/v slices of a cache longer than S."""
    B, H, KV = 2, 16, 2
    q = _cuda_rand(cuda_device, dtype, B, S, H, hd).transpose(1, 2)
    ck = _cuda_rand(cuda_device, dtype, B, S + 37, KV, hd)
    cv = _cuda_rand(cuda_device, dtype, B, S + 41, KV, hd)
    k, v = ck[:, :S].transpose(1, 2), cv[:, :S].transpose(1, 2)
    got = ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    want = ref.flash_attention_ref(q, k, v, causal=True)
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_is_deterministic(cuda_device, dtype):
    """Two calls on the same inputs give bit-equal outputs."""
    q = _cuda_rand(cuda_device, dtype, 2, 300, 8, 128).transpose(1, 2)
    k = _cuda_rand(cuda_device, dtype, 2, 301, 4, 128)[:, :300].transpose(1, 2)
    v = _cuda_rand(cuda_device, dtype, 2, 300, 4, 128).transpose(1, 2)
    a = cuda_flash(q, k, v)
    b = cuda_flash(q, k, v)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.parametrize("B,S,H,KV,hd,dtype", [
    (8, 1024, 12, 12, 64, torch.float32),
    (4, 256, 16, 4, 128, torch.float32),
    (3, 64, 8, 1, 64, torch.float32),
    (8, 1024, 12, 12, 64, torch.bfloat16),
])
def test_cuda_slot_decode_matches_plain(cuda_device, B, S, H, KV, hd, dtype):
    q = _cuda_rand(cuda_device, dtype, B, H, hd)
    k = _cuda_rand(cuda_device, dtype, B, S, KV, hd)
    v = _cuda_rand(cuda_device, dtype, B, S + 1, KV, hd)[:, :S].contiguous()
    kv_len = torch.linspace(0, S, B, device=cuda_device).to(torch.int32)
    done = torch.zeros(B, dtype=torch.bool, device=cuda_device)
    done[-1] = True
    n0 = cuda_slot.launches
    got = ops.slot_decode_attention(q, k, v, kv_len, done=done)
    torch.cuda.synchronize()
    assert cuda_slot.launches == n0 + 1
    want = ref.slot_decode_attention_ref(q, k, v,
                                         torch.where(done, 0, kv_len))
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))
    assert (got[0] == 0).all() and (got[-1] == 0).all()


@pytest.mark.parametrize("on_device", [True, False])
@pytest.mark.parametrize("B,S,H,KV,hd,dtype", [
    (8, 1024, 12, 12, 64, torch.float32),   # gpt-base's pool: TMA boxes
    (8, 1024, 16, 8, 128, torch.bfloat16),  # qwen3-0.6b's pool
    (4, 300, 32, 4, 128, torch.float32),    # GQA G 8, hd 128, ragged pool
    (6, 100, 16, 2, 128, torch.bfloat16),   # G 8 bf16, row copies
    (3, 64, 8, 1, 64, torch.bfloat16),      # one kv head: bulk runs
])
def test_cuda_slot_decode_on_the_decode_body_matches_plain(
        cuda_device, monkeypatch, B, S, H, KV, hd, dtype, on_device):
    """The dense slot on the paged-decode body, its bands cut on the device
    or on the host: kv_len 0 (exact zeros), 1, a tile edge, mid, S and
    past S (reads S), in one launch."""
    monkeypatch.setattr(kda, "SLOT_CUT_ON_DEVICE", on_device)
    q = _cuda_rand(cuda_device, dtype, B, H, hd)
    k = _cuda_rand(cuda_device, dtype, B, S, KV, hd)
    v = _cuda_rand(cuda_device, dtype, B, S + 1, KV, hd)[:, :S].contiguous()
    lens = [0, S + 7, 1, 32, S // 2, S, 33, S - 1][:B]
    kv_len = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    n0 = cuda_slot.launches
    got = cuda_slot(q, k, v, kv_len)
    torch.cuda.synchronize()
    assert cuda_slot.launches == n0 + 1
    want = ref.slot_decode_attention_ref(q, k, v, kv_len)
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))
    assert (got[0] == 0).all()


def test_cuda_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    q = _cuda_rand(cuda_device, torch.float32, 1, 2, 8, 32)
    with pytest.raises(ValueError, match="head_dim"):
        cuda_flash(q, q, q)
    h = _cuda_rand(cuda_device, torch.float16, 1, 2, 8, 64)
    with pytest.raises(TypeError, match="dtype"):
        cuda_flash(h, h, h)
    b = _cuda_rand(cuda_device, torch.bfloat16, 1, 2, 8, 72)[..., 1:65]
    with pytest.raises(ValueError, match="16 bytes"):
        cuda_flash(b, b, b)  # rows one element off 16 bytes
    q = _cuda_rand(cuda_device, torch.float32, 2, 6, 64)
    pool = _cuda_rand(cuda_device, torch.float32, 2, 16, 2, 64)
    lens = torch.tensor([3, 4], dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="H/KV"):
        cuda_slot(q, pool, pool, lens)  # G = 3 is not a kernel variant
    with pytest.raises(ValueError, match="contiguous"):
        cuda_slot(q[:, :2], pool, pool.transpose(1, 2), lens)
    with pytest.raises(ValueError, match="int32"):
        cuda_slot(q[:, :2].contiguous(), pool, pool, lens.long())


def _gqa_hd64_cfg():
    # the kernels take head_dim 64 or 128: 4 query heads over 2 KV heads
    return ModelConfig(name="gqa-hd64", n_layers=2, d_model=256, n_heads=4,
                       n_kv_heads=2, d_ff=512, vocab_size=997, rope="none",
                       learned_pos=128, norm="ln", act="gelu",
                       max_seq_len=128)


@pytest.mark.parametrize("S", [100, 37, 64])
def test_cuda_prefill_of_any_length_launches_flash(cuda_device, S):
    """Every causal prefill from position 0 goes through the flash kernel,
    whatever its length, and matches the plain full forward."""
    cfg = _gqa_hd64_cfg()
    params = build_params(cfg, seed=0, device=cuda_device)
    tokens = torch.from_numpy(lm_batch(cfg.vocab_size, 2, S, seed=S)).to(
        cuda_device)
    cache = transformer.init_cache(cfg, 2, 128, device=cuda_device)
    n0 = cuda_flash.launches
    got, _ = transformer.prefill(params, {"tokens": tokens}, cfg, cache)
    torch.cuda.synchronize()
    assert cuda_flash.launches == n0 + cfg.n_layers
    want, _ = transformer.forward(params, {"tokens": tokens}, cfg)
    torch.testing.assert_close(got, want[:, -1], atol=F32_ATOL, rtol=1e-4)


def test_cuda_engine_launches_both_kernels_and_matches_generate(
        cuda_device):
    """On the card the engine's admission prefill and slot decode go
    through the CUDA kernels (counted), and tokens equal ``generate``."""
    cfg = _gqa_hd64_cfg()
    params = build_params(cfg, seed=0, device=cuda_device)
    reqs = [Request(uid=i, prompt=lm_batch(cfg.vocab_size, 1, p,
                                           seed=50 + i)[0],
                    max_new_tokens=g)
            for i, (p, g) in enumerate([(16, 8), (32, 6), (9, 5)])]
    kern = {n: ops.kernels()[n]
            for n in ("flash_attention", "slot_decode_attention")}
    before = {n: f.launches for n, f in kern.items()}
    eng = ContinuousBatchingEngine(cfg, params, capacity=2, max_len=64, k=4)
    got = eng.run(reqs)
    assert all(kern[n].launches > before[n] for n in kern)
    for r in reqs:
        want = generate(cfg, params, torch.from_numpy(r.prompt)[None].to(
            cuda_device), max_new_tokens=r.max_new_tokens, max_len=64)
        np.testing.assert_array_equal(got[r.uid], want[0].cpu().numpy())


def test_cuda_engine_syncs_only_where_it_counts(cuda_device):
    """Double buffering holds: while serving, the only host waits PyTorch
    flags as synchronizing are the admission reads of each group's first
    tokens (one per prefill); block readbacks wait on CUDA events, and
    host-to-device copies of admission/eviction data do not sync."""
    cfg = _gqa_hd64_cfg()
    params = build_params(cfg, seed=0, device=cuda_device)
    reqs = [Request(uid=i, prompt=lm_batch(cfg.vocab_size, 1, 5 + 7 * i,
                                           seed=i)[0], max_new_tokens=9)
            for i in range(5)]
    eng = ContinuousBatchingEngine(cfg, params, capacity=2, max_len=64, k=4)
    eng.run([Request(uid=99, prompt=reqs[0].prompt, max_new_tokens=2)])
    n_prefills = eng.n_prefills
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            eng.run(reqs)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    assert len(syncs) == eng.n_prefills - n_prefills, [
        str(w.message) for w in syncs]


def _sandwich_inputs(dev, dtype, N, d1i, d1o, d2i, d2o):
    """x ~ N(0, 1) and operators scaled by 1/sqrt(fan-in), so |Y| ~ 1."""
    x = _cuda_rand(dev, torch.float32, N, d1i, d1o)
    a_i = _cuda_rand(dev, torch.float32, d1i, d2i + 1)[:, :d2i] * d1i ** -0.5
    a_o = _cuda_rand(dev, torch.float32, d1o, d2o) * d1o ** -0.5
    return x.to(dtype), a_i.contiguous().to(dtype), a_o.to(dtype)


@pytest.mark.parametrize("N,d1i,d1o,d2i,d2o,dtype", [
    (144, 512, 512, 768, 768, torch.float32),  # gpt-small -> gpt-base
    (144, 512, 512, 768, 768, torch.bfloat16),
    (144, 384, 384, 768, 768, torch.float32),  # deit-s -> deit-b
    (144, 384, 384, 768, 768, torch.bfloat16),
    (3, 64, 64, 128, 128, torch.float32),      # gpt-micro -> gpt-micro-big
    (3, 50, 70, 100, 36, torch.float32),       # ragged on every axis
    (5, 64, 48, 130, 96, torch.bfloat16),
])
def test_cuda_tr_sandwich_matches_plain(cuda_device, N, d1i, d1o, d2i, d2o,
                                        dtype):
    x, a_i, a_o = _sandwich_inputs(cuda_device, dtype, N, d1i, d1o, d2i, d2o)
    n0 = cuda_sandwich.launches
    got = ops.tr_sandwich(x, a_i, a_o)
    torch.cuda.synchronize()
    assert cuda_sandwich.launches == n0 + 1
    assert got.shape == (N, d2i, d2o) and got.dtype == dtype
    want = ref.tr_sandwich_ref(x, a_i, a_o)
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))


@pytest.mark.parametrize("N,d1i,d1o,d2i,d2o,dtype", [
    # TMA route: rows on 16 bytes, D1i/D1o not multiples of 16, D2i/D2o not
    # multiples of 64
    (4, 200, 100, 196, 132, torch.float32),
    (3, 120, 72, 136, 200, torch.bfloat16),
    # element-wise route (rows off 16 bytes)
    (2, 77, 45, 99, 70, torch.bfloat16),
    (2, 33, 17, 65, 63, torch.float32),
    # the widest contraction the shared memory takes (shallow stage)
    (2, 768, 40, 72, 100, torch.float32),
    (2, 768, 24, 48, 40, torch.bfloat16),
])
def test_cuda_tr_sandwich_tile_edges_match_plain(cuda_device, N, d1i, d1o,
                                                 d2i, d2o, dtype):
    x, a_i, a_o = _sandwich_inputs(cuda_device, dtype, N, d1i, d1o, d2i, d2o)
    got = ops.tr_sandwich(x, a_i, a_o)
    torch.cuda.synchronize()
    want = ref.tr_sandwich_ref(x, a_i, a_o)
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_tr_sandwich_is_deterministic(cuda_device, dtype):
    """Two calls on the same inputs give bit-equal outputs."""
    x, a_i, a_o = _sandwich_inputs(cuda_device, dtype, 5, 256, 192, 320, 200)
    a = cuda_sandwich(x, a_i, a_o)
    b = cuda_sandwich(x, a_i, a_o)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_cuda_tr_sandwich_grads_match_autograd(cuda_device):
    """Forward and dX run the kernel (two launches); all three grads match
    autograd of the plain einsum (f32, relative to the largest entry)."""
    x, a_i, a_o = _sandwich_inputs(cuda_device, torch.float32, 6, 64, 96,
                                   130, 80)
    dy = _cuda_rand(cuda_device, torch.float32, 6, 130, 80)
    ins = [t.clone().requires_grad_(True) for t in (x, a_i, a_o)]
    n0 = cuda_sandwich.launches
    got = torch.autograd.grad(ops.tr_sandwich(*ins), ins, dy)
    torch.cuda.synchronize()
    assert cuda_sandwich.launches == n0 + 2
    ref_ins = [t.clone().requires_grad_(True) for t in (x, a_i, a_o)]
    want = torch.autograd.grad(
        torch.einsum("nio,ij,om->njm", *ref_ins), ref_ins, dy)
    for g, w in zip(got, want):
        assert (g - w).abs().max() <= 1e-5 * w.abs().max()


def test_cuda_tr_sandwich_refuses_what_it_does_not_take(cuda_device):
    x, a_i, a_o = _sandwich_inputs(cuda_device, torch.float32, 2, 32, 32,
                                   48, 48)
    with pytest.raises(TypeError, match="dtype"):
        cuda_sandwich(x.half(), a_i.half(), a_o.half())
    with pytest.raises(TypeError, match="dtype"):
        cuda_sandwich(x, a_i.bfloat16(), a_o)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_sandwich(x.transpose(1, 2), a_i, a_o)
    with pytest.raises(ValueError, match="rows"):
        cuda_sandwich(x, a_i[:16].contiguous(), a_o)
    # T^T (64 x D1i, f32) and the shallow ring fit up to D1i 768
    for d1i, dtype in ((769, torch.float32), (769, torch.bfloat16)):
        big = torch.zeros(1, d1i, 8, device=cuda_device, dtype=dtype)
        with pytest.raises(ValueError, match="shared memory"):
            cuda_sandwich(big, torch.zeros(d1i, 8, device=cuda_device,
                                           dtype=dtype),
                          torch.zeros(8, 8, device=cuda_device, dtype=dtype))


@pytest.mark.parametrize("rank", [1, 2])
def test_cuda_contract_takes_the_kernel_at_rank_one(cuda_device, rank):
    """A rank-1 contraction launches the sandwich once per group; rank 2
    takes the einsum chain.  Both match the single-einsum reference."""
    cfg_s, cfg_t = get_config("gpt-micro"), get_config("gpt-micro-big")
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    gop, op_params = growlib.build("mango", cfg_s, cfg_t, rank=rank,
                                   gen=gen, noise=0.05)
    src = build_params(cfg_s, seed=1, device=cuda_device)
    for g in gop.op.plan_src.groups:
        M1 = packing.pack_group(g, src[g.name], cfg_s.d_model)
        cores = op_params["groups"][g.name]
        n0 = cuda_sandwich.launches
        got = mango.contract(M1, cores)
        torch.cuda.synchronize()
        assert cuda_sandwich.launches == n0 + (rank == 1)
        want = mango.contract_reference(M1, cores)
        assert (got - want).abs().max() <= 1e-5 * want.abs().max()


@pytest.mark.parametrize("async_save", [False, True])
def test_cuda_checkpoint_round_trip(cuda_device, tmp_path, async_save):
    """CUDA f32 and bf16 leaves saved (async: snapshot on the caller's
    thread, then the leaves are overwritten in place) and restored into a
    CUDA template: equal bit for bit, on the card, in their dtypes."""
    from repro_torch.checkpoint import CheckpointManager, load_checkpoint

    tree = {"p": {"w": _cuda_rand(cuda_device, torch.float32, 384, 768),
                  "h": _cuda_rand(cuda_device, torch.bfloat16, 768, 1000)},
            "o": {"m": _cuda_rand(cuda_device, torch.float32, 1000)}}
    want = {k: {kk: vv.clone() for kk, vv in v.items()}
            for k, v in tree.items()}
    mgr = CheckpointManager(str(tmp_path), every=1, async_save=async_save)
    assert mgr.maybe_save(1, tree)
    for v in tree.values():
        for t in v.values():
            t.zero_()
    mgr.wait()
    assert mgr.saves[0]["bytes"] == (384 * 768 + 1000) * 4 + 768 * 1000 * 2
    got, step, _ = load_checkpoint(str(tmp_path), tree)
    assert step == 1
    for k in want:
        for kk, w in want[k].items():
            g = got[k][kk]
            assert g.device.type == "cuda" and g.dtype == w.dtype
            assert torch.equal(g, w), (k, kk)


def _chunk_case(dev, dtype, B, S, H, KV, Sc, hd, offsets):
    q = _cuda_rand(dev, dtype, B, S, H, hd)
    ck = _cuda_rand(dev, dtype, B, Sc, KV, hd)
    cv = _cuda_rand(dev, dtype, B, Sc + 1, KV, hd)[:, :Sc].contiguous()
    k = _cuda_rand(dev, dtype, B, S + 1, KV, hd)[:, :S].contiguous()
    v = _cuda_rand(dev, dtype, B, S, KV, hd)
    return q, ck, cv, k, v, torch.tensor(offsets, dtype=torch.int32,
                                         device=dev)


CHUNK_GRID = [(ring, window, G, dtype) for ring in (False, True)
              for window in (None, 8) for G in (1, 2, 4)
              for dtype in (torch.float32, torch.bfloat16)]


@pytest.mark.parametrize("ring,window,G,dtype", CHUNK_GRID)
def test_cuda_chunk_verify_matches_plain(cuda_device, ring, window, G,
                                         dtype):
    """Offsets -1, 0, 1, mid, Sc and (ring) wrapped ones, over a cache
    length that divides nothing (100)."""
    Sc = 100
    offsets = ([-1, 0, 1, 37, Sc, Sc + 5, 3 * Sc + 41] if ring
               else [-1, 0, 1, 37, Sc, Sc - 1, 63])
    q, ck, cv, k, v, off = _chunk_case(cuda_device, dtype, 7, 5, 2 * G, 2,
                                       Sc, 64, offsets)
    n0 = cuda_chunk.launches
    got = ops.chunk_verify_attention(q, ck, cv, k, v, off, ring=ring,
                                     window=window)
    torch.cuda.synchronize()
    assert cuda_chunk.launches == n0 + 1
    want = ref.chunk_verify_attention_ref(q, ck, cv, k, v, off, ring=ring,
                                          window=window)
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))
    assert (got[0] == 0).all()


@pytest.mark.parametrize("B,S,H,KV,Sc,hd,dtype", [
    (8, 5, 12, 12, 1024, 64, torch.float32),   # gpt-base verify
    (8, 5, 8, 8, 1024, 64, torch.float32),     # gpt-small catch-up
    (8, 5, 12, 12, 1024, 64, torch.bfloat16),
    (3, 16, 16, 2, 300, 128, torch.float32),   # S*G = 128: 16 query tiles
    (2, 1, 8, 8, 64, 128, torch.bfloat16),     # S = 1
])
def test_cuda_chunk_verify_main_shapes_match_plain(cuda_device, B, S, H, KV,
                                                   Sc, hd, dtype):
    offsets = np.linspace(64, min(576, Sc - S), B).astype(int).tolist()
    offsets[-1] = -1
    q, ck, cv, k, v, off = _chunk_case(cuda_device, dtype, B, S, H, KV, Sc,
                                       hd, offsets)
    done = torch.zeros(B, dtype=torch.bool, device=cuda_device)
    done[0] = True
    got = ops.chunk_verify_attention(q, ck, cv, k, v, off, ring=False,
                                     done=done)
    torch.cuda.synchronize()
    want = ref.chunk_verify_attention_ref(
        q, ck, cv, k, v, torch.where(done, -1, off), ring=False)
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))
    assert (got[0] == 0).all() and (got[-1] == 0).all()


def test_cuda_chunk_verify_refuses_what_it_does_not_take(cuda_device):
    q, ck, cv, k, v, off = _chunk_case(cuda_device, torch.float32, 2, 5, 4,
                                       2, 32, 64, [3, 9])
    kw = dict(ring=False)
    with pytest.raises(ValueError, match="head_dim"):
        cuda_chunk(q[..., :32].contiguous(), ck[..., :32].contiguous(),
                   cv[..., :32].contiguous(), k[..., :32].contiguous(),
                   v[..., :32].contiguous(), off, **kw)
    with pytest.raises(TypeError, match="dtype"):
        cuda_chunk(q, ck.bfloat16(), cv, k, v, off, **kw)
    with pytest.raises(ValueError, match="H/KV"):
        cuda_chunk(q[:, :, :3].contiguous(), ck, cv, k, v, off, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_chunk(q, ck.transpose(1, 2), cv, k, v, off, **kw)
    with pytest.raises(ValueError, match="int32"):
        cuda_chunk(q, ck, cv, k, v, off.long(), **kw)
    with pytest.raises(ValueError, match="chunk length"):
        empty = _chunk_case(cuda_device, torch.float32, 2, 0, 4, 2, 32, 64,
                            [3, 9])
        cuda_chunk(*empty, **kw)
    with pytest.raises(ValueError, match="window"):
        cuda_chunk(q, ck, cv, k, v, off, ring=True, window=0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_chunk(q, ck, cv, k, v, off.cpu(), **kw)


VERIFY_LONG_GRID = [(kind, S, G, dtype) for kind in ("full", "ring", "paged")
                    for S in (17, 33, 65) for G in (1, 8)
                    for dtype in (torch.float32, torch.bfloat16)]


@pytest.mark.parametrize("kind,S,G,dtype", VERIFY_LONG_GRID)
def test_cuda_verify_past_16_keys_matches_plain(cuda_device, kind, S, G,
                                                dtype):
    """Chunks of 17, 33 and 65 keys (speculation depth 16, 32 and 64):
    tiles of 32 positions that hold cache and chunk rows (offsets off 32),
    chunks over two or more tiles, and up to 33 tiles of 16 query rows
    (S 65 x G 8).  The dense cache in the full layout (320 positions: TMA
    boxes for whole cache tiles, row copies for the mixed ones) and the
    ring layout (300, wrapped offsets), and the paged verify over pages
    of 64 (a cap of 320, sentinel blocks)."""
    B, KV, hd = 6, 2, 64
    if kind == "ring":
        Sc, offsets = 300, [-1, 0, 37, 297, 305, 941]
    else:
        Sc, offsets = 320, [-1, 0, 37, 100, 320 - S, 330]
    q, ck, cv, k, v, off = _chunk_case(cuda_device, dtype, B, S, G * KV, KV,
                                       Sc, hd, offsets)
    if kind == "paged":
        fn, kw = cuda_paged_chunk, dict(ring=False)
        ck, cv, bt = _paged_case(cuda_device, dtype, B, KV, hd, 11, 64, 5,
                                 seed=S + G)
        args = (q, ck, cv, bt, k, v, off)
        want = ref.paged_chunk_verify_attention_ref(*args, **kw)
    else:
        fn, kw = cuda_chunk, dict(ring=kind == "ring")
        args = (q, ck, cv, k, v, off)
        want = ref.chunk_verify_attention_ref(*args, **kw)
    n0 = fn.launches
    got = fn(*args, **kw)
    torch.cuda.synchronize()
    assert fn.launches == n0 + 1
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))
    assert (got[0] == 0).all()


def _hd64_pair(dev):
    """A grown pair whose kernels take their head_dim (gpt-micro's is 16):
    a 2 x 128 source (2 heads of 64) grown by rank-1 Mango into a 4 x 256
    target (4 heads of 64), the source drafting."""
    base = dict(vocab_size=997, rope="none", learned_pos=128, norm="ln",
                act="gelu", max_seq_len=128)
    cfg_s = ModelConfig(name="hd64-src", n_layers=2, d_model=128,
                        n_heads=2, n_kv_heads=2, d_ff=256, **base)
    cfg_t = ModelConfig(name="hd64-tgt", n_layers=4, d_model=256,
                        n_heads=4, n_kv_heads=4, d_ff=512, **base)
    params_t, params_s = growlib.grow_from_source(
        cfg_s, cfg_t, device=dev, log_fn=lambda *_: None,
        return_source=True)
    return cfg_t, params_t, cfg_s, params_s


def test_cuda_spec_engine_launches_chunk_verify_and_matches_generate(
        cuda_device):
    """Speculative serving on the card: tokens equal ``generate``; every
    block launches the chunk kernel once per layer of both models (the
    target's verify and the draft's catch-up), the draft's proposals the
    slot kernel, and admission the flash kernel."""
    cfg_t, p_t, cfg_s, p_s = _hd64_pair(cuda_device)
    d, k = 4, 2
    reqs = [Request(uid=i, prompt=lm_batch(cfg_t.vocab_size, 1, p,
                                           seed=70 + i)[0], max_new_tokens=g)
            for i, (p, g) in enumerate([(16, 12), (33, 7), (9, 20),
                                        (20, 5)])]
    kern = ops.kernels()
    for fn in kern.values():
        fn.launches = 0
    eng = ContinuousBatchingEngine(
        cfg_t, p_t, capacity=2, max_len=64, k=k,
        speculative=SpeculativeConfig(cfg_s, p_s, d=d))
    got = eng.run(reqs)
    torch.cuda.synchronize()
    assert kern["chunk_verify_attention"].launches == (
        (cfg_t.n_layers + cfg_s.n_layers) * k * eng.n_decode_dispatches)
    assert kern["slot_decode_attention"].launches == (
        cfg_s.n_layers * d * k * eng.n_decode_dispatches)
    assert kern["flash_attention"].launches > 0
    # two prefills (target and draft) an admission group, one sync a group
    groups, odd = divmod(eng.n_prefills, 2)
    assert not odd and groups > 0
    assert eng.n_host_syncs == groups + eng.n_decode_dispatches
    assert eng.n_spec_proposed > 0 and eng.n_spec_fallbacks == 0
    for r in reqs:
        want = generate(cfg_t, p_t, torch.from_numpy(r.prompt)[None].to(
            cuda_device), max_new_tokens=r.max_new_tokens, max_len=64)
        np.testing.assert_array_equal(got[r.uid], want[0].cpu().numpy())


def test_cuda_spec_engine_at_depth_16_matches_the_plain_route(cuda_device):
    """``--spec-d 16`` on the card: every block verifies a chunk of 17 keys
    (two tiles of query rows), and the tokens equal the plain route's (a
    full forward per token, which runs no kernel of the port) and
    ``generate``'s."""
    cfg_t, p_t, cfg_s, p_s = _hd64_pair(cuda_device)
    d, k = 16, 2
    reqs = [Request(uid=i, prompt=lm_batch(cfg_t.vocab_size, 1, p,
                                           seed=170 + i)[0], max_new_tokens=g)
            for i, (p, g) in enumerate([(16, 40), (33, 25), (9, 60)])]
    kern = ops.kernels()
    for fn in kern.values():
        fn.launches = 0
    eng = ContinuousBatchingEngine(
        cfg_t, p_t, capacity=2, max_len=128, k=k,
        speculative=SpeculativeConfig(cfg_s, p_s, d=d))
    got = eng.run(reqs)
    torch.cuda.synchronize()
    assert kern["chunk_verify_attention"].launches == (
        (cfg_t.n_layers + cfg_s.n_layers) * k * eng.n_decode_dispatches)
    assert eng.n_spec_proposed > 0 and eng.n_spec_fallbacks == 0
    for r in reqs:
        seq = torch.from_numpy(r.prompt)[None].to(cuda_device)
        plain = []
        for _ in range(r.max_new_tokens):
            logits, _ = transformer.forward(p_t, {"tokens": seq}, cfg_t)
            nxt = logits[0, -1].argmax()
            plain.append(int(nxt))
            seq = torch.cat([seq, nxt.to(seq.dtype).view(1, 1)], dim=1)
        np.testing.assert_array_equal(got[r.uid], np.array(plain))
        want = generate(cfg_t, p_t, torch.from_numpy(r.prompt)[None].to(
            cuda_device), max_new_tokens=r.max_new_tokens, max_len=128)
        np.testing.assert_array_equal(got[r.uid], want[0].cpu().numpy())


# ------------------------------------------------------------ paged pool
def _paged_case(dev, dtype, B, KV, hd, n_pages, page, nblk, seed):
    """Arenas of random values and non-contiguous block tables (a seeded
    page permutation) whose odd rows end in sentinel entries."""
    k = _cuda_rand(dev, dtype, n_pages, page, KV, hd)
    v = _cuda_rand(dev, dtype, n_pages + 1, page, KV, hd)[:n_pages]
    perm = torch.randperm(n_pages, generator=torch.Generator().manual_seed(
        seed))
    bt = torch.full((B, nblk), n_pages, dtype=torch.int32)
    for b in range(B):
        take = perm[(b * nblk) % n_pages:][:nblk - (b % 2)]
        bt[b, :len(take)] = take
    return k, v.contiguous(), bt.to(dev)


@pytest.mark.parametrize("B,H,KV,hd,n_pages,page,nblk,dtype", [
    (8, 12, 12, 64, 128, 64, 16, torch.float32),   # gpt-base, --pages 128
    (8, 12, 12, 64, 128, 64, 16, torch.bfloat16),
    (8, 8, 8, 64, 128, 64, 16, torch.float32),     # gpt-small's pool
    (5, 16, 4, 128, 23, 8, 6, torch.float32),      # G 4, hd 128, page 8
    (4, 16, 2, 128, 9, 16, 4, torch.bfloat16),     # G 8
    (3, 2, 2, 64, 5, 24, 3, torch.float32),        # G 1, page 24
])
def test_cuda_paged_slot_decode_matches_plain(cuda_device, B, H, KV, hd,
                                              n_pages, page, nblk, dtype):
    """Ragged kv_len: 0, lengths that end inside a sentinel block (read
    through the clamp, as a draft past its budget does), the full table
    and beyond it; a done row."""
    k, v, bt = _paged_case(cuda_device, dtype, B, KV, hd, n_pages, page,
                           nblk, seed=B + H)
    q = _cuda_rand(cuda_device, dtype, B, H, hd)
    S = nblk * page
    kv_len = torch.linspace(0, S + 5, B, device=cuda_device).to(torch.int32)
    done = torch.zeros(B, dtype=torch.bool, device=cuda_device)
    done[-1] = B > 2
    n0 = cuda_paged_slot.launches
    got = ops.paged_slot_decode_attention(q, k, v, bt, kv_len, done=done)
    torch.cuda.synchronize()
    assert cuda_paged_slot.launches == n0 + 1
    want = ref.paged_slot_decode_attention_ref(
        q, k, v, bt, torch.where(done, 0, kv_len))
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))
    assert (got[0] == 0).all() and (got[done] == 0).all()


PAGED_CHUNK_GRID = [(window, G, dtype) for window in (None, 8)
                    for G in (1, 2, 4, 8)
                    for dtype in (torch.float32, torch.bfloat16)]


@pytest.mark.parametrize("window,G,dtype", PAGED_CHUNK_GRID)
def test_cuda_paged_chunk_verify_matches_plain(cuda_device, window, G,
                                               dtype):
    """Offsets -1, 0, 1, mid, inside a sentinel block, the full table and
    past it, over pages of 8 (a cache of 48 positions)."""
    n_pages, page, nblk, KV = 17, 8, 6, 2
    B, S = 7, 5
    ck, cv, bt = _paged_case(cuda_device, dtype, B, KV, 64, n_pages, page,
                             nblk, seed=G)
    q = _cuda_rand(cuda_device, dtype, B, S, G * KV, 64)
    k = _cuda_rand(cuda_device, dtype, B, S, KV, 64)
    v = _cuda_rand(cuda_device, dtype, B, S + 1, KV, 64)[:, :S].contiguous()
    off = torch.tensor([-1, 0, 1, 21, 44, 48, 50], dtype=torch.int32,
                       device=cuda_device)
    n0 = cuda_paged_chunk.launches
    got = ops.paged_chunk_verify_attention(q, ck, cv, bt, k, v, off,
                                           ring=False, window=window)
    torch.cuda.synchronize()
    assert cuda_paged_chunk.launches == n0 + 1
    want = ref.paged_chunk_verify_attention_ref(q, ck, cv, bt, k, v, off,
                                                ring=False, window=window)
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))
    assert (got[0] == 0).all()


@pytest.mark.parametrize("B,S,H,KV,n_pages,dtype", [
    (8, 5, 12, 12, 64, torch.float32),    # gpt-base verify, --pages 64
    (8, 5, 8, 8, 64, torch.float32),      # gpt-small catch-up
    (8, 5, 12, 12, 64, torch.bfloat16),
    (8, 16, 12, 12, 128, torch.float32),  # S 16
])
def test_cuda_paged_chunk_verify_main_shapes_match_plain(
        cuda_device, B, S, H, KV, n_pages, dtype):
    page, nblk = 64, 16
    ck, cv, bt = _paged_case(cuda_device, dtype, B, KV, 64, n_pages, page,
                             nblk, seed=S)
    q = _cuda_rand(cuda_device, dtype, B, S, H, 64)
    k = _cuda_rand(cuda_device, dtype, B, S, KV, 64)
    v = _cuda_rand(cuda_device, dtype, B, S, KV, 64)
    off = torch.tensor([-1, 64, 137, 210, 283, 356, 430, 576][:B],
                       dtype=torch.int32, device=cuda_device)
    got = ops.paged_chunk_verify_attention(q, ck, cv, bt, k, v, off,
                                           ring=False)
    torch.cuda.synchronize()
    want = ref.paged_chunk_verify_attention_ref(q, ck, cv, bt, k, v, off,
                                                ring=False)
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))


def test_cuda_paged_wrappers_refuse_what_the_kernels_do_not_take(
        cuda_device):
    k, v, bt = _paged_case(cuda_device, torch.float32, 2, 2, 64, 5, 8, 3, 0)
    q = _cuda_rand(cuda_device, torch.float32, 2, 4, 64)
    lens = torch.tensor([3, 9], dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="int32"):
        cuda_paged_slot(q, k, v, bt.long(), lens)
    with pytest.raises(ValueError, match="arena"):
        cuda_paged_slot(q, k, v[:, :4].contiguous(), bt, lens)
    with pytest.raises(ValueError, match="nblk"):
        cuda_paged_slot(q, k, v, torch.zeros(2, 4096, dtype=torch.int32,
                                             device=cuda_device), lens)
    with pytest.raises(ValueError, match="H/KV"):
        cuda_paged_slot(q[:, :3].contiguous(), k, v, bt, lens)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_paged_slot(q, k, v, bt.t().contiguous().t(), lens)
    qc = _cuda_rand(cuda_device, torch.float32, 2, 3, 4, 64)
    kc = _cuda_rand(cuda_device, torch.float32, 2, 3, 2, 64)
    with pytest.raises(NotImplementedError, match="ring slice"):
        cuda_paged_chunk(qc, k, v, bt, kc, kc, lens, ring=True)
    with pytest.raises(TypeError, match="dtype"):
        cuda_paged_chunk(qc, k.bfloat16(), v, bt, kc, kc, lens, ring=False)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_paged_chunk(qc, k, v, bt.cpu(), kc, kc, lens, ring=False)


def _prefix_requests(vocab, n_shared=6):
    """Requests that open with the same 40 tokens (five pages of 8 at
    max_len 64), then 3..8 tokens of their own, and two distinct ones."""
    prefix = lm_batch(vocab, 1, 40, seed=400)[0]
    out = [Request(uid=i, prompt=np.concatenate(
        [prefix, lm_batch(vocab, 1, 3 + i, seed=410 + i)[0]]),
        max_new_tokens=8 + i % 3) for i in range(n_shared)]
    for j, (p, g) in enumerate([(13, 9), (30, 6)]):
        out.append(Request(uid=n_shared + j,
                           prompt=lm_batch(vocab, 1, p, seed=430 + j)[0],
                           max_new_tokens=g))
    return out


def test_cuda_paged_engine_matches_dense_with_exact_launches(cuda_device):
    """The paged engine on the card: tokens equal the dense engine's and
    ``generate``; every decode step (macro steps and the prefix hits'
    tail steps) launches the paged slot kernel once per layer and the
    dense one never; admission prefills launch the flash kernel; every
    page is released at the end."""
    cfg = _gqa_hd64_cfg()
    params = build_params(cfg, seed=0, device=cuda_device)
    reqs = _prefix_requests(cfg.vocab_size)
    kern = ops.kernels()
    dense = ContinuousBatchingEngine(cfg, params, capacity=2, max_len=64,
                                     k=4).run(reqs)
    for fn in kern.values():
        fn.launches = 0
    eng = ContinuousBatchingEngine(cfg, params, capacity=2, max_len=64, k=4,
                                   pool="paged", pages=12)
    got = eng.run([Request(uid=r.uid, prompt=r.prompt,
                           max_new_tokens=r.max_new_tokens) for r in reqs])
    torch.cuda.synchronize()
    steps = eng.k * eng.n_decode_dispatches + eng.n_prefix_tail_steps
    assert kern["paged_slot_decode_attention"].launches == (
        cfg.n_layers * steps)
    assert kern["slot_decode_attention"].launches == 0
    assert kern["flash_attention"].launches == cfg.n_layers * eng.n_prefills
    assert kern["paged_chunk_verify_attention"].launches == 0
    assert eng.n_prefix_hits > 0 and eng.pages_in_use == 0
    assert eng.pages_highwater <= 12
    for r in reqs:
        np.testing.assert_array_equal(got[r.uid], dense[r.uid])
        want = generate(cfg, params, torch.from_numpy(r.prompt)[None].to(
            cuda_device), max_new_tokens=r.max_new_tokens, max_len=64)
        np.testing.assert_array_equal(got[r.uid], want[0].cpu().numpy())


def test_cuda_paged_engine_syncs_only_where_it_counts(cuda_device):
    """A paged engine waits on the host only where it counts a host sync:
    each admission group's and each prefix-hit wave's first tokens."""
    cfg = _gqa_hd64_cfg()
    params = build_params(cfg, seed=0, device=cuda_device)
    reqs = _prefix_requests(cfg.vocab_size)
    eng = ContinuousBatchingEngine(cfg, params, capacity=2, max_len=64, k=4,
                                   pool="paged")
    eng.run([Request(uid=99, prompt=reqs[-1].prompt, max_new_tokens=2)])
    before = eng.n_host_syncs - eng.n_decode_dispatches
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            eng.run(reqs)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    assert eng.n_prefix_hits > 0
    assert len(syncs) == (eng.n_host_syncs - eng.n_decode_dispatches
                          - before), [str(w.message) for w in syncs]


def test_cuda_paged_spec_engine_launches_paged_kernels_only(cuda_device):
    """Speculative serving on one shared page arena: tokens equal
    ``generate``; each block launches the paged chunk kernel once per layer
    of both models and the paged slot kernel once per draft layer and
    proposal; the dense chunk and slot kernels never run."""
    cfg_t, p_t, cfg_s, p_s = _hd64_pair(cuda_device)
    d, k = 4, 2
    reqs = [Request(uid=i, prompt=lm_batch(cfg_t.vocab_size, 1, p,
                                           seed=70 + i)[0], max_new_tokens=g)
            for i, (p, g) in enumerate([(16, 12), (33, 7), (9, 20),
                                        (20, 5)])]
    kern = ops.kernels()
    for fn in kern.values():
        fn.launches = 0
    eng = ContinuousBatchingEngine(
        cfg_t, p_t, capacity=2, max_len=64, k=k, pool="paged", pages=10,
        speculative=SpeculativeConfig(cfg_s, p_s, d=d))
    got = eng.run(reqs)
    torch.cuda.synchronize()
    blocks = k * eng.n_decode_dispatches
    assert kern["paged_chunk_verify_attention"].launches == (
        (cfg_t.n_layers + cfg_s.n_layers) * blocks)
    assert kern["paged_slot_decode_attention"].launches == (
        cfg_s.n_layers * d * blocks)
    assert kern["chunk_verify_attention"].launches == 0
    assert kern["slot_decode_attention"].launches == 0
    assert eng.n_spec_proposed > 0 and eng.pages_in_use == 0
    for r in reqs:
        want = generate(cfg_t, p_t, torch.from_numpy(r.prompt)[None].to(
            cuda_device), max_new_tokens=r.max_new_tokens, max_len=64)
        np.testing.assert_array_equal(got[r.uid], want[0].cpu().numpy())


# ------------------------------------------------ griffin: ring and scan
RING_GRID = [(G, hd, dtype) for G in (1, 4, 10) for hd in (64, 128, 256)
             for dtype in (torch.float32, torch.bfloat16)]


def _ring_positions(ring, window):
    """Done, the first position, inside the first lap, at the ring, past
    it, far past it, and a band cut by the window."""
    return [-1, 0, 5, ring - 1, ring, ring + 17, 3 * ring + 101,
            window + 3]


@pytest.mark.parametrize("G,hd,dtype", RING_GRID)
@pytest.mark.parametrize("ring,window", [(2048, 2048), (300, 130),
                                         (40, 1000)])
def test_cuda_ring_decode_matches_plain(cuda_device, G, hd, dtype, ring,
                                        window):
    KV = 1 if G == 10 else 2
    pos = torch.tensor(_ring_positions(ring, window), dtype=torch.int32,
                       device=cuda_device)
    B = pos.shape[0]
    g = torch.Generator(device=cuda_device).manual_seed(G + hd + ring)
    q, k, v = (torch.randn(*shape, generator=g, device=cuda_device).to(dtype)
               for shape in ((B, G * KV, hd), (B, ring, KV, hd),
                             (B, ring, KV, hd)))
    got = cuda_ring(q, k, v, pos, window=window)
    torch.cuda.synchronize()
    want = ref.ring_decode_attention_ref(q, k, v, pos, window=window)
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))
    assert (got[0] == 0).all()


@pytest.mark.parametrize("G,hd,dtype", [(1, 64, torch.float32),
                                        (10, 256, torch.float32),
                                        (10, 256, torch.bfloat16),
                                        (4, 128, torch.bfloat16)])
@pytest.mark.parametrize("page,nblk,window", [(64, 32, 2048), (8, 5, 23)])
def test_cuda_paged_ring_decode_matches_plain(cuda_device, G, hd, dtype,
                                              page, nblk, window):
    """A seeded permutation of the arena's pages as tables, the sentinel
    for blocks short rows never got, positions past the wrap, a done
    row."""
    KV = 1 if G == 10 else 2
    ring = nblk * page
    pos = [-1, 3, page + 1, ring - 1, ring + 7, 5 * ring + 3]
    B = len(pos)
    n_pages = B * nblk - 3
    perm = torch.randperm(n_pages, generator=torch.Generator().manual_seed(
        page), dtype=torch.int32)
    bt = perm[torch.arange(B * nblk) % n_pages].reshape(B, nblk)
    bt[1, 1:] = n_pages  # a short row: one page
    bt[2, 2:] = n_pages  # two pages
    bt = bt.contiguous().to(cuda_device)
    pos = torch.tensor(pos, dtype=torch.int32, device=cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(G + hd + page)
    q, k, v = (torch.randn(*shape, generator=g, device=cuda_device).to(dtype)
               for shape in ((B, G * KV, hd), (n_pages, page, KV, hd),
                             (n_pages, page, KV, hd)))
    got = cuda_paged_ring(q, k, v, bt, pos, window=window)
    torch.cuda.synchronize()
    want = ref.paged_ring_decode_attention_ref(q, k, v, bt, pos,
                                               window=window)
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))
    assert (got[0] == 0).all()


# The paged slot and ring kernels, the dense ring, the paged and dense
# verify and decode_attention share one body (csrc/paged_decode.cuh): each
# (row, kv head) band is one thread-block cluster of ``nsplit`` pieces
# (``paged_decode_splits``) merged in the launch: pieces of the host's
# chunk positions, or, for a verify and decode_attention, a band of n
# positions cut into pieces of ceil(n / nsplit) rounded up to 32 (at most
# the host's chunk).  Grid entries are (kind, G, hd, dtype, page): a dense
# ring's "page" is its ring length (the window by DENSE_RING_WINDOW), a
# verify's S and window come from VERIFY_EDGE; a dense verify's "page" is
# its cache length Sc (DENSE_VERIFY_EDGE), decode_attention's its cache
# length S (DECODE_EDGE).
DENSE_RING_WINDOW = {2048: 2048, 384: 1000, 200: 100}
VERIFY_EDGE = {  # (G, page) -> (S, window)
    (1, 64): (5, None),   # gpt-base's verify: 5 rows in the 8-row instance
    (2, 24): (1, None),   # S 1
    (8, 8): (16, 40),     # S 16 x G 8: 8 tiles of 16 rows, a window
    (8, 64): (16, None),  # 8 tiles, TMA boxes over the cache
    (4, 24): (5, 70),     # 20 rows in 2 tiles; the window cuts each row
    (2, 8): (5, 3),       # a window shorter than the chunk
    (1, 32): (16, None),  # one tile of 16 rows
}
DENSE_VERIFY_EDGE = {  # (G, Sc) -> (S, window, ring, KV)
    (1, 1024): (5, None, False, 12),  # gpt-base's verify: TMA boxes
    (8, 300): (16, 64, False, 2),     # S 16 x G 8: 8 tiles, a window
    (8, 96): (16, None, True, 2),     # 8 tiles over a wrapped ring
    (2, 100): (1, 3, True, 2),        # S 1, a window of 3 in a ring
    (4, 200): (5, 64, True, 2),       # 20 rows in 2 tiles, ring + window
    (2, 64): (5, 3, False, 2),        # a window shorter than the chunk
    (4, 40): (16, None, True, 1),     # one kv head: runs of rows
}
DECODE_EDGE = {  # (G, S) -> (B, KV, layout)
    (1, 1024): (1, 12, "pool"),       # gpt-base's generate at B 1
    (1, 100): (1, 12, "pool"),        # B 1, a band shorter than a piece
    (2, 576): (8, 8, "pool"),         # qwen3-0.6b's generate at B 8
    (8, 300): (8, 4, "head-major"),   # runs of contiguous rows
    (4, 37): (8, 2, "head-major"),
    (1, 200): (8, 2, "pool"),         # strided rows, no TMA (200 % 32)
}
PAGED_EDGE_GRID = [(kind, G, hd, dtype, page)
                   for kind, G, hd in (("slot", 8, 128), ("ring", 8, 128),
                                       ("ring", 10, 256))
                   for dtype in (torch.float32, torch.bfloat16)
                   for page in (8, 24, 64)] + [
    ("dense_ring", 10, 256, torch.float32, 2048),
    ("dense_ring", 10, 256, torch.bfloat16, 384),
    ("dense_ring", 8, 128, torch.float32, 384),
    ("dense_ring", 8, 128, torch.bfloat16, 200),
    ("dense_ring", 4, 64, torch.float32, 200),
    ("verify", 1, 64, torch.float32, 64),
    ("verify", 1, 64, torch.bfloat16, 64),
    ("verify", 2, 128, torch.float32, 24),
    ("verify", 8, 128, torch.float32, 8),
    ("verify", 8, 128, torch.bfloat16, 64),
    ("verify", 4, 64, torch.float32, 24),
    ("verify", 2, 64, torch.bfloat16, 8),
    ("verify", 1, 128, torch.float32, 32),
    ("dense_verify", 1, 64, torch.float32, 1024),
    ("dense_verify", 1, 64, torch.bfloat16, 1024),
    ("dense_verify", 8, 128, torch.float32, 300),
    ("dense_verify", 8, 128, torch.bfloat16, 96),
    ("dense_verify", 2, 64, torch.float32, 100),
    ("dense_verify", 4, 128, torch.bfloat16, 200),
    ("dense_verify", 2, 128, torch.float32, 64),
    ("dense_verify", 4, 64, torch.float32, 40),
    ("decode", 1, 64, torch.float32, 1024),
    ("decode", 1, 64, torch.bfloat16, 100),
    ("decode", 2, 128, torch.float32, 576),
    ("decode", 2, 128, torch.bfloat16, 576),
    ("decode", 8, 128, torch.float32, 300),
    ("decode", 4, 64, torch.bfloat16, 37),
    ("decode", 1, 128, torch.float32, 200),
]


def _paged_edge_case(dev, kind, G, hd, dtype, page):
    """Inputs at the body's edges, from the split the wrapper will take:
    bands shorter than one piece (the other ranks get nothing), ending on
    a piece boundary and on a page boundary, the full table and past it
    (slot), wrapped rings (ring), a sentinel entry inside an attended
    band, a done row.  Pages 8 and 24 cut the pieces of 32 positions
    across pages; window > ring at page 8, < ring at 24, = ring at 64."""
    KV = 1 if G == 10 else 2
    nblk = 12
    cap = nblk * page
    window = {8: 1000, 24: 100, 64: cap}[page]
    span = cap if kind == "slot" else min(window, cap)
    g = torch.Generator(device=dev).manual_seed(G + hd + page)
    q = torch.randn(8, G * KV, hd, generator=g, device=dev).to(dtype)
    chunk, nsplit = kda._paged_splits(  # the wrapper's
        f"paged_{kind}_decode_attention", q, KV, span)
    assert nsplit > 1
    if kind == "slot":
        rows = [0, 1, chunk - 1, chunk, 2 * page, cap, cap + 5, 3 * page + 2]
    else:
        rows = [-1, 0, chunk - 1, chunk, 2 * page - 1, cap - 1, cap + 3,
                3 * cap + 7]
    B = len(rows)
    n_pages = B * nblk - 5
    perm = torch.randperm(n_pages, generator=torch.Generator().manual_seed(
        page + G), dtype=torch.int32)
    bt = perm[torch.arange(B * nblk) % n_pages].reshape(B, nblk)
    bt[4, 1] = n_pages  # the sentinel inside row 4's band (blocks 0, 1)
    bt[7, 2] = n_pages + 7  # and inside row 7's (its band covers block 2)
    k, v = (torch.randn(n_pages, page, KV, hd, generator=g,
                        device=dev).to(dtype) for _ in range(2))
    rows = torch.tensor(rows, dtype=torch.int32, device=dev)
    return q, k, v, bt.contiguous().to(dev), rows, window


def _dense_ring_edge_case(dev, G, hd, dtype, ring):
    """A dense ring's edges, from the wrapper's split: a done row, a band
    of one position (the other ranks get nothing), bands ending on and
    just past a piece boundary, wrapped rings, and a window above, below
    or at the ring length."""
    KV = 1 if G == 10 else 2
    window = DENSE_RING_WINDOW[ring]
    g = torch.Generator(device=dev).manual_seed(G + hd + ring)
    q = torch.randn(8, G * KV, hd, generator=g, device=dev).to(dtype)
    chunk, nsplit = kda._paged_splits("ring_decode_attention", q, KV,
                                      min(window, ring))
    assert nsplit > 1
    pos = torch.tensor([-1, 0, chunk - 1, chunk, 2 * chunk + 5, ring - 1,
                        ring + 3, 3 * ring + 7], dtype=torch.int32,
                       device=dev)
    k, v = (torch.randn(8, ring, KV, hd, generator=g, device=dev).to(dtype)
            for _ in range(2))
    return q, k, v, pos, window


def _verify_edge_case(dev, G, hd, dtype, page):
    """A paged verify's edges, from the wrapper's plan: offsets -1, 0 and
    1, the chunk's keys straddling a piece boundary (offset 30: a band of
    at most 32 * nsplit positions cuts into pieces of 32; no window), a
    sentinel inside an attended band, the full table and past it; S and
    the window from VERIFY_EDGE."""
    S, window = VERIFY_EDGE[G, page]
    KV, nblk, B = 2, 12, 8
    cap = nblk * page
    g = torch.Generator(device=dev).manual_seed(G + hd + page + S)
    q = torch.randn(B, S, G * KV, hd, generator=g, device=dev).to(dtype)
    kc, vc = (torch.randn(B, S, KV, hd, generator=g, device=dev).to(dtype)
              for _ in range(2))
    rows, tiles, chunk, nsplit = kda._verify_plan(q, KV, cap, window)
    assert (nsplit > 1 or window is not None) and rows * tiles >= S * G
    offs = torch.tensor([-1, 0, 1, 30, 2 * chunk - 1, cap - S, cap,
                         cap + 3], dtype=torch.int32, device=dev)
    n_pages = B * nblk - 5
    perm = torch.randperm(n_pages, generator=torch.Generator().manual_seed(
        page + G), dtype=torch.int32)
    bt = perm[torch.arange(B * nblk) % n_pages].reshape(B, nblk)
    bt[4, 1] = n_pages  # the sentinel inside row 4's cache (blocks 0, 1)
    bt[6, 2] = n_pages + 7  # and inside row 6's (the full table)
    ck, cv = (torch.randn(n_pages, page, KV, hd, generator=g,
                          device=dev).to(dtype) for _ in range(2))
    return q, ck, cv, bt.contiguous().to(dev), kc, vc, offs, window


def _dense_verify_edge_case(dev, G, hd, dtype, Sc):
    """A dense verify's edges, from the wrapper's plan: offsets -1, 0 and
    1, the chunk's keys straddling a piece boundary (30), a band ending
    near a piece boundary, a full cache and offsets past it (full: the
    whole cache; ring: wrapped); S, window, layout and KV from
    DENSE_VERIFY_EDGE."""
    S, window, ring, KV = DENSE_VERIFY_EDGE[G, Sc]
    B = 8
    g = torch.Generator(device=dev).manual_seed(G + hd + Sc + S)
    q = torch.randn(B, S, G * KV, hd, generator=g, device=dev).to(dtype)
    kc, vc, ck, cv = (
        torch.randn(B, n, KV, hd, generator=g, device=dev).to(dtype)
        for n in (S, S, Sc, Sc))
    rows, tiles, chunk, nsplit = kda._verify_plan(
        q, KV, Sc, window, "chunk_verify_attention")
    assert rows * tiles >= S * G and chunk * nsplit >= min(
        Sc, window - 1 if window else Sc) + S
    offs = torch.tensor([-1, 0, 1, 30, 2 * chunk - 1, Sc - S, Sc,
                         3 * Sc + 7], dtype=torch.int32, device=dev)
    return q, ck, cv, kc, vc, offs, ring, window


def _decode_edge_case(dev, G, hd, dtype, S):
    """decode_attention's edges, from the wrapper's split: kv_len 0, 1, a
    band shorter than a piece, on and past a piece boundary, S and past S,
    over the pool's (B, S, KV, hd) cache read through its transposed view
    or a contiguous head-major cache (DECODE_EDGE); at B 1 one length."""
    B, KV, layout = DECODE_EDGE[G, S]
    g = torch.Generator(device=dev).manual_seed(G + hd + S)
    q = torch.randn(B, G * KV, hd, generator=g, device=dev).to(dtype)
    chunk, nsplit = kda._paged_splits("decode_attention", q, KV, S)
    assert chunk * nsplit >= S
    if layout == "pool":
        k, v = (torch.randn(B, S, KV, hd, generator=g, device=dev).to(
            dtype).transpose(1, 2) for _ in range(2))
    else:
        k, v = (torch.randn(B, KV, S, hd, generator=g, device=dev).to(dtype)
                for _ in range(2))
    lens = ([S // 2 + 37] if S > 200 else [37]) if B == 1 else [
        0, 1, min(chunk - 1, S), min(chunk, S), min(chunk + 1, S), S // 3,
        S, S + 7]
    return q, k, v, torch.tensor(lens, dtype=torch.int32, device=dev)


@pytest.mark.parametrize("kind,G,hd,dtype,page", PAGED_EDGE_GRID)
def test_cuda_paged_decode_body_edges_match_plain(cuda_device, kind, G, hd,
                                                  dtype, page):
    if kind == "verify":
        q, ck, cv, bt, kc, vc, rows, window = _verify_edge_case(
            cuda_device, G, hd, dtype, page)
        fn = cuda_paged_chunk
        n0 = fn.launches
        got = fn(q, ck, cv, bt, kc, vc, rows, ring=False, window=window)
        want = ref.paged_chunk_verify_attention_ref(
            q, ck, cv, bt, kc, vc, rows, ring=False, window=window)
        done = rows < 0
    elif kind == "dense_ring":
        q, k, v, rows, window = _dense_ring_edge_case(cuda_device, G, hd,
                                                      dtype, page)
        fn = cuda_ring
        n0 = fn.launches
        got = fn(q, k, v, rows, window=window)
        want = ref.ring_decode_attention_ref(q, k, v, rows, window=window)
        done = rows < 0
    elif kind == "dense_verify":
        q, ck, cv, kc, vc, rows, ring, window = _dense_verify_edge_case(
            cuda_device, G, hd, dtype, page)
        fn = cuda_chunk
        n0 = fn.launches
        got = fn(q, ck, cv, kc, vc, rows, ring=ring, window=window)
        want = ref.chunk_verify_attention_ref(q, ck, cv, kc, vc, rows,
                                              ring=ring, window=window)
        done = rows < 0
    elif kind == "decode":
        q, k, v, rows = _decode_edge_case(cuda_device, G, hd, dtype, page)
        fn = cuda_decode
        n0 = fn.launches
        got = fn(q, k, v, rows)
        want = ref.decode_attention_ref(q, k, v, rows)
        done = rows <= 0
    else:
        q, k, v, bt, rows, window = _paged_edge_case(cuda_device, kind, G,
                                                     hd, dtype, page)
        if kind == "slot":
            fn = cuda_paged_slot
            n0 = fn.launches
            got = fn(q, k, v, bt, rows)
            want = ref.paged_slot_decode_attention_ref(q, k, v, bt, rows)
            done = rows <= 0
        else:
            fn = cuda_paged_ring
            n0 = fn.launches
            got = fn(q, k, v, bt, rows, window=window)
            want = ref.paged_ring_decode_attention_ref(q, k, v, bt, rows,
                                                       window=window)
            done = rows < 0
    torch.cuda.synchronize()
    assert fn.launches == n0 + 1
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))
    # every batch holds a done row, but decode_attention's at B 1
    assert bool(done.any()) or len(rows) == 1
    assert (got[done] == 0).all()
    assert torch.isfinite(got.float()).all()


@pytest.mark.parametrize("kind", ["slot", "ring", "dense_ring", "verify",
                                  "dense_verify", "decode", "dense_slot"])
def test_cuda_paged_decode_is_one_kernel_and_one_allocation(cuda_device,
                                                            kind):
    """One call puts exactly one kernel on the device (the in-launch merge:
    no merge kernel, no memset) and allocates only its output (no
    workspace)."""
    if kind == "verify":
        q, ck, cv, bt, kc, vc, offs, window = _verify_edge_case(
            cuda_device, 1, 64, torch.bfloat16, 64)

        def call():
            return cuda_paged_chunk(q, ck, cv, bt, kc, vc, offs, ring=False,
                                    window=window)
    elif kind == "dense_ring":
        q, k, v, pos, window = _dense_ring_edge_case(
            cuda_device, 10, 256, torch.bfloat16, 2048)

        def call():
            return cuda_ring(q, k, v, pos, window=window)
    elif kind == "dense_verify":
        q, ck, cv, kc, vc, offs, ring, window = _dense_verify_edge_case(
            cuda_device, 1, 64, torch.bfloat16, 1024)

        def call():
            return cuda_chunk(q, ck, cv, kc, vc, offs, ring=ring,
                              window=window)
    elif kind == "decode":
        q, k, v, lens = _decode_edge_case(cuda_device, 1, 64,
                                          torch.float32, 1024)

        def call():
            return cuda_decode(q, k, v, lens)
    elif kind == "dense_slot":
        q = _cuda_rand(cuda_device, torch.float32, 8, 12, 64)
        k = _cuda_rand(cuda_device, torch.float32, 8, 1024, 12, 64)
        lens = torch.tensor([0, 97, 200, 333, 451, 576, 800, 1024],
                            dtype=torch.int32, device=cuda_device)

        def call():
            return cuda_slot(q, k, k, lens)
    else:
        q, k, v, bt, rows, window = _paged_edge_case(
            cuda_device, kind, 10 if kind == "ring" else 8,
            256 if kind == "ring" else 128, torch.bfloat16, 64)
        if kind == "slot":
            def call():
                return cuda_paged_slot(q, k, v, bt, rows)
        else:
            def call():
                return cuda_paged_ring(q, k, v, bt, rows, window=window)
    call()
    torch.cuda.synchronize()
    from torch.profiler import DeviceType, ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    device_ops = [e.name for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
    assert len(device_ops) == 1 and "paged_decode_kernel" in device_ops[0], \
        device_ops
    n_alloc = torch.cuda.memory_stats()["allocation.all.allocated"]
    out = call()
    assert torch.cuda.memory_stats()["allocation.all.allocated"] == \
        n_alloc + 1
    assert out.shape == q.shape


@pytest.mark.parametrize("B,S,W", [(8, 4096, 2560), (3, 37, 50),
                                   (2, 1, 129), (1, 1000, 7),
                                   # TMA boxes at a single admission, ragged
                                   # sequences and a 400-byte row; W 99 (396
                                   # bytes) takes the per-lane path
                                   (1, 2048, 2560), (3, 2101, 2560),
                                   (4, 31, 100), (4, 31, 99), (1, 1, 2560),
                                   (3, 2101, 99)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_h0", [True, False])
def test_cuda_rglru_scan_matches_plain(cuda_device, B, S, W, dtype,
                                       with_h0):
    """Ragged shapes (no divisibility rule), with and without h0: float32
    equals the plain version bit for bit (each step rounds the product,
    then the sum, as the plain version's two tensor ops do); bfloat16
    within one output rounding.  Frozen positions (a = 1, b = 0) carry h
    through exactly."""
    g = torch.Generator(device=cuda_device).manual_seed(S + W)
    a = torch.rand(B, S, W, generator=g, device=cuda_device) * 0.5 + 0.5
    b = torch.randn(B, S, W, generator=g, device=cuda_device) * 0.1
    tail = S // 2
    a[:, tail:], b[:, tail:] = 1.0, 0.0
    a, b = a.to(dtype), b.to(dtype)
    h0 = (torch.randn(B, W, generator=g, device=cuda_device) if with_h0
          else None)
    got = cuda_scan(a, b, h0)
    torch.cuda.synchronize()
    want = ref.rglru_scan_ref(a, b, h0)
    assert got.dtype == dtype and got.shape == (B, S, W)
    if dtype == torch.float32:
        assert torch.equal(got, want)
        if tail:
            frozen = got[:, tail - 1:tail].expand(B, S - tail, W)
            assert torch.equal(got[:, tail:], frozen)
    else:
        torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)


@pytest.mark.parametrize("W", [2560, 99])
def test_cuda_rglru_scan_is_one_kernel_and_one_allocation(cuda_device, W):
    """Either path (TMA boxes at W 2560, per-lane at W 99) puts exactly one
    kernel on the device and allocates only its output."""
    a = _cuda_rand(cuda_device, torch.float32, 2, 300, W)
    b = _cuda_rand(cuda_device, torch.float32, 2, 301, W)[:, 1:].contiguous()
    h0 = _cuda_rand(cuda_device, torch.float32, 2, W)
    cuda_scan(a, b, h0)
    torch.cuda.synchronize()
    from torch.profiler import DeviceType, ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        cuda_scan(a, b, h0)
        torch.cuda.synchronize()
    device_ops = [e.name for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
    assert len(device_ops) == 1 and "rglru_scan" in device_ops[0], \
        device_ops
    n_alloc = torch.cuda.memory_stats()["allocation.all.allocated"]
    out = cuda_scan(a, b, h0)
    assert torch.cuda.memory_stats()["allocation.all.allocated"] == \
        n_alloc + 1
    assert torch.equal(out, ref.rglru_scan_ref(a, b, h0))


def test_cuda_griffin_kernels_refuse_what_they_do_not_take(cuda_device):
    dev = cuda_device
    pos = torch.zeros(2, dtype=torch.int32, device=dev)
    k = torch.zeros(2, 8, 1, 64, device=dev)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_ring(torch.zeros(2, 4, 64), k, k, pos, window=4)
    with pytest.raises(ValueError, match="head_dim 32"):
        k32 = torch.zeros(2, 8, 1, 32, device=dev)
        cuda_ring(torch.zeros(2, 4, 32, device=dev), k32, k32, pos, window=4)
    with pytest.raises(ValueError, match="H/KV = 17/1"):
        cuda_ring(torch.zeros(2, 17, 64, device=dev), k, k, pos, window=4)
    with pytest.raises(ValueError, match="window"):
        cuda_ring(torch.zeros(2, 4, 64, device=dev), k, k, pos, window=0)
    with pytest.raises(ValueError, match="slot_positions"):
        cuda_ring(torch.zeros(2, 4, 64, device=dev), k, k, pos.long(),
                  window=4)
    bt = torch.zeros(2, 1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="head_dim 32"):
        a32 = torch.zeros(3, 8, 1, 32, device=dev)
        cuda_paged_ring(torch.zeros(2, 4, 32, device=dev), a32, a32, bt,
                        pos, window=4)
    with pytest.raises(ValueError, match="nblk"):
        a = torch.zeros(3, 1, 1, 64, device=dev)
        cuda_paged_ring(torch.zeros(2, 4, 64, device=dev), a, a,
                        torch.zeros(2, 4096, dtype=torch.int32, device=dev),
                        pos, window=4)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_scan(torch.ones(1, 3, 2), torch.zeros(1, 3, 2))
    with pytest.raises(TypeError, match="float32"):
        cuda_scan(torch.ones(1, 3, 2, device=dev, dtype=torch.float16),
                  torch.zeros(1, 3, 2, device=dev, dtype=torch.float16))
    with pytest.raises(ValueError, match="h0"):
        cuda_scan(torch.ones(1, 3, 2, device=dev),
                  torch.zeros(1, 3, 2, device=dev),
                  torch.zeros(1, 3, device=dev))
    with pytest.raises(NotImplementedError, match="no backward"):
        cuda_scan(torch.ones(1, 3, 2, device=dev, requires_grad=True),
                  torch.zeros(1, 3, 2, device=dev))


def _griffin_hd64(dev):
    """A small griffin whose attention takes a kernel variant (head_dim 64,
    G 2), weights redrawn (embedding std 0.02, matrices 0.2) so greedy
    tokens vary."""
    cfg = ModelConfig(name="griffin-hd64", family="griffin", n_layers=3,
                      d_model=128, n_heads=2, n_kv_heads=1, head_dim=64,
                      d_ff=256, vocab_size=257, lru_width=128, window=16,
                      act="geglu", scale_embeddings=True,
                      tie_embeddings=True, max_seq_len=256, attn_chunk=16)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = griffin.init(gen, cfg)

    def redraw(tree, path=""):
        for name, leaf in tree.items():
            if isinstance(leaf, dict):
                redraw(leaf, name)
            elif name != "lam" and path not in ("ln1", "ln2", "final_norm"):
                std = 0.02 if name == "embed" else 0.2
                leaf.normal_(0.0, std, generator=gen)
    redraw(params)
    return cfg, params


@pytest.mark.parametrize("pool", ["dense", "paged"])
def test_cuda_griffin_engine_launches_ring_and_scan_exactly(cuda_device,
                                                            pool):
    """Griffin on the card, rings wrapping (window 16): tokens equal
    ``generate`` (scan prefill, plain scalar decode); each decode step
    launches
    the ring kernel (dense pool) or the paged ring kernel (paged pool,
    under page pressure) once per attention layer, each admission group
    the scan once per recurrent layer; no other kernel runs."""
    cfg, params = _griffin_hd64(cuda_device)
    n_rec = griffin.block_pattern(cfg).count("rec")
    n_attn = cfg.n_layers - n_rec
    reqs = [Request(uid=i, prompt=lm_batch(cfg.vocab_size, 1, p,
                                           seed=80 + i)[0], max_new_tokens=g)
            for i, (p, g) in enumerate([(3, 14), (21, 6), (9, 12), (30, 9),
                                        (5, 20)])]
    kern = ops.kernels()
    for fn in kern.values():
        fn.launches = 0
    kw = dict(capacity=3, max_len=64, k=4, pool=pool,
              pages=5 if pool == "paged" else None)
    eng = ContinuousBatchingEngine(cfg, params, **kw)
    got = eng.run(reqs)
    torch.cuda.synchronize()
    ring = "paged_ring_decode_attention" if pool == "paged" else \
        "ring_decode_attention"
    want = {name: 0 for name in kern}
    want.update({ring: n_attn * eng.k * eng.n_decode_dispatches,
                 "rglru_scan": n_rec * eng.n_prefills})
    assert {name: fn.launches for name, fn in kern.items()} == want
    for r in reqs:
        gen = generate(cfg, params, torch.from_numpy(r.prompt)[None].to(
            cuda_device), max_new_tokens=r.max_new_tokens, max_len=64)
        np.testing.assert_array_equal(got[r.uid], gen[0].cpu().numpy())
    if pool == "paged":
        assert eng.pages_in_use == 0 and eng.pages_highwater <= 5


# ------------------------------------- RoPE transformers: decode_attention
DECODE_GRID = [(G, hd, dtype) for G in (1, 2, 4, 8) for hd in (64, 128)
               for dtype in (torch.float32, torch.bfloat16)]


@pytest.mark.parametrize("G,hd,dtype", DECODE_GRID)
def test_cuda_decode_attention_matches_plain(cuda_device, G, hd, dtype):
    """S of 37, 300 and 576 (bands of one piece and of several);
    ragged lengths with 0, 1, S and past S, a done row; a contiguous
    head-major cache and the pool's (B, S, KV, hd) cache through its
    ``transpose(1, 2)`` view; a scalar length."""
    B, KV = 6, 2
    for S in (37, 300, 576):
        q = _cuda_rand(cuda_device, dtype, B, G * KV, hd)
        pool_k, pool_v = _cuda_rand(cuda_device, dtype, 2, B, S, KV, hd)
        lens = torch.tensor([0, 1, S // 3, S, S + 7, S - 2],
                            dtype=torch.int32, device=cuda_device)
        done = torch.zeros(B, dtype=torch.bool, device=cuda_device)
        done[-1] = True
        for k, v in ((pool_k.transpose(1, 2), pool_v.transpose(1, 2)),
                     (pool_k.transpose(1, 2).contiguous(),
                      pool_v.transpose(1, 2).contiguous())):
            n0 = cuda_decode.launches
            got = ops.decode_attention(q, k, v, lens, done=done)
            torch.cuda.synchronize()
            assert cuda_decode.launches == n0 + 1
            want = ref.decode_attention_ref(q, k, v,
                                            torch.where(done, 0, lens))
            torch.testing.assert_close(got.float(), want.float(),
                                       **_tol(dtype))
            assert (got[0] == 0).all() and (got[-1] == 0).all()
            got = ops.decode_attention(q, k, v, S - 3)
            want = ref.decode_attention_ref(q, k, v, S - 3)
            torch.testing.assert_close(got.float(), want.float(),
                                       **_tol(dtype))


def test_cuda_decode_attention_reads_the_pool_view_without_a_copy(
        cuda_device):
    """The (B, S, KV, hd) pool's transposed view, k and v sharing strides,
    is taken as it is (qwen3-0.6b's decode shape, 4 chunks)."""
    q = _cuda_rand(cuda_device, torch.float32, 8, 16, 128)
    pool = _cuda_rand(cuda_device, torch.float32, 2, 8, 576, 8, 128)
    lens = torch.arange(520, 576, 7, dtype=torch.int32, device=cuda_device)
    lens[3] = 0
    got = cuda_decode(q, pool[0].transpose(1, 2), pool[1].transpose(1, 2),
                      lens)
    want = ref.decode_attention_ref(q, pool[0].transpose(1, 2),
                                    pool[1].transpose(1, 2), lens)
    torch.testing.assert_close(got, want, atol=F32_ATOL, rtol=1e-4)
    assert (got[3] == 0).all()


def test_cuda_decode_attention_refuses_what_it_does_not_take(cuda_device):
    q = _cuda_rand(cuda_device, torch.float32, 2, 4, 64)
    k = _cuda_rand(cuda_device, torch.float32, 2, 2, 40, 64)
    lens = torch.tensor([3, 40], dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_decode(q.cpu(), k.cpu(), k.cpu(), lens.cpu())
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_decode(q, k.cpu(), k, lens)
    q80 = _cuda_rand(cuda_device, torch.float32, 2, 4, 80)
    k80 = _cuda_rand(cuda_device, torch.float32, 2, 2, 40, 80)
    with pytest.raises(ValueError, match="head_dim 80"):
        cuda_decode(q80, k80, k80, lens)
    wide = _cuda_rand(cuda_device, torch.float32, 2, 2, 40, 128)
    with pytest.raises(ValueError, match="stride 1"):
        cuda_decode(q, wide[..., ::2], wide[..., ::2], lens)
    flat = _cuda_rand(cuda_device, torch.float32, 2 * 2 * 40 * 64 + 1)
    odd = flat[1:].view(2, 2, 40, 64)
    with pytest.raises(ValueError, match="aligned"):
        cuda_decode(q, odd, odd, lens)
    with pytest.raises(ValueError, match="H/KV"):
        cuda_decode(_cuda_rand(cuda_device, torch.float32, 2, 6, 64), k, k,
                    lens)
    with pytest.raises(ValueError, match="int32"):
        cuda_decode(q, k, k, lens.long())
    with pytest.raises(TypeError, match="dtype"):
        cuda_decode(q, k.bfloat16(), k.bfloat16(), lens)


def _qwen3_hd128(dev):
    """qwen3-0.6b-smoke at head_dim 128 (its own 32 is no kernel
    variant): q/k norms, GQA 4/2, RoPE theta 1e6; weights redrawn
    (embedding std 0.02, matrices 0.2) so greedy tokens vary."""
    cfg = get_config("qwen3-0.6b-smoke").replace(head_dim=128)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = transformer.init(gen, cfg)

    def redraw(tree, path=""):
        for name, leaf in tree.items():
            if isinstance(leaf, dict):
                redraw(leaf, name)
            elif path not in ("ln1", "ln2", "final_norm") and \
                    not name.endswith("_norm"):
                leaf.normal_(0.0, 0.02 if name == "embed" else 0.2,
                             generator=gen)
    redraw(params)
    return cfg, params


def test_cuda_decode_step_launches_decode_attention_once_per_layer(
        cuda_device):
    """The scalar cached decode step of a RoPE model launches the kernel
    once per layer over the cache's head-major view; its logits match the
    plain full forward."""
    cfg, params = _qwen3_hd128(cuda_device)
    toks = torch.from_numpy(lm_batch(cfg.vocab_size, 3, 21, seed=5)).to(
        cuda_device)
    cache = transformer.init_cache(cfg, 3, 64, device=cuda_device)
    _, cache = transformer.prefill(params, {"tokens": toks[:, :20]}, cfg,
                                   cache)
    n0 = cuda_decode.launches
    got, _ = transformer.decode_step(params, toks[:, 20], 20, cache, cfg)
    torch.cuda.synchronize()
    assert cuda_decode.launches == n0 + cfg.n_layers
    want, _ = transformer.forward(params, {"tokens": toks}, cfg)
    torch.testing.assert_close(got, want[:, -1], atol=F32_ATOL, rtol=1e-4)


@pytest.mark.parametrize("pool", ["dense", "paged"])
def test_cuda_rope_engine_matches_generate_with_exact_launches(cuda_device,
                                                               pool):
    """qwen3 (head_dim 128) through the engine on the card, then drafting
    for itself: tokens equal ``generate``, which launches decode_attention
    once per layer and decode step; the engine launches its pool's slot
    kernel once per layer and decode step and never decode_attention."""
    cfg, params = _qwen3_hd128(cuda_device)
    reqs = [Request(uid=i, prompt=lm_batch(cfg.vocab_size, 1, p,
                                           seed=90 + i)[0], max_new_tokens=g)
            for i, (p, g) in enumerate([(16, 12), (33, 7), (9, 20),
                                        (20, 5)])]
    kern = ops.kernels()
    slot = ("paged_slot_decode_attention" if pool == "paged"
            else "slot_decode_attention")
    for fn in kern.values():
        fn.launches = 0
    kw = dict(capacity=2, max_len=64, k=4, pool=pool,
              pages=10 if pool == "paged" else None)
    eng = ContinuousBatchingEngine(cfg, params, **kw)
    got = eng.run(reqs)
    torch.cuda.synchronize()
    steps = eng.k * eng.n_decode_dispatches + eng.n_prefix_tail_steps
    want = {name: 0 for name in kern}
    want.update({slot: cfg.n_layers * steps,
                 "flash_attention": cfg.n_layers * eng.n_prefills})
    assert {name: fn.launches for name, fn in kern.items()} == want
    spec = ContinuousBatchingEngine(
        cfg, params, speculative=SpeculativeConfig(cfg, params, d=3),
        **dict(kw, pages=20 if pool == "paged" else None))
    got_spec = spec.run([Request(uid=r.uid, prompt=r.prompt,
                                 max_new_tokens=r.max_new_tokens)
                         for r in reqs])
    assert spec.n_spec_accepted == spec.n_spec_proposed > 0
    for r in reqs:
        n0 = cuda_decode.launches
        gen = generate(cfg, params, torch.from_numpy(r.prompt)[None].to(
            cuda_device), max_new_tokens=r.max_new_tokens, max_len=64)
        assert cuda_decode.launches == n0 + cfg.n_layers * (
            r.max_new_tokens - 1)
        np.testing.assert_array_equal(got[r.uid], gen[0].cpu().numpy())
        np.testing.assert_array_equal(got_spec[r.uid], gen[0].cpu().numpy())
