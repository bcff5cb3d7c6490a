"""Card-only tests of the port (``-m gpu``): each CUDA kernel against its
plain version, the wrappers' refusals, the engine (plain and speculative,
dense and paged pools; the transformer, griffin and xlstm), the growth
contraction and the sampling chains on the card.

This file imports neither JAX nor the JAX package, so it also runs on a
GPU machine without JAX:
    PYTHONPATH=src python -m pytest -q -m gpu --noconftest \
        tests/test_torch_gpu.py
Without a card every test skips (decided in the ``cuda_device`` fixture,
never at import or collection).
"""
import dataclasses
import importlib.util
import warnings
from pathlib import Path

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
from repro_torch.kernels.rglru_scan import rglru_scan_bwd as cuda_scan_bwd
from repro_torch.kernels.tr_sandwich import tr_sandwich as cuda_sandwich
from repro_torch.launch.serve import build_params, generate
from repro_torch.models import griffin, transformer, xlstm
from repro_torch.serve import (
    ContinuousBatchingEngine,
    Request,
    SamplingParams,
    SpeculativeConfig,
)
from repro_torch.serve import sampling


def _chip_smoke():
    """The repo root's ``chip_smoke.py``, loaded by path (the root is not
    on the import path of every test run)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_smoke = _chip_smoke()
counting_drops = _smoke.counting_drops
nan_outside_bands = _smoke.nan_outside_bands

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
    # head dims in buckets; one kv head of 20: 40-byte bf16 rows
    (2, 4, 1, 77, 20, torch.bfloat16, True),
    (2, 4, 1, 77, 20, torch.float32, True),
    (2, 8, 4, 130, 16, torch.bfloat16, False),
    (2, 8, 2, 200, 80, torch.float32, True),
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
@pytest.mark.parametrize("hd", [16, 20, 32, 64, 80, 128])
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
    (8, 96, 8, 2, 16, torch.float32),       # head dims in buckets
    (8, 96, 8, 1, 20, torch.bfloat16),      # 40-byte rows: the warp copies
    (8, 64, 4, 4, 32, torch.bfloat16),
    (5, 130, 8, 1, 80, torch.float32),
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
    q = _cuda_rand(cuda_device, torch.float32, 1, 2, 8, 144)
    with pytest.raises(ValueError, match="head_dim"):
        cuda_flash(q, q, q)  # past the 128 bucket
    h = _cuda_rand(cuda_device, torch.float16, 1, 2, 8, 64)
    with pytest.raises(TypeError, match="dtype"):
        cuda_flash(h, h, h)
    # bf16 rows one element off 16 bytes: the producer warp fills the
    # tiles TMA cannot
    b = _cuda_rand(cuda_device, torch.bfloat16, 1, 2, 8, 72)[..., 1:65]
    got = cuda_flash(b, b, b)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(),
                               ref.flash_attention_ref(b, b, b).float(),
                               **BF16_TOL)
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


# (Sc, hd, S) of the ring layout's cases: caches that are not a multiple
# of 32 (row copies) and ones that are (TMA boxes at hd 64 and 128), head
# dims of both buckets and one inside the 128 bucket, chunks of 5 and 17
RING_SHAPES = [(100, 64, 5), (300, 80, 17), (320, 128, 5), (320, 64, 17)]
CHUNK_GRID = ([(False, window, G, dtype, (100, 64, 5))
               for window in (None, 8) for G in (1, 2, 4)
               for dtype in (torch.float32, torch.bfloat16)]
              + [(True, window, G, dtype, shape)
                 for window in (None, 8, 400) for G in (1, 2, 4)
                 for dtype in (torch.float32, torch.bfloat16)
                 for shape in RING_SHAPES])


def _ring_offsets(cap, window):
    """Offsets of a ring verify's edge rows: done (-1), 0 and 5 (bands
    shorter than a tile), then 32 offsets several laps in whose bands start
    at every residue mod 32 (the first tile's rows below the band)."""
    reach = min(cap, window - 1 if window else cap)
    base = 7 * cap + reach
    return [-1, 0, 5] + [base + r for r in range(32)]


@pytest.mark.parametrize("ring,window,G,dtype,shape", CHUNK_GRID)
def test_cuda_chunk_verify_matches_plain(cuda_device, ring, window, G,
                                         dtype, shape):
    """Full layout: offsets -1, 0, 1, mid, Sc over a cache length that
    divides nothing (100).  Ring layout: windows below and above the
    cache, band starts at every residue mod 32, S * G past 16 (two or more
    query tiles), Sc of 100 and 300 (row copies) and 320 (boxes); done
    rows exact zeros."""
    Sc, hd, S = shape
    offsets = (_ring_offsets(Sc, window) if ring
               else [-1, 0, 1, 37, Sc, Sc - 1, 63])
    q, ck, cv, k, v, off = _chunk_case(cuda_device, dtype, len(offsets), S,
                                       2 * G, 2, Sc, hd, offsets)
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
    (8, 5, 64, 8, 512, 128, torch.float32),    # qwen2-vl-72b verify: G 8
    (8, 5, 64, 8, 512, 128, torch.bfloat16),
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
        wide = [torch.cat([t, t, t], -1)[..., :144].contiguous()
                for t in (q, ck, cv, k, v)]
        cuda_chunk(*wide[:5], off, **kw)
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


VERIFY_LONG_GRID = [(kind, S, G, dtype)
                    for kind in ("full", "ring", "paged", "paged ring")
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
    of 64 (a cap of 320, sentinel blocks) in either layout."""
    B, KV, hd = 6, 2, 64
    if kind.endswith("ring"):
        Sc, offsets = 300, [-1, 0, 37, 297, 305, 941]
    else:
        Sc, offsets = 320, [-1, 0, 37, 100, 320 - S, 330]
    q, ck, cv, k, v, off = _chunk_case(cuda_device, dtype, B, S, G * KV, KV,
                                       Sc, hd, offsets)
    if kind.startswith("paged"):
        fn, kw = cuda_paged_chunk, dict(ring=kind == "paged ring")
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


# (page, nblk) of the paged ring cases: rings of 48 and 80 (pages of 8
# and 16: row copies), 128 and 192 (pages of 32 and 64: TMA boxes)
RING_PAGES = [(8, 6), (16, 5), (32, 4), (64, 3)]
PAGED_RING_GRID = [(window, G, hd, dtype, pages)
                   for window in (None, 20, 1000) for G in (1, 2, 4, 8)
                   for hd in (64, 80, 128)
                   for dtype in (torch.float32, torch.bfloat16)
                   for pages in RING_PAGES]


@pytest.mark.parametrize("window,G,hd,dtype,pages", PAGED_RING_GRID)
def test_cuda_paged_chunk_verify_ring_matches_plain(cuda_device, window, G,
                                                    hd, dtype, pages):
    """The ring layout over pages of 8, 16, 32 and 64: offsets -1 (and a
    done row), 0 and 5, then bands several laps in that start at every
    residue mod 32, through tables with sentinel entries; windows below
    and above the ring; head dims of both buckets and one inside the 128
    bucket; S 5, or 17 at G 4 and 8 (S * G past 16: several query tiles).
    Done rows are exact zeros."""
    page, nblk = pages
    KV, S = 2, 17 if G >= 4 else 5
    offsets = _ring_offsets(nblk * page, window)
    B = len(offsets)
    n_pages = B * nblk // 3
    ck, cv, bt = _paged_case(cuda_device, dtype, B, KV, hd, n_pages, page,
                             nblk, seed=G + hd + page)
    q = _cuda_rand(cuda_device, dtype, B, S, G * KV, hd)
    k = _cuda_rand(cuda_device, dtype, B, S, KV, hd)
    v = _cuda_rand(cuda_device, dtype, B, S + 1, KV, hd)[:, :S].contiguous()
    off = torch.tensor(offsets, dtype=torch.int32, device=cuda_device)
    done = torch.zeros(B, dtype=torch.bool, device=cuda_device)
    done[5] = True
    n0 = cuda_paged_chunk.launches
    got = ops.paged_chunk_verify_attention(q, ck, cv, bt, k, v, off,
                                           ring=True, window=window,
                                           done=done)
    torch.cuda.synchronize()
    assert cuda_paged_chunk.launches == n0 + 1
    want = ref.paged_chunk_verify_attention_ref(
        q, ck, cv, bt, k, v, torch.where(done, -1, off), ring=True,
        window=window)
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))
    assert (got[0] == 0).all() and (got[5] == 0).all()


@pytest.mark.parametrize("kind", ["paged", "dense"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cap,hd,window", [(1088, 128, 1025), (256, 64, None),
                                          (264, 80, 100)])
def test_cuda_ring_verify_nan_outside_every_band_adds_nothing(
        cuda_device, kind, dtype, cap, hd, window):
    """Cache rows no row's band reads hold NaN (the fault layer plants it
    so): the ring verify stages some of them (the rows of a band's first
    tile below its start, boxes of whole pages), and its output equals its
    own output without the NaN, bit for bit, and is finite.  Phase 17's
    ring (boxes), a ring of 256 at hd 64 (boxes) and one of 264 at hd 80
    (row copies); pages of 64, 64 and 24 on the paged pool."""
    B, S, KV = 8, 5, 8
    offsets = [-1, 0, 40, cap - 3, cap + 31, 3 * cap + 17, 5 * cap + 1,
               9 * cap + 40]
    q = _cuda_rand(cuda_device, dtype, B, S, 2 * KV, hd)
    k = _cuda_rand(cuda_device, dtype, B, S, KV, hd)
    v = _cuda_rand(cuda_device, dtype, B, S + 1, KV, hd)[:, :S].contiguous()
    off = torch.tensor(offsets, dtype=torch.int32, device=cuda_device)
    if kind == "paged":
        page = 24 if cap % 32 else 64
        nblk = cap // page
        ck, cv, bt = _paged_case(cuda_device, dtype, B, KV, hd, B * nblk,
                                 page, nblk, seed=cap)
        kn, vn, n_nan = nan_outside_bands(ck, cv, offsets, cap, window,
                                          bt.cpu())

        def run(a, b):
            return cuda_paged_chunk(q, a, b, bt, k, v, off, ring=True,
                                    window=window)
    else:
        ck = _cuda_rand(cuda_device, dtype, B, cap, KV, hd)
        cv = _cuda_rand(cuda_device, dtype, B, cap + 1, KV, hd)[
            :, :cap].contiguous()
        kn, vn, n_nan = nan_outside_bands(ck, cv, offsets, cap, window)

        def run(a, b):
            return cuda_chunk(q, a, b, k, v, off, ring=True, window=window)
    assert n_nan > 0
    clean, poisoned = run(ck, cv), run(kn, vn)
    torch.cuda.synchronize()
    assert torch.isfinite(poisoned).all()
    assert torch.equal(poisoned, clean)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_paged_chunk_verify_ring_phase17_shape(cuda_device, dtype):
    """The windowed qwen3-0.6b's verify (chip_smoke.py phase 17): B 8, S 5,
    16 heads over 8 KV heads of 128, a ring of 1,088 in pages of 64
    (nblk 17), window 1,025, offsets past the ring."""
    B, S, KV, hd, page, nblk = 8, 5, 8, 128, 64, 17
    ck, cv, bt = _paged_case(cuda_device, dtype, B, KV, hd, B * nblk, page,
                             nblk, seed=17)
    bt = torch.arange(B * nblk, dtype=torch.int32,
                      device=cuda_device).reshape(B, nblk)
    q = _cuda_rand(cuda_device, dtype, B, S, 2 * KV, hd)
    k = _cuda_rand(cuda_device, dtype, B, S, KV, hd)
    v = _cuda_rand(cuda_device, dtype, B, S + 1, KV, hd)[:, :S].contiguous()
    off = torch.tensor([-1, 1100, 1150, 1300, 1500, 1600, 2100, 3333],
                       dtype=torch.int32, device=cuda_device)
    got = ops.paged_chunk_verify_attention(q, ck, cv, bt, k, v, off,
                                           ring=True, window=1025)
    want = ref.paged_chunk_verify_attention_ref(q, ck, cv, bt, k, v, off,
                                                ring=True, window=1025)
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
    with pytest.raises(ValueError, match="window"):
        cuda_paged_chunk(qc, k, v, bt, kc, kc, lens, ring=True, window=0)
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
] + [  # head dims run in the 64 and 128 buckets (20 in bf16: 40-byte rows)
    (kind, G, hd, dtype, page)
    for hd in (16, 20, 32, 80)
    for dtype in (torch.float32, torch.bfloat16)
    for kind, G, page in (("slot", 8, 24), ("ring", 10, 8), ("ring", 8, 64),
                          ("dense_ring", 4, 200), ("verify", 4, 24),
                          ("verify", 8, 64), ("dense_verify", 4, 40),
                          ("dense_verify", 1, 1024), ("decode", 8, 300),
                          ("decode", 1, 200))]


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


def _scan_grads(fn, a, b, h0, g):
    ins = [a.clone().requires_grad_(), b.clone().requires_grad_()] + (
        [] if h0 is None else [h0.clone().requires_grad_()])
    with torch.enable_grad():
        out = fn(ins[0], ins[1], None if h0 is None else ins[2])
        return out, torch.autograd.grad(out, ins, g)


@pytest.mark.parametrize("B,S,W", [(2, 512, 2560), (2, 2101, 2560),
                                   (1, 1, 2560), (4, 31, 100), (3, 37, 50),
                                   (2, 300, 99)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_h0", [True, False])
def test_cuda_rglru_scan_bwd_matches_plain(cuda_device, B, S, W, dtype,
                                           with_h0):
    """The backward kernel on both paths (TMA boxes where W * itemsize is
    on 16 bytes: W 2560, and W 100 in float32; one thread a lane
    otherwise), frozen tails included.  float32: da, db and dh0 equal the
    plain backward bit for bit and autograd through the plain forward
    within 1e-5; bfloat16: the error against a float32 route at most
    twice the plain bf16 route's."""
    dev = cuda_device
    g = torch.Generator(device=dev).manual_seed(S + W + 1)
    a = torch.rand(B, S, W, generator=g, device=dev) * 0.5 + 0.5
    b = torch.randn(B, S, W, generator=g, device=dev) * 0.1
    up = torch.randn(B, S, W, generator=g, device=dev)
    a[:, S // 2:], b[:, S // 2:] = 1.0, 0.0
    h0 = torch.randn(B, W, generator=g, device=dev) if with_h0 else None
    a, b, up = a.to(dtype), b.to(dtype), up.to(dtype)
    n0 = (cuda_scan.launches, cuda_scan_bwd.launches)
    out, got = _scan_grads(ops.rglru_scan, a, b, h0, up)
    torch.cuda.synchronize()
    assert (cuda_scan.launches, cuda_scan_bwd.launches) == (n0[0] + 1,
                                                            n0[1] + 1)
    assert [t.dtype for t in got] == [dtype, dtype] + (
        [torch.float32] if with_h0 else [])
    _, plain = _scan_grads(ref.rglru_scan_ref, a, b, h0, up)
    if dtype == torch.float32:
        h = ref.rglru_scan_ref(a, b, h0)
        da, db, dh0 = ref.rglru_scan_bwd_ref(a, up, h, h0)
        assert torch.equal(got[0], da) and torch.equal(got[1], db)
        if with_h0:
            assert torch.equal(got[2], dh0)
        for x, y in zip(got, plain):
            torch.testing.assert_close(x, y, atol=0.0, rtol=1e-5)
    else:
        _, f32 = _scan_grads(ref.rglru_scan_ref, a.float(), b.float(), h0,
                             up.float())
        for x, y, z in zip(got, plain, f32):
            err = (x.float() - z).abs().max().item()
            plain_err = (y.float() - z).abs().max().item()
            assert err <= 2 * plain_err + 1e-6, (err, plain_err)


def test_cuda_rglru_scan_bwd_refuses_what_it_does_not_take(cuda_device):
    dev = cuda_device
    a = torch.ones(1, 3, 32, device=dev)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_scan_bwd(a.cpu(), a.cpu(), a.cpu())
    with pytest.raises(TypeError, match="h must be float32"):
        cuda_scan_bwd(a.bfloat16(), a.bfloat16(), a.bfloat16())
    with pytest.raises(ValueError, match="shape"):
        cuda_scan_bwd(a, a[:, :2], a)
    with pytest.raises(ValueError, match="h0"):
        cuda_scan_bwd(a, a, a, torch.ones(1, 31, device=dev))


def test_cuda_griffin_train_step_runs_the_scan_kernels(cuda_device):
    """griffin-micro's train step on the card: its two recurrent layers
    launch the forward and the backward scan once each, and step 0's loss
    and gradient norm equal the CPU's plain route on the same weights
    (1e-5 and 1e-4 relative)."""
    from repro_torch.optim import OptimizerConfig, make_optimizer
    from repro_torch.train.steps import make_train_step
    from repro_torch.utils.pytree import tree_map
    cfg = get_config("griffin-micro")
    params = griffin.init(torch.Generator().manual_seed(0), cfg)
    tokens = torch.from_numpy(lm_batch(cfg.vocab_size, 4, 64, seed=1))
    opt = OptimizerConfig(lr=1e-3)
    init_fn, _ = make_optimizer(opt)
    step = make_train_step(cfg, opt)

    def run(dev):
        p = tree_map(lambda t: t.to(dev), params)
        return step(p, init_fn(p), {"tokens": tokens.to(dev)}, 1)[2]

    n0 = (cuda_scan.launches, cuda_scan_bwd.launches)
    got = run(cuda_device)
    torch.cuda.synchronize()
    assert (cuda_scan.launches - n0[0], cuda_scan_bwd.launches - n0[1]) == \
        (2, 2)
    want = run(torch.device("cpu"))
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(got["grad_norm"]),
                               float(want["grad_norm"]), rtol=1e-4)


def test_cuda_griffin_kernels_refuse_what_they_do_not_take(cuda_device):
    dev = cuda_device
    pos = torch.zeros(2, dtype=torch.int32, device=dev)
    k = torch.zeros(2, 8, 1, 64, device=dev)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_ring(torch.zeros(2, 4, 64), k, k, pos, window=4)
    with pytest.raises(ValueError, match="head_dim 320"):
        k320 = torch.zeros(2, 8, 1, 320, device=dev)
        cuda_ring(torch.zeros(2, 4, 320, device=dev), k320, k320, pos,
                  window=4)
    with pytest.raises(ValueError, match="H/KV = 17/1"):
        cuda_ring(torch.zeros(2, 17, 64, device=dev), k, k, pos, window=4)
    with pytest.raises(ValueError, match="window"):
        cuda_ring(torch.zeros(2, 4, 64, device=dev), k, k, pos, window=0)
    with pytest.raises(ValueError, match="slot_positions"):
        cuda_ring(torch.zeros(2, 4, 64, device=dev), k, k, pos.long(),
                  window=4)
    bt = torch.zeros(2, 1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="head_dim 320"):
        a320 = torch.zeros(3, 8, 1, 320, device=dev)
        cuda_paged_ring(torch.zeros(2, 4, 320, device=dev), a320, a320, bt,
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
    # the raw wrapper carries no graph; ops binds it to its backward
    a = torch.ones(1, 3, 2, device=dev, requires_grad=True)
    assert cuda_scan(a, torch.zeros(1, 3, 2, device=dev)).grad_fn is None
    assert ops.rglru_scan(a, torch.zeros(1, 3, 2, device=dev)).grad_fn \
        is not None


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
    q144 = _cuda_rand(cuda_device, torch.float32, 2, 4, 144)
    k144 = _cuda_rand(cuda_device, torch.float32, 2, 2, 40, 144)
    with pytest.raises(ValueError, match="head_dim 144"):
        cuda_decode(q144, k144, k144, lens)
    wide = _cuda_rand(cuda_device, torch.float32, 2, 2, 40, 128)
    with pytest.raises(ValueError, match="stride 1"):
        cuda_decode(q, wide[..., ::2], wide[..., ::2], lens)
    # a cache off 16 bytes: the body copies its rows a row at a time
    flat = _cuda_rand(cuda_device, torch.float32, 2 * 2 * 40 * 64 + 1)
    odd = flat[1:].view(2, 2, 40, 64)
    got = cuda_decode(q, odd, odd, lens)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref.decode_attention_ref(q, odd, odd,
                                                             lens),
                               atol=F32_ATOL, rtol=1e-4)
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
    return _redrawn(dev, get_config("qwen3-0.6b-smoke").replace(
        head_dim=128))


def _redrawn(dev, cfg):
    """``cfg``'s params on ``dev`` with the embedding at std 0.02 and every
    other matrix and bias at 0.2 (norm scales kept)."""
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
    _rope_engine_case(cuda_device, pool, *_qwen3_hd128(cuda_device))


def _rope_engine_case(cuda_device, pool, cfg, params):
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


@pytest.mark.parametrize("pool", ["dense", "paged"])
def test_cuda_windowed_engine_matches_generate_with_exact_launches(
        cuda_device, pool):
    """qwen3 (head_dim 128) with a window of 24 over a ring of 24: the
    engine's slot decode launches its pool's ring kernel once per layer
    and step, a self-drafting engine the dense ring verify (dense pool)
    or the paged ring verify (paged pool) twice per layer and block; no
    flash prefill (a window takes the plain windowed attention).  Tokens
    equal ``generate`` far past the window."""
    cfg, params = _qwen3_hd128(cuda_device)
    cfg = cfg.replace(name="qwen3-win", window=24)
    reqs = [Request(uid=i, prompt=lm_batch(cfg.vocab_size, 1, p,
                                           seed=95 + i)[0], max_new_tokens=g)
            for i, (p, g) in enumerate([(30, 12), (9, 30), (20, 16)])]
    kern = ops.kernels()
    ring = ("paged_ring_decode_attention" if pool == "paged"
            else "ring_decode_attention")
    verify = ("paged_chunk_verify_attention" if pool == "paged"
              else "chunk_verify_attention")
    for fn in kern.values():
        fn.launches = 0
    kw = dict(capacity=2, max_len=64, k=4, pool=pool)
    eng = ContinuousBatchingEngine(cfg, params, **kw)
    got = eng.run(reqs)
    torch.cuda.synchronize()
    steps = eng.k * eng.n_decode_dispatches + eng.n_prefix_tail_steps
    want = {name: 0 for name in kern}
    want[ring] = cfg.n_layers * steps
    assert {name: fn.launches for name, fn in kern.items()} == want
    for fn in kern.values():
        fn.launches = 0
    spec = ContinuousBatchingEngine(
        cfg, params, speculative=SpeculativeConfig(cfg, params, d=3), **kw)
    got_spec = spec.run([dataclasses.replace(r) for r in reqs])
    torch.cuda.synchronize()
    blocks = spec.k * spec.n_decode_dispatches
    want = {name: 0 for name in kern}
    want.update({ring: cfg.n_layers * 3 * blocks,
                 verify: 2 * cfg.n_layers * blocks})
    assert {name: fn.launches for name, fn in kern.items()} == want
    assert spec.n_spec_accepted == spec.n_spec_proposed > 0
    for r in reqs:
        gen = generate(cfg, params, torch.from_numpy(r.prompt)[None].to(
            cuda_device), max_new_tokens=r.max_new_tokens, max_len=64)
        np.testing.assert_array_equal(got[r.uid], gen[0].cpu().numpy())
        np.testing.assert_array_equal(got_spec[r.uid], gen[0].cpu().numpy())


# ------------------------------------------------------------------ sampling
@pytest.mark.parametrize("shape", [(50257,), (3,), (5, 37), (8, 50257)])
def test_cuda_sampling_chains_bits_and_uniforms_equal_cpu(cuda_device,
                                                          shape):
    """The threefry chains (roots, splits, fold_in), random bits and
    uniforms on the card equal the CPU's bit for bit (chip_smoke.py phase
    13's first check)."""
    uids = torch.tensor([0, 1, 12345, 2**31 - 1])
    out = {}
    for dev in ("cpu", cuda_device):
        keys = sampling.request_key(5, uids.to(dev))
        carry, sub = sampling.next_keys(keys)
        out[str(dev)] = [keys, carry, sub, sampling.fold_in(sub, 5),
                         sampling.random_bits(sub, shape),
                         sampling.uniform(sub, shape)]
    for got, want in zip(out["cuda"], out["cpu"]):
        assert got.device.type == "cuda"
        assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("sp", [
    SamplingParams(temperature=0.8, top_k=50, top_p=0.95, seed=5),
    SamplingParams(temperature=0.8, top_k=12, top_p=0.9),
    SamplingParams(temperature=1.3, top_k=50)])
def test_cuda_filtered_probs_match_cpu(cuda_device, sp):
    """``filtered_probs`` over gpt-base-wide rows on the card: the CPU's
    support, probabilities within 1e-6; the sampled tokens equal."""
    logits = 3 * torch.randn(8, 50257,
                             generator=torch.Generator().manual_seed(13))
    want = sampling.filtered_probs(logits, sp)
    got = sampling.filtered_probs(logits.to(cuda_device), sp)
    assert torch.equal(got.cpu() > 0, want > 0)
    torch.testing.assert_close(got.cpu(), want, atol=1e-6, rtol=0)
    keys = sampling.request_key(sp.seed, torch.arange(8))
    assert torch.equal(
        sampling.sample_probs(got, keys.to(cuda_device)).cpu(),
        sampling.sample_probs(want, keys))


# ------------------------------------------------- live upgrade, recovery
def _hd64_source(dev):
    """``_hd64_pair``'s 2 x 128 source with seeded weights, and its target
    config (the upgrade grows it)."""
    cfg_t, _, cfg_s, _ = _hd64_pair(dev)
    params = build_params(cfg_s, seed=3, device=dev)
    return cfg_s, params, cfg_t


@pytest.mark.parametrize("pool", ["dense", "paged"])
def test_cuda_hot_swap_is_token_exact_and_prewarmed(cuda_device, pool):
    """The hd-64 source grown live (rank-1 Mango on the card) and swapped
    in at dispatch 2, its source drafting after: every request's committed
    prefix equals the source's ``generate`` and its suffix the grown
    target's on prompt ++ committed; the swap builds, loads and launches
    nothing, and every kernel launched after it was launched by the
    prewarm first."""
    from repro_torch.kernels import build
    from repro_torch.serve import UpgradeManager

    cfg_s, p_s, cfg_t = _hd64_source(cuda_device)
    eng = ContinuousBatchingEngine(cfg_s, p_s, capacity=3, max_len=64, k=2,
                                   pool=pool)
    mgr = UpgradeManager(eng, cfg_t, upgrade_at=2, spec_d=3)
    kern = ops.kernels()
    for fn in kern.values():
        fn.launches = 0
    mgr.start(background=False)
    warm = {n for n, f in kern.items() if f.launches}
    assert kern["tr_sandwich"].launches > 0  # the growth ran the sandwich
    at = {}
    apply = eng._apply_upgrade

    def watched(m):
        libs = sorted(build._libs)
        before = {n: f.launches for n, f in kern.items()}
        apply(m)
        at.update(libs=sorted(build._libs) == libs,
                  quiet={n: f.launches for n, f in kern.items()} == before,
                  launches={n: f.launches for n, f in kern.items()})

    eng._apply_upgrade = watched
    reqs = [Request(uid=i, prompt=lm_batch(cfg_s.vocab_size, 1, p,
                                           seed=40 + i)[0], max_new_tokens=g)
            for i, (p, g) in enumerate([(9, 14), (20, 12), (14, 13)])]
    got = eng.run(reqs)
    torch.cuda.synchronize()
    assert mgr.state == "swapped" and at["libs"] and at["quiet"]
    after = {n for n, f in kern.items() if f.launches > at["launches"][n]}
    assert after and after <= warm
    assert eng.speculative is not None and eng.n_spec_proposed > 0
    assert eng.pages_in_use == 0 and eng.rejected == {}
    by_uid = {r.uid: r for r in mgr.resumed_requests}
    assert set(by_uid) == {r.uid for r in reqs}
    for r in reqs:
        nc = by_uid[r.uid].n_committed
        pre = generate(cfg_s, p_s, torch.from_numpy(r.prompt)[None].to(
            cuda_device), max_new_tokens=nc, max_len=64)[0].cpu().numpy()
        post = generate(cfg_t, mgr.grown_params, torch.from_numpy(
            by_uid[r.uid].prompt)[None].to(cuda_device),
            max_new_tokens=r.max_new_tokens - nc,
            max_len=64)[0].cpu().numpy()
        np.testing.assert_array_equal(got[r.uid], np.concatenate([pre,
                                                                  post]))


def test_cuda_sampled_crash_resume_matches_uninterrupted(cuda_device,
                                                         tmp_path):
    """A sampled gpt-small on the card with a journal and a snapshot, dropped
    after 2 iterations, restored on the card and resumed from the journal:
    the tokens equal the uninterrupted run's, except from a step where the
    uninterrupted run's perturbed scores (replayed) nearly tie."""
    from repro_torch.models import get_family
    from repro_torch.serve import (
        RequestJournal,
        read_journal,
        recovery_requests,
        restore_engine,
        snapshot_engine,
    )

    # a registered config (a restore looks its arch up by name)
    cfg_s = get_config("gpt-small")
    p_s = build_params(cfg_s, seed=3, device=cuda_device)
    sp = SamplingParams(temperature=0.9, top_k=20, seed=4)
    specs = [(9, 14), (20, 12), (14, 13), (6, 10)]

    def reqs():
        return [Request(uid=i, prompt=lm_batch(cfg_s.vocab_size, 1, p,
                                               seed=60 + i)[0],
                        max_new_tokens=g) for i, (p, g) in enumerate(specs)]

    def engine(journal=None):
        return ContinuousBatchingEngine(cfg_s, p_s, capacity=2, max_len=64,
                                        k=2, sampling=sp, journal=journal)

    want = engine().run(reqs())
    snapshot_engine(engine(), str(tmp_path / "snap"))
    path = str(tmp_path / "j.jsonl")
    j = RequestJournal(path)
    eng = engine(j)
    for r in reqs():
        eng.submit(r)
    eng.step()
    eng.step()
    j.close()
    del eng
    resumed, done = recovery_requests(read_journal(path))
    assert any(r.n_committed for r in resumed)
    eng2 = restore_engine(str(tmp_path / "snap"),
                          journal=RequestJournal(path))
    assert eng2.device.type == "cuda" and eng2.sampling == sp
    got = {**done, **eng2.run(resumed)}
    eng2.journal.close()
    fam = get_family(cfg_s)
    for r in reqs():
        a, b = got[r.uid], want[r.uid]
        diff = np.nonzero(a != b)[0]
        if not diff.size:
            continue
        # replay the uninterrupted chain up to the first mismatch
        t = int(diff[0])
        cache = fam.init_cache(cfg_s, 1, 64, device=cuda_device)
        logits, cache = fam.prefill(p_s, {"tokens": torch.from_numpy(
            r.prompt)[None].to(cuda_device)}, cfg_s, cache)
        keys = sampling.request_key(sp.seed, torch.tensor(
            [r.uid], device=cuda_device))
        for i in range(t + 1):
            keys, sub = sampling.next_keys(keys)
            if i < t:
                logits, cache = fam.decode_step(
                    p_s, torch.tensor([int(b[i])], dtype=torch.int32,
                                      device=cuda_device),
                    len(r.prompt) + i, cache, cfg_s)
        probs = sampling.filtered_probs(logits, sp)
        scores = sampling.gumbel(sub, logits.shape[-1:]) + torch.where(
            probs > 0, torch.log(probs.clamp_min(1e-38)), sampling.NEG_INF)
        top = scores.float().topk(2, dim=-1).values[0]
        assert float(top[0] - top[1]) < 1e-4, (r.uid, t)


# ------------------------------------------ griffin speculation, the faults
@pytest.mark.parametrize("pool", ["dense", "paged"])
def test_cuda_griffin_spec_engine_matches_generate_with_exact_launches(
        cuda_device, pool):
    """Griffin drafting for griffin on the card (rings wrapping, window 16;
    the paged pool under page pressure): tokens equal ``generate``; every
    block runs the ring kernel (paged ring on a paged pool) once per
    attention layer for each of the draft's d proposals, the target's S
    verify steps and the draft's S catch-up steps, and admission the scan
    once per recurrent layer of each model.  The model drafting for
    itself accepts every proposal; a nudged copy of it, some."""
    cfg, params = _griffin_hd64(cuda_device)
    n_rec = griffin.block_pattern(cfg).count("rec")
    n_attn = cfg.n_layers - n_rec
    gen = torch.Generator(device=cuda_device).manual_seed(1)

    def nudge(t):
        if isinstance(t, dict):
            return {k: nudge(v) for k, v in t.items()}
        return t + 2e-3 * torch.randn(t.shape, generator=gen,
                                      device=cuda_device)
    d, k = 3, 2
    reqs = [Request(uid=i, prompt=lm_batch(cfg.vocab_size, 1, p,
                                           seed=90 + i)[0], max_new_tokens=g)
            for i, (p, g) in enumerate([(4, 20), (21, 12), (9, 16),
                                        (30, 9)])]
    want = {r.uid: generate(cfg, params, torch.from_numpy(r.prompt)[None].to(
        cuda_device), max_new_tokens=r.max_new_tokens,
        max_len=64)[0].cpu().numpy() for r in reqs}
    ring = "paged_ring_decode_attention" if pool == "paged" else \
        "ring_decode_attention"
    kern = ops.kernels()
    for draft in (params, nudge(params)):
        for fn in kern.values():
            fn.launches = 0
        eng = ContinuousBatchingEngine(
            cfg, params, capacity=2, max_len=64, k=k, pool=pool,
            pages=3 if pool == "paged" else None,
            speculative=SpeculativeConfig(cfg, draft, d=d))
        got = eng.run(reqs)
        torch.cuda.synchronize()
        expect = {name: 0 for name in kern}
        expect.update({ring: n_attn * (3 * d + 2) * k
                       * eng.n_decode_dispatches,
                       "rglru_scan": n_rec * eng.n_prefills})
        assert {name: fn.launches for name, fn in kern.items()} == expect
        for r in reqs:
            np.testing.assert_array_equal(got[r.uid], want[r.uid])
        assert eng.n_spec_proposed > 0 and eng.n_spec_fallbacks == 0
        if draft is params:
            assert eng.acceptance_rate == 1.0
        if pool == "paged":
            assert eng.pages_in_use == 0 and eng.pages_highwater <= 3


def test_cuda_poison_pool_on_a_cuda_arena(cuda_device):
    """``poison_pool`` on the card: NaN in page ``pid`` of every layer's k
    and v of a paged group, in the slot's rows of a dense float group;
    block tables and every other byte untouched, in place."""
    from repro_torch.serve import faults as faults_lib

    cfg, params = _griffin_hd64(cuda_device)
    eng = ContinuousBatchingEngine(cfg, params, capacity=3, max_len=64,
                                   pool="paged", pages=5)
    pool = eng.pool
    for grp in pool.values():
        for name, t in grp.items():
            if t.is_floating_point():
                t.uniform_()
    before = {g: {n: t.clone() for n, t in grp.items()}
              for g, grp in pool.items()}
    assert faults_lib.poison_pool(pool, 1, 2) is pool
    torch.cuda.synchronize()
    for g, grp in pool.items():
        for name, t in grp.items():
            nan = torch.isnan(t)
            if name == "bt":
                assert torch.equal(t, before[g][name])
                continue
            hit = torch.zeros_like(nan)
            if "bt" in grp:
                hit[:, 2] = True
            else:
                hit[:, 1] = True
            assert torch.equal(nan, hit), (g, name)
            assert torch.equal(t[~hit], before[g][name][~hit])


FAULT_SPECS = [(6, 12), (9, 10), (4, 14), (12, 8), (7, 9)]


@pytest.mark.parametrize("plan,pool", [
    ("nan@2", "dense"), ("nan@2", "paged"), ("oom@1:2", "dense"),
    ("slow@2:0.01", "dense"), ("malformed@2", "dense"),
    ("nan@2:0", "spec")])
def test_cuda_fault_kinds_leave_survivors_exact(cuda_device, plan, pool):
    """Each fault kind on the card, against the fault-free run: a NaN
    quarantines exactly one request, whose tokens are a prefix of its
    fault-free tokens (a paged pool then degrades to full reservation); a
    draft-pool NaN demotes speculation without changing a token; oom,
    slow and malformed cost no token; no page is left in use."""
    from repro_torch.serve import FaultPlan

    cfg = _gqa_hd64_cfg()
    params = build_params(cfg, seed=0, device=cuda_device)
    reqs = [Request(uid=i, prompt=lm_batch(cfg.vocab_size, 1, p,
                                           seed=40 + i)[0], max_new_tokens=g)
            for i, (p, g) in enumerate(FAULT_SPECS)]
    kw = dict(capacity=2, max_len=64, k=2,
              pool="paged" if pool == "paged" else "dense")
    if pool == "spec":
        plan = "nan@2:0"
        kw["speculative"] = SpeculativeConfig(cfg, params, d=2)
    plain = ContinuousBatchingEngine(cfg, params, **kw).run(reqs)
    faults = FaultPlan.parse(plan)
    if pool == "spec":
        faults = FaultPlan([dataclasses.replace(faults.faults[0], pool=1)])
    eng = ContinuousBatchingEngine(cfg, params, faults=faults, **kw)
    got = eng.run(reqs)
    assert eng.n_faults_injected == 1
    bad = [u for u, o in eng.outcomes.items() if o != "finished"]
    if plan.startswith("nan") and pool != "spec":
        assert eng.n_quarantined == 1 and len(bad) == 1
        n = len(got[bad[0]])
        assert n < len(plain[bad[0]])
        np.testing.assert_array_equal(got[bad[0]], plain[bad[0]][:n])
    elif plan.startswith("malformed"):
        assert bad == [-1002] and "empty prompt" in eng.rejected[-1002]
        bad = []
    else:
        assert not bad and eng.n_quarantined == 0
    if pool == "spec":
        assert eng.n_spec_fallbacks == 1
    if pool == "paged":
        assert eng._arena_degraded and eng.n_degraded_admissions > 0
        assert eng.pages_in_use == 0
    for r in reqs:
        if r.uid not in bad:
            np.testing.assert_array_equal(got[r.uid], plain[r.uid])


def test_cuda_hang_past_a_deadline_and_crash_resume(cuda_device, tmp_path,
                                                    monkeypatch):
    """On a fake clock (a hang advances it): a hang past the engine's
    deadline expires every request at the next boundary; a plan crash at
    dispatch 3 with a journal resumes to the uninterrupted tokens."""
    from repro_torch.serve import (
        EngineKilled,
        Fault,
        FaultPlan,
        RequestJournal,
        read_journal,
        recovery_requests,
    )
    from repro_torch.serve import faults as faults_lib

    now = [0.0]
    monkeypatch.setattr(faults_lib, "_monotonic", lambda: now[0])
    monkeypatch.setattr(faults_lib, "_sleep",
                        lambda s: now.__setitem__(0, now[0] + s))
    cfg = _gqa_hd64_cfg()
    params = build_params(cfg, seed=0, device=cuda_device)

    def reqs():
        return [Request(uid=i, prompt=lm_batch(cfg.vocab_size, 1, p,
                                               seed=40 + i)[0],
                        max_new_tokens=g)
                for i, (p, g) in enumerate(FAULT_SPECS)]
    kw = dict(capacity=2, max_len=64, k=2)
    eng = ContinuousBatchingEngine(cfg, params, deadline=0.5, faults=FaultPlan(
        [Fault("hang", 2, duration=1.0)]), **kw)
    got = eng.run(reqs())
    assert eng.n_expired == len(FAULT_SPECS) == len(got)
    assert set(eng.outcomes.values()) == {"expired"}
    assert eng.n_decode_dispatches == 2
    want = ContinuousBatchingEngine(cfg, params, **kw).run(reqs())
    path = str(tmp_path / "j.jsonl")
    j = RequestJournal(path)
    eng = ContinuousBatchingEngine(cfg, params, journal=j, faults=FaultPlan(
        [Fault("crash", 3)]), **kw)
    with pytest.raises(EngineKilled):
        eng.run(reqs())
    j.close()
    resumed, done = recovery_requests(read_journal(path))
    assert any(r.n_committed for r in resumed)
    got = {**done, **ContinuousBatchingEngine(cfg, params, **kw).run(
        resumed)}
    for uid in want:
        np.testing.assert_array_equal(got[uid], want[uid])


# ------------------------------------------------------------------- xlstm
XLSTM_SPECS = [(3, 12), (21, 6), (9, 10), (30, 8), (5, 14)]


def _xlstm_smoke(dev):
    cfg = get_config("xlstm-1.3b-smoke")
    return cfg, build_params(cfg, seed=0, device=dev)


def _xlstm_reqs(cfg, specs, seed0=110):
    return [Request(uid=i, prompt=lm_batch(cfg.vocab_size, 1, p,
                                           seed=seed0 + i)[0],
                    max_new_tokens=g) for i, (p, g) in enumerate(specs)]


def _generate_on(dev, cfg, params, reqs):
    return {r.uid: generate(cfg, params, torch.from_numpy(r.prompt)[None].to(
        dev), max_new_tokens=r.max_new_tokens, max_len=64)[0].cpu().numpy()
        for r in reqs}


@pytest.mark.parametrize("pool", ["dense", "paged"])
def test_cuda_xlstm_engine_matches_generate_and_launches_nothing(
        cuda_device, pool):
    """xlstm-1.3b-smoke served on the card (the paged pool under page
    pressure: its conv tails page, one page a request, 2 pages for 3
    slots): tokens equal ``generate``'s; the path runs no kernel of the
    port (the mLSTM and sLSTM are plain PyTorch, as in the reference)."""
    cfg, params = _xlstm_smoke(cuda_device)
    reqs = _xlstm_reqs(cfg, XLSTM_SPECS)
    kern = ops.kernels()
    for fn in kern.values():
        fn.launches = 0
    eng = ContinuousBatchingEngine(cfg, params, capacity=3, max_len=64, k=4,
                                   pool=pool,
                                   pages=2 if pool == "paged" else None)
    got = eng.run(reqs)
    torch.cuda.synchronize()
    assert {name: fn.launches for name, fn in kern.items()} == {
        name: 0 for name in kern}
    want = _generate_on(cuda_device, cfg, params, reqs)
    for uid in want:
        np.testing.assert_array_equal(got[uid], want[uid])
    assert eng.pool_kind == pool
    if pool == "paged":
        assert eng.pages_in_use == 0 and eng.pages_highwater == 2
        assert eng.pool["m"]["conv"].shape[1] == 3  # 2 pages + scratch


@pytest.mark.parametrize("pool", ["dense", "paged"])
def test_cuda_xlstm_spec_engine_matches_generate(cuda_device, pool):
    """xlstm drafting for xlstm on the card (the paged pool shared by
    target and draft, 3 pages for 2 slots): tokens equal ``generate``'s;
    the model drafting for itself accepts every proposal, a nudged copy
    some but not all."""
    cfg, params = _xlstm_smoke(cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(1)

    def nudge(t):
        if isinstance(t, dict):
            return {k: nudge(v) for k, v in t.items()}
        return t + 1e-2 * torch.randn(t.shape, generator=gen,
                                      device=cuda_device)
    reqs = _xlstm_reqs(cfg, [(4, 16), (21, 12), (9, 14)], seed0=120)
    want = _generate_on(cuda_device, cfg, params, reqs)
    for draft in (params, nudge(params)):
        eng = ContinuousBatchingEngine(
            cfg, params, capacity=2, max_len=64, k=2, pool=pool,
            pages=3 if pool == "paged" else None,
            speculative=SpeculativeConfig(cfg, draft, d=3))
        got = eng.run(reqs)
        for uid in want:
            np.testing.assert_array_equal(got[uid], want[uid])
        assert eng.n_spec_proposed > 0 and eng.n_spec_fallbacks == 0
        if draft is params:
            assert eng.acceptance_rate == 1.0
        else:
            assert 0.0 < eng.acceptance_rate < 1.0
        if pool == "paged":
            assert eng.pages_in_use == 0


@pytest.mark.parametrize("plens", [None, [512, 300]])
def test_cuda_mlstm_chunkwise_matches_sequential_and_the_cpu(cuda_device,
                                                            plens):
    """xlstm-1.3b's mLSTM cell shape (4 heads of 1,024) over 512
    positions in chunks of 256, with bucketed pads (row 1: its second
    chunk holds pads only after position 300): the chunkwise form against
    the stepped recurrence on the card (1e-4 of the largest entry) and
    against the CPU's chunkwise form (F32_ATOL scaled the same way)."""
    B, NH, S, dh = 2, 4, 512, 1024
    g = torch.Generator().manual_seed(7)
    q, k, v = (torch.randn((B, NH, S, dh), generator=g) for _ in range(3))
    q = q * dh ** -0.5
    log_i = torch.randn((B, NH, S), generator=g)
    log_f = torch.nn.functional.logsigmoid(
        3.0 + torch.randn((B, NH, S), generator=g))
    if plens is not None:
        valid = (torch.arange(S)[None] < torch.tensor(plens)[:, None])[
            :, None]
        log_i = torch.where(valid, log_i, float("-inf"))
        log_f = torch.where(valid, log_f, 0.0)
    ins = (q, k, v, log_i, log_f)
    h_cpu, s_cpu = xlstm.mlstm_chunkwise(*ins, chunk=256)
    dev_ins = [t.to(cuda_device) for t in ins]
    h, st = xlstm.mlstm_chunkwise(*dev_ins, chunk=256)
    h_seq, st_seq = xlstm.mlstm_sequential(*dev_ins)

    def rel(a, b):
        return float((a.cpu() - b.cpu()).abs().max()
                     / b.abs().max().clamp_min(1.0).cpu())
    assert rel(h, h_seq) <= 1e-4
    assert rel(h, h_cpu) <= 1e-4
    for a, b, c in zip(st, st_seq, s_cpu):
        assert torch.isfinite(a).all()
        assert rel(a, b) <= 1e-4 and rel(a, c) <= 1e-4


def test_cuda_xlstm_growth_launches_the_sandwich_exactly(cuda_device):
    """xlstm-1.3b-smoke grown into an 8 x 128 xlstm by rank-1 Mango on the
    card: one sandwich a block group (m_blocks, s_blocks) a growth, and
    the grown params equal the CPU's growth of the same weights and
    operator (1e-5 of each leaf's largest entry)."""
    from repro_torch.utils.pytree import tree_flatten_with_paths, tree_map

    cfg_s = get_config("xlstm-1.3b-smoke")
    cfg_t = cfg_s.replace(name="xlstm-smoke-big", n_layers=8, d_model=128,
                          slstm_every=4)
    small = xlstm.init(torch.Generator().manual_seed(0), cfg_s)
    gop, op = growlib.build("mango", cfg_s, cfg_t, rank=1, device="cpu")
    with torch.no_grad():
        want = growlib.grow_params(gop, op, small)
    gop_d, _ = growlib.build("mango", cfg_s, cfg_t, rank=1,
                             device=cuda_device)
    kern = ops.kernels()
    for fn in kern.values():
        fn.launches = 0
    with torch.no_grad():
        got = growlib.grow_params(
            gop_d, tree_map(lambda t: t.to(cuda_device), op),
            tree_map(lambda t: t.to(cuda_device), small))
    torch.cuda.synchronize()
    expect = {name: 0 for name in kern}
    expect["tr_sandwich"] = 2
    assert {name: fn.launches for name, fn in kern.items()} == expect
    w = dict(tree_flatten_with_paths(want))
    for path, t in tree_flatten_with_paths(got):
        err = (t.cpu() - w[path]).abs().max() / w[path].abs().max().clamp_min(
            1e-30)
        assert float(err) <= 1e-5, path


@pytest.mark.parametrize("pool", ["dense", "paged"])
def test_cuda_xlstm_graphed_step_equals_the_eager_step(cuda_device, pool):
    """The single-token step replayed from its CUDA graph against the same
    step run eagerly, on two copies of an engine's pool mid-run (a done
    row among the live ones; on the paged pool the conv tails go through
    the block tables, the done row's to the scratch page): logits and
    every pool leaf equal bit for bit, over several replays, with and
    without the head."""
    from repro_torch.utils.pytree import tree_leaves, tree_map

    cfg, params = _xlstm_smoke(cuda_device)
    eng = ContinuousBatchingEngine(cfg, params, capacity=3, max_len=64,
                                   k=2, pool=pool,
                                   pages=3 if pool == "paged" else None)
    for r in _xlstm_reqs(cfg, [(9, 30), (21, 30), (5, 30)]):
        eng.submit(r)
    eng.step()
    eager = tree_map(lambda t: t.clone(), eng.pool)
    graphed = tree_map(lambda t: t.clone(), eng.pool)
    done = torch.tensor([False, True, False], device=cuda_device)
    nxt = torch.tensor([3, 4, 5], dtype=torch.int32, device=cuda_device)
    try:
        for i in range(4):
            step = xlstm.decode_step_slots if i % 2 == 0 else \
                xlstm._slot_state_step
            xlstm.CUDA_GRAPHS = False
            want, _ = step(params, nxt, nxt, eager, cfg, done=done)
            xlstm.CUDA_GRAPHS = True
            got, _ = step(params, nxt, nxt, graphed, cfg, done=done)
            assert (got is None) == (want is None)
            if got is not None:
                assert torch.equal(got, want)
            for a, b in zip(tree_leaves(graphed), tree_leaves(eager)):
                assert torch.equal(a, b)
    finally:
        xlstm.CUDA_GRAPHS = True


@pytest.mark.parametrize("plens", [None, [24, 9, 17]])
def test_cuda_xlstm_graphed_slstm_loop_equals_the_eager_loop(cuda_device,
                                                             plens):
    """A 24-token prefill of 3 rows without grad, its sLSTM loop replayed
    a position at a time from a CUDA graph, against the eager loop (with
    and without bucketed pads): logits and every cache leaf bit for bit;
    under grad the loop stays eager (the train step differentiates it)."""
    from repro_torch.utils.pytree import tree_leaves

    cfg, params = _xlstm_smoke(cuda_device)
    toks = torch.from_numpy(lm_batch(cfg.vocab_size, 3, 24, seed=7)).to(
        cuda_device)
    lens = None if plens is None else torch.tensor(plens, device=cuda_device)
    out = []
    try:
        for graph in (False, True):
            xlstm.CUDA_GRAPHS = graph
            cache = xlstm.init_cache(cfg, 3, 64, device=cuda_device)
            with torch.no_grad():
                logits, cache = xlstm.prefill_full(
                    params, {"tokens": toks, "plens": lens}, cfg, cache)
            out.append((logits, cache))
    finally:
        xlstm.CUDA_GRAPHS = True
    (la, ca), (lb, cb) = out
    assert torch.equal(la, lb)
    for a, b in zip(tree_leaves(ca), tree_leaves(cb)):
        assert torch.equal(a, b)
    assert xlstm._SLSTM_GRAPHS


# ---------------------------------------------------------------- MoE
def _moe_inputs(dev, S, **kw):
    """A routed-experts layer of phi3.5-moe-42b-smoke's widths (d 64, 4
    experts of 128 at top 2) and (2, S, 64) inputs, drawn on the CPU and
    copied to ``dev``."""
    from repro_torch.models import moe

    cfg = get_config("phi3.5-moe-42b-smoke").replace(**kw)
    gen = torch.Generator().manual_seed(S)
    p = moe.init_moe(gen, cfg, layers=None, std=0.2)
    x = torch.randn(2, S, cfg.d_model, generator=gen)
    return cfg, p, x


@pytest.mark.parametrize("S,kw", [
    (1, {}), (40, dict(capacity_factor=0.75)),
    (40, dict(capacity_factor=0.75, moe_dispatch_dtype="bfloat16")),
    (40, dict(capacity_factor=0.75, n_shared_experts=1,
              router_score="sigmoid")),
    (1024, dict(capacity_factor=0.5))])
def test_cuda_moe_mlp_matches_the_cpu(cuda_device, S, kw):
    """``moe_mlp`` on the card against the same call on the CPU: the same
    expert choices, drops (some, below capacity factor 1) and aux, and
    outputs within 1e-5 (f32: the batched expert products sum in another
    order)."""
    from repro_torch.models import moe

    cfg, p, x = _moe_inputs(cuda_device, S, **kw)
    with torch.no_grad(), counting_drops(cfg) as want_drops:
        want, want_aux = moe.moe_mlp(x, p, cfg)
    pd = {k: v.to(cuda_device) for k, v in p.items()}
    with torch.no_grad(), counting_drops(cfg) as drops:
        got, aux = moe.moe_mlp(x.to(cuda_device), pd, cfg)
    _, idx, _ = moe.router(x, p["w_router"], top_k=cfg.top_k,
                           score=cfg.router_score)
    _, idx_d, _ = moe.router(x.to(cuda_device), pd["w_router"],
                             top_k=cfg.top_k, score=cfg.router_score)
    assert torch.equal(idx_d.cpu(), idx)
    assert drops == want_drops and (drops["dropped"] > 0) == (S > 1)
    torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(aux.cpu(), want_aux, atol=1e-6, rtol=1e-6)


def _phi_reqs(cfg):
    return [Request(uid=i, prompt=lm_batch(cfg.vocab_size, 1, p,
                                           seed=120 + i)[0],
                    max_new_tokens=g)
            for i, (p, g) in enumerate([(16, 12), (33, 7), (9, 20),
                                        (20, 5)])]


def _moe_launches(eng, kern):
    """One flash a layer per prefill group (target and draft in a
    speculative admission), one slot decode a layer per decode step, and
    per speculative block d slot decodes and two chunk verifies a
    layer."""
    L = eng.cfg.n_layers
    paged = eng.pool_kind == "paged"
    slot = ("paged_slot_decode_attention" if paged
            else "slot_decode_attention")
    steps = eng.k * eng.n_decode_dispatches
    want = {name: 0 for name in kern}
    if eng.speculative is None:
        want.update({slot: L * (steps + eng.n_prefix_tail_steps),
                     "flash_attention": L * eng.n_prefills})
    else:
        verify = ("paged_chunk_verify_attention" if paged
                  else "chunk_verify_attention")
        want.update({slot: L * eng.speculative.d * steps,
                     verify: 2 * L * steps,
                     "flash_attention": L * eng.n_prefills})
    return want


def test_cuda_moe_engine_routes_agree_with_exact_launches(cuda_device):
    """phi3.5-moe-42b-smoke on the card.  At capacity factor 8.0 (= E / K,
    nothing drops) the dense pool, a paged pool and the model drafting
    for itself (d 3) on both pools give ``generate``'s tokens; at the
    published 1.25 (prefills drop choices) the paged pool gives the dense
    pool's.  Every run launches its kernels exactly."""
    cfg8 = get_config("phi3.5-moe-42b-smoke").replace(capacity_factor=8.0)
    params = transformer.init(torch.Generator(device=cuda_device).manual_seed(
        0), cfg8)
    reqs = _phi_reqs(cfg8)
    kern = ops.kernels()

    def run(cfg, pool, spec=False):
        kw = dict(capacity=2, max_len=64, k=2 if spec else 4, pool=pool,
                  prefill_bucket=8)
        if spec:
            kw["speculative"] = SpeculativeConfig(cfg, params, d=3)
        elif pool == "paged":
            kw["pages"] = 10
        eng = ContinuousBatchingEngine(cfg, params, **kw)
        for fn in kern.values():
            fn.launches = 0
        with counting_drops(cfg) as drops:
            got = eng.run([dataclasses.replace(r) for r in reqs])
        torch.cuda.synchronize()
        assert {n: fn.launches for n, fn in kern.items()} == \
            _moe_launches(eng, kern)
        assert eng.pages_in_use in (None, 0)
        return got, drops

    gen = {r.uid: generate(cfg8, params, torch.from_numpy(r.prompt)[None].to(
        cuda_device), max_new_tokens=r.max_new_tokens, max_len=64)[0]
        .cpu().numpy() for r in reqs}
    for pool in ("dense", "paged"):
        for spec in (False, True):
            got, drops = run(cfg8, pool, spec)
            assert drops["dropped"] == 0
            for r in reqs:
                np.testing.assert_array_equal(got[r.uid], gen[r.uid])
    cfg = cfg8.replace(capacity_factor=1.25)
    (dense, drops), (paged, _) = run(cfg, "dense"), run(cfg, "paged")
    assert drops["dropped"] > 0
    for r in reqs:
        np.testing.assert_array_equal(paged[r.uid], dense[r.uid])


# ---------------------------------------------------------------- MLA
def _mla_attn(dev, full, B, S, Sc):
    """An MLA attention layer's latent-space inputs: deepseek-v3-671b-
    smoke's widths, or the full model's (128 heads, kv_lora_rank 512,
    qk_nope_dim 128, qk_rope_dim 64, v_head_dim 128); drawn on the CPU,
    returned there and copied to ``dev``."""
    cfg = get_config("deepseek-v3-671b" if full else
                     "deepseek-v3-671b-smoke").replace(
        param_dtype="float32", compute_dtype="float32")
    H, R = cfg.n_heads, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    g = torch.Generator().manual_seed(Sc + S)
    cpu = {"p": {"kv_norm": 1 + 0.1 * torch.randn(R, generator=g),
                 "w_uk": 0.05 * torch.randn(R, H * dn, generator=g),
                 "w_uv": 0.05 * torch.randn(R, H * dv, generator=g)},
           "q_nope": torch.randn(B, S, H, dn, generator=g),
           "q_rope": torch.randn(B, S, H, dr, generator=g),
           "ckv": torch.randn(B, Sc, R, generator=g),
           "kr": torch.randn(B, Sc, dr, generator=g),
           "ckv_chunk": torch.randn(B, S, R, generator=g),
           "kr_chunk": torch.randn(B, S, dr, generator=g)}

    def to(t):
        return {k: to(v) for k, v in t.items()} if isinstance(t, dict) \
            else t.to(dev)

    return cfg, cpu, to(cpu)


@pytest.mark.parametrize("full", [False, True])
def test_cuda_mla_absorbed_decode_and_verify_match_the_cpu(cuda_device,
                                                           full):
    """MLA's latent-space attention on the card against the same call on
    the CPU, within 1e-5 in f32: the absorbed decode at per-row kv_len
    (a row of length 0 gives exact zeros) and the chunk verify of S 5 at
    per-row offsets over [cache ‖ chunk] (a done row gives exact
    zeros)."""
    B, Sc = 4, 96
    cfg, c, d = _mla_attn(cuda_device, full, B, 1, Sc)
    kv_len = torch.tensor([96, 0, 37, 1], dtype=torch.int32)
    want = transformer._mla_absorbed_decode(
        c["q_nope"], c["q_rope"], c["ckv"], c["kr"], c["p"], cfg,
        kv_len=kv_len)
    got = transformer._mla_absorbed_decode(
        d["q_nope"], d["q_rope"], d["ckv"], d["kr"], d["p"], cfg,
        kv_len=kv_len.to(cuda_device))
    torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=1e-5)
    assert (got[1] == 0).all()
    cfg, c, d = _mla_attn(cuda_device, full, B, 5, Sc)
    offsets = torch.tensor([0, 40, 91, 12], dtype=torch.int32)
    done = torch.tensor([False, False, False, True])
    want = transformer._mla_chunk_verify(
        c["q_nope"], c["q_rope"], (c["ckv"], c["kr"]), c["ckv_chunk"],
        c["kr_chunk"], c["p"], cfg, offsets, done)
    got = transformer._mla_chunk_verify(
        d["q_nope"], d["q_rope"], (d["ckv"], d["kr"]), d["ckv_chunk"],
        d["kr_chunk"], d["p"], cfg, offsets.to(cuda_device),
        done.to(cuda_device))
    torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=1e-5)
    assert (got[3] == 0).all()


def test_cuda_mla_engine_routes_agree_without_attention_kernels(
        cuda_device):
    """deepseek-v3-671b-smoke on the card.  At capacity factor 2.0 (= E /
    K, nothing drops) the dense latent pool, a paged latent pool and the
    model drafting for itself (d 3) on both pools give ``generate``'s
    tokens; at the published 1.25 (prefills drop choices) the paged pool
    gives the dense pool's.  MLA attends in plain products: no kernel of
    the port launches in any run."""
    cfg2 = get_config("deepseek-v3-671b-smoke").replace(capacity_factor=2.0)
    params = transformer.init(torch.Generator(device=cuda_device).manual_seed(
        0), cfg2)
    reqs = _phi_reqs(cfg2)
    kern = ops.kernels()

    def run(cfg, pool, spec=False):
        kw = dict(capacity=2, max_len=64, k=2 if spec else 4, pool=pool,
                  prefill_bucket=8)
        if spec:
            kw["speculative"] = SpeculativeConfig(cfg, params, d=3)
        elif pool == "paged":
            kw["pages"] = 10
        eng = ContinuousBatchingEngine(cfg, params, **kw)
        assert eng.cache_layout == "full-mla"
        for fn in kern.values():
            fn.launches = 0
        with counting_drops(cfg) as drops:
            got = eng.run([dataclasses.replace(r) for r in reqs])
        torch.cuda.synchronize()
        assert {n: fn.launches for n, fn in kern.items()} == {
            n: 0 for n in kern}
        assert eng.pages_in_use in (None, 0)
        if spec:
            assert eng.acceptance_rate == 1.0
        return got, drops

    for fn in kern.values():
        fn.launches = 0
    gen = {r.uid: generate(cfg2, params, torch.from_numpy(r.prompt)[None].to(
        cuda_device), max_new_tokens=r.max_new_tokens, max_len=64)[0]
        .cpu().numpy() for r in reqs}
    assert {n: fn.launches for n, fn in kern.items()} == {n: 0 for n in kern}
    for pool in ("dense", "paged"):
        for spec in (False, True):
            got, drops = run(cfg2, pool, spec)
            assert drops["dropped"] == 0
            for r in reqs:
                np.testing.assert_array_equal(got[r.uid], gen[r.uid])
    cfg = cfg2.replace(capacity_factor=1.25)
    (dense, drops), (paged, _) = run(cfg, "dense"), run(cfg, "paged")
    assert drops["dropped"] > 0
    for r in reqs:
        np.testing.assert_array_equal(paged[r.uid], dense[r.uid])


# -------------------------------------------------------------- qwen2-vl
def test_cuda_mrope_matches_the_cpu(cuda_device):
    """One M-RoPE rotation at three distinct position streams (an image
    span's grid) on the card equals the CPU's, at qwen2-vl-72b's heads
    (chip_smoke.py phase 21's check)."""
    err = _smoke.check_mrope_on_card(get_config("qwen2-vl-72b"),
                                     cuda_device)
    assert err <= 2e-5


def test_cuda_qwen2vl_kernel_shapes_match_plain(cuda_device):
    """Every attention kernel at qwen2-vl-72b's shapes (64 query heads
    over 8 KV heads of 128; phase 21's flash row, dense and paged slot,
    ``decode_attention``, dense and paged verify at B 8, S 5), f32 and
    bf16, against its plain version (chip_smoke.py phase 21's check)."""
    errs = _smoke.qv_kernel_checks(get_config("qwen2-vl-72b"), cuda_device)
    assert set(errs) == set(_smoke.QV_KERNELS)


@pytest.mark.parametrize("pool", ["dense", "paged"])
def test_cuda_mrope_engine_matches_generate_with_exact_launches(cuda_device,
                                                                pool):
    """qwen2-vl-72b-smoke at head_dim 128 (M-RoPE sections (16, 24, 24),
    qkv bias, GQA 4/2) through the engine and drafting for itself, as the
    RoPE engine test runs qwen3: tokens equal ``generate``, launches
    exact."""
    cfg = get_config("qwen2-vl-72b-smoke").replace(
        head_dim=128, mrope_sections=(16, 24, 24))
    _rope_engine_case(cuda_device, pool, *_redrawn(cuda_device, cfg))
