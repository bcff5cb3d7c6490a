"""Card-only tests of the port (``-m gpu``): each CUDA kernel against its
plain version, the wrappers' refusals, and the engine on the card.

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

from repro_torch.configs.base import ModelConfig
from repro_torch.data import lm_batch
from repro_torch.kernels import ops, ref
from repro_torch.kernels.decode_attention import (
    slot_decode_attention as cuda_slot,
)
from repro_torch.kernels.flash_attention import flash_attention as cuda_flash
from repro_torch.launch.serve import build_params, generate
from repro_torch.models import transformer
from repro_torch.serve import ContinuousBatchingEngine, Request

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


def test_cuda_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    q = _cuda_rand(cuda_device, torch.float32, 1, 2, 8, 32)
    with pytest.raises(ValueError, match="head_dim"):
        cuda_flash(q, q, q)
    h = _cuda_rand(cuda_device, torch.float16, 1, 2, 8, 64)
    with pytest.raises(TypeError, match="dtype"):
        cuda_flash(h, h, h)
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
    kern = ops.kernels()
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
