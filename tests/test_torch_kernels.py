"""The port's attention kernels: plain versions vs the JAX Pallas kernels
(interpret mode) on the CPU, and the CPU dispatch rule of the wrappers.
The CUDA kernels are held against the plain versions in
``test_torch_gpu.py``."""
import jax  # noqa: F401  (both frameworks in one process, JAX on the CPU)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import F32_ATOL
from repro.kernels import ops as jops
from repro_torch.kernels import ops, ref
from repro_torch.kernels.decode_attention import (
    slot_decode_attention as cuda_slot,
)
from repro_torch.kernels.flash_attention import flash_attention as cuda_flash


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("B,H,KV,S,hd,causal", [
    (2, 4, 4, 16, 8, True),   # MHA
    (1, 8, 2, 32, 16, True),  # GQA 4:1
    (2, 6, 3, 24, 8, True),   # GQA 2:1, three key blocks
    (1, 4, 2, 16, 8, False),  # non-causal
])
def test_flash_plain_matches_pallas(B, H, KV, S, hd, causal):
    rng = np.random.default_rng(S + H)
    q, k, v = (_rand(rng, B, H, S, hd), _rand(rng, B, KV, S, hd),
               _rand(rng, B, KV, S, hd))
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal,
                                mode="interpret", bq=8, bk=8)
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_ATOL)


@pytest.mark.parametrize("B,H,KV,S,hd", [(4, 4, 4, 24, 8), (3, 8, 2, 32, 16)])
def test_slot_decode_plain_matches_pallas(B, H, KV, S, hd):
    """Per-row kv_len including 0 and the full length, plus a ``done`` row:
    both fold to exact zeros."""
    rng = np.random.default_rng(B * S)
    q, k, v = (_rand(rng, B, H, hd), _rand(rng, B, S, KV, hd),
               _rand(rng, B, S, KV, hd))
    kv_len = np.array([0, S, 5, 1][:B], np.int32)
    done = np.zeros(B, bool)
    done[2] = True
    want = jops.slot_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(kv_len),
        mode="interpret", done=jnp.asarray(done))
    got = ops.slot_decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(kv_len), done=torch.from_numpy(done))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_ATOL)
    assert (got[0] == 0).all() and (got[2] == 0).all()


def test_cpu_tensors_take_the_plain_version_and_kernels_refuse_them():
    """CPU tensors go to ``ref.py`` without touching the CUDA wrappers; the
    wrappers themselves raise on a CPU tensor instead of falling back."""
    rng = np.random.default_rng(0)
    q = torch.from_numpy(_rand(rng, 1, 2, 8, 64))
    k = torch.from_numpy(_rand(rng, 1, 2, 8, 64))
    before = (cuda_flash.launches, cuda_slot.launches)
    torch.testing.assert_close(ops.flash_attention(q, k, k),
                               ref.flash_attention_ref(q, k, k))
    pool = k.permute(0, 2, 1, 3).contiguous()  # (B, S, KV, hd)
    lens = torch.tensor([5], dtype=torch.int32)
    torch.testing.assert_close(
        ops.slot_decode_attention(q[:, :, 0], pool, pool, lens),
        ref.slot_decode_attention_ref(q[:, :, 0], pool, pool, lens))
    assert (cuda_flash.launches, cuda_slot.launches) == before
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_flash(q, k, k)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_slot(q[:, :, 0].contiguous(), pool, pool, lens)
