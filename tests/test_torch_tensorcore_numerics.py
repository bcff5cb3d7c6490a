"""Why the tensor-core kernels split float32 into TF32 hi and lo (3xTF32).

The CUDA ``tr_sandwich`` and ``flash_attention`` kernels run their float32
products on the H100's tensor cores, which multiply TF32 (10 mantissa
bits).  Emulated here on the CPU, with no card and no JAX: TF32 rounding
(``cvt.rna.tf32.f32``: round to nearest, ties away from zero, to 10
mantissa bits) by integer ops on the float32 bit pattern, the split x = hi
+ lo, and the kernels' products (exact TF32 products, float32 sums).  At
the growth path's sandwich widths and at gpt-base's and qwen3-0.6b's
attention head shapes, hi.hi + lo.hi + hi.lo meets ``chip_smoke.py``'s
float32 tolerance against a float64 reference, and one TF32 pass does not.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


def _f32_tol():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    atol, rtol = mod.TOL["float32"]
    return dict(atol=atol, rtol=rtol)


TOL = _f32_tol()


def tf32(x):
    """float32 -> the nearest TF32 value (ties away from zero), as float32."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x):
    hi = tf32(x)
    return hi, tf32(x - hi)


def mm_3x(a, b):
    """a @ b as the kernels compute it in float32: 3xTF32."""
    (ah, al), (bh, bl) = split(a), split(b)
    return al @ bh + ah @ bl + ah @ bh


def mm_1x(a, b):
    """a @ b in one TF32 pass (what the kernels must not do)."""
    return tf32(a) @ tf32(b)


def _rand(rng, *shape, scale=1.0):
    return torch.from_numpy(
        (scale * rng.standard_normal(shape)).astype(np.float32))


def test_tf32_rounding_is_round_to_nearest_ties_away():
    one = 1.0 + 2.0 ** -10  # the TF32 step just above 1
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -12,
                      -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12, 3.0e-3],
                     dtype=torch.float32)
    got = tf32(x)
    assert got[0] == 1.0
    assert got[1] == one  # a tie rounds away from zero
    assert got[2] == one
    assert got[3] == -one
    assert got[4] == 1.0
    # 10 explicit mantissa bits: the low 13 bits are zero
    assert int((got.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    hi, lo = split(x)
    assert torch.equal(hi, got)
    assert (((hi.double() + lo.double()) - x.double()).abs()
            <= 2.0 ** -22 * x.double().abs()).all()


@pytest.fixture(scope="module")
def sandwich():
    """gpt-small -> gpt-base widths (N 4 of the path's 144), inputs scaled
    as ``chip_smoke.sandwich_cases``: x ~ N(0, 1), operators by
    1/sqrt(fan-in), so |Y| ~ 1."""
    rng = np.random.default_rng(0)
    x = _rand(rng, 4, 512, 512)
    a_i = _rand(rng, 512, 768, scale=512 ** -0.5)
    a_o = _rand(rng, 512, 768, scale=512 ** -0.5)
    want = torch.einsum("nio,ij,om->njm", x.double(), a_i.double(),
                        a_o.double())
    return x, a_i, a_o, want


@pytest.mark.parametrize("passes", [3, 1])
def test_sandwich_needs_three_tf32_passes(sandwich, passes):
    """The kernel's two products, T = X[n] A_O and Y = A_I^T T (T split
    again in registers), held to the f32 tolerance: 3xTF32 passes, one
    pass fails."""
    x, a_i, a_o, want = sandwich
    mm = mm_3x if passes == 3 else mm_1x
    y = mm(a_i.mT, mm(x, a_o))
    close = torch.allclose(y.double(), want, **TOL)
    err = float((y.double() - want).abs().max())
    assert close == (passes == 3), (passes, err)


def _attention(q, k, v, mm):
    """Causal attention as the flash kernel orders it: S = Q K^T, scale,
    mask, float32 softmax, O = P V (P split again)."""
    S, hd = q.shape[-2:]
    s = mm(q, k.mT) * hd ** -0.5
    mask = torch.ones(S, S, dtype=torch.bool).tril()
    p = torch.softmax(torch.where(mask, s, -1e30), dim=-1)
    return mm(p, v)


@pytest.mark.parametrize("passes", [3, 1])
@pytest.mark.parametrize("hd", [64, 128])  # gpt-base, qwen3-0.6b heads
def test_attention_needs_three_tf32_passes(hd, passes):
    """Both attention products at S 512 (two heads, q, k, v ~ N(0, 1) as
    ``chip_smoke.flash_cases``) against float64 attention."""
    rng = np.random.default_rng(hd)
    q, k, v = (_rand(rng, 2, 512, hd) for _ in range(3))
    want = _attention(q.double(), k.double(), v.double(),
                      lambda a, b: a @ b)
    got = _attention(q, k, v, mm_3x if passes == 3 else mm_1x)
    close = torch.allclose(got.double(), want, **TOL)
    err = float((got.double() - want).abs().max())
    assert close == (passes == 3), (hd, passes, err)
