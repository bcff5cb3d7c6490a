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
from repro_torch.kernels import decode_attention as kda
from repro_torch.kernels import ops, ref
from repro_torch.kernels.decode_attention import (
    paged_decode_splits,
    verify_span,
    verify_tiles,
)
from repro_torch.kernels.decode_attention import (
    slot_decode_attention as cuda_slot,
)
from repro_torch.kernels.flash_attention import flash_attention as cuda_flash
from repro_torch.kernels.rglru_scan import scan_plan, scan_smem


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("B,H,KV,S,hd,causal", [
    (2, 4, 4, 16, 8, True),   # MHA
    (1, 8, 2, 32, 16, True),  # GQA 4:1
    (2, 6, 3, 24, 8, True),   # GQA 2:1, three key blocks
    (1, 4, 2, 16, 8, False),  # non-causal
    # the head dims of the repo's configs that the kernels run in buckets
    (1, 4, 2, 16, 16, True),
    (1, 4, 1, 16, 20, True),
    (2, 4, 2, 24, 32, False),
    (1, 2, 1, 16, 80, True),
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


@pytest.mark.parametrize("B,H,KV,S,hd", [(4, 4, 4, 24, 8), (3, 8, 2, 32, 16),
                                         (4, 4, 2, 24, 20), (4, 4, 4, 16, 32),
                                         (3, 2, 1, 16, 80)])
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


# Host-side planning of the paged-decode body's launches (132 SMs, an
# H100 SXM; ``per_sm`` is the instance's occupancy, which only the card
# reports): pieces of a multiple of 32 positions, at most 16 a band (one
# thread-block cluster), covering the band with no empty last piece.
def _check_pieces(chunk, nsplit, span):
    assert chunk % 32 == 0 and 1 <= nsplit <= 16
    assert chunk * (nsplit - 1) < span <= chunk * nsplit


@pytest.mark.parametrize("B,KV,ring,window,per_sm,want", [
    (8, 1, 2048, 2048, 1, (128, 16)),  # recurrentgemma-2b, f32 and bf16
    (8, 1, 2048, 1000, 1, (64, 16)),   # window < ring
    (6, 4, 300, 130, 2, (32, 5)),      # GQA hd 128: 24 bands
    (8, 2, 40, 1000, 2, (32, 2)),      # window > ring: the ring's 40
])
def test_dense_ring_pieces_come_from_paged_decode_splits(B, KV, ring, window,
                                                         per_sm, want):
    """``ring_decode_attention`` reads the dense pool as an arena of one
    page a row: its B * KV bands of up to min(window, ring) positions are
    cut as the paged ring's are."""
    span = min(window, ring)
    chunk, nsplit = paged_decode_splits(B, KV, span, 132, per_sm)
    assert (chunk, nsplit) == want
    _check_pieces(chunk, nsplit, span)


@pytest.mark.parametrize("B,S,KV,G,cap,window,per_sm,want", [
    # gpt-base's verify (d 4): 5 rows run in the 8-row instance
    (8, 5, 12, 1, 1024, None, 3, (5, 1, 288, 4)),
    (8, 5, 12, 1, 1024, None, 5, (5, 1, 192, 6)),   # bf16, capped at 4.5
    (8, 5, 8, 1, 1024, None, 3, (5, 1, 192, 6)),    # gpt-small's catch-up
    (8, 5, 8, 2, 1024, None, 2, (10, 1, 288, 4)),   # qwen3-0.6b self-draft
    (4, 16, 2, 8, 500, 64, 2, (16, 8, 32, 3)),      # S 16 x G 8, window 64
    (7, 5, 2, 4, 48, 8, 3, (10, 2, 32, 1)),         # 20 rows: 2 tiles
    (7, 5, 2, 8, 48, None, 2, (14, 3, 32, 2)),      # 40 rows: 3 tiles
    (8, 1, 12, 1, 1024, None, 3, (1, 1, 288, 4)),   # S 1: a one-query band
    # d >= 16: chunks past one tile of 32 keys and 16 query rows
    (8, 17, 12, 1, 1024, None, 3, (9, 2, 544, 2)),  # gpt-base at d 16
    (8, 33, 8, 1, 1024, None, 3, (11, 3, 544, 2)),  # gpt-small at d 32
    (4, 65, 2, 8, 500, None, 2, (16, 33, 576, 1)),  # S 65 x G 8: 33 tiles
])
def test_verify_plan_tiles_rows_and_cuts_bands(B, S, KV, G, cap, window,
                                               per_sm, want):
    """``paged_chunk_verify_attention``'s plan: the S * G query rows (i, g)
    of a (row, kv head) in as few tiles of at most 16 as hold them, as
    even as they come; each of the B * KV * tiles bands -- the attended
    cache (``window - 1`` positions at most) and the chunk's S keys -- cut
    as the decode body's bands are."""
    rows, tiles = verify_tiles(S, G)
    assert 1 <= rows <= 16 and rows * (tiles - 1) < S * G <= rows * tiles
    span = verify_span(S, cap, window)
    assert span == min(cap, window - 1 if window else cap) + S
    chunk, nsplit = paged_decode_splits(B * tiles, KV, span, 132, per_sm)
    assert (rows, tiles, chunk, nsplit) == want
    _check_pieces(chunk, nsplit, span)


def _wrapper_plan(monkeypatch, per_sm):
    """The wrappers' own planning on a card of 132 SMs whose instance
    holds ``per_sm`` blocks an SM; records (library, rows) of each
    occupancy query."""
    asked = []

    def occupancy(name, device, dtype, hd, rows):
        asked.append((name, rows))
        return per_sm
    monkeypatch.setattr(kda, "_sm_count", lambda device: 132)
    monkeypatch.setattr(kda, "_paged_per_sm", occupancy)
    return asked


@pytest.mark.parametrize("B,S,H,KV,Sc,window,per_sm,want", [
    # gpt-base's verify (d 4): 5 rows in the 8-row instance, f32 and bf16
    (8, 5, 12, 12, 1024, None, 3, (5, 1, 288, 4)),
    (8, 5, 12, 12, 1024, None, 5, (5, 1, 192, 6)),
    (8, 5, 8, 8, 1024, None, 3, (5, 1, 192, 6)),     # gpt-small's catch-up
    (4, 16, 16, 2, 500, 64, 2, (16, 8, 32, 3)),      # S 16 x G 8, window 64
    (6, 5, 8, 2, 300, 128, 2, (10, 2, 32, 5)),       # ring Sc 300, window 128
])
def test_dense_verify_plan_tiles_rows_and_cuts_bands(monkeypatch, B, S, H, KV,
                                                     Sc, window, per_sm,
                                                     want):
    """``chunk_verify_attention`` plans as the paged verify does, over a
    cache of Sc positions a row (the dense cache is B pages of Sc rows):
    the S * G query rows in tiles of at most 16, each of the B * KV *
    tiles bands -- the attended cache, ``window - 1`` positions at most in
    either layout, and the chunk's S keys -- cut as the body's bands are,
    at the occupancy of its own library's instance for ``rows``."""
    asked = _wrapper_plan(monkeypatch, per_sm)
    q = torch.zeros(B, S, H, 64)
    plan = kda._verify_plan(q, KV, Sc, window, "chunk_verify_attention")
    assert plan == want
    rows, tiles, chunk, nsplit = plan
    assert asked == [("chunk_verify_attention", rows)]
    assert (rows, tiles) == verify_tiles(S, H // KV)
    _check_pieces(chunk, nsplit, verify_span(S, Sc, window))
    # the same cut as the paged verify over a table of the same capacity
    assert kda._verify_plan(q, KV, Sc, window) == want


@pytest.mark.parametrize("B,KV,S,want", [
    (1, 12, 1024, (64, 16)),    # gpt-base generate at B 1: 16 pieces a band
    (8, 8, 576, (96, 6)),       # qwen3-0.6b generate at B 8 (phase 3)
    (8, 8, 1024, (192, 6)),     # ... over a max_len of 1024
    (64, 32, 4096, (4096, 1)),  # more bands than the card holds
    (2, 2, 37, (32, 2)),        # ragged: pieces of one tile
])
def test_decode_attention_pieces_come_from_paged_decode_splits(
        monkeypatch, B, KV, S, want):
    """``decode_attention`` cuts each (row, kv head) band of up to S
    positions as the body's SLOT bands are, at its own instance's
    occupancy for the group's G heads (3 blocks an SM: float32 at hd 64
    and 128); on the device each band then cuts its own kv_len over those
    pieces (multiples of 32, at most ``chunk``), which always covers it."""
    asked = _wrapper_plan(monkeypatch, 3)
    G = 2
    q = torch.zeros(B, KV * G, 128)
    chunk, nsplit = kda._paged_splits("decode_attention", q, KV, S)
    assert (chunk, nsplit) == want
    assert asked == [("decode_attention", G)]
    _check_pieces(chunk, nsplit, S)
    for n in (1, 31, 33, S // 3, S - 1, S):
        per = -(-n // nsplit)  # a band of n positions, as the device cuts it
        cut = min(chunk, -(-per // 32) * 32)
        assert cut % 32 == 0 and cut * nsplit >= n


@pytest.mark.parametrize("B,KV,S,per_sm,want", [
    (8, 12, 1024, 3, (256, 4)),  # gpt-base's pool, f32: 96 bands
    (8, 12, 1024, 5, (192, 6)),  # ... bf16, capped at 4.5 an SM
    (8, 8, 1024, 3, (192, 6)),   # qwen3-0.6b's pool (G 2)
    (4, 4, 512, 3, (32, 16)),    # GQA: 16 bands, 16 pieces each
    (3, 1, 100, 4, (32, 4)),     # a pool of 100: pieces of one tile
])
def test_slot_decode_pieces_come_from_paged_decode_splits(
        monkeypatch, B, KV, S, per_sm, want):
    """The dense slot cuts each (row, kv head) band of up to S positions
    (its pool row) as the paged slot cuts a table of S positions, at its
    own library's occupancy for the group's G heads; with the device's
    cut each band then cuts its own kv_len over those pieces (multiples of
    32, at most ``chunk``), which always covers it."""
    asked = _wrapper_plan(monkeypatch, per_sm)
    G = 2
    q = torch.zeros(B, KV * G, 64)
    chunk, nsplit = kda._paged_splits("slot_decode_attention", q, KV, S)
    assert (chunk, nsplit) == want
    assert asked == [("slot_decode_attention", G)]
    assert (chunk, nsplit) == paged_decode_splits(B, KV, S, 132, per_sm)
    _check_pieces(chunk, nsplit, S)
    for n in (1, 31, 33, S // 3, S - 1, S):
        per = -(-n // nsplit)  # a band of n positions, as the device cuts it
        cut = min(chunk, -(-per // 32) * 32)
        assert cut % 32 == 0 and cut * nsplit >= n


def _scan_cover(B, S, W, steps, blocks):
    """How often the kernel's launch of ``scan_plan``'s (steps, blocks)
    visits each lane (B, W) and each step S, from its own index rules: a
    TMA-path block x walks lanes w0 .. w0 + 31 of row x // wtiles in
    stages of ``steps`` (boxes clipped at W and S); a per-lane-path thread
    walks its one lane's whole sequence."""
    lanes, seq = np.zeros((B, W), int), np.zeros(S, int)
    if steps:
        wtiles = -(-W // 32)
        for x in range(blocks):
            bi, w0 = divmod(x, wtiles)
            lanes[bi, w0 * 32:w0 * 32 + 32] += 1
        for t0 in range(0, -(-S // steps) * steps, steps):
            seq[t0:t0 + steps] += 1
    else:
        for lane in range(blocks * 128):
            if lane < B * W:
                lanes[divmod(lane, W)] += 1
        seq += 1
    return lanes, seq


@pytest.mark.parametrize("B,S,W,item,want", [
    (8, 4096, 2560, 4, (32, 640)),   # recurrentgemma-2b admission, f32
    (8, 4096, 2560, 2, (64, 640)),   # ... bf16
    (1, 2048, 2560, 4, (128, 80)),   # a single admission: a tile an SM
    (1, 2048, 2560, 2, (256, 80)),   # ... bf16: the box's 256 rows
    (3, 2101, 2560, 4, (64, 240)),   # ragged sequence
    (2, 1, 128, 4, (8, 8)),          # S 1
    (1, 31, 100, 4, (32, 4)),        # W 100 f32: 400-byte rows, TMA
    (64, 4096, 4096, 4, (16, 8192)),  # more tiles than an SM holds
    (1, 31, 99, 4, (0, 1)),          # W 99 f32: 396-byte rows
    (2, 7, 100, 2, (0, 2)),          # W 100 bf16: 200-byte rows
])
def test_scan_plan_covers_every_lane_and_step_once(B, S, W, item, want):
    """``rglru_scan``'s plan: the TMA path only where W * itemsize is a
    multiple of 16 (else steps 0, the per-lane path); blocks of 32 lanes
    whose resident share of an SM's shared memory holds their stages; and
    its launch visits every (b, t, w) exactly once."""
    steps, blocks = scan_plan(B, S, W, item, 132)
    assert (steps, blocks) == want
    assert (steps > 0) == (W * item % 16 == 0)
    if steps:
        assert steps % 8 == 0 and steps <= 256
        per_sm = min(8, -(-blocks // 132))
        assert per_sm * scan_smem(steps, item) <= 220 * 1024
    lanes, seq = _scan_cover(B, S, W, steps, blocks)
    assert (lanes == 1).all() and (seq[:S] == 1).all()


def test_scan_plan_takes_the_per_lane_path_off_16_bytes():
    """A tensor whose data starts off 16 bytes (a view at an odd offset)
    cannot be described to the TMA unit either, whatever its width."""
    assert scan_plan(8, 64, 2560, 4, 132, ptrs=(0, 256, 512))[0] == 32
    assert scan_plan(8, 64, 2560, 4, 132, ptrs=(0, 260, 512)) == (0, 160)


def test_build_runs_every_nvcc_at_once_whatever_its_report(tmp_path,
                                                           monkeypatch):
    """``build_all`` starts one compiler a source and reads each report
    from a file: a report past a pipe's 64 KiB buffer does not hold its
    compiler until the reader gets to it.  A stand-in compiler prints a
    200 KB report and then works a second; ten of them end in well under
    the ten seconds they would take one after another."""
    import sys
    import time

    from repro_torch.kernels import build
    fake = tmp_path / "nvcc"
    fake.write_text(
        f"#!{sys.executable}\n"
        "import sys, time\n"
        "sys.stdout.write('x' * 200000)\n"
        "sys.stdout.flush()\n"
        "time.sleep(1.0)\n"
        "open(sys.argv[sys.argv.index('-o') + 1], 'w').write('lib')\n")
    fake.chmod(0o755)
    monkeypatch.setattr(build, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    t0 = time.perf_counter()
    secs = build.build_all()
    assert time.perf_counter() - t0 < 5.0
    assert secs.keys() == set(build.SOURCES)
    for name in build.SOURCES:
        assert len(build.ptxas_log[name]) == 200000
        assert build.cpu_seconds[name] >= 0.0
        assert build._target(name).read_text() == "lib"
    assert build.build_all() == {name: 0.0 for name in build.SOURCES}
