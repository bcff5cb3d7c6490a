"""The host side of the verify kernels' ring layout (``csrc/ring_verify.cuh``),
on the CPU: the plan covers each row's band walked from a multiple of 32,
the TMA-box rule picks the box only where an aligned tile of the ring is
one page's consecutive slots, and the pieces a band shrink while their
clusters would not all be resident at once.  The kernel itself runs only
on the card (``tests/test_torch_gpu.py``)."""
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch.kernels import decode_attention as kda
from repro_torch.kernels.decode_attention import (
    PAGED_TILE,
    ring_verify_box,
    ring_verify_splits,
    verify_span,
    verify_tiles,
)

TR = PAGED_TILE


def _band(off, cap, window, S):
    """(lo, la, n) of a row at offset ``off`` >= 0, as the kernel computes
    them: the band [lo, off + S), walked from la = lo rounded down to a
    multiple of 32, n positions from la."""
    lo = max(off - cap, off - window + 1 if window else 0, 0)
    la = lo // TR * TR
    return lo, la, off + S - la


def _pieces(n, chunk, nsplit):
    """The device's cut of a band of n positions (``devcut``): piece r is
    [r * cut, (r + 1) * cut) from la, clipped to n."""
    cut = min(chunk, -(-(-(-n // nsplit)) // TR) * TR)
    return [(min(n, r * cut), min(n, (r + 1) * cut)) for r in range(nsplit)]


def _clusters_of(per_sm):
    """A card of 132 SMs whose clusters of n blocks pack into GPCs of 16
    SMs (a stand-in for the occupancy query)."""
    return lambda n: (132 // 16) * ((16 * per_sm) // n)


@settings(max_examples=300, deadline=None)
@given(page=st.sampled_from([8, 16, 24, 32, 48, 64, 100]),
       nblk=st.integers(1, 20), window=st.one_of(st.none(),
                                                 st.integers(1, 3000)),
       S=st.integers(1, 40), G=st.sampled_from([1, 2, 4, 8]),
       B=st.integers(1, 9), KV=st.sampled_from([1, 2, 8]),
       per_sm=st.integers(1, 3),
       offs=st.lists(st.integers(-1, 20000), min_size=1, max_size=9))
def test_ring_plan_covers_every_aligned_band(page, nblk, window, S, G, B,
                                             KV, per_sm, offs):
    """Whatever the ring, window, chunk and offsets (done, wrapped many
    times, shorter than a tile): the pieces of ``ring_verify_splits`` over
    ``verify_span(..., ring=True)`` cover every row's band from its
    aligned start, each piece starts on a multiple of 32, and the span is
    never shorter than a band."""
    cap = nblk * page
    rows, tiles = verify_tiles(S, G)
    span = verify_span(S, cap, window, ring=True)
    assert span == min(cap, window - 1 if window else cap) + S + TR - 1
    chunk, nsplit = ring_verify_splits(B * tiles * KV, span, 132, per_sm,
                                       _clusters_of(per_sm))
    assert chunk % TR == 0 and 1 <= nsplit <= 16
    assert chunk * (nsplit - 1) < span <= chunk * nsplit
    for off in offs:
        if off < 0:
            continue
        lo, la, n = _band(off, cap, window, S)
        assert la % TR == 0 and la <= lo < la + TR and 0 < n <= span
        pieces = _pieces(n, chunk, nsplit)
        assert pieces[0][0] == 0 and pieces[-1][1] == n
        for (a0, a1), (b0, _) in zip(pieces, pieces[1:]):
            assert a1 == b0
        assert all(a % TR == 0 for a, b in pieces if a < b)


@settings(max_examples=300, deadline=None)
@given(page=st.integers(1, 130), nblk=st.integers(1, 20),
       hd=st.sampled_from([16, 20, 32, 64, 80, 128]),
       itemsize=st.sampled_from([2, 4]),
       off=st.integers(0, 50000), window=st.one_of(st.none(),
                                                   st.integers(1, 3000)))
def test_ring_box_rule_takes_the_box_only_for_one_page_tiles(
        page, nblk, hd, itemsize, off, window):
    """Where ``ring_verify_box`` holds, every whole cache tile the kernel
    boxes (aligned, ending at or before the offset) is 32 consecutive slots
    of one page of the ring; where pages do not hold whole tiles, some
    aligned tile of the ring is not (so only the row copies are right)."""
    cap = nblk * page
    box = ring_verify_box(page, hd, itemsize)
    assert box == (page % TR == 0 and hd in (64, 128)
                   and hd * itemsize % 16 == 0)

    def one_page(tp):
        slots = [(tp + i) % cap for i in range(TR)]
        return (all(b == a + 1 for a, b in zip(slots, slots[1:]))
                and slots[0] // page == slots[-1] // page)
    if box:
        lo, la, _ = _band(off, cap, window, 1)
        for tp in range(la, off - TR + 1, TR):
            assert one_page(tp), (page, nblk, tp)
    if page % TR:
        assert not all(one_page(tp) for tp in range(0, TR * cap, TR))


@pytest.mark.parametrize("per_sm,clusters,want", [
    # phase 17 (64 bands of 1,060): at two blocks an SM the split asks 4
    # pieces, but an H100 holds 62 clusters of 4 (79 of 3)
    (2, {4: 62, 3: 79}, (384, 3)),
    (1, {2: 66}, (544, 2)),  # the ring instance: one block an SM
    (2, {4: 64}, (288, 4)),  # every band's cluster resident: no change
    (2, {4: 10, 3: 10, 2: 10}, (1088, 1)),  # down to one piece
])
def test_ring_splits_shrink_until_every_cluster_is_resident(per_sm,
                                                            clusters, want):
    assert ring_verify_splits(
        64, 1060, 132, per_sm, lambda n: clusters.get(n, 10 ** 6)) == want


def test_ring_plan_asks_the_ring_instance(monkeypatch):
    """``_verify_plan(..., ring=True)`` plans the ring instance: its own
    occupancy and cluster queries, the aligned band's span; the full
    layout keeps the shared body's plan."""
    asked = []

    def occupancy(name, device, dtype, hd, rows, ring=False):
        asked.append(("blocks", name, rows, ring))
        return 1 if ring else 2

    def clusters(name, device, dtype, hd, n):
        asked.append(("clusters", name, n))
        return 66 if n <= 2 else 30
    monkeypatch.setattr(kda, "_sm_count", lambda device: 132)
    monkeypatch.setattr(kda, "_paged_per_sm", occupancy)
    monkeypatch.setattr(kda, "_ring_clusters", clusters)
    q = torch.zeros(8, 5, 16, 128)
    for name in ("paged_chunk_verify_attention", "chunk_verify_attention"):
        asked.clear()
        plan = kda._verify_plan(q, 8, 1088, 1025, name, ring=True)
        assert plan == (10, 1, 544, 2)
        assert asked == [("blocks", name, 10, True), ("clusters", name, 2)]
        asked.clear()
        assert kda._verify_plan(q, 8, 1088, 1025, name) == (10, 1, 288, 4)
        assert asked == [("blocks", name, 10, False)]
