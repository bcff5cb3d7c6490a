"""Wrappers of the CUDA decode-side attention kernels, seven kernels over
one body, ``csrc/paged_decode.cuh``: ``csrc/slot_decode_attention.cu``
(one query per slot over the dense pool), ``csrc/decode_attention.cu``
(one query per row over a head-major cache, read through strides),
``csrc/chunk_verify_attention.cu`` (a speculative verify chunk per slot,
full or ring layout) and ``csrc/ring_decode_attention.cu`` (one query per
slot over a ring-buffer window cache), which read a dense cache as an
arena of one page a row, and ``csrc/paged_slot_decode_attention.cu``,
``csrc/paged_ring_decode_attention.cu`` and
``csrc/paged_chunk_verify_attention.cu`` (page arenas read through
per-row block tables).  The body cuts each (row, kv head) band into a
thread-block cluster of pieces merged in the launch; the host picks the
cut (``paged_decode_splits``) and, for a verify, the tiles of its S * G
query rows (``verify_tiles``).  The two verifies' ring layout runs in a
body of its own, ``csrc/ring_verify.cuh`` (tiles aligned to 32 positions,
one TMA box a whole cache tile where ``ring_verify_box`` holds, tensor-core
products), planned by the same functions.

Each checks what its kernel takes, allocates the output, launches on the
current stream and counts launches in ``<wrapper>.launches``.  ``ops``
routes CPU tensors to the plain versions and folds ``done`` rows into
``kv_len = 0`` / ``offsets = -1`` / ``slot_positions = -1`` before calling
these.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# head dims: any hd up to the largest bucket (64 and 128; the ring also
# 256), run in the smallest bucket that holds it (csrc/paged_decode.cuh)
HEAD_DIM_MAX = 128
GROUPS = (1, 2, 4, 8)
NBLK_MAX = 2048  # block-table entries per row the paged kernels take


def _entry():
    fn = build.load("slot_decode_attention").slot_decode_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check_tensors(what, floats, *ints):
    """Device, layout and dtype rules the kernels share: every tensor on
    the first one's CUDA device and contiguous; the float tensors
    (``floats``, (name, tensor) pairs) share float32 or bfloat16 (rows or
    bases off 16 bytes take the body's row-at-a-time copies); ``ints`` are
    the (name, tensor) int tensors (per-row lengths, block tables), checked
    by the caller for dtype and shape."""
    first = floats[0][1]
    for name, t in (*floats, *ints):
        if t.device.type != "cuda" or t.device != first.device:
            raise ValueError(f"{what}: {name} must be a CUDA tensor on "
                             f"{first.device} (got {t.device})")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    names = ", ".join(name for name, _ in floats)
    for name, t in floats:
        if t.dtype != first.dtype or t.dtype not in DTYPES:
            raise TypeError(f"{what}: {name} has dtype {t.dtype}; {names} "
                            "must share float32 or bfloat16")


def _check_one_query(what, q, k, v, kv_len, *, pool):
    """The rules of the one-query kernels (the slot and decode_attention
    entries).  With
    ``pool`` k, v are the (B, S, KV, hd) slot pool and must be contiguous;
    else they are head-major (B, KV, S, hd), read through their B, KV and
    S strides with hd contiguous."""
    layout = "(B, S, KV, hd)" if pool else "(B, KV, S, hd)"
    _check_tensors(what, (("q", q), ("k", k), ("v", v)) if pool
                   else (("q", q),), ("kv_len", kv_len))
    if q.dim() != 3 or k.dim() != 4:
        raise ValueError(f"{what}: q must be (B, H, hd) and k, v {layout}")
    B, H, hd = q.shape
    kh, vh = (k.transpose(1, 2), v.transpose(1, 2)) if pool else (k, v)
    KV, S = kh.shape[1], kh.shape[2]
    if kh.shape != (B, KV, S, hd) or vh.shape != kh.shape:
        raise ValueError(f"{what}: q {tuple(q.shape)} needs k, v of shape "
                         f"{layout}; got {tuple(k.shape)}, {tuple(v.shape)}")
    for name, t in (("k", kh), ("v", vh)):
        if t.device != q.device:
            raise ValueError(f"{what}: {name} must be a CUDA tensor on "
                             f"{q.device} (got {t.device})")
        if t.dtype != q.dtype:
            raise TypeError(f"{what}: {name} has dtype {t.dtype}; q, k, v "
                            "must share float32 or bfloat16")
        if t.stride(-1) != 1:
            raise ValueError(f"{what}: {name} must have a contiguous head "
                             f"dim (stride 1, got {t.stride(-1)})")
    if vh.stride() != kh.stride():
        raise ValueError(f"{what}: k and v must share strides (got "
                         f"{k.stride()} and {v.stride()})")
    if kv_len.dtype != torch.int32 or kv_len.shape != (B,):
        raise ValueError(f"{what}: kv_len must be ({B},) int32 (got "
                         f"{tuple(kv_len.shape)} {kv_len.dtype})")
    _check_heads(what, H, KV, hd)
    if S < 1:
        raise ValueError(f"{what}: the cache needs at least one position")


# the dense slot's bands cut their own kv_len over the pieces on the device
# (True), or take the host's cut of the whole pool row (False), as the
# paged slot does
SLOT_CUT_ON_DEVICE = True


def slot_decode_attention(q, k, v, kv_len):
    """q: (B, H, hd); k, v: (B, S, KV, hd) pool layout; kv_len: (B,) int32
    -> (B, H, hd).  kv_len 0 gives exact zeros; kv_len > S reads S.  Each
    (row, kv head) band of up to S positions is one thread-block cluster
    of ``_paged_splits`` pieces."""
    what = "slot_decode_attention"
    _check_one_query(what, q, k, v, kv_len, pool=True)
    B, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    chunk, nsplit = _paged_splits(what, q, KV, S)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = _entry()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
            out.data_ptr(), DTYPES[q.dtype], B, S, KV, H, hd, chunk, nsplit,
            int(SLOT_CUT_ON_DEVICE), hd ** -0.5,
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")
    slot_decode_attention.launches += 1
    return out


slot_decode_attention.launches = 0


# ------------------------------------------- head-major (strided) decode
# decode_attention's bands cut their own kv_len over the pieces on the
# device (generate's cache is max_len wide and mostly unfilled); False
# takes the host's cut of the whole cache axis, as the paged slot does
DECODE_CUT_ON_DEVICE = True


@functools.lru_cache(maxsize=None)
def _sm_count(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def _decode_entry():
    fn = build.load("decode_attention").decode_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                       + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 3
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def decode_attention(q, k, v, kv_len):
    """q: (B, H, hd) contiguous; k, v: (B, KV, S, hd) head-major, read
    through their B, KV and S strides (hd contiguous: a contiguous tensor,
    or the pool's (B, S, KV, hd) cache as its ``transpose(1, 2)`` view);
    kv_len: (B,) int32 -> (B, H, hd).  kv_len 0 gives exact zeros; kv_len
    > S reads S.  Each (row, kv head) band of up to S positions is one
    thread-block cluster of ``_paged_splits`` pieces."""
    what = "decode_attention"
    _check_one_query(what, q, k, v, kv_len, pool=False)
    B, H, hd = q.shape
    KV, S = k.shape[1], k.shape[2]
    chunk, nsplit = _paged_splits(what, q, KV, S)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = _decode_entry()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
            out.data_ptr(), DTYPES[q.dtype], B, S, KV, H, hd,
            *k.stride()[:3], chunk, nsplit, int(DECODE_CUT_ON_DEVICE),
            hd ** -0.5, torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


def _chunk_entry():
    fn = build.load("chunk_verify_attention").chunk_verify_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 12
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check_chunk(q, ck, cv, k, v, offsets, window):
    what = "chunk_verify_attention"
    _check_tensors(what, (("q", q), ("ck", ck), ("cv", cv), ("k", k),
                          ("v", v)), ("offsets", offsets))
    if q.dim() != 4 or ck.dim() != 4:
        raise ValueError(f"{what}: q must be (B, S, H, hd) and ck, cv "
                         "(B, Sc, KV, hd)")
    B, S, H, hd = q.shape
    Sc, KV = ck.shape[1], ck.shape[2]
    if ck.shape != (B, Sc, KV, hd) or cv.shape != ck.shape:
        raise ValueError(f"{what}: q {tuple(q.shape)} needs ck, cv of shape "
                         f"(B, Sc, KV, hd); got {tuple(ck.shape)}, "
                         f"{tuple(cv.shape)}")
    if k.shape != (B, S, KV, hd) or v.shape != k.shape:
        raise ValueError(f"{what}: q {tuple(q.shape)} needs the chunk's k, v "
                         f"of shape (B, S, KV, hd); got {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if offsets.dtype != torch.int32 or offsets.shape != (B,):
        raise ValueError(f"{what}: offsets must be ({B},) int32 (got "
                         f"{tuple(offsets.shape)} {offsets.dtype})")
    _check_heads(what, H, KV, hd)
    _check_chunk_length(what, B, S, H // KV)
    if Sc < 1:
        raise ValueError(f"{what}: the cache needs at least one slot")
    if window is not None and window < 1:
        raise ValueError(f"{what}: window must be >= 1 (got {window})")


def chunk_verify_attention(q, ck, cv, k, v, offsets, *, ring, window=None):
    """q: (B, S, H, hd); ck, cv: (B, Sc, KV, hd) read-only cache, full
    (``ring`` False) or ring-buffer layout; k, v: (B, S, KV, hd) the chunk's
    own K/V; offsets: (B,) int32 committed lengths -> (B, S, H, hd).
    Offsets < 0 give exact zeros; the cache is never written.  Planned as
    the paged verify is (``_verify_plan``): the cache is B pages of Sc
    rows."""
    _check_chunk(q, ck, cv, k, v, offsets, window)
    B, S, H, hd = q.shape
    Sc, KV = ck.shape[1], ck.shape[2]
    rows, _, chunk, nsplit = _verify_plan(q, KV, Sc, window,
                                          "chunk_verify_attention", ring)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = _chunk_entry()(
            q.data_ptr(), ck.data_ptr(), cv.data_ptr(), k.data_ptr(),
            v.data_ptr(), offsets.data_ptr(), out.data_ptr(),
            DTYPES[q.dtype], B, S, Sc, KV, H, hd, int(ring), window or 0,
            rows, chunk, nsplit, hd ** -0.5,
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"chunk_verify_attention kernel launch failed: "
                           f"CUDA error {rc}")
    chunk_verify_attention.launches += 1
    return out


chunk_verify_attention.launches = 0


def _check_heads(what, H, KV, hd):
    if KV < 1 or H % KV or H // KV not in GROUPS:
        raise ValueError(f"{what}: H/KV = {H}/{KV} must be one of {GROUPS}")
    if not 1 <= hd <= HEAD_DIM_MAX:
        raise ValueError(f"{what}: head_dim {hd} not in 1..{HEAD_DIM_MAX}")


def _check_arena(what, arenas, bt, B, KV, hd):
    """Page arenas (n_pages, page, KV, hd) and a (B, nblk) int32 table."""
    n_pages, page = arenas[0][1].shape[:2]
    for name, a in arenas:
        if a.dim() != 4 or a.shape != (n_pages, page, KV, hd):
            raise ValueError(f"{what}: {name} must be an arena (n_pages, "
                             f"page, KV, hd) = ({n_pages}, {page}, {KV}, "
                             f"{hd}); got {tuple(a.shape)}")
    if n_pages < 1 or page < 1:
        raise ValueError(f"{what}: the arena needs at least one page")
    if bt.dtype != torch.int32 or bt.dim() != 2 or bt.shape[0] != B:
        raise ValueError(f"{what}: bt must be ({B}, nblk) int32 (got "
                         f"{tuple(bt.shape)} {bt.dtype})")
    if not 1 <= bt.shape[1] <= NBLK_MAX:
        raise ValueError(f"{what}: nblk = {bt.shape[1]} must be in "
                         f"1..{NBLK_MAX}")


PAGED_TILE = 32  # positions a tile of the paged body (TR in the .cuh)
PAGED_CLUSTER_MAX = 16  # pieces of one band: a thread-block cluster
PAGED_ROWS_MAX = 16  # query rows a block of the body (ROWS_MAX in the .cuh)
GRID_Z_MAX = 65535  # CUDA's limit on grid z, where a verify's tiles lie
# blocks an SM at most: past about 4.5 the clusters' launch and merge cost
# more than the split gains (gpt-base's 96 bands on an H100)
PAGED_LOAD = 4.5


def paged_decode_splits(B, KV, span, n_sm, per_sm):
    """(chunk, nsplit): each (row, kv head) band of up to ``span``
    positions cut into ``nsplit`` pieces of ``chunk`` positions (a
    multiple of PAGED_TILE), one thread-block cluster a band.  The B * KV
    bands take as many blocks as the card holds at once (``per_sm`` an SM
    of its ``n_sm``), at most PAGED_LOAD an SM and PAGED_CLUSTER_MAX a
    band.  The kernels of ``csrc/paged_decode.cuh`` take it (a verify's
    bands are its B * tiles rows' (row, kv head) pairs); their pieces
    merge in the launch."""
    blocks = int(min(per_sm, PAGED_LOAD) * n_sm)
    want = min(PAGED_CLUSTER_MAX, max(1, blocks // max(1, B * KV)))
    chunk = -(-max(1, span) // want)
    chunk = -(-chunk // PAGED_TILE) * PAGED_TILE
    return chunk, -(-max(1, span) // chunk)


def verify_tiles(S, G):
    """(rows, tiles): a verify's S * G query rows (i, g) of one (row, kv
    head) cut into ``tiles`` blocks of at most ``rows`` (PAGED_ROWS_MAX),
    as even as they come; the kernel runs ``rows`` in its next
    compile-time row count (1, 2, 4, 8, 10, 16)."""
    tiles = -(-S * G // PAGED_ROWS_MAX)
    return -(-S * G // tiles), tiles


def _check_chunk_length(what, B, S, G):
    """A verify takes any chunk length S >= 1: its chunk keys stage through
    the body's tile ring after the cache.  Only CUDA's grid bounds it: the
    B * tiles blocks of query-row tiles (``verify_tiles``) lie on grid z."""
    if S < 1:
        raise ValueError(f"{what}: chunk length S = {S} must be >= 1")
    tiles = verify_tiles(S, G)[1]
    if B * tiles > GRID_Z_MAX:
        raise ValueError(f"{what}: B * query tiles = {B} * {tiles} exceeds "
                         f"CUDA's grid z limit of {GRID_Z_MAX}")


def verify_span(S, cap, window, ring=False):
    """The longest band of a verify over a cache of ``cap`` positions: the
    attended cache (at most ``window - 1`` positions below the chunk) and
    the chunk's own S keys; in the ring layout up to PAGED_TILE - 1 more,
    the positions below the band's first that its first tile (aligned to
    PAGED_TILE) also stages."""
    return (min(cap, window - 1 if window else cap) + S
            + (PAGED_TILE - 1 if ring else 0))


def ring_verify_box(page, hd, itemsize):
    """Whether the ring layout's verify stages each whole cache tile of
    PAGED_TILE positions (aligned to PAGED_TILE) by one TMA box for K and
    one for V, as ``csrc/ring_verify.cuh`` decides for 16-byte aligned
    bases: rows that fill their head-dim bucket (hd 64 or 128) in
    16-byte multiples, and pages of whole tiles.  Then cap = nblk * page is
    a multiple of PAGED_TILE too, so position p and its slot p % cap agree
    mod PAGED_TILE and an aligned tile is PAGED_TILE consecutive slots of
    one page.  Otherwise (cap % 32 != 0 among them) every tile takes one
    copy a band row."""
    return (page % PAGED_TILE == 0 and hd in (64, 128)
            and hd * itemsize % 16 == 0)


@functools.lru_cache(maxsize=None)
def _paged_per_sm(name, device, dtype, hd, rows, ring=False):
    """Blocks an SM holds at once (CUDA's occupancy for its threads and
    shared memory) of library ``name``'s instance for ``rows`` query rows
    a block (the group's G outside a verify); ``ring``: a verify's
    ring-layout instance (``csrc/ring_verify.cuh``)."""
    fn = getattr(build.load(name),
                 f"{name}_{'ring_' if ring else ''}blocks_per_sm")
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    n = ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = fn(DTYPES[dtype], hd, rows, ctypes.addressof(n))
    if rc != 0 or n.value < 1:
        raise RuntimeError(f"{name}: occupancy query failed (CUDA error "
                           f"{rc}, {n.value} blocks an SM)")
    return n.value


def _paged_splits(name, q, KV, span, rows=None, tiles=1):
    """(chunk, nsplit) of library ``name``'s call on ``q`` (B, [S,] H, hd):
    B * tiles * KV bands of up to ``span`` positions, ``rows`` query rows
    a block (default: the group's H / KV)."""
    H, hd = q.shape[-2:]
    return paged_decode_splits(
        q.shape[0] * tiles, KV, span, _sm_count(q.device),
        _paged_per_sm(name, q.device, q.dtype, hd, rows or H // KV))


@functools.lru_cache(maxsize=None)
def _ring_clusters(name, device, dtype, hd, nsplit):
    """Thread-block clusters of ``nsplit`` blocks of library ``name``'s
    ring-layout verify instance that the card holds at once."""
    fn = getattr(build.load(name), f"{name}_ring_clusters")
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    n = ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = fn(DTYPES[dtype], hd, nsplit, ctypes.addressof(n))
    if rc != 0 or n.value < 1:
        raise RuntimeError(f"{name}: cluster occupancy query failed (CUDA "
                           f"error {rc}, {n.value} clusters)")
    return n.value


def ring_verify_splits(bands, span, n_sm, per_sm, clusters):
    """(chunk, nsplit) of the ring layout's verify: ``bands`` bands of up
    to ``span`` positions cut as ``paged_decode_splits`` cuts them, then
    into fewer pieces while ``clusters(nsplit)`` -- the clusters of nsplit
    blocks the card holds at once -- is fewer than the bands, so that no
    band's cluster waits for a second wave behind the others."""
    chunk, nsplit = paged_decode_splits(bands, 1, span, n_sm, per_sm)
    while nsplit > 1 and clusters(nsplit) < bands:
        chunk = -(-max(1, span) // (nsplit - 1))
        chunk = -(-chunk // PAGED_TILE) * PAGED_TILE
        nsplit = -(-max(1, span) // chunk)
    return chunk, nsplit


def _verify_plan(q, KV, cap, window, name="paged_chunk_verify_attention",
                 ring=False):
    """(rows, tiles, chunk, nsplit) of library ``name``'s verify on q
    (B, S, H, hd) over a cache of ``cap`` positions a row, in the ring
    layout with ``ring``."""
    S, H, hd = q.shape[1:]
    rows, tiles = verify_tiles(S, H // KV)
    span = verify_span(S, cap, window, ring)
    if not ring:
        return rows, tiles, *_paged_splits(name, q, KV, span, rows, tiles)
    return rows, tiles, *ring_verify_splits(
        q.shape[0] * tiles * KV, span, _sm_count(q.device),
        _paged_per_sm(name, q.device, q.dtype, hd, rows, ring=True),
        lambda n: _ring_clusters(name, q.device, q.dtype, hd, n))


def _paged_slot_entry():
    fn = build.load("paged_slot_decode_attention"
                    ).paged_slot_decode_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 10
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def paged_slot_decode_attention(q, k, v, bt, kv_len):
    """q: (B, H, hd); k, v: (n_pages, page, KV, hd) page arenas; bt:
    (B, nblk) int32 block tables; kv_len: (B,) int32 -> (B, H, hd).
    Position p of row b is ``arena[bt[b, p // page], p % page]``; table
    entries outside the arena clamp to its last page.  kv_len 0 gives
    exact zeros; kv_len > nblk * page reads nblk * page."""
    what = "paged_slot_decode_attention"
    _check_tensors(what, (("q", q), ("k", k), ("v", v)), ("bt", bt),
                   ("kv_len", kv_len))
    if q.dim() != 3:
        raise ValueError(f"{what}: q must be (B, H, hd)")
    B, H, hd = q.shape
    KV = k.shape[2] if k.dim() == 4 else -1
    _check_arena(what, (("k", k), ("v", v)), bt, B, KV, hd)
    if kv_len.dtype != torch.int32 or kv_len.shape != (B,):
        raise ValueError(f"{what}: kv_len must be ({B},) int32 (got "
                         f"{tuple(kv_len.shape)} {kv_len.dtype})")
    _check_heads(what, H, KV, hd)
    n_pages, page = k.shape[:2]
    nblk = bt.shape[1]
    chunk, nsplit = _paged_splits(what, q, KV, nblk * page)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = _paged_slot_entry()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bt.data_ptr(),
            kv_len.data_ptr(), out.data_ptr(), DTYPES[q.dtype], B, n_pages,
            page, nblk, KV, H, hd, chunk, nsplit, hd ** -0.5,
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")
    paged_slot_decode_attention.launches += 1
    return out


paged_slot_decode_attention.launches = 0


def _paged_chunk_entry():
    fn = build.load("paged_chunk_verify_attention"
                    ).paged_chunk_verify_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 14
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def paged_chunk_verify_attention(q, ck, cv, bt, k, v, offsets, *, ring,
                                 window=None):
    """q: (B, S, H, hd); ck, cv: (n_pages, page, KV, hd) read-only cache
    arenas; bt: (B, nblk) int32 block tables (logical cache length
    ``cap = nblk * page``: slot s of row b is ``arena[bt[b, s // page],
    s % page]``), full (``ring`` False: slot p holds position p) or
    ring-buffer layout (slot s holds the largest position p < offset with
    ``p % cap == s``); k, v: (B, S, KV, hd) the chunk's own K/V; offsets:
    (B,) int32 committed lengths -> (B, S, H, hd).  Offsets < 0 give
    exact zeros; the arenas are never written."""
    what = "paged_chunk_verify_attention"
    _check_tensors(what, (("q", q), ("ck", ck), ("cv", cv), ("k", k),
                          ("v", v)), ("bt", bt), ("offsets", offsets))
    if q.dim() != 4:
        raise ValueError(f"{what}: q must be (B, S, H, hd)")
    B, S, H, hd = q.shape
    KV = ck.shape[2] if ck.dim() == 4 else -1
    _check_arena(what, (("ck", ck), ("cv", cv)), bt, B, KV, hd)
    if k.shape != (B, S, KV, hd) or v.shape != k.shape:
        raise ValueError(f"{what}: q {tuple(q.shape)} needs the chunk's k, v "
                         f"of shape (B, S, KV, hd); got {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if offsets.dtype != torch.int32 or offsets.shape != (B,):
        raise ValueError(f"{what}: offsets must be ({B},) int32 (got "
                         f"{tuple(offsets.shape)} {offsets.dtype})")
    _check_heads(what, H, KV, hd)
    _check_chunk_length(what, B, S, H // KV)
    if window is not None and window < 1:
        raise ValueError(f"{what}: window must be >= 1 (got {window})")
    n_pages, page = ck.shape[:2]
    nblk = bt.shape[1]
    rows, _, chunk, nsplit = _verify_plan(q, KV, nblk * page, window,
                                          ring=ring)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = _paged_chunk_entry()(
            q.data_ptr(), ck.data_ptr(), cv.data_ptr(), bt.data_ptr(),
            k.data_ptr(), v.data_ptr(), offsets.data_ptr(), out.data_ptr(),
            DTYPES[q.dtype], B, S, n_pages, page, nblk, KV, H, hd,
            int(ring), window or 0, rows, chunk, nsplit, hd ** -0.5,
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")
    paged_chunk_verify_attention.launches += 1
    return out


paged_chunk_verify_attention.launches = 0


# ------------------------------------------------- ring-buffer window decode
RING_HEAD_DIM_MAX = 256
RING_GROUP_MAX = 16  # query heads per kv head the ring kernels take


def _check_ring(what, q, KV, slot_positions, window, ring):
    """The ring kernels' own head, band and position rules (G 1..16, hd
    up to 256: recurrentgemma-2b has G = 10 and hd = 256).  Returns the
    longest band, min(window, ring), which the kernel cuts into pieces."""
    B, H, hd = q.shape
    if KV < 1 or H % KV or not 1 <= H // KV <= RING_GROUP_MAX:
        raise ValueError(f"{what}: H/KV = {H}/{KV} must be a whole number "
                         f"in 1..{RING_GROUP_MAX}")
    if not 1 <= hd <= RING_HEAD_DIM_MAX:
        raise ValueError(f"{what}: head_dim {hd} not in "
                         f"1..{RING_HEAD_DIM_MAX}")
    if (slot_positions.dtype != torch.int32
            or slot_positions.shape != (B,)):
        raise ValueError(f"{what}: slot_positions must be ({B},) int32 (got "
                         f"{tuple(slot_positions.shape)} "
                         f"{slot_positions.dtype})")
    if window is None or window < 1:
        raise ValueError(f"{what}: window must be >= 1 (got {window})")
    if ring < 1:
        raise ValueError(f"{what}: the ring needs at least one slot")
    return min(window, ring)


def _ring_entry():
    fn = build.load("ring_decode_attention").ring_decode_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def ring_decode_attention(q, k, v, slot_positions, *, window):
    """q: (B, H, hd); k, v: (B, ring, KV, hd) ring caches already holding
    this step's K/V at ``slot_positions[b] % ring``; slot_positions: (B,)
    int32 query positions -> (B, H, hd).  Attends positions in
    ``(pos - window, pos]`` that the ring still holds; a position < 0
    gives exact zeros."""
    what = "ring_decode_attention"
    _check_tensors(what, (("q", q), ("k", k), ("v", v)),
                   ("slot_positions", slot_positions))
    if q.dim() != 3 or k.dim() != 4:
        raise ValueError(f"{what}: q must be (B, H, hd) and k, v "
                         "(B, ring, KV, hd)")
    B, H, hd = q.shape
    ring, KV = k.shape[1], k.shape[2]
    if k.shape != (B, ring, KV, hd) or v.shape != k.shape:
        raise ValueError(f"{what}: q {tuple(q.shape)} needs k, v of shape "
                         f"(B, ring, KV, hd); got {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    span = _check_ring(what, q, KV, slot_positions, window, ring)
    chunk, nsplit = _paged_splits(what, q, KV, span)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = _ring_entry()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            slot_positions.data_ptr(), out.data_ptr(), DTYPES[q.dtype], B,
            ring, KV, H, hd, window, chunk, nsplit, hd ** -0.5,
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")
    ring_decode_attention.launches += 1
    return out


ring_decode_attention.launches = 0


def _paged_ring_entry():
    fn = build.load("paged_ring_decode_attention"
                    ).paged_ring_decode_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 11
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def paged_ring_decode_attention(q, k, v, bt, slot_positions, *, window):
    """q: (B, H, hd); k, v: (n_pages, page, KV, hd) page arenas; bt:
    (B, nblk) int32 block tables (ring modulus ``nblk * page``: ring slot
    s of row b is ``arena[bt[b, s // page], s % page]``); slot_positions:
    (B,) int32 -> (B, H, hd).  Table entries outside the arena clamp to
    its last page; a position < 0 gives exact zeros."""
    what = "paged_ring_decode_attention"
    _check_tensors(what, (("q", q), ("k", k), ("v", v)), ("bt", bt),
                   ("slot_positions", slot_positions))
    if q.dim() != 3:
        raise ValueError(f"{what}: q must be (B, H, hd)")
    B, H, hd = q.shape
    KV = k.shape[2] if k.dim() == 4 else -1
    _check_arena(what, (("k", k), ("v", v)), bt, B, KV, hd)
    n_pages, page = k.shape[:2]
    nblk = bt.shape[1]
    span = _check_ring(what, q, KV, slot_positions, window, nblk * page)
    chunk, nsplit = _paged_splits(what, q, KV, span)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = _paged_ring_entry()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bt.data_ptr(),
            slot_positions.data_ptr(), out.data_ptr(), DTYPES[q.dtype], B,
            n_pages, page, nblk, KV, H, hd, window, chunk, nsplit,
            hd ** -0.5, torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")
    paged_ring_decode_attention.launches += 1
    return out


paged_ring_decode_attention.launches = 0
