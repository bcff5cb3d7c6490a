"""Checkpointing in the reference package's on-disk format: one ``.npy``
file a leaf and a JSON manifest, so either package restores what the
other wrote.

    <dir>/step_<step:010d>/leaf_<i:05d>.npy
    <dir>/step_<step:010d>/manifest.json
        {"step", "leaves": {name: {file, shape, dtype, crc32}}, "extra"}

A leaf's name is its dotted path (``p.dense_blocks.attn.wq``), its CRC32
is ``zlib.crc32`` of its contiguous bytes.  bfloat16 and float8 leaves
have no numpy dtype here: they are written as raw void bytes (``|V2``,
``|V1``) with the manifest naming the logical dtype, which is exactly how
numpy saves the reference's ``ml_dtypes`` arrays, and they cross through
their bit patterns both ways.

Guarantees, as in the reference:
  * **atomicity**: a save writes ``tmp.<step>/`` and renames it to
    ``step_<step>/`` only after the manifest is fsynced, so a crash never
    leaves a half-written step that ``latest_step`` would pick;
  * **integrity**: every leaf's CRC32 is checked on load;
  * **keep-K GC**: old steps are pruned only after a newer one commits;
  * **async**: ``CheckpointManager(async_save=True)`` copies the tree to
    host memory on the caller's thread and writes it on a worker thread,
    which makes no CUDA call; a failed write re-raises on ``wait()`` and
    on the next ``maybe_save``.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
import zlib
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.utils.pytree import tree_flatten_with_paths

_MANIFEST = "manifest.json"

# dtypes numpy has no name for: saved as raw void bytes of their width
_EXOTIC = {"bfloat16": torch.bfloat16,
           "float8_e4m3fn": torch.float8_e4m3fn,
           "float8_e5m2": torch.float8_e5m2}
_BITS = {1: (np.int8, torch.int8), 2: (np.int16, torch.int16)}


class CheckpointShapeError(ValueError):
    """The restore template's geometry does not match the checkpoint on
    disk (a pre-growth snapshot loaded into a grown model, say).  Carries
    the offending leaf in ``.leaf`` and names it in the message."""

    def __init__(self, msg: str, leaf: Optional[str] = None):
        super().__init__(msg)
        self.leaf = leaf


def _flatten(tree):
    """[(name, leaf)] in the reference's flatten order; its names join the
    path with "." and replace any "/"."""
    return [(path.replace("/", "_"), leaf)
            for path, leaf in tree_flatten_with_paths(tree)]


def _snapshot(tree):
    """[(name, (host array, manifest dtype))] of every leaf of ``tree``."""
    return [(n, _to_host(t)) for n, t in _flatten(tree)]


def _to_host(t: torch.Tensor):
    """(numpy array as it is saved, manifest dtype): a copy, so a later
    in-place update of ``t`` cannot reach a pending write."""
    t = t.detach()
    name = next((n for n, dt in _EXOTIC.items() if t.dtype == dt), None)
    if name is not None:
        t = t.contiguous().view(_BITS[t.element_size()][1])
    a = t.cpu().numpy()
    if t.device.type == "cpu":  # ``.cpu()`` copied a device tensor already
        a = a.copy()
    if name is None:
        return a, str(a.dtype)
    return a.view(np.dtype(f"V{a.itemsize}")), name


def _from_disk(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name in _EXOTIC and arr.dtype.kind == "V":
        bits = arr.view(_BITS[arr.dtype.itemsize][0])
        return torch.from_numpy(bits).view(_EXOTIC[dtype_name])
    return torch.from_numpy(arr)


def _crc(arr: np.ndarray) -> int:
    """``zlib.crc32`` of the contiguous bytes, read in place (the
    reference's ``tobytes()`` copy first costs as much as the CRC)."""
    return zlib.crc32(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))


def _write(ckpt_dir: str, step: int, host_flat, extra) -> str:
    """Atomic write of [(name, (array, dtype name))]; -> the step's dir."""
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f"tmp.{step}")
    final = os.path.join(ckpt_dir, f"step_{step:010d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "leaves": {}, "extra": extra or {}}
    for i, (name, (arr, dtype_name)) in enumerate(host_flat):
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"][name] = {
            "file": fname, "shape": list(arr.shape), "dtype": dtype_name,
            "crc32": _crc(arr)}
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def save_checkpoint(ckpt_dir: str, step: int, tree: Any,
                    extra: Optional[dict] = None) -> str:
    """Atomic write of ``tree`` (nested dict of tensors) at ``step``;
    returns the step's directory."""
    return _write(ckpt_dir, step, _snapshot(tree), extra)


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The newest committed step: ``tmp.*`` directories and directories
    without a manifest are ignored."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(name.split("_")[1]) for name in os.listdir(ckpt_dir)
             if name.startswith("step_") and os.path.exists(
                 os.path.join(ckpt_dir, name, _MANIFEST))]
    return max(steps) if steps else None


def _rebuild(template, leaves, prefix=""):
    if isinstance(template, dict):
        return {k: _rebuild(v, leaves, f"{prefix}{k}.")
                for k, v in template.items()}
    return None if template is None else leaves[prefix[:-1]]


def load_checkpoint(ckpt_dir: str, template: Any,
                    step: Optional[int] = None):
    """Restore into the structure of ``template`` (a ``None`` there is an
    empty subtree: ``{"p": params, "o": None}`` reads only ``p.*``).  Each
    leaf is cast to its template leaf's dtype and placed on its device;
    leaves on disk that the template lacks are ignored.

    Returns (tree, step, extra).  A CRC mismatch raises ``IOError``; a
    leaf missing on disk or of another shape raises
    ``CheckpointShapeError`` naming it."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:010d}")
    with open(os.path.join(d, _MANIFEST)) as f:
        manifest = json.load(f)
    flat = _flatten(template)
    leaves = {}
    for name, tmpl in flat:
        meta = manifest["leaves"].get(name)
        if meta is None:
            raise CheckpointShapeError(
                f"checkpoint step {step} in {ckpt_dir} has no leaf "
                f"{name!r}: the restore template describes a different "
                f"geometry ({len(flat)} template leaves vs "
                f"{len(manifest['leaves'])} on disk)", leaf=name)
        arr = np.load(os.path.join(d, meta["file"]))
        if _crc(arr) != meta["crc32"]:
            raise IOError(f"checksum mismatch for {name} in step {step}")
        if list(arr.shape) != list(tmpl.shape):
            raise CheckpointShapeError(
                f"leaf {name!r} in checkpoint step {step} has shape "
                f"{tuple(arr.shape)} but the restore template expects "
                f"{tuple(tmpl.shape)}", leaf=name)
        leaves[name] = _from_disk(arr, meta["dtype"]).to(
            device=tmpl.device, dtype=tmpl.dtype)
    return (_rebuild(template, leaves), step, manifest.get("extra", {}))


class CheckpointManager:
    """Keep-K, optionally async checkpoint driver for the train loop.

    ``saves`` records each committed save: its step, the seconds the
    write took (on the worker thread when async) and the bytes written."""

    def __init__(self, ckpt_dir: str, *, keep: int = 3, every: int = 100,
                 async_save: bool = False):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self.every = every
        self.async_save = async_save
        self.saves: list = []
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def maybe_save(self, step: int, tree: Any, extra=None, force=False):
        if not force and (self.every <= 0 or step % self.every != 0):
            return False
        if not self.async_save:
            self._save_and_gc(step, _snapshot(tree), extra)
            return True
        self.wait()  # one in flight at a time; surfaces a prior failure
        self._thread = threading.Thread(
            target=self._save_bg, args=(step, _snapshot(tree), extra),
            daemon=True)
        self._thread.start()
        return True

    def _save_and_gc(self, step, host_flat, extra):
        t0 = time.perf_counter()
        _write(self.ckpt_dir, step, host_flat, extra)
        self.saves.append(dict(
            step=step, seconds=time.perf_counter() - t0,
            bytes=sum(a.nbytes for _, (a, _) in host_flat)))
        self._gc()

    def _save_bg(self, step, host_flat, extra):
        # a daemon thread's traceback otherwise evaporates, and with it the
        # fact that the checkpoint was never written
        try:
            self._save_and_gc(step, host_flat, extra)
        except BaseException as e:  # noqa: BLE001 (re-raised on wait())
            self._error = e

    def wait(self):
        """Join the in-flight async save; if it failed, re-raise its
        exception here (and on the next ``maybe_save``)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        if not os.path.isdir(self.ckpt_dir):
            return
        steps = sorted(int(n.split("_")[1]) for n in os.listdir(self.ckpt_dir)
                       if n.startswith("step_"))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"step_{s:010d}"),
                          ignore_errors=True)

    def restore_latest(self, template):
        step = latest_step(self.ckpt_dir)
        if step is None:
            return None
        return load_checkpoint(self.ckpt_dir, template, step)
