"""Build the hand-written CUDA kernels and load them with ctypes.

Each ``csrc/*.cu`` file has a plain C interface and compiles on its own
(with the shared ``csrc/*.cuh`` headers it includes) with ``nvcc`` into
``<checkout>/build/kernels/`` (``build/`` is git-ignored) at first use.
Every source starts its own ``nvcc`` at the same time, so building all
kernels takes as long as the slowest one.  A library's file name carries
a hash of its source, the headers and the flags, so an edited kernel
never loads a stale build.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = ("flash_attention", "decode_attention", "slot_decode_attention",
           "tr_sandwich",
           "chunk_verify_attention", "paged_slot_decode_attention",
           "paged_chunk_verify_attention", "ring_decode_attention",
           "paged_ring_decode_attention", "rglru_scan")

_libs: dict = {}  # source name -> loaded ctypes.CDLL
ptxas_log: dict = {}  # source name -> nvcc's register/shared-memory report


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on "
                           "PATH to build the CUDA kernels")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def _target(name: str) -> Path:
    # the shared headers count too: a source may include any of them
    src = b"".join(p.read_bytes() for p in [CSRC / f"{name}.cu",
                                            *sorted(CSRC.glob("*.cuh"))])
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{tag[:12]}.so"


def build_all(names=SOURCES) -> dict:
    """Compile every missing library in parallel; return {name: seconds
    nvcc ran (0.0 when the library was already built)}."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    secs = {name: 0.0 for name in names}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        secs[name] = time.perf_counter() - t0
        ptxas_log[name] = log
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name}.cu (rc {proc.returncode}) ---\n"
                          f"{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)  # atomic: a reader never sees half a file
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return secs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    lib = _libs.get(name)
    if lib is None:
        build_all((name,))
        lib = ctypes.CDLL(str(_target(name)))
        _libs[name] = lib
    return lib
