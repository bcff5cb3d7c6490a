"""Build the hand-written CUDA kernels and load them with ctypes.

Each ``csrc/*.cu`` file has a plain C interface and compiles on its own
(with the shared ``csrc/*.cuh`` headers it includes) with ``nvcc`` into
``<checkout>/build/kernels/`` (``build/`` is git-ignored) at first use.
Every source starts its own ``nvcc`` at the same time, so building all
kernels takes as long as the slowest one.  Each nvcc writes its report
to a file of its own, never to a pipe: a pipe's 64 KiB buffer would
stop a compile whose report outgrows it until the reader got to it, one
source after another.  A library's file name carries a hash of its
source, the headers and the flags, so an edited kernel never loads a
stale build.  Nothing here runs at import time.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import resource
import subprocess
import sys
import tempfile
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
cpu_seconds: dict = {}  # source name -> CPU seconds of its nvcc (all of
# nvcc's processes, user and system)


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
    until its nvcc had finished (0.0 when the library was already
    built)}."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        log = tempfile.TemporaryFile(mode="w+")
        procs[name] = (subprocess.Popen(cmd, stdout=log,
                                        stderr=subprocess.STDOUT, text=True),
                       log, tmp, out)
    secs = {name: 0.0 for name in names}
    failed = []
    cpu0 = _children_cpu()
    while procs:
        for name in list(procs):
            if procs[name][0].poll() is None:
                continue
            # poll reaped this nvcc alone: the children's usage grew by
            # its own and by that of the processes it reaped
            cpu1 = _children_cpu()
            proc, log, tmp, out = procs.pop(name)
            secs[name] = time.perf_counter() - t0
            cpu_seconds[name], cpu0 = cpu1 - cpu0, cpu1
            log.seek(0)
            ptxas_log[name] = log.read()
            log.close()
            if proc.returncode != 0:
                failed.append(f"--- nvcc {name}.cu (rc {proc.returncode}) "
                              f"---\n{ptxas_log[name]}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, out)  # atomic: readers never see half a file
        time.sleep(0.05)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return secs


def _children_cpu() -> float:
    ru = resource.getrusage(resource.RUSAGE_CHILDREN)
    return ru.ru_utime + ru.ru_stime


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    lib = _libs.get(name)
    if lib is None:
        build_all((name,))
        lib = ctypes.CDLL(str(_target(name)))
        _libs[name] = lib
    return lib


def main(argv=None):
    """Build the libraries into an empty directory, every nvcc started at
    once, and print as JSON each one's wall and CPU seconds and the bytes
    of its report: ``python -m repro_torch.kernels.build --out
    build/timing [--csrc DIR] [--only NAME ...]``.  ``--csrc`` takes
    another checkout's sources, compiled with this module's flags."""
    global CSRC, BUILD_DIR
    ap = argparse.ArgumentParser(description=main.__doc__.split("\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--csrc", default=str(CSRC))
    ap.add_argument("--only", nargs="*", default=list(SOURCES))
    args = ap.parse_args(argv)
    CSRC, BUILD_DIR = Path(args.csrc), Path(args.out)
    if BUILD_DIR.exists() and any(BUILD_DIR.iterdir()):
        sys.exit(f"{BUILD_DIR} is not empty")
    t0 = time.perf_counter()
    wall = build_all(args.only)
    print(json.dumps({"csrc": str(CSRC),
                      "cores": len(os.sched_getaffinity(0)),
                      "seconds": time.perf_counter() - t0, "wall": wall,
                      "cpu_seconds": {k: cpu_seconds[k] for k in args.only},
                      "report_bytes": {k: len(ptxas_log[k])
                                       for k in args.only}}))


if __name__ == "__main__":
    main()
