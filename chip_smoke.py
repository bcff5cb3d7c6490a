#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port's serving path (``repro_torch``).

    python3 chip_smoke.py [--out report.json]

Needs one CUDA card and runs from the root of a checkout.  Phases, each
printed as it goes; a failed phase raises, so the exit code is not 0:

  1. device  -- CUDA present; name, count, and ``nvidia-smi`` name and
                power limit;
  2. build   -- compile every CUDA kernel of the path from ``src/`` (one
                nvcc per source, all started together);
  3. kernels -- each kernel against its plain PyTorch version on the card
                at gpt-base's serving shapes plus GQA and bfloat16 cases,
                then CUDA-event times of kernel, plain version and one
                PyTorch library call beside the kernel's bound;
  4. serve   -- full-width gpt-base (12 x 768, vocab 50257, random weights
                from a seeded generator) through the continuous-batching
                engine: capacity 8, max_len 1024, K 8, 16 requests of
                64..512 prompt tokens and 64 new tokens each.  Both kernels'
                launch counters must move, and every request's tokens,
                from the engine and from ``generate``, must equal the plain
                route's (a full forward per step, which runs no kernel of
                the port) except where its top-2 logit gap is below 1e-4
                (an f32 near tie, reported).

The line before the last is the kernels JSON; the last line is
``{"ok": true, "device": {...}}``.  Without CUDA, or without the package
beside this file, it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): memory rate, and the
# operation rate for each input type (float32 outside the tensor cores)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
TOL = {  # (atol, rtol): float32 differs only by summation order; bfloat16
    # rounds its output to 8 mantissa bits (~4e-3 at |out| near 1)
    "float32": (2e-5, 1e-4),
    # measured on an H100 at gpt-base's shapes: 2.0e-3 (flash), 4.9e-4 (slot)
    "bfloat16": (5e-3, 1e-2),
}
NEAR_TIE = 1e-4  # top-2 logit gap below which f32 routes may disagree


def phase(name):
    print(f"== {name}", flush=True)


def time_ms(fn, iters, warmup=3):
    """Mean device time of ``fn`` over ``iters`` back-to-back calls.

    A call that takes less device time than its Python wrapper takes to
    launch would otherwise be timed at the host's launch rate.  So the
    stream is first held by a device-side sleep long enough for the host
    to enqueue every call; the CUDA events then bracket only device work
    (the sleep doubles until the enqueue fits inside it)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    hold_s = 0.05
    while True:
        torch.cuda._sleep(int(hold_s * 2e9))  # cycles; >= hold_s at <= 2 GHz
        start.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        end.record()
        enqueue_s = time.perf_counter() - t0
        end.synchronize()
        if enqueue_s < hold_s:
            return start.elapsed_time(end) / iters
        hold_s *= 2


def check_close(name, out, want, dtype_name):
    import torch

    atol, rtol = TOL[dtype_name]
    err = (out.float() - want.float()).abs().max().item()
    if not torch.allclose(out.float(), want.float(), atol=atol, rtol=rtol):
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version (max abs err {err:.3g}, atol {atol}, "
                             f"rtol {rtol})")
    return err


def bound_ms(nbytes, flops, dtype_name):
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def flash_cases(gen):
    """(label, q, k, v) at gpt-base's admission-prefill shape first."""
    import torch

    out = []
    for label, B, H, KV, S, hd, dt in (
            ("gpt-base prefill f32", 8, 12, 12, 512, 64, torch.float32),
            ("GQA f32", 4, 16, 4, 512, 128, torch.float32),
            ("gpt-base prefill bf16", 8, 12, 12, 512, 64, torch.bfloat16),
            ("GQA bf16 ragged", 2, 16, 4, 300, 128, torch.bfloat16)):
        def rnd(*s):
            return torch.randn(*s, generator=gen, device="cuda").to(dt)
        # head-major views of (B, S, heads, hd) activations, as the
        # transformer passes them
        out.append((label, rnd(B, S, H, hd).transpose(1, 2),
                    rnd(B, S, KV, hd).transpose(1, 2),
                    rnd(B, S, KV, hd).transpose(1, 2)))
    return out


def slot_cases(gen):
    """(label, q, k, v, kv_len) at gpt-base's slot pool first; k/v are
    (L, B, S, KV, hd) pools whose layers the timing cycles through."""
    import torch

    out = []
    for label, L, B, S, H, KV, hd, dt, kvl in (
            ("gpt-base pool f32", 12, 8, 1024, 12, 12, 64, torch.float32,
             [0, 97, 200, 333, 451, 576, 800, 1024]),
            ("GQA f32", 2, 4, 512, 16, 4, 128, torch.float32,
             [0, 1, 255, 512]),
            ("gpt-base pool bf16", 2, 8, 1024, 12, 12, 64, torch.bfloat16,
             [0, 97, 200, 333, 451, 576, 800, 1024]),
            ("GQA bf16", 2, 4, 512, 16, 4, 128, torch.bfloat16,
             [3, 0, 511, 64])):
        def rnd(*s):
            return torch.randn(*s, generator=gen, device="cuda").to(dt)
        out.append((label, rnd(B, H, hd), rnd(L, B, S, KV, hd),
                    rnd(L, B, S, KV, hd),
                    torch.tensor(kvl, dtype=torch.int32, device="cuda")))
    return out


def run_kernels():
    """Phase 3: every kernel against its plain version, then timings at
    the main-path shape (the first case of each kernel)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention, flash_attention, ref

    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = {}
    fa = flash_attention.flash_attention
    for i, (label, q, k, v) in enumerate(flash_cases(gen)):
        dname = str(q.dtype).split(".")[1]
        got = fa(q, k, v, causal=True)
        torch.cuda.synchronize()
        err = check_close(f"flash_attention [{label}]", got,
                          ref.flash_attention_ref(q, k, v, causal=True),
                          dname)
        print(f"flash_attention [{label}] q{tuple(q.shape)} "
              f"kv{tuple(k.shape)}: max abs err {err:.3g}", flush=True)
        if i:
            continue
        B, H, S, hd = q.shape
        KV = k.shape[1]
        item = q.element_size()
        b_ms, b_by = bound_ms((2 * B * H + 2 * B * KV) * S * hd * item,
                              2 * B * H * S * S * hd, dname)
        rows["flash_attention"] = dict(
            name="flash_attention", route="cuda",
            source="src/repro_torch/kernels/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention.py:68",
            max_abs_err=err,
            ms=time_ms(lambda: fa(q, k, v, causal=True), 20),
            plain_ms=time_ms(
                lambda: ref.flash_attention_ref(q, k, v, causal=True), 5),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=H != KV), 20),
            shape=f"q{tuple(q.shape)} k/v{tuple(k.shape)} {dname} causal")

    sd = decode_attention.slot_decode_attention
    for i, (label, q, kp, vp, kvl) in enumerate(slot_cases(gen)):
        dname = str(q.dtype).split(".")[1]
        got = sd(q, kp[0], vp[0], kvl)
        torch.cuda.synchronize()
        want = ref.slot_decode_attention_ref(q, kp[0], vp[0], kvl)
        err = check_close(f"slot_decode_attention [{label}]", got, want,
                          dname)
        if not bool((got[kvl == 0] == 0).all()):
            raise AssertionError(f"slot_decode_attention [{label}]: rows "
                                 "with kv_len 0 are not exact zeros")
        print(f"slot_decode_attention [{label}] q{tuple(q.shape)} "
              f"pool{tuple(kp.shape[1:])} kv_len {kvl.tolist()}: max abs "
              f"err {err:.3g}, kv_len-0 rows exact zeros", flush=True)
        if i:
            continue
        L = kp.shape[0]
        B, H, hd = q.shape
        S, KV = kp.shape[2], kp.shape[3]
        item = q.element_size()
        n_kv = int(kvl.clamp(0, S).sum())
        b_ms, b_by = bound_ms(
            n_kv * KV * hd * 2 * item + 2 * B * H * hd * item + 4 * B,
            4 * n_kv * H * hd, dname)
        # cycle the layers of the pool, as one decode step does, so a call
        # finds its layer cold in L2 (the gpt-base pool is ~600 MB)
        layers = iter(range(10 ** 9))
        mask = torch.arange(S, device="cuda")[None] < kvl[:, None]

        def cycled(fn):
            def call():
                j = next(layers) % L
                return fn(kp[j], vp[j])
            return call

        def lib(k, v):
            return F.scaled_dot_product_attention(
                q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
                attn_mask=mask[:, None, None], enable_gqa=H != KV)

        rows["slot_decode_attention"] = dict(
            name="slot_decode_attention", route="cuda",
            source="src/repro_torch/kernels/csrc/slot_decode_attention.cu",
            replaces="src/repro/kernels/decode_attention.py:502",
            max_abs_err=err,
            ms=time_ms(cycled(lambda k, v: sd(q, k, v, kvl)), 10 * L),
            plain_ms=time_ms(cycled(
                lambda k, v: ref.slot_decode_attention_ref(q, k, v, kvl)),
                2 * L),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=time_ms(cycled(lib), 10 * L),
            shape=(f"q{tuple(q.shape)} pool{tuple(kp.shape[1:])} {dname} "
                   f"kv_len {kvl.tolist()}"))
    for r in rows.values():
        print(f"time {r['name']} [{r['shape']}]: kernel {r['ms']:.4f} ms, "
              f"plain {r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} "
              f"ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})",
              flush=True)
    return rows


def plain_greedy(cfg, params, prompt, n):
    """Greedy tokens of the plain route: a full forward (plain attention,
    no cache, no CUDA kernel of the port) over prompt + tokens so far at
    every step.  Returns the tokens and each step's top-2 logit gap."""
    import numpy as np
    import torch

    from repro_torch.models import transformer

    seq = torch.tensor(prompt, dtype=torch.int32, device="cuda")[None]
    toks, gaps = [], []
    for _ in range(n):
        logits, _ = transformer.forward(params, {"tokens": seq}, cfg)
        last = logits[0, -1].float()
        top = last.topk(2).values
        nxt = last.argmax()
        seq = torch.cat([seq, nxt.to(seq.dtype).view(1, 1)], dim=1)
        toks.append(nxt)
        gaps.append(top[0] - top[1])
    return (torch.stack(toks).cpu().numpy().astype(np.int32),
            torch.stack(gaps).cpu().numpy())


def check_against_plain(what, uid, got, want, gaps):
    """Tokens must equal the plain route's, except that they may diverge at
    a step where the plain top-2 gap is below NEAR_TIE.  Returns the
    near tie (uid, step, gap) or None."""
    import numpy as np

    diff = np.nonzero(got != want)[0]
    if diff.size == 0:
        return None
    t = int(diff[0])
    gap = float(gaps[t])
    if gap >= NEAR_TIE:
        raise AssertionError(
            f"uid {uid}: {what} and the plain route diverge at step {t} "
            f"where the plain top-2 gap is {gap:.3g} >= {NEAR_TIE}")
    print(f"near tie: uid {uid} {what} diverges at step {t}, plain top-2 "
          f"gap {gap:.3g}", flush=True)
    return (uid, t, gap)


def run_serve(kernel_rows):
    """Phase 4: gpt-base through the continuous-batching engine, then the
    same requests again under the profiler."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import lm_batch
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import build_params, generate
    from repro_torch.serve import ContinuousBatchingEngine, Request

    cfg = get_config("gpt-base")
    params = build_params(cfg, seed=0, device="cuda")
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"gpt-base: {cfg.n_layers} layers x d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads, vocab {cfg.vocab_size}: {n_params} "
          "params (f32, seeded torch.Generator)", flush=True)
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i, prompt=lm_batch(cfg.vocab_size, 1,
                                           int(rng.integers(64, 513)),
                                           seed=100 + i)[0],
                    max_new_tokens=64) for i in range(16)]

    def engine():
        return ContinuousBatchingEngine(cfg, params, capacity=8,
                                        max_len=1024, k=8)

    # warm-up: first-use costs (cuBLAS handles, allocator growth) stay out
    # of the measured run
    engine().run([Request(uid=0, prompt=reqs[0].prompt, max_new_tokens=9)])
    kern = ops.kernels()
    eng = engine()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in kern.values():
        fn.launches = 0
    t0 = time.perf_counter()
    out = eng.run(reqs)
    dt = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in kern.items()}
    peak = torch.cuda.max_memory_allocated()
    n_tok = sum(len(v) for v in out.values())
    print(f"served {len(out)} requests / {n_tok} tokens in {dt:.3f} s: "
          f"{n_tok / dt:.1f} tok/s, {eng.n_host_syncs / n_tok:.4f} host "
          f"syncs/token ({eng.n_host_syncs} syncs, "
          f"{eng.n_decode_dispatches} macro-steps, {eng.n_prefills} "
          f"prefill batches), peak memory {peak / 2**20:.1f} MiB; "
          f"kernel launches {launches}", flush=True)
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"{name} was never launched on the main "
                                 "path")
        kernel_rows[name]["launches"] = n
    if set(out) != {r.uid for r in reqs} or eng.rejected:
        raise AssertionError(f"requests missing or rejected: {eng.rejected}")
    # the reference is the plain route alone: no kernel of the port runs
    # in it (asserted through the launch counters)
    before = {name: fn.launches for name, fn in kern.items()}
    t0 = time.perf_counter()
    plain = {r.uid: plain_greedy(cfg, params, r.prompt, 64) for r in reqs}
    plain_s = time.perf_counter() - t0
    if {name: fn.launches for name, fn in kern.items()} != before:
        raise AssertionError("the plain reference launched a CUDA kernel")
    near_ties = {"engine": [], "generate": []}
    for r in reqs:
        got = out[r.uid]
        if got.shape != (64,) or got.min() < 0 or got.max() >= cfg.vocab_size:
            raise AssertionError(f"uid {r.uid}: bad output {got}")
        gen = generate(cfg, params, torch.from_numpy(r.prompt)[None].cuda(),
                       max_new_tokens=64, max_len=1024)[0].cpu().numpy()
        for what, toks in (("engine", got), ("generate", gen)):
            tie = check_against_plain(what, r.uid, toks, *plain[r.uid])
            if tie is not None:
                near_ties[what].append(tie)
    exact = {what: len(reqs) - len(t) for what, t in near_ties.items()}
    print(f"tokens == plain route (full forward, no kernel; {plain_s:.1f} s) "
          f"for {exact['engine']}/{len(reqs)} requests from the engine and "
          f"{exact['generate']}/{len(reqs)} from generate; near-tie "
          f"divergences: {near_ties}", flush=True)
    report = dict(tok_per_s=n_tok / dt, seconds=dt, tokens=n_tok,
                  host_syncs_per_token=eng.n_host_syncs / n_tok,
                  peak_mib=peak / 2**20, launches=launches,
                  exact_requests=exact, near_ties=near_ties)
    report["profile"] = profile_serve(engine, reqs, dt)
    return report


def profile_serve(make_engine, reqs, untraced_wall):
    """A second, traced run of the same requests under torch.profiler:
    device busy time, host time per engine stage, and the kernels that
    take the device time.  Tracing slows the host, so the idle share is
    given against both the traced wall time and the untraced run's."""
    import dataclasses

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    eng = make_engine()
    stages = ("_admit_group", "_dispatch", "_process")
    for name in stages:
        def ranged(*a, _fn=getattr(eng, name), _tag=f"engine{name}", **kw):
            with record_function(_tag):
                return _fn(*a, **kw)
        setattr(eng, name, ranged)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run([dataclasses.replace(r) for r in reqs])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    tags = {f"engine{n}" for n in stages}
    events = prof.events()
    # kernels and copies only: the GPU-side spans of the stage annotations
    # cover idle gaps too
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)
           and e.name not in tags]
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy, end = 0.0, float("-inf")
    for s0, s1 in spans:  # length of the union of device intervals (us)
        busy += max(0.0, s1 - max(s0, end))
        end = max(end, s1)
    by_name = {}
    for e in dev:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    stage_rows = {t: dict(calls=0, host_ms=0.0, device_span_ms=0.0)
                  for t in sorted(tags)}
    for e in events:
        if e.name in tags:
            row = stage_rows[e.name]
            if e.device_type == DeviceType.CUDA:
                row["device_span_ms"] += e.time_range.elapsed_us() / 1e3
            else:
                row["calls"] += 1
                row["host_ms"] += e.time_range.elapsed_us() / 1e3
    report = dict(
        traced_wall_s=wall, device_busy_s=busy / 1e6,
        device_idle_share_traced=1 - busy / 1e6 / wall,
        device_idle_share_untraced=1 - busy / 1e6 / untraced_wall,
        device_ops=len(dev),
        decode_steps=eng.n_decode_dispatches * eng.k, stages=stage_rows,
        top_device_ops=[dict(name=n[:90], calls=c, ms=t / 1e3)
                        for n, (c, t) in top])
    print(f"profile: device busy {busy / 1e6:.4f} s in {len(dev)} device "
          f"ops over {report['decode_steps']} decode steps; idle share "
          f"{report['device_idle_share_untraced']:.3f} of the untraced "
          f"{untraced_wall:.3f} s ({report['device_idle_share_traced']:.3f} "
          f"of the traced {wall:.3f} s)", flush=True)
    for k, v in report["stages"].items():
        print(f"profile stage {k}: {v['calls']} calls, host "
              f"{v['host_ms']:.1f} ms, device span "
              f"{v['device_span_ms']:.1f} ms", flush=True)
    for r in report["top_device_ops"]:
        print(f"profile device op {r['ms']:9.3f} ms {r['calls']:6d}x "
              f"{r['name']}", flush=True)
    return report


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None,
                    help="also write the full report as JSON here")
    args = ap.parse_args(argv)

    import torch

    phase("device")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.kernels import build
        from repro_torch.utils.device import resolve_device
    except ImportError as e:
        print(f"chip_smoke: the repro_torch package is not beside this "
              f"script ({e})", file=sys.stderr)
        return 2
    resolve_device("cuda")  # also switches TF32 off (f32 reference numbers)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    print(f"torch {torch.__version__} (CUDA {torch.version.cuda}); "
          f"device {kind}; count {count}; nvidia-smi name, power.limit:",
          flush=True)
    print(smi[0] if smi else "nvidia-smi: no output", flush=True)

    phase("build")
    t0 = time.perf_counter()
    secs = build.build_all()
    print(f"built {sorted(secs)} from {build.CSRC.relative_to(ROOT)} in "
          f"{time.perf_counter() - t0:.1f} s (per source: "
          f"{ {k: round(v, 1) for k, v in secs.items()} })", flush=True)
    for name, log in build.ptxas_log.items():
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        print(f"ptxas {name}: {regs}", flush=True)

    phase("kernels vs plain versions")
    rows = run_kernels()

    phase("serve gpt-base")
    serve = run_serve(rows)

    kernels = [{key: r[key] for key in (
        "name", "route", "source", "replaces", "launches", "max_abs_err",
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
        for r in rows.values()]
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"device": kind, "nvidia_smi": smi, "kernels": list(rows.values()),
             "serve": serve, "build_seconds": secs}, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
