#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``repro_torch``): serving, the
paper's growth and training loop, speculative serving of the grown model
with its source drafting, both served from a paged pool,
recurrentgemma-2b (griffin) served from a dense and a paged pool, and
qwen3-0.6b (RoPE) served on every route; DeiT-S grown into DeiT-B
with checkpoints, resume and the three examples.

    python3 chip_smoke.py [--out report.json]

Needs one CUDA card and runs from the root of a checkout.  Phases, each
printed as it goes; a failed phase raises, so the exit code is not 0:

  1. device  -- CUDA present; name, count, and ``nvidia-smi`` name and
                power limit;
  2. build   -- compile every CUDA kernel of the path from ``src/`` (one
                nvcc per source, all started together);
  3. kernels -- each kernel against its plain PyTorch version on the card
                at the main paths' shapes (gpt-base serving, gpt-small ->
                gpt-base growth, gpt-base's speculative verify and
                gpt-small's catch-up, the paged kernels over a 128-page
                arena through permuted block tables with a sentinel block,
                recurrentgemma-2b's ring decode over dense rings and a
                permuted arena, and its admission scan at 8 rows and at
                one, qwen3-0.6b's and gpt-base's ``generate`` decode over
                the pool's transposed view) plus GQA, bfloat16, ragged,
                ring and window cases, gpt-base's verify at d 16 (S 17)
                dense and paged, the dense slot and ``decode_attention``
                with their bands cut on the device and by the host (the
                sandwich's gradients too), then
                CUDA-event times of kernel, plain version and one PyTorch
                library call beside the kernel's bound, in f32 and, for
                every kernel with a bf16 case, in bf16 (flash's and the
                sandwich's f32 bound at the 3xTF32 rate beside the SIMT
                one);
  4. serve   -- full-width gpt-base (12 x 768, vocab 50257, random weights
                from a seeded generator) through the continuous-batching
                engine: capacity 8, max_len 1024, K 8, 16 requests of
                64..512 prompt tokens and 64 new tokens each.  Both kernels'
                launch counters must move, each ``generate`` call must
                launch decode_attention exactly 12 x 63 times (and the
                engine never), and every request's tokens,
                from the engine and from ``generate``, must equal the plain
                route's (a full forward per step, which runs no kernel of
                the port) except where its top-2 logit gap is below 1e-4
                (an f32 near tie, reported).
  5. grow    -- the paper's loop at full width: pretrain gpt-small (12 x
                512), train the rank-1 Mango operator into gpt-base (Eq. 7;
                the sandwich kernel must launch every step), grow and hold
                the contraction against its one-einsum reference, check
                that the grown gpt-base's loss is below a scratch one's,
                train it a few steps, serve it (tokens == the plain route),
                and run the train launcher once with ``--grow-from``;
  6. speculate -- phase 5's grown gpt-base served with its pretrained
                gpt-small drafting (d 4, K 2, capacity 8, max_len 1024, 16
                requests of 64..448 prompt tokens from the 1024-id chain, 64
                new tokens): tokens == the plain route (near ties
                reported), exact launch counts of the chunk-verify, slot
                and flash kernels, tok/s beside the non-speculative engine
                on the same requests; a traced run, and a second one
                with the dense slot's other cut of its bands; then
                gpt-base drafting for itself, where a rejection must sit
                at a near tie;
  7. paged   -- phase 4's gpt-base from a paged pool of 48 pages (3/8 of
                the dense pool's 128), capacity 8, max_len 1024 (page 64),
                K 8: 16 requests of 64 new tokens, 12 opening with one
                256-token prefix, beside the dense pool (dense, paged,
                paged, dense): tokens == the plain route and the dense
                engine (near ties reported), prefix hits, admissions that
                waited for pages, exact launches of the paged slot kernel
                (one per layer per decode step, the dense one never), no
                page left in use; a traced run for the idle share;
  8. paged speculate -- phase 6's pair and requests with both pools on
                one arena of 64 pages, beside the dense speculative engine:
                tokens == phase 6's plain route, exact launches of the
                paged chunk-verify and paged slot kernels (the dense ones
                never);
  9. griffin -- recurrentgemma-2b at full width and depth (26 layers: 18
                RG-LRU, 8 local MQA with window 2048; f32, seeded weights)
                through the engine on the dense pool: capacity 8, max_len
                4096, K 8, 16 requests of 64 new tokens, prompts of 64..512,
                1990..2040 (rings wrap in decode) and 2100..2600 tokens
                (rings filled at admission).  Tokens from the engine and
                from ``generate`` == the plain route (the scalar
                ``decode_step`` over all rows at one shared position, no
                kernel) up to reported near ties; exactly 8 ring launches a
                decode step and 18 scan launches an admission group, no
                other kernel; a traced run for the idle share;
 10. griffin paged -- phase 9's model and requests from a 160-page arena
                (5/8 of the dense rings' 256) beside the dense pool: tokens
                == the plain route and the dense engine, exact launches of
                the paged ring kernel (the dense one never), the refused
                admissions, prefill groups, macro-steps and pages
                high-water as a CPU run of the same schedule (1-layer
                model) predicted, no page left in use;
 11. qwen3  -- qwen3-0.6b at full width and depth (28 layers, 16 heads
                over 8 KV heads of 128, q/k norms, RoPE theta 1e6, vocab
                151,936, tied; f32, seeded weights with the block
                matrices scaled 2.5x, so greedy output varies): 16 requests of
                64..768 prompt tokens and 64 new through the engine
                (capacity 8, max_len 1024, K 8) on the dense pool, a
                64-page paged pool and speculatively with the model
                drafting for itself (d 4, K 2), then ``generate`` for each
                request (B 1) and over 8 prompts of 512 (B 8).  Tokens ==
                the plain route (a full forward per token) up to reported
                near ties, paged == dense, exact launches (decode_attention
                28 x 63 per ``generate`` call and never from the engine),
                no page left in use, at least 512 distinct tokens from
                the dense engine; tok/s, host syncs per token, peak
                memory, a traced run's idle share (and the dense slot's
                traced time with each cut of its bands).  The f32 logits
                of 8 ``decode_step`` calls against the f32 full forward,
                within 1e-3 of the largest logit.  Then the published
                bf16 (weights cast from the f32 ones) through ``generate``
                at B 8: tok/s, and the max |logit| error of 8 decode steps
                against the f32 route on the same weights, which must be
                at most twice the plain bf16 route's.
 12. deit   -- the paper's headline setting at full width: DeiT-S (12 x
                384) grown into DeiT-B (12 x 768), 197 tokens, 1000
                classes, f32, batches of 32 synthetic images whose labels
                come from the first 16 classes.  Pretrain DeiT-S 40 steps
                (ms/step), save it through an async checkpoint manager and
                reload it (every leaf equal, on the card); 10 rank-1 Mango
                operator steps into DeiT-B (the sandwich launching every
                step), grow, the contraction against its reference (1e-5),
                grown below scratch on a held-out batch (the margin), 4
                DeiT-B train steps (ms/step); the train launcher grown
                from that checkpoint (the sibling-directory rule),
                saving every 3 of 6 steps, then resumed from a copy of
                step 3 (losses at steps 3-5 within 1e-4 relative; each
                save's seconds and bytes); the three examples
                (``quickstart``, ``grow_pipeline`` at its default steps,
                ``train_100m --grow --steps 8``); peak memory and traces
                of the DeiT-B train step and the operator step.

Each traced run prints the device time of each of the port's kernels.
Each path's launch counters are set to 0 just before it runs and read just
after; a kernel of the path that was never launched fails the run.  The
line before the last is the kernels JSON; the last line is
``{"ok": true, "device": {...}}``.  Without CUDA, or without the package
beside this file, it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): memory rate, and the
# operation rate for each input type (float32 outside the tensor cores)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12,
              # float32 on the tensor cores as 3xTF32: three TF32 passes
              "float32_3xtf32": 495e12 / 3}
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
    (the sleep doubles until the enqueue fits inside it).  Calls that
    launch more kernels than the device's launch queue holds (a plain
    version that loops over a sequence) make the host wait for the device
    whatever the sleep, so past a 1.6 s hold the calls are timed without
    one: they keep the device busy by themselves."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    hold_s = 0.05
    while True:
        if hold_s <= 1.6:  # cycles; >= hold_s at <= 2 GHz
            torch.cuda._sleep(int(hold_s * 2e9))
        start.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        end.record()
        enqueue_s = time.perf_counter() - t0
        end.synchronize()
        if enqueue_s < hold_s or hold_s > 1.6:
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


def bound_ms(nbytes, flops, dtype_name, rate=None):
    """(ms, "bytes" or "operations"): the larger of the bytes over the
    memory rate and the operations over ``PEAK_FLOPS[rate or dtype]``."""
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[rate or dtype_name]
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
    (L, B, S, KV, hd) pools whose layers the timing cycles through.  Cases
    0, 2 and 4 are timed."""
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
             [3, 0, 511, 64]),
            # phase 6's draft: gpt-small's pool, bands of a prompt and a
            # reply filling a third to a half of it
            ("gpt-small draft f32", 12, 8, 1024, 8, 8, 64, torch.float32,
             [64, 120, 180, 240, 300, 360, 420, 512])):
        def rnd(*s):
            return torch.randn(*s, generator=gen, device="cuda").to(dt)
        out.append((label, rnd(B, H, hd), rnd(L, B, S, KV, hd),
                    rnd(L, B, S, KV, hd),
                    torch.tensor(kvl, dtype=torch.int32, device="cuda")))
    return out


def sandwich_cases(gen):
    """(label, x, a_i, a_o) at the growth path's shape first (gpt-small ->
    gpt-base: 12 slots x 12 layers, 512 -> 768), the DeiT path's last
    (deit-s -> deit-b: 12 x 12, 384 -> 768).  x ~ N(0, 1) and the
    operators are scaled by 1/sqrt(fan-in), so |Y| ~ 1."""
    import torch

    out = []
    for label, N, d1i, d1o, d2i, d2o, dt in (
            ("gpt-small->gpt-base f32", 144, 512, 512, 768, 768,
             torch.float32),
            ("gpt-small->gpt-base bf16", 144, 512, 512, 768, 768,
             torch.bfloat16),
            ("ragged f32", 3, 50, 70, 100, 36, torch.float32),
            ("non-square bf16", 7, 256, 384, 640, 96, torch.bfloat16),
            ("deit-s->deit-b f32", 144, 384, 384, 768, 768, torch.float32),
            ("deit-s->deit-b bf16", 144, 384, 384, 768, 768,
             torch.bfloat16)):
        def rnd(*s, scale=1.0):
            return (scale * torch.randn(*s, generator=gen,
                                        device="cuda")).to(dt)
        out.append((label, rnd(N, d1i, d1o), rnd(d1i, d2i, scale=d1i ** -0.5),
                    rnd(d1o, d2o, scale=d1o ** -0.5)))
    return out


def check_sandwich_grads(label, x, a_i, a_o, dname):
    """``ops.TrSandwich``'s gradients (forward and dX through the kernel)
    against autograd of the plain version, relative to each gradient's
    largest entry: 1e-5 in f32 (summation order), 1e-2 in bf16 (one
    rounding of the output and of dX)."""
    import torch

    from repro_torch.kernels import ops, ref

    dy = torch.randn(x.shape[0], a_i.shape[1], a_o.shape[1], device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(2)
                     ).to(x.dtype)

    def grads(fn):
        ins = [t.detach().clone().requires_grad_(True) for t in (x, a_i, a_o)]
        return torch.autograd.grad(fn(*ins), ins, dy)

    got, want = grads(ops.tr_sandwich), grads(ref.tr_sandwich_ref)
    torch.cuda.synchronize()
    rel = max(float((g.float() - w.float()).abs().max()
                    / w.float().abs().max()) for g, w in zip(got, want))
    limit = 1e-5 if dname == "float32" else 1e-2
    if not rel <= limit:
        raise AssertionError(f"tr_sandwich [{label}]: gradients disagree "
                             f"with autograd of the plain version (max "
                             f"relative err {rel:.3g} > {limit})")
    return rel


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
        if i not in (0, 2):  # time the first f32 and the first bf16 case
            continue
        B, H, S, hd = q.shape
        KV = k.shape[1]
        nbytes = (2 * B * H + 2 * B * KV) * S * hd * q.element_size()
        flops = 2 * B * H * S * S * hd

        def sdpa():
            return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                  enable_gqa=H != KV)
        if i == 2:
            row = rows["flash_attention"]
            row["bf16_ms"] = time_ms(lambda: fa(q, k, v, causal=True), 20)
            row["bf16_library_ms"] = time_ms(sdpa, 20)
            row["bf16_bound_ms"], row["bf16_bound_by"] = bound_ms(
                nbytes, flops, dname)
            row["bf16_max_abs_err"] = err
            continue
        b_ms, b_by = bound_ms(nbytes, flops, dname, "float32_3xtf32")
        rows["flash_attention"] = dict(
            name="flash_attention", route="cuda",
            source="src/repro_torch/kernels/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention.py:68",
            max_abs_err=err,
            ms=time_ms(lambda: fa(q, k, v, causal=True), 20),
            plain_ms=time_ms(
                lambda: ref.flash_attention_ref(q, k, v, causal=True), 5),
            bound_ms=b_ms, bound_by=b_by, bound_rate="3xTF32",
            bound_simt_ms=bound_ms(nbytes, flops, dname)[0],
            library_ms=time_ms(sdpa, 20),
            shape=f"q{tuple(q.shape)} k/v{tuple(k.shape)} {dname} causal")

    sd = decode_attention.slot_decode_attention
    on_device_default = decode_attention.SLOT_CUT_ON_DEVICE
    for i, (label, q, kp, vp, kvl) in enumerate(slot_cases(gen)):
        dname = str(q.dtype).split(".")[1]
        want = ref.slot_decode_attention_ref(q, kp[0], vp[0], kvl)
        errs = {}
        for on_device in (False, True):  # the host's cut, the device's
            decode_attention.SLOT_CUT_ON_DEVICE = on_device
            got = sd(q, kp[0], vp[0], kvl)
            torch.cuda.synchronize()
            errs[on_device] = check_close(
                f"slot_decode_attention [{label}, cut on the "
                f"{'device' if on_device else 'host'}]", got, want, dname)
            if not bool((got[kvl == 0] == 0).all()):
                raise AssertionError(f"slot_decode_attention [{label}]: "
                                     "rows with kv_len 0 are not exact zeros")
        decode_attention.SLOT_CUT_ON_DEVICE = on_device_default
        err = errs[on_device_default]
        splits = decode_attention._paged_splits(
            "slot_decode_attention", q, kp.shape[3], kp.shape[2])
        print(f"slot_decode_attention [{label}] q{tuple(q.shape)} "
              f"pool{tuple(kp.shape[1:])} kv_len {kvl.tolist()}: max abs "
              f"err {err:.3g} (host's cut {errs[False]:.3g}), pieces "
              f"{splits}, kv_len-0 rows exact zeros", flush=True)
        if i not in (0, 2, 4):  # the first f32 and bf16 cases, the draft
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

        kern = cycled(lambda k, v: sd(q, k, v, kvl))
        cut_ms = {True: 0.0, False: 0.0}  # device, host, host, device
        for on_device in (True, False, False, True):
            decode_attention.SLOT_CUT_ON_DEVICE = on_device
            cut_ms[on_device] += time_ms(kern, 10 * L) / 2
        decode_attention.SLOT_CUT_ON_DEVICE = on_device_default
        print(f"slot_decode_attention [{label}]: bands cut on the device "
              f"{cut_ms[True]:.4f} ms, on the host {cut_ms[False]:.4f} ms, "
              f"bound {b_ms:.4f} ms", flush=True)
        if i == 4:
            rows["slot_decode_attention"]["gpt_small_draft"] = dict(
                device_cut_ms=cut_ms[True], host_cut_ms=cut_ms[False],
                library_ms=time_ms(cycled(lib), 10 * L), bound_ms=b_ms,
                splits=splits)
            continue
        if i == 2:
            row = rows["slot_decode_attention"]
            row["bf16_ms"] = cut_ms[on_device_default]
            row["bf16_device_cut_ms"] = cut_ms[True]
            row["bf16_host_cut_ms"] = cut_ms[False]
            row["bf16_library_ms"] = time_ms(cycled(lib), 10 * L)
            row["bf16_bound_ms"], row["bf16_bound_by"] = b_ms, b_by
            row["bf16_max_abs_err"] = err
            continue
        rows["slot_decode_attention"] = dict(
            name="slot_decode_attention", route="cuda",
            source="src/repro_torch/kernels/csrc/slot_decode_attention.cu",
            replaces="src/repro/kernels/decode_attention.py:502",
            max_abs_err=err, ms=cut_ms[on_device_default],
            device_cut_ms=cut_ms[True], host_cut_ms=cut_ms[False],
            splits=splits,
            plain_ms=time_ms(cycled(
                lambda k, v: ref.slot_decode_attention_ref(q, k, v, kvl)),
                2 * L),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=time_ms(cycled(lib), 10 * L),
            shape=(f"q{tuple(q.shape)} pool{tuple(kp.shape[1:])} {dname} "
                   f"kv_len {kvl.tolist()}"))
    from repro_torch.kernels import tr_sandwich

    sw = tr_sandwich.tr_sandwich
    for i, (label, x, a_i, a_o) in enumerate(sandwich_cases(gen)):
        dname = str(x.dtype).split(".")[1]
        got = sw(x, a_i, a_o)
        torch.cuda.synchronize()
        err = check_close(f"tr_sandwich [{label}]", got,
                          ref.tr_sandwich_ref(x, a_i, a_o), dname)
        grad_rel = check_sandwich_grads(label, x, a_i, a_o, dname)
        print(f"tr_sandwich [{label}] x{tuple(x.shape)} a_i"
              f"{tuple(a_i.shape)} a_o{tuple(a_o.shape)}: max abs err "
              f"{err:.3g}; grads max relative err {grad_rel:.3g}",
              flush=True)
        if i in (2, 3):  # time gpt-small's and deit-s's f32 and bf16
            continue
        N, d1i, d1o = x.shape
        d2i, d2o = a_i.shape[1], a_o.shape[1]
        nbytes = ((N * d1i * d1o + d1i * d2i + d1o * d2o + N * d2i * d2o)
                  * x.element_size())
        flops = 2 * N * (d1i * d1o * d2o + d1i * d2i * d2o)

        def two_products():  # yardstick only: T goes to device memory
            return torch.matmul(a_i.mT, torch.matmul(x, a_o))
        if i in (1, 5):
            row = (rows["tr_sandwich"] if i == 1
                   else rows["tr_sandwich"]["deit"])
            row["bf16_ms"] = time_ms(lambda: sw(x, a_i, a_o), 10)
            row["bf16_library_ms"] = time_ms(two_products, 10)
            row["bf16_bound_ms"], row["bf16_bound_by"] = bound_ms(
                nbytes, flops, dname)
            row["bf16_max_abs_err"] = err
            if i == 5:
                row["bf16_plain_ms"] = time_ms(
                    lambda: ref.tr_sandwich_ref(x, a_i, a_o), 5)
                print(f"time tr_sandwich [{label}]: kernel "
                      f"{row['bf16_ms']:.4f} ms, plain "
                      f"{row['bf16_plain_ms']:.4f} ms, cuBLAS "
                      f"{row['bf16_library_ms']:.4f} ms, bound "
                      f"{row['bf16_bound_ms']:.4f} ms "
                      f"({row['bf16_bound_by']})", flush=True)
            continue
        b_ms, b_by = bound_ms(nbytes, flops, dname, "float32_3xtf32")
        row = dict(
            max_abs_err=err, grad_max_rel_err=grad_rel,
            ms=time_ms(lambda: sw(x, a_i, a_o), 10),
            plain_ms=time_ms(lambda: ref.tr_sandwich_ref(x, a_i, a_o), 5),
            bound_ms=b_ms, bound_by=b_by, bound_rate="3xTF32",
            bound_simt_ms=bound_ms(nbytes, flops, dname)[0],
            library_ms=time_ms(two_products, 10),
            shape=f"x{tuple(x.shape)} -> ({N}, {d2i}, {d2o}) {dname}")
        if i == 4:  # the DeiT path's shape, beside the main row
            rows["tr_sandwich"]["deit"] = row
            print(f"time tr_sandwich [{label}]: kernel {row['ms']:.4f} ms, "
                  f"plain {row['plain_ms']:.4f} ms, cuBLAS "
                  f"{row['library_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}, "
                  f"3xTF32; SIMT {row['bound_simt_ms']:.4f} ms)", flush=True)
            continue
        rows["tr_sandwich"] = dict(
            name="tr_sandwich", route="cuda",
            source="src/repro_torch/kernels/csrc/tr_sandwich.cu",
            replaces="src/repro/kernels/tr_sandwich.py:41", **row)
    rows["decode_attention"] = run_decode_cases(gen)
    rows["chunk_verify_attention"] = run_chunk_cases(gen)
    rows.update(run_paged_cases(gen))
    rows.update(run_griffin_cases(gen))
    for r in rows.values():  # the first bf16 case's numbers, on the row
        bf16 = [c for c in r.get("cases", ()) if c["dtype"] == "bfloat16"]
        if bf16 and "bf16_ms" not in r:
            for key in ("ms", "library_ms", "bound_ms", "bound_by",
                        "max_abs_err"):
                r[f"bf16_{key}"] = bf16[0][key]
    for r in rows.values():
        lib = ("none" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms")
        rate = f", {r['bound_rate']}" if "bound_rate" in r else ""
        print(f"time {r['name']} [{r['shape']}]: kernel {r['ms']:.4f} ms, "
              f"plain {r['plain_ms']:.4f} ms, library {lib}, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}{rate})", flush=True)
        if "bf16_ms" in r:
            simt = (f"f32 SIMT bound {r['bound_simt_ms']:.4f} ms; "
                    if "bound_simt_ms" in r else "")
            lib = ("none" if r["bf16_library_ms"] is None
                   else f"{r['bf16_library_ms']:.4f} ms")
            print(f"time {r['name']}: {simt}bf16 kernel "
                  f"{r['bf16_ms']:.4f} ms, library {lib}, bound "
                  f"{r['bf16_bound_ms']:.4f} ms ({r['bf16_bound_by']})",
                  flush=True)
    return rows


def decode_cases():
    """Phase 3's ``decode_attention`` cases: (label, L, B, S, H, KV, hd,
    dtype, layout, kv_len).  qwen3-0.6b's ``generate`` decode at B 8 first
    (the kernels-line row): q (8, 16, 128) over the head-major view of
    (8, 576, 8, 128) layer caches, ragged lengths with one 0; then the same
    in bfloat16, gpt-base's ``generate`` at B 1 (12 heads over 12 KV heads
    of 64, 1024 positions), qwen3-0.6b's at B 1 early in a reply (a band
    of 100 in a max_len of 1024: shorter than the host's pieces) and a
    contiguous head-major cache at yi-9b's grouping (G 8).  ``L`` layer
    caches, cycled by the timing so that a call finds its layer cold in
    L2."""
    import torch

    f32, bf16 = torch.float32, torch.bfloat16
    qwen = [0, 528, 536, 545, 553, 561, 570, 576]
    return [
        ("qwen3-0.6b generate B 8 f32", 8, 8, 576, 16, 8, 128, f32, "pool",
         qwen),
        ("qwen3-0.6b generate B 8 bf16", 8, 8, 576, 16, 8, 128, bf16, "pool",
         qwen),
        ("gpt-base generate B 1 f32", 12, 1, 1024, 12, 12, 64, f32, "pool",
         [600]),
        ("qwen3-0.6b generate B 1 short f32", 8, 1, 1024, 16, 8, 128, f32,
         "pool", [100]),
        ("head-major G 8 f32", 2, 4, 300, 32, 4, 128, f32, "head-major",
         [0, 77, 300, 299]),
    ]


def run_decode_cases(gen):
    """Phase 3 for ``decode_attention``: every case against the plain
    version (f32 within 2e-5 + 1e-4 relative, bfloat16 within 5e-3 + 1e-2
    relative; kv_len-0 rows exact zeros), with each band cutting its own
    length on the device (the wrapper's choice) and with the host's cut
    of the whole cache axis, each timed, beside its byte bound, the plain
    version and masked SDPA over the same K/V views.  The first case is
    the kernels-line row."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention, ref

    fn = decode_attention.decode_attention
    on_device_default = decode_attention.DECODE_CUT_ON_DEVICE
    row = None
    for label, L, B, S, H, KV, hd, dt, layout, kvl in decode_cases():
        dname = str(dt).split(".")[1]
        q = torch.randn(B, H, hd, generator=gen, device="cuda").to(dt)
        if layout == "pool":  # (L, B, S, KV, hd) pools, read transposed
            kp, vp = (torch.randn(L, B, S, KV, hd, generator=gen,
                                  device="cuda").to(dt).transpose(2, 3)
                      for _ in range(2))
        else:
            kp, vp = (torch.randn(L, B, KV, S, hd, generator=gen,
                                  device="cuda").to(dt) for _ in range(2))
        lens = torch.tensor(kvl, dtype=torch.int32, device="cuda")
        want = ref.decode_attention_ref(q, kp[0], vp[0], lens)
        errs = {}
        for on_device in (False, True):
            decode_attention.DECODE_CUT_ON_DEVICE = on_device
            got = fn(q, kp[0], vp[0], lens)
            torch.cuda.synchronize()
            errs[on_device] = check_close(
                f"decode_attention [{label}, cut on the "
                f"{'device' if on_device else 'host'}]", got, want, dname)
            if not bool((got[lens == 0] == 0).all()):
                raise AssertionError(f"decode_attention [{label}]: rows "
                                     "with kv_len 0 are not exact zeros")
        err = errs[on_device_default]
        item = q.element_size()
        n_kv = int(lens.clamp(0, S).sum())
        b_ms, b_by = bound_ms(
            n_kv * KV * hd * 2 * item + 2 * B * H * hd * item + 4 * B,
            4 * n_kv * H * hd, dname)
        layers = iter(range(10 ** 9))
        mask = torch.arange(S, device="cuda")[None] < lens[:, None]

        def cycled(call):
            def run():
                j = next(layers) % L
                return call(kp[j], vp[j])
            return run

        def lib(k, v):
            return F.scaled_dot_product_attention(
                q[:, :, None], k, v, attn_mask=mask[:, None, None],
                enable_gqa=H != KV)

        kern = cycled(lambda k, v: fn(q, k, v, lens))
        cut_ms = {True: 0.0, False: 0.0}  # device, host, host, device
        for on_device in (True, False, False, True):
            decode_attention.DECODE_CUT_ON_DEVICE = on_device
            cut_ms[on_device] += time_ms(kern, 10 * L) / 2
        decode_attention.DECODE_CUT_ON_DEVICE = on_device_default
        case = dict(
            label=label, dtype=dname, max_abs_err=err,
            ms=cut_ms[on_device_default],
            device_cut_ms=cut_ms[True], host_cut_ms=cut_ms[False],
            host_cut_max_abs_err=errs[False],
            plain_ms=time_ms(cycled(
                lambda k, v: ref.decode_attention_ref(q, k, v, lens)), 2 * L),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=time_ms(cycled(lib), 10 * L),
            splits=decode_attention._paged_splits("decode_attention", q, KV,
                                                  S),
            shape=(f"q{tuple(q.shape)} k/v{tuple(kp.shape[1:])} {layout} "
                   f"{dname} kv_len {kvl}"))
        print(f"decode_attention [{label}] {case['shape']}: max abs err "
              f"{err:.3g}, pieces {case['splits']}; kernel {case['ms']:.4f} "
              f"ms (bands cut on the device {case['device_cut_ms']:.4f} ms, "
              f"on the host {case['host_cut_ms']:.4f} ms), plain "
              f"{case['plain_ms']:.4f} ms, SDPA {case['library_ms']:.4f} ms, "
              f"bound {b_ms:.4f} ms ({b_by})", flush=True)
        if row is None:
            row = dict(
                name="decode_attention", route="cuda",
                source="src/repro_torch/kernels/csrc/decode_attention.cu",
                replaces="src/repro/kernels/decode_attention.py:126",
                cases=[], **{key: case[key] for key in (
                    "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "shape")})
        row["cases"].append(case)
    return row


def chunk_cases():
    """(label, L, B, S, H, KV, Sc, hd, dtype, ring, window, offsets): the
    speculative path's two shapes first -- gpt-base's verify and gpt-small's
    catch-up, d 4 at capacity 8 over max_len 1024, one done row -- then
    ring, window, GQA and bfloat16 cases (cache lengths that divide
    nothing, wrapped ring offsets, S*G = 128 across 16 query tiles), and
    gpt-base's verify at d 16 (S 17: tiles mixing cache and chunk rows)."""
    import torch

    spread = [-1, 64, 137, 210, 283, 356, 430, 576]
    f32, bf16 = torch.float32, torch.bfloat16
    return [
        ("gpt-base verify f32", 12, 8, 5, 12, 12, 1024, 64, f32, False, None,
         spread),
        ("gpt-small catch-up f32", 12, 8, 5, 8, 8, 1024, 64, f32, False,
         None, spread),
        ("gpt-base verify bf16", 2, 8, 5, 12, 12, 1024, 64, bf16, False,
         None, spread),
        ("ring window GQA f32", 2, 6, 5, 8, 2, 300, 128, f32, True, 128,
         [-1, 0, 1, 150, 300, 1234]),
        ("ring GQA bf16", 2, 6, 5, 16, 4, 300, 64, bf16, True, None,
         [-1, 0, 7, 299, 301, 901]),
        ("window full G8 f32", 2, 4, 16, 16, 2, 500, 128, f32, False, 64,
         [-1, 3, 250, 500]),
        ("gpt-base verify S 17 f32", 2, 8, 17, 12, 12, 1024, 64, f32, False,
         None, spread),
    ]


def run_chunk_cases(gen):
    """Phase 3 for ``chunk_verify_attention``: every case against the plain
    version (f32 within 1e-5 of the largest entry, bfloat16 within
    5e-3 + 1e-2 relative) and timed beside its bound, the plain version
    and masked SDPA over K/V concatenated ahead of the timing.  The first
    case (gpt-base's verify) is the kernels-line row."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention, ref

    cv_fn = decode_attention.chunk_verify_attention
    cases = []
    for (label, L, B, S, H, KV, Sc, hd, dt, ring, window,
         offs) in chunk_cases():
        def rnd(*s):
            return torch.randn(*s, generator=gen, device="cuda").to(dt)
        q, kc, vc = rnd(B, S, H, hd), rnd(B, S, KV, hd), rnd(B, S, KV, hd)
        ckp, cvp = rnd(L, B, Sc, KV, hd), rnd(L, B, Sc, KV, hd)
        off = torch.tensor(offs, dtype=torch.int32, device="cuda")
        kw = dict(ring=ring, window=window)
        dname = str(dt).split(".")[1]
        got = cv_fn(q, ckp[0], cvp[0], kc, vc, off, **kw)
        torch.cuda.synchronize()
        want = ref.chunk_verify_attention_ref(q, ckp[0], cvp[0], kc, vc, off,
                                              **kw)
        err = (got.float() - want.float()).abs().max().item()
        if dname == "float32":
            if not err <= 1e-5 * want.abs().max().item():
                raise AssertionError(
                    f"chunk_verify_attention [{label}]: max abs err "
                    f"{err:.3g} exceeds 1e-5 of the largest entry")
        else:
            check_close(f"chunk_verify_attention [{label}]", got, want,
                        dname)
        if not bool((got[off < 0] == 0).all()):
            raise AssertionError(f"chunk_verify_attention [{label}]: done "
                                 "rows are not exact zeros")
        # the bound: each row's attended cache positions and its S chunk
        # keys once, q and out, the offsets
        n_keys = 0
        for o in offs:
            if o < 0:
                continue
            lo = max(0, o - Sc) if ring else 0
            if window:
                lo = max(lo, o - window + 1)
            n_keys += max((o if ring else min(o, Sc)) - lo, 0) + S
        item = q.element_size()
        b_ms, b_by = bound_ms(
            n_keys * KV * hd * 2 * item + 2 * B * S * H * hd * item + 4 * B,
            4 * n_keys * S * H * hd, dname)
        # library yardstick: SDPA with a boolean mask over [cache ‖ chunk]
        # concatenated per layer ahead of the timing
        steps = torch.arange(S, device="cuda")[None]
        if ring:
            kpos_c = ref._ring_kpos(off, Sc)
        else:
            pos = torch.arange(Sc, device="cuda")[None]
            kpos_c = torch.where(pos < off[:, None], pos, -1)
        kpos = torch.cat([kpos_c, off[:, None] + steps], 1)
        qpos = off[:, None] + steps
        mask = (kpos[:, None] >= 0) & (kpos[:, None] <= qpos[:, :, None])
        if window:
            mask &= kpos[:, None] > qpos[:, :, None] - window
        k_all = [torch.cat([ckp[j], kc], 1).transpose(1, 2) for j in range(L)]
        v_all = [torch.cat([cvp[j], vc], 1).transpose(1, 2) for j in range(L)]
        qt = q.transpose(1, 2)
        layers = iter(range(10 ** 9))

        def cycled(fn):
            def call():
                return fn(next(layers) % L)
            return call

        case = dict(
            label=label, dtype=dname, max_abs_err=err,
            ms=time_ms(cycled(lambda j: cv_fn(q, ckp[j], cvp[j], kc, vc, off,
                                              **kw)), 10 * L),
            plain_ms=time_ms(cycled(lambda j: ref.chunk_verify_attention_ref(
                q, ckp[j], cvp[j], kc, vc, off, **kw)), 2 * L),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=time_ms(cycled(lambda j: F.scaled_dot_product_attention(
                qt, k_all[j], v_all[j], attn_mask=mask[:, None],
                enable_gqa=H != KV)), 10 * L),
            shape=(f"q{tuple(q.shape)} cache{tuple(ckp.shape[1:])} {dname} "
                   f"ring {ring} window {window} offsets {offs}"))
        # rows a tile, tiles, then the band's pieces: (positions, a
        # cluster of)
        case["splits"] = decode_attention._verify_plan(
            q, KV, Sc, window, "chunk_verify_attention")
        cases.append(case)
        print(f"chunk_verify_attention [{label}] {case['shape']}: max abs "
              f"err {err:.3g}, pieces {case['splits']}; kernel "
              f"{case['ms']:.4f} ms, plain "
              f"{case['plain_ms']:.4f} ms, library {case['library_ms']:.4f} "
              f"ms, bound {b_ms:.4f} ms ({b_by})", flush=True)
        del k_all, v_all, ckp, cvp
    main = cases[0]
    return dict(name="chunk_verify_attention", route="cuda",
                source="src/repro_torch/kernels/csrc/chunk_verify_attention.cu",
                replaces="src/repro/kernels/decode_attention.py:595",
                cases=cases, **{key: main[key] for key in (
                    "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "shape")})


def paged_cases(gen):
    """Phase 3's paged cases: (kernel, label, L, B, S, H, KV, hd, n_pages,
    page, nblk, dtype, lens), gpt-base's shapes first.  Tables are a seeded
    permutation of the arena's pages (not contiguous), and one block
    inside a row's attended range holds the sentinel (a draft past its
    budget reads through it)."""
    import torch

    f32, bf16 = torch.float32, torch.bfloat16
    kv_lens = [0, 97, 200, 333, 451, 576, 800, 1024]
    spread = [-1, 64, 137, 210, 283, 356, 430, 576]
    return [
        ("slot", "gpt-base paged f32", 12, 8, 1, 12, 12, 64, 128, 64, 16,
         f32, kv_lens),
        ("slot", "gpt-small paged f32", 12, 8, 1, 8, 8, 64, 128, 64, 16, f32,
         kv_lens),
        ("slot", "gpt-base paged bf16", 2, 8, 1, 12, 12, 64, 128, 64, 16,
         bf16, kv_lens),
        ("chunk", "gpt-base verify paged f32", 12, 8, 5, 12, 12, 64, 128, 64,
         16, f32, spread),
        ("chunk", "gpt-small catch-up paged f32", 12, 8, 5, 8, 8, 64, 128, 64,
         16, f32, spread),
        ("chunk", "gpt-base verify paged bf16", 2, 8, 5, 12, 12, 64, 128, 64,
         16, bf16, spread),
        ("chunk", "gpt-base verify S 17 paged f32", 2, 8, 17, 12, 12, 64, 128,
         64, 16, f32, spread),
    ]


def run_paged_cases(gen):
    """Phase 3 for the two paged kernels: every case against its plain
    version (``check_close``), then timed beside its bound, the plain
    version and SDPA over K/V gathered from the arena ahead of the timing.
    The first case of each kernel is its kernels-line row."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention, ref

    fns = {"slot": decode_attention.paged_slot_decode_attention,
           "chunk": decode_attention.paged_chunk_verify_attention}
    rows = {}
    for (kind, label, L, B, S, H, KV, hd, n_pages, page, nblk, dt,
         lens) in paged_cases(gen):
        def rnd(*s):
            return torch.randn(*s, generator=gen, device="cuda").to(dt)
        perm = torch.randperm(n_pages, generator=torch.Generator().manual_seed(
            n_pages + B), dtype=torch.int32)
        bt = perm[:B * nblk].reshape(B, nblk) if B * nblk <= n_pages else \
            perm[torch.arange(B * nblk) % n_pages].reshape(B, nblk)
        bt[7, 6] = n_pages  # row 7 attends blocks 0..9 or all 16
        bt = bt.contiguous().cuda()
        ka, va = rnd(L, n_pages, page, KV, hd), rnd(L, n_pages, page, KV, hd)
        ln = torch.tensor(lens, dtype=torch.int32, device="cuda")
        dname = str(dt).split(".")[1]
        name = f"paged_{kind}_" + ("decode_attention" if kind == "slot"
                                   else "verify_attention")
        fn = fns[kind]
        item = ka.element_size()
        cap = nblk * page
        if kind == "slot":
            q = rnd(B, H, hd)

            def kern(j):
                return fn(q, ka[j], va[j], bt, ln)

            def plain(j):
                return ref.paged_slot_decode_attention_ref(q, ka[j], va[j],
                                                           bt, ln)
            n_keys = int(ln.clamp(0, cap).sum())
            qkv = 2 * B * H * hd * item
            mask = (torch.arange(cap, device="cuda")[None] < ln[:, None])[
                :, None, None]
            qt = q[:, :, None]
        else:
            q, kc, vc = rnd(B, S, H, hd), rnd(B, S, KV, hd), rnd(B, S, KV, hd)

            def kern(j):
                return fn(q, ka[j], va[j], bt, kc, vc, ln, ring=False)

            def plain(j):
                return ref.paged_chunk_verify_attention_ref(
                    q, ka[j], va[j], bt, kc, vc, ln, ring=False)
            n_keys = sum(min(o, cap) + S for o in lens if o >= 0)
            qkv = 2 * B * S * H * hd * item
            steps = torch.arange(S, device="cuda")[None]
            pos = torch.arange(cap, device="cuda")[None]
            kpos = torch.cat([torch.where(pos < ln[:, None], pos, -1),
                              ln[:, None] + steps], 1)
            qpos = ln[:, None] + steps
            mask = ((kpos[:, None] >= 0) & (kpos[:, None] <= qpos[:, :, None])
                    )[:, None]
            qt = q.transpose(1, 2)
        got = kern(0)
        torch.cuda.synchronize()
        err = check_close(f"{name} [{label}]", got, plain(0), dname)
        done_rows = (ln == 0) if kind == "slot" else (ln < 0)
        if not bool((got[done_rows] == 0).all()):
            raise AssertionError(f"{name} [{label}]: rows with kv_len 0 / "
                                 "offset -1 are not exact zeros")
        b_ms, b_by = bound_ms(
            n_keys * KV * hd * 2 * item + qkv + 4 * B * nblk + 4 * B,
            4 * n_keys * H * hd * (S if kind == "chunk" else 1), dname)
        # library yardstick: SDPA over each layer's K/V gathered from the
        # arena (and, for a verify, the chunk appended) ahead of the timing
        k_all, v_all = [], []
        for j in range(L):
            kd = ref._paged_gather_ref(ka[j], bt)
            vd = ref._paged_gather_ref(va[j], bt)
            if kind == "chunk":
                kd, vd = torch.cat([kd, kc], 1), torch.cat([vd, vc], 1)
            k_all.append(kd.transpose(1, 2).contiguous())
            v_all.append(vd.transpose(1, 2).contiguous())
        layers = iter(range(10 ** 9))

        def cycled(f):
            def call():
                return f(next(layers) % L)
            return call

        case = dict(
            label=label, dtype=dname, max_abs_err=err,
            ms=time_ms(cycled(kern), 10 * L),
            plain_ms=time_ms(cycled(plain), 2 * L),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=time_ms(cycled(
                lambda j: F.scaled_dot_product_attention(
                    qt, k_all[j], v_all[j], attn_mask=mask,
                    enable_gqa=H != KV)), 10 * L),
            shape=(f"q{tuple(q.shape)} arena{tuple(ka.shape[1:])} bt"
                   f"{tuple(bt.shape)} {dname} "
                   f"{'kv_len' if kind == 'slot' else 'offsets'} {lens}"))
        # the band's pieces: (positions, a cluster of); a verify's rows a
        # tile and tiles first
        case["splits"] = (
            decode_attention._paged_splits(name, q, KV, cap)
            if kind == "slot" else
            decode_attention._verify_plan(q, KV, cap, None))
        split = f", pieces {case['splits']}"
        print(f"{name} [{label}] {case['shape']}: max abs err {err:.3g}"
              f"{split}; kernel {case['ms']:.4f} ms, plain "
              f"{case['plain_ms']:.4f} ms, library {case['library_ms']:.4f} "
              f"ms, bound {b_ms:.4f} ms ({b_by})", flush=True)
        del k_all, v_all, ka, va
        if name not in rows:
            rows[name] = dict(
                name=name, route="cuda",
                source=f"src/repro_torch/kernels/csrc/{name}.cu",
                replaces=("src/repro/kernels/decode_attention.py:366"
                          if kind == "slot" else
                          "src/repro/kernels/decode_attention.py:451"),
                cases=[], **{key: case[key] for key in (
                    "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "shape")})
        rows[name]["cases"].append(case)
    return rows


RING_POSITIONS = [-1, 100, 2047, 2048, 3000, 4095, 1500, 2600]


def ring_cases():
    """Phase 3's ring cases: (kind, label, L, B, H, KV, hd, ring, window,
    dtype, positions, short), recurrentgemma-2b's decode first (8 slots,
    10 query heads over one KV head of 256, ring = window = 2048):
    positions done, inside the first lap, at the ring, past it, far past
    it.  ``short`` rows of a paged case hold only the blocks their
    position reached (the rest of the table is the sentinel)."""
    import torch

    f32, bf16 = torch.float32, torch.bfloat16
    pos = RING_POSITIONS
    return [
        ("ring", "recurrentgemma-2b f32", 8, 8, 10, 1, 256, 2048, 2048, f32,
         pos, ()),
        ("ring", "recurrentgemma-2b bf16", 2, 8, 10, 1, 256, 2048, 2048,
         bf16, pos, ()),
        ("ring", "window < ring f32", 2, 8, 10, 1, 256, 2048, 1000, f32, pos,
         ()),
        ("ring", "GQA hd 128 f32", 2, 6, 16, 4, 128, 300, 130, f32,
         [-1, 0, 5, 299, 300, 1234], ()),
        ("paged_ring", "recurrentgemma-2b paged f32", 8, 8, 10, 1, 256, 2048,
         2048, f32, pos, (1,)),
        ("paged_ring", "recurrentgemma-2b paged bf16", 2, 8, 10, 1, 256,
         2048, 2048, bf16, pos, (1,)),
    ]


def run_griffin_cases(gen):
    """Phase 3 for the three griffin kernels: each case against its plain
    version and timed beside its bound, the plain version and, for the
    ring kernels, SDPA over K/V gathered into position order (with the
    band mask) ahead of the timing; the scan has no one-call library
    counterpart.  The first case of each kernel is its kernels-line
    row."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention, ref, rglru_scan

    fns = {"ring": decode_attention.ring_decode_attention,
           "paged_ring": decode_attention.paged_ring_decode_attention}
    rows = {}
    for (kind, label, L, B, H, KV, hd, ring, window, dt, positions,
         short) in ring_cases():
        def rnd(*s):
            return torch.randn(*s, generator=gen, device="cuda").to(dt)
        dname = str(dt).split(".")[1]
        pos = torch.tensor(positions, dtype=torch.int32, device="cuda")
        q = rnd(B, H, hd)
        span = min(window, ring)
        if kind == "ring":
            kp, vp = rnd(L, B, ring, KV, hd), rnd(L, B, ring, KV, hd)
            bt = None

            def kern(j):
                return fns[kind](q, kp[j], vp[j], pos, window=window)

            def plain(j):
                return ref.ring_decode_attention_ref(q, kp[j], vp[j], pos,
                                                     window=window)

            def rows_of(j):
                return kp[j], vp[j]
        else:
            page = 64
            nblk = ring // page
            n_pages = B * nblk + 16
            perm = torch.randperm(n_pages, generator=torch.Generator(
            ).manual_seed(n_pages), dtype=torch.int32)
            bt = perm[:B * nblk].reshape(B, nblk).clone()
            for b in short:  # blocks this row never got: the sentinel
                bt[b, positions[b] // page + 1:] = n_pages
            bt = bt.cuda()
            kp, vp = (rnd(L, n_pages, page, KV, hd),
                      rnd(L, n_pages, page, KV, hd))

            def kern(j):
                return fns[kind](q, kp[j], vp[j], bt, pos, window=window)

            def plain(j):
                return ref.paged_ring_decode_attention_ref(
                    q, kp[j], vp[j], bt, pos, window=window)

            def rows_of(j):
                return (ref._paged_gather_ref(kp[j], bt),
                        ref._paged_gather_ref(vp[j], bt))
        got = kern(0)
        torch.cuda.synchronize()
        name = f"{kind}_decode_attention"
        err = check_close(f"{name} [{label}]", got, plain(0), dname)
        if not bool((got[pos < 0] == 0).all()):
            raise AssertionError(f"{name} [{label}]: done rows are not "
                                 "exact zeros")
        item = q.element_size()
        n_keys = sum(min(p + 1, span) for p in positions if p >= 0)
        b_ms, b_by = bound_ms(
            n_keys * KV * hd * 2 * item + 2 * B * H * hd * item + 4 * B
            + (0 if bt is None else 4 * bt.numel()),
            4 * n_keys * H * hd, dname)
        # library yardstick: each row's band gathered into position order
        # (span positions ending at pos; the ones before 0 masked)
        p_ord = pos[:, None].long() - span + 1 + torch.arange(
            span, device="cuda")[None]
        slot = p_ord.remainder(ring)
        mask = ((p_ord >= 0) & (pos[:, None] >= 0))[:, None, None]
        rows_b = torch.arange(B, device="cuda")[:, None]
        k_ord, v_ord = [], []
        for j in range(L):
            kd, vd = rows_of(j)
            k_ord.append(kd[rows_b, slot].transpose(1, 2).contiguous())
            v_ord.append(vd[rows_b, slot].transpose(1, 2).contiguous())
        layers = iter(range(10 ** 9))

        def cycled(f):
            def call():
                return f(next(layers) % L)
            return call

        case = dict(
            label=label, dtype=dname, max_abs_err=err,
            ms=time_ms(cycled(kern), 10 * L),
            plain_ms=time_ms(cycled(plain), 2 * L),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=time_ms(cycled(
                lambda j: F.scaled_dot_product_attention(
                    q[:, :, None], k_ord[j], v_ord[j], attn_mask=mask,
                    enable_gqa=H != KV)), 2 * L),
            shape=(f"q{tuple(q.shape)} "
                   + (f"ring{tuple(kp.shape[1:])}" if bt is None else
                      f"arena{tuple(kp.shape[1:])} bt{tuple(bt.shape)}")
                   + f" {dname} window {window} positions {positions}"))
        # the band's pieces: (positions, a cluster of)
        case["splits"] = decode_attention._paged_splits(name, q, KV, span)
        split = f", pieces {case['splits']}"
        print(f"{name} [{label}] {case['shape']}: max abs err {err:.3g}"
              f"{split}; kernel {case['ms']:.4f} ms, plain "
              f"{case['plain_ms']:.4f} ms, library {case['library_ms']:.4f} "
              f"ms, bound {b_ms:.4f} ms ({b_by})", flush=True)
        del k_ord, v_ord, kp, vp
        if name not in rows:
            rows[name] = dict(
                name=name, route="cuda",
                source=f"src/repro_torch/kernels/csrc/{name}.cu",
                replaces=("src/repro/kernels/decode_attention.py:546"
                          if kind == "ring" else
                          "src/repro/kernels/decode_attention.py:407"),
                cases=[], **{key: case[key] for key in (
                    "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "shape")})
        rows[name]["cases"].append(case)

    scan = rglru_scan.rglru_scan
    for label, B, S, W, dt, with_h0 in (
            ("recurrentgemma-2b admission f32", 8, 4096, 2560,
             torch.float32, True),
            ("ragged f32", 3, 2101, 2560, torch.float32, False),
            ("recurrentgemma-2b bf16", 8, 4096, 2560, torch.bfloat16, True),
            ("single admission f32", 1, 2048, 2560, torch.float32, True)):
        dname = str(dt).split(".")[1]
        a = (torch.rand(B, S, W, generator=gen, device="cuda") * 0.5
             + 0.5).to(dt)
        b = (0.1 * torch.randn(B, S, W, generator=gen, device="cuda")).to(dt)
        h0 = (torch.randn(B, W, generator=gen, device="cuda") if with_h0
              else None)
        got = scan(a, b, h0)
        torch.cuda.synchronize()
        want = ref.rglru_scan_ref(a, b, h0)
        err = check_close(f"rglru_scan [{label}]", got, want, dname)
        if dname == "float32" and not torch.equal(got, want):
            raise AssertionError(f"rglru_scan [{label}]: float32 differs "
                                 "from the plain version's step-by-step "
                                 f"rounding (max abs err {err:.3g})")
        item = a.element_size()
        b_ms, b_by = bound_ms(3 * B * S * W * item
                              + (0 if h0 is None else 4 * B * W),
                              2 * B * S * W, dname)
        case = dict(label=label, dtype=dname, max_abs_err=err,
                    ms=time_ms(lambda: scan(a, b, h0), 10),
                    plain_ms=time_ms(lambda: ref.rglru_scan_ref(a, b, h0), 2),
                    bound_ms=b_ms, bound_by=b_by, library_ms=None,
                    shape=f"a, b ({B}, {S}, {W}) {dname} h0 {with_h0}",
                    plan=rglru_scan.scan_plan(B, S, W, item, torch.cuda.
                                              get_device_properties(0).
                                              multi_processor_count))
        print(f"rglru_scan [{label}] {case['shape']}: max abs err "
              f"{err:.3g}, plan (steps, blocks) {case['plan']}; kernel "
              f"{case['ms']:.4f} ms, plain "
              f"{case['plain_ms']:.4f} ms, no library call, bound "
              f"{b_ms:.4f} ms ({b_by})", flush=True)
        del a, b, want, got
        if "rglru_scan" not in rows:
            rows["rglru_scan"] = dict(
                name="rglru_scan", route="cuda",
                source="src/repro_torch/kernels/csrc/rglru_scan.cu",
                replaces="src/repro/kernels/rglru_scan.py:41", cases=[],
                **{key: case[key] for key in (
                    "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "shape")})
        rows["rglru_scan"]["cases"].append(case)
    return rows


def timed_run(eng, reqs):
    """Serve fresh copies of ``reqs`` on ``eng`` between two device syncs.
    Returns (outputs, seconds, tokens/s, admissions refused for want of
    pages); fails if a request is missing or was rejected."""
    import dataclasses

    import torch

    waits = []  # admissions refused for want of pages (backpressure)
    alloc = eng._alloc_request

    def counted(req):
        info = alloc(req)
        waits.append(info is None)
        return info
    eng._alloc_request = counted
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        out = eng.run([dataclasses.replace(r) for r in reqs])
        torch.cuda.synchronize()
    finally:
        # the wrapper holds the engine: drop it, so the engine (and its
        # pool) is freed with the caller's last reference
        del eng._alloc_request
    dt = time.perf_counter() - t0
    if set(out) != {r.uid for r in reqs} or eng.rejected:
        raise AssertionError(f"requests missing or rejected: {eng.rejected}")
    return out, dt, sum(len(v) for v in out.values()) / dt, sum(waits)


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
    path = ("flash_attention", "slot_decode_attention")
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
    if launches["tr_sandwich"] or launches["decode_attention"]:
        raise AssertionError("the engine launched the growth kernel or the "
                             "scalar decode kernel")
    print(f"served {len(out)} requests / {n_tok} tokens in {dt:.3f} s: "
          f"{n_tok / dt:.1f} tok/s, {eng.n_host_syncs / n_tok:.4f} host "
          f"syncs/token ({eng.n_host_syncs} syncs, "
          f"{eng.n_decode_dispatches} macro-steps, {eng.n_prefills} "
          f"prefill batches), peak memory {peak / 2**20:.1f} MiB; "
          f"kernel launches {launches}", flush=True)
    for name in path:
        if launches[name] == 0:
            raise AssertionError(f"{name} was never launched on the serving "
                                 "path")
        kernel_rows[name]["launches"] = launches[name]
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
    gen_launches = []
    for r in reqs:
        got = out[r.uid]
        if got.shape != (64,) or got.min() < 0 or got.max() >= cfg.vocab_size:
            raise AssertionError(f"uid {r.uid}: bad output {got}")
        for fn in kern.values():
            fn.launches = 0
        gen = generate(cfg, params, torch.from_numpy(r.prompt)[None].cuda(),
                       max_new_tokens=64, max_len=1024)[0].cpu().numpy()
        # the scalar decode route: one decode_attention launch per layer
        # and decode step, the flash kernel once per layer for the prompt
        want = {name: 0 for name in kern}
        want.update(decode_attention=cfg.n_layers * 63,
                    flash_attention=cfg.n_layers)
        got_l = {name: fn.launches for name, fn in kern.items()}
        if got_l != want:
            raise AssertionError(f"uid {r.uid}: generate launched {got_l}, "
                                 f"expected {want}")
        gen_launches.append(got_l["decode_attention"])
        for what, toks in (("engine", got), ("generate", gen)):
            tie = check_against_plain(what, r.uid, toks, *plain[r.uid])
            if tie is not None:
                near_ties[what].append(tie)
    exact = {what: len(reqs) - len(t) for what, t in near_ties.items()}
    print(f"tokens == plain route (full forward, no kernel; {plain_s:.1f} s) "
          f"for {exact['engine']}/{len(reqs)} requests from the engine and "
          f"{exact['generate']}/{len(reqs)} from generate; near-tie "
          f"divergences: {near_ties}; decode_attention launches per "
          f"generate call {sorted(set(gen_launches))} (12 x 63)", flush=True)
    report = dict(tok_per_s=n_tok / dt, seconds=dt, tokens=n_tok,
                  host_syncs_per_token=eng.n_host_syncs / n_tok,
                  peak_mib=peak / 2**20, launches=launches,
                  generate_decode_attention_launches=gen_launches,
                  exact_requests=exact, near_ties=near_ties)
    report["profile"] = profile_serve(engine, reqs, dt)
    return report


def device_busy_and_top(dev, n_top):
    """Device busy time (us; the union of the device events' intervals)
    and the ``n_top`` device ops by summed time: [(name, (calls, us))]."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy, end = 0.0, float("-inf")
    for s0, s1 in spans:
        busy += max(0.0, s1 - max(s0, end))
        end = max(end, s1)
    by_name = {}
    for e in dev:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us())
    return busy, sorted(by_name.items(), key=lambda kv: -kv[1][1])[:n_top]


# the paged-decode body's instances by their template arguments (band kind
# 0 slot, 1 ring, 2 verify; row address true dense, false paged).  The
# dense SLOT instance also runs decode_attention, which no engine launches
PDEC_KERNELS = {("0", "true"): "slot_decode_attention",
                ("0", "false"): "paged_slot_decode_attention",
                ("1", "true"): "ring_decode_attention",
                ("1", "false"): "paged_ring_decode_attention",
                ("2", "true"): "chunk_verify_attention",
                ("2", "false"): "paged_chunk_verify_attention"}


def port_kernel_ms(dev):
    """{kernel: (launches, ms)}: the traced device time of the port's own
    kernels among the device events ``dev``, by kernel."""
    import re

    out = {}
    for e in dev:
        m = re.search(r"paged_decode_kernel<[^,]+, \d+, \d+, (\d), "
                      r"(true|false)>", e.name)
        if m:
            name = PDEC_KERNELS[m.groups()]
        else:
            name = next((k for k in ("rglru_scan", "flash_attention")
                         if k.split("_")[0] in e.name), None)
            if name is None:
                continue
        n, t = out.get(name, (0, 0.0))
        out[name] = (n + 1, t + e.time_range.elapsed_us() / 1e3)
    return out


def profile_step(label, fn):
    """One call of ``fn`` under torch.profiler: device busy time, idle
    share of the traced wall time, and the 8 device ops that take most of
    it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy, top = device_busy_and_top(dev, 8)
    report = dict(traced_wall_ms=wall * 1e3, device_busy_ms=busy / 1e3,
                  device_idle_share_traced=1 - busy / 1e6 / wall,
                  device_ops=len(dev),
                  top_device_ops=[dict(name=n[:90], calls=c, ms=t / 1e3)
                                  for n, (c, t) in top])
    print(f"profile {label}: device busy {busy / 1e3:.1f} ms of the traced "
          f"{wall * 1e3:.1f} ms (idle share "
          f"{report['device_idle_share_traced']:.3f}), {len(dev)} device "
          "ops", flush=True)
    for r in report["top_device_ops"]:
        print(f"profile {label} device op {r['ms']:8.3f} ms {r['calls']:5d}x "
              f"{r['name']}", flush=True)
    return out, report


def profile_serve(make_engine, reqs, untraced_wall,
                  stages=("_admit_group", "_dispatch", "_process")):
    """A second, traced run of the same requests under torch.profiler:
    device busy time, host time per engine stage (``stages``, engine
    methods), and the kernels that take the device time.  Tracing slows
    the host, so the idle share is given against both the traced wall
    time and the untraced run's.  ``decode_steps`` counts K per dispatch:
    decode steps, or speculative blocks.  With no ``stages`` only the
    device is traced: the host's events are what makes reading a trace of
    a quarter million device ops take minutes."""
    import dataclasses

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    eng = make_engine()
    for name in stages:
        def ranged(*a, _fn=getattr(eng, name), _tag=f"engine{name}", **kw):
            with record_function(_tag):
                return _fn(*a, **kw)
        setattr(eng, name, ranged)
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA]
    if stages:
        activities.append(ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
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
    if not dev:
        raise AssertionError("the traced run holds no device op")
    busy, top = device_busy_and_top(dev, 12)
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
                        for n, (c, t) in top],
        port_kernels={k: dict(calls=c, ms=t) for k, (c, t) in
                      sorted(port_kernel_ms(dev).items())})
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
    for k, v in report["port_kernels"].items():
        print(f"profile traced kernel {k}: {v['ms']:.3f} ms in {v['calls']} "
              "launches", flush=True)
    return report


def slot_cuts_traced(make_engine, reqs, untraced_wall, report):
    """The dense slot's traced time with each cut of its bands: the
    device's or the host's (``SLOT_CUT_ON_DEVICE``).  ``report`` is the
    traced run with the wrapper's choice; a second, device-only traced run
    takes the other cut."""
    from repro_torch.kernels import decode_attention

    chosen = decode_attention.SLOT_CUT_ON_DEVICE
    decode_attention.SLOT_CUT_ON_DEVICE = not chosen
    try:
        other = profile_serve(make_engine, reqs, untraced_wall, stages=())
    finally:
        decode_attention.SLOT_CUT_ON_DEVICE = chosen

    def slot_ms(r):
        return r["port_kernels"].get("slot_decode_attention",
                                     {"ms": 0.0})["ms"]
    cuts = {("device" if chosen else "host"): slot_ms(report),
            ("host" if chosen else "device"): slot_ms(other)}
    print(f"traced dense slot: bands cut on the device {cuts['device']:.3f} "
          f"ms, on the host {cuts['host']:.3f} ms (the wrapper cuts on the "
          f"{'device' if chosen else 'host'})", flush=True)
    return cuts


GROW_DATA_VOCAB = 1024  # phase 5's chain runs over the first 1024 token ids
GROW_BATCH, GROW_SEQ = 8, 256


def _synced_ms(t0):
    import torch

    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def run_grow(kernel_rows):
    """Phase 5: the paper's loop at full width, gpt-small -> gpt-base.

    The synthetic chain draws its tokens from the first 1024 ids of the
    50257-word vocabulary, so that a few tens of pretraining steps teach
    gpt-small something growth can carry over (over the full vocabulary
    each id would be seen about once)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import grow as growlib
    from repro_torch.core import mango, packing
    from repro_torch.data import lm_batch, lm_data_iter
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.serve import build_params
    from repro_torch.optim import OptimizerConfig, make_optimizer
    from repro_torch.serve import ContinuousBatchingEngine, Request
    from repro_torch.train.steps import (
        make_eval_step,
        make_grow_step,
        make_train_step,
    )

    cfg_s, cfg_t = get_config("gpt-small"), get_config("gpt-base")
    tokens_per_step = GROW_BATCH * GROW_SEQ

    def data(seed):
        for b in lm_data_iter(GROW_DATA_VOCAB, GROW_BATCH, GROW_SEQ,
                              seed=seed):
            yield {k: torch.from_numpy(v).cuda() for k, v in b.items()}

    kern = ops.kernels()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in kern.values():
        fn.launches = 0
    report = {}

    # 1. pretrain the source
    small = build_params(cfg_s, seed=0, device="cuda")
    opt = OptimizerConfig(lr=1e-3)
    init_fn, _ = make_optimizer(opt)
    state, step = init_fn(small), make_train_step(cfg_s, opt)
    it = data(seed=0)
    n_pre = 40
    small, state, m = step(small, state, next(it), 1)  # first-use costs
    t0 = time.perf_counter()
    for s_ in range(1, n_pre):
        small, state, m = step(small, state, next(it), s_ + 1)
    report["pretrain_ms_per_step"] = _synced_ms(t0) / (n_pre - 1)
    report["pretrain_final_loss"] = float(m["loss"])
    print(f"pretrain gpt-small: {n_pre} steps of {GROW_BATCH}x{GROW_SEQ} "
          f"tokens, loss {report['pretrain_final_loss']:.4f}, "
          f"{report['pretrain_ms_per_step']:.1f} ms/step", flush=True)

    # 2. operator training (Eq. 7), the sandwich launching every step
    gen = torch.Generator(device="cuda").manual_seed(0)
    gop, op_params = growlib.build("mango", cfg_s, cfg_t, rank=1, gen=gen)
    dims = gop.op.dims("dense_blocks")
    gstep = make_grow_step(gop, cfg_t, OptimizerConfig(lr=1e-3))
    ostate = make_optimizer(OptimizerConfig(lr=1e-3))[0](op_params)
    it = data(seed=3)
    n_op, losses, step_ms = 10, [], []
    for s_ in range(n_op):
        before = kern["tr_sandwich"].launches
        t0 = time.perf_counter()
        op_params, ostate, m = gstep(op_params, ostate, small, next(it),
                                     s_ + 1)
        step_ms.append(_synced_ms(t0))
        if kern["tr_sandwich"].launches == before:
            raise AssertionError(f"operator step {s_} did not launch the "
                                 "tr_sandwich kernel")
        losses.append(float(m["loss"]))
    if not all(np.isfinite(losses)):
        raise AssertionError(f"operator training loss not finite: {losses}")
    report["operator_ms_per_step"] = float(np.mean(step_ms[1:]))
    report["operator_losses"] = losses
    print(f"operator training (rank-1 Mango, {dims}): {n_op} steps, loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}, "
          f"{report['operator_ms_per_step']:.1f} ms/step after the first "
          f"({step_ms[0]:.1f} ms)", flush=True)
    (op_params, ostate, _), report["operator_step_profile"] = profile_step(
        "operator step", lambda: gstep(op_params, ostate, small, next(it),
                                       n_op + 1))

    # 3. grow, and hold the contraction against the one-einsum reference
    with torch.no_grad():
        t0 = time.perf_counter()
        big = growlib.grow_params(gop, op_params, small)
        report["grow_params_ms"] = _synced_ms(t0)
        g = gop.op.plan_src.groups[0]
        M1 = packing.pack_group(g, small[g.name], cfg_s.d_model)
        cores = op_params["groups"][g.name]
        got = mango.contract(M1, cores)
        want = mango.contract_reference(M1, cores)
        rel = float((got - want).abs().max() / want.abs().max())
    # f32 on both sides, the same products summed in other orders: within
    # 1e-5 of the largest entry
    if not rel <= 1e-5:
        raise AssertionError(f"contract (sandwich route) disagrees with "
                             f"contract_reference: max err {rel:.3g} of "
                             "the largest entry > 1e-5")
    report["contract_max_rel_err"] = rel
    print(f"grow_params {report['grow_params_ms']:.1f} ms; contract vs "
          f"contract_reference on M2{tuple(got.shape)}: max err {rel:.3g} "
          "of the largest entry (limit 1e-5)", flush=True)
    del got, want, M1

    # 4. grown vs scratch on a held-out batch
    ev = make_eval_step(cfg_t)
    held = next(data(seed=50))
    scratch = build_params(cfg_t, seed=99, device="cuda")
    l_grown, l_scratch = (float(ev(p, held)["loss"]) for p in (big, scratch))
    del scratch
    report.update(grown_loss=l_grown, scratch_loss=l_scratch,
                  margin=l_scratch - l_grown)
    print(f"held-out loss of gpt-base: grown {l_grown:.4f}, scratch "
          f"{l_scratch:.4f}, margin {l_scratch - l_grown:.4f}", flush=True)
    if not l_grown < l_scratch:
        raise AssertionError("the grown gpt-base does not start below the "
                             "scratch one")

    # 5. train the grown model
    tstate, tstep = init_fn(big), make_train_step(cfg_t, opt)
    it = data(seed=1)
    big, tstate, m = tstep(big, tstate, next(it), 1)
    n_tr, tr_losses = 5, [float(m["loss"])]
    t0 = time.perf_counter()
    for s_ in range(1, n_tr + 1):
        big, tstate, m = tstep(big, tstate, next(it), s_ + 1)
        tr_losses.append(float(m["loss"]))
    ms = _synced_ms(t0) / n_tr
    if not all(np.isfinite(tr_losses)):
        raise AssertionError(f"grown-model training loss not finite: "
                             f"{tr_losses}")
    report.update(train_ms_per_step=ms, train_tok_per_s=tokens_per_step
                  / ms * 1e3, train_losses=tr_losses)
    print(f"train grown gpt-base: {n_tr + 1} steps, loss {tr_losses[0]:.4f} "
          f"-> {tr_losses[-1]:.4f}, {ms:.1f} ms/step, "
          f"{report['train_tok_per_s']:.0f} tokens/s", flush=True)
    (big, tstate, _), report["train_step_profile"] = profile_step(
        "train step", lambda: tstep(big, tstate, next(it), n_tr + 2))

    # 6. serve the grown model
    reqs = [Request(uid=i, prompt=lm_batch(GROW_DATA_VOCAB, 1, 24 + 8 * i,
                                           seed=200 + i)[0],
                    max_new_tokens=32) for i in range(4)]
    out = ContinuousBatchingEngine(cfg_t, big, capacity=4, max_len=128,
                                   k=8).run(reqs)
    ties = []
    for r in reqs:
        toks, gaps = plain_greedy(cfg_t, big, r.prompt, 32)
        tie = check_against_plain("engine", r.uid, out[r.uid], toks, gaps)
        if tie is not None:
            ties.append(tie)
    report["serve_near_ties"] = ties
    print(f"served 4 requests x 32 tokens of the grown gpt-base: "
          f"{4 - len(ties)}/4 equal to the plain route, near ties {ties}",
          flush=True)

    # 7. the train launcher, grown from gpt-small
    hist_path = ROOT / "build" / "grow_train_history.json"
    hist_path.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    launch_train.main(["--arch", "gpt-base", "--grow-from", "gpt-small",
                       "--grow-steps", "2", "--steps", "3",
                       "--history-out", str(hist_path)])
    report["launcher_s"] = _synced_ms(t0) / 1e3
    hist = json.loads(hist_path.read_text())
    if not hist or not all(np.isfinite(h["loss"]) for h in hist):
        raise AssertionError(f"launcher losses not finite: {hist}")
    print(f"launch.train --arch gpt-base --grow-from gpt-small: "
          f"{report['launcher_s']:.1f} s, losses "
          f"{[round(h['loss'], 4) for h in hist]}", flush=True)

    launches = {name: fn.launches for name, fn in kern.items()}
    report.update(launches=launches,
                  peak_mib=torch.cuda.max_memory_allocated() / 2**20)
    print(f"grow path: kernel launches {launches}, peak memory "
          f"{report['peak_mib']:.1f} MiB", flush=True)
    for name in ("flash_attention", "slot_decode_attention", "tr_sandwich"):
        if launches[name] == 0:
            raise AssertionError(f"{name} was never launched on the growth "
                                 "path")
    kernel_rows["tr_sandwich"]["launches"] = launches["tr_sandwich"]
    return report, small, big


SPEC_D, SPEC_K = 4, 2


def spec_groups(eng):
    """Admission groups of a speculative engine: it counts two prefills a
    group (the target's and the draft's), as the reference does."""
    groups, odd = divmod(eng.n_prefills, 2)
    if odd:
        raise AssertionError(f"a speculative engine counted {eng.n_prefills} "
                             "prefills, not two an admission group")
    return groups


def run_speculative(kernel_rows, small, big):
    """Phase 6: the grown gpt-base (phase 5's ``big``) served by the
    speculative engine with the pretrained gpt-small (``small``) drafting,
    beside the plain engine on the same requests (plain, speculative,
    speculative, plain); then gpt-base drafting for itself."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import lm_batch
    from repro_torch.kernels import ops
    from repro_torch.serve import (
        ContinuousBatchingEngine,
        Request,
        SpeculativeConfig,
    )

    cfg_s, cfg_t = get_config("gpt-small"), get_config("gpt-base")
    rng = np.random.default_rng(6)
    reqs = [Request(uid=i, prompt=lm_batch(GROW_DATA_VOCAB, 1,
                                           int(rng.integers(64, 449)),
                                           seed=300 + i)[0],
                    max_new_tokens=64) for i in range(16)]

    def engine(draft_cfg=None, draft=None):
        spec = None if draft is None else SpeculativeConfig(
            draft_cfg, draft, d=SPEC_D)
        k = 8 if spec is None else SPEC_K
        return ContinuousBatchingEngine(cfg_t, big, capacity=8, max_len=1024,
                                        k=k, speculative=spec)

    for warm in (engine(), engine(cfg_s, small)):  # first-use costs
        warm.run([Request(uid=0, prompt=reqs[0].prompt, max_new_tokens=9)])
    kern = ops.kernels()
    plain_a, _, tps_plain_a, _ = timed_run(engine(), reqs)
    torch.cuda.reset_peak_memory_stats()
    for fn in kern.values():
        fn.launches = 0
    eng = engine(cfg_s, small)
    out, dt, tps_spec, _ = timed_run(eng, reqs)
    launches = {name: fn.launches for name, fn in kern.items()}
    peak = torch.cuda.max_memory_allocated()
    _, _, tps_spec_b, _ = timed_run(engine(cfg_s, small), reqs)
    _, _, tps_plain_b, _ = timed_run(engine(), reqs)
    n_tok = sum(len(v) for v in out.values())
    blocks = SPEC_K * eng.n_decode_dispatches
    groups = spec_groups(eng)
    want = {name: 0 for name in kern}
    want.update(
        chunk_verify_attention=(cfg_t.n_layers + cfg_s.n_layers) * blocks,
        slot_decode_attention=cfg_s.n_layers * SPEC_D * blocks,
        flash_attention=(cfg_t.n_layers + cfg_s.n_layers) * groups)
    if launches != want or eng.n_spec_fallbacks:
        raise AssertionError(f"speculative path launched {launches}, "
                             f"expected {want} ({eng.n_decode_dispatches} "
                             f"dispatches of {SPEC_K} blocks, "
                             f"{groups} admission groups, "
                             f"{eng.n_spec_fallbacks} fallbacks)")
    kernel_rows["chunk_verify_attention"]["launches"] = launches[
        "chunk_verify_attention"]
    decode_tokens = n_tok - len(reqs)  # the first token comes from prefill
    report = dict(
        tok_per_s=tps_spec, tok_per_s_second_run=tps_spec_b,
        plain_engine_tok_per_s=[tps_plain_a, tps_plain_b], seconds=dt,
        tokens=n_tok, acceptance_rate=eng.acceptance_rate,
        n_spec_proposed=eng.n_spec_proposed,
        n_spec_accepted=eng.n_spec_accepted,
        tokens_per_target_verify=decode_tokens / blocks,
        host_syncs_per_token=eng.n_host_syncs / n_tok,
        peak_mib=peak / 2**20, launches=launches)
    print(f"speculative: {len(out)} requests / {n_tok} tokens in {dt:.3f} s: "
          f"{tps_spec:.1f} tok/s (second run {tps_spec_b:.1f}); plain engine "
          f"(K 8) {tps_plain_a:.1f} and {tps_plain_b:.1f} tok/s; acceptance "
          f"{eng.acceptance_rate:.4f} ({eng.n_spec_accepted}/"
          f"{eng.n_spec_proposed}), {report['tokens_per_target_verify']:.2f} "
          f"tokens per target verify ({blocks} verifies of 8 slots), "
          f"{report['host_syncs_per_token']:.4f} host syncs/token, peak "
          f"memory {peak / 2**20:.1f} MiB; kernel launches {launches}",
          flush=True)

    # the reference is the plain route alone (no kernel of the port)
    before = {name: fn.launches for name, fn in kern.items()}
    plain = {r.uid: plain_greedy(cfg_t, big, r.prompt, 64) for r in reqs}
    if {name: fn.launches for name, fn in kern.items()} != before:
        raise AssertionError("the plain reference launched a CUDA kernel")
    ties = {"speculative": [], "plain engine": []}
    for r in reqs:
        for what, toks in (("speculative", out[r.uid]),
                           ("plain engine", plain_a[r.uid])):
            if toks.shape != (64,):
                raise AssertionError(f"uid {r.uid}: bad {what} output {toks}")
            tie = check_against_plain(what, r.uid, toks, *plain[r.uid])
            if tie is not None:
                ties[what].append(tie)
    report["near_ties"] = ties
    # how peaked the target's next-token choice is: the draft can only
    # agree with a top-1 that stands out from the rest
    gaps = np.concatenate([plain[r.uid][1] for r in reqs])
    report["plain_top2_gap"] = dict(
        median=float(np.median(gaps)), p10=float(np.quantile(gaps, 0.1)),
        p90=float(np.quantile(gaps, 0.9)))
    print(f"plain route top-2 logit gap over {gaps.size} steps: median "
          f"{np.median(gaps):.4g}, 10th percentile "
          f"{np.quantile(gaps, 0.1):.4g}, 90th {np.quantile(gaps, 0.9):.4g}",
          flush=True)
    print(f"tokens == plain route for "
          f"{len(reqs) - len(ties['speculative'])}/{len(reqs)} requests "
          f"(speculative) and {len(reqs) - len(ties['plain engine'])}/"
          f"{len(reqs)} (plain engine); near ties {ties}", flush=True)

    # device only: the host's events of ~240,000 device ops take minutes
    # to read
    report["profile"] = profile_serve(lambda: engine(cfg_s, small), reqs,
                                      dt, stages=())
    report["dense_slot_traced_ms"] = slot_cuts_traced(
        lambda: engine(cfg_s, small), reqs, dt, report["profile"])

    # the grown gpt-base drafting for itself: every proposal is the
    # target's own argmax up to the two kernels' arithmetic, so each
    # rejection (at most one per step) must sit at a near tie
    self_reqs = reqs[:4]
    self_eng = engine(cfg_t, big)
    self_out = self_eng.run([dataclasses.replace(r) for r in self_reqs])
    rejected = self_eng.n_spec_proposed - self_eng.n_spec_accepted
    n_ties = sum(int((plain[r.uid][1] < NEAR_TIE).sum()) for r in self_reqs)
    for r in self_reqs:
        check_against_plain("self-draft", r.uid, self_out[r.uid],
                            *plain[r.uid])
    report["self_draft"] = dict(acceptance_rate=self_eng.acceptance_rate,
                                rejected=rejected, near_tie_steps=n_ties)
    print(f"self-draft (gpt-base drafts for itself, 4 requests): acceptance "
          f"{self_eng.acceptance_rate:.4f} ({self_eng.n_spec_accepted}/"
          f"{self_eng.n_spec_proposed}), {rejected} rejections, {n_ties} "
          f"plain near-tie steps", flush=True)
    if rejected > n_ties:
        raise AssertionError(f"self-draft rejected {rejected} proposals but "
                             f"the plain route has only {n_ties} near-tie "
                             "steps: a rejection away from a near tie")
    return report, reqs, plain


PAGED_PAGES = 48  # phase 7's arena: 3/8 of the dense pool's 128 pages
SPEC_PAGES = 64  # phase 8's arena, shared by target and draft


def paged_requests(vocab):
    """Phase 7's 16 requests, 64 new tokens each: 12 open with the same
    256-token prefix (4 full pages of 64) and add 16..192 tokens of their
    own, 4 have prompts of their own (64..448 tokens).  A prefix hit needs
    every full page before the prompt's last token resident, so only the
    four with at most 64 own tokens can hit; they come last, after the
    first waves have registered the prefix."""
    import numpy as np

    from repro_torch.data import lm_batch
    from repro_torch.serve import Request

    rng = np.random.default_rng(7)
    prefix = lm_batch(vocab, 1, 256, seed=500)[0]
    own = [int(n) for n in np.linspace(16, 192, 12)]
    shared = [np.concatenate([prefix, lm_batch(vocab, 1, n, seed=510 + i)[0]])
              for i, n in enumerate(own)]
    solo = [lm_batch(vocab, 1, int(rng.integers(64, 449)), seed=530 + i)[0]
            for i in range(4)]
    long_first = shared[4:] + solo
    order = [long_first[i] for i in rng.permutation(len(long_first))]
    return [Request(uid=i, prompt=p, max_new_tokens=64)
            for i, p in enumerate(order + shared[:4])]


def _pool_bytes(pool):
    return sum(t.numel() * t.element_size() for t in _leaves(pool))


def check_same_tokens(what, uid, got, want, gaps):
    """Two routes' tokens must be equal, except from a step where the
    plain route's top-2 gap is a near tie (reported)."""
    import numpy as np

    diff = np.nonzero(got != want)[0]
    if diff.size == 0:
        return None
    t = int(diff[0])
    if gaps[t] >= NEAR_TIE:
        raise AssertionError(f"uid {uid}: {what} diverge at step {t} where "
                             f"the plain top-2 gap is {gaps[t]:.3g}")
    print(f"near tie: uid {uid} {what} diverge at step {t}", flush=True)
    return (uid, t, float(gaps[t]))


def run_paged_serve(kernel_rows):
    """Phase 7: phase 4's gpt-base served from a paged pool of
    PAGED_PAGES pages (prefix sharing, page backpressure) beside the dense
    pool on the same requests (dense, paged, paged, dense)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import build_params
    from repro_torch.serve import ContinuousBatchingEngine, Request

    cfg = get_config("gpt-base")
    params = build_params(cfg, seed=0, device="cuda")
    reqs = paged_requests(cfg.vocab_size)

    def engine(pool):
        return ContinuousBatchingEngine(
            cfg, params, capacity=8, max_len=1024, k=8, pool=pool,
            pages=PAGED_PAGES if pool == "paged" else None)

    for pool in ("dense", "paged"):  # first-use costs
        engine(pool).run([Request(uid=0, prompt=reqs[0].prompt,
                                  max_new_tokens=9)])
    kern = ops.kernels()
    gc.collect()  # no earlier phase's garbage in the peaks below
    held = torch.cuda.memory_allocated()  # params of phases 5 and 7
    torch.cuda.reset_peak_memory_stats()
    dense_a, _, tps_dense_a, _ = timed_run(engine("dense"), reqs)
    peak_dense = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for fn in kern.values():
        fn.launches = 0
    eng = engine("paged")
    out, dt, tps_paged, waits = timed_run(eng, reqs)
    launches = {name: fn.launches for name, fn in kern.items()}
    peak = torch.cuda.max_memory_allocated()
    _, _, tps_paged_b, _ = timed_run(engine("paged"), reqs)
    _, _, tps_dense_b, _ = timed_run(engine("dense"), reqs)
    n_tok = sum(len(v) for v in out.values())
    steps = eng.k * eng.n_decode_dispatches + eng.n_prefix_tail_steps
    want = {name: 0 for name in kern}
    want.update(paged_slot_decode_attention=cfg.n_layers * steps,
                flash_attention=cfg.n_layers * eng.n_prefills)
    if launches != want:
        raise AssertionError(f"paged path launched {launches}, expected "
                             f"{want} ({steps} decode steps, "
                             f"{eng.n_prefills} admission groups)")
    if eng.n_prefix_hits == 0 or eng.pages_in_use != 0 or not waits:
        raise AssertionError(
            f"prefix hits {eng.n_prefix_hits}, pages in use at the end "
            f"{eng.pages_in_use}, admissions refused for pages {waits}")
    kernel_rows["paged_slot_decode_attention"]["launches"] = launches[
        "paged_slot_decode_attention"]
    dense_eng = engine("dense")
    report = dict(
        tok_per_s=[tps_paged, tps_paged_b],
        dense_tok_per_s=[tps_dense_a, tps_dense_b], seconds=dt,
        tokens=n_tok, pages_budget=eng.pages_budget,
        pages_highwater=eng.pages_highwater,
        n_prefix_hits=eng.n_prefix_hits, n_prefix_misses=eng.n_prefix_misses,
        n_prefix_stalls=eng.n_prefix_stalls,
        prefix_hit_rate=eng.prefix_hit_rate,
        n_pages_allocated=eng.n_pages_allocated,
        admissions_refused_for_pages=waits,
        prefix_tail_steps=eng.n_prefix_tail_steps,
        decode_steps=eng.k * eng.n_decode_dispatches,
        n_prefills=eng.n_prefills,
        pool_bytes=_pool_bytes(eng.pool),
        dense_pool_bytes=_pool_bytes(dense_eng.pool),
        host_syncs_per_token=eng.n_host_syncs / n_tok,
        peak_mib=peak / 2**20, dense_peak_mib=peak_dense / 2**20,
        held_before_mib=held / 2**20, launches=launches)
    del dense_eng
    print(f"paged: {len(out)} requests / {n_tok} tokens in {dt:.3f} s: "
          f"{tps_paged:.1f} tok/s (second run {tps_paged_b:.1f}); dense "
          f"pool {tps_dense_a:.1f} and {tps_dense_b:.1f} tok/s; prefix hits "
          f"{eng.n_prefix_hits}, misses {eng.n_prefix_misses}, stalls "
          f"{eng.n_prefix_stalls} (hit rate {eng.prefix_hit_rate:.3f}); "
          f"admissions refused for pages {waits}; pages {eng.pages_budget} "
          f"budget, {eng.pages_highwater} high-water, "
          f"{eng.n_pages_allocated} allocated; pool "
          f"{report['pool_bytes'] / 2**20:.1f} MiB paged vs "
          f"{report['dense_pool_bytes'] / 2**20:.1f} MiB dense; "
          f"{eng.n_host_syncs / n_tok:.4f} host syncs/token "
          f"({eng.n_host_syncs} syncs, {eng.n_decode_dispatches} "
          f"macro-steps, {eng.n_prefills} prefill groups); "
          f"{eng.n_prefix_tail_steps} hit tail steps beside "
          f"{report['decode_steps']} macro decode steps; peak memory "
          f"{peak / 2**20:.1f} MiB paged vs {peak_dense / 2**20:.1f} MiB "
          f"dense ({held / 2**20:.1f} MiB held before either run); kernel "
          f"launches {launches}", flush=True)

    before = {name: fn.launches for name, fn in kern.items()}
    plain = {r.uid: plain_greedy(cfg, params, r.prompt, 64) for r in reqs}
    if {name: fn.launches for name, fn in kern.items()} != before:
        raise AssertionError("the plain reference launched a CUDA kernel")
    ties = {"paged": [], "dense": [], "paged vs dense": []}
    for r in reqs:
        for what, toks in (("paged", out[r.uid]), ("dense", dense_a[r.uid])):
            if toks.shape != (64,):
                raise AssertionError(f"uid {r.uid}: bad {what} output {toks}")
            tie = check_against_plain(what, r.uid, toks, *plain[r.uid])
            if tie is not None:
                ties[what].append(tie)
        tie = check_same_tokens("paged and dense engines", r.uid, out[r.uid],
                                dense_a[r.uid], plain[r.uid][1])
        if tie is not None:
            ties["paged vs dense"].append(tie)
    report["near_ties"] = ties
    print(f"tokens == plain route for {len(reqs) - len(ties['paged'])}/"
          f"{len(reqs)} requests (paged), "
          f"{len(reqs) - len(ties['dense'])}/{len(reqs)} (dense); paged == "
          f"dense for {len(reqs) - len(ties['paged vs dense'])}/{len(reqs)}; "
          f"near ties {ties}", flush=True)
    report["profile"] = profile_serve(
        lambda: engine("paged"), reqs, dt,
        stages=("_admit_group", "_admit_hits", "_dispatch", "_process"))
    return report


def run_paged_speculative(kernel_rows, small, big, reqs, plain):
    """Phase 8: phase 6's pair and requests, both pools on ONE arena of
    SPEC_PAGES pages, beside the dense speculative engine (dense, paged,
    paged, dense); tokens against phase 6's plain route."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.serve import (
        ContinuousBatchingEngine,
        Request,
        SpeculativeConfig,
    )

    cfg_s, cfg_t = get_config("gpt-small"), get_config("gpt-base")

    def engine(pool):
        return ContinuousBatchingEngine(
            cfg_t, big, capacity=8, max_len=1024, k=SPEC_K, pool=pool,
            pages=SPEC_PAGES if pool == "paged" else None,
            speculative=SpeculativeConfig(cfg_s, small, d=SPEC_D))

    engine("paged").run([Request(uid=0, prompt=reqs[0].prompt,
                                 max_new_tokens=9)])  # first-use costs
    kern = ops.kernels()
    gc.collect()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    dense_eng = engine("dense")
    _, _, tps_dense_a, _ = timed_run(dense_eng, reqs)
    peak_dense = torch.cuda.max_memory_allocated()
    dense_acceptance = dense_eng.acceptance_rate
    del dense_eng  # its pools must not count in the paged run's peak
    torch.cuda.reset_peak_memory_stats()
    for fn in kern.values():
        fn.launches = 0
    eng = engine("paged")
    out, dt, tps_paged, _ = timed_run(eng, reqs)
    launches = {name: fn.launches for name, fn in kern.items()}
    peak = torch.cuda.max_memory_allocated()
    _, _, tps_paged_b, _ = timed_run(engine("paged"), reqs)
    _, _, tps_dense_b, _ = timed_run(engine("dense"), reqs)
    n_tok = sum(len(v) for v in out.values())
    blocks = SPEC_K * eng.n_decode_dispatches
    groups = spec_groups(eng)
    want = {name: 0 for name in kern}
    want.update(
        paged_chunk_verify_attention=(cfg_t.n_layers + cfg_s.n_layers)
        * blocks,
        paged_slot_decode_attention=cfg_s.n_layers * SPEC_D * blocks,
        flash_attention=(cfg_t.n_layers + cfg_s.n_layers) * groups)
    if launches != want or eng.n_spec_fallbacks or eng.pages_in_use:
        raise AssertionError(f"paged speculative path launched {launches}, "
                             f"expected {want} ({eng.n_decode_dispatches} "
                             f"dispatches of {SPEC_K} blocks, "
                             f"{groups} admission groups, "
                             f"{eng.n_spec_fallbacks} fallbacks, "
                             f"{eng.pages_in_use} pages left in use)")
    kernel_rows["paged_chunk_verify_attention"]["launches"] = launches[
        "paged_chunk_verify_attention"]
    ties = []
    for r in reqs:
        if out[r.uid].shape != (64,):
            raise AssertionError(f"uid {r.uid}: bad output {out[r.uid]}")
        tie = check_against_plain("paged speculative", r.uid, out[r.uid],
                                  *plain[r.uid])
        if tie is not None:
            ties.append(tie)
    report = dict(
        tok_per_s=[tps_paged, tps_paged_b],
        dense_spec_tok_per_s=[tps_dense_a, tps_dense_b], seconds=dt,
        tokens=n_tok, acceptance_rate=eng.acceptance_rate,
        n_spec_proposed=eng.n_spec_proposed,
        n_spec_accepted=eng.n_spec_accepted,
        dense_acceptance_rate=dense_acceptance,
        pages_budget=eng.pages_budget, pages_highwater=eng.pages_highwater,
        host_syncs_per_token=eng.n_host_syncs / n_tok,
        peak_mib=peak / 2**20, dense_peak_mib=peak_dense / 2**20,
        held_before_mib=held / 2**20, launches=launches, near_ties=ties)
    print(f"paged speculative: {len(out)} requests / {n_tok} tokens in "
          f"{dt:.3f} s: {tps_paged:.1f} tok/s (second run {tps_paged_b:.1f});"
          f" dense speculative {tps_dense_a:.1f} and {tps_dense_b:.1f} tok/s;"
          f" acceptance {eng.acceptance_rate:.4f} ({eng.n_spec_accepted}/"
          f"{eng.n_spec_proposed}; dense {dense_acceptance:.4f}); "
          f"pages {eng.pages_budget} budget (target and draft), "
          f"{eng.pages_highwater} high-water; "
          f"{report['host_syncs_per_token']:.4f} host syncs/token; peak "
          f"memory {peak / 2**20:.1f} MiB paged vs {peak_dense / 2**20:.1f} "
          f"MiB dense ({held / 2**20:.1f} MiB held before either run); "
          f"kernel launches {launches}; "
          f"tokens == plain route for {len(reqs) - len(ties)}/{len(reqs)} "
          f"(near ties {ties})", flush=True)
    return report


GRIFFIN_PAGES = 160  # phase 10's arena: 5/8 of the dense rings' 256 pages
EMBED_SCALE = 0.05  # phase 9's tied embedding, scaled down (see below)


def griffin_model():
    """recurrentgemma-2b at full width and depth in float32 (so the routes'
    tokens can be compared exactly), weights from a seeded generator.  At
    the init's std (0.02) the scaled, tied embedding of the current token
    dominates the residual and greedy decoding repeats that token forever
    (a 3-layer CPU run of this config did); the embedding is scaled by
    EMBED_SCALE so the blocks decide the next token."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import build_params

    cfg = get_config("recurrentgemma-2b").replace(param_dtype="float32",
                                                 compute_dtype="float32")
    params = build_params(cfg, seed=0, device="cuda")
    params["embed"].mul_(EMBED_SCALE)
    return cfg, params


def griffin_requests(vocab):
    """Phase 9's 16 requests, 64 new tokens each, in a seeded order: 4
    prompts of 64..512 tokens (their rings never wrap), 4 of 1990..2040
    (they wrap during decode: ring = window = 2048) and 8 of 2100..2600
    (admission fills their rings by ``ring_fill_rows``)."""
    import numpy as np

    from repro_torch.data import lm_batch
    from repro_torch.serve import Request

    rng = np.random.default_rng(9)
    lens = ([int(n) for n in rng.integers(64, 513, 4)]
            + [int(n) for n in rng.integers(1990, 2041, 4)]
            + [int(n) for n in rng.integers(2100, 2601, 8)])
    lens = [lens[i] for i in rng.permutation(len(lens))]
    return [Request(uid=i, prompt=lm_batch(vocab, 1, n, seed=900 + i)[0],
                    max_new_tokens=64) for i, n in enumerate(lens)]


def griffin_plain_route(cfg, params, reqs, n_new):
    """Greedy tokens of the plain route: the scalar ``decode_step`` over
    all rows at one shared position from an empty cache, each row fed its
    prompt and then its own argmax.  It runs ``rglru_step`` and
    ``_ring_window_attend``: no kernel of the port.  Returns {uid:
    (tokens, top-2 gaps)}."""
    import numpy as np
    import torch

    from repro_torch.models import griffin

    B = len(reqs)
    plens = [len(r.prompt) for r in reqs]
    P = max(plens)
    prompts = torch.zeros(B, P, dtype=torch.int32)
    for b, r in enumerate(reqs):
        prompts[b, :plens[b]] = torch.from_numpy(r.prompt)
    prompts = prompts.cuda()
    pl = torch.tensor(plens, device="cuda")
    cache = griffin.init_cache(cfg, B, P + n_new, device="cuda")
    tok = prompts[:, 0]
    nxts, gaps = [], []
    for t in range(P + n_new - 1):
        logits, cache = griffin.decode_step(params, tok, t, cache, cfg)
        top = logits.float().topk(2, dim=-1).values
        nxt = logits.argmax(-1).to(torch.int32)
        nxts.append(nxt)
        gaps.append(top[:, 0] - top[:, 1])
        tok = torch.where(t + 1 < pl, prompts[:, min(t + 1, P - 1)], nxt)
    nxts = torch.stack(nxts).cpu().numpy()  # (steps, B)
    gaps = torch.stack(gaps).cpu().numpy()
    out = {}
    for b, r in enumerate(reqs):
        sl = slice(plens[b] - 1, plens[b] - 1 + n_new)
        out[r.uid] = (nxts[sl, b].astype(np.int32), gaps[sl, b])
    return out


def run_griffin_serve(kernel_rows):
    """Phase 9: recurrentgemma-2b through the continuous-batching engine
    on the dense pool, ``generate`` beside it, both against the plain
    route; then a traced run."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch.serve import generate
    from repro_torch.models import griffin
    from repro_torch.serve import ContinuousBatchingEngine, Request

    t0 = time.perf_counter()
    cfg, params = griffin_model()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    pat = griffin.block_pattern(cfg)
    n_rec, n_attn = pat.count("rec"), pat.count("attn")
    print(f"recurrentgemma-2b: {cfg.n_layers} layers ({n_rec} RG-LRU, "
          f"{n_attn} local MQA), d_model {cfg.d_model}, {cfg.n_heads} heads "
          f"over {cfg.n_kv_heads} KV head of {cfg.head_dim}, window "
          f"{cfg.window}, vocab {cfg.vocab_size}: {n_params} params (f32, "
          f"seeded torch.Generator, embedding x {EMBED_SCALE}; drawn in "
          f"{init_s:.1f} s)", flush=True)
    reqs = griffin_requests(cfg.vocab_size)

    def engine():
        return ContinuousBatchingEngine(cfg, params, capacity=8,
                                        max_len=4096, k=8)

    engine().run([Request(uid=0, prompt=reqs[0].prompt,
                          max_new_tokens=9)])  # first-use costs
    kern = ops.kernels()
    gc.collect()
    held = torch.cuda.memory_allocated()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in kern.values():
        fn.launches = 0
    eng = engine()
    out, dt, _, _ = timed_run(eng, reqs)
    launches = {name: fn.launches for name, fn in kern.items()}
    peak = torch.cuda.max_memory_allocated()
    n_tok = sum(len(v) for v in out.values())
    steps = eng.k * eng.n_decode_dispatches
    want = {name: 0 for name in kern}
    want.update(ring_decode_attention=n_attn * steps,
                rglru_scan=n_rec * eng.n_prefills)
    if launches != want:
        raise AssertionError(f"griffin path launched {launches}, expected "
                             f"{want} ({steps} decode steps, "
                             f"{eng.n_prefills} admission groups)")
    for name in ("ring_decode_attention", "rglru_scan"):
        kernel_rows[name]["launches"] = launches[name]
    pool_bytes = _pool_bytes(eng.pool)
    print(f"griffin dense: {len(out)} requests / {n_tok} tokens in {dt:.3f} "
          f"s: {n_tok / dt:.1f} tok/s, {eng.n_host_syncs / n_tok:.4f} host "
          f"syncs/token ({eng.n_host_syncs} syncs, {eng.n_decode_dispatches} "
          f"macro-steps, {eng.n_prefills} prefill groups); pool "
          f"{pool_bytes / 2**20:.1f} MiB; peak memory {peak / 2**20:.1f} MiB"
          f" ({(peak - held) / 2**20:.1f} MiB above the {held / 2**20:.1f} "
          f"MiB held); kernel launches {launches}", flush=True)

    before = {name: fn.launches for name, fn in kern.items()}
    t0 = time.perf_counter()
    plain = griffin_plain_route(cfg, params, reqs, 64)
    plain_s = time.perf_counter() - t0
    if {name: fn.launches for name, fn in kern.items()} != before:
        raise AssertionError("the plain route launched a CUDA kernel")
    ties = {"engine": [], "generate": []}
    distinct = set()
    t0 = time.perf_counter()
    for r in reqs:
        got = out[r.uid]
        if got.shape != (64,) or got.min() < 0 or got.max() >= cfg.vocab_size:
            raise AssertionError(f"uid {r.uid}: bad output {got}")
        distinct.update(int(t) for t in got)
        gen = generate(cfg, params, torch.from_numpy(r.prompt)[None].cuda(),
                       max_new_tokens=64, max_len=4096)[0].cpu().numpy()
        for what, toks in (("engine", got), ("generate", gen)):
            tie = check_against_plain(what, r.uid, toks, *plain[r.uid])
            if tie is not None:
                ties[what].append(tie)
    generate_s = time.perf_counter() - t0
    gaps = np.concatenate([plain[r.uid][1] for r in reqs])
    exact = {what: len(reqs) - len(t) for what, t in ties.items()}
    print(f"tokens == plain route (scalar decode_step over all rows, no "
          f"kernel; {plain_s:.1f} s) for {exact['engine']}/{len(reqs)} "
          f"requests from the engine and {exact['generate']}/{len(reqs)} "
          f"from generate ({generate_s:.1f} s for the 16 calls); near ties "
          f"{ties}; {len(distinct)} distinct "
          f"tokens generated; plain top-2 gap median {np.median(gaps):.4g},"
          f" min {gaps.min():.4g}", flush=True)
    report = dict(tok_per_s=n_tok / dt, seconds=dt, tokens=n_tok,
                  host_syncs_per_token=eng.n_host_syncs / n_tok,
                  n_prefills=eng.n_prefills, decode_steps=steps,
                  pool_bytes=pool_bytes, peak_mib=peak / 2**20,
                  held_before_mib=held / 2**20, launches=launches,
                  exact_requests=exact, near_ties=ties,
                  distinct_tokens=len(distinct),
                  plain_top2_gap=dict(median=float(np.median(gaps)),
                                      min=float(gaps.min())),
                  plain_route_seconds=plain_s, generate_seconds=generate_s,
                  init_seconds=init_s, prompt_lens=[
                      len(r.prompt) for r in reqs])
    t0 = time.perf_counter()
    report["profile"] = profile_serve(engine, reqs, dt, stages=())
    report["profile"]["seconds"] = time.perf_counter() - t0
    return report, (cfg, params, reqs, plain, out)


def predict_griffin_schedule(reqs, pages):
    """The paged engine's admission schedule does not depend on the
    weights (no eos, fixed budgets): run it on the CPU with a 1-layer
    model of recurrentgemma-2b's paging geometry (one local-attention
    layer, window 2048, max_len 4096: page 64, 32 blocks a slot) and
    count the admissions refused for want of pages, the prefill groups,
    the macro-steps and the pages high-water."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import build_params
    from repro_torch.serve import ContinuousBatchingEngine

    cfg = get_config("recurrentgemma-2b").replace(
        n_layers=1, block_pattern=("attn",), d_model=8, n_heads=1,
        n_kv_heads=1, head_dim=8, d_ff=8, lru_width=8,
        param_dtype="float32", compute_dtype="float32")
    params = build_params(cfg, seed=0, device="cpu")
    eng = ContinuousBatchingEngine(cfg, params, capacity=8, max_len=4096,
                                   k=8, pool="paged", pages=pages)
    waits = []
    alloc = eng._alloc_request

    def counted(req):
        info = alloc(req)
        waits.append(info is None)
        return info
    eng._alloc_request = counted
    with torch.no_grad():
        eng.run([dataclasses.replace(r) for r in reqs])
    return dict(refused=sum(waits), n_prefills=eng.n_prefills,
                n_decode_dispatches=eng.n_decode_dispatches,
                pages_highwater=eng.pages_highwater)


def run_griffin_paged(kernel_rows, model):
    """Phase 10: phase 9's model and requests from a paged pool of
    GRIFFIN_PAGES pages beside the dense pool (dense, paged, paged,
    dense); the refused admissions predicted first by a CPU run of the
    same schedule."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import griffin
    from repro_torch.serve import ContinuousBatchingEngine, Request

    cfg, params, reqs, plain, dense_out = model
    pat = griffin.block_pattern(cfg)
    n_rec, n_attn = pat.count("rec"), pat.count("attn")
    t0 = time.perf_counter()
    predicted = predict_griffin_schedule(reqs, GRIFFIN_PAGES)
    print(f"predicted by a CPU run of the schedule ({time.perf_counter() - t0:.1f}"
          f" s, 1-layer model): {predicted}", flush=True)

    def engine(pool):
        return ContinuousBatchingEngine(
            cfg, params, capacity=8, max_len=4096, k=8, pool=pool,
            pages=GRIFFIN_PAGES if pool == "paged" else None)

    engine("paged").run([Request(uid=0, prompt=reqs[0].prompt,
                                 max_new_tokens=9)])  # first-use costs
    kern = ops.kernels()
    gc.collect()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    dense_a, _, tps_dense_a, _ = timed_run(engine("dense"), reqs)
    peak_dense = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for fn in kern.values():
        fn.launches = 0
    eng = engine("paged")
    out, dt, tps_paged, waits = timed_run(eng, reqs)
    launches = {name: fn.launches for name, fn in kern.items()}
    peak = torch.cuda.max_memory_allocated()
    _, _, tps_paged_b, _ = timed_run(engine("paged"), reqs)
    _, _, tps_dense_b, _ = timed_run(engine("dense"), reqs)
    n_tok = sum(len(v) for v in out.values())
    steps = eng.k * eng.n_decode_dispatches
    want = {name: 0 for name in kern}
    want.update(paged_ring_decode_attention=n_attn * steps,
                rglru_scan=n_rec * eng.n_prefills)
    if launches != want:
        raise AssertionError(f"paged griffin path launched {launches}, "
                             f"expected {want} ({steps} decode steps, "
                             f"{eng.n_prefills} admission groups)")
    got_sched = dict(refused=waits, n_prefills=eng.n_prefills,
                     n_decode_dispatches=eng.n_decode_dispatches,
                     pages_highwater=eng.pages_highwater)
    if got_sched != predicted or not waits:
        raise AssertionError(f"paged schedule {got_sched} differs from the "
                             f"CPU prediction {predicted} (or no admission "
                             "waited for pages)")
    if eng.pages_highwater > GRIFFIN_PAGES or eng.pages_in_use:
        raise AssertionError(f"pages high-water {eng.pages_highwater}, in "
                             f"use at the end {eng.pages_in_use}")
    kernel_rows["paged_ring_decode_attention"]["launches"] = launches[
        "paged_ring_decode_attention"]
    dense_eng = engine("dense")
    report = dict(
        tok_per_s=[tps_paged, tps_paged_b],
        dense_tok_per_s=[tps_dense_a, tps_dense_b], seconds=dt,
        tokens=n_tok, pages_budget=eng.pages_budget,
        pages_highwater=eng.pages_highwater,
        n_pages_allocated=eng.n_pages_allocated,
        admissions_refused_for_pages=waits, predicted=predicted,
        decode_steps=steps, n_prefills=eng.n_prefills,
        pool_bytes=_pool_bytes(eng.pool),
        dense_pool_bytes=_pool_bytes(dense_eng.pool),
        host_syncs_per_token=eng.n_host_syncs / n_tok,
        peak_mib=peak / 2**20, dense_peak_mib=peak_dense / 2**20,
        held_before_mib=held / 2**20, launches=launches)
    del dense_eng
    ties = {"paged": [], "dense": [], "paged vs dense": [],
            "dense vs phase 9": []}
    for r in reqs:
        for what, toks in (("paged", out[r.uid]), ("dense", dense_a[r.uid])):
            if toks.shape != (64,):
                raise AssertionError(f"uid {r.uid}: bad {what} output {toks}")
            tie = check_against_plain(what, r.uid, toks, *plain[r.uid])
            if tie is not None:
                ties[what].append(tie)
        for what, a, b in (("paged and dense engines", out, dense_a),
                           ("dense engines of phases 9 and 10", dense_a,
                            dense_out)):
            tie = check_same_tokens(what, r.uid, a[r.uid], b[r.uid],
                                    plain[r.uid][1])
            if tie is not None:
                ties["paged vs dense" if a is out
                     else "dense vs phase 9"].append(tie)
    report["near_ties"] = ties
    print(f"griffin paged: {len(out)} requests / {n_tok} tokens in "
          f"{dt:.3f} s: {tps_paged:.1f} tok/s (second run "
          f"{tps_paged_b:.1f}); dense pool {tps_dense_a:.1f} and "
          f"{tps_dense_b:.1f} tok/s; admissions refused for pages {waits} "
          f"(predicted {predicted['refused']}); pages {eng.pages_budget} "
          f"budget, {eng.pages_highwater} high-water, "
          f"{eng.n_pages_allocated} allocated, {eng.pages_in_use} in use at "
          f"the end; pool {report['pool_bytes'] / 2**20:.1f} MiB paged vs "
          f"{report['dense_pool_bytes'] / 2**20:.1f} MiB dense; "
          f"{report['host_syncs_per_token']:.4f} host syncs/token "
          f"({eng.n_decode_dispatches} macro-steps, {eng.n_prefills} prefill "
          f"groups); peak memory {(peak - held) / 2**20:.1f} MiB paged vs "
          f"{(peak_dense - held) / 2**20:.1f} MiB dense above the "
          f"{held / 2**20:.1f} MiB held; kernel launches {launches}; tokens "
          f"== plain route for {len(reqs) - len(ties['paged'])}/{len(reqs)} "
          f"(paged), {len(reqs) - len(ties['dense'])}/{len(reqs)} (dense); "
          f"near ties {ties}", flush=True)
    return report


QWEN_PAGES = 64  # phase 11's arena: half the dense pool's 128 pages of 64
QWEN_D, QWEN_K = 4, 2  # phase 11's self-draft depth and blocks a dispatch
QWEN_MATRIX_SCALE = 2.5  # phase 11: block matrices scaled up (see qwen_model)
QWEN_MIN_DISTINCT = 512  # of the dense engine's 1024 tokens (see qwen_model)
F32_LOGIT_RTOL = 1e-3  # f32 kernel route vs f32 full forward, of max |logit|


def qwen_model():
    """qwen3-0.6b at full width and depth in float32 (so the routes'
    tokens compare exactly), weights from a seeded generator.  At the
    init's std (0.02) greedy decoding nearly repeats a few tokens (the
    full-depth engine did, and so did CPU runs of this config cut to 8 and
    14 layers, also with phase 9's scaled-down embedding), so a fault
    that leaves the argmax unchanged would pass the token checks.  The
    block matrices (q, k, v, o and the MLP's) are scaled by
    QWEN_MATRIX_SCALE, to std 0.05 (about 1.6 / sqrt(d_model), as the
    card test's redrawn qwen3 smoke model): each block then changes the
    residual enough that the next token depends on the context (the cut
    CPU runs stopped repeating), and ``run_qwen`` fails below
    QWEN_MIN_DISTINCT distinct tokens."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import build_params

    cfg = get_config("qwen3-0.6b").replace(param_dtype="float32",
                                           compute_dtype="float32")
    params = build_params(cfg, seed=0, device="cuda")
    for group in ("attn", "mlp"):
        for name, leaf in params["dense_blocks"][group].items():
            if name.startswith("w"):
                leaf.mul_(QWEN_MATRIX_SCALE)
    return cfg, params


def qwen_requests(vocab):
    """Phase 11's 16 requests: prompts of 64..768 tokens, 64 new each."""
    import numpy as np

    from repro_torch.data import lm_batch
    from repro_torch.serve import Request

    rng = np.random.default_rng(11)
    return [Request(uid=i, prompt=lm_batch(vocab, 1, int(rng.integers(
        64, 769)), seed=1100 + i)[0], max_new_tokens=64) for i in range(16)]


def _bf16_logit_errors(cfg32, params32, prompts, n_steps=8):
    """The published bf16 against an f32 route on the same bf16-cast
    weights.  Tokens: the f32 kernel route's greedy ones (prefill and
    ``n_steps`` decode steps).  Reference: the f32 full forward over
    prompt + those tokens.  Returns the max |logit| error of the first
    ``n_steps`` decode steps of the f32 kernel route itself (RoPE at every
    decode position, decode_attention over the cache), of the bf16 kernel
    route (prefill, then ``decode_step`` fed the same tokens: flash and
    decode_attention) and of the bf16 plain route (one full forward), the
    reference's max |logit|, and the bf16 config and params."""
    import torch

    from repro_torch.models import transformer
    from repro_torch.utils.pytree import tree_map

    cfg16 = cfg32.replace(param_dtype="bfloat16", compute_dtype="bfloat16")
    params16 = tree_map(lambda t: t.bfloat16(), params32)
    p32 = tree_map(lambda t: t.float(), params16)
    B, P = prompts.shape
    with torch.no_grad():
        cache = transformer.init_cache(cfg32, B, P + n_steps, device="cuda")
        logits, cache = transformer.prefill(p32, {"tokens": prompts}, cfg32,
                                            cache)
        toks, kern32 = [logits.argmax(-1).to(torch.int32)], []
        for i in range(n_steps):
            logits, cache = transformer.decode_step(p32, toks[-1], P + i,
                                                    cache, cfg32)
            kern32.append(logits.float())
            toks.append(logits.argmax(-1).to(torch.int32))
        # (B, n_steps): the decode steps' inputs
        fed = torch.stack(toks[:n_steps], 1)
        full = torch.cat([prompts, fed], 1)
        ref32 = transformer.forward(p32, {"tokens": full}, cfg32)[0][
            :, P:].float()
        plain16 = transformer.forward(params16, {"tokens": full}, cfg16)[0][
            :, P:].float()
        cache = transformer.init_cache(cfg16, B, P + n_steps, device="cuda")
        _, cache = transformer.prefill(params16, {"tokens": prompts}, cfg16,
                                       cache)
        kern16 = []
        for i in range(n_steps):
            logits, cache = transformer.decode_step(params16, fed[:, i],
                                                    P + i, cache, cfg16)
            kern16.append(logits.float())
        kern16 = torch.stack(kern16, 1)
    return (float((torch.stack(kern32, 1) - ref32).abs().max()),
            float((kern16 - ref32).abs().max()),
            float((plain16 - ref32).abs().max()), float(ref32.abs().max()),
            cfg16, params16)


def run_qwen(kernel_rows):
    """Phase 11: qwen3-0.6b through the engine on the dense pool, a paged
    pool of QWEN_PAGES pages and the dense pool speculatively with the
    model drafting for itself; ``generate`` for each request (B 1) and
    over 8 prompts of 512 tokens (B 8); all against the plain route; a
    traced run for the idle share; then the published bf16 through
    ``generate``."""
    import numpy as np
    import torch

    from repro_torch.data import lm_batch
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import generate
    from repro_torch.serve import (
        ContinuousBatchingEngine,
        Request,
        SpeculativeConfig,
    )

    t0 = time.perf_counter()
    cfg, params = qwen_model()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    L = cfg.n_layers
    print(f"qwen3-0.6b: {L} layers x d_model {cfg.d_model}, {cfg.n_heads} "
          f"heads over {cfg.n_kv_heads} KV heads of {cfg.head_dim}, q/k norms,"
          f" RoPE theta {cfg.rope_theta:g}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}, tied: {n_params} params (f32, seeded "
          f"torch.Generator, block matrices x {QWEN_MATRIX_SCALE}; drawn in "
          f"{init_s:.1f} s)", flush=True)
    reqs = qwen_requests(cfg.vocab_size)

    def engine(pool, spec=False):
        return ContinuousBatchingEngine(
            cfg, params, capacity=8, max_len=1024, k=QWEN_K if spec else 8,
            pool=pool, pages=QWEN_PAGES if pool == "paged" else None,
            speculative=(SpeculativeConfig(cfg, params, d=QWEN_D) if spec
                         else None))

    for pool, spec in (("dense", False), ("paged", False), ("dense", True)):
        engine(pool, spec).run([Request(uid=0, prompt=reqs[0].prompt,
                                        max_new_tokens=9)])  # first use
    kern = ops.kernels()
    gc.collect()
    held = torch.cuda.memory_allocated()
    runs = {}
    for label, pool, spec in (("dense", "dense", False),
                              ("paged", "paged", False),
                              ("speculative", "dense", True)):
        torch.cuda.reset_peak_memory_stats()
        for fn in kern.values():
            fn.launches = 0
        eng = engine(pool, spec)
        out, dt, tps, waits = timed_run(eng, reqs)
        launches = {name: fn.launches for name, fn in kern.items()}
        peak = torch.cuda.max_memory_allocated()
        steps = eng.k * eng.n_decode_dispatches
        groups = spec_groups(eng) if spec else eng.n_prefills
        want = {name: 0 for name in kern}
        if spec:
            want.update(chunk_verify_attention=2 * L * steps,
                        slot_decode_attention=L * QWEN_D * steps,
                        flash_attention=2 * L * groups)
        else:
            slot = ("paged_slot_decode_attention" if pool == "paged"
                    else "slot_decode_attention")
            want.update({slot: L * (steps + eng.n_prefix_tail_steps),
                         "flash_attention": L * groups})
        if launches != want or eng.n_spec_fallbacks:
            raise AssertionError(f"qwen3 {label} engine launched {launches},"
                                 f" expected {want} ({steps} decode steps or "
                                 f"blocks, {groups} admission "
                                 f"groups, {eng.n_spec_fallbacks} "
                                 "fallbacks)")
        if pool == "paged" and eng.pages_in_use:
            raise AssertionError(f"{eng.pages_in_use} pages left in use")
        n_tok = sum(len(v) for v in out.values())
        runs[label] = dict(
            out=out, tok_per_s=tps, seconds=dt, tokens=n_tok,
            host_syncs_per_token=eng.n_host_syncs / n_tok,
            n_prefills=eng.n_prefills, decode_steps=steps,
            peak_above_held_mib=(peak - held) / 2**20,
            pool_bytes=_pool_bytes(eng.pool), launches=launches,
            admissions_refused_for_pages=waits,
            pages_highwater=eng.pages_highwater,
            acceptance=(eng.n_spec_accepted, eng.n_spec_proposed))
        print(f"qwen3 {label}: {len(out)} requests / {n_tok} tokens in "
              f"{dt:.3f} s: {tps:.1f} tok/s, "
              f"{eng.n_host_syncs / n_tok:.4f} host syncs/token "
              f"({eng.n_host_syncs} syncs, {eng.n_decode_dispatches} "
              f"macro-steps, {groups} prefill groups); pool "
              f"{runs[label]['pool_bytes'] / 2**20:.1f} MiB; peak "
              f"{(peak - held) / 2**20:.1f} MiB above the "
              f"{held / 2**20:.1f} MiB held; admissions refused for pages "
              f"{waits}, pages high-water {eng.pages_highwater}; acceptance "
              f"{eng.n_spec_accepted}/{eng.n_spec_proposed}; kernel "
              f"launches {launches}", flush=True)
        del eng
    _, _, tps_dense_b, _ = timed_run(engine("dense"), reqs)
    runs["dense"]["tok_per_s_second_run"] = tps_dense_b

    # the reference is the plain route alone (no kernel of the port)
    before = {name: fn.launches for name, fn in kern.items()}
    t0 = time.perf_counter()
    plain = {r.uid: plain_greedy(cfg, params, r.prompt, 64) for r in reqs}
    prompts8 = lm_batch(cfg.vocab_size, 8, 512, seed=1200)
    plain8 = [plain_greedy(cfg, params, p, 64) for p in prompts8]
    plain_s = time.perf_counter() - t0
    if {name: fn.launches for name, fn in kern.items()} != before:
        raise AssertionError("the plain route launched a CUDA kernel")

    ties = {"dense": [], "paged": [], "speculative": [], "paged vs dense": [],
            "generate": [], "generate B 8": []}
    gen_launches, gen_s = 0, 0.0
    want_gen = {name: 0 for name in kern}
    want_gen.update(decode_attention=L * 63, flash_attention=L)
    for r in reqs:
        for what in ("dense", "paged", "speculative"):
            toks = runs[what]["out"][r.uid]
            if toks.shape != (64,) or toks.min() < 0 or \
                    toks.max() >= cfg.vocab_size:
                raise AssertionError(f"uid {r.uid}: bad {what} output")
            tie = check_against_plain(what, r.uid, toks, *plain[r.uid])
            if tie is not None:
                ties[what].append(tie)
        tie = check_same_tokens("paged and dense engines", r.uid,
                                runs["paged"]["out"][r.uid],
                                runs["dense"]["out"][r.uid], plain[r.uid][1])
        if tie is not None:
            ties["paged vs dense"].append(tie)
        for fn in kern.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gen = generate(cfg, params, torch.from_numpy(r.prompt)[None].cuda(),
                       max_new_tokens=64, max_len=1024)[0].cpu().numpy()
        gen_s += time.perf_counter() - t0
        got_l = {name: fn.launches for name, fn in kern.items()}
        if got_l != want_gen:
            raise AssertionError(f"uid {r.uid}: generate launched {got_l}, "
                                 f"expected {want_gen}")
        gen_launches += got_l["decode_attention"]
        tie = check_against_plain("generate", r.uid, gen, *plain[r.uid])
        if tie is not None:
            ties["generate"].append(tie)
    prompts8_d = torch.from_numpy(prompts8).cuda()
    generate(cfg, params, prompts8_d[:, :64], max_new_tokens=4)  # first use
    for fn in kern.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gen8 = generate(cfg, params, prompts8_d, max_new_tokens=64).cpu().numpy()
    gen8_s = time.perf_counter() - t0
    got_l = {name: fn.launches for name, fn in kern.items()}
    if got_l != want_gen:
        raise AssertionError(f"generate at B 8 launched {got_l}, expected "
                             f"{want_gen}")
    gen_launches += got_l["decode_attention"]
    for b in range(8):
        tie = check_against_plain("generate B 8", b, gen8[b], *plain8[b])
        if tie is not None:
            ties["generate B 8"].append(tie)
    kernel_rows["decode_attention"]["launches"] = gen_launches
    distinct = {int(t) for v in runs["dense"]["out"].values() for t in v}
    if len(distinct) < QWEN_MIN_DISTINCT:
        raise AssertionError(f"the dense engine's output nearly repeats: "
                             f"{len(distinct)} distinct tokens")
    gaps = np.concatenate([plain[r.uid][1] for r in reqs])
    print(f"qwen3 tokens == plain route (full forward per token, no kernel;"
          f" {plain_s:.1f} s): "
          + ", ".join(f"{w} {len(reqs) - len(ties[w])}/{len(reqs)}"
                      for w in ("dense", "paged", "speculative", "generate"))
          + f", generate B 8 {8 - len(ties['generate B 8'])}/8; near ties "
          f"{ties}; {len(distinct)} distinct tokens from the dense engine; "
          f"plain top-2 gap median {np.median(gaps):.4g}, min "
          f"{gaps.min():.4g}", flush=True)
    print(f"qwen3 generate: B 1 {16 * 64 / gen_s:.1f} tok/s over the 16 "
          f"requests ({gen_s:.1f} s), B 8 x 512-token prompts "
          f"{8 * 64 / gen8_s:.1f} tok/s ({gen8_s:.2f} s); decode_attention "
          f"launches {gen_launches} ({L} x 63 a call, 17 calls)", flush=True)

    t0 = time.perf_counter()
    profile = profile_serve(lambda: engine("dense"), reqs[:8],
                            untraced_wall=runs["dense"]["seconds"] / 2,
                            stages=())
    profile["seconds"] = time.perf_counter() - t0
    profile["note"] = ("8 of the 16 requests (one wave); the untraced idle "
                       "share uses half the 16-request run's wall time")
    profile["dense_slot_traced_ms"] = slot_cuts_traced(
        lambda: engine("dense"), reqs[:8], runs["dense"]["seconds"] / 2,
        profile)

    # the published bf16, weights cast from the f32 ones
    err_32, err_k, err_p, top, cfg16, params16 = _bf16_logit_errors(
        cfg, params, prompts8_d)
    print(f"qwen3 f32 kernel route (prefill, then 8 decode_step calls) "
          f"against the f32 full forward on the bf16-cast weights: max "
          f"|logit| error {err_32:.4g}, max |logit| {top:.4g} (limit "
          f"{F32_LOGIT_RTOL:g} of it)", flush=True)
    if not err_32 <= F32_LOGIT_RTOL * top:
        raise AssertionError(f"f32 decode logits off by {err_32:.4g} "
                             f"(max |logit| {top:.4g})")
    generate(cfg16, params16, prompts8_d[:, :64], max_new_tokens=4)
    for fn in kern.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gen16 = generate(cfg16, params16, prompts8_d, max_new_tokens=64)
    torch.cuda.synchronize()
    gen16_s = time.perf_counter() - t0
    if kern["decode_attention"].launches != L * 63 or gen16.shape != (8, 64):
        raise AssertionError(f"bf16 generate launched "
                             f"{kern['decode_attention'].launches} "
                             "decode_attention kernels")
    print(f"qwen3 bf16 (published dtype, weights cast from f32): generate "
          f"B 8 x 512 {8 * 64 / gen16_s:.1f} tok/s ({gen16_s:.2f} s); max "
          f"|logit| error of the first 8 decode steps against the f32 route "
          f"on the same weights: kernel route {err_k:.4g}, plain route "
          f"{err_p:.4g} (ratio {err_k / err_p:.3f}, limit 2)", flush=True)
    if not err_k <= 2 * err_p:
        raise AssertionError(f"bf16 kernel route's logit error {err_k:.4g} "
                             f"is more than twice the plain route's "
                             f"{err_p:.4g}")
    for run in runs.values():
        del run["out"]
    return dict(runs=runs, near_ties=ties, distinct_tokens=len(distinct),
                plain_top2_gap=dict(median=float(np.median(gaps)),
                                    min=float(gaps.min())),
                plain_route_seconds=plain_s,
                generate_b1_tok_per_s=16 * 64 / gen_s,
                generate_b8_tok_per_s=8 * 64 / gen8_s,
                generate_decode_attention_launches=gen_launches,
                bf16=dict(generate_b8_tok_per_s=8 * 64 / gen16_s,
                          logit_err_kernel=err_k, logit_err_plain=err_p),
                f32_decode_logit_err=err_32, f32_max_abs_logit=top,
                profile=profile, init_seconds=init_s, n_params=n_params,
                held_mib=held / 2**20)


DEIT_SRC, DEIT_TGT = "deit-s", "deit-b"  # phase 12's pair, full width
DEIT_CLASSES = 16  # phase 12's labels: the first 16 of DeiT's 1000 classes
DEIT_BATCH = 32
DEIT_PRETRAIN, DEIT_OP_STEPS = 40, 10
CKPT_ROOT = ROOT / "build" / "chip_ckpt"


def vision_batches(cfg, seed, n_classes=DEIT_CLASSES, device="cuda"):
    """Phase 12's batches on ``device``: ``vision_batch`` at the config's
    image and patch size (224 and 16: 196 patches of 768 values), cut to
    its ``continuous_inputs`` and ``learned_pos - 1`` as the launcher's
    ``data_for`` cuts them, labels from the first ``n_classes``."""
    import torch

    from repro_torch.data import vision_batch

    step = 0
    while True:
        b = vision_batch(n_classes, DEIT_BATCH, cfg.image_size,
                         cfg.patch_size, seed=seed, step=step)
        b["inputs"] = b["inputs"][:, :cfg.learned_pos - 1,
                                  :cfg.continuous_inputs]
        yield {k: torch.from_numpy(v).to(device) for k, v in b.items()}
        step += 1


def _recording_managers(launch_train):
    """Swap the launcher's ``CheckpointManager`` for a subclass that keeps
    every instance (their ``saves`` hold each save's seconds and bytes);
    -> (list of instances, restore function)."""
    made, real = [], launch_train.CheckpointManager

    class Recording(real):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)
    launch_train.CheckpointManager = Recording

    def restore():
        launch_train.CheckpointManager = real
    return made, restore


def run_deit(kernel_rows, device="cuda"):
    """Phase 12: the paper's headline setting at full width, DeiT-S (12 x
    384, 6 heads) grown into DeiT-B (12 x 768, 12 heads): 197 tokens (196
    patches of 16 x 16 x 3 from 224 x 224 images, and the class token),
    1000 classes, f32, seeded weights and synthetic vision batches.

    The labels are drawn from the first 16 of the 1000 classes
    (``vision_batch(16, ...)``), so that a few tens of pretraining steps
    teach DeiT-S something growth can carry over (phase 5 restricts its
    vocabulary for the same reason); the launcher runs (part 3) use its
    own ``data_for``, over all 1000.

    1. pretrain DeiT-S, save it through an async ``CheckpointManager`` and
       reload it leaf for leaf; 2. train the rank-1 Mango operator into
       DeiT-B (the sandwich launching every step), grow, hold the
       contraction against its reference, grown vs scratch on a held-out
       batch, a few DeiT-B train steps; 3. the train launcher grown from
       that checkpoint (the sibling-directory rule) with checkpoints every
       3 steps, then resumed from a copy of step 3: the same losses;
       4. the three examples; 5. clean up, peak memory, traces."""
    import shutil

    import numpy as np
    import torch

    from repro_torch.checkpoint import CheckpointManager, load_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.core import grow as growlib
    from repro_torch.core import mango, packing
    from repro_torch.examples import grow_pipeline, quickstart, train_100m
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.serve import build_params
    from repro_torch.optim import OptimizerConfig, make_optimizer
    from repro_torch.train.steps import (
        make_eval_step,
        make_grow_step,
        make_train_step,
    )
    from repro_torch.utils.pytree import (
        tree_flatten_with_paths,
        tree_param_count,
        tree_size_bytes,
    )

    sync = torch.cuda.synchronize
    cfg_s, cfg_t = get_config(DEIT_SRC), get_config(DEIT_TGT)
    shutil.rmtree(CKPT_ROOT, ignore_errors=True)
    kern = ops.kernels()
    sync()
    torch.cuda.reset_peak_memory_stats()
    for fn in kern.values():
        fn.launches = 0
    report = {}

    # 1. pretrain the source, save it, reload it
    small = build_params(cfg_s, seed=0, device=device)
    opt = OptimizerConfig(lr=1e-3)
    init_fn, _ = make_optimizer(opt)
    state, step = init_fn(small), make_train_step(cfg_s, opt)
    report["n_params"] = {DEIT_SRC: tree_param_count(small)}
    it = vision_batches(cfg_s, seed=0, device=device)
    t0 = time.perf_counter()
    batches = [next(it) for _ in range(DEIT_PRETRAIN)]
    report["batch_host_ms"] = (time.perf_counter() - t0) * 1e3 / len(batches)
    losses, ms = [], []
    for s_, b in enumerate(batches):
        sync()
        t0 = time.perf_counter()
        small, state, m = step(small, state, b, s_ + 1)
        sync()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
    del batches
    if not all(np.isfinite(losses)):
        raise AssertionError(f"DeiT-S pretraining loss not finite: {losses}")
    report.update(pretrain_ms_per_step=float(np.mean(ms[1:])),
                  pretrain_first_step_ms=ms[0], pretrain_losses=losses)
    print(f"pretrain {DEIT_SRC} ({report['n_params'][DEIT_SRC]:,} params): "
          f"{DEIT_PRETRAIN} steps of {DEIT_BATCH} images, loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}, "
          f"{report['pretrain_ms_per_step']:.1f} ms/step after the first "
          f"({ms[0]:.1f} ms); a batch takes the host "
          f"{report['batch_host_ms']:.1f} ms to make", flush=True)
    src_dir = CKPT_ROOT / DEIT_SRC
    tree = {"p": small, "o": state}
    mgr = CheckpointManager(str(src_dir), keep=3, every=DEIT_PRETRAIN,
                            async_save=True)
    sync()
    t0 = time.perf_counter()
    mgr.maybe_save(DEIT_PRETRAIN, tree, extra={"arch": DEIT_SRC})
    snapshot_ms = (time.perf_counter() - t0) * 1e3
    mgr.wait()
    save = dict(mgr.saves[0], snapshot_ms=snapshot_ms)
    if save["bytes"] != tree_size_bytes(tree):
        raise AssertionError(f"the save wrote {save['bytes']} bytes of a "
                             f"{tree_size_bytes(tree)}-byte tree")
    t0 = time.perf_counter()
    back, sstep, extra = load_checkpoint(str(src_dir), tree)
    sync()
    save["load_s"] = time.perf_counter() - t0
    bad = [n for (n, a), (_, b) in zip(tree_flatten_with_paths(tree),
                                       tree_flatten_with_paths(back))
           if not (b.is_cuda == (device == "cuda") and torch.equal(a, b))]
    if bad or sstep != DEIT_PRETRAIN or extra != {"arch": DEIT_SRC}:
        raise AssertionError(f"the reloaded {DEIT_SRC} checkpoint differs: "
                             f"step {sstep}, extra {extra}, leaves {bad[:5]}")
    del back, state, tree
    report["source_save"] = save
    print(f"saved {DEIT_SRC} params and AdamW state at step {sstep}: "
          f"{save['bytes']:,} bytes, snapshot on the caller "
          f"{snapshot_ms:.1f} ms, write {save['seconds']:.2f} s "
          f"({save['bytes'] / save['seconds'] / 1e9:.2f} GB/s), reload "
          f"{save['load_s']:.2f} s; every leaf equal and on the card",
          flush=True)

    # 2. the operator (Eq. 7), growth, grown vs scratch, DeiT-B steps
    gen = torch.Generator(device=device).manual_seed(0)
    gop, op_params = growlib.build("mango", cfg_s, cfg_t, rank=1, gen=gen)
    dims = gop.op.dims("dense_blocks")
    gstep = make_grow_step(gop, cfg_t, OptimizerConfig(lr=1e-3))
    ostate = make_optimizer(OptimizerConfig(lr=1e-3))[0](op_params)
    it = vision_batches(cfg_t, seed=3, device=device)
    losses, ms = [], []
    for s_ in range(DEIT_OP_STEPS):
        b = next(it)
        before = kern["tr_sandwich"].launches
        sync()
        t0 = time.perf_counter()
        op_params, ostate, m = gstep(op_params, ostate, small, b, s_ + 1)
        sync()
        ms.append((time.perf_counter() - t0) * 1e3)
        if kern["tr_sandwich"].launches == before:
            raise AssertionError(f"DeiT operator step {s_} did not launch "
                                 "the tr_sandwich kernel")
        losses.append(float(m["loss"]))
    if not all(np.isfinite(losses)):
        raise AssertionError(f"DeiT operator loss not finite: {losses}")
    report.update(operator_ms_per_step=float(np.mean(ms[1:])),
                  operator_losses=losses, operator_dims=dims)
    print(f"operator training {DEIT_SRC} -> {DEIT_TGT} (rank-1 Mango, "
          f"{dims}): {DEIT_OP_STEPS} steps, loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}, {report['operator_ms_per_step']:.1f} ms/step "
          f"after the first ({ms[0]:.1f} ms), the sandwich launched on "
          "every step", flush=True)
    b = next(it)
    (op_params, ostate, _), report["operator_step_profile"] = profile_step(
        "deit operator step", lambda: gstep(op_params, ostate, small, b,
                                            DEIT_OP_STEPS + 1))
    with torch.no_grad():
        big = growlib.grow_params(gop, op_params, small)
        g = gop.op.plan_src.groups[0]
        M1 = packing.pack_group(g, small[g.name], cfg_s.d_model)
        cores = op_params["groups"][g.name]
        got = mango.contract(M1, cores)
        want = mango.contract_reference(M1, cores)
        rel = float((got - want).abs().max() / want.abs().max())
    if not rel <= 1e-5:
        raise AssertionError(f"DeiT contract disagrees with "
                             f"contract_reference: max err {rel:.3g} of "
                             "the largest entry > 1e-5")
    report["contract_max_rel_err"] = rel
    report["n_params"][DEIT_TGT] = tree_param_count(big)
    print(f"grow {DEIT_TGT} ({report['n_params'][DEIT_TGT]:,} params); "
          f"contract vs contract_reference on M2{tuple(got.shape)}: max err "
          f"{rel:.3g} of the largest entry (limit 1e-5)", flush=True)
    del got, want, M1, ostate
    ev = make_eval_step(cfg_t)
    held = next(vision_batches(cfg_t, seed=50, device=device))
    scratch = build_params(cfg_t, seed=99, device=device)
    evg, evs = ev(big, held), ev(scratch, held)
    del scratch
    report.update(grown_loss=float(evg["loss"]),
                  scratch_loss=float(evs["loss"]),
                  grown_acc=float(evg["acc"]), scratch_acc=float(evs["acc"]))
    report["margin"] = report["scratch_loss"] - report["grown_loss"]
    print(f"held-out loss of {DEIT_TGT}: grown {report['grown_loss']:.4f} "
          f"(acc {report['grown_acc']:.3f}), scratch "
          f"{report['scratch_loss']:.4f} (acc {report['scratch_acc']:.3f}), "
          f"margin {report['margin']:.4f}", flush=True)
    if not report["margin"] > 0:
        raise AssertionError(f"the grown {DEIT_TGT} does not start below "
                             "the scratch one")
    tstate, tstep = init_fn(big), make_train_step(cfg_t, opt)
    it = vision_batches(cfg_t, seed=1, device=device)
    ms, tr_losses = [], []
    for s_ in range(4):
        b = next(it)
        sync()
        t0 = time.perf_counter()
        big, tstate, m = tstep(big, tstate, b, s_ + 1)
        sync()
        ms.append((time.perf_counter() - t0) * 1e3)
        tr_losses.append(float(m["loss"]))
    report.update(train_ms_per_step=float(np.mean(ms[1:])),
                  train_losses=tr_losses)
    print(f"train grown {DEIT_TGT}: 4 steps, loss {tr_losses[0]:.4f} -> "
          f"{tr_losses[-1]:.4f}, {report['train_ms_per_step']:.1f} ms/step "
          f"after the first ({ms[0]:.1f} ms)", flush=True)
    b = next(it)
    (big, tstate, _), report["train_step_profile"] = profile_step(
        "deit-b train step", lambda: tstep(big, tstate, b, 5))
    del big, tstate, small, op_params, b, held
    gc.collect()

    # 3. the launcher grown from the checkpoint, checkpointing; resumed
    managers, restore = _recording_managers(launch_train)
    runs = {}
    try:
        for run, ckpt, kw in (
                ("A", CKPT_ROOT / DEIT_TGT, dict(grow_from=DEIT_SRC)),
                ("B", CKPT_ROOT / f"{DEIT_TGT}-resumed", dict(resume=True))):
            if run == "B":
                shutil.copytree(CKPT_ROOT / DEIT_TGT / "step_0000000003",
                                ckpt / "step_0000000003")
            logs = []
            t0 = time.perf_counter()
            _, hist = launch_train.train(
                DEIT_TGT, ckpt_dir=str(ckpt), ckpt_every=3, steps=6,
                batch=DEIT_BATCH, log_every=1, device=device,
                log_fn=lambda msg, _l=logs: (_l.append(msg),
                                             print(msg, flush=True)), **kw)
            runs[run] = dict(seconds=time.perf_counter() - t0, logs=logs,
                             losses={h["step"]: h["loss"] for h in hist},
                             saves=managers[-1].saves)
    finally:
        restore()
    want_src = (f"[grow] source weights from {CKPT_ROOT / DEIT_SRC} @ step "
                f"{DEIT_PRETRAIN}")
    if want_src not in runs["A"]["logs"]:
        raise AssertionError(f"run A did not log {want_src!r}")
    if "[resume] restored step 3" not in runs["B"]["logs"]:
        raise AssertionError("run B did not resume from step 3")
    a, b_ = runs["A"]["losses"], runs["B"]["losses"]
    if sorted(b_) != [3, 4, 5]:
        raise AssertionError(f"run B logged steps {sorted(b_)}")
    rel = max(abs(b_[s] - a[s]) / abs(a[s]) for s in b_)
    if not rel <= 1e-4:
        raise AssertionError(f"resumed losses {b_} differ from the "
                             f"uninterrupted run's {a} (max relative "
                             f"{rel:.3g} > 1e-4)")
    for r in runs.values():
        for sv in r["saves"]:
            sv["gb_per_s"] = sv["bytes"] / sv["seconds"] / 1e9
    report["launcher"] = dict(resumed_max_rel_loss_diff=rel, **{
        k: {kk: vv for kk, vv in v.items() if kk != "logs"}
        for k, v in runs.items()})
    print(f"launcher: run A {runs['A']['seconds']:.1f} s (grown from the "
          f"step-{DEIT_PRETRAIN} checkpoint), run B resumed from step 3 "
          f"{runs['B']['seconds']:.1f} s; losses at steps 3-5 "
          f"{[round(b_[s], 6) for s in (3, 4, 5)]} vs "
          f"{[round(a[s], 6) for s in (3, 4, 5)]}: max relative difference "
          f"{rel:.3g} (limit 1e-4)", flush=True)
    for run in ("A", "B"):
        for sv in runs[run]["saves"]:
            print(f"run {run} save at step {sv['step']}: {sv['bytes']:,} "
                  f"bytes in {sv['seconds']:.2f} s ({sv['gb_per_s']:.2f} "
                  "GB/s)", flush=True)

    # 4. the three examples
    examples = {}
    t0 = time.perf_counter()
    qs = quickstart.main(["--device", device])
    examples["quickstart"] = dict(seconds=time.perf_counter() - t0, **qs)
    t0 = time.perf_counter()
    hist = grow_pipeline.run(str(CKPT_ROOT / "pipeline"), device=device)
    examples["grow_pipeline"] = dict(seconds=time.perf_counter() - t0,
                                     final_loss=hist[-1]["loss"])
    t0 = time.perf_counter()
    _, hist = train_100m.main(["--grow", "--steps", "8", "--ckpt-dir",
                               str(CKPT_ROOT / "100m"), "--device", device])
    examples["train_100m"] = dict(seconds=time.perf_counter() - t0,
                                  final_loss=hist[-1]["loss"])
    if not all(np.isfinite(examples[k]["final_loss"])
               for k in ("grow_pipeline", "train_100m")):
        raise AssertionError(f"an example's loss is not finite: {examples}")
    report["examples"] = examples
    print("examples: " + "; ".join(
        f"{k} {v['seconds']:.1f} s" for k, v in examples.items())
        + f" (quickstart grown {qs['grown']:.4f} < scratch "
        f"{qs['scratch']:.4f})", flush=True)

    # 5. clean up, peak memory, launches
    shutil.rmtree(CKPT_ROOT)
    launches = {name: fn.launches for name, fn in kern.items()}
    report.update(launches=launches,
                  peak_mib=torch.cuda.max_memory_allocated() / 2**20)
    print(f"deit path: kernel launches {launches}, peak memory "
          f"{report['peak_mib']:.1f} MiB", flush=True)
    if launches["tr_sandwich"] == 0:
        raise AssertionError("tr_sandwich was never launched on the DeiT "
                             "path")
    kernel_rows["tr_sandwich"]["deit_launches"] = launches["tr_sandwich"]
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

    phase("grow gpt-small -> gpt-base")
    t0 = time.perf_counter()
    grow, small, big = run_grow(rows)
    print(f"phase 5 took {time.perf_counter() - t0:.1f} s", flush=True)

    phase("speculative serving: gpt-small drafts for the grown gpt-base")
    t0 = time.perf_counter()
    spec, spec_reqs, spec_plain = run_speculative(rows, small, big)
    print(f"phase 6 took {time.perf_counter() - t0:.1f} s", flush=True)

    phase("paged serving of gpt-base: block tables, prefix sharing")
    t0 = time.perf_counter()
    paged = run_paged_serve(rows)
    print(f"phase 7 took {time.perf_counter() - t0:.1f} s", flush=True)

    phase("paged speculative serving: one arena for gpt-small and gpt-base")
    t0 = time.perf_counter()
    paged_spec = run_paged_speculative(rows, small, big, spec_reqs,
                                       spec_plain)
    del small, big, spec_reqs, spec_plain
    print(f"phase 8 took {time.perf_counter() - t0:.1f} s", flush=True)
    gc.collect()  # phases 5-8's models go before recurrentgemma-2b
    torch.cuda.empty_cache()

    phase("serve recurrentgemma-2b (griffin), dense pool")
    t0 = time.perf_counter()
    griffin_dense, griffin_model_state = run_griffin_serve(rows)
    print(f"phase 9 took {time.perf_counter() - t0:.1f} s", flush=True)

    phase("serve recurrentgemma-2b (griffin), paged pool")
    t0 = time.perf_counter()
    griffin_paged = run_griffin_paged(rows, griffin_model_state)
    del griffin_model_state
    print(f"phase 10 took {time.perf_counter() - t0:.1f} s", flush=True)

    phase("serve qwen3-0.6b (RoPE): dense, paged, speculative, generate")
    t0 = time.perf_counter()
    qwen = run_qwen(rows)
    print(f"phase 11 took {time.perf_counter() - t0:.1f} s", flush=True)
    gc.collect()  # phase 11's models go before DeiT-B
    torch.cuda.empty_cache()

    phase("grow deit-s -> deit-b: checkpoints, resume, the examples")
    t0 = time.perf_counter()
    deit = run_deit(rows)
    print(f"phase 12 took {time.perf_counter() - t0:.1f} s", flush=True)

    # the contract's keys, then the tensor-core rows' 3xTF32 and bf16 ones
    kernels = [{key: r[key] for key in (
        "name", "route", "source", "replaces", "launches", "max_abs_err",
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
        "bound_rate", "bound_simt_ms", "bf16_ms", "bf16_library_ms",
        "bf16_bound_ms") if key in r}
        for r in rows.values()]
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"device": kind, "nvidia_smi": smi, "kernels": list(rows.values()),
             "serve": serve, "grow": grow, "speculative": spec,
             "paged": paged, "paged_speculative": paged_spec,
             "griffin_dense": griffin_dense, "griffin_paged": griffin_paged,
             "qwen": qwen, "deit": deit,
             "build_seconds": secs}, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
