#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``repro_torch``): serving, the
paper's growth and training loop, speculative serving of the grown model
with its source drafting, both served from a paged pool,
recurrentgemma-2b (griffin) served from a dense and a paged pool, and
qwen3-0.6b (RoPE) served on every route; DeiT-S grown into DeiT-B
with checkpoints, resume and the examples; gpt-base sampled;
gpt-small grown live into gpt-base under traffic, and crash recovery;
griffin speculation; the fault layer; griffin growth, and
recurrentgemma-2b trained at full width; qwen3-0.6b with a sliding window
served from ring caches on every route; xlstm-1.3b served dense, paged and
speculative, grown into and trained at full width; phi3.5-moe-42b (mixture
of experts) at full width, cut in depth, served at two capacity factors,
grown into and trained; deepseek-v3-671b (multi-head latent attention, MoE
and the MTP head) at full width, cut in depth, served from latent caches
on both pools and speculatively, grown into and trained; qwen2-vl-72b
(multimodal RoPE) at full width, cut in depth, on every serving route;
hubert-xlarge (an encoder over continuous frames) trained at full width
and depth and grown into.

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
                dense and paged, the paged verify's ring layout (phase
                17's shape, and hd 64 and 80 with done rows, offsets up
                to eight laps around the ring and sentinel table
                entries), the dense slot and ``decode_attention``
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
                engine never), and the first 4 requests' tokens, from the
                engine and from ``generate``, must equal the plain route's
                (a full forward per step, which runs no kernel of the
                port) except where its top-2 logit gap is below 1e-4 (an
                f32 near tie, reported).
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
                on the same requests; a traced run of its first 8
                requests; then
                gpt-base drafting for itself, where a rejection must sit
                at a near tie;
  7. paged   -- phase 4's gpt-base from a paged pool of 48 pages (3/8 of
                the dense pool's 128), capacity 8, max_len 1024 (page 64),
                K 8: 16 requests of 64 new tokens, 12 opening with one
                256-token prefix, beside the dense pool (dense, then
                paged): tokens == the dense engine, and the first
                4 requests' == the plain route (near ties reported),
                prefix hits, admissions that
                waited for pages, exact launches of the paged slot kernel
                (one per layer per decode step, the dense one never), no
                page left in use; a traced run of the last 8 requests
                (two of them prefix hits) for the idle share and the host
                time per engine stage (admission, hit admission, dispatch,
                processing);
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
                (rings filled at admission).  Tokens from the engine (its
                first 3 requests and the shortest of its first 8, every
                kind of prompt among them) and from ``generate`` (its
                first 2 requests) == the plain route
                (``griffin.prefill`` with the scan's plain version, then
                ``decode_step``, a request at a time, no kernel) up to
                reported near ties; for the request of the shortest
                prompt, the engine's and the plain route's tokens ==
                the scalar route (``decode_step`` over the prompt, no
                prefill); exactly 8
                ring launches a decode step and 18 scan launches an
                admission group, no other kernel;
 10. griffin paged -- phase 9's model and its first 8 requests from a
                160-page arena (5/8 of the dense rings' 256) beside the
                dense pool: tokens
                == the plain route (phase 9's dense engine exactly where
                it has none, ``griffin_reference``) and the dense engine,
                exact launches of
                the paged ring kernel (the dense one never), the refused
                admissions, prefill groups, macro-steps and pages
                high-water as a CPU run of the same schedule (1-layer
                model) predicted, no page left in use;
 10b. griffin speculation -- phase 9's model drafting for itself (d 4, K
                2) on its first 4 requests: the model itself on the dense
                pool (acceptance exactly 1.0), then a copy nudged by
                seeded noise (1e-3 of each leaf's std; acceptance strictly
                inside (0, 1)) on phase 10's 160-page pool.  Tokens ==
                phase 9's plain route up to reported near ties; exact
                launches of the ring (paged ring) kernel, 3d + 2 a block
                and attention layer, and of the scan, each recurrent layer
                of each admission prefill (target and draft); tok/s beside
                phase 10's plain engines;
 11. qwen3  -- qwen3-0.6b at full width and depth (28 layers, 16 heads
                over 8 KV heads of 128, q/k norms, RoPE theta 1e6, vocab
                151,936, tied; f32, seeded weights with the block
                matrices scaled 2.5x, so greedy output varies): 16 requests of
                64..768 prompt tokens and 64 new through the engine
                (capacity 8, max_len 1024, K 8) on the dense pool, a
                64-page paged pool and speculatively with the model
                drafting for itself (d 4, K 2), then ``generate`` for each
                of the first 2 requests (B 1) and over 8 prompts of 512
                (B 8; its first 2 rows checked).  Tokens ==
                the plain route (a full forward per token; the first 2
                requests, and any later one where the engines disagree) up
                to reported near ties, paged == dense and speculative ==
                dense for all 16, exact launches (decode_attention
                28 x 63 per ``generate`` call and never from the engine),
                no page left in use, at least 512 distinct tokens from
                the dense engine; tok/s, host syncs per token, peak
                memory, a traced run's idle share.  The f32 logits
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
                of the DeiT-B train step and the operator step;
 13. sampled -- gpt-base (phase 4's weights) sampled at temperature 0.8,
                top-k 50, top-p 0.95, seed 5, on phase 7's 16 requests
                (64 new tokens, capacity 8, K 8): the port's threefry
                keys, bits and uniforms on the card equal to the CPU's and
                ``filtered_probs`` within 1e-6; the sampled dense engine
                beside the greedy one (tok/s of both; host syncs, prefill
                groups, macro-steps and every kernel's launches equal);
                tokens of the first 4 == a sequential sampled replay
                (``fam.prefill`` and ``decode_step`` along the same (seed,
                uid) chain) up to reported near ties of the perturbed
                scores, and not all
                equal to greedy's; the paged pool of 48 pages with prefix
                hits == dense, no page left in use; gpt-base drafting for
                itself (d 4, K 2, 8 requests) at acceptance 1.0 with equal
                tokens in two runs; device ops per decode step of two
                device-only traced runs, sampled and greedy.
 14. upgrade -- phase 5's pretrained gpt-small served (capacity 8, max_len
                512, K 8, prefill bucket 64; 16 requests of 64 new tokens,
                prompts of 64..384 tokens from the 1024-id chain) and grown
                LIVE into gpt-base (rank-1 Mango, noise 0) with gpt-small
                drafting after the swap (d 4): first growing on a
                background thread while the engine serves waves of the
                requests, then synchronously with the swap at dispatch 2,
                then synchronously on a 48-page paged pool.  Every resumed
                request, and those of the first 8 prompts, against the
                plain routes: served before the swap ==
                gpt-small's, resumed == gpt-small's committed prefix then
                the grown gpt-base's on prompt ++ committed, queued at the
                swap == the grown gpt-base's (near ties reported); exact
                launches in the synchronous runs; the swap itself builds,
                loads and launches nothing, and every kernel launched after
                it was launched by the prewarm; pause, prewarm and growth
                seconds, the greedy agreement probe, the post-swap
                acceptance, pages resident at the swap and re-prefilled, no
                page in use at the end.  Then the grown gpt-base sampled
                (phase 13's policy) with a journal and a snapshot, crashed
                after 3 dispatches, restored from the snapshot and resumed
                from the journal: tokens == the uninterrupted run's up to
                near ties; and the same through the launcher's
                ``--journal``, ``--snapshot`` and ``--resume``.
 15. faults -- the grown gpt-base of phase 14 (gpt-small drafting where
                said) on phase 7's 16 requests, capacity 8, max_len 1024,
                K 8: the plan ``nan@2,oom@3:2,slow@4:0.05,malformed@5`` on
                the dense pool and a 48-page pool (exactly one request
                quarantined, its tokens a prefix of its plain-route tokens,
                every other request == the plain route, the hostile
                request rejected, the paged arena degraded to full
                reservations and no page in use at the end, exact
                launches); a NaN in the draft's pool (d 4, K 2: one
                fallback, nothing quarantined, every token == the plain
                route, exact launches); a 3 s hang past a 2 s deadline on
                the wall clock (all 16 expired, the run bounded); shedding
                at capacity 1; the launcher crashed by ``--faults crash@3``
                and resumed by ``--resume`` (16/16 == the whole launcher
                run); ``run(realtime=True)`` over seeded arrival offsets
                (time to first token per request, gaps between block
                readbacks).
 16. griffin growth and training -- (a) griffin-micro pretrained 100
                steps and grown into griffin-micro-big by rank-1 Mango
                after 10 operator steps (a sandwich a group, a scan and a
                backward scan a recurrent layer: exact launches counted
                from after the pretraining), the held-out margin scratch -
                grown (> 0), the grown model trained 5 steps (the scan and
                its backward, exact launches); the griffin
                upgrade command through the serve launcher (``--arch
                griffin-micro --grow-cfg griffin-micro-big --upgrade-at 1
                --upgrade-sync``: agreement 1.000, griffin-micro drafting
                after the swap) and a swap mid-flight whose grown model
                verifies griffin-micro's proposals (ring kernels at head
                dims 16 and 32); (b) recurrentgemma-2b at full width and
                depth (26 x 2560, f32, seeded weights) trained 3 AdamW
                steps at B 2 x S 512 (params and moments updated in
                place): step 0's loss and gradient norm
                against the plain route (the scan through its plain
                version under autograd; 1e-5 and 1e-4 relative), 18
                forward and 18 backward scan launches a step and no other
                kernel, ms/step against the f32 FLOP bound, peak memory.
 17. window  -- phase 11's qwen3-0.6b weights with a window of 1,025
                (rings of 1,088 slots, 17 pages of 64) on 8 requests of
                1,100..1,600 prompt tokens (4 opening with the same 1,280)
                and 64 new tokens each, capacity 8, max_len 2,048: (a) the
                dense pool (the ring kernel), (b) a paged pool of 84 pages
                with ring prefix sharing (the paged ring kernel; prefix
                hits, misses, refused admissions, prefills, macro-steps
                and the pages high-water as a CPU run of the schedule
                predicts, 3 hits), (c) the paged pool speculating with a
                copy nudged by 1e-3 of each leaf's std drafting (d 4, K 2:
                the paged ring kernel and the paged verify's ring layout),
                (d) the same on the dense pool (the dense verify's ring
                layout).  Tokens of (a)-(d) equal for all 8 requests and
                the plain route's for the first 2 (near ties reported),
                exact launches, acceptance strictly inside (0, 1), 0 pages
                in use at the end; tok/s, acceptance, hits, pages
                high-water and peak memory beside the card's name and
                power limit.
 18. xlstm   -- xlstm-1.3b at full width and depth (48 x 2048: 42 mLSTM
                and 6 sLSTM blocks, mLSTM head dim 1,024; 3,606,139,216
                params, f32, seeded weights; no kernel of the port on its
                serving path) on 8 requests of 64..512 prompt tokens and
                64 new each, capacity 8, max_len 640: (a) the dense pool,
                and the sequential route (``generate``'s prefill and
                decode steps) on the first 4 (near ties reported); (b) a
                512-token prompt through the chunkwise prefill (two chunks
                of 256) and through the mLSTM recurrence stepped token by
                token: the last logits and the carried C/n/m within the
                stated f32 limits; (c) a paged pool of 6 pages (the conv
                tails as slot groups, one page a request): tokens == (a)'s,
                refused admissions, prefills, macro-steps and the pages
                high-water as a CPU run of the schedule predicts, 0 pages
                in use; (d) a copy nudged by 1e-3 of each leaf's std
                drafting (d 3, K 2, capacity 4) for the shortest prompt
                on the dense pool and a 4-page pool: tokens == (a)'s,
                acceptance strictly inside (0, 1), peak memory; (e)
                xlstm-1.3b-smoke pretrained and grown into an 8 x 128
                xlstm by rank-1 Mango after a few operator steps: the
                sandwich launched exactly as often as a CPU run counts, the
                grown params == the plain version's route, the held-out
                margin scratch - grown; (f) xlstm-1.3b trained 2 in-place
                AdamW steps at B 1 x S 256 (no kernel launched): ms/step
                against the f32 FLOP bound and peak memory.  Tok/s,
                acceptance and memory beside the card's name and power
                limit.
 19. phi     -- phi3.5-moe-42b at full width (d_model 4,096, 32 heads
                over 8 KV heads of 128, 16 experts of 6,400 at top 2,
                vocab 32,064; f32, seeded weights) cut to 4 of 32 layers
                (5,463,904,256 params), 8 requests of 64..448 prompt tokens
                and 64 new each, capacity 8, max_len 512, K 8, buckets of
                16 (a whole sequence is one dispatch group): (a) at the
                published capacity factor 1.25, where prefills drop
                choices (counted), the dense pool and a 32-page pool, in
                f32 and in bf16 (weights cast): paged == dense, a
                disagreement decided by the same route replayed with
                plain attention (bf16: the limits are twice the logit
                and router-gap differences of that bf16 replay and the
                kernels' one, the arithmetic dense and paged differ in);
                (b) at
                capacity factor 8.0 = E / K, where nothing can drop: the
                dense pool, the 32-page pool with 4 requests opening on
                the same 256 tokens (hits, misses, refusals, prefills,
                macro-steps, tail steps and the pages high-water as a
                CPU run of the schedule predicts), a copy nudged by 1e-3
                of each leaf's std drafting (d 4, K 2) on both pools
                (acceptance strictly inside (0, 1)), and ``generate`` at
                B 1 on the first 2: all == the dense run, and the first 2
                == the plain route (a full forward a token), near ties
                (a top-2 logit gap below 1e-4 or a router top-K boundary
                gap below 1e-5, at or before the step) reported; exact
                launches of the six attention kernels throughout, 0
                pages in use; (c) phi3.5-moe-42b-smoke grown into a 4 x
                128 MoE by rank-1 Mango after 5 operator steps (the
                sandwich over the ``"expert"`` slots launched exactly as
                a CPU run counts, the plain route's params, the held-out
                margin); (d) phi3.5-moe-42b cut to 2 layers trained 2
                AdamW steps at B 1 x S 256: loss, moe_aux, ms/step
                against the bound, peak memory.
 20. deepseek -- deepseek-v3-671b at full width (d_model 7,168, 128
                heads, MLA with q_lora_rank 1,536, kv_lora_rank 512,
                qk_nope_dim 128, qk_rope_dim 64, v_head_dim 128; 256
                experts of 2,048 at top 8, sigmoid scoring, 1 shared
                expert; a dense d_ff of 18,432; vocab 129,280; the MTP
                head; f32, seeded weights at the init's std) cut to 2 of 61
                layers, one dense and one MoE (14,630,392,832 params), its
                spread checked first (``phi_spread``); MLA runs no kernel of
                the port, so every attention kernel launches 0 times in
                (a)-(b).  (a) 8 requests of 64..448 prompt tokens and 32
                new, capacity 8, max_len 512, K 8, buckets of 16, at the
                published capacity factor 1.25 (prefills drop choices,
                counted): the dense latent pool and a 32-page one, f32
                (paged == dense exactly) and, after (b), bf16 (weights cast
                leaf by leaf; a parting excused only by phase 19's bf16
                rule); latent pool bytes a token a layer against the
                expanded K/V's.  (b) capacity factor 32 = E / K (nothing
                drops): 4 requests of 96 and 40 prompt tokens (the last 3
                open on the first's first 32) and 24 new, capacity 4,
                max_len 128 (pages of 8): the dense pool, a 24-page pool
                (hits, misses, refusals, prefills, macro-steps, tail steps
                and the pages high-water as a CPU run of the schedule
                predicts), the target's dense layer drafting (its own
                tensors, no copy; d 4, K 2) on both pools (acceptance
                strictly inside (0, 1)), ``generate`` at B 1 and the plain
                route on the first 2: every run == the dense run up to
                reported near ties.  (c) deepseek-v3-671b-smoke grown into
                4 x 128 by rank-1 Mango after 5 operator steps (the
                sandwich on the MLA matrices and expert slots exactly as a
                CPU run counts; the plain route's params; the margin).  (d)
                deepseek-v3-671b cut to its dense layer with the MTP head
                (3,123,106,816 params) trained 2 AdamW steps at B 1 x S
                256: loss, ce and mtp, ms/step against the bytes and f32
                FLOP bounds, peak memory.
 21. qwen2-vl -- qwen2-vl-72b at full width (d_model 8,192, 64 heads over
                8 KV heads of 128, d_ff 29,568, vocab 152,064, qkv bias,
                M-RoPE sections (16, 24, 24) at theta 1e6; f32, seeded
                weights at the init's std) cut to 2 of 80 layers
                (4,246,794,240 params), its spread checked first
                (``phi_spread``); one M-RoPE rotation at three distinct
                position streams on the card against the CPU (serving
                builds three equal streams, 1-D RoPE exactly); each
                attention kernel against its plain version at this
                phase's shapes (G 8; f32 and bf16); then phase 19b's
                geometry (8 requests of 64..448 prompt tokens, the last 4
                opening on one 256-token prefix, 64 new, capacity 8,
                max_len 512, K 8): the dense pool, a 32-page pool (hits,
                misses, refusals, prefills, macro-steps, tail steps and
                the pages high-water as a CPU run of the schedule
                predicts), a copy nudged by 1e-3 of each leaf's std
                drafting (d 4, K 2) on both pools (acceptance strictly
                inside (0, 1)), ``generate`` at B 1 and the plain route on
                the first 2: every run == the dense run, and the first 2
                == the plain route, near ties reported; at least 64
                distinct tokens of the dense run's 512; exact launches of
                the six attention kernels; then the dense pool in bf16
                (weights cast leaf by leaf after the draft is gone), its
                first 2 requests == the same route replayed with plain
                attention in bf16 but at a gap of at most two bf16 ulps.
                Tok/s, acceptance, pool bytes and peak memory beside the
                card's name and power limit.
 22. hubert  -- hubert-xlarge at full width and depth (48 x 1,280, 16
                heads of 80, frames 1,280 wide, 504 units, non-causal,
                learned positions; 988,193,280 params, f32, seeded
                weights): (a) 3 in-place AdamW steps at B 2 x S 512 on the
                train launcher's frames batches (no kernel launches: the
                uncached non-causal forward takes plain attention):
                finite losses, ms/step against the f32 FLOP bound, peak
                memory; (b) grown into from its half (24 x 640, 8 heads of
                80, d_ff 2,560), pretrained 40 steps, by rank-1 Mango
                after 5 operator steps at lr 1e-4 on B 2 x S 256 frames:
                the sandwich launched exactly as a CPU run counts, the
                plain route's params within 1e-5 of a leaf's largest
                entry, and a positive held-out margin scratch - grown
                after equal steps (the scratch model trained 5 steps).

Phase 3 also holds the scan's backward kernel against autograd through the
scan's plain version (recurrentgemma-2b's training shape, f32 and bf16,
with and without h0, and widths off 16 bytes), and every attention kernel
at head dims 16, 20, 32 and 80 in both dtypes with done rows, timed beside
its bound and SDPA.  Phase 12 also runs ``serve_continuous`` and
``serve_batched`` on the card (tokens == a CPU run of each example on the
same weights).  Phase 9 also checks recurrentgemma-2b's bf16 route (prefill
and 8 decode steps) against f32 on the same bf16-cast weights: within 2x
the bf16 plain route's error.

Each traced run prints the device time of each of the port's kernels.
Each path's launch counters are set to 0 just before it runs and read just
after; a kernel of the path that was never launched fails the run.  The
line before the last is the kernels JSON (``launches_p19``: phase 19's
launches of each kernel it runs; ``launches_p20``: phase 20's, the
sandwich's, as MLA launches no attention kernel; ``launches_p21``: phase
21's, of the six attention kernels; ``launches_p22``: phase 22's, the
sandwich's); the last line is
``{"ok": true, "device": {...}}``.  Without CUDA, or without the package
beside this file, it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
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


def _sync():
    """Wait for the card where there is one (a CPU rehearsal has none)."""
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


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
    rows.update(run_chunk_cases(gen))
    rows.update(run_paged_cases(gen))
    rows.update(run_griffin_cases(gen))
    rows.update(run_scan_bwd_cases(gen))
    run_head_dims(rows, gen)
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


def nan_outside_bands(k, v, offs, cap, window, bt=None):
    """Copies of a ring cache's k, v -- page arenas (n_pages, page, KV, hd)
    read through the block tables ``bt`` (on the host), or a dense (B, cap,
    KV, hd) cache -- with NaN in every row that no row's band [max(off -
    cap, off - window + 1, 0), off) reads (sentinel entries clamp to the
    last page), and the count of such rows.  The ring verify stages some
    of them (a tile's positions below its band's first): they must add
    nothing."""
    import torch

    n_pages, page = k.shape[:2]
    keep = torch.zeros(k.shape[:2], dtype=torch.bool)
    for b, o in enumerate(offs):
        lo = max(o - cap, o - window + 1 if window else 0, 0)
        slots = torch.arange(lo, max(lo, o)) % cap
        if bt is None:
            keep[b, slots] = True
        else:
            pages = bt[b, slots // page].long().clamp(0, n_pages - 1)
            keep[pages, slots % page] = True
    keep = keep.to(k.device)
    kn, vn = k.clone(), v.clone()
    kn[~keep] = float("nan")
    vn[~keep] = float("nan")
    return kn, vn, int((~keep).sum())


def ring_split_ms(name, call, q, KV, cap):
    """{pieces: (ms, clusters the card holds at once)} of the ring verify's
    ``call`` with each band cut into 1, 2, 3 and 4 pieces (the plan cuts
    as many as keep every band's cluster resident)."""
    from repro_torch.kernels import decode_attention as kda

    plan = kda.ring_verify_splits
    hd = q.shape[-1]
    out = {}
    for n in (1, 2, 3, 4):
        def forced(bands, span, n_sm, per_sm, clusters, n=n):
            chunk = -(-(-(-span // n)) // kda.PAGED_TILE) * kda.PAGED_TILE
            return chunk, -(-span // chunk)
        kda.ring_verify_splits = forced
        out[n] = (time_ms(call, 40), kda._ring_clusters(
            name.split("[")[0], q.device, q.dtype, hd, n))
    kda.ring_verify_splits = plan
    print(f"{name}: ms (clusters resident) by pieces a band "
          f"{ {n: (round(ms, 4), c) for n, (ms, c) in out.items()} }; "
          f"{q.shape[0] * KV} bands", flush=True)
    return out


def check_nan_outside_bands(name, label, got, fn, n_nan):
    """The ring verify's output with NaN planted outside every band
    (``fn()``) equals its output without, bit for bit, and is finite."""
    import torch

    with_nan = fn()
    torch.cuda.synchronize()
    if not (torch.equal(with_nan, got) and bool(torch.isfinite(with_nan).all())):
        raise AssertionError(f"{name} [{label}]: NaN in {n_nan} cache rows "
                             "outside every band reached the output")
    return n_nan


def chunk_cases():
    """(label, L, B, S, H, KV, Sc, hd, dtype, ring, window, offsets): the
    speculative path's two shapes first -- gpt-base's verify and gpt-small's
    catch-up, d 4 at capacity 8 over max_len 1024, one done row -- then
    phase 17's verify in the ring layout (the ``[ring]`` row: qwen3-0.6b's
    16 heads over 8 KV heads of 128, a ring of 1,088, window 1,025), then
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
        ("qwen3-0.6b window ring f32", 4, 8, 5, 16, 8, 1088, 128, f32, True,
         1025, WIN_RING_OFFSETS),
        ("qwen3-0.6b window ring bf16", 4, 8, 5, 16, 8, 1088, 128, bf16,
         True, 1025, WIN_RING_OFFSETS),
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
    full-layout case (gpt-base's verify) is the kernels-line row
    ``chunk_verify_attention``, the first ring-layout case (phase 17's
    shape) ``chunk_verify_attention[ring]``."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention, ref

    cv_fn = decode_attention.chunk_verify_attention
    rows = {}
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
        nan_rows = None
        if ring:
            kn, vn, nan_rows = nan_outside_bands(ckp[0], cvp[0], offs, Sc,
                                                 window)
            check_nan_outside_bands(
                "chunk_verify_attention", label, got,
                lambda: cv_fn(q, kn, vn, kc, vc, off, **kw), nan_rows)
            del kn, vn
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
            q, KV, Sc, window, "chunk_verify_attention", ring)
        case["nan_rows_outside_bands"] = nan_rows
        name = "chunk_verify_attention" + ("[ring]" if ring else "")
        if name not in rows:
            rows[name] = dict(
                name=name, route="cuda",
                source="src/repro_torch/kernels/csrc/chunk_verify_attention.cu",
                replaces="src/repro/kernels/decode_attention.py:595",
                cases=[], **{key: case[key] for key in (
                    "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "shape")})
        rows[name]["cases"].append(case)
        nan = ("" if nan_rows is None else
               f", TMA boxes {decode_attention.ring_verify_box(Sc, hd, item)}"
               f", NaN in {nan_rows} rows outside the bands added nothing")
        print(f"chunk_verify_attention [{label}] {case['shape']}: max abs "
              f"err {err:.3g}{nan}, pieces {case['splits']}; kernel "
              f"{case['ms']:.4f} ms, plain "
              f"{case['plain_ms']:.4f} ms, library {case['library_ms']:.4f} "
              f"ms, bound {b_ms:.4f} ms ({b_by})", flush=True)
        del k_all, v_all, ckp, cvp
    return rows


# phase 17's verify: B 8, S 5 (d 4), qwen3-0.6b's 16 heads over 8 KV heads
# of 128, a ring of 1,088 (window 1,025) in pages of 64, offsets of its
# requests near their end (prompts of 1,100..1,600 and 64 new tokens)
WIN_RING_OFFSETS = [1105, 1180, 1290, 1305, 1320, 1335, 1450, 1600]


def paged_cases(gen):
    """Phase 3's paged cases: (kernel, label, L, B, S, H, KV, hd, n_pages,
    page, nblk, dtype, lens, window), gpt-base's shapes first, then the
    full layout at the ring's shape and band length (the yardstick), then
    the verify's ring layout ("ring"): phase 17's shape in f32 and bf16,
    hd 64 and an in-bucket hd 80 with done rows and offsets that wrap the
    ring up to eight times, and pages of 24 (a ring of 264, not a multiple
    of 32: every tile copied a row at a time).  Tables are a seeded permutation of the arena's
    pages (not contiguous), and blocks inside a row's attended range hold
    the sentinel (a draft past its budget reads through it)."""
    import torch

    f32, bf16 = torch.float32, torch.bfloat16
    kv_lens = [0, 97, 200, 333, 451, 576, 800, 1024]
    spread = [-1, 64, 137, 210, 283, 356, 430, 576]
    wrap = [-1, 0, 100, 255, 256, 700, 1024, 1999]
    return [
        ("slot", "gpt-base paged f32", 12, 8, 1, 12, 12, 64, 128, 64, 16,
         f32, kv_lens, None),
        ("slot", "gpt-small paged f32", 12, 8, 1, 8, 8, 64, 128, 64, 16, f32,
         kv_lens, None),
        ("slot", "gpt-base paged bf16", 2, 8, 1, 12, 12, 64, 128, 64, 16,
         bf16, kv_lens, None),
        ("chunk", "gpt-base verify paged f32", 12, 8, 5, 12, 12, 64, 128, 64,
         16, f32, spread, None),
        ("chunk", "gpt-small catch-up paged f32", 12, 8, 5, 8, 8, 64, 128, 64,
         16, f32, spread, None),
        ("chunk", "gpt-base verify paged bf16", 2, 8, 5, 12, 12, 64, 128, 64,
         16, bf16, spread, None),
        ("chunk", "gpt-base verify S 17 paged f32", 2, 8, 17, 12, 12, 64, 128,
         64, 16, f32, spread, None),
        # the yardstick: the full layout at the ring's shape and band length
        # (1,024 cache positions and 5 chunk keys a row, TMA boxes)
        ("chunk", "yardstick full layout at the ring's shape f32", 4, 8, 5,
         16, 8, 128, 136, 64, 17, f32, [1024] * 8, None),
        ("chunk", "yardstick full layout at the ring's shape bf16", 4, 8, 5,
         16, 8, 128, 136, 64, 17, bf16, [1024] * 8, None),
        ("ring", "qwen3-0.6b window ring f32", 4, 8, 5, 16, 8, 128, 136, 64,
         17, f32, WIN_RING_OFFSETS, 1025),
        ("ring", "qwen3-0.6b window ring bf16", 4, 8, 5, 16, 8, 128, 136, 64,
         17, bf16, WIN_RING_OFFSETS, 1025),
        ("ring", "ring hd 64 G 2 wrap f32", 1, 8, 5, 4, 2, 64, 29, 64, 4, f32,
         wrap, 200),
        ("ring", "ring hd 64 G 2 wrap bf16", 1, 8, 5, 4, 2, 64, 29, 64, 4,
         bf16, wrap, 200),
        ("ring", "ring hd 80 G 4 wrap f32", 1, 8, 9, 16, 4, 80, 37, 32, 8, f32,
         wrap, None),
        ("ring", "ring hd 80 G 4 wrap bf16", 1, 8, 9, 16, 4, 80, 37, 32, 8,
         bf16, wrap, None),
        # pages of 24: a ring of 264 (not a multiple of 32)
        ("ring", "ring page 24 cap 264 f32", 1, 8, 5, 8, 2, 64, 90, 24, 11,
         f32, [-1, 0, 100, 263, 264, 700, 1024, 1999], 100),
    ]


def run_paged_cases(gen):
    """Phase 3 for the two paged kernels and the verify's ring layout:
    every case against its plain version (``check_close``; done rows exact
    zeros), then timed beside its bound, the plain version and SDPA over
    K/V gathered from the arena ahead of the timing.  The first case of
    each kernel (and of the ring layout) is its kernels-line row."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention, ref

    names = {"slot": "paged_slot_decode_attention",
             "chunk": "paged_chunk_verify_attention",
             "ring": "paged_chunk_verify_attention[ring]"}
    rows = {}
    for (kind, label, L, B, S, H, KV, hd, n_pages, page, nblk, dt,
         lens, window) in paged_cases(gen):
        def rnd(*s):
            return torch.randn(*s, generator=gen, device="cuda").to(dt)
        perm = torch.randperm(n_pages, generator=torch.Generator().manual_seed(
            n_pages + B), dtype=torch.int32)
        bt = perm[:B * nblk].reshape(B, nblk) if B * nblk <= n_pages else \
            perm[torch.arange(B * nblk) % n_pages].reshape(B, nblk)
        if kind == "ring":  # rows 3 and 6 wrap past these blocks
            bt[3, 1] = bt[6, nblk - 1] = n_pages
        else:
            bt[7, 6] = n_pages  # row 7 attends blocks 0..9 or all 16
        bt = bt.contiguous().cuda()
        ka, va = rnd(L, n_pages, page, KV, hd), rnd(L, n_pages, page, KV, hd)
        ln = torch.tensor(lens, dtype=torch.int32, device="cuda")
        dname = str(dt).split(".")[1]
        name = names[kind]
        item = ka.element_size()
        cap = nblk * page
        if kind == "slot":
            fn = decode_attention.paged_slot_decode_attention
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
            fn = decode_attention.paged_chunk_verify_attention
            ring = kind == "ring"
            kw = dict(ring=ring, window=window)
            q, kc, vc = rnd(B, S, H, hd), rnd(B, S, KV, hd), rnd(B, S, KV, hd)

            def kern(j):
                return fn(q, ka[j], va[j], bt, kc, vc, ln, **kw)

            def plain(j):
                return ref.paged_chunk_verify_attention_ref(
                    q, ka[j], va[j], bt, kc, vc, ln, **kw)
            n_keys = 0
            for o in lens:  # each row's attended positions and its chunk
                if o >= 0:
                    lo = max(0, o - cap) if ring else 0
                    if window:
                        lo = max(lo, o - window + 1)
                    n_keys += (o if ring else min(o, cap)) - lo + S
            qkv = 2 * B * S * H * hd * item
            steps = torch.arange(S, device="cuda")[None]
            if ring:
                kpos_c = ref._ring_kpos(ln, cap)
            else:
                pos = torch.arange(cap, device="cuda")[None]
                kpos_c = torch.where(pos < ln[:, None], pos, -1)
            kpos = torch.cat([kpos_c, ln[:, None] + steps], 1)
            qpos = ln[:, None] + steps
            mask = (kpos[:, None] >= 0) & (kpos[:, None] <= qpos[:, :, None])
            if window:
                mask &= kpos[:, None] > qpos[:, :, None] - window
            mask = mask[:, None]
            qt = q.transpose(1, 2)
        got = kern(0)
        torch.cuda.synchronize()
        err = check_close(f"{name} [{label}]", got, plain(0), dname)
        done_rows = (ln == 0) if kind == "slot" else (ln < 0)
        if not bool((got[done_rows] == 0).all()):
            raise AssertionError(f"{name} [{label}]: rows with kv_len 0 / "
                                 "offset -1 are not exact zeros")
        nan_rows = None
        if kind == "ring":
            kn, vn, nan_rows = nan_outside_bands(ka[0], va[0], lens, cap,
                                                 window, bt.cpu())
            check_nan_outside_bands(
                name, label, got,
                lambda: fn(q, kn, vn, bt, kc, vc, ln, **kw), nan_rows)
            del kn, vn
        b_ms, b_by = bound_ms(
            n_keys * KV * hd * 2 * item + qkv + 4 * B * nblk + 4 * B,
            4 * n_keys * H * hd * (1 if kind == "slot" else S), dname)
        # library yardstick: SDPA over each layer's K/V gathered from the
        # arena (and, for a verify, the chunk appended) ahead of the timing
        k_all, v_all = [], []
        for j in range(L):
            kd = ref._paged_gather_ref(ka[j], bt)
            vd = ref._paged_gather_ref(va[j], bt)
            if kind != "slot":
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
                   + (f"ring {cap} window {window} " if kind == "ring" else "")
                   + f"{'kv_len' if kind == 'slot' else 'offsets'} {lens}"))
        # the band's pieces: (positions, a cluster of); a verify's rows a
        # tile and tiles first
        case["splits"] = (
            decode_attention._paged_splits(name, q, KV, cap)
            if kind == "slot" else
            decode_attention._verify_plan(q, KV, cap, window,
                                          ring=kind == "ring"))
        case["nan_rows_outside_bands"] = nan_rows
        split = f", pieces {case['splits']}"
        if kind == "ring":
            case["tma_boxes"] = decode_attention.ring_verify_box(page, hd,
                                                                 item)
            split += f", TMA boxes {case['tma_boxes']}"
        if kind == "ring" and name not in rows:  # phase 17's shape
            case["split_ms"] = ring_split_ms(
                name, lambda: kern(next(layers) % L), q, KV, cap)
        if nan_rows is not None:
            split += (f", NaN in {nan_rows} rows outside the bands added "
                      "nothing")
        print(f"{name} [{label}] {case['shape']}: max abs err {err:.3g}"
              f"{split}; kernel {case['ms']:.4f} ms, plain "
              f"{case['plain_ms']:.4f} ms, library {case['library_ms']:.4f} "
              f"ms, bound {b_ms:.4f} ms ({b_by})", flush=True)
        del k_all, v_all, ka, va
        if name not in rows:
            rows[name] = dict(
                name=name, route="cuda",
                source=("src/repro_torch/kernels/csrc/"
                        f"{name.split('[')[0]}.cu"),
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



def scan_grads(fn, a, b, h0, g):
    """Gradients of sum(fn(a, b, h0) * g) with respect to a, b (and h0)."""
    import torch

    ins = [a.clone().requires_grad_(), b.clone().requires_grad_()] + (
        [] if h0 is None else [h0.clone().requires_grad_()])
    with torch.enable_grad():
        out = fn(ins[0], ins[1], None if h0 is None else ins[2])
        return torch.autograd.grad(out, ins, g)


def run_scan_bwd_cases(gen):
    """Phase 3 for the scan's backward (no Pallas site: JAX differentiates
    ``lax.associative_scan``): recurrentgemma-2b's training shape (B 2, S
    512, W 2560) first (the kernels-line row), f32 and bf16, without and
    with h0, the admission shape, and widths off 16 bytes (the per-lane
    path).  Through ``ops.rglru_scan`` under autograd (one forward and one
    backward launch a case) against autograd through
    ``ref.rglru_scan_ref``: f32 within 1e-5 relative (and the plain
    backward bit for bit), bf16 at most twice the plain bf16 route's error
    against an f32 route.  Timed alone on the forward's f32 h beside its
    byte bound and the plain backward; no one-call library counterpart."""
    import torch

    from repro_torch.kernels import ops, ref, rglru_scan

    bwd, fwd = rglru_scan.rglru_scan_bwd, rglru_scan.rglru_scan
    f32, bf16 = torch.float32, torch.bfloat16
    row = None
    for label, B, S, W, dt, with_h0 in (
            ("recurrentgemma-2b train f32", 2, 512, 2560, f32, False),
            ("recurrentgemma-2b train bf16", 2, 512, 2560, bf16, False),
            ("train shape with h0 f32", 2, 512, 2560, f32, True),
            ("train shape with h0 bf16", 2, 512, 2560, bf16, True),
            ("admission shape f32", 8, 4096, 2560, f32, True),
            ("off 16 bytes f32", 2, 300, 99, f32, True),
            ("off 16 bytes bf16", 3, 37, 50, bf16, False)):
        dname = str(dt).split(".")[1]
        a = (torch.rand(B, S, W, generator=gen, device="cuda") * 0.5
             + 0.5).to(dt)
        b = (0.1 * torch.randn(B, S, W, generator=gen, device="cuda")).to(dt)
        g = torch.randn(B, S, W, generator=gen, device="cuda").to(dt)
        h0 = (torch.randn(B, W, generator=gen, device="cuda") if with_h0
              else None)
        n0 = (fwd.launches, bwd.launches)
        got = scan_grads(ops.rglru_scan, a, b, h0, g)
        torch.cuda.synchronize()
        if (fwd.launches - n0[0], bwd.launches - n0[1]) != (1, 1):
            raise AssertionError(f"rglru_scan_bwd [{label}]: the gradient "
                                 "did not launch one forward and one "
                                 "backward")
        plain = scan_grads(ref.rglru_scan_ref, a, b, h0, g)
        h32 = ref.rglru_scan_ref(a.float(), b.float(), h0)
        if dt == f32:
            errs = [((x - y).abs() / y.abs().clamp_min(1e-30)).max().item()
                    for x, y in zip(got, plain)]
            err = max((x - y).abs().max().item() for x, y in zip(got, plain))
            want = ref.rglru_scan_bwd_ref(a, g, h32, h0)
            exact = all(torch.equal(x, y) for x, y in zip(got, want))
            if max(errs) > 1e-5 or not exact:
                raise AssertionError(f"rglru_scan_bwd [{label}]: relative "
                                     f"err {max(errs):.3g} against autograd "
                                     f"(1e-5), bit-equal to the plain "
                                     f"backward: {exact}")
            note = f"max relative err {max(errs):.3g}, plain backward bit " \
                "for bit"
        else:
            ref32 = scan_grads(ref.rglru_scan_ref, a.float(), b.float(), h0,
                               g.float())
            err = plain_err = 0.0
            for x, y, z in zip(got, plain, ref32):
                err = max(err, (x.float() - z).abs().max().item())
                plain_err = max(plain_err, (y.float() - z).abs().max().item())
            if err > 2 * plain_err + 1e-6:
                raise AssertionError(f"rglru_scan_bwd [{label}]: err {err:.3g}"
                                     f" against the f32 route, over twice "
                                     f"the plain bf16 route's {plain_err:.3g}")
            note = (f"max abs err against the f32 route {err:.3g} (plain "
                    f"bf16 route {plain_err:.3g})")
        item = a.element_size()
        b_ms, b_by = bound_ms(
            (4 * item + 4) * B * S * W + (0 if h0 is None else 8 * B * W),
            3 * B * S * W, dname)
        case = dict(label=label, dtype=dname, max_abs_err=err,
                    ms=time_ms(lambda: bwd(a, g, h32, h0), 10),
                    plain_ms=time_ms(
                        lambda: ref.rglru_scan_bwd_ref(a, g, h32, h0), 2),
                    bound_ms=b_ms, bound_by=b_by, library_ms=None,
                    shape=f"a, g ({B}, {S}, {W}) {dname} h0 {with_h0}",
                    plan=rglru_scan.scan_plan(
                        B, S, W, item, torch.cuda.get_device_properties(0)
                        .multi_processor_count, bwd=True))
        print(f"rglru_scan_bwd [{label}] {case['shape']}: {note}; plan "
              f"(steps, blocks) {case['plan']}; kernel {case['ms']:.4f} ms, "
              f"plain {case['plain_ms']:.4f} ms, no library call, bound "
              f"{b_ms:.4f} ms ({b_by})", flush=True)
        del a, b, g, h32, got, plain
        if row is None:
            row = dict(name="rglru_scan_bwd", route="cuda",
                       source="src/repro_torch/kernels/csrc/rglru_scan.cu",
                       replaces=("none: no Pallas site; JAX differentiates "
                                 "lax.associative_scan "
                                 "(src/repro/models/griffin.py:154)"),
                       cases=[], **{key: case[key] for key in (
                           "max_abs_err", "ms", "plain_ms", "bound_ms",
                           "bound_by", "library_ms", "shape")})
        row["cases"].append(case)
    return {"rglru_scan_bwd": row}


HEAD_DIMS = (16, 20, 32, 80)  # the repo's configs' head dims in buckets


def head_dim_case(kind, hd, dt, gen):
    """(call, plain, library, done, nbytes, flops) of one attention kernel
    at head dim ``hd``: 8 rows (one done or idle), 8 query heads over 2 KV
    heads, 512 positions (a 256-position ring); the library call is SDPA
    over the same K/V (gathered for the paged kinds) with the band's
    mask."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as kd
    from repro_torch.kernels import flash_attention, ref

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dt)

    B, H, KV, S, item = 8, 8, 2, 512, torch.finfo(dt).bits // 8
    dev = "cuda"
    if kind == "flash_attention":
        B = 2
        q = rnd(B, S, H, hd).transpose(1, 2)
        k, v = (rnd(B, S, KV, hd).transpose(1, 2) for _ in range(2))
        return (lambda: flash_attention.flash_attention(q, k, v),
                lambda: ref.flash_attention_ref(q, k, v),
                lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=True),
                None, 2 * B * (H + KV) * S * hd * item,
                2 * B * H * S * S * hd)
    page, nblk = 64, S // 64
    paged = kind.startswith("paged")
    perm = torch.randperm(B * nblk + 3, generator=torch.Generator()
                          .manual_seed(hd), dtype=torch.int32)
    bt = perm[:B * nblk].reshape(B, nblk).contiguous().to(dev)
    if "ring" in kind:
        ring, window = 256, 200
        nblk_r = ring // page
        bt = bt[:, :nblk_r].contiguous()
        pos = torch.tensor([-1, 0, 37, 199, 255, 256, 600, 1000],
                           dtype=torch.int32, device=dev)
        q = rnd(B, H, hd)
        if paged:
            k, v = (rnd(B * nblk + 3, page, KV, hd) for _ in range(2))
            kg, vg = (ref._paged_gather_ref(t, bt) for t in (k, v))
            call = (lambda: kd.paged_ring_decode_attention(
                q, k, v, bt, pos, window=window))
            plain = (lambda: ref.paged_ring_decode_attention_ref(
                q, k, v, bt, pos, window=window))
        else:
            k, v = (rnd(B, ring, KV, hd) for _ in range(2))
            kg, vg = k, v
            call = lambda: kd.ring_decode_attention(q, k, v, pos,  # noqa
                                                    window=window)
            plain = (lambda: ref.ring_decode_attention_ref(
                q, k, v, pos, window=window))
        kpos = ref._ring_kpos(pos + 1, ring)
        mask = ((kpos >= 0) & (kpos > pos[:, None] - window)
                & (pos[:, None] >= 0))
        n_keys = int(mask.sum())
        kh, vh = kg.transpose(1, 2), vg.transpose(1, 2)
        lib = (lambda: F.scaled_dot_product_attention(
            q[:, :, None], kh, vh, attn_mask=mask[:, None, None],
            enable_gqa=True))
        return (call, plain, lib, pos < 0,
                2 * n_keys * KV * hd * item + 2 * B * H * hd * item,
                4 * n_keys * H * hd)
    if "verify" in kind:
        Sq = 5
        off = torch.tensor([-1, 0, 1, 30, 100, 300, 507, 512],
                           dtype=torch.int32, device=dev)
        q = rnd(B, Sq, H, hd)
        kc, vc = (rnd(B, Sq, KV, hd) for _ in range(2))
        if paged:
            ck, cv = (rnd(B * nblk + 3, page, KV, hd) for _ in range(2))
            cg, vgc = (ref._paged_gather_ref(t, bt) for t in (ck, cv))
            call = (lambda: kd.paged_chunk_verify_attention(
                q, ck, cv, bt, kc, vc, off, ring=False))
            plain = (lambda: ref.paged_chunk_verify_attention_ref(
                q, ck, cv, bt, kc, vc, off, ring=False))
        else:
            ck, cv = (rnd(B, S, KV, hd) for _ in range(2))
            cg, vgc = ck, cv
            call = (lambda: kd.chunk_verify_attention(
                q, ck, cv, kc, vc, off, ring=False))
            plain = (lambda: ref.chunk_verify_attention_ref(
                q, ck, cv, kc, vc, off, ring=False))
        kk = torch.cat([cg, kc], 1).transpose(1, 2)
        vv = torch.cat([vgc, vc], 1).transpose(1, 2)
        i = torch.arange(Sq, device=dev)
        cache = torch.arange(S, device=dev)[None, None] < off[:, None, None]
        chunk = (i[None, :, None] >= i[None, None, :]) & (off >= 0)[
            :, None, None]
        mask = torch.cat([cache.expand(B, Sq, S), chunk.expand(B, Sq, Sq)],
                         -1)
        n_keys = int(off.clamp(0, S).sum()) + Sq * int((off >= 0).sum())
        return (call, plain,
                lambda: F.scaled_dot_product_attention(
                    q.transpose(1, 2), kk, vv, attn_mask=mask[:, None],
                    enable_gqa=True),
                off < 0, n_keys * KV * hd * 2 * item + 2 * B * Sq * H * hd
                * item, 4 * n_keys * Sq * H * hd)
    # slot, decode_attention, paged slot: kv_len with a 0 (idle) row
    kv_len = torch.tensor([0, 1, 31, 64, 200, 333, 511, 512],
                          dtype=torch.int32, device=dev)
    q = rnd(B, H, hd)
    if paged:
        k, v = (rnd(B * nblk + 3, page, KV, hd) for _ in range(2))
        kg, vg = (ref._paged_gather_ref(t, bt) for t in (k, v))
        call = lambda: kd.paged_slot_decode_attention(q, k, v, bt,  # noqa
                                                      kv_len)
        plain = (lambda: ref.paged_slot_decode_attention_ref(q, k, v, bt,
                                                             kv_len))
    elif kind == "decode_attention":
        pool = [rnd(B, S, KV, hd) for _ in range(2)]
        k, v = (t.transpose(1, 2) for t in pool)  # the pool's view
        kg, vg = pool
        call = lambda: kd.decode_attention(q, k, v, kv_len)  # noqa
        plain = lambda: ref.decode_attention_ref(q, k, v, kv_len)  # noqa
    else:
        k, v = (rnd(B, S, KV, hd) for _ in range(2))
        kg, vg = k, v
        call = lambda: kd.slot_decode_attention(q, k, v, kv_len)  # noqa
        plain = lambda: ref.slot_decode_attention_ref(q, k, v,  # noqa
                                                      kv_len)
    mask = torch.arange(S, device=dev)[None] < kv_len[:, None]
    kh, vh = kg.transpose(1, 2), vg.transpose(1, 2)
    n_kv = int(kv_len.sum())
    return (call, plain,
            lambda: F.scaled_dot_product_attention(
                q[:, :, None], kh, vh, attn_mask=mask[:, None, None],
                enable_gqa=True),
            kv_len <= 0, 2 * n_kv * KV * hd * item + 2 * B * H * hd * item,
            4 * n_kv * H * hd)


def run_head_dims(rows, gen):
    """Phase 3: each attention kernel at head dims 16, 20, 32 and 80 (run
    in the 64 and 128 buckets; 20 in bf16 has 40-byte rows, which the
    bodies copy a row at a time) in float32 and bfloat16, with done or
    idle rows (exact zeros), held against its plain version and timed
    beside its bound and SDPA; each kernel's row gets ``head_dims``."""
    import torch

    kinds = ("flash_attention", "slot_decode_attention", "decode_attention",
             "chunk_verify_attention", "ring_decode_attention",
             "paged_slot_decode_attention", "paged_ring_decode_attention",
             "paged_chunk_verify_attention")
    for kind in kinds:
        cases = []
        for hd in HEAD_DIMS:
            for dt in (torch.float32, torch.bfloat16):
                dname = str(dt).split(".")[1]
                call, plain, lib, done, nbytes, flops = head_dim_case(
                    kind, hd, dt, gen)
                got = call()
                torch.cuda.synchronize()
                err = check_close(f"{kind} [hd {hd} {dname}]", got, plain(),
                                  dname)
                if done is not None and not bool((got[done] == 0).all()):
                    raise AssertionError(f"{kind} [hd {hd} {dname}]: done "
                                         "rows are not exact zeros")
                b_ms, b_by = bound_ms(nbytes, flops, dname)
                cases.append(dict(hd=hd, dtype=dname, max_abs_err=err,
                                  ms=time_ms(call, 20),
                                  library_ms=time_ms(lib, 20),
                                  bound_ms=b_ms, bound_by=b_by))
        rows[kind]["head_dims"] = cases
        print(f"{kind} head dims: " + "; ".join(
            f"hd {c['hd']} {c['dtype'][:4]} err {c['max_abs_err']:.2g} "
            f"{c['ms']:.4f} ms (SDPA {c['library_ms']:.4f}, bound "
            f"{c['bound_ms']:.4f})" for c in cases), flush=True)

def timed_run(eng, reqs):
    """Serve fresh copies of ``reqs`` on ``eng`` between two device syncs.
    Returns (outputs, seconds, tokens/s, admissions refused for want of
    pages); fails if a request is missing or was rejected."""
    import dataclasses

    waits = []  # admissions refused for want of pages (backpressure)
    alloc = eng._alloc_request

    def counted(req):
        info = alloc(req)
        waits.append(info is None)
        return info
    eng._alloc_request = counted
    _sync()
    t0 = time.perf_counter()
    try:
        out = eng.run([dataclasses.replace(r) for r in reqs])
        _sync()
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

    seq = torch.tensor(prompt, dtype=torch.int32,
                       device=next(_leaves(params)).device)[None]
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


# phase 4 holds the engine's and generate's tokens of its first 4 requests
# against the plain route (all 16 until PR 29, cut to make room for phase
# 19; phase 7 holds its own dense and paged engines on 16 requests)
SERVE_PLAIN_REQS = 4


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
    plain = {r.uid: plain_greedy(cfg, params, r.prompt, 64)
             for r in reqs[:SERVE_PLAIN_REQS]}
    plain_s = time.perf_counter() - t0
    if {name: fn.launches for name, fn in kern.items()} != before:
        raise AssertionError("the plain reference launched a CUDA kernel")
    near_ties = {"engine": [], "generate": []}
    gen_launches = []
    for r in reqs:
        got = out[r.uid]
        if got.shape != (64,) or got.min() < 0 or got.max() >= cfg.vocab_size:
            raise AssertionError(f"uid {r.uid}: bad output {got}")
        if r.uid not in plain:
            continue
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
    exact = {what: len(plain) - len(t) for what, t in near_ties.items()}
    print(f"tokens == plain route (full forward, no kernel; {plain_s:.1f} s) "
          f"for {exact['engine']}/{len(plain)} requests from the engine (of "
          f"{len(reqs)}) and {exact['generate']}/{len(plain)} from generate; "
          f"near-tie "
          f"divergences: {near_ties}; decode_attention launches per "
          f"generate call {sorted(set(gen_launches))} (12 x 63)", flush=True)
    report = dict(tok_per_s=n_tok / dt, seconds=dt, tokens=n_tok,
                  host_syncs_per_token=eng.n_host_syncs / n_tok,
                  peak_mib=peak / 2**20, launches=launches,
                  generate_decode_attention_launches=gen_launches,
                  exact_requests=exact, near_ties=near_ties)
    # the device only: phase 7's paged run traces the engine's stages
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


def profile_serve(make_engine, reqs, untraced_wall, stages=()):
    """A second, traced run of the same requests under torch.profiler:
    device busy time, host time per engine stage (``stages``, engine
    methods; phase 7 names them), and the kernels that take the device
    time.  Tracing slows the host, so the idle share is given against both
    the traced wall time and the untraced run's.  ``decode_steps`` counts
    K per dispatch: decode steps, or speculative blocks.  With no
    ``stages`` only the device is traced: the host's events are what
    makes reading a trace of a quarter million device ops take minutes."""
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
    beside the plain engine on the same requests (plain, then
    speculative: one run each, the second pair cut to make room for
    phases 21-22); then gpt-base drafting for itself."""
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
        tok_per_s=tps_spec, plain_engine_tok_per_s=tps_plain_a, seconds=dt,
        tokens=n_tok, acceptance_rate=eng.acceptance_rate,
        n_spec_proposed=eng.n_spec_proposed,
        n_spec_accepted=eng.n_spec_accepted,
        tokens_per_target_verify=decode_tokens / blocks,
        host_syncs_per_token=eng.n_host_syncs / n_tok,
        peak_mib=peak / 2**20, launches=launches)
    print(f"speculative: {len(out)} requests / {n_tok} tokens in {dt:.3f} s: "
          f"{tps_spec:.1f} tok/s; plain engine (K 8) {tps_plain_a:.1f} "
          f"tok/s; acceptance "
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

    # device only, and the first 8 requests (one wave): the host's events
    # of ~240,000 device ops, the 16 requests' trace, take minutes to read
    # (16 until PR 25, cut to make room for phases 10b and 15)
    report["profile"] = profile_serve(lambda: engine(cfg_s, small),
                                      reqs[:8], dt / 2)
    report["profile"]["note"] = (
        "8 of the 16 requests (one wave); the untraced idle share uses "
        "half the 16-request run's wall time")

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
# phase 7 holds its dense and paged engines' tokens of its first 4 requests
# against the plain route (all 16 until PR 29, cut to make room for phase
# 19); paged == dense for all 16, exactly unless the plain route, run for
# a request where they differ, finds a near tie
PAGED_PLAIN_REQS = 4
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
    reference route's top-2 gap (of the logits, or of the perturbed scores
    of a sampled draw) is a near tie (reported)."""
    import numpy as np

    diff = np.nonzero(got != want)[0]
    if diff.size == 0:
        return None
    t = int(diff[0])
    if gaps[t] >= NEAR_TIE:
        raise AssertionError(f"uid {uid}: {what} diverge at step {t} where "
                             f"the reference's top-2 gap is {gaps[t]:.3g}")
    print(f"near tie: uid {uid} {what} diverge at step {t}", flush=True)
    return (uid, t, float(gaps[t]))


def run_paged_serve(kernel_rows):
    """Phase 7: phase 4's gpt-base served from a paged pool of
    PAGED_PAGES pages (prefix sharing, page backpressure) beside the dense
    pool on the same requests (dense, then paged)."""
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
        tok_per_s=tps_paged, dense_tok_per_s=tps_dense_a, seconds=dt,
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
          f"{tps_paged:.1f} tok/s; dense pool {tps_dense_a:.1f} tok/s; "
          f"prefix hits "
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
    plain = {r.uid: plain_greedy(cfg, params, r.prompt, 64)
             for r in reqs[:PAGED_PLAIN_REQS]}
    ties = {"paged": [], "dense": [], "paged vs dense": []}
    for r in reqs:
        for what, toks in (("paged", out[r.uid]), ("dense", dense_a[r.uid])):
            if toks.shape != (64,):
                raise AssertionError(f"uid {r.uid}: bad {what} output {toks}")
        if r.uid not in plain and (out[r.uid] != dense_a[r.uid]).any():
            plain[r.uid] = plain_greedy(cfg, params, r.prompt, 64)
        if r.uid not in plain:
            continue  # paged == dense exactly
        for what, toks in (("paged", out[r.uid]), ("dense", dense_a[r.uid])):
            tie = check_against_plain(what, r.uid, toks, *plain[r.uid])
            if tie is not None:
                ties[what].append(tie)
        tie = check_same_tokens("paged and dense engines", r.uid, out[r.uid],
                                dense_a[r.uid], plain[r.uid][1])
        if tie is not None:
            ties["paged vs dense"].append(tie)
    if {name: fn.launches for name, fn in kern.items()} != before:
        raise AssertionError("the plain reference launched a CUDA kernel")
    report["near_ties"] = ties
    print(f"tokens == plain route for {len(plain) - len(ties['paged'])}/"
          f"{len(plain)} requests (paged), "
          f"{len(plain) - len(ties['dense'])}/{len(plain)} (dense) (of "
          f"{len(reqs)}); paged == dense for "
          f"{len(reqs) - len(ties['paged vs dense'])}/{len(reqs)}; "
          f"near ties {ties}", flush=True)
    # the port's one breakdown of host time by engine stage, on the last 8
    # requests (2 prefix hits, 10 of the 27 macro-steps, as a CPU run of
    # the schedule shows): with the host's events, a trace of all 16 took
    # ~40 s to read
    tail = reqs[8:]
    _, dt_tail, _, _ = timed_run(engine("paged"), tail)
    report["profile"] = profile_serve(
        lambda: engine("paged"), tail, dt_tail,
        stages=("_admit_group", "_admit_hits", "_dispatch", "_process"))
    report["profile"]["note"] = ("the last 8 of the 16 requests, traced "
                                 "and untraced")
    if not report["profile"]["stages"]["engine_admit_hits"]["calls"]:
        raise AssertionError("the traced paged run admitted no prefix hit")
    return report


def run_paged_speculative(kernel_rows, small, big, reqs, plain):
    """Phase 8: phase 6's pair and requests, both pools on ONE arena of
    SPEC_PAGES pages, beside the dense speculative engine (dense, then
    paged); tokens against phase 6's plain route."""
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
        tok_per_s=tps_paged, dense_spec_tok_per_s=tps_dense_a, seconds=dt,
        tokens=n_tok, acceptance_rate=eng.acceptance_rate,
        n_spec_proposed=eng.n_spec_proposed,
        n_spec_accepted=eng.n_spec_accepted,
        dense_acceptance_rate=dense_acceptance,
        pages_budget=eng.pages_budget, pages_highwater=eng.pages_highwater,
        host_syncs_per_token=eng.n_host_syncs / n_tok,
        peak_mib=peak / 2**20, dense_peak_mib=peak_dense / 2**20,
        held_before_mib=held / 2**20, launches=launches, near_ties=ties)
    print(f"paged speculative: {len(out)} requests / {n_tok} tokens in "
          f"{dt:.3f} s: {tps_paged:.1f} tok/s; dense speculative "
          f"{tps_dense_a:.1f} tok/s;"
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
# phase 9 holds ``generate`` of the first 2 of its 16 requests against the
# plain route (cut from all 16 to make room for later phases; the first 2
# are one prompt past the window and one that wraps in decode)
GRIFFIN_GENERATE_REQS = 2
# phase 9 also holds its request of the shortest prompt against the
# scalar route (``decode_step`` over the prompt: every prompt token a
# step, so its cost grows with the longest prompt it takes; 2 until PR 28,
# cut to make room for phase 18)
GRIFFIN_SCALAR_REQS = 1
# phase 10 serves the first 8 of them (16 until PR 24, cut for the same
# reason; at 160 pages 9 of their admissions still wait for pages)
GRIFFIN_PAGED_REQS = 8
# phase 9 holds the engine's tokens of its first 3 requests, of the
# shortest of the first 8 (the scalar route's) and of the first later one
# among those 8 whose ring wraps during decode against the plain route
# (cut from all 16 to make room for later phases; the 5 hold each kind of
# prompt: 2,558 tokens past the window, 2,024 and 2,020 wrapping during
# decode, 495 and 192 short); the rest must equal phase 9's dense engine
# exactly in phases 10 and 10b unless the plain route, run for them then,
# finds a near tie (``griffin_reference``), and are checked for shape and
# range here
GRIFFIN_PLAIN_REQS = 3
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
    """Greedy tokens of the plain route, a request at a time: its prompt
    through ``griffin.prefill`` with the scan's plain version (the
    prefill's attention is plain banded attention), then ``decode_step``
    (``rglru_step`` and ``_ring_window_attend``): no kernel of the port,
    and none of the engine's batching.  Returns {uid: (tokens, top-2
    gaps)}.  (Every row running ``decode_step`` over its prompt token by
    token, at one shared position, took 100-130 s.)"""
    import numpy as np
    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.models import griffin

    out = {}
    scan = ops.rglru_scan
    ops.rglru_scan = ref.rglru_scan_ref
    try:
        for r in reqs:
            P = len(r.prompt)
            cache = griffin.init_cache(cfg, 1, P + n_new, device="cuda")
            prompt = torch.from_numpy(r.prompt)[None].cuda()
            logits, cache = griffin.prefill(params, {"tokens": prompt}, cfg,
                                            cache)
            nxts, gaps = [], []
            for i in range(n_new):
                top = logits.float().topk(2, dim=-1).values
                nxt = logits.argmax(-1).to(torch.int32)
                nxts.append(nxt)
                gaps.append(top[:, 0] - top[:, 1])
                if i + 1 < n_new:
                    logits, cache = griffin.decode_step(params, nxt, P + i,
                                                        cache, cfg)
            out[r.uid] = (torch.cat(nxts).cpu().numpy().astype(np.int32),
                          torch.cat(gaps).cpu().numpy())
    finally:
        ops.rglru_scan = scan
    return out


def griffin_reference(model, r, *outs):
    """What phases 10 and 10b hold request ``r``'s tokens ``outs`` to:
    phase 9's plain route where it ran; elsewhere phase 9's dense engine
    tokens exactly (no near tie), unless one of ``outs`` disagrees with
    them: then the plain route runs for ``r`` (kept in ``model`` for later
    phases) and decides up to near ties.  Returns (tokens, gaps)."""
    import numpy as np

    cfg, params, _, plain, dense_out = model
    if r.uid not in plain and any((t != dense_out[r.uid]).any()
                                  for t in outs):
        plain.update(griffin_plain_route(cfg, params, [r], 64))
    if r.uid in plain:
        return plain[r.uid]
    return dense_out[r.uid], np.full(64, np.inf)


def griffin_scalar_route(cfg, params, reqs, n_new):
    """Greedy tokens of the scalar route: ``decode_step`` over all rows at
    one shared position from an empty cache, each row fed its prompt and
    then its own argmax.  It runs ``rglru_step`` and
    ``_ring_window_attend``: no kernel of the port, and no prefill, so it
    shares nothing with the engine's admission but the blocks' weights.
    Returns {uid: (tokens, top-2 gaps)}."""
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
    short = sorted(reqs[:GRIFFIN_PAGED_REQS],
                   key=lambda r: len(r.prompt))[:GRIFFIN_SCALAR_REQS]
    t0 = time.perf_counter()
    wraps = [r for r in reqs[GRIFFIN_PLAIN_REQS:GRIFFIN_PAGED_REQS]
             if len(r.prompt) < cfg.window <= len(r.prompt) + 64][:1]
    plain = griffin_plain_route(cfg, params, reqs[:GRIFFIN_PLAIN_REQS] + [
        r for r in short if r.uid >= GRIFFIN_PLAIN_REQS] + wraps, 64)
    plain_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    scalar = griffin_scalar_route(cfg, params, short, 64)
    scalar_s = time.perf_counter() - t0
    if {name: fn.launches for name, fn in kern.items()} != before:
        raise AssertionError("the plain route launched a CUDA kernel")
    scalar_ties = []
    for uid, (toks, gaps) in scalar.items():
        for what, got in (("engine", out[uid]), ("plain route", plain[uid][0])):
            tie = check_against_plain(f"{what} (scalar route)", uid, got,
                                      toks, gaps)
            if tie is not None:
                scalar_ties.append((what, *tie))
    print(f"scalar route (decode_step over the prompt, no prefill, no "
          f"kernel; {scalar_s:.1f} s) on uids {sorted(scalar)} (prompts "
          f"{[len(r.prompt) for r in short]}): engine and plain route "
          f"tokens equal it but for near ties {scalar_ties}", flush=True)
    ties = {"engine": [], "generate": []}
    distinct = set()
    t0 = time.perf_counter()
    for r in reqs:
        got = out[r.uid]
        if got.shape != (64,) or got.min() < 0 or got.max() >= cfg.vocab_size:
            raise AssertionError(f"uid {r.uid}: bad output {got}")
        distinct.update(int(t) for t in got)
        if r.uid not in plain:
            continue
        runs = [("engine", got)]
        if r.uid < GRIFFIN_GENERATE_REQS:
            runs.append(("generate", generate(
                cfg, params, torch.from_numpy(r.prompt)[None].cuda(),
                max_new_tokens=64, max_len=4096)[0].cpu().numpy()))
        for what, toks in runs:
            tie = check_against_plain(what, r.uid, toks, *plain[r.uid])
            if tie is not None:
                ties[what].append(tie)
    generate_s = time.perf_counter() - t0
    gaps = np.concatenate([v[1] for v in plain.values()])
    exact = {"engine": len(plain) - len(ties["engine"]),
             "generate": GRIFFIN_GENERATE_REQS - len(ties["generate"])}
    print(f"tokens == plain route (prefill with the plain scan, then "
          f"decode_step, a request at a time, no kernel; {plain_s:.1f} s) "
          f"for {exact['engine']}/{len(plain)} "
          f"requests from the engine (of {len(reqs)}) and "
          f"{exact['generate']}/"
          f"{GRIFFIN_GENERATE_REQS} from generate ({generate_s:.1f} s for "
          f"the {GRIFFIN_GENERATE_REQS} calls); near ties "
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
                  scalar_route=dict(uids=sorted(scalar), seconds=scalar_s,
                                    near_ties=scalar_ties),
                  init_seconds=init_s, prompt_lens=[
                      len(r.prompt) for r in reqs])
    # no traced run (~30 s, reading ~125,000 device ops), cut to make room
    # for phase 16: this path's breakdown stands in PERF.md section 5
    report["bf16"] = griffin_bf16_check(cfg, params)
    return report, (cfg, params, reqs, plain, out)


GRIFFIN_BF16_B, GRIFFIN_BF16_P, GRIFFIN_BF16_STEPS = 2, 128, 8  # phase 9


def griffin_bf16_check(cfg32, params32):
    """Phase 9's bf16 check (ROADMAP 1.3): recurrentgemma-2b in its
    published bf16 against an f32 route on the same bf16-cast weights.
    Tokens: the f32 route's greedy ones (prefill through the scan kernel,
    then GRIFFIN_BF16_STEPS decode steps).  Reference: the f32 full
    forward over prompt + those tokens.  The bf16 route (prefill through
    the scan kernel, then ``decode_step`` fed the same tokens) must lie
    within 2x the bf16 plain route's max |logit| error (one full forward,
    the scan through its plain version: no kernel), phase 11's rule.  No
    bf16 engine run."""
    import torch

    from repro_torch.data import lm_batch
    from repro_torch.kernels import ops, ref
    from repro_torch.models import griffin
    from repro_torch.utils.pytree import tree_map

    t0 = time.perf_counter()
    B, P, n = GRIFFIN_BF16_B, GRIFFIN_BF16_P, GRIFFIN_BF16_STEPS
    prompts = torch.from_numpy(lm_batch(cfg32.vocab_size, B, P,
                                        seed=19)).cuda()
    cfg16 = cfg32.replace(param_dtype="bfloat16", compute_dtype="bfloat16")
    params16 = tree_map(lambda t: t.bfloat16(), params32)
    p32 = tree_map(lambda t: t.float(), params16)
    kern = ops.kernels()
    with torch.no_grad():
        cache = griffin.init_cache(cfg32, B, P + n, device="cuda")
        logits, cache = griffin.prefill(p32, {"tokens": prompts}, cfg32,
                                        cache)
        toks = [logits.argmax(-1).to(torch.int32)]
        for i in range(n - 1):
            logits, cache = griffin.decode_step(p32, toks[-1], P + i, cache,
                                                cfg32)
            toks.append(logits.argmax(-1).to(torch.int32))
        fed = torch.stack(toks, 1)  # (B, n): the decode steps' inputs
        full = torch.cat([prompts, fed], 1)
        ref32 = griffin.forward(p32, {"tokens": full}, cfg32)[0][
            :, P:].float()
        before = _launch_counts(kern)
        orig = ops.rglru_scan
        ops.rglru_scan = ref.rglru_scan_ref
        try:
            plain16 = griffin.forward(params16, {"tokens": full}, cfg16)[0][
                :, P:].float()
        finally:
            ops.rglru_scan = orig
        if _launch_counts(kern) != before:
            raise AssertionError("the plain bf16 route launched a kernel")
        cache = griffin.init_cache(cfg16, B, P + n, device="cuda")
        _, cache = griffin.prefill(params16, {"tokens": prompts}, cfg16,
                                   cache)
        route16 = []
        for i in range(n):
            logits, cache = griffin.decode_step(params16, fed[:, i], P + i,
                                                cache, cfg16)
            route16.append(logits.float())
        route16 = torch.stack(route16, 1)
    err16 = float((route16 - ref32).abs().max())
    plain_err = float((plain16 - ref32).abs().max())
    scale = float(ref32.abs().max())
    del params16, p32, cache
    print(f"recurrentgemma-2b bf16 (B {B}, prompt {P}, {n} decode steps) "
          f"against f32 on the same bf16-cast weights: max |logit| error "
          f"{err16:.4g} (the bf16 plain route's {plain_err:.4g}, limit 2x; "
          f"max |logit| {scale:.4g}; {time.perf_counter() - t0:.1f} s)",
          flush=True)
    if not (err16 <= 2 * plain_err and err16 > 0):
        raise AssertionError(f"recurrentgemma-2b bf16 error {err16} is past "
                             f"2x the plain bf16 route's {plain_err}")
    return dict(err=err16, plain_err=plain_err, max_logit=scale,
                seconds=time.perf_counter() - t0)


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
    """Phase 10: phase 9's model and its first GRIFFIN_PAGED_REQS requests
    from a paged pool of GRIFFIN_PAGES pages beside the dense pool (dense,
    then paged); the refused admissions predicted first by a CPU run of the
    same schedule."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import griffin
    from repro_torch.serve import ContinuousBatchingEngine, Request

    cfg, params, reqs, _, dense_out = model
    reqs = reqs[:GRIFFIN_PAGED_REQS]
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
        tok_per_s=tps_paged, dense_tok_per_s=tps_dense_a, seconds=dt,
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
        ref = griffin_reference(model, r, out[r.uid], dense_a[r.uid])
        for what, toks in (("paged", out[r.uid]), ("dense", dense_a[r.uid])):
            tie = check_against_plain(what, r.uid, toks, *ref)
            if tie is not None:
                ties[what].append(tie)
        for what, a, b in (("paged and dense engines", out, dense_a),
                           ("dense engines of phases 9 and 10", dense_a,
                            dense_out)):
            tie = check_same_tokens(what, r.uid, a[r.uid], b[r.uid], ref[1])
            if tie is not None:
                ties["paged vs dense" if a is out
                     else "dense vs phase 9"].append(tie)
    report["near_ties"] = ties
    print(f"griffin paged: {len(out)} requests / {n_tok} tokens in "
          f"{dt:.3f} s: {tps_paged:.1f} tok/s; dense pool "
          f"{tps_dense_a:.1f} tok/s; admissions refused for pages {waits} "
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
          f"== plain route (or phase 9's dense engine: griffin_reference) "
          f"for {len(reqs) - len(ties['paged'])}/{len(reqs)} (paged), "
          f"{len(reqs) - len(ties['dense'])}/{len(reqs)} (dense); near ties "
          f"{ties}", flush=True)
    return report


GRIFFIN_SPEC_D, GRIFFIN_SPEC_K = 4, 2  # phase 10b: draft depth, blocks
GRIFFIN_DRAFT_NOISE = 1e-3  # phase 10b's nudged draft: noise / leaf std
# phase 10b's runs: the self-draft on the dense pool, the nudged draft on
# the paged pool (cut from each draft on both pools to make room for
# phase 16)
GRIFFIN_SPEC_RUNS = (("self", ("dense",)), ("nudged", ("paged",)))
# phase 10b serves phase 9's first 4 requests (cut from 8 to make room
# for phase 20): a ring filled at admission (2,558 tokens), one that wraps
# in decode (2,024) and two short ones (495, 454)
GRIFFIN_SPEC_REQS = 4


def nudged_copy(params, scale, seed):
    """A copy of ``params`` with seeded Gaussian noise of ``scale`` times
    each leaf's standard deviation added (norm scales, all ones, keep
    theirs): a draft that agrees with its target most of the time."""
    import torch

    gen = torch.Generator(device=next(_leaves(params)).device).manual_seed(
        seed)

    def nudge(t):
        if isinstance(t, dict):
            return {k: nudge(v) for k, v in t.items()}
        noise = torch.randn(t.shape, generator=gen, device=t.device,
                            dtype=t.dtype)
        return t + noise.mul_(scale * t.float().std().item())

    return nudge(params)


def run_griffin_spec(model, paged_report):
    """Phase 10b: griffin speculation.  recurrentgemma-2b drafting for
    itself (d 4, K 2) on phase 9's first GRIFFIN_SPEC_REQS requests: the
    model itself on
    the dense pool (every proposal accepted), then a copy nudged by seeded
    noise on phase 10's 160-page pool (acceptance strictly inside (0,
    1)).  Tokens == phase 9's plain route up to reported near
    ties; exact launches of the ring (or paged ring) kernel -- d proposals,
    S verify steps and S catch-up steps a block, each attention layer --
    and of the scan, each recurrent layer of each admission prefill (two a
    group: target and draft); tok/s beside phase 10's plain engines on
    the same requests."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import griffin
    from repro_torch.serve import ContinuousBatchingEngine, SpeculativeConfig

    cfg, params, reqs, _, _ = model
    reqs = reqs[:GRIFFIN_SPEC_REQS]
    pat = griffin.block_pattern(cfg)
    n_rec, n_attn = pat.count("rec"), pat.count("attn")
    d, k = GRIFFIN_SPEC_D, GRIFFIN_SPEC_K
    kern = ops.kernels()
    report = dict(d=d, k=k, plain_dense_tok_per_s=paged_report[
        "dense_tok_per_s"], plain_paged_tok_per_s=paged_report["tok_per_s"])
    ties = []
    for label, pools in GRIFFIN_SPEC_RUNS:
        t0 = time.perf_counter()
        draft = params if label == "self" else nudged_copy(
            params, GRIFFIN_DRAFT_NOISE, seed=10)
        copy_s = time.perf_counter() - t0
        for pool in pools:
            eng = ContinuousBatchingEngine(
                cfg, params, capacity=8, max_len=4096, k=k, pool=pool,
                pages=GRIFFIN_PAGES if pool == "paged" else None,
                speculative=SpeculativeConfig(cfg, draft, d=d))
            for fn in kern.values():
                fn.launches = 0
            out, dt, tps, waits = timed_run(eng, reqs)
            launches = {name: fn.launches for name, fn in kern.items()}
            ring = ("paged_ring_decode_attention" if pool == "paged"
                    else "ring_decode_attention")
            want = {name: 0 for name in kern}
            want.update({ring: n_attn * (3 * d + 2) * k
                         * eng.n_decode_dispatches,
                         "rglru_scan": n_rec * eng.n_prefills})
            if launches != want:
                raise AssertionError(
                    f"griffin speculation ({label}, {pool}) launched "
                    f"{launches}, expected {want} ({eng.n_decode_dispatches}"
                    f" dispatches, {eng.n_prefills} prefills)")
            acc = eng.acceptance_rate
            if eng.n_spec_proposed == 0 or eng.n_spec_fallbacks or (
                    acc != 1.0 if label == "self" else not 0.0 < acc < 1.0):
                raise AssertionError(
                    f"griffin speculation ({label}, {pool}): acceptance "
                    f"{acc} ({eng.n_spec_accepted}/{eng.n_spec_proposed}), "
                    f"{eng.n_spec_fallbacks} fallbacks")
            if pool == "paged" and eng.pages_in_use:
                raise AssertionError(f"{eng.pages_in_use} pages in use")
            for r in reqs:
                if out[r.uid].shape != (64,):
                    raise AssertionError(f"uid {r.uid}: {out[r.uid]}")
                tie = check_against_plain(
                    f"griffin spec {label} {pool}", r.uid, out[r.uid],
                    *griffin_reference(model, r, out[r.uid]))
                if tie is not None:
                    ties.append((label, pool) + tie)
            n_tok = sum(len(v) for v in out.values())
            report[f"{label}_{pool}"] = dict(
                tok_per_s=tps, seconds=dt, tokens=n_tok, acceptance=acc,
                proposed=eng.n_spec_proposed, accepted=eng.n_spec_accepted,
                dispatches=eng.n_decode_dispatches,
                n_prefills=eng.n_prefills, refused_for_pages=waits,
                launches={n: v for n, v in launches.items() if v},
                host_syncs_per_token=eng.n_host_syncs / n_tok)
            print(f"griffin speculation, {label} draft, {pool} pool: "
                  f"{n_tok} tokens in {dt:.3f} s: {tps:.1f} tok/s (plain "
                  f"engine {pool}: "
                  f"{report[f'plain_{pool}_tok_per_s']}); acceptance "
                  f"{acc:.4f} ({eng.n_spec_accepted}/{eng.n_spec_proposed});"
                  f" {eng.n_decode_dispatches} dispatches, {eng.n_prefills} "
                  f"prefills, admissions refused for pages {waits}; "
                  f"launches {report[f'{label}_{pool}']['launches']}",
                  flush=True)
            del eng
        if label == "nudged":
            report["nudged_copy_s"] = copy_s
            del draft
            gc.collect()
            torch.cuda.empty_cache()
    report["near_ties"] = ties
    print(f"griffin speculation: tokens == plain route for every request "
          f"of the {len(GRIFFIN_SPEC_RUNS)} runs but near ties {ties}",
          flush=True)
    return report


QWEN_PAGES = 64  # phase 11's arena: half the dense pool's 128 pages of 64
QWEN_D, QWEN_K = 4, 2  # phase 11's self-draft depth and blocks a dispatch
QWEN_MATRIX_SCALE = 2.5  # phase 11: block matrices scaled up (see qwen_model)
# phase 11 runs ``generate`` at B 1 on the first 2 of its 16 requests (16
# at first, then 8, then 4, cut to make room for phases 14, 17 and 18)
QWEN_GENERATE_REQS = 2
# phase 11 holds the first 2 rows of ``generate`` at B 8 against the plain
# route (8, then 4, cut to make room for phases 16 and 18)
QWEN_GEN8_CHECKED = 2
# phase 11 holds its first 2 requests' tokens (every route's) against the
# plain route, and paged == dense for all 16 (16, then 8, then 4, cut to
# make room for phases 16, 17 and 18)
QWEN_PLAIN_REQS = 2
# phase 11's traced engine run serves its first 2 requests (cut from one
# wave of 8, then 4, to make room for phases 18 and 20)
QWEN_TRACED_REQS = 2
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
    model drafting for itself; ``generate`` for the first
    QWEN_GENERATE_REQS requests (B 1) and over 8 prompts of 512 tokens
    (B 8, its first QWEN_GEN8_CHECKED rows); all against the plain route; a
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
    plain = {r.uid: plain_greedy(cfg, params, r.prompt, 64)
             for r in reqs[:QWEN_PLAIN_REQS]}
    prompts8 = lm_batch(cfg.vocab_size, 8, 512, seed=1200)
    plain8 = [plain_greedy(cfg, params, p, 64)
              for p in prompts8[:QWEN_GEN8_CHECKED]]
    plain_s = time.perf_counter() - t0
    if {name: fn.launches for name, fn in kern.items()} != before:
        raise AssertionError("the plain route launched a CUDA kernel")

    ties = {"dense": [], "paged": [], "speculative": [], "paged vs dense": [],
            "speculative vs dense": [], "generate": [], "generate B 8": []}
    gen_launches, gen_s = 0, 0.0
    want_gen = {name: 0 for name in kern}
    want_gen.update(decode_attention=L * 63, flash_attention=L)
    for r in reqs:
        if r.uid not in plain and any(
                (runs[w]["out"][r.uid] != runs["dense"]["out"][r.uid]).any()
                for w in ("paged", "speculative")):
            # engines that disagree past the plain route's requests: the
            # plain route decides whether at a near tie
            t0 = time.perf_counter()
            plain[r.uid] = plain_greedy(cfg, params, r.prompt, 64)
            plain_s += time.perf_counter() - t0
            if {name: fn.launches for name, fn in kern.items()} != before:
                raise AssertionError("the plain route launched a CUDA "
                                     "kernel")
        for what in ("dense", "paged", "speculative"):
            toks = runs[what]["out"][r.uid]
            if toks.shape != (64,) or toks.min() < 0 or \
                    toks.max() >= cfg.vocab_size:
                raise AssertionError(f"uid {r.uid}: bad {what} output")
            if r.uid in plain:
                tie = check_against_plain(what, r.uid, toks, *plain[r.uid])
                if tie is not None:
                    ties[what].append(tie)
        # past the plain route's requests the paged pool and the
        # speculative engine must agree with the dense pool exactly
        for what in ("paged", "speculative"):
            tie = check_same_tokens(
                f"{what} and dense engines", r.uid, runs[what]["out"][r.uid],
                runs["dense"]["out"][r.uid],
                plain[r.uid][1] if r.uid in plain else np.full(64, np.inf))
            if tie is not None:
                ties[f"{what} vs dense"].append(tie)
        if r.uid >= QWEN_GENERATE_REQS:
            continue
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
    for b in range(QWEN_GEN8_CHECKED):
        tie = check_against_plain("generate B 8", b, gen8[b], *plain8[b])
        if tie is not None:
            ties["generate B 8"].append(tie)
    kernel_rows["decode_attention"]["launches"] = gen_launches
    distinct = {int(t) for v in runs["dense"]["out"].values() for t in v}
    if len(distinct) < QWEN_MIN_DISTINCT:
        raise AssertionError(f"the dense engine's output nearly repeats: "
                             f"{len(distinct)} distinct tokens")
    gaps = np.concatenate([v[1] for v in plain.values()])
    print(f"qwen3 tokens == plain route (full forward per token, no kernel;"
          f" {plain_s:.1f} s): "
          + ", ".join(f"{w} {len(plain) - len(ties[w])}/{len(plain)}"
                      for w in ("dense", "paged", "speculative"))
          + f", paged == dense {len(reqs) - len(ties['paged vs dense'])}/"
          f"{len(reqs)}, speculative == dense "
          f"{len(reqs) - len(ties['speculative vs dense'])}/{len(reqs)}"
          + f", generate {QWEN_GENERATE_REQS - len(ties['generate'])}/"
          f"{QWEN_GENERATE_REQS}, generate B 8 "
          f"{QWEN_GEN8_CHECKED - len(ties['generate B 8'])}/"
          f"{QWEN_GEN8_CHECKED}; near ties "
          f"{ties}; {len(distinct)} distinct tokens from the dense engine; "
          f"plain top-2 gap median {np.median(gaps):.4g}, min "
          f"{gaps.min():.4g}", flush=True)
    print(f"qwen3 generate: B 1 {QWEN_GENERATE_REQS * 64 / gen_s:.1f} tok/s "
          f"over the first {QWEN_GENERATE_REQS} requests ({gen_s:.1f} s), B 8"
          f" x 512-token prompts {8 * 64 / gen8_s:.1f} tok/s ({gen8_s:.2f} "
          f"s); decode_attention launches {gen_launches} ({L} x 63 a call, "
          f"{QWEN_GENERATE_REQS + 1} calls)", flush=True)

    t0 = time.perf_counter()
    profile = profile_serve(
        lambda: engine("dense"), reqs[:QWEN_TRACED_REQS],
        untraced_wall=runs["dense"]["seconds"] * QWEN_TRACED_REQS / 16)
    profile["seconds"] = time.perf_counter() - t0
    profile["note"] = (f"{QWEN_TRACED_REQS} of the 16 requests; the "
                       "untraced idle share uses that share of the "
                       "16-request run's wall time")

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
                generate_b1_tok_per_s=QWEN_GENERATE_REQS * 64 / gen_s,
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
# the launcher's operator steps in phase 12 (its default is 50; 10 keep
# the phase short: each step makes a 32-image batch on the host, ~0.22 s)
DEIT_LAUNCHER_OP_STEPS = 10
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
                grow_steps=DEIT_LAUNCHER_OP_STEPS,
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


SAMPLED = dict(temperature=0.8, top_k=50, top_p=0.95, seed=5)  # phase 13
SAMPLED_SPEC_REQS = 8  # phase 13's self-draft runs serve the first 8
# phase 13 replays its first 4 requests' chains sequentially (cut from
# 16, then 8, to make room for phases 18 and 20); the paged pool's tokens
# equal the dense pool's exactly past them
SAMPLED_REPLAY_REQS = 4


def check_sampling_on_card(sp, vocab):
    """The port's threefry chains, random bits, uniforms and
    ``filtered_probs`` on the card against the same functions on the CPU:
    keys, bits and uniforms equal, probabilities within 1e-6."""
    import torch

    from repro_torch.serve import sampling

    uids = torch.tensor([0, 1, 12345, 2**31 - 1])
    pairs = {}
    for dev in ("cpu", "cuda"):
        keys = sampling.request_key(sp.seed, uids.to(dev))
        carry, sub = sampling.next_keys(keys)
        out = dict(keys=keys, carry=carry, sub=sub,
                   fold=sampling.fold_in(sub, 5))
        for shape in ((50257,), (3,), (5, 37)):
            out[f"bits{shape}"] = sampling.random_bits(sub, shape)
            out[f"uniform{shape}"] = sampling.uniform(sub, shape)
        pairs[dev] = out
    for name, want in pairs["cpu"].items():
        got = pairs["cuda"][name]
        if got.device.type != "cuda" or not torch.equal(got.cpu(), want):
            raise AssertionError(f"sampling {name}: the card's differs from "
                                 "the CPU's")
    gen = torch.Generator().manual_seed(13)
    logits = 3 * torch.randn(8, vocab, generator=gen)
    want = sampling.filtered_probs(logits, sp)
    got = sampling.filtered_probs(logits.cuda(), sp).cpu()
    err = (got - want).abs().max().item()
    if err > 1e-6 or not torch.equal(got > 0, want > 0):
        raise AssertionError(f"filtered_probs on the card: max abs err "
                             f"{err:.3g} (limit 1e-6) or another support")
    print(f"sampling on the card == CPU: keys, splits, fold_in, bits and "
          f"uniforms of (50257,), (3,), (5, 37) equal; filtered_probs "
          f"(8, {vocab}) max abs err {err:.3g}", flush=True)
    return err


def sampled_replay_on_card(cfg, params, req, sp, tokens):
    """Sequential replay of one request's sampling chain: ``fam.prefill``
    and ``fam.decode_step`` at B 1, the chain rooted at (seed, uid) and
    split once a token, fed ``tokens`` as the generated prefix.  Returns
    what the chain draws at each step and the top-2 gap of the perturbed
    scores there."""
    import numpy as np
    import torch

    from repro_torch.models import get_family
    from repro_torch.serve import sampling

    fam = get_family(cfg)
    cache = fam.init_cache(cfg, 1, len(req.prompt) + len(tokens),
                           device="cuda")
    x = torch.tensor(req.prompt, dtype=torch.int32, device="cuda")[None]
    logits, cache = fam.prefill(params, {"tokens": x}, cfg, cache)
    keys = sampling.request_key(sp.seed,
                                torch.tensor([req.uid], device="cuda"))
    scores = []
    pos = len(req.prompt)
    for i, t in enumerate(tokens):
        keys, sub = sampling.next_keys(keys)
        probs = sampling.filtered_probs(logits, sp)
        logp = torch.where(probs > 0, torch.log(probs.clamp_min(1e-38)),
                           sampling.NEG_INF)
        scores.append(sampling.gumbel(sub, logits.shape[-1:]) + logp)
        if i + 1 < len(tokens):
            logits, cache = fam.decode_step(
                params, torch.tensor([int(t)], dtype=torch.int32,
                                     device="cuda"), pos, cache, cfg)
            pos += 1
    s = torch.cat(scores)
    top = s.topk(2, dim=-1).values
    return (s.argmax(-1).cpu().numpy().astype(np.int32),
            (top[:, 0] - top[:, 1]).cpu().numpy())


def run_sampled():
    """Phase 13: gpt-base sampled (temperature 0.8, top-k 50, top-p 0.95,
    seed 5) through the engine on phase 7's 16 requests, beside the greedy
    engine: the card's sampling against the CPU's, tokens against a
    sequential sampled replay, launches and host syncs equal greedy's,
    the paged pool with prefix hits, self-draft rejection sampling."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import build_params
    from repro_torch.serve import (
        ContinuousBatchingEngine,
        Request,
        SamplingParams,
        SpeculativeConfig,
    )

    cfg = get_config("gpt-base")
    params = build_params(cfg, seed=0, device="cuda")
    sp = SamplingParams(**SAMPLED)
    reqs = paged_requests(cfg.vocab_size)
    report = dict(probs_max_abs_err=check_sampling_on_card(
        sp, cfg.vocab_size))

    def engine(sampling, pool="dense", k=8, speculative=None):
        return ContinuousBatchingEngine(
            cfg, params, capacity=8, max_len=1024, k=k, pool=pool,
            pages=PAGED_PAGES if pool == "paged" else None,
            sampling=sampling, speculative=speculative)

    engine(sp).run([Request(uid=0, prompt=reqs[0].prompt,
                            max_new_tokens=9)])  # first-use costs
    kern = ops.kernels()
    runs = {}
    for label, sampling in (("greedy", None), ("sampled", sp)):
        for fn in kern.values():
            fn.launches = 0
        eng = engine(sampling)
        out, dt, tps, _ = timed_run(eng, reqs)
        runs[label] = dict(out=out, seconds=dt, tok_per_s=tps,
                           launches={n: fn.launches
                                     for n, fn in kern.items()},
                           syncs=eng.n_host_syncs,
                           dispatches=eng.n_decode_dispatches,
                           prefills=eng.n_prefills)
    g, s = runs["greedy"], runs["sampled"]
    for key in ("launches", "syncs", "dispatches", "prefills"):
        if s[key] != g[key]:
            raise AssertionError(f"sampled {key} {s[key]} != greedy's "
                                 f"{g[key]}")
    if not (s["launches"]["slot_decode_attention"]
            and s["launches"]["flash_attention"]):
        raise AssertionError(f"sampled path launched {s['launches']}")
    out = s["out"]
    if all(np.array_equal(out[u], g["out"][u]) for u in out):
        raise AssertionError("sampled tokens equal the greedy run's")
    print(f"sampled: {len(out)} requests / "
          f"{sum(len(v) for v in out.values())} tokens, "
          f"{s['tok_per_s']:.1f} tok/s beside greedy {g['tok_per_s']:.1f} "
          f"({s['seconds']:.3f} s and {g['seconds']:.3f} s); host syncs "
          f"{s['syncs']} == greedy's; launches {s['launches']} == greedy's",
          flush=True)

    t0 = time.perf_counter()
    ties = {"engine vs replay": [], "paged vs dense": []}
    gaps = {}
    for r in reqs:
        toks = out[r.uid]
        if toks.shape != (64,) or toks.min() < 0 or toks.max() >= \
                cfg.vocab_size:
            raise AssertionError(f"uid {r.uid}: bad output {toks}")
        if r.uid >= SAMPLED_REPLAY_REQS:
            gaps[r.uid] = np.full(64, np.inf)
            continue
        drawn, gaps[r.uid] = sampled_replay_on_card(cfg, params, r, sp, toks)
        tie = check_same_tokens("the sampled engine and its replay", r.uid,
                                toks, drawn, gaps[r.uid])
        if tie is not None:
            ties["engine vs replay"].append(tie)
    replay_s = time.perf_counter() - t0

    for fn in kern.values():
        fn.launches = 0
    peng = engine(sp, "paged")
    pout, pdt, ptps, waits = timed_run(peng, reqs)
    p_launches = {n: fn.launches for n, fn in kern.items()}
    if peng.n_prefix_hits == 0 or peng.pages_in_use != 0:
        raise AssertionError(f"sampled paged: prefix hits "
                             f"{peng.n_prefix_hits}, pages in use at the "
                             f"end {peng.pages_in_use}")
    for r in reqs:
        tie = check_same_tokens("sampled paged and dense engines", r.uid,
                                pout[r.uid], out[r.uid], gaps[r.uid])
        if tie is not None:
            ties["paged vs dense"].append(tie)
    print(f"sampled tokens == the sequential replay (fam.prefill + "
          f"decode_step, {replay_s:.1f} s) for "
          f"{SAMPLED_REPLAY_REQS - len(ties['engine vs replay'])}/"
          f"{SAMPLED_REPLAY_REQS} requests; paged ({PAGED_PAGES} pages, "
          f"{peng.n_prefix_hits} prefix hits, {waits} admissions refused for pages, "
          f"{ptps:.1f} tok/s, 0 pages in use at the end) == dense for "
          f"{len(reqs) - len(ties['paged vs dense'])}/{len(reqs)}; paged "
          f"launches {p_launches}; near ties {ties}", flush=True)

    spec_reqs = reqs[:SAMPLED_SPEC_REQS]
    spec = []
    for _ in range(2):
        e = engine(sp, k=2, speculative=SpeculativeConfig(cfg, params, d=4))
        sout, _, stps, _ = timed_run(e, spec_reqs)
        spec.append((sout, stps, e.n_spec_proposed, e.n_spec_accepted))
    (s1, tps1, prop, acc), (s2, tps2, _, _) = spec
    if prop == 0 or acc != prop:
        raise AssertionError(f"self-draft acceptance {acc}/{prop} != 1.0")
    if any(not np.array_equal(s1[u], s2[u]) for u in s1):
        raise AssertionError("two self-draft sampled runs differ")
    print(f"self-draft sampled speculation (d 4, K 2, {len(spec_reqs)} "
          f"requests): acceptance {acc}/{prop} = 1.0, the two runs' tokens "
          f"equal, {tps1:.1f} and {tps2:.1f} tok/s", flush=True)

    prof = {}
    for label, sampling in (("greedy", None), ("sampled", sp)):
        r = profile_serve(lambda: engine(sampling), reqs,
                          runs[label]["seconds"])
        prof[label] = dict(r, ops_per_decode_step=r["device_ops"]
                           / r["decode_steps"])
    print(f"device ops per decode step: sampled "
          f"{prof['sampled']['ops_per_decode_step']:.1f}, greedy "
          f"{prof['greedy']['ops_per_decode_step']:.1f} (admission ops "
          f"included; {prof['sampled']['decode_steps']} decode steps)",
          flush=True)
    report.update(
        tok_per_s=s["tok_per_s"], greedy_tok_per_s=g["tok_per_s"],
        seconds=s["seconds"], greedy_seconds=g["seconds"],
        host_syncs=s["syncs"], launches=s["launches"],
        paged_tok_per_s=ptps, paged_prefix_hits=peng.n_prefix_hits,
        paged_waits=waits, paged_launches=p_launches,
        spec_tok_per_s=[tps1, tps2], spec_proposed=prop, spec_accepted=acc,
        replay_seconds=replay_s, near_ties=ties,
        ops_per_decode_step={k: v["ops_per_decode_step"]
                             for k, v in prof.items()},
        profile=prof)
    return report


UPGRADE_K, UPGRADE_D = 8, 4  # phase 14: macro-step, post-swap draft depth
# phase 14's background run serves waves of its 16 requests while the
# model grows, at most this many; a growth that outlives them swaps at the
# boundary after the last one
UPGRADE_WAVES = 10
# phase 14 holds the requests served wholly before or wholly after a swap
# to the plain routes where their prompt is one of the wave's first 8 (cut
# from all 16 to make room for phase 20); every resumed request is held
UPGRADE_PLAIN_PROMPTS = 8
# phase 14's prefill buckets: the swap's prewarm admits every (group size,
# bucket) shape, 4 x 8 = 32 at buckets of 64 (4 x 32 = 128 at buckets of
# 16 took 29.8-41.0 s of prewarm in the background run alone on an H100)
UPGRADE_BUCKET = 64


def upgrade_requests(uid0=0):
    """Phase 14's 16 requests: prompts of 64..384 tokens from phase 5's
    chain over the first 1024 ids, 64 new tokens each."""
    import numpy as np

    from repro_torch.data import lm_batch
    from repro_torch.serve import Request

    rng = np.random.default_rng(14)
    return [Request(uid=uid0 + i, prompt=lm_batch(
        GROW_DATA_VOCAB, 1, int(rng.integers(64, 385)), seed=1400 + i)[0],
        max_new_tokens=64) for i in range(16)]


class SwapWatch:
    """Wraps an engine's ``_apply_upgrade``: records the engine's window
    counters, every kernel's launches, the loaded kernel libraries and the
    builds at the swap, and the requests finished by then."""

    def __init__(self, eng):
        from repro_torch.kernels import build, ops

        self.eng, self.kern, self.build = eng, ops.kernels(), build
        self.builds = []
        self._build_all = build.build_all
        build.build_all = self._record_build
        self._apply = eng._apply_upgrade
        eng._apply_upgrade = self._swap
        self.at = None

    def _record_build(self, *a, **kw):
        self.builds.append(a)
        return self._build_all(*a, **kw)

    def _snap(self):
        e = self.eng
        return dict(launches={n: f.launches for n, f in self.kern.items()},
                    libs=sorted(self.build._libs),
                    builds=len(self.builds),
                    dispatches=e.n_decode_dispatches, prefills=e.n_prefills,
                    tail_steps=e.n_prefix_tail_steps,
                    finished=set(e.finished))

    def _swap(self, mgr):
        before = self._snap()
        self._apply(mgr)
        self.at = dict(before=before, after=self._snap())

    def close(self):
        self.build.build_all = self._build_all
        del self.eng._apply_upgrade


def run_upgrade(small):
    """Phase 14: phase 5's pretrained gpt-small served on the dense pool
    and grown live into gpt-base (rank-1 Mango, noise 0) with the old
    model drafting after the swap: a background growth, then a
    synchronous one swapping at dispatch 2, then the synchronous one on a
    48-page paged pool; then the grown gpt-base sampled with a journal and
    a snapshot, crashed after 3 dispatches, restored and resumed, by hand
    and through the launcher."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.serve import ContinuousBatchingEngine, UpgradeManager

    cfg_s, cfg_t = get_config("gpt-small"), get_config("gpt-base")
    reqs = upgrade_requests()
    kern = ops.kernels()
    report = {}
    plain = {}  # (weights, prompt, n) -> plain tokens and gaps
    grown_seen = []  # grown weights so far, each a key of ``plain``

    def weights_key(mgr):
        """Growth is deterministic: a run whose grown weights equal an
        earlier run's (checked leaf for leaf) reuses its plain routes."""
        leaves = list(_leaves(mgr.grown_params))
        for i, seen in enumerate(grown_seen):
            if all(torch.equal(a, b) for a, b in zip(seen, leaves)):
                return i
        grown_seen.append(leaves)
        return len(grown_seen) - 1

    def plain_route(key, cfg, params, prompt, n):
        k = (key, tuple(int(t) for t in prompt), n)
        if k not in plain:
            plain[k] = plain_greedy(cfg, params, prompt, n)
        return plain[k]

    def plain_small(i):
        return plain_route("small", cfg_s, small, reqs[i].prompt, 64)

    def engine(pool):
        return ContinuousBatchingEngine(
            cfg_s, small, capacity=8, max_len=512, k=UPGRADE_K,
            prefill_bucket=UPGRADE_BUCKET, pool=pool,
            pages=PAGED_PAGES if pool == "paged" else None)

    def manager(eng, background):
        mgr = UpgradeManager(eng, cfg_t, method="mango", rank=1,
                             spec_d=UPGRADE_D, upgrade_at=2, probe_fp=True)
        if mgr.spec_config() is None:
            raise AssertionError(f"no draft after the swap: "
                                 f"{mgr.spec_reason}")
        return mgr.start(background=background)

    def check(label, eng, mgr, watch, out, waves):
        """Every resumed request, and every request of the wave's first
        UPGRADE_PLAIN_PROMPTS prompts, against the plain routes: served
        before the swap == gpt-small's, resumed == gpt-small's committed
        prefix then the grown gpt-base's on prompt ++ committed, admitted
        after the swap == the grown gpt-base's."""
        resumed = {r.uid: r for r in mgr.resumed_requests}
        before = watch.at["after"]["finished"] - set(resumed)
        key = weights_key(mgr)
        ties, kinds = [], {"before": 0, "resumed": 0, "after": 0,
                           "unchecked": 0}
        for uid, toks in out.items():
            i = uid % 16
            if toks.shape != (64,):
                raise AssertionError(f"{label} uid {uid}: bad output {toks}")
            if uid in resumed:
                r = resumed[uid]
                nc = r.n_committed
                tie = check_against_plain(
                    f"{label} committed prefix", uid, toks[:nc],
                    plain_small(i)[0][:nc], plain_small(i)[1][:nc])
                post = plain_route(key, cfg_t, mgr.grown_params, r.prompt,
                                   64 - nc)
                tie2 = check_against_plain(f"{label} post-swap suffix", uid,
                                           toks[nc:], *post)
                ties += [t for t in (tie, tie2) if t is not None]
                kinds["resumed"] += 1
            elif i >= UPGRADE_PLAIN_PROMPTS:
                kinds["unchecked"] += 1
            elif uid in before:
                tie = check_against_plain(f"{label} pre-swap", uid, toks,
                                          *plain_small(i))
                ties += [tie] if tie is not None else []
                kinds["before"] += 1
            else:
                tie = check_against_plain(
                    f"{label} post-swap", uid, toks,
                    *plain_route(key, cfg_t, mgr.grown_params,
                                 reqs[i].prompt, 64))
                ties += [tie] if tie is not None else []
                kinds["after"] += 1
        if len(out) != 16 * waves or eng.rejected:
            raise AssertionError(f"{label}: {len(out)} outputs of "
                                 f"{16 * waves}, rejected {eng.rejected}")
        return kinds, ties, key

    def swap_checks(label, watch, mgr):
        """Nothing is built, loaded or launched in the swap itself, and
        every kernel the grown path launches was launched by the
        prewarm."""
        b, a = watch.at["before"], watch.at["after"]
        if (a["libs"] != b["libs"] or a["builds"] != b["builds"]
                or a["launches"] != b["launches"]):
            raise AssertionError(f"{label}: the swap built, loaded or "
                                 f"launched something: {b} -> {a}")

    def one_run(pool, background):
        eng = engine(pool)
        for fn in kern.values():
            fn.launches = 0
        t0 = time.perf_counter()
        mgr = manager(eng, background)
        start_s = time.perf_counter() - t0
        prewarm = {n: f.launches for n, f in kern.items()}
        watch = SwapWatch(eng)
        for fn in kern.values():
            fn.launches = 0
        out, waves = {}, 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            while True:
                out.update(eng.run(upgrade_requests(uid0=16 * waves)))
                waves += 1
                if mgr.state in ("swapped", "failed") or \
                        waves >= UPGRADE_WAVES:
                    break
            if mgr.state != "swapped":
                mgr.wait()
                mgr.poll(eng)
            torch.cuda.synchronize()
        finally:
            watch.close()
        serve_s = time.perf_counter() - t0
        if mgr.state != "swapped" or watch.at is None:
            raise AssertionError(f"upgrade ended in {mgr.state}: "
                                 f"{mgr.error}")
        label = f"{pool}{' background' if background else ''}"
        launches = {n: f.launches for n, f in kern.items()}
        swap_checks(label, watch, mgr)
        kinds, ties, key = check(label, eng, mgr, watch, out, waves)
        post = {n: launches[n] - watch.at["after"]["launches"][n]
                for n in kern}
        # (the background growth's launches mix with the serving ones)
        cold = [] if background else [
            n for n, c in post.items() if c and not prewarm[n]]
        if cold:
            raise AssertionError(f"{label}: {cold} launched after the swap "
                                 "but not by the prewarm")
        res = dict(
            pause_ms=mgr.pause_ms, grow_s=mgr.grow_seconds,
            prewarm_s=mgr.prewarm_seconds, start_s=start_s,
            fp_token_agreement=mgr.fp_token_agreement,
            resumed=mgr.resumed, waves=waves, serve_s=serve_s,
            tok_per_s=16 * 64 * waves / serve_s,
            acceptance=eng.acceptance_rate,
            spec_proposed=eng.n_spec_proposed,
            spec_accepted=eng.n_spec_accepted,
            pages_resident_at_swap=mgr.pages_resident_at_swap,
            pages_reprefilled=mgr.pages_reprefilled,
            pages_in_use_at_end=eng.pages_in_use, kinds=kinds,
            near_ties=ties, launches=launches, grown_weights=key,
            prewarm_shapes=len(mgr.prewarm_shapes))
        if not background:
            res["exact_launches"] = exact_launches(label, eng, watch,
                                                   launches, pool)
        if pool == "paged" and eng.pages_in_use:
            raise AssertionError(f"{label}: {eng.pages_in_use} pages in use "
                                 "at the end")
        print(f"upgrade {label}: gpt-small -> gpt-base grown in "
              f"{mgr.grow_seconds:.3f} s, prewarm {mgr.prewarm_seconds:.2f} s"
              f" ({len(mgr.prewarm_shapes)} admissions), swap pause "
              f"{mgr.pause_ms:.2f} ms at dispatch "
              f"{watch.at['before']['dispatches']} of wave {waves}, "
              f"{mgr.resumed} resumed, greedy agreement "
              f"{mgr.fp_token_agreement:.3f}; served {16 * waves} requests "
              f"in {serve_s:.2f} s; post-swap acceptance of gpt-small "
              f"drafting for the grown gpt-base (d {UPGRADE_D}) "
              f"{eng.acceptance_rate:.4f} ({eng.n_spec_accepted}/"
              f"{eng.n_spec_proposed}); pages resident at the swap "
              f"{mgr.pages_resident_at_swap}, re-prefilled "
              f"{mgr.pages_reprefilled}, in use at the end "
              f"{eng.pages_in_use}; requests {kinds} == the plain routes "
              f"(grown weights #{key}), near ties {ties}; launches "
              f"{launches}", flush=True)
        return res, mgr

    def exact_launches(label, eng, watch, launches, pool):
        """The synchronous run's launches: gpt-small's slot kernel each
        layer of each decode step and flash each layer of each admission
        group before the swap; after it, the grown gpt-base verifying with
        gpt-small drafting (d 4)."""
        b = watch.at["before"]
        disp_pre, disp_post = b["dispatches"], \
            eng.n_decode_dispatches - b["dispatches"]
        groups_pre = b["prefills"]
        groups_post = (eng.n_prefills - b["prefills"]) // 2
        blocks = UPGRADE_K * disp_post
        steps_pre = UPGRADE_K * disp_pre + b["tail_steps"]
        slot, verify = (("paged_slot_decode_attention",
                         "paged_chunk_verify_attention") if pool == "paged"
                        else ("slot_decode_attention",
                              "chunk_verify_attention"))
        want = {n: 0 for n in kern}
        want[slot] = cfg_s.n_layers * (steps_pre + UPGRADE_D * blocks)
        want[verify] = (cfg_t.n_layers + cfg_s.n_layers) * blocks
        want["flash_attention"] = (cfg_s.n_layers * groups_pre
                                   + (cfg_t.n_layers + cfg_s.n_layers)
                                   * groups_post)
        if launches != want:
            raise AssertionError(f"{label}: launched {launches}, expected "
                                 f"{want} ({disp_pre} + {disp_post} "
                                 f"dispatches, {groups_pre} + {groups_post} "
                                 "admission groups)")
        return want

    engine("dense").run([upgrade_requests()[0]])  # first-use costs
    report["background"], _ = one_run("dense", True)
    report["dense"], mgr = one_run("dense", False)
    report["paged"], _ = one_run("paged", False)
    plain.clear()
    grown_seen.clear()
    report["sampled_recovery"] = run_recovery(cfg_t, mgr.grown_params)
    return report, mgr.grown_params


def run_recovery(cfg, params):
    """Phase 14, part c: the grown gpt-base sampled (phase 13's policy)
    with a journal and a snapshot, crashed after 3 dispatches (3 engine
    iterations, then the engine dropped), restored from the snapshot and
    resumed from the journal; tokens == the uninterrupted run's up to
    near ties of the perturbed scores.  Then the same through the
    launcher's --journal, --snapshot and --resume."""
    import shutil

    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launch_serve
    from repro_torch.serve import (
        ContinuousBatchingEngine,
        RequestJournal,
        SamplingParams,
        read_journal,
        recovery_requests,
        restore_engine,
        snapshot_engine,
    )

    sp = SamplingParams(**SAMPLED)
    work = ROOT / "build" / "phase14"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)

    def engine(journal=None):
        return ContinuousBatchingEngine(cfg, params, capacity=8,
                                        max_len=512, k=UPGRADE_K,
                                        prefill_bucket=16, sampling=sp,
                                        journal=journal)

    def crash(eng, reqs, steps=3):
        for r in reqs:
            eng.submit(r)
        for _ in range(steps):
            eng.step()
        if eng._inflight or not (eng.waiting or eng.active):
            raise AssertionError("the crash point is not mid-trace")
        eng.journal.close()

    def compare(what, p, reqs, got, want):
        """Sampled tokens equal, or a first mismatch at a near tie of the
        perturbed scores (a sequential replay, run only where they
        differ)."""
        ties = []
        for r in reqs:
            a, b = got[r.uid], want[r.uid]
            if np.array_equal(a, b):
                continue
            _, gaps = sampled_replay_on_card(cfg, p, r, sp, b)
            tie = check_same_tokens(what, r.uid, a[:len(b)], b[:len(a)],
                                    gaps)
            ties.append(tie)
        return ties

    reqs = upgrade_requests()
    t0 = time.perf_counter()
    want = engine().run(reqs)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    journal = work / "journal.jsonl"
    t0 = time.perf_counter()
    snap = snapshot_engine(engine(), str(work / "snapshot"))
    snap_s = time.perf_counter() - t0
    crash(engine(RequestJournal(str(journal))), upgrade_requests())
    gc.collect()
    t0 = time.perf_counter()
    st = read_journal(str(journal))
    resumed, done = recovery_requests(st)
    eng = restore_engine(str(work / "snapshot"),
                         journal=RequestJournal(str(journal)))
    restore_s = time.perf_counter() - t0
    flash = ops.kernels()["flash_attention"]
    flash_before = flash.launches
    got = {**done, **eng.run(resumed)}
    eng.journal.close()
    flash_resume = flash.launches - flash_before
    if not any(r.n_committed for r in resumed) or set(got) != set(want):
        raise AssertionError(f"resume: {len(resumed)} resumed, outputs "
                             f"{sorted(got)}")
    ties = compare("resumed and uninterrupted sampled runs", params, reqs,
                   got, want)
    if flash_resume != cfg.n_layers * eng.n_prefills:
        raise AssertionError(f"the resumed run launched flash "
                             f"{flash_resume} times in {eng.n_prefills} "
                             "admission groups")
    print(f"sampled crash/resume: snapshot {snap_s:.2f} s ({snap}), crash "
          f"after 3 dispatches, restore {restore_s:.2f} s; "
          f"{len(resumed)} resumed ({sum(r.n_committed for r in resumed)} "
          f"committed tokens re-prefilled by flash, {flash_resume} launches "
          f"in {eng.n_prefills} groups), {len(done)} complete; tokens == "
          f"the uninterrupted run ({plain_s:.2f} s) for "
          f"{len(reqs) - len(ties)}/{len(reqs)}, near ties {ties}",
          flush=True)

    # the same through the launcher: a run with --journal and --snapshot,
    # a crash of its restored engine, then --resume
    argv = ["--arch", "gpt-base", "--engine", "continuous", "--batch", "16",
            "--capacity", "8", "--prompt-len", "384", "--gen", "64",
            "--max-len", "512", "--temperature", str(sp.temperature),
            "--top-k", str(sp.top_k), "--top-p", str(sp.top_p),
            "--sample-seed", str(sp.seed)]
    j1, j2 = work / "launch1.jsonl", work / "launch2.jsonl"
    t0 = time.perf_counter()
    launch_serve.main([*argv, "--journal", str(j1), "--snapshot",
                       str(work / "launch_snap")])
    leng = restore_engine(str(work / "launch_snap"),
                          journal=RequestJournal(str(j2)))
    lreqs = launch_serve.trace_requests(leng.cfg, 16, 384, 64)
    crash(leng, lreqs)
    lparams = leng.params
    del leng
    gc.collect()
    launch_serve.main([*argv, "--journal", str(j2), "--resume"])
    launch_s = time.perf_counter() - t0
    a, b = read_journal(str(j1)), read_journal(str(j2))
    if set(a.finished) != set(range(16)) or a.finished != b.finished:
        raise AssertionError(f"launcher journals: {a.finished} vs "
                             f"{b.finished}")
    lties = compare("launcher resumed and uninterrupted runs", lparams,
                    lreqs, {u: np.asarray(t) for u, t in b.committed.items()},
                    {u: np.asarray(t) for u, t in a.committed.items()})
    print(f"launcher --journal/--snapshot, a crash after 3 dispatches, "
          f"--resume: {launch_s:.1f} s; resumed tokens == the uninterrupted "
          f"launcher run for {16 - len(lties)}/16, near ties {lties}",
          flush=True)
    shutil.rmtree(work, ignore_errors=True)
    return dict(snapshot_s=snap_s, restore_s=restore_s,
                resumed=len(resumed), complete=len(done), near_ties=ties,
                launcher_s=launch_s, launcher_near_ties=lties)


FAULT_PLAN = "nan@2,oom@3:2,slow@4:0.05,malformed@5"  # phase 15, part a
FAULT_DEADLINE, FAULT_HANG = 2.0, 3.0  # phase 15, part c (seconds)
FAULT_SHED_AGE = 0.25  # phase 15, part d (seconds)


def run_faults(small, big):
    """Phase 15: the fault layer on the grown gpt-base (phase 14's) with
    phase 5's gpt-small drafting, phase 7's 16 requests, capacity 8, max_len
    1024, K 8: (a) FAULT_PLAN on the dense pool and a 48-page paged pool --
    exactly one request quarantined with a prefix of its plain-route
    tokens, every other request equal to the plain route, the paged arena
    degraded (full reservations) with no page in use at the end; (b) a
    draft-pool NaN (d 4, K 2): one fallback to plain decode, nothing
    quarantined, every token unchanged; (c) a hang past the engine's
    deadline on the wall clock: every request expired, the run bounded;
    (d) queue-age shedding at capacity 1; (e) the launcher crashed by
    ``--faults crash@3`` and resumed by ``--resume``: 16/16 requests equal
    the uninterrupted launcher run; (f) ``run(realtime=True)`` over seeded
    arrival offsets: time to first token per request and the gaps between
    block readbacks.  Exact launches in (a) and (b)."""
    import dataclasses
    import shutil

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launch_serve
    from repro_torch.serve import (
        ContinuousBatchingEngine,
        Fault,
        FaultPlan,
        SpeculativeConfig,
        read_journal,
    )

    cfg_s, cfg = get_config("gpt-small"), get_config("gpt-base")
    L, Ls = cfg.n_layers, cfg_s.n_layers
    reqs = paged_requests(cfg.vocab_size)
    kern = ops.kernels()
    report = {}
    t0 = time.perf_counter()
    plain = {r.uid: plain_greedy(cfg, big, r.prompt, 64) for r in reqs}
    report["plain_route_s"] = time.perf_counter() - t0

    def engine(**kw):
        kw = dict(dict(capacity=8, max_len=1024, k=8), **kw)
        return ContinuousBatchingEngine(cfg, big, **kw)

    def serve(eng, rs=reqs, **kw):
        for fn in kern.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = eng.run([dataclasses.replace(r) for r in rs], **kw)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t, {
            n: fn.launches for n, fn in kern.items()}

    def against_plain(what, eng, out):
        """Finished requests == plain; a quarantined one a prefix of it."""
        ties = []
        for r in reqs:
            got, (want, gaps) = out.get(r.uid), plain[r.uid]
            o = eng.outcomes.get(r.uid)
            if o == "quarantined":
                if not 0 <= len(got) < 64:
                    raise AssertionError(f"{what}: quarantined uid {r.uid} "
                                         f"delivered {len(got)} tokens")
                want, gaps = want[:len(got)], gaps[:len(got)]
            elif o != "finished" or got.shape != (64,):
                raise AssertionError(f"{what}: uid {r.uid} {o} {got}")
            tie = check_against_plain(what, r.uid, got, want, gaps)
            if tie is not None:
                ties.append(tie)
        return ties

    # (a) the plan on both pools
    for pool in ("dense", "paged"):
        eng = engine(pool=pool, pages=PAGED_PAGES if pool == "paged" else
                     None, faults=FaultPlan.parse(FAULT_PLAN))
        out, dt, launches = serve(eng)
        slot = "paged_slot_decode_attention" if pool == "paged" else \
            "slot_decode_attention"
        want = {n: 0 for n in kern}
        want[slot] = L * (eng.k * eng.n_decode_dispatches
                          + eng.n_prefix_tail_steps)
        want["flash_attention"] = L * eng.n_prefills
        bad = {u: o for u, o in eng.outcomes.items() if o != "finished"}
        quarantined = [u for u, o in bad.items() if o == "quarantined"]
        if (launches != want or eng.n_faults_injected != 4
                or eng.n_quarantined != 1 or len(quarantined) != 1
                or set(bad) != {quarantined[0], -1005}
                or "empty prompt" not in eng.rejected.get(-1005, "")
                or eng._oom_waves):
            raise AssertionError(f"faults on the {pool} pool: launches "
                                 f"{launches} (expected {want}), outcomes "
                                 f"{bad}, rejected {eng.rejected}")
        if pool == "paged" and not (eng._arena_degraded
                                    and eng.n_degraded_admissions > 0
                                    and eng.pages_in_use == 0):
            raise AssertionError(
                f"paged faults: degraded {eng._arena_degraded}, "
                f"{eng.n_degraded_admissions} degraded admissions, "
                f"{eng.pages_in_use} pages in use")
        ties = against_plain(f"faults {pool}", eng, out)
        report[f"plan_{pool}"] = dict(
            seconds=dt, quarantined=quarantined[0],
            quarantined_tokens=len(out[quarantined[0]]),
            degraded_admissions=eng.n_degraded_admissions,
            dispatches=eng.n_decode_dispatches, near_ties=ties,
            launches={n: v for n, v in launches.items() if v})
        print(f"faults {FAULT_PLAN} on the {pool} pool: {dt:.3f} s; "
              f"{eng.n_faults_injected} injected, uid {quarantined[0]} "
              f"quarantined after {len(out[quarantined[0]])} tokens (a "
              f"prefix of its plain route), uid -1005 rejected (empty "
              f"prompt), {eng.n_degraded_admissions} degraded admissions, "
              f"{eng.pages_in_use} pages in use at the end; the other 15 "
              f"== plain route but near ties {ties}; launches "
              f"{report[f'plan_{pool}']['launches']}", flush=True)
        del eng

    # (b) a NaN in the draft's pool: speculation falls back, once
    d, k = 4, 2
    eng = engine(k=k, speculative=SpeculativeConfig(cfg_s, small, d=d),
                 faults=FaultPlan([Fault("nan", 2, pool=1)]))
    modes = []
    dispatch = eng._dispatch

    def counted_dispatch():
        modes.append(not eng._spec_fallback)
        dispatch()
    eng._dispatch = counted_dispatch
    out, dt, launches = serve(eng)
    del eng._dispatch
    n_spec, n_plain = sum(modes), len(modes) - sum(modes)
    want = {n: 0 for n in kern}
    want["slot_decode_attention"] = k * (Ls * d * n_spec + L * n_plain)
    want["chunk_verify_attention"] = (L + Ls) * k * n_spec
    want["flash_attention"] = (L + Ls) * (eng.n_prefills // 2)
    if (launches != want or eng.n_spec_fallbacks != 1
            or eng.n_quarantined != 0 or not n_plain):
        raise AssertionError(f"draft NaN: launches {launches} (expected "
                             f"{want}), {eng.n_spec_fallbacks} fallbacks, "
                             f"{eng.n_quarantined} quarantined")
    ties = against_plain("draft NaN", eng, out)
    report["draft_nan"] = dict(seconds=dt, spec_dispatches=n_spec,
                               plain_dispatches=n_plain, near_ties=ties,
                               launches={n: v for n, v in launches.items()
                                         if v})
    print(f"draft-pool NaN under gpt-small drafting (d {d}, K {k}): "
          f"{dt:.3f} s; {eng.n_spec_fallbacks} fallback after {n_spec} "
          f"speculative dispatches ({n_plain} plain after it), "
          f"{eng.n_quarantined} quarantined; 16/16 == plain route but near "
          f"ties {ties}; launches {report['draft_nan']['launches']}",
          flush=True)
    del eng

    # (c) a hang past the deadline, on the wall clock
    eng = engine(deadline=FAULT_DEADLINE,
                 faults=FaultPlan([Fault("hang", 2, duration=FAULT_HANG)]))
    out, dt, _ = serve(eng)
    if (eng.n_expired != 16 or set(eng.outcomes.values()) != {"expired"}
            or set(out) != {r.uid for r in reqs} or dt > 4 * FAULT_HANG):
        raise AssertionError(f"hang: {eng.n_expired} expired, outcomes "
                             f"{eng.outcomes}, {dt:.1f} s")
    partial = sorted(len(v) for v in out.values())
    report["hang"] = dict(seconds=dt, expired=eng.n_expired,
                          tokens=partial)
    print(f"hang {FAULT_HANG} s past a {FAULT_DEADLINE} s deadline: all 16 "
          f"expired in {dt:.2f} s (partial outputs of {partial} tokens, "
          f"the queued ones empty)", flush=True)
    del eng

    # (d) queue-age shedding at capacity 1
    eng = engine(capacity=1, shed_age=FAULT_SHED_AGE,
                 faults=FaultPlan([Fault("slow", 1, duration=0.5)]))
    out, dt, _ = serve(eng)
    shed = sorted(u for u, o in eng.outcomes.items() if o == "shed")
    served = sorted(u for u, o in eng.outcomes.items() if o == "finished")
    if (not shed or eng.n_shed != len(shed)
            or len(shed) + len(served) != 16
            or not all("shed after" in eng.rejected[u] for u in shed)):
        raise AssertionError(f"shedding: outcomes {eng.outcomes}")
    for u in served:
        if check_against_plain("shed run", u, out[u], *plain[u]):
            raise AssertionError(f"shed run: uid {u} near tie")
    report["shed"] = dict(seconds=dt, shed=len(shed), served=served)
    print(f"shedding at capacity 1 (shed_age {FAULT_SHED_AGE} s, a 0.5 s "
          f"slow dispatch): {len(shed)} shed, {served} served (== plain "
          f"route) in {dt:.2f} s", flush=True)
    del eng

    # (e) the launcher crashed by its plan, then resumed
    work = ROOT / "build" / "phase15"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    argv = ["--arch", "gpt-base", "--engine", "continuous", "--batch", "16",
            "--capacity", "8", "--prompt-len", "384", "--gen", "64",
            "--max-len", "512"]
    j0, j1 = str(work / "whole.jsonl"), str(work / "crashed.jsonl")
    t0 = time.perf_counter()
    launch_serve.main([*argv, "--journal", j0])
    launch_serve.main([*argv, "--journal", j1, "--faults", "crash@3"])
    crashed = read_journal(j1)
    launch_serve.main([*argv, "--journal", j1, "--resume"])
    launch_s = time.perf_counter() - t0
    a, b = read_journal(j0), read_journal(j1)
    if (set(a.finished) != set(range(16)) or a.finished != b.finished
            or len(crashed.finished) == 16
            or not any(crashed.committed.values())):
        raise AssertionError(f"launcher crash: {crashed.finished} at the "
                             f"crash, then {b.finished} vs {a.finished}")
    lties = []
    for u in range(16):
        got, want = np.asarray(b.committed[u]), np.asarray(a.committed[u])
        if np.array_equal(got, want):
            continue
        lparams = launch_serve.build_params(cfg, device="cuda",
                                            log_fn=lambda *_: None)
        lreq = launch_serve.trace_requests(cfg, 16, 384, 64)[u]
        gaps = plain_greedy(cfg, lparams, lreq.prompt, 64)[1]
        lties.append(check_same_tokens("launcher resumed and whole runs", u,
                                       got, want, gaps))
    shutil.rmtree(work, ignore_errors=True)
    report["launcher_crash"] = dict(seconds=launch_s, near_ties=lties,
                                    committed_at_crash=sum(
                                        len(v) for v in
                                        crashed.committed.values()))
    print(f"launcher --faults crash@3 then --resume: "
          f"{report['launcher_crash']['committed_at_crash']} tokens "
          f"committed at the crash; {16 - len(lties)}/16 resumed requests "
          f"== the whole launcher run (near ties {lties}); {launch_s:.1f} s "
          f"for the three launcher runs", flush=True)

    # (f) run(realtime=True): time to first token and block gaps
    rng = np.random.default_rng(15)
    arrivals = np.cumsum(rng.exponential(0.05, len(reqs)))
    timed = [dataclasses.replace(r, arrival=float(a))
             for r, a in zip(reqs, arrivals)]
    eng = engine()
    reads = []
    process = eng._process

    def stamped(item):
        process(item)
        reads.append(time.monotonic())
    eng._process = stamped
    torch.cuda.synchronize()
    t_run = time.monotonic()
    out = eng.run(timed, realtime=True)
    torch.cuda.synchronize()
    dt = time.monotonic() - t_run
    del eng._process
    ttft = {s.req.uid: (s.t_first - t_run - s.req.arrival) * 1e3
            for s in eng.retired}
    gaps = np.diff(reads) * 1e3
    if set(ttft) != {r.uid for r in reqs} or min(ttft.values()) < 0:
        raise AssertionError(f"realtime: ttft {ttft}")
    ties = against_plain("realtime run", eng, out)
    report["realtime"] = dict(
        seconds=dt, arrivals_s=arrivals.tolist(), ttft_ms=ttft,
        block_gap_ms=gaps.tolist(), k=eng.k, near_ties=ties)
    tt = np.array(list(ttft.values()))
    print(f"run(realtime=True) over arrivals at {arrivals[0]:.3f}.."
          f"{arrivals[-1]:.3f} s: {dt:.2f} s; time to first token per "
          f"request (ms) {[round(ttft[u], 1) for u in sorted(ttft)]} "
          f"(median {np.median(tt):.1f}, max {tt.max():.1f}); gap between "
          f"block readbacks ({eng.k} tokens a row each) median "
          f"{np.median(gaps):.2f} ms, p90 {np.percentile(gaps, 90):.2f} ms, "
          f"max {gaps.max():.2f} ms over {len(gaps)} gaps; tokens == plain "
          f"route but near ties {ties}", flush=True)
    return report



GRIFFIN_GROW_PRE, GRIFFIN_GROW_OP, GRIFFIN_GROW_TRAIN = 100, 10, 5  # 16a
RG_TRAIN_B, RG_TRAIN_S, RG_TRAIN_STEPS = 2, 512, 3  # phase 16b


def _launch_counts(kern, zero=False):
    counts = {name: fn.launches for name, fn in kern.items()}
    if zero:
        for fn in kern.values():
            fn.launches = 0
    return counts


def run_launcher(argv):
    """``repro_torch.launch.serve.main(argv)`` in this process (on the
    card); -> its standard output, also printed."""
    import contextlib
    import io

    from repro_torch.launch import serve as launch_serve

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        launch_serve.main(argv)
    out = buf.getvalue()
    print(out, end="", flush=True)
    return out


def run_griffin_grown_pair(kernel_rows):
    """Phase 16a: griffin-micro pretrained GRIFFIN_GROW_PRE steps, grown
    into griffin-micro-big by rank-1 Mango after GRIFFIN_GROW_OP operator
    steps (exact launches: a sandwich a group, a scan and a backward scan
    a recurrent layer), the held-out margin scratch - grown, the grown
    model trained GRIFFIN_GROW_TRAIN steps (the scan and its backward,
    exact launches); then the griffin upgrade command through the serve
    launcher (griffin-micro grown live into griffin-micro-big, swapped at
    dispatch 1, griffin-micro drafting after the swap; ring kernels at
    head dims 16 and 32) and a longer run whose swap lands mid-flight, so
    the grown model decodes and verifies griffin-micro's proposals."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import grow as growlib
    from repro_torch.data import lm_data_iter
    from repro_torch.kernels import ops
    from repro_torch.models import get_family, griffin
    from repro_torch.optim import OptimizerConfig, make_optimizer
    from repro_torch.train.loss import loss_for
    from repro_torch.train.steps import make_eval_step, make_train_step

    kern = ops.kernels()
    cfg_s, cfg_t = get_config("griffin-micro"), get_config("griffin-micro-big")
    fam_s, fam_t = get_family(cfg_s), get_family(cfg_t)
    n_rec_t = griffin.block_pattern(cfg_t).count("rec")

    def on(b):
        return {k: torch.as_tensor(v, device="cuda") for k, v in b.items()}

    _launch_counts(kern, zero=True)
    t0 = time.perf_counter()
    small = fam_s.init(torch.Generator(device="cuda").manual_seed(0), cfg_s)
    opt = OptimizerConfig(lr=3e-3)
    init_fn, _ = make_optimizer(opt)
    state, step = init_fn(small), make_train_step(cfg_s, opt)
    data = lm_data_iter(cfg_s.vocab_size, 8, 64, seed=0)
    pre = []
    for i in range(GRIFFIN_GROW_PRE):
        small, state, m = step(small, state, on(next(data)), i + 1)
        if i in (0, GRIFFIN_GROW_PRE - 1):
            pre.append(float(m["loss"]))
    pre_s = time.perf_counter() - t0
    pre_launches = _launch_counts(kern, zero=True)
    n_rec_s = griffin.block_pattern(cfg_s).count("rec")
    want = {name: 0 for name in kern}
    want.update(rglru_scan=n_rec_s * GRIFFIN_GROW_PRE,
                rglru_scan_bwd=n_rec_s * GRIFFIN_GROW_PRE)
    if pre_launches != want:
        raise AssertionError(f"griffin-micro pretraining launched "
                             f"{pre_launches}, expected {want}")
    lf = loss_for(cfg_t)

    def op_loss(big, b):
        logits, aux = fam_t.forward(big, b, cfg_t)
        return lf(logits, aux, b, cfg_t)[0]

    t0 = time.perf_counter()
    gop, op = growlib.build("mango", cfg_s, cfg_t, rank=1, device="cuda")
    op, op_losses = growlib.train_operator(
        gop, op, small, op_loss, lm_data_iter(cfg_t.vocab_size, 8, 64,
                                              seed=3),
        steps=GRIFFIN_GROW_OP, lr=2e-3)
    with torch.no_grad():
        big = growlib.grow_params(gop, op, small)
    torch.cuda.synchronize()
    op_s = time.perf_counter() - t0
    grow_launches = _launch_counts(kern, zero=True)
    # an operator step grows the target (a sandwich a group) and runs its
    # forward and backward (a scan and a backward scan a recurrent layer);
    # grow_params after the last step is one more growth
    n_groups = len(gop.op.plan_src.groups)
    want = {name: 0 for name in kern}
    want.update(tr_sandwich=n_groups * (GRIFFIN_GROW_OP + 1),
                rglru_scan=n_rec_t * GRIFFIN_GROW_OP,
                rglru_scan_bwd=n_rec_t * GRIFFIN_GROW_OP)
    if grow_launches != want:
        raise AssertionError(f"griffin growth ({GRIFFIN_GROW_OP} operator "
                             f"steps, {n_groups} groups, {n_rec_t} "
                             f"recurrent layers) launched {grow_launches}, "
                             f"expected {want}")
    scratch = fam_t.init(torch.Generator(device="cuda").manual_seed(99),
                         cfg_t)
    ev = make_eval_step(cfg_t)
    held = on(next(lm_data_iter(cfg_t.vocab_size, 8, 64, seed=50)))
    l_grown = float(ev(big, held)["loss"])
    l_scratch = float(ev(scratch, held)["loss"])
    if not l_grown < l_scratch:
        raise AssertionError(f"grown griffin-micro-big ({l_grown:.4f}) does "
                             f"not start below scratch ({l_scratch:.4f})")
    state_t, step_t = init_fn(big), make_train_step(cfg_t, opt)
    data_t = lm_data_iter(cfg_t.vocab_size, 8, 64, seed=4)
    _launch_counts(kern, zero=True)
    grown_losses = []
    for i in range(GRIFFIN_GROW_TRAIN):
        big, state_t, m = step_t(big, state_t, on(next(data_t)), i + 1)
        grown_losses.append(float(m["loss"]))
    got = _launch_counts(kern, zero=True)
    want = {name: 0 for name in kern}
    want.update(rglru_scan=n_rec_t * GRIFFIN_GROW_TRAIN,
                rglru_scan_bwd=n_rec_t * GRIFFIN_GROW_TRAIN)
    if got != want:
        raise AssertionError(f"grown griffin training launched {got}, "
                             f"expected {want}")
    print(f"griffin-micro pretrained {GRIFFIN_GROW_PRE} steps ({pre[0]:.4f}"
          f" -> {pre[1]:.4f}, {pre_s:.1f} s); Mango operator "
          f"{GRIFFIN_GROW_OP} steps ({op_losses[0]:.4f} -> "
          f"{op_losses[-1]:.4f}, {op_s:.1f} s; launches {grow_launches}, "
          f"exact: {n_groups} sandwiches a growth, {n_rec_t} + {n_rec_t} "
          f"scans a step; pretraining {pre_launches}); "
          f"held-out loss grown {l_grown:.4f} vs scratch {l_scratch:.4f} "
          f"(margin {l_scratch - l_grown:.4f}); grown trained "
          f"{GRIFFIN_GROW_TRAIN} steps {[round(x, 4) for x in grown_losses]}"
          f", launches {got}", flush=True)

    f1 = ["--arch", "griffin-micro", "--engine", "continuous", "--batch",
          "2", "--gen", "4", "--grow-cfg", "griffin-micro-big",
          "--upgrade-at", "1", "--upgrade-sync"]
    out = run_launcher(f1)
    f1_launches = _launch_counts(kern, zero=True)
    if "greedy agreement 1.000" not in out or \
            "post-swap speculation draft=griffin-micro" not in out:
        raise AssertionError("the griffin upgrade command did not swap "
                             "with agreement 1.000 and griffin-micro "
                             "drafting")
    long = ["--arch", "griffin-micro", "--engine", "continuous", "--batch",
            "4", "--gen", "24", "--k", "2", "--grow-cfg",
            "griffin-micro-big", "--upgrade-at", "2", "--upgrade-sync"]
    out_long = run_launcher(long)
    long_launches = _launch_counts(kern, zero=True)
    acc = out_long.split("acceptance ")[1].split(" ")[1].strip("(),")
    accepted, proposed = (int(x) for x in acc.split("/"))
    if "greedy agreement 1.000" not in out_long or not proposed or \
            not long_launches["ring_decode_attention"]:
        raise AssertionError(f"the mid-flight swap did not speculate on the "
                             f"grown model: {proposed} proposals, launches "
                             f"{long_launches}")
    kernel_rows["rglru_scan_bwd"]["launches_16a"] = got["rglru_scan_bwd"]
    return dict(pretrain_losses=pre, pretrain_seconds=pre_s,
                operator_losses=op_losses, operator_seconds=op_s,
                grown_loss=l_grown, scratch_loss=l_scratch,
                margin=l_scratch - l_grown, grown_train_losses=grown_losses,
                pretrain_launches=pre_launches,
                grow_launches=grow_launches, train_launches=got,
                f1_output=out, f1_launches=f1_launches,
                long_output=out_long, long_launches=long_launches,
                acceptance=(accepted, proposed))


def run_griffin_train(kernel_rows):
    """Phase 16b: recurrentgemma-2b at full width and depth (26 x 2560,
    f32, seeded weights) trained RG_TRAIN_STEPS AdamW steps at B 2 x S
    512 (params and moments updated in place): step 0's
    loss and gradient norm against the plain route on the same weights and
    batch (the scan through ``ref.rglru_scan_ref`` under autograd: 1e-5
    and 1e-4 relative), exact scan launches (18 forward and 18 backward a
    step, no other kernel), ms/step against the f32 FLOP bound, peak
    memory."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import lm_batch
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.serve import build_params
    from repro_torch.models import get_family, griffin
    from repro_torch.optim import OptimizerConfig, make_optimizer
    from repro_torch.optim.adamw import global_norm
    from repro_torch.train.loss import loss_for
    from repro_torch.train.steps import make_train_step, value_and_grad

    kern = ops.kernels()
    cfg = get_config("recurrentgemma-2b").replace(param_dtype="float32",
                                                 compute_dtype="float32")
    fam, lf = get_family(cfg), loss_for(cfg)
    pat = griffin.block_pattern(cfg)
    n_rec, n_attn = pat.count("rec"), pat.count("attn")
    t0 = time.perf_counter()
    params = build_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = list(_leaves(params))
    n_params = sum(t.numel() for t in leaves)
    n_mm = sum(t.numel() for t in leaves if t.dim() >= 2)
    batch = {"tokens": torch.from_numpy(lm_batch(
        cfg.vocab_size, RG_TRAIN_B, RG_TRAIN_S, seed=16)).cuda()}

    def fwd_loss(p, b):
        logits, aux = fam.forward(p, b, cfg)
        return lf(logits, aux, b, cfg)

    # the plain route: step 0's gradient with the scan's plain version
    orig = ops.rglru_scan
    ops.rglru_scan = ref.rglru_scan_ref
    try:
        before = _launch_counts(kern)
        t0 = time.perf_counter()
        grads, pm = value_and_grad(fwd_loss, params, batch)
        plain_loss, plain_norm = float(pm["loss"]), float(global_norm(grads))
        plain_s = time.perf_counter() - t0
        if _launch_counts(kern) != before:
            raise AssertionError("the plain route launched a CUDA kernel")
    finally:
        ops.rglru_scan = orig
    del grads
    gc.collect()
    torch.cuda.empty_cache()

    # the step updates params and moments in place, as the reference
    # launcher's jitted step donates them: new trees would hold two copies
    # of 10.7 GB of params and 21.4 GB of moments, past the card's 80 GB
    opt = OptimizerConfig(lr=1e-4)
    init_fn, _ = make_optimizer(opt)
    state = init_fn(params)
    step = make_train_step(cfg, opt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _launch_counts(kern, zero=True)
    ms, metrics = [], []
    for i in range(RG_TRAIN_STEPS):
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch, i + 1)
        m = {k: float(v) for k, v in m.items()}  # reads back: synchronises
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        metrics.append(m)
    peak = torch.cuda.max_memory_allocated()
    got = _launch_counts(kern, zero=True)
    want = {name: 0 for name in kern}
    want.update(rglru_scan=n_rec * RG_TRAIN_STEPS,
                rglru_scan_bwd=n_rec * RG_TRAIN_STEPS)
    if got != want:
        raise AssertionError(f"recurrentgemma-2b training launched {got}, "
                             f"expected {want}")
    loss_rel = abs(metrics[0]["loss"] - plain_loss) / abs(plain_loss)
    norm_rel = abs(metrics[0]["grad_norm"] - plain_norm) / abs(plain_norm)
    if loss_rel > 1e-5 or norm_rel > 1e-4:
        raise AssertionError(f"step 0 against the plain route: loss "
                             f"{metrics[0]['loss']} vs {plain_loss} "
                             f"({loss_rel:.3g}), grad norm "
                             f"{metrics[0]['grad_norm']} vs {plain_norm} "
                             f"({norm_rel:.3g})")
    if not all(torch.isfinite(t).all() for t in _leaves(params)):
        raise AssertionError("recurrentgemma-2b training left a non-finite "
                             "parameter")
    tokens = RG_TRAIN_B * RG_TRAIN_S
    hd, H = cfg.head_dim, cfg.n_heads
    flops = (6 * tokens * n_mm
             + 3 * n_attn * 2 * RG_TRAIN_B * H * RG_TRAIN_S ** 2 * hd)
    # bytes: params, grads and AdamW's two moments, read and written
    b_ms, b_by = bound_ms(9 * 4 * n_params, flops, "float32")
    kernel_rows["rglru_scan_bwd"]["launches"] = got["rglru_scan_bwd"]
    print(f"recurrentgemma-2b training: {n_params} params ({n_mm} in "
          f"matrices; drawn in {init_s:.1f} s), B {RG_TRAIN_B} x S "
          f"{RG_TRAIN_S}, AdamW f32: ms/step {[round(x, 1) for x in ms]} "
          f"against the bound {b_ms:.1f} ms ({b_by}, {flops:.4g} FLOPs at "
          f"67 TFLOP/s f32); peak memory {peak / 2**30:.2f} GiB; losses "
          f"{[round(m['loss'], 5) for m in metrics]}; step 0 loss "
          f"{metrics[0]['loss']:.6f} vs plain {plain_loss:.6f} (rel "
          f"{loss_rel:.3g}), grad norm {metrics[0]['grad_norm']:.6f} vs "
          f"plain {plain_norm:.6f} (rel {norm_rel:.3g}; plain route "
          f"{plain_s:.1f} s); launches {got}", flush=True)
    report = dict(n_params=n_params, n_matrix_params=n_mm, ms_per_step=ms,
                  bound_ms=b_ms, bound_by=b_by, flops=flops,
                  peak_gib=peak / 2**30, metrics=metrics,
                  plain_loss=plain_loss, plain_grad_norm=plain_norm,
                  loss_rel_err=loss_rel, grad_norm_rel_err=norm_rel,
                  plain_route_seconds=plain_s, launches=got,
                  init_seconds=init_s)
    del params, state
    return report


def run_serve_batched():
    """Phase 12's addition: ``repro_torch.examples.serve_batched`` on the
    card (qwen3-0.6b-smoke, recurrentgemma-2b-smoke, xlstm-1.3b-smoke
    through ``generate``) with the same weights as a CPU run of the
    example: every row's tokens equal the CPU's; flash and
    decode_attention (qwen3) and the scan (griffin) launch."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.examples import serve_batched as example
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import build_params
    from repro_torch.utils.pytree import tree_map

    kern = ops.kernels()
    params = {a: build_params(get_config(a), seed=0, device="cuda")
              for a in example.ARCHS}
    cpu = {a: tree_map(lambda t: t.cpu(), p) for a, p in params.items()}
    _launch_counts(kern, zero=True)
    t0 = time.perf_counter()
    with torch.no_grad():
        got = example.main(["--device", "cuda"], params=params)
    card_s = time.perf_counter() - t0
    launches = _launch_counts(kern, zero=True)
    for name in ("flash_attention", "decode_attention", "rglru_scan"):
        if not launches[name]:
            raise AssertionError(f"serve_batched never launched {name}: "
                                 f"{launches}")
    with torch.no_grad():
        want = example.main(["--device", "cpu"], params=cpu)
    for arch in want:
        if not np.array_equal(got[arch], want[arch]):
            raise AssertionError(f"serve_batched {arch}: card "
                                 f"{got[arch].tolist()} != CPU "
                                 f"{want[arch].tolist()}")
    print(f"serve_batched on the card in {card_s:.1f} s, tokens == the "
          f"CPU run's for {len(want)} configs; launches {launches}",
          flush=True)
    return dict(seconds=card_s, launches=launches)


def run_serve_continuous():
    """Phase 12's addition: ``repro_torch.examples.serve_continuous`` on
    the card (qwen1.5-0.5b-smoke, a Mango-grown gpt-micro-big and
    recurrentgemma-2b-smoke: head dims 16, 16, 20) with the same weights
    as a CPU run of the example; every request's tokens equal the CPU's,
    and flash, the dense slot, the ring and the scan launch."""
    import torch

    from repro_torch.examples import serve_continuous as example
    from repro_torch.kernels import ops
    from repro_torch.utils.pytree import tree_map

    kern = ops.kernels()
    params = {name: example.model_params(name, "cuda")
              for name, _, _ in example.MODELS}
    cpu = {name: tree_map(lambda t: t.cpu(), p) for name, p in params.items()}
    _launch_counts(kern, zero=True)
    t0 = time.perf_counter()
    with torch.no_grad():
        got = example.main(["--device", "cuda"], params=params)
    card_s = time.perf_counter() - t0
    launches = _launch_counts(kern, zero=True)
    for name in ("flash_attention", "slot_decode_attention",
                 "ring_decode_attention", "rglru_scan"):
        if not launches[name]:
            raise AssertionError(f"serve_continuous never launched {name}: "
                                 f"{launches}")
    with torch.no_grad():
        want = example.main(["--device", "cpu"], params=cpu)
    for name in want:
        for uid in want[name]:
            a = got[name][uid]
            a = a.cpu().numpy() if torch.is_tensor(a) else a
            b = want[name][uid]
            b = b.cpu().numpy() if torch.is_tensor(b) else b
            if list(a) != list(b):
                raise AssertionError(f"serve_continuous {name} uid {uid}: "
                                     f"card {list(a)} != CPU {list(b)}")
    print(f"serve_continuous on the card in {card_s:.1f} s, tokens == the "
          f"CPU run's for {sum(len(v) for v in want.values())} requests; "
          f"launches {launches}", flush=True)
    return dict(seconds=card_s, launches=launches)

WIN_WINDOW = 1025  # phase 17: qwen3-0.6b's window; its ring pads to 1,088
WIN_MAX_LEN = 2048
# phase 17b's arena: 4 requests' 17 pages and one donor's 16 registry
# copies, so the shared-prefix requests of the second wave hit
WIN_PAGES = 84
WIN_D, WIN_K = 4, 2  # phase 17c/d: draft depth, blocks a dispatch
WIN_DRAFT_NOISE = 1e-3  # phase 17c/d's nudged draft: noise / leaf std
# phase 17 holds its first 2 requests against the plain route (4 until PR
# 28, cut to make room for phase 18)
WIN_PLAIN_REQS = 2
WIN_SHARED = 1280  # tokens (20 pages) the shared-prefix requests open with


def window_requests(vocab):
    """Phase 17's 8 requests, 64 new tokens each, every prompt past the
    window.  Uids 0, 4, 5, 6 open with the same 1,280 tokens, then 10, 25,
    40, 55 of their own (prompts 1,290..1,335); uids 1, 2, 3, 7 have
    prompts of 1,100, 1,180, 1,250 and 1,600 tokens of their own.  At
    WIN_PAGES the first wave holds uids 0..3 and each registers its ring's
    last 16 full pages, in the order of their prefill buckets: each
    registration reclaims the one before it, so uid 0, whose prompt is
    the wave's longest, registers last and keeps its pages; uids 4..6 hit
    them in the second wave."""
    import numpy as np

    from repro_torch.data import lm_batch
    from repro_torch.serve import Request

    shared = lm_batch(vocab, 1, WIN_SHARED, seed=1700)[0]
    own = iter([1100, 1180, 1250, 1600])
    tails = iter([10, 25, 40, 55])
    out = []
    for uid in range(8):
        if uid in (0, 4, 5, 6):
            prompt = np.concatenate([shared, lm_batch(
                vocab, 1, next(tails), seed=1710 + uid)[0]])
        else:
            prompt = lm_batch(vocab, 1, next(own), seed=1720 + uid)[0]
        out.append(Request(uid=uid, prompt=prompt, max_new_tokens=64))
    return out


def predict_window_schedule(cfg, reqs):
    """The paged engine's schedule does not depend on the weights (no eos,
    fixed budgets): run phase 17b's on the CPU with a 1-layer model of the
    same paging geometry (window 1,025, max_len 2,048: a ring of 17 pages
    of 64) and count the prefix hits and misses, the admissions refused
    for want of pages, the prefill groups, the macro-steps and the pages
    high-water."""
    import dataclasses

    import torch

    from repro_torch.launch.serve import build_params
    from repro_torch.serve import ContinuousBatchingEngine

    tiny = cfg.replace(n_layers=1, d_model=8, n_heads=2, n_kv_heads=1,
                       head_dim=8, d_ff=8)
    params = build_params(tiny, seed=0, device="cpu")
    eng = ContinuousBatchingEngine(tiny, params, capacity=8,
                                   max_len=WIN_MAX_LEN, k=8, pool="paged",
                                   pages=WIN_PAGES)
    waits = []
    alloc = eng._alloc_request

    def counted(req):
        info = alloc(req)
        waits.append(info is None)
        return info
    eng._alloc_request = counted
    with torch.no_grad():
        eng.run([dataclasses.replace(r) for r in reqs])
    return dict(hits=eng.n_prefix_hits, misses=eng.n_prefix_misses,
                refused=sum(waits), n_prefills=eng.n_prefills,
                n_decode_dispatches=eng.n_decode_dispatches,
                pages_highwater=eng.pages_highwater)


def run_window(kernel_rows, smi):
    """Phase 17: qwen3-0.6b (phase 11's weights) with a window of 1,025
    over rings of 1,088 slots, 8 requests past the window: (a) the dense
    pool (the ring kernel), (b) a paged pool of WIN_PAGES pages with ring
    prefix sharing (the paged ring kernel; registry copies at admission,
    hits rebuilding their ring; hits as a CPU run of the schedule
    predicts), (c) the paged pool speculating with a nudged copy drafting
    (d 4, K 2: the paged ring decode and the paged verify's ring layout),
    (d) the same on the dense pool (the dense verify's ring layout).
    Tokens of (a)-(d) equal for all 8 requests and the plain route's for
    the first WIN_PLAIN_REQS (near ties reported), exact launches,
    acceptance strictly inside (0, 1), 0 pages in use at the end."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.serve import ContinuousBatchingEngine, SpeculativeConfig

    t0 = time.perf_counter()
    cfg, params = qwen_model()
    cfg = cfg.replace(name="qwen3-0.6b-window", window=WIN_WINDOW)
    draft = nudged_copy(params, WIN_DRAFT_NOISE, seed=17)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    L, d, k = cfg.n_layers, WIN_D, WIN_K
    reqs = window_requests(cfg.vocab_size)
    t0 = time.perf_counter()
    predicted = predict_window_schedule(cfg, reqs)
    predict_s = time.perf_counter() - t0
    print(f"qwen3-0.6b window {WIN_WINDOW} (weights and a copy nudged by "
          f"{WIN_DRAFT_NOISE:g} of each leaf's std drawn in {init_s:.1f} s): "
          f"prompts {[len(r.prompt) for r in reqs]}; phase 17b's schedule "
          f"as a CPU run predicts it ({predict_s:.1f} s, 1-layer model): "
          f"{predicted}", flush=True)
    if predicted["hits"] < 1:
        raise AssertionError(f"the schedule predicts no prefix hit: "
                             f"{predicted}")

    def engine(pool, spec=False):
        return ContinuousBatchingEngine(
            cfg, params, capacity=8, max_len=WIN_MAX_LEN,
            k=k if spec else 8, pool=pool,
            pages=WIN_PAGES if pool == "paged" and not spec else None,
            speculative=SpeculativeConfig(cfg, draft, d=d) if spec else None)

    engine("dense").run([dataclasses.replace(reqs[1], max_new_tokens=2)])
    kern = ops.kernels()
    gc.collect()
    held = torch.cuda.memory_allocated()
    runs = {}
    for label, pool, spec in (("dense", "dense", False),
                              ("paged", "paged", False),
                              ("paged speculative", "paged", True),
                              ("dense speculative", "dense", True)):
        eng = engine(pool, spec)
        if eng.cache_layout != "ring" or eng.pool["dense"]["k"].shape[
                -3] != (64 if pool == "paged" else 1088):
            raise AssertionError(f"{label}: not a ring pool "
                                 f"({eng.cache_layout})")
        torch.cuda.reset_peak_memory_stats()
        for fn in kern.values():
            fn.launches = 0
        out, dt, tps, waits = timed_run(eng, reqs)
        launches = {name: fn.launches for name, fn in kern.items()}
        peak = torch.cuda.max_memory_allocated()
        steps = eng.k * eng.n_decode_dispatches
        ring = ("paged_ring_decode_attention" if pool == "paged"
                else "ring_decode_attention")
        want = {name: 0 for name in kern}
        if spec:
            verify = ("paged_chunk_verify_attention" if pool == "paged"
                      else "chunk_verify_attention")
            want.update({ring: L * d * steps, verify: 2 * L * steps})
        else:
            want[ring] = L * (steps + eng.n_prefix_tail_steps)
        if launches != want or eng.n_spec_fallbacks:
            raise AssertionError(
                f"window {label} engine launched {launches}, expected "
                f"{want} ({steps} decode steps or blocks, "
                f"{eng.n_prefix_tail_steps} tail steps, "
                f"{eng.n_spec_fallbacks} fallbacks)")
        acc = eng.acceptance_rate
        if spec and not 0.0 < acc < 1.0:
            raise AssertionError(f"window {label}: acceptance {acc} "
                                 f"({eng.n_spec_accepted}/"
                                 f"{eng.n_spec_proposed}) not inside (0, 1)")
        if pool == "paged" and eng.pages_in_use:
            raise AssertionError(f"window {label}: {eng.pages_in_use} pages "
                                 "left in use")
        sched = dict(hits=eng.n_prefix_hits, misses=eng.n_prefix_misses,
                     refused=waits, n_prefills=eng.n_prefills,
                     n_decode_dispatches=eng.n_decode_dispatches,
                     pages_highwater=eng.pages_highwater)
        if label == "paged" and sched != predicted:
            raise AssertionError(f"paged window schedule {sched} differs "
                                 f"from the CPU prediction {predicted}")
        n_tok = sum(len(v) for v in out.values())
        runs[label] = dict(
            out=out, tok_per_s=tps, seconds=dt, tokens=n_tok,
            acceptance=acc, proposed=eng.n_spec_proposed,
            accepted=eng.n_spec_accepted, schedule=sched,
            prefix_tail_steps=eng.n_prefix_tail_steps,
            pages_budget=eng.pages_budget,
            peak_above_held_mib=(peak - held) / 2**20,
            pool_bytes=_pool_bytes(eng.pool),
            host_syncs_per_token=eng.n_host_syncs / n_tok,
            launches={n: v for n, v in launches.items() if v})
        print(f"window {label}: {n_tok} tokens in {dt:.3f} s: {tps:.1f} "
              f"tok/s; acceptance {acc:.4f} ({eng.n_spec_accepted}/"
              f"{eng.n_spec_proposed}); prefix hits {eng.n_prefix_hits}, "
              f"misses {eng.n_prefix_misses}, tail steps "
              f"{eng.n_prefix_tail_steps}; pages budget {eng.pages_budget}"
              f", high-water {eng.pages_highwater}; pool "
              f"{runs[label]['pool_bytes'] / 2**20:.1f} MiB; peak "
              f"{(peak - held) / 2**20:.1f} MiB above the "
              f"{held / 2**20:.1f} MiB held; {eng.n_decode_dispatches} "
              f"dispatches, {eng.n_prefills} prefills; launches "
              f"{runs[label]['launches']} ({smi})", flush=True)
        if spec:  # every verify of phase 17 is in the ring layout
            name = ("paged_chunk_verify_attention" if pool == "paged"
                    else "chunk_verify_attention")
            kernel_rows[f"{name}[ring]"]["launches"] = launches[name]
        del eng
    del draft

    # the reference is the plain route alone (no kernel of the port)
    before = {name: fn.launches for name, fn in kern.items()}
    t0 = time.perf_counter()
    plain = {r.uid: plain_greedy(cfg, params, r.prompt, 64)
             for r in reqs[:WIN_PLAIN_REQS]}
    ties = {w: [] for w in runs}
    for r in reqs:
        dense = runs["dense"]["out"][r.uid]
        if r.uid not in plain and any(
                (runs[w]["out"][r.uid] != dense).any() for w in runs):
            # engines that disagree past the plain route's requests: the
            # plain route decides whether at a near tie
            plain[r.uid] = plain_greedy(cfg, params, r.prompt, 64)
        for what, run in runs.items():
            toks = run["out"][r.uid]
            if toks.shape != (64,) or toks.min() < 0 or \
                    toks.max() >= cfg.vocab_size:
                raise AssertionError(f"uid {r.uid}: bad {what} output")
            if r.uid in plain:
                tie = check_against_plain(f"window {what}", r.uid, toks,
                                          *plain[r.uid])
            else:
                tie = check_same_tokens(f"window {what} and dense", r.uid,
                                        toks, dense, np.full(64, np.inf))
            if tie is not None:
                ties[what].append(tie)
    plain_s = time.perf_counter() - t0
    if {name: fn.launches for name, fn in kern.items()} != before:
        raise AssertionError("the plain route launched a CUDA kernel")
    print(f"window: tokens of the {len(runs)} runs equal for all "
          f"{len(reqs)} requests and the plain route's for "
          f"{sorted(plain)} ({plain_s:.1f} s) but near ties {ties}",
          flush=True)
    for run in runs.values():
        del run["out"]
    return dict(runs=runs, near_ties=ties, predicted=predicted,
                plain_route_seconds=plain_s, init_seconds=init_s,
                window=WIN_WINDOW, max_len=WIN_MAX_LEN, nvidia_smi=smi,
                prompts=[len(r.prompt) for r in reqs])


XL_ARCH = "xlstm-1.3b"
XL_N_PARAMS = 3_606_139_216  # the reference's init, counted by eval_shape
XL_CAPACITY, XL_MAX_LEN, XL_NEW = 8, 640, 64  # phase 18a-c
XL_PROMPTS = (64, 512, 200, 333, 128, 450, 96, 270)  # phase 18's prompts
XL_PAGES = 6  # phase 18c's arena: a page a request, fewer than the slots
XL_GENERATE_REQS = 4  # phase 18a holds its first 4 against the sequential
XL_SPEC_D, XL_SPEC_K, XL_SPEC_CAP = 3, 2, 4  # phase 18d
XL_SPEC_PAGES = 4  # phase 18d's paged pool, shared by target and draft
XL_SPEC_REQS = 1  # phase 18d serves the shortest prompt (cut from 4 to 2,
# then to 1 to make room for phases 21-22)
XL_DRAFT_NOISE = 1e-3  # phase 18d's nudged draft: noise / leaf std
XL_GROW_PRE, XL_GROW_OP = 20, 5  # phase 18e: pretraining, operator steps
XL_GROW_SEQ = 32  # phase 18e's batches: 8 x 32 tokens (two chunks of 16)
XL_BUCKET = 128  # phase 18's admission buckets: fewer prefill groups
XL_TRAIN_S, XL_TRAIN_STEPS = 256, 2  # phase 18f at B 1
# phase 18b: chunkwise against the stepped recurrence at head dim 1,024, f32.
# The two sum the same terms in other orders.  The first mLSTM block sees
# the same input on both routes: its carried C/n/m must agree within
# XL_CHUNK_FIRST_RTOL of each leaf's largest entry (6e-6 on the CPU at full
# width).  Deeper blocks see inputs that already differ, and the rounding
# grows with depth (on the CPU at full width: 6e-6 at block 0, 3.5e-5 at
# block 7, logits 1.4e-4 after 9 blocks; on the card after 48 blocks: C
# 2.6e-4, logits 1.05e-3), so the whole stack is held to these:
XL_CHUNK_FIRST_RTOL = 1e-4
XL_CHUNK_STATE_RTOL = 2e-3  # every block's C/n/m, of its largest entry
XL_CHUNK_LOGIT_ATOL = 5e-3  # the last logits (max |logit| ~3.4)


def xlstm_requests(vocab):
    """Phase 18's 8 requests: prompts of 64..512 tokens, 64 new each."""
    from repro_torch.data import lm_batch
    from repro_torch.serve import Request

    return [Request(uid=uid, prompt=lm_batch(vocab, 1, n,
                                             seed=1800 + uid)[0],
                    max_new_tokens=XL_NEW)
            for uid, n in enumerate(XL_PROMPTS)]


def xlstm_sequential(cfg, params, prompt, n, dev):
    """Greedy tokens of the sequential route, ``generate``'s own (the
    prompt's prefill, then one ``decode_step`` a token, B 1), and each
    step's top-2 logit gap."""
    import numpy as np
    import torch

    from repro_torch.models import xlstm

    cache = xlstm.init_cache(cfg, 1, len(prompt) + n, device=dev)
    x = torch.as_tensor(np.asarray(prompt, np.int32), device=dev)[None]
    with torch.no_grad():
        logits, cache = xlstm.prefill(params, {"tokens": x}, cfg, cache)
        toks, gaps = [], []
        for i in range(n):
            top = logits[0].float().topk(2).values
            toks.append(logits[0].argmax().to(torch.int32))
            gaps.append(top[0] - top[1])
            if i + 1 < n:
                logits, cache = xlstm.decode_step(params, toks[-1][None],
                                                  len(prompt) + i, cache,
                                                  cfg)
    return (torch.stack(toks).cpu().numpy(),
            torch.stack(gaps).cpu().numpy())


def xlstm_graph_check(cfg, params, reqs, dev):
    """The CUDA-graph routes against the eager ones at full width: two
    prompts admitted into a 2-row pool (the sLSTM loop eager, then
    graphed), then 3 slot-decode steps with row 1 done on each pool, one
    eager and one replayed from its graph.  The logits and every pool leaf
    agree within the f32 limits (the same kernels on the same inputs; bit
    equality is reported)."""
    import numpy as np
    import torch

    from repro_torch.models import xlstm
    from repro_torch.utils.pytree import tree_leaves, tree_map

    plens = np.array([len(reqs[0].prompt), len(reqs[4].prompt)], np.int32)
    toks = np.zeros((2, int(plens.max())), np.int32)
    for j, r in enumerate((reqs[0], reqs[4])):
        toks[j, :len(r.prompt)] = r.prompt
    errs, bitwise = [], True

    def compare(got, want):
        nonlocal bitwise
        for a, b in [(got, want)] + list(zip(tree_leaves(graphed),
                                             tree_leaves(eager))):
            errs.append(check_close("xlstm graphed step", a, b, "float32"))
            bitwise = bitwise and torch.equal(a, b)

    with torch.no_grad():
        # the admission prefill (sLSTM loop graphed a position at a time)
        caches = []
        for graph in (False, True):
            xlstm.CUDA_GRAPHS = graph
            try:
                c = xlstm.init_cache(cfg, 2, XL_MAX_LEN, device=dev)
                caches.append(xlstm.prefill_last(
                    params, torch.as_tensor(toks, device=dev),
                    torch.as_tensor(plens, device=dev), cfg, c))
            finally:
                xlstm.CUDA_GRAPHS = True
        (want, eager), (got, graphed) = caches
        compare(got, want)
        done = torch.tensor([False, True], device=dev)
        nxt = torch.tensor([5, 7], dtype=torch.int32, device=dev)
        for _ in range(3):
            xlstm.CUDA_GRAPHS = False
            try:
                want, _ = xlstm.decode_step_slots(params, nxt, nxt, eager,
                                                  cfg, done=done)
            finally:
                xlstm.CUDA_GRAPHS = True
            got, _ = xlstm.decode_step_slots(params, nxt, nxt, graphed, cfg,
                                             done=done)
            compare(got, want)
            nxt = want.argmax(-1).to(torch.int32)
    print(f"xlstm graphed admission prefill (2 rows of {plens.tolist()} "
          f"tokens) and slot-decode steps (one row done, 3 steps) against "
          f"the eager ones: max abs err {max(errs):.3g} (limits "
          f"{TOL['float32']}), bit for bit: {bitwise}", flush=True)
    return dict(max_abs_err=max(errs), bitwise=bitwise)


def predict_xlstm_schedule(cfg, reqs, **engine_kw):
    """The engine's schedule does not depend on the weights (no eos, fixed
    budgets): run it on the CPU with a 2-block xlstm of width 8 (an mLSTM
    and an sLSTM block, so both slot groups page) and count the admissions
    refused for want of pages, the prefill groups, the macro-steps and the
    pages high-water."""
    import dataclasses

    import torch

    from repro_torch.launch.serve import build_params
    from repro_torch.serve import ContinuousBatchingEngine

    tiny = cfg.replace(n_layers=2, d_model=8, n_heads=2,
                       block_pattern=("m", "s"))
    eng = ContinuousBatchingEngine(tiny, build_params(tiny, seed=0,
                                                      device="cpu"),
                                   **engine_kw)
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


def _xlstm_check_tokens(label, runs, reqs, seq, cfg, params, dev):
    """Every run's tokens well formed and equal to the sequential route's
    for the requests in ``seq`` ({uid: (tokens, gaps)}, near ties
    reported); a request outside it where a run disagrees with the dense
    pool gets the sequential route too, which decides whether at a near
    tie.  Returns the near ties by run."""
    import numpy as np

    ties = {w: [] for w in runs}
    dense = runs["dense"]
    for r in reqs:
        if r.uid not in seq and any((run[r.uid] != dense[r.uid]).any()
                                    for run in runs.values() if r.uid in run):
            seq[r.uid] = xlstm_sequential(cfg, params, r.prompt, XL_NEW, dev)
        for what, run in runs.items():
            if r.uid not in run:
                continue
            toks = run[r.uid]
            if toks.shape != (XL_NEW,) or toks.min() < 0 or \
                    toks.max() >= cfg.vocab_size:
                raise AssertionError(f"uid {r.uid}: bad {label} {what} "
                                     "output")
            if r.uid in seq:
                tie = check_against_plain(f"{label} {what}", r.uid, toks,
                                          *seq[r.uid])
            else:
                tie = check_same_tokens(f"{label} {what} and dense", r.uid,
                                        toks, dense[r.uid],
                                        np.full(XL_NEW, np.inf))
            if tie is not None:
                ties[what].append(tie)
    return ties


def run_xlstm(kernel_rows, smi, cfg=None, dev="cuda"):
    """Phase 18: xlstm-1.3b at full width and depth in f32 (``cfg`` and
    ``dev`` replace it for a rehearsal at a small size on the CPU):
    (a) the dense pool, and the sequential route on the first
    XL_GENERATE_REQS requests; (b) chunkwise against the stepped
    recurrence over a 512-token prompt; (c) a paged pool of XL_PAGES pages
    (refusals, prefills, macro-steps and high-water as a CPU run of the
    schedule predicts); (d) a nudged copy drafting on the dense pool and a
    paged pool; (e) xlstm-1.3b-smoke grown into an 8 x 128 xlstm (exact
    sandwich launches, the plain version's route, the held-out margin);
    (f) 2 in-place AdamW steps at B 1 x S 256.  No kernel of the port runs
    on (a)-(d) or (f): every launch counter stays 0 there."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import build_params
    from repro_torch.models import xlstm
    from repro_torch.serve import ContinuousBatchingEngine, SpeculativeConfig
    from repro_torch.utils.pytree import tree_param_count, tree_size_bytes

    t_phase = time.perf_counter()
    full = cfg is None
    cfg = cfg or get_config(XL_ARCH).replace(param_dtype="float32",
                                             compute_dtype="float32")
    kern = ops.kernels()
    none = {name: 0 for name in kern}
    t0 = time.perf_counter()
    params = build_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = tree_param_count(params)
    if full and n_params != XL_N_PARAMS:
        raise AssertionError(f"xlstm-1.3b has {n_params} params, not "
                             f"{XL_N_PARAMS}")
    types = xlstm.block_types(cfg)
    reqs = xlstm_requests(cfg.vocab_size)
    pool_kw = dict(capacity=XL_CAPACITY, max_len=XL_MAX_LEN, k=8,
                   prefill_bucket=XL_BUCKET)
    t0 = time.perf_counter()
    predicted = predict_xlstm_schedule(cfg, reqs, pool="paged",
                                       pages=XL_PAGES, **pool_kw)
    predict_s = time.perf_counter() - t0
    print(f"xlstm-1.3b: {n_params} params ({types.count('m')} mLSTM, "
          f"{types.count('s')} sLSTM blocks, f32, drawn in {init_s:.1f} s); "
          f"prompts {list(XL_PROMPTS)}; phase 18c's schedule as a CPU run "
          f"predicts it ({predict_s:.1f} s): {predicted} ({smi})",
          flush=True)
    report = dict(n_params=n_params, init_seconds=init_s,
                  predicted=predicted, nvidia_smi=smi)

    def serve(label, make_engine, rs):
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        eng = make_engine()
        _launch_counts(kern, zero=True)
        out, dt, tps, waits = timed_run(eng, rs)
        launches = _launch_counts(kern, zero=True)
        if launches != none:
            raise AssertionError(f"xlstm {label} launched {launches}: the "
                                 "xlstm path runs no kernel of the port")
        peak = torch.cuda.max_memory_allocated() - held
        n_tok = sum(len(v) for v in out.values())
        sched = dict(refused=waits, n_prefills=eng.n_prefills,
                     n_decode_dispatches=eng.n_decode_dispatches,
                     pages_highwater=eng.pages_highwater)
        rec = dict(tok_per_s=tps, seconds=dt, tokens=n_tok, schedule=sched,
                   acceptance=eng.acceptance_rate,
                   proposed=eng.n_spec_proposed,
                   accepted=eng.n_spec_accepted,
                   pool_bytes=_pool_bytes(eng.pool)
                   + (_pool_bytes(eng.pool_d) if eng.pool_d else 0),
                   peak_above_held_gib=peak / 2**30,
                   host_syncs_per_token=eng.n_host_syncs / n_tok)
        print(f"xlstm {label}: {n_tok} tokens in {dt:.3f} s: {tps:.1f} tok/s"
              f"; acceptance {eng.acceptance_rate:.4f} "
              f"({eng.n_spec_accepted}/{eng.n_spec_proposed}); pools "
              f"{rec['pool_bytes'] / 2**30:.2f} GiB, peak "
              f"{peak / 2**30:.2f} GiB above the {held / 2**30:.2f} GiB held;"
              f" {sched}; launches none ({smi})", flush=True)
        return out, rec, eng

    # (a) the dense pool, and the sequential route on the first requests
    with torch.no_grad():
        out_a, report["dense"], eng = serve(
            "dense", lambda: ContinuousBatchingEngine(cfg, params, **pool_kw),
            reqs)
        # where a decode step's time goes: one slot-decode step, 8 live
        # rows, eager and replayed from its CUDA graph
        zeros = torch.zeros(XL_CAPACITY, dtype=torch.int32, device=dev)
        for graphed in (False, True):
            xlstm.CUDA_GRAPHS = graphed
            try:
                _, report[f"decode_profile_graph_{graphed}"] = profile_step(
                    f"xlstm-1.3b slot decode step (B 8, "
                    f"{'CUDA graph' if graphed else 'eager'})",
                    lambda: xlstm.decode_step_slots(
                        params, zeros, zeros, eng.pool, cfg,
                        done=zeros.bool()))
            finally:
                xlstm.CUDA_GRAPHS = True
        del eng  # its 5.7 GB pool goes before the sequential route
        report["graph_check"] = xlstm_graph_check(cfg, params, reqs, dev)
        t0 = time.perf_counter()
        seq = {r.uid: xlstm_sequential(cfg, params, r.prompt, XL_NEW, dev)
               for r in reqs[:XL_GENERATE_REQS]}
        report["sequential_seconds"] = time.perf_counter() - t0

    # (b) chunkwise against the recurrence stepped token by token
    r512 = next(r for r in reqs if len(r.prompt) == 512)
    x = torch.as_tensor(r512.prompt, device=dev)[None]
    with torch.no_grad():
        got = {}
        for chunkwise in (True, False):
            cache = xlstm.init_cache(cfg, 1, XL_MAX_LEN, device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = xlstm.prefill(params, {"tokens": x}, cfg, cache,
                                          chunkwise=chunkwise)
            torch.cuda.synchronize()
            got[chunkwise] = (logits, cache["m"],
                              time.perf_counter() - t0)
        (lc, mc, tc), (ls, ms, ts) = got[True], got[False]
        logit_err = float((lc - ls).abs().max())
        _, report["prefill_profile"] = profile_step(
            "xlstm-1.3b 512-token chunkwise prefill (B 1)",
            lambda: xlstm.prefill(params, {"tokens": x}, cfg,
                                  xlstm.init_cache(cfg, 1, XL_MAX_LEN,
                                                   device=dev)))

        def rel(k, sl=slice(None)):  # m: of max(1, |m|), it is a log scale
            a, b = mc[k][sl], ms[k][sl]
            return float((a - b).abs().max() / b.abs().max().clamp_min(
                1.0 if k == "m" else 1e-30))
        first = {k: rel(k, 0) for k in ("C", "n", "m")}
        state_err = {k: rel(k) for k in ("C", "n", "m")}
        finite = all(bool(torch.isfinite(t).all())
                     for t in (lc, ls, mc["C"], mc["n"], mc["m"]))
        del got, mc, ms, cache
    print(f"xlstm chunkwise (2 chunks of 256, {tc:.2f} s) against the "
          f"recurrence stepped over 512 tokens ({ts:.2f} s): the first "
          f"mLSTM block's carried C/n/m max err {first} of each leaf's "
          f"largest entry (limit {XL_CHUNK_FIRST_RTOL}); every block's "
          f"{state_err} (limit {XL_CHUNK_STATE_RTOL}); last logits max err "
          f"{logit_err:.3g} (limit {XL_CHUNK_LOGIT_ATOL})", flush=True)
    if not (finite and max(first.values()) <= XL_CHUNK_FIRST_RTOL
            and max(state_err.values()) <= XL_CHUNK_STATE_RTOL
            and logit_err <= XL_CHUNK_LOGIT_ATOL):
        raise AssertionError("xlstm chunkwise disagrees with the sequential "
                             f"recurrence: first block {first}, every block "
                             f"{state_err}, logits {logit_err}, finite "
                             f"{finite}")
    report["chunkwise"] = dict(logit_err=logit_err, first_rel_err=first,
                               state_rel_err=state_err,
                               chunkwise_seconds=tc, sequential_seconds=ts)

    # (c) the paged pool: a page a request, fewer pages than slots
    with torch.no_grad():
        out_c, report["paged"], eng = serve(
            "paged", lambda: ContinuousBatchingEngine(
                cfg, params, pool="paged", pages=XL_PAGES, **pool_kw), reqs)
        if eng.pool_kind != "paged" or sorted(
                k for k, g in eng.pool.items() if "bt" in g) != ["m", "s"]:
            raise AssertionError("xlstm's conv tails did not page")
        if report["paged"]["schedule"] != predicted:
            raise AssertionError(f"paged xlstm schedule "
                                 f"{report['paged']['schedule']} differs from "
                                 f"the CPU prediction {predicted}")
        if eng.pages_in_use:
            raise AssertionError(f"{eng.pages_in_use} pages left in use")
        del eng

    # (d) a nudged copy drafting, dense and paged
    draft = nudged_copy(params, XL_DRAFT_NOISE, seed=18)
    # the shortest prompts: every prefill runs twice here (target, draft)
    spec_reqs = sorted(reqs, key=lambda r: len(r.prompt))[:XL_SPEC_REQS]
    out_d = {}
    with torch.no_grad():
        for pool in ("dense", "paged"):
            label = f"{pool} speculative"
            out_d[label], report[label], eng = serve(
                label, lambda: ContinuousBatchingEngine(
                    cfg, params, capacity=XL_SPEC_CAP, max_len=XL_MAX_LEN,
                    k=XL_SPEC_K, pool=pool, prefill_bucket=XL_BUCKET,
                    pages=XL_SPEC_PAGES if pool == "paged" else None,
                    speculative=SpeculativeConfig(cfg, draft, d=XL_SPEC_D)),
                spec_reqs)
            acc = eng.acceptance_rate
            if not 0.0 < acc < 1.0 or eng.n_spec_fallbacks:
                raise AssertionError(f"xlstm {label}: acceptance {acc}, "
                                     f"{eng.n_spec_fallbacks} fallbacks")
            if pool == "paged" and eng.pages_in_use:
                raise AssertionError(f"{eng.pages_in_use} pages left in use")
            del eng
    del draft
    ties = _xlstm_check_tokens("xlstm", {"dense": out_a, "paged": out_c,
                                         **out_d}, reqs, seq, cfg, params,
                               dev)
    print(f"xlstm: tokens of the dense, paged and speculative runs equal "
          f"and equal to the sequential route's for {sorted(seq)} "
          f"({report['sequential_seconds']:.1f} s) but near ties {ties}",
          flush=True)
    report["near_ties"] = ties

    # (e) growth into an xlstm, then (f) training at full width
    cfg_s = get_config("xlstm-1.3b-smoke")
    report["grow"] = run_small_growth(
        kernel_rows, "xlstm", cfg_s,
        cfg_s.replace(name="xlstm-smoke-big", n_layers=8, d_model=128,
                      slstm_every=4), "launches_18e", XL_GROW_PRE,
        XL_GROW_OP, XL_GROW_SEQ, dev)
    report["train"] = run_xlstm_train(cfg, params, kern, dev)
    del params
    report["seconds"] = time.perf_counter() - t_phase
    print(f"xlstm phase: {report['seconds']:.1f} s ({smi})", flush=True)
    return report


def _count_sandwich_calls(fn):
    """Run ``fn()`` counting its calls of ``ops.tr_sandwich``."""
    from repro_torch.kernels import ops

    calls = [0]
    orig = ops.tr_sandwich

    def counted(*a):
        calls[0] += 1
        return orig(*a)
    ops.tr_sandwich = counted
    try:
        out = fn()
    finally:
        ops.tr_sandwich = orig
    return out, calls[0]


def run_small_growth(kernel_rows, label, cfg_s, cfg_t, row_key, n_pre, n_op,
                     seq, dev="cuda", batch=8, op_lr=2e-3, scratch_steps=0,
                     scratch_lr=3e-3):
    """Phases 18e, 19c, 20c and 22b: ``cfg_s`` pretrained ``n_pre`` steps
    at B ``batch`` x ``seq`` on the train launcher's batches (token
    chains; frames for hubert; no kernel launches), grown into ``cfg_t``
    by rank-1 Mango after ``n_op`` operator steps.  The sandwich must
    launch exactly as often as a CPU run of one growth counts its calls,
    times the growths (one an operator step, one more for
    ``grow_params``) at lr ``op_lr``; the grown params equal the plain
    version's route (the sandwich swapped for its plain version) within
    1e-5 of each leaf's largest entry; the held-out margin scratch - grown
    is printed, the scratch model trained ``scratch_steps`` AdamW steps at
    lr ``scratch_lr`` first.  The sandwich's launches go to
    ``kernel_rows["tr_sandwich"][row_key]``."""
    import numpy as np
    import torch

    from repro_torch.core import grow as growlib
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.train import data_for
    from repro_torch.models import get_family
    from repro_torch.optim import OptimizerConfig, make_optimizer
    from repro_torch.train.loss import loss_for
    from repro_torch.train.steps import make_eval_step, make_train_step
    from repro_torch.utils.pytree import tree_flatten_with_paths

    kern = ops.kernels()
    fam_s, fam_t = get_family(cfg_s), get_family(cfg_t)

    def on(b):
        return {k: torch.as_tensor(v, device=dev) for k, v in b.items()}

    # a CPU run of one growth counts the sandwich calls
    gop_cpu, op_cpu = growlib.build("mango", cfg_s, cfg_t, rank=1,
                                    device="cpu")
    small_cpu = fam_s.init(torch.Generator().manual_seed(0), cfg_s)
    with torch.no_grad():
        _, per_growth = _count_sandwich_calls(
            lambda: growlib.grow_params(gop_cpu, op_cpu, small_cpu))
    del gop_cpu, op_cpu, small_cpu

    _launch_counts(kern, zero=True)
    t0 = time.perf_counter()
    small = fam_s.init(torch.Generator(device=dev).manual_seed(0), cfg_s)
    opt = OptimizerConfig(lr=3e-3)
    init_fn, _ = make_optimizer(opt)
    state, step = init_fn(small), make_train_step(cfg_s, opt)
    data = data_for(cfg_s, batch, seq, seed=0)
    pre = []
    for i in range(n_pre):
        small, state, m = step(small, state, on(next(data)), i + 1)
        if i in (0, n_pre - 1):
            pre.append(float(m["loss"]))
    pre_s = time.perf_counter() - t0
    if _launch_counts(kern, zero=True) != {name: 0 for name in kern}:
        raise AssertionError(f"{label} pretraining launched a kernel")
    lf = loss_for(cfg_t)

    def op_loss(big, b):
        logits, aux = fam_t.forward(big, b, cfg_t)
        return lf(logits, aux, b, cfg_t)[0]

    t0 = time.perf_counter()
    gop, op = growlib.build("mango", cfg_s, cfg_t, rank=1, device=dev)
    op, op_losses = growlib.train_operator(
        gop, op, small, op_loss, data_for(cfg_t, batch, seq, seed=3),
        steps=n_op, lr=op_lr)
    with torch.no_grad():
        big = growlib.grow_params(gop, op, small)
    _sync()
    op_s = time.perf_counter() - t0
    launches = _launch_counts(kern, zero=True)
    want = {name: 0 for name in kern}
    if dev == "cuda":  # a wrapper counts its kernel's launches only
        want["tr_sandwich"] = per_growth * (n_op + 1)
    if launches != want:
        raise AssertionError(f"{label} growth ({n_op} operator steps, "
                             f"{per_growth} sandwiches a growth on the CPU) "
                             f"launched {launches}, expected {want}")
    # the plain version's route on the same operator
    orig = ops.tr_sandwich
    ops.tr_sandwich = ref.tr_sandwich_ref
    try:
        with torch.no_grad():
            plain = growlib.grow_params(gop, op, small)
    finally:
        ops.tr_sandwich = orig
    if _launch_counts(kern, zero=True) != {name: 0 for name in kern}:
        raise AssertionError("the plain route launched a kernel")
    pw = dict(tree_flatten_with_paths(plain))
    rel = max(float((t - pw[p]).abs().max() / pw[p].abs().max().clamp_min(
        1e-30)) for p, t in tree_flatten_with_paths(big))
    if not rel <= 1e-5:
        raise AssertionError(f"grown {label} params disagree with the plain "
                             f"route: {rel:.3g} of a leaf's largest entry")
    scratch = fam_t.init(torch.Generator(device=dev).manual_seed(99), cfg_t)
    if scratch_steps:
        opt = OptimizerConfig(lr=scratch_lr)
        init_fn, _ = make_optimizer(opt)
        state, step = init_fn(scratch), make_train_step(cfg_t, opt)
        data = data_for(cfg_t, batch, seq, seed=3)
        for i in range(scratch_steps):
            scratch, state, _ = step(scratch, state, on(next(data)), i + 1)
        del state
        if _launch_counts(kern, zero=True) != {name: 0 for name in kern}:
            raise AssertionError(f"{label} scratch training launched a "
                                 "kernel")
    ev = make_eval_step(cfg_t)
    held = on(next(data_for(cfg_t, batch, seq, seed=50)))
    l_grown = float(ev(big, held)["loss"])
    l_scratch = float(ev(scratch, held)["loss"])
    if not (np.isfinite(l_grown) and np.isfinite(l_scratch)):
        raise AssertionError(f"{label} growth gave a non-finite loss")
    kernel_rows["tr_sandwich"][row_key] = launches["tr_sandwich"]
    print(f"{cfg_s.name} pretrained {n_pre} steps ({pre[0]:.4f} -> "
          f"{pre[1]:.4f}, {pre_s:.1f} s, no kernel); Mango operator into "
          f"{cfg_t.n_layers} x {cfg_t.d_model} {n_op} steps "
          f"({op_losses[0]:.4f} -> {op_losses[-1]:.4f}, {op_s:.1f} s; "
          f"launches {launches}: {per_growth} sandwiches a growth as the "
          f"CPU counts, x {n_op + 1}); grown vs the plain route {rel:.3g} "
          f"of a "
          f"leaf's largest entry (limit 1e-5); held-out loss grown "
          f"{l_grown:.4f} vs scratch {l_scratch:.4f} after "
          f"{scratch_steps} steps (margin {l_scratch - l_grown:.4f})",
          flush=True)
    return dict(pretrain_losses=pre, pretrain_seconds=pre_s,
                operator_losses=op_losses, operator_seconds=op_s,
                sandwiches_per_growth=per_growth, launches=launches,
                plain_rel_err=rel, grown_loss=l_grown,
                scratch_loss=l_scratch, scratch_steps=scratch_steps,
                margin=l_scratch - l_grown)


def run_xlstm_train(cfg, params, kern, dev="cuda"):
    """Phase 18f: ``params`` (xlstm-1.3b, f32) trained XL_TRAIN_STEPS
    AdamW steps at B 1 x S XL_TRAIN_S, params and moments updated in place
    (no kernel launches): finite losses and params, ms/step against the
    f32 FLOP bound, peak memory."""
    import numpy as np
    import torch

    from repro_torch.data import lm_batch
    from repro_torch.optim import OptimizerConfig, make_optimizer
    from repro_torch.train.steps import make_train_step
    from repro_torch.utils.pytree import tree_param_count

    n_params = tree_param_count(params)
    batch = {"tokens": torch.from_numpy(lm_batch(
        cfg.vocab_size, 1, XL_TRAIN_S, seed=18)).to(dev)}
    opt = OptimizerConfig(lr=1e-4)
    init_fn, _ = make_optimizer(opt)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = init_fn(params)
    step = make_train_step(cfg, opt)
    _launch_counts(kern, zero=True)
    ms, metrics = [], []
    for i in range(XL_TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch, i + 1)
        m = {k: float(v) for k, v in m.items()}  # reads back: synchronises
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        metrics.append(m)
    peak = torch.cuda.max_memory_allocated()
    launches = _launch_counts(kern, zero=True)
    if launches != {name: 0 for name in kern}:
        raise AssertionError(f"xlstm training launched {launches}")
    if not all(np.isfinite(m["loss"]) for m in metrics) or not all(
            bool(torch.isfinite(t).all()) for t in _leaves(params)):
        raise AssertionError("xlstm training went non-finite")
    flops = 6 * n_params * XL_TRAIN_S
    b_ms, b_by = bound_ms(9 * 4 * n_params, flops, "float32")
    print(f"xlstm-1.3b training: B 1 x S {XL_TRAIN_S}, AdamW f32, "
          f"{n_params} params: ms/step {[round(x, 1) for x in ms]} against "
          f"the bound {b_ms:.1f} ms ({b_by}, {flops:.4g} FLOPs at 67 TFLOP/s"
          f" f32); peak memory {peak / 2**30:.2f} GiB; losses "
          f"{[round(m['loss'], 5) for m in metrics]}; no kernel launched",
          flush=True)
    del state
    return dict(ms_per_step=ms, bound_ms=b_ms, bound_by=b_by, flops=flops,
                peak_gib=peak / 2**30, metrics=metrics)


PHI_ARCH = "phi3.5-moe-42b"
PHI_LAYERS = 4  # of 32: phase 19 cuts depth, never width
PHI_N_PARAMS = {4: 5_463_904_256, 2: 2_863_288_320}  # eval_shape, by depth
PHI_SPREAD_TOKENS = 256  # phi_spread's prompt


def phi_model(layers=PHI_LAYERS, dev="cuda", **overrides):
    """phi3.5-moe-42b at full width (d_model 4,096, 32 heads over 8 KV
    heads of 128, 16 experts of 6,400 at top 2, vocab 32,064) cut to
    ``layers`` layers, in f32, weights from a torch.Generator seeded 0 on
    ``dev`` at the init's std (0.02): unlike qwen3-0.6b's (``qwen_model``)
    they need no scaling, as ``phi_spread`` shows (PERF.md section 4).
    ``overrides`` replace config fields (the capacity factor)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import build_params

    cfg = get_config(PHI_ARCH).replace(
        n_layers=layers, param_dtype="float32", compute_dtype="float32",
        **overrides)
    return cfg, build_params(cfg, seed=0, device=dev)


@contextlib.contextmanager
def router_gaps(log):
    """Inside the block every ``moe.router`` call also appends the (B, S)
    top-K boundary gap of its f32 scores (the K-th largest score minus
    the next) to ``log``: how near each token's expert choice is to a
    flip."""
    import torch

    from repro_torch.models import moe

    orig = moe.router

    def recorded(x, w_router, *, top_k=2, score="softmax"):
        logits = x.float() @ w_router.float()
        s = (torch.softmax(logits, -1) if score == "softmax"
             else torch.sigmoid(logits))
        top = s.topk(top_k + 1, dim=-1).values
        log.append(top[..., top_k - 1] - top[..., top_k])
        return orig(x, w_router, top_k=top_k, score=score)

    moe.router = recorded
    try:
        yield log
    finally:
        moe.router = orig


@contextlib.contextmanager
def counting_drops(cfg):
    """Count the routed expert choices and the dropped ones of every
    ``moe_mlp`` call of ``cfg`` inside the block: yields a dict whose
    ``"choices"`` and ``"dropped"`` are filled in when the block ends.
    Each ``moe.expert_positions`` call (which only ``moe_mlp`` makes on a
    model's routes) appends two device counts, its choices and those at a
    position past ``moe.group_capacity``; the block's end reads them with
    one host sync."""
    import torch

    from repro_torch.models import moe

    orig, log = moe.expert_positions, []
    counts = {"choices": 0, "dropped": 0}

    def counted(idx, n_experts):
        pos = orig(idx, n_experts)
        log.append((pos.numel(),
                    (pos >= moe.group_capacity(idx.shape[1], cfg)).sum()))
        return pos

    moe.expert_positions = counted
    try:
        yield counts
    finally:
        moe.expert_positions = orig
        if log:
            counts["choices"] = sum(n for n, _ in log)
            counts["dropped"] = int(torch.stack([d for _, d in log]).sum())


def phi_spread(cfg, params, dev="cuda", n=PHI_SPREAD_TOKENS):
    """Whether seeded weights make a usable model (phases 19 and 20): one
    full forward over a seeded prompt of ``n`` tokens.  Returns the median
    and least top-2 logit gap over its positions, the router's median and
    least top-K boundary gap over every MoE layer and position (None
    without one), and the distinct argmax tokens.  On the CPU at full
    width cut to 1 layer: ``python -c "import chip_smoke;
    chip_smoke.phi_spread_cpu()"`` (``ds_spread_cpu`` for deepseek)."""
    import numpy as np
    import torch

    from repro_torch.data import lm_batch
    from repro_torch.models import transformer

    x = torch.from_numpy(lm_batch(cfg.vocab_size, 1, n, seed=1900)).to(dev)
    log = []
    with router_gaps(log), torch.no_grad():
        logits, aux = transformer.forward(params, {"tokens": x}, cfg)
    top = logits[0].float().topk(2, dim=-1).values
    gaps = (top[:, 0] - top[:, 1]).cpu().numpy()
    rg = torch.cat([g.reshape(-1) for g in log]).cpu().numpy() if log \
        else None
    return dict(top2_gap_median=float(np.median(gaps)),
                top2_gap_min=float(gaps.min()),
                router_gap_median=None if rg is None else float(np.median(rg)),
                router_gap_min=None if rg is None else float(rg.min()),
                distinct_argmax=int(np.unique(
                    logits[0].argmax(-1).cpu().numpy()).size),
                logit_absmax=float(logits.abs().max()),
                moe_aux=float(aux["moe_aux"]), positions=n)


def phi_spread_cpu(layers=1):
    """``phi_spread`` on the CPU at full width cut to ``layers`` layers
    (1: ~6.3 GB of f32 weights)."""
    import torch

    torch.manual_seed(0)
    cfg, params = phi_model(layers, dev="cpu")
    out = phi_spread(cfg, params, dev="cpu")
    print(f"phi3.5-moe-42b at full width, {layers} layer(s), f32 on the "
          f"CPU, the init's std: {out}", flush=True)
    return out


PHI_CAPACITY, PHI_MAX_LEN, PHI_K, PHI_BUCKET, PHI_NEW = 8, 512, 8, 16, 64
PHI_PROMPTS = (64, 96, 448, 200, 333, 128, 400, 270)  # phase 19a
PHI_PAGES = 32  # phase 19a-b's arena: half the dense pool's 64 pages of 64
PHI_NO_DROP = 8.0  # capacity factor E / K: a group's capacity is its length
PHI_OWN = (64, 96, 300, 448)  # phase 19b: uids 0..3's prompts
PHI_SHARED = 256  # phase 19b: uids 4..7 open with the same 256 tokens (4
PHI_TAILS = (10, 25, 40, 55)  # pages of 64), then tails within a page
PHI_D, PHI_SPEC_K = 4, 2  # phase 19b's draft depth, blocks a dispatch
PHI_DRAFT_NOISE = 1e-3  # phase 19b's nudged draft: noise / leaf std
PHI_PLAIN_REQS = 2  # phase 19b holds its first 2 against the plain route
PHI_GROW_PRE, PHI_GROW_OP, PHI_GROW_SEQ = 20, 5, 32  # phase 19c
PHI_TRAIN_LAYERS, PHI_TRAIN_S, PHI_TRAIN_STEPS = 2, 256, 2  # phase 19d
# an expert choice whose top-K boundary gap in the router's f32 scores is
# below this may flip between two summation orders (phase 19's near ties)
ROUTER_NEAR_TIE = 1e-5
# the six attention kernels and the sandwich phase 19 runs
PHI_KERNELS = ("flash_attention", "slot_decode_attention",
               "paged_slot_decode_attention", "chunk_verify_attention",
               "paged_chunk_verify_attention", "decode_attention",
               "tr_sandwich")


def phi_requests(vocab, shared):
    """Phase 19's 8 requests, PHI_NEW new tokens each.  19a (``shared``
    False): prompts of PHI_PROMPTS tokens of their own; 19b: uids 0..3
    prompts of PHI_OWN tokens of their own, uids 4..7 the same PHI_SHARED
    tokens and then PHI_TAILS of their own.  Every sequence stays within
    one dispatch group (prompt + new <= 512)."""
    import numpy as np

    from repro_torch.data import lm_batch
    from repro_torch.serve import Request

    def own(uid, n):
        return lm_batch(vocab, 1, n, seed=1900 + uid)[0]

    if not shared:
        prompts = [own(uid, n) for uid, n in enumerate(PHI_PROMPTS)]
    else:
        head = lm_batch(vocab, 1, PHI_SHARED, seed=1950)[0]
        prompts = [own(uid, n) for uid, n in enumerate(PHI_OWN)] + [
            np.concatenate([head, own(10 + i, n)])
            for i, n in enumerate(PHI_TAILS)]
    return [Request(uid=uid, prompt=p, max_new_tokens=PHI_NEW)
            for uid, p in enumerate(prompts)]


@contextlib.contextmanager
def plain_attention():
    """Inside the block the transformer's dense-pool kernel entry points
    (flash prefill, slot decode) run their plain versions on any device:
    a route that launches no kernel of the port."""
    import torch

    from repro_torch.kernels import ops, ref

    saved = ops.flash_attention, ops.slot_decode_attention

    def slot(q, k, v, kv_len, *, done=None):
        del done  # the transformer folds done rows into kv_len
        return ref.slot_decode_attention_ref(
            q, k, v, torch.as_tensor(kv_len, dtype=torch.int32,
                                     device=q.device).expand(q.shape[0]))

    ops.flash_attention = ref.flash_attention_ref
    ops.slot_decode_attention = slot
    try:
        yield
    finally:
        ops.flash_attention, ops.slot_decode_attention = saved


def phi_plain_route(cfg, params, prompt, n):
    """Greedy tokens of the plain route (``plain_greedy``: a full forward a
    token, no kernel), each step's top-2 logit gap, and, for each step,
    the least router top-K boundary gap over every layer and every
    position up to the one that predicts it (one more full forward over
    the sequence, its routing recorded).  At a capacity factor of E / K a
    full forward drops nothing, so each position routes as it did when
    its token was new.  A model without MoE layers has no router: its
    router gaps are infinite."""
    import numpy as np
    import torch

    from repro_torch.models import transformer

    toks, gaps = plain_greedy(cfg, params, prompt, n)
    if not cfg.moe:
        return toks, gaps, np.full(n, np.inf)
    seq = torch.from_numpy(np.concatenate([prompt, toks[:-1]]).astype(
        np.int32)).to(next(_leaves(params)).device)[None]
    log = []
    with router_gaps(log), torch.no_grad():
        transformer.forward(params, {"tokens": seq}, cfg)
    per_pos = torch.stack([g[0] for g in log]).amin(0)
    upto = torch.cummin(per_pos, 0).values[len(prompt) - 1:]
    return toks, gaps, upto.cpu().numpy()


def phi_route_replay(cfg, params, prompt, n, forced=None):
    """One request through the dense pool's route at a capacity factor
    that drops, with plain attention (no kernel): its prompt zero-padded
    to its bucket and prefilled as one row (``prefill_last``; the row is
    one dispatch group, its pads included), then one ``decode_step_slots``
    a token (a group a token), fed its own greedy tokens or ``forced``
    ones.  Returns (tokens, each step's top-2 logit gap, the least router
    boundary gap up to each step (the prefill group's, then each decode
    token's), each step's top logit)."""
    import numpy as np
    import torch

    from repro_torch.models import transformer

    dev = next(_leaves(params)).device
    plen = len(prompt)
    toks = np.zeros((1, -(-plen // PHI_BUCKET) * PHI_BUCKET), np.int32)
    toks[0, :plen] = prompt
    cache = transformer.init_cache(cfg, 1, PHI_MAX_LEN, device=dev)
    log, out, gaps, rgaps, tops = [], [], [], [], []
    with plain_attention(), router_gaps(log), torch.no_grad():
        logits, cache = transformer.prefill_last(
            params, torch.from_numpy(toks).to(dev),
            torch.tensor([plen], dtype=torch.int32, device=dev), cfg, cache)
        least = float("inf")
        for i in range(n):
            least = min([least] + [float(g.min()) for g in log])
            log.clear()
            step = logits[0].float()
            top = step.topk(2).values
            tok = step.argmax().to(torch.int32)
            if forced is not None:
                tok = torch.tensor(int(forced[i]), dtype=torch.int32,
                                   device=dev)
            out.append(int(tok))
            gaps.append(float(top[0] - top[1]))
            rgaps.append(least)
            tops.append(float(top[0]))
            if i + 1 < n:
                logits, cache = transformer.decode_step_slots(
                    params, tok.view(1),
                    torch.tensor([plen + i], dtype=torch.int32, device=dev),
                    cache, cfg)
    return (np.asarray(out, np.int32), np.asarray(gaps), np.asarray(rgaps),
            np.asarray(tops))


def bf16_ulp(x):
    """The spacing of bfloat16 values (8 significant bits) at ``x``."""
    import numpy as np

    return 2.0 ** (np.floor(np.log2(np.abs(x))) - 7)


def phi_bf16_reference(cfg16, params16, prompt, tokens):
    """What bf16 runs that part are held to: the bf16 dense run's
    ``tokens`` replayed through the same route with plain attention.  A
    parting at step t is a bf16 near tie only where that replay shows, at
    or before t, a top-2 logit gap of at most two bf16 ulps of its top
    logit (the logits are bf16 values, so the gap is 0, 1 or 2 ulps: a
    change of summation order flips such a pair), or up to t a router
    boundary gap below ROUTER_NEAR_TIE.  Returns (tokens, each step's
    logit gap in ulps of its top logit, router gaps, ``check_phi_tokens``'
    limits: 2.5 ulps, between 2 and 3)."""
    _, gaps, rgaps, tops = phi_route_replay(cfg16, params16, prompt,
                                            len(tokens), tokens)
    return tokens, gaps / bf16_ulp(tops), rgaps, dict(tie=2.5)


def check_phi_tokens(what, uid, got, want, gaps, rgaps, tie=NEAR_TIE,
                     router_tie=ROUTER_NEAR_TIE):
    """``got`` must equal the reference route's ``want``, except from a
    step t where the reference shows, at or before t, a top-2 logit gap
    below ``tie``, or up to t a router top-K boundary gap below
    ``router_tie`` (``rgaps[t]``).  Returns the excused near tie (uid,
    step, least logit gap, router gap) or None."""
    import numpy as np

    diff = np.nonzero(np.asarray(got) != np.asarray(want))[0]
    if diff.size == 0:
        return None
    t = int(diff[0])
    lg, rg = float(np.min(gaps[:t + 1])), float(rgaps[t])
    if lg >= tie and rg >= router_tie:
        raise AssertionError(
            f"uid {uid}: {what} diverge at step {t}, where the reference's "
            f"least top-2 logit gap is {lg:.3g} (>= {tie:.3g}) and its "
            f"least router boundary gap {rg:.3g} (>= {router_tie:.3g})")
    print(f"near tie: uid {uid} {what} diverge at step {t} (top-2 logit gap "
          f"{lg:.3g} < {tie:.3g} or router boundary gap {rg:.3g} < "
          f"{router_tie:.3g})", flush=True)
    return (uid, t, lg, rg)


def predict_phi_schedule(cfg, reqs, **engine_kw):
    """The paged engine's schedule does not depend on the weights (no eos,
    fixed budgets): run it on the CPU with a phi of width 8 and one layer
    (the same vocabulary, experts and paging geometry) and count the
    prefix hits and misses, the admissions refused for want of pages, the
    prefill groups, the macro-steps, the hit tails' decode steps and the
    pages high-water."""
    import dataclasses

    import torch

    from repro_torch.launch.serve import build_params
    from repro_torch.serve import ContinuousBatchingEngine

    tiny = cfg.replace(n_layers=1, d_model=8, n_heads=2, n_kv_heads=1,
                       head_dim=8, d_ff=8, expert_d_ff=8,
                       mrope_sections=(2, 1, 1))
    eng = ContinuousBatchingEngine(tiny, build_params(tiny, seed=0,
                                                      device="cpu"),
                                   **engine_kw)
    waits = []
    alloc = eng._alloc_request

    def counted(req):
        info = alloc(req)
        waits.append(info is None)
        return info
    eng._alloc_request = counted
    with torch.no_grad():
        eng.run([dataclasses.replace(r) for r in reqs])
    return _phi_schedule(eng, sum(waits))


def _phi_schedule(eng, refused):
    return dict(hits=eng.n_prefix_hits, misses=eng.n_prefix_misses,
                refused=refused, n_prefills=eng.n_prefills,
                n_decode_dispatches=eng.n_decode_dispatches,
                tail_steps=eng.n_prefix_tail_steps,
                pages_highwater=eng.pages_highwater)


def _phi_launches(eng, L, kern):
    """The launches a phi engine run must make: per prefill group one
    flash a layer (two groups a speculative admission: target and draft);
    per decode step (and hit-tail step) one slot decode a layer on its
    pool; per speculative block d slot decodes and two chunk verifies (the
    target's verify, the draft's catch-up) a layer."""
    paged = eng.pool_kind == "paged"
    want = {name: 0 for name in kern}
    steps = eng.k * eng.n_decode_dispatches
    slot = ("paged_slot_decode_attention" if paged
            else "slot_decode_attention")
    if eng.speculative is not None:
        verify = ("paged_chunk_verify_attention" if paged
                  else "chunk_verify_attention")
        want.update({"flash_attention": 2 * L * spec_groups(eng),
                     slot: L * eng.speculative.d * steps,
                     verify: 2 * L * steps})
    else:
        want.update({"flash_attention": L * eng.n_prefills,
                     slot: L * (steps + eng.n_prefix_tail_steps)})
    return want


def moe_serve(name, label, make_engine, reqs, kern, want_launches, totals,
              smi, on_card):
    """Phases 19 and 20: serve ``reqs`` on a fresh ``make_engine()``
    (timed, drops counted), with exactly ``want_launches(eng)`` kernel
    launches (added to ``totals``), no speculative fallback and no page
    left in use.  Returns (outputs, record, engine): tok/s, the schedule,
    acceptance, dropped choices, pool bytes, peak memory above what was
    held before, host syncs a token, launches."""
    import torch

    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() if on_card else 0
    eng = make_engine()
    _launch_counts(kern, zero=True)
    with torch.no_grad(), counting_drops(eng.cfg) as drops:
        out, dt, tps, waits = timed_run(eng, reqs)
    launches = _launch_counts(kern, zero=True)
    want = want_launches(eng)
    if launches != want or eng.n_spec_fallbacks:
        raise AssertionError(f"{name} {label} launched {launches}, expected "
                             f"{want} ({eng.n_spec_fallbacks} fallbacks)")
    for k in totals:
        totals[k] += launches[k]
    if eng.pool_kind == "paged" and eng.pages_in_use:
        raise AssertionError(f"{name} {label}: {eng.pages_in_use} pages "
                             "left in use")
    peak = (torch.cuda.max_memory_allocated() - held) if on_card else 0
    n_tok = sum(len(v) for v in out.values())
    rec = dict(tok_per_s=tps, seconds=dt, tokens=n_tok,
               schedule=_phi_schedule(eng, waits),
               acceptance=eng.acceptance_rate,
               proposed=eng.n_spec_proposed,
               accepted=eng.n_spec_accepted,
               drops=drops, pages_budget=eng.pages_budget,
               pool_bytes=_pool_bytes(eng.pool)
               + (_pool_bytes(eng.pool_d) if eng.pool_d else 0),
               peak_above_held_gib=peak / 2**30,
               held_gib=held / 2**30,
               host_syncs_per_token=eng.n_host_syncs / n_tok,
               launches={n: v for n, v in launches.items() if v})
    print(f"{name} {label}: {n_tok} tokens in {dt:.3f} s: {tps:.1f} tok/s; "
          f"acceptance {eng.acceptance_rate:.4f} ({eng.n_spec_accepted}/"
          f"{eng.n_spec_proposed}); dropped {drops['dropped']} of "
          f"{drops['choices']} expert choices; schedule "
          f"{rec['schedule']}; pages budget {eng.pages_budget}; pools "
          f"{rec['pool_bytes'] / 2**30:.4f} GiB, peak "
          f"{peak / 2**30:.2f} GiB above the {held / 2**30:.2f} GiB "
          f"held; launches {rec['launches']} ({smi})", flush=True)
    return out, rec, eng


def moe_check_runs(label, runs, reqs, ref, n_new, vocab):
    """Every run's tokens well formed (``n_new`` ids below ``vocab``) and
    equal to ``runs["dense"]``; a disagreement is decided by ``ref(req)``
    (tokens, logit gaps, router gaps, and ``check_phi_tokens``' limits),
    which every run must then equal up to near ties.  Every request is
    decided before the disagreements that are no near tie are raised
    together.  Returns ({run: [near ties]}, the uids decided)."""
    ties = {w: [] for w in runs}
    decided, faults = [], []
    for r in reqs:
        got = {what: run[r.uid] for what, run in runs.items()}
        for what, toks in got.items():
            if toks.shape != (n_new,) or toks.min() < 0 or \
                    toks.max() >= vocab:
                raise AssertionError(f"uid {r.uid}: bad {label} {what} "
                                     "output")
        if all((t == got["dense"]).all() for t in got.values()):
            continue
        decided.append(r.uid)
        want, gaps, rgaps, limits = ref(r)
        for what, toks in got.items():
            try:
                tie = check_phi_tokens(f"{label} {what}", r.uid, toks, want,
                                       gaps, rgaps, **limits)
            except AssertionError as e:
                print(e, flush=True)
                faults.append(str(e))
                continue
            if tie is not None:
                ties[what].append(tie)
    if faults:
        raise AssertionError(f"{label}: {len(faults)} disagreements are no "
                             f"near tie: {faults}")
    return ties, decided


def run_phi(kernel_rows, smi, cfg=None, dev="cuda"):
    """Phase 19: phi3.5-moe-42b at full width cut to PHI_LAYERS layers, in
    f32 (``cfg`` and ``dev`` replace it for a rehearsal at a small size on
    the CPU).  (a) At the published capacity factor (1.25; choices drop)
    on PHI_PROMPTS: the dense pool and a PHI_PAGES-page pool, in f32 and
    in bf16 (weights cast from the f32 ones); paged == dense in each
    dtype (a disagreement is decided by the same route replayed with
    plain attention, near ties reported; in bf16 a logit gap of at most
    two bf16 ulps, ``phi_bf16_reference``).  (b) At capacity factor
    E / K (nothing can drop): the dense pool, the paged pool with 4
    requests sharing a 256-token prefix (its schedule as a CPU run
    predicts it), a copy nudged by PHI_DRAFT_NOISE of each leaf's std
    drafting (d 4, K 2) on both pools, and ``generate`` at B 1 for the first PHI_PLAIN_REQS
    requests: every run == the dense run, and the first PHI_PLAIN_REQS
    == the plain route, up to reported near ties (a top-2 logit gap below
    NEAR_TIE or a router boundary gap below ROUTER_NEAR_TIE).  Exact
    launches throughout, acceptance strictly inside (0, 1), 0 pages in
    use.  (c) phi3.5-moe-42b-smoke grown into a 4 x 128 MoE (exact
    sandwich launches, the expert slots included).  (d) phi3.5-moe-42b cut
    to PHI_TRAIN_LAYERS layers trained PHI_TRAIN_STEPS AdamW steps."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import generate
    from repro_torch.models import transformer
    from repro_torch.serve import ContinuousBatchingEngine, SpeculativeConfig
    from repro_torch.utils.pytree import tree_map, tree_param_count

    t_phase = time.perf_counter()
    full = cfg is None
    kern = ops.kernels()
    on_card = dev == "cuda"
    t0 = time.perf_counter()
    if full:
        cfg, params = phi_model(PHI_LAYERS, dev)
    else:
        from repro_torch.launch.serve import build_params
        params = build_params(cfg, seed=0, device=dev)
    _sync()
    init_s = time.perf_counter() - t0
    n_params = tree_param_count(params)
    if full and n_params != PHI_N_PARAMS[PHI_LAYERS]:
        raise AssertionError(f"phi3.5-moe-42b at {PHI_LAYERS} layers has "
                             f"{n_params} params, not "
                             f"{PHI_N_PARAMS[PHI_LAYERS]}")
    L = cfg.n_layers
    reqs_a = phi_requests(cfg.vocab_size, shared=False)
    reqs_b = phi_requests(cfg.vocab_size, shared=True)
    pool_kw = dict(capacity=PHI_CAPACITY, max_len=PHI_MAX_LEN, k=PHI_K,
                   prefill_bucket=PHI_BUCKET)
    cfg_nd = cfg.replace(capacity_factor=PHI_NO_DROP)
    t0 = time.perf_counter()
    predicted = predict_phi_schedule(cfg_nd, reqs_b, pool="paged",
                                     pages=PHI_PAGES, **pool_kw)
    predict_s = time.perf_counter() - t0
    spread = phi_spread(cfg, params, dev)
    print(f"phi3.5-moe-42b: {L} x {cfg.d_model}, {cfg.n_heads} heads over "
          f"{cfg.n_kv_heads} KV heads of {cfg.head_dim}, {cfg.n_experts} "
          f"experts of {cfg.expert_d_ff} at top {cfg.top_k}: {n_params} "
          f"params (f32, drawn in {init_s:.1f} s); spread {spread}; phase "
          f"19b's paged schedule as a CPU run predicts it ({predict_s:.1f} "
          f"s): {predicted} ({smi})", flush=True)
    if predicted["hits"] < 1:
        raise AssertionError(f"the schedule predicts no prefix hit: "
                             f"{predicted}")
    report = dict(n_params=n_params, init_seconds=init_s, spread=spread,
                  predicted=predicted, nvidia_smi=smi)
    p19 = {name: 0 for name in PHI_KERNELS}

    def want_launches(eng):
        return (_phi_launches(eng, eng.cfg.n_layers, kern) if on_card
                else {name: 0 for name in kern})

    def serve(label, make_engine, reqs):
        return moe_serve("phi", label, make_engine, reqs, kern,
                         want_launches, p19, smi, on_card)

    def check_runs(label, runs, reqs, ref):
        return moe_check_runs(f"phi {label}", runs, reqs, ref, PHI_NEW,
                              cfg.vocab_size)

    # (a) the published capacity factor: choices drop
    runs_a = {}
    for dname in ("float32", "bfloat16"):
        dt_ = getattr(torch, dname)
        c = cfg if dname == "float32" else cfg.replace(
            param_dtype=dname, compute_dtype=dname)
        p = params if dname == "float32" else tree_map(
            lambda t: t.to(dt_), params)
        outs = {}
        for pool in ("dense", "paged"):
            label = f"{dname} {pool}"
            outs[pool], report[f"a {label}"], eng = serve(
                label, lambda: ContinuousBatchingEngine(
                    c, p, pool=pool,
                    pages=PHI_PAGES if pool == "paged" else None, **pool_kw),
                reqs_a)
            if on_card and label == "float32 dense":
                # where a decode step's time goes: 8 live rows at 300
                pos = torch.full((PHI_CAPACITY,), 300, dtype=torch.int32,
                                 device=dev)
                with torch.no_grad():
                    _, report["decode_profile"] = profile_step(
                        "phi3.5-moe-42b slot decode step (B 8, f32)",
                        lambda: transformer.decode_step_slots(
                            params, pos, pos, eng.pool, cfg))
            del eng
            if report[f"a {label}"]["drops"]["dropped"] < 1:
                raise AssertionError(f"phi {label}: no expert choice "
                                     "dropped at the published capacity "
                                     "factor")
        if dname == "float32":
            def ref(r):
                return phi_route_replay(c, p, r.prompt,
                                        PHI_NEW)[:3] + ({},)
        else:
            def ref(r):
                return phi_bf16_reference(c, p, r.prompt,
                                          outs["dense"][r.uid])
        ties, replayed = check_runs(f"{dname} cf {cfg.capacity_factor}",
                                    outs, reqs_a, ref)
        report[f"a {dname} near ties"] = ties
        print(f"phi {dname} at capacity factor {cfg.capacity_factor}: paged "
              f"== dense for {len(reqs_a)}/{len(reqs_a)} requests but near "
              f"ties {ties} (replayed {replayed})", flush=True)
        runs_a[dname] = outs
        del p
    del runs_a

    # (b) capacity factor E / K: nothing can drop
    runs_b = {}
    for label, make in (
            ("dense", lambda: ContinuousBatchingEngine(cfg_nd, params,
                                                       **pool_kw)),
            ("paged", lambda: ContinuousBatchingEngine(
                cfg_nd, params, pool="paged", pages=PHI_PAGES, **pool_kw))):
        runs_b[label], report[f"b {label}"], eng = serve(
            f"cf {PHI_NO_DROP:g} {label}", make, reqs_b)
        del eng
    if report["b paged"]["schedule"] != predicted:
        raise AssertionError(f"phi paged schedule "
                             f"{report['b paged']['schedule']} differs from "
                             f"the CPU prediction {predicted}")
    draft = nudged_copy(params, PHI_DRAFT_NOISE, seed=19)
    for pool in ("dense", "paged"):
        label = f"{pool} speculative"
        runs_b[label], report[f"b {label}"], eng = serve(
            f"cf {PHI_NO_DROP:g} {label}", lambda: ContinuousBatchingEngine(
                cfg_nd, params, capacity=PHI_CAPACITY, max_len=PHI_MAX_LEN,
                k=PHI_SPEC_K, prefill_bucket=PHI_BUCKET, pool=pool,
                speculative=SpeculativeConfig(cfg_nd, draft, d=PHI_D)),
            reqs_b)
        del eng
        acc = report[f"b {label}"]["acceptance"]
        if not 0.0 < acc < 1.0:
            raise AssertionError(f"phi {label}: acceptance {acc} not inside "
                                 "(0, 1)")
    del draft
    for label, rec in report.items():
        if label.startswith("b ") and rec["drops"]["dropped"]:
            raise AssertionError(f"phi {label} dropped {rec['drops']} at "
                                 f"capacity factor {PHI_NO_DROP}")
    # generate at B 1 (flash prefill, decode_attention) on the first 2
    gen = {}
    gc.collect()
    for r in reqs_b[:PHI_PLAIN_REQS]:
        _launch_counts(kern, zero=True)
        with torch.no_grad():
            gen[r.uid] = generate(cfg_nd, params, torch.from_numpy(
                r.prompt)[None].to(dev), max_new_tokens=PHI_NEW,
                max_len=PHI_MAX_LEN)[0].cpu().numpy()
        got = _launch_counts(kern, zero=True)
        want = {name: 0 for name in kern}
        if on_card:
            want.update(flash_attention=L, decode_attention=L * (PHI_NEW - 1))
        if got != want:
            raise AssertionError(f"uid {r.uid}: generate launched {got}, "
                                 f"expected {want}")
        for name in p19:
            p19[name] += got[name]
    # the plain route alone decides (no kernel of the port)
    t0 = time.perf_counter()
    plain = {r.uid: phi_plain_route(cfg_nd, params, r.prompt, PHI_NEW)
             for r in reqs_b[:PHI_PLAIN_REQS]}
    plain_s = time.perf_counter() - t0
    if _launch_counts(kern) != {name: 0 for name in kern}:
        raise AssertionError("the plain route launched a kernel")
    ties_b, _ = check_runs(
        f"cf {PHI_NO_DROP:g}", runs_b, reqs_b,
        lambda r: (plain.get(r.uid) or phi_plain_route(
            cfg_nd, params, r.prompt, PHI_NEW)) + ({},))
    ties_b["dense vs plain"], ties_b["generate vs plain"] = [], []
    for r in reqs_b[:PHI_PLAIN_REQS]:
        for what, toks in (("dense", runs_b["dense"][r.uid]),
                           ("generate", gen[r.uid])):
            tie = check_phi_tokens(f"phi {what} and the plain route", r.uid,
                                   toks, *plain[r.uid])
            if tie is not None:
                ties_b[f"{what} vs plain"].append(tie)
    report["b near ties"] = ties_b
    report["plain_route_seconds"] = plain_s
    print(f"phi at capacity factor {PHI_NO_DROP:g}: the {len(runs_b)} engine "
          f"runs equal for {len(reqs_b)}/{len(reqs_b)} requests, the dense "
          f"run and generate (B 1) == the plain route ({plain_s:.1f} s) for "
          f"uids {sorted(plain)}, but near ties {ties_b}; plain route's "
          f"least router boundary gap "
          f"{ {u: float(v[2].min()) for u, v in plain.items()} }", flush=True)
    del runs_b, plain, gen

    # (c) growth into a wider MoE, then (d) training at full width
    cfg_s = get_config("phi3.5-moe-42b-smoke")
    report["grow"] = run_small_growth(
        kernel_rows, "phi", cfg_s,
        cfg_s.replace(name="phi-smoke-big", n_layers=4, d_model=128,
                      n_heads=8, n_kv_heads=2, d_ff=256, expert_d_ff=256),
        "launches_p19", PHI_GROW_PRE, PHI_GROW_OP, PHI_GROW_SEQ, dev)
    p19["tr_sandwich"] += kernel_rows["tr_sandwich"]["launches_p19"]
    del params
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    report["train"] = run_phi_train(
        cfg.replace(n_layers=PHI_TRAIN_LAYERS), kern, dev, full)
    for name, n in p19.items():
        kernel_rows[name]["launches_p19"] = n
    report["launches_p19"] = p19
    report["seconds"] = time.perf_counter() - t_phase
    print(f"phi phase: {report['seconds']:.1f} s; launches {p19} ({smi})",
          flush=True)
    return report


def phi_train_flops(cfg, S):
    """Operations of one training step (forward and backward, 3x the
    forward's products) of a phi at B 1 x S: the q/k/v/o, router and head
    products, the attention scores and values, and the experts' three
    products over every capacity slot (E x C rows a layer, the capacity
    layout's real work, C = max(int(S * K / E * cf), 1))."""
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    E, F = cfg.n_experts, cfg.expert_d_ff
    C = max(int(S * cfg.top_k / E * cfg.capacity_factor), 1)
    dense = D * (2 * H * hd + 2 * KV * hd) + D * E
    per_layer = 2 * S * dense + 4 * S * S * H * hd + 2 * E * C * 3 * D * F
    return 3 * (cfg.n_layers * per_layer + 2 * S * D * cfg.vocab_size)


def run_phi_train(cfg, kern, dev="cuda", full=True):
    """Phase 19d: ``cfg`` (phi3.5-moe-42b cut to PHI_TRAIN_LAYERS layers,
    f32, weights drawn afresh) trained PHI_TRAIN_STEPS AdamW steps at B 1
    x S PHI_TRAIN_S at the published capacity factor, params and moments
    updated in place (no kernel launches): loss and moe_aux, ms/step
    against the f32 bound (``phi_train_flops``; bytes: AdamW's nine f32
    accesses a param), peak memory."""
    import numpy as np
    import torch

    from repro_torch.data import lm_batch
    from repro_torch.launch.serve import build_params
    from repro_torch.optim import OptimizerConfig, make_optimizer
    from repro_torch.train.steps import make_train_step
    from repro_torch.utils.pytree import tree_param_count

    on_card = dev == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    params = build_params(cfg, seed=0, device=dev)
    n_params = tree_param_count(params)
    if full and n_params != PHI_N_PARAMS[PHI_TRAIN_LAYERS]:
        raise AssertionError(f"phi at {PHI_TRAIN_LAYERS} layers has "
                             f"{n_params} params")
    batch = {"tokens": torch.from_numpy(lm_batch(
        cfg.vocab_size, 1, PHI_TRAIN_S, seed=19)).to(dev)}
    opt = OptimizerConfig(lr=1e-4)
    init_fn, _ = make_optimizer(opt)
    state = init_fn(params)
    step = make_train_step(cfg, opt)
    _launch_counts(kern, zero=True)
    ms, metrics = [], []
    for i in range(PHI_TRAIN_STEPS):
        _sync()
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch, i + 1)
        m = {k: float(v) for k, v in m.items()}  # reads back: synchronises
        _sync()
        ms.append((time.perf_counter() - t0) * 1e3)
        metrics.append(m)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    launches = _launch_counts(kern, zero=True)
    if launches != {name: 0 for name in kern}:
        raise AssertionError(f"phi training launched {launches}")
    if not all(np.isfinite(m["loss"]) and m["moe_aux"] > 0
               for m in metrics) or not all(
            bool(torch.isfinite(t).all()) for t in _leaves(params)):
        raise AssertionError(f"phi training went wrong: {metrics}")
    flops = phi_train_flops(cfg, PHI_TRAIN_S)
    b_ms, b_by = bound_ms(9 * 4 * n_params, flops, "float32")
    print(f"phi3.5-moe-42b training ({cfg.n_layers} layers): B 1 x S "
          f"{PHI_TRAIN_S}, capacity factor {cfg.capacity_factor}, AdamW f32, "
          f"{n_params} params: ms/step {[round(x, 1) for x in ms]} against "
          f"the bound {b_ms:.1f} ms ({b_by}; {flops:.4g} FLOPs at 67 TFLOP/s "
          f"f32, {9 * 4 * n_params / 1e9:.1f} GB at 3.35 TB/s); peak memory "
          f"{peak / 2**30:.2f} GiB; loss "
          f"{[round(m['loss'], 5) for m in metrics]}, moe_aux (weighted) "
          f"{[round(m['moe_aux'], 6) for m in metrics]}; no kernel launched",
          flush=True)
    del state, params
    return dict(ms_per_step=ms, bound_ms=b_ms, bound_by=b_by, flops=flops,
                n_params=n_params, peak_gib=peak / 2**30, metrics=metrics)


DS_ARCH = "deepseek-v3-671b"
DS_LAYERS = 2  # of 61, one dense and one MoE (moe_layer_start 1, the
# smoke's split): phase 20 cuts depth, never width
DS_N_PARAMS = {2: 14_630_392_832, 1: 3_123_106_816}  # eval_shape, by depth
# phase 20a: the published capacity factor (1.25) in phase 19a's geometry,
# which ``phi_route_replay`` replays for the bf16 rule
DS_CAPACITY, DS_MAX_LEN, DS_K, DS_BUCKET = (PHI_CAPACITY, PHI_MAX_LEN, PHI_K,
                                            PHI_BUCKET)
DS_NEW = 32
DS_PROMPTS = (64, 96, 448, 200, 333, 128, 400, 270)
DS_PAGES = 32  # half the dense pool's 64 pages of 64
# phase 20b: capacity factor E / K = 32, where nothing drops; the capacity
# layout then holds 256 x sg slots a group of sg tokens, so short prompts
# and few rows (a prefill holds at most 256 x 96 slots a row)
DS_NO_DROP = 32.0
DS_B_CAPACITY, DS_B_MAX_LEN, DS_B_NEW = 4, 128, 24  # page 8 at max_len 128
# uids 1..3 open on uid 0's first 32 tokens (4 pages of 8) with tails
# inside their fifth page: a hit needs every full page before a prompt's
# last token resident
DS_B_PROMPTS = (96, 40, 40, 40)
DS_SHARED = 32
DS_B_PAGES = 24  # 3/8 of the dense pool's 64 pages of 8: uids 2 and 3
# wait for pages, then hit the registered opening
DS_D, DS_SPEC_K = 4, 2  # phase 20b's draft depth, blocks a dispatch
DS_PLAIN_REQS = 2  # phase 20b holds its first 2 against the plain route
DS_GROW_PRE, DS_GROW_OP, DS_GROW_SEQ = 20, 5, 32  # phase 20c
DS_TRAIN_S, DS_TRAIN_STEPS = 256, 2  # phase 20d, at 1 dense layer + MTP


def ds_model(layers=DS_LAYERS, dev="cuda", **overrides):
    """deepseek-v3-671b at full width (d_model 7,168, 128 heads, MLA with
    q_lora_rank 1,536 and kv_lora_rank 512, 256 experts of 2,048 at top 8
    with sigmoid scoring and one shared expert, a dense d_ff of 18,432,
    vocab 129,280, the MTP head) cut to ``layers`` layers, the first
    dense (``moe_layer_start`` 1), in f32, weights from a torch.Generator
    seeded 0 on ``dev`` at the init's std (0.02).  ``overrides`` replace
    config fields (the capacity factor)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import build_params

    cfg = get_config(DS_ARCH).replace(
        n_layers=layers, moe_layer_start=1, param_dtype="float32",
        compute_dtype="float32", **overrides)
    return cfg, build_params(cfg, seed=0, device=dev)


def ds_spread_cpu(layers=1):
    """``phi_spread`` of deepseek-v3-671b on the CPU at full width cut to
    ``layers`` layers (1: the dense layer and the MTP head, ~12.5 GB of
    f32 weights)."""
    import torch

    torch.manual_seed(0)
    cfg, params = ds_model(layers, dev="cpu")
    out = phi_spread(cfg, params, dev="cpu")
    print(f"deepseek-v3-671b at full width, {layers} layer(s), f32 on the "
          f"CPU, the init's std: {out}", flush=True)
    return out


def ds_requests(vocab, shared):
    """Phase 20's requests.  20a (``shared`` False): 8 prompts of
    DS_PROMPTS tokens, DS_NEW new each.  20b: 4 prompts of DS_B_PROMPTS
    tokens, DS_B_NEW new each, uids 1..3 opening on uid 0's first
    DS_SHARED tokens."""
    import numpy as np

    from repro_torch.data import lm_batch
    from repro_torch.serve import Request

    def own(uid, n):
        return lm_batch(vocab, 1, n, seed=2000 + uid)[0]

    if not shared:
        return [Request(uid=uid, prompt=own(uid, n), max_new_tokens=DS_NEW)
                for uid, n in enumerate(DS_PROMPTS)]
    first = own(0, DS_B_PROMPTS[0])
    prompts = [first] + [np.concatenate([first[:DS_SHARED],
                                         own(uid, n - DS_SHARED)])
                         for uid, n in enumerate(DS_B_PROMPTS) if uid]
    return [Request(uid=uid, prompt=p, max_new_tokens=DS_B_NEW)
            for uid, p in enumerate(prompts)]


def ds_draft(cfg, params):
    """Phase 20b's draft: the target without its MoE layer -- the config
    cut to its dense layer, no MTP head -- over the target's own embed,
    dense block, final norm and head tensors (no copy)."""
    cfg_d = cfg.replace(n_layers=1, moe_layer_start=1, mtp=False)
    return cfg_d, {k: params[k] for k in ("embed", "dense_blocks",
                                          "final_norm", "head")}


def _cast_in_place(tree, dtype):
    """Every floating leaf of ``tree`` cast to ``dtype`` one leaf at a
    time, each old leaf freed before the next is cast (two full copies of
    a 58.5 GB model do not fit the card)."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _cast_in_place(v, dtype)
        elif v.is_floating_point():
            tree[k] = None
            tree[k] = v.to(dtype)
            del v
    return tree


def run_ds(kernel_rows, smi, cfg=None, dev="cuda"):
    """Phase 20: deepseek-v3-671b at full width cut to DS_LAYERS layers
    (one dense, one MoE; 14,630,392,832 params), f32 (``cfg`` and ``dev``
    replace it for a rehearsal at a small size on the CPU).  MLA runs no
    kernel of the port: every attention kernel must launch 0 times in
    20a-b.  (a) The published capacity factor (1.25; prefills drop
    choices) on DS_PROMPTS: the dense pool and a DS_PAGES-page pool, in
    f32 (paged == dense exactly: the same plain code over the same
    latents) and, after (b), in bf16 (weights cast leaf by leaf; a parting
    excused only by phase 19's bf16 rule).  (b) Capacity factor E / K (32,
    nothing drops) on 4 requests sharing a 32-token opening: the dense
    pool, the paged pool (its schedule as a CPU run predicts it),
    speculation at d 4, K 2 with the target's dense layer drafting on both
    pools (acceptance strictly inside (0, 1)), ``generate`` at B 1 and the
    plain route on the first DS_PLAIN_REQS: every run == the dense run up
    to reported near ties.  (c) deepseek-v3-671b-smoke grown into 4 x 128
    by rank-1 Mango (exact sandwich launches).  (d) deepseek-v3-671b cut
    to its dense layer and the MTP head trained DS_TRAIN_STEPS AdamW steps
    at B 1 x S DS_TRAIN_S."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import build_params, generate
    from repro_torch.models import transformer
    from repro_torch.serve import ContinuousBatchingEngine, SpeculativeConfig
    from repro_torch.utils.pytree import tree_param_count

    t_phase = time.perf_counter()
    full = cfg is None
    kern = ops.kernels()
    on_card = dev == "cuda"
    zeros = {name: 0 for name in kern}
    t0 = time.perf_counter()
    if full:
        cfg, params = ds_model(DS_LAYERS, dev)
    else:
        params = build_params(cfg, seed=0, device=dev)
    _sync()
    init_s = time.perf_counter() - t0
    n_params = tree_param_count(params)
    if full and n_params != DS_N_PARAMS[DS_LAYERS]:
        raise AssertionError(f"deepseek-v3-671b at {DS_LAYERS} layers has "
                             f"{n_params} params, not "
                             f"{DS_N_PARAMS[DS_LAYERS]}")
    reqs_a = ds_requests(cfg.vocab_size, shared=False)
    reqs_b = ds_requests(cfg.vocab_size, shared=True)
    kw_a = dict(capacity=DS_CAPACITY, max_len=DS_MAX_LEN, k=DS_K,
                prefill_bucket=DS_BUCKET)
    kw_b = dict(capacity=DS_B_CAPACITY, max_len=DS_B_MAX_LEN, k=DS_K,
                prefill_bucket=DS_BUCKET)
    cfg_nd = cfg.replace(capacity_factor=DS_NO_DROP)
    t0 = time.perf_counter()
    predicted = predict_phi_schedule(cfg_nd, reqs_b, pool="paged",
                                     pages=DS_B_PAGES, **kw_b)
    predict_s = time.perf_counter() - t0
    spread = phi_spread(cfg, params, dev)
    # a latent token a layer against the K/V MLA would expand to
    latent_b = (cfg.kv_lora_rank + cfg.qk_rope_dim) * 4
    expanded_b = cfg.n_heads * (cfg.qk_nope_dim + cfg.qk_rope_dim
                                + cfg.v_head_dim) * 4
    print(f"deepseek-v3-671b: {cfg.n_layers} x {cfg.d_model} (dense "
          f"layers {cfg.n_dense_layers}), {cfg.n_heads} heads, MLA "
          f"q_lora {cfg.q_lora_rank} kv_lora {cfg.kv_lora_rank} nope "
          f"{cfg.qk_nope_dim} rope {cfg.qk_rope_dim} v {cfg.v_head_dim}, "
          f"{cfg.n_experts} experts of {cfg.expert_d_ff} at top "
          f"{cfg.top_k} ({cfg.router_score}, {cfg.n_shared_experts} "
          f"shared), MTP head: {n_params} params (f32, drawn in "
          f"{init_s:.1f} s); spread {spread}; a latent token a layer "
          f"{latent_b} B against {expanded_b} B expanded "
          f"({expanded_b / latent_b:.1f}x); phase 20b's paged schedule as "
          f"a CPU run predicts it ({predict_s:.1f} s): {predicted} ({smi})",
          flush=True)
    if predicted["hits"] < 1:
        raise AssertionError(f"the schedule predicts no prefix hit: "
                             f"{predicted}")
    report = dict(n_params=n_params, init_seconds=init_s, spread=spread,
                  predicted=predicted, nvidia_smi=smi,
                  latent_bytes_per_token_layer=latent_b,
                  expanded_bytes_per_token_layer=expanded_b)
    p20 = {"tr_sandwich": 0}

    def serve(label, make_engine, reqs):
        out, rec, eng = moe_serve("deepseek", label, make_engine, reqs,
                                  kern, lambda _: zeros, p20, smi, on_card)
        # bytes a cached token takes a layer: the latent leaves' widths
        grp = next(iter(eng.pool.values()))
        rec["pool_bytes_per_token_layer"] = sum(
            t.shape[-1] * t.element_size() for k, t in grp.items()
            if k != "bt")
        if eng.cache_layout != "full-mla" or set(grp) - {"ckv", "kr", "bt"}:
            raise AssertionError(f"deepseek {label}: layout "
                                 f"{eng.cache_layout}, pool leaves "
                                 f"{sorted(grp)}")
        return out, rec, eng

    def check_runs(label, runs, reqs, ref, n_new):
        return moe_check_runs(f"deepseek {label}", runs, reqs, ref, n_new,
                              cfg.vocab_size)

    def pools(c, p, label, reqs, kw, pages):
        outs = {}
        for pool in ("dense", "paged"):
            outs[pool], report[f"{label} {pool}"], eng = serve(
                f"{label} {pool}", lambda: ContinuousBatchingEngine(
                    c, p, pool=pool, pages=pages if pool == "paged"
                    else None, **kw), reqs)
            if on_card and label == "a float32" and pool == "dense":
                # where a decode step's time goes: 8 live rows at 300
                pos = torch.full((DS_CAPACITY,), 300, dtype=torch.int32,
                                 device=dev)
                with torch.no_grad():
                    _, report["decode_profile"] = profile_step(
                        "deepseek-v3-671b slot decode step (B 8, f32)",
                        lambda: transformer.decode_step_slots(
                            p, pos, pos, eng.pool, c))
            del eng
        return outs

    # (a) the published capacity factor, f32: choices drop; the two pools
    # run the same plain code over the same latents, so exactly equal
    outs = pools(cfg, params, "a float32", reqs_a, kw_a, DS_PAGES)
    for pool in ("dense", "paged"):
        if report[f"a float32 {pool}"]["drops"]["dropped"] < 1:
            raise AssertionError(f"deepseek f32 {pool}: no expert choice "
                                 "dropped at the published capacity factor")
    def no_parting(r):
        raise AssertionError(f"deepseek uid {r.uid}: f32 paged != dense")

    check_runs("a float32", outs, reqs_a, no_parting, DS_NEW)
    print(f"deepseek f32 at capacity factor {cfg.capacity_factor}: paged "
          f"== dense for {len(reqs_a)}/{len(reqs_a)} requests", flush=True)
    del outs

    # (b) capacity factor E / K: nothing can drop
    runs_b = {}
    for pool in ("dense", "paged"):
        runs_b[pool], report[f"b {pool}"], eng = serve(
            f"cf {DS_NO_DROP:g} {pool}", lambda: ContinuousBatchingEngine(
                cfg_nd, params, pool=pool,
                pages=DS_B_PAGES if pool == "paged" else None, **kw_b),
            reqs_b)
        del eng
    if report["b paged"]["schedule"] != predicted:
        raise AssertionError(f"deepseek paged schedule "
                             f"{report['b paged']['schedule']} differs from "
                             f"the CPU prediction {predicted}")
    cfg_d, params_d = ds_draft(cfg_nd, params)
    for pool in ("dense", "paged"):
        label = f"{pool} speculative"
        runs_b[label], report[f"b {label}"], eng = serve(
            f"cf {DS_NO_DROP:g} {label}", lambda: ContinuousBatchingEngine(
                cfg_nd, params, capacity=DS_B_CAPACITY, max_len=DS_B_MAX_LEN,
                k=DS_SPEC_K, prefill_bucket=DS_BUCKET, pool=pool,
                speculative=SpeculativeConfig(cfg_d, params_d, d=DS_D)),
            reqs_b)
        del eng
        acc = report[f"b {label}"]["acceptance"]
        if not 0.0 < acc < 1.0:
            raise AssertionError(f"deepseek {label}: acceptance {acc} not "
                                 "inside (0, 1)")
    del params_d
    for label, rec in report.items():
        if label.startswith("b ") and rec["drops"]["dropped"]:
            raise AssertionError(f"deepseek {label} dropped {rec['drops']} "
                                 f"at capacity factor {DS_NO_DROP:g}")
    # generate at B 1 (MLA: the expanded prefill, absorbed decode steps;
    # no kernel) on the first DS_PLAIN_REQS
    gen = {}
    for r in reqs_b[:DS_PLAIN_REQS]:
        _launch_counts(kern, zero=True)
        with torch.no_grad():
            gen[r.uid] = generate(cfg_nd, params, torch.from_numpy(
                r.prompt)[None].to(dev), max_new_tokens=DS_B_NEW,
                max_len=DS_B_MAX_LEN)[0].cpu().numpy()
        if _launch_counts(kern, zero=True) != zeros:
            raise AssertionError(f"uid {r.uid}: deepseek generate launched "
                                 "a kernel")
    t0 = time.perf_counter()
    plain = {r.uid: phi_plain_route(cfg_nd, params, r.prompt, DS_B_NEW)
             for r in reqs_b[:DS_PLAIN_REQS]}
    plain_s = time.perf_counter() - t0
    if _launch_counts(kern) != zeros:
        raise AssertionError("the plain route launched a kernel")
    ties_b, _ = check_runs(
        f"cf {DS_NO_DROP:g}", runs_b, reqs_b,
        lambda r: (plain.get(r.uid) or phi_plain_route(
            cfg_nd, params, r.prompt, DS_B_NEW)) + ({},), DS_B_NEW)
    ties_b["dense vs plain"], ties_b["generate vs plain"] = [], []
    for r in reqs_b[:DS_PLAIN_REQS]:
        for what, toks in (("dense", runs_b["dense"][r.uid]),
                           ("generate", gen[r.uid])):
            tie = check_phi_tokens(f"deepseek {what} and the plain route",
                                   r.uid, toks, *plain[r.uid])
            if tie is not None:
                ties_b[f"{what} vs plain"].append(tie)
    report["b near ties"] = ties_b
    report["plain_route_seconds"] = plain_s
    print(f"deepseek at capacity factor {DS_NO_DROP:g}: the {len(runs_b)} "
          f"engine runs equal for {len(reqs_b)}/{len(reqs_b)} requests, the "
          f"dense run and generate (B 1) == the plain route ({plain_s:.1f} "
          f"s) for uids {sorted(plain)}, but near ties {ties_b}; plain "
          f"route's least router boundary gap "
          f"{ {u: float(v[2].min()) for u, v in plain.items()} }", flush=True)
    del runs_b, plain, gen

    # (a) in the published bf16: the f32 weights cast leaf by leaf
    cfg16 = cfg.replace(param_dtype="bfloat16", compute_dtype="bfloat16")
    params = _cast_in_place(params, torch.bfloat16)
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    outs = pools(cfg16, params, "a bfloat16", reqs_a, kw_a, DS_PAGES)
    ties_a, replayed = check_runs(
        "a bfloat16", outs, reqs_a,
        lambda r: phi_bf16_reference(cfg16, params, r.prompt,
                                     outs["dense"][r.uid]), DS_NEW)
    report["a bfloat16 near ties"] = ties_a
    print(f"deepseek bf16 at capacity factor {cfg.capacity_factor}: paged "
          f"== dense for {len(reqs_a)}/{len(reqs_a)} requests but near ties "
          f"{ties_a} (replayed {replayed})", flush=True)
    del outs, params
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # (c) growth into a wider deepseek, then (d) training at full width
    cfg_s = get_config("deepseek-v3-671b-smoke")
    report["grow"] = run_small_growth(
        kernel_rows, "deepseek", cfg_s,
        cfg_s.replace(name="ds-smoke-big", n_layers=4, d_model=128,
                      n_heads=8, n_kv_heads=8, d_ff=256),
        "launches_p20", DS_GROW_PRE, DS_GROW_OP, DS_GROW_SEQ, dev)
    p20["tr_sandwich"] += kernel_rows["tr_sandwich"]["launches_p20"]
    report["train"] = run_ds_train(
        None if full else cfg.replace(n_layers=1), kern, dev)
    report["launches_p20"] = p20
    report["seconds"] = time.perf_counter() - t_phase
    print(f"deepseek phase: {report['seconds']:.1f} s; launches {p20} "
          f"({smi})", flush=True)
    return report


def ds_train_flops(cfg, S):
    """Operations of one training step (forward and backward, 3x the
    forward's) of deepseek at B 1 x S: every matrix param once a token
    (the embedding is a gather; the MTP block and head run over S - 1
    positions, counted as S), plus each MLA layer's scores and values
    over all S x S pairs (the main stack's and the MTP block's)."""
    from repro_torch.models import transformer
    from repro_torch.utils.pytree import tree_flatten_with_paths

    shapes = transformer.param_shapes(cfg)
    mat = sum(int(s.numel()) for p, s in tree_flatten_with_paths(shapes)
              if len(s) >= 2 and p != "embed")
    H = cfg.n_heads
    attn = 2 * S * S * H * (cfg.qk_nope_dim + cfg.qk_rope_dim
                            + cfg.v_head_dim)
    n_attn = cfg.n_layers + (1 if cfg.mtp else 0)
    return 3 * (2 * S * mat + n_attn * attn)


def run_ds_train(cfg, kern, dev="cuda"):
    """Phase 20d: deepseek-v3-671b cut to its dense layer with the MTP
    head (3,123,106,816 params; ``cfg`` replaces it for a rehearsal),
    f32, weights drawn afresh, trained DS_TRAIN_STEPS AdamW steps at B 1
    x S DS_TRAIN_S, params and moments updated in place (no kernel
    launches): the loss with its ce and mtp terms, ms/step against the
    bytes bound (AdamW's nine f32 accesses a param) and the f32 FLOP bound
    (``ds_train_flops``), peak memory."""
    import numpy as np
    import torch

    from repro_torch.data import lm_batch
    from repro_torch.optim import OptimizerConfig, make_optimizer
    from repro_torch.train.steps import make_train_step
    from repro_torch.utils.pytree import tree_param_count

    on_card = dev == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    if cfg is None:
        cfg, params = ds_model(1, dev)
    else:
        from repro_torch.launch.serve import build_params
        params = build_params(cfg, seed=0, device=dev)
    n_params = tree_param_count(params)
    if cfg.d_model == 7168 and n_params != DS_N_PARAMS[1]:
        raise AssertionError(f"deepseek at 1 layer has {n_params} params")
    batch = {"tokens": torch.from_numpy(lm_batch(
        cfg.vocab_size, 1, DS_TRAIN_S, seed=20)).to(dev)}
    opt = OptimizerConfig(lr=1e-4)
    init_fn, _ = make_optimizer(opt)
    state = init_fn(params)
    step = make_train_step(cfg, opt)
    _launch_counts(kern, zero=True)
    ms, metrics = [], []
    for i in range(DS_TRAIN_STEPS):
        _sync()
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch, i + 1)
        m = {k: float(v) for k, v in m.items()}  # reads back: synchronises
        _sync()
        ms.append((time.perf_counter() - t0) * 1e3)
        metrics.append(m)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    launches = _launch_counts(kern, zero=True)
    if launches != {name: 0 for name in kern}:
        raise AssertionError(f"deepseek training launched {launches}")
    if not all(np.isfinite(m["loss"]) and np.isfinite(m["mtp"])
               for m in metrics) or not all(
            bool(torch.isfinite(t).all()) for t in _leaves(params)):
        raise AssertionError(f"deepseek training went wrong: {metrics}")
    flops = ds_train_flops(cfg, DS_TRAIN_S)
    by_bytes = bound_ms(9 * 4 * n_params, 0, "float32")[0]
    by_ops = bound_ms(0, flops, "float32")[0]
    print(f"deepseek-v3-671b training (1 dense layer + the MTP head): B 1 x "
          f"S {DS_TRAIN_S}, AdamW f32, {n_params} params: ms/step "
          f"{[round(x, 1) for x in ms]} against the bytes bound "
          f"{by_bytes:.1f} ms ({9 * 4 * n_params / 1e9:.1f} GB at 3.35 TB/s) "
          f"and the f32 FLOP bound {by_ops:.1f} ms ({flops:.4g} FLOPs at 67 "
          f"TFLOP/s); peak memory {peak / 2**30:.2f} GiB; loss "
          f"{[round(m['loss'], 5) for m in metrics]}, ce "
          f"{[round(m['ce'], 5) for m in metrics]}, mtp "
          f"{[round(m['mtp'], 5) for m in metrics]}; no kernel launched",
          flush=True)
    del state, params
    return dict(ms_per_step=ms, bytes_bound_ms=by_bytes, flop_bound_ms=by_ops,
                flops=flops, n_params=n_params, peak_gib=peak / 2**30,
                metrics=metrics)


QV_ARCH = "qwen2-vl-72b"
QV_LAYERS = 2  # of 80: phase 21 cuts depth, never width
QV_N_PARAMS = 4_246_794_240  # eval_shape at 2 layers (877,684,736 a layer)
# phase 21 serves phase 19's geometry: PHI_CAPACITY, PHI_MAX_LEN, PHI_K,
# PHI_BUCKET, PHI_NEW, and ``phi_requests(vocab, shared=True)``
QV_PAGES = 32  # half the dense pool's 64 pages of 64
QV_D, QV_SPEC_K = 4, 2  # the nudged draft's depth, blocks a dispatch
QV_DRAFT_NOISE = 1e-3  # noise / leaf std
QV_PLAIN_REQS = 2  # held against the plain route (and ``generate``)
QV_MIN_DISTINCT = 64  # distinct tokens of the dense run's 512, at least
QV_KERNELS = ("flash_attention", "slot_decode_attention",
              "paged_slot_decode_attention", "chunk_verify_attention",
              "paged_chunk_verify_attention", "decode_attention")


def qv_model(layers=QV_LAYERS, dev="cuda"):
    """qwen2-vl-72b at full width (d_model 8,192, 64 heads over 8 KV heads
    of 128, d_ff 29,568, vocab 152,064, qkv bias, M-RoPE sections (16, 24,
    24) at theta 1e6) cut to ``layers`` layers, in f32, weights from a
    torch.Generator seeded 0 on ``dev`` at the init's std (0.02; not
    scaled: ``phi_spread`` reports the spread this gives)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import build_params

    cfg = get_config(QV_ARCH).replace(
        n_layers=layers, param_dtype="float32", compute_dtype="float32")
    return cfg, build_params(cfg, seed=0, device=dev)


def mrope_grid_positions(B, S, grid=(16, 16)):
    """(3, B, S) Qwen2-VL positions with three distinct streams: row b
    opens with 8 + b text tokens (t = h = w = i), then an image of
    ``grid`` (gh, gw) patches (t stands at the span's start while h and w
    walk the grid), then text again from the span's largest position +
    1."""
    import numpy as np

    gh, gw = grid
    pos = np.zeros((3, B, S), np.int64)
    for b in range(B):
        start, n = 8 + b, gh * gw
        pos[:, b, :start] = np.arange(start)
        rows, cols = np.divmod(np.arange(n), gw)
        pos[0, b, start:start + n] = start
        pos[1, b, start:start + n] = start + rows
        pos[2, b, start:start + n] = start + cols
        pos[:, b, start + n:] = start + max(gh, gw) + np.arange(
            S - start - n)
    return pos


def check_mrope_on_card(cfg, dev):
    """One M-RoPE rotation at three distinct position streams (a
    (2, 448, 64, 128) q, as an admission row of phase 21 gives it) on the
    card against the same on the CPU, f32: within TOL's f32 limits; and
    it differs from 1-D RoPE there.  Returns the max abs error."""
    import torch

    from repro_torch.models import rope

    gen = torch.Generator().manual_seed(21)
    x = torch.randn(2, 448, cfg.n_heads, cfg.head_dim, generator=gen)
    pos3 = torch.from_numpy(mrope_grid_positions(2, 448))
    kw = dict(theta=cfg.rope_theta, sections=cfg.mrope_sections)
    want = rope.apply_mrope(x, pos3, **kw)
    got = rope.apply_mrope(x.to(dev), pos3.to(dev), **kw)
    err = check_close("M-RoPE on the card vs the CPU", got.cpu(), want,
                      "float32")
    if float((want - rope.apply_rope(x, pos3[1], theta=cfg.rope_theta))
             .abs().max()) < 0.1:
        raise AssertionError("the M-RoPE check's streams do not tell it "
                             "from 1-D RoPE")
    return err


def qv_kernel_checks(cfg, dev):
    """Each attention kernel phase 21 runs, against its plain version at
    the shapes its routes give it (64 query heads over 8 KV heads of 128:
    G 8), f32 and bf16: flash over a 448-token admission row; the dense
    slot and ``decode_attention`` (the pool's transposed view) over a
    capacity-8 pool of 512 with a done row; the dense verify at S 5 (d 4 +
    1: 40 query rows a KV head, in tiles); the paged slot and the paged
    verify over 32 pages of 64 through permuted block tables with
    sentinels.  Returns {kernel: max abs err over both dtypes}."""
    import torch

    from repro_torch.kernels import ops, ref

    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    B, Sc, S, page, n_pages = PHI_CAPACITY, PHI_MAX_LEN, QV_D + 1, 64, 32
    gen = torch.Generator(device=dev).manual_seed(21)
    errs = {name: 0.0 for name in QV_KERNELS}
    kv_len = torch.tensor([0, 64, 96, 448, 200, 333, 128, 511],
                          dtype=torch.int32, device=dev)
    offs = torch.tensor([-1, 64, 96, 448, 200, 333, 128, 500],
                        dtype=torch.int32, device=dev)
    nblk = Sc // page
    perm = torch.randperm(n_pages, generator=gen, device=dev).to(torch.int32)
    bt = torch.full((B, nblk), n_pages, dtype=torch.int32, device=dev)
    for b in range(B):  # 4 pages a row; the rest of the table sentinels
        bt[b, :4] = perm[(4 * b) % n_pages:(4 * b) % n_pages + 4]
    kv_paged = torch.clamp(kv_len, max=4 * page)
    offs_paged = torch.clamp(offs, max=4 * page - S)
    for dname in ("float32", "bfloat16"):
        dt = getattr(torch, dname)

        def rnd(*shape):
            return torch.randn(shape, generator=gen, device=dev).to(dt)

        q, k, v = rnd(1, H, 448, hd), rnd(1, KV, 448, hd), rnd(1, KV, 448, hd)
        cases = [("flash_attention", ops.flash_attention(q, k, v),
                  ref.flash_attention_ref(q, k, v))]
        pool_k, pool_v, qd = rnd(B, Sc, KV, hd), rnd(B, Sc, KV, hd), rnd(
            B, H, hd)
        cases.append(("slot_decode_attention",
                      ops.slot_decode_attention(qd, pool_k, pool_v, kv_len),
                      ref.slot_decode_attention_ref(qd, pool_k, pool_v,
                                                    kv_len)))
        kt, vt = pool_k.transpose(1, 2), pool_v.transpose(1, 2)
        cases.append(("decode_attention",
                      ops.decode_attention(qd, kt, vt, kv_len),
                      ref.decode_attention_ref(qd, kt, vt, kv_len)))
        qc, kc, vc = rnd(B, S, H, hd), rnd(B, S, KV, hd), rnd(B, S, KV, hd)
        cases.append(("chunk_verify_attention",
                      ops.chunk_verify_attention(qc, pool_k, pool_v, kc, vc,
                                                 offs, ring=False),
                      ref.chunk_verify_attention_ref(
                          qc, pool_k, pool_v, kc, vc, offs, ring=False)))
        ak, av = rnd(n_pages + 1, page, KV, hd), rnd(n_pages + 1, page, KV,
                                                      hd)
        cases.append(("paged_slot_decode_attention",
                      ops.paged_slot_decode_attention(qd, ak, av, bt,
                                                      kv_paged),
                      ref.paged_slot_decode_attention_ref(qd, ak, av, bt,
                                                          kv_paged)))
        cases.append(("paged_chunk_verify_attention",
                      ops.paged_chunk_verify_attention(
                          qc, ak, av, bt, kc, vc, offs_paged, ring=False),
                      ref.paged_chunk_verify_attention_ref(
                          qc, ak, av, bt, kc, vc, offs_paged, ring=False)))
        _sync()
        for name, got, want in cases:
            errs[name] = max(errs[name], check_close(
                f"{name} at phase 21's shape ({dname})", got, want, dname))
    return errs


def run_qwen2vl(kernel_rows, smi, cfg=None, dev="cuda"):
    """Phase 21: qwen2-vl-72b at full width cut to QV_LAYERS layers, in
    f32 (``cfg`` and ``dev`` replace it for a rehearsal at a small size on
    the CPU), on phase 19's geometry (8 requests of 64..448 prompt tokens,
    the last 4 opening on one 256-token prefix; 64 new each, capacity 8,
    max_len 512, K 8, buckets of 16).  Serving builds three equal M-RoPE
    streams (1-D RoPE exactly, as in the reference), so one rotation at
    three distinct streams is checked on the card against the CPU, and
    each attention kernel against its plain version at this phase's
    shapes (G 8).  Then: the dense pool, a QV_PAGES-page pool with prefix
    hits (its schedule as a CPU run predicts it), a copy nudged by
    QV_DRAFT_NOISE of each leaf's std drafting (d 4, K 2) on both pools
    (acceptance strictly inside (0, 1)), ``generate`` at B 1 and the plain
    route on the first QV_PLAIN_REQS: every run == the dense run, and the
    first QV_PLAIN_REQS == the plain route, up to reported near ties;
    exact launches, 0 pages in use.  Then the dense pool in bf16 (weights
    cast leaf by leaf after the draft is gone), its first QV_PLAIN_REQS
    held to the same route replayed with plain attention in bf16 (a
    parting excused at a gap of at most two bf16 ulps)."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch.serve import build_params, generate
    from repro_torch.serve import ContinuousBatchingEngine, SpeculativeConfig
    from repro_torch.utils.pytree import tree_param_count

    t_phase = time.perf_counter()
    full = cfg is None
    kern = ops.kernels()
    on_card = dev == "cuda"
    t0 = time.perf_counter()
    if full:
        cfg, params = qv_model(QV_LAYERS, dev)
    else:
        params = build_params(cfg, seed=0, device=dev)
    _sync()
    init_s = time.perf_counter() - t0
    n_params = tree_param_count(params)
    if full and n_params != QV_N_PARAMS:
        raise AssertionError(f"qwen2-vl-72b at {QV_LAYERS} layers has "
                             f"{n_params} params, not {QV_N_PARAMS}")
    L = cfg.n_layers
    reqs = phi_requests(cfg.vocab_size, shared=True)
    pool_kw = dict(capacity=PHI_CAPACITY, max_len=PHI_MAX_LEN, k=PHI_K,
                   prefill_bucket=PHI_BUCKET)
    t0 = time.perf_counter()
    predicted = predict_phi_schedule(cfg, reqs, pool="paged", pages=QV_PAGES,
                                     **pool_kw)
    predict_s = time.perf_counter() - t0
    spread = phi_spread(cfg, params, dev)
    report = dict(n_params=n_params, init_seconds=init_s, spread=spread,
                  predicted=predicted, nvidia_smi=smi)
    if on_card:
        report["mrope_err"] = check_mrope_on_card(cfg, dev)
        report["kernel_errs"] = qv_kernel_checks(cfg, dev)
    print(f"qwen2-vl-72b: {L} x {cfg.d_model}, {cfg.n_heads} heads over "
          f"{cfg.n_kv_heads} KV heads of {cfg.head_dim}, d_ff {cfg.d_ff}, "
          f"vocab {cfg.vocab_size}, M-RoPE sections {cfg.mrope_sections}: "
          f"{n_params} params (f32, drawn in {init_s:.1f} s); spread "
          f"{spread}; M-RoPE at three distinct streams, card vs CPU "
          f"{report.get('mrope_err')}; kernels vs plain at this phase's "
          f"shapes {report.get('kernel_errs')}; the paged schedule as a CPU "
          f"run predicts it ({predict_s:.1f} s): {predicted} ({smi})",
          flush=True)
    if predicted["hits"] < 1:
        raise AssertionError(f"the schedule predicts no prefix hit: "
                             f"{predicted}")
    p21 = {name: 0 for name in QV_KERNELS}

    def want_launches(eng):
        return (_phi_launches(eng, eng.cfg.n_layers, kern) if on_card
                else {name: 0 for name in kern})

    def serve(label, make_engine):
        return moe_serve("qwen2-vl", label, make_engine, reqs, kern,
                         want_launches, p21, smi, on_card)

    runs = {}
    for pool in ("dense", "paged"):
        runs[pool], report[pool], eng = serve(
            f"f32 {pool}", lambda: ContinuousBatchingEngine(
                cfg, params, pool=pool,
                pages=QV_PAGES if pool == "paged" else None, **pool_kw))
        del eng
    if report["paged"]["schedule"] != predicted:
        raise AssertionError(f"qwen2-vl paged schedule "
                             f"{report['paged']['schedule']} differs from "
                             f"the CPU prediction {predicted}")
    draft = nudged_copy(params, QV_DRAFT_NOISE, seed=21)
    for pool in ("dense", "paged"):
        label = f"{pool} speculative"
        runs[label], report[label], eng = serve(
            f"f32 {label}", lambda: ContinuousBatchingEngine(
                cfg, params, capacity=PHI_CAPACITY, max_len=PHI_MAX_LEN,
                k=QV_SPEC_K, prefill_bucket=PHI_BUCKET, pool=pool,
                speculative=SpeculativeConfig(cfg, draft, d=QV_D)))
        del eng
        acc = report[label]["acceptance"]
        if not 0.0 < acc < 1.0:
            raise AssertionError(f"qwen2-vl {label}: acceptance {acc} not "
                                 "inside (0, 1)")
    del draft
    # generate at B 1 (flash prefill, decode_attention) on the first few
    gen = {}
    for r in reqs[:QV_PLAIN_REQS]:
        _launch_counts(kern, zero=True)
        with torch.no_grad():
            gen[r.uid] = generate(cfg, params, torch.from_numpy(
                r.prompt)[None].to(dev), max_new_tokens=PHI_NEW,
                max_len=PHI_MAX_LEN)[0].cpu().numpy()
        got = _launch_counts(kern, zero=True)
        want = {name: 0 for name in kern}
        if on_card:
            want.update(flash_attention=L, decode_attention=L * (PHI_NEW - 1))
        if got != want:
            raise AssertionError(f"uid {r.uid}: generate launched {got}, "
                                 f"expected {want}")
        for name in p21:
            p21[name] += got[name]
    t0 = time.perf_counter()
    plain = {r.uid: phi_plain_route(cfg, params, r.prompt, PHI_NEW)
             for r in reqs[:QV_PLAIN_REQS]}
    plain_s = time.perf_counter() - t0
    if _launch_counts(kern) != {name: 0 for name in kern}:
        raise AssertionError("the plain route launched a kernel")
    ties, _ = moe_check_runs(
        "qwen2-vl f32", runs, reqs,
        lambda r: (plain.get(r.uid) or phi_plain_route(
            cfg, params, r.prompt, PHI_NEW)) + ({},), PHI_NEW, cfg.vocab_size)
    ties["dense vs plain"], ties["generate vs plain"] = [], []
    for r in reqs[:QV_PLAIN_REQS]:
        for what, toks in (("dense", runs["dense"][r.uid]),
                           ("generate", gen[r.uid])):
            tie = check_phi_tokens(f"qwen2-vl {what} and the plain route",
                                   r.uid, toks, *plain[r.uid])
            if tie is not None:
                ties[f"{what} vs plain"].append(tie)
    distinct = int(np.unique(np.concatenate(list(runs["dense"].values())))
                   .size)
    report.update(near_ties=ties, plain_route_seconds=plain_s,
                  distinct_tokens=distinct)
    print(f"qwen2-vl f32: the {len(runs)} engine runs equal for "
          f"{len(reqs)}/{len(reqs)} requests, the dense run and generate (B "
          f"1) == the plain route ({plain_s:.1f} s) for uids "
          f"{sorted(plain)}, but near ties {ties}; {distinct} distinct "
          f"tokens of the dense run's {len(reqs) * PHI_NEW}", flush=True)
    if full and distinct < QV_MIN_DISTINCT:
        raise AssertionError(f"qwen2-vl's dense run gave only {distinct} "
                             "distinct tokens: its greedy output repeats")
    del runs, plain, gen

    # the published bf16: the f32 weights cast leaf by leaf
    cfg16 = cfg.replace(param_dtype="bfloat16", compute_dtype="bfloat16")
    params = _cast_in_place(params, torch.bfloat16)
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    out16, report["bf16 dense"], eng = serve(
        "bf16 dense", lambda: ContinuousBatchingEngine(cfg16, params,
                                                       **pool_kw))
    del eng
    ties16 = []
    for r in reqs[:QV_PLAIN_REQS]:
        toks, gaps, rgaps, tops = phi_route_replay(cfg16, params, r.prompt,
                                                   PHI_NEW)
        tie = check_phi_tokens("qwen2-vl bf16 dense and its plain replay",
                               r.uid, out16[r.uid], toks,
                               gaps / bf16_ulp(tops), rgaps, tie=2.5)
        if tie is not None:
            ties16.append(tie)
    report["bf16 near ties"] = ties16
    if _launch_counts(kern) != {name: 0 for name in kern}:
        raise AssertionError("the bf16 plain replay launched a kernel")
    del params, out16
    for name, n in p21.items():
        kernel_rows[name]["launches_p21"] = n
    report["launches_p21"] = p21
    report["seconds"] = time.perf_counter() - t_phase
    print(f"qwen2-vl bf16 dense == its plain replay for uids "
          f"{[r.uid for r in reqs[:QV_PLAIN_REQS]]} but near ties (uid, "
          f"step, gap in ulps) {ties16}; qwen2-vl phase: "
          f"{report['seconds']:.1f} s; launches {p21} ({smi})", flush=True)
    return report


HU_ARCH = "hubert-xlarge"
HU_N_PARAMS = 988_193_280  # eval_shape: 48 x 1280, head dim 80
HU_TRAIN_B, HU_TRAIN_S, HU_TRAIN_STEPS = 2, 512, 3  # phase 22a
HU_LR = 1e-4  # phase 22a's AdamW, and 22b's scratch model's
# phase 22b: the source, hubert-xlarge at half depth and width (24 x 640,
# 8 heads of 80, d_ff 2,560; the frames stay 1,280 wide), pretrained
# HU_GROW_PRE steps at lr 3e-3, HU_GROW_OP operator steps into
# hubert-xlarge at HU_OP_LR, the scratch model trained HU_GROW_OP steps at
# HU_LR; B 2 x S 256 frames
HU_GROW_PRE, HU_GROW_OP, HU_GROW_B, HU_GROW_S = 40, 5, 2, 256
# the smaller phases' operator lr (2e-3 at width 64) scaled by 64 / 1,280:
# a step moves every entry of A_I and A_O by about lr, and each grown
# weight sums ~D of them, so 2e-3 at width 1,280 diverged (3.75 -> 21.3
# in 5 steps; PERF.md section 6)
HU_OP_LR = 1e-4


def hubert_half(cfg):
    """Phase 22b's Mango source: ``cfg`` (hubert-xlarge) at half depth
    and width, the paper's L/2, D/2 setting."""
    return cfg.replace(name="hubert-xlarge-half", n_layers=cfg.n_layers // 2,
                       d_model=cfg.d_model // 2, n_heads=cfg.n_heads // 2,
                       n_kv_heads=cfg.n_kv_heads // 2, d_ff=cfg.d_ff // 2)


def hubert_train_flops(cfg, B, S):
    """Operations of one training step (forward and backward, 3x the
    forward's) of the encoder at B x S frames: every matrix param once a
    frame (``pos_embed`` is a gather), plus the non-causal scores and
    values over all S x S pairs of every layer."""
    from repro_torch.models import transformer
    from repro_torch.utils.pytree import tree_flatten_with_paths

    mat = sum(int(s.numel()) for p, s in tree_flatten_with_paths(
        transformer.param_shapes(cfg)) if len(s) >= 2 and p != "pos_embed")
    attn = 4 * S * S * cfg.n_heads * cfg.head_dim
    return 3 * B * (2 * S * mat + cfg.n_layers * attn)


def run_hubert(kernel_rows, smi, cfg=None, dev="cuda"):
    """Phase 22: hubert-xlarge (an encoder over continuous frames, 48 x
    1,280, head dim 80; ``cfg`` and ``dev`` replace it for a rehearsal).
    (a) Full width and depth, f32, trained HU_TRAIN_STEPS AdamW steps at
    B HU_TRAIN_B x S HU_TRAIN_S on the train launcher's frames batches
    (``launch.train.data_for``), params and moments updated in place: the
    uncached non-causal forward takes plain attention, so no kernel
    launches; finite losses, ms/step against the f32 FLOP bound, peak
    memory.  (b) Grown into from its half-depth, half-width twin
    (``hubert_half``) by rank-1 Mango (``run_small_growth`` on frames:
    exact sandwich launches, the plain route's params within 1e-5 of a
    leaf's largest entry, the held-out margin scratch - grown after equal
    steps -- HU_GROW_OP operator steps, HU_GROW_OP scratch steps -- which
    must be positive)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import build_params
    from repro_torch.launch.train import data_for
    from repro_torch.optim import OptimizerConfig, make_optimizer
    from repro_torch.train.steps import make_train_step
    from repro_torch.utils.pytree import tree_param_count

    t_phase = time.perf_counter()
    full = cfg is None
    if full:
        cfg = get_config(HU_ARCH).replace(param_dtype="float32",
                                          compute_dtype="float32")
    kern = ops.kernels()
    on_card = dev == "cuda"
    B, S = (HU_TRAIN_B, HU_TRAIN_S) if full else (2, 32)
    if on_card:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = build_params(cfg, seed=0, device=dev)
    _sync()
    init_s = time.perf_counter() - t0
    n_params = tree_param_count(params)
    if full and n_params != HU_N_PARAMS:
        raise AssertionError(f"hubert-xlarge has {n_params} params, not "
                             f"{HU_N_PARAMS}")
    data = data_for(cfg, B, S, seed=22)
    opt = OptimizerConfig(lr=HU_LR)
    init_fn, _ = make_optimizer(opt)
    state = init_fn(params)
    step = make_train_step(cfg, opt)
    _launch_counts(kern, zero=True)
    ms, metrics = [], []
    for i in range(HU_TRAIN_STEPS):
        batch = {k: torch.as_tensor(v).to(dev) for k, v in next(data).items()}
        if batch["inputs"].shape != (B, S, cfg.continuous_inputs):
            raise AssertionError(f"frames of {tuple(batch['inputs'].shape)}")
        _sync()
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch, i + 1)
        m = {k: float(v) for k, v in m.items()}  # reads back: synchronises
        _sync()
        ms.append((time.perf_counter() - t0) * 1e3)
        metrics.append(m)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    launches = _launch_counts(kern, zero=True)
    if launches != {name: 0 for name in kern}:
        raise AssertionError(f"hubert training launched {launches}")
    if not all(np.isfinite(m["loss"]) for m in metrics) or not all(
            bool(torch.isfinite(t).all()) for t in _leaves(params)):
        raise AssertionError(f"hubert training went wrong: {metrics}")
    flops = hubert_train_flops(cfg, B, S)
    b_ms, b_by = bound_ms(9 * 4 * n_params, flops, "float32")
    report = dict(n_params=n_params, init_seconds=init_s, nvidia_smi=smi,
                  train=dict(ms_per_step=ms, bound_ms=b_ms, bound_by=b_by,
                             flops=flops, peak_gib=peak / 2**30,
                             metrics=metrics, batch=B, seq=S))
    print(f"hubert-xlarge training: {cfg.n_layers} x {cfg.d_model}, "
          f"{cfg.n_heads} heads of {cfg.head_dim}, {n_params} params (f32, "
          f"drawn in {init_s:.1f} s); frames B {B} x S {S} x "
          f"{cfg.continuous_inputs} from the train launcher, AdamW f32: "
          f"ms/step {[round(x, 1) for x in ms]} against the bound "
          f"{b_ms:.1f} ms ({b_by}; {flops:.4g} FLOPs at 67 TFLOP/s f32, "
          f"{9 * 4 * n_params / 1e9:.1f} GB at 3.35 TB/s); peak memory "
          f"{peak / 2**30:.2f} GiB; losses "
          f"{[round(m['loss'], 5) for m in metrics]}; no kernel launched "
          f"({smi})", flush=True)
    del state, params
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    report["grow"] = run_small_growth(
        kernel_rows, "hubert", hubert_half(cfg), cfg, "launches_p22",
        HU_GROW_PRE, HU_GROW_OP, HU_GROW_S if full else 16, dev,
        batch=HU_GROW_B, op_lr=HU_OP_LR, scratch_steps=HU_GROW_OP,
        scratch_lr=HU_LR)
    if not report["grow"]["margin"] > 0:
        raise AssertionError(f"grown hubert-xlarge is no better than "
                             f"scratch after {HU_GROW_OP} steps: margin "
                             f"{report['grow']['margin']}")
    report["launches_p22"] = {"tr_sandwich": kernel_rows["tr_sandwich"][
        "launches_p22"]}
    report["seconds"] = time.perf_counter() - t_phase
    print(f"hubert phase: {report['seconds']:.1f} s; launches "
          f"{report['launches_p22']} ({smi})", flush=True)
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
          f"{ {k: round(v, 1) for k, v in secs.items()} }; CPU s: "
          f"{ {k: round(v, 1) for k, v in build.cpu_seconds.items()} })",
          flush=True)
    for name, log in build.ptxas_log.items():
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        print(f"ptxas {name}: {regs}", flush=True)

    phase("kernels vs plain versions")
    t0 = time.perf_counter()
    rows = run_kernels()
    print(f"phase 3 took {time.perf_counter() - t0:.1f} s", flush=True)

    phase("serve gpt-base")
    t0 = time.perf_counter()
    serve = run_serve(rows)
    print(f"phase 4 took {time.perf_counter() - t0:.1f} s", flush=True)

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
    del big, spec_reqs, spec_plain  # phase 14 serves gpt-small again
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
    print(f"phase 10 took {time.perf_counter() - t0:.1f} s", flush=True)

    phase("griffin speculation: recurrentgemma-2b drafting for itself")
    t0 = time.perf_counter()
    griffin_spec = run_griffin_spec(griffin_model_state, griffin_paged)
    del griffin_model_state
    print(f"phase 10b took {time.perf_counter() - t0:.1f} s", flush=True)

    phase("serve qwen3-0.6b (RoPE): dense, paged, speculative, generate")
    t0 = time.perf_counter()
    qwen = run_qwen(rows)
    print(f"phase 11 took {time.perf_counter() - t0:.1f} s", flush=True)
    gc.collect()  # phase 11's models go before DeiT-B
    torch.cuda.empty_cache()

    phase("grow deit-s -> deit-b: checkpoints, resume, the examples")
    t0 = time.perf_counter()
    deit = run_deit(rows)
    deit["serve_continuous"] = run_serve_continuous()
    deit["serve_batched"] = run_serve_batched()
    print(f"phase 12 took {time.perf_counter() - t0:.1f} s", flush=True)
    gc.collect()  # phase 12's models go before gpt-base
    torch.cuda.empty_cache()

    phase("sampled serving of gpt-base: chains, replay, paged, speculative")
    t0 = time.perf_counter()
    sampled = run_sampled()
    print(f"phase 13 took {time.perf_counter() - t0:.1f} s", flush=True)

    phase("live upgrade gpt-small -> gpt-base; crash recovery")
    t0 = time.perf_counter()
    upgrade, grown = run_upgrade(small)
    print(f"phase 14 took {time.perf_counter() - t0:.1f} s", flush=True)

    phase("faults: quarantine, degradation, deadlines, shedding, crash, "
          "realtime arrivals")
    t0 = time.perf_counter()
    faults = run_faults(small, grown)
    del small, grown
    print(f"phase 15 took {time.perf_counter() - t0:.1f} s", flush=True)
    gc.collect()  # phase 15's models go before recurrentgemma-2b's training
    torch.cuda.empty_cache()

    phase("griffin growth and training: griffin-micro -> griffin-micro-big, "
          "the griffin upgrade command, recurrentgemma-2b trained at full "
          "width")
    t0 = time.perf_counter()
    griffin_growth = run_griffin_grown_pair(rows)
    griffin_growth["train"] = run_griffin_train(rows)
    print(f"phase 16 took {time.perf_counter() - t0:.1f} s", flush=True)
    gc.collect()  # phase 16's models go before qwen3-0.6b's window
    torch.cuda.empty_cache()

    phase("windowed qwen3-0.6b: ring caches dense and paged, ring prefix "
          "sharing, ring speculation on both pools")
    t0 = time.perf_counter()
    window = run_window(rows, smi[0] if smi else "nvidia-smi: no output")
    print(f"phase 17 took {time.perf_counter() - t0:.1f} s", flush=True)
    gc.collect()  # phase 17's models go before xlstm-1.3b
    torch.cuda.empty_cache()

    phase("xlstm-1.3b: dense, paged and speculative serving, chunkwise "
          "against the recurrence, growth into an xlstm, training at full "
          "width")
    t0 = time.perf_counter()
    xl = run_xlstm(rows, smi[0] if smi else "nvidia-smi: no output")
    print(f"phase 18 took {time.perf_counter() - t0:.1f} s", flush=True)
    gc.collect()  # phase 18's models go before phi3.5-moe-42b
    torch.cuda.empty_cache()

    phase("phi3.5-moe-42b (MoE): dense, paged and speculative serving at two "
          "capacity factors, f32 and bf16, growth into an MoE, training at "
          "full width")
    t0 = time.perf_counter()
    phi = run_phi(rows, smi[0] if smi else "nvidia-smi: no output")
    print(f"phase 19 took {time.perf_counter() - t0:.1f} s", flush=True)
    gc.collect()  # phase 19's models go before deepseek-v3-671b
    torch.cuda.empty_cache()

    phase("deepseek-v3-671b (MLA, MoE, MTP): latent caches dense and paged "
          "at two capacity factors, f32 and bf16, speculation, growth, "
          "training at full width")
    t0 = time.perf_counter()
    ds = run_ds(rows, smi[0] if smi else "nvidia-smi: no output")
    print(f"phase 20 took {time.perf_counter() - t0:.1f} s", flush=True)
    gc.collect()  # phase 20's models go before qwen2-vl-72b
    torch.cuda.empty_cache()

    phase("qwen2-vl-72b (M-RoPE): dense and paged, speculative on both "
          "pools, generate, bf16")
    t0 = time.perf_counter()
    qv = run_qwen2vl(rows, smi[0] if smi else "nvidia-smi: no output")
    print(f"phase 21 took {time.perf_counter() - t0:.1f} s", flush=True)
    gc.collect()  # phase 21's models go before hubert-xlarge
    torch.cuda.empty_cache()

    phase("hubert-xlarge (continuous inputs): trained at full width and "
          "depth, grown into from its half")
    t0 = time.perf_counter()
    hubert = run_hubert(rows, smi[0] if smi else "nvidia-smi: no output")
    print(f"phase 22 took {time.perf_counter() - t0:.1f} s", flush=True)

    # the contract's keys, then the tensor-core rows' 3xTF32 and bf16 ones
    kernels = [{key: r[key] for key in (
        "name", "route", "source", "replaces", "launches", "max_abs_err",
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
        "bound_rate", "bound_simt_ms", "bf16_ms", "bf16_library_ms",
        "bf16_bound_ms", "launches_p19", "launches_p20", "launches_p21",
        "launches_p22") if key in r}
        for r in rows.values()]
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"device": kind, "nvidia_smi": smi, "kernels": list(rows.values()),
             "serve": serve, "grow": grow, "speculative": spec,
             "paged": paged, "paged_speculative": paged_spec,
             "griffin_dense": griffin_dense, "griffin_paged": griffin_paged,
             "griffin_speculative": griffin_spec, "faults": faults,
             "qwen": qwen, "deit": deit, "sampled": sampled,
             "upgrade": upgrade, "griffin_growth": griffin_growth,
             "window": window, "xlstm": xl, "phi": phi, "deepseek": ds,
             "qwen2_vl": qv, "hubert": hubert, "build_seconds": secs},
            indent=1))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
