#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printed as it runs; any failure exits non-zero:

1. device  — requires CUDA; prints the card's name and power limit as
   ``nvidia-smi`` reports them, the torch and CUDA versions, and turns TF32
   off for matrix products and convolutions (the plain versions and the
   library yardstick then run in full float32).
2. build   — builds every CUDA kernel from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, in parallel).
3. kernels — holds each kernel against its plain PyTorch version on the
   card, with the stated tolerance, at every shape phases 4 to 16 give it
   (the paper's full sizes, MRI-Q's bench size, the six prefill buckets,
   the planners' reduced models, paligemma's three causal S = 256 +
   bucket, timed beside SDPA with ``enable_gqa`` and the same causal
   mask as row 3p, and, row 3w, whisper's bidirectional encoder attention
   at [1, 12/12, 1,500, 64], timed beside SDPA) and at one shape off the
   kernel's grain
   (FIR: N=4000, where the default block_n 512 is clamped to 500; MRI-Q:
   300 x 200, ragged in both loops; the scans: S=9 and D=300, no multiple
   of a tile; rmsnorm: 9 rows of D=300, off the 16-byte grain); times
   kernel, plain version and, where one PyTorch call computes the same
   function, that call with CUDA events; prints the bound and each
   kernel's registers and shared memory beside the Step-3 estimate.  The
   kernels (rmsnorm aside) are timed from their C entry points on
   arguments checked and allocated once, as a CUDA-graph replay of the
   launches (the host's enqueue cost out; SDPA and FIR's grouped conv1d
   timed the same way) beside the wrapper-call times, at every tile point
   of FIR, rglru_scan and bf16 flash, where each Step-3 estimate must
   equal the kernel's shared memory (static + dynamic); the bf16 flash
   instances must show HGMMA and UTMALDG in ``cuobjdump -sass``, and the
   decode grid at the serving shape at least 264 blocks.  rglru_scan also
   runs at the chunked scan's edges (S one short of, at and one past
   time_chunk; two batch rows over three groups of chunks; exact 0s and
   1s in a; D odd; 2,500 x 3 x 3 blocks), and its launch is replayed from
   one CUDA graph on alternating inputs, outputs poisoned before each
   replay, and must give the eager results bit for bit.
4. planner — the main path: the five-step planner on tdFIR (HPEC set 1)
   and MRI-Q (sampled at its bench size, analysed at Parboil "large"),
   strategy staged, d=4, against a temporary plan cache; a second plan is
   served from the cache with zero measurements.
5. run     — the main path continued: the ``hopper`` patterns of both apps
   at the paper's full sizes, held against the all-offload builds (and
   tdFIR's timed warm, the median of 5 calls).  The
   kernels' launch counters are zeroed before phase 4 and read here: both
   must have launched.
6. serve   — the slice-2 main path: plans ``make_lm_program
   ("mistral-nemo-12b")`` (staged, temporary plan cache, then a cache hit),
   builds full-width Mistral-NeMo-12B (40 layers, random weights from a
   seeded generator on the card) and serves 3 greedy requests (prompts
   2,060 / 300 / 9 tokens, buckets 2,080 / 512 / 16; phase 9 serves the
   whole mix of 6: 2,060 / 2,048 / 1,000 / 300 / 100 / 9, buckets 2,080 /
   2,048 / 1,024 / 512 / 128 / 16) on 4 slots at ctx 2,080 with
   ``attn_core=hopper`` over the planned pattern, twice on one engine:
   round 1 captures a CUDA
   graph per prefill bucket and the decode graph, round 2 replays them and
   must capture nothing; an eager twin (the same step functions, called
   eagerly) serves the mix once more.  Every request must finish with 16
   tokens, the three runs must give the same greedy streams, and each
   request's prefill logits under ``attn_core=hopper`` must agree with
   ``attn_core=ref`` on the same params.  Each run prints TTFT, aggregate
   tok/s, captures, launches and peak memory; then one decode step with
   all 4 slots is timed as a graph replay and eagerly (host clock,
   synchronized, median of 20, in turns) and traced once each with
   ``torch.profiler`` (device busy share, kernels).  ``flash_attention``
   must have launched in this phase, and in round 2.
7. decode_attn plan — plans ``make_decode_program()`` (a real Step 4
   measuring ``decode_attn=hopper``, then a cache hit);
   ``decode_attention`` must have launched in this phase.
8. serve falcon-mamba-7b — as phase 6 for the Mamba-1 SSM family: plans
   ``make_lm_program("falcon-mamba-7b")``, builds the full model (64
   layers, d_inner 8,192, N=16) and serves the same 3 requests in the same
   way with ``ssm_scan=hopper``; ``ssm_scan`` must have launched in this phase
   (and in round 2) and the prefill logits under hopper must agree with
   ``ssm_scan=ref``.
9. serve recurrentgemma-2b — the same, over all 6 requests, for the
   RG-LRU / local-attention hybrid (26 layers = 8 units of (RG-LRU, RG-LRU, local attention) + a
   2-layer tail; window 2,048, 10 query heads over 1 kv head of width
   256) with ``rglru_scan=hopper`` and ``attn_core=hopper``; ``rglru_scan``
   and ``flash_attention`` must have launched in this phase (and in round
   2).
10. extract — the slice-4 main path, static extraction: the recognizer
   accuracy table of ``repro_torch.launch.loop_extraction`` over the three
   archs captured at full width and full depth on fake tensors (no
   memory), then an unannotated full-width Mistral-NeMo-12B (40 layers,
   random weights from a seeded generator on the card): its all-ref
   forward at a [1, 512] prompt is captured, recognized, legalized and
   stitched by ``discover()``, planned (staged, d=4, temporary plan cache;
   a pattern with ``rmsnorm=hopper`` must be measured, and the re-plan
   must be a cache hit), and run with ``rmsnorm=hopper`` over the selected
   pattern; its logits are held against the captured program's, and
   ``rmsnorm`` must have launched (81 times per forward).
11. strategies — the slice-8 main path, the rest of Step 4: tdFIR (HPEC
   set 1) and MRI-Q (as phase 4) planned under staged, genetic, surrogate
   and exhaustive at d=4, with ``verify_workers`` 1 and then 4, each on a
   fresh plan cache (the staged plans' compile steps build the app's
   kernel with ``nvcc`` into a fresh directory, so they show a real
   compile; ``REPRO_TORCH_BUILD_DIR`` names the directory; one timed rep a
   pattern).  The workers=4 plan runs every pattern on the card as well,
   but is told the workers=1 plan's medians for the patterns both measure:
   the apps' loop-faithful refs are host-bound and vary 10-40% between
   runs, so two independent searches can part at a near-tie, and the
   executor's contract is the same sequence for the same measurements.  So
   the same-sequence check shows that the pipelined executor does not
   change what the strategy sees; what the card shows is that the
   workers=4 plan's own medians are those of the same work: each within
   ``WORKERS_MEDIAN_FACTOR`` of the workers=1 median.  No pattern may be
   measured twice, workers 1 and 4 must measure the same sequence and
   select the same pattern, the surrogate
   must spend fewer real measurements than the GA, a repeat plan against
   the warm cache must spend none, and ``fir_filter_bank`` and
   ``mriq_compute_q`` must launch.  Prints per app and strategy the
   measurements spent, the selected pattern, its median and the compile
   seconds, serial and pipelined.
12. faults — tdFIR wrapped with four injected faults (a compile-step hang
   under ``compile_timeout_s``, a transient exception that is retried, a
   NaN at run on the runner-up ``fir_bank=offload``, which is quarantined,
   and a slow rep, which is MAD-rejected), planned exhaustively at d=8: the
   selected pattern must equal the fault-free plan's, the strike must be
   in the plan cache under the measurement key, and a second search must
   skip the struck gene.
13. replan — full-width recurrentgemma-2b (4 slots, ctx 2,080, random
   weights from a seed) served from the all-ref plan under scripted drift
   (prompts of bucket 128, then of bucket 2,048 at twice the arrival
   rate) with a drift-triggered replanner (``make_replan_fn``): the
   search, ``prepare_plan`` (graphs captured on the worker's side stream)
   and the canary run on the replanner's thread while the engine ticks,
   and the swap lands between ticks.  No request may be dropped; every
   stream must equal a never-swapped twin's under the canary rule (the
   twin on the old plan for requests admitted before the swap, one on the
   new plan after it); ``flash_attention`` and ``rglru_scan`` must launch
   after the swap.  Then a generation captured through a device-side NaN
   fault is armed and offered: it must be rolled back within its tick with
   no request lost, ``rollbacks`` 1 and ``degraded`` in ``stats()`` (and 0
   and false just before it).  Prints the memory allocated and its peak
   before the swap, after it and after the rollback.
   Prints the swap tick's time against the median tick and the decode
   tok/s before and after the swap.
14. serve mixtral-8x7b — the slice-9 main path, Mixture-of-Experts: plans
   ``make_lm_program("mixtral-8x7b")`` (regions ``attn_core`` and
   ``moe_dispatch``), builds Mixtral-8x7B at full width (d_model 4,096,
   32/8 heads x 128, 8 experts top-2 of d_ff 14,336, vocab 32,000) with 16
   of its 32 layers (the 32 take ~87 GiB in bf16, more than the card) and
   serves the 3 requests of phase 6 as phase 6 does, with
   ``attn_core=hopper`` over the planned pattern (the expert-choice
   ``moe_ffn=offload`` default underneath); ``flash_attention`` must
   launch.  Expert choice turns a one-ulp difference into another pick at
   an expert's capacity boundary, so the prefill is held by the rule of
   ``models/moe_check.py`` instead of the logits alone, on the six draws
   of its seed rule (``DRAWS``: 2,060 / 300 / 9 tokens from seeds 100-105):
   hopper on ref's own attention inputs (2e-2); the logits with every
   expert-choice layer on ref's picks within max(3 x floor, 0.05), the
   floor being offload and attention in 2 x 2 chunks on the same picks;
   routing freely, the logits within the same rule where no pick flips,
   else the router's logits at the first layer that flips within 3x the
   floors' at that layer.  Each draw's flips per layer are printed.  Then
   one full-width
   layer's routed block at 2,048 tokens (capacity 640, expert 0 favoured
   so that tokens drop): ``moe_dispatch`` offload against ref, within
   ``MOE_TOL``.  Then the unannotated reduced
   model is discovered (``moe_dispatch`` must be found), planned, and run
   with ``rmsnorm=hopper``, its logits held against the captured
   program's; ``rmsnorm`` must launch.
15. serve whisper-small — the slice-10 main path, the audio frontend:
   plans ``make_lm_program("whisper-small")`` (regions ``attn_core``,
   ``mlp_gelu``, ``conv_stem``; a pattern with ``attn_core=hopper`` must
   fail, its cross-attention having s != sk, and must not be selected),
   builds the model at full width and depth (12 + 12 layers, d_model 768,
   12 heads of 64, vocab 51,865, a two-layer conv stem over 3,000 mel
   frames of 80 bins) and serves 3 greedy requests (prompts 5 / 60 / 200,
   buckets 8 / 64 / 256, each with its own frames; 4 slots at ctx 512) as
   phase 6 does, over the planned pattern (the encoder runs inside each
   prefill graph).  Then ``lm.encode`` at full width under
   ``attn_core=hopper`` against ref: 12 bidirectional ``flash_attention``
   launches; and a reduced whisper prefill under ``attn_core=hopper`` must
   raise the wrapper's s != sk error with no plain version run.
16. serve paligemma-3b — the slice-10 main path, the SigLIP-stub prefix:
   plans ``make_lm_program("paligemma-3b")``, builds it at full width and
   depth (18 layers, d_model 2,048, 8/1 heads of 256, d_ff 16,384, vocab
   257,216) and serves 3 requests (prompts 9 / 300 / 1,500, each behind
   its 256 patch embeddings: buckets 16 / 512 / 1,824 under the cap ctx -
   256, attention over 272 / 768 / 2,080 positions; 4 slots at ctx 2,080)
   as phase 6 does, with ``attn_core=hopper`` over the planned pattern;
   ``flash_attention`` must launch.
17. launchers — the slice-11 entry points, each through its ``main``
   with small budgets and reps on a temporary plan cache: ``quickstart``
   (twice: the second run is a cache hit), ``offload_fir`` and
   ``offload_mriq`` (their hopper kernels held against ``fir_ref`` /
   ``mriq_ref``), ``offload_transformer``, ``serve_lm`` at full width on
   recurrentgemma-2b, and ``launch.run`` over the conditions and kernels
   sections with ``--json`` into a temporary directory; every ``hopper``
   row of ``kernel_bench`` must have launched its kernel; the documents
   are read back, and ``trend`` runs over them with no baseline and
   against themselves (both exit 0).  Its launches join the kernels line.
18. train — the slice-12 main path, one-card training: full-width
   recurrentgemma-2b (26 layers, d_model 2,560, vocab 256,000; bf16
   params and grads, float32 moments, 32 GB) drawn from a seeded
   generator on the card, under ``default_impl`` and the train preset
   of ``parallelism_for`` (remat "dots", microbatch 1), takes 8 steps of
   batch 2 x 2,048 from ``SyntheticLM`` at a constant lr of 3e-4 (at
   tests/test_system.py's 1e-2 the full-width loss diverges after step
   3): the loss must be finite at every step and fall;
   then one more step from one state (kept on the host and copied back)
   under "dots" and under "full": the losses must be equal bit for bit,
   the grad norms within 1e-3 relative; each prints its peak memory.
   Then whisper-small at full width and depth (with its frames) takes 10
   steps of ``run_training`` with a checkpoint every 5 into a temporary
   directory, and a second ``run_training`` to 15 must restore step 10
   and run only the last 5; then ``train_lm``'s ~100M model runs 60
   steps and its loss must fall.  No kernel may launch (the train step
   takes the ref/offload variants; a hopper entry point refuses inputs
   that require grad).
19. int8 decode — the slice-12 serving path, int8 weight-only decode:
   Mixtral-8x7B at full width with 8 of its 32 layers (23.7 GB bf16 +
   11.9 GB int8 + the dequantized tree), 4 greedy decode steps from one
   bf16 prefill of 4 x 2,048 tokens through ``make_serve_step``,
   ``make_quantized_serve_step`` and ``make_serve_step`` on the
   dequantized tree, each fed the bf16 step's tokens: the int8 step must
   equal the dequantized one bit for bit and lie within cosine 0.99 of
   bf16 per slot (tests/test_quantize.py's cosine); the argmax agreement,
   bf16's top-two margins and the int8 logit error are printed (on random
   weights the top two lie within the int8 error); then all 32 layers in
   int8 alone (46.7 GB, drawn and quantized one layer slice at a time),
   4 slots at ctx 2,080, a prefill and 16 greedy decode steps: the
   step's host-clock time, its device time (``torch.profiler``) and its
   int8 weight-streaming bound (every int8 byte with the scales, and the
   cache, once, at 3.35 TB/s), and the peak memory.
20. mesh — the slice-13 path, on a world of 1 over NCCL and a 1x1
   ``DeviceMesh``: (a) phase 18's model, seed, batch, preset and lr
   through ``run_training(..., mesh, ...)`` for 3 steps: its losses and
   grad norms must equal phase 18's first 3 bit for bit; the step time
   and peak memory are printed beside phase 18's; (b) recurrentgemma-2b
   at full width serves a [4, 2,048] prefill and 8 greedy decode steps
   through ``prefill_shardings`` / ``serve_shardings`` with
   ``attn_core`` and ``rglru_scan`` on hopper: the logits must equal the
   same steps without the mesh bit for bit, and flash_attention and
   rglru_scan must launch; (c) the dry-run (``launch/dryrun.py``) of
   qwen2-72b decode_32k on the 16x16 mesh and arctic-480b decode_32k on
   2x16x16, on fake devices on the host, one process each at once (a
   time limit each): status ok; per-device GB, flops, collective bytes,
   the ops the context gathered and the wall time are printed; (d) beside
   c, on the host with no card visible: ``launch.train`` on reduced
   qwen2-72b for 5 steps under ``torch.distributed.run`` on a 2x2 mesh
   of 4 gloo ranks, and the same steps on 1x1, each with a time limit:
   the 2x2 step-0 and final losses within 2e-2 of the 1x1 ones (the CPU
   tests' tolerance) and falling, which runs the embedding's backward on
   a DTensor table under this machine's torch.
21. timing twins — the slice-14 sections of ``launch.run``
   (``verification``, ``autotune``, ``faults``), each with ``--json`` into
   ``chiprun_out/``: the twins' hard assertions (the same measured
   sequences and counts, the tuned space larger than the fixed, the hot
   re-plan measuring nothing, the storm's quarantine and winner, one
   rollback with no request dropped), the timing claims by rule P
   (``launch/paired.py``); each row is printed with ``decided_by`` (and
   ``paired_ratio`` where the paired re-time ran).  The faults section
   serves full-width Mistral-NeMo-12B in bf16 on 2 slots;
   ``fir_filter_bank`` and ``decode_attention`` must launch (the
   autotune plans' ``hopper`` patterns).

Phases 6, 8, 9, 14, 15 and 16 print the decode step's device time beside
its weight-streaming bound: every weight the step reads and the whole
cache, once, at 3.35 TB/s (an untied embedding table gives 4 rows and is
left out, a tied one is read whole as the unembedding; a frontend's
projection, stem and encoder run at prefill only; an MoE step reads every
expert).

Every launch counter is set to 0 just before the path it belongs to runs
and read just after it; the comparisons of phase 3 do not count.  A graph
replay adds to each counter the launches its capture recorded
(``serving/graphs.py``), so the counts stay kernel executions.

The card's name and power limit come two lines before the last, the JSON
object listing every ported kernel on the line before the last, and the
last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import signal
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# the script runs as ``python3 chip_smoke.py`` from the root of a checkout,
# with no PYTHONPATH; outside a checkout the import below fails
sys.path.insert(0, str(ROOT / "src"))  # sys-path: run alone, see above
# the published H100 SXM peaks at the full 700 W limit, from the port's one
# module of the card's figures
from repro_torch.launch.constants import (  # noqa: E402
    HBM_BW as HBM_BYTES_PER_S, PEAK_FLOPS_BF16 as BF16_FLOPS_PER_S,
    PEAK_FLOPS_FP32 as FP32_FLOPS_PER_S, SFU_RATE as SFU_OPS_PER_S)

ARCH = "mistral-nemo-12b"
SSM_ARCH = "falcon-mamba-7b"
HYBRID_ARCH = "recurrentgemma-2b"
# phase 14: Mixtral-8x7B at full width keeps 16 of its 32 layers (the 32
# take ~87 GiB in bf16, more than the card holds); its routed block is held
# ref against offload at a prefill of 2,048 tokens (capacity 640)
MOE_ARCH = "mixtral-8x7b"
MOE_LAYERS = 16
MOE_TOKENS = 2048
# moe_dispatch offload against ref: the same token-choice routing, the
# combine rounded to bf16 in another place (a float32 sum of the k gated
# outputs against bf16 products summed): the bf16 tolerance of
# tests/test_kernels.py, on outputs of unit scale
MOE_TOL = 2e-2
SERVE_PROMPTS = (2060, 2048, 1000, 300, 100, 9)   # buckets 2080 ... 16
SERVE_BUCKETS = (2080, 2048, 1024, 512, 128, 16)
# phases 6 and 8 serve three of the six prompts (buckets 2,080, 512 and 16;
# the whole script has to fit the time it had before phases 11-13 came);
# phase 9 serves all six
SHORT_MIX = (0, 3, 5)
SERVE_CTX = 2080
SERVE_SLOTS = 4
SERVE_NEW_TOKENS = 16
# the kernel each hopper region of phases 6, 8 and 9 launches
REGION_KERNEL = {"attn_core": "flash_attention", "ssm_scan": "ssm_scan",
                 "rglru_scan": "rglru_scan"}
# prefill logits of the hopper variants against ref on the same params.
# The two attention paths differ only in where they round to bf16 (p
# against a 64-key tile's running max or a 1,024-key chunk's; o to bf16),
# about one bf16 ulp of the unit-scale attention output per layer, and the
# init's oversized output projections (std 1/sqrt(layers)) carry that
# noise through all the layers to the float32 logits.  The scans differ in
# where they round too: ref carries the selective scan's state in bf16 and
# runs the recurrence as an associative scan, hopper carries float32 state
# step by step.  So the tolerance is relative to the same noise measured in
# this run, between two plain versions, offload (larger chunks, float32)
# against ref: at most LOGIT_NOISE_FACTOR (3x) it, and never below
# LOGIT_TOL_MIN (0.05), the constants of models/moe_check.py, whose MoE
# rule applies the same bound.  A wrong mask, head, tile or time step
# moves the logits by O(1).
EXTRACT_PROMPT = 512     # phase 10: one query and one key chunk per layer
# phase 15: whisper-small at full width and depth, 4 slots at ctx 512; its
# encoder attends over 1,500 positions in 12 heads of width 64
WHISPER_ARCH = "whisper-small"
WHISPER_CTX = 512
WHISPER_PROMPTS = (5, 60, 200)
WHISPER_BUCKETS = (8, 64, 256)
WHISPER_HEADS, WHISPER_ENC_SEQ, WHISPER_HEAD_DIM = 12, 1500, 64
# phase 16: paligemma-3b at full width and depth, 4 slots at ctx 2,080;
# each prompt behind its 256 patch embeddings, the bucket capped at
# ctx - 256 = 1,824, so attention runs over 256 + bucket positions
PALI_ARCH = "paligemma-3b"
PALI_PROMPTS = (9, 300, 1500)
PALI_BUCKETS = (16, 512, 1824)
PALI_SEQS = tuple(256 + b for b in PALI_BUCKETS)
# phase 13's scripted drift: ticks of bucket-128 prompts, then of two
# bucket-2,048 prompts a tick; long-prompt traffic goes on (at most this
# many ticks) until the replanner's swap has landed
REPLAN_SHORT = (65, 120)       # prompt lengths: bucket 128
REPLAN_LONG = (1100, 2000)     # bucket 2,048
REPLAN_SHORT_TICKS = 20
REPLAN_LONG_TICKS = 8
REPLAN_MAX_EXTRA = 64          # long prompts submitted while the swap is due
REPLAN_MAX_WAIT_S = 240.0
# phase 11: the workers=4 plan's own median of a pattern against the
# workers=1 plan's, one rep each: within this factor either way (the refs
# are host-bound; sub-millisecond patterns differed up to 2.8x over four
# earlier runs on the H100).  A pipelined executor that timed other work
# (a compile inside a rep, an empty call) is off by far more.
WORKERS_MEDIAN_FACTOR = 5.0
# the first versions of the attention kernels (scalar FP32 FMAs over float32
# tiles; one decode block per (b, kv head)) at phase 3's timed shapes, from
# an earlier run on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md)
FLASH_FIRST_MS = {"serve S=2048": 1.5621, "hybrid S=2048": 1.1555}
DECODE_FIRST_MS = 0.2099
# the first version of rglru_scan (one thread per channel walking time) at
# [1, 2,080, 2,560] bf16, an eager wrapper call; of fir_filter_bank (one
# output per thread at a time) at HPEC set 1, a CUDA-graph replay of
# C-entry launches (PERF.md)
RGLRU_FIRST_MS = 0.1191
FIR_FIRST_MS = 0.0148
# phase 17: quickstart's image side (its hist ref walks every pixel) and
# the timing reps of the launchers' plans
QUICKSTART_SIZE = 64
LAUNCHER_REPS = 3
# phase 18: full-width recurrentgemma-2b trained on the card at batch 2 x
# 2,048 tokens under the train preset (dots remat, microbatch 1), then one
# step from the same state under each of "dots" and "full"; whisper-small's
# restart from a checkpoint (batch 4 x 448 text tokens, each with its 3,000
# mel frames); train_lm's ~100M model.  The lr is constant at 3e-4, the
# peak of the JAX train step's default schedule: at the 1e-2 that the
# reduced models of tests/test_system.py take, AdamW moves each weight of
# the full-width model by about half its init scale (std 1/sqrt(2,560)) a
# step, and its loss fell from 12.45 to 6.46 in 3 steps and rose to 18.9
# by step 8 (PERF.md, PR 23)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 2, 2048, 8, 3e-4
GRAD_NORM_RTOL = 1e-3          # "full" against "dots", the same state
WHISPER_TRAIN = (4, 448)
WHISPER_STEPS, WHISPER_RESTART = 10, 15
TRAIN_LM_STEPS = 60
# phase 19: Mixtral-8x7B in int8: 8 of its 32 layers beside their bf16
# tree and its dequantized copy (~23 + 12 + 23 GB), greedy decode steps
# from one bf16 prefill through the bf16 step, the int8 step and the bf16
# step on the dequantized tree, all fed the bf16 step's tokens: the int8
# step must equal the dequantized one bit for bit and come within cosine
# 0.99 of bf16 per slot (tests/test_quantize.py's cosine).  Its argmax
# check is printed, not held: on random full-width weights the decode
# logits' top two lie within the int8 error (the first card run flipped
# one slot of four at cosine 0.9973; PERF.md, PR 23).  Then all 32 layers
# in int8 alone (~47 GB), 4 slots at ctx 2,080, 16 greedy decode steps
QUANT_LAYERS = 8
QUANT_PROMPT = 2048
QUANT_CHECK_STEPS = 4
QUANT_DECODE_STEPS = 16
QUANT_MIN_COSINE = 0.99
# phase 20: the mesh path on a world of 1 over NCCL (a 1x1 DeviceMesh).
# a: phase 18's model, seed, batch, preset and lr through run_training on
# the mesh for MESH_TRAIN_STEPS steps: its losses and grad norms must
# equal phase 18's first steps bit for bit (the CPU tests show the 1x1
# mesh bit for bit against no mesh).  b: recurrentgemma-2b prefill of
# [MESH_SLOTS, MESH_PROMPT] and MESH_DECODE_STEPS greedy decode steps
# through prefill_shardings / serve_shardings with attn_core and
# rglru_scan on hopper, equal to the same steps without the mesh.  c: the
# dry-run of two full-width cells on fake devices, on the host, in two
# processes at once, each with a time limit.  qwen2-72b's train_4k cell
# ran past 75 s on the card's host (PERF.md, PR 24), so its decode_32k
# cell stands in for it
MESH_TRAIN_STEPS = 3
MESH_SLOTS, MESH_PROMPT, MESH_DECODE_STEPS = 4, 2048, 8
MESH_DRYRUN_CELLS = (("qwen2-72b", "decode_32k", "single"),
                     ("arctic-480b", "decode_32k", "multi"))
MESH_CELL_S = 150
# phase 20 d: reduced qwen2-72b trained by the launcher on a 2x2 mesh of
# 4 gloo ranks on the host and on 1x1; the 2x2 losses within MESH_TOL of
# the 1x1 losses (tests/test_torch_parallel.py's tolerance), and falling
MESH22_TRAIN = ["--arch", "qwen2-72b", "--reduced", "--device", "cpu",
                "--steps", "5", "--batch", "8", "--seq", "32"]
MESH22_S = 240
MESH_TOL = 2e-2
# phase 21: the timing twins through launch.run on the card; the faults
# section serves Mistral-NeMo-12B at full width (2 slots)
TWIN_SECTIONS = ("verification", "autotune", "faults")


_START = time.perf_counter()


def phase(name: str) -> None:
    print(f"\n== {name} == ({time.perf_counter() - _START:.1f} s into the "
          "script)", flush=True)


def cuda_ms(torch, fn, calls: int, groups: int = 7) -> tuple[float, str]:
    """Median over ``groups`` of the mean CUDA-event time of ``calls``
    back-to-back calls, after one untimed group of warm-up calls; and the
    range of the group means, as text."""
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(groups):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times), f"[{min(times):.4f}-{max(times):.4f}]"


def graph_ms(torch, make, calls: int, groups: int = 7) -> tuple[float, str]:
    """Median over ``groups`` replays of a CUDA graph of ``calls`` launches
    made by ``make(stream)()`` on its capture stream, per launch, and the
    range; the host's enqueue cost is out of the timing (a launch from the
    host costs more than these kernels take at the small shapes)."""
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        fn = make(stream.cuda_stream)
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream, capture_error_mode="relaxed"):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(groups):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del graph
    return statistics.median(times), f"[{min(times):.4f}-{max(times):.4f}]"


def replays_agree(torch, make, ins, outs, cases, what: str) -> None:
    """Capture one launch ``make(stream)()`` in a CUDA graph and replay it
    once per case ``(inputs, want)``: the inputs are copied into ``ins``
    and the outputs ``outs`` set to NaN first, and each replay must write
    that case's ``want`` bit for bit.  Cases that alternate their inputs
    show any state one launch leaves for the next (a status word that is
    not cleared lets a block read the previous replay's values)."""
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        fn = make(stream.cuda_stream)
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream, capture_error_mode="relaxed"):
        fn()
    for i, (inputs, want) in enumerate(cases):
        for dst, src in zip(ins, inputs):
            dst.copy_(src)
        for o in outs:
            o.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        if not all(torch.equal(o, w) for o, w in zip(outs, want)):
            raise AssertionError(f"{what}: graph replay {i + 1} differs")
    del graph


def profile_step(torch, fn, step_ms: float) -> tuple[str, float | None]:
    """One call of ``fn`` (then a synchronize) under ``torch.profiler``:
    the device time (kernels, copies, memsets) as a share of the traced
    span (first host event to last device event; the tracer slows the
    step) and of ``step_ms``, the step's untraced host-clock time; the
    kernels it ran, and the four names that took the most device time.
    Returns that text and the device time in ms ("not measured" and None
    when the trace holds no device event)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = list(prof.events())
    on_device = [e for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA]
    if not on_device:
        return "not measured (no device events in the trace)", None
    busy = sum(e.time_range.elapsed_us() for e in on_device)
    span = (max(e.time_range.end for e in events)
            - min(e.time_range.start for e in events))
    kernels = [e for e in on_device
               if not e.name.startswith(("Memcpy", "Memset"))]
    by_name: dict = {}
    for e in on_device:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    return (f"{busy / 1e3:.3f} ms on the device = {busy / span:.1%} of the "
            f"traced {span / 1e3:.3f} ms and {busy / 1e3 / step_ms:.1%} of "
            f"the untraced step; {len(kernels)} kernels; top: "
            + "; ".join(f"{n[:60]} {t / 1e3:.3f} ms" for n, t in top),
            busy / 1e3)


def clocks() -> str:
    """The card's SM clock, its maximum, power draw and temperature now."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
         "temperature.gpu", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True).stdout.strip()


def max_abs_err(torch, got, want) -> float:
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    return max(float((g - w).abs().max()) for g, w in zip(got, want))


def assert_close(torch, got, want, what: str, *, rtol: float,
                 atol: float) -> None:
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    for g, w in zip(got, want):
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{what}: non-finite output")
        torch.testing.assert_close(
            g, w, rtol=rtol, atol=atol,
            msg=lambda m: f"{what} (rtol={rtol}, atol={atol}, max_abs_err="
                          f"{float((g - w).abs().max()):.3e}): {m}")


def fir_bound_ms(m: int, n: int, k: int) -> tuple[float, str]:
    """Least time for y = causal FIR of x [m, n] with h [m, k] (complex64):
    each input read once and the output written once, against the complex
    MACs these shapes need (causal: sample i has min(i + 1, k) taps)."""
    macs = m * sum(min(i + 1, k) for i in range(n))
    t_ops = 8.0 * macs / FP32_FLOPS_PER_S
    t_bytes = 8.0 * (2 * m * n + m * k) / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def mriq_bound_ms(num_x: int, num_k: int) -> tuple[float, str]:
    """Least time for computeQ: 7 float32 inputs read once, 2 outputs
    written once; per (voxel, sample) pair 10 FP32 flops (phase: 3 mul,
    2 add, 1 scale; two multiply-adds) and 2 transcendentals on the SFUs."""
    pairs = num_x * num_k
    t_ops = max(10.0 * pairs / FP32_FLOPS_PER_S, 2.0 * pairs / SFU_OPS_PER_S)
    t_bytes = 4.0 * (5 * num_x + 4 * num_k) / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def attention_pairs(s: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask admits in one head of S x S attention."""
    n = 0
    for i in range(s):
        hi = i + 1 if causal else s
        lo = max(0, i - window + 1) if window else 0
        n += max(hi - lo, 0)
    return n


def flash_bound_ms(b, hq, hkv, s, d, elem, causal, window,
                   flops_per_s) -> tuple[float, str]:
    """Least time for prefill attention: q, k, v read once and o written
    once; per admitted (query, key) pair 4*D flops (QK^T and P.V) at the
    input type's peak and one exp on the SFUs."""
    pairs = b * hq * attention_pairs(s, causal, window)
    t_ops = max(4.0 * d * pairs / flops_per_s, pairs / SFU_OPS_PER_S)
    t_bytes = elem * (2 * b * hq * s * d + 2 * b * hkv * s * d) / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def decode_bound_ms(b, hq, hkv, s, d, elem, flops_per_s) -> tuple[float, str]:
    """Least time for decode attention with every slot valid: the cache's k
    and v, q, slot_pos and cur_pos read once, o written once; 4*D flops
    and one exp per (head, slot)."""
    pairs = b * hq * s
    t_ops = max(4.0 * d * pairs / flops_per_s, pairs / SFU_OPS_PER_S)
    t_bytes = (elem * (2 * b * hkv * s * d + 2 * b * hq * d)
               + 4 * (b * s + b)) / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def ssm_bound_ms(b, s, d, n, elem) -> tuple[float, str]:
    """Least time for the selective scan: a and bx [B,S,D,N] and c [B,S,N]
    read once in their type, h0 read and h_final written once (float32),
    y [B,S,D] written once; two FMAs (4 FP32 flops) per element of a."""
    t_ops = 4.0 * b * s * d * n / FP32_FLOPS_PER_S
    t_bytes = (elem * (2 * b * s * d * n + b * s * n + b * s * d)
               + 4 * 2 * b * d * n) / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def rglru_bound_ms(b, s, d, elem) -> tuple[float, str]:
    """Least time for the linear recurrence: a and b [B,S,D] read once,
    h_all written once in their type, h0 and h_final once in float32; one
    FMA (2 flops) per element."""
    t_ops = 2.0 * b * s * d / FP32_FLOPS_PER_S
    t_bytes = (elem * 3 * b * s * d + 4 * 2 * b * d) / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def rmsnorm_bound_ms(rows, d, elem, w_elem) -> tuple[float, str]:
    """Least time for RMSNorm: x read once and out written once in x's
    type, w read once; per element 4 FP32 flops (square-add, two scalings)
    and per row one rsqrt on the SFUs."""
    t_ops = max(4.0 * rows * d / FP32_FLOPS_PER_S, rows / SFU_OPS_PER_S)
    t_bytes = (2 * elem * rows * d + w_elem * d) / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def ptxas_entries(report: str) -> list[tuple[str, int, int, int, int]]:
    """(entry function, registers, stack-frame bytes, spill-store bytes,
    spill-load bytes) of each kernel in a ``ptxas -v`` report."""
    out, name, frame = [], None, (0, 0, 0)
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            frame = tuple(int(x) for x in m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append((name, int(m.group(1)), *frame))
            name, frame = None, (0, 0, 0)
    return out


def sass_counts(library: Path, kernel: str, opcodes: tuple[str, ...]):
    """{entry function: {opcode: count}} over the functions of ``library``
    whose name contains ``kernel``, from ``cuobjdump -sass``; None when the
    toolkit has no cuobjdump."""
    from repro_torch.kernels import _build
    tool = Path(_build._nvcc()).parent / "cuobjdump"
    if not tool.exists():
        return None
    sass = subprocess.run([str(tool), "-sass", str(library)],
                          capture_output=True, text=True, check=True).stdout
    counts = {}
    for part in sass.split("Function : ")[1:]:
        name = part.split(None, 1)[0]
        if kernel in name:
            counts[name] = {op: len(re.findall(rf"\b{op}\b", part))
                            for op in opcodes}
    return counts


def held(fn, args, tensors):
    """``fn(*args)`` as a closure that also holds ``tensors``, whose device
    pointers ``args`` carry, so that their memory outlives the timing."""
    def launch():
        return fn(*args), tensors
    return launch


def flash_instance(name: str) -> str:
    """'D x block_q x block_k' of a mangled flash_wgmma_kernel name."""
    m = re.search(r"flash_wgmma_kernelILi(\d+)ELi(\d+)ELi(\d+)E", name)
    return "x".join(m.groups()) if m else name


def main() -> int:
    import numpy as np
    import torch

    # ---- 1. device ------------------------------------------------------
    phase("1. device")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    from repro_torch.apps import mriq as mriq_app
    from repro_torch.apps import tdfir as tdfir_app
    from repro_torch.configs.paper_apps import MRIQ_BENCH, MRIQ_FULL, TDFIR_FULL
    from repro_torch.core.plan_cache import PlanCache
    from repro_torch.core.planner import AutoOffloader, PlannerConfig
    from repro_torch.core.regions import (Impl, register_variant,
                                          tuning_space, unregister_variant,
                                          variants)
    from repro_torch.core.resources import precompile
    from repro_torch.apps.decode_attn import make_decode_program
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import _build, launch_counters
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import fir, mriq
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import rglru_scan as RS
    from repro_torch.kernels import rmsnorm as RN
    from repro_torch.kernels import ssm_scan as SS
    from repro_torch.kernels.ref import rmsnorm_plain
    from repro_torch.core.extract import discover
    from repro_torch.launch import loop_extraction
    from repro_torch.models import factory as F
    from repro_torch.models import layers as L
    from repro_torch.models import lm
    from repro_torch.models.lm import layer_plan
    from repro_torch.models.moe import moe_capacity, route_tokens
    from repro_torch.models.moe_check import (DRAWS, LOGIT_NOISE_FACTOR,
                                              LOGIT_TOL_MIN, check_moe_prefill)
    from repro_torch.models.offload_program import make_lm_program
    from repro_torch.models.params import tree_leaves
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.graphs import EagerStep
    from repro_torch.core.device import backend_name
    from repro_torch.core.faults import (DeviceNaN, FaultInjector, FaultSpec,
                                         wrap_program)
    from repro_torch.core.plan_cache import measurement_cache_key
    from repro_torch.core import search as search_mod
    from repro_torch.core.search import impl_key
    from repro_torch.launch.serve import make_offloader, make_replan_fn
    from repro_torch.serving.replan import (DriftConfig, DriftDetector,
                                            ReplanConfig, Replanner)

    class EagerTwin(ServeEngine):
        """The engine with its steps called eagerly, not captured: the
        yardstick of phases 6, 8 and 9 (the engine itself has no such
        mode)."""

        def _make_step(self, fn, fixed, feeds, **_):
            return EagerStep(fn, fixed)

    sdpa = torch.nn.functional.scaled_dot_product_attention
    counters = launch_counters()

    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, check=True)
    card = smi.stdout.strip()
    print(card)
    print(f"torch {torch.__version__}  CUDA {torch.version.cuda}  "
          f"device {torch.cuda.get_device_name(dev)}  "
          f"count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch.backends.cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32}  "
          f"torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    # ---- 2. build -------------------------------------------------------
    phase("2. build")
    t0 = time.perf_counter()
    built = _build.build()
    print(f"built {built or 'nothing (up to date)'} in "
          f"{time.perf_counter() - t0:.1f} s into {_build.build_dir()}")
    for name in _build.SOURCES:
        entries = ptxas_entries(_build.ptxas_report(name))
        print(f"-- ptxas {name}.cu: {len(entries)} kernels; registers "
              f"{min(e[1] for e in entries)}-{max(e[1] for e in entries)}; "
              f"stack frame, spill stores, spill loads (bytes) max "
              f"{max(e[2] for e in entries)}, {max(e[3] for e in entries)}, "
              f"{max(e[4] for e in entries)}")
        if "setmaxnreg ignored" in _build.ptxas_report(name):
            print(f"   ptxas: setmaxnreg ignored in {name}.cu")

    # ---- 3. kernels against their plain versions -----------------------
    phase("3. kernels")
    g = torch.Generator().manual_seed(0)

    def cnormal(*shape):
        return torch.complex(torch.randn(shape, generator=g),
                             torch.randn(shape, generator=g)).to(dev)

    def normal(n, scale=1.0):
        return (torch.randn(n, generator=g) * scale).to(dev)

    rows = {}
    stream = torch.cuda.current_stream(dev).cuda_stream

    def c_entry(lib, fn: str, args, outs, want, what: str):
        """Launches of a kernel straight from its C entry point ``fn`` on
        arguments checked and allocated once (``args``: everything before
        the stream; ``outs``: the tensors it writes): ``make(on)`` returns
        one launch on stream ``on``, timed eagerly and as a CUDA graph.
        The first launch must equal the wrapper's result ``want`` bit for
        bit.  These launches are not counted."""
        entry = getattr(lib, fn)

        def make(on):
            return held(entry, (*args, on), outs)

        _build.check(make(stream)()[0], lib, what)
        torch.cuda.synchronize()
        if not all(torch.equal(o, w) for o, w in zip(outs, want)):
            raise AssertionError(f"{what}: direct launch and wrapper differ")
        return make

    tol = 3e-4
    m, n, k = TDFIR_FULL.n_banks, TDFIR_FULL.n_samples, TDFIR_FULL.n_taps
    for label, (mm, nn, kk) in (("full", (m, n, k)), ("clamped", (m, 4000, k))):
        x, h = cnormal(mm, nn), cnormal(mm, kk)
        got = fir.fir_filter_bank(x, h)          # clamped: block_n 512 -> 500
        want = fir.fir_filter_bank_plain(x, h)
        torch.cuda.synchronize()
        assert_close(torch, got, want, f"fir_filter_bank {label}", rtol=tol,
                     atol=tol)
        err = max_abs_err(torch, got, want)
        print(f"fir_filter_bank {label} M={mm} N={nn} K={kk}: "
              f"max_abs_err={err:.3e} (tol rtol=atol={tol})")
        if label == "full":
            xp = torch.nn.functional.pad(x, (kk - 1, 0)).unsqueeze(0)
            hf = h.flip(1).unsqueeze(1)
            lib = torch.nn.functional.conv1d(xp, hf, groups=mm)[0]
            assert_close(torch, lib, want, "grouped complex conv1d", rtol=tol,
                         atol=tol)
            def fir_entry(block_n, tap_unroll, want):
                y = torch.empty_like(x)
                return c_entry(fir._lib(), "fir_filter_bank_launch", (
                    x.data_ptr(), h.data_ptr(), y.data_ptr(), mm, nn, kk,
                    block_n, tap_unroll), (y,), (want,), "fir_filter_bank")

            ms, ms_range = graph_ms(torch, fir_entry(fir.DEFAULT_BLOCK_N, 1,
                                                     got), 200)
            call_ms, call_range = cuda_ms(
                torch, lambda: fir.fir_filter_bank(x, h), 200)
            plain_ms, plain_range = cuda_ms(
                torch, lambda: fir.fir_filter_bank_plain(x, h), 20)
            lib_ms, lib_range = graph_ms(torch, lambda on: lambda: torch.nn
                                         .functional.conv1d(xp, hf, groups=mm),
                                         50)
            bound_ms, bound_by = fir_bound_ms(mm, nn, kk)
            print(f"  kernel {ms:.4f} ms {ms_range} (first version "
                  f"{FIR_FIRST_MS} ms, an earlier run on the same card model;"
                  f" wrapper call {call_ms:.4f} ms {call_range})  plain "
                  f"{plain_ms:.4f} ms {plain_range}  conv1d {lib_ms:.4f} ms "
                  f"{lib_range}  kernel/conv1d {ms / lib_ms:.2f}x  bound "
                  f"{bound_ms * 1e3:.2f} us ({bound_by}, "
                  f"{bound_ms / ms:.1%} of it)")
            print(f"  clocks.sm, clocks.max.sm, power.draw, temperature: "
                  f"{clocks()}")
            # every tile point of the tuning space: against the plain
            # version, timed as a graph replay, its registers and shared
            # memory (static + dynamic) against the Step-3 estimate
            sweep = {}
            for pt in tuning_space("fir_bank", "hopper").points((x, h)):
                bn, tu = pt["block_n"], pt["tap_unroll"]
                at = fir.fir_filter_bank(x, h, block_n=bn, tap_unroll=tu)
                assert_close(torch, at, want, f"fir_filter_bank at {bn}x{tu}",
                             rtol=tol, atol=tol)
                sweep[bn, tu] = graph_ms(torch, fir_entry(bn, tu, at), 200)[0]
                attrs = fir.kernel_attributes(tu)
                smem = attrs["static_smem_bytes"] + fir.kernel_smem_bytes(
                    bn, kk)
                est = precompile("fir_bank", "hopper",
                                 variants("fir_bank")["hopper"], (x, h), pt)
                print(f"  block_n {bn}, tap_unroll {tu}: {sweep[bn, tu]:.4f} "
                      f"ms; cudaFuncGetAttributes {attrs}, dynamic smem "
                      f"{fir.kernel_smem_bytes(bn, kk)} B, "
                      f"{fir.threads(bn)} threads; Step-3 estimate "
                      f"{est.resource_bytes:.0f} B/block")
                if est.resource_bytes != smem:
                    raise AssertionError(f"fir_filter_bank: Step-3 estimate "
                                         f"{est.resource_bytes} B != the "
                                         f"kernel's {smem} B at {bn}x{tu}")
            best = min(sweep, key=sweep.get)
            print(f"  tile points: best {best[0]}x{best[1]} "
                  f"{sweep[best]:.4f} ms; default {fir.DEFAULT_BLOCK_N}x1 "
                  f"{ms:.4f} ms")
            rows["fir_filter_bank"] = {
                "name": "fir_filter_bank", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/fir.cu",
                "replaces": "src/repro/kernels/fir.py:69",
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": lib_ms}

    # Each MRI-Q output is a sum of numK terms phi_j * cos/sin(phase).  A
    # term's own error (float32 phase, __sincosf) is ~1e-6 |phi_j|; the
    # float32 sums of the kernel and of the plain version's matrix product
    # differ by a random walk of ~6e-8 |Q| sqrt(numK) <= 2.7e-6 sum|phi| at
    # numK = 2,048.  So the tolerance is absolute, 1e-5 sum|phi|, with no
    # relative part (|Q| reaches the thousands): a sample dropped or counted
    # twice moves Q by ~|phi_j|, about 1 here, far outside it.
    for label, (nx, nk) in (("full", (MRIQ_FULL.num_x, MRIQ_FULL.num_k)),
                            ("bench", (MRIQ_BENCH.num_x, MRIQ_BENCH.num_k)),
                            ("ragged", (300, 200))):
        args = (normal(nx), normal(nx), normal(nx), normal(nk, 0.1),
                normal(nk, 0.1), normal(nk, 0.1), normal(nk).square())
        tol = 1e-5 * float(args[6].abs().sum())
        got = mriq.mriq_compute_q(*args)
        want = mriq.mriq_compute_q_plain(*args)
        torch.cuda.synchronize()
        assert_close(torch, got, want, f"mriq_compute_q {label}", rtol=0.0,
                     atol=tol)
        err = max_abs_err(torch, got, want)
        print(f"mriq_compute_q {label} numX={nx} numK={nk}: "
              f"max_abs_err={err:.3e} (tol atol=1e-5*sum|phi|={tol:.3e}, "
              f"rtol=0)")
        if label == "full":
            qr, qi = torch.empty_like(args[0]), torch.empty_like(args[0])
            make = c_entry(mriq._lib(), "mriq_compute_q_launch", (
                *(t.data_ptr() for t in args), qr.data_ptr(), qi.data_ptr(),
                nx, nk), (qr, qi), got, "mriq_compute_q")
            ms, ms_range = graph_ms(torch, make, 20)
            call_ms, call_range = cuda_ms(
                torch, lambda: mriq.mriq_compute_q(*args), 20)
            plain_ms, plain_range = cuda_ms(
                torch, lambda: mriq.mriq_compute_q_plain(*args), 3)
            bound_ms, bound_by = mriq_bound_ms(nx, nk)
            print(f"  kernel {ms:.4f} ms {ms_range} (wrapper call "
                  f"{call_ms:.4f} ms {call_range})  plain {plain_ms:.4f} ms "
                  f"{plain_range}  library: none  bound "
                  f"{bound_ms * 1e3:.2f} us ({bound_by}, "
                  f"{bound_ms / ms:.1%} of it)")
            print(f"  clocks.sm, clocks.max.sm, power.draw, temperature: "
                  f"{clocks()}")
            est = precompile("compute_q", "hopper",
                             variants("compute_q")["hopper"], args)
            print(f"  cudaFuncGetAttributes: {mriq.kernel_attributes()}; "
                  f"Step-3 estimate {est.resource_bytes:.0f} B/block")
            rows["mriq_compute_q"] = {
                "name": "mriq_compute_q", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/mriq.cu",
                "replaces": "src/repro/kernels/mriq.py:49",
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": None}
        del args, got, want
    torch.cuda.empty_cache()

    def randn(*shape, dtype):
        return torch.randn(shape, generator=g).to(dev, dtype)

    bf16, f32 = torch.bfloat16, torch.float32
    # bf16 2e-2 and f32 2e-5: the flash tolerances of tests/test_kernels.py
    # (outputs are averages of unit normals; bf16 rounding of p and o)
    tols = {bf16: 2e-2, f32: 2e-5}
    flops_rate = {bf16: BF16_FLOPS_PER_S, f32: FP32_FLOPS_PER_S}

    def flash_direct(q, k, v, window, block_q, block_k, causal=True):
        """The kernel from its C entry point (as ``c_entry``)."""
        o = torch.empty_like(q)
        b, hq, n, d = q.shape
        return c_entry(FA._lib(), "flash_attention_launch", (
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, hq,
            k.shape[1], n, d, block_q, block_k, int(causal), window,
            1.0 / math.sqrt(d), int(q.dtype == bf16)), (o,), (
                FA.flash_attention(q, k, v, causal=causal, window=window,
                                   block_q=block_q, block_k=block_k),),
            "flash_attention")

    flash_cases = [(f"serve S={n}", 1, 32, 8, n, 128, bf16, 0)
                   for n in SERVE_BUCKETS]
    flash_cases += [("serve S=2080 window=512", 1, 32, 8, 2080, 128, bf16, 512),
                    ("serve S=2048 f32", 1, 32, 8, 2048, 128, f32, 0),
                    ("planner (reduced)", 2, 4, 2, 128, 16, bf16, 0),
                    ("planner (reduced) f32", 2, 4, 2, 128, 16, f32, 0),
                    ("ragged f32 window=48", 1, 8, 2, 300, 64, f32, 48)]
    # recurrentgemma's local attention (phase 9): head_dim 256, 10 query
    # heads over 1 kv head, window 2,048, at every bucket; its planner's
    # reduced model; and a ragged float32 case at head_dim 256
    flash_cases += [(f"hybrid S={n}", 1, 10, 1, n, 256, bf16, 2048)
                    for n in SERVE_BUCKETS]
    flash_cases += [("hybrid planner (reduced)", 2, 4, 1, 128, 16, bf16, 32),
                    ("ragged f32 D=256 window=48", 1, 10, 1, 300, 256, f32,
                     48)]
    # paligemma-3b (phase 16): 8 query heads over 1 kv head of width 256,
    # causal over its 256-patch prefix and a bucket (16, 512, 1,824): S no
    # multiple of a tile, ragged tail tiles
    flash_cases += [(f"paligemma S={n}", 1, 8, 1, n, 256, bf16, 0)
                    for n in PALI_SEQS]
    flash256, flash_f32 = {}, {}
    for label, b, hq, hkv, n, d, dt, window in flash_cases:
        q, k, v = randn(b, hq, n, d, dtype=dt), randn(b, hkv, n, d, dtype=dt), \
            randn(b, hkv, n, d, dtype=dt)
        got = FA.flash_attention(q, k, v, causal=True, window=window)
        want = FA.flash_attention_plain(q, k, v, causal=True, window=window)
        torch.cuda.synchronize()
        tol = tols[dt]
        assert_close(torch, got.float(), want.float(), f"flash_attention {label}",
                     rtol=tol, atol=tol)
        err = max_abs_err(torch, got.float(), want.float())
        bq, bk = FA.default_tiles(dt, d)
        line = (f"flash_attention {label} [B={b}, Hq={hq}, Hkv={hkv}, S={n}, "
                f"D={d}] {str(dt).removeprefix('torch.')} causal, tiles {bq}x"
                f"{bk}: max_abs_err={err:.3e} (tol rtol=atol={tol})")
        elem = 2 if dt == bf16 else 4
        bound_ms, bound_by = flash_bound_ms(b, hq, hkv, n, d, elem, True,
                                            window, flops_rate[dt])
        if label.startswith(("serve", "hybrid S=")):
            calls = 10 if dt == bf16 else 3
            make = flash_direct(q, k, v, window, bq, bk)
            ms, ms_range = graph_ms(torch, make, calls)
            eager_ms, _ = cuda_ms(torch, make(stream), calls)
            call_ms, call_range = cuda_ms(torch, lambda: FA.flash_attention(
                q, k, v, causal=True, window=window), calls)
            line += (f"; kernel {ms:.4f} ms {ms_range} (C entry eager "
                     f"{eager_ms:.4f}, wrapper call {call_ms:.4f} ms "
                     f"{call_range}), bound {bound_ms * 1e3:.2f} us "
                     f"({bound_by})")
        print(line)
        if label in ("serve S=2048", "hybrid S=2048", "serve S=2048 f32"):
            # the window (2,048) admits every causal key at S=2,048, so
            # causal SDPA computes the same function in each case
            lib = sdpa(q, k, v, is_causal=True, enable_gqa=True)
            assert_close(torch, lib.float(), want.float(), "SDPA vs plain",
                         rtol=tol, atol=tol)
            plain_ms, plain_range = cuda_ms(torch, lambda: FA.flash_attention_plain(
                q, k, v, causal=True, window=window), 3)
            lib_ms, lib_range = graph_ms(torch, lambda on: lambda: sdpa(
                q, k, v, is_causal=True, enable_gqa=True), 10)
            est = precompile("attn_core", "hopper",
                             variants("attn_core")["hopper"], (q, k, v))
            earlier = FLASH_FIRST_MS.get(label)
            print(f"  kernel {ms:.4f} ms {ms_range}"
                  + (f" (first version {earlier} ms, an earlier run on the "
                     f"same card model)" if earlier else "")
                  + f"  plain {plain_ms:.4f} ms {plain_range}  SDPA "
                  f"{lib_ms:.4f} ms {lib_range}  kernel/SDPA "
                  f"{ms / lib_ms:.2f}x  bound {bound_ms * 1e3:.2f} us "
                  f"({bound_by}, {bound_ms / ms:.1%} of it)")
            print(f"  clocks.sm, clocks.max.sm, power.draw, temperature: "
                  f"{clocks()}")
            print(f"  cudaFuncGetAttributes ({bq}x{bk}, head_dim {d}): "
                  f"{FA.kernel_attributes(bq, bk, d, dt)}; dynamic smem "
                  f"{FA.smem_bytes(bq, bk, d, dt)} B/block, "
                  f"{FA.threads(bq, d, dt)} threads; Step-3 estimate "
                  f"{est.resource_bytes:.0f} B/block")
            if dt == bf16:
                sweep = {(pq, pk): graph_ms(torch, flash_direct(
                    q, k, v, window, pq, pk), 10)[0]
                    for pq in FA.BLOCK_QS for pk in FA.BLOCK_KS
                    if FA.fits(pq, pk, d, dt)}
                best = min(sweep, key=sweep.get)
                print("  bf16 tile points (block_q x block_k: kernel ms): "
                      + ", ".join(f"{pq}x{pk}: {t:.4f}"
                                  for (pq, pk), t in sweep.items())
                      + f"; best {best[0]}x{best[1]}, default {bq}x{bk}")
            found = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": lib_ms}
            if label == "hybrid S=2048":
                flash256 = found
            elif label == "serve S=2048 f32":
                flash_f32 = found
            else:
                rows["flash_attention"] = {
                    "name": "flash_attention", "route": "cuda",
                    "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
                    "replaces": "src/repro/kernels/flash_attention.py:74",
                    **found}
        del q, k, v, got, want
    torch.cuda.empty_cache()

    # row 3w: whisper-small's encoder (phase 15), bidirectional
    # self-attention over its 1,500 positions in 12/12 heads of width 64;
    # S no multiple of a tile.  Timed as graph replays beside SDPA
    b, h, n, d = 1, WHISPER_HEADS, WHISPER_ENC_SEQ, WHISPER_HEAD_DIM
    q, k, v = (randn(b, h, n, d, dtype=bf16) for _ in range(3))
    got = FA.flash_attention(q, k, v, causal=False)
    want = FA.flash_attention_plain(q, k, v, causal=False)
    lib = sdpa(q, k, v)
    torch.cuda.synchronize()
    assert_close(torch, got.float(), want.float(), "flash_attention 3w",
                 rtol=2e-2, atol=2e-2)
    assert_close(torch, lib.float(), want.float(), "SDPA vs plain (3w)",
                 rtol=2e-2, atol=2e-2)
    bq, bk = FA.default_tiles(bf16, d)
    ms, ms_range = graph_ms(torch, flash_direct(q, k, v, 0, bq, bk,
                                                causal=False), 20)
    plain_ms, plain_range = cuda_ms(torch, lambda: FA.flash_attention_plain(
        q, k, v, causal=False), 3)
    lib_ms, lib_range = graph_ms(torch, lambda on: lambda: sdpa(q, k, v), 20)
    bound_ms, bound_by = flash_bound_ms(b, h, h, n, d, 2, False, 0,
                                        BF16_FLOPS_PER_S)
    flash_whisper = {"max_abs_err": max_abs_err(torch, got.float(),
                                                want.float()),
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": lib_ms}
    print(f"flash_attention 3w whisper encoder [B={b}, Hq={h}, Hkv={h}, "
          f"S={n}, D={d}] bf16 bidirectional, tiles {bq}x{bk}: max_abs_err="
          f"{flash_whisper['max_abs_err']:.3e} (tol rtol=atol=2e-2); kernel "
          f"{ms:.4f} ms {ms_range}  plain {plain_ms:.4f} ms {plain_range}  "
          f"SDPA {lib_ms:.4f} ms {lib_range}  kernel/SDPA {ms / lib_ms:.2f}x"
          f"  bound {bound_ms * 1e3:.2f} us ({bound_by}, "
          f"{bound_ms / ms:.1%} of it) [{card}]")
    print(f"  clocks.sm, clocks.max.sm, power.draw, temperature: {clocks()}")
    del q, k, v, got, want, lib
    torch.cuda.empty_cache()

    # row 3p: paligemma-3b's causal attention (phase 16), 8 query heads over
    # 1 kv head of width 256 over its 256-patch prefix and a bucket: S =
    # 272, 768 and 2,080, ragged tail tiles.  Timed as graph replays beside
    # SDPA with enable_gqa and the same causal mask
    flash_pali = {}
    for n in PALI_SEQS:
        b, hq, hkv, d = 1, 8, 1, 256
        q = randn(b, hq, n, d, dtype=bf16)
        k, v = randn(b, hkv, n, d, dtype=bf16), randn(b, hkv, n, d, dtype=bf16)
        got = FA.flash_attention(q, k, v, causal=True)
        want = FA.flash_attention_plain(q, k, v, causal=True)
        lib = sdpa(q, k, v, is_causal=True, enable_gqa=True)
        torch.cuda.synchronize()
        assert_close(torch, got.float(), want.float(),
                     f"flash_attention 3p S={n}", rtol=2e-2, atol=2e-2)
        assert_close(torch, lib.float(), want.float(),
                     f"SDPA vs plain (3p S={n})", rtol=2e-2, atol=2e-2)
        bq, bk = FA.default_tiles(bf16, d)
        ms, ms_range = graph_ms(torch, flash_direct(q, k, v, 0, bq, bk), 10)
        plain_ms, plain_range = cuda_ms(
            torch, lambda: FA.flash_attention_plain(q, k, v, causal=True), 3)
        lib_ms, lib_range = graph_ms(torch, lambda on: lambda: sdpa(
            q, k, v, is_causal=True, enable_gqa=True), 10)
        bound_ms, bound_by = flash_bound_ms(b, hq, hkv, n, d, 2, True, 0,
                                            BF16_FLOPS_PER_S)
        flash_pali[n] = {"max_abs_err": max_abs_err(torch, got.float(),
                                                    want.float()),
                         "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                         "bound_by": bound_by, "library_ms": lib_ms}
        print(f"flash_attention 3p paligemma [B={b}, Hq={hq}, Hkv={hkv}, "
              f"S={n}, D={d}] bf16 causal, tiles {bq}x{bk}: max_abs_err="
              f"{flash_pali[n]['max_abs_err']:.3e} (tol rtol=atol=2e-2); "
              f"kernel {ms:.4f} ms {ms_range}  plain {plain_ms:.4f} ms "
              f"{plain_range}  SDPA {lib_ms:.4f} ms {lib_range}  kernel/SDPA "
              f"{ms / lib_ms:.2f}x  bound {bound_ms * 1e3:.2f} us ({bound_by},"
              f" {bound_ms / ms:.1%} of it) [{card}]")
        del q, k, v, got, want, lib
    print(f"  clocks.sm, clocks.max.sm, power.draw, temperature: {clocks()}")
    torch.cuda.empty_cache()

    # the bf16 instances run on the tensor cores (HGMMA) fed by TMA (UTMALDG)
    wg = [e for e in ptxas_entries(_build.ptxas_report("flash_attention"))
          if "flash_wgmma_kernel" in e[0]]
    print("flash_attention bf16 instances (D x block_q x block_k: registers, "
          "stack frame / spill bytes): " + ", ".join(
              f"{flash_instance(n)}: {r}, {fr}/{st}" for n, r, fr, st, _ in wg))
    counts = sass_counts(_build.library_path("flash_attention"),
                         "flash_wgmma_kernel", ("HGMMA", "UTMALDG"))
    if counts is None:
        print("cuobjdump not found beside nvcc: SASS not counted")
    else:
        print("flash_attention bf16 SASS (HGMMA, UTMALDG): " + ", ".join(
            f"{flash_instance(n)}: {c['HGMMA']}, {c['UTMALDG']}"
            for n, c in counts.items()))
        if len(counts) != len(wg) or any(
                not c["HGMMA"] or not c["UTMALDG"] for c in counts.values()):
            raise AssertionError("flash_attention: a bf16 instance without "
                                 "HGMMA or UTMALDG")

    def decode_direct(q, k, v, sp, cp, window, block_k):
        """The split and combine kernels from their C entry point (as
        ``c_entry``)."""
        b, hq, _, d = q.shape
        hkv, n = k.shape[1], k.shape[2]
        splits, _ = DA.decode_splits(b * hkv, n, block_k)
        o = torch.empty_like(q)
        part = torch.empty(b * hq * splits * (d + 2), dtype=f32, device=dev)
        return c_entry(DA._lib(), "decode_attention_launch", (
            q.data_ptr(), k.data_ptr(), v.data_ptr(), sp.data_ptr(),
            cp.data_ptr(), o.data_ptr(), part.data_ptr(), b, hkv, hq // hkv,
            n, d, block_k, splits, window, 1.0 / math.sqrt(d),
            int(q.dtype == bf16)), (o, part), (DA.decode_attention(
                q, k, v, sp, cp, window=window, block_k=block_k),),
            "decode_attention")

    # decode: bf16 2e-2 as above; f32 5e-6, the decode tolerance of
    # tests/test_kernels.py (float32 throughout, summation order only)
    dtols = {bf16: 2e-2, f32: 5e-6}
    lens = (2076, 2060, 1015, 316)       # valid slots per row when empties
    decode_cases = [("serve, empties", 4, 32, 8, 2080, 128, bf16, 0, True),
                    ("serve, empties, window=512", 4, 32, 8, 2080, 128, bf16,
                     512, True),
                    ("serve, full cache", 4, 32, 8, 2080, 128, bf16, 0, False),
                    ("serve, empties f32", 4, 32, 8, 2080, 128, f32, 0, True),
                    ("decode_attn program (f32)", 2, 8, 2, 512, 64, f32, 0,
                     False)]
    for label, b, hq, hkv, n, d, dt, window, empties in decode_cases:
        q = randn(b, hq, 1, d, dtype=dt)
        k, v = randn(b, hkv, n, d, dtype=dt), randn(b, hkv, n, d, dtype=dt)
        sp = torch.arange(n, dtype=torch.int32, device=dev).repeat(b, 1)
        cp = torch.full((b,), n - 1, dtype=torch.int32, device=dev)
        if empties:
            for i, m in enumerate(lens[:b]):
                sp[i, m:] = -1
                cp[i] = m - 1
        got = DA.decode_attention(q, k, v, sp, cp, window=window)
        want = DA.decode_attention_plain(q, k, v, sp, cp, window=window)
        torch.cuda.synchronize()
        tol = dtols[dt]
        assert_close(torch, got.float(), want.float(),
                     f"decode_attention {label}", rtol=tol, atol=tol)
        err = max_abs_err(torch, got.float(), want.float())
        splits, per = DA.decode_splits(b * hkv, n, DA.DEFAULT_BLOCK_K)
        print(f"decode_attention {label} [B={b}, Hq={hq}, Hkv={hkv}, S={n}, "
              f"D={d}] {str(dt).removeprefix('torch.')}: max_abs_err={err:.3e} "
              f"(tol rtol=atol={tol}); grid ({splits}, {b * hkv}) = "
              f"{splits * b * hkv} blocks, {per} tiles of "
              f"{DA.DEFAULT_BLOCK_K} slots each")
        if label == "serve, full cache":
            lib = sdpa(q, k, v, enable_gqa=True)
            assert_close(torch, lib.float(), want.float(), "SDPA vs plain",
                         rtol=tol, atol=tol)
            if splits * b * hkv < 2 * 132:
                raise AssertionError("decode_attention: fewer than 264 "
                                     "blocks at the serving shape")
            make = decode_direct(q, k, v, sp, cp, 0, DA.DEFAULT_BLOCK_K)
            ms, ms_range = graph_ms(torch, make, 50)
            eager_ms, _ = cuda_ms(torch, make(stream), 100)
            call_ms, call_range = cuda_ms(torch, lambda: DA.decode_attention(
                q, k, v, sp, cp), 100)
            plain_ms, plain_range = cuda_ms(torch, lambda: DA.decode_attention_plain(
                q, k, v, sp, cp), 10)
            lib_ms, lib_range = graph_ms(torch, lambda on: lambda: sdpa(
                q, k, v, enable_gqa=True), 50)
            lib_eager_ms, _ = cuda_ms(torch, lambda: sdpa(
                q, k, v, enable_gqa=True), 100)
            bound_ms, bound_by = decode_bound_ms(b, hq, hkv, n, d, 2,
                                                 flops_rate[dt])
            sweep = {bk: graph_ms(torch, decode_direct(
                q, k, v, sp, cp, 0, bk), 50)[0]
                for bk in DA.BLOCK_KS if DA.fits(hq // hkv, d, bk, dt)}
            print(f"  kernel {ms:.4f} ms {ms_range} (first version "
                  f"{DECODE_FIRST_MS} ms, an earlier run on the same card "
                  f"model; C entry eager {eager_ms:.4f} ms; wrapper call "
                  f"{call_ms:.4f} ms {call_range})  plain {plain_ms:.4f} ms "
                  f"{plain_range}  SDPA {lib_ms:.4f} ms {lib_range} (eager "
                  f"{lib_eager_ms:.4f})  kernel/SDPA {ms / lib_ms:.2f}x  "
                  f"bound {bound_ms * 1e3:.2f} us ({bound_by}, "
                  f"{bound_ms / ms:.1%} of it)")
            print("  block_k (kernel ms, blocks): " + ", ".join(
                f"{bk}: {t:.4f}, {DA.decode_splits(b * hkv, n, bk)[0] * b * hkv}"
                for bk, t in sweep.items())
                + f"; best {min(sweep, key=sweep.get)}, default "
                f"{DA.DEFAULT_BLOCK_K}")
            print(f"  clocks.sm, clocks.max.sm, power.draw, temperature: "
                  f"{clocks()}")
            est = precompile("decode_attn", "hopper",
                             variants("decode_attn")["hopper"],
                             (q, k, v, sp, cp))
            print(f"  cudaFuncGetAttributes (G={hq // hkv}, D={d}): "
                  f"{DA.kernel_attributes(hq // hkv, d, dt)}; dynamic smem "
                  f"{DA.smem_bytes(hq // hkv, d, DA.DEFAULT_BLOCK_K, dt)} "
                  f"B/block, {DA.occupancy(hq // hkv, d, DA.DEFAULT_BLOCK_K, dt)}"
                  f" blocks/SM; Step-3 estimate {est.resource_bytes:.0f} "
                  f"B/block")
            print("  ptxas (kernel: registers, stack frame / spill bytes): "
                  + ", ".join(f"{re.sub(r'_ZN.*?(decode_\w+?_kernel)', r'\1', n)[:50]}"
                              f": {r}, {fr}/{st}"
                              for n, r, fr, st, _ in ptxas_entries(
                                  _build.ptxas_report("decode_attention"))
                              if "combine" in n or "Li4ELi128E" in n))
            rows["decode_attention"] = {
                "name": "decode_attention", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
                "replaces": "src/repro/kernels/decode_attention.py:67",
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": lib_ms}
        del q, k, v, got, want
    torch.cuda.empty_cache()

    # the scans of phases 8 and 9, on inputs drawn on the card (a [1, 2,080,
    # 8,192, 16] normal drawn on the host would take seconds).  Decays in
    # (0.5, 1), the slow end of the model's exp(dt * A).  bf16: kernel and
    # plain version read the same bf16 inputs and carry the same float32
    # state, so they differ in the order of the FMA and of the sum over N,
    # then by the rounding of y (h_all) to bf16, one ulp (2^-8 relative):
    # rtol = atol = 2e-2.  float32, and the float32 final states: 1e-4
    # (ssm) and 1e-5 (rglru), the tolerances of tests/test_kernels.py.
    gd = torch.Generator(device=dev).manual_seed(1)

    def dnormal(*shape, dtype):
        return torch.randn(shape, generator=gd, device=dev).to(dtype)

    def decays(*shape, dtype):
        return (torch.rand(shape, generator=gd, device=dev) * 0.5 + 0.5).to(
            dtype)

    scan_tols = {"ssm_scan": {bf16: 2e-2, f32: 1e-4},
                 "rglru_scan": {bf16: 2e-2, f32: 1e-5}}
    scan_cases = [("ssm_scan", f"serve S={n}", (1, n, 8192, 16), bf16)
                  for n in SERVE_BUCKETS]
    scan_cases += [("ssm_scan", "planner (reduced)", (2, 128, 128, 8), bf16),
                   ("ssm_scan", "off-grain S=9 D=300", (1, 9, 300, 16), bf16),
                   ("ssm_scan", "ragged f32", (2, 300, 300, 16), f32)]
    scan_cases += [("rglru_scan", f"serve S={n}", (1, n, 2560), bf16)
                   for n in SERVE_BUCKETS]
    scan_cases += [("rglru_scan", "planner (reduced)", (2, 128, 64), bf16),
                   ("rglru_scan", "off-grain S=9 D=300", (1, 9, 300), bf16),
                   ("rglru_scan", "ragged f32", (2, 300, 300), f32)]
    # the chunked scan's edges: one chunk short of, at and one step past
    # time_chunk; two batch rows over three groups of chunks; a with exact
    # 0s (the carry cut) and 1s (passed whole); D odd (single bf16 words);
    # the largest chunk count, at the smallest time_chunk, on a 3-D grid
    scan_cases += [("rglru_scan", f"S=time_chunk{o:+d}" if o else
                    "S=time_chunk", (1, RS.DEFAULT_TIME_CHUNK + o, 2560),
                    bf16) for o in (-1, 0, 1)]
    scan_cases += [("rglru_scan", "B=2 over 94 chunks", (2, 3000, 300), bf16),
                   ("rglru_scan", "exact 0s and 1s in a", (2, 3000, 300), f32),
                   ("rglru_scan", "odd D", (1, 2100, 301), bf16),
                   ("rglru_scan", "3-D grid, time_chunk 16", (3, 40000, 300),
                    bf16)]

    def scan_entry(name, args, want, block_c, time_chunk):
        """A scan kernel from its C entry point (as ``c_entry``); returns
        ``make`` and the tensors it writes."""
        outs = tuple(torch.empty_like(t) for t in want)
        ptrs = tuple(t.data_ptr() for t in (*args, *outs))
        bf = int(args[0].dtype == bf16)
        if name == "ssm_scan":
            return c_entry(SS._lib(), "ssm_scan_launch", (
                *ptrs, *args[0].shape, block_c, time_chunk, bf), outs, want,
                name), outs
        work = RS.scratch(args[0], block_c, time_chunk)
        return c_entry(RS._lib(), "rglru_scan_launch", (
            *ptrs, *args[0].shape, block_c, time_chunk, bf, work.data_ptr(),
            work.numel()), (*outs, work), want, name), outs

    def rglru_replays(make, args, outs, got, kw, what):
        """The launch replayed from one graph on a's inputs, then on other
        inputs, then on a's again (``replays_agree``)."""
        other = (decays(*args[0].shape, dtype=args[0].dtype),
                 dnormal(*args[1].shape, dtype=args[1].dtype), args[2])
        want = RS.rglru_scan(*other, **kw)
        saved = tuple(t.clone() for t in args)
        replays_agree(torch, make, args, outs, [
            (saved, got), (other, want), (saved, got)], what)

    for name, label, shape, dt in scan_cases:
        if name == "ssm_scan":
            b, n, d, ns = shape
            args = (decays(*shape, dtype=dt), dnormal(*shape, dtype=dt),
                    dnormal(b, n, ns, dtype=dt), dnormal(b, d, ns, dtype=f32))
            kernel, plain, mod = SS.ssm_scan, SS.ssm_scan_plain, SS
            bound_ms, bound_by = ssm_bound_ms(b, n, d, ns, args[0].element_size())
        else:
            b, n, d = shape
            args = (decays(*shape, dtype=dt), dnormal(*shape, dtype=dt),
                    dnormal(b, d, dtype=f32))
            if label.startswith("exact"):
                args[0].view(-1)[::5] = 0.0
                args[0].view(-1)[2::7] = 1.0
            kernel, plain, mod = RS.rglru_scan, RS.rglru_scan_plain, RS
            bound_ms, bound_by = rglru_bound_ms(b, n, d, args[0].element_size())
        kw = {"time_chunk": 16} if label.endswith("time_chunk 16") else {}
        got, want = kernel(*args, **kw), plain(*args)
        torch.cuda.synchronize()
        tol = scan_tols[name][dt]
        assert_close(torch, got[0].float(), want[0].float(), f"{name} {label}",
                     rtol=tol, atol=tol)
        ftol = scan_tols[name][f32]
        assert_close(torch, got[1], want[1], f"{name} {label} final state",
                     rtol=ftol, atol=ftol)
        err = max_abs_err(torch, got[0].float(), want[0].float())
        line = (f"{name} {label} {list(shape)} {str(dt).removeprefix('torch.')}"
                f": max_abs_err={err:.3e} (tol rtol=atol={tol}), final state "
                f"{max_abs_err(torch, got[1], want[1]):.3e} (tol {ftol})")
        if label.startswith("serve"):
            make, outs = scan_entry(name, args, got, mod.DEFAULT_BLOCK_C,
                                    mod.DEFAULT_TIME_CHUNK)
            ms, ms_range = graph_ms(torch, make, 20)
            if name == "rglru_scan":
                rglru_replays(make, args, outs, got, {}, f"{name} {label}")
            call_ms, call_range = cuda_ms(torch, lambda: kernel(*args), 20)
            line += (f"; kernel {ms:.4f} ms {ms_range} (wrapper call "
                     f"{call_ms:.4f} ms {call_range}), bound "
                     f"{bound_ms * 1e3:.2f} us ({bound_by}, "
                     f"{bound_ms / ms:.1%} of it)")
        print(line)
        if label.startswith("3-D grid"):
            make, outs = scan_entry(name, args, got, mod.DEFAULT_BLOCK_C, 16)
            rglru_replays(make, args, outs, got, kw, f"{name} {label}")
            print(f"  grid ({-(-n // 16)}, {-(-d // mod.DEFAULT_BLOCK_C)}, "
                  f"{b}) blocks; graph replays bit-identical")
        if label == f"serve S={SERVE_BUCKETS[0]}":
            plain_ms, plain_range = cuda_ms(torch, lambda: plain(*args), 1)
            print(f"  kernel {ms:.4f} ms {ms_range}"
                  + (f" (first version {RGLRU_FIRST_MS} ms, an earlier run "
                     f"on the same card model)" if name == "rglru_scan" else "")
                  + f"  plain {plain_ms:.4f} ms {plain_range}  library: none"
                  f"  bound {bound_ms * 1e3:.2f} us ({bound_by}, "
                  f"{bound_ms / ms:.1%} of it)")
            print(f"  clocks.sm, clocks.max.sm, power.draw, temperature: "
                  f"{clocks()}")
            points = [(mod.DEFAULT_BLOCK_C, mod.DEFAULT_TIME_CHUNK)]
            if name == "rglru_scan":
                points += [(bc, tc) for bc in RS.BLOCK_CS
                           for tc in RS.TIME_CHUNKS if (bc, tc) != points[0]]
            sweep = {}
            for bc, tc in points:
                # each tile point against the plain version and the
                # wrapper; its time as a graph replay; its registers and
                # shared memory against the Step-3 estimate
                at = kernel(*args, block_c=bc, time_chunk=tc)
                assert_close(torch, at[0].float(), want[0].float(),
                             f"{name} {label} at {bc}x{tc}", rtol=tol,
                             atol=tol)
                if (bc, tc) != points[0]:
                    sweep[bc, tc] = graph_ms(torch, scan_entry(
                        name, args, at, bc, tc)[0], 20)[0]
                if name == "ssm_scan":
                    attrs = SS.kernel_attributes(shape[3], tc, dt == bf16)
                    dynamic = 0
                else:
                    attrs = RS.kernel_attributes(tc, dt == bf16)
                    dynamic = RS.kernel_smem_bytes(bc, tc, dt == bf16)
                est = precompile(name, "hopper", variants(name)["hopper"],
                                 args, {"block_c": bc, "time_chunk": tc})
                print(f"  block_c {bc}, time_chunk {tc}: "
                      f"cudaFuncGetAttributes {attrs}, dynamic smem "
                      f"{dynamic} B; Step-3 estimate "
                      f"{est.resource_bytes:.0f} B/block")
                if est.resource_bytes != attrs["static_smem_bytes"] + dynamic:
                    raise AssertionError(f"{name}: Step-3 estimate "
                                         f"{est.resource_bytes} B != the "
                                         f"kernel's {attrs}, dynamic "
                                         f"{dynamic} B at {bc}x{tc}")
            if sweep:
                sweep[points[0]] = ms
                best = min(sweep, key=sweep.get)
                print("  tile points (block_c x time_chunk: kernel ms): "
                      + ", ".join(f"{bc}x{tc}: {t:.4f}"
                                  for (bc, tc), t in sorted(sweep.items()))
                      + f"; best {best[0]}x{best[1]}, default "
                      f"{points[0][0]}x{points[0][1]}")
            rows[name] = {
                "name": name, "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{name}.cu",
                "replaces": {"ssm_scan": "src/repro/kernels/ssm_scan.py:51",
                             "rglru_scan": "src/repro/kernels/rglru_scan.py:45"
                             }[name],
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
        del args, got, want
    torch.cuda.empty_cache()

    def rmsnorm_launches(x, w):
        """The kernel launched from its C entry point (as ``c_entry``): at
        these sizes the wrapper's host cost per call (~25 us) exceeds the
        kernel's, so back-to-back wrapper calls time the host."""
        rows_x = x.view(-1, x.shape[-1])
        out = torch.empty_like(rows_x)
        return c_entry(RN._lib(), "rmsnorm_launch", (
            rows_x.data_ptr(), w.data_ptr(), out.data_ptr(), rows_x.shape[0],
            rows_x.shape[1], rows_x.stride(0), 1e-5, int(x.dtype == bf16),
            int(w.dtype == bf16), RN.threads(x.shape[-1], x.element_size())),
            (out,), (RN.rmsnorm(x, w, eps=1e-5).view(rows_x.shape),),
            "rmsnorm")(stream)

    # rmsnorm at the rows the norms of phases 6, 8 and 9 and of phase 10's
    # discovered Mistral see (prefill buckets, a decode step) and 9 rows of
    # D=300 (600-byte bf16 rows: off the 16-byte grain, the scalar path).
    # bf16 2e-2, the tolerance of tests/test_kernels.py: kernel and plain
    # version agree to float32 summation order, then round once to bf16.
    # float32 1e-5: the summation order of the row's sum of squares.
    norm_tols = {bf16: 2e-2, f32: 1e-5}
    norm_cases = [((1, 2048, 5120), "Mistral prefill"),
                  ((1, 2080, 4096), "falcon-mamba prefill"),
                  ((1, 2080, 2560), "recurrentgemma prefill"),
                  ((4, 1, 5120), "decode step"),
                  ((9, 300), "off-grain")]
    for (shape, label), dt in [(c, dt) for dt in (bf16, f32)
                               for c in norm_cases] + [
            (((1, 2048, 5120), "Mistral prefill, f32 w"), bf16)]:
        w_dt = f32 if label.endswith("f32 w") else dt
        x = dnormal(*shape, dtype=dt)
        w = dnormal(shape[-1], dtype=w_dt) * 0.1
        got, want = RN.rmsnorm(x, w, eps=1e-5), rmsnorm_plain(x, w, 1e-5)
        torch.cuda.synchronize()
        tol = norm_tols[dt]
        assert_close(torch, got.float(), want.float(), f"rmsnorm {label}",
                     rtol=tol, atol=tol)
        err = max_abs_err(torch, got.float(), want.float())
        n_rows, d = x.numel() // shape[-1], shape[-1]
        bound_ms, bound_by = rmsnorm_bound_ms(n_rows, d, x.element_size(),
                                              w.element_size())
        line = (f"rmsnorm {label} {list(shape)} x "
                f"{str(dt).removeprefix('torch.')}, w "
                f"{str(w_dt).removeprefix('torch.')}: max_abs_err={err:.3e} "
                f"(tol rtol=atol={tol})")
        if label.endswith("prefill") or label == "decode step":
            ms, ms_range = cuda_ms(torch, rmsnorm_launches(x, w), 200)
            call_ms, call_range = cuda_ms(torch, lambda: RN.rmsnorm(
                x, w, eps=1e-5), 100)
            line += (f"; kernel {ms:.4f} ms {ms_range} (wrapper call "
                     f"{call_ms:.4f} ms {call_range}), bound "
                     f"{bound_ms * 1e3:.2f} us ({bound_by})")
        print(line)
        if label == "Mistral prefill" and dt == bf16:
            plain_ms, plain_range = cuda_ms(
                torch, lambda: rmsnorm_plain(x, w, 1e-5), 50)
            w1 = 1.0 + w.float()            # formed outside the timing
            lib = torch.nn.functional.rms_norm(x.float(), (d,), w1,
                                               1e-5).to(x.dtype)
            assert_close(torch, lib.float(), want.float(),
                         "F.rms_norm vs plain", rtol=tol, atol=tol)
            lib_ms, lib_range = cuda_ms(torch, lambda: torch.nn.functional
                                        .rms_norm(x.float(), (d,), w1, 1e-5)
                                        .to(x.dtype), 50)
            est = precompile("rmsnorm", "hopper",
                             variants("rmsnorm")["hopper"], (x, w), None,
                             {"eps": 1e-5})
            print(f"  kernel {ms:.4f} ms {ms_range}  plain {plain_ms:.4f} ms "
                  f"{plain_range}  F.rms_norm {lib_ms:.4f} ms {lib_range}  "
                  f"bound {bound_ms * 1e3:.2f} us ({bound_by})")
            print(f"  clocks.sm, clocks.max.sm, power.draw, temperature: "
                  f"{clocks()}")
            print(f"  cudaFuncGetAttributes: {RN.kernel_attributes()}; "
                  f"{RN.threads(d, 2)} threads per row; static smem "
                  f"{RN.smem_bytes()} B/block; Step-3 estimate "
                  f"{est.resource_bytes:.0f} B/block")
            rows["rmsnorm"] = {
                "name": "rmsnorm", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
                "replaces": "src/repro/kernels/rmsnorm.py:21",
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": lib_ms}
        del x, w, got, want
    torch.cuda.empty_cache()

    # ---- 4. planner (main path; launch counters zeroed here) ------------
    phase("4. planner")
    for counter in counters:
        counter.launches = 0
    cfg = PlannerConfig(strategy="staged", max_measurements=4, reps=3)
    with tempfile.TemporaryDirectory() as tmp:
        cache = PlanCache(Path(tmp) / "plans.json")
        for prog in (tdfir_app.make_program(TDFIR_FULL, TDFIR_FULL, device=dev),
                     mriq_app.make_program(device=dev)):
            t0 = time.perf_counter()
            report = AutoOffloader(cfg).plan(prog, cache=cache)
            print(report.summary())
            print(f"planned {prog.name} in {time.perf_counter() - t0:.1f} s, "
                  f"{len(report.measurements)} measurements")
            if not (report.baseline.ok and report.measurements
                    and len(report.measurements) <= cfg.max_measurements):
                raise AssertionError(f"{prog.name}: unsound plan")
            again = AutoOffloader(cfg).plan(prog, cache=cache)
            if not again.from_cache or again.measurements:
                raise AssertionError(f"{prog.name}: re-plan was not a cache hit")
            print(f"re-plan: served from plan cache with "
                  f"{len(again.measurements)} measurements, best "
                  f"{Impl(again.best_pattern).describe()}")

    print(f"launches during the two plans: "
          f"fir_filter_bank {fir.fir_filter_bank.launches}, "
          f"mriq_compute_q {mriq.mriq_compute_q.launches}")

    # ---- 5. the hopper patterns at full size (main path, continued) -----
    phase("5. run")
    # tdFIR's hopper pattern is also timed once warm (median of 5 calls;
    # MRI-Q's full-size pattern runs its loop-faithful check for seconds)
    for prog, impl, tols, reps in (
            (tdfir_app.make_program(TDFIR_FULL, TDFIR_FULL, device=dev),
             Impl({"fir_bank": "hopper"}), (3e-4, 1e-3), 5),
            (mriq_app.make_program(MRIQ_FULL, MRIQ_FULL, device=dev),
             Impl({"compute_q": "hopper"}), (3e-3, 3e-3, 1e-3), 0)):
        sample = prog.sample_inputs(0, dev)
        offload = Impl({r.name: "offload" for r in prog.regions})
        torch.cuda.reset_peak_memory_stats(dev)
        run = prog.build(impl)
        t0 = time.perf_counter()
        got = run(*sample)
        torch.cuda.synchronize()
        t_hopper = time.perf_counter() - t0
        warm = []
        for _ in range(reps):
            t0 = time.perf_counter()
            run(*sample)
            torch.cuda.synchronize()
            warm.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        want = prog.build(offload)(*sample)
        torch.cuda.synchronize()
        t_offload = time.perf_counter() - t0
        # the checksums (last output) sum in another order than the
        # offload build (a sequential loop against a pairwise reduction):
        # their tolerance is the summation-order error, 1e-3 relative
        for i, (a, b, t) in enumerate(zip(got, want, tols)):
            if a.shape != b.shape:
                raise AssertionError(f"{prog.name} output {i}: shape "
                                     f"{tuple(a.shape)} vs {tuple(b.shape)}")
            assert_close(torch, a, b, f"{prog.name} output {i}", rtol=t,
                         atol=t)
        print(f"{prog.name} {impl.describe()} vs all-offload: outputs "
              f"{[tuple(a.shape) for a in got]} agree; hopper build "
              f"{t_hopper:.2f} s, offload build {t_offload:.2f} s (wall, "
              f"first call)"
              + (f"; hopper pattern warm {statistics.median(warm) * 1e3:.3f}"
                 f" ms (wall, median of {reps})" if warm else "")
              + f"; peak memory "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
        del sample, got, want
        torch.cuda.empty_cache()
    launches = {"fir_filter_bank": fir.fir_filter_bank.launches,
                "mriq_compute_q": mriq.mriq_compute_q.launches}
    print(f"launches on the main path (phases 4-5): {launches}")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"{name} was not launched on the main path")
        rows[name]["launches"] = count

    # ---- 6, 8, 9. serve a full-width model through the planner ----------
    decode_ms: dict = {}

    def serve_arch(arch: str, hopper: tuple[str, ...],
                   mix: tuple[int, ...] = tuple(range(len(SERVE_PROMPTS))),
                   ncfg=None, lengths: tuple[int, ...] | None = None,
                   buckets: tuple[int, ...] | None = None,
                   ctx: int = SERVE_CTX, on_plan=None,
                   with_model=None, check_prefill=None) -> dict:
        """Plan ``make_lm_program(arch)`` (then a cache hit), draw the model
        (``ncfg``, by default the arch's full config) on the card, serve the
        request mix twice with the ``hopper`` regions over the planned
        pattern (captures, then replays) and once on an eager twin, time the
        decode step both ways against its weight-streaming bound, and hold
        each request's prefill logits under hopper against ref, the noise
        floor being offload against ref, or, where given, run
        ``check_prefill(params, ncfg, impl)`` in place of that comparison.
        The mix is ``SERVE_PROMPTS[mix]`` in
        ``SERVE_BUCKETS[mix]`` at ``SERVE_CTX``, or ``lengths`` in
        ``buckets`` at ``ctx``; a frontend arch's requests each carry their
        own synthetic patches or frames.  ``on_plan(report)`` checks the
        plan; ``with_model(params, ncfg)`` runs before the model is freed.
        Every launch counter is zeroed first; returns the counts of
        planning and the engine's two rounds."""
        for counter in counters:
            counter.launches = 0
        with tempfile.TemporaryDirectory() as tmp:
            cache = PlanCache(Path(tmp) / "plans.json")
            prog = make_lm_program(arch, device=dev)
            t0 = time.perf_counter()
            report = AutoOffloader(cfg).plan(prog, cache=cache)
            print(report.summary())
            print(f"planned {prog.name} in {time.perf_counter() - t0:.1f} s, "
                  f"{len(report.measurements)} measurements")
            if not (report.baseline.ok and report.measurements):
                raise AssertionError(f"{prog.name}: unsound plan")
            if on_plan is not None:
                on_plan(report)
            again = AutoOffloader(cfg).plan(prog, cache=cache)
            if not again.from_cache or again.measurements:
                raise AssertionError(f"{prog.name}: re-plan was not a cache hit")
            print(f"re-plan: served from plan cache with "
                  f"{len(again.measurements)} measurements")
        impl = Impl({**report.best_impl(), **{r: "hopper" for r in hopper}})
        depth = get_config(arch).num_layers
        ncfg = ncfg or get_config(arch)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        params = F.init_params(ncfg, torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize()
        leaves = tree_leaves(params)
        unit, reps, tail = layer_plan(ncfg)
        print(f"{arch}: {ncfg.num_layers} layers ("
              + ("full depth" if ncfg.num_layers == depth
                 else f"{ncfg.num_layers} of {depth}")
              + f": {reps} x "
              f"{'/'.join(unit)}{' + ' + '/'.join(tail) if tail else ''}), "
              f"d_model {ncfg.d_model}, heads {ncfg.num_heads}/"
              f"{ncfg.num_kv_heads} x {ncfg.resolved_head_dim if ncfg.num_heads else 0}"
              f", d_ff {ncfg.d_ff}, vocab {ncfg.vocab_size}"
              + (f", d_inner {ncfg.d_inner}, N {ncfg.ssm_state}"
                 if ncfg.family == "ssm" else "")
              + (f", d_rnn {ncfg.rglru_d_rnn}, window {ncfg.attn_window}"
                 if ncfg.family == "hybrid" else "")
              + (f", {ncfg.num_experts} experts top-{ncfg.experts_per_token}"
                 f" of d_ff {ncfg.moe_d_ff or ncfg.d_ff}" if ncfg.is_moe
                 else "")
              + (f", {ncfg.encoder_layers}-layer encoder over "
                 f"{ncfg.encoder_seq} positions" if ncfg.encoder_layers
                 else "")
              + (f", frontend {ncfg.frontend} [{ncfg.frontend_seq}, "
                 f"{ncfg.frontend_dim}]" if ncfg.frontend != "none" else "")
              + f": {sum(t.numel() for t in leaves) / 1e9:.3f} B parameters, "
              f"{sum(t.numel() * t.element_size() for t in leaves) / 2**30:.2f}"
              f" GiB, drawn on the card in {time.perf_counter() - t0:.1f} s")
        engine = ServeEngine(ncfg, params, slots=SERVE_SLOTS, ctx=ctx,
                             seed=0, impl=impl)
        if lengths is None:      # request i of the mix of six: seed 100 + i
            lengths = tuple(SERVE_PROMPTS[i] for i in mix)
            buckets = tuple(SERVE_BUCKETS[i] for i in mix)
            seeds = tuple(100 + i for i in mix)
        else:
            seeds = tuple(100 + i for i in range(len(lengths)))
        requests = [F.synthetic_request(ncfg, n, seed=seed)
                    for n, seed in zip(lengths, seeds)]
        prompts = [r[0] for r in requests]
        n_front = ncfg.n_front

        def serve_round(eng, label: str):
            """Serve the mix on ``eng``; check it, print it, return the
            streams, the summary stats and the launches of the round."""
            before = {c.__name__: c.launches for c in counters}
            traces = eng.prefill_traces
            built = ("first calls" if isinstance(eng, EagerTwin)
                     else "captures")
            for prompt, frontend in requests:
                eng.submit(prompt, max_new_tokens=SERVE_NEW_TOKENS,
                           frontend=frontend)
            t0 = time.perf_counter()
            eng.run_to_completion()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            st = eng.stats()
            done = eng.drain_finished()
            launched = {c.__name__: c.launches - before[c.__name__]
                        for c in counters}
            for req in done:
                print(f"  req {req.rid}: prompt {req.tokens.size:4d} (bucket "
                      f"{req.bucket:4d}) | wait {req.queue_wait_s * 1e3:8.1f} ms "
                      f"| ttft {req.ttft_s * 1e3:8.1f} ms | decode "
                      f"{req.decode_tps:7.1f} tok/s | {len(req.generated)} "
                      "tokens")
            print(f"{label}: served {st['requests_finished']} requests / "
                  f"{st['generated_tokens']} tokens in {wall:.3f} s "
                  f"({st['generated_tokens'] / wall:.1f} tok/s aggregate); "
                  f"TTFT mean {st['ttft_s_mean'] * 1e3:.1f} ms, p50 "
                  f"{st['ttft_s_p50'] * 1e3:.1f} ms; decode tok/s per request "
                  f"mean {st['decode_tps_mean']:.1f}; prefill {built} "
                  f"{eng.prefill_traces - traces} (total {eng.prefill_traces}"
                  f", buckets {st['buckets']}); launches {launched}; peak "
                  f"memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} "
                  "GiB")
            if (len(done) != len(prompts)
                    or any(len(r.generated) != SERVE_NEW_TOKENS for r in done)
                    or tuple(r.bucket for r in done) != buckets):
                raise AssertionError(
                    f"serve {arch} {label}: {len(done)} finished, tokens "
                    f"{[len(r.generated) for r in done]}, buckets "
                    f"{[r.bucket for r in done]}")
            # a fault of the served plan would roll back to the plain one
            if st["rollbacks"] or st["degraded"]:
                raise AssertionError(
                    f"serve {arch} {label}: rolled back ({st['rollbacks']}, "
                    f"degraded {st['degraded']}): {st['last_fault']}")
            return [r.generated for r in done], launched

        # round 1 captures one prefill graph per bucket and the decode
        # graph; round 2 replays them and must capture nothing
        streams, launches = serve_round(engine, "round 1 (captures)")
        traces = engine.prefill_traces
        again, replayed = serve_round(engine, "round 2 (replays)")
        launches = {k: v + replayed[k] for k, v in launches.items()}
        print(f"launches while serving (planning and both rounds): {launches}")
        print(f"  clocks.sm, clocks.max.sm, power.draw, temperature: {clocks()}")
        if traces != len(buckets) or engine.prefill_traces != traces:
            raise AssertionError(f"serve {arch}: {traces} prefill captures in "
                                 f"round 1, {engine.prefill_traces - traces} in "
                                 "round 2")
        if again != streams:
            raise AssertionError(f"serve {arch}: round 2's greedy streams "
                                 "differ from round 1's")
        silent = [REGION_KERNEL[r] for r in hopper
                  if not replayed[REGION_KERNEL[r]]]
        if silent:
            raise AssertionError(f"serve {arch}: round 2 counted no launch of "
                                 f"{silent}")
        # the eager twin: the same step functions, called eagerly
        twin = EagerTwin(ncfg, params, slots=SERVE_SLOTS, ctx=ctx,
                         seed=0, impl=impl)
        eager_streams, _ = serve_round(twin, "eager twin")
        del twin
        torch.cuda.empty_cache()
        if eager_streams != streams:
            raise AssertionError(f"serve {arch}: the graphs' greedy streams "
                                 "differ from the eager twin's")
        print("greedy streams: round 1 = round 2 = eager twin")

        # one decode step with all slots active, as a graph replay and as
        # the eager step function (the twin's path), on the engine's cache
        toks = np.asarray(streams, np.int32)[:SERVE_SLOTS, -1:]
        pos = np.asarray([p.size + n_front for p in prompts][:SERVE_SLOTS],
                         np.int32) + 8
        toks = np.resize(toks, (SERVE_SLOTS, 1))
        pos = np.resize(pos, SERVE_SLOTS)
        replay = engine._gen.decode
        eager = EagerStep(replay.step.fn, replay.step.fixed)
        steps = {"graph": lambda: replay(toks, pos),
                 "eager": lambda: eager(toks, pos)}
        times = {k: [] for k in steps}
        for name in ("graph", "eager", "eager", "graph"):
            for _ in range(12):
                t0 = time.perf_counter()
                steps[name]()
                torch.cuda.synchronize()
                times[name].append(time.perf_counter() - t0)
        ms = {k: statistics.median(v[2:12] + v[14:]) * 1e3
              for k, v in times.items()}
        print(f"decode step [{SERVE_SLOTS} slots] host clock, synchronized, "
              f"median of 20: graph replay {ms['graph']:.3f} ms, eager "
              f"{ms['eager']:.3f} ms ({ms['eager'] / ms['graph']:.2f}x)")
        prof, device_ms = {}, {}
        for k, fn in steps.items():
            prof[k], device_ms[k] = profile_step(torch, fn, ms[k])
            print(f"  profiled {k}: {prof[k]}")
        busy = device_ms["graph"]
        # the least a step can take: every weight it reads (the embedding
        # table gives 4 rows; a frontend's projection, stem and encoder run
        # at prefill only) and the whole KV / state cache, once, at the
        # card's memory rate.  An MoE step reads every expert: at decode
        # each expert's capacity holds all the slots (moe_ffn=offload)
        weight_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(
            {k: v for k, v in params.items()
             if k not in ("w_front", "stem", "encoder")}))
        if not ncfg.tie_embeddings:
            embed = params["embed"]
            weight_bytes -= embed.numel() * embed.element_size()
        cache_bytes = sum(t.numel() * t.element_size()
                          for t in tree_leaves(engine.cache))
        bound = (weight_bytes + cache_bytes) / HBM_BYTES_PER_S * 1e3
        print(f"decode step device time (graph replay, torch.profiler) "
              + (f"{busy:.3f} ms" if busy is not None else "not measured")
              + f" against its weight-streaming bound {bound:.3f} ms "
              f"({weight_bytes / 1e9:.2f} GB of weights + "
              f"{cache_bytes / 1e9:.2f} GB of cache at "
              f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s)"
              + (f": {busy / bound:.2f}x" if busy is not None else "")
              + f" [{card}]")
        del replay, eager, steps
        decode_ms[arch] = (ms, prof)

        # the prefill logits of each request under hopper against ref (the
        # engine's own prefill entry point), with offload as the noise floor
        # of two plain versions
        def prefill_logits(variant: str, request):
            # the engine's pattern: over the architectural defaults (MoE:
            # expert choice), as ServeEngine merges them
            step = F.make_bucketed_prefill_step(
                ncfg, impl=Impl({**F.default_impl(ncfg), **impl,
                                 **{r: variant for r in hopper}}),
                ctx=ctx)
            prompt, frontend = request
            n = prompt.size
            padded = np.zeros((1, F.prefill_bucket(n, ctx - n_front)),
                              np.int32)
            padded[0, :n] = prompt
            batch = {"tokens": torch.from_numpy(padded).to(dev)}
            if frontend is not None:
                batch[F.frontend_key(ncfg)] = torch.from_numpy(
                    frontend[None]).to(dev)
            logits, _ = step(params, batch, n)
            return logits[0, -1]

        worst = floor = 0.0
        agree = 0
        for request in requests if hopper and not check_prefill else ():
            prompt = request[0]
            hop = prefill_logits("hopper", request)
            ref = prefill_logits("ref", request)
            off = prefill_logits("offload", request)
            if not bool(torch.isfinite(hop).all()):
                raise AssertionError(f"serve {arch}: non-finite prefill "
                                     "logits")
            diff = float((hop - ref).abs().max())
            worst = max(worst, diff)
            floor = max(floor, float((off - ref).abs().max()))
            agree += int(hop.argmax() == ref.argmax())
            print(f"  prompt {prompt.size:4d}: max |logits(hopper) - "
                  f"logits(ref)| = {diff:.3e}, max |logits(hopper) - "
                  f"logits(offload)| = {float((hop - off).abs().max()):.3e}, "
                  f"max |logits(offload) - logits(ref)| = "
                  f"{float((off - ref).abs().max()):.3e}, max |logits(ref)| "
                  f"= {float(ref.abs().max()):.3f}")
        tol = max(LOGIT_NOISE_FACTOR * floor, LOGIT_TOL_MIN)
        if check_prefill is not None:
            check_prefill(params, ncfg, impl)
        elif hopper:
            print(f"prefill logits hopper vs ref: max abs diff {worst:.3e}; "
                  f"noise floor (offload vs ref) {floor:.3e}; tol max("
                  f"{LOGIT_NOISE_FACTOR} x floor, {LOGIT_TOL_MIN}) = "
                  f"{tol:.3e}; argmax agrees on {agree}/{len(prompts)} "
                  "prompts")
        else:
            print("no hopper region served: prefill logits not compared")
        if worst > tol:
            raise AssertionError(f"serve {arch}: hopper and ref prefill logits "
                                 f"differ by {worst:.3e} > {tol:.3e}")
        if with_model is not None:
            with_model(params, ncfg)
        del engine, params, leaves
        gc.collect()                 # the engine's graphs refer back to it
        torch.cuda.empty_cache()
        return launches

    # ---- 6. serve full-width Mistral-NeMo-12B (slice-2 main path) -------
    phase("6. serve")
    serve_launches = serve_arch(ARCH, ("attn_core",), SHORT_MIX)
    if serve_launches["flash_attention"] <= 0:
        raise AssertionError("flash_attention was not launched on the main "
                             "path")

    # ---- 7. plan the decode_attn program ------------------------------
    phase("7. decode_attn plan")
    for counter in counters:
        counter.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        cache = PlanCache(Path(tmp) / "plans.json")
        prog = make_decode_program(device=dev)
        report = AutoOffloader(cfg).plan(prog, cache=cache)
        print(report.summary())
        if not any(m.ok and m.mapping().get("decode_attn") == "hopper"
                   for m in report.measurements):
            raise AssertionError("decode_attn=hopper was not measured")
        again = AutoOffloader(cfg).plan(prog, cache=cache)
        if not again.from_cache or again.measurements:
            raise AssertionError(f"{prog.name}: re-plan was not a cache hit")
        print(f"re-plan: served from plan cache with "
              f"{len(again.measurements)} measurements")
    decode_launches = {c.__name__: c.launches for c in counters}
    print(f"launches while planning decode_attn: {decode_launches}")
    if decode_launches["decode_attention"] <= 0:
        raise AssertionError("decode_attention was not launched on the main "
                             "path")

    # ---- 8. serve full-width falcon-mamba-7b (slice-3 main path) --------
    phase("8. serve falcon-mamba-7b")
    ssm_launches = serve_arch(SSM_ARCH, ("ssm_scan",), SHORT_MIX)
    if ssm_launches["ssm_scan"] <= 0:
        raise AssertionError("ssm_scan was not launched on the main path")

    # ---- 9. serve full-width recurrentgemma-2b (slice-3 main path) ------
    phase("9. serve recurrentgemma-2b")
    hybrid_launches = serve_arch(HYBRID_ARCH, ("rglru_scan", "attn_core"))
    for name in ("rglru_scan", "flash_attention"):
        if hybrid_launches[name] <= 0:
            raise AssertionError(f"{name} was not launched on the main path")

    print("decode step [4 slots], graph replay / eager (ms, host clock): "
          + ", ".join(f"{a} {m['graph']:.3f} / {m['eager']:.3f}"
                      for a, (m, _) in decode_ms.items()))

    # flash serves two main paths: Mistral's (head_dim 128) and
    # recurrentgemma's local attention (head_dim 256)
    rows["flash_attention"]["launches"] = (serve_launches["flash_attention"]
                                           + hybrid_launches["flash_attention"])
    rows["decode_attention"]["launches"] = decode_launches["decode_attention"]
    rows["ssm_scan"]["launches"] = ssm_launches["ssm_scan"]
    rows["rglru_scan"]["launches"] = hybrid_launches["rglru_scan"]
    print(f"flash_attention launches: phase 6 {serve_launches['flash_attention']}"
          f" (head_dim 128), phase 9 {hybrid_launches['flash_attention']} "
          f"(head_dim 256); at head_dim 256 [1, 10/1, 2,048, 256] bf16 window "
          f"2,048: {json.dumps(flash256)}; the float32 instance at [1, 32/8, "
          f"2,048, 128]: {json.dumps(flash_f32)}")

    # ---- 10. static extraction of an unannotated model (slice-4 path) ---
    phase("10. extract")
    t10 = time.perf_counter()
    for counter in counters:
        counter.launches = 0
    t0 = time.perf_counter()
    accuracy = loop_extraction.run_accuracy(dev, reduced=False)
    loop_extraction.print_accuracy(*accuracy)
    print(f"accuracy table: the archs at full width and full depth, captured "
          f"on fake tensors, in {time.perf_counter() - t0:.1f} s")

    ncfg = get_config(ARCH)
    t0 = time.perf_counter()
    params = F.init_params(ncfg, torch.Generator(device=dev).manual_seed(0))
    tokens = torch.from_numpy(F.synthetic_batch(
        ncfg, 1, EXTRACT_PROMPT, seed=3)["tokens"]).to(dev)
    torch.cuda.synchronize()
    print(f"{ARCH}: {ncfg.num_layers} layers drawn on the card in "
          f"{time.perf_counter() - t0:.1f} s")
    fwd = F.make_forward(ncfg, Impl())           # all-ref: unannotated

    def unannotated(t):
        return fwd(params, {"tokens": t})

    t0 = time.perf_counter()
    prog = discover(unannotated, (tokens,), name=ARCH)
    found = prog.extraction
    print(found.summary().splitlines()[0])
    print(f"discovered {ARCH} at [1, {EXTRACT_PROMPT}] in "
          f"{time.perf_counter() - t0:.1f} s: "
          f"{len(found.graph_module.graph.nodes)} graph nodes; regions "
          + ", ".join(f"{r.name} {r.arg_signature()}"
                      + (f" {r.static_kwargs}" if "+" not in r.name else "")
                      for r in prog.regions))
    missing = {"rmsnorm", "attn_core", "mlp_core"} - {r.name for r in prog.regions}
    if missing:
        raise AssertionError(f"extract {ARCH}: {sorted(missing)} not discovered")
    with tempfile.TemporaryDirectory() as tmp:
        cache = PlanCache(Path(tmp) / "plans.json")
        t0 = time.perf_counter()
        report = AutoOffloader(cfg).plan(prog, cache=cache)
        print(report.summary())
        print(f"planned {prog.name} in {time.perf_counter() - t0:.1f} s, "
              f"{len(report.measurements)} measurements")
        if not (report.baseline.ok and any(
                m.ok and m.mapping().get("rmsnorm") == "hopper"
                for m in report.measurements)):
            raise AssertionError("rmsnorm=hopper was not measured")
        again = AutoOffloader(cfg).plan(prog, cache=cache)
        if not again.from_cache or again.measurements:
            raise AssertionError(f"{prog.name}: re-plan was not a cache hit")
        print(f"re-plan: served from plan cache with "
              f"{len(again.measurements)} measurements")
    impl = Impl({**report.best_impl(), "rmsnorm": "hopper"})
    ref = prog.build(Impl())(tokens)
    # the noise floor: two plain versions against each other.  offload
    # against ref is the rule of phases 6, 8 and 9, but at 512 tokens both
    # attention versions take one 512 x 512 tile and give the same logits;
    # so the floor also takes the norms computed by PyTorch's own
    # F.rms_norm (the same function, summed in another order), a variant
    # registered for this comparison only
    floor_impl = Impl({r.name: "offload" for r in prog.regions
                       if "+" not in r.name and "offload" in variants(r.name)})
    register_variant("rmsnorm", "torch_rms_norm")(
        lambda x, w, eps=1e-6: torch.nn.functional.rms_norm(
            x.float(), (x.shape[-1],), 1.0 + w.float(), eps).to(x.dtype))
    try:
        floors = {i.describe(): float((prog.build(i)(tokens) - ref).abs().max())
                  for i in (floor_impl, Impl({"rmsnorm": "torch_rms_norm"}))}
    finally:
        unregister_variant("rmsnorm", "torch_rms_norm")
    floor = max(floors.values())
    tol = max(LOGIT_NOISE_FACTOR * floor, LOGIT_TOL_MIN)
    print(f"noise floor (plain vs all-ref): {floors} -> {floor:.3e}; tol "
          f"max({LOGIT_NOISE_FACTOR} x floor, {LOGIT_TOL_MIN}) = {tol:.3e}; "
          f"max |logits| {float(ref.abs().max()):.3f}")
    per_forward = 0
    for run in (Impl({"rmsnorm": "hopper"}), impl):
        before = RN.rmsnorm.launches
        hop = prog.build(run)(tokens)
        torch.cuda.synchronize()
        per_forward = RN.rmsnorm.launches - before
        if not bool(torch.isfinite(hop).all()) or hop.shape != ref.shape:
            raise AssertionError(f"extract {ARCH}: logits {tuple(hop.shape)} "
                                 "non-finite or misshapen")
        diff = float((hop - ref).abs().max())
        agree = float((hop.argmax(-1) == ref.argmax(-1)).float().mean())
        print(f"logits [1, {EXTRACT_PROMPT}, {ncfg.vocab_size}] with "
              f"{run.describe()} vs the captured program: max abs diff "
              f"{diff:.3e} (tol {tol:.3e}); argmax agrees at {agree:.4f} of "
              f"positions; {per_forward} rmsnorm launches")
        if diff > tol:
            raise AssertionError(f"extract {ARCH}: {run.describe()} logits "
                                 f"differ by {diff:.3e} > {tol:.3e}")
    extract_launches = {c.__name__: c.launches for c in counters}
    print(f"launches in phase 10: {extract_launches}; rmsnorm per forward "
          f"{per_forward} (2 per layer x {ncfg.num_layers} + the final norm)")
    if extract_launches["rmsnorm"] <= 0 or per_forward != 2 * ncfg.num_layers + 1:
        raise AssertionError("rmsnorm was not launched on the main path")
    rows["rmsnorm"]["launches"] = extract_launches["rmsnorm"]
    del prog, found, report, again, hop, ref, params, fwd, unannotated
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 10 wall {time.perf_counter() - t10:.1f} s")

    # ---- 11. the rest of Step 4: strategies x verify_workers -----------
    phase("11. strategies")
    t11 = time.perf_counter()
    for counter in counters:
        counter.launches = 0
    apps11 = {"tdfir": lambda: tdfir_app.make_program(TDFIR_FULL, TDFIR_FULL,
                                                      device=dev),
              "mriq": lambda: mriq_app.make_program(device=dev)}

    def plan_fresh(make, cfg11, cold=False, replay=None):
        """One plan on a fresh cache (and, with ``cold``, a fresh build
        directory: the compile step builds the app's kernel with nvcc),
        then a repeat plan against the warm cache.  With ``replay`` (pattern
        -> Measurement of an earlier plan) every pattern is still built,
        run and timed on the card, but the strategy is told the earlier
        plan's median for a pattern both plans measured."""
        told: list = []

        def time_callable(*args, **kwargs):
            m = real_time_callable(*args, **kwargs)
            rec = replay.get(m.pattern) if replay else None
            if m.ok and rec is not None:
                told.append((m.pattern, m.run_seconds, rec.run_seconds))
                m.run_seconds, m.runs = rec.run_seconds, list(rec.runs)
            return m

        with tempfile.TemporaryDirectory() as tmp:
            cache = PlanCache(Path(tmp) / "plans.json")
            if cold:
                os.environ["REPRO_TORCH_BUILD_DIR"] = str(Path(tmp) / "build")
            search_mod.time_callable = time_callable
            try:
                t0 = time.perf_counter()
                rep = AutoOffloader(cfg11).plan(make(), cache=cache)
                wall = time.perf_counter() - t0
            finally:
                search_mod.time_callable = real_time_callable
                os.environ.pop("REPRO_TORCH_BUILD_DIR", None)
            again = AutoOffloader(cfg11).plan(make(), cache=cache)
        if not again.from_cache or again.measurements:
            raise AssertionError(f"{rep.program}/{rep.strategy}: the repeat "
                                 "plan was not a zero-measurement cache hit")
        return rep, wall, told

    real_time_callable = search_mod.time_callable
    print("app,strategy,workers,measured,selected,median_ms,compile_s_total,"
          "compile_wall_s,verify_wall_s,plan_wall_s,cache_hits")
    for app, make in apps11.items():
        spent = {}
        for strat in ("staged", "genetic", "surrogate", "exhaustive"):
            runs = {}
            for workers in (1, 4):
                cfg11 = PlannerConfig(strategy=strat, max_measurements=4,
                                      reps=1, warmup=1, seed=0,
                                      verify_workers=workers)
                replay = None
                if workers == 4:
                    one = runs[1][0]
                    replay = {m.pattern: m for m in
                              [one.baseline] + list(one.measurements)}
                rep, wall, told = plan_fresh(make, cfg11, strat == "staged",
                                             replay)
                keys = [impl_key(m.impl) for m in rep.measurements]
                if len(set(keys)) != len(keys) or not 0 < len(keys) <= 4:
                    raise AssertionError(f"{app}/{strat}: measured {keys}")
                if not (rep.baseline.ok and all(m.ok for m in rep.measurements)):
                    raise AssertionError(f"{app}/{strat}: a failed measurement")
                ex = rep.search_trace[-1]
                runs[workers] = (rep, told)
                print(f"{app},{strat},{workers},{len(rep.measurements)},"
                      f"{Impl(rep.best_pattern).describe()},"
                      f"{rep.best_seconds * 1e3:.3f},"
                      f"{ex['compile_seconds_total']:.3f},"
                      f"{ex['compile_wall_s']:.3f},{ex['verify_wall_s']:.3f},"
                      f"{wall:.2f},{ex['compile_cache_hits']}")
            (one, _), (four, told) = runs[1], runs[4]
            ratios = [got / was for _, got, was in told]
            print(f"# {app}/{strat}: workers=4 timed (and was told the "
                  f"workers=1 median) " + ", ".join(
                      f"{p} {got * 1e3:.3f} ({was * 1e3:.3f}) ms"
                      for p, got, was in told)
                  + f"; own/told ratio {min(ratios):.3f}-{max(ratios):.3f},"
                  f" geometric mean {math.exp(statistics.fmean(map(math.log, ratios))):.3f}")
            far = [(p, got, was) for p, got, was in told
                   if not 1 / WORKERS_MEDIAN_FACTOR <= got / was
                   <= WORKERS_MEDIAN_FACTOR]
            if len(told) < len(four.measurements) + 1 or far:
                raise AssertionError(
                    f"{app}/{strat}: workers=4 medians not within "
                    f"{WORKERS_MEDIAN_FACTOR}x of workers=1's: {far}, or "
                    f"{len(told)} told for {len(four.measurements)} + 1")
            if ([m.pattern for m in one.measurements]
                    != [m.pattern for m in four.measurements]
                    or one.best_pattern != four.best_pattern):
                print(one.summary())
                print(four.summary())
                raise AssertionError(
                    f"{app}/{strat}: verify_workers 1 and 4 measured "
                    f"{[m.pattern for m in one.measurements]} -> "
                    f"{one.best_pattern} and "
                    f"{[m.pattern for m in four.measurements]} -> "
                    f"{four.best_pattern}")
            spent[strat] = len(one.measurements)
        print(f"# {app}: real measurements: " + ", ".join(
            f"{k} {v}" for k, v in spent.items()))
        if not spent["surrogate"] < spent["genetic"]:
            raise AssertionError(f"{app}: the surrogate spent "
                                 f"{spent['surrogate']} real measurements, the "
                                 f"GA {spent['genetic']}")
    strat_launches = {c.__name__: c.launches for c in counters}
    print(f"launches in phase 11: {strat_launches}; phase wall "
          f"{time.perf_counter() - t11:.1f} s")
    for name in ("fir_filter_bank", "mriq_compute_q"):
        if strat_launches[name] <= 0:
            raise AssertionError(f"{name} was not launched in phase 11")

    # ---- 12. faults injected into tdFIR's verification -----------------
    phase("12. faults")
    t12 = time.perf_counter()
    for counter in counters:
        counter.launches = 0
    # exhaustive: its proposals do not hang on a single pattern beating the
    # baseline in a noisy round 1, so the fault-free and the faulted plans
    # measure the same 8 patterns (fir_bank=offload the eighth)
    cfg12 = PlannerConfig(strategy="exhaustive", max_measurements=8, reps=5,
                          warmup=1, compile_timeout_s=1.0,
                          run_timeout_s=30.0, retry_backoff_s=0.0,
                          quarantine_threshold=1)
    winner12 = "fir_bank=hopper+fir_energy=offload+fir_load=offload"
    specs12 = [
        # the compile step of the winning pattern hangs past the watchdog
        FaultSpec("hang", site="compile", match=winner12, times=1,
                  delay_s=4.0),
        # every pattern with fir_load=offload fails its first call once
        FaultSpec("flaky", site="run", match="fir_load=offload", times=1),
        # the runner-up destination of fir_bank produces NaN
        FaultSpec("nan", site="run", match="fir_bank=offload", times=0,
                  transient=False),
        # the first timed rep of every fir_bank=hopper pattern is 50 ms slow
        FaultSpec("slow", site="run", match="fir_bank=hopper", times=2,
                  delay_s=0.05)]
    prog12 = tdfir_app.make_program(TDFIR_FULL, TDFIR_FULL, device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        clean = AutoOffloader(cfg12).plan(prog12, cache=PlanCache(
            Path(tmp) / "clean.json"))
        print(clean.summary())
        inj = FaultInjector(specs=specs12)
        faulty = wrap_program(prog12, inj)
        cache = PlanCache(Path(tmp) / "plans.json")
        rep = AutoOffloader(cfg12).plan(faulty, cache=cache)
        print(rep.summary())
        fired = {k: inj.fired(k) for k in ("hang", "flaky", "nan", "slow")}
        retried = [(m.pattern, m.attempts) for m in rep.measurements
                   if m.attempts > 1]
        rejected = [(m.pattern, m.outliers_rejected) for m in rep.measurements
                    if m.outliers_rejected]
        print(f"faults fired {fired}; retried {retried}; MAD-rejected reps "
              f"{rejected}; quarantined {rep.quarantined}")
        if rep.best_pattern != clean.best_pattern:
            raise AssertionError(f"faults: selected {rep.best_pattern}, the "
                                 f"fault-free plan {clean.best_pattern}")
        if not all(fired.values()) or not retried or not rejected:
            raise AssertionError(f"faults: not every fault fired and was "
                                 f"tolerated: {fired} {retried} {rejected}")
        records = cache.quarantine_for(measurement_cache_key(
            faulty, backend_name(dev)))
        if not any(r["gene"] == "fir_bank=offload" for r in records):
            raise AssertionError(f"faults: no strike persisted: {records}")
        nan_before = inj.fired("nan")
        again = AutoOffloader(PlannerConfig(
            strategy="staged", max_measurements=8, reps=2, warmup=1,
            quarantine_threshold=1)).plan(faulty, cache=cache)
        if (again.from_cache or "fir_bank=offload" not in again.quarantined
                or inj.fired("nan") != nan_before
                or any("fir_bank=offload" in m.pattern
                       for m in again.measurements)):
            raise AssertionError("faults: the second search did not skip the "
                                 "struck gene")
        print(f"second search (staged): skipped fir_bank=offload; "
              f"{len(again.measurements)} measured, best "
              f"{Impl(again.best_pattern).describe()}; persisted strikes "
              f"{records}")
    fault_launches = {c.__name__: c.launches for c in counters}
    print(f"launches in phase 12: {fault_launches}; phase wall "
          f"{time.perf_counter() - t12:.1f} s")

    # ---- 13. online replanning of full-width recurrentgemma-2b ---------
    phase("13. replan")
    t13 = time.perf_counter()
    for counter in counters:
        counter.launches = 0
    ncfg = get_config(HYBRID_ARCH)
    params = F.init_params(ncfg, torch.Generator(device=dev).manual_seed(0))
    rng = np.random.default_rng(13)
    torch.cuda.reset_peak_memory_stats(dev)
    mem13: dict = {}            # label -> (allocated, peak, reserved) in GiB

    def memory(label, release=False):
        """Record the memory allocated, its peak and the memory reserved
        (graph pools included); ``release`` first returns the allocator's
        unused blocks, freed pools among them, to the card."""
        if release:
            gc.collect()
            torch.cuda.empty_cache()
        mem13[label] = tuple(x / 2**30 for x in (
            torch.cuda.memory_allocated(dev),
            torch.cuda.max_memory_allocated(dev),
            torch.cuda.memory_reserved(dev)))

    def prompt(lo, hi):
        return rng.integers(1, ncfg.vocab_size, int(rng.integers(lo, hi + 1))
                            ).astype(np.int32)

    # scripted drift (tests/serving_harness.py's shape at full size): a
    # bucket-128 prompt every 4 ticks (8 new tokens), then two bucket-2,048
    # prompts a tick (16 new tokens)
    script = ([[(prompt(*REPLAN_SHORT), 8)] if t % 4 == 0 else []
               for t in range(REPLAN_SHORT_TICKS)]
              + [[(prompt(*REPLAN_LONG), SERVE_NEW_TOKENS)
                  for _ in range(2)] for _ in range(REPLAN_LONG_TICKS)])
    engine = ServeEngine(ncfg, params, slots=SERVE_SLOTS, ctx=SERVE_CTX,
                         seed=0)
    memory("at the start")
    offloader = make_offloader(reps=2, strategy="staged")
    pins = {"attn_core": "hopper", "rglru_scan": "hopper"}
    with tempfile.TemporaryDirectory() as tmp:
        plan_fn = make_replan_fn(HYBRID_ARCH, offloader,
                                 PlanCache(Path(tmp) / "plans.json"),
                                 device=dev)
        searched = {}
        timeline: dict = {}

        def mark(what):
            timeline[what] = (time.perf_counter(), engine.ticks)

        def timed(what, fn):
            def call(*args, **kwargs):
                mark(what + " start")
                out = fn(*args, **kwargs)
                mark(what + " end")
                return out
            return call

        engine.prepare_plan = timed("prepare_plan", engine.prepare_plan)
        engine.canary_check = timed("canary", engine.canary_check)

        def plan_and_pin(conditions):
            """The production plan_fn; the phase needs the swapped-in
            generation to run flash_attention and rglru_scan, so their
            hopper genes are pinned where the search chose otherwise."""
            mark("search start")
            rep = plan_fn(conditions)
            mark("search end")
            searched["report"] = rep
            searched["pinned"] = {r: v for r, v in pins.items()
                                  if rep.best_pattern.get(r) != v}
            rep.best_pattern = {**rep.best_pattern, **pins}
            return rep

        detector = DriftDetector(DriftConfig(
            window=8, bucket_l1=0.5, occupancy_delta=2.0, ratio_rel=100.0,
            hysteresis=2, cooldown=4))
        replanner = Replanner(plan_and_pin, config=ReplanConfig(
            on_drift=True, window=8), detector=detector,
            quarantine=offloader.quarantine)
        engine.attach_replanner(replanner)
        submitted: list = []            # (tick, prompt, max_new)
        tick_s: list = []
        busy: list = []                 # the tick admitted or decoded
        admitted: list = []             # requests the tick admitted
        decoded: list = []
        swap_counts = None

        def tick(reqs=()):
            nonlocal swap_counts
            for p, new in reqs:
                engine.submit(p, max_new_tokens=new)
                submitted.append((engine.ticks, p, new))
            t0 = time.perf_counter()
            swapped = engine.swaps
            engine.step()
            tick_s.append(time.perf_counter() - t0)
            if not engine.swaps:
                memory("before the swap tick")
            elif not swapped:
                memory("after the swap tick")
            ev = engine.stats(window=1)
            decoded.append(ev["decode_tokens"])
            admitted.append(ev["requests_admitted"])
            busy.append(bool(ev["decode_tokens"] or ev["requests_admitted"]))
            if engine.swaps and swap_counts is None:
                swap_counts = {c.__name__: c.launches for c in counters}

        for reqs in script:
            tick(reqs)
        # long-prompt traffic goes on (a short backlog, at most
        # REPLAN_MAX_EXTRA requests) until the swap has landed; an idle
        # engine ticks every 10 ms, as a server waiting for requests would
        extra, t_wait = 0, time.perf_counter()
        while (not engine.swaps
               and time.perf_counter() - t_wait < REPLAN_MAX_WAIT_S):
            if len(engine.queue) < 2 and extra < REPLAN_MAX_EXTRA:
                tick([(prompt(*REPLAN_LONG), SERVE_NEW_TOKENS)
                      for _ in range(2)])
                extra += 2
            elif engine.busy:
                tick()
            else:
                tick()
                time.sleep(0.01)
        print(f"replan timeline (s into the phase, engine tick): "
              + ", ".join(f"{k} {t - t13:.1f} ({n})"
                          for k, (t, n) in timeline.items()))
        if not engine.swaps:
            worker = replanner._thread
            frame = (sys._current_frames().get(worker.ident)
                     if worker is not None else None)
            print("replanner thread stack:\n" + ("".join(
                traceback.format_stack(frame)) if frame else "none"))
            raise AssertionError(f"replan: no swap after {extra} extra ticks "
                                 f"(replanner {replanner.stats()}, error "
                                 f"{replanner.last_error!r})")
        # one swap is the phase: the replanner takes no further trigger (an
        # idle engine's empty bucket mix would read as drift)
        replanner.close(600)
        # a post-swap batch of both buckets, then drain
        tick([(prompt(*REPLAN_LONG), SERVE_NEW_TOKENS),
              (prompt(*REPLAN_SHORT), 8)])
        while engine.busy:
            tick()
        rep13 = searched["report"]
        print(rep13.summary())
        print(f"search conditions {replanner.last_conditions}; pinned "
              f"{searched['pinned'] or 'nothing'}; replanner "
              f"{replanner.stats()}; canary: {replanner.last_canary_reason}; "
              f"error {replanner.last_error!r}")
    if replanner.last_error is not None:
        raise AssertionError(f"replan: {replanner.last_error!r}")
    after = {c.__name__: c.launches - swap_counts[c.__name__]
             for c in counters}
    swap_tick = engine.swap_ticks[0]
    med = statistics.median(t for t, b in zip(tick_s, busy) if b)
    # a tick's time is mostly its prefills: hold the swap tick against the
    # ticks that admitted as many requests
    alike = [t for t, b, a in zip(tick_s, busy, admitted)
             if b and a == admitted[swap_tick - 1]]
    med_alike = statistics.median(alike)
    pre = sum(decoded[:swap_tick - 1]) / max(sum(tick_s[:swap_tick - 1]),
                                             1e-9)
    post = sum(decoded[swap_tick - 1:]) / max(sum(tick_s[swap_tick - 1:]),
                                              1e-9)
    st = engine.stats()
    print(f"replan: drift fired {detector.fired}x; swap landed before tick "
          f"{swap_tick} of {engine.ticks} ({'a busy' if busy[swap_tick - 1] else 'an idle'}"
          f" tick admitting {admitted[swap_tick - 1]} request(s)): swap tick "
          f"{tick_s[swap_tick - 1] * 1e3:.1f} ms against a median of "
          f"{med_alike * 1e3:.1f} ms over the {len(alike)} ticks admitting as "
          f"many, and a median busy tick of {med * 1e3:.1f} ms (host clock, "
          f"{sum(busy)} busy of {len(tick_s)} ticks); {len(submitted)} "
          f"requests; decode {pre:.1f} tok/s before the swap, "
          f"{post:.1f} after; serving {engine.plan_impl.describe()}; launches "
          f"after the swap {after}; prefill captures {engine.prefill_traces}")
    if after["flash_attention"] <= 0 or after["rglru_scan"] <= 0:
        raise AssertionError(f"replan: the swapped-in generation launched "
                             f"{after}")
    done = engine.drain_finished()
    if (len(done) != len(submitted)
            or any(len(r.generated) != r.max_new_tokens for r in done)):
        raise AssertionError(f"replan: {len(done)} of {len(submitted)} "
                             "requests finished in full")
    # no fault of the searched plan rolled back to the plain one
    if st["rollbacks"] or st["degraded"]:
        raise AssertionError(f"replan: rolled back before the NaN segment "
                             f"({st['rollbacks']}, degraded {st['degraded']})"
                             f": {st['last_fault']}")
    memory("after the replanned traffic", release=True)

    # the device-side NaN fault: captured clean, armed, offered, rolled back
    fault = DeviceNaN("mlp_core", base=engine.plan_impl.pick("mlp_core"),
                      name="nan")
    try:
        good_key = engine.plan_key
        bad = engine.prepare_plan({**engine.plan_impl, "mlp_core": "nan"})
        memory("with the NaN generation captured", release=True)
        fault.arm()
        engine.offer_plan(bad)
        post_fault = [(prompt(*REPLAN_SHORT), 8),
                      (prompt(*REPLAN_LONG), SERVE_NEW_TOKENS),
                      (prompt(*REPLAN_SHORT), 8)]
        for p, new in post_fault:
            engine.submit(p, max_new_tokens=new)
        engine.run_to_completion()
    finally:
        fault.close()
    st = engine.stats()
    fault_done = engine.drain_finished()
    del bad                     # the faulted generation left the trace memo
    memory("after the rollback", release=True)
    print("phase 13 memory allocated / peak / reserved: " + "; ".join(
        f"{k} {a:.3f} / {m:.3f} / {r:.3f} GiB"
        for k, (a, m, r) in mem13.items()))
    if (mem13["after the rollback"][2]
            > mem13["after the replanned traffic"][2] + 0.05):
        raise AssertionError("replan: the faulted generation's graphs were "
                             "not freed")
    print(f"NaN generation: rollbacks {st['rollbacks']}, degraded "
          f"{st['degraded']}, last fault {st['last_fault']!r}; "
          f"{len(fault_done)} of {len(post_fault)} requests finished; "
          f"strikes {offloader.quarantine.strikes()}")
    if (st["rollbacks"] != 1 or not st["degraded"]
            or engine.plan_key != good_key or len(fault_done) != len(post_fault)
            or any(len(r.generated) != r.max_new_tokens for r in fault_done)):
        raise AssertionError(f"replan: the NaN generation was not rolled back "
                             f"cleanly: {st}")

    # the never-swapped twins: the old plan and the new one, fed the same
    # submissions tick for tick; a request's stream must equal the twin's
    # of the plan it was prefilled under (the decode steps of the two plans
    # run the same arithmetic: the canary held them bit for bit)
    if "bit-equal" not in (replanner.last_canary_reason or ""):
        raise AssertionError(f"replan: the canary did not find the same "
                             f"decode arithmetic: {replanner.last_canary_reason}")
    twin_streams = {}
    for label, timpl in (("old", None), ("new", engine.plan_impl)):
        twin = ServeEngine(ncfg, params, slots=SERVE_SLOTS, ctx=SERVE_CTX,
                           seed=0, impl=timpl)
        i = 0
        for t in range(max(s[0] for s in submitted) + 1):
            while i < len(submitted) and submitted[i][0] == t:
                twin.submit(submitted[i][1], max_new_tokens=submitted[i][2])
                i += 1
            twin.step()
        for p, new in post_fault:
            twin.submit(p, max_new_tokens=new)
        twin_streams[label] = [r.generated for r in twin.run_to_completion()]
        del twin
        gc.collect()
    got = done + fault_done
    mismatched = [r.rid for r in got
                  if r.generated != twin_streams[
                      "old" if r.plan_generation == 0 else "new"][r.rid]]
    print(f"streams: {len(got)} requests ({sum(r.plan_generation == 0 for r in got)}"
          f" prefilled before the swap) against the never-swapped twins: "
          f"{len(got) - len(mismatched)} equal")
    if mismatched:
        raise AssertionError(f"replan: streams of requests {mismatched} differ "
                             "from the never-swapped twins'")
    replan_launches = {c.__name__: c.launches for c in counters}
    print(f"launches in phase 13: {replan_launches}; phase wall "
          f"{time.perf_counter() - t13:.1f} s")
    del engine, params
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 14. serve full-width Mixtral-8x7B (slice-9 main path) ---------
    phase("14. serve mixtral-8x7b")
    t14 = time.perf_counter()
    full_moe = get_config(MOE_ARCH)
    moe_cfg = dataclasses.replace(full_moe, num_layers=MOE_LAYERS)
    per_layer = ((full_moe.param_count() - moe_cfg.param_count())
                 / (full_moe.num_layers - MOE_LAYERS))
    card_gib = torch.cuda.get_device_properties(dev).total_memory / 2**30
    print(f"{MOE_ARCH}: {full_moe.param_count() / 1e9:.3f} B parameters at "
          f"{full_moe.num_layers} layers ({per_layer / 1e9:.3f} B a layer), "
          f"{2 * full_moe.param_count() / 2**30:.1f} GiB in bf16, more than "
          f"the card's {card_gib:.1f} GiB; cut to {MOE_LAYERS} layers: "
          f"{moe_cfg.param_count() / 1e9:.3f} B, "
          f"{2 * moe_cfg.param_count() / 2**30:.1f} GiB")
    # the prefill is held by the rule of models/moe_check.py on the six
    # draws of its seed rule, the floor being offload (which takes ref's
    # single tile up to 512 tokens) and attention in 2 x 2 chunks at every
    # bucket
    def moe_prefill_check(params, ncfg, impl):
        attn = variants("attn_core")
        floors = {"offload": attn["offload"],
                  "halves": lambda q, k, v, **kw: L.chunked_attention(
                      q, k, v, q_chunk=max(q.shape[2] // 2, 1),
                      k_chunk=max(k.shape[2] // 2, 1), **kw)}
        results = []
        for length, seed in DRAWS:
            prompt, _ = F.synthetic_request(ncfg, length, seed=seed)
            res = check_moe_prefill(params, ncfg, prompt, ctx=SERVE_CTX,
                                    attn=attn["hopper"], floors=floors,
                                    impl=impl)
            print(f"  draw (seed {seed}, {length} tokens): {res.line()}")
            results.append(res)
        print(f"MoE prefill rule over {len(DRAWS)} draws (seeds "
              f"{[s for _, s in DRAWS]}): kernel on ref's inputs max err "
              f"{max(r.kernel_err for r in results):.3e}; logits on ref's "
              f"picks {[f'{r.pinned_diff:.3e}' for r in results]} vs tols "
              f"{[f'{r.pinned_tol:.3e}' for r in results]}; flips "
              f"{[sum(r.flips) for r in results]}, L "
              f"{[r.first_flip for r in results]}; free logits "
              f"{[f'{r.free_diff:.3e}' for r in results]} [{card}]")
        bad = [seed for (_, seed), r in zip(DRAWS, results) if not r.ok]
        if bad:
            raise AssertionError(f"serve {MOE_ARCH}: the MoE prefill rule "
                                 f"failed on the draws of seeds {bad}")

    moe_launches = serve_arch(MOE_ARCH, ("attn_core",), SHORT_MIX,
                              ncfg=moe_cfg, check_prefill=moe_prefill_check)
    if moe_launches["flash_attention"] <= 0:
        raise AssertionError("flash_attention was not launched serving "
                             f"{MOE_ARCH}")

    # the routed block of one full-width layer: moe_dispatch ref (dense
    # one-hot) against offload (scatter slots), expert 0 favoured by every
    # token so that its queue overflows and tokens drop
    d, e = full_moe.d_model, full_moe.num_experts
    f, k = full_moe.moe_d_ff or full_moe.d_ff, full_moe.experts_per_token
    g14 = torch.Generator(device=dev).manual_seed(14)

    def normal(*shape, fan_in):
        return (torch.randn(shape, generator=g14, device=dev)
                / math.sqrt(fan_in)).to(torch.bfloat16)

    x = normal(MOE_TOKENS, d, fan_in=1)
    x[:, 0] = x[:, 0].abs() + 1
    moe_args = (x, normal(d, e, fan_in=d), normal(e, d, f, fan_in=d),
                normal(e, d, f, fan_in=d), normal(e, f, d, fan_in=f))
    moe_args[1][0, 0] = 1
    cap = moe_capacity(MOE_TOKENS, e, k, full_moe.capacity_factor)
    kw = {"num_experts": e, "k": k, "capacity": cap}
    dispatch_fns = variants("moe_dispatch")
    got = dispatch_fns["offload"](*moe_args, **kw)
    want = dispatch_fns["ref"](*moe_args, **kw)
    keep = route_tokens(x, moe_args[1], e, k, cap)[4]
    assert_close(torch, got.float(), want.float(),
                 f"moe_dispatch offload vs ref at [{MOE_TOKENS}, {d}]",
                 rtol=MOE_TOL, atol=MOE_TOL)
    moe_ms = {v: cuda_ms(torch, lambda v=v: dispatch_fns[v](*moe_args, **kw),
                         calls=2, groups=5)
              for v in ("ref", "offload")}
    print(f"moe_dispatch at [{MOE_TOKENS}, {d}] x {e} experts [{d}, {f}] "
          f"bf16, top-{k}, capacity {cap}: {int((~keep).sum())} of "
          f"{keep.numel()} choices dropped; offload vs ref max abs err "
          f"{max_abs_err(torch, got.float(), want.float()):.3e} (tol "
          f"{MOE_TOL}), max |ref| {float(want.abs().max()):.3f}; ref "
          f"{moe_ms['ref'][0]:.3f} ms {moe_ms['ref'][1]}, offload "
          f"{moe_ms['offload'][0]:.3f} ms {moe_ms['offload'][1]} (CUDA "
          "events, eager)")
    if bool(keep.all()):
        raise AssertionError("moe_dispatch: the capacity dropped no token")
    del x, moe_args, got, want, keep
    torch.cuda.empty_cache()

    # static extraction of the unannotated reduced model: the routed block
    # is rediscovered as moe_dispatch, planned, and run with rmsnorm=hopper
    for counter in counters:
        counter.launches = 0
    fn14, args14 = loop_extraction.trace_arch(MOE_ARCH, device=dev)
    t0 = time.perf_counter()
    prog = discover(fn14, args14, name=MOE_ARCH)
    print(prog.extraction.summary().splitlines()[0])
    print(f"discovered reduced {MOE_ARCH} at {list(args14[0].shape)} in "
          f"{time.perf_counter() - t0:.1f} s: regions "
          + ", ".join(f"{r.name} {r.arg_signature()} {r.static_kwargs}"
                      for r in prog.regions))
    missing = {"moe_dispatch", "attn_core", "rmsnorm"} - {
        r.name for r in prog.regions}
    if missing:
        raise AssertionError(f"extract {MOE_ARCH}: {sorted(missing)} not "
                             "discovered")
    with tempfile.TemporaryDirectory() as tmp:
        cache = PlanCache(Path(tmp) / "plans.json")
        report = AutoOffloader(cfg).plan(prog, cache=cache)
        print(report.summary())
        if not report.baseline.ok:
            raise AssertionError(f"{prog.name}: unsound plan")
        again = AutoOffloader(cfg).plan(prog, cache=cache)
        if not again.from_cache or again.measurements:
            raise AssertionError(f"{prog.name}: re-plan was not a cache hit")
    ref = prog.build(Impl())(*args14)
    floor_impl = Impl({r.name: "offload" for r in prog.regions
                       if "+" not in r.name and "offload" in variants(r.name)})
    register_variant("rmsnorm", "torch_rms_norm")(
        lambda x, w, eps=1e-6: torch.nn.functional.rms_norm(
            x.float(), (x.shape[-1],), 1.0 + w.float(), eps).to(x.dtype))
    try:
        floors = {
            i.describe(): float((prog.build(i)(*args14) - ref).abs().max())
            for i in (floor_impl, Impl({"rmsnorm": "torch_rms_norm"}))}
    finally:
        unregister_variant("rmsnorm", "torch_rms_norm")
    tol = max(LOGIT_NOISE_FACTOR * max(floors.values()), LOGIT_TOL_MIN)
    run = Impl({**report.best_impl(), "rmsnorm": "hopper"})
    before = RN.rmsnorm.launches
    hop = prog.build(run)(*args14)
    torch.cuda.synchronize()
    per_forward = RN.rmsnorm.launches - before
    diff = float((hop - ref).abs().max())
    print(f"reduced {MOE_ARCH} with {run.describe()} vs the captured "
          f"program: max abs diff {diff:.3e}; noise floor {floors}; tol "
          f"{tol:.3e}; argmax agrees at "
          f"{float((hop.argmax(-1) == ref.argmax(-1)).float().mean()):.4f} "
          f"of positions; {per_forward} rmsnorm launches a forward")
    if not bool(torch.isfinite(hop).all()) or diff > tol:
        raise AssertionError(f"extract {MOE_ARCH}: logits differ by "
                             f"{diff:.3e} > {tol:.3e} or are non-finite")
    moe_extract = {c.__name__: c.launches for c in counters}
    reduced_layers = get_config(MOE_ARCH).reduced().num_layers
    if moe_extract["rmsnorm"] <= 0 or per_forward != 2 * reduced_layers + 1:
        raise AssertionError(f"rmsnorm was not launched running {MOE_ARCH}")
    print(f"launches in phase 14: serving {moe_launches}; extraction "
          f"{moe_extract}; phase wall {time.perf_counter() - t14:.1f} s")
    rows["flash_attention"]["launches"] += moe_launches["flash_attention"]
    rows["rmsnorm"]["launches"] += moe_extract["rmsnorm"]
    del prog, report, again, ref, hop, fn14, args14
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 15. serve whisper-small (slice-10 main path, audio frontend) --
    phase("15. serve whisper-small")
    t15 = time.perf_counter()
    hopper_genes = {}

    def whisper_plan(report):
        """Cross-attention has s != sk, which the flash kernel refuses:
        a measured pattern with attn_core=hopper must have failed, and
        the selected one must not hold it."""
        hop = [m for m in report.measurements
               if (m.mapping() or {}).get("attn_core") == "hopper"]
        hopper_genes["measured"] = len(hop)
        print(f"attn_core=hopper: {len(hop)} measured pattern(s), "
              + ("every one failed" if hop else "none proposed by Step 4")
              + "; selected " + (report.best_impl().describe() or "all-ref"))
        if any(m.ok for m in hop):
            raise AssertionError("whisper: a pattern with attn_core=hopper "
                                 "did not fail")
        if report.best_impl().get("attn_core") == "hopper":
            raise AssertionError("whisper: the selected pattern holds "
                                 "attn_core=hopper")

    enc_launches = {}

    def whisper_encode(params, ncfg):
        """The encoder at full width under attn_core=hopper against ref:
        one bidirectional flash launch per layer, held to the rule of the
        prefill logits (3x the offload-vs-ref floor, at least 0.05)."""
        frames = torch.from_numpy(F.synthetic_request(
            ncfg, 8, seed=150)[1][None]).to(dev)
        out = {}
        for variant in ("offload", "ref", "hopper"):
            for counter in counters:
                counter.launches = 0
            t0 = time.perf_counter()
            out[variant] = lm.encode(params, frames, cfg=ncfg,
                                     impl=Impl({"attn_core": variant}))
            torch.cuda.synchronize()
            if variant == "hopper":
                enc_launches.update({c.__name__: c.launches
                                     for c in counters})
                enc_launches["seconds"] = time.perf_counter() - t0
        floor = float((out["offload"] - out["ref"]).abs().max())
        diff = float((out["hopper"] - out["ref"]).abs().max())
        tol = max(LOGIT_NOISE_FACTOR * floor, LOGIT_TOL_MIN)
        print(f"encode [1, {ncfg.frontend_seq}, {ncfg.frontend_dim}] frames "
              f"-> {list(out['hopper'].shape)} under attn_core=hopper: max "
              f"|hopper - ref| {diff:.3e}, noise floor (offload vs ref) "
              f"{floor:.3e}, tol {tol:.3e}; max |ref| "
              f"{float(out['ref'].abs().max()):.3f}; flash launches "
              f"{enc_launches['flash_attention']}")
        if not bool(torch.isfinite(out["hopper"]).all()) or diff > tol:
            raise AssertionError(f"whisper encode: hopper and ref differ by "
                                 f"{diff:.3e} > {tol:.3e} or non-finite")
        if enc_launches["flash_attention"] != ncfg.encoder_layers:
            raise AssertionError(f"whisper encode launched flash "
                                 f"{enc_launches['flash_attention']} times, "
                                 f"not {ncfg.encoder_layers}")

    whisper_launches = serve_arch(
        WHISPER_ARCH, (), lengths=WHISPER_PROMPTS, buckets=WHISPER_BUCKETS,
        ctx=WHISPER_CTX, on_plan=whisper_plan, with_model=whisper_encode)
    # the cross-attention of a prefill under attn_core=hopper: the wrapper
    # raises, and no plain version runs in the kernel's place
    small = get_config(WHISPER_ARCH).reduced()
    small_params = F.init_params(small, torch.Generator(device=dev)
                                 .manual_seed(0))
    plain_calls = []
    plain = FA.flash_attention_plain
    FA.flash_attention_plain = lambda *a, **kw: (plain_calls.append(1),
                                                 plain(*a, **kw))[1]
    before = FA.flash_attention.launches
    try:
        step = F.make_bucketed_prefill_step(
            small, impl=Impl({"attn_core": "hopper"}), ctx=32)
        tokens, frames = F.synthetic_request(small, 5, seed=151)
        padded = np.zeros((1, 8), np.int32)
        padded[0, :5] = tokens
        step(small_params, {"tokens": torch.from_numpy(padded).to(dev),
                            "frames": torch.from_numpy(frames[None]).to(dev)},
             5)
        raise AssertionError("whisper prefill under attn_core=hopper did "
                             "not raise")
    except ValueError as err:
        if "self-attention" not in str(err):
            raise
        print(f"reduced whisper prefill under attn_core=hopper raised, as "
              f"it must: {err}; flash launches before the raise "
              f"{FA.flash_attention.launches - before} (the encoder's and "
              f"the decoder's self-attention), plain versions run "
              f"{len(plain_calls)}")
    finally:
        FA.flash_attention_plain = plain
    if plain_calls:
        raise AssertionError("a plain flash version ran under "
                             "attn_core=hopper")
    del small_params
    print(f"launches in phase 15: serving {whisper_launches}; encode "
          f"{enc_launches}; phase wall {time.perf_counter() - t15:.1f} s "
          f"[{card}]")

    # ---- 16. serve paligemma-3b (slice-10 main path, SigLIP prefix) ----
    phase("16. serve paligemma-3b")
    t16 = time.perf_counter()
    pali_launches = serve_arch(PALI_ARCH, ("attn_core",),
                               lengths=PALI_PROMPTS, buckets=PALI_BUCKETS,
                               ctx=SERVE_CTX)
    if pali_launches["flash_attention"] <= 0:
        raise AssertionError("flash_attention was not launched serving "
                             f"{PALI_ARCH}")
    print(f"launches in phase 16: {pali_launches}; phase wall "
          f"{time.perf_counter() - t16:.1f} s [{card}]")
    rows["flash_attention"]["launches"] += (enc_launches["flash_attention"]
                                            + pali_launches["flash_attention"])
    print(f"flash_attention 3w (whisper encoder, bidirectional, [1, 12/12, "
          f"1,500, 64]): {json.dumps(flash_whisper)}; launches: phase 15's "
          f"encode {enc_launches['flash_attention']}, phase 16's serving "
          f"{pali_launches['flash_attention']} [{card}]")

    print(f"flash_attention 3p (paligemma, causal GQA 8:1 at head_dim 256, "
          f"S = 272 / 768 / 2,080): {json.dumps(flash_pali)}; launches: "
          f"phase 16's serving {pali_launches['flash_attention']} [{card}]")

    # ---- 17. the launchers and the benchmark harness (slice 11) --------
    phase("17. launchers")
    t17 = time.perf_counter()
    from repro_torch.launch import (offload_fir, offload_mriq,
                                    offload_transformer, quickstart, serve_lm,
                                    trend)
    from repro_torch.launch import run as bench_run
    for counter in counters:
        counter.launches = 0
    cache_env = os.environ.get("REPRO_TORCH_PLAN_CACHE")
    steps17 = {}

    def step17(name, fn):
        t0 = time.perf_counter()
        out = fn()
        steps17[name] = round(time.perf_counter() - t0, 1)
        return out

    with tempfile.TemporaryDirectory() as tmp17:
        os.environ["REPRO_TORCH_PLAN_CACHE"] = str(Path(tmp17) / "plans.json")
        try:
            for again in (False, True):
                rep17 = step17(
                    f"quickstart{' (cache)' if again else ''}",
                    lambda: quickstart.main(["--size", str(QUICKSTART_SIZE),
                                             "--reps", "1"]))
                if rep17.from_cache != again:
                    raise AssertionError(f"quickstart: from_cache "
                                         f"{rep17.from_cache}, want {again}")
            for name, mod in (("offload_fir", offload_fir),
                              ("offload_mriq", offload_mriq)):
                res = step17(name, lambda mod=mod: mod.main(
                    ["--reps", str(LAUNCHER_REPS)]))
                if res["max_abs_err"] is None or not res["report"].baseline.ok:
                    raise AssertionError(f"{name}: the hopper kernel was not "
                                         "validated or the plan is unsound")
            step17("offload_transformer", lambda: offload_transformer.main(
                ["--reps", "1", "--no-cache"]))
            served = step17("serve_lm", lambda: serve_lm.main(
                ["--arch", HYBRID_ARCH, "--requests", "4", "--prompt-len",
                 "32", "--new-tokens", "16", "--temperature", "0.7",
                 "--top-k", "20"]))
            if (served["stats"]["requests_finished"] != 4
                    or served["stats"]["rollbacks"]):
                raise AssertionError(f"serve_lm: {served['stats']}")
            del served
            gc.collect()
            torch.cuda.empty_cache()
            bench = Path(tmp17) / "bench"
            sections = ("conditions", "kernels")
            for section in sections:
                out17 = step17(section, lambda section=section: bench_run.main(
                    ["--section", section, "--json", "--out", str(bench),
                     "--reps", str(LAUNCHER_REPS)]))
            hop = [r for r in out17["kernels"] if r["name"].endswith("/hopper")]
            print(f"kernel_bench hopper rows: "
                  f"{[(r['name'], r['launches']) for r in hop]}")
            silent = [r["name"] for r in hop
                      if not (r["ran"] and r["launches"] > 0)]
            if len(hop) != 3 or silent:
                raise AssertionError(f"kernel_bench: hopper rows {silent} "
                                     f"launched no kernel ({len(hop)} rows)")
            docs = {json.loads(f.read_text())["section"]: f.name
                    for f in sorted(bench.glob("BENCH_*.json"))}
            print(f"BENCH documents written and read back: {docs}")
            if set(docs) != set(sections):
                raise AssertionError(f"BENCH documents {sorted(docs)}, want "
                                     f"{sorted(sections)}")
            rc_first = trend.main(["--baseline", str(Path(tmp17) / "none"),
                                   "--current", str(bench)])
            rc_self = trend.main(["--baseline", str(bench), "--current",
                                  str(bench)])
            print(f"trend: no baseline -> exit {rc_first}; against itself -> "
                  f"exit {rc_self}")
            if rc_first != 0 or rc_self != 0:
                raise AssertionError("trend: a first run or a run against "
                                     "itself must exit 0")
        finally:
            if cache_env is None:
                os.environ.pop("REPRO_TORCH_PLAN_CACHE", None)
            else:
                os.environ["REPRO_TORCH_PLAN_CACHE"] = cache_env
    launcher_launches = {c.__name__: c.launches for c in counters}
    print(f"launches in phase 17: {launcher_launches}; seconds per step "
          f"{steps17}; phase wall {time.perf_counter() - t17:.1f} s [{card}]")
    for name, count in launcher_launches.items():
        rows[name]["launches"] += count

    # ---- 18. one-card training (slice-12 main path) --------------------
    phase("18. train")
    t18 = time.perf_counter()
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs.base import SHAPES
    from repro_torch.data.pipeline import SyntheticLM, to_device
    from repro_torch.launch import train_lm
    from repro_torch.models.params import tree_map
    from repro_torch.optim.schedule import constant
    from repro_torch.parallel.presets import parallelism_for
    from repro_torch.runtime import steps as train_steps
    from repro_torch.runtime.loop import LoopConfig, run_training
    for counter in counters:
        counter.launches = 0
    gib = 2 ** 30
    lr_fn = lambda step: constant(step, peak_lr=TRAIN_LR)
    rg = get_config(HYBRID_ARCH)
    pcfg = parallelism_for(rg, SHAPES["train_4k"], model_axis=1)
    if (pcfg.remat, pcfg.microbatch) != ("dots", 1):
        raise AssertionError(f"train preset of {HYBRID_ARCH}: {pcfg}")
    t0 = time.perf_counter()
    state = train_steps.init_train_state(
        rg, torch.Generator(device=dev).manual_seed(18))
    torch.cuda.synchronize()
    print(f"{HYBRID_ARCH} at full width and depth ({rg.num_layers} layers, "
          f"d_model {rg.d_model}, vocab {rg.vocab_size:,}): "
          f"{rg.param_count() / 1e9:.3f} B parameters; state (bf16 params, "
          f"float32 moments) drawn in {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated(dev) / gib:.2f} GiB; preset {pcfg}; "
          f"batch {TRAIN_BATCH} x {TRAIN_SEQ}, constant lr {TRAIN_LR}")
    data = SyntheticLM(rg, TRAIN_BATCH, TRAIN_SEQ, seed=18)
    steps18 = {mode: train_steps.make_train_step(
        rg, dataclasses.replace(pcfg, remat=mode), lr_fn=lr_fn)
        for mode in ("dots", "full")}
    losses, norms, secs = [], [], []
    torch.cuda.reset_peak_memory_stats(dev)
    for _ in range(TRAIN_STEPS):
        batch = to_device(next(data), dev)
        t0 = time.perf_counter()
        state, metrics = steps18["dots"](state, batch)
        losses.append(metrics["loss"].item())
        norms.append(metrics["grad_norm"].item())
        secs.append(time.perf_counter() - t0)
    peak18 = torch.cuda.max_memory_allocated(dev) / gib
    print(f"{TRAIN_STEPS} steps under dots: losses "
          f"{[round(x, 4) for x in losses]}; grad norms "
          f"{[round(x, 3) for x in norms]}; seconds a step "
          f"{[round(x, 2) for x in secs]}; peak {peak18:.2f} GiB [{card}]")
    if not all(math.isfinite(x) for x in losses + norms) or not (
            losses[-1] < losses[0]):
        raise AssertionError(f"train {HYBRID_ARCH}: the loss is not finite or "
                             f"did not fall: {losses}")
    # one more step from the same state under each mode: the state is
    # updated in place, so it is kept on the host and copied back between
    batch = to_device(next(data), dev)
    t0 = time.perf_counter()
    saved = tree_map(lambda t: t.to("cpu", copy=True), state)
    print(f"state copied to the host in {time.perf_counter() - t0:.1f} s")
    modes18 = {}
    for mode in ("dots", "full"):
        for dst, src in zip(tree_leaves(state), tree_leaves(saved)):
            dst.copy_(src)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        _, metrics = steps18[mode](state, batch)
        modes18[mode] = (metrics["loss"].item(), metrics["grad_norm"].item(),
                         torch.cuda.max_memory_allocated(dev) / gib,
                         time.perf_counter() - t0)
    print("step 9 from one state: " + "; ".join(
        f"{mode}: loss {v[0]!r}, grad norm {v[1]!r}, peak {v[2]:.2f} GiB, "
        f"{v[3]:.2f} s" for mode, v in modes18.items()) + f" [{card}]")
    (loss_d, norm_d, *_), (loss_f, norm_f, *_) = modes18.values()
    if loss_f != loss_d or abs(norm_f - norm_d) > GRAD_NORM_RTOL * norm_d:
        raise AssertionError(f"train {HYBRID_ARCH}: full remat gives loss "
                             f"{loss_f!r} / grad norm {norm_f!r} against dots' "
                             f"{loss_d!r} / {norm_d!r}")
    del state, saved, batch, steps18, metrics
    gc.collect()
    torch.cuda.empty_cache()

    # whisper-small: 10 steps with a checkpoint every 5, then a second run
    # to 15 that restores step 10 (and the data position) and runs 5 steps
    wh = get_config(WHISPER_ARCH)
    wpcfg = parallelism_for(wh, SHAPES["train_4k"], model_axis=1)
    with tempfile.TemporaryDirectory() as tmp18:
        ck = CheckpointManager(tmp18, keep_n=2)
        runs18 = []
        for total in (WHISPER_STEPS, WHISPER_RESTART):
            t0 = time.perf_counter()
            res = run_training(
                wh, wpcfg, dev, SyntheticLM(wh, *WHISPER_TRAIN, seed=19),
                LoopConfig(total_steps=total, checkpoint_every=5, log_every=0),
                ckpt=ck, seed=19, lr_fn=lr_fn)
            runs18.append((res, time.perf_counter() - t0))
            print(f"{WHISPER_ARCH} run to {total}: restored from "
                  f"{res.restored_from}, {len(res.losses)} steps, losses "
                  f"{[round(x, 4) for x in res.losses]}, median step "
                  f"{statistics.median(res.step_times):.3f} s, wall "
                  f"{runs18[-1][1]:.1f} s, stragglers {res.straggler_events}; "
                  f"checkpoints {sorted(os.listdir(tmp18))}")
        first, second = runs18[0][0], runs18[1][0]
        if (first.final_step != WHISPER_STEPS or first.restored_from is not None
                or second.restored_from != WHISPER_STEPS
                or len(second.losses) != WHISPER_RESTART - WHISPER_STEPS
                or second.final_step != WHISPER_RESTART
                or not all(map(math.isfinite, first.losses + second.losses))):
            raise AssertionError(f"train {WHISPER_ARCH}: the restart did not "
                                 "resume at step 10 for 5 finite steps")
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp18:
        t0 = time.perf_counter()
        res = train_lm.main(["--steps", str(TRAIN_LM_STEPS), "--ckpt-dir",
                             tmp18, "--device", str(dev)])
        print(f"train_lm: {len(res.losses)} steps in "
              f"{time.perf_counter() - t0:.1f} s, loss {res.losses[0]:.4f} -> "
              f"{res.losses[-1]:.4f} [{card}]")
        if not res.losses[-1] < res.losses[0]:
            raise AssertionError("train_lm: the loss did not fall")
    train_launches = {c.__name__: c.launches for c in counters}
    print(f"launches in phase 18: {train_launches} (the train step takes the "
          f"ref/offload variants); phase wall {time.perf_counter() - t18:.1f} s")
    if any(train_launches.values()):
        raise AssertionError("a hopper kernel launched in a train step")
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 19. int8 weight-only decode (slice-12 main path) --------------
    phase("19. int8 decode")
    t19 = time.perf_counter()
    from repro_torch.optim import quantize as Q
    for counter in counters:
        counter.launches = 0
    q8 = dataclasses.replace(full_moe, num_layers=QUANT_LAYERS)
    params = F.init_params(q8, torch.Generator(device=dev).manual_seed(19))
    prompts = {"tokens": torch.from_numpy(F.synthetic_batch(
        q8, SERVE_SLOTS, QUANT_PROMPT, seed=190)["tokens"]).to(dev)}
    logits, cache = F.make_prefill_step(q8, ctx=SERVE_CTX)(params, prompts)
    qparams = Q.quantize_params(params)
    deq = Q.dequantize_params(qparams)
    torch.cuda.synchronize()
    orig_b, quant_b = Q.quantized_bytes(lm.model_template(q8))
    print(f"{MOE_ARCH} with {QUANT_LAYERS} of {full_moe.num_layers} layers: "
          f"{orig_b / 1e9:.2f} GB bf16, {quant_b / 1e9:.2f} GB int8 "
          f"(quantized_bytes); allocated "
          f"{torch.cuda.memory_allocated(dev) / gib:.2f} GiB with the bf16, "
          "int8 and dequantized trees")
    cache_q, cache_d = (tree_map(torch.clone, cache) for _ in range(2))
    serve, qserve = F.make_serve_step(q8), F.make_quantized_serve_step(q8)
    # every path takes the bf16 step's greedy token, so each step compares
    # logits of the same context
    tok = logits[:, -1].argmax(-1).to(torch.int32)
    cosines, agree, margins, errs = [], [], [], []
    for i in range(QUANT_CHECK_STEPS):
        pos = torch.full((SERVE_SLOTS,), QUANT_PROMPT + i, dtype=torch.int32,
                         device=dev)
        lg, cache = serve(params, cache, tok[:, None], pos)
        lg_q, cache_q = qserve(qparams, cache_q, tok[:, None], pos)
        lg_d, cache_d = serve(deq, cache_d, tok[:, None], pos)
        if not torch.equal(lg_q, lg_d):
            raise AssertionError(
                f"int8 {MOE_ARCH} decode step {i}: the at-use dequantized "
                f"step differs from the step on the dequantized tree by "
                f"{float((lg_q - lg_d).abs().max()):.3e}")
        a, b = lg[:, 0].float(), lg_q[:, 0].float()
        cos = (a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1))
        top2 = a.topk(2, dim=-1).values
        cosines.append([round(float(c), 6) for c in cos])
        agree.append((a.argmax(-1) == b.argmax(-1)).tolist())
        margins.append([round(float(m), 4) for m in top2[:, 0] - top2[:, 1]])
        errs.append([round(float(e), 4) for e in (a - b).abs().amax(-1)])
        if float(cos.min()) <= QUANT_MIN_COSINE:
            raise AssertionError(f"int8 {MOE_ARCH} decode step {i}: cosine "
                                 f"{cosines[-1]} against bf16")
        tok = a.argmax(-1).to(torch.int32)
    print(f"int8 against bf16, {QUANT_CHECK_STEPS} greedy decode steps from "
          f"one [{SERVE_SLOTS}, {QUANT_PROMPT}] bf16 prefill (the bf16 "
          f"step's tokens fed to every path): the int8 step equals the bf16 "
          f"step on the dequantized tree bit for bit at every step; cosine "
          f"to bf16 per slot {cosines} (> {QUANT_MIN_COSINE}); argmax equal "
          f"{agree}; bf16 top-1 minus top-2 logit {margins}; max |int8 - "
          f"bf16| logit {errs} [{card}]")
    del params, qparams, deq, cache, cache_q, cache_d, logits, lg, lg_q, lg_d
    gc.collect()
    torch.cuda.empty_cache()

    # all 32 layers in int8 alone, drawn and quantized one layer slice at
    # a time (no bf16 stacked leaf is ever whole)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    qfull = Q.init_quantized(lm.model_template(full_moe),
                             torch.Generator(device=dev).manual_seed(191))
    torch.cuda.synchronize()
    q_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(qfull))
    print(f"{MOE_ARCH} at all {full_moe.num_layers} layers in int8: "
          f"{q_bytes / 1e9:.2f} GB drawn and quantized in "
          f"{time.perf_counter() - t0:.1f} s; peak so far "
          f"{torch.cuda.max_memory_allocated(dev) / gib:.2f} GiB")
    t0 = time.perf_counter()
    logits, cache = F.make_prefill_step(full_moe, ctx=SERVE_CTX)(
        F.dequantize_outside_stack(qfull, full_moe), prompts)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    cache_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(cache))
    qserve = F.make_quantized_serve_step(full_moe)
    tok = logits[:, -1].argmax(-1).to(torch.int32)
    step_s, streams = [], [tok.tolist()]
    for i in range(QUANT_DECODE_STEPS):
        pos = torch.full((SERVE_SLOTS,), QUANT_PROMPT + i, dtype=torch.int32,
                         device=dev)
        t0 = time.perf_counter()
        lg, cache = qserve(qfull, cache, tok[:, None], pos)
        tok = lg[:, 0].argmax(-1).to(torch.int32)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        streams.append(tok.tolist())
        if not bool(torch.isfinite(lg).all()):
            raise AssertionError(f"int8 {MOE_ARCH}: non-finite logits at "
                                 f"decode step {i}")
    step_ms = statistics.median(step_s) * 1e3
    pos = torch.full((SERVE_SLOTS,), QUANT_PROMPT + QUANT_DECODE_STEPS,
                     dtype=torch.int32, device=dev)
    trace, device_ms = profile_step(
        torch, lambda: qserve(qfull, cache, tok[:, None], pos), step_ms)
    bound_ms = (q_bytes + cache_bytes) / HBM_BYTES_PER_S * 1e3
    print(f"int8 decode, {SERVE_SLOTS} slots at ctx {SERVE_CTX}, "
          f"{QUANT_DECODE_STEPS} greedy steps after a [{SERVE_SLOTS}, "
          f"{QUANT_PROMPT}] prefill ({prefill_s:.1f} s): step "
          f"{step_ms:.3f} ms median on the host clock (synchronized); "
          f"{trace}; weight-streaming bound {bound_ms:.3f} ms (int8 "
          f"{q_bytes / 1e9:.2f} GB with scales + cache {cache_bytes / 1e9:.2f} "
          "GB, once, at 3.35 TB/s)"
          + (f", device time / bound {device_ms / bound_ms:.2f}x"
             if device_ms else "")
          + f"; peak {torch.cuda.max_memory_allocated(dev) / gib:.2f} GiB "
          f"[{card}]")
    print(f"greedy tokens per slot: {[list(s) for s in zip(*streams)]}")
    quant_launches = {c.__name__: c.launches for c in counters}
    print(f"launches in phase 19: {quant_launches}; phase wall "
          f"{time.perf_counter() - t19:.1f} s")
    del qfull, cache, logits, lg, prompts
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 20. the mesh path (slice 13) -----------------------------------
    phase("20. mesh")
    t20 = time.perf_counter()
    mesh_phase(torch, dev, card, counters, lr_fn, pcfg,
               losses[:MESH_TRAIN_STEPS], norms[:MESH_TRAIN_STEPS],
               secs[:MESH_TRAIN_STEPS], peak18)
    print(f"phase wall {time.perf_counter() - t20:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 21. the timing twins (slice 14) -------------------------------
    phase("21. timing twins")
    t21 = time.perf_counter()
    out21 = ROOT / "chiprun_out"
    for counter in counters:
        counter.launches = 0
    for section in TWIN_SECTIONS:
        t0 = time.perf_counter()
        bench_run.main(["--section", section, "--json", "--out", str(out21)]
                       + (["--arch", ARCH] if section == "faults" else []))
        doc = json.loads((out21 / f"BENCH_{section}.json").read_text())
        print(f"{section}: {time.perf_counter() - t0:.1f} s; backend "
              f"{doc['backend']} [{card}]")
        keep = ("patterns", "run_seconds", "compile_seconds")
        for row in doc["rows"]:
            print("  " + json.dumps({k: v for k, v in row.items()
                                     if k not in keep}))
        for extra in ("workers_determinism", "warm_cache"):
            if extra in doc:
                print(f"  {extra}: {json.dumps(doc[extra])}")
    twin_launches = {c.__name__: c.launches for c in counters}
    print(f"launches in phase 21: {twin_launches}; phase wall "
          f"{time.perf_counter() - t21:.1f} s [{card}]")
    for name in ("fir_filter_bank", "decode_attention"):
        if not twin_launches[name]:
            raise AssertionError(f"phase 21: {name} did not launch")
        rows[name]["launches"] += twin_launches[name]
    gc.collect()
    torch.cuda.empty_cache()

    names = ("fir_filter_bank", "mriq_compute_q", "flash_attention",
             "decode_attention", "ssm_scan", "rglru_scan", "rmsnorm")
    print("kernels: " + ", ".join(f"{n} ported (cuda)" for n in names)
          + "; no kernel left to port")
    print(card)
    print(json.dumps({"kernels": [
        {k: rows[name][k] for k in ("name", "route", "source", "replaces",
                                    "launches", "max_abs_err", "ms",
                                    "plain_ms", "bound_ms", "bound_by",
                                    "library_ms")}
        for name in names]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _host_start(cmd: list, limit_s: float, **env):
    """Start ``cmd`` on the host, with no card visible, in a session of its
    own (so that it and every process it starts can be killed);
    :func:`_host_wait` collects it."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="", **env)
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    return proc, t0, limit_s


def _host_wait(started):
    """(exit code, output, wall seconds) of a process :func:`_host_start`
    started; the exit code is None when it ran past its time limit (its
    session is then killed)."""
    proc, t0, limit_s = started
    try:
        log, _ = proc.communicate(timeout=max(limit_s - (
            time.perf_counter() - t0), 1.0))
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        log, _ = proc.communicate()
        return None, log, time.perf_counter() - t0
    return proc.returncode, log, time.perf_counter() - t0


def _dryrun_cell(cell, out: Path, limit_s: float):
    """Start one full-width dry-run cell in a process of its own, on the
    host; :func:`_dryrun_wait` collects it."""
    arch, shape, mesh = cell
    return _host_start([sys.executable, "-m", "repro_torch.launch.dryrun",
                        "--arch", arch, "--shape", shape, "--mesh", mesh,
                        "--out", str(out)], limit_s)


def _dryrun_wait(started, cell, out: Path):
    """(record, wall seconds) of a cell :func:`_dryrun_cell` started, or
    (None, wall) when it ran past its time limit (then killed)."""
    rc, log, wall = _host_wait(started)
    if rc is None:
        return None, wall
    recs = [json.loads(line) for line in out.read_text().splitlines()
            if line.strip()] if out.exists() else []
    rec = next((r for r in reversed(recs)
                if (r["arch"], r["shape"], r["mesh"]) == cell), None)
    if rec is None:
        raise AssertionError(f"dry-run {cell}: no record; log {log[-2000:]}")
    return rec, wall


def mesh_phase(torch, dev, card, counters, lr_fn, pcfg, losses18, norms18,
               secs18, peak18) -> None:
    """Phase 20 (module docstring): a world of 1 over NCCL."""
    import datetime
    import socket

    import torch.distributed as dist
    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.core.regions import Impl
    from repro_torch.data.pipeline import SyntheticLM, shard_batch
    from repro_torch.launch import shardings as SH
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import factory as F
    from repro_torch.models.params import tree_map
    from repro_torch.parallel.ctx import parallel_context
    from repro_torch.runtime.loop import LoopConfig, run_training

    gib = 2 ** 30
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=120))
    try:
        mesh = make_host_mesh(1, 1)
        rg = get_config(HYBRID_ARCH)
        print(f"world of {dist.get_world_size()} over "
              f"{dist.get_backend()}; mesh {mesh}")

        # a. train through run_training on the mesh
        for counter in counters:
            counter.launches = 0
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        res = run_training(rg, pcfg, mesh,
                           SyntheticLM(rg, TRAIN_BATCH, TRAIN_SEQ, seed=18),
                           LoopConfig(total_steps=MESH_TRAIN_STEPS,
                                      checkpoint_every=0, log_every=0),
                           seed=18, lr_fn=lr_fn)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev) / gib
        print(f"a. {HYBRID_ARCH} on the 1x1 mesh, {MESH_TRAIN_STEPS} steps "
              f"through run_training in {time.perf_counter() - t0:.1f} s: "
              f"losses {res.losses!r}, grad norms {res.grad_norms!r}; "
              f"phase 18's first {MESH_TRAIN_STEPS}: {losses18!r}, "
              f"{norms18!r}")
        print(f"   seconds a step on the mesh "
              f"{[round(x, 3) for x in res.step_times]} against phase 18's "
              f"{[round(x, 3) for x in secs18]} (median gap "
              f"{statistics.median(res.step_times) - statistics.median(secs18):+.3f}"
              f" s: DTensor dispatch on the host); peak {peak:.2f} GiB "
              f"against phase 18's {peak18:.2f} GiB; gathered "
              f"{dict(res.gathered)} [{card}]")
        if res.losses != losses18 or res.grad_norms != norms18:
            raise AssertionError("mesh train: losses or grad norms differ "
                                 "from phase 18's")
        if any(c.launches for c in counters):
            raise AssertionError("a hopper kernel launched in a train step")
        del res
        gc.collect()
        torch.cuda.empty_cache()

        # b. prefill + greedy decode through the step shardings, hopper
        impl = Impl({"attn_core": "hopper", "rglru_scan": "hopper"})
        spcfg = dataclasses.replace(pcfg, remat="none")
        ctx = MESH_PROMPT + MESH_DECODE_STEPS
        params = F.init_params(rg, torch.Generator(device=dev).manual_seed(20))
        batch = F.synthetic_batch(rg, MESH_SLOTS, MESH_PROMPT, seed=200)
        pre_shape = ShapeConfig("mesh_prefill", MESH_PROMPT, MESH_SLOTS,
                                "prefill")
        dec_shape = ShapeConfig("mesh_decode", ctx, MESH_SLOTS, "decode")
        (p_sh, _), (l_sh, _) = SH.prefill_shardings(rg, pre_shape, mesh,
                                                    spcfg)
        (_, c_sh, t_sh, q_sh), (dl_sh, _) = SH.serve_shardings(
            rg, dec_shape, mesh, spcfg)
        dparams = SH.distribute(params, p_sh)
        prefill = F.make_prefill_step(rg, impl=impl, ctx=ctx)
        serve = F.make_serve_step(rg, impl=impl)

        gathered = {}

        def greedy(prm, on_mesh):
            toks, logits = [], []
            with torch.no_grad(), (parallel_context(mesh, spcfg) if on_mesh
                                   else contextlib.nullcontext()) as pc:
                b = (shard_batch(batch, mesh, spcfg) if on_mesh else
                     {k: torch.from_numpy(v).to(dev)
                      for k, v in batch.items()})
                lg, cache = prefill(prm, b)
                if on_mesh:
                    lg, cache = SH.distribute((lg, cache), (l_sh, c_sh))
                for i in range(MESH_DECODE_STEPS + 1):
                    whole = lg.full_tensor() if on_mesh else lg
                    logits.append(whole[:, -1].float())
                    tok = whole[:, -1].argmax(-1).to(torch.int32)
                    toks.append(tok.tolist())
                    if i == MESH_DECODE_STEPS:
                        break
                    pos = torch.full((MESH_SLOTS,), MESH_PROMPT + i,
                                     dtype=torch.int32, device=dev)
                    t_in = tok[:, None]
                    if on_mesh:
                        t_in = SH.distribute(t_in, t_sh)
                        pos = SH.distribute(pos, q_sh)
                    lg, cache = serve(prm, cache, t_in, pos)
                    if on_mesh:
                        lg = SH.distribute(lg, dl_sh)
            if pc is not None:
                gathered.update(pc.gathered)
            return toks, torch.stack(logits)

        t0 = time.perf_counter()
        toks_p, lg_p = greedy(params, False)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        for counter in counters:
            counter.launches = 0
        t0 = time.perf_counter()
        toks_m, lg_m = greedy(dparams, True)
        torch.cuda.synchronize()
        mesh_s = time.perf_counter() - t0
        launches = {c.__name__: c.launches for c in counters}
        diff = float((lg_m - lg_p).abs().max())
        print(f"b. [{MESH_SLOTS}, {MESH_PROMPT}] prefill + "
              f"{MESH_DECODE_STEPS} greedy decode steps, attn_core and "
              f"rglru_scan on hopper: on the mesh {mesh_s:.2f} s, without "
              f"{plain_s:.2f} s; max |logit difference| {diff!r}; "
              f"greedy tokens per slot equal: {toks_m == toks_p}; launches "
              f"on the mesh {launches}; gathered {gathered} [{card}]")
        if not torch.equal(lg_m, lg_p) or toks_m != toks_p:
            raise AssertionError("mesh serve: logits differ from the same "
                                 "steps without the mesh")
        if not (launches["flash_attention"] and launches["rglru_scan"]):
            raise AssertionError("mesh serve: flash_attention or rglru_scan "
                                 "did not launch under the mesh")
        del params, dparams
    finally:
        dist.destroy_process_group()

    # c. the full-width dry-run cells (host, fake devices), one process a
    # cell, each writing its own JSONL
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    files = {cell: out_dir / f"dryrun_{cell[0]}_{cell[1]}_{cell[2]}.jsonl"
             for cell in MESH_DRYRUN_CELLS}
    for f in files.values():
        if f.exists():
            f.unlink()
    # d's trainings (host processes too) run beside c's cells
    train_d = {mesh: _host_start(
        ([sys.executable, "-m", "torch.distributed.run", "--standalone",
          f"--nproc-per-node={data * model}"] if data * model > 1
         else [sys.executable]) + ["-m", "repro_torch.launch.train"]
        + MESH22_TRAIN + ["--data-mesh", str(data), "--model-mesh",
                          str(model)], MESH22_S, OMP_NUM_THREADS="1")
        for mesh, (data, model) in (("2x2", (2, 2)), ("1x1", (1, 1)))}
    started = {cell: _dryrun_cell(cell, files[cell], MESH_CELL_S)
               for cell in MESH_DRYRUN_CELLS}
    # every host process of c and d is stopped, whatever fails first
    try:
        results = {cell: _dryrun_wait(started[cell], cell, files[cell])
                   for cell in MESH_DRYRUN_CELLS}
        for cell, (rec, wall) in results.items():
            if rec is None or rec["status"] != "ok":
                raise AssertionError(f"dry-run {cell}: " + (
                    f"ran past {MESH_CELL_S} s" if rec is None
                    else rec.get("error", "")))
            mem, hc = rec["memory"], rec["hlo_cost"]
            print(f"c. dry-run {' '.join(cell)} on {rec['devices']} fake "
                  f"devices: {rec['status']}, {wall:.1f} s wall (step "
                  f"{rec['run_s']} s); per device "
                  f"{(mem['argument_bytes'] + mem['temp_bytes']) / 1e9:.2f}"
                  " GB "
                  f"(arguments {mem['argument_bytes'] / 1e9:.2f}, temp "
                  f"{mem['temp_bytes'] / 1e9:.2f}), {hc['flops']:.4e} flops, "
                  f"{hc['hbm_fused']:.4e} HBM bytes, collectives "
                  f"{rec['collectives']['total_bytes']:.4e} B "
                  f"{rec['collectives']['counts']}; pcfg {rec['pcfg']}; "
                  f"gathered {rec['gathered']}")

        # d. the 2x2 backward under this machine's torch: the train launcher
        # on 4 gloo ranks of the host against its 1x1 run
        losses_d = {}
        for mesh, started_d in train_d.items():
            rc, log, wall = _host_wait(started_d)
            found = (re.search(r"step 0 loss (\S+) ", log),
                     re.search(r"final loss (\S+) after (\d+) steps", log))
            if rc != 0 or None in found:
                raise AssertionError(
                    f"d. train on {mesh}: " + (f"ran past {MESH22_S} s" if rc
                                               is None else f"exit {rc}")
                    + f"; output:\n{log[-6000:]}")
            losses_d[mesh] = [float(m.group(1)) for m in found]
            print(f"d. qwen2-72b (reduced) through launch.train on {mesh} "
                  f"({wall:.1f} s on the host): step-0 and final losses "
                  f"{losses_d[mesh]} after {found[1].group(2)} steps")
        two, one = losses_d["2x2"], losses_d["1x1"]
        err = max(abs(a - b) for a, b in zip(two, one))
        print(f"d. 2x2 against 1x1: max |loss difference| {err:.2e} "
              f"(tolerance {MESH_TOL} + {MESH_TOL} x |1x1|), torch "
              f"{torch.__version__}")
        if any(abs(a - b) > MESH_TOL + MESH_TOL * abs(b)
               for a, b in zip(two, one)) or not two[1] < two[0]:
            raise AssertionError(f"d. the 2x2 losses {two} against 1x1's "
                                 f"{one}")
    finally:
        for proc, _, _ in (*started.values(), *train_d.values()):
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.communicate()


if __name__ == "__main__":
    sys.exit(main())
