#!/usr/bin/env python3
"""Drive the PyTorch/H100 port on one CUDA card, end to end.

    python3 chip_smoke.py            # from the repository root

1. Device: prints the card's name and power limit (nvidia-smi).
2. Build: compiles every CUDA source of the port with nvcc for sm_90a, one
   nvcc per source, all started together.
3. Serve: Llama-3.2 1B at full width (seeded random bf16 weights) behind
   the paged serving engine with the paged-decode kernel on; the kernel
   launch counters are zeroed just before and read just after, and every
   distinct geometry the model gives the kernel is recorded.
4. End to end: teacher-forced check of the served tokens against the plain
   full-sequence forward on the card, which must also reject a serve
   through a planted kernel fault.
   Then two more serves of the same prompts from a quantized KV pool with
   chunked prefill (256-token chunks): Q1, int8 with the kernel's mode 3
   (dequantize in the kernel), and Q2, fp8 e4m3 with quant_mxu (mode 6,
   the q.k dot in fp8). Each is checked the same way against one
   whole-prompt pass of the decode model over a fresh pool of the same
   dtype (which reads the same quantized K/V and runs no kernel), and must
   reject a serve whose kernel calls read V's scales as K's. Then F, a fused
   speculative serve of the same prompts (four of them rebuilt as
   repeated patterns, so that the n-gram drafter proposes): drafts of up
   to 4 tokens verified at t = 5, 16-token prefill chunks packed with the
   decode and verify rows into one t = 16 mixed step a step, whose K4
   calls carry per-lane live rows (row_live, mode 4). F is checked
   against the plain full-sequence forward on all eight requests; a
   serve whose row_live walks stop one row short must read above the
   tighter margin on request 6, where F reads within it. Witnesses are
   logged (the gather path, the fused step without speculation, an fp32
   copy of the model), and F's twin is profiled. Then T, a tree-speculative fused
   serve of the same prompts (four of them rebuilt from two patterns that
   share their first three tokens, a context with two continuations):
   trees of up to 31 nodes verified at t = 32, and 32-token prefill
   chunks in t = 32 mixed steps, whose K4 calls carry per-node ancestor
   masks (tree_bits, mode 5) over 128 tile rows. T is checked against the plain forward on all eight requests
   and logged against an fp32 copy; its prompts are served once more with
   a drafter whose every tree branches, a decoy branch before the plain
   forward's greedy continuation, so that every accept moves rows to the
   frontier, and a serve whose frontier commit is the identity must read
   above the margin. T's twin is profiled.
   Each serve (Serve, Q1, Q2, F, T, and QF: F's knobs from an int8 pool,
   served and checked eagerly first) has a prewarmed twin: a server with
   PagedConfig.prewarm captures every program key of its catalog (whole
   prompt prefill per prefill rung, suffix prefill per (prefill rung, kv
   rung) pair, decode per kv rung, verify / tree verify per (kv, k),
   mixed per (t, kv)) as a CUDA graph, then serves the same requests by
   replaying them; its greedy streams must equal the eager serve's (or
   first differ at a near tie, and then pass the eager serve's e2e check),
   no capture may follow the freeze, the captures must have launched K4's
   t1 and tile sources (Serve's t = 8 suffix prefills among them) and no
   K4 wrapper may count a launch during the serve: every call is a
   replay. Each twin logs its keys by kind, capture seconds and the
   reserved bytes its graphs added. Serve, Q1 and F have an async twin
   too: prewarm with PagedConfig.async_loop, the steady state
   dispatching step N+1 before it reads step N back; held as the twins
   are, it must have run async steps and discarded lame-duck tokens, and
   it logs a decode step's own device time (the most replayed decode-time
   graph, replayed alone). The twins of Serve, Q1, Q2, F and T are
   profiled (wall, busy share, TPOT, TTFT, tokens/s), their streams must
   equal the eager serve's, and K4's launches by source in their replays
   must equal the eager serve's wrappers' counts (the profiler's count of
   those kernels above 0 and never above it). Serve's planted fault is
   captured into a twin's graphs, and the e2e check must reject that
   serve too, and a serve with the fault in its suffix prefills' graphs
   alone. Then fault tolerance on Serve's configuration: a prewarmed twin
   with the finite-logit check and the invariant auditor every step
   (detect_nonfinite, audit_interval=1) serves the unchecked twin's
   streams with no quarantine, no violation, no capture after the freeze
   and no upload on a steady step (its TPOT and tokens/s logged beside the
   unchecked twin's); the same twin under a FaultPlan of one nan and one
   device fault fails exactly the two victims with the JAX engine's error
   strings, the six others token for token the clean twin's, no leak and
   no K4 launch outside a replay; and NaN K rows written into a block one
   lane alone holds get that lane quarantined by the on-device isfinite,
   the others unaffected, where the same serve without detection commits
   the lane's garbage tokens and fails nothing, and the verdict must tell
   the two apart. Then tiered KV storage (PagedConfig.spill_enabled):
   Serve's prompts as a churn (the prefix's seed alone, six fillers, two
   re-hits of the 256-token prefix with other tails) on a pool cut so
   that the fillers evict every prefix block: the blocks spill to pinned
   host memory and the first re-hit restores all 16, each bitwise equal
   to the block that was spilled; eagerly, from Q1's int8 pool (the scale
   tiles with the payloads) and in a prewarmed async twin whose graphs
   read the restored blocks. The streams equal the resident serve's (or
   first differ at a near tie), the re-prefill serve (spill off) passes
   the e2e margin, and a restore writing V's payload into K, and one
   leaving the fresh block's scale tiles as they were, must read above
   their margins; K4's t1 and tile sources must read the restored blocks.
   (Before it, the degradation ladder and the front door, on Serve's
   prewarmed async twin: three device faults with degrade_after_faults=1
   climb the ladder 1 -> 2 -> 3 and back to 0, exactly the victims fail
   with the JAX engine's error strings, the survivors serve the clean
   twin's streams, rung 3 runs the gather twins captured at their first
   use, which launch K4 0 times, K4's t1 source is replayed again after
   the recovery, and a ladder whose _step_model keeps the kernel model
   must read K4 launches at rung 3; four faults reach rung 4, which sheds
   the youngest lane by preemption, and it resumes to its clean stream.
   GraftServer over the async twin under step_policy="slo" serves the
   eight prompts to an in-process asyncio client on a loopback port, four
   streamed (SSE) and four not, each equal to the async twin's batch run,
   a ninth cancelled after its fourth token, /metrics and /snapshot
   parsed, no capture after the freeze, no upload on a steady step, K4
   only from replays; a pump that drops each stream's last token must
   fail the stream check, and the TTFT p50 by class under slo is logged
   beside the same traffic under fifo.)
   The same restores without the bit check, eager and prewarmed, are
   clocked part by part beside the re-prefill and resident serves. The
   host link's per-block copy times, the restore path's effective rate,
   the price a restore gets at restore_crossover 1.0 and each twin's
   cost ledger (cost_profiled_programs, mfu_est, bandwidth_util_est, the
   HBM ledger's parameter and pool bytes, which must be the tensors' own)
   are logged. Then on-device sampling (PagedConfig.on_device_sampling): the
   sampler (sample_lanes) on the card at every served shape (Serve's
   decode (8, V), F's verify (8, 5, V) and mixed (8, 16, V), T's (8, 32,
   V)) over the model's own logits and mixed per-lane configs, greedy
   sentinels among them, against the same function on a CPU copy (a
   difference only at a near tie), timed, and a frequency check against
   the filtered softmax that must reject the draws with the temperature
   applied twice; Serve, F and T served sampled (temperature 0.8, top-p
   0.95), eagerly (every token the plain forward's draw at its landing
   index, up to near ties) and by their prewarmed twins, Serve by its
   async twin too (the twins' streams the eager ones, no capture after
   the freeze, no K4 launch outside a replay, sampled_steps > 0, no host
   fallback); a
   greedy config under on_device_sampling prewarmed (the greedy twin's
   streams); Serve sampled on a pool small enough to preempt (the
   unpreempted streams); and F's prompts served sampled without
   speculation, then with F's knobs and a drafter proposing those
   streams (accepted drafts, the same streams, and F's sampled streams
   the same too). Then the dense engine (InferenceEngine, every program
   a CUDA graph, tokens and positions on the card between steps): Serve's
   prompts greedy through generate() at on_device_steps 1 and 8 (the
   streams equal, every token within 0.125 of the plain forward, the
   eager paged serve's streams up to near ties, no program built after
   the first token, the cache 536,870,912 B; a decode whose kv read leaves
   out each slot's newest row must read above 0.125; TTFT / TPOT p50 and
   a graphed decode step's device time logged); the continuous-batching
   churn (16 requests over 8 slots, no program built under traffic, each
   stream its prompt's generate() stream); generate() sampled at
   on_device_steps 1 and 8 (equal streams) and sample() on the card
   against a CPU copy (a difference only at a near tie); draft-model
   speculation (the 1B's first 4 layers, shared tensors, gamma 4) and
   Medusa (three seeded random heads, the default tree), each stream the
   greedy generate() stream; and Serve's config host-sampled (no
   on_device_sampling) prewarmed against its eager serve: the streams
   equal (the key chain is the JAX engine's, split inside the graphs; a
   difference only at a near tie with the eager draw's key), no capture
   after the freeze, 0 uploads a steady step, K4 only from replays, the
   audit clean, no leak; a twin whose captures leave the key advanced
   must fail the stream check. Every phase logs its seconds.
5. Train: Llama-3.2 1B at full width and depth in bench.py's training
   configuration (batch 12 x 2048, remat "full", flash attention, loss
   chunked at 256, AdamW with bf16 state) through TrainingConfig ->
   initialize_parallel_model -> make_train_step; a warm-up step, then
   timed steps with the flash-kernel launch counters zeroed just before
   and read after each; the loss must be finite and fall. Then one step's
   loss and gradients through the kernels against the same step through
   the plain attention (which must also reject a backward through a
   planted kernel fault), and a profiled step. Then the remat policies:
   one step's loss and gradients at batch 2 x 2048 (flash on) under each of
   "full", "none", "selective", "dots", "hybrid", "kv" from the same weights
   and batch, each within the train e2e bands of "full"'s, with K1 launched
   once a layer where the policy keeps the attention output and its
   residuals and twice where the backward recomputes it (K2, K3 once), its
   peak memory and step time logged. Then the pretrain script
   (scripts.pretrain.main, in process): the 1B at full width and depth
   under its default remat "selective", the native token loader over a
   token file of repeated motifs written here, 8 steps at batch 4 x 2048
   saving at step 4 and at the end in the JAX package's checkpoint format;
   the final tag moved aside, the same command resumes from step 4 and
   must repeat the losses (1e-3 relative) and end within one bf16 ulp of
   the first run's weights; the TensorBoard scalars, the timeline and the
   metrics file read back. The saves', the load's and the host copy's
   times are logged. The trained checkpoint is then loaded into T's
   configuration (its weights bitwise the trained state's) and served
   eagerly (every token within T's margin of the plain forward; the lane
   trees that branch logged) and by its prewarmed twin (the eager streams,
   no K4 launch outside a replay), and scripts.generate --ckpt-dir must
   give InferenceEngine.generate's greedy stream.
   Every serve checks which source took its K4 calls: every t == 1 call
   csrc/paged_decode_t1.cu (each lane's live blocks split evenly over a
   split count that fills the card, the splits merged in the same launch),
   every call at t > 1 with at most 128 tile rows csrc/paged_decode_tile.cu
   (one block owning the whole query tile, on the tensor cores; bf16, and
   the quantized pools in modes 3 and 6, Q1's and Q2's suffix prefills
   among them), and csrc/paged_decode.cu the rest (none of the served
   calls).
6. Kernels: runs each kernel on the card at a grid of shapes and at every
   geometry the main paths launched, against its plain PyTorch version,
   with the tolerance stated, and times the kernel, the plain version and
   one PyTorch library call computing the same function (a yardstick the
   port never calls), beside the bound the card could reach; at every
   call the tile or the t1 kernel takes, csrc/paged_decode.cu is held and
   timed at the same call too (split_ms), and at the served t == 1 call
   launched most the t1 kernel is timed at 4, 8, 16 and 32 splits. The
   paged-decode kernel runs so for the bf16 pool and for each of the six
   quantized combinations {int8, fp8 e4m3, fp8 e5m2} x {mode 3, mode 6},
   at the median call of each served geometry, and once more on a probe
   built to expose the faults a quantized kernel could hide, at t = 1 (the
   t1 kernel) and at t = 8 (the tile kernel): there the check must reject
   the kernel's output with dequantized values left unrounded, and (mode
   6) with mode 3's arithmetic in place of mode 6's.
   K4's row_live mode runs so at F's median mixed-step call and at t = 16
   cases of the 1B and 3B geometries, bf16 and int8 mode 3, with its live
   rows bitwise equal to the same launch without row_live, and on a probe
   whose lanes' last live row opens a pool block, where a walk one row
   short must fail the check. K4's tree_bits mode runs so at T's median
   tree-verify and mixed calls and at random branching trees of t = 17,
   25 and 32 (1B and 3B, bf16 and int8 mode 3), where a chain's masks must
   give bitwise the launch without tree_bits and the block-causal mask in
   place of the ancestor mask must fail the check; and a linear t = 32
   block (128 tile rows) with and without row_live. The tile kernel runs
   once more on a probe whose lanes' walks end in a block of 16 fresh
   rows, on a bf16 and an int8 (mode 6) pool, where a walk without its
   last staged block must fail the check; ptxas must report no spills for
   any of its instances. The t1 kernel runs once more on a
   probe (lanes at row 0, at the last row under the limit and at rows that
   open a pool block, walks shorter than the split count), where the check
   must reject its output with every lane's newest row left out and with
   every lane's last split range left out; it is held so there with
   row_live and tree_bits at t = 1 too, and ptxas must report no spills
   for it either. K1-K3 (the flash kernels) run so at six shapes; at the
   train shape the check must reject each of their outputs (o, dq, dk,
   dv) with one kv tile left out, and each with the causal diagonal
   masked (col < row), the compare that only the kernels' diagonal tiles
   run; ptxas must report no spills for K1-K3 either, and no wgmma
   product serialized (warning C7520). Then K1-K3's packed-document mode
   (segment_ids) at three packed shapes (the train shape causal, the 3B
   geometry full, S 1000 causal), with seeded document ids (boundaries on
   a 64-row tile's first row, its last row and mid-tile, a document of one
   row and one longer than 1024, an id that comes back after another),
   driven once through the public flash_attention(segment_ids=) forward
   and backward with the launch counters zeroed just before (one launch
   of each kernel), held the same way, timed beside SDPA with the boolean
   block-diagonal mask; at the packed train shape the check must reject
   each output with a document boundary moved by one row and with the
   segment compare applied only on the tiles the causal or edge mask
   crosses.

Tensor parallelism last (NCCL refuses two ranks on one device): "tp nccl"
runs NCCL at world size 1 through the tp code path (a mesh of one rank,
each row-parallel layer's all-reduce and the LM head's all-gather issued
and, in the prewarmed twin, captured in its graphs; the single-device
serve's streams; none issued outside a replay); "tp2 serve" runs two
ranks on the card over gloo at tp = 2, the 1B at full width and depth,
Serve's prompts eagerly, each rank's pool 537,133,056 bytes, both ranks'
streams equal and held to the tp = 1 serve's under the near-tie rule, K4
held against its plain version at a rank's 16 q / 4 kv heads at the
served geometries; a rank 1 whose K4 reads rank 0's kv-head slice must
fail the stream check; "tp2 train" holds one tp = 2 step's loss and
gathered gradients to the tp = 1 step within the train bands, with and
without sequence parallelism (K1-K3 launched 32 / 16 / 16 times a rank,
held at the rank's shape), a
row-parallel layer without its all-reduce must fall outside them, and a
dp = 2 ZeRO-1 step halves each rank's fp32 state. Context parallelism
after it: "cp2 train" runs the train step through
``TrainingConfig(context_parallel_size=2)`` on two ranks on the card over
gloo (the ring rotating by an all-gather: gloo's point-to-point refuses
CUDA tensors), in the contiguous and the zigzag layout, each step's loss
and the gradients summed over cp within the train bands of the cp = 1
step, K1-K3 launched as the ring implies on each rank (``CP_LAUNCHES``),
and planted faults in each layout (a visiting chunk left out of the
merge; the zigzag positions cut in contiguous order; the ring backward's
dk / dv one hop short of home) outside them; K1-K3 are held and timed at
the ring's chunk shapes. The pipeline and expert parallelism follow on
the same two ranks (every two-rank phase runs in one pair of processes):
"pp2 train" in each schedule, and "ep2 train", Mixtral's widths at ep = 2
against ep = 1 on the same expert choices. Then the MoE phases: "moe
train" (Mixtral's widths, 2 layers, against the plain step on the kernel
step's expert choices; K1-K3 at D 128, G 4) and "moe serve" (Mixtral's
widths, 4 layers, bf16 at 8 and 4 lanes, a planted K4 fault, a prewarmed
twin; int8 weights and their twin; DBRX's widths, 1 layer, and its twin:
K4 at G 6), each served token teacher-forced on the serve's own expert
choices. Then the LoRA, GPT-NeoX / CodeGen and BERT phases: "lora train"
(the 1B under the default adapters, r 8, through the trainer: B = 0 the
base's logits, four steps with K1-K3 counted, the base unchanged, AdamW
adapter-sized, the step against plain attention within the train bands
and a planted K3 fault outside, the adapter-only tag bit for bit; K1-K3
at the step's shape), "lora serve" (the trained adapters merged within a
bf16 ulp, a merge scaling twice outside it; the merged 1B served within
the e2e margin; a B = 0 merge serving Serve's eager streams), "neox
train" (Pythia-6.9B's widths, 2 layers, against the plain step; K1-K3 at
MHA, G 1, D 128), "neox serve" (Pythia at 4 layers over 8 lanes, a
planted K4 fault, a prewarmed twin, K4 at G 1; CodeGen2.5-7B at 2 layers
over 4 lanes) and "bert train" (BERT-large's bf16 step against the fp32
step, the padding mask left out outside the bands; the pretrain script
on bert-large, four steps, no tag). Last, Mllama, which runs no
hand-written kernel (the JAX model reaches no Pallas call either):
"mllama serve" (Llama-3.2 11B-Vision at full width and depth, bf16,
gates seeded non-zero, behind ``MllamaDecoder``: a 2 x 2 image of 4
tiles and a 1 x 2 image with 2 of 4 tiles valid, 64-token prompts
attending the image from position 8, 16 greedy tokens each; the
decoder's logits within a band of the full forward's, teacher-forced,
every token the argmax or a near tie, ``project_kv`` 8 times a request,
a second image moving the logits past the band; a step mask from the
first prompt row must fail; the vision tower in bf16 against its fp32
copy, and with the tile-validity bias left out outside the band) and
"mllama train" (the 11B's widths, the vision tower at full depth, 5 text
layers, remat full, 2 x 512 tokens with an image each: bf16 against fp32
loss and gradients, every gate's gradient non-zero, the full-row mask
left out outside the bands; four AdamW steps through the trainer, losses
falling). To keep the script
inside its limit the eager serves' profiles, the async twins' profiles,
the timing of the bf16 K4 grid and of the tree cases no serve launched,
the spill phase's unwatched serves (``chip_trials/spill_restore_trial.py``
times the restores), two of the sampler's three timing windows, the F
witness phase and the cp2 phase's loss-gap witnesses are left out, a
timing window is 25 calls (it was 50), Q1's and Q2's twins are
profiled on their graph phase's own serve, and (since the LoRA, GPT-NeoX
and BERT phases) the sampled twin's profile and K4 t1's split-count sweep
are left out; every check of the phases that remain stays.

Every failure exits non-zero. The last line of standard output is
``{"ok": true, "device": {...}}``; the line before it is the per-kernel
JSON record. Without a CUDA card, or outside the repository, the script
exits non-zero and prints no result.
"""

from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import functools
import gc
import json
import os
import re
import subprocess
import sys
import time
from typing import Optional
from unittest.mock import patch

import numpy as np
import torch

SEED = 0
# A kernel vs its plain version, held element by element: a tolerance of a
# tensor's largest value would be as large as the typical output of a
# causal flash row late in the sequence, or of a decode lane that reads a
# long context. Each output element must lie within ROW_ULPS bf16 ulps of
# its own plain value plus ROW_ULPS ulps of the largest |plain value| of
# its row (the D values of one (b, head, position) of K1-K3, of one (lane,
# token, head) of K4), a row's largest taken as at least ROW_FLOOR of the
# tensor's: a row whose plain value cancels to 0 (dq of causal row 0,
# where dP = delta) keeps the kernel's fp32 rounding of that cancellation,
# about 1e-7 of the tensor's largest. Groups of rows are held by relative
# L2 error besides (TILE_REL_L2 for K1-K3, LANE_REL_L2 for K4).
ROW_ULPS = 2
ROW_FLOOR = 2.0 ** -12
# K4 vs its plain version: both read the same bf16 operands (a quantized
# pool's dequantized and bf16-rounded, or its payload and requantized q
# under quant_mxu), accumulate in fp32 in another order and round the
# output to bf16 on their own; the kernel rounds its softmax weights to
# bf16 against its running max before p.V and the plain version does not
# round them: about 2^-9 relative each, a few thousandths of relative L2
# in all. Each (lane, query head) within LANE_REL_L2 over its t x D outputs
LANE_REL_L2 = 1e-2
# end-to-end: an engine token must be the plain forward's argmax or within
# this many logits of it. Both paths run bf16 through 16 layers with
# different shapes (bucket-padded prefill, the paged kernel, T=1 decode vs
# one full-sequence pass), so their bf16 roundings differ. On an H100 the
# sound serve reads a worst gap of 2^-4 over all eight requests (2^-5 on
# requests 0 and 4) and the planted fault of run_e2e_phase reads 1.3;
# E2E_LOGIT_MARGIN, which holds every request of the serve, is twice the
# sound reading, and run_e2e_phase fails unless the fault lands above it.
# LOGIT_MARGIN is twice the reading on a short request (F's fault check)
LOGIT_MARGIN = 0.0625
E2E_LOGIT_MARGIN = 0.125
# the quantized serves: (label, kv_cache_dtype, quant_mxu), chunked prefill
# at QUANT_CHUNK tokens
QUANT_SERVES = (("Q1", "int8", False), ("Q2", "fp8_e4m3", True))
QUANT_CHUNK = 256
# their e2e margins against a whole-prompt pass over a pool of the same
# dtype, on every request. Both read the same quantized K/V up to bf16
# rounding differences in the projections, which can move a row's scale
# and payload by a step; Q2 also quantizes its queries in the kernel, which
# the reference pass does not. On an H100 the sound serves read worst gaps
# of 0.0625 (Q1) and 0.203125 (Q2) over all eight requests, the planted
# scale fault of run_quant_e2e_phase 3.81 and 4.10; each margin is twice
# the sound reading, and run_quant_e2e_phase fails unless the fault lands
# above it. QF (F's knobs from an int8 pool) is held to the int8 margin by
# the same check, and its own planted scale fault must land above it; its
# sound serve reads 0.046875 on an H100
QUANT_LOGIT_MARGIN = {"int8": 0.125, "fp8_e4m3": 0.40625}
# the fused speculative serve F: PagedConfig knobs, the kernel's widest
# fresh block (the mixed step's t = max(chunk, drafts + 1) = 16: 64 tile
# rows at G = 4) and the prompts rebuilt as repeated 3-token patterns.
# Prompt 1, the longest, is one of them so that a drafting lane outlives
# the mixed steps and the verify dispatch (K4 at t = 5) runs too
SPEC_KNOBS = dict(spec_draft_tokens=4, prefill_chunk_tokens=16, fused_step=True)
SPEC_MAX_T = 16
SPEC_REP_PROMPTS = (0, 2, 6, 1)
# F's e2e check holds every request. On an H100 the sound serve reads a
# worst gap of 0.109375 (prompt 5, a near tie that the same prompts served
# through the gather path and without speculation read too); the margin is
# twice that
F_LOGIT_MARGIN = 0.21875
# the planted row_live fault's own check: a walk one row short changes a
# token only where a lane's last live row opens a pool block, and by the
# weight of one row of the context, so it reads a request where that
# happens in a short context: prompt 6, 64 tokens, whose first decoded
# row, inside the grid, opens a block. On an H100 the sound serve reads
# 0.015625 there and the fault 0.140625 (no other request moves); both
# are held at LOGIT_MARGIN. The kernel probe (ROW_LIVE_PROBE) is the
# sharper guard against the same fault
F_FAULT_PICK = 6
# the tree-speculative serve T: PagedConfig knobs (the tree's node budget is
# the draft budget, 31; the fused step packs 32-token prefill chunks), and
# the kernel's widest fresh block: t = 32 for both the tree verify (31
# nodes and the root) and the mixed step, 128 tile rows at G = 4, one block
# of csrc/paged_decode_tile.cu
TREE_KNOBS = dict(spec_draft_tokens=31, spec_tree=True, spec_tree_branches=2,
                  prefill_chunk_tokens=32, fused_step=True)
TREE_MAX_T = 32
# T's e2e check and that of the tree e2e phase hold every request. On an
# H100 the sound serves read worst gaps of 0.09375 over all eight (T and
# its decoy-first serve alike); the margin is twice that, and the planted
# commit fault of run_tree_branch_phase (1.625) must read above it
T_LOGIT_MARGIN = 0.1875


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def log(*parts) -> None:
    print(*parts, flush=True)


# -- 1. device ------------------------------------------------------------------

def card_label() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    check(bool(out), "nvidia-smi reported no card")
    return out[0].strip()


# -- 5. kernels -------------------------------------------------------------------

def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The bf16 ulp (8 significant bits) at each |x|."""
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(2.0 ** -126))) - 7)


def element_ratio(out: torch.Tensor, ref: torch.Tensor) -> float:
    """The largest ratio of an element's error to its limit: ROW_ULPS ulps
    of its plain value plus ROW_ULPS of its row's (last dim's) largest."""
    r = ref.float()
    row_top = r.abs().amax(dim=-1, keepdim=True).clamp_min(ROW_FLOOR * r.abs().max())
    limit = ROW_ULPS * (bf16_ulp(r) + bf16_ulp(row_top))
    return ((out.float() - r).abs() / limit).max().item()


def decode_agreement(out: torch.Tensor, ref: torch.Tensor):
    """How far a (b, t, N, D) K4 output lies from its plain version: (the
    largest ratio of an element's error to its limit, the largest relative
    L2 error of one (lane, query head) over its t x D outputs, against a
    norm taken as at least ROW_FLOOR of the largest lane's, as rows are in
    ``element_ratio``). It agrees when the first is at most 1 and the
    second at most LANE_REL_L2."""
    r = ref.float()
    norms = r.square().sum(dim=(1, 3)).sqrt()
    rel = ((out.float() - r).square().sum(dim=(1, 3)).sqrt()
           / norms.clamp_min(ROW_FLOOR * norms.max()).clamp_min(1e-30)).max().item()
    return element_ratio(out, ref), rel


def device_ms(fn, iters: int = 25, windows: int = 3, matches=(None,)):
    """([device ms for each entry of ``matches``], wall ms) per call of
    ``fn(i)``, each the median over ``windows`` runs of ``iters`` calls
    after three warm-up calls. Device time is the summed duration of the
    CUDA kernels the calls launched (torch.profiler, CUPTI) whose name
    contains the entry, or of all of them for None; so one window times
    each kernel of a call that launches several. A window whose trace
    holds fewer kernels than the fullest one lost records and is left
    out. Wall time is CUDA events around the run, which includes the
    host's launch overhead whenever the host is the slower side."""
    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    runs = []
    # a window whose trace came back empty is run again, up to twice over
    for _ in range(3 * windows):
        if sum(r[0] > 0 for r in runs) == windows:
            break
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            start.record()
            for i in range(iters):
                fn(i)
            end.record()
            torch.cuda.synchronize()
        events = prof.key_averages()
        runs.append((
            sum(e.count for e in events if e.self_device_time_total > 0),
            [sum(e.self_device_time_total for e in events if m is None or m in e.key)
             / 1e3 / iters for m in matches],
            start.elapsed_time(end) / iters,
        ))
    full = max(r[0] for r in runs)
    check(full > 0, "the profiler recorded no device time")
    dev = np.asarray([r[1] for r in runs if r[0] == full])
    return [float(x) for x in np.median(dev, axis=0)], float(np.median([r[2] for r in runs]))


@dataclasses.dataclass
class DecodeCase:
    name: str
    n: int
    nkv: int
    d: int
    t: int
    kv_limit: int
    splits: Optional[int]  # None: the wrapper's default, as the model calls it
    positions: np.ndarray  # (b,) first fresh row per lane
    bs: int = 16
    layers: int = 16  # pool depth; timed calls walk the layers, as decode does
    table_width: Optional[int] = None  # W; None = kv_limit // bs
    serve_launches: int = 0  # launches at this geometry in the counted serve
    row_live: Optional[np.ndarray] = None  # (b,) live rows per lane (mode 4)
    tree_bits: Optional[np.ndarray] = None  # (b, t) ancestor masks (mode 5)


# -- the serve's launch geometries -------------------------------------------

@contextlib.contextmanager
def model_kernel_call(wrap):
    """Route the model's paged-decode calls through ``wrap(inner, *args,
    **kwargs)`` while the block runs (the model looks the wrapper up in its
    module at each call). The kernel's own launch counter is untouched."""
    import neuronx_distributed_llama3_2_tpu_torch.inference.model as im

    inner, inner_tp = im.paged_flash_decode, im.paged_flash_decode_tp
    im.paged_flash_decode = functools.partial(wrap, inner)
    # a rank of a tp group calls the tp wrapper (its own heads)
    im.paged_flash_decode_tp = functools.partial(wrap, inner_tp)
    try:
        yield
    finally:
        im.paged_flash_decode, im.paged_flash_decode_tp = inner, inner_tp


def recording(geometries: dict, keep_positions: bool):
    """A ``model_kernel_call`` wrapper that counts the calls at each
    distinct (b, t, kv_limit, num_splits, W), with "row_live" and "tree"
    appended for the calls that pass per-lane live rows and per-node
    ancestor masks, and, if asked, keeps every call's positions, live rows
    and masks (a host sync per call)."""
    def wrap(inner, q, k_pool, v_pool, tables, positions, **kw):
        live, bits = kw.get("row_live"), kw.get("tree_bits")
        key = (
            q.shape[0], 1 if q.dim() == 3 else q.shape[1], kw.get("kv_limit"),
            kw.get("num_splits"), tables.shape[1],
        ) + (() if live is None else ("row_live",)) + (() if bits is None else ("tree",))
        entry = geometries.setdefault(
            key, {"calls": 0, "positions": [], "row_live": [], "tree_bits": []})
        entry["calls"] += 1
        if keep_positions:
            entry["positions"].append(positions.tolist())
            if live is not None:
                entry["row_live"].append(live.tolist())
            if bits is not None:
                entry["tree_bits"].append(bits.tolist())
        return inner(q, k_pool, v_pool, tables, positions, **kw)
    return wrap


def median_call(calls: list) -> list:
    """The positions of the call whose live rows (the sum of its lanes'
    positions) are the median of a geometry's calls: the load that
    geometry's launches typically served."""
    return sorted(calls, key=sum)[(len(calls) - 1) // 2]


def check_routes(label: str, cfg, geoms: dict, launches: int, tile: int, t1: int,
                 kv_dtype: str = "bf16") -> str:
    """The counted serve's K4 launches by source: csrc/paged_decode_t1.cu
    must have taken exactly its t == 1 calls, csrc/paged_decode_tile.cu
    exactly the calls ``kernel_route`` gives it (every call at t > 1 here,
    from any pool: at most 128 tile rows) and csrc/paged_decode.cu the rest
    (none here). Returns the log's summary."""
    def source(key):
        return k4_source(kv_dtype, key[1], cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)

    want = {src: sum(e["calls"] for k, e in geoms.items() if source(k) == src)
            for src in ("t1", "tile", "split")}
    t1_calls = sum(e["calls"] for k, e in geoms.items() if k[1] == 1)
    check(t1 == want["t1"] == t1_calls,
          f"{label}: {t1} paged_decode_t1.cu launches, the route gives it {want['t1']} "
          f"of {t1_calls} t == 1 calls")
    check(tile == want["tile"] and launches - tile - t1 == want["split"],
          f"{label}: {tile} tile and {launches - tile - t1} split launches of {launches}, "
          f"the route gives them {want['tile']} and {want['split']}")
    split_t = sorted({k[1] for k in geoms if source(k) == "split"})
    return (f"paged_decode_t1.cu {t1} launches (every t == 1 call), paged_decode_tile.cu "
            f"{tile}, paged_decode.cu {launches - tile - t1} (t in {split_t})")


def paged_cases(cfg, served: dict):
    """The fixed grid of shapes, then one case for each geometry the
    counted serve gave the kernel, at the positions of its median call."""
    rng = np.random.default_rng(SEED)
    cases = []
    for kv_limit in (512, 2048):
        for t in (1, 4):
            pos = rng.integers(0, kv_limit - t + 1, size=8)
            pos[0], pos[-1] = 0, kv_limit - t  # first row, last row
            for splits in (1, 4):
                cases.append(DecodeCase(
                    f"1b kv{kv_limit} t{t} s{splits}", 32, 8, 64, t, kv_limit,
                    splits, pos,
                ))
    cases.append(DecodeCase(
        "3b kv2048 t4 s4", 24, 8, 128, 4, 2048, 4,
        rng.integers(0, 2048 - 4 + 1, size=8),
    ))
    # the D = 128 instances of csrc/paged_decode_t1.cu, at its own split count
    pos = rng.integers(0, 2048, size=8)
    pos[0], pos[-1] = 0, 2047
    cases.append(DecodeCase("3b kv2048 t1", 24, 8, 128, 1, 2048, None, pos))
    for (b, t, kv_limit, splits, w), entry in sorted(served.items()):
        cases.append(DecodeCase(
            f"serve b{b} t{t} kv{kv_limit}", cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim, t, kv_limit, splits, np.asarray(entry["positions"]),
            table_width=w, serve_launches=entry["calls"],
        ))
    return cases


def build_case(c: DecodeCase, gen: torch.Generator):
    """q, a shuffled block table with null-block (id 0) entries past each
    lane's frontier, and an L-layer bf16 pool on the card."""
    b = len(c.positions)
    w = c.table_width or c.kv_limit // c.bs
    nb = b * w + 1
    perm = torch.randperm(nb - 1, generator=gen, device="cuda") + 1
    tables = perm[: b * w].reshape(b, w).to(torch.int32)
    for i, p in enumerate(c.positions):
        tables[i, (int(p) + c.t - 1) // c.bs + 1:] = 0
    shape = (c.layers, nb, c.bs, c.nkv, c.d)
    kp = torch.randn(shape, generator=gen, device="cuda", dtype=torch.bfloat16)
    vp = torch.randn(shape, generator=gen, device="cuda", dtype=torch.bfloat16)
    q = torch.randn((b, c.t, c.n, c.d), generator=gen, device="cuda", dtype=torch.bfloat16)
    pos = torch.as_tensor(c.positions, dtype=torch.int32, device="cuda")
    return q, kp, vp, tables.contiguous(), pos


def paged_bound(c: DecodeCase, kv_dtype: str = "bf16", mxu: bool = False):
    """Least time for this call's work: each input byte read once (q, the
    K/V rows 0 .. pos + t - 1 of every lane with their scales for a
    quantized pool, the table entries of the blocks holding them,
    positions), each output byte written once; operations are the q.k and
    p.V products over the rows each lane's queries can see, q.k at the
    int8 / fp8 peak under quant_mxu."""
    from neuronx_distributed_llama3_2_tpu_torch import flops as fl

    b = len(c.positions)
    rows = [min(int(p) + c.t, c.kv_limit) for p in c.positions]
    row_bytes = c.d * 2 if kv_dtype == "bf16" else c.d + 2  # payload + fp16 scale
    kv_bytes = 2 * sum(rows) * c.nkv * row_bytes
    blocks = [-(-r // c.bs) for r in rows]
    io_bytes = 2 * (b * c.t * c.n * c.d * 2) + 4 * sum(blocks) + 4 * b
    seen = sum(int(p) + ti + 1 for p in c.positions for ti in range(c.t))
    half = 2 * seen * c.n * c.d  # one of the two products
    qk_peak = fl.H100_BF16_FLOPS_PER_S
    if mxu:
        qk_peak = fl.H100_INT8_OPS_PER_S if kv_dtype == "int8" else fl.H100_FP8_FLOPS_PER_S
    t_bytes = (kv_bytes + io_bytes) / fl.H100_HBM_BYTES_PER_S * 1e3
    t_ops = (half / qk_peak + half / fl.H100_BF16_FLOPS_PER_S) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), kv_bytes


def mode_label(kv_dtype: str, mxu: bool) -> str:
    """How the logs name a pool and kernel mode."""
    if kv_dtype == "bf16":
        return "bf16"
    return f"{kv_dtype} mode {6 if mxu else 3}"


def forced_launch(kernel: str, q, kp, vp, tables, pos, *, kv_limit, num_splits=None, **kw):
    """The call ``paged_flash_decode(q, ...)`` makes (q 4-dim), launched on
    the source ``kernel`` names ("split": csrc/paged_decode.cu, "tile":
    csrc/paged_decode_tile.cu, "t1": csrc/paged_decode_t1.cu) whatever the
    route would pick, at that source's own split count when ``num_splits``
    is None."""
    from neuronx_distributed_llama3_2_tpu_torch.kernels import paged_attention as pa

    nblk, splits, bps = pa._geometry(q, kp, tables, kv_limit, num_splits, source=kernel)
    return pa._launch(q, kp, vp, tables, pos, nblk, splits, bps, kernel=kernel, **kw)


#: csrc/paged_decode.cu at a call another source takes: the same-run yardstick
split_launch = functools.partial(forced_launch, "split")


def k4_source(kv_dtype: str, t: int, n: int, nkv: int, d: int) -> str:
    """The K4 source the port picks for a call: "t1", "tile" or "split"."""
    from neuronx_distributed_llama3_2_tpu_torch.kernels import paged_attention as pa
    from neuronx_distributed_llama3_2_tpu_torch.quantization import kv_cache as kv

    return pa.kernel_route(kv.kv_cache_torch_dtype(kv_dtype), t, n // nkv, d)


# the device kernels each source launches for one call, as the profiler
# names them: main kernel, then the combine where it is a launch of its own
SOURCE_KERNELS = {
    "tile": ("paged_decode_tile_kernel", "paged_decode_tile_combine"),
    "t1": ("paged_decode_t1_kernel",),
}


def split_yardstick(c: DecodeCase, kv_dtype: str, call, ref, label: str,
                    timing: bool = True):
    """For a case that csrc/paged_decode_tile.cu or csrc/paged_decode_t1.cu
    serves (None for any other): (device ms of csrc/paged_decode.cu at the
    same call, ``call(fn, i)`` with fn = split_launch, held to the same
    check; device ms of the serving source's main kernel; of its combine,
    or None where the main kernel merges the splits itself). Without
    ``timing`` only the check runs, and the times are None."""
    from neuronx_distributed_llama3_2_tpu_torch.kernels import paged_attention as pa

    src = k4_source(kv_dtype, c.t, c.n, c.nkv, c.d)
    if src == "split":
        return None
    elem, rel = decode_agreement(call(split_launch, 0), ref)
    check(elem <= 1.0 and rel <= LANE_REL_L2,
          f"{label}: paged_decode.cu disagrees with the plain version ({elem}, {rel})")
    if not timing:
        return None, None, None
    (split_ms,), _ = device_ms(functools.partial(call, split_launch))
    times, _ = device_ms(functools.partial(call, pa.paged_flash_decode),
                         matches=SOURCE_KERNELS[src])
    return split_ms, times[0], (times[1] if len(times) > 1 else None)


def source_note(c: DecodeCase, kv_dtype: str, yard) -> str:
    """Which source served a logged case, with paged_decode.cu's time beside
    the serving source's (``split_yardstick``'s result)."""
    if yard is None:
        return "paged_decode.cu"
    src = k4_source(kv_dtype, c.t, c.n, c.nkv, c.d)
    if yard[0] is None:
        return f"paged_decode_{src}.cu; paged_decode.cu agrees at the same call"
    combine = ("the splits merged in the same launch" if yard[2] is None
               else f"combine {yard[2]:.6f}")
    return (f"paged_decode_{src}.cu (its main kernel {yard[1]:.6f} ms, {combine}); "
            f"split_ms={yard[0]:.6f} (paged_decode.cu, same call)")


def run_paged_kernel_phase(cfg, served: dict, card: str, kv_dtype: str = "bf16",
                           mxu: bool = False, time_grid: bool = True, grid: bool = True,
                           probes: bool = True, time_served: bool = True):
    """K4 on one pool dtype and mode against its plain version at the grid
    and the served geometries, timed beside the plain version, the library
    yardstick (SDPA on K/V dequantized and gathered beforehand) and the
    bound. Without ``time_grid`` the grid's cases
    are checked (against the plain version, the yardstick and
    csrc/paged_decode.cu) and not timed, without ``time_served`` the served
    geometries too (and nothing is recorded); without ``grid`` only the
    served geometries run (a tp rank's, at its own head counts), and without
    ``probes`` the planted-fault probes are left to the full phase. At head
    dim 96 the check must also reject, once on each source, the kernel's
    output with scores that leave out columns 64-95 (``columns_left_out``).
    Returns ({source: the record of the served geometry it launched most},
    {source: its worst abs error over the cases it served})."""
    from neuronx_distributed_llama3_2_tpu_torch.kernels import paged_attention as pa
    from neuronx_distributed_llama3_2_tpu_torch.quantization import kv_cache as kv

    quantized = kv_dtype != "bf16"
    mode = mode_label(kv_dtype, mxu)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    worst_elem, worst_rel, records, worst_by, nan_checked = 0.0, 0.0, {}, {}, set()
    cols_checked = set()
    cases = paged_cases(cfg, served)
    if not grid:
        cases = [c for c in cases if c.serve_launches]
    for c in cases:
        src = k4_source(kv_dtype, c.t, c.n, c.nkv, c.d)
        q, kp, vp, tables, pos = build_case(c, gen)
        L = c.layers
        ks = vs = None
        if quantized:
            qdt = kv.kv_cache_torch_dtype(kv_dtype)
            kp, ks = kv.kv_quantize(kp, qdt)
            vp, vs = kv.kv_quantize(vp, qdt)

        def kernel(i, q=q):
            j = i % L
            return pa.paged_flash_decode(
                q, kp[j], vp[j], tables, pos, kv_limit=c.kv_limit, num_splits=c.splits,
                k_scale=None if ks is None else ks[j], v_scale=None if vs is None else vs[j],
                quant_mxu=mxu,
            )

        def plain(i, q=q):
            j = i % L
            return pa.paged_flash_decode_reference(
                q, kp[j], vp[j], tables, pos, kv_limit=c.kv_limit,
                k_scale=None if ks is None else ks[j], v_scale=None if vs is None else vs[j],
                quant_mxu=mxu,
            )

        out, ref = kernel(0), plain(0)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        check(bool(torch.isfinite(out).all()), f"{mode} {c.name}: non-finite kernel output")
        elem, rel = decode_agreement(out, ref)
        check(elem <= 1.0 and rel <= LANE_REL_L2,
              f"{mode} {c.name}: disagrees with the plain version (error {elem} x its "
              f"element limit, lane relative L2 {rel}; max_abs_err {err})")
        worst_by[src] = max(worst_by.get(src, 0.0), err)
        worst_elem, worst_rel = max(worst_elem, elem), max(worst_rel, rel)
        if mxu and kv_dtype != "int8" and src not in nan_checked:
            # the unsaturated fp8 cast of q: an element past the range
            # poisons its query row with NaN, in the kernel as in the plain
            # version (and the reference); once on each source
            nan_checked.add(src)
            bad = q.clone()
            bad[-1, 0, 3, 5] = 1000.0 if kv_dtype == "fp8_e4m3" else 7e4
            nan_k, nan_p = kernel(0, bad).isnan(), plain(0, bad).isnan()
            check(bool((nan_k == nan_p).all()) and bool(nan_p.any()),
                  f"{mode}: the kernel's NaN rows differ from the plain version's")
            log(f"kernel paged_decode [{mode}] [{c.name}] q element past the fp8 range: "
                f"{int(nan_k.sum())} NaN outputs, as the plain version")
        if c.d == 96 and src not in cols_checked:
            # the planted fault of a D 96 instance that reads one 64-column
            # box of K: the plain version's change added to the kernel's output
            cols_checked.add(src)
            bad = pa.paged_flash_decode_reference(
                q, columns_left_out(kp[0]), vp[0], tables, pos, kv_limit=c.kv_limit,
                k_scale=None if ks is None else ks[0], v_scale=None if vs is None else vs[0],
                quant_mxu=mxu)
            f_elem, f_rel = decode_agreement((out.float() + bad.float() - ref.float()).to(
                out.dtype), ref)
            log(f"kernel paged_decode [{mode}] [{c.name}] planted fault (the scores leave out "
                f"columns 64-95, paged_decode_{src}.cu's call): error {f_elem:.6g} x its "
                f"element limit, lane relative L2 {f_rel:.6g} (limits 1, {LANE_REL_L2})")
            check(f_elem > 1.0 or f_rel > LANE_REL_L2,
                  f"the {mode} check passes scores without columns 64-95 on {src}")

        # the yardstick: one library call over K/V dequantized and gathered
        # beforehand (neither in its time), same mask
        b, nblk = len(c.positions), c.kv_limit // c.bs
        blocks = tables[:, :nblk].long()
        k_all, v_all = kp[:, blocks], vp[:, blocks]
        if quantized:
            k_all = kv.kv_dequantize(k_all, ks[:, blocks], torch.bfloat16)
            v_all = kv.kv_dequantize(v_all, vs[:, blocks], torch.bfloat16)
        k_all = k_all.reshape(L, b, c.kv_limit, c.nkv, c.d).transpose(2, 3).contiguous()
        v_all = v_all.reshape(L, b, c.kv_limit, c.nkv, c.d).transpose(2, 3).contiguous()
        rows = torch.arange(c.kv_limit, device="cuda")
        last = pos.long()[:, None] + torch.arange(c.t, device="cuda")[None, :]
        mask = (rows[None, None, :] <= last[:, :, None])[:, None]  # (b, 1, t, S)
        qh = q.transpose(1, 2).contiguous()

        def library(i):
            return torch.nn.functional.scaled_dot_product_attention(
                qh, k_all[i % L], v_all[i % L], attn_mask=mask, enable_gqa=True,
            )

        lib_elem, lib_rel = decode_agreement(library(0).transpose(1, 2), ref)
        # the yardstick must compute the same function (its per-element
        # agreement, which depends on the library's own roundings, is
        # recorded); mode 6 quantizes q for its q.k dot and SDPA does not,
        # so there it is recorded only (the probe holds the kernel to mode
        # 6's arithmetic)
        check(mxu or lib_rel <= LANE_REL_L2,
              f"{mode} {c.name}: library yardstick disagrees (lane relative L2 {lib_rel})")
        timing = time_served if c.serve_launches else time_grid
        if timing:
            (ms,), wall_ms = device_ms(kernel)
            (plain_ms,), plain_wall_ms = device_ms(plain)
            (library_ms,), library_wall_ms = device_ms(library)

        def call(fn, i, num_splits=c.splits):
            j = i % L
            return fn(q, kp[j], vp[j], tables, pos, kv_limit=c.kv_limit,
                      num_splits=num_splits, k_scale=None if ks is None else ks[j],
                      v_scale=None if vs is None else vs[j], quant_mxu=mxu)

        yard = split_yardstick(c, kv_dtype, call, ref, f"{mode} {c.name}", timing)
        bound_ms, bound_by, kv_bytes = paged_bound(c, kv_dtype, mxu)
        splits = pa._geometry(q, kp[0], tables, c.kv_limit, c.splits)[1]
        served_by = f", {c.serve_launches} serve launches" if c.serve_launches else ""
        tag = "" if not quantized else f"[{mode}] "
        log(
            f"kernel paged_decode {tag}[{c.name}] b={b} N={c.n} NKV={c.nkv} D={c.d} "
            f"t={c.t} kv_limit={c.kv_limit} splits={splits} positions="
            f"{list(map(int, c.positions))}{served_by}: max_abs_err={err:.6g} "
            f"({elem:.4f} x its element limit, lane rel L2 {rel:.6g}; library "
            f"{lib_elem:.4f} x, {lib_rel:.6g}) "
            + (f"kernel_ms={ms:.6f} plain_ms={plain_ms:.6f} library_ms={library_ms:.6f} "
               if timing else "not timed (the grid of a quantized phase) ")
            + f"bound_ms={bound_ms:.6f} ({bound_by}; K+V bytes read {kv_bytes} / 3.35 TB/s)"
            + (f"; wall per call {wall_ms:.6f} / {plain_wall_ms:.6f} / {library_wall_ms:.6f} ms"
               if timing else "")
            + f"; {source_note(c, kv_dtype, yard)} | {card}"
        )
        # the JSON records time, for each source, the geometry the serve
        # launched most
        if timing and c.serve_launches > records.get(src, {}).get("launches", 0):
            records[src] = dict(
                launches=c.serve_launches, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by,
                **({} if yard is None else dict(split_ms=yard[0])),
            )
        del q, kp, vp, ks, vs, k_all, v_all
    torch.cuda.empty_cache()
    probed = [run_paged_probe(kv_dtype, mxu, card, t) for t in (1, PROBE_TILE_T)] if probes else []
    elem, rel = (max(x) for x in zip(*probed)) if probed else (0.0, 0.0)
    log(
        f"paged_decode [{mode}]: every case and the probes agree with the plain "
        f"version: each element within {ROW_ULPS} bf16 ulps of its own value plus "
        f"{ROW_ULPS} of its (lane, token, head) row's largest (worst "
        f"{max(worst_elem, elem):.6g} x that limit), each (lane, head) within relative "
        f"L2 {LANE_REL_L2} (worst {max(worst_rel, rel):.6g}); worst abs err by source "
        f"{worst_by}; tolerance: the same bf16 operands (dequantized and bf16-rounded for "
        "a quantized pool), fp32 accumulation in another order, bf16-rounded softmax weights"
    )
    for src, rec in records.items():
        del rec["launches"]
        rec["max_abs_err"] = worst_by[src]
    return records, worst_by



# the probe of run_paged_probe: 8 lanes of the 1B geometry over a 512-row
# table, each lane's last fresh row; odd rows give the V lanes an even
# number of rows to the last query. Held at t = 1 (csrc/paged_decode_t1.cu)
# and at PROBE_TILE_T, the served suffix prefill (csrc/paged_decode_tile.cu)
PROBE_POSITIONS = (511, 299, 201, 401, 511, 299, 201, 401)
PROBE_KV_LIMIT = 512
PROBE_TILE_T = 8


def probe_case(kv_dtype: str, device: str, t: int = 1):
    """Inputs on which the faults a quantized K4 could make move its output
    far past the tolerance, where on random data they stay within it
    (made from a seeded numpy generator, so that they are the same on any
    device). Lanes 0-3 (K lanes): every K row of a head is one large
    common vector plus small noise, and q is large; the softmax stays
    spread out (the common part of the scores cancels in it), while an
    error in q or in K of a fraction of an ulp moves every score by a
    sizeable step (q's int8 requantization, q's fp8 cast, or K's bf16
    rounding after dequantization). Lanes 4-7 (V lanes): the K rows of a
    head are equal, so every visible row weighs exactly 1 in both the
    kernel and the plain version, and V rows alternate in sign at a
    magnitude of 2-3: the output is a mean that cancels to a few
    thousandths and moves by many of its ulps if V's bf16 rounding after
    dequantization is skipped. At t > 1 each lane's t fresh rows end at
    its PROBE_POSITIONS row.
    Returns (q (b, t, N, D), k_pool, v_pool, k_scale, v_scale, tables,
    positions) for one layer; the scales are None for the bf16 pool."""
    from neuronx_distributed_llama3_2_tpu_torch.quantization import kv_cache as kv

    rng = np.random.default_rng(SEED + 2)
    b, n, nkv, d, bs, rows = 8, 32, 8, 64, 16, PROBE_KV_LIMIT
    k0 = 3.0 * rng.standard_normal((b, 1, nkv, d))
    k = np.broadcast_to(k0, (b, rows, nkv, d)).copy()
    k[:4] += 0.1 * rng.standard_normal((4, rows, nkv, d))
    v = rng.standard_normal((b, rows, nkv, d))
    # V lanes: row r is sign_r * m_r * c, with c in [2, 3) fixed per (lane,
    # head) and m_r in [1, 1.1): every row quantizes to the same payload
    # pattern at its own scale, so the dequantized rows round differently
    sign = np.where(np.arange(rows) % 2 == 0, 1.0, -1.0)[None, :, None, None]
    m = 1.0 + 0.1 * rng.random((4, rows, 1, 1))
    v[4:] = sign * m * (2.0 + rng.random((4, 1, nkv, d)))
    q = rng.standard_normal((b, t, n, d))
    q[:4] *= 10.0
    # a shuffled table; blocks past each lane's frontier are the null block
    w = rows // bs
    tables = 1 + rng.permutation(b * w).reshape(b, w)
    for i, p in enumerate(PROBE_POSITIONS):
        tables[i, p // bs + 1:] = 0
    k_pool = rng.standard_normal((b * w + 1, bs, nkv, d))  # garbage where unused
    v_pool = rng.standard_normal((b * w + 1, bs, nkv, d))
    for i in range(b):
        k_pool[tables[i]] = k[i].reshape(w, bs, nkv, d)
        v_pool[tables[i]] = v[i].reshape(w, bs, nkv, d)
    k_pool[0] = rng.standard_normal((bs, nkv, d))  # the null block stays garbage
    v_pool[0] = rng.standard_normal((bs, nkv, d))

    def on(x, dtype=torch.bfloat16):
        return torch.as_tensor(x, device=device).to(dtype)

    kp, vp, ks, vs = on(k_pool), on(v_pool), None, None
    if kv_dtype != "bf16":
        qdt = kv.kv_cache_torch_dtype(kv_dtype)
        kp, ks = kv.kv_quantize(kp, qdt)
        vp, vs = kv.kv_quantize(vp, qdt)
    pos = on(np.asarray(PROBE_POSITIONS) - (t - 1), torch.int32)
    return on(q), kp, vp, ks, vs, on(tables, torch.int32), pos


@contextlib.contextmanager
def plain_dequant_unrounded():
    """While the block runs, the plain version keeps a quantized pool's
    dequantized values in fp32, as a kernel that skipped their bf16
    rounding would (K and V in mode 3, V in mode 6)."""
    from neuronx_distributed_llama3_2_tpu_torch.kernels import paged_attention as pa

    inner = pa.kv_dequantize
    pa.kv_dequantize = lambda payload, scale, dtype: payload.float() * scale.float()[..., None]
    try:
        yield
    finally:
        pa.kv_dequantize = inner


def run_paged_probe(kv_dtype: str, mxu: bool, card: str, t: int = 1):
    """K4 against its plain version on ``probe_case``'s inputs at t, held by
    ``decode_agreement``, on the source the route gives the call (which it
    must have taken); then, for a quantized pool, the same check must
    reject the kernel's output with each planted fault (what the fault
    changes in the plain version, added to the kernel's output): the
    dequantized values left unrounded, and under quant_mxu mode 3's
    arithmetic (q neither requantized nor cast, K dequantized) passed off
    as mode 6. Returns the sound (element ratio, lane relative L2)."""
    from neuronx_distributed_llama3_2_tpu_torch.kernels import paged_attention as pa

    mode = mode_label(kv_dtype, mxu)
    q, kp, vp, ks, vs, tables, pos = probe_case(kv_dtype, "cuda", t)
    kw = dict(kv_limit=PROBE_KV_LIMIT, k_scale=ks, v_scale=vs)
    src = k4_source(kv_dtype, t, q.shape[2], kp.shape[2], q.shape[3])
    counter = {"t1": pa.t1_launches, "tile": pa.tile_launches}[src]
    before = counter.count
    out = pa.paged_flash_decode(q, kp, vp, tables, pos, num_splits=4, quant_mxu=mxu, **kw)
    check(counter.count == before + 1, f"{mode} probe t={t}: not on paged_decode_{src}.cu")
    ref = pa.paged_flash_decode_reference(q, kp, vp, tables, pos, quant_mxu=mxu, **kw)
    check(bool(torch.isfinite(out).all()), f"{mode} probe t={t}: non-finite kernel output")
    elem, rel = decode_agreement(out, ref)
    log(f"kernel paged_decode [{mode}] [probe t={t}, paged_decode_{src}.cu] positions "
        f"{pos.tolist()}: {elem:.6g} x its element limit, lane relative L2 {rel:.6g} "
        f"(limits 1, {LANE_REL_L2}) | {card}")
    check(elem <= 1.0 and rel <= LANE_REL_L2,
          f"{mode} probe t={t}: disagrees with the plain version ({elem}, {rel})")
    faults = {}
    if kv_dtype != "bf16":
        with plain_dequant_unrounded():
            faults["dequantized values left unrounded"] = pa.paged_flash_decode_reference(
                q, kp, vp, tables, pos, quant_mxu=mxu, **kw)
    if mxu:
        faults["mode 3's arithmetic"] = pa.paged_flash_decode_reference(
            q, kp, vp, tables, pos, quant_mxu=False, **kw)
    for name, bad in faults.items():
        planted = (out.float() + bad.float() - ref.float()).to(out.dtype)
        f_elem, f_rel = decode_agreement(planted, ref)
        log(f"kernel paged_decode [{mode}] [probe t={t}] planted fault ({name}): error "
            f"{f_elem:.6g} x its element limit, lane relative L2 {f_rel:.6g} (limits 1, "
            f"{LANE_REL_L2})")
        check(f_elem > 1.0 or f_rel > LANE_REL_L2,
              f"the {mode} check passes a planted fault ({name}) at t={t}")
    return elem, rel


# the probe of run_t1_probe: 8 lanes of the 1B geometry over a 512-row
# table, t = 1, at csrc/paged_decode_t1.cu's own split count (16 here)
T1_PROBE_KV_LIMIT = 512


def t1_probe_case(device: str = "cuda"):
    """Inputs that reach every edge of csrc/paged_decode_t1.cu's partition,
    made from a seeded numpy generator: lane 0 at row 0 (one block, one
    visible row), lanes 1-3 at a row that opens a pool block in a short
    context (the block holds the lane's newest row alone), lanes 4-6 at
    random rows, lane 7 at the last row under the limit; lanes 0-3 walk
    fewer blocks than the launch has splits. Random q and pools; blocks past
    each lane's frontier are the null block, which holds garbage. Returns
    (q (b, 1, N, D), k_pool, v_pool, tables, positions) for one layer."""
    rng = np.random.default_rng(SEED + 9)
    b, n, nkv, d, bs, rows = 8, 32, 8, 64, 16, T1_PROBE_KV_LIMIT
    pos = np.empty(b, np.int64)
    pos[0], pos[-1] = 0, rows - 1
    pos[1:4] = bs * rng.choice(np.arange(1, 8), size=3, replace=False)
    pos[4:7] = rng.integers(bs + 1, rows - 1, size=3)
    w = rows // bs
    tables = 1 + rng.permutation(b * w).reshape(b, w)
    for i, p in enumerate(pos):
        tables[i, p // bs + 1:] = 0
    pools = rng.standard_normal((2, b * w + 1, bs, nkv, d))
    q = rng.standard_normal((b, 1, n, d))

    def on(x, dtype=torch.bfloat16):
        return torch.as_tensor(x, device=device).to(dtype)

    return on(q), on(pools[0]), on(pools[1]), on(tables, torch.int32), on(pos, torch.int32)


def run_t1_probe(card: str):
    """csrc/paged_decode_t1.cu against the plain version on
    ``t1_probe_case``; then the same check must reject the kernel's output
    with each planted fault (what the fault changes in the plain version,
    added to the kernel's output): every lane's newest row left out (the
    plain version at positions - 1), and every lane's last range of
    ``t1_split_ranges`` left out (the plain version with its walk cut
    before that range, by row_live). The kernel is held so too with
    row_live and tree_bits at t = 1 (one-row blocks of modes 4 and 5).
    Returns the sound (element ratio, lane relative L2)."""
    from neuronx_distributed_llama3_2_tpu_torch.kernels import paged_attention as pa

    q, kp, vp, tables, pos = t1_probe_case()
    kw = dict(kv_limit=T1_PROBE_KV_LIMIT)
    t1 = pa.t1_launches.count
    out = pa.paged_flash_decode(q, kp, vp, tables, pos, **kw)
    check(pa.t1_launches.count == t1 + 1, "the t1 probe did not reach paged_decode_t1.cu")
    ref = pa.paged_flash_decode_reference(q, kp, vp, tables, pos, **kw)
    nblk, splits, _ = pa._geometry(q, kp, tables, T1_PROBE_KV_LIMIT, None)
    ranges = pa.t1_split_ranges(pos, nblk, splits)
    blocks = [r[-1][1] for r in ranges]
    check(min(blocks) < splits and int(pos[0]) == 0 and int(pos[-1]) == T1_PROBE_KV_LIMIT - 1
          and any(int(p) % 16 == 0 for p in pos[1:]),
          f"the t1 probe misses an edge: positions {pos.tolist()}, blocks {blocks}")
    elem, rel = decode_agreement(out, ref)
    log(f"kernel paged_decode_t1 [probe] positions {pos.tolist()} ({splits} splits; blocks "
        f"walked {blocks}, ranges {[len(r) for r in ranges]}): {elem:.6g} x its element "
        f"limit, lane relative L2 {rel:.6g} (limits 1, {LANE_REL_L2}) | {card}")
    check(elem <= 1.0 and rel <= LANE_REL_L2,
          f"t1 probe: disagrees with the plain version ({elem}, {rel})")
    last_range = torch.as_tensor([r[-1][0] * 16 for r in ranges], device="cuda") - pos
    faults = {
        "every lane's newest row left out": pa.paged_flash_decode_reference(
            q, kp, vp, tables, pos - 1, **kw),
        "every lane's last split range left out": pa.paged_flash_decode_reference(
            q, kp, vp, tables, pos, row_live=last_range, **kw),
    }
    for name, bad in faults.items():
        planted = (out.float() + bad.float() - ref.float()).to(out.dtype)
        f_elem, f_rel = decode_agreement(planted, ref)
        log(f"kernel paged_decode_t1 [probe] planted fault ({name}): error {f_elem:.6g} x its "
            f"element limit, lane relative L2 {f_rel:.6g} (limits 1, {LANE_REL_L2})")
        check(f_elem > 1.0 or f_rel > LANE_REL_L2,
              f"the t1 check passes a planted fault ({name})")
    rng = np.random.default_rng(SEED + 10)
    live = torch.as_tensor(rng.integers(0, 2, size=len(pos)), dtype=torch.int32, device="cuda")
    bits = torch.as_tensor(rng.integers(0, 2, size=(len(pos), 1)), dtype=torch.int32,
                           device="cuda")
    for extra in (dict(row_live=live), dict(tree_bits=bits), dict(row_live=live, tree_bits=bits)):
        m_elem, m_rel = decode_agreement(
            pa.paged_flash_decode(q, kp, vp, tables, pos, **extra, **kw),
            pa.paged_flash_decode_reference(q, kp, vp, tables, pos, **extra, **kw))
        log(f"kernel paged_decode_t1 [probe] with {' and '.join(extra)} "
            f"{[x.flatten().tolist() for x in extra.values()]}: {m_elem:.6g} x its element "
            f"limit, lane relative L2 {m_rel:.6g}")
        check(m_elem <= 1.0 and m_rel <= LANE_REL_L2,
              f"t1 probe with {' and '.join(extra)}: disagrees ({m_elem}, {m_rel})")
    check(pa.t1_launches.count == t1 + 4, "the t1 probe's launches left paged_decode_t1.cu")
    return elem, rel


# -- K4's row_live mode (the fused step's mixed-width tile) --------------------

def live_cases(cfg, f_served: dict):
    """F's row_live geometry launched most, at its median call, then t = 16
    cases of the 1B and 3B (D 128, G 3) geometries over 2048 rows, with
    random live counts and, in the even lanes, the last live row at the
    first row of a pool block."""
    rng = np.random.default_rng(SEED + 4)
    key, entry = max(((k, e) for k, e in f_served.items() if k[-1] == "row_live"),
                     key=lambda ke: ke[1]["calls"])
    b, t, kv_limit, splits, w, _ = key
    cases = [DecodeCase(
        f"F grid b{b} t{t} kv{kv_limit}", cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
        t, kv_limit, splits, np.asarray(entry["positions"]), table_width=w,
        serve_launches=entry["calls"], row_live=np.asarray(entry["row_live"]),
    )]
    for name, n, d in (("1b", 32, 64), ("3b", 24, 128)):
        t, kv_limit = SPEC_MAX_T, 2048
        live = rng.integers(1, t + 1, size=8)
        pos = rng.integers(0, kv_limit - t + 1, size=8)
        for j in range(0, 8, 2):
            pos[j] = 16 * rng.integers(1, kv_limit // 16 - 1) + 1 - live[j]
        cases.append(DecodeCase(
            f"{name} kv{kv_limit} t{t}", n, 8, d, t, kv_limit, None, pos, row_live=live,
        ))
    return cases


def walked_rows_of(c: DecodeCase):
    """Rows each lane's walk reads (the plain version's ``walked_rows``):
    whole blocks up to the one holding its last live row (its last fresh
    row without row_live), within kv_limit."""
    from neuronx_distributed_llama3_2_tpu_torch.kernels import paged_attention as pa

    live = None if c.row_live is None else torch.as_tensor(c.row_live)
    return pa.walked_rows(torch.as_tensor(c.positions), c.t, c.kv_limit // c.bs, c.bs,
                          live).tolist()


def run_row_live_phase(cfg, f_served: dict, card: str) -> dict:
    """K4 with row_live against its plain version (``decode_agreement`` on
    all rows, padding rows included) at ``live_cases``, for the bf16 pool
    and int8 mode 3; each case's live rows must be bitwise what the same
    launch without row_live gives. Timed beside the same launch without
    row_live, the plain version, the library yardstick (SDPA on K/V
    gathered and dequantized beforehand, masked as the walk) and the
    bound. Returns the record of F's grid case in bf16."""
    from neuronx_distributed_llama3_2_tpu_torch.kernels import paged_attention as pa
    from neuronx_distributed_llama3_2_tpu_torch.quantization import kv_cache as kv

    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    worst, worst_elem, worst_rel, record, tile_err = 0.0, 0.0, 0.0, None, 0.0
    for kv_dtype in ("bf16", "int8"):
        mode = mode_label(kv_dtype, False)
        for c in live_cases(cfg, f_served):
            q, kp, vp, tables, pos = build_case(c, gen)
            live = torch.as_tensor(c.row_live, dtype=torch.int32, device="cuda")
            L = c.layers
            ks = vs = None
            if kv_dtype != "bf16":
                kp, ks = kv.kv_quantize(kp, torch.int8)
                vp, vs = kv.kv_quantize(vp, torch.int8)

            def call(fn, i, with_live=True):
                j = i % L
                return fn(q, kp[j], vp[j], tables, pos, kv_limit=c.kv_limit,
                          k_scale=None if ks is None else ks[j],
                          v_scale=None if vs is None else vs[j],
                          **(dict(row_live=live) if with_live else {}))

            out = call(pa.paged_flash_decode, 0)
            full = call(pa.paged_flash_decode, 0, with_live=False)
            ref = call(pa.paged_flash_decode_reference, 0)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(out).all()), f"row_live {mode} {c.name}: non-finite")
            err = (out.float() - ref.float()).abs().max().item()
            elem, rel = decode_agreement(out, ref)
            check(elem <= 1.0 and rel <= LANE_REL_L2,
                  f"row_live {mode} {c.name}: disagrees with the plain version (error "
                  f"{elem} x its element limit, lane relative L2 {rel}; max_abs_err {err})")
            is_live = torch.arange(c.t, device="cuda")[None, :] < live[:, None]
            check(torch.equal(out[is_live], full[is_live]),
                  f"row_live {mode} {c.name}: live rows differ from the launch without row_live")
            worst = max(worst, err)
            worst_elem, worst_rel = max(worst_elem, elem), max(worst_rel, rel)

            b, nblk = len(c.positions), c.kv_limit // c.bs
            blocks = tables[:, :nblk].long()
            k_all, v_all = kp[:, blocks], vp[:, blocks]
            if ks is not None:
                k_all = kv.kv_dequantize(k_all, ks[:, blocks], torch.bfloat16)
                v_all = kv.kv_dequantize(v_all, vs[:, blocks], torch.bfloat16)
            k_all = k_all.reshape(L, b, c.kv_limit, c.nkv, c.d).transpose(2, 3).contiguous()
            v_all = v_all.reshape(L, b, c.kv_limit, c.nkv, c.d).transpose(2, 3).contiguous()
            mask = walk_mask(c)[:, None]
            qh = q.transpose(1, 2).contiguous()

            def library(i):
                return torch.nn.functional.scaled_dot_product_attention(
                    qh, k_all[i % L], v_all[i % L], attn_mask=mask, enable_gqa=True,
                )

            lib_elem, lib_rel = decode_agreement(library(0).transpose(1, 2), ref)
            check(lib_rel <= LANE_REL_L2,
                  f"row_live {mode} {c.name}: library yardstick disagrees ({lib_rel})")
            (ms,), wall_ms = device_ms(functools.partial(call, pa.paged_flash_decode))
            (full_ms,), _ = device_ms(
                functools.partial(call, pa.paged_flash_decode, with_live=False))
            (plain_ms,), _ = device_ms(functools.partial(call, pa.paged_flash_decode_reference))
            (library_ms,), _ = device_ms(library)
            yard = split_yardstick(c, kv_dtype, call, ref, f"row_live {mode} {c.name}")
            if yard is not None:
                tile_err = max(tile_err, err)
            bound_ms, bound_by, kv_bytes = walk_bound(c, kv_dtype)
            served_by = f", {c.serve_launches} serve launches" if c.serve_launches else ""
            log(f"kernel paged_decode row_live [{mode}] [{c.name}] b={b} N={c.n} NKV={c.nkv} "
                f"D={c.d} t={c.t} kv_limit={c.kv_limit} positions={list(map(int, c.positions))} "
                f"row_live={list(map(int, c.row_live))}{served_by}: max_abs_err={err:.6g} "
                f"({elem:.4f} x its element limit, lane rel L2 {rel:.6g}; library "
                f"{lib_elem:.4f} x, {lib_rel:.6g}); live rows bitwise equal to the launch "
                f"without row_live; kernel_ms={ms:.6f} (without row_live {full_ms:.6f}) "
                f"plain_ms={plain_ms:.6f} library_ms={library_ms:.6f} bound_ms={bound_ms:.6f} "
                f"({bound_by}; K+V bytes of the walked blocks {kv_bytes} / 3.35 TB/s); wall "
                f"per call {wall_ms:.6f} ms; {source_note(c, kv_dtype, yard)} | {card}")
            if record is None:
                record = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                              bound_ms=bound_ms, bound_by=bound_by, split_ms=yard[0])
            del q, kp, vp, ks, vs, k_all, v_all
        torch.cuda.empty_cache()
    elem, rel = run_row_live_probe(card)
    log(f"paged_decode row_live: every case and the probe agree with the plain version "
        f"on all rows: each element within {ROW_ULPS} bf16 ulps of its own value plus "
        f"{ROW_ULPS} of its row's largest (worst {max(worst_elem, elem):.6g} x that "
        f"limit), each (lane, head) within relative L2 {LANE_REL_L2} (worst "
        f"{max(worst_rel, rel):.6g}); worst abs err {worst:.6g}")
    record["max_abs_err"] = worst
    record["tile_err"] = tile_err
    return record


# the probe of run_row_live_probe: (last live row, live rows) per lane of
# the 1B geometry at t = 16; every last live row is the first row of a
# pool block, in short contexts, so a walk one row short drops a row that
# weighs about 1/17 to 1/65 of its query's softmax
ROW_LIVE_PROBE = ((16, 1), (16, 16), (32, 5), (32, 9), (48, 2), (48, 12), (64, 3), (64, 16))


def run_row_live_probe(card: str):
    """K4 with row_live against its plain version on lanes whose last live
    row opens a pool block; then a launch whose walk stops one row short
    (``row_live - 1``) must fail the same check. Returns the sound
    (element ratio, lane relative L2)."""
    from neuronx_distributed_llama3_2_tpu_torch.kernels import paged_attention as pa

    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    frontier = np.asarray([f for f, _ in ROW_LIVE_PROBE])
    live_np = np.asarray([n for _, n in ROW_LIVE_PROBE])
    c = DecodeCase("row_live probe", 32, 8, 64, SPEC_MAX_T, 128, 4, frontier - live_np + 1,
                   layers=1, row_live=live_np)
    q, kp, vp, tables, pos = build_case(c, gen)
    live = torch.as_tensor(live_np, dtype=torch.int32, device="cuda")
    kw = dict(kv_limit=c.kv_limit)
    out = pa.paged_flash_decode(q, kp[0], vp[0], tables, pos, num_splits=4, row_live=live, **kw)
    ref = pa.paged_flash_decode_reference(q, kp[0], vp[0], tables, pos, row_live=live, **kw)
    elem, rel = decode_agreement(out, ref)
    log(f"kernel paged_decode row_live [probe] positions {list(map(int, c.positions))} "
        f"row_live {list(map(int, live_np))}: {elem:.6g} x its element limit, lane "
        f"relative L2 {rel:.6g} (limits 1, {LANE_REL_L2}) | {card}")
    check(elem <= 1.0 and rel <= LANE_REL_L2,
          f"row_live probe: disagrees with the plain version ({elem}, {rel})")
    short = pa.paged_flash_decode(q, kp[0], vp[0], tables, pos, num_splits=4,
                                  row_live=live - 1, **kw)
    f_elem, f_rel = decode_agreement(short, ref)
    log(f"kernel paged_decode row_live [probe] planted fault (the walk one row short): "
        f"error {f_elem:.6g} x its element limit, lane relative L2 {f_rel:.6g} (limits 1, "
        f"{LANE_REL_L2})")
    check(f_elem > 1.0 or f_rel > LANE_REL_L2,
          "the row_live check passes a walk one row short")
    return elem, rel


# -- K4's tree_bits mode (tree speculation) and tiles wider than 64 rows ---------

def ancestor_bits(parents: np.ndarray) -> np.ndarray:
    """(b, t) int32 tree_bits of packed parents (b, t), as the model packs
    them."""
    from neuronx_distributed_llama3_2_tpu_torch.inference.model import tree_bits_of
    from neuronx_distributed_llama3_2_tpu_torch.inference.speculative import tree_topology

    return tree_bits_of(tree_topology(torch.as_tensor(parents))[1]).numpy()


def tree_cases(cfg, t_served: dict):
    """T's tree verify and mixed geometries launched most, at their median
    calls; random branching trees (each node's parent among the three
    before it) at t = 17, 25, 32 over 2048 rows, for the 1B and 3B (D 128,
    G 3) geometries, without row_live; a linear t = 32 block of the 1B
    geometry (128 tile rows, no tree), without and with row_live."""
    rng = np.random.default_rng(SEED + 7)
    cases = []
    for tag in (("tree",), ("row_live", "tree")):
        key, entry = max(((k, e) for k, e in t_served.items() if k[5:] == tag),
                         key=lambda ke: ke[1]["calls"])
        b, t, kv_limit, splits, w = key[:5]
        cases.append(DecodeCase(
            f"T {'mixed' if 'row_live' in tag else 'verify'} b{b} t{t} kv{kv_limit}",
            cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, t, kv_limit, splits,
            np.asarray(entry["positions"]), table_width=w, serve_launches=entry["calls"],
            row_live=None if entry["row_live"] is None else np.asarray(entry["row_live"]),
            tree_bits=np.asarray(entry["tree_bits"], np.int32),
        ))
    for name, n, d in (("1b", 32, 64), ("3b", 24, 128)):
        for t in (17, 25, 32):
            parents = np.zeros((8, t), np.int64)
            for j in range(1, t):
                parents[:, j] = rng.integers(max(0, j - 3), j, size=8)
            cases.append(DecodeCase(
                f"{name} kv2048 t{t} tree", n, 8, d, t, 2048, None,
                rng.integers(0, 2048 - t + 1, size=8), tree_bits=ancestor_bits(parents),
            ))
    pos = rng.integers(0, 2048 - TREE_MAX_T + 1, size=8)
    live = rng.integers(1, TREE_MAX_T + 1, size=8)
    for row_live in (None, live):
        cases.append(DecodeCase(
            f"1b kv2048 t{TREE_MAX_T} linear{' row_live' if row_live is not None else ''}",
            32, 8, 64, TREE_MAX_T, 2048, None, pos, row_live=row_live,
        ))
    return cases


def walk_mask(c: DecodeCase, device: str = "cuda") -> torch.Tensor:
    """(b, t, kv_limit) bool: the rows each query row sees within its
    lane's walk (cut by row_live where the case has it), under the ancestor
    mask (the block-causal mask without tree_bits); the plain version's
    mask."""
    rows = torch.arange(c.kv_limit, device=device)
    pos = torch.as_tensor(c.positions, device=device).long()
    if c.tree_bits is None:
        last = pos[:, None] + torch.arange(c.t, device=device)[None, :]
        seen = rows[None, None, :] <= last[:, :, None]
    else:
        u = rows[None, None, :] - pos[:, None, None]
        bits = torch.as_tensor(c.tree_bits, device=device).long()[:, :, None]
        seen = (u < 0) | ((u < c.t) & (((bits >> u.clamp(0, 31)) & 1) > 0))
    walked = torch.as_tensor(walked_rows_of(c), device=device)
    return seen & (rows[None, None, :] < walked[:, None, None])


def walk_bound(c: DecodeCase, kv_dtype: str = "bf16"):
    """Least time for a row_live or tree call: each input byte read once
    (q, the K/V rows of the blocks the lane's walk reads with their scales
    for a quantized pool, their table entries, positions, live counts and
    masks), each output byte written once; operations are the q.k and p.V
    products over the rows each query row sees within the walk (under
    tree_bits its ancestors and the committed prefix)."""
    from neuronx_distributed_llama3_2_tpu_torch import flops as fl

    b = len(c.positions)
    walked = walked_rows_of(c)
    row_bytes = c.d * 2 if kv_dtype == "bf16" else c.d + 2
    kv_bytes = 2 * sum(walked) * c.nkv * row_bytes
    io_bytes = (2 * (b * c.t * c.n * c.d * 2) + 4 * sum(x // c.bs for x in walked) + 4 * b
                + (4 * b if c.row_live is not None else 0)
                + (4 * b * c.t if c.tree_bits is not None else 0))
    seen = int(walk_mask(c, "cpu").sum())
    half = 2 * seen * c.n * c.d
    t_bytes = (kv_bytes + io_bytes) / fl.H100_HBM_BYTES_PER_S * 1e3
    t_ops = 2 * half / fl.H100_BF16_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), kv_bytes


def run_tree_kernel_phase(cfg, t_served: dict, card: str) -> dict:
    """K4 with tree_bits, and linear tiles of 128 rows, against the plain
    version (``decode_agreement`` on all rows) at ``tree_cases``, for the
    bf16 pool and int8 mode 3 (T's calls and the linear cases in bf16, as
    served). On every tree case the same launch with a chain's masks must
    give bitwise what it gives without tree_bits, and a launch with the
    block-causal mask in place of the ancestor mask (the planted fault)
    must fail the check; on a row_live case the live rows must be bitwise
    what the launch without row_live gives. T's served geometries are
    timed beside the plain version, the library yardstick (SDPA with the
    walk's ancestor mask on K/V gathered and dequantized beforehand) and
    the bound; the other cases are checked, not timed (the script's timing
    depth, PERF.md section 7). Returns the record of T's tree geometry
    launched most."""
    from neuronx_distributed_llama3_2_tpu_torch.kernels import paged_attention as pa
    from neuronx_distributed_llama3_2_tpu_torch.quantization import kv_cache as kv

    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    worst, worst_elem, worst_rel, record, probe = 0.0, 0.0, 0.0, None, []
    tile_err = 0.0
    cases = tree_cases(cfg, t_served)
    for kv_dtype in ("bf16", "int8"):
        mode = mode_label(kv_dtype, False)
        for c in cases:
            if kv_dtype != "bf16" and not c.name.endswith("tree"):
                continue
            q, kp, vp, tables, pos = build_case(c, gen)
            L = c.layers
            ks = vs = None
            if kv_dtype != "bf16":
                kp, ks = kv.kv_quantize(kp, torch.int8)
                vp, vs = kv.kv_quantize(vp, torch.int8)

            def arg(x):
                return None if x is None else torch.as_tensor(x, dtype=torch.int32,
                                                              device="cuda")

            live, bits = arg(c.row_live), arg(c.tree_bits)

            def call(fn, i, tree_bits=bits, row_live=live):
                j = i % L
                splits = {} if fn is pa.paged_flash_decode_reference else dict(
                    num_splits=c.splits)
                return fn(q, kp[j], vp[j], tables, pos, kv_limit=c.kv_limit,
                          k_scale=None if ks is None else ks[j],
                          v_scale=None if vs is None else vs[j], row_live=row_live,
                          tree_bits=tree_bits, **splits)

            out = call(pa.paged_flash_decode, 0)
            ref = call(pa.paged_flash_decode_reference, 0)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(out).all()), f"tree {mode} {c.name}: non-finite")
            err = (out.float() - ref.float()).abs().max().item()
            elem, rel = decode_agreement(out, ref)
            check(elem <= 1.0 and rel <= LANE_REL_L2,
                  f"tree {mode} {c.name}: disagrees with the plain version (error {elem} x "
                  f"its element limit, lane relative L2 {rel}; max_abs_err {err})")
            worst = max(worst, err)
            worst_elem, worst_rel = max(worst_elem, elem), max(worst_rel, rel)
            notes = []
            if bits is not None:
                chain = arg(ancestor_bits(np.broadcast_to(
                    np.maximum(np.arange(c.t) - 1, 0), (len(c.positions), c.t)).copy()))
                check(torch.equal(call(pa.paged_flash_decode, 0, tree_bits=chain),
                                  call(pa.paged_flash_decode, 0, tree_bits=None)),
                      f"tree {mode} {c.name}: a chain's masks differ from no tree_bits")
                notes.append("chain bitwise = no tree_bits")
                # the planted fault, held on the random trees (every lane
                # branches there) and logged on T's calls
                causal = call(pa.paged_flash_decode, 0, tree_bits=None)
                f_elem, f_rel = decode_agreement(causal, ref)
                if c.name.endswith("tree"):
                    check(f_elem > 1.0 or f_rel > LANE_REL_L2,
                          f"the tree check passes the block-causal mask on {mode} {c.name}")
                    probe.append(f_elem)
                notes.append(f"planted fault (block-causal mask) {f_elem:.6g} x, {f_rel:.6g}")
            if live is not None:
                full = call(pa.paged_flash_decode, 0, row_live=None)
                is_live = torch.arange(c.t, device="cuda")[None, :] < live[:, None]
                check(torch.equal(out[is_live], full[is_live]),
                      f"tree {mode} {c.name}: live rows differ from the launch without row_live")
                notes.append("live rows bitwise = no row_live")

            b, nblk = len(c.positions), c.kv_limit // c.bs
            blocks = tables[:, :nblk].long()
            k_all, v_all = kp[:, blocks], vp[:, blocks]
            if ks is not None:
                k_all = kv.kv_dequantize(k_all, ks[:, blocks], torch.bfloat16)
                v_all = kv.kv_dequantize(v_all, vs[:, blocks], torch.bfloat16)
            k_all = k_all.reshape(L, b, c.kv_limit, c.nkv, c.d).transpose(2, 3).contiguous()
            v_all = v_all.reshape(L, b, c.kv_limit, c.nkv, c.d).transpose(2, 3).contiguous()
            mask = walk_mask(c)[:, None]
            qh = q.transpose(1, 2).contiguous()

            def library(i):
                return torch.nn.functional.scaled_dot_product_attention(
                    qh, k_all[i % L], v_all[i % L], attn_mask=mask, enable_gqa=True,
                )

            lib_elem, lib_rel = decode_agreement(library(0).transpose(1, 2), ref)
            check(lib_rel <= LANE_REL_L2,
                  f"tree {mode} {c.name}: library yardstick disagrees ({lib_rel})")
            timing = c.serve_launches > 0
            if timing:
                (ms,), wall_ms = device_ms(functools.partial(call, pa.paged_flash_decode))
                (plain_ms,), _ = device_ms(functools.partial(call, pa.paged_flash_decode_reference))
                (library_ms,), _ = device_ms(library)
            yard = split_yardstick(c, kv_dtype, call, ref, f"tree {mode} {c.name}", timing)
            if yard is not None:
                tile_err = max(tile_err, err)
            bound_ms, bound_by, kv_bytes = walk_bound(c, kv_dtype)
            served_by = f", {c.serve_launches} serve launches" if c.serve_launches else ""
            extra = "" if c.row_live is None else f" row_live={list(map(int, c.row_live))}"
            log(f"kernel paged_decode tree [{mode}] [{c.name}] b={b} N={c.n} NKV={c.nkv} "
                f"D={c.d} t={c.t} ({c.t * c.n // c.nkv} tile rows) kv_limit={c.kv_limit} "
                f"positions={list(map(int, c.positions))}{extra}{served_by}: "
                f"max_abs_err={err:.6g} ({elem:.4f} x its element limit, lane rel L2 "
                f"{rel:.6g}; library {lib_elem:.4f} x, {lib_rel:.6g}); {'; '.join(notes or ['linear'])}; "
                + (f"kernel_ms={ms:.6f} plain_ms={plain_ms:.6f} library_ms={library_ms:.6f} "
                   if timing else "not timed (not a served geometry) ")
                + f"bound_ms={bound_ms:.6f} ({bound_by}; K+V bytes of the walked blocks "
                f"{kv_bytes} / 3.35 TB/s); "
                + (f"wall per call {wall_ms:.6f} ms; " if timing else "")
                + f"{source_note(c, kv_dtype, yard)} | {card}")
            if c.serve_launches and kv_dtype == "bf16" and (
                    record is None or c.serve_launches > record["launches"]):
                record = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                              bound_ms=bound_ms, bound_by=bound_by, launches=c.serve_launches,
                              split_ms=yard[0])
            del q, kp, vp, ks, vs, k_all, v_all
        torch.cuda.empty_cache()
    log(f"paged_decode tree_bits and wide tiles: every case agrees with the plain version "
        f"on all rows: each element within {ROW_ULPS} bf16 ulps of its own value plus "
        f"{ROW_ULPS} of its row's largest (worst {worst_elem:.6g} x that limit), each "
        f"(lane, head) within relative L2 {LANE_REL_L2} (worst {worst_rel:.6g}); worst abs "
        f"err {worst:.6g}; the block-causal mask in place of the ancestor mask fails on "
        f"every random tree case ({min(probe):.6g} x the element limit at least)")
    del record["launches"]
    record["max_abs_err"] = worst
    record["tile_err"] = tile_err
    return record


# the probe of run_tile_probe: first fresh rows per lane of the 1B geometry
# at t = 32 (128 tile rows) in contexts of 32-512 rows; every lane's last
# fresh row closes a pool block, so the last block its walk stages holds
# the fresh block's last 16 rows, which 16 of its 32 queries see
TILE_PROBE_POSITIONS = (0, 16, 48, 96, 160, 240, 336, 480)
TILE_PROBE_KV_LIMIT = 512


def run_tile_probe(card: str, kv_dtype: str = "bf16", mxu: bool = False):
    """csrc/paged_decode_tile.cu against the plain version on
    TILE_PROBE_POSITIONS, on a ``kv_dtype`` pool (mode 6 under ``mxu``);
    then the same launch with each lane's walk cut before the last pool
    block it stages (a row_live that ends the lane's live rows at that
    block's first row: the ring neither stages nor computes it) must fail
    the same check. Returns the sound (element ratio, lane relative L2)."""
    from neuronx_distributed_llama3_2_tpu_torch.kernels import paged_attention as pa
    from neuronx_distributed_llama3_2_tpu_torch.quantization import kv_cache as kv

    mode = mode_label(kv_dtype, mxu)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    c = DecodeCase("tile probe", 32, 8, 64, TREE_MAX_T, TILE_PROBE_KV_LIMIT, 4,
                   np.asarray(TILE_PROBE_POSITIONS), layers=1)
    q, kp, vp, tables, pos = build_case(c, gen)
    kp, vp = kp[0], vp[0]
    scales = {}
    if kv_dtype != "bf16":
        qdt = kv.kv_cache_torch_dtype(kv_dtype)
        kp, ks = kv.kv_quantize(kp, qdt)
        vp, vs = kv.kv_quantize(vp, qdt)
        scales = dict(k_scale=ks, v_scale=vs, quant_mxu=mxu)
    kw = dict(kv_limit=c.kv_limit, num_splits=c.splits, **scales)
    tile0 = pa.tile_launches.count
    out = pa.paged_flash_decode(q, kp, vp, tables, pos, **kw)
    check(pa.tile_launches.count == tile0 + 1,
          f"the {mode} tile probe did not reach the tile kernel")
    ref = pa.paged_flash_decode_reference(q, kp, vp, tables, pos, kv_limit=c.kv_limit,
                                          **scales)
    elem, rel = decode_agreement(out, ref)
    log(f"kernel paged_decode_tile [{mode}] [probe] positions {list(TILE_PROBE_POSITIONS)} "
        f"t={c.t} ({c.t * c.n // c.nkv} tile rows): {elem:.6g} x its element limit, lane "
        f"relative L2 {rel:.6g} (limits 1, {LANE_REL_L2}) | {card}")
    check(elem <= 1.0 and rel <= LANE_REL_L2,
          f"{mode} tile probe: disagrees with the plain version ({elem}, {rel})")
    last_block = (pos + c.t - 1) // c.bs * c.bs
    short = forced_launch("tile", q, kp, vp, tables, pos, row_live=last_block - pos, **kw)
    f_elem, f_rel = decode_agreement(short, ref)
    log(f"kernel paged_decode_tile [{mode}] [probe] planted fault (the walk without its last "
        f"staged block): error {f_elem:.6g} x its element limit, lane relative L2 "
        f"{f_rel:.6g} (limits 1, {LANE_REL_L2})")
    check(f_elem > 1.0 or f_rel > LANE_REL_L2,
          f"the {mode} tile check passes a walk without its last staged block")
    return elem, rel


# -- 3. serve -------------------------------------------------------------------

def serve_prompts():
    """Eight greedy prompts, 20 to 700 tokens; two share a 256-token prefix
    and differ by suffixes of 5 and 8 tokens."""
    rng = np.random.default_rng(SEED + 1)
    vocab = 128256
    shared = rng.integers(0, vocab, size=256).tolist()
    lengths = (23, 700, 130, None, None, 511, 64, 333)
    prompts = []
    for i, n in enumerate(lengths):
        if n is None:
            prompts.append(shared + rng.integers(0, vocab, size=5 if i == 3 else 8).tolist())
        else:
            prompts.append(rng.integers(0, vocab, size=n).tolist())
    return prompts


MAX_NEW = 32


def load_model():
    """Llama-3.2 1B at full width, bf16, seeded random weights, on the card."""
    from neuronx_distributed_llama3_2_tpu_torch.models.llama import (
        LLAMA_CONFIGS,
        LlamaForCausalLM,
    )

    cfg = dataclasses.replace(LLAMA_CONFIGS["llama3.2-1b"], use_paged_kernel=True)
    check(cfg.dtype == torch.bfloat16 and cfg.hidden_size == 2048, "not the 1B config")
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device="cuda").init_weights(SEED)
    torch.cuda.synchronize()
    log(f"serve: llama3.2-1b, {cfg.num_layers} layers, hidden {cfg.hidden_size}, "
        f"vocab {cfg.vocab_size}, heads {cfg.num_heads}/{cfg.num_kv_heads}, "
        f"head_dim {cfg.head_dim}, rope_scaling {cfg.rope_scaling}, bf16, "
        f"seeded random weights ({time.perf_counter() - t0:.3f} s to init)")
    return cfg, model


def make_server(cfg, model, drafter=None, sampling=None, injector=None, **paged_kw):
    """The paged engine as served here: 8 lanes, 2048-token sequences, a
    2049-block pool of 16-row blocks (block 0 the null block); ``paged_kw``
    adds or replaces PagedConfig knobs (the quantized serves' pool dtype,
    quant_mxu and prefill chunk, speculation, on-device sampling, a
    smaller pool, the fault-tolerance knobs), ``drafter`` replaces the
    n-gram drafter, ``sampling`` (a SamplingConfig) the greedy default,
    ``injector`` hooks a FaultInjector in."""
    from neuronx_distributed_llama3_2_tpu_torch.inference.engine import (
        GenerationConfig,
        InferenceEngine,
    )
    from neuronx_distributed_llama3_2_tpu_torch.serving.engine import (
        PagedConfig,
        PagedServingEngine,
    )

    engine = InferenceEngine(cfg, model, max_batch=8, max_seq_len=2048)
    paged = PagedConfig(**{
        **dict(block_size=16, num_blocks=2049,
               # small rungs let a short suffix prefill ride the kernel (t <= 8)
               prefill_buckets=(8, 16, 32, 64, 128, 256, 512, 1024, 2048)),
        **paged_kw,
    })
    gen = GenerationConfig(max_new_tokens=MAX_NEW,
                           **(dict(sampling=sampling) if sampling is not None else {}))
    return PagedServingEngine(engine, gen, paged, drafter=drafter, injector=injector)


def run_serve_phase(cfg, model, card: str):
    from neuronx_distributed_llama3_2_tpu_torch.kernels import paged_attention as pa

    prompts = serve_prompts()
    # warm-up: the same requests on a server of their own, so that library
    # handles, matmul algorithm choices for every prefill rung and the
    # allocator's pools are set up outside the timed and counted run, and
    # the timed server starts with an empty prefix cache. The warm-up also
    # keeps the positions of each kernel geometry's last call: it is the
    # same serve, and reading positions back costs a sync per call that
    # the timed run should not pay
    warm_geoms: dict = {}
    with model_kernel_call(recording(warm_geoms, keep_positions=True)):
        warm = make_server(cfg, model)
        for p in prompts:
            warm.submit(p)
        warm.run_to_completion()
    del warm

    server = make_server(cfg, model)
    geoms: dict = {}
    with model_kernel_call(recording(geoms, keep_positions=False)):
        pa.launches.reset()
        pa.tile_launches.reset()
        pa.t1_launches.reset()
        server.model.attention_paths.clear()
        steps0 = server.metrics.decode_steps
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rids = [server.submit(p) for p in prompts]
        outs = server.run_to_completion()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, tile, t1 = pa.launches.count, pa.tile_launches.count, pa.t1_launches.count
    paths = dict(server.model.attention_paths)
    decode_steps = server.metrics.decode_steps - steps0

    infos = [server.request_info(r) for r in rids]
    for r, info in zip(rids, infos):
        check(info["status"] == "finished", f"request {r} is {info['status']}")
        check(len(outs[r]) == MAX_NEW, f"request {r} produced {len(outs[r])} tokens")
    check(infos[4]["cached_tokens"] >= 256, f"prefix pair not shared: {infos[4]}")
    check(launches >= decode_steps * cfg.num_layers,
          f"{launches} kernel launches for {decode_steps} decode steps")
    check(paths.get("kernel", 0) == launches and not paths.get("gather"),
          f"attention paths {paths} vs {launches} kernel launches")
    check(sum(e["calls"] for e in geoms.values()) == launches,
          f"kernel geometries {geoms} vs {launches} launches")
    check({k: e["calls"] for k, e in geoms.items()}
          == {k: e["calls"] for k, e in warm_geoms.items()},
          f"the warm-up's kernel geometries {warm_geoms} differ from the serve's {geoms}")
    served = {k: dict(calls=e["calls"], positions=median_call(warm_geoms[k]["positions"]))
              for k, e in geoms.items()}
    generated = sum(len(outs[r]) for r in rids)
    ttft = np.median([i["ttft_ms"] for i in infos])
    tpot = np.median([i["tpot_ms"] for i in infos])
    log(f"serve: {len(rids)} requests, {generated} tokens in {wall:.6f} s = "
        f"{generated / wall:.6f} tokens/s; TTFT p50 {ttft:.6f} ms, TPOT p50 "
        f"{tpot:.6f} ms; cached_tokens {[i['cached_tokens'] for i in infos]}; "
        f"{decode_steps} decode steps | {card}")
    routes = check_routes("serve", cfg, geoms, launches, tile, t1)
    log(f"serve: paged_decode kernel launches {launches} ({routes}); attention calls by "
        f"path {paths} (context = whole-prompt prefill in plain torch, kernel = "
        f"paged-decode kernel, gather = block-table gather + plain torch) | {card}")
    for (b, t, kv_limit, splits, w), e in sorted(served.items()):
        log(f"serve: kernel geometry b={b} t={t} kv_limit={kv_limit} "
            f"num_splits={splits} W={w}: {e['calls']} launches")
    return prompts, outs, rids, tile, t1, served, server.metrics.pool_bytes_total


#: K4's main kernel of each source, as the profiler names it (the tile and
#: split sources also launch a combine kernel a call)
K4_KERNELS = {"t1": "paged_decode_t1_kernel", "tile": "paged_decode_tile_kernel",
              "split": "paged_decode_split_kernel"}


def k4_counts() -> dict:
    """K4's wrapper launch counters by source (``K4_KERNELS``' keys)."""
    from neuronx_distributed_llama3_2_tpu_torch.kernels import paged_attention as pa

    t1, tile = pa.t1_launches.count, pa.tile_launches.count
    return dict(t1=t1, tile=tile, split=pa.launches.count - t1 - tile)


@contextlib.contextmanager
def counted_captures():
    """Within the block, every ``torch.cuda.graph`` capture records the K4
    launches its wrappers counted while it captured (the kernels the graph
    holds, which each replay launches again) in the yielded dict, keyed by
    the graph's ``id``."""
    held = {}
    plain = torch.cuda.graph

    class graph(plain):
        def __enter__(self):
            self._k4_at = k4_counts()
            return super().__enter__()

        def __exit__(self, *exc):
            out = super().__exit__(*exc)
            now = k4_counts()
            held[id(self.cuda_graph)] = {s: now[s] - self._k4_at[s] for s in now}
            return out

    torch.cuda.graph = graph
    try:
        yield held
    finally:
        torch.cuda.graph = plain


def replayed_k4(server, held: dict) -> dict:
    """K4's launches by source in a prewarmed server's replays so far: each
    record's replays times the launches its graph captured (``held``, from
    ``counted_captures``)."""
    total = dict.fromkeys(K4_KERNELS, 0)
    for rec in server.program_registry().values():
        for s, n in held[id(rec.graph)].items():
            total[s] += rec.replays * n
    return total


def serve_stats(server, rids, outs, wall_s: float) -> dict:
    """tokens/s, TTFT p50 and TPOT p50 (ms) of a finished serve."""
    infos = [server.request_info(r) for r in rids]
    return dict(
        tokens_s=sum(len(outs[r]) for r in rids) / wall_s,
        ttft=float(np.median([i["ttft_ms"] for i in infos])),
        tpot=float(np.median([i["tpot_ms"] for i in infos])),
    )


def staged_serve(knobs: dict) -> bool:
    """Whether a serve with PagedConfig ``knobs`` submits as ``serve_staged``
    does: the quantized and speculative serves (chunked prefill), not
    Serve, whatever its sampling."""
    return bool(set(knobs) - {"on_device_sampling"})


def serve_requests(server, prompts, staged: bool):
    """Submit ``prompts`` and run the server to completion: all at once, or
    as ``serve_staged`` submits them (the quantized and speculative serves).
    Returns (rids in prompt order, outputs by rid)."""
    if staged:
        return serve_staged(server, prompts)
    rids = [server.submit(p) for p in prompts]
    return rids, server.run_to_completion()


def run_profile_phase(cfg, model, prompts, card: str, label: str = "serve",
                      prewarm: bool = False, async_loop: bool = False, sampling=None,
                      **knobs) -> dict:
    """The same requests once more on a fresh pool, under torch.profiler:
    the share of the wall time the card was busy, and the kernels that
    took it. ``knobs`` are a quantized or speculative serve's PagedConfig
    knobs; its requests are submitted as it submits them
    (``serve_staged``). ``prewarm``: the server captures its programs as
    CUDA graphs before the profiler starts; ``async_loop``: it runs the
    async decode loop; ``sampling``: its SamplingConfig. Returns the serve's
    wall and busy ms, K4's launches by source as the profiler counted its
    kernels, the outputs in prompt order and ``serve_stats``; under
    ``prewarm`` also K4's launches by source in the serve's replays
    (``replayed_k4``), which the profiler's count must not exceed."""
    with counted_captures() as held:
        server = make_server(cfg, model, prewarm=prewarm, async_loop=async_loop,
                             sampling=sampling, **knobs)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rids, outs = serve_requests(server, prompts, staged=staged_serve(knobs))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms, launches = profile_reading(prof, wall_ms, server, label, card)
    replayed = replayed_k4(server, held) if prewarm else None
    return dict(wall=wall_ms, busy=busy_ms, launches=launches, replayed=replayed,
                outs=[outs[r] for r in rids], **serve_stats(server, rids, outs, wall_ms / 1e3))


def profile_reading(prof, wall_ms: float, server, label: str, card: str):
    """A profiled serve's device busy ms and K4's launches by source as the
    profiler counted its kernels; logs the share of the wall and the
    kernels that took the most device time."""
    events = sorted(
        prof.key_averages(), key=lambda e: e.self_device_time_total, reverse=True,
    )
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    paged_ms = sum(
        e.self_device_time_total for e in events if "paged_decode" in e.key
    ) / 1e3
    by_source = {
        src: sum(e.self_device_time_total for e in events if f"paged_decode_{src}" in e.key) / 1e3
        for src in ("tile", "t1")
    }
    launches = {src: sum(e.count for e in events if name in e.key)
                for src, name in K4_KERNELS.items()}
    log(f"profile: {label} wall {wall_ms:.6f} ms (profiler on), device busy "
        f"{busy_ms:.6f} ms = {100 * busy_ms / wall_ms:.6f}% of it; paged_decode "
        f"kernels {paged_ms:.6f} ms = {100 * paged_ms / busy_ms:.6f}% of device "
        f"time, of them " + ", ".join(
            f"paged_decode_{src} {ms:.6f} ms = {100 * ms / busy_ms:.6f}%"
            for src, ms in by_source.items())
        + f"; {server.metrics.decode_steps} decode steps, "
        f"{server.metrics.decode_steps_async} of them async | {card}")
    for e in events[:12]:
        log(f"  device {e.self_device_time_total / 1e3:.6f} ms, {e.count} calls: "
            f"{e.key[:100]}")
    return busy_ms, launches


# -- 4. end to end --------------------------------------------------------------

def e2e_gaps(model, prompts, outs, rids, picks=None):
    """Teacher-forced over the ``picks`` requests (all by default): the
    plain full-sequence forward on prompt + served tokens. Returns the
    largest gap between the argmax logit and the served token's logit, and
    how many of the served tokens were the argmax, of how many."""
    worst_gap, exact, total = 0.0, 0, 0
    for j in range(len(prompts)) if picks is None else picks:
        prompt, gen = prompts[j], outs[rids[j]]
        ids = torch.as_tensor([prompt + gen[:-1]], device="cuda")
        logits = model(ids)[0, len(prompt) - 1:].float()  # predicts gen[0..]
        check(bool(torch.isfinite(logits).all()), "non-finite plain logits")
        tokens = torch.as_tensor(gen, device="cuda")
        chosen = logits[torch.arange(len(gen), device="cuda"), tokens]
        worst_gap = max(worst_gap, (logits.max(dim=-1).values - chosen).max().item())
        exact += int((logits.argmax(dim=-1) == tokens).sum())
        total += len(gen)
    return worst_gap, exact, total


def newest_row_dropped(inner, q, k_pool, v_pool, tables, positions, **kw):
    """A ``model_kernel_call`` wrapper planting a kernel fault: the newest
    visible row of every query masked off (at decode, the token's own
    K/V)."""
    return inner(q, k_pool, v_pool, tables, (positions - 1).clamp_min(0), **kw)


def columns_left_out(x: torch.Tensor, first: int = 64) -> torch.Tensor:
    """``x`` (K, or a K pool) with its head columns from ``first`` on set to
    0: with it the plain versions compute the scores a D 96 kernel instance
    that read one 64-column box of its operands would (the D 96 checks'
    planted fault; a zero payload dequantizes to 0)."""
    out = x.clone()
    (out.view(torch.uint8) if out.element_size() == 1 else out)[..., first:] = 0
    return out


def run_e2e_phase(cfg, model, prompts, outs, rids) -> None:
    """Every served token of every request must be the plain forward's
    argmax or within E2E_LOGIT_MARGIN of it; and the same check must reject
    a serve through a planted kernel fault (the newest visible row of every
    query masked off: at decode, the token's own K/V), or it could not tell
    a wrong kernel from a right one."""
    gap, exact, total = e2e_gaps(model, prompts, outs, rids)
    log(f"e2e: {exact}/{total} served tokens are the plain forward's argmax; "
        f"worst logit gap {gap:.6g} (margin {E2E_LOGIT_MARGIN}); every request "
        f"(worst gap, argmax tokens): {per_request_gaps(model, prompts, outs, rids)}")
    check(gap <= E2E_LOGIT_MARGIN, f"a served token is {gap} below the argmax logit")
    with model_kernel_call(newest_row_dropped):
        server = make_server(cfg, model)
        bad_rids = [server.submit(p) for p in prompts]
        bad_outs = server.run_to_completion()
    bad_gap, bad_exact, _ = e2e_gaps(model, prompts, bad_outs, bad_rids)
    log(f"e2e planted fault (newest row masked off in every kernel call): "
        f"{bad_exact}/{total} served tokens are the plain forward's argmax; "
        f"worst logit gap {bad_gap:.6g} (margin {E2E_LOGIT_MARGIN})")
    check(bad_gap > E2E_LOGIT_MARGIN,
          f"the e2e check passes a planted kernel fault (gap {bad_gap})")



# -- 4b. the quantized serves --------------------------------------------------

def serve_staged(server, prompts):
    """Submit every prompt but the second of the prefix pair, step until
    the first of the pair has finished its chunked prefill, then submit the
    second and run to completion. A chunked prompt's prefix is registered
    only when its last chunk lands (as in the JAX engine), so the second
    of the pair, 264 tokens, would share nothing if it arrived in the same
    wave. Returns (rids in prompt order, outputs by rid)."""
    rids = [None] * len(prompts)
    for j, p in enumerate(prompts):
        if j != 4:
            rids[j] = server.submit(p)
    while server.request_info(rids[3])["status"] in ("queued", "prefilling"):
        server.step()
    rids[4] = server.submit(prompts[4])
    return rids, server.run_to_completion()


def quant_pool_bytes(cfg, num_blocks: int = 2049, block_size: int = 16) -> int:
    """K and V pools of 1-byte payloads plus one fp16 scale per (row, kv
    head), every layer."""
    return 2 * cfg.num_layers * num_blocks * block_size * cfg.num_kv_heads * (cfg.head_dim + 2)


def run_quant_serve_phase(cfg, model, label: str, kv_dtype: str, mxu: bool,
                          bf16_pool_bytes: int, card: str):
    """One quantized, chunked serve of the eight prompts after a warm-up
    serve of its own (which also records the positions of each kernel
    geometry's last call), the kernel counters zeroed just before and read
    just after. Returns (prompts, outputs, rids, K4 launches, of them
    csrc/paged_decode_t1.cu's, served geometries)."""
    from neuronx_distributed_llama3_2_tpu_torch.kernels import paged_attention as pa

    prompts = serve_prompts()
    knobs = dict(kv_cache_dtype=kv_dtype, quant_mxu=mxu, prefill_chunk_tokens=QUANT_CHUNK)
    warm_geoms: dict = {}
    with model_kernel_call(recording(warm_geoms, keep_positions=True)):
        serve_staged(make_server(cfg, model, **knobs), prompts)

    server = make_server(cfg, model, **knobs)
    geoms: dict = {}
    with model_kernel_call(recording(geoms, keep_positions=False)):
        pa.launches.reset()
        pa.tile_launches.reset()
        pa.t1_launches.reset()
        server.model.attention_paths.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rids, outs = serve_staged(server, prompts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, tile, t1 = pa.launches.count, pa.tile_launches.count, pa.t1_launches.count
    paths = dict(server.model.attention_paths)
    m = server.metrics
    infos = [server.request_info(r) for r in rids]
    for r, info in zip(rids, infos):
        check(info["status"] == "finished", f"{label}: request {r} is {info['status']}")
        check(len(outs[r]) == MAX_NEW, f"{label}: request {r} produced {len(outs[r])} tokens")
    check(infos[4]["cached_tokens"] >= 256, f"{label}: prefix pair not shared: {infos[4]}")
    check(m.prefill_chunks > 0, f"{label}: no prefill was chunked")
    check(launches > 0 and paths.get("kernel", 0) == launches,
          f"{label}: attention paths {paths} vs {launches} kernel launches")
    check(launches >= m.decode_steps * cfg.num_layers,
          f"{label}: {launches} kernel launches for {m.decode_steps} decode steps")
    check(server.model.config.quant_mxu == mxu, f"{label}: quant_mxu not on the model")
    check({k: e["calls"] for k, e in geoms.items()}
          == {k: e["calls"] for k, e in warm_geoms.items()},
          f"{label}: the warm-up's kernel geometries {warm_geoms} differ from the serve's {geoms}")
    c = server.cache
    held = sum(x.numel() * x.element_size() for x in (c.k, c.v, c.k_scale, c.v_scale))
    formula = quant_pool_bytes(cfg)
    check(m.pool_bytes_total == formula == held,
          f"{label}: pool bytes {m.pool_bytes_total} (formula {formula}, held {held})")
    served = {k: dict(calls=e["calls"], positions=median_call(warm_geoms[k]["positions"]))
              for k, e in geoms.items()}
    generated = sum(len(outs[r]) for r in rids)
    ttft = np.median([i["ttft_ms"] for i in infos])
    tpot = np.median([i["tpot_ms"] for i in infos])
    log(f"serve {label} ({kv_dtype} pool, quant_mxu {mxu}, prefill chunks of "
        f"{QUANT_CHUNK}): {len(rids)} requests, {generated} tokens in {wall:.6f} s = "
        f"{generated / wall:.6f} tokens/s; TTFT p50 {ttft:.6f} ms, TPOT p50 {tpot:.6f} ms; "
        f"cached_tokens {[i['cached_tokens'] for i in infos]}; prefill_chunks "
        f"{m.prefill_chunks}; {m.decode_steps} decode steps | {card}")
    routes = check_routes(label, cfg, geoms, launches, tile, t1, kv_dtype)
    log(f"serve {label}: paged_decode kernel launches {launches} ({mode_label(kv_dtype, mxu)}; "
        f"{routes}); attention calls by path {paths}; pool_bytes_total {m.pool_bytes_total} = "
        f"formula {formula} = bytes held, {bf16_pool_bytes / m.pool_bytes_total:.6f}x "
        f"fewer than the bf16 serve's {bf16_pool_bytes} | {card}")
    for (b, t, kv_limit, splits, w), e in sorted(served.items()):
        log(f"serve {label}: kernel geometry b={b} t={t} kv_limit={kv_limit} "
            f"num_splits={splits} W={w}: {e['calls']} launches")
    return prompts, outs, rids, launches, t1, served


def quant_e2e_gaps(cfg, model, kv_dtype: str, prompts, outs, rids):
    """Teacher-forced over every request: one whole-prompt pass of the
    decode model over prompt + served tokens, on a fresh pool of
    ``kv_dtype``. Scales are per row and append-local, so that pass
    attends to the dequantized K/V the serve wrote and read; it runs no
    kernel. Returns (largest gap between the argmax logit and the served
    token's, served tokens that were the argmax, tokens, [(each request's
    worst gap, argmax tokens)])."""
    from neuronx_distributed_llama3_2_tpu_torch.inference.model import LlamaDecode

    dec = LlamaDecode(cfg)
    worst_gap, exact, total, each = 0.0, 0, 0, []
    for j in range(len(prompts)):
        prompt, gen = prompts[j], outs[rids[j]]
        seq = prompt + gen[:-1]
        nblk = -(-len(seq) // 16)
        cache = dec.init_paged_cache(nblk + 1, 16, kv_cache_dtype=kv_dtype, device="cuda")
        tables = torch.arange(1, nblk + 1, dtype=torch.int32, device="cuda")[None]
        logits, _ = dec.forward(
            model, cache, torch.as_tensor([seq], device="cuda"),
            torch.zeros((1,), dtype=torch.int32, device="cuda"),
            context_encode=True, block_tables=tables,
        )
        logits = logits[0, len(prompt) - 1:].float()  # predicts gen[0..]
        check(bool(torch.isfinite(logits).all()), "non-finite reference logits")
        tokens = torch.as_tensor(gen, device="cuda")
        chosen = logits[torch.arange(len(gen), device="cuda"), tokens]
        gap = (logits.max(dim=-1).values - chosen).max().item()
        hits = int((logits.argmax(dim=-1) == tokens).sum())
        worst_gap, exact, total = max(worst_gap, gap), exact + hits, total + len(gen)
        each.append((gap, hits))
        del cache, logits
    check(dec.attention_paths.get("kernel", 0) == 0, "the reference pass ran the kernel")
    return worst_gap, exact, total, each


def v_scale_as_k_scale(inner, q, k_pool, v_pool, tables, positions, **kw):
    """A planted fault of the quantized e2e checks: every kernel call reads
    V's scales as K's."""
    return inner(q, k_pool, v_pool, tables, positions, **dict(kw, k_scale=kw["v_scale"]))


def run_quant_e2e_phase(cfg, model, label: str, kv_dtype: str, mxu: bool,
                        prompts, outs, rids) -> None:
    """The served tokens must be the reference pass's argmax or within the
    dtype's QUANT_LOGIT_MARGIN of it; and the same check must reject a
    serve whose every kernel call reads V's scales as K's."""
    margin = QUANT_LOGIT_MARGIN[kv_dtype]
    gap, exact, total, each = quant_e2e_gaps(cfg, model, kv_dtype, prompts, outs, rids)
    log(f"e2e {label}: {exact}/{total} served tokens are the argmax of one whole-prompt "
        f"pass over a {kv_dtype} pool; worst logit gap {gap:.6g} (margin {margin}); "
        f"every request (worst gap, argmax tokens): {each}")
    check(gap <= margin, f"{label}: a served token is {gap} below the argmax logit")
    with model_kernel_call(v_scale_as_k_scale):
        bad_rids, bad_outs = serve_staged(
            make_server(cfg, model, kv_cache_dtype=kv_dtype, quant_mxu=mxu,
                        prefill_chunk_tokens=QUANT_CHUNK), prompts)
    bad_gap, bad_exact, _, _ = quant_e2e_gaps(cfg, model, kv_dtype, prompts, bad_outs,
                                              bad_rids)
    log(f"e2e {label} planted fault (v_scale passed as k_scale in every kernel call): "
        f"{bad_exact}/{total} served tokens are the argmax; worst logit gap "
        f"{bad_gap:.6g} (margin {margin})")
    check(bad_gap > margin,
          f"the {label} e2e check passes a planted scale fault (gap {bad_gap})")


# -- 4c. the fused speculative serve F ------------------------------------------

def spec_prompts():
    """The serve's eight prompts with SPEC_REP_PROMPTS rebuilt at the same
    lengths as a repeated 3-token pattern of ids 1-8 (the JAX package's
    ``_rep_prompts`` recipe), so that the n-gram drafter proposes."""
    prompts = serve_prompts()
    rng = np.random.default_rng(SEED + 3)
    for j in SPEC_REP_PROMPTS:
        n = len(prompts[j])
        pat = rng.integers(1, 9, size=3).tolist()
        prompts[j] = (pat * (n // 3 + 1))[:n]
    return prompts


def spec_config(cfg):
    """The decode model's config for F: the kernel takes fresh blocks up
    to the mixed step's width."""
    return dataclasses.replace(cfg, paged_kernel_max_t=SPEC_MAX_T)


def median_live_call(entry: dict):
    """(positions, row_live) of the row_live call whose live rows (the sum
    over lanes of position + live count) are the median of its calls."""
    calls = list(zip(entry["positions"], entry["row_live"]))
    calls.sort(key=lambda pl: sum(p + n for p, n in zip(*pl)))
    return calls[(len(calls) - 1) // 2]


def run_spec_serve_phase(cfg, model, card: str):
    """F: the fused speculative serve of ``spec_prompts`` after a warm-up
    serve of its own (which also records each kernel geometry's calls),
    submitted as the quantized serves are (``serve_staged``), K4's launch
    counters zeroed just before and read just after. Returns (prompts,
    outputs, rids, row_live launches, csrc/paged_decode_tile.cu's and
    csrc/paged_decode_t1.cu's launches, served geometries)."""
    from neuronx_distributed_llama3_2_tpu_torch.kernels import paged_attention as pa

    fcfg = spec_config(cfg)
    prompts = spec_prompts()
    warm_geoms: dict = {}
    with model_kernel_call(recording(warm_geoms, keep_positions=True)):
        serve_staged(make_server(fcfg, model, **SPEC_KNOBS), prompts)

    server = make_server(fcfg, model, **SPEC_KNOBS)
    geoms: dict = {}
    with model_kernel_call(recording(geoms, keep_positions=False)):
        pa.launches.reset()
        pa.row_live_launches.reset()
        pa.tile_launches.reset()
        pa.t1_launches.reset()
        server.model.attention_paths.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rids, outs = serve_staged(server, prompts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, live_launches = pa.launches.count, pa.row_live_launches.count
        tile, t1 = pa.tile_launches.count, pa.t1_launches.count
    paths = dict(server.model.attention_paths)
    m = server.metrics
    infos = [server.request_info(r) for r in rids]
    for r, info in zip(rids, infos):
        check(info["status"] == "finished", f"F: request {r} is {info['status']}")
        check(len(outs[r]) == MAX_NEW, f"F: request {r} produced {len(outs[r])} tokens")
    check(infos[4]["cached_tokens"] >= 256, f"F: prefix pair not shared: {infos[4]}")
    check(m.mixed_dispatches > 0 and m.verify_steps > 0 and m.draft_tokens > 0,
          f"F: mixed {m.mixed_dispatches}, verify {m.verify_steps}, drafts {m.draft_tokens}")
    check(launches > 0 and paths.get("kernel", 0) == launches and not paths.get("gather"),
          f"F: attention paths {paths} vs {launches} kernel launches")
    check(live_launches == m.mixed_dispatches * cfg.num_layers,
          f"F: {live_launches} row_live launches for {m.mixed_dispatches} mixed steps")
    k1 = SPEC_KNOBS["spec_draft_tokens"] + 1
    check(any(k[1] == k1 and len(k) == 5 for k in geoms),
          f"F: no verify dispatch launched K4 at t = {k1}: {sorted(geoms)}")
    check({k: e["calls"] for k, e in geoms.items()}
          == {k: e["calls"] for k, e in warm_geoms.items()},
          f"F: the warm-up's kernel geometries {warm_geoms} differ from the serve's {geoms}")
    served = {}
    for k, e in geoms.items():
        w = warm_geoms[k]
        if k[-1] == "row_live":
            pos, live = median_live_call(w)
            served[k] = dict(calls=e["calls"], positions=pos, row_live=live)
        else:
            served[k] = dict(calls=e["calls"], positions=median_call(w["positions"]))
    generated = sum(len(outs[r]) for r in rids)
    ttft = np.median([i["ttft_ms"] for i in infos])
    tpot = np.median([i["tpot_ms"] for i in infos])
    snap = m.snapshot(server.allocator, server.index)
    log(f"serve F (drafts of {SPEC_KNOBS['spec_draft_tokens']}, fused step, prefill "
        f"chunks of {SPEC_KNOBS['prefill_chunk_tokens']}): {len(rids)} requests, "
        f"{generated} tokens in {wall:.6f} s = {generated / wall:.6f} tokens/s; TTFT p50 "
        f"{ttft:.6f} ms, TPOT p50 {tpot:.6f} ms; cached_tokens "
        f"{[i['cached_tokens'] for i in infos]} | {card}")
    log(f"serve F: {m.engine_steps} engine steps, {m.compute_dispatches} dispatches "
        f"(dispatches_per_step {snap['dispatches_per_step']}), {m.mixed_dispatches} mixed, "
        f"{m.verify_steps} verify, {m.decode_steps} decode steps; draft_tokens "
        f"{m.draft_tokens}, accepted_tokens {m.accepted_tokens} (accept rate "
        f"{m.accept_rate():.6f}), spec_disabled_lanes {m.spec_disabled_lanes}; "
        f"prefill_chunks {m.prefill_chunks} | {card}")
    routes = check_routes("F", cfg, geoms, launches, tile, t1)
    log(f"serve F: paged_decode kernel launches {launches} ({routes}), of them with "
        f"row_live {live_launches} (= {m.mixed_dispatches} mixed steps x {cfg.num_layers} "
        f"layers); attention calls by path {paths} | {card}")
    for key, e in sorted(served.items(), key=lambda ke: (len(ke[0]), ke[0][:5])):
        b, t, kv_limit, splits, w = key[:5]
        log(f"serve F: kernel geometry b={b} t={t} kv_limit={kv_limit} num_splits="
            f"{splits} W={w}{' row_live' if len(key) == 6 else ''}: {e['calls']} launches")
    return prompts, outs, rids, live_launches, tile, t1, served


def per_request_gaps(model, prompts, outs, rids) -> list:
    """e2e_gaps of each request alone: [(worst gap, argmax tokens), ...]."""
    return [e2e_gaps(model, prompts, outs, rids, (j,))[:2] for j in range(len(prompts))]


def run_spec_e2e_phase(cfg, model, prompts, outs, rids) -> None:
    """F's tokens must be the plain forward's argmax or within
    F_LOGIT_MARGIN of it, on every request; and a serve whose row_live
    calls walk one row short (``row_live - 1``), which drops the newest
    row of a lane whose last live row opens a pool block, must read above
    LOGIT_MARGIN on request F_FAULT_PICK, where the sound serve reads
    within it."""
    gap, exact, total = e2e_gaps(model, prompts, outs, rids)
    each = per_request_gaps(model, prompts, outs, rids)
    log(f"e2e F: {exact}/{total} served tokens are the plain forward's argmax; worst "
        f"logit gap {gap:.6g} (margin {F_LOGIT_MARGIN}); every request (worst gap, "
        f"argmax tokens): {each}")
    check(gap <= F_LOGIT_MARGIN, f"F: a served token is {gap} below the argmax logit")
    sound = each[F_FAULT_PICK][0]
    check(sound <= LOGIT_MARGIN,
          f"F: request {F_FAULT_PICK} reads {sound}, over the fault check's {LOGIT_MARGIN}")

    def row_live_short(inner, q, k_pool, v_pool, tables, positions, **kw):
        if kw.get("row_live") is not None:
            kw = dict(kw, row_live=kw["row_live"] - 1)
        return inner(q, k_pool, v_pool, tables, positions, **kw)

    with model_kernel_call(row_live_short):
        bad_rids, bad_outs = serve_staged(
            make_server(spec_config(cfg), model, **SPEC_KNOBS), prompts)
    bad_each = per_request_gaps(model, prompts, bad_outs, bad_rids)
    bad = bad_each[F_FAULT_PICK][0]
    log(f"e2e F planted fault (every row_live walk one row short): request "
        f"{F_FAULT_PICK} reads {bad:.6g} (sound {sound:.6g}, margin {LOGIT_MARGIN}); "
        f"every request: {bad_each}")
    check(bad > LOGIT_MARGIN,
          f"the F e2e check passes a planted row_live fault (gap {bad})")


# -- 4d. the tree-speculative serve T --------------------------------------------

def tree_prompts():
    """The serve's eight prompts with SPEC_REP_PROMPTS rebuilt at the same
    lengths from two 4-token patterns that share their first three tokens
    (a b c x a b c y ...): every (a, b, c) site is followed by x or by y,
    so the n-gram drafter's trie branches wherever a lane's history ends
    in (a, b, c)."""
    prompts = serve_prompts()
    rng = np.random.default_rng(SEED + 6)
    for j in SPEC_REP_PROMPTS:
        n = len(prompts[j])
        a, b, c, x, y = rng.choice(np.arange(1, 64), size=5, replace=False).tolist()
        prompts[j] = ([a, b, c, x, a, b, c, y] * (n // 8 + 1))[:n]
    return prompts


def tree_config(cfg):
    """The decode model's config for T: the kernel takes fresh blocks up
    to the tree's width."""
    return dataclasses.replace(cfg, paged_kernel_max_t=TREE_MAX_T)


def tree_dispatch_spy(server, calls: list) -> None:
    """Keep, for every tree dispatch of ``server`` (a tree verify, or a
    mixed step, which carries trees whenever spec_tree is on), its
    (parents, live nodes) device tensors, copied on the device (the engine
    reuses its payload buffers): no host sync while it serves."""
    dec = server.model
    verify, mixed = dec.tree_verify_step, dec.mixed_step

    def tree_verify_step(params, cache, tokens, positions, tables, parents, node_len, **kw):
        calls.append((parents.clone(), node_len.clone()))
        return verify(params, cache, tokens, positions, tables, parents, node_len, **kw)

    def mixed_step(params, cache, tokens, positions, tables, rows, row_start, row_len,
                   forced, **kw):
        calls.append((kw["parents"].clone(), torch.where(forced > 0, 1, row_len + 1)))
        return mixed(params, cache, tokens, positions, tables, rows, row_start, row_len,
                     forced, **kw)

    dec.tree_verify_step, dec.mixed_step = tree_verify_step, mixed_step


def branching_lanes(calls: list) -> int:
    """Lanes of the recorded tree dispatches whose live nodes branch (two
    of them share a parent)."""
    n = 0
    for parents, live in calls:
        for par, k in zip(parents.tolist(), live.tolist()):
            n += len(set(par[1:k])) < k - 1
    return n


def one_dispatch_steps(server) -> tuple:
    """(steps with a mixed dispatch, of them those with another compute
    dispatch action beside it) over the engine's action trace."""
    mixed = other = 0
    for _, _, actions in server.action_trace:
        kinds = [a.type.value for a in actions]
        if "MIXED_DISPATCH" in kinds:
            mixed += 1
            other += kinds.count("MIXED_DISPATCH") > 1 or any(
                k in kinds for k in ("VERIFY", "DECODE_DISPATCH"))
    return mixed, other


def run_tree_serve_phase(cfg, model, card: str, summary: Optional[dict] = None):
    """T: the tree-speculative fused serve of ``tree_prompts`` after a
    warm-up serve of its own (which also records each kernel geometry's
    calls, ancestor masks included), submitted as F is (``serve_staged``),
    K4's launch counters zeroed just before and read just after. Returns
    (prompts, outputs, rids, tree launches, csrc/paged_decode_tile.cu's and
    csrc/paged_decode_t1.cu's launches, served geometries); ``summary``, if
    given, receives the lane trees dispatched and branched and the
    accepted tokens."""
    from neuronx_distributed_llama3_2_tpu_torch.kernels import paged_attention as pa

    tcfg = tree_config(cfg)
    prompts = tree_prompts()
    warm_geoms: dict = {}
    with model_kernel_call(recording(warm_geoms, keep_positions=True)):
        serve_staged(make_server(tcfg, model, **TREE_KNOBS), prompts)

    server = make_server(tcfg, model, **TREE_KNOBS)
    calls: list = []
    tree_dispatch_spy(server, calls)
    geoms: dict = {}
    with model_kernel_call(recording(geoms, keep_positions=False)):
        pa.launches.reset()
        pa.row_live_launches.reset()
        pa.tree_launches.reset()
        pa.tile_launches.reset()
        pa.t1_launches.reset()
        server.model.attention_paths.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rids, outs = serve_staged(server, prompts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, tile, t1 = pa.launches.count, pa.tile_launches.count, pa.t1_launches.count
        live_launches, tree_launches = pa.row_live_launches.count, pa.tree_launches.count
    paths = dict(server.model.attention_paths)
    m = server.metrics
    infos = [server.request_info(r) for r in rids]
    for r, info in zip(rids, infos):
        check(info["status"] == "finished", f"T: request {r} is {info['status']}")
        check(len(outs[r]) == MAX_NEW, f"T: request {r} produced {len(outs[r])} tokens")
    check(infos[4]["cached_tokens"] >= 256, f"T: prefix pair not shared: {infos[4]}")
    # logged, not held: with random weights the model emits no prompt
    # token after the patterned prompts, so the drafter's tails match only
    # its own tokens and its tries rarely branch (PERF.md, PR 5); the decoy
    # serve of run_tree_branch_phase holds branching trees on this path
    branched = branching_lanes(calls)
    check(m.tree_verify_steps > 0 and m.mixed_dispatches > 0,
          f"T: tree verifies {m.tree_verify_steps}, mixed {m.mixed_dispatches}")
    mixed_steps, shared = one_dispatch_steps(server)
    check(mixed_steps == m.mixed_dispatches and shared == 0,
          f"T: {shared} of {mixed_steps} mixed steps dispatched more than the mixed step")
    check(launches > 0 and paths.get("kernel", 0) == launches and not paths.get("gather"),
          f"T: attention paths {paths} vs {launches} kernel launches")
    check(tree_launches == len(calls) * cfg.num_layers,
          f"T: {tree_launches} tree launches for {len(calls)} tree dispatches")
    check(live_launches == m.mixed_dispatches * cfg.num_layers,
          f"T: {live_launches} row_live launches for {m.mixed_dispatches} mixed steps")
    check(any(k[1] == TREE_MAX_T and k[-1] == "tree" and "row_live" not in k for k in geoms)
          and any(k[1] == TREE_MAX_T and k[-2:] == ("row_live", "tree") for k in geoms),
          f"T: no t = {TREE_MAX_T} tree verify and mixed launches: {sorted(geoms)}")
    check({k: e["calls"] for k, e in geoms.items()}
          == {k: e["calls"] for k, e in warm_geoms.items()},
          f"T: the warm-up's kernel geometries {warm_geoms} differ from the serve's {geoms}")
    served = {}
    for k, e in geoms.items():
        w = warm_geoms[k]
        calls_k = list(zip(w["positions"], w["row_live"] or [None] * len(w["positions"]),
                           w["tree_bits"] or [None] * len(w["positions"])))
        calls_k.sort(key=lambda c: sum(c[0]) + (sum(c[1]) if c[1] else 0))
        pos, live, bits = calls_k[(len(calls_k) - 1) // 2]
        served[k] = dict(calls=e["calls"], positions=pos, row_live=live, tree_bits=bits)
    generated = sum(len(outs[r]) for r in rids)
    ttft = np.median([i["ttft_ms"] for i in infos])
    tpot = np.median([i["tpot_ms"] for i in infos])
    snap = m.snapshot(server.allocator, server.index)
    log(f"serve T (trees of {TREE_KNOBS['spec_draft_tokens']} nodes, "
        f"{TREE_KNOBS['spec_tree_branches']} branches, fused step, prefill chunks of "
        f"{TREE_KNOBS['prefill_chunk_tokens']}): {len(rids)} requests, {generated} tokens in "
        f"{wall:.6f} s = {generated / wall:.6f} tokens/s; TTFT p50 {ttft:.6f} ms, TPOT p50 "
        f"{tpot:.6f} ms; cached_tokens {[i['cached_tokens'] for i in infos]} | {card}")
    log(f"serve T: {m.engine_steps} engine steps, {m.compute_dispatches} dispatches "
        f"(dispatches_per_step {snap['dispatches_per_step']}; {mixed_steps} steps with a "
        f"mixed dispatch, none with another decode dispatch), {m.mixed_dispatches} mixed, "
        f"{m.verify_steps} verify ({m.tree_verify_steps} of them trees), {m.decode_steps} "
        f"decode steps; {len(calls)} tree dispatches, {branched} branching lane trees; "
        f"draft_tokens {m.draft_tokens} (tree {m.tree_draft_tokens}), accepted_tokens "
        f"{m.accepted_tokens} (accept rate {m.accept_rate():.6f}); tree_accept_by_shape "
        f"{ {s: (v['lanes'], v['accepted']) for s, v in m.tree_accept_by_shape.items()} } "
        f"(lanes, accepted); prefill_chunks {m.prefill_chunks} | {card}")
    if summary is not None:
        summary.update(lane_trees=sum(int(par.shape[0]) for par, _ in calls),
                       branched=branched, accepted=m.accepted_tokens,
                       draft=m.draft_tokens, accept_rate=m.accept_rate())
    routes = check_routes("T", cfg, geoms, launches, tile, t1)
    log(f"serve T: paged_decode kernel launches {launches} ({routes}), of them with "
        f"tree_bits {tree_launches} (= {len(calls)} tree dispatches x {cfg.num_layers} "
        f"layers), with row_live {live_launches}; attention calls by path {paths} | {card}")
    for key, e in sorted(served.items(), key=lambda ke: (len(ke[0]), ke[0][:5])):
        b, t, kv_limit, splits, w = key[:5]
        log(f"serve T: kernel geometry b={b} t={t} kv_limit={kv_limit} num_splits="
            f"{splits} W={w} {' '.join(key[5:])}: {e['calls']} launches")
    return prompts, outs, rids, tree_launches, tile, t1, served


def fp32_copy(cfg, model):
    """An fp32 copy of the model (the witness reference)."""
    from neuronx_distributed_llama3_2_tpu_torch.models.llama import LlamaForCausalLM

    ref = LlamaForCausalLM(dataclasses.replace(cfg, dtype=torch.float32), device="cuda")
    ref.load_state_dict(model.state_dict())
    return ref


def run_tree_e2e_phase(cfg, model, prompts, outs, rids) -> None:
    """T's tokens must be the plain forward's argmax or within
    T_LOGIT_MARGIN of it, on every request; an fp32 copy of the model as
    the reference is logged beside it, held to nothing."""
    gap, exact, total = e2e_gaps(model, prompts, outs, rids)
    each = per_request_gaps(model, prompts, outs, rids)
    log(f"e2e T: {exact}/{total} served tokens are the plain forward's argmax; worst "
        f"logit gap {gap:.6g} (margin {T_LOGIT_MARGIN}); every request (worst gap, "
        f"argmax tokens): {each}")
    ref = fp32_copy(cfg, model)
    log(f"e2e T witness (fp32 reference): every request (worst gap, argmax tokens): "
        f"{per_request_gaps(ref, prompts, outs, rids)}")
    del ref
    torch.cuda.empty_cache()
    check(gap <= T_LOGIT_MARGIN, f"T: a served token is {gap} below the argmax logit")


def plain_greedy(model, prompt, n: int) -> list:
    """``n`` greedy tokens of the plain full-sequence forward after
    ``prompt``."""
    ids = list(prompt)
    for _ in range(n):
        logits = model(torch.as_tensor([ids], device="cuda"))[0, -1]
        ids.append(int(logits.argmax()))
    return ids[len(prompt):]


class DecoyTreeDrafter:
    """Knows the plain forward's greedy streams: while a lane's history is
    a prefix of one, proposes a two-branch tree, a decoy branch first (the
    next ``depth`` greedy tokens each plus one: its first node is never
    the target's choice) and then the next ``depth`` greedy tokens;
    abstains otherwise. Every accept then runs through nodes whose index
    is ``depth`` past their depth, so the frontier commit moves rows at
    each step that accepts, and the lane decodes on over those rows (a
    short branch leaves most of its tokens to later steps)."""

    def __init__(self, streams, vocab: int, depth: int = 4):
        self.streams, self.vocab, self.depth = [list(s) for s in streams], vocab, depth

    def propose(self, history, max_tokens):
        return []

    def propose_tree(self, history, max_nodes, branches=2):
        h = list(history)
        for s in self.streams:
            if len(h) < len(s) and s[: len(h)] == h:
                cont = s[len(h): len(h) + min(self.depth, max_nodes // 2)]
                if not cont:
                    return [], []
                n = len(cont)
                decoy = [(x + 1) % self.vocab for x in cont]
                # nodes 1..n the decoy chain, n+1..2n the greedy chain
                parents = list(range(n)) + [0] + list(range(n + 1, 2 * n))
                return decoy + cont, parents
        return [], []


def run_tree_branch_phase(cfg, model, prompts, card: str) -> None:
    """T's prompts served with T's knobs and ``DecoyTreeDrafter`` over the
    plain forward's greedy streams: branching trees dispatched, accepted
    tokens > 0, the commit moves rows (counted on the device), and every
    served token within T_LOGIT_MARGIN of the plain forward's argmax; then
    a serve whose frontier commit is the identity (the decoy's K/V left at
    the frontier) must read above the margin."""
    greedy = [plain_greedy(model, p, MAX_NEW) for p in prompts]
    drafter = DecoyTreeDrafter([p + g for p, g in zip(prompts, greedy)], cfg.vocab_size)
    tcfg = tree_config(cfg)
    server = make_server(tcfg, model, drafter=drafter, **TREE_KNOBS)
    moved = torch.zeros((), dtype=torch.long, device="cuda")
    commit = server.model._tree_frontier_commit

    def counted_commit(cache, tables, positions, depths, ancestors, best):
        nonlocal moved
        moved = moved + (best != depths.gather(1, best.long()[:, None])[:, 0]).sum()
        return commit(cache, tables, positions, depths, ancestors, best)

    server.model._tree_frontier_commit = counted_commit
    calls: list = []
    tree_dispatch_spy(server, calls)
    rids, outs = serve_staged(server, prompts)
    m = server.metrics
    branched = branching_lanes(calls)
    gap, exact, total = e2e_gaps(model, prompts, outs, rids)
    same = [sum(a == b for a, b in zip(outs[r], g)) for r, g in zip(rids, greedy)]
    log(f"e2e T branches (a decoy branch first, the greedy stream second, "
        f"{drafter.depth} nodes each): {m.tree_verify_steps} "
        f"tree verifies, {m.mixed_dispatches} mixed, draft_tokens {m.draft_tokens}, "
        f"accepted_tokens {m.accepted_tokens}, {branched} branching lane trees in "
        f"{len(calls)} tree dispatches, {int(moved)} lane commits that moved rows; "
        f"{exact}/{total} served tokens are the plain forward's argmax, worst logit gap "
        f"{gap:.6g} (margin {T_LOGIT_MARGIN}); tokens equal to the greedy stream, by "
        f"request: {same} | {card}")
    check(branched > 0 and m.accepted_tokens > 0 and int(moved) > 0,
          f"T branches: branching trees {branched}, accepted {m.accepted_tokens}, "
          f"moving commits {int(moved)}")
    check(gap <= T_LOGIT_MARGIN, f"T branches: a served token is {gap} below the argmax")

    bad = make_server(tcfg, model, drafter=drafter, **TREE_KNOBS)
    bad.model._tree_frontier_commit = lambda cache, *args: cache
    bad_rids, bad_outs = serve_staged(bad, prompts)
    bad_gap, bad_exact, _ = e2e_gaps(model, prompts, bad_outs, bad_rids)
    log(f"e2e T branches planted fault (the frontier commit the identity): "
        f"{bad.metrics.accepted_tokens} accepted tokens; {bad_exact}/{total} served tokens "
        f"are the argmax; worst logit gap {bad_gap:.6g} (margin {T_LOGIT_MARGIN})")
    check(bad_gap > T_LOGIT_MARGIN,
          f"the T e2e check passes an identity frontier commit (gap {bad_gap})")


# -- 4e. the prewarmed twins: every decode-time step a CUDA graph --------------

def first_difference(a: list, b: list) -> Optional[int]:
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)


def collective_counts() -> dict:
    """The tp collectives issued so far in this process, by kind
    (``parallel.mappings.COLLECTIVE_COUNTS``)."""
    from neuronx_distributed_llama3_2_tpu_torch.parallel.mappings import COLLECTIVE_COUNTS

    return dict(COLLECTIVE_COUNTS)


def counts_since(before: dict) -> dict:
    now = collective_counts()
    return {k: n - before.get(k, 0) for k, n in now.items() if n - before.get(k, 0)}


def reserved_bytes() -> int:
    """The caching allocator's reserved bytes on the card, its free cached
    blocks outside the graphs' private pools handed back first."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_stats()["reserved_bytes.all.current"]


def step_device_ms(server) -> tuple:
    """A decode step's own time on the card: the decode-time record the
    serve replayed most, replayed again after the serve (every lane
    released and flushed, so its writes land in the null block) under
    ``device_ms``. Returns (its key's line, device ms, events ms) per
    replay."""
    from neuronx_distributed_llama3_2_tpu_torch.serving.catalog import format_key

    server._flush_state()
    rec = max((r for r in server.program_registry().values()
               if r.kind not in ("pctx", "psfx")), key=lambda r: r.replays)
    (dev,), wall = device_ms(lambda i: rec(), iters=20, windows=3)
    return format_key(rec.key), dev, wall


def run_graph_phase(scfg, model, label: str, prompts, eager_outs: list, card: str,
                    gaps, margin: float, async_loop: bool = False, sampling=None,
                    profile: Optional[dict] = None, **knobs) -> dict:
    """The prewarmed twin of serve ``label``: a server built with
    ``PagedConfig.prewarm``, which captures every prefill and decode-time
    key of its catalog as a CUDA graph, serves the same requests as the
    eager serve (``eager_outs``, in prompt order) and must emit the same
    greedy tokens. Where a stream differs, the first token that differs
    must be a near tie, the two tokens' logits under the plain forward
    within LOGIT_MARGIN, and the twin's worst e2e gap (``gaps(outs,
    rids)``) must then lie within ``margin``, as the eager serve's does.
    No capture may follow the freeze. K4's launch counters are zeroed
    before the server is built and read after the serve: the captures
    must have launched the t1 and the tile sources, and nothing may tick
    them during the serve (every K4 call is a replay). ``async_loop``: the
    twin also runs the async decode loop, and must have dispatched async
    steps and discarded lame-duck tokens, and logs a decode step's own
    device time (``step_device_ms``). ``sampling``: a sampled config (with
    ``on_device_sampling`` among ``knobs``): the streams are held by the
    sampled near-tie rule (``same_streams``), ``gaps`` and ``margin`` are
    in tempered logits, and the twin must have drawn on the device
    (``sampled_steps`` > 0, no host fallback). Logs the keys by kind, the
    capture seconds, the reserved bytes the construction added beyond the
    KV pool (the graphs' pool, the static buffers) and the serve's
    numbers. ``profile`` (the eager serve's K4 launches by source): the
    twin's serve runs under torch.profiler, as ``run_graph_profile_phase``'s
    does, and is held to the same launch checks (``check_replayed``); its
    times are then those of a profiled serve. Returns the capture count and
    seconds, the streams in prompt order and ``serve_stats``."""
    from neuronx_distributed_llama3_2_tpu_torch.kernels import paged_attention as pa
    from neuronx_distributed_llama3_2_tpu_torch.serving.catalog import GRAPH_KINDS

    counters = {"t1": pa.t1_launches, "tile": pa.tile_launches, "all": pa.launches}
    for c in counters.values():
        c.reset()
    reserved0 = reserved_bytes()
    coll0 = collective_counts()
    t0 = time.perf_counter()
    with counted_captures() as held:
        server = make_server(scfg, model, prewarm=True, async_loop=async_loop,
                             sampling=sampling, **knobs)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    # the tp collectives issued while the graphs were captured (a model
    # built under a mesh; 0 on one device)
    coll_captured = counts_since(coll0)
    coll1 = collective_counts()
    m = server.metrics
    graph_bytes = reserved_bytes() - reserved0 - m.pool_bytes_total
    captured = {src: c.count for src, c in counters.items()}
    registry = server.program_registry()
    kinds = {k: sum(key[0] == k for key in registry) for k in sorted(GRAPH_KINDS)}
    check(list(registry) == server.catalog.graph_keys()
          and all(r.graph is not None for r in registry.values())
          and m.prewarm_compiles == len(registry) == m.programs_compiled
          and kinds["pctx"] > 0 and (kinds["psfx"] > 0) != bool(knobs.get("fused_step")),
          f"graph {label}: registry {sorted(map(str, registry))} vs the catalog's "
          f"{server.catalog.describe()}, prewarm_compiles {m.prewarm_compiles}")
    prof = (torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
            if profile is not None else contextlib.nullcontext())
    with prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rids, outs = serve_requests(server, prompts, staged=staged_serve(knobs))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    coll_serve = counts_since(coll1)
    stats = serve_stats(server, rids, outs, wall)
    eager_calls = {src: c.count - captured[src] for src, c in counters.items()}
    check(m.steadystate_compiles == 0 and len(server.program_registry()) == len(registry),
          f"graph {label}: {m.steadystate_compiles} captures after the freeze")
    check(captured["t1"] > 0 and captured["tile"] > 0,
          f"graph {label}: the captures launched K4 {captured}")
    check(not any(eager_calls.values()),
          f"graph {label}: K4 launched outside a replay during the serve {eager_calls}")
    check(m.compute_dispatches == sum(r.replays for r in registry.values()),
          f"graph {label}: {m.compute_dispatches} dispatches, "
          f"{sum(r.replays for r in registry.values())} replays")
    if async_loop:
        check(m.decode_steps_async > 0 and m.lame_duck_tokens > 0,
              f"graph {label}: decode_steps_async {m.decode_steps_async}, "
              f"lame_duck_tokens {m.lame_duck_tokens}")
    if knobs.get("on_device_sampling"):
        sampled = sampling is not None and not sampling.greedy
        check(m.host_sample_fallbacks == 0 and (m.sampled_steps > 0) == sampled,
              f"graph {label}: sampled_steps {m.sampled_steps}, host_sample_fallbacks "
              f"{m.host_sample_fallbacks}")
    differ = same_streams(f"graph {label}", model, prompts, [outs[r] for r in rids],
                          eager_outs, rids, sampling)
    if profile is not None:
        busy_ms, launched = profile_reading(prof, wall * 1e3, server,
                                            f"{label} (CUDA graphs)", card)
        graph = dict(launches=launched, replayed=replayed_k4(server, held))
        log(f"graph profile {label} (profiler on, the graph phase's own serve): wall "
            f"{wall * 1e3:.6f} ms, busy {busy_ms:.6f} ms = {100 * busy_ms / (wall * 1e3):.6f}%, "
            f"K4 launches (profiler) {launched}, in the replays {graph['replayed']}; the "
            f"eager serve's wrappers counted {profile} | {card}")
        if not differ:
            check_replayed(label, graph, profile)
    if differ:
        gap = gaps(outs, rids)
        log(f"graph {label}: worst e2e gap {gap:.6g} (margin {margin})")
        check(gap <= margin, f"graph {label}: a served token is {gap} below the argmax")
    # the device-cost ledger, harvested at the end of prewarm: a profile a
    # captured key, the H100's peaks, and the ledger's parameter and pool
    # bytes those of the tensors themselves
    params = sum(p.nbytes for p in server.engine.params.parameters())
    pool = sum(x.nbytes for x in server._pool_tensors())
    led = server.hbm
    check(m.cost_profiled_programs == len(registry) and led.param_bytes == params
          and led.pool_bytes == pool == m.pool_bytes_total,
          f"graph {label}: cost_profiled_programs {m.cost_profiled_programs} of "
          f"{len(registry)} keys; ledger params {led.param_bytes} / {params}, pool "
          f"{led.pool_bytes} / {pool}")
    cost = (f"; cost_profiled_programs {m.cost_profiled_programs}, dispatched_flops "
            f"{m.dispatched_flops:.6g}, mfu_est {m.mfu_estimate():.6f}, bandwidth_util_est "
            f"{m.bandwidth_util_estimate():.6f} (against 989 TFLOP/s, 3.35 TB/s); HBM ledger "
            f"param_bytes {led.param_bytes}, pool_bytes {led.pool_bytes}, footprint "
            f"{led.footprint_bytes} of budget {led.budget_bytes} beside "
            f"torch.cuda.memory_allocated() {torch.cuda.memory_allocated()}")
    step = ""
    if async_loop:
        step_key, step_dev, step_wall = step_device_ms(server)
        step = (f"; one replay of {step_key} takes {step_dev:.6f} ms of device time "
                f"({step_wall:.6f} ms by events)")
    log(f"graph {label}: {len(registry)} keys captured as CUDA graphs ({kinds}) in "
        f"{capture_s:.6f} s (engine construction and prewarm; {server.catalog.describe()}); "
        f"reserved bytes beyond the {m.pool_bytes_total}-byte KV pool: {graph_bytes} (the "
        f"graphs' pool and the static buffers); {len(rids)} requests, "
        f"{sum(len(outs[r]) for r in rids)} tokens in {wall:.6f} s = "
        f"{stats['tokens_s']:.6f} tokens/s; TTFT p50 {stats['ttft']:.6f} ms, TPOT p50 "
        f"{stats['tpot']:.6f} ms; streams equal to the eager serve's on "
        f"{len(rids) - len(differ)} of {len(rids)} requests; steadystate_compiles "
        f"{m.steadystate_compiles}, prewarm_compiles {m.prewarm_compiles}; replays "
        f"{sum(r.replays for r in registry.values())}; sampled_steps {m.sampled_steps}, "
        f"host_sample_fallbacks {m.host_sample_fallbacks}; decode steps {m.decode_steps}, "
        f"async {m.decode_steps_async}, lame_duck_tokens {m.lame_duck_tokens}, "
        f"sync_fallbacks {m.sync_fallbacks}; K4 launches captured {captured}, during "
        f"the serve {eager_calls}; tp collectives captured {coll_captured}, issued during "
        f"the serve {coll_serve}{cost}{step} | {card}")
    del server, registry
    gc.collect()
    torch.cuda.empty_cache()
    return dict(keys=m.prewarm_compiles, capture_s=capture_s, same=not differ,
                outs=[outs[r] for r in rids], collectives_captured=coll_captured,
                collectives_serve=coll_serve, **stats)


def check_replayed(label: str, graph: dict, launched: dict) -> None:
    """A profiled twin whose streams equal the eager serve's: its replays
    launched K4 by source as often as the eager serve's wrappers counted
    (``launched``), and the profiler saw each source launched, never more
    often than that."""
    check(graph["replayed"] == launched and launched["t1"] > 0,
          f"graph profile {label}: K4 launches {graph['replayed']} (the twin's replays) "
          f"against {launched} (the eager serve's wrappers)")
    check(all(0 < graph["launches"][s] <= n if n else graph["launches"][s] == 0
              for s, n in graph["replayed"].items()),
          f"graph profile {label}: the profiler counted K4 launches {graph['launches']} "
          f"on the card against {graph['replayed']} in the twin's replays")


def run_graph_profile_phase(scfg, model, label: str, prompts, eager: Optional[dict],
                            launched: dict, card: str, same: bool,
                            eager_outs: Optional[list] = None, **knobs) -> None:
    """The prewarmed twin's profiled serve beside the eager serve's of the
    same run (``eager``, run_profile_phase's numbers): wall, busy ms and
    share, TPOT p50, TTFT p50, tokens/s, and K4's launches by source. Where
    the twin's streams equal the eager ones (``same``), the twin's replays
    must have launched K4 exactly as often, by source, as the eager
    serve's wrappers counted for the same requests (``launched``): each
    record's replays times the launches its graph captured. The profiler
    must have seen those kernels run on the card, a count above 0 for each
    source launched and never above the exact one; it can lose kernel
    records in a long trace (519-527 of 528 t1 launches read in some
    runs, eager and replayed alike), so its count is logged beside the
    exact one, not held equal to it.
    ``eager`` None: the eager serve was not profiled (the script's timing
    depth, PERF.md section 7); the twin's streams are then held to
    ``eager_outs``, the counted eager serve's, in prompt order.
    Returns the twin's profile (``run_profile_phase``'s numbers)."""
    graph = run_profile_phase(scfg, model, prompts, card, prewarm=True,
                              label=f"{label} (CUDA graphs)", **knobs)
    serves = ([("eager", eager)] if eager else []) + [("graphs", graph)]
    rows = []
    for name, st in serves:
        rows.append(f"{name}: wall {st['wall']:.6f} ms, busy {st['busy']:.6f} ms = "
                    f"{100 * st['busy'] / st['wall']:.6f}%, TPOT p50 {st['tpot']:.6f} ms, "
                    f"TTFT p50 {st['ttft']:.6f} ms, {st['tokens_s']:.6f} tokens/s, K4 "
                    f"launches (profiler) {st['launches']}"
                    + (f", in the replays {st['replayed']}" if st["replayed"] else ""))
    log(f"graph profile {label} (profiler on): " + "; ".join(rows) + f"; the eager serve's "
        f"wrappers counted {launched} | {card}")
    if same:
        check(graph["outs"] == (eager["outs"] if eager else eager_outs),
              f"graph profile {label}: the profiled streams differ from the eager ones")
        check_replayed(label, graph, launched)
    gc.collect()
    torch.cuda.empty_cache()
    return graph


def prefix_read_from_null_block(inner, q, k_pool, v_pool, tables, positions, **kw):
    """A ``model_kernel_call`` wrapper planting a kernel fault: every table
    entry below the block of a lane's first fresh row read as the null
    block, so that a suffix prefill reads its cached prefix from the wrong
    block (computed on the card: it may be captured)."""
    cols = torch.arange(tables.shape[1], device=tables.device)
    prefix = cols[None, :] < (positions // k_pool.shape[1])[:, None]
    return inner(q, k_pool, v_pool, torch.where(prefix, torch.zeros_like(tables), tables),
                 positions, **kw)


def suffix_only(fault):
    """A ``model_kernel_call`` wrapper that plants ``fault`` in the suffix
    prefills' calls alone (one lane: b == 1) and passes every other call
    through."""
    def wrap(inner, q, *args, **kw):
        if q.shape[0] == 1:
            return fault(inner, q, *args, **kw)
        return inner(q, *args, **kw)
    return wrap


def run_graph_fault_phase(cfg, model, prompts, card: str) -> None:
    """The planted fault of run_e2e_phase (every kernel call's newest row
    masked off) captured into the prewarmed Serve's graphs, the serve run
    after the wrapper is gone: only the replays carry the fault. The e2e
    check must read it above E2E_LOGIT_MARGIN, as it reads the eager
    fault. Then a fault in the suffix prefills' graphs alone (psfx, the
    t = 8 tile calls of the prefix pair): there the newest row masked off
    moves no served token (one row of some 260 that random weights weigh
    about evenly), so the planted fault is the cached prefix read from
    the null block (``prefix_read_from_null_block``), which the check
    must reject too."""
    for name, fault in (
        ("newest row masked off in every kernel call", newest_row_dropped),
        ("cached prefix read from the null block in the suffix prefills' kernel calls",
         suffix_only(prefix_read_from_null_block)),
    ):
        with model_kernel_call(fault):
            server = make_server(cfg, model, prewarm=True)
        rids = [server.submit(p) for p in prompts]
        outs = server.run_to_completion()
        gap, exact, total = e2e_gaps(model, prompts, outs, rids)
        log(f"e2e planted fault captured into the graphs ({name}, "
            f"{server.metrics.prewarm_compiles} graphs, "
            f"{sum(r.replays for r in server.program_registry().values())} replays): "
            f"{exact}/{total} served tokens are the plain forward's argmax; worst logit gap "
            f"{gap:.6g} (margin {E2E_LOGIT_MARGIN}) | {card}")
        check(gap > E2E_LOGIT_MARGIN,
              f"the e2e check passes a planted kernel fault replayed from the graphs "
              f"({name}; gap {gap})")
        del server
        gc.collect()
        torch.cuda.empty_cache()


# the fault phase's schedule: a nan fault, then a device fault, each at the
# first decode dispatch at or after its step (every lane decodes from step
# 2 on, after the one admission wave of step 1)
FAULT_SCHEDULE = ((5, "nan"), (9, "device"))
# the genuine non-finite: K rows turned to NaN after this step
NAN_AFTER_STEP = 3
CHECKED_KNOBS = dict(detect_nonfinite=True, audit_interval=1)


def steady_upload_steps(server) -> tuple:
    """Run ``server`` to completion one step at a time; returns (its
    outputs, the steady steps' upload counts): a steady step dispatches
    and reads back decode steps and audits, nothing else (no admission,
    finish, lane flush or table delta)."""
    steady = {"DECODE_DISPATCH", "READBACK", "AUDIT"}
    uploads = []
    alive = True
    while alive:
        before = server.metrics.h2d_uploads
        alive = server.step()
        actions = {a.type.value for a in server.action_trace[-1][2]}
        if actions <= steady and "DECODE_DISPATCH" in actions:
            uploads.append(server.metrics.h2d_uploads - before)
    return {rid: r.out for rid, r in sorted(server._finished.items())}, uploads


def nan_victim(server):
    """The decoding lane whose last block only it holds (refcount 1, not
    in the prefix index) and holds the most of its written rows: (lane,
    request, block, rows written in it)."""
    bs = server.paged.block_size
    best = None
    for lane, req in server._active.items():
        bid, rows = req.table[-1], req.position % bs
        if (req.prefilling or rows == 0 or server.allocator.refcount(bid) != 1
                or server.allocator.is_registered(bid)):
            continue
        if best is None or rows > best[3]:
            best = (lane, req, bid, rows)
    check(best is not None, "faults: no decoding lane holds a private written block")
    return best


def run_nan_serve(cfg, model, prompts, detect: bool):
    """An eager Serve whose victim lane's last block gets NaN K rows (every
    row it has written, layer 0) after step NAN_AFTER_STEP. Returns the
    server, the rids, the victim's rid and its token count at the write."""
    server = make_server(cfg, model, detect_nonfinite=detect)
    rids = [server.submit(p) for p in prompts]
    for _ in range(NAN_AFTER_STEP):
        server.step()
    lane, req, bid, rows = nan_victim(server)
    server.cache.k[0, bid, :rows] = float("nan")
    n_at_write = len(req.out)
    server.run_to_completion()
    return server, rids, req.rid, n_at_write


def nan_quarantined(server, victim: int, n_at_write: int) -> bool:
    """The genuine-NaN verdict: the victim, and only it, failed by the
    on-device isfinite (no injector, so no poison mask), having committed
    no token after the write."""
    info = server.request_info(victim)
    return (server.injector is None and server.metrics.lane_quarantines == 1
            and server.metrics.failed_requests == 1 and info["status"] == "failed"
            and info["error"] == "non-finite logits at decode step (lane quarantined)"
            and info["generated_tokens"] == n_at_write)


def run_fault_phase(cfg, model, prompts, eager_outs: list, unchecked: dict,
                    card: str) -> None:
    """Fault tolerance on Serve's configuration (1B, bf16, 8 lanes).

    - The clean checked twin: prewarmed with CHECKED_KNOBS, no injector.
      Its streams equal the unchecked twin's (``unchecked``, the serve
      graphs phase, near-tie rule), no quarantine, no audit violation, no
      capture after the freeze, every pdecode key checked, and its steady
      steps upload nothing. Its TPOT p50 and tokens/s beside the unchecked
      twin's are the cost of the check (and of the per-step host audit).
    - Scheduled faults: the same twin with FaultPlan(schedule=
      FAULT_SCHEDULE). Exactly the two victims fail, with the JAX engine's
      error strings; the other six streams equal the clean twin's token
      for token; one quarantine, two failed requests, two faults, no leak,
      and no K4 launch outside a replay.
    - A genuine non-finite (``run_nan_serve``): NaN K rows in a block only
      the victim lane holds. With detection its lane is quarantined by the
      on-device isfinite and the other streams equal the eager serve's;
      the planted fault is the same serve with detection off, which
      commits the victim's garbage tokens and fails nothing: the verdict
      (``nan_quarantined``) must tell the two apart."""
    from neuronx_distributed_llama3_2_tpu_torch.kernels import paged_attention as pa
    from neuronx_distributed_llama3_2_tpu_torch.serving.faults import (
        FaultInjector,
        FaultPlan,
    )

    # the clean checked twin
    t0 = time.perf_counter()
    server = make_server(cfg, model, prewarm=True, **CHECKED_KNOBS)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    m = server.metrics
    keys = server.program_registry()
    check(server._check_logits and all(k[-1] for k in keys if k[0] == "pdecode")
          and any(k[0] == "pdecode" for k in keys),
          f"faults: the checked twin's pdecode keys are not all checked: {sorted(map(str, keys))}")
    t0 = time.perf_counter()
    rids = [server.submit(p) for p in prompts]
    outs, uploads = steady_upload_steps(server)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    clean = serve_stats(server, rids, outs, wall)
    clean_outs = [outs[r] for r in rids]
    differ = same_streams("faults checked twin", model, prompts, clean_outs,
                          unchecked["outs"], rids)
    check(m.lane_quarantines == 0 and m.audit_violations == 0 and m.failed_requests == 0,
          f"faults: the clean checked twin quarantined {m.lane_quarantines}, audit "
          f"violations {m.audit_violations}, failed {m.failed_requests}")
    check(m.steadystate_compiles == 0, f"faults: {m.steadystate_compiles} captures after "
          "the freeze in the checked twin")
    check(len(uploads) > 0 and not any(uploads),
          f"faults: the checked twin's steady steps uploaded {uploads}")
    check(server.allocator.leak_check() == [], "faults: the checked twin leaks blocks")
    log(f"faults: clean checked twin ({CHECKED_KNOBS}, prewarmed: {m.prewarm_compiles} "
        f"graphs in {capture_s:.6f} s): streams equal to the unchecked twin's on "
        f"{len(rids) - len(differ)} of {len(rids)} requests (the rest near ties); "
        f"{len(uploads)} steady steps, h2d_uploads a steady step {max(uploads)}; "
        f"lane_quarantines {m.lane_quarantines}, audit_violations {m.audit_violations} over "
        f"{m.engine_steps} audits, steadystate_compiles {m.steadystate_compiles}; TPOT p50 "
        f"{clean['tpot']:.6f} ms, {clean['tokens_s']:.6f} tokens/s against the unchecked "
        f"twin's {unchecked['tpot']:.6f} ms, {unchecked['tokens_s']:.6f} tokens/s (TPOT "
        f"{100 * (clean['tpot'] / unchecked['tpot'] - 1):+.4f}%: the on-device check, the "
        f"finite readback and the host audit each step) | {card}")
    del server, keys
    gc.collect()
    torch.cuda.empty_cache()

    # scheduled faults on the same twin
    counters = {"t1": pa.t1_launches, "tile": pa.tile_launches, "all": pa.launches}
    for c in counters.values():
        c.reset()
    injector = FaultInjector(FaultPlan(schedule=FAULT_SCHEDULE))
    server = make_server(cfg, model, prewarm=True, injector=injector, **CHECKED_KNOBS)
    captured = {src: c.count for src, c in counters.items()}
    rids = [server.submit(p) for p in prompts]
    outs = server.run_to_completion()
    torch.cuda.synchronize()
    during = {src: c.count - captured[src] for src, c in counters.items()}
    m = server.metrics
    fired = list(injector.fired)
    check([f[1:3] for f in fired] == [("nan", "decode"), ("device", "decode")],
          f"faults: fired {fired}, not one nan and one device fault at decode dispatches")
    (nan_lane,), (dev_lane,) = fired[0][3], fired[1][3]
    failed = {r: server.request_info(r)["error"] for r in rids
              if server.request_info(r)["status"] == "failed"}
    want_errors = sorted(["non-finite logits at decode step (lane quarantined)",
                          f"injected device fault at decode (lanes [{dev_lane}])"])
    check(len(failed) == 2 and sorted(failed.values()) == want_errors,
          f"faults: failed requests {failed}, want the errors {want_errors}")
    survivors = [j for j, r in enumerate(rids) if r not in failed]
    same = [outs[rids[j]] == clean_outs[j] for j in survivors]
    check(all(same), f"faults: survivors' streams differ from the clean twin's: {same}")
    for j, r in enumerate(rids):
        if r in failed:
            check(outs[r] == clean_outs[j][: len(outs[r])],
                  f"faults: request {j}'s partial output is not a prefix of its clean stream")
    check((m.lane_quarantines, m.failed_requests, m.faults_injected) == (1, 2, 2),
          f"faults: lane_quarantines {m.lane_quarantines}, failed_requests "
          f"{m.failed_requests}, faults_injected {m.faults_injected}")
    check(server.allocator.leak_check() == [] and server.allocator.active_blocks == 0,
          "faults: the faulted twin leaks blocks")
    check(not any(during.values()) and m.steadystate_compiles == 0,
          f"faults: K4 launched outside a replay {during}, steadystate_compiles "
          f"{m.steadystate_compiles}")
    log(f"faults: scheduled {FAULT_SCHEDULE} on the checked twin: fired {fired}; failed "
        f"{failed}; {len(survivors)} survivors token for token the clean twin's; "
        f"lane_quarantines {m.lane_quarantines}, failed_requests {m.failed_requests}, "
        f"faults_injected {m.faults_injected}, leak_check [], K4 launches outside a "
        f"replay {during} | {card}")
    del server
    gc.collect()
    torch.cuda.empty_cache()

    # a genuine non-finite, with and without detection
    verdicts = {}
    for detect in (True, False):
        server, n_rids, victim, n_at_write = run_nan_serve(cfg, model, prompts, detect)
        verdicts[detect] = nan_quarantined(server, victim, n_at_write)
        j_victim = n_rids.index(victim)
        others = [j for j in range(len(n_rids)) if j != j_victim]
        info = server.request_info(victim)
        if detect:
            same_streams("faults genuine NaN", model, [prompts[j] for j in others],
                         [server._finished[n_rids[j]].out for j in others],
                         [eager_outs[j] for j in others], [n_rids[j] for j in others])
        else:
            check(info["generated_tokens"] > n_at_write and server.metrics.failed_requests == 0,
                  f"faults: the serve without detection committed "
                  f"{info['generated_tokens'] - n_at_write} NaN-lane tokens and failed "
                  f"{server.metrics.failed_requests}")
        log(f"faults: genuine NaN (K rows of request {j_victim}'s private last block, layer "
            f"0, after step {NAN_AFTER_STEP}), detect_nonfinite={detect}: victim "
            f"{info['status']} ({info['error']}), {info['generated_tokens'] - n_at_write} "
            f"tokens after the write; lane_quarantines {server.metrics.lane_quarantines}, "
            f"failed_requests {server.metrics.failed_requests}; verdict quarantined "
            f"{verdicts[detect]} | {card}")
        del server
        gc.collect()
        torch.cuda.empty_cache()
    check(verdicts == {True: True, False: False},
          f"faults: the genuine-NaN verdict does not tell detection from none: {verdicts}")


def run_quant_spec_serve_phase(cfg, model, card: str):
    """F's prompts and knobs from an int8 pool (mode 3): the widest reach
    of the tile source's quantized instances, every verify and mixed call.
    A warm-up serve, then the counted serve; every token within Q1's int8
    margin (QUANT_LOGIT_MARGIN, the same check: one whole-prompt pass over
    a fresh int8 pool) of that pass's argmax; and a serve whose every
    kernel call reads V's scales as K's must read above it. Returns
    (prompts, outputs in prompt order)."""
    from neuronx_distributed_llama3_2_tpu_torch.kernels import paged_attention as pa

    fcfg, prompts = spec_config(cfg), spec_prompts()
    knobs = dict(SPEC_KNOBS, kv_cache_dtype="int8")
    serve_staged(make_server(fcfg, model, **knobs), prompts)
    server = make_server(fcfg, model, **knobs)
    for c in (pa.launches, pa.tile_launches, pa.row_live_launches):
        c.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids, outs = serve_staged(server, prompts)
    torch.cuda.synchronize()
    stats = serve_stats(server, rids, outs, time.perf_counter() - t0)
    m = server.metrics
    for r in rids:
        check(len(outs[r]) == MAX_NEW, f"QF: request {r} produced {len(outs[r])} tokens")
    check(m.mixed_dispatches > 0 and m.verify_steps > 0 and pa.tile_launches.count > 0
          and pa.row_live_launches.count == m.mixed_dispatches * cfg.num_layers,
          f"QF: mixed {m.mixed_dispatches}, verify {m.verify_steps}, tile launches "
          f"{pa.tile_launches.count}, row_live launches {pa.row_live_launches.count}")
    margin = QUANT_LOGIT_MARGIN["int8"]
    gap, exact, total, each = quant_e2e_gaps(cfg, model, "int8", prompts, outs, rids)
    log(f"serve QF (F's knobs from an int8 pool, mode 3): {stats['tokens_s']:.6f} tokens/s, "
        f"TTFT p50 {stats['ttft']:.6f} ms, TPOT p50 {stats['tpot']:.6f} ms; {m.mixed_dispatches} "
        f"mixed, {m.verify_steps} verify, accepted_tokens {m.accepted_tokens}; K4 launches "
        f"{pa.launches.count}, tile {pa.tile_launches.count}; e2e: {exact}/{total} served "
        f"tokens are the argmax of one whole-prompt pass over an int8 pool, worst gap "
        f"{gap:.6g} (margin {margin}); every request: {each} | {card}")
    check(gap <= margin, f"QF: a served token is {gap} below the argmax logit")
    with model_kernel_call(v_scale_as_k_scale):
        bad_rids, bad_outs = serve_staged(make_server(fcfg, model, **knobs), prompts)
    bad_gap, bad_exact, _, _ = quant_e2e_gaps(cfg, model, "int8", prompts, bad_outs, bad_rids)
    log(f"e2e QF planted fault (v_scale passed as k_scale in every kernel call): "
        f"{bad_exact}/{total} served tokens are the argmax; worst logit gap {bad_gap:.6g} "
        f"(margin {margin})")
    check(bad_gap > margin, f"the QF e2e check passes a planted scale fault (gap {bad_gap})")
    return prompts, [outs[r] for r in rids]


# -- 4f. on-device sampling (PagedConfig.on_device_sampling) --------------------

# the sampled serves' config: nucleus sampling at temperature 0.8, as chat
# traffic is served
SAMPLED = dict(greedy=False, temperature=0.8, top_p=0.95)
# the sampler phase: per-lane (temperature, top_k, top_p) of its 8 lanes,
# greedy sentinels (temperature 0) among them, and the landing index of
# each lane's first row
SAMPLER_LANES = ((0.0, 0, 1.0), (0.8, 0, 0.95), (0.7, 50, 1.0), (1.0, 0, 1.0),
                 (1.2, 40, 0.9), (0.6, 1000, 0.5), (0.8, 0, 0.95), (0.0, 0, 1.0))
SAMPLER_INDEX0 = 700
# its shapes: Serve's decode, F's verify and mixed steps, T's tree verify
# and mixed steps (rows of one lane; all at B = 8, V = 128256)
SAMPLER_SHAPES = (("Serve decode", 1), ("F verify", 5), ("F mixed", 16),
                  ("T verify / mixed", 32))
# a draw the card and the CPU disagree on must be a near tie there: its
# top two perturbed values within this relative distance
SAMPLER_TIE = 1e-5
# the frequency check: a sharp config, FREQ_DRAWS landing indices for each
# of the first FREQ_LANES lanes, drawn FREQ_CHUNK indices at a time; the
# chi-square statistic over the kept tokens of all lanes must lie within
# FREQ_SIGMAS standard deviations of its degrees of freedom, and the same
# draws with the temperature applied twice must lie outside
FREQ_CONFIG = (0.7, 50, 1.0)
FREQ_LANES = 4
FREQ_DRAWS = 4096
FREQ_CHUNK = 512
FREQ_SIGMAS = 5.0
# the replay serve's pool: 112 usable blocks against the ~170 Serve's eight
# requests hold at once, and one block of admission headroom, so that
# admissions wait and decode growth preempts lanes (two preemptions: the
# block accounting depends on lengths alone, so a CPU run shows it)
REPLAY_BLOCKS = 113


def sampling_config(**kw):
    from neuronx_distributed_llama3_2_tpu_torch.inference.sampling import SamplingConfig

    return SamplingConfig(**kw)


def lane_key(rid: int) -> np.ndarray:
    """Request ``rid``'s base key data, as the engine installs it
    (``PagedServingEngine._lane_rng`` at GenerationConfig's seed 0)."""
    return np.random.SeedSequence([0, int(rid)]).generate_state(2).astype(np.int64)


def sampled_rows(logits, rid: int, start: int, sampling):
    """The sampled view of ``logits (n, V)``, rows landing at sequence
    indices start .. start + n - 1 of request ``rid``: (gumbel noise of
    each row's key, tempered logits, filtered tempered logits, each row's
    top-p / top-k cutoff value), all (n, V) or (n,) float32 on the
    logits' device."""
    from neuronx_distributed_llama3_2_tpu_torch.inference.sampling import (
        filtered_logits,
        gumbel,
        lane_keys,
    )

    n, v = logits.shape
    dev = logits.device
    lf = logits.float()
    key = torch.as_tensor(lane_key(rid), device=dev)[None].expand(n, 2)
    g = gumbel(lane_keys(key, start + torch.arange(n, device=dev)), v)
    filt = filtered_logits(
        lf, torch.full((n,), sampling.temperature, device=dev),
        torch.full((n,), sampling.top_k, dtype=torch.int32, device=dev),
        torch.full((n,), sampling.top_p, device=dev),
    )
    cutoff = torch.where(torch.isfinite(filt), filt, torch.full_like(filt, float("inf")))
    return g, lf / sampling.temperature, filt, cutoff.amin(dim=-1)


def sampled_e2e_gaps(model, prompts, outs, rids, sampling):
    """The sampled twin of ``e2e_gaps``: teacher-forced, each served token
    against the draw the plain full-sequence forward gives at its landing
    index with the request's key. A token's gap is how far its perturbed
    value (gumbel + tempered logit) lies below the largest perturbed value
    of the filtered logits, or, where the filter dropped it, how far its
    tempered logit lies below the filter's cutoff: bf16 noise moves the
    draw only across such near ties. Returns the largest gap (tempered
    logits), and how many served tokens were the plain forward's draw,
    of how many."""
    worst, exact, total = 0.0, 0, 0
    for j, prompt in enumerate(prompts):
        gen = outs[rids[j]]
        ids = torch.as_tensor([prompt + gen[:-1]], device="cuda")
        logits = model(ids)[0, len(prompt) - 1:].float()
        check(bool(torch.isfinite(logits).all()), "non-finite plain logits")
        g, x, filt, cutoff = sampled_rows(logits, rids[j], len(prompt), sampling)
        tok = torch.as_tensor(gen, device="cuda")
        rows = torch.arange(len(gen), device="cuda")
        pert = g + filt
        mine = g[rows, tok] + x[rows, tok]
        gap = torch.maximum(pert.max(dim=-1).values - mine,
                            (cutoff - x[rows, tok]).clamp_min(0))
        worst = max(worst, gap.max().item())
        exact += int((pert.argmax(dim=-1) == tok).sum())
        total += len(gen)
    return worst, exact, total


def same_streams(label: str, model, prompts, outs: list, want: list, rids, sampling=None):
    """Where one of ``outs`` differs from ``want`` (both in prompt order),
    the first token that differs must be a near tie under the plain
    forward: greedy, the two tokens' logits within LOGIT_MARGIN; sampled
    (``sampling``), their perturbed values at the token's landing index
    (request ``rids[j]``'s key) within LOGIT_MARGIN / temperature, or one
    of them within that of the filter's cutoff. Logs each difference.
    Returns the (request, token) pairs that differ."""
    differ = [(j, first_difference(o, w)) for j, (o, w) in enumerate(zip(outs, want))]
    differ = [(j, i) for j, i in differ if i is not None]
    for j, i in differ:
        served = outs[j]
        logits = model(torch.as_tensor([prompts[j] + served[:i]], device="cuda"))[0, -1:].float()
        a, b = served[i], want[j][i]
        if sampling is None or sampling.greedy:
            tie, limit = abs(logits[0, a] - logits[0, b]).item(), LOGIT_MARGIN
            what = "plain-forward logits"
        else:
            g, x, _, cutoff = sampled_rows(logits, rids[j], len(prompts[j]) + i, sampling)
            val = g[0] + x[0]
            tie = min(abs(val[a] - val[b]).item(), abs(x[0, a] - cutoff[0]).item(),
                      abs(x[0, b] - cutoff[0]).item())
            limit = LOGIT_MARGIN / sampling.temperature
            what = "perturbed plain-forward values (or one of them and the cutoff)"
        log(f"{label}: request {j} first differs at token {i} ({a} against {b}); their "
            f"{what} lie {tie:.6g} apart (near-tie limit {limit:.6g})")
        check(tie <= limit, f"{label}: request {j} differs at token {i}, not a near tie ({tie})")
    return differ


def lane_tensors(device: str, b: int = 8):
    """The sampler phase's per-lane (key data, temperature, top_k, top_p)
    on ``device``: SAMPLER_LANES, each lane keyed as request ``lane``."""
    rows = SAMPLER_LANES[:b]
    return (
        torch.as_tensor(np.stack([lane_key(i) for i in range(b)]), device=device),
        torch.tensor([r[0] for r in rows], dtype=torch.float32, device=device),
        torch.tensor([r[1] for r in rows], dtype=torch.int32, device=device),
        torch.tensor([r[2] for r in rows], dtype=torch.float32, device=device),
    )


def chi_square(draws: torch.Tensor, logits: torch.Tensor, temperature: float, k: int):
    """Pearson's chi-square of ``draws (L, n)`` against the filtered softmax
    of ``logits (L, V)`` at (temperature, top_k k), summed over the lanes,
    with its degrees of freedom, and the draws outside each lane's top k."""
    stat, dof, outside = 0.0, 0, 0
    n = draws.shape[1]
    for lane in range(draws.shape[0]):
        lf = logits[lane].float()
        kth = torch.topk(lf, k).values[-1]
        kept = lf >= kth
        probs = torch.softmax(torch.where(kept, lf / temperature,
                                          torch.full_like(lf, float("-inf"))), dim=0)
        counts = torch.bincount(draws[lane].long(), minlength=lf.numel()).double()
        outside += int(counts[~kept].sum())
        e = probs[kept].double() * n
        stat += float(((counts[kept] - e) ** 2 / e).sum())
        dof += int(kept.sum()) - 1
    return stat, dof, outside


def run_sampler_phase(cfg, model, card: str) -> dict:
    """``sample_lanes`` on the card at each served shape (SAMPLER_SHAPES, B
    = 8, V = 128256), over the model's own logits of 8 random sequences
    and SAMPLER_LANES' mixed configs: its draws against the same function
    on a CPU copy of the same logits (a difference must be a near tie, its
    top two perturbed values within SAMPLER_TIE relative; a greedy lane's
    never differs), its device time, and the bytes it must move (the bf16
    logits read once, the tokens written). Then the frequency check at
    FREQ_CONFIG against the filtered softmax, which must reject the same
    draws with the temperature applied twice. Returns shape -> device
    ms."""
    from neuronx_distributed_llama3_2_tpu_torch.inference.sampling import (
        perturbed_logits,
        sample_lanes,
    )

    b, v, t_max = 8, cfg.vocab_size, SAMPLER_SHAPES[-1][1]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    ids = torch.randint(0, v, (b, 64), device="cuda", generator=gen)
    with torch.no_grad():
        logits = model(ids)[:, -t_max:]                                  # (8, 32, V)
    check(bool(torch.isfinite(logits).all()), "non-finite sampler logits")
    dev_args, cpu_args = lane_tensors("cuda"), lane_tensors("cpu")
    out = {}
    for name, t in SAMPLER_SHAPES:
        lg = logits[:, -1] if t == 1 else logits[:, :t].contiguous()
        index = SAMPLER_INDEX0 + torch.arange(t, device="cuda")[None, :].expand(b, t)
        index = index[:, 0].contiguous() if t == 1 else index.contiguous()
        got = sample_lanes(lg, dev_args[0], index, *dev_args[1:]).cpu()
        lg_cpu, idx_cpu = lg.cpu(), index.cpu()
        want = sample_lanes(lg_cpu, cpu_args[0], idx_cpu, *cpu_args[1:])
        rows = (got != want).reshape(b, -1)
        ties = []
        for lane, j in torch.nonzero(rows).tolist():
            check(SAMPLER_LANES[lane][0] > 0,
                  f"sampler {name}: greedy lane {lane} drew {got.reshape(b, -1)[lane, j]} "
                  f"on the card, {want.reshape(b, -1)[lane, j]} on the CPU")
            row = lg_cpu.reshape(b, -1, v)[lane, j][None]
            pert = perturbed_logits(row, cpu_args[0][lane:lane + 1],
                                    idx_cpu.reshape(b, -1)[lane, j:j + 1],
                                    *(a[lane:lane + 1] for a in cpu_args[1:]))[0]
            top2 = torch.topk(pert, 2).values
            rel = ((top2[0] - top2[1]) / top2.abs().max()).item()
            ties.append((lane, j, rel))
            check(rel <= SAMPLER_TIE, f"sampler {name}: lane {lane} row {j} drew "
                  f"{got.reshape(b, -1)[lane, j]} on the card, {want.reshape(b, -1)[lane, j]} "
                  f"on the CPU, top two perturbed values {rel:.3g} apart (relative)")
        # one window (timing depth cut for the cp phase's time)
        (ms,), wall = device_ms(
            lambda i: sample_lanes(lg, dev_args[0], index, *dev_args[1:]),
            iters=10, windows=1)
        nbytes = lg.numel() * lg.element_size() + b * t * 4
        out[name] = ms
        log(f"sampler {name}: (8, {t}, {v}) logits, {b * t} draws: card = CPU on "
            f"{b * t - len(ties)} of {b * t}, near ties {ties}; device {ms:.6f} ms "
            f"({wall:.6f} ms by events) per call; it must move {nbytes} bytes "
            f"(bytes bound {nbytes / 3.35e12 * 1e3:.6f} ms) | {card}")
    # frequency check
    temp, k, top_p = FREQ_CONFIG
    lanes = logits[:FREQ_LANES, -1]
    args = (torch.as_tensor(np.stack([lane_key(i) for i in range(FREQ_LANES)]), device="cuda"),
            torch.full((FREQ_LANES,), temp, device="cuda"),
            torch.full((FREQ_LANES,), k, dtype=torch.int32, device="cuda"),
            torch.full((FREQ_LANES,), top_p, device="cuda"))
    readings = {}
    for case, t_draw in (("sound", temp), ("temperature applied twice", temp * temp)):
        draws = []
        for c0 in range(0, FREQ_DRAWS, FREQ_CHUNK):
            rows = lanes[:, None].expand(FREQ_LANES, FREQ_CHUNK, v)
            index = (c0 + torch.arange(FREQ_CHUNK, device="cuda"))[None].expand(FREQ_LANES, -1)
            draws.append(sample_lanes(rows, args[0], index.contiguous(),
                                      torch.full_like(args[1], t_draw), *args[2:]))
        stat, dof, outside = chi_square(torch.cat(draws, dim=1), lanes, temp, k)
        readings[case] = (stat, outside)
        log(f"sampler frequency ({case}): {FREQ_LANES} lanes x {FREQ_DRAWS} landing indices "
            f"at temperature {temp}, top_k {k}: chi-square {stat:.6g} on {dof} degrees of "
            f"freedom (limit {dof + FREQ_SIGMAS * (2 * dof) ** 0.5:.6g}), {outside} draws "
            f"outside the top {k} | {card}")
    limit = dof + FREQ_SIGMAS * (2 * dof) ** 0.5
    check(readings["sound"][0] <= limit and readings["sound"][1] == 0,
          f"sampler frequencies: chi-square {readings['sound']} against limit {limit}")
    check(readings["temperature applied twice"][0] > limit,
          f"the frequency check passes the temperature applied twice "
          f"({readings['temperature applied twice']}, limit {limit})")
    return out


def run_sampled_serve_phase(scfg, model, label: str, prompts, card: str, sampling,
                            margin: float, **knobs):
    """Serve ``label``'s requests eagerly under on-device sampling with the
    sampled config ``sampling`` (warm-up serve first): every draw on the
    card (``sampled_steps`` > 0, no host fallback), K4's t1 and tile
    sources launched (their counters zeroed just before the serve and read
    just after), and every served token the plain forward's draw or within
    ``margin`` / temperature of it (``sampled_e2e_gaps``). Returns (streams
    in prompt order, rids, ``serve_stats``)."""
    from neuronx_distributed_llama3_2_tpu_torch.kernels import paged_attention as pa

    knobs = dict(knobs, on_device_sampling=True)
    staged = staged_serve(knobs)
    serve_requests(make_server(scfg, model, sampling=sampling, **knobs), prompts, staged)
    server = make_server(scfg, model, sampling=sampling, **knobs)
    counters = {"t1": pa.t1_launches, "tile": pa.tile_launches}
    for c in counters.values():
        c.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids, outs = serve_requests(server, prompts, staged)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = {src: c.count for src, c in counters.items()}
    check(launched["t1"] > 0 and launched["tile"] > 0,
          f"sampled {label}: K4 launches {launched}")
    stats = serve_stats(server, rids, outs, wall)
    m = server.metrics
    check(all(len(outs[r]) == MAX_NEW for r in rids), f"sampled {label}: short streams")
    check(m.sampled_steps > 0 and m.host_sample_fallbacks == 0
          and m.rng_reseeds == len(prompts) + m.preemptions,
          f"sampled {label}: sampled_steps {m.sampled_steps}, host_sample_fallbacks "
          f"{m.host_sample_fallbacks}, rng_reseeds {m.rng_reseeds}")
    gap, exact, total = sampled_e2e_gaps(model, prompts, outs, rids, sampling)
    limit = margin / sampling.temperature
    log(f"sampled {label} ({sampling}): {len(rids)} requests, {total} tokens in "
        f"{wall:.6f} s = {stats['tokens_s']:.6f} tokens/s; TTFT p50 {stats['ttft']:.6f} ms, "
        f"TPOT p50 {stats['tpot']:.6f} ms; sampled_steps {m.sampled_steps}, "
        f"rng_reseeds {m.rng_reseeds}, decode steps {m.decode_steps}, verify steps "
        f"{m.verify_steps}, accepted {m.accepted_tokens}; K4 launches {launched}; e2e: "
        f"{exact}/{total} served "
        f"tokens are the plain forward's draw, worst gap {gap:.6g} (limit {limit:.6g}) "
        f"| {card}")
    check(gap <= limit, f"sampled {label}: a served token lies {gap} below the plain draw")
    return [outs[r] for r in rids], rids, stats


def run_sampled_replay_phase(cfg, model, prompts, want: list, card: str, sampling) -> None:
    """Serve's requests sampled on a pool of REPLAY_BLOCKS blocks, small
    enough that lanes are preempted and resume by re-prefilling their
    generated tokens: each draw is keyed by its landing index and the
    request's key is re-installed at re-admission, so the streams must be
    the unpreempted sampled serve's (``want``), up to near ties
    (``same_streams``: the resumed rows' K/V come from a prefill, not the
    decode steps, and differ in bf16 rounding)."""
    server = make_server(cfg, model, sampling=sampling, on_device_sampling=True,
                         num_blocks=REPLAY_BLOCKS, decode_reserve_blocks=1)
    rids, outs = serve_requests(server, prompts, staged=False)
    m = server.metrics
    check(m.preemptions > 0, f"replay: no lane was preempted ({REPLAY_BLOCKS} blocks)")
    check(m.rng_reseeds == len(prompts) + m.preemptions and m.host_sample_fallbacks == 0,
          f"replay: rng_reseeds {m.rng_reseeds}, preemptions {m.preemptions}")
    differ = same_streams("replay", model, prompts, [outs[r] for r in rids], want, rids,
                          sampling)
    log(f"replay: sampled Serve on {REPLAY_BLOCKS} blocks: {m.preemptions} preemptions, "
        f"{m.rng_reseeds} key installs, admit_blocked {m.admit_blocked}; streams equal to "
        f"the unpreempted sampled serve's on {len(rids) - len(differ)} of {len(rids)} "
        f"requests | {card}")


class StreamDrafter:
    """Proposes the continuation of whichever of ``seqs`` (prompt + the
    non-speculative sampled stream) a lane's history starts, so that
    sampled drafts are accepted; elsewhere it abstains."""

    def __init__(self, seqs):
        self.seqs = seqs

    def propose(self, history, max_tokens):
        for s in self.seqs:
            if s[: len(history)] == list(history):
                return s[len(history): len(history) + max_tokens]
        return []


def run_sampled_spec_phase(fcfg, model, prompts, f_outs: list, card: str, sampling) -> None:
    """Sampled speculation: F's prompts served sampled without speculation
    (16-token chunks, no fused step, the same seed and rids), then with
    F's knobs and a drafter proposing that serve's streams (so that drafts
    are accepted: the accept rule compares them with the draws at their
    landing indices). Both the drafted serve's streams and those of F's
    sampled serve (``f_outs``, the n-gram drafter) must equal the plain
    sampled streams up to near ties."""
    plain = make_server(fcfg, model, sampling=sampling, on_device_sampling=True,
                        prefill_chunk_tokens=SPEC_KNOBS["prefill_chunk_tokens"])
    rids, outs = serve_requests(plain, prompts, staged=True)
    want = [outs[r] for r in rids]
    drafter = StreamDrafter([p + w for p, w in zip(prompts, want)])
    spec = make_server(fcfg, model, drafter=drafter, sampling=sampling,
                       on_device_sampling=True, **SPEC_KNOBS)
    s_rids, s_outs = serve_requests(spec, prompts, staged=True)
    m = spec.metrics
    check(s_rids == rids and m.verify_steps > 0 and m.accepted_tokens > 0
          and m.sampled_steps > 0 and m.host_sample_fallbacks == 0,
          f"sampled speculation: rids {s_rids} / {rids}, verify_steps {m.verify_steps}, "
          f"accepted {m.accepted_tokens}, sampled_steps {m.sampled_steps}")
    d_spec = same_streams("sampled speculation", model, prompts, [s_outs[r] for r in rids],
                          want, rids, sampling)
    d_f = same_streams("sampled F against the plain sampled serve", model, prompts, f_outs,
                       want, rids, sampling)
    log(f"sampled speculation: drafts {m.draft_tokens}, accepted {m.accepted_tokens} in "
        f"{m.verify_steps} verify steps ({m.mixed_dispatches} mixed); streams equal to the "
        f"non-speculative sampled serve's on {len(rids) - len(d_spec)} of {len(rids)} "
        f"requests (the n-gram-drafted F serve: {len(rids) - len(d_f)}) | {card}")


def sampled_summary(rows, card: str) -> None:
    """One line of serve numbers: (label, serve_stats) pairs."""
    log("sampled serves against the greedy twins of this run: " + "; ".join(
        f"{name}: {st['tokens_s']:.6f} tokens/s, TTFT p50 {st['ttft']:.6f} ms, TPOT p50 "
        f"{st['tpot']:.6f} ms" for name, st in rows) + f" | {card}")


# -- 4g. the degradation ladder and the front door ------------------------------

#: the ladder phase (Serve's prewarmed async twin): one event a rung; three
#: device faults climb to the kernel-shed rung 3 at step 7, which holds for
#: LADDER_RECOVER steps, and the ladder is back at 0 after 3 x LADDER_RECOVER
#: clean steps with Serve's last tokens still to decode; a fourth fault
#: reaches rung 4, which sheds the youngest lane
LADDER_RECOVER = 6
LADDER_FAULTS = ((3, "device"), (5, "device"), (7, "device"))
LADDER_SHED_FAULTS = LADDER_FAULTS + ((9, "device"),)
LADDER_KNOBS = dict(degrade_after_faults=1, degrade_window_steps=16,
                    degrade_recover_steps=LADDER_RECOVER)


def gather_bit(key) -> bool:
    """A program key's gather bit (the kernel-shed rung's twins)."""
    return bool(key[4] if key[0] in ("psfx", "pmixed") else key[3])


def kernel_kept_at_rung_3(server) -> None:
    """A planted ladder fault: from rung 3 on the program keys carry the
    gather bit, but ``_step_model`` keeps the kernel model, so the gather
    twins still launch K4."""
    server._step_model = lambda: server.model
    server._gather_shed = lambda: server._degrade_level >= 3


def ladder_serve(cfg, model, prompts, schedule, fault=None) -> dict:
    """Serve's prewarmed async twin with the ladder armed (LADDER_KNOBS)
    and a FaultPlan of ``schedule``, stepped one step at a time inside
    ``counted_captures``. Records per step the level its dispatches ran at,
    the level after it, its host wall ms, its actions and each record's
    replays in it, and times every capture after the freeze (the gather
    twins'). ``fault`` plants a fault into the built server. Returns the
    server, its rids and outputs, the steps, the captured launches, the
    capture seconds and K4's wrapper launches during the serve (outside
    any replay)."""
    from neuronx_distributed_llama3_2_tpu_torch.serving.faults import (
        FaultInjector,
        FaultPlan,
    )

    with counted_captures() as held:
        server = make_server(cfg, model, prewarm=True, async_loop=True,
                             injector=FaultInjector(FaultPlan(schedule=schedule)),
                             **LADDER_KNOBS)
        if fault is not None:
            fault(server)
        captures = []
        capture = server._capture

        def timed_capture(fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = capture(fn)
            torch.cuda.synchronize()
            captures.append(time.perf_counter() - t0)
            return out

        server._capture = timed_capture
        k4_before = k4_counts()
        rids = [server.submit(p) for p in prompts]
        steps, alive = [], True
        while alive:
            level = server._degrade_level
            before = {k: r.replays for k, r in server.program_registry().items()}
            t0 = time.perf_counter()
            alive = server.step()
            ms = (time.perf_counter() - t0) * 1e3
            replayed = {k: r.replays - before.get(k, 0)
                        for k, r in server.program_registry().items()
                        if r.replays != before.get(k, 0)}
            steps.append(dict(level=level, after=server._degrade_level, ms=ms,
                              replayed=replayed,
                              actions={a.type.value for a in server.action_trace[-1][2]}))
        torch.cuda.synchronize()
        k4_during = {s: n - k4_before[s] for s, n in k4_counts().items()}
    outs = {rid: r.out for rid, r in sorted(server._finished.items())}
    return dict(server=server, rids=rids, outs=outs, steps=steps, held=held,
                captures=captures, k4_during=k4_during)


def rung3_k4(run: dict) -> int:
    """K4's launches, by replay, in the steps a serve dispatched at ladder
    level 3 or more: each replayed record's replays in the step times the
    launches its graph captured."""
    held, registry = run["held"], run["server"].program_registry()
    return sum(n * sum(held[id(registry[k].graph)].values())
               for st in run["steps"] if st["level"] >= 3
               for k, n in st["replayed"].items())


def ladder_levels(steps) -> list:
    """The levels a serve passed through, each once a visit (from 0)."""
    seq = [0]
    for st in steps:
        if st["after"] != seq[-1]:
            seq.append(st["after"])
    return seq


def fault_errors(run: dict) -> tuple:
    """(failed rid -> error, the JAX engine's error strings for the fired
    device faults): each fault fails the request on its victim lane."""
    server = run["server"]
    failed = {r: server.request_info(r)["error"] for r in run["rids"]
              if server.request_info(r)["status"] == "failed"}
    want = sorted(f"injected device fault at decode (lanes [{lanes[0]}])"
                  for _, kind, site, lanes in server.injector.fired)
    return failed, want


def check_ladder_streams(label: str, model, prompts, run: dict, clean: list) -> None:
    """The survivors' streams equal the clean twin's (``clean``, in prompt
    order) under the near-tie rule, a failed request's partial stream is a
    prefix of its clean stream (the same rule), and every served token is
    within E2E_LOGIT_MARGIN of the plain forward's argmax."""
    rids, outs = run["rids"], run["outs"]
    failed = {r for r in rids if run["server"].request_info(r)["status"] == "failed"}
    for j, r in enumerate(rids):
        if r not in failed:
            check(len(outs[r]) == MAX_NEW, f"{label}: request {j} produced {len(outs[r])}")
    same_streams(label, model, prompts, [outs[r] for r in rids],
                 [clean[j][: len(outs[r])] for j, r in enumerate(rids)], rids)
    picks = [j for j, r in enumerate(rids) if outs[r]]
    gap, exact, total = e2e_gaps(model, prompts, outs, rids, picks=picks)
    log(f"{label}: {exact}/{total} served tokens are the plain forward's argmax; worst "
        f"logit gap {gap:.6g} (margin {E2E_LOGIT_MARGIN})")
    check(gap <= E2E_LOGIT_MARGIN, f"{label}: a served token is {gap} below the argmax")


def check_clean_engine(label: str, server) -> None:
    from neuronx_distributed_llama3_2_tpu_torch.serving.invariants import audit_engine

    violations = audit_engine(server)
    check(server._pending is None and server.allocator.active_blocks == 0
          and server.allocator.leak_check() == [] and not violations,
          f"{label}: pending {server._pending is not None}, active blocks "
          f"{server.allocator.active_blocks}, leaks {server.allocator.leak_check()}, "
          f"audit {violations}")


def run_ladder_phase(cfg, model, prompts, clean: list, card: str) -> None:
    """The degradation ladder on Serve's prewarmed async twin
    (``degrade_after_faults=1``, LADDER_KNOBS), against the clean async
    twin's streams (``clean``, in prompt order).

    - Three device faults (LADDER_FAULTS): the ladder climbs 1 -> 2 -> 3
      and back to 0, three degradations; rung 3 holds for at least 6
      decode steps and the ladder is back at 0 with at least 4 decode
      steps left. Exactly the victims fail, with the JAX engine's error
      strings; the survivors' streams are the clean twin's (near-tie
      rule) and every token is within E2E_LOGIT_MARGIN of the plain
      forward. Rung 3 runs the gather twins, captured at their first use:
      each launched K4 0 times when it was captured, every replay at
      level >= 3 is of one, and K4 launches (by replay) at rung 3 are 0;
      after the recovery the t1 source launches again by replay. Nothing
      counts in steadystate_compiles, no K4 launch happens outside a
      replay, the audit is clean and nothing leaks. Logs the levels step
      by step, the capture seconds of the gather twins and the median
      step ms by level (2 and 3 both synchronous: the gather against the
      kernel).
    - The same serve with the planted fault ``kernel_kept_at_rung_3``:
      the rung-3 K4 count must read above 0.
    - Four faults (LADDER_SHED_FAULTS): rung 4 sheds the youngest lane
      (one preemption, one PREEMPT action with shed=True), which resumes
      and ends with its clean stream."""
    from neuronx_distributed_llama3_2_tpu_torch.serving.catalog import format_key

    run = ladder_serve(cfg, model, prompts, LADDER_FAULTS)
    server, steps = run["server"], run["steps"]
    m = server.metrics
    levels = ladder_levels(steps)
    log(f"ladder: levels by step {[st['after'] for st in steps]}")
    check(levels == [0, 1, 2, 3, 2, 1, 0] and m.degradations == 3,
          f"ladder: the levels ran {levels}, degradations {m.degradations}")
    decode = [st for st in steps if "DECODE_DISPATCH" in st["actions"]]
    at3 = [st for st in decode if st["level"] >= 3]
    last3 = max(i for i, st in enumerate(steps) if st["level"] >= 3)
    back = max(i for i, st in enumerate(steps) if st["level"] > 0 or st["after"] > 0)
    after0 = [st for st in steps[back + 1:] if "DECODE_DISPATCH" in st["actions"]]
    check(len(at3) >= 6 and len(after0) >= 4,
          f"ladder: {len(at3)} decode steps at rung 3, {len(after0)} back at level 0")
    failed, want = fault_errors(run)
    check(len(failed) == 3 and sorted(failed.values()) == want,
          f"ladder: failed {failed}, want the errors {want}")
    check_ladder_streams("ladder", model, prompts, run, clean)
    registry = server.program_registry()
    gathers = {k: r for k, r in registry.items() if gather_bit(k)}
    check(any(k[0] == "pdecode" for k in gathers)
          and all(not any(run["held"][id(r.graph)].values()) for r in gathers.values()),
          f"ladder: gather twins {[format_key(k) for k in gathers]} captured K4 "
          f"{[run['held'][id(r.graph)] for r in gathers.values()]}")
    stray = [format_key(k) for st in steps if st["level"] >= 3 for k in st["replayed"]
             if not gather_bit(k)]
    check(not stray, f"ladder: replays at rung 3 of kernel records {stray}")
    k4_at3 = rung3_k4(run)
    check(k4_at3 == 0, f"ladder: {k4_at3} K4 launches at rung 3")
    t1_after = sum(n * run["held"][id(registry[k].graph)]["t1"]
                   for st in steps[last3 + 1:] for k, n in st["replayed"].items())
    check(t1_after > 0, "ladder: the t1 source was not replayed after the recovery")
    check(m.steadystate_compiles == 0 and not any(run["k4_during"].values()),
          f"ladder: steadystate_compiles {m.steadystate_compiles}, K4 launched outside a "
          f"replay {run['k4_during']}")
    check_clean_engine("ladder", server)
    by_level = {lv: float(np.median([st["ms"] for st in decode if st["level"] == lv]))
                for lv in sorted({st["level"] for st in decode})}
    log(f"ladder: {LADDER_FAULTS} on Serve's prewarmed async twin ({LADDER_KNOBS}): "
        f"levels {levels}, degradations {m.degradations}; failed {failed}; "
        f"{len(at3)} decode steps at rung 3, {len(after0)} back at level 0; gather twins "
        f"{len(gathers)} ({[format_key(k) for k in gathers]}) captured at first use in "
        f"{[round(s, 6) for s in run['captures']]} s, K4 launches at rung 3 {k4_at3}, "
        f"t1 launches by replay after the recovery {t1_after}; median step ms by level "
        f"{ {lv: round(v, 6) for lv, v in by_level.items()} } (levels 2 and 3 synchronous: "
        f"kernel against gather), programs {m.programs_compiled} (prewarm "
        f"{m.prewarm_compiles}), steadystate_compiles {m.steadystate_compiles} | {card}")
    del run, server, registry, gathers
    gc.collect()
    torch.cuda.empty_cache()

    planted = ladder_serve(cfg, model, prompts, LADDER_FAULTS, fault=kernel_kept_at_rung_3)
    bad = rung3_k4(planted)
    log(f"ladder planted fault (_step_model keeps the kernel model at rung 3): K4 launches "
        f"at rung 3 {bad}, outside a replay {planted['k4_during']}")
    check(bad > 0, "ladder: the rung-3 K4 check passes a ladder that keeps the kernel")
    del planted
    gc.collect()
    torch.cuda.empty_cache()

    run = ladder_serve(cfg, model, prompts, LADDER_SHED_FAULTS)
    server, steps = run["server"], run["steps"]
    m = server.metrics
    shed = [(step, a.meta["rid"]) for step, _, acts in server.action_trace for a in acts
            if a.type.value == "PREEMPT"]
    shed_true = [(step, a.meta["rid"]) for step, _, acts in server.action_trace
                 for a in acts if a.type.value == "PREEMPT" and a.meta["shed"]]
    failed, want = fault_errors(run)
    check(max(st["after"] for st in steps) == 4 and m.degradations == 4
          and m.preemptions == 1 and len(shed) == 1 and shed == shed_true,
          f"ladder shed: levels {ladder_levels(steps)}, degradations {m.degradations}, "
          f"preemptions {m.preemptions}, PREEMPT actions {shed}")
    check(len(failed) == 4 and sorted(failed.values()) == want,
          f"ladder shed: failed {failed}, want {want}")
    shed_rid = shed[0][1]
    check(server.request_info(shed_rid)["status"] == "finished"
          and server.request_info(shed_rid)["preemptions"] == 1,
          f"ladder shed: the shed request {server.request_info(shed_rid)}")
    check_ladder_streams("ladder shed", model, prompts, run, clean)
    check(m.steadystate_compiles == 0 and not any(run["k4_during"].values()),
          f"ladder shed: steadystate_compiles {m.steadystate_compiles}, K4 outside a "
          f"replay {run['k4_during']}")
    check_clean_engine("ladder shed", server)
    log(f"ladder shed: {LADDER_SHED_FAULTS}: levels {ladder_levels(steps)}, degradations "
        f"{m.degradations}; rung 4 shed request {shed_rid} at step {shed[0][0]} (PREEMPT "
        f"shed=True), which resumed and finished with its clean stream; preemptions "
        f"{m.preemptions}; failed {failed}; gather twins captured at first use "
        f"{sorted(format_key(k) for k in server.program_registry() if gather_bit(k))} in "
        f"{[round(s, 6) for s in run['captures']]} s | {card}")
    del run, server
    gc.collect()
    torch.cuda.empty_cache()


#: the front door's objectives: every class's TTFT and TPOT (p99, ms)
DOOR_SLO = dict(slo_ttft_p99_ms=250.0, slo_tpot_p99_ms=25.0)
DOOR_CANCEL_AT = 4


def door_prompt():
    """The front door's ninth request (cancelled mid-stream): 100 seeded
    tokens."""
    return np.random.default_rng(SEED + 17).integers(0, 128256, size=100).tolist()


async def http_call(host: str, port: int, method: str, target: str, body=None) -> tuple:
    """One HTTP/1.1 request on a fresh loopback connection (the server
    closes it after the response): (status, body bytes)."""
    reader, writer = await asyncio.open_connection(host, port)
    payload = b"" if body is None else json.dumps(body).encode()
    writer.write(f"{method} {target} HTTP/1.1\r\nHost: {host}\r\nContent-Type: "
                 f"application/json\r\nContent-Length: {len(payload)}\r\n\r\n".encode()
                 + payload)
    await writer.drain()
    raw = await reader.read()
    writer.close()
    await writer.wait_closed()
    head, _, data = raw.partition(b"\r\n\r\n")
    return int(head.split()[1]), data


def last_token_dropped(server_cls):
    """A planted front-door fault: a ``GraftServer`` whose ``_pump`` never
    pushes a finished request's last token into its stream."""
    from neuronx_distributed_llama3_2_tpu_torch.serving.server import _DONE

    class Dropping(server_cls):
        def _pump(self):
            for rid in list(self._streams):
                q, sent = self._streams[rid]
                toks = self.engine.request_tokens(rid)
                done = self.engine.request_info(rid)["done"]
                upto = len(toks) - 1 if done else len(toks)
                for t in toks[sent:upto]:
                    q.put_nowait(t)
                self._streams[rid] = (q, max(upto, sent))
                if done:
                    q.put_nowait(_DONE)
                    del self._streams[rid]

    return Dropping


def front_door(engine, prompts, server_cls=None) -> dict:
    """``prompts`` through a ``GraftServer`` over ``engine`` listening on
    ``serve_http("127.0.0.1", 0)``, from an in-process asyncio client:
    request j POSTs /v1/completions with ``"stream"`` for j < 4 (SSE) and
    without for the rest, class interactive / batch alternating, tenant
    alpha / beta in pairs; the ninth request (``door_prompt``) is submitted
    on the server and cancelled through POST /v1/requests/<rid>/cancel
    after its DOOR_CANCEL_AT-th token. Then /metrics and /snapshot. The
    engine's steady steps' uploads are recorded (a wrapper around its
    ``step``). Returns each request's streamed tokens (SSE) and final
    payload, the ninth's tokens, cancel answer and payload, the two
    scrapes, the steady uploads and K4's wrapper launches during the run."""
    from neuronx_distributed_llama3_2_tpu_torch.serving.server import GraftServer

    server_cls = server_cls or GraftServer
    steady = {"DECODE_DISPATCH", "READBACK", "AUDIT"}
    uploads = []
    inner = engine.step

    def step():
        before = engine.metrics.h2d_uploads
        alive = inner()
        actions = {a.type.value for a in engine.action_trace[-1][2]}
        if actions <= steady and "DECODE_DISPATCH" in actions:
            uploads.append(engine.metrics.h2d_uploads - before)
        return alive

    engine.step = step
    k4_before = k4_counts()

    async def main():
        srv = server_cls(engine, idle_poll_s=0.002)
        host, port = await srv.serve_http("127.0.0.1", 0)
        try:
            async def one(j):
                status, data = await http_call(host, port, "POST", "/v1/completions", dict(
                    prompt=prompts[j], stream=j < 4,
                    service_class=("interactive", "batch")[j % 2],
                    tenant=("alpha", "beta")[(j // 2) % 2]))
                check(status == 200, f"front door: request {j} answered {status}")
                if j >= 4:
                    return None, json.loads(data)
                text = data.decode()
                events = [json.loads(line[len("data: "):]) for line in text.split("\n\n")
                          if line.startswith("data: ") and line != "data: [DONE]"]
                check("data: [DONE]" in text, f"front door: request {j}'s stream has no end")
                return ([e["token"] for e in events if "token" in e],
                        [e for e in events if "choices" in e][-1])

            async def ninth():
                rid = srv.submit(door_prompt(), service_class="interactive", tenant="alpha")
                toks, answer = [], None
                async for t in srv.stream(rid):
                    toks.append(t)
                    if len(toks) == DOOR_CANCEL_AT:
                        status, data = await http_call(host, port, "POST",
                                                       f"/v1/requests/{rid}/cancel")
                        answer = (status, json.loads(data))
                return rid, toks, answer, srv.response(rid)

            results = await asyncio.gather(*(one(j) for j in range(len(prompts))), ninth())
            scrapes = {}
            for target in ("/metrics", "/snapshot"):
                status, data = await http_call(host, port, "GET", target)
                check(status == 200, f"front door: GET {target} answered {status}")
                scrapes[target] = data.decode()
            return results, scrapes
        finally:
            await srv.close()

    t0 = time.perf_counter()
    results, scrapes = asyncio.run(main())
    wall = time.perf_counter() - t0
    del engine.step  # the class's step again
    torch.cuda.synchronize()
    k4_during = {s: n - k4_before[s] for s, n in k4_counts().items()}
    *door, (rid9, toks9, answer9, payload9) = results
    return dict(streams=[d[0] for d in door], payloads=[d[1] for d in door], rid9=rid9,
                toks9=toks9, answer9=answer9, payload9=payload9, scrapes=scrapes,
                uploads=uploads, k4_during=k4_during, wall=wall)


def door_streams_differ(model, prompts, run: dict, want: list) -> list:
    """The requests whose streamed tokens (SSE) or payload token_ids are
    not ``want`` (in prompt order): a length that differs, or a first
    difference that is not a near tie (``same_streams`` fails on that)."""
    bad = []
    for kind, got in (("stream", run["streams"]),
                      ("payload", [p["choices"][0]["token_ids"] for p in run["payloads"]])):
        for j, toks in enumerate(got):
            if toks is not None and len(toks) != len(want[j]):
                bad.append((kind, j, len(toks)))
        picks = [j for j, t in enumerate(got) if t is not None and len(t) == len(want[j])]
        same_streams(f"front door {kind}s", model, [prompts[j] for j in picks],
                     [got[j] for j in picks], [want[j] for j in picks], picks)
    return bad


def parse_metrics(text: str) -> int:
    """The Prometheus text's samples, each ``name{labels} value`` with a
    float value; raises on a line that is neither that nor a comment."""
    n = 0
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        name, value = line.rsplit(" ", 1)
        float(value)
        check(bool(re.match(r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{.*\})?$", name)),
              f"front door: /metrics line {line!r}")
        n += 1
    return n


def door_ttft(run: dict) -> dict:
    """TTFT p50 (ms) by service class of the eight HTTP requests."""
    by = {}
    for p in run["payloads"]:
        by.setdefault(p["service_class"], []).append(p["timing"]["ttft_ms"])
    return {c: float(np.median(v)) for c, v in sorted(by.items())}


def run_front_door_phase(cfg, model, prompts, clean: list, card: str) -> None:
    """``GraftServer`` (serving/server.py) over Serve's prewarmed async
    twin with ``step_policy="slo"`` and both objectives (DOOR_SLO),
    listening on a loopback port (``front_door``). Each request's streamed
    tokens (SSE) and payload token_ids equal the async twin's batch run
    (``clean``, near-tie rule); the ninth request, cancelled after its
    DOOR_CANCEL_AT-th token, ends failed with error type ``cancelled``;
    /metrics and /snapshot parse, with active_streams 0;
    steadystate_compiles 0, no upload on a steady step, no K4 launch
    outside a replay; the audit is clean and nothing leaks. The planted
    fault (``last_token_dropped``) serves the same traffic on a twin of
    its own, and the stream check must fail on it. The same traffic under
    the FIFO policy (a twin of its own) gives the TTFT p50 by class beside
    the SLO policy's (logged, no limit). Each serve starts from a cold
    prefix cache: a second serve of the same prompts on one engine
    prefills them from the cache, another path in bf16."""
    from neuronx_distributed_llama3_2_tpu_torch.serving.scheduler import SloPolicy
    from neuronx_distributed_llama3_2_tpu_torch.serving.server import GraftServer

    ttft = {}
    for policy, planted in (("slo", False), ("slo", True), ("fifo", False)):
        t0 = time.perf_counter()
        engine = make_server(cfg, model, prewarm=True, async_loop=True, step_policy=policy,
                             **DOOR_SLO)
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
        check(isinstance(engine.policy, SloPolicy) == (policy == "slo"),
              f"front door: the {policy} twin runs {type(engine.policy).__name__}")
        if planted:
            run = front_door(engine, prompts, last_token_dropped(GraftServer))
            bad = door_streams_differ(model, prompts, run, clean)
            log(f"front door planted fault (each stream's last token dropped): differing "
                f"{bad}")
            check(bool(bad), "front door: the stream check passes a pump that drops the "
                  "last token")
            del engine, run
            gc.collect()
            torch.cuda.empty_cache()
            continue
        run = front_door(engine, prompts)
        m = engine.metrics
        bad = door_streams_differ(model, prompts, run, clean)
        check(not bad, f"front door {policy}: streams differ {bad}")
        info9 = engine.request_info(run["rid9"])
        p9 = run["payload9"]
        check(run["answer9"] == (200, {"rid": run["rid9"], "cancelled": True})
              and info9["status"] == "failed" and p9["error"]["type"] == "cancelled"
              and p9["choices"][0]["finish_reason"] == "cancelled"
              and DOOR_CANCEL_AT <= len(run["toks9"]) < MAX_NEW
              and p9["choices"][0]["token_ids"] == run["toks9"]
              and m.cancelled_requests == 1 and m.finished == len(prompts),
              f"front door {policy}: the cancelled request {info9}, answer {run['answer9']}, "
              f"{len(run['toks9'])} tokens streamed, finished {m.finished}")
        samples = parse_metrics(run["scrapes"]["/metrics"])
        snap = json.loads(run["scrapes"]["/snapshot"])
        check(snap["active_streams"] == 0 and m.active_streams == 0
              and snap["finished"] == len(prompts) and samples > 0,
              f"front door {policy}: snapshot active_streams {snap['active_streams']}, "
              f"finished {snap['finished']}, {samples} metric samples")
        check(m.steadystate_compiles == 0 and not any(run["k4_during"].values())
              and run["uploads"] and not any(run["uploads"]),
              f"front door {policy}: steadystate_compiles {m.steadystate_compiles}, K4 "
              f"outside a replay {run['k4_during']}, steady uploads {run['uploads']}")
        check_clean_engine(f"front door {policy}", engine)
        ttft[policy] = door_ttft(run)
        log(f"front door {policy}: GraftServer over Serve's prewarmed async twin "
            f"(step_policy={policy}, {DOOR_SLO}; {m.prewarm_compiles} graphs in "
            f"{capture_s:.6f} s) on a loopback port: {len(prompts)} requests (4 SSE, 4 "
            f"plain) in {run['wall']:.6f} s, streams and payloads equal to the async "
            f"twin's batch run; request 9 cancelled after {len(run['toks9'])} tokens "
            f"({p9['error']}); /metrics {samples} samples, /snapshot active_streams "
            f"{snap['active_streams']}, slo_alerts {snap['slo_alerts']}, slo_burn_ttft "
            f"{snap['slo_burn_ttft']}, slo_burn_tpot {snap['slo_burn_tpot']}; "
            f"{len(run['uploads'])} steady steps, uploads a steady step "
            f"{max(run['uploads'])}; steadystate_compiles {m.steadystate_compiles}; TTFT "
            f"p50 by class {ttft[policy]} ms | {card}")
        del engine, run
        gc.collect()
        torch.cuda.empty_cache()
    log(f"front door: TTFT p50 by class, slo {ttft['slo']} against fifo {ttft['fifo']} ms "
        f"(the same traffic, each on a twin of its own) | {card}")


# -- 4h. tiered KV storage (host-RAM spill and restore) ---------------------------

#: the spill serves' pool of 16-row blocks, cut so that the fillers'
#: admissions evict every block of the shared prefix (the seed's cached
#: blocks are the oldest in the LRU) and preempt no lane: the churn spills
#: all 16 prefix blocks on 128 blocks and fewer (15 on 129), and preempts
#: a lane on 123; 125 keeps three blocks from each edge
SPILL_BLOCKS = 125
SPILL_KNOBS = dict(num_blocks=SPILL_BLOCKS, spill_enabled=True, host_tier_bytes=1 << 30,
                   restore_crossover=1e9)
#: the blocks of the 256-token shared prefix, all of which must come back
PREFIX_BLOCKS = 16
#: the index of the first re-hit in spill_prompts
REHIT = 7


def spill_prompts():
    """The spill serves' requests, from Serve's prompts: the seed (prompt 3,
    the 256-token shared prefix and 5 more tokens), the six prompts that
    share nothing (the fillers), and two re-hits of the prefix with other
    tails (prompt 4's 8 tokens, and 11 fresh ones)."""
    prompts = serve_prompts()
    rng = np.random.default_rng(SEED + 16)
    rehit = prompts[3][:256] + rng.integers(0, 128256, size=11).tolist()
    return [prompts[3]] + [prompts[j] for j in (0, 1, 2, 5, 6, 7)] + [prompts[4], rehit]


def serve_churn(server, prompts, before_rehits=None):
    """The seed alone, then the fillers, then the two re-hits, each wave
    run to completion; ``before_rehits`` is called just before the re-hits
    are submitted. Returns (rids in prompt order, outputs by rid)."""
    rids = []
    for wave in (prompts[:1], prompts[1:REHIT], prompts[REHIT:]):
        if len(rids) == REHIT and before_rehits is not None:
            before_rehits()
        rids += [server.submit(p) for p in wave]
        outs = server.run_to_completion()
    return rids, outs


def spill_spy(server) -> dict:
    """Keep a copy, on the card, of every block the server spills (taken
    just before its own snapshot, at the same point of the stream) and, at
    each restore, compare the restored pool block bit for bit with the copy
    of the block that was spilled, on the card, right after the restore's
    writes and before any later one (no sync inside the serve:
    ``spill_tally`` reads the verdicts after it). Returns the tally:
    {"copies": sid -> tensors, "verdicts": [bool tensors]}."""
    tally = dict(copies={}, verdicts=[])
    hook, restore = server.allocator.spill_hook, server._restore_block

    def on_spill(bid):
        copy = tuple(x[:, bid].clone() for x in server._pool_tensors())
        sid = server.host_tier._next_sid
        moved = hook(bid)
        if moved:
            tally["copies"][sid] = copy
        return moved

    def on_restore(sid, nb, payload):
        restore(sid, nb, payload)
        want = tally["copies"].pop(sid)
        tally["verdicts"].append(torch.stack([
            (x[:, nb].contiguous().view(torch.uint8) == w.view(torch.uint8)).all()
            for x, w in zip(server._pool_tensors(), want)]).all())

    server.allocator.spill_hook = on_spill
    server._restore_block = on_restore
    return tally


def spill_tally(tally: dict) -> dict:
    """The spy's verdicts, read after the serve: restored blocks, and those
    bitwise equal to their spilled copies."""
    verdicts = [bool(v) for v in tally["verdicts"]]
    tally["copies"].clear()
    return dict(restored=len(verdicts), equal=sum(verdicts))


def restore_breakdown(server) -> dict:
    """Host-clock ms inside the admissions that restored (``_maybe_restore``
    calls that added a restore hit), split by what they ran: the drain of
    the queued snapshots, the snapshots of the blocks that the restore's
    own allocations evicted (``spill_ms``, with the pinned buffers they
    took fresh and reused) and the uploads into the pool (``upload_ms``).
    Wraps the server's methods, a clock read each; no device sync."""
    acc = dict(restores=0, total_ms=0.0, drain_ms=0.0, spill_ms=0.0, upload_ms=0.0,
               pinned_fresh=0, pinned_reused=0)
    cur: dict = {}

    def clocked(name, fn):
        def run(*args):
            if name not in cur:
                return fn(*args)
            t0 = time.perf_counter()
            try:
                return fn(*args)
            finally:
                cur[name] += (time.perf_counter() - t0) * 1e3
        return run

    server._drain_spills = clocked("drain_ms", server._drain_spills)
    server.allocator.spill_hook = clocked("spill_ms", server.allocator.spill_hook)
    server._restore_block = clocked("upload_ms", server._restore_block)
    take = server._pinned_take

    def counted_take(like):
        if cur:
            fresh = not server._pinned_free.get((tuple(like.shape), like.dtype))
            cur["pinned_fresh" if fresh else "pinned_reused"] += 1
        return take(like)

    server._pinned_take = counted_take
    admit = server._maybe_restore

    def on_admit(*args):
        hits = server.metrics.restore_hits
        cur.update({k: 0 for k in acc if k not in ("restores", "total_ms")})
        t0 = time.perf_counter()
        try:
            return admit(*args)
        finally:
            total = (time.perf_counter() - t0) * 1e3
            if server.metrics.restore_hits > hits:
                acc["restores"] += 1
                acc["total_ms"] += total
                for k, v in cur.items():
                    acc[k] += v
            cur.clear()

    server._maybe_restore = on_admit
    return acc


def restore_v_into_k(server) -> None:
    """A planted restore fault: V's payload written into K as well."""
    restore = server._restore_block
    server._restore_block = lambda sid, nb, p: restore(sid, nb, (p[1], p[1]) + tuple(p[2:]))


def restore_keeps_scales(server) -> None:
    """A planted restore fault: the payloads restored, the fresh block's
    scale tiles left as they were."""
    restore = server._restore_block
    server._restore_block = lambda sid, nb, p: restore(sid, nb, tuple(p[:2]))


def churn_serve(cfg, model, label: str, spy: bool = True, fault=None, breakdown=False,
                **knobs) -> dict:
    """The churn (``serve_churn``) on a server built with ``knobs``: every
    request finishes with MAX_NEW tokens, the audit is clean and nothing
    leaks. With spill on, ``spill_spy`` holds each restore's bits (unless
    ``spy`` is off) and each restore's price is recorded; ``fault`` plants
    a restore fault; ``breakdown`` clocks the restores'
    parts (``restore_breakdown``). K4's launch counters (all, t1, tile) are
    read at the construction's end, before the re-hits and at the serve's
    end: returns them with the streams, the first re-hit's TTFT and the
    spill counters."""
    from neuronx_distributed_llama3_2_tpu_torch.kernels import paged_attention as pa
    from neuronx_distributed_llama3_2_tpu_torch.serving.invariants import audit_engine

    prompts = spill_prompts()
    k4 = (pa.launches, pa.t1_launches, pa.tile_launches)
    for c in k4:
        c.reset()
    server = make_server(cfg, model, **knobs)
    built, built_t1, built_tile = (c.count for c in k4)
    tally = spill_spy(server) if server._spill and spy else None
    parts = restore_breakdown(server) if breakdown else None
    if fault is not None:
        fault(server)
    prices = []
    price = server._restore_price
    server._restore_price = lambda n, g: prices.append(price(n, g)) or prices[-1]
    waits = []
    drain = server._drain_spills

    def timed_drain():
        t0 = time.perf_counter()
        drain()
        waits.append(time.perf_counter() - t0)

    server._drain_spills = timed_drain
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    marks = []
    rids, outs = serve_churn(server, prompts, lambda: marks.extend(c.count for c in k4[1:]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    m = server.metrics
    infos = [server.request_info(r) for r in rids]
    for r, info in zip(rids, infos):
        check(info["status"] == "finished" and len(outs[r]) == MAX_NEW,
              f"spill {label}: request {r} is {info['status']} with {len(outs[r])} tokens")
    violations, leaks = audit_engine(server), server.allocator.leak_check()
    check(not violations and not leaks and not server._spill_pending,
          f"spill {label}: audit {violations}, leaks {leaks}")
    # under trace_enabled, the admission's restore span and the first
    # re-hit's prefill span (ms)
    spans = [(e["name"], e["dur"] / 1e3, e["args"].get("rid"))
             for e in server.tracer.chrome_events() if e.get("ph") == "X"]
    restore_ms = sum(d for n, d, _ in spans if n == "restore")
    rehit_prefill_ms = sum(d for n, d, rid in spans if n == "prefill" and rid == rids[REHIT])
    out = dict(
        label=label, prompts=prompts, rids=rids, outs=[outs[r] for r in rids], wall=wall,
        restore_ms=restore_ms, rehit_prefill_ms=rehit_prefill_ms,
        rehit_ttft=infos[REHIT]["ttft_ms"], rehit_cached=infos[REHIT]["cached_tokens"],
        tally=None if tally is None else spill_tally(tally), prices=prices,
        drain_s=sum(waits), built=built, built_t1=built_t1, built_tile=built_tile,
        serve_launches=pa.launches.count - built, rehit_t1=pa.t1_launches.count - marks[0],
        rehit_tile=pa.tile_launches.count - marks[1], parts=parts, wait_ms=m.device_wait_ms,
        **{c: getattr(m, c) for c in (
            "blocks_spilled", "blocks_restored", "restore_hits", "restore_bytes",
            "restore_declined", "restore_fallbacks", "restore_uploads", "spill_bytes",
            "preemptions", "steadystate_compiles", "decode_steps_async")},
        evictions=server.allocator.evictions,
    )
    log(f"spill {label}: {len(rids)} requests in {wall:.6f} s; the first re-hit's TTFT "
        f"{out['rehit_ttft']:.6f} ms, cached_tokens {out['rehit_cached']}; blocks_spilled "
        f"{m.blocks_spilled}, blocks_restored {m.blocks_restored}, restore_hits "
        f"{m.restore_hits}, restore_declined {m.restore_declined}, restore_fallbacks "
        f"{m.restore_fallbacks}, restore_bytes {m.restore_bytes}, spill_bytes "
        f"{m.spill_bytes}, restore_uploads {m.restore_uploads}; evictions "
        f"{server.allocator.evictions}, preemptions {m.preemptions}; device_wait_ms "
        f"{m.device_wait_ms:.6f}, spill drains {sum(waits) * 1e3:.6f} ms; K4 launches "
        f"captured {built} (t1 {built_t1}, tile {built_tile}), in the re-hit wave t1 "
        f"{out['rehit_t1']}, tile {out['rehit_tile']}"
        + ("" if parts is None else "; the restores ({restores}) on the host clock "
           "{total_ms:.6f} ms: drain {drain_ms:.6f}, eviction snapshots {spill_ms:.6f} "
           "(pinned buffers fresh {pinned_fresh}, reused {pinned_reused}), uploads "
           "{upload_ms:.6f}".format(**parts))
        + (f"; traced: the restore {restore_ms:.6f} ms, the first re-hit's prefill "
           f"{rehit_prefill_ms:.6f} ms" if server.tracer.enabled else "")
        + (f"; restored blocks bitwise equal to their spilled copies {out['tally']['equal']} "
           f"of {out['tally']['restored']}" if tally is not None else ""))
    del server
    gc.collect()
    torch.cuda.empty_cache()
    return out


def check_restored(res: dict) -> None:
    """Every block of the shared prefix spilled and came back, bit for
    bit where the spy watched, through one restore, and no restore fell
    back; K4's t1 and tile sources read the restored blocks: launched in
    the re-hit wave by an eager serve, captured by a prewarmed one (whose
    serve launches K4 only from replays)."""
    label = res["label"]
    check(res["blocks_spilled"] >= PREFIX_BLOCKS and res["restore_hits"] >= 1
          and res["blocks_restored"] >= PREFIX_BLOCKS and res["restore_fallbacks"] == 0,
          f"spill {label}: spilled {res['blocks_spilled']}, restore_hits "
          f"{res['restore_hits']}, restored {res['blocks_restored']}, fallbacks "
          f"{res['restore_fallbacks']}")
    t = res["tally"]
    if t is not None:
        check(t["restored"] == res["blocks_restored"] == t["equal"],
              f"spill {label}: {t['equal']} of {t['restored']} restored blocks hold their bits")
    t1, tile = ((res["built_t1"], res["built_tile"]) if res["built"]
                else (res["rehit_t1"], res["rehit_tile"]))
    check(t1 > 0 and tile > 0, f"spill {label}: K4 t1 {t1}, tile {tile} launches "
          f"{'captured' if res['built'] else 'in the re-hit wave'}")
    check(res["rehit_cached"] >= 256, f"spill {label}: the re-hit cached {res['rehit_cached']}")
    check(res["preemptions"] == 0, f"spill {label}: {res['preemptions']} preemptions")


def host_link_ms(cfg, iters: int = 50):
    """The engine's own copies of one 1B pool block (16 rows, bf16), timed
    with CUDA events over ``iters`` rounds: the spill's snapshot (a clone of
    the block's K and V on the card, copied into pinned host memory without
    blocking) and the restore's (each pinned tensor uploaded and copied
    into the block in place). Returns (bytes a block, D2H ms, H2D ms, ms of
    one pinned allocation of K's half of a block)."""
    shape = (cfg.num_layers, 64, 16, cfg.num_kv_heads, cfg.head_dim)
    pool = [torch.randn(shape, device="cuda").to(torch.bfloat16) for _ in range(2)]
    host = [torch.empty(x[:, 1].shape, dtype=x.dtype, pin_memory=True) for x in pool]

    def d2h():
        for h, x in zip(host, pool):
            h.copy_(x[:, 1].clone(), non_blocking=True)

    def h2d():
        for h, x in zip(host, pool):
            x[:, 2].copy_(h.to(x.device, non_blocking=True))

    # a spill with no dropped payload's buffers to reuse pins fresh memory
    # (the host tier holds the earlier ones): 32 such allocations, held,
    # on the host's clock
    t0 = time.perf_counter()
    held = [torch.empty(host[0].shape, dtype=host[0].dtype, pin_memory=True) for _ in range(32)]
    alloc_ms = (time.perf_counter() - t0) * 1e3 / len(held)
    del held
    times = []
    for fn in (d2h, h2d):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    check(torch.equal(pool[0][:, 1], pool[0][:, 2]), "host link: the block did not come back")
    return sum(h.nbytes for h in host), times[0], times[1], alloc_ms


def run_spill_phase(cfg, model, card: str) -> None:
    """Tiered KV storage at full width: Serve's prompts as a churn
    (``spill_prompts``), the serves below, each on a fresh server.

    (a) spill: SPILL_BLOCKS blocks, spill on, every restore priced in; (b)
    resident: Serve's 2049-block pool, where the prefix never leaves; (c)
    re-prefill: (a)'s pool with spill off; (d) int8: (a) with Q1's knobs,
    the scale tiles spilled and restored with the payloads, beside (d0),
    Q1's knobs on the resident pool; (e) the prewarmed async twin of (a),
    whose graphs read the restored blocks, beside (e0), the same twin with
    spill off (device_wait_ms with and without the drains); (f) priced:
    (a) at restore_crossover 1.0, the port's restore rate and the H100's
    peak deciding. (a), (d), (e) must spill and restore every prefix block
    bit for bit, and K4's t1 and tile sources must read the restored
    blocks; their streams equal (b)'s or (d0)'s, or first differ at a near
    tie (then within the e2e margin); (c) within Serve's e2e margin; (e)
    captures nothing after the freeze and launches K4 only from replays.
    (The restores unwatched, each restore's parts on the host clock, are
    ``chip_trials/spill_restore_trial.py``'s: this phase's timing depth was
    cut for the cp phase's time.) Planted faults: a
    restore writing V's payload into K (bf16) and one leaving the fresh
    block's scale tiles as they were (int8) must read above their margins
    on the re-hits. Logs the host link's per-block rates and the restore
    path's effective rate."""
    from neuronx_distributed_llama3_2_tpu_torch.serving.accounting import (
        HOST_LINK_BW_BYTES_PER_S,
    )

    q1 = dict(kv_cache_dtype="int8", prefill_chunk_tokens=QUANT_CHUNK)
    nbytes, d2h, h2d, alloc_ms = host_link_ms(cfg)
    log(f"spill: host link, one 1B block ({nbytes} bytes, K and V): pinned D2H snapshot "
        f"{d2h:.6f} ms = {nbytes / d2h / 1e6:.6f} GB/s, H2D restore {h2d:.6f} ms = "
        f"{nbytes / h2d / 1e6:.6f} GB/s (CUDA events, 50 rounds); one fresh pinned "
        f"allocation of {nbytes // 2} bytes {alloc_ms:.6f} ms (host clock, 32 held) | {card}")
    b = churn_serve(cfg, model, "(b) resident")
    a = churn_serve(cfg, model, "(a) spill", trace_enabled=True, **SPILL_KNOBS)
    check_restored(a)
    prompts, rids = a["prompts"], a["rids"]
    gaps = lambda o, r, picks=None: e2e_gaps(model, prompts, dict(zip(r, o)), r, picks)[0]
    differ = same_streams("spill (a)", model, prompts, a["outs"], b["outs"], rids)
    if differ:
        check(gaps(a["outs"], rids) <= E2E_LOGIT_MARGIN, "spill (a): e2e gap past the margin")
    c = churn_serve(cfg, model, "(c) re-prefill", num_blocks=SPILL_BLOCKS, trace_enabled=True)
    check(c["evictions"] >= PREFIX_BLOCKS and c["blocks_spilled"] == 0,
          f"spill (c): evictions {c['evictions']}")
    c_gap = gaps(c["outs"], c["rids"])
    check(c_gap <= E2E_LOGIT_MARGIN, f"spill (c): a token {c_gap} below the argmax")
    d0 = churn_serve(cfg, model, "(d0) Q1 resident", **q1)
    d = churn_serve(cfg, model, "(d) Q1 spill", **SPILL_KNOBS, **q1)
    check_restored(d)
    d_differ = same_streams("spill (d)", model, prompts, d["outs"], d0["outs"], rids)
    if d_differ:
        gap = quant_e2e_gaps(cfg, model, "int8", prompts, dict(zip(rids, d["outs"])), rids)[0]
        check(gap <= QUANT_LOGIT_MARGIN["int8"], f"spill (d): e2e gap {gap}")
    twin = dict(SPILL_KNOBS, prewarm=True, async_loop=True)
    e = churn_serve(cfg, model, "(e) prewarmed async twin", **twin)
    check_restored(e)
    check(e["steadystate_compiles"] == 0 and e["serve_launches"] == 0 and e["built"] > 0
          and e["decode_steps_async"] > 0,
          f"spill (e): steadystate_compiles {e['steadystate_compiles']}, K4 launches in the "
          f"serve {e['serve_launches']}, captured {e['built']}, async steps "
          f"{e['decode_steps_async']}")
    e_differ = same_streams("spill (e)", model, prompts, e["outs"], b["outs"], rids)
    if e_differ:
        check(gaps(e["outs"], rids) <= E2E_LOGIT_MARGIN, "spill (e): e2e gap past the margin")
    e0 = churn_serve(cfg, model, "(e0) prewarmed async twin, spill off",
                     **dict(twin, spill_enabled=False, host_tier_bytes=0,
                            restore_crossover=1.0))
    f = churn_serve(cfg, model, "(f) priced", spy=False,
                    **dict(SPILL_KNOBS, restore_crossover=1.0))
    check(len(f["prices"]) >= 1, f"spill (f): no spilled run was priced {f['prices']}")
    (restore_s, recompute_s), decided = f["prices"][0], (
        "restore" if f["restore_hits"] else "re-prefill")
    check(decided == ("restore" if restore_s <= recompute_s else "re-prefill"),
          f"spill (f): decided {decided} at {f['prices']}")
    # the planted faults, each read on the re-hits
    picks = [REHIT, REHIT + 1]
    fa = churn_serve(cfg, model, "planted fault: V's payload restored into K", spy=False,
                     fault=restore_v_into_k, **SPILL_KNOBS)
    fa_gap = gaps(fa["outs"], fa["rids"], picks)
    fd = churn_serve(cfg, model, "planted fault: scale tiles left as they were", spy=False,
                     fault=restore_keeps_scales, **SPILL_KNOBS, **q1)
    fd_gap = quant_e2e_gaps(cfg, model, "int8", [prompts[j] for j in picks],
                            dict(zip(fd["rids"], fd["outs"])),
                            [fd["rids"][j] for j in picks])[0]
    check(fa["restore_hits"] >= 1 and fd["restore_hits"] >= 1, "spill faults: no restore")
    log(f"spill: streams equal to the resident serve's: (a) {len(rids) - len(differ)}, (e) "
        f"{len(rids) - len(e_differ)} of {len(rids)}; (d) {len(rids) - len(d_differ)} of "
        f"{len(rids)} against Q1's resident serve; (c) worst e2e gap {c_gap:.6g} (margin "
        f"{E2E_LOGIT_MARGIN}); the first re-hit's TTFT (a) {a['rehit_ttft']:.6f} ms, (c) "
        f"{c['rehit_ttft']:.6f} ms, (d) {d['rehit_ttft']:.6f}, (e) {e['rehit_ttft']:.6f} ms | "
        f"{card}")
    log(f"spill: the async twin's device_wait_ms {e['wait_ms']:.6f} with spill (its drains "
        f"{e['drain_s'] * 1e3:.6f} ms, {e['blocks_spilled']} blocks) against "
        f"{e0['wait_ms']:.6f} without, wall {e['wall']:.6f} against {e0['wall']:.6f} s | {card}")
    log(f"spill (f): restore_crossover 1.0 priced the first spilled run at restore_s "
        f"{restore_s:.9f} s against recompute_s {recompute_s:.9f} s (restore rate "
        f"{HOST_LINK_BW_BYTES_PER_S:.6g} B/s, 989 TFLOP/s): {decided}; every priced run {f['prices']}; "
        f"restore_hits {f['restore_hits']}, restore_declined {f['restore_declined']} | {card}")
    log(f"spill planted faults on the re-hits: V's payload into K reads {fa_gap:.6g} "
        f"(margin {E2E_LOGIT_MARGIN}); the scale tiles left as they were read {fd_gap:.6g} "
        f"(margin {QUANT_LOGIT_MARGIN['int8']})")
    check(fa_gap > E2E_LOGIT_MARGIN, f"the spill check passes V's payload in K ({fa_gap})")
    check(fd_gap > QUANT_LOGIT_MARGIN["int8"],
          f"the spill check passes stale scale tiles ({fd_gap})")


# -- 5. train -------------------------------------------------------------------

TRAIN_BATCH, TRAIN_SEQ = 12, 2048
TIMED_STEPS = 3
E2E_BATCH = 2
# launches of (K1, K2, K3) in one train step of the 16-layer model under
# remat "full": each layer's forward runs K1 once and its recompute once
# more in the backward, which runs K2 and K3 once
STEP_LAUNCHES = (32, 16, 16)
# end-to-end train check, kernels vs the plain attention path on the same
# weights and batch (2 x 2048), both bf16 through 16 layers: |loss
# difference| and the largest per-parameter relative L2 error of the
# gradients. The plain path rounds its scores to bf16 before the softmax
# and the kernels do not, so the two differ by more than summation order.
# On an H100 the sound step reads a loss gap of 0.00064 and a gradient
# error of 0.0296 (a layer-13 q projection), a planted K3 fault (skipping
# the diagonal kv tile of every causal backward) 0.689; the bands are
# about twice the sound readings, and run_train_e2e_phase fails unless the
# fault reads above the gradient band
LOSS_BAND = 0.00125
GRAD_BAND = 0.06


def train_configs():
    """bench.py's training configuration (bench.py:51-76), for the port:
    (model config, TrainingConfig)."""
    from neuronx_distributed_llama3_2_tpu_torch.models.llama import LLAMA_CONFIGS
    from neuronx_distributed_llama3_2_tpu_torch.trainer import (
        OptimizerConfig,
        TrainingConfig,
    )

    cfg = dataclasses.replace(
        LLAMA_CONFIGS["llama3.2-1b"], remat="full", max_seq_len=TRAIN_SEQ,
        use_flash_attention=True, flash_block_q=1024, flash_block_kv=1024,
        loss_chunk_size=256,
    )
    tc = TrainingConfig(optimizer=OptimizerConfig(
        zero_one_enabled=False, warmup_steps=1, use_master_weights=False,
        use_fp32_grad_acc=False, state_dtype="bfloat16",
    ))
    return cfg, tc


def train_batch(cfg, batch: int):
    """bench.py's batch: token ids from np.random.default_rng(0), labels =
    ids."""
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ))
    ids = torch.as_tensor(ids[:batch], device="cuda")
    return {"input_ids": ids, "labels": ids}


def flash_counts():
    from neuronx_distributed_llama3_2_tpu_torch.kernels import flash_attention as fa

    return (fa.fwd_launches.count, fa.bwd_dq_launches.count, fa.bwd_dkv_launches.count)


def run_train_phase(card: str):
    """Warm-up step, then TIMED_STEPS timed steps on bench's repeated
    batch, the flash launch counters zeroed after the warm-up. Returns
    (model, state, step, batch, (K1, K2, K3) launches over the timed
    steps)."""
    from neuronx_distributed_llama3_2_tpu_torch import flops
    from neuronx_distributed_llama3_2_tpu_torch.kernels import flash_attention as fa
    from neuronx_distributed_llama3_2_tpu_torch.models.llama import LlamaForCausalLM
    from neuronx_distributed_llama3_2_tpu_torch.trainer import (
        initialize_parallel_model,
        make_train_step,
    )

    cfg, tc = train_configs()
    tc.initialize("cuda")
    model = LlamaForCausalLM(cfg, device="cuda")
    state, _ = initialize_parallel_model(model, tc, key=SEED)
    step = make_train_step(model, tc)
    batch = train_batch(cfg, TRAIN_BATCH)
    n_params = sum(p.numel() for p in state.params.values())
    log(f"train: llama3.2-1b, {cfg.num_layers} layers, hidden {cfg.hidden_size}, "
        f"{n_params} parameters, bf16, seeded random weights; batch {TRAIN_BATCH} x "
        f"{TRAIN_SEQ}, remat {cfg.remat}, flash attention, loss chunk "
        f"{cfg.loss_chunk_size}, AdamW bf16 state, no master weights")

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, m = step(state, batch)
    losses = [float(m["loss"])]
    log(f"train: warm-up step {1e3 * (time.perf_counter() - t0):.6f} ms, loss "
        f"{losses[0]:.6f}, grad_norm {float(m['grad_norm']):.6f}")
    for c in (fa.fwd_launches, fa.bwd_dq_launches, fa.bwd_dkv_launches):
        c.reset()
    step_ms = []
    prev = flash_counts()
    for i in range(TIMED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        losses.append(float(m["loss"]))  # synchronizes
        step_ms.append(1e3 * (time.perf_counter() - t0))
        now = flash_counts()
        per_step = tuple(a - b for a, b in zip(now, prev))
        prev = now
        check(per_step == STEP_LAUNCHES,
              f"train step {i}: (K1, K2, K3) launches {per_step}, expected {STEP_LAUNCHES}")
        log(f"train: step {i} {step_ms[-1]:.6f} ms, loss {losses[-1]:.6f}, grad_norm "
            f"{float(m['grad_norm']):.6f}, lr {m['learning_rate']:.6g}, (K1, K2, K3) "
            f"launches {per_step} | {card}")
    launches = flash_counts()
    check(all(np.isfinite(losses)), f"non-finite train loss: {losses}")
    check(losses[-1] < losses[0], f"train loss did not fall: {losses}")
    med_ms = float(np.median(step_ms))
    tps = TRAIN_BATCH * TRAIN_SEQ / (med_ms / 1e3)
    util = flops.mfu(tps, n_params, cfg.num_layers, cfg.hidden_size, TRAIN_SEQ)
    log(f"train: median step {med_ms:.6f} ms = {tps:.6f} tokens/s, MFU {100 * util:.6f}% "
        f"of {flops.H100_BF16_FLOPS_PER_S:.4g} FLOP/s bf16; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.6f} GiB; losses {losses} | {card}")
    return model, state, step, batch, launches


def diagonal_tile_part(q, k, v, do, lse, delta, sm_scale, tile=64):
    """The share of causal dk and dv that each kv tile of ``tile`` rows
    receives from the q tile on its diagonal, in the kernels' arithmetic
    (for the planted fault: a K3 that skips that tile)."""
    b, n, s, d = q.shape
    nkv = k.shape[1]
    g, nt = n // nkv, s // tile
    qt = q.float().reshape(b, nkv, g, nt, tile, d)
    dot = do.float().reshape(b, nkv, g, nt, tile, d)
    kt = k.float().reshape(b, nkv, nt, tile, d)
    vt = v.float().reshape(b, nkv, nt, tile, d)
    sc = torch.einsum("bkgtid,bktjd->bkgtij", qt, kt) * sm_scale
    causal = torch.ones(tile, tile, dtype=torch.bool, device=q.device).tril()
    p = torch.where(causal, torch.exp(sc - lse.reshape(b, nkv, g, nt, tile)[..., None]), 0.0)
    dp = torch.einsum("bkgtid,bktjd->bkgtij", dot, vt)
    ds = (p * (dp - delta.reshape(b, nkv, g, nt, tile)[..., None])).to(k.dtype).float()
    dv = torch.einsum("bkgtij,bkgtid->bktjd", p.to(v.dtype).float(), dot)
    dk = sm_scale * torch.einsum("bkgtij,bkgtid->bktjd", ds, qt)
    return dk.reshape(b, nkv, s, d), dv.reshape(b, nkv, s, d)


@contextlib.contextmanager
def k3_skips_diagonal():
    """Plant a fault in K3 while the block runs: every causal backward
    returns dk and dv without their diagonal-tile share."""
    from neuronx_distributed_llama3_2_tpu_torch.kernels import flash_attention as fa

    inner = fa._launch_bwd

    def faulty(q, k, v, do, lse, delta, segment_ids, causal, sm_scale):
        dq, dk, dv = inner(q, k, v, do, lse, delta, segment_ids, causal, sm_scale)
        if causal:
            dk_diag, dv_diag = diagonal_tile_part(
                q.contiguous(), k.contiguous(), v.contiguous(), do.contiguous(),
                lse, delta, sm_scale,
            )
            dk = (dk.float() - dk_diag).to(dk.dtype)
            dv = (dv.float() - dv_diag).to(dv.dtype)
        return dq, dk, dv

    fa._launch_bwd = faulty
    try:
        yield
    finally:
        fa._launch_bwd = inner


def loss_and_grads(model, batch):
    params = dict(model.named_parameters())
    loss = model.loss(batch["input_ids"], batch["labels"])
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.detach().item(), dict(zip(params, grads))


#: leaves whose gradient is 0 in exact arithmetic, left out of
#: ``grad_gap``: the k projection's bias (the GPT-NeoX family's and
#: BERT's) shifts every key of a query's softmax alike, which it does not
#: see; its computed gradient is rounding noise of either path
ZERO_GRAD_LEAVES = ("attn.qkv.k_bias",)


def grad_gap(grads, ref):
    """Largest per-parameter relative L2 error, and the parameter
    (ZERO_GRAD_LEAVES left out)."""
    worst, at = 0.0, ""
    for k, g in grads.items():
        if k.endswith(ZERO_GRAD_LEAVES):
            continue
        r = ref[k].float()
        err = ((g.float() - r).norm() / r.norm().clamp_min(1e-30)).item()
        if err > worst:
            worst, at = err, k
    return worst, at


def run_train_e2e_phase(model, card: str) -> None:
    """One step's loss and gradients through the kernels against the same
    step through ``core_attention`` (use_flash_attention=False): same
    weights, bench's batch cut to E2E_BATCH rows, full width and depth.
    Then the same comparison through a planted K3 fault, which must read
    above GRAD_BAND."""
    from neuronx_distributed_llama3_2_tpu_torch.models.llama import LlamaForCausalLM

    cfg = model.config
    plain = LlamaForCausalLM(dataclasses.replace(cfg, use_flash_attention=False), device="cuda")
    plain.load_state_dict(model.state_dict())
    batch = train_batch(cfg, E2E_BATCH)
    ref_loss, ref_grads = loss_and_grads(plain, batch)
    del plain
    loss, grads = loss_and_grads(model, batch)
    loss_gap = abs(loss - ref_loss)
    gap, at = grad_gap(grads, ref_grads)
    log(f"train e2e: loss {loss:.6f} through the kernels vs {ref_loss:.6f} plain "
        f"(gap {loss_gap:.6g}, band {LOSS_BAND}); largest gradient relative L2 "
        f"error {gap:.6g} at {at} (band {GRAD_BAND}) | {card}")
    check(np.isfinite(loss) and loss_gap <= LOSS_BAND, f"train loss gap {loss_gap}")
    check(gap <= GRAD_BAND, f"train gradient gap {gap} at {at}")
    del grads
    with k3_skips_diagonal():
        _, bad_grads = loss_and_grads(model, batch)
    bad_gap, bad_at = grad_gap(bad_grads, ref_grads)
    log(f"train e2e planted fault (K3 skips the diagonal kv tile): largest gradient "
        f"relative L2 error {bad_gap:.6g} at {bad_at} (band {GRAD_BAND})")
    check(bad_gap > GRAD_BAND, f"the train e2e check passes a planted K3 fault ({bad_gap})")


def run_train_profile_phase(state, step, batch, card: str) -> None:
    """One more train step under torch.profiler: the card's busy share of
    its wall time and the kernels that took it."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        float(m["loss"])
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = sorted(prof.key_averages(), key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    flash_ms = sum(e.self_device_time_total for e in events if "flash_" in e.key) / 1e3
    log(f"profile: train step wall {wall_ms:.6f} ms (profiler on), device busy "
        f"{busy_ms:.6f} ms = {100 * busy_ms / wall_ms:.6f}% of it; flash kernels "
        f"{flash_ms:.6f} ms = {100 * flash_ms / busy_ms:.6f}% of device time | {card}")
    # device time by kind of kernel, first matching name fragment wins
    kinds = (("flash kernels", ("flash_",)), ("GEMMs", ("nvjet", "gemm", "cutlass", "xmma")),
             ("copies and casts", ("copy",)), ("reductions", ("reduce",)),
             ("other elementwise", ("elementwise",)))
    by_kind: dict = {}
    for e in events:
        kind = next((k for k, frags in kinds if any(f in e.key for f in frags)), "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + e.self_device_time_total / 1e3
    log("profile: train step device time by kind: " + "; ".join(
        f"{k} {ms:.6f} ms ({100 * ms / busy_ms:.6f}%)"
        for k, ms in sorted(by_kind.items(), key=lambda kv: -kv[1])))
    for e in events[:15]:
        log(f"  device {e.self_device_time_total / 1e3:.6f} ms, {e.count} calls: {e.key[:100]}")


# -- 5b. remat, pretrain and resume, the trained serve ----------------------------

REMAT_POLICIES = ("full", "none", "selective", "dots", "hybrid", "kv")
REMAT_BATCH = 2
REMAT_TIMED = 3


def run_remat_phase(card: str) -> None:
    """One step's loss and gradients (forward and backward, no optimizer)
    of the 1B at full width and depth, flash attention on, batch
    REMAT_BATCH x 2048, from the same weights and batch under each of the
    six remat policies: the loss within LOSS_BAND and every gradient
    within GRAD_BAND (largest per-parameter relative L2) of "full"'s, and
    (K1, K2, K3) launched (FLASH_FWD_PER_LAYER x layers, layers, layers)
    times in each step. Each policy's step runs once untimed (which also
    grows the allocator's pools to its needs), then REMAT_TIMED times with
    the launch counters reset before each; logs the median wall ms (each
    ending in a read of the loss) and the peak max_memory_allocated over
    them, less what was allocated before the phase and less "full"'s
    gradients, held for the comparison: the weights, the gradients and
    the policy's activations."""
    from neuronx_distributed_llama3_2_tpu_torch.kernels import flash_attention as fa
    from neuronx_distributed_llama3_2_tpu_torch.models.llama import (
        FLASH_FWD_PER_LAYER,
        LlamaForCausalLM,
    )

    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    cfg, _ = train_configs()
    model = LlamaForCausalLM(cfg, device="cuda").init_weights(SEED)
    batch = train_batch(cfg, REMAT_BATCH)
    params = dict(model.named_parameters())
    ref = None
    for policy in REMAT_POLICIES:
        model.config = dataclasses.replace(cfg, remat=policy)
        gc.collect()
        torch.cuda.empty_cache()
        loss_and_grads(model, batch)  # warm-up
        want = (FLASH_FWD_PER_LAYER[policy] * cfg.num_layers, cfg.num_layers, cfg.num_layers)
        held = 0 if ref is None else sum(g.nbytes for g in ref[1].values())
        torch.cuda.reset_peak_memory_stats()
        step_ms = []
        for _ in range(REMAT_TIMED):
            grads = None
            for c in (fa.fwd_launches, fa.bwd_dq_launches, fa.bwd_dkv_launches):
                c.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = model.loss(batch["input_ids"], batch["labels"])
            grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
            loss = loss.item()
            step_ms.append(1e3 * (time.perf_counter() - t0))
            launches = flash_counts()
            check(launches == want, f"remat {policy}: (K1, K2, K3) launches {launches}, "
                                    f"expected {want}")
        peak = torch.cuda.max_memory_allocated() - base - held
        ms = float(np.median(step_ms))
        if ref is None:
            ref = (loss, grads)
            loss_gap, gap, at = 0.0, 0.0, "-"
        else:
            loss_gap = abs(loss - ref[0])
            gap, at = grad_gap(grads, ref[1])
        log(f"remat {policy}: loss {loss:.6f} (gap to full {loss_gap:.6g}, band {LOSS_BAND}); "
            f"largest gradient relative L2 error against full {gap:.6g} at {at} (band "
            f"{GRAD_BAND}); (K1, K2, K3) launches {launches} a step, expected {want}; step "
            f"median {ms:.6f} ms of {[round(t, 6) for t in step_ms]}; peak memory {peak} B = "
            f"{peak / 2**30:.6f} GiB (weights, gradients, activations) | {card}")
        check(np.isfinite(loss) and loss_gap <= LOSS_BAND, f"remat {policy}: loss gap {loss_gap}")
        check(gap <= GRAD_BAND, f"remat {policy}: gradient gap {gap} at {at}")
        if policy != REMAT_POLICIES[0]:
            del grads
    del model, params, ref
    gc.collect()
    torch.cuda.empty_cache()


PRETRAIN_STEPS = 8
PRETRAIN_SAVE_EVERY = 4
PRETRAIN_BATCH = 4
PRETRAIN_SAMPLES = 64
MOTIF = 64
#: resumed losses against the uninterrupted run's, relative
RESUME_LOSS_TOL = 1e-3


def pretrain_tokens() -> np.ndarray:
    """PRETRAIN_SAMPLES x 2048 tokens of MOTIF-token motifs in seeded
    order: T's four 8-token prompt patterns (two 4-token patterns sharing
    their first three tokens, ``tree_prompts``) each repeated to a motif,
    and three seeded random motifs of ids 64-511."""
    prompts = tree_prompts()
    motifs = [(prompts[j][:8] * (MOTIF // 8)) for j in SPEC_REP_PROMPTS]
    rng = np.random.default_rng(SEED + 19)
    motifs += [rng.integers(64, 512, size=MOTIF).tolist() for _ in range(3)]
    order = rng.integers(0, len(motifs), size=PRETRAIN_SAMPLES * TRAIN_SEQ // MOTIF)
    return np.asarray([t for i in order for t in motifs[i]], dtype=np.int32)


def work_dir():
    """The phases' scratch directory, inside the checkout (git-ignored)."""
    from pathlib import Path

    return Path(__file__).resolve().parent / ".chipscratch" / "pretrain"


class LogLines:
    """Collect the port's log lines (its logger does not propagate)."""

    def __init__(self):
        import logging

        from neuronx_distributed_llama3_2_tpu_torch.utils.logger import get_logger

        self.lines: list = []
        self.handler = logging.Handler()
        self.handler.emit = lambda record: self.lines.append(record.getMessage())
        self.logger = get_logger()

    def __enter__(self):
        self.logger.addHandler(self.handler)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)


@contextlib.contextmanager
def host_copy_spy(copies: list):
    """Record (bytes, seconds) of each CheckpointIOState.add_tree: the copy
    of a kind's tensors into host memory, synchronize included."""
    from neuronx_distributed_llama3_2_tpu_torch.checkpoint import checkpoint as ckpt

    inner = ckpt.CheckpointIOState.add_tree

    def add_tree(self, kind, tree, specs=None):
        t0 = time.perf_counter()
        inner(self, kind, tree, specs)
        secs = time.perf_counter() - t0
        host = self._work[-1][2]
        copies.append((kind, sum(a.nbytes for a in host.values()), secs))

    ckpt.CheckpointIOState.add_tree = add_tree
    try:
        yield
    finally:
        ckpt.CheckpointIOState.add_tree = inner


@contextlib.contextmanager
def skip_save(skipped: str):
    """``save_checkpoint`` calls for the tag ``skipped`` return without
    writing while the block runs (the other tags are saved)."""
    import neuronx_distributed_llama3_2_tpu_torch.checkpoint as ckpt_pkg

    inner = ckpt_pkg.save_checkpoint

    def save(path, tag, *args, **kwargs):
        if tag != skipped:
            inner(path, tag, *args, **kwargs)

    ckpt_pkg.save_checkpoint = save
    try:
        yield
    finally:
        ckpt_pkg.save_checkpoint = inner


def tag_bytes(path) -> int:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def run_pretrain_phase(card: str) -> dict:
    """scripts.pretrain.main in process on a token file of repeated
    motifs (``pretrain_tokens``, written with write_token_file): the 1B at
    full width and depth under its default remat "selective", the native
    loader, batch PRETRAIN_BATCH x 2048, lr 1e-3 after 2 warm-up steps,
    TensorBoard, timeline and metrics file. Run A: PRETRAIN_STEPS steps,
    saving every PRETRAIN_SAVE_EVERY. Its final tag is moved out of the
    root (kept for the trained serve), and run B, the same command, must
    resume from the middle tag: its losses equal A's within
    RESUME_LOSS_TOL relative (the exact differences logged), its final
    weights A's within one bf16 ulp. Both ran the native loader; A's
    TensorBoard file reads back PRETRAIN_STEPS train/loss scalars equal to
    its losses, B's the resumed ones; the timeline parses; A's losses are
    finite and fall. B's final save is not written (``skip_save``: the
    machine's disk-write budget). Logs the free disk before the runs, each tag's bytes,
    each save's and the load's seconds (sync), and the host copy's GB/s.
    Returns A's final tag's path and its weights (on the card)."""
    import shutil

    from neuronx_distributed_llama3_2_tpu_torch.checkpoint import checkpoint as ckpt
    from neuronx_distributed_llama3_2_tpu_torch.data import write_token_file
    from neuronx_distributed_llama3_2_tpu_torch.scripts import pretrain
    from neuronx_distributed_llama3_2_tpu_torch.trainer.tensorboard import read_scalars

    work = work_dir()
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    free = shutil.disk_usage(work).free
    log(f"pretrain: {free} B free on the checkout's disk before the runs")
    tokens = pretrain_tokens()
    write_token_file(str(work / "tokens.npy"), tokens)
    root, kept = work / "ckpt", work / "ckpt_a"
    argv = ["--model", "llama3.2-1b", "--data", str(work / "tokens.npy"), "--native-loader",
            "--seq-len", str(TRAIN_SEQ), "--global-batch", str(PRETRAIN_BATCH),
            "--lr", "1e-3", "--warmup-steps", "2", "--steps", str(PRETRAIN_STEPS),
            "--save-every", str(PRETRAIN_SAVE_EVERY), "--ckpt-dir", str(root),
            "--tensorboard-dir", str(work / "tb"), "--timeline", str(work / "timeline.json"),
            "--metrics-file", str(work / "metrics.jsonl"), "--seed", str(SEED)]
    final = f"step_{PRETRAIN_STEPS}"
    mid = f"step_{PRETRAIN_SAVE_EVERY}"
    copies: list = []
    runs = {}
    for name in ("A", "B"):
        # B's final tag is not written: three 17.3 GB tags would pass the
        # chip machine's budget of bytes written to its disk (45 GiB, freed
        # blocks included); A's two saves are written, timed and served
        skip = skip_save(final) if name == "B" else contextlib.nullcontext()
        with LogLines() as lines, host_copy_spy(copies), skip:
            t0 = time.perf_counter()
            out = pretrain.main(argv)
            wall = time.perf_counter() - t0
        json.loads((work / "timeline.json").read_text())  # must parse
        runs[name] = out
        log(f"pretrain run {name}: {wall:.6f} s; start step {out['start_step']}, losses "
            f"{out['losses']}; dataset {out['dataset']}; saves {out['save_seconds']} s, load "
            f"{out['load_seconds']} s (sync) | {card}")
        if name == "A":
            sizes = {t: tag_bytes(root / t) for t in (mid, final)}
            log(f"pretrain: tag bytes {sizes}; {shutil.disk_usage(work).free} B free after run A")
            params_a = {k: p.detach().clone() for k, p in out["state"].params.items()}
            kept.mkdir()
            os.replace(root / final, kept / final)  # B must not find it; the serve loads it
            tb_a = sorted((work / "tb").iterdir())
        else:
            check(any(f"resumed from {mid} at step {PRETRAIN_SAVE_EVERY}" in line
                      for line in lines.lines),
                  f"pretrain run B did not resume from {mid}: {lines.lines[:5]}")
        check(any(f"done: {PRETRAIN_STEPS} steps" in line for line in lines.lines),
              f"pretrain run {name} did not finish")
        del out
        gc.collect()
        torch.cuda.empty_cache()
    a, b = runs["A"], runs["B"]
    losses = [a["losses"][s] for s in range(PRETRAIN_STEPS)]
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"pretrain: losses not finite and falling: {losses}")
    check(a["dataset"] == b["dataset"] == "NativeTokenDataset",
          f"pretrain: datasets {a['dataset']}, {b['dataset']} (the native loader must run)")
    diffs = {s: b["losses"][s] - a["losses"][s] for s in range(PRETRAIN_SAVE_EVERY, PRETRAIN_STEPS)}
    check(sorted(b["losses"]) == list(range(PRETRAIN_SAVE_EVERY, PRETRAIN_STEPS))
          and all(abs(d) <= RESUME_LOSS_TOL * abs(a["losses"][s]) for s, d in diffs.items()),
          f"pretrain: resumed losses {b['losses']} vs {a['losses']}")
    worst_ulps, differing, total = 0.0, 0, 0
    for k, p in b["state"].params.items():
        ref = params_a[k]
        d = (p.float() - ref.float()).abs()
        worst_ulps = max(worst_ulps, (d / bf16_ulp(ref.float())).max().item())
        differing += int((d > 0).sum())
        total += d.numel()
    log(f"pretrain: resumed losses minus run A's {diffs} (tolerance {RESUME_LOSS_TOL} "
        f"relative); final weights: {differing} of {total} elements differ, the worst by "
        f"{worst_ulps:.6g} bf16 ulps | {card}")
    check(worst_ulps <= 1.0, f"pretrain: resumed weights {worst_ulps} ulps from run A's")
    scal_a = read_scalars(str(tb_a[0]))["train/loss"]
    tb_b = [f for f in sorted((work / "tb").iterdir()) if f not in tb_a]
    scal_b = read_scalars(str(tb_b[0]))["train/loss"] if len(tb_b) == 1 else {}
    check(len(tb_a) == 1 and sorted(scal_a) == list(range(PRETRAIN_STEPS))
          and all(abs(scal_a[s] - a["losses"][s]) <= 1e-6 * abs(a["losses"][s])
                  for s in scal_a)
          and sorted(scal_b) == list(range(PRETRAIN_SAVE_EVERY, PRETRAIN_STEPS)),
          f"pretrain: TensorBoard scalars A {scal_a}, B {scal_b}")
    metrics = [json.loads(line) for line in open(work / "metrics.jsonl")]
    check(len(metrics) == PRETRAIN_STEPS + PRETRAIN_STEPS - PRETRAIN_SAVE_EVERY,
          f"pretrain: {len(metrics)} metrics lines")
    rates = [f"{kind} {n} B in {sec:.6f} s = {n / sec / 1e9:.6f} GB/s" for kind, n, sec in copies]
    log(f"pretrain: host copies (CheckpointIOState.add_tree, each a save's kind; the first "
        f"allocates the page-locked buffers): {rates} | {card}")
    ckpt._IO_STATES.pop(str(root), None)  # the root's page-locked host buffers
    del b
    runs.clear()
    shutil.rmtree(root)
    gc.collect()
    torch.cuda.empty_cache()
    return dict(tag_dir=kept, tag=final, params=params_a)


def run_trained_serve_phase(cfg, trained: dict, card: str) -> None:
    """The pretrained checkpoint served: run A's final tag loaded through
    load_checkpoint into the 1B (``cfg``: the paged kernel on), its weights
    bitwise the trained state's; T (tree speculation) served eagerly, every
    request within T_LOGIT_MARGIN of the plain forward over the loaded
    weights, and by its prewarmed twin (the eager streams, no K4 launch
    outside a replay); the lane trees that branched and the accepted
    tokens logged beside the random-weight runs' 0 of 256. Then
    scripts.generate --ckpt-dir on the card, greedy: its stream equals
    InferenceEngine.generate's over the loaded weights. Deletes the
    scratch directory at the end."""
    import shutil

    from neuronx_distributed_llama3_2_tpu_torch.checkpoint import load_checkpoint
    from neuronx_distributed_llama3_2_tpu_torch.inference.engine import (
        GenerationConfig,
        InferenceEngine,
    )
    from neuronx_distributed_llama3_2_tpu_torch.models.llama import LlamaForCausalLM
    from neuronx_distributed_llama3_2_tpu_torch.scripts import generate

    root, tag = trained["tag_dir"], trained["tag"]
    model = LlamaForCausalLM(cfg, device="cuda")
    t0 = time.perf_counter()
    loaded = load_checkpoint(str(root), tag, model=dict(model.named_parameters()))
    model.load_state_dict(loaded["model"])
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    del loaded
    same = all(torch.equal(p, trained["params"][k]) for k, p in model.named_parameters())
    log(f"trained serve: {root.name}/{tag} loaded (model kind) in {load_s:.6f} s; weights "
        f"bitwise the trained state's: {same} | {card}")
    check(same, "trained serve: the loaded weights differ from the trained state's")
    trained["params"].clear()
    summary: dict = {}
    t_prompts, t_outs, t_rids, *_ = run_tree_serve_phase(cfg, model, card, summary=summary)
    run_tree_e2e_phase(cfg, model, t_prompts, t_outs, t_rids)
    twin = run_graph_phase(tree_config(cfg), model, "serve T trained", t_prompts,
                           [t_outs[r] for r in t_rids], card,
                           lambda o, r: e2e_gaps(model, t_prompts, o, r)[0], T_LOGIT_MARGIN,
                           **TREE_KNOBS)
    log(f"trained serve T: {summary['branched']} of {summary['lane_trees']} lane trees "
        f"branched (random weights: 0 of 256, runs S, U); accepted tokens "
        f"{summary['accepted']} of {summary['draft']} drafted (accept rate "
        f"{summary['accept_rate']:.6f}), {summary['accepted'] / max(summary['lane_trees'], 1):.6f} "
        f"a lane tree; prewarmed twin's streams equal: {twin['same']}, TPOT p50 "
        f"{twin['tpot']:.6f} ms | {card}")
    prompt = t_prompts[SPEC_REP_PROMPTS[0]][:64]
    got = generate.main(["--model", "llama3.2-1b", "--ckpt-dir", str(root), "--tag", tag,
                         "--prompt-ids", ",".join(map(str, prompt)), "--greedy",
                         "--max-new-tokens", "16", "--max-seq-len", "256"])
    engine = InferenceEngine(cfg, model, max_batch=1, max_seq_len=256)
    want = engine.generate([prompt], GenerationConfig(max_new_tokens=16)).sequences
    log(f"trained serve: scripts.generate --ckpt-dir {got['sequences']}, "
        f"InferenceEngine.generate {want}; per-token p50 "
        f"{got['report']['per_token']['p50_ms']:.6f} ms | {card}")
    check(got["sequences"] == want, "trained serve: scripts.generate's stream differs")
    del engine, model
    shutil.rmtree(work_dir(), ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()


# -- 6. flash kernels -----------------------------------------------------------

# (name, B, N, Nkv, S, D, causal, timing iterations); the first is the
# train step's shape, whose numbers go into the kernels record and where
# the planted fault runs
FLASH_CASES = (
    ("train causal", 12, 32, 8, 2048, 64, True, 10),
    ("train full", 12, 32, 8, 2048, 64, False, 5),
    ("3b causal (D 128, G 3)", 2, 24, 8, 2048, 128, True, 10),
    ("3b full (D 128, G 3)", 2, 24, 8, 2048, 128, False, 10),
    ("unaligned S 1000 causal", 2, 32, 8, 1000, 64, True, 10),
    ("unaligned S 1000 full", 2, 32, 8, 1000, 64, False, 10),
)
# the packed-document cases (segment_ids, ``packed_segments``), same layout;
# the first is the train shape, where the planted segment faults run
PACKED_CASES = (
    ("train causal, packed", 12, 32, 8, 2048, 64, True, 10),
    ("3b full, packed (D 128, G 3)", 2, 24, 8, 2048, 128, False, 10),
    ("unaligned S 1000 causal, packed", 2, 32, 8, 1000, 64, True, 10),
    ("D 96 causal, packed (G 4)", 2, 16, 4, 1000, 96, True, 10),
)
# the one document of row 0 longer than the seeded lengths' 1024 rows
PACKED_LONG = 1100
# lse is fp32 from the same bf16 products in another order
LSE_TOL = 1e-4
# K1-K3 vs their plain versions, held element by element and tile by tile:
# ulps of a tensor's largest value would be as large as a late causal
# row's whole output. Both read bf16 operands, accumulate in fp32 in
# another order and round o, dq, dk, dv to bf16 on their own; K1 rounds P
# to bf16 against the running max of its kv tiles (64 rows at D = 64, 128
# at D = 128), the plain version against that of 1024-row chunks, so their
# rounded P differ at random by up to a bf16 ulp (2^-8) relative. K2 (kv
# tiles of 64 rows) and K3 (q tiles of 64 rows) rebuild P from lse and
# round P and dS where the plain version does, from fp32 scores summed in
# another order, so a rounding may land one ulp apart. Hence:
# - each output element within its ROW_ULPS limit (``element_ratio``);
# - each (b, head, TILE-row tile) within TILE_REL_L2 relative L2 error:
#   the P roundings give about 2^-9 relative and the output roundings as
#   much again, a few thousandths in all.
TILE_REL_L2 = 1e-2
TILE = 64
# the kernel phase's planted fault, at its first case's S: kernels that
# leave out the kv rows of ``fault_tile(S)`` for its q rows (one 64 x 64
# tile: one warpgroup's share of a K1 or K2 kv tile, one step of a K3
# warpgroup's walk): at the train shape (S 2048) q rows 1984-2047 and kv
# rows 1024-1087, 64 of the ~2000 keys of those q rows, 64 of the 1024
# queries of those kv rows. The check must reject every output the fault
# touches


def fault_tile(s: int) -> tuple:
    """(q rows, kv rows) of the planted tile fault at sequence length s:
    the last q tile, the kv tile at the middle."""
    return (s - TILE, s), (s // 2, s // 2 + TILE)


def flash_bound(b, n, nkv, s, d, causal, k: int, segment_ids=None):
    """Least time of K1 (k=1), K2 (k=2) or K3 (k=3) at this shape: FLOPs
    of 4, 6 or 8 x D per attended (q, kv) pair over the bf16 peak, against
    each input read once and each output written once over HBM bandwidth.
    With ``segment_ids`` only the pairs the segment (and causal) mask lets
    attend count, and the ids are read once."""
    from neuronx_distributed_llama3_2_tpu_torch import flops as fl

    if segment_ids is None:
        pairs = b * n * (s * (s + 1) // 2 if causal else s * s)
    else:
        pairs = n * attended_pairs(segment_ids, causal)
    flops = (2 + 2 * k) * d * pairs
    qo = b * n * s * d * 2     # one (B, N, S, D) bf16 tensor
    kv = b * nkv * s * d * 2   # one (B, Nkv, S, D) bf16 tensor
    vec = b * n * s * 4        # one (B, N, S) fp32 vector
    ids = 0 if segment_ids is None else b * s * 4
    nbytes = ids + {1: 2 * qo + 2 * kv + vec,            # q, k, v -> o, lse
                    2: 3 * qo + 2 * kv + 2 * vec,        # q, k, v, do, lse, delta -> dq
                    3: 2 * qo + 4 * kv + 2 * vec}[k]     # q, k, v, do, lse, delta -> dk, dv
    t_ops = flops / fl.H100_BF16_FLOPS_PER_S * 1e3
    t_bytes = nbytes / fl.H100_HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def attended_pairs(segment_ids, causal: bool) -> int:
    """The (q, kv) pairs of one head that a (B, S) id array lets attend:
    per id with c rows in a batch row, c^2, or c (c + 1) / 2 under the
    causal mask (the i-th row of an id sees i of its rows). Ids are
    compared, not assumed contiguous."""
    total = 0
    for row in np.asarray(torch.as_tensor(segment_ids).cpu()):
        counts = np.unique(row, return_counts=True)[1].astype(np.int64)
        total += int((counts * (counts + 1) // 2 if causal else counts * counts).sum())
    return total


def packed_segments(b: int, s: int, seed: int = SEED) -> torch.Tensor:
    """(B, S) int32 document ids of a packed batch, made from ``seed``: each
    row filled with documents of seeded lengths 1-1024. Row 0 starts with
    documents whose boundaries fall on a 64-row tile's first row (64, 128),
    on its last row (127: a document of one row) and mid-tile (158), then,
    where S allows, a document of PACKED_LONG rows; row 1 starts with two
    short documents and takes the ids 0, 1, 0, 1, ... in turn, so an id
    comes back after another one."""
    rng = np.random.default_rng(seed)
    out = np.zeros((b, s), np.int32)
    for r in range(b):
        starts = [0]
        if r == 0:
            starts += [64, 127, 128, 158]
            if 158 + PACKED_LONG < s:
                starts.append(158 + PACKED_LONG)
        elif r == 1:
            starts += [int(rng.integers(1, s // 3))]
            starts += [starts[-1] + int(rng.integers(1, s // 3))]
        while starts[-1] + 1 < s:
            starts.append(starts[-1] + int(rng.integers(1, 1025)))
        starts = [x for x in starts if x < s]
        ids = np.arange(len(starts), dtype=np.int32)
        if r == 1:
            ids %= 2
        out[r] = np.repeat(ids, np.diff(starts + [s]))
    return torch.from_numpy(out)


def plain_moves_boundary(segment_ids: torch.Tensor, row: int = 64) -> torch.Tensor:
    """The planted fault (a): ``segment_ids`` with the document boundary at
    ``row`` of batch row 0 moved one row later (row ``row`` keeps the
    earlier document's id), for the plain versions to run with."""
    bad = segment_ids.clone()
    assert bad[0, row] != bad[0, row - 1], "no boundary at the fault's row"
    bad[0, row] = bad[0, row - 1]
    return bad


def plain_segments_on_crossing_tiles_only(tile: int = TILE):
    """The planted fault (b): while the block runs, the plain versions apply
    the segment compare only on the (tile x tile) tiles that the causal
    diagonal or the kv edge crosses, as a kernel that kept its "masks only
    where needed" rule under segment ids would."""
    def mask_of(inner):
        def mask(q_pos, kv_pos, causal, segment_ids):
            with_ids = inner(q_pos, kv_pos, causal, segment_ids)
            if segment_ids is None:
                return with_ids
            s = segment_ids.shape[1]
            crossing = kv_pos[None, :] // tile == q_pos[:, None] // tile
            if s % tile:  # the ragged last kv tile
                crossing = crossing | (kv_pos[None, :] // tile == (s - 1) // tile)
            return torch.where(crossing, with_ids, inner(q_pos, kv_pos, causal, None))
        return mask
    return _plain_mask(mask_of)


def flash_agreement(out: torch.Tensor, ref: torch.Tensor):
    """How far a (B, H, S, D) kernel output lies from its plain version:
    (the largest ratio of an element's error to its limit, the largest
    relative L2 error of a (b, head, TILE-row tile)). It agrees when the
    first is at most 1 and the second at most TILE_REL_L2."""
    r = ref.float()
    diff = out.float() - r

    def tile_norms(x):
        rows = torch.nn.functional.pad(x.square().sum(dim=-1), (0, -x.shape[2] % TILE))
        return rows.reshape(*rows.shape[:2], -1, TILE).sum(dim=-1).sqrt()

    rel = (tile_norms(diff) / tile_norms(r).clamp_min(1e-30)).max().item()
    return element_ratio(out, ref), rel


@contextlib.contextmanager
def _plain_mask(mask_of):
    """While the block runs, the plain versions mask with
    ``mask_of(inner)(q_pos, kv_pos, causal, segment_ids)``, ``inner`` being
    their own mask."""
    from neuronx_distributed_llama3_2_tpu_torch.kernels import flash_attention as fa

    inner = fa._mask
    fa._mask = mask_of(inner)
    try:
        yield
    finally:
        fa._mask = inner


def plain_skips_tile(q_rows, kv_rows):
    """While the block runs, the plain versions leave out the (q, kv) pairs
    of q_rows x kv_rows, as a kernel that skipped that tile would."""
    def mask_of(inner):
        def mask(q_pos, kv_pos, causal, segment_ids):
            skip = (((q_pos >= q_rows[0]) & (q_pos < q_rows[1]))[:, None]
                    & ((kv_pos >= kv_rows[0]) & (kv_pos < kv_rows[1]))[None, :])
            return inner(q_pos, kv_pos, causal, segment_ids) & ~skip
        return mask
    return _plain_mask(mask_of)


def plain_misses_diagonal():
    """While the block runs, the plain versions' causal mask is col < row in
    place of col <= row, as a kernel that masks its diagonal tiles with the
    strict compare would: every row loses its own key, and row 0 every
    key."""
    def mask_of(inner):
        def mask(q_pos, kv_pos, causal, segment_ids):
            ok = inner(q_pos, kv_pos, causal, segment_ids)
            if causal:
                ok = ok & (kv_pos[None, :] != q_pos[:, None])
            return ok
        return mask
    return _plain_mask(mask_of)


def packed_library_mask(segment_ids: torch.Tensor, causal: bool) -> torch.Tensor:
    """The boolean (B, 1, S, S) mask of the packed batch for SDPA: the
    block-diagonal same-id mask, under the causal one."""
    seg = segment_ids.cuda()
    mask = seg[:, None, :, None] == seg[:, None, None, :]
    if causal:
        s = seg.shape[1]
        mask &= torch.ones((s, s), dtype=torch.bool, device="cuda").tril()
    return mask


def run_flash_kernel_phase(card: str, packed: bool = False, cases=None) -> dict:
    """K1, K2 and K3 against their plain versions at FLASH_CASES (held by
    ``flash_agreement``, lse within LSE_TOL), with kernel, plain, library
    and bound times. At the train shape the same check must also reject
    each of the kernels' outputs with a planted fault
    (``plain_skips_tile``), and each with a causal mask of col < row
    (``plain_misses_diagonal``).

    ``packed``: the same at PACKED_CASES with ``packed_segments`` ids, the
    kernels driven once through the public ``flash_attention(segment_ids=)``
    (forward and backward, each launch counter 1 after it), the library
    time SDPA's with the boolean block-diagonal mask built once, the bounds
    over the attended pairs; the planted faults at the packed train shape
    are a document boundary moved by one row (``plain_moves_boundary``)
    and the segment compare only on crossing tiles
    (``plain_segments_on_crossing_tiles_only``). ``cases`` replaces
    FLASH_CASES (a tp rank's shapes; the planted faults run at the first,
    and at D 96 one more: K1's scores without columns 64-95).
    Only the first case is timed (the script's timing depth, PERF.md
    section 7); the others are checked. Returns the record of K1-K3 (the
    first case's times, the worst errors, and under ``packed`` the public
    entry's launches)."""
    from neuronx_distributed_llama3_2_tpu_torch.kernels import flash_attention as fa

    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    worst = {1: 0.0, 2: 0.0, 3: 0.0}
    worst_elem, worst_rel = 0.0, 0.0
    launches = {1: 0, 2: 0, 3: 0}
    record = None
    for name, b, n, nkv, s, d, causal, iters in cases or (PACKED_CASES if packed else FLASH_CASES):
        def randn(*shape):
            return torch.randn(shape, generator=gen, device="cuda", dtype=torch.bfloat16)

        q, k, v, do = randn(b, n, s, d), randn(b, nkv, s, d), randn(b, nkv, s, d), randn(b, n, s, d)
        seg = packed_segments(b, s).cuda() if packed else None
        sc = d ** -0.5
        if packed:
            # the public entry, (B, S, N, D), forward and backward: one launch
            # of each kernel, counted from 0
            for counter in (fa.fwd_launches, fa.bwd_dq_launches, fa.bwd_dkv_launches):
                counter.count = 0
            qe, ke, ve = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
            fa.flash_attention(qe, ke, ve, causal=causal, segment_ids=seg).backward(
                do.transpose(1, 2))
            torch.cuda.synchronize()
            counts = list(flash_counts())
            check(counts == [1, 1, 1],
                  f"flash {name}: flash_attention(segment_ids=) launched K1-K3 {counts} "
                  "times, not once each")
            for kn, c in zip((1, 2, 3), counts):
                launches[kn] += c
            del qe, ke, ve
        o, lse = fa.flash_fwd(q, k, v, seg, causal, sc)
        dq, dk, dv = fa.flash_bwd(q, k, v, o, lse, do, seg, causal, sc)
        outs = {"o": o, "dq": dq, "dk": dk, "dv": dv}
        o_ref, lse_ref = fa.flash_fwd_reference(q, k, v, seg, causal, sc, block_kv=1024)
        refs = dict(zip(("o", "dq", "dk", "dv"), (o_ref, *fa.flash_bwd_reference(
            q, k, v, o, lse, do, seg, causal, sc, block_kv=1024))))
        torch.cuda.synchronize()
        errs = {}
        for kn, label in ((1, "o"), (2, "dq"), (3, "dk"), (3, "dv")):
            out, ref = outs[label], refs[label]
            check(bool(torch.isfinite(out).all()), f"flash {name}: non-finite {label}")
            err = (out.float() - ref.float()).abs().max().item()
            elem, rel = flash_agreement(out, ref)
            check(elem <= 1.0 and rel <= TILE_REL_L2,
                  f"flash {name}: {label} disagrees with the plain version (error "
                  f"{elem} x its element limit, tile relative L2 {rel})")
            worst[kn] = max(worst[kn], err)
            worst_elem, worst_rel = max(worst_elem, elem), max(worst_rel, rel)
            # the share of outputs not bitwise equal to the plain version's
            # (recorded, not checked: the summation orders differ)
            differ = (out != ref).float().mean().item()
            errs[label] = (err, elem, rel, differ)
        lse_err = (lse - lse_ref).abs().max().item()
        check(lse_err <= LSE_TOL, f"flash {name}: lse max_abs_err {lse_err}")
        del o_ref, lse_ref

        if record is None:
            # the planted faults: the kernels' outputs plus what the fault
            # changes in the plain versions
            if packed:
                faults = (("a document boundary moved by one row", plain_moves_boundary(seg),
                           contextlib.nullcontext()),
                          ("the segment compare only on crossing tiles", seg,
                           plain_segments_on_crossing_tiles_only()))
            else:
                q_rows, kv_rows = fault_tile(s)
                faults = ((f"kv rows {kv_rows} left out for q rows {q_rows}", None,
                           plain_skips_tile(q_rows, kv_rows)),
                          ("the causal diagonal masked with col < row", None,
                           plain_misses_diagonal()))

            def fault_outputs():
                for fault, bad_seg, planted_mask in faults:
                    with planted_mask:
                        bad = dict(zip(("o", "dq", "dk", "dv"), (
                            fa.flash_fwd_reference(q, k, v, bad_seg, causal, sc,
                                                   block_kv=1024)[0],
                            *fa.flash_bwd_reference(q, k, v, o, lse, do, bad_seg, causal, sc,
                                                    block_kv=1024))))
                    yield fault, bad
                if d == 96:
                    # a D 96 K1 whose S = Q K^T reads one 64-column box
                    yield "the scores leave out columns 64-95", {"o": fa.flash_fwd_reference(
                        q, columns_left_out(k), v, seg, causal, sc, block_kv=1024)[0]}

            for fault, bad in fault_outputs():
                for label in bad:
                    out = outs[label]
                    planted = (out.float() + bad[label].float()
                               - refs[label].float()).to(out.dtype)
                    elem, rel = flash_agreement(planted, refs[label])
                    log(f"flash [{name}] planted fault ({fault}): {label} error {elem:.6g} x "
                        f"its element limit, tile relative L2 {rel:.6g} (limits 1, "
                        f"{TILE_REL_L2})")
                    check(elem > 1.0 or rel > TILE_REL_L2,
                          f"the flash check passes a planted fault ({fault}) in {label}")
                del bad, planted
        del refs, outs

        def fwd(i):
            return fa.flash_fwd(q, k, v, seg, causal, sc)

        def bwd(i):
            return fa.flash_bwd(q, k, v, o, lse, do, seg, causal, sc)

        def fwd_plain(i):
            return fa.flash_fwd_reference(q, k, v, seg, causal, sc, block_kv=1024)

        def bwd_plain(i):
            return fa.flash_bwd_reference(q, k, v, o, lse, do, seg, causal, sc, block_kv=1024)

        # the library yardstick: SDPA, with the packed batch's boolean mask
        # built once (never a path of the port)
        lib_kw = (dict(attn_mask=packed_library_mask(seg, causal)) if packed
                  else dict(is_causal=causal))

        def fwd_lib(i):
            return sdpa(q, k, v, enable_gqa=True, **lib_kw)

        ql, kl, vl = (x.detach().requires_grad_() for x in (q, k, v))
        o_lib = sdpa(ql, kl, vl, enable_gqa=True, **lib_kw)

        def bwd_lib(i):
            return torch.autograd.grad(o_lib, (ql, kl, vl), do, retain_graph=True)

        bounds = {kn: flash_bound(b, n, nkv, s, d, causal, kn, segment_ids=seg)
                  for kn in (1, 2, 3)}
        timing = record is None  # the first case (the record's) is timed
        if timing:
            times = {1: device_ms(fwd, iters, matches=("flash_fwd_kernel",))[0][0]}
            times[2], times[3] = device_ms(
                bwd, iters, matches=("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel"))[0]
            (plain_fwd,), _ = device_ms(fwd_plain, max(2, iters // 5))
            (plain_bwd,), _ = device_ms(bwd_plain, max(2, iters // 5))
            (lib_fwd,), _ = device_ms(fwd_lib, iters)
            (lib_bwd,), _ = device_ms(bwd_lib, iters)
        err_txt = ", ".join(
            f"{lb} {e:.6g} ({el:.4f} x its element limit, tile rel L2 {rl:.6g}; "
            f"{100 * f:.4f}% differ)" for lb, (e, el, rl, f) in errs.items()
        )
        pairs = "" if seg is None else (
            f" (packed: {attended_pairs(seg, causal)} attended pairs a head, "
            f"{len(torch.unique(seg[0]))} ids in row 0)")
        timed_txt = (
            f"K1 {times[1]:.6f} ms (bound {bounds[1][0]:.6f}, {bounds[1][1]}), K2 "
            f"{times[2]:.6f} ms (bound {bounds[2][0]:.6f}), K3 {times[3]:.6f} ms (bound "
            f"{bounds[3][0]:.6f}); plain fwd {plain_fwd:.6f} / bwd {plain_bwd:.6f} ms; library "
            f"(SDPA) fwd {lib_fwd:.6f} / bwd {lib_bwd:.6f} ms" if timing else
            f"checked, not timed (bounds {bounds[1][0]:.6f} / {bounds[2][0]:.6f} / "
            f"{bounds[3][0]:.6f} ms)")
        log(f"kernel flash [{name}] B={b} N={n} Nkv={nkv} S={s} D={d}{pairs}: {err_txt}, lse "
            f"{lse_err:.6g}; {timed_txt} | {card}")
        if record is None:
            record = {
                kn: dict(ms=times[kn], bound_ms=bounds[kn][0], bound_by=bounds[kn][1],
                         plain_ms=plain_fwd if kn == 1 else plain_bwd,
                         library_ms=lib_fwd if kn == 1 else lib_bwd)
                for kn in (1, 2, 3)
            }
        del q, k, v, do, o, lse, dq, dk, dv, ql, kl, vl, o_lib, lib_kw, seg
        torch.cuda.empty_cache()
    log(f"flash{' packed' if packed else ''}: every case agrees with the plain version: "
        f"each element within {ROW_ULPS} bf16 ulps of its own value plus {ROW_ULPS} of its "
        f"row's largest (worst {worst_elem:.6g} x that limit), each {TILE}-row tile within "
        f"relative L2 {TILE_REL_L2} (worst {worst_rel:.6g}); worst abs err K1 {worst[1]:.6g}, "
        f"K2 {worst[2]:.6g}, K3 {worst[3]:.6g}; lse within {LSE_TOL}; tolerance: bf16 "
        "operands and outputs, fp32 accumulation in another order, P rounded against "
        "another running max; K2's and K3's plain and library times are of dq, dk and "
        "dv together, and K2 and K3 are timed in one window of flash_bwd")
    for kn in (1, 2, 3):
        record[kn]["max_abs_err"] = worst[kn]
        if packed:
            record[kn]["launches"] = launches[kn]
    return record


# -- 4i. the dense engine -----------------------------------------------------------

#: generate()'s on_device_steps: the per-token loop and 8 tokens a round trip
DENSE_STEPS = (1, 8)
#: K and V of the 1B's dense cache, 8 slots of 2048 rows: 2 x 16 layers x 8
#: x 2048 x 8 kv heads x 64 x 2 bytes
DENSE_CACHE_BYTES = 536870912
#: the churn: Serve's eight prompts twice over the 8 slots, one admitted
#: every DENSE_ADMIT_EVERY decode steps
DENSE_ADMIT_EVERY = 4
DENSE_SEED = 7
#: replays of the graphed decode step under the profiler (its kernel list)
DENSE_PROFILE_REPLAYS = 10
SPEC_DRAFT_LAYERS = 4
SPEC_GAMMA = 4


def dense_engine(cfg, model, max_batch: int = 8):
    """The dense engine as served here: 2048-row slots, the default
    buckets (128 ... 2048)."""
    from neuronx_distributed_llama3_2_tpu_torch.inference.engine import InferenceEngine

    return InferenceEngine(cfg, model, max_batch=max_batch, max_seq_len=2048)


def dense_generate(engine, prompts, steps: int, sampling=None, seed: int = 0) -> dict:
    """``engine.generate(prompts)`` with precompile, MAX_NEW tokens at
    ``on_device_steps`` ``steps``. Returns the streams, the latency report,
    the program-table size right after the first token and after the
    run, and the wall seconds."""
    from neuronx_distributed_llama3_2_tpu_torch.inference.engine import GenerationConfig

    gen = GenerationConfig(max_new_tokens=MAX_NEW, on_device_steps=steps, seed=seed,
                           precompile=True,
                           **(dict(sampling=sampling) if sampling is not None else {}))
    table = {}
    inner = engine._prefill_dev

    def first_token(*a, **kw):
        out = inner(*a, **kw)
        table["first"] = len(engine._programs)
        return out

    engine._prefill_dev = first_token
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = engine.generate(prompts, gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        del engine._prefill_dev
    return dict(seqs=res.sequences, report=res.benchmark.report(), first=table["first"],
                after=len(engine._programs), wall=wall)


@contextlib.contextmanager
def dense_newest_row_dropped(engine):
    """A planted fault in ``engine``'s dense decode: the kv_limit read's
    mask leaves out each slot's newest row (at decode, the token's own
    K/V). Install it before the engine captures anything."""
    model = engine.model
    inner = model._cache_attention

    def planted(q, k_all, v_all, pos_block, positions=None, tree=None):
        return inner(q, k_all, v_all, pos_block - 1, positions, tree)

    model._cache_attention = planted
    try:
        yield
    finally:
        del model._cache_attention


def run_dense_phase(cfg, model, prompts, paged_outs: list, card: str):
    """The dense engine (``InferenceEngine.generate``, every program a CUDA
    graph) on Serve's eight prompts, greedy, at on_device_steps 1 and 8:
    the two runs' streams equal, every token within E2E_LOGIT_MARGIN of
    the plain forward's argmax, the streams the eager paged serve's (the
    near-tie rule), no program built after the first token, the cache
    DENSE_CACHE_BYTES; a planted decode whose kv read leaves out each
    slot's newest row must read above the margin. Logs TTFT / TPOT p50 and
    one graphed decode step's device time (b 8, at the served kv bucket,
    1024) beside its bytes bound. Returns (engine, streams)."""
    from neuronx_distributed_llama3_2_tpu_torch.inference.sampling import SamplingConfig

    engine = dense_engine(cfg, model)
    runs = {}
    for steps in DENSE_STEPS:
        r = runs[steps] = dense_generate(engine, prompts, steps)
        check(r["after"] == r["first"],
              f"dense: {r['after'] - r['first']} programs built after the first token "
              f"(on_device_steps {steps})")
        check(all(len(s) == MAX_NEW for s in r["seqs"]), f"dense: stream lengths "
              f"{[len(s) for s in r['seqs']]}")
    seqs = runs[1]["seqs"]
    check(runs[8]["seqs"] == seqs, "dense: the streams at on_device_steps 8 differ from 1's")
    cache = engine.cache
    cache_bytes = cache.k.nbytes + cache.v.nbytes
    check(cache_bytes == DENSE_CACHE_BYTES, f"dense: the cache is {cache_bytes} B")
    rids = list(range(len(prompts)))
    gap, exact, total = e2e_gaps(model, prompts, dict(enumerate(seqs)), rids)
    check(gap <= E2E_LOGIT_MARGIN, f"dense: a token is {gap} below the argmax logit")
    differ = same_streams("dense", model, prompts, seqs, paged_outs, rids)
    # one graphed greedy decode step at the served kv bucket (1024 for
    # Serve's prompts), replayed alone
    kv = max(k[-1] for k in engine._programs if k[0] == "decode")
    key_ = ("decode", 8, SamplingConfig(), kv)
    prog = engine._programs[key_]
    check(prog.graph is not None, f"dense: {key_} was not captured")
    (step_ms,), step_ev = device_ms(lambda i: prog(), iters=20, windows=3)
    # where a replay's device time goes, kernel by kernel
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(DENSE_PROFILE_REPLAYS):
            prog()
        torch.cuda.synchronize()
    events = sorted((e for e in prof.key_averages() if e.self_device_time_total > 0),
                    key=lambda e: e.self_device_time_total, reverse=True)
    weight_bytes = sum(p.nbytes for p in model.parameters())
    kv_bytes = 2 * cfg.num_layers * 8 * kv * cfg.num_kv_heads * cfg.head_dim * 2
    bound = (weight_bytes + kv_bytes) / 3.35e12 * 1e3
    # the planted fault, captured into a fresh engine's graphs
    bad = dense_engine(cfg, model)
    with dense_newest_row_dropped(bad):
        bad_seqs = dense_generate(bad, prompts, 1)["seqs"]
    bad_gap, bad_exact, _ = e2e_gaps(model, prompts, dict(enumerate(bad_seqs)), rids)
    del bad
    gc.collect()
    torch.cuda.empty_cache()
    check(bad_gap > E2E_LOGIT_MARGIN,
          f"dense: the e2e check passes a decode that leaves out the newest row ({bad_gap})")
    for steps, r in runs.items():
        rep = r["report"]
        log(f"dense generate (on_device_steps {steps}): {len(prompts)} prompts, "
            f"{sum(map(len, r['seqs']))} tokens in {r['wall']:.6f} s (capture included "
            f"on the first run); TTFT p50 {rep['ttft']['p50_ms']:.6f} ms, TPOT p50 "
            f"{rep['per_token']['p50_ms']:.6f} ms (p90 {rep['per_token']['p90_ms']:.6f}); "
            f"programs {r['first']} after the first token, {r['after']} after the run | {card}")
    log(f"dense: streams equal at on_device_steps 1 and 8; {exact}/{total} tokens the plain "
        f"forward's argmax, worst logit gap {gap:.6g} (margin {E2E_LOGIT_MARGIN}); equal to "
        f"the eager paged serve's on {len(prompts) - len(differ)} of {len(prompts)} requests "
        f"(the rest near ties); cache {cache_bytes} B; {len(engine._programs)} programs "
        f"({sorted({k[0] for k in engine._programs})}); one replay of {key_[0]} b 8 kv {kv} "
        f"{step_ms:.6f} ms of device time ({step_ev:.6f} ms by events), bytes bound "
        f"{bound:.6f} ms ({weight_bytes} B of weights + {kv_bytes} B of K/V) | {card}")
    n = DENSE_PROFILE_REPLAYS
    log(f"dense decode replay profile: {sum(e.count for e in events) / n:.1f} kernels a "
        f"replay, {sum(e.self_device_time_total for e in events) / 1e3 / n:.6f} ms of device "
        f"time a replay; the largest by device time: | {card}")
    for e in events[:10]:
        log(f"  device {e.self_device_time_total / 1e3 / n:.6f} ms a replay, {e.count / n:.1f} "
            f"calls: {e.key[:100]}")
    log(f"dense planted fault (each slot's newest row left out of the kv read): "
        f"{bad_exact}/{total} tokens the plain forward's argmax, worst logit gap "
        f"{bad_gap:.6g} (margin {E2E_LOGIT_MARGIN})")
    return engine, seqs


def run_dense_churn_phase(engine, model, prompts, dense_seqs: list, card: str) -> None:
    """``benchmark_serving_churn``'s loop over the dense engine: Serve's
    prompts twice (16 requests over 8 slots, one admitted every
    DENSE_ADMIT_EVERY steps, so slots are freed and refilled mid-run). No
    program built under traffic, and each stream that prompt's greedy
    generate() stream (the near-tie rule). Logs requests/s and tokens/s."""
    from neuronx_distributed_llama3_2_tpu_torch.inference.runner import (
        benchmark_serving_churn,
    )

    churn = prompts + prompts
    rep = benchmark_serving_churn(engine, prompts=churn, max_new_tokens=MAX_NEW,
                                  admit_every=DENSE_ADMIT_EVERY)
    outs = [rep["outputs"][i] for i in range(len(churn))]
    check(rep["compiled_under_traffic"] == 0,
          f"dense churn: {rep['compiled_under_traffic']} programs built under traffic")
    check(all(len(o) == MAX_NEW for o in outs), f"dense churn: lengths {list(map(len, outs))}")
    differ = same_streams("dense churn", model, churn, outs, dense_seqs + dense_seqs,
                          list(range(len(churn))))
    log(f"dense churn: {rep['n_requests']} requests over 8 slots, one admitted every "
        f"{DENSE_ADMIT_EVERY} steps: {rep['decode_steps']} steps, {rep['requests_per_s']:.6f} "
        f"requests/s, {rep['tokens_per_s']:.6f} tokens/s; programs {rep['programs_after_warmup']} "
        f"after the warm-up, {rep['programs_after_run']} after the run; streams equal to "
        f"generate()'s on {len(churn) - len(differ)} of {len(churn)} | {card}")


def host_perturbed(logits, key, sampling):
    """The values ``sample(logits, key, sampling)`` takes the argmax of, on
    the CPU: the gumbel noise of ``key`` over the whole (b, V) array plus
    the tempered, filtered logits. Returns ((b, V) perturbed, (b, V)
    tempered, (b,) cutoff)."""
    from neuronx_distributed_llama3_2_tpu_torch.inference.sampling import (
        filtered_logits,
        gumbel,
    )

    b, v = logits.shape
    lf = logits.float().cpu()
    noise = gumbel(key.cpu().long()[None], b * v).reshape(b, v)
    filt = filtered_logits(lf, torch.full((b,), sampling.temperature),
                           torch.full((b,), sampling.top_k, dtype=torch.int32),
                           torch.full((b,), sampling.top_p))
    cutoff = torch.where(torch.isfinite(filt), filt, torch.full_like(filt, float("inf")))
    return noise + filt, lf / sampling.temperature, cutoff.amin(dim=-1)


def run_dense_sampled_phase(engine, model, prompts, card: str) -> None:
    """generate() at SAMPLED (temperature 0.8, top-p 0.95) with seed
    DENSE_SEED: the streams at on_device_steps 1 and 8 equal (each sampled
    step splits the resident key inside its graph, in the per-token
    loop's order). Then ``sample`` on the card against ``sample`` on a CPU
    copy of the same logits (the model's own, 8 rows) and keys (16 splits
    of one chain): the draws equal, a difference allowed only where the
    top two perturbed values lie within SAMPLER_TIE relative."""
    from neuronx_distributed_llama3_2_tpu_torch.inference.sampling import key, sample, split

    sampled = sampling_config(**SAMPLED)
    runs = {steps: dense_generate(engine, prompts, steps, sampled, DENSE_SEED)
            for steps in DENSE_STEPS}
    check(runs[8]["seqs"] == runs[1]["seqs"],
          "dense sampled: the streams at on_device_steps 8 differ from 1's")
    check(runs[1]["after"] == runs[1]["first"], "dense sampled: programs built after the "
          "first token")
    greedy = dense_generate(engine, prompts, 1)["seqs"]
    differs_from_greedy = sum(a != b for a, b in zip(runs[1]["seqs"], greedy))
    check(differs_from_greedy > 0, "dense sampled: the sampled streams are the greedy ones")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 18)
    ids = torch.randint(0, model.config.vocab_size, (8, 64), device="cuda", generator=gen)
    with torch.no_grad():
        logits = model(ids)[:, -1].float()
    k = key(DENSE_SEED, device="cuda")
    equal, ties = 0, []
    for _ in range(16):
        keys = split(k)
        k, sub = keys[0], keys[1]
        got = sample(logits, sub, sampled).cpu()
        want = sample(logits.cpu(), sub.cpu(), sampled)
        pert, _, _ = host_perturbed(logits, sub, sampled)
        for row in torch.nonzero(got != want).flatten().tolist():
            top2 = torch.topk(pert[row], 2).values
            rel = ((top2[0] - top2[1]) / top2.abs().max()).item()
            ties.append(rel)
            check(rel <= SAMPLER_TIE, f"dense sampled: row {row} drew {got[row]} on the card, "
                  f"{want[row]} on the CPU, top two perturbed values {rel:.3g} apart")
        equal += int((got == want).sum())
    (ms,), ev = device_ms(lambda i: sample(logits, sub, sampled), iters=10, windows=3)
    for steps, r in runs.items():
        rep = r["report"]
        log(f"dense sampled (on_device_steps {steps}, {SAMPLED}, seed {DENSE_SEED}): "
            f"TTFT p50 {rep['ttft']['p50_ms']:.6f} ms, TPOT p50 "
            f"{rep['per_token']['p50_ms']:.6f} ms; {differs_from_greedy} of "
            f"{len(prompts)} streams differ from the greedy ones | {card}")
    log(f"dense sampled: streams equal at on_device_steps 1 and 8; sample() on the card = "
        f"CPU on {equal} of {16 * 8} draws, near ties {ties}; one (8, "
        f"{model.config.vocab_size}) draw {ms:.6f} ms of device time ({ev:.6f} ms by "
        f"events) | {card}")


def shallow_model(model, n_layers: int):
    """A LlamaForCausalLM over ``model``'s first ``n_layers`` layers, its
    embedding and its final norm: the same tensors, no copy."""
    import copy

    d = copy.copy(model)
    d._modules = dict(model._modules)
    d.layers = torch.nn.ModuleList(list(model.layers)[:n_layers])
    d.config = dataclasses.replace(model.config, num_layers=n_layers)
    return d


def run_spec_draft_phase(cfg, model, prompts, dense_seqs: list, card: str) -> None:
    """SpeculativeDecoder with the 1B's first SPEC_DRAFT_LAYERS layers as
    the draft (shared tensors) and gamma SPEC_GAMMA, one B = 1 engine
    each, over Serve's prompts: every stream the target's greedy
    generate() stream (the near-tie rule). Logs the mean accepted tokens
    a round and tokens/s."""
    from neuronx_distributed_llama3_2_tpu_torch.inference import SpeculativeDecoder

    draft_model = shallow_model(model, SPEC_DRAFT_LAYERS)
    check(draft_model.layers[0] is model.layers[0]
          and draft_model.embed is model.embed, "spec draft: the draft copied the weights")
    target = dense_engine(cfg, model, max_batch=1)
    draft = dense_engine(draft_model.config, draft_model, max_batch=1)
    spec = SpeculativeDecoder(target, draft, gamma=SPEC_GAMMA)
    outs, accepted = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for p in prompts:
        res = spec.generate(p, MAX_NEW)
        outs.append(res.tokens)
        accepted += res.accepted_per_round
    wall = time.perf_counter() - t0
    check(all(len(o) == MAX_NEW for o in outs), f"spec draft: lengths {list(map(len, outs))}")
    differ = same_streams("spec draft", model, prompts, outs, dense_seqs,
                          list(range(len(prompts))))
    log(f"spec draft ({SPEC_DRAFT_LAYERS}-layer draft sharing the target's tensors, gamma "
        f"{SPEC_GAMMA}): {len(accepted)} rounds, mean accepted {np.mean(accepted):.6f}; "
        f"{sum(map(len, outs))} tokens in {wall:.6f} s (captures included); streams equal "
        f"to generate()'s on {len(prompts) - len(differ)} of {len(prompts)} | {card}")
    del spec, target, draft
    gc.collect()
    torch.cuda.empty_cache()


def run_medusa_phase(cfg, model, prompts, dense_seqs: list, card: str) -> None:
    """MedusaDecoder with three seeded random heads (bf16) and the default
    tree over a B = 1 engine: every stream the greedy generate() stream
    (the near-tie rule). Logs the mean accepted tokens a round."""
    from neuronx_distributed_llama3_2_tpu_torch.inference.medusa import (
        MedusaDecoder,
        MedusaHeads,
    )

    engine = dense_engine(cfg, model, max_batch=1)
    heads = MedusaHeads(cfg.hidden_size, cfg.vocab_size, 3, dtype=cfg.dtype,
                        device="cuda").init_weights(SEED + 18)
    dec = MedusaDecoder(engine, heads)
    outs, accepted = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for p in prompts:
        res = dec.generate(p, MAX_NEW)
        outs.append(res.tokens)
        accepted += res.accepted_per_round
    wall = time.perf_counter() - t0
    check(all(len(o) == MAX_NEW for o in outs), f"medusa: lengths {list(map(len, outs))}")
    differ = same_streams("medusa", model, prompts, outs, dense_seqs, list(range(len(prompts))))
    log(f"medusa (3 random heads, tree of {dec.buffers.tree_len} nodes): {len(accepted)} "
        f"rounds, mean accepted {np.mean(accepted):.6f}; {sum(map(len, outs))} tokens in "
        f"{wall:.6f} s; streams equal to generate()'s on {len(prompts) - len(differ)} of "
        f"{len(prompts)} | {card}")
    del dec, engine, heads
    gc.collect()
    torch.cuda.empty_cache()


@contextlib.contextmanager
def host_draw_spy(server, draws: list):
    """Record each host-sampled draw of ``server`` (an eager one: the spy
    reads the key back): ``(key (2,), (b, V), {row: (rid, index of the
    token in its stream)})``. A (1, V) draw is the admission prefill of
    the one active request with no token yet; a (b, V) draw is a decode
    step over the decoding lanes."""
    from neuronx_distributed_llama3_2_tpu_torch.serving import engine as serving_engine

    inner = serving_engine.sample

    def spy(logits, key, cfg):
        out = inner(logits, key, cfg)
        if key is not None:
            if logits.shape[0] == 1:
                req = [r for r in server._active.values() if not r.out][-1]
                rows = {0: (req.rid, 0)}
            else:
                rows = {lane: (r.rid, len(r.out)) for lane, r in server._active.items()
                        if not r.prefilling}
            draws.append((key.detach().cpu(), tuple(logits.shape), rows))
        return out

    serving_engine.sample = spy
    try:
        yield
    finally:
        serving_engine.sample = inner


def host_sampled_differences(model, prompts, outs: list, want: list, rids, draws: list,
                             sampling) -> list:
    """Where one of ``outs`` differs from ``want`` (prompt order), the first
    token that differs, and how near a tie it is under the plain forward
    with the key ``want``'s draw used (``draws`` of ``host_draw_spy``):
    the two tokens' perturbed values (gumbel of the whole draw + tempered
    logit), or one of them and the top-p cutoff. Returns [(request, token,
    tie)]."""
    where = {}
    for key, shape, rows in draws:
        for row, (rid, idx) in rows.items():
            where[rid, idx] = (key, shape, row)
    out = []
    for j, (o, w) in enumerate(zip(outs, want)):
        i = first_difference(o, w)
        if i is None:
            continue
        key, (b, v), row = where[rids[j], i]
        with torch.no_grad():
            logits = model(torch.as_tensor([prompts[j] + o[:i]], device="cuda"))[0, -1:].float()
        full = torch.zeros((b, v))
        full[row] = logits[0].cpu()
        pert, x, cutoff = host_perturbed(full, key, sampling)
        a, c = o[i], w[i]
        tie = min(abs(pert[row, a] - pert[row, c]).item(), abs(x[row, a] - cutoff[row]).item(),
                  abs(x[row, c] - cutoff[row]).item())
        out.append((j, i, tie))
    return out


@contextlib.contextmanager
def capture_leaves_key_advanced():
    """A planted fault in the paged engine's capture: the warm-up's split of
    the host-sampling key is left in place (the key one split ahead after
    each capture)."""
    from neuronx_distributed_llama3_2_tpu_torch.serving.engine import PagedServingEngine

    inner = PagedServingEngine._capture

    def planted(self, fn):
        out = inner(self, fn)
        self._draw_key(self.gen.sampling)
        return out

    PagedServingEngine._capture = planted
    try:
        yield
    finally:
        PagedServingEngine._capture = inner


def run_host_sampled_graph_phase(cfg, model, prompts, card: str) -> None:
    """Serve's config host-sampled (SAMPLED, no on_device_sampling),
    prewarmed, against the eager host-sampled serve: every program splits
    the engine's resident key where the JAX engine splits its key, inside
    the graph on the twin, so the streams are equal token for token (a
    first difference must be a near tie under the plain forward with the
    eager draw's key). The twin: no capture after the freeze, 0 uploads a
    steady step, K4 launched by the captures only (every call in the serve
    a replay), the audit clean and no leak. A planted twin whose captures
    leave the key advanced must fail the stream check."""
    from neuronx_distributed_llama3_2_tpu_torch.kernels import paged_attention as pa

    sampled = sampling_config(**SAMPLED)
    limit = LOGIT_MARGIN / sampled.temperature
    draws: list = []
    eager = make_server(cfg, model, sampling=sampled)
    with host_draw_spy(eager, draws):
        e_rids = [eager.submit(p) for p in prompts]
        e_outs = eager.run_to_completion()
    want = [e_outs[r] for r in e_rids]
    check(eager.metrics.host_sample_fallbacks > 0 and eager.metrics.sampled_steps == 0,
          f"sampled-host: eager sampled_steps {eager.metrics.sampled_steps}, "
          f"host_sample_fallbacks {eager.metrics.host_sample_fallbacks}")
    check(len(draws) == eager.metrics.decode_steps + len(prompts),
          f"sampled-host: {len(draws)} draws for {eager.metrics.decode_steps} decode steps and "
          f"{len(prompts)} prefills")
    del eager
    counters = {"t1": pa.t1_launches, "tile": pa.tile_launches, "all": pa.launches}
    for c in counters.values():
        c.reset()
    t0 = time.perf_counter()
    twin = make_server(cfg, model, sampling=sampled, prewarm=True)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    captured = {src: c.count for src, c in counters.items()}
    m = twin.metrics
    registry = twin.program_registry()
    check(list(registry) == twin.catalog.graph_keys()
          and all(r.graph is not None for r in registry.values())
          and not any("lane" in map(str, k) for k in registry),
          f"sampled-host: registry {sorted(map(str, registry))}")
    rids = [twin.submit(p) for p in prompts]
    t0 = time.perf_counter()
    outs, uploads = steady_upload_steps(twin)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats = serve_stats(twin, rids, outs, wall)
    served = [outs[r] for r in rids]
    eager_calls = {src: c.count - captured[src] for src, c in counters.items()}
    check(m.steadystate_compiles == 0, f"sampled-host: {m.steadystate_compiles} captures "
          "after the freeze")
    check(len(uploads) > 0 and not any(uploads),
          f"sampled-host: the twin's steady steps uploaded {uploads}")
    check(captured["t1"] > 0 and not any(eager_calls.values()),
          f"sampled-host: K4 launches captured {captured}, during the serve {eager_calls}")
    check(m.compute_dispatches == sum(r.replays for r in registry.values()),
          f"sampled-host: {m.compute_dispatches} dispatches, "
          f"{sum(r.replays for r in registry.values())} replays")
    check_clean_engine("sampled-host twin", twin)
    differ = host_sampled_differences(model, prompts, served, want, rids, draws, sampled)
    for j, i, tie in differ:
        log(f"sampled-host: request {j} first differs at token {i}; perturbed plain-forward "
            f"values {tie:.6g} apart (near-tie limit {limit:.6g})")
        check(tie <= limit, f"sampled-host: request {j} differs at token {i}, not a near tie")
    greedy_like = sum(len(set(s)) == 1 for s in served)
    del twin, registry
    gc.collect()
    torch.cuda.empty_cache()
    with capture_leaves_key_advanced():
        bad = make_server(cfg, model, sampling=sampled, prewarm=True)
    b_rids = [bad.submit(p) for p in prompts]
    b_outs = bad.run_to_completion()
    bad_differ = host_sampled_differences(model, prompts, [b_outs[r] for r in b_rids], want,
                                          b_rids, draws, sampled)
    del bad
    gc.collect()
    torch.cuda.empty_cache()
    check(any(tie > limit for _, _, tie in bad_differ),
          f"sampled-host: the stream check passes a twin whose captures leave the key "
          f"advanced ({bad_differ})")
    log(f"graph serve sampled-host ({SAMPLED}, host sampling on the JAX key chain): "
        f"{m.prewarm_compiles} keys captured in {capture_s:.6f} s; streams equal to the eager "
        f"host-sampled serve's on {len(prompts) - len(differ)} of {len(prompts)} requests; "
        f"{len(draws)} draws recorded; steadystate_compiles {m.steadystate_compiles}; "
        f"{len(uploads)} steady steps, h2d_uploads a steady step {max(uploads)}; K4 launches "
        f"captured {captured}, during the serve {eager_calls}; {greedy_like} streams of one "
        f"token; TTFT p50 {stats['ttft']:.6f} ms, TPOT p50 {stats['tpot']:.6f} ms, "
        f"{stats['tokens_s']:.6f} tokens/s | {card}")
    log(f"sampled-host planted fault (captures leave the key advanced): "
        f"{len(bad_differ)} of {len(prompts)} requests differ, first-difference ties "
        f"{[round(t, 6) for _, _, t in bad_differ]} (limit {limit:.6g})")


# -- 4j. tensor parallelism -----------------------------------------------------------
#
# The card is one: NCCL refuses two ranks on one device, so NCCL runs at world
# size 1 (every tp region issuing its collective over a group of one rank,
# the prewarmed twin capturing them), and tp = 2 runs as two processes on the
# card over gloo, which carries every collective the port issues on CUDA
# tensors (PERF.md section 6) but cannot be captured in a CUDA graph:
# those serves run eagerly. Times over gloo are gloo's (host copies), not
# NCCL's.

#: the tp = 2 serve's KV pool on each rank: 2049 blocks x 16 rows x 4 of the
#: 1B's 8 kv heads x 64 x 2 bytes x 16 layers x K and V
TP_POOL_BYTES = 537133056
#: the tp = 2 train phase's layer whose row-parallel o-projection skips its
#: all-reduce (the planted fault, ``without_tp_reduce``)
TP_FAULT_LAYER = 8


@contextlib.contextmanager
def without_tp_reduce(layer):
    """A planted fault: ``layer``, a ``RowParallelLinear``, returns its
    rank's partial product without the tp all-reduce."""
    layer.forward = lambda x: x @ layer.kernel
    try:
        yield
    finally:
        del layer.forward


@contextlib.contextmanager
def without_zero1_gather():
    """A planted fault: the train step skips ZeRO-1's all-gather and
    broadcast of the updated parts, so each dp rank keeps the old values
    of the parts it does not update."""
    from neuronx_distributed_llama3_2_tpu_torch.trainer import trainer as tr

    inner = tr.zero1_gather_params
    tr.zero1_gather_params = lambda params, parts: None
    try:
        yield
    finally:
        tr.zero1_gather_params = inner


def run_tp_nccl_phase(prompts, eager_outs: list, card: str) -> dict:
    """World size 1 on NCCL through the tp code path: a mesh of one rank,
    the 1B built under it (its row-parallel layers all-reduce, its LM head
    all-gathers, each a one-rank NCCL collective), Serve's config eagerly
    and as a prewarmed twin (``run_graph_phase``: the single-device eager
    serve's streams under the near-tie rule, ``steadystate_compiles`` 0,
    K4 launched only by replays). The collectives must run in the eager
    serve and be captured in the twin's graphs, none issued outside a
    replay during its serve. The process group and the mesh are taken down
    after."""
    import torch.distributed as dist

    from neuronx_distributed_llama3_2_tpu_torch.parallel import multihost
    from neuronx_distributed_llama3_2_tpu_torch.parallel import state as ps

    multihost.initialize_distributed(device="cuda")
    check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
          f"tp nccl: backend {dist.get_backend()}, world {dist.get_world_size()}")
    ps.initialize_model_parallel(tensor_model_parallel_size=1, device="cuda")
    try:
        cfg, model = load_model()
        server = make_server(cfg, model)
        c0 = collective_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rids = [server.submit(p) for p in prompts]
        outs = server.run_to_completion()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        eager = counts_since(c0)
        stats = serve_stats(server, rids, outs, wall)
        del server
        differ = same_streams("tp nccl eager", model, prompts, [outs[r] for r in rids],
                              eager_outs, rids)
        steps = cfg.num_layers * 2  # o and down of every layer, a forward
        check(eager.get("all_reduce", 0) >= steps and eager.get("all_gather", 0) > 0,
              f"tp nccl eager: collectives {eager}")
        log(f"tp nccl eager: world 1 over NCCL, {len(rids)} requests, "
            f"{sum(len(outs[r]) for r in rids)} tokens in {wall:.6f} s = "
            f"{stats['tokens_s']:.6f} tokens/s; TTFT p50 {stats['ttft']:.6f} ms, TPOT p50 "
            f"{stats['tpot']:.6f} ms; streams equal to the single-device serve's on "
            f"{len(rids) - len(differ)} of {len(rids)}; collectives issued {eager} | {card}")
        twin = run_graph_phase(cfg, model, "tp nccl", prompts, eager_outs, card,
                               lambda o, r: e2e_gaps(model, prompts, o, r)[0],
                               E2E_LOGIT_MARGIN)
        cap, during = twin["collectives_captured"], twin["collectives_serve"]
        check(cap.get("all_reduce", 0) >= steps and cap.get("all_gather", 0) > 0,
              f"tp nccl twin: collectives captured {cap}")
        check(not during, f"tp nccl twin: collectives issued outside a replay {during}")
        del model
        gc.collect()
        torch.cuda.empty_cache()
        return dict(eager=stats, twin=twin, captured=cap)
    finally:
        ps.destroy_model_parallel()
        dist.destroy_process_group()


def tp_spawn(body, *args) -> list:
    """``body(rank, 2, *args)`` on two ranks on the card over gloo
    (``multihost.spawn_gloo_ranks``), joined through a file under the
    phases' scratch directory; their results by rank. A rank that fails
    fails the run."""
    from neuronx_distributed_llama3_2_tpu_torch.parallel.multihost import spawn_gloo_ranks

    os.makedirs(work_dir(), exist_ok=True)
    return spawn_gloo_ranks(body, 2, *args, device="cuda", tmp_dir=str(work_dir()))


def rank_log(rank: int, *parts) -> None:
    if rank == 0:
        log(*parts)


def heads_of_rank0_kv(cfg, model):
    """The planted fault of the tp serve: a copy of the model whose rank 1
    projects rank 0's kv heads (its q heads its own), so that its pool, and
    the K4 that reads it, hold the other rank's head slice."""
    from neuronx_distributed_llama3_2_tpu_torch.models.llama import LlamaForCausalLM
    from neuronx_distributed_llama3_2_tpu_torch.parallel import state as ps

    fault = LlamaForCausalLM(cfg, device="cuda")
    if ps.get_tensor_model_parallel_rank() == 1:
        for layer in fault.layers:
            layer.attn.qkv.tp_rank = 0  # the weights drawn are rank 0's slices
    fault.init_weights(SEED)
    with torch.no_grad():
        for mine, bad in zip(model.layers, fault.layers):
            bad.attn.qkv.tp_rank = mine.attn.qkv.tp_rank
            bad.attn.qkv.q_kernel.copy_(mine.attn.qkv.q_kernel)
    return fault


def beyond_near_tie(model, prompts, outs: list, want: list) -> list:
    """(request, token, tie) of each request whose first difference from
    ``want`` is not a near tie under the plain forward (``same_streams``'
    rule, without its check)."""
    bad = []
    for j, (o, w) in enumerate(zip(outs, want)):
        i = first_difference(o, w)
        if i is None:
            continue
        logits = model(torch.as_tensor([prompts[j] + o[:i]], device="cuda"))[0, -1].float()
        tie = abs(logits[o[i]] - logits[w[i]]).item()
        if tie > LOGIT_MARGIN:
            bad.append((j, i, tie))
    return bad


def tp_serve_rank(rank: int, nproc: int, prompts, want: list, card: str) -> dict:
    """A rank of the tp = 2 serve: the 1B at full width and depth under a
    tp = 2 mesh, Serve's eight prompts eagerly, K4 on this rank's 16 q / 4
    kv heads (the served calls recorded); streams held to the tp = 1 eager
    serve's under the near-tie rule, and every served token teacher-forced
    through the tp = 2 model's plain forward within E2E_LOGIT_MARGIN of its
    argmax (``e2e_gaps``); the pool TP_POOL_BYTES; then the planted fault
    (rank 1's K4 reading rank 0's kv-head slice), which must read beyond a
    near tie and beyond the e2e margin. Rank 0 then holds K4 against its plain version
    at the served per-rank geometries (kernel-agreement limits) while rank
    1 waits."""
    import torch.distributed as dist

    from neuronx_distributed_llama3_2_tpu_torch.kernels import paged_attention as pa
    from neuronx_distributed_llama3_2_tpu_torch.parallel import state as ps

    ps.initialize_model_parallel(tensor_model_parallel_size=2, device="cuda")
    try:
        cfg, model = load_model()
        check(model.layers[0].attn.n_heads == 16 and model.layers[0].attn.n_kv_heads == 4,
              f"rank {rank}: heads {model.layers[0].attn.n_heads} / "
              f"{model.layers[0].attn.n_kv_heads}")
        warm = make_server(cfg, model)
        for p in prompts[:2]:
            warm.submit(p)
        warm.run_to_completion()
        del warm
        server = make_server(cfg, model)
        m = server.metrics
        pool = sum(x.nbytes for x in server._pool_tensors())
        check(m.tp_size == 2 and m.pool_bytes_per_rank == pool == TP_POOL_BYTES
              and 2 * m.pool_bytes_per_rank == m.pool_bytes_total,
              f"rank {rank}: tp_size {m.tp_size}, pool bytes {m.pool_bytes_per_rank} / "
              f"{pool} / {m.pool_bytes_total}")
        geoms: dict = {}
        for c in (pa.launches, pa.t1_launches, pa.tile_launches):
            c.reset()
        with model_kernel_call(recording(geoms, keep_positions=True)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rids = [server.submit(p) for p in prompts]
            outs = server.run_to_completion()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = dict(t1=pa.t1_launches.count, tile=pa.tile_launches.count,
                        all=pa.launches.count)
        stats = serve_stats(server, rids, outs, wall)
        paths = dict(server.model.attention_paths)
        del server
        check(paths.get("kernel", 0) == launches["all"] > 0 and not paths.get("gather"),
              f"rank {rank}: attention paths {paths}, K4 launches {launches}")
        streams = [outs[r] for r in rids]
        differ = same_streams(f"tp2 serve rank {rank}", model, prompts, streams, want, rids)
        gap, exact, total = e2e_gaps(model, prompts, outs, rids)
        rank_log(rank, f"tp2 serve e2e: {exact}/{total} served tokens are the tp = 2 plain "
                 f"forward's argmax; worst logit gap {gap:.6g} (margin {E2E_LOGIT_MARGIN})")
        check(gap <= E2E_LOGIT_MARGIN, f"tp2 serve: a served token is {gap} below the argmax logit")
        both = [None, None]
        dist.all_gather_object(both, streams)
        check(both[0] == both[1], "tp2 serve: the two ranks' streams differ")
        rank_log(rank, f"tp2 serve: two ranks over gloo on one card, 16 q / 4 kv heads each, "
                 f"{len(rids)} requests, {sum(map(len, streams))} tokens in {wall:.6f} s = "
                 f"{stats['tokens_s']:.6f} tokens/s; TTFT p50 {stats['ttft']:.6f} ms, TPOT p50 "
                 f"{stats['tpot']:.6f} ms (gloo's collectives: host copies); streams equal "
                 f"to the tp = 1 eager serve's on {len(rids) - len(differ)} of {len(rids)}, "
                 f"the ranks' equal; pool {TP_POOL_BYTES} B a rank; K4 launches {launches} "
                 f"| {card}")
        for (b, t, kv_limit, splits, w), e in sorted(geoms.items()):
            rank_log(rank, f"tp2 serve: K4 geometry b={b} t={t} kv_limit={kv_limit} "
                     f"num_splits={splits} W={w}: {e['calls']} launches a rank")

        # the planted fault: rank 1's K4 reads rank 0's kv-head slice
        fault = heads_of_rank0_kv(cfg, model)
        server = make_server(cfg, fault)
        rids = [server.submit(p) for p in prompts]
        f_outs = server.run_to_completion()
        del server, fault
        bad = beyond_near_tie(model, prompts, [f_outs[r] for r in rids], want)
        bad_gap, bad_exact, bad_total = e2e_gaps(model, prompts, f_outs, rids)
        rank_log(rank, f"tp2 serve planted fault (rank 1's K4 reads rank 0's kv-head slice): "
                 f"{len(bad)} of {len(rids)} requests differ beyond a near tie {bad[:3]}; "
                 f"{bad_exact}/{bad_total} served tokens the argmax, worst logit gap {bad_gap:.6g} "
                 f"(margin {E2E_LOGIT_MARGIN})")
        check(bool(bad), "the tp2 stream check passes a rank reading the other's head slice")
        check(bad_gap > E2E_LOGIT_MARGIN,
              f"the tp2 e2e check passes a rank reading the other's head slice ({bad_gap})")

        records = None
        if rank == 0:
            served = {k: dict(calls=e["calls"], positions=median_call(e["positions"]))
                      for k, e in geoms.items()}
            rank_cfg = dataclasses.replace(cfg, num_heads=16, num_kv_heads=4)
            records, _ = run_paged_kernel_phase(rank_cfg, served, card, grid=False,
                                                probes=False)
            for src in records:
                records[src]["launches"] = launches[src]
        dist.barrier()
        del model
        gc.collect()
        torch.cuda.empty_cache()
        return dict(streams=streams, stats=stats, launches=launches, records=records)
    finally:
        ps.destroy_model_parallel()


def rel_l2_parts(grads: dict, ref: dict, specs: dict) -> dict:
    """Per parameter, (squared error, squared reference) of this rank's
    gradient against its slice of the tp = 1 gradient, a tp-replicated
    leaf counted on tp rank 0 alone, so that the sums over the ranks are
    the gathered gradient's."""
    from neuronx_distributed_llama3_2_tpu_torch.parallel import state as ps
    from neuronx_distributed_llama3_2_tpu_torch.parallel.layout import mesh_coords, port_slice

    coords = mesh_coords()
    out = {}
    for name, g in grads.items():
        leaf = specs[name]
        layer = int(name.split(".")[1]) if leaf.stacked else None
        _, index = port_slice(leaf, coords, layer)
        r = ref[name][index].float()
        own = ps.get_tensor_model_parallel_rank() == 0 or leaf.mentions("tp")
        err = ((g.float() - r).square().sum().item(), r.square().sum().item())
        out[name] = err if own else (0.0, 0.0)
    return out


def gathered_gap(parts: dict) -> tuple:
    """The largest per-parameter relative L2 error of the gradient
    gathered over the ranks (``rel_l2_parts`` summed over them)."""
    import torch.distributed as dist

    names = sorted(parts)
    t = torch.tensor([parts[n] for n in names], dtype=torch.float64)
    dist.all_reduce(t)
    errs = (t[:, 0] / t[:, 1].clamp_min(1e-30)).sqrt()
    i = int(errs.argmax())
    return errs[i].item(), names[i]


def tp_train_rank(rank: int, nproc: int, card: str) -> dict:
    """A rank of the tp train phase (bench's config, the 1B, flash on,
    batch 2 x 2048, remat full). First the tp = 1 step's loss and
    gradients (no mesh); then at tp = 2 one step's loss and gradients,
    gathered, within the train bands of them, K1 / K2 / K3 launched 32 / 16
    / 16 times at 16 q / 4 kv heads; a layer whose o-projection skips its
    all-reduce must fall outside the bands; the same step under sequence
    parallelism within the bands too; rank 0 holds K1-K3 against
    their plain versions at the rank's shape. Then dp = 2 with ZeRO-1
    (fp32 master, mu, nu): one train step, its loss within the loss band
    of the tp = 1 loss and its grad norm within the gradient band of the
    tp = 1 norm; each rank's fp32 state bytes half the dp = 1 bytes; the
    update of its master parts and of its gathered parameters within the
    gradient band of the same step at dp = 1 (``zero1_update_gap``); and
    a step that skips the gather of the updated parts outside it."""
    import torch.distributed as dist

    from neuronx_distributed_llama3_2_tpu_torch.kernels import flash_attention as fa
    from neuronx_distributed_llama3_2_tpu_torch.models.llama import LlamaForCausalLM, param_specs
    from neuronx_distributed_llama3_2_tpu_torch.parallel import state as ps
    from neuronx_distributed_llama3_2_tpu_torch.trainer import (
        OptimizerConfig,
        TrainingConfig,
        initialize_parallel_model,
        make_train_step,
    )
    from neuronx_distributed_llama3_2_tpu_torch.trainer.optimizer import state_bytes, zero1_parts

    cfg, _ = train_configs()
    batch = train_batch(cfg, E2E_BATCH)
    ref_model = LlamaForCausalLM(cfg, device="cuda").init_weights(SEED)
    ref_loss, ref_grads = loss_and_grads(ref_model, batch)
    ref_norm = torch.sqrt(sum(g.float().square().sum() for g in ref_grads.values())).item()
    n_params = sum(p.numel() for p in ref_model.parameters())
    del ref_model
    torch.cuda.empty_cache()

    ps.initialize_model_parallel(tensor_model_parallel_size=2, device="cuda")
    try:
        model = LlamaForCausalLM(cfg, device="cuda").init_weights(SEED)
        specs = param_specs(cfg)
        for c in (fa.fwd_launches, fa.bwd_dq_launches, fa.bwd_dkv_launches):
            c.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, grads = loss_and_grads(model, batch)
        step_ms = (time.perf_counter() - t0) * 1e3
        launches = flash_counts()
        check(launches == STEP_LAUNCHES,
              f"tp2 train rank {rank}: (K1, K2, K3) launches {launches}, want {STEP_LAUNCHES}")
        gap, at = gathered_gap(rel_l2_parts(grads, ref_grads, specs))
        loss_gap = abs(loss - ref_loss)
        rank_log(rank, f"tp2 train: two ranks over gloo on one card, 16 q / 4 kv heads each, "
                 f"loss {loss:.6f} against {ref_loss:.6f} at tp = 1 (gap {loss_gap:.6g}, band "
                 f"{LOSS_BAND}); the gathered gradient's largest relative L2 error {gap:.6g} at "
                 f"{at} (band {GRAD_BAND}); forward and backward {step_ms:.6f} ms (gloo's "
                 f"collectives); (K1, K2, K3) launches {launches} a rank | {card}")
        check(np.isfinite(loss) and loss_gap <= LOSS_BAND, f"tp2 train loss gap {loss_gap}")
        check(gap <= GRAD_BAND, f"tp2 train gradient gap {gap} at {at}")
        del grads
        with without_tp_reduce(model.layers[TP_FAULT_LAYER].attn.o):
            bad_loss, bad_grads = loss_and_grads(model, batch)
        bad_gap, bad_at = gathered_gap(rel_l2_parts(bad_grads, ref_grads, specs))
        del bad_grads
        rank_log(rank, f"tp2 train planted fault (layer {TP_FAULT_LAYER}'s o-projection skips "
                 f"its all-reduce): loss gap {abs(bad_loss - ref_loss):.6g}, gradient "
                 f"{bad_gap:.6g} at {bad_at} (bands {LOSS_BAND}, {GRAD_BAND})")
        check(abs(bad_loss - ref_loss) > LOSS_BAND or bad_gap > GRAD_BAND,
              "the tp2 train bands pass a row-parallel layer without its all-reduce")
        del model
        gc.collect()
        torch.cuda.empty_cache()
        # Megatron sequence parallelism: the norms and residual adds on
        # sequence shards, attention on the all-gathered sequence
        ps.destroy_model_parallel()
        ps.initialize_model_parallel(tensor_model_parallel_size=2, sequence_parallel=True,
                                     device="cuda")
        model = LlamaForCausalLM(cfg, device="cuda").init_weights(SEED)
        check(model.sequence_parallel, "tp2 sp: the model runs without sequence parallelism")
        sp_loss, sp_grads = loss_and_grads(model, batch)
        sp_gap, sp_at = gathered_gap(rel_l2_parts(sp_grads, ref_grads, specs))
        del model, sp_grads
        gc.collect()
        torch.cuda.empty_cache()
        rank_log(rank, f"tp2 sp train: loss {sp_loss:.6f} (gap {abs(sp_loss - ref_loss):.6g}), "
                 f"the gathered gradient's largest relative L2 error {sp_gap:.6g} at {sp_at} "
                 f"(bands {LOSS_BAND}, {GRAD_BAND}) | {card}")
        check(abs(sp_loss - ref_loss) <= LOSS_BAND and sp_gap <= GRAD_BAND,
              f"tp2 sp train: loss gap {abs(sp_loss - ref_loss)}, gradient {sp_gap} at {sp_at}")
        flash = None
        if rank == 0:
            flash = run_flash_kernel_phase(card, cases=(
                ("tp2 rank, train causal", E2E_BATCH, 16, 4, TRAIN_SEQ, 64, True, 10),))
        dist.barrier()
    finally:
        ps.destroy_model_parallel()

    # dp = 2, ZeRO-1, against the same step at dp = 1 from the same weights
    del ref_grads
    gc.collect()
    torch.cuda.empty_cache()
    opt = OptimizerConfig(zero_one_enabled=True, warmup_steps=1, use_master_weights=True,
                          state_dtype="float32")
    before, ref_master, ref_dp_loss = dp1_step(cfg, batch, opt)
    tc = TrainingConfig(optimizer=opt)
    tc.initialize("cuda")
    try:
        model = LlamaForCausalLM(cfg, device="cuda")
        state, state_specs = initialize_parallel_model(model, tc, key=SEED)
        parts = zero1_parts(state_specs.opt)
        held = state_bytes(state.opt)
        whole = 3 * 4 * n_params
        step = make_train_step(model, tc)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        dp_loss = float(m["loss"])
        dp_ms = (time.perf_counter() - t0) * 1e3
        norm_gap = abs(float(m["grad_norm"]) - ref_norm) / ref_norm
        upd = zero1_update_gap(state, parts, before, ref_master)
        rank_log(rank, f"tp dp2 zero1: loss {dp_loss:.6f} against {ref_loss:.6f} at dp = 1 "
                 f"(gap {abs(dp_loss - ref_loss):.6g}), grad norm {float(m['grad_norm']):.6f} "
                 f"against {ref_norm:.6f} (relative {norm_gap:.6g}); fp32 state bytes a rank "
                 f"{held} of {whole} at dp = 1 ({held / whole:.6f}); the step {dp_ms:.6f} ms "
                 f"(gloo's reduce-scatter and all-gather) | {card}")
        rank_log(rank, f"tp dp2 zero1 update: against the dp = 1 step (two microbatches of a "
                 f"row, loss {ref_dp_loss:.6f}), the update's relative L2 error {upd[0]:.6g} "
                 f"over the ranks' fp32 master parts and {upd[1]:.6g} over their gathered "
                 f"parameters, the largest a leaf {upd[3]:.6g} at {upd[2]} (band {GRAD_BAND})")
        check(abs(dp_loss - ref_loss) <= LOSS_BAND and norm_gap <= GRAD_BAND,
              f"dp2 zero1: loss {dp_loss} / {ref_loss}, norm gap {norm_gap}")
        check(0.45 <= held / whole <= 0.55, f"dp2 zero1: state bytes {held} of {whole}")
        check(max(upd[:2]) <= GRAD_BAND, f"dp2 zero1: update gaps {upd}")
        # the planted fault: the same step without the all-gather and the
        # broadcast of the updated parts
        del state
        gc.collect()
        torch.cuda.empty_cache()
        state, _ = initialize_parallel_model(model, tc, key=SEED)
        with without_zero1_gather():
            state, _ = step(state, batch)
        bad = zero1_update_gap(state, parts, before, ref_master)
        rank_log(rank, f"tp dp2 zero1 planted fault (the updated parts neither all-gathered "
                 f"nor broadcast): the update's relative L2 error {bad[0]:.6g} over the "
                 f"master parts, {bad[1]:.6g} over the parameters (band {GRAD_BAND})")
        check(max(bad[:2]) > GRAD_BAND,
              f"the dp2 zero1 update check passes a step that skips the gather ({bad})")
        del model, state, step, before, ref_master
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        ps.destroy_model_parallel()
    return dict(launches=launches, flash=flash, state_ratio=held / whole)


def dp1_step(cfg, batch, opt) -> tuple:
    """The dp = 1 step ZeRO-1 at dp = 2 must reproduce, with no mesh: the
    weights of SEED, the batch's two rows as two microbatches of one row
    (each dp = 2 rank's row), their gradients summed in fp32 as the dp = 2
    ranks' are. Returns (the parameters before it, the fp32 master after
    it, its loss)."""
    from neuronx_distributed_llama3_2_tpu_torch.models.llama import LlamaForCausalLM
    from neuronx_distributed_llama3_2_tpu_torch.trainer import (
        TrainingConfig,
        initialize_parallel_model,
        make_train_step,
    )

    model = LlamaForCausalLM(cfg, device="cuda")
    tc = TrainingConfig(num_microbatches=2,
                        optimizer=dataclasses.replace(opt, zero_one_enabled=False))
    state, _ = initialize_parallel_model(model, tc, key=SEED)
    before = {k: p.detach().clone() for k, p in state.params.items()}
    state, m = make_train_step(model, tc)(state, batch)
    loss = float(m["loss"])
    master = state.opt.master
    del model, state
    gc.collect()
    torch.cuda.empty_cache()
    return before, master, loss


def zero1_update_gap(state, parts, before: dict, ref_master: dict) -> tuple:
    """How far a dp = 2 ZeRO-1 step moved the weights from where the dp = 1
    step (``dp1_step``) moved them: the relative L2 error of the update
    (after minus ``before``) over every leaf, of the rank's fp32 master
    parts, and of its whole parameters (what the gather made of them), each
    summed over both ranks. Returns (master gap, parameter gap, the
    parameter whose own gap is largest, that gap)."""
    import torch.distributed as dist

    from neuronx_distributed_llama3_2_tpu_torch.trainer.optimizer import _part_of

    sums = torch.zeros(4, dtype=torch.float64)
    names = sorted(state.params)
    leaves = torch.zeros(len(names), 2, dtype=torch.float64)
    for i, k in enumerate(names):
        p, base, ref = state.params[k], before[k].float(), ref_master[k]
        ref_p = ref.to(p.dtype).float()
        leaves[i, 0] = (p.float() - ref_p).square().sum().item()
        leaves[i, 1] = (ref_p - base).square().sum().item()
        if k in state.opt.master:
            part = parts[k]
            ref_m = _part_of(ref, part)
            sums[0] += (state.opt.master[k] - ref_m).square().sum().item()
            sums[1] += (ref_m - _part_of(base, part)).square().sum().item()
    sums[2:] = leaves.sum(0)
    dist.all_reduce(sums)
    dist.all_reduce(leaves)
    own = (leaves[:, 0] / leaves[:, 1].clamp_min(1e-30)).sqrt()
    i = int(own.argmax())
    return ((sums[0] / sums[1]).sqrt().item(), (sums[2] / sums[3]).sqrt().item(),
            names[i], own[i].item())


def tp_serve_result(outs: list) -> dict:
    """The tp = 2 serve (``tp_serve_rank``'s results on two ranks): rank 0's
    K4 records at its served geometries and both ranks' launches."""
    check(outs[0]["streams"] == outs[1]["streams"], "tp2 serve: the ranks' streams differ")
    check(outs[0]["launches"] == outs[1]["launches"],
          f"tp2 serve: K4 launches {outs[0]['launches']} / {outs[1]['launches']}")
    return outs[0]


def tp_train_result(outs: list) -> dict:
    check(outs[0]["launches"] == outs[1]["launches"] == STEP_LAUNCHES,
          f"tp2 train: launches {outs[0]['launches']} / {outs[1]['launches']}")
    return outs[0]


# -- 6b. context parallelism ---------------------------------------------------------
#
# cp = 2 at tp = 1 as two processes on the card over gloo, whose
# point-to-point refuses CUDA tensors: the ring rotates by an all-gather over
# the cp group (``parallel.mappings.ring_transport``; PERF.md section 6, PR
# 21). Times over gloo are gloo's host copies.

CP_LAYOUTS = ("contiguous", "zigzag")
#: (K1, K2, K3) launches on (rank 0, rank 1) in one cp = 2 train step of the
#: 16-layer model under remat "full" (the forward twice, the backward once),
#: by layout. Contiguous: rank 0's visiting chunk is in the future, so it
#: runs only its resident causal chunk (1 forward and 1 backward pair a
#: layer); rank 1 runs its resident chunk and rank 0's, in the past (2
#: each). Zigzag: every rank runs its three resident half-chunk pairs (early
#: causal, late causal, late x early) and two a visit (5 each)
CP_LAUNCHES = {
    "contiguous": ((32, 16, 16), (64, 32, 32)),
    "zigzag": ((160, 80, 80), (160, 80, 80)),
}
#: K1-K3 at the ring's chunk shapes of the 1B at batch 2 x 2048, cp = 2:
#: contiguous chunks of 1024 (the resident causal call, the visiting full
#: one), zigzag half-chunks of 512 (the causal resident halves, the full
#: pairs); the planted tile faults run at each first case
CP_FLASH_CASES = {
    "contiguous": (("cp2 contiguous chunk, causal", E2E_BATCH, 32, 8, 1024, 64, True, 10),
                   ("cp2 contiguous chunk, full", E2E_BATCH, 32, 8, 1024, 64, False, 10)),
    "zigzag": (("cp2 zigzag half-chunk, causal", E2E_BATCH, 32, 8, 512, 64, True, 10),
               ("cp2 zigzag half-chunk, full", E2E_BATCH, 32, 8, 512, 64, False, 10)),
}


@contextlib.contextmanager
def step_gradients(read):
    """While the block runs, ``read(grads)`` sees the gradients each train
    step hands to AdamW: summed over cp (and dp), divided by the step's
    token count."""
    from neuronx_distributed_llama3_2_tpu_torch.trainer import trainer as tr

    inner = tr.apply_gradients

    def spy(state, grads, *args, **kwargs):
        read(grads)
        return inner(state, grads, *args, **kwargs)

    tr.apply_gradients = spy
    try:
        yield
    finally:
        tr.apply_gradients = inner


@contextlib.contextmanager
def visiting_chunk_dropped():
    """A planted fault: the kernel ring's merge keeps the running output,
    so every visiting chunk is left out of it (the contiguous ring merges
    nothing else)."""
    from neuronx_distributed_llama3_2_tpu_torch.kernels import ring_attention_pallas as rap

    inner = rap._merge
    rap._merge = lambda o1, lse1, o2, lse2: (o1, lse1)
    try:
        yield
    finally:
        rap._merge = inner


@contextlib.contextmanager
def home_hop_left_out(ring):
    """A planted fault in the backward of the kernel ring ``ring``
    (``_RingFlash`` or ``_ZigzagFlash``): the dk / dv accumulators stop one
    hop short of home (the last hop undone), so each rank takes its
    neighbour's dk / dv."""
    from neuronx_distributed_llama3_2_tpu_torch.parallel.mappings import ring_shift

    inner = ring.__dict__["backward"]

    def faulty(ctx, do):
        dq, dk, dv, *rest = inner.__func__(ctx, do)
        dkv = ring_shift(torch.stack((dk, dv)), ctx.group, -1)
        return (dq, dkv[0], dkv[1], *rest)

    ring.backward = staticmethod(faulty)
    try:
        yield
    finally:
        ring.backward = inner


@contextlib.contextmanager
def positions_in_contiguous_order(model):
    """A planted fault: under zigzag the tokens are permuted into the ring's
    layout but their positions (RoPE's) are cut in contiguous order."""
    inner = model._positions

    def faulty(b, s, plan, device):
        return inner(b, s, plan._replace(perm=None) if plan is not None else plan, device)

    model._positions = faulty
    try:
        yield
    finally:
        del model._positions


def cp_train_rank(rank: int, nproc: int, card: str) -> dict:
    """A rank of the cp = 2 train phase: the 1B at full width and depth,
    train_configs' step (flash attention, remat full, CE chunked at 256,
    AdamW bf16 state) on bench's batch cut to E2E_BATCH x 2048. Rank 0 takes
    the tp = 1 step's loss and gradients first (no mesh). Then through the
    trainer's entry points (``TrainingConfig(context_parallel_size=2)``,
    ``initialize_parallel_model``, ``make_train_step``), in each layout one
    step from SEED's weights: its loss within LOSS_BAND of the cp = 1 loss,
    the gradients it hands to AdamW (summed over cp) within GRAD_BAND
    (``grad_gap``), K1 / K2 / K3 launched as CP_LAUNCHES says on each rank;
    then the same step through a planted fault (contiguous: every visiting
    chunk left out of the merge; zigzag: the positions cut in contiguous
    order), which must fall outside the bands, and through the ring's
    backward with dk / dv one hop short of home, whose gradients must fall
    outside GRAD_BAND. Rank 0 then holds K1-K3
    against their plain versions at the ring's chunk shapes
    (CP_FLASH_CASES) while rank 1 waits."""
    import torch.distributed as dist

    from neuronx_distributed_llama3_2_tpu_torch.models.llama import LlamaForCausalLM
    from neuronx_distributed_llama3_2_tpu_torch.parallel import state as ps
    from neuronx_distributed_llama3_2_tpu_torch.parallel.mappings import ring_transport
    from neuronx_distributed_llama3_2_tpu_torch.kernels import flash_attention as fa
    from neuronx_distributed_llama3_2_tpu_torch.kernels import ring_attention_pallas as rap
    from neuronx_distributed_llama3_2_tpu_torch.trainer import (
        TrainingConfig,
        initialize_parallel_model,
        make_train_step,
    )

    cfg, tc1 = train_configs()
    batch = train_batch(cfg, E2E_BATCH)
    ref_loss = ref_grads = None
    if rank == 0:
        ref_model = LlamaForCausalLM(cfg, device="cuda").init_weights(SEED)
        ref_loss, ref_grads = loss_and_grads(ref_model, batch)
        del ref_model
        torch.cuda.empty_cache()
    tc = TrainingConfig(context_parallel_size=2, optimizer=tc1.optimizer)
    tc.initialize("cuda")
    out = dict(launches={}, flash={})
    try:
        transport = ring_transport(ps.get_context_parallel_group())
        rank_log(rank, f"cp2 train: two ranks over {dist.get_backend()} on one card, the ring's "
                 f"transport {transport!r} (gloo's send / recv refuses CUDA tensors) | {card}")

        def one_step(model, step, fault=contextlib.nullcontext()):
            seen = {}

            def read(grads):
                if rank == 0:
                    seen["gap"] = grad_gap(grads, ref_grads)

            state, _ = initialize_parallel_model(model, tc, key=SEED)
            for c in (fa.fwd_launches, fa.bwd_dq_launches, fa.bwd_dkv_launches):
                c.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with fault, step_gradients(read):
                state, m = step(state, batch)
            loss = float(m["loss"])
            ms = (time.perf_counter() - t0) * 1e3
            del state
            return loss, seen.get("gap", (0.0, "")), flash_counts(), ms

        for layout in CP_LAYOUTS:
            model = LlamaForCausalLM(dataclasses.replace(cfg, cp_ring_layout=layout),
                                     device="cuda")
            step = make_train_step(model, tc)
            loss, (gap, at), launches, ms = one_step(model, step)
            want = CP_LAUNCHES[layout][rank]
            check(launches == want, f"cp2 {layout} rank {rank}: (K1, K2, K3) launches "
                  f"{launches}, want {want}")
            both = [None, None]
            dist.all_gather_object(both, (loss, launches))
            check(both[0][0] == both[1][0], f"cp2 {layout}: the ranks' losses differ {both}")
            out["launches"][layout] = tuple(sum(x) for x in zip(both[0][1], both[1][1]))
            if rank == 0:
                loss_gap = abs(loss - ref_loss)
                log(f"cp2 {layout} train: loss {loss:.6f} against {ref_loss:.6f} at cp = 1 "
                    f"(gap {loss_gap:.6g}, band {LOSS_BAND}); the gradients summed over cp, "
                    f"largest relative L2 error {gap:.6g} at {at} (band {GRAD_BAND}); the step "
                    f"{ms:.6f} ms over {transport} (forward, backward, the gradients' "
                    f"all-reduce over gloo, AdamW); (K1, K2, K3) launches rank 0 {both[0][1]}, "
                    f"rank 1 {both[1][1]} | {card}")
                check(np.isfinite(loss) and loss_gap <= LOSS_BAND,
                      f"cp2 {layout} train loss gap {loss_gap}")
                check(gap <= GRAD_BAND, f"cp2 {layout} train gradient gap {gap} at {at}")
            if layout == "contiguous":
                # the loss band rejects this one: the forward alone, from
                # SEED's weights (no gradients, no all-reduce over gloo)
                label = "every visiting chunk left out of the merge"
                model.init_weights(SEED)
                with torch.no_grad(), visiting_chunk_dropped():
                    bad_loss = float(model.loss(batch["input_ids"], batch["labels"]))
                bad_gap, bad_at = float("nan"), "(forward only)"
            else:
                label = "the positions cut in contiguous order"
                bad_loss, (bad_gap, bad_at), _, _ = one_step(
                    model, step, positions_in_contiguous_order(model))
                bad_at = f"at {bad_at}"
            if rank == 0:
                bad_loss_gap = abs(bad_loss - ref_loss)
                log(f"cp2 {layout} train planted fault ({label}): loss gap {bad_loss_gap:.6g}, "
                    f"gradient {bad_gap:.6g} {bad_at} (bands {LOSS_BAND}, {GRAD_BAND})")
                check(bad_loss_gap > LOSS_BAND or bad_gap > GRAD_BAND,
                      f"the cp2 {layout} train bands pass a planted fault ({label})")
            # the ring's backward: dk / dv one hop short of home
            ring = rap._ZigzagFlash if layout == "zigzag" else rap._RingFlash
            _, (bad_gap, bad_at), _, _ = one_step(model, step, home_hop_left_out(ring))
            if rank == 0:
                log(f"cp2 {layout} train planted fault (the backward's dk / dv one hop short "
                    f"of home): gradient {bad_gap:.6g} at {bad_at} (band {GRAD_BAND})")
                check(bad_gap > GRAD_BAND,
                      f"the cp2 {layout} gradient band passes dk / dv one hop short of home "
                      f"({bad_gap})")
            del model, step
            gc.collect()
            torch.cuda.empty_cache()
        if rank == 0:
            del ref_grads
            gc.collect()
            torch.cuda.empty_cache()
            for layout in CP_LAYOUTS:
                out["flash"][layout] = run_flash_kernel_phase(card, cases=CP_FLASH_CASES[layout])
        dist.barrier()
    finally:
        ps.destroy_model_parallel()
    return out


def cp_train_result(outs: list) -> dict:
    check(outs[0]["launches"] == outs[1]["launches"],
          f"cp2 train: launches {outs[0]['launches']} / {outs[1]['launches']}")
    return outs[0]


# -- 6c. pipeline parallelism --------------------------------------------------------
#
# pp = 2 at tp = 1 as two processes on the card over gloo: a stage boundary's
# message goes through a host buffer (``parallel.mappings.pp_transport``:
# gloo's send / recv refuses CUDA tensors). Times over gloo are its host copies.

PP_BATCH, PP_MICRO = 4, 4
#: (schedule, model chunks) of the three steps
PP_SCHEDULES = (("gpipe", 1), ("1f1b", 1), ("interleaved", 2))
#: K1-K3 at a microbatch's shape on one stage: B 1, the 1B's heads, S 2048
PP_FLASH_CASES = (("pp2 stage microbatch, causal", 1, 32, 8, 2048, 64, True, 10),)
#: round trips of one (1, 2048, 2048) bf16 message between the two stages
PP_PING_PONGS = 8


@contextlib.contextmanager
def embedding_grad_unsummed():
    """A planted fault: ``ReduceGradsTask`` leaves the tied embedding's
    gradient unsummed over the first and the last stage (each keeps its own
    part: the lookup's on the first, the head's on the last)."""
    from neuronx_distributed_llama3_2_tpu_torch.pipeline.model import PipelinedCausalLM

    inner = PipelinedCausalLM._reduce_shared_grads
    PipelinedCausalLM._reduce_shared_grads = lambda self, acc: None
    try:
        yield
    finally:
        PipelinedCausalLM._reduce_shared_grads = inner


@contextlib.contextmanager
def stash_one_microbatch_ahead():
    """A planted fault in 1F1B's steady state, where a stage has run the
    forward of microbatch i + 1 before the backward of i: the backward of
    i differentiates the stash of i + 1 (and that of i + 1 the stash of i)
    against the gradient received for i. (A send of microbatch i + 1's
    upstream gradient in place of i's cannot happen in this task order:
    the receive of i's gradient comes before the send of i + 1's
    activations it would need.)"""
    from neuronx_distributed_llama3_2_tpu_torch.pipeline.model import PipelinedCausalLM

    inner = PipelinedCausalLM.__dict__["_take_stash"]

    def faulty(outputs, inputs, key):
        pair = (key[0] ^ 1, key[1])
        return inner.__func__(outputs, inputs, pair if pair in outputs else key)

    PipelinedCausalLM._take_stash = staticmethod(faulty)
    try:
        yield
    finally:
        PipelinedCausalLM._take_stash = inner


def message_ms(rank: int, shape, group) -> float:
    """Mean ms of one host-staged stage-boundary message (``send_forward``
    and ``recv_forward`` of a bf16 ``shape`` between the two stages), over
    PP_PING_PONGS round trips after one warm-up."""
    from neuronx_distributed_llama3_2_tpu_torch.parallel import mappings
    from neuronx_distributed_llama3_2_tpu_torch.parallel import state as ps

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn(shape, device="cuda", generator=gen).to(torch.bfloat16)
    peer = ps.get_pipeline_model_parallel_next_rank()

    def trip():
        if rank == 0:
            mappings.send_forward(x, peer, group)
            got = mappings.recv_forward(shape, torch.bfloat16, "cuda", peer, group)
        else:
            got = mappings.recv_forward(shape, torch.bfloat16, "cuda", peer, group)
            mappings.send_forward(got, peer, group)
        mappings.finish_sends()
        return got

    check(torch.equal(trip(), x), "pp2: a stage-boundary message arrived changed")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(PP_PING_PONGS):
        trip()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / (2 * PP_PING_PONGS)


def pp_train_rank(rank: int, nproc: int, card: str) -> dict:
    """A rank of the pp = 2 train phase: the 1B at full width and depth (8
    layers a stage, 4 a chunk interleaved), train_configs' step (flash
    attention, remat full, CE chunked at 256, AdamW bf16 state) on bench's
    batch cut to PP_BATCH x 2048 in PP_MICRO microbatches. Each rank first
    takes the pp = 1 step with ``num_microbatches`` PP_MICRO from SEED's
    weights (no mesh) and keeps the gradients it handed to AdamW of the
    leaves its stage holds. Then, through the trainer's entry points
    (``TrainingConfig(pipeline_parallel_size=2, pipeline_schedule=...)``,
    ``PipelinedCausalLM``, ``initialize_parallel_model``,
    ``make_train_step``), one step from SEED's weights in each of
    PP_SCHEDULES: its loss within LOSS_BAND of the pp = 1 loss, the
    gradients it hands to AdamW within GRAD_BAND of the pp = 1 step's
    (``grad_gap`` on each rank's leaves, the tied embedding summed over the
    stages; the worst of the two ranks), K1 / K2 / K3 launched
    (FLASH_FWD_PER_LAYER x 8 x PP_MICRO, 8 x PP_MICRO, 8 x PP_MICRO)
    times on each rank, the point-to-point calls each rank issued equal to
    its task list's sends and receives; its step ms and peak memory logged,
    and the forward and backward's peak (before AdamW) under 1f1b below
    gpipe's on each rank.
    Two planted faults must read outside the bands: the tied embedding's
    gradient left unsummed (gpipe), and 1F1B's backward on the stash one
    microbatch ahead. The ms of one host-staged (1, 2048, 2048) bf16
    message is logged. Rank 0 then holds K1-K3 against their plain
    versions at a stage's shape (PP_FLASH_CASES) while rank 1 waits."""
    import torch.distributed as dist

    from neuronx_distributed_llama3_2_tpu_torch.kernels import flash_attention as fa
    from neuronx_distributed_llama3_2_tpu_torch.models.llama import (
        FLASH_FWD_PER_LAYER,
        LlamaForCausalLM,
        jax_path,
        param_specs,
    )
    from neuronx_distributed_llama3_2_tpu_torch.parallel import mappings
    from neuronx_distributed_llama3_2_tpu_torch.parallel.layout import holds, mesh_coords
    from neuronx_distributed_llama3_2_tpu_torch.parallel import state as ps
    from neuronx_distributed_llama3_2_tpu_torch.pipeline import PipelinedCausalLM
    from neuronx_distributed_llama3_2_tpu_torch.pipeline import scheduler as sch
    from neuronx_distributed_llama3_2_tpu_torch.trainer import (
        TrainingConfig,
        initialize_parallel_model,
        make_train_step,
    )

    cfg, tc1 = train_configs()
    batch = train_batch(cfg, PP_BATCH)
    # the pp = 1 reference, on each rank: its loss and the gradients it hands
    # to AdamW, summed in bf16 over the microbatches (use_fp32_grad_acc off)
    ref_model = LlamaForCausalLM(cfg, device="cuda")
    tcr = TrainingConfig(num_microbatches=PP_MICRO, optimizer=tc1.optimizer)
    state, _ = initialize_parallel_model(ref_model, tcr, key=SEED)
    seen = {}
    with step_gradients(lambda g: seen.update(g)):
        ref_loss = float(make_train_step(ref_model, tcr)(state, batch)[1]["loss"])
    del ref_model, state
    tc = TrainingConfig(pipeline_parallel_size=2, optimizer=tc1.optimizer)
    tc.initialize("cuda")
    out = dict(launches=(0, 0, 0))
    p2p = ("send_forward", "recv_forward", "send_backward", "recv_backward")
    kinds = (sch.SendForwardTask, sch.RecvForwardTask, sch.SendBackwardTask, sch.RecvBackwardTask)
    try:
        stage = ps.get_pipeline_model_parallel_rank()
        group = ps.get_pipeline_model_parallel_group()
        transport = mappings.pp_transport(group)
        # the leaves this stage holds under any of the schedules: the other
        # stage's reference gradients are freed
        names = {k for _, v in PP_SCHEDULES for k, leaf in param_specs(cfg, chunks=v).items()
                 if holds(leaf, mesh_coords(), jax_path(k)[1])}
        ref_grads = {k: g for k, g in seen.items() if k in names}
        seen.clear()
        gc.collect()
        torch.cuda.empty_cache()
        rank_log(rank, f"pp2 train: two stages over {dist.get_backend()} on one card, the "
                 f"boundary's transport {transport!r} (gloo's send / recv refuses CUDA tensors); "
                 f"the pp = 1 step's loss {ref_loss:.6f} ({PP_MICRO} microbatches of 1 x "
                 f"{TRAIN_SEQ}) | {card}")
        per_layer = FLASH_FWD_PER_LAYER[cfg.remat]
        layers = cfg.num_layers // 2
        want = (per_layer * layers * PP_MICRO, layers * PP_MICRO, layers * PP_MICRO)

        def one_step(schedule, chunks, fault=contextlib.nullcontext()):
            tcs = dataclasses.replace(tc, pipeline_schedule=schedule, num_model_chunks=chunks)
            model = PipelinedCausalLM(
                LlamaForCausalLM(cfg, device="cuda", num_model_chunks=chunks),
                num_microbatches=PP_MICRO, schedule=schedule, num_model_chunks=chunks)
            state, _ = initialize_parallel_model(model, tcs, key=SEED)
            step = make_train_step(model, tcs)
            got = {}

            def read(grads):
                # the forward and backward's own peak, before AdamW's
                got["fb_peak"] = torch.cuda.max_memory_allocated()
                got["gap"] = grad_gap(grads, ref_grads)

            for c in (fa.fwd_launches, fa.bwd_dq_launches, fa.bwd_dkv_launches):
                c.reset()
            before = dict(mappings.COLLECTIVE_COUNTS)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            with fault, step_gradients(read):
                state, m = step(state, batch)
            loss = float(m["loss"])
            ms = (time.perf_counter() - t0) * 1e3
            peak = (torch.cuda.max_memory_allocated(), base, got["fb_peak"])
            sent = [mappings.COLLECTIVE_COUNTS[k] - before.get(k, 0) for k in p2p]
            tasks = model.stats["tasks"]
            listed = [sum(isinstance(t, c) for t in tasks) for c in kinds]
            del state, step, model
            gc.collect()
            torch.cuda.empty_cache()
            both = [None, None]
            dist.all_gather_object(both, (loss, got["gap"], flash_counts(), sent, listed, ms,
                                          peak))
            return both

        for schedule, chunks in PP_SCHEDULES:
            both = one_step(schedule, chunks)
            label = f"{schedule}" + (f" V = {chunks}" if chunks > 1 else "")
            loss, loss1 = both[0][0], both[1][0]
            (ms0, peak0), (ms1, peak1) = (b[5:] for b in both)
            gap, at = max(b[1] for b in both)
            for r, b in enumerate(both):
                check(b[2] == want, f"pp2 {label} rank {r}: (K1, K2, K3) launches {b[2]}, "
                      f"want {want}")
                check(b[3] == b[4], f"pp2 {label} rank {r}: point-to-point calls {b[3]} "
                      f"(send / recv forward, send / recv backward), the task list's {b[4]}")
            check(loss == loss1, f"pp2 {label}: the ranks' losses differ ({loss}, {loss1})")
            out["launches"] = tuple(a + both[0][2][i] + both[1][2][i]
                                    for i, a in enumerate(out["launches"]))
            loss_gap = abs(loss - ref_loss)
            rank_log(rank, f"pp2 {label} train: loss {loss:.6f} against {ref_loss:.6f} at pp = 1 "
                     f"(gap {loss_gap:.6g}, band {LOSS_BAND}); the gradients handed to AdamW, "
                     f"largest relative L2 error {gap:.6g} at {at} (band {GRAD_BAND}); the "
                     f"step {ms0:.6f} / {ms1:.6f} ms (rank 0 / 1, over {transport}); peak "
                     f"memory {peak0[0] / 2**30:.6f} / {peak1[0] / 2**30:.6f} GiB, of it held "
                     f"before the step {peak0[1] / 2**30:.6f} / {peak1[1] / 2**30:.6f} GiB "
                     f"(the stage, its AdamW state, the kept pp = 1 gradients), the forward "
                     f"and backward's peak (before AdamW) {peak0[2] / 2**30:.6f} / "
                     f"{peak1[2] / 2**30:.6f} GiB; (K1, K2, K3) "
                     f"launches {both[0][2]} / {both[1][2]}; point-to-point calls "
                     f"{both[0][3]} / {both[1][3]} | {card}")
            if rank == 0:
                check(np.isfinite(loss) and loss_gap <= LOSS_BAND,
                      f"pp2 {label} train loss gap {loss_gap}")
                check(gap <= GRAD_BAND, f"pp2 {label} train gradient gap {gap} at {at}")
            out.setdefault("steps", {})[label] = dict(ms=(ms0, ms1), peak=(peak0, peak1))
        # 1F1B holds at most pp - rank microbatches' stage inputs where gpipe
        # holds all PP_MICRO: its forward and backward's peak is lower on
        # each rank
        fb = {k: tuple(p[2] for p in v["peak"]) for k, v in out["steps"].items()}
        check(all(a < b for a, b in zip(fb["1f1b"], fb["gpipe"])),
              f"pp2: 1f1b's forward and backward peak {fb['1f1b']} is not below gpipe's "
              f"{fb['gpipe']} on every rank")
        for label, (schedule, chunks), fault in (
                ("the tied embedding's gradient left unsummed", ("gpipe", 1),
                 embedding_grad_unsummed()),
                ("1F1B's backward on the stash one microbatch ahead", ("1f1b", 1),
                 stash_one_microbatch_ahead())):
            both = one_step(schedule, chunks, fault)
            bad_gap, bad_at = max(b[1] for b in both)
            bad_loss_gap = abs(both[0][0] - ref_loss)
            rank_log(rank, f"pp2 train planted fault ({label}): loss gap {bad_loss_gap:.6g}, "
                     f"gradient {bad_gap:.6g} at {bad_at} (bands {LOSS_BAND}, {GRAD_BAND})")
            check(bad_loss_gap > LOSS_BAND or bad_gap > GRAD_BAND,
                  f"the pp2 train bands pass a planted fault ({label})")
        shape = (1, TRAIN_SEQ, cfg.hidden_size)
        msg = message_ms(rank, shape, group)
        rank_log(rank, f"pp2: one host-staged stage-boundary message of {shape} bf16 "
                 f"({np.prod(shape) * 2 / 2**20:.0f} MiB) {msg:.6f} ms over {transport} "
                 f"(D2H, gloo send / recv, H2D; {PP_PING_PONGS} round trips) | {card}")
        out["message_ms"] = msg
        del ref_grads
        gc.collect()
        torch.cuda.empty_cache()
        if rank == 0:
            out["flash"] = run_flash_kernel_phase(card, cases=PP_FLASH_CASES)
        dist.barrier()
    finally:
        ps.destroy_model_parallel()
    return out


def pp_train_result(outs: list) -> dict:
    check(outs[0]["launches"] == outs[1]["launches"],
          f"pp2 train: launches {outs[0]['launches']} / {outs[1]['launches']}")
    return outs[0]

# -- 6d. MoE and quantized layers ------------------------------------------------
#
# Mixtral 8x7B and DBRX at their published widths (HF config.json values:
# MIXTRAL_CONFIGS["mixtral-8x7b"], DBRX_CONFIGS["dbrx"]), depth cut: the
# train step at 2 layers, the serves at 4 (Mixtral) and 1 (DBRX). Weights
# are drawn on the card from SEED; no tag is written (a layer is 2.9 GB).

MOE_TRAIN_LAYERS = 2
MOE_TRAIN_BATCH = 2
#: K1-K3 at Mixtral's train shape: B 2, 32 / 8 heads (G 4), S 2048, D 128
MOE_FLASH_CASES = (("mixtral train causal (D 128, G 4)", 2, 32, 8, 2048, 128, True, 10),)
MOE_TIMED_STEPS = 2
MOE_SERVE_LAYERS = 4
DBRX_SERVE_LAYERS = 1
#: JAX's band for int8 logits against bf16's (tests/test_quantization.py:
#: 252-254, on tiny-moe, where the CPU test holds the port to it): logged
#: here. At Mixtral's widths with random weights the logits lie close
#: together (a median top-1 to top-2 gap of 0.19), and a correct int8
#: rounding moves the largest of a prompt's 16 M logits by more than 0.25
QUANT_LOGIT_BAND, QUANT_ARGMAX_AGREE = 0.25, 0.95
#: the int8 logits' relative L2 distance from bf16's (on bf16's expert
#: choices), held: per-channel int8 rounds each weight by at most half its
#: channel's absmax / 127, ~0.9 % of the weights' spread for a normal
#: draw over 4096 rows, so a few percent over the layers; 0.1 leaves room
QUANT_REL_L2 = 0.1
#: the MoE serves' e2e margin: twice the sound reading of the first 8-lane
#: Mixtral serve on an H100 teacher-forced on its own expert choices
#: (0.21875: Mixtral's logits lie closer together than the 1B's, a median
#: top-1 to top-2 gap of 0.19, and its 4096-wide head sums more bf16
#: products); the newest K/V row left out of every K4 call must read above
MOE_LOGIT_MARGIN = 0.4375
#: a shorter prefill ladder than Serve's (fewer graphs to capture), which
#: still covers every prompt and takes the 5- and 8-token suffixes at t = 8
MOE_PREFILL_BUCKETS = (8, 64, 1024)


def moe_train_configs(layers: int):
    """Mixtral 8x7B at full width and ``layers`` layers, with the 1B's
    train knobs (flash attention, remat full, CE chunked at 256, AdamW bf16
    state, no master weights): (model config, TrainingConfig)."""
    from neuronx_distributed_llama3_2_tpu_torch.models.mixtral import MIXTRAL_CONFIGS

    _, tc = train_configs()
    cfg = dataclasses.replace(
        MIXTRAL_CONFIGS["mixtral-8x7b"], num_layers=layers, remat="full",
        max_seq_len=TRAIN_SEQ, use_flash_attention=True, flash_block_q=1024,
        flash_block_kv=1024, loss_chunk_size=256,
    )
    return cfg, tc


@contextlib.contextmanager
def gates_not_renormalized(model):
    """A planted fault: every MoE block of ``model`` keeps the raw softmax
    affinities of the chosen experts (Mixtral renormalizes them to sum to
    1)."""
    blocks = model.moe_layers()
    configs = [m.config for m in blocks]
    for m in blocks:
        m.config = dataclasses.replace(m.config, normalize_top_k=False)
    try:
        yield
    finally:
        for m, c in zip(blocks, configs):
            m.config = c


@contextlib.contextmanager
def route_tape(tape: list, mode: str, rows=None):
    """Record (``mode`` "record") each MoE routing call's expert choices
    into ``tape``, or replay them ("replay"): each call takes the next
    recorded choices (their ``rows`` slice, a rank's tokens of a recorded
    global batch) in place of its own, gated by its own logits. Two steps
    of one structure (the same layers, remat and microbatches) make their
    routing calls in the same order. A bf16 forward through other kernels
    moves a router logit by an ulp, and a token near a tie between two
    experts then picks the other: a step that replays another's routing
    differs from it only by arithmetic, not by expert choice."""
    from neuronx_distributed_llama3_2_tpu_torch.moe import model as mm

    inner = mm.MoE.route

    def route(self, x):
        logits, gates, idx = inner(self, x)
        if mode == "record":
            tape.append(idx.detach().clone())
            return logits, gates, idx
        idx = tape.pop(0)
        if rows is not None:
            idx = idx[rows[0]:rows[1]]
        gates = torch.softmax(logits.float(), -1).gather(-1, idx)
        if self.config.normalize_top_k:
            gates = gates / gates.sum(-1, keepdim=True)
        return logits, gates, idx

    mm.MoE.route = route
    try:
        yield
    finally:
        mm.MoE.route = inner


def moe_drops(model) -> tuple:
    """(dropped assignments, assignments) of the last forward, over the
    MoE layers."""
    layers = [m.experts for m in model.moe_layers()]
    return (sum(int(e.dropped) for e in layers), sum(e.assignments for e in layers))


def run_moe_train_phase(card: str) -> dict:
    """Mixtral 8x7B's train step at full width, MOE_TRAIN_LAYERS layers,
    batch MOE_TRAIN_BATCH x 2048, capacity factor 4.0 (E·C = 32768 slots a
    layer): one step's loss and gradients through K1-K3 against the same
    step with plain attention (same weights) on the kernel step's expert
    choices (``route_tape``; the plain step routing on its own logits is
    logged as a witness): LOSS_BAND / GRAD_BAND, and a planted fault (gates
    not renormalized) outside them; then a warm-up and
    MOE_TIMED_STEPS steps through the trainer, (K1, K2, K3) launched
    (FLASH_FWD_PER_LAYER x L, L, L) a step, the dropped assignments and the
    peak memory logged; K1-K3 at the train shape against their plain
    versions (MOE_FLASH_CASES). Returns the K1-K3 records and launches."""
    from neuronx_distributed_llama3_2_tpu_torch.models.llama import FLASH_FWD_PER_LAYER
    from neuronx_distributed_llama3_2_tpu_torch.models.mixtral import MixtralForCausalLM
    from neuronx_distributed_llama3_2_tpu_torch.trainer import (
        initialize_parallel_model,
        make_train_step,
    )

    cfg, tc = moe_train_configs(MOE_TRAIN_LAYERS)
    tc.initialize("cuda")
    batch = train_batch(cfg, MOE_TRAIN_BATCH)
    torch.cuda.reset_peak_memory_stats()
    model = MixtralForCausalLM(cfg, device="cuda")
    state, _ = initialize_parallel_model(model, tc, key=SEED)
    n_params = sum(p.numel() for p in state.params.values())
    log(f"moe train: mixtral-8x7b widths (hidden {cfg.hidden_size}, intermediate "
        f"{cfg.intermediate_size}, {cfg.num_heads} / {cfg.num_kv_heads} heads, head_dim "
        f"{cfg.head_dim}, E {cfg.num_experts}, k {cfg.top_k}, capacity factor "
        f"{cfg.capacity_factor}, vocab {cfg.vocab_size}), depth cut to {cfg.num_layers} of 32 "
        f"layers: {n_params} parameters, bf16, seeded random weights; batch "
        f"{MOE_TRAIN_BATCH} x {TRAIN_SEQ}, remat {cfg.remat}, flash attention, AdamW bf16 "
        f"state | {card}")
    plain = MixtralForCausalLM(dataclasses.replace(cfg, use_flash_attention=False),
                               device="cuda")
    plain.load_state_dict(model.state_dict())
    tape: list = []
    with route_tape(tape, "record"):
        loss, grads = loss_and_grads(model, batch)
    dropped, assigned = moe_drops(model)
    # the witness: the plain step routing on its own logits
    own: list = []
    with route_tape(own, "record"):
        free_loss, free_grads = loss_and_grads(plain, batch)
    flips = [int((a.sort(-1).values != b.sort(-1).values).any(-1).sum())
             for a, b in zip(tape[:cfg.num_layers], own[:cfg.num_layers])]
    free_gap = grad_gap(grads, free_grads)
    del free_grads
    # the check: the plain step given the kernel step's expert choices
    with route_tape(list(tape), "replay"):
        ref_loss, ref_grads = loss_and_grads(plain, batch)
    del plain
    gc.collect()
    torch.cuda.empty_cache()
    loss_gap = abs(loss - ref_loss)
    gap, at = grad_gap(grads, ref_grads)
    del grads
    log(f"moe train e2e: loss {loss:.6f} through the kernels vs {ref_loss:.6f} plain on the "
        f"kernel step's expert choices (gap {loss_gap:.6g}, band {LOSS_BAND}); largest gradient "
        f"relative L2 error {gap:.6g} at {at} (band {GRAD_BAND}); witness, the plain step "
        f"routing on its own logits: {flips} of {batch['input_ids'].numel()} tokens choose "
        f"other experts (by layer), loss {free_loss:.6f} (gap {abs(loss - free_loss):.6g}), "
        f"gradient {free_gap[0]:.6g} at {free_gap[1]}; dropped assignments at capacity factor "
        f"{cfg.capacity_factor}: {dropped} of {assigned} | {card}")
    check(np.isfinite(loss) and loss_gap <= LOSS_BAND, f"moe train loss gap {loss_gap}")
    check(gap <= GRAD_BAND, f"moe train gradient gap {gap} at {at}")
    with gates_not_renormalized(model), route_tape(list(tape), "replay"):
        bad_loss, bad_grads = loss_and_grads(model, batch)
    bad_gap, bad_at = grad_gap(bad_grads, ref_grads)
    del bad_grads, ref_grads
    log(f"moe train planted fault (gates not renormalized): loss gap "
        f"{abs(bad_loss - ref_loss):.6g}, gradient {bad_gap:.6g} at {bad_at}")
    check(abs(bad_loss - ref_loss) > LOSS_BAND or bad_gap > GRAD_BAND,
          "the moe train bands pass un-renormalized gates")
    gc.collect()
    torch.cuda.empty_cache()

    step = make_train_step(model, tc)
    t0 = time.perf_counter()
    state, m = step(state, batch)
    losses = [float(m["loss"])]
    warm_ms = 1e3 * (time.perf_counter() - t0)
    want = (FLASH_FWD_PER_LAYER[cfg.remat] * cfg.num_layers, cfg.num_layers, cfg.num_layers)
    launches, step_ms = (0, 0, 0), []
    for i in range(MOE_TIMED_STEPS):
        prev = flash_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        step_ms.append(1e3 * (time.perf_counter() - t0))
        per_step = tuple(a - b for a, b in zip(flash_counts(), prev))
        check(per_step == want, f"moe train step {i}: (K1, K2, K3) launches {per_step}, "
              f"want {want}")
        launches = tuple(a + b for a, b in zip(launches, per_step))
    dropped, assigned = moe_drops(model)
    check(all(np.isfinite(losses)), f"non-finite moe train loss: {losses}")
    log(f"moe train: warm-up {warm_ms:.6f} ms, steps {[round(x, 6) for x in step_ms]} ms "
        f"(median {float(np.median(step_ms)):.6f}), losses {losses}; (K1, K2, K3) launches "
        f"{launches} over {MOE_TIMED_STEPS} steps; dropped assignments {dropped} of "
        f"{assigned}; peak memory {torch.cuda.max_memory_allocated() / 2**30:.6f} GiB | {card}")
    del model, state, step
    gc.collect()
    torch.cuda.empty_cache()
    return dict(launches=launches, flash=run_flash_kernel_phase(card, cases=MOE_FLASH_CASES))


# ep = 2 as two processes on the card over gloo, whose all_to_all_single
# carries CUDA tensors (chip_trials/gloo_a2a_trial.py)

@contextlib.contextmanager
def exit_blocks_swapped():
    """A planted fault: the ep exit all-to-all returns the expert blocks in
    the wrong order (the two ep ranks' outputs swapped)."""
    from neuronx_distributed_llama3_2_tpu_torch.moe import model as mm

    inner = mm.exit_expert_parallel_region

    def faulty(x, group):
        y = inner(x, group)
        return y.roll(y.shape[0] // 2, dims=0)

    mm.exit_expert_parallel_region = faulty
    try:
        yield
    finally:
        mm.exit_expert_parallel_region = inner


def ep_part_gap(grads, ref, parts, ep_rank: int, ep: int):
    """``grad_gap`` of a rank's gradients handed to AdamW (ZeRO-1's parts
    of the dense leaves, its experts' slice of the expert leaves) against
    the same slices of the ep = 1 gradients."""
    cut = {}
    for k, g in grads.items():
        r = ref[k]
        if ".experts." in k:
            e = r.shape[0] // ep
            r = r[ep_rank * e:(ep_rank + 1) * e]
        part = parts[k] if parts else None
        if part is not None and part.dim is not None:
            r = r.narrow(part.dim, part.start, part.size)
        cut[k] = r
    return grad_gap(grads, cut)


def ep_train_rank(rank: int, nproc: int, card: str) -> dict:
    """A rank of the ep = 2 train phase: the moe train phase's model and
    batch. Each rank first takes the ep = 1 step's loss and gradients (no
    mesh, the ranks in turn) from SEED's weights and keeps them and its
    expert choices (``route_tape``); then, through the
    trainer's entry points (``TrainingConfig(expert_parallel_size=2)`` with
    ZeRO-1 on, ``initialize_parallel_model``, ``make_train_step``), the ep =
    2 step from the same weights, on the ep = 1 step's expert choices for
    its tokens: each rank holds E / 2 experts and takes one row of the
    batch, its capacity is its own (C = 2048 a rank, which
    no assignment exceeds: zero drops, required), its loss within
    LOSS_BAND of ep = 1's and its gradients within GRAD_BAND of the same
    slices; the planted fault (the exit all-to-all's blocks swapped) outside
    them. Logged: each rank's expert shard, its ZeRO-1 state bytes, the
    step ms, one (8, 2048, 4096) bf16 all-to-all's ms."""
    import torch.distributed as dist

    from neuronx_distributed_llama3_2_tpu_torch.models.mixtral import MixtralForCausalLM
    from neuronx_distributed_llama3_2_tpu_torch.parallel import mappings
    from neuronx_distributed_llama3_2_tpu_torch.parallel import state as ps
    from neuronx_distributed_llama3_2_tpu_torch.trainer import (
        TrainingConfig,
        initialize_parallel_model,
        make_train_step,
    )
    from neuronx_distributed_llama3_2_tpu_torch.trainer.optimizer import state_bytes, zero1_parts
    from neuronx_distributed_llama3_2_tpu_torch.trainer.trainer import state_specs

    cfg, tc1 = moe_train_configs(MOE_TRAIN_LAYERS)
    batch = train_batch(cfg, MOE_TRAIN_BATCH)
    # the ep = 1 step's loss and gradients (at one microbatch, those the
    # trainer hands to AdamW), the ranks in turn: two at once do not fit
    ref, tape = {}, []
    for turn in range(nproc):
        if turn == rank:
            ref_model = MixtralForCausalLM(cfg, device="cuda").init_weights(SEED)
            with route_tape(tape, "record"):
                ref_loss, ref = loss_and_grads(ref_model, batch)
            del ref_model
            gc.collect()
            torch.cuda.empty_cache()
        dist.barrier()
    opt = dataclasses.replace(tc1.optimizer, zero_one_enabled=True)
    tc = TrainingConfig(expert_parallel_size=2, optimizer=opt)
    tc.initialize("cuda")
    out = {}
    try:
        ep_rank = ps.get_expert_model_parallel_rank()

        def one_step(fault=contextlib.nullcontext()):
            model = MixtralForCausalLM(cfg, device="cuda")
            state, specs = initialize_parallel_model(model, tc, key=SEED)
            parts = zero1_parts(state_specs(model, tc).opt)
            got = {}
            step = make_train_step(model, tc)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with fault, step_gradients(lambda g: got.update(
                    gap=ep_part_gap(g, ref, parts, ep_rank, 2))), \
                    route_tape(list(tape), "replay", (ep_rank * TRAIN_SEQ, (ep_rank + 1) * TRAIN_SEQ)):
                state, m = step(state, batch)
            loss = float(m["loss"])
            ms = 1e3 * (time.perf_counter() - t0)
            shard = tuple(model.layers[0].moe.experts.gate_up.shape)
            sbytes = state_bytes(state.opt)
            drops = moe_drops(model)
            del model, state, step
            gc.collect()
            torch.cuda.empty_cache()
            both = [None, None]
            dist.all_gather_object(both, (loss, got["gap"], drops, ms, shard, sbytes))
            return both

        both = one_step()
        (loss, gap0, drops0, ms0, shard0, sb0), (loss1, gap1, drops1, ms1, shard1, sb1) = both
        gap, at = max(gap0, gap1)
        loss_gap = abs(loss - ref_loss)
        rank_log(rank, f"ep2 train: two ranks over {dist.get_backend()} on one card, the expert "
                 f"all-to-all by all_to_all_single on the CUDA tensors; each rank holds experts "
                 f"gate_up {shard0} / {shard1} (E / ep = {cfg.num_experts // 2}), ZeRO-1 state "
                 f"{sb0} / {sb1} B; loss {loss:.6f} against {ref_loss:.6f} at ep = 1 (gap "
                 f"{loss_gap:.6g}, band {LOSS_BAND}); gradients handed to AdamW, largest relative "
                 f"L2 error {gap:.6g} at {at} (band {GRAD_BAND}); dropped assignments {drops0} / "
                 f"{drops1} (rank-local capacity); the step {ms0:.6f} / {ms1:.6f} ms | {card}")
        check(loss == loss1, f"ep2 train: the ranks' losses differ ({loss}, {loss1})")
        check(drops0[0] == 0 and drops1[0] == 0, f"ep2 train: dropped {drops0}, {drops1}")
        check(np.isfinite(loss) and loss_gap <= LOSS_BAND, f"ep2 train loss gap {loss_gap}")
        check(gap <= GRAD_BAND, f"ep2 train gradient gap {gap} at {at}")
        bad = one_step(exit_blocks_swapped())
        bad_gap, bad_at = max(b[1] for b in bad)
        bad_loss_gap = abs(bad[0][0] - ref_loss)
        rank_log(rank, f"ep2 train planted fault (the exit all-to-all's blocks swapped): loss gap "
                 f"{bad_loss_gap:.6g}, gradient {bad_gap:.6g} at {bad_at}")
        check(bad_loss_gap > LOSS_BAND or bad_gap > GRAD_BAND,
              "the ep2 train bands pass a swapped exit all-to-all")
        del ref
        gc.collect()
        torch.cuda.empty_cache()
        group = ps.get_expert_model_parallel_group()
        buf = torch.randn((cfg.num_experts, TRAIN_SEQ, cfg.hidden_size), device="cuda",
                          generator=torch.Generator(device="cuda").manual_seed(SEED + rank),
                          ).to(torch.bfloat16)
        back = mappings.all_to_all(mappings.all_to_all(buf, 0, 1, group), 1, 0, group)
        check(torch.equal(back, buf), "ep2: the all-to-all and its inverse changed the buffer")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(4):
            mappings.all_to_all(buf, 0, 1, group)
        torch.cuda.synchronize()
        a2a_ms = 1e3 * (time.perf_counter() - t0) / 4
        rank_log(rank, f"ep2: one all-to-all of the (8, {TRAIN_SEQ}, {cfg.hidden_size}) bf16 "
                 f"dispatch buffer ({buf.numel() * 2 / 1e6:.3f} MB) {a2a_ms:.6f} ms over "
                 f"{dist.get_backend()} | {card}")
        out = dict(loss_gap=loss_gap, gap=gap, a2a_ms=a2a_ms)
        dist.barrier()
    finally:
        ps.destroy_model_parallel()
    return out


#: the phases that run on two ranks over gloo, in order, on one pair of
#: processes (one process start and CUDA context a rank for all of them)
TWO_RANK_PHASES = ("tp2 serve", "tp2 train", "cp2 train", "pp2 train", "ep2 train")


def two_rank_body(rank: int, nproc: int, prompts, want: list, card: str) -> dict:
    """Each of TWO_RANK_PHASES's rank bodies in turn: {phase: this rank's
    result}; each phase's seconds logged by rank 0."""
    bodies = {"tp2 serve": (tp_serve_rank, (prompts, want, card)),
              "tp2 train": (tp_train_rank, (card,)), "cp2 train": (cp_train_rank, (card,)),
              "pp2 train": (pp_train_rank, (card,)), "ep2 train": (ep_train_rank, (card,))}
    out = {}
    for name in TWO_RANK_PHASES:
        fn, args = bodies[name]
        t0 = time.perf_counter()
        out[name] = fn(rank, nproc, *args)
        gc.collect()
        torch.cuda.empty_cache()
        rank_log(rank, f"phase {name}: {time.perf_counter() - t0:.3f} s")
    return out


def run_two_rank_phases(prompts, want: list, card: str) -> dict:
    """TWO_RANK_PHASES on two ranks on the card over gloo (``two_rank_body``):
    {phase: rank 0's record}, each held to both ranks' agreement."""
    outs = tp_spawn(two_rank_body, prompts, want, card)
    by = {name: [o[name] for o in outs] for name in TWO_RANK_PHASES}
    return {"tp2 serve": tp_serve_result(by["tp2 serve"]),
            "tp2 train": tp_train_result(by["tp2 train"]),
            "cp2 train": cp_train_result(by["cp2 train"]),
            "pp2 train": pp_train_result(by["pp2 train"]),
            "ep2 train": by["ep2 train"][0]}


def moe_prompts(vocab: int) -> list:
    """Serve's prompts with their ids taken modulo the model's vocab."""
    return [[t % vocab for t in p] for p in serve_prompts()]


@contextlib.contextmanager
def serve_routing(server, prompts: list, tape: dict):
    """While an eager serve of ``prompts`` runs on ``server``: each MoE
    routing call's expert choices into ``tape``, keyed by (prompt index,
    position, layer). A prefill's rows (one request) are the prompt whose
    tokens they are, past its end padding; a decode step's row i is lane
    i's request. A host sync per call: eager serves only."""
    from neuronx_distributed_llama3_2_tpu_torch.inference import model as im
    from neuronx_distributed_llama3_2_tpu_torch.moe import model as mm

    inner_fwd, inner_route = im.LlamaDecode.forward, mm.MoE.route
    ctx: dict = {}
    of_rid: dict = {}

    def owner(i, toks, pos):
        if len(ctx["tokens"]) == 1 and len(toks) > 1 or ctx["prefill"]:
            for j, p in enumerate(prompts):
                n = min(len(toks), len(p) - pos)
                if n > 0 and p[pos:pos + n] == toks[:n]:
                    return j
            return None
        req = server._active.get(i)
        if req is None:
            return None
        if req.rid not in of_rid:
            of_rid[req.rid] = next(j for j, p in enumerate(prompts) if list(req.prompt) == p)
        return of_rid[req.rid]

    def forward(self, params, cache, tokens, positions, *args, **kw):
        ctx.update(tokens=tokens.tolist(), pos=positions.tolist(), layer=0,
                   prefill=bool(kw.get("context_encode")))
        return inner_fwd(self, params, cache, tokens, positions, *args, **kw)

    def route(self, x):
        logits, gates, idx = inner_route(self, x)
        rows, toks = idx.tolist(), ctx["tokens"]
        t = len(toks[0])
        for i, row_toks in enumerate(toks):
            j = owner(i, row_toks, ctx["pos"][i])
            if j is None:
                continue
            for u in range(t):
                pos = ctx["pos"][i] + u
                if ctx["prefill"] or len(toks) == 1 and t > 1:
                    if pos >= len(prompts[j]):
                        break
                tape[(j, pos, ctx["layer"])] = rows[i * t + u]
        ctx["layer"] += 1
        return logits, gates, idx

    im.LlamaDecode.forward, mm.MoE.route = forward, route
    try:
        yield
    finally:
        im.LlamaDecode.forward, mm.MoE.route = inner_fwd, inner_route


def replayed_logits(model, tape: dict, prompts: list, j: int, seq: list) -> torch.Tensor:
    """``model``'s plain forward over ``seq`` (prompt ``j`` and served
    tokens) with each position's expert choices the serve's (``tape``; a
    position of a prefix the request shares with another prompt, which the
    prefix cache served from that prompt's prefill, from that prompt's)."""
    n_layers = model.config.num_layers
    layers = []
    for layer in range(n_layers):
        rows = []
        for pos in range(len(seq)):
            key = (j, pos, layer)
            if key not in tape:
                key = next((q, pos, layer) for q, p in enumerate(prompts)
                           if (q, pos, layer) in tape and p[:pos + 1] == seq[:pos + 1])
            rows.append(tape[key])
        layers.append(torch.as_tensor(rows, device="cuda"))
    with route_tape(layers, "replay"):
        return model(torch.as_tensor([seq], device="cuda"))[0].float()


def moe_e2e(model, prompts, streams, tape, label: str, card: str,
            check_margin: bool = True) -> float:
    """Every served token (``streams`` in prompt order) teacher-forced
    through ``model``'s plain forward on the serve's own expert choices
    (``replayed_logits``): within MOE_LOGIT_MARGIN of its argmax. A bf16
    forward through other kernels moves a router logit by an ulp, and a
    token near a tie between two experts then takes the other, which moves
    its logits by whole units (the witness logged: the plain forward
    routing on its own). Returns the worst gap."""
    worst, exact, total = 0.0, 0, 0
    for j, gen in enumerate(streams):
        logits = replayed_logits(model, tape, prompts, j, prompts[j] + gen[:-1])
        logits = logits[len(prompts[j]) - 1:]
        check(bool(torch.isfinite(logits).all()), f"{label}: non-finite plain logits")
        tok = torch.as_tensor(gen, device="cuda")
        chosen = logits[torch.arange(len(gen), device="cuda"), tok]
        worst = max(worst, (logits.max(-1).values - chosen).max().item())
        exact += int((logits.argmax(-1) == tok).sum())
        total += len(gen)
    free, free_exact, _ = e2e_gaps(model, prompts, dict(enumerate(streams)), range(len(streams)))
    log(f"{label} e2e: {exact} of {total} served tokens are the argmax of the plain forward "
        f"on the serve's expert choices, the worst within {worst:.6g} logits (margin "
        f"{MOE_LOGIT_MARGIN}); witness, the plain forward routing on its own: {free_exact} "
        f"exact, the worst {free:.6g} | {card}")
    if check_margin:
        check(worst <= MOE_LOGIT_MARGIN, f"{label}: a served token {worst} below the argmax")
    return worst


def moe_twin_streams(label: str, model, prompts, tape, want: list, got: list) -> int:
    """A prewarmed serve's streams (``got``, in prompt order) against the
    eager serve's (``want``): where one differs, its first differing token
    must be a near tie (the two tokens' logits within LOGIT_MARGIN) under
    the plain forward on the eager serve's expert choices. Returns how many
    streams are equal."""
    same = 0
    for j, (o, w) in enumerate(zip(got, want)):
        i = first_difference(o, w)
        if i is None:
            same += 1
            continue
        logits = replayed_logits(model, tape, prompts, j, prompts[j] + w[:i])[-1]
        tie = abs(logits[o[i]] - logits[w[i]]).item()
        log(f"{label}: request {j} first differs at token {i} ({o[i]} against {w[i]}); their "
            f"plain-forward logits lie {tie:.6g} apart (near-tie limit {LOGIT_MARGIN})")
        check(tie <= LOGIT_MARGIN, f"{label}: request {j} differs at token {i}, not a near tie")
    return same


def moe_serve(cfg, model, prompts, lanes: int, prewarm: bool, card: str, label: str,
              routed: bool = True, **paged_kw):
    """Serve ``prompts`` greedily through the paged engine (K4 on,
    ``lanes`` lanes, MOE_PREFILL_BUCKETS, ``paged_kw`` over those
    ``PagedConfig`` knobs), eager with every kernel call's geometry and
    (``routed``, an MoE model) every routing call's expert choices recorded
    (``serve_routing``), or prewarmed with K4's launches read from the
    graphs' replays. Returns (streams in prompt order, {source: launches},
    served geometries, moe_paths, routing tape)."""
    from neuronx_distributed_llama3_2_tpu_torch.inference.engine import (
        GenerationConfig,
        InferenceEngine,
    )
    from neuronx_distributed_llama3_2_tpu_torch.serving.engine import (
        PagedConfig,
        PagedServingEngine,
    )

    def server():
        engine = InferenceEngine(cfg, model, max_batch=lanes, max_seq_len=2048)
        paged = PagedConfig(**dict(block_size=16, num_blocks=2049,
                                   prefill_buckets=MOE_PREFILL_BUCKETS, prewarm=prewarm)
                            | paged_kw)
        return PagedServingEngine(engine, GenerationConfig(max_new_tokens=MAX_NEW), paged)

    geoms: dict = {}
    tape: dict = {}
    if prewarm:
        before = k4_counts()
        t0 = time.perf_counter()
        with counted_captures() as held:
            srv = server()
        capture_s = time.perf_counter() - t0
        check(k4_counts() != before, f"{label}: the captures launched no K4")
        t0 = time.perf_counter()
        rids = [srv.submit(p) for p in prompts]
        outs = srv.run_to_completion()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = replayed_k4(srv, held)
        check(srv.metrics.steadystate_compiles == 0,
              f"{label}: {srv.metrics.steadystate_compiles} captures after the freeze")
    else:
        capture_s = 0.0
        srv = server()
        before = k4_counts()
        with model_kernel_call(recording(geoms, keep_positions=True)), \
                (serve_routing(srv, prompts, tape) if routed else contextlib.nullcontext()):
            t0 = time.perf_counter()
            rids = [srv.submit(p) for p in prompts]
            outs = srv.run_to_completion()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = {s: k4_counts()[s] - before[s] for s in before}
    # counted in the eager calls and the captures' (a replay runs no Python)
    paths = dict(getattr(srv.model, "moe_paths", {}))
    for r in rids:
        check(srv.request_info(r)["status"] == "finished" and len(outs[r]) == MAX_NEW,
              f"{label}: request {r} {srv.request_info(r)['status']}, {len(outs[r])} tokens")
    stats = serve_stats(srv, rids, outs, wall)
    log(f"{label}: {len(rids)} requests over {lanes} lanes"
        f"{' (prewarmed: graphs captured in %.3f s)' % capture_s if prewarm else ' (eager)'}: "
        f"{stats['tokens_s']:.6f} tokens/s, TTFT p50 {stats['ttft']:.6f} ms, TPOT p50 "
        f"{stats['tpot']:.6f} ms; K4 launches by source {launches}; expert paths by layer "
        f"call {paths} | {card}")
    served = {k: dict(calls=e["calls"], positions=median_call(e["positions"]))
              for k, e in geoms.items()}
    streams = [outs[r] for r in rids]
    del srv
    gc.collect()
    torch.cuda.empty_cache()
    return streams, launches, served, paths, tape


@contextlib.contextmanager
def per_tensor_dequant():
    """A planted fault: every quantized layer dequantizes with its largest
    (per-tensor) scale in place of its per-channel scales."""
    from neuronx_distributed_llama3_2_tpu_torch.quantization.layers import DequantizeOnRead

    inner = DequantizeOnRead.__getattr__

    def faulty(self, name):
        held = self.__dict__.get("_quantized")
        if held is not None and name in held:
            b = self.__dict__["_buffers"]
            return (b[name + "_qvalue"].float() * b[name + "_scale"].max()).to(held[name])
        return inner(self, name)

    DequantizeOnRead.__getattr__ = faulty
    try:
        yield
    finally:
        DequantizeOnRead.__getattr__ = inner


def logit_band(logits, ref) -> tuple:
    """(relative L2 distance, max |logit difference|, argmax agreement) of
    two (.., V) logits."""
    d = logits.float() - ref.float()
    return ((d.norm() / ref.float().norm()).item(), d.abs().max().item(),
            (logits.argmax(-1) == ref.argmax(-1)).float().mean().item())


def run_moe_serve_phase(card: str) -> dict:
    """(a) Mixtral 8x7B widths, MOE_SERVE_LAYERS layers, bf16: Serve's
    prompts (ids modulo the vocab) over 8 lanes (T·k = 16 > E: every expert
    on every decode token) and over 4 lanes (T·k = 8 <= E: the selective
    path), each eager with its expert choices recorded, every served token
    teacher-forced against ``MixtralForCausalLM``'s plain forward on them
    (``moe_e2e``); the 4-lane serve's prewarmed twin (every step a CUDA
    graph) gives its streams (``moe_twin_streams``); ``moe_paths`` must show
    both paths; K4 against its plain version at the 8-lane serve's
    geometries (t1 at b 8, the tile at the t > 1 suffix). (b) the same
    model quantized (``quantize_model``, int8 per channel): weight bytes
    logged, the logits of a 511-token prompt within QUANT_LOGIT_BAND /
    QUANT_ARGMAX_AGREE of bf16's (a per-tensor dequantize must fail it), an
    eager 8-lane serve teacher-forced against the quantized model's plain
    forward, its prewarmed twin's streams, and that twin's peak memory
    above the quantized model below the bytes a whole-model dequantize
    holds (which a planted whole-model dequantize must reach). (c) DBRX
    widths, DBRX_SERVE_LAYERS layer, 4 lanes (selective decode), eager: K4
    at G 6, LayerNorm and clip_qkv, teacher-forced against
    ``DbrxForCausalLM``, its prewarmed twin's streams, K4 at its
    geometries."""
    from neuronx_distributed_llama3_2_tpu_torch.models.dbrx import DBRX_CONFIGS, DbrxForCausalLM
    from neuronx_distributed_llama3_2_tpu_torch.models.mixtral import (
        MIXTRAL_CONFIGS,
        MixtralForCausalLM,
    )
    from neuronx_distributed_llama3_2_tpu_torch.quantization import (
        QuantizationConfig,
        quantize_model,
    )
    from neuronx_distributed_llama3_2_tpu_torch.quantization.quantize import weight_bytes

    out = {}
    cfg = dataclasses.replace(MIXTRAL_CONFIGS["mixtral-8x7b"], num_layers=MOE_SERVE_LAYERS,
                              use_paged_kernel=True, max_seq_len=2048)
    model = MixtralForCausalLM(cfg, device="cuda").init_weights(SEED)
    bf16_bytes = weight_bytes(model)
    prompts = moe_prompts(cfg.vocab_size)
    log(f"moe serve: mixtral-8x7b widths, depth cut to {cfg.num_layers} of 32 layers, bf16, "
        f"seeded random weights ({bf16_bytes} B); prompts of {[len(p) for p in prompts]} "
        f"tokens (Serve's, ids modulo {cfg.vocab_size}) | {card}")
    label = "moe serve mixtral bf16"
    s8, l8, served, p8, tape8 = moe_serve(cfg, model, prompts, 8, False, card, label)
    moe_e2e(model, prompts, s8, tape8, label, card)
    del tape8
    with model_kernel_call(newest_row_dropped):
        sf, _, _, _, tapef = moe_serve(cfg, model, prompts, 8, False, card, label + " fault")
    bad = moe_e2e(model, prompts, sf, tapef, label + " planted fault (K4's newest row left out)",
                  card, check_margin=False)
    check(bad > MOE_LOGIT_MARGIN, f"the moe serve e2e check passes a planted K4 fault ({bad})")
    del tapef
    s4, l4, _, p4, tape4 = moe_serve(cfg, model, prompts, 4, False, card, label + " 4 lanes")
    moe_e2e(model, prompts, s4, tape4, label + " 4 lanes", card)
    t4, lt4, _, _, _ = moe_serve(cfg, model, prompts, 4, True, card, label + " 4 lanes prewarmed")
    same = moe_twin_streams(label + " 4 lanes prewarmed", model, prompts, tape4, s4, t4)
    log(f"{label} 4 lanes prewarmed: {same} of {len(prompts)} streams equal to the eager "
        f"serve's | {card}")
    del tape4
    paths = {k: p8.get(k, 0) + p4.get(k, 0) for k in ("selective", "all_experts")}
    check(all(paths.values()), f"moe serve: expert paths {paths}: not both taken")
    records, _ = run_paged_kernel_phase(cfg, served, card, grid=False, probes=False)
    check(set(records) == {"t1", "tile"}, f"moe serve: K4 sources served {list(records)}")
    out["k4"] = {s: dict(records[s], launches=l8[s] + l4[s] + lt4[s]) for s in ("t1", "tile")}

    # (b) int8, per channel
    # the int8 model's logits on the bf16 model's expert choices: the band
    # holds the weights' rounding, not the routing flips it causes (logged)
    probe = torch.as_tensor([prompts[5]], device="cuda")
    routes: list = []
    with route_tape(routes, "record"):
        ref_logits = model(probe)
    quantize_model(model, QuantizationConfig(quantized_dtype="int8"))
    q_bytes = weight_bytes(model)
    with route_tape(list(routes), "replay"):
        rel, diff, agree = logit_band(model(probe), ref_logits)
    free = logit_band(model(probe), ref_logits)
    with per_tensor_dequant(), route_tape(list(routes), "replay"):
        bad_rel, bad_diff, bad_agree = logit_band(model(probe), ref_logits)
    log(f"moe serve int8: weights {q_bytes} B = {q_bytes / bf16_bytes:.6f} of bf16's; a "
        f"{probe.shape[1]}-token prompt's logits against bf16's, on bf16's expert choices: "
        f"relative L2 {rel:.6g} (band {QUANT_REL_L2}); JAX's tiny-model band (max |diff| < "
        f"{QUANT_LOGIT_BAND}, argmax agreement > {QUANT_ARGMAX_AGREE}) reads {diff:.6g}, "
        f"{agree:.6f}; witness, routing on its own: {free[0]:.6g}, {free[1]:.6g}, "
        f"{free[2]:.6f}; planted fault (per-tensor scale in the dequantize): {bad_rel:.6g}, "
        f"{bad_diff:.6g}, {bad_agree:.6f} | {card}")
    check(rel <= QUANT_REL_L2, f"moe serve int8 logits: relative L2 {rel}")
    check(bad_rel > QUANT_REL_L2, f"the int8 logit band passes a per-tensor dequantize "
          f"({bad_rel})")
    del ref_logits
    label = "moe serve mixtral int8"
    sq, lq, _, _, tapeq = moe_serve(cfg, model, prompts, 8, False, card, label)
    moe_e2e(model, prompts, sq, tapeq, label, card)
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    tq, ltq, _, _, _ = moe_serve(cfg, model, prompts, 8, True, card, label + " prewarmed")
    peak = torch.cuda.max_memory_allocated() - held
    same = moe_twin_streams(label + " prewarmed", model, prompts, tapeq, sq, tq)
    log(f"{label} prewarmed: {same} of {len(prompts)} streams equal to the eager serve's "
        f"| {card}")
    del tapeq
    # what a whole-model dequantize holds at once: every quantized weight in bf16
    quantized = [(m, n) for _, m in model.named_modules() for n in getattr(m, "_quantized", {})]
    deq_bytes = sum(getattr(m, n + "_qvalue").numel() * 2 for m, n in quantized)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        whole = [getattr(m, n) for m, n in quantized]
        model(probe)
    fault_peak = torch.cuda.max_memory_allocated() - held
    del whole
    log(f"{label} memory: the prewarmed serve's peak {peak} B above the {held} B held before "
        f"it (bound: the quantized weights in bf16, {deq_bytes} B, which a whole-model "
        f"dequantize holds at once); planted fault (every layer dequantized at once, then a "
        f"forward): {fault_peak} B | {card}")
    check(peak < deq_bytes, f"{label}: peak {peak} B above the model, not below the "
          f"dequantized weights' {deq_bytes}")
    check(fault_peak >= deq_bytes, f"the memory check passes a whole-model dequantize "
          f"({fault_peak})")
    out["int8_launches"] = {s: lq[s] + ltq[s] for s in lq}
    del model
    gc.collect()
    torch.cuda.empty_cache()

    # (c) DBRX
    dcfg = dataclasses.replace(DBRX_CONFIGS["dbrx"], num_layers=DBRX_SERVE_LAYERS,
                               use_paged_kernel=True, max_seq_len=2048)
    dmodel = DbrxForCausalLM(dcfg, device="cuda").init_weights(SEED)
    dprompts = moe_prompts(dcfg.vocab_size)
    log(f"moe serve: dbrx widths (hidden {dcfg.hidden_size}, {dcfg.num_heads} / "
        f"{dcfg.num_kv_heads} heads, E {dcfg.num_experts}, k {dcfg.top_k}, LayerNorm, clip_qkv "
        f"{dcfg.clip_qkv}), depth cut to {dcfg.num_layers} of 40 layers, bf16 "
        f"({weight_bytes(dmodel)} B) | {card}")
    sd, ld, dserved, pd, taped = moe_serve(dcfg, dmodel, dprompts, 4, False, card,
                                           "moe serve dbrx")
    moe_e2e(dmodel, dprompts, sd, taped, "moe serve dbrx", card)
    check(pd.get("selective", 0) > 0, f"moe serve dbrx: expert paths {pd}")
    td, ltd, _, _, _ = moe_serve(dcfg, dmodel, dprompts, 4, True, card, "moe serve dbrx prewarmed")
    same = moe_twin_streams("moe serve dbrx prewarmed", dmodel, dprompts, taped, sd, td)
    log(f"moe serve dbrx prewarmed: {same} of {len(dprompts)} streams equal to the eager "
        f"serve's | {card}")
    drecords, _ = run_paged_kernel_phase(dcfg, dserved, card, grid=False, probes=False)
    check(set(drecords) == {"t1", "tile"}, f"moe serve dbrx: K4 sources served {list(drecords)}")
    out["k4_dbrx"] = {s: dict(drecords[s], launches=ld[s] + ltd[s]) for s in ("t1", "tile")}
    del dmodel, taped
    gc.collect()
    torch.cuda.empty_cache()
    return out

# -- 7. LoRA, GPT-NeoX / CodeGen and BERT -------------------------------------------

LORA_R, LORA_ALPHA = 8, 16.0
LORA_BATCH = 2
LORA_STEPS = 4
#: the adapters' learning rate: a step of AdamW moves B by about the
#: learning rate, and scaling · A @ B must outgrow a bf16 ulp of the 1B's
#: N(0, 0.02) weights (~8e-5) for the merged step to move the loss: at 1e-3
#: a step moves a merged weight by ~1e-4 to 5e-4. On an H100 at 1e-2 the
#: losses oscillated (12.16, 11.29, 11.69, 11.50, then 12.76) and the
#: kernel-vs-plain gradients of the unsettled step read 0.0689 (targets)
#: and 0.0820 (adapters); at 1e-3 the losses fall each step and the same
#: check reads 0.0478 and 0.0446, inside the train bands
LORA_LR = 1e-3
#: K1-K3 at the LoRA step's shape: the 1B's heads (32 / 8, D 64) at batch 2
LORA_FLASH_CASES = (("lora 1b train causal (D 64, G 4)", 2, 32, 8, 2048, 64, True, 10),)
#: an adapter-only tag of the default targets at r 8 over the 1B holds
#: 16 x (2048 x 8 x 4 + 8 x (2048 x 2 + 512 x 2)) bf16 values, 3.9 MB
LORA_TAG_LIMIT = 16 * 2 ** 20
NEOX_TRAIN_LAYERS = 2
NEOX_TRAIN_BATCH = 2
#: K1-K3 at Pythia-6.9B's train shape: B 2, 32 / 32 heads (MHA, G 1), D 128
NEOX_FLASH_CASES = (("pythia train causal (D 128, G 1)", 2, 32, 32, 2048, 128, True, 10),)
#: K1-K3 at gpt-neox-20b's train shape (B 2, 64 / 64 heads, MHA, D 96),
#: timed, with the planted faults; then D 96 under the full mask with a GQA
#: group of 4 at an unaligned S (the CPU tests' other D 96 modes), checked
NEOX20B_FLASH_CASES = (("gpt-neox-20b train causal (D 96, G 1)", 2, 64, 64, 2048, 96, True, 10),
                       ("D 96 full, G 4, unaligned S 1000", 2, 16, 4, 1000, 96, False, 10))
NEOX_TIMED_STEPS = 2
NEOX_SERVE_LAYERS = 4
#: the gpt-neox-20b serve's chunked twin: 256-token prefill chunks, each
#: after a prompt's first taken by the paged kernel at t = 256 (256 tile
#: rows at G 1, past paged_decode_tile.cu's 128: csrc/paged_decode.cu), the
#: prefill ladder given the chunk's rung
NEOX20B_CHUNK = 256
NEOX20B_CHUNK_BUCKETS = (8, 64, 256, 1024)
#: the pools K4 is held in at the gpt-neox-20b serve's geometries: bf16
#: (timed), int8 in mode 3 and fp8 e4m3 in mode 6 (checked)
NEOX20B_POOLS = (("bf16", False), ("int8", False), ("fp8_e4m3", True))
CODEGEN_SERVE_LAYERS = 2
#: the GPT-NeoX / CodeGen serves' e2e margin: twice the first sound reading
#: of the 8-lane Pythia serve on an H100 (0.03125; CodeGen's read 0.03125
#: too); the planted K4 fault read 0.25
NEOX_LOGIT_MARGIN = 0.0625
BERT_BATCH = 8
BERT_SEQ = 512
#: the bf16 BERT-large step against the fp32 step on the same weights and
#: batch: |loss difference| and the largest per-parameter relative L2 error
#: of the encoder layers' gradients, each twice its first sound reading on
#: an H100 (8.29697e-05; 0.0354321 at a layer-6 q bias). The embedding
#: tables' gradients, bf16 sums over every token of the batch into a few
#: rows (the token type table's 2 rows read 0.301384), are logged as a
#: witness. The planted fault (the padding mask left out) read a loss gap of
#: 0.00710297 and a layer gradient of 0.597176
BERT_LOSS_BAND = 0.000166
BERT_GRAD_BAND = 0.0709
BERT_PRETRAIN_STEPS = 4


def lora_base(cfg):
    """The 1B at ``cfg``'s knobs with the SEED weights (load_model's: the
    same draws, whatever the knobs)."""
    from neuronx_distributed_llama3_2_tpu_torch.models.llama import LlamaForCausalLM

    return LlamaForCausalLM(cfg, device="cuda").init_weights(SEED)


def run_lora_train_phase(card: str) -> dict:
    """Llama-3.2 1B at full width and depth under the LoRA adapters of the
    default targets (q, k, v, o; r LORA_R, alpha LORA_ALPHA), the 1B's train
    knobs (flash, remat full, CE chunked, AdamW bf16 state), batch
    LORA_BATCH x 2048, through the trainer (``initialize_parallel_model``
    / ``make_train_step`` on the ``LoraModel``): (a) at B = 0 the adapted
    logits equal the base's bit for bit (a planted B off zero must move
    them); (b) LORA_STEPS steps, (K1, K2, K3) launched (2L, L, L) a step,
    the losses falling, the base's weights bit for bit unchanged, AdamW's
    state below 1/20 of the base's bytes; (c) one step's loss and adapter
    gradients through K1-K3 against the plain-attention step on the same
    base and adapters, within LOSS_BAND / GRAD_BAND, and a planted K3 fault
    (the diagonal kv tile skipped) above GRAD_BAND; (d) the adapter-only
    tag saved and loaded bit for bit, under LORA_TAG_LIMIT; (e) K1-K3 at
    the step's shape (LORA_FLASH_CASES). Returns the trained LoraModel, its
    base, the K1-K3 records and launches."""
    from neuronx_distributed_llama3_2_tpu_torch.checkpoint import (
        load_checkpoint,
        save_checkpoint,
    )
    from neuronx_distributed_llama3_2_tpu_torch.lora import LoraConfig, LoraModel
    from neuronx_distributed_llama3_2_tpu_torch.models.llama import FLASH_FWD_PER_LAYER
    from neuronx_distributed_llama3_2_tpu_torch.trainer import (
        initialize_parallel_model,
        make_train_step,
    )
    from neuronx_distributed_llama3_2_tpu_torch.trainer.optimizer import state_bytes

    cfg, tc = train_configs()
    tc = dataclasses.replace(tc, optimizer=dataclasses.replace(tc.optimizer,
                                                               learning_rate=LORA_LR))
    tc.initialize("cuda")
    batch = train_batch(cfg, LORA_BATCH)
    base = lora_base(cfg)
    base_bytes = sum(p.numel() * p.element_size() for p in base.parameters())
    with torch.no_grad():
        ref = base(batch["input_ids"][:1])
    frozen = {k: p.detach().clone() for k, p in base.named_parameters()}
    lcfg = LoraConfig(r=LORA_R, alpha=LORA_ALPHA)
    lora = LoraModel(base, lcfg)
    state, _ = initialize_parallel_model(lora, tc, key=SEED)
    n_adapter = sum(p.numel() for p in state.params.values())
    log(f"lora train: llama3.2-1b, {cfg.num_layers} layers, default targets (q, k, v, o), r "
        f"{LORA_R}, alpha {LORA_ALPHA}: {n_adapter} adapter parameters over "
        f"{sum(p.numel() for p in base.parameters())} frozen; batch {LORA_BATCH} x {TRAIN_SEQ}, "
        f"remat {cfg.remat}, flash attention, lr {LORA_LR} | {card}")
    # (a) B = 0
    with torch.no_grad():
        zero_gap = (lora(batch["input_ids"][:1]).float() - ref.float()).abs().max().item()
        probe = lora.adapter("layers.0.attn.qkv.q_kernel").b
        probe.fill_(1e-2)
        moved = (lora(batch["input_ids"][:1]).float() - ref.float()).abs().max().item()
        probe.zero_()
    del ref
    log(f"lora train B = 0: the adapted logits differ from the base's by {zero_gap:.6g} (must be "
        f"0); planted fault (layer 0's q adapter B set to 0.01): {moved:.6g}")
    check(zero_gap == 0.0, f"lora train: B = 0 logits {zero_gap} from the base's")
    check(moved > 0.0, "the B = 0 check passes adapters off zero")
    # (b) the steps
    step = make_train_step(lora, tc)
    L = cfg.num_layers
    want = (FLASH_FWD_PER_LAYER[cfg.remat] * L, L, L)
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms, launches = [], [], (0, 0, 0)
    for i in range(LORA_STEPS):
        prev = flash_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        step_ms.append(1e3 * (time.perf_counter() - t0))
        per_step = tuple(a - b for a, b in zip(flash_counts(), prev))
        check(per_step == want, f"lora train step {i}: (K1, K2, K3) launches {per_step}, "
              f"want {want}")
        launches = tuple(a + b for a, b in zip(launches, per_step))
    unchanged = all(torch.equal(p, frozen[k]) for k, p in base.named_parameters())
    del frozen
    opt_bytes = state_bytes(state.opt)
    log(f"lora train: steps {[round(x, 6) for x in step_ms]} ms (the first the warm-up), losses "
        f"{losses}; (K1, K2, K3) launches {launches} over {LORA_STEPS} steps; base weights "
        f"unchanged: {unchanged}; AdamW state {opt_bytes} B against the base's {base_bytes} B "
        f"({opt_bytes / base_bytes:.6f}); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.6f} GiB | {card}")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0], f"lora train losses {losses}")
    check(unchanged, "lora train: a step moved the base's weights")
    check(opt_bytes < base_bytes / 20, f"lora train: AdamW state {opt_bytes} B, not adapter-sized")
    # (c) flash against plain attention, on the trained adapters
    plain_base = lora_base(dataclasses.replace(cfg, use_flash_attention=False))
    plain = LoraModel(plain_base, lcfg)
    plain.load_state_dict(lora.state_dict())
    ref_loss, ref_grads, ref_w = lora_loss_and_grads(plain, batch)
    del plain, plain_base
    gc.collect()
    torch.cuda.empty_cache()
    loss, grads, grads_w = lora_loss_and_grads(lora, batch)
    loss_gap = abs(loss - ref_loss)
    gap, at = grad_gap(grads, ref_grads)
    gap_w, at_w = grad_gap(grads_w, ref_w)
    del grads, grads_w
    with k3_skips_diagonal():
        _, bad_grads, bad_w = lora_loss_and_grads(lora, batch)
    bad_gap, bad_at = grad_gap(bad_grads, ref_grads)
    bad_gap_w, _ = grad_gap(bad_w, ref_w)
    del bad_grads, ref_grads, bad_w, ref_w
    log(f"lora train e2e: loss {loss:.6f} through the kernels vs {ref_loss:.6f} plain (gap "
        f"{loss_gap:.6g}, band {LOSS_BAND}); largest gradient relative L2 error of the adapters "
        f"{gap:.6g} at {at}, of the adapted target weights {gap_w:.6g} at {at_w} (band "
        f"{GRAD_BAND} each); planted fault (K3 skips the diagonal kv tile): adapters "
        f"{bad_gap:.6g} at {bad_at}, targets {bad_gap_w:.6g} | {card}")
    check(np.isfinite(loss) and loss_gap <= LOSS_BAND, f"lora train loss gap {loss_gap}")
    check(gap <= GRAD_BAND, f"lora train adapter gradient gap {gap} at {at}")
    check(gap_w <= GRAD_BAND, f"lora train target-weight gradient gap {gap_w} at {at_w}")
    check(bad_gap > GRAD_BAND and bad_gap_w > GRAD_BAND,
          f"the lora train check passes a planted K3 fault ({bad_gap}, {bad_gap_w})")
    # (d) the adapter-only tag
    root = work_dir() / "lora"
    own = dict(lora.named_parameters())
    t0 = time.perf_counter()
    save_checkpoint(str(root), "adapters", model=own)
    save_s = time.perf_counter() - t0
    nbytes = tag_bytes(root / "adapters")
    back = load_checkpoint(str(root), "adapters", model=own)["model"]
    same = all(torch.equal(back[k], p) for k, p in own.items())
    log(f"lora train tag: {nbytes} B saved in {save_s:.6f} s (limit {LORA_TAG_LIMIT}); loaded "
        f"back bit for bit: {same} | {card}")
    check(same and nbytes < LORA_TAG_LIMIT, f"lora tag: {nbytes} B, bitwise {same}")
    del back, step, state
    gc.collect()
    torch.cuda.empty_cache()
    return dict(lora=lora, base=base, config=lcfg, launches=launches,
                flash=run_flash_kernel_phase(card, cases=LORA_FLASH_CASES))


def lora_loss_and_grads(lora, batch):
    """(loss, the adapters' gradients, the gradients of the adapted target
    weights): the base's targets take a gradient for the call (what the
    merged reads add to), so the step's full-weight gradients read as the
    1B train check's do."""
    targets = {k: p for k, p in lora.base.named_parameters() if k in lora._plan}
    adapters = dict(lora.named_parameters())
    for p in targets.values():
        p.requires_grad_(True)
    try:
        loss = lora.loss(batch["input_ids"], batch["labels"])
        grads = torch.autograd.grad(loss, [*adapters.values(), *targets.values()])
    finally:
        for p in targets.values():
            p.requires_grad_(False)
    n = len(adapters)
    return loss.detach().item(), dict(zip(adapters, grads[:n])), dict(zip(targets, grads[n:]))


@contextlib.contextmanager
def scaling_applied_twice():
    """A planted fault: the LoRA merge scales A @ B by scaling squared."""
    from neuronx_distributed_llama3_2_tpu_torch.lora import model as lm

    inner = lm.LoraModel._delta

    def delta(self, name, w):
        return (inner(self, name, w).float() * self.lora_config.scaling).to(w.dtype)

    lm.LoraModel._delta = delta
    try:
        yield
    finally:
        lm.LoraModel._delta = inner


def merge_gap(base, lora, merged: dict) -> float:
    """The largest error of a merged target weight against W + delta, delta
    = scaling · A @ B, computed apart in fp32, in bf16 ulps of the largest
    of |W|, |W + delta| and |delta|: the merge rounds delta to bf16 and the
    sum to bf16, half an ulp of each."""
    worst = 0.0
    params = dict(base.named_parameters())
    s = lora.lora_config.scaling
    for name in lora._plan:
        ad = lora.adapter(name)
        delta = s * (ad.a.float() @ ad.b.float())
        want = params[name].float() + delta
        ulp = bf16_ulp(torch.maximum(torch.maximum(want.abs(), delta.abs()),
                                     params[name].float().abs()))
        worst = max(worst, ((merged[name].float() - want).abs() / ulp).max().item())
    return worst


def run_lora_serve_phase(trained: dict, eager_outs: list, card: str) -> None:
    """The trained adapters merged into the 1B (``merge_lora``), served by
    the paged engine with the paged kernel on Serve's prompts: (a) every
    merged target within one bf16 ulp of base + scaling · A @ B computed
    apart in fp32, and a merge that applies the scaling twice outside it;
    (b) every served token within E2E_LOGIT_MARGIN of the plain forward over
    the merged weights; (c) a B = 0 merge serves Serve's eager streams (the
    near-tie rule)."""
    from neuronx_distributed_llama3_2_tpu_torch.lora import merge_lora
    from neuronx_distributed_llama3_2_tpu_torch.models.llama import LLAMA_CONFIGS

    base, lora, lcfg = trained["base"], trained["lora"], trained["config"]
    cfg = dataclasses.replace(LLAMA_CONFIGS["llama3.2-1b"], use_paged_kernel=True)
    adapters = lora.state_dict()
    with torch.no_grad():
        merged = merge_lora(base, adapters, lcfg)
        gap = merge_gap(base, lora, merged)
        with scaling_applied_twice():
            bad = merge_gap(base, lora, merge_lora(base, adapters, lcfg))
    log(f"lora serve merge: merged targets within {gap:.6g} bf16 ulps (of the largest of W, "
        f"the merged value and the delta) of W + scaling * A @ B in fp32 (limit 1); planted fault "
        f"(the scaling applied twice): {bad:.6g} | {card}")
    check(gap <= 1.0, f"lora merge: {gap} ulps")
    check(bad > 1.0, f"the merge check passes the scaling applied twice ({bad})")
    served = lora_base(cfg)
    served.load_state_dict(merged)
    del merged
    prompts = serve_prompts()
    before = k4_counts()
    server = make_server(cfg, served)
    t0 = time.perf_counter()
    rids = [server.submit(p) for p in prompts]
    outs = server.run_to_completion()
    torch.cuda.synchronize()
    stats = serve_stats(server, rids, outs, time.perf_counter() - t0)
    launched = {k: k4_counts()[k] - before[k] for k in before}
    worst, exact, total = e2e_gaps(served, prompts, outs, rids)
    log(f"lora serve: the merged 1B over 8 lanes: {stats['tokens_s']:.6f} tokens/s, TTFT p50 "
        f"{stats['ttft']:.6f} ms, TPOT p50 {stats['tpot']:.6f} ms; K4 launches by source "
        f"{launched}; e2e: {exact} of {total} served tokens the plain forward's argmax, the "
        f"worst within {worst:.6g} logits (margin {E2E_LOGIT_MARGIN}) | {card}")
    check(launched["t1"] > 0 and launched["tile"] > 0, f"lora serve: K4 launches {launched}")
    check(worst <= E2E_LOGIT_MARGIN, f"lora serve: a served token {worst} below the argmax")
    del server, outs
    # (c) B = 0
    zero = {k: torch.zeros_like(v) if k.endswith(".b") else v for k, v in adapters.items()}
    with torch.no_grad():
        served.load_state_dict(merge_lora(base, zero, lcfg))
    server = make_server(cfg, served)
    rids = [server.submit(p) for p in prompts]
    outs = server.run_to_completion()
    streams = [outs[r] for r in rids]
    differ = same_streams("lora serve B = 0", served, prompts, streams, eager_outs, rids)
    log(f"lora serve B = 0: {len(prompts) - len(differ)} of {len(prompts)} streams equal to "
        f"Serve's eager streams (the rest near ties) | {card}")
    del server, served
    gc.collect()
    torch.cuda.empty_cache()


def neox_train_configs(layers: int, name: str = "pythia-6.9b"):
    """The GPT-NeoX config ``name`` at full width and ``layers`` layers,
    with the 1B's train knobs: (model config, TrainingConfig)."""
    from neuronx_distributed_llama3_2_tpu_torch.models.gptneox import GPTNEOX_CONFIGS

    _, tc = train_configs()
    cfg = dataclasses.replace(
        GPTNEOX_CONFIGS[name], num_layers=layers, remat="full",
        max_seq_len=TRAIN_SEQ, use_flash_attention=True, flash_block_q=1024,
        flash_block_kv=1024, loss_chunk_size=256,
    )
    return cfg, tc


def run_neox_train_phase(card: str, name: str = "pythia-6.9b", cases=NEOX_FLASH_CASES,
                         label: str = "neox train") -> dict:
    """The train step of the GPT-NeoX config ``name`` at full width
    (Pythia-6.9B: hidden 4096, 32 heads MHA, D 128; gpt-neox-20b: hidden
    6144, 64 heads MHA, D 96; both rotary on 25 %, vocab 50432, untied),
    NEOX_TRAIN_LAYERS layers, batch NEOX_TRAIN_BATCH x 2048: one step's loss
    and gradients through K1-K3 against the plain-attention step (same
    weights) within LOSS_BAND / GRAD_BAND, a planted K3 fault above
    GRAD_BAND; a warm-up and NEOX_TIMED_STEPS steps through the trainer,
    (K1, K2, K3) launched (2L, L, L) a step; K1-K3 at the train shape
    against their plain versions (``cases``, the first the train shape: the
    kernel check rejects a K3 with one kv tile left out, and at D 96 a K1
    whose scores leave out columns 64-95). Returns the K1-K3 records and
    launches."""
    from neuronx_distributed_llama3_2_tpu_torch.models.gptneox import (
        GPTNEOX_CONFIGS,
        GPTNeoXForCausalLM,
    )
    from neuronx_distributed_llama3_2_tpu_torch.models.llama import FLASH_FWD_PER_LAYER
    from neuronx_distributed_llama3_2_tpu_torch.trainer import (
        initialize_parallel_model,
        make_train_step,
    )

    cfg, tc = neox_train_configs(NEOX_TRAIN_LAYERS, name)
    tc.initialize("cuda")
    batch = train_batch(cfg, NEOX_TRAIN_BATCH)
    torch.cuda.reset_peak_memory_stats()
    model = GPTNeoXForCausalLM(cfg, device="cuda")
    state, _ = initialize_parallel_model(model, tc, key=SEED)
    n_params = sum(p.numel() for p in state.params.values())
    log(f"{label}: {name} widths (hidden {cfg.hidden_size}, intermediate "
        f"{cfg.intermediate_size}, {cfg.num_heads} / {cfg.num_kv_heads} heads, head_dim "
        f"{cfg.head_dim}, rotary {cfg.rotary_dims} of {cfg.head_dim}, vocab {cfg.vocab_size}, "
        f"untied), depth cut to {cfg.num_layers} of {GPTNEOX_CONFIGS[name].num_layers} layers: "
        f"{n_params} parameters, bf16, seeded random weights; batch {NEOX_TRAIN_BATCH} x "
        f"{TRAIN_SEQ}, remat {cfg.remat}, flash attention | {card}")
    plain = GPTNeoXForCausalLM(dataclasses.replace(cfg, use_flash_attention=False), device="cuda")
    plain.load_state_dict(model.state_dict())
    ref_loss, ref_grads = loss_and_grads(plain, batch)
    del plain
    gc.collect()
    torch.cuda.empty_cache()
    loss, grads = loss_and_grads(model, batch)
    loss_gap = abs(loss - ref_loss)
    gap, at = grad_gap(grads, ref_grads)
    del grads
    with k3_skips_diagonal():
        _, bad_grads = loss_and_grads(model, batch)
    bad_gap, bad_at = grad_gap(bad_grads, ref_grads)
    del bad_grads, ref_grads
    log(f"{label} e2e: loss {loss:.6f} through the kernels vs {ref_loss:.6f} plain (gap "
        f"{loss_gap:.6g}, band {LOSS_BAND}); largest gradient relative L2 error {gap:.6g} at "
        f"{at} (band {GRAD_BAND}); planted fault (K3 skips the diagonal kv tile): "
        f"{bad_gap:.6g} at {bad_at} | {card}")
    check(np.isfinite(loss) and loss_gap <= LOSS_BAND, f"{label} loss gap {loss_gap}")
    check(gap <= GRAD_BAND, f"{label} gradient gap {gap} at {at}")
    check(bad_gap > GRAD_BAND, f"the {label} check passes a planted K3 fault ({bad_gap})")
    gc.collect()
    torch.cuda.empty_cache()

    step = make_train_step(model, tc)
    t0 = time.perf_counter()
    state, m = step(state, batch)
    losses = [float(m["loss"])]
    warm_ms = 1e3 * (time.perf_counter() - t0)
    want = (FLASH_FWD_PER_LAYER[cfg.remat] * cfg.num_layers, cfg.num_layers, cfg.num_layers)
    launches, step_ms = (0, 0, 0), []
    for i in range(NEOX_TIMED_STEPS):
        prev = flash_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        step_ms.append(1e3 * (time.perf_counter() - t0))
        per_step = tuple(a - b for a, b in zip(flash_counts(), prev))
        check(per_step == want, f"{label} step {i}: (K1, K2, K3) launches {per_step}, "
              f"want {want}")
        launches = tuple(a + b for a, b in zip(launches, per_step))
    check(all(np.isfinite(losses)), f"non-finite {label} loss: {losses}")
    log(f"{label}: warm-up {warm_ms:.6f} ms, steps {[round(x, 6) for x in step_ms]} ms "
        f"(median {float(np.median(step_ms)):.6f}), losses {losses}; (K1, K2, K3) launches "
        f"{launches} over {NEOX_TIMED_STEPS} steps; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.6f} GiB | {card}")
    del model, state, step
    gc.collect()
    torch.cuda.empty_cache()
    return dict(launches=launches, flash=run_flash_kernel_phase(card, cases=cases))


def neox_e2e(model, prompts, streams, label: str, card: str, check_margin: bool = True) -> float:
    """Every served token (``streams`` in prompt order) teacher-forced
    through ``model``'s plain forward: within NEOX_LOGIT_MARGIN of its
    argmax. Returns the worst gap."""
    worst, exact, total = e2e_gaps(model, prompts, dict(enumerate(streams)), range(len(streams)))
    log(f"{label} e2e: {exact} of {total} served tokens the plain forward's argmax, the worst "
        f"within {worst:.6g} logits (margin {NEOX_LOGIT_MARGIN}) | {card}")
    if check_margin:
        check(worst <= NEOX_LOGIT_MARGIN, f"{label}: a served token {worst} below the argmax")
    return worst


def neox_paged_serve(card: str, name: str, label: str, chunked: bool = False,
                     pools=(("bf16", False),)) -> dict:
    """The GPT-NeoX config ``name`` at full width, NEOX_SERVE_LAYERS layers,
    bf16, K4 on: Serve's prompts (ids modulo the vocab) over 8 lanes, eager
    with every K4 call's geometry recorded (``moe_serve`` unrouted, its short
    prefill ladder), every served token within NEOX_LOGIT_MARGIN of the
    plain forward; the same serve through a planted K4 fault (the newest row
    left out) above it; the prewarmed twin's streams (the near-tie rule).
    With ``chunked``, a twin with NEOX20B_CHUNK-token prefill chunks whose
    every later chunk the kernel takes at t = NEOX20B_CHUNK (at G 1 past the
    tile source's 128 rows: csrc/paged_decode.cu), its tokens within the
    margin too. Then K4 at every geometry the eager serves launched against
    its plain version, in each of ``pools`` (the first timed, the others
    checked; at D 96 the check must reject scores that leave out columns
    64-95). Returns the first pool's records by source, each with its
    launches over the serves."""
    from neuronx_distributed_llama3_2_tpu_torch.models.gptneox import (
        GPTNEOX_CONFIGS,
        GPTNeoXForCausalLM,
    )
    from neuronx_distributed_llama3_2_tpu_torch.quantization.quantize import weight_bytes

    full = GPTNEOX_CONFIGS[name]
    cfg = dataclasses.replace(full, num_layers=NEOX_SERVE_LAYERS, use_paged_kernel=True,
                              max_seq_len=2048)
    model = GPTNeoXForCausalLM(cfg, device="cuda").init_weights(SEED)
    prompts = moe_prompts(cfg.vocab_size)
    log(f"{label}: {name} widths ({cfg.num_heads} / {cfg.num_kv_heads} heads, G "
        f"{cfg.num_heads // cfg.num_kv_heads}, D {cfg.head_dim}, hidden {cfg.hidden_size}), "
        f"depth cut to {cfg.num_layers} of {full.num_layers} layers, bf16, seeded random "
        f"weights ({weight_bytes(model)} B); Serve's prompts, ids modulo {cfg.vocab_size} | "
        f"{card}")
    s8, l8, served, _, _ = moe_serve(cfg, model, prompts, 8, False, card, label, routed=False)
    neox_e2e(model, prompts, s8, label, card)
    with model_kernel_call(newest_row_dropped):
        sf, _, _, _, _ = moe_serve(cfg, model, prompts, 8, False, card, label + " fault",
                                   routed=False)
    bad = neox_e2e(model, prompts, sf, label + " planted fault (K4's newest row left out)",
                   card, check_margin=False)
    check(bad > NEOX_LOGIT_MARGIN, f"the {label} e2e check passes a planted K4 fault ({bad})")
    t8, lt8, _, _, _ = moe_serve(cfg, model, prompts, 8, True, card, label + " prewarmed",
                                 routed=False)
    differ = same_streams(label + " prewarmed", model, prompts, t8, s8, list(range(len(prompts))))
    log(f"{label} prewarmed: {len(prompts) - len(differ)} of {len(prompts)} streams equal to the "
        f"eager serve's (the rest near ties) | {card}")
    launched = {s: l8[s] + lt8[s] for s in l8}
    if chunked:
        ccfg = dataclasses.replace(cfg, paged_kernel_max_t=NEOX20B_CHUNK)
        sc, lc, c_served, _, _ = moe_serve(
            ccfg, model, prompts, 8, False, card, label + " chunked", routed=False,
            prefill_chunk_tokens=NEOX20B_CHUNK, prefill_buckets=NEOX20B_CHUNK_BUCKETS)
        neox_e2e(model, prompts, sc, label + " chunked", card)
        check(lc["split"] > 0, f"{label} chunked: no chunk reached paged_decode.cu ({lc})")
        launched = {s: launched[s] + lc[s] for s in launched}
        for k, e in c_served.items():
            served.setdefault(k, dict(e, calls=0))["calls"] += e["calls"]
    records = {}
    for i, (kv_dtype, mxu) in enumerate(pools):
        got, _ = run_paged_kernel_phase(cfg, served, card, kv_dtype=kv_dtype, mxu=mxu,
                                        grid=False, probes=False, time_served=i == 0)
        records = records or got
    want = {s for s, n in launched.items() if n}
    check(set(records) == want, f"{label}: K4 sources served {list(records)}, launched {want}")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return {s: dict(records[s], launches=launched[s]) for s in records}


def run_neox_serve_phase(card: str) -> dict:
    """(a) Pythia-6.9B widths (32 / 32 heads, G 1, D 128): ``neox_paged_serve``,
    K4 t1 and tile at the served G 1 geometries against their plain
    versions. (b) CodeGen2.5-7B widths (interleaved rotary on half the head,
    the shared LayerNorm, gelu_new, the head's bias), CODEGEN_SERVE_LAYERS
    layers, 4 lanes, eager, within the margin. Returns K4's records and
    launches at G 1."""
    from neuronx_distributed_llama3_2_tpu_torch.models.gptneox import (
        GPTNEOX_CONFIGS,
        GPTNeoXForCausalLM,
    )
    from neuronx_distributed_llama3_2_tpu_torch.quantization.quantize import weight_bytes

    out = neox_paged_serve(card, "pythia-6.9b", "neox serve pythia")
    check(set(out) == {"t1", "tile"}, f"neox serve: K4 sources served {list(out)}")

    ccfg = dataclasses.replace(GPTNEOX_CONFIGS["codegen25-7b"], num_layers=CODEGEN_SERVE_LAYERS,
                               use_paged_kernel=True, max_seq_len=2048)
    cmodel = GPTNeoXForCausalLM(ccfg, device="cuda").init_weights(SEED)
    cprompts = moe_prompts(ccfg.vocab_size)
    log(f"neox serve: codegen25-7b widths (interleaved rotary on {ccfg.rotary_dims} of "
        f"{ccfg.head_dim}, shared LayerNorm, gelu_new, head bias), depth cut to "
        f"{ccfg.num_layers} of 32 layers, bf16 ({weight_bytes(cmodel)} B) | {card}")
    sc, lc, _, _, _ = moe_serve(ccfg, cmodel, cprompts, 4, False, card, "neox serve codegen",
                                routed=False)
    neox_e2e(cmodel, cprompts, sc, "neox serve codegen", card)
    check(lc["t1"] > 0 and lc["tile"] > 0, f"neox serve codegen: K4 launches {lc}")
    for s in ("t1", "tile"):
        out[s]["launches"] += lc[s]
    del cmodel
    gc.collect()
    torch.cuda.empty_cache()
    return out


def run_neox20b_serve_phase(card: str) -> dict:
    """gpt-neox-20b widths (64 / 64 heads, G 1, D 96: K4's D 96 instances):
    ``neox_paged_serve`` with the chunked twin, so that the serves launch
    all three K4 sources (t1 the decode, tile the suffix prefills and short
    last chunks, paged_decode.cu the 256-token chunks), and K4 at every
    served geometry in NEOX20B_POOLS. Returns the bf16 records by source
    with their launches."""
    out = neox_paged_serve(card, "gpt-neox-20b", "neox20b serve", chunked=True,
                           pools=NEOX20B_POOLS)
    check(set(out) == {"t1", "tile", "split"}, f"neox20b serve: K4 sources served {list(out)}")
    return out


def bert_tokens(n: int, vocab: int) -> np.ndarray:
    """``n`` tokens of four seeded 64-token motifs (ids 1000-1511) in seeded
    order: an MLM objective a few steps can learn."""
    rng = np.random.default_rng(SEED + 23)
    motifs = [rng.integers(1000, 1512, size=64) for _ in range(4)]
    order = rng.integers(0, len(motifs), size=-(-n // 64))
    return np.concatenate([motifs[i] for i in order])[:n].astype(np.int32) % vocab


def bert_batch(cfg) -> dict:
    """BERT_BATCH x BERT_SEQ: motif tokens, the pretrain script's 15 % MLM
    masks, two segments (the second from a seeded split point), rows 1, 3,
    5, 7 padded past a seeded length, seeded NSP labels."""
    from neuronx_distributed_llama3_2_tpu_torch.scripts.pretrain import mask_mlm

    rng = np.random.default_rng(SEED + 29)
    ids = bert_tokens(BERT_BATCH * BERT_SEQ, cfg.vocab_size).reshape(BERT_BATCH, BERT_SEQ)
    ids, labels = mask_mlm(ids, rng, cfg.vocab_size)
    split = rng.integers(BERT_SEQ // 4, 3 * BERT_SEQ // 4, size=(BERT_BATCH, 1))
    mask = np.ones((BERT_BATCH, BERT_SEQ), np.int64)
    for r in range(1, BERT_BATCH, 2):
        mask[r, rng.integers(BERT_SEQ // 2, BERT_SEQ):] = 0
    labels = np.where(mask == 1, labels, -100)
    batch = dict(input_ids=ids, labels=labels, attention_mask=mask,
                 token_type_ids=(np.arange(BERT_SEQ)[None] >= split).astype(np.int64),
                 next_sentence_label=rng.integers(0, 2, size=BERT_BATCH))
    return {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}


def bert_loss_and_grads(model, batch, mask: bool = True):
    """The pretraining loss (MLM + NSP) and its gradients; without ``mask``
    the padding bias is left out (a planted fault)."""
    if not mask:
        batch = {k: v for k, v in batch.items() if k != "attention_mask"}
    params = dict(model.named_parameters())
    loss = model.pretraining_loss(batch)
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.detach().item(), dict(zip(params, grads))


def run_bert_train_phase(card: str) -> None:
    """BERT-large at full width and depth (24 layers, hidden 1024, 16
    heads, S 512), MLM + NSP, batch BERT_BATCH x BERT_SEQ with padding and
    two segments: the bf16 step's loss and gradients against the fp32 step
    on the same weights and batch (BERT_LOSS_BAND / BERT_GRAD_BAND), the
    padding mask left out above them; then ``scripts.pretrain.main``
    --model bert-large over motif tokens for BERT_PRETRAIN_STEPS steps, no
    checkpoint written: losses finite and falling."""
    from neuronx_distributed_llama3_2_tpu_torch.data import write_token_file
    from neuronx_distributed_llama3_2_tpu_torch.models.bert import BERT_CONFIGS, BertForPreTraining
    from neuronx_distributed_llama3_2_tpu_torch.scripts import pretrain

    cfg = BERT_CONFIGS["bert-large"]
    model = BertForPreTraining(cfg, device="cuda").init_weights(SEED)
    f32 = BertForPreTraining(dataclasses.replace(cfg, dtype=torch.float32), device="cuda")
    f32.load_state_dict(model.state_dict())
    batch = bert_batch(cfg)
    log(f"bert train: bert-large ({cfg.num_layers} layers, hidden {cfg.hidden_size}, "
        f"{cfg.num_heads} heads, vocab {cfg.vocab_size}), "
        f"{sum(p.numel() for p in model.parameters())} parameters, seeded random weights; "
        f"batch {BERT_BATCH} x {BERT_SEQ}, {int((batch['labels'] != -100).sum())} masked "
        f"positions, {int((batch['attention_mask'] == 0).sum())} padded | {card}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref_loss, ref_grads = bert_loss_and_grads(f32, batch)
    f32_ms = 1e3 * (time.perf_counter() - t0)
    del f32
    t0 = time.perf_counter()
    loss, grads = bert_loss_and_grads(model, batch)
    bf16_ms = 1e3 * (time.perf_counter() - t0)
    loss_gap = abs(loss - ref_loss)

    def layers(g):
        return {k: v for k, v in g.items() if k.startswith("layers.")}

    gap, at = grad_gap(layers(grads), ref_grads)
    all_gap, all_at = grad_gap(grads, ref_grads)
    del grads
    bad_loss, bad_grads = bert_loss_and_grads(model, batch, mask=False)
    bad_gap, bad_at = grad_gap(layers(bad_grads), ref_grads)
    del bad_grads, ref_grads
    log(f"bert train: bf16 loss {loss:.6f} vs fp32 {ref_loss:.6f} (gap {loss_gap:.6g}, band "
        f"{BERT_LOSS_BAND}); largest encoder-layer gradient relative L2 error {gap:.6g} at {at} "
        f"(band {BERT_GRAD_BAND}); witness, over every leaf: {all_gap:.6g} at {all_at}; "
        f"planted fault (the padding mask left out): loss gap {abs(bad_loss - ref_loss):.6g}, "
        f"layer gradient {bad_gap:.6g} at {bad_at}; one forward and backward {bf16_ms:.6f} ms "
        f"bf16, {f32_ms:.6f} ms fp32 (host clock) | {card}")
    check(np.isfinite(loss) and loss_gap <= BERT_LOSS_BAND, f"bert train loss gap {loss_gap}")
    check(gap <= BERT_GRAD_BAND, f"bert train gradient gap {gap} at {at}")
    check(abs(bad_loss - ref_loss) > BERT_LOSS_BAND or bad_gap > BERT_GRAD_BAND,
          "the bert train bands pass the padding mask left out")
    del model, batch
    gc.collect()
    torch.cuda.empty_cache()
    root = work_dir() / "bert"
    root.mkdir(parents=True, exist_ok=True)
    data = root / "tokens.npy"
    write_token_file(str(data), bert_tokens(64 * BERT_SEQ, cfg.vocab_size))
    argv = ["--model", "bert-large", "--data", str(data), "--global-batch", str(BERT_BATCH),
            "--seq-len", str(BERT_SEQ), "--steps", str(BERT_PRETRAIN_STEPS), "--lr", "1e-3",
            "--warmup-steps", "1", "--save-every", "0", "--ckpt-dir", str(root / "ckpt"),
            "--device", "cuda"]
    with LogLines() as lines, skip_save(f"step_{BERT_PRETRAIN_STEPS}"):
        run = pretrain.main(argv)
    losses = [run["losses"][s] for s in sorted(run["losses"])]
    written = tag_bytes(root)
    log(f"bert train pretrain: scripts.pretrain.main({' '.join(argv)}): losses {losses}; "
        f"{written} B under its directory (no tag); its step lines: "
        f"{[x for x in lines.lines if x.startswith('step ')]} | {card}")
    check(len(losses) == BERT_PRETRAIN_STEPS and all(np.isfinite(losses))
          and losses[-1] < losses[0], f"bert pretrain losses {losses}")
    check(not (root / "ckpt" / f"step_{BERT_PRETRAIN_STEPS}").exists() and written < 100 << 20,
          f"bert pretrain wrote {written} B")
    del run
    gc.collect()
    torch.cuda.empty_cache()


# -- Mllama (Llama-3.2 11B-Vision) ------------------------------------------------

#: the two requests: (aspect ratio id, valid tiles). HF's ratios for 4 tiles
#: are ids 1-8 of (1,1) (1,2) (1,3) (1,4) (2,1) (2,2) (3,1) (4,1): a 2 x 2
#: image of 4 tiles of 448^2, and a 1 x 2 image with 2 of its 4 tiles valid
MLLAMA_REQUESTS = ((6, 4), (2, 2))
MLLAMA_PROMPT = 64
MLLAMA_NEW = 16
#: the text attends the image from this position (the rows before it
#: attend nothing: the full-row mask zeroes their MLP branch)
MLLAMA_IMAGE_FROM = 8
MLLAMA_MAX_SEQ = 96
MLLAMA_CROSS_LAYERS = 8
#: decode steps timed and traced apart from ``generate``
MLLAMA_PROFILE_STEPS = 8
#: bf16 bands, each about twice its sound reading on an H100 80GB HBM3 at
#: 700 W (PERF.md §6, Mllama): the decoder's logits (prefill and each step)
#: against the full forward's over the same tokens, max abs (sound 0.1875
#: on both requests; the first-row step mask 4.04); the bf16 vision
#: tower's output against its fp32 copy, relative L2 over the valid and
#: over the invalid tiles (sound 0.0088 / 0.0091; the tile bias left out
#: 0.129 / 0.131). A stream token must be the teacher-forced forward's
#: argmax or within LOGIT_MARGIN of it (sound: every token the argmax)
MLLAMA_LOGIT_BAND = 0.375
MLLAMA_VISION_BAND = 0.02
#: at N(0, 0.02) weights a vision layer's attention adds ~1 % to the
#: residual stream (random scores spread each token's weights over ~4K
#: keys, and the MLP dominates), so the bias it is steered by moves the
#: output by about bf16's own error; the tower check runs with the
#: attention output kernels scaled by this
MLLAMA_VISION_ATTN_SCALE = 8.0
#: the train phase: 11B widths, the vision tower at full depth, the text
#: cut to one group of 5 layers with cross-attention at 3 (the 11B's offset)
MLLAMA_TRAIN_LAYERS = 5
MLLAMA_TRAIN_SEQ = 512
MLLAMA_TRAIN_IMAGE_FROM = 16
MLLAMA_TRAIN_STEPS = 4
MLLAMA_TRAIN_LR = 1e-4
#: bf16 against fp32 on the same weights (PERF.md §6, Mllama): the loss,
#: abs (sound 0.00088); the largest per-leaf gradient relative L2 error
#: over the leaves but the gates (0.0389); over the gates, each gate's
#: |bf16 - fp32| gap over the largest |fp32 gate gradient| (0.0538). A
#: gate's gradient is a sum over its whole branch: the smallest, 2000x
#: below the largest, reads the largest relative gap (0.113), so its own
#: relative gap says little. The full-row mask left out reads 0.186 on
#: the leaves, 0.146 on the gates
MLLAMA_LOSS_BAND = 0.002
MLLAMA_GRAD_BAND = 0.08
MLLAMA_GATE_GRAD_BAND = 0.08


def mllama_gates(model, seed: int) -> None:
    """Every gate of ``model`` set to a seeded value of 0.3-0.9, either
    sign: at init the cross gates and the tile and position gates are 0,
    and the image moves no logit."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(("gate", "gate_attn", "gate_ffn")):
                u = torch.rand(p.shape, generator=g) * 0.6 + 0.3
                sign = torch.where(torch.rand(p.shape, generator=g) < 0.5, -1.0, 1.0)
                p.copy_((u * sign).to(p.device, p.dtype))


def mllama_request(cfg, ar_id: int, valid: int, seq: int, image_from: int, seed: int) -> dict:
    """One request's inputs on the card: seeded pixels (1, 1, T, 3, H, W),
    ``seq`` ids, the aspect ratio, its tile mask and the cross-attention
    mask (its ``valid`` tiles attended from ``image_from`` on)."""
    v = cfg.vision
    g = torch.Generator(device="cuda").manual_seed(seed)
    tiles = v.max_num_tiles
    ar_mask = torch.zeros((1, 1, tiles), dtype=torch.long, device="cuda")
    ar_mask[..., :valid] = 1
    xmask = torch.zeros((1, seq, 1, tiles), dtype=torch.long, device="cuda")
    xmask[:, image_from:, 0, :valid] = 1
    return dict(
        pix=torch.randn((1, 1, tiles, 3, v.image_size, v.image_size), generator=g, device="cuda"),
        ids=torch.randint(0, cfg.text.vocab_size, (1, seq), generator=g, device="cuda"),
        ar_ids=torch.tensor([[ar_id]], device="cuda"), ar_mask=ar_mask, xmask=xmask)


def mllama_forward(model, req: dict, ids=None, xmask=None) -> torch.Tensor:
    return model(req["ids"] if ids is None else ids, req["pix"], req["ar_ids"], req["ar_mask"],
                 req["xmask"] if xmask is None else xmask)[0].float()


def mllama_generate(dec, req: dict) -> dict:
    """``dec.generate`` on one request, its decoder forwards spied: each
    block's last-row logits, the prefill's and each step's time between CUDA
    events (the card's work and the host's gaps between launches), the
    vision encode + cross K/V time, and ``project_kv``'s calls."""
    from neuronx_distributed_llama3_2_tpu_torch.models import mllama as M

    rows, times, kv_calls = [], [], []
    forward, precompute = dec.forward, dec.precompute_cross_kv
    project_kv = M.TextCrossAttention.project_kv

    def timed_call(fn, *a, **k):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*a, **k)
        end.record()
        return out, (start, end)

    def spy_forward(*a, **k):
        (logits, cache), ev = timed_call(forward, *a, **k)
        rows.append(logits[0, -1].float())
        times.append(ev)
        return logits, cache

    encode = []

    def spy_precompute(*a, **k):
        out, ev = timed_call(precompute, *a, **k)
        encode.append(ev)
        return out

    def spy_kv(self, vt):
        kv_calls.append(tuple(vt.shape))
        return project_kv(self, vt)

    dec.forward, dec.precompute_cross_kv = spy_forward, spy_precompute
    try:
        with patch.object(M.TextCrossAttention, "project_kv", spy_kv):
            out = dec.generate([int(x) for x in req["ids"][0]], req["pix"], req["ar_ids"],
                               req["ar_mask"], req["xmask"], max_new_tokens=MLLAMA_NEW)
    finally:
        del dec.forward, dec.precompute_cross_kv
    torch.cuda.synchronize()
    ms = [a.elapsed_time(b) for a, b in times]
    return dict(out=out, rows=torch.stack(rows), prefill_ms=ms[0], step_ms=ms[1:],
                encode_ms=encode[0][0].elapsed_time(encode[0][1]), kv_calls=len(kv_calls))


def mllama_decode_profile(dec, req: dict) -> dict:
    """MLLAMA_PROFILE_STEPS decode steps over one request's cache, timed by
    CUDA events on the request's binding (as ``generate`` runs them) and
    with the model bound anew every step, then the bound steps traced
    (torch.profiler, CUPTI): each a step's ms, the card's busy ms a step
    (0 if the trace holds no device time) and the kernels a step
    launches."""
    from neuronx_distributed_llama3_2_tpu_torch.models.mllama import (
        prepare_cross_attention_mask,
    )

    _, ks, vs = dec.precompute_cross_kv(req["pix"], req["ar_ids"], req["ar_mask"])
    cache = dec.init_cache(ks, vs)
    live = dec._live_params(dec.params)
    bias, full_row = prepare_cross_attention_mask(dec.step_mask(req["xmask"]),
                                                  dec.config.vision.num_patches)

    def steps(params) -> float:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(MLLAMA_PROFILE_STEPS):
            dec.forward(params, cache, req["ids"][:, i:i + 1],
                        torch.tensor([i], dtype=torch.int32, device="cuda"), bias, full_row)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / MLLAMA_PROFILE_STEPS

    steps(live)  # warm
    bound_ms, rebound_ms = steps(live), steps(dec.params)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        traced_ms = steps(live)
    events = prof.key_averages()
    return dict(bound_ms=bound_ms, rebound_ms=rebound_ms, traced_ms=traced_ms,
                busy_ms=sum(e.self_device_time_total for e in events) / 1e3
                / MLLAMA_PROFILE_STEPS,
                kernels=sum(e.count for e in events if e.self_device_time_total > 0)
                / MLLAMA_PROFILE_STEPS)


def mllama_stream_gaps(model, req: dict, run: dict) -> tuple:
    """(the decoder's worst logit gap to the full forward over the prompt
    and the generated tokens, teacher-forced, each generated row given the
    last prompt row's cross mask as ``generate`` gives it; the worst gap
    between a served token's logit and that forward's max)."""
    out = run["out"]
    ids = torch.cat([req["ids"], torch.tensor([out[:-1]], device="cuda")], dim=1)
    xm = req["xmask"]
    xmask = torch.cat([xm, xm[:, -1:].expand(1, len(out) - 1, *xm.shape[2:])], dim=1)
    ref = mllama_forward(model, req, ids, xmask)[MLLAMA_PROMPT - 1:]
    logit_gap = (run["rows"] - ref).abs().max().item()
    tie = max((ref[j].max() - ref[j, t]).item() for j, t in enumerate(out))
    return logit_gap, tie


def run_mllama_serve_phase(card: str) -> None:
    """Llama-3.2 11B-Vision at full width and depth (the vision tower's 32 +
    8 layers, 40 text layers with cross-attention every 5th from 3), bf16,
    seeded random weights with every gate seeded non-zero, behind
    ``MllamaDecoder``: two requests (MLLAMA_REQUESTS, a 64-token prompt
    attending its image from MLLAMA_IMAGE_FROM, 16 greedy tokens, EOS off).
    Each: the decoder's prefill and step logits within MLLAMA_LOGIT_BAND of
    the full forward's, teacher-forced over the stream (each generated row
    given the last prompt row's mask), every token the forward's argmax or
    within LOGIT_MARGIN of it, ``project_kv`` run 8 times; a second image
    moves the forward's logits past the band; a serve whose step mask is
    the first prompt row's must fail the check. The vision tower in bf16
    against its fp32 copy on the 1 x 2 image within MLLAMA_VISION_BAND, and
    the tile-validity bias left out of the bf16 tower above it."""
    from neuronx_distributed_llama3_2_tpu_torch.inference import MllamaDecoder
    from neuronx_distributed_llama3_2_tpu_torch.models import mllama as M
    from neuronx_distributed_llama3_2_tpu_torch.models.mllama import (
        MLLAMA_CONFIGS,
        MllamaForConditionalGeneration,
        MllamaVisionModel,
    )

    cfg = MLLAMA_CONFIGS["llama3.2-11b-vision"]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = MllamaForConditionalGeneration(cfg, device="cuda").init_weights(SEED)
    mllama_gates(model, SEED + 1)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    n_params = sum(p.numel() for p in model.parameters())
    vis = sum(p.numel() for n, p in model.named_parameters() if n.startswith("vision_model."))
    log(f"mllama serve: llama3.2-11b-vision ({cfg.text.num_hidden_layers} text layers, cross "
        f"at {cfg.text.cross_attention_layers}, vision {cfg.vision.num_hidden_layers} + "
        f"{cfg.vision.num_global_layers} layers, {cfg.vision.max_num_tiles} tiles of "
        f"{cfg.vision.image_size}^2): {n_params} parameters ({vis} vision), {weight_bytes} B "
        f"bf16, seeded random weights and gates, drawn in {init_s:.6f} s | {card}")
    dec = MllamaDecoder(cfg, model, max_seq_len=MLLAMA_MAX_SEQ)
    reqs = [mllama_request(cfg, ar, valid, MLLAMA_PROMPT, MLLAMA_IMAGE_FROM, SEED + 10 + i)
            for i, (ar, valid) in enumerate(MLLAMA_REQUESTS)]
    for i, req in enumerate(reqs):
        run = mllama_generate(dec, req)
        gap, tie = mllama_stream_gaps(model, req, run)
        other = dict(req, pix=torch.randn_like(req["pix"]))
        moved = (mllama_forward(model, other) - mllama_forward(model, req)).abs().max().item()
        log(f"mllama serve request {i} (aspect ratio id {MLLAMA_REQUESTS[i][0]}, "
            f"{MLLAMA_REQUESTS[i][1]} valid tiles): stream {run['out']}; decoder logits vs the "
            f"full forward, teacher-forced: worst gap {gap:.6g} (band {MLLAMA_LOGIT_BAND}), "
            f"worst tie {tie:.6g} (margin {LOGIT_MARGIN}); project_kv calls {run['kv_calls']}; "
            f"a second image moves the logits by {moved:.6g}; vision encode + cross K/V "
            f"{run['encode_ms']:.6f} ms, prefill ({MLLAMA_PROMPT} tokens) "
            f"{run['prefill_ms']:.6f} ms, TPOT p50 {float(np.median(run['step_ms'])):.6f} ms "
            f"(wall time between CUDA events, the host's gaps included) | {card}")
        check(len(run["out"]) == MLLAMA_NEW, f"mllama serve request {i}: {len(run['out'])} tokens")
        check(gap <= MLLAMA_LOGIT_BAND, f"mllama serve request {i}: logit gap {gap}")
        check(tie <= LOGIT_MARGIN, f"mllama serve request {i}: a token {tie} below the argmax")
        check(run["kv_calls"] == MLLAMA_CROSS_LAYERS,
              f"mllama serve request {i}: project_kv ran {run['kv_calls']} times")
        check(moved > MLLAMA_LOGIT_BAND, f"mllama serve request {i}: a second image moves the "
              f"logits by {moved} only")
    prof = mllama_decode_profile(dec, reqs[0])
    busy = (f"the card busy {prof['busy_ms']:.6f} ms a step "
            f"({prof['busy_ms'] / prof['traced_ms']:.6g} of the traced step's wall)"
            if prof["busy_ms"] > 0 else "the card's busy time not measured (no device time "
            "in the trace)")
    log(f"mllama serve decode steps ({MLLAMA_PROFILE_STEPS}, request 0's cache; wall time "
        f"between CUDA events): {prof['bound_ms']:.6f} ms a step on the request's binding, "
        f"{prof['rebound_ms']:.6f} ms binding the model every step; traced (torch.profiler): "
        f"{prof['traced_ms']:.6f} ms a step, {busy}, {prof['kernels']:.6g} kernels a step "
        f"| {card}")
    # planted fault: the step mask from the first prompt row (which attends
    # nothing) instead of the last
    with patch.object(MllamaDecoder, "step_mask", staticmethod(lambda m: m[:, :1])):
        run = mllama_generate(dec, reqs[0])
    bad_gap, bad_tie = mllama_stream_gaps(model, reqs[0], run)
    log(f"mllama serve planted fault (the step's cross mask from the first prompt row): "
        f"logit gap {bad_gap:.6g}, worst tie {bad_tie:.6g} | {card}")
    check(bad_gap > MLLAMA_LOGIT_BAND or bad_tie > LOGIT_MARGIN,
          "the mllama serve check passes a step mask taken from the first prompt row")
    # the vision tower in bf16 against its fp32 copy, and with the
    # tile-validity bias left out of the bf16 tower; the attention output
    # kernels scaled first (MLLAMA_VISION_ATTN_SCALE), so that attention,
    # which the bias steers, carries the stream
    req = reqs[1]
    args = (req["pix"], req["ar_ids"], req["ar_mask"])
    with torch.no_grad():
        for stack in (model.vision_model.transformer, model.vision_model.global_transformer):
            stack.self_attn.o.kernel.mul_(MLLAMA_VISION_ATTN_SCALE)
    f32 = MllamaVisionModel(dataclasses.replace(cfg.vision, dtype=torch.float32), device="cuda")
    f32.load_state_dict({k: v.float() for k, v in model.vision_model.state_dict().items()})
    with torch.no_grad():
        ref = f32(*args)
        del f32
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = model.vision_model(*args).float()
        torch.cuda.synchronize()
        tower_ms = 1e3 * (time.perf_counter() - t0)
        rel = vision_gaps(got, ref, MLLAMA_REQUESTS[1][1])
        with patch.object(M, "tile_validity_bias", lambda mask, n, t: torch.zeros(
                (), device=mask.device)):
            bad = vision_gaps(model.vision_model(*args).float(), ref, MLLAMA_REQUESTS[1][1])
    log(f"mllama serve vision tower (1 x 2 image, 2 of 4 tiles valid): bf16 vs fp32 relative "
        f"L2 {rel[0]:.6g} over the valid tiles, {rel[1]:.6g} over the invalid ones (band "
        f"{MLLAMA_VISION_BAND}); planted fault (the tile-validity bias left out of the bf16 "
        f"tower): {bad[0]:.6g} / {bad[1]:.6g}; one bf16 tower {tower_ms:.6f} ms (host clock); "
        f"peak memory {torch.cuda.max_memory_allocated()} B | {card}")
    check(max(rel) <= MLLAMA_VISION_BAND, f"mllama vision tower bf16 vs fp32: {rel}")
    check(max(bad) > MLLAMA_VISION_BAND,
          f"the mllama vision check passes the tile bias left out ({bad})")
    del model, dec, ref, got
    gc.collect()
    torch.cuda.empty_cache()


def vision_gaps(got: torch.Tensor, ref: torch.Tensor, valid: int) -> tuple:
    """Relative L2 errors of a (B, M, T, P, D) vision output over the valid
    tiles and over the invalid ones (whose tokens the tile-validity bias
    keeps from attending each other)."""
    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    return (rel(got[:, :, :valid], ref[:, :, :valid]), rel(got[:, :, valid:], ref[:, :, valid:]))


#: Mllama's gates: one fp32 scalar each, whose gradient is a sum over every
#: element of its branch's output
MLLAMA_GATES = ("gate", "gate_attn", "gate_ffn")


def gate_split_gaps(grads, ref) -> tuple:
    """(largest relative gradient gap over the non-gate leaves, its leaf,
    largest gap over the gates scaled by the largest fp32 gate gradient,
    its gate, {gate: (|fp32 gradient|, its relative gap)})."""
    gates = [k for k in grads if k.endswith(MLLAMA_GATES)]
    each = {k: ((ref[k].float() - grads[k].float()).abs().max().item(),
                ref[k].float().abs().max().item()) for k in gates}
    scale = max(m for _, m in each.values())
    gat = max(each, key=lambda k: each[k][0])
    return (*grad_gap({k: v for k, v in grads.items() if k not in each}, ref),
            each[gat][0] / scale, gat, {k: (m, d / max(m, 1e-30)) for k, (d, m) in each.items()})


def gate_readings(gates: dict) -> str:
    """The largest and smallest |fp32 gate gradient| and the gate of the
    largest relative gap with its magnitude, for the log."""
    worst = max(gates, key=lambda k: gates[k][1])
    mags = [m for m, _ in gates.values()]
    return (f"|fp32 gate gradient| {min(mags):.6g}-{max(mags):.6g}; the largest relative gap "
            f"{gates[worst][1]:.6g} at {worst}, whose |gradient| is {gates[worst][0]:.6g}")


def mllama_loss_and_grads(model, batch: dict):
    params = dict(model.named_parameters())
    loss = model.loss(batch["input_ids"], batch["labels"], batch["pixel_values"],
                      batch["aspect_ratio_ids"], batch["aspect_ratio_mask"],
                      batch["cross_attention_mask"])
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.detach().item(), dict(zip(params, grads))


def run_mllama_train_phase(card: str) -> None:
    """The 11B's widths with the vision tower at full depth and the text cut
    to MLLAMA_TRAIN_LAYERS (cross-attention at 3), remat "full" on both
    towers, gates seeded: a batch of 2 x 512 tokens, one image each
    (MLLAMA_REQUESTS), the text attending it from MLLAMA_TRAIN_IMAGE_FROM.
    The bf16 loss and gradients against an fp32 copy's within
    MLLAMA_LOSS_BAND / MLLAMA_GRAD_BAND, every gate's gradient non-zero, the
    full-row mask left out above a band; then MLLAMA_TRAIN_STEPS AdamW steps
    through the trainer (bf16 state, the image inputs as batch entries),
    losses falling."""
    from neuronx_distributed_llama3_2_tpu_torch.models import mllama as M
    from neuronx_distributed_llama3_2_tpu_torch.trainer import (
        OptimizerConfig,
        TrainingConfig,
        TrainState,
        init_optimizer_state,
        make_train_step,
        state_specs,
    )

    base = M.MLLAMA_CONFIGS["llama3.2-11b-vision"]
    cfg = dataclasses.replace(
        base, vision=dataclasses.replace(base.vision, remat="full"),
        text=dataclasses.replace(base.text, num_hidden_layers=MLLAMA_TRAIN_LAYERS,
                                 cross_attention_layers=(3,), remat="full"))
    torch.cuda.reset_peak_memory_stats()
    model = M.MllamaForConditionalGeneration(cfg, device="cuda").init_weights(SEED)
    mllama_gates(model, SEED + 2)
    reqs = [mllama_request(cfg, ar, valid, MLLAMA_TRAIN_SEQ, MLLAMA_TRAIN_IMAGE_FROM, SEED + 20 + i)
            for i, (ar, valid) in enumerate(MLLAMA_REQUESTS)]
    batch = {"input_ids": torch.cat([r["ids"] for r in reqs]),
             "pixel_values": torch.cat([r["pix"] for r in reqs]),
             "aspect_ratio_ids": torch.cat([r["ar_ids"] for r in reqs]),
             "aspect_ratio_mask": torch.cat([r["ar_mask"] for r in reqs]),
             "cross_attention_mask": torch.cat([r["xmask"] for r in reqs])}
    batch["labels"] = batch["input_ids"]
    n_params = sum(p.numel() for p in model.parameters())
    log(f"mllama train: 11B widths, vision {cfg.vision.num_hidden_layers} + "
        f"{cfg.vision.num_global_layers} layers, text cut to {cfg.text.num_hidden_layers} of 40 "
        f"(cross-attention at 3), remat full on both towers: {n_params} parameters, bf16, "
        f"seeded weights and gates; batch 2 x {MLLAMA_TRAIN_SEQ}, one image each | {card}")
    f32cfg = dataclasses.replace(cfg, vision=dataclasses.replace(cfg.vision, dtype=torch.float32),
                                 text=dataclasses.replace(cfg.text, dtype=torch.float32))
    f32 = M.MllamaForConditionalGeneration(f32cfg, device="cuda")
    f32.load_state_dict({k: v.float() for k, v in model.state_dict().items()})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref_loss, ref_grads = mllama_loss_and_grads(f32, batch)
    torch.cuda.synchronize()
    f32_ms = 1e3 * (time.perf_counter() - t0)
    del f32
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    loss, grads = mllama_loss_and_grads(model, batch)
    torch.cuda.synchronize()
    bf16_ms = 1e3 * (time.perf_counter() - t0)
    gap, at, ggap, gat, gate_info = gate_split_gaps(grads, ref_grads)
    gates = {k: g.float().abs().min().item() for k, g in grads.items()
             if k.endswith(MLLAMA_GATES)}
    del grads
    orig = M.prepare_cross_attention_mask
    with patch.object(M, "prepare_cross_attention_mask", lambda m, n: (orig(m, n)[0], None)):
        bad_loss, bad_grads = mllama_loss_and_grads(model, batch)
    bad_gap, bad_at, bad_ggap, bad_gat, _ = gate_split_gaps(bad_grads, ref_grads)
    del bad_grads, ref_grads
    gc.collect()
    torch.cuda.empty_cache()
    loss_gap = abs(loss - ref_loss)
    log(f"mllama train: bf16 loss {loss:.6f} vs fp32 {ref_loss:.6f} (gap {loss_gap:.6g}, band "
        f"{MLLAMA_LOSS_BAND}); largest gradient relative L2 error {gap:.6g} at {at} (band "
        f"{MLLAMA_GRAD_BAND}), over the gates {ggap:.6g} of the largest gate gradient at "
        f"{gat} (band {MLLAMA_GATE_GRAD_BAND}); {gate_readings(gate_info)}; smallest |bf16 gate "
        f"gradient| {min(gates.values()):.6g} over {len(gates)} gates; planted fault (the "
        f"full-row mask left out): loss gap {abs(bad_loss - ref_loss):.6g}, gradient {bad_gap:.6g} at {bad_at}, gates "
        f"{bad_ggap:.6g} at {bad_gat}; one forward and backward {bf16_ms:.6f} ms bf16, "
        f"{f32_ms:.6f} ms fp32 (host clock) | {card}")
    check(np.isfinite(loss) and loss_gap <= MLLAMA_LOSS_BAND, f"mllama train loss gap {loss_gap}")
    check(gap <= MLLAMA_GRAD_BAND, f"mllama train gradient gap {gap} at {at}")
    check(ggap <= MLLAMA_GATE_GRAD_BAND, f"mllama train gate gradient gap {ggap} at {gat}")
    check(min(gates.values()) > 0, f"mllama train: a gate without gradient: {gates}")
    check(abs(bad_loss - ref_loss) > MLLAMA_LOSS_BAND or bad_gap > MLLAMA_GRAD_BAND
          or bad_ggap > MLLAMA_GATE_GRAD_BAND,
          "the mllama train bands pass the full-row mask left out")
    tc = TrainingConfig(optimizer=OptimizerConfig(
        learning_rate=MLLAMA_TRAIN_LR, warmup_steps=1, state_dtype="bfloat16"))
    tc.initialize("cuda")
    params = dict(model.named_parameters())
    state = TrainState(params, init_optimizer_state(params, tc.optimizer,
                                                    state_specs(model, tc).opt))
    step = make_train_step(model, tc)
    losses, step_ms = [], []
    for _ in range(MLLAMA_TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        step_ms.append(1e3 * (time.perf_counter() - t0))
    log(f"mllama train: {MLLAMA_TRAIN_STEPS} AdamW steps (lr {MLLAMA_TRAIN_LR}, bf16 state): "
        f"losses {losses}, step ms {[round(x, 6) for x in step_ms]}; peak memory "
        f"{torch.cuda.max_memory_allocated()} B | {card}")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0], f"mllama train losses {losses}")
    del model, state, step, params, batch
    gc.collect()
    torch.cuda.empty_cache()


def timed(name: str, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, its wall seconds logged under ``name``."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    log(f"phase {name}: {time.perf_counter() - t0:.3f} s")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 2
    from neuronx_distributed_llama3_2_tpu_torch.kernels import _build

    t_start = time.perf_counter()
    torch.manual_seed(SEED)
    card = card_label()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    built = _build.build()
    log(f"build: {len(built)} CUDA sources in {time.perf_counter() - t0:.3f} s "
        f"({', '.join(f'{r.name} {r.seconds:.3f} s' for r in built.values())})")
    for r in built.values():
        for line in r.ptxas.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {r.name}: {line.strip()}")
    # the instances (D = 64, 96, 128) of each kernel written for one block
    # to hold a whole tile in registers must not spill, and ptxas must not
    # serialize a wgmma product (warning C7520); the spill readings each
    # source must show at least (two a kernel: stores, loads):
    # paged_decode_tile's fifteen main kernels (D x bf16, int8 and fp8 in
    # modes 3 and 6), paged_decode_t1's eighteen (D x payload layout x group
    # of 4 or 8), flash_fwd's six (D x the segment instance) and flash_bwd's
    # twelve (D x K2, K3 x the segment instance)
    for name, readings in (("paged_decode_tile", 30), ("paged_decode_t1", 36),
                           ("flash_fwd", 12), ("flash_bwd", 24)):
        ptxas = built[name].ptxas
        if ptxas:  # empty when the library was built by an earlier process
            spills = [int(x) for x in re.findall(r"(\d+) bytes spill (?:stores|loads)", ptxas)]
            check(len(spills) >= readings and not any(spills),
                  f"{name} spills (ptxas: {spills} bytes of spill stores/loads)")
            check("C7520" not in ptxas, f"ptxas serialized a wgmma product in {name}")

    cfg, model = timed("load", load_model)
    prompts, outs, rids, tile, t1, served, bf16_pool = timed(
        "serve", run_serve_phase, cfg, model, card)
    timed("serve e2e", run_e2e_phase, cfg, model, prompts, outs, rids)
    # each serve's prewarmed twin: every prefill and decode-time step a CUDA
    # graph; Serve's, Q1's and F's async twins run the async loop on them
    graph = timed("serve graphs", run_graph_phase, cfg, model, "serve", prompts,
                  [outs[r] for r in rids], card,
                  lambda o, r: e2e_gaps(model, prompts, o, r)[0], E2E_LOGIT_MARGIN)
    serve_twin = graph
    serve_async = timed("serve async", run_graph_phase, cfg, model, "serve async", prompts,
                        [outs[r] for r in rids], card,
                        lambda o, r: e2e_gaps(model, prompts, o, r)[0], E2E_LOGIT_MARGIN,
                        async_loop=True)
    timed("serve graphs profile", run_graph_profile_phase, cfg, model,
                            "serve", prompts, None, dict(t1=t1, tile=tile, split=0), card,
                            graph["same"], eager_outs=[outs[r] for r in rids])
    timed("serve graphs fault", run_graph_fault_phase, cfg, model, prompts, card)
    timed("faults", run_fault_phase, cfg, model, prompts, [outs[r] for r in rids],
          serve_twin, card)
    # the degradation ladder and the front door, on Serve's async twin
    timed("ladder", run_ladder_phase, cfg, model, prompts, serve_async["outs"], card)
    timed("front door", run_front_door_phase, cfg, model, prompts, serve_async["outs"], card)
    # tiered KV storage: Serve's prompts as a churn that spills the shared
    # prefix to host RAM and restores it
    timed("spill", run_spill_phase, cfg, model, card)
    quant = {}  # label -> (kv dtype, mxu, K4 launches, t1 launches, served geometries)
    for label, kv_dtype, mxu in QUANT_SERVES:
        qk = dict(kv_cache_dtype=kv_dtype, quant_mxu=mxu, prefill_chunk_tokens=QUANT_CHUNK)
        q_prompts, q_outs, q_rids, q_launches, q_t1, q_served = timed(
            f"serve {label}", run_quant_serve_phase, cfg, model, label, kv_dtype, mxu,
            bf16_pool, card)
        timed(f"serve {label} e2e", run_quant_e2e_phase, cfg, model, label, kv_dtype, mxu,
              q_prompts, q_outs, q_rids)
        # the twin's serve is the profiled one (the script's profiling depth,
        # PERF.md section 7)
        timed(f"serve {label} graphs", run_graph_phase, cfg, model, f"serve {label}", q_prompts,
              [q_outs[r] for r in q_rids], card,
              lambda o, r: quant_e2e_gaps(cfg, model, kv_dtype, q_prompts, o, r)[0],
              QUANT_LOGIT_MARGIN[kv_dtype],
              profile=dict(t1=q_t1, tile=q_launches - q_t1, split=0), **qk)
        if label == "Q1":
            timed(f"serve {label} async", run_graph_phase, cfg, model, f"serve {label} async",
                  q_prompts, [q_outs[r] for r in q_rids], card,
                  lambda o, r: quant_e2e_gaps(cfg, model, kv_dtype, q_prompts, o, r)[0],
                  QUANT_LOGIT_MARGIN[kv_dtype], async_loop=True, **qk)
        quant[label] = (kv_dtype, mxu, q_launches, q_t1, q_served)
    fcfg = spec_config(cfg)
    f_prompts, f_outs, f_rids, f_live_launches, f_tile, f_t1, f_served = timed(
        "serve F", run_spec_serve_phase, cfg, model, card)
    timed("serve F e2e", run_spec_e2e_phase, cfg, model, f_prompts, f_outs, f_rids)
    graph = f_twin = timed("serve F graphs", run_graph_phase, fcfg, model, "serve F", f_prompts,
                  [f_outs[r] for r in f_rids], card,
                  lambda o, r: e2e_gaps(model, f_prompts, o, r)[0], F_LOGIT_MARGIN,
                  **SPEC_KNOBS)
    timed("serve F async", run_graph_phase, fcfg, model, "serve F async", f_prompts,
          [f_outs[r] for r in f_rids], card,
          lambda o, r: e2e_gaps(model, f_prompts, o, r)[0], F_LOGIT_MARGIN,
          async_loop=True, **SPEC_KNOBS)
    timed("serve F graphs profile", run_graph_profile_phase, fcfg, model, "serve F",
          f_prompts, None, dict(t1=f_t1, tile=f_tile, split=0), card, graph["same"],
          eager_outs=[f_outs[r] for r in f_rids], **SPEC_KNOBS)
    qf_prompts, qf_outs = timed("serve QF", run_quant_spec_serve_phase, cfg, model, card)
    timed("serve QF graphs", run_graph_phase, fcfg, model, "serve QF", qf_prompts, qf_outs,
          card, lambda o, r: quant_e2e_gaps(cfg, model, "int8", qf_prompts, o, r)[0],
          QUANT_LOGIT_MARGIN["int8"], kv_cache_dtype="int8", **SPEC_KNOBS)
    tcfg = tree_config(cfg)
    t_prompts, t_outs, t_rids, t_tree_launches, t_tile, t_t1, t_served = timed(
        "serve T", run_tree_serve_phase, cfg, model, card)
    timed("serve T e2e", run_tree_e2e_phase, cfg, model, t_prompts, t_outs, t_rids)
    timed("serve T branches", run_tree_branch_phase, cfg, model, t_prompts, card)
    graph = t_twin = timed("serve T graphs", run_graph_phase, tcfg, model, "serve T", t_prompts,
                  [t_outs[r] for r in t_rids], card,
                  lambda o, r: e2e_gaps(model, t_prompts, o, r)[0], T_LOGIT_MARGIN,
                  **TREE_KNOBS)
    timed("serve T graphs profile", run_graph_profile_phase, tcfg, model, "serve T",
          t_prompts, None, dict(t1=t_t1, tile=t_tile, split=0), card, graph["same"],
          eager_outs=[t_outs[r] for r in t_rids], **TREE_KNOBS)
    # on-device sampling: the sampler at the served shapes; Serve, F and T
    # sampled, each eagerly and by its prewarmed twin (Serve by its async
    # twin too); the greedy sentinel; preempt-resume; sampled speculation
    timed("sampler", run_sampler_phase, cfg, model, card)
    sampled = sampling_config(**SAMPLED)
    lane = dict(on_device_sampling=True)
    stats = []
    for label, scfg, s_prompts, margin, knobs, twin in (
            ("serve", cfg, prompts, E2E_LOGIT_MARGIN, {}, serve_twin),
            ("serve F", fcfg, f_prompts, F_LOGIT_MARGIN, SPEC_KNOBS, f_twin),
            ("serve T", tcfg, t_prompts, T_LOGIT_MARGIN, TREE_KNOBS, t_twin)):
        s_outs, _, s_stats = timed(f"{label} sampled", run_sampled_serve_phase, scfg, model,
                                   label, s_prompts, card, sampled, margin, **knobs)
        gaps = functools.partial(sampled_e2e_gaps, model, s_prompts, sampling=sampled)
        s_twin = timed(f"{label} sampled graphs", run_graph_phase, scfg, model,
                       f"{label} sampled", s_prompts, s_outs, card,
                       lambda o, r, gaps=gaps: gaps(o, r)[0], margin / sampled.temperature,
                       sampling=sampled, **lane, **knobs)
        stats += [(f"{label} sampled eager", s_stats), (f"{label} sampled twin", s_twin),
                  (f"{label} greedy twin", twin)]
        if label == "serve":
            s_async = timed("serve sampled async", run_graph_phase, cfg, model,
                            "serve sampled async", prompts, s_outs, card,
                            lambda o, r, gaps=gaps: gaps(o, r)[0],
                            E2E_LOGIT_MARGIN / sampled.temperature, async_loop=True,
                            sampling=sampled, **lane)
            stats += [("serve sampled async twin", s_async), ("serve greedy async twin",
                                                              serve_async)]
            timed("serve greedy sentinel graphs", run_graph_phase, cfg, model,
                  "serve greedy sentinel", prompts, serve_twin["outs"], card,
                  lambda o, r: e2e_gaps(model, prompts, o, r)[0], E2E_LOGIT_MARGIN, **lane)
            timed("serve sampled replay", run_sampled_replay_phase, cfg, model, prompts,
                  s_outs, card, sampled)
        if label == "serve F":
            timed("serve F sampled speculation", run_sampled_spec_phase, fcfg, model,
                  f_prompts, s_outs, card, sampled)
    sampled_summary(stats, card)
    # the dense engine: generate (greedy, sampled), continuous batching under
    # churn, draft-model and Medusa speculation; host sampling on the JAX
    # key chain, prewarmed
    paged_outs = [outs[r] for r in rids]
    dense, dense_seqs = timed("dense", run_dense_phase, cfg, model, prompts, paged_outs, card)
    timed("dense churn", run_dense_churn_phase, dense, model, prompts, dense_seqs, card)
    timed("dense sampled", run_dense_sampled_phase, dense, model, prompts, card)
    del dense
    gc.collect()
    torch.cuda.empty_cache()
    timed("spec draft", run_spec_draft_phase, cfg, model, prompts, dense_seqs, card)
    timed("medusa", run_medusa_phase, cfg, model, prompts, dense_seqs, card)
    timed("graph serve sampled-host", run_host_sampled_graph_phase, cfg, model, prompts, card)
    del model
    torch.cuda.empty_cache()
    # the bf16 grid checked, not timed (the script's timing depth, PERF.md
    # section 7); the served geometries timed
    paged, paged_err = timed("K4 bf16", run_paged_kernel_phase, cfg, served, card,
                             time_grid=False)
    row_live = timed("K4 row_live", run_row_live_phase, cfg, f_served, card)
    tree = timed("K4 tree", run_tree_kernel_phase, cfg, t_served, card)
    for kv_dtype, mxu in (("bf16", False), ("int8", True)):
        timed(f"K4 tile probe {kv_dtype}", run_tile_probe, card, kv_dtype, mxu)
    timed("K4 t1 probe", run_t1_probe, card)
    # the six quantized combinations at the grid (checked, not timed) and at
    # every geometry the quantized serves launched (launch counts summed
    # over both serves)
    q_geoms: dict = {}
    for *_, q_served in quant.values():
        for k, e in q_served.items():
            entry = q_geoms.setdefault(k, dict(calls=0, positions=e["positions"]))
            entry["calls"] += e["calls"]
    quant_records, quant_errs = {}, []
    for kv_dtype in ("int8", "fp8_e4m3", "fp8_e5m2"):
        for mxu in (False, True):
            quant_records[kv_dtype, mxu], err = timed(
                f"K4 {mode_label(kv_dtype, mxu)}", run_paged_kernel_phase,
                cfg, q_geoms, card, kv_dtype=kv_dtype, mxu=mxu, time_grid=False)
            quant_errs.append(err)

    model, state, step, batch, train_launches = timed("train", run_train_phase, card)
    timed("train e2e", run_train_e2e_phase, model, card)
    timed("train profile", run_train_profile_phase, state, step, batch, card)
    del model, state, step, batch
    torch.cuda.empty_cache()
    # every remat policy; the pretrain script with a save, a resume and the
    # native loader; its checkpoint served
    timed("remat", run_remat_phase, card)
    trained = timed("pretrain", run_pretrain_phase, card)
    timed("trained serve", run_trained_serve_phase, cfg, trained, card)
    del trained
    flash = timed("flash kernels", run_flash_kernel_phase, card)
    flash_packed = timed("flash kernels packed", run_flash_kernel_phase, card, packed=True)
    # tensor parallelism: NCCL at world size 1 through the tp code path
    # (eager and captured), then two ranks on the card over gloo: Serve at
    # tp = 2, and the train step at tp = 2 and at dp = 2 with ZeRO-1
    timed("tp nccl", run_tp_nccl_phase, prompts, [outs[r] for r in rids], card)
    # on one pair of ranks over gloo: Serve at tp = 2, the train step at tp =
    # 2 and at dp = 2 with ZeRO-1; context parallelism, the cp = 2 step in
    # both ring layouts; pipeline parallelism, the pp = 2 step in each
    # schedule; expert parallelism, the Mixtral-width step at ep = 2
    two = timed("two-rank phases", run_two_rank_phases, prompts, [outs[r] for r in rids], card)
    tp_serve, tp_train = two["tp2 serve"], two["tp2 train"]
    cp_train, pp_train = two["cp2 train"], two["pp2 train"]
    # MoE: Mixtral's train step at full width, the Mixtral (bf16 and int8)
    # and DBRX serves
    moe_train = timed("moe train", run_moe_train_phase, card)
    moe_serve = timed("moe serve", run_moe_serve_phase, card)
    # LoRA over the 1B: the adapters' step through the trainer, their tag,
    # the merged weights served; GPT-NeoX / CodeGen: Pythia's step, the
    # Pythia and CodeGen serves at G 1; BERT-large's step and the pretrain
    # script on it
    lora = timed("lora train", run_lora_train_phase, card)
    timed("lora serve", run_lora_serve_phase, lora, [outs[r] for r in rids], card)
    lora_train = {k: lora.pop(k) for k in ("launches", "flash")}
    lora["lora"].detach()
    del lora
    gc.collect()
    torch.cuda.empty_cache()
    neox_train = timed("neox train", run_neox_train_phase, card)
    neox_serve = timed("neox serve", run_neox_serve_phase, card)
    # gpt-neox-20b (D 96): its step through K1-K3's D 96 instances, its
    # serves through K4's (all three sources, every pool kind held)
    neox20b_train = timed("neox20b train", run_neox_train_phase, card, "gpt-neox-20b",
                          NEOX20B_FLASH_CASES, "neox20b train")
    neox20b_serve = timed("neox20b serve", run_neox20b_serve_phase, card)
    timed("bert train", run_bert_train_phase, card)
    # Mllama: the 11B-Vision serve behind MllamaDecoder, and the 11B-widths
    # train step (its vision tower at full depth)
    timed("mllama serve", run_mllama_serve_phase, card)
    timed("mllama train", run_mllama_train_phase, card)

    fa_src = "neuronx_distributed_llama3_2_tpu_torch/kernels/csrc/"
    pfa = "neuronx_distributed_llama3_2_tpu/kernels/pallas_flash_attention.py:"
    k4 = "neuronx_distributed_llama3_2_tpu/kernels/paged_attention_pallas.py:419"
    # the worst abs error of the calls the tile kernel served, over every phase
    tile_err = max([r.pop("tile_err") for r in (row_live, tree)]
                   + [e.get("tile", 0.0) for e in (paged_err, *quant_errs)])
    # paged_decode_t1: its launches over the bf16 serves (the t == 1 decode
    # of Serve, F and T), timed at the bf16 serve's median decode call, with
    # csrc/paged_decode.cu at the same call (split_ms)
    kernels = [dict(
        name="paged_decode_t1", route="cuda", source=fa_src + "paged_decode_t1.cu",
        replaces=k4, launches=t1 + f_t1 + t_t1, **paged["t1"],
    )]
    # paged_decode_tile: its launches over the bf16 serves (Serve's suffix
    # prefills, F's verifies and mixed steps, T's tree verifies and mixed
    # steps), timed at the call they launched most, F's median mixed call
    kernels.append(dict(
        name="paged_decode_tile", route="cuda", source=fa_src + "paged_decode_tile.cu",
        replaces=k4, launches=tile + f_tile + t_tile, **dict(row_live, max_abs_err=tile_err),
    ))
    # one entry per quantized mode the serves launched, on each source: the
    # t == 1 decode on csrc/paged_decode_t1.cu, the suffix prefills (t > 1)
    # on csrc/paged_decode_tile.cu, with csrc/paged_decode.cu at the same
    # call (split_ms)
    for label, (kv_dtype, mxu, q_launches, q_t1, _) in quant.items():
        tag = f"{kv_dtype}{'_mxu' if mxu else ''}"
        records = quant_records[kv_dtype, mxu]
        kernels.append(dict(
            name=f"paged_decode_t1_{tag}", route="cuda", source=fa_src + "paged_decode_t1.cu",
            replaces=k4, launches=q_t1, **records["t1"],
        ))
        check((q_launches > q_t1) == ("tile" in records) and "split" not in records,
              f"{label}: {q_launches - q_t1} t > 1 launches, records {list(records)}")
        if "tile" in records:
            kernels.append(dict(
                name=f"paged_decode_{tag}", route="cuda",
                source=fa_src + "paged_decode_tile.cu", replaces=k4,
                launches=q_launches - q_t1, **records["tile"],
            ))
    # modes 4 and 5 of the bf16 serves, all on the tile kernel
    kernels.append(dict(
        name="paged_decode_row_live", route="cuda", source=fa_src + "paged_decode_tile.cu",
        replaces=k4, launches=f_live_launches, **row_live,
    ))
    kernels.append(dict(
        name="paged_decode_tree", route="cuda", source=fa_src + "paged_decode_tile.cu",
        replaces=k4, launches=t_tree_launches, **tree,
    ))
    flash_kernels = ((1, "flash_fwd", "flash_fwd.cu", 194),
                     (2, "flash_bwd_dq", "flash_bwd.cu", 394),
                     (3, "flash_bwd_dkv", "flash_bwd.cu", 433))
    for kn, name, src, line in flash_kernels:
        kernels.append(dict(
            name=name, route="cuda", source=fa_src + src, replaces=f"{pfa}{line}",
            launches=train_launches[kn - 1], **flash[kn],
        ))
        # the segment_ids mode, driven through flash_attention(segment_ids=)
        kernels.append(dict(
            name=f"{name}_segment_ids", route="cuda", source=fa_src + src,
            replaces=f"{pfa}{line}", **flash_packed[kn],
        ))
    # K4 and K1-K3 at a tp = 2 rank's heads (16 q / 4 kv): rank 0's launches
    # in the tp phases, its records at its served geometries / its shape
    for src, file in (("t1", "paged_decode_t1.cu"), ("tile", "paged_decode_tile.cu")):
        kernels.append(dict(
            name=f"paged_decode_{src}_tp2_rank", route="cuda", source=fa_src + file,
            replaces=k4, **tp_serve["records"][src],
        ))
    for kn, name, src, line in flash_kernels:
        kernels.append(dict(
            name=f"{name}_tp2_rank", route="cuda", source=fa_src + src,
            replaces=f"{pfa}{line}", launches=tp_train["launches"][kn - 1],
            **tp_train["flash"][kn],
        ))
    # K1-K3 in the cp = 2 ring: both ranks' launches in one step of each
    # layout, rank 0's records at the layout's chunk shape (CP_FLASH_CASES)
    for layout in CP_LAYOUTS:
        for kn, name, src, line in flash_kernels:
            kernels.append(dict(
                name=f"{name}_cp2_{layout}", route="cuda", source=fa_src + src,
                replaces=f"{pfa}{line}", launches=cp_train["launches"][layout][kn - 1],
                **cp_train["flash"][layout][kn],
            ))
    # K1-K3 in the pp = 2 stages: both ranks' launches in one step of each
    # schedule, rank 0's records at a stage's microbatch (PP_FLASH_CASES)
    for kn, name, src, line in flash_kernels:
        kernels.append(dict(
            name=f"{name}_pp2", route="cuda", source=fa_src + src,
            replaces=f"{pfa}{line}", launches=pp_train["launches"][kn - 1],
            **pp_train["flash"][kn],
        ))
    # K1-K3 at Mixtral's train shape (D 128, G 4): the moe train phase's
    # launches and records; K4 at Mixtral's (G 4) and DBRX's (G 6) serves
    for kn, name, src, line in flash_kernels:
        kernels.append(dict(
            name=f"{name}_moe", route="cuda", source=fa_src + src,
            replaces=f"{pfa}{line}", launches=moe_train["launches"][kn - 1],
            **moe_train["flash"][kn],
        ))
    for src, file in (("t1", "paged_decode_t1.cu"), ("tile", "paged_decode_tile.cu")):
        for tag, key in (("moe", "k4"), ("dbrx_moe", "k4_dbrx")):
            kernels.append(dict(
                name=f"paged_decode_{src}_{tag}", route="cuda", source=fa_src + file,
                replaces=k4, **moe_serve[key][src],
            ))
    # K1-K3 at the LoRA step's shape (the 1B's heads, batch 2), at Pythia's
    # (MHA, G 1, D 128) and at gpt-neox-20b's (MHA, G 1, D 96): the phases'
    # launches and records; K4 at the Pythia serve's G 1 geometries (the t1
    # source pads G 1 to 4 rows), launched by the Pythia serves and the
    # CodeGen serve, and at the gpt-neox-20b serves' (D 96; its chunked twin
    # launches csrc/paged_decode.cu)
    for tag, rec in (("lora", lora_train), ("neox", neox_train), ("neox20b", neox20b_train)):
        for kn, name, src, line in flash_kernels:
            kernels.append(dict(
                name=f"{name}_{tag}", route="cuda", source=fa_src + src,
                replaces=f"{pfa}{line}", launches=rec["launches"][kn - 1], **rec["flash"][kn],
            ))
    for src, file in (("t1", "paged_decode_t1.cu"), ("tile", "paged_decode_tile.cu")):
        kernels.append(dict(
            name=f"paged_decode_{src}_neox", route="cuda", source=fa_src + file, replaces=k4,
            **neox_serve[src],
        ))
    for src, file in (("t1", "paged_decode_t1.cu"), ("tile", "paged_decode_tile.cu"),
                      ("split", "paged_decode.cu")):
        kernels.append(dict(
            name=f"paged_decode_{src}_neox20b", route="cuda", source=fa_src + file,
            replaces=k4, **neox20b_serve[src],
        ))
    check(all(k["launches"] > 0 for k in kernels),
          f"a kernel of the main path was never launched: "
          f"{[(k['name'], k['launches']) for k in kernels]}")
    log(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.3f} s of "
        f"wall time | {card}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
