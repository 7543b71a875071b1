#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one card and check it.

Run from the root of a checkout, on a machine with one CUDA card and the
CUDA toolkit:

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) when a check fails:

1. Build the kernels from ``src/repro_torch/csrc`` (one ``nvcc`` each, all
   started together).  Check each kernel against its plain PyTorch version
   on the card at the paper's sizes and time both: K1 (HOTSPOT 2048², 8
   steps in one launch; and the runtime's band, 130 × 2048 with steps=1)
   bitwise, and K2 (2048², 8 launches) at rtol 1e-5, atol 1e-4;
   K3 on the full SPMM problem (29957 × 29957 · 29957 × 100, seed 1234)
   bitwise and at 1e-4, with ``torch.sparse.mm`` on the same matrix in CSR
   timed beside it; K3's bound counts the bytes it must move and the flops
   of the nonzero entries (2 · nnz · N).
2. SPMM hybrid: ``make_hybrid_executor`` splits the density-sorted rows
   between K3 on the card and the gather path on host cores;
   ``converge(rounds=5)`` then ``run()``, compared with K3's plain result.
3. HOTSPOT through ``HeteroRuntime``: Table-1 configurations 5
   (4CC+4HPACC+INT, K2) and 7 (4CC+4HPCACC+INT, K1 with steps=1), one
   ``parallel_for`` per time step for 8 steps, compared with the whole-grid
   plain ``hotspot_ref`` on the card; every step must cover each row once.

4. K4 (flash attention) and K5 (SSD scan) at the full-width shapes of the
   serving path, each against its plain version: K4 in bf16 (rtol 2e-2,
   atol 2e-2 of the RMS of each expected (query, head) row) and f32 (rtol
   2e-4, atol 2e-5) against both its plain version and the ``mha_ref``
   oracle, where Sk >= 128 a check that the same tolerance rejects the
   output with one 64-key tile masked out, and
   ``scaled_dot_product_attention`` timed beside it
   on the same function (each row prints kernel ms over SDPA ms; a window
   that masks goes to SDPA as a boolean ``attn_mask`` built outside the
   timed call), at ``K4_SHAPES``: the causal prefill attention of
   tinyllama-1.1b (B 1, S 2048, 1000 and the longest served prompt's 891,
   whose 7128 rows leave a ragged last tile, H 32, KVH 4, D 64),
   stablelm-12b (S 2048 and 891, H 32, KVH 8, D 160: padded to 192
   columns) and recurrentgemma-9b (H 16, KVH 1, D 256, window 2048: at S
   2048 and 891 the window masks nothing, at S 4096 it masks);
   whisper-large-v3's encoder (no mask, S 1500, H 20, KVH 20, D 64),
   decoder self-attention (causal, S 55, the longest served prompt) and
   cross-attention (Sq 55, 448 and 1 over Sk 1500 frames);
   llama-3.2-vision-90b's self-attention (causal, S 891) and
   cross-attention (Sq 891 over Sk 1024 image tokens, H 64, KVH 8, D
   128); what phase 9 hands K4 on a rank of its (2, 2) mesh (B 2, S
   2048, 16 query and 2 kv heads: tinyllama's at D 64, qwen3-moe's at
   D 128); and what phase 10a/10c's prefill hands it, on a rank (B 2, S
   512, 16 / 2 heads, D 64) and in the parent's one-rank run (B 4, S 512,
   32 / 4 heads).  K4's bound counts the (query, key) pairs its masks
   keep.  Each K4 row also names the kernel that ran (bf16 past D 128:
   ``flash_fwd_bf16_wide``, launched once a call there and nowhere else;
   f32: ``flash_fwd_f32_kernel``, counted in ``f32_launches``),
   SDPA's time on the card alone (``library_device_ms``) beside its
   ``library_ms``.  An f32 row's bound prices its products on the split
   route (six bf16 products of three-piece operands at the bf16 peak,
   ``split_bound_ms``), the 67 TFLOP/s f32 bound beside it
   (``bound_67tf_ms``), and it prints the error against float64
   (``float64_attention``) of the kernel, the plain version and SDPA, as
   the largest share of the f32 tolerance an element takes
   (``float64_error_ratio``; the kernel's must be at most the larger of
   0.1 and twice the plain version's), the kernels SDPA launched
   (``library_kernels``) and its own by the profiler's names
   (``launch_device_ms``).  A line of its own gives, for each row, the (64-row
   tile, 64-key tile) pairs the wrapper's ``forward_walk`` says the forward
   walks (a model, not read on the card) beside those that hold a pair the
   masks keep.  The kernels line carries the wide forward as
   ``flash_attention_wide`` (its row: stablelm-12b's S 2048 in bf16) and
   the f32 forward as ``flash_attention_f32`` (tinyllama's S 2048 in
   f32).  K5 at mamba2-130m's prefill
   (``K5_SHAPES``: B 1 at S 2048, 1000 and the longest served prompt's
   891; phase 10b's B 2 a rank and B 4 in the one-rank run at S 512; H 24,
   P 64, N 128, chunk 256) with zero and
   nonzero h0 at 2e-4.  Then the backward kernels at what training hands
   them, each against its plain backward (``flash_attention_backward_plain``,
   ``ssd_scan_backward_plain``) on the forward kernel's row statistics,
   two calls bitwise equal, timed beside the plain backward: K4's in both
   dtypes at ``K4_BACKWARD_SHAPES`` (phase 7's tinyllama microbatch B 4 ×
   2048, a phase-9 rank's 16 / 2 heads at D 64 and 128, stablelm's D 160,
   recurrentgemma's D 256 at S 2048, where its window drops no pair, and
   at S 4096, where it masks and its one kv head leaves the dK/dV grid
   short of a wave (its walk split: the row prints ``walk_splits`` and
   ``dkdv_ctas``, at least the card's SMs), whisper's non-causal
   cross-attention 448 × 1500), K5's at mamba2's B 4 × 2048 (dy alone)
   and B 1 × 1000 with h0 (dy and the final state's gradient).  A
   backward's bound is its least work: 2.5× the forward's operations.
   Each backward row carries the device time of every kernel it launches
   (``launch_device_ms``, from ``torch.profiler``), and K4's rows the
   time of one PyTorch call on the same inputs (``library_ms``, with
   ``library_call``), K and V expanded to H heads before the timed call:
   in bf16 ``_scaled_dot_product_flash_attention_backward`` on the output
   and logsumexp of its forward where no window drops a pair; in f32, and
   in bf16 where one does, ``_scaled_dot_product_efficient_attention_
   backward`` on those of its forward, the window an additive 0 / -inf
   bias, with its device time (``library_device_ms``) and the kernels it
   launched (``library_kernels``); a shape PyTorch refuses prints the
   error under ``library_error``, with no time.  K4's f32 backward rows
   carry both bounds and the float64 errors of dq, dk and dv as the
   forward's do, and the kernels line carries the f32 backward as
   ``flash_attention_f32_backward``.
5. Serving at full width, inline: tinyllama-1.1b (K4, D 64), mamba2-130m
   (K5), stablelm-12b (K4, D 160; 24 GB in bf16), qwen3-moe-30b-a3b (K4,
   D 128, 128 experts top-8 with capacity chunks and the dense fallback;
   61.5 GB in bf16) and recurrentgemma-9b (RG-LRU and local attention,
   K4 in its 12 attn layers, D 256; 17.3 GB in bf16), one model on the
   card at a time, random bf16 weights from a seeded generator on the
   card, 8 requests through ``ServingEngine`` (4 slots, continuous,
   inline, greedy, max_len 2048).  Every request completes, the RunReport
   covers each exactly once, the kernel launches equal the layers that
   launch it × prefills (176, 192, 320, 384 and 96; stablelm-12b's and
   recurrentgemma-9b's all through the wide bf16 forward), and a float32 copy
   of each model (its bf16 weights moved to the host first; qwen3-moe's
   first 4 layers, since its 123 GB do not fit) gives the same greedy
   tokens through the kernels as through their plain versions, with
   last-position logits within rtol/atol 1e-3 (since PR 22 at a depth
   that leaves phase 11 room: the first 8 layers of tinyllama-1.1b,
   mamba2-130m and stablelm-12b, recurrentgemma-9b's first 9, three whole
   patterns); the MoE check prints the
   smallest top-k router margin it met; recurrentgemma's f32 copy also
   prefills a 3000-token prompt (max_len 4096: its KV caches roll at 2048
   rows) and decodes 16 tokens, equal between kernels and plain.
   K4's launches in the f32 copy are all f32's (``flash_attention_f32``),
   one a layer that holds K4 and a prefill.  Prints
   TTFT, prefill and decode times, tokens/s, peak memory, the MoE routing
   of one prefill (``moe_overflow_frac``, ``moe_load_max`` as means over
   the layers) and a profiler top-10 of one prefill and one decode step.
   The two families whose prefill takes a second input run through
   ``Model.prefill`` and ``decode_step``: whisper-large-v3 (32 + 32
   layers; 4 requests, frames (1, 1500, 1280) and prompts of 4–64 tokens
   from a seed, 32 greedy tokens each) and llama-3.2-vision-90b cut to 10
   of its 100 layers (two patterns, 8 attn + 2 cross: 181 GB of bf16
   weights do not fit one card; image embeddings (1, 1024, 8192), an
   891-token prompt, 16 greedy tokens; its cross gates set to 0.5, since
   at their initial 0 tanh(0) multiplies the cross path away), after one
   uncounted, untimed warm-up request.  Their K4 launches are counted by
   form (encoder, self, cross, cross-decode: read from the arguments of
   each ``attention`` call that launched it) against the layers, and
   their f32 copies give equal greedy tokens through the kernels and the
   plain versions; a profiler top-10 of one prefill and one decode step.
   Every model but the first two is served last, after phase 6: moving
   bf16 weights to the host for the f32 checks leaves the process slower
   on the host, which would reach phase 6a's host-clock times.
6. Slice B on the card:
   a. Remote prefill: 2 worker processes (``spawn_worker``), each warmed
      once with a short prefill; phase 5's 8 requests served per model
      with ``backend="remote:a,b"`` and a ``cuda`` model spec (seed 0), 4
      slots, continuous, greedy.  Every token stream equals phase 5's
      inline one, the workers launch K4 22 × 8 and K5 24 × 8 times (read
      by a ``LaunchCounts`` probe through a ``RemoteUnit``), and the
      parent launches neither.  Prints TTFT, prefill and decode times,
      tokens/s, the cache bytes a request and the wire latency.
   b. ``checkpointed_parallel_for`` over phase 1's 3745 row blocks on 4
      ``CudaStreamUnit`` ACC units, each chunk ``[a, b)`` running K3 on
      row blocks ``a:b`` into ``out[8a:8b]``; the work raises in round 3
      (a crash), a fresh runtime resumes from the checkpoint directory and
      runs exactly the rows the bitmap left, and ``out`` is bitwise equal
      to phase 1's K3 output.  Prints the checkpoint write time and the
      overhead against a plain ``parallel_for`` and phase 2's ``run()``.
   c. A ``FleetManager`` with 2 workers hosting ``cuda`` units runs a
      ``parallel_for`` of ``SleepWork``; one worker is frozen (SIGSTOP)
      mid-run, convicted by missed heartbeats (``action="dead"``) and its
      chunk requeued exactly once; then it is killed and reaped.
7. Training at full width (last, so the earlier host-clock numbers stay
   comparable): tinyllama-1.1b (K4; bf16 parameters, f32 AdamW moments)
   and mamba2-130m (K5), each through ``run_training`` (batch 8 × 2048,
   2 microbatches, 6 steps, lr 3e-4, a checkpoint every 3 steps).  Every
   loss is finite; step 0's batch scores below its first loss with the
   trained parameters (step 6's checkpoint), and for tinyllama the last
   step's loss is below the first's (``FRESH_BATCH_LOSS_FALLS``); for
   mamba2 the same 6 steps run again with ``plain=True`` and their
   losses are printed beside the kernels' (a witness, not a check); the
   kernel launches equal 2 × the layers that hold it × 2 microbatches ×
   6 steps (remat runs each unit's forward twice); a second run resumes
   at step 3 from its checkpoint, runs exactly 3 steps and ends within
   rtol 1e-2 of the first's final loss.  Then: the step's host-clock time
   (the resumed run's steps after its first two, median; each ends in
   ``torch.cuda.synchronize()``), tokens/s, the model-flops share (6 · ``active_param_count()`` · tokens
   over the step time and the 989 TFLOP/s bf16 peak, attention excluded),
   peak memory, and a profiler top-10 of one step with the shares in the
   kernel's forward and backward kernels; the backward kernel's launches
   equal the layers that hold it × 2 microbatches × 6 steps, and an
   observer of ``flash_attention_plain``, ``ssd_scan_plain`` and
   ``ssd_chunked`` (every module that binds them) counts 0 calls during the
   run and the resumed run: no plain version runs in a step; a float32
   copy at full width takes one step on a 2 × 2048 batch through the
   kernels and with ``plain=True``: loss within rtol 1e-5, ``grad_norm``
   within 1e-4, every gradient within 1e-4 of the tree's largest |g|
   (before the optimizer), and 2 microbatches against 1 at the same
   tolerance.  Last, the ``Function``'s forward + backward is timed at the
   training microbatch (K4: B 4, S 2048, H 32, KVH 4, D 64, bf16, beside
   ``scaled_dot_product_attention``'s forward + backward; K5: B 4, S
   2048, H 24, P 64, N 128) against autograd of its plain version, with
  the bound of its forward + backward.  Phase 7 runs ``run_training`` on
  its (1, 1) mesh and keeps mamba2's step-3 checkpoint for phase 8.  A
  third run puts K4's backward past D 128 in a training step
  (``WIDE_TRAIN``): stablelm-12b at full width (D 160) cut to 4 of its 40
  layers (``reduced``), 4 steps of the same batch and microbatches, no
  checkpoint: finite losses, no plain version called, 2 × 4 × 2 × 4 K4
  launches (every one the wide bf16 forward) and 4 × 2 × 4 backward
  launches, the median step, one profiled step's
  backward kernels by name with their share of its kernel time, and the
  float32 parity step at those 4 layers at the measures above.
8. The distribution layer (slice F1): two ranks spawned on the one card
   share gloo (NCCL refuses two ranks on one device; ``Group`` stages
   gloo's send and recv of CUDA tensors through pinned host buffers and
   counts the bytes); the parent built the kernels, the ranks load them.
   a. mamba2-130m at full width: phase 7's step-3 checkpoint restored
      onto a (2, 1) ``("data", "model")`` mesh with ``reshard_tree``
      (every shard bitwise its slice of the saved arrays), an
      ``ElasticMeshManager`` plan's ``elastic_restore_summary``, then
      ``run_training`` on the mesh for steps 3–5 (batch 8 × 2048, 4 ×
      2048 a rank, 1 microbatch from ``default_microbatches``): each
      loss within 5e-3 of phase 7's resumed one-rank run, 2 × 24 × 3 K5
      launches a rank; one more step's time and the bytes its
      collectives move.
   b. tinyllama-1.1b's 22 layers in 2 GPipe stages (``stage_partition``,
      ``pipeline_apply``), 4 microbatches of 1 × 2048 in bf16, against
      the same blocks in order on rank 0 (the bf16 tolerance); 11 × 4 K4
      launches a stage.
   c. tinyllama-1.1b at published widths cut to 2 layers, f32, batch 4 ×
      512: the two-rank step against the one-rank step with 2
      microbatches (loss 1e-5, ``grad_norm`` 1e-4, every gathered
      gradient 1e-4 of the largest |g|), and ``compressed_psum`` of each
      rank's gradients within 0.02 of the exact sum, with the bytes each
      hands to the collective.
9. Tensor and sequence parallelism (slice F2): four ranks spawned on the
   one card share gloo on a (2, 2) ``("data", "model")`` mesh; each rank
   holds its block of every leaf, computes on its ``model`` block (its
   heads through K4, its experts) and reduces over the model group.
   a. ``run_training`` on the mesh, tinyllama-1.1b at full width, bf16,
      global batch 4 × 2048, 1 microbatch, 2 steps from the seed: finite
      losses, 2 × 22 × 2 K4 launches a rank (16 query and 2 kv heads a
      call); a rank's step ms (the steps after the first; each ends in
      ``torch.cuda.synchronize()``), the bytes it hands to the model
      group's and the data group's collectives a step, its peak memory.
   b. The same for qwen3-moe-30b-a3b at published widths cut to 2 of 48
      layers (``local`` dispatch: each model rank serves 64 of the 128
      experts), and each data shard's own ``moe_overflow_frac`` and
      ``moe_load_max`` in the first step's forward, read where the
      routing plan's statistics are computed (before their mean over the
      data shards).
   c. float32, batch 4 × 512: tinyllama at 2 layers, sequence
      parallelism off and on, and mamba2-130m at 4 layers (K5 on the
      gathered ``in_proj`` path), each held to the one-rank step on the
      same card as 8c holds; qwen3-moe at 2 layers held to itself through
      K4's plain version (per-shard routing differs from one rank's
      global routing by design): every token's experts equal, the aux
      losses within 1e-5, the same f32 measures.
10. Prefill and decode on the (2, 2) mesh (slice F3a): the parent runs
   each case's prompts through the one-rank ``Model.prefill`` /
   ``decode_step``, then four ranks spawned on the one card share gloo
   on a (2, 2) ``("data", "model")`` mesh and run ``make_prefill_step``
   and 4 greedy ``make_decode_step`` calls on their blocks of the same
   seeded weights (each call gathers the data-axis shards), batch 4 ×
   512 prompt tokens from a seeded generator (2 rows a data shard),
   caches of 1024 rows.
   a. tinyllama-1.1b at full width, float32: the greedy tokens (the
      argmax over the model group, ``models.greedy_tokens``) equal the
      one-rank run's, each logits block within rtol/atol 1e-3 of its
      rows and vocabulary block of the one-rank logits, at the prefill
      and at each decode step; K4 22 launches a rank a prefill, on 16
      query / 2 kv heads a call, none at decode.
   b. mamba2-130m at full width, float32, the same checks; K5 24
      launches a rank a prefill on all 24 heads (the gathered path).
   c. tinyllama-1.1b in bf16, the same shapes, read and not checked: the
      share of greedy tokens equal to the one-rank bf16 run's.
   For each, a rank's prefill and decode ms (host clock, each call
   ending in ``torch.cuda.synchronize()``), the part of them spent inside
   the groups' collectives and the process's CPU time, the bytes a call
   hands to the model group and to the data group, its peak GB and
   launches; before the spawn, the host's load and the card memory the
   parent still holds.
11. The dry-run (slice F3b, ``launch/dryrun.py``): one rank's step on
   ``meta`` tensors over shape-only groups, priced from the H100 SXM data
   sheet, no card used.
   a. The steps that phases 7 (both models, (1, 1)), 9a and 10a / 10b
      ((2, 2): the prefill and a decode step) ran: each rank's
      collective bytes to the model group and to the data group equal
      what those phases just counted, to the byte; the parameter and
      AdamW state bytes equal the blocks those ranks held (10: the
      parameter blocks); the roofline bound of phase 7's tinyllama step
      and of 9a's is at or under the measured step time.
   b. Each predicted peak printed beside the measured
      ``max_memory_allocated`` (a reading).
   c. ``launch/perf.py``'s cells A, B and C on the 16×16 mesh, traced in
      parallel processes: each variant's terms, dominant term, peak and
      whether it fits, and cells A's and B's flash substitution.
   d. ``examples/torch_hetero_spmm_demo.py`` on the card: the SPMM hybrid
      split through K3, its launches counted on the main paths.

Launch counts are set to 0 just before each main path (phases 2–3 for
K1–K3, each model's serving run in phase 5 and in 6a, 6b for K3, each
training run in phase 7, in each rank 8a's run and 8b's pipeline,
9a's and 9b's runs and 9c's steps, 10's prefill steps, and 11d's example)
and read just after, so they count the main path's launches only; the
JSON line's ``launches`` is phases 2–3's, phase 5's, phase 7's, phase
8's, phase 9's, phase 10's and 11d's (summed over the models and ranks),
``launches_by_path`` names
each model's (whisper's and the vision model's by form, recurrentgemma's
past-the-window check apart) and adds phase 6's, K4's row lists every
phase-4 shape under ``shapes``, and K4's and K5's rows carry phase 7's
forward + backward times and bound under ``train_fwd_bwd``.  The backward
kernels have rows of their own (``flash_attention_backward``,
``ssd_scan_backward``, counted in the wrappers' ``backward_launches``),
with their launches on the training paths (phases 7, 8a, 8c and 9), each
of which must launch them.
Profiler totals sum the CUDA kernels' rows only.  Each phase prints
its wall time.  The last lines are a JSON line of the kernels' numbers
and the JSON result line.

Kernel times: ``ms``, ``plain_ms`` and ``library_ms`` are CUDA events
around one call on an idle card, so a call that the host enqueues more
slowly than the card runs it is timed with its enqueue, as a caller sees
it; ``device_ms`` holds the stream while the host enqueues and times the
card's work alone.
"""

from __future__ import annotations

import contextlib
import functools
import gc
import json
import os
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# bounds divide by the published peaks of one H100 SXM (dense, at its 700 W
# limit): repro_torch.launch.mesh.H100_SXM
# flops of one stencil update of one cell (_step_math: 10 adds/subs, 5 muls)
STENCIL_FLOPS = 15

HOTSPOT_TOL = dict(rtol=1e-5, atol=1e-4)
SPMM_TOL = dict(rtol=1e-4, atol=1e-4)
# K4: f32 at the reference tests' tolerance; bf16 at its rtol, with an
# atol of that fraction of the RMS of each expected output row (one query
# and head), which falls as 1/sqrt(keys attended): a fixed 2e-2 is half a
# typical output at 1500 keys and would pass a dropped 64-key tile, and
# rounding P to bf16 errs by about 2^-9 of that RMS, however the row's
# terms cancel
ATTN_TOL = {"float32": dict(rtol=2e-4, atol=2e-5), "bfloat16": dict(rtol=2e-2, atol_rms=2e-2)}
SSD_TOL = dict(rtol=2e-4, atol=2e-4)
LOGITS_TOL = dict(rtol=1e-3, atol=1e-3)
SERVE_ARCHS = ("tinyllama-1.1b", "mamba2-130m")
# served inline only (phase 5, run after phase 6): at full width each
# leaves no room for a worker's second copy on the card
INLINE_ARCHS = ("stablelm-12b", "qwen3-moe-30b-a3b", "recurrentgemma-9b")
# qwen3-moe in float32 (123 GB) does not fit the card: its f32 check runs
# this many of its layers; the other decoders run the same check at a cut
# depth too (recurrentgemma: three whole patterns, 3 of its attention
# layers), which leaves phase 11 room in the time limit
F32_LAYERS = {"qwen3-moe-30b-a3b": 4, "stablelm-12b": 8, "recurrentgemma-9b": 9,
              "tinyllama-1.1b": 8, "mamba2-130m": 8}
# the block kinds that launch each model kernel, once per layer and prefill
KERNEL_KINDS = {"flash_attention": ("attn", "moe"), "ssd_scan": ("ssd",)}
# a windowed model's extra f32 check: (prompt tokens, max_len, decode steps)
WINDOW_PROMPT = (3000, 4096, 16)
# served through Model.prefill / decode_step after phase 6, with their second
# input: (requests, prompt lengths [lo, hi), greedy decode steps, layers kept
# or None).  llama-3.2-vision-90b keeps 10 of its 100 layers (two whole
# patterns, 8 attn + 2 cross): all 100 take 181 GB in bf16, past one card
CROSS_SOURCE_ARCHS = {
    "whisper-large-v3": (4, (4, 65), 32, None),
    "llama-3.2-vision-90b": (1, (891, 892), 16, 10),
}
# the vision model's cross gates in this run (initialised to 0)
CROSS_GATE = 0.5
# phase 7: training at full width, one model per kernel, through
# run_training: 2 microbatches is default_microbatches' count at 8 x 2048
# tokens and 8192 tokens per device
TRAIN_ARCHS = ("tinyllama-1.1b", "mamba2-130m")
TRAIN_RUN = dict(global_batch=8, seq_len=2048, microbatches=2, steps=6, lr=3e-4, ckpt_every=3)
# phase 7's third run: K4's backward past D 128 in a training step, on
# stablelm-12b (D 160) at full width cut to 4 of its 40 layers (all 40 with
# AdamW's moments and the f32 parity step would not fit the card), TRAIN_RUN's
# batch and microbatches, fewer steps and no checkpoint
WIDE_TRAIN = dict(arch="stablelm-12b", layers=4, steps=4)
# the models whose last step's loss, on its own fresh batch, must also fall
# below the first step's.  mamba2-130m's per-step losses stay within the
# spread between batches over 10 steps at lr 3e-4 (10.9788 -> 10.9794 on
# the card); the reference's own losses stay as flat at the smoke config
# (tests/test_torch_train.py).  For such a model the same steps run again with
# plain=True, no kernel on the path, and both runs' losses are printed
# side by side: the witness that the flat losses are the model's and the
# data's.  A gradient lost in a kernel's Function fails the float32
# parity step, which holds every gradient leaf (in_proj's too) against
# the plain path's.  Every model's learning is also held on step 0's
# batch, which the trained parameters must score lower
FRESH_BATCH_LOSS_FALLS = ("tinyllama-1.1b",)
# the float32 parity step's batch (x 2048 tokens)
PARITY_BATCH = 2
# gradients: an atol of this share of the tree's largest |g|, not per leaf:
# a true gradient of 0 (whisper's attention key biases) is rounding alone
GRAD_REL = 1e-4
# K4 in phase 4: (model and use, B, H, KVH, D, causal, window, (Sq, Sk)
# pairs) of each served model's attention at full width: causal prefills;
# the hybrid's local window, which masks from S 2049 on; whisper's encoder
# (no mask), its decoder's causal self-attention at the longest prompt
# phase 5 serves (55 tokens) and its cross-attention over 1500 frames at
# that prompt, at 448 (the published decoder's whole context) and at a
# decode step (Sq 1); the vision model's causal self-attention and its
# cross-attention over 1024 image tokens at its 891-token prompt; and
# what phase 9a and 9b hand K4 on each rank of the (2, 2) mesh: a data
# shard's 2 rows of 2048 tokens on a model rank's half of the heads; and
# what phase 10a/10c's prefill hands it, on a rank (2 rows of 512 tokens,
# half of the heads) and in the parent's one-rank run (4 rows, every head)
K4_SHAPES = (
    ("tinyllama-1.1b", 1, 32, 4, 64, True, 0, ((2048, 2048), (1000, 1000), (891, 891))),
    ("stablelm-12b", 1, 32, 8, 160, True, 0, ((2048, 2048), (891, 891))),
    ("recurrentgemma-9b", 1, 16, 1, 256, True, 2048, ((2048, 2048), (891, 891), (4096, 4096))),
    ("whisper-large-v3 encoder", 1, 20, 20, 64, False, 0, ((1500, 1500),)),
    ("whisper-large-v3 self", 1, 20, 20, 64, True, 0, ((55, 55),)),
    ("whisper-large-v3 cross", 1, 20, 20, 64, False, 0, ((55, 1500), (448, 1500), (1, 1500))),
    ("llama-3.2-vision-90b self", 1, 64, 8, 128, True, 0, ((891, 891),)),
    ("llama-3.2-vision-90b cross", 1, 64, 8, 128, False, 0, ((891, 1024),)),
    ("tinyllama-1.1b a model rank's heads (9a)", 2, 16, 2, 64, True, 0, ((2048, 2048),)),
    ("qwen3-moe-30b-a3b a model rank's heads (9b)", 2, 16, 2, 128, True, 0, ((2048, 2048),)),
    ("tinyllama-1.1b a model rank's heads (10a/10c)", 2, 16, 2, 64, True, 0, ((512, 512),)),
    ("tinyllama-1.1b one rank (10a/10c)", 4, 32, 4, 64, True, 0, ((512, 512),)),
)
# K5 in phase 4: (B, S) of mamba2-130m's prefills at full width: phase 5's
# prompts, and phase 10b's on a rank (2 rows of 512 tokens, every head on
# the gathered path) and in the parent's one-rank run (4 rows)
K5_SHAPES = ((1, 2048), (1, 1000), (1, 891), (2, 512), (4, 512))
# K4's backward kernel in phase 4, at what training hands it: (use, B, H,
# KVH, D, causal, window, Sq, Sk): phase 7's tinyllama microbatch, a phase-9
# rank's 16 / 2 heads at tinyllama's D 64 and qwen3-moe's D 128, stablelm's
# D 160 (phase 7's third run), recurrentgemma's D 256 at S 2048 (its window
# drops no pair there) and with its window masking at S 4096 (one kv head:
# the dK/dV grid short of a wave walks split ranges), and whisper's
# non-causal cross-attention
K4_BACKWARD_SHAPES = (
    ("tinyllama-1.1b training microbatch (7)", 4, 32, 4, 64, True, 0, 2048, 2048),
    ("tinyllama-1.1b a model rank's heads (9a)", 2, 16, 2, 64, True, 0, 2048, 2048),
    ("qwen3-moe-30b-a3b a model rank's heads (9b)", 2, 16, 2, 128, True, 0, 2048, 2048),
    ("stablelm-12b", 1, 32, 8, 160, True, 0, 2048, 2048),
    ("recurrentgemma-9b", 1, 16, 1, 256, True, 2048, 2048, 2048),
    ("recurrentgemma-9b window", 1, 16, 1, 256, True, 2048, 4096, 4096),
    ("whisper-large-v3 cross", 1, 20, 20, 64, False, 0, 448, 1500),
)
# K5's backward kernels in phase 4: (B, S, h0, gradients of): mamba2-130m's
# training microbatch (y alone reaches the loss), and a partial sub-chunk
# with a carried state, through y and the final state
K5_BACKWARD_SHAPES = ((4, 2048, False, "y"), (1, 1000, True, "both"))


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


class Count:
    """Another count of a kernel wrapper (``wrapper.backward_launches``,
    ``wrapper.wide_launches``), read and set to 0 as a wrapper's
    ``launches``."""

    def __init__(self, wrapper, attr: str):
        self.wrapper, self.attr = wrapper, attr

    @property
    def launches(self) -> int:
        return getattr(self.wrapper, self.attr)

    @launches.setter
    def launches(self, n: int) -> None:
        setattr(self.wrapper, self.attr, n)


def model_wrappers() -> dict:
    """K4 and K5 and their backward kernels, K4's bf16 forward past D 128
    (``flash_fwd_bf16_wide``, counted within K4's launches too) and K4's
    f32 forward and backward (``flash_fwd_f32_kernel`` and its gradient's
    kernels, counted within K4's forward and backward launches too), by the
    names of the JSON line."""
    from repro_torch.kernels.flash_attention.flash_attention import flash_attention
    from repro_torch.kernels.ssd_scan.ssd_scan import ssd_scan

    return {"flash_attention": flash_attention, "ssd_scan": ssd_scan,
            "flash_attention_wide": Count(flash_attention, "wide_launches"),
            "flash_attention_backward": Count(flash_attention, "backward_launches"),
            "flash_attention_f32": Count(flash_attention, "f32_launches"),
            "flash_attention_f32_backward": Count(flash_attention, "f32_backward_launches"),
            "ssd_scan_backward": Count(ssd_scan, "backward_launches")}


def wide_share(cfg, k4_launches: int) -> dict:
    """The wide forward's launches a run of ``cfg`` must count beside K4's:
    every K4 launch of a bf16 model past D 128, else none."""
    wide = cfg.family != "ssm" and cfg.dtype == "bfloat16" and cfg.head_dim > 128
    return {"flash_attention_wide": k4_launches if wide else 0}


# the plain versions that no training step on the card may call: the
# kernels' plain forwards (K5's is ssd_scan_plain over ssd_chunked)
PLAIN_VERSIONS = (("kernels.flash_attention.flash_attention", "flash_attention_plain"),
                  ("kernels.ssd_scan.ssd_scan", "ssd_scan_plain"),
                  ("kernels.ssd_scan.ref", "ssd_chunked"))


@contextlib.contextmanager
def counting_plain_calls(calls: dict):
    """Counts into ``calls[name]`` every call of each of ``PLAIN_VERSIONS``
    made inside the block, wherever the function is bound: every loaded
    ``repro_torch`` module that holds it by name gets a counting wrapper."""
    import importlib

    patched = []
    for module, name in PLAIN_VERSIONS:
        fn = getattr(importlib.import_module(f"repro_torch.{module}"), name)
        calls.setdefault(name, 0)

        def counted(*args, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*args, **kw)

        for mod in list(sys.modules.values()):
            if getattr(mod, "__name__", "").startswith("repro_torch") and \
                    getattr(mod, name, None) is fn:
                setattr(mod, name, counted)
                patched.append((mod, name, fn))
    try:
        yield calls
    finally:
        for mod, name, fn in patched:
            setattr(mod, name, fn)


@functools.lru_cache(maxsize=None)
def spin_cycles_per_ms() -> float:
    """Clock cycles of ``torch.cuda._sleep`` per millisecond on this card."""
    import torch

    torch.cuda._sleep(1_000_000)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(20_000_000)
    end.record()
    end.synchronize()
    return 20_000_000 / start.elapsed_time(end)


def time_ms(fn, *, reps: int = 10, warmup: int = 2, hold: bool = False) -> float:
    """Median milliseconds of ``fn`` on the card, from CUDA events.

    The card is idle when each timed call starts, so the events bracket the
    host's enqueue too wherever the card would wait for it.  With ``hold``
    a spin kernel first holds the stream for twice the host's time to
    enqueue ``fn`` (at most 50 ms), and the events bracket the card's work
    alone: a kernel of a few microseconds is timed as it runs, not as fast
    as Python can launch it.
    """
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    spin = 0
    if hold:
        t0 = time.perf_counter()
        fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        spin = int(min(2.0 * host_ms + 0.05, 50.0) * spin_cycles_per_ms())
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if spin:
            torch.cuda._sleep(spin)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def attn_keep(sq: int, sk: int, causal: bool, window: int):
    """The (Sq, Sk) boolean mask of the pairs K4 keeps, on the card."""
    import torch

    i = torch.arange(sq, device="cuda")[:, None]
    j = torch.arange(sk, device="cuda")[None, :]
    keep = torch.ones(sq, sk, dtype=torch.bool, device="cuda")
    if causal:
        keep &= j <= i
    if window:
        keep &= j > i - window
    return keep


def tile_pairs(nb: int, sq: int, sk: int, h: int, kvh: int, d: int, bf16: bool, causal: bool,
               window: int, keep) -> tuple:
    """(walked, kept): the (64-row tile, 64-key tile) pairs K4's forward
    walks on these inputs as the wrapper's ``forward_walk`` models it (each
    64-row warpgroup of a CTA walks the CTA's walk; nothing here is read on
    the card), and the pairs that hold one (query, key) pair the
    masks keep (``keep``, (Sq, Sk) on the card, or None: every pair)."""
    import torch

    from repro_torch.kernels.flash_attention.flash_attention import (
        KEY_TILE, forward_cta_rows, forward_walk,
    )

    g, cta = h // kvh, forward_cta_rows(d, bf16)
    rows, key_tiles = sq * g, -(-sk // KEY_TILE)
    if keep is not None:  # (Sq, key tiles): a position keeps a key of the tile
        padded = torch.nn.functional.pad(keep, (0, key_tiles * KEY_TILE - sk))
        by_tile = padded.reshape(sq, key_tiles, KEY_TILE).any(-1)
    walked = kept = 0
    for rho0 in range(0, rows, cta):
        t_lo, t_end = forward_walk(rho0 // g, (min(rho0 + cta, rows) - 1) // g, sk, causal,
                                   window)
        walked += cta // 64 * (t_end - t_lo)
        for r0 in range(rho0, min(rho0 + cta, rows), 64):
            p0, p1 = r0 // g, (min(r0 + 64, rows) - 1) // g
            kept += key_tiles if keep is None else int(by_tile[p0:p1 + 1].any(0).sum())
    return nb * kvh * walked, nb * kvh * kept


def without_a_tile(q, k, v, keep):
    """Attention in f32 with the 64 keys of one tile in the middle of
    ``k`` masked out of every row besides ``keep``'s mask: what a kernel
    that dropped or mis-masked that tile would return."""
    import torch

    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    keep = keep.clone()
    t0 = 64 * (sk // 128)
    keep[:, t0:t0 + 64] = False
    qg = q.float().reshape(b, sq, kvh, h // kvh, d)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * d**-0.5
    w = torch.softmax(s.masked_fill(~keep, float("-inf")), dim=-1)
    return torch.einsum("bkgqs,bskd->bqkgd", w, v.float()).reshape(b, sq, h, d)


def attn_tol(dtype_name: str, want) -> dict:
    """``ATTN_TOL`` for ``want`` (B, Sq, H, D), bf16's atol scaled by the
    RMS of each (query, head) row: a tensor (B, Sq, H, 1)."""
    tol = dict(ATTN_TOL[dtype_name])
    if "atol_rms" in tol:
        tol["atol"] = tol.pop("atol_rms") * want.float().pow(2).mean(-1, keepdim=True).sqrt()
    return tol


def within(got, want, tol: dict) -> bool:
    """``torch.allclose``'s test, |got - want| <= atol + rtol·|want| in
    every element, with ``atol`` a number or a tensor that broadcasts."""
    return bool(((got - want).abs() <= tol["atol"] + tol["rtol"] * want.abs()).all())


def bound_ms(n_bytes: float, flops: float, bf16: bool = False):
    """(least milliseconds, "bytes" or "operations") on the published peaks
    (the operations at the bf16 tensor-core rate, else at the f32 rate)."""
    from repro_torch.launch.mesh import H100_SXM

    t_bytes = n_bytes / H100_SXM.hbm_bw
    t_ops = flops / (H100_SXM.peak_flops if bf16 else H100_SXM.f32_flops)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def split_bound_ms(n_bytes: float, flops: float):
    """``bound_ms`` of f32 K4 work on the tensor cores: each f32 product as
    the six bf16 products of three-piece operands (``ops.tensor_core_flops``)
    at the bf16 peak; with the same work's bound at the 67 TFLOP/s f32 rate
    beside it: (ms, bound_by, ms at 67 TF)."""
    from repro_torch.kernels.flash_attention import ops as fops

    b, by = bound_ms(n_bytes, fops.tensor_core_flops(flops, bf16=False), bf16=True)
    return b, by, bound_ms(n_bytes, flops)[0]


def float64_attention(q, k, v, gy, causal: bool, window: int, scale: float):
    """K4's function in float64 (the plain version's arithmetic: masked
    scores at MASK_VALUE, so a row that sees no key averages every key) and,
    with ``gy``, its gradient by autograd: (o, dq, dk, dv), float64."""
    import torch

    from repro_torch.kernels.flash_attention.flash_attention import MASK_VALUE

    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    with torch.enable_grad():
        q, k, v = (x.detach().double().requires_grad_(gy is not None) for x in (q, k, v))
        s = torch.einsum("bqkgd,bskd->bkgqs", q.reshape(b, sq, kvh, h // kvh, d) * scale, k)
        keep = attn_keep(sq, sk, causal, window)
        p = torch.softmax(s.masked_fill(~keep, MASK_VALUE), dim=-1)
        del s
        o = torch.einsum("bkgqs,bskd->bqkgd", p, v).reshape(b, sq, h, d)
        if gy is None:
            return (o.detach(),)
        return (o.detach(), *torch.autograd.grad(o, (q, k, v), gy.double()))


def f32_error_ratio(got, want) -> float:
    """The largest |got - want| / (atol + rtol |want|) at K4's f32
    tolerance: 1 is the tolerance's edge."""
    tol = ATTN_TOL["float32"]
    want = want.double()
    return float(((got.double() - want).abs() / (tol["atol"] + tol["rtol"] * want.abs())).max())


def compare(name: str, got, want, tol: dict) -> float:
    import torch

    err = float((got - want).abs().max())
    atol = tol["atol"]
    if torch.is_tensor(atol):
        atol = f"{float(atol.min()):.3e}..{float(atol.max()):.3e}"
    require(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    require(within(got, want, tol), f"{name}: max |err| {err} beyond rtol={tol['rtol']} "
            f"atol={atol}")
    print(f"{name}: max_abs_err={err:.3e} within rtol={tol['rtol']} atol={atol}")
    return err


def phase1_kernels(cfg, spmm_cfg):
    import numpy as np
    import torch

    from repro_torch import _build, convert
    from repro_torch.kernels.hotspot.hotspot import (
        hotspot_hp_step, hotspot_hp_step_plain, hotspot_hpc, hotspot_hpc_plain, shift_rows,
    )
    from repro_torch.kernels.spmm.ops import pad_rhs
    from repro_torch.kernels.spmm.ref import make_problem, to_block_ell
    from repro_torch.kernels.spmm.spmm import BlockEllArrays, spmm_block_ell, spmm_block_ell_plain

    t0 = time.perf_counter()
    per_source = _build.build(verbose=True)
    print(f"build_s={time.perf_counter() - t0:.3f} per_source="
          + json.dumps({k: round(v, 3) for k, v in per_source.items()}))

    kernels = {}
    # -- HOTSPOT: K1 and K2 at the paper's 2048² grid ------------------------
    rng = np.random.default_rng(0)
    rows = cols = cfg.grid
    temp, power = convert.hotspot_grids(
        80.0 + 10.0 * rng.random((rows, cols), np.float32),
        rng.random((rows, cols), np.float32), "cuda")
    steps = cfg.sim_steps
    cells = rows * cols

    got, want = hotspot_hpc(temp, power, cfg, steps), hotspot_hpc_plain(temp, power, cfg, steps)
    err = compare("K1 hotspot_hpc", got, want, HOTSPOT_TOL)
    require(torch.equal(got, want), "K1: not bitwise equal to its plain version")
    ms = time_ms(lambda: hotspot_hpc(temp, power, cfg, steps))
    dev = time_ms(lambda: hotspot_hpc(temp, power, cfg, steps), hold=True)
    plain = time_ms(lambda: hotspot_hpc_plain(temp, power, cfg, steps))
    b, by = bound_ms(3 * cells * 4, STENCIL_FLOPS * cells * steps)
    print(f"K1 2048² x {steps} steps: {ms:.4f} ms ({dev:.4f} ms on the card), "
          f"bound {b:.4f} ms ({by})")

    # the runtime's ACC chunk (phase 3): 128 rows and a halo row each side,
    # steps=1, with the full grid's coefficients
    band_t, band_p = temp[127:257].contiguous(), power[127:257].contiguous()
    got = hotspot_hpc(band_t, band_p, cfg, 1, grid=(rows, cols))
    want = hotspot_hpc_plain(band_t, band_p, cfg, 1, grid=(rows, cols))
    require(torch.equal(got, want), "K1 band: not bitwise equal to its plain version")
    band_ms = time_ms(lambda: hotspot_hpc(band_t, band_p, cfg, 1, grid=(rows, cols)))
    band_dev = time_ms(lambda: hotspot_hpc(band_t, band_p, cfg, 1, grid=(rows, cols)),
                       hold=True)
    band_b, band_by = bound_ms(3 * band_t.numel() * 4, STENCIL_FLOPS * band_t.numel())
    print(f"K1 band {tuple(band_t.shape)} steps=1: bitwise equal, {band_ms:.4f} ms with the "
          f"host's enqueue, {band_dev:.4f} ms on the card, bound {band_b:.4f} ms ({band_by})")
    kernels["hotspot_hpc"] = dict(
        name="hotspot_hpc", route="cuda", source="src/repro_torch/csrc/hotspot.cu",
        replaces="src/repro/kernels/hotspot/hotspot.py:77",
        max_abs_err=err, ms=ms, device_ms=dev, plain_ms=plain, bound_ms=b, bound_by=by,
        library_ms=None)

    t_hp, t_plain = temp, temp
    for _ in range(steps):
        t_hp = hotspot_hp_step(t_hp, power, cfg)
        t_plain = hotspot_hp_step_plain(t_plain, shift_rows(t_plain, "up"),
                                        shift_rows(t_plain, "down"), power, cfg)
    err = compare("K2 hotspot_hp_step (8 launches)", t_hp, t_plain, HOTSPOT_TOL)
    ms = time_ms(lambda: hotspot_hp_step(temp, power, cfg))
    dev = time_ms(lambda: hotspot_hp_step(temp, power, cfg), hold=True)
    copies = time_ms(lambda: (shift_rows(temp, "up"), shift_rows(temp, "down")))
    plain = time_ms(lambda: hotspot_hp_step_plain(
        temp, shift_rows(temp, "up"), shift_rows(temp, "down"), power, cfg))
    # one step: T, up, down, P read and T written, plus the two shifted
    # copies (each reads and writes a grid) the HP port materialises
    b, by = bound_ms(9 * cells * 4, STENCIL_FLOPS * cells)
    print(f"K2 one step: {ms:.4f} ms, of which the shifted copies alone take {copies:.4f} ms")
    kernels["hotspot_hp_step"] = dict(
        name="hotspot_hp_step", route="cuda", source="src/repro_torch/csrc/hotspot.cu",
        replaces="src/repro/kernels/hotspot/hotspot.py:110",
        max_abs_err=err, ms=ms, device_ms=dev, plain_ms=plain, bound_ms=b, bound_by=by,
        library_ms=None)

    # the unit work of phase 3 alone: a CC band (17 rows, one host thread)
    # and an ACC chunk (128 rows plus halos) through K2 and K1
    from repro_torch.kernels.hotspot.ops import hotspot_step_banded

    host_t, host_p = temp[:19].cpu(), power[:19].cpu()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    cc_ms = []
    for _ in range(7):
        t0 = time.perf_counter()
        hotspot_step_banded(host_t, host_p, cfg, (rows, cols))
        cc_ms.append((time.perf_counter() - t0) * 1e3)
    torch.set_num_threads(threads)
    print("band_alone " + json.dumps({
        "cc_17_rows_host_ms": statistics.median(cc_ms),
        "k2_130_rows_ms": time_ms(lambda: hotspot_hp_step(band_t, band_p, cfg, grid=(rows, cols))),
        "k1_130_rows_ms": band_ms,
    }))

    # -- SPMM: K3 on the full paper problem -----------------------------------
    t0 = time.perf_counter()
    problem = make_problem(spmm_cfg.rows, spmm_cfg.cols, spmm_cfg.dense_cols,
                           nnz_mean=spmm_cfg.nnz_per_row_mean,
                           nnz_sigma=spmm_cfg.nnz_per_row_sigma, seed=spmm_cfg.seed)
    t1 = time.perf_counter()
    be = to_block_ell(problem)
    t2 = time.perf_counter()
    ell = BlockEllArrays(be, "cuda")
    rhs_pad = convert.to_tensor(pad_rhs(problem), "cuda")
    torch.cuda.synchronize()
    print(f"spmm set-up: make_problem {t1 - t0:.3f} s, to_block_ell {t2 - t1:.3f} s, "
          f"to card {time.perf_counter() - t2:.3f} s; nnz={int(problem.nnz.sum())} "
          f"maxnnz={problem.vals.shape[1]} row_blocks={be.n_row_blocks} K={be.k_max} "
          f"occupied_blocks={int(be.counts.sum())} vals_GB={be.vals.nbytes / 1e9:.3f}")

    out = spmm_block_ell(ell, rhs_pad)
    want = spmm_block_ell_plain(ell, rhs_pad)
    err = compare("K3 spmm_block_ell", out, want, SPMM_TOL)
    require(torch.equal(out, want), "K3: not bitwise equal to its plain version")
    ms = time_ms(lambda: spmm_block_ell(ell, rhs_pad), reps=5)
    dev = time_ms(lambda: spmm_block_ell(ell, rhs_pad), reps=5, hold=True)
    plain = time_ms(lambda: spmm_block_ell_plain(ell, rhs_pad), reps=3, warmup=1)

    # yardstick only: the same product as one cuSPARSE call through torch
    nnz_mask = np.arange(problem.vals.shape[1]) < problem.nnz[:, None]
    crow = np.concatenate([[0], np.cumsum(problem.nnz, dtype=np.int64)])
    csr = torch.sparse_csr_tensor(
        torch.from_numpy(crow), torch.from_numpy(problem.cols[nnz_mask].astype(np.int64)),
        torch.from_numpy(problem.vals[nnz_mask]), size=(problem.rows, rhs_pad.shape[0]),
        check_invariants=True, device="cuda")
    lib_err = float((torch.sparse.mm(csr, rhs_pad) - want[:problem.rows]).abs().max())
    library = time_ms(lambda: torch.sparse.mm(csr, rhs_pad), reps=5)
    print(f"K3 yardstick torch.sparse.mm (CSR): {library:.4f} ms, max |diff| {lib_err:.3e}")
    del csr

    # what the function needs: every occupied block read once, and a
    # multiply-add per nonzero entry and output column
    occupied = int(ell.counts.sum())
    nnz = int((ell.vals != 0).sum())
    n_dense = rhs_pad.shape[1]
    n_bytes = (occupied * 8 * 128 * 4 + ell.colblocks.numel() * 4 + ell.counts.numel() * 4
               + rhs_pad.numel() * 4 + out.numel() * 4)
    b, by = bound_ms(n_bytes, 2.0 * nnz * n_dense)
    print(f"K3 bound: {n_bytes / 1e9:.4f} GB, {2.0 * nnz * n_dense / 1e9:.4f} GFLOP "
          f"(nnz in blocks {nnz}) -> {b:.4f} ms ({by})")
    kernels["spmm_block_ell"] = dict(
        name="spmm_block_ell", route="cuda", source="src/repro_torch/csrc/spmm.cu",
        replaces="src/repro/kernels/spmm/spmm.py:48",
        max_abs_err=err, ms=ms, device_ms=dev, plain_ms=plain, bound_ms=b, bound_by=by,
        library_ms=library)
    for k in kernels.values():
        print(f"{k['name']}: kernel_ms={k['ms']:.4f} device_ms={k['device_ms']:.4f} "
              f"plain_ms={k['plain_ms']:.4f} "
              f"bound_ms={k['bound_ms']:.4f} ({k['bound_by']}) library_ms={k['library_ms']}")
    k3_ref = want[:problem.rows, :problem.rhs.shape[1]].clone()
    # phase 6b's operands wait on the host, so phases 2-5 find the card as before
    k3_host = (be, rhs_pad.cpu(), out.cpu())
    del ell, out, want, rhs_pad
    return kernels, (temp, power), problem, k3_ref, k3_host


def phase2_spmm_hybrid(problem, k3_ref):
    import numpy as np
    import torch

    from repro_torch.kernels.spmm.ops import make_hybrid_executor
    from repro_torch.kernels.spmm.spmm import spmm_block_ell

    t0 = time.perf_counter()
    ex, order = make_hybrid_executor(problem, device="cuda")
    print(f"hybrid set-up: {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    converged = ex.converge(rounds=5)
    t1 = time.perf_counter()
    res, d = ex.run()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    inv = np.empty_like(order)
    inv[order] = np.arange(len(order))
    compare("SPMM hybrid vs K3 plain", res[torch.from_numpy(inv).to(res.device)], k3_ref,
            SPMM_TOL)
    print("spmm_hybrid " + json.dumps({
        "converged_split": [converged.n_dense, converged.n_sparse],
        "run_split": [d.n_dense, d.n_sparse],
        "dense_fraction": d.dense_fraction,
        "dense_rows_per_s": ex.tracker.get("dense"),
        "sparse_rows_per_s": ex.tracker.get("sparse"),
        "converge_5_rounds_s": t1 - t0,
        "run_s": t2 - t1,
        "rows_per_ms": problem.rows / ((t2 - t1) * 1e3),
        "k3_launches": spmm_block_ell.launches,
    }))
    require(spmm_block_ell.launches > 0, "the SPMM hybrid never launched K3")
    return t2 - t1


def phase3_hotspot_runtime(cfg, temp, power):
    import torch

    from repro_torch.kernels.hotspot.ops import hotspot_hetero
    from repro_torch.kernels.hotspot.ref import hotspot_ref

    rows = temp.shape[0]
    want = hotspot_ref(temp, power, cfg, cfg.sim_steps)
    threads = torch.get_num_threads()
    # one intra-op thread each: 4 CC unit threads must not fight over one pool
    torch.set_num_threads(1)
    try:
        for cid, label, port in (("5", "4CC+4HPACC+INT", "hp"), ("7", "4CC+4HPCACC+INT", "hpc")):
            t0 = time.perf_counter()
            run = hotspot_hetero(temp, power, cfg, cfg.sim_steps, port=port, acc_chunk=128)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            for rep in run.reports:
                require(rep.items == rows, f"config {cid}: {rep.items} rows of {rows}")
                spans = rep.coverage
                require(spans[0][0] == 0 and spans[-1][1] == rows
                        and all(b == c for (_, b), (c, _) in zip(spans, spans[1:])),
                        f"config {cid}: coverage is not exact-once")
            compare(f"HOTSPOT config {cid} {label} vs hotspot_ref", run.out, want, HOTSPOT_TOL)
            n = len(run.reports)
            units = sorted(run.reports[0].per_worker_busy)
            print(f"hotspot_table1_{cid} " + json.dumps({
                "label": label,
                "items_per_ms": rows * n / (wall * 1e3),
                "step_items_per_ms_mean": statistics.mean(r.throughput for r in run.reports),
                "wall_s": wall,
                "load_balance_mean": statistics.mean(r.load_balance for r in run.reports),
                "rows": {u: sum(r.per_worker_items.get(u, 0) for r in run.reports) for u in units},
                "busy_s": {u: sum(r.per_worker_busy.get(u, 0.0) for r in run.reports)
                           for u in units},
                "utilization_mean": {u: statistics.mean(r.utilization.get(u, 0.0)
                                                        for r in run.reports) for u in units},
                "dispatch_latency_us": {u: 1e6 * statistics.mean(
                    (r.dispatch_latency or {}).get(u, 0.0) for r in run.reports) for u in units},
                "d2h_s": run.d2h_seconds,
                "cc_writeback_s": run.cc_writeback_seconds,
            }))
    finally:
        torch.set_num_threads(threads)


def phase4_model_kernels():
    """K4 and K5 against their plain versions at the serving path's full widths."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention, flash_attention_plain,
    )
    from repro_torch.kernels.flash_attention.ref import mha_ref
    from repro_torch.kernels.ssd_scan import ops as sops
    from repro_torch.kernels.ssd_scan.ssd_scan import ssd_scan, ssd_scan_plain

    kernels = {}
    rng = np.random.default_rng(0)
    wide = Count(flash_attention, "wide_launches")
    f32_count = Count(flash_attention, "f32_launches")

    def normal(*shape, scale=1.0):
        return torch.from_numpy(scale * rng.standard_normal(shape, dtype=np.float32)).cuda()

    # -- K4 at the served models' attention -----------------------------------
    rows, walks = [], []
    for model_name, nb, h, kvh, d, causal, window, lengths in K4_SHAPES:
        for sq, sk in lengths:
            q32, k32, v32 = normal(nb, sq, h, d), normal(nb, sk, kvh, d), normal(nb, sk, kvh, d)
            mask = dict(causal=causal, window=window)
            for name, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
                q, k, v = q32.to(dtype), k32.to(dtype), v32.to(dtype)
                run = functools.partial(flash_attention, q, k, v, **mask)
                label = f"K4 flash_attention {model_name} D={d} Sq={sq} Sk={sk} {name}"
                want = flash_attention_plain(q, k, v, **mask)
                before = wide.launches, f32_count.launches
                got = run().float()
                # bf16 past D 128 runs flash_fwd_bf16_wide, f32 flash_fwd_f32_kernel,
                # and nothing else does
                is_wide = dtype == torch.bfloat16 and d > 128
                is_f32 = dtype == torch.float32
                require((wide.launches - before[0], f32_count.launches - before[1]) ==
                        (int(is_wide), int(is_f32)),
                        f"{label}: flash_fwd_bf16_wide and flash_fwd_f32_kernel launched "
                        f"{wide.launches - before[0]} and {f32_count.launches - before[1]} times")
                tol = attn_tol(name, want)
                err = compare(label, got, want.float(), tol)
                # the largest share of its tolerance that an element takes
                used = float(((got - want.float()).abs()
                              / (tol["atol"] + tol["rtol"] * want.float().abs())).max())
                compare(label + " vs mha_ref", got, mha_ref(q, k, v, **mask).float(), tol)
                keep = attn_keep(sq, sk, causal, window)
                if sk >= 128:  # the tolerance rejects an output that lost a 64-key tile
                    require(not within(got, without_a_tile(q, k, v, keep), tol),
                            f"{label}: the tolerance passes an output without one key tile")
                ms = time_ms(run)
                dev = time_ms(run, hold=True)
                plain = time_ms(lambda: flash_attention_plain(q, k, v, **mask), reps=5)
                # yardstick: SDPA computes the same function; where the
                # window masks (recurrentgemma at S > 2048) it takes the
                # mask as a boolean attn_mask, built outside the timed call
                qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
                how = (dict(attn_mask=keep) if window and window < sk else
                       dict(is_causal=causal))
                sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
                    qt, kt, vt, enable_gqa=True, **how)
                lib_out = sdpa().transpose(1, 2)
                lib_err = float((lib_out.float() - want.float()).abs().max())
                library = time_ms(sdpa)
                library_dev = time_ms(sdpa, hold=True)
                el = 2 if dtype == torch.bfloat16 else 4
                # the work this mask leaves: kernel_flops scaled by the
                # window's share of the causal pairs
                flops = fops.kernel_flops(nb, sq, sk, h, d, causal=causal) * \
                    fops.window_share(sq, sk, causal, window)
                n_bytes = fops.kernel_hbm_bytes(nb, sq, sk, h, kvh, d, bytes_per_el=el)
                extra = {}
                if is_f32:  # the split route's bound, the 67 TF one, errors against float64
                    b, by, extra["bound_67tf_ms"] = split_bound_ms(n_bytes, flops)
                    ref = float64_attention(q, k, v, None, causal, window, d**-0.5)[0]
                    extra.update(float64_error_ratio=dict(
                        kernel=f32_error_ratio(got, ref), plain=f32_error_ratio(want, ref),
                        library=f32_error_ratio(lib_out, ref)))
                    # the issue's measure, with the plain version standing in
                    # for the parent's kernel (tools/k4_forward_vs_parent.py
                    # holds the parent's itself)
                    ratios = extra["float64_error_ratio"]
                    require(ratios["kernel"] <= max(0.1, 2 * ratios["plain"]),
                            f"{label}: {ratios} of the f32 tolerance from float64")
                    extra["library_kernels"] = sorted(launch_device_ms(sdpa))
                    extra["launch_device_ms"] = launch_device_ms(run)  # the kernel's, by name
                    del ref
                else:
                    b, by = bound_ms(n_bytes, flops, bf16=True)
                del lib_out
                rows.append(dict(model=model_name, shape=f"B={nb} H={h} KVH={kvh} D={d} Sq={sq} "
                                 f"Sk={sk} causal={causal} window={window} {name}",
                                 max_abs_err=err, tolerance_used=used, ms=ms, device_ms=dev,
                                 plain_ms=plain, bound_ms=b, bound_by=by, library_ms=library,
                                 library_device_ms=library_dev, x_library=ms / library,
                                 x_library_device=dev / library_dev,
                                 library_max_abs_diff=lib_err, kernel=(
                                     "flash_fwd_bf16_wide" if is_wide else "flash_fwd_f32_kernel"
                                     if is_f32 else "flash_fwd_bf16_kernel"), **extra))
                walked, needed = tile_pairs(nb, sq, sk, h, kvh, d, dtype == torch.bfloat16,
                                            causal, window, keep if causal or window else None)
                walks.append(dict(shape=rows[-1]["shape"], tile_pairs_walked=walked,
                                  tile_pairs_kept=needed))
    print("K4 at full width " + json.dumps(rows))
    # a model, not a reading: what forward_walk says each row's CTAs walk
    print("K4 forward walks, modelled by forward_walk " + json.dumps(walks))
    main_row = rows[0]  # tinyllama's S 2048 bf16, every PR's yardstick
    kernels["flash_attention"] = dict(
        name="flash_attention", route="cuda", source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/flash_attention.py:85",
        shapes=[r for r in rows if r["kernel"] == "flash_fwd_bf16_kernel"],
        **{k: main_row[k] for k in ("max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
                                    "bound_by", "library_ms")})
    # tinyllama's S 2048 f32: the f32 forward's yardstick
    f32_row = next(r for r in rows if r["kernel"] == "flash_fwd_f32_kernel")
    kernels["flash_attention_f32"] = dict(
        name="flash_attention_f32", route="cuda",
        source="src/repro_torch/csrc/flash_attention_f32.cu",
        replaces="src/repro/kernels/flash_attention/flash_attention.py:85",
        shapes=[r for r in rows if r["kernel"] == "flash_fwd_f32_kernel"],
        **{k: f32_row[k] for k in ("max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
                                   "bound_by", "library_ms")})
    # stablelm-12b's S 2048 bf16 (D 160): the wide forward's yardstick
    wide_row = next(r for r in rows if r["model"] == "stablelm-12b" and "Sq=2048" in r["shape"]
                    and r["shape"].endswith("bfloat16"))
    kernels["flash_attention_wide"] = dict(
        name="flash_attention_wide", route="cuda",
        source="src/repro_torch/csrc/flash_attention_wide.cu",
        replaces="src/repro/kernels/flash_attention/flash_attention.py:85",
        shapes=[r for r in rows if r["kernel"] == "flash_fwd_bf16_wide"],
        **{k: wide_row[k] for k in ("max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
                                    "bound_by", "library_ms")})

    # -- K5 at mamba2-130m's prefill ------------------------------------------
    h, p, n, chunk = 24, 64, 128, 256
    rows = []
    for nb, s in K5_SHAPES:
        x = normal(nb, s, h, p)
        log_a = torch.from_numpy(-0.2 * rng.random((nb, s, h), np.float32)).cuda()
        bm, cm = normal(nb, s, n, scale=0.3), normal(nb, s, n, scale=0.3)
        for h0 in (None, normal(nb, h, p, n, scale=0.5)):
            label = f"K5 ssd_scan B={nb} S={s} h0={'nonzero' if h0 is not None else 'none'}"
            y, hf = ssd_scan(x, log_a, bm, cm, chunk=chunk, h0=h0)
            y_want, h_want = ssd_scan_plain(x, log_a, bm, cm, chunk=chunk, h0=h0)
            err = max(compare(label + " y", y, y_want, SSD_TOL),
                      compare(label + " state", hf, h_want, SSD_TOL))
            ms = time_ms(lambda: ssd_scan(x, log_a, bm, cm, chunk=chunk, h0=h0))
            dev = time_ms(lambda: ssd_scan(x, log_a, bm, cm, chunk=chunk, h0=h0), hold=True)
            plain = time_ms(lambda: ssd_scan_plain(x, log_a, bm, cm, chunk=chunk, h0=h0), reps=5)
            b, by = bound_ms(sops.kernel_hbm_bytes(nb, s, h, p, n, with_h0=h0 is not None),
                             sops.kernel_flops(nb, s, h, p, n))
            rows.append(dict(shape=label[len("K5 ssd_scan "):], max_abs_err=err, ms=ms,
                             device_ms=dev, plain_ms=plain, bound_ms=b, bound_by=by))
    print("K5 at full width " + json.dumps(rows))
    main_row = rows[0]  # B 1 S 2048, no h0: a prompt's first prefill
    kernels["ssd_scan"] = dict(
        name="ssd_scan", route="cuda", source="src/repro_torch/csrc/ssd_scan.cu",
        replaces="src/repro/kernels/ssd_scan/ssd_scan.py:67", library_ms=None,
        **{k: main_row[k] for k in ("max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
                                    "bound_by")})
    return kernels


def launch_device_ms(fn) -> dict:
    """Device milliseconds of each CUDA kernel one call of ``fn`` launches,
    by kernel name (``torch.profiler``), after a warm-up call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {key[:90]: us / 1e3 for us, key, _ in _kernel_rows(prof)}


def backward_library(q, k, v, gy, causal: bool, window: int, scale: float) -> dict:
    """One PyTorch call that computes K4's backward on the same inputs, K
    and V expanded to the H query heads before the timed call (the group
    sum stays outside it): a yardstick the port never calls.  bf16 without
    a window that drops a pair (none, or one of at least Sq):
    ``_scaled_dot_product_flash_attention_backward`` on the output and
    logsumexp of its forward.  f32 (which the flash kernels do not take),
    and bf16 with such a window: ``_scaled_dot_product_efficient_attention_
    backward`` on those of its forward, the window (where it drops a pair)
    an additive 0 / -inf bias, the causal mask the kernel's own.  Returns
    {ms, device_ms, call, error, kernels (the profiler's kernel names and
    device ms of one call), grads ((dq, dk, dv) in K4's layouts, the group
    summed in float64)}; a shape PyTorch refuses gives no time and the
    error, printed; no other call stands in."""
    import torch

    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    qt, gt = (x.transpose(1, 2).contiguous() for x in (q, gy))
    kt, vt = (x.repeat_interleave(g, dim=2).transpose(1, 2).contiguous() for x in (k, v))
    aten = torch.ops.aten
    windowed = bool(window) and window < sq
    flash = q.dtype == torch.bfloat16 and not windowed
    call = ("_scaled_dot_product_flash_attention_backward" if flash else
            "_scaled_dot_product_efficient_attention_backward")
    out = dict(ms=None, device_ms=None, call=call, error=None, kernels=None, grads=None)
    try:
        if flash:
            fwd = aten._scaled_dot_product_flash_attention(qt, kt, vt, 0.0, causal, False,
                                                           scale=scale)
            o, lse, cum_q, cum_k, max_q, max_k, seed, offset = fwd[:8]

            def run():
                return aten._scaled_dot_product_flash_attention_backward(
                    gt, qt, kt, vt, o, lse, cum_q, cum_k, max_q, max_k, 0.0, causal, seed,
                    offset, scale=scale)
        else:
            bias = torch.zeros((sq, sk), dtype=q.dtype, device=q.device).masked_fill(
                ~attn_keep(sq, sk, False, window), float("-inf")).expand(b, h, sq, sk) \
                if windowed else None
            o, lse, seed, offset = aten._scaled_dot_product_efficient_attention(
                qt, kt, vt, bias, True, 0.0, causal, scale=scale)

            def run():
                return aten._scaled_dot_product_efficient_attention_backward(
                    gt, qt, kt, vt, bias, o, lse, seed, offset, 0.0,
                    [True, True, True, False], causal, scale=scale)
        out.update(ms=time_ms(run), device_ms=time_ms(run, hold=True),
                   kernels=launch_device_ms(run))
        dq, dk, dv = run()[:3]
        out["grads"] = (dq.transpose(1, 2),
                        *(x.double().reshape(b, kvh, g, sk, d).sum(2).transpose(1, 2)
                          for x in (dk, dv)))
    except RuntimeError as e:
        print(f"{call} refused B={b} H={h} D={d} Sq={sq} Sk={sk} causal={causal} "
              f"window={window} {q.dtype}: {e}")
        out["error"] = str(e)[:400]
    return out


def phase4_backward_kernels() -> dict:
    """K4's and K5's backward kernels against their plain versions at the
    shapes training hands them, bitwise equal on two calls, and timed."""
    import numpy as np
    import torch

    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.flash_attention import (
        KEY_TILE, _launch, flash_attention, flash_attention_backward,
        flash_attention_backward_plain, walk_splits,
    )
    from repro_torch.kernels.ssd_scan import ops as sops
    from repro_torch.kernels.ssd_scan.ssd_scan import ssd_scan_backward, ssd_scan_backward_plain

    kernels = {}
    rng = np.random.default_rng(1)

    def normal(*shape, scale=1.0):
        return torch.from_numpy(scale * rng.standard_normal(shape, dtype=np.float32)).cuda()

    def same_bits(a, b):
        return all(x is None and y is None or torch.equal(x, y) for x, y in zip(a, b))

    rows = []
    for use, nb, h, kvh, d, causal, window, sq, sk in K4_BACKWARD_SHAPES:
        q32, k32, v32, g32 = (normal(nb, sq, h, d), normal(nb, sk, kvh, d),
                              normal(nb, sk, kvh, d), normal(nb, sq, h, d))
        mask = dict(causal=causal, window=window, scale=d**-0.5)
        for name, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
            q, k, v, gy = (x.to(dtype) for x in (q32, k32, v32, g32))
            _, stats = _launch(q, k, v, causal, window, mask["scale"], stats=True)
            label = f"K4 backward {use} D={d} Sq={sq} Sk={sk} {name}"
            run = functools.partial(flash_attention_backward, q, k, v, stats, gy, **mask)
            f32 = Count(flash_attention, "f32_backward_launches").launches
            got = run()
            require(Count(flash_attention, "f32_backward_launches").launches - f32 ==
                    int(dtype == torch.float32), f"{label}: the f32 backward's count")
            want = flash_attention_backward_plain(q, k, v, stats[0], stats[1], gy, **mask)
            err = max(compare(f"{label} d{x}", g.float(), w.float(), attn_tol(name, w))
                      for x, g, w in zip("qkv", got, want))
            require(same_bits(got, run()), f"{label}: two calls differ")
            ms = time_ms(run)
            dev = time_ms(run, hold=True)
            plain = time_ms(lambda: flash_attention_backward_plain(q, k, v, stats[0], stats[1], gy,
                                                                   **mask), reps=3)
            el = 2 if dtype == torch.bfloat16 else 4
            # the least work: the backward's five products, 2.5 x the forward's
            flops = 2.5 * fops.kernel_flops(nb, sq, sk, h, d, causal=causal) * \
                fops.window_share(sq, sk, causal, window)
            n_bytes = fops.backward_hbm_bytes(nb, sq, sk, h, kvh, d, bytes_per_el=el,
                                              scratch=False)
            lib = backward_library(q, k, v, gy, causal, window, mask["scale"])
            extra = {}
            if dtype == torch.float32:  # the split route's bound, the 67 TF one, float64
                b, by, extra["bound_67tf_ms"] = split_bound_ms(n_bytes, flops)
                ref = float64_attention(q, k, v, gy, causal, window, mask["scale"])[1:]
                extra["float64_error_ratio"] = ratios = {
                    f"d{x}": dict(kernel=f32_error_ratio(g, r), plain=f32_error_ratio(w, r),
                                  library=None if lib["grads"] is None else
                                  f32_error_ratio(lg, r))
                    for x, g, w, r, lg in zip("qkv", got, want, ref,
                                              lib["grads"] or (None,) * 3)}
                for x, ratio in ratios.items():
                    require(ratio["kernel"] <= max(0.1, 2 * ratio["plain"]),
                            f"{label} {x}: {ratio} of the f32 tolerance from float64")
                del ref
            else:
                b, by = bound_ms(n_bytes, flops, bf16=True)
            del want
            # the dK/dV grid: its key tiles' CTAs, times the ranges of a split walk
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            splits = walk_splits(nb, sq, sk, h, kvh, d, dtype == torch.bfloat16, sms)
            dkdv_ctas = nb * kvh * -(-sk // KEY_TILE) * splits
            require(splits == 1 or dkdv_ctas >= sms, f"{label}: a split dK/dV grid of "
                    f"{dkdv_ctas} CTAs, short of {sms}")
            rows.append(dict(use=use, shape=f"B={nb} H={h} KVH={kvh} D={d} Sq={sq} Sk={sk} "
                             f"causal={causal} window={window} {name}", max_abs_err=err, ms=ms,
                             walk_splits=splits, dkdv_ctas=dkdv_ctas,
                             device_ms=dev, plain_ms=plain, bound_ms=b, bound_by=by,
                             library_ms=lib["ms"], library_device_ms=lib["device_ms"],
                             library_call=lib["call"], library_error=lib["error"],
                             library_kernels=lib["kernels"],
                             launch_device_ms=launch_device_ms(run), bitwise_repeatable=True,
                             **extra))
            del got, stats, lib
    print("K4 backward at training shapes " + json.dumps(rows))
    for entry, dtype, source in (
            ("flash_attention_backward", "bfloat16", "flash_attention_bwd.cu"),
            ("flash_attention_f32_backward", "float32", "flash_attention_f32_bwd.cu")):
        shapes = [r for r in rows if r["shape"].endswith(dtype)]
        main_row = shapes[0]  # tinyllama's training microbatch, phase 7's
        kernels[entry] = dict(
            name=entry, route="cuda", source=f"src/repro_torch/csrc/{source}",
            replaces="src/repro/kernels/flash_attention/flash_attention.py:85", shapes=shapes,
            **{k: main_row[k] for k in ("max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms")})

    hh, p, n = 24, 64, 128
    rows = []
    for nb, s, with_h0, through in K5_BACKWARD_SHAPES:
        x = normal(nb, s, hh, p)
        log_a = torch.from_numpy(-0.2 * rng.random((nb, s, hh), np.float32)).cuda()
        bm, cm = normal(nb, s, n, scale=0.3), normal(nb, s, n, scale=0.3)
        h0 = normal(nb, hh, p, n, scale=0.5) if with_h0 else None
        gy = normal(nb, s, hh, p)
        gh = normal(nb, hh, p, n) if through == "both" else None
        label = f"K5 backward B={nb} S={s} h0={'nonzero' if with_h0 else 'none'} d{through}"
        run = functools.partial(ssd_scan_backward, x, log_a, bm, cm, h0, gy, gh)
        got = run()
        want = ssd_scan_backward_plain(x, log_a, bm, cm, h0, gy, gh)
        err = max(compare(f"{label} d{name}", g, w, SSD_TOL)
                  for name, g, w in zip(("x", "log_a", "B", "C", "h0"), got, want)
                  if w is not None)
        require(same_bits(got, run()), f"{label}: two calls differ")
        ms = time_ms(run)
        dev = time_ms(run, hold=True)
        plain = time_ms(lambda: ssd_scan_backward_plain(x, log_a, bm, cm, h0, gy, gh), reps=3)
        b, by = bound_ms(sops.backward_hbm_bytes(nb, s, hh, p, n, with_h0=with_h0),
                         2.5 * sops.kernel_flops(nb, s, hh, p, n))
        rows.append(dict(shape=label[len("K5 backward "):], max_abs_err=err, ms=ms,
                         device_ms=dev, plain_ms=plain, bound_ms=b, bound_by=by,
                         launch_device_ms=launch_device_ms(run), bitwise_repeatable=True))
    print("K5 backward at training shapes " + json.dumps(rows))
    main_row = rows[0]  # mamba2's training microbatch
    kernels["ssd_scan_backward"] = dict(
        name="ssd_scan_backward", route="cuda", source="src/repro_torch/csrc/ssd_scan.cu",
        replaces="src/repro/kernels/ssd_scan/ssd_scan.py:67", library_ms=None, shapes=rows,
        **{k: main_row[k] for k in ("max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
                                    "bound_by")})
    return kernels


def request_specs(cfg):
    """8 prompts from default_rng(0): 128–1024 tokens, 16–48 new tokens."""
    import numpy as np

    rng = np.random.default_rng(0)
    lengths = rng.integers(128, 1025, 8)
    return [(rid, rng.integers(0, cfg.vocab_size, int(n)).astype(np.int64),
             int(rng.integers(16, 49))) for rid, n in enumerate(lengths)]


def serve(model, params, specs):
    """Serve ``specs`` through a 4-slot continuous inline greedy engine."""
    import torch

    from repro_torch.serving import Request, ServingEngine

    engine = ServingEngine(model, params, slots=4, max_len=2048, mode="continuous",
                           backend="inline", temperature=0.0)
    for rid, prompt, max_new in specs:
        require(bool(engine.submit(Request(rid=rid, prompt=prompt, max_new_tokens=max_new))),
                f"request {rid} was shed")
    t0 = time.perf_counter()
    results = engine.run()
    torch.cuda.synchronize()
    return engine, results, time.perf_counter() - t0


def _kernel_rows(prof):
    """[(device µs, name, calls)] of the CUDA kernels a profile traced, the
    largest first: the device's own events only.  An operator's row also
    carries its kernels' time and a ``record_function`` range has a device
    span of its own, so summing every row would count the time twice."""
    from torch.autograd import DeviceType

    rows = []
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CPU or getattr(evt, "is_user_annotation", False):
            continue
        rows.append((evt.self_device_time_total, evt.key, evt.count))
    rows.sort(reverse=True)
    return rows


def profile_top10(fn):
    """The 10 CUDA kernels with the most device time in one call of ``fn``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = _kernel_rows(prof)
    total = sum(r[0] for r in rows)
    return {"device_ms_total": total / 1e3,
            "top10": [{"name": k[:80], "calls": c, "device_ms": us / 1e3}
                      for us, k, c in rows[:10]]}


def phase5_serving(arch: str, wrappers: dict):
    """Serve one model at full width; returns ({kernel name: launches}, bf16
    tokens, K4's launches past the window)."""
    import gc

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import make_model
    from repro_torch.models.moe import moe_capacity
    from repro_torch.models.transformer import layer_kinds

    cfg = get_config(arch)
    kernel = "ssd_scan" if cfg.family == "ssm" else "flash_attention"
    # the layers that launch the kernel, once each per prefill (the
    # hybrid's rglru layers launch none)
    kernel_layers = sum(kind in KERNEL_KINDS[kernel] for kind in layer_kinds(cfg))
    t0 = time.perf_counter()
    model = make_model(cfg, device="cuda")
    params = model.init(seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    specs = request_specs(cfg)
    prompt_lens = [len(p) for _, p, _ in specs]

    torch.cuda.reset_peak_memory_stats()
    for w in wrappers.values():
        w.launches = 0
    engine, results, wall = serve(model, params, specs)
    launches = {name: w.launches for name, w in wrappers.items()}

    require(sorted(results) == list(range(len(specs))), f"{arch}: not every request finished")
    for rid, _, max_new in specs:
        r = results[rid]
        require(r.ok and len(r.tokens) == max_new, f"{arch}: request {rid} gave {r.error or len(r.tokens)}")
    rep = engine.last_run_report
    spans = rep.coverage
    require(rep.items == len(specs) and spans[0][0] == 0 and spans[-1][1] == len(specs)
            and all(b == c for (_, b), (c, _) in zip(spans, spans[1:])),
            f"{arch}: the RunReport does not cover each request exactly once")
    want = kernel_layers * len(specs)
    require(launches[kernel] == want,
            f"{arch}: {kernel} launched {launches[kernel]} times, not {kernel_layers} layers x "
            f"{len(specs)} prefills = {want}")
    counts = {kernel: want, **wide_share(cfg, want)}
    wide = counts["flash_attention_wide"]
    require(launches["flash_attention_wide"] == wide, f"{arch}: flash_attention_wide launched "
            f"{launches['flash_attention_wide']} times, not {wide}")
    others = {k: v for k, v in launches.items() if k not in counts and v}
    require(not others, f"{arch}: unexpected launches {others}")
    counts = {k: n for k, n in counts.items() if n}

    tokens = sum(len(r.tokens) for r in results.values())
    ttft = sorted(r.ttft for r in results.values())
    prefill = [results[rid].prefill_seconds * 1e3 for rid, _, _ in specs]
    metrics = {
        "arch": arch, "layers": cfg.num_layers, "d_model": cfg.d_model,
        "head_dim": cfg.head_dim,
        "params_B": sum(t.numel() for t in _leaves(params)) / 1e9,
        "init_s": init_s, "prompt_lens": prompt_lens,
        "max_new": [m for _, _, m in specs],
        f"{kernel}_launches": launches[kernel],
        "ttft_p50_ms": statistics.median(ttft) * 1e3,
        "ttft_max_ms": ttft[-1] * 1e3,
        "prefill_ms_per_request": prefill,
        "prefill_ms_mean": statistics.mean(prefill),
        "prefill_tokens_per_s": sum(prompt_lens) / (sum(prefill) / 1e3),
        "decode_steps": engine.steps,
        "decode_ms_per_step": engine.decode_seconds / max(engine.steps, 1) * 1e3,
        "tokens": tokens, "wall_s": wall, "tokens_per_s": tokens / wall,
        "peak_mem_GB": torch.cuda.max_memory_allocated() / 1e9,
    }
    print(f"serve {arch} " + json.dumps(metrics))

    longest = specs[int(np.argmax(prompt_lens))][1]
    prompt = torch.as_tensor(longest, device="cuda")[None, :]
    if cfg.family == "moe":
        # the routing of one prefill: the aux values (summed over the
        # layers) and each layer's overflow and most loaded expert
        aux, per_layer = {}, []
        with torch.no_grad(), _observing("core.moe_dispatch", "expert_load_stats",
                                         lambda _, __, out: per_layer.append(out)):
            model.forward(params, prompt, mode="prefill", caches=model.init_caches(1, 2048),
                          aux=aux)
        print(f"moe routing {arch} prefill ({len(longest)} tokens) " + json.dumps({
            "capacity": moe_capacity(cfg, len(longest)),
            "mean_over_layers": {k: float(v) / cfg.num_layers for k, v in aux.items()},
            "moe_overflow_frac_by_layer": [float(ov) for _, ov in per_layer],
            "moe_load_max_by_layer": [float(load.max()) for load, _ in per_layer],
        }))
    print(f"profile {arch} prefill ({len(longest)} tokens) "
          + json.dumps(profile_top10(lambda: model.prefill(params, prompt, 2048))))
    dec_tokens = torch.zeros((4, 1), dtype=torch.int64, device="cuda")
    kv = [c for c in engine.caches if hasattr(c, "length")]
    dec_pos = kv[0].length.long()[:, None] if kv else \
        torch.full((4, 1), max(prompt_lens), device="cuda")
    print(f"profile {arch} decode step (4 slots) " + json.dumps(profile_top10(
        lambda: model.decode_step(params, dec_tokens, dec_pos, engine.caches))))
    bf16_tokens = {rid: r.tokens for rid, r in results.items()}
    del engine, results

    # a float32 copy: the kernels against their plain versions, end to end.
    # The bf16 weights go to the host first, so the card holds one copy.
    layers = F32_LAYERS.get(arch, cfg.num_layers)
    cfg32 = cfg.replace(dtype="float32", param_dtype="float32", num_layers=layers)
    params["layers"] = params["layers"][:layers]
    params = _map_leaves(params, lambda t: t.cpu())
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params32 = _map_leaves(params, lambda t: t.to("cuda", torch.float32))
    del params
    fast, plain = make_model(cfg32, device="cuda"), make_model(cfg32, device="cuda", plain=True)
    margins = []
    with (_observing("core.moe_dispatch", "route_topk",
                     lambda args, _, out: margins.append(_top_k_margin(args, out)))
          if cfg.family == "moe" else contextlib.nullcontext()):
        for w in wrappers.values():
            w.launches = 0
        _, res_k, _ = serve(fast, params32, specs)
        # K4's f32 kernel, once a layer that holds K4 and a prefill
        f32 = wrappers["flash_attention_f32"].launches
        want32 = sum(kind in KERNEL_KINDS["flash_attention"] for kind in layer_kinds(cfg32)) * \
            len(specs) if kernel == "flash_attention" else 0
        require(f32 == want32 == wrappers["flash_attention"].launches,
                f"{arch} f32: flash_attention_f32 launched {f32} times, K4 "
                f"{wrappers['flash_attention'].launches}, not {want32}")
        if f32:
            counts["flash_attention_f32"] = f32
        _, res_p, _ = serve(plain, params32, specs)
    margin = f", smallest top-k router margin {float(min(margins)):.3e}" if margins else ""
    worst = 0.0
    for rid, prompt_np, _ in specs:
        require(res_k[rid].tokens == res_p[rid].tokens,
                f"{arch} f32: request {rid} greedy tokens differ between kernels and plain"
                + margin)
        prompt = torch.as_tensor(prompt_np, device="cuda")[None, :]
        lk, _ = fast.prefill(params32, prompt, 2048)
        lp, _ = plain.prefill(params32, prompt, 2048)
        worst = max(worst, compare(f"{arch} f32 request {rid} last-position logits", lk, lp,
                                   LOGITS_TOL))
    if layers == cfg.num_layers:
        same = sum(res_k[rid].tokens == bf16_tokens[rid] for rid in bf16_tokens)
        vs_bf16 = f"; {same} of {len(specs)} streams also equal bf16's"
    else:
        vs_bf16 = f" ({layers} of {cfg.num_layers} layers)"
    print(f"serve {arch} f32 kernels vs plain: all {len(specs)} token streams equal, logits "
          f"max |diff| {worst:.3e}{margin}{vs_bf16}; peak_mem_GB "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f}")
    rolled = 0
    if cfg.window:
        rolled = past_the_window(arch, cfg32, fast, plain, params32, wrappers)
    del params32, fast, plain, res_k, res_p
    gc.collect()
    torch.cuda.empty_cache()  # the next model finds the card empty
    return counts, bf16_tokens, rolled


def greedy(model, params, prompt, max_len: int, steps: int, **source):
    """Batch-1 prefill of ``prompt`` (1, S) and ``steps`` greedy decode
    steps: (tokens, prefill ms, decode ms a step, caches), host clock
    through to the card's finish (each token is read back)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = model.prefill(params, prompt, max_len, **source)
    tokens = [int(logits.argmax())]
    prefill_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    for i in range(steps):
        logits, caches = model.decode_step(
            params, torch.tensor([[tokens[-1]]], device="cuda"),
            torch.tensor([[prompt.shape[1] + i]], device="cuda"), caches)
        tokens.append(int(logits.argmax()))
    return tokens, prefill_ms, (time.perf_counter() - t0) * 1e3 / steps, caches


def past_the_window(arch, cfg, fast, plain, params, wrappers):
    """One prompt longer than ``cfg.window`` (its KV caches roll) through
    the kernels and the plain versions in float32: greedy tokens equal.
    Returns K4's launches in the kernels' run."""
    import numpy as np
    import torch

    n_prompt, max_len, steps = WINDOW_PROMPT
    require(n_prompt > cfg.window, f"{arch}: a {n_prompt}-token prompt does not pass the window")
    prompt = torch.as_tensor(np.random.default_rng(1).integers(0, cfg.vocab_size, n_prompt),
                             device="cuda")[None, :]
    out = {}
    for name, model in (("kernels", fast), ("plain", plain)):
        for w in wrappers.values():
            w.launches = 0
        tokens, prefill_ms, decode_ms, caches = greedy(model, params, prompt, max_len, steps)
        launches = {k: w.launches for k, w in wrappers.items() if w.launches}
        rows = {c.k.shape[1] for c in caches if hasattr(c, "length")}
        require(rows == {cfg.window}, f"{arch}: KV caches of {rows} rows, not {cfg.window}")
        out[name] = dict(tokens=tokens, prefill_ms=prefill_ms, decode_ms_per_step=decode_ms,
                         launches=launches.pop("flash_attention", 0))
        require(launches.pop("flash_attention_f32", 0) == out[name]["launches"],
                f"{arch} {name}: a K4 launch past the window took another kernel than f32's")
        require(not launches, f"{arch} {name}: unexpected launches {launches}")
    require(out["kernels"]["tokens"] == out["plain"]["tokens"],
            f"{arch} f32: the {n_prompt}-token prompt's greedy tokens differ between kernels "
            "and plain")
    require(out["plain"]["launches"] == 0, f"{arch}: the plain model launched the kernel")
    print(f"serve {arch} f32 past the window " + json.dumps({
        "prompt": n_prompt, "max_len": max_len, "window": cfg.window, "decode_steps": steps,
        "tokens_equal": True, **{f"{name}_{k}": v[k] for name, v in out.items()
                                 for k in ("prefill_ms", "decode_ms_per_step", "launches")}}))
    return out["kernels"]["launches"]


def _count_forms(counts: dict, wrapper):
    """An observer of a model's ``attention`` calls that adds the K4
    launches each call made to its form, read from the call's arguments:
    ``cross`` (a source given and written to the cache), ``cross-decode``
    (the cached source reused), ``encoder`` (no source, not causal) and
    ``self`` (causal)."""
    seen = [wrapper.launches]

    def observe(args, kw, _):
        n, seen[0] = wrapper.launches - seen[0], wrapper.launches
        if kw.get("kv_x") is not None:
            form = "cross" if kw.get("cache_update", True) else "cross-decode"
        else:
            form = "self" if kw.get("causal", True) else "encoder"
        if n:
            counts[form] = counts.get(form, 0) + n
    return observe


def phase5_cross_source(arch: str, wrappers: dict):
    """A model whose prefill takes a second input (whisper's frames, the
    vision model's image embeddings), at full width, through
    ``Model.prefill`` and ``decode_step`` (the engine's requests carry
    tokens only); returns (launches, launches by kind)."""
    import gc

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import make_model
    from repro_torch.models.transformer import layer_kinds

    full = get_config(arch)
    n_req, (lo, hi), steps, layers = CROSS_SOURCE_ARCHS[arch]
    cfg = full.replace(num_layers=layers) if layers else full
    reduced = {"num_layers": f"{full.num_layers} -> {cfg.num_layers}"} if layers else {}
    if cfg.family == "encdec":
        key, source_shape = "frames", (1, cfg.encoder_seq, cfg.d_model)
        per_prefill = {"encoder": cfg.encoder_layers, "self": cfg.num_layers,
                       "cross": cfg.num_layers}
        per_step = {"cross-decode": cfg.num_layers}
    else:
        kinds = layer_kinds(cfg)
        key, source_shape = "image_embeds", (1, cfg.num_image_tokens, cfg.d_model)
        per_prefill = {"self": len(kinds), "cross": kinds.count("cross")}
        per_step = {"cross-decode": kinds.count("cross")}
    t0 = time.perf_counter()
    model = make_model(cfg, device="cuda")
    params = model.init(seed=0)
    if cfg.family == "vlm":  # at their initial 0, tanh(0) would multiply the cross path away
        for layer in params["layers"]:
            if "gate_attn" in layer:
                layer["gate_attn"].fill_(CROSS_GATE)
                layer["gate_mlp"].fill_(CROSS_GATE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    reqs = [(rng.integers(0, cfg.vocab_size, int(rng.integers(lo, hi))),
             rng.standard_normal(source_shape, dtype=np.float32)) for _ in range(n_req)]

    def run(m, p, dtype):
        """Greedy tokens of every request, and host-clock ms of prefill and decode."""
        out, prefill_ms, decode_ms = [], [], []
        for prompt_np, source_np in reqs:
            prompt = torch.as_tensor(prompt_np, device="cuda")[None, :]
            source = {key: torch.as_tensor(source_np, device="cuda").to(dtype)}
            tokens, pre, dec, _ = greedy(m, p, prompt, len(prompt_np) + steps, steps, **source)
            out.append(tokens)
            prefill_ms.append(pre)
            decode_ms.append(dec)
        return out, prefill_ms, decode_ms

    dtype = getattr(torch, cfg.dtype)
    prompt = torch.as_tensor(reqs[0][0], device="cuda")[None, :]
    source = {key: torch.as_tensor(reqs[0][1], device="cuda").to(dtype)}
    # one uncounted, untimed request first: a shape's first call carries
    # one-off costs (library heuristics, the allocator's growth)
    greedy(model, params, prompt, prompt.shape[1] + 1, 1, **source)
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers.values():
        w.launches = 0
    by_kind = {}
    caller = "models.encdec" if cfg.family == "encdec" else "models.transformer"
    with _observing(caller, "attention", _count_forms(by_kind, wrappers["flash_attention"])):
        bf16_tokens, prefill_ms, decode_ms = run(model, params, dtype)
    launches = {name: w.launches for name, w in wrappers.items()}
    want = {kind: n * n_req for kind, n in per_prefill.items()}
    for kind, n in per_step.items():
        want[kind] = want.get(kind, 0) + n * n_req * steps
    require(by_kind == want, f"{arch}: K4 calls by kind {by_kind}, not {want}")
    require(launches["flash_attention"] == sum(want.values()),
            f"{arch}: K4 launched {launches['flash_attention']} times, not {sum(want.values())}")
    others = {k: v for k, v in launches.items() if k != "flash_attention" and v}
    require(not others, f"{arch}: unexpected launches {others}")

    enc_ms = None
    if cfg.family == "encdec":
        from repro_torch.models.encdec import encoder_forward

        with torch.no_grad():
            enc_ms = statistics.median(_host_ms(lambda: encoder_forward(params, source[key], cfg))
                                       for _ in range(5))
    print(f"serve {arch} " + json.dumps({
        "arch": arch, "layers": cfg.num_layers, "reduced": reduced, "d_model": cfg.d_model,
        "head_dim": cfg.head_dim, key: list(source_shape),
        "params_B": sum(t.numel() for t in _leaves(params)) / 1e9, "init_s": init_s,
        "requests": n_req, "prompt_lens": [len(p) for p, _ in reqs], "decode_steps": steps,
        "flash_attention_launches": launches["flash_attention"],
        "flash_attention_launches_by_kind": by_kind,
        "encoder_ms": enc_ms, "prefill_ms_per_request": prefill_ms,
        "prefill_ms_mean": statistics.mean(prefill_ms),
        "decode_ms_per_step": statistics.mean(decode_ms),
        "peak_mem_GB": torch.cuda.max_memory_allocated() / 1e9,
    }))
    print(f"profile {arch} prefill ({prompt.shape[1]} tokens) " + json.dumps(profile_top10(
        lambda: model.prefill(params, prompt, prompt.shape[1] + steps, **source))))
    _, caches = model.prefill(params, prompt, prompt.shape[1] + steps, **source)
    tok, pos = prompt[:, -1:], torch.tensor([[prompt.shape[1]]], device="cuda")
    print(f"profile {arch} decode step (batch 1) " + json.dumps(profile_top10(
        lambda: model.decode_step(params, tok, pos, caches))))

    # a float32 copy: kernels against plain versions; bf16 weights to the host first
    params = _map_leaves(params, lambda t: t.cpu())
    del model
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg32 = cfg.replace(dtype="float32", param_dtype="float32")
    params32 = _map_leaves(params, lambda t: t.to("cuda", torch.float32))
    del params
    fast, plain = make_model(cfg32, device="cuda"), make_model(cfg32, device="cuda", plain=True)
    for w in wrappers.values():
        w.launches = 0
    tok_k, _, _ = run(fast, params32, torch.float32)
    f32 = wrappers["flash_attention_f32"].launches
    require(f32 == wrappers["flash_attention"].launches == launches["flash_attention"],
            f"{arch} f32: flash_attention_f32 launched {f32} times, not "
            f"{launches['flash_attention']}")
    tok_p, _, _ = run(plain, params32, torch.float32)
    require(tok_k == tok_p, f"{arch} f32: greedy tokens differ between kernels and plain")
    worst = 0.0
    for prompt_np, source_np in reqs:
        prompt = torch.as_tensor(prompt_np, device="cuda")[None, :]
        source = {key: torch.as_tensor(source_np, device="cuda")}
        lk, _ = fast.prefill(params32, prompt, len(prompt_np), **source)
        lp, _ = plain.prefill(params32, prompt, len(prompt_np), **source)
        worst = max(worst, compare(f"{arch} f32 last-position logits", lk, lp, LOGITS_TOL))
    same = sum(a == b for a, b in zip(tok_k, bf16_tokens))
    print(f"serve {arch} f32 kernels vs plain: all {n_req} token streams equal, logits max "
          f"|diff| {worst:.3e}; {same} of {n_req} streams also equal bf16's; peak_mem_GB "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f}")
    del params32, fast, plain
    gc.collect()
    torch.cuda.empty_cache()
    return launches["flash_attention"], by_kind, f32


def _host_ms(fn) -> float:
    """Host-clock milliseconds of ``fn`` through to the card's finish."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def on_worker(address: str, work, timeout: float = 600.0):
    """Run ``work`` once on a ``cuda`` unit of the worker at ``address``;
    returns its completion record (``result``, ``elapsed`` on the worker)
    and the seconds from the submit to the record's arrival here."""
    from repro_torch.core import CompletionBus, RemoteUnit
    from repro_torch.core.scheduler import Chunk

    # a generous retransmit budget: a worker's first call builds a model
    unit = RemoteUnit("probe", address=address, remote_backend="cuda", max_retries=3000,
                      connect_timeout=120.0)
    bus = CompletionBus()
    unit.start(bus)
    try:
        t0 = time.perf_counter()
        unit.submit(Chunk(start=0, stop=1, worker="probe"), work)
        require(bus.wait(timeout=timeout), f"no answer from the worker at {address}")
        round_trip = time.perf_counter() - t0
        rec = bus.drain()[0]
    finally:
        unit.close()
    if rec.error is not None:
        raise RuntimeError(f"work on the worker at {address} failed") from rec.error
    return rec, round_trip


def phase6a_remote_serving(arch: str, inline_tokens: dict, workers, wrappers: dict):
    """Serve phase 5's requests with the prefills in the worker processes."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.launches import LaunchCounts
    from repro_torch.models import make_model
    from repro_torch.serving import Request, ServingEngine
    from repro_torch.serving.engine import _RemotePrefill

    cfg = get_config(arch)
    kernel = "ssd_scan" if cfg.family == "ssm" else "flash_attention"
    model = make_model(cfg, device="cuda")
    params = model.init(seed=0)
    spec = {"config": arch, "smoke": False, "seed": 0, "device": "cuda"}
    specs = request_specs(cfg)
    warm = {}
    for w in workers:  # model build and first launches, outside the timed run
        t0 = time.perf_counter()
        on_worker(w.address, _RemotePrefill(spec, specs[0][1][:16], 2048, rid=0,
                                            temperature=0.0, sample_seed=0))
        warm[w.address] = time.perf_counter() - t0
        on_worker(w.address, LaunchCounts())  # zeroes the worker's counts
    for wrapper in wrappers.values():
        wrapper.launches = 0

    engine = ServingEngine(model, params, slots=4, max_len=2048, mode="continuous",
                           temperature=0.0, backend="remote:" + ",".join(w.address for w in workers),
                           model_spec=spec)
    for rid, prompt, max_new in specs:
        require(bool(engine.submit(Request(rid=rid, prompt=prompt, max_new_tokens=max_new))),
                f"request {rid} was shed")
    t0 = time.perf_counter()
    results = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    parent = {name: w.launches for name, w in wrappers.items()}
    per_worker = [on_worker(w.address, LaunchCounts())[0].result for w in workers]

    for rid, _, _ in specs:
        r = results[rid]
        require(r.ok, f"{arch} remote: request {rid} failed: {r.error}")
        require(r.tokens == inline_tokens[rid],
                f"{arch} remote: request {rid} tokens differ from phase 5's inline tokens")
    rep = engine.last_run_report
    spans = rep.coverage
    require(rep.items == len(specs) and spans[0][0] == 0 and spans[-1][1] == len(specs)
            and all(b == c for (_, b), (c, _) in zip(spans, spans[1:])),
            f"{arch} remote: the RunReport does not cover each request exactly once")
    launches = sum(c[kernel] for c in per_worker)
    want = cfg.num_layers * len(specs)
    require(launches == want,
            f"{arch} remote: the workers launched {kernel} {launches} times, not {want}")
    require(not any(parent.values()), f"{arch} remote: the parent launched kernels {parent}")

    # the longest prompt alone, on an otherwise idle card and host: the
    # worker's prefill, the round trip around it, and the same prefill here
    rid, longest, _ = max(specs, key=lambda r: len(r[1]))
    alone = {"remote_round_trip_ms": [], "worker_prefill_ms": [], "inline_prefill_ms": []}
    for _ in range(3):
        rec, round_trip = on_worker(workers[0].address, _RemotePrefill(
            spec, longest, 2048, rid=rid, temperature=0.0, sample_seed=0))
        alone["remote_round_trip_ms"].append(round_trip * 1e3)
        alone["worker_prefill_ms"].append(rec.result[2] * 1e3)
        t0 = time.perf_counter()
        logits, _ = model.prefill(params, torch.as_tensor(longest, device="cuda")[None, :], 2048)
        int(logits.argmax())
        alone["inline_prefill_ms"].append((time.perf_counter() - t0) * 1e3)
    alone = {k: statistics.median(v) for k, v in alone.items()}
    alone["return_ms"] = alone["remote_round_trip_ms"] - alone["worker_prefill_ms"]

    cache_bytes = sum(t.numel() * t.element_size() for c in model.init_caches(1, 2048)
                      for t in vars(c).values())
    tokens = sum(len(r.tokens) for r in results.values())
    ttft = sorted(r.ttft for r in results.values())
    prefill = [results[rid].prefill_seconds * 1e3 for rid, _, _ in specs]
    wire = statistics.mean(rep.wire_latency.values())
    dispatch = statistics.mean(rep.dispatch_latency.values())
    print(f"serve {arch} remote " + json.dumps({
        "workers": len(workers), "warm_s": warm,
        f"{kernel}_launches_per_worker": [c[kernel] for c in per_worker],
        "tokens_equal_inline": True,
        "ttft_p50_ms": statistics.median(ttft) * 1e3, "ttft_max_ms": ttft[-1] * 1e3,
        "prefill_ms_per_request": prefill, "prefill_ms_mean": statistics.mean(prefill),
        "decode_steps": engine.steps,
        "decode_ms_per_step": engine.decode_seconds / max(engine.steps, 1) * 1e3,
        "tokens": tokens, "wall_s": wall, "tokens_per_s": tokens / wall,
        "cache_bytes_per_request": cache_bytes,
        "wire_latency_ms_mean": wire * 1e3, "dispatch_latency_ms_mean": dispatch * 1e3,
        "wire_share_of_dispatch": wire / dispatch,
        f"prompt_{len(longest)}_alone": alone,
    }))
    del engine, results, params
    return kernel, launches


def phase6b_checkpointed_spmm(k3_host, phase2_run_s: float):
    """checkpointed_parallel_for over the row blocks through K3, crash and resume."""
    import numpy as np
    import torch

    from repro_torch.checkpoint import Checkpointer, checkpointed_parallel_for
    from repro_torch.core import HeteroRuntime
    from repro_torch.kernels.spmm.ref import ROW_BLOCK
    from repro_torch.kernels.spmm.spmm import BlockEllArrays, spmm_block_ell

    be, rhs_pad, k3_out = k3_host
    ell = BlockEllArrays(be, "cuda")
    rhs_pad, k3_out = rhs_pad.cuda(), k3_out.cuda()
    n_rb = ell.counts.shape[0]
    out = torch.zeros_like(k3_out)
    per_round = (n_rb + 3) // 4  # checkpointed_parallel_for's default round

    def runtime():
        rt = HeteroRuntime()
        for i in range(4):
            rt.register_unit(f"acc{i}", "acc", backend="cuda")
        return rt

    def k3_rows(chunk):
        a, b = chunk.start, chunk.stop
        out[ROW_BLOCK * a:ROW_BLOCK * b].copy_(spmm_block_ell(ell.row_block_range(a, b), rhs_pad))

    class Crash(RuntimeError):
        pass

    def crashing(chunk):
        if chunk.start >= 2 * per_round:  # the first chunk of round 3
            raise Crash(f"a crash in round 3 at row block {chunk.start}")
        k3_rows(chunk)

    kw = dict(policy="multidynamic", acc_chunk=64)
    root = ROOT / "build"
    root.mkdir(exist_ok=True)
    ckpt_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_", dir=root))
    try:
        spmm_block_ell.launches = 0
        first = Checkpointer(ckpt_dir / "crash")
        try:
            checkpointed_parallel_for(runtime(), crashing, n_rb, checkpointer=first, **kw)
        except Crash:
            pass
        else:
            raise RuntimeError("the crashing run did not crash")
        first.wait_all()
        t0 = time.perf_counter()
        run = checkpointed_parallel_for(runtime(), k3_rows, n_rb,
                                        checkpointer=Checkpointer(ckpt_dir / "crash"), **kw)
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
        launches = spmm_block_ell.launches
        require(run.resumed_from_step == 2 * per_round,
                f"resumed from step {run.resumed_from_step}, not {2 * per_round}")
        require(run.items_run == n_rb - run.resumed_items_done == n_rb - 2 * per_round,
                f"the resumed call ran {run.items_run} row blocks of the "
                f"{n_rb - run.resumed_items_done} the bitmap left")
        require(torch.equal(out, k3_out), "checkpointed SPMM: not bitwise equal to phase 1's K3")
        require(launches > 0, "checkpointed SPMM never launched K3")

        # overhead: an uninterrupted checkpointed run against one plain parallel_for
        times = {"checkpointed": [], "plain": []}
        for i in range(3):
            t0 = time.perf_counter()
            checkpointed_parallel_for(runtime(), k3_rows, n_rb,
                                      checkpointer=Checkpointer(ckpt_dir / f"fresh{i}"), **kw)
            torch.cuda.synchronize()
            times["checkpointed"].append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            runtime().parallel_for(k3_rows, num_items=n_rb, **kw)
            torch.cuda.synchronize()
            times["plain"].append(time.perf_counter() - t0)
        require(torch.equal(out, k3_out), "plain parallel_for SPMM: not bitwise equal to K3")
        bitmap = np.zeros(n_rb, dtype=bool)
        write_ms = [Checkpointer(ckpt_dir / "timing").save(i, {"coverage_done": bitmap},
                                                            blocking=True).wait().wall_time * 1e3
                    for i in range(5)]
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    ck, plain = statistics.median(times["checkpointed"]), statistics.median(times["plain"])
    print("spmm_checkpointed " + json.dumps({
        "row_blocks": n_rb, "rounds_per_fresh_run": 4, "crash_in_round": 3,
        "resumed_from_step": run.resumed_from_step, "resumed_items_done": run.resumed_items_done,
        "items_run_after_resume": run.items_run, "resume_rounds": run.rounds,
        "resume_s": resume_s, "k3_launches": launches,
        "checkpointed_run_s": times["checkpointed"], "plain_parallel_for_s": times["plain"],
        "overhead_vs_plain_s": ck - plain, "overhead_vs_plain": ck / plain - 1.0,
        "phase2_run_s": phase2_run_s, "checkpointed_over_phase2_run": ck / phase2_run_s,
        "checkpoint_write_ms": write_ms,
    }))
    return launches


def phase6c_fleet():
    """A FleetManager's cuda-hosting workers; one freezes mid-run."""
    from repro_torch.core import FleetManager, HeteroRuntime
    from repro_torch.core.transport import SleepWork, spawn_worker

    heartbeat, patience, items = 0.1, 3, 1000
    rt = HeteroRuntime()
    with FleetManager(rt, heartbeat=heartbeat, patience=patience,
                      spawn=lambda: spawn_worker(startup_timeout=120.0)) as fm:
        fm.scale_to(2)
        work = SleepWork(1e-3)
        # a first run opens each worker's CUDA context outside the timed one
        rep = rt.parallel_for(work, num_items=40, policy="multidynamic", acc_chunk=8)
        require(rep.items == 40, "fleet warm-up run did not cover its items")
        victim = fm.members[-1]
        pid = fm.handle(victim).proc.pid
        stopped = {}

        def freeze():
            stopped["t"] = time.perf_counter()
            os.kill(pid, signal.SIGSTOP)

        timer = threading.Timer(0.25, freeze)
        timer.start()
        try:
            rep = rt.parallel_for(work, num_items=items, policy="multidynamic", acc_chunk=8)
        finally:
            timer.cancel()
        t_end = time.perf_counter()
        require("t" in stopped, "the run ended before the worker was frozen")
        fm.kill_unit(victim)
        require(fm.reap() == [victim], "the killed worker was not reaped")
    spans = rep.coverage
    require(rep.items == items and spans[0][0] == 0 and spans[-1][1] == items
            and all(b == c for (_, b), (c, _) in zip(spans, spans[1:])),
            "fleet run: coverage is not exact-once")
    losses = [e for e in (rep.events or []) if e["action"] in ("lost", "dead")]
    require(len(losses) == 1 and losses[0]["unit"] == victim and losses[0]["action"] == "dead",
            f"the frozen worker was not convicted by heartbeat: {losses}")
    conviction_s = (t_end - rep.wall_time + losses[0]["t"]) - stopped["t"]
    print("fleet " + json.dumps({
        "workers": 2, "hosted": "cuda", "heartbeat_s": heartbeat, "patience": patience,
        "items": items, "victim": victim, "event": losses[0],
        "time_to_conviction_s": conviction_s, "wall_s": rep.wall_time,
        "per_worker_items": rep.per_worker_items,
    }))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _map_leaves(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_leaves(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_leaves(v, fn) for v in tree]
    return fn(tree)



@contextlib.contextmanager
def _observing(module: str, name: str, observe):
    """Calls ``observe(args, kwargs, result)`` after every call of
    ``repro_torch.<module>.<name>`` made inside the block, and fails
    unless there was one (a caller that bound the function itself would
    bypass the observer)."""
    import importlib

    mod = importlib.import_module(f"repro_torch.{module}")
    fn = getattr(mod, name)
    calls = [0]

    def observed(*args, **kw):
        out = fn(*args, **kw)
        observe(args, kw, out)
        calls[0] += 1
        return out

    setattr(mod, name, observed)
    try:
        yield
    finally:
        setattr(mod, name, fn)
    require(calls[0] > 0, f"{module}.{name} was not called through the module inside the block")


def _top_k_margin(args, _routing):
    """The smallest gap between a token's k-th and (k+1)-th router
    probability in one routing: a greedy-token mismatch with a margin near
    float32 rounding is a near-tie, not a fault."""
    import torch

    logits, k = args[0], args[1]
    top = torch.topk(torch.softmax(logits.float(), dim=-1), k + 1, dim=-1).values
    return (top[:, k - 1] - top[:, k]).min()


def profile_train_step(fn, kernel_names, backward_names) -> dict:
    """Device time of one call of ``fn`` (a train step): the CUDA kernels'
    total and top 10, the share in the kernel's forward launches (kernels
    whose names hold one of ``kernel_names``) and the share in its backward
    kernels (names holding one of ``backward_names``; K5's backward also
    reruns the forward's state and pass kernels, which count under the
    forward's names)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = _kernel_rows(prof)
    total = sum(r[0] for r in rows)
    kernel_us = sum(us for us, key, _ in rows if any(n in key for n in kernel_names))
    backward = [(us, key, c) for us, key, c in rows if any(n in key for n in backward_names)]
    backward_us = sum(us for us, _, _ in backward)
    share = (lambda us: us / total) if total else (lambda us: None)  # no device time traced
    return {"device_ms_total": total / 1e3,
            "kernel_ms": kernel_us / 1e3, "kernel_share": share(kernel_us),
            "backward_kernel_ms": backward_us / 1e3, "backward_kernel_share": share(backward_us),
            "backward_kernels": [{"name": k[:90], "calls": c, "device_ms": us / 1e3,
                                  "share": share(us)} for us, k, c in backward],
            "top10": [{"name": k[:80], "calls": c, "device_ms": us / 1e3}
                      for us, k, c in rows[:10]]}


def grads_within(name: str, got, want) -> float:
    """Every gradient leaf of ``got`` within GRAD_REL × the largest |g| of
    ``want``; returns the largest difference over that largest |g|."""
    gmax = max(float(g.abs().max()) for g in _leaves(want))
    worst = max(float((a.float() - b.float()).abs().max()) for a, b in zip(_leaves(got),
                                                                            _leaves(want)))
    require(worst <= GRAD_REL * gmax, f"{name}: a gradient differs by {worst:.3e}, beyond "
            f"{GRAD_REL} x the largest |g| {gmax:.3e}")
    print(f"{name}: max |dg| {worst:.3e} = {worst / gmax:.3e} of the largest |g| {gmax:.3e}")
    return worst / gmax


def train_function_ms(kernel: str) -> dict:
    """K4's or K5's ``Function``, forward + backward, at phase 7's training
    microbatch (B 4, S 2048; K4 bf16 with tinyllama's heads, K5 f32 at
    mamba2's), against autograd of its plain version and, for K4, against
    ``scaled_dot_product_attention``'s forward + backward (a comparison only)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention, flash_attention_plain,
    )
    from repro_torch.kernels.ssd_scan import ops as sops
    from repro_torch.kernels.ssd_scan.ssd_scan import ssd_scan, ssd_scan_plain

    rng = np.random.default_rng(7)

    def normal(*shape, scale=1.0, dtype=torch.float32):
        return torch.from_numpy(scale * rng.standard_normal(shape, dtype=np.float32)).to(
            "cuda", dtype).requires_grad_()

    def fwd_bwd(fn, inputs, weights):
        def run():
            outs = fn(*inputs)
            outs = outs if isinstance(outs, tuple) else (outs,)
            torch.autograd.grad(outs, inputs, weights)
        return run

    if kernel == "flash_attention":
        b, s, h, kvh, d = 4, 2048, 32, 4, 64
        q, k, v = (normal(b, s, n, d, dtype=torch.bfloat16) for n in (h, kvh, kvh))
        gy = normal(b, s, h, d, dtype=torch.bfloat16).detach()
        qt, kt, vt = (x.detach().transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
        out = dict(shape=f"B={b} S={s} H={h} KVH={kvh} D={d} causal bfloat16",
                   fwd_bwd_ms=time_ms(fwd_bwd(flash_attention, (q, k, v), (gy,))),
                   plain_fwd_bwd_ms=time_ms(fwd_bwd(flash_attention_plain, (q, k, v), (gy,)),
                                            reps=5),
                   library_fwd_bwd_ms=time_ms(fwd_bwd(
                       lambda *x: F.scaled_dot_product_attention(*x, is_causal=True,
                                                                 enable_gqa=True),
                       (qt, kt, vt), (gy.transpose(1, 2).contiguous(),))))
        # forward and backward products (the backward about 2.5x the forward's);
        # q, k, v, dO read and O, dQ, dK, dV written, each once
        out["bound_ms"], out["bound_by"] = bound_ms(
            fops.kernel_hbm_bytes(b, s, s, h, kvh, d, bytes_per_el=2, backward=True),
            fops.kernel_flops(b, s, s, h, d, causal=True, backward=True), bf16=True)
    else:
        b, s, h, p, n, chunk = 4, 2048, 24, 64, 128, 256
        x = normal(b, s, h, p)
        log_a = torch.from_numpy(-0.2 * rng.random((b, s, h), np.float32)).cuda().requires_grad_()
        bm, cm = normal(b, s, n, scale=0.3), normal(b, s, n, scale=0.3)
        gy, gh = normal(b, s, h, p).detach(), normal(b, h, p, n).detach()
        out = dict(shape=f"B={b} S={s} H={h} P={p} N={n} chunk={chunk} float32",
                   fwd_bwd_ms=time_ms(fwd_bwd(lambda *a: ssd_scan(*a, chunk=chunk),
                                              (x, log_a, bm, cm), (gy, gh))),
                   plain_fwd_bwd_ms=time_ms(fwd_bwd(lambda *a: ssd_scan_plain(*a, chunk=chunk),
                                                    (x, log_a, bm, cm), (gy, gh)), reps=5),
                   library_fwd_bwd_ms=None)
        # the forward's bytes, then x, log_a, B, C, dy, dh read and dx, dlog_a,
        # dB, dC written; the backward's products about 2.5x the forward's
        inputs = 4 * (b * s * h * p + b * s * h + 2 * b * s * n)
        out["bound_ms"], out["bound_by"] = bound_ms(
            sops.kernel_hbm_bytes(b, s, h, p, n) + 2 * inputs + 4 * (b * s * h * p + b * h * p * n),
            3.5 * sops.kernel_flops(b, s, h, p, n))
    print(f"{kernel} Function forward + backward " + json.dumps(out))
    return out


def plain_training_witness(arch: str, kernel_losses, kernel_refit: float, wrappers: dict,
                           batch_of) -> None:
    """The run's steps again with ``plain=True`` (no kernel on the path):
    the same initial parameters, batches, optimizer and step as
    ``run_training``'s; prints both runs' losses side by side, and step 0's
    batch scored after each run."""
    import math

    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import make_model
    from repro_torch.optim import AdamW
    from repro_torch.parallel.mesh_rules import MeshRules, MeshShape

    cfg = get_config(arch)
    gb, seq, mb, steps = (TRAIN_RUN[k] for k in ("global_batch", "seq_len", "microbatches",
                                                   "steps"))
    before = {name: w.launches for name, w in wrappers.items()}
    model = make_model(cfg, device="cuda", plain=True)
    opt = AdamW(state_dtype=torch.bfloat16 if cfg.parallel.opt_state_dtype == "bfloat16"
                else torch.float32, cfg=cfg)
    params = model.init(0)
    state = opt.init(params)
    step_fn = make_train_step(model, opt, MeshRules(MeshShape((1, 1), ("data", "model")),
                                                    cfg.parallel),
                              InputShape("train", seq, gb, "train"), lr=TRAIN_RUN["lr"],
                              loss_chunk=0, microbatches=mb)
    losses = []
    for step in range(steps):
        params, state, metrics = step_fn(params, state, batch_of(step, gb))
        losses.append(float(metrics["loss"]))
    with torch.no_grad():
        refit = float(model.loss_fn(params, batch_of(0, gb), loss_chunk=0)[0])
    require(all(math.isfinite(loss) for loss in losses), f"{arch} plain: a loss is not finite")
    launched = {name: w.launches - before[name] for name, w in wrappers.items()
                if w.launches != before[name]}
    require(not launched, f"{arch} plain: kernels launched {launched}")
    print(f"train {arch} plain witness " + json.dumps({
        "losses_kernels": kernel_losses, "losses_plain": losses,
        "max_abs_loss_diff": max(abs(a - b) for a, b in zip(kernel_losses, losses)),
        "final_minus_first_kernels": kernel_losses[-1] - kernel_losses[0],
        "final_minus_first_plain": losses[-1] - losses[0],
        "step0_batch_loss_after_run_kernels": kernel_refit,
        "step0_batch_loss_after_run_plain": refit}))
    del model, params, state, step_fn


def f32_parity_step(arch: str, cfg, params32, rules, batch_of) -> dict:
    """Phase 7's float32 step at full width from ``params32`` (the model's
    parameters in f32; released here): through the kernels and with
    ``plain=True`` on a PARITY_BATCH x 2048 batch, loss within 1e-5,
    ``grad_norm`` within 1e-4, every gradient within GRAD_REL of the tree's
    largest |g|, and 2 microbatches against 1 at the same measures.
    Prints and returns the readings."""
    import gc

    import torch

    from repro_torch.configs.base import InputShape
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import make_model
    from repro_torch.optim import AdamW, global_norm

    seq = TRAIN_RUN["seq_len"]
    gc.collect()
    torch.cuda.empty_cache()
    cfg32 = cfg.replace(dtype="float32", param_dtype="float32")
    opt32 = AdamW(cfg=cfg32)
    shape32 = InputShape("parity", seq, PARITY_BATCH, "train")
    batch = batch_of(100, PARITY_BATCH)
    results, step_s = {}, {}
    for plain in (False, True):
        step32 = make_train_step(make_model(cfg32, device="cuda", plain=plain), opt32, rules,
                                 shape32, lr=TRAIN_RUN["lr"], loss_chunk=0, microbatches=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grads, metrics = step32.grads(params32, batch)
        torch.cuda.synchronize()
        step_s["plain" if plain else "kernels"] = time.perf_counter() - t0  # its first call
        metrics = dict(metrics, grad_norm=global_norm(grads))  # the step's, before clipping
        results[plain] = (grads, {k: float(v) for k, v in metrics.items()})
        del grads, step32
    (gk, mk), (gp, mp) = results[False], results[True]
    del results
    require(abs(mk["loss"] - mp["loss"]) <= 1e-5 * abs(mp["loss"]),
            f"{arch} f32: loss {mk['loss']} through the kernels, {mp['loss']} plain")
    require(abs(mk["grad_norm"] - mp["grad_norm"]) <= 1e-4 * abs(mp["grad_norm"]),
            f"{arch} f32: grad_norm {mk['grad_norm']} through the kernels, {mp['grad_norm']} plain")
    vs_plain = grads_within(f"{arch} f32 train step gradients, kernels vs plain", gk, gp)
    del gp
    step2 = make_train_step(make_model(cfg32, device="cuda"), opt32, rules, shape32,
                            lr=TRAIN_RUN["lr"], loss_chunk=0, microbatches=2)
    g2, m2 = step2.grads(params32, batch)
    vs_mb = grads_within(f"{arch} f32 gradients, 2 microbatches vs 1", g2, gk)
    require(abs(float(global_norm(g2)) - mk["grad_norm"]) <= 1e-4 * mk["grad_norm"],
            f"{arch} f32: 2 microbatches give grad_norm {float(global_norm(g2))}, not "
            f"{mk['grad_norm']}")
    out = {"batch": f"{PARITY_BATCH} x {seq}", "layers": cfg.num_layers, "kernels": mk,
           "plain": mp, "loss_rel_diff": abs(mk["loss"] - mp["loss"]) / abs(mp["loss"]),
           "grad_norm_rel_diff": abs(mk["grad_norm"] - mp["grad_norm"]) / mp["grad_norm"],
           "grads_max_diff_over_max_g": vs_plain, "microbatches_2_vs_1_max_diff_over_max_g": vs_mb,
           "loss_2_microbatches": float(m2["loss"]), "grads_s_first_call": step_s,
           "peak_mem_GB": torch.cuda.max_memory_allocated() / 1e9}
    print(f"train {arch} f32 parity " + json.dumps(out))
    del params32, gk, g2, step2, batch
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase7_training(arch: str, wrappers: dict, card: str, keep=None, *, layers: int = 0,
                    steps: int = TRAIN_RUN["steps"], resume: bool = True):
    """Train one model at full width through ``run_training`` (on its (1, 1)
    mesh) and check it: finite losses, no plain version called, the kernel
    and its backward launched per layer, microbatch and step; the step's
    median ms, one profiled step, and the float32 parity step.  ``layers``
    cuts the depth (0: the config's; the cut printed under ``reduced``).
    With ``resume`` the run checkpoints at step ``ckpt_every`` and its end,
    step 0's batch must score lower with its last checkpoint, and a second
    run resumes from step ``ckpt_every``; ``keep``: a directory that
    receives the run's checkpoint of step ``ckpt_every``.  Returns ({kernel:
    launches, backward kernel: launches, and the wide forward's where it
    ran} of the run, the resumed run's losses or None, the run's readings)."""
    import dataclasses
    import gc
    import math

    import torch

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.data import SyntheticTokens
    from repro_torch.launch.mesh import H100_SXM
    from repro_torch.launch.steps import default_microbatches, make_train_step
    from repro_torch.launch.train import TrainLoopConfig, run_training
    from repro_torch.models import make_model
    from repro_torch.models.transformer import layer_kinds
    from repro_torch.optim import AdamW
    from repro_torch.parallel.mesh_rules import MeshRules, MeshShape

    full = get_config(arch)
    cfg = full.replace(num_layers=layers) if layers else full
    kernel = "ssd_scan" if cfg.family == "ssm" else "flash_attention"
    kernel_names = ("ssd_state_kernel", "ssd_pass_kernel", "ssd_output_kernel") \
        if kernel == "ssd_scan" else ("flash_fwd",)
    backward_names = ("ssd_dpass_kernel", "ssd_bwd_kernel", "ssd_bwd_bc_kernel") \
        if kernel == "ssd_scan" else ("flash_bwd",)
    backward = f"{kernel}_backward"
    kernel_layers = sum(kind in KERNEL_KINDS[kernel] for kind in layer_kinds(cfg))
    gb, seq, mb = (TRAIN_RUN[k] for k in ("global_batch", "seq_len", "microbatches"))
    shape = InputShape("train", seq, gb, "train")
    rules = MeshRules(MeshShape((1, 1), ("data", "model")), cfg.parallel)
    require(default_microbatches(cfg, shape, rules) == mb, f"{arch}: default_microbatches "
            f"gives {default_microbatches(cfg, shape, rules)}, not {mb}")
    model = make_model(cfg, device="cuda")
    source = SyntheticTokens(cfg.padded_vocab, seq, seed=0)   # run_training's, at seed 0

    def batch_of(step: int, rows: int):
        b = source.batch(step, shard=0, num_shards=1, per_shard=rows)
        return {k: torch.from_numpy(getattr(b, k)).cuda() for k in ("tokens", "labels", "mask")}

    root = ROOT / "build"
    root.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_train_", dir=root))
    rest = None
    try:
        # -- the run: with ``resume``, checkpoints at steps 3 and 6 -------------
        run = TrainLoopConfig(arch=arch, smoke=False, layers=layers, device="cuda",
                              ckpt_dir=str(tmp / "run") if resume else None, log_every=1,
                              **dict(TRAIN_RUN, steps=steps))
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for w in wrappers.values():
            w.launches = 0
        plain_calls = {}
        t0 = time.perf_counter()
        with counting_plain_calls(plain_calls):
            whole = run_training(run)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: w.launches for name, w in wrappers.items()}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        require(whole["steps"] == len(whole["losses"]) == steps,
                f"{arch}: the run took {whole['steps']} steps, not {steps}")
        require(all(math.isfinite(loss) for loss in whole["losses"]),
                f"{arch}: a loss is not finite")
        refit_loss = None
        if resume:
            # the loss falls: step 0's batch scores lower with the trained
            # parameters (the last step's checkpoint) than with the initial ones
            trained = Checkpointer(tmp / "run").restore(steps, (model.init(run.seed),))[0][0]
            with torch.no_grad():
                refit_loss = float(model.loss_fn(
                    _map_leaves(trained, lambda t: t.cuda()), batch_of(0, gb), loss_chunk=0)[0])
            del trained
            require(refit_loss < whole["first_loss"], f"{arch}: step 0's batch scores "
                    f"{refit_loss} after the run, not below its first loss {whole['first_loss']}")
        if arch in FRESH_BATCH_LOSS_FALLS:
            require(whole["final_loss"] < whole["first_loss"], f"{arch}: the loss did not "
                    f"fall ({whole['first_loss']} -> {whole['final_loss']})")
        # each layer that holds the kernel launches it twice per microbatch
        # and step: in the forward, and again when remat recomputes its unit
        # (one layer) in the backward; its backward kernel once.  tinyllama:
        # 2 x 22 x 2 x 6 = 528 and 264; mamba2: 2 x 24 x 2 x 6 = 576 and 288;
        # stablelm-12b at 4 layers and 4 steps: 64 and 32
        want = 2 * kernel_layers * mb * steps
        require(launches[kernel] == want,
                f"{arch}: {kernel} launched {launches[kernel]} times in training, not 2 x "
                f"{kernel_layers} layers x {mb} microbatches x {steps} steps = {want}")
        require(launches[backward] == want // 2,
                f"{arch}: {backward} launched {launches[backward]} times in training, not "
                f"{kernel_layers} layers x {mb} microbatches x {steps} steps = {want // 2}")
        counts = {kernel: want, backward: want // 2, **wide_share(cfg, want)}
        wide = counts["flash_attention_wide"]
        require(launches["flash_attention_wide"] == wide, f"{arch}: flash_attention_wide "
                f"launched {launches['flash_attention_wide']} times in training, not {wide}")
        others = {k: v for k, v in launches.items() if k not in counts and v}
        require(not others, f"{arch}: unexpected launches in training {others}")
        counts = {k: n for k, n in counts.items() if n}

        if resume:
            # -- resume from step ckpt_every: the steps after it again ---------
            # the last checkpoint goes, as if the run had stopped before
            # writing it (tinyllama's take 11 GB each: bf16 parameters, f32
            # moments), and the resumed run writes none
            shutil.rmtree(tmp / "run" / f"step_{steps:08d}")
            t0 = time.perf_counter()
            with counting_plain_calls(plain_calls):
                rest = run_training(dataclasses.replace(run, resume=True,
                                                        ckpt_every=10 * steps))
            resume_wall = time.perf_counter() - t0
            start = TRAIN_RUN["ckpt_every"]
            require(rest["steps"] == len(rest["losses"]) == steps - start,
                    f"{arch}: the resumed run took {rest['steps']} steps, not {steps - start}")
            resume_rel = abs(rest["final_loss"] - whole["final_loss"]) / abs(whole["final_loss"])
            require(resume_rel <= 1e-2, f"{arch}: the resumed run's final loss "
                    f"{rest['final_loss']} is not within 1e-2 of the uninterrupted run's "
                    f"{whole['final_loss']}")
            if keep is not None:
                shutil.move(tmp / "run", keep)
        # no plain version ran in a training step of either run: the backward
        # is the kernels'
        require(not any(plain_calls.values()),
                f"{arch}: plain versions called in training on the card: {plain_calls}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    if resume and arch not in FRESH_BATCH_LOSS_FALLS:
        plain_training_witness(arch, whole["losses"], refit_loss, wrappers, batch_of)

    # -- the step's time: the resumed run's steps after its first two (no
    # checkpoint is written then), else the run's after its first; its
    # profile: one more step outside the run
    params = model.init(0)
    opt = AdamW(state_dtype=torch.bfloat16 if cfg.parallel.opt_state_dtype == "bfloat16"
                else torch.float32, cfg=cfg)
    state = opt.init(params)
    step_fn = make_train_step(model, opt, rules, shape, lr=TRAIN_RUN["lr"], loss_chunk=0,
                              microbatches=mb)
    batch = batch_of(0, gb)
    step_s = statistics.median(rest["step_seconds"][2:] if resume else whole["step_seconds"][1:])
    n_active = cfg.active_param_count()
    prof_holder = {}

    def one_step():
        prof_holder["out"] = step_fn(params, state, batch)

    prof = profile_train_step(one_step, kernel_names, backward_names)
    del prof_holder
    summary = {
        "arch": arch, "layers": cfg.num_layers,
        "reduced": {"num_layers": [full.num_layers, layers]} if layers else {},
        "d_model": cfg.d_model, "head_dim": cfg.head_dim,
        "params_B": sum(t.numel() for t in _leaves(params)) / 1e9,
        "active_param_count": n_active, "global_batch": gb, "seq_len": seq, "microbatches": mb,
        "steps": steps, "losses": whole["losses"],
        "first_loss": whole["first_loss"], "final_loss": whole["final_loss"],
        **{f"{name}_launches": n for name, n in counts.items()},
        "plain_version_calls": plain_calls, "run_wall_s": wall,
        "run_mean_tok_per_s": whole["mean_tok_per_s"], "peak_mem_GB": peak_gb,
        "held_bytes": whole["held_bytes"],
        "step_ms_each": [t * 1e3 for t in whole["step_seconds"]],
        "tokens_per_s": gb * seq / step_s,
        "model_flops_share": 6 * n_active * gb * seq / step_s / H100_SXM.peak_flops,
        "card": card,
    }
    if resume:
        summary.update({
            "step0_batch_loss_after_run": refit_loss,
            "resumed_final_loss": rest["final_loss"], "resume_rel_diff": resume_rel,
            "resumed_run_wall_s": resume_wall,
            "resumed_step_ms_each": [t * 1e3 for t in rest["step_seconds"]],
            "step_ms_median_after_2": step_s * 1e3})
    else:
        summary["step_ms_median_after_1"] = step_s * 1e3
    label = f"{arch} ({layers} of {full.num_layers} layers)" if layers else arch
    print(f"train {label} " + json.dumps(summary))
    print(f"profile {label} train step ({gb} x {seq}, {mb} microbatches) " + json.dumps(prof))

    # -- float32 at full width: kernels against plain, 1 against 2 microbatches
    params32 = _map_leaves(params, lambda t: t.float())
    del model, params, state, step_fn, batch
    for w in wrappers.values():
        w.launches = 0
    f32_parity_step(arch, cfg, params32, rules, batch_of)
    if kernel == "flash_attention":  # K4's f32 kernels ran the kernels' steps, and only they
        f32 = {k: wrappers[k].launches for k in ("flash_attention_f32",
                                                 "flash_attention_f32_backward")}
        require(0 < f32["flash_attention_f32"] == wrappers["flash_attention"].launches and
                0 < f32["flash_attention_f32_backward"] ==
                wrappers["flash_attention_backward"].launches,
                f"{arch} f32 parity: launches {f32}, K4 {wrappers['flash_attention'].launches} "
                f"and its backward {wrappers['flash_attention_backward'].launches}")
        counts.update(f32)
    del params32
    gc.collect()
    torch.cuda.empty_cache()
    return counts, rest["losses"] if resume else None, summary


# phase 8: the distribution layer (slice F1) with two ranks on the one card.
# NCCL refuses two ranks on one device, so they share gloo (its send and
# recv of CUDA tensors, the pipeline's hand-offs, are staged through host
# buffers in parallel/collectives.py, which counts the bytes)
DIST_RANKS = 2
# 8a: phase 7's mamba2 run resumed at its checkpoint (step 3) on a (2, 1)
# mesh: steps 3-5
DIST_TRAIN = dict(arch="mamba2-130m", from_step=TRAIN_RUN["ckpt_every"], loss_atol=5e-3)
# 8b: tinyllama's 22 layers in 2 GPipe stages, 4 microbatches of 1 x 2048, bf16
PIPELINE = dict(arch="tinyllama-1.1b", microbatches=4, rows=1, seq=2048)
# 8c: tinyllama at published widths cut to 2 layers, float32, batch 4 x 512
DIST_PARITY = dict(arch="tinyllama-1.1b", layers=2, batch=4, seq=512, psum_rel=0.02)


def _phase8a(rank: int, mesh, plan: dict) -> dict:
    """Restore phase 7's checkpoint onto the mesh and train the steps after it."""
    import torch

    from repro_torch.checkpoint import Checkpointer, elastic_restore_summary, reshard_tree
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.core.elastic import ElasticMeshManager
    from repro_torch.data import SyntheticTokens
    from repro_torch.launch.steps import default_microbatches, make_train_step
    from repro_torch.launch.train import TrainLoopConfig, run_training
    from repro_torch.models import make_model
    from repro_torch.models.transformer import layer_kinds
    from repro_torch.optim import AdamW
    from repro_torch.parallel.mesh_rules import MeshRules, axes_leaves

    arch, device, start = DIST_TRAIN["arch"], plan["device"], DIST_TRAIN["from_step"]
    cfg = get_config(arch)
    cfg = cfg.smoke() if plan["smoke"] else cfg
    gb, seq, steps, lr = (plan["train"][k] for k in ("global_batch", "seq_len", "steps", "lr"))
    model = make_model(cfg, device=device)
    rules = MeshRules(mesh, cfg.parallel)
    shape = InputShape("train", seq, gb, "train")
    mb = default_microbatches(cfg, shape, rules)
    require(mb == 1, f"8a: default_microbatches gives {mb} with dp 2, not 1")
    opt = AdamW(state_dtype=torch.bfloat16 if cfg.parallel.opt_state_dtype == "bfloat16"
                else torch.float32, cfg=cfg)
    params = model.init(0)
    like = (params, tuple(opt.init(params)))
    (host_p, (_, host_mu, host_nu)), step = Checkpointer(plan["ckpt"]).restore(None, like)
    require(step == start, f"8a: the checkpoint is step {step}, not {start}")
    # each rank's shards are its slices of the saved arrays, bitwise
    specs, coords, sharded = model.param_specs(), rules.coordinate(), 0
    for tree in (host_p, host_mu, host_nu):
        shards = reshard_tree(tree, specs, rules, device=device)
        for axes, full, part in zip(axes_leaves(specs), _leaves(tree), _leaves(shards)):
            index = rules.local_slice(rules.spec(axes, tuple(full.shape)), tuple(full.shape),
                                      coords)
            require(torch.equal(part.cpu(), full[index]), f"8a: a shard of {axes} differs")
            sharded += part.numel() < full.numel()
        del shards
    del host_p, host_mu, host_nu, like
    manager = ElasticMeshManager((DIST_RANKS, 1), ("data", "model"), host_size=1)
    manager.mark_failed(DIST_RANKS - 1)
    summary = elastic_restore_summary(manager.plan(), old_lr=lr)

    wrappers = model_wrappers()
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.reset_peak_memory_stats() if device == "cuda" else None
    t0 = time.perf_counter()
    run = run_training(TrainLoopConfig(arch=arch, smoke=plan["smoke"], device=device,
                                       ckpt_dir=plan["ckpt"], resume=True, steps=steps,
                                       global_batch=gb, seq_len=seq, microbatches=mb, lr=lr,
                                       ckpt_every=100 * steps, log_every=1), mesh=mesh)
    wall = time.perf_counter() - t0
    launches = {name: w.launches for name, w in wrappers.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if device == "cuda" else None
    require(run["steps"] == steps - start, f"8a: {run['steps']} steps, not {steps - start}")
    diffs = [abs(a - b) for a, b in zip(run["losses"], plan["want_losses"])]
    require(len(diffs) == steps - start and max(diffs) <= DIST_TRAIN["loss_atol"],
            f"8a: losses {run['losses']} not within {DIST_TRAIN['loss_atol']} of the one-rank "
            f"resumed run's {plan['want_losses']}")
    kernel_layers = sum(kind == "ssd" for kind in layer_kinds(cfg))
    want = 2 * kernel_layers * mb * (steps - start)   # forward and remat, a layer and step
    if device == "cuda":
        require(launches == dict(ssd_scan=want, ssd_scan_backward=want // 2, flash_attention=0,
                                 flash_attention_wide=0, flash_attention_backward=0,
                                 flash_attention_f32=0, flash_attention_f32_backward=0),
                f"8a rank {rank}: launches {launches}, not ssd_scan {want} and its backward "
                f"{want // 2}")

    # one step outside the run: its time and the bytes its collectives move
    step_fn = make_train_step(model, opt, rules, shape, lr=lr, loss_chunk=0, microbatches=mb)
    shards = step_fn.shard(model.init(0))
    state = opt.init(shards)
    b = SyntheticTokens(cfg.padded_vocab, seq, seed=0).batch(start, shard=0, num_shards=1,
                                                             per_shard=gb)
    batch = {k: torch.from_numpy(getattr(b, k)).to(device) for k in ("tokens", "labels", "mask")}
    step_fn(shards, state, batch)                      # warm-up
    sent, staged = step_fn.group.sent_bytes, step_fn.group.staged_bytes
    _sync(device)
    t0 = time.perf_counter()
    step_fn(shards, state, batch)
    _sync(device)
    step_ms = (time.perf_counter() - t0) * 1e3
    return dict(arch=arch, sharded_leaves=sharded, restore_summary=summary, microbatches=mb,
                losses=run["losses"], one_rank_losses=plan["want_losses"],
                max_abs_loss_diff=max(diffs), run_step_ms=[t * 1e3 for t in run["step_seconds"]],
                run_wall_s=wall, launches=launches, peak_mem_GB=peak_gb,
                step_ms=step_ms, sent_bytes_per_step=step_fn.group.sent_bytes - sent,
                staged_bytes_per_step=step_fn.group.staged_bytes - staged)


def _phase8b(rank: int, plan: dict) -> dict:
    """tinyllama's layers in GPipe stages, against the same blocks in order."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.flash_attention import flash_attention
    from repro_torch.models import make_model
    from repro_torch.models.transformer import _apply_block, layer_kinds
    from repro_torch.parallel import Group, pipeline_apply, stage_partition

    device = plan["device"]
    cfg = get_config(PIPELINE["arch"])
    cfg = cfg.smoke() if plan["smoke"] else cfg
    n_micro, rows = PIPELINE["microbatches"], PIPELINE["rows"]
    seq = plan["pipeline_seq"]
    group = Group()
    lo, hi = stage_partition(cfg.num_layers, group.size)[group.rank]
    require(set(layer_kinds(cfg)) == {"attn"}, "8b: a model of attn blocks only")
    params = make_model(cfg, device=device).init(0)     # every rank draws the whole tree
    tokens = np.random.default_rng(11).integers(0, cfg.vocab_size, (n_micro, rows, seq))

    def layer_fn(p, x):
        return _apply_block("attn", p, x, cfg, mode="train", positions=None, cache=None,
                            image_embeds=None, plain=False)[0]

    with torch.no_grad():
        x = params["embed"][torch.from_numpy(tokens).to(device)]
        flash_attention.launches = 0
        _sync(device)
        t0 = time.perf_counter()
        out = pipeline_apply(params["layers"][lo:hi], x, layer_fn, group)
        _sync(device)
        pipe_ms = (time.perf_counter() - t0) * 1e3
        launches = flash_attention.launches
        if device == "cuda":
            require(launches == (hi - lo) * n_micro,
                    f"8b stage {group.rank}: K4 launched {launches}, not {(hi - lo) * n_micro}")
        result = dict(arch=cfg.name, stage=group.rank, layers=[lo, hi], microbatches=n_micro,
                      shape=list(x.shape[1:]), dtype=str(x.dtype), k4_launches=launches,
                      pipeline_ms=pipe_ms, sent_bytes=group.sent_bytes,
                      staged_bytes=group.staged_bytes)
        if group.rank == 0:       # the same blocks applied in order on one rank
            _sync(device)
            t0 = time.perf_counter()
            want = []
            for m in range(n_micro):
                y = x[m]
                for p in params["layers"]:
                    y = layer_fn(p, y)
                want.append(y)
            want = torch.stack(want)
            _sync(device)
            result["sequential_ms"] = (time.perf_counter() - t0) * 1e3
            result["max_abs_err"] = compare("8b GPipe vs the layers in order", out.float(),
                                            want.float(), attn_tol("bfloat16", want))
            result["bitwise"] = bool(torch.equal(out, want))
    return result


def _phase8c(rank: int, mesh, plan: dict) -> dict:
    """f32 parity of the two-rank step at a cut depth, and compressed_psum."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.data import SyntheticTokens
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import make_model
    from repro_torch.optim import AdamW, global_norm
    from repro_torch.parallel import Group, MeshRules, MeshShape, compressed_psum_tree

    device = plan["device"]
    cfg = get_config(DIST_PARITY["arch"])
    cfg = (cfg.smoke() if plan["smoke"] else cfg).replace(
        num_layers=DIST_PARITY["layers"], dtype="float32", param_dtype="float32")
    rows, seq = DIST_PARITY["batch"], plan["parity_seq"]
    model = make_model(cfg, device=device)
    params = model.init(0)
    opt = AdamW(cfg=cfg)
    shape = InputShape("parity", seq, rows, "train")
    b = SyntheticTokens(cfg.padded_vocab, seq, seed=0).batch(100, shard=0, num_shards=1,
                                                             per_shard=rows)
    batch = {k: torch.from_numpy(getattr(b, k)).to(device) for k in ("tokens", "labels", "mask")}
    lr = plan["train"]["lr"]
    two = make_train_step(model, opt, MeshRules(mesh, cfg.parallel), shape, lr=lr,
                          loss_chunk=0, microbatches=1)
    shards = two.shard(params)
    wrappers = model_wrappers()
    for w in wrappers.values():
        w.launches = 0
    grads, metrics = two.grads(shards, batch)
    launches = {k: w.launches for k, w in wrappers.items()}
    if device == "cuda":   # the forward, remat's replay and the backward, a layer, all f32
        require(launches["flash_attention"] == launches["flash_attention_f32"] ==
                2 * cfg.num_layers and
                launches["flash_attention_backward"] == launches["flash_attention_f32_backward"] ==
                cfg.num_layers, f"8c rank {rank}: launches {launches}")
    metrics = {k: float(v) for k, v in dict(metrics, grad_norm=two.global_norm(grads)).items()}
    grads = two.gather(grads)
    one_rules = MeshRules(MeshShape((1, 1), ("data", "model")), cfg.parallel)
    result = dict(arch=cfg.name, layers=cfg.num_layers, batch=f"{rows} x {seq}",
                  two_ranks=metrics, launches=launches)
    if rank == 0:       # the one-rank step with 2 microbatches: the same rows in 2 pieces
        one = make_train_step(model, opt, one_rules, shape, lr=lr, loss_chunk=0, microbatches=2)
        g1, m1 = one.grads(params, batch)
        m1 = {k: float(v) for k, v in dict(m1, grad_norm=global_norm(g1)).items()}
        loss_rel = abs(metrics["loss"] - m1["loss"]) / abs(m1["loss"])
        norm_rel = abs(metrics["grad_norm"] - m1["grad_norm"]) / m1["grad_norm"]
        require(loss_rel <= 1e-5, f"8c: loss {metrics['loss']} on 2 ranks, {m1['loss']} on one")
        require(norm_rel <= 1e-4,
                f"8c: grad_norm {metrics['grad_norm']} on 2 ranks, {m1['grad_norm']} on one")
        result.update(one_rank=m1, loss_rel_diff=loss_rel, grad_norm_rel_diff=norm_rel,
                      grads_max_diff_over_max_g=grads_within("8c gathered gradients, 2 ranks "
                                                             "vs 1", grads, g1))
        del g1
    del grads
    # compressed_psum of this rank's gradients (its rows' mean) against the exact sum
    local, _ = make_train_step(model, opt, one_rules, shape, lr=lr, loss_chunk=0,
                               microbatches=1).grads(params, two.local_batch(batch))
    group = Group()
    sent = group.sent_bytes
    exact = [group.all_reduce(g.clone()) for g in _leaves(local)]
    exact_bytes, sent = group.sent_bytes - sent, group.sent_bytes
    comp = _leaves(compressed_psum_tree(local, group))
    comp_bytes = group.sent_bytes - sent
    rel = max(float((c - e).abs().max()) / max(float(e.abs().max()), 1e-9)
              for c, e in zip(comp, exact))
    require(rel < DIST_PARITY["psum_rel"], f"8c: compressed_psum is {rel} of the exact sum away")
    result.update(compressed_psum_max_rel_err=rel, psum_sent_bytes_f32=exact_bytes,
                  psum_sent_bytes_compressed=comp_bytes,
                  int8_payload_bytes=sum(g.numel() for g in _leaves(local)))
    return result


def _sync(device: str) -> None:
    import torch

    if device == "cuda":
        torch.cuda.synchronize()


def phase8_rank(rank: int, plan: dict) -> None:
    """One of phase 8's ranks: 8a, 8b and 8c on a (ranks, 1) mesh of gloo
    over ``plan["device"]``; writes its readings to ``rank<r>.json``."""
    import datetime

    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    tmp = Path(plan["tmp"])
    if plan["device"] == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous", rank=rank,
                            world_size=plan["world"], timeout=datetime.timedelta(seconds=300))
    try:
        mesh = make_mesh((plan["world"], 1), ("data", "model"), device_type=plan["device"])
        out = {"rank": rank}
        for name, run in (("8a", lambda: _phase8a(rank, mesh, plan)),
                          ("8b", lambda: _phase8b(rank, plan)),
                          ("8c", lambda: _phase8c(rank, mesh, plan))):
            t0 = time.perf_counter()
            out[name] = run()
            out[name]["wall_s"] = time.perf_counter() - t0
            gc.collect()
            if plan["device"] == "cuda":
                torch.cuda.empty_cache()
        (tmp / f"rank{rank}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()


def phase8_distributed(ckpt: Path, want_losses, card: str, *, device: str = "cuda",
                       smoke: bool = False) -> dict:
    """Spawn phase 8's ranks (the kernels are built: they only load them);
    returns {path: {kernel: launches}} of its main paths."""
    import torch
    import torch.multiprocessing as mp

    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_dist_", dir=ROOT / "build"))
    plan = dict(tmp=str(tmp), ckpt=str(ckpt), want_losses=want_losses, world=DIST_RANKS,
                device=device, smoke=smoke, train=TRAIN_RUN,
                pipeline_seq=PIPELINE["seq"], parity_seq=DIST_PARITY["seq"])
    if smoke:   # a rehearsal on the CPU at small sizes
        plan.update(train=dict(TRAIN_RUN, global_batch=4, seq_len=32), pipeline_seq=16,
                    parity_seq=16)
    try:
        t0 = time.perf_counter()
        mp.spawn(phase8_rank, args=(plan,), nprocs=DIST_RANKS, join=True)
        wall = time.perf_counter() - t0
        ranks = [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(DIST_RANKS)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for part in ("8a", "8b", "8c"):
        print(f"phase {part} " + json.dumps({"card": card, "ranks": [r[part] for r in ranks]}))
    print(f"phase 8 wall {wall:.1f} s (spawn, 8a, 8b, 8c)")
    launches = {}
    for r in ranks:
        launches[f"phase 8a train {DIST_TRAIN['arch']} rank {r['rank']}"] = r["8a"]["launches"]
        launches[f"phase 8b pipeline {PIPELINE['arch']} stage {r['rank']}"] = {
            "flash_attention": r["8b"]["k4_launches"]}
        launches[f"phase 8c parity {DIST_PARITY['arch']} rank {r['rank']}"] = r["8c"]["launches"]
    return launches


# phase 9: tensor and sequence parallelism (slice F2): four gloo ranks on
# the one card, a (2, 2) ("data", "model") mesh
TP_MESH = (2, 2)
# 9a and 9b through run_training on the mesh, bf16, 1 microbatch, 2 steps
# from the seed (the second's time is the reading): tinyllama-1.1b at full
# width; qwen3-moe-30b-a3b at published widths cut to 2 of its 48 layers
# (every rank builds the whole tree before it keeps its block: 61.5 GB at 48)
TP_TRAIN = (("9a", "tinyllama-1.1b", 0), ("9b", "qwen3-moe-30b-a3b", 2))
TP_RUN = dict(global_batch=4, seq_len=2048, steps=2)
# 9c: float32 at a batch of 4 x 512: (arch, layers kept (0: all), sequence
# parallel) held to the one-rank step on the same card, and qwen3-moe at
# 2 layers held to itself through K4's plain version (per-shard routing
# differs from one rank's global routing by design)
TP_PARITY = (("tinyllama-1.1b", 2, False), ("tinyllama-1.1b", 2, True), ("mamba2-130m", 4, False))
TP_PARITY_MOE = ("qwen3-moe-30b-a3b", 2)
TP_PARITY_BATCH = dict(batch=4, seq=512)


def _phase9_train(mesh, plan: dict, part: str, arch: str, layers: int) -> dict:
    """run_training on the mesh: losses, step ms, bytes a step to each group,
    peak memory, launches; for the moe model each data shard's own routing
    readings in the first step's forward (before their mean over the shards)."""
    import math

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.train import TrainLoopConfig, run_training
    from repro_torch.models.transformer import layer_kinds

    device = plan["device"]
    run_cfg = dict(plan["tp_run"], lr=plan["train"]["lr"])
    layers = 0 if plan["smoke"] else layers
    cfg = get_config(arch)
    cfg = cfg.smoke() if plan["smoke"] else cfg
    cfg = cfg.replace(num_layers=layers) if layers else cfg
    wrappers = model_wrappers()
    for w in wrappers.values():
        w.launches = 0
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    stats, served = [], []      # each moe layer call's (load, overflow); its experts
    watch = contextlib.ExitStack()
    if cfg.family == "moe":
        watch.enter_context(_observing("core.moe_dispatch", "expert_load_stats",
                                       lambda args, kw, r: stats.append(
                                           (r[0].detach().max(), r[1].detach()))))
        watch.enter_context(_observing("models.moe", "_place_rows",
                                       lambda args, kw, r: served.append(args[0].shape[0])))
    with watch:
        run = run_training(TrainLoopConfig(arch=arch, smoke=plan["smoke"], layers=layers,
                                           device=device, microbatches=1, log_every=1,
                                           **run_cfg), mesh=mesh)
    launches = {name: w.launches for name, w in wrappers.items()}
    cuda = device == "cuda"
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if cuda else None
    reserved_gb = torch.cuda.max_memory_reserved() / 1e9 if cuda else None
    require(all(math.isfinite(x) for x in run["losses"]), f"{part}: losses {run['losses']}")
    attn = sum(kind in ("attn", "moe") for kind in layer_kinds(cfg))
    want = 2 * attn * run_cfg["steps"]      # forward and remat, a layer and step
    if device == "cuda":
        require(launches == dict(flash_attention=want, flash_attention_backward=want // 2,
                                 flash_attention_wide=0, ssd_scan=0, ssd_scan_backward=0,
                                 flash_attention_f32=0, flash_attention_f32_backward=0),
                f"{part}: launches {launches}, not flash_attention {want} and its backward "
                f"{want // 2}")
    result = dict(arch=arch, layers=cfg.num_layers, mesh=list(TP_MESH),
                  batch=f"{run_cfg['global_batch']} x {run_cfg['seq_len']}", losses=run["losses"],
                  step_ms=[t * 1e3 for t in run["step_seconds"]],
                  step_ms_after_first=[t * 1e3 for t in run["step_seconds"][1:]],
                  bytes_per_step=run["collective_bytes"][-1], held_bytes=run["held_bytes"],
                  peak_mem_GB=peak_gb,
                  peak_reserved_GB=reserved_gb, launches=launches)
    if cfg.family == "moe":     # the first step's forward: its first num_layers calls
        first = stats[:cfg.num_layers]
        result.update(experts_a_rank=served[0],
                      shard_moe_overflow_frac_mean=sum(float(o) for _, o in first) / len(first),
                      shard_moe_load_max_mean=sum(float(m) for m, _ in first) / len(first))
        require(plan["smoke"] or served[0] == cfg.num_experts // TP_MESH[1],
                f"{part}: a rank serves {served[0]} experts")
    return result


def _phase9c(rank: int, mesh, plan: dict) -> dict:
    """float32: the (2, 2) step against the one-rank step, and qwen3-moe's
    (2, 2) step through K4 against the same through K4's plain version."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.data import SyntheticTokens
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import make_model
    from repro_torch.optim import AdamW, global_norm
    from repro_torch.parallel import Group, MeshRules, MeshShape

    device = plan["device"]
    rows, seq = TP_PARITY_BATCH["batch"], plan["tp_parity_seq"]
    shape = InputShape("parity", seq, rows, "train")
    world = Group()
    wrappers = model_wrappers()

    def config(arch, layers, sp=False, dtype="float32"):
        cfg = get_config(arch)
        cfg = cfg.smoke() if plan["smoke"] else cfg
        cfg = cfg.replace(num_layers=layers) if layers and not plan["smoke"] else cfg
        return cfg.replace(dtype=dtype, param_dtype=dtype, parallel=dataclasses.replace(
            cfg.parallel, sequence_parallel=sp))

    def batch_of(cfg):
        b = SyntheticTokens(cfg.padded_vocab, seq, seed=0).batch(100, shard=0, num_shards=1,
                                                                 per_shard=rows)
        return {k: torch.from_numpy(getattr(b, k)).to(device) for k in ("tokens", "labels", "mask")}

    out, launches = {}, {}
    for arch, layers, sp in TP_PARITY:
        name = f"{arch} {'sp' if sp else 'tp'}"
        cfg = config(arch, layers, sp)
        model = make_model(cfg, device=device)
        params = model.init(0)
        opt = AdamW(cfg=cfg)
        batch = batch_of(cfg)
        two = make_train_step(model, opt, MeshRules(mesh, cfg.parallel), shape,
                              lr=plan["train"]["lr"], loss_chunk=0, microbatches=1)
        shards = two.shard(params)
        for w in wrappers.values():
            w.launches = 0
        grads, metrics = two.grads(shards, batch)
        metrics = {k: float(v) for k, v in dict(metrics,
                                                grad_norm=two.global_norm(grads)).items()}
        launches[name] = {k: w.launches for k, w in wrappers.items()}
        got = launches[name]
        if device == "cuda":   # float32: K4 through its f32 kernels alone
            require(got["flash_attention"] == got["flash_attention_f32"] and
                    got["flash_attention_backward"] == got["flash_attention_f32_backward"] and
                    (arch == "mamba2-130m" or got["flash_attention_f32"] > 0),
                    f"9c {name}: launches {got}")
        grads = two.gather(grads)
        result = dict(layers=cfg.num_layers, sequence_parallel=sp, batch=f"{rows} x {seq}",
                      mesh=metrics, launches=launches[name])
        if rank == 0:
            one = make_train_step(model, opt, MeshRules(MeshShape((1, 1), ("data", "model")),
                                                        cfg.parallel),
                                  shape, lr=plan["train"]["lr"], loss_chunk=0, microbatches=1)
            g1, m1 = one.grads(params, batch)
            m1 = {k: float(v) for k, v in dict(m1, grad_norm=global_norm(g1)).items()}
            loss_rel = abs(metrics["loss"] - m1["loss"]) / abs(m1["loss"])
            norm_rel = abs(metrics["grad_norm"] - m1["grad_norm"]) / m1["grad_norm"]
            require(loss_rel <= 1e-5, f"9c {name}: loss {metrics['loss']} on (2, 2), "
                    f"{m1['loss']} on one rank")
            require(norm_rel <= 1e-4, f"9c {name}: grad_norm {metrics['grad_norm']} on (2, 2), "
                    f"{m1['grad_norm']} on one rank")
            result.update(one_rank=m1, loss_rel_diff=loss_rel, grad_norm_rel_diff=norm_rel,
                          grads_max_diff_over_max_g=grads_within(
                              f"9c {name} gathered gradients, (2, 2) vs 1", grads, g1))
            del g1, one
        out[name] = result
        del grads, shards, params, model, two
        gc.collect()

    # qwen3-moe: the (2, 2) step through K4 and through its plain version
    arch, layers = TP_PARITY_MOE
    cfg16, cfg = config(arch, layers, dtype="bfloat16"), config(arch, layers)
    rules = MeshRules(mesh, cfg.parallel)
    batch = batch_of(cfg)
    runs = []
    for plain in (False, True):
        model = make_model(cfg, device=device, plain=plain)
        step = make_train_step(model, AdamW(cfg=cfg), rules, shape, loss_chunk=0,
                               microbatches=1)
        if not runs:    # built in bf16 (half the transient tree), held in f32
            blocks = _map_leaves(step.shard(make_model(cfg16, device=device).init(0)),
                                 lambda t: t.float())
        routes = []     # each layer's routing (forward and remat): experts, aux losses
        for w in wrappers.values():
            w.launches = 0
        with _observing("core.moe_dispatch", "route_topk",
                        lambda args, kw, r: routes.append(
                            (r.expert_ids.cpu(), float(r.aux_loss.detach()),
                             float(r.router_z_loss.detach())))):
            grads, metrics = step.grads(blocks, batch)
        norm = float(step.global_norm(grads))
        if not plain:
            launches[f"{arch} tp"] = {k: w.launches for k, w in wrappers.items()}
        runs.append(dict(routes=routes, metrics={k: float(v) for k, v in metrics.items()},
                         grad_norm=norm, grads=_map_leaves(grads, lambda t: t.cpu())))
        del grads, step, model
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
    kern, pl = runs
    # the same experts for every token (so the same capacity chunks, overflow
    # and loads), and the same aux losses
    require(len(kern["routes"]) == len(pl["routes"]) and all(
        torch.equal(a[0], b[0]) for a, b in zip(kern["routes"], pl["routes"])),
        "9c qwen3-moe: a token's experts differ between K4 and its plain version")
    aux_rel = max(abs(a[i] - b[i]) / abs(b[i]) for a, b in zip(kern["routes"], pl["routes"])
                  for i in (1, 2))
    require(aux_rel <= 1e-5, f"9c qwen3-moe: an aux loss differs by {aux_rel:.3e} (relative)")
    loss_rel = abs(kern["metrics"]["loss"] - pl["metrics"]["loss"]) / abs(pl["metrics"]["loss"])
    norm_rel = abs(kern["grad_norm"] - pl["grad_norm"]) / pl["grad_norm"]
    require(loss_rel <= 1e-5 and norm_rel <= 1e-4,
            f"9c qwen3-moe: loss {kern['metrics']['loss']} / {pl['metrics']['loss']}, grad_norm "
            f"{kern['grad_norm']} / {pl['grad_norm']} through K4 / plain")
    gmax = world.all_reduce_float(max(float(g.abs().max()) for g in _leaves(pl["grads"])), "max")
    worst = world.all_reduce_float(max(float((a - b).abs().max()) for a, b in zip(
        _leaves(kern["grads"]), _leaves(pl["grads"]))), "max")
    require(worst <= GRAD_REL * gmax, f"9c qwen3-moe: a gradient differs by {worst:.3e}, beyond "
            f"{GRAD_REL} x the largest |g| {gmax:.3e}")
    out[f"{arch} kernels vs plain"] = dict(
        layers=cfg.num_layers, batch=f"{rows} x {seq}", loss_rel_diff=loss_rel,
        grad_norm_rel_diff=norm_rel, grads_max_diff_over_max_g=worst / gmax,
        routings_equal=len(kern["routes"]), aux_max_rel_diff=aux_rel,
        launches=launches[f"{arch} tp"])
    return dict(cases=out, launches=launches)


def phase9_rank(rank: int, plan: dict) -> None:
    """One of phase 9's ranks: 9a, 9b and 9c on the (2, 2) mesh of gloo over
    ``plan["device"]``; writes its readings to ``rank<r>.json``."""
    import datetime

    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    tmp = Path(plan["tmp"])
    if plan["device"] == "cuda":
        # four ranks share the card: segments that grow, not a cache of fixed
        # blocks each, leave the others room (read when this process's
        # allocator starts, on its first allocation)
        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous", rank=rank,
                            world_size=plan["world"], timeout=datetime.timedelta(seconds=300))
    try:
        mesh = make_mesh(TP_MESH, ("data", "model"), device_type=plan["device"])
        out = {"rank": rank, "coordinate": mesh.get_coordinate()}
        for part, arch, layers in TP_TRAIN:
            t0 = time.perf_counter()
            out[part] = _phase9_train(mesh, plan, part, arch, layers)
            out[part]["wall_s"] = time.perf_counter() - t0
            gc.collect()
            if plan["device"] == "cuda":
                torch.cuda.empty_cache()
        t0 = time.perf_counter()
        out["9c"] = _phase9c(rank, mesh, plan)
        out["9c"]["wall_s"] = time.perf_counter() - t0
        (tmp / f"rank{rank}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()


def phase9_tensor_parallel(card: str, *, device: str = "cuda", smoke: bool = False) -> dict:
    """Spawn phase 9's ranks (the kernels are built: they only load them);
    returns ({path: {kernel: launches}} of its main paths, each rank's
    readings)."""
    import torch
    import torch.multiprocessing as mp

    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_tp_", dir=ROOT / "build"))
    world = TP_MESH[0] * TP_MESH[1]
    plan = dict(tmp=str(tmp), world=world, device=device, smoke=smoke, train=TRAIN_RUN,
                tp_run=TP_RUN, tp_parity_seq=TP_PARITY_BATCH["seq"])
    if smoke:   # a rehearsal on the CPU at small sizes
        plan.update(tp_run=dict(TP_RUN, seq_len=32), tp_parity_seq=16)
    try:
        t0 = time.perf_counter()
        mp.spawn(phase9_rank, args=(plan,), nprocs=world, join=True)
        wall = time.perf_counter() - t0
        ranks = [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(world)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for part in ("9a", "9b", "9c"):
        print(f"phase {part} " + json.dumps({"card": card, "ranks": [
            dict(r[part], rank=r["rank"], coordinate=r["coordinate"]) for r in ranks]}))
    print(f"phase 9 wall {wall:.1f} s (spawn, 9a, 9b, 9c)")
    if device == "cuda":    # what the four ranks' allocators held at most, against the card
        total = torch.cuda.get_device_properties(0).total_memory / 1e9
        print("phase 9 memory " + json.dumps({"card_GB": total, **{
            part: {"ranks_peak_reserved_GB": sum(r[part]["peak_reserved_GB"] for r in ranks),
                   "headroom_GB": total - sum(r[part]["peak_reserved_GB"] for r in ranks)}
            for part in ("9a", "9b")}}))
    launches = {}
    for r in ranks:
        for part, arch, _ in TP_TRAIN:
            launches[f"phase {part} train {arch} rank {r['rank']}"] = r[part]["launches"]
        for name, counts in r["9c"]["launches"].items():
            launches[f"phase 9c {name} rank {r['rank']}"] = counts
    return launches, ranks


# phase 10: prefill and decode on the (2, 2) mesh (slice F3a): four gloo
# ranks on the one card, the serving steps of launch/steps.py against the
# one-rank Model.prefill / decode_step the parent ran on the same prompts
SERVE_TP = dict(batch=4, prompt=512, max_len=1024, steps=4)
# (part, arch, dtype, whether the tokens and logits are checks (float32)
# or readings (bf16))
SERVE_TP_CASES = (("10a", "tinyllama-1.1b", "float32", True),
                  ("10b", "mamba2-130m", "float32", True),
                  ("10c", "tinyllama-1.1b", "bfloat16", False))


def _serve_tp_config(arch: str, dtype: str, smoke: bool):
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    return (cfg.smoke() if smoke else cfg).replace(dtype=dtype, param_dtype=dtype)


def _serve_tp_prompt(cfg, plan: dict, device: str):
    import torch

    gen = torch.Generator(device="cpu").manual_seed(10)
    return torch.randint(0, cfg.vocab_size, (plan["batch"], plan["prompt"]), generator=gen,
                         dtype=torch.int32).to(device)


def _phase10_one_rank(part: str, arch: str, dtype: str, plan: dict, tmp: Path) -> dict:
    """The parent's one-rank run of a case: prefill and greedy decode through
    ``Model.prefill`` / ``decode_step``, its tokens and last-position
    logits written to ``tmp`` for the ranks."""
    import torch

    from repro_torch.kernels.flash_attention.flash_attention import flash_attention
    from repro_torch.kernels.ssd_scan.ssd_scan import ssd_scan
    from repro_torch.models import make_model

    device = plan["device"]
    cfg = _serve_tp_config(arch, dtype, plan["smoke"])
    model = make_model(cfg, device=device)
    params = model.init(0)
    tokens = _serve_tp_prompt(cfg, plan, device)
    for w in (flash_attention, ssd_scan):
        w.launches = 0
    logits, caches = model.prefill(params, tokens, plan["max_len"])
    launches = {"flash_attention": flash_attention.launches, "ssd_scan": ssd_scan.launches}
    out = dict(logits=[logits.float().cpu()], tokens=[])
    for i in range(plan["steps"]):
        tok = logits.argmax(dim=-1)
        out["tokens"].append(tok.cpu())
        pos = torch.full((plan["batch"], 1), plan["prompt"] + i, dtype=torch.int32, device=device)
        logits, caches = model.decode_step(params, tok[:, None].int(), pos, caches)
        out["logits"].append(logits.float().cpu())
    torch.save(out, tmp / f"one_rank_{part}.pt")
    del params, caches, logits, model
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return launches


def _phase10_case(mesh, plan: dict, part: str, arch: str, dtype: str, check: bool) -> dict:
    """One case on this rank: the prefill step and ``steps`` greedy decode
    steps on the mesh, against the parent's one-rank run."""
    import torch

    from repro_torch.configs.base import InputShape
    from repro_torch.kernels.flash_attention.flash_attention import flash_attention
    from repro_torch.kernels.ssd_scan.ssd_scan import ssd_scan
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import greedy_tokens, make_model
    from repro_torch.models.transformer import layer_kinds
    from repro_torch.parallel import MeshRules

    device, rows = plan["device"], plan["batch"]
    cuda = device == "cuda"
    cfg = _serve_tp_config(arch, dtype, plan["smoke"])
    model = make_model(cfg, device=device)
    rules = MeshRules(mesh, cfg.parallel)
    prefill = make_prefill_step(model, rules, InputShape("p", plan["max_len"], rows, "prefill"))
    decode = make_decode_step(model, rules, InputShape("d", plan["max_len"], rows, "decode"))
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    shards = prefill.shard(model.init(0))   # the whole tree from the seed, then this rank's blocks
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    tokens = _serve_tp_prompt(cfg, plan, device)
    want = torch.load(Path(plan["tmp"]) / f"one_rank_{part}.pt")
    tp, data = prefill.tp, prefill.group
    d, m = mesh.get_coordinate()
    local_rows = slice(d * rows // TP_MESH[0], (d + 1) * rows // TP_MESH[0])
    heads = []      # (query, kv) heads of every K4 call of the prefill; K5's heads
    wrappers = {"flash_attention": flash_attention, "ssd_scan": ssd_scan,
                "flash_attention_f32": Count(flash_attention, "f32_launches")}
    load_at_start = os.getloadavg()[0]

    def call(fn, *args):
        """fn(*args) timed by the host clock, with the bytes it hands to each
        group, the launches it makes, the part of its time spent inside the
        groups' collectives and the process's CPU time."""
        for w in wrappers.values():
            w.launches = 0
        sent = (tp.group.sent_bytes, data.sent_bytes)
        _sync(device)
        in_collectives = _COLLECTIVE_S[0]
        cpu0, t0 = time.process_time(), time.perf_counter()
        out = fn(*args)
        _sync(device)
        return out, dict(ms=(time.perf_counter() - t0) * 1e3,
                         collective_ms=(_COLLECTIVE_S[0] - in_collectives) * 1e3,
                         cpu_ms=(time.process_time() - cpu0) * 1e3,
                         model_group_bytes=tp.group.sent_bytes - sent[0],
                         data_group_bytes=data.sent_bytes - sent[1],
                         launches={k: w.launches for k, w in wrappers.items()})

    def held(got, i):
        """The logits block against the one-rank run's; (max |diff|, within)."""
        ref = want["logits"][i][local_rows]
        cols = ref.shape[1] // TP_MESH[1]
        ref = ref[:, m * cols:(m + 1) * cols]
        got = got.float().cpu()
        return float((got - ref).abs().max()), within(got, ref, LOGITS_TOL)

    observe = (_observing("models.ssm", "ssd_scan", lambda args, kw, r: heads.append(
        (args[0].shape[2],))) if cfg.family == "ssm" else _observing(
        "models.attention", "flash_attention",
        lambda args, kw, r: heads.append((args[0].shape[2], args[1].shape[2]))))
    with observe:
        (logits, caches), prefill_reading = call(prefill, shards, {"tokens": tokens})
    prefill_heads = sorted(set(heads))
    diffs, equal, decode_readings = [held(logits, 0)], [], []
    for i in range(plan["steps"]):
        tok = torch.cat(data.all_gather(greedy_tokens(logits, tp)).unbind(0))   # every row
        equal.append(int((tok.cpu() == want["tokens"][i]).sum()))
        pos = torch.full((rows, 1), plan["prompt"] + i, dtype=torch.int32, device=device)
        (logits, caches), reading = call(decode, shards, tok[:, None].int(), pos, caches)
        decode_readings.append(reading)
        diffs.append(held(logits, i + 1))
    kinds = layer_kinds(cfg)
    attn, ssd = sum(k in ("attn", "moe") for k in kinds), kinds.count("ssd")
    # K4 on the rank's heads (the GQA ratio kept); K5 on every head (the
    # gathered in_proj path)
    want_heads = ([(cfg.ssm_heads,)] if ssd else
                  [(cfg.num_heads // TP_MESH[1], cfg.num_kv_heads // TP_MESH[1])])
    name = f"{part} {arch} {dtype}"
    require(prefill_heads == want_heads, f"{name}: the kernels ran on heads {prefill_heads}, "
            f"not {want_heads}")
    if cuda:
        got = prefill_reading["launches"]
        f32 = attn if dtype == "float32" else 0
        require(got == {"flash_attention": attn, "ssd_scan": ssd, "flash_attention_f32": f32},
                f"{name}: a prefill launched {got}, not K4 {attn} ({f32} f32) and K5 {ssd} times")
        require(all(r["launches"] == {"flash_attention": 0, "ssd_scan": 0,
                                      "flash_attention_f32": 0}
                    for r in decode_readings), f"{name}: a decode step launched a kernel")
    total = rows * plan["steps"]
    if check:
        require(sum(equal) == total, f"{name}: greedy tokens {equal} a step of {rows} equal "
                f"to the one-rank run's")
        require(all(ok for _, ok in diffs), f"{name}: logits differ from the one-rank run's by "
                f"{[round(x, 6) for x, _ in diffs]} (max |diff| a call; rtol/atol 1e-3)")
    return dict(
        arch=arch, dtype=dtype, layers=cfg.num_layers, mesh=list(TP_MESH),
        batch=f"{rows} x {plan['prompt']}", max_len=plan["max_len"], decode_steps=plan["steps"],
        greedy_tokens_equal_share=sum(equal) / total,
        logits_max_abs_diff=[x for x, _ in diffs], prefill_heads=prefill_heads,
        load_avg_1min_at_start=load_at_start,
        prefill=prefill_reading, decode_ms=[r["ms"] for r in decode_readings],
        decode_collective_ms=[r["collective_ms"] for r in decode_readings],
        decode_cpu_ms=[r["cpu_ms"] for r in decode_readings],
        decode_model_group_bytes=decode_readings[0]["model_group_bytes"],
        decode_data_group_bytes=decode_readings[0]["data_group_bytes"],
        decode_launches=decode_readings[0]["launches"],
        shard_bytes=sum(t.numel() * t.element_size() for t in _leaves(shards)),
        peak_mem_GB=torch.cuda.max_memory_allocated() / 1e9 if cuda else None,
        launches=prefill_reading["launches"])


# seconds this process has spent inside ``Group``'s collectives (phase 10's
# ranks time them: each waits for the card's queued work, gloo's host
# copies and sums, and the other ranks)
_COLLECTIVE_S = [0.0]


def _timing_collectives() -> None:
    """Make every ``Group`` collective add its wall time to ``_COLLECTIVE_S``."""
    from repro_torch.parallel.collectives import Group

    def timed(fn):
        @functools.wraps(fn)
        def run(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                _COLLECTIVE_S[0] += time.perf_counter() - t0
        return run

    for name in ("all_reduce", "broadcast", "all_gather", "reduce_scatter", "send", "recv"):
        setattr(Group, name, timed(getattr(Group, name)))


def phase10_rank(rank: int, plan: dict) -> None:
    """One of phase 10's ranks: 10a, 10b and 10c on the (2, 2) mesh of gloo
    over ``plan["device"]``; writes its readings to ``rank<r>.json``."""
    import datetime

    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    _timing_collectives()

    tmp = Path(plan["tmp"])
    if plan["device"] == "cuda":
        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous", rank=rank,
                            world_size=plan["world"], timeout=datetime.timedelta(seconds=300))
    try:
        mesh = make_mesh(TP_MESH, ("data", "model"), device_type=plan["device"])
        out = {"rank": rank, "coordinate": list(mesh.get_coordinate())}
        for part, arch, dtype, check in SERVE_TP_CASES:
            t0 = time.perf_counter()
            out[part] = _phase10_case(mesh, plan, part, arch, dtype, check)
            out[part]["wall_s"] = time.perf_counter() - t0
            gc.collect()
            if plan["device"] == "cuda":
                torch.cuda.empty_cache()
        (tmp / f"rank{rank}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()


def _host_memory_GB() -> dict:
    """This process's resident memory and the host's available memory, GB."""
    def kb(path: str, key: str) -> float:
        for line in Path(path).read_text().splitlines():
            if line.startswith(key + ":"):
                return int(line.split()[1]) * 1024 / 1e9
        return float("nan")

    return dict(parent_rss_GB=kb("/proc/self/status", "VmRSS"),
                host_available_GB=kb("/proc/meminfo", "MemAvailable"))


def phase10_serving_tp(card: str, *, device: str = "cuda", smoke: bool = False) -> dict:
    """Phase 10: the one-rank runs, then the four ranks (the kernels are
    built: they only load them); returns ({path: {kernel: launches}} of its
    main paths (the ranks' steps), each rank's readings)."""
    import torch
    import torch.multiprocessing as mp

    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_serve_tp_", dir=ROOT / "build"))
    world = TP_MESH[0] * TP_MESH[1]
    plan = dict(SERVE_TP, tmp=str(tmp), world=world, device=device, smoke=smoke)
    if smoke:   # a rehearsal on the CPU at small sizes
        plan.update(prompt=16, max_len=32, steps=4)
    try:
        t0 = time.perf_counter()
        one_rank = {part: _phase10_one_rank(part, arch, dtype, plan, tmp)
                    for part, arch, dtype, _ in SERVE_TP_CASES}
        t1 = time.perf_counter()
        # what the ranks share with the parent: the host's load and memory,
        # and the card's memory the parent still holds
        print("phase 10 before the spawn " + json.dumps(dict(
            load_avg=os.getloadavg(), cpus=len(os.sched_getaffinity(0)),
            **_host_memory_GB(),
            parent_allocated_GB=torch.cuda.memory_allocated() / 1e9 if device == "cuda" else None,
            parent_reserved_GB=torch.cuda.memory_reserved() / 1e9 if device == "cuda" else None,
            parent_threads=threading.active_count())))
        mp.spawn(phase10_rank, args=(plan,), nprocs=world, join=True)
        wall = time.perf_counter() - t0
        ranks = [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(world)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for part, *_ in SERVE_TP_CASES:
        print(f"phase {part} " + json.dumps({"card": card, "one_rank_launches": one_rank[part],
                                             "ranks": [dict(r[part], rank=r["rank"],
                                                            coordinate=r["coordinate"])
                                                       for r in ranks]}))
    print(f"phase 10 wall {wall:.1f} s (one-rank runs {t1 - t0:.1f} s, then spawn, 10a, 10b, "
          "10c)")
    return {f"phase {part} serve {arch} {dtype} rank {r['rank']}": r[part]["launches"]
            for part, arch, dtype, _ in SERVE_TP_CASES for r in ranks}, ranks


# phase 11: the dry-run (slice F3b): one rank's step on meta tensors over
# shape-only groups, priced from the H100 SXM data sheet.  11a holds the
# steps phases 7, 9a and 10a / 10b ran to what they counted; 11c traces
# perf.py's cells in worker processes beside it
DRY_RUN_WORKERS = 7


def _dry_run_cases(smoke: bool):
    """(name, config, shape, keywords of dry_run, mesh) of each step of
    phases 7, 9a and 10a / 10b that phase 11a dry-runs."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.launch.mesh import make_test_mesh

    one, mesh = make_test_mesh((1, 1)), make_test_mesh(TP_MESH)
    cases = []
    if not smoke:       # phase 7 runs on the card only
        for arch in TRAIN_ARCHS:
            cases.append((f"7 {arch}", get_config(arch),
                          InputShape("train", TRAIN_RUN["seq_len"], TRAIN_RUN["global_batch"],
                                     "train"),
                          dict(microbatches=TRAIN_RUN["microbatches"], loss_chunk=0), one))
    run = dict(TP_RUN, seq_len=32) if smoke else TP_RUN
    cfg = get_config(TP_TRAIN[0][1])
    cases.append(("9a", cfg.smoke() if smoke else cfg,
                  InputShape("train", run["seq_len"], run["global_batch"], "train"),
                  dict(microbatches=1, loss_chunk=0), mesh))
    serve = dict(SERVE_TP, prompt=16, max_len=32) if smoke else SERVE_TP
    for part, arch, dtype, _ in SERVE_TP_CASES[:2]:
        cfg = _serve_tp_config(arch, dtype, smoke)
        cases.append((f"{part} prefill", cfg,
                      InputShape("p", serve["max_len"], serve["batch"], "prefill"),
                      dict(prompt=serve["prompt"]), mesh))
        cases.append((f"{part} decode", cfg,
                      InputShape("d", serve["max_len"], serve["batch"], "decode"), {}, mesh))
    return cases


def phase11_dry_run(card: str, trained: dict, ranks9, ranks10, *, device: str = "cuda",
                    smoke: bool = False) -> dict:
    """Phase 11; ``trained``: phase 7's readings by arch, ``ranks9`` /
    ``ranks10``: phases 9 and 10's ranks' readings.  Returns 11d's K3
    launches."""
    from repro_torch.kernels.spmm.spmm import spmm_block_ell
    from repro_torch.launch.dryrun import dry_run

    out_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_dryrun_", dir=ROOT / "build"))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    perf = subprocess.Popen([sys.executable, "-m", "repro_torch.launch.perf", "--out",
                             str(out_dir), "--workers", str(DRY_RUN_WORKERS)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
    try:
        # -- 11a / 11b: the steps the earlier phases ran ----------------------
        t0 = time.perf_counter()
        held = {}
        for name, cfg, shape, kw, mesh in _dry_run_cases(smoke):
            rec = dry_run(cfg, shape, mesh, **kw)
            groups, mem, roof = rec["collective_bytes_by_group"], rec["memory"], rec["roofline"]
            predicted = dict(model=groups["model"], data=groups["data"],
                             params_and_state=mem["param_bytes"] + mem.get("opt_state_bytes", 0),
                             bound_ms=roof["bound_s"] * 1e3, dominant=roof["dominant"],
                             peak_GB=mem["peak_est_bytes"] / 1e9)
            if name.startswith("7"):
                got = trained[name.split()[1]]
                measured = [dict(model=0, data=0, params_and_state=sum(got["held_bytes"].values()),
                                 step_ms=got["step_ms_median_after_2"],
                                 peak_GB=got["peak_mem_GB"])]
            elif name == "9a":
                measured = [dict(model=r["9a"]["bytes_per_step"]["model"],
                                 data=r["9a"]["bytes_per_step"]["data"],
                                 params_and_state=sum(r["9a"]["held_bytes"].values()),
                                 step_ms=min(r["9a"]["step_ms_after_first"]),
                                 peak_GB=r["9a"]["peak_mem_GB"]) for r in ranks9]
            else:
                part, kind = name.split()
                measured = []
                for r in ranks10:
                    case = r[part]
                    reading = case["prefill"] if kind == "prefill" else dict(
                        model_group_bytes=case["decode_model_group_bytes"],
                        data_group_bytes=case["decode_data_group_bytes"])
                    measured.append(dict(model=reading["model_group_bytes"],
                                         data=reading["data_group_bytes"],
                                         params_and_state=case["shard_bytes"],
                                         peak_GB=case["peak_mem_GB"]))
            for i, m in enumerate(measured):
                for key in ("model", "data", "params_and_state"):
                    require(m[key] == predicted[key], f"11a {name} rank {i}: {key} bytes "
                            f"{m[key]} measured, {predicted[key]} dry-run")
                if "step_ms" in m and name in ("7 tinyllama-1.1b", "9a") and not smoke:
                    require(predicted["bound_ms"] <= m["step_ms"], f"11a {name} rank {i}: a "
                            f"bound of {predicted['bound_ms']} ms over the measured step "
                            f"{m['step_ms']} ms")
            held[name] = dict(predicted=predicted, measured=measured, trace_s=rec["trace_s"],
                              terms_s={k: roof[k] for k in ("compute_s", "memory_s",
                                                           "collective_s")})
            print(f"phase 11a {name} " + json.dumps(held[name]))
            print(f"phase 11b {name} peak GB: predicted {predicted['peak_GB']:.4f}, measured "
                  + ", ".join("none" if m["peak_GB"] is None else f"{m['peak_GB']:.4f}"
                              for m in measured))
        print(f"phase 11a-b {time.perf_counter() - t0:.1f} s")
        # -- 11c: perf.py's cells, traced beside 11a ---------------------------
        text, _ = perf.communicate(timeout=600)
        print("phase 11c (predicted: NVIDIA H100 SXM data sheet)\n" + text.rstrip())
        require(perf.returncode == 0, f"11c: launch.perf exited {perf.returncode}")
    finally:
        if perf.poll() is None:
            perf.kill()
            perf.wait()
        shutil.rmtree(out_dir, ignore_errors=True)
    # -- 11d: the SPMM example on the card, K3 counted --------------------------
    sys.path.insert(0, str(ROOT / "examples"))
    import torch_hetero_spmm_demo

    spmm_block_ell.launches = 0
    demo = torch_hetero_spmm_demo.run(device)
    launches = spmm_block_ell.launches
    if device == "cuda":
        require(launches > 0, "11d: the SPMM example did not launch K3")
    print("phase 11d " + json.dumps(dict(demo, spmm_block_ell_launches=launches, card=card)))
    return {"phase 11d example": {"spmm_block_ell": launches}}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card",
              file=sys.stderr)
        return 2
    from repro_torch.configs.paper_eneac import HOTSPOT, SPMM
    from repro_torch.kernels.hotspot.hotspot import hotspot_hp_step, hotspot_hpc
    from repro_torch.kernels.spmm.spmm import spmm_block_ell

    t_start = time.perf_counter()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    torch.backends.cudnn.allow_tf32 = False
    require(torch.backends.cuda.matmul.allow_tf32 is False,
            "torch.backends.cuda.matmul.allow_tf32 must be False (IEEE f32 parity)")

    kernels, (temp, power), problem, k3_ref, k3_host = phase1_kernels(HOTSPOT, SPMM)
    print(f"phase 1 done at {time.perf_counter() - t_start:.1f} s")

    wrappers = {"hotspot_hpc": hotspot_hpc, "hotspot_hp_step": hotspot_hp_step,
                "spmm_block_ell": spmm_block_ell}
    for w in wrappers.values():
        w.launches = 0
    phase2_run_s = phase2_spmm_hybrid(problem, k3_ref)
    print(f"phase 2 done at {time.perf_counter() - t_start:.1f} s")
    phase3_hotspot_runtime(HOTSPOT, temp, power)
    print(f"phase 3 done at {time.perf_counter() - t_start:.1f} s")
    for name, w in wrappers.items():
        kernels[name]["launches"] = w.launches
        kernels[name]["launches_by_path"] = {"phases 2-3": w.launches}
        require(w.launches > 0, f"{name} was not launched on the main path")

    kernels.update(phase4_model_kernels())
    kernels.update(phase4_backward_kernels())
    print(f"phase 4 done at {time.perf_counter() - t_start:.1f} s")
    wrappers.update(model_wrappers())
    inline_tokens = {}
    for name in ("flash_attention", "ssd_scan", "flash_attention_wide", "flash_attention_backward",
                 "ssd_scan_backward", "flash_attention_f32", "flash_attention_f32_backward"):
        kernels[name]["launches"] = 0
        kernels[name]["launches_by_path"] = {}

    def serve_inline(arch):
        counts, inline_tokens[arch], rolled = phase5_serving(arch, wrappers)
        for name, launches in counts.items():
            kernels[name]["launches"] += launches
            kernels[name]["launches_by_path"][f"phase 5 {arch}"] = launches
        if rolled:
            kernels["flash_attention"]["launches_by_path"][
                f"phase 5 {arch} f32 past the window"] = rolled
        print(f"phase 5 {arch} done at {time.perf_counter() - t_start:.1f} s")

    for arch in SERVE_ARCHS:
        serve_inline(arch)

    from repro_torch.core.transport import spawn_worker

    workers = []
    try:
        workers = [spawn_worker(startup_timeout=120.0) for _ in range(2)]
        for arch in SERVE_ARCHS:
            name, launches = phase6a_remote_serving(arch, inline_tokens[arch], workers, wrappers)
            kernels[name]["launches_by_path"]["phase 6a workers"] = launches
            print(f"phase 6a {arch} done at {time.perf_counter() - t_start:.1f} s")
    finally:
        for w in workers:
            w.kill()
    kernels["spmm_block_ell"]["launches_by_path"]["phase 6b"] = phase6b_checkpointed_spmm(
        k3_host, phase2_run_s)
    del k3_host
    print(f"phase 6b done at {time.perf_counter() - t_start:.1f} s")
    phase6c_fleet()
    print(f"phase 6c done at {time.perf_counter() - t_start:.1f} s")
    for arch in INLINE_ARCHS:
        serve_inline(arch)
    for arch in CROSS_SOURCE_ARCHS:
        launches, by_kind, f32 = phase5_cross_source(arch, wrappers)
        kernels["flash_attention"]["launches"] += launches
        for kind, n in by_kind.items():
            kernels["flash_attention"]["launches_by_path"][f"phase 5 {arch} {kind}"] = n
        kernels["flash_attention_f32"]["launches"] += f32
        kernels["flash_attention_f32"]["launches_by_path"][f"phase 5 {arch} f32"] = f32
        print(f"phase 5 {arch} done at {time.perf_counter() - t_start:.1f} s")
    # phase 7 keeps mamba2's checkpoint and resumed losses for phase 8a
    kept = Path(tempfile.mkdtemp(prefix="chip_smoke_kept_", dir=ROOT / "build"))
    try:
        resumed, trained = {}, {}
        for arch in TRAIN_ARCHS:
            keep = kept / arch if arch == DIST_TRAIN["arch"] else None
            counts, resumed[arch], trained[arch] = phase7_training(arch, wrappers, card, keep)
            for name, launches in counts.items():
                kernels[name]["launches"] += launches
                kernels[name]["launches_by_path"][f"phase 7 train {arch}"] = launches
            kernel = next(iter(counts))
            kernels[kernel]["train_fwd_bwd"] = train_function_ms(kernel)
            print(f"phase 7 {arch} done at {time.perf_counter() - t_start:.1f} s")
        arch = WIDE_TRAIN["arch"]
        counts, _, _ = phase7_training(arch, wrappers, card, layers=WIDE_TRAIN["layers"],
                                       steps=WIDE_TRAIN["steps"], resume=False)
        for name, launches in counts.items():
            kernels[name]["launches"] += launches
            kernels[name]["launches_by_path"][
                f"phase 7 train {arch} ({WIDE_TRAIN['layers']} layers)"] = launches
        print(f"phase 7 {arch} done at {time.perf_counter() - t_start:.1f} s")
        t8 = time.perf_counter()
        for path, counts in phase8_distributed(kept / DIST_TRAIN["arch"],
                                               resumed[DIST_TRAIN["arch"]], card).items():
            for name, n in counts.items():
                if n:
                    kernels[name]["launches"] += n
                    kernels[name]["launches_by_path"][path] = n
        print(f"phase 8 done at {time.perf_counter() - t_start:.1f} s "
              f"({time.perf_counter() - t8:.1f} s)")
    finally:
        shutil.rmtree(kept, ignore_errors=True)
    t9 = time.perf_counter()
    paths, ranks9 = phase9_tensor_parallel(card)
    for path, counts in paths.items():
        for name, n in counts.items():
            if n:
                kernels[name]["launches"] += n
                kernels[name]["launches_by_path"][path] = n
    print(f"phase 9 done at {time.perf_counter() - t_start:.1f} s "
          f"({time.perf_counter() - t9:.1f} s)")
    t10 = time.perf_counter()
    paths, ranks10 = phase10_serving_tp(card)
    for path, counts in paths.items():
        for name, n in counts.items():
            if n:
                kernels[name]["launches"] += n
                kernels[name]["launches_by_path"][path] = n
    print(f"phase 10 done at {time.perf_counter() - t_start:.1f} s "
          f"({time.perf_counter() - t10:.1f} s)")
    t11 = time.perf_counter()
    for path, counts in phase11_dry_run(card, trained, ranks9, ranks10).items():
        for name, n in counts.items():
            kernels[name]["launches"] += n
            kernels[name]["launches_by_path"][path] = n
    print(f"phase 11 done at {time.perf_counter() - t_start:.1f} s "
          f"({time.perf_counter() - t11:.1f} s)")
    print("launches on the main paths: " + ", ".join(
        f"{k}={v['launches_by_path']}" for k, v in kernels.items()))
    # the wide forward served stablelm-12b and recurrentgemma-9b and trained
    # stablelm-12b
    for phase in ("phase 5", "phase 7"):
        n = sum(c for path, c in kernels["flash_attention_wide"]["launches_by_path"].items()
                if path.startswith(phase))
        require(n > 0, f"flash_attention_wide was not launched in {phase}")
    # the backward kernels ran in every training phase's steps
    for name in ("flash_attention_backward", "ssd_scan_backward"):
        for phase in ("phase 7", "phase 8", "phase 9"):
            n = sum(c for path, c in kernels[name]["launches_by_path"].items()
                    if path.startswith(phase))
            require(n > 0, f"{name} was not launched in {phase}'s training")
    # K4's f32 kernels ran every f32 check: phase 5's serving, phase 7's
    # parity steps, 8c's and 9c's steps and 10a's prefills (the backward in
    # the training steps)
    for name, phases in (("flash_attention_f32", ("phase 5", "phase 7", "phase 8c", "phase 9c",
                                                  "phase 10")),
                         ("flash_attention_f32_backward", ("phase 7", "phase 8c", "phase 9c"))):
        for phase in phases:
            n = sum(c for path, c in kernels[name]["launches_by_path"].items()
                    if path.startswith(phase))
            require(n > 0, f"{name} was not launched in {phase}")

    keys = ("name", "route", "source", "replaces", "launches", "launches_by_path",
            "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    # K4's row also carries every phase-4 shape it was held and timed at, and
    # K4's and K5's the Function's forward + backward at phase 7's microbatch
    print(json.dumps({"kernels": [dict({k: v[k] for k in keys},
                                       **{k: v[k] for k in ("shapes", "train_fwd_bwd") if k in v})
                                  for v in kernels.values()]}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
