#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's CTR inference and training paths, and the
LM zoo's serving, training and mesh paths and the dry run, on one NVIDIA
card.

    python3 chip_smoke.py            # from the repository root

Phases (any failure raises; the script then exits non-zero):

1. Device and settings: the card's name and power limit (nvidia-smi),
   TF32 off for matmuls and cuDNN.
2. Build: every ``src/repro_torch/kernels/csrc/*.cu`` with nvcc for
   sm_90a, one compiler per source, all at once.
3. Kernels: K1 ``mtl_gather`` (d = 32 and d = 1), K9 ``fused_cross_v2``,
   K10 ``fused_cross_v1`` and K11 ``fused_fm_second_order`` at the main
   path's shapes (b = 256 and 1024) against their plain PyTorch versions
   on the card — bitwise for K1, K9, K10, within ``FM_TOL`` for K11 —
   and timed with CUDA events beside the plain version, the one PyTorch
   call that computes the same function where there is one
   (``library_ms``), and the least time the card could take
   (``bound_ms``). K9 and K10 also in layer 0's form (``x`` is ``x0``,
   one load stream fewer), on operands 4 bytes into their storage (four
   4-byte loads a piece), at D = 117 (a float a piece) and b = 1, through
   their launch sweep (1, 2, 4 pieces a thread × 32-256 threads a block at
   b = 256 and 1024, every setting bitwise before it is timed), and on
   NaN, inf and -inf entries (the plain version's bits). K11 also through
   its launch sweep (32-256 threads a
   block at b = 256 and 1024, every setting within ``FM_TOL`` before it
   is timed), at d = 1, 3 and 60, at b = 1, on a ``v`` 4 bytes into its
   storage (a float a lane), and on rows holding a NaN, an inf and a
   -inf (NaN in those rows, every other row bitwise unchanged).
   Then K2 ``mtl_gather_multihot``, K3 ``mtl_gather_two_level`` and K4
   ``mtl_gather_two_level_q8`` on the full Criteo table at d = 32 (an
   851 MB fp32 backing; a 213 MB int8 one plus 26.6 MB of scales) under
   a 65,536-row cache whose hot set comes from one observe + refresh on
   quadratic-skew traffic, at b = 256 and 1024 and h = 1 and 5: bitwise
   against their plain versions (out-of-range ids included), K2 and K3
   at h = 1 bitwise against K1, timed the same way; K3 and K4 at h = 1
   also through a cold cache (rows 0..C-1, nearly all misses), their miss
   path; K2 on a copy of the table and K3 on an fp32 cache 4 bytes into
   their storage (their 4-byte path) and K4 on int8 tiers 1 byte into
   their storage (its byte path), bitwise; and K2's and K3's launch
   sweeps (16-byte or 4-byte words, 64-256 threads a block) and K4's
   (codes loaded as 4-byte words or byte by byte, 32-256 threads), every
   setting bitwise against the plain version before it is timed.
   Then K5 ``mtl_gather_three_level`` and K6
   ``mtl_gather_three_level_q8`` on the same table under the same kind
   of 65,536-row cache (its hot set from one observe + refresh of a
   ``HostBackedStore``) with every miss of the timed batches staged, at
   b = 256 and 1024 and h = 1 and 5: bitwise against their plain
   versions (ids -7, 2**31-1 and 10**8, a cache slot past C, a staging
   slot past S and rows in neither tier, which read exactly 0.0), K5
   against K1 (h = 1) and K2 (h = 5), K6 against K4; timed the same way;
   K5 also on fp32 tiers 4 bytes into their storage and K6 on its byte
   path, and both through their launch sweeps, as K3 and K4.
   Then K12 ``dmm_q8`` (int8 ``wgmma`` on TMA-fed shared memory) at
   DCNv2's MLP shapes (1248 -> 1024, 1024 -> 1024) at b = 256 and 1024,
   plus (1, 1, 1), (33, 7, 5), (200, 1248, 1000), a misaligned ``hq``
   view and ±127 codes at fan_in 1248, bitwise against its plain version
   on the card and on the CPU, timed beside ``torch._int_mm``; the
   activation quantizer ``quantize_rows_q8`` at the same b × fan_in
   (a zero row and half-way values among them), bitwise against its
   plain version on the card and on the CPU, timed beside that ~10-op
   plain path, and on a row holding a NaN and one holding an inf (scale
   NaN and inf, codes 0 as on the CPU, K12's output rows all NaN, every
   other value bitwise); K8 ``mtl_input_first`` and K1 at Fig. 11's
   shapes (39 fields of 100,000 rows, d = 32 at b = 2048, 16,384, 65,536
   and d = 60 at b = 2048) and K8 on the full Criteo table, both also on
   a table view 4 bytes into its storage (their 4-byte path; Criteo
   b = 1024 and Fig. 11's d = 60), bitwise against each other and their
   plain versions, each timed beside ``index_select`` on its own row
   order, with the input-first / output-first ratio and each launch
   shape; K7 ``mtl_onehot`` over Criteo's 18 fields of at
   most 128 rows (fp32 and bf16 at b = 1, 256 and 1024; at b = 1024 also
   at d = 1 and 3 and on tables 4 bytes, and bf16 2 bytes, into their
   storage; ids -1, n_pad, 10**6, -2**31 and 2**31-1 giving +0.0 rows),
   bitwise against its plain version and (fp32, d = 32) a K1 gather, and
   through its launch sweep (1 and 2 rows a thread × 32-256 threads a
   block at b = 256 and 1024 and on the views, every setting bitwise
   before it is timed); then K8's path
   (``FusedEmbeddingCollection.forward(strategy="input_first")``) and
   K7's (``ops.multi_table_lookup_onehot``) with the counters reset.
4. Main path: full-width DCNv2 on the uncapped Criteo schema (k = 39,
   d = 32, 6,648,548 table rows, D = 1248, three 1248×1248 cross layers,
   MLP 1248→1024→1024→1024) with random weights from a seed, served
   through ``compile_plan(level="dual")`` on two CUDA streams at batch
   256 and 1024: a few dozen ``plan.predict`` requests, partial batches
   among them, with the launch counters reset just before and read just
   after. Scores must be finite and in (0, 1); the four levels must agree
   on the card, and the card must agree with the CPU path on the same
   weights.
5. DCN, DeepFM and Wide&Deep at the same width, the same way; DeepFM's
   trace logs K11's device time a step, DCNv2's and DCN's the cross
   tail's (K9, K10).
6. The tiered stores: the same DCNv2 weights adopted into a
   ``CachedStore`` (C = 65,536) and a ``HostBackedStore`` (C = S =
   65,536; the backing in host memory), each with fp32 and with int8
   rows, each served through one "dual" plan per batch
   (``runtime_provider=model.store_runtime_env``): per request a prefetch
   hint of the next request, ``stage`` (host stores), ``predict`` and
   ``observe``, a refresh every 8 and one batch of 1,024 trainer delta
   rows halfway — no recompile. fp32 scores must be bitwise those of a
   ``DenseStore`` plan replaying the same ids and deltas; int8 scores
   within 1e-2 of them. K3/K4 (cached) or K5/K6 (host) launch once per
   step, K1 never. A host store's device tensors must be its cache,
   staging area and two maps, never a (rows, d) table, and a staging
   upload moves only the rows and map entries that changed. Then latency
   of all five plans in turns, traces, the four levels of the fp32 cached
   model, the host store with the reference's default staging area (S =
   256), where nearly every batch overflows and is served in chunks, and
   store-level multi-hot (h = 5) through a ``DenseStore`` (K2), the fp32
   ``CachedStore`` (K3) and the fp32 ``HostBackedStore`` (K5), bitwise
   equal.
7. int8 dense compute: full-width DCNv2, DCN, DeepFM and Wide&Deep
   compiled with ``compute_dtype="int8"`` (the MLP's three layers each
   ``quantize_rows_q8`` + K12 ``dmm_q8``; the cross and head GEMMs stay
   fp32): the four levels agree on the card, the card agrees with the CPU
   int8 path, the MLP weight counters are the reference's (3,387,392 B
   int8 for DCNv2), and "dual" plans serve requests with three quantizer
   and three K12 launches a step, scores within 1e-2 of the fp32 plan's;
   DCNv2's int8 and fp32 plans timed in turns and traced, the int8 trace
   free of the eager quantizer's abs/amax/div/round/clamp. Then the full
   int8 stack: DCNv2 over an int8-row
   ``CachedStore`` with int8 compute, refreshed and updated between
   requests with no rebuild, within 1e-2 of the dense fp32 plan, and its
   fp32-row twin bitwise the dense int8-compute plan.
8. Summary, printed last (after phases 9-13): one JSON line of every
   ported kernel (its launches from its paths in phases 3-7, 10 and 11),
   then the card's name and power limit, then ``{"ok": true, "device":
   {...}}`` as the last line.
9. Serving at full width through ``repro_torch.serving`` (DCNv2, d = 32,
   hidden 1024, the uncapped Criteo table): (a) a sync
   ``InferenceEngine`` over an fp32 ``CachedStore`` (C = 65,536,
   ``BucketedBatch((64, 256, 1024))``, ``refresh_every=8``) drained by
   ``serve_pending`` wave by wave (quadratic-skew rows), one
   ``SyntheticTrainer`` batch of 1,024 delta rows pulled halfway: every
   wave's scores bitwise a ``DenseStore`` plan of each batch's bucket
   replaying the rows and deltas, plan-cache misses = the three buckets,
   all at ``warmup()``, one K3 and three K9 launches a batch, the host
   time of the push and of one more refresh logged; (b) the same
   through a ``HostBackedStore`` (C = S = 65,536) in the engine's staged
   loop, then S = 256 (batches overflow and are served in chunks):
   bitwise the dense plans, one K5 launch a plan step, the prefetch hit
   rate and p50/p99 logged; (c) a ``ServingRuntime`` (``refresh_every=
   256``, the reference CLI's ladder 16-256) hosting DCNv2 over an fp32
   ``CachedStore`` and a dense DeepFM, 2,048 requests from four submitter
   threads round-robin over the two, with ``scheduler="shared"``
   (``pool_size=2``), then ``"per-engine"``, then shared again with no
   runtime refresh: every future resolves
   within ``FUTURE_TIMEOUT_S``, every score finite, in (0, 1) and within
   ``LADDER_TOL`` of a one-bucket plan's, launches = each engine's batches
   times its step's (DCNv2 one K3 and three K9, DeepFM two K1 and one
   K11); p50/p99, batches per bucket, padding waste, device-time share,
   dispatches and the compute share of latency logged per model; (d)
   ``repro_torch.launch.serve.main`` at its defaults with ``--models
   dcnv2,deepfm --async --store cached --refresh-every 4 --delta-every
   100``, its lines logged.
10. Training (``repro_torch.training``), with K1, K9, K10 and K11 under
   autograd through their ``torch.autograd.Function``s: (a) full-width
   DCNv2 (the configuration of record: the uncapped 6,648,548-row d = 32
   table, hidden 1024) trained 300 steps at b = 1024 with AdamW lr 1e-3
   through ``run_train_loop`` and one checkpoint (~2.6 GB with ``m`` and
   ``v``, written under ``build/`` and deleted): every loss finite, the
   last 10 losses' mean below the first 10's, one K1 and three K9
   launches a step, the checkpoint restored bitwise, validation AUC and
   LogLoss through a "dual" plan at b = 8,192; (b) one backward of small
   DCNv2, DCN, DeepFM and Wide&Deep (hidden 64, fields capped at 2,000)
   on the card and on the CPU from the same weights and batch: every
   leaf's gradient within ``CPU_TOL``, the mega-table's nonzero; (c) each
   Function's backward on the card against autograd through its plain
   version on the card (K1 at d = 32 and d = 1 on the full tables, ids
   repeated; K9 and K10 with ``x`` being ``x0`` and apart; K11), K1's
   table gradient bitwise across two calls; (d) 6 steps unbroken equal 3
   steps, a restore and 3 more, bitwise; (e) the full-width step's p50
   over 50 steps and a profiler trace of 5 steps split by the host range
   that launched each kernel (forward, backward, K1's table gradient,
   optimizer), with the idle share. The summary's launch counts add
   (a)'s K1 and K9 and (b)'s K10 and K11.
11. Multi-device (``repro_torch.distributed``, single-controller) at full
   width, every mesh position on cuda:0 unless there are as many cards
   as positions: (a) dense DCNv2 "dual" on (1, 4) (212.8 MB row shards,
   bitwise the mesh-less plan), (2, 2) and (4, 1) at b = 256 and 1024,
   DCN, DeepFM and int8-compute DCNv2 on (2, 2) (within ``LADDER_TOL``
   of their mesh-less plans), with exact launches a step (K1: model
   shards × batch shards a table; K9/K10 three, K11 one, K12 and the
   quantizer three a batch shard); (b) cached fp32 and int8 and (c) host
   fp32 DCNv2 engines on (2, 2) against mesh-less twins over 32 requests
   with a refresh every 8 (bitwise across each swap) and one 1,024-row
   delta push halfway, zero recompiles, each backing shard half the rows
   on its position's device, the host tiers replicated, K3/K4 four and
   K5 two launches a step; (d) a ``ServingRuntime(mesh=(2, 2))`` hosting
   cached DCNv2 and dense DeepFM, served in waves with a ``refresh_all``
   between, within mesh-less engines; pooled (h = 5) sharded lookups
   through K2 and K3 on (1, 4); (e) the compressed data-parallel step on
   full-width DCNv2, b = 1024, over data = 2, against the exact step
   (loss within 1e-5, gradient relative error below 0.02), both timed;
   (f) p50 and host enqueue of every mesh plan beside its mesh-less plan
   in turns, at both batch sizes. On one card that is the cost of
   orchestration, not scaling.
12. The LM zoo's serving path (``repro_torch.models.lm``,
   ``serving.generate``; no hand kernel: attention is plain tensor ops,
   the GEMMs cuBLAS), the ten archs one at a time at their published
   widths in bf16, depth cut only to fit the card (``LM_ARCHS``:
   phi3.5-moe 8 of 32 layers, llama4-maverick 1 of 48): (a) ``generate``
   greedy at b = 4, a 512-token prompt (128 for rwkv6 and zamba2, whose
   recurrences step in Python; pixtral with 256 random patch rows,
   whisper with 1,500 random frames), 32 new tokens; (b) the reference's
   invariant (tests/test_lm_smoke.py:70-104): prefill + one decode step
   against the teacher-forced forward's last position, in bf16 for every
   arch (max diff and greedy agreement logged) and for llama3-8b in fp32
   within 5e-2; (c) every arch's ``reduced()`` fp32 model with the same
   weights on the card and the CPU: forward, prefill and 4 decode steps
   within ``CPU_TOL``; (d) a llama3-8b prefill at b = 1, s = 4,096 through
   ``flash_attention`` in every layer, and ``flash_attention`` against
   ``_sdpa`` on fp32 q, k, v (h = 32, kv = 8, hd = 128, s = 4,096,
   causal) within ``CPU_TOL``; (e) weight GB, init s, prefill p50 (5
   runs), decode p50 a token (32 steps, a sync each) and the same steps
   queued back to back, tokens/s, peak memory, each beside its bound
   (weights, and at decode the cache, read once at ``hw.HBM_BW``; the
   counted GEMM operations at ``hw.PEAK_FLOPS_BF16`` in bf16 and
   ``hw.PEAK_FLOPS_FP32`` in fp32), and for
   llama3-8b the device's idle share of 8 queued decode steps under
   ``torch.profiler``. Numbers also go to ``chiprun_out/lm_phase12.json``.
13. LM training through ``repro_torch.launch.train``'s step
   (``make_train_step``: the loss by autograd, then the eager AdamW; no
   hand kernel): (a) smollm-360m at full width and depth in bf16 with
   fp32 AdamW state, remat on as published, at b = 8 and s = 64 (the
   launcher's defaults, one CE chunk) and s = 2,048 (two chunks): 3 warm
   steps, the p50 and p90 of 20 timed steps (host clock to the loss on the
   host), a trace of 3 more split by ``train/forward``, ``train/backward``
   and ``train/optimizer``, the idle share, peak memory, the first and
   last loss, and the bound (the weight GEMMs' 8·N·T and the attention's
   operations at the bf16 and fp32 peaks of ``hw``, against the bytes of
   parameters, gradients and moments); then the embedding's gradient
   twice on one batch, bitwise; (b) every other arch at published width,
   depth cut only for memory (``LM_TRAIN_ARCHS``, each cut on its own
   line; llama4-maverick not at all: one layer is over the card), bf16
   AdamW state where the reference picks it (over 30 B parameters): 3
   steps at b = 8, s = 64, every loss finite, every parameter free of NaN
   and every leaf not pinned by bf16 rounding (an element below 0.125)
   changed; (c) every arch's ``reduced()`` fp32 model
   with the same weights and batch on the card and on the CPU: the loss
   and every gradient leaf within ``CPU_TOL``, the card's gradients twice
   bitwise (smollm also with a tied head); (d) smollm reduced: 6 steps
   through ``run_train_loop`` bitwise 3, a restore and 3 more. Numbers
   also go to ``chiprun_out/lm_phase13.json``.
14. The LM mesh and the cell builder (``repro_torch.launch.steps``,
   ``layers.flash_decode_sharded``; no hand kernel) on a (2, 2)
   ("data", "model") mesh of four positions on the card: (a) llama3-8b,
   all 32 layers, through ``build_cell("llama3-8b", "decode_32k",
   mesh)``, its 32,768-slot KV cache (16,384 a sequence shard) filled
   from a seed to 16,380, then 8 decode steps across the shards'
   boundary on the cell and on the mesh-less ``decode_step`` over a copy
   of the same cache; in bf16 at b = 4 (the batch of 128 cut): layer 0's
   sharded attention within twice the mesh-less attention's error
   against fp32, greedy tokens equal (a token that differs is logged
   with its top-2 margin and fails unless that margin is within twice
   the row's |diff|), the logits' gap logged (two bf16 paths drift apart
   over 32 random layers), decode ms a token (p50, a sync each step)
   beside the bound (weights and cache read once at ``hw.HBM_BW``), ATen ops
   a step, the bytes its copies of a cache shard write (no more than the
   mesh-less step's) and peak memory; in fp32 at b = 2: logits and the
   written slots within ``rtol 2e-4, atol 2e-4``; (b) qwen3-4b,
   pixtral-12b, phi3.5-moe (8 of 32 layers), zamba2-1.2b (its shared
   attention) and whisper-small (the cross-attention over a 1,500-frame
   memory, 750 a shard) at published width in fp32, b = 4, a 4,096-slot
   cache filled to 2,044: 8 steps against their mesh-less decode within
   ``rtol 2e-4, atol 2e-4`` (MoE: the steps that route alike);
   rwkv6-7b (no ``decode_ctx``, the hook only) bitwise; (c) every arch's
   ``reduced()`` fp32 decode cell on the card against the same cell on
   a CPU mesh within ``CPU_TOL`` and against the mesh-less decode within
   ``rtol 2e-4, atol 2e-4``; (d) smollm-360m's train cell, all 32
   layers, ``train_4k`` cut to b = 8, s = 256: 3 steps with ``n_micro``
   1 and 3 with 2 from the same parameters and batches, losses within
   1e-2, step p50 of each. (The production mesh's ``lower()`` runs in
   phase 15, through the dry run.) Numbers also go to
   ``chiprun_out/lm_phase14.json``.
15. The analysis and the dry run (``repro_torch.analysis``,
   ``repro_torch.launch.dryrun``; no hand kernel, nothing on the card):
   the card's name, power limit and ``total_memory`` beside
   ``hw.HBM_BYTES``; then ``dryrun.run_cell`` on whisper-small's
   ``train_4k``, ``prefill_32k`` and ``decode_32k`` (pod), zamba2-1.2b's
   ``long_500k`` (pod and multipod) and phi3.5-moe's ``decode_32k``
   (multipod), one worker process each, side by side, each the trace
   of the split step (one batch row run, the others counted by
   symmetry): each record's three roofline terms, ``dominant``,
   ``fits_hbm``, ``n_ops``, ``lower_s`` and ``collective_breakdown``;
   any record not ``ok`` or not ``"trace": "split"``, a train or prefill
   cell with neither ``fsdp_gather`` nor ``tp_reduce`` bytes, or a decode
   cell with no bytes but the ``merge``'s fails the run. Records also go
   to ``chiprun_out/dryrun/`` and ``chiprun_out/dryrun_phase15.json``.
16. Split weights (``Cell.place_params``,
   ``repro_torch.distributed.tensor_parallel``; no hand kernel) on phase
   14's (2, 2) mesh of four positions on cuda:0: (a) and (b), run inside
   phase 14 on (a)'s llama3-8b ``decode_32k`` cells and their 32,768-slot
   caches before they are freed, bf16 at b = 4 (TP only) and fp32 at
   b = 2 (TP × FSDP): 8 steps of phase 14's unsplit cell, the split cell
   from the same cache index and the mesh-less step, each to a sync, then
   queued; bf16 holds layer 0's block and the head to phase 14's error
   ratio against fp32 and the greedy tokens up to near ties, fp32 the
   logits to ``MESH_DECODE_TOL``; ATen ops a step of each path and the
   split step's bytes between positions by kind, peak memory; (a) also
   holds ``lower()``, the dry run's meta trace of the cell cut to b = 4,
   to one split step on the card at the trace's cache index: every
   position's bytes by kind, and the busiest position's, equal
   (``trace_vs_card``). (c)
   llama3-8b's prefill cell (TP × FSDP) at b = 4, s = 512: bf16 split and
   mesh-less prefill p50, ops, bytes by kind; fp32 split logits within
   ``MESH_DECODE_TOL`` of the mesh-less prefill's. (d) phi3.5-moe at
   depth 8 (TP × FSDP, experts over ``model``), a 4,096-slot cache: bf16,
   the three paths from one cache state a step, timed, and layer 0's
   experts held to fp32 by the error ratio; fp32, split and mesh-less
   steps within ``MESH_DECODE_TOL`` where the routing agrees, failing if
   it agrees on no step. (e) the ten archs' ``reduced()`` fp32 prefill
   and decode cells placed on the card and on a CPU mesh (rwkv6's and
   zamba2's state caches placed too): within ``CPU_TOL`` of the CPU and
   ``MESH_DECODE_TOL`` of the card's mesh-less step. (f) rwkv6-7b and
   zamba2-1.2b at published width and depth, ``decode_32k`` cut to b =
   4, parameters and state caches split, from a split prefill of 16
   tokens: bf16, split and mesh-less steps to a sync and queued, ATen
   ops, bytes between positions by kind, peak memory, layer 0's
   recurrent block and the head held to fp32 by phase 14's error ratio;
   fp32, split within ``MESH_DECODE_TOL`` of mesh-less over 8 steps,
   greedy tokens equal up to near ties. (g) smollm-360m's ``train_4k``
   (all 32 layers, pure FSDP) at b = 8, s = 256 and (h) llama3-8b's
   (depth 4, TP × FSDP) at b = 4, s = 512, parameters placed: one split
   step held to the unsplit step in fp32 (loss, ``grad_norm``, every
   gradient, params, m and v within ``TRAIN_SPLIT_TOL``), then 3 bf16
   steps each split, unsplit and mesh-less to a sync, ATen ops a step,
   bytes between positions by kind (the forward's alone too), peak
   memory, the step's bound; (h) also holds its ``lower()`` trace to
   one more split step as (a) does. (i) rwkv6-7b's ``train_4k`` (depth
   2 of 32) and (j) zamba2-1.2b's (depth 7 of 38: one full chunk of 6
   with its shared block and a tail layer), both TP × FSDP at b = 4,
   s = 64, as (h), their ``lower()`` traces too (a row's two head sites
   scanned as one, ``TensorParallel.scan_sites``): their losses start
   every recurrent layer from zero states and place no state cache
   (``state`` moves 0 bytes); (i) draws rwkv6's ``u`` from N(0, 0.5²),
   since at the init's zeros layer 0's ``u`` gradient is
   ill-conditioned in fp32 (``split_train_cell``).
   Numbers also go to ``chiprun_out/lm_phase16.json``.
"""

from __future__ import annotations

import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
if str(SRC) not in sys.path:
    sys.path.insert(0, str(SRC))

# every rate of the bounds below: the H100 SXM data sheet's, at 700 W
from repro_torch.analysis import hw  # noqa: E402
FM_TOL = dict(rtol=1e-5, atol=1e-5)
LADDER_TOL = dict(rtol=1e-5, atol=1e-6)
# GEMMs with K up to 2272 summed in another order by cuBLAS and the CPU BLAS
CPU_TOL = dict(rtol=1e-4, atol=1e-5)
SEED = 0
LATENCY_WARMUP, LATENCY_SAMPLES = 3, 60   # p80 has 12 samples beyond it
CACHE_CAPACITY = 65_536     # the reference's serve default (serve.py:267)
STAGING_CAPACITY = 65_536   # >= b*k = 39,936 at b = 1024: no batch overflows
OVERFLOW_STAGING = 256      # the reference's default, max(4*k*h, 256)
HOT = 5                     # ids per field of the pooled (multi-hot) forms
REFRESH_EVERY, DELTA_ROWS = 8, 1_024
Q8_SCORE_GATE = 1e-2        # per-score |int8 - fp32| (accuracy_parity.py:13)
# Fig. 11's sweep (benchmarks/workload_allocation.py:24-28): k = 39 fields
# of 100,000 rows, uniform ids, (b, d)
FIG11_FIELDS, FIG11_ROWS = 39, 100_000
FIG11_CASES = ((2048, 32), (16_384, 32), (65_536, 32), (2048, 60))
MISALIGNED_FIG11 = (2048, 60)   # K1 and K8 also on a view 4 bytes in
ONEHOT_MAX_ROWS, ONEHOT_PAD = 128, 128  # Criteo's fields of <= 128 rows
ONEHOT_BAD_IDS = (-1, ONEHOT_PAD, 10**6, -2**31, 2**31 - 1)  # zero rows
# phase 9: rows per wave of the sync engines (every bucket of the ladder
# full and partial), the overflow run's shorter traffic, the reference
# CLI's ladder (serve.py --buckets) and the async runs' requests
SERVE_LADDER = (64, 256, 1024)
SERVE_WAVES = (1300, 350, 2048, 90, 1100, 300, 1024, 70)
OVERFLOW_WAVES = (300, 90)
CLI_LADDER = (16, 32, 64, 128, 256)
ASYNC_REQUESTS, ASYNC_THREADS = 2048, 4
FUTURE_TIMEOUT_S = 120.0
# phase 10: training (``examples/train_ctr.py``: AdamW lr 1e-3, b = 1024,
# 300 steps, an 8,192-row validation batch at step 10,000)
TRAIN_STEPS, TRAIN_BATCH, TRAIN_LR = 300, 1024, 1e-3
VAL_STEP, VAL_ROWS = 10_000, 8192
TRAIN_SMALL_FIELD = 2_000   # the scaled schema of (b) and (d)
STEP_TIMES, TRACE_STEPS = 50, 5


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def device_ms(torch, fn, arg_sets, iters: int = 100) -> float:
    """Device time of one ``fn`` call, from CUDA events around ``iters``
    calls that cycle through ``arg_sets`` (enough sets that their bytes
    exceed the 50 MB L2, so each call finds its inputs in device memory).
    A sleep kernel queued first keeps the device busy while the host
    enqueues, so host launch cost does not pad the measurement."""
    for args in arg_sets:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_busy(device_events) -> tuple[float, float]:
    """(busy µs: the union of the events' intervals, window µs)."""
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in device_events)
    busy, cur = 0.0, spans[0][0]
    for a, b in spans:
        if b > cur:
            busy += b - max(a, cur)
            cur = b
    return busy, spans[-1][1] - spans[0][0]


def n_sets(bytes_per_set: int) -> int:
    return max(2, min(32, math.ceil(120e6 / max(bytes_per_set, 1))))


def bound(bytes_moved: float, flops: float,
          ops_per_s: float = hw.PEAK_FLOPS_FP32) -> tuple[float, str]:
    t_bytes = bytes_moved / hw.HBM_BW * 1e3
    t_ops = flops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def recorder(rows: list):
    """``record(...)``: append one kernel measurement to ``rows`` (one
    dict per kernel and shape) and log it."""
    def record(name, shape, err, ms, plain_ms, lib_ms, bytes_moved, flops,
               ops_per_s=hw.PEAK_FLOPS_FP32):
        b_ms, b_by = bound(bytes_moved, flops, ops_per_s)
        rows.append(dict(name=name, shape=shape, max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=b_ms, bound_by=b_by))
        lib = "n/a" if lib_ms is None else f"{lib_ms:.5f}"
        log(f"[kernels] {name} {shape}: max|kernel-plain|={err:.3e} "
            f"ms={ms:.5f} plain_ms={plain_ms:.5f} library_ms={lib} "
            f"bound_ms={b_ms:.5f} ({b_by})")
    return record


def launch_sweep(torch, table, offsets, sets, shape: str) -> None:
    """Time K1 at one and two rows a thread and K8, each at 32, 64, 128
    and 256 threads a block, by calling their C entries with each launch
    shape (every one checked bitwise against the plain version first):
    the measurements behind ``gather_launch`` and ``input_first_launch``.
    ``sets`` hold the ids first."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import multi_table_lookup as mtl

    ids0 = sets[0][0]
    b, k = ids0.shape
    n_rows, d = table.shape
    stream = _build.current_stream(table.device)
    vec = mtl.vector_words(d, table.data_ptr())
    lanes = mtl.gather_launch(b, k, d, vec).lanes

    def k1(rows, threads):
        blocks = math.ceil(math.ceil(b * k / rows) * lanes / threads)

        def run(ids, *_):
            out = torch.empty((b, k * d), device=table.device)
            code = mtl._kernel()(
                ids.data_ptr(), offsets.data_ptr(), table.data_ptr(),
                out.data_ptr(), b, k, d, n_rows, int(vec),
                lanes.bit_length() - 1, rows, threads, blocks, stream)
            assert code == 0, code
            return out
        return run

    def k8(threads):
        def run(ids, *_):
            out = torch.empty((k, b, d), device=table.device)
            code = mtl._input_first_kernel()(
                ids.data_ptr(), offsets.data_ptr(), table.data_ptr(),
                out.data_ptr(), b, k, d, n_rows, int(vec), threads,
                math.ceil(b * k / threads), stream)
            assert code == 0, code
            return out
        return run

    want = mtl.mtl_gather_plain(ids0, offsets, table)
    want_f = mtl.mtl_input_first_plain(ids0, offsets, table,
                                       field_major=True)
    t1, t8 = {}, {}
    for threads in (32, 64, 128, 256):
        for rows in (1, 2):
            assert torch.equal(k1(rows, threads)(ids0), want), shape
            t1[f"r{rows}t{threads}"] = round(
                device_ms(torch, k1(rows, threads), sets) * 1e3, 2)
        assert torch.equal(k8(threads)(ids0), want_f), shape
        t8[f"t{threads}"] = round(device_ms(torch, k8(threads), sets) * 1e3,
                                  2)
    k1_pick = mtl.gather_launch(b, k, d, vec)
    k8_pick = mtl.input_first_launch(b, k, vec)
    log(f"[sweep] {shape}: mtl_gather us {t1} (picked r{k1_pick.rows}"
        f"t{k1_pick.threads}); mtl_input_first us {t8} (picked "
        f"t{k8_pick.threads})")


def onehot_sweep(torch, stacked, sets, shape: str) -> None:
    """Time K7 at one and two rows a thread, each at 32, 64, 128 and 256
    threads a block, by calling its C entry with each launch shape (every
    one checked bitwise against the plain version first): the
    measurements behind ``onehot_launch``'s rows a thread and
    ``ONEHOT_THREADS``. ``sets`` hold the ids first."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import multi_table_lookup as mtl

    ids0 = sets[0][0]
    b, k = ids0.shape
    _, n_pad, d = stacked.shape
    el = stacked.element_size()
    stream = _build.current_stream(stacked.device)
    pick = mtl.onehot_launch(b, k, d, mtl.onehot_word(
        d, el, stacked.data_ptr(), 0), el)

    def k7(rows, threads):
        launch = pick._replace(rows=rows, threads=threads, blocks=mtl._grid(
            math.ceil(b * k / rows) * pick.lanes, threads))

        def run(ids):
            out = torch.empty((b, k, d), dtype=stacked.dtype,
                              device=stacked.device)
            assert out.data_ptr() % 16 == 0
            code = mtl._onehot_kernel()(
                ids.data_ptr(), stacked.data_ptr(), out.data_ptr(), b, k,
                n_pad, d, el, *mtl._onehot_args(launch), stream)
            assert code == 0, code
            return out
        return run

    want = mtl.mtl_onehot_plain(ids0, stacked)
    times = {}
    for threads in (32, 64, 128, 256):
        for rows in (1, 2):
            assert same_bits(torch, k7(rows, threads)(ids0), want), \
                (shape, rows, threads)
            times[f"r{rows}t{threads}"] = round(
                device_ms(torch, k7(rows, threads), sets) * 1e3, 2)
    log(f"[sweep] mtl_onehot {shape}: us {times} (picked r{pick.rows}"
        f"t{pick.threads}, word {pick.word}, {pick.lanes} lanes)")


def same_bits(torch, a, b) -> bool:
    """Bitwise equal float32 or bfloat16 tensors (+0.0 and -0.0 differ);
    no NaN."""
    bits = {4: torch.int32, 2: torch.int16}[a.element_size()]
    return a.dtype == b.dtype and torch.equal(a.view(bits), b.view(bits))


def entry_call(torch, name, offsets, tensors, sizes, b, k, h, d):
    """``with_launch`` for :func:`tiered_sweep`: ``with_launch(launch)``
    gives a call of K2–K6's C entry ``name`` on ``(ids, mask, offsets,
    *tensors, out, b, k, h, d, *sizes)`` with that launch."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import multi_table_lookup as mtl

    dev = offsets.device
    stream = _build.current_stream(dev)

    def with_launch(launch):
        args = mtl._tiered_args(launch)
        entry = mtl._tiered(name, 4 + len(tensors),
                            4 + len(sizes) + len(args))

        def run(i, m, rows):
            out = torch.empty((b, k * d), device=dev)
            code = entry(i.data_ptr(), mtl._ptr(m), offsets.data_ptr(),
                         *(t.data_ptr() for t in tensors), out.data_ptr(),
                         b, k, h, d, *sizes, *args, stream)
            assert code == 0, (name, code)
            return out
        return run
    return with_launch


def tiered_sweep(torch, name, with_launch, want, sets, b, k, h, d,
                 shape: str) -> None:
    """Time K2–K6 (``name``) at each launch of their sweep: K2, K3 and K5
    with their floats loaded as 16-byte words and one by one (the 4-byte
    path's loads, here on aligned tiers) at 64, 128 and 256 threads a
    block; K4
    and K6 with their codes loaded as 4-byte words and byte by byte (the
    byte path's loads) at 32, 64, 128 and 256. ``with_launch(launch)``
    gives a call of the C entry with that launch, each checked bitwise
    against ``want`` (the plain version on ``sets[0]``) first. The
    measurements behind ``tiered_launch``."""
    from repro_torch.kernels import multi_table_lookup as mtl

    words, sizes = ((4, 1), (32, 64, 128, 256)) if name.endswith("_q8") \
        else ((16, 4), (64, 128, 256))
    times = {}
    for word in words:
        for threads in sizes:
            launch = mtl.tiered_launch(b, k, h, d, word)
            launch = launch._replace(threads=threads, blocks=mtl._grid(
                b * k * launch.lanes, threads))
            fn = with_launch(launch)
            assert same_bits(torch, fn(*sets[0]), want), (name, shape, launch)
            times[f"w{word}t{threads}"] = round(
                device_ms(torch, fn, sets) * 1e3, 2)
    log(f"[sweep] {name} {shape}: us {times} (picked w{words[0]}"
        f"t{mtl.TIERED_THREADS})")


def byte_offset(torch, t, offset: int = 1):
    """``t`` copied into a view ``offset`` bytes past a 16-byte boundary of
    its storage: an int8 tier 1 byte in, which the kernels must read code
    by code, or an fp32 table or tier 4 bytes in, which they must read a
    float at a time."""
    el = t.element_size()
    assert offset % el == 0, (t.dtype, offset)
    buf = torch.empty(t.numel() + 32 // el, dtype=t.dtype, device=t.device)
    start = ((-buf.data_ptr()) % 16 + offset) // el
    view = buf[start:start + t.numel()].view(t.shape)
    view.copy_(t)
    assert view.data_ptr() % 16 == offset
    return view


def fm_case(torch, sets, record, shape: str) -> None:
    """K11 on ``sets[0]`` within ``FM_TOL`` of its plain version, then
    timed over ``sets`` beside the plain version and its bound; its launch
    logged."""
    from repro_torch.kernels.fused_fm import (
        fm_launch, fused_fm_second_order, fused_fm_second_order_plain)

    v0 = sets[0][0]
    b, k, d = v0.shape
    out = fused_fm_second_order(v0)
    want = fused_fm_second_order_plain(v0)
    torch.testing.assert_close(out, want, **FM_TOL)
    record("fused_fm_second_order", shape, (out - want).abs().max().item(),
           device_ms(torch, fused_fm_second_order, sets),
           device_ms(torch, fused_fm_second_order_plain, sets), None,
           b * k * d * 4 + b * 4, 4 * b * k * d)
    log(f"[launch] fused_fm_second_order {shape}: "
        f"{fm_launch(b, d, v0.data_ptr() % 16 == 0)}")


def fm_sweep(torch, sets, shape: str) -> None:
    """Time K11 at 32, 64, 128 and 256 threads a block by calling its C
    entry with each (every setting within ``FM_TOL`` of the plain version
    first): the measurements behind ``FM_THREADS``."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import fused_fm as fm

    v0 = sets[0][0]
    b, k, d = v0.shape
    stream = _build.current_stream(v0.device)
    launch = fm.fm_launch(b, d, v0.data_ptr() % 16 == 0)
    want = fm.fused_fm_second_order_plain(v0)
    times = {}
    for threads in (32, 64, 128, 256):
        def run(v, threads=threads):
            out = torch.empty((b, 1), device=v.device)
            code = fm._kernel()(v.data_ptr(), out.data_ptr(), b, k, d,
                                int(launch.vec),
                                launch.lanes.bit_length() - 1, threads,
                                math.ceil(b * 32 / threads), stream)
            assert code == 0, code
            return out
        torch.testing.assert_close(run(v0), want, **FM_TOL)
        times[f"t{threads}"] = round(device_ms(torch, run, sets) * 1e3, 2)
    log(f"[sweep] fused_fm_second_order {shape}: us {times} (picked "
        f"t{launch.threads})")


def cross_sets(torch, dev, g, kind, b, dim, offset=0, same=False, n=None):
    """Input sets of K9 (``kind`` "v2": ``(x0, xw_plus, x)``) or K10
    ("v1": ``(x0, xlw, bias, x)``) at (b, dim), enough that their bytes
    exceed the L2 (or ``n``): the (b, dim) operands and the bias
    ``offset`` bytes past a 16-byte boundary of their storage, ``x`` the
    tensor ``x0`` where ``same`` (layer 0)."""
    def make(shape, off=offset):
        return byte_offset(torch, torch.randn(shape, device=dev, generator=g),
                           off)
    sets = []
    for _ in range(n or n_sets((4 if kind == "v2" else 3) * b * dim * 4)):
        x0 = make((b, dim))
        x = x0 if same else make((b, dim))
        sets.append((x0, make((b, dim)), x) if kind == "v2"
                    else (x0, make((b, 1), 0), make((dim,)), x))
    return sets


def cross_fns(kind):
    """K9's or K10's wrapper, plain version and C entry."""
    from repro_torch.kernels import fused_cross as fc
    if kind == "v2":
        return fc.fused_cross_v2, fc.fused_cross_v2_plain, fc._v2_kernel()
    return fc.fused_cross_v1, fc.fused_cross_v1_plain, fc._v1_kernel()


def cross_aligned(args) -> bool:
    """Whether K9's or K10's operands (all but K10's ``xlw``) are 16-byte
    aligned, as the wrappers ask."""
    tensors = args if len(args) == 3 else (args[0], args[2], args[3])
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def cross_case(torch, kind, sets, record, shape: str) -> None:
    """K9 or K10 on ``sets[0]`` bitwise its plain version, then timed over
    ``sets`` beside the plain version, ``addcmul`` (K9) and its bound; its
    launch logged. In layer 0 (``x`` is ``x0``) one load stream fewer."""
    from repro_torch.kernels.fused_cross import cross_launch

    fn, plain, _ = cross_fns(kind)
    args = sets[0]
    x0 = args[0]
    b, dim = x0.shape
    out, want = fn(*args), plain(*args)
    assert same_bits(torch, out, want), (kind, shape)
    reads = (3 if kind == "v2" else 2) \
        - int(args[-1].data_ptr() == x0.data_ptr())
    moved = (reads + 1) * b * dim * 4 + (0 if kind == "v2" else
                                         b * 4 + dim * 4)
    lib_ms = None
    if kind == "v2":
        lib_ms = device_ms(torch, lambda a, w, x: torch.addcmul(x, a, w),
                           sets)
    record(f"fused_cross_{kind}", shape, (out - want).abs().max().item(),
           device_ms(torch, fn, sets), device_ms(torch, plain, sets), lib_ms,
           moved, (2 if kind == "v2" else 3) * b * dim)
    log(f"[launch] fused_cross_{kind} {shape}: "
        f"{cross_launch(b, dim, cross_aligned(args))}")


def cross_sweep(torch, kind, sets, shape: str) -> None:
    """Time K9 or K10 at 1, 2, 4 pieces a thread and 32-256 threads a
    block by calling its C entry with each launch (every one bitwise its
    plain version first): the measurements behind ``cross_launch``."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import fused_cross as fc

    _, plain, entry = cross_fns(kind)
    args = sets[0]
    x0 = args[0]
    b, dim = x0.shape
    stream = _build.current_stream(x0.device)
    picked = fc.cross_launch(b, dim, cross_aligned(args))
    pieces = b * dim // (4 if picked.vec else 1)
    want = plain(*args)
    times = {}
    for words in (1, 2, 4):
        for threads in (32, 64, 128, 256):
            launch = picked._replace(rows=words, threads=threads,
                                     blocks=math.ceil(pieces
                                                      / (words * threads)))

            def run(*a, launch=launch):
                out = torch.empty_like(a[0])
                code = entry(*(t.data_ptr() for t in a), out.data_ptr(), b,
                             dim, int(a[-1].data_ptr() == a[0].data_ptr()),
                             *fc.launch_args(launch), stream)
                assert code == 0, code
                return out
            assert same_bits(torch, run(*args), want), (kind, shape, launch)
            times[f"w{words}t{threads}"] = round(
                device_ms(torch, run, sets) * 1e3, 2)
    log(f"[sweep] fused_cross_{kind} {shape}: us {times} (picked "
        f"w{picked.rows}t{picked.threads})")


def cross_nan_inf(torch, kind, args) -> None:
    """K9 or K10 with NaN, inf and -inf in every operand: NaN where the
    plain version has NaN, its bits everywhere else."""
    fn, plain, _ = cross_fns(kind)
    args = [t.clone() for t in args]
    x0 = args[0]
    x0[0, 0], x0[5, 7], x0[9, -1] = float("nan"), float("inf"), float("-inf")
    args[1][17, -1] = float("inf")       # xw_plus, or xlw's whole row
    args[1 if kind == "v2" else 2][-1] = float("nan")   # a row, a column
    args[-1][100, 100] = float("-inf")
    got, want = fn(*args), plain(*args)
    nan = want.isnan()
    assert torch.equal(got.isnan(), nan) and nan.any(), kind
    assert same_bits(torch, got.masked_fill(nan, 0), want.masked_fill(nan, 0))
    log(f"[kernels] fused_cross_{kind} b=256: NaN, inf and -inf entries give "
        f"the plain version's bits ({int(nan.sum())} NaN, "
        f"{int(want.isinf().sum())} inf)")


def phase_kernels(torch, dev, table32, table1, offsets, schema, sample_ids,
                  record):
    from repro_torch.kernels.fused_fm import (
        fused_fm_second_order, fused_fm_second_order_plain)
    from repro_torch.kernels.multi_table_lookup import (
        gather_launch, mtl_gather, mtl_gather_plain, vector_words)

    k = schema.k
    g = torch.Generator(device=dev).manual_seed(SEED + 1)

    for b in (256, 1024):
        # K1 at d = 32 (main table) and d = 1 (wide / FM tables)
        for table in (table32, table1):
            d = table.shape[1]
            sets = []
            for s in range(n_sets(2 * b * k * d * 4)):
                ids = torch.from_numpy(sample_ids(schema, b, step=s)).to(dev)
                flat = (ids.long() + offsets.long()[None, :]).reshape(-1)
                sets.append((ids, flat))
            ids0 = sets[0][0]
            out = mtl_gather(ids0, offsets, table)
            want = mtl_gather_plain(ids0, offsets, table)
            assert torch.equal(out, want), f"mtl_gather d={d} b={b}"
            bad = ids0.clone()
            bad[0, :3] = torch.tensor([-7, 2**31 - 1, 10**8], device=dev)
            assert torch.equal(mtl_gather(bad, offsets, table),
                               mtl_gather_plain(bad, offsets, table)), \
                "out-of-range ids"
            err = (out - want).abs().max().item()
            ms = device_ms(torch, lambda i, f: mtl_gather(i, offsets, table),
                           sets)
            plain_ms = device_ms(
                torch, lambda i, f: mtl_gather_plain(i, offsets, table), sets)
            lib_ms = device_ms(
                torch, lambda i, f: torch.index_select(table, 0, f), sets)
            uniq = torch.unique(sets[0][1]).numel()
            moved = b * k * 4 + k * 4 + uniq * d * 4 + b * k * d * 4
            record("mtl_gather", f"b={b},k={k},d={d}", err, ms, plain_ms,
                   lib_ms, moved, 0)
            log(f"[launch] mtl_gather b={b},k={k},d={d}: "
                f"{gather_launch(b, k, d, vector_words(d, table.data_ptr()))}")
            if d == 1:
                launch_sweep(torch, table, offsets, sets, f"b={b},k={k},d=1")

        dim = k * 32
        # K9 fused_cross_v2 and K10 fused_cross_v1: the main path's form,
        # layer 0 (x is x0), the 4-byte path (operands 4 bytes into their
        # storage) and a float a piece (D = 117), then the launch sweep
        for kind in ("v2", "v1"):
            sets = cross_sets(torch, dev, g, kind, b, dim)
            cross_case(torch, kind, sets, record, f"b={b},D={dim}")
            cross_sweep(torch, kind, sets, f"b={b},D={dim}")
            cross_case(torch, kind,
                       cross_sets(torch, dev, g, kind, b, dim, same=True),
                       record, f"b={b},D={dim},layer0")
            cross_case(torch, kind,
                       cross_sets(torch, dev, g, kind, b, dim, offset=4),
                       record, f"b={b},D={dim},misaligned")
            cross_case(torch, kind, cross_sets(torch, dev, g, kind, b, 117),
                       record, f"b={b},D=117")

        # K11 fused_fm_second_order on embedding-scale values, then its
        # launch sweep
        sets = [(torch.randn((b, k, 32), device=dev, generator=g) * 0.05,)
                for _ in range(n_sets(b * k * 32 * 4))]
        fm_case(torch, sets, record, f"b={b},k={k},d=32")
        fm_sweep(torch, sets, f"b={b},k={k},d=32")

    # K9/K10 at b = 1, and on NaN, inf and -inf entries
    for kind in ("v2", "v1"):
        cross_case(torch, kind, cross_sets(torch, dev, g, kind, 1, k * 32),
                   record, f"b=1,D={k * 32}")
        cross_nan_inf(torch, kind, cross_sets(torch, dev, g, kind, 256,
                                              k * 32, n=1)[0])

    # K11's other paths: a float a lane (d = 1, 3; a v 4 bytes into its
    # storage), a partial last group (d = 3, 60), one row; then NaN and
    # inf rows
    for b, d, offset in ((1024, 1, 0), (1024, 3, 0), (1024, 60, 0),
                         (1024, 32, 4), (1, 32, 0)):
        sets = [(byte_offset(torch, torch.randn(
            (b, k, d), device=dev, generator=g) * 0.05, offset),)
            for _ in range(n_sets(b * k * d * 4))]
        fm_case(torch, sets, record, f"b={b},k={k},d={d}"
                + (",misaligned" if offset else ""))
    clean = torch.randn((256, k, 32), device=dev, generator=g) * 0.05
    v = clean.clone()
    bad = [3, 10, 11]
    v[3, 5, 7], v[10, 0, 31], v[11, 38, 0] = (float("nan"), float("inf"),
                                              float("-inf"))
    got, want = fused_fm_second_order(v), fused_fm_second_order_plain(v)
    rows = torch.zeros(256, dtype=torch.bool, device=dev)
    rows[bad] = True
    assert got[rows].isnan().all() and want[rows].isnan().all(), \
        "fused_fm_second_order: NaN/inf rows"
    assert same_bits(torch, got[~rows], fused_fm_second_order(clean)[~rows])
    torch.testing.assert_close(got[~rows], want[~rows], **FM_TOL)
    log(f"[kernels] fused_fm_second_order b=256: rows {bad} holding NaN, "
        f"inf, -inf give NaN (kernel and plain), the other 253 rows "
        f"bitwise their values without them")


def phase_q8_kernels(torch, dev, record):
    """K12 ``dmm_q8`` (int8 ``wgmma`` fed by TMA) at DCNv2's MLP shapes
    (1248 -> 1024 and 1024 -> 1024) at b = 256 and 1024, ReLU on and off,
    plus (1, 1, 1), (33, 7, 5), (200, 1248, 1000) (M and N off every
    tile), an ``hq`` view 3 bytes into its storage (padded by the wrapper)
    and codes of ±127 at fan_in 1248 (the largest |acc|, 127² · 1248 >
    2**24): bitwise against its plain version on the card and on the CPU;
    timed (ReLU on, as the plan runs it) beside the plain version,
    ``torch._int_mm`` (the int32 product only: no PyTorch call has the
    epilogue) and, for information, the fp32 ``addmm`` + ReLU of the fp32
    plan."""
    from repro_torch.kernels.dense_matmul import (dmm_q8, dmm_q8_plain,
                                                  pack_weight)
    from repro_torch.quant import absmax_scale, quantize, quantize_channels

    g = torch.Generator(device=dev).manual_seed(SEED + 6)

    def make(b, fan_in, fan_out, saturate=False):
        h = torch.randn((b, fan_in), device=dev, generator=g)
        w = torch.randn((fan_in, fan_out), device=dev, generator=g) * 0.03
        if saturate:
            h = torch.where(h >= 0, 1.0, -1.0)
            w = torch.where(w >= 0, 0.03, -0.03)
            w[:, 0] = 0.03 * h[0]
        hs = absmax_scale(h)
        wq, ws = quantize_channels(w)
        bias = torch.randn((1, fan_out), device=dev, generator=g) * 0.1
        return (quantize(h, hs), hs, pack_weight(wq), ws, bias), (h, w)

    def check(args, relu, tag):
        out = dmm_q8(*args, relu=relu)
        want = dmm_q8_plain(*args, relu=relu)
        assert torch.equal(out, want), f"dmm_q8 {tag} relu={relu}"
        cpu = dmm_q8_plain(*[a.cpu() for a in args], relu=relu)
        assert torch.equal(out.cpu(), cpu), f"dmm_q8 {tag} vs CPU"
        return (out - want).abs().max().item()

    for b, fan_in, fan_out, sat in ((1, 1, 1, False), (33, 7, 5, False),
                                    (200, 1248, 1000, False),
                                    (256, 1248, 1024, True)):
        args, _ = make(b, fan_in, fan_out, sat)
        for relu in (True, False):
            check(args, relu, f"{(b, fan_in, fan_out)}")
        if sat:
            acc = int(args[0][0].cpu().long() @ args[2][0].cpu().long())
            assert acc == 127 * 127 * fan_in > 2**24, acc
            log(f"[q8] codes of ±127 at fan_in {fan_in}: |acc| = {acc} > "
                f"2**24, bitwise against the plain version (card and CPU)")
    log("[q8] (1, 1, 1), (33, 7, 5) and (200, 1248, 1000): bitwise, ReLU "
        "on and off")
    args, _ = make(200, 1248, 96)
    buf = torch.zeros(3 + args[0].numel(), dtype=torch.int8, device=dev)
    view = buf[3:].view(args[0].shape)
    view.copy_(args[0])
    before = dmm_q8.launches
    out = dmm_q8(view, *args[1:])
    assert dmm_q8.launches == before + 1
    assert torch.equal(out, dmm_q8_plain(*args)), "dmm_q8 offset view"
    log("[q8] an hq view 3 bytes into its storage: launched, bitwise")

    for b in (256, 1024):
        for fan_in in (1248, 1024):
            fan_out = 1024
            per_set = b * fan_in + fan_in * fan_out + 4 * b * fan_out
            sets, fp32 = [], []
            for _ in range(n_sets(per_set)):
                args, (h, w) = make(b, fan_in, fan_out)
                sets.append(args)
                fp32.append((args[4], h, w))
            err = max(check(sets[0], relu, f"b={b},in={fan_in}")
                      for relu in (True, False))
            ms = device_ms(torch, lambda *a: dmm_q8(*a, relu=True), sets)
            plain_ms = device_ms(
                torch, lambda *a: dmm_q8_plain(*a, relu=True), sets)
            lib_ms = device_ms(
                torch, lambda hq, hs, wq_t, ws, bias: torch._int_mm(
                    hq, wq_t.t()), sets)
            fp32_ms = device_ms(
                torch, lambda bias, h, w: torch.relu(torch.addmm(bias, h, w)),
                fp32)
            moved = b * fan_in + b * 4 + fan_in * fan_out + 2 * fan_out * 4 \
                + b * fan_out * 4
            shape = f"b={b},in={fan_in},out={fan_out}"
            record("dmm_q8", shape, err, ms, plain_ms, lib_ms, moved,
                   2 * b * fan_in * fan_out, hw.PEAK_OPS_INT8)
            log(f"[q8] {shape}: library_ms is torch._int_mm, the int32 "
                f"product only; the fp32 plan's addmm + relu takes "
                f"{fp32_ms:.5f} ms")


def phase_quantizer(torch, dev, record):
    """``quantize_rows_q8``, the int8 MLP's activation quantizer, at the
    MLP's shapes (b = 256 and 1024, fan_in 1248 and 1024) on activations of
    mixed row scales with an all-zero row and a row of half-way values
    (every other ``x / scale`` is ``k + 0.5``): codes and scales bitwise
    against the plain version on the card and on the CPU; timed beside the
    plain version, which is the ~10-op path the int8 plan ran before (no
    single PyTorch call quantizes per row, so ``library_ms`` is none)."""
    from repro_torch.kernels.quantize import (quantize_rows_q8,
                                              quantize_rows_q8_plain)

    g = torch.Generator(device=dev).manual_seed(SEED + 7)

    def make(b, fan_in):
        h = torch.randn((b, fan_in), device=dev, generator=g) * (
            torch.rand((b, 1), device=dev, generator=g) * 10 + 1e-3)
        h[1] = 0.0
        half = ((torch.arange(fan_in, device=dev) % 254) - 126.5) / 16
        h[2] = half
        h[2, 0] = 127 / 16
        return h

    for b in (256, 1024):
        for fan_in in (1248, 1024):
            sets = [(make(b, fan_in),)
                    for _ in range(n_sets(5 * b * fan_in + 4 * b))]
            h = sets[0][0]
            hq, hs = quantize_rows_q8(h)
            want_q, want_s = quantize_rows_q8_plain(h)
            assert torch.equal(hq, want_q) and torch.equal(hs, want_s), \
                f"quantize_rows_q8 b={b},in={fan_in}"
            cpu_q, cpu_s = quantize_rows_q8_plain(h.cpu())
            assert torch.equal(hq.cpu(), cpu_q) and \
                torch.equal(hs.cpu(), cpu_s), "quantize_rows_q8 vs CPU"
            assert hs[1, 0].item() == torch.tensor(1e-12).item() \
                and not hq[1].any(), "zero row"
            assert hs[2, 0].item() == 1 / 16 and \
                hq[2, 1].item() == -126, "half-way row"
            err = max((hq.float() - want_q.float()).abs().max().item(),
                      (hs - want_s).abs().max().item())
            shape = f"b={b},in={fan_in}"
            ms = device_ms(torch, quantize_rows_q8, sets)
            plain_ms = device_ms(torch, quantize_rows_q8_plain, sets)
            record("quantize_rows_q8", shape, err, ms, plain_ms, None,
                   4 * b * fan_in + b * fan_in + 4 * b, 3 * b * fan_in)
            log(f"[quant] {shape}: library_ms none (the plain version is "
                f"the ~10-op path: {plain_ms:.5f} ms)")

    # rows holding a NaN and an inf at fan_in 1248: the scale is NaN for
    # the NaN row (the plain version's amax and clamp_min propagate it) and
    # inf for the inf row, codes 0 in both, as on the CPU; K12 then gives
    # both rows NaN outputs through its ReLU, and every other value stays
    # bitwise the plain version's
    from repro_torch.kernels.dense_matmul import (dmm_q8, dmm_q8_plain,
                                                  pack_weight)
    from repro_torch.quant import quantize_channels
    h = make(256, 1248)
    h[3, 5] = float("nan")
    h[4, 0] = float("inf")
    hq, hs = quantize_rows_q8(h)
    want_q, want_s = quantize_rows_q8_plain(h)
    cpu_q, cpu_s = quantize_rows_q8_plain(h.cpu())
    nan = torch.isnan(hs)
    assert nan[:, 0].nonzero().flatten().tolist() == [3], "NaN scale"
    assert torch.equal(nan, torch.isnan(want_s)) and \
        torch.equal(nan.cpu(), torch.isnan(cpu_s)), "NaN scale vs plain"
    assert torch.equal(hs[~nan].view(torch.int32),
                       want_s[~nan].view(torch.int32)), "scales vs plain"
    assert torch.equal(hs.cpu()[~nan.cpu()].view(torch.int32),
                       cpu_s[~nan.cpu()].view(torch.int32)), "scales vs CPU"
    assert math.isinf(hs[4, 0].item()), "inf scale"
    assert torch.equal(hq.cpu(), cpu_q) and not hq[3:5].any(), "codes vs CPU"
    wq, ws = quantize_channels(torch.randn((1248, 1024), device=dev,
                                           generator=g))
    bias = torch.randn((1, 1024), device=dev, generator=g)
    out = dmm_q8(hq, hs, pack_weight(wq), ws, bias)
    want = dmm_q8_plain(hq, hs, pack_weight(wq), ws, bias)
    rows = torch.isnan(out).all(dim=1)
    assert rows.nonzero().flatten().tolist() == [3, 4], "K12 NaN rows"
    assert not torch.isnan(out[~rows]).any() and \
        torch.equal(out[~rows], want[~rows]) and \
        torch.isnan(want[rows]).all(), "K12 vs plain"
    log(f"[quant] NaN row: scale {hs[3, 0].item()}, codes all 0, K12 row "
        f"all NaN; inf row: scale {hs[4, 0].item()}, K12 row all NaN; the "
        f"other 254 rows bitwise the plain version")


def phase_lookup_variants(torch, dev, emb, schema, sample_ids,
                          record) -> dict:
    """K8 ``mtl_input_first`` at Fig. 11's shapes and on the full Criteo
    table, and K7 ``mtl_onehot`` over Criteo's 18 fields of at most 128
    rows padded to 128 (fp32 and bf16; d = 1, 3 and misaligned views at
    b = 1024; b = 1; K7's launch sweep at b = 256 and 1024 and on the
    views): bitwise against their plain versions, K8 against K1 and K7
    (fp32) against a K1 gather of the same rows; timed. Then each one's
    path with the counters reset just before and read just after: K8
    through ``FusedEmbeddingCollection.forward(strategy="input_first")``,
    K7 through ``ops.multi_table_lookup_onehot``. Returns their launches
    there."""
    import numpy as np

    from repro_torch.embedding import (FusedEmbeddingCollection,
                                       FusedEmbeddingSpec)
    from repro_torch.kernels import launch_counts, ops, reset_launch_counts
    from repro_torch.kernels.multi_table_lookup import (
        gather_launch, input_first_launch, mtl_gather, mtl_gather_plain,
        mtl_input_first, mtl_input_first_plain, mtl_onehot, mtl_onehot_plain,
        vector_words)

    def lookup_sets(ids_list, offsets):
        """(ids, field-major rows, sample-major rows) per batch of ids: the
        rows ``index_select`` takes to build K8's and K1's outputs."""
        sets = []
        for ids in ids_list:
            rows = ids.long() + offsets.long()[None, :]
            sets.append((ids, rows.t().reshape(-1), rows.reshape(-1)))
        return sets

    def k8_case(table, offsets, sets, shape, k1_too: bool):
        """Check K8 and K1 on ``sets[0]``, bitwise, and time them: K8 alone
        (its (k, b, d) buffer) and with the transpose, K1 beside it; each
        beside its plain version and ``index_select`` on its own row
        order. ``k1_too`` records K1's row as well."""
        ids0 = sets[0][0]
        b, k = ids0.shape
        d = table.shape[1]
        out = mtl_input_first(ids0, offsets, table)
        assert torch.equal(out, mtl_input_first_plain(ids0, offsets, table))
        assert torch.equal(out, mtl_gather(ids0, offsets, table)), shape
        assert torch.equal(out, mtl_gather_plain(ids0, offsets, table))
        assert torch.equal(mtl_input_first(ids0, offsets, table,
                                           field_major=True),
                           mtl_input_first_plain(ids0, offsets, table,
                                                 field_major=True))
        kernel_ms = device_ms(torch, lambda i, fr, r: mtl_input_first(
            i, offsets, table, field_major=True), sets)
        full_ms = device_ms(torch, lambda i, fr, r: mtl_input_first(
            i, offsets, table), sets)
        k1_ms = device_ms(torch, lambda i, fr, r: mtl_gather(
            i, offsets, table), sets)
        plain_ms = device_ms(torch, lambda i, fr, r: mtl_input_first_plain(
            i, offsets, table, field_major=True), sets)
        lib_ms = device_ms(torch, lambda i, fr, r: torch.index_select(
            table, 0, fr), sets)
        uniq = torch.unique(sets[0][1]).numel()
        moved = b * k * 4 + k * 4 + uniq * d * 4 + b * k * d * 4
        record("mtl_input_first", shape, 0.0, kernel_ms, plain_ms, lib_ms,
               moved, 0)
        vec = vector_words(d, table.data_ptr())
        if k1_too:
            record("mtl_gather", shape, 0.0, k1_ms,
                   device_ms(torch, lambda i, fr, r: mtl_gather_plain(
                       i, offsets, table), sets),
                   device_ms(torch, lambda i, fr, r: torch.index_select(
                       table, 0, r), sets), moved, 0)
        log(f"[launch] {shape}: mtl_gather {gather_launch(b, k, d, vec)}, "
            f"mtl_input_first {input_first_launch(b, k, vec)}")
        launch_sweep(torch, table, offsets, sets, shape)
        log(f"[fig11] {shape}: input-first kernel {kernel_ms:.5f} ms, with "
            f"its transpose {full_ms:.5f} ms; output-first K1 {k1_ms:.5f} "
            f"ms; input-first / output-first = {full_ms / k1_ms:.3f} "
            f"(kernel alone {kernel_ms / k1_ms:.3f})")

    # Fig. 11: k = 39 fields of 100,000 rows, uniform ids
    rng = np.random.default_rng(SEED)
    for b, d in FIG11_CASES:
        spec = FusedEmbeddingSpec(field_sizes=(FIG11_ROWS,) * FIG11_FIELDS,
                                  dim=d)
        coll = FusedEmbeddingCollection(spec, device=dev)
        coll.store.reset_parameters(
            torch.Generator(device=dev).manual_seed(SEED))
        table, offsets = coll.dense_view(), coll.offsets
        sets = lookup_sets([torch.from_numpy(rng.integers(
            0, FIG11_ROWS, size=(b, FIG11_FIELDS)).astype(np.int32)).to(dev)
            for _ in range(n_sets(2 * b * FIG11_FIELDS * d * 4))], offsets)
        shape = f"b={b},k={FIG11_FIELDS},d={d},fig11"
        k8_case(table, offsets, sets, shape, k1_too=True)
        if (b, d) == MISALIGNED_FIG11:
            view = byte_offset(torch, table, 4)    # K1's and K8's 4-byte path
            del coll, table
            k8_case(view, offsets, sets, shape + ",misaligned", k1_too=True)
            del view
        else:
            del coll, table
        del sets
        torch.cuda.empty_cache()

    # the full Criteo table
    table, offsets = emb.dense_view(), emb.offsets
    k = schema.k
    view = byte_offset(torch, table, 4)
    for b in (256, 1024):
        sets = lookup_sets([torch.from_numpy(
            sample_ids(schema, b, step=55_000 + s)).to(dev)
            for s in range(n_sets(2 * b * k * 32 * 4))], offsets)
        bad = sets[0][0].clone()
        bad[0, :3] = torch.tensor([-7, 2**31 - 1, 10**8], device=dev)
        for t in (table, view):
            assert torch.equal(mtl_input_first(bad, offsets, t),
                               mtl_gather(bad, offsets, t)), "clamped ids"
            assert torch.equal(mtl_gather(bad, offsets, t),
                               mtl_gather_plain(bad, offsets, t))
        # K1 at Criteo's shapes is the kernel phase's row
        k8_case(table, offsets, sets, f"b={b},k={k},d=32", k1_too=False)
        if b == 1024:
            k8_case(view, offsets, sets, f"b={b},k={k},d=32,misaligned",
                    k1_too=True)
    del view
    torch.cuda.empty_cache()

    # K7 over Criteo's small fields, rows taken from the main table
    small = [f for f, n in enumerate(schema.field_sizes)
             if n <= ONEHOT_MAX_ROWS]
    sizes = [schema.field_sizes[f] for f in small]
    offs = [int(emb.spec.offsets[f]) for f in small]
    ks = len(small)
    stacked32 = torch.zeros((ks, ONEHOT_PAD, 32), device=dev)
    for j, (o, n) in enumerate(zip(offs, sizes)):
        stacked32[j, :n] = table[o:o + n]
    small_offsets = torch.tensor(offs, dtype=torch.int32, device=dev)
    small_idx = torch.tensor(small, device=dev)
    field = torch.arange(ks, device=dev)[None, :]
    log(f"[onehot] {ks} Criteo fields of at most {ONEHOT_MAX_ROWS} rows "
        f"(sizes {min(sizes)}-{max(sizes)}), padded to n_pad = {ONEHOT_PAD}")

    def onehot_case(stacked, sets, shape, sweep=False):
        """Check K7 on ``sets[0]`` bitwise against its plain version, its
        out-of-range ids giving +0.0 rows, and time it beside the plain
        version and ``stacked[field, ids]``; ``sweep`` also runs
        :func:`onehot_sweep`."""
        ids0 = sets[0][0]
        b = ids0.shape[0]
        d, el = stacked.shape[2], stacked.element_size()
        out = mtl_onehot(ids0, stacked)
        assert same_bits(torch, out, mtl_onehot_plain(ids0, stacked)), shape
        bad = ids0.clone()
        bad[0, :len(ONEHOT_BAD_IDS)] = torch.tensor(ONEHOT_BAD_IDS,
                                                    device=dev)
        got = mtl_onehot(bad, stacked)
        assert same_bits(torch, got, mtl_onehot_plain(bad, stacked)), shape
        assert same_bits(torch, got[0, :len(ONEHOT_BAD_IDS)], torch.zeros(
            (len(ONEHOT_BAD_IDS), d), dtype=stacked.dtype, device=dev)), \
            "out-of-range ids give +0.0 rows"
        uniq = torch.unique(ids0.long() * ks + field).numel()
        record("mtl_onehot", shape, 0.0,
               device_ms(torch, lambda i: mtl_onehot(i, stacked), sets),
               device_ms(torch, lambda i: mtl_onehot_plain(i, stacked),
                         sets),
               device_ms(torch, lambda i: stacked[field, i.long()], sets),
               b * ks * 4 + uniq * d * el + b * ks * d * el, 0)
        if sweep:
            onehot_sweep(torch, stacked, sets, shape)
        return out

    gen = torch.Generator(device=dev).manual_seed(SEED)
    narrow = {}                     # d = 1 and 3 tables, rows past a field 0
    for d in (1, 3):
        t = torch.randn((ks, ONEHOT_PAD, d), generator=gen, device=dev)
        for j, n in enumerate(sizes):
            t[j, n:] = 0
        narrow[d] = t
    for b in (1, 256, 1024):
        sets = []
        for s in range(n_sets(2 * b * ks * 32 * 4)):
            ids = torch.from_numpy(sample_ids(schema, b, step=56_000 + s)
                                   ).to(dev).index_select(1, small_idx)
            sets.append((ids.contiguous(),))
        ids0 = sets[0][0]
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            stacked = stacked32.to(dtype)
            shape = f"b={b},k={ks},n_pad={ONEHOT_PAD},d=32,{name}"
            out = onehot_case(stacked, sets, shape, sweep=b > 1)
            if dtype == torch.float32:
                assert torch.equal(out.reshape(b, -1), mtl_gather(
                    ids0, small_offsets, table)), "K7 != K1 gather"
            if b < 1024:
                continue
            # the narrower words: a view 4 bytes (bf16: also 2 bytes) into
            # its storage, and d = 1 and 3
            for offset in (4, 2) if dtype == torch.bfloat16 else (4,):
                view = byte_offset(torch, stacked, offset)
                onehot_case(view, sets, f"{shape},misaligned{offset}",
                            sweep=True)
                del view
            for d, t in narrow.items():
                onehot_case(t.to(dtype), sets,
                            f"b={b},k={ks},n_pad={ONEHOT_PAD},d={d},{name}")
        del sets

    # each lookup's path, counters reset just before and read just after
    batches = [torch.from_numpy(sample_ids(schema, b, step=57_000 + r)
                                ).to(dev) for b in (256, 1024)
               for r in range(8)]
    torch.cuda.synchronize()
    reset_launch_counts()
    for ids in batches:
        out = emb(ids, strategy="input_first")
        assert out.shape == (ids.shape[0], k * 32)
    for ids in batches:
        for stacked in (stacked32, stacked32.to(torch.bfloat16)):
            out = ops.multi_table_lookup_onehot(
                ids.index_select(1, small_idx).contiguous(), stacked)
            assert out.shape == (ids.shape[0], ks, 32)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["mtl_input_first"] == len(batches), counts
    assert counts["mtl_onehot"] == 2 * len(batches), counts
    assert counts["mtl_gather"] == 0, counts
    for ids in batches[::8]:
        assert torch.equal(emb(ids, strategy="input_first"), emb(ids))
    log(f"[lookups] {len(batches)} lookups (b = 256, 1024) through "
        f"FusedEmbeddingCollection.forward(strategy=\"input_first\") and "
        f"{2 * len(batches)} through ops.multi_table_lookup_onehot (fp32, "
        f"bf16): launches {counts}")
    return {"mtl_input_first": counts["mtl_input_first"],
            "mtl_onehot": counts["mtl_onehot"]}


def slot_ids(schema, sample_ids, b: int, h: int, step: int):
    """(b, k, h) int32 ids: h independent draws of the schema's traffic."""
    ids = sample_ids(schema, b * h, step=step)
    return ids.reshape(b, h, schema.k).transpose(0, 2, 1).copy()


def phase_tiered_kernels(torch, dev, emb, schema, sample_ids, record):
    """K2, K3 and K4 on the full-width table of collection ``emb`` under a
    65,536-row cache (fp32 and int8), against their plain versions and
    K1, timed; K3 and K4 also on a cold cache, K2 on a copy of the table
    and K3 on an fp32 cache 4 bytes into their storage (their 4-byte
    path), K4 on int8 tiers 1 byte into their storage (its byte path),
    and K2's, K3's and K4's launch sweeps."""
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.embedding import CachedStore
    from repro_torch.kernels import multi_table_lookup as mtl
    from repro_torch.kernels.multi_table_lookup import (
        mtl_gather, mtl_gather_multihot, mtl_gather_multihot_plain,
        mtl_gather_two_level, mtl_gather_two_level_plain,
        mtl_gather_two_level_q8, mtl_gather_two_level_q8_plain)

    table32, offsets, spec = emb.dense_view(), emb.offsets, emb.spec
    k, d = spec.k, spec.dim
    n_rows = spec.rows
    warm = sample_ids(schema, 16_384, step=50_000)      # quadratic skew
    stores = {}
    for row_dtype in (None, "int8"):
        store = CachedStore(spec, CACHE_CAPACITY, row_dtype, device=dev)
        store.from_dense({"mega_table": table32})
        store.observe(warm + spec.offsets[None, :])
        store.refresh()
        stores[row_dtype] = store
        log(f"[tiered] {store.describe()}: hot set from one refresh over "
            f"{warm.shape[0]} quadratic-skew rows, cached traffic "
            f"{store.cached_traffic_fraction:.3f}")
    f32, q8 = stores[None], stores["int8"]
    assert torch.equal(f32.backing, table32)
    rng = np.random.default_rng(SEED + 2)

    def k2(i, m, rows):
        return mtl_gather_multihot(i, m, offsets, table32)

    def k2_plain(i, m, rows):
        return mtl_gather_multihot_plain(i, m, offsets, table32)

    def k3(i, m, rows):
        return mtl_gather_two_level(i, offsets, f32.slot_of_row, f32.cache,
                                    f32.backing, mask=m)

    def k3_plain(i, m, rows):
        return mtl_gather_two_level_plain(i, offsets, f32.slot_of_row,
                                          f32.cache, f32.backing, mask=m)

    def k4(i, m, rows):
        return mtl_gather_two_level_q8(i, offsets, q8.slot_of_row, q8.cache,
                                       q8.cache_scale, q8.backing,
                                       q8.backing_scale, mask=m)

    def k4_plain(i, m, rows):
        return mtl_gather_two_level_q8_plain(
            i, offsets, q8.slot_of_row, q8.cache, q8.cache_scale,
            q8.backing, q8.backing_scale, mask=m)

    # K3's miss path: a cold cache holding rows 0..C-1 (the map before any
    # refresh), so nearly every slot of this traffic reads the backing
    cold_map = torch.full((n_rows,), -1, dtype=torch.int32, device=dev)
    cold_map[:CACHE_CAPACITY] = torch.arange(CACHE_CAPACITY,
                                             dtype=torch.int32, device=dev)
    cold_cache = table32[:CACHE_CAPACITY].clone()

    def k3_cold(i, m, rows):
        return mtl_gather_two_level(i, offsets, cold_map, cold_cache,
                                    table32, mask=m)

    def k3_cold_plain(i, m, rows):
        return mtl_gather_two_level_plain(i, offsets, cold_map, cold_cache,
                                          table32, mask=m)

    # K2's 4-byte path: a copy of the table 4 bytes into its storage
    odd_table = byte_offset(torch, table32, 4)
    assert mtl.tier_word(d, 4, odd_table.data_ptr()) == 4

    def k2_odd(i, m, rows):
        return mtl_gather_multihot(i, m, offsets, odd_table)

    def k2_odd_plain(i, m, rows):
        return mtl_gather_multihot_plain(i, m, offsets, odd_table)

    # K3's 4-byte path: the fp32 cache 4 bytes into its storage (one tier
    # off 16 bytes is enough; the 851 MB backing stays where it is)
    odd32 = byte_offset(torch, f32.cache, 4)
    assert mtl.tier_word(d, 4, odd32.data_ptr(), f32.backing.data_ptr()) == 4

    def k3_odd(i, m, rows):
        return mtl_gather_two_level(i, offsets, f32.slot_of_row, odd32,
                                    f32.backing, mask=m)

    def k3_odd_plain(i, m, rows):
        return mtl_gather_two_level_plain(i, offsets, f32.slot_of_row, odd32,
                                          f32.backing, mask=m)

    # K4's miss path: the same cold map over the int8 tiers (the 213 MB
    # backing); and its byte path: every int8 tier 1 byte into its storage
    cold_q8 = (q8.backing[:CACHE_CAPACITY].clone(),
               q8.backing_scale[:CACHE_CAPACITY].clone())
    odd_cache, odd_backing = (byte_offset(torch, q8.cache),
                              byte_offset(torch, q8.backing))
    assert mtl.tier_word(d, 1, odd_cache.data_ptr(),
                         odd_backing.data_ptr()) == 1

    def k4_cold(i, m, rows):
        return mtl_gather_two_level_q8(i, offsets, cold_map, *cold_q8,
                                       q8.backing, q8.backing_scale, mask=m)

    def k4_cold_plain(i, m, rows):
        return mtl_gather_two_level_q8_plain(
            i, offsets, cold_map, *cold_q8, q8.backing, q8.backing_scale,
            mask=m)

    def k4_odd(i, m, rows):
        return mtl_gather_two_level_q8(i, offsets, q8.slot_of_row,
                                       odd_cache, q8.cache_scale,
                                       odd_backing, q8.backing_scale, mask=m)

    def k4_odd_plain(i, m, rows):
        return mtl_gather_two_level_q8_plain(
            i, offsets, q8.slot_of_row, odd_cache, q8.cache_scale,
            odd_backing, q8.backing_scale, mask=m)

    def bag(table):                          # one pooled PyTorch call
        return lambda i, m, rows: F.embedding_bag(rows, table, mode="sum")

    def take(i, m, rows):
        return torch.index_select(f32.backing, 0, rows.reshape(-1))

    for b in (256, 1024):
        for h in (1, HOT):
            sets = []
            for s in range(n_sets(2 * b * k * h * d * 4)):
                if h == 1:
                    ids = torch.from_numpy(sample_ids(
                        schema, b, step=51_000 + s)).to(dev)
                    mask = None
                else:
                    ids = torch.from_numpy(slot_ids(
                        schema, sample_ids, b, h, 52_000 + s)).to(dev)
                    mask = torch.from_numpy(rng.integers(
                        0, 2, size=(b, k, h)).astype(np.float32)).to(dev)
                rows = ids.long().reshape(b, k, h) \
                    + offsets.long()[None, :, None]
                if mask is not None:
                    rows = torch.where(mask != 0, rows, n_rows - 1)
                sets.append((ids, mask, rows.reshape(b * k, h)))
            ids0, mask0, rows0 = sets[0]
            bad = ids0.clone()
            bad.view(b, k, h)[0, :3, 0] = torch.tensor(
                [-7, 2**31 - 1, 10**8], dtype=torch.int32, device=dev)
            outs = {}
            for name, fn, plain in (("mtl_gather_multihot", k2, k2_plain),
                                    ("mtl_gather_two_level", k3, k3_plain),
                                    ("mtl_gather_two_level_q8", k4,
                                     k4_plain)):
                out = fn(ids0, mask0, rows0)
                want = plain(ids0, mask0, rows0)
                assert torch.equal(out, want), f"{name} b={b} h={h}"
                assert torch.equal(fn(bad, mask0, rows0),
                                   plain(bad, mask0, rows0)), \
                    f"{name} out-of-range ids"
                outs[name] = out
            # a cache row is a copy of its backing row: K3 == K2, and at
            # h = 1 K2 == K3 == K1
            assert torch.equal(outs["mtl_gather_two_level"],
                               outs["mtl_gather_multihot"])
            if h == 1:
                assert torch.equal(outs["mtl_gather_multihot"],
                                   mtl_gather(ids0, offsets, table32))
            uniq = torch.unique(rows0).numel()
            hits = int((f32.slot_of_row.index_select(
                0, rows0.reshape(-1)) >= 0).sum())
            ids_bytes = b * k * h * 4 * (1 if mask0 is None else 2) + k * 4
            out_bytes = b * k * d * 4
            shape = f"b={b},k={k},d={d},h={h}"
            log(f"[tiered] {shape}: {uniq} distinct rows, cache hits "
                f"{hits / rows0.numel():.3f} of {rows0.numel()} slots")
            for name, fn, plain, lib, row_bytes in (
                    ("mtl_gather_multihot", k2, k2_plain, bag(table32),
                     4 * d),
                    ("mtl_gather_two_level", k3, k3_plain,
                     take if h == 1 else bag(f32.backing), 4 + 4 * d),
                    ("mtl_gather_two_level_q8", k4, k4_plain, None,
                     4 + d + 4)):
                record(name, shape, 0.0, device_ms(torch, fn, sets),
                       device_ms(torch, plain, sets),
                       None if lib is None else device_ms(torch, lib, sets),
                       ids_bytes + uniq * row_bytes + out_bytes, 0)
            if h == 1:
                out = k3_cold(ids0, mask0, rows0)
                assert torch.equal(out, k3_cold_plain(ids0, mask0, rows0))
                assert torch.equal(out, outs["mtl_gather_two_level"])
                hits = int((cold_map.index_select(0, rows0.reshape(-1))
                            >= 0).sum())
                log(f"[tiered] {shape}, cold cache: hits "
                    f"{hits / rows0.numel():.3f} of {rows0.numel()} slots")
                record("mtl_gather_two_level", shape + ",cold", 0.0,
                       device_ms(torch, k3_cold, sets),
                       device_ms(torch, k3_cold_plain, sets),
                       device_ms(torch, take, sets),
                       ids_bytes + uniq * (4 + 4 * d) + out_bytes, 0)
                out = k4_cold(ids0, mask0, rows0)
                assert same_bits(torch, out, k4_cold_plain(ids0, mask0,
                                                           rows0))
                assert same_bits(torch, out, outs["mtl_gather_two_level_q8"])
                record("mtl_gather_two_level_q8", shape + ",cold", 0.0,
                       device_ms(torch, k4_cold, sets),
                       device_ms(torch, k4_cold_plain, sets), None,
                       ids_bytes + uniq * (4 + d + 4) + out_bytes, 0)
            # the 4-byte paths, bitwise the plain versions and the aligned
            # table or cache; then the launch sweeps
            out = k2_odd(ids0, mask0, rows0)
            assert torch.equal(out, outs["mtl_gather_multihot"])
            assert torch.equal(out, k2_odd_plain(ids0, mask0, rows0))
            record("mtl_gather_multihot", shape + ",misaligned", 0.0,
                   device_ms(torch, k2_odd, sets),
                   device_ms(torch, k2_odd_plain, sets),
                   device_ms(torch, bag(odd_table), sets),
                   ids_bytes + uniq * 4 * d + out_bytes, 0)
            tiered_sweep(torch, "mtl_gather_multihot", entry_call(
                torch, "mtl_gather_multihot", offsets, (table32,),
                (n_rows, 0, n_rows), b, k, h, d),
                outs["mtl_gather_multihot"], sets, b, k, h, d, shape)
            out = k3_odd(ids0, mask0, rows0)
            assert torch.equal(out, outs["mtl_gather_two_level"])
            assert torch.equal(out, k3_odd_plain(ids0, mask0, rows0))
            record("mtl_gather_two_level", shape + ",misaligned", 0.0,
                   device_ms(torch, k3_odd, sets),
                   device_ms(torch, k3_odd_plain, sets),
                   device_ms(torch, take if h == 1 else bag(f32.backing),
                             sets),
                   ids_bytes + uniq * (4 + 4 * d) + out_bytes, 0)
            tiered_sweep(torch, "mtl_gather_two_level", entry_call(
                torch, "mtl_gather_two_level", offsets,
                (f32.slot_of_row, f32.cache, f32.backing),
                (f32.cache.shape[0], n_rows, 0, n_rows), b, k, h, d),
                outs["mtl_gather_two_level"], sets, b, k, h, d, shape)
            # the byte path, bitwise the plain version and the aligned tiers
            out = k4_odd(ids0, mask0, rows0)
            assert same_bits(torch, out, outs["mtl_gather_two_level_q8"])
            assert same_bits(torch, out, k4_odd_plain(ids0, mask0, rows0))
            record("mtl_gather_two_level_q8", shape + ",misaligned", 0.0,
                   device_ms(torch, k4_odd, sets),
                   device_ms(torch, k4_odd_plain, sets), None,
                   ids_bytes + uniq * (4 + d + 4) + out_bytes, 0)
            tiered_sweep(torch, "mtl_gather_two_level_q8", entry_call(
                torch, "mtl_gather_two_level_q8", offsets,
                (q8.slot_of_row, q8.cache, q8.cache_scale, q8.backing,
                 q8.backing_scale), (q8.cache.shape[0], n_rows, 0, n_rows),
                b, k, h, d),
                outs["mtl_gather_two_level_q8"], sets, b, k, h, d, shape)
    del stores, f32, q8, cold_map, cold_cache, cold_q8, odd_table, odd32, \
        odd_cache, odd_backing
    torch.cuda.empty_cache()


def phase_host_kernels(torch, dev, emb, schema, sample_ids, record):
    """K5 and K6 on the full-width table of collection ``emb`` under a
    65,536-row cache whose hot set comes from one observe + refresh of a
    fp32 ``HostBackedStore``, with every miss of the timed batches staged
    (fp32 and int8 tiers), against their plain versions, K1/K2 and K4,
    timed; K5 also on fp32 tiers 4 bytes into their storage (its 4-byte
    path), K6 on int8 tiers 1 byte into their storage (its byte path), and
    K5's and K6's launch sweeps."""
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.embedding import HostBackedStore
    from repro_torch.kernels.multi_table_lookup import (
        mtl_gather, mtl_gather_multihot, mtl_gather_three_level,
        mtl_gather_three_level_plain, mtl_gather_three_level_q8,
        mtl_gather_three_level_q8_plain, mtl_gather_two_level_q8)
    from repro_torch.quant import quantize_rows

    table32, offsets, spec = emb.dense_view(), emb.offsets, emb.spec
    k, d, n_rows = spec.k, spec.dim, spec.rows
    store = HostBackedStore(spec, CACHE_CAPACITY, STAGING_CAPACITY,
                            device=dev)
    store.from_dense({"mega_table": table32})
    store.observe(sample_ids(schema, 16_384, step=50_000)
                  + spec.offsets[None, :])
    store.refresh()
    slot_of_row, cache = store.slot_of_row, store.cache
    hot = np.flatnonzero(store._slot_of_row >= 0)
    cached_rows = torch.from_numpy(
        hot[np.argsort(store._slot_of_row[hot])]).to(dev)
    log(f"[host-kernels] {store.describe()}: hot set from one refresh, "
        f"cached traffic {store.cached_traffic_fraction:.3f}")
    del store
    q, scale = quantize_rows(table32)
    qcache = q.index_select(0, cached_rows)
    qcscale = scale.index_select(0, cached_rows)
    odd_qcache = byte_offset(torch, qcache)
    odd_cache = byte_offset(torch, cache, 4)
    rng = np.random.default_rng(SEED + 5)

    def staged_tiers(rows):
        """Staging map and tiers holding every uncached row of ``rows``."""
        rows = torch.unique(rows)
        miss = rows[slot_of_row.index_select(0, rows) < 0]
        smap = torch.full((n_rows,), -1, dtype=torch.int32, device=dev)
        smap[miss] = torch.arange(miss.numel(), dtype=torch.int32,
                                  device=dev)
        return (smap, table32.index_select(0, miss),
                q.index_select(0, miss), scale.index_select(0, miss))

    for b in (256, 1024):
        for h in (1, HOT):
            sets = []
            for s in range(n_sets(2 * b * k * h * d * 4)):
                if h == 1:
                    ids = torch.from_numpy(sample_ids(
                        schema, b, step=53_000 + s)).to(dev)
                    mask = None
                else:
                    ids = torch.from_numpy(slot_ids(
                        schema, sample_ids, b, h, 54_000 + s)).to(dev)
                    mask = torch.from_numpy(rng.integers(
                        0, 2, size=(b, k, h)).astype(np.float32)).to(dev)
                rows = ids.long().reshape(b, k, h) \
                    + offsets.long()[None, :, None]
                if mask is not None:
                    rows = torch.where(mask != 0, rows, n_rows - 1)
                sets.append((ids, mask, rows.reshape(b * k, h)))
            smap, staging, qstaging, qsscale = staged_tiers(
                torch.cat([r.reshape(-1) for _, _, r in sets]))

            def k5(i, m, rows, som=slot_of_row, sm=smap):
                return mtl_gather_three_level(i, offsets, som, sm, cache,
                                              staging, mask=m)

            def k5_plain(i, m, rows, som=slot_of_row, sm=smap):
                return mtl_gather_three_level_plain(i, offsets, som, sm,
                                                    cache, staging, mask=m)

            def k6(i, m, rows, som=slot_of_row, sm=smap):
                return mtl_gather_three_level_q8(i, offsets, som, sm, qcache,
                                                 qcscale, qstaging, qsscale,
                                                 mask=m)

            def k6_plain(i, m, rows, som=slot_of_row, sm=smap):
                return mtl_gather_three_level_q8_plain(
                    i, offsets, som, sm, qcache, qcscale, qstaging, qsscale,
                    mask=m)

            odd_staging = byte_offset(torch, staging, 4)
            odd_qstaging = byte_offset(torch, qstaging)

            def k5_odd(i, m, rows, sm=smap, st=odd_staging):
                return mtl_gather_three_level(i, offsets, slot_of_row, sm,
                                              odd_cache, st, mask=m)

            def k5_odd_plain(i, m, rows, sm=smap, st=odd_staging):
                return mtl_gather_three_level_plain(i, offsets, slot_of_row,
                                                    sm, odd_cache, st, mask=m)

            def k6_odd(i, m, rows, sm=smap, qs=odd_qstaging):
                return mtl_gather_three_level_q8(i, offsets, slot_of_row, sm,
                                                 odd_qcache, qcscale, qs,
                                                 qsscale, mask=m)

            def k6_odd_plain(i, m, rows, sm=smap, qs=odd_qstaging):
                return mtl_gather_three_level_q8_plain(
                    i, offsets, slot_of_row, sm, odd_qcache, qcscale, qs,
                    qsscale, mask=m)

            ids0, mask0, rows0 = sets[0]
            bad = ids0.clone()
            bad.view(b, k, h)[0, :3, 0] = torch.tensor(
                [-7, 2**31 - 1, 10**8], dtype=torch.int32, device=dev)
            for name, fn, plain in (("mtl_gather_three_level", k5, k5_plain),
                                    ("mtl_gather_three_level_q8", k6,
                                     k6_plain)):
                out = fn(ids0, mask0, rows0)
                assert torch.equal(out, plain(ids0, mask0, rows0)), \
                    f"{name} b={b} h={h}"
                assert torch.equal(fn(bad, mask0, rows0),
                                   plain(bad, mask0, rows0)), \
                    f"{name} out-of-range ids"
            # every row resolves: K5 is K1 (h = 1) and K2 (pooled) on the
            # dense table, and K6 is K4 on the int8 table
            k5_out = k5(ids0, mask0, rows0)
            if h == 1:
                assert torch.equal(k5_out, mtl_gather(ids0, offsets, table32))
            assert torch.equal(k5_out, mtl_gather_multihot(ids0, mask0,
                                                           offsets, table32))
            assert torch.equal(k6(ids0, mask0, rows0), mtl_gather_two_level_q8(
                ids0, offsets, slot_of_row, qcache, qcscale, q, scale,
                mask=mask0))
            if h == 1:
                # a cache slot past C, a staging slot past S and a row
                # staged nowhere: all three read exactly 0.0
                flat = rows0.reshape(-1)
                hit = slot_of_row.index_select(0, flat) >= 0
                r_c = int(flat[hit][0])
                staged_rows = flat[~hit]
                r_s, r_n = int(staged_rows[0]), int(
                    staged_rows[staged_rows != staged_rows[0]][0])
                som2, smap2 = slot_of_row.clone(), smap.clone()
                som2[r_c] = CACHE_CAPACITY + 5
                smap2[r_s] = staging.shape[0] + 5
                smap2[r_n] = -1
                gone = torch.isin(flat, torch.tensor([r_c, r_s, r_n],
                                                     device=dev))
                for name, fn, plain in (
                        ("mtl_gather_three_level", k5, k5_plain),
                        ("mtl_gather_three_level_q8", k6, k6_plain)):
                    out = fn(bad, None, rows0, som2, smap2)
                    assert torch.equal(out, plain(bad, None, rows0, som2,
                                                  smap2)), f"{name} tiers"
                    out = fn(ids0, None, rows0, som2, smap2).view(b * k, d)
                    assert torch.all(out[gone] == 0.0) \
                        and not torch.signbit(out[gone]).any(), name
                    assert bool((out[~gone].abs().sum(dim=1) > 0).all()), name
            uniq = torch.unique(rows0)
            n_miss = int((slot_of_row.index_select(0, uniq) < 0).sum())
            hits = int((slot_of_row.index_select(0, rows0.reshape(-1))
                        >= 0).sum())
            ids_bytes = b * k * h * 4 * (1 if mask0 is None else 2) + k * 4
            out_bytes = b * k * d * 4
            shape = f"b={b},k={k},d={d},h={h}"
            log(f"[host-kernels] {shape}: {uniq.numel()} distinct rows, "
                f"{n_miss} staged; cache hits {hits / rows0.numel():.3f} of "
                f"{rows0.numel()} slots; staging holds {staging.shape[0]} "
                f"rows for {len(sets)} timed batches")
            # each distinct row: its cache slot, on a miss its staging slot
            maps = uniq.numel() * 4 + n_miss * 4
            lib = (lambda i, m, rows: torch.index_select(
                       table32, 0, rows.reshape(-1))) if h == 1 else \
                (lambda i, m, rows: F.embedding_bag(rows, table32,
                                                    mode="sum"))
            for name, fn, plain, lib_fn, row_bytes in (
                    ("mtl_gather_three_level", k5, k5_plain, lib, 4 * d),
                    ("mtl_gather_three_level_q8", k6, k6_plain, None, d + 4)):
                record(name, shape, 0.0, device_ms(torch, fn, sets),
                       device_ms(torch, plain, sets),
                       None if lib_fn is None else device_ms(torch, lib_fn,
                                                             sets),
                       ids_bytes + maps + uniq.numel() * row_bytes
                       + out_bytes, 0)
            # the 4-byte path, bitwise the plain version and the aligned
            # tiers; then the launch sweep
            want = k5(ids0, mask0, rows0)
            out = k5_odd(ids0, mask0, rows0)
            assert torch.equal(out, want)
            assert torch.equal(out, k5_odd_plain(ids0, mask0, rows0))
            record("mtl_gather_three_level", shape + ",misaligned", 0.0,
                   device_ms(torch, k5_odd, sets),
                   device_ms(torch, k5_odd_plain, sets),
                   device_ms(torch, lib, sets),
                   ids_bytes + maps + uniq.numel() * 4 * d + out_bytes, 0)
            tiered_sweep(torch, "mtl_gather_three_level", entry_call(
                torch, "mtl_gather_three_level", offsets,
                (slot_of_row, smap, cache, staging),
                (cache.shape[0], staging.shape[0], n_rows), b, k, h, d),
                want, sets, b, k, h, d, shape)
            # the byte path, bitwise the plain version and the aligned tiers
            want = k6(ids0, mask0, rows0)
            out = k6_odd(ids0, mask0, rows0)
            assert same_bits(torch, out, want)
            assert same_bits(torch, out, k6_odd_plain(ids0, mask0, rows0))
            record("mtl_gather_three_level_q8", shape + ",misaligned", 0.0,
                   device_ms(torch, k6_odd, sets),
                   device_ms(torch, k6_odd_plain, sets), None,
                   ids_bytes + maps + uniq.numel() * (d + 4) + out_bytes, 0)
            tiered_sweep(torch, "mtl_gather_three_level_q8", entry_call(
                torch, "mtl_gather_three_level_q8", offsets,
                (slot_of_row, smap, qcache, qcscale, qstaging, qsscale),
                (qcache.shape[0], qstaging.shape[0], n_rows), b, k, h, d),
                want, sets, b, k, h, d, shape)
            del odd_staging, odd_qstaging
    del q, scale, qcache, qcscale, odd_qcache, odd_cache, cache, slot_of_row
    torch.cuda.empty_cache()


def trace_step(torch, name, plan, ids, n_steps: int = 20,
               prepare=None) -> dict:
    """Profile ``n_steps`` calls of ``plan`` and print, per step: device
    busy time (union of kernel and copy intervals), the share of the
    traced window with nothing running on the device, the time kernels
    on two or more streams overlapped, the host-to-device copies, the
    five kernels that took the most device time, and the embedding
    gathers' time. ``prepare(i)``, when
    given, runs before step i (a host store stages that step's batch
    there) and returns its device ids; otherwise every step runs on
    ``ids``. The Chrome trace lands in ``build/traces/``. Returns the
    traced window's device time by kernel name (``kernels``, µs over all
    ``steps``) and its host-side PyTorch ops by name (``ops``, counts)."""
    from torch.profiler import ProfilerActivity, profile

    def step_ids(i):
        return ids if prepare is None else prepare(i)

    plan(step_ids(n_steps))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(n_steps):
            plan(step_ids(i))
        torch.cuda.synchronize()
    out = ROOT / "build" / "traces"
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"{name}_{plan.level}_b{plan.batch_size}.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())["traceEvents"]
    events = [e for e in trace if e.get("ph") == "X"
              and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    ops: dict = {}
    for e in trace:
        if e.get("ph") == "X" and e.get("cat") == "cpu_op":
            ops[e["name"]] = ops.get(e["name"], 0) + 1
    if not events:
        log(f"[{name}] trace: no device events recorded")
        return {"kernels": {}, "ops": ops, "steps": n_steps}
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["args"].get("stream", -1))
                   for e in events)
    busy = overlap = 0.0
    cur_end = spans[0][0]
    edges = sorted([(s, 1, st) for s, _, st in spans]
                   + [(t, -1, st) for _, t, st in spans],
                   key=lambda e: e[:2])                 # ends before starts
    active: dict = {}
    last = edges[0][0]
    for t, step, st in edges:
        if len({k for k, v in active.items() if v > 0}) >= 2:
            overlap += t - last
        last = t
        active[st] = active.get(st, 0) + step
    for s, t, _ in spans:
        if t > cur_end:
            busy += t - max(s, cur_end)
            cur_end = t
    window = spans[-1][1] - spans[0][0]
    by_kernel: dict = {}
    for e in events:
        by_kernel[e["name"]] = by_kernel.get(e["name"], 0.0) + e["dur"]
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:5]
    streams = sorted({st for _, _, st in spans})
    h2d = [e for e in events if e.get("cat") == "gpu_memcpy"
           and "HtoD" in e["name"]]
    log(f"[{name}] trace {plan.level} b={plan.batch_size}, {n_steps} steps: "
        f"device busy {busy / n_steps:.1f} us/step, idle share of window "
        f"{1 - busy / window:.3f}, streams {streams}, multi-stream overlap "
        f"{overlap / n_steps:.1f} us/step, host-to-device copies "
        f"{len(h2d) / n_steps:.1f}/step taking "
        f"{sum(e['dur'] for e in h2d) / n_steps:.1f} us/step")
    for kname, dur in top:
        log(f"[{name}]   {dur / n_steps:8.1f} us/step  {kname[:90]}")
    gathers: dict = {}
    for kname, dur in by_kernel.items():
        if "gather" in kname or "tiered" in kname:
            short = kname.split("<")[0].split("::")[-1].split()[-1]
            gathers[short] = gathers.get(short, 0.0) + dur / n_steps
    log(f"[{name}]   embedding gathers, us/step: "
        f"{ {k: round(v, 2) for k, v in gathers.items()} }")
    fm = [dur for kname, dur in by_kernel.items() if "fm_second_order" in kname]
    if fm:
        log(f"[{name}]   K11 fused_fm_second_order, us/step: "
            f"{sum(fm) / n_steps:.2f}")
    cross = [e["dur"] for e in events if "cross_v" in e["name"]]
    if cross:
        log(f"[{name}]   K9/K10 cross tail, us/step: "
            f"{sum(cross) / n_steps:.2f} ({len(cross) / n_steps:.1f} "
            f"launches/step)")
    return {"kernels": by_kernel, "ops": ops, "steps": n_steps}


def latency(torch, name, plan, schema, sample_ids) -> None:
    """p50/p80 of full-batch ``predict`` calls (closed loop, one caller);
    at level "dual" also a profiler trace of the step."""
    import numpy as np

    ids_b = sample_ids(schema, plan.batch_size, step=30_000)
    lat = []
    for _ in range(LATENCY_WARMUP + LATENCY_SAMPLES):
        t0 = time.perf_counter()
        plan.predict(ids_b)
        lat.append((time.perf_counter() - t0) * 1e3)
    lat = np.asarray(lat[LATENCY_WARMUP:])
    log(f"[{name}] latency {plan.level} b={plan.batch_size}: p50 "
        f"{np.percentile(lat, 50):.3f} ms, p80 "
        f"{np.percentile(lat, 80):.3f} ms ({lat.size} requests)")
    if plan.level == "dual":
        trace_step(torch, name, plan, torch.from_numpy(ids_b).to(plan.device))


def paired_latency(torch, plans: dict, schema, sample_ids,
                   stores: dict | None = None) -> dict:
    """Request latency of several "dual" plans of one batch size, measured
    in turns (a, b, c, c, b, a, ...) so host and clock drift fall on all
    alike, each round on a fresh batch: p50/p80 of a request (``stage`` +
    ``predict`` for the plans whose tag is in ``stores``, host stores that
    stage each batch first; ``predict`` for the others) and p50 of the
    host's enqueue of one step (``plan(ids)`` returning, before the device
    finishes); then a trace of each plan (staging each step's batch for
    the host stores). Returns each plan's ``trace_step`` result."""
    import numpy as np

    stores = stores or {}
    b = next(iter(plans.values())).batch_size
    dev = next(iter(plans.values())).device
    rounds = LATENCY_WARMUP + LATENCY_SAMPLES
    batches = [sample_ids(schema, b, step=30_000 + r) for r in range(rounds)]
    ids_b = batches[0]
    ids_dev = torch.from_numpy(ids_b).to(dev)
    for store in stores.values():
        store.stage(ids_b)
    lat = {tag: [] for tag in plans}
    enq = {tag: [] for tag in plans}
    tags = list(plans)
    for r, ids in enumerate(batches):
        for tag in (tags if r % 2 == 0 else tags[::-1]):
            t0 = time.perf_counter()
            if tag in stores:
                stores[tag].stage(ids)
            plans[tag].predict(ids)
            lat[tag].append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            plans[tag](ids_dev)
            enq[tag].append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
    for tag in tags:
        la = np.asarray(lat[tag][LATENCY_WARMUP:])
        en = np.asarray(enq[tag][LATENCY_WARMUP:])
        what = "stage + predict" if tag in stores else "predict"
        log(f"[{tag}] latency dual b={b} ({what}, in turns with "
            f"{len(tags) - 1} other plans): p50 {np.percentile(la, 50):.3f} "
            f"ms, p80 {np.percentile(la, 80):.3f} ms, host enqueue of a step "
            f"p50 {np.percentile(en, 50):.3f} ms ({la.size} requests)")
    traces = {}
    for tag, plan in plans.items():
        prepare = None
        if tag in stores:
            feed = [sample_ids(schema, b, step=31_000 + i) for i in range(21)]

            def prepare(i, store=stores[tag], feed=feed):
                store.stage(feed[i])
                return torch.from_numpy(feed[i]).to(dev)
        traces[tag] = trace_step(torch, tag, plan, ids_dev, prepare=prepare)
    return traces


def serve(plan, schema, sample_ids, n_requests: int, step0: int):
    """Answer ``n_requests`` predict calls, every third one a partial
    batch; returns all scores."""
    scores = []
    for r in range(n_requests):
        b = plan.batch_size if r % 3 else max(1, plan.batch_size // 3 - r)
        s = plan.predict(sample_ids(schema, b, step=step0 + r))
        assert s.shape == (b,), s.shape
        scores.append(s)
    return scores


def run_model(torch, dev, name, spec, schema, sample_ids, *, batches,
              n_requests):
    """Build one full-width model, check its levels and its CPU twin,
    serve it through "dual", and return its launch counts and steps."""
    import numpy as np

    from repro_torch.core import LEVELS, compile_plan
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.ctr import CTR_MODELS

    model = CTR_MODELS[name](spec, device=dev).init(
        torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()

    # the four levels agree on the card
    ids = torch.from_numpy(sample_ids(schema, 256, step=10_000)).to(dev)
    plans = {}
    for level in LEVELS:
        plans[level] = compile_plan(model, level, 256, device=dev)
        log(f"[{name}] compiled {level} b=256 in "
            f"{plans[level].compile_ms:.1f} ms")
    logits = {lvl: p(ids) for lvl, p in plans.items()}
    for lvl, out in logits.items():
        assert out.shape == (256, 1), out.shape
        assert torch.isfinite(out).all(), lvl
        torch.testing.assert_close(out, logits["naive"], **LADDER_TOL,
                                   msg=lambda m: f"{name} {lvl}: {m}")
    diffs = {lvl: (out - logits["naive"]).abs().max().item()
             for lvl, out in logits.items()}
    log(f"[{name}] level ladder on the card: max|level-naive| = {diffs}")

    # the card agrees with the CPU path on the same weights
    cpu_model = CTR_MODELS[name](spec, device="cpu")
    cpu_model.load_state_dict(model.state_dict())
    cpu_plan = compile_plan(cpu_model, "dual", 16, device="cpu")
    small = sample_ids(schema, 16, step=20_000)
    want = cpu_plan(torch.from_numpy(small))
    got = plans["dual"](torch.from_numpy(
        np.concatenate([small, sample_ids(schema, 240, step=20_001)]))
        .to(dev))[:16].cpu()
    torch.testing.assert_close(got, want, **CPU_TOL)
    log(f"[{name}] card vs CPU, dual, 16 rows: max|diff| = "
        f"{(got - want).abs().max().item():.3e}")
    del cpu_model, cpu_plan

    # request latency per level at each batch (full batches, closed loop,
    # one caller), then a profiler trace of the "dual" step
    for b in batches:
        for level in LEVELS:
            plan = plans[level] if b == 256 else compile_plan(
                model, level, b, device=dev)
            latency(torch, name, plan, schema, sample_ids)

    # the main path: counters reset just before, read just after
    dual = {b: compile_plan(model, "dual", b, device=dev) for b in batches}
    torch.cuda.synchronize()
    reset_launch_counts()
    n_steps = 0
    all_scores = []
    for b in batches:
        scores = serve(dual[b], schema, sample_ids, n_requests, 40_000 + b)
        n_steps += n_requests
        all_scores += scores
    torch.cuda.synchronize()
    counts = launch_counts()
    s = np.concatenate(all_scores)
    assert np.all(np.isfinite(s)) and np.all((s > 0) & (s < 1)), \
        (s.min(), s.max())
    log(f"[{name}] main path: {n_steps} requests through dual "
        f"({', '.join(str(b) for b in batches)}), {s.size} scores in "
        f"[{s.min():.4f}, {s.max():.4f}], launches {counts}")
    del plans, dual, model
    torch.cuda.empty_cache()
    return counts, n_steps


def check_host_device_state(torch, store) -> None:
    """A host store's device tensors are its cache, staging area (with
    their scales) and two maps: ``device_bytes`` is their sum, and no
    (rows, d) table sits on the card."""
    spec = store.spec
    row_bytes = spec.dim + 4 if store.quantized else 4 * spec.dim
    want = (store.capacity + store.staging_capacity) * row_bytes \
        + 2 * spec.rows * 4
    assert store.device_bytes() == want, (store.device_bytes(), want)
    names = {name for name, _ in store.named_buffers()}
    assert names == set(store.runtime_keys), names
    for name, t in store.named_buffers():
        assert not (t.dim() == 2 and t.shape[0] == spec.rows), name


def request_schedule(schema, sample_ids, emb_spec, batches, n_requests):
    """Per batch size: the ids of each request, and one batch of
    ``DELTA_ROWS`` trainer delta rows (a third of them touched by the
    requests after the halfway point, where the batch lands)."""
    import numpy as np

    half = n_requests // 2
    offsets = emb_spec.offsets
    drng = np.random.default_rng(SEED + 3)
    schedule, deltas = {}, {}
    for b in batches:
        schedule[b] = [sample_ids(schema, b, step=60_000 + 100 * b + r)
                       for r in range(n_requests)]
        later = np.concatenate([ids + offsets[None, :]
                                for ids in schedule[b][half:]]).ravel()
        cand = np.unique(np.concatenate([
            drng.choice(later, DELTA_ROWS // 2),
            drng.choice(emb_spec.zero_row, DELTA_ROWS)]))
        rows = drng.permutation(cand)[:DELTA_ROWS]
        vals = (drng.standard_normal((DELTA_ROWS, emb_spec.dim)) * 0.05
                ).astype(np.float32)
        deltas[b] = (rows, vals)
    return schedule, deltas


def run_tiered(torch, dev, spec, schema, sample_ids, *, batches,
               n_requests) -> dict:
    """Serve full-width DCNv2 through "dual" over fp32 and int8
    ``CachedStore``s and ``HostBackedStore``s adopted from the dense
    model's weights, with hint / stage / observe / refresh / deltas
    between requests, against a ``DenseStore`` replay of the same ids and
    deltas; then latency, traces, the level ladders, chunked serving
    through the reference's default staging area, and store-level
    multi-hot. Returns the launches of K2–K6 on their paths."""
    import numpy as np

    from repro_torch.core import LEVELS, compile_plan
    from repro_torch.embedding import (CachedStore, HostBackedStore,
                                       StagingOverflowError)
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.ctr import DCNv2

    emb_spec = spec.embedding_spec()

    def build(kind="dense", row_dtype=None):
        model = DCNv2(spec, device=dev).init(
            torch.Generator(device=dev).manual_seed(SEED))
        if kind == "cached":
            model.use_store(CachedStore(emb_spec, CACHE_CAPACITY, row_dtype,
                                        device=dev))
        elif kind == "host":
            model.use_store(HostBackedStore(emb_spec, CACHE_CAPACITY,
                                            STAGING_CAPACITY,
                                            row_dtype=row_dtype, device=dev))
        return model

    dense = build()
    tiers = {"cached-fp32": build("cached"),
             "cached-int8": build("cached", "int8"),
             "host-fp32": build("host"),
             "host-int8": build("host", "int8")}
    gathers = {"cached-fp32": "mtl_gather_two_level",
               "cached-int8": "mtl_gather_two_level_q8",
               "host-fp32": "mtl_gather_three_level",
               "host-int8": "mtl_gather_three_level_q8"}
    torch.cuda.synchronize()
    table = dense.embedding.dense_view()
    assert torch.equal(tiers["cached-fp32"].embedding.store.backing, table)
    assert np.array_equal(tiers["host-fp32"].embedding.store.host_view(),
                          table.cpu().numpy())
    for tag in ("host-fp32", "host-int8"):
        store = tiers[tag].embedding.store
        check_host_device_state(torch, store)
        log(f"[{tag}] {store.describe()}: {store.device_bytes()} bytes on "
            f"the device (cache, staging, two maps), "
            f"{store.host_view().nbytes} bytes of backing in host memory")
    offsets = emb_spec.offsets

    half = n_requests // 2
    schedule, deltas = request_schedule(schema, sample_ids, emb_spec,
                                        batches, n_requests)

    def serve_schedule(model, plans, tag):
        """Per request: hint the next request and stage this one (host
        stores), predict, observe; a refresh every ``REFRESH_EVERY``
        requests and the delta batch halfway."""
        store = model.embedding.store
        scores = {}
        swap_ms = {"refresh": [], "deltas": []}
        stage_ms, per_req = [], []
        for b in batches:
            out, windows = [], []
            seen = (store.stats.hits, store.stats.lookups)
            reqs = schedule[b]
            for r, ids in enumerate(reqs):
                if store.needs_staging:
                    if r + 1 < len(reqs):
                        store.prefetch_hint(reqs[r + 1])
                    st = store.stats
                    before = (st.staged_rows, st.prefetched_rows,
                              st.h2d_bytes, store.upload_bytes)
                    t0 = time.perf_counter()
                    store.stage(ids)
                    stage_ms.append((time.perf_counter() - t0) * 1e3)
                    per_req.append([a - z for a, z in zip(
                        (st.staged_rows, st.prefetched_rows, st.h2d_bytes,
                         store.upload_bytes), before)])
                out.append(plans[b].predict(ids))
                if store.refreshable:
                    model.embedding.observe(ids)
                if store.refreshable and (r + 1) % REFRESH_EVERY == 0:
                    hits, looks = store.stats.hits, store.stats.lookups
                    windows.append((hits - seen[0]) / (looks - seen[1]))
                    t0 = time.perf_counter()
                    store.refresh()
                    swap_ms["refresh"].append(
                        (time.perf_counter() - t0) * 1e3)
                    seen = (store.stats.hits, store.stats.lookups)
                if r + 1 == half:
                    rows, vals = deltas[b]
                    if store.refreshable:
                        t0 = time.perf_counter()
                        assert store.apply_deltas(rows, vals) == DELTA_ROWS
                        swap_ms["deltas"].append(
                            (time.perf_counter() - t0) * 1e3)
                    else:                      # the dense replay's twin
                        torch.cuda.synchronize()
                        store.mega_table.index_copy_(
                            0, torch.from_numpy(rows).to(dev),
                            torch.from_numpy(vals).to(dev))
            scores[b] = np.concatenate(out)
            if windows:
                log(f"[{tag}] b={b}: hit rate per {REFRESH_EVERY}-request "
                    f"window, each ended by a refresh: "
                    + " -> ".join(f"{w:.4f}" for w in windows)
                    + f"; cached traffic "
                    f"{store.cached_traffic_fraction:.4f}")
        if store.refreshable:
            log(f"[{tag}] host wall time of each publish (build aside, "
                f"device sync, swap): refresh "
                + ", ".join(f"{t:.2f}" for t in swap_ms["refresh"])
                + " ms; deltas "
                + ", ".join(f"{t:.2f}" for t in swap_ms["deltas"]) + " ms")
        if per_req:
            pr = np.asarray(per_req, dtype=np.float64)
            snapshot = sum(t.numel() * t.element_size() for k, t in
                           store.runtime_tensors().items()
                           if k.startswith("staging"))
            log(f"[{tag}] per request ({len(per_req)}): staged at serve "
                f"time {pr[:, 0].mean():.1f} rows, already prefetched "
                f"{pr[:, 1].mean():.1f} rows; h2d_bytes (staged rows x "
                f"wire bytes) {pr[:, 2].mean():.0f} B; staging upload "
                f"copied {pr[:, 3].mean():.0f} B (max {pr[:, 3].max():.0f};"
                f" a whole-area snapshot would be {snapshot} B); host time "
                f"of stage p50 {np.percentile(stage_ms, 50):.3f} ms, p80 "
                f"{np.percentile(stage_ms, 80):.3f} ms")
        return scores

    # the four levels of the fp32 cached model agree on the card, and the
    # three the fp32 host model serves ("naive" needs the whole table on
    # the device, which the host store never holds)
    ids_np = sample_ids(schema, 256, step=10_000)
    ids = torch.from_numpy(ids_np).to(dev)
    for tag, levels in (("cached-fp32", LEVELS),
                        ("host-fp32", ("fused_emb", "fused_all", "dual"))):
        m = tiers[tag]
        m.embedding.store.stage(ids_np)
        logits = {lvl: compile_plan(m, lvl, 256, device=dev,
                                    runtime_provider=m.store_runtime_env)(ids)
                  for lvl in levels}
        ref = logits[levels[0]]
        for lvl, out in logits.items():
            torch.testing.assert_close(out, ref, **LADDER_TOL,
                                       msg=lambda msg: f"{tag} {lvl}: {msg}")
        log(f"[{tag}] level ladder on the card: max|level-{levels[0]}| = "
            f"{ {lvl: (o - ref).abs().max().item() for lvl, o in logits.items()} }")
        del logits

    dense_plans = {b: compile_plan(dense, "dual", b, device=dev)
                   for b in batches}
    want = serve_schedule(dense, dense_plans, "dense")
    w = np.concatenate([want[b] for b in batches])
    launches, got_all = {}, {}
    served = {"dense": dense_plans}
    for tag, model in tiers.items():
        store = model.embedding.store
        plans = {}
        for b in batches:                  # the only compiles of this run
            plans[b] = compile_plan(model, "dual", b, device=dev,
                                    runtime_provider=model.store_runtime_env)
        n_compiles = len(plans)
        served[tag] = plans
        kernel = gathers[tag]
        torch.cuda.synchronize()
        reset_launch_counts()
        got = serve_schedule(model, plans, tag)
        torch.cuda.synchronize()
        counts = launch_counts()
        n_steps = len(batches) * n_requests
        assert counts[kernel] == n_steps, counts
        for other in ("mtl_gather", *gathers.values()):
            assert other == kernel or counts[other] == 0, counts
        assert counts["fused_cross_v2"] == 3 * n_steps, counts
        assert len(plans) == n_compiles and store.stats.refreshes == \
            len(batches) * (n_requests // REFRESH_EVERY), store.stats
        launches[kernel] = counts[kernel]
        s = np.concatenate([got[b] for b in batches])
        assert np.all(np.isfinite(s)) and np.all((s > 0) & (s < 1))
        err = float(np.abs(s - w).max())
        if tag.endswith("fp32"):
            assert np.array_equal(s, w), f"fp32 {tag} != dense ({err})"
        else:
            assert err < Q8_SCORE_GATE, f"{tag} scores off by {err}"
        if tag.startswith("host"):
            check_host_device_state(torch, store)
            assert store.stats.staging_overflows == 0, store.stats
        got_all[tag] = s
        log(f"[{tag}] main path: {n_steps} requests through dual "
            f"({', '.join(str(b) for b in batches)}) on {n_compiles} plans, "
            f"{store.stats.refreshes} refreshes, {len(batches)} delta "
            f"batches of {DELTA_ROWS} rows; max|score - dense replay| = "
            f"{err:.3e}; launches {counts}")
    log("[host-int8] max|host int8 - cached int8| on the same ids and "
        f"deltas = {float(np.abs(got_all['host-int8'] - got_all['cached-int8']).max()):.3e}")
    host_stores = {tag: tiers[tag].embedding.store
                   for tag in ("host-fp32", "host-int8")}
    for b in batches:
        paired_latency(torch, {tag: plans[b] for tag, plans in served.items()},
                       schema, sample_ids, stores=host_stores)
    del served

    # the reference's default staging area (S = 256) at b = 256 after one
    # refresh: nearly every batch's misses overflow it, and the batch is
    # served in chunks through the same plan, bitwise the dense replay
    m_over = DCNv2(spec, device=dev)
    m_over.load_state_dict(dense.state_dict())     # deltas included
    over = HostBackedStore(emb_spec, CACHE_CAPACITY, OVERFLOW_STAGING,
                           device=dev)
    m_over.use_store(over)
    over.observe(sample_ids(schema, 16_384, step=50_000) + offsets[None, :])
    over.refresh()
    plan_o = compile_plan(m_over, "dual", 256, device=dev,
                          runtime_provider=m_over.store_runtime_env)
    torch.cuda.synchronize()
    reset_launch_counts()
    chunks = []
    for r in range(8):
        ids = sample_ids(schema, 256, step=80_000 + r)
        try:
            over.stage(ids)
            parts = [ids]
            s = plan_o.predict(ids)
        except StagingOverflowError:
            parts = over.split_for_staging(ids)
            outs = []
            for part in parts:
                over.stage(part)
                outs.append(plan_o.predict(part))
            s = np.concatenate(outs)
        chunks.append(len(parts))
        assert np.array_equal(s, dense_plans[256].predict(ids)), \
            f"overflow request {r}"
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["mtl_gather_three_level"] == sum(chunks), counts
    assert over.stats.staging_overflows > 0, over.stats
    log(f"[host-overflow] {over.describe()}: 8 requests of b=256, "
        f"{over.stats.staging_overflows} staging overflows, chunks per "
        f"request {chunks}; scores bitwise the dense replay; launches "
        f"{counts}")
    over.pipeline.stop()
    del m_over, over, plan_o

    # the stores took the same deltas: one table, and store-level multi-hot
    # through the dense store (K2), the fp32 cached store (K3) and the fp32
    # host store (K5) agree
    host32 = tiers["host-fp32"].embedding
    assert torch.equal(dense.embedding.dense_view(),
                       tiers["cached-fp32"].embedding.store.backing)
    assert np.array_equal(host32.store.host_view(),
                          dense.embedding.dense_view().cpu().numpy())
    rng = np.random.default_rng(SEED + 4)
    torch.cuda.synchronize()
    reset_launch_counts()
    for r in range(8):
        ids = torch.from_numpy(slot_ids(schema, sample_ids, 1024, HOT,
                                        70_000 + r)).to(dev)
        mask = torch.from_numpy(rng.integers(
            0, 2, size=tuple(ids.shape)).astype(np.float32)).to(dev)
        a = dense.embedding.forward_multihot(ids, mask)
        c = tiers["cached-fp32"].embedding.forward_multihot(ids, mask)
        host32.store.stage(ids, mask)
        h = host32.forward_multihot(ids, mask)
        assert torch.equal(a, c), "multi-hot: dense != cached"
        assert torch.equal(a, h), "multi-hot: dense != host"
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["mtl_gather_multihot"] == counts[
        "mtl_gather_two_level"] == counts["mtl_gather_three_level"] == 8, \
        counts
    launches["mtl_gather_multihot"] = counts["mtl_gather_multihot"]
    log(f"[multihot] 8 pooled lookups (b=1024, h={HOT}, random mask) "
        f"through DenseStore, CachedStore and HostBackedStore: bitwise "
        f"equal; launches {counts}")
    for store in host_stores.values():
        store.pipeline.stop()
    del dense, tiers, host_stores, host32
    torch.cuda.empty_cache()
    return launches


def run_int8_models(torch, dev, schema, sample_ids) -> dict:
    """Full-width DCNv2, then DCN, DeepFM and Wide&Deep, compiled with
    ``compute_dtype="int8"``: the four levels agree on the card, the card
    agrees with the CPU int8 path on the same weights, the weight counters
    are the reference's, and "dual" plans serve a few dozen requests
    (partial batches among them) with the counters reset just before and
    read just after: three quantizer and three K12 launches a step, scores
    finite, in (0, 1) and within ``Q8_SCORE_GATE`` of the fp32 plan's on
    the same requests. DCNv2's int8 and fp32 plans are then timed in turns
    and traced; the int8 step's trace must hold no ``abs``/``amax``/
    ``div``/``round``/``clamp`` op or kernel (the MLP layers' quantizer
    was those ops before it was a kernel). Returns the quantizer's and
    K12's launches in DCNv2's run."""
    import numpy as np

    from repro_torch.configs import ctr_spec
    from repro_torch.core import LEVELS, compile_plan
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.ctr import CTR_MODELS

    launches = {}
    for name, batches, n_requests in (("dcnv2", (256, 1024), 16),
                                      ("dcn", (256,), 24),
                                      ("deepfm", (256,), 24),
                                      ("widedeep", (256,), 24)):
        spec = ctr_spec(name, "criteo", embed_dim=32, hidden=1024)
        model = CTR_MODELS[name](spec, device=dev).init(
            torch.Generator(device=dev).manual_seed(SEED))
        tag = f"{name}-int8"
        ids = torch.from_numpy(sample_ids(schema, 256, step=10_000)).to(dev)
        logits = {lvl: compile_plan(model, lvl, 256, device=dev,
                                    compute_dtype="int8")(ids)
                  for lvl in LEVELS}
        for lvl, out in logits.items():
            assert out.shape == (256, 1) and torch.isfinite(out).all(), lvl
            torch.testing.assert_close(out, logits["naive"], **LADDER_TOL,
                                       msg=lambda m: f"{tag} {lvl}: {m}")
        log(f"[{tag}] level ladder on the card: max|level-naive| = "
            f"{ {lvl: (o - logits['naive']).abs().max().item() for lvl, o in logits.items()} }")
        del logits

        cpu_model = CTR_MODELS[name](spec, device="cpu")
        cpu_model.load_state_dict(model.state_dict())
        small = sample_ids(schema, 16, step=20_000)
        want = compile_plan(cpu_model, "dual", 16, device="cpu",
                            compute_dtype="int8")(torch.from_numpy(small))
        del cpu_model

        p8 = {b: compile_plan(model, "dual", b, device=dev,
                              compute_dtype="int8") for b in batches}
        p32 = {b: compile_plan(model, "dual", b, device=dev)
               for b in batches}
        got = p8[256](torch.from_numpy(np.concatenate(
            [small, sample_ids(schema, 240, step=20_001)])).to(dev))[:16]
        torch.testing.assert_close(got.cpu(), want, **CPU_TOL)
        st = p8[256].stats
        assert (st.compute_dtype, st.mlp_quant_matmuls,
                st.mlp_quant_weight_bytes,
                st.mlp_quant_weight_bytes_saved) == (
            "int8", 3, 3_387_392, 10_113_024), st
        assert p32[256].stats.mlp_quant_matmuls == 0
        ratio = (st.mlp_quant_weight_bytes
                 + st.mlp_quant_weight_bytes_saved) \
            / st.mlp_quant_weight_bytes
        log(f"[{tag}] card vs CPU int8 path, dual, 16 rows: max|diff| = "
            f"{(got.cpu() - want).abs().max().item():.3e}; MLP weights "
            f"{st.mlp_quant_weight_bytes} B int8 (saved "
            f"{st.mlp_quant_weight_bytes_saved} B, {ratio:.3f}x smaller)")

        torch.cuda.synchronize()
        reset_launch_counts()
        s8 = np.concatenate([np.concatenate(serve(
            p8[b], schema, sample_ids, n_requests, 40_000 + b))
            for b in batches])
        torch.cuda.synchronize()
        counts = launch_counts()
        n_steps = len(batches) * n_requests
        assert counts["dmm_q8"] == counts["quantize_rows_q8"] \
            == 3 * n_steps, counts
        s32 = np.concatenate([np.concatenate(serve(
            p32[b], schema, sample_ids, n_requests, 40_000 + b))
            for b in batches])
        assert np.all(np.isfinite(s8)) and np.all((s8 > 0) & (s8 < 1))
        err = float(np.abs(s8 - s32).max())
        assert err < Q8_SCORE_GATE, f"{tag}: |int8 - fp32| = {err}"
        log(f"[{tag}] main path: {n_steps} requests through dual "
            f"({', '.join(str(b) for b in batches)}), {s8.size} scores in "
            f"[{s8.min():.4f}, {s8.max():.4f}]; max|int8 - fp32| = "
            f"{err:.3e}; launches {counts}")
        if name == "dcnv2":
            launches = {k: counts[k] for k in ("quantize_rows_q8", "dmm_q8")}
            for b in batches:
                traces = paired_latency(torch, {"dcnv2-fp32": p32[b],
                                                "dcnv2-int8": p8[b]},
                                        schema, sample_ids)
                check_no_quantizer_ops(traces["dcnv2-int8"], f"{tag} b={b}")
        del model, p8, p32
        torch.cuda.empty_cache()
    return launches


QUANT_OPS = ("aten::abs", "aten::amax", "aten::div", "aten::round",
             "aten::clamp", "aten::clamp_", "aten::clamp_min")
QUANT_KERNELS = ("abs_kernel", "MaxNanFunctor", "MaxOps", "div_true",
                 "round_kernel", "clamp")


def check_no_quantizer_ops(trace: dict, tag: str) -> None:
    """Fail if a traced int8 step ran any op or kernel of the eager
    activation quantizer (``quant.absmax_scale`` + ``quant.quantize``)."""
    ops = {op: n for op, n in trace["ops"].items() if op in QUANT_OPS}
    kernels = [k for k in trace["kernels"]
               if any(p in k for p in QUANT_KERNELS)]
    assert not ops and not kernels, f"{tag}: quantizer ops {ops} {kernels}"
    per_step = {k: sum(us for name, us in trace["kernels"].items()
                       if k in name) / trace["steps"]
                for k in ("quantize_rows_q8", "dmm_q8")}
    log(f"[{tag}] trace: no abs/amax/div/round/clamp op or kernel "
        f"({len(trace['ops'])} op names, {len(trace['kernels'])} kernels); "
        f"quantize_rows_q8 {per_step['quantize_rows_q8']:.1f} us/step, "
        f"dmm_q8 {per_step['dmm_q8']:.1f} us/step")


def run_int8_stack(torch, dev, spec, schema, sample_ids, *, batches,
                   n_requests) -> None:
    """The full int8 stack (the reference's ``mlp_quant.py`` refresh check
    without the engine): DCNv2 over an int8-row ``CachedStore`` with int8
    compute, and its fp32-row twin, each served through one "dual" plan
    per batch (``runtime_provider=model.store_runtime_env``) with observe,
    a refresh every 8 requests and one delta batch halfway; beside them a
    ``DenseStore`` model replaying the same ids and deltas through an fp32
    and an int8-compute plan. The fp32-row twin must be bitwise the dense
    int8-compute plan, the int8 stack within ``Q8_SCORE_GATE`` of the
    dense fp32 plan, with no plan rebuilt."""
    import numpy as np

    from repro_torch.core import compile_plan
    from repro_torch.embedding import CachedStore
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.ctr import DCNv2

    emb_spec = spec.embedding_spec()

    def build(row_dtype="dense"):
        model = DCNv2(spec, device=dev).init(
            torch.Generator(device=dev).manual_seed(SEED))
        if row_dtype != "dense":
            model.use_store(CachedStore(emb_spec, CACHE_CAPACITY, row_dtype,
                                        device=dev))
        return model

    dense, c32, c8 = build(), build(None), build("int8")
    cached = (c32, c8)
    plans = {}
    for b in batches:
        plans[b] = {
            "dense-fp32": compile_plan(dense, "dual", b, device=dev),
            "dense-int8c": compile_plan(dense, "dual", b, device=dev,
                                        compute_dtype="int8"),
            "cached-fp32-int8c": compile_plan(
                c32, "dual", b, device=dev, compute_dtype="int8",
                runtime_provider=c32.store_runtime_env),
            "cached-int8-int8c": compile_plan(
                c8, "dual", b, device=dev, compute_dtype="int8",
                runtime_provider=c8.store_runtime_env)}
    compiled = {id(p) for per in plans.values() for p in per.values()}
    half = n_requests // 2
    schedule, deltas = request_schedule(schema, sample_ids, emb_spec,
                                        batches, n_requests)
    scores = {tag: [] for tag in plans[batches[0]]}
    torch.cuda.synchronize()
    reset_launch_counts()
    for b in batches:
        for r, ids in enumerate(schedule[b]):
            for tag, plan in plans[b].items():
                scores[tag].append(plan.predict(ids))
            for m in cached:
                m.embedding.observe(ids)
                if (r + 1) % REFRESH_EVERY == 0:
                    m.embedding.store.refresh()
            if r + 1 == half:
                rows, vals = deltas[b]
                for m in cached:
                    assert m.embedding.store.apply_deltas(rows, vals) \
                        == DELTA_ROWS
                torch.cuda.synchronize()
                dense.embedding.store.mega_table.index_copy_(
                    0, torch.from_numpy(rows).to(dev),
                    torch.from_numpy(vals).to(dev))
    torch.cuda.synchronize()
    counts = launch_counts()
    n_steps = len(batches) * n_requests
    assert counts["dmm_q8"] == 3 * 3 * n_steps, counts
    assert counts["mtl_gather"] == 2 * n_steps, counts
    assert counts["mtl_gather_two_level"] == n_steps, counts
    assert counts["mtl_gather_two_level_q8"] == n_steps, counts
    assert {id(p) for per in plans.values() for p in per.values()} \
        == compiled
    for m in cached:
        assert m.embedding.store.stats.refreshes == \
            len(batches) * (n_requests // REFRESH_EVERY)
    s = {tag: np.concatenate(v) for tag, v in scores.items()}
    for tag, v in s.items():
        assert np.all(np.isfinite(v)) and np.all((v > 0) & (v < 1)), tag
    assert np.array_equal(s["cached-fp32-int8c"], s["dense-int8c"]), \
        "fp32-row cached int8-compute plan != dense int8-compute plan"
    err8 = float(np.abs(s["cached-int8-int8c"] - s["dense-fp32"]).max())
    errc = float(np.abs(s["dense-int8c"] - s["dense-fp32"]).max())
    assert err8 < Q8_SCORE_GATE and errc < Q8_SCORE_GATE, (err8, errc)
    log(f"[int8-stack] {n_steps} requests ({', '.join(map(str, batches))}) "
        f"through {len(compiled)} plans, no rebuild; "
        f"{c8.embedding.store.stats.refreshes} refreshes and "
        f"{len(batches)} delta batches of {DELTA_ROWS} rows per cached "
        f"store; cached fp32 rows + int8 compute bitwise the dense int8 "
        f"compute plan; max|int8 rows + int8 compute - dense fp32| = "
        f"{err8:.3e}, max|int8 compute - fp32| on the dense store = "
        f"{errc:.3e}; launches {counts}")
    del dense, c32, c8, cached, plans
    torch.cuda.empty_cache()


def drain_batches(policy, n: int) -> list[tuple[int, int]]:
    """The (take, bucket) batches ``serve_pending`` drains ``n`` queued
    rows into under ``policy`` (partials allowed)."""
    out = []
    while n:
        d = policy.decide(n, 0.0, allow_partial=True)
        out.append((d.take, d.bucket))
        n -= d.take
    return out


def serve_waves(torch, tag, eng, dense, dplans, waves, trainer) -> dict:
    """Drive a sync engine wave by wave (submit, ``serve_pending``), the
    trainer's one delta batch pulled halfway and replayed on ``dense``;
    each wave's scores bitwise the dense plans of its batches' buckets.
    Returns the launches of the engine's own waves (the dense replay's
    are not counted) and the host ms of the halfway push, and restores
    ``dense``'s table."""
    import numpy as np

    from repro_torch.embedding import validate_deltas
    from repro_torch.kernels import launch_counts, reset_launch_counts

    table = dense.embedding.store.mega_table
    counts, undo = {}, None
    for w, ids in enumerate(waves):
        if w == len(waves) // 2:
            t0 = time.perf_counter()
            assert eng.pull_updates() > 0
            push_ms = (time.perf_counter() - t0) * 1e3
            rows, vals = validate_deltas(dense.embedding.spec,
                                         *trainer.replay().next_batch())
            idx = torch.from_numpy(rows).to(table.device)
            undo = (idx, table[idx].clone())
            table[idx] = torch.from_numpy(vals).to(table.device)
        torch.cuda.synchronize()
        reset_launch_counts()
        eng.submit_many(list(ids))
        got = eng.serve_pending()
        torch.cuda.synchronize()
        for name, n in launch_counts().items():
            counts[name] = counts.get(name, 0) + n
        want, i = [], 0
        for take, bucket in drain_batches(eng.policy, len(ids)):
            want.append(dplans[bucket].predict(ids[i:i + take]))
            i += take
        assert np.array_equal(got, np.concatenate(want)), f"{tag} wave {w}"
    table[undo[0]] = undo[1]
    st = eng.stats
    assert st.emb_version == 1 and st.rows_behind == 0, st
    assert st.cache_misses == len(eng.policy.buckets), st.cache_misses
    assert st.emb_cache_refreshes == st.n_batches // eng.refresh_every
    return counts, push_ms


def predict_in_threads(plans: dict, ids, n: int = 20) -> dict:
    """Host ms of ``plan.predict(ids)`` in new threads: each plan alone in
    its own thread, then all at once (a thread each): the first call of a
    thread and the mean of the next ``n``. Separates a new thread's first
    step from two threads' steps contending for the host."""
    import threading

    def run(plan, out):
        times = []
        for _ in range(n + 1):
            t0 = time.perf_counter()
            plan.predict(ids)
            times.append((time.perf_counter() - t0) * 1e3)
        out.append((round(times[0], 3),
                    round(sum(times[1:]) / n, 3)))

    res = {}
    for mode in ("alone", "together"):
        outs = {name: [] for name in plans}
        threads = [threading.Thread(target=run, args=(plan, outs[name]))
                   for name, plan in plans.items()]
        for th in threads:
            th.start()
            if mode == "alone":
                th.join(timeout=FUTURE_TIMEOUT_S)
        for th in threads:
            th.join(timeout=FUTURE_TIMEOUT_S)
            assert not th.is_alive(), "predict thread hung"
        res[mode] = {name: out[0] for name, out in outs.items()}
    return res


def run_serving(torch, dev, schema, sample_ids) -> None:
    """Phase 9: the serving stack at full width (see the docstring)."""
    import contextlib
    import io
    import threading

    import numpy as np

    from repro_torch.configs import ctr_spec
    from repro_torch.core import compile_plan
    from repro_torch.embedding import CachedStore, HostBackedStore
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.models.ctr import CTR_MODELS
    from repro_torch.serving import (BucketedBatch, InferenceEngine,
                                     ServingRuntime, SyntheticTrainer)

    t_phase = time.perf_counter()
    spec = ctr_spec("dcnv2", "criteo", embed_dim=32, hidden=1024)
    emb_spec = spec.embedding_spec()
    dense = CTR_MODELS["dcnv2"](spec, device=dev).init(
        torch.Generator(device=dev).manual_seed(SEED))

    def twin():
        model = CTR_MODELS["dcnv2"](spec, device=dev)
        model.load_state_dict(dense.state_dict())
        return model

    dplans = {b: compile_plan(dense, "dual", b, device=dev)
              for b in SERVE_LADDER}
    waves = [sample_ids(schema, n, step=95_000 + w)
             for w, n in enumerate(SERVE_WAVES)]

    # (a) and (b): sync engines over the cached and host tiers
    hosts = []
    runs = (("cached", CachedStore(emb_spec, CACHE_CAPACITY, device=dev),
             "mtl_gather_two_level", waves),
            ("host", HostBackedStore(emb_spec, CACHE_CAPACITY,
                                     STAGING_CAPACITY, device=dev),
             "mtl_gather_three_level", waves),
            ("host-overflow", HostBackedStore(emb_spec, CACHE_CAPACITY,
                                              OVERFLOW_STAGING, device=dev),
             "mtl_gather_three_level",
             [sample_ids(schema, n, step=96_000 + w)
              for w, n in enumerate(OVERFLOW_WAVES)]))
    try:
        for tag, store, gather, traffic in runs:
            if isinstance(store, HostBackedStore):
                hosts.append(store)
            eng = InferenceEngine(twin(), policy=BucketedBatch(SERVE_LADDER),
                                  store=store, refresh_every=REFRESH_EVERY,
                                  device=dev)
            trainer = SyntheticTrainer(store.spec, rows_per_batch=DELTA_ROWS,
                                       n_batches=1, seed=SEED)
            eng.attach_delta_source(trainer)
            eng.warmup()
            misses = eng.stats.cache_misses
            assert misses == len(SERVE_LADDER), misses
            counts, push_ms = serve_waves(torch, tag, eng, dense, dplans,
                                          traffic, trainer)
            t0 = time.perf_counter()
            eng.refresh_cache()
            refresh_ms = (time.perf_counter() - t0) * 1e3
            st = eng.stats
            steps = counts[gather]
            if tag == "host-overflow":
                assert 0 < st.emb_staging_overflows <= st.n_batches, st
                assert steps > st.n_batches, (steps, st.n_batches)
            else:
                assert st.emb_staging_overflows == 0, st
                assert steps == st.n_batches, (counts, st.n_batches)
            assert counts["fused_cross_v2"] == 3 * steps, counts
            assert counts["mtl_gather"] == 0, counts
            host = (f" prefetch_hit={st.emb_prefetch_hit_rate:.3f} "
                    f"staged={st.emb_staged_rows} "
                    f"prefetched={st.emb_prefetched_rows} "
                    f"overflows={st.emb_staging_overflows}"
                    if tag.startswith("host") else "")
            log(f"[serve-{tag}] {store.describe()}: {st.n_requests} requests "
                f"in {st.n_batches} batches {dict(st.batches_per_bucket)}, "
                f"{steps} plan steps; p50 {st.p50_ms:.3f} ms, p99 "
                f"{st.p99_ms:.3f} ms (submit to scores, a wave queued at "
                f"once); compute {st.compute_ms_total / st.n_batches:.3f} "
                f"ms a batch; pad_waste {st.padding_waste:.3f}; "
                f"emb_hit {st.emb_cache_hit_rate:.3f}, refreshes "
                f"{st.emb_cache_refreshes}, v{st.emb_version} "
                f"({st.emb_delta_rows} delta rows){host}; host ms of a "
                f"refresh {refresh_ms:.1f}, of the push {push_ms:.1f}; "
                f"bitwise the dense "
                f"plan per bucket; plan-cache misses {st.cache_misses} "
                f"(all at warmup); launches {counts}")
            del eng
    finally:
        for store in hosts:
            store.pipeline.stop()
    del runs, hosts, dplans
    torch.cuda.empty_cache()

    # (c) the async runtime: DCNv2 (fp32 cached) and DeepFM (dense)
    fm_spec = ctr_spec("deepfm", "criteo", embed_dim=32, hidden=1024)
    dcn = twin()
    dcn.use_store(CachedStore(emb_spec, CACHE_CAPACITY, device=dev))
    dfm = CTR_MODELS["deepfm"](fm_spec, device=dev).init(
        torch.Generator(device=dev).manual_seed(SEED))
    models = {"dcnv2": dcn, "deepfm": dfm}
    one_bucket = {"dcnv2": compile_plan(dense, "dual", 256, device=dev),
                  "deepfm": compile_plan(dfm, "dual", 256, device=dev)}
    per_thread = ASYNC_REQUESTS // ASYNC_THREADS
    rows = [sample_ids(schema, per_thread, step=97_000 + t)
            for t in range(ASYNC_THREADS)]
    names = list(models)
    t0 = time.perf_counter()
    want = {(t, n): np.concatenate([
        one_bucket[n].predict(rows[t][j::2][i:i + 256])
        for i in range(0, per_thread // 2, 256)])
        for t in range(ASYNC_THREADS) for j, n in enumerate(names)}
    log(f"[serve-async] one caller, one thread: a b=256 predict takes "
        f"{(time.perf_counter() - t0) * 1e3 / len(want):.3f} ms (mean of "
        f"{len(want)}, DCNv2 and DeepFM in turns)")
    threads_ms = predict_in_threads(one_bucket, rows[0][:256])
    log(f"[serve-async] b=256 predicts in new threads: the first and the "
        f"mean of the next 20 in a thread, alone "
        f"{threads_ms['alone']}; two threads at once (DCNv2, DeepFM) "
        f"{threads_ms['together']} ms")
    per_step = {"dcnv2": {"mtl_gather_two_level": 1, "fused_cross_v2": 3},
                "deepfm": {"mtl_gather": 2, "fused_fm_second_order": 1}}
    # the shared pool again without the runtime's refresh cadence, to
    # separate a refresh's hold on the DCNv2 engine from the pool's pick
    for mode, every in (("shared", 256), ("per-engine", 256),
                        ("shared", None)):
        rt = ServingRuntime(scheduler=mode, pool_size=2, refresh_every=every)
        for name, model in models.items():
            rt.add_model(name, model, policy=BucketedBatch(CLI_LADDER),
                         device=dev)
        rt.warmup()
        torch.cuda.synchronize()
        reset_launch_counts()
        futs = {}

        def intake(t):
            futs[t] = [rt.submit(names[i % 2], row)
                       for i, row in enumerate(rows[t])]

        threads = [threading.Thread(target=intake, args=(t,))
                   for t in range(ASYNC_THREADS)]
        t0 = time.perf_counter()
        rt.start()
        try:
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=FUTURE_TIMEOUT_S)
                assert not th.is_alive(), "submitter thread hung"
            got = {t: np.array([f.result(timeout=FUTURE_TIMEOUT_S)
                                for f in fs]) for t, fs in futs.items()}
        finally:
            rt.stop()
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        counts = launch_counts()
        for t in range(ASYNC_THREADS):
            s = got[t]
            assert s.shape == (per_thread,) and np.all(np.isfinite(s)) \
                and np.all((s > 0) & (s < 1)), (mode, t)
            for j, name in enumerate(names):
                np.testing.assert_allclose(s[j::2], want[(t, name)],
                                           **LADDER_TOL,
                                           err_msg=f"{mode} {name} t{t}")
        agg = rt.stats()
        assert agg.n_requests == ASYNC_REQUESTS and agg.queue_depth == 0
        assert agg.n_worker_errors == 0
        mode = mode if every else f"{mode}, no refresh"
        expect = {}
        for name in names:
            n_b = rt.engine(name).stats.n_batches
            for kernel, k in per_step[name].items():
                expect[kernel] = expect.get(kernel, 0) + k * n_b
        for kernel, n in expect.items():
            assert counts[kernel] == n, (mode, kernel, counts, expect)
        for name in names:
            st = agg.per_model[name]
            lat = np.asarray(st.latency_ms)
            compute = st.compute_ms_total / st.n_batches
            log(f"[serve-async:{mode}] {name}: {st.n_requests} requests in "
                f"{st.n_batches} batches {dict(sorted(st.batches_per_bucket.items()))}; "
                f"p50 {st.p50_ms:.3f} ms, p99 {st.p99_ms:.3f} ms; "
                f"pad_waste {st.padding_waste:.3f}; device_time_share "
                f"{st.device_time_share:.3f}; sched_dispatches "
                f"{st.sched_dispatches}; compute {compute:.3f} ms a batch = "
                f"{compute / lat.mean():.3f} of the mean latency "
                f"({lat.mean():.3f} ms), queue {1 - compute / lat.mean():.3f}"
                f"; refreshes {st.emb_cache_refreshes}")
        log(f"[serve-async:{mode}] {ASYNC_REQUESTS} requests from "
            f"{ASYNC_THREADS} threads in {wall:.3f} s; every future "
            f"resolved; scores within {LADDER_TOL} of the one-bucket plans; "
            f"launches {counts} = batches x step ({expect})")
    del rt, models, dcn, dfm, one_bucket
    torch.cuda.empty_cache()

    # (d) the CLI, in this process, at its defaults
    argv = ["--models", "dcnv2,deepfm", "--async", "--store", "cached",
            "--refresh-every", "4", "--delta-every", "100"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        serve_main(argv)
    lines = out.getvalue().splitlines()
    for line in lines:
        log(f"[serve-cli] {line}")
    for prefix in ("[serve:async] dcnv2: 250 requests",
                   "[serve:async] deepfm: 250 requests",
                   "[serve:runtime] 2 models  500 requests",
                   "[serve:delta] pushes=", "[serve:sched] pool=2"):
        assert any(line.startswith(prefix) for line in lines), prefix
    log(f"[serve-cli] python -m repro_torch.launch.serve {' '.join(argv)}")
    log(f"[serve] phase 9 in {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# phase 10: training
# ---------------------------------------------------------------------------

def _leaf_map(tree) -> dict:
    from repro_torch.training.optimizer import tree_flatten
    return {"/".join(map(str, p)): t for p, t in tree_flatten(tree)}


def _backward(torch, fn, inputs, g):
    """fn(*leaves) and the floating leaves' gradients for output grad g."""
    leaves = [t.detach().clone().requires_grad_(t.is_floating_point())
              for t in inputs]
    out = fn(*leaves)
    out.backward(g)
    return out.detach(), [t.grad for t in leaves if t.is_floating_point()]


def train_functions(torch, dev, emb, wide, schema, sample_ids) -> None:
    """Phase 10 (c): each kernel's autograd Function on the card against
    autograd through its plain version on the card, at the training
    path's shapes; K1's table gradient bitwise across two calls."""
    from repro_torch.kernels import autograd as kad
    from repro_torch.kernels.fused_cross import (fused_cross_v1_plain,
                                                 fused_cross_v2_plain)
    from repro_torch.kernels.fused_fm import fused_fm_second_order_plain
    from repro_torch.kernels.multi_table_lookup import mtl_gather_plain

    g = torch.Generator(device=dev).manual_seed(SEED + 10)
    ids = torch.from_numpy(sample_ids(schema, TRAIN_BATCH,
                                      step=120_000)).to(dev)
    offsets = emb.offsets
    for name, table in (("d=32", emb.dense_view()),
                        ("d=1", wide.dense_view())):
        d = table.shape[1]
        grad = torch.randn((TRAIN_BATCH, schema.k * d), device=dev,
                           generator=g)
        out, (tg,) = _backward(
            torch, lambda t: kad.mtl_gather(ids, offsets, t), [table], grad)
        want_out, (want,) = _backward(
            torch, lambda t: mtl_gather_plain(ids, offsets, t), [table],
            grad)
        assert torch.equal(out, want_out), name
        # a row's gradient sums up to b of the N(0, 1) output gradients
        # (Criteo's 2-row fields: ~512 each, |sum| up to ~60), in another
        # order than index_select's backward: a few float32 ulps there
        torch.testing.assert_close(tg, want, rtol=1e-5, atol=1e-4)
        _, (again,) = _backward(
            torch, lambda t: kad.mtl_gather(ids, offsets, t), [table], grad)
        assert torch.equal(tg, again), f"K1 {name}: table gradient differs"
        log(f"[train] (c) K1 {name} backward: rows touched "
            f"{int((tg != 0).any(dim=1).sum())}, max|fn-plain|="
            f"{(tg - want).abs().max().item():.3e}, bitwise across calls")
        del tg, want, again
    b, dim = TRAIN_BATCH, schema.k * 32

    def rand(*shape):
        return torch.randn(shape, device=dev, generator=g)
    for kind, same in (("v2", True), ("v2", False), ("v1", True),
                       ("v1", False)):
        if kind == "v2":
            args = [rand(b, dim), rand(b, dim)]
            fn, plain = kad.fused_cross_v2, fused_cross_v2_plain
        else:
            args = [rand(b, dim), rand(b, 1), rand(dim)]
            fn, plain = kad.fused_cross_v1, fused_cross_v1_plain
        if not same:
            args.append(rand(b, dim))

        def call(f, _same=same):
            return (lambda *a: f(*a, a[0])) if _same else f
        grad = rand(b, dim)
        out, grads = _backward(torch, call(fn), args, grad)
        want_out, want = _backward(torch, call(plain), args, grad)
        assert torch.equal(out, want_out), kind
        err = 0.0
        for got, exp in zip(grads, want):
            torch.testing.assert_close(got, exp, **LADDER_TOL)
            err = max(err, (got - exp).abs().max().item())
        log(f"[train] (c) K{9 if kind == 'v2' else 10} backward, "
            f"{'x is x0' if same else 'x apart'}: max|fn-plain|={err:.3e}")
    v = rand(b, schema.k, 32) * 0.05          # embedding scale, as phase 3
    grad = rand(b, 1)
    out, (dv,) = _backward(torch, kad.fused_fm_second_order, [v], grad)
    want_out, (want,) = _backward(torch, fused_fm_second_order_plain, [v],
                                  grad)
    torch.testing.assert_close(out, want_out, **FM_TOL)
    torch.testing.assert_close(dv, want, **FM_TOL)
    log(f"[train] (c) K11 backward: max|fn-plain|="
        f"{(dv - want).abs().max().item():.3e}")


def train_vs_cpu(torch, dev, schema) -> dict:
    """Phase 10 (b): one backward of small DCNv2, DCN, DeepFM and
    Wide&Deep on the same weights and batch on the card and on the CPU;
    every leaf's gradient within ``CPU_TOL``. Returns the card runs'
    launch counts."""
    from repro_torch.configs import ctr_spec
    from repro_torch.data import synthetic_batch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.ctr import CTR_MODELS

    small = schema.scaled(TRAIN_SMALL_FIELD)
    batch = synthetic_batch(small, 0, TRAIN_BATCH, device="cpu")
    launches: dict = {}
    for name in CTR_MODELS:
        spec = ctr_spec(name, "criteo", embed_dim=32, hidden=64,
                        max_field=TRAIN_SMALL_FIELD)
        cpu_model = CTR_MODELS[name](spec, device="cpu").init(
            torch.Generator().manual_seed(SEED))
        model = CTR_MODELS[name](spec, device=dev)
        model.load_state_dict(cpu_model.state_dict())
        grads = {}
        for where, m in (("cpu", cpu_model), ("cuda", model)):
            tree = m.param_tree()
            reset_launch_counts()
            m.loss({k: v.to(m.device) for k, v in batch.items()}).backward()
            counts = launch_counts()
            grads[where] = {k: t.grad for k, t in _leaf_map(tree).items()}
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n
        err = 0.0
        for key, want in grads["cpu"].items():
            got = grads["cuda"][key]
            assert got is not None and want is not None, f"{name} {key}"
            torch.testing.assert_close(got.cpu(), want, **CPU_TOL)
            err = max(err, (got.cpu() - want).abs().max().item())
        table = grads["cuda"]["emb/mega_table"]
        assert table.abs().sum().item() > 0, name
        log(f"[train] (b) {name}: {len(grads['cpu'])} leaves, every one "
            f"with a gradient, max|card-cpu|={err:.3e}; launches "
            f"{ {k: n for k, n in counts.items() if n} }")
    return launches


def train_resume(torch, dev, schema) -> None:
    """Phase 10 (d): 6 steps unbroken equal 3 steps, a restore from the
    checkpoint into a fresh model, then 3 more — bitwise on the card."""
    import tempfile

    from repro_torch.configs import ctr_spec
    from repro_torch.data import CTRLoader
    from repro_torch.models.ctr import CTR_MODELS
    from repro_torch.training import (AdamWConfig, TrainLoopConfig,
                                      adamw_init, make_ctr_step,
                                      run_train_loop)

    small = schema.scaled(TRAIN_SMALL_FIELD)
    spec = ctr_spec("dcnv2", "criteo", embed_dim=32, hidden=1024,
                    max_field=TRAIN_SMALL_FIELD)
    opt = AdamWConfig(lr=TRAIN_LR)
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        def run(total, sub):
            model = CTR_MODELS["dcnv2"](spec, device=dev).init(
                torch.Generator(device=dev).manual_seed(SEED))
            cfg = TrainLoopConfig(total_steps=total, ckpt_every=3,
                                  ckpt_dir=f"{tmp}/{sub}", log_every=1000)
            state, hist = run_train_loop(
                make_ctr_step(model, opt),
                adamw_init(model.param_tree(), opt),
                CTRLoader(small, TRAIN_BATCH, device=dev), cfg)
            return state, hist
        whole, h1 = run(6, "a")
        run(3, "b")
        resumed, h2 = run(6, "b")
    assert [r["loss"] for r in h1[3:]] == [r["loss"] for r in h2]
    for (key, a), (_, b) in zip(_leaf_map(whole).items(),
                                _leaf_map(resumed).items()):
        assert torch.equal(a, b), f"resumed {key} differs"
    log(f"[train] (d) 6 steps == 3 + restore + 3, bitwise: every one of "
        f"{len(_leaf_map(whole))} leaves; losses {[round(r['loss'], 6) for r in h2]}")


def trace_ranges(torch, run, n_steps: int, names, tag: str) -> dict:
    """``run()`` (``n_steps`` steps) under ``torch.profiler``; its device
    time split by the host range each kernel was launched from (the first
    of ``names`` whose span holds the launch; "other" outside them all),
    per step, with the busy time (the union of the device intervals) a
    step, the idle share of the window, the host ms a step in each range
    and the device time a step by kernel name. The trace goes to
    ``build/traces/<tag>.json``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    out = ROOT / "build" / "traces"
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"{tag}.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())["traceEvents"]
    xs = [e for e in trace if e.get("ph") == "X"]
    device = [e for e in xs if e.get("cat") in ("kernel", "gpu_memcpy",
                                                 "gpu_memset")]
    if not device:
        raise RuntimeError(f"the {tag} trace recorded no device events")
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in xs
                 if e.get("cat") in ("cuda_runtime", "cuda_driver")
                 and "correlation" in e.get("args", {})}
    ranges = {name: [(e["ts"], e["ts"] + e["dur"]) for e in xs
                     if e.get("cat") == "user_annotation"
                     and e["name"] == name]
              for name in names}
    split: dict = {}
    for e in device:
        t = launch_ts.get(e["args"].get("correlation"))
        part = "other"
        for name, spans in ranges.items():
            if t is not None and any(a <= t <= b for a, b in spans):
                part = name
                break
        split[part] = split.get(part, 0.0) + e["dur"] / n_steps
    busy, window = device_busy(device)
    by_kernel: dict = {}
    for e in device:
        by_kernel[e["name"]] = (by_kernel.get(e["name"], 0.0)
                                + e["dur"] / n_steps)
    return {"busy_us": busy / n_steps, "idle_share": 1 - busy / window,
            "split_us": split,
            "host_ms": {name: sum(b - a for a, b in spans) / n_steps / 1e3
                        for name, spans in ranges.items()},
            "by_kernel": by_kernel}


TRAIN_RANGES = ("train/forward", "train/backward", "train/optimizer")


def trace_train(torch, step_fn, state, loader, start: int):
    """Phase 10 (e), second half: a profiler trace of ``TRACE_STEPS``
    steps; device time per step split by the host range each kernel was
    launched from (``train/forward``, ``train/backward`` — less K1's table
    gradient, ``mtl_gather_backward`` —, ``train/optimizer``, the rest:
    the batch's copies), and the idle share of the window."""
    def run():
        nonlocal state
        for i in range(TRACE_STEPS):
            state, m = step_fn(state, loader(start + i))
            float(m["loss"])

    t = trace_ranges(torch, run, TRACE_STEPS,
                     ("mtl_gather_backward",) + TRAIN_RANGES,
                     f"train_dcnv2_b{TRAIN_BATCH}")
    log(f"[train] (e) trace {TRACE_STEPS} steps: device busy "
        f"{t['busy_us']:.1f} us/step, idle share of window "
        f"{t['idle_share']:.3f}; device us/step by launching range "
        f"{ {k: round(v, 1) for k, v in sorted(t['split_us'].items())} }; "
        f"host ms/step per range "
        f"{ {k: round(v, 3) for k, v in t['host_ms'].items()} }")
    for kname, dur in sorted(t["by_kernel"].items(),
                             key=lambda kv: -kv[1])[:8]:
        log(f"[train]   {dur:9.1f} us/step  {kname[:90]}")
    return state


def run_training(torch, dev, schema, sample_ids) -> dict:
    """Phase 10: training (see the docstring). Returns the launch counts of
    its runs, each read just after the counters were reset for it."""
    import tempfile

    import numpy as np

    from repro_torch.configs import ctr_spec
    from repro_torch.core import compile_plan
    from repro_torch.data import CTRLoader, synthetic_batch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.ctr import CTR_MODELS
    from repro_torch.training import (AdamWConfig, TrainLoopConfig,
                                      adamw_init, logloss, make_ctr_step,
                                      restore_checkpoint, roc_auc,
                                      run_train_loop)
    from repro_torch.training.optimizer import tree_map

    t_phase = time.perf_counter()
    # (a) full width: the configuration of record, 300 steps, one checkpoint
    spec = ctr_spec("dcnv2", "criteo", embed_dim=32, hidden=1024)
    model = CTR_MODELS["dcnv2"](spec, device=dev).init(
        torch.Generator(device=dev).manual_seed(SEED))
    opt = AdamWConfig(lr=TRAIN_LR)
    state = adamw_init(model.param_tree(), opt)
    n_params = sum(t.numel() for t in _leaf_map(state.params).values())
    step_fn = make_ctr_step(model, opt)
    loader = CTRLoader(schema, TRAIN_BATCH, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        cfg = TrainLoopConfig(total_steps=TRAIN_STEPS,
                              ckpt_every=TRAIN_STEPS, ckpt_dir=tmp,
                              log_every=50)
        reset_launch_counts()
        t0 = time.perf_counter()
        state, hist = run_train_loop(step_fn, state, loader, cfg)
        loop_s = time.perf_counter() - t0
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        ckpt = Path(tmp) / f"step_{TRAIN_STEPS}"
        ckpt_bytes = sum(f.stat().st_size for f in ckpt.iterdir())
        target = tree_map(torch.empty_like, state)
        t0 = time.perf_counter()
        restore_checkpoint(tmp, TRAIN_STEPS, target)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        want = _leaf_map(state)
        for key, t in _leaf_map(target).items():
            assert torch.equal(t, want[key]), f"checkpoint leaf {key} differs"
        del target, want
    losses = np.array([r["loss"] for r in hist])
    secs = np.array([r["sec"] for r in hist])
    assert len(losses) == TRAIN_STEPS and np.isfinite(losses).all()
    first, last = losses[:10].mean(), losses[-10:].mean()
    assert last < first, f"loss did not fall: {first} -> {last}"
    assert counts["mtl_gather"] == TRAIN_STEPS, counts
    assert counts["fused_cross_v2"] == 3 * TRAIN_STEPS, counts
    launches = {"mtl_gather": counts["mtl_gather"],
                "fused_cross_v2": counts["fused_cross_v2"]}
    log(f"[train] (a) dcnv2 full width, {n_params / 1e6:.1f}M parameters, "
        f"b={TRAIN_BATCH}, AdamW lr={TRAIN_LR}: {TRAIN_STEPS} steps in "
        f"{loop_s:.2f} s with one checkpoint; loss mean of the first 10 "
        f"{first:.6f} -> last 10 {last:.6f}; loop step p50 "
        f"{np.median(secs[50:]) * 1e3:.3f} ms (batch made on the host "
        f"included); launches {counts['mtl_gather']} K1, "
        f"{counts['fused_cross_v2']} K9; peak device memory "
        f"{peak / 2**30:.2f} GiB")
    log(f"[train] (a) checkpoint {ckpt_bytes / 1e9:.3f} GB, restored "
        f"bitwise in {restore_s:.2f} s")
    plan = compile_plan(model, "dual", VAL_ROWS, device=dev)
    val = synthetic_batch(schema, VAL_STEP, VAL_ROWS, device="cpu")
    probs = plan.predict(val["ids"].numpy())
    labels = val["labels"].numpy()
    assert np.isfinite(probs).all() and ((probs > 0) & (probs < 1)).all()
    log(f"[train] (a) val AUC = {roc_auc(labels, probs):.4f}   LogLoss = "
        f"{logloss(labels, probs):.4f} (dual plan, b={VAL_ROWS})")

    # (e) step time at full width, then a trace
    times = []
    for i in range(STEP_TIMES):
        batch = loader(TRAIN_STEPS + i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        float(m["loss"])
        times.append(time.perf_counter() - t0)
    log(f"[train] (e) step p50 {np.median(times) * 1e3:.3f} ms, p90 "
        f"{np.percentile(times, 90) * 1e3:.3f} ms over {STEP_TIMES} steps "
        f"(batch on the card before the clock starts)")
    state = trace_train(torch, step_fn, state, loader,
                        TRAIN_STEPS + STEP_TIMES)
    del state, step_fn, model, plan
    torch.cuda.empty_cache()

    # (b) card against CPU, (c) the Functions, (d) resume
    for k, n in train_vs_cpu(torch, dev, schema).items():
        if k in ("fused_cross_v1", "fused_fm_second_order"):
            launches[k] = n
    from repro_torch.embedding import FusedEmbeddingCollection
    emb = FusedEmbeddingCollection(spec.embedding_spec(), device=dev)
    wide = FusedEmbeddingCollection(spec.wide_spec(), device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    emb.store.reset_parameters(gen)
    wide.store.reset_parameters(gen)
    train_functions(torch, dev, emb, wide, schema, sample_ids)
    del emb, wide
    torch.cuda.empty_cache()
    train_resume(torch, dev, schema)
    log(f"[train] phase 10 took {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 11: multi-device at full width
# ---------------------------------------------------------------------------

MESH_SHAPES = ((1, 4), (2, 2), (4, 1))
MESH_BATCHES = (256, 1024)
MESH_REQUESTS = 16          # full-batch requests a plan serves in (a)
MESH_SERVE = 32             # requests an engine serves in (b) and (c)
MESH_REFRESH = 8            # (b): a refresh every 8 requests
MESH_DELTA_ROWS = 1024      # (b): one delta batch halfway


def mesh_of(torch, shape, axes=("data", "model")):
    """A mesh: one card a position where there are enough cards, else
    every position explicitly on cuda:0."""
    import math

    from repro_torch.distributed import make_mesh
    n = math.prod(shape)
    if torch.cuda.device_count() >= n:
        return make_mesh(shape, axes)
    return make_mesh(shape, axes, [torch.device("cuda", 0)] * n)


def add_counts(total: dict, counts: dict) -> None:
    for name, n in counts.items():
        total[name] = total.get(name, 0) + n


def serve_counted(torch, plan, ids_list) -> tuple[list, dict]:
    """``plan.predict`` on each batch of ``ids_list`` with the launch
    counters reset just before and read just after."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    torch.cuda.synchronize()
    reset_launch_counts()
    out = [plan.predict(ids) for ids in ids_list]
    torch.cuda.synchronize()
    return out, launch_counts()


def per_step(counts: dict, steps: int, want: dict, tag: str) -> None:
    """Every kernel of ``want`` launched exactly ``want[k]`` times a step,
    every other kernel never."""
    for name, n in counts.items():
        assert n == want.get(name, 0) * steps, (tag, name, n, want, steps)


def mesh_turns(torch, plans: dict, feeds: dict) -> dict:
    """p50 of ``predict`` and of the host enqueue of one step
    (``plan(ids)`` returning) for each plan, measured in turns (a, b, c,
    c, b, a, ...), each on its own batches (``feeds[tag]``: a callable
    giving round r's ids, made before the clock starts)."""
    import numpy as np

    tags = list(plans)
    lat = {t: [] for t in tags}
    enq = {t: [] for t in tags}
    for r in range(LATENCY_WARMUP + LATENCY_SAMPLES):
        for tag in (tags if r % 2 == 0 else tags[::-1]):
            plan = plans[tag]
            ids = feeds[tag](r)
            t0 = time.perf_counter()
            plan.predict(ids)
            lat[tag].append((time.perf_counter() - t0) * 1e3)
            ids_dev = torch.from_numpy(ids).to(plan.device)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            plan(ids_dev)
            enq[tag].append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
    return {t: (float(np.percentile(lat[t][LATENCY_WARMUP:], 50)),
                float(np.percentile(enq[t][LATENCY_WARMUP:], 50)))
            for t in tags}


def log_turns(label: str, times: dict) -> None:
    base = times["meshless"]
    for tag, (p50, enq) in times.items():
        log(f"[mesh] (f) {label} {tag}: p50 {p50:.3f} ms ({p50 / base[0]:.2f}x"
            f" the mesh-less plan), host enqueue p50 {enq:.3f} ms "
            f"({enq / base[1]:.2f}x)")


def mesh_dense(torch, dev, schema, sample_ids, launches: dict) -> None:
    """(a) dense plans: DCNv2 on (1, 4), (2, 2), (4, 1) at b = 256 and
    1024; DCN, DeepFM and int8-compute DCNv2 on (2, 2)."""
    import numpy as np

    from repro_torch.configs import ctr_spec
    from repro_torch.core import compile_plan, place_params
    from repro_torch.models.ctr import CTR_MODELS

    runs = [("dcnv2", "fp32", MESH_SHAPES), ("dcn", "fp32", ((2, 2),)),
            ("deepfm", "fp32", ((2, 2),)), ("dcnv2", "int8", ((2, 2),))]
    for name, cd, shapes in runs:
        spec = ctr_spec(name, "criteo", embed_dim=32, hidden=1024)
        model = CTR_MODELS[name](spec, device=dev).init(
            torch.Generator(device=dev).manual_seed(SEED))
        rows = spec.embedding_spec().rows
        tables = 2 if name == "deepfm" else 1
        for b in MESH_BATCHES:
            base = compile_plan(model, "dual", b, device=dev,
                                compute_dtype=cd)
            feed = [sample_ids(schema, b, step=40_000 + r)
                    for r in range(MESH_REQUESTS)]
            want = [base.predict(ids) for ids in feed]
            plans = {"meshless": base}
            for shape in shapes:
                mesh = mesh_of(torch, shape)
                placed = place_params(model, mesh)
                table = placed["emb"]["mega_table"]
                assert tuple(table.sharding.spec) == ("model", None)
                shard = table.local((0, shape[1] - 1))
                assert shard.shape[0] == rows // shape[1]
                plan = compile_plan(model, "dual", b, mesh=mesh,
                                    placed=placed, compute_dtype=cd)
                got, counts = serve_counted(torch, plan, feed)
                d, m = shape
                step = {"mtl_gather": tables * d * m}
                if name == "dcnv2":
                    step["fused_cross_v2"] = 3 * d
                elif name == "dcn":
                    step["fused_cross_v1"] = 3 * d
                else:
                    step["fused_fm_second_order"] = d
                if cd == "int8":
                    step["dmm_q8"] = step["quantize_rows_q8"] = 3 * d
                tag = f"{name} {cd} {shape} b={b}"
                per_step(counts, MESH_REQUESTS, step, tag)
                add_counts(launches, counts)
                err = max(float(np.abs(g - w).max())
                          for g, w in zip(got, want))
                for g, w in zip(got, want):
                    assert np.isfinite(g).all() and g.shape == (b,), tag
                    if d == 1:
                        assert np.array_equal(g, w), tag
                    else:
                        np.testing.assert_allclose(g, w, **LADDER_TOL,
                                                   err_msg=tag)
                log(f"[mesh] (a) {tag}: {'bitwise' if d == 1 else 'within'}"
                    f" the mesh-less plan (max |diff| {err:.3e}); shard "
                    f"{shard.numel() * shard.element_size() / 1e6:.1f} MB; "
                    f"launches a step {step}; compile "
                    f"{plan.compile_ms:.0f} ms")
                plans[str(shape)] = plan
            feeds = {t: (lambda r, b=b: sample_ids(schema, b,
                                                   step=41_000 + r))
                     for t in plans}
            log_turns(f"{name} {cd} b={b}", mesh_turns(torch, plans, feeds))
        del model, base, plans, placed
        torch.cuda.empty_cache()


def mesh_engines(torch, dev, schema, sample_ids, launches: dict) -> None:
    """(b) cached fp32 and int8 DCNv2 engines and (c) the host fp32 one,
    on (2, 2): against a mesh-less twin engine given the same requests,
    refreshes and deltas."""
    import numpy as np

    from repro_torch.configs import ctr_spec
    from repro_torch.embedding import CachedStore, HostBackedStore
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.ctr import CTR_MODELS
    from repro_torch.serving import BucketedBatch, InferenceEngine

    spec = ctr_spec("dcnv2", "criteo", embed_dim=32, hidden=1024)
    es = spec.embedding_spec()
    shape = (2, 2)
    mesh = mesh_of(torch, shape)
    for kind in ("cached", "cached_int8", "host"):
        engs, stores = [], []
        for m in (mesh, None):
            model = CTR_MODELS["dcnv2"](spec, device=dev).init(
                torch.Generator(device=dev).manual_seed(SEED))
            if kind == "host":
                store = HostBackedStore(es, CACHE_CAPACITY, STAGING_CAPACITY,
                                        device=dev)
            else:
                store = CachedStore(es, CACHE_CAPACITY, "int8" if kind
                                    == "cached_int8" else None, device=dev)
            stores.append(store)
            engs.append(InferenceEngine(model, store=store, mesh=m,
                                        device=dev,
                                        policy=BucketedBatch(MESH_BATCHES)))
            del model
        eng, twin = engs
        try:
            eng.warmup()
            twin.warmup()
            compiles = eng.stats.cache_misses
            pub = eng.published
            if kind == "host":          # the store's own buffers, or
                for edge, t in pub.items():     # its replicas on other cards
                    assert t.sharding.is_fully_replicated, edge
                    own = getattr(stores[0], edge.split(":")[1])
                    for pos in np.ndindex(*shape):
                        local = t.local(pos)
                        assert local.device == mesh.devices[pos], edge
                        assert (local is own) == (local.device
                                                  == own.device), edge
            else:
                backing = pub["emb:backing"]
                assert tuple(backing.sharding.spec) == ("model", None)
                for pos in np.ndindex(*shape):
                    local = backing.local(pos)
                    assert local.shape[0] == es.rows // 2, local.shape
                    assert local.device == mesh.devices[pos]
            rng = np.random.default_rng(SEED)
            rows = rng.choice(es.zero_row, MESH_DELTA_ROWS, replace=False)
            vals = (rng.normal(size=(MESH_DELTA_ROWS, es.dim))
                    * 0.05).astype(np.float32)
            counts, err, swaps = {}, 0.0, 0
            for r in range(MESH_SERVE):
                b = MESH_BATCHES[r % 2]
                ids = sample_ids(schema, b, step=42_000 + r)
                if r == MESH_SERVE // 2:
                    assert eng.push_update(rows, vals) == MESH_DELTA_ROWS
                    assert twin.push_update(rows, vals) == MESH_DELTA_ROWS
                want = twin.predict(ids)
                torch.cuda.synchronize()
                reset_launch_counts()
                got = eng.predict(ids)
                torch.cuda.synchronize()
                add_counts(counts, launch_counts())
                assert np.isfinite(got).all() and got.shape == (b,)
                np.testing.assert_allclose(got, want, **LADDER_TOL,
                                           err_msg=f"{kind} request {r}")
                err = max(err, float(np.abs(got - want).max()))
                if (r + 1) % MESH_REFRESH == 0:
                    probe = sample_ids(schema, 256, step=43_000 + r)
                    pre = eng.predict(probe)
                    eng.refresh_cache()
                    twin.refresh_cache()
                    assert np.array_equal(eng.predict(probe), pre), kind
                    swaps += 1
            assert eng.stats.cache_misses == compiles == 2, eng.stats
            assert eng.stats.emb_cache_refreshes == swaps
            gather = {"cached": "mtl_gather_two_level",
                      "cached_int8": "mtl_gather_two_level_q8",
                      "host": "mtl_gather_three_level"}[kind]
            d, m = shape
            step = {gather: d * (m if kind != "host" else 1),
                    "fused_cross_v2": 3 * d}
            per_step(counts, MESH_SERVE, step, kind)
            add_counts(launches, counts)
            log(f"[mesh] ({'c' if kind == 'host' else 'b'}) {kind} DCNv2 "
                f"{shape}: {MESH_SERVE} requests within the mesh-less "
                f"engine (max |diff| {err:.3e}), {swaps} refreshes bitwise "
                f"across the swap, one {MESH_DELTA_ROWS}-row push, "
                f"{eng.stats.cache_misses} compiles (the two buckets at "
                f"warmup); launches a step {step}")
            for b in MESH_BATCHES:
                ids = sample_ids(schema, b, step=44_000)
                if kind == "host":
                    stores[0].stage(ids)
                    stores[1].stage(ids)
                plans = {"meshless": twin.plan_for(b), "(2, 2)":
                         eng.plan_for(b)}
                log_turns(f"dcnv2 {kind} b={b}", mesh_turns(
                    torch, plans, {t: (lambda r, i=ids: i) for t in plans}))
        finally:
            for store in stores:
                if kind == "host":
                    store.pipeline.stop()
        del engs, eng, twin, stores
        torch.cuda.empty_cache()


def mesh_runtime(torch, dev, schema, sample_ids, launches: dict) -> None:
    """(d) ServingRuntime(mesh=(2, 2)) hosting cached DCNv2 and dense
    DeepFM, served in waves, then refresh_all: within tolerance of
    mesh-less engines."""
    import numpy as np

    from repro_torch.configs import ctr_spec
    from repro_torch.embedding import CachedStore
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.ctr import CTR_MODELS
    from repro_torch.serving import (BucketedBatch, InferenceEngine,
                                     ServingRuntime)

    mesh = mesh_of(torch, (2, 2))
    rt = ServingRuntime(mesh=mesh)
    twins = {}
    for name in ("dcnv2", "deepfm"):
        spec = ctr_spec(name, "criteo", embed_dim=32, hidden=1024)
        for host in (rt, None):
            model = CTR_MODELS[name](spec, device=dev).init(
                torch.Generator(device=dev).manual_seed(SEED))
            store = (CachedStore(spec.embedding_spec(), CACHE_CAPACITY,
                                 device=dev) if name == "dcnv2" else None)
            kw = dict(policy=BucketedBatch(MESH_BATCHES), store=store,
                      device=dev)
            if host is rt:
                rt.add_model(name, model, **kw)
            else:
                twins[name] = InferenceEngine(model, **kw)
    assert all(rt.engine(n).mesh is mesh for n in rt.models)
    rt.warmup()
    counts, err, served = {}, 0.0, 0
    for w, n in enumerate((300, 1024, 90, 700)):
        if w == 2:
            pre = {name: rt.predict(name, sample_ids(schema, 64, step=45_999))
                   for name in rt.models}
            assert rt.refresh_all() == 1
            for name, twin in twins.items():
                twin.refresh_cache()
                assert np.array_equal(rt.predict(name, sample_ids(
                    schema, 64, step=45_999)), pre[name]), name
        for name in rt.models:
            ids = sample_ids(schema, n, step=45_000 + w)
            torch.cuda.synchronize()
            reset_launch_counts()
            rt.submit_many(name, list(ids))
            got = rt.engine(name).serve_pending()
            torch.cuda.synchronize()
            add_counts(counts, launch_counts())
            want = twins[name].predict(ids)
            np.testing.assert_allclose(got, want, **LADDER_TOL,
                                       err_msg=f"runtime {name} wave {w}")
            err = max(err, float(np.abs(got - want).max()))
            served += n
    add_counts(launches, counts)
    stats = {n: rt.engine(n).stats for n in rt.models}
    log(f"[mesh] (d) ServingRuntime(mesh=(2, 2)): {served} requests over "
        f"cached DCNv2 and dense DeepFM in waves, one refresh_all, within "
        f"mesh-less engines (max |diff| {err:.3e}); batches "
        f"{ {n: s.n_batches for n, s in stats.items()} }, compiles "
        f"{ {n: s.cache_misses for n, s in stats.items()} }; launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    del rt, twins
    torch.cuda.empty_cache()


def mesh_pooled(torch, dev, schema, launches: dict) -> None:
    """Pooled (h = 5) vocab-parallel lookups on (1, 4): K2 over the dense
    table's shards, K3 over a cached store's, within rtol 1e-5, atol 1e-5
    of the 1-device pooled lookup."""
    import numpy as np

    from repro_torch.configs import ctr_spec
    from repro_torch.embedding import CachedStore, FusedEmbeddingCollection
    from repro_torch.kernels import launch_counts, reset_launch_counts

    spec = ctr_spec("dcnv2", "criteo", embed_dim=32, hidden=1024)
    es = spec.embedding_spec()
    emb = FusedEmbeddingCollection(es, device=dev)
    emb.store.reset_parameters(torch.Generator(device=dev).manual_seed(SEED))
    cached = FusedEmbeddingCollection(es, store=CachedStore(
        es, CACHE_CAPACITY, device=dev))
    cached.store.adopt(dict(emb.store.named_buffers()))
    mesh = mesh_of(torch, (1, 4))
    rng = np.random.default_rng(SEED)
    for coll, kernel in ((emb, "mtl_gather_multihot"),
                         (cached, "mtl_gather_two_level")):
        tensors = coll.store.place(coll.store.device_tensors(), mesh)
        for b in MESH_BATCHES:
            ids = torch.from_numpy(np.stack(
                [rng.integers(0, n, size=(b, HOT))
                 for n in schema.field_sizes], axis=1).astype(np.int32)
            ).to(dev)
            mask = torch.from_numpy(rng.integers(
                0, 2, size=ids.shape).astype(np.float32)).to(dev)
            want = coll.forward_multihot(ids, mask)
            torch.cuda.synchronize()
            reset_launch_counts()
            got = coll.apply_multihot_sharded(ids, mask, mesh,
                                              tensors=tensors)
            torch.cuda.synchronize()
            counts = launch_counts()
            assert counts[kernel] == 4, counts
            add_counts(launches, counts)
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
            log(f"[mesh] pooled h={HOT} b={b} over (1, 4) through {kernel}: "
                f"4 shard launches, max |diff| "
                f"{float((got - want).abs().max()):.3e} from the 1-device "
                "pooled lookup")
    del emb, cached, tensors
    torch.cuda.empty_cache()


def mesh_compressed(torch, dev, schema) -> None:
    """(e) the compressed data-parallel step on full-width DCNv2, b = 1024,
    over data = 2, against the exact step: loss within 1e-5, the gradient
    within relative error 0.02 (max |compressed - exact| over max |exact|,
    every leaf together, as tests/distributed_inner.py:48-51 takes it for
    its one leaf); both timed."""
    import numpy as np

    from repro_torch.configs import ctr_spec
    from repro_torch.data import synthetic_batch
    from repro_torch.distributed.sharding import tree_map
    from repro_torch.models.ctr import CTR_MODELS
    from repro_torch.models.ctr.common import bce_loss
    from repro_torch.training import make_compressed_dp_step

    spec = ctr_spec("dcnv2", "criteo", embed_dim=32, hidden=1024)
    model = CTR_MODELS["dcnv2"](spec, device=dev).init(
        torch.Generator(device=dev).manual_seed(SEED))
    leaves = []
    params = model.param_tree()
    tree_map(leaves.append, params)
    names = {id(t): n for n, t in model.named_buffers()}
    order = [names[id(t)] for t in leaves]
    # the buffers outside the tree (the collections' field offsets), on
    # each rank's card
    others = {n: t for n, t in model.named_buffers() if n not in order}

    def loss_fn(p, batch):
        flat = []
        tree_map(flat.append, p)
        subs = {n: t.to(flat[0].device) for n, t in others.items()}
        subs.update(zip(order, flat))
        logits = torch.func.functional_call(model, subs, (batch["ids"],))
        return bce_loss(logits, batch["labels"])
    batch = synthetic_batch(schema, 0, 1024, device=dev)
    step = make_compressed_dp_step(loss_fn, mesh_of(torch, (2,), ("data",)))

    def exact():
        loss = loss_fn(params, batch)
        return loss.detach(), torch.autograd.grad(loss, leaves)

    def timed(fn):
        out, ms = None, []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        return out, float(np.percentile(ms[1:], 50))
    (loss_c, grads_c), ms_c = timed(lambda: step(params, batch))
    (loss_e, grads_e), ms_e = timed(exact)
    assert abs(float(loss_c) - float(loss_e)) < 1e-5, (loss_c, loss_e)
    flat_c = []
    tree_map(flat_c.append, grads_c)
    diff = max(float((gc - ge).abs().max())
               for gc, ge in zip(flat_c, grads_e))
    top = max(float(ge.abs().max()) for ge in grads_e)
    rel = diff / top
    assert rel < 0.02, (diff, top)
    worst = max((float((gc - ge).abs().max()) / float(ge.abs().max()), n)
                for n, gc, ge in zip(order, flat_c, grads_e)
                if ge.abs().max() > 0)
    for t in leaves:
        t.requires_grad_(False)
    log(f"[mesh] (e) compressed DP step, full-width DCNv2 b=1024 over "
        f"data=2 ({len(leaves)} leaves, {sum(t.numel() for t in leaves):,} "
        f"values): loss {float(loss_c):.6f} vs exact {float(loss_e):.6f}, "
        f"gradient relative error {rel:.5f} (< 0.02; the worst leaf alone "
        f"{worst[0]:.4f}, {worst[1]}); step p50 "
        f"{ms_c:.2f} ms against the exact step's {ms_e:.2f} ms")
    del model, params, leaves, grads_c, grads_e, flat_c
    torch.cuda.empty_cache()


def run_mesh(torch, dev, schema, sample_ids) -> dict:
    """Phase 11. Returns the launches of its paths."""
    t_phase = time.perf_counter()
    launches = {}
    mesh_dense(torch, dev, schema, sample_ids, launches)
    mesh_engines(torch, dev, schema, sample_ids, launches)
    mesh_runtime(torch, dev, schema, sample_ids, launches)
    mesh_pooled(torch, dev, schema, launches)
    mesh_compressed(torch, dev, schema)
    cards = torch.cuda.device_count()
    log(f"[mesh] on {cards} card(s): " + (
        "one card a position, cross-card copies included" if cards >= 4
        else "every mesh position on one card times orchestration, not "
        "scaling"))
    log(f"[mesh] phase 11 took {time.perf_counter() - t_phase:.1f} s")
    return {k: v for k, v in launches.items() if v}


# ---------------------------------------------------------------------------
# phase 12: the LM zoo's serving path
# ---------------------------------------------------------------------------

# (arch, layers on the card or None for all, prompt length): every arch at
# its published width in bf16; depth cut only where the weights would not
# fit the card (all 32 phi3.5-moe layers take ~83 GB; one llama4-maverick
# layer's experts alone are 16.1 B parameters). RWKV6's and Zamba2's
# recurrences step in Python, so their prompts are shorter.
LM_ARCHS = (("llama3-8b", None, 512), ("granite-8b", None, 512),
            ("smollm-360m", None, 512), ("qwen3-4b", None, 512),
            ("pixtral-12b", None, 512), ("phi3.5-moe-42b-a6.6b", 8, 512),
            ("llama4-maverick-400b-a17b", 1, 512), ("rwkv6-7b", None, 128),
            ("zamba2-1.2b", None, 128), ("whisper-small", None, 512))
LM_BATCH, LM_NEW, LM_PREFILL_RUNS = 4, 32, 5
LM_PATCHES, LM_FRAMES = 256, 1500     # pixtral's image rows; whisper's s_enc
# (b): prefill 127 + one decode against forward over 128 (4 x 128 = 512
# tokens: one MoE routing group, GROUP_SIZE)
LM_CHECK_PROMPT = 127
LM_CHECK_TOL = dict(rtol=5e-2, atol=5e-2)   # tests/test_lm_smoke.py:103
LM_TRACE_STEPS = 8
# (d): the flash branch (FLASH_THRESHOLD) and flash vs _sdpa at llama3's
# attention shape
LM_FLASH_SEQ = 4096
LM_FLASH_CHECK = dict(h=32, kv=8, hd=128, s=4096)
LM_CPU_DECODE = 4                   # (c): decode steps card vs CPU


def lm_config(arch: str, layers):
    """The configuration phase 12 runs: published, depth cut to
    ``layers`` where given."""
    import dataclasses

    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return cfg if layers is None else dataclasses.replace(cfg,
                                                          n_layers=layers)


def lm_inputs(torch, cfg, dev, b: int, s: int, seed: int):
    """(tokens (b, s), the family's prefill extras) from ``seed``:
    pixtral's ``LM_PATCHES`` patch rows × 0.02, whisper's ``LM_FRAMES``
    frames × 0.1, in the model's dtype."""
    g = torch.Generator(device=dev).manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab, (b, s), generator=g, device=dev)
    dtype = getattr(torch, cfg.dtype)
    rows = {"vlm": ("patch_embeds", LM_PATCHES, 0.02),
            "encdec": ("frames", LM_FRAMES, 0.1)}.get(cfg.family)
    extra = {}
    if rows:
        name, n, scale = rows
        extra[name] = (torch.randn((b, n, cfg.d_model), generator=g,
                                   device=dev) * scale).to(dtype)
    return tokens, extra


def lm_prefill(model, tokens, extra, new: int):
    """A cache for ``new`` more tokens and the prefill into it, as
    ``generate`` makes them."""
    b, s = tokens.shape
    fam = model.cfg.family
    if fam == "encdec":
        cache = model.init_cache(b, s + new, extra["frames"].shape[1])
        return model.prefill(tokens, extra["frames"], cache)
    if fam == "ssm":
        return model.prefill(tokens, model.init_cache(b, 0))
    if fam == "vlm":
        cache = model.init_cache(b, extra["patch_embeds"].shape[1] + s + new)
        return model.prefill(tokens, cache, **extra)
    return model.prefill(tokens, model.init_cache(b, s + new))


def dispatch_counts(torch, fn, min_copy: int = 0) -> tuple[dict, int, int]:
    """Run ``fn`` once; return 2·m·n·k of every GEMM it dispatches
    (``analysis.roofline.gemm_flops``, the dry run's counter: ``mm``/
    ``addmm``/``bmm``/``baddbmm``; ``matmul`` and ``einsum`` lower to them)
    by operand dtype, the number of ATen ops it dispatches that are not
    views (each one host dispatch, nearly all a launch), and the bytes
    written by its copies (``_to_copy``, ``clone``, ``copy_``) of a
    source of at least ``min_copy`` elements."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.analysis.roofline import gemm_flops

    aten = torch.ops.aten
    copies = {aten._to_copy: 0, aten.clone: 0, aten.copy_: 1}
    counts: dict = {}
    ops = copied = 0

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            nonlocal ops, copied
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            ops += not func.is_view
            flops = gemm_flops(func, args, kwargs, out)
            if flops:
                dt = next(a.dtype for a in args
                          if isinstance(a, torch.Tensor))
                counts[dt] = counts.get(dt, 0) + flops
            i = copies.get(func.overloadpacket)
            if i is not None and args[i].numel() >= min_copy:
                copied += out.numel() * out.element_size()
            return out

    with Count():
        fn()
    return counts, ops, copied


def flops_ms(torch, counts: dict) -> float:
    """The least time of ``counts``' GEMMs: bf16 at the tensor-core rate,
    fp32 (TF32 off: attention logits, the MoE router) outside it."""
    rate = {torch.bfloat16: hw.PEAK_FLOPS_BF16,
            torch.float32: hw.PEAK_FLOPS_FP32}
    return sum(f / rate[dt] for dt, f in counts.items()) * 1e3


def tensor_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(tensor_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size() if hasattr(tree, "numel") \
        else 0


def trace_decode(torch, model, cache, nxt, n: int) -> float:
    """The device's idle share over ``n`` decode steps run as ``generate``
    runs them (argmax on the card, no sync between steps), under
    ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            logits, cache = model.decode_step(nxt, cache)
            nxt = logits.argmax(-1)[:, None]
        torch.cuda.synchronize()
    out = ROOT / "build" / "traces"
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"lm_decode_{model.cfg.name}.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())["traceEvents"]
    device = [e for e in trace if e.get("ph") == "X" and e.get("cat") in
              ("kernel", "gpu_memcpy", "gpu_memset")]
    if not device:
        raise RuntimeError("the decode trace recorded no device events")
    busy, window = device_busy(device)
    return 1 - busy / window


def lm_check(torch, model, dev) -> tuple[float, bool]:
    """(b): prefill ``LM_CHECK_PROMPT`` tokens + one decode step against
    the teacher-forced forward's last position (tests/test_lm_smoke.py:
    70-104; MoE at capacity_factor = n_experts, so nothing drops). Returns
    (max |diff|, greedy tokens agree)."""
    import dataclasses

    cfg = model.cfg
    if cfg.family == "moe":
        model.cfg = dataclasses.replace(cfg,
                                        capacity_factor=float(cfg.n_experts))
    try:
        tokens, extra = lm_inputs(torch, cfg, dev, LM_BATCH,
                                  LM_CHECK_PROMPT, SEED + 2)
        lp, cache = lm_prefill(model, tokens, extra, 1)
        nxt = lp.argmax(-1)[:, None]
        ld, _ = model.decode_step(nxt, cache)
        ref = model(torch.cat([tokens, nxt], 1), *extra.values())[:, -1]
    finally:
        model.cfg = cfg
    assert torch.isfinite(ld.float()).all() and torch.isfinite(
        ref.float()).all(), cfg.name
    diff = float((ld.float() - ref.float()).abs().max())
    agree = bool((ld.argmax(-1) == ref.argmax(-1)).all())
    if cfg.dtype == "float32":
        torch.testing.assert_close(ld, ref, **LM_CHECK_TOL)
    return diff, agree


def lm_vs_cpu(torch, dev, arch: str) -> float:
    """(c): the arch's ``reduced()`` fp32 model with the same weights on
    the card and on the CPU: forward, prefill and ``LM_CPU_DECODE`` decode
    steps (the CPU's greedy tokens fed to both) within ``CPU_TOL``.
    Returns the largest |card - CPU|."""
    from repro_torch.configs import get_config
    from repro_torch.models.lm import make_lm_model

    cfg = get_config(arch).reduced()
    cpu = torch.device("cpu")
    host = make_lm_model(cfg, device=cpu).init(
        torch.Generator().manual_seed(SEED))
    card = make_lm_model(cfg, device=dev)
    card.load_state_dict(host.state_dict())
    tokens, extra = lm_inputs(torch, cfg, cpu, 2, 16, SEED + 3)
    moved = {k: v.to(dev) for k, v in extra.items()}
    worst = 0.0

    def close(a, b):
        nonlocal worst
        torch.testing.assert_close(a.cpu(), b, **CPU_TOL)
        worst = max(worst, float((a.cpu() - b).abs().max()))

    close(card(tokens.to(dev), *moved.values()),
          host(tokens, *extra.values()))
    lh, ch = lm_prefill(host, tokens, extra, LM_CPU_DECODE)
    lc, cc = lm_prefill(card, tokens.to(dev), moved, LM_CPU_DECODE)
    close(lc, lh)
    for _ in range(LM_CPU_DECODE):
        nxt = lh.argmax(-1)[:, None]
        lh, ch = host.decode_step(nxt, ch)
        lc, cc = card.decode_step(nxt.to(dev), cc)
        close(lc, lh)
    return worst


def lm_flash(torch, model, dev) -> dict:
    """(d): one prefill at b = 1, s = ``LM_FLASH_SEQ`` (``_attend`` takes
    ``flash_attention`` in every layer), then ``flash_attention`` against
    ``_sdpa`` on the same fp32 q, k, v at ``LM_FLASH_CHECK``'s shape."""
    from repro_torch.models.lm import layers as L

    calls = []
    flash = L.flash_attention
    L.flash_attention = lambda *a, **kw: calls.append(1) or flash(*a, **kw)
    try:
        tokens, _ = lm_inputs(torch, model.cfg, dev, 1, LM_FLASH_SEQ,
                              SEED + 4)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, _ = lm_prefill(model, tokens, {}, 0)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
    finally:
        L.flash_attention = flash
    assert len(calls) == model.cfg.n_layers, len(calls)
    assert torch.isfinite(logits.float()).all()
    c = LM_FLASH_CHECK
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    q = torch.randn((1, c["s"], c["h"], c["hd"]), generator=g, device=dev)
    k, v = (torch.randn((1, c["s"], c["kv"], c["hd"]), generator=g,
                        device=dev) for _ in range(2))
    got = L.flash_attention(q, k, v, causal=True, q_chunk=L.FLASH_CHUNK,
                            k_chunk=L.FLASH_CHUNK)
    want = L._sdpa(q, k, v, causal=True)
    torch.testing.assert_close(got, want, **CPU_TOL)
    return {"prefill_ms": prefill_ms, "layers": len(calls),
            "max_abs_err": float((got - want).abs().max())}


def lm_arch(torch, dev, arch: str, layers, prompt: int, card: str) -> dict:
    """Phase 12 for one arch: load it, serve it, hold it to (b) and (c),
    measure (e); (d) and the idle share for llama3-8b."""
    from repro_torch.models.lm import make_lm_model
    from repro_torch.serving import generate

    cfg = lm_config(arch, layers)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model = make_lm_model(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights = tensor_bytes(model.state_dict())
    b = LM_BATCH
    tokens, extra = lm_inputs(torch, cfg, dev, b, prompt, SEED + 1)

    # (a) serve: generate, greedy
    t0 = time.perf_counter()
    out = generate(model, tokens, max_new=LM_NEW, **extra)
    torch.cuda.synchronize()
    generate_s = time.perf_counter() - t0
    assert tuple(out.shape) == (b, prompt + LM_NEW), out.shape
    assert torch.equal(out[:, :prompt], tokens)
    assert bool(((out >= 0) & (out < cfg.vocab)).all())

    # (e) prefill p50 over LM_PREFILL_RUNS, decode p50 over LM_NEW steps
    prefill_ms = []
    for _ in range(LM_PREFILL_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = lm_prefill(model, tokens, extra, LM_NEW)
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
    assert torch.isfinite(logits.float()).all(), arch
    cache_bytes = tensor_bytes(cache)
    nxt = logits.argmax(-1)[:, None]
    decode_ms = []
    for _ in range(LM_NEW):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = model.decode_step(nxt, cache)
        nxt = logits.argmax(-1)[:, None]
        torch.cuda.synchronize()
        decode_ms.append((time.perf_counter() - t0) * 1e3)
    assert torch.isfinite(logits.float()).all(), arch
    # the same steps queued back to back, as generate runs them
    logits, cache = lm_prefill(model, tokens, extra, LM_NEW)
    nxt = logits.argmax(-1)[:, None]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(LM_NEW):
        logits, cache = model.decode_step(nxt, cache)
        nxt = logits.argmax(-1)[:, None]
    torch.cuda.synchronize()
    queued_ms = (time.perf_counter() - t0) * 1e3 / LM_NEW
    peak = torch.cuda.max_memory_allocated() - base

    # bounds: every weight byte read once (decode: and the cache), the
    # GEMMs' operations at their dtype's rate, counted on this run
    pre_ops, _, _ = dispatch_counts(
        torch, lambda: lm_prefill(model, tokens, extra, 0))
    logits, cache = lm_prefill(model, tokens, extra, 1)
    dec_ops, step_ops, _ = dispatch_counts(torch, lambda: model.decode_step(
        logits.argmax(-1)[:, None], cache))
    prefill_bound = max(weights / hw.HBM_BW * 1e3,
                        flops_ms(torch, pre_ops))
    decode_bound = max((weights + cache_bytes) / hw.HBM_BW * 1e3,
                       flops_ms(torch, dec_ops))
    res = {
        "arch": arch, "family": cfg.family, "layers": cfg.n_layers,
        "weights_gb": weights / 1e9, "init_s": init_s,
        "generate_s": generate_s, "prompt": prompt,
        "prefill_p50_ms": sorted(prefill_ms)[len(prefill_ms) // 2],
        "prefill_bound_ms": prefill_bound,
        "prefill_tflop": {str(k).split(".")[-1]: v / 1e12
                          for k, v in pre_ops.items()},
        "decode_p50_ms": sorted(decode_ms)[len(decode_ms) // 2],
        "decode_queued_ms": queued_ms, "decode_bound_ms": decode_bound,
        "decode_ops": step_ops,
        "cache_gb": cache_bytes / 1e9,
        "tokens_per_s": b / (sorted(decode_ms)[len(decode_ms) // 2] / 1e3),
        "peak_gib": peak / 2**30}
    del cache, logits

    # (b) the reference's invariant, in bf16
    res["check_diff"], res["check_agree"] = lm_check(torch, model, dev)
    if arch == "llama3-8b":
        res["flash"] = lm_flash(torch, model, dev)
        logits, cache = lm_prefill(model, tokens, extra, LM_TRACE_STEPS)
        res["decode_idle_share"] = trace_decode(
            torch, model, cache, logits.argmax(-1)[:, None], LM_TRACE_STEPS)
    log(f"[lm] {arch} ({cfg.family}, L={cfg.n_layers}, {cfg.dtype}): "
        f"weights {res['weights_gb']:.2f} GB, init {init_s:.2f} s, "
        f"generate b={b} s={prompt}+{LM_NEW} {generate_s:.2f} s | prefill "
        f"p50 {res['prefill_p50_ms']:.2f} ms (bound {prefill_bound:.2f}: "
        f"{ {k: round(v, 3) for k, v in res['prefill_tflop'].items()} } "
        f"TFLOP) | decode p50 {res['decode_p50_ms']:.3f} ms/token (bound "
        f"{decode_bound:.3f}; queued {queued_ms:.3f}; {step_ops} ops, "
        f"{queued_ms / step_ops * 1e3:.1f} us an op queued), "
        f"{res['tokens_per_s']:.1f} tokens/s | peak "
        f"{res['peak_gib']:.2f} GiB above the phase's start | (b) "
        f"max|decode-forward| "
        f"{res['check_diff']:.4f}, greedy agree {res['check_agree']} | "
        f"{card}")
    if "flash" in res:
        f = res["flash"]
        log(f"[lm] (d) {arch} prefill b=1 s={LM_FLASH_SEQ}: flash_attention "
            f"in {f['layers']} layers, {f['prefill_ms']:.1f} ms; flash vs "
            f"_sdpa at {LM_FLASH_CHECK}: max|diff| {f['max_abs_err']:.3e} | "
            f"{card}")
        log(f"[lm] (e) {arch} idle share of {LM_TRACE_STEPS} queued decode "
            f"steps under torch.profiler: {res['decode_idle_share']:.3f} | "
            f"{card}")
    return res


def lm_fp32_check(torch, dev, card: str) -> float:
    """(b) in fp32 for llama3-8b at full width (32.1 GB): within the
    reference's 5e-2."""
    import dataclasses

    from repro_torch.models.lm import make_lm_model

    cfg = dataclasses.replace(lm_config("llama3-8b", None), dtype="float32")
    model = make_lm_model(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(SEED))
    diff, agree = lm_check(torch, model, dev)
    gb = tensor_bytes(model.state_dict()) / 1e9
    log(f"[lm] (b) llama3-8b fp32 ({gb:.2f} GB): max|decode-forward| "
        f"{diff:.3e} within {LM_CHECK_TOL}, greedy agree {agree} | {card}")
    return diff


def run_lm(torch, dev, card: str) -> list:
    """Phase 12: the LM zoo's serving path at full width (see the
    docstring). Returns one dict of numbers an arch."""
    t_phase = time.perf_counter()
    log(f"[lm] {torch.cuda.memory_allocated() / 2**30:.2f} GiB still "
        f"allocated by earlier phases")
    log("[lm] depth on the card: " + ", ".join(
        f"{a} {lm_config(a, n).n_layers}/{lm_config(a, None).n_layers}"
        for a, n, _ in LM_ARCHS))
    results = []
    for arch, layers, prompt in LM_ARCHS:
        results.append(lm_arch(torch, dev, arch, layers, prompt, card))
        torch.cuda.empty_cache()
        if arch == "llama3-8b":
            lm_fp32_check(torch, dev, card)
            torch.cuda.empty_cache()
    worst = {arch: lm_vs_cpu(torch, dev, arch) for arch, _, _ in LM_ARCHS}
    log(f"[lm] (c) reduced fp32, card vs CPU within {CPU_TOL}: max|diff| "
        f"{ {a: float(f'{w:.2e}') for a, w in worst.items()} }")
    path = ROOT / "chiprun_out" / "lm_phase12.json"
    path.parent.mkdir(exist_ok=True)
    path.write_text(json.dumps({"card": card, "archs": results}, indent=1))
    log(f"[lm] phase 12 took {time.perf_counter() - t_phase:.1f} s")
    return results


# ---------------------------------------------------------------------------
# phase 13: LM training
# ---------------------------------------------------------------------------

# (a) smollm-360m at full width and depth, bf16 parameters and fp32 AdamW
# state: the launcher's defaults (one CE chunk) and s = 2,048 (two chunks),
# remat on as published; warm steps, then timed steps, then a trace
LM_TRAIN_SHAPES = ((8, 64), (8, 2048))
LM_TRAIN_WARM, LM_TRAIN_STEPS, LM_TRAIN_TRACE = 3, 20, 3
# (b) every other arch at published width, b = 8, s = 64 (the launcher's
# defaults), 3 steps; depth cut only so that parameters, gradients and
# AdamW state (12 bytes a parameter with fp32 state, 8 with bf16 state),
# plus the eager optimizer's ~8 fp32 temporaries of the largest leaf (the
# embedding or an expert stack), stay near 60 GB. llama4-maverick trains
# on no single card: one layer's 128 experts are 16.17 B parameters.
LM_TRAIN_ARCHS = (("llama3-8b", 12), ("granite-8b", 18),
                  ("qwen3-4b", 32), ("pixtral-12b", 7),
                  ("phi3.5-moe-42b-a6.6b", 4), ("rwkv6-7b", 16),
                  ("zamba2-1.2b", None), ("whisper-small", None))
LM_TRAIN_SKIPPED = {"llama4-maverick-400b-a17b": (
    "one layer holds 16.17 B parameters (128 experts of 5120 x 8192 x 3): "
    "bf16 parameters, gradients and bf16 AdamW state take 8 bytes a "
    "parameter, 146 GB with the embeddings, over one card's 80 GB; it "
    "waits for the LM mesh")}
# the reference picks bf16 AdamW state above 30 B parameters
# (src/repro/launch/steps.py:83-86), counted on the published config
BF16_STATE_PARAMS = 30_000_000_000
LM_TRAIN_B, LM_TRAIN_S, LM_TRAIN_ARCH_STEPS = 8, 64, 3


def lm_param_counts(cfg) -> tuple[int, int]:
    """(parameters, parameters of the GEMMs) of ``cfg`` at its depth, from
    its shapes on the meta device: every leaf, and the leaves of two or
    more dimensions but an untied embedding table (gathered, not
    multiplied)."""
    from repro_torch.bridge import _leaves
    from repro_torch.models.lm import layers as L
    from repro_torch.models.lm import make_lm_model

    add = L.add_buffers

    def meta(module, device, dtype, **shapes):
        add(module, "meta", dtype, **shapes)
    L.add_buffers = meta
    try:
        tree = make_lm_model(cfg, device="cpu").tensor_tree()
    finally:
        L.add_buffers = add
    total = gemm = 0
    for path, t in _leaves(tree):
        total += t.numel()
        if t.dim() >= 2 and not (path == ("embed",)
                                 and not cfg.tie_embeddings):
            gemm += t.numel()
    return total, gemm


def lm_train_bound(cfg, n_params: int, n_gemm: int, b: int, s: int) -> dict:
    """The least time of one training step of a decoder with remat: the
    weight GEMMs' 8·N·T operations in bf16 (forward, recompute, backward
    twice), the attention's q·kᵀ in fp32 and p·v in bf16, each
    2·b·h·s²·hd a layer a pass over four passes (zamba2: an application
    of its shared block; rwkv6: none), the recurrences in fp32 over the
    same four passes (rwkv6's WKV step 7·d·hd operations a token a layer:
    k·vᵀ, u∘kv, the sum, r·S and the decayed update; zamba2's scan
    6·d_in·n: dt·x·Bᵀ, the decay, the sum and S·c), at the data sheet's
    rates; against the bytes of parameters, AdamW moments and gradients,
    each read or written once."""
    t = b * s
    bf16 = 8 * n_gemm * t
    n_attn, scan = cfg.n_layers, 0
    if cfg.family == "ssm":
        n_attn, scan = 0, 7 * cfg.d_model * cfg.ssm_head_dim
    elif cfg.family == "hybrid":
        n_attn = cfg.n_layers // cfg.shared_attn_every
        scan = 6 * cfg.ssm_expand * cfg.d_model * cfg.ssm_state
    attn = 4 * 2 * b * cfg.n_heads * s * s * cfg.hd * n_attn
    scan = 4 * t * cfg.n_layers * scan
    ops_ms = ((bf16 + attn) / hw.PEAK_FLOPS_BF16
              + (attn + scan) / hw.PEAK_FLOPS_FP32) * 1e3
    elem = 2 if cfg.dtype == "bfloat16" else 4
    # parameters read and written, gradients written and read, m and v
    # read and written in fp32
    moved = n_params * (4 * elem + 16)
    bytes_ms = moved / hw.HBM_BW * 1e3
    return {"bf16_tflop": (bf16 + attn) / 1e12,
            "fp32_tflop": (attn + scan) / 1e12,
            "ops_ms": ops_ms, "bytes_ms": bytes_ms,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def lm_train_setup(torch, cfg, dev, b: int, s: int, state_dtype: str):
    """A model of ``cfg`` from seed ``SEED``, its AdamW state, the
    launcher's step and batch function."""
    from repro_torch.launch.train import lm_batch_fn
    from repro_torch.models.lm import make_lm_model
    from repro_torch.training import (AdamWConfig, adamw_init,
                                      make_train_step)

    model = make_lm_model(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(SEED))
    opt = AdamWConfig(lr=1e-3, state_dtype=state_dtype)
    state = adamw_init(model.param_tree(), opt)
    return model, state, make_train_step(model, opt), lm_batch_fn(
        cfg, b, s, dev)


def lm_train_smollm(torch, dev, card: str) -> list:
    """(a): smollm-360m at full width and depth, each of
    ``LM_TRAIN_SHAPES``: ``LM_TRAIN_WARM`` warm steps, ``LM_TRAIN_STEPS``
    timed steps (host clock to the loss on the host), a trace of
    ``LM_TRAIN_TRACE`` more split by range, peak memory, the first and
    last loss, the bound; then, at the first shape, the embedding's
    gradient twice on one batch, bitwise."""
    from repro_torch.configs import get_config

    cfg = get_config("smollm-360m")
    n_params, n_gemm = lm_param_counts(cfg)
    out = []
    for b, s in LM_TRAIN_SHAPES:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        model, state, step_fn, batch_fn = lm_train_setup(
            torch, cfg, dev, b, s, "float32")
        losses, times = [], []
        for i in range(LM_TRAIN_WARM + LM_TRAIN_STEPS):
            t0 = time.perf_counter()
            state, m = step_fn(state, batch_fn(i))
            losses.append(float(m["loss"]))
            times.append((time.perf_counter() - t0) * 1e3)
        timed = sorted(times[LM_TRAIN_WARM:])
        assert all(math.isfinite(x) for x in losses), losses
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30

        def run(start=len(losses)):
            nonlocal state
            for i in range(LM_TRAIN_TRACE):
                state, m = step_fn(state, batch_fn(start + i))
                float(m["loss"])
        tr = trace_ranges(torch, run, LM_TRAIN_TRACE, TRAIN_RANGES,
                          f"lm_train_smollm_b{b}_s{s}")
        bnd = lm_train_bound(cfg, n_params, n_gemm, b, s)
        by_kernel = tr.pop("by_kernel")
        res = {"b": b, "s": s, "params": n_params,
               "step_p50_ms": timed[len(timed) // 2],
               "step_p90_ms": timed[int(0.9 * (len(timed) - 1))],
               "first_loss": losses[0], "last_loss": losses[-1],
               "peak_gib": peak, **tr, **bnd}
        out.append(res)
        log(f"[lmtrain] (a) smollm-360m (L={cfg.n_layers}, {n_params / 1e9:.3f}"
            f" B parameters, bf16, fp32 AdamW state, remat) b={b} s={s}: "
            f"step p50 {res['step_p50_ms']:.2f} ms, p90 "
            f"{res['step_p90_ms']:.2f} ms over {LM_TRAIN_STEPS} after "
            f"{LM_TRAIN_WARM} warm; device busy {tr['busy_us']:.0f} us/step "
            f"{ {k: round(v) for k, v in sorted(tr['split_us'].items())} }, "
            f"idle share {tr['idle_share']:.3f}; host ms/step "
            f"{ {k: round(v, 2) for k, v in tr['host_ms'].items()} }; peak "
            f"{peak:.2f} GiB; loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
            f"bound {bnd['bound_ms']:.2f} ms by {bnd['bound_by']} (GEMMs "
            f"{bnd['bf16_tflop']:.2f} TFLOP bf16 + {bnd['fp32_tflop']:.2f} "
            f"fp32 = {bnd['ops_ms']:.2f} ms; bytes {bnd['bytes_ms']:.2f} ms)"
            f" | {card}")
        for kname, dur in sorted(by_kernel.items(),
                                 key=lambda kv: -kv[1])[:6]:
            log(f"[lmtrain]   {dur:10.1f} us/step  {kname[:90]}")
        if s == LM_TRAIN_SHAPES[0][1]:
            # the embedding's gradient (the gathered rows summed by id),
            # twice on one batch: bitwise
            batch = batch_fn(0)
            grads = []
            for _ in range(2):
                loss = model.loss(batch)
                loss.backward()
                grads.append(model.embed.grad.clone())
                for t in model.state_dict(keep_vars=True).values():
                    t.grad = None
            assert torch.equal(grads[0], grads[1]), \
                "the embedding's gradient is not repeatable"
            log(f"[lmtrain] (a) the embedding's gradient (rows gathered by "
                f"id, summed) twice on one batch of {b}x{s}: bitwise")
        del model, state, step_fn
    return out


def lm_train_arch(torch, dev, arch: str, layers, card: str) -> dict:
    """(b): one arch at published width, depth cut to ``layers``: 3 steps,
    every loss finite, no NaN in any parameter, and every leaf of at most
    2**24 elements that holds an element below 0.125 changed (a bf16 gain
    at 1.0 cannot move by lr 1e-3)."""
    import dataclasses

    from repro_torch.bridge import _leaves
    from repro_torch.configs import get_config

    full = get_config(arch)
    cfg = full if layers is None else dataclasses.replace(
        full, n_layers=layers,
        encoder_layers=layers if full.encoder_layers else 0)
    state_dtype = ("bfloat16" if lm_param_counts(full)[0] > BF16_STATE_PARAMS
                   else "float32")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model, state, step_fn, batch_fn = lm_train_setup(
        torch, cfg, dev, LM_TRAIN_B, LM_TRAIN_S, state_dtype)
    before = {p: t.detach().clone() for p, t in _leaves(state.params)
              if t.numel() <= 2**24}
    losses, times = [], []
    for i in range(LM_TRAIN_ARCH_STEPS):
        t1 = time.perf_counter()
        state, m = step_fn(state, batch_fn(i))
        losses.append(float(m["loss"]))
        times.append((time.perf_counter() - t1) * 1e3)
    assert all(math.isfinite(x) for x in losses), (arch, losses)
    changed = 0
    for path, t in _leaves(state.params):
        assert not torch.isnan(t).any(), (arch, path)
        if path in before:
            same = torch.equal(t, before[path])
            changed += not same
            # AdamW's first steps move an element by about lr = 1e-3: a
            # bf16 leaf whose every element sits at 0.5 or further from 0
            # (gains at 1.0, RWKV's mu at 0.5, w_base at -2.0) lies more
            # than half a spacing from its neighbours and may not move
            small = bool((before[path].abs() < 0.125).any())
            assert not (same and small), (arch, path)
    n = sum(t.numel() for _, t in _leaves(state.params))
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    res = {"arch": arch, "layers": cfg.n_layers, "published": full.n_layers,
           "params": n, "state_dtype": state_dtype, "losses": losses,
           "leaves_changed": [changed, len(before)],
           "step_ms": times, "peak_gib": peak,
           "seconds": time.perf_counter() - t0}
    log(f"[lmtrain] (b) {arch} ({cfg.family}, L={cfg.n_layers} of "
        f"{full.n_layers}, {n / 1e9:.2f} B parameters, {state_dtype} AdamW "
        f"state) b={LM_TRAIN_B} s={LM_TRAIN_S}: losses "
        f"{[round(x, 4) for x in losses]}, steps "
        f"{[round(x, 1) for x in times]} ms, peak {peak:.2f} GiB; every "
        f"parameter finite; {changed} of the {len(before)} leaves of at most "
        f"2**24 elements changed, every one holding an element below 0.125 "
        f"among them | {card}")
    del model, state, step_fn
    return res


def lm_train_vs_cpu(torch, dev) -> dict:
    """(c): each arch's ``reduced()`` fp32 model with the same weights and
    batch on the card and on the CPU (and smollm's with a tied head, which
    no published config has): the loss and every gradient leaf within
    ``CPU_TOL``; the card's gradients twice, bitwise. Returns the largest
    |card - CPU| an arch."""
    from repro_torch.bridge import _leaves
    from repro_torch.configs import ARCH_NAMES, get_config
    from repro_torch.launch.train import lm_batch_fn
    from repro_torch.models.lm import make_lm_model

    def grads(model, batch):
        tree = model.param_tree()
        loss = model.loss(batch)
        loss.backward()
        out = {p: t.grad.detach().clone() for p, t in _leaves(tree)}
        for _, t in _leaves(tree):
            t.grad = None
        return loss.detach(), out

    worst = {}
    for arch, tied in [(a, False) for a in ARCH_NAMES] + [
            ("smollm-360m", True)]:
        cfg = get_config(arch).reduced(tie_embeddings=tied)
        arch = arch + (" tied" if tied else "")
        host = make_lm_model(cfg, device="cpu").init(
            torch.Generator().manual_seed(SEED))
        card = make_lm_model(cfg, device=dev)
        card.load_state_dict(host.state_dict())
        batch = lm_batch_fn(cfg, 2, 16, "cpu")(SEED)
        moved = {k: v.to(dev) for k, v in batch.items()}
        lh, gh = grads(host, batch)
        lc, gc = grads(card, moved)
        lc2, gc2 = grads(card, moved)
        torch.testing.assert_close(lc.cpu(), lh, **CPU_TOL)
        w = float((lc.cpu() - lh).abs())
        for path, g in gh.items():
            torch.testing.assert_close(gc[path].cpu(), g, **CPU_TOL,
                                       msg=f"{arch} {path}")
            assert torch.equal(gc[path], gc2[path]), (arch, path)
            w = max(w, float((gc[path].cpu() - g).abs().max()))
        assert torch.equal(lc, lc2), arch
        worst[arch] = w
    return worst


def lm_train_resume(torch, dev) -> int:
    """(d): on smollm's ``reduced()`` config, 6 steps through
    ``run_train_loop`` against 3, a fresh model's restore and 3 more:
    parameters, moments and step bitwise. Returns the leaves compared."""
    import shutil
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.launch.train import lm_batch_fn
    from repro_torch.models.lm import make_lm_model
    from repro_torch.training import (AdamWConfig, TrainLoopConfig,
                                      adamw_init, make_train_step,
                                      run_train_loop)

    cfg = get_config("smollm-360m").reduced()
    opt = AdamWConfig(lr=1e-3)
    root = Path(tempfile.mkdtemp(dir=ROOT / "build"))

    def run(total, ckpt):
        model = make_lm_model(cfg, device=dev).init(
            torch.Generator(device=dev).manual_seed(SEED))
        loop = TrainLoopConfig(total_steps=total, ckpt_every=3,
                               ckpt_dir=str(root / ckpt), log_every=100)
        return run_train_loop(make_train_step(model, opt),
                              adamw_init(model.param_tree(), opt),
                              lm_batch_fn(cfg, 8, 64, dev), loop)

    try:
        whole, h1 = run(6, "a")
        run(3, "b")
        resumed, h2 = run(6, "b")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    assert [r["loss"] for r in h1[3:]] == [r["loss"] for r in h2]
    a, b = _leaf_map(whole), _leaf_map(resumed)
    assert a.keys() == b.keys()
    for key, t in a.items():
        assert torch.equal(t, b[key]), f"resumed {key} differs"
    return len(a)


def run_lm_train(torch, dev, card: str) -> dict:
    """Phase 13: LM training through ``launch/train.py``'s step (see the
    docstring). Numbers also go to ``chiprun_out/lm_phase13.json``."""
    t_phase = time.perf_counter()
    res = {"card": card, "smollm": lm_train_smollm(torch, dev, card)}
    for arch, reason in LM_TRAIN_SKIPPED.items():
        log(f"[lmtrain] (b) {arch}: not run on one card: {reason}")
    for arch, layers in LM_TRAIN_ARCHS:
        if layers is not None:
            log(f"[lmtrain] (b) depth cut: {arch} {layers} of "
                f"{lm_config(arch, None).n_layers} layers, for memory")
    res["archs"] = [lm_train_arch(torch, dev, arch, layers, card)
                    for arch, layers in LM_TRAIN_ARCHS]
    torch.cuda.empty_cache()
    res["vs_cpu"] = lm_train_vs_cpu(torch, dev)
    log(f"[lmtrain] (c) reduced fp32, loss and every gradient card vs CPU "
        f"within {CPU_TOL}, the card's gradients repeatable bitwise: "
        f"max|diff| "
        f"{ {a: float(f'{w:.2e}') for a, w in res['vs_cpu'].items()} }")
    n = lm_train_resume(torch, dev)
    log(f"[lmtrain] (d) smollm reduced: 6 steps == 3 + restore + 3, "
        f"bitwise in all {n} leaves")
    res["seconds"] = time.perf_counter() - t_phase
    path = ROOT / "chiprun_out" / "lm_phase13.json"
    path.parent.mkdir(exist_ok=True)
    path.write_text(json.dumps(res, indent=1))
    log(f"[lmtrain] phase 13 took {res['seconds']:.1f} s")
    return res


# ---------------------------------------------------------------------------
# phase 14: the LM mesh and the cell builder
# ---------------------------------------------------------------------------

# a (2, 2) ("data", "model") mesh of four positions on the first card
LM_MESH_SHAPE = (2, 2)
LM_MESH_B = 4                 # decode_32k's batch of 128 cut to 4
LM_MESH_FILL = 16_380         # (a): slots filled; 8 steps cross 16,384
LM_MESH_STEPS = 8
# (a) in fp32: the same cache at b = 2 (weights 32.1 GB, the cache and
# its mesh-less copy 17.2 GB each)
LM_MESH_FP32_B = 2
# (b): the other families at published width in fp32, depths as phase
# 12 cuts them, a 4,096-slot cache (2,048 a sequence shard) filled to
# 2,044
LM_MESH_ARCHS = (("qwen3-4b", None), ("pixtral-12b", None),
                 ("phi3.5-moe-42b-a6.6b", 8), ("zamba2-1.2b", None),
                 ("whisper-small", None), ("rwkv6-7b", None))
LM_MESH_SEQ, LM_MESH_SEQ_FILL = 4096, 2044
MESH_DECODE_TOL = dict(rtol=2e-4, atol=2e-4)  # tests/distributed_inner.py:75
# (a) in bf16: the sharded attention's error against fp32 at most this
# many times the mesh-less attention's (both round q·k, p and p·v to
# bf16, in other orders)
LM_MESH_ATTN_RATIO = 2.0
# (c): reduced fp32 archs, a prompt of 6 into 16 slots (8 a shard)
LM_MESH_SMALL = dict(prompt=6, s_max=16, frames=8, patches=2, steps=6)
# (d): smollm-360m whole, train_4k cut to b = 8, s = 256
LM_MESH_TRAIN = ("smollm-360m", 8, 256, 3)


class lm_cell_config:
    """``repro_torch.configs``' config of ``arch`` replaced while inside
    (depth cut to ``layers``, or ``reduced()``), as the reference's
    tests/distributed_inner.py:102-104 patches it for a cell."""

    def __init__(self, arch: str, layers=None, reduced: bool = False,
                 dtype: str | None = None):
        import dataclasses
        import importlib

        import repro_torch.configs as C
        self.mod = importlib.import_module(
            f"repro_torch.configs.{C._ARCH_MODULES[arch]}")
        self.saved = self.mod.CONFIG
        cfg = self.saved.reduced() if reduced else self.saved
        if layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        self.cfg = cfg if dtype is None else dataclasses.replace(
            cfg, dtype=dtype)

    def __enter__(self):
        self.mod.CONFIG = self.cfg
        return self.cfg

    def __exit__(self, *exc):
        self.mod.CONFIG = self.saved


def released(torch, base: int, tag: str) -> None:
    """Fail unless the card's allocated memory is back within 256 MiB of
    ``base``: a cell that outlived its section would hold its weights."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() - base
    assert held < 2**28, f"{tag}: {held / 2**30:.2f} GiB still held"


def lm_mesh(torch, dev, shape=LM_MESH_SHAPE):
    from repro_torch.distributed import make_mesh
    return make_mesh(shape, ("data", "model"),
                     [dev] * math.prod(shape))


def fill_cache(torch, cache: dict, upto: int, g) -> dict:
    """Seeded values in a fresh cache: a KV cache's slots [0, upto) ~
    N(0, 1) (the rest stays zero), a cross memory whole, a recurrent
    state × 0.1; ``index`` = ``upto``."""
    for key, val in cache.items():
        if isinstance(val, dict):
            fill_cache(torch, val, upto, g)
        elif key == "index":
            cache[key] = upto
        elif key in ("k", "v"):
            for layer in val:
                layer[:, :upto].copy_(torch.randn(
                    layer[:, :upto].shape, generator=g, device=val.device))
        elif key in ("xk", "xv"):
            for layer in val:
                layer.copy_(torch.randn(layer.shape, generator=g,
                                        device=val.device))
        else:
            val.copy_(torch.randn(val.shape, generator=g,
                                  device=val.device) * 0.1)
    return cache


def whole_copy(torch, cache):
    """A mesh-less copy of a (placed) cache: every ``Placed`` assembled
    on the first device, every tensor cloned."""
    from repro_torch.distributed import Placed
    if isinstance(cache, dict):
        return {k: whole_copy(torch, v) for k, v in cache.items()}
    if isinstance(cache, Placed):
        return cache.full()
    return cache.clone() if torch.is_tensor(cache) else cache


def mesh_step_pair(torch, cell, nxt, cache, plain):
    """One decode step of ``cell`` (through its ``decode_ctx``, if any) on
    ``cache`` and of its mesh-less twin on ``plain`` (the same model, no
    ``decode_ctx``, the hook replaced by none): (sharded logits, mesh-less
    logits, sharded ms, mesh-less ms), each call timed to a sync."""
    from repro_torch.models.lm import layers as L

    model = cell.model
    ctx, shard = cell.decode_ctx, model.shard
    times = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if ctx is not None:
        model.decode_ctx = None
    model.shard = L.no_shard
    try:
        lp, plain = model.decode_step(nxt, plain)
    finally:
        model.shard = shard
        if ctx is not None:
            model.decode_ctx = ctx
    torch.cuda.synchronize()
    times.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    ls, cache = cell.decode_fn()({"tokens": nxt, "cache": cache})
    torch.cuda.synchronize()
    times.append((time.perf_counter() - t0) * 1e3)
    return ls, lp, times[1], times[0]


def check_tokens(torch, ls, lp, tag: str) -> int:
    """Greedy tokens of the sharded (``ls``) and mesh-less (``lp``)
    logits: where one differs, log the mesh-less top-2 margin; a margin
    above twice that row's largest |diff| is not a near tie and fails.
    Returns the number of tokens that differ."""
    diff = (ls.float() - lp.float()).abs().amax(-1)
    top = lp.float().topk(2, dim=-1).values
    margin = top[:, 0] - top[:, 1]
    differ = (ls.argmax(-1) != lp.argmax(-1)).nonzero().flatten().tolist()
    for r in differ:
        log(f"[lmmesh] {tag}: row {r} greedy token differs, top-2 margin "
            f"{float(margin[r]):.3e}, max|diff| {float(diff[r]):.3e}")
        assert float(margin[r]) <= 2 * float(diff[r]), (tag, r)
    return len(differ)


def attention_vs_fp32(torch, cell, nxt, plain) -> tuple[float, float]:
    """Layer 0's attention for the next token, on a copy of layer 0's
    cache with that token written, through ``flash_decode_sharded`` and
    through the mesh-less ``_sdpa_decode``, each against ``_sdpa_decode``
    in fp32 on the same q and cache: (sharded, mesh-less) relative norm
    errors."""
    from repro_torch.models.lm import layers as L

    model, idx = cell.model, plain["index"]
    layer = model.layers[0]
    b = nxt.shape[0]
    h = L.rms_norm(model.embed_tokens(nxt), layer.ln1)
    pos = torch.full((b, 1), idx, dtype=torch.int32, device=nxt.device)
    q, k, v = L._qkv(layer.attn, model.dims, h, pos)
    kc, vc = plain["k"][0].clone(), plain["v"][0].clone()
    kc[:, idx], vc[:, idx] = k[:, 0], v[:, 0]
    valid = torch.arange(kc.shape[1], device=nxt.device) <= idx
    truth = L._sdpa_decode(q.float(), kc.float(), vc.float(), valid)
    mless = L._sdpa_decode(q, kc, vc, valid)
    shd, _, _ = L.flash_decode_sharded(q, kc, vc, None, None, idx,
                                       cell.decode_ctx)
    err = lambda t: float((t.float() - truth).norm() / truth.norm())  # noqa
    return err(shd), err(mless)


def lm_mesh_llama(torch, dev, mesh, card: str, dtype: str, b: int,
                  then=None) -> dict:
    """(a): llama3-8b, all 32 layers, through ``build_cell("llama3-8b",
    "decode_32k", mesh)``: a 32,768-slot cache (16,384 a sequence shard)
    filled to ``LM_MESH_FILL``, ``LM_MESH_STEPS`` decode steps across the
    shards' boundary on the cell and on the mesh-less ``decode_step``
    over a copy of the same cache. In bf16 (the published dtype, timed):
    layer 0's sharded attention within ``LM_MESH_ATTN_RATIO`` × the
    mesh-less attention's error against fp32, the greedy tokens equal up
    to near ties, the logit gap logged (two bf16 paths that round in
    other orders drift apart over 32 random layers: PERF.md §6).
    In fp32: logits within ``MESH_DECODE_TOL``. ``then(cell, cache,
    plain, nxt, res)``, if given, runs last, before the cell is freed
    (phase 16's (a) and (b))."""
    from repro_torch.launch.steps import build_cell

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with lm_cell_config("llama3-8b", dtype=dtype):
        cell = build_cell("llama3-8b", "decode_32k", mesh)
    assert cell.model.device == mesh.first_device
    assert cell.decode_ctx.batch_axes == "data"
    g = torch.Generator(device=dev).manual_seed(SEED)
    cell.model.init(g)
    weights = tensor_bytes(cell.model.state_dict())
    s_max = cell.cell.seq
    cache = fill_cache(torch, cell.model.init_cache(b, s_max),
                       LM_MESH_FILL, g)
    cache_bytes = tensor_bytes(cache)
    cell.place_cache(cache)           # the whole tensors go
    torch.cuda.synchronize()
    plain = whole_copy(torch, cache)
    assert cache["k"].local((1, 1)).is_contiguous()
    nxt = torch.randint(0, cell.cfg.vocab, (b, 1), generator=g, device=dev)
    res = {"dtype": dtype, "layers": cell.cfg.n_layers, "b": b,
           "s_max": s_max, "fill": LM_MESH_FILL}
    if dtype == "bfloat16":
        res["attn_err"], res["attn_err_mesh_less"] = attention_vs_fp32(
            torch, cell, nxt, plain)
        assert res["attn_err"] <= LM_MESH_ATTN_RATIO * max(
            res["attn_err_mesh_less"], 1e-6), res
    ms, plain_ms, worst, mean, differ = [], [], 0.0, 0.0, 0
    for step in range(LM_MESH_STEPS):
        ls, lp, t_s, t_p = mesh_step_pair(torch, cell, nxt, cache, plain)
        assert torch.isfinite(ls.float()).all()
        if dtype == "float32":
            torch.testing.assert_close(ls, lp, **MESH_DECODE_TOL)
        gap = (ls.float() - lp.float()).abs()
        worst = max(worst, float(gap.max()))
        mean = max(mean, float(gap.mean()))
        differ += check_tokens(torch, ls, lp, f"(a) {dtype} step {step}")
        ms.append(t_s)
        plain_ms.append(t_p)
        nxt = lp.argmax(-1)[:, None]
    assert cache["index"] == plain["index"] == LM_MESH_FILL + LM_MESH_STEPS
    for key in ("k", "v"):
        # the written slots, in both shards, against the mesh-less ones
        got = cache[key].full()[:, :, LM_MESH_FILL - 4:LM_MESH_FILL + 8]
        want = plain[key][:, :, LM_MESH_FILL - 4:LM_MESH_FILL + 8]
        if dtype == "float32":
            torch.testing.assert_close(got, want, **MESH_DECODE_TOL)
        assert torch.equal(got[:, :, :4], want[:, :, :4])
        assert not got[:, :, 4:].eq(0).all(dim=(0, 1, 3, 4)).any()
        del got, want
    peak = torch.cuda.max_memory_allocated() - base
    # one more step of each, counted: ATen ops and the bytes of copies of
    # a cache shard or more
    model = cell.model
    ctx = model.decode_ctx
    shard_numel = cache["k"][0].local((0, 0)).numel()
    model.decode_ctx = None
    gemms, plain_ops, plain_copy = dispatch_counts(
        torch, lambda: model.decode_step(nxt, plain), shard_numel)
    model.decode_ctx = ctx
    _, mesh_ops, mesh_copy = dispatch_counts(torch, lambda: cell.decode_fn()(
        {"tokens": nxt, "cache": cache}), shard_numel)
    # no copy of a cache shard beyond the mesh-less path's own
    assert mesh_copy <= plain_copy, (mesh_copy, plain_copy)
    bound = max((weights + cache_bytes) / hw.HBM_BW * 1e3,
                flops_ms(torch, gemms))
    res.update({"weights_gb": weights / 1e9, "cache_gb": cache_bytes / 1e9,
                "max_abs_diff": worst, "max_mean_abs_diff": mean,
                "tokens_differ": differ,
                "decode_p50_ms": sorted(ms)[len(ms) // 2],
                "plain_decode_p50_ms": sorted(plain_ms)[len(plain_ms) // 2],
                "bound_ms": bound, "ops": mesh_ops, "plain_ops": plain_ops,
                "copy_gb": mesh_copy / 1e9,
                "plain_copy_gb": plain_copy / 1e9, "peak_gib": peak / 2**30})
    check = (f"layer-0 attention vs fp32: sharded {res['attn_err']:.3e}, "
             f"mesh-less {res['attn_err_mesh_less']:.3e} (relative norm) | "
             if dtype == "bfloat16" else f"within {MESH_DECODE_TOL} | ")
    log(f"[lmmesh] (a) llama3-8b decode_32k ({dtype}, L={res['layers']}, "
        f"b={b} of 128, S_max={s_max}, {s_max // mesh.shape['model']} a "
        f"sequence shard, filled to {LM_MESH_FILL}, {LM_MESH_STEPS} steps "
        f"across the boundary) on a {mesh.shape} mesh of one card: "
        + check + f"logits max|sharded-mesh-less| {worst:.3e} (mean at most "
        f"{mean:.3e}), {differ} greedy tokens differ | decode p50 "
        f"{res['decode_p50_ms']:.2f} ms/token sharded, "
        f"{res['plain_decode_p50_ms']:.2f} mesh-less (bound {bound:.2f}: "
        f"{res['weights_gb']:.2f} GB weights + {res['cache_gb']:.2f} GB "
        f"cache at {hw.HBM_BW / 1e12:.2f} TB/s, or the GEMMs' operations "
        "if more) | "
        f"{mesh_ops} ATen ops a step sharded, "
        f"{plain_ops} mesh-less | copies {res['copy_gb']:.2f} GB a step "
        f"sharded, {res['plain_copy_gb']:.2f} mesh-less | peak "
        f"{res['peak_gib']:.2f} GiB | {card}")
    if then is not None:
        then(cell, cache, plain, nxt, res)
    del cell, cache, plain, model
    released(torch, base, f"(a) {dtype}")
    return res


class routing_record:
    """While inside, every ``moe_ffn`` call appends its top-k expert
    choices (recomputed from the same fp32 router logits) to ``calls``."""

    def __init__(self, torch):
        from repro_torch.models.lm import moe
        self.torch, self.moe, self.real, self.calls = torch, moe, \
            moe.moe_ffn, []

    def __enter__(self):
        torch, real = self.torch, self.real

        def recorded(p, x, cfg, *args):
            # a split step's rows, joined in batch order as it routes them
            xs = torch.cat(x.parts) if hasattr(x, "parts") else x
            probs = torch.softmax(xs.float() @ p.router, dim=-1)
            self.calls.append(torch.topk(probs, cfg.top_k, dim=-1)[1])
            return real(p, x, cfg, *args)
        self.moe.moe_ffn = recorded
        return self

    def __exit__(self, *exc):
        self.moe.moe_ffn = self.real

    def take(self) -> list:
        out, self.calls = self.calls, []
        return out


def lm_mesh_arch(torch, dev, mesh, arch: str, layers, card: str) -> dict:
    """(b): one arch at published width (depth ``layers``) in fp32, its
    decode cell on ``mesh``, a ``LM_MESH_SEQ``-slot cache filled to
    ``LM_MESH_SEQ_FILL`` (whisper's 1,500-frame memory whole, 750 a
    shard), ``LM_MESH_STEPS`` steps against the mesh-less decode within
    ``MESH_DECODE_TOL``; RWKV6 (no ``decode_ctx``, the hook only)
    bitwise. MoE routing is a discontinuous function of the hidden state,
    so for MoE each step starts both paths from the same (sharded) cache
    and is held to the tolerance only where every layer routed every
    token to the same experts on both; a step whose routing differs is
    logged."""
    from repro_torch.launch.steps import build_cell

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    with lm_cell_config(arch, layers, dtype="float32"):
        cell = build_cell(arch, "decode_32k", mesh)
    g = torch.Generator(device=dev).manual_seed(SEED)
    cell.model.init(g)
    model, fam = cell.model, cell.cfg.family
    args = (LM_MESH_B, LM_MESH_SEQ) + ((LM_FRAMES,) if fam == "encdec"
                                       else ())
    if fam == "ssm":
        args = (LM_MESH_B, 0)
    cache = fill_cache(torch, model.init_cache(*args), LM_MESH_SEQ_FILL, g)
    cell.place_cache(cache)
    plain = whole_copy(torch, cache)
    nxt = torch.randint(0, cell.cfg.vocab, (LM_MESH_B, 1), generator=g,
                        device=dev)
    ms, plain_ms, worst, differ, flips = [], [], 0.0, 0, 0
    routes = routing_record(torch)
    for step in range(LM_MESH_STEPS):
        if fam == "moe":
            plain = whole_copy(torch, cache)
            with routes:
                ls, lp, t_s, t_p = mesh_step_pair(torch, cell, nxt, cache,
                                                  plain)
        else:
            ls, lp, t_s, t_p = mesh_step_pair(torch, cell, nxt, cache,
                                              plain)
        ms.append(t_s)
        plain_ms.append(t_p)
        calls = routes.take()
        half = len(calls) // 2          # the mesh-less step's, then ours
        same = all(torch.equal(a, b) for a, b in zip(calls[:half],
                                                     calls[half:]))
        assert torch.isfinite(ls.float()).all(), arch
        if not same:
            flips += 1
            log(f"[lmmesh] (b) {arch} step {step}: the routing differs "
                f"(max|diff| {float((ls.float() - lp.float()).abs().max()):.3e}"
                f"), not held to the tolerance")
            nxt = lp.argmax(-1)[:, None]
            continue
        if cell.decode_ctx is None:
            assert torch.equal(ls, lp), arch
        else:
            torch.testing.assert_close(ls, lp, **MESH_DECODE_TOL)
        worst = max(worst, float((ls.float() - lp.float()).abs().max()))
        differ += check_tokens(torch, ls, lp, f"(b) {arch} step {step}")
        nxt = lp.argmax(-1)[:, None]
    res = {"arch": arch, "family": fam, "layers": cell.cfg.n_layers,
           "sharded": cell.decode_ctx is not None, "max_abs_diff": worst,
           "tokens_differ": differ, "routing_flips": flips,
           "decode_p50_ms": sorted(ms)[len(ms) // 2],
           "plain_decode_p50_ms": sorted(plain_ms)[len(plain_ms) // 2]}
    assert flips < LM_MESH_STEPS, f"{arch}: no step held to the tolerance"
    log(f"[lmmesh] (b) {arch} ({fam}, L={res['layers']}, fp32, b="
        f"{LM_MESH_B}, cache {LM_MESH_SEQ} filled to {LM_MESH_SEQ_FILL}"
        + (f", memory {LM_FRAMES}" if fam == "encdec" else "") + "): "
        + ("flash_decode_sharded" if res["sharded"] else
           "no decode_ctx, the hook only, bitwise")
        + f": max|sharded-mesh-less| {worst:.3e}, {differ} greedy tokens "
        f"differ" + (f", {flips} of {LM_MESH_STEPS} steps routed "
                     "differently" if fam == "moe" else "")
        + f" | decode p50 {res['decode_p50_ms']:.2f} ms sharded, "
        f"{res['plain_decode_p50_ms']:.2f} mesh-less | {card}")
    del cell, model, cache, plain
    released(torch, base, f"(b) {arch}")
    return res


def lm_mesh_small(torch, dev, mesh, arch: str) -> tuple[float, float]:
    """(c): the arch's ``reduced()`` fp32 decode cell on the card's mesh
    and on a CPU mesh of the same shape with the same weights: a prompt
    into 16 slots, 6 decode steps across the shard boundary. Returns
    (max |card - CPU| sharded, max |sharded - mesh-less| on the card)."""
    from repro_torch.distributed import make_mesh
    from repro_torch.launch.steps import build_cell

    c = LM_MESH_SMALL
    cpu = torch.device("cpu")
    with lm_cell_config(arch, reduced=True):
        host = build_cell(arch, "decode_32k",
                          make_mesh(mesh.devices.shape, mesh.axis_names,
                                    "cpu"))
        card = build_cell(arch, "decode_32k", mesh)
    host.model.init(torch.Generator().manual_seed(SEED))
    card.model.load_state_dict(host.model.state_dict())
    cfg, fam = host.cfg, host.cfg.family
    g = torch.Generator().manual_seed(SEED + 6)
    n_tok = c["prompt"] - (c["patches"] if fam == "vlm" else 0)
    tokens = torch.randint(0, cfg.vocab, (LM_MESH_B, n_tok), generator=g)

    def prefill(cell, to):
        model = cell.model
        t = tokens.to(to)
        if fam == "encdec":
            frames = (torch.randn((LM_MESH_B, c["frames"], cfg.d_model),
                                  generator=torch.Generator().manual_seed(
                                      SEED + 7)) * 0.1).to(to)
            return model.prefill(t, frames, model.init_cache(
                LM_MESH_B, c["s_max"], c["frames"]))
        if fam == "ssm":
            return model.prefill(t, model.init_cache(LM_MESH_B, 0))
        cache = model.init_cache(LM_MESH_B, c["s_max"])
        if fam == "vlm":
            pe = (torch.randn((LM_MESH_B, c["patches"], cfg.d_model),
                              generator=torch.Generator().manual_seed(
                                  SEED + 7)) * 0.02).to(to)
            return model.prefill(t, cache, patch_embeds=pe)
        return model.prefill(t, cache)

    lh, ch = prefill(host, cpu)
    lc, cc = prefill(card, dev)
    plain = whole_copy(torch, cc)
    vs_cpu = vs_plain = 0.0
    for _ in range(c["steps"]):
        nxt = lh.argmax(-1)[:, None]
        lh, ch = host.decode_fn()({"tokens": nxt, "cache": ch})
        lc, lp, _, _ = mesh_step_pair(torch, card, nxt.to(dev), cc,
                                      plain)
        torch.testing.assert_close(lc.cpu(), lh, **CPU_TOL)
        torch.testing.assert_close(lc, lp, **MESH_DECODE_TOL)
        vs_cpu = max(vs_cpu, float((lc.cpu() - lh).abs().max()))
        vs_plain = max(vs_plain, float((lc - lp).abs().max()))
    return vs_cpu, vs_plain


def lm_mesh_train(torch, dev, mesh, card: str) -> dict:
    """(d): smollm-360m's train cell (all 32 layers, bf16, fp32 AdamW
    state, remat as published), ``train_4k`` cut to b = 8, s = 256: 3
    steps with ``n_micro`` 1 and 3 with 2 from the same parameters and
    batches; the losses within 1e-2 (the microbatches' GEMMs run at
    another M, so not bitwise)."""
    from repro_torch.launch.steps import build_cell
    from repro_torch.training import adamw_init

    arch, b, s, n_steps = LM_MESH_TRAIN
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    cell = build_cell(arch, "train_4k", mesh)
    g = torch.Generator(device=dev).manual_seed(SEED)
    cell.model.init(g)
    start = {k: v.clone() for k, v in cell.model.state_dict().items()}
    batches = [{"tokens": torch.randint(0, cell.cfg.vocab, (b, s),
                                        generator=g, device=dev)}
               for _ in range(n_steps)]
    res = {"arch": arch, "policy": cell.policy,
           "cell_n_micro": cell.n_micro, "b": b, "s": s, "runs": {}}
    for n_micro in (1, 2):
        cell.model.load_state_dict(start)
        cell.n_micro = n_micro
        state = adamw_init(cell.model.param_tree(), cell.opt_cfg)
        step = cell.train_step_fn()
        losses, times = [], []
        for batch in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
            times.append((time.perf_counter() - t0) * 1e3)
        assert all(math.isfinite(x) for x in losses), losses
        res["runs"][n_micro] = {"losses": losses,
                                "step_p50_ms": sorted(times)[1]}
        del state, step
    l1, l2 = res["runs"][1]["losses"], res["runs"][2]["losses"]
    assert all(abs(a - b) <= 1e-2 for a, b in zip(l1, l2)), (l1, l2)
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    log(f"[lmmesh] (d) {arch} train cell ({res['policy']}; its own n_micro "
        f"for train_4k {res['cell_n_micro']}), b={b}, s={s}, "
        f"{n_steps} steps: losses n_micro=1 "
        f"{[round(x, 5) for x in l1]}, n_micro=2 "
        f"{[round(x, 5) for x in l2]} (within 1e-2) | step p50 "
        f"{res['runs'][1]['step_p50_ms']:.1f} ms at n_micro=1, "
        f"{res['runs'][2]['step_p50_ms']:.1f} at 2 | peak "
        f"{res['peak_gib']:.2f} GiB | {card}")
    del cell, start, batches
    released(torch, base, "(d)")
    return res


def run_lm_mesh(torch, dev, card: str, split: dict | None = None) -> dict:
    """Phase 14: the LM mesh and the cell builder (see the docstring).
    Numbers also go to ``chiprun_out/lm_phase14.json``. With ``split`` (a
    dict), phase 16's (a) and (b) run on (a)'s llama3-8b cells and caches
    before they are freed, their records under the dtype's name."""
    from repro_torch.configs import ARCH_NAMES

    def then(dtype):
        if split is None:
            return None
        return lambda *args: split.__setitem__(
            dtype, lm_split_decode(torch, *args, card))

    t_phase = time.perf_counter()
    mesh = lm_mesh(torch, dev)
    log(f"[lmmesh] mesh {mesh.shape} of {mesh.size} positions on "
        f"{mesh.first_device}; cuts: decode_32k's batch 128 -> "
        f"{LM_MESH_B}; (b) cache {LM_MESH_SEQ} slots; depth: "
        + ", ".join(f"{a} {n}/{lm_config(a, None).n_layers}"
                    for a, n in LM_MESH_ARCHS if n is not None)
        + f"; (d) train_4k b=256, s=4096 -> b={LM_MESH_TRAIN[1]}, "
        f"s={LM_MESH_TRAIN[2]}; (e), qwen3-4b's three unplaced lower() "
        f"traces on the (16, 16) meta mesh (~210 s), removed: phase 15 "
        f"drives lower() through the dry run")
    res = {"card": card,
           "llama": lm_mesh_llama(torch, dev, mesh, card, "bfloat16",
                                  LM_MESH_B, then("bfloat16")),
           "llama_fp32": lm_mesh_llama(torch, dev, mesh, card, "float32",
                                       LM_MESH_FP32_B, then("float32"))}
    res["archs"] = [lm_mesh_arch(torch, dev, mesh, arch, layers, card)
                    for arch, layers in LM_MESH_ARCHS]
    res["small"] = {a: lm_mesh_small(torch, dev, mesh, a)
                    for a in ARCH_NAMES}
    log(f"[lmmesh] (c) reduced fp32 decode cells: max|card-CPU| sharded "
        f"within {CPU_TOL}, max|sharded-mesh-less| on the card within "
        f"{MESH_DECODE_TOL}: "
        f"{ {a: (float(f'{x:.2e}'), float(f'{y:.2e}')) for a, (x, y) in res['small'].items()} }")
    res["train"] = lm_mesh_train(torch, dev, mesh, card)
    res["seconds"] = time.perf_counter() - t_phase
    path = ROOT / "chiprun_out" / "lm_phase14.json"
    path.parent.mkdir(exist_ok=True)
    path.write_text(json.dumps(res, indent=1))
    log(f"[lmmesh] phase 14 took {res['seconds']:.1f} s")
    return res



# ---------------------------------------------------------------------------
# phase 15: the analysis and the dry run
# ---------------------------------------------------------------------------

# (arch, shape, mesh): whisper-small's three cells, zamba2's 524k decode on
# both meshes, phi3.5-moe's decode over the multipod's 32 batch shards
DRYRUN_CELLS = (("whisper-small", "train_4k", "pod"),
                ("whisper-small", "prefill_32k", "pod"),
                ("whisper-small", "decode_32k", "pod"),
                ("zamba2-1.2b", "long_500k", "pod"),
                ("zamba2-1.2b", "long_500k", "multipod"),
                ("phi3.5-moe-42b-a6.6b", "decode_32k", "multipod"))


def dryrun_cell(arch: str, shape: str, mesh_name: str) -> dict:
    """One cell of phase 15, in a worker process: ``dryrun.run_cell``,
    its record also written under ``chiprun_out/dryrun/``."""
    from repro_torch.launch.dryrun import run_cell

    return run_cell(arch, shape, mesh_name,
                    str(ROOT / "chiprun_out" / "dryrun"))


def run_dryrun(torch, card: str) -> list:
    """Phase 15: ``DRYRUN_CELLS`` through the dry run, one worker process
    each, side by side (meta traces: host work, no card); every record
    must be ``ok``. Numbers also go to ``chiprun_out/dryrun_phase15.json``."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    props = torch.cuda.get_device_properties(0)
    log(f"[dryrun] {card} | total_memory {props.total_memory} B "
        f"({props.total_memory / 1e9:.2f} GB) beside hw.HBM_BYTES "
        f"{hw.HBM_BYTES:.0f} B; rates: bf16 {hw.PEAK_FLOPS_BF16:.4g}, "
        f"int8 {hw.PEAK_OPS_INT8:.4g}, fp32 {hw.PEAK_FLOPS_FP32:.4g}, "
        f"HBM {hw.HBM_BW:.4g} B/s, NVLink {hw.NVLINK_BW:.4g} B/s")
    t0 = time.perf_counter()
    with ProcessPoolExecutor(len(DRYRUN_CELLS), mp_context=multiprocessing
                             .get_context("spawn")) as pool:
        recs = list(pool.map(dryrun_cell, *zip(*DRYRUN_CELLS)))
    wall = time.perf_counter() - t0
    for rec in recs:
        assert rec["status"] == "ok", rec
        rl = rec["roofline"]
        kinds = rl["collective_breakdown"]
        log(f"[dryrun] {rec['arch']} {rec['shape']} {rec['mesh']} "
            f"({rec['chips']} positions, n_micro {rec['n_micro']}, "
            f"{rec['trace']} step, {rec['rows_traced']} of {rec['rows']} "
            f"batch rows traced): compute_s {rl['compute_s']:.6g} "
            f"memory_s {rl['memory_s']:.6g} collective_s "
            f"{rl['collective_s']:.6g} (busiest position's bytes by kind "
            f"{kinds}) dominant {rl['dominant']} useful_ratio "
            f"{rl['useful_ratio']:.4f} fits_hbm {rl['fits_hbm']} "
            f"(arg {rec['memory']['arg_GiB']} GiB, temp "
            f"{rec['memory']['temp_GiB']}, out {rec['memory']['out_GiB']}) "
            f"n_ops {rec['n_ops']} lower_s {rec['lower_s']}")
        assert rec["trace"] == "split", rec["trace"]
        if rec["kind"] == "decode":
            assert set(kinds) - {"merge"}, kinds
        else:
            assert kinds.get("fsdp_gather") or kinds.get("tp_reduce"), kinds
    log(f"[dryrun] phase 15: {len(recs)} cells side by side in "
        f"{wall:.1f} s")
    path = ROOT / "chiprun_out" / "dryrun_phase15.json"
    path.parent.mkdir(exist_ok=True)
    path.write_text(json.dumps({"card": card, "total_memory":
                                props.total_memory, "seconds": wall,
                                "records": recs}, indent=1, default=str))
    return recs


# ---------------------------------------------------------------------------
# phase 16: split weights (Cell.place_params) on the LM mesh
# ---------------------------------------------------------------------------

LM_SPLIT_PROMPT = 512         # (c): llama3-8b prefill_32k cut to b = 4, s = 512
LM_SPLIT_RUNS = 3             # (c): prefills a path, the p50 kept
LM_SPLIT_MOE = ("phi3.5-moe-42b-a6.6b", 8)   # (d): depth 8 of 32
LM_SPLIT_MOE_STEPS = 8
LM_SPLIT_ARCHS = ("llama3-8b", "granite-8b", "smollm-360m", "qwen3-4b",
                  "pixtral-12b", "phi3.5-moe-42b-a6.6b",
                  "llama4-maverick-400b-a17b", "whisper-small", "rwkv6-7b",
                  "zamba2-1.2b")
LM_SPLIT_RECURRENT = ("rwkv6-7b", "zamba2-1.2b")   # (f): published width
LM_SPLIT_REC_PROMPT = 16      # (f): the prefill before the decode steps
LM_SPLIT_REC_STEPS = 8
# (g)-(j): train cells split (item, arch, depth or None for all, b, s):
# smollm-360m's train_4k under pure FSDP as phase 14 (d) cuts it,
# llama3-8b's under TP x FSDP at depth 4 of 32, b = 4 of 256, s = 512 of
# 4,096, and the recurrent families' under TP x FSDP at b = 4, s = 64
# (their scans are Python loops over time at each head site): rwkv6-7b at
# depth 2 of 32, zamba2-1.2b at 7 of 38 (a full chunk of 6 with its
# shared block, then a tail layer)
LM_SPLIT_TRAIN = (("g", "smollm-360m", None, 8, 256),
                  ("h", "llama3-8b", 4, 4, 512),
                  ("i", "rwkv6-7b", 2, 4, 64),
                  ("j", "zamba2-1.2b", 7, 4, 64))
LM_SPLIT_TRAIN_STEPS = 3
# their fp32 checks: the LM-training tolerance, with AdamW's eps at 1e-3
# as tests/test_torch_lm_tp_train.py sets it, so that a gradient near 0
# does not turn its rounding into a whole step of the update
TRAIN_SPLIT_TOL = dict(rtol=1e-4, atol=1e-5)
TRAIN_SPLIT_EPS = 1e-3


class lm_cell_shape:
    """``repro_torch.configs.SHAPES[name]`` cut to (seq, batch) while
    inside (a cell reads it when it is built)."""

    def __init__(self, name: str, seq: int, batch: int):
        import repro_torch.configs as C
        self.C, self.name = C, name
        self.saved = C.SHAPES[name]
        self.cut = C.ShapeCell(name, seq, batch, self.saved.kind)

    def __enter__(self):
        self.C.SHAPES[self.name] = self.cut

    def __exit__(self, *exc):
        self.C.SHAPES[self.name] = self.saved


class cell_path:
    """While inside, ``cell``'s model runs as ``path``: ``"split"`` (on
    ``tp``, its placed parameters), ``"unsplit"`` (whole weights and the
    placed cache: phase 14's cell) or ``"mesh_less"`` (no ``decode_ctx``,
    no hook, no split)."""

    def __init__(self, cell, tp, path: str):
        self.model, self.tp, self.path = cell.model, tp, path

    def __enter__(self):
        from repro_torch.models.lm import layers as L
        m = self.model
        # RWKV6 has no attention and no decode_ctx
        self.saved = m.tp, getattr(m, "decode_ctx", None), m.shard
        m.tp = self.tp if self.path == "split" else None
        if self.path == "mesh_less":
            m.shard = L.no_shard
            if hasattr(m, "decode_ctx"):
                m.decode_ctx = None

    def __exit__(self, *exc):
        m = self.model
        m.tp, ctx, m.shard = self.saved
        if hasattr(m, "decode_ctx"):
            m.decode_ctx = ctx


def trace_vs_card(torch, cell, tp, step) -> dict:
    """(a), (h)-(j): ``cell.lower()``, the dry run's meta trace of the split
    step (one batch row run, the others counted by symmetry), beside one
    split step of the same cell on the card (``step``, on inputs of the
    cell's input specs' dtypes and, for a decode, its cache index): every
    position's bytes between positions by kind, the busiest position's
    by kind and in all, exactly equal to ``tp.moved``'s."""
    from repro_torch.distributed.tensor_parallel import KINDS

    tp.moved.clear()
    step()
    torch.cuda.synchronize()
    card = +tp.moved
    per_pos = tp.by_position()
    busiest = max(sorted(per_pos), key=per_pos.__getitem__)
    t0 = time.perf_counter()
    low, _ = cell.lower()
    seconds = time.perf_counter() - t0
    assert low.trace == "split" and low.rows_traced == 1 < low.rows, low
    assert +low.moved == card, (low.moved, card)
    assert low.moved_bytes == per_pos[busiest]
    assert low.moved_by_kind == {k: card[k, busiest] for k in KINDS
                                 if card[k, busiest]}
    return {"step": "split", "trace_s": seconds, "trace_ops": low.n_ops,
            "rows": low.rows, "busiest": list(busiest),
            "busiest_bytes": low.moved_bytes,
            "busiest_by_kind": low.moved_by_kind,
            "bytes_by_kind": tp.bytes_by_kind()}


def decode_as(torch, cell, tp, path: str, nxt, cache):
    """One decode step of ``cell`` as ``path`` (``cell_path``); the
    mesh-less step calls the model, the others the cell's ``decode_fn``
    (which places the cache)."""
    with cell_path(cell, tp, path):
        if path == "mesh_less":
            return cell.model.decode_step(nxt, cache)
        return cell.decode_fn()({"tokens": nxt, "cache": cache})


def timed(torch, fn):
    """(``fn()``, ms to a sync)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def queued_ms(torch, step, nxt, n: int) -> float:
    """ms a token over ``n`` steps of ``step(nxt) -> logits`` queued as
    ``generate`` runs them (argmax on the card, one sync at the end)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        nxt = step(nxt).argmax(-1)[:, None]
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def split_error_ratio(torch, cell, tp, cache, g) -> dict:
    """bf16: layer 0's decode block (attention over a copy of layer 0's
    cache, then the MLP) on the split weights and mesh-less, and the head
    on one hidden state split and mesh-less, each against the same
    computed in fp32 (the block's weights and cache cast): relative norm
    errors. Phase 14's rule: the split error at most
    ``LM_MESH_ATTN_RATIO`` times the mesh-less one."""
    import copy

    from repro_torch.models.lm import layers as L

    model, ctx, idx = cell.model, cell.decode_ctx, cache["index"]
    layer = model.layers[0]
    b = LM_MESH_B if model.dtype == torch.bfloat16 else LM_MESH_FP32_B
    nxt = torch.randint(0, cell.cfg.vocab, (b, 1), generator=g,
                        device=model.device)
    x = L.take_rows(model.embed, nxt)
    k0, v0 = cache["k"][0].full(), cache["v"][0].full()

    def block(lyr, x_, kc, vc, ctx_):
        h = L.rms_norm(x_, lyr.ln1)
        a, _, _ = L.attention_decode(lyr.attn, model.dims, h, kc, vc, idx,
                                     decode_ctx=ctx_)
        x_ = x_ + a
        return x_ + L.swiglu(lyr.mlp, L.rms_norm(x_, lyr.ln2))

    err = lambda t, truth: float(  # noqa: E731
        (t.float() - truth).norm() / truth.norm())
    mless = block(layer, x, k0.clone(), v0.clone(), None)
    split = block(layer, tp.split_rows(x), k0.clone(), v0.clone(),
                  ctx).whole("heads")
    lyr32 = copy.deepcopy(layer).float()
    truth = block(lyr32, x.float(), k0.float(), v0.float(), None)
    out = {"block_err": err(split, truth),
           "block_err_mesh_less": err(mless, truth)}
    del lyr32, truth, k0, v0
    xh = L.rms_norm(torch.randn((b, 1, cell.cfg.d_model), generator=g,
                                device=model.device).to(model.dtype),
                    model.final_norm)
    truth = xh.float() @ model.lm_head.float()
    out["head_err"] = err(tp.head(tp.split_rows(xh), model.lm_head), truth)
    out["head_err_mesh_less"] = err(xh @ model.lm_head, truth)
    for part in ("block", "head"):
        assert out[f"{part}_err"] <= LM_MESH_ATTN_RATIO * max(
            out[f"{part}_err_mesh_less"], 1e-6), out
    return out


def lm_split_decode(torch, cell, cache, plain, nxt, mesh_res: dict,
                    card: str) -> dict:
    """(a) bf16, b = 4 and (b) fp32, b = 2: phase 14 (a)'s llama3-8b
    decode cell, its cache (placed, ``mesh_res['fill']`` + 9 slots
    written) and the mesh-less copy, run before phase 14 frees them. The
    parameters are split by ``Cell.place_params`` (views: no weight
    memory). ``LM_MESH_STEPS`` steps, each timed to a sync: phase 14's
    unsplit cell on the cache, then the split cell on the cache from the
    same index (its writes replace the unsplit step's), then the
    mesh-less step on its copy; then as many of each queued. bf16: the
    error ratios of ``split_error_ratio`` and the greedy tokens up to near
    ties (``check_tokens``); fp32: the split logits within
    ``MESH_DECODE_TOL`` of the mesh-less step's. One more step of each is
    counted: ATen ops and, split, the bytes between positions by kind."""
    dtype = cell.cfg.dtype
    t_start = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    tp = cell.place_params()
    assert torch.cuda.memory_allocated() == start, "placed weights copied"
    w_gate = cell.model.layers[0].mlp.w_gate
    fsdp = tp.placed(w_gate).split_dim("data") is not None
    g = torch.Generator(device=cell.model.device).manual_seed(SEED + 16)
    res = {"dtype": dtype, "b": nxt.shape[0], "layers": cell.cfg.n_layers,
           "specs": "TP x FSDP" if fsdp else "TP",
           "slots": cache["k"].shape[2], "start_index": cache["index"]}
    if dtype == "bfloat16":
        res.update(split_error_ratio(torch, cell, tp, cache, g))
    ms = {p: [] for p in ("split", "unsplit", "mesh_less")}
    worst, differ = 0.0, 0
    for step in range(LM_MESH_STEPS):
        idx = cache["index"]
        (lu, _), t_u = timed(torch, lambda: decode_as(
            torch, cell, tp, "unsplit", nxt, cache))
        cache["index"] = idx
        (ls, _), t_s = timed(torch, lambda: decode_as(
            torch, cell, tp, "split", nxt, cache))
        (lp, _), t_p = timed(torch, lambda: decode_as(
            torch, cell, tp, "mesh_less", nxt, plain))
        for path, t in (("split", t_s), ("unsplit", t_u),
                        ("mesh_less", t_p)):
            ms[path].append(t)
        assert torch.isfinite(ls.float()).all()
        if dtype == "float32":
            torch.testing.assert_close(ls, lp, **MESH_DECODE_TOL)
            torch.testing.assert_close(ls, lu, **MESH_DECODE_TOL)
        worst = max(worst, float((ls.float() - lp.float()).abs().max()))
        differ += check_tokens(torch, ls, lp, f"(split {dtype}) step {step}")
        nxt = lp.argmax(-1)[:, None]
    p50 = lambda v: sorted(v)[len(v) // 2]   # noqa: E731
    res.update({f"{p}_p50_ms": p50(v) for p, v in ms.items()})
    idx = cache["index"]
    queued = {}
    for path in ("split", "unsplit"):
        cache["index"] = idx
        queued[path] = queued_ms(torch, lambda t: decode_as(
            torch, cell, tp, path, t, cache)[0], nxt, LM_MESH_STEPS)
    queued["mesh_less"] = queued_ms(torch, lambda t: decode_as(
        torch, cell, tp, "mesh_less", t, plain)[0], nxt, LM_MESH_STEPS)
    res.update({f"{p}_queued_ms": t for p, t in queued.items()})
    ops = {}
    for path in ("unsplit", "split"):
        cache["index"] = idx
        tp.moved.clear()
        cell.decode_ctx.moved.clear()
        _, ops[path], _ = dispatch_counts(torch, lambda: decode_as(
            torch, cell, tp, path, nxt, cache))
        if path == "unsplit":
            # its one kind: the flash decode's, each copy counted twice
            res["unsplit_merge_bytes"] = sum(
                cell.decode_ctx.moved.values()) // 2
    res["moved_bytes"] = tp.bytes_by_kind()
    _, ops["mesh_less"], _ = dispatch_counts(torch, lambda: decode_as(
        torch, cell, tp, "mesh_less", nxt, plain))
    if dtype == "bfloat16":
        # the dry run's trace of this cell as cut here, beside one split
        # step at the trace's cache index with int32 tokens (its specs)
        from repro_torch.launch.steps import build_cell
        with lm_cell_config("llama3-8b", dtype=dtype), lm_cell_shape(
                "decode_32k", cache["k"].shape[2], nxt.shape[0]):
            twin = build_cell("llama3-8b", "decode_32k", cell.mesh,
                              device="meta")
        cache["index"] = twin.inputs_sds["cache"]["index"]
        res["trace"] = trace_vs_card(torch, twin, tp, lambda: decode_as(
            torch, cell, tp, "split", nxt.to(torch.int32), cache))
    res.update({f"{p}_ops": n for p, n in ops.items()})
    res.update({"max_abs_diff": worst, "tokens_differ": differ,
                "bound_ms": mesh_res["bound_ms"],
                "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                "extra_gib": (torch.cuda.max_memory_allocated() - start)
                / 2**30, "seconds": time.perf_counter() - t_start})
    cell.model.tp = None
    tr = res.get("trace")
    traced = ("" if tr is None else
              f" | dry-run trace of the cell as cut ({tr['trace_ops']} "
              f"ops, {tr['trace_s']:.2f} s, 1 of {tr['rows']} batch rows "
              f"run) equals one split step at index 0: busiest position "
              f"{tr['busiest']} {tr['busiest_bytes']} B "
              f"{tr['busiest_by_kind']}, all {tr['bytes_by_kind']}")
    check = (f"layer-0 block vs fp32 split {res['block_err']:.3e}, "
             f"mesh-less {res['block_err_mesh_less']:.3e}; head split "
             f"{res['head_err']:.3e}, mesh-less "
             f"{res['head_err_mesh_less']:.3e} (relative norm) | "
             if dtype == "bfloat16" else f"within {MESH_DECODE_TOL} | ")
    log(f"[lmsplit] ({'a' if dtype == 'bfloat16' else 'b'}) llama3-8b "
        f"decode_32k ({dtype}, L={res['layers']}, b={res['b']} of 128, "
        f"{res['specs']}; phase 14 (a)'s cache, {res['slots']} slots from "
        f"index {res['start_index']}, {LM_MESH_STEPS} steps) on "
        f"{cell.mesh.shape}: " + check
        + f"logits max|split-mesh-less| {worst:.3e}, {differ} greedy "
        f"tokens differ | ms/token p50 to a sync: split "
        f"{res['split_p50_ms']:.2f}, unsplit {res['unsplit_p50_ms']:.2f}, "
        f"mesh-less {res['mesh_less_p50_ms']:.2f}; queued "
        f"{queued['split']:.2f}, {queued['unsplit']:.2f}, "
        f"{queued['mesh_less']:.2f} (bound {res['bound_ms']:.2f}) | ATen "
        f"ops a step {ops['split']}, {ops['unsplit']}, {ops['mesh_less']} "
        f"| bytes between positions a step split {res['moved_bytes']}, "
        f"unsplit merge {res['unsplit_merge_bytes']}, mesh-less 0 | peak "
        f"{res['peak_gib']:.2f} GiB, {res['extra_gib']:.2f} over the "
        f"cell's{traced} | {card}")
    return res


def split_prefill_cell(torch, dev, mesh, dtype: str):
    """(c)'s llama3-8b prefill cell in ``dtype`` (all 32 layers, TP ×
    FSDP), ``prefill_32k`` cut to b = ``LM_MESH_B``, s =
    ``LM_SPLIT_PROMPT``, its weights from ``SEED`` and placed; returns
    (cell, its prefill_fn, the placed tree, the prompt)."""
    from repro_torch.launch.steps import build_cell

    with lm_cell_config("llama3-8b", dtype=dtype), lm_cell_shape(
            "prefill_32k", LM_SPLIT_PROMPT, LM_MESH_B):
        cell = build_cell("llama3-8b", "prefill_32k", mesh)
    g = torch.Generator(device=dev).manual_seed(SEED)
    cell.model.init(g)
    tokens = torch.randint(0, cell.cfg.vocab, (LM_MESH_B, LM_SPLIT_PROMPT),
                           generator=g, device=dev)
    return cell, cell.prefill_fn(), cell.place_params(), tokens


def lm_split_prefill(torch, dev, mesh, card: str) -> dict:
    """(c): llama3-8b's prefill cell (all 32 layers, TP × FSDP),
    ``prefill_32k`` cut to b = ``LM_MESH_B``, s = ``LM_SPLIT_PROMPT``.
    bf16: ``LM_SPLIT_RUNS`` prefills split and as many unplaced
    (mesh-less: the prefill cell runs whole on the first device),
    alternating, each to a sync; ATen ops and bytes between positions of
    one split prefill. fp32 (the check, as (b) holds the decode): the
    split prefill's logits within ``MESH_DECODE_TOL`` of the mesh-less
    prefill's and the greedy tokens equal up to near ties."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    cell, fn, tp, tokens = split_prefill_cell(torch, dev, mesh, "bfloat16")
    ms = {"split": [], "mesh_less": []}
    for _ in range(LM_SPLIT_RUNS):
        for path in ("split", "mesh_less"):
            cell.model.tp = tp if path == "split" else None
            (logits, _), t = timed(torch, lambda: fn({"tokens": tokens}))
            ms[path].append(t)
            if path == "split":
                ls = logits
            else:
                lp = logits
    assert torch.isfinite(ls.float()).all()
    gap = float((ls.float() - lp.float()).abs().max())
    ops = {}
    for path in ("mesh_less", "split"):
        cell.model.tp = tp if path == "split" else None
        tp.moved.clear()
        gemms, ops[path], _ = dispatch_counts(
            torch, lambda: fn({"tokens": tokens}))
    cell.model.tp = None
    weights = tensor_bytes(cell.model.state_dict())
    res = {"b": LM_MESH_B, "s": LM_SPLIT_PROMPT, "layers": cell.cfg.n_layers,
           "split_p50_ms": sorted(ms["split"])[LM_SPLIT_RUNS // 2],
           "mesh_less_p50_ms": sorted(ms["mesh_less"])[LM_SPLIT_RUNS // 2],
           "bound_ms": max(weights / hw.HBM_BW * 1e3,
                           flops_ms(torch, gemms)),
           "split_ops": ops["split"], "mesh_less_ops": ops["mesh_less"],
           "moved_bytes": tp.bytes_by_kind(), "max_abs_diff": gap,
           "peak_gib": (torch.cuda.max_memory_allocated() - base) / 2**30}
    del cell, fn, tp, tokens, ls, lp, logits
    released(torch, base, "(c) split prefill, bf16")
    torch.cuda.reset_peak_memory_stats()
    cell, fn, tp, tokens = split_prefill_cell(torch, dev, mesh, "float32")
    ls = fn({"tokens": tokens})[0]
    cell.model.tp = None
    lp = fn({"tokens": tokens})[0]
    assert torch.isfinite(ls).all()
    torch.testing.assert_close(ls, lp, **MESH_DECODE_TOL)
    res.update({"fp32_max_abs_diff": float((ls - lp).abs().max()),
                "fp32_tokens_differ": check_tokens(torch, ls, lp,
                                                   "(c) fp32"),
                "fp32_peak_gib": (torch.cuda.max_memory_allocated() - base)
                / 2**30})
    log(f"[lmsplit] (c) llama3-8b prefill_32k (L={res['layers']}, TP x "
        f"FSDP; b={LM_MESH_B} of 32, s={LM_SPLIT_PROMPT} of 32,768) on "
        f"{mesh.shape}: fp32 within {MESH_DECODE_TOL}, logits "
        f"max|split-mesh-less| {res['fp32_max_abs_diff']:.3e}, "
        f"{res['fp32_tokens_differ']} greedy tokens differ | bf16 logits "
        f"max|split-mesh-less| {gap:.3e} | bf16 prefill p50 of "
        f"{LM_SPLIT_RUNS}: split {res['split_p50_ms']:.2f} ms, mesh-less "
        f"{res['mesh_less_p50_ms']:.2f} (bound {res['bound_ms']:.2f}) | "
        f"ATen ops {ops['split']}, {ops['mesh_less']} | bytes between "
        f"positions {res['moved_bytes']} | peak bf16 "
        f"{res['peak_gib']:.2f} GiB, fp32 {res['fp32_peak_gib']:.2f} | "
        f"{card}")
    del cell, fn, tp, tokens, ls, lp
    released(torch, base, "(c) split prefill, fp32")
    return res


def moe_error_ratio(torch, cell, tp, g) -> dict:
    """Layer 0's experts (``moe_ffn``) on one normed hidden state of
    ``LM_MESH_B`` tokens, split and mesh-less, against the same with the
    experts cast to fp32: every path routes from the same fp32 router
    logits, so they run the same experts. Phase 14's ratio rule, as in
    ``split_error_ratio``."""
    import copy

    from repro_torch.models.lm import layers as L
    from repro_torch.models.lm.moe import moe_ffn

    model, cfg = cell.model, cell.cfg
    ffn = model.layers[0].moe
    x = L.rms_norm(torch.randn((LM_MESH_B, 1, cfg.d_model), generator=g,
                               device=model.device).to(model.dtype),
                   model.layers[0].ln2)
    mless, _ = moe_ffn(ffn, x, cfg)
    split, _ = moe_ffn(ffn, tp.split_rows(x), cfg)
    split = split.whole("moe_tokens")
    truth, _ = moe_ffn(copy.deepcopy(ffn).float(), x.float(), cfg)
    err = lambda t: float((t.float() - truth).norm() / truth.norm())  # noqa
    out = {"ffn_err": err(split), "ffn_err_mesh_less": err(mless)}
    assert out["ffn_err"] <= LM_MESH_ATTN_RATIO * max(
        out["ffn_err_mesh_less"], 1e-6), out
    return out


def split_moe_cell(torch, dev, mesh, dtype: str):
    """(d)'s phi3.5-moe decode cell in ``dtype`` (depth
    ``LM_SPLIT_MOE[1]``, published width), its weights from ``SEED``, a
    ``LM_MESH_SEQ``-slot cache of b = ``LM_MESH_B`` filled to
    ``LM_MESH_SEQ_FILL`` and placed, the parameters placed; returns
    (cell, placed tree, cache, first tokens, weight bytes, TP × FSDP?)."""
    from repro_torch.launch.steps import build_cell

    arch, layers = LM_SPLIT_MOE
    with lm_cell_config(arch, layers, dtype=dtype):
        cell = build_cell(arch, "decode_32k", mesh)
    g = torch.Generator(device=dev).manual_seed(SEED)
    cell.model.init(g)
    cache = cell.place_cache(fill_cache(torch, cell.model.init_cache(
        LM_MESH_B, LM_MESH_SEQ), LM_MESH_SEQ_FILL, g))
    tp = cell.place_params()
    weights = tensor_bytes(cell.model.state_dict())
    fsdp = tp.placed(cell.model.layers[0].moe.w_gate).split_dim("data") == 1
    assert fsdp == (weights / mesh.shape["model"] > 8 * 2**30), weights
    nxt = torch.randint(0, cell.cfg.vocab, (LM_MESH_B, 1), generator=g,
                        device=dev)
    return cell, tp, cache, nxt, weights, fsdp


def lm_split_moe(torch, dev, mesh, card: str) -> dict:
    """(d): phi3.5-moe decode (depth ``LM_SPLIT_MOE[1]``, published width,
    b = ``LM_MESH_B``, experts over ``model``; the model shard is over 8
    GiB in both dtypes, so ``data`` stays: TP × FSDP). bf16, timed:
    ``LM_SPLIT_MOE_STEPS`` steps, each from one cache state, of the
    unsplit cell, the split cell (from the same index) and the mesh-less
    step on a copy; bf16 routing flips on one ulp, so these steps are
    counted, not checked, and the split experts are held to fp32 on one
    input by ``moe_error_ratio``. fp32, the check (as phase 14 (b) holds
    its MoE decode): as many split and mesh-less steps from one cache
    state, each held to ``MESH_DECODE_TOL`` and its greedy tokens up to
    near ties where every layer routed every token alike; a run where no
    step did fails."""
    arch, layers = LM_SPLIT_MOE
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    cell, tp, cache, nxt, weights, fsdp = split_moe_cell(
        torch, dev, mesh, "bfloat16")
    routes = routing_record(torch)
    ms = {p: [] for p in ("split", "unsplit", "mesh_less")}
    bf16_flips, gap = 0, 0.0
    for step in range(LM_SPLIT_MOE_STEPS):
        plain = whole_copy(torch, cache)
        idx = cache["index"]
        with routes:
            (lu, _), t_u = timed(torch, lambda: decode_as(
                torch, cell, tp, "unsplit", nxt, cache))
            cache["index"] = idx
            (ls, _), t_s = timed(torch, lambda: decode_as(
                torch, cell, tp, "split", nxt, cache))
            (lp, _), t_p = timed(torch, lambda: decode_as(
                torch, cell, tp, "mesh_less", nxt, plain))
        for path, t in (("split", t_s), ("unsplit", t_u),
                        ("mesh_less", t_p)):
            ms[path].append(t)
        calls = routes.take()
        n = len(calls) // 3
        assert torch.isfinite(ls.float()).all()
        bf16_flips += not all(torch.equal(a, b) for a, b in zip(
            calls[n:2 * n], calls[2 * n:]))
        gap = max(gap, float((ls.float() - lp.float()).abs().max()))
        nxt = lp.argmax(-1)[:, None]
    g = torch.Generator(device=dev).manual_seed(SEED + 16)
    res_ffn = moe_error_ratio(torch, cell, tp, g)
    tp.moved.clear()
    _, split_ops, _ = dispatch_counts(torch, lambda: decode_as(
        torch, cell, tp, "split", nxt, cache))
    p50 = lambda v: sorted(v)[len(v) // 2]   # noqa: E731
    res = {"arch": arch, "layers": layers, "b": LM_MESH_B,
           "weights_gb": weights / 1e9,
           "specs": "TP x FSDP" if fsdp else "TP",
           **{f"{p}_p50_ms": p50(v) for p, v in ms.items()},
           "split_ops": split_ops, "moved_bytes": tp.bytes_by_kind(),
           "bf16_max_abs_diff": gap, "bf16_routing_flips": bf16_flips,
           **res_ffn,
           "peak_gib": (torch.cuda.max_memory_allocated() - base) / 2**30}
    del cell, tp, cache, plain, nxt, ls, lp, lu
    released(torch, base, "(d) split MoE, bf16")

    torch.cuda.reset_peak_memory_stats()
    cell, tp, cache, nxt, weights, fsdp = split_moe_cell(
        torch, dev, mesh, "float32")
    worst, differ, flips = 0.0, 0, 0
    for step in range(LM_SPLIT_MOE_STEPS):
        plain = whole_copy(torch, cache)
        with routes:
            ls = decode_as(torch, cell, tp, "split", nxt, cache)[0]
            lp = decode_as(torch, cell, tp, "mesh_less", nxt, plain)[0]
        calls = routes.take()
        n = len(calls) // 2
        assert torch.isfinite(ls).all()
        nxt = lp.argmax(-1)[:, None]
        diff = [i for i, (a, b) in enumerate(zip(calls[:n], calls[n:]))
                if not torch.equal(a, b)]
        if diff:
            flips += 1
            log(f"[lmsplit] (d) fp32 step {step}: the routing differs from "
                f"layer {diff[0]} on ({len(diff)} of {n} layers), "
                f"max|diff| {float((ls - lp).abs().max()):.3e}, not held "
                "to the tolerance")
            continue
        torch.testing.assert_close(ls, lp, **MESH_DECODE_TOL)
        worst = max(worst, float((ls - lp).abs().max()))
        differ += check_tokens(torch, ls, lp, f"(d) fp32 step {step}")
    assert flips < LM_SPLIT_MOE_STEPS, "(d): no fp32 step routed alike"
    res.update({"fp32_weights_gb": weights / 1e9,
                "fp32_specs": "TP x FSDP" if fsdp else "TP",
                "max_abs_diff": worst,
                "tokens_differ": differ, "routing_flips": flips,
                "fp32_peak_gib": (torch.cuda.max_memory_allocated() - base)
                / 2**30})
    log(f"[lmsplit] (d) {arch} decode (L={layers} of 32, b={LM_MESH_B}, "
        f"cache {LM_MESH_SEQ} filled to {LM_MESH_SEQ_FILL}, experts over "
        f"model) on {mesh.shape}: fp32 ({res['fp32_weights_gb']:.2f} GB, "
        f"{res['fp32_specs']}) {flips} of {LM_SPLIT_MOE_STEPS} steps routed "
        f"differently, the others within {MESH_DECODE_TOL}: "
        f"max|split-mesh-less| {worst:.3e}, {differ} greedy tokens differ "
        f"| bf16 ({res['weights_gb']:.2f} GB, {res['specs']}): layer 0's "
        f"experts on one hidden state vs fp32: split "
        f"{res['ffn_err']:.3e}, mesh-less {res['ffn_err_mesh_less']:.3e} "
        f"(relative norm); {bf16_flips} of {LM_SPLIT_MOE_STEPS} steps "
        f"routed differently (max|split-mesh-less| {gap:.3e}, not "
        f"checked) | bf16 ms/token p50 split {res['split_p50_ms']:.2f}, "
        f"unsplit {res['unsplit_p50_ms']:.2f}, mesh-less "
        f"{res['mesh_less_p50_ms']:.2f} | {split_ops} ATen ops a split "
        f"step | bytes between positions a step {res['moved_bytes']} | "
        f"peak bf16 {res['peak_gib']:.2f} GiB, fp32 "
        f"{res['fp32_peak_gib']:.2f} | {card}")
    del cell, cache, plain, tp, nxt, ls, lp
    released(torch, base, "(d) split MoE, fp32")
    return res


def lm_split_small(torch, dev, mesh, arch: str) -> tuple[float, float]:
    """(e): the arch's ``reduced()`` fp32 prefill and decode cells, placed,
    on the card's mesh and on a CPU mesh of the same shape with the same
    weights: a prefill of ``LM_MESH_SMALL['prompt']`` rows, then 6 decode
    steps from a prefill into 16 slots. Returns (max |card - CPU|, max
    |split - mesh-less| on the card)."""
    from repro_torch.distributed import make_mesh
    from repro_torch.launch.steps import build_cell

    c = LM_MESH_SMALL
    cpu = torch.device("cpu")
    host_mesh = make_mesh(mesh.devices.shape, mesh.axis_names, "cpu")
    cells = {}
    with lm_cell_config(arch, reduced=True), lm_cell_shape(
            "prefill_32k", c["prompt"], LM_MESH_B), lm_cell_shape(
            "decode_32k", c["s_max"], LM_MESH_B):
        for kind in ("prefill_32k", "decode_32k"):
            cells[kind] = (build_cell(arch, kind, host_mesh),
                           build_cell(arch, kind, mesh))
    state = None
    for host, card in cells.values():
        if state is None:
            host.model.init(torch.Generator().manual_seed(SEED))
            state = host.model.state_dict()
        host.model.load_state_dict(state)
        card.model.load_state_dict(state)
        host.place_params()
        card.place_params()
    cfg = cells["prefill_32k"][0].cfg
    g = torch.Generator().manual_seed(SEED + 6)
    n_tok = c["prompt"] - (c["patches"] if cfg.family == "vlm" else 0)
    inputs = {"tokens": torch.randint(0, cfg.vocab, (LM_MESH_B, n_tok),
                                      generator=g)}
    if cfg.family == "encdec":
        inputs["frames"] = torch.randn((LM_MESH_B, c["frames"], cfg.d_model),
                                       generator=g) * 0.1
    if cfg.family == "vlm":
        inputs["patch_embeds"] = torch.randn(
            (LM_MESH_B, c["patches"], cfg.d_model), generator=g) * 0.02
    on = {k: v.to(dev) for k, v in inputs.items()}
    vs_cpu = vs_plain = 0.0

    def check(got, host_l, plain_l):
        nonlocal vs_cpu, vs_plain
        torch.testing.assert_close(got.cpu(), host_l, **CPU_TOL)
        torch.testing.assert_close(got, plain_l, **MESH_DECODE_TOL)
        vs_cpu = max(vs_cpu, float((got.cpu() - host_l).abs().max()))
        vs_plain = max(vs_plain, float((got - plain_l).abs().max()))

    host, card = cells["prefill_32k"]
    lh, _ = host.prefill_fn()(inputs)
    lc, _ = card.prefill_fn()(on)
    with cell_path(card, card.tp, "mesh_less"):
        lp, _ = card.prefill_fn()(on)
    check(lc, lh, lp)

    host, card = cells["decode_32k"]

    def prefill(model, x):
        b = LM_MESH_B
        if cfg.family == "encdec":
            return model.prefill(x["tokens"], x["frames"], model.init_cache(
                b, c["s_max"], c["frames"]))
        cache = model.init_cache(b, c["s_max"])
        if cfg.family == "vlm":
            return model.prefill(x["tokens"], cache,
                                 patch_embeds=x["patch_embeds"])
        return model.prefill(x["tokens"], cache)

    lh, ch = prefill(host.model, inputs)
    lc, cc = prefill(card.model, on)
    plain = whole_copy(torch, cc)
    for _ in range(c["steps"]):
        nxt = lh.argmax(-1)[:, None]
        lh, ch = host.decode_fn()({"tokens": nxt, "cache": ch})
        lc, cc = decode_as(torch, card, card.tp, "split", nxt.to(dev), cc)
        lp, plain = decode_as(torch, card, card.tp, "mesh_less",
                              nxt.to(dev), plain)
        check(lc, lh, lp)
    return vs_cpu, vs_plain


def recurrent_error_ratio(torch, cell, tp, plain, g) -> dict:
    """(f) bf16, as ``split_error_ratio`` holds (a): layer 0's recurrent
    block (rwkv6: time mix and channel mix; zamba2: the Mamba block) on
    one new token from the layer's states in ``plain`` (a whole copy of
    the cache), split (the states placed anew by ``cache_specs``) and
    mesh-less, and the head on one hidden state split and mesh-less, each
    against the same computed in fp32 (the layer and states cast):
    relative norm errors, the split error at most
    ``LM_MESH_ATTN_RATIO`` times the mesh-less one."""
    import copy

    from repro_torch.models.lm import layers as L

    model = cell.model
    rwkv = cell.cfg.family == "ssm"
    layer = model.layers[0] if rwkv else model.mamba[0]
    states = plain if rwkv else plain["mamba"]
    nxt = torch.randint(0, cell.cfg.vocab, (LM_MESH_B, 1), generator=g,
                        device=model.device)

    def block(lyr, x_, dtype=None):
        st = {k: v[0].to(dtype or v.dtype, copy=True)
              for k, v in states.items()}
        return (model._block(lyr, x_, st) if rwkv
                else model._mamba_block(lyr, x_, st))[0]

    def split_block(x_):
        st = {k: v[0] for k, v in tp.place_states(
            {k: v[:1].clone() for k, v in states.items()}).items()}
        xr = tp.split_rows(x_)
        if rwkv:
            y = xr + model._time_mix_split(layer, L.rms_norm(xr, layer.ln1),
                                           st)
            y = y + model._channel_mix_split(layer, L.rms_norm(y, layer.ln2),
                                             st)
            return y.whole("heads")
        return model._mamba_block_split(layer, xr, st).whole("heads")

    err = lambda t, truth: float(  # noqa: E731
        (t.float() - truth).norm() / truth.norm())
    with torch.no_grad():
        x = L.take_rows(model.embed, nxt)
        mless, split = block(layer, x), split_block(x)
        truth = block(copy.deepcopy(layer).float(), x.float(),
                      torch.float32).float()
        out = {"block_err": err(split, truth),
               "block_err_mesh_less": err(mless, truth)}
        xh = L.rms_norm(torch.randn((LM_MESH_B, 1, cell.cfg.d_model),
                                    generator=g, device=model.device
                                    ).to(model.dtype), model.final_norm)
        truth = xh.float() @ model.lm_head.float()
        out["head_err"] = err(tp.head(tp.split_rows(xh), model.lm_head),
                              truth)
        out["head_err_mesh_less"] = err(xh @ model.lm_head, truth)
    for part in ("block", "head"):
        assert out[f"{part}_err"] <= LM_MESH_ATTN_RATIO * max(
            out[f"{part}_err_mesh_less"], 1e-6), (cell.arch, out)
    return out


def split_recurrent_cell(torch, dev, mesh, arch: str, dtype: str):
    """(f)'s decode cell of ``arch`` at published width and depth in
    ``dtype``, ``decode_32k`` cut to b = ``LM_MESH_B``, its weights from
    ``SEED`` and placed, then a split prefill of ``LM_SPLIT_REC_PROMPT``
    tokens into a fresh cache of the cell's slots (its states placed by
    ``cache_specs``); returns (cell, placed tree, cache, first tokens,
    weight bytes, prefill ms)."""
    from repro_torch.configs import SHAPES
    from repro_torch.launch.steps import build_cell

    with lm_cell_config(arch, dtype=dtype), lm_cell_shape(
            "decode_32k", SHAPES["decode_32k"].seq, LM_MESH_B):
        cell = build_cell(arch, "decode_32k", mesh)
    g = torch.Generator(device=dev).manual_seed(SEED)
    cell.model.init(g)
    tp = cell.place_params()
    tokens = torch.randint(0, cell.cfg.vocab, (LM_MESH_B, LM_SPLIT_REC_PROMPT),
                           generator=g, device=dev)
    cache = cell.model.init_cache(LM_MESH_B, cell.cell.seq)
    (logits, cache), ms = timed(torch, lambda: cell.model.prefill(tokens,
                                                                  cache))
    return (cell, tp, cache, logits.argmax(-1)[:, None],
            tensor_bytes(cell.model.state_dict()), ms)


def lm_split_recurrent(torch, dev, mesh, arch: str, card: str) -> dict:
    """(f): ``arch`` (rwkv6-7b or zamba2-1.2b) at published width and
    depth, its decode cell on the card's mesh, parameters and state
    caches split (``split_recurrent_cell``). bf16, timed:
    ``LM_SPLIT_REC_STEPS`` split steps and as many mesh-less ones on a
    whole copy of the cache, each to a sync, then as many of each queued;
    ATen ops a step split and mesh-less, the bytes between positions a
    split step by kind, the peak memory; the bf16 logits' drift is
    recorded, and layer 0's recurrent block and the head are held to fp32
    by ``recurrent_error_ratio``. fp32, the check (as (b) and (d) hold
    theirs):
    as many split and mesh-less steps, the logits within
    ``MESH_DECODE_TOL`` and the greedy tokens equal up to near ties. The
    bound a token is the weights' bytes over ``hw.HBM_BW``."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t_start = time.perf_counter()
    cell, tp, cache, nxt, weights, pre_ms = split_recurrent_cell(
        torch, dev, mesh, arch, "bfloat16")
    plain = whole_copy(torch, cache)
    ratio = recurrent_error_ratio(
        torch, cell, tp, plain,
        torch.Generator(device=dev).manual_seed(SEED + 16))
    ms = {"split": [], "mesh_less": []}
    gap, differ = 0.0, 0
    for _ in range(LM_SPLIT_REC_STEPS):
        (ls, _), t_s = timed(torch, lambda: decode_as(
            torch, cell, tp, "split", nxt, cache))
        (lp, _), t_p = timed(torch, lambda: decode_as(
            torch, cell, tp, "mesh_less", nxt, plain))
        ms["split"].append(t_s)
        ms["mesh_less"].append(t_p)
        assert torch.isfinite(ls.float()).all() and torch.isfinite(
            lp.float()).all()
        gap = max(gap, float((ls.float() - lp.float()).abs().max()))
        differ += int((ls.argmax(-1) != lp.argmax(-1)).sum())
        nxt = lp.argmax(-1)[:, None]
    queued = {path: queued_ms(torch, lambda t: decode_as(
        torch, cell, tp, path, t, cache if path == "split" else plain)[0],
        nxt, LM_SPLIT_REC_STEPS) for path in ("split", "mesh_less")}
    tp.moved.clear()
    _, split_ops, _ = dispatch_counts(torch, lambda: decode_as(
        torch, cell, tp, "split", nxt, cache))
    moved = tp.bytes_by_kind()
    _, plain_ops, _ = dispatch_counts(torch, lambda: decode_as(
        torch, cell, tp, "mesh_less", nxt, plain))
    p50 = lambda v: sorted(v)[len(v) // 2]   # noqa: E731
    res = {"arch": arch, "layers": cell.cfg.n_layers, "b": LM_MESH_B,
           "slots": cell.cell.seq, "prompt": LM_SPLIT_REC_PROMPT,
           "weights_gb": weights / 1e9,
           "cache_mb": tensor_bytes(plain) / 1e6,
           "prefill_ms": pre_ms,
           **{f"{p}_p50_ms": p50(v) for p, v in ms.items()},
           **{f"{p}_queued_ms": t for p, t in queued.items()},
           "split_ops": split_ops, "mesh_less_ops": plain_ops,
           "moved_bytes": moved, "bf16_max_abs_diff": gap,
           "bf16_tokens_differ": differ, **ratio,
           "bound_ms": weights / hw.HBM_BW * 1e3,
           "peak_gib": (torch.cuda.max_memory_allocated() - base) / 2**30}
    del cell, tp, cache, plain, nxt, ls, lp
    released(torch, base, f"(f) {arch}, bf16")

    torch.cuda.reset_peak_memory_stats()
    cell, tp, cache, nxt, weights, _ = split_recurrent_cell(
        torch, dev, mesh, arch, "float32")
    plain = whole_copy(torch, cache)
    worst, differ = 0.0, 0
    for step in range(LM_SPLIT_REC_STEPS):
        ls = decode_as(torch, cell, tp, "split", nxt, cache)[0]
        lp = decode_as(torch, cell, tp, "mesh_less", nxt, plain)[0]
        assert torch.isfinite(ls).all()
        torch.testing.assert_close(ls, lp, **MESH_DECODE_TOL)
        worst = max(worst, float((ls - lp).abs().max()))
        differ += check_tokens(torch, ls, lp, f"(f) {arch} fp32 step {step}")
        nxt = lp.argmax(-1)[:, None]
    res.update({"fp32_weights_gb": weights / 1e9, "max_abs_diff": worst,
                "tokens_differ": differ,
                "fp32_peak_gib": (torch.cuda.max_memory_allocated() - base)
                / 2**30, "seconds": time.perf_counter() - t_start})
    log(f"[lmsplit] (f) {arch} decode_32k (L={res['layers']}, published "
        f"width, b={LM_MESH_B} of 128, {res['slots']} slots, split prefill "
        f"of {LM_SPLIT_REC_PROMPT}) on {mesh.shape}: fp32 "
        f"({res['fp32_weights_gb']:.2f} GB) within {MESH_DECODE_TOL} over "
        f"{LM_SPLIT_REC_STEPS} steps, max|split-mesh-less| {worst:.3e}, "
        f"{differ} greedy tokens differ | bf16 ({res['weights_gb']:.2f} "
        f"GB, cache {res['cache_mb']:.1f} MB): layer-0 block vs fp32 "
        f"split {ratio['block_err']:.3e}, mesh-less "
        f"{ratio['block_err_mesh_less']:.3e}; head split "
        f"{ratio['head_err']:.3e}, mesh-less "
        f"{ratio['head_err_mesh_less']:.3e} (relative norm, within "
        f"{LM_MESH_ATTN_RATIO}x); logits max|split-mesh-less| {gap:.3e}, "
        f"{res['bf16_tokens_differ']} tokens differ | bf16 ms/token p50 "
        f"to a sync split "
        f"{res['split_p50_ms']:.2f}, mesh-less {res['mesh_less_p50_ms']:.2f};"
        f" queued {queued['split']:.2f}, {queued['mesh_less']:.2f} (bound "
        f"{res['bound_ms']:.2f}) | split prefill {pre_ms:.1f} ms | ATen ops "
        f"a step {split_ops}, {plain_ops} | bytes between positions a "
        f"split step {moved} | peak bf16 {res['peak_gib']:.2f} GiB, fp32 "
        f"{res['fp32_peak_gib']:.2f} | {card}")
    del cell, tp, cache, plain, nxt, ls, lp
    released(torch, base, f"(f) {arch}, fp32")
    return res


def split_train_cell(torch, dev, mesh, arch: str, layers, b: int, s: int,
                     dtype: str):
    """(g)-(j)'s train cell of ``arch`` in ``dtype`` (depth cut to
    ``layers``; remat as published), ``train_4k`` cut to b, s, its
    weights from ``SEED``, and one batch of tokens.

    rwkv6's bonus ``u`` is drawn from N(0, 0.5²) instead of the init's
    zeros: with ``u`` = 0 and a zero state the first WKV output is exactly
    0, ``ln_x`` scales its gradient by rsqrt(eps) = 1e3, and layer 0's
    ``u`` gradient holds to ``TRAIN_SPLIT_TOL`` in no fp32 evaluation:
    weights moved by a relative 1e-7 move elements of it out of the
    tolerance (``u_misses``; (i) logs the count from zeros and from the
    draw)."""
    from repro_torch.launch.steps import build_cell
    from repro_torch.models.lm import layers as L

    with lm_cell_config(arch, layers, dtype=dtype), lm_cell_shape(
            "train_4k", s, b):
        cell = build_cell(arch, "train_4k", mesh)
    g = torch.Generator(device=dev).manual_seed(SEED)
    cell.model.init(g)
    if cell.cfg.family == "ssm":
        with torch.no_grad():
            for layer in cell.model.layers:
                L.normal_(layer.u, g, 0.5)
    return cell, {"tokens": torch.randint(0, cell.cfg.vocab, (b, s),
                                          generator=g, device=dev)}


def host_leaves(torch, tree) -> list:
    """(path, CPU copy) of each leaf of a tree of tensors or placed
    values (assembled)."""
    from repro_torch.bridge import _leaves
    from repro_torch.distributed import Placed
    return [(p, (t.full() if isinstance(t, Placed) else t.detach()).to(
        "cpu", copy=True)) for p, t in _leaves(tree)]


def held_to(torch, tree, want: list, tag: str) -> float:
    """Every leaf of ``tree`` (assembled) within ``TRAIN_SPLIT_TOL`` of
    ``want`` (``host_leaves``); the largest absolute difference."""
    from repro_torch.bridge import _leaves
    from repro_torch.distributed import Placed
    worst = 0.0
    for (path, t), (wpath, w) in zip(_leaves(tree), want, strict=True):
        assert path == wpath, (path, wpath)
        got = t.full() if isinstance(t, Placed) else t.detach()
        w = w.to(got.device)
        torch.testing.assert_close(
            got, w, msg=lambda m, p=path: f"{tag} {p}: {m}",
            **TRAIN_SPLIT_TOL)
        worst = max(worst, float((got - w).abs().max()))
    return worst


def u_misses(torch, cell, batch, u_scale: float) -> int:
    """rwkv6: the elements of layer 0's ``u`` gradient (the unsplit fp32
    step, every ``u`` drawn as ``split_train_cell`` draws it times
    ``u_scale``; 0: the init's zeros) that leave ``TRAIN_SPLIT_TOL`` of
    themselves when every weight moves by a relative 1e-7 (a seeded
    draw). The weights are left as they were."""
    from repro_torch.bridge import _leaves

    model = cell.model
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}

    def u_grad():
        tree = model.param_tree()
        model.loss(batch).backward()
        g = model.layers[0].u.grad.clone()
        for _, t in _leaves(tree):
            t.grad = None
            t.requires_grad_(False)
        return g

    with torch.no_grad():
        for layer in model.layers:
            layer.u.mul_(u_scale)
    want = u_grad()
    gen = torch.Generator(device=model.device).manual_seed(SEED + 32)
    with torch.no_grad():
        for v in model.state_dict().values():
            v.mul_(1 + 1e-7 * torch.randn(v.shape, generator=gen,
                                          device=v.device, dtype=v.dtype))
    got = u_grad()
    with torch.no_grad():
        for k, v in model.state_dict().items():
            v.copy_(start[k])
    return int((~torch.isclose(got, want, **TRAIN_SPLIT_TOL)).sum())


def split_train_check(torch, dev, mesh, arch: str, layers, b: int,
                      s: int) -> dict:
    """(g)-(j) fp32 (TF32 off): one step of the unsplit cell (its results
    kept on the host), then, from the same weights and batch, one split
    step (``Cell.place_params``): the loss, ``grad_norm``, every
    gradient leaf and params, m and v after the update within
    ``TRAIN_SPLIT_TOL``."""
    import dataclasses

    from repro_torch.training import adamw_update
    from repro_torch.training.train_loop import loss_and_grads

    cell, batch = split_train_cell(torch, dev, mesh, arch, layers, b, s,
                                   "float32")
    cell.opt_cfg = dataclasses.replace(cell.opt_cfg, eps=TRAIN_SPLIT_EPS)
    # why rwkv6's u is drawn: the step's own conditioning at the init's 0
    conditioning = {} if cell.cfg.family != "ssm" else {
        "u_misses_zero": u_misses(torch, cell, batch, 0.0),
        "u_misses_drawn": u_misses(torch, cell, batch, 1.0),
        "u_numel": cell.model.layers[0].u.numel()}
    start = {k: v.to("cpu", copy=True)
             for k, v in cell.model.state_dict().items()}
    state = cell.train_state()
    loss, grads = loss_and_grads(cell.model, state.params, batch,
                                 cell.n_micro)
    want = {"grads": host_leaves(torch, grads)}
    state, metrics = adamw_update(state, grads, cell.opt_cfg)
    want.update({part: host_leaves(torch, getattr(state, part))
                 for part in ("params", "m", "v")})
    want_loss, want_norm = float(loss), float(metrics["grad_norm"])
    del state, grads, metrics
    with torch.no_grad():
        for k, v in cell.model.state_dict().items():
            v.copy_(start[k])
    del start
    cell.place_params()
    state = cell.train_state()
    loss, grads = loss_and_grads(cell.model, state.params, batch,
                                 cell.n_micro)
    res = {"loss": float(loss), "loss_unsplit": want_loss,
           "grads_max_abs_diff": held_to(torch, grads, want.pop("grads"),
                                         f"({arch}) gradient")}
    state, metrics = adamw_update(state, grads, cell.opt_cfg)
    del grads
    res["grad_norm"], res["grad_norm_unsplit"] = (
        float(metrics["grad_norm"]), want_norm)
    for k in ("loss", "grad_norm"):
        torch.testing.assert_close(torch.tensor(res[k]),
                                   torch.tensor(res[f"{k}_unsplit"]),
                                   msg=k, **TRAIN_SPLIT_TOL)
    for part in ("params", "m", "v"):
        res[f"{part}_max_abs_diff"] = held_to(
            torch, getattr(state, part), want.pop(part), f"({arch}) {part}")
    res["policy"] = cell.policy
    res.update(conditioning)
    del cell, state, metrics, batch
    return res


def split_train_time(torch, dev, mesh, arch: str, layers, b: int,
                     s: int, trace: bool = False) -> dict:
    """(g)-(j) bf16 (fp32 AdamW state, remat): ``LM_SPLIT_TRAIN_STEPS``
    steps to a sync of each path from one set of weights (each path's
    steps move them; split first, its state freed before the others):
    split (``Cell.place_params``), unsplit (whole weights, the cell's
    ``shard`` hook) and mesh-less; then one more of each counted (ATen
    ops; split, the bytes between positions by kind, with the forward's
    alone first, under ``no_grad``); peak memory of each path's steps
    above the weights; the step's bound (``lm_train_bound``). ``trace``:
    the cell's dry-run trace held to one more split step
    (``trace_vs_card``, int32 tokens as the cell's input specs)."""
    cell, batch = split_train_cell(torch, dev, mesh, arch, layers, b, s,
                                   "bfloat16")
    n_params, n_gemm = lm_param_counts(cell.cfg)
    res = {"layers": cell.cfg.n_layers, "params": n_params,
           "policy": cell.policy, "n_micro": cell.n_micro,
           "remat": cell.cfg.remat,
           **lm_train_bound(cell.cfg, n_params, n_gemm, b, s)}
    tp = cell.place_params()
    base = torch.cuda.memory_allocated()
    p50 = lambda v: sorted(v)[len(v) // 2]   # noqa: E731
    for path in ("split", "unsplit", "mesh_less"):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with cell_path(cell, tp, path):
            state = cell.train_state()
            step = cell.train_step_fn()
            times, losses = [], []
            for _ in range(LM_SPLIT_TRAIN_STEPS):
                (state, m), t = timed(torch, lambda: step(state, batch))
                times.append(t)
                losses.append(float(m["loss"]))
            assert all(math.isfinite(x) for x in losses), (path, losses)
            if path == "split":
                tp.moved.clear()
                with torch.no_grad():
                    cell.model.loss(batch)
                tp.release()
                res["forward_bytes"] = tp.bytes_by_kind()
                tp.moved.clear()
            _, res[f"{path}_ops"], _ = dispatch_counts(
                torch, lambda: step(state, batch))
            if path == "split":
                res["step_bytes"] = tp.bytes_by_kind()
                if trace:
                    ids = {k: v.to(torch.int32) for k, v in batch.items()}
                    res["trace"] = trace_vs_card(
                        torch, cell, tp, lambda: step(state, ids))
        res[f"{path}_p50_ms"] = p50(times)
        res[f"{path}_losses"] = losses
        res[f"{path}_peak_gib"] = (torch.cuda.max_memory_allocated()
                                   - base) / 2**30
        del state, step
    return res


def lm_split_train(torch, dev, mesh, item: str, arch: str, layers, b: int,
                   s: int, card: str) -> dict:
    """(g)-(j): ``arch``'s train cell on the card's mesh, its weights
    split: the fp32 check (``split_train_check``), then the bf16 times
    and counts (``split_train_time``)."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    t_start = time.perf_counter()
    res = {"arch": arch, "b": b, "s": s,
           "fp32": split_train_check(torch, dev, mesh, arch, layers, b, s)}
    gc.collect()
    released(torch, base, f"({item}) {arch}, fp32")
    res.update(split_train_time(torch, dev, mesh, arch, layers, b, s,
                                trace=item in ("h", "i", "j")))
    gc.collect()
    released(torch, base, f"({item}) {arch}, bf16")
    res["seconds"] = time.perf_counter() - t_start
    f32, fwd, step = res["fp32"], res["forward_bytes"], res["step_bytes"]
    # a train step places no state cache: every scan starts from zeros
    assert fwd["state"] == step["state"] == 0, (fwd, step)
    gb = lambda d: {k: round(v / 1e9, 4) for k, v in d.items()  # noqa: E731
                    if v}
    log(f"[lmsplit] ({item}) {arch} train_4k (L={res['layers']}, published "
        f"width, {res['params'] / 1e9:.3f} B parameters, b={b} of 256, s={s}"
        f" of 4096, {res['policy']}, n_micro {res['n_micro']}, remat "
        f"{res['remat']}) on "
        f"{mesh.shape}: fp32 split step vs unsplit within {TRAIN_SPLIT_TOL} "
        f"(AdamW eps {TRAIN_SPLIT_EPS}): loss {f32['loss']:.6f} / "
        f"{f32['loss_unsplit']:.6f}, grad_norm {f32['grad_norm']:.6f} / "
        f"{f32['grad_norm_unsplit']:.6f}, max|diff| gradients "
        f"{f32['grads_max_abs_diff']:.3e}, params "
        f"{f32['params_max_abs_diff']:.3e}, m {f32['m_max_abs_diff']:.3e}, "
        f"v {f32['v_max_abs_diff']:.3e}"
        + ("" if "u_misses_zero" not in f32 else
           f" (u drawn, N(0, 0.5^2): weights moved by a relative 1e-7 put "
           f"{f32['u_misses_drawn']} of layer 0's {f32['u_numel']} "
           f"u-gradient elements out of the tolerance of the unsplit step, "
           f"against "
           f"{f32['u_misses_zero']} from the init's u = 0)")
        + f" | bf16 step p50 to a sync split "
        f"{res['split_p50_ms']:.2f} ms, unsplit {res['unsplit_p50_ms']:.2f},"
        f" mesh-less {res['mesh_less_p50_ms']:.2f} (bound "
        f"{res['bound_ms']:.2f} by {res['bound_by']}) | ATen ops a step "
        f"{res['split_ops']}, {res['unsplit_ops']}, {res['mesh_less_ops']} "
        f"| GB between positions a split step {gb(step)}, the forward's "
        f"{gb(fwd)} | peak above the weights split "
        f"{res['split_peak_gib']:.2f} GiB, unsplit "
        f"{res['unsplit_peak_gib']:.2f}, mesh-less "
        f"{res['mesh_less_peak_gib']:.2f} | {res['seconds']:.1f} s"
        + ("" if "trace" not in res else
           f" | dry-run trace of the cell as cut ({res['trace']['trace_ops']}"
           f" ops, {res['trace']['trace_s']:.2f} s, 1 of "
           f"{res['trace']['rows']} batch rows run) equals one split step "
           f"on int32 tokens: busiest position {res['trace']['busiest']} "
           f"{res['trace']['busiest_bytes']} B "
           f"{res['trace']['busiest_by_kind']}")
        + f" | {card}")
    return res


def run_lm_split(torch, dev, card: str, early: dict) -> dict:
    """Phase 16: split weights (see the docstring). ``early`` holds (a)
    and (b), run inside phase 14 on its llama3-8b cells. Numbers also go
    to ``chiprun_out/lm_phase16.json``."""
    t_phase = time.perf_counter()
    mesh = lm_mesh(torch, dev)
    assert set(early) == {"bfloat16", "float32"}, early.keys()
    log(f"[lmsplit] phase 16 on a {mesh.shape} mesh of {mesh.size} "
        f"positions on {mesh.first_device}; (a) and (b) ran on phase 14 "
        f"(a)'s cells and caches before they were freed; cuts: (c) "
        f"prefill_32k b=32, s=32,768 -> b={LM_MESH_B}, s={LM_SPLIT_PROMPT}; "
        f"(d) {LM_SPLIT_MOE[0]} depth {LM_SPLIT_MOE[1]}/32, decode_32k b="
        f"128 -> {LM_MESH_B}, cache {LM_MESH_SEQ} slots; (e) reduced() "
        f"configs; (f) {', '.join(LM_SPLIT_RECURRENT)} decode_32k b=128 -> "
        f"{LM_MESH_B}, from a prefill of {LM_SPLIT_REC_PROMPT}; (g)-(j) "
        f"train_4k: "
        + "; ".join(f"({i}) {a} depth {n or 'all'}, b=256 -> {b}, s=4096 "
                    f"-> {s}" for i, a, n, b, s in LM_SPLIT_TRAIN))
    res = {"card": card, "decode": early,
           "prefill": lm_split_prefill(torch, dev, mesh, card),
           "moe": lm_split_moe(torch, dev, mesh, card)}
    res["small"] = {a: lm_split_small(torch, dev, mesh, a)
                    for a in LM_SPLIT_ARCHS}
    log(f"[lmsplit] (e) reduced fp32 prefill and decode cells, placed: "
        f"max|card-CPU| within {CPU_TOL}, max|split-mesh-less| on the "
        f"card within {MESH_DECODE_TOL}: "
        f"{ {a: (float(f'{x:.2e}'), float(f'{y:.2e}')) for a, (x, y) in res['small'].items()} } | {card}")
    res["recurrent"] = {a: lm_split_recurrent(torch, dev, mesh, a, card)
                        for a in LM_SPLIT_RECURRENT}
    res["train"] = {item: lm_split_train(torch, dev, mesh, item, arch,
                                         layers, b, s, card)
                    for item, arch, layers, b, s in LM_SPLIT_TRAIN}
    res["seconds"] = time.perf_counter() - t_phase
    path = ROOT / "chiprun_out" / "lm_phase16.json"
    path.parent.mkdir(exist_ok=True)
    path.write_text(json.dumps(res, indent=1))
    log(f"[lmsplit] phase 16 took {res['seconds']:.1f} s (and (a), (b) "
        f"{sum(early[d]['seconds'] for d in early):.1f} s inside phase 14) "
        f"| {card}")
    return res



def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} is missing; run from a "
              "checkout of the repository", file=sys.stderr)
        return 1

    # 1. device and settings
    card = nvidia_smi()
    log(f"[device] {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    dev = torch.device("cuda")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"{torch.cuda.get_device_name(0)} "
        f"capability {torch.cuda.get_device_capability(0)}")

    # 2. build
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    libs = _build.build_all()
    for name in libs:
        _build.library(name)
    log(f"[build] {len(libs)} libraries in {time.perf_counter() - t0:.1f} s "
        f"under {_build.build_dir().relative_to(ROOT)}")
    for name in libs:
        for line in (_build.build_dir() / f"{name}.log").read_text() \
                .splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    from repro_torch.configs import ctr_spec
    from repro_torch.data import CRITEO, sample_ids
    from repro_torch.embedding import FusedEmbeddingCollection

    # 3. kernels at the main path's shapes: the full-width d = 32 table
    # and the d = 1 wide/FM table of the same schema
    spec = ctr_spec("dcnv2", "criteo", embed_dim=32, hidden=1024)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    emb = FusedEmbeddingCollection(spec.embedding_spec(), device=dev)
    wide = FusedEmbeddingCollection(spec.wide_spec(), device=dev)
    emb.store.reset_parameters(gen)
    wide.store.reset_parameters(gen)
    rows = []
    record = recorder(rows)
    phase_kernels(torch, dev, emb.dense_view(), wide.dense_view(),
                  emb.offsets, CRITEO, sample_ids, record)
    phase_tiered_kernels(torch, dev, emb, CRITEO, sample_ids, record)
    phase_host_kernels(torch, dev, emb, CRITEO, sample_ids, record)
    phase_q8_kernels(torch, dev, record)
    phase_quantizer(torch, dev, record)
    launches = phase_lookup_variants(torch, dev, emb, CRITEO, sample_ids,
                                     record)
    del emb, wide
    torch.cuda.empty_cache()

    # 4. the main path, then 5. the other three models; each model's run
    # resets the launch counters just before it and reads them just after
    for name, batches, n_requests, gathers, kernel, per_step in (
            ("dcnv2", (256, 1024), 16, 1, "fused_cross_v2", 3),
            ("dcn", (256,), 24, 1, "fused_cross_v1", 3),
            ("deepfm", (256,), 24, 2, "fused_fm_second_order", 1),
            ("widedeep", (256,), 24, 2, None, 0)):
        spec_m = ctr_spec(name, "criteo", embed_dim=32, hidden=1024)
        counts, steps = run_model(torch, dev, name, spec_m, CRITEO,
                                  sample_ids, batches=batches,
                                  n_requests=n_requests)
        # DeepFM and Wide&Deep gather twice per step: d = 32 and d = 1
        assert counts["mtl_gather"] == gathers * steps, counts
        if name == "dcnv2":
            launches["mtl_gather"] = counts["mtl_gather"]
        if kernel is not None:
            assert counts[kernel] == per_step * steps, counts
            launches[kernel] = counts[kernel]

    # 6. the cached and host tiers (K3-K6) and store-level multi-hot (K2)
    launches.update(run_tiered(
        torch, dev, ctr_spec("dcnv2", "criteo", embed_dim=32, hidden=1024),
        CRITEO, sample_ids, batches=(256, 1024), n_requests=16))

    # 7. int8 dense compute (the quantizer + K12): the four models, then the
    # full int8 stack
    launches.update(run_int8_models(torch, dev, CRITEO, sample_ids))
    run_int8_stack(torch, dev,
                   ctr_spec("dcnv2", "criteo", embed_dim=32, hidden=1024),
                   CRITEO, sample_ids, batches=(256, 1024), n_requests=16)

    # 9. serving: the engine (sync, cached and host stores), the runtime
    # (shared pool and per-engine workers), the CLI; each run's counters
    # reset just before it and read just after
    run_serving(torch, dev, CRITEO, sample_ids)

    # 10. training: full-width DCNv2 (K1 and K9 under autograd), the four
    # models' gradients against the CPU (K10 and K11 too), each kernel's
    # Function against its plain version, resume
    for name, n in run_training(torch, dev, CRITEO, sample_ids).items():
        launches[name] += n

    # 11. multi-device: the mesh paths on every position of the card (or
    # one card a position), each run's counters reset just before it
    for name, n in run_mesh(torch, dev, CRITEO, sample_ids).items():
        launches[name] += n

    # 12. the LM zoo's serving path: ten archs at full width (no hand
    # kernel runs there)
    run_lm(torch, dev, card)

    # 13. LM training: the launcher's step at full width (no hand kernel)
    run_lm_train(torch, dev, card)

    # 14. the LM mesh and the cell builder: sequence-parallel decode on
    # four positions of the card, the train cell, meta traces (no hand
    # kernel); phase 16's (a) and (b) run on its llama3-8b cells
    split = {}
    run_lm_mesh(torch, dev, card, split)

    # 15. the analysis and the dry run: roofline records of six cells
    # from meta traces (host work, no hand kernel)
    run_dryrun(torch, card)

    # 16. split weights: serving cells with their parameters placed by
    # their specs on four positions of the card (no hand kernel)
    run_lm_split(torch, dev, card, split)

    # 8. summary
    lookup = "src/repro/kernels/multi_table_lookup.py"
    sources = {"mtl_gather": ("mtl_gather.cu", f"{lookup}:60",
                              "b=1024,k=39,d=32"),
               "mtl_gather_multihot": ("mtl_gather_tiered.cu",
                                       f"{lookup}:106",
                                       f"b=1024,k=39,d=32,h={HOT}"),
               "mtl_gather_two_level": ("mtl_gather_tiered.cu",
                                        f"{lookup}:164",
                                        "b=1024,k=39,d=32,h=1"),
               "mtl_gather_two_level_q8": ("mtl_gather_tiered.cu",
                                           f"{lookup}:241",
                                           "b=1024,k=39,d=32,h=1"),
               "mtl_gather_three_level": ("mtl_gather_tiered.cu",
                                          f"{lookup}:323",
                                          "b=1024,k=39,d=32,h=1"),
               "mtl_gather_three_level_q8": ("mtl_gather_tiered.cu",
                                             f"{lookup}:403",
                                             "b=1024,k=39,d=32,h=1"),
               "fused_cross_v2": ("fused_cross.cu",
                                  "src/repro/kernels/fused_cross.py:26",
                                  "b=1024,D=1248"),
               "fused_cross_v1": ("fused_cross.cu",
                                  "src/repro/kernels/fused_cross.py:48",
                                  "b=1024,D=1248"),
               "mtl_onehot": ("mtl_onehot.cu", f"{lookup}:472",
                              f"b=1024,k=18,n_pad={ONEHOT_PAD},d=32,"
                              "float32"),
               "mtl_input_first": ("mtl_input_first.cu", f"{lookup}:510",
                                   "b=1024,k=39,d=32"),
               "fused_fm_second_order": ("fused_fm.cu",
                                         "src/repro/kernels/fused_fm.py:31",
                                         "b=1024,k=39,d=32"),
               "dmm_q8": ("dense_matmul_q8.cu",
                          "src/repro/kernels/dense_matmul.py:42",
                          "b=1024,in=1248,out=1024"),
               "quantize_rows_q8": ("quantize_rows_q8.cu",
                                    "src/repro/quant.py:52,60 (jnp)",
                                    "b=1024,in=1248")}
    kernels = []
    for name, (src, replaces, shape) in sources.items():
        row = next(r for r in rows if r["name"] == name
                   and r["shape"] == shape)
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows
                               if r["name"] == name),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "shape": shape})
    for name, count in launches.items():
        assert count > 0, f"{name} never launched on its main path"
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
