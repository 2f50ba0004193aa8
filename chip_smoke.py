#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:

1. Device: require CUDA; print the card's name and power limit; turn TF32
   and reduced-precision half reductions off (the ``full`` policy means
   real f32, and the reference accumulates half products in f32).
2. Build: compile the hand-written kernels (the dense forward source, the
   dense backward source, the CP source, the order-shared source, the
   fused source, the RMSNorm source and the flash attention source, one
   ``nvcc`` each, started together) for ``sm_90a`` from the sources in
   this checkout; print each ptxas report.  ``dense_fwd`` and
   ``dense_bwd_x`` are one streaming design (``csrc/dense_stream.cuh``)
   that sums the weight over its input or its output channels.
3. Kernels vs plain: the dense forward kernel and its two backward
   kernels, the CP kernels ``cp_fwd`` and ``cp_bwd``, and the order-shared
   kernels ``ls_fwd``, ``ls_bwd_x`` and ``ls_bwd_w``, against their plain
   PyTorch versions on the card, at their path's shape and a ragged one,
   in the paths' three modes (CP and order-shared also at a width they
   refused before their channel tiling: I = O = R = 128, I = O = 192).
   Dense: within ``4ε·M + 32·ε_f32·M + 1e-5`` elementwise (ε of the
   format each output is stored at, M the contraction of |operands| it
   sums); the backward kernels' zeroed outputs are checked to exceed it.
   CP and order-shared (kernel and plain both sum in f32 from the same
   operands): within one rounding of
   the stored result, ``2ε/(1-ε)·|plain| + (1+ε)(32·ε_f32·M + 1e-5)``, a
   budget that every zeroed output is checked to exceed.  The fused
   kernels ``fused_fwd`` and ``fused_bwd`` at the Darcy path's shape,
   421x421, GINO_CAR's 3-d latent FNO (32³, modes 12³) and a ragged 1-d
   shape whose last axis keeps its Nyquist row, in five modes (f32, bf16,
   fp16, simulated fp8 e4m3 and e5m2): each output within the composed
   envelope budget (one ``4ε·M`` per requantising stage on either side, the
   f32 order term, M from ``fused_magnitude``) and, in the half modes,
   within 1/4 of the plain version's own gap to its answer with the
   quantisation skipped (relative L2); a zeroed output must fail one.
4. Darcy serving, staged path (``FNO_DARCY`` with ``fuse_spectral=False``
   on both devices, so kernel 1 keeps a path that this script drives)
   through ``OperatorEngine(max_batch=8)`` under ``mixed_fno_bf16`` and
   ``full``:
   16 GRF fields at 128x128 and 8 at 421x421, two rounds (the first warms
   cuFFT plans and cuBLAS).  Outputs finite and shaped; 8 kernel launches
   per micro-batch; a re-served field through a fresh engine bit-identical
   to its batched answer; one 128x128 field against the same weights run
   on the CPU.
5. Darcy training, staged path (``fuse_spectral=False``, kernels 1–3):
   32 Darcy pairs at 128x128 from the ported CG solver on the card;
   ``FNO_DARCY`` trained 12 steps in batches of 8 under the
   paper's schedule (``paper_default("bf16")``: 3 mixed, 6 AMP, 3 full).
   Losses finite and falling, the schedule followed, no skipped step, 8
   forward, 8 bwd_x and 8 bwd_w launches per step; a restore of the step-6
   checkpoint reruns step 7 bit-identically; one step's gradients on the
   card against the CPU; a 4-step fp16 run with its loss scale accounted.
5b. Darcy through the fused path, ``FNO_DARCY`` at its default config
   (fused on the card): served as in phase 4, 4 ``fused_fwd`` launches per
   micro-batch (one per layer, the corners gathered) and no dense launch,
   batched == solo, card vs CPU (the CPU told ``fuse_spectral=True``)
   within phase 4's limits; trained as in phase 5 on its Darcy pairs, 4
   ``fused_fwd`` and 4 ``fused_bwd`` launches per step (one batch tile of
   8) and no dense launch, the schedule, a falling loss, the step-6
   restore rerun, gradients card vs CPU (CPU fused) within phase 5's
   limits; then fused against staged, side by side, per resolution and
   policy.
6. TFNO serving: the paper's CP-factorised TFNO (``TFNO_NS``) served as in
   phase 4, NS forcings at 128x128 (16) and 256x256 (8): 8 ``cp_fwd``
   launches per micro-batch and no dense launch, batched == solo, card vs
   CPU on one 128x128 field; a Tucker-factorised TFNO_NS (the einsum path)
   answers one micro-batch, card vs CPU.
7. TFNO training: 32 Navier-Stokes pairs at 128x128 (T = 5, 512 steps)
   from the ported solver on the card; ``TFNO_NS`` trained 12 steps with
   the relative H¹ loss under ``paper_default("bf16")``, batch 8: 8
   ``cp_fwd`` and 8 ``cp_bwd`` launches per step, the schedule, a finite
   and falling loss, the step-6 restore rerun, one step's gradients card
   vs CPU; and the NS solver on 2 fields card vs CPU at three horizons.
8. SFNO: 32 shallow-water pairs at 256x512 (200 steps) from the ported
   solver on the card, and the solver card vs CPU on 2 fields at 50, 100
   and 200 steps; the paper's SFNO (``SFNO_SWE``) served through
   ``OperatorEngine(model="sfno", max_batch=8)`` on 16 of those initial
   fields as in phase 4 (4 ``ls_fwd`` launches per micro-batch, no dense
   or CP launch, batched == solo, card vs CPU); trained 12 steps with the
   relative L² loss under ``paper_default("bf16")``, batch 8: 4 + 4 + 4
   order-shared launches per step, the schedule, a falling loss, the
   step-6 restore rerun, one step's gradients card vs CPU on 2 fields.
   The SFNO's half policies run the tanh stabiliser, so their limits
   leave it out: the forward and each gradient leaf within half the
   card's own ``amp_bf16``-vs-``full`` gap.  Half, not a quarter: the
   card's FFT and GEMM libraries differ from the CPU's in the last bits
   everywhere, and through 4 layers of half roundings that alone moves
   the answer by ~0.3 of the gap (the CPU moves as far from itself when
   its input moves by one f32 ulp; the phase prints that spread).
8b. GINO: ``GINO_CAR`` at full width (226.5 M latent FNO parameters,
   random from a seed) on car batches of 4 from the device sampler (3586
   surface points a shape, the reference's k = 8 and radius 0.35), whose
   KNN equals the CPU's on 2 shapes; the forward under ``full``, fused
   (one ``fused_fwd`` launch per layer and batch tile of ``pick_block_b``
   rows, 2 tiles of 2 here, no dense launch; the CPU told
   ``fuse_spectral=True``)
   and staged (``fuse_spectral=False`` on both: 16 dense forward launches,
   4 corners a layer), card vs CPU within 1e-5 on 2 shapes; each shape
   alone against its batched answer (within 1e-6 under ``full``, a quarter
   of the batched run's gap to ``full`` under ``mixed_fno_bf16``; not bit
   for bit: cuBLAS picks its GEMM by the row count); one step's gradients card vs CPU under ``full``
   within 1e-4 per leaf on both paths (the staged one launches kernels 1–3
   at 3-D); 12 steps of ``examples.gino_car_cfd``'s loop (AdamW(lr=2e-3),
   ``mixed_fno_bf16``, fresh shapes each step): 8 ``fused_fwd`` and 8
   ``fused_bwd`` launches a step, losses finite and falling, ms a step,
   fields/s and peak memory; one step run twice from one state,
   bit-identical parameters (the decoder's gather has a sorted,
   deterministic backward on CUDA); a profiled step.
8c. The U-Net baseline: ``UNET_BASELINE`` on 8 Darcy fields at 128² (CG
   on the card), card vs CPU under ``full`` within 1e-5, then 30
   AdamW(lr=2e-3, no weight decay) steps under ``amp_bf16`` on the whole
   set, as ``benchmarks/bench_paper_tables.py`` trains it: losses finite,
   the last quarter's mean below the first (at that rate the loss spikes
   on the way down), ms a step, peak memory; the 30 steps run again from
   the same state give bit-identical losses and parameters (the
   convolutions' backward runs with cuDNN's deterministic algorithms).
8d. Auto-precision: ``FNO_DARCY`` at its default config (fused on the
   card) under a telemetry collector, which keeps every layer on the
   staged dense kernels.  Trained 16 steps on phase 5's Darcy pairs at
   128² with ``PrecisionSchedule.auto("full", grid_points=128²)`` and an
   ``AutoPrecisionController(interval=4)``: ``full+auto0`` for steps 0–7,
   ``full+auto1`` after the second update, every ``fno/layer<i>/spectral``
   group at bf16, one policy change, no overflow, finite losses; 8 launches
   of each dense kernel a step and no fused launch in each half.  The
   first step's telemetry against the CPU's forward of the same batch: one
   site set, equal n, overflow and underflow, amax within 1e-4 relative and
   qerr within 1e-4 · amax.  Served through ``OperatorEngine(autoprec=...,
   autoprec_every=4)``, 16 micro-batches of 8 GRF fields: ``full+auto1``
   with bf16 groups, 8 ``dense_fwd`` launches a micro-batch and no fused
   one, a field served alone bit-identical to its batched answer with
   telemetry on, and its answer no farther from ``full`` than
   ``mixed_fno_bf16``'s.  Then telemetry's cost: the median step and tick
   under one fixed policy, staged with telemetry on and off, and the
   default config (fused) with it off.
8e. The tuner: ``python -m repro_torch.tune tune`` on the card over its
   ``DEFAULT_KEYS`` (``FNO_DARCY``'s fused layer at 128² in bf16 and f32
   and at 421², ``GINO_CAR``'s latent layer, ``SFNO_SWE``'s order-shared
   layer in bf16 and f32), ``validate`` (every entry passes) and
   ``validate --perturb 2`` (every entry rejected); each key's heuristic
   and winning tiles, µs and GB/s beside the card's name and power limit.
   ``FNO_DARCY`` (fused) served 16 micro-batches of 8 at 128² under
   ``mixed_fno_bf16`` and trained 12 ``paper_default("bf16")`` steps with
   ``calibration_state=`` that state, each against the same run with no
   state: calibrated hits and no stale lookup, the fused launches
   following the winners' tiles, the served fields bit-identical, the
   losses finite and falling (their relative difference to the run
   without state printed) and step 0's gradients within phase 5's
   card-vs-CPU gates of the run without state.  A state with
   its ``kernel_version`` altered is served by the heuristic, bit for bit;
   a state seeded with batch tile 2 at 128² serves 16 fused launches a
   micro-batch, bit for bit, and trains within the same limits.
8f. Observability: ``FNO_DARCY`` (fused) trained 12 steps with
   ``TrainerConfig(obs=True)`` under a caller's span and served 16
   micro-batches of 8 at 128² with tracing on: the Chrome trace validates,
   one ``train/step`` and one ``train/data`` span per step under the
   caller's span, one ``serve/operator/batch`` span per micro-batch in
   its ``serve/tick``, ``repro_train_steps_total`` the steps, the fused
   calls counted in ``repro_kernels_calls_total`` equal to those made; 8
   auto-precision steps with obs on put the controller's demotions on
   the timeline with its ε budget.  The median step and tick with tracing
   on and off are printed (no gate); the run log and Chrome trace are
   written under ``build/``.
8g. Static analysis: ``repro_torch.analyze`` in this process on the card.
   The dtype-flow matrix (8 policies x FNO, TFNO and SFNO at the
   analyzer's tiny configs, staged and, for the dense FNO, fused, plus one
   ``Trainer`` step per policy and path) records every ATen op and kernel
   launch; the kernels pass runs every spectral family's launchers at the
   reference's and the paths' shapes, the launch recorder delegating to
   the real launches, and holds each plan's shared memory to the
   library's own export.  Then ``FNO_DARCY`` at full width under
   ``mixed_fno_bf16``, fused (the default) and staged
   (``fuse_spectral=False``): one ``OperatorEngine`` micro-batch of 8 at
   128² and one ``Trainer`` step on phase 5's pairs, each without and with
   the recorder.  Gates: no unsuppressed error; every
   ``fno/layer<i>/spectral/contract`` site of those runs carries
   ``fused_fwd`` (and in the step ``fused_bwd``) records rounding to bf16
   on the fused path, and the dense kernels' records on the staged one,
   backward ones attributed from the autograd engine's device thread;
   every plan equal to its export; the served fields, the loss and the
   stepped parameters bit-identical with and without the recorder.
9. Numbers: each kernel's time (CUDA graph of many launches, operands
   cycled through more than L2 holds) beside its bound (bytes at the HBM
   rate; half x half products at the bf16/fp16 tensor-core rate, the rest
   at the f32 CUDA-core rate; ``cp_fwd``'s bf16 rank-expand as the three
   exact bf16 products a term it runs on the tensor cores), its plain
   version's and one PyTorch call's on complex64 where one computes the
   same function; engine fields/s and ms per micro-batch per resolution;
   ms per training step, fields/s and peak memory per policy; profiler
   breakdowns of serving micro-batches and of a ``mixed_fno_bf16`` and a
   ``full`` training step of each model (the fused Darcy path too).  The
   fused kernels at 128² and 421² in their five modes are timed with CUDA
   events over 40 back-to-back launches (20 at 421² and at GINO_CAR's
   latent FNO, batch 4 at 32³ with modes 12³), not as a CUDA graph,
   beside their plain versions and the fused and the staged layer's
   forward and forward + backward at the same shape and policy; no single
   PyTorch call computes the fused layer, so their library time is null.

10. The LM pool's substrate kernels (no model calls them): their path is
   ``kernels.ops.rmsnorm`` at 32768 tokens of 960 and 6144 features
   (smollm-360m's and granite-34b's widths) and ``kernels.ops.
   flash_attention``, causal, at one 32k smollm-360m sequence (15 heads of
   64) and 8 of granite-34b's 48 heads of 128, each in bf16 and f32, with
   the launch counts set to 0 before and read after (one launch per call).
   Then each kernel against its plain version on the same inputs (RMSNorm:
   f32 1e-6 relative per element, half >= 99.9 % bit-equal and within one
   ulp; flash attention: f32 1e-5 relative L2, half within 1/4 of the
   plain version's gap to the causal oracle on 256 query rows), a zeroed
   output checked to fail (RMSNorm also rerun bit for bit), and each timed
   beside its bound, its plain version and ``F.rms_norm`` or ``F.scaled_
   dot_product_attention(is_causal=True)`` (the backend it took printed):
   RMSNorm and ``F.rms_norm`` as a CUDA graph (``ms``, ``library_ms``) and
   as back-to-back eager calls between CUDA events (``eager_ms``,
   ``library_eager_ms``: the wrapper's host path included), flash
   attention with CUDA events.

11. LM serving (no hand-written kernel on its path: the spectral, RMSNorm
   and flash launch counts are set to 0 before it and must read 0 after).
   smollm-360m at its full published width (32 layers, d 960, 15/5 heads
   of 64, d_ff 2560, vocab 49152, 362 M parameters), weights from a seeded
   CUDA generator, served by ``LMEngine(n_slots=8, max_len=1024)`` at
   chunk 8 under ``full`` and ``amp_bf16``: 16 seeded requests, prompts of
   32-512 tokens, 32 new tokens each, 12 greedy and 4 sampled (T 0.8,
   top-k 50, top-p 0.95).  Every logit finite.  Under ``full``: chunk 1
   against chunk 8 on the 4 shortest greedy prompts, one greedy request
   solo against batched, and a rerun of the whole traffic (generations and
   every logits row bit for bit) are gated; under ``amp_bf16`` the chunk
   agreement is printed, not gated (cuBLAS picks its GEMM by row count,
   so a chunk and a token may differ in the last bits and flip a
   near-tie).  One request (a 64-token prompt, 8 new tokens) on the card
   against the same weights on the CPU: equal tokens and per-step logits
   within 1e-4 relative L2 (f32 sum order).  Printed per policy, with the
   card's name and power limit: prefill and decode tokens/s (prompt tokens
   over the chunk ticks' time, generated tokens over the decode ticks'),
   ms per prefill and decode tick (host clock; a tick ends in the logits'
   copy to the host), peak ``max_memory_allocated`` (and the peak above
   what was allocated when the engine was built), and the profiled
   device idle share of one decode tick with all 8 slots decoding.  Then
   every other decoder arch's SMOKE config (MoE without capacity drops)
   against the CPU, decode against its forward, and engine chunk 1 == 4,
   and Whisper's SMOKE encode and 8 decode steps against the CPU, each
   within 1e-5 relative L2.

12. Paged LM serving (no hand-written kernel on its path either: the
   counts are set to 0 before it and must read 0 after).  Phase 11's
   seeded weights through ``PagedLMEngine(n_slots=8, max_len=1024,
   block_size=16)`` at chunk 8 (the default pool: 577 blocks).  (a) Phase
   11's traffic with prefix sharing off, under ``full`` and ``amp_bf16``:
   every per-step logits row and token bit-equal to ``LMEngine``'s in the
   same phase.  (b) 16 greedy requests of one seeded 256-token system
   prompt and 16-128 tokens of their own, 32 new tokens, sharing on:
   under ``full`` at least 8 prefix hits, at least 8 x 256 fewer prompt
   tokens than the dense engine, fewer peak live blocks than the same
   traffic holds unshared, the same tokens as ``LMEngine`` and per-step
   logits within 1e-5 relative L2; under ``amp_bf16`` the token agreement
   is printed.  (c) A running slot's block forked as a prefix entry would:
   one copy-on-write, generation and logits bit-equal to dense.  (d)
   Traffic (b) through ``AsyncServeFrontend`` with a 250 ms deadline: the
   same tokens as (b), its latency, TTFT, misses and jitter printed.  Block
   0 (the null block) untouched after each.  Printed per policy beside the
   card's name and power limit, paged against dense: the tick rates and
   times as in phase 11, peak memory and the engine's share, the pool's
   peak live blocks, the unshared peak and fragmentation, a profiled
   decode tick.  Then ``repro_torch.launch.serve_smoke`` on the card (its
   smoke configs): the three engines' stats in one line.

13. Distribution (``repro_torch.dist``, ``launch.steps``, the dry-runs) on
   a one-rank NCCL world (a file store) and ``make_debug_mesh(1, "cuda")``,
   a 1x1 ("data", "model") mesh.  (b) ``FNO_DARCY`` at 128², batch 8,
   ``mixed_fno_bf16``: 4 steps of ``build_fno_train_step`` on the mesh
   (parameters and moments DTensors, the gradients all-reduced over NCCL,
   the fused kernels launched on the local tensors) against the same step
   with ``mesh=None``: losses and parameters bit for bit; the fused
   kernels' launches of the mesh run counted into the kernels line; then
   one step with ``make_dp_allreduce``'s bf16 all-reduce: its first
   gradient, and every one, within 2^-8 relative L2 of the f32
   all-reduce's (and whether the reference's "< 1e-3" holds).  (c) ``LMEngine`` at smollm-360m's full
   width on the mesh, ``full``, 8 seeded greedy requests of 16 new tokens,
   against ``mesh=None``: the same tokens; the logits' largest difference,
   whether they are bit-equal, ms a decode tick of both.  (d) 4
   ``amp_bf16`` steps of ``build_train_step`` at smollm-360m, batch 2 x 512
   tokens, on the mesh and off it: bit for bit, the loss finite and lower
   after 4 steps.  (e) the dry-runs as niced subprocesses on the host's
   CPU (fake process groups of 256 and 512 ranks), started with the script
   so that they overlap every phase before this one, on half of the
   script's CPU cores (``cpu_split``; the timed phases run on the other
   half from the end of phase 2 on): smollm-360m's ``decode_32k``,
   ``prefill_32k`` and ``train_4k`` on both production meshes (the
   sequence-parallel cells the card machine's torch refused before the
   port's local folds), ``granite-moe-3b-a800m``'s and
   ``whisper-large-v3``'s ``train_4k`` on the 16x16 mesh, and
   ``repro_torch.launch.dryrun_fno --cell fno-darcy --mesh both``: one line
   a cell with its status, seconds and roofline (derived counts, not
   timings); a cell that is not ok fails the run.  (f)
   ``repro_torch.launch.parity`` on four gloo ranks on the same side cores: the
   MoE and Whisper train steps on a 2x2 mesh against one device (loss within
   1e-5 relative, every parameter within 1e-5 relative L2) and
   ``cross_entropy`` on vocabulary-sharded logits, on this machine's torch.

The line before the last is ``{"kernels": [...]}`` (twelve kernels); the
last is ``{"ok": true, "device": {...}}``.
"""
import contextlib
import dataclasses
import gc
import json
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SEED = 0
POLICIES = ("mixed_fno_bf16", "full")
RESOLUTIONS = ((128, 16), (421, 8))      # (grid, fields)
MAX_BATCH = 8
PATH_SHAPE = (8, 64, 64, 1024)           # (B, I, O, M) of every launch on the path
RAGGED_SHAPE = (3, 24, 40, 300)
#: (cast_to, out_dtype) of the kernels' three modes on the paths
MODES = ((None, torch.float32), (torch.bfloat16, torch.bfloat16),
         (torch.float16, torch.float16))
TRAIN_GRID, TRAIN_FIELDS, TRAIN_BATCH, TRAIN_STEPS = 128, 32, 8, 12
CG_MAXITER = 1000
#: (B, I, O, R, M) of every CP launch on the TFNO paths: TFNO_NS's 4 layers
#: x 2 corners of 42x42 modes, rank 64
CP_PATH_SHAPE = (8, 64, 64, 64, 42 * 42)
CP_RAGGED_SHAPE = (3, 24, 40, 17, 300)
#: operand dtypes of the CP kernels on the paths: full/amp, mixed_fno_bf16,
#: the fp16 family
CP_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
TFNO_RESOLUTIONS = ((128, 16), (256, 8))  # (grid, fields)
NS_T, NS_STEPS = 5.0, 512
#: (B, I, O, L, M) of every order-shared launch on the SFNO paths:
#: SFNO_SWE's 4 layers, hidden 64, lmax = mmax = 128
LS_PATH_SHAPE = (8, 64, 64, 128, 128)
LS_RAGGED_SHAPE = (3, 5, 7, 37, 29)
SWE_GRID, SWE_FIELDS, SWE_STEPS, SFNO_SERVE_FIELDS = (256, 512), 32, 200, 16
#: formerly refused widths, checked beside the path's shapes: the CP
#: kernels at I = O = R = 128, the order-shared ones at I = O = 192
CP_WIDE_SHAPE = (8, 128, 128, 128, 42 * 42)
LS_WIDE_SHAPE = (8, 192, 192, 64, 64)
#: the LM pool's RMSNorm shapes: 32k tokens at smollm-360m's and
#: granite-34b's d_model (src/repro/configs/smollm_360m.py:7-8,
#: granite_34b.py:7-8)
RMS_SHAPES = ((32768, 960), (32768, 6144))
#: the LM pool's causal flash attention shapes (tag, BH, S = Sk, D): one
#: smollm-360m sequence of prefill_32k (src/repro/configs/base.py:115),
#: 15 heads of 64; granite-34b's head dim 128 at 8 of its 48 heads (cut to
#: bound the script's time)
FLASH_SHAPES = (("smollm_360m", 15, 32768, 64), ("granite_34b_8_of_48_heads", 8, 32768, 128))
LM_DTYPES = (torch.bfloat16, torch.float32)
#: query rows of the flash oracle at 32k (the whole S x S oracle needs 64 GB)
FLASH_ORACLE_ROWS = 256
#: (B, I, O, spatial, modes) of the fused kernels' checks: the Darcy path
#: at 128² and 421², GINO_CAR's latent FNO, and a 1-d shape whose last axis
#: keeps its Nyquist row (m - 1 = S/2)
FUSED_SHAPES = ((8, 64, 64, (128, 128), (32, 32)), (8, 64, 64, (421, 421), (32, 32)),
                (2, 64, 64, (32, 32, 32), (12, 12, 12)), (3, 5, 7, (30,), (16,)))
#: (cast_to, sim_fmt) of the fused kernels' five modes: full/amp,
#: mixed_fno_bf16, the fp16 policies, sim_fp8_e4m3, sim_fp8_e5m2
FUSED_MODES = ((None, None), (torch.bfloat16, None), (torch.float16, None),
               (torch.float16, "fp8_e4m3"), (torch.float16, "fp8_e5m2"))
#: the policy each fused mode stands for, for the layer timings
FUSED_MODE_POLICY = {"f32": "full", "bf16": "mixed_fno_bf16", "fp16": "mixed_fno_fp16",
                     "fp8_e4m3": "sim_fp8_e4m3", "fp8_e5m2": "sim_fp8_e5m2"}
#: GINO_CAR's path: car batches of 4 from the device sampler, 3586 surface
#: points a shape (the order of Shape-Net Car's meshes), the reference's
#: k = 8 and radius 0.35; 12 steps of the example's loop
GINO_BATCH, GINO_POINTS, GINO_STEPS = 4, 3586, 12
#: the U-Net baseline: 8 Darcy fields at 128², 30 AdamW steps under amp_bf16
#: (the paper-table benchmark's count: at its lr of 2e-3 the loss spikes
#: over the first dozen steps, on the CPU too, and falls after)
UNET_FIELDS, UNET_GRID, UNET_STEPS = 8, 128, 30
#: auto-precision at FNO_DARCY, 128²: 16 training steps (controller interval
#: 4, patience 2: the update after step 7 demotes) and 16 served micro-batches
AUTOPREC_STEPS, AUTOPREC_BATCHES = 16, 16
#: the tuner's and the observability phases' served micro-batches of 8 at 128²,
#: and the batch tile of the tuner phase's seeded (not the heuristic's) state
TUNE_BATCHES, SEEDED_TILE = 16, 2
#: (B, I, O, spatial, modes, operand sets, launches timed) of the fused
#: kernels' timings: the Darcy path at 128² and 421², GINO_CAR's latent FNO
FUSED_TIMED = ((8, 64, 64, (128, 128), (32, 32), 4, 40),
               (8, 64, 64, (421, 421), (32, 32), 2, 20),
               (GINO_BATCH, 64, 64, (32, 32, 32), (12, 12, 12), 2, 20))
#: phase 11: smollm-360m at full width (src/repro/configs/smollm_360m.py:6-9)
#: served by LMEngine(n_slots=8, max_len=1024) under each policy: 16 seeded
#: requests, prompts of 32-512 tokens, 32 new tokens each; chunk 1 against
#: 8 on the 4 shortest greedy prompts; card against CPU on one request of
#: a 64-token prompt and 8 new tokens, per-step logits within f32 sum order
LM_ARCH, LM_POLICIES = "smollm-360m", ("full", "amp_bf16")
LM_SLOTS, LM_MAX_LEN, LM_REQUESTS, LM_NEW, LM_PROMPTS = 8, 1024, 16, 32, (32, 512)
LM_CHUNK_CHECK, LM_PARITY, LM_CARD_CPU_TOL = 4, (64, 8), 1e-4
#: the other decoder archs' and Whisper's SMOKE configs, card against CPU
#: and decode against forward, relative L2
LM_SMOKE_TOL = 1e-5
#: phase 12: PagedLMEngine at the same width, blocks of 16 rows (the default
#: pool: 8 x 64 + 64 + 1 = 577 blocks); traffic (b): 16 greedy requests of one
#: seeded 256-token system prompt (16 blocks) and 16-128 tokens of their own,
#: 32 new tokens each; the frontend's deadline
PAGED_BLOCK, PAGED_REQUESTS, PAGED_SYSTEM, PAGED_OWN, PAGED_NEW = 16, 16, 256, (16, 128), 32
PAGED_DEADLINE_MS = 250.0
#: phase 13: FNO_DARCY's data-parallel step (128², batch 8, mixed_fno_bf16, 4
#: steps); smollm-360m served on the mesh (8 greedy requests of 16-128 prompt
#: tokens, 16 new tokens each, full) and trained (4 amp_bf16 steps, batch
#: 2 x 512 tokens of data.tokens); the two dry-runs as subprocesses
DIST_FNO_POLICY, DIST_FNO_BATCH, DIST_FNO_STEPS = "mixed_fno_bf16", 8, 4
DIST_LM_REQUESTS, DIST_LM_NEW, DIST_LM_PROMPTS, DIST_LM_MAX_LEN = 8, 16, (16, 128), 256
DIST_TRAIN_BATCH, DIST_TRAIN_SEQ, DIST_TRAIN_STEPS, DIST_TRAIN_LR = 2, 512, 4, 1e-3
DIST_DRYRUNS = {
    "dryrun_lm": ("repro_torch.launch.dryrun", "--arch", "smollm-360m", "--shape", "decode_32k",
                  "--mesh", "both"),
    **{f"dryrun_lm_{shape.split('_')[0]}_{mesh}": (
        "repro_torch.launch.dryrun", "--arch", "smollm-360m", "--shape", shape, "--mesh", mesh)
       for shape in ("prefill_32k", "train_4k") for mesh in ("single", "multi")},
    **{f"dryrun_{name}_train": ("repro_torch.launch.dryrun", "--arch", arch, "--shape", "train_4k",
                                "--mesh", "single")
       for name, arch in (("moe", "granite-moe-3b-a800m"), ("whisper", "whisper-large-v3"))},
    "dryrun_fno": ("repro_torch.launch.dryrun_fno", "--cell", "fno-darcy", "--mesh", "both"),
}
#: the dry-runs start with the script (niced, on the host's CPU cores that
#: the timed phases leave them) and must be done this long after their start
DIST_DRYRUN_TIMEOUT = 900
#: phase 13(f): the four-rank parity checks and their time limit
DIST_PARITY = ("repro_torch.launch.parity", "--arch", "granite-moe-3b-a800m",
               "--arch", "whisper-large-v3")
DIST_PARITY_TIMEOUT = 400
#: bf16's unit roundoff: the compressed all-reduce's budget a gradient
BF16_UNIT_ROUNDOFF = 2.0 ** -8
#: every kernel's launch count on ``repro_torch.kernels.spectral_contract``
LAUNCH_COUNTERS = ("launches", "launches_bwd_x", "launches_bwd_w",
                   "launches_cp_fwd", "launches_cp_bwd", "launches_ls_fwd",
                   "launches_ls_bwd_x", "launches_ls_bwd_w", "launches_fused_fwd",
                   "launches_fused_bwd")
#: H100 SXM data sheet: HBM rate, f32 (non-tensor-core) peak, and the dense
#: bf16/fp16 tensor-core peak (half x half products summed in f32)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
HALF_FLOP_PER_S = 989e12


def emit(tag, **fields):
    print(json.dumps({"phase": tag, **fields}), flush=True)


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# -- phase 1 ------------------------------------------------------------------
def device_phase():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    card = smi.splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False
    emit("device", name=torch.cuda.get_device_name(0), smi=card,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda,
         allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
         bf16_reduced_reduction=torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction,
         fp16_reduced_reduction=torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction)
    return card


# -- phase 2 ------------------------------------------------------------------
def build_phase():
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(build.SOURCES)) as pool:
        built = list(pool.map(build.build, build.SOURCES))
    for lib, report in built:
        print(report.strip(), flush=True)
    emit("build", libraries=[str(lib.relative_to(ROOT)) for lib, _ in built],
         seconds=time.perf_counter() - t0)


# -- phase 3 ------------------------------------------------------------------
def operands(shape, seed):
    B, I, O, M = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = [0.5 * torch.randn(B, I, M, generator=g, device="cuda") for _ in range(2)]
    w = [0.5 * torch.randn(I, O, M, generator=g, device="cuda") for _ in range(2)]
    return x + w


def kernel_phase(sc):
    from repro_torch.core.precision import FORMAT_EPS, dtype_name
    from repro_torch.core.theory import contract_budget

    worst = 0.0
    for k, shape in enumerate((PATH_SHAPE, RAGGED_SHAPE)):
        ops = operands(shape, SEED + k)
        mag = sc.contract_magnitude(*ops)
        for cast_to, out_dtype in MODES:
            kr, ki = sc.spectral_contract_dense(*ops, cast_to=cast_to, out_dtype=out_dtype)
            torch.cuda.synchronize()
            pr, pi = sc.spectral_contract_plain(*ops, cast_to=cast_to, out_dtype=out_dtype)
            torch.cuda.synchronize()
            diff = torch.hypot(kr.float() - pr.float(), ki.float() - pi.float())
            budget = contract_budget(FORMAT_EPS[dtype_name(out_dtype)], mag)
            err, excess = diff.max().item(), (diff - budget).max().item()
            emit("kernel_vs_plain", shape=list(shape), cast_to=str(cast_to),
                 out_dtype=str(out_dtype), max_abs_err=err,
                 max_excess_over_budget=excess, ok=excess <= 0)
            if excess > 0:
                fail(f"kernel disagrees with its plain version at {shape} "
                     f"{cast_to}->{out_dtype}: exceeds the budget by {excess:.3e}")
            if shape == PATH_SHAPE:
                worst = max(worst, err)
    return worst


def cotangent(shape, dtype, seed):
    B, _, O, M = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [(0.5 * torch.randn(B, O, M, generator=g, device="cuda")).to(dtype)
            for _ in range(2)]


def bwd_magnitudes(xr, xi, wr, wi, gr, gi):
    """Σ_o |g||w| and Σ_b |x||g|: what each gradient's tolerance scales with."""
    absg = torch.hypot(gr.float(), gi.float())
    return (torch.einsum("bom,iom->bim", absg, torch.hypot(wr, wi)),
            torch.einsum("bim,bom->iom", torch.hypot(xr, xi), absg))


def backward_kernel_phase(sc):
    """dense_bwd_x and dense_bwd_w against their plain versions; returns
    each kernel's worst max-abs error at the path's shape.  A zeroed output
    must fall outside the budget, or the comparison could not see a wrong
    one."""
    from repro_torch.core.precision import FORMAT_EPS
    from repro_torch.core.theory import contract_budget

    worst = {"bwd_x": 0.0, "bwd_w": 0.0}
    for k, shape in enumerate((PATH_SHAPE, RAGGED_SHAPE)):
        ops = operands(shape, SEED + 10 + k)
        for cast_to, out_dtype in MODES:
            g = cotangent(shape, out_dtype, SEED + 20 + k)
            mags = bwd_magnitudes(*ops, *g)
            kernel = {"bwd_x": sc._launch_bwd_x(*g, ops[2], ops[3], cast_to),
                      "bwd_w": sc._launch_bwd_w(ops[0], ops[1], *g, cast_to)}
            torch.cuda.synchronize()
            plain = {"bwd_x": sc.spectral_contract_bwd_x_plain(*g, ops[2], ops[3], cast_to=cast_to),
                     "bwd_w": sc.spectral_contract_bwd_w_plain(ops[0], ops[1], *g, cast_to=cast_to)}
            torch.cuda.synchronize()
            for (name, (kr, ki)), mag in zip(kernel.items(), mags):
                pr, pi = plain[name]
                diff = torch.hypot(kr - pr, ki - pi)
                budget = contract_budget(FORMAT_EPS["float32"], mag)
                err, excess = diff.max().item(), (diff - budget).max().item()
                zero_excess = (torch.hypot(pr, pi) - budget).max().item()
                emit("kernel_vs_plain", kernel=name, shape=list(shape), cast_to=str(cast_to),
                     g_dtype=str(out_dtype), max_abs_err=err,
                     max_excess_over_budget=excess, zeroed_output_excess=zero_excess,
                     ok=excess <= 0 and zero_excess > 0)
                if excess > 0:
                    fail(f"{name} disagrees with its plain version at {shape} "
                         f"{cast_to}/{out_dtype}: exceeds the budget by {excess:.3e}")
                if zero_excess <= 0:
                    fail(f"{name} at {shape} {cast_to}/{out_dtype}: the budget would accept "
                         f"a zeroed output")
                if shape == PATH_SHAPE:
                    worst[name] = max(worst[name], err)
    return worst


def cp_operands(shape, dtype, seed):
    """x, U_i, U_o, W and a cotangent g of the CP contraction as re/im
    pairs at ``dtype`` on the card, scaled so the outputs are O(1)."""
    B, I, O, R, M = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    shapes = ((B, I, M), (I, R), (O, R), (R, M), (B, O, M))
    scales = (1.0, I ** -0.5, R ** -0.5, 1.0, 1.0)
    return [(s * torch.randn(*sh, generator=g, device="cuda")).to(dtype)
            for sh, s in zip(shapes, scales, strict=True) for _ in range(2)]


def cp_kernel_phase(sc):
    """cp_fwd and cp_bwd against their plain versions; returns each
    kernel's worst max-abs error at the path's shape.  Both sum in f32 from
    the same operands, so each output is held to one rounding at its dtype
    plus the f32 summation order (``store_budget``); a zeroed output must
    fall outside that budget, or the comparison could not see a wrong one."""
    from repro_torch.core.precision import FORMAT_EPS, dtype_name
    from repro_torch.core.theory import store_budget

    names = ("out", "out", "dx", "dx", "dU_i", "dU_i", "dU_o", "dU_o", "dW", "dW")
    worst = {"cp_fwd": 0.0, "cp_bwd": 0.0}
    for k, shape in enumerate((CP_PATH_SHAPE, CP_RAGGED_SHAPE, CP_WIDE_SHAPE)):
        for dtype in CP_DTYPES:
            ops = cp_operands(shape, dtype, SEED + 30 + k)
            got = (*sc._launch_cp_fwd(*ops[:8]), *sc._launch_cp_bwd(*ops))
            torch.cuda.synchronize()
            want = (*sc.spectral_contract_cp_plain(*ops[:8]),
                    *sc.spectral_contract_cp_bwd_plain(*ops))
            torch.cuda.synchronize()
            mags = sc.cp_magnitudes(*ops)
            eps = FORMAT_EPS[dtype_name(dtype)]
            errs, excess, zero_excess = {}, {}, {}
            for name, a, b in zip(names, got, want, strict=True):
                budget = store_budget(eps, b.float(), mags[name])
                diff = (a.float() - b.float()).abs()
                excess[name] = max(excess.get(name, -1e30), (diff - budget).max().item())
                zero_excess[name] = max(zero_excess.get(name, -1e30),
                                        (b.float().abs() - budget).max().item())
                errs[name] = max(errs.get(name, 0.0), diff.max().item())
            for kernel, keys in (("cp_fwd", ("out",)), ("cp_bwd", ("dx", "dU_i", "dU_o", "dW"))):
                ok = all(excess[n] <= 0 for n in keys)
                blind = [n for n in keys if zero_excess[n] <= 0]
                emit("kernel_vs_plain", kernel=kernel, shape=list(shape), dtype=str(dtype),
                     max_abs_err={n: errs[n] for n in keys},
                     max_excess_over_budget={n: excess[n] for n in keys},
                     zeroed_output_excess={n: zero_excess[n] for n in keys},
                     ok=ok and not blind)
                if not ok:
                    fail(f"{kernel} disagrees with its plain version at {shape} {dtype}: "
                         f"excess over budget {excess}")
                if blind:
                    fail(f"{kernel} at {shape} {dtype}: the budget would accept a zeroed {blind}")
                if shape == CP_PATH_SHAPE:
                    worst[kernel] = max(worst[kernel], *(errs[n] for n in keys))
    return worst


def ls_operands(shape, dtype, seed):
    """x, w and a cotangent g of the order-shared contraction as re/im
    pairs at ``dtype`` on the card, scaled so the outputs are O(1)."""
    B, I, O, L, M = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    shapes = ((B, I, L, M), (I, O, L), (B, O, L, M))
    scales = (1.0, I ** -0.5, 1.0)
    return [(s * torch.randn(*sh, generator=g, device="cuda")).to(dtype)
            for sh, s in zip(shapes, scales, strict=True) for _ in range(2)]


def ls_kernel_phase(sc):
    """ls_fwd, ls_bwd_x and ls_bwd_w against their plain versions, each
    result held to ``store_budget`` (one rounding at its dtype plus the f32
    order of its magnitude contraction: M = I for out, O for dx, B·M for
    dw), which a zeroed result must exceed; returns each kernel's worst
    max-abs error at the path's shape."""
    from repro_torch.core.precision import FORMAT_EPS, dtype_name
    from repro_torch.core.theory import store_budget

    kernels = {"ls_fwd": "out", "ls_bwd_x": "dx", "ls_bwd_w": "dw"}
    worst = dict.fromkeys(kernels, 0.0)
    for k, shape in enumerate((LS_PATH_SHAPE, LS_RAGGED_SHAPE, LS_WIDE_SHAPE)):
        for dtype in CP_DTYPES:
            xr, xi, wr, wi, gr, gi = ls_operands(shape, dtype, SEED + 40 + k)
            got = {"out": sc._launch_ls_fwd(xr, xi, wr, wi),
                   "dx": sc._launch_ls_bwd_x(gr, gi, wr, wi),
                   "dw": sc._launch_ls_bwd_w(xr, xi, gr, gi)}
            torch.cuda.synchronize()
            want = {"out": sc.spectral_contract_lshared_plain(xr, xi, wr, wi),
                    "dx": sc.spectral_contract_lshared_bwd_x_plain(gr, gi, wr, wi),
                    "dw": sc.spectral_contract_lshared_bwd_w_plain(xr, xi, gr, gi)}
            torch.cuda.synchronize()
            mags = sc.lshared_magnitudes(xr, xi, wr, wi, gr, gi)
            eps = FORMAT_EPS[dtype_name(dtype)]
            for kernel, name in kernels.items():
                err, excess, zero_excess = 0.0, -1e30, -1e30
                for a, b in zip(got[name], want[name], strict=True):
                    budget = store_budget(eps, b.float(), mags[name])
                    diff = (a.float() - b.float()).abs()
                    err = max(err, diff.max().item())
                    excess = max(excess, (diff - budget).max().item())
                    zero_excess = max(zero_excess, (b.float().abs() - budget).max().item())
                emit("kernel_vs_plain", kernel=kernel, shape=list(shape), dtype=str(dtype),
                     max_abs_err=err, max_excess_over_budget=excess,
                     zeroed_output_excess=zero_excess, ok=excess <= 0 < zero_excess)
                if excess > 0:
                    fail(f"{kernel} disagrees with its plain version at {shape} {dtype}: "
                         f"exceeds the budget by {excess:.3e}")
                if zero_excess <= 0:
                    fail(f"{kernel} at {shape} {dtype}: the budget would accept a zeroed "
                         f"{name}")
                if shape == LS_PATH_SHAPE:
                    worst[kernel] = max(worst[kernel], err)
    return worst


def mode_name(cast_to, sim_fmt):
    return sim_fmt or {None: "f32", torch.bfloat16: "bf16", torch.float16: "fp16"}[cast_to]


def fused_operands(shape, seed):
    """x, the gathered weight (scaled so y is O(1)) and a cotangent g of
    the fused layer on the card."""
    from repro_torch.kernels.spectral_contract import fused_rows

    B, I, O, spatial, modes = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    Mh = int(np.prod(fused_rows(spatial, modes)))
    x = torch.randn(B, I, *spatial, generator=g, device="cuda")
    w = [torch.randn(I, O, Mh, generator=g, device="cuda") / I for _ in range(2)]
    return x, *w, torch.randn(B, O, *spatial, generator=g, device="cuda")


def rel_l2_dev(a, b):
    """Relative L2 of two tensors on the card, in f64."""
    a, b = a.double(), b.double()
    return (torch.linalg.vector_norm(a - b) / (torch.linalg.vector_norm(b) + 1e-12)).item()


def fused_kernel_phase(sc):
    """fused_fwd and fused_bwd against their plain versions at
    ``FUSED_SHAPES`` in ``FUSED_MODES``; returns each kernel's worst
    max-abs error at the Darcy path's shape."""
    from repro_torch.core.precision import FORMAT_EPS, dtype_name
    from repro_torch.core.theory import contract_budget

    worst = {"fused_fwd": 0.0, "fused_bwd": 0.0}
    for k, shape in enumerate(FUSED_SHAPES):
        x, wgr, wgi, g = fused_operands(shape, SEED + 50 + k)
        modes = shape[-1]
        mags = sc.fused_magnitude(x, wgr, wgi, modes, g=g)
        mags = (mags["out"], mags["dx"], mags["dw"], mags["dw"])
        raw = (sc.spectral_fused_plain(x, wgr, wgi, modes),
               *sc.spectral_fused_bwd_plain(x, wgr, wgi, g, modes))
        for cast_to, sim_fmt in FUSED_MODES:
            got = (sc._launch_fused_fwd(x, wgr, wgi, modes, cast_to, sim_fmt),
                   *sc._launch_fused_bwd(x, wgr, wgi, g, modes, cast_to, sim_fmt))
            torch.cuda.synchronize()
            q = {"cast_to": cast_to, "sim_fmt": sim_fmt}
            want = (sc.spectral_fused_plain(x, wgr, wgi, modes, **q),
                    *sc.spectral_fused_bwd_plain(x, wgr, wgi, g, modes, **q))
            torch.cuda.synchronize()
            eps = FORMAT_EPS[sim_fmt or dtype_name(cast_to or torch.float32)]
            rows, ok, blind = {}, True, []
            for name, a, b, r, mag, stages in zip(("y", "dx", "dwr", "dwi"), got, want, raw,
                                                  mags, (2, 4, 4, 4), strict=True):
                budget = contract_budget(eps, mag, stages=stages)
                diff = (a.double() - b.double()).abs()
                row = {"max_abs_err": diff.max().item(), "stages": stages,
                       "excess_over_budget": (diff - budget).max().item(),
                       "zeroed_excess_over_budget": (b.double().abs() - budget).max().item()}
                ok &= row["excess_over_budget"] <= 0
                zero_fails = row["zeroed_excess_over_budget"] > 0
                if cast_to is not None:
                    gap = rel_l2_dev(b, r)
                    row.update(rel_l2=rel_l2_dev(a, b), rel_l2_limit=0.25 * gap,
                               rel_l2_excess=rel_l2_dev(a, b) - 0.25 * gap)
                    ok &= row["rel_l2_excess"] <= 0
                    zero_fails |= 1.0 > 0.25 * gap
                if not zero_fails:
                    blind.append(name)
                rows[name] = row
            emit("fused_kernel_vs_plain", shape=[shape[0], shape[1], shape[2], list(shape[3]),
                                                 list(modes)],
                 mode=mode_name(cast_to, sim_fmt), eps=eps, outputs=rows,
                 ok=ok and not blind)
            if not ok:
                fail(f"fused kernels disagree with their plain versions at {shape} "
                     f"{mode_name(cast_to, sim_fmt)}: {rows}")
            if blind:
                fail(f"fused kernels at {shape} {mode_name(cast_to, sim_fmt)}: the checks "
                     f"would accept a zeroed {blind}")
            if k == 0:
                worst["fused_fwd"] = max(worst["fused_fwd"], rows["y"]["max_abs_err"])
                worst["fused_bwd"] = max(worst["fused_bwd"],
                                         *(rows[n]["max_abs_err"] for n in ("dx", "dwr", "dwi")))
            del got, want
        del x, wgr, wgi, g, mags, raw
        torch.cuda.empty_cache()
    return worst


# -- phases 4 and 6: serving ---------------------------------------------------
def serve(engine, fields, uid0, times):
    """Submit ``fields`` and tick the engine dry, recording per tick the
    resolution, wall ms and peak device memory into ``times``."""
    from repro_torch.serve import FieldRequest

    reqs = [FieldRequest(uid=uid0 + i, x=x) for i, x in enumerate(fields)]
    for r in reqs:
        if not engine.submit(r):
            fail(f"request {r.uid} rejected: {r.error}")
    while engine.scheduler.depth:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        done = engine.tick()
        ms = (time.perf_counter() - t0) * 1e3
        times.append((done[0].resolution[0], len(done), ms,
                      torch.cuda.max_memory_allocated()))
    return reqs


def check_outputs(reqs, cfg):
    for r in reqs:
        want = (cfg.out_channels, *r.resolution)
        if r.status != "done" or r.y is None or r.y.shape != want:
            fail(f"request {r.uid}: status {r.status}, output "
                 f"{None if r.y is None else r.y.shape}, want {want}")
        if not np.isfinite(r.y).all():
            fail(f"request {r.uid}: non-finite output")


#: the kernels' names, as the profiler reports them
KERNEL_NAMES = ("dense_fwd_kernel", "dense_bwd_x_kernel", "dense_bwd_w_kernel",
                "cp_fwd_kernel", "cp_bwd_kernel", "ls_mix_kernel",
                "ls_bwd_w_kernel", "fused_fwd_kernel", "fused_bwd_kernel")


def profiled(fn):
    """Run ``fn`` under the profiler: wall ms (host clock, ending in a
    synchronise), device-busy ms, the spectral kernels' ms and the top
    kernels by device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        name = e.name
        if any(s in name for s in ("Activity Buffer", "Module Loading", "Function Loading")):
            continue
        by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values())
    spectral = {k: sum(v for n, v in by_name.items() if k in n) for k in KERNEL_NAMES}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    launched = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)
    return {"wall_ms": wall, "device_busy_ms": busy, "device_events": launched,
            "idle_share": max(0.0, 1.0 - busy / wall),
            "spectral_kernel_ms": {k: v for k, v in spectral.items() if v},
            "top": [[name[:90], ms] for name, ms in top]}


def profile_tick(engine, fields):
    """One micro-batch under the profiler."""
    from repro_torch.serve import FieldRequest

    for i, x in enumerate(fields):
        engine.submit(FieldRequest(uid=10_000 + i, x=x))
    return profiled(engine.tick)


def counts(sc):
    return {name: getattr(sc, name) for name in LAUNCH_COUNTERS}


def zero_counts(sc):
    for name in LAUNCH_COUNTERS:
        setattr(sc, name, 0)


def sfno_yardsticks(sc, net, net_cpu, x, y_full, y_mixed_cpu):
    """The SFNO's tanh-free yardstick for ``mixed_fno_bf16`` on one field
    ``x``: the card's own gap between ``amp_bf16`` and ``full`` (the limit
    is half of it); and, for the record, the CPU's own store gap (its
    answer without the contraction's half store) and its spread (its
    answer when its input moves by one f32 ulp), which says how far last-bit
    differences carry through the half roundings of the network."""
    from repro_torch.models import sfno_infer
    from repro_torch.precision import get_policy

    mixed = get_policy("mixed_fno_bf16")
    amp = sfno_infer(net, x, get_policy("amp_bf16")).cpu().numpy()[0]
    with no_store(sc):
        raw = sfno_infer(net_cpu, x, mixed, device="cpu").numpy()[0]
    signs = np.random.RandomState(SEED).choice([-1.0, 1.0], size=x.shape)
    moved = (x * (1 + 2.0 ** -23 * signs)).astype(np.float32)
    spread = sfno_infer(net_cpu, moved, mixed, device="cpu").numpy()[0]
    return {"amp_bf16_vs_full_rel_l2": rel_l2(amp, y_full),
            "cpu_store_gap_rel_l2": rel_l2(y_mixed_cpu, raw),
            "cpu_one_ulp_spread_rel_l2": rel_l2(spread, y_mixed_cpu)}


class no_store:
    """Within: the CPU's plain ``ls_fwd`` returns its f32 sums, the store of
    its result at the half dtype left out (the SFNO's store-gap yardstick)."""

    def __init__(self, sc):
        self.sc = sc

    def __enter__(self):
        self.plain = self.sc.spectral_contract_lshared_plain
        self.sc.spectral_contract_lshared_plain = lambda *a: self.plain(*(t.float() for t in a))

    def __exit__(self, *exc):
        self.sc.spectral_contract_lshared_plain = self.plain


def serve_model(sc, tag, cfg, net, net_cpu, fields, solo_picks, counter, model="fno"):
    """Serve ``fields`` ({grid: [field]}) through ``OperatorEngine`` under
    each policy, two rounds, then check launches, batched == solo and card
    vs CPU; ``counter`` names the one launch count the path must move (8
    per micro-batch for a staged FNO, one per corner and layer; 4 for an
    SFNO or a fused FNO, one per layer), every other count must stay at 0.
    Phases are emitted under ``tag`` + their name.  Returns the path's
    launches and the engine's numbers per (policy, grid)."""
    from repro_torch.models import fno_infer, sfno_infer
    from repro_torch.precision import get_policy
    from repro_torch.serve import OperatorEngine

    sfno = model == "sfno"
    per_layer = sfno or counter == "launches_fused_fwd"
    infer = sfno_infer if sfno else fno_infer
    per_batch = cfg.n_layers if per_layer else cfg.n_layers * 2 ** (cfg.ndim - 1)
    if per_batch != (4 if per_layer else 8):
        fail(f"{tag}model launches {per_batch} kernels per micro-batch, not the path's")
    grids = list(fields)
    zero_counts(sc)          # the serving path's run starts here
    ticks = 0
    served, stats, profiles = {}, {}, {}
    for pname in POLICIES:
        policy = get_policy(pname)
        engine = OperatorEngine(net, model=model, policy=policy, max_batch=MAX_BATCH)
        for rnd in range(2):
            times = []
            reqs = []
            for n in grids:
                reqs += serve(engine, fields[n], 1000 * rnd + n, times)
            ticks += len(times)
            check_outputs(reqs, cfg)
        served[pname] = {n: [r.y for r in reqs if r.resolution[0] == n] for n in grids}
        for n in grids:
            rows = [t for t in times if t[0] == n]
            ms = [t[2] for t in rows]
            stats[(pname, n)] = {
                "policy": pname, "grid": n, "micro_batches": len(rows),
                "fields": sum(t[1] for t in rows),
                "ms_per_micro_batch": ms,
                "fields_per_s": sum(t[1] for t in rows) / (sum(ms) / 1e3),
                "peak_mem_bytes": max(t[3] for t in rows)}
            prof = profile_tick(engine, fields[n][:MAX_BATCH])
            prof["idle_share_unprofiled"] = max(
                0.0, 1.0 - prof["device_busy_ms"] / float(np.median(ms)))
            profiles[(pname, n)] = prof
            ticks += 1
        # a re-served field through a fresh engine gives its batched answer
        for n, idx in solo_picks:
            solo = OperatorEngine(net, model=model, policy=policy, max_batch=MAX_BATCH)
            times = []
            (sr,) = serve(solo, [fields[n][idx]], 0, times)
            ticks += len(times)
            if not np.array_equal(sr.y, served[pname][n][idx]):
                fail(f"{tag}{pname} {n}x{n}: re-served field differs from its batched answer")
    launched = counts(sc)   # the serving path's run ends here
    launches = launched[counter]
    emit(f"{tag}launches", launches=launches, micro_batches=ticks,
         per_micro_batch=launches / ticks, counts=launched)
    if launches != per_batch * ticks:
        fail(f"{tag}{launches} kernel launches for {ticks} micro-batches, want {per_batch} each")
    if any(v for k, v in launched.items() if k != counter):
        fail(f"{tag}serving launched other kernels than {counter}: {launched}")

    for key in stats:
        emit(f"{tag}engine", **stats[key])
    for (pname, n), prof in profiles.items():
        emit(f"{tag}profile", policy=pname, grid=n, **prof)

    # the card against the CPU plain path, same weights, one field
    n, idx = solo_picks[0]
    x = fields[n][idx][None]
    parity, y_cpu = {}, {}
    for pname in POLICIES:
        y_cpu[pname] = infer(net_cpu, x, get_policy(pname), device="cpu").numpy()[0]
        parity[pname] = rel_l2(served[pname][n][idx], y_cpu[pname])
    precision_err = rel_l2(served["mixed_fno_bf16"][n][idx], served["full"][n][idx])
    limits = {"full": 1e-5, "mixed_fno_bf16": 0.25 * precision_err}
    sfno_yard = {}
    if sfno:
        sfno_yard = sfno_yardsticks(sc, net, net_cpu, x, served["full"][n][idx],
                                    y_cpu["mixed_fno_bf16"])
        limits["mixed_fno_bf16"] = 0.5 * sfno_yard["amp_bf16_vs_full_rel_l2"]
    emit(f"{tag}card_vs_cpu", rel_l2=parity, limits=limits,
         mixed_vs_full_rel_l2=precision_err, **sfno_yard)
    for pname in POLICIES:
        if not parity[pname] <= limits[pname]:
            fail(f"{tag}{pname}: card vs CPU relative L2 {parity[pname]:.3e} "
                 f"> {limits[pname]:.3e}")
    return launches, stats


def darcy_fields():
    """The Darcy serving inputs: GRF fields per resolution, host arrays."""
    from repro_torch.data import grf_2d

    return {n: list(grf_2d(torch.Generator().manual_seed(n), n, batch=count).numpy()[:, None])
            for n, count in RESOLUTIONS}


def serve_phase(sc, fused=False):
    """FNO_DARCY served on the staged path (``fuse_spectral=False`` on both
    devices) or, with ``fused``, at its default config, fused on the card,
    against the CPU told ``fuse_spectral=True``.  Returns the path's
    launches and the engine's numbers."""
    import dataclasses

    from repro_torch.configs.fno_paper import FNO_DARCY
    from repro_torch.models import init_fno, param_count

    tag = "fused_" if fused else ""
    cfg = FNO_DARCY if fused else dataclasses.replace(FNO_DARCY, fuse_spectral=False)
    cpu_cfg = dataclasses.replace(FNO_DARCY, fuse_spectral=True) if fused else cfg
    t0 = time.perf_counter()
    net = init_fno(torch.Generator().manual_seed(SEED), cfg)
    net_cpu = init_fno(torch.Generator().manual_seed(SEED), cpu_cfg, device="cpu")
    fields = darcy_fields()
    emit(f"{tag}setup", params=param_count(net), fuse_spectral=cfg.fuse_spectral,
         seconds=time.perf_counter() - t0)
    return serve_model(sc, tag, cfg, net, net_cpu, fields, ((128, 5), (421, 3)),
                       "launches_fused_fwd" if fused else "launches")


def ns_forcing(n, count):
    """NS forcings f ~ N(0, 27(-Δ+9I)^{-4}) (the TFNO's inputs), (count,
    1, n, n) host arrays from a CPU generator."""
    from repro_torch.data import grf_2d

    f = grf_2d(torch.Generator().manual_seed(n), n, alpha=4.0, tau=3.0,
               sigma=27.0 ** 0.5, batch=count)
    return list(f.numpy()[:, None])


def tfno_serve_phase(sc):
    from repro_torch.configs.fno_paper import TFNO_NS
    from repro_torch.models import init_fno, param_count

    t0 = time.perf_counter()
    net = init_fno(torch.Generator().manual_seed(SEED + 2), TFNO_NS)
    net_cpu = init_fno(torch.Generator().manual_seed(SEED + 2), TFNO_NS, device="cpu")
    fields = {n: ns_forcing(n, count) for n, count in TFNO_RESOLUTIONS}
    emit("tfno_setup", params=param_count(net), seconds=time.perf_counter() - t0)
    launches, _ = serve_model(sc, "tfno_", TFNO_NS, net, net_cpu, fields,
                              ((128, 5), (256, 3)), "launches_cp_fwd")
    tucker_parity(fields[128][:MAX_BATCH])
    return launches


def tucker_parity(fields):
    """A Tucker-factorised TFNO_NS (the memory-greedy einsum path, no
    kernel) answers one micro-batch on the card and on the CPU: relative
    L2 within 1e-5 under full and 1/4 of the card's own mixed-vs-full
    error under mixed_fno_bf16."""
    import dataclasses

    from repro_torch.configs.fno_paper import TFNO_NS
    from repro_torch.models import fno_infer, init_fno
    from repro_torch.precision import get_policy

    cfg = dataclasses.replace(TFNO_NS, factorization="tucker")
    x = np.stack(fields)
    y = {}
    for dev in ("cuda", "cpu"):
        net = init_fno(torch.Generator().manual_seed(SEED + 5), cfg, device=dev)
        for pname in POLICIES:
            y[(dev, pname)] = fno_infer(net, x, get_policy(pname), device=dev).cpu().numpy()
    err = {p: rel_l2(y[("cuda", p)], y[("cpu", p)]) for p in POLICIES}
    gap = rel_l2(y[("cuda", "mixed_fno_bf16")], y[("cuda", "full")])
    limits = {"full": 1e-5, "mixed_fno_bf16": 0.25 * gap}
    emit("tucker_card_vs_cpu", fields=len(fields), grid=x.shape[-1], rel_l2=err,
         limits=limits, mixed_vs_full_rel_l2=gap)
    for p in POLICIES:
        if not (np.isfinite(y[("cuda", p)]).all() and err[p] <= limits[p]):
            fail(f"Tucker TFNO {p}: card vs CPU relative L2 {err[p]:.3e} > {limits[p]:.3e}")


# -- phases 5 and 7: training --------------------------------------------------
def darcy_data():
    """32 Darcy pairs at 128x128 from the ported CG solver on the card, as
    host numpy arrays, and each field's final relative residual
    ``‖1 − A u‖/‖1‖`` recomputed from the unwhitened solution."""
    from repro_torch.data import darcy_matvec, sample_darcy_batch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    a, u = sample_darcy_batch(torch.Generator().manual_seed(SEED), TRAIN_GRID,
                              TRAIN_FIELDS, maxiter=CG_MAXITER)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    a_raw, u_raw = a[:, 0] * 4.5 + 7.5, u[:, 0] * 5e-3 + 5e-3
    r = 1.0 - darcy_matvec(a_raw, u_raw)
    resid = (torch.linalg.vector_norm(r, dim=(-2, -1)) / TRAIN_GRID).cpu().numpy()
    if not (torch.isfinite(a).all() and torch.isfinite(u).all()):
        fail("non-finite Darcy data")
    emit("darcy_data", fields=TRAIN_FIELDS, grid=TRAIN_GRID, cg_maxiter=CG_MAXITER,
         seconds=seconds, worst_rel_residual=float(resid.max()),
         median_rel_residual=float(np.median(resid)))
    return {"a": a.cpu().numpy(), "u": u.cpu().numpy()}


def ns_data():
    """32 Navier-Stokes pairs (forcing, ω(T)) at 128x128 from the ported
    solver on the card, T = 5 in 512 steps, as host numpy arrays."""
    from repro_torch.data import sample_ns_batch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    f, w = sample_ns_batch(torch.Generator().manual_seed(SEED + 3), TRAIN_GRID, TRAIN_FIELDS,
                           T=NS_T, steps=NS_STEPS)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if not (torch.isfinite(f).all() and torch.isfinite(w).all()):
        fail("non-finite Navier-Stokes data")
    f_std, w_std = float(f.std()), float(w.std())
    emit("ns_data", fields=TRAIN_FIELDS, grid=TRAIN_GRID, T=NS_T, steps=NS_STEPS,
         seconds=seconds, forcing_std=f_std, vorticity_std=w_std,
         vorticity_max_abs=float(w.abs().max()))
    # both channels whitened to O(1), the standard neuraloperator
    # preprocessing (the raw fields are ~1e-4)
    return {"a": (f / f_std).cpu().numpy(), "u": (w / w_std).cpu().numpy()}


def ns_solver_parity():
    """The NS solver on 2 forcings, card vs CPU, at three horizons of the
    same time step (T = 1.25, 2.5, 5 in 128, 256, 512 steps).  The flow is
    nonlinear, so cuFFT's and pocketfft's last bits grow with the horizon:
    the growth is recorded, and the full horizon is held to 1e-3 relative
    L2 (the solver at 128 steps reads ~1e-6 in the CPU tests; 1e-3 leaves
    a thousandfold growth and is still 1000x below the O(1) relative
    change a wrong solver makes)."""
    from repro_torch.data import solve_ns_vorticity

    f = torch.stack([torch.from_numpy(a[0]) for a in ns_forcing(TRAIN_GRID, 2)])
    growth = {}
    for steps in (NS_STEPS // 4, NS_STEPS // 2, NS_STEPS):
        T = NS_T * steps / NS_STEPS
        got = solve_ns_vorticity(f.cuda(), TRAIN_GRID, T=T, steps=steps).cpu().numpy()
        want = solve_ns_vorticity(f, TRAIN_GRID, T=T, steps=steps).numpy()
        growth[steps] = rel_l2(got, want)
    emit("ns_solver_card_vs_cpu", fields=2, grid=TRAIN_GRID, rel_l2_by_steps=growth,
         limit=1e-3)
    if not growth[NS_STEPS] <= 1e-3:
        fail(f"NS solver card vs CPU relative L2 {growth[NS_STEPS]:.3e} > 1e-3")


def loss_l2(model, batch, policy):
    from repro_torch.models import fno_apply
    from repro_torch.train import relative_l2

    return relative_l2(fno_apply(model, batch["a"], policy), batch["u"])


def loss_h1(model, batch, policy):
    from repro_torch.models import fno_apply
    from repro_torch.train import relative_h1

    return relative_h1(fno_apply(model, batch["a"], policy), batch["u"])


def leaf_grads(loss_fn, model, batch, policy):
    loss = loss_fn(model, batch, policy)
    names = [k for k, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()])
    return {k: g.detach().cpu().numpy() for k, g in zip(names, grads)}


def grad_parity(tag, loss_fn, net_cpu, data, yard="mixed_fno_bf16", share=0.25, cpu_net=None):
    """One step's gradients on the card against the CPU, same weights and
    2 fields of ``data``.  Limits per leaf: 1e-4 relative L2 under full;
    under mixed_fno_bf16 ``share`` of the card's own gradient gap between
    the ``yard`` policy and full (a quarter of mixed_fno_bf16's own for an
    FNO; half of amp_bf16's, which leaves the tanh out, for an SFNO).
    ``cpu_net``, where given, is the CPU's model (the same weights under
    another config); the card runs ``net_cpu``'s."""
    import copy

    from repro_torch.precision import get_policy

    net_gpu = copy.deepcopy(net_cpu).cuda()
    net_cpu = cpu_net or net_cpu
    batch = {k: torch.from_numpy(v[:2]) for k, v in data.items()}
    got, gap, limits = {}, {}, {}
    g = {}
    for pname in dict.fromkeys(("full", "mixed_fno_bf16", yard)):
        g[("cuda", pname)] = leaf_grads(loss_fn, net_gpu,
                                        {k: v.cuda() for k, v in batch.items()},
                                        get_policy(pname))
    for pname in ("full", "mixed_fno_bf16"):
        g[("cpu", pname)] = leaf_grads(loss_fn, net_cpu, batch, get_policy(pname))
    for pname in ("full", "mixed_fno_bf16"):
        for leaf, want in g[("cpu", pname)].items():
            err = rel_l2(g[("cuda", pname)][leaf], want)
            if pname == "full":
                limit = 1e-4
            else:
                gap[leaf] = rel_l2(g[("cuda", yard)][leaf], g[("cuda", "full")][leaf])
                limit = share * gap[leaf]
            got[f"{pname}/{leaf}"] = err
            limits[f"{pname}/{leaf}"] = limit
    emit(f"{tag}train_grad_card_vs_cpu", rel_l2=got, limits=limits,
         **{f"{yard}_vs_full_gap": gap})
    for key, err in got.items():
        if not err <= limits[key]:
            fail(f"{tag}{key}: card vs CPU gradient relative L2 {err:.3e} > {limits[key]:.3e}")


def train_model(sc, tag, cfg, data, loss_fn, seed, path_counters, sfno=False, cpu_cfg=None):
    """Train ``cfg`` 12 steps on ``data`` under ``paper_default("bf16")``
    and check it (launches of ``path_counters``, each once per layer and
    corner per step (an SFNO layer has no corners, a fused layer gathers
    them), and no other; schedule; falling loss; the step-6 restore rerun;
    gradients card vs CPU, the CPU under ``cpu_cfg`` where given); profile
    one step per policy.  Returns the path's launches, the CPU model, the
    loader and the numbers per policy."""
    from repro_torch.core.schedule import PrecisionSchedule
    from repro_torch.data import CachedDataset
    from repro_torch.models import FNO, init_fno, init_sfno
    from repro_torch.train import Trainer, TrainerConfig

    per_layer = sfno or "launches_fused_fwd" in path_counters
    per_step = cfg.n_layers if per_layer else cfg.n_layers * 2 ** (cfg.ndim - 1)
    loader = CachedDataset(data, TRAIN_BATCH, seed=SEED)
    net_cpu = (init_sfno if sfno else init_fno)(torch.Generator().manual_seed(seed), cfg,
                                                device="cpu")
    schedule = PrecisionSchedule.paper_default("bf16")
    want = [schedule.policy_at(s, TRAIN_STEPS).name for s in range(TRAIN_STEPS)]
    if want != ["mixed_fno_bf16"] * 3 + ["amp_bf16"] * 6 + ["full"] * 3:
        fail(f"unexpected schedule {want}")
    peaks = {}

    def batch_fn(step):
        # the previous step's peak, then a fresh window for this step
        if step - 1 not in peaks and step > 0:
            peaks[step - 1] = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        return loader.batch_at(step)

    with tempfile.TemporaryDirectory() as ckpt:
        tcfg = TrainerConfig(total_steps=TRAIN_STEPS, schedule=schedule, ckpt_dir=ckpt,
                             ckpt_every=6, keep_last_k=3)
        trainer = Trainer(loss_fn, net_cpu, tcfg)
        zero_counts(sc)                                    # the main run starts
        trainer.run(batch_fn, steps=7)
        # on the host, so the snapshot does not count in later steps' peaks
        after7 = {k: p.detach().cpu() for k, p in trainer.params.items()}
        trainer.run(batch_fn)
        torch.cuda.synchronize()
        launched = counts(sc)                              # the main run ends
        peaks[TRAIN_STEPS - 1] = torch.cuda.max_memory_allocated()
        hist = trainer.history
        emit(f"{tag}train_launches", steps=len(hist), launches=launched,
             per_step={k: v / len(hist) for k, v in launched.items()})
        for name, n in launched.items():
            expect = per_step * TRAIN_STEPS if name in path_counters else 0
            if n != expect:
                fail(f"{tag}{name}: {n} launches in {TRAIN_STEPS} steps, want {expect}")
        losses = [h["loss"] for h in hist]
        if [h["policy"] for h in hist] != want:
            fail(f"{tag}policies {[h['policy'] for h in hist]} do not follow {want}")
        if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
            fail(f"{tag}losses not finite and falling: {losses}")
        if trainer.stats["skipped_steps"]:
            fail(f"{tag}{trainer.stats['skipped_steps']} skipped steps under bf16")

        # the step-6 checkpoint, restored into a fresh trainer, reruns step 7
        resumed = Trainer(loss_fn, net_cpu, tcfg)
        if not resumed.restore(step=6) or resumed.step != 6:
            fail(f"{tag}the step-6 checkpoint did not restore")
        resumed.run(batch_fn, steps=7)
        torch.cuda.synchronize()
        differ = [k for k, p in after7.items()
                  if not torch.equal(p, resumed.params[k].detach().cpu())]
        emit(f"{tag}train_restore", restored_step=6, rerun_step=7, bit_identical=not differ,
             differing_leaves=differ)
        if differ:
            fail(f"{tag}step 7 after restoring step 6 differs in {differ}")

    steps = [{"step": h["step"], "policy": h["policy"], "loss": h["loss"],
              "ms": h["dt"] * 1e3, "fields_per_s": TRAIN_BATCH / h["dt"],
              "peak_mem_bytes": peaks.get(h["step"])} for h in hist]
    for row in steps:
        emit(f"{tag}train_step", **row)
    by_policy = {}
    for pname in ("mixed_fno_bf16", "amp_bf16", "full"):
        rows = [r for r in steps if r["policy"] == pname and r["step"] > 0]
        ms = float(np.median([r["ms"] for r in rows]))
        by_policy[pname] = {"steps": len(rows), "median_ms_per_step": ms,
                            "fields_per_s": TRAIN_BATCH / (ms / 1e3),
                            "peak_mem_bytes": max(r["peak_mem_bytes"] for r in rows)}
        emit(f"{tag}train_policy", policy=pname, **by_policy[pname])

    if sfno:
        grad_parity(tag, loss_fn, net_cpu, data, "amp_bf16", 0.5)
    else:
        twin = None
        if cpu_cfg is not None:
            twin = FNO(cpu_cfg)
            twin.load_state_dict(net_cpu.state_dict())
        grad_parity(tag, loss_fn, net_cpu, data, cpu_net=twin)

    # one profiled step per policy, after a warm step
    for pname in ("mixed_fno_bf16", "full"):
        tt = Trainer(loss_fn, net_cpu, TrainerConfig(
            total_steps=2, schedule=PrecisionSchedule.constant(pname)))
        tt.run(loader.batch_at, steps=1)
        prof = profiled(lambda: tt.run(loader.batch_at, steps=2))
        prof["step_ms_unprofiled"] = by_policy[pname]["median_ms_per_step"]
        prof["idle_share_unprofiled"] = max(
            0.0, 1.0 - prof["device_busy_ms"] / prof["step_ms_unprofiled"])
        emit(f"{tag}train_profile", policy=pname, **prof)
    return {k: launched[k] for k in path_counters}, net_cpu, loader, by_policy


def train_phase(sc):
    """The Darcy training slice on the staged path (``fuse_spectral=False``,
    kernels 1–3); returns the launches of each kernel in the main run, the
    Darcy pairs and the numbers per policy."""
    import dataclasses

    from repro_torch.configs.fno_paper import FNO_DARCY
    from repro_torch.core.schedule import PrecisionSchedule
    from repro_torch.train import Trainer, TrainerConfig

    data = darcy_data()
    launched, net_cpu, loader, by_policy = train_model(
        sc, "", dataclasses.replace(FNO_DARCY, fuse_spectral=False), data, loss_l2, SEED + 1,
        ("launches", "launches_bwd_x", "launches_bwd_w"))

    # a short fp16 run: the loss scale stays finite and every skipped step
    # halved it once
    fp16 = Trainer(loss_l2, net_cpu, TrainerConfig(
        total_steps=4, schedule=PrecisionSchedule.paper_default("fp16")))
    fp16.run(loader.batch_at)
    scale = float(fp16.scale_state.scale)
    skipped = sum(not h["finite"] for h in fp16.history)
    emit("train_fp16", policies=[h["policy"] for h in fp16.history],
         losses=[h["loss"] for h in fp16.history], loss_scale=scale,
         skipped_steps=fp16.stats["skipped_steps"])
    if not np.isfinite(scale) or fp16.stats["skipped_steps"] != skipped or \
            scale != 2.0 ** 15 * 0.5 ** skipped:
        fail(f"fp16 run: scale {scale}, skipped {fp16.stats['skipped_steps']} "
             f"vs {skipped} non-finite steps")
    return ({"fwd": launched["launches"], "bwd_x": launched["launches_bwd_x"],
             "bwd_w": launched["launches_bwd_w"]}, data, by_policy)


def fused_train_phase(sc, data):
    """FNO_DARCY at its default config (fused on the card) trained on the
    phase-5 Darcy pairs, gradients against the CPU told
    ``fuse_spectral=True``; returns the launches of each fused kernel in
    the main run and the numbers per policy."""
    import dataclasses

    from repro_torch.configs.fno_paper import FNO_DARCY

    launched, _, _, by_policy = train_model(
        sc, "fused_", FNO_DARCY, data, loss_l2, SEED + 1,
        ("launches_fused_fwd", "launches_fused_bwd"),
        cpu_cfg=dataclasses.replace(FNO_DARCY, fuse_spectral=True))
    return ({"fused_fwd": launched["launches_fused_fwd"],
             "fused_bwd": launched["launches_fused_bwd"]}, by_policy)


def fused_vs_staged(serve_stats, train_stats):
    """Fused against staged, side by side: per policy and resolution the
    median ms per micro-batch, fields/s and peak memory of serving; per
    policy the median ms per step, fields/s and peak memory of training."""
    for key, staged in serve_stats["staged"].items():
        fused = serve_stats["fused"][key]
        row = {}
        for name, st in (("staged", staged), ("fused", fused)):
            ms = float(np.median(st["ms_per_micro_batch"]))
            row[name] = {"median_ms_per_micro_batch": ms, "fields_per_s": st["fields_per_s"],
                         "peak_mem_bytes": st["peak_mem_bytes"]}
        row["speedup"] = row["staged"]["median_ms_per_micro_batch"] / \
            row["fused"]["median_ms_per_micro_batch"]
        emit("fused_vs_staged_serve", policy=key[0], grid=key[1], **row)
    for pname, staged in train_stats["staged"].items():
        fused = train_stats["fused"][pname]
        emit("fused_vs_staged_train", policy=pname, staged=staged, fused=fused,
             speedup=staged["median_ms_per_step"] / fused["median_ms_per_step"])


def tfno_train_phase(sc):
    """The TFNO training slice on ported Navier-Stokes data; returns the
    launches of each CP kernel in the main run."""
    from repro_torch.configs.fno_paper import TFNO_NS

    data = ns_data()
    launched, _, _, _ = train_model(sc, "tfno_", TFNO_NS, data, loss_h1, SEED + 4,
                                    ("launches_cp_fwd", "launches_cp_bwd"))
    ns_solver_parity()
    return {"cp_fwd": launched["launches_cp_fwd"], "cp_bwd": launched["launches_cp_bwd"]}


# -- phase 8: the SFNO -----------------------------------------------------------
def swe_data():
    """32 shallow-water pairs at 256x512 (200 steps) from the ported solver
    on the card, as host numpy arrays ``{"a": x, "u": y}``."""
    from repro_torch.data import sample_swe_batch

    nlat, nlon = SWE_GRID
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x, y = sample_swe_batch(torch.Generator().manual_seed(SEED + 6), nlat, nlon, SWE_FIELDS,
                            steps=SWE_STEPS)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if not (torch.isfinite(x).all() and torch.isfinite(y).all()):
        fail("non-finite shallow-water data")
    emit("swe_data", fields=SWE_FIELDS, grid=list(SWE_GRID), steps=SWE_STEPS, seconds=seconds,
         input_std=float(x[:, 0].std()), target_std=[float(y[:, c].std()) for c in range(3)])
    return {"a": x.cpu().numpy(), "u": y.cpu().numpy()}


def swe_solver_parity(data):
    """The shallow-water solver on 2 of the initial fields, card vs CPU, at
    50, 100 and 200 steps.  The gravity waves are undamped apart from the
    filter, so each step's last-bit differences (cuFFT against pocketfft,
    the GEMMs' order) add up: the growth is recorded, and the full horizon
    is held per field to one f32 ulp of relative error per step,
    ``steps · 2^-23`` = 2.4e-5 relative L2 (a wrong solver moves the
    fields by O(1))."""
    from repro_torch.data import solve_swe_linear

    nlat, nlon = SWE_GRID
    phi0 = torch.from_numpy(data["a"][:2, 0] * 1e2)
    growth = {}
    for steps in (SWE_STEPS // 4, SWE_STEPS // 2, SWE_STEPS):
        got = solve_swe_linear(phi0.cuda(), nlat, nlon, steps=steps)
        want = solve_swe_linear(phi0, nlat, nlon, steps=steps)
        growth[steps] = {name: rel_l2(a.cpu().numpy(), b.numpy())
                         for name, a, b in zip(("phi", "u", "v"), got, want, strict=True)}
    limit = SWE_STEPS * 2.0 ** -23
    emit("swe_solver_card_vs_cpu", fields=2, grid=list(SWE_GRID), rel_l2_by_steps=growth,
         limit=limit)
    if not max(growth[SWE_STEPS].values()) <= limit:
        fail(f"SWE solver card vs CPU relative L2 {growth[SWE_STEPS]} > {limit:.3e}")


def sfno_serve_phase(sc, data):
    """SFNO_SWE served on 16 shallow-water initial fields; returns the
    ls_fwd launches of the run."""
    from repro_torch.configs.fno_paper import SFNO_SWE
    from repro_torch.models import init_sfno, param_count

    t0 = time.perf_counter()
    net = init_sfno(torch.Generator().manual_seed(SEED + 7), SFNO_SWE)
    net_cpu = init_sfno(torch.Generator().manual_seed(SEED + 7), SFNO_SWE, device="cpu")
    fields = {SWE_GRID[0]: list(data["a"][:SFNO_SERVE_FIELDS])}
    emit("sfno_setup", params=param_count(net), seconds=time.perf_counter() - t0)
    launches, _ = serve_model(sc, "sfno_", SFNO_SWE, net, net_cpu, fields,
                              ((SWE_GRID[0], 5), (SWE_GRID[0], 12)), "launches_ls_fwd",
                              model="sfno")
    return launches


def sfno_train_phase(sc, data):
    """SFNO_SWE trained on the shallow-water pairs; returns the launches of
    each order-shared kernel in the main run."""
    from repro_torch.configs.fno_paper import SFNO_SWE

    launched, _, _, _ = train_model(sc, "sfno_", SFNO_SWE, data, loss_l2, SEED + 8,
                                    ("launches_ls_fwd", "launches_ls_bwd_x",
                                     "launches_ls_bwd_w"), sfno=True)
    return {"ls_fwd": launched["launches_ls_fwd"], "ls_bwd_x": launched["launches_ls_bwd_x"],
            "ls_bwd_w": launched["launches_ls_bwd_w"]}


# -- phase 8b: GINO on the car shapes ----------------------------------------------
def gino_twin(net, cfg, device="cpu"):
    """A GINO of ``cfg`` (another ``fuse_spectral``) holding ``net``'s
    weights, on ``device``."""
    from repro_torch.models import GINO

    twin = GINO(cfg)
    twin.load_state_dict({k: v.detach().cpu() for k, v in net.state_dict().items()})
    return twin.to(device)


def gino_phase(sc):
    """GINO_CAR at full width on car batches from the device sampler: the
    KNN card vs CPU, the forward's launches and card vs CPU under full,
    fused (the CPU told ``fuse_spectral=True``) and staged (both
    ``fuse_spectral=False``), batched == per-sample, one step's gradients
    card vs CPU on both paths, 12 steps of the example's loop, one step
    run twice, a profiled step.  Returns the launches of each kernel on
    the GINO path."""
    import dataclasses

    from repro_torch.configs.fno_paper import GINO_CAR
    from repro_torch.core.schedule import PrecisionSchedule
    from repro_torch.examples import gino_car_cfd as ex
    from repro_torch.models import gino_apply, init_gino, param_count
    from repro_torch.optim import AdamW
    from repro_torch.precision import get_policy
    from repro_torch.train import Trainer, TrainerConfig

    cfg = GINO_CAR
    staged = dataclasses.replace(cfg, fno=dataclasses.replace(cfg.fno, fuse_spectral=False))
    fused_cpu = dataclasses.replace(cfg, fno=dataclasses.replace(cfg.fno, fuse_spectral=True))
    full, mixed = get_policy("full"), get_policy("mixed_fno_bf16")
    layers, corners = cfg.fno.n_layers, 2 ** (cfg.fno.ndim - 1)
    H, grid = cfg.fno.hidden_channels, (cfg.latent_grid,) * 3

    def fused_per_layer(B):
        """Fused launches per layer: one per batch tile of ``pick_block_b``."""
        return -(-B // sc.pick_block_b(B, H, H, grid, cfg.fno.modes))

    path_launches = dict.fromkeys(LAUNCH_COUNTERS, 0)

    def run(fn):
        """``fn()`` as a piece of the GINO path: counts from 0, read after."""
        zero_counts(sc)
        out = fn()
        torch.cuda.synchronize()
        got = counts(sc)
        for name, n in got.items():
            path_launches[name] += n
        return out, got

    def expect(got, tag, **want):
        want = {name: want.get(name, 0) for name in LAUNCH_COUNTERS}
        if got != want:
            fail(f"gino {tag}: launches {got}, want {want}")

    # the data: the device sampler, its KNN against the CPU's on 2 shapes
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batch = ex.car_batch(SEED + 20, cfg, GINO_POINTS, GINO_BATCH)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    t0 = time.perf_counter()
    two_cpu = ex.car_batch(SEED + 20, cfg, GINO_POINTS, 2, device="cpu")
    cpu_seconds = time.perf_counter() - t0
    differ = [k for k, v in two_cpu.items() if not torch.equal(batch[k][:2].cpu(), v)]
    emit("gino_data", batch=GINO_BATCH, points=GINO_POINTS, latent_grid=cfg.latent_grid,
         k=cfg.k_neighbors, radius=0.35, seconds=seconds, cpu_seconds_two_shapes=cpu_seconds,
         enc_mask_mean=float(batch["enc_mask"].mean()),
         dec_mask_mean=float(batch["dec_mask"].mean()),
         knn_card_equals_cpu=not differ, differing=differ)
    if differ:
        fail(f"gino: the card's car batch differs from the CPU's in {differ}")

    t0 = time.perf_counter()
    net = init_gino(torch.Generator().manual_seed(SEED + 21), cfg)
    nets = {"fused": net, "staged": gino_twin(net, staged, "cuda")}
    cpu_nets = {"fused": gino_twin(net, fused_cpu), "staged": gino_twin(net, staged)}
    emit("gino_setup", params=param_count(net), latent_fno_params=param_count(net.fno),
         fuse_spectral=cfg.fno.fuse_spectral, seconds=time.perf_counter() - t0)
    if param_count(net.fno) != 226_521_568:
        fail(f"gino: the latent FNO holds {param_count(net.fno)} parameters")

    # the forward on both paths, card vs CPU under full on 2 shapes
    two = {k: v[:2] for k, v in batch.items()}
    per_fwd = {"fused": {"launches_fused_fwd": layers * fused_per_layer(GINO_BATCH)},
               "staged": {"launches": layers * corners}}
    parity = {}
    for path, card_net in nets.items():
        with torch.no_grad():
            y, got = run(lambda card_net=card_net: gino_apply(card_net, batch, full))
            expect(got, f"{path} forward", **per_fwd[path])
            y_cpu = gino_apply(cpu_nets[path], two_cpu, full).numpy()
        if y.shape != (GINO_BATCH, GINO_POINTS, 1) or not bool(torch.isfinite(y).all()):
            fail(f"gino {path}: output {tuple(y.shape)}, finite {bool(torch.isfinite(y).all())}")
        parity[path] = rel_l2(y[:2].cpu().numpy(), y_cpu)
    emit("gino_card_vs_cpu", policy="full", rel_l2=parity, limit=1e-5,
         launches_per_forward=per_fwd)
    for path, err in parity.items():
        if not err <= 1e-5:
            fail(f"gino {path}: card vs CPU relative L2 {err:.3e} > 1e-5")

    # batched against per-sample on the card: each shape alone gets its
    # batched answer up to the order of f32 sums.  Not bit for bit: cuBLAS
    # picks its GEMM by the row count, so the pointwise layers' sums run in
    # another order at batch 1 (the FFTs and the spectral kernels do not
    # depend on the batch); the operator engine pads to a fixed width for
    # that reason.  Within 1e-6 relative L2 under full, a quarter of the
    # batched run's own gap to full under mixed_fno_bf16.
    alone_equal, alone_err, outs = {}, {}, {}
    for pname, policy in (("full", full), ("mixed_fno_bf16", mixed)):
        with torch.no_grad():
            together, _ = run(lambda policy=policy: gino_apply(net, batch, policy))
            alone = [run(lambda b=b, policy=policy: gino_apply(
                net, {k: v[b:b + 1] for k, v in batch.items()}, policy))[0][0]
                for b in range(GINO_BATCH)]
        alone_equal[pname] = [bool(torch.equal(a, together[b])) for b, a in enumerate(alone)]
        alone_err[pname] = rel_l2(torch.stack(alone).cpu().numpy(), together.cpu().numpy())
        outs[pname] = together.cpu().numpy()
    limits = {"full": 1e-6, "mixed_fno_bf16": 0.25 * rel_l2(outs["mixed_fno_bf16"], outs["full"])}
    emit("gino_batched_vs_alone", bit_identical=alone_equal, rel_l2=alone_err, limits=limits)
    for pname, err in alone_err.items():
        if not err <= limits[pname]:
            fail(f"gino {pname}: shapes alone differ from their batched answers by {err:.3e} "
                 f"> {limits[pname]:.3e}")

    # one step's gradients, card vs CPU under full, on both paths
    per_grad = {"fused": {"launches_fused_fwd": layers * fused_per_layer(2),
                          "launches_fused_bwd": layers * fused_per_layer(2)},
                "staged": {"launches": layers * corners, "launches_bwd_x": layers * corners,
                           "launches_bwd_w": layers * corners}}
    grad_err = {}
    for path, card_net in nets.items():
        g, got = run(lambda card_net=card_net: leaf_grads(ex.loss_fn, card_net, two, full))
        expect(got, f"{path} gradient", **per_grad[path])
        want = leaf_grads(ex.loss_fn, cpu_nets[path], two_cpu, full)
        grad_err[path] = {leaf: rel_l2(g[leaf], w) for leaf, w in want.items()}
    emit("gino_train_grad_card_vs_cpu", policy="full", rel_l2=grad_err, limit=1e-4)
    for path, errs in grad_err.items():
        for leaf, err in errs.items():
            if not err <= 1e-4:
                fail(f"gino {path} {leaf}: card vs CPU gradient relative L2 {err:.3e} > 1e-4")
    del cpu_nets, nets["staged"], two_cpu

    # 12 steps of the example's loop at full width under mixed_fno_bf16
    torch.cuda.reset_peak_memory_stats()
    trainer, got = run(lambda: ex.train(cfg, GINO_STEPS, GINO_POINTS, GINO_BATCH, model=net))
    peak = torch.cuda.max_memory_allocated()
    per_step = layers * fused_per_layer(GINO_BATCH)
    expect(got, "training", launches_fused_fwd=per_step * GINO_STEPS,
           launches_fused_bwd=per_step * GINO_STEPS)
    hist = trainer.history
    losses = [h["loss"] for h in hist]
    for h in hist:
        emit("gino_train_step", step=h["step"], policy=h["policy"], loss=h["loss"],
             ms=h["dt"] * 1e3, fields_per_s=GINO_BATCH / h["dt"])
    ms = float(np.median([h["dt"] * 1e3 for h in hist[1:]]))
    emit("gino_train", steps=len(hist), policy="mixed_fno_bf16", losses=losses,
         median_ms_per_step=ms, fields_per_s=GINO_BATCH / (ms / 1e3), peak_mem_bytes=peak,
         batch_tile=sc.pick_block_b(GINO_BATCH, H, H, grid, cfg.fno.modes),
         fused_launches_per_step=per_step, launches=got)
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        fail(f"gino: losses not finite and falling: {losses}")

    # one step twice from the same state: bit-identical parameters
    step_batch = ex.car_batch(SEED + 22, cfg, GINO_POINTS, GINO_BATCH)
    tcfg = TrainerConfig(total_steps=2, schedule=PrecisionSchedule.constant("mixed_fno_bf16"),
                         optimizer=AdamW(lr=2e-3))
    after = []
    for _ in range(2):
        tt = Trainer(ex.loss_fn, trainer.model, tcfg)
        run(lambda tt=tt: tt.run(lambda s: step_batch, steps=1))
        after.append({k: p.detach().clone() for k, p in tt.params.items()})
    differ = [k for k in after[0] if not torch.equal(after[0][k], after[1][k])]
    emit("gino_step_rerun", bit_identical=not differ, differing_leaves=differ)
    if differ:
        fail(f"gino: one step run twice differs in {differ}")
    del after

    prof = profiled(lambda: run(lambda: tt.run(lambda s: step_batch, steps=2)))
    prof["step_ms_unprofiled"] = ms
    prof["idle_share_unprofiled"] = max(0.0, 1.0 - prof["device_busy_ms"] / ms)
    emit("gino_train_profile", policy="mixed_fno_bf16", **prof)
    return {"fwd": path_launches["launches"], "bwd_x": path_launches["launches_bwd_x"],
            "bwd_w": path_launches["launches_bwd_w"],
            "fused_fwd": path_launches["launches_fused_fwd"],
            "fused_bwd": path_launches["launches_fused_bwd"]}


# -- phase 8c: the U-Net baseline ------------------------------------------------------
def unet_phase():
    """UNET_BASELINE on 8 Darcy fields at 128²: the forward card vs CPU
    under full, then 30 AdamW(lr=2e-3, no weight decay) steps under
    amp_bf16 on the whole set, as the paper-table benchmark trains it; the
    loss spikes on the way down, so its last quarter, on average, must be
    below the first step's; the 30 steps again from the same state must
    give the same losses and parameters bit for bit."""
    from repro_torch.configs.fno_paper import UNET_BASELINE
    from repro_torch.core.schedule import PrecisionSchedule
    from repro_torch.data import sample_darcy_batch
    from repro_torch.models import init_unet, param_count, unet_apply
    from repro_torch.optim import AdamW
    from repro_torch.precision import get_policy
    from repro_torch.train import Trainer, TrainerConfig, relative_l2

    a, u = sample_darcy_batch(torch.Generator().manual_seed(SEED + 30), UNET_GRID, UNET_FIELDS,
                              maxiter=CG_MAXITER)
    net = init_unet(torch.Generator().manual_seed(SEED + 31), UNET_BASELINE)
    net_cpu = init_unet(torch.Generator().manual_seed(SEED + 31), UNET_BASELINE, device="cpu")
    with torch.no_grad():
        y = unet_apply(net, a, get_policy("full"))
        y_cpu = unet_apply(net_cpu, a.cpu(), get_policy("full")).numpy()
    err = rel_l2(y.cpu().numpy(), y_cpu)
    emit("unet_card_vs_cpu", params=param_count(net), fields=UNET_FIELDS, grid=UNET_GRID,
         policy="full", rel_l2=err, limit=1e-5)
    if y.shape != (UNET_FIELDS, 1, UNET_GRID, UNET_GRID) or not err <= 1e-5:
        fail(f"unet: output {tuple(y.shape)}, card vs CPU relative L2 {err:.3e} > 1e-5")

    def loss_fn(model, batch, policy):
        return relative_l2(unet_apply(model, batch["a"], policy), batch["u"])

    tcfg = TrainerConfig(total_steps=UNET_STEPS, schedule=PrecisionSchedule.constant("amp_bf16"),
                         optimizer=AdamW(lr=2e-3, weight_decay=0.0))
    trainer = Trainer(loss_fn, net, tcfg)
    torch.cuda.reset_peak_memory_stats()
    trainer.run(lambda s: {"a": a, "u": u})
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    losses = [h["loss"] for h in trainer.history]

    # the same 30 steps again from the same state: bit-identical losses and
    # parameters (the convolutions' backward is deterministic on the card)
    again = Trainer(loss_fn, net, tcfg)
    again.run(lambda s: {"a": a, "u": u})
    differ = [k for k, p in trainer.params.items() if not torch.equal(p, again.params[k])]
    same_losses = [h["loss"] for h in again.history] == losses
    emit("unet_train_rerun", steps=UNET_STEPS, bit_identical=not differ and same_losses,
         same_losses=same_losses, differing_leaves=differ)
    if differ or not same_losses:
        fail(f"unet: 30 steps run twice differ (losses equal: {same_losses}; leaves {differ})")
    ms = float(np.median([h["dt"] * 1e3 for h in trainer.history[1:]]))
    emit("unet_train", steps=len(losses), policy="amp_bf16", losses=losses,
         median_ms_per_step=ms, fields_per_s=UNET_FIELDS / (ms / 1e3), peak_mem_bytes=peak,
         skipped_steps=trainer.stats["skipped_steps"])
    tail = losses[-(len(losses) // 4):]
    emit("unet_train_gate", first=losses[0], last_quarter_mean=float(np.mean(tail)))
    if not np.isfinite(losses).all() or not float(np.mean(tail)) < losses[0]:
        fail(f"unet: losses not finite, or their last quarter not below the first: {losses}")


# -- phase 8d: auto-precision -----------------------------------------------------------
def autoprec_snapshot_card_vs_cpu(card, cpu_totals):
    """The first training step's telemetry on the card against the CPU's
    forward of the same batch: one site set, equal n, overflow and
    underflow, amax within 1e-4 relative and qerr within 1e-4 · amax (cuFFT
    and pocketfft differ in the last bits)."""
    rows, bad = {}, []
    if set(card) != set(cpu_totals):
        fail(f"autoprec: card sites {sorted(card)} != CPU sites {sorted(cpu_totals)}")
    for site, w in sorted(card.items()):
        c = cpu_totals[site]
        rows[site] = {"n": w.n, "amax": w.amax, "cpu_amax": c.amax, "qerr": w.qerr,
                      "cpu_qerr": c.qerr, "overflow": w.overflow, "underflow": w.underflow,
                      "hist_l1_diff": float(np.abs(w.hist - c.hist).sum()),
                      "hist_mass": float(c.hist.sum())}
        if (w.n, w.overflow, w.underflow) != (c.n, c.overflow, c.underflow) or \
                not abs(w.amax - c.amax) <= 1e-4 * c.amax or \
                not abs(w.qerr - c.qerr) <= 1e-4 * c.amax:
            bad.append(site)
    emit("autoprec_card_vs_cpu", sites=rows, amax_rel_limit=1e-4, qerr_limit="1e-4*amax")
    if bad:
        fail(f"autoprec: the card's first snapshot differs from the CPU's at {bad}")


def telemetry_cost(data, rules):
    """Median ms a step (6 steps, step 0 left out) and a tick (7 ticks of 8
    fields at 128², the first left out), then a seventh step and an eighth
    tick under the profiler (device busy ms and device events), under one
    fixed policy, ``rules``
    over ``full`` (the trained controller's overlay): staged with
    telemetry on, staged with it off (the taps' cost), and FNO_DARCY's
    default config with it off (fused on the card: what a collector's veto
    gives up)."""
    import dataclasses

    from repro_torch.configs.fno_paper import FNO_DARCY
    from repro_torch.core.schedule import PrecisionSchedule
    from repro_torch.data import CachedDataset, grf_2d
    from repro_torch.models import init_fno
    from repro_torch.serve import FieldRequest, OperatorEngine
    from repro_torch.train import Trainer, TrainerConfig

    schedule = PrecisionSchedule(phases=((1.0, rules),), base="full")
    policy = schedule.policy_at(0, 1)
    loader = CachedDataset(data, TRAIN_BATCH, seed=SEED)
    fields = list(grf_2d(torch.Generator().manual_seed(SEED + 40), TRAIN_GRID,
                         batch=8 * MAX_BATCH).numpy()[:, None])
    out = {}
    for label, fuse, telemetry in (("staged_telemetry_on", False, True),
                                   ("staged_telemetry_off", False, False),
                                   ("default_config_telemetry_off", None, False)):
        cfg = dataclasses.replace(FNO_DARCY, fuse_spectral=fuse)
        trainer = Trainer(loss_l2, init_fno(torch.Generator().manual_seed(SEED + 1), cfg,
                                            device="cpu"),
                          TrainerConfig(total_steps=6, schedule=schedule, telemetry=telemetry))
        trainer.run(loader.batch_at)
        step_ms = [h["dt"] * 1e3 for h in trainer.history[1:]]
        net = init_fno(torch.Generator().manual_seed(SEED), cfg)
        engine = OperatorEngine(net, policy=policy, max_batch=MAX_BATCH, telemetry=telemetry)
        for i, x in enumerate(fields):
            engine.submit(FieldRequest(uid=i, x=x))
        tick_ms = []
        while engine.scheduler.depth > MAX_BATCH:
            t0 = time.perf_counter()
            engine.tick()
            tick_ms.append((time.perf_counter() - t0) * 1e3)
        tick_prof = profiled(engine.tick)
        step_prof = profiled(lambda trainer=trainer: trainer.run(loader.batch_at, steps=7))
        out[label] = {"median_step_ms": float(np.median(step_ms)), "step_ms": step_ms,
                      "median_tick_ms": float(np.median(tick_ms[1:])), "tick_ms": tick_ms,
                      "profiled_step": {k: step_prof[k] for k in (
                          "wall_ms", "device_busy_ms", "device_events", "top")},
                      "profiled_tick": {k: tick_prof[k] for k in (
                          "wall_ms", "device_busy_ms", "device_events", "top")}}
        del trainer, net, engine
    on, off = out["staged_telemetry_on"], out["staged_telemetry_off"]
    emit("autoprec_telemetry_cost", policy=policy.name, grid=TRAIN_GRID, batch=TRAIN_BATCH,
         step_overhead=on["median_step_ms"] / off["median_step_ms"] - 1.0,
         tick_overhead=on["median_tick_ms"] / off["median_tick_ms"] - 1.0, **out)


def autoprec_phase(sc, data):
    """FNO_DARCY at its default config (fused on the card), staged by the
    telemetry veto, under auto-precision at 128²: 16 training steps and
    16 served micro-batches, each path's launches counted; the first
    step's telemetry against the CPU; telemetry's cost.  Returns the dense
    kernels' launches on these paths."""
    import copy

    from repro_torch.autoprec import AutoPrecisionController, TelemetryAggregator, \
        TraceCollector, collecting
    from repro_torch.configs.fno_paper import FNO_DARCY
    from repro_torch.core.schedule import PrecisionSchedule
    from repro_torch.data import CachedDataset, grf_2d
    from repro_torch.models import fno_apply, fno_infer, init_fno
    from repro_torch.precision import get_policy
    from repro_torch.serve import FieldRequest, OperatorEngine
    from repro_torch.train import Trainer, TrainerConfig

    n2 = TRAIN_GRID ** 2
    groups = [f"fno/layer{i}/spectral" for i in range(FNO_DARCY.n_layers)]
    per_step = FNO_DARCY.n_layers * 2 ** (FNO_DARCY.ndim - 1)
    dense = ("launches", "launches_bwd_x", "launches_bwd_w")
    loader = CachedDataset(data, TRAIN_BATCH, seed=SEED)
    net_cpu = init_fno(torch.Generator().manual_seed(SEED + 1), FNO_DARCY, device="cpu")
    ctl = AutoPrecisionController(base="full", grid_points=n2, interval=4)
    trainer = Trainer(loss_l2, net_cpu, TrainerConfig(
        total_steps=AUTOPREC_STEPS, schedule=PrecisionSchedule.auto("full", grid_points=n2),
        autoprec=ctl))
    halves = {}
    zero_counts(sc)                                   # the training path starts
    trainer.run(loader.batch_at, steps=1)
    first = copy.deepcopy(trainer.telemetry.totals)
    trainer.run(loader.batch_at, steps=AUTOPREC_STEPS // 2)
    torch.cuda.synchronize()
    halves["steps_0_7"] = counts(sc)
    zero_counts(sc)
    trainer.run(loader.batch_at)
    torch.cuda.synchronize()
    halves["steps_8_15"] = counts(sc)                 # the training path ends
    hist = trainer.history
    policies = [h["policy"] for h in hist]
    losses = [h["loss"] for h in hist]
    decisions = ctl.describe()
    numerics = trainer.telemetry.counters()
    emit("autoprec_train", steps=len(hist), policies=policies, losses=losses,
         policy_changes=trainer.stats["policy_changes"],
         overflow_total=numerics["overflow_total"], underflow_total=numerics["underflow_total"],
         launches=halves, step_ms=[h["dt"] * 1e3 for h in hist],
         decisions={g: {k: st[k] for k in ("fmt", "eps_budget", "amax")}
                    for g, st in decisions["sites"].items()},
         eps_budget_128=ctl.eps_budget(n2))
    half = AUTOPREC_STEPS // 2
    if policies != ["full+auto0"] * half + ["full+auto1"] * half:
        fail(f"autoprec: policies {policies}")
    if {g: st["fmt"] for g, st in decisions["sites"].items()} != dict.fromkeys(groups,
                                                                               "bfloat16"):
        fail(f"autoprec: decisions {decisions['sites']}")
    if trainer.stats["policy_changes"] != 1 or numerics["overflow_total"] != 0 or \
            not np.isfinite(losses).all():
        fail(f"autoprec: {trainer.stats}, overflows {numerics['overflow_total']}, "
             f"losses {losses}")
    for name, got in halves.items():
        want = {k: (per_step * half if k in dense else 0) for k in LAUNCH_COUNTERS}
        if got != want:
            fail(f"autoprec: {name} launched {got}, want {want}")

    # the card's first snapshot against the CPU's forward of the same batch
    cpu_col = TraceCollector()
    with torch.no_grad(), collecting(cpu_col):
        fno_apply(init_fno(torch.Generator().manual_seed(SEED + 1), FNO_DARCY, device="cpu"),
                  torch.from_numpy(loader.batch_at(0)["a"]),
                  AutoPrecisionController(base="full").policy())
    cpu_agg = TelemetryAggregator()
    cpu_agg.update(cpu_col.snapshot())
    autoprec_snapshot_card_vs_cpu(first, cpu_agg.totals)

    # serving: the controller owns the engine's policy
    net = init_fno(torch.Generator().manual_seed(SEED), FNO_DARCY)
    sctl = AutoPrecisionController(base="full", grid_points=n2)
    engine = OperatorEngine(net, autoprec=sctl, autoprec_every=4, max_batch=MAX_BATCH)
    fields = list(grf_2d(torch.Generator().manual_seed(SEED + 41), TRAIN_GRID,
                         batch=AUTOPREC_BATCHES * MAX_BATCH).numpy()[:, None])
    reqs = [FieldRequest(uid=i, x=x) for i, x in enumerate(fields)]
    for r in reqs:
        engine.submit(r)
    zero_counts(sc)                                   # the serving path starts
    tick_policy, tick_ms = [], []
    while engine.scheduler.depth:
        tick_policy.append(engine.policy.name)
        t0 = time.perf_counter()
        engine.tick()
        tick_ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    served = counts(sc)                               # the serving path ends
    check_outputs(reqs, FNO_DARCY)
    stats = engine.stats()
    emit("autoprec_serve", micro_batches=len(tick_ms), tick_policy=tick_policy, tick_ms=tick_ms,
         launches=served, policy=stats["policy"],
         decisions={g: {k: st[k] for k in ("fmt", "eps_budget", "amax")}
                    for g, st in stats["autoprec"]["sites"].items()},
         overflow_total=stats["numerics"]["overflow_total"])
    want = {k: (per_step * AUTOPREC_BATCHES if k == "launches" else 0) for k in LAUNCH_COUNTERS}
    if served != want:
        fail(f"autoprec serving launched {served}, want {want}")
    if stats["policy"] != "full+auto1" or {g: st["fmt"] for g, st in stats["autoprec"][
            "sites"].items()} != dict.fromkeys(groups, "bfloat16"):
        fail(f"autoprec serving: policy {stats['policy']}, {stats['autoprec']['sites']}")
    # after the switch: solo == batched with telemetry on, and the answer
    # within mixed_fno_bf16's own distance of the full one
    last = reqs[-3]
    solo = OperatorEngine(net, policy=sctl.policy(), telemetry=True, max_batch=MAX_BATCH)
    alone = FieldRequest(uid=0, x=last.x)
    solo.submit(alone)
    solo.drain()
    x = last.x[None]
    y_full = fno_infer(net, x, get_policy("full")).cpu().numpy()[0]
    y_mixed = fno_infer(net, x, get_policy("mixed_fno_bf16")).cpu().numpy()[0]
    auto_gap, mixed_gap = rel_l2(last.y, y_full), rel_l2(y_mixed, y_full)
    emit("autoprec_serve_checks", solo_bit_identical=bool(np.array_equal(alone.y, last.y)),
         auto_vs_full_rel_l2=auto_gap, mixed_fno_bf16_vs_full_rel_l2=mixed_gap)
    if not np.array_equal(alone.y, last.y):
        fail("autoprec serving: a field served alone differs from its batched answer")
    if not auto_gap <= mixed_gap:
        fail(f"autoprec serving: {auto_gap:.3e} from full, beyond mixed_fno_bf16's {mixed_gap:.3e}")
    del trainer, engine, solo, net
    telemetry_cost(data, ctl.overlay())
    return {"fwd": halves["steps_0_7"]["launches"] + halves["steps_8_15"]["launches"]
            + served["launches"],
            "bwd_x": halves["steps_0_7"]["launches_bwd_x"] + halves["steps_8_15"]["launches_bwd_x"],
            "bwd_w": halves["steps_0_7"]["launches_bwd_w"] + halves["steps_8_15"]["launches_bwd_w"],
            "fused_fwd": 0, "fused_bwd": 0}


# -- phase 8e: the tuner ---------------------------------------------------------------
def _tune_cli(*argv):
    """``python -m repro_torch.tune`` in this process: its exit code and its
    printed lines (echoed)."""
    import contextlib
    import io

    from repro_torch.tune.__main__ import main as tune_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = tune_main(list(argv))
    print(buf.getvalue(), end="", flush=True)
    return rc, buf.getvalue()


def _serve_fields(sc, net, fields, state, policy):
    """Serve ``fields`` through a fresh engine at micro-batch 8 with
    ``state`` active (None: none); returns the answers, the fused forward
    launches, the tile stats and the ms per tick."""
    from repro_torch.kernels import ops
    from repro_torch.serve import FieldRequest, OperatorEngine
    from repro_torch.tune import cache

    cache.activate(None)
    ops.reset_tile_resolution_stats()
    engine = OperatorEngine(net, policy=policy, max_batch=MAX_BATCH, calibration_state=state)
    reqs = [FieldRequest(uid=i, x=x) for i, x in enumerate(fields)]
    for r in reqs:
        engine.submit(r)
    before = sc.launches_fused_fwd
    tick_ms = []
    while engine.scheduler.depth:
        t0 = time.perf_counter()
        engine.tick()
        tick_ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    check_outputs(reqs, net.cfg)
    return [r.y for r in reqs], sc.launches_fused_fwd - before, engine.stats()["tiles"], tick_ms


def _train_steps(sc, data, state, seed=SEED + 1, obs=False, steps=TRAIN_STEPS, schedule=None,
                 autoprec=None):
    """``FNO_DARCY`` (fused on the card) trained ``steps`` steps of
    ``paper_default("bf16")`` on the Darcy pairs with ``state`` active (None:
    none); returns the trainer and each step's fused launches."""
    from repro_torch.configs.fno_paper import FNO_DARCY
    from repro_torch.core.schedule import PrecisionSchedule
    from repro_torch.data import CachedDataset
    from repro_torch.models import init_fno
    from repro_torch.train import Trainer, TrainerConfig
    from repro_torch.tune import cache

    cache.activate(None)
    loader = CachedDataset(data, TRAIN_BATCH, seed=SEED)
    net = init_fno(torch.Generator().manual_seed(seed), FNO_DARCY, device="cpu")
    trainer = Trainer(loss_l2, net, TrainerConfig(
        total_steps=steps, schedule=schedule or PrecisionSchedule.paper_default("bf16"),
        calibration_state=state, obs=obs, autoprec=autoprec))
    per_step = []
    for _ in range(steps):
        before = (sc.launches_fused_fwd, sc.launches_fused_bwd)
        trainer.run(loader.batch_at, steps=trainer.step + 1)
        torch.cuda.synchronize()
        per_step.append((sc.launches_fused_fwd - before[0], sc.launches_fused_bwd - before[1]))
    return trainer, per_step


def tune_phase(sc, data, card):
    """``python -m repro_torch.tune`` on the card over ``DEFAULT_KEYS``, then
    ``validate`` (every entry passes) and ``validate --perturb 2`` (every
    entry rejected); each key's heuristic and winner.  Then FNO_DARCY served
    (16 micro-batches of 8 at 128², ``mixed_fno_bf16``) and trained (12
    steps) with ``calibration_state=`` that state, each against the same
    run with no state: calibrated hits and no stale entry, the fused
    launches following the winners' tiles, served fields bit-identical,
    the losses finite and falling (phase 5's loss gates; their relative
    difference to the run without state printed) and step 0's gradients
    within phase 5's card-vs-CPU gates of the run without state;
    a state whose ``kernel_version`` is altered is served entirely by the
    heuristic, bit for bit; a state seeded with batch tile 2 both ways at
    128² serves 4x the fused launches bit for bit and trains within the
    same limits.  Returns the fused launches of its paths."""
    import json as json_

    from repro_torch.configs.fno_paper import FNO_DARCY
    from repro_torch.data import grf_2d
    from repro_torch.kernels import ops
    from repro_torch.models import init_fno
    from repro_torch.precision import get_policy
    from repro_torch.tune import cache
    from repro_torch.tune.__main__ import DEFAULT_KEYS

    state = ROOT / "build" / "chip_smoke_calibration.json"
    if state.exists():
        state.unlink()
    t0 = time.perf_counter()
    rc, _ = _tune_cli("tune", "--state", str(state))
    tune_s = time.perf_counter() - t0
    if rc != 0:
        fail(f"tune exited {rc}")
    loaded = cache.load(state)
    t0 = time.perf_counter()
    rc_ok, out_ok = _tune_cli("validate", "--state", str(state))
    rc_bad, out_bad = _tune_cli("validate", "--state", str(state), "--perturb", "2")
    validate_s = time.perf_counter() - t0
    n = len(loaded.entries)
    rejected = out_bad.count("REJECT ")
    emit("tune_cycle", card=card, keys=len(DEFAULT_KEYS), entries=n, tune_seconds=tune_s,
         validate_seconds=validate_s, validate_rc=rc_ok, perturbed_rc=rc_bad,
         perturbed_rejected=rejected, backend=loaded.backend,
         kernel_version=loaded.kernel_version)
    if n != len(DEFAULT_KEYS) or rc_ok != 0 or f"{n} checked, 0 rejected" not in out_ok:
        fail(f"tune: {n} entries of {len(DEFAULT_KEYS)} keys, validate rc {rc_ok}")
    if rc_bad != 1 or rejected != n:
        fail(f"tune: validate --perturb 2 rejected {rejected} of {n} (rc {rc_bad})")
    winners = {}
    for family, shape, dtype in DEFAULT_KEYS:
        ent = loaded.entries.get(cache.entry_key(family, shape, dtype))
        if ent is None or not ent["validated"] or ent["interpret"]:
            fail(f"tune: no card entry for {family} {shape} {dtype}: {ent}")
        winners[(family, tuple(shape), dtype)] = (ent["block_fwd"], ent["block_bwd"])
        emit("tune_key", card=card, family=family, shape=list(shape), dtype=dtype,
             heuristic={"block_fwd": ent["heuristic_fwd"], "block_bwd": ent["heuristic_bwd"],
                        "us": ent["heuristic_wall_us"]},
             winner={"block_fwd": ent["block_fwd"], "block_bwd": ent["block_bwd"],
                     "us": ent["wall_us"], "gbps": ent["gbps"],
                     "roofline_fraction": ent["roofline_fraction"]},
             winner_over_heuristic=ent["wall_us"] / ent["heuristic_wall_us"],
             max_err=ent["max_err"], budget_min=ent["budget_min"])

    # serving at 128², mixed_fno_bf16: with the state against without
    layers = FNO_DARCY.n_layers
    key = ("spectral_fused", (MAX_BATCH, 64, 64, TRAIN_GRID, TRAIN_GRID, 32, 32))
    net = init_fno(torch.Generator().manual_seed(SEED), FNO_DARCY)
    fields = list(grf_2d(torch.Generator().manual_seed(SEED + 50), TRAIN_GRID,
                         batch=TUNE_BATCHES * MAX_BATCH).numpy()[:, None])
    policy = get_policy("mixed_fno_bf16")
    y0, n0, _, ms0 = _serve_fields(sc, net, fields, None, policy)
    y1, n1, tiles, ms1 = _serve_fields(sc, net, fields, str(state), policy)
    bf, _bb = winners[(*key, "bfloat16")]
    same = all(np.array_equal(a, b) for a, b in zip(y0, y1, strict=True))
    emit("tune_serve", card=card, micro_batches=TUNE_BATCHES, tiles=tiles,
         fused_fwd_launches={"no_state": n0, "state": n1}, bit_identical=same,
         median_tick_ms={"no_state": float(np.median(ms0[1:])),
                         "state": float(np.median(ms1[1:]))})
    if n1 != TUNE_BATCHES * layers * (MAX_BATCH // bf) or n0 != TUNE_BATCHES * layers:
        fail(f"tune serving: {n1} fused launches with the state (winner {bf}), {n0} without")
    if tiles["cache"] != {"hits": TUNE_BATCHES * layers, "misses": 0, "stale": 0} or \
            tiles["sources"]["calibrated"] != TUNE_BATCHES * layers:
        fail(f"tune serving: tiles {tiles}")
    if not same:
        fail("tune serving: the calibrated fields differ from the heuristic's")

    # a stale state: its kernel_version altered, so every lookup is stale
    stale = ROOT / "build" / "chip_smoke_calibration_stale.json"
    raw = json_.loads(state.read_text())
    for ent in raw["entries"].values():
        ent["kernel_version"] = int(ent["kernel_version"]) + 1
    stale.write_text(json_.dumps(raw))
    y2, n2, stale_tiles, _ = _serve_fields(sc, net, fields, str(stale), policy)
    same_stale = all(np.array_equal(a, b) for a, b in zip(y0, y2, strict=True))
    emit("tune_stale_state", tiles=stale_tiles, fused_fwd_launches=n2,
         bit_identical_to_no_state=same_stale)
    if not same_stale or n2 != n0 or stale_tiles["cache"]["stale"] != TUNE_BATCHES * layers \
            or stale_tiles["sources"]["calibrated"]:
        fail(f"tune: a stale state changed the launches or answers: {stale_tiles}, {n2}")

    # training, 12 steps of paper_default("bf16"): with the state against without
    plain, plain_launches = _train_steps(sc, data, None)
    tuned, tuned_launches = _train_steps(sc, data, str(state))
    tuned_tiles = ops.tile_resolution_stats()
    want = []
    for h in tuned.history:
        dt = "bfloat16" if get_policy(h["policy"]).at(
            "fno/layer0/spectral/contract").spectral_is_half else "float32"
        f, b = winners[(*key, dt)]
        want.append((layers * MAX_BATCH // f, layers * MAX_BATCH // b))
    losses = [h["loss"] for h in tuned.history]
    ref_losses = [h["loss"] for h in plain.history]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses, strict=True)]
    emit("tune_train", card=card, steps=len(losses), policies=[h["policy"] for h in tuned.history],
         losses=losses, losses_no_state=ref_losses, loss_rel_diff=rel,
         fused_launches_per_step=tuned_launches, want=want, tiles=tuned_tiles,
         ms_per_step=[h["dt"] * 1e3 for h in tuned.history],
         ms_per_step_no_state=[h["dt"] * 1e3 for h in plain.history])
    if tuned_launches != want:
        fail(f"tune training: fused launches {tuned_launches}, want {want}")
    if plain_launches != [(layers, layers)] * TRAIN_STEPS:
        fail(f"tune training without state: {plain_launches}")
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        fail(f"tune training: losses not finite and falling: {losses}")
    # step 0's gradients with the state against without, under phase 5's gates
    tuned_grad_parity(data, str(state), "tune_train_grad_state_vs_none")

    # a seeded state whose 128² tiles are not the heuristic's (batch tile 2
    # both ways): 4x the fused launches, the forward still bit for bit, the
    # backward's dw summed over 4 tiles in tile order, so the gradients and
    # losses held to phase 5's limits, not bits
    seeded = ROOT / "build" / "chip_smoke_calibration_seeded.json"
    raw = json_.loads(state.read_text())
    for dt in ("bfloat16", "float32"):
        ent = raw["entries"][cache.entry_key(*key, dt)]
        ent["block_fwd"] = ent["block_bwd"] = SEEDED_TILE
    seeded.write_text(json_.dumps(raw))
    y3, n3, seeded_tiles, _ = _serve_fields(sc, net, fields, str(seeded), policy)
    same_seeded = all(np.array_equal(a, b) for a, b in zip(y0, y3, strict=True))
    seeded_trainer, seeded_launches = _train_steps(sc, data, str(seeded))
    seeded_losses = [h["loss"] for h in seeded_trainer.history]
    seeded_rel = [abs(a - b) / abs(b) for a, b in zip(seeded_losses, ref_losses, strict=True)]
    per_tile = layers * MAX_BATCH // SEEDED_TILE
    emit("tune_seeded_state", tile=SEEDED_TILE, fused_fwd_launches=n3, tiles=seeded_tiles,
         bit_identical_to_no_state=same_seeded, fused_launches_per_step=seeded_launches,
         losses=seeded_losses, loss_rel_diff=seeded_rel)
    if n3 != TUNE_BATCHES * per_tile or not same_seeded or \
            seeded_tiles["sources"]["calibrated"] != TUNE_BATCHES * layers:
        fail(f"tune: the seeded state served {n3} launches, bit-identical {same_seeded}")
    if seeded_launches != [(per_tile, per_tile)] * TRAIN_STEPS or \
            not np.isfinite(seeded_losses).all() or not seeded_losses[-1] < seeded_losses[0]:
        fail(f"tune: the seeded state trained {seeded_launches}, losses {seeded_losses}")
    tuned_grad_parity(data, str(seeded), "tune_train_grad_seeded_vs_none")
    del net
    cache.activate(None)
    return {"fused_fwd": n0 + n1 + n2 + n3 + sum(f for f, _ in plain_launches + tuned_launches
                                                 + seeded_launches),
            "fused_bwd": sum(b for _, b in plain_launches + tuned_launches + seeded_launches)}


def tuned_grad_parity(data, state, tag):
    """One step's gradients on the card with ``state`` active against none,
    same weights and 2 fields: per leaf 1e-4 relative L2 under full, a
    quarter of the card's own mixed_fno_bf16-vs-full gap under
    mixed_fno_bf16 (phase 5's gates)."""
    import copy

    from repro_torch.configs.fno_paper import FNO_DARCY
    from repro_torch.models import init_fno
    from repro_torch.precision import get_policy
    from repro_torch.tune import cache

    net = init_fno(torch.Generator().manual_seed(SEED + 1), FNO_DARCY)
    batch = {k: torch.from_numpy(v[:MAX_BATCH]).cuda() for k, v in data.items()}
    g = {}
    for label, st in (("none", None), ("state", state)):
        cache.activate(st)
        for pname in ("full", "mixed_fno_bf16"):
            g[(label, pname)] = leaf_grads(loss_l2, copy.deepcopy(net), batch,
                                           get_policy(pname))
    cache.activate(None)
    errs, limits = {}, {}
    for pname in ("full", "mixed_fno_bf16"):
        for leaf, want in g[("none", pname)].items():
            errs[f"{pname}/{leaf}"] = rel_l2(g[("state", pname)][leaf], want)
            limits[f"{pname}/{leaf}"] = 1e-4 if pname == "full" else 0.25 * rel_l2(
                g[("none", "mixed_fno_bf16")][leaf], g[("none", "full")][leaf])
    emit(tag, rel_l2=errs, limits=limits)
    bad = [k for k, e in errs.items() if not e <= limits[k]]
    if bad:
        fail(f"{tag}: gradients differ beyond phase 5's gates at {bad}")


# -- phase 8f: observability --------------------------------------------------------------
def obs_phase(sc, data):
    """FNO_DARCY (fused on the card) at 128²: 12 training steps with
    ``TrainerConfig(obs=True)`` under a caller's span and 16 micro-batches
    of 8 served with tracing on.  The Chrome trace validates; one
    ``train/step`` and one ``train/data`` span per step under the caller's
    span; one ``serve/operator/batch`` span per micro-batch inside its
    ``serve/tick``; ``repro_train_steps_total`` is the steps;
    ``repro_kernels_calls_total{family="spectral_fused"}`` is the calls
    that reached the fused wrapper (one per layer a step and a
    micro-batch; each launched ``fused_fwd`` once, batch tile 8).  Then 8
    auto-precision steps (staged by the collector's veto) with obs on: the
    controller's demotions appear as numerics events with its ε budget.
    Prints the median step and tick with tracing on against off (no gate).
    Returns the fused launches of its paths."""
    from repro_torch import obs
    from repro_torch.autoprec import AutoPrecisionController
    from repro_torch.configs.fno_paper import FNO_DARCY
    from repro_torch.core.schedule import PrecisionSchedule
    from repro_torch.data import grf_2d
    from repro_torch.kernels import ops
    from repro_torch.models import init_fno
    from repro_torch.precision import get_policy

    layers = FNO_DARCY.n_layers
    obs.trace.disable()
    obs.trace.clear()
    obs.registry().clear()
    ops._register_obs()
    # tracing off first: the baseline step and tick
    off_trainer, off_launches = _train_steps(sc, data, None)
    net = init_fno(torch.Generator().manual_seed(SEED), FNO_DARCY)
    fields = list(grf_2d(torch.Generator().manual_seed(SEED + 60), TRAIN_GRID,
                         batch=TUNE_BATCHES * MAX_BATCH).numpy()[:, None])
    policy = get_policy("mixed_fno_bf16")
    _, off_n, _, off_ms = _serve_fields(sc, net, fields, None, policy)
    obs.registry().clear()
    ops._register_obs()
    # tracing on (on before the caller's span opens, so the span records;
    # the trainer keeps a ring that is already on)
    obs.trace.enable()
    with obs.trace.span("chip_smoke/train"):
        on_trainer, on_launches = _train_steps(sc, data, None, obs=True)
    _, on_n, _, on_ms = _serve_fields(sc, net, fields, None, policy)
    recs = obs.trace.snapshot()
    snap = obs.registry().snapshot()
    doc = obs.chrome_trace(recs)
    errors = obs.validate_chrome_trace(doc)
    spans = [r for r in recs if r["kind"] == "span"]
    steps = [s for s in spans if s["name"] == "train/step"]
    datas = [s for s in spans if s["name"] == "train/data"]
    batches = [s for s in spans if s["name"] == "serve/operator/batch"]
    calls = snap["counters"].get('repro_kernels_calls_total{family="spectral_fused"}')
    fused_calls = (TRAIN_STEPS + TUNE_BATCHES) * layers
    obs.write_jsonl(str(ROOT / "build" / "chip_smoke_obs.jsonl"),
                    obs.run_records(recs, snapshot=snap, run="chip_smoke_obs"))
    obs.write_chrome_trace(str(ROOT / "build" / "chip_smoke_obs.trace.json"), recs)
    emit("obs_trace", records=len(recs), dropped=obs.trace.dropped(), chrome_errors=errors,
         train_step_spans=len(steps), train_data_spans=len(datas),
         operator_batch_spans=len(batches),
         steps_total=snap["counters"].get("repro_train_steps_total"),
         fused_calls_counted=calls, fused_calls=fused_calls,
         fused_fwd_launches={"train": sum(f for f, _ in on_launches), "serve": on_n})
    if errors:
        fail(f"obs: the Chrome trace is invalid: {errors[:5]}")
    if len(steps) != TRAIN_STEPS or [s["attrs"]["step"] for s in steps] != \
            list(range(TRAIN_STEPS)) or len(datas) != TRAIN_STEPS or \
            any((s["parent"], s["depth"]) != ("chip_smoke/train", 1) for s in steps + datas):
        fail(f"obs: train spans {[(s['name'], s.get('parent'), s['depth']) for s in steps]}")
    if len(batches) != TUNE_BATCHES or any(b["parent"] != "serve/tick" for b in batches):
        fail(f"obs: {len(batches)} operator batch spans for {TUNE_BATCHES} micro-batches")
    if snap["counters"].get("repro_train_steps_total") != TRAIN_STEPS:
        fail(f"obs: repro_train_steps_total {snap['counters'].get('repro_train_steps_total')}")
    if calls != fused_calls or sum(f for f, _ in on_launches) + on_n != fused_calls:
        fail(f"obs: {calls} fused calls counted, {fused_calls} made")

    # auto-precision with obs: the controller's decisions on the timeline
    obs.trace.clear()
    n2 = TRAIN_GRID ** 2
    ctl = AutoPrecisionController(base="full", grid_points=n2, interval=4)
    auto, _ = _train_steps(sc, data, None, obs=True, steps=8, autoprec=ctl,
                           schedule=PrecisionSchedule.auto("full", grid_points=n2))
    demotes = [r for r in obs.trace.snapshot() if r["name"] == "numerics/autoprec_demote"]
    groups = sorted(r["attrs"]["site"] for r in demotes)
    emit("obs_autoprec_events", steps=len(auto.history), demotes=[r["attrs"] for r in demotes],
         eps_budget=ctl.eps_budget(n2))
    if groups != [f"fno/layer{i}/spectral" for i in range(layers)] or any(
            r["attrs"]["eps_budget"] != ctl.eps_budget(n2) or r["attrs"]["to_fmt"] != "bfloat16"
            for r in demotes):
        fail(f"obs: autoprec demotions on the timeline {[r['attrs'] for r in demotes]}")
    obs.trace.disable()
    obs.trace.clear()
    on_step = float(np.median([h["dt"] * 1e3 for h in on_trainer.history[1:]]))
    off_step = float(np.median([h["dt"] * 1e3 for h in off_trainer.history[1:]]))
    emit("obs_cost", median_step_ms={"on": on_step, "off": off_step},
         median_tick_ms={"on": float(np.median(on_ms[1:])), "off": float(np.median(off_ms[1:]))},
         step_overhead=on_step / off_step - 1.0,
         tick_overhead=float(np.median(on_ms[1:]) / np.median(off_ms[1:])) - 1.0)
    return {"fused_fwd": off_n + on_n + sum(f for f, _ in off_launches + on_launches),
            "fused_bwd": sum(b for _, b in off_launches + on_launches)}


# -- phase 8g: static analysis --------------------------------------------------------------
def _analyze_step(data, fused):
    """One ``mixed_fno_bf16`` Trainer step of ``FNO_DARCY`` (``fuse_spectral``
    None, fused on the card, or False) on phase 5's first batch: the loss
    and the stepped parameters."""
    import dataclasses

    from repro_torch.configs.fno_paper import FNO_DARCY
    from repro_torch.core.schedule import PrecisionSchedule
    from repro_torch.data import CachedDataset
    from repro_torch.models import init_fno
    from repro_torch.train import Trainer, TrainerConfig

    cfg = dataclasses.replace(FNO_DARCY, fuse_spectral=None if fused else False)
    net = init_fno(torch.Generator().manual_seed(SEED + 1), cfg, device="cpu")
    trainer = Trainer(loss_l2, net, TrainerConfig(
        total_steps=1, schedule=PrecisionSchedule.constant("mixed_fno_bf16")))
    hist = trainer.run(CachedDataset(data, TRAIN_BATCH, seed=SEED).batch_at, steps=1)
    torch.cuda.synchronize()
    return hist[0]["loss"], [p.detach().clone() for p in trainer.params.values()]


def analyze_phase(sc, data):
    """``repro_torch.analyze`` on the card (phase 8g of the module docstring).
    Returns the full-width runs' launches."""
    import dataclasses
    from collections import Counter

    from repro_torch.analyze import analyze_records, load_suppressions, partition, recording
    from repro_torch.analyze import kernels as akernels
    from repro_torch.analyze.__main__ import DEFAULT_SUPPRESSIONS, MODELS, run_dataflow
    from repro_torch.configs.fno_paper import FNO_DARCY
    from repro_torch.data import grf_2d
    from repro_torch.models import init_fno
    from repro_torch.precision import POLICIES, get_policy

    t0 = time.perf_counter()
    dev = torch.device("cuda", torch.cuda.current_device())
    findings = run_dataflow(sorted(POLICIES), list(MODELS), (False, True), True, dev)
    t_dataflow = time.perf_counter() - t0
    traces = akernels.trace_families(dev)
    findings += akernels.kernels_pass(dev, traces)
    plans = [(tr.where, la.name, akernels.plan_bytes(la), akernels.library_bytes(la))
             for tr in traces for la in tr.launches if akernels.plan_bytes(la) is not None]
    t_kernels = time.perf_counter() - t0 - t_dataflow

    policy = get_policy("mixed_fno_bf16")
    layers = FNO_DARCY.n_layers
    fields = list(grf_2d(torch.Generator().manual_seed(SEED + 70), TRAIN_GRID,
                         batch=MAX_BATCH).numpy()[:, None])
    zero_counts(sc)
    identical, records_by = {}, {}
    for path, fused in (("fused", True), ("staged", False)):
        cfg = dataclasses.replace(FNO_DARCY, fuse_spectral=None if fused else False)
        net = init_fno(torch.Generator().manual_seed(SEED), cfg)
        y0, _, _, _ = _serve_fields(sc, net, fields, None, policy)
        loss0, params0 = _analyze_step(data, fused)
        with recording() as rec:
            y1, _, _, _ = _serve_fields(sc, net, fields, None, policy)
            n_serve = len(rec.records)
            loss1, params1 = _analyze_step(data, fused)
        findings += analyze_records(rec.records, policy, f"FNO_DARCY/{policy.name}/{path}")
        identical[path] = (all(np.array_equal(a, b) for a, b in zip(y0, y1, strict=True))
                           and loss0 == loss1
                           and all(torch.equal(a, b) for a, b in zip(params0, params1,
                                                                     strict=True)))
        want = ({"serve": {"spectral_fused_fwd"},
                 "train": {"spectral_fused_fwd", "spectral_fused_bwd"}} if fused else
                {"serve": {"spectral_contract_dense_fwd"},
                 "train": {"spectral_contract_dense_fwd", "spectral_contract_dense_bwd_x",
                           "spectral_contract_dense_bwd_w"}})
        got = {}
        for part, recs in (("serve", rec.records[:n_serve]), ("train", rec.records[n_serve:])):
            for i in range(layers):
                site = f"fno/layer{i}/spectral/contract"
                got[(part, site)] = {r.op for r in recs if r.kernel and r.site == site
                                     and r.cast_to == torch.bfloat16}
                if got[(part, site)] != want[part]:
                    fail(f"analyze: {path} {part} records at {site} round to bf16 through "
                         f"{sorted(got[(part, site)])}, want {sorted(want[part])}")
        records_by[path] = {
            "kernel": dict(Counter(r.op for r in rec.records if r.kernel)),
            "backward_aten": sum(1 for r in rec.records if r.backward and not r.kernel),
            "backward_kernel": sum(1 for r in rec.records if r.backward and r.kernel),
            "ops": len(rec.records)}
    torch.cuda.synchronize()
    full = counts(sc)

    active, suppressed = partition(findings, load_suppressions(DEFAULT_SUPPRESSIONS))
    errors = [f for f in active if f.severity == "error"]
    mismatched = [p for p in plans if p[2] != p[3]]
    optin = getattr(torch.cuda.get_device_properties(dev), "shared_memory_per_block_optin", None)
    emit("analyze", seconds=time.perf_counter() - t0, dataflow_seconds=t_dataflow,
         kernels_seconds=t_kernels,
         findings=dict(Counter(f"{f.pass_name}/{f.check}/{f.severity}" for f in active)),
         suppressed=dict(Counter(f"{f.pass_name}/{f.check}" for f in suppressed)),
         errors=[f.to_json() for f in errors[:10]], records=records_by,
         kernel_traces=len(traces),
         kernel_launches=dict(Counter(la.name for tr in traces for la in tr.launches)),
         plans_compared=len(plans), plan_mismatches=mismatched[:10],
         smem_limit=sc.SMEM_LIMIT, smem_optin=optin, bit_identical=identical,
         launches=full)
    if errors:
        fail(f"analyze: {len(errors)} unsuppressed error(s), e.g. {errors[0]}")
    if not plans or mismatched:
        fail(f"analyze: {len(mismatched)} of {len(plans)} plans differ from the library's "
             f"export, e.g. {mismatched[:3]}")
    if not all(identical.values()):
        fail(f"analyze: results with the recorder differ from those without: {identical}")
    if any(records_by[p]["backward_kernel"] == 0 or records_by[p]["backward_aten"] == 0
           for p in records_by):
        fail(f"analyze: no backward op recorded on the device thread: {records_by}")
    return {"fwd": full["launches"], "bwd_x": full["launches_bwd_x"],
            "bwd_w": full["launches_bwd_w"], "fused_fwd": full["launches_fused_fwd"],
            "fused_bwd": full["launches_fused_bwd"]}


# -- phase 9 ------------------------------------------------------------------
def graph_ms(fn, sets, iters=40):
    """Device ms per call of ``fn``: ``iters`` calls cycling through
    ``sets`` captured as one CUDA graph (no host overhead between
    launches), replayed between CUDA events."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for args in sets:     # warm-up outside the capture
            fn(*args)
    torch.cuda.current_stream().wait_stream(s)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for k in range(iters):
            fn(*sets[k % len(sets)])
    graph.replay()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    reps = 5
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * iters)


def _bound(nbytes, flops, half_flops=0):
    """The least time for ``nbytes`` of memory traffic and ``flops``
    operations, of which ``half_flops`` multiply two bf16 or two fp16
    operands into f32 sums (the tensor cores' work) and the rest take f32
    operands (the CUDA cores' work)."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    flops_ms = ((flops - half_flops) / F32_FLOP_PER_S + half_flops / HALF_FLOP_PER_S) * 1e3
    return {"bytes": nbytes, "flops": flops, "half_flops": half_flops,
            "bytes_ms": bytes_ms, "flops_ms": flops_ms,
            "bound_ms": max(bytes_ms, flops_ms),
            "bound_by": "bytes" if bytes_ms >= flops_ms else "operations"}


def timing_phase(sc, max_err, launches):
    """Each kernel at the path's shape in its two modes on the path (bf16
    cast and bf16 output/cotangent: mixed_fno_bf16; no cast and f32: amp
    and full), beside its bound, its plain version and one torch.einsum
    call on complex64.  Returns the kernels line's entries (bf16 mode)."""
    B, I, O, M = PATH_SHAPE
    flops = 8 * B * I * O * M
    # 4 operand sets of ~40 MB each: consecutive calls find their operands
    # outside the 50 MB L2, as the paths do
    sets = [operands(PATH_SHAPE, 100 + k) for k in range(4)]
    csets = [(torch.complex(xr, xi), torch.complex(wr, wi)) for xr, xi, wr, wi in sets]
    rows = {"fwd": {}, "bwd_x": {}, "bwd_w": {}}
    for cast_to, dt in ((torch.bfloat16, torch.bfloat16), (None, torch.float32)):
        gsets = [cotangent(PATH_SHAPE, dt, 200 + k) for k in range(4)]
        full = [(*ops, *g) for ops, g in zip(sets, gsets)]
        size = torch.empty((), dtype=dt).element_size()
        x_b, w_b, g_b = 4 * 2 * B * I * M, 4 * 2 * I * O * M, size * 2 * B * O * M
        runs = {
            "fwd": (lambda xr, xi, wr, wi, gr, gi, c=cast_to, o=dt:
                    sc.spectral_contract_dense(xr, xi, wr, wi, cast_to=c, out_dtype=o),
                    lambda xr, xi, wr, wi, gr, gi, c=cast_to, o=dt:
                    sc.spectral_contract_plain(xr, xi, wr, wi, cast_to=c, out_dtype=o),
                    x_b + w_b + g_b),
            "bwd_x": (lambda xr, xi, wr, wi, gr, gi, c=cast_to:
                      sc._launch_bwd_x(gr, gi, wr, wi, c),
                      lambda xr, xi, wr, wi, gr, gi, c=cast_to:
                      sc.spectral_contract_bwd_x_plain(gr, gi, wr, wi, cast_to=c),
                      g_b + w_b + x_b),
            "bwd_w": (lambda xr, xi, wr, wi, gr, gi, c=cast_to:
                      sc._launch_bwd_w(xr, xi, gr, gi, c),
                      lambda xr, xi, wr, wi, gr, gi, c=cast_to:
                      sc.spectral_contract_bwd_w_plain(xr, xi, gr, gi, cast_to=c),
                      x_b + g_b + w_b),
        }
        for name, (kernel, plain, nbytes) in runs.items():
            # under a bf16 cast every product is bf16 x bf16 with f32 sums
            rows[name][str(dt)] = {"ms": graph_ms(kernel, full),
                                   "plain_ms": graph_ms(plain, full),
                                   **_bound(nbytes, flops, flops if cast_to else 0)}
    gc = [torch.complex(*cotangent(PATH_SHAPE, torch.float32, 200 + k)) for k in range(4)]
    library = {
        "fwd": graph_ms(lambda x, w: torch.einsum("bim,iom->bom", x, w), csets),
        "bwd_x": graph_ms(lambda g, w: torch.einsum("bom,iom->bim", g, w.conj()),
                          [(g, w) for g, (_, w) in zip(gc, csets)]),
        "bwd_w": graph_ms(lambda x, g: torch.einsum("bim,bom->iom", x.conj(), g),
                          [(x, g) for g, (x, _) in zip(gc, csets)]),
    }
    meta = {
        "fwd": ("spectral_contract_dense_fwd", "spectral_contract.cu",
                "src/repro/kernels/spectral_contract.py:104"),
        "bwd_x": ("spectral_contract_dense_bwd_x", "spectral_contract_bwd.cu",
                  "src/repro/kernels/spectral_contract.py:136"),
        "bwd_w": ("spectral_contract_dense_bwd_w", "spectral_contract_bwd.cu",
                  "src/repro/kernels/spectral_contract.py:160"),
    }
    entries = []
    for key, modes in rows.items():
        for mode, t in modes.items():
            emit("kernel_time", kernel=key, shape=list(PATH_SHAPE), mode=mode,
                 library_ms=library[key], **t)
        t = modes[str(torch.bfloat16)]
        name, src, replaces = meta[key]
        entries.append({
            "name": name, "route": "cuda", "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": replaces, "launches": launches[key], "max_abs_err": max_err[key],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": library[key],
            "ms_f32_mode": modes[str(torch.float32)]["ms"]})
    return entries


def cp_timing_phase(sc, max_err, launches):
    """cp_fwd and cp_bwd at the TFNO path's shape in bf16 mode
    (mixed_fno_bf16) and f32 mode (amp, full), beside their bounds, their
    plain versions and, for the forward, one ``torch.einsum`` call on
    complex64 (no single PyTorch call computes the backward).  Returns the
    kernels line's entries (bf16 mode)."""
    B, I, O, R, M = CP_PATH_SHAPE
    # two complex contractions of 4 real FMAs per term over I and R, and the
    # mode scale (one complex product); the backward's five contractions
    # (t, du, dx, dU_i, dU_o) and its three complex products (u, dt, dW).
    # Of these, t = x·U_i (both) and du = g·U_o (cp_bwd) multiply two
    # operands at the operand dtype: half x half in a half mode.  In bf16
    # mode the kernels multiply the exact three-piece bf16 split of an f32
    # operand (cp_fwd's u; cp_bwd's dt in dx and dU_i, u in dU_o) by the
    # other: three half products a term on the tensor cores; the mode scale
    # (and cp_bwd's dt and dW terms) stay f32 products
    flops = {"cp_fwd": 8 * B * M * (I * R + R * O) + 6 * B * M * R,
             "cp_bwd": 8 * B * M * (3 * I * R + 2 * O * R) + 20 * B * M * R}
    tensor = {"cp_fwd": 8 * B * M * (I * R + 3 * R * O),
              "cp_bwd": 8 * B * M * (I * R + O * R) + 3 * 8 * B * M * (2 * I * R + O * R)}
    half_work = {"cp_fwd": (tensor["cp_fwd"] + 6 * B * M * R, tensor["cp_fwd"]),
                 "cp_bwd": (tensor["cp_bwd"] + 20 * B * M * R, tensor["cp_bwd"])}
    rows = {"cp_fwd": {}, "cp_bwd": {}}
    for dtype in (torch.bfloat16, torch.float32):
        # 8 operand sets (62 MB in bf16): consecutive calls find their
        # operands outside the 50 MB L2
        sets = [cp_operands(CP_PATH_SHAPE, dtype, 300 + k) for k in range(8)]
        size = torch.empty((), dtype=dtype).element_size()
        x_b, g_b = 2 * size * B * I * M, 2 * size * B * O * M
        f_b = 2 * size * (I * R + O * R + R * M)
        nbytes = {"cp_fwd": x_b + f_b + g_b, "cp_bwd": x_b + f_b + g_b + x_b + f_b}
        runs = {"cp_fwd": (lambda *o: sc._launch_cp_fwd(*o[:8]),
                           lambda *o: sc.spectral_contract_cp_plain(*o[:8])),
                "cp_bwd": (lambda *o: sc._launch_cp_bwd(*o),
                           lambda *o: sc.spectral_contract_cp_bwd_plain(*o))}
        for name, (kernel, plain) in runs.items():
            work = half_work[name] if size == 2 else (flops[name], 0)
            rows[name][str(dtype)] = {"ms": graph_ms(kernel, sets),
                                      "plain_ms": graph_ms(plain, sets),
                                      **_bound(nbytes[name], *work)}
    csets = [[torch.complex(o[2 * k], o[2 * k + 1]) for k in range(4)]
             for o in (cp_operands(CP_PATH_SHAPE, torch.float32, 300 + k) for k in range(8))]
    library = {
        "cp_fwd": graph_ms(lambda x, ui, uo, w: torch.einsum("bim,ir,rm,or->bom", x, ui, w, uo),
                           csets),
        "cp_bwd": None,
    }
    meta = {"cp_fwd": ("spectral_contract_cp_fwd", "src/repro/kernels/spectral_contract.py:337"),
            "cp_bwd": ("spectral_contract_cp_bwd", "src/repro/kernels/spectral_contract.py:349")}
    entries = []
    for key, modes in rows.items():
        for mode, t in modes.items():
            emit("kernel_time", kernel=key, shape=list(CP_PATH_SHAPE), mode=mode,
                 library_ms=library[key], **t)
        t = modes[str(torch.bfloat16)]
        name, replaces = meta[key]
        entries.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/spectral_contract_cp.cu",
            "replaces": replaces, "launches": launches[key], "max_abs_err": max_err[key],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": library[key],
            "ms_f32_mode": modes[str(torch.float32)]["ms"]})
    return entries


def ls_timing_phase(sc, max_err, launches):
    """ls_fwd, ls_bwd_x and ls_bwd_w at the SFNO path's shape in bf16 mode
    (mixed_fno_bf16), fp16 mode (mixed_fno_fp16) and f32 mode (amp, full),
    beside their bounds (each
    reads two operands once and writes one result: ~69 MB in bf16; 4.29
    GFLOP, half x half in bf16 mode), the bytes' achieved rate, their plain
    versions and one complex64 ``torch.einsum`` each.  Returns the kernels
    line's entries (bf16 mode)."""
    B, I, O, L, M = LS_PATH_SHAPE
    flops = 8 * B * I * O * L * M
    rows = {"ls_fwd": {}, "ls_bwd_x": {}, "ls_bwd_w": {}}
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        # 4 operand sets (276 MB in bf16): consecutive calls find their
        # operands outside the 50 MB L2
        sets = [ls_operands(LS_PATH_SHAPE, dtype, 400 + k) for k in range(4)]
        size = torch.empty((), dtype=dtype).element_size()
        x_b, w_b, g_b = 2 * size * B * I * L * M, 2 * size * I * O * L, 2 * size * B * O * L * M
        runs = {
            "ls_fwd": (lambda xr, xi, wr, wi, gr, gi: sc._launch_ls_fwd(xr, xi, wr, wi),
                       lambda xr, xi, wr, wi, gr, gi:
                       sc.spectral_contract_lshared_plain(xr, xi, wr, wi), x_b + w_b + g_b),
            "ls_bwd_x": (lambda xr, xi, wr, wi, gr, gi: sc._launch_ls_bwd_x(gr, gi, wr, wi),
                         lambda xr, xi, wr, wi, gr, gi:
                         sc.spectral_contract_lshared_bwd_x_plain(gr, gi, wr, wi),
                         g_b + w_b + x_b),
            "ls_bwd_w": (lambda xr, xi, wr, wi, gr, gi: sc._launch_ls_bwd_w(xr, xi, gr, gi),
                         lambda xr, xi, wr, wi, gr, gi:
                         sc.spectral_contract_lshared_bwd_w_plain(xr, xi, gr, gi),
                         x_b + g_b + w_b),
        }
        for name, (kernel, plain, nbytes) in runs.items():
            ms = graph_ms(kernel, sets)
            rows[name][str(dtype)] = {"ms": ms, "plain_ms": graph_ms(plain, sets),
                                      "achieved_gb_per_s": nbytes / ms / 1e6,
                                      **_bound(nbytes, flops, flops if size == 2 else 0)}
        del sets
    csets = [[torch.complex(o[2 * k], o[2 * k + 1]) for k in range(3)]
             for o in (ls_operands(LS_PATH_SHAPE, torch.float32, 400 + k) for k in range(4))]
    library = {
        "ls_fwd": graph_ms(lambda x, w, g: torch.einsum("bilm,iol->bolm", x, w), csets),
        "ls_bwd_x": graph_ms(lambda x, w, g: torch.einsum("bolm,iol->bilm", g, w.conj()),
                             csets),
        "ls_bwd_w": graph_ms(lambda x, w, g: torch.einsum("bilm,bolm->iol", x.conj(), g),
                             csets),
    }
    meta = {"ls_fwd": ("spectral_contract_ls_fwd", "src/repro/kernels/spectral_contract.py:546"),
            "ls_bwd_x": ("spectral_contract_ls_bwd_x",
                         "src/repro/kernels/spectral_contract.py:563"),
            "ls_bwd_w": ("spectral_contract_ls_bwd_w",
                         "src/repro/kernels/spectral_contract.py:580")}
    entries = []
    for key, modes in rows.items():
        for mode, t in modes.items():
            emit("kernel_time", kernel=key, shape=list(LS_PATH_SHAPE), mode=mode,
                 library_ms=library[key], **t)
        t = modes[str(torch.bfloat16)]
        name, replaces = meta[key]
        entries.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/spectral_contract_lshared.cu",
            "replaces": replaces, "launches": launches[key], "max_abs_err": max_err[key],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": library[key],
            "ms_fp16_mode": modes[str(torch.float16)]["ms"],
            "ms_f32_mode": modes[str(torch.float32)]["ms"]})
    return entries


def event_ms(fn, sets, iters):
    """Device ms per call of ``fn``: ``iters`` back-to-back calls cycling
    through ``sets`` between two CUDA events, after one warm call per set.
    The fused kernels are cooperative launches and are timed this way, not
    as a CUDA graph; at a few ms per call the host's launch time hides
    behind the device's."""
    for args in sets:
        fn(*args)
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for k in range(iters):
        fn(*sets[k % len(sets)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def fused_work(B, I, O, spatial, modes):
    """The fused layer's operations, from the shapes: ``(transform flops
    of one slab, contraction flops of a forward)``.  A slab's analysis and
    its synthesis take the same count.  The last axis goes first, over
    every row of the slab, then each other axis over the columns the later
    axes retain.  Each axis counts the fewer of two ways to transform it:
    the truncated DFT (a real-by-complex factor on the last axis, 4 flops
    per term; complex by complex on the others, 8) and a whole FFT at the
    conventional 5 N log2 N flops (2.5 N log2 N on the real last axis;
    Rader's algorithm keeps a prime N in this order), pruning left out."""
    from repro_torch.kernels.spectral_contract import fused_rows

    rows = fused_rows(spatial, modes)
    S = [int(v) for v in spatial]
    T = int(np.prod(S[:-1])) * min(4 * S[-1] * rows[-1], 2.5 * S[-1] * np.log2(S[-1]))
    for k in range(len(S) - 1):
        T += int(np.prod(S[:k])) * int(np.prod(rows[k + 1:])) * min(
            8 * S[k] * rows[k], 5 * S[k] * np.log2(S[k]))
    return float(T), 8 * B * I * O * int(np.prod(rows))


def fused_timing_phase(sc, max_err, launches):
    """fused_fwd and fused_bwd at the Darcy path's shape at 128² and 421²
    and at GINO_CAR's latent FNO (batch 4, 32³, modes 12³) in the five
    modes (``FUSED_TIMED``), beside their bounds (bytes: x, y and the f32 weight in
    the forward; x, g, dx, the weight and dw in the backward; operations:
    ``fused_work``'s transforms at the CUDA cores' f32 rate, the
    contraction's half x half products at the tensor cores' rate in the
    half modes), their plain versions, and the fused and the staged layer
    (``spectral_conv_apply`` under the mode's policy) forward and forward +
    backward.  Returns the kernels line's entries (bf16 mode at 128²)."""
    from repro_torch.core.spectral import init_spectral_weights, spectral_conv_apply
    from repro_torch.kernels.spectral_contract import fused_rows
    from repro_torch.precision import get_policy

    rows = {"fused_fwd": {}, "fused_bwd": {}}
    for B, I, O, spatial, modes, nsets, iters in FUSED_TIMED:
        shape = (B, I, O, spatial, modes)
        grid = spatial if len(spatial) == 3 else spatial[0]
        # 4 operand sets of 134 MB at 128² (x, g and the weight), 2 of 793 MB
        # at 421², 2 of 294 MB at GINO's 32³: consecutive calls find their
        # operands outside the L2
        sets = [fused_operands(shape, 500 + k) for k in range(nsets)]
        N, Mh = int(np.prod(spatial)), int(np.prod(fused_rows(spatial, modes)))
        T, C = fused_work(*shape)
        nbytes = {"fused_fwd": 4 * (B * I * N + B * O * N) + 8 * I * O * Mh,
                  "fused_bwd": 4 * (2 * B * I * N + B * O * N) + 16 * I * O * Mh}
        flops = {"fused_fwd": (B * I + B * O) * T + C, "fused_bwd": (2 * B * I + B * O) * T + 2 * C}
        contract = {"fused_fwd": C, "fused_bwd": 2 * C}
        params = {k: v.cuda().requires_grad_() for k, v in init_spectral_weights(
            I, O, modes, generator=torch.Generator().manual_seed(SEED + 9)).items()}
        lsets = [(x.detach().clone().requires_grad_(), g) for x, _, _, g in sets]
        for cast_to, sim_fmt in FUSED_MODES:
            mode = mode_name(cast_to, sim_fmt)
            policy = get_policy(FUSED_MODE_POLICY[mode])
            q = {"cast_to": cast_to, "sim_fmt": sim_fmt}
            runs = {
                "fused_fwd": (lambda x, wr, wi, _g, q=q, m=modes: sc._launch_fused_fwd(
                                  x, wr, wi, m, q["cast_to"], q["sim_fmt"]),
                              lambda x, wr, wi, _g, q=q, m=modes: sc.spectral_fused_plain(
                                  x, wr, wi, m, **q)),
                "fused_bwd": (lambda x, wr, wi, g, q=q, m=modes: sc._launch_fused_bwd(
                                  x, wr, wi, g, m, q["cast_to"], q["sim_fmt"]),
                              lambda x, wr, wi, g, q=q, m=modes: sc.spectral_fused_bwd_plain(
                                  x, wr, wi, g, m, **q)),
            }
            layer = {}
            for path, fuse in (("fused", True), ("staged", False)):
                def fwd(x, _g, fuse=fuse, policy=policy, p=params, m=modes):
                    with torch.no_grad():
                        return spectral_conv_apply(p, x, m, policy, fuse_spectral=fuse)

                def fwd_bwd(x, g, fuse=fuse, policy=policy, p=params, m=modes):
                    y = spectral_conv_apply(p, x, m, policy, fuse_spectral=fuse)
                    return torch.autograd.grad(y, [x, p["w_re"], p["w_im"]], g.to(y.dtype))

                layer[f"{path}_layer_fwd_ms"] = event_ms(fwd, lsets, iters)
                layer[f"{path}_layer_fwd_bwd_ms"] = event_ms(fwd_bwd, lsets, iters)
            for name, (kernel, plain) in runs.items():
                half = contract[name] if cast_to is not None else 0
                rows[name][(grid, mode)] = {
                    "ms": event_ms(kernel, sets, iters), "plain_ms": event_ms(plain, sets, iters),
                    **_bound(nbytes[name], flops[name], half), **layer}
        del sets, lsets, params
        torch.cuda.empty_cache()
    meta = {"fused_fwd": ("spectral_fused_fwd", "src/repro/kernels/spectral_contract.py:856"),
            "fused_bwd": ("spectral_fused_bwd", "src/repro/kernels/spectral_contract.py:890")}
    entries = []
    for key, by in rows.items():
        for (grid, mode), t in by.items():
            shape = ([GINO_BATCH, 64, 64, list(grid), [12, 12, 12]] if isinstance(grid, tuple)
                     else [8, 64, 64, [grid, grid], [32, 32]])
            emit("kernel_time", kernel=key, shape=shape, mode=mode,
                 timing="cuda events, back-to-back launches", library_ms=None, **t)
        t = by[(128, "bf16")]
        name, replaces = meta[key]
        entries.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/spectral_fused.cu",
            "replaces": replaces, "launches": launches[key], "max_abs_err": max_err[key],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None,
            "ms_f32_mode": by[(128, "f32")]["ms"], "ms_421_bf16": by[(421, "bf16")]["ms"],
            "ms_gino_32cubed_bf16": by[((32, 32, 32), "bf16")]["ms"],
            "bound_ms_gino_32cubed_bf16": by[((32, 32, 32), "bf16")]["bound_ms"],
            "staged_layer_fwd_ms": t["staged_layer_fwd_ms"],
            "staged_layer_fwd_bwd_ms": t["staged_layer_fwd_bwd_ms"]})
    return entries


# -- phase 10: the LM pool's RMSNorm and flash attention -------------------------------
def lm_operands(seed):
    """RMSNorm rows and weights, and causal attention q, k, v, on the card
    at each dtype: {(kind, tag, dtype): operands}."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    out = {}
    for dtype in LM_DTYPES:
        for N, D in RMS_SHAPES:
            out[("rms", D, dtype)] = (torch.randn(N, D, generator=g, device="cuda").to(dtype),
                                      (torch.rand(D, generator=g, device="cuda") + 0.5).to(dtype))
        for tag, BH, S, D in FLASH_SHAPES:
            out[("flash", tag, dtype)] = tuple(
                torch.randn(BH, S, D, generator=g, device="cuda").to(dtype) for _ in range(3))
    return out


def flash_rows_oracle(q, k, v, rows):
    """``flash_attention_ref`` (causal) of the query ``rows`` alone, in f32:
    the whole S x S oracle does not fit at 32k."""
    qf = q[:, rows].float()
    s = torch.matmul(qf, k.float().transpose(1, 2)) * (1.0 / q.shape[-1] ** 0.5)
    keep = rows[:, None] >= torch.arange(k.shape[1], device=q.device)[None, :]
    s = torch.where(keep[None], s, torch.tensor(-1e30, device=q.device))
    return torch.matmul(torch.softmax(s, dim=-1), v.float()).to(q.dtype)


def rms_check(got, want):
    """f32: 1e-6 relative per element; half: >= 99.9 % bit-equal, every
    element within one ulp of the dtype.  Returns the check's numbers."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    if want.dtype == torch.float32:
        rel = (err / (w.abs() + 1e-30)).max().item()
        return {"max_abs_err": err.max().item(), "max_rel_err": rel, "ok": rel <= 1e-6}
    a = want.abs()
    ulp = (torch.nextafter(a, torch.full_like(a, float("inf"))) - a).float()
    equal = (g == w).float().mean().item()
    worst = (err / ulp).max().item()
    return {"max_abs_err": err.max().item(), "bit_equal_share": equal, "max_ulps": worst,
            "ok": equal >= 0.999 and worst <= 1.0}


def sdpa_backend(q, k, v):
    """The backend ``scaled_dot_product_attention(is_causal=True)`` picks
    for these operands (PyTorch's own dispatch rule)."""
    from torch.nn.attention import SDPBackend

    return SDPBackend(torch._fused_sdp_choice(q, k, v, is_causal=True)).name


def lm_kernel_phase():
    """RMSNorm and flash attention, the reference's ``kernels.ops`` entry
    points, at the LM pool's shapes.  Their path: ``ops.rmsnorm`` and
    ``ops.flash_attention`` called once per shape and dtype, with the
    launch counts set to 0 just before and read just after.  Then each
    kernel against its plain version on the same inputs (RMSNorm: f32
    1e-6 relative per element, half >= 99.9 % bit-equal and within one
    ulp; flash attention: f32 1e-5 relative L2, half within 1/4 of the
    plain version's gap to the causal oracle on 256 query rows; RMSNorm
    also rerun bit for bit), a zeroed output checked to fail, and the
    times: the kernel and the library call (``F.rms_norm``,
    ``F.scaled_dot_product_attention(is_causal=True)``, top-left aligned
    like the reference's mask) beside each other, RMSNorm's as a CUDA
    graph and as eager calls, flash attention's with CUDA events, the
    plain versions with CUDA events, and flash attention's achieved
    TFLOP/s.  Returns the kernels line's entries (bf16 at the first
    shape)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import rmsnorm as rn

    torch.cuda.empty_cache()
    sets = lm_operands(SEED + 60)
    fa.launches_flash, rn.launches_rmsnorm = 0, 0
    for (kind, tag, dtype), ops_ in sets.items():
        if kind == "rms":
            y = ops.rmsnorm(ops_[0][None], ops_[1])
        else:
            y = ops.flash_attention(*(t[None] for t in ops_), causal=True)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(y.float()).all()) or y.shape[1:] != ops_[0].shape:
            fail(f"ops {kind} at {tag} {dtype}: output not finite or misshaped")
    launches = {"rms": rn.launches_rmsnorm, "flash": fa.launches_flash}
    emit("lm_launches", rmsnorm=launches["rms"], flash_attention=launches["flash"],
         calls_per_kernel=len(LM_DTYPES) * 2)
    if launches["rms"] != len(LM_DTYPES) * len(RMS_SHAPES) or \
            launches["flash"] != len(LM_DTYPES) * len(FLASH_SHAPES):
        fail(f"the LM path did not launch each kernel once per call: {launches}")

    rows = {}
    for (kind, tag, dtype), ops_ in sets.items():
        if kind == "rms":
            x, w = ops_
            N, D = x.shape
            got, want = rn.rmsnorm(x, w), rn.rmsnorm_plain(x, w)
            check = {**rms_check(got, want),
                     "plan": rn.rmsnorm_plan(D, x.dtype, w.dtype)._asdict()}
            rerun = bool(torch.equal(got, rn.rmsnorm(x, w)))
            check.update(rerun_bit_identical=rerun, ok=check["ok"] and rerun)
            zero_ok = rms_check(torch.zeros_like(want), want)["ok"]
            size = x.element_size()
            bound = _bound(2 * N * D * size + D * size, 3 * N * D)

            def library(x, w, D=D):
                return F.rms_norm(x, (D,), w, 1e-6)

            # a CUDA graph leaves the wrapper's host path out; back-to-back
            # eager calls keep it in
            t = {"ms": graph_ms(rn.rmsnorm, [(x, w)], 20),
                 "eager_ms": event_ms(rn.rmsnorm, [(x, w)], 20),
                 "plain_ms": event_ms(rn.rmsnorm_plain, [(x, w)], 5),
                 "library_ms": graph_ms(library, [(x, w)], 20),
                 "library_eager_ms": event_ms(library, [(x, w)], 20)}
            timing = "cuda graph of 20 launches; eager: cuda events, back-to-back calls"
            shape = [N, D]
        else:
            q, k, v = ops_
            BH, S, D = q.shape
            got = fa.flash_attention(q, k, v, causal=True)
            plain = fa.flash_attention_plain(q, k, v, causal=True)
            torch.cuda.synchronize()
            pick = torch.linspace(0, S - 1, FLASH_ORACLE_ROWS, device="cuda").long()
            oracle = flash_rows_oracle(q, k, v, pick)
            err_all = rel_l2_dev(got, plain)
            gap = rel_l2_dev(plain[:, pick], oracle)
            if dtype == torch.float32:
                err, limit = err_all, 1e-5
            else:
                err, limit = rel_l2_dev(got[:, pick], plain[:, pick]), 0.25 * gap
            check = {"rel_l2": err, "limit": limit, "ok": err <= limit,
                     "rel_l2_all_rows": err_all, "plain_gap_to_oracle_rows": gap,
                     "max_abs_err": (got.float() - plain.float()).abs().max().item()}
            zero_ok = 1.0 <= limit
            size = q.element_size()
            pairs = S * (S + 1) // 2           # causal (query, key) pairs, S = Sk
            flops = 4 * BH * D * pairs
            bound = _bound(4 * BH * S * D * size, flops, flops if size == 2 else 0)
            lib = [(q[None], k[None], v[None])]
            try:
                lib_ms = event_ms(lambda *a: F.scaled_dot_product_attention(*a, is_causal=True),
                                  lib, 2)
                backend = sdpa_backend(*lib[0])
            except RuntimeError as exc:   # no SDPA backend takes this shape and dtype
                lib_ms, backend = None, f"failed: {str(exc)[:120]}"
            ms = event_ms(lambda *a: fa.flash_attention(*a, causal=True), [ops_], 2)
            t = {"ms": ms, "achieved_tflop_per_s": flops / ms / 1e9,
                 "plain_ms": event_ms(lambda *a: fa.flash_attention_plain(*a, causal=True),
                                      [ops_], 1),
                 "library_ms": lib_ms, "library_backend": backend}
            timing = "cuda events, back-to-back launches"
            shape = [BH, S, S, D]
            del got, plain, oracle
        emit("lm_kernel_vs_plain", kernel=kind, shape=shape, config=str(tag),
             dtype=str(dtype), **check, zeroed_output_passes=zero_ok)
        if not check["ok"]:
            fail(f"{kind} at {tag} {dtype} disagrees with its plain version: {check}")
        if zero_ok:
            fail(f"{kind} at {tag} {dtype}: the check would accept a zeroed output")
        emit("kernel_time", kernel=kind, shape=shape, config=str(tag), mode=str(dtype),
             timing=timing, **t, **bound)
        rows[(kind, tag, dtype)] = {**t, **bound, "max_abs_err": check["max_abs_err"]}
        torch.cuda.empty_cache()
    del sets
    torch.cuda.empty_cache()

    meta = {"rms": ("rmsnorm_fwd", "rmsnorm.cu", "src/repro/kernels/rmsnorm.py:20",
                    RMS_SHAPES[0][1], RMS_SHAPES[1][1]),
            "flash": ("flash_attention_fwd", "flash_attention.cu",
                      "src/repro/kernels/flash_attention.py:28", FLASH_SHAPES[0][0],
                      FLASH_SHAPES[1][0])}
    entries = []
    for kind, (name, src, replaces, first, second) in meta.items():
        t = rows[(kind, first, torch.bfloat16)]
        entries.append({
            "name": name, "route": "cuda", "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": replaces, "launches": launches[kind],
            "max_abs_err": max(r["max_abs_err"] for (k, _, _), r in rows.items() if k == kind),
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "ms_f32_mode": rows[(kind, first, torch.float32)]["ms"],
            "ms_second_shape_bf16": rows[(kind, second, torch.bfloat16)]["ms"],
            **({"eager_ms": t["eager_ms"]} if "eager_ms" in t else {}),
            "bound_ms_second_shape_bf16": rows[(kind, second, torch.bfloat16)]["bound_ms"]})
    return entries


# -- phase 11: LM serving ----------------------------------------------------------------
def lm_cpu_twin(model):
    """The same weights as ``model`` (an LM or a Whisper) on the CPU."""
    from repro_torch.models.lm.model import load_tree

    return load_tree(type(model)(model.cfg),
                     {k: v.detach().cpu() for k, v in model.state_dict().items()},
                     torch.device("cpu"))


def lm_traffic(cfg, seed):
    """LM_REQUESTS seeded requests, prompts of LM_PROMPTS tokens and LM_NEW
    new tokens each; every fourth samples (T 0.8, top-k 50, top-p 0.95),
    the rest are greedy."""
    from repro_torch.serve import GREEDY, SamplingParams

    rng = np.random.RandomState(seed)
    lens = rng.randint(LM_PROMPTS[0], LM_PROMPTS[1] + 1, LM_REQUESTS)
    sampled = SamplingParams(temperature=0.8, top_k=50, top_p=0.95)
    return [([int(t) for t in rng.randint(1, cfg.vocab, n)], LM_NEW,
             sampled if i % 4 == 3 else GREEDY) for i, n in enumerate(lens)]


def lm_requests(traffic, uids=None, prompt_len=None):
    from repro_torch.serve import Request

    return [Request(uid=u, prompt=list(p[:prompt_len]), max_new_tokens=n, sampling=s)
            for u, (p, n, s) in enumerate(traffic) if uids is None or u in uids]


def lm_serve(engine, reqs):
    """Serve ``reqs`` to the end, timing each tick by kind on the host clock
    (a tick ends in the logits' copy to the host, which waits for the
    card) with the prompt tokens it consumed and the tokens it emitted.
    Returns uid -> generation and the ticks."""
    ticks = {"prefill": [], "decode": []}
    chunk, decode = engine._tick_chunk, engine._tick_decode

    def timed(kind, fn):
        def run():
            p0, g0 = engine._n_prompt_tokens, engine._n_generated
            t0 = time.perf_counter()
            out = fn()
            ticks[kind].append(((time.perf_counter() - t0) * 1e3,
                                engine._n_prompt_tokens - p0, engine._n_generated - g0))
            return out
        return run

    engine._tick_chunk, engine._tick_decode = timed("prefill", chunk), timed("decode", decode)
    try:
        done, _ = engine.run_until_done(reqs)
    finally:
        # back to the class's methods: no engine -> wrapper -> engine cycle
        # keeps a finished engine's KV cache alive on the card
        del engine._tick_chunk, engine._tick_decode
    if len(done) != len(reqs) or any(r.status != "done" for r in done):
        fail(f"LM serving: {sum(r.status == 'done' for r in done)} of {len(reqs)} requests done")
    return {r.uid: list(r.generated) for r in done}, ticks


def lm_rates(ticks):
    pre, dec = np.array(ticks["prefill"] or [(0, 0, 0)]), np.array(ticks["decode"] or [(0, 0, 0)])
    return {"prefill_ticks": len(ticks["prefill"]), "decode_ticks": len(ticks["decode"]),
            "prefill_tokens_per_s": float(pre[:, 1].sum() / (pre[:, 0].sum() / 1e3)),
            "decode_tokens_per_s": float(dec[:, 2].sum() / (dec[:, 0].sum() / 1e3)),
            "ms_per_prefill_tick": float(pre[:, 0].mean()),
            "ms_per_prefill_tick_median": float(np.median(pre[:, 0])),
            "ms_per_decode_tick": float(dec[:, 0].mean()),
            "ms_per_decode_tick_median": float(np.median(dec[:, 0]))}


def lm_same_bits(a, b, uids):
    return all(len(a.logits_for(u)) == len(b.logits_for(u))
               and all(np.array_equal(x, y) for x, y in zip(a.logits_for(u), b.logits_for(u),
                                                            strict=True)) for u in uids)


def lm_smollm_phase(card):
    """smollm-360m at full width through ``LMEngine`` under ``full`` and
    ``amp_bf16`` (phase 11 of the module docstring).  Returns the
    per-policy numbers."""
    from repro_torch.configs import get_config
    from repro_torch.models.lm import init_lm
    from repro_torch.precision import get_policy
    from repro_torch.serve import GREEDY, LMEngine

    cfg = get_config(LM_ARCH)
    t0 = time.perf_counter()
    model = init_lm(torch.Generator(device="cuda").manual_seed(SEED + 80), cfg)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    emit("lm_setup", arch=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
         heads=[cfg.n_heads, cfg.n_kv_heads, cfg.hd], d_ff=cfg.d_ff, vocab=cfg.vocab,
         params=n_params, param_bytes=4 * n_params, init_s=time.perf_counter() - t0)
    traffic = lm_traffic(cfg, SEED + 81)
    greedy = [u for u, (_, _, s) in enumerate(traffic) if s.temperature <= 0]
    # the chunk check takes the shortest greedy prompts; solo is the next one
    by_len = sorted(greedy, key=lambda u: len(traffic[u][0]))
    chunk_uids, solo_uid = set(by_len[:LM_CHUNK_CHECK]), by_len[LM_CHUNK_CHECK]
    rows = {}
    for name in LM_POLICIES:
        policy = get_policy(name)

        def engine(chunk=8, slots=LM_SLOTS, record=True, policy=policy):
            return LMEngine(model, cfg, n_slots=slots, max_len=LM_MAX_LEN, policy=policy,
                            prefill_chunk=chunk, seed=SEED, telemetry=True,
                            record_logits=record)

        # warm-up (cuBLAS handles, allocator), then the timed run
        lm_serve(engine(record=False), lm_requests(traffic, set(by_len[:2])))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # what earlier phases and the weights hold; the engine's own share
        # is the peak above it
        start = torch.cuda.memory_allocated()
        eng = engine()
        t0 = time.perf_counter()
        gens, ticks = lm_serve(eng, lm_requests(traffic))
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        stats = eng.stats()
        finite = all(np.isfinite(x).all() for u in gens for x in eng.logits_for(u))
        if not finite or stats["numerics"]["logits_nonfinite"]:
            fail(f"LM serving under {name}: non-finite logits")
        row = {"policy": name, "card": card, "requests": LM_REQUESTS, "slots": LM_SLOTS,
               "max_len": LM_MAX_LEN, "prefill_chunk": 8,
               "prompt_tokens": stats["prompt_tokens"],
               "tokens_generated": stats["tokens_generated"], **lm_rates(ticks),
               "wall_s": wall, "engine_tokens_per_s": stats["tokens_per_s"],
               "peak_memory_bytes": peak, "memory_at_start_bytes": start,
               "peak_above_start_bytes": peak - start, "weight_bytes": 4 * n_params,
               "kv_cache_bytes": sum(t.numel() * t.element_size() for t in eng.cache.values()),
               "logits_amax": stats["numerics"]["logits_amax"]}
        # chunk 1 against chunk 8 on the shortest greedy prompts
        one = engine(chunk=1)
        gens1, _ = lm_serve(one, lm_requests(traffic, chunk_uids))
        agree = sum(int(a == b) for u in chunk_uids
                    for a, b in zip(gens1[u], gens[u], strict=True))
        row["chunk1_vs_8_tokens_equal"] = [agree, LM_CHUNK_CHECK * LM_NEW]
        if name == "full":
            if any(gens1[u] != gens[u] for u in chunk_uids):
                fail(f"LM serving under full: chunk 1 and 8 differ ({agree} tokens equal)")
            solo = engine()
            gs, _ = lm_serve(solo, lm_requests(traffic, {solo_uid}))
            if gs[solo_uid] != gens[solo_uid]:
                fail("LM serving under full: a request solo differs from it batched")
            row["solo_vs_batched_logits_bit_identical"] = lm_same_bits(solo, eng, [solo_uid])
            again = engine()
            gens2, _ = lm_serve(again, lm_requests(traffic))
            rerun = gens2 == gens and lm_same_bits(again, eng, range(LM_REQUESTS))
            if not rerun:
                fail("LM serving under full: a rerun of the traffic is not bit-identical")
            row["rerun_bit_identical"] = rerun
            del again, solo
        del one, eng
        # one decode tick with every slot decoding, under the profiler
        prof_eng = engine(record=False)
        for r in lm_requests(traffic, set(range(LM_SLOTS)), prompt_len=LM_PROMPTS[0]):
            prof_eng.submit(r)
        while prof_eng.scheduler.depth or any(prof_eng.slot_pending[i]
                                              for i in range(LM_SLOTS)):
            prof_eng.tick()
        prof_eng.tick()
        prof = profiled(prof_eng.tick)
        row["decode_tick_profile"] = {k: prof[k] for k in ("wall_ms", "device_busy_ms",
                                                           "device_events", "idle_share", "top")}
        del prof_eng
        emit("lm_serve", **row)
        rows[name] = row

    # one request on the card against the same weights on the CPU
    cpu = lm_cpu_twin(model)
    rng = np.random.RandomState(SEED + 83)
    prompt = [int(t) for t in rng.randint(1, cfg.vocab, LM_PARITY[0])]
    got = {}
    for dev, net in (("cuda", model), ("cpu", cpu)):
        e = LMEngine(net, cfg, n_slots=1, max_len=LM_PARITY[0] + LM_PARITY[1],
                     prefill_chunk=8, record_logits=True, device=dev)
        gen, _ = lm_serve(e, lm_requests([(prompt, LM_PARITY[1], GREEDY)]))
        got[dev] = (gen[0], e.logits_for(0))
    errs = [rel_l2(a, b) for a, b in zip(got["cuda"][1], got["cpu"][1], strict=True)]
    emit("lm_card_vs_cpu", card=card, prompt=LM_PARITY[0], new_tokens=LM_PARITY[1],
         tokens_equal=got["cuda"][0] == got["cpu"][0], rel_l2_per_step=errs,
         limit=LM_CARD_CPU_TOL)
    if got["cuda"][0] != got["cpu"][0] or max(errs) > LM_CARD_CPU_TOL:
        fail(f"LM serving card vs CPU: tokens equal {got['cuda'][0] == got['cpu'][0]}, "
             f"rel L2 up to {max(errs):.3g} > {LM_CARD_CPU_TOL}")
    del model, cpu
    torch.cuda.empty_cache()
    return rows


def lm_pool_phase():
    """Every other decoder arch's SMOKE config on the card against the CPU
    (forward), decode against the card's own forward, and engine chunk
    agreement under ``full``; Whisper's SMOKE config: encode and 8 decode
    steps against the CPU."""
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.models import lm
    from repro_torch.serve import LMEngine, Request

    rows = []
    for k, arch in enumerate(a for a in ARCH_IDS if a not in (LM_ARCH, "whisper-large-v3")):
        cfg = get_config(arch, smoke=True)
        if cfg.moe_experts:
            # capacity drops depend on the dispatch batch (a 12-token forward
            # may drop a token one decode row keeps): no drops here
            cfg = dataclasses.replace(cfg, capacity_factor=8.0)
        model = lm.init_lm(torch.Generator().manual_seed(SEED + 90 + k), cfg)
        cpu = lm_cpu_twin(model)
        rng = np.random.RandomState(SEED + 90 + k)
        toks = torch.from_numpy(rng.randint(0, cfg.vocab, (2, 12)))
        pe = (torch.from_numpy((0.1 * rng.randn(2, cfg.n_patches, cfg.d_model)).astype(np.float32))
              if cfg.frontend == "vision_stub" else None)
        with torch.no_grad():
            card_l, _ = lm.lm_forward(model, toks.cuda(), cfg,
                                      patch_embeds=None if pe is None else pe.cuda())
            cpu_l, _ = lm.lm_forward(cpu, toks, cfg, patch_embeds=pe)
            fwd, _ = lm.lm_forward(model, toks.cuda(), cfg)
        cache = lm.init_cache(cfg, 2, 16)
        dec = []
        for t in range(toks.shape[1]):
            lg, cache = lm.lm_decode_step(model, cache, toks[:, t].cuda(), cfg)
            dec.append(rel_l2(lg.cpu(), fwd[:, t].cpu()))
        gens = {}
        for chunk in (1, 4):
            eng = LMEngine(model, cfg, n_slots=2, max_len=32, prefill_chunk=chunk)
            done, _ = eng.run_until_done([Request(uid=i, prompt=[int(x) for x in toks[0, :n]],
                                                  max_new_tokens=4)
                                          for i, n in enumerate((5, 11, 3))])
            gens[chunk] = {r.uid: r.generated for r in done}
        row = {"arch": arch, "forward_card_vs_cpu": rel_l2(card_l.cpu(), cpu_l),
               "decode_vs_forward": max(dec), "chunk1_eq_4": gens[1] == gens[4]}
        rows.append(row)
        if not torch.isfinite(card_l).all() or row["forward_card_vs_cpu"] > LM_SMOKE_TOL \
                or row["decode_vs_forward"] > LM_SMOKE_TOL or not row["chunk1_eq_4"]:
            fail(f"LM pool on the card: {row}")
        del model, cpu, cache
    cfg = get_config("whisper-large-v3", smoke=True)
    model = lm.init_whisper(torch.Generator().manual_seed(SEED + 99), cfg)
    cpu = lm_cpu_twin(model)
    rng = np.random.RandomState(SEED + 99)
    frames = torch.from_numpy((0.5 * rng.randn(2, 24, cfg.d_model)).astype(np.float32))
    toks = torch.from_numpy(rng.randint(0, cfg.vocab, (2, 8)))
    with torch.no_grad():
        mem = lm.whisper_encode(model, frames.cuda(), cfg)
        mem_cpu = lm.whisper_encode(cpu, frames, cfg)
    caches = (lm.init_whisper_cache(model, mem, cfg, 2),
              lm.init_whisper_cache(cpu, mem_cpu, cfg, 2))
    steps = []
    for t in range(8):
        a, _ = lm.whisper_decode_step(model, caches[0], toks[:, t].cuda(), cfg)
        b, _ = lm.whisper_decode_step(cpu, caches[1], toks[:, t], cfg)
        steps.append(rel_l2(a.cpu(), b))
    whisper = {"encode_card_vs_cpu": rel_l2(mem.cpu(), mem_cpu),
               "decode_card_vs_cpu": max(steps)}
    if max(whisper.values()) > LM_SMOKE_TOL:
        fail(f"Whisper on the card: {whisper}")
    emit("lm_pool", archs=rows, whisper=whisper, limit=LM_SMOKE_TOL)
    del model, cpu, caches
    torch.cuda.empty_cache()


def lm_phase(sc, card):
    """Phase 11: LM serving.  No hand-written kernel lies on this path: the
    launch counts are set to 0 before it and must still read 0 after."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn

    t0 = time.perf_counter()
    zero_counts(sc)
    fa.launches_flash, rn.launches_rmsnorm = 0, 0
    rows = lm_smollm_phase(card)
    lm_pool_phase()
    launched = {**counts(sc), "launches_rmsnorm": rn.launches_rmsnorm,
                "launches_flash": fa.launches_flash}
    if any(launched.values()):
        fail(f"the LM path launched a spectral, RMSNorm or flash kernel: {launched}")
    emit("lm_serving", card=card, seconds=time.perf_counter() - t0,
         kernel_launches=sum(launched.values()),
         **{name: {k: r[k] for k in ("prefill_tokens_per_s", "decode_tokens_per_s",
                                     "ms_per_prefill_tick", "ms_per_decode_tick",
                                     "peak_memory_bytes", "peak_above_start_bytes")}
            | {"decode_tick_idle_share": r["decode_tick_profile"]["idle_share"]}
            for name, r in rows.items()})


# -- phase 12: paged LM serving ------------------------------------------------------------
def paged_traffic(cfg, seed):
    """Traffic (b): PAGED_REQUESTS greedy requests, each one seeded
    PAGED_SYSTEM-token system prompt followed by PAGED_OWN tokens of its own,
    PAGED_NEW new tokens each."""
    from repro_torch.serve import GREEDY

    rng = np.random.RandomState(seed)
    system = [int(t) for t in rng.randint(1, cfg.vocab, PAGED_SYSTEM)]
    lens = rng.randint(PAGED_OWN[0], PAGED_OWN[1] + 1, PAGED_REQUESTS)
    return [(system + [int(t) for t in rng.randint(1, cfg.vocab, n)], PAGED_NEW, GREEDY)
            for n in lens]


def null_block_untouched(engine, tag):
    c = engine.cache
    bad = [k for k in ("k", "v", "c_kv", "k_rope") if k in c and bool(c[k][:, 0].any())]
    if not bool((c["kv_pos"][:, 0] == -1).all()) or bad:
        fail(f"paged LM serving ({tag}): the null block was written ({bad or 'kv_pos'})")


@contextlib.contextmanager
def block_trace(engine):
    """Wrap ``engine._prepare_writes`` to follow, tick by tick, the blocks
    this traffic would hold at once without sharing (each live slot's rows
    written so far, in whole blocks: no ring wraps at max_len) and the
    internal fragmentation of the slot-mapped blocks after the tick's
    writes.  Yields the dict the numbers land in; the wrapper goes on exit
    (no engine -> wrapper -> engine cycle keeps a KV cache alive)."""
    trace = {"unshared_peak_blocks": 0, "fragmentation": []}
    prepare = engine._prepare_writes

    def wrapped(slot_rows):
        prepare(slot_rows)
        bs = engine.block_size
        need = sum(max(rows) // bs + 1 for _, rows in slot_rows)
        used = sum(max(rows) + 1 for _, rows in slot_rows)
        trace["unshared_peak_blocks"] = max(trace["unshared_peak_blocks"], need)
        trace["fragmentation"].append(1.0 - used / (int((engine._bt > 0).sum()) * bs))

    engine._prepare_writes = wrapped
    try:
        yield trace
    finally:
        del engine._prepare_writes


def trace_summary(trace):
    frag = trace["fragmentation"] or [0.0]
    return {"unshared_peak_blocks": trace["unshared_peak_blocks"],
            "fragmentation_mean": float(np.mean(frag)), "fragmentation_max": float(max(frag))}


def decode_profile(make, traffic):
    """One decode tick of a fresh engine with all LM_SLOTS slots decoding,
    under the profiler."""
    eng = make(False)
    for r in lm_requests(traffic, set(range(LM_SLOTS)), prompt_len=LM_PROMPTS[0]):
        eng.submit(r)
    while eng.scheduler.depth or any(eng.slot_pending[i] for i in range(LM_SLOTS)):
        eng.tick()
    eng.tick()
    prof = profiled(eng.tick)
    return {k: prof[k] for k in ("wall_ms", "device_busy_ms", "device_events", "idle_share",
                                 "top")}


def timed_serve(make, reqs):
    """(generations, ticks, engine, peak bytes, bytes at the engine's start,
    the paged engine's block trace) of one engine serving ``reqs``."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    eng = make(True)
    with block_trace(eng) if hasattr(eng, "pool") else contextlib.nullcontext() as trace:
        gens, ticks = lm_serve(eng, reqs)
    return gens, ticks, eng, torch.cuda.max_memory_allocated(), start, trace


def lm_paged_phase(sc, card):
    """Phase 12: ``PagedLMEngine`` at smollm-360m's full width against
    ``LMEngine`` (phase 12 of the module docstring).  No hand-written kernel
    lies on this path: the launch counts are set to 0 before it and must
    still read 0 after."""
    import asyncio

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.models.lm import init_lm
    from repro_torch.precision import get_policy
    from repro_torch.serve import AsyncServeFrontend, LMEngine, PagedLMEngine, Request

    t0 = time.perf_counter()
    zero_counts(sc)
    fa.launches_flash, rn.launches_rmsnorm = 0, 0
    cfg = get_config(LM_ARCH)
    # phase 11's seeded weights
    model = init_lm(torch.Generator(device="cuda").manual_seed(SEED + 80), cfg)
    traffic = lm_traffic(cfg, SEED + 81)
    shared = paged_traffic(cfg, SEED + 84)
    rows = {}

    def makers(policy, **paged_kw):
        def dense(record):
            return LMEngine(model, cfg, n_slots=LM_SLOTS, max_len=LM_MAX_LEN, policy=policy,
                            prefill_chunk=8, seed=SEED, telemetry=True, record_logits=record)

        def paged(record):
            return PagedLMEngine(model, cfg, n_slots=LM_SLOTS, max_len=LM_MAX_LEN,
                                 policy=policy, prefill_chunk=8, seed=SEED, telemetry=True,
                                 record_logits=record, block_size=PAGED_BLOCK, **paged_kw)
        return dense, paged

    # (a) phase 11's traffic, prefix sharing off: bit for bit against dense
    for name in LM_POLICIES:
        policy = get_policy(name)
        dense, paged = makers(policy, prefix_sharing=False)
        lm_serve(paged(False), lm_requests(traffic, {0, 1}))   # warm-up
        row = {"policy": name, "card": card, "requests": LM_REQUESTS, "block_size": PAGED_BLOCK}
        runs = {}
        for tag, make in (("dense", dense), ("paged", paged)):
            gens, ticks, eng, peak, start, trace = timed_serve(make, lm_requests(traffic))
            runs[tag] = (gens, eng, trace)
            row[tag] = {**lm_rates(ticks), "peak_memory_bytes": peak,
                        "peak_above_start_bytes": peak - start,
                        "cache_bytes": sum(t.numel() * t.element_size()
                                           for t in eng.cache.values())}
        (dg, de, _), (pg, pe, trace) = runs["dense"], runs["paged"]
        st = pe.stats()["paged"]
        row["pool"] = {**{k: st[k] for k in ("num_blocks", "peak_live_blocks", "cow_copies",
                                             "allocs", "frees")}, **trace_summary(trace)}
        row["tokens_equal"] = pg == dg
        row["logits_bit_identical"] = lm_same_bits(pe, de, range(LM_REQUESTS))
        null_block_untouched(pe, f"a, {name}")
        del runs, de, pe
        if not (row["tokens_equal"] and row["logits_bit_identical"]):
            fail(f"paged LM serving under {name}: not bit-identical to LMEngine "
                 f"(tokens equal {row['tokens_equal']})")
        row["dense"]["decode_tick_profile"] = decode_profile(dense, traffic)
        row["paged"]["decode_tick_profile"] = decode_profile(paged, traffic)
        emit("lm_paged_vs_dense", **row)
        rows[name] = row

    # (b) a shared 256-token system prompt, prefix sharing on
    agree = {}
    for name in LM_POLICIES:
        dense, paged = makers(get_policy(name))
        d_eng, p_eng = dense(True), paged(True)
        dg, _ = lm_serve(d_eng, lm_requests(shared))
        t1 = time.perf_counter()
        with block_trace(p_eng) as trace:
            pg, pticks = lm_serve(p_eng, lm_requests(shared))
        wall = time.perf_counter() - t1
        ps, ds = p_eng.stats(), d_eng.stats()
        errs = [rel_l2(b, a) for u in range(PAGED_REQUESTS)
                for a, b in zip(d_eng.logits_for(u), p_eng.logits_for(u), strict=True)]
        equal = sum(int(a == b) for u in dg for a, b in zip(dg[u], pg[u], strict=True))
        agree[name] = [equal, PAGED_REQUESTS * PAGED_NEW]
        prefix = ps["paged"]["prefix"]
        row = {"policy": name, "card": card, "requests": PAGED_REQUESTS,
               "system_tokens": PAGED_SYSTEM, "prompt_tokens": ps["prompt_tokens"],
               "dense_prompt_tokens": ds["prompt_tokens"], "prefix": prefix,
               "peak_live_blocks": ps["paged"]["peak_live_blocks"],
               "cow_copies": ps["paged"]["cow_copies"], **trace_summary(trace),
               "tokens_equal": agree[name],
               "max_rel_l2": max(errs), "wall_s": wall, **lm_rates(pticks)}
        emit("lm_paged_prefix", **row)
        null_block_untouched(p_eng, f"b, {name}")
        if name == "full":
            shared_gens = pg
            if prefix["hits"] < PAGED_REQUESTS // 2 \
                    or ps["prompt_tokens"] > ds["prompt_tokens"] - 8 * PAGED_SYSTEM \
                    or row["peak_live_blocks"] >= row["unshared_peak_blocks"] \
                    or pg != dg or max(errs) > LM_SMOKE_TOL:
                fail(f"paged LM serving, shared prefix under full: {row}")
        del d_eng, p_eng

    # (c) copy-on-write of a running slot's forked block, against dense
    prompt, _, _ = traffic[0]
    prompt = prompt[:64]
    policy = get_policy("full")
    out = {}
    for tag in ("dense", "paged"):
        kw = dict(n_slots=1, max_len=LM_MAX_LEN, policy=policy, prefill_chunk=8,
                  record_logits=True)
        eng = (LMEngine(model, cfg, **kw) if tag == "dense"
               else PagedLMEngine(model, cfg, block_size=PAGED_BLOCK, **kw))
        req = Request(uid=0, prompt=list(prompt), max_new_tokens=8)
        eng.submit(req)
        for _ in range(5):          # 40 of 64 prompt tokens: the next chunk writes block 2
            eng.tick()
        if tag == "paged":
            forked = int(eng._bt[0, 2])
            eng.pool.fork(forked)
        while req.status != "done":
            eng.tick()
        out[tag] = (req.generated, eng)
    pe, de = out["paged"][1], out["dense"][1]
    cow = {"cow_copies": pe.pool.cow_copies, "block_rehomed": int(pe._bt[0, 2]) != forked,
           "tokens_equal": out["paged"][0] == out["dense"][0],
           "logits_bit_identical": lm_same_bits(pe, de, [0])}
    null_block_untouched(pe, "c")
    emit("lm_paged_cow", card=card, **cow)
    if not (cow["cow_copies"] == 1 and cow["block_rehomed"] and cow["tokens_equal"]
            and cow["logits_bit_identical"]):
        fail(f"paged LM serving, copy-on-write: {cow}")
    del out, pe, de

    # (d) traffic (b) through the async frontend, a 250 ms deadline each
    eng = PagedLMEngine(model, cfg, n_slots=LM_SLOTS, max_len=LM_MAX_LEN, policy=policy,
                        prefill_chunk=8, seed=SEED, block_size=PAGED_BLOCK)
    front = AsyncServeFrontend(eng)
    reqs = lm_requests(shared)

    async def serve_all():
        return await asyncio.gather(*[front.submit_async(r, deadline_ms=PAGED_DEADLINE_MS)
                                      for r in reqs])

    done = asyncio.run(serve_all())
    metrics = front.metrics()
    ttft = sorted(r["ttft_ms"] for r in front.records)
    metrics["ttft_ms"] = {"p50": ttft[len(ttft) // 2], "max": ttft[-1]}
    emit("lm_paged_frontend", card=card, deadline_ms=PAGED_DEADLINE_MS, **metrics)
    null_block_untouched(eng, "d")
    if metrics["completed"] != PAGED_REQUESTS \
            or {r.uid: r.generated for r in done} != shared_gens:
        fail(f"paged LM serving through the frontend: {metrics}")
    del eng, front, model
    torch.cuda.empty_cache()

    launched = {**counts(sc), "launches_rmsnorm": rn.launches_rmsnorm,
                "launches_flash": fa.launches_flash}
    if any(launched.values()):
        fail(f"the paged LM path launched a spectral, RMSNorm or flash kernel: {launched}")
    emit("lm_paged_serving", card=card, seconds=time.perf_counter() - t0,
         kernel_launches=sum(launched.values()), prefix_tokens_equal=agree,
         **{name: {tag: {k: r[tag][k] for k in ("prefill_tokens_per_s", "decode_tokens_per_s",
                                                 "ms_per_prefill_tick", "ms_per_decode_tick",
                                                 "peak_memory_bytes", "peak_above_start_bytes")}
                    | {"decode_tick_idle_share": r[tag]["decode_tick_profile"]["idle_share"]}
                    for tag in ("dense", "paged")}
            for name, r in rows.items()})


def serve_smoke_phase(card):
    """``repro_torch.launch.serve_smoke`` on the card (its smoke configs):
    the three engines' stats in one line; its artifact goes to build/."""
    import contextlib
    import io

    from repro_torch.launch import serve_smoke

    t0 = time.perf_counter()
    out = ROOT / "build" / "chip_smoke_serve_smoke.json"
    with contextlib.redirect_stdout(io.StringIO()):
        rec = serve_smoke.main(["--out", str(out)])
    keys = ("engine", "device", "ticks", "completed", "failed", "tokens_per_s", "fields_per_s",
            "prompt_tokens", "tokens_generated")
    emit("serve_smoke", card=card, seconds=time.perf_counter() - t0, artifact=str(out),
         **{k: {f: v["stats"][f] for f in keys if f in v["stats"]}
            | ({"prefix": v["stats"]["paged"]["prefix"]} if "paged" in v["stats"] else {})
            | ({"memo": v["stats"]["memo"]} if "memo" in v["stats"] else {})
            for k, v in rec.items()})

# -- phase 13: distribution ----------------------------------------------------------
def _bits_equal(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def dist_fno(sc, card, mesh, darcy):
    """13(b): FNO_DARCY's data-parallel step on the one-rank mesh against
    the same step off the mesh; then one step with the bf16-compressed
    all-reduce.  Returns the fused kernels' launches of the mesh run."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs.fno_paper import FNO_DARCY
    from repro_torch.dist import distribute, fno_param_specs
    from repro_torch.launch.steps import build_fno_train_step, fno_batch_specs
    from repro_torch.models import init_fno
    from repro_torch.optim import AdamW
    from repro_torch.optim.grad_comm import make_dp_allreduce
    from repro_torch.precision import get_policy

    policy = get_policy(DIST_FNO_POLICY)
    B = DIST_FNO_BATCH
    batch = {"x": torch.from_numpy(darcy["a"][:B]).cuda(),
             "y": torch.from_numpy(darcy["u"][:B]).cuda()}
    opt = AdamW(lr=1e-3)

    def fresh():
        return init_fno(torch.Generator().manual_seed(SEED + 130), FNO_DARCY)

    def placed():
        model = fresh()
        distribute(model, mesh, fno_param_specs(model, mesh))
        with implicit_replication():
            state = opt.init(dict(model.named_parameters()))
        return model, state

    ref = fresh()
    ref_state = opt.init(dict(ref.named_parameters()))
    plain = build_fno_train_step(policy, None, opt)
    dbatch = distribute(batch, mesh, fno_batch_specs(batch, mesh))
    dp = build_fno_train_step(policy, mesh, opt)
    model, state = placed()
    plain_losses, dp_losses = [], []
    for _ in range(DIST_FNO_STEPS):
        ref, ref_state, loss = plain(ref, ref_state, batch)
        plain_losses.append(loss.detach())
    torch.cuda.synchronize()
    zero_counts(sc)
    for _ in range(DIST_FNO_STEPS):
        model, state, loss = dp(model, state, dbatch)
        dp_losses.append(loss.detach())
    # one step with the bf16-compressed all-reduce, its gradients caught
    # beside the f32 all-reduce of the same partial gradients
    caught = {}
    compressed = make_dp_allreduce(mesh, dtype=torch.bfloat16)
    uncompressed = make_dp_allreduce(mesh, dtype=torch.float32)

    def spy(grads):
        caught["f32"], caught["bf16"] = uncompressed(grads), compressed(grads)
        return caught["bf16"]

    cmodel, cstate = placed()
    _, _, closs = build_fno_train_step(policy, mesh, opt, grad_reduce=spy)(cmodel, cstate, dbatch)
    torch.cuda.synchronize()
    launched = {"fused_fwd": sc.launches_fused_fwd, "fused_bwd": sc.launches_fused_bwd}
    same_losses = all(_bits_equal(a, b) for a, b in zip(plain_losses, dp_losses, strict=True))
    ref_named = dict(ref.named_parameters())
    same_params = all(_bits_equal(p.full_tensor().detach(), ref_named[k].detach())
                      for k, p in model.named_parameters())
    # relative L2 a leaf, in the model's order (leaves whose gradient is 0 left out)
    rel = {k: float((caught["bf16"][k] - g).norm() / g.norm())
           for k, g in caught["f32"].items() if float(g.norm()) > 0}
    first = next(iter(rel))
    emit("dist_fno_train", card=card, config="FNO_DARCY", grid=TRAIN_GRID, batch=B,
         policy=DIST_FNO_POLICY, steps=DIST_FNO_STEPS, mesh=str(tuple(mesh.shape)),
         losses=[float(v) for v in dp_losses], plain_losses=[float(v) for v in plain_losses],
         losses_bit_equal=same_losses, params_bit_equal=same_params, launches=launched,
         compressed_loss=float(closs), first_grad=first,
         first_grad_rel_l2_bf16=rel[first], max_grad_rel_l2_bf16=max(rel.values()),
         bound_bf16=BF16_UNIT_ROUNDOFF,
         reference_claim_1e3_holds_first=rel[first] < 1e-3,
         reference_claim_1e3_holds_all=max(rel.values()) < 1e-3)
    if not (same_losses and same_params):
        fail("the data-parallel FNO step on the one-rank mesh differs from mesh=None")
    if not launched["fused_fwd"] or not launched["fused_bwd"]:
        fail(f"the data-parallel FNO step launched no fused kernel: {launched}")
    # the first gradient, and every one: a leaf cast to bf16 in the forward
    # has a gradient bf16 already holds exactly, so the first may read 0
    if not np.isfinite(float(closs)) or max(rel.values()) > BF16_UNIT_ROUNDOFF:
        fail(f"the bf16 all-reduce's gradients are up to {max(rel.values())} from f32's "
             f"(bound {BF16_UNIT_ROUNDOFF}; the first {rel[first]})")
    return launched


def dist_lm_serve(card, mesh):
    """13(c): LMEngine at smollm-360m's full width on the mesh against
    mesh=None, under full."""
    from repro_torch.configs import get_config
    from repro_torch.models.lm import init_lm
    from repro_torch.precision import get_policy
    from repro_torch.serve import GREEDY, LMEngine

    cfg = get_config(LM_ARCH)
    model = init_lm(torch.Generator(device="cuda").manual_seed(SEED + 131), cfg)
    rng = np.random.RandomState(SEED + 132)
    lens = rng.randint(DIST_LM_PROMPTS[0], DIST_LM_PROMPTS[1] + 1, DIST_LM_REQUESTS)
    traffic = [([int(t) for t in rng.randint(1, cfg.vocab, n)], DIST_LM_NEW, GREEDY)
               for n in lens]

    def engine(m):
        return LMEngine(model, cfg, n_slots=DIST_LM_REQUESTS, max_len=DIST_LM_MAX_LEN,
                        policy=get_policy("full"), mesh=m, seed=SEED, record_logits=True)

    plain, sharded = engine(None), engine(mesh)
    gens0, ticks0 = lm_serve(plain, lm_requests(traffic))
    gens1, ticks1 = lm_serve(sharded, lm_requests(traffic))
    uids = sorted(gens0)
    diff = max(float(np.abs(x - y).max()) for u in uids
               for x, y in zip(plain.logits_for(u), sharded.logits_for(u), strict=True))
    r0, r1 = lm_rates(ticks0), lm_rates(ticks1)
    emit("dist_lm_serve", card=card, arch=cfg.name, policy="full",
         requests=DIST_LM_REQUESTS, new_tokens=DIST_LM_NEW, mesh=str(tuple(mesh.shape)),
         tokens_equal=gens0 == gens1, logits_max_abs_diff=diff,
         logits_bit_equal=lm_same_bits(plain, sharded, uids),
         ms_per_decode_tick={"mesh_none": r0["ms_per_decode_tick"],
                             "mesh": r1["ms_per_decode_tick"]},
         ms_per_decode_tick_median={"mesh_none": r0["ms_per_decode_tick_median"],
                                    "mesh": r1["ms_per_decode_tick_median"]},
         ms_per_prefill_tick={"mesh_none": r0["ms_per_prefill_tick"],
                              "mesh": r1["ms_per_prefill_tick"]},
         decode_ticks=[r0["decode_ticks"], r1["decode_ticks"]])
    if gens0 != gens1:
        fail("LMEngine on the mesh generated other tokens than mesh=None")


def dist_lm_train(card, mesh):
    """13(d): build_train_step at smollm-360m, amp_bf16, on the mesh and off
    it: bit for bit, and the loss lower after the steps."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.data import lm_inputs
    from repro_torch.dist import batch_specs, distribute, lm_param_specs, use_mesh
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models.lm import init_lm
    from repro_torch.optim import AdamW
    from repro_torch.precision import get_policy

    cfg = get_config(LM_ARCH)
    B, S = DIST_TRAIN_BATCH, DIST_TRAIN_SEQ
    batch = {k: v.to(torch.int32).cuda()
             for k, v in lm_inputs(SEED + 133, 0, B, S, cfg.vocab).items()}
    opt = AdamW(lr=DIST_TRAIN_LR)
    bundle = build_train_step(cfg, ShapeConfig(f"train_{S}", S, B, "train"),
                              get_policy("amp_bf16"), opt)

    def fresh():
        return init_lm(torch.Generator(device="cuda").manual_seed(SEED + 134), cfg)

    p0 = fresh()
    s0 = opt.init(dict(p0.named_parameters()))
    losses0 = []
    t0 = time.perf_counter()
    for _ in range(DIST_TRAIN_STEPS):
        p0, s0, loss = bundle.step_fn(p0, s0, batch)
        losses0.append(loss)
    torch.cuda.synchronize()
    off_s = time.perf_counter() - t0
    p1 = fresh()
    distribute(p1, mesh, lm_param_specs(p1, mesh))
    losses1 = []
    t0 = time.perf_counter()
    with use_mesh(mesh), implicit_replication():
        s1 = opt.init(dict(p1.named_parameters()))
        dbatch = distribute(batch, mesh, batch_specs(batch, mesh))
        for _ in range(DIST_TRAIN_STEPS):
            p1, s1, loss = bundle.step_fn(p1, s1, dbatch)
            losses1.append(loss.full_tensor())
    torch.cuda.synchronize()
    on_s = time.perf_counter() - t0
    same_losses = all(_bits_equal(a, b) for a, b in zip(losses0, losses1, strict=True))
    n0 = dict(p0.named_parameters())
    same_params = all(_bits_equal(p.full_tensor().detach(), n0[k].detach())
                      for k, p in p1.named_parameters())
    vals = [float(v) for v in losses1]
    emit("dist_lm_train", card=card, arch=cfg.name, policy="amp_bf16", batch=B, seq=S,
         steps=DIST_TRAIN_STEPS, lr=DIST_TRAIN_LR, losses=vals,
         plain_losses=[float(v) for v in losses0], losses_bit_equal=same_losses,
         params_bit_equal=same_params, seconds_off_mesh=off_s, seconds_on_mesh=on_s)
    if not (same_losses and same_params):
        fail("the LM train step on the one-rank mesh differs from mesh=None")
    if not (all(np.isfinite(vals)) and vals[-1] < vals[0]):
        fail(f"the LM train step's loss did not fall: {vals}")
    del p0, p1, s0, s1
    gc.collect()
    torch.cuda.empty_cache()


def _cpu_env():
    """The environment of the phase's CPU subprocesses: this checkout's
    port, no card, one thread each (the card's process group is not
    theirs: each makes its own)."""
    import os

    return dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="",
                OMP_NUM_THREADS="1")


def core_split():
    """(main, side): this process's CPU cores in two halves.  The phase
    subprocesses run on the side half, and the timed phases keep the main
    half to themselves (on one core both share it)."""
    import os

    cores = sorted(os.sched_getaffinity(0))
    half = len(cores) // 2
    return set(cores[:half]) or set(cores), set(cores[half:])


def pin_threads(cores):
    """Every thread of this process, and so every one it starts later, on
    ``cores``."""
    import os

    for tid in os.listdir("/proc/self/task"):
        with contextlib.suppress(ProcessLookupError):     # a thread that has ended
            os.sched_setaffinity(int(tid), cores)


def _spawn(args, log, cores):
    """A niced CPU subprocess on ``cores``, in a session of its own (so it and
    every process it starts can be stopped together), stopped at exit."""
    import atexit
    import os

    def child():
        os.nice(19)
        os.sched_setaffinity(0, cores)

    proc = subprocess.Popen([sys.executable, "-m", *args], cwd=ROOT, env=_cpu_env(), stdout=log,
                            stderr=subprocess.STDOUT, start_new_session=True, preexec_fn=child)
    atexit.register(_kill, proc)
    return proc


def start_dryruns(cores):
    """13(e): the dry-runs, as the CLI runs them, on the host's CPU ``cores``;
    started with the script, so that they overlap every phase before 13."""
    procs = {}
    (ROOT / "build").mkdir(exist_ok=True)
    for name, args in DIST_DRYRUNS.items():
        out = ROOT / "build" / f"chip_smoke_{name}.json"
        if out.exists():
            out.unlink()
        log = open(ROOT / "build" / f"chip_smoke_{name}.log", "w")
        procs[name] = (_spawn((*args, "--out", str(out)), log, cores), out, log,
                       time.perf_counter())
    return procs


def start_parity(cores):
    """13(f): the four-rank parity checks on the host's CPU ``cores``."""
    log = open(ROOT / "build" / "chip_smoke_parity.log", "w")
    return {"parity": (_spawn(DIST_PARITY, log, cores), None, log, time.perf_counter())}


def _kill(proc):
    """Stop a phase subprocess and every process it started (its session)."""
    import os
    import signal

    if proc.poll() is None:
        with contextlib.suppress(ProcessLookupError):
            os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()


def _wait(proc, log, t0, limit):
    """(exit code or "timeout", seconds) of a phase subprocess; its log
    closed."""
    try:
        rc = proc.wait(timeout=max(1.0, limit - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        _kill(proc)
        rc = "timeout"
    log.close()
    return rc, time.perf_counter() - t0


def finish_dryruns(procs):
    for name, (proc, out, log, t0) in procs.items():
        rc, seconds = _wait(proc, log, t0, DIST_DRYRUN_TIMEOUT)
        if rc != 0:
            tail = (ROOT / "build" / f"chip_smoke_{name}.log").read_text()[-2000:]
            fail(f"the {name} dry-run exited {rc}: {tail}")
        recs = json.loads(out.read_text())
        emit(f"dist_{name}", seconds=seconds, cells=len(recs), torch=torch.__version__)
        for r in recs:
            mem = r.get("memory_analysis") or {}
            emit("dist_dryrun_cell", run=name, arch=r["arch"], shape=r["shape"], mesh=r["mesh"],
                 status=r["status"], seconds=r.get("compile_s"),
                 note="derived counts, not timings", torch=torch.__version__,
                 peak_gb_a_device=mem.get("peak_bytes", 0) / 1e9, fits_hbm=mem.get("fits_hbm"),
                 roofline=r.get("roofline"),
                 collective_bytes_by_kind=r.get("collective_bytes_by_kind"),
                 spectral_kernel=r.get("spectral_kernel"), error=r.get("error"))
        if any(r["status"] != "ok" for r in recs):
            fail(f"the {name} dry-run has a cell that is not ok")


def finish_parity(procs):
    proc, _, log, t0 = procs["parity"]
    rc, seconds = _wait(proc, log, t0, DIST_PARITY_TIMEOUT)
    text = (ROOT / "build" / "chip_smoke_parity.log").read_text()
    recs = [json.loads(line) for line in text.splitlines() if line.startswith("{")]
    for r in recs:
        emit("dist_parity", torch=torch.__version__, ranks=4, mesh="2x2", **r)
    emit("dist_parity_run", rc=rc, seconds=seconds, checks=len(recs))
    want = {(r.get("check"), r.get("arch")) for r in recs if r.get("ok")}
    need = {("cross_entropy", None)} | {("train_step", a) for a in DIST_PARITY[2::2]}
    if rc != 0 or not need <= want:
        fail(f"the four-rank parity checks failed (exit {rc}): {text[-2000:]}")


def dist_phase(sc, card, darcy, dryruns, cores):
    """Phase 13: distribution on the card's one-rank NCCL world; ``dryruns``
    from :func:`start_dryruns`, (f) on the CPU ``cores``."""
    import os

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_debug_mesh

    t0 = time.perf_counter()
    store = os.path.join(tempfile.mkdtemp(), "store")
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0, world_size=1)
    procs = dict(dryruns)
    try:
        mesh = make_debug_mesh(1, "cuda")
        emit("dist_setup", backend=str(dist.get_backend()), world=dist.get_world_size(),
             mesh=str(tuple(mesh.shape)), axes=list(mesh.mesh_dim_names),
             device_type=mesh.device_type)
        # the four-rank checks are CPU work on the host: they overlap the card's
        procs.update(start_parity(cores))
        launched = dist_fno(sc, card, mesh, darcy)
        dist_lm_serve(card, mesh)
        dist_lm_train(card, mesh)
        finish_parity(procs)
        finish_dryruns(dryruns)
    finally:
        for proc, _, log, _ in procs.values():
            _kill(proc)
            log.close()
        dist.destroy_process_group()
    emit("distribution", card=card, seconds=time.perf_counter() - t0, launches=launched)
    return launched


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    # the port comes from this checkout's src/; without it, fail before any output
    from repro_torch.kernels import spectral_contract as sc

    t0 = time.perf_counter()
    card = device_phase()
    main_cores, side_cores = core_split()
    emit("cpu_split", main=sorted(main_cores), side=sorted(side_cores))
    dryruns = start_dryruns(side_cores)     # 13(e), on the side cores meanwhile
    build_phase()
    pin_threads(main_cores)                 # the timed phases off the side cores
    max_err = {"fwd": kernel_phase(sc), **backward_kernel_phase(sc), **cp_kernel_phase(sc),
               **ls_kernel_phase(sc), **fused_kernel_phase(sc)}
    served, staged_serve = serve_phase(sc)
    trained, darcy, staged_train = train_phase(sc)
    fused_served, fused_serve = serve_phase(sc, fused=True)
    fused_trained, fused_train = fused_train_phase(sc, darcy)
    fused_vs_staged({"staged": staged_serve, "fused": fused_serve},
                    {"staged": staged_train, "fused": fused_train})
    tfno_served = tfno_serve_phase(sc)
    tfno_trained = tfno_train_phase(sc)
    swe = swe_data()
    sfno_served = sfno_serve_phase(sc, swe)
    sfno_trained = sfno_train_phase(sc, swe)
    swe_solver_parity(swe)
    del swe
    gino = gino_phase(sc)
    unet_phase()
    auto = autoprec_phase(sc, darcy)
    tuned = tune_phase(sc, darcy, card)
    observed = obs_phase(sc, darcy)
    analyzed = analyze_phase(sc, darcy)
    lm_phase(sc, card)
    lm_paged_phase(sc, card)
    serve_smoke_phase(card)
    distributed = dist_phase(sc, card, darcy, dryruns, side_cores)
    del darcy
    launches = {"fwd": served + trained["fwd"] + gino["fwd"] + auto["fwd"] + analyzed["fwd"],
                "bwd_x": trained["bwd_x"] + gino["bwd_x"] + auto["bwd_x"] + analyzed["bwd_x"],
                "bwd_w": trained["bwd_w"] + gino["bwd_w"] + auto["bwd_w"] + analyzed["bwd_w"],
                "cp_fwd": tfno_served + tfno_trained["cp_fwd"],
                "cp_bwd": tfno_trained["cp_bwd"], "ls_fwd": sfno_served + sfno_trained["ls_fwd"],
                "ls_bwd_x": sfno_trained["ls_bwd_x"], "ls_bwd_w": sfno_trained["ls_bwd_w"],
                "fused_fwd": fused_served + fused_trained["fused_fwd"] + gino["fused_fwd"]
                + tuned["fused_fwd"] + observed["fused_fwd"] + analyzed["fused_fwd"]
                + distributed["fused_fwd"],
                "fused_bwd": fused_trained["fused_bwd"] + gino["fused_bwd"]
                + tuned["fused_bwd"] + observed["fused_bwd"] + analyzed["fused_bwd"]
                + distributed["fused_bwd"]}
    emit("launches_by_path", serve={"fwd": served}, train=trained,
         fused_serve={"fused_fwd": fused_served}, fused_train=fused_trained,
         tfno_serve={"cp_fwd": tfno_served}, tfno_train=tfno_trained,
         sfno_serve={"ls_fwd": sfno_served}, sfno_train=sfno_trained, gino=gino,
         autoprec=auto, tune=tuned, obs=observed, analyze=analyzed, distribution=distributed)
    entries = (timing_phase(sc, max_err, launches) + cp_timing_phase(sc, max_err, launches)
               + ls_timing_phase(sc, max_err, launches)
               + fused_timing_phase(sc, max_err, launches) + lm_kernel_phase())
    emit("done", seconds=time.perf_counter() - t0)
    print(card, flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
