#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one stdout line (or a few) each; any failure raises and the
script exits non-zero without its last line:

1. environment: versions, the card's name and power limit, TF32 off, and
   the CUDA kernels built from the checkout's sources (a library for
   each dtype pair, the nvcc processes started together), with each
   instance's registers, shared memory and spill bytes (none allowed in
   the ring instances that compute in float64, the bf16-stored ones
   included, nor in either instance of the tensor-core forms
   (``bp.MMA_FORMS``: the seven kernels in bf16/float64, the float64
   ``cimmino_scatter`` and the three float64 sparse kernels;
   ``bp.BF16_MMA_FORMS``: the all-bf16 ``sparse_scatter``) at KC = 1, 2,
   4, 8, both forms of ``sparse_scatter``, all of which must be there;
   each of the seven rings present, and both instances of all seven
   kernels in the all-bf16 form);
2. kernel vs plain version on the card: ``apc_gather``/``apc_scatter``
   and ``cimmino_gather``/``cimmino_scatter`` against their plain PyTorch
   versions at ragged shapes and at the main path's shapes, and
   ``sparse_gather``/``sparse_cimmino_gather``/``sparse_scatter`` at the
   reference's sparse corner shapes (odd support width, p = 1, even), a
   support width of one chunk and a bit, and the sparse path's shapes;
   float64 and float32, each with its matrix in its own dtype and in
   bfloat16 (the mixed forms), and the all-bf16 sparse gathers, k =
   1..11, a batch row bit-identical to a k = 1 call; both instances of
   each of the four gathers, of
   ``apc_scatter``, of ``cimmino_scatter`` and of both forms of
   ``sparse_scatter`` (the ring, where its alignment admits the shape,
   and the row dot) against the plain version and bit-identical to each
   other (a bf16-stored scatter's ring to the ring on its matrix widened,
   as its row dot sums in another order; but the tensor-core forms, the
   bf16/float64 scatters among them, whose two instances issue the same
   products in one order: ring ≡ row dot);
3. the APC main path at full size: a 32768 x 16384 tall Gaussian system
   on 16 workers (float64), ``analyze``, then ``solve`` on the kernel
   path — error to x_true, one launch of each kernel per iteration, the
   history against the unfused path, and a bit-identical repeat;
4. APC ``solve_many`` with 8 right-hand sides through the same kernels;
5. block Cimmino and consensus on the same system: ``solve`` on the
   kernel path (exactly one launch of each of its kernels per iteration,
   at k = 1), the history against the unfused path, a bit-identical
   repeat, and Cimmino ``solve_many`` with 8 right-hand sides;
6. the paper's comparison: all eight solvers for the same number of
   iterations, with parameters from ONE spectral analysis (X and AᵀA);
   final residual, iters_to_tol, theoretical and measured rate;
7. the CLI entry point ``repro_torch.launch.solve`` in-process, for
   ``--method apc`` and ``--method cimmino``, both with ``--use-kernel``;
8. CUDA-event times of each dense kernel in each of its forms
   (float64, float32, bf16/float64, bf16/float32), timed in turns beside
   each form's bound: the float64 form's plain version, one torch.matmul
   of the same product where the matrix and the operands share a dtype,
   the row-dot instance of a gather (float64) and of ``apc_scatter`` and
   ``cimmino_scatter`` (every form, each beside its ring forced), with
   the ring asserted to be the instance the main path's shapes take (but
   a float64 or float32 scatter at k = 1 outside the tensor-core forms:
   the row dot), the tensor-core forms' lines beside the times of the
   DFMA instances they replaced (PERF.md §6, "NVIDIA H100 80GB HBM3,
   700.00 W"); and of the whole
   APC and Cimmino iterations,
   float64 and mixed, eager and inside a captured 10-step CUDA graph,
   with the card's clocks, power, temperature and
   throttle reasons at the phase's start and end;
9. the sparse path at full size: a banded 32768 x 32768 system on 16
   workers (float64, support width 2064), one spectral analysis
   (``banded_mu``: the extremes of X from an eigvalsh of half its size,
   held to X's own eigenvalues on phase 14's cut system), then
   APC, consensus and Cimmino on the sparse kernels — exactly one launch
   of each of its kernels per iteration, the history against the
   unfused sparse path, x against the densified system's dense-kernel
   solve, a bit-identical repeat — and APC and Cimmino ``solve_many``
   with 8 right-hand sides;
10. least squares: the CLI on ``tall_noisy`` (Cimmino on its kernels,
   DGD), a 4096 x 2048 noisy system solved by Cimmino and DGD against
   each solver's ``ls_reference``, and the CLI on ``banded`` with APC on
   the sparse kernels;
11. CUDA-event times of the sparse kernels as in phase 8 (torch.bmm on
   the pre-gathered operands; both forms of ``sparse_scatter``, each
   with its row-dot instance in every form; the ring at every k), each
   kernel and library call also as 10 calls replayed from a CUDA graph
   (``graph_ms``: an eager call of a sparse kernel is its launcher's host
   work; ``sparse_scatter``'s tensor-core forms beside the parent's DFMA
   graph times), and of
   the sparse and
   densified iterations and the sparse mixed ones (the sparse ones also
   in a captured 10-step graph), with the card's clocks as in phase 8,
   then the ``{"kernels": [...]}`` line with all seven, each with its
   five forms (the all-bf16 one from phase 15 (a));
12. ``precision="mixed"`` (bf16-stored A and B, float64 x), in two
   halves: after phase 7 on the dense system and after phase 9 on the
   sparse one, APC, consensus and Cimmino — exactly one launch of each
   of its kernels per iteration, a bit-identical repeat, the history of
   the "upcast twin" (the default solve on the bf16-rounded factors
   widened to float64, through the float64 kernels) within 1e-9, and the
   float64 run's within the reference's bf16 envelope — and dense APC
   ``solve_many`` with 8 right-hand sides; then APC and Cimmino on a
   float32 copy of each system, default (the kernels' float32 form) and
   mixed (bf16/float32);
13. compile-once execution (every ``solve``/``solve_many`` above already
   ran its history captured into a CUDA graph), in two halves: after
   phase 8 on the dense system and after phase 11 on the sparse one,
   APC, consensus and Cimmino on the kernels, default and mixed, k = 1
   and K_MANY — the captured histories and x ``torch.equal`` to the eager
   loop's (``executor.disable_capture``), 150 launches of each kernel
   counted from the replays, the kernel instances the capture took those
   of the eager loop, a bit-identical repeat — and DGD (cuBLAS glue)
   within 1e-12; the whole solve's time per iteration, eager against
   captured, in turns (host clock around work ending in synchronize());
   the dense solves' peak memory, eager and captured; the device's idle
   share over one sparse k = 1 APC solve, float64 and mixed, eager and
   captured (``torch.profiler``); and a ``LocalExecutor`` serving three
   batches of new right-hand sides of the sparse system — one build, one
   capture, the second and third runs quiet under
   ``tracecheck(steady_state=True)``, the first batch's x intact after
   the third, each batch against ``solve_many``;
14. serving (after phase 13): the dense main path's system and kernel
   factors, kept from phase 2 (the dense system of phases 14-18), served
   by ``LinsysServer`` over a ``FactorStore`` (APC on the kernels, k =
   K_MANY, 29 seeded consistent right-hand sides: 4 batches, 3 pad
   slots) — 1 store miss then 3 hits, 1 executor build and 1 capture,
   batches 2-4 quiet under ``tracecheck(steady_state=True)``, 150
   launches of each kernel a steady batch from the replays, the
   placement the store's entry (no second copy of A or B), peak memory,
   each x within 1e-12 of ``solve_many`` and 1e-8 of x_true, RHS/s, ms a
   batch, the fingerprint's time, and one batch split into the
   executor's cold run (``init`` eagerly, outside the graph, then the
   graph) and warm run (the graph alone), and ``init`` alone on the
   process's own linalg library, cuSOLVER and MAGMA; the same traffic
   through ``AsyncLinsysServer`` (bit-equal, 0 shed, latency
   p50/p95/p99) and an overload (``admit_capacity``, explicit ``Shed``);
   APC at ``precision="mixed"`` on ``SERVE_SPARSE`` (the sparse path's
   banded system cut to n = 8192, with its own spectrum: a register
   hashes a system's whole A on the host) and a second one
   (its rows doubled) from a cold store, requests interleaved, through
   both servers (bf16 store entries in each, bit-equal: the async
   server's second miss runs while the first system's program is
   captured), a warm Cimmino server on perturbed right-hand sides (the
   warm program captured once), and the disk tier under ``build/`` (a
   fresh store: two disk hits, x bit-equal, write and read times); the
   ``serve_linsys``
   CLI sync and ``--async`` on one ``--store-dir`` (the second run a disk
   hit) and the solve CLI with ``--ckpt-dir``/``--resume`` twice;
15. the kernel ops layer (after phase 14, with the card's clocks as in
   phase 8): (a) the all-bf16 form of all seven kernels (both forms of
   ``sparse_scatter``) at the dense main path's shapes and the sparse
   path's, k = 1 and K_MANY, every instance ``gather_instance`` admits
   against the plain version (8e-2 of max|plain| + 1, max|Δ| in bf16
   ulps beside it), the ring bit-identical to the row dot (the gathers
   and ``sparse_scatter`` on the bf16 tensor cores; a dense scatter's
   packed row dot sums in another order) and, for the gathers and
   ``cimmino_scatter``, to the bf16/float32 ring on the operands
   widened, rounded to bf16; each timed beside the bytes bound (the
   sparse kernels also in a 10-call CUDA graph), the plain version
   and ``torch.matmul`` (dense) or ``torch.bmm`` on the operands
   gathered beforehand (sparse) in bf16; then ``ops.block_projection``,
   ``ops.cimmino_update``, ``ops.sparse_proj_update`` and
   ``ops.sparse_cimmino_update`` all-bf16 end to end, one launch of each
   kernel they use, through the bf16_bf16 entries; (b) the measured engine verdict (``ops.use_fused``, no pin) of the
   four families at the dense and sparse main path's shapes, k = 1 and
   K_MANY, with both times, then APC and Cimmino ``solve_many`` (k =
   K_MANY, 150 iterations) on each system with no pin: the kernels
   launched exactly where the verdict says fused, and the history within
   1e-6 relative of the pinned-fused one; (c) each k-chunk pin
   (``REPRO_KERNEL_BK`` 1, 2, 4, 8) on a K_MANY gather and scatter of the
   main path against the plain version, timed in turns, the outputs of
   the pins compared bit for bit, and the measured KC;
16. the mesh backend (after phase 15, on its dense system and phase 9's
   sparse one): (a) one rank over NCCL on the card — APC, consensus and
   Cimmino on the kernels with ``backend="mesh"`` (the on-mesh prepare)
   against ``backend="local"``, x and the histories within the contract
   of tests/test_mesh_backend.py (x rtol 1e-8 / atol 1e-10, histories
   rtol 1e-6 / atol 1e-12, ``iters_to_tol`` equal), 150 launches of each
   kernel, most of them from the replays: every mesh history runs
   captured into CUDA graphs (NCCL), one capture a solve (counted by
   ``tracecheck``), and k = 1 and K_MANY (dense and sparse) are held bit
   for bit to the same run under ``executor.disable_capture()``; ms an
   iteration, mesh captured, mesh eager and local captured, in turns;
   APC ``solve_many`` k = K_MANY against local; sparse APC and Cimmino on
   the sparse kernels; APC at ``precision="mixed"``; (b) two ranks on the
   one card over gloo (NCCL refuses two ranks on one GPU), spawned as
   ``chip_smoke.py --mesh-rank R DIR CONFIG``: meshes 1 data x 2 model
   (the split gather -> ``all_reduce`` -> scatter on column shards of
   n/2) and 2 data x 1 model, APC and Cimmino on the kernels, each held
   to (a)'s local run within the same contract, with no capture (gloo
   runs the same chunks eagerly); each rank's four dense
   kernels held against their plain versions on the operands of their
   first launch in that run (the rank's own shards); each rank's
   resident memory, the instances its launches took, launches, ms an
   iteration, and, from one more run with every ``all_reduce`` timed
   between two synchronizes, that run's ms an iteration and the
   ``all_reduce``'s ms and share of it;
17. mesh serving: (a) one NCCL rank, phase 14's dense traffic through
   ``LinsysServer(backend="mesh")`` (one build and one capture, batches
   2-4 quiet under ``tracecheck(steady_state=True)``, bit-equal to the
   same server under ``disable_capture()`` and to the local server,
   timed in turns with both) and ``AsyncLinsysServer``, then two batches
   each of dense Cimmino, sparse mixed APC and sparse Cimmino (on phase
   14's ``SERVE_SPARSE`` system) against the local server; (b) two gloo ranks (1 x 2), ``--serve-rank``: rank 0
   admits and answers, the follower serves, no capture; the serving CLI
   at world 2;
18. redundancy and the elastic runtime on the dense system (no kernel):
   APC, consensus, Cimmino at r = 2 under a rotating straggler against
   the plain solve, captured ≡ eager; the elastic runtime's death,
   rejoin and join and its recovery from a disk tier (on ``RED_CUT``:
   each build and repartition fingerprints every block on the host); on one NCCL rank the
   redundant mesh runner's one captured step ≡ ``disable_capture()`` and
   a history split into segments ≡ one run, timed against eager and the
   local engine; two gloo ranks (2 x 1, ``--red-rank``), no capture.
19. the LM framework's serving path (A19a) and the APC probe head, after
   phase 18's memory is freed: (a) tinyllama-1.1b at full width and
   depth in float32, prefill of 62 tokens and two decode steps against
   the (2, 64) forward at tests/test_models.py's tolerances; (b) the
   same weights cut to two layers, the card's logits against the CPU's
   within 2e-5 of max + 1; (c) ``launch/serve.py`` in bfloat16 for
   tinyllama-1.1b and qwen3-4b (8 requests, batch 4, prompt 128, 32 new
   tokens), twice each: tokens equal, tok/s, one prefill's and one decode
   step's ms, resident and peak memory; (d) examples/probe_apc.py's probe
   on (a)'s features: ``fit_probe`` within 1e-3 of the float64 closed
   form, and its normal system on ``ExecutionPlan(kernel=True)``, the
   history within 1e-6 of the unfused one, ``apc_gather`` and
   ``apc_scatter`` counted (the JSON line's ``lm_probe_launches``);
20. the LM serving path of the MoE, SSM, hybrid and MLA decoders (A19b
   parts 1-3; no kernel backs it), once phases 1-19 have returned (what
   they held freed; the largest tensors still on the card listed): (a) in float32, mamba2-130m at full
   depth ((2, 512) forward, two SSD chunks; prefill 256, decode at 256 and
   257), qwen3-moe-30b-a3b at 4 layers, jamba-v0.1-52b at one period of 8
   and deepseek-v2-236b at 2 (the dense MLA layer and one MoE layer),
   MoE at capacity factor 32, prefill and two decode steps against the
   forward at tests/test_models.py's tolerances; (b) mamba2-130m, and
   qwen3-moe-30b-a3b and deepseek-v2-236b cut to 2 layers, the card's
   logits against the CPU's within 2e-5 of max + 1, and every MoE layer's
   top-k expert ids equal (the smallest gap between the k-th and (k+1)-th
   router probability printed); (c) bfloat16 serving (8 requests, batch
   4, prompt 128, 32 new tokens) twice each: qwen3-moe-30b-a3b and
   mamba2-130m through the CLI at full size, jamba-v0.1-52b at 8 layers
   and deepseek-v2-236b at 4 through ``serve.serve``; tokens equal, tok/s,
   a prefill's and a decode step's ms beside the step's bytes bound,
   parameters and peak GB;
21. Whisper's encoder-decoder serving (A19b part 4; no kernel backs it) at
   its published width and depth (4 + 4 layers, d 384, 1500 frames):
   (a) in float32, on frames drawn as 0.1·N(0, 1), prefill 62 + 2 decode
   steps against the (2, 64) forward at tests/test_models.py's
   tolerances; (b) the card's logits and cross cache against the CPU's
   within 2e-5 of max + 1; (c) bfloat16 serving through the CLI (zero
   frames, 8 requests, batch 4, prompt 128, 32 new tokens) twice: tokens
   equal, tok/s, a prefill (the encoder included) and a decode step
   beside the step's bytes bound (the decoder's weights, the self and the
   cross cache), one decode step profiled;
22. the LM training path (A19c; no kernel backs it): (a) one float32
   train step of each of the ten smoke configs on the card against the
   CPU, the same parameters and batch — loss within 2e-5 of |loss| + 1,
   each gradient leaf within 1e-4 of the leaf's max|g_CPU| (the worst
   leaf printed), AdamW on the CPU's gradients within 1e-6 — the card's
   step run twice under ``torch.use_deterministic_algorithms(True,
   warn_only=True)``: bit-equal, or the ops that warn named beside the
   measured max|Δ|; (b) the flash backward (an autograd.Function) at
   tinyllama-1.1b's heads, B 1, S 8192, bf16, against plain autograd
   through the same loop (8e-2 of max + 1), its peak memory above the
   inputs and the memory kept from forward to backward each under a
   tenth of plain autograd's, at a 512-key block and at the train path's
   own block; (c) the train CLI at full width on
   tinyllama-1.1b (12 steps, batch 8, seq 512, bf16, checkpoints every
   6; the loss falls), resumed to 14 steps from step 12, then
   ``train.loop`` on whisper-tiny and mamba2-130m (6 steps each) and
   qwen3-moe-30b-a3b cut to 2 layers (2 steps): ms a step, tokens/s, peak
   GB and the 6·N·tokens FLOP bound at the card's dense bf16 peak.  Each
   of phases 21 and 22 prints its seconds, resident and peak GB and the
   card's name and power limit;
23. sharding (A19d; no kernel backs it): (a) the dry-run (no card: meta
   DTensors on torch's fake process group), its cells started with the
   script in processes of their own while the kernels build — the APC
   solver iteration on the (16, 16) and (2, 16, 16) meshes and one
   shape an architecture on the second (``DRYRUN_CELLS``) — each cell's
   per-device FLOPs, bytes, collective bytes, peak GB against 80 and
   bottleneck, any FAILED cell failing the script; (b) the sharded path
   on a one-rank NCCL mesh (gloo's DTensor collectives crash a rank on
   CUDA tensors, and NCCL refuses two ranks on one card): tinyllama-1.1b
   float32 at 2 layers, forward, prefill + 4 decode steps and one AdamW
   step against the plain one-rank run within 2e-5 of max + 1, and
   qwen3-moe-30b-a3b at 2 layers through the expert-parallel path
   against the global one, no entry dropped on either; ms a step of
   each beside the other.

Phases 1-19 run under ``REPRO_KERNEL_ENGINE=fused``, the pin the
reference's own benchmarks use: the kernels those phases hold, count
and time run whatever the measured engine verdict would choose.

Every time is the median over rounds of a run of back-to-back calls
between two CUDA events, divided by the run's length: the host's time
to launch a call then overlaps the card's work on the one before.

Before the last lines: the ``{"kernels": [...]}`` line, each phase's
wall time (from its first line to the next phase's, in print order: the
script's 1200 s limit shows there first) and the total.  The last line
is ``{"ok": true, "device": {...}}``.  Imports only torch, numpy and
repro_torch.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import json
import math
import os
import pathlib
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
FULL = dict(N=32768, n=16384, m=16)     # the main path's system
ITERS = 150
K_MANY = 8
CLI_ARGS = ["--problem", "ash608", "--workers", "4", "--iters", "200",
            "--use-kernel"]
# kernel vs plain: max|Δ| / (max|plain| + 1), tests/test_kernels.py TOL,
# by the compute dtype (a bf16 matrix is widened exactly)
TOL = {torch.float64: 1e-12, torch.float32: 2e-5}
BF16 = torch.bfloat16
# precision="mixed" against the float64 run: the reference's bf16
# envelope (tests/test_kernel_corners.py MIXED_TOL); against its upcast
# twin: 1e-9 absolute
MIXED_TOL = dict(rtol=0.5, atol=5e-2)
TWIN_TOL = 1e-9
# the default solve in float32 against the float64 run: about 80 float32
# epsilons absolute (the residual's own rounding is some 6 of them), so a
# float32 history that stalls or converges at another rate fails
F32_TOL = dict(rtol=1e-3, atol=1e-5)
# the kernels' (matrix, compute) dtype forms beside float64/float64
MIXED_FORMS = ((BF16, torch.float64), (BF16, torch.float32))
NO_LIBRARY = ("none: torch.matmul and torch.bmm refuse a bfloat16 matrix "
              "with float64 or float32 operands, and upcasting first is "
              "a second pass over the matrix")
# the tensor-core forms' kernels (bp.MMA_FORMS) on the DFMA ring they
# replaced, ms at k = 1 and 8 (PERF.md §6, "NVIDIA H100 80GB HBM3,
# 700.00 W"), printed beside phase 8's and 11's times: the dense
# bf16/float64 four, the float64 cimmino_scatter (at k = 1 its DFMA row
# dot, the instance the launcher took there), the sparse gathers in
# bf16/float64 and float64 (their DFMA ring, the support gathered
# element by element in its producers), and both forms of sparse_scatter
# in bf16/float64 and float64 (PERF.md §6, scripts/
# probe_sparse_scatter.py: graph times of the parent's 64-row DFMA ring,
# at k = 1 in float64 its DFMA row dot, the launcher's instance there;
# set beside phase 11's graph times)
DFMA_MIXED_MS = {("apc_gather", 1): 0.3818, ("apc_gather", 8): 0.8301,
                 ("apc_scatter", 1): 0.3839, ("apc_scatter", 8): 0.7801,
                 ("cimmino_gather", 1): 0.3832, ("cimmino_gather", 8): 0.7239,
                 ("cimmino_scatter", 1): 0.3771,
                 ("cimmino_scatter", 8): 0.7763,
                 ("sparse_gather", 1): 0.0840, ("sparse_gather", 8): 0.1315,
                 ("sparse_cimmino_gather", 1): 0.0854,
                 ("sparse_cimmino_gather", 8): 0.1181,
                 ("sparse_scatter", 1): 0.0560, ("sparse_scatter", 8): 0.1020,
                 ("sparse_scatter cimmino", 1): 0.0536,
                 ("sparse_scatter cimmino", 8): 0.0984}
DFMA_F64_MS = {("cimmino_scatter", 1): 1.3482, ("cimmino_scatter", 8): 1.4570,
               ("sparse_gather", 1): 0.1851, ("sparse_gather", 8): 0.2004,
               ("sparse_cimmino_gather", 1): 0.1858,
               ("sparse_cimmino_gather", 8): 0.1974,
               ("sparse_scatter", 1): 0.1753, ("sparse_scatter", 8): 0.1912,
               ("sparse_scatter cimmino", 1): 0.1742,
               ("sparse_scatter cimmino", 8): 0.1859}
RAGGED = [(7, 130), (1, 128), (24, 896)]
# the sparse path's system, and the banded corner systems of phase 2
# (tests/test_kernel_corners.py, plus a support one chunk and a bit wide)
SPARSE = dict(n=32768, m=16, bandwidth=8)
# the sparse traffic of the servers (phases 14 and 17 (a)): the sparse
# path's banded system cut in scale, as each register hashes a system's
# whole (m, p, n) A on the host, 12 s at the sparse path's size
SERVE_SPARSE = dict(n=8192, m=16, bandwidth=8)
SPARSE_CORNERS = [dict(n=130, m=2, bandwidth=6), dict(n=24, m=24, bandwidth=2),
                  dict(n=192, m=4, bandwidth=6),
                  dict(n=1024, m=4, bandwidth=8)]
# phase 10: the least-squares system (its two references, a Cholesky a
# block and an lstsq, run on the host)
LS_MID = dict(N=4096, n=2048, m=8, noise=0.5, seed=0)
LS_ITERS = 600
# (HBM bytes/s, float64, float32 and dense bf16 peak op/s) from NVIDIA's
# data sheets, matched on the name nvidia-smi reports; the first match
# wins
CARDS = [("H100 PCIe", 2.0e12, 51e12, 51e12, 756e12),
         ("H100 NVL", 3.9e12, 60e12, 60e12, 835e12),
         ("H200", 4.8e12, 67e12, 67e12, 989e12),
         ("H100", 3.35e12, 67e12, 67e12, 989e12)]
# the all-bf16 form against its plain version: tests/test_kernels.py's
# bf16 TOL, relative to max|plain| + 1
BF16_TOL = 8e-2
BF = "bfloat16/bfloat16"
ENGINE_ENV, BK_ENV = "REPRO_KERNEL_ENGINE", "REPRO_KERNEL_BK"
# phase 16: the mesh against the local backend (tests/test_mesh_backend.py)
MESH_X = dict(rtol=1e-8, atol=1e-10)
MESH_H = dict(rtol=1e-6, atol=1e-12)
MESH_SHAPES = ((1, 2), (2, 1))       # (data, model) of the two-rank runs
MESH_DEADLINE = 150.0                # seconds for the two ranks
# phase 17: a served answer's final residual against the local server's
SERVE_RES_REL = 1e-6
SERVE_DEADLINE = 240.0               # seconds for phases 17 (b), 18's ranks
# phase 17 (b): the serving CLI at world 2, on a system cut to n = 2048
SERVE_CLI_ARGS = ["--backend", "mesh", "--requests", "12", "--systems", "1",
                  "--batch", "4", "--n", "2048", "--workers", "16",
                  "--iters", "150", "--use-kernel"]
# phase 18: the system of the elastic recovery and of the two gloo ranks
RED_CUT = dict(N=8192, n=4096, m=16)
# phase 19: the LM serving path (A19a) and the APC probe head.  LM_SMOKE
# takes each architecture's smoke config instead of the full one (the CPU
# rehearsal only).
LM_ARCH = "tinyllama-1.1b"          # (a), (b), (d): float32, full width
LM_SMOKE = False
LM_BATCH = (2, 64)                  # (a): prefill 62 tokens + 2 decode steps
LM_CUT_LAYERS = 2                   # (b): card ≡ CPU on the weights cut so
LM_CPU_TOL = 2e-5                   # (b): x (max|CPU| + 1)
LM_SERVE = ("tinyllama-1.1b", "qwen3-4b")    # (c): bfloat16, full width
LM_SERVE_ARGS = ["--requests", "8", "--batch", "4", "--prompt-len", "128",
                 "--max-new", "32"]
# (d): examples/probe_apc.py's probe on (a)'s features
PROBE = dict(B=8, S=64, cols=64, m=4, lam=10.0, iters=2000)
# phase 20: the LM serving path of the MoE, SSM, hybrid and MLA decoders
# (A19b parts 1-3), the published dimensions cut in depth only (None: the
# full depth; a cut longer than a config is the config).  An SSM config's
# (a) runs (2, 2 * chunk) tokens, prefill one chunk.
LM20_DEPTH = {"mamba2-130m": None, "qwen3-moe-30b-a3b": 4,
              "jamba-v0.1-52b": 8, "deepseek-v2-236b": 2}   # (a): float32
LM20_NO_DROPS = 32.0                # (a): MoE capacity factor (no drops)
LM20_CPU = {"mamba2-130m": None, "qwen3-moe-30b-a3b": 2,
            "deepseek-v2-236b": 2}  # (b): card ≡ CPU on (a)'s weights cut
LM20_CLI = ("qwen3-moe-30b-a3b", "mamba2-130m")   # (c): the CLI, full size
LM20_CUT = {"jamba-v0.1-52b": 8, "deepseek-v2-236b": 4}   # (c): serve.serve
# phase 21: Whisper's encoder-decoder serving (A19b part 4) at published
# width and depth; (a), (b) on frames drawn as LM21_FRAMES * N(0, 1), (c)
# through the CLI (zero frames) on LM_SERVE_ARGS
LM21_ARCH = "whisper-tiny"
LM21_FRAMES = 0.1
# phase 22: training (A19c).  (a) one float32 step of every smoke config,
# card against CPU, on TRAIN_BATCH tokens of the synthetic stream
TRAIN_BATCH = (2, 32)
TRAIN_GRAD = 1e-4                   # (a): x max|g_CPU| of each leaf
TRAIN_UPDATE = 1e-6                 # (a): AdamW on the CPU's gradients
# (b) the flash backward at tinyllama-1.1b's heads and 8192 tokens, bf16,
# against plain autograd through the same loop, at a 512-key block and at
# the train path's own block (pick_blk), the memory gated at both
FLASH_LEN = dict(B=1, S=8192, H=32, K=4, d=64)
FLASH_BLK = 512
FLASH_PEAK_RATIO = 0.1              # the Function's peak under this share
# (c) the train CLI at full width, then the same loop on other configs
# (None: full depth), with the number of steps each
TRAIN_ARCH = "tinyllama-1.1b"
TRAIN_CLI_ARGS = ["--steps", "12", "--batch", "8", "--seq", "512",
                  "--ckpt-every", "6"]
TRAIN_RESUME_STEPS = 14
TRAIN_MORE = {"whisper-tiny": (None, 6), "mamba2-130m": (None, 6),
              "qwen3-moe-30b-a3b": (2, 2)}
PROBE_HIST_REL = 1e-6               # kernel-path history vs the unfused one
# phase 23: sharding and the dry-run launchers (A19d).  (a) the dry-run
# (no card: meta tensors on the fake process group), started at the
# script's start in processes of its own, DRYRUN_PARALLEL at a time, and
# read in phase 23: the solver cells on both meshes, and one shape per
# architecture on the multi-pod mesh (every shape among them)
DRYRUN_CELLS = {"tinyllama-1.1b": "train_4k", "deepseek-7b": "prefill_32k",
                "deepseek-coder-33b": "decode_32k", "qwen3-4b": "train_4k",
                "deepseek-v2-236b": "decode_32k",
                "qwen3-moe-30b-a3b": "train_4k",
                "jamba-v0.1-52b": "long_500k", "pixtral-12b": "prefill_32k",
                "mamba2-130m": "train_4k", "whisper-tiny": "train_4k"}
DRYRUN_PARALLEL = 5
DRYRUN_DEADLINE = 600.0             # seconds from the start, all cells
# (b) the sharded path on the card (DTensors on a one-rank NCCL mesh),
# float32 at published width, cut in depth, against the plain one-rank run
SHARD_ARCH, SHARD_LAYERS = "tinyllama-1.1b", 2
SHARD_BATCH = (2, 64)               # prefill 64, then SHARD_DECODE steps
SHARD_DECODE = 4
SHARD_MOE = ("qwen3-moe-30b-a3b", 2)
SHARD_TOL = 2e-5                    # x (max|one rank| + 1)
SOURCE = "src/repro_torch/kernels/csrc/block_projection.cu"
REPLACES = {"apc_gather": "src/repro/kernels/block_projection.py:173",
            "apc_scatter": "src/repro/kernels/block_projection.py:210",
            "cimmino_gather": "src/repro/kernels/block_projection.py:246",
            "cimmino_scatter": "src/repro/kernels/block_projection.py:274",
            "sparse_gather": "src/repro/kernels/block_projection.py:313",
            "sparse_cimmino_gather":
                "src/repro/kernels/block_projection.py:314",
            "sparse_scatter": "src/repro/kernels/block_projection.py:315"}
# the kernels each kernel-path solver launches, once per iteration
USES = {"apc": ("apc_gather", "apc_scatter"),
        "consensus": ("apc_gather", "apc_scatter"),
        "cimmino": ("cimmino_gather", "cimmino_scatter")}
SPARSE_USES = {"apc": ("sparse_gather", "sparse_scatter"),
               "consensus": ("sparse_gather", "sparse_scatter"),
               "cimmino": ("sparse_cimmino_gather", "sparse_scatter")}
# the dense kernels' wrappers in kernels/ops.py, which the mesh hooks call
# apart (the gather, the all_reduce of u over the model axis, the
# scatter), and their plain versions there
WRAPPERS = {"apc_gather": ("proj_gather", "apc_gather_ref"),
            "apc_scatter": ("proj_scatter", "apc_scatter_ref"),
            "cimmino_gather": ("cimmino_gather", "cimmino_gather_ref"),
            "cimmino_scatter": ("cimmino_scatter", "cimmino_scatter_ref")}


# when each phase's first line was printed, in print order (phase_spans)
PHASE_STARTS: dict = {}


def say(*parts) -> None:
    hit = re.match(r"phase (\d+)", str(parts[0])) if parts else None
    if hit:
        PHASE_STARTS.setdefault(hit[1], time.time())
    print(*parts, flush=True)


def phase_spans(end: float) -> str:
    """'1 57.1 s, 2 80.3 s, ...': the wall time from each phase's first
    line to the next phase's first line (the last one's to ``end``), in
    print order; the dry-run of phase 23 (a) runs beside the others."""
    starts = list(PHASE_STARTS.items())
    ends = [t for _, t in starts[1:]] + [end]
    return ", ".join(f"{ph} {e - t:.1f} s"
                     for (ph, t), e in zip(starts, ends))


def launched_instances(run):
    """(``run()``, the set of (kernel, instance) its launches took): a
    captured solve decides each instance once, at capture."""
    from repro_torch.kernels import block_projection as bp
    seen, launch = set(), bp._launch
    names = {v: inst for inst, v in bp.INSTANCES.items()}

    def spy(name, matrix, out, *args):
        seen.add((name, names[args[-2]]))     # the instance, then kc
        return launch(name, matrix, out, *args)
    bp._launch = spy
    try:
        return run(), seen
    finally:
        bp._launch = launch


@contextlib.contextmanager
def kernel_calls(ops, kernels):
    """Inside, the first call of each of ``kernels``' wrappers in ``ops``
    (``WRAPPERS``) is kept: {kernel: (wrapper, its arguments)}, the
    operands after the matrix cloned, so the kernel can be held against
    its plain version on the very inputs a run gave it."""
    calls, real = {}, {kn: getattr(ops, WRAPPERS[kn][0]) for kn in kernels}

    def spy(kn):
        def call(matrix, *args):
            calls.setdefault(kn, (real[kn], (matrix, *(
                a.clone() if isinstance(a, torch.Tensor) else a
                for a in args))))
            return real[kn](matrix, *args)
        return call
    for kn in kernels:
        setattr(ops, WRAPPERS[kn][0], spy(kn))
    try:
        yield calls
    finally:
        for kn in kernels:
            setattr(ops, WRAPPERS[kn][0], real[kn])


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


CLOCK_QUERY = ("clocks.sm,clocks.max.sm,power.draw,temperature.gpu,"
               "clocks_throttle_reasons.active")


def clocks(label: str) -> None:
    """Print the card's SM clock, its maximum, power draw, temperature
    and active throttle reasons on a line of its own, so a change of
    rate within a run shows beside the times it would move.  Gates
    nothing: without nvidia-smi it says so and goes on."""
    try:
        r = subprocess.run(["nvidia-smi", f"--query-gpu={CLOCK_QUERY}",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        got = (r.stdout + r.stderr).strip()
    except (OSError, subprocess.SubprocessError) as e:
        got = f"nvidia-smi not available ({e})"
    say(f"{label} clocks ({CLOCK_QUERY}): {got}")


def card_rates(name: str):
    for key, bw, f64, f32, b16 in CARDS:
        if key in name:
            return bw, {torch.float64: f64, torch.float32: f32,
                        torch.bfloat16: b16}
    raise RuntimeError(f"no bandwidth/peak entry for card {name!r}")


@contextlib.contextmanager
def env_var(name: str, value):
    """The environment variable ``name`` set to ``value`` (removed for
    None) inside, as it was after."""
    prev = os.environ.get(name)
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = prev


def randn(seed: int, *shape, dtype=torch.float64) -> torch.Tensor:
    """Seeded standard normals made on the card (a host array of the main
    path's size takes seconds to fill), in ``dtype``."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(shape, generator=gen, device="cuda",
                       dtype=torch.float32).to(dtype)


def rel_err(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max|Δ| / (max|want| + 1), max|Δ|)"""
    d = float((got.double() - want.double()).abs().max())
    return d / (float(want.double().abs().max()) + 1.0), d


def bf16_ulps(d: float, want: torch.Tensor) -> float:
    """max|Δ| ``d`` in units in the last place of a bf16 number in the
    binade of max|want| (8 significant bits)."""
    top = float(want.double().abs().max())
    return d / 2.0 ** (math.floor(math.log2(top)) - 7) if top else 0.0


def pair_label(matrix: torch.Tensor, x: torch.Tensor) -> str:
    """'float64/float64', 'bfloat16/float64', ...: a kernel's form."""
    return f"{str(matrix.dtype)[6:]}/{str(x.dtype)[6:]}"


# the mangled matrix/compute types of a kernel instance, and their names
# (a substitution, "S<n>_", for the compute type: it repeats the matrix
# type, the all-bf16 form)
MANGLED = {"d": (torch.float64, "f64"), "f": (torch.float32, "f32"),
           "13__nv_bfloat16": (BF16, "bf16")}


def ptxas_summary(log: str, dynamic_smem, mma_forms=()) -> list[str]:
    """'apc_gather f64 KC=8 spill 0 B: 128 regs, smem 16384 B' per kernel
    instance, from nvcc's -Xptxas=-v output ('bf16/f64' for a bf16-stored
    matrix with float64 compute; the sparse scatter's two forms are tagged
    apc/cimmino; a ring instance's shared memory adds
    ``dynamic_smem(matrix dtype, dtype, KC, form)`` bytes of dynamic
    shared memory, the form "apc" for the APC gathers' rings, else
    "cimmino": the Cimmino gather's and the scatters' stage; "apc_mma"
    and "cimmino_mma" for the dense rings of ``mma_forms``, (kernel, pair
    suffix) pairs: the tensor-core form's, bp.MMA_FORMS; "sparse" for the
    sparse gathers' rings, "sparse_scatter" for sparse_scatter's, in
    every pair); and the sparse gathers'
    pre-pass, 'support_operand f64 apc: 30 regs, smem 0 B' (apc:
    sparse_gather's X̄ − X, cimmino: X̄)."""
    out, kernel = [], None
    for line in log.splitlines():
        pre = re.search(r"entry function '\S*?support_operand_kernelI"
                        r"(d|f|13__nv_bfloat16)Lb([01])E", line)
        if pre:
            kernel = (f"support_operand {MANGLED[pre[1]][1]} "
                      + ("apc" if pre[2] == "1" else "cimmino"))
            ring = False
        hit = re.search(r"entry function '\S*?((?:apc|cimmino|sparse)_\w+?)"
                        r"_kernelI(d|f|13__nv_bfloat16)([df]|S\d*_)Li(\d+)E"
                        r"(?:Li\d+E)?(?:Lb([01]))?", line)
        if hit:
            mdtype, mname = MANGLED[hit[2]]
            dtype, name = MANGLED.get(hit[3], (mdtype, mname))
            tag = name if mname == name else f"{mname}/{name}"
            kernel = (f"{hit[1]} {tag} KC={hit[4]}"
                      + ("" if hit[5] is None else
                         " apc" if hit[5] == "1" else " cimmino"))
            ring = hit[1].endswith("_ring")
            form = ("sparse" if hit[1] in ("sparse_gather_ring",
                                           "sparse_cimmino_gather_ring")
                    else "sparse_scatter"
                    if hit[1] == "sparse_scatter_ring"
                    else "apc" if hit[1] == "apc_gather_ring"
                    else "cimmino")
            suffix = name if mname == name else f"{mname}_{name}"
            if (ring and form in ("apc", "cimmino")
                    and (hit[1][:-len("_ring")], suffix) in mma_forms):
                form += "_mma"
            kc = int(hit[4])
        spill = re.search(r"(\d+) bytes spill stores", line)
        if kernel and spill:
            kernel += f" spill {spill[1]} B"
        regs = re.search(r"Used (\d+) registers", line)
        if kernel and regs:
            smem = re.search(r"(\d+) bytes smem", line)
            kernel += f": {regs[1]} regs, smem {smem[1] if smem else 0} B"
            if ring:
                kernel += (f" + {dynamic_smem(mdtype, dtype, kc, form)} B "
                           f"dynamic")
            out.append(kernel)
            kernel = None
    return out


def medians_ms(fns: dict, reps: int = 15, batch: int = 10) -> dict:
    """CUDA-event medians, ms a call, of each function in ``fns``, timed
    in turns (f1, f2, ..., f1, f2, ...): a sample is a run of ``batch``
    back-to-back calls between two events, over ``batch``.  One call
    between two events would also time the host's launch of it, as the
    card idles until the launch arrives (phase 11 prints how much)."""
    for fn in fns.values():
        for _ in range(3):
            fn()
    torch.cuda.synchronize()
    times = {name: [] for name in fns}
    for _ in range(reps):
        for name, fn in fns.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(batch):
                fn()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end) / batch)
    return {name: float(np.median(t)) for name, t in times.items()}


def inputs(m, p, n, k, dtype, seed, *, transposed=False):
    """Seeded A (m,p,n), B (m,n,p), X (m,k,n), X̄ (k,n), V (m,k,p) on the
    card.

    ``transposed`` gives X and V as the (m, k, .) views of (k, m, .)
    tensors, the layout solve_many hands the kernels."""
    rng = np.random.default_rng(seed)
    g = lambda *s: torch.as_tensor(rng.standard_normal(s),  # noqa: E731
                                   device="cuda").to(dtype)
    A, B = g(m, p, n), g(m, n, p)
    if transposed:
        X, V = g(k, m, n).transpose(0, 1), g(k, m, p).transpose(0, 1)
    else:
        X, V = g(m, k, n), g(m, k, p)
    return A, B, X, g(k, n), V


def decay(res: torch.Tensor, floor: float = 1e-12):
    """Measured per-step residual decay over the second half of the
    history above ``floor``: (r_j / r_i)^(1/(j-i)), or None."""
    r = res.double().cpu().numpy()
    above = np.nonzero(r > floor)[0]
    if len(above) < 4:
        return None
    j = int(above[-1])
    i = j // 2
    return float((r[j] / r[i]) ** (1.0 / (j - i)))


def timed_ms(fn):
    """(fn(), host ms from the card idle to the card idle after it)."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


@contextlib.contextmanager
def linalg_library(lib: str):
    """``torch.backends.cuda.preferred_linalg_library(lib)`` inside."""
    prev = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library(lib)
    try:
        yield
    finally:
        torch.backends.cuda.preferred_linalg_library(prev)


def captured_stdout(fn, label, card):
    """Run ``fn()`` with its standard output captured; print each line
    after ``label``, and the card it ran on after it.  Returns (fn(), the
    output)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    text = buf.getvalue()
    for line in text.splitlines():
        say(f"{label}: {line} [{card}]")
    return out, text


def banded_mu(spectral, system) -> tuple:
    """((mu_min, mu_max) of X = (1/m) sum_i P_i, the side of the eigvalsh
    that found them) for a system whose blocks' column supports each meet
    only their neighbours' (asserted), as a banded system's do.  The even
    blocks' row-space projectors then have disjoint supports and sum to
    one projector P_e, the odd ones' to P_o, and X = (P_e + P_o) / m.  The
    eigenvalues of a sum of two projectors whose ranges span R^n are 1 ±
    the cosines of their principal angles (and 1 where the ranges' sizes
    differ), so mu = (1 ∓ s) / m, s the largest singular value of Q_eᵀ Q_o,
    whose nonzero blocks are L_i⁻¹ A_i A_jᵀ L_j⁻ᵀ for |i − j| = 1 (L_i L_iᵀ
    = A_i A_iᵀ): one eigvalsh of about n/2 x n/2 instead of X's n x n."""
    A = system.A_blocks
    m, p, n = A.shape
    nz = (A != 0).any(dim=1).to(A.dtype)
    meet = nz @ nz.T
    assert not meet.triu(2).any(), "supports meet past their neighbours"
    L = torch.linalg.cholesky(A @ A.transpose(1, 2))
    ne, no = (m + 1) // 2, m // 2
    M = torch.zeros(ne * p, no * p, dtype=A.dtype, device=A.device)
    for i in range(m - 1):
        W = torch.linalg.solve_triangular(L[i], A[i] @ A[i + 1].T,
                                          upper=False)
        W = torch.linalg.solve_triangular(L[i + 1], W.T, upper=False).T
        e, o = (i, i + 1) if i % 2 == 0 else (i + 1, i)
        M[e // 2 * p:(e // 2 + 1) * p, o // 2 * p:(o // 2 + 1) * p] = (
            W if i % 2 == 0 else W.T)
    G = M.T @ M if no < ne else M @ M.T
    s = math.sqrt(max(float(spectral.eigvalsh(G)[-1]), 0.0))
    return ((1.0 - s) / m, (1.0 + s) / m), G.shape[0]


def sparse_pinned(spectral, mu, m) -> dict:
    """The sparse solvers' pinned parameters and rates from mu(X): the
    closed forms each one's analyze() applies."""
    apc_p = spectral.apc_optimal(*mu)
    nu_m, rho_cim = spectral.cimmino_optimal(*mu)
    return {"apc": ({"gamma": apc_p.gamma, "eta": apc_p.eta}, apc_p.rho),
            "consensus": ({"gamma": 1.0, "eta": 1.0},
                          spectral.consensus_rate(mu[0])),
            "cimmino": ({"nu": nu_m / m}, rho_cim)}


def consistent(system, count, seed):
    """``count`` seeded solutions xs (on the card) and their right-hand
    sides A xs on the host, as a client sends them."""
    xs = torch.as_tensor(np.random.default_rng(seed).standard_normal(
        (count, system.n)), device="cuda")
    B = (system.A_blocks.reshape(system.N, system.n) @ xs.T).T
    return xs, B.cpu().numpy()


def groups(rhs, k):
    """The server's batches of ``rhs``: FIFO groups of k, the last padded
    by repeating its last request."""
    out = []
    for i in range(0, len(rhs), k):
        rows = list(rhs[i:i + k])
        out.append(np.stack(rows + [rows[-1]] * (k - len(rows))))
    return out


def serving_phase(card, form_launches, dprm, dsys, sp, sp_pinned) -> None:
    """Phase 14: ``LinsysServer`` and ``AsyncLinsysServer`` over a
    ``FactorStore`` on the dense main path (``dsys``) and the sparse path,
    the disk tier, and the two CLIs (module docstring)."""
    from repro_torch import solvers
    from repro_torch.analysis import tracecheck
    from repro_torch.kernels import block_projection as bp
    from repro_torch.kernels import ops
    from repro_torch.launch import serve_linsys as serve_cli
    from repro_torch.launch import solve as solve_cli
    from repro_torch.solvers import executor
    from repro_torch.solvers.pipeline import Shed
    from repro_torch.solvers.store import block_fingerprint

    s = solvers.get("apc")
    head = min(executor.CHUNK, ITERS)
    uses = lambda kns, n: {kn: n if kn in kns else 0  # noqa: E731
                           for kn in bp.KERNELS}

    # -- the dense main path, sync ---------------------------------------
    a_bytes = dsys.A_blocks.numel() * dsys.A_blocks.element_size()
    n_req = 3 * K_MANY + 5
    xs, rhs = consistent(dsys, n_req, 14)
    say(f"phase 14 data: {n_req} right-hand sides of the dense system")
    fp_key, fp_ms = timed_ms(lambda: solvers.fingerprint("apc", dsys, dprm))
    # the chunks through the pinned buffer hash what a host copy hashes
    same_fp = (block_fingerprint("apc", dsys.A_blocks[0], dprm)
               == block_fingerprint("apc", dsys.A_blocks[0].cpu(), dprm))
    assert same_fp
    say(f"phase 14 fingerprint: A {a_bytes / 1e9:.2f} GB copied from the "
        f"card (in chunks through a pinned buffer) and hashed (sha256) on "
        f"the host in {fp_ms:.1f} ms ({a_bytes / fp_ms / 1e6:.2f} GB/s); a "
        f"block's digest from the card ≡ its host copy's {same_fp} [{card}]")
    store = solvers.FactorStore()
    srv = solvers.LinsysServer(store, solver="apc", iters=ITERS,
                               batch=K_MANY, use_kernel=True, **dprm)
    fp = srv.register(dsys)
    assert fp == fp_key
    for b in rhs:
        srv.submit(fp, b)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    outs, ms, launched = [], [], []
    ops.reset_launch_counts()
    with tracecheck() as tc:
        out, t_ms = timed_ms(srv.step)
    launched.append(form_launches("f64"))
    outs.append(out)
    ms.append(t_ms)
    resident = torch.cuda.memory_allocated()
    first_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with tracecheck(steady_state=True):
        for _ in range(3):
            ops.reset_launch_counts()
            out, t_ms = timed_ms(srv.step)
            launched.append(form_launches("f64"))
            outs.append(out)
            ms.append(t_ms)
    steady_peak = torch.cuda.max_memory_allocated()
    assert srv.step() == []
    assert [e.fun for e in tc.traces()] == ["build apc.cold",
                                            "capture apc.cold"], tc.summary()
    (ex,) = srv._executors.values()
    st = store.stats
    assert (st.misses, st.hits, st.disk_hits) == (1, 3, 0), st
    assert srv.stats.executor_builds == 1, srv.stats
    assert (ex.builds, ex.captures, ex.cache_size()) == (1, 1, 1)
    assert (srv.stats.served, srv.stats.padded, srv.stats.batches) == (
        n_req, 3, 4), srv.stats
    assert launched[0] == uses(USES["apc"], head + ITERS), launched[0]
    for got in launched[1:]:
        assert got == uses(USES["apc"], ITERS), got
    # one copy of A and of B: the placement IS the store's entry
    entry, ent = store._mem[fp], srv._systems[fp]
    assert entry.A is dsys.A_op and ent.A_placed is dsys.A_op
    assert ent.factors_placed is entry
    b_bytes = entry.B.numel() * entry.B.element_size()
    assert resident - base < a_bytes + b_bytes, (resident, base)
    assert steady_peak - resident < a_bytes // 4, (steady_peak, resident)
    served = [r for out in outs for r in out]
    assert [r.rid for r in served] == list(range(n_req))
    worst, same, err = 0.0, True, 0.0
    kfs = solvers.ExecutionPlan(kernel=True, factors=entry)
    for i, (Bg, out) in enumerate(zip(groups(rhs, K_MANY), outs)):
        ref = s.solve_many(dsys, Bg, iters=ITERS, plan=kfs, **dprm)
        for j, r in enumerate(out):
            xr = ref.x[j].cpu().numpy()
            d = float(np.linalg.norm(r.x - xr) / np.linalg.norm(xr))
            worst = max(worst, d)
            same = same and np.array_equal(r.x, xr)
            assert d <= 1e-12, (i, j, d)
            xt = xs[r.rid].cpu().numpy()
            err = max(err, float(np.linalg.norm(r.x - xt)
                                 / np.linalg.norm(xt)))
            assert np.isfinite(r.residual)
    assert err <= 1e-8, err
    say(f"phase 14 dense apc server k={K_MANY}, {ITERS} iterations: "
        f"{n_req} requests in 4 batches (the last 5 real + 3 padded); "
        f"store misses {st.misses} hits {st.hits}; executor builds "
        f"{srv.stats.executor_builds}, captures {ex.captures}; batches "
        f"2-4 quiet under tracecheck(steady_state=True); launches a batch "
        f"{[launched[i]['apc_gather'] for i in range(4)]} (apc_gather) "
        f"{[launched[i]['apc_scatter'] for i in range(4)]} (apc_scatter), "
        f"the first with the {head}-step eager head; served x vs "
        f"solve_many max rel {worst:.3e}, bit-identical {same}; vs x_true "
        f"max rel {err:.3e}")
    say(f"phase 14 dense apc server: ms a batch {', '.join(f'{v:.1f}' for v in ms)} "
        f"(the first with prepare, the pinv factors and the capture); "
        f"{n_req / sum(ms) * 1e3:.2f} RHS/s over the 4 batches, "
        f"{(n_req - K_MANY) / sum(ms[1:]) * 1e3:.2f} RHS/s over batches "
        f"2-4, padding excluded (host clock to synchronize()) [{card}]")
    say(f"phase 14 dense apc server memory: resident {base / 1e9:.3f} GB "
        f"before (A and b, the kernel factors phases 15-18 take, the sparse "
        f"path's), +{(resident - base) / 1e9:.3f} GB after the "
        f"first batch (B {b_bytes / 1e9:.3f} GB, the Cholesky factors, the "
        f"graph's pool), peak +{(first_peak - base) / 1e9:.3f} GB in it "
        f"(prepare); batches 2-4 peak {steady_peak / 1e9:.3f} GB "
        f"(max_memory_allocated), +{(steady_peak - resident) / 1e6:.1f} MB "
        f"above the resident; the store's entry is the placement (A is the "
        f"system's own) [{card}]")

    # one batch split: the executor's cold run (init eagerly, outside the
    # graph, then the graph's steps) against its warm run (the graph's
    # steps alone), and init alone on the process's own library (what the
    # executor and eager solve_many run it on), on cuSOLVER and on MAGMA
    ex2 = executor.LocalExecutor(s, dprm, ITERS, use_kernel=True)
    Bb = ex2.place_B(groups(rhs, K_MANY)[0].reshape(K_MANY, dsys.m,
                                                    dsys.p), dsys.A_op)
    assert Bb.device == dsys.device
    warm = ex2.run(dsys.A_op, entry, Bb)[0]
    ex2.run(dsys.A_op, entry, Bb, warm)
    assert (ex2.builds, ex2.captures) == (2, 2)

    def init_on(lib):
        with linalg_library(lib):
            s.init(entry, Bb, dprm)
    split = medians_ms({
        "cold run": lambda: ex2.run(dsys.A_op, entry, Bb),
        "warm run": lambda: ex2.run(dsys.A_op, entry, Bb, warm),
        "init own": lambda: s.init(entry, Bb, dprm),
        "init cuSOLVER": lambda: init_on("cusolver"),
        "init MAGMA": lambda: init_on("magma")}, reps=3, batch=1)
    say(f"phase 14 one batch (dense apc k={K_MANY}, CUDA events, median of "
        f"3 in turns): cold run {split['cold run']:.3f} ms, warm run "
        f"({ITERS} steps, the graph alone) {split['warm run']:.3f} ms = "
        f"{split['warm run'] / ITERS:.4f} ms a step, so init (eager, "
        f"outside the graph) {split['cold run'] - split['warm run']:.3f} "
        f"ms; init alone: the process's own library "
        f"{split['init own']:.3f} ms, cuSOLVER {split['init cuSOLVER']:.3f}"
        f" ms, MAGMA {split['init MAGMA']:.3f} ms [{card}]")
    del ex2, Bb, warm

    # -- the same traffic through the async pipeline ---------------------
    asrv = solvers.AsyncLinsysServer(store, solver="apc", iters=ITERS,
                                     batch=K_MANY, use_kernel=True,
                                     pipeline_depth=2, **dprm)
    afp = asrv.register(dsys)
    for b in rhs:
        asrv.submit(afp, b)
    ops.reset_launch_counts()
    aout, a_ms = timed_ms(asrv.drain)
    a_launched = form_launches("f64")
    asrv.close()
    assert [r.rid for r in aout] == list(range(n_req))
    for r, e in zip(aout, served):
        assert np.array_equal(r.x, e.x) and r.residual == e.residual, r.rid
    assert (asrv.stats.served, asrv.stats.shed) == (n_req, 0), asrv.stats
    assert a_launched == uses(USES["apc"], head + 4 * ITERS), a_launched
    rep = asrv.latency_report()
    say(f"phase 14 dense apc async (pipeline_depth 2): {n_req} requests "
        f"bit-equal to the sync server's in rid order, 0 shed; launches "
        f"{a_launched['apc_gather']} of each kernel; {a_ms:.1f} ms, "
        f"{n_req / a_ms * 1e3:.2f} RHS/s (its first batch captures); "
        f"latency p50/p95/p99 {rep['p50_ms']:.1f}/{rep['p95_ms']:.1f}/"
        f"{rep['p99_ms']:.1f} ms, mean {rep['mean_ms']:.1f}, max "
        f"{rep['max_ms']:.1f} (all submitted at t=0) [{card}]")
    osrv = solvers.AsyncLinsysServer(store, solver="apc", iters=ITERS,
                                     batch=K_MANY, use_kernel=True,
                                     admit_capacity=K_MANY, **dprm)
    ofp = osrv.register(dsys)
    tickets = [osrv.submit(ofp, b) for b in rhs[:20]]
    assert all(t.future.done() and isinstance(t.result(), Shed)
               for t in tickets[K_MANY:])
    assert (osrv.stats.admitted, osrv.stats.shed) == (K_MANY, 20 - K_MANY)
    oout = osrv.drain()
    osrv.close()
    assert [r.rid for r in oout] == list(range(20))
    assert all(isinstance(r, Shed) for r in oout[K_MANY:])
    for r, e in zip(oout[:K_MANY], served):
        assert not isinstance(r, Shed) and np.array_equal(r.x, e.x)
    say(f"phase 14 overload (admit_capacity {K_MANY}, 20 submitted before "
        f"the pipeline starts): admitted {osrv.stats.admitted}, each of "
        f"the {osrv.stats.shed} others an explicit Shed; the admitted "
        f"bit-equal to the sync server's")
    del srv, asrv, osrv, store, entry, ent, ex, dsys, xs
    gc.collect()
    torch.cuda.empty_cache()

    # -- the sparse path: mixed APC over two systems from a cold store
    # (sp and sp2, its rows doubled: its own fingerprint, factors and
    # placement, b doubled, the same x), sync (over a store with a disk
    # tier) and async (a store without one: its second miss runs on the
    # assembly thread while a pool thread captures the first system's
    # program); then a fresh store on the sync one's directory, as a
    # restarted process: two disk hits
    sprm, cprm = sp_pinned["apc"][0], sp_pinned["cimmino"][0]
    xs, srhs = consistent(sp, 2 * K_MANY, 15)
    sp2 = dataclasses.replace(sp, A_blocks=2 * sp.A_blocks,
                              b_blocks=2 * sp.b_blocks)
    pairs = ((sp, 1.0), (sp2, 2.0))
    sdir = ROOT / "build" / "phase14_factors"
    shutil.rmtree(sdir, ignore_errors=True)
    io_ms = {}

    def timing(store, name):
        """``store`` with its method ``name`` timed into ``io_ms``."""
        fn = getattr(store, name)

        def timed(*a, **k):
            out, t_ms = timed_ms(lambda: fn(*a, **k))
            io_ms.setdefault(name, []).append(t_ms)
            return out
        setattr(store, name, timed)
        return store

    mixed = {}
    for label, cls, mstore in (
            ("sync", solvers.LinsysServer, timing(solvers.FactorStore(
                directory=str(sdir)), "_disk_store")),
            ("async", solvers.AsyncLinsysServer, solvers.FactorStore()),
            ("restarted", solvers.LinsysServer, timing(solvers.FactorStore(
                directory=str(sdir)), "_disk_load"))):
        msrv = cls(mstore, solver="apc", iters=ITERS, batch=K_MANY,
                   use_kernel=True, precision="mixed", **sprm)
        mfps = [msrv.register(system) for system, _ in pairs]
        for b in srhs:                  # interleaved: rid 2i sp, 2i+1 sp2
            for mfp, (_, scale) in zip(mfps, pairs):
                msrv.submit(mfp, scale * b)
        ops.reset_launch_counts()
        out, t_ms = timed_ms(msrv.drain)
        got = form_launches("bf16_f64")
        if cls is solvers.AsyncLinsysServer:
            msrv.close()
        (mex,) = msrv._executors.values()
        entries = [mstore._mem[mfp] for mfp in mfps]
        for me in entries:
            assert me.A.vals.dtype == me.B.dtype == BF16, (label, me.B.dtype)
        assert mstore.stats.hits == 2, (label, mstore.stats)
        assert (mex.builds, mex.captures) == (2, 2), label
        assert got == uses(SPARSE_USES["apc"], 2 * head + 4 * ITERS), got
        mixed[label] = (sorted(out, key=lambda r: r.rid), t_ms, entries,
                        mstore.stats, mfps)
    (sout, s_ms, mes, st1, mfps), (aout, a_ms, _, _, _), \
        (rout, r_ms, _, st2, _) = mixed.values()
    assert (st1.misses, st1.disk_writes) == (2, 2), st1
    assert (st2.disk_hits, st2.misses) == (2, 0), st2
    assert [r.rid for r in aout] == [r.rid for r in sout] == list(
        range(4 * K_MANY))
    for r, e, d in zip(aout, sout, rout):
        assert np.array_equal(r.x, e.x) and r.residual == e.residual
        assert np.array_equal(d.x, e.x) and d.residual == e.residual
    worst = 0.0
    for (system, scale), mfp, me in zip(pairs, mfps, mes):
        kfs = solvers.ExecutionPlan(kernel=True, precision="mixed",
                                    factors=me)
        mine = [r for r in sout if r.fp == mfp]
        for i, Bg in enumerate(groups(srhs, K_MANY)):
            ref = s.solve_many(system, scale * Bg, iters=ITERS, plan=kfs,
                               **sprm)
            for j, r in enumerate(mine[i * K_MANY:(i + 1) * K_MANY]):
                xr = ref.x[j].cpu().numpy()
                d = float(np.linalg.norm(r.x - xr) / np.linalg.norm(xr))
                worst = max(worst, d)
                assert d <= 1e-12, d
    size = sum(f.stat().st_size for f in sdir.rglob("*") if f.is_file())
    say(f"phase 14 sparse apc precision=mixed k={K_MANY}, two systems from "
        f"a cold store (sp, and sp2 its rows doubled), requests "
        f"interleaved: the store's entries bf16 (vals, Bvals) in the sync "
        f"and the async server; async bit-equal to sync for both; vs "
        f"solve_many max rel {worst:.3e}; {4 * K_MANY} requests in "
        f"{s_ms:.1f} ms sync (with the disk writes), {a_ms:.1f} ms async "
        f"(each with its two placements' captures) [{card}]")
    say(f"phase 14 disk tier (sparse apc mixed): the sync server missed "
        f"twice and wrote {size / 1e6:.1f} MB in "
        + " + ".join(f"{v:.1f}" for v in io_ms["_disk_store"])
        + f" ms; a fresh store on the directory: disk_hits "
        f"{st2.disk_hits} misses {st2.misses}, read in "
        + " + ".join(f"{v:.1f}" for v in io_ms["_disk_load"])
        + f" ms, the entries bf16, served x bit-equal to the first "
        f"server's; {4 * K_MANY} requests in {r_ms:.1f} ms [{card}]")
    shutil.rmtree(sdir, ignore_errors=True)
    del mixed, mes, sout, aout, rout, sp2, pairs
    gc.collect()
    torch.cuda.empty_cache()

    # -- a warm Cimmino server on perturbed right-hand sides ---------------
    wsrv = solvers.LinsysServer(solvers.FactorStore(), solver="cimmino",
                                iters=ITERS, batch=K_MANY, use_kernel=True,
                                warm_start=True, **cprm)
    wfp = wsrv.register(sp)
    noise = np.random.default_rng(16).standard_normal(srhs[:K_MANY].shape)
    events, res = [], []
    for i in range(4):
        for b in srhs[:K_MANY] + 1e-3 * i * noise:
            wsrv.submit(wfp, b)
        with tracecheck() as tc:
            out = wsrv.drain()
        events.append([e.fun for e in tc.traces()])
        assert [r.warm for r in out] == [i > 0] * K_MANY
        res.append(max(r.residual for r in out))
    (wex,) = wsrv._executors.values()
    assert events == [["build cimmino.cold", "capture cimmino.cold"],
                      ["build cimmino.warm", "capture cimmino.warm"], [],
                      []], events
    assert wsrv.stats.warm_batches == 3 and wex.captures == 2
    say(f"phase 14 sparse cimmino warm_start k={K_MANY}: 4 batches of "
        f"perturbed right-hand sides, warm_batches "
        f"{wsrv.stats.warm_batches}; the warm program captured once "
        f"(batches 3-4 quiet); worst final residual a batch "
        + ", ".join(f"{v:.3e}" for v in res))
    del wsrv, wex, xs

    # -- the CLIs ---------------------------------------------------------
    cdir = ROOT / "build" / "phase14_cli"
    shutil.rmtree(cdir, ignore_errors=True)
    args = ["--requests", "12", "--systems", "2", "--batch", "4",
            "--iters", "400", "--use-kernel", "--store-dir",
            str(cdir / "store")]
    texts = []
    for extra in ([], ["--async"]):
        rc, text = captured_stdout(lambda: serve_cli.main(args + extra),
                                   "phase 14 serve_linsys "
                                   + " ".join(extra or ["sync"]), card)
        assert rc == 0
        texts.append(text)
    assert "misses=2" in texts[0] and "disk_hits=2" in texts[1], texts
    assert "misses=0" in texts[1] and "0 shed" in texts[1]
    for i in range(2):
        rc, text = captured_stdout(lambda: solve_cli.main(
            CLI_ARGS + ["--ckpt-dir", str(cdir / "ckpt"), "--resume",
                        "--store-dir", str(cdir / "solve_store")]),
            f"phase 14 solve run {i + 1}", card)
        assert rc == 0
        assert (f"checkpointed at iter {200 * (i + 1)}" in text
                and ("resuming from checkpointed state at iter 200" in text)
                == (i == 1)), text
    shutil.rmtree(cdir, ignore_errors=True)


def mesh_check(label, x, res, err, itt, loc) -> tuple[float, float]:
    """Hold a mesh run (x, residuals, errors, iters_to_tol) to the local
    SolveResult ``loc`` within the mesh contract: (max|Δx|, max|Δ
    history|)."""
    x = torch.as_tensor(x).to(loc.x)
    res = torch.as_tensor(res).to(loc.residuals)
    dx = float((x - loc.x).abs().max())
    dh = float((res - loc.residuals).abs().max())
    assert torch.allclose(x, loc.x, **MESH_X), (label, dx)
    assert torch.allclose(res, loc.residuals, **MESH_H), (label, dh)
    if err is not None and loc.errors is not None:
        assert torch.allclose(torch.as_tensor(err).to(loc.errors),
                              loc.errors, **MESH_H), label
    assert np.array_equal(np.asarray(itt), np.asarray(loc.iters_to_tol)), \
        (label, itt, loc.iters_to_tol)
    return dx, dh


def same_result(a, b) -> bool:
    """Two SolveResults bit for bit: x, the histories, the counter."""
    same = torch.equal(a.x, b.x) and torch.equal(a.residuals, b.residuals)
    if a.errors is not None or b.errors is not None:
        same = same and torch.equal(a.errors, b.errors)
    return same and a.state.t == b.state.t


def mesh_phase(card, dsys, dfac, sp, fs, pinned, sp_pinned,
               form_launches) -> dict:
    """Phase 16: the mesh backend on the card.  Returns the launches of
    each kernel in (a)'s mesh runs, counted from 0 just before each."""
    import torch.distributed as dist

    from repro_torch import device as dev
    from repro_torch import solvers
    from repro_torch.analysis import tracecheck
    from repro_torch.kernels import block_projection as bp
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.solvers import executor
    t16 = time.time()
    # (a) one rank over NCCL: the default group this process starts
    created = not dist.is_initialized()
    mesh = mesh_lib.solver_mesh(1, 1)
    say(f"phase 16 (a) mesh (('data', 1), ('model', 1)) over "
        f"{dist.get_world_size()} rank(s), {dist.get_backend()} on "
        f"{mesh_lib.mesh_device(mesh)}")
    mplan = solvers.ExecutionPlan(backend="mesh", mesh=mesh, kernel=True)
    lplan = solvers.ExecutionPlan(kernel=True, factors=dfac)
    mesh_launches, local = {}, {}
    chunk = executor.CHUNK
    replayed = (ITERS - chunk) // chunk * chunk
    from_replays = (f"{replayed} of them from {replayed // chunk} replays "
                    f"of the captured {chunk}-step graph")

    def turns(fns, reps=4):
        """Median host ms of each whole solve (card idle to idle), the
        solves timed in turns; a key ending in "eager" runs under
        ``executor.disable_capture()``."""
        got = {k: [] for k in fns}
        for _ in range(reps):
            for k, fn in fns.items():
                with (executor.disable_capture() if k.endswith("eager")
                      else contextlib.nullcontext()):
                    got[k].append(timed_ms(fn)[1])
        return {k: float(np.median(v)) for k, v in got.items()}

    def per_iter(ms):
        return ", ".join(f"{k} {v / ITERS:.4f}" for k, v in ms.items())

    def captured_vs_eager(label, run, pair, kernels):
        """``run()`` captured (one capture, ITERS launches of each kernel,
        from its replays) and under ``disable_capture()``, bit for bit."""
        ops.reset_launch_counts()
        with tracecheck() as tc:
            cap = run()
        torch.cuda.synchronize()
        got = form_launches(pair)
        assert got == {kn: ITERS if kn in kernels else 0
                       for kn in bp.KERNELS}, (label, got)
        caps = [e.fun for e in tc.traces("capture *")]
        assert len(caps) == 1, (label, caps)
        with executor.disable_capture():
            eager = run()
        same = same_result(cap, eager)
        assert same, (label, float((cap.x - eager.x).abs().max()))
        return caps[0], got

    n_caps = 0
    for sname in ("apc", "consensus", "cimmino"):
        s, prm = solvers.get(sname), pinned[sname][0]
        loc = local[sname] = s.solve(dsys, iters=ITERS, plan=lplan, **prm)
        ops.reset_launch_counts()
        with tracecheck() as tc:
            r = s.solve(dsys, iters=ITERS, plan=mplan, **prm)  # on-mesh prepare
        torch.cuda.synchronize()
        got = form_launches("f64")
        assert got == {kn: ITERS if kn in USES[sname] else 0
                       for kn in bp.KERNELS}, (sname, got)
        assert len(tc.traces("capture *")) == 1, tc.summary()
        for kn in USES[sname]:
            mesh_launches.setdefault(kn, got[kn])
        dx, dh = mesh_check(sname, r.x, r.residuals, r.errors,
                            r.iters_to_tol, loc)
        fplan = mplan.replace(factors=dfac)
        one = lambda: s.solve(dsys, iters=ITERS, plan=fplan,  # noqa: E731
                              **prm)
        _, Bk = consistent(dsys, K_MANY, 16)
        many = lambda: s.solve_many(dsys, Bk, iters=ITERS,  # noqa: E731
                                    plan=fplan, **prm)
        cap1, _ = captured_vs_eager(f"{sname} k=1", one, "f64",
                                    USES[sname])
        cap8, _ = captured_vs_eager(f"{sname} k={K_MANY}", many, "f64",
                                    USES[sname])
        n_caps += 3
        ms = turns({
            "mesh captured": one, "mesh eager": one,
            "local captured": lambda: s.solve(dsys, iters=ITERS,
                                              plan=lplan, **prm)}, reps=3)
        timed8 = ""
        if sname == "apc":              # the others stream the same bytes
            timed8 = "; k={} {}".format(K_MANY, per_iter(turns({
                "mesh captured": many, "mesh eager": many,
                "local captured": lambda: s.solve_many(
                    dsys, Bk, iters=ITERS, plan=lplan, **prm)}, reps=3)))
        say(f"phase 16 (a) {sname} dense kernel=True {ITERS} iters: mesh vs "
            f"local max|Δx| {dx:.3e} max|Δ history| {dh:.3e} (x rtol "
            f"{MESH_X['rtol']:.0e} atol {MESH_X['atol']:.0e}, history rtol "
            f"{MESH_H['rtol']:.0e} atol {MESH_H['atol']:.0e}), iters_to_tol "
            f"{r.iters_to_tol} both; launches {got}, {from_replays}; "
            f"captured ({cap1}, {cap8}) ≡ disable_capture() bit for bit at "
            f"k=1 and k={K_MANY} True; whole solve ms an iteration (factors "
            f"given, median of 3 in turns): k=1 {per_iter(ms)}{timed8} "
            f"[{card}]")
    s, prm = solvers.get("apc"), pinned["apc"][0]
    _, Bk = consistent(dsys, K_MANY, 16)
    loc = s.solve_many(dsys, Bk, iters=ITERS, plan=lplan, **prm)
    ops.reset_launch_counts()
    r = s.solve_many(dsys, Bk, iters=ITERS, plan=mplan.replace(factors=dfac),
                     **prm)
    torch.cuda.synchronize()
    got = form_launches("f64")
    assert got == {kn: ITERS if kn in USES["apc"] else 0
                   for kn in bp.KERNELS}, got
    dx, dh = mesh_check("solve_many", r.x, r.residuals, None,
                        r.iters_to_tol, loc)
    say(f"phase 16 (a) apc solve_many k={K_MANY}: mesh vs local max|Δx| "
        f"{dx:.3e} max|Δ history| {dh:.3e}; launches {got} [{card}]")
    for sname in ("apc", "cimmino"):
        s, prm = solvers.get(sname), sp_pinned[sname][0]
        sloc = solvers.ExecutionPlan(kernel=True, factors=fs)
        loc = s.solve(sp, iters=ITERS, plan=sloc, **prm)
        ops.reset_launch_counts()
        r = s.solve(sp, iters=ITERS, plan=mplan, **prm)
        torch.cuda.synchronize()
        got = form_launches("f64")
        assert got == {kn: ITERS if kn in SPARSE_USES[sname] else 0
                       for kn in bp.KERNELS}, (sname, got)
        for kn in SPARSE_USES[sname]:
            mesh_launches.setdefault(kn, got[kn])
        dx, dh = mesh_check(f"sparse {sname}", r.x, r.residuals, r.errors,
                            r.iters_to_tol, loc)
        fplan = mplan.replace(factors=fs)
        one = lambda: s.solve(sp, iters=ITERS, plan=fplan,  # noqa: E731
                              **prm)
        _, Bs = consistent(sp, K_MANY, 17)
        many = lambda: s.solve_many(sp, Bs, iters=ITERS,  # noqa: E731
                                    plan=fplan, **prm)
        captured_vs_eager(f"sparse {sname} k=1", one, "f64",
                          SPARSE_USES[sname])
        captured_vs_eager(f"sparse {sname} k={K_MANY}", many, "f64",
                          SPARSE_USES[sname])
        n_caps += 2
        ms = turns({"mesh captured": one, "mesh eager": one,
                    "local captured": lambda: s.solve(sp, iters=ITERS,
                                                      plan=sloc, **prm)})
        ms8 = turns({"mesh captured": many, "mesh eager": many,
                     "local captured": lambda: s.solve_many(
                         sp, Bs, iters=ITERS, plan=sloc, **prm)})
        say(f"phase 16 (a) {sname} sparse kernel=True: mesh vs local "
            f"max|Δx| {dx:.3e} max|Δ history| {dh:.3e}; launches {got}; "
            f"captured ≡ disable_capture() bit for bit at k=1 and "
            f"k={K_MANY} True; whole solve ms an iteration (median of 4 in "
            f"turns): k=1 {per_iter(ms)}; k={K_MANY} {per_iter(ms8)} "
            f"[{card}]")
    s, prm = solvers.get("apc"), pinned["apc"][0]
    mixed = dict(kernel=True, precision="mixed", factors=dfac)
    loc = s.solve(dsys, iters=ITERS, plan=solvers.ExecutionPlan(**mixed),
                  **prm)
    ops.reset_launch_counts()
    r = s.solve(dsys, iters=ITERS, plan=mplan.replace(**mixed), **prm)
    torch.cuda.synchronize()
    got = form_launches("bf16_f64")
    assert got == {kn: ITERS if kn in USES["apc"] else 0
                   for kn in bp.KERNELS}, got
    dx, dh = mesh_check("mixed", r.x, r.residuals, r.errors,
                        r.iters_to_tol, loc)
    say(f"phase 16 (a) apc precision=mixed: mesh vs local max|Δx| {dx:.3e} "
        f"max|Δ history| {dh:.3e}; launches {got} [{card}]")
    say(f"phase 16 (a) compile-once on NCCL: {n_caps} captured mesh "
        f"histories checked against disable_capture(), one capture each "
        f"(tracecheck); every mesh solve of (a) ran captured")
    if created:
        dist.destroy_process_group()

    # (b) two ranks on the one card over gloo, each a process of its own;
    # they need the memory this process's allocator caches (among it the
    # pools of (a)'s freed graphs)
    gc.collect()
    torch.cuda.empty_cache()
    say(f"phase 16 (b) before spawning: this process holds "
        f"{torch.cuda.memory_allocated() / 1e9:.3f} GB allocated, "
        f"{torch.cuda.memory_reserved() / 1e9:.3f} GB reserved")
    cfg = dict(full=FULL, iters=ITERS, world=2, shapes=MESH_SHAPES,
               device=dev.resolve("cuda").type,
               params={k: pinned[k][0] for k in ("apc", "cimmino")})
    t = time.time()
    ranks = spawn_ranks("--mesh-rank", ROOT / "build" / "phase16", cfg,
                        MESH_DEADLINE)
    caps = [int(rk["captures"]) for rk in ranks]
    assert caps == [0, 0], caps
    say(f"phase 16 (b) two ranks over gloo on {cfg['device']}: the system "
        f"{FULL} made on each rank's host in "
        f"{float(ranks[0]['t_data']):.2f} s, each rank copying its own "
        f"shard alone; captures {caps} (gloo runs the same chunks "
        f"eagerly); {time.time() - t:.1f} s in all")
    for shape in MESH_SHAPES:
        tag = "x".join(map(str, shape))
        for sname in ("apc", "cimmino"):
            key = f"{tag}/{sname}"
            assert np.array_equal(ranks[1][f"{key}/x"], ranks[0][f"{key}/x"])
            g = ranks[0]
            dx, dh = mesh_check(key, g[f"{key}/x"], g[f"{key}/res"],
                                g[f"{key}/err"], g[f"{key}/itt"],
                                local[sname])
            for rk in ranks:
                if cfg["device"] == "cuda":
                    assert rk[f"{key}/launches"].tolist() == [ITERS] * 2, key
                    took = dict(x.split(":") for x in rk[f"{key}/inst"])
                    # one instance a kernel; the gathers' contiguous shards
                    # admit the ring, so a launch on a strided view (the
                    # row dot) fails here
                    assert len(took) == len(rk[f"{key}/inst"]) and \
                        sorted(took) == sorted(USES[sname]), (key, took)
                    assert took[USES[sname][0]] == "ring", (key, took)
            per = "; ".join(
                f"rank {i}: resident {float(rk[f'{key}/gb']):.3f} GB, "
                f"instances launched "
                f"{', '.join(rk[f'{key}/inst'].tolist()) or 'none (plain versions)'}, "
                f"launches {rk[f'{key}/launches'].tolist()}, kernel vs "
                f"plain on its shards "
                + ", ".join(
                    f"{kn} {tuple(rk[f'{key}/{kn}/shape'].tolist())} "
                    f"max|Δ| {float(rk[f'{key}/{kn}/err']):.3e}"
                    for kn in USES[sname])
                + f"; {float(rk[f'{key}/ms']) / ITERS:.4f} ms an iteration; "
                f"a run with every all_reduce between two synchronizes: "
                f"{float(rk[f'{key}/ms_sync']) / ITERS:.4f} ms an "
                f"iteration, all_reduce "
                f"{float(rk[f'{key}/ms_ar']) / ITERS:.4f} ms of it "
                f"({100 * float(rk[f'{key}/ms_ar'] / rk[f'{key}/ms_sync']):.1f} %)"
                for i, rk in enumerate(ranks))
            say(f"phase 16 (b) mesh (data, model) {shape} {sname} "
                f"kernel=True {ITERS} iters: vs (a)'s local max|Δx| "
                f"{dx:.3e} max|Δ history| {dh:.3e}, x the same on both "
                f"ranks; kernels vs plain within "
                f"{TOL[torch.float64]:.0e} of max|plain| + 1; {per} [{card}]")
    say(f"phase 16: {time.time() - t16:.1f} s")
    return mesh_launches


def mesh_rank(argv) -> int:
    """Phase 16 (b)'s rank ``argv[0]``: ``chip_smoke.py --mesh-rank R DIR
    CONFIG`` joins a gloo group through a FileStore in DIR, makes the
    CONFIG's dense system on the host, and runs APC and Cimmino on the
    kernels on each of its meshes; it writes rank R's records to
    DIR/rankR.npz and prints nothing."""
    rank, out, cfg = int(argv[0]), pathlib.Path(argv[1]), json.loads(argv[2])
    sys.path.insert(0, str(ROOT / "src"))
    import torch.distributed as dist

    from repro_torch import solvers
    from repro_torch.data import linsys
    from repro_torch.kernels import block_projection as bp
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.solvers import mesh as mesh_backend
    torch.set_num_threads(1)
    device = torch.device(cfg["device"])
    cuda = device.type == "cuda"
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    join_group(rank, out, cfg["world"])
    got = {}
    try:
        with captures_into(got):
            t = time.time()
            system = linsys.tall_gaussian(**cfg["full"], seed=0, device="cpu")
            got["t_data"] = time.time() - t
            with env_var(ENGINE_ENV, "fused"):
                for shape in cfg["shapes"]:
                    mesh = mesh_lib.make_mesh(shape, ("data", "model"),
                                              device=device)
                    for sname in ("apc", "cimmino"):
                        key = f"{'x'.join(map(str, shape))}/{sname}"
                        s = solvers.get(sname)
                        cs = mesh_backend.compile_solve(
                            s, system, mesh=mesh, iters=cfg["iters"],
                            use_kernel=True, **cfg["params"][sname])
                        sync()
                        got[f"{key}/gb"] = (torch.cuda.memory_allocated() / 1e9
                                            if cuda else 0.0)
                        ops.reset_launch_counts()
                        with kernel_calls(ops, USES[sname]) as calls:
                            (state, res, err), seen = launched_instances(
                                lambda: cs.run(*cs.args))
                            sync()
                        launches = ops.launch_counts()
                        got[f"{key}/launches"] = np.asarray(
                            [launches[kn] for kn in USES[sname]])
                        got[f"{key}/inst"] = np.asarray(sorted(
                            f"{kn}:{inst}" for kn, inst in seen))
                        got[f"{key}/x"] = s.extract(state).cpu().numpy()
                        got[f"{key}/res"] = res.cpu().numpy()
                        got[f"{key}/err"] = err.cpu().numpy()
                        got[f"{key}/itt"] = np.asarray(
                            solvers.iters_to_tolerance(res, 1e-6))
                        # each kernel on the operands of its first launch in
                        # the run (this rank's shards) against its plain version
                        for kn, (wrapper, args) in calls.items():
                            y = wrapper(*args)
                            sync()
                            e, d = rel_err(y, getattr(ops, WRAPPERS[kn][1])(
                                *args))
                            assert e < TOL[y.dtype], (key, kn, e)
                            got[f"{key}/{kn}/err"] = d
                            got[f"{key}/{kn}/shape"] = np.asarray(
                                args[0].shape)
                        sync()
                        t = time.perf_counter()
                        cs.run(*cs.args)
                        sync()
                        got[f"{key}/ms"] = (time.perf_counter() - t) * 1e3
                        # the all_reduce's share, from one run whose every
                        # all_reduce is timed between two synchronizes: the
                        # share is of that run's own time
                        with timed_collective("all_reduce", [0.0], sync) as spent:
                            t = time.perf_counter()
                            cs.run(*cs.args)
                            sync()
                        got[f"{key}/ms_sync"] = (time.perf_counter() - t) * 1e3
                        got[f"{key}/ms_ar"] = spent[0]
                        # the next solve's resident GB holds none of these
                        del cs, state, calls, wrapper, args, y
    finally:
        dist.destroy_process_group()
    np.savez(out / f"rank{rank}.npz", **got)
    return 0


def spawn_ranks(flag: str, out: pathlib.Path, cfg: dict,
                deadline: float) -> list:
    """Run ``chip_smoke.py FLAG R OUT CONFIG`` for each rank R of
    ``cfg["world"]``, all at once; past ``deadline`` seconds every one is
    killed and the phase fails, as it does when a rank exits non-zero.
    Every rank's records (OUT/rankR.npz)."""
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    t = time.time()
    procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"),
                               flag, str(r), str(out), json.dumps(cfg)])
             for r in range(cfg["world"])]
    try:
        for p in procs:
            rc = p.wait(timeout=max(1.0, deadline - (time.time() - t)))
            assert rc == 0, f"{flag}: a rank exited with {rc}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [dict(np.load(out / f"rank{r}.npz", allow_pickle=True))
            for r in range(cfg["world"])]


@contextlib.contextmanager
def captures_into(got: dict):
    """Inside, every CUDA graph capture (``tracecheck``) is counted into
    ``got["captures"]``: a spawned gloo rank must capture none."""
    from repro_torch.analysis import tracecheck
    with tracecheck() as tc:
        yield
    got["captures"] = np.asarray(len(tc.traces("capture *")))


def join_group(rank: int, out: pathlib.Path, world: int):
    """A spawned rank's gloo group, through a FileStore in ``out``."""
    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.FileStore(
        str(out / "store"), world), rank=rank, world_size=world)


@contextlib.contextmanager
def timed_collective(name: str, spent: list, sync):
    """Inside, each ``torch.distributed.<name>`` call is timed between
    two calls of ``sync`` (the rank's device's synchronize), its ms added
    to ``spent[0]``."""
    import torch.distributed as dist
    real = getattr(dist, name)

    def timed(*a, **k):
        sync()
        t = time.perf_counter()
        work = real(*a, **k)
        sync()
        spent[0] += (time.perf_counter() - t) * 1e3
        return work
    setattr(dist, name, timed)
    try:
        yield spent
    finally:
        setattr(dist, name, real)


def served_close(label, xs, residuals, ref,
                 residual_tol=None) -> tuple[float, float]:
    """Hold served answers (x rows, final residuals) to ``ref``, the
    local server's ``Served`` for the same requests: x within the mesh
    contract, the residual within 1e-6 relative (tests/test_linsys_server
    .py), or within ``residual_tol`` (``np.isclose`` keywords) where the
    residuals sit at the rounding floor.  (max|Δx|, max relative Δ
    residual)."""
    assert len(xs) == len(ref), label
    dx = dr = 0.0
    for x, res, e in zip(xs, residuals, ref):
        assert np.allclose(x, e.x, **MESH_X), (label, e.rid)
        d = abs(res - e.residual) / abs(e.residual)
        assert (d <= SERVE_RES_REL if residual_tol is None else
                np.isclose(res, e.residual, **residual_tol)), (label, e.rid,
                                                               d)
        dx, dr = max(dx, float(np.abs(x - e.x).max())), max(dr, d)
    return dx, dr


def mesh_serving_phase(card, form_launches, dsys, sp, pinned,
                       sp_pinned) -> dict:
    """Phase 17: mesh serving.  Returns the launches of each kernel in a
    mesh-served batch, counted from 0 just before each mesh server's
    batch and read just after."""
    import torch.distributed as dist

    from repro_torch import device as dev
    from repro_torch import solvers
    from repro_torch.analysis import tracecheck
    from repro_torch.data import linsys
    from repro_torch.kernels import block_projection as bp
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.solvers import executor
    t17 = time.time()
    uses = lambda kns, n: {kn: n if kn in kns else 0  # noqa: E731
                           for kn in bp.KERNELS}
    created = not dist.is_initialized()
    mesh = mesh_lib.solver_mesh(1, 1)
    say(f"phase 17 (a) mesh serving, mesh (('data', 1), ('model', 1)) over "
        f"{dist.get_world_size()} rank(s), {dist.get_backend()} on "
        f"{mesh_lib.mesh_device(mesh)}")
    dprm = pinned["apc"][0]
    n_req = 3 * K_MANY + 5
    xs, rhs = consistent(dsys, n_req, 14)
    store = solvers.FactorStore()
    kw = dict(solver="apc", iters=ITERS, batch=K_MANY, use_kernel=True)
    srvs = {"local": solvers.LinsysServer(store, **kw, **dprm),
            "mesh": solvers.LinsysServer(store, backend="mesh", mesh=mesh,
                                         **kw, **dprm),
            "mesh eager": solvers.LinsysServer(store, backend="mesh",
                                               mesh=mesh, **kw, **dprm)}
    fps = {tag: srv.register(dsys) for tag, srv in srvs.items()}
    assert len(set(fps.values())) == 1
    for tag, srv in srvs.items():
        for b in rhs:
            srv.submit(fps[tag], b)
    outs = {tag: [] for tag in srvs}
    ms = {tag: [] for tag in srvs}
    launched = {tag: [] for tag in srvs}
    events = []
    for i in range(4):                  # the batches, the servers in turns
        for tag, srv in srvs.items():
            ops.reset_launch_counts()
            with (executor.disable_capture() if tag == "mesh eager"
                  else contextlib.nullcontext()), \
                    tracecheck(steady_state=tag == "mesh" and i > 0) as tc:
                out, t_ms = timed_ms(srv.step)
            if tag == "mesh" and i == 0:
                events = [e.fun for e in tc.traces()]
            launched[tag].append(form_launches("f64"))
            outs[tag] += out
            ms[tag].append(t_ms)
    assert all(srv.step() == [] for srv in srvs.values())
    chunk = executor.CHUNK
    # the first captured batch adds its warm-up head's launches
    for tag, first in (("mesh", ITERS + chunk), ("mesh eager", ITERS)):
        assert launched[tag] == [uses(USES["apc"], first)] + [
            uses(USES["apc"], ITERS)] * 3, (tag, launched[tag])
    msrv, local = srvs["mesh"], outs["local"]
    (mex,) = msrv._executors.values()
    assert events == ["build apc.cold", "capture apc.cold"], events
    assert (msrv.stats.executor_builds, mex.builds, mex.captures,
            msrv.jit_cache_size()) == (1, 1, 1, 1)
    assert srvs["mesh eager"]._executors[
        next(iter(srvs["mesh eager"]._executors))].captures == 0
    assert [r.rid for r in outs["mesh"]] == list(range(n_req))
    same = {tag: all(np.array_equal(a.x, b.x) and a.residual == b.residual
                     for a, b in zip(outs["mesh"], outs[tag]))
            for tag in ("mesh eager", "local")}
    assert all(same.values()), same
    dx, dr = served_close("dense apc", [r.x for r in outs["mesh"]],
                          [r.residual for r in outs["mesh"]], local)
    err = max(float(np.linalg.norm(r.x - xs[r.rid].cpu().numpy())
                    / np.linalg.norm(xs[r.rid].cpu().numpy()))
              for r in outs["mesh"])
    assert err <= 1e-8, err
    rate = {t: (n_req - K_MANY) / sum(v[1:]) * 1e3 for t, v in ms.items()}
    say(f"phase 17 (a) dense apc mesh server k={K_MANY}, {ITERS} "
        f"iterations, {n_req} requests in 4 batches (3 pad slots): the "
        f"mesh server's first batch {events}, batches 2-4 quiet under "
        f"tracecheck(steady_state=True); builds {mex.builds} captures "
        f"{mex.captures} programs {msrv.jit_cache_size()}; bit-equal to "
        f"the eager mesh server {same['mesh eager']} and to the local "
        f"server {same['local']} (x and residuals); vs x_true max rel "
        f"{err:.3e}; launches a batch "
        f"{[g['apc_gather'] for g in launched['mesh']]} (apc_gather) "
        f"{[g['apc_scatter'] for g in launched['mesh']]} (apc_scatter; the "
        f"first with its warm-up head's {chunk}); ms a batch "
        + "; ".join(f"{tag} {', '.join(f'{v:.1f}' for v in ms[tag])}"
                    for tag in ("mesh", "mesh eager", "local"))
        + f" (mesh and local captured; in turns, each first with its "
        f"capture, local's also with the store miss's prepare); RHS/s over "
        f"batches 2-4 "
        + ", ".join(f"{tag} {rate[tag]:.2f}" for tag in srvs)
        + f" (padding excluded; host clock to synchronize()) [{card}]")
    for srv in srvs.values():
        srv.close()
    assert msrv.jit_cache_size() == 0
    launched = launched["mesh"]
    mesh_launches = {kn: launched[-1][kn] for kn in USES["apc"]}
    asrv = solvers.AsyncLinsysServer(store, backend="mesh", mesh=mesh,
                                     pipeline_depth=2, **kw, **dprm)
    afp = asrv.register(dsys)
    for b in rhs:
        asrv.submit(afp, b)
    ops.reset_launch_counts()
    aout, a_ms = timed_ms(asrv.drain)
    a_launched = form_launches("f64")
    a_caps = sum(ex.captures for ex in asrv._executors.values())
    asrv.close()
    assert a_launched == uses(USES["apc"], 4 * ITERS + chunk), a_launched
    assert a_caps == 1, a_caps
    adx, adr = served_close("async", [r.x for r in aout],
                            [r.residual for r in aout], local)
    same = all(np.array_equal(a.x, m.x) for a, m in zip(aout,
                                                        outs["mesh"]))
    assert same
    rep = asrv.latency_report()
    say(f"phase 17 (a) dense apc async mesh server (its assembly thread "
        f"announces and runs each batch): {n_req} requests in {a_ms:.1f} ms "
        f"({n_req / a_ms * 1e3:.2f} RHS/s), latency p50/p95/p99 "
        f"{rep['p50_ms']:.1f}/{rep['p95_ms']:.1f}/{rep['p99_ms']:.1f} ms "
        f"(all sent at t = 0); vs local max|Δx| {adx:.3e} max rel Δ "
        f"residual {adr:.3e}; bit-equal to the sync mesh server {same}; "
        f"captures {a_caps} (on the assembly thread); launches "
        f"{a_launched} [{card}]")
    del srvs, msrv, asrv, aout, store
    gc.collect()
    # the other kernels: one batch each of dense Cimmino (on the cut
    # system of phase 18: a new system's fingerprint hashes its A on the
    # host, 5-6 s at the main path's size), sparse APC at
    # precision="mixed" (the serving phase's sparse traffic) and sparse
    # Cimmino, mesh against local
    csys = linsys.tall_gaussian(**RED_CUT, seed=1, device="cuda")
    for sname, system, prm, precision, kernels, pair in (
            ("cimmino", csys, solvers.get("cimmino").resolve_params(csys),
             "default", USES["cimmino"], "f64"),
            ("apc", sp, sp_pinned["apc"][0], "mixed", SPARSE_USES["apc"],
             "bf16_f64"),
            ("cimmino", sp, sp_pinned["cimmino"][0], "default",
             SPARSE_USES["cimmino"], "f64")):
        _, Bs = consistent(system, 2 * K_MANY, 17)
        store = solvers.FactorStore()
        got = {}
        for tag, extra in (("local", {}),
                           ("mesh", dict(backend="mesh", mesh=mesh))):
            srv = solvers.LinsysServer(store, solver=sname, iters=ITERS,
                                       batch=K_MANY, use_kernel=True,
                                       precision=precision, **extra, **prm)
            fp = srv.register(system)
            for b in Bs:
                srv.submit(fp, b)
            first, t_first = timed_ms(srv.step)     # its build and capture
            ops.reset_launch_counts()
            second, t_ms = timed_ms(srv.step)
            got[tag] = (first + second, t_first, t_ms)
            if tag == "mesh":
                counts = form_launches(pair)
                (mex,) = srv._executors.values()
                assert (mex.builds, mex.captures) == (1, 1), sname
            srv.close()
        assert counts == uses(kernels, ITERS), (sname, counts)
        for kn in kernels:
            mesh_launches.setdefault(kn, counts[kn])
        mout = got["mesh"][0]
        sdx, sdr = served_close(f"{system.structure} {sname}",
                                [r.x for r in mout],
                                [r.residual for r in mout], got["local"][0])
        say(f"phase 17 (a) {system.structure} {sname} precision={precision} "
            f"mesh server k={K_MANY}, N={system.N} n={system.n} m={system.m}, "
            f"two batches: vs local max|Δx| "
            f"{sdx:.3e} max rel Δ residual {sdr:.3e}; one capture; ms mesh "
            f"{got['mesh'][1]:.1f} then {got['mesh'][2]:.1f}, local "
            f"{got['local'][1]:.1f} then {got['local'][2]:.1f} (the first "
            f"batch: the store's miss, the capture); launches of the second "
            f"{counts} [{card}]")
        del store, srv, got, mout
    del csys
    if created:
        dist.destroy_process_group()
    # the spawned ranks need the memory this process's allocator caches
    gc.collect()
    torch.cuda.empty_cache()

    # (b) two ranks on the one card over gloo: rank 0 admits, the other
    # follows; then the serving CLI at world 2 on a cut system
    rdir = ROOT / "build" / "phase17"
    rhs_file = ROOT / "build" / "phase17_rhs.npy"
    rhs_file.parent.mkdir(parents=True, exist_ok=True)
    np.save(rhs_file, rhs)
    cfg = dict(full=FULL, iters=ITERS, k=K_MANY, world=2,
               device=dev.resolve("cuda").type, params=dprm,
               rhs=str(rhs_file), cli=SERVE_CLI_ARGS)
    t = time.time()
    g0, g1 = spawn_ranks("--serve-rank", rdir, cfg, SERVE_DEADLINE)
    rhs_file.unlink()
    # two ranks sum u over column shards: the residuals, at the rounding
    # floor after 150 iterations, are held to the history contract
    bdx, bdr = served_close("two ranks", g0["x"], g0["res"], local,
                            residual_tol=MESH_H)
    assert int(g1["served"]) == 4 and "rank 0 admits" in str(g1["refused"])
    caps = [int(g["captures"]) for g in (g0, g1)]
    assert caps == [0, 0], caps
    share = float(g0["ms_bcast"] / g0["ms_sync"])
    insts = []
    for i, g in enumerate((g0, g1)):
        if cfg["device"] == "cuda":
            # the four batches and the synchronized one
            assert g["launches"].tolist() == [5 * ITERS] * 2, g["launches"]
            took = dict(x.split(":") for x in g["inst"])
            assert sorted(took) == sorted(USES["apc"]), took
        insts.append(f"rank {i}: instances "
                     f"{', '.join(g['inst'].tolist()) or 'none (plain versions)'}"
                     f", launches {g['launches'].tolist()}")
    say(f"phase 17 (b) two ranks over gloo on {cfg['device']}, mesh (data, "
        f"model) (1, 2), the system {FULL} made and registered on each "
        f"rank (fingerprints compared): rank 0 admitted {n_req} requests "
        f"in 4 batches and answered them, the follower served "
        f"{int(g1['served'])} batches and stopped on the stop flag, "
        f"answering none; vs (a)'s local answers max|Δx| {bdx:.3e} (rtol "
        f"{MESH_X['rtol']:.0e} atol {MESH_X['atol']:.0e}), max rel Δ "
        f"residual {bdr:.3e} (rtol {MESH_H['rtol']:.0e} atol "
        f"{MESH_H['atol']:.0e}: the residuals sit at the rounding floor, "
        f"{min(float(r) for r in g0['res']):.1e} and up); ms a batch "
        f"{', '.join(f'{v:.1f}' for v in g0['ms'])}; a batch with every "
        f"broadcast between two synchronizes {float(g0['ms_sync']):.1f} ms, "
        f"the header's and the right-hand sides' broadcasts "
        f"{float(g0['ms_bcast']):.2f} ms of it ({100 * share:.2f} %); "
        f"{'; '.join(insts)}; captures {caps}; {time.time() - t:.1f} s in "
        f"all [{card}]")
    cut = " ".join(SERVE_CLI_ARGS)
    for line in g0["cli"]:
        say(f"phase 17 (b) serve_linsys --backend mesh at world 2 ({cut}): "
            f"{line} [{card}]")
    assert list(g1["cli"]) == []
    assert any(str(x).startswith("served ") for x in g0["cli"]), g0["cli"]
    say(f"phase 17 (b) the CLI's system is cut to {cut}: it draws "
        f"conditioned_gaussian systems, whose orthogonal basis is a QR of "
        f"an n x n Gaussian on each rank's host, O(n^3): minutes at the "
        f"main path's n = {FULL['n']} on the card's shared cores")
    say(f"phase 17: {time.time() - t17:.1f} s")
    return mesh_launches


def serve_rank(argv) -> int:
    """Phase 17 (b)'s rank ``argv[0]``: ``chip_smoke.py --serve-rank R DIR
    CONFIG`` joins a gloo group through a FileStore in DIR, makes and
    registers the CONFIG's dense system, and serves it on a 1 x 2 mesh:
    rank 0 admits the requests of CONFIG's ``rhs`` file and answers, the
    other follows; then both run the serving CLI.  It writes rank R's
    records to DIR/rankR.npz and prints nothing."""
    rank, out, cfg = int(argv[0]), pathlib.Path(argv[1]), json.loads(argv[2])
    sys.path.insert(0, str(ROOT / "src"))
    import torch.distributed as dist

    from repro_torch import solvers
    from repro_torch.data import linsys
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import serve_linsys as serve_cli
    torch.set_num_threads(1)
    device = torch.device(cfg["device"])
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    sync = torch.cuda.synchronize if device.type == "cuda" else (
        lambda: None)
    join_group(rank, out, cfg["world"])
    got = {}
    try:
        with captures_into(got):
            system = linsys.tall_gaussian(**cfg["full"], seed=0, device=device)
            mesh = mesh_lib.make_mesh((1, cfg["world"]), ("data", "model"),
                                      device=device)
            with env_var(ENGINE_ENV, "fused"):
                srv = solvers.LinsysServer(
                    solvers.FactorStore(), solver="apc", iters=cfg["iters"],
                    batch=cfg["k"], backend="mesh", mesh=mesh, use_kernel=True,
                    **cfg["params"])
                fp = srv.register(system)
                ops.reset_launch_counts()
                if rank == 0:
                    rhs = np.load(cfg["rhs"])
                    for b in rhs:
                        srv.submit(fp, b)
                    served, ms = [], []

                    def batches():
                        while True:
                            sync()
                            t = time.perf_counter()
                            batch = srv.step()
                            sync()
                            if not batch:
                                return
                            ms.append((time.perf_counter() - t) * 1e3)
                            served.extend(batch)
                    _, seen = launched_instances(batches)
                    # one more batch, every broadcast between two synchronizes
                    spent = [0.0]
                    srv.submit(fp, rhs[0])
                    with timed_collective("broadcast", spent, sync):
                        sync()
                        t = time.perf_counter()
                        srv.step()
                        sync()
                    got["ms_sync"] = (time.perf_counter() - t) * 1e3
                    got["ms_bcast"] = spent[0]
                    srv.close()
                    got["x"] = np.stack([r.x for r in served])
                    got["res"] = np.asarray([r.residual for r in served])
                    got["ms"] = np.asarray(ms)
                else:
                    try:
                        srv.submit(fp, np.zeros(system.N))
                        got["refused"] = np.asarray("")
                    except RuntimeError as e:
                        got["refused"] = np.asarray(str(e))
                    n, seen = launched_instances(srv.serve_follower)
                    got["served"] = np.asarray(n - 1)   # less the timed batch
                launches = ops.launch_counts()
                got["launches"] = np.asarray([launches["apc_gather"],
                                              launches["apc_scatter"]])
                got["inst"] = np.asarray(sorted(f"{kn}:{inst}"
                                                for kn, inst in seen))
                del srv, system
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    assert serve_cli.main(
                        cfg["cli"] + ["--device", cfg["device"]]) == 0
                got["cli"] = np.asarray(buf.getvalue().splitlines(),
                                        dtype=object)
    finally:
        dist.destroy_process_group()
    np.savez(out / f"rank{rank}.npz", **got)
    return 0


def redundancy_phase(card, dsys, chol, pinned) -> None:
    """Phase 18: redundant execution and the elastic runtime on the dense
    main path (no kernel: the replicated layout has none)."""
    import torch.distributed as dist

    from repro_torch import device as dev
    from repro_torch import solvers
    from repro_torch.data import linsys
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.runtime.fault import HeartbeatMonitor
    from repro_torch.solvers import executor, redundant
    from repro_torch.solvers.projection import (ProjFactors,
                                                _cho_solve_replicas)
    t18 = time.time()
    name = torch.cuda.get_device_name(0)
    m = dsys.m
    rot = rotating_straggler(m)
    F = ProjFactors(A=dsys.A_blocks, chol=chol)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    say(f"phase 18 data: the dense main path's A and Cholesky factors "
        f"resident, {base / 1e9:.3f} GB (the kernels' B freed)")
    Plan = solvers.ExecutionPlan
    for sname in ("apc", "consensus", "cimmino"):
        s, prm = solvers.get(sname), pinned[sname][0]
        plain = s.solve(dsys, iters=ITERS, plan=Plan(factors=F), **prm)
        rplan = Plan(redundancy=2, alive_schedule=rot, factors=F)
        r = s.solve(dsys, iters=ITERS, plan=rplan, **prm)
        again = s.solve(dsys, iters=ITERS, plan=rplan, **prm)
        with executor.disable_capture():
            eager = s.solve(dsys, iters=ITERS, plan=rplan, **prm)
        torch.cuda.synchronize()
        dx, dh = mesh_check(f"redundant {sname}", r.x, r.residuals,
                            r.errors, r.iters_to_tol, plain)
        repeat = torch.equal(again.x, r.x) and torch.equal(
            again.residuals, r.residuals)
        vs_eager = torch.equal(eager.x, r.x) and torch.equal(
            eager.residuals, r.residuals)
        assert repeat, sname
        assert vs_eager, (sname, float((eager.x - r.x).abs().max()))
        line = (f"phase 18 {sname} redundancy=2, a rotating straggler, "
                f"{ITERS} iters: vs the plain unfused solve max|Δx| "
                f"{dx:.3e} max|Δ history| {dh:.3e} (x rtol "
                f"{MESH_X['rtol']:.0e} atol {MESH_X['atol']:.0e}, history "
                f"rtol {MESH_H['rtol']:.0e} atol {MESH_H['atol']:.0e}), "
                f"iters_to_tol {r.iters_to_tol} both; repeat bit-identical "
                f"{repeat}; captured ≡ eager (disable_capture) {vs_eager}")
        del plain, r, again, eager
        if sname != "apc":              # the same bytes as APC's
            say(f"{line} [{card}]")
            continue
        # ms an iteration: one engine's segment of ITERS steps, captured
        # (replays) and eager, against the plain unfused solve, in turns
        engine = redundant.RedundantEngine(s, dsys, r=2, factors=F, **prm)
        W = engine.lower(redundant.resolve_schedule(rot, m, ITERS))
        st0 = engine.init_state()
        engine.run(st0, W)
        turns = {"captured": [], "eager": [], "plain": []}
        for _ in range(3):
            for how in turns:
                def run(how=how):
                    if how == "plain":
                        return s.solve(dsys, iters=ITERS,
                                       plan=Plan(factors=F), **prm)
                    with (executor.disable_capture() if how == "eager"
                          else contextlib.nullcontext()):
                        return engine.run(st0, W)
                turns[how].append(timed_ms(run)[1] / ITERS)
        med = {how: float(np.median(v)) for how, v in turns.items()}
        say(f"{line}; ms an iteration (median of 3 "
            f"in turns, host clock to synchronize()): redundant captured "
            f"{med['captured']:.4f}, eager {med['eager']:.4f} (a "
            f"{ITERS}-step segment of one engine), plain unfused "
            f"{med['plain']:.4f} (the whole solve) = "
            f"{med['captured'] / med['plain']:.3f}x; engine captures "
            f"{engine.captures} [{card}]")
        # where a redundant iteration's time goes: its pieces on the
        # engine's replicated factors, CUDA events, and the Cholesky
        # solve the steps do not take (cuSOLVER's, MAGMA's) beside it
        f, st = engine._frep, st0
        d = st.xbar[None, None, :] - st.x
        u = torch.einsum("mrpn,mrn->mrp", f.A, d)

        def cho(lib):
            with linalg_library(lib):
                return torch.cholesky_solve(u.unsqueeze(-1), f.chol)
        h = engine._program.h
        part = medians_ms({
            "gather einsum": lambda: torch.einsum("mrpn,mrn->mrp", f.A, d),
            "two triangular solves": lambda: _cho_solve_replicas(f.chol, u),
            "scatter einsum": lambda: torch.einsum("mrpn,mrp->mrn", f.A, u),
            "residual": lambda: h.true_res(st),
            "cholesky_solve cuSOLVER": lambda: cho("cusolver"),
            "cholesky_solve MAGMA": lambda: cho("magma")}, reps=5, batch=3)
        a_rep = f.A.numel() * f.A.element_size()
        say(f"phase 18 apc redundant iteration, its pieces (CUDA events, "
            f"median of 5 runs of 3 in turns; the replicated A "
            f"{a_rep / 1e9:.2f} GB, {tuple(f.chol.shape)} Cholesky "
            f"factors): " + "; ".join(f"{k} {v:.4f} ms"
                                      for k, v in part.items())
            + f"; bytes bound of an iteration (the replicated A twice, A "
            f"once) {(2 * a_rep + a_rep / 2) / card_rates(name)[0] * 1e3:.4f}"
            f" ms [{card}]")
        del engine, st0, W, f, st, d, u, h
        gc.collect()
        torch.cuda.empty_cache()
    red_peak = torch.cuda.max_memory_allocated()

    # the elastic runtime on a cut system (each build and each
    # repartition fingerprints every block of A on the host): a death, a
    # same-size rejoin, a join 16 -> 17
    s = solvers.get("apc")
    csys = linsys.tall_gaussian(**RED_CUT, seed=1, device="cuda")
    cprm = s.resolve_params(csys)
    cm = csys.m
    mon = HeartbeatMonitor(n_workers=cm)
    t = time.time()
    # a store that keeps one system and one block: its block tier would
    # otherwise hold a copy of every block of A
    rt = solvers.ElasticRuntime(
        s, csys, plan=Plan(redundancy=2, store=solvers.FactorStore(
            capacity=1, block_capacity=1)), monitor=mon, segment=25, **cprm)
    t_build = time.time() - t
    mask = np.ones(cm, bool)
    mask[2] = False
    death = ITERS // 3                  # worker 2 dies after this many
    sched = np.stack([np.ones(cm, bool)] * death + [mask] * (ITERS - death))
    ref = s.solve(csys, iters=ITERS, plan=Plan(
        redundancy=2, alive_schedule=sched, factors=rt._current.factors),
        **cprm)
    gc.collect()
    rep1 = rt.run(iters=death)
    sizes = rt.engine_cache_sizes()
    mon.mark_dead(2)
    t = time.time()
    rep2 = rt.run(iters=ITERS - death)
    torch.cuda.synchronize()
    t_death = time.time() - t
    bit = torch.equal(rep2.x, ref.x) and torch.equal(
        torch.cat([rep1.residuals, rep2.residuals]), ref.residuals)
    assert bit and rep2.relowerings == 1 and rep2.iters == ITERS
    assert rt.engine_cache_sizes() == sizes and rt.engine.captures == 1, (
        sizes, rt.engine_cache_sizes())
    del ref
    mon.rejoin(2, resynced=True)
    rep3 = rt.run(iters=25)
    assert rep3.repartitions == 0 and rep3.fleet == tuple(range(cm))
    assert rt.engine_cache_sizes() == sizes
    mon.join(resynced=True)
    gc.collect()
    torch.cuda.empty_cache()
    t = time.time()
    rep4 = rt.run(iters=25)
    torch.cuda.synchronize()
    t_join = time.time() - t
    assert rep4.repartitions == 1 and rt.sys.m == cm + 1, rep4.fleet
    assert bool(torch.isfinite(rep4.residuals).all())
    caps = {size: part.engine.captures for size, part in rt._parts.items()}
    assert caps == {cm: 1, cm + 1: 1}, caps
    el_peak = torch.cuda.max_memory_allocated()
    say(f"phase 18 elastic apc redundancy=2 on tall_gaussian {RED_CUT} "
        f"(the system of the recovery below), segments of 25: built in "
        f"{t_build:.2f} s (the blocks' fingerprints and factors through "
        f"the store's block tier); worker 2 dies after {death} iterations: "
        f"re-lowered ({rep2.relowerings}), {ITERS - death} more in "
        f"{t_death:.2f} s, "
        f"x and history bit-equal to the one-shot solve on the same "
        f"schedule {bit}, the engine's programs {sizes} before and after "
        f"(captures 1); rejoin at the same size: repartitions "
        f"{rep3.repartitions}, fleet of {len(rep3.fleet)}; a join grows the "
        f"fleet {cm} -> {rt.sys.m}: repartitions {rep4.repartitions}, "
        f"reused_blocks {rep4.reused_blocks} prepared_blocks "
        f"{rep4.prepared_blocks}, 25 iterations (with the new partition, "
        f"its factors and engine) in {t_join:.2f} s, residual "
        f"{float(rep4.residuals[-1]):.3e}; captures by fleet size {caps} "
        f"[{card}]")
    del rt, rep1, rep2, rep3, rep4
    gc.collect()
    torch.cuda.empty_cache()

    # checkpoint() and recover() from a disk tier, on a cut system
    edir = ROOT / "build" / "phase18_elastic"
    shutil.rmtree(edir, ignore_errors=True)
    oracle = s.solve(csys, iters=2 * ITERS, **cprm)
    cplan = lambda: Plan(redundancy=2, store=solvers.FactorStore(  # noqa
        directory=str(edir / "store")))
    rt = solvers.ElasticRuntime(s, csys, plan=cplan(), segment=25,
                                checkpoint_dir=str(edir / "ckpt"), **cprm)
    rt.run(iters=ITERS)
    del rt
    t = time.time()
    rt = solvers.ElasticRuntime.recover(s, csys, str(edir / "ckpt"),
                                        plan=cplan(), segment=25, **cprm)
    t_rec = time.time() - t
    assert (rt.reused_blocks, rt.prepared_blocks) == (csys.m, 0)
    rep = rt.run(iters=ITERS)
    assert rep.iters == 2 * ITERS
    rx = float(torch.linalg.norm(rep.x - oracle.x) / torch.linalg.norm(
        oracle.x))
    assert torch.allclose(rep.x, oracle.x, rtol=1e-6, atol=1e-10), rx
    say(f"phase 18 elastic recover (a cut system, tall_gaussian {RED_CUT}: "
        f"the disk tier writes every block's A with its factors): "
        f"checkpoint after each segment, a fresh runtime recovered from "
        f"the disk tier and the checkpoint in {t_rec:.2f} s, "
        f"reused_blocks {csys.m} prepared_blocks 0; {rep.iters} iterations "
        f"in all; x vs the uninterrupted plain solve max rel {rx:.3e} "
        f"[{card}]")
    shutil.rmtree(edir, ignore_errors=True)

    # the redundant mesh path: one NCCL rank against local, its runner's
    # one step captured (eager under disable_capture), a history split
    # into segments against one run
    created = not dist.is_initialized()
    mesh = mesh_lib.solver_mesh(1, 1)
    s, prm = solvers.get("apc"), pinned["apc"][0]
    rplan = Plan(redundancy=2, alive_schedule=rot, factors=F)
    loc = s.solve(dsys, iters=ITERS, plan=rplan, **prm)
    mplan = rplan.replace(backend="mesh", mesh=mesh)
    r = s.solve(dsys, iters=ITERS, plan=mplan, **prm)
    dx, dh = mesh_check("redundant mesh", r.x, r.residuals, r.errors,
                        r.iters_to_tol, loc)
    del r, loc
    engines = {"mesh": redundant.RedundantEngine(
        s, dsys, r=2, backend="mesh", mesh=mesh, factors=F, **prm),
        "local": redundant.RedundantEngine(s, dsys, r=2, factors=F, **prm)}
    W = engines["mesh"].lower(redundant.resolve_schedule(rot, m, ITERS))
    st0 = {tag: eng.init_state() for tag, eng in engines.items()}
    mesh_eng = engines["mesh"]
    one = mesh_eng.run(st0["mesh"], W)
    cut = ITERS // 3
    a = mesh_eng.run(st0["mesh"], W[:cut])
    b = mesh_eng.run(a[0], W[cut:])
    with executor.disable_capture():
        eager = mesh_eng.run(st0["mesh"], W)
    split = torch.equal(b[0].x, one[0].x) and torch.equal(
        torch.cat([a[1], b[1]]), one[1]) and torch.equal(
        torch.cat([a[2], b[2]]), one[2])
    vs_eager = torch.equal(eager[0].x, one[0].x) and torch.equal(
        eager[1], one[1]) and torch.equal(eager[2], one[2])
    assert split and vs_eager, (split, vs_eager)
    assert (mesh_eng.captures, mesh_eng.cache_size()) == (1, 1)
    turns = {"mesh captured": [], "mesh eager": [], "local captured": []}
    for _ in range(2):
        for how in turns:
            tag = how.split()[0]
            with (executor.disable_capture() if how.endswith("eager")
                  else contextlib.nullcontext()):
                vs_local, t_ms = timed_ms(
                    lambda: engines[tag].run(st0[tag], W))
            turns[how].append(t_ms / ITERS)
    same_local = torch.equal(vs_local[0].x, one[0].x) and torch.equal(
        vs_local[1], one[1])
    med = {how: float(np.median(v)) for how, v in turns.items()}
    say(f"phase 18 redundant apc on the mesh, one rank over "
        f"{dist.get_backend()}: the solve vs local max|Δx| {dx:.3e} max|Δ "
        f"history| {dh:.3e}; the runner's one step captured "
        f"(captures {mesh_eng.captures}, programs {mesh_eng.cache_size()}): "
        f"≡ disable_capture() bit for bit {vs_eager}, a history split at "
        f"{cut} ≡ one run {split}, ≡ the local engine's {same_local}; ms "
        f"an iteration (a {ITERS}-step segment, median of 2 in turns) "
        + ", ".join(f"{how} {v:.4f}" for how, v in med.items())
        + f" [{card}]")
    # the runner's graph holds the communicator's collectives: it goes
    # before the group does
    del engines, mesh_eng, one, a, b, eager, vs_local, st0, W
    gc.collect()
    if created:
        dist.destroy_process_group()
    mem_peak = torch.cuda.max_memory_allocated()

    # two gloo ranks (2 x 1) on the one card, on the cut system
    gc.collect()
    torch.cuda.empty_cache()
    cfg = dict(cut=RED_CUT, iters=ITERS, world=2,
               device=dev.resolve("cuda").type,
               params={k: s_.resolve_params(csys) for k, s_ in (
                   ("apc", solvers.get("apc")),
                   ("cimmino", solvers.get("cimmino")))})
    t = time.time()
    g0, g1 = spawn_ranks("--red-rank", ROOT / "build" / "phase18", cfg,
                         SERVE_DEADLINE)
    caps = [int(g["captures"]) for g in (g0, g1)]
    assert caps == [0, 0], caps
    for name in ("apc", "cimmino"):
        plain = solvers.get(name).solve(csys, iters=ITERS,
                                        **cfg["params"][name])
        for key in (name, f"{name}/elastic"):
            if f"{key}/x" not in g0:
                continue
            assert np.array_equal(g0[f"{key}/x"], g1[f"{key}/x"]), key
            kdx, kdh = mesh_check(key, g0[f"{key}/x"], g0[f"{key}/res"],
                                  None, g0[f"{key}/itt"], plain)
            say(f"phase 18 two ranks over gloo on {cfg['device']}, mesh "
                f"(data, model) (2, 1), {key} redundancy=2 "
                + (f"(a death on rank 0's monitor after {ITERS // 3} "
                   f"iterations)"
                   if "elastic" in key else "(a rotating straggler)")
                + f": vs the local plain solve max|Δx| {kdx:.3e} max|Δ "
                f"history| {kdh:.3e}, x the same on both ranks; "
                f"{float(g0[f'{key}/ms']) / ITERS:.4f} ms an iteration "
                f"[{card}]")
    say(f"phase 18 two ranks: the system cut to tall_gaussian {RED_CUT} "
        f"(each rank makes it on its host and holds A and its replicated "
        f"shard; gloo takes every all_reduce through the host), captures "
        f"{caps}, {time.time() - t:.1f} s in all")
    say(f"phase 18 memory: resident {base / 1e9:.3f} GB before; peak "
        f"{red_peak / 1e9:.3f} GB in the redundant solves (A, the "
        f"replicated A and factors), {el_peak / 1e9:.3f} GB with the "
        f"elastic runtime's two partitions, {mem_peak / 1e9:.3f} GB in "
        f"all (max_memory_allocated) [{card}]")
    say(f"phase 18: {time.time() - t18:.1f} s")


def serve_arg(name: str) -> int:
    """The value of ``name`` in ``LM_SERVE_ARGS``."""
    return int(LM_SERVE_ARGS[LM_SERVE_ARGS.index(name) + 1])


def decode_vs_forward(cfg, params, toks, pre, extra=None):
    """The full forward of ``toks`` (B, S) (timed cold and warm), then a
    prefill of its first ``pre`` tokens and decode steps at ``pre`` and
    ``pre + 1``, each against the forward at its position at
    tests/test_models.py's tolerances; ``extra`` (Whisper's frames) goes
    into the forward's and the prefill's batch.  Returns (logits, ms
    cold, ms warm, the three max|Δ|, the three verdicts)."""
    from repro_torch.models import model
    B, S = toks.shape
    batch = dict(extra or {}, tokens=toks)
    with torch.inference_mode():
        full, ms_cold = timed_ms(lambda: model.forward(cfg, params, batch))
        _, ms_fwd = timed_ms(lambda: model.forward(cfg, params, batch))
        cache = model.init_cache(cfg, B, S, torch.float32, toks.device)
        ll, cache = model.prefill(cfg, params,
                                  dict(batch, tokens=toks[:, :pre]), cache)
        devs = [float((ll[:, 0] - full[:, pre - 1]).abs().max())]
        ok = [torch.allclose(ll[:, 0], full[:, pre - 1], rtol=1e-4,
                             atol=1e-4)]
        for pos in (pre, pre + 1):
            dl, cache = model.decode_step(cfg, params, toks[:, pos:pos + 1],
                                          cache, pos)
            devs.append(float((dl[:, 0] - full[:, pos]).abs().max()))
            ok.append(torch.allclose(dl[:, 0], full[:, pos], rtol=1e-4,
                                     atol=2e-4))
    assert full.shape == (B, S, cfg.padded_vocab)
    assert bool(torch.isfinite(full).all())
    return full, ms_cold, ms_fwd, devs, ok


def step_ms(cfg, params, gen):
    """CUDA-event medians of one prefill of ``LM_SERVE_ARGS``' batch of
    prompts (drawn from ``gen``) and of one decode step after it, into a
    fresh cache of the serving length.  Returns (ms by name, the cache,
    the decode step's token)."""
    from repro_torch.models import model
    nb, plen = serve_arg("--batch"), serve_arg("--prompt-len")
    prompts = torch.randint(0, cfg.vocab_size, (nb, plen), generator=gen,
                            device=gen.device)
    cache = model.init_cache(cfg, nb, plen + serve_arg("--max-new"),
                             device=gen.device)
    batch = {"tokens": prompts}
    if cfg.frontend == "audio":         # the CLI's zero frames
        batch["frames"] = torch.zeros(
            (nb, cfg.encoder_seq, cfg.d_model), dtype=model.cache_dtype(cfg),
            device=gen.device)
    tok = prompts[:, :1]
    with torch.inference_mode():
        ms = medians_ms({
            "prefill": lambda: model.prefill(cfg, params, batch, cache),
            "decode": lambda: model.decode_step(
                cfg, params, tok, cache, plen)}, reps=5, batch=1)
    return ms, (cache, tok)


def lm_phase(card) -> dict:
    """Phase 19: the LM framework's serving path for GQA decoders (A19a)
    and the APC probe head on the card.  Returns the probe's kernel
    launches by kernel (its kernel-path solve, counted from 0)."""
    from repro_torch import configs, device as dev
    from repro_torch import solvers
    from repro_torch.core import partition
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import model, sharding
    from repro_torch.optim import apc_head
    t19 = time.time()
    device = dev.resolve()
    say(f"phase 19 start: resident {torch.cuda.memory_allocated() / 1e9:.3f}"
        f" GB allocated, {torch.cuda.memory_reserved() / 1e9:.3f} GB "
        f"reserved; TF32 {torch.backends.cuda.matmul.allow_tf32}")
    assert not torch.backends.cuda.matmul.allow_tf32
    get = configs.get_smoke if LM_SMOKE else configs.get

    def gen(seed):
        return torch.Generator(device=device).manual_seed(seed)

    # (a) decode ≡ forward at full width and depth, float32 -------------
    cfg = dataclasses.replace(get(LM_ARCH), dtype="float32")
    t = time.time()
    params = sharding.init_tree(model.model_abstract(cfg), gen(0),
                                torch.float32, device)
    torch.cuda.synchronize()
    t_init = time.time() - t
    B, S = LM_BATCH
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen(1),
                         device=device)
    full, ms_cold, ms_fwd, devs, ok = decode_vs_forward(cfg, params, toks,
                                                        S - 2)
    n_params = model.count_params(cfg)
    say(f"phase 19 (a) {cfg.name} float32 ({cfg.n_layers} layers, d "
        f"{cfg.d_model}, vocab {cfg.vocab_size}, {n_params} parameters, "
        f"drawn in {t_init:.2f} s): forward ({B}, {S}) in {ms_cold:.1f} ms "
        f"cold, {ms_fwd:.1f} ms warm, "
        f"max|logit| {float(full.abs().max()):.4f}; prefill {S - 2} + 2 "
        f"decode steps vs forward max|Δ| {devs[0]:.3e} / {devs[1]:.3e} / "
        f"{devs[2]:.3e} (rtol 1e-4, atol 1e-4 / 2e-4: {all(ok)})")
    assert all(ok), devs

    # (b) card ≡ CPU on the same weights cut to LM_CUT_LAYERS layers -----
    cut = dataclasses.replace(cfg, n_layers=LM_CUT_LAYERS)
    cut_params = lm_cut_params(params, cut)
    on_cpu = sharding.tree_map(lambda w: w.cpu(), cut_params,
                               is_leaf=lambda x: False)
    with torch.inference_mode():
        card_logits = model.forward(cut, cut_params, {"tokens": toks})
        cpu_logits = model.forward(cut, on_cpu, {"tokens": toks.cpu()})
    e, d = rel_err(card_logits.cpu(), cpu_logits)
    say(f"phase 19 (b) {cut.name} cut to {LM_CUT_LAYERS} layers, float32: "
        f"the card's logits vs the CPU's max|Δ| {d:.3e}, "
        f"{e:.3e} of max|CPU| + 1 (limit {LM_CPU_TOL})")
    assert e <= LM_CPU_TOL, e
    del cut_params, on_cpu, card_logits, cpu_logits

    # (d) the APC probe on (a)'s features --------------------------------
    pb, ps, cols = PROBE["B"], PROBE["S"], PROBE["cols"]
    ptoks = torch.randint(0, cfg.vocab_size, (pb, ps), generator=gen(2),
                          device=device)
    with torch.inference_mode():
        H = model.forward(cfg, params, {"tokens": ptoks})[..., :cols]
    H = H.reshape(pb * ps, cols).double().cpu().numpy()
    H = (H - H.mean(0)) / (H.std(0) + 1e-9)      # standardized features
    rng = np.random.default_rng(2)
    y = H @ rng.standard_normal(cols) + 0.01 * rng.standard_normal(len(H))
    del params, full
    gc.collect()
    torch.cuda.empty_cache()
    lam, m, iters = PROBE["lam"], PROBE["m"], PROBE["iters"]
    (w, res), ms_fit = timed_ms(lambda: apc_head.fit_probe(
        H, y, m=m, lam=lam, iters=iters, device=device))
    Ht = torch.as_tensor(H, device=device)
    yt = torch.as_tensor(y, device=device)
    A, b = apc_head.normal_system(Ht, yt, lam)
    w_ref = np.linalg.solve(A.cpu().numpy(), b.cpu().numpy())
    err = float(np.linalg.norm(w.cpu().numpy() - w_ref)
                / np.linalg.norm(w_ref))
    assert err < 1e-3, err
    sys_ = partition.partition(A, b, m)
    apc = solvers.get("apc")
    plain = apc.solve(sys_, iters=iters)
    ops.reset_launch_counts()
    fused, ms_kernel = timed_ms(lambda: apc.solve(
        sys_, iters=iters, plan=solvers.ExecutionPlan(kernel=True)))
    launches = ops.launch_counts()
    hp, hk = plain.residuals.cpu().numpy(), fused.residuals.cpu().numpy()
    h_ok = np.allclose(hk, hp, rtol=PROBE_HIST_REL, atol=1e-12)
    dx = float((fused.x - plain.x).abs().max())
    say(f"phase 19 (d) probe (examples/probe_apc.py) on {cfg.name}'s "
        f"features, {pb * ps} tokens x {cols} standardized logit columns, "
        f"m={m}, lam={lam}, {iters} iterations: fit_probe vs the float64 "
        f"closed form {err:.3e} (limit 1e-3) in {ms_fit:.1f} ms, history "
        f"{float(res[0]):.2e} -> {float(res[-1]):.2e}, MSE "
        f"{apc_head.probe_loss(Ht, yt, w):.4e}; the normal system with "
        f"ExecutionPlan(kernel=True): history within rtol "
        f"{PROBE_HIST_REL} / atol 1e-12 of the unfused one {h_ok} (max|Δ| "
        f"{float(np.abs(hk - hp).max()):.3e}), max|Δx| {dx:.3e}, "
        f"{ms_kernel:.1f} ms, launches "
        f"{ {kn: launches[kn] for kn in USES['apc']} }")
    assert h_ok
    assert all(launches[kn] == iters for kn in USES["apc"]), launches
    assert all(launches[kn] == 0 for kn in launches
               if kn not in USES["apc"]), launches
    del sys_, plain, fused, A, b, Ht, yt
    gc.collect()
    torch.cuda.empty_cache()

    # (c) the serving CLI in bfloat16 at full width ----------------------
    for arch in LM_SERVE:
        argv = ["--arch", arch, *(["--smoke"] if LM_SMOKE else []),
                *LM_SERVE_ARGS]
        torch.cuda.reset_peak_memory_stats()
        reps = [serve.run(argv) for _ in range(2)]
        same = all(np.array_equal(a, b) for a, b in zip(reps[0].tokens,
                                                        reps[1].tokens))
        peak = torch.cuda.max_memory_allocated() / 1e9
        scfg = get(arch)
        before = torch.cuda.memory_allocated()
        sparams = sharding.init_tree(model.model_abstract(scfg), gen(0),
                                     model.cache_dtype(scfg), device)
        resident = torch.cuda.memory_allocated() / 1e9
        weights = (torch.cuda.memory_allocated() - before) / 1e9
        nb, plen = serve_arg("--batch"), serve_arg("--prompt-len")
        ms, _ = step_ms(scfg, sparams, gen(3))
        say(f"phase 19 (c) serve {arch} ({scfg.dtype}, {scfg.n_layers} "
            f"layers, d {scfg.d_model}, vocab {scfg.vocab_size} -> "
            f"{scfg.padded_vocab}, qk_norm {scfg.qk_norm}) "
            f"{' '.join(LM_SERVE_ARGS)}: {reps[0].served} requests, "
            f"{reps[0].tok_per_s:.1f} / {reps[1].tok_per_s:.1f} tok/s in two "
            f"runs ({reps[0].seconds:.2f} / {reps[1].seconds:.2f} s); "
            f"greedy tokens equal across the runs {same}; one prefill "
            f"({nb} x {plen}) {ms['prefill']:.2f} ms, one decode step "
            f"{ms['decode']:.2f} ms (CUDA events, a call each, the host's "
            f"launches included); parameters {weights:.3f} GB, resident "
            f"{resident:.3f} GB with them, peak {peak:.3f} GB while "
            f"serving")
        assert same, arch
        del sparams, reps
        gc.collect()
        torch.cuda.empty_cache()
    say(f"phase 19: {time.time() - t19:.1f} s")
    say(card)
    return {kn: launches[kn] for kn in launches}


def lm_cut(cfg, layers):
    """``cfg`` cut to its first ``layers`` layers (None, or at least its
    depth: ``cfg`` itself)."""
    if layers is None or layers >= cfg.n_layers:
        return cfg
    return dataclasses.replace(cfg, n_layers=layers)


def lm_cut_params(params, cfg):
    """The leading layers of ``params`` that ``cfg`` (a depth cut) has:
    its prefix, then each stacked slot's first periods (views)."""
    from repro_torch.models import sharding
    nd = cfg.moe.first_dense if cfg.moe else 0
    periods = (cfg.n_layers - nd) // len(cfg.pattern)
    dec = params["decoder"]
    return dict(params, decoder=dict(dec, prefix=dec["prefix"][:nd], slots=[
        sharding.tree_map(lambda w: w[:periods], slot,
                          is_leaf=lambda x: False) for slot in dec["slots"]]))


@contextlib.contextmanager
def recorded_routes():
    """The MoE router's (probs, gates, eids) of every call inside, in
    order (``moe.route`` wrapped for the block's duration)."""
    from repro_torch.models import moe
    seen, route = [], moe.route

    def record(cfg, router, xf):
        out = route(cfg, router, xf)
        seen.append(out)
        return out
    moe.route = record
    try:
        yield seen
    finally:
        moe.route = route


def lm_nbytes(tree) -> int:
    from repro_torch.models import sharding
    return sum(t.numel() * t.element_size() for t in sharding.tree_leaves(
        tree, is_leaf=lambda x: False))


def lm_decode_bound_ms(cfg, params, cache, bw, routes=()) -> tuple:
    """The bytes bounds of one decode step, (every expert, routed experts):
    every weight it reads once (the embedding table only where it is the
    tied LM head: an untied one is read a row a token; an encoder's
    weights and the decoder's cross projections wk, wv and k_norm, which
    only prefill reads, not at all) and the cache once (Whisper's cross
    cache included), over the card's rate.  The first counts every expert
    of a MoE layer, as the grouped product reads them all; the second only
    the experts that ``routes`` (the step's ``recorded_routes``, one a MoE
    layer) send a token to."""
    dec = params["decoder"]
    w = lm_nbytes(params) - lm_nbytes(params.get("encoder")) - sum(
        lm_nbytes({k: sp["xattn"].get(k) for k in ("wk", "wv", "k_norm")})
        for sp in (*dec["prefix"], *dec["slots"]) if "xattn" in sp)
    if not cfg.tie_embeddings:
        w -= lm_nbytes(params["embed"])
    every = (w + lm_nbytes(cache)) / bw * 1e3
    moes = [sp["mlp"] for sp in dec["slots"]
            if "router" in (sp.get("mlp") or {})]
    if not moes:
        return every, every
    names = ("w_gate", "w_up", "w_down")
    assert len(routes) == sum(len(m["router"]) for m in moes), len(routes)
    per_expert = lm_nbytes({k: moes[0][k][0, 0] for k in names})
    unread = sum(lm_nbytes({k: m[k] for k in names}) for m in moes) \
        - sum(len(eids.unique()) for _, _, eids in routes) * per_expert
    return every, every - unread / bw * 1e3


def device_time(run):
    """(kernel ms summed from ``torch.profiler``'s key_averages, wall ms,
    the three kernels with the most device time as (name, ms, launches))
    over one ``run()``, the profiler on."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    busy = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:3]
    return busy, wall, [(e.key, e.self_device_time_total / 1e3, e.count)
                        for e in top]


def lm_families_phase(card, bw) -> None:
    """Phase 20: the LM serving path of the MoE, SSM, hybrid and MLA
    decoders (A19b parts 1-3).  No kernel backs it (the reference computes
    MoE, SSD and MLA in XLA ops, no Pallas kernel)."""
    from repro_torch import configs, device as dev
    from repro_torch.launch import serve
    from repro_torch.models import model, sharding
    t20 = time.time()
    device = dev.resolve()
    say(f"phase 20 start: resident {torch.cuda.memory_allocated() / 1e9:.3f}"
        f" GB allocated, {torch.cuda.memory_reserved() / 1e9:.3f} GB "
        f"reserved")
    get = configs.get_smoke if LM_SMOKE else configs.get

    def gen(seed):
        return torch.Generator(device=device).manual_seed(seed)

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    # (a) decode ≡ forward in float32; (b) card ≡ CPU, routes included ----
    for arch, depth in LM20_DEPTH.items():
        cfg = lm_cut(dataclasses.replace(get(arch), dtype="float32"), depth)
        published = cfg
        if cfg.moe is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=LM20_NO_DROPS))
        torch.cuda.reset_peak_memory_stats()
        t = time.time()
        params = sharding.init_tree(model.model_abstract(cfg), gen(0),
                                    torch.float32, device)
        torch.cuda.synchronize()
        t_init = time.time() - t
        if cfg.family == "ssm":
            (B, S), pre = (2, 2 * cfg.ssm.chunk), cfg.ssm.chunk
        else:
            (B, S), pre = LM_BATCH, LM_BATCH[1] - 2
        toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen(1),
                             device=device)
        full, ms_cold, ms_fwd, devs, ok = decode_vs_forward(cfg, params,
                                                            toks, pre)
        mo = cfg.moe
        experts = (f"{mo.num_experts} experts top-{mo.top_k}, {mo.n_shared} "
                   f"shared, capacity factor {mo.capacity_factor}, "
                   if mo else "")
        say(f"phase 20 (a) {cfg.name} float32 ({cfg.family}, {cfg.n_layers} "
            f"layers, pattern {'/'.join(cfg.pattern)}, attention "
            f"{cfg.attn_type}, d {cfg.d_model}, vocab {cfg.vocab_size}, "
            f"{experts}{model.count_params(cfg)} parameters, "
            f"{lm_nbytes(params) / 1e9:.3f} GB, drawn in {t_init:.2f} s): "
            f"forward ({B}, {S}) in {ms_cold:.1f} ms cold, {ms_fwd:.1f} ms "
            f"warm, max|logit| {float(full.abs().max()):.4f}; prefill {pre} "
            f"+ 2 decode steps vs forward at {pre - 1}, {pre}, {pre + 1} "
            f"max|Δ| {devs[0]:.3e} / {devs[1]:.3e} / {devs[2]:.3e} (rtol "
            f"1e-4, atol 1e-4 / 2e-4: {all(ok)}); peak "
            f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
        assert all(ok), (arch, devs)
        del full
        if arch in LM20_CPU:
            cut = lm_cut(published, LM20_CPU[arch])
            cut_params = lm_cut_params(params, cut)
            on_cpu = sharding.tree_map(lambda w: w.cpu(), cut_params,
                                       is_leaf=lambda x: False)
            with torch.inference_mode():
                with recorded_routes() as card_routes:
                    card_logits = model.forward(cut, cut_params,
                                                {"tokens": toks})
                t = time.time()
                with recorded_routes() as cpu_routes:
                    cpu_logits = model.forward(cut, on_cpu,
                                               {"tokens": toks.cpu()})
                t_cpu = time.time() - t
            e, d = rel_err(card_logits.cpu(), cpu_logits)
            differ, gap = 0, math.inf
            assert len(card_routes) == len(cpu_routes)
            for (_, _, ec), (pc, _, ep) in zip(card_routes, cpu_routes):
                differ += int((ec.cpu() != ep).any(-1).sum())
                top = torch.sort(pc, dim=-1, descending=True).values
                K = cut.moe.top_k
                gap = min(gap, float((top[:, K - 1] - top[:, K]).min()))
            routes = (f"; top-{cut.moe.top_k} routes of {len(cpu_routes)} "
                      f"MoE layers x {B * S} tokens (capacity factor "
                      f"{cut.moe.capacity_factor}): {differ} differ, the "
                      f"smallest gap between the k-th and (k+1)-th router "
                      f"probability {gap:.3e}" if cut.moe else "")
            say(f"phase 20 (b) {cut.name} at {cut.n_layers} layers, float32, "
                f"({B}, {S}) tokens: the card's logits vs the CPU's max|Δ| "
                f"{d:.3e}, {e:.3e} of max|CPU| + 1 (limit {LM_CPU_TOL}; the "
                f"CPU's forward {t_cpu:.1f} s){routes}")
            assert e <= LM_CPU_TOL, (arch, e)
            assert differ == 0, (arch, differ, gap)
            del cut_params, on_cpu, card_logits, cpu_logits, card_routes, \
                cpu_routes
        del params, toks
        free()

    # (c) bfloat16 serving --------------------------------------------------
    nb, plen = serve_arg("--batch"), serve_arg("--prompt-len")
    for arch in (*LM20_CLI, *LM20_CUT):
        scfg = lm_cut(get(arch), LM20_CUT.get(arch))
        torch.cuda.reset_peak_memory_stats()
        reps, sparams = [], None
        if arch in LM20_CLI:
            how = "the CLI (launch/serve.py)"
            argv = ["--arch", arch, *(["--smoke"] if LM_SMOKE else []),
                    *LM_SERVE_ARGS]
            for _ in range(2):
                reps.append(serve.run(argv))
                free()
        else:
            how = f"serve.serve on the cut to {scfg.n_layers} layers"
            sparams = sharding.init_tree(model.model_abstract(scfg), gen(0),
                                         model.cache_dtype(scfg), device)
            for _ in range(2):
                reps.append(serve.serve(
                    scfg, sparams, requests=serve_arg("--requests"),
                    batch=nb, prompt_len=plen,
                    max_new=serve_arg("--max-new"), device=device))
        same = all(np.array_equal(a, b) for a, b in zip(reps[0].tokens,
                                                        reps[1].tokens))
        peak = torch.cuda.max_memory_allocated() / 1e9
        if sparams is None:
            sparams = sharding.init_tree(model.model_abstract(scfg), gen(0),
                                         model.cache_dtype(scfg), device)
        ms, (cache, tok) = step_ms(scfg, sparams, gen(3))
        with torch.inference_mode(), recorded_routes() as routes:
            busy, wall, top = device_time(lambda: model.decode_step(
                scfg, sparams, tok, cache, plen))
        bound, routed = lm_decode_bound_ms(scfg, sparams, cache, bw, routes)
        # only the faked card of the CPU rehearsal shows no device time
        assert busy > 0 or LM_SMOKE, (arch, "no device time in the profile")
        profiled = (
            f"kernels {busy:.2f} ms of {wall:.2f} ms wall, the device idle "
            f"{1 - busy / wall:.1%}; most device time: " + ", ".join(
                f"{name[:48]} {ms:.2f} ms ({n})" for name, ms, n in top)
            if busy > 0 else "the profiler shows no device time: the "
            "device's idle share not measured")
        n_routed = sum(len(eids.unique()) for _, _, eids in routes)
        experts = (f"; {routed:.3f} ms with only the {n_routed} routed "
                   f"experts of its {len(routes)} MoE layers read"
                   if routes else "")
        say(f"phase 20 (c) serve {arch} ({scfg.dtype}, {scfg.family}, "
            f"{scfg.n_layers} layers, d {scfg.d_model}, vocab "
            f"{scfg.vocab_size}) through {how}, "
            f"{' '.join(LM_SERVE_ARGS)}: {reps[0].served} requests, "
            f"{reps[0].tok_per_s:.1f} / {reps[1].tok_per_s:.1f} tok/s in two "
            f"runs ({reps[0].seconds:.2f} / {reps[1].seconds:.2f} s); "
            f"greedy tokens equal across the runs {same}; one prefill "
            f"({nb} x {plen}) {ms['prefill']:.2f} ms, one decode step "
            f"{ms['decode']:.2f} ms (CUDA events, a call each, the host's "
            f"launches included; its bytes bound {bound:.3f} ms: the "
            f"weights it reads, every expert, and the cache{experts}); one "
            f"decode step profiled: {profiled}; parameters "
            f"{lm_nbytes(sparams) / 1e9:.3f} GB, peak {peak:.3f} GB while "
            f"serving")
        assert same, arch
        del sparams, cache, tok, reps
        free()
    say(f"phase 20: {time.time() - t20:.1f} s")
    say(card)


def phase_memory() -> str:
    """The card's resident and peak GB (max_memory_allocated since the
    last reset)."""
    return (f"resident {torch.cuda.memory_allocated() / 1e9:.3f} GB, peak "
            f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")


def whisper_phase(card, bw) -> None:
    """Phase 21: Whisper's encoder-decoder serving (A19b part 4) at its
    published width and depth.  No kernel backs it (the reference runs
    the encoder and the cross-attention in XLA ops)."""
    from repro_torch import configs, device as dev
    from repro_torch.launch import serve
    from repro_torch.models import model, sharding
    t21 = time.time()
    device = dev.resolve()
    torch.cuda.reset_peak_memory_stats()
    say(f"phase 21 start: {phase_memory()}")
    get = configs.get_smoke if LM_SMOKE else configs.get

    def gen(seed):
        return torch.Generator(device=device).manual_seed(seed)

    # (a) decode ≡ forward in float32; (b) the card against the CPU ------
    cfg = dataclasses.replace(get(LM21_ARCH), dtype="float32")
    params = sharding.init_tree(model.model_abstract(cfg), gen(0),
                                torch.float32, device)
    B, S = LM_BATCH
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen(1),
                         device=device)
    frames = LM21_FRAMES * torch.randn((B, cfg.encoder_seq, cfg.d_model),
                                       generator=gen(2), device=device)
    full, ms_cold, ms_fwd, devs, ok = decode_vs_forward(
        cfg, params, toks, S - 2, {"frames": frames})
    say(f"phase 21 (a) {cfg.name} float32 ({cfg.encoder_layers} encoder + "
        f"{cfg.n_layers} decoder layers, d {cfg.d_model}, {cfg.n_heads} "
        f"heads, {cfg.encoder_seq} frames of {LM21_FRAMES}·N(0, 1), vocab "
        f"{cfg.vocab_size}, {model.count_params(cfg)} parameters): forward "
        f"({B}, {S}) in {ms_cold:.1f} ms cold, {ms_fwd:.1f} ms warm, "
        f"max|logit| {float(full.abs().max()):.4f}; prefill {S - 2} + 2 "
        f"decode steps vs forward max|Δ| {devs[0]:.3e} / {devs[1]:.3e} / "
        f"{devs[2]:.3e} (rtol 1e-4, atol 1e-4 / 2e-4: {all(ok)})")
    assert all(ok), devs
    on_cpu = sharding.tree_map(lambda w: w.cpu(), params,
                               is_leaf=lambda x: False)
    errs, t = {}, time.time()
    with torch.inference_mode():
        for where, p, tk, fr in (("card", params, toks, frames),
                                 ("cpu", on_cpu, toks.cpu(), frames.cpu())):
            cache = model.init_cache(cfg, B, S, torch.float32, tk.device)
            logits = model.forward(cfg, p, {"tokens": tk, "frames": fr})
            _, cache = model.prefill(cfg, p, {"tokens": tk[:, :S - 2],
                                              "frames": fr}, cache)
            errs[where] = [logits] + sharding.tree_leaves(
                cache["cross"], is_leaf=lambda x: False)
    t_cpu = time.time() - t
    worst = [rel_err(a.cpu(), b) for a, b in zip(errs["card"], errs["cpu"])]
    e_cross = max(e for e, _ in worst[1:])
    say(f"phase 21 (b) {cfg.name} float32, ({B}, {S}) tokens: the card's "
        f"logits vs the CPU's max|Δ| {worst[0][1]:.3e}, {worst[0][0]:.3e} "
        f"of max|CPU| + 1; the {len(worst) - 1} cross-cache leaves after "
        f"prefill at most {e_cross:.3e} (limit {LM_CPU_TOL}; the card and "
        f"the CPU together {t_cpu:.1f} s)")
    assert max(e for e, _ in worst) <= LM_CPU_TOL, worst
    del params, on_cpu, full, errs, frames, toks
    gc.collect()
    torch.cuda.empty_cache()

    # (c) bfloat16 serving through the CLI ---------------------------------
    scfg = get(LM21_ARCH)
    argv = ["--arch", LM21_ARCH, *(["--smoke"] if LM_SMOKE else []),
            *LM_SERVE_ARGS]
    torch.cuda.reset_peak_memory_stats()
    reps = [serve.run(argv) for _ in range(2)]
    same = all(np.array_equal(a, b) for a, b in zip(reps[0].tokens,
                                                    reps[1].tokens))
    peak = torch.cuda.max_memory_allocated() / 1e9
    sparams = sharding.init_tree(model.model_abstract(scfg), gen(0),
                                 model.cache_dtype(scfg), device)
    ms, (cache, tok) = step_ms(scfg, sparams, gen(3))
    plen = serve_arg("--prompt-len")
    with torch.inference_mode():
        busy, wall, top = device_time(lambda: model.decode_step(
            scfg, sparams, tok, cache, plen))
    bound, _ = lm_decode_bound_ms(scfg, sparams, cache, bw)
    assert busy > 0 or LM_SMOKE, "no device time in the profile"
    profiled = (
        f"kernels {busy:.2f} ms of {wall:.2f} ms wall, the device idle "
        f"{1 - busy / wall:.1%}" if busy > 0 else "the profiler shows no "
        "device time: the device's idle share not measured")
    say(f"phase 21 (c) serve {LM21_ARCH} ({scfg.dtype}, "
        f"{scfg.encoder_layers} + {scfg.n_layers} layers, d {scfg.d_model}, "
        f"vocab {scfg.vocab_size}, zero frames) through the CLI "
        f"(launch/serve.py), {' '.join(LM_SERVE_ARGS)}: {reps[0].served} "
        f"requests, {reps[0].tok_per_s:.1f} / {reps[1].tok_per_s:.1f} tok/s "
        f"in two runs ({reps[0].seconds:.2f} / {reps[1].seconds:.2f} s); "
        f"greedy tokens equal across the runs {same}; one prefill "
        f"({serve_arg('--batch')} x {plen}, the encoder included) "
        f"{ms['prefill']:.2f} ms, one decode step {ms['decode']:.2f} ms "
        f"(CUDA events, a call each; its bytes bound {bound:.4f} ms: the "
        f"decoder's weights but the cross projections, the self cache and "
        f"the cross cache, "
        f"{lm_nbytes(cache['cross']) / 1e6:.1f} MB of it); one decode step "
        f"profiled: {profiled}; parameters {lm_nbytes(sparams) / 1e9:.3f} "
        f"GB, peak {peak:.3f} GB while serving")
    assert same
    del sparams, cache, tok, reps
    gc.collect()
    torch.cuda.empty_cache()
    say(f"phase 21: {time.time() - t21:.1f} s, {phase_memory()}")
    say(card)


def tree_paths(tree, prefix="") -> list:
    """The dotted key paths of ``tree``'s leaves in ``tree_leaves``
    order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in tree_paths(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [p for i, t in enumerate(tree)
                for p in tree_paths(t, f"{prefix}{i}.")]
    return [] if tree is None else [prefix[:-1]]


def train_cpu_step(cfg, device):
    """Phase 22 (a) for one smoke config in float32: the same parameters
    (seed 0) and batch (the synthetic stream's step 0, Whisper's frames
    and pixtral's patches drawn) on the card and the CPU; two card runs
    under ``torch.use_deterministic_algorithms(True, warn_only=True)``.
    Returns the line's text, or raises."""
    import warnings
    from repro_torch.data import synthetic
    from repro_torch.launch import train
    from repro_torch.models import sharding
    from repro_torch.optim import adamw
    leaf = lambda x: False  # noqa: E731
    params = train.init_params(cfg, device)
    B, S = TRAIN_BATCH
    gen = torch.Generator(device=device).manual_seed(1)
    batch = train.full_batch(cfg, synthetic.make_batch(
        synthetic.DataConfig(cfg.vocab_size, S, B), 0, device=device))
    for key, scale in (("patches", 0.02), ("frames", LM21_FRAMES)):
        if key in batch:
            batch[key] = scale * torch.randn(batch[key].shape,
                                             generator=gen, device=device)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            runs = [train.loss_and_grads(cfg, params, batch)
                    for _ in range(2)]
        finally:
            torch.use_deterministic_algorithms(False)
    refused = sorted({str(w.message).split("\n")[0][:90] for w in caught
                      if "deterministic" in str(w.message)})
    (loss, grads), (loss2, grads2) = runs
    g_l = sharding.tree_leaves(grads, leaf)
    rerun = max([float((loss - loss2).abs())] + [
        float((a - b).abs().max()) for a, b in zip(
            g_l, sharding.tree_leaves(grads2, leaf))])
    bitwise = rerun == 0.0
    cpu_p = sharding.tree_map(lambda t: t.detach().cpu().requires_grad_(),
                              params, leaf)
    cpu_b = {k: v.cpu() for k, v in batch.items()}
    c_loss, c_grads = train.loss_and_grads(cfg, cpu_p, cpu_b)
    e_loss = abs(float(loss) - float(c_loss))
    worst, where = 0.0, ""
    for name, a, b in zip(tree_paths(grads), g_l,
                          sharding.tree_leaves(c_grads, leaf)):
        r = float((a.cpu() - b).abs().max()) / max(float(b.abs().max()),
                                                  1e-30)
        if r >= worst:
            worst, where = r, name
    acfg = adamw.AdamWConfig(lr=1e-3)
    new_card, _ = adamw.update(acfg, sharding.tree_map(
        lambda g: g.to(device), c_grads, leaf), adamw.init(params), params)
    new_cpu, _ = adamw.update(acfg, c_grads, adamw.init(cpu_p), cpu_p)
    e_upd = max(float((a.detach().cpu() - b.detach()).abs().max())
                for a, b in zip(sharding.tree_leaves(new_card, leaf),
                                sharding.tree_leaves(new_cpu, leaf)))
    text = (f"{cfg.name} ({cfg.family}, {len(g_l)} leaves): loss "
            f"{float(loss):.6f}, vs the CPU's {e_loss:.3e} (limit "
            f"{LM_CPU_TOL} x (|loss| + 1)); worst gradient leaf {where} at "
            f"{worst:.3e} of its max|g_CPU| (limit {TRAIN_GRAD}); AdamW on "
            f"the CPU's gradients max|Δ| {e_upd:.3e} (limit {TRAIN_UPDATE}); "
            f"two card runs under deterministic algorithms "
            + ("bit-equal" if bitwise else f"differ by max|Δ| {rerun:.3e}")
            + ("; ops without a deterministic implementation: "
               + " | ".join(refused) if refused else ""))
    assert e_loss <= LM_CPU_TOL * (abs(float(c_loss)) + 1.0), text
    assert worst <= TRAIN_GRAD, text
    assert e_upd <= TRAIN_UPDATE, text
    assert bitwise or refused, text
    return text


def flash_memory(fn, q, k, v, do):
    """(dq, dk, dv, GB kept from the forward to the backward, peak GB
    above the inputs, ms) of ``fn(q, k, v)`` and its backward."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t = time.perf_counter()
    out = fn(q, k, v)
    kept = (torch.cuda.memory_allocated() - base) / 1e9
    grads = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    return grads, kept, peak, ms


def profiled_train_step(cfg, device, nb, seq):
    """(busy ms, wall ms, top kernels) of one train step of ``cfg`` (seed
    0 parameters, the synthetic stream's step 0 at (nb, seq)) after one
    unprofiled step, ``torch.profiler`` on (``device_time``)."""
    from repro_torch.data import synthetic
    from repro_torch.launch import train
    from repro_torch.optim import adamw
    acfg = adamw.AdamWConfig(lr=1e-3)
    state = [train.init_params(cfg, device)]
    state.append(adamw.init(state[0]))
    batch = train.full_batch(cfg, synthetic.make_batch(
        synthetic.DataConfig(cfg.vocab_size, seq, nb), 0, device=device))

    def step():
        state[0], state[1], _, _ = train.train_step(cfg, acfg, *state,
                                                    batch, 1.0)
    step()
    return device_time(step)


def train_phase(card, peaks) -> None:
    """Phase 22: the LM training path (A19c).  No kernel backs it (the
    reference computes attention, its custom backward, the loss and AdamW
    in XLA ops)."""
    from repro_torch import configs, device as dev
    from repro_torch.launch import train
    from repro_torch.models import layers, model
    t22 = time.time()
    device = dev.resolve()
    torch.cuda.reset_peak_memory_stats()
    say(f"phase 22 start: {phase_memory()}")

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    # (a) one float32 step of every smoke config, card against CPU ---------
    for arch in configs.ARCHS:
        cfg = dataclasses.replace(configs.get_smoke(arch), dtype="float32")
        say(f"phase 22 (a) {train_cpu_step(cfg, device)}")
        free()

    # (b) the flash backward at length ---------------------------------------
    B, S, H, K, d = (FLASH_LEN[x] for x in ("B", "S", "H", "K", "d"))
    gen = torch.Generator(device=device).manual_seed(5)
    q, k, v, do = (torch.randn(shape, generator=gen, device=device).to(
        torch.bfloat16) for shape in (
        (B, S, H, d), (B, S, K, d), (B, S, K, d), (B, S, H, d)))
    for x in (q, k, v):
        x.requires_grad_()
    plain_tiles = B * H * S * S * 4 / 1e9
    for blk in (FLASH_BLK, layers.pick_blk(S)):
        fn, kept_f, peak_f, ms_f = flash_memory(
            lambda a, b, c: layers.flash_attention(a, b, c, 0, True, blk),
            q, k, v, do)
        pl, kept_p, peak_p, ms_p = flash_memory(
            lambda a, b, c: layers._flash_fwd(a, b, c, 0, True, blk)[0],
            q, k, v, do)
        errs = [rel_err(a.float(), b.float()) for a, b in zip(fn, pl)]
        say(f"phase 22 (b) flash backward, tinyllama-1.1b's heads ({H} "
            f"query, {K} KV, hd {d}), B {B}, S {S}, causal, bf16, blk {blk}"
            f"{' (pick_blk)' if blk == layers.pick_blk(S) else ''}: dq / dk "
            f"/ dv vs plain autograd through the same loop max|Δ| "
            + " / ".join(f"{dd:.3e}" for _, dd in errs)
            + f", at most {max(e for e, _ in errs):.3e} of max + 1 (limit "
            f"{BF16_TOL}); kept from forward to backward {kept_f:.3f} GB vs "
            f"{kept_p:.3f} GB (B·H·S²·4 = {plain_tiles:.2f} GB of float32 "
            f"tiles); peak above the inputs {peak_f:.3f} GB vs {peak_p:.3f} "
            f"GB ({peak_f / max(peak_p, 1e-12):.3f} of it, limit "
            f"{FLASH_PEAK_RATIO}; {layers._row_chunk(B, H, S, blk)} query "
            f"rows a chunk); forward + backward {ms_f:.1f} ms vs "
            f"{ms_p:.1f} ms (host clock, cold)")
        assert max(e for e, _ in errs) <= BF16_TOL, errs
        assert kept_f <= FLASH_PEAK_RATIO * kept_p or LM_SMOKE, \
            (kept_f, kept_p)
        assert peak_f <= FLASH_PEAK_RATIO * peak_p or LM_SMOKE, \
            (peak_f, peak_p)
        del fn, pl
        free()
    del q, k, v, do
    free()

    # (c) the train CLI at full width, then the loop on three more ---------
    get = configs.get_smoke if LM_SMOKE else configs.get
    ckpt_dir = ROOT / "build" / "phase22_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    steps = int(TRAIN_CLI_ARGS[TRAIN_CLI_ARGS.index("--steps") + 1])
    nb = int(TRAIN_CLI_ARGS[TRAIN_CLI_ARGS.index("--batch") + 1])
    seq = int(TRAIN_CLI_ARGS[TRAIN_CLI_ARGS.index("--seq") + 1])
    argv = ["--arch", TRAIN_ARCH, *(["--smoke"] if LM_SMOKE else []),
            *TRAIN_CLI_ARGS, "--ckpt-dir", str(ckpt_dir)]

    def figures(cfg, rep, wall, profiled=True) -> str:
        n = len(rep.losses)
        steady = (rep.seconds - rep.first_step_seconds - rep.ckpt_seconds) \
            / max(n - 1, 1)
        flops = 6 * model.non_embedding_params(cfg, active_only=True) \
            * nb * seq
        bound = flops / peaks[torch.bfloat16] * 1e3
        peak = torch.cuda.max_memory_allocated() / 1e9
        prof = ""
        if profiled:
            free()
            busy, pwall, top = profiled_train_step(cfg, device, nb, seq)
            assert busy > 0 or LM_SMOKE, (cfg.name, "no device time")
            prof = ("; one step profiled: " + (
                f"kernels {busy:.1f} ms of {pwall:.1f} ms wall, the device "
                f"idle {1 - busy / pwall:.1%}; most device time: "
                + ", ".join(f"{name[:48]} {ms:.1f} ms ({c})"
                            for name, ms, c in top)
                if busy > 0 else "the profiler shows no device time: the "
                "device's idle share not measured"))
        return (f"loss {rep.losses[0]:.4f} -> {rep.losses[-1]:.4f} over "
                f"steps {rep.start_step}-{rep.start_step + n - 1}; the run "
                f"{wall:.1f} s in all (drawing the parameters, a restore "
                f"where there is a checkpoint, the loop with "
                f"{rep.ckpt_seconds:.1f} s of checkpoint writes); the first "
                f"step "
                f"{rep.first_step_seconds * 1e3:.0f} ms, then "
                f"{steady * 1e3:.1f} ms a step ({nb * seq / steady:.0f} "
                f"tokens/s; host clock, the loop's end synchronized, the "
                f"checkpoints' seconds taken out); its "
                f"FLOP bound 6·N·tokens = {flops / 1e12:.2f} TFLOP (N "
                f"{model.non_embedding_params(cfg, active_only=True)} "
                f"non-embedding, active) at "
                f"{peaks[torch.bfloat16] / 1e12:.0f} TFLOP/s (the dense "
                f"bf16 peak of NVIDIA's data sheet for this card) "
                f"{bound:.2f} ms, {bound / (steady * 1e3):.1%} of the step; "
                f"peak {peak:.3f} GB{prof}")

    cfg = get(TRAIN_ARCH)
    torch.cuda.reset_peak_memory_stats()
    t = time.time()
    rep, _ = captured_stdout(lambda: train.run(argv), "phase 22 (c) cli",
                             card)
    wall = time.time() - t
    say(f"phase 22 (c) train {TRAIN_ARCH} ({cfg.dtype}, {cfg.n_layers} "
        f"layers, d {cfg.d_model}) through the CLI, "
        f"{' '.join(TRAIN_CLI_ARGS)}: {figures(cfg, rep, wall)}")
    assert all(math.isfinite(x) for x in rep.losses), rep.losses
    assert rep.start_step == 0 and len(rep.losses) == steps
    assert rep.losses[steps - 1] < rep.losses[0], rep.losses
    free()
    torch.cuda.reset_peak_memory_stats()
    argv[argv.index("--steps") + 1] = str(TRAIN_RESUME_STEPS)
    t = time.time()
    rep, text = captured_stdout(lambda: train.run(argv),
                                "phase 22 (c) cli resumed", card)
    wall = time.time() - t
    say(f"phase 22 (c) train {TRAIN_ARCH} resumed with --steps "
        f"{TRAIN_RESUME_STEPS}: {figures(cfg, rep, wall, profiled=False)}")
    assert f"resumed from step {steps}" in text, text
    assert rep.start_step == steps and all(
        math.isfinite(x) for x in rep.losses), rep
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    free()
    for arch, (depth, n) in TRAIN_MORE.items():
        mcfg = lm_cut(get(arch), depth)
        torch.cuda.reset_peak_memory_stats()
        t = time.time()
        rep, _ = captured_stdout(lambda: train.loop(
            mcfg, steps=n, batch=nb, seq=seq, device=device),
            f"phase 22 (c) {arch}", card)
        wall = time.time() - t
        say(f"phase 22 (c) train {arch} ({mcfg.dtype}, {mcfg.family}, "
            f"{mcfg.n_layers} layers, d {mcfg.d_model}) through "
            f"train.loop, {n} steps, batch {nb}, seq {seq}: "
            f"{figures(mcfg, rep, wall)}")
        assert len(rep.losses) == n and all(
            math.isfinite(x) for x in rep.losses), (arch, rep.losses)
        free()
    say(f"phase 22: {time.time() - t22:.1f} s, {phase_memory()}")
    say(card)


class DryRun:
    """Phase 23 (a)'s dry-run cells, each ``python -m
    repro_torch.launch.dryrun`` in a process of its own (the fake process
    group is a process's default group), ``DRYRUN_PARALLEL`` at a time,
    from a thread started with the script; their records land in
    ``build/dryrun/<tag>.json``.  ``join`` waits for them until the
    deadline, then kills what still runs."""

    def __init__(self):
        import threading
        self.out = ROOT / "build" / "dryrun"
        shutil.rmtree(self.out, ignore_errors=True)
        self.out.mkdir(parents=True)
        self.jobs = [("solver", ["--solver", "--both-meshes"])] + [
            (f"{arch}_{shape}", ["--arch", arch, "--shape", shape,
                                 "--multi-pod"])
            for arch, shape in DRYRUN_CELLS.items()]
        self.rc, self.seconds, self.procs = {}, {}, []
        self.t0 = time.time()
        self.stop = False
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        todo, running = list(self.jobs), []
        while (todo or running) and not self.stop:
            while todo and len(running) < DRYRUN_PARALLEL and not self.stop:
                tag, args = todo.pop(0)
                with open(self.out / f"{tag}.out", "w") as log:
                    p = subprocess.Popen(
                        [sys.executable, "-m", "repro_torch.launch.dryrun",
                         *args, "--json", str(self.out / f"{tag}.json")],
                        env=env, stdout=log, stderr=subprocess.STDOUT)
                self.procs.append(p)
                running.append((tag, p, time.time()))
            time.sleep(0.2)
            for job in list(running):
                tag, p, t = job
                if p.poll() is not None:
                    running.remove(job)
                    self.rc[tag], self.seconds[tag] = p.returncode, \
                        time.time() - t

    def join(self) -> dict:
        """{tag: (rc, seconds, records)} of every job; a job cut by the
        deadline has rc None."""
        self.thread.join(timeout=max(1.0, DRYRUN_DEADLINE -
                                     (time.time() - self.t0)))
        self.close()
        out = {}
        for tag, _ in self.jobs:
            path = self.out / f"{tag}.json"
            recs = json.loads(path.read_text()) if path.exists() else []
            out[tag] = (self.rc.get(tag), self.seconds.get(tag), recs)
        return out

    def close(self) -> None:
        """Stop starting cells and kill every one still running."""
        self.stop = True
        self.thread.join(timeout=5.0)
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def dryrun_phase(dry: DryRun, card) -> None:
    """Phase 23 (a): the dry-run's cells, each record's per-device peak
    against the card's 80 GB and its bottleneck; any FAILED cell, or a
    job that did not end with 0, fails the script."""
    got = dry.join()
    n = {"ok": 0, "skipped": 0, "FAILED": 0}
    for tag, (rc, secs, recs) in got.items():
        assert rc == 0 and recs, (tag, rc, (dry.out / f"{tag}.out")
                                  .read_text()[-3000:])
        for r in recs:
            n[r["status"] if r["status"] in n else "FAILED"] += 1
            if r["status"] != "ok":
                say(f"phase 23 (a) {r['arch']} {r['shape']} {r['mesh']}: "
                    f"{r['status']} {r.get('reason', r.get('error', ''))}")
                continue
            f, mem = r["roofline"], r["memory"]
            say(f"phase 23 (a) {r['arch']} {r['shape']} {r['mesh']} "
                f"(traced in {r['trace_s']} s of the job's {secs:.1f}): "
                f"peak {mem['peak_bytes'] / 1e9:.2f} GB a device "
                f"({'fits' if mem['fits_80gb'] else 'does not fit'} 80 GB), "
                f"arguments {mem['argument_bytes'] / 1e9:.2f} GB; "
                f"FLOPs {f['flops_dev']:.4e}, HBM {f['hbm_bytes_dev']:.4e} B, "
                f"collective {f['coll_bytes_dev']:.4e} B a device; t_comp "
                f"{f['t_compute']:.4e} t_mem {f['t_memory']:.4e} t_coll "
                f"{f['t_collective']:.4e} s -> {f['bottleneck']}; useful "
                f"{f['useful_ratio']:.3f}, roofline {f['roofline_fraction']:.4f}")
    say(f"phase 23 (a) dry-run: {n['ok']} ok, {n['skipped']} skipped, "
        f"{n['FAILED']} FAILED (the solver cells on both meshes, one shape "
        f"an architecture on 2x16x16; the H100 SXM's constants, "
        f"launch/analysis.py) [{card}]")
    assert n["FAILED"] == 0 and n["ok"] == 4 + len(DRYRUN_CELLS), n


def sharded_phase(card, device="cuda") -> None:
    """Phase 23 (b): the sharded path on the card.  The parameters, the
    caches, the optimizer state and the batch are DTensors on a one-rank
    NCCL mesh (gloo's DTensor collectives crash a rank on CUDA tensors:
    PERF.md §7), placed by the logical-axis rules; forward, prefill +
    decode and one AdamW step against the plain one-rank run on the same
    seed-0 weights, and the expert-parallel MoE against the global one at
    a capacity where nothing drops."""
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import train
    from repro_torch.models import model, moe, sharding
    from repro_torch.optim import adamw
    t23 = time.time()
    created = not dist.is_initialized()
    mesh = mesh_lib.make_host_mesh(1, 1, device=device)
    dev = mesh_lib.mesh_device(mesh)
    rules = sharding.rules_for_mesh(mesh)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    say(f"phase 23 (b) mesh {tuple(mesh.mesh.shape)} "
        f"{tuple(mesh.mesh_dim_names)} over {dist.get_world_size()} "
        f"rank(s), {dist.get_backend()} on {dev}")

    def place(t, logical):
        return sharding.local_part(t, mesh, sharding.placements(
            sharding.to_pspec(logical, rules), mesh))

    def timed(fn):
        sync()
        t = time.perf_counter()
        out = fn()
        sync()
        return out, (time.perf_counter() - t) * 1e3

    def close(got, want, what):
        got = (got.full_tensor() if sharding.is_dtensor(got) else got).detach()
        want = want.detach().double()
        e = float((got.double() - want).abs().max()) / (
            float(want.abs().max()) + 1.0)
        assert e < SHARD_TOL, (what, e)
        return e

    get = configs.get_smoke if LM_SMOKE else configs.get
    cfg = dataclasses.replace(lm_cut(get(SHARD_ARCH), SHARD_LAYERS),
                              dtype="float32")
    ab = model.model_abstract(cfg)
    params = sharding.init_tree(ab, torch.Generator(dev).manual_seed(0),
                                torch.float32, dev)
    for t in sharding.tree_leaves(params):
        t.requires_grad_()
    dp = sharding.shard_tree(params, ab, rules, mesh)
    B, S = SHARD_BATCH
    tok = torch.randint(0, cfg.vocab_size, (B, S + SHARD_DECODE + 1),
                        generator=torch.Generator(dev).manual_seed(1),
                        device=dev)
    errs, ms = {}, {}
    with torch.no_grad():
        for label, run in (("one rank", lambda: model.forward(
                cfg, params, {"tokens": tok[:, :S]})), ("sharded", lambda:
                model.forward(cfg, dp, {"tokens": place(tok[:, :S], (
                    "batch", None))}, rules=rules))):
            run()                   # the first call pays the propagation
            out, ms[f"forward {label}"] = timed(run)
            if label == "one rank":
                ref = out
        errs["forward"] = close(out, ref, "forward")
        caches = {}
        for label, p, r, put in (("one rank", params, None,
                                  lambda t, ax: t),
                                 ("sharded", dp, rules, place)):
            cache = sharding.tree_map(
                lambda s: put(torch.zeros(s.shape, device=dev), s.logical),
                model.cache_abstract(cfg, B, S + SHARD_DECODE))
            steps, (lg, cache) = [], model.prefill(
                cfg, p, {"tokens": put(tok[:, :S], ("batch", None))}, cache,
                rules=r)
            steps.append(lg)
            for i in range(SHARD_DECODE):
                (lg, cache), t = timed(lambda: model.decode_step(
                    cfg, p, put(tok[:, S + i:S + i + 1], ("batch", None)),
                    cache, S + i, rules=r))
                steps.append(lg)
                ms[f"decode step {label}"] = t
            caches[label] = steps
        errs["prefill + decode"] = max(
            close(g, w, "decode") for g, w in zip(caches["sharded"],
                                                  caches["one rank"]))
    acfg = adamw.AdamWConfig(lr=1e-3)
    batch = {"tokens": tok[:, :S], "labels": tok[:, 1:S + 1]}
    res = {}
    for label, p, r in (("one rank", params, None), ("sharded", dp, rules)):
        b = batch if r is None else train.place_batch(batch, r)
        opt = adamw.init(p)
        (newp, _, loss, _), ms[f"train step {label}"] = timed(
            lambda: train.train_step(cfg, acfg, p, opt, b, 1.0, rules=r))
        res[label] = (loss, newp)
    errs["train loss"] = close(res["sharded"][0], res["one rank"][0], "loss")
    errs["train params"] = max(close(g, w, "params") for g, w in zip(
        sharding.tree_leaves(res["sharded"][1]),
        sharding.tree_leaves(res["one rank"][1])))
    del res, caches
    say(f"phase 23 (b) {cfg.name} float32, {cfg.n_layers} of "
        f"{get(SHARD_ARCH).n_layers} layers, d {cfg.d_model}, ({B}, {S}) "
        f"tokens, {SHARD_DECODE} decode steps, one AdamW step: sharded vs "
        f"one rank " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f" (tol {SHARD_TOL:.0e} of max + 1); ms " + ", ".join(
            f"{k} {v:.2f}" for k, v in ms.items()) + f" [{card}]")

    # the expert-parallel MoE against the global path, nothing dropped
    arch, depth = SHARD_MOE
    mcfg = lm_cut(get(arch), depth)
    mcfg = dataclasses.replace(mcfg, dtype="float32", moe=dataclasses.replace(
        mcfg.moe, capacity_factor=LM20_NO_DROPS))
    mab = model.model_abstract(mcfg)
    mp = sharding.init_tree(mab, torch.Generator(dev).manual_seed(0),
                            torch.float32, dev)
    mdp = sharding.shard_tree(mp, mab, rules, mesh)
    drops, calls = {"sharded": 0, "global": 0}, {"sharded": 0}
    real_apply, real_sharded = moe.moe_apply, moe._moe_sharded

    def spy_apply(c, p, x, rules=None):
        if rules is None:
            drops["global"] += moe.dropped_entries(
                c, p["router"], x.reshape(-1, x.shape[-1]))
        else:       # each batch shard's tokens, as the sharded path routes
            xl = x.redistribute(mesh, sharding.placements(
                sharding.to_pspec(("batch", None, None), rules),
                mesh)).to_local()
            drops["sharded"] += moe.dropped_entries(
                c, p["router"].full_tensor(), xl.reshape(-1, x.shape[-1]))
        return real_apply(c, p, x, rules=rules)

    def spy_sharded(*a, **k):
        out = real_sharded(*a, **k)
        calls["sharded"] += out is not None
        return out
    mtok = tok[:, :S] % mcfg.vocab_size
    moe.moe_apply, moe._moe_sharded = spy_apply, spy_sharded
    try:
        with torch.no_grad():
            want, t_one = timed(lambda: model.forward(
                mcfg, mp, {"tokens": mtok}))
            got, t_sh = timed(lambda: model.forward(
                mcfg, mdp, {"tokens": place(mtok, ("batch", None))},
                rules=rules))
    finally:
        moe.moe_apply, moe._moe_sharded = real_apply, real_sharded
    e = close(got, want, "moe")
    # the MoE layers: each stacks its three expert banks over the periods
    n_moe = sum(s.shape[0] for s in sharding.tree_leaves(mab)
                if len(s.shape) == 4) // 3
    assert calls["sharded"] == n_moe and drops == {"sharded": 0,
                                                   "global": 0}, (calls, drops)
    say(f"phase 23 (b) {mcfg.name} float32, {mcfg.n_layers} of "
        f"{get(arch).n_layers} layers, {mcfg.moe.num_experts} experts on "
        f"the rank, capacity factor {LM20_NO_DROPS}: the expert-parallel "
        f"path ({calls['sharded']} MoE layers) vs the global one max|Δ| "
        f"{e:.3e} of max + 1, dropped entries {drops}; ms forward sharded "
        f"{t_sh:.2f} (the first call, the propagation included), one rank "
        f"{t_one:.2f} [{card}]")
    del mp, mdp, params, dp
    if created:
        dist.destroy_process_group()
    say(f"phase 23: {time.time() - t23:.1f} s, {phase_memory()}")
    say(card)


def rotating_straggler(m):
    """The covering schedule of tests/test_redundant.py: worker t mod m
    stalls at iteration t."""
    return lambda t: np.array([i != (t % m) for i in range(m)])


def red_rank(argv) -> int:
    """Phase 18's rank ``argv[0]``: ``chip_smoke.py --red-rank R DIR
    CONFIG`` joins a gloo group through a FileStore in DIR, makes the
    CONFIG's cut system, and runs redundant APC and Cimmino on a 2 x 1
    mesh under the rotating straggler, then the elastic runtime's death
    path (APC, the death on rank 0's monitor alone).  It writes rank R's
    records to DIR/rankR.npz and prints nothing."""
    rank, out, cfg = int(argv[0]), pathlib.Path(argv[1]), json.loads(argv[2])
    sys.path.insert(0, str(ROOT / "src"))
    import torch.distributed as dist

    from repro_torch import solvers
    from repro_torch.data import linsys
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.runtime.fault import HeartbeatMonitor
    torch.set_num_threads(1)
    device = torch.device(cfg["device"])
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    sync = torch.cuda.synchronize if device.type == "cuda" else (
        lambda: None)
    join_group(rank, out, cfg["world"])
    got = {}
    try:
        with captures_into(got):
            system = linsys.tall_gaussian(**cfg["cut"], seed=1, device=device)
            mesh = mesh_lib.make_mesh((cfg["world"], 1), ("data", "model"),
                                      device=device)
            rot = rotating_straggler(system.m)
            for name in ("apc", "cimmino"):
                s, prm = solvers.get(name), cfg["params"][name]
                sync()
                t = time.perf_counter()
                r = s.solve(system, iters=cfg["iters"], plan=solvers.ExecutionPlan(
                    redundancy=2, alive_schedule=rot, backend="mesh", mesh=mesh),
                    **prm)
                sync()
                got[f"{name}/ms"] = (time.perf_counter() - t) * 1e3
                got[f"{name}/x"] = r.x.cpu().numpy()
                got[f"{name}/res"] = r.residuals.cpu().numpy()
                got[f"{name}/itt"] = np.asarray(r.iters_to_tol)
            s, prm = solvers.get("apc"), cfg["params"]["apc"]
            mon = HeartbeatMonitor(n_workers=system.m)
            rt = solvers.ElasticRuntime(s, system, monitor=mon, segment=25,
                                        plan=solvers.ExecutionPlan(
                                            redundancy=2, backend="mesh",
                                            mesh=mesh), **prm)
            sync()
            t = time.perf_counter()
            death = cfg["iters"] // 3
            r1 = rt.run(iters=death)
            if rank == 0:
                mon.mark_dead(2)
            r2 = rt.run(iters=cfg["iters"] - death)
            sync()
            assert r2.relowerings == 1
            got["apc/elastic/ms"] = (time.perf_counter() - t) * 1e3
            got["apc/elastic/x"] = r2.x.cpu().numpy()
            res = torch.cat([r1.residuals, r2.residuals])
            got["apc/elastic/res"] = res.cpu().numpy()
            got["apc/elastic/itt"] = np.asarray(
                solvers.iters_to_tolerance(res, 1e-6))
    finally:
        dist.destroy_process_group()
    np.savez(out / f"rank{rank}.npz", **got)
    return 0


def main() -> int:
    ranks = {"--mesh-rank": mesh_rank, "--serve-rank": serve_rank,
             "--red-rank": red_rank}
    if sys.argv[1:2] and sys.argv[1] in ranks:
        return ranks[sys.argv[1]](sys.argv[2:])
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "test needs a CUDA device", file=sys.stderr)
        return 1
    PHASE_STARTS.clear()
    # 23 (a). the dry-run's cells (no card), in processes of their own
    # from now on
    dry = DryRun()
    try:
        with env_var(ENGINE_ENV, "fused"):
            kernels, card, t0, bw = phases()
        return finish(dry, kernels, card, t0, bw)
    finally:
        dry.close()


def finish(dry, kernels, card, t0, bw) -> int:
    """Phases 20-23, then the kernels line and the last lines."""
    # 20. the LM serving path of the MoE, SSM, hybrid and MLA decoders,
    # once phases 1-19 have returned: nothing they held stays on the card
    # (qwen3-moe-30b-a3b's bf16 weights alone take 61 of its 80 GB)
    gc.collect()
    torch.cuda.empty_cache()
    lm_families_phase(card, bw)
    # 21. Whisper's encoder-decoder serving; 22. the LM training path
    whisper_phase(card, bw)
    train_phase(card, card_rates(torch.cuda.get_device_name(0))[1])
    # 23. sharding: (a) the dry-run's cells, (b) the sharded path
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dryrun_phase(dry, card)
    sharded_phase(card)
    say(json.dumps({"kernels": kernels}))
    say("phase spans: " + phase_spans(time.time()))
    say(f"total {time.time() - t0:.1f} s")
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def phases():
    """Phases 1-19.  Returns (the ``{"kernels": [...]}`` line's list, the
    card's ``nvidia-smi`` line, the start time, the card's memory rate)."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import solvers
    from repro_torch.analysis import tracecheck
    from repro_torch.core import blockops, partition, spectral
    from repro_torch.core.apc import APCState
    from repro_torch.data import linsys
    from repro_torch.kernels import block_projection as bp
    from repro_torch.kernels import ops
    from repro_torch.launch import solve as cli
    from repro_torch.solvers import executor
    from repro_torch.solvers.projection import CimminoState, ProjFactors

    def form_launches(pair):
        """The launches since the last reset, by kernel; every one of them
        must have gone through the C entries of ``pair`` (a value of
        bp.PAIRS: "f64", "bf16_f64", "bf16_f32")."""
        got = ops.launch_counts(pair)
        assert got == ops.launch_counts(), (pair, ops.launch_counts())
        return got

    # 1. environment ------------------------------------------------------
    t0 = time.time()
    card = smi()
    name = torch.cuda.get_device_name(0)
    bw, peak = card_rates(name)
    say(f"phase 1 env: python {sys.version.split()[0]} torch "
        f"{torch.__version__} cuda {torch.version.cuda} device {name} "
        f"count {torch.cuda.device_count()}")
    say(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    assert not torch.backends.cuda.matmul.allow_tf32
    tb = time.time()
    libs = bp.build()
    say(f"phase 1 build: {time.time() - tb:.2f} s ({SOURCE}, sm_90a, a "
        f"library for each of the {len(libs)} dtype pairs, their nvcc "
        f"processes started together)")
    ptxas = ptxas_summary("".join(lib.with_suffix(".log").read_text()
                                  for lib in libs.values()),
                          bp.ring_smem_bytes, bp.MMA_FORMS)
    say("phase 1 ptxas: " + "; ".join(ptxas))
    for tag in ("f64", "bf16/f64"):      # every float64-compute ring
        rings = [x for x in ptxas if x.split()[1] == tag and "_ring " in x]
        assert all(" spill 0 B:" in x for x in rings), rings
        assert {x.split()[0] for x in rings} == {
            f"{kn}_ring" for kn in bp.RINGS}, rings
    # the tensor-core forms (the FP64 and the bf16 ones): both instances
    # at every KC (sparse_scatter's in both epilogues), none spilling
    tags = {sfx: "bf16" if sfx == "bf16_bf16" else sfx.replace("_", "/")
            for sfx in bp.PAIRS.values()}
    tc_forms = bp.MMA_FORMS + bp.BF16_MMA_FORMS
    mma = [x for x in ptxas if (x.split()[0].replace("_ring", ""),
                                x.split()[1]) in {
        (kn, tags[sfx]) for kn, sfx in tc_forms}]
    assert {tuple(x.split()[:3]) + tuple(
        w for w in x.split()[3:4] if w in ("apc", "cimmino"))
            for x in mma} == {
        (f"{kn}{inst}", tags[sfx], f"KC={kc}") + form
        for kn, sfx in tc_forms for inst in ("", "_ring")
        for kc in bp.KC_VALUES
        for form in ((("apc",), ("cimmino",)) if kn == "sparse_scatter"
                     else ((),))}, mma
    assert all(" spill 0 B:" in x for x in mma), mma
    # the all-bf16 form: both instances of every kernel
    assert {x.split()[0] for x in ptxas if x.split()[1] == "bf16"
            and not x.startswith("support_operand")} == {
        f"{kn}{inst}" for kn in bp.KERNELS for inst in ("", "_ring")}, \
        ptxas

    # 2. kernel vs plain version ------------------------------------------
    max_abs = {}             # (kernel, form) -> max|Δ| at the main shapes

    def check(kname, got, want, pr, label, record):
        """got (in the compute dtype) against the plain version, at the
        compute dtype's tolerance; ``pr`` is the form (pair_label)."""
        assert got.dtype == want.dtype, (kname, label, pr, got.dtype)
        e, d = rel_err(got, want)
        assert e < TOL[got.dtype], (kname, label, pr, e)
        if record:
            max_abs[(kname, pr)] = max(max_abs.get((kname, pr), 0.0), d)
        return e

    def instances(kname, launch, want, matrix, copied, pr, label, record):
        """Both instances of a kernel of bp.RINGS, ``launch(instance,
        matrix)``: the row dot, and the ring where ``gather_instance``
        admits these operands; each against the plain version, and the
        two bit-identical — but for a bf16-stored scatter outside
        bp.MMA_FORMS, whose row dot sums in the packed order: its ring is
        bit-identical to the ring on the matrix widened to the compute
        dtype.  Returns what held."""
        ring = bp.gather_instance(matrix, *copied) == "ring"
        outs = {inst: launch(inst, matrix) for inst in bp.INSTANCES
                if inst == "row_dot" or ring}
        torch.cuda.synchronize()
        for got in outs.values():
            check(kname, got.reshape(want.shape), want, pr, label, record)
        if not ring:
            return "row_dot"
        if kname in bp.SCATTERS and matrix.dtype == BF16 and (
                kname, bp.PAIRS[(matrix.dtype, want.dtype)]) \
                not in bp.MMA_FORMS:
            wide = launch("ring", matrix.to(copied[0].dtype))
            assert torch.equal(outs["ring"], wide), (kname, label)
            return "ring≡widened ring"
        assert torch.equal(outs["ring"], outs["row_dot"]), (kname, label)
        return "ring≡row_dot"

    def compare(A, B, X, Xb, V, gamma, label, record=False):
        """The four dense kernels against their plain versions; V stands in for
        both the APC scatter's U and the Cimmino scatter's V.  A and B in
        X's dtype or in bfloat16 (a mixed form)."""
        pr = pair_label(A, X)
        outs = {
            "apc_gather": (ops.proj_gather(A, X, Xb),
                           ops.apc_gather_ref(A, X, Xb)),
            "apc_scatter": (ops.proj_scatter(B, X, Xb, V, gamma),
                            ops.apc_scatter_ref(B, X, Xb, V, gamma)),
            "cimmino_gather": (ops.cimmino_gather(A, Xb),
                               ops.cimmino_gather_ref(A, Xb)),
            "cimmino_scatter": (ops.cimmino_scatter(B, V),
                                ops.cimmino_scatter_ref(B, V)),
        }
        torch.cuda.synchronize()
        errs = {kn: check(kn, got, want, pr, label, record)
                for kn, (got, want) in outs.items()}
        X3, Xb3 = (X, Xb) if X.dim() == 3 else (X[:, None], Xb[None])
        V3 = V if V.dim() == 3 else V[:, None]
        ran = {
            "apc_gather": instances(
                "apc_gather", lambda inst, M: bp.apc_gather(
                    M, X3, Xb3, _instance=inst), outs["apc_gather"][1], A,
                (X3, Xb3), pr, label, record),
            "apc_scatter": instances(
                "apc_scatter", lambda inst, M: bp.apc_scatter(
                    M, X3, Xb3, V3, gamma, _instance=inst),
                outs["apc_scatter"][1], B, (V3,), pr, label, record),
            "cimmino_gather": instances(
                "cimmino_gather", lambda inst, M: bp.cimmino_gather(
                    M, Xb3, _instance=inst), outs["cimmino_gather"][1], A,
                (Xb3,), pr, label, record),
            "cimmino_scatter": instances(
                "cimmino_scatter", lambda inst, M: bp.cimmino_scatter(
                    M, V3, _instance=inst), outs["cimmino_scatter"][1], B,
                (V3,), pr, label, record)}
        say(f"phase 2 {label} {pr}: " + " ".join(
            f"{kn} {e:.3e}" for kn, e in errs.items())
            + f" (tol {TOL[X.dtype]:.0e}); "
            + "; ".join(f"{kn} {how}" for kn, how in ran.items()))
        if X.dim() == 3:    # a batch row is bit-identical to a k=1 call
            i = X.shape[1] - 1
            rows = {
                "apc_gather": ops.proj_gather(A, X[:, i], Xb[i]),
                "apc_scatter": ops.proj_scatter(B, X[:, i], Xb[i], V[:, i],
                                                gamma),
                "cimmino_gather": ops.cimmino_gather(A, Xb[i]),
                "cimmino_scatter": ops.cimmino_scatter(B, V[:, i]),
            }
            for kn, row in rows.items():
                assert torch.equal(row, outs[kn][0][:, i]), (kn, label)

    def compare_sparse(vals, cols, Bv, X, Xb, V, gamma, label,
                       record=False):
        """The three sparse kernels against their plain versions, through
        the two sparse ops: U of each op is its gather's result, Y and R
        the two forms of ``sparse_scatter``; V is the Cimmino b.  vals and
        Bvals in X's dtype or in bfloat16 (a mixed form)."""
        pr = pair_label(vals, X)
        Y, U = ops.sparse_proj_update(vals, cols, Bv, X, Xb, gamma)
        R, Uc = ops.sparse_cimmino_update(vals, cols, Bv, V, Xb)
        Yr, Ur = ops.sparse_proj_update_ref(vals, cols, Bv, X, Xb, gamma)
        Rr, Ucr = ops.sparse_cimmino_update_ref(vals, cols, Bv, V, Xb)
        torch.cuda.synchronize()
        pairs = {"sparse_gather": [(U, Ur)],
                 "sparse_cimmino_gather": [(Uc, Ucr)],
                 "sparse_scatter": [(Y, Yr), (R, Rr)]}
        errs = {kn: max(check(kn, got, want, pr, label, record)
                        for got, want in outs) for kn, outs in pairs.items()}
        X3, Xb3 = (X, Xb) if X.dim() == 3 else (X[:, None], Xb[None])
        V3 = V if V.dim() == 3 else V[:, None]
        Ur3 = Ur if Ur.dim() == 3 else Ur[:, None]
        ran = {
            "sparse_gather": instances(
                "sparse_gather", lambda inst, M: bp.sparse_gather(
                    M, cols, X3, Xb3, _instance=inst), Ur, vals, (), pr,
                label, record),
            "sparse_cimmino_gather": instances(
                "sparse_cimmino_gather", lambda inst, M:
                bp.sparse_cimmino_gather(M, cols, Xb3, _instance=inst), Ucr,
                vals, (), pr, label, record)}
        # both forms of sparse_scatter on the plain gathers' U (APC, into
        # the AXPY pre-pass) and on V (Cimmino, into zeros)
        Y0 = X3 + gamma * (Xb3 - X3)
        for form, U_, out0, kw in (
                ("apc", Ur3, Y0, dict(X=X3, Xbar=Xb3, gamma=gamma)),
                ("cimmino", V3, torch.zeros_like(Y0), {})):
            want = ops.sparse_scatter_ref(Bv, cols, U_, out0, kw.get("X"),
                                          kw.get("Xbar"), gamma)
            ran[f"sparse_scatter {form}"] = instances(
                "sparse_scatter", lambda inst, M: bp.sparse_scatter(
                    M, cols, U_, out0.clone(), **kw, _instance=inst), want,
                Bv, (U_,), pr, label, record)
        say(f"phase 2 {label} {pr}: " + " ".join(
            f"{kn} {e:.3e}" for kn, e in errs.items())
            + f" (tol {TOL[X.dtype]:.0e}); "
            + "; ".join(f"{kn} {how}" for kn, how in ran.items()))
        if X.dim() == 3:    # a batch row is bit-identical to a k=1 call
            i = X.shape[1] - 1
            Y1, U1 = ops.sparse_proj_update(vals, cols, Bv, X[:, i], Xb[i],
                                            gamma)
            R1, Uc1 = ops.sparse_cimmino_update(vals, cols, Bv, V[:, i],
                                                Xb[i])
            for row, full in ((U1, U), (Y1, Y), (Uc1, Uc), (R1, R)):
                assert torch.equal(row, full[:, i]), label

    def sparse_inputs(vals, cols, n, k, dt, seed):
        """Seeded X (m,k,n), X̄ (k,n), V (m,k,p) as (m, k, .) views of
        (k, m, .) tensors (k = 1: without the k axis), vals/cols as given."""
        m, p, _ = vals.shape
        rng = np.random.default_rng(seed)
        g = lambda *s: torch.as_tensor(rng.standard_normal(s),  # noqa: E731
                                       device="cuda").to(dt)
        X, Xb, V = g(k, m, n).transpose(0, 1), g(k, n), \
            g(k, m, p).transpose(0, 1)
        if k == 1:
            X, Xb, V = X[:, 0], Xb[0], V[:, 0]
        return X, Xb, V

    def bf16_sparse_gathers(vals, cols, X, Xb, label):
        """The all-bf16 sparse gathers (phase 15 (a) times them) on the
        bf16-rounded operands: both instances, the ring where vals' rows
        admit it, against the plain versions at BF16_TOL, ring ≡ row dot,
        and the last batch row ≡ a k = 1 call, bit for bit."""
        v, x, xb = vals.to(BF16), X.to(BF16), Xb.to(BF16)
        X3, Xb3 = (x, xb) if x.dim() == 3 else (x[:, None], xb[None])
        ring = bp.gather_instance(v) == "ring"
        errs = {}
        for kname, launch, want in (
                ("sparse_gather", lambda inst, kk=slice(None):
                 bp.sparse_gather(v, cols, X3[:, kk], Xb3[kk],
                                  _instance=inst),
                 ops.sparse_gather_ref(v, cols, X3, Xb3)),
                ("sparse_cimmino_gather", lambda inst, kk=slice(None):
                 bp.sparse_cimmino_gather(v, cols, Xb3[kk], _instance=inst),
                 ops.sparse_cimmino_gather_ref(v, cols, Xb3))):
            outs = {inst: launch(inst) for inst in bp.INSTANCES
                    if inst == "row_dot" or ring}
            torch.cuda.synchronize()
            for inst, got in outs.items():
                e, d = rel_err(got, want)
                assert got.dtype == BF16 and e < BF16_TOL, (kname, label,
                                                           inst, e)
                errs[kname] = max(errs.get(kname, 0.0), e)
                i = X3.shape[1] - 1
                assert torch.equal(launch(inst, slice(i, i + 1)),
                                   got[:, i:]), (kname, label, inst)
            if ring:
                assert torch.equal(outs["ring"], outs["row_dot"]), (kname,
                                                                   label)
        say(f"phase 2 {label} bfloat16/bfloat16: " + " ".join(
            f"{kn} {e:.3e}" for kn, e in errs.items())
            + f" (tol {BF16_TOL:.0e}); sparse gathers "
            + ("ring≡row_dot" if ring else "row_dot")
            + "; batch row ≡ k=1 call")

    for spec in SPARSE_CORNERS:
        csys = linsys.banded_system(seed=0, device="cuda", **spec)
        # each corner system's factors once, for its kernels' operands
        cf = solvers.get("apc").kernel_factors(
            solvers.get("apc").prepare(csys.A_op, {}))  # repro: allow[R003]
        for dt in TOL:
            for k in (1, 5, K_MANY, 11):
                X, Xb, V = sparse_inputs(cf.A.vals, csys.cols, csys.n, k, dt,
                                         seed=csys.n + k)
                label = (f"banded n={csys.n} m={csys.m} p={csys.p} "
                         f"w={csys.cols.shape[1]} k={k}")
                for mdt in (dt, BF16):
                    compare_sparse(cf.A.vals.to(mdt), csys.cols,
                                   cf.B.to(mdt), X, Xb, V, 0.83, label)
                if dt == torch.float64:
                    bf16_sparse_gathers(cf.A.vals, csys.cols, X, Xb, label)
    # the sparse path's shapes: its band support, seeded values, and the
    # padded slots zeroed as as_sparse leaves them
    sn, sm, sbw = SPARSE["n"], SPARSE["m"], SPARSE["bandwidth"]
    sp_p = sn // sm
    band = np.zeros((sm, sn), bool)
    for i in range(sm):
        band[i, max(i * sp_p - sbw, 0):(i + 1) * sp_p + sbw] = True
    scols = torch.as_tensor(partition.support_cols(band), device="cuda")
    sw = scols.shape[1]
    rng = np.random.default_rng(11)
    svals = torch.as_tensor(rng.standard_normal((sm, sp_p, sw)),
                            device="cuda")
    sBv = torch.as_tensor(rng.standard_normal((sm, sw, sp_p)), device="cuda")
    for i in range(sm):          # every slot of a repeated (pad) column
        c = scols[i].cpu().numpy()
        _, inv, counts = np.unique(c, return_inverse=True,
                                   return_counts=True)
        pad = torch.as_tensor(np.flatnonzero(counts[inv] > 1),
                              device="cuda")
        svals[i][:, pad] = 0.0
        sBv[i][pad] = 0.0
    for k in (1, K_MANY):
        for dt in TOL:
            X, Xb, V = sparse_inputs(svals, scols, sn, k, dt, seed=k)
            label = f"sparse path m={sm} p={sp_p} w={sw} n={sn} k={k}"
            for mdt in (dt, BF16):
                compare_sparse(svals.to(mdt), scols, sBv.to(mdt), X, Xb, V,
                               0.9, label, record=True)
            if dt == torch.float64:
                bf16_sparse_gathers(svals, scols, X, Xb, label)
    del svals, sBv

    for dt in TOL:
        for (p, n) in RAGGED:
            for k in (1, 5, K_MANY, 11):
                A, B, X, Xb, V = inputs(3, p, n, k, dt, seed=p * n + k,
                                        transposed=k > 1)
                if k == 1:
                    X, Xb, V = X[:, 0], Xb[0], V[:, 0]
                for mdt in (dt, BF16):
                    compare(A.to(mdt), B.to(mdt), X, Xb, V, 0.83,
                            f"m=3 p={p} n={n} k={k}")

    t = time.time()
    sys_ = linsys.tall_gaussian(**FULL, seed=0, device="cuda")
    torch.cuda.synchronize()
    m, p, n = sys_.m, sys_.p, sys_.n
    say(f"data: tall_gaussian N={sys_.N} n={n} m={m} float64 in "
        f"{time.time() - t:.2f} s")
    solver = solvers.get("apc")
    # the main path's factors, timed and shared by the phases that follow
    factors = solver.kernel_factors(
        solver.prepare(sys_.A_op, {}))  # repro: allow[R003]
    rng = np.random.default_rng(1)
    for k in (1, K_MANY):
        X = torch.as_tensor(rng.standard_normal((k, m, n)), device="cuda")
        Xb = torch.as_tensor(rng.standard_normal((k, n)), device="cuda")
        V = torch.as_tensor(rng.standard_normal((k, m, p)), device="cuda")
        for dt in TOL:
            Xd, Xbd = X.to(dt).transpose(0, 1), Xb.to(dt)
            Vd = V.to(dt).transpose(0, 1)
            if k == 1:
                Xd, Xbd, Vd = Xd[:, 0], Xbd[0], Vd[:, 0]
            for mdt in (dt, BF16):
                A, B = factors.A.to(mdt), factors.B.to(mdt)
                compare(A, B, Xd, Xbd, Vd, 0.9, f"main path m={m} p={p} "
                        f"n={n} k={k}", record=True)
                del A, B

    # 3. the APC main path at full size -----------------------------------
    t = time.time()
    params, rho = solver.analyze(sys_)
    torch.cuda.synchronize()
    t_analyze = time.time() - t
    say(f"phase 3 analyze: gamma={params['gamma']:.6f} "
        f"eta={params['eta']:.6f} rho={rho:.6f} in {t_analyze:.2f} s")
    kplan = solvers.ExecutionPlan(kernel=True)
    ops.reset_launch_counts()
    t = time.time()
    res = solver.solve(sys_, iters=ITERS, plan=kplan, **params)
    torch.cuda.synchronize()
    t_solve = time.time() - t
    launches = form_launches("f64")
    err = float(torch.linalg.norm(res.x - sys_.x_true)
                / torch.linalg.norm(sys_.x_true))
    say(f"phase 3 solve kernel=True: {ITERS} iters in {t_solve:.2f} s "
        f"(prepare included), residual {float(res.residuals[-1]):.3e} "
        f"rel-error {err:.3e} iters_to_tol {res.iters_to_tol} "
        f"launches {launches}")
    assert err <= 1e-8, err
    assert launches == {kn: ITERS if kn in USES["apc"] else 0
                        for kn in bp.KERNELS}, launches
    res_u = solver.solve(sys_, iters=ITERS,
                         plan=solvers.ExecutionPlan(factors=factors),
                         **params)
    # the reference's kernel-vs-unfused contract
    # (tests/test_kernel_engine.py _close: rtol 1e-6, atol 1e-12)
    dres = float((res.residuals - res_u.residuals).abs().max())
    assert torch.allclose(res.residuals, res_u.residuals, rtol=1e-6,
                          atol=1e-12), dres
    assert torch.allclose(res.errors, res_u.errors, rtol=1e-6,
                          atol=1e-12)
    res2 = solver.solve(sys_, iters=ITERS, plan=kplan, **params)
    assert torch.equal(res2.residuals, res.residuals)
    assert torch.equal(res2.x, res.x)
    say(f"phase 3 checks: kernel vs unfused history max|Δ| {dres:.3e}; "
        f"repeat bit-identical")

    # 4. solve_many -------------------------------------------------------
    def consistent_rhs(system, seed):
        """K_MANY seeded solutions xs and their right-hand sides A xs."""
        xs = torch.as_tensor(np.random.default_rng(seed).standard_normal(
            (K_MANY, system.n)), device="cuda")
        return xs, (system.A_blocks.reshape(system.N, system.n) @ xs.T).T

    def many_vs_rows(s, prm, label, check_x, system, facs, xs, Bm, uses,
                     precision="default"):
        """solve_many with K_MANY rows through one launch of each kernel
        per step, each row against its single solve (``check_x`` also
        holds it to the row's x_true)."""
        kplan_p = solvers.ExecutionPlan(kernel=True, factors=facs,
                                        precision=precision)
        ops.reset_launch_counts()
        t = time.time()
        many = s.solve_many(system, Bm, iters=ITERS, plan=kplan_p, **prm)
        torch.cuda.synchronize()
        t_many = time.time() - t
        got = form_launches("f64" if precision == "default" else "bf16_f64")
        assert got == {kn: ITERS if kn in uses[s.name] else 0
                       for kn in bp.KERNELS}, got
        worst = 0.0
        for i in range(K_MANY):
            row = dataclasses.replace(
                system, b_blocks=Bm[i].reshape(system.m, system.p),
                x_true=xs[i], mode="square")
            one = s.solve(row, iters=ITERS, plan=kplan_p, **prm)
            d = float(torch.linalg.norm(many.x[i] - one.x)
                      / torch.linalg.norm(one.x))
            worst = max(worst, d)
            assert d <= 1e-12, (label, i, d)
            if check_x:
                assert float(torch.linalg.norm(many.x[i] - xs[i])
                             / torch.linalg.norm(xs[i])) <= 1e-8
        say(f"phase {label} solve_many k={K_MANY}"
            + ("" if precision == "default" else f" precision={precision}")
            + f": {ITERS} iters in "
            f"{t_many:.2f} s, launches {got}, max row vs single solve "
            f"{worst:.3e}")

    xs, Bm = consistent_rhs(sys_, 2)
    many_vs_rows(solver, params, "4", True, sys_, factors, xs, Bm, USES)

    # 5. Cimmino and consensus at full size --------------------------------
    t = time.time()
    mu = spectral.mu_extremes(spectral.x_matrix(sys_))
    lam = spectral.ata_extremes(sys_)
    torch.cuda.synchronize()
    t_spec = time.time() - t
    say(f"phase 5 spectrum: mu(X) [{mu[0]:.6e}, {mu[1]:.6e}] "
        f"lambda(AᵀA) [{lam[0]:.6e}, {lam[1]:.6e}] in {t_spec:.2f} s")
    # every solver's pinned parameters and theoretical rate from this one
    # analysis (the closed forms each solver's analyze() applies)
    apc_p = spectral.apc_optimal(*mu)
    nu_m, rho_cim = spectral.cimmino_optimal(*mu)
    a_dgd, rho_dgd = spectral.dgd_optimal(*lam)
    a_nag, b_nag, rho_nag = spectral.dnag_optimal(*lam)
    a_hbm, b_hbm, rho_hbm = spectral.dhbm_optimal(*lam)
    a_p, b_p, rho_p = spectral.dhbm_optimal(m * mu[0], m * mu[1])
    pinned = {
        "apc": ({"gamma": apc_p.gamma, "eta": apc_p.eta}, apc_p.rho),
        "cimmino": ({"nu": nu_m / m}, rho_cim),
        "consensus": ({"gamma": 1.0, "eta": 1.0},
                      spectral.consensus_rate(mu[0])),
        "dgd": ({"alpha": a_dgd}, rho_dgd),
        "dhbm": ({"alpha": a_hbm, "beta": b_hbm}, rho_hbm),
        "dnag": ({"alpha": a_nag, "beta": b_nag}, rho_nag),
        "madmm": ({"xi": 1.0}, None),
        "pdhbm": ({"alpha": a_p, "beta": b_p}, rho_p),
    }
    assert sorted(pinned) == solvers.available()
    for key in params:     # the same closed form as phase 3's analyze()
        assert math.isclose(pinned["apc"][0][key], params[key],
                            rel_tol=1e-9), key
    cim_launches = {}
    kernel_runs = {}
    for sname in ("cimmino", "consensus"):
        s = solvers.get(sname)
        prm = pinned[sname][0]
        ops.reset_launch_counts()
        t = time.time()
        r = s.solve(sys_, iters=ITERS, plan=kplan, **prm)
        torch.cuda.synchronize()
        t_solve = time.time() - t
        got = form_launches("f64")
        assert got == {kn: ITERS if kn in USES[sname] else 0
                       for kn in bp.KERNELS}, (sname, got)
        if sname == "cimmino":
            cim_launches = got
        r_u = s.solve(sys_, iters=ITERS,
                      plan=solvers.ExecutionPlan(factors=factors), **prm)
        d = float((r.residuals - r_u.residuals).abs().max())
        assert torch.allclose(r.residuals, r_u.residuals, rtol=1e-6,
                              atol=1e-12), (sname, d)
        assert torch.allclose(r.errors, r_u.errors, rtol=1e-6, atol=1e-12)
        r2 = s.solve(sys_, iters=ITERS, plan=kplan, **prm)
        assert torch.equal(r2.residuals, r.residuals), sname
        assert torch.equal(r2.x, r.x), sname
        assert torch.isfinite(r.residuals).all()
        assert float(r.residuals[-1]) < float(r.residuals[0]), sname
        kernel_runs[sname] = r
        say(f"phase 5 {sname} solve kernel=True: {ITERS} iters in "
            f"{t_solve:.2f} s (prepare included), residual "
            f"{float(r.residuals[-1]):.3e} iters_to_tol {r.iters_to_tol} "
            f"launches {got}; kernel vs unfused history max|Δ| {d:.3e}; "
            f"repeat bit-identical")
    many_vs_rows(solvers.get("cimmino"), pinned["cimmino"][0], "5", False,
                 sys_, factors, xs, Bm, USES)

    # 6. the paper's comparison -------------------------------------------
    kernel_runs["apc"] = res
    for sname, (prm, rho_th) in pinned.items():
        s = solvers.get(sname)
        t = time.time()
        if sname not in kernel_runs:
            kernel_runs[sname] = s.solve(sys_, iters=ITERS, **prm)
            torch.cuda.synchronize()
        r = kernel_runs[sname]
        assert torch.isfinite(r.residuals).all(), sname
        assert float(r.residuals[-1]) < float(r.residuals[0]), sname
        dec = decay(r.residuals)
        say(f"phase 6 {s.paper_name or sname:>9} ({sname}, "
            f"{'kernel' if sname in USES else 'unfused'}): residual "
            f"{float(r.residuals[-1]):.3e} after {ITERS} iters, "
            f"iters_to_tol {r.iters_to_tol}, rho theory "
            f"{'n/a' if rho_th is None else f'{rho_th:.6f}'} measured "
            f"{'n/a' if dec is None else f'{dec:.6f}'}"
            + ("" if sname in USES else
               f", {time.time() - t:.2f} s with prepare"))
    f64_hist = {sname: kernel_runs[sname].residuals for sname in USES}
    del kernel_runs

    # 7. the CLI entry point ----------------------------------------------
    for method in ("apc", "cimmino"):
        ops.reset_launch_counts()
        rc = cli.main(CLI_ARGS + ["--method", method])
        assert rc == 0, rc
        got = ops.launch_counts()
        assert all((got[kn] > 0) == (kn in USES[method])
                   for kn in bp.KERNELS), (method, got)
        say(f"phase 7 cli {' '.join(CLI_ARGS)} --method {method}: rc {rc} "
            f"launches {got}")

    # 13. compile-once execution: the checks of each half -------------------
    def solve_k(s, system, k, plan, prm, Bk):
        """``solve`` (k = 1, the system's own b) or ``solve_many`` on the
        K_MANY right-hand sides ``Bk``."""
        if k == 1:
            return s.solve(system, iters=ITERS, plan=plan, **prm)
        return s.solve_many(system, Bk, iters=ITERS, plan=plan, **prm)

    def captured_vs_eager(label, system, facs_of, prm_of, uses, Bk):
        """APC, consensus and Cimmino on the kernels, default and mixed,
        k = 1 and K_MANY: the captured solve's residual and error
        histories and x torch.equal to the eager loop's
        (``executor.disable_capture``), launches of each kernel 150 a
        solve (the replays counted), the instances it took those of the
        eager loop, and a bit-identical repeat."""
        for precision, facs in facs_of.items():
            pair = "f64" if precision == "default" else "bf16_f64"
            plan = solvers.ExecutionPlan(kernel=True, precision=precision,
                                         factors=facs)
            for sname in ("apc", "consensus", "cimmino"):
                s, prm = solvers.get(sname), prm_of[sname][0]
                for k in (1, K_MANY):
                    run = lambda: solve_k(s, system, k, plan, prm, Bk)  # noqa: E731,E501
                    ops.reset_launch_counts()
                    r, cap = launched_instances(run)
                    torch.cuda.synchronize()
                    got = form_launches(pair)
                    assert got == {kn: ITERS if kn in uses[sname] else 0
                                   for kn in bp.KERNELS}, (label, sname, got)
                    with executor.disable_capture():
                        e, eag = launched_instances(run)
                    r2 = run()
                    torch.cuda.synchronize()
                    assert cap == eag, (label, sname, precision, k, cap, eag)
                    for what in ("residuals", "errors", "x"):
                        a = getattr(r, what)
                        if a is None:
                            continue
                        assert torch.equal(a, getattr(e, what)), (
                            label, sname, precision, k, what)
                        assert torch.equal(a, getattr(r2, what)), (
                            label, sname, precision, k, what)
                    say(f"phase 13 {label} {sname} {precision} k={k}: "
                        f"captured ≡ eager loop (residuals, "
                        f"{'errors, ' if r.errors is not None else ''}x), "
                        f"launches {got}; instances captured "
                        f"{sorted(cap)} eager {sorted(eag)}; repeat "
                        f"bit-identical")

    def dgd_vs_eager(label, system, prm, Bk):
        """DGD, whose glue is cuBLAS: captured against the eager loop
        within 1e-12 relative, and whether it came out bit-identical."""
        s = solvers.get("dgd")
        for k in (1, K_MANY):
            run = lambda: solve_k(s, system, k, solvers.ExecutionPlan(),  # noqa: E731,E501
                                  prm, Bk)
            r = run()
            with executor.disable_capture():
                e = run()
            torch.cuda.synchronize()
            d = float(((r.residuals - e.residuals).abs()
                       / e.residuals.abs()).max())
            dx = float(torch.linalg.norm(r.x - e.x) / torch.linalg.norm(e.x))
            assert d <= 1e-12 and dx <= 1e-12, (label, k, d, dx)
            same = torch.equal(r.residuals, e.residuals) and torch.equal(
                r.x, e.x)
            say(f"phase 13 {label} dgd k={k} (cuBLAS glue): captured vs "
                f"eager loop max relative residual Δ {d:.3e}, x {dx:.3e} "
                f"(tol 1e-12); bit-identical {same}")

    def solve_times(label, system, facs_of, prm_of, snames, Bk, rounds=4):
        """Each solver's whole solve on the kernels per iteration, eager
        loop against captured, host clock around work ending in
        synchronize(), in turns, medians of ``rounds``."""
        plans = {precision: solvers.ExecutionPlan(
            kernel=True, precision=precision, factors=facs)
            for precision, facs in facs_of.items()}
        times = {(sname, precision, k, how): [] for sname in snames
                 for precision in plans for k in (1, K_MANY)
                 for how in ("eager", "captured")}
        for _ in range(rounds):
            for sname, precision, k, how in times:
                torch.cuda.synchronize()
                t = time.perf_counter()
                with (executor.disable_capture() if how == "eager"
                      else contextlib.nullcontext()):
                    solve_k(solvers.get(sname), system, k, plans[precision],
                            prm_of[sname][0], Bk)
                torch.cuda.synchronize()
                times[(sname, precision, k, how)].append(
                    (time.perf_counter() - t) / ITERS * 1e3)
        med = {key: float(np.median(v)) for key, v in times.items()}
        for sname, precision, k, how in times:
            if how == "eager":
                e, c = med[(sname, precision, k, how)], med[
                    (sname, precision, k, "captured")]
                say(f"phase 13 {label} {sname} k={k} {precision}: whole "
                    f"solve {e:.4f} ms per iteration eager, {c:.4f} ms "
                    f"captured (ratio {e / c:.2f}; host clock to "
                    f"synchronize(), {ITERS} iterations, median of {rounds} "
                    f"in turns) [{card}]")
        return med

    def graphed(fn, n=10):
        """``n`` calls of ``fn`` captured into one CUDA graph (after an
        eager call): its replay."""
        fn()
        torch.cuda.synchronize()
        graph, _ = executor._capture(lambda: [fn() for _ in range(n)],
                                     "chip_smoke steps")
        return graph.replay

    def memory_of(run):
        """(bytes allocated at ``run()``'s peak above what was resident,
        for each CUDA graph captured in it the bytes it reserved for its
        private pool — device memory reserved across the capture, the
        cache emptied first — and the capture's host time in ms, from the
        device idle to the graph instantiated)."""
        pools, capture = [], executor._capture

        def spy(body, name):
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            before = torch.cuda.memory_reserved()
            t = time.perf_counter()
            out = capture(body, name)
            pools.append((torch.cuda.memory_reserved() - before,
                          (time.perf_counter() - t) * 1e3))
            return out
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        executor._capture = spy
        try:
            run()
        finally:
            executor._capture = capture
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() - base, pools

    def idle_share(label, run, unprofiled_ms):
        """The device's idle share over ``run()``: kernel time summed from
        the profiler's key_averages() over the wall window, and over the
        same run's unprofiled wall time ``unprofiled_ms``.  Without device
        time in the profile, the CUDA-event span instead, and the share
        not measured."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) * 1e3
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)) / 1e3
        if busy > 0:
            say(f"phase 13 {label}: device idle share {1 - busy / wall:.1%} "
                f"of the profiled window (kernels {busy:.3f} ms of "
                f"{wall:.3f} ms wall, profiler on), "
                f"{1 - busy / unprofiled_ms:.1%} of the unprofiled solve "
                f"({unprofiled_ms:.3f} ms wall) [{card}]")
            return
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        say(f"phase 13 {label}: the profiler shows no device time; the "
            f"CUDA-event span of the solve is {start.elapsed_time(end):.3f} "
            f"ms; device idle share not measured [{card}]")

    # 12. precision="mixed", dense half -------------------------------------
    def upcast_twin(facs):
        """The bf16-rounded factors widened to float64: the default solve
        on them is what the mixed solve computes."""
        A = facs.A
        A = (A._replace(vals=A.vals.double()) if blockops.is_sparse(A)
             else A.double())
        return ProjFactors(A=A, chol=facs.chol, B=facs.B.double())

    # launches of each mixed run, by (system, solver): of the bf16/float64
    # form, and in float32_solves of the bf16/float32 and float32 forms
    mixed_launches, mixed32_launches, f32_launches = {}, {}, {}

    def mixed_solves(label, system, facs, prm_of, uses, f64_runs):
        """APC, consensus and Cimmino with precision="mixed" on ``facs``
        (the cast kernel factors): launches of the bf16/float64 form
        only, a bit-identical repeat, the upcast twin (float64 form only)
        within TWIN_TOL, the float64 history within the reference's bf16
        envelope."""
        twin = upcast_twin(facs)
        mplan = solvers.ExecutionPlan(kernel=True, precision="mixed",
                                      factors=facs)
        for sname in ("apc", "consensus", "cimmino"):
            s = solvers.get(sname)
            prm = prm_of[sname][0]
            ops.reset_launch_counts()
            t = time.time()
            r = s.solve(system, iters=ITERS, plan=mplan, **prm)
            torch.cuda.synchronize()
            t_solve = time.time() - t
            got = mixed_launches[(label, sname)] = form_launches("bf16_f64")
            want = {kn: ITERS if kn in uses[sname] else 0
                    for kn in bp.KERNELS}
            assert got == want, (label, sname, got)
            r2 = s.solve(system, iters=ITERS, plan=mplan, **prm)
            assert torch.equal(r2.residuals, r.residuals), (label, sname)
            assert torch.equal(r2.x, r.x), (label, sname)
            ops.reset_launch_counts()
            tw = s.solve(system, iters=ITERS, plan=solvers.ExecutionPlan(
                kernel=True, factors=twin), **prm)
            assert form_launches("f64") == want, (label, sname)
            d_tw = float((r.residuals - tw.residuals).abs().max())
            d_tx = float((r.x - tw.x).abs().max())
            assert d_tw <= TWIN_TOL and torch.allclose(
                r.errors, tw.errors, rtol=0, atol=TWIN_TOL), (sname, d_tw)
            assert torch.isfinite(r.residuals).all(), (label, sname)
            ref = f64_runs[sname]
            assert torch.allclose(r.residuals, ref, **MIXED_TOL), sname
            err = float(torch.linalg.norm(r.x - system.x_true)
                        / torch.linalg.norm(system.x_true))
            say(f"phase 12 {label} {sname} precision=mixed: {ITERS} iters "
                f"in {t_solve:.2f} s, residual {float(r.residuals[-1]):.3e} "
                f"(float64 run {float(ref[-1]):.3e}, max|Δ| "
                f"{float((r.residuals - ref).abs().max()):.3e}) rel-error "
                f"{err:.3e} launches {got}; upcast twin history max|Δ| "
                f"{d_tw:.3e}, x max|Δ| {d_tx:.3e}; repeat bit-identical")
        del twin
        gc.collect()
        torch.cuda.empty_cache()

    def as_float32(facs):
        """Kernel factors with every tensor cast to float32."""
        A = facs.A
        A = (A._replace(vals=A.vals.float()) if blockops.is_sparse(A)
             else A.float())
        return ProjFactors(A=A, chol=facs.chol.float(), B=facs.B.float())

    def float32_solves(label, system, facs, mfacs, prm_of, uses, f64_runs):
        """APC and Cimmino in float32: the default solve on ``facs`` cast
        to float32 (the kernels' float32/float32 form) and the
        precision="mixed" one on ``mfacs`` (bf16 A and B) with its
        Cholesky factor in float32 (the bfloat16/float32 form), on the
        system in float32.  Launches of the run's form only, a
        bit-identical repeat, the float64 history within F32_TOL (the
        float32 form) or the reference's bf16 envelope (the bf16/float32
        form)."""
        sys32 = dataclasses.replace(
            system, A_blocks=system.A_blocks.float(),
            b_blocks=system.b_blocks.float(), x_true=system.x_true.float())
        runs = (("float32", "f32", f32_launches, F32_TOL,
                 solvers.ExecutionPlan(kernel=True,
                                       factors=as_float32(facs))),
                ("precision=mixed float32", "bf16_f32", mixed32_launches,
                 MIXED_TOL, solvers.ExecutionPlan(
                     kernel=True, precision="mixed",
                     factors=mfacs._replace(chol=mfacs.chol.float()))))
        for what, pair, counts, tol, plan32 in runs:
            for sname in ("apc", "cimmino"):
                s = solvers.get(sname)
                prm = prm_of[sname][0]
                ops.reset_launch_counts()
                t = time.time()
                r = s.solve(sys32, iters=ITERS, plan=plan32, **prm)
                torch.cuda.synchronize()
                t_solve = time.time() - t
                got = counts[(label, sname)] = form_launches(pair)
                assert got == {kn: ITERS if kn in uses[sname] else 0
                               for kn in bp.KERNELS}, (label, sname, got)
                assert r.x.dtype == torch.float32, r.x.dtype
                r2 = s.solve(sys32, iters=ITERS, plan=plan32, **prm)
                assert torch.equal(r2.residuals, r.residuals), (label, sname)
                assert torch.equal(r2.x, r.x), (label, sname)
                assert torch.isfinite(r.residuals).all(), (label, sname)
                ref = f64_runs[sname]
                d = float((r.residuals.double() - ref).abs().max())
                assert torch.allclose(r.residuals.double(), ref,
                                      **tol), (label, sname, d)
                say(f"phase 12 {label} {sname} {what}: "
                    f"{ITERS} iters in {t_solve:.2f} s, residual "
                    f"{float(r.residuals[-1]):.3e} (float64 run "
                    f"{float(ref[-1]):.3e}, max|Δ| {d:.3e}) launches {got}; "
                    f"repeat bit-identical")
        del sys32, runs
        gc.collect()
        torch.cuda.empty_cache()

    mf = solver.cast_factors(factors, "mixed")
    say(f"phase 12 dense factors: A {tuple(mf.A.shape)} {mf.A.dtype}, B "
        f"{tuple(mf.B.shape)} {mf.B.dtype}, chol {mf.chol.dtype}")
    mixed_solves("dense", sys_, mf, pinned, USES, f64_hist)
    float32_solves("dense", sys_, factors, mf, pinned, USES, f64_hist)
    many_vs_rows(solver, params, "12", False, sys_, mf, xs, Bm, USES,
                 precision="mixed")

    # 8. times --------------------------------------------------------------
    rows = {}
    F64, F32 = "float64/float64", "float32/float32"

    def bound(work, dtype):
        """(bound ms, "bytes" or "operations") of ``work`` = (bytes,
        operations in ``dtype``)."""
        nbytes, nops = work
        t_bytes = nbytes / bw * 1e3
        t_ops = nops / peak[dtype] * 1e3
        return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                     else "operations")

    def form_calls(kname, pr, calls):
        """The calls timed of ``kname`` in form ``pr``: the kernel
        (``ms``, the instance its launcher picks), its row-dot instance
        (``row_dot_ms``: a gather's in float64, a scatter's in every
        form), a scatter's ring instance (``ring_ms``,
        every form: gather_instance picks the row dot at k = 1 in float64
        and float32), its plain version (float64) and the library
        yardstick (where the matrix and the operands share a dtype)."""
        keep = {"ms"}
        if kname in bp.SCATTERS or (kname in bp.GATHERS and pr == F64):
            keep.add("row_dot_ms")
        if kname in bp.SCATTERS:
            keep.add("ring_ms")
        if pr == F64:
            keep.add("plain_ms")
        if not pr.startswith("bfloat16"):
            keep.add("library_ms")
        return {key: fn for key, fn in calls.items() if key in keep}

    def dfma_note(key, k, pr, f, b):
        """Beside a tensor-core form's time: the DFMA instance's before
        it (the ring; the float64 scatters' row dot at k = 1), against
        ``f``'s eager time, or its graph time for sparse_scatter."""
        kname = key.split()[0]
        sfx = {"bfloat16/float64": "bf16_f64", F64: "f64"}.get(pr)
        old = {"bfloat16/float64": DFMA_MIXED_MS,
               F64: DFMA_F64_MS}.get(pr, {}).get((key, k))
        if old is None or (kname, sfx) not in bp.MMA_FORMS:
            return ""
        was = ("row dot" if pr == F64 and k == 1 and kname in (
            "cimmino_scatter", "sparse_scatter") else "ring")
        ms = f["graph_ms"] if kname == "sparse_scatter" else f["ms"]
        return (f"; tensor cores (mma.sync f64), the DFMA {was} before them "
                f"{old:.4f} ms ({b / old:.1%} of the bound), {old / ms:.2f}x")

    def time_kernel(phase, kname, k, shape, forms, library, key=None,
                    captured=False):
        """CUDA-event medians, in turns, of a kernel in each of its forms
        (``forms``: form label -> (calls, work, compute dtype), the calls
        those of form_calls), each beside its bound from its work =
        (bytes, operations); kept in ``rows[(key or kname, k)]`` (the
        float64 form's numbers at the top, every form's under "forms") and
        printed, a line a form.  ``captured``: the kernel and the library
        call also as 10 calls replayed from a CUDA graph (``graph_ms``,
        ``graph_library_ms``: the device's time, which the launcher's host
        work exceeds at the sparse shapes' 0.05-0.1 ms)."""
        timed = {(pr, name): fn for pr, (calls, _, _) in forms.items()
                 for name, fn in form_calls(kname, pr, calls).items()}
        t = medians_ms(timed)
        if captured:
            t.update({(pr, f"graph_{name}"): v / 10 for (pr, name), v in
                      medians_ms({key_: graphed(timed[key_]) for key_ in timed
                                  if key_[1] in ("ms", "library_ms")},
                                 batch=1).items()})
        r = {"forms": {}}
        for pr, (_, work, dt) in forms.items():
            f = {name: v for (fpr, name), v in t.items() if fpr == pr}
            f["bound_ms"], f["bound_by"] = bound(work, dt)
            r["forms"][pr] = f
            b = f["bound_ms"]
            say(f"phase {phase} {kname} k={k} {shape} {pr}: "
                f"{f['ms']:.4f} ms (bound {b:.4f} ms by {f['bound_by']}, "
                f"{b / f['ms']:.1%} of it)"
                + "".join(f", {inst} instance {f[key]:.4f} ms "
                          f"({b / f[key]:.1%})"
                          for inst, key in (("ring", "ring_ms"),
                                            ("row-dot", "row_dot_ms"))
                          if key in f)
                + (f", plain {f['plain_ms']:.4f} ms" if "plain_ms" in f
                   else "")
                + (f", {library} {f['library_ms']:.4f} ms"
                   if "library_ms" in f else ", library none")
                + (f"; in a 10-call CUDA graph {f['graph_ms']:.4f} ms "
                   f"({b / f['graph_ms']:.1%})" if "graph_ms" in f else "")
                + (f", the library {f['graph_library_ms']:.4f} ms"
                   if "graph_library_ms" in f else "")
                + dfma_note(key or kname, k, pr, f, b))
        r.update(r["forms"][F64])
        rows[(key or kname, k)] = r

    def pair_bounds(k, uses):
        """The bounds of an iteration's two kernels (rows keys) at k,
        summed: the bf16/float64 form's and the float64 form's, ms."""
        return (sum(rows[(kn, k)]["forms"]["bfloat16/float64"]["bound_ms"]
                    for kn in uses),
                sum(rows[(kn, k)]["bound_ms"] for kn in uses))

    b = sys_.b_blocks
    nu = pinned["cimmino"][0]["nu"]
    cim = solvers.get("cimmino")
    A, B = factors.A, factors.B
    A16, B16 = mf.A, mf.B
    A32, B32 = A.float(), B.float()
    say(f"phase 8 library yardstick of the bf16-stored forms: {NO_LIBRARY}")
    clocks("phase 8 start")
    for k in (1, K_MANY):
        rng = np.random.default_rng(3 + k)
        X = torch.as_tensor(rng.standard_normal((k, m, n)), device="cuda")
        X3 = X.transpose(0, 1)                       # (m, k, n) view
        Xb = torch.as_tensor(rng.standard_normal((k, n)), device="cuda")
        U = bp.apc_gather(A, X3, Xb)
        V = (b.expand(k, m, p).transpose(0, 1)
             - bp.cimmino_gather(A, Xb))             # (m, k, p)
        D = Xb - X3
        X3f, Xbf, Uf, Vf, Df = (t.float() for t in (X3, Xb, U, V, D))
        mkn, mkp, kn_, mpn = m * k * n, m * k * p, k * n, m * p * n

        def dense_work(ms, xs):
            """(bytes, ops) of each kernel with its matrix at ``ms`` bytes
            an element and the rest at ``xs``: each input read once, each
            output written once."""
            return {
                "apc_gather": (ms * mpn + xs * (mkn + kn_ + mkp),
                               2 * m * k * p * n + mkn),
                "apc_scatter": (ms * mpn + xs * (2 * mkn + kn_ + mkp),
                                2 * m * k * p * n + 4 * mkn),
                "cimmino_gather": (ms * mpn + xs * (kn_ + mkp),
                                   2 * m * k * p * n),
                "cimmino_scatter": (ms * mpn + xs * (mkp + mkn),
                                    2 * m * k * p * n),
            }

        def dense_calls(A_, B_, X_, Xb_, U_, V_, D_):
            """Every call form_calls may time, of each dense kernel, on one
            form's operands."""
            return {
                "apc_gather": dict(
                    ms=lambda: bp.apc_gather(A_, X_, Xb_),
                    row_dot_ms=lambda: bp.apc_gather(A_, X_, Xb_,
                                                     _instance="row_dot"),
                    plain_ms=lambda: ops.apc_gather_ref(A_, X_, Xb_),
                    library_ms=lambda: torch.matmul(D_, A_.transpose(1, 2))),
                "apc_scatter": dict(
                    ms=lambda: bp.apc_scatter(B_, X_, Xb_, U_, 0.9),
                    ring_ms=lambda: bp.apc_scatter(B_, X_, Xb_, U_, 0.9,
                                                   _instance="ring"),
                    row_dot_ms=lambda: bp.apc_scatter(
                        B_, X_, Xb_, U_, 0.9, _instance="row_dot"),
                    plain_ms=lambda: ops.apc_scatter_ref(B_, X_, Xb_, U_,
                                                         0.9),
                    library_ms=lambda: torch.matmul(U_, B_.transpose(1, 2))),
                "cimmino_gather": dict(
                    ms=lambda: bp.cimmino_gather(A_, Xb_),
                    row_dot_ms=lambda: bp.cimmino_gather(
                        A_, Xb_, _instance="row_dot"),
                    plain_ms=lambda: ops.cimmino_gather_ref(A_, Xb_),
                    library_ms=lambda: torch.matmul(Xb_,
                                                    A_.transpose(1, 2))),
                "cimmino_scatter": dict(
                    ms=lambda: bp.cimmino_scatter(B_, V_),
                    ring_ms=lambda: bp.cimmino_scatter(
                        B_, V_, _instance="ring"),
                    row_dot_ms=lambda: bp.cimmino_scatter(
                        B_, V_, _instance="row_dot"),
                    plain_ms=lambda: ops.cimmino_scatter_ref(B_, V_),
                    library_ms=lambda: torch.matmul(V_, B_.transpose(1, 2))),
            }
        forms = {
            F64: (dense_calls(A, B, X3, Xb, U, V, D), dense_work(8, 8),
                  torch.float64),
            F32: (dense_calls(A32, B32, X3f, Xbf, Uf, Vf, Df),
                  dense_work(4, 4), torch.float32),
            "bfloat16/float64": (dense_calls(A16, B16, X3, Xb, U, V, D),
                                 dense_work(2, 8), torch.float64),
            "bfloat16/float32": (dense_calls(A16, B16, X3f, Xbf, Uf, Vf, Df),
                                 dense_work(2, 4), torch.float32)}
        # the ring is the instance the main path's shapes take, in every
        # form, but for the scatters' fixed rule: the row dot at k = 1
        # with a float64 or float32 matrix outside bp.MMA_FORMS
        for A_, B_, X_, Xb_, U_, V_ in ((A, B, X3, Xb, U, V),
                                        (A32, B32, X3f, Xbf, Uf, Vf),
                                        (A16, B16, X3, Xb, U, V),
                                        (A16, B16, X3f, Xbf, Uf, Vf)):
            assert bp.gather_instance(A_, X_, Xb_) == "ring"
            assert bp.gather_instance(A_, Xb_) == "ring"
            for kn, S_ in (("apc_scatter", U_), ("cimmino_scatter", V_)):
                mma = (kn, bp.PAIRS[(B_.dtype, S_.dtype)]) in bp.MMA_FORMS
                assert bp.gather_instance(B_, S_, scatter=kn) == (
                    "row_dot" if k == 1 and B_.dtype != BF16 and not mma
                    else "ring")
        if k == 1:
            st = APCState(x=X[0], xbar=Xb[0], t=0)
            cst = CimminoState(xbar=Xb[0], t=0)
            bb = b
        else:
            st = APCState(x=X, xbar=Xb, t=0)
            cst = CimminoState(xbar=Xb, t=0)
            bb = b.expand(k, m, p)
        its = medians_ms({
            "APC": lambda: solver.step_many_residual(factors, bb, st,
                                                     params),
            "Cimmino": lambda: cim.step_many_residual(factors, bb, cst,
                                                      {"nu": nu}),
            "APC mixed": lambda: solver.step_many_residual(mf, bb, st,
                                                           params),
            "Cimmino mixed": lambda: cim.step_many_residual(mf, bb, cst,
                                                            {"nu": nu})})
        t_it, t_cit = its["APC"], its["Cimmino"]
        steps = {
            "APC": lambda: solver.step_many_residual(factors, bb, st, params),
            "Cimmino": lambda: cim.step_many_residual(factors, bb, cst,
                                                      {"nu": nu}),
            "APC mixed": lambda: solver.step_many_residual(mf, bb, st,
                                                           params),
            "Cimmino mixed": lambda: cim.step_many_residual(mf, bb, cst,
                                                            {"nu": nu})}
        g10 = medians_ms({meth: graphed(fn) for meth, fn in steps.items()},
                         batch=1)
        say(f"phase 8 iteration k={k} captured: " + "; ".join(
            f"{meth} {g10[meth] / 10:.4f} ms per step in a 10-step CUDA "
            f"graph (eager {its[meth]:.4f})" for meth in steps)
            + f" [{card}]")
        for kname in USES["apc"] + USES["cimmino"]:
            time_kernel(8, kname, k, f"m={m} p={p} n={n}",
                        {pr: (calls[kname], work[kname], dt)
                         for pr, (calls, work, dt) in forms.items()},
                        "torch.matmul")
        say(f"phase 8 iteration k={k}: APC {t_it:.4f} ms per step "
            f"(gather + scatter + master update + residual); Cimmino "
            f"{t_cit:.4f} ms per step (gather + v = b − u + scatter + "
            f"worker sum + master update + residual)")
        say(f"phase 8 iteration k={k} precision=mixed: " + "; ".join(
            f"{meth} {its[meth + ' mixed']:.4f} ms per step (float64 "
            f"{its[meth]:.4f}; bound of its two kernels bf16/float64 "
            "{:.4f} ms, float64 {:.4f} ms)".format(
                *pair_bounds(k, USES[meth.lower()]))
            for meth in ("APC", "Cimmino")))
        del U, V, D, X3f, Xbf, Uf, Vf, Df, forms
    clocks("phase 8 end")

    # 13. compile-once execution, dense half ---------------------------------
    dense_facs = {"default": factors, "mixed": mf}
    captured_vs_eager("dense", sys_, dense_facs, pinned, USES, Bm)
    dgd_vs_eager("dense", sys_, pinned["dgd"][0], Bm)
    aplan = solvers.ExecutionPlan(kernel=True, factors=factors)
    a_bytes = factors.A.numel() * factors.A.element_size()
    for k in (1, K_MANY):
        peaks, pools = {}, {}
        for how in ("eager", "captured"):
            def run():
                with (executor.disable_capture() if how == "eager"
                      else contextlib.nullcontext()):
                    solve_k(solver, sys_, k, aplan, pinned["apc"][0], Bm)
            peaks[how], pools[how] = memory_of(run)
        say(f"phase 13 dense apc k={k} memory: peak above the resident "
            f"{torch.cuda.memory_allocated() / 1e9:.3f} GB: eager "
            f"{peaks['eager'] / 1e9:.4f} GB, captured "
            f"{peaks['captured'] / 1e9:.4f} GB (max_memory_allocated); "
            f"the 16-step graph's pool {pools['captured'][0][0] / 1e6:.1f} "
            f"MB (memory_reserved across its capture; A and B "
            f"{a_bytes / 1e9:.3f} GB each), its capture "
            f"{pools['captured'][0][1]:.2f} ms on the host")
        # the pool holds a few steps' intermediates, never A or B
        assert pools["eager"] == [] and len(pools["captured"]) == 1
        assert pools["captured"][0][0] < a_bytes // 16, pools
    solve_times("dense", sys_, dense_facs, pinned, ("apc",), Bm)

    main_launches = {kn: (launches if kn in USES["apc"] else cim_launches)[kn]
                     for kn in USES["apc"] + USES["cimmino"]}
    # the main path's system and its kernel factors stay, the dense system
    # of phases 14-18
    dsys, dfac = sys_, factors
    del sys_, factors, mf, res, res_u, res2, A, B, A16, B16, A32, B32, X, \
        X3, Xb
    gc.collect()
    torch.cuda.empty_cache()

    # 9. the sparse path at full size -------------------------------------
    t = time.time()
    sp = linsys.banded_system(**SPARSE, seed=0, device="cuda")
    torch.cuda.synchronize()
    m, p, n, w = sp.m, sp.p, sp.n, sp.cols.shape[1]
    say(f"phase 9 data: banded_system n={n} m={m} bandwidth="
        f"{SPARSE['bandwidth']} float64: p={p} w={w}, generator "
        f"{time.time() - t:.2f} s")
    t = time.time()
    mu, half = banded_mu(spectral, sp)
    torch.cuda.synchronize()
    sp_pinned = sparse_pinned(spectral, mu, m)
    say(f"phase 9 spectrum: mu(X) [{mu[0]:.6e}, {mu[1]:.6e}] in "
        f"{time.time() - t:.2f} s (banded_mu: one eigvalsh of {half}^2, "
        f"where X's own is {n}^2, MAGMA's past 32767, 77-92 s alone; the "
        f"identity held to x_matrix + eigvalsh in phase 14); rho "
        + " ".join(f"{k} {v[1]:.6f}" for k, v in sp_pinned.items()))
    dn = sp.densified()
    t = time.time()
    # the sparse and densified factorizations, timed against each other
    fs = solver.kernel_factors(
        solver.prepare(sp.A_op, {}))  # repro: allow[R003]
    fd = solver.kernel_factors(
        solver.prepare(dn.A_op, {}))  # repro: allow[R003]
    torch.cuda.synchronize()
    say(f"phase 9 factors: sparse (vals, Bvals {tuple(fs.B.shape)}) and "
        f"densified (B {tuple(fd.B.shape)}) in {time.time() - t:.2f} s")
    sparse_launches, sp_hist = {}, {}
    for sname in ("apc", "consensus", "cimmino"):
        s = solvers.get(sname)
        prm = sp_pinned[sname][0]
        ops.reset_launch_counts()
        t = time.time()
        r = s.solve(sp, iters=ITERS, plan=kplan, **prm)
        torch.cuda.synchronize()
        t_solve = time.time() - t
        got = sparse_launches[sname] = form_launches("f64")
        assert got == {kn: ITERS if kn in SPARSE_USES[sname] else 0
                       for kn in bp.KERNELS}, (sname, got)
        sp_hist[sname] = r.residuals
        r_u = s.solve(sp, iters=ITERS, plan=solvers.ExecutionPlan(factors=fs),
                      **prm)
        dres = float((r.residuals - r_u.residuals).abs().max())
        assert torch.allclose(r.residuals, r_u.residuals, rtol=1e-6,
                              atol=1e-12), (sname, dres)
        assert torch.allclose(r.errors, r_u.errors, rtol=1e-6, atol=1e-12)
        r_d = s.solve(dn, iters=ITERS, plan=solvers.ExecutionPlan(
            kernel=True, factors=fd), **prm)
        dx = float((r.x - r_d.x).abs().max())
        # tests/test_modes.py::test_sparse_matches_densified
        assert torch.allclose(r.x, r_d.x, rtol=1e-8, atol=1e-10), (sname, dx)
        r2 = s.solve(sp, iters=ITERS, plan=kplan, **prm)
        assert torch.equal(r2.residuals, r.residuals), sname
        assert torch.equal(r2.x, r.x), sname
        assert torch.isfinite(r.residuals).all()
        assert float(r.residuals[-1]) < float(r.residuals[0]), sname
        err = float(torch.linalg.norm(r.x - sp.x_true)
                    / torch.linalg.norm(sp.x_true))
        say(f"phase 9 {sname} sparse solve kernel=True: {ITERS} iters in "
            f"{t_solve:.2f} s (prepare included), residual "
            f"{float(r.residuals[-1]):.3e} rel-error {err:.3e} iters_to_tol "
            f"{r.iters_to_tol} launches {got}; vs unfused sparse history "
            f"max|Δ| {dres:.3e}; vs densified dense-kernel x max|Δ| "
            f"{dx:.3e}; repeat bit-identical")
        if sname == "apc":
            assert err <= 1e-8, err
    xs, Bm = consistent_rhs(sp, 4)
    for sname in ("apc", "cimmino"):
        many_vs_rows(solvers.get(sname), sp_pinned[sname][0], "9", False, sp,
                     fs, xs, Bm, SPARSE_USES)
    del r, r_u, r_d, r2, xs, Bm

    # 12. precision="mixed", sparse half ------------------------------------
    msf = solver.cast_factors(fs, "mixed")
    say(f"phase 12 sparse factors: vals {tuple(msf.A.vals.shape)} "
        f"{msf.A.vals.dtype}, Bvals {tuple(msf.B.shape)} {msf.B.dtype}")
    mixed_solves("sparse", sp, msf, sp_pinned, SPARSE_USES, sp_hist)
    float32_solves("sparse", sp, fs, msf, sp_pinned, SPARSE_USES, sp_hist)

    # 10. least squares -----------------------------------------------------
    ls_cli = ["--problem", "tall_noisy", "--workers", "4", "--iters", "300"]
    for method, extra in (("cimmino", ["--use-kernel"]), ("dgd", [])):
        ops.reset_launch_counts()
        rc = cli.main(ls_cli + ["--method", method] + extra)
        assert rc == 0, rc
        got = ops.launch_counts()
        assert all((got[kn] > 0) == (kn in USES.get(method, ()) and bool(extra))
                   for kn in bp.KERNELS), (method, got)
        say(f"phase 10 cli {' '.join(ls_cli)} --method {method} "
            f"{' '.join(extra)}: rc {rc} launches {got}")
    t = time.time()
    ls = linsys.tall_gaussian(**LS_MID, device="cuda")
    say(f"phase 10 data: tall_gaussian {LS_MID} ({ls.mode}) in "
        f"{time.time() - t:.2f} s")
    for sname, plan in (("cimmino", kplan), ("dgd", solvers.ExecutionPlan())):
        s = solvers.get(sname)
        prm, rho = s.analyze(ls)
        t = time.time()
        ref = s.ls_reference(ls)
        t_ref = time.time() - t
        ops.reset_launch_counts()
        t = time.time()
        r = s.solve(ls, iters=LS_ITERS, plan=plan, **prm)
        torch.cuda.synchronize()
        t_solve = time.time() - t
        got = ops.launch_counts()
        assert got == {kn: LS_ITERS if plan.kernel and kn in USES[sname]
                       else 0 for kn in bp.KERNELS}, (sname, got)
        e = float(torch.linalg.norm(r.x - ref) / torch.linalg.norm(ref))
        assert e <= 1e-6, (sname, e)
        assert float(r.residuals[-1]) < 1e-8, sname
        say(f"phase 10 {sname} least squares "
            f"{'kernel' if plan.kernel else 'unfused'}: {LS_ITERS} iters in "
            f"{t_solve:.2f} s, optimality residual "
            f"{float(r.residuals[-1]):.3e}, iters_to_tol {r.iters_to_tol}, "
            f"rel-error to ls_reference {e:.3e} (ls_reference "
            f"{t_ref:.2f} s on the host), rho {rho:.6f}, launches {got}")
    del ls, r
    sp_cli = ["--problem", "banded", "--workers", "4", "--iters", "200",
              "--method", "apc", "--use-kernel"]
    ops.reset_launch_counts()
    rc = cli.main(sp_cli)
    assert rc == 0, rc
    got = ops.launch_counts()
    assert all((got[kn] > 0) == (kn in SPARSE_USES["apc"])
               for kn in bp.KERNELS), got
    say(f"phase 10 cli {' '.join(sp_cli)}: rc {rc} launches {got}")

    # 11. sparse times ------------------------------------------------------
    vals, cols, Bv = fs.A.vals, fs.A.cols, fs.B
    vals16, Bv16 = msf.A.vals, msf.B
    vals32, Bv32 = vals.float(), Bv.float()
    b = sp.b_blocks
    prm_apc, prm_cim = sp_pinned["apc"][0], sp_pinned["cimmino"][0]
    clocks("phase 11 start")
    for k in (1, K_MANY):
        rng = np.random.default_rng(7 + k)
        X = torch.as_tensor(rng.standard_normal((k, m, n)), device="cuda")
        X3 = X.transpose(0, 1)                       # (m, k, n) view
        Xb = torch.as_tensor(rng.standard_normal((k, n)), device="cuda")
        idx = cols[:, None, :].expand(m, k, w)
        U = bp.sparse_gather(vals, cols, X3, Xb)
        V = (b.expand(k, m, p).transpose(0, 1)
             - bp.sparse_cimmino_gather(vals, cols, Xb)).contiguous()
        Y0 = X3 + 0.9 * (Xb - X3)
        R0 = torch.zeros_like(Y0)
        # the library yardstick's operands, gathered beforehand
        Ds = torch.take_along_dim(Xb - X3, idx, dim=-1)
        Xs = torch.take_along_dim(Xb.expand(m, k, n), idx, dim=-1)
        mkw, mkp, mwp = m * k * w, m * k * p, m * w * p
        flops = 2 * m * k * p * w
        X3f, Xbf, Uf, Vf, Y0f, R0f, Dsf, Xsf = (
            t.float() for t in (X3, Xb, U, V, Y0, R0, Ds, Xs))

        def sparse_work(ms, xs):
            """(bytes, ops) with vals/Bvals at ``ms`` bytes an element and
            X, X̄, U, Y at ``xs``: each input read once, each output once;
            the support columns of X/X̄ are what the gathers read, cols is
            int64."""
            return {
                "sparse_gather": (ms * mwp + 8 * m * w
                                  + xs * (2 * mkw + mkp), flops + mkw),
                "sparse_cimmino_gather": (ms * mwp + 8 * m * w
                                          + xs * (mkw + mkp), flops),
                "sparse_scatter": (ms * mwp + 8 * m * w
                                   + xs * (mkp + 3 * mkw), flops + 4 * mkw),
                "sparse_scatter cimmino": (ms * mwp + 8 * m * w
                                           + xs * (mkp + mkw), flops),
            }

        def sparse_calls(vals_, Bv_, X_, Xb_, U_, V_, Y0_, R0_, Ds_, Xs_):
            """Every call form_calls may time, of each sparse kernel (and
            the Cimmino form of sparse_scatter), on one form's
            operands."""
            return {
                "sparse_gather": dict(
                    ms=lambda: bp.sparse_gather(vals_, cols, X_, Xb_),
                    row_dot_ms=lambda: bp.sparse_gather(
                        vals_, cols, X_, Xb_, _instance="row_dot"),
                    plain_ms=lambda: ops.sparse_gather_ref(vals_, cols, X_,
                                                           Xb_),
                    library_ms=lambda: torch.bmm(Ds_,
                                                 vals_.transpose(1, 2))),
                "sparse_cimmino_gather": dict(
                    ms=lambda: bp.sparse_cimmino_gather(vals_, cols, Xb_),
                    row_dot_ms=lambda: bp.sparse_cimmino_gather(
                        vals_, cols, Xb_, _instance="row_dot"),
                    plain_ms=lambda: ops.sparse_cimmino_gather_ref(
                        vals_, cols, Xb_),
                    library_ms=lambda: torch.bmm(Xs_,
                                                 vals_.transpose(1, 2))),
                "sparse_scatter": dict(
                    ms=lambda: bp.sparse_scatter(Bv_, cols, U_, Y0_, X=X_,
                                                 Xbar=Xb_, gamma=0.9),
                    ring_ms=lambda: bp.sparse_scatter(
                        Bv_, cols, U_, Y0_, X=X_, Xbar=Xb_, gamma=0.9,
                        _instance="ring"),
                    row_dot_ms=lambda: bp.sparse_scatter(
                        Bv_, cols, U_, Y0_, X=X_, Xbar=Xb_, gamma=0.9,
                        _instance="row_dot"),
                    plain_ms=lambda: ops.sparse_scatter_ref(
                        Bv_, cols, U_, Y0_, X_, Xb_, 0.9),
                    library_ms=lambda: torch.bmm(U_, Bv_.transpose(1, 2))),
                "sparse_scatter cimmino": dict(
                    ms=lambda: bp.sparse_scatter(Bv_, cols, V_, R0_),
                    ring_ms=lambda: bp.sparse_scatter(
                        Bv_, cols, V_, R0_, _instance="ring"),
                    row_dot_ms=lambda: bp.sparse_scatter(
                        Bv_, cols, V_, R0_, _instance="row_dot"),
                    plain_ms=lambda: ops.sparse_scatter_ref(Bv_, cols, V_,
                                                            R0_),
                    library_ms=lambda: torch.bmm(V_, Bv_.transpose(1, 2))),
            }
        forms = {
            F64: (sparse_calls(vals, Bv, X3, Xb, U, V, Y0, R0, Ds, Xs),
                  sparse_work(8, 8), torch.float64),
            F32: (sparse_calls(vals32, Bv32, X3f, Xbf, Uf, Vf, Y0f, R0f,
                               Dsf, Xsf), sparse_work(4, 4), torch.float32),
            "bfloat16/float64": (
                sparse_calls(vals16, Bv16, X3, Xb, U, V, Y0, R0, Ds, Xs),
                sparse_work(2, 8), torch.float64),
            "bfloat16/float32": (
                sparse_calls(vals16, Bv16, X3f, Xbf, Uf, Vf, Y0f, R0f, Dsf,
                             Xsf), sparse_work(2, 4), torch.float32)}
        # the ring is the instance the sparse path's shapes take, in every
        # form and at every k: both sparse gathers (vals alone decides)
        # and both forms of the scatter (Bvals and U)
        for vals_, Bv_, U_ in ((vals, Bv, U), (vals32, Bv32, Uf),
                               (vals16, Bv16, U), (vals16, Bv16, Uf)):
            assert bp.gather_instance(vals_) == "ring"
            for U2 in (U_, V.to(U_.dtype)):
                assert bp.gather_instance(
                    Bv_, U2, scatter="sparse_scatter") == "ring"
        for key in SPARSE_USES["apc"] + ("sparse_cimmino_gather",
                                         "sparse_scatter cimmino"):
            kname, _, form = key.partition(" ")
            time_kernel(11, kname, k, f"m={m} p={p} w={w} n={n}"
                        + (f" ({form.capitalize()} form)" if form else ""),
                        {pr: (calls[key], work[key], dt)
                         for pr, (calls, work, dt) in forms.items()},
                        "torch.bmm (operands gathered beforehand, "
                        "gather/scatter excluded)", key=key, captured=True)
        if k == 1:      # what a single call between two events also times
            one = medians_ms({"ms": forms[F64][0]["sparse_gather"]["ms"]},
                             batch=1)["ms"]
            say(f"phase 11 timing method: sparse_gather k=1, one call "
                f"between two events {one:.4f} ms, in runs of 10 calls "
                f"{rows[('sparse_gather', 1)]['ms']:.4f} ms a call")
        if k == 1:
            st = APCState(x=X[0], xbar=Xb[0], t=0)
            cst = CimminoState(xbar=Xb[0], t=0)
            bb = b
        else:
            st = APCState(x=X, xbar=Xb, t=0)
            cst = CimminoState(xbar=Xb, t=0)
            bb = b.expand(k, m, p)
        its = medians_ms({
            (meth, label): (
                (lambda f=f: solver.step_many_residual(f, bb, st, prm_apc))
                if meth == "APC" else
                (lambda f=f: cim.step_many_residual(f, bb, cst, prm_cim)))
            for label, f in (("sparse", fs), ("densified", fd),
                             ("mixed", msf))
            for meth in ("APC", "Cimmino")})
        g10 = medians_ms({key: graphed(fn) for key, fn in (
            ((meth, label), (
                (lambda f=f: solver.step_many_residual(f, bb, st, prm_apc))
                if meth == "APC" else
                (lambda f=f: cim.step_many_residual(f, bb, cst, prm_cim))))
            for label, f in (("sparse", fs), ("mixed", msf))
            for meth in ("APC", "Cimmino"))}, batch=1)
        say(f"phase 11 iteration k={k} captured: " + "; ".join(
            f"{meth} {label} {ms / 10:.4f} ms per step in a 10-step CUDA "
            f"graph (eager {its[(meth, label)]:.4f})"
            for (meth, label), ms in g10.items()) + f" [{card}]")
        for meth, uses in (("APC", SPARSE_USES["apc"]),
                           ("Cimmino", ("sparse_cimmino_gather",
                                        "sparse_scatter cimmino"))):
            sp_ms, dn_ms = its[(meth, "sparse")], its[(meth, "densified")]
            say(f"phase 11 iteration k={k} {meth}: sparse {sp_ms:.4f} ms, "
                f"densified {dn_ms:.4f} ms per step (step_residual), "
                f"ratio {dn_ms / sp_ms:.2f} (n/w = {n / w:.2f})")
            b16, b64 = pair_bounds(k, uses)
            say(f"phase 11 iteration k={k} {meth} precision=mixed: sparse "
                f"{its[(meth, 'mixed')]:.4f} ms per step (float64 "
                f"{sp_ms:.4f}; bound of its two kernels bf16/float64 "
                f"{b16:.4f} ms, float64 {b64:.4f} ms)")
        del U, V, Y0, R0, Ds, Xs, X3f, Xbf, Uf, Vf, Y0f, R0f, Dsf, Xsf, forms
    clocks("phase 11 end")

    # 13. compile-once execution, sparse half --------------------------------
    xs, Bm = consistent_rhs(sp, 4)
    sparse_facs = {"default": fs, "mixed": msf}
    captured_vs_eager("sparse", sp, sparse_facs, sp_pinned, SPARSE_USES, Bm)
    # a safe DGD step: λmax(AᵀA) <= ‖A‖_F²
    dgd_vs_eager("sparse", sp, {"alpha": 1.0 / float(
        torch.sum(fs.A.vals * fs.A.vals))}, Bm)
    med = solve_times("sparse", sp, sparse_facs, sp_pinned,
                      ("apc", "cimmino"), Bm)
    for precision, facs in sparse_facs.items():
        plan = solvers.ExecutionPlan(kernel=True, precision=precision,
                                     factors=facs)
        _, pools = memory_of(lambda: solver.solve(
            sp, iters=ITERS, plan=plan, **sp_pinned["apc"][0]))
        say(f"phase 13 sparse apc k=1 {precision}: the 16-step graph's "
            f"capture {pools[0][1]:.2f} ms on the host, its pool "
            f"{pools[0][0] / 1e6:.1f} MB [{card}]")
        for how in ("eager", "captured"):
            def run():
                with (executor.disable_capture() if how == "eager"
                      else contextlib.nullcontext()):
                    solver.solve(sp, iters=ITERS, plan=plan,
                                 **sp_pinned["apc"][0])
            idle_share(f"sparse apc k=1 {precision} {how}", run,
                       med[("apc", precision, 1, how)] * ITERS)
    # the serving executor: 3 batches of new right-hand sides, one system
    s, prm = solvers.get("apc"), sp_pinned["apc"][0]
    ex = executor.LocalExecutor(s, prm, ITERS, use_kernel=True)
    key = executor.executor_key(s, sp, prm, kplan, K_MANY, ITERS)
    batches = [consistent_rhs(sp, seed)[1].reshape(K_MANY, m, p)
               for seed in (5, 6, 7)]
    outs = []
    with tracecheck() as tc:
        _, ex_pools = memory_of(
            lambda: outs.append(ex.run(sp.A_op, fs, batches[0])))
    x1 = outs[0][1].clone()
    with tracecheck(steady_state=True):
        outs += [ex.run(sp.A_op, fs, Bb) for Bb in batches[1:]]
    torch.cuda.synchronize()
    assert (ex.builds, ex.captures, ex.cache_size()) == (1, 1, 1), (
        ex.builds, ex.captures)
    assert torch.equal(outs[0][1], x1)
    assert [e.fun for e in tc.traces()] == ["build apc.cold",
                                            "capture apc.cold"], tc.summary()
    worst, same = 0.0, True
    for Bb, (_, X, res) in zip(batches, outs):
        ref = s.solve_many(sp, Bb.reshape(K_MANY, -1), iters=ITERS,
                           plan=solvers.ExecutionPlan(kernel=True,
                                                      factors=fs), **prm)
        d = float(torch.linalg.norm(X - ref.x) / torch.linalg.norm(ref.x))
        worst = max(worst, d)
        same = same and torch.equal(X, ref.x) and torch.equal(
            res, ref.residuals)
        assert d <= 1e-12 and torch.allclose(res, ref.residuals, rtol=1e-9,
                                             atol=1e-14), d
    say(f"phase 13 executor apc k={K_MANY} sparse, 3 batches: builds "
        f"{ex.builds} captures {ex.captures} cache {ex.cache_size()}; "
        f"runs 2-3 quiet under tracecheck(steady_state=True); first x "
        f"intact after the third; vs solve_many x max rel {worst:.3e}, "
        f"bit-identical {same}; its graph's pool "
        f"{ex_pools[0][0] / 1e6:.1f} MB, its capture {ex_pools[0][1]:.2f} "
        f"ms; key {key}; first run: "
        + "; ".join(str(e) for e in tc.traces()))
    # serving's steady state: a replay of the executor's program against
    # solve_many of the same batch, eager and captured, in turns
    kfs = solvers.ExecutionPlan(kernel=True, factors=fs)
    served = {"executor replay": lambda: ex.run(sp.A_op, fs, batches[1]),
              "solve_many eager": lambda: s.solve_many(
                  sp, batches[1].reshape(K_MANY, -1), iters=ITERS,
                  plan=kfs, **prm),
              "solve_many captured": lambda: s.solve_many(
                  sp, batches[1].reshape(K_MANY, -1), iters=ITERS,
                  plan=kfs, **prm)}
    times = {how: [] for how in served}
    for _ in range(4):
        for how, run in served.items():
            torch.cuda.synchronize()
            t = time.perf_counter()
            with (executor.disable_capture() if how.endswith("eager")
                  else contextlib.nullcontext()):
                run()
            torch.cuda.synchronize()
            times[how].append((time.perf_counter() - t) / ITERS * 1e3)
    assert (ex.builds, ex.captures) == (1, 1)
    say(f"phase 13 executor apc k={K_MANY} sparse, a batch of {ITERS} "
        "iterations: " + "; ".join(
            f"{how} {float(np.median(v)):.4f} ms per iteration"
            for how, v in times.items())
        + f" (host clock to synchronize(), median of 4 in turns) [{card}]")
    del ex, outs, batches, xs, Bm

    # 14. serving: the factor store, the servers, the CLI -----------------
    # the dense system: the main path's, kept from phase 2 with its kernel
    # factors; the servers' sparse traffic (phases 14 and 17 (a)): the sparse
    # path's banded system cut in scale, with its own spectrum
    t = time.time()
    ssp = linsys.banded_system(**SERVE_SPARSE, seed=0, device="cuda")
    smu = spectral.mu_extremes(spectral.x_matrix(ssp))
    torch.cuda.synchronize()
    t_x = time.time() - t
    # phase 9's identity against X's own eigenvalues
    bmu = banded_mu(spectral, ssp)[0]
    dmu = max(abs(a - b) for a, b in zip(smu, bmu))
    assert dmu <= 1e-12, (smu, bmu)
    ssp_pinned = sparse_pinned(spectral, smu, ssp.m)
    # its kernels' k-chunks measured for the servers' k before their
    # batches, as phases 9-13 measured the sparse path's before phase 14
    # ("measure tiles" would otherwise ride in a server's first batch)
    wB = consistent(ssp, K_MANY, 13)[1]
    for sname, prec in (("apc", "mixed"), ("cimmino", "default")):
        solvers.get(sname).solve_many(
            ssp, wB, iters=1, plan=solvers.ExecutionPlan(
                kernel=True, precision=prec), **ssp_pinned[sname][0])
    say(f"phase 14 data: the servers' sparse system, banded_system "
        f"{SERVE_SPARSE} (the sparse path's cut in scale: a register hashes "
        f"a system's whole (m, p, n) A on the host) with its spectrum "
        f"(x_matrix + eigvalsh of {ssp.n}^2) in {t_x:.2f} s; banded_mu "
        f"within {dmu:.1e} of it (limit 1e-12); rho "
        + " ".join(f"{k} {v[1]:.6f}" for k, v in ssp_pinned.items()))
    serving_phase(card, form_launches, pinned["apc"][0], dsys, ssp,
                  ssp_pinned)

    # 15. the kernel ops layer: all-bf16, engine verdicts, k-chunks --------
    t15 = time.time()
    clocks("phase 15 start")
    dm, dp, dn = FULL["m"], FULL["N"] // FULL["m"], FULL["n"]
    shape = f"m={dm} p={dp} n={dn}"
    # (a) the all-bf16 form of every kernel at the dense main path's
    # shapes and the sparse path's; a scatter takes its gather's plain U
    # (bf16, as between the two passes), a Cimmino scatter a seeded V
    bf_launches = {}
    A16 = randn(151, dm, dp, dn, dtype=BF16)
    B16 = randn(152, dm, dn, dp, dtype=BF16)
    # phase 11's bf16-stored sparse factors (precision="mixed")
    scols = fs.A.cols
    sm, spp, sn, sw = sp.m, sp.p, sp.n, scols.shape[1]
    sshape = f"m={sm} p={spp} w={sw} n={sn}"
    f32 = torch.Tensor.float
    for k in (1, K_MANY):
        X16 = randn(153 + k, k, dm, dn, dtype=BF16).transpose(0, 1)
        Xb16 = randn(154 + k, k, dn, dtype=BF16)
        V16 = randn(155 + k, k, dm, dp, dtype=BF16).transpose(0, 1)
        U16 = ops.apc_gather_ref(A16, X16, Xb16)
        sX = randn(156 + k, k, sm, sn, dtype=BF16).transpose(0, 1)
        sXb = randn(157 + k, k, sn, dtype=BF16)
        sV = randn(158 + k, sm, k, spp, dtype=BF16)
        sU = ops.sparse_gather_ref(vals16, scols, sX, sXb)
        sY0 = ops._axpy(sX, sXb, 0.9)
        sR0 = torch.zeros_like(sY0)
        idx = scols[:, None, :].expand(sm, k, sw)
        # the library yardstick's operands, gathered beforehand
        sD = torch.take_along_dim(sXb - sX, idx, dim=-1)
        sXs = torch.take_along_dim(sXb.expand(sm, k, sn), idx, dim=-1)
        torch.cuda.synchronize()
        mkn, mkp, kn_, mpn = dm * k * dn, dm * k * dp, k * dn, dm * dp * dn
        flops = 2 * dm * k * dp * dn
        mkw, smkp, mwp = sm * k * sw, sm * k * spp, sm * sw * spp
        sflops, ci = 2 * sm * k * spp * sw, 8 * sm * sw
        # each spec: launch(instance) on a fresh output; the plain
        # version's result; the matrix and the operands the ring copies;
        # the same ring on the operands widened to float32 (its bf16/f32
        # entries), rounded to bf16: the all-bf16 ring's bits, but for
        # the APC scatters, which round otherwise; the timed calls;
        # (bytes, operations) of its work
        specs = {
            "apc_gather": dict(
                shape=shape, launch=lambda inst=None: bp.apc_gather(
                    A16, X16, Xb16, _instance=inst),
                want=U16, matrix=A16, copied=(X16, Xb16),
                wide=lambda: bp.apc_gather(A16, f32(X16), f32(Xb16),
                                           _instance="ring"),
                plain=lambda: ops.apc_gather_ref(A16, X16, Xb16),
                library=lambda D=Xb16 - X16: torch.matmul(
                    D, A16.transpose(1, 2)),
                work=(2 * (mpn + mkn + kn_ + mkp), flops + mkn)),
            "apc_scatter": dict(
                shape=shape, launch=lambda inst=None: bp.apc_scatter(
                    B16, X16, Xb16, U16, 0.9, _instance=inst),
                want=ops.apc_scatter_ref(B16, X16, Xb16, U16, 0.9),
                matrix=B16, copied=(U16,), wide=None,
                plain=lambda: ops.apc_scatter_ref(B16, X16, Xb16, U16, 0.9),
                library=lambda: torch.matmul(U16, B16.transpose(1, 2)),
                work=(2 * (mpn + 2 * mkn + kn_ + mkp), flops + 4 * mkn)),
            "cimmino_gather": dict(
                shape=shape, launch=lambda inst=None: bp.cimmino_gather(
                    A16, Xb16, _instance=inst),
                want=ops.cimmino_gather_ref(A16, Xb16), matrix=A16,
                copied=(Xb16,),
                wide=lambda: bp.cimmino_gather(A16, f32(Xb16),
                                               _instance="ring"),
                plain=lambda: ops.cimmino_gather_ref(A16, Xb16),
                library=lambda: torch.matmul(Xb16, A16.transpose(1, 2)),
                work=(2 * (mpn + kn_ + mkp), flops)),
            "cimmino_scatter": dict(
                shape=shape, launch=lambda inst=None: bp.cimmino_scatter(
                    B16, V16, _instance=inst),
                want=ops.cimmino_scatter_ref(B16, V16), matrix=B16,
                copied=(V16,),
                wide=lambda: bp.cimmino_scatter(B16, f32(V16),
                                                _instance="ring"),
                plain=lambda: ops.cimmino_scatter_ref(B16, V16),
                library=lambda: torch.matmul(V16, B16.transpose(1, 2)),
                work=(2 * (mpn + mkp + mkn), flops)),
            "sparse_gather": dict(
                shape=sshape, launch=lambda inst=None: bp.sparse_gather(
                    vals16, scols, sX, sXb, _instance=inst),
                want=sU, matrix=vals16, copied=(),
                wide=lambda: bp.sparse_gather(vals16, scols, f32(sX),
                                              f32(sXb), _instance="ring"),
                plain=lambda: ops.sparse_gather_ref(vals16, scols, sX, sXb),
                library=lambda: torch.bmm(sD, vals16.transpose(1, 2)),
                work=(2 * mwp + ci + 2 * (2 * mkw + smkp), sflops + mkw)),
            "sparse_cimmino_gather": dict(
                shape=sshape,
                launch=lambda inst=None: bp.sparse_cimmino_gather(
                    vals16, scols, sXb, _instance=inst),
                want=ops.sparse_cimmino_gather_ref(vals16, scols, sXb),
                matrix=vals16, copied=(),
                wide=lambda: bp.sparse_cimmino_gather(
                    vals16, scols, f32(sXb), _instance="ring"),
                plain=lambda: ops.sparse_cimmino_gather_ref(vals16, scols,
                                                            sXb),
                library=lambda: torch.bmm(sXs, vals16.transpose(1, 2)),
                work=(2 * mwp + ci + 2 * (mkw + smkp), sflops)),
            "sparse_scatter": dict(
                shape=sshape, launch=lambda inst=None: bp.sparse_scatter(
                    Bv16, scols, sU, sY0.clone(), X=sX, Xbar=sXb, gamma=0.9,
                    _instance=inst),
                want=ops.sparse_scatter_ref(Bv16, scols, sU, sY0, sX, sXb,
                                            0.9),
                matrix=Bv16, copied=(sU,), wide=None,
                timed=lambda inst=None: bp.sparse_scatter(
                    Bv16, scols, sU, sY0, X=sX, Xbar=sXb, gamma=0.9,
                    _instance=inst),
                plain=lambda: ops.sparse_scatter_ref(Bv16, scols, sU, sY0,
                                                     sX, sXb, 0.9),
                library=lambda: torch.bmm(sU, Bv16.transpose(1, 2)),
                work=(2 * mwp + ci + 2 * (smkp + 3 * mkw), sflops + 4 * mkw)),
            "sparse_scatter cimmino": dict(
                shape=sshape + " (Cimmino form)",
                launch=lambda inst=None: bp.sparse_scatter(
                    Bv16, scols, sV, sR0.clone(), _instance=inst),
                want=ops.sparse_scatter_ref(Bv16, scols, sV, sR0),
                matrix=Bv16, copied=(sV,),
                wide=None,
                timed=lambda inst=None: bp.sparse_scatter(
                    Bv16, scols, sV, sR0, _instance=inst),
                plain=lambda: ops.sparse_scatter_ref(Bv16, scols, sV, sR0),
                library=lambda: torch.bmm(sV, Bv16.transpose(1, 2)),
                work=(2 * mwp + ci + 2 * (smkp + mkw), sflops)),
        }
        timed = {}
        for key, sp_ in specs.items():
            kname = key.split()[0]
            scatter = kname in bp.SCATTERS
            fits = bp.gather_instance(sp_["matrix"], *sp_["copied"])
            default = bp.gather_instance(sp_["matrix"], *sp_["copied"],
                                         scatter=kname if scatter else None)
            insts = [i for i in bp.INSTANCES
                     if i == "row_dot" or fits == "ring"]
            outs = {i: sp_["launch"](i) for i in insts}
            torch.cuda.synchronize()
            errs = {i: rel_err(o, sp_["want"]) for i, o in outs.items()}
            for i, (e, _) in errs.items():
                assert outs[i].dtype == BF16 and e < BF16_TOL, (key, k, i, e)
            max_abs[(kname, BF)] = max(
                [max_abs.get((kname, BF), 0.0)]
                + [d for _, d in errs.values()])
            same = wide = None
            if "ring" in outs:
                # the dense scatters' row dot is the packed one, summing in
                # another order than the ring (phase 2); sparse_scatter's
                # two instances issue the same bf16 mmas
                same = torch.equal(outs["ring"], outs["row_dot"])
                assert same or (scatter and (kname, "bf16_bf16")
                                not in bp.BF16_MMA_FORMS), (key, k)
                if sp_["wide"] is not None:
                    wide = torch.equal(outs["ring"], sp_["wide"]().to(BF16))
                    assert wide, (key, k)
            say(f"phase 15 {kname} k={k} {sp_['shape']} {BF}: " + "; ".join(
                f"{i} {e:.3e} (max|Δ| {bf16_ulps(d, sp_['want']):.2f} ulps)"
                for i, (e, d) in errs.items())
                + f" (tol {BF16_TOL:.0e}); ring≡row_dot {same}; "
                f"ring≡bf16/f32 ring rounded {wide}; the launcher takes "
                f"the {default}")
            call = sp_.get("timed", sp_["launch"])
            timed.update({(key, "ms"): call,
                          (key, "row_dot_ms"): lambda f=call: f("row_dot"),
                          (key, "plain_ms"): sp_["plain"],
                          (key, "library_ms"): sp_["library"]})
            if scatter and fits == "ring":
                timed[(key, "ring_ms")] = lambda f=call: f("ring")
        t = medians_ms(timed)
        # the sparse kernels and their library call also as 10 calls
        # replayed from a CUDA graph: the device's time (phase 11)
        t.update({(key, f"graph_{name}"): v / 10 for (key, name), v in
                  medians_ms({key_: graphed(fn) for key_, fn in timed.items()
                              if key_[0].split()[0] in bp.GATHERS[2:]
                              + ("sparse_scatter",)
                              and key_[1] in ("ms", "library_ms")},
                             batch=1).items()})
        for key, sp_ in specs.items():
            kname = key.split()[0]
            f = {name: v for (kn, name), v in t.items() if kn == key}
            f["bound_ms"], f["bound_by"] = bound(sp_["work"], BF16)
            rows[(key, k)]["forms"][BF] = f
            b_ = f["bound_ms"]
            lib = ("torch.matmul" if kname in USES["apc"] + USES["cimmino"]
                   else "torch.bmm (operands gathered beforehand)")
            say(f"phase 15 {kname} k={k} {sp_['shape']} {BF}: "
                f"{f['ms']:.4f} ms (bound {b_:.4f} ms by {f['bound_by']}, "
                f"{b_ / f['ms']:.1%} of it), row-dot instance "
                f"{f['row_dot_ms']:.4f} ms"
                + (f", ring instance {f['ring_ms']:.4f} ms"
                   if "ring_ms" in f else "")
                + f", plain {f['plain_ms']:.4f} ms, {lib} bf16 "
                f"{f['library_ms']:.4f} ms"
                + (f"; in a 10-call CUDA graph {f['graph_ms']:.4f} ms "
                   f"({b_ / f['graph_ms']:.1%}), the library "
                   f"{f['graph_library_ms']:.4f} ms" if "graph_ms" in f
                   else "") + f" [{card}]")
        # the ops end to end, each launching once each kernel it uses
        # (k = 1: no batch axis)
        one = (lambda t, a: t.select(a, 0)) if k == 1 else (
            lambda t, a: t)
        Xe, Xbe, Ve = one(X16, 1), one(Xb16, 0), one(V16, 1)
        sXe, sXbe, sVe = one(sX, 1), one(sXb, 0), one(sV, 1)
        runs = {
            "block_projection": (
                "apc", lambda: ops.block_projection(A16, B16, Xe, Xbe, 0.9),
                lambda: ops.block_projection_ref(A16, B16, Xe, Xbe, 0.9)),
            "cimmino_update": (
                "cimmino", lambda: ops.cimmino_update(A16, B16, Ve, Xbe),
                lambda: ops.cimmino_update_ref(A16, B16, Ve, Xbe)),
            "sparse_proj_update": (
                "sparse apc", lambda: ops.sparse_proj_update(
                    vals16, scols, Bv16, sXe, sXbe, 0.9),
                lambda: ops.sparse_proj_update_ref(vals16, scols, Bv16,
                                                   sXe, sXbe, 0.9)),
            "sparse_cimmino_update": (
                "sparse cimmino", lambda: ops.sparse_cimmino_update(
                    vals16, scols, Bv16, sVe, sXbe),
                lambda: ops.sparse_cimmino_update_ref(vals16, scols, Bv16,
                                                      sVe, sXbe))}
        for op, (path, run, plain) in runs.items():
            uses = (SPARSE_USES if path.startswith("sparse") else USES)[
                path.split()[-1]]
            ops.reset_launch_counts()
            got_out = run()
            got = form_launches("bf16_bf16")
            assert got == {kn: 1 if kn in uses else 0
                           for kn in bp.KERNELS}, (op, got)
            if k == 1:
                bf_launches.update({kn: got[kn] for kn in uses})
            outs = got_out if isinstance(got_out, tuple) else (got_out,)
            wants = plain()
            wants = wants if isinstance(wants, tuple) else (wants,)
            errs = []
            for o, w_ in zip(outs, wants):
                e, _ = rel_err(o, w_)
                assert o.dtype == BF16 and o.shape == w_.shape and (
                    e < BF16_TOL), (op, e)
                errs.append(e)
            say(f"phase 15 ops.{op} k={k} "
                f"{sshape if path.startswith('sparse') else shape} {BF}: "
                f"vs plain " + ", ".join(f"{e:.3e}" for e in errs)
                + f" (tol {BF16_TOL:.0e}), launches {got}")
        del X16, Xb16, V16, U16, sX, sXb, sV, sU, sY0, sR0, sD, sXs
        del timed, specs, runs
    del A16, B16
    # (b) the measured engine verdicts, no pin, then solves under them, on
    # phase 14's dense system and factors
    sw = fs.A.vals.shape[2]
    where = {"apc": (dfac.A, dp, dn, None), "cimmino": (dfac.A, dp, dn, None),
             "apc_sparse": (fs.A.vals, sp.p, sp.n, sw),
             "cimmino_sparse": (fs.A.vals, sp.p, sp.n, sw)}
    verdicts = {}
    with env_var(ENGINE_ENV, None):
        for family, (M, fp_, fn_, fw) in where.items():
            for k in (1, K_MANY):
                t = time.time()
                v = verdicts[(family, k)] = ops.use_fused(
                    family, fp_, fn_, k, M.dtype, w=fw, device=M.device,
                    compute_dtype=torch.float64)
                times = ops.engine_times.get(ops.engine_key(
                    family, fp_, fn_, k, M.dtype, w=fw))
                say(f"phase 15 engine {family} k={k} p={fp_} n={fn_}"
                    + ("" if fw is None else f" w={fw}") + " float64: "
                    + ("not measured (the heuristic)" if times is None else
                       f"fused {times[0] * 1e3:.4f} ms, unfused "
                       f"{times[1] * 1e3:.4f} ms (best of 5, "
                       f"{ops._MEAS_WORKERS} workers; fused wins within "
                       f"{ops._ENGINE_MARGIN})")
                    + f" -> {'fused' if v else 'unfused'}, resolved in "
                    f"{time.time() - t:.2f} s [{card}]")
    for label, system, facs, prm_of, uses, fam in (
            ("dense", dsys, dfac, pinned, USES, ""),
            ("sparse", sp, fs, sp_pinned, SPARSE_USES, "_sparse")):
        _, Bk = consistent_rhs(system, 9)
        plan = solvers.ExecutionPlan(kernel=True, factors=facs)
        for sname in ("apc", "cimmino"):
            s, prm = solvers.get(sname), prm_of[sname][0]
            fused = verdicts[(sname + fam, K_MANY)]
            with env_var(ENGINE_ENV, None):
                ops.reset_launch_counts()
                r = s.solve_many(system, Bk, iters=ITERS, plan=plan, **prm)
                torch.cuda.synchronize()
                got = ops.launch_counts()
            assert got == {kn: ITERS if fused and kn in uses[sname] else 0
                           for kn in bp.KERNELS}, (label, sname, got)
            r_f = s.solve_many(system, Bk, iters=ITERS, plan=plan, **prm)
            d = float(((r.residuals - r_f.residuals).abs()
                       / r_f.residuals.abs()).max())
            assert torch.allclose(r.residuals, r_f.residuals, rtol=1e-6,
                                  atol=1e-12), (label, sname, d)
            say(f"phase 15 {label} {sname} solve_many k={K_MANY} no pin: "
                f"verdict {'fused' if fused else 'unfused'}, launches "
                f"{got}; history vs the pinned-fused one max rel "
                f"{d:.3e}")
    # (c) each k-chunk pin on a K_MANY gather and scatter of the main path
    X8 = randn(160, K_MANY, dm, dn).transpose(0, 1)
    Xb8 = randn(161, K_MANY, dn)
    U8 = ops.apc_gather_ref(dfac.A, X8, Xb8)
    Y8 = ops.apc_scatter_ref(dfac.B, X8, Xb8, U8, 0.9)
    outs = {}
    for kc in bp.KC_VALUES:
        with env_var(BK_ENV, str(kc)):
            outs[kc] = (ops.proj_gather(dfac.A, X8, Xb8),
                        ops.proj_scatter(dfac.B, X8, Xb8, U8, 0.9))
        torch.cuda.synchronize()
        for got, want in zip(outs[kc], (U8, Y8)):
            assert rel_err(got, want)[0] < TOL[torch.float64], kc
    with env_var(BK_ENV, "16"):     # divides k = 16, not instantiated
        try:
            ops.proj_gather(randn(162, 2, 8, 128), randn(163, 2, 16, 128),
                            randn(164, 16, 128))
            raise AssertionError("REPRO_KERNEL_BK=16 launched")
        except ValueError as e:
            refused = str(e)
    same = all(torch.equal(outs[kc][i], outs[1][i]) for kc in bp.KC_VALUES
               for i in (0, 1))
    kc_ms = medians_ms({(kn, kc): (
        (lambda kc=kc: bp.apc_gather(dfac.A, X8, Xb8, kc=kc))
        if kn == "apc_gather" else
        (lambda kc=kc: bp.apc_scatter(dfac.B, X8, Xb8, U8, 0.9, kc=kc)))
        for kn in USES["apc"] for kc in bp.KC_VALUES})
    measured = {key: v for key, v in ops.tile_cache().items()
                if key[:3] == (K_MANY, dp, dn)}
    say(f"phase 15 KC pins k={K_MANY} {shape} float64: each against the "
        f"plain version within {TOL[torch.float64]:.0e}; outputs bit-equal "
        f"across the pins {same}; " + "; ".join(
            f"KC={kc} apc_gather {kc_ms[('apc_gather', kc)]:.4f} ms "
            f"apc_scatter {kc_ms[('apc_scatter', kc)]:.4f} ms"
            for kc in bp.KC_VALUES)
        + f" (in turns); the tile cache at these shapes {measured}; a pin "
        f"of 16 refused: {refused} [{card}]")
    del X8, Xb8, U8, Y8, outs
    gc.collect()
    torch.cuda.empty_cache()
    clocks("phase 15 end")
    say(f"phase 15: {time.time() - t15:.1f} s")

    # 16. the mesh backend ------------------------------------------------
    mesh_launches = mesh_phase(card, dsys, dfac, sp, fs, pinned, sp_pinned,
                               form_launches)

    # 17. mesh serving ----------------------------------------------------
    serving_launches = mesh_serving_phase(card, form_launches, dsys, ssp,
                                          pinned, ssp_pinned)

    # 18. redundancy and the elastic runtime (no kernel) --------------------
    # on the dense system alone: the kernels' B and the sparse path's
    # systems and factors (its densified twin's B among them) go
    chol = dfac.chol
    del dfac, sp, ssp, fs, fd, msf, sparse_facs, vals, cols, Bv, vals16, \
        Bv16, vals32, Bv32, b
    gc.collect()
    torch.cuda.empty_cache()
    redundancy_phase(card, dsys, chol, pinned)
    del dsys, chol
    gc.collect()
    torch.cuda.empty_cache()

    # 19. the LM serving path and the APC probe head ----------------------
    probe_launches = lm_phase(card)

    main_launches.update(
        {kn: sparse_launches["apc" if kn in SPARSE_USES["apc"]
                             else "cimmino"][kn]
         for kn in SPARSE_USES["apc"] + SPARSE_USES["cimmino"]})
    # each form's launches, each from its own runs (counts reset just
    # before each and read by form just after): dense APC and Cimmino,
    # sparse APC and Cimmino
    def by_kernel(runs):
        return {kn: runs[(label, sname)][kn]
                for label, uses in (("dense", USES), ("sparse", SPARSE_USES))
                for sname in ("apc", "cimmino") for kn in uses[sname]}

    form_main = {F64: main_launches, F32: by_kernel(f32_launches),
                 "bfloat16/float64": by_kernel(mixed_launches),
                 "bfloat16/float32": by_kernel(mixed32_launches),
                 BF: bf_launches}
    kernels = []
    for kname in bp.KERNELS:
        r = rows[(kname, 1)]
        forms = []
        for pr, f in r["forms"].items():
            forms.append({
                "pair": pr, "k": 1, "ms": f["ms"],
                "graph_ms": f.get("graph_ms"),
                "row_dot_ms": f.get("row_dot_ms"),
                "ring_ms": f.get("ring_ms"), "bound_ms": f["bound_ms"],
                "bound_by": f["bound_by"],
                "launches": form_main[pr][kname],
                "max_abs_err": max_abs[(kname, pr)],
                "library_ms": f.get("library_ms"),
                "library": None if "library_ms" in f else NO_LIBRARY})
        kernels.append({
            "name": kname, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[kname], "launches": main_launches[kname],
            "mesh_launches": mesh_launches[kname],
            "mesh_serving_launches": serving_launches[kname],
            "lm_probe_launches": probe_launches[kname],
            "max_abs_err": max_abs[(kname, "float64/float64")],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "forms": forms})
    return kernels, card, t0, bw


if __name__ == "__main__":
    sys.exit(main())
