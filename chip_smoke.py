"""Drive the PyTorch/CUDA port on one NVIDIA GPU and hold its kernels to their
plain PyTorch versions.

    python3 chip_smoke.py

Phases (each failure is fatal; exit code != 0, no result line):

1. the card's name and power limit, torch/CUDA versions; TF32 off.
2. build the CUDA kernels from ``tensordiffeq_tpu_torch/csrc`` (nvcc).
3. K1 (Taylor-table forward) against the plain flavor at the slice's full
   shapes (N = 50,000 points, net 2-128x4-1) for the Allen-Cahn request set
   and for a mixed-3rd / unmixed-4th request set, with the route the host
   chose by shape (the persistent wgmma route of ``csrc/taylor_fwd_wg.cuh``
   at these shapes) and a second launch equal to the first bit for bit;
   its ms over 20 launches beside its ms before the wgmma route (PERF.md).
   The same for K1's route for wider layers (the kernel beside K2 in
   ``csrc/taylor_table.cu``) on the net at twice the width, 2-256x4-1,
   with the Allen-Cahn set (``[K1 wide]``); phase 14 holds K1-bf16 there.
4. K2 (Taylor-table backward: dW, db, dX) against autograd of the plain
   flavor, same shapes.
5. K3 (the fused minimax step: value, dW/db, gw, gX) against its plain
   flavor, for the Allen-Cahn residual (E = 1, N = 50,000, 2-128x4-1), the
   coupled 2-equation system (E = 2, 2-128x4-2) and a ``1/x`` residual at a
   ragged N = 50,001 (everything finite).
   Each kernel's time is printed beside two bounds: the route it takes
   (its tensor-core products as 3 TF32 passes over the TF32 peak, the rest
   over the FP32 peak, its bytes over the HBM rate) and, for continuity,
   every operation on the FP32 CUDA cores.  A ``[yardstick]`` line times
   the same hidden-layer products as cuBLAS f32 matmuls.
6. the minimax slice, the main path: the Allen-Cahn SA-PINN at its full
   size trained through ``compile(fused="cuda")`` with the default
   ``minimax``, which adopts K3; ``fit(tf_iter=200)`` and ``predict`` on the
   512x201 grid, with the kernels' launch counts read around compile, fit
   and predict (K3 once in compile's cross-check and once per step; K1 and
   K2 not in ``fit``).
7. the unfused path of the first slice, ``compile(fused="cuda",
   minimax=False)``: K1 and K2 once each per step, the same 200 steps, so
   the two paths' ms/step compare within one call.
8. the refinement slice on the trained minimax solver of phase 6: L-BFGS
   with the zoom line search (``fit(newton_iter=100)``), where every
   evaluation of the loss and its gradient is one K3 launch and K1/K2 do
   not run; the fixed-step rule (``fit(newton_iter=20,
   newton_eager=True)``, K3 exactly 20 times); ms per iteration,
   evaluations and host synchronisations per iteration, one evaluation,
   one two-loop sweep and one fixed-step iteration timed alone, the
   host's time to issue each of their graphs, line-search iterations past
   the graphs' capture, and the rel-L2 of ``predict(best_model=True)``.  Then the checkpoint leg: ``save_checkpoint``, a
   fresh solver compiled the same way and restored on the card has the
   same ``update_loss()`` and the same 10 further Adam steps, bit for bit;
   a checkpoint taken mid-L-BFGS brings ``newton_done`` and the iterate
   back.
9. the CUDA graphs against their eager referee: on each path an
   identically seeded solver trains 50 Adam steps through the replayed
   graphs and another through the same steps run eagerly
   (``fit(_graphs=False)``), ms/step of both printed, every loss and
   parameter bit for bit (or within 1e-6 scale-relative, the band printed);
   on the minimax path also 10 line-search and 10 fixed-step L-BFGS
   iterations each way.  Then ``fit(batch_sz=16384)`` for 20 epochs on the
   minimax solver (4 batches, the last wrapping 15,536 rows to the front:
   K3 exactly 80 times, at N = 16,384 each; the loss falls) and
   ``fit(grad_clip=1.0)`` for 20 steps, held to its eager referee too.
   Every capture's seconds and graph-pool bytes are printed.
10. serving, on the trained minimax solver of phases 6 and 8:
   ``export_surrogate()`` saved, loaded back with no solver
   (``Surrogate.load(dir, f_model=...)``) onto a 256-131,072 ladder (10
   rungs), then the kinds ``u``, ``d:x:1``, ``d:x:2``, ``d:t:1`` and
   ``residual`` on the 512x201 grid (one chunk, rung 131,072) and on 200
   queries of 1-50,000 points (log-uniform sizes); every rung a captured
   CUDA graph.  Gates: each rung's graph equals its program run eagerly at
   the same padded shape bit for bit; 1,000 rows answer bit for bit alone
   and inside a larger query of the same rung; ``u`` matches ``predict``
   within 1e-6 and its rel-L2 matches ``predict``'s; the derivative kinds
   recombine into the residual within 1e-4; the residual matches
   ``predict``'s (K1's fused engine) in the cross-check band; no rung
   quarantined, one capture per program, no K1-K3 launch; the graphs in one
   shared pool answer as in private pools.  Then a ``RequestBatcher`` over
   the residual takes 5,000 requests of 1-64 points.  Prints a ``[serve
   <kind> b=<bucket>]`` line per rung (capture s, pool MiB, ms per replay
   by CUDA events, points/s), ``[serve grid]`` and ``[serve batcher]``.
11. adaptive collocation on AC-SA full (``compile(fused="cuda")``, K3
   adopted): (a) K3 at w = 1, the ascent mover's scores (the sum of gw)
   and direction (gX), against its plain flavor at N = 50,000; (b) K1 over
   a pool of 200,000 points (``[X_f ; 150,000 stratified]``) against its
   plain flavor, each within 1e-4 scale-relative and timed; (c)
   ``fit(tf_iter=400, chunk=100, resample_every=100)`` in pool mode: 3
   redraws dispatched on their own stream, 2 swapped in, the last discarded;
   (d) the same with ``resample_mode="ascent"``; (e) each mode again on a
   fresh solver with ``_graphs=False``.  Gates: N_f unchanged and ``X_f``
   the same tensor; the Adam graph captured once across the swaps; at each
   swap kept rows' λ and λ moments are the old rows gathered bit for bit,
   fresh rows' λ the kept mean and their moments zero; launches K1 3 and
   K3 400 in pool mode, K3 400 + 6 x 3 in ascent mode; the graphed and the
   eager solver (one seed) end bit for bit equal, ``X_f`` included; the
   loss finite.  Prints each redraw's device ms (CUDA events on its
   stream), its host dispatch and swap stall, and, in four more fits of
   two chunks on the graphed solver, ms/step of the first chunk (alone)
   against the second (a redraw in flight).
12. the inverse problem at full width: ``DiscoveryModel`` on the 512x201
   Allen-Cahn grid (102,912 observations), 2-128x4-1, var = [0, 0], SA
   weights from ``RandomState(0).rand``, ``lr_vars=[2e-5, 0.01]``, the
   fused engine adopted.  50 graphed steps against 50 eager ones bit for
   bit; 200 steps in all (ms/step), the loss falls and both coefficients
   move; a checkpoint at step 100 restored into a fresh model resumes bit
   for bit; ``export_surrogate`` → ``save`` → ``Surrogate.load(...,
   f_model=)`` keeps the learned coefficients and its engine's residual on
   the grid matches ``predict_f`` within 1e-5 scale-relative.  No kernel
   launches (the JAX package's discovery reaches none either).
13. the solver's remaining training options, each on the Allen-Cahn
   problem at full width (N_f = 50,000, 2-128x4-1, the 512x201 grid):
   (a) ``compile(fused="autotune")`` on AC-SA: each candidate's graphed
   loss-and-gradient step (generic, the fused engine's plain flavor, its
   K1/K2 flavor) and the K3 race printed; gates: the adopted engine is the
   argmin, the K1/K2 candidate passed its cross-check, compile's launches
   are the protocol's; (b) AC-SA on the minimax path with
   ``exponential_decay`` on the network's rate and ``cosine_decay_schedule``
   on the λ's, 200 steps (ms/step beside a constant-rate twin's 200 and
   phase 6's), then 50 graphed against 50 eager steps; gates: bit for bit, one capture, the device's
   counts 200 and rates the schedules' at count 199 (the 200th update's),
   K3 once per step; (c) ``examples/ac_ntk.py``'s configuration
   (``Adaptive_type=3``), ``fit(tf_iter=200, chunk=50)``, each NTK update's
   device and host ms; gates: 4-5 updates within ``max_ratio``, one
   capture, 50 graphed steps equal 50 eager ones across two updates, K3
   once per step, the loss falls; (d) AC-SA on ``fused="cuda"`` with the
   ladder ``causal_eps=[1e-2, 1e-1, 1, 10]`` (gate 0.5), 200 steps in
   chunks of 50, then the same with ``remat=True``: peak device memory and
   ms/step of both; gates: K1 and K2 once per step (K1 twice under remat),
   one capture across the ladder's changes, graph = eager bit for bit,
   ``Causal_w_last`` in every row, remat's first loss and gradients equal
   to the plain run's; (e) ``PeriodicMLP`` (x periodic, 4 harmonics) and
   ``FourierMLP`` (64 frequencies) on AC-SA, 200 graphed steps each on the
   generic engine, exported, saved and loaded with no solver; gates: served
   ``u`` equals ``predict`` within 1e-6, ``u(-1, t) = u(1, t)`` within 1e-6
   (periodic), no K1-K3 launch.
14. mixed precision, the bf16-operand flavor of K1, K2 and K3 at full width
   (AC, N_f = 50,000, 2-128x4-1, the 512x201 grid):
   (a) K1-bf16 and K2-bf16 (the AC and mixed request sets; K1-bf16 also
   on phase 3's 2-256x4-1, its wide route) and K3-bf16
   (E = 1 and the coupled E = 2 system) against their plain bf16 flavors
   (``compute_dtype=torch.bfloat16``); gates: every leaf within the
   reference's bf16 bands (5e-2 values, 1.5e-1 gradients, scale-relative),
   and nearer (RMS) the plain bf16 flavor than the plain f32 one, K1-bf16
   bit for bit run to run (its route printed); each
   timed over 20 launches beside its f32 flavor and beside its time before
   the flavor took the bf16 tensor cores (its TF32-pass route's, and
   K1-bf16's before the wgmma route, from PERF.md), with its
   bound (the products at the dense bf16 peak: 1 pass per forward product,
   3 per cotangent product, the passes its route takes);
   (b) ``compile(fused="cuda", fused_dtype="bfloat16")`` on AC-SA: the
   minimax path ``fit(tf_iter=200)`` then ``fit(newton_iter=100)``, and
   ``minimax=False`` ``fit(tf_iter=200)``, then 50 graphed against 50
   eager steps on each path; gates: K3-bf16 once per Adam step and no other
   kernel in the minimax Adam leg, K1-bf16 and K2-bf16 once per step on
   the unfused one, in the L-BFGS leg K3-bf16 per evaluation until the
   retreat and f32 K3 after it (whether and when it retreated is printed),
   the loss falls and the L-BFGS best is below the Adam leg's last loss,
   one capture, graph = eager bit for bit; rel-L2 reported beside phase
   6's; (c) the trained bf16 net exported, loaded with no solver and served
   by ``InferenceEngine(compute_dtype="bfloat16")`` on phase 10's ladder
   for ``u``, ``d:x:1``, ``d:x:2`` and ``residual`` at rungs 256, 4,096 and
   131,072; gates: each rung's graph equals its program run eagerly bit for
   bit; on the grid each kind within the bf16 values band of the same
   artifact served by the plain bf16 flavor (an engine on the CPU) and
   nearer it by RMS than the f32 engine, and not equal to the f32 engine;
   its distance to the f32 engine is printed, on this net and on phase
   10's f32-trained one served both ways (as ``tests/test_serving.py::
   test_engine_bf16_buckets_track_f32_within_rounding`` serves an
   f32-trained net): bf16's own distance on a trained net, which the
   plain bf16 flavor shares to the digit; K1-bf16 once per replay and
   nothing else; ms per replay beside phase 10's.
15. the PDE zoo (``tensordiffeq_tpu_torch/zoo``): each of its nine entries
   at its ``full`` size (its own widths, N_f, d, n_out and E; only the
   budget is cut) built by ``zoo.build_solver(entry, "full")`` on the card:
   (a) the engine must be ``fused-minimax-cuda`` with E equations; compile
   seconds and launches printed; (b) K3 (the solver's own lowered step, w
   = λ²), K1 and K2 (the entry's requests) against their plain flavors at
   the entry's N_f points within 1e-4 scale-relative, K1 and K3 bit for
   bit run to run, each timed over 20 launches beside its bound; (c)
   ``zoo.race_entry(entry, "full", arms=("fixed",), budget_cap=200)``: 200
   Adam steps and up to 200 L-BFGS iterations with evaluations at the
   scorecard's cadences and a ``TrainingTelemetry`` attached; gates: the
   loss falls, every evaluation finite, K3 once in compile + once per Adam
   step + once per L-BFGS evaluation and K1/K2 never, one capture of the
   Adam step, ``flops_basis == "analytic-minimax"``; ms/step past the
   capture, ms/iteration and the final rel-L2 (residual RMS for
   ``burgers2d``) reported; ``allen-cahn-sa`` races all three arms at a
   cap of 300 (one redraw swapped in), where the pool and ascent arms must
   report a redraw and a finite stall p50; (d) on ``taylor-green`` (E =
   3), 50 graphed steps with telemetry against 50 eager ones from one seed,
   bit for bit, and 50 without telemetry: the same losses (but
   ``Grad_norm``), parameters and λ, bit for bit; (e) ``fit(profile_dir=)``
   on ``burgers`` writes a Chrome trace holding K3's kernel records.  The
   phase's wall is printed.
16. the network options: (a) K1, K2 and K3 in their single-pass TF32
   flavor (precision ``None``) at the Allen-Cahn slice (N = 50,000,
   2-128x4-1, C = 4, E = 1) and at ``burgers``' 2-20x8-1, each against the
   TF32-emulating plain flavor (``taylor_derivatives(emulate_tf32=True)``)
   and its float64-summed twin: the nearer within TF32_SPREAD times the
   order spread of the same semantics (the two referees' distance, at
   least 1e-4) by RMS, and by max also within TF32_FLIP of the
   emulation's distance to the IEEE flavor; nearer the emulation than the
   IEEE flavor; K1 and K3 bit for bit run to run;
   each timed over 20 launches beside the 3xTF32 flavor and its one-pass
   bound; the distance to the IEEE flavor printed.  (b) AC-SA full with
   ``neural_net(WIDTHS, precision=None)`` on ``fused="cuda"``: the engine
   compile adopts and the cross-check's distances; where the f32 band
   refuses the flavor the next narrower width is tried (TF32_WIDTHS, each
   printed); at the first that adopts the minimax step, 200 Adam steps with
   K3-TF32 once per step and no other launch, 20 L-BFGS iterations with
   K3-TF32 once per evaluation, the loss falling, graph = eager over 50
   steps, ms/step beside phase 6's, and 50 unfused steps through
   K1-TF32/K2-TF32.  (c) a custom ``nn.Module`` (a residual MLP with skip
   connections) on AC-SA: the generic engine through the CUDA graphs, 200
   Adam + 20 L-BFGS with no K1-K3 launch of any flavor, the loss falling,
   graph = eager; ``save`` -> ``load_model(network=)`` -> 10 steps bit for
   bit against the same steps from a copy of the module;
   ``export_surrogate`` -> ``Surrogate.load(net=)`` -> the engine serves
   ``u`` within 1e-6 of ``predict``.  (d) ``MLP(activation=torch.sin)``
   and ``neural_net(dtype=torch.bfloat16)`` on AC-SA: the generic engine,
   no launch, the loss falls over 200 steps, graph = eager, ms/step.
17. a ``{"kernels": [...]}`` line (K1, K2, K3, their bf16 and their TF32
   flavors, each held to its plain version; K1's with the route it took and
   its wide route's measurements as ``wide_route``; the TF32 flavors with
   their distances and the 3xTF32 flavor's ms; ``launches_by_path`` has
   phase 16's paths), the card line again, and the result line.

Phases 6-9 and 11-14 train through CUDA graphs (``training/graphs.py``): each Adam
step, each L-BFGS evaluation and two-loop sweep, and each fixed-step L-BFGS
iteration is one replayed graph after three eager warm-up steps; the
kernels' launch counters add each graph's recorded launches at every
replay, so the launch gates count the launches the device ran.

``--profile`` adds, after phase 8, an A/B of the two trained solvers (50
more steps per turn in eight turns: minimax, unfused, unfused, minimax,
twice), so their ms/step compare within one stretch of the host's load;
then four windows of 20 Adam steps under ``torch.profiler``, the paths in
turns (minimax, unfused, unfused, minimax): the host's time in each of
``fit_adam``'s ranges (``fit_adam.step``: a graph replay; ``fit_adam.read``:
the chunk's history copy), device time by kernel group, the device's busy
and idle share, the host's launches per step (kernel and graph launches,
copies and fills: the runtime calls the host makes), and the top host ops;
then one window of 20 line-search L-BFGS iterations of the minimax solver,
split the same way over the ranges ``lbfgs.evaluate``, ``lbfgs.direction``
and ``lbfgs.read`` (the host reads: the line search's syncs).  The script
imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

# H100 SXM published peaks (NVIDIA data sheet; dense, at the 700 W limit)
PEAK_FP32_FLOPS = 67e12       # FP32 on the CUDA cores, no tensor cores
PEAK_TF32_FLOPS = 495e12      # TF32 on the tensor cores, dense
PEAK_BF16_FLOPS = 989e12      # bf16 on the tensor cores, dense
PEAK_HBM_BYTES = 3.35e12      # HBM3 bytes/s
TF32_PASSES = 3               # the f32 flavor's products are 3xTF32

# K1/K2 vs their plain flavor: scale-relative max error (max |kernel - plain|
# over max |plain|, per table channel / gradient leaf).  The plain side is
# IEEE f32; the kernels take the hidden-layer products as 3xTF32 (at worst
# about 2^-20 relative per product, f32 sums) and sum in another order
# (128-term dot products per layer for K1, its wgmma route summing all 48
# passes of a layer in the tensor core's own accumulator; K2's weight
# cotangents also sum 50,000 points x C channels).  Measured on an H100 at
# these shapes: K1 7.6e-6 (4.8e-6 before its wgmma route), K2 1.1e-6
# (PERF.md).
K1_RTOL = 1e-4
K2_RTOL = 1e-4
# K3 vs its plain flavor, the same measure over the value, every dW/db leaf,
# gw and gX: the same product numerics, another summation order (the value
# and dW/db sum 50,000 points)
K3_RTOL = 1e-4

AC_REQUESTS = {(), (1,), (0, 0)}
MIXED_REQUESTS = {(), (0,), (1,), (0, 0), (0, 1), (0, 0, 1), (0, 0, 0, 0)}
WIDTHS = [2, 128, 128, 128, 128, 1]
# K1's shapes past its wgmma route (hidden widths over 128): the slice's
# net at twice the width, which takes the kernel beside K2
WIDE_WIDTHS = [2, 256, 256, 256, 256, 1]
# the K1 route each case of phases 3 and 14 must take
K1_ROUTES = {"ac": "wgmma", "mixed": "wgmma", "wide": "wide"}
N_POINTS = 50_000
TF_ITER = 200  # Adam steps of the slice
LBFGS_ITER = 100  # line-search L-BFGS iterations of the refinement slice
EAGER_ITER = 20  # fixed-step L-BFGS iterations
RESUME_STEPS = 10  # Adam steps after the restore, on both solvers
AB_STEPS = 50  # steps per turn of the paths' A/B
REFEREE_STEPS = 50  # Adam steps, graphs against the eager referee
REFEREE_ITER = 10  # L-BFGS iterations of each rule, the same
STEADY_ITER = 50  # line-search iterations timed past the graphs' capture
BATCH_SZ, BATCH_EPOCHS = 16_384, 20  # the minibatch leg: 4 batches
CLIP, CLIP_STEPS = 1.0, 20  # the grad_clip leg
# graph against eager: scale-relative, were a replayed op to round otherwise
GRAPH_BAND = 1e-6
# the profiler ranges of an Adam step under the graphs (training/fit.py):
# the replay, and the chunk's history copy
HOST_SPANS = ("fit_adam.step", "fit_adam.read")
# the CUDA runtime calls by which the host starts work on the device
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch",
                "cudaMemcpyAsync", "cudaMemsetAsync", "cudaLaunchKernelExC")
# the profiler ranges of an L-BFGS iteration (training/lbfgs.py):
# evaluations of loss and gradient, two-loop products, host reads
LBFGS_SPANS = ("lbfgs.evaluate", "lbfgs.direction", "lbfgs.read")
# phase 10, serving: the kinds, the ladder, the traffic
SERVE_KINDS = ("u", "d:x:1", "d:x:2", "d:t:1", "residual")
SERVE_LADDER = dict(min_bucket=256, max_bucket=131_072)
SERVE_QUERIES, SERVE_MAX_ROWS = 200, 50_000
ROW_STABLE = 1_000
BATCH_REQUESTS, BATCH_MAX_ROWS = 5_000, 64
# phase 11, adaptive collocation: 400 steps, a redraw dispatched every 100
# (at 100, 200, 300), swapped in at the next boundary, the last discarded
RESAMPLE_STEPS, RESAMPLE_EVERY = 400, 100
RESAMPLE_PLAN = [(100, 200), (200, 300), (300, None)]
RESAMPLE_TURNS = 4  # fits of two chunks: the second with a redraw in flight
# phase 12, discovery: 200 steps in chunks of 50, the first 50 held to
# eager, a checkpoint at 100; the JAX example's per-coefficient rates
DISC_STEPS, DISC_REFEREE, DISC_CKPT, DISC_CHUNK = 200, 50, 100, 50
DISC_LR_VARS = (2e-5, 0.01)
# phase 13, the training options: autotune's timed replays per step (the
# solver's _time_loss_step default), the causal ladder and its gate (the
# default causal_delta of 0.99 does not open within 200 steps on AC-SA:
# Causal_w_last stays at 0.77-0.98 at eps 1e-2 over the first 100 steps,
# measured on the CPU at N_f = 5,000)
AUTOTUNE_REPS = 3
CAUSAL_LADDER = [1e-2, 1e-1, 1.0, 10.0]
CAUSAL_DELTA = 0.5
# phase 14, mixed precision: the reference's bf16 bands (the JAX solver's
# cross-check bands under fused_dtype), scale-relative; the serving kinds
# and the rungs timed
BF16_VALUE_BAND, BF16_GRAD_BAND = 5e-2, 1.5e-1
# the bf16 kernels' ms before they took the bf16 tensor cores: TF32 passes
# over operands rounded at each fragment load (PERF.md §6, an NVIDIA H100
# 80GB HBM3 at 700 W), printed beside this run's
BF16_TF32_ROUTE_MS = {"K1-bf16 ac": 0.738, "K2-bf16 ac": 3.408,
               "K3-bf16 ac": 3.760, "K3-bf16 system": 3.853}
# K1's ms before its persistent wgmma route (the kernel beside K2, which
# stays the route for other shapes; PERF.md §6, an NVIDIA H100 80GB HBM3 at
# 700 W: the Allen-Cahn set's from chip_smoke.py, the mixed set's from
# scripts/torch_k1_route_ab.py), printed beside this run's; the same-call
# comparison is those scripts' and scripts/torch_step_ab.py's
K1_BEFORE_WGMMA_MS = {"K1 ac": 0.844, "K1-bf16 ac": 0.583,
                      "K1 mixed": 1.735, "K1-bf16 mixed": 1.237}
SERVE_BF16_KINDS = ("u", "d:x:1", "d:x:2", "residual")
SERVE_BF16_BUCKETS = (256, 4096, 131_072)
# engine u against predict's u: the same forward at another row count
SERVE_U_BAND = 1e-6
# u_t - 1e-4 u_xx + 5u^3 - 5u from the derivative kinds against the
# residual kind: the JAX serving example's check
SERVE_RECOMBINE_BAND = 1e-4
# the residual against predict's (K1's fused engine): the engines'
# cross-check band (ops/fused.py::crosscheck_residuals)
SERVE_CROSSCHECK_RTOL = 5e-3
# phase 16, the network options.  The TF32 flavor's band: rounding each
# layer's input to TF32 is discontinuous, so two sum orders of the same
# single-pass semantics round the few operands that sit on a TF32 rounding
# boundary a TF32 unit apart, and no referee of another order holds the
# kernels to a fixed 1e-4 (scripts/torch_tf32_order_witness.py measures it
# on the CPU: 2e-4 to 2.4e-3 scale-relative between f32 and f64 sums of
# the same TF32 products).  Each kernel is held to the nearer of two
# referees of the same semantics (the emulation, and its float64-summed
# twin) within TF32_SPREAD times their distance on the same inputs (the
# order spread), at least TF32_FLOOR, in the RMS metric; in the max metric,
# where one flipped operand decides, also within TF32_FLIP of the
# emulation's own max distance to the IEEE flavor (a flip moves one
# operand by one TF32 unit, rounding every operand moves the table that
# far); and nearer the emulation than the IEEE flavor.
TF32_SPREAD, TF32_FLIP = 3.0, 0.5
TF32_FLOOR = 1e-4
BURGERS_WIDTHS = [2] + [20] * 8 + [1]  # the zoo's burgers entry, full size
# the widths phase 16(b) tries in turn: the slice's first; the next ones
# only if the f32 cross-check band refuses the TF32 flavor at a width
TF32_WIDTHS = ([2, 128, 128, 128, 128, 1], [2, 64, 64, 64, 64, 1],
               [2, 32, 32, 32, 32, 1], BURGERS_WIDTHS)
TF32_LBFGS = 20  # L-BFGS iterations of the TF32 and custom-module legs
TF32_UNFUSED_STEPS = 50  # the TF32 flavor's unfused steps (K1/K2)


def fail(msg: str):
    print(f"FAILED: {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean ms per call, by CUDA events around ``reps`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(flops: dict, nbytes: float, passes: float = TF32_PASSES,
             peak: float = PEAK_TF32_FLOPS) -> dict:
    """The least time the card could take for a kernel's work: the larger
    of its tensor-core products (``passes`` each at ``peak``: 3 TF32 passes
    in the f32 flavor; in the bf16 flavor dense-bf16 passes at the bf16
    peak, 1 per forward product and 3 per cotangent product,
    ``tensor_passes``, which its route takes), the rest of its operations
    over the FP32 peak, and its bytes over the HBM rate.  ``fp32_ms``: the
    bound with every operation on the CUDA cores, as before the tensor
    cores."""
    t_tc = passes * flops["tensor"] / peak
    t_simt = flops["simt"] / PEAK_FP32_FLOPS
    t_bytes = nbytes / PEAK_HBM_BYTES
    t_fp32 = (flops["tensor"] + flops["simt"]) / PEAK_FP32_FLOPS
    return dict(ms=max(t_tc, t_simt, t_bytes) * 1e3,
                by="operations" if max(t_tc, t_simt) >= t_bytes else "bytes",
                fp32_ms=max(t_fp32, t_bytes) * 1e3)


def bound_text(ms: float, bound: dict) -> str:
    return (f"bound {bound['ms']:.3f} ms ({bound['by']}; "
            f"{100 * bound['ms'] / ms:.1f} % of it), FP32-core bound "
            f"{bound['fp32_ms']:.3f} ms ({100 * bound['fp32_ms'] / ms:.1f} %)")


def _bit_identical_run_to_run(label: str, first, launch) -> bool:
    """A kernel's output launched again on the same inputs equals the first
    bit for bit (the served rungs and remat's first step rely on it)."""
    import torch
    again = launch()
    torch.cuda.synchronize()
    same = torch.equal(again, first)
    print(f"[{label}] run to run: "
          f"{'bit-identical' if same else 'DIFFERENT'}", flush=True)
    if not same:
        fail(f"{label} is not bit-identical run to run")
    return same


def scaled_err(got, want) -> tuple[float, float]:
    """(max abs error, max abs error / max |want|)."""
    err = float((got - want).abs().max())
    return err, err / max(float(want.abs().max()), 1e-30)


def _slice_net(widths, dev):
    """The net of phases 3 and 14 at ``widths`` (seed 0): its layers, their
    tensors flat and detached, leaf copies that take gradients, and those
    as (W, b) pairs."""
    from tensordiffeq_tpu_torch.networks import neural_net
    layers = neural_net(widths, device=dev, seed=0).layers()
    flat_layers = [t.detach() for pair in layers for t in pair]
    params = [t.clone().requires_grad_(True) for t in flat_layers]
    return layers, flat_layers, params, list(zip(params[0::2], params[1::2]))


def _k1_route(plan, dtype, label: str) -> str:
    """The route K1's last launch in a flavor took; it must be the one
    ``K1_ROUTES`` names for the case."""
    route = plan.k1_routes[dtype]
    if route != K1_ROUTES[label]:
        fail(f"K1 ({label}, {dtype}) took the {route} route, not the "
             f"{K1_ROUTES[label]} one")
    return route


def phase_kernels(dev) -> dict:
    """Phases 3-4: each kernel against its plain flavor, at the slice's
    shapes, and K1 also on ``WIDE_WIDTHS`` (its route for wider layers).
    Returns the measurements of the Allen-Cahn request set, the wide
    route's under ``k1["wide"]``."""
    import torch
    from tensordiffeq_tpu_torch.ops import cuda_taylor as ct
    from tensordiffeq_tpu_torch.ops.taylor import taylor_derivatives

    rng = np.random.RandomState(0)
    X = torch.as_tensor(np.stack([rng.uniform(-1, 1, N_POINTS),
                                  rng.uniform(0, 1, N_POINTS)], 1),
                        dtype=torch.float32, device=dev)
    out = {}
    for label, reqs, widths in (("ac", AC_REQUESTS, WIDTHS),
                                ("mixed", MIXED_REQUESTS, WIDTHS),
                                ("wide", AC_REQUESTS, WIDE_WIDTHS)):
        layers, flat_layers, params, pairs = _slice_net(widths, dev)
        plan = ct.build_cuda_table_fn(
            reqs, [tuple(W.shape) for W, _ in layers]).plan
        flat = plan.pack(flat_layers)
        channels = plan.channels

        def plain_table():
            t = taylor_derivatives(pairs, X, set(channels), flat_matmul=True)
            return torch.stack([t[mi] for mi in channels])

        table = ct.k1_forward(plan, X, flat)
        torch.cuda.synchronize()
        with torch.no_grad():
            ref = plain_table()
        k1_abs, k1_rel = 0.0, 0.0
        for c in range(plan.C):
            a, r = scaled_err(table[c], ref[c])
            k1_abs, k1_rel = max(k1_abs, a), max(k1_rel, r)
        route = _k1_route(plan, None, label)
        print(f"[K1 {label}] C={plan.C} N={N_POINTS} widths {widths} route "
              f"{route} max_abs_err={k1_abs:.3e} scale_rel_err={k1_rel:.3e} "
              f"(tol {K1_RTOL:g} on it)", flush=True)
        if not k1_rel <= K1_RTOL:
            fail(f"K1 disagrees with the plain flavor ({label})")
        k1_bits = _bit_identical_run_to_run(
            f"K1 {label}", table, lambda: ct.k1_forward(plan, X, flat))
        flops = ct.flop_count(plan, N_POINTS)
        nbytes = ct.byte_count(plan, N_POINTS)
        b1 = bound_ms(flops["k1"], nbytes["k1"])
        if label == "wide":
            before = ct.k1_forward.launches
            k1_ms = cuda_ms(lambda: ct.k1_forward(plan, X, flat))
            with torch.no_grad():
                k1_plain_ms = cuda_ms(plain_table)
            # comparison launches are not the main path's
            ct.k1_forward.launches = before
            print(f"[time {label}] K1 {k1_ms:.3f} ms on the {route} route "
                  f"(plain {k1_plain_ms:.3f} ms), {bound_text(k1_ms, b1)}",
                  flush=True)
            out[label] = dict(k1=dict(
                max_abs_err=k1_abs, ms=k1_ms, plain_ms=k1_plain_ms,
                bound=b1, route=route, bit_identical=k1_bits))
            continue

        g = torch.as_tensor(rng.randn(plan.C, N_POINTS, 1),
                            dtype=torch.float32, device=dev)
        dX, dflat = ct.k2_backward(plan, X, flat, g)
        torch.cuda.synchronize()
        Xg = X.clone().requires_grad_(True)

        def plain_grads():
            t = taylor_derivatives(pairs, Xg, set(channels), flat_matmul=True)
            loss = sum((t[mi] * g[c]).sum() for c, mi in enumerate(channels))
            return torch.autograd.grad(loss, params + [Xg])

        ref_g = plain_grads()
        mine = plan.unpack(dflat) + [dX]
        k2_abs, k2_rel = 0.0, 0.0
        for a_k, a_p in zip(mine, ref_g):
            a, r = scaled_err(a_k, a_p)
            k2_abs, k2_rel = max(k2_abs, a), max(k2_rel, r)
        print(f"[K2 {label}] max_abs_err={k2_abs:.3e} "
              f"scale_rel_err={k2_rel:.3e} (tol {K2_RTOL:g} on it)",
              flush=True)
        if not k2_rel <= K2_RTOL:
            fail(f"K2 disagrees with autograd of the plain flavor ({label})")

        before = (ct.k1_forward.launches, ct.k2_backward.launches)
        k1_ms = cuda_ms(lambda: ct.k1_forward(plan, X, flat))
        with torch.no_grad():
            k1_plain_ms = cuda_ms(plain_table)
        k2_ms = cuda_ms(lambda: ct.k2_backward(plan, X, flat, g))
        k2_plain_ms = cuda_ms(plain_grads, reps=5)
        # comparison launches are not the main path's: restore the counts
        ct.k1_forward.launches, ct.k2_backward.launches = before
        b2 = bound_ms(flops["k2"], nbytes["k2"])
        before_ms = K1_BEFORE_WGMMA_MS.get(f"K1 {label}")
        print(f"[time {label}] K1 {k1_ms:.3f} ms on the {route} route "
              f"(before the wgmma route: "
              f"{'not recorded' if before_ms is None else f'{before_ms:.3f} ms'}"
              f"; plain {k1_plain_ms:.3f} ms), {bound_text(k1_ms, b1)}",
              flush=True)
        print(f"[time {label}] K2 {k2_ms:.3f} ms (plain fwd+bwd "
              f"{k2_plain_ms:.3f} ms), {bound_text(k2_ms, b2)}", flush=True)
        out[label] = dict(
            k1=dict(max_abs_err=k1_abs, ms=k1_ms, plain_ms=k1_plain_ms,
                    bound=b1, route=route, bit_identical=k1_bits),
            k2=dict(max_abs_err=k2_abs, ms=k2_ms, plain_ms=k2_plain_ms,
                    bound=b2))
    out["ac"]["k1"]["wide"] = out["wide"]["k1"]
    return out["ac"]


def _ac_residual(u, x, t):
    from tensordiffeq_tpu_torch import grad
    uv = u(x, t)
    return (grad(u, "t")(x, t) - 0.0001 * grad(grad(u, "x"), "x")(x, t)
            + 5.0 * uv ** 3 - 5.0 * uv)


def _coupled_residual(u, x, t):
    """The Schrodinger-type coupled pair of the JAX package's
    ``tests/test_solver.py::make_coupled_system``."""
    from tensordiffeq_tpu_torch import grad
    uv, vv = u[0](x, t), u[1](x, t)
    sq = uv ** 2 + vv ** 2
    f_u = (grad(u[0], "t")(x, t) + 0.5 * grad(grad(u[1], "x"), "x")(x, t)
           + sq * vv)
    f_v = (grad(u[1], "t")(x, t) - 0.5 * grad(grad(u[0], "x"), "x")(x, t)
           - sq * uv)
    return f_u, f_v


def _singular_residual(u, x, t):
    """A cylindrical-Laplacian-style ``1/x`` term: NaN at the origin."""
    from tensordiffeq_tpu_torch import grad
    return grad(u, "t")(x, t) + grad(u, "x")(x, t) / x


def phase_k3(dev) -> dict:
    """Phase 5: K3 against its plain flavor.  Returns the measurements of
    the Allen-Cahn case (the slice's shapes)."""
    import torch
    from tensordiffeq_tpu_torch.networks import neural_net
    from tensordiffeq_tpu_torch.ops import cuda_minimax as cm
    from tensordiffeq_tpu_torch.ops.fused import analyze_f_model
    from tensordiffeq_tpu_torch.ops.minimax import build_minimax_sq_fn

    cases = (  # label, residual, widths, N, x range
        ("ac", _ac_residual, WIDTHS, N_POINTS, (-1.0, 1.0)),
        ("system", _coupled_residual, WIDTHS[:-1] + [2], N_POINTS,
         (-1.0, 1.0)),
        ("singular", _singular_residual, WIDTHS, N_POINTS + 1, (0.5, 1.5)))
    rng = np.random.RandomState(1)
    out = {}
    for label, f_model, widths, n, (lo, hi) in cases:
        n_out = widths[-1]
        reqs = analyze_f_model(f_model, ("x", "t"), n_out)
        if reqs is None:
            fail(f"K3 {label}: the residual does not analyse")
        layers = neural_net(widths, device=dev, seed=0).layers()
        sq = build_minimax_sq_fn(f_model, ("x", "t"), n_out, reqs,
                                 [tuple(W.shape) for W, _ in layers])
        plan = sq.plan
        X = torch.as_tensor(np.stack([rng.uniform(lo, hi, n),
                                      rng.uniform(0, 1, n)], 1),
                            dtype=torch.float32, device=dev)
        # w = lambda^2, lambda ~ U[0, 1] per point and equation
        w = torch.as_tensor(rng.rand(n, plan.E) ** 2, dtype=torch.float32,
                            device=dev)
        flat_layers = [a.detach() if a.ndim == 2 else
                       a.detach().reshape(1, -1)
                       for pair in layers for a in pair]
        flat = plan.pack(flat_layers)
        before = cm.k3_minimax.launches
        val, dflat, gw, gX = cm.k3_minimax(plan, X, w, flat)
        torch.cuda.synchronize()
        p_val, p_flat, p_gw, p_gX = sq.plain(flat_layers, w, X)
        got = [val.reshape(1)] + [g.reshape(-1) for g in plan.unpack(dflat)] \
            + [gw, gX]
        want = [p_val.reshape(1)] + [g.reshape(-1) for g in p_flat] \
            + [p_gw, p_gX]
        if not all(bool(torch.isfinite(g).all()) for g in got):
            fail(f"K3 {label}: non-finite output")
        k3_abs, k3_rel = 0.0, 0.0
        for a_k, a_p in zip(got, want):
            a, r = scaled_err(a_k, a_p)
            k3_abs, k3_rel = max(k3_abs, a), max(k3_rel, r)
        print(f"[K3 {label}] C={plan.C} E={plan.E} N={n} tape "
              f"{len(plan.tape.ops)} ops, value {float(val):.6e} (plain "
              f"{float(p_val):.6e}) max_abs_err={k3_abs:.3e} "
              f"scale_rel_err={k3_rel:.3e} (tol {K3_RTOL:g} on it)",
              flush=True)
        if not k3_rel <= K3_RTOL:
            fail(f"K3 disagrees with its plain flavor ({label})")
        ms = cuda_ms(lambda: cm.k3_minimax(plan, X, w, flat))
        plain_ms = cuda_ms(lambda: sq.plain(flat_layers, w, X), reps=5)
        # comparison launches are not the main path's: restore the count
        cm.k3_minimax.launches = before
        bound = bound_ms(cm.flop_count(plan, n)["k3"],
                         cm.byte_count(plan, n)["k3"])
        print(f"[time K3 {label}] K3 {ms:.3f} ms (plain fwd+bwd "
              f"{plain_ms:.3f} ms), {bound_text(ms, bound)}", flush=True)
        out[label] = dict(max_abs_err=k3_abs, ms=ms, plain_ms=plain_ms,
                          bound=bound)
    return out["ac"]


def phase_yardstick(dev) -> dict:
    """What the card's own f32 GEMM does on the slice's hidden-layer
    products: torch.matmul with TF32 off on [N*C, 128] x [128, 128] (C = 4),
    the forward H W, dW = H^T dP and dH = dP W^T, three of each as in one
    K2 or K3 launch (K1 takes the three forward ones).  A yardstick only:
    the port never calls it."""
    import torch
    g = torch.Generator(device=dev).manual_seed(0)
    rows = N_POINTS * 4
    H = torch.rand(rows, 128, generator=g, device=dev) * 2 - 1
    dP = torch.randn(rows, 128, generator=g, device=dev)
    W = torch.randn(128, 128, generator=g, device=dev) / 128 ** 0.5
    fwd = cuda_ms(lambda: [H @ W for _ in range(3)], reps=10)
    dw = cuda_ms(lambda: [H.t() @ dP for _ in range(3)], reps=10)
    dh = cuda_ms(lambda: [dP @ W.t() for _ in range(3)], reps=10)
    print(f"[yardstick] torch.matmul f32 (allow_tf32=False), [{rows}, 128] x "
          f"[128, 128], three of each: forward {fwd:.3f} ms, dW {dw:.3f} ms,"
          f" dH {dh:.3f} ms; the nine of K2/K3 {fwd + dw + dh:.3f} ms, the "
          f"three of K1 {fwd:.3f} ms (cuBLAS, not used by the port)",
          flush=True)
    return dict(fwd_ms=fwd, dw_ms=dw, dh_ms=dh)


def ac_sa_problem(n_f: int = N_POINTS, grid=(512, 201), seed: int = 0):
    """The Allen-Cahn SA-PINN at its full size (the JAX package's zoo entry
    ``allen-cahn-sa``, size ``full``): u_t - 1e-4 u_xx + 5u^3 - 5u = 0 on
    [-1, 1] x [0, 1], IC x^2 cos(pi x), periodic (u, u_x) in x; per-point
    lambda_res ~ U[0,1] and lambda_IC ~ 100 U[0,1], Adaptive_type=1."""
    import tensordiffeq_tpu_torch as tdqt
    from tensordiffeq_tpu_torch import grad

    nx, nt = grid
    domain = tdqt.DomainND(["x", "t"], time_var="t")
    domain.add("x", [-1.0, 1.0], nx)
    domain.add("t", [0.0, 1.0], nt)
    domain.generate_collocation_points(n_f, seed=seed)

    def func_ic(x):
        return x ** 2 * np.cos(np.pi * x)

    def deriv_model(u, x, t):
        return u(x, t), grad(u, "x")(x, t)

    bcs = [tdqt.IC(domain, [func_ic], var=[["x"]]),
           tdqt.periodicBC(domain, ["x"], [deriv_model])]

    def f_model(u, x, t):
        u_xx = grad(grad(u, "x"), "x")
        u_t = grad(u, "t")
        uv = u(x, t)
        return u_t(x, t) - 0.0001 * u_xx(x, t) + 5.0 * uv ** 3 - 5.0 * uv

    rng = np.random.RandomState(seed)
    compile_kw = dict(
        Adaptive_type=1,
        dict_adaptive={"residual": [True], "BCs": [True, False]},
        init_weights={"residual": [rng.rand(n_f, 1)],
                      "BCs": [100.0 * rng.rand(nx, 1), None]})
    return domain, bcs, f_model, compile_kw


def _counts() -> dict:
    from tensordiffeq_tpu_torch.ops import cuda_minimax as cm
    from tensordiffeq_tpu_torch.ops import cuda_taylor as ct
    return {"k1": ct.k1_forward.launches, "k2": ct.k2_backward.launches,
            "k3": cm.k3_minimax.launches}


def phase_slice(tf_iter: int, minimax) -> dict:
    """Phases 6 and 7: compile + fit + predict through fused="cuda" with
    ``minimax`` (None: the default, which adopts K3; False: the unfused
    loss), with the kernels' launch counts set to 0 just before and read
    after compile, fit and predict."""
    import torch
    import tensordiffeq_tpu_torch as tdqt
    from tensordiffeq_tpu_torch.exact import allen_cahn_solution
    from tensordiffeq_tpu_torch.ops import cuda_taylor as ct
    from tensordiffeq_tpu_torch.training import graphs

    tag = "minimax" if minimax is None else "unfused"
    want_engine = "fused-minimax-cuda" if minimax is None else "fused-cuda"
    domain, bcs, f_model, kw = ac_sa_problem()
    lam0 = {"residual": kw["init_weights"]["residual"][0].astype(np.float32),
            "IC": kw["init_weights"]["BCs"][0].astype(np.float32)}
    x, t, usol = allen_cahn_solution()
    X_star = np.stack(np.meshgrid(x, t, indexing="ij"), -1).reshape(-1, 2)

    ct.reset_launch_counts()
    solver = tdqt.CollocationSolverND(verbose=False, seed=0)
    t0 = time.perf_counter()
    if minimax is None:  # the default
        solver.compile(WIDTHS, f_model, domain, bcs, fused="cuda", **kw)
    else:
        solver.compile(WIDTHS, f_model, domain, bcs, fused="cuda",
                       minimax=minimax, **kw)
    torch.cuda.synchronize()
    t_compile = time.perf_counter() - t0
    if solver.engine != want_engine:
        fail(f"solver engine is {solver.engine}, expected {want_engine} "
             f"(minimax not adopted: {solver._minimax_fail_reason!r})")
    at_compile = _counts()
    c0 = len(graphs.captures)
    t0 = time.perf_counter()
    solver.fit(tf_iter=tf_iter)
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    at_fit = _counts()
    _captures_since(f"slice {tag}", c0)
    t0 = time.perf_counter()
    u_pred, f_pred = solver.predict(X_star)
    t_pred = time.perf_counter() - t0
    launches = _counts()
    in_fit = {k: at_fit[k] - at_compile[k] for k in launches}

    total = np.array([r["Total Loss"] for r in solver.losses])
    lam_res = solver.lambdas["residual"][0].detach().cpu().numpy()
    lam_ic = solver.lambdas["BCs"][0].detach().cpu().numpy()
    rel_l2 = tdqt.find_L2_error(u_pred, usol.reshape(-1, 1))
    ms_step = 1e3 * t_fit / tf_iter
    print(f"[slice {tag}] engine {solver.engine}; compile {t_compile:.2f} s,"
          f" fit {tf_iter} epochs {t_fit:.2f} s = {ms_step:.3f} ms/step, "
          f"predict {X_star.shape[0]} pts {t_pred:.3f} s", flush=True)
    print(f"[slice {tag}] loss epoch 0 {total[0]:.6e} -> epoch {tf_iter - 1}"
          f" {total[-1]:.6e} (min {total.min():.6e}); rel-L2 vs ETDRK4 "
          f"{rel_l2:.4f}; |d lambda_res| max "
          f"{np.abs(lam_res - lam0['residual']).max():.3e}, |d lambda_IC| "
          f"max {np.abs(lam_ic - lam0['IC']).max():.3e}", flush=True)
    print(f"[slice {tag}] launches after compile {at_compile}, in fit "
          f"{in_fit}, in all {launches}", flush=True)
    if not (np.all(np.isfinite(total)) and total[-1] < total[0]):
        fail("the loss did not fall (or is not finite)")
    if not (np.abs(lam_res - lam0["residual"]).max() > 0
            and np.abs(lam_ic - lam0["IC"]).max() > 0):
        fail("the SA lambdas did not move")
    if u_pred.shape != (X_star.shape[0], 1) or not (
            np.all(np.isfinite(u_pred)) and np.all(np.isfinite(f_pred))):
        fail("predict is not finite / has the wrong shape")
    if minimax is None:
        # K3: once in compile's cross-check, once per Adam step; K1 and K2
        # only outside fit (compile's fused-residual check and predict)
        if solver._minimax_kind != "cuda":
            fail(f"_minimax_kind is {solver._minimax_kind!r}, not 'cuda'")
        if not (at_compile["k3"] == 1 and in_fit["k3"] == tf_iter
                and launches["k3"] == 1 + tf_iter):
            fail(f"K3 launches {launches['k3']} != the cross-check + "
                 f"{tf_iter} steps")
        if in_fit["k1"] or in_fit["k2"] or not (launches["k1"]
                                                and launches["k2"]):
            fail(f"K1/K2 ran in the minimax fit or not at all: {in_fit}")
    elif not (in_fit["k1"] == in_fit["k2"] == tf_iter and not launches["k3"]):
        fail(f"the unfused path did not go through K1/K2 per step: {in_fit}")
    return dict(launches=launches, ms_step=ms_step, rel_l2=rel_l2,
                solver=solver)


def _lbfgs_counts() -> tuple:
    from tensordiffeq_tpu_torch.training.lbfgs import lbfgs_minimize
    return lbfgs_minimize.evaluations, lbfgs_minimize.host_syncs


def _time_lbfgs_parts(solver) -> dict:
    """One evaluation of the L-BFGS objective (loss and gradient at the
    flat parameters, K3 on this path), one two-loop sweep over a full
    memory of 50 pairs at the net's 50,049 parameters and one fixed-step
    iteration, each a replayed graph timed alone (host clock around 10
    calls ending in a synchronisation), and the host's time to issue one
    replay of each (the device idle before); then ``STEADY_ITER``
    line-search iterations past the graphs' warm-up and capture.  Restores
    the kernels' launch counts."""
    import torch
    from tensordiffeq_tpu_torch.ops import cuda_minimax as cm
    from tensordiffeq_tpu_torch.training import graphs
    from tensordiffeq_tpu_torch.training import lbfgs as tl
    from tensordiffeq_tpu_torch.utils import ieee_f32

    before = (cm.k3_minimax.launches, _lbfgs_counts())
    layers = solver.net.layers()
    fun = tl.lbfgs_objective(solver.loss_fn, solver.lambdas, solver.X_f,
                             tl.layer_shapes(layers))
    x = tl.flatten_layers(layers)
    g = torch.Generator(device=x.device).manual_seed(0)
    ev = tl._Evaluator(fun, x)
    ev.aim(x)
    mem = tl._Memory(x, 50)
    for _ in range(51):  # fill every slot (warm-ups and capture first)
        mem.precondition(x + torch.randn(x.shape, generator=g,
                                         device=x.device),
                         torch.randn(x.shape, generator=g, device=x.device))

    def host_ms(fn, reps=10):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / reps

    def launch_ms(graph, reps=10, before=lambda: None):
        total = 0.0
        for _ in range(reps):
            before()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            graph.replay()
            total += time.perf_counter() - t0
        torch.cuda.synchronize()
        return 1e3 * total / reps

    with ieee_f32():
        for _ in range(graphs.WARMUP_RUNS):
            ev()
        eval_ms = host_ms(ev)
        fixed = tl._FixedStep(ev, tl._Memory(x, 50), tl._Best(x), 0.8, 1)
        for _ in range(graphs.WARMUP_RUNS):
            fixed.row.zero_()
            fixed.graph()
        fixed_ms = host_ms(lambda: (fixed.row.zero_(), fixed.graph()))
    steady_ms = _lbfgs_past_capture(solver, STEADY_ITER)
    direction_ms = host_ms(lambda: mem.precondition(x, x))
    launches = {"evaluation": launch_ms(ev.graph.graph),
                "sweep": launch_ms(mem.graph.graph),
                # its history row starts over before each replay
                "fixed-step": launch_ms(fixed.graph.graph,
                                        before=fixed.row.zero_)}
    cm.k3_minimax.launches = before[0]
    (tl.lbfgs_minimize.evaluations, tl.lbfgs_minimize.host_syncs) = before[1]
    return dict(eval_ms=eval_ms, direction_ms=direction_ms,
                fixed_ms=fixed_ms, steady_ms=steady_ms,
                launch_ms=launches, n_params=int(x.numel()))


def phase_refine(paths: dict) -> dict:
    """Phase 8: the refinement slice on the minimax solver of phase 6 (after
    its Adam steps), with the kernels' launch counts set to 0 just before
    each L-BFGS leg and read just after; then the checkpoint leg."""
    import torch
    import tensordiffeq_tpu_torch as tdqt
    from tensordiffeq_tpu_torch.exact import allen_cahn_solution
    from tensordiffeq_tpu_torch.ops import cuda_taylor as ct
    from tensordiffeq_tpu_torch.training import graphs

    solver = paths["minimax"]["solver"]
    n_adam = len(solver.losses)
    adam_last = solver.losses[-1]["Total Loss"]
    x, t, usol = allen_cahn_solution()
    X_star = np.stack(np.meshgrid(x, t, indexing="ij"), -1).reshape(-1, 2)

    # the line-search leg
    ct.reset_launch_counts()
    e0, s0 = _lbfgs_counts()
    c0 = len(graphs.captures)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solver.fit(newton_iter=LBFGS_ITER)
    torch.cuda.synchronize()
    t_leg = time.perf_counter() - t0
    zoom = _counts()
    evals, syncs = (b - a for a, b in zip((e0, s0), _lbfgs_counts()))
    _captures_since("refine lbfgs", c0)
    iters = len(solver.losses) - n_adam
    hist = np.array([r["Total Loss"] for r in solver.losses[n_adam:]])
    u_best, _ = solver.predict(X_star, best_model=True)
    rel_l2 = tdqt.find_L2_error(u_best, usol.reshape(-1, 1))
    ms_iter = 1e3 * t_leg / max(iters, 1)
    print(f"[refine lbfgs] {iters} iterations in {t_leg:.2f} s = "
          f"{ms_iter:.3f} ms/iteration; {evals} evaluations "
          f"({evals / max(iters, 1):.3f}/iteration), {syncs} host syncs "
          f"({syncs / max(iters, 1):.3f}/iteration); launches {zoom}",
          flush=True)
    print(f"[refine lbfgs] loss {adam_last:.6e} (last Adam step) -> "
          f"{hist[-1]:.6e}, best {solver.min_loss['l-bfgs']:.6e} at "
          f"iteration {solver.best_epoch['l-bfgs']}; predict(best_model="
          f"True) rel-L2 vs ETDRK4 {rel_l2:.4f} (overall best: "
          f"{solver.best_epoch['overall']}, "
          f"{solver.min_loss['overall']:.6e})", flush=True)
    if not (zoom["k3"] == evals and zoom["k3"] > 0):
        fail(f"K3 launched {zoom['k3']} times for {evals} L-BFGS "
             "evaluations")
    if zoom["k1"] or zoom["k2"]:
        fail(f"K1/K2 ran in the L-BFGS leg: {zoom}")
    best = solver.min_loss["l-bfgs"]
    if not (np.isfinite(best) and best < adam_last):
        fail(f"the L-BFGS best loss {best} is not below the Adam leg's last "
             f"{adam_last}")
    if solver.newton_done != iters or iters <= 0:
        fail(f"newton_done {solver.newton_done} != the {iters} iterations "
             "in the history")

    # where an iteration's time goes
    parts = _time_lbfgs_parts(solver)
    per_iter = evals / max(iters, 1)
    rest = ms_iter - per_iter * parts["eval_ms"] - parts["direction_ms"]
    print(f"[refine split] per iteration: {per_iter:.3f} evaluations x "
          f"{parts['eval_ms']:.3f} ms (loss + gradient, timed alone) + "
          f"two-loop sweep {parts['direction_ms']:.3f} ms (50 pairs, "
          f"{parts['n_params']} parameters, timed alone) + the rest "
          f"{rest:.3f} ms (line-search arithmetic, syncs, best select, the "
          f"graphs' warm-up and capture)", flush=True)
    print(f"[refine steady] past the warm-up and capture: line search "
          f"{parts['steady_ms']:.3f} ms/iteration ({STEADY_ITER} "
          f"iterations), fixed step {parts['fixed_ms']:.3f} ms/iteration "
          f"(its graph timed alone); host time to issue one replay: "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in
                      parts["launch_ms"].items()), flush=True)

    # the fixed-step leg
    ct.reset_launch_counts()
    e0, s0 = _lbfgs_counts()
    c0 = len(graphs.captures)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solver.fit(newton_iter=EAGER_ITER, newton_eager=True)
    torch.cuda.synchronize()
    t_eager = time.perf_counter() - t0
    eager = _counts()
    e_evals, e_syncs = (b - a for a, b in zip((e0, s0), _lbfgs_counts()))
    _captures_since("refine fixed-step", c0)
    print(f"[refine fixed-step] {EAGER_ITER} iterations in {t_eager:.2f} s "
          f"= {1e3 * t_eager / EAGER_ITER:.3f} ms/iteration; {e_evals} "
          f"evaluations, {e_syncs} host syncs; launches {eager}", flush=True)
    if eager["k3"] != EAGER_ITER or e_evals != EAGER_ITER \
            or eager["k1"] or eager["k2"]:
        fail(f"the fixed-step leg launched {eager}, not K3 x {EAGER_ITER}")

    resume = phase_checkpoint(solver)
    return dict(launches={k: zoom[k] + eager[k] for k in zoom},
                ms_iter=ms_iter, evals_per_iter=per_iter,
                syncs_per_iter=syncs / max(iters, 1), rel_l2=rel_l2,
                eager_syncs=e_syncs, **parts, **resume)


def phase_checkpoint(solver) -> dict:
    """Phase 8, the checkpoint leg: save the trained solver, restore it into
    a fresh solver compiled the same way on the card; the loss and
    ``RESUME_STEPS`` more Adam steps on both must agree bit for bit.  Then
    a checkpoint taken mid-L-BFGS restores ``newton_done`` and the
    iterate."""
    import tempfile

    import torch
    import tensordiffeq_tpu_torch as tdqt

    def fresh():
        domain, bcs, f_model, kw = ac_sa_problem()
        s = tdqt.CollocationSolverND(verbose=False, seed=1)
        s.compile(WIDTHS, f_model, domain, bcs, fused="cuda", **kw)
        return s

    with tempfile.TemporaryDirectory() as tmp:
        ck = f"{tmp}/ck"
        t0 = time.perf_counter()
        solver.save_checkpoint(ck)
        t_save = time.perf_counter() - t0
        other = fresh()
        t0 = time.perf_counter()
        other.restore_checkpoint(ck)
        t_restore = time.perf_counter() - t0
        if other.X_f.device.type != "cuda" or not all(
                p.is_cuda for pair in other.net.layers() for p in pair):
            fail("the restored state is not on the card")
        a = float(solver.update_loss()[0].detach())
        b = float(other.update_loss()[0].detach())
        n0 = len(solver.losses)
        solver.fit(tf_iter=RESUME_STEPS)
        other.fit(tf_iter=RESUME_STEPS)
        ha = [r["Total Loss"] for r in solver.losses[n0:]]
        hb = [r["Total Loss"] for r in other.losses[n0:]]
        print(f"[checkpoint] save {t_save:.3f} s, restore {t_restore:.3f} s;"
              f" update_loss {a!r} vs restored {b!r}; {RESUME_STEPS} Adam "
              f"steps each: {ha[-1]!r} vs {hb[-1]!r}", flush=True)
        if a != b:
            fail("the restored solver's loss differs from the saved one's")
        if ha != hb:
            fail("the restored solver's Adam steps differ from the saved "
                 "one's")

        mid = f"{tmp}/mid"
        solver.fit(newton_iter=10, checkpoint_dir=mid, checkpoint_every=10)
        third = fresh()
        third.restore_checkpoint(mid)
        same = all(torch.equal(p, q) for p, q in zip(
            [t for pair in solver.net.layers() for t in pair],
            [t for pair in third.net.layers() for t in pair]))
        print(f"[checkpoint] mid-L-BFGS: newton_done {third.newton_done} "
              f"(saved solver {solver.newton_done}), iterate "
              f"{'identical' if same else 'DIFFERS'}", flush=True)
        if third.newton_done != solver.newton_done or not same:
            fail("the mid-L-BFGS checkpoint did not bring back newton_done "
                 "and the iterate")
    return dict(save_s=t_save, restore_s=t_restore)


def _captures_since(tag: str, since: int) -> list:
    """Print the graph captures made since ``since``: their seconds and the
    device memory their pools took (``torch.cuda.memory_reserved`` across
    the capture)."""
    from tensordiffeq_tpu_torch.training import graphs
    new = graphs.captures[since:]
    if new:
        print(f"[graphs {tag}] {len(new)} captures: " + "; ".join(
            f"{c['name']} {c['seconds']:.3f} s, pool "
            f"{c['pool_bytes'] / 2 ** 20:.1f} MiB" for c in new), flush=True)
    if any(c["pool_bytes"] < 0 for c in new):
        # the allocator gave memory back across a capture: the capture
        # released the cache, which costs more than the capture itself
        fail(f"a graph pool read negative: {new}")
    return new


def _fresh_solver(minimax=None, seed: int = 0):
    """The slice's solver, compiled as phases 6 and 7 compile it."""
    import tensordiffeq_tpu_torch as tdqt
    domain, bcs, f_model, kw = ac_sa_problem()
    s = tdqt.CollocationSolverND(verbose=False, seed=seed)
    if minimax is not None:
        kw = dict(kw, minimax=minimax)
    s.compile(WIDTHS, f_model, domain, bcs, fused="cuda", **kw)
    return s


def _timed_fit(solver, **kw) -> float:
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solver.fit(**kw)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _state_diff(a, b, since: int = 0) -> float:
    """The largest scale-relative difference between two solvers' loss
    histories (from row ``since``), parameters and λ: 0.0 when every one is
    bit-identical."""
    rows_a, rows_b = a.losses[since:], b.losses[since:]
    if len(rows_a) != len(rows_b):
        return float("inf")
    pairs = [(np.array([r[k] for r in rows_a for k in sorted(r)]),
              np.array([r[k] for r in rows_b for k in sorted(r)]))]
    for sa, sb in ((a.net.params(), b.net.params()),
                   (a.lambdas["residual"] + a.lambdas["BCs"],
                    b.lambdas["residual"] + b.lambdas["BCs"])):
        flat_a = [t for x in sa for t in (x if isinstance(x, tuple) else (x,))
                  if t is not None]
        flat_b = [t for x in sb for t in (x if isinstance(x, tuple) else (x,))
                  if t is not None]
        pairs += [(p.detach().float().cpu().numpy(),
                   q.detach().float().cpu().numpy())
                  for p, q in zip(flat_a, flat_b)]
    worst = 0.0
    for x, y in pairs:
        if not np.array_equal(x, y):
            worst = max(worst, float(np.abs(x - y).max())
                        / max(float(np.abs(y).max()), 1e-30))
    return worst


def phase_graphs():
    """Phase 9: the graphs against their eager referee on each path (Adam;
    on the minimax path also both L-BFGS rules), then the minibatch leg and
    the clipping leg."""
    from tensordiffeq_tpu_torch.ops import cuda_taylor as ct
    from tensordiffeq_tpu_torch.ops import minimax as mmx
    from tensordiffeq_tpu_torch.training import graphs

    def held(tag, leg, graph, eager, n, unit, since, **kw):
        c0 = len(graphs.captures)
        t_g = _timed_fit(graph, **kw)
        t_e = _timed_fit(eager, _graphs=False, **kw)
        diff = _state_diff(graph, eager, since)
        same = ("bit-identical" if diff == 0 else
                f"max scale-relative difference {diff:.3e} (band "
                f"{GRAPH_BAND:g})")
        print(f"[graph {tag} {leg}] {n} {unit}s each way: graphs "
              f"{1e3 * t_g / n:.3f} ms/{unit}, eager {1e3 * t_e / n:.3f} "
              f"ms/{unit}; graph vs eager: {same}", flush=True)
        _captures_since(f"{tag} {leg}", c0)
        if not diff <= GRAPH_BAND:
            fail(f"the {tag} {leg} graphs differ from their eager referee "
                 f"by {diff:.3e}")

    for tag, minimax in (("minimax", None), ("unfused", False)):
        graph, eager = _fresh_solver(minimax), _fresh_solver(minimax)
        # the first turn warms up and captures the step; the second replays
        held(tag, "adam", graph, eager, REFEREE_STEPS, "step", 0,
             tf_iter=REFEREE_STEPS)
        held(tag, "adam, replays only", graph, eager, REFEREE_STEPS, "step",
             0, tf_iter=REFEREE_STEPS)
        if minimax is None:
            n0 = len(graph.losses)
            held(tag, "lbfgs", graph, eager, REFEREE_ITER, "iteration", n0,
                 newton_iter=REFEREE_ITER)
            n0 = len(graph.losses)
            held(tag, "fixed-step", graph, eager, REFEREE_ITER, "iteration",
                 n0, newton_iter=REFEREE_ITER, newton_eager=True)

    # minibatches: K3 once per batch, each at N = batch_sz
    solver = _fresh_solver()
    sizes = []
    k3 = mmx.FLAVORS[None]  # the f32 K3 the minimax unit launches

    def spy(plan, X, w, flat):  # runs at the warm-ups and the capture
        sizes.append(int(X.shape[0]))
        return k3(plan, X, w, flat)

    mmx.FLAVORS[None] = spy
    ct.reset_launch_counts()
    try:
        t = _timed_fit(solver, tf_iter=BATCH_EPOCHS, batch_sz=BATCH_SZ)
    finally:
        mmx.FLAVORS[None] = k3
    launches = _counts()
    n_b = solver._adam.n_batches
    total = np.array([r["Total Loss"] for r in solver.losses])
    print(f"[batch] batch_sz {BATCH_SZ}: {n_b} batches per epoch ("
          f"{n_b * BATCH_SZ - N_POINTS} rows wrapped), {BATCH_EPOCHS} epochs "
          f"in {t:.2f} s = {1e3 * t / (BATCH_EPOCHS * n_b):.3f} ms/step; K3 "
          f"at N = {sorted(set(sizes))}; launches {launches}; loss epoch 0 "
          f"{total[0]:.6e} -> {total[-1]:.6e}", flush=True)
    want = BATCH_EPOCHS * -(-N_POINTS // BATCH_SZ)
    if n_b != 4 or launches["k3"] != want or launches["k1"] \
            or launches["k2"] or set(sizes) != {BATCH_SZ}:
        fail(f"the minibatch leg launched {launches} over {n_b} batches at "
             f"N = {sorted(set(sizes))}, not K3 x {want} at {BATCH_SZ}")
    if not (np.all(np.isfinite(total)) and total[-1] < total[0]):
        fail("the minibatch leg's loss did not fall")

    # global-norm clipping, held to its eager referee
    graph, eager = _fresh_solver(), _fresh_solver()
    ct.reset_launch_counts()
    held("minimax", f"grad_clip={CLIP:g}", graph, eager, CLIP_STEPS, "step",
         0, tf_iter=CLIP_STEPS, grad_clip=CLIP)
    total = np.array([r["Total Loss"] for r in graph.losses])
    if not (np.all(np.isfinite(total)) and total[-1] < total[0]):
        fail("the grad_clip leg's loss did not fall")
    if _counts()["k3"] != 2 * CLIP_STEPS:  # both solvers' steps
        fail(f"the grad_clip leg launched {_counts()}")


def phase_ab(paths: dict, steps: int = AB_STEPS) -> dict:
    """``--profile``: ``steps`` more Adam steps of each trained solver per
    turn, in the order minimax, unfused, unfused, minimax, twice; ms/step
    per turn."""
    import torch
    turns = {tag: [] for tag in ("minimax", "unfused")}
    for tag in ("minimax", "unfused", "unfused", "minimax") * 2:
        solver = paths[tag]["solver"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solver.fit(tf_iter=steps, chunk=steps)
        torch.cuda.synchronize()
        turns[tag].append(1e3 * (time.perf_counter() - t0) / steps)
    print("[A/B] ms/step of each path's turns (run in the order minimax, "
          "unfused, unfused, minimax, twice): "
          + "; ".join(f"{tag} " + ", ".join(f"{ms:.3f}" for ms in v)
                      + f" (mean {np.mean(v):.3f})"
                      for tag, v in turns.items()), flush=True)
    return turns


def _kernel_group(name: str) -> str:
    low = name.lower()
    if "taylor_fwd" in low:
        return "K1 taylor_fwd_kernel"
    if "taylor_bwd" in low:
        return "K2 taylor_bwd_kernel"
    if "minimax_step" in low:
        return "K3 minimax_step_kernel"
    if "reduce_partials" in low:
        return "reduce_partials (K2's or K3's slot-ordered sum)"
    if "gemm" in low or "gemv" in low or "cutlass" in low:
        return "cuBLAS matmuls (BC terms, generic engine)"
    if "adam" in low or "multi_tensor" in low:
        return "Adam updates"
    return "other PyTorch kernels (pointwise, reductions, copies)"


def _lbfgs_past_capture(solver, n: int, prof=None) -> float:
    """Ms per line-search L-BFGS iteration of ``solver``'s objective over
    ``n`` iterations past those in which the evaluation and sweep graphs
    warm up and are captured: a ``fit_lbfgs`` leg whose chunk-boundary
    callback starts the clock (and ``prof``, a profiler, when given).  The
    solver is not changed."""
    import torch
    from tensordiffeq_tpu_torch.training import graphs
    from tensordiffeq_tpu_torch.training.lbfgs import fit_lbfgs

    skip = graphs.WARMUP_RUNS + 1
    t0 = []

    def start(done, *_):
        if done == skip:
            torch.cuda.synchronize()
            if prof is not None:
                prof.__enter__()
            t0.append(time.perf_counter())

    fit_lbfgs(solver.loss_fn, solver.net.layers(), solver.lambdas,
              solver.X_f, maxiter=skip + n, chunk=skip, callback=start,
              callback_every=skip, verbose=False)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0[0]) / n
    if prof is not None:
        prof.__exit__(None, None, None)
    return ms


def phase_profile(solver, tag: str, n_steps: int = 20, lbfgs: bool = False):
    """``--profile``: ``n_steps`` Adam steps (``lbfgs``: line-search L-BFGS
    iterations) of the trained slice under ``torch.profiler``: the host's
    time in each of the loop's ranges and its launches, device time by
    kernel group, the device's busy and idle share of the wall, the top
    kernels and host ops."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    spans = LBFGS_SPANS if lbfgs else HOST_SPANS
    if lbfgs:
        # the first window takes the profiler's start-up
        _lbfgs_past_capture(solver, 2, profile(activities=activities))
        prof = profile(activities=activities)
        wall_ms = n_steps * _lbfgs_past_capture(solver, n_steps, prof)
    else:
        solver.fit(tf_iter=5)  # warm
        torch.cuda.synchronize()
        # the profiler's first window carries its own start-up; keep it out
        with profile(activities=activities):
            solver.fit(tf_iter=2)
            torch.cuda.synchronize()
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            solver.fit(tf_iter=n_steps)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
    by_name, by_group, n_launch, n_host = {}, {}, 0, 0
    host = dict.fromkeys(spans, 0.0)
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CPU:
            if evt.name in host:
                host[evt.name] += evt.time_range.elapsed_us()
            n_host += evt.name in LAUNCH_CALLS
            continue
        if evt.device_type != torch.autograd.DeviceType.CUDA or getattr(
                evt, "is_user_annotation", False):
            continue
        us = evt.time_range.elapsed_us()
        by_name[evt.name] = by_name.get(evt.name, 0.0) + us
        grp = _kernel_group(evt.name)
        by_group[grp] = by_group.get(grp, 0.0) + us
        n_launch += 1
    busy_ms = sum(by_group.values()) / 1e3
    if busy_ms <= 0:
        fail("the profiler saw no device time")
    if not all(host.values()):
        fail(f"the profiler missed a range of the loop: {host}")
    unit = "iteration" if lbfgs else "step"
    print(f"[host {tag}] {n_steps} {unit}s, host ms/{unit} in the loop's "
          f"ranges (under the profiler): "
          + ", ".join(f"{k} {us / 1e3 / n_steps:.3f}"
                      for k, us in host.items()), flush=True)
    print(f"[profile {tag}] {n_steps} {unit}s: wall {wall_ms / n_steps:.3f} "
          f"ms/{unit}, device busy {busy_ms / n_steps:.3f} ms/{unit} "
          f"({100 * busy_ms / wall_ms:.1f}% busy, "
          f"{100 * (1 - busy_ms / wall_ms):.1f}% idle), "
          f"{n_launch / n_steps:.0f} kernels/{unit} on the device, "
          f"{n_host / n_steps:.1f} host launches/{unit} ("
          + ", ".join(LAUNCH_CALLS) + ")", flush=True)
    for grp, us in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"[profile]   {us / 1e3 / n_steps:8.3f} ms/{unit}  {grp}",
              flush=True)
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        print(f"[profile]     {us / 1e3 / n_steps:8.3f} ms/{unit}  "
              f"{name[:90]}", flush=True)
    ops = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    for e in ops[:8]:
        print(f"[profile] host {e.self_cpu_time_total / 1e3 / n_steps:8.3f} "
              f"ms/{unit} self, {e.count / n_steps:6.1f} calls/{unit}  "
              f"{e.key[:70]}", flush=True)


def _serve_leaves(out) -> list:
    return list(out) if isinstance(out, (tuple, list)) else [out]


def _bit_equal(a, b) -> bool:
    return all(np.array_equal(x, y) for x, y in
               zip(_serve_leaves(a), _serve_leaves(b)))


def _serve_eager(eng, spec: str, X: np.ndarray, bucket: int):
    """The kind's program run eagerly on ``X`` padded to ``bucket``: the
    graph's referee."""
    import torch
    from tensordiffeq_tpu_torch.utils import ieee_f32
    sur = eng.surrogate
    Xp = torch.zeros(bucket, X.shape[1], dtype=torch.float32,
                     device=sur.device)
    Xp[:X.shape[0]] = torch.from_numpy(X)
    with ieee_f32(), torch.no_grad():
        out = eng.make_batched(spec)()(sur.params, Xp)
    return [o[:X.shape[0]].cpu().numpy() for o in _serve_leaves(out)]


def _serve_queries(rng, n_queries: int, max_rows: int) -> list:
    sizes = np.exp(rng.uniform(0.0, np.log(max_rows), n_queries))
    return [np.stack([rng.uniform(-1, 1, n), rng.uniform(0, 1, n)],
                     1).astype(np.float32)
            for n in np.maximum(sizes.astype(int), 1)]


def phase_serve(solver, card: str) -> dict:
    """Phase 10: the serving path on the trained minimax solver, with the
    kernels' launch counts set to 0 just before the engine's queries and
    read just after (serving launches none of K1-K3)."""
    import tempfile

    import torch
    import tensordiffeq_tpu_torch as tdqt
    from tensordiffeq_tpu_torch.exact import allen_cahn_solution
    from tensordiffeq_tpu_torch.ops import cuda_taylor as ct
    from tensordiffeq_tpu_torch.ops.fused import crosscheck_residuals
    from tensordiffeq_tpu_torch.serving import RequestBatcher, Surrogate
    from tensordiffeq_tpu_torch.training import graphs
    from tensordiffeq_tpu_torch.training.graphs import CudaGraph

    x, t, usol = allen_cahn_solution()
    X_grid = np.ascontiguousarray(np.stack(
        np.meshgrid(x, t, indexing="ij"), -1).reshape(-1, 2), np.float32)
    u_pred, f_pred = solver.predict(X_grid)
    rel_pred = tdqt.find_L2_error(u_pred, usol.reshape(-1, 1))

    # export, save, and load back with no solver object
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        solver.export_surrogate().save(f"{tmp}/ac")
        t_save = time.perf_counter() - t0
        t0 = time.perf_counter()
        sur = Surrogate.load(f"{tmp}/ac", f_model=_ac_residual)
        t_load = time.perf_counter() - t0
    eng = sur.engine(**SERVE_LADDER)
    if eng.n_buckets != 10:
        fail(f"the engine has {eng.n_buckets} rungs, not 10")

    rng = np.random.default_rng(0)
    queries = _serve_queries(rng, SERVE_QUERIES, SERVE_MAX_ROWS)
    reps = {eng.bucket_for(X_grid.shape[0]): X_grid}
    for Xq in queries:  # the first query of each rung
        reps.setdefault(eng.bucket_for(Xq.shape[0]), Xq)
    c0 = len(graphs.captures)
    ct.reset_launch_counts()
    first_ms, grid_ms, grid = {}, {}, {}
    for spec in SERVE_KINDS:
        op = eng.op_for(spec)
        for label, store in (("first", first_ms), ("warm", grid_ms)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            grid[spec] = op(X_grid)
            store[spec] = 1e3 * (time.perf_counter() - t0)
        for Xq in queries:
            op(Xq)
    launches = _counts()
    if any(launches.values()):
        fail(f"the serving path launched {launches}")

    # the graphs against their programs run eagerly, per touched rung
    mismatched = []
    for spec in SERVE_KINDS:
        op = eng.op_for(spec)
        for bucket, Xq in sorted(reps.items()):
            if not _bit_equal(op(Xq), _serve_eager(eng, spec, Xq, bucket)):
                mismatched.append(f"{spec} b={bucket}")
    rows = np.stack([rng.uniform(-1, 1, ROW_STABLE),
                     rng.uniform(0, 1, ROW_STABLE)], 1).astype(np.float32)
    pad = eng.bucket_for(ROW_STABLE) - ROW_STABLE
    others = np.stack([rng.uniform(-1, 1, pad),
                       rng.uniform(0, 1, pad)], 1).astype(np.float32)
    big = np.concatenate([others[:pad // 2], rows, others[pad // 2:]])
    unstable = [spec for spec in SERVE_KINDS
                if not _bit_equal(eng.op_for(spec)(rows),
                                  [a[pad // 2:pad // 2 + ROW_STABLE] for a in
                                   _serve_leaves(eng.op_for(spec)(big))])]
    print(f"[serve] graph vs eager at the padded shape on {len(reps)} rungs"
          f" x {len(SERVE_KINDS)} kinds: "
          f"{'bit-identical' if not mismatched else mismatched}; "
          f"{ROW_STABLE} rows alone vs inside {ROW_STABLE + pad} rows (rung "
          f"{eng.bucket_for(ROW_STABLE)}): "
          f"{'bit-identical' if not unstable else unstable}", flush=True)
    if mismatched:
        fail(f"graphs differ from their eager programs: {mismatched}")
    if unstable:
        fail(f"rows change with their neighbours: {unstable}")

    # the answers against the solver and each other
    u_err = scaled_err(torch.from_numpy(grid["u"]),
                       torch.from_numpy(u_pred))[1]
    u_ = grid["u"][:, 0].astype(np.float64)
    recombined = (grid["d:t:1"] - 1e-4 * grid["d:x:2"].astype(np.float64)
                  + 5.0 * u_ ** 3 - 5.0 * u_)
    res = grid["residual"].astype(np.float64)
    rec_err = float(np.abs(recombined - res).max() / np.abs(res).max())
    ok, why = crosscheck_residuals(grid["residual"], f_pred,
                                   rtol=SERVE_CROSSCHECK_RTOL)
    f_err = float(np.abs(grid["residual"] - f_pred).max()
                  / np.abs(grid["residual"]).max())
    rel_eng = tdqt.find_L2_error(grid["u"], usol.reshape(-1, 1))
    rel_gap = abs(rel_eng - rel_pred) / rel_pred
    print(f"[serve] u vs predict {u_err:.3e} scale-relative (band "
          f"{SERVE_U_BAND:g}); u_t - 1e-4 u_xx + 5u^3 - 5u vs residual "
          f"{rec_err:.3e} (band {SERVE_RECOMBINE_BAND:g}); residual vs "
          f"predict's fused K1 engine {f_err:.3e} (cross-check rtol "
          f"{SERVE_CROSSCHECK_RTOL:g}); rel-L2 vs ETDRK4 {rel_eng:.6f}, "
          f"predict {rel_pred:.6f} (relative gap {rel_gap:.2e})", flush=True)
    if not u_err <= SERVE_U_BAND:
        fail("the engine's u differs from predict's")
    if not rec_err <= SERVE_RECOMBINE_BAND:
        fail("the derivative kinds do not recombine into the residual")
    if not ok:
        fail(f"the engine's residual fails the cross-check: {why}")
    if not rel_gap <= 1e-6:
        fail("the engine's rel-L2 differs from predict's")

    # one capture per program, none quarantined
    caps = [c for c in graphs.captures[c0:]
            if c["name"].startswith("serve ")]
    print(f"[serve] programs {eng.compile_cache_size} (bound "
          f"{len(SERVE_KINDS) * eng.n_buckets}), graph captures {len(caps)},"
          f" quarantined {eng.quarantined_buckets()}; shared pool "
          f"{sum(c['pool_bytes'] for c in caps) / 2 ** 20:.1f} MiB; launches "
          f"{launches}; save {t_save:.3f} s, load {t_load:.3f} s", flush=True)
    if eng.compile_cache_size > len(SERVE_KINDS) * eng.n_buckets \
            or len(caps) != eng.compile_cache_size \
            or eng.quarantined_buckets():
        fail("the ladder is not one graph per touched rung")
    if any(c["pool_bytes"] < 0 for c in caps):
        fail(f"a graph pool read negative: {caps}")

    # per rung: capture, pool, replay time
    by_name = {c["name"]: c for c in caps}
    sizes = eng.surrogate.layer_sizes
    # u's products per point; the other kinds' work is the jvp chains'
    u_flops = 2 * sum(a * b for a, b in zip(sizes[:-1], sizes[1:]))
    rungs = []
    for spec, bucket in [(k, b) for k in SERVE_KINDS
                         for b in eng.bucket_sizes]:
        rung = eng._rungs.get((eng.kind_key(spec), bucket))
        if rung is None:
            continue
        cap = by_name[rung.graph.name]
        ms = cuda_ms(rung.graph.graph.replay)
        rungs.append(dict(kind=spec, bucket=bucket, capture_s=cap["seconds"],
                          pool_mib=cap["pool_bytes"] / 2 ** 20, ms=ms))
        bound = ""
        if spec == "u":
            b_ms = 1e3 * u_flops * bucket / PEAK_FP32_FLOPS
            bound = (f", FP32-core bound {b_ms:.4f} ms ({100 * b_ms / ms:.1f}"
                     " % of it)")
        print(f"[serve {spec} b={bucket}] capture {cap['seconds']:.3f} s, "
              f"pool {cap['pool_bytes'] / 2 ** 20:.1f} MiB, {ms:.4f} "
              f"ms/replay, {bucket / ms * 1e3:.4g} points/s{bound} ({card})",
              flush=True)
    print(f"[serve grid] {X_grid.shape[0]} points, wall ms (host clock, "
          "copies in and out included) first touch / warm: "
          + ", ".join(f"{k} {first_ms[k]:.3f} / {grid_ms[k]:.3f}"
                      for k in SERVE_KINDS) + f" ({card})", flush=True)

    # the same traffic through private pools: the same answers
    private = sur.engine(**SERVE_LADDER)
    private._make_graph = CudaGraph  # a pool per graph
    p0 = len(graphs.captures)
    for spec in ("d:x:2", "residual"):
        for Xq in [X_grid] + queries:
            if not _bit_equal(private.op_for(spec)(Xq),
                              eng.op_for(spec)(Xq)):
                fail(f"{spec}: private pools answer otherwise than the "
                     "shared pool")
    shared = sum(c["pool_bytes"] for c in caps if c["name"].split()[1]
                 in ("d:0:2:0", "residual"))
    priv = sum(c["pool_bytes"] for c in graphs.captures[p0:])
    print(f"[serve pools] d:x:2 and residual over their {len(private._rungs)}"
          f" rungs: shared pool {shared / 2 ** 20:.1f} MiB, private pools "
          f"{priv / 2 ** 20:.1f} MiB; answers bit-identical", flush=True)
    del private

    # the batcher over the residual
    batch_rows = []

    def op(X):
        batch_rows.append(X.shape[0])
        return eng.residual(X)

    batcher = RequestBatcher(eng, op=op, max_batch=4096,
                             max_latency_s=0.002)
    reqs = [np.stack([rng.uniform(-1, 1, n), rng.uniform(0, 1, n)],
                     1).astype(np.float32)
            for n in rng.integers(1, BATCH_MAX_ROWS + 1, BATCH_REQUESTS)]
    handles = []
    for Xr in reqs:
        handles.append(batcher.submit(Xr))
        batcher.poll()
    got = [h.result() for h in handles]
    stats = batcher.stats()
    ends = np.cumsum(batch_rows)
    starts = np.cumsum([r.shape[0] for r in reqs]) - 1
    batch_of = np.searchsorted(ends, starts, side="right")
    worst = {"same rung": 0.0, "other rung": 0.0}
    scale = 0.0
    for Xr, g, b in zip(reqs, got, batch_of):
        want = eng.residual(Xr)
        where = ("same rung" if eng.bucket_for(batch_rows[b])
                 == eng.bucket_for(Xr.shape[0]) else "other rung")
        worst[where] = max(worst[where], float(np.abs(g - want).max()))
        scale = max(scale, float(np.abs(want).max()))
    worst = {k: v / scale for k, v in worst.items()}
    lat = stats["latency_s"]
    print(f"[serve batcher] {stats['requests']} requests in "
          f"{stats['batches']} batches, mean batch "
          f"{stats['points'] / stats['batches']:.1f} points, "
          f"{stats['qps']:.1f} requests/s, latency p50 "
          f"{1e3 * lat['p50']:.3f} ms, p90 {1e3 * lat['p90']:.3f} ms, p99 "
          f"{1e3 * lat['p99']:.3f} ms; against each request alone: same "
          f"rung {worst['same rung']:.3e}, other rung "
          f"{worst['other rung']:.3e} scale-relative ({card})", flush=True)
    if stats["requests"] != BATCH_REQUESTS or stats["failed"]:
        fail(f"the batcher served {stats}")
    if not (worst["same rung"] <= SERVE_U_BAND
            and worst["other rung"] <= SERVE_RECOMBINE_BAND):
        fail(f"batched answers differ from single ones: {worst}")
    if eng.quarantined_buckets():
        fail(f"rungs quarantined: {eng.quarantined_buckets()}")
    return dict(rungs=rungs, grid_ms=grid_ms, batcher=stats)


# --------------------------------------------------------------------- #
# phase 11: adaptive collocation; phase 12: the inverse problem
# --------------------------------------------------------------------- #
def _checked_adopt(log: list):
    """A wrapper of ``AdamStep.adopt`` that holds each swap's λ carry to
    its contract: kept rows' λ and λ moments are the old rows gathered, bit
    for bit; fresh rows' λ sit at the kept rows' mean and their moments at
    zero.  Appends one ``(kept, ok, why)`` per swap to ``log``."""
    import torch
    from tensordiffeq_tpu_torch.training import fit as tfit
    adopt = tfit.AdamStep.adopt

    def checked(self, X_new, swap=None):
        if swap is None:
            return adopt(self, X_new, swap)
        lam = self.lambdas["residual"][0]
        state = self.optimizers[1].state[lam]
        old = lam.detach().clone()
        moments = {k: state[k].clone() for k in ("exp_avg", "exp_avg_sq")}
        shape = tuple(self.X_f.shape)
        drift = adopt(self, X_new, swap)
        kept, rows = swap.kept, swap.idx[swap.kept]
        fresh = ~kept
        new = lam.detach()
        why = []
        if tuple(self.X_f.shape) != shape or not torch.equal(self.X_f,
                                                             X_new):
            why.append("X_f")
        if not torch.equal(new[kept], old[rows]):
            why.append("kept lambda")
        if int(fresh.sum()):
            mean = old[rows].mean(0)
            if not torch.allclose(new[fresh], mean.expand_as(new[fresh]),
                                  rtol=1e-6, atol=0):
                why.append("fresh lambda")
        for k, m in moments.items():
            if not torch.equal(state[k][kept], m[rows]) \
                    or bool(state[k][fresh].any()):
                why.append(k)
        log.append((int(kept.sum()), not why, why))
        return drift

    return adopt, checked


def _resample_fit(solver, tag: str, **kw) -> dict:
    """``fit`` with resampling on ``solver``, the launch counts set to 0
    just before and read just after, each swap's carry checked."""
    import torch
    from tensordiffeq_tpu_torch.ops import cuda_taylor as ct
    from tensordiffeq_tpu_torch.training import fit as tfit

    log = []
    adopt, checked = _checked_adopt(log)
    X_f = solver.X_f
    n0 = len(solver.redraws)
    ct.reset_launch_counts()
    tfit.AdamStep.adopt = checked
    try:
        t = _timed_fit(solver, **kw)
    finally:
        tfit.AdamStep.adopt = adopt
    launches = _counts()
    recs = solver.redraws[n0:]
    chunks = solver._adam_result.chunk_seconds
    n_step = kw["tf_iter"] // len(chunks)
    print(f"[resample {tag}] {kw['tf_iter']} steps in {t:.2f} s = "
          f"{1e3 * t / kw['tf_iter']:.3f} ms/step; launches {launches}; "
          f"captures {solver._adam.graph.captures}; loss "
          f"{solver.losses[-kw['tf_iter']]['Total Loss']:.6e} -> "
          f"{solver.losses[-1]['Total Loss']:.6e}", flush=True)
    for r in recs:
        stall = ("discarded" if r["adopted"] is None else
                 f"swapped at {r['adopted']}, host stall "
                 f"{1e3 * r['stall_s']:.3f} ms")
        print(f"[resample {tag}] redraw of epoch {r['epoch']}: device "
              f"{r['device_ms']:.3f} ms on its stream, dispatch "
              f"{1e3 * r['dispatch_s']:.3f} ms host, {stall}; "
              + ", ".join(f"{k} {v:.4g}" for k, v in r["stats"].items()),
              flush=True)
    print(f"[resample {tag}] chunk ms/step: "
          + ", ".join(f"{1e3 * c / n_step:.3f}" for c in chunks)
          + " (the first holds the warm-up and capture; the rest run with "
          "a redraw in flight)", flush=True)
    for kept, ok, why in log:
        print(f"[resample {tag}] swap: {kept} rows kept, carry "
              f"{'exact' if ok else 'WRONG: ' + ', '.join(why)}", flush=True)
    total = np.array([r["Total Loss"] for r in solver.losses])
    if solver.X_f is not X_f or tuple(X_f.shape) != (N_POINTS, 2):
        fail(f"{tag}: X_f was replaced or changed shape")
    captures = 0 if kw.get("_graphs") is False else 1
    if solver._adam.graph.captures != captures:
        fail(f"{tag}: the Adam graph was captured "
             f"{solver._adam.graph.captures} times across the swaps")
    if [(r["epoch"], r["adopted"]) for r in recs] != RESAMPLE_PLAN:
        fail(f"{tag}: redraws {[(r['epoch'], r['adopted']) for r in recs]}"
             f", expected {RESAMPLE_PLAN}")
    if len(log) != 2 or not all(ok for _, ok, _ in log):
        fail(f"{tag}: the swaps' carry broke its contract: {log}")
    if not np.all(np.isfinite(total)):
        fail(f"{tag}: the loss is not finite")
    return dict(launches=launches, seconds=t, records=recs, chunks=chunks,
                solver=solver)


def phase_resample(dev) -> dict:
    """Phase 11: adaptive collocation on AC-SA full through
    ``compile(fused="cuda")`` (K3 adopted): (a) K3 at w = 1 and (b) K1 at
    the pool's size against their plain flavors; (c) the pool redraw and
    (d) the ascent mover, 400 steps each with a redraw every 100; (e) each
    mode again eagerly from the same seed, held bit for bit."""
    import torch
    from tensordiffeq_tpu_torch.ops import cuda_minimax as cm
    from tensordiffeq_tpu_torch.ops import cuda_taylor as ct
    from tensordiffeq_tpu_torch.ops import resampling as rs
    from tensordiffeq_tpu_torch.ops.taylor import taylor_derivatives

    solver = _fresh_solver()
    layers = solver.net.layers()
    flat_layers = [a.detach() if a.ndim == 2 else a.detach().reshape(1, -1)
                   for pair in layers for a in pair]
    X = solver.X_f
    before = _counts()
    # (a) K3 at w = 1: the ascent mover's scores (sum of gw) and direction
    sg = solver._minimax_score_grad_fn()
    s_k, g_k = sg(layers, X)
    torch.cuda.synchronize()
    ones = torch.ones((N_POINTS, 1), device=dev)
    _, _, gw_p, g_p = solver._minimax_sq.plain(flat_layers, ones, X)
    s_p = gw_p.sum(1)
    a1, r1 = scaled_err(s_k, s_p)
    a2, r2 = scaled_err(g_k, g_p)
    ms = cuda_ms(lambda: sg(layers, X))
    plain_ms = cuda_ms(lambda: solver._minimax_sq.plain(flat_layers, ones, X),
                       reps=5)
    print(f"[K3 w=1] N={N_POINTS}: scores max_abs_err={a1:.3e} "
          f"scale_rel_err={r1:.3e}, gX max_abs_err={a2:.3e} scale_rel_err="
          f"{r2:.3e} (tol {K3_RTOL:g}); {ms:.3f} ms (plain {plain_ms:.3f} ms)",
          flush=True)
    if not (max(r1, r2) <= K3_RTOL and bool(torch.isfinite(s_k).all())):
        fail("K3 at w = 1 disagrees with its plain flavor")
    # (b) K1 over the pool: [X_f ; 3 N_f fresh]
    gen = rs.redraw_generator(0, 1, dev)
    pool = torch.cat([X, rs._stratified_pool(gen, 3 * N_POINTS,
                                              solver.domain.xlimits)])
    plan = ct.build_cuda_table_fn(solver._fuse_requests,
                                  [tuple(W.shape) for W, _ in layers],
                                  device=dev).plan
    flat = plan.pack(flat_layers)
    table = ct.k1_forward(plan, pool, flat)
    torch.cuda.synchronize()
    pairs = [(W.detach(), b.detach()) for W, b in layers]

    def plain_table():
        t = taylor_derivatives(pairs, pool, set(plan.channels),
                               flat_matmul=True)
        return torch.stack([t[mi] for mi in plan.channels])

    with torch.no_grad():
        ref = plain_table()
        k1_abs, k1_rel = 0.0, 0.0
        for c in range(plan.C):
            a, r = scaled_err(table[c], ref[c])
            k1_abs, k1_rel = max(k1_abs, a), max(k1_rel, r)
        k1_ms = cuda_ms(lambda: ct.k1_forward(plan, pool, flat))
        k1_plain = cuda_ms(plain_table, reps=5)
    n_pool = int(pool.shape[0])
    bound = bound_ms(ct.flop_count(plan, n_pool)["k1"],
                     ct.byte_count(plan, n_pool)["k1"])
    print(f"[K1 pool] N={n_pool}: max_abs_err={k1_abs:.3e} scale_rel_err="
          f"{k1_rel:.3e} (tol {K1_RTOL:g}); {k1_ms:.3f} ms (plain "
          f"{k1_plain:.3f} ms), {bound_text(k1_ms, bound)}", flush=True)
    if not k1_rel <= K1_RTOL:
        fail("K1 at the pool's size disagrees with its plain flavor")
    # comparison launches are not the main path's: restore the counts
    ct.k1_forward.launches, ct.k2_backward.launches, \
        cm.k3_minimax.launches = before["k1"], before["k2"], before["k3"]
    del solver, pool, table, ref

    out = {"w1": dict(max_abs_err=max(a1, a2), ms=ms, plain_ms=plain_ms),
           "pool_k1": dict(max_abs_err=k1_abs, ms=k1_ms, plain_ms=k1_plain,
                           bound=bound)}
    kw = dict(tf_iter=RESAMPLE_STEPS, chunk=RESAMPLE_EVERY,
              resample_every=RESAMPLE_EVERY)
    for mode in ("pool", "ascent"):
        want = ({"k1": 3, "k2": 0, "k3": RESAMPLE_STEPS} if mode == "pool"
                else {"k1": 0, "k2": 0, "k3": RESAMPLE_STEPS + 6 * 3})
        runs = {}
        for leg, graphs in (("graphs", True), ("eager", False)):
            res = runs[leg] = _resample_fit(
                _fresh_solver(), f"{mode} {leg}", resample_mode=mode,
                _graphs=graphs, **kw)
            if res["launches"] != want:
                fail(f"{mode} {leg}: launches {res['launches']}, expected "
                     f"{want}")
        # (e) two solvers from one seed, one graphed, one eager
        a, b = runs["graphs"]["solver"], runs["eager"]["solver"]
        diff = _state_diff(a, b)
        same_x = bool(torch.equal(a.X_f, b.X_f))
        print(f"[resample {mode}] graph vs eager from one seed: "
              + ("losses, parameters and lambda bit-identical" if diff == 0
                 else f"max scale-relative difference {diff:.3e}")
              + f"; X_f {'bit-identical' if same_x else 'DIFFERS'}",
              flush=True)
        if diff != 0 or not same_x:
            fail(f"{mode}: the graphed and the eager solver differ")
        # a chunk with a redraw in flight against one without, in turns:
        # each fit of two chunks dispatches a redraw after its first, so
        # the first runs alone and the second beside the redraw
        quiet, busy = [], []
        for _ in range(RESAMPLE_TURNS):
            _timed_fit(a, tf_iter=2 * RESAMPLE_EVERY, chunk=RESAMPLE_EVERY,
                       resample_every=RESAMPLE_EVERY, resample_mode=mode)
            q, b_ = a._adam_result.chunk_seconds
            quiet.append(1e3 * q / RESAMPLE_EVERY)
            busy.append(1e3 * b_ / RESAMPLE_EVERY)
        print(f"[resample {mode}] chunk ms/step in {RESAMPLE_TURNS} turns "
              f"of the same graph, without / with a redraw in flight: "
              + ", ".join(f"{q:.3f} / {b_:.3f}" for q, b_ in
                          zip(quiet, busy))
              + f"; mean {np.mean(quiet):.3f} / {np.mean(busy):.3f} "
              f"({100 * (np.mean(busy) / np.mean(quiet) - 1):+.1f} %)",
              flush=True)
        if a._adam.graph.captures != 1:
            fail(f"{mode}: the turns captured the step again")
        runs["graphs"]["busy_ms"] = float(np.mean(busy))
        runs["graphs"]["quiet_ms"] = float(np.mean(quiet))
        out[mode] = runs["graphs"]
    return out


def _discovery_model(X, u_star, col_weights):
    """Phase 12's model: the JAX package's ``examples/ac_discovery.py``
    setup at full width (2-128x4-1, var = [0, 0], SA weights, per-coefficient
    rates), the fused engine chosen automatically."""
    import tensordiffeq_tpu_torch as tdqt
    from tensordiffeq_tpu_torch import grad

    def f_model(u, var, x, t):
        c1, c2 = var
        u_xx = grad(grad(u, "x"), "x")
        uv = u(x, t)
        return grad(u, "t")(x, t) - c1 * u_xx(x, t) + c2 * uv ** 3 - c2 * uv

    m = tdqt.DiscoveryModel()
    m.compile(WIDTHS, f_model, [X[:, 0:1], X[:, 1:2]], u_star,
              var=[0.0, 0.0], col_weights=col_weights, varnames=["x", "t"],
              lr_vars=list(DISC_LR_VARS), verbose=False)
    return m, f_model


def _disc_equal(a, b) -> bool:
    import torch
    return (a.losses == b.losses and a.var_history == b.var_history
            and np.array_equal(a.col_weights, b.col_weights)
            and all(torch.equal(p, q) for p, q in
                    zip(a.net.parameters(), b.net.parameters())))


def phase_discovery() -> dict:
    """Phase 12: ``DiscoveryModel`` on the Allen-Cahn grid at full width;
    graphs against eager, the run, a mid-run checkpoint resumed in a fresh
    model, and the exported surrogate's residual against ``predict_f``."""
    import tempfile

    import torch
    from tensordiffeq_tpu_torch.exact import allen_cahn_solution
    from tensordiffeq_tpu_torch.ops import cuda_taylor as ct
    from tensordiffeq_tpu_torch.serving import Surrogate
    from tensordiffeq_tpu_torch.training import graphs

    x, t, usol = allen_cahn_solution()
    X = np.stack(np.meshgrid(x, t, indexing="ij"), -1).reshape(-1, 2)
    u_star = usol.reshape(-1, 1)
    cw = np.random.RandomState(0).rand(X.shape[0], 1)
    ct.reset_launch_counts()
    c0 = len(graphs.captures)
    a, f_model = _discovery_model(X, u_star, cw)
    b, _ = _discovery_model(X, u_star, cw)
    if a.engine != "fused":
        fail(f"discovery engine {a.engine}: the fused engine was not "
             f"adopted ({a._fuse_fail_reason!r})")
    t_g = _timed_disc(a, DISC_REFEREE)
    t_e = _timed_disc(b, DISC_REFEREE, _graphs=False)
    same = _disc_equal(a, b)
    print(f"[discovery] n={X.shape[0]} engine {a.engine}; {DISC_REFEREE} "
          f"steps each way: graphs {1e3 * t_g / DISC_REFEREE:.3f} ms/step, "
          f"eager {1e3 * t_e / DISC_REFEREE:.3f} ms/step; graph vs eager: "
          f"{'bit-identical' if same else 'DIFFERS'}", flush=True)
    _captures_since("discovery", c0)
    if not same or a._step_obj.graph.captures != 1:
        fail("discovery: the graphed steps differ from the eager ones")
    del b
    # the run: 200 steps in all, a checkpoint at 100
    t_1 = _timed_disc(a, DISC_CKPT - DISC_REFEREE)
    with tempfile.TemporaryDirectory() as tmp:
        a.save_checkpoint(f"{tmp}/ck")
        t_2 = _timed_disc(a, DISC_STEPS - DISC_CKPT)
        c, _ = _discovery_model(X, u_star, cw)
        c.restore_checkpoint(f"{tmp}/ck")
        _timed_disc(c, DISC_STEPS - DISC_CKPT)
        resumed = _disc_equal(a, c)
        del c
        ms = 1e3 * (t_1 + t_2) / (DISC_STEPS - DISC_REFEREE)
        v0, v1 = a.var_history[0], a.var_history[-1]
        print(f"[discovery] {DISC_STEPS} steps: {ms:.3f} ms/step (replays); "
              f"loss {a.losses[0]:.6e} -> {a.losses[-1]:.6e}; c1 {v0[0]:.6e}"
              f" -> {v1[0]:.6e}, c2 {v0[1]:.6e} -> {v1[1]:.6e} (true 1e-4, "
              f"5); resume from step {DISC_CKPT} "
              f"{'bit-identical' if resumed else 'DIFFERS'}", flush=True)
        if not (np.all(np.isfinite(a.losses)) and a.losses[-1] < a.losses[0]):
            fail("discovery: the loss did not fall")
        if not all(abs(v) > 0 for v in v1):
            fail(f"discovery: a coefficient did not move: {v1}")
        if not resumed:
            fail("discovery: the resumed model differs from the run")
        # the learned PDE as a surrogate, with no model around
        a.export_surrogate().save(f"{tmp}/art")
        sur = Surrogate.load(f"{tmp}/art", f_model=f_model)
        eng = sur.engine(**SERVE_LADDER)
        Xg = np.ascontiguousarray(X, np.float32)
        t0 = time.perf_counter()
        res = np.asarray(eng.residual(Xg)).reshape(-1, 1)
        t_res = time.perf_counter() - t0
        ref = a.predict_f(Xg)
        err = float(np.abs(res - ref).max())
        scale = float(np.abs(ref).max())
        print(f"[discovery serve] contract {sur.contract}, coefficients "
              f"{[float(c) for c in sur.coefficients]}; engine residual on "
              f"{Xg.shape[0]} points in {t_res:.3f} s (first touch) vs "
              f"predict_f: max_abs_err {err:.3e}, scale-relative "
              f"{err / scale:.3e} (band 1e-5)", flush=True)
        if not err <= 1e-5 * scale:
            fail("discovery: the engine's residual disagrees with predict_f")
    launches = _counts()
    if any(launches.values()):
        fail(f"discovery launched kernels: {launches}")
    return dict(ms_step=ms, launches=launches)


def _timed_disc(model, steps: int, _graphs: bool = True) -> float:
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.fit(tf_iter=steps, chunk=DISC_CHUNK, _graphs=_graphs)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


# --------------------------------------------------------------------- #
# phase 13: the solver's remaining training options
# --------------------------------------------------------------------- #
def _fit_counted(solver, **kw) -> tuple:
    """``fit`` with the launch counts set to 0 just before and read just
    after; returns (seconds, launches, Adam-step captures in the fit)."""
    from tensordiffeq_tpu_torch.ops import cuda_taylor as ct
    from tensordiffeq_tpu_torch.training import graphs

    c0 = len(graphs.captures)
    ct.reset_launch_counts()
    t = _timed_fit(solver, **kw)
    launches = _counts()
    caps = [c for c in graphs.captures[c0:] if c["name"] == "Adam step"]
    return t, launches, len(caps)


def _steady_ms(solver, chunk: int) -> float:
    """ms per Adam step of the last ``fit``'s chunks after its first (the
    first holds the warm-ups and the capture): replays and the chunks'
    history reads."""
    secs = solver._adam_result.chunk_seconds[1:]
    return 1e3 * float(np.mean(secs)) / chunk if secs else float("nan")


def _graph_vs_eager(tag: str, make, steps: int, chunk: int) -> dict:
    """Two solvers from one seed, ``steps`` Adam steps each, graphed and
    eager: held bit for bit (``_state_diff``)."""
    graph, eager = make(), make()
    t_g, launches, caps = _fit_counted(graph, tf_iter=steps, chunk=chunk)
    t_e = _timed_fit(eager, tf_iter=steps, chunk=chunk, _graphs=False)
    diff = _state_diff(graph, eager)
    print(f"[{tag} graph] {steps} steps each way: graphs "
          f"{1e3 * t_g / steps:.3f} ms/step, eager {1e3 * t_e / steps:.3f} "
          f"ms/step; captures {caps}; graph vs eager: "
          f"{'bit-identical' if diff == 0 else f'differs by {diff:.3e}'}",
          flush=True)
    if diff != 0 or caps != 1:
        fail(f"{tag}: graphed steps differ from eager ones ({diff:.3e}) or "
             f"the step was captured {caps} times")
    return dict(graph=graph, eager=eager, launches=launches)


def _log_eps(solver) -> list:
    """The (epoch, ε) of each ladder change of ``solver``."""
    log = []
    real = solver._set_causal_eps

    def logged(eps):
        log.append((len(solver.losses), float(eps)))
        real(eps)

    solver._set_causal_eps = logged
    return log


def phase_options(phase6_ms: float) -> dict:
    """Phase 13: (a) ``fused="autotune"``, (b) lr schedules, (c) NTK
    weighting, (d) causal weighting and ``remat``, (e) the embedding
    network families, each on the Allen-Cahn problem at full width."""
    out = {}
    out["autotune"] = _phase_autotune()
    out["schedules"] = _phase_schedules(phase6_ms)
    out["ntk"] = _phase_ntk()
    out.update(_phase_causal())
    out["families"] = _phase_families()
    return out


def _phase_autotune() -> dict:
    """(a) ``compile(fused="autotune")`` on AC-SA: each candidate's graphed
    loss step, the K3 race, the launches the protocol makes."""
    import torch
    import tensordiffeq_tpu_torch as tdqt
    from tensordiffeq_tpu_torch.ops import cuda_taylor as ct
    from tensordiffeq_tpu_torch.training import graphs

    domain, bcs, f_model, kw = ac_sa_problem()
    ct.reset_launch_counts()
    solver = tdqt.CollocationSolverND(verbose=False, seed=0)
    t0 = time.perf_counter()
    solver.compile(WIDTHS, f_model, domain, bcs, fused="autotune", **kw)
    torch.cuda.synchronize()
    t_c = time.perf_counter() - t0
    launches = _counts()
    rep = solver.autotune_report
    times = rep["timings_ms"]
    race = rep["minimax"]
    print(f"[autotune] compile {t_c:.2f} s; ms per graphed loss step: "
          + ", ".join(f"{k} {v:.3f}" for k, v in times.items())
          + f" -> {rep['choice']}; excluded {list(rep['excluded'])}, "
          f"failed {list(rep['failures'])}", flush=True)
    if race is not None:
        print(f"[autotune] K3 race: minimax step {race['minimax_ms']:.3f} ms"
              f" vs the winner's unfused step {race['unfused_ms']:.3f} ms -> "
              f"{'adopted' if race['adopted'] else 'not adopted'}; engine "
              f"{solver.engine}; launches in compile {launches}", flush=True)
    if "cuda" not in times:
        fail(f"autotune: the K1/K2 candidate did not pass its cross-check "
             f"or run: {rep['excluded']} {rep['failures']}")
    if rep["choice"] != min(times, key=times.get):
        fail(f"autotune chose {rep['choice']}, not the argmin of {times}")
    # the protocol: K1/K2 once each in the K1/K2 candidate's cross-check,
    # WARMUP_RUNS warm-ups and AUTOTUNE_REPS replays per timed step; K3
    # once in the minimax cross-check, then its timed step; the winner's
    # unfused step timed again in the race
    per = graphs.WARMUP_RUNS + AUTOTUNE_REPS
    k12 = 1 + per
    k3 = 0
    if rep["choice"] != "generic":
        k3 = 1 + per
        if rep["choice"] == "cuda":
            k12 += per
    want = {"k1": k12, "k2": k12, "k3": k3}
    if launches != want:
        fail(f"autotune launched {launches} in compile, the protocol says "
             f"{want}")
    adopted = race is not None and race["adopted"]
    want_engine = ("generic" if rep["choice"] == "generic" else
                   "fused-minimax-cuda" if adopted else
                   "fused-cuda" if rep["choice"] == "cuda" else "fused")
    if solver.engine != want_engine:
        fail(f"autotune's engine {solver.engine} is not its choice "
             f"{want_engine}")
    return dict(launches=launches)


def _phase_schedules(phase6_ms: float) -> dict:
    """(b) AC-SA on the minimax path with an exponential-decay rate on the
    network and a cosine-decay rate on the λ: 200 steps, then 50 graphed
    steps against 50 eager ones."""
    import torch
    import tensordiffeq_tpu_torch as tdqt
    from tensordiffeq_tpu_torch.training import schedules as S
    from tensordiffeq_tpu_torch.training.fit import step_count

    def sched():
        return dict(lr=S.exponential_decay(5e-3, 100, 0.5),
                    lr_weights=S.cosine_decay_schedule(5e-3, TF_ITER))

    def make(scheduled=True):
        domain, bcs, f_model, kw = ac_sa_problem()
        s = tdqt.CollocationSolverND(verbose=False, seed=0)
        s.compile(WIDTHS, f_model, domain, bcs, fused="cuda", **kw,
                  **(sched() if scheduled else {}))
        return s

    # the constant-rate twin beside it, on the same measure
    const = make(scheduled=False)
    t_c, _, _ = _fit_counted(const, tf_iter=TF_ITER, chunk=50)
    solver = make()
    t, launches, caps = _fit_counted(solver, tf_iter=TF_ITER, chunk=50)
    ms = 1e3 * t / TF_ITER
    net_lr = solver._opt[0].tdq_schedules[0]
    lam_lr = solver._opt[1].tdq_schedules[0]
    counts = [int(step_count(opt, opt.param_groups[0]))
              for opt in solver._opt]
    want_net = float(S.exponential_decay(5e-3, 100, 0.5)(
        torch.tensor(TF_ITER - 1, dtype=torch.int32)))
    want_lam = float(S.cosine_decay_schedule(5e-3, TF_ITER)(
        torch.tensor(TF_ITER - 1, dtype=torch.int32)))
    total = np.array([r["Total Loss"] for r in solver.losses])
    print(f"[schedules] engine {solver.engine}; {TF_ITER} steps "
          f"{ms:.3f} ms/step, {_steady_ms(solver, 50):.3f} past the first "
          f"chunk; constant rates beside it {1e3 * t_c / TF_ITER:.3f}, "
          f"{_steady_ms(const, 50):.3f} (phase 6: {phase6_ms:.3f}); "
          f"captures {caps}; launches {launches}; "
          f"device counts {counts[0]}/{counts[1]}, rates "
          f"{float(net_lr.lr):.6e}/{float(lam_lr.lr):.6e} (schedules at "
          f"count {TF_ITER - 1}: {want_net:.6e}/{want_lam:.6e}); loss "
          f"{total[0]:.6e} -> {total[-1]:.6e}", flush=True)
    if solver.engine != "fused-minimax-cuda":
        fail(f"schedules: engine {solver.engine}")
    if caps != 1 or launches != {"k1": 0, "k2": 0, "k3": TF_ITER}:
        fail(f"schedules: captures {caps}, launches {launches}")
    if not (counts[0] == counts[1] == TF_ITER
            and float(net_lr.lr) == want_net and float(lam_lr.lr) == want_lam):
        fail("schedules: the device's counts or rates are not the "
             "schedules'")
    if not (np.all(np.isfinite(total)) and total[-1] < total[0]):
        fail("schedules: the loss did not fall")
    _graph_vs_eager("schedules", make, REFEREE_STEPS, 25)
    return dict(launches=launches, ms_step=ms)


def _phase_ntk() -> dict:
    """(c) ``examples/ac_ntk.py``'s configuration: AC at full width with
    ``Adaptive_type=3``, ``fit(tf_iter=200, chunk=50)``; then 50 graphed
    steps against 50 eager ones across two updates."""
    import tensordiffeq_tpu_torch as tdqt

    def make():
        domain, bcs, f_model, _ = ac_sa_problem()
        s = tdqt.CollocationSolverND(verbose=False, seed=0)
        s.compile(WIDTHS, f_model, domain, bcs, fused="cuda",
                  Adaptive_type=3)
        return s

    solver = make()
    t, launches, caps = _fit_counted(solver, tf_iter=TF_ITER, chunk=50)
    ups = solver.ntk_updates
    weights = [[float(v) for vs in u["weights"].values() for v in vs]
               for u in ups]
    total = np.array([r["Total Loss"] for r in solver.losses])
    print(f"[ntk] engine {solver.engine}; {TF_ITER} steps "
          f"{1e3 * t / TF_ITER:.3f} ms/step, {_steady_ms(solver, 50):.3f} "
          f"past the first chunk; {len(ups)} updates: device ms "
          + ", ".join(f"{u['device_ms'] or float('nan'):.2f}" for u in ups)
          + "; host ms "
          + ", ".join(f"{1e3 * u['host_s']:.2f}" for u in ups)
          + f"; captures {caps}; launches {launches}; loss {total[0]:.6e} "
          f"-> {total[-1]:.6e}", flush=True)
    print("[ntk] weights (BCs, residual) per update: "
          + "; ".join(", ".join(f"{v:.4g}" for v in w) for w in weights),
          flush=True)
    if solver.engine != "fused-minimax-cuda":
        fail(f"ntk: engine {solver.engine}")
    if not 4 <= len(ups) <= 5:
        fail(f"ntk: {len(ups)} weight updates")
    if not all(max(w) / min(w) <= solver.ntk_max_ratio * (1 + 1e-6)
               and min(w) > 0 for w in weights):
        fail(f"ntk: a weight update left its max_ratio: {weights}")
    if caps != 1 or launches != {"k1": 0, "k2": 0, "k3": TF_ITER}:
        fail(f"ntk: captures {caps}, launches {launches}")
    if not (np.all(np.isfinite(total)) and total[-1] < total[0]):
        fail("ntk: the loss did not fall")
    _graph_vs_eager("ntk", make, REFEREE_STEPS, 25)
    return dict(launches=launches)


def _first_step(solver) -> list:
    """The loss and its parameter gradients at the solver's current state,
    eagerly, as detached tensors.  Nothing of the autograd graph may
    outlive the call: a live graph keeps the parameters' gradient
    accumulators of this (default) stream, and a later capture's backward
    would then reach into the default stream, which the capture
    refuses."""
    import torch
    layers = solver.net.layers()
    flat = [p for pair in layers for p in pair]
    total, _ = solver.loss_fn(layers, solver.lambdas["BCs"],
                              solver.lambdas["residual"], solver.X_f)
    grads = torch.autograd.grad(total, flat)
    return [total.detach()] + [g.detach() for g in grads]


def _phase_causal() -> dict:
    """(d) AC-SA on ``fused="cuda"`` with the ladder ``causal_eps=
    CAUSAL_LADDER``, 200 steps in chunks of 50, then the same with
    ``remat=True``: peak memory and ms/step of both, graphs against eager,
    and remat's first step against the plain one's."""
    import torch
    import tensordiffeq_tpu_torch as tdqt

    def make(remat=False):
        domain, bcs, f_model, kw = ac_sa_problem()
        s = tdqt.CollocationSolverND(verbose=False, seed=0)
        s.compile(WIDTHS, f_model, domain, bcs, fused="cuda",
                  causal_eps=CAUSAL_LADDER, causal_delta=CAUSAL_DELTA,
                  remat=remat, **kw)
        return s

    out = {}
    first = {}
    for tag, remat in (("causal", False), ("remat", True)):
        graph, eager = make(remat), make(remat)
        if graph.engine != "fused-cuda":
            fail(f"{tag}: engine {graph.engine} ({graph._minimax_fail_reason})")
        first[tag] = _first_step(graph)
        log = _log_eps(graph)
        _log_eps(eager)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t, launches, caps = _fit_counted(graph, tf_iter=TF_ITER, chunk=50)
        peak = torch.cuda.max_memory_allocated()
        t_e = _timed_fit(eager, tf_iter=TF_ITER, chunk=50, _graphs=False)
        diff = _state_diff(graph, eager)
        rows = graph.losses
        w = [r["Causal_w_last_0"] for r in rows]
        print(f"[{tag}] engine {graph.engine}; {TF_ITER} steps "
              f"{1e3 * t / TF_ITER:.3f} ms/step graphed "
              f"({_steady_ms(graph, 50):.3f} past the first chunk), "
              f"{1e3 * t_e / TF_ITER:.3f} eager; peak device memory "
              f"{peak / 2 ** 20:.1f} MiB; ladder {CAUSAL_LADDER} (delta "
              f"{CAUSAL_DELTA}) changes (epoch, eps) {log}; Causal_w_last "
              f"{w[0]:.4f} -> {w[-1]:.4f}; captures {caps}; launches "
              f"{launches}; graph vs eager "
              f"{'bit-identical' if diff == 0 else f'differs by {diff:.3e}'}",
              flush=True)
        k1 = TF_ITER * (2 if remat else 1)
        if launches != {"k1": k1, "k2": TF_ITER, "k3": 0}:
            fail(f"{tag}: launches {launches}, expected K1 {k1}, K2 "
                 f"{TF_ITER}")
        if caps != 1 or not log:
            fail(f"{tag}: captures {caps} across the ladder changes {log}")
        if diff != 0:
            fail(f"{tag}: graph differs from eager by {diff:.3e}")
        if len(rows) != TF_ITER or not all(
                "Causal_w_last_0" in r for r in rows):
            fail(f"{tag}: a history row lacks Causal_w_last")
        if not np.all(np.isfinite([r["Total Loss"] for r in rows])):
            fail(f"{tag}: the loss is not finite")
        out[tag] = dict(launches=launches, peak=peak,
                        ms_step=1e3 * t / TF_ITER)
        del graph, eager
    same = all(torch.equal(a, b) for a, b in zip(first["causal"],
                                                   first["remat"]))
    print(f"[remat] first step's loss and gradients against the plain "
          f"run's: {'bit-identical' if same else 'DIFFER'}; peak memory "
          f"{out['remat']['peak'] / 2 ** 20:.1f} MiB against "
          f"{out['causal']['peak'] / 2 ** 20:.1f}", flush=True)
    if not same:
        fail("remat: the first step differs from the plain run's")
    return out


def _phase_families() -> dict:
    """(e) the embedding families on AC-SA: ``PeriodicMLP`` (x periodic, 4
    harmonics) and ``FourierMLP`` (64 frequencies), 200 graphed steps each
    on the generic engine, then export, save and load with no solver."""
    import tempfile

    import tensordiffeq_tpu_torch as tdqt
    from tensordiffeq_tpu_torch import networks
    from tensordiffeq_tpu_torch.serving import Surrogate

    total = {"k1": 0, "k2": 0, "k3": 0}
    grid = np.stack(np.meshgrid(np.linspace(-1, 1, 512),
                                np.linspace(0, 1, 201), indexing="ij"),
                    -1).reshape(-1, 2).astype(np.float32)
    ts = np.linspace(0, 1, 201, dtype=np.float32)
    for tag in ("periodic", "fourier"):
        domain, bcs, f_model, kw = ac_sa_problem()
        gen = networks.init_generator(0)
        net = (networks.periodic_net(WIDTHS, domain, ["x"], n_harmonics=4,
                                     generator=gen)
               if tag == "periodic" else
               networks.fourier_net(WIDTHS, n_frequencies=64, generator=gen))
        s = tdqt.CollocationSolverND(verbose=False, seed=0)
        s.compile(WIDTHS, f_model, domain, bcs, network=net, **kw)
        t, launches, caps = _fit_counted(s, tf_iter=TF_ITER)
        rows = np.array([r["Total Loss"] for r in s.losses])
        u_pred, _ = s.predict(grid)
        with tempfile.TemporaryDirectory() as tmp:
            s.export_surrogate().save(f"{tmp}/art")
            sur = Surrogate.load(f"{tmp}/art", f_model=f_model)
        eng = sur.engine(**SERVE_LADDER)
        u_srv = np.asarray(eng.u(grid)).reshape(u_pred.shape)
        err = float(np.abs(u_srv - u_pred).max())
        scale = float(np.abs(u_pred).max())
        edge = float(np.abs(
            np.asarray(eng.u(np.stack([-np.ones_like(ts), ts], 1)))
            - np.asarray(eng.u(np.stack([np.ones_like(ts), ts], 1)))).max())
        print(f"[family {tag}] {type(s.net).__name__} engine {s.engine}; "
              f"{TF_ITER} steps {1e3 * t / TF_ITER:.3f} ms/step "
              f"({_steady_ms(s, 100):.3f} past the first chunk); captures "
              f"{caps}; launches {launches}; loss {rows[0]:.6e} -> "
              f"{rows[-1]:.6e}; served u vs predict max_abs_err {err:.3e} "
              f"(scale {scale:.3f}); |u(-1,t) - u(1,t)| max {edge:.3e}",
              flush=True)
        if s.engine != "generic" or type(sur.net) is not type(s.net):
            fail(f"family {tag}: engine {s.engine}, served net "
                 f"{type(sur.net).__name__}")
        if caps != 1 or any(launches.values()):
            fail(f"family {tag}: captures {caps}, launches {launches}")
        if not (np.all(np.isfinite(rows)) and rows[-1] < rows[0]):
            fail(f"family {tag}: the loss did not fall")
        if not err <= SERVE_U_BAND * max(1.0, scale):
            fail(f"family {tag}: served u differs from predict by {err:.3e}")
        if tag == "periodic" and not edge <= 1e-6 * max(1.0, scale):
            fail(f"family periodic: u(-1, t) != u(1, t) by {edge:.3e}")
        total = {k: total[k] + v for k, v in _counts().items()}
    return dict(launches=total)


# --------------------------------------------------------------------- #
# phase 14: mixed precision, the bf16-operand flavor of K1, K2 and K3
# --------------------------------------------------------------------- #
def _wrappers() -> dict:
    """Every kernel wrapper, by its key in the launch counts."""
    from tensordiffeq_tpu_torch.ops import cuda_minimax as cm
    from tensordiffeq_tpu_torch.ops import cuda_taylor as ct
    return {"k1": ct.k1_forward, "k2": ct.k2_backward, "k3": cm.k3_minimax,
            "k1_bf16": ct.k1_forward_bf16, "k2_bf16": ct.k2_backward_bf16,
            "k3_bf16": cm.k3_minimax_bf16, "k1_tf32": ct.k1_forward_tf32,
            "k2_tf32": ct.k2_backward_tf32, "k3_tf32": cm.k3_minimax_tf32}


def _counts_all() -> dict:
    """Every flavor's launch counts: ``_counts()``, the bf16 and the TF32
    ones."""
    return {k: fn.launches for k, fn in _wrappers().items()}


def _set_counts(saved: dict):
    """Put back the counts of a ``_counts_all()`` snapshot: comparison
    launches are not the main path's."""
    for k, fn in _wrappers().items():
        fn.launches = saved[k]


def _rms(a, b) -> float:
    import torch
    return float(torch.sqrt(torch.mean((a.double() - b.double()) ** 2)))


def _flavor_check(label: str, got: list, want: list, want32: list,
                  bands: list) -> dict:
    """A bf16 kernel's outputs against its plain bf16 flavor (each leaf in
    its band, scale-relative) and nearer that flavor than the plain f32
    one, by the RMS over every leaf together."""
    import torch
    worst_abs, worst_rel, fails = 0.0, 0.0, []
    for i, (a, b, band) in enumerate(zip(got, want, bands)):
        if not bool(torch.isfinite(a).all()):
            fail(f"{label}: non-finite output")
        ab, rel = scaled_err(a, b)
        worst_abs = max(worst_abs, ab)
        worst_rel = max(worst_rel, rel)
        if not rel <= band:
            fails.append((i, rel, band))
    cat = lambda ts: torch.cat([t.reshape(-1) for t in ts])  # noqa: E731
    r16, r32 = _rms(cat(got), cat(want)), _rms(cat(got), cat(want32))
    print(f"[{label}] max_abs_err={worst_abs:.3e} scale_rel_err="
          f"{worst_rel:.3e} (bands {BF16_VALUE_BAND:g} values, "
          f"{BF16_GRAD_BAND:g} gradients); RMS to the plain bf16 flavor "
          f"{r16:.3e}, to the plain f32 flavor {r32:.3e}", flush=True)
    if fails:
        fail(f"{label} outside the bf16 bands: {fails}")
    if not r16 < r32:
        fail(f"{label} is not nearer the plain bf16 flavor than the f32 one")
    return dict(max_abs_err=worst_abs, scale_rel_err=worst_rel,
                rms_bf16=r16, rms_f32=r32)


def phase_mixed_kernels(dev) -> dict:
    """Phase 14(a): K1-bf16, K2-bf16 and K3-bf16 against their plain bf16
    flavors at phases 3-5's shapes (K1-bf16 also on ``WIDE_WIDTHS``, its
    route for wider layers), timed beside their f32 flavors."""
    import torch
    from tensordiffeq_tpu_torch.networks import neural_net
    from tensordiffeq_tpu_torch.ops import cuda_minimax as cm
    from tensordiffeq_tpu_torch.ops import cuda_taylor as ct
    from tensordiffeq_tpu_torch.ops.fused import analyze_f_model
    from tensordiffeq_tpu_torch.ops.minimax import build_minimax_sq_fn
    from tensordiffeq_tpu_torch.ops.taylor import taylor_derivatives

    bf16 = torch.bfloat16
    rng = np.random.RandomState(0)
    X = torch.as_tensor(np.stack([rng.uniform(-1, 1, N_POINTS),
                                  rng.uniform(0, 1, N_POINTS)], 1),
                        dtype=torch.float32, device=dev)
    before = _counts_all()
    out = {}

    def timed(label, kernel, ms32, plain_ms, flops, nbytes, passes,
              route=None):
        ms = cuda_ms(kernel)
        b = bound_ms(flops, nbytes, passes, PEAK_BF16_FLOPS)
        before = BF16_TF32_ROUTE_MS.get(label)
        wg = K1_BEFORE_WGMMA_MS.get(label)
        earlier = [] if before is None else [f"TF32-pass route: {before:.3f} ms"]
        earlier += [] if wg is None else [f"before the wgmma route: {wg:.3f} ms"]
        print(f"[time {label}] {ms:.3f} ms "
              f"{'' if route is None else f'on the {route} route '}"
              f"({'; '.join(earlier) or 'no earlier time recorded'}"
              f") beside the f32 flavor's {ms32:.3f} ms (plain bf16 "
              f"{plain_ms:.3f} ms); {bound_text(ms, b)}", flush=True)
        return dict(ms=ms, f32_ms=ms32, plain_ms=plain_ms, bound=b)

    for label, reqs, widths in (("ac", AC_REQUESTS, WIDTHS),
                                ("mixed", MIXED_REQUESTS, WIDTHS),
                                ("wide", AC_REQUESTS, WIDE_WIDTHS)):
        layers, flat_layers, params, pairs = _slice_net(widths, dev)
        plan = ct.build_cuda_table_fn(
            reqs, [tuple(W.shape) for W, _ in layers]).plan
        flat = plan.pack(flat_layers)
        channels = plan.channels
        # the wide case holds K1-bf16 alone (and draws nothing, so K3's
        # inputs below stay as they were)
        g = None if label == "wide" else torch.as_tensor(
            rng.randn(plan.C, N_POINTS, 1), dtype=torch.float32, device=dev)
        Xg = X.clone().requires_grad_(True)

        def plain(dtype):
            t = taylor_derivatives(pairs, Xg, set(channels), flat_matmul=True,
                                   compute_dtype=dtype)
            table = torch.stack([t[mi] for mi in channels])
            if g is None:
                return table.detach(), None
            loss = sum((t[mi] * g[c]).sum() for c, mi in enumerate(channels))
            return table.detach(), torch.autograd.grad(loss, params + [Xg])

        table = ct.k1_forward_bf16(plan, X, flat)
        torch.cuda.synchronize()
        (t16, g16), (t32, g32) = plain(bf16), plain(None)
        k1 = _flavor_check(f"K1-bf16 {label}", list(table), list(t16),
                           list(t32), [BF16_VALUE_BAND] * plan.C)
        k1["route"] = _k1_route(plan, bf16, label)
        k1["bit_identical"] = _bit_identical_run_to_run(
            f"K1-bf16 {label}", table,
            lambda: ct.k1_forward_bf16(plan, X, flat))
        flops, nbytes = ct.flop_count(plan, N_POINTS), \
            ct.byte_count(plan, N_POINTS)
        passes = ct.tensor_passes(plan, bf16)
        with torch.no_grad():
            p1 = cuda_ms(lambda: taylor_derivatives(
                pairs, X, set(channels), flat_matmul=True,
                compute_dtype=bf16), reps=5)
        k1.update(timed(f"K1-bf16 {label}",
                        lambda: ct.k1_forward_bf16(plan, X, flat),
                        cuda_ms(lambda: ct.k1_forward(plan, X, flat)), p1,
                        flops["k1"], nbytes["k1"], passes["k1"],
                        k1["route"]))
        if label == "wide":
            out[label] = dict(k1=k1)
            continue
        dX, dflat = ct.k2_backward_bf16(plan, X, flat, g)
        torch.cuda.synchronize()
        mine = plan.unpack(dflat) + [dX]
        k2 = _flavor_check(f"K2-bf16 {label}", mine, list(g16), list(g32),
                           [BF16_GRAD_BAND] * len(mine))
        k2.update(timed(f"K2-bf16 {label}",
                        lambda: ct.k2_backward_bf16(plan, X, flat, g),
                        cuda_ms(lambda: ct.k2_backward(plan, X, flat, g)),
                        cuda_ms(lambda: plain(bf16), reps=5),
                        flops["k2"], nbytes["k2"], passes["k2"]))
        out[label] = dict(k1=k1, k2=k2)

    k3 = {}
    for label, f_model, widths in (("ac", _ac_residual, WIDTHS),
                                   ("system", _coupled_residual,
                                    WIDTHS[:-1] + [2])):
        n_out = widths[-1]
        reqs = analyze_f_model(f_model, ("x", "t"), n_out)
        layers = neural_net(widths, device=dev, seed=0).layers()
        kw = dict(device=dev)
        sq32 = build_minimax_sq_fn(f_model, ("x", "t"), n_out, reqs,
                                   [tuple(W.shape) for W, _ in layers], **kw)
        sq = build_minimax_sq_fn(f_model, ("x", "t"), n_out, reqs,
                                 sq32.plan.layer_shapes, compute_dtype=bf16,
                                 **kw)
        plan = sq.plan
        w = torch.as_tensor(rng.rand(N_POINTS, plan.E) ** 2,
                            dtype=torch.float32, device=dev)
        fl = [a.detach() if a.ndim == 2 else a.detach().reshape(1, -1)
              for pair in layers for a in pair]
        flat = plan.pack(fl)

        def leaves(res):
            v, d, gw, gX = res
            return [v.reshape(1)] + [t.reshape(-1) for t in d] + [gw, gX]

        got = cm.k3_minimax_bf16(plan, X, w, flat)
        torch.cuda.synchronize()
        got = leaves((got[0], plan.unpack(got[1]), got[2], got[3]))
        bands = [BF16_VALUE_BAND] + [BF16_GRAD_BAND] * (len(got) - 3) \
            + [BF16_VALUE_BAND, BF16_GRAD_BAND]
        res = _flavor_check(f"K3-bf16 {label}", got,
                            leaves(sq.plain(fl, w, X)),
                            leaves(sq32.plain(fl, w, X)), bands)
        res.update(timed(f"K3-bf16 {label}",
                         lambda: cm.k3_minimax_bf16(plan, X, w, flat),
                         cuda_ms(lambda: cm.k3_minimax(plan, X, w, flat)),
                         cuda_ms(lambda: sq.plain(fl, w, X), reps=5),
                         cm.flop_count(plan, N_POINTS)["k3"],
                         cm.byte_count(plan, N_POINTS)["k3"],
                         cm.tensor_passes(plan, bf16)))
        k3[label] = res
    # comparison launches are not the main path's: restore the counts
    for fn, key in ((ct.k1_forward, "k1"), (ct.k2_backward, "k2"),
                    (cm.k3_minimax, "k3"), (ct.k1_forward_bf16, "k1_bf16"),
                    (ct.k2_backward_bf16, "k2_bf16"),
                    (cm.k3_minimax_bf16, "k3_bf16")):
        fn.launches = before[key]
    out["ac"]["k1"]["wide"] = out["wide"]["k1"]
    return {"k1_bf16": out["ac"]["k1"], "k2_bf16": out["ac"]["k2"],
            "k3_bf16": k3["ac"]}


def _bf16_solver(minimax, seed: int = 0):
    """AC-SA at full size on ``fused="cuda", fused_dtype="bfloat16"``."""
    import tensordiffeq_tpu_torch as tdqt
    domain, bcs, f_model, kw = ac_sa_problem()
    s = tdqt.CollocationSolverND(verbose=False, seed=seed)
    s.compile(WIDTHS, f_model, domain, bcs, fused="cuda",
              fused_dtype="bfloat16", minimax=minimax, **kw)
    return s


def phase_mixed_training(paths: dict) -> dict:
    """Phase 14(b): ``compile(fused="cuda", fused_dtype="bfloat16")`` on
    AC-SA, the minimax path (200 Adam steps, then 100 L-BFGS iterations)
    and the unfused one (200 steps), the counts set to 0 just before each
    leg and read just after; then 50 graphed against 50 eager steps on each
    path."""
    import torch
    import tensordiffeq_tpu_torch as tdqt
    from tensordiffeq_tpu_torch.exact import allen_cahn_solution
    from tensordiffeq_tpu_torch.ops import cuda_taylor as ct

    x, t, usol = allen_cahn_solution()
    X_star = np.stack(np.meshgrid(x, t, indexing="ij"), -1).reshape(-1, 2)
    out = {}
    for tag, minimax in (("minimax", None), ("unfused", False)):
        ct.reset_launch_counts()
        solver = _bf16_solver(minimax)
        at_compile = _counts_all()
        want_engine = ("fused-minimax-cuda" if minimax is None
                       else "fused-cuda")
        if solver.engine != want_engine or solver.fused_dtype is None:
            fail(f"bf16 {tag}: engine {solver.engine}, expected "
                 f"{want_engine} ({solver._minimax_fail_reason!r})")
        ct.reset_launch_counts()
        t_fit = _timed_fit(solver, tf_iter=TF_ITER)
        adam = _counts_all()
        total = np.array([r["Total Loss"] for r in solver.losses])
        ms_step = 1e3 * t_fit / TF_ITER
        want = (dict(k3_bf16=TF_ITER) if minimax is None else
                dict(k1_bf16=TF_ITER, k2_bf16=TF_ITER))
        print(f"[bf16 {tag}] compile launches {at_compile}; {TF_ITER} Adam "
              f"steps {ms_step:.3f} ms/step (f32 phase "
              f"{6 if minimax is None else 7}: "
              f"{paths[tag]['ms_step']:.3f}); launches {adam}; loss "
              f"{total[0]:.6e} -> {total[-1]:.6e}; captures "
              f"{solver._adam.graph.captures}", flush=True)
        if adam != dict({k: 0 for k in adam}, **want):
            fail(f"bf16 {tag}: the Adam leg launched {adam}, not {want}")
        if not (np.all(np.isfinite(total)) and total[-1] < total[0]):
            fail(f"bf16 {tag}: the loss did not fall")
        if solver._adam.graph.captures != 1:
            fail(f"bf16 {tag}: {solver._adam.graph.captures} captures")
        res = dict(launches=adam, ms_step=ms_step, solver=solver)
        if minimax is None:
            adam_last = total[-1]
            e0, _ = _lbfgs_counts()
            ct.reset_launch_counts()
            n0 = len(solver.losses)
            t_leg = _timed_fit(solver, newton_iter=LBFGS_ITER)
            leg = _counts_all()
            evals = _lbfgs_counts()[0] - e0
            iters = len(solver.losses) - n0
            best = solver.min_loss["l-bfgs"]
            where = ("no retreat" if solver.lbfgs_retreat is None else
                     f"retreated to f32 after iteration "
                     f"{solver.lbfgs_retreat}")
            ms_iter = 1e3 * t_leg / max(iters, 1)
            print(f"[bf16 lbfgs] {iters} iterations {ms_iter:.3f} "
                  f"ms/iteration (f32 phase 8: "
                  f"{paths['lbfgs']['ms_iter']:.3f}); {evals} evaluations; "
                  f"launches {leg}; {where}; loss {adam_last:.6e} (last "
                  f"Adam step) -> best {best:.6e}", flush=True)
            if leg["k3_bf16"] + leg["k3"] != evals or leg["k3_bf16"] == 0:
                fail(f"bf16 lbfgs: {leg} for {evals} evaluations")
            if (solver.lbfgs_retreat is None) != (leg["k3"] == 0):
                fail(f"bf16 lbfgs: f32 K3 launched {leg['k3']} times, "
                     f"retreat {solver.lbfgs_retreat}")
            if any(leg[k] for k in ("k1", "k2", "k1_bf16", "k2_bf16")):
                fail(f"bf16 lbfgs: K1/K2 ran: {leg}")
            if not (np.isfinite(best) and best < adam_last):
                fail(f"bf16 lbfgs: best {best} not below {adam_last}")
            res.update(lbfgs_launches=leg, ms_iter=ms_iter,
                       retreat=solver.lbfgs_retreat)
        # as phases 7 (the last iterate) and 8 (the best, after L-BFGS)
        # measure it
        u_pred, _ = solver.predict(X_star, best_model=minimax is None)
        res["rel_l2"] = tdqt.find_L2_error(u_pred, usol.reshape(-1, 1))
        ref, ph = ((paths["lbfgs"]["rel_l2"], 8) if minimax is None
                   else (paths["unfused"]["rel_l2"], 7))
        print(f"[bf16 {tag}] rel-L2 vs ETDRK4 {res['rel_l2']:.4f} (f32 "
              f"phase {ph}: {ref:.4f}; reported, not gated)", flush=True)
        out[tag] = res

    for tag, minimax in (("minimax", None), ("unfused", False)):
        graph, eager = _bf16_solver(minimax), _bf16_solver(minimax)
        t_g = _timed_fit(graph, tf_iter=REFEREE_STEPS)
        t_e = _timed_fit(eager, tf_iter=REFEREE_STEPS, _graphs=False)
        diff = _state_diff(graph, eager)
        print(f"[bf16 graph {tag}] {REFEREE_STEPS} steps each way: graphs "
              f"{1e3 * t_g / REFEREE_STEPS:.3f} ms/step, eager "
              f"{1e3 * t_e / REFEREE_STEPS:.3f} ms/step; graph vs eager: "
              f"{'bit-identical' if diff == 0 else diff}; captures "
              f"{graph._adam.graph.captures}/{eager._adam.graph.captures}",
              flush=True)
        if diff != 0 or graph._adam.graph.captures != 1 \
                or eager._adam.graph.captures != 0:
            fail(f"bf16 {tag}: graph vs eager {diff}")
    return out


def phase_mixed_serve(solver, solver32, serve: dict, card: str,
                      keep_nets: str | None = None) -> dict:
    """Phase 14(c): the trained bf16 net exported, loaded with no solver
    and served by ``InferenceEngine(compute_dtype="bfloat16")`` on phase
    10's ladder, held on the grid to the same artifact served by the plain
    bf16 flavor (an engine on the CPU); bf16's distance to the f32 engine
    printed on it and on phase 10's f32-trained net (``solver32``); the
    counts set to 0 just before the timed queries (every rung already
    captured) and read just after.  ``keep_nets``: a directory to keep both
    artifacts in (``bf16`` and ``f32``), for
    ``scripts/torch_serve_bf16_witness.py``."""
    import shutil
    import tempfile

    import torch
    from tensordiffeq_tpu_torch.exact import allen_cahn_solution
    from tensordiffeq_tpu_torch.ops import cuda_taylor as ct
    from tensordiffeq_tpu_torch.serving import Surrogate

    x, t, _ = allen_cahn_solution()
    X_grid = np.ascontiguousarray(np.stack(
        np.meshgrid(x, t, indexing="ij"), -1).reshape(-1, 2), np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        solver.export_surrogate().save(f"{tmp}/ac")
        solver32.export_surrogate().save(f"{tmp}/ac32")
        sur = Surrogate.load(f"{tmp}/ac", f_model=_ac_residual)
        plain = Surrogate.load(f"{tmp}/ac", f_model=_ac_residual,
                               device="cpu").engine(
            compute_dtype="bfloat16", **SERVE_LADDER)
        sur32 = Surrogate.load(f"{tmp}/ac32", f_model=_ac_residual)
        if keep_nets:
            for name, src in (("bf16", "ac"), ("f32", "ac32")):
                shutil.copytree(f"{tmp}/{src}", os.path.join(keep_nets, name),
                                dirs_exist_ok=True)
    eng = sur.engine(compute_dtype="bfloat16", **SERVE_LADDER)
    f32 = sur.engine(**SERVE_LADDER)
    rng = np.random.default_rng(1)
    sets = {b: (X_grid if b == SERVE_LADDER["max_bucket"] else np.stack(
        [rng.uniform(-1, 1, b - 7), rng.uniform(0, 1, b - 7)],
        1).astype(np.float32)) for b in SERVE_BF16_BUCKETS}
    errs, mismatched, grid = {}, [], ([], [], [])
    for spec in SERVE_BF16_KINDS:
        op, op32 = eng.op_for(spec), f32.op_for(spec)
        for b, Xq in sets.items():
            if eng.bucket_for(Xq.shape[0]) != b:
                fail(f"{Xq.shape[0]} rows do not route to rung {b}")
            got = op(Xq)
            if not _bit_equal(got, _serve_eager(eng, spec, Xq, b)):
                mismatched.append(f"{spec} b={b}")
            if b == SERVE_LADDER["max_bucket"]:
                want32 = torch.from_numpy(np.asarray(op32(Xq)))
                got = torch.from_numpy(np.asarray(got))
                errs[spec] = scaled_err(got, want32)[1]
                for ts, v in zip(grid, (got, torch.from_numpy(np.asarray(
                        plain.op_for(spec)(Xq))), want32)):
                    ts.append(v)
    _flavor_check("serve bf16 vs plain bf16 engine", *grid,
                  [BF16_VALUE_BAND] * len(SERVE_BF16_KINDS))
    # an f32-trained net served in bf16 and in f32, as the reference's test
    # serves one: bf16's distance there too is the net's, not the kernel's
    eng32, f32b = sur32.engine(compute_dtype="bfloat16", **SERVE_LADDER), \
        sur32.engine(**SERVE_LADDER)
    errs32 = {spec: scaled_err(
        torch.from_numpy(np.asarray(eng32.op_for(spec)(X_grid))),
        torch.from_numpy(np.asarray(f32b.op_for(spec)(X_grid))))[1]
        for spec in SERVE_BF16_KINDS}
    ct.reset_launch_counts()
    n_replays = 0
    for spec in SERVE_BF16_KINDS:
        for Xq in sets.values():
            eng.op_for(spec)(Xq)
            n_replays += 1
    launches = _counts_all()
    print(f"[serve bf16] graph vs eager on {len(sets)} rungs x "
          f"{len(SERVE_BF16_KINDS)} kinds: "
          f"{'bit-identical' if not mismatched else mismatched}; against "
          f"the f32 engine on the grid (bf16's own distance on this net, "
          f"not gated): "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + "; phase 10's f32-trained net, bf16 against f32 (not gated): "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs32.items())
          + f"; {n_replays} replays, launches "
          f"{launches}; quarantined {eng.quarantined_buckets()}", flush=True)
    if mismatched:
        fail(f"bf16 rungs differ from their eager programs: {mismatched}")
    if not all(v > 0 for v in {**errs, **errs32}.values()):
        fail(f"the bf16 engine equals the f32 one: {errs}, {errs32}")
    if launches != dict({k: 0 for k in launches}, k1_bf16=n_replays):
        fail(f"the bf16 engine launched {launches}, not K1-bf16 x "
             f"{n_replays}")
    if eng.quarantined_buckets():
        fail(f"bf16 rungs quarantined: {eng.quarantined_buckets()}")
    f32_ms = {(r["kind"], r["bucket"]): r["ms"] for r in serve["rungs"]}
    for spec in SERVE_BF16_KINDS:
        for b in SERVE_BF16_BUCKETS:
            rung = eng._rungs[(eng.kind_key(spec), b)]
            ms = cuda_ms(rung.graph.graph.replay)
            ref = f32_ms.get((spec, b))
            print(f"[serve bf16 {spec} b={b}] {ms:.4f} ms/replay (f32 "
                  f"phase 10: {'not touched' if ref is None else f'{ref:.4f}'}"
                  f" ms) ({card})", flush=True)
    return dict(launches=dict(launches))


# --------------------------------------------------------------------- #
# phase 15: the PDE zoo at its full sizes
# --------------------------------------------------------------------- #
# the capped race: Adam steps and L-BFGS iterations per phase; Allen-Cahn's
# three arms run longer, so that one redraw is swapped in (dispatched at
# the chunk boundary 100, adopted at 200; at 200 steps the one dispatched
# at 100 trains no step and is discarded at the phase's end)
ZOO_CAP = 200
ZOO_CAP_ARMS = 300
# the entry whose graph is held to eager with telemetry attached (E = 3)
ZOO_GRAPH_ENTRY, ZOO_GRAPH_STEPS = "taylor-green", 50
ZOO_PROFILE_ENTRY, ZOO_PROFILE_STEPS = "burgers", 20


def _zoo_kernels(entry, solver, dev) -> dict:
    """K3, K1 and K2 at the entry's own shape (its N_f collocation points,
    widths, d, n_out and E) against their plain flavors, each timed over 20
    launches beside its bound; the counts restored after."""
    import torch
    from tensordiffeq_tpu_torch.ops import cuda_minimax as cm
    from tensordiffeq_tpu_torch.ops import cuda_taylor as ct
    from tensordiffeq_tpu_torch.ops.taylor import taylor_derivatives

    before = _counts_all()
    rng = np.random.RandomState(2)
    X = solver.X_f.contiguous()
    n = int(X.shape[0])
    layers = [(W.detach(), b.detach()) for W, b in solver.net.layers()]
    shapes = [tuple(W.shape) for W, _ in layers]
    out = {}

    # K3: the solver's own lowered step at w = lambda^2
    sq = solver._minimax_sq
    plan3 = sq.plan
    w = torch.as_tensor(rng.rand(n, plan3.E) ** 2, dtype=torch.float32,
                        device=dev)
    fl = [a if a.ndim == 2 else a.reshape(1, -1) for pair in layers
          for a in pair]
    flat3 = plan3.pack(fl)
    val, dflat, gw, gX = cm.k3_minimax(plan3, X, w, flat3)
    torch.cuda.synchronize()
    p_val, p_flat, p_gw, p_gX = sq.plain(fl, w, X)
    got = [val.reshape(1)] + [g.reshape(-1) for g in plan3.unpack(dflat)] \
        + [gw, gX]
    want = [p_val.reshape(1)] + [g.reshape(-1) for g in p_flat] + [p_gw, p_gX]
    if not all(bool(torch.isfinite(g).all()) for g in got):
        fail(f"zoo {entry.id}: K3 output not finite")
    k3_abs, k3_rel = 0.0, 0.0
    for a_k, a_p in zip(got, want):
        a, r = scaled_err(a_k, a_p)
        k3_abs, k3_rel = max(k3_abs, a), max(k3_rel, r)
    if not k3_rel <= K3_RTOL:
        fail(f"zoo {entry.id}: K3 disagrees with its plain flavor "
             f"({k3_rel:.3e})")
    again = cm.k3_minimax(plan3, X, w, flat3)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(again, (val, dflat, gw, gX)))
    if not same:
        fail(f"zoo {entry.id}: K3 is not bit-identical run to run")
    out["k3"] = dict(
        max_abs_err=k3_abs, scale_rel_err=k3_rel, C=plan3.C, E=plan3.E,
        ms=cuda_ms(lambda: cm.k3_minimax(plan3, X, w, flat3)),
        plain_ms=cuda_ms(lambda: sq.plain(fl, w, X), reps=5),
        bound=bound_ms(cm.flop_count(plan3, n)["k3"],
                       cm.byte_count(plan3, n)["k3"]))

    # K1 and K2: the Taylor table of the entry's requests
    plan = ct.build_cuda_table_fn(solver._fuse_requests, shapes).plan
    flat_layers = [t for pair in layers for t in pair]
    flat = plan.pack(flat_layers)
    params = [t.clone().requires_grad_(True) for t in flat_layers]
    pairs = list(zip(params[0::2], params[1::2]))
    channels = plan.channels

    def plain_table():
        t = taylor_derivatives(pairs, X, set(channels), flat_matmul=True)
        return torch.stack([t[mi] for mi in channels])

    table = ct.k1_forward(plan, X, flat)
    torch.cuda.synchronize()
    with torch.no_grad():
        ref = plain_table()
    k1_abs, k1_rel = 0.0, 0.0
    for c in range(plan.C):
        a, r = scaled_err(table[c], ref[c])
        k1_abs, k1_rel = max(k1_abs, a), max(k1_rel, r)
    if not k1_rel <= K1_RTOL:
        fail(f"zoo {entry.id}: K1 disagrees with its plain flavor "
             f"({k1_rel:.3e})")
    again = ct.k1_forward(plan, X, flat)
    torch.cuda.synchronize()
    if not torch.equal(again, table):
        fail(f"zoo {entry.id}: K1 is not bit-identical run to run")
    route = plan.k1_routes.get(None)
    g = torch.as_tensor(rng.randn(plan.C, n, plan.n_out), dtype=torch.float32,
                        device=dev)
    dX, dflat2 = ct.k2_backward(plan, X, flat, g)
    torch.cuda.synchronize()
    Xg = X.clone().requires_grad_(True)

    def plain_grads():
        t = taylor_derivatives(pairs, Xg, set(channels), flat_matmul=True)
        loss = sum((t[mi] * g[c]).sum() for c, mi in enumerate(channels))
        return torch.autograd.grad(loss, params + [Xg],
                                   materialize_grads=True)

    k2_abs, k2_rel = 0.0, 0.0
    for a_k, a_p in zip(plan.unpack(dflat2) + [dX], plain_grads()):
        a, r = scaled_err(a_k, a_p)
        k2_abs, k2_rel = max(k2_abs, a), max(k2_rel, r)
    if not k2_rel <= K2_RTOL:
        fail(f"zoo {entry.id}: K2 disagrees with autograd of the plain "
             f"flavor ({k2_rel:.3e})")
    flops, nbytes = ct.flop_count(plan, n), ct.byte_count(plan, n)
    with torch.no_grad():
        k1_plain = cuda_ms(plain_table, reps=5)
    out["k1"] = dict(max_abs_err=k1_abs, scale_rel_err=k1_rel, C=plan.C,
                     route=route,
                     ms=cuda_ms(lambda: ct.k1_forward(plan, X, flat)),
                     plain_ms=k1_plain,
                     bound=bound_ms(flops["k1"], nbytes["k1"]))
    out["k2"] = dict(max_abs_err=k2_abs, scale_rel_err=k2_rel, C=plan.C,
                     ms=cuda_ms(lambda: ct.k2_backward(plan, X, flat, g)),
                     plain_ms=cuda_ms(plain_grads, reps=5),
                     bound=bound_ms(flops["k2"], nbytes["k2"]))
    # comparison launches are not the main path's: restore the counts
    for fn, key in ((ct.k1_forward, "k1"), (ct.k2_backward, "k2"),
                    (cm.k3_minimax, "k3")):
        fn.launches = before[key]
    for key in ("k3", "k1", "k2"):
        m = out[key]
        extra = (f" C={m['C']}" + (f" E={m['E']}" if key == "k3" else "")
                 + (f" route {m['route']}" if key == "k1" else ""))
        print(f"[zoo {entry.id} {key.upper()}]{extra} N={n} max_abs_err="
              f"{m['max_abs_err']:.3e} scale_rel_err={m['scale_rel_err']:.3e}"
              f" (tol 1e-4); {m['ms']:.3f} ms (plain {m['plain_ms']:.3f} ms),"
              f" {bound_text(m['ms'], m['bound'])}", flush=True)
    return out


def _zoo_race(entry, arms: tuple, cap: int, compile_k3: int) -> dict:
    """``race_entry`` at the full size, capped, with the counts set to 0
    just before and read just after; the gates of each arm.  ``compile_k3``:
    K3's launches in the entry's compile (its cross-check, once per build:
    twice for an assimilation entry, whose ``compile_data`` builds
    again)."""
    import torch
    from tensordiffeq_tpu_torch import zoo
    from tensordiffeq_tpu_torch.ops import cuda_taylor as ct
    from tensordiffeq_tpu_torch.training import graphs
    from tensordiffeq_tpu_torch.training.lbfgs import lbfgs_minimize

    fits = {}

    def on_fit(arm, solver, tele, traj):
        torch.cuda.synchronize()
        fits[arm] = dict(solver=solver, tele=tele, traj=list(traj),
                         counts=_counts(),
                         evals=lbfgs_minimize.evaluations,
                         captures=len(graphs.captures))

    ct.reset_launch_counts()
    e0, c0 = lbfgs_minimize.evaluations, len(graphs.captures)
    t0 = time.perf_counter()
    res = zoo.race_entry(entry, "full", arms=arms, budget_cap=cap,
                         on_fit=on_fit)
    wall = time.perf_counter() - t0
    out = dict(result=res, wall_s=wall, arms={})
    prev = dict(k1=0, k2=0, k3=0)
    for arm in arms:
        f = fits[arm]
        s, tele, traj = f["solver"], f["tele"], f["traj"]
        launches = {k: f["counts"][k] - prev[k] for k in prev}
        prev = f["counts"]
        evals, e0 = f["evals"] - e0, f["evals"]
        new = graphs.captures[c0:f["captures"]]
        c0 = f["captures"]
        adam_caps = [c for c in new if c["name"] == "Adam step"]
        a = res["arms"][arm]
        n_adam = res["budget"]["adam"]
        total = [r["Total Loss"] for r in s.losses]
        # the fit's chunks of 100 steps: the first holds the warm-up and
        # the capture
        chunks = s._adam_result.chunk_seconds
        hist = tele.registry.as_dict()["histograms"]
        # the L-BFGS chunks' step-time split: per iteration, averaged
        lb_disp = hist["step_time_dispatch_s{phase=l-bfgs}"]
        lb_dev = hist["step_time_device_s{phase=l-bfgs}"]
        ms_iter = 1e3 * (lb_disp["sum"] + lb_dev["sum"]) / lb_disp["count"]
        metric = a.get("rel_l2_final", a.get("residual_final"))
        rec = dict(launches=launches, evals=evals, captures=len(adam_caps),
                   ms_step=1e3 * (sum(chunks[1:]) / (n_adam - 100)
                                  if len(chunks) > 1 else chunks[0] / n_adam),
                   ms_iter=ms_iter, metric=metric, redraws=a["redraws"],
                   stall_p50_s=a["stall_p50_s"], basis=a["flops_basis"],
                   iters=s.newton_done, loss=(total[0], total[-1]))
        out["arms"][arm] = rec
        kind = "rel-L2" if "rel_l2_final" in a else "residual RMS"
        print(f"[zoo {entry.id} race {arm}] cap {cap}: {n_adam} Adam steps "
              f"{rec['ms_step']:.3f} ms/step past the capture, {s.newton_done}"
              f" L-BFGS iterations {ms_iter:.3f} ms/iteration ({evals} "
              f"evaluations); loss {total[0]:.4e} -> "
              f"{total[-1]:.4e}; {len(traj)} evals, final {kind} {metric} "
              f"(the capped budget measures the contract, not the gate "
              f"{res['gate']['value']:g}); launches {launches}; Adam "
              f"captures {len(adam_caps)}; redraws {a['redraws']}, stall p50 "
              f"{a['stall_p50_s']} s; flops {a['flops_per_step']:.4g}/step "
              f"({a['flops_basis']})", flush=True)
        if not (np.isfinite(total[-1]) and total[-1] < total[0]):
            fail(f"zoo {entry.id} {arm}: the loss did not fall")
        if not traj or not all(np.isfinite(m) for _, m in traj):
            fail(f"zoo {entry.id} {arm}: an eval is not finite: {traj}")
        if len(adam_caps) != 1:
            fail(f"zoo {entry.id} {arm}: {len(adam_caps)} captures of the "
                 "Adam step")
        if a["flops_basis"] != "analytic-minimax":
            fail(f"zoo {entry.id} {arm}: flops_basis {a['flops_basis']}")
        if arm == "fixed":
            # K3: compile's cross-check, each Adam step, each evaluation
            want = dict(k1=0, k2=0, k3=compile_k3 + n_adam + evals)
            if launches != want:
                fail(f"zoo {entry.id}: launches {launches}, not {want}")
        elif not (a["redraws"] >= 1 and a["stall_p50_s"] is not None
                  and np.isfinite(a["stall_p50_s"])):
            fail(f"zoo {entry.id} {arm}: redraws {a['redraws']}, stall "
                 f"{a['stall_p50_s']}")
    return out


def phase_zoo(dev) -> dict:
    """Phase 15: the nine zoo entries at their ``full`` sizes on the card
    (``zoo.build_solver``: the minimax step K3 adopted), each kernel held
    to its plain flavor at each entry's shape and timed, a capped race per
    entry (the fixed arm; Allen-Cahn's three arms), graph against eager
    with telemetry on ``taylor-green`` and ``fit(profile_dir=)``."""
    import tempfile

    import torch
    from tensordiffeq_tpu_torch import zoo
    from tensordiffeq_tpu_torch.telemetry import (MetricsRegistry,
                                                  TrainingTelemetry)
    from tensordiffeq_tpu_torch.ops import cuda_taylor as ct

    t_phase = time.perf_counter()
    shapes, races = {}, {}
    launches = dict(k1=0, k2=0, k3=0)
    for entry in zoo.entries():
        ct.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solver = zoo.build_solver(entry, "full")
        torch.cuda.synchronize()
        t_compile = time.perf_counter() - t0
        at_compile = _counts()
        label = zoo.engine_label(solver)
        spec = entry.spec("full")
        print(f"[zoo {entry.id}] {list(solver.layer_sizes)} N_f={spec.n_f} "
              f"E={solver._minimax_n_eq}: engine {label}, compile "
              f"{t_compile:.2f} s, launches in compile {at_compile}",
              flush=True)
        if label != "fused-minimax-cuda":
            fail(f"zoo {entry.id}: engine {label} "
                 f"({solver._minimax_fail_reason!r})")
        # K3 once per build's cross-check: compile_data builds again
        builds = 1 + (solver.data_X is not None)
        if at_compile != dict(k1=0, k2=0, k3=builds):
            fail(f"zoo {entry.id}: launches in compile {at_compile}")
        if int(solver._minimax_n_eq) != entry.n_components:
            fail(f"zoo {entry.id}: n_eq {solver._minimax_n_eq} != "
                 f"{entry.n_components}")
        shapes[entry.id] = _zoo_kernels(entry, solver, dev)
        del solver
        arms, cap = (("fixed",), ZOO_CAP) if entry.id != "allen-cahn-sa" \
            else (tuple(zoo.ARMS), ZOO_CAP_ARMS)
        races[entry.id] = _zoo_race(entry, arms, cap, at_compile["k3"])
        for rec in races[entry.id]["arms"].values():
            for k in launches:
                launches[k] += rec["launches"][k]

    # graph against eager with telemetry attached, and the plain step
    entry = zoo.get(ZOO_GRAPH_ENTRY)
    runs = {}
    for tag, tele, graphs_on in (("graph", True, True),
                                 ("eager", True, False),
                                 ("plain", False, True)):
        s = zoo.build_solver(entry, "full")
        t = _timed_fit(s, tf_iter=ZOO_GRAPH_STEPS, chunk=ZOO_GRAPH_STEPS,
                       _graphs=graphs_on,
                       telemetry=(TrainingTelemetry(registry=MetricsRegistry())
                                  if tele else None))
        runs[tag] = (s, 1e3 * t / ZOO_GRAPH_STEPS)
    (g, g_ms), (e, e_ms), (p, p_ms) = runs["graph"], runs["eager"], \
        runs["plain"]
    diff = _state_diff(g, e)
    # the plain step trains as the instrumented one: the losses without
    # the gradient norm and every parameter and λ, bit for bit
    strip = [{k: v for k, v in r.items() if k != "Grad_norm"}
             for r in g.losses]
    same_plain = strip == p.losses and _state_diff(p, g, len(g.losses)) == 0
    norms = [r["Grad_norm"] for r in g.losses]
    print(f"[zoo graph {entry.id}] {ZOO_GRAPH_STEPS} steps with telemetry: "
          f"graphs {g_ms:.3f} ms/step, eager {e_ms:.3f} ms/step; graph vs "
          f"eager: {'bit-identical' if diff == 0 else diff}; captures "
          f"{g._adam.graph.captures}/{e._adam.graph.captures}; without "
          f"telemetry {p_ms:.3f} ms/step, "
          f"{'bit-identical' if same_plain else 'DIFFERENT'} to the "
          f"instrumented run but Grad_norm; Grad_norm {norms[0]:.4e} -> "
          f"{norms[-1]:.4e}", flush=True)
    if diff != 0 or g._adam.graph.captures != 1 \
            or e._adam.graph.captures != 0:
        fail(f"zoo graph {entry.id}: graph vs eager {diff}")
    if not same_plain or "Grad_norm" in p.losses[0] \
            or not all(np.isfinite(norms)):
        fail(f"zoo graph {entry.id}: the plain step trains otherwise")
    del runs, g, e, p

    # fit(profile_dir=): a Chrome trace that holds K3's kernel records
    s = zoo.build_solver(zoo.get(ZOO_PROFILE_ENTRY), "full")
    with tempfile.TemporaryDirectory() as tmp:
        t = _timed_fit(s, tf_iter=ZOO_PROFILE_STEPS, chunk=10,
                       profile_dir=tmp)
        (name,) = os.listdir(tmp)
        with open(os.path.join(tmp, name)) as fh:
            events = json.load(fh)["traceEvents"]
    k3_records = [ev for ev in events if ev.get("cat") == "kernel"
                  and "minimax_step" in str(ev.get("name"))]
    print(f"[zoo profile {ZOO_PROFILE_ENTRY}] fit(tf_iter="
          f"{ZOO_PROFILE_STEPS}, profile_dir=...) {t:.2f} s: {len(events)} "
          f"trace events, {len(k3_records)} K3 kernel records "
          f"(captures {s._adam.graph.captures})", flush=True)
    if not k3_records:
        fail("the profile trace holds no K3 kernel record")
    wall = time.perf_counter() - t_phase
    print(f"[zoo] phase wall {wall:.1f} s; launches on the path {launches}",
          flush=True)
    return dict(launches=launches, shapes=shapes, races=races, wall_s=wall)


# --------------------------------------------------------------------- #
# phase 16: the network options (precision=None and the TF32 flavor of
# the kernels, a custom nn.Module, another activation, a bf16 dtype)
# --------------------------------------------------------------------- #
def _burgers_residual(u, x, t):
    from tensordiffeq_tpu_torch import grad
    u_x = grad(u, "x")
    return (grad(u, "t")(x, t) + u(x, t) * u_x(x, t)
            - (0.01 / np.pi) * grad(u_x, "x")(x, t))


def _rms_rel(a, b) -> float:
    import torch
    return _rms(a, b) / max(float(torch.sqrt(torch.mean(b.double() ** 2))),
                            1e-30)


def _tf32_check(label: str, got: list, emu: list, twin: list,
                ieee: list) -> dict:
    """A TF32 kernel's leaves against the TF32-emulating plain flavor and
    its float64-summed twin (two referees of the same semantics): each
    leaf's RMS scale-relative distance to the nearer referee within
    TF32_SPREAD times the order spread (the two referees' distance, the
    largest over the leaves; at least TF32_FLOOR), its max distance within
    the larger of that band in the max metric and TF32_FLIP of the
    emulation's own max distance to the IEEE flavor (where one flipped
    operand decides the max), and the whole nearer (RMS) the emulation
    than the IEEE flavor.  Prints the distances to the emulation, to the
    twin and to the IEEE flavor, and the spread."""
    import torch
    worst = dict(max_abs_err=0.0, scale_rel_err=0.0, rms_rel=0.0,
                 twin_max=0.0, twin_rms=0.0, near_max=0.0, near_rms=0.0,
                 spread_max=0.0, spread_rms=0.0, ieee_max=0.0, ieee_rms=0.0)
    for a, e, t, i in zip(got, emu, twin, ieee):
        if not bool(torch.isfinite(a).all()):
            fail(f"{label}: non-finite output")
        ab, rel = scaled_err(a, e)
        worst["max_abs_err"] = max(worst["max_abs_err"], ab)
        worst["scale_rel_err"] = max(worst["scale_rel_err"], rel)
        worst["rms_rel"] = max(worst["rms_rel"], _rms_rel(a, e))
        t_max, t_rms = scaled_err(a, t)[1], _rms_rel(a, t)
        worst["twin_max"] = max(worst["twin_max"], t_max)
        worst["twin_rms"] = max(worst["twin_rms"], t_rms)
        worst["near_max"] = max(worst["near_max"], min(rel, t_max))
        worst["near_rms"] = max(worst["near_rms"],
                                min(_rms_rel(a, e), t_rms))
        worst["spread_max"] = max(worst["spread_max"], scaled_err(t, e)[1])
        worst["spread_rms"] = max(worst["spread_rms"], _rms_rel(t, e))
        worst["ieee_max"] = max(worst["ieee_max"], scaled_err(a, i)[1])
        worst["emu_ieee_max"] = max(worst.get("emu_ieee_max", 0.0),
                                    scaled_err(e, i)[1])
        worst["ieee_rms"] = max(worst["ieee_rms"], _rms_rel(a, i))
    cat = lambda ts: torch.cat([t.reshape(-1) for t in ts])  # noqa: E731
    r_emu, r_ieee = _rms(cat(got), cat(emu)), _rms(cat(got), cat(ieee))
    band_max = max(TF32_FLOOR, TF32_SPREAD * worst["spread_max"],
                   TF32_FLIP * worst["emu_ieee_max"])
    band_rms = max(TF32_FLOOR, TF32_SPREAD * worst["spread_rms"])
    print(f"[{label}] to the TF32 emulation: scale_rel_err="
          f"{worst['scale_rel_err']:.3e}, RMS-relative {worst['rms_rel']:.3e};"
          f" to its float64-summed twin {worst['twin_max']:.3e} max, "
          f"{worst['twin_rms']:.3e} RMS; to the nearer (gated) "
          f"{worst['near_max']:.3e} max (band {band_max:.3e}), "
          f"{worst['near_rms']:.3e} RMS (band {band_rms:.3e}); order spread "
          f"(emulation vs twin) {worst['spread_max']:.3e} max, "
          f"{worst['spread_rms']:.3e} RMS; to the IEEE flavor "
          f"{worst['ieee_max']:.3e} max, {worst['ieee_rms']:.3e} RMS",
          flush=True)
    if not (worst["near_max"] <= band_max and worst["near_rms"] <= band_rms):
        fail(f"{label} is outside the TF32 flavor's band")
    if not r_emu < r_ieee:
        fail(f"{label} is not nearer the TF32 emulation than the IEEE "
             "flavor")
    return worst


def phase_tf32_kernels(dev) -> dict:
    """Phase 16(a): K1-TF32, K2-TF32 and K3-TF32 against the
    TF32-emulating plain flavor at the Allen-Cahn slice (N = 50,000,
    2-128x4-1, C = 4, E = 1) and at ``burgers``' 2-20x8-1, K1 and K3 bit
    for bit run to run, each timed over 20 launches beside the 3xTF32
    flavor and its one-pass bound.  Returns the Allen-Cahn measurements."""
    import torch
    from tensordiffeq_tpu_torch.networks import neural_net
    from tensordiffeq_tpu_torch.ops import cuda_minimax as cm
    from tensordiffeq_tpu_torch.ops import cuda_taylor as ct
    from tensordiffeq_tpu_torch.ops.fused import analyze_f_model
    from tensordiffeq_tpu_torch.ops.minimax import build_minimax_sq_fn
    from tensordiffeq_tpu_torch.ops.taylor import taylor_derivatives

    rng = np.random.RandomState(2)
    before = _counts_all()
    out = {}
    for label, f_model, widths in (("ac", _ac_residual, WIDTHS),
                                   ("burgers", _burgers_residual,
                                    BURGERS_WIDTHS)):
        X = torch.as_tensor(np.stack([rng.uniform(-1, 1, N_POINTS),
                                      rng.uniform(0, 1, N_POINTS)], 1),
                            dtype=torch.float32, device=dev)
        reqs = analyze_f_model(f_model, ("x", "t"), 1)
        layers, flat_layers, params, pairs = _slice_net(widths, dev)
        shapes = [tuple(W.shape) for W, _ in layers]
        plan = ct.build_cuda_table_fn(reqs, shapes, precision=None).plan
        flat = plan.pack(flat_layers)
        channels = plan.channels
        g = torch.as_tensor(rng.randn(plan.C, N_POINTS, 1),
                            dtype=torch.float32, device=dev)
        Xg = X.clone().requires_grad_(True)

        def plain(mode):
            t = taylor_derivatives(pairs, Xg, set(channels), flat_matmul=True,
                                   emulate_tf32=mode)
            table = torch.stack([t[mi] for mi in channels])
            loss = sum((t[mi] * g[c]).sum() for c, mi in enumerate(channels))
            return table.detach(), torch.autograd.grad(loss, params + [Xg])

        table = ct.k1_forward_tf32(plan, X, flat)
        torch.cuda.synchronize()
        (te, ge), (tt, gt), (ti, gi) = plain(True), plain("float64"), \
            plain(False)
        k1 = _tf32_check(f"K1-TF32 {label}", list(table), list(te),
                         list(tt), list(ti))
        k1["route"] = plan.k1_routes[ct.TF32]
        k1["bit_identical"] = _bit_identical_run_to_run(
            f"K1-TF32 {label}", table,
            lambda: ct.k1_forward_tf32(plan, X, flat))
        dX, dflat = ct.k2_backward_tf32(plan, X, flat, g)
        torch.cuda.synchronize()
        k2 = _tf32_check(f"K2-TF32 {label}", plan.unpack(dflat) + [dX],
                         list(ge), list(gt), list(gi))
        flops, nbytes = ct.flop_count(plan, N_POINTS), \
            ct.byte_count(plan, N_POINTS)
        passes = ct.tensor_passes(plan, ct.TF32)
        for name, res, kern, ref, key in (
                ("K1", k1, lambda: ct.k1_forward_tf32(plan, X, flat),
                 lambda: ct.k1_forward(plan, X, flat), "k1"),
                ("K2", k2, lambda: ct.k2_backward_tf32(plan, X, flat, g),
                 lambda: ct.k2_backward(plan, X, flat, g), "k2")):
            res["ms"] = cuda_ms(kern)
            res["f32_ms"] = cuda_ms(ref)
            res["plain_ms"] = cuda_ms(lambda: plain(True), reps=5)
            res["bound"] = bound_ms(flops[key], nbytes[key], passes[key])
            print(f"[time {name}-TF32 {label}] {res['ms']:.3f} ms"
                  f"{' on the ' + res['route'] + ' route' if key == 'k1' else ''}"
                  f" beside the 3xTF32 flavor's {res['f32_ms']:.3f} ms (plain "
                  f"TF32 emulation {res['plain_ms']:.3f} ms); "
                  f"{bound_text(res['ms'], res['bound'])}", flush=True)

        sq32 = build_minimax_sq_fn(f_model, ("x", "t"), 1, reqs, shapes,
                                   device=dev)
        sq = build_minimax_sq_fn(f_model, ("x", "t"), 1, reqs, shapes,
                                 device=dev, precision=None)
        w = torch.as_tensor(rng.rand(N_POINTS, 1) ** 2, dtype=torch.float32,
                            device=dev)
        fl = [a.detach() if a.ndim == 2 else a.detach().reshape(1, -1)
              for pair in layers for a in pair]
        kflat = sq.plan.pack(fl)

        def leaves(res):
            v, d, gw, gX = res
            return [v.reshape(1)] + [t.reshape(-1) for t in d] + [gw, gX]

        got = cm.k3_minimax_tf32(sq.plan, X, w, kflat)
        torch.cuda.synchronize()
        k3 = _tf32_check(
            f"K3-TF32 {label}",
            leaves((got[0], sq.plan.unpack(got[1]), got[2], got[3])),
            leaves(sq.plain(fl, w, X, emulate_tf32=True)),
            leaves(sq.plain(fl, w, X, emulate_tf32="float64")),
            leaves(sq32.plain(fl, w, X)))
        k3["bit_identical"] = _bit_identical_run_to_run(
            f"K3-TF32 {label}", got[1],
            lambda: cm.k3_minimax_tf32(sq.plan, X, w, kflat)[1])
        k3["ms"] = cuda_ms(lambda: cm.k3_minimax_tf32(sq.plan, X, w, kflat))
        k3["f32_ms"] = cuda_ms(lambda: cm.k3_minimax(sq.plan, X, w, kflat))
        k3["plain_ms"] = cuda_ms(
            lambda: sq.plain(fl, w, X, emulate_tf32=True), reps=5)
        k3["bound"] = bound_ms(cm.flop_count(sq.plan, N_POINTS)["k3"],
                               cm.byte_count(sq.plan, N_POINTS)["k3"],
                               cm.tensor_passes(sq.plan, ct.TF32))
        print(f"[time K3-TF32 {label}] {k3['ms']:.3f} ms beside the 3xTF32 "
              f"flavor's {k3['f32_ms']:.3f} ms (plain TF32 emulation "
              f"{k3['plain_ms']:.3f} ms); {bound_text(k3['ms'], k3['bound'])}",
              flush=True)
        out[label] = dict(k1_tf32=k1, k2_tf32=k2, k3_tf32=k3)
    _set_counts(before)  # comparison launches are not the main path's
    return out["ac"]


def _crosscheck_distances(solver) -> dict:
    """The adopted engines' distances to the generic engine on the
    cross-check's 32 points (the measures of ``ops/fused.py``'s
    cross-check): the fused residual's values and its squared residual's
    parameter gradients, and the minimax loss value."""
    import torch
    from tensordiffeq_tpu_torch.ops.fused import _leaves

    X_s = solver.X_f[:32]
    params = solver.net.params()

    def sumsq(out):
        comps = out if isinstance(out, tuple) else (out,)
        return sum(torch.sum(c ** 2) for c in comps)

    with torch.enable_grad():
        gen = solver._generic_residual(params, X_s)
        fus = solver._fused_residual(params, X_s)
        g_gen = torch.autograd.grad(sumsq(gen), params,
                                    materialize_grads=True)
        g_fus = torch.autograd.grad(sumsq(fus), params,
                                    materialize_grads=True)
    values = max(scaled_err(f.detach(), g.detach())[1] for f, g in
                 zip(_leaves(fus), _leaves(gen)))
    grads = max(float((a - b).abs().max()) / (float(b.abs().max()) + 1e-5)
                for a, b in zip(g_fus, g_gen))
    return dict(values=values, grads=grads)


def _phase_tf32_training(phase6_ms: float) -> dict:
    """Phase 16(b): AC-SA full with ``neural_net(WIDTHS, precision=None)``
    on ``fused="cuda"``: the engine compile adopts and the cross-check's
    distances; if the f32 band refuses the TF32 flavor at a width, the
    next narrower width (the widest where compile adopts it) trains: 200
    Adam steps and 20 L-BFGS iterations with K3-TF32 once per step and per
    evaluation and no other launch, graph = eager over 50 steps, and 50
    unfused steps through K1-TF32/K2-TF32."""
    import torch
    import tensordiffeq_tpu_torch as tdqt
    from tensordiffeq_tpu_torch.networks import neural_net
    from tensordiffeq_tpu_torch.ops import cuda_taylor as ct
    from tensordiffeq_tpu_torch.training import graphs

    def make(widths, minimax=None, seed=0):
        domain, bcs, f_model, kw = ac_sa_problem()
        s = tdqt.CollocationSolverND(verbose=False, seed=seed)
        s.compile(widths, f_model, domain, bcs, fused="cuda",
                  minimax=minimax,
                  network=neural_net(widths, precision=None, seed=seed), **kw)
        return s

    widths = None
    for cand in TF32_WIDTHS:
        ct.reset_launch_counts()
        try:
            s = make(cand)
        except ValueError as e:  # the cross-check's band refused the flavor
            cause = e.__cause__
            print(f"[tf32 compile] widths {cand}: refused ({e}; "
                  f"{type(cause).__name__}: {cause})", flush=True)
            continue
        at_compile = _counts_all()
        dist = _crosscheck_distances(s)
        _set_counts(at_compile)  # the distances' launches are not the path's
        print(f"[tf32 compile] widths {cand}: engine {s.engine}; "
              f"cross-check distances to the generic engine (TF32 matmuls): "
              f"values {dist['values']:.3e}, gradients {dist['grads']:.3e} "
              f"(band 5e-3); minimax "
              f"{'adopted' if s._minimax_kind else 'declined'}"
              f"{'' if s._minimax_kind else f' ({s._minimax_fail_reason!r})'}"
              f"; launches in compile {_nonzero(at_compile)}", flush=True)
        if s.engine == "fused-minimax-cuda":
            widths = cand
            break
    if widths is None:
        fail("no width adopts the TF32 flavor's minimax step")
    if s._minimax_sq.flavor != ct.TF32:
        fail(f"K3's flavor is {s._minimax_sq.flavor!r}, not TF32")
    c0 = len(graphs.captures)
    t_fit, launches_adam, caps = _fit_counted(s, tf_iter=TF_ITER)
    launches_adam = _counts_all()
    rows = np.array([r["Total Loss"] for r in s.losses])
    e0 = _lbfgs_counts()[0]
    ct.reset_launch_counts()
    t_lb = _timed_fit(s, newton_iter=TF32_LBFGS)
    launches_lbfgs = _counts_all()
    evals = _lbfgs_counts()[0] - e0
    ms_step = 1e3 * t_fit / TF_ITER
    print(f"[tf32 minimax] {TF_ITER} steps {ms_step:.3f} ms/step "
          f"({_steady_ms(s, 100):.3f} past the first chunk) beside phase 6's "
          f"{phase6_ms:.3f}; loss {rows[0]:.6e} -> {rows[-1]:.6e}; launches "
          f"{_nonzero(launches_adam)}; captures {caps}; L-BFGS "
          f"{TF32_LBFGS} iterations {1e3 * t_lb / TF32_LBFGS:.3f} ms each, "
          f"{evals} evaluations, launches {_nonzero(launches_lbfgs)}, best "
          f"{s.min_loss['l-bfgs']:.6e}", flush=True)
    _captures_since("tf32 minimax", c0)
    if _nonzero(launches_adam) != {"k3_tf32": TF_ITER} or caps != 1:
        fail(f"tf32 Adam leg: launches {launches_adam}, captures {caps}")
    if _nonzero(launches_lbfgs) != {"k3_tf32": evals}:
        fail(f"tf32 L-BFGS leg: launches {launches_lbfgs}, evaluations "
             f"{evals}")
    if not (np.all(np.isfinite(rows)) and rows[-1] < rows[0]
            and s.min_loss["l-bfgs"] < rows[-1]):
        fail("tf32 minimax: the loss did not fall")
    _graph_vs_eager("tf32 minimax", lambda: make(widths), REFEREE_STEPS,
                    REFEREE_STEPS)
    # the unfused loss on the same flavor: K1-TF32 and K2-TF32 per step
    un = make(widths, minimax=False)
    ct.reset_launch_counts()
    t_un = _timed_fit(un, tf_iter=TF32_UNFUSED_STEPS)
    launches_un = _counts_all()
    want = {"k1_tf32": TF32_UNFUSED_STEPS, "k2_tf32": TF32_UNFUSED_STEPS}
    print(f"[tf32 unfused] {TF32_UNFUSED_STEPS} steps "
          f"{1e3 * t_un / TF32_UNFUSED_STEPS:.3f} ms/step; engine "
          f"{un.engine}; launches {_nonzero(launches_un)}", flush=True)
    if un.engine != "fused-cuda" or _nonzero(launches_un) != want:
        fail(f"tf32 unfused: engine {un.engine}, launches {launches_un}")
    return {"tf32-minimax": dict(launches={
                k: at_compile[k] + launches_adam[k] for k in at_compile}),
            "tf32-lbfgs": dict(launches=launches_lbfgs),
            "tf32-unfused": dict(launches=launches_un),
            "widths": widths, "ms_step": ms_step}


def _nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def _residual_mlp_class():
    """A custom ``nn.Module``: a residual MLP with skip connections, ``h
    <- h + tanh(W h + b)`` over ``n_blocks`` blocks between an input and an
    output ``nn.Linear``; ``seed`` fixes its init."""
    import torch
    from torch import nn

    class ResidualMLP(nn.Module):
        def __init__(self, width: int = 128, n_blocks: int = 3,
                     seed: int = 0):
            super().__init__()
            torch.manual_seed(seed)
            self.inp = nn.Linear(2, width)
            self.blocks = nn.ModuleList(nn.Linear(width, width)
                                        for _ in range(n_blocks))
            self.out = nn.Linear(width, 1)

        def forward(self, x):
            h = torch.tanh(self.inp(x))
            for blk in self.blocks:
                h = h + torch.tanh(blk(h))
            return self.out(h)

    return ResidualMLP


def _phase_custom_module() -> dict:
    """Phase 16(c): a custom residual MLP on AC-SA: the generic engine
    through the CUDA graphs, 200 Adam + 20 L-BFGS with no K1-K3 launch,
    graph = eager, ``save`` -> ``load_model(network=)`` -> 10 more steps
    bit for bit, and ``export_surrogate`` -> ``Surrogate.load(net=)`` ->
    the engine serving ``u`` as ``predict`` does."""
    import copy
    import tempfile

    import tensordiffeq_tpu_torch as tdqt
    from tensordiffeq_tpu_torch.serving import Surrogate

    Res = _residual_mlp_class()

    def make(module):
        domain, bcs, f_model, kw = ac_sa_problem()
        s = tdqt.CollocationSolverND(verbose=False, seed=0)
        s.compile(WIDTHS, f_model, domain, bcs, network=module, **kw)
        return s

    s = make(Res())
    t, launches, caps = _fit_counted(s, tf_iter=TF_ITER)
    launches = _counts_all()
    ct_lb = _timed_fit(s, newton_iter=TF32_LBFGS)
    lb_launches = _counts_all()
    rows = np.array([r["Total Loss"] for r in s.losses])
    print(f"[custom] {type(s.net.module).__name__} "
          f"({sum(p.numel() for p in s.net.params()):,} parameters) engine "
          f"{s.engine}; {TF_ITER} steps {1e3 * t / TF_ITER:.3f} ms/step "
          f"({_steady_ms(s, 100):.3f} past the first chunk), captures "
          f"{caps}; L-BFGS {TF32_LBFGS} iterations "
          f"{1e3 * ct_lb / TF32_LBFGS:.3f} ms each; loss {rows[0]:.6e} -> "
          f"{rows[TF_ITER - 1]:.6e} -> {rows[-1]:.6e}; launches "
          f"{_nonzero(launches)}, {_nonzero(lb_launches)}", flush=True)
    if s.engine != "generic" or caps != 1:
        fail(f"custom module: engine {s.engine}, captures {caps}")
    if any(launches.values()) or any(lb_launches.values()):
        fail(f"custom module launched kernels: {launches} {lb_launches}")
    if not (np.all(np.isfinite(rows)) and rows[TF_ITER - 1] < rows[0]
            and s.min_loss["l-bfgs"] < rows[TF_ITER - 1]):
        fail("custom module: the loss did not fall")
    _graph_vs_eager("custom", lambda: make(Res()), REFEREE_STEPS,
                    REFEREE_STEPS)
    grid = np.stack(np.meshgrid(np.linspace(-1, 1, 512),
                                np.linspace(0, 1, 201), indexing="ij"),
                    -1).reshape(-1, 2).astype(np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        s.save(f"{tmp}/model.tdq")
        ref = make(copy.deepcopy(s.net.module))
        domain, bcs, f_model, kw = ac_sa_problem()
        b = tdqt.CollocationSolverND(verbose=False, seed=0)
        b.load_model(f"{tmp}/model.tdq", network=Res(seed=123))
        b.compile(None, f_model, domain, bcs, **kw)
        ref.fit(tf_iter=RESUME_STEPS, chunk=RESUME_STEPS)
        b.fit(tf_iter=RESUME_STEPS, chunk=RESUME_STEPS)
        diff = _state_diff(ref, b)
        s.export_surrogate().save(f"{tmp}/art")
        sur = Surrogate.load(f"{tmp}/art", f_model=f_model, net=Res(seed=7))
    u_pred = s.predict(grid)[0]
    u_srv = np.asarray(sur.engine(**SERVE_LADDER).u(grid)).reshape(
        u_pred.shape)
    err = float(np.abs(u_srv - u_pred).max())
    scale = float(np.abs(u_pred).max())
    print(f"[custom save] load_model(network=) then {RESUME_STEPS} steps vs "
          f"the same steps from a copy of the module: "
          f"{'bit-identical' if diff == 0 else f'differs by {diff:.3e}'}; "
          f"served u vs predict max_abs_err {err:.3e} (scale {scale:.3f})",
          flush=True)
    if diff != 0:
        fail(f"custom module: load_model's steps differ by {diff:.3e}")
    if not err <= SERVE_U_BAND * max(1.0, scale):
        fail(f"custom module: served u differs from predict by {err:.3e}")
    return {"custom": dict(launches=launches),
            "custom-lbfgs": dict(launches=lb_launches)}


def _phase_knobs(phase6_ms: float) -> dict:
    """Phase 16(d): ``MLP(activation=torch.sin)`` and ``neural_net(...,
    dtype=torch.bfloat16)`` on AC-SA: the generic engine, no kernel launch,
    the loss falls over 200 steps, graph = eager over 50."""
    import torch
    import tensordiffeq_tpu_torch as tdqt
    from tensordiffeq_tpu_torch import networks

    out = {}
    for tag, build in (
            ("sin", lambda: networks.MLP(
                WIDTHS, generator=networks.init_generator(0),
                activation=torch.sin)),
            ("bf16", lambda: networks.neural_net(WIDTHS, seed=0,
                                                 dtype=torch.bfloat16))):
        def make():
            domain, bcs, f_model, kw = ac_sa_problem()
            s = tdqt.CollocationSolverND(verbose=False, seed=0)
            s.compile(WIDTHS, f_model, domain, bcs, network=build(), **kw)
            return s

        s = make()
        t, launches, caps = _fit_counted(s, tf_iter=TF_ITER)
        launches = _counts_all()
        rows = np.array([r["Total Loss"] for r in s.losses])
        print(f"[knob {tag}] engine {s.engine}; {TF_ITER} steps "
              f"{1e3 * t / TF_ITER:.3f} ms/step ({_steady_ms(s, 100):.3f} "
              f"past the first chunk; phase 6: {phase6_ms:.3f}); captures "
              f"{caps}; loss {rows[0]:.6e} -> {rows[-1]:.6e}; launches "
              f"{_nonzero(launches)}", flush=True)
        if s.engine != "generic" or caps != 1 or any(launches.values()):
            fail(f"knob {tag}: engine {s.engine}, captures {caps}, "
                 f"launches {launches}")
        if not (np.all(np.isfinite(rows)) and rows[-1] < rows[0]):
            fail(f"knob {tag}: the loss did not fall")
        _graph_vs_eager(f"knob {tag}", make, REFEREE_STEPS, REFEREE_STEPS)
        out[f"knob-{tag}"] = dict(launches=launches)
    return out


def phase_network_options(dev, phase6_ms: float) -> tuple:
    """Phase 16: the network options.  Returns the TF32 kernels'
    measurements and the paths' launches."""
    t0 = time.perf_counter()
    meas = phase_tf32_kernels(dev)
    paths = _phase_tf32_training(phase6_ms)
    paths.update(_phase_custom_module())
    paths.update(_phase_knobs(phase6_ms))
    print(f"[network options] phase wall {time.perf_counter() - t0:.1f} s; "
          f"TF32 training widths {paths.pop('widths')}", flush=True)
    paths.pop("ms_step")
    return meas, paths


def kernels_line(meas: dict, paths: dict) -> str:
    """``launches`` sums a kernel's launches over the runs of every path
    (``launches_by_path`` splits them: minimax, unfused, lbfgs, pool,
    ascent, discovery, phase 13's autotune, schedules, ntk, causal, remat,
    families, phase 14's minimax-bf16, lbfgs-bf16, unfused-bf16,
    serve-bf16, phase 15's zoo, and phase 16's tf32-minimax, tf32-lbfgs,
    tf32-unfused, custom, custom-lbfgs, knob-sin and knob-bf16)."""
    entries = []
    for key, name, source, replaces in (
            ("k1", "taylor_table_fwd (K1)", "csrc/taylor_fwd_wg.cuh",
             "pallas_taylor.py:154"),
            ("k2", "taylor_table_bwd (K2)", "csrc/taylor_table.cu",
             "pallas_taylor.py:171"),
            ("k3", "minimax_step (K3)", "csrc/minimax_step.cu",
             "pallas_minimax.py:259"),
            ("k1_bf16", "taylor_table_fwd bf16 (K1-bf16)",
             "csrc/taylor_fwd_wg.cuh", "pallas_taylor.py:154"),
            ("k2_bf16", "taylor_table_bwd bf16 (K2-bf16)",
             "csrc/taylor_table.cu", "pallas_taylor.py:171"),
            ("k3_bf16", "minimax_step bf16 (K3-bf16)",
             "csrc/minimax_step.cu", "pallas_minimax.py:259"),
            ("k1_tf32", "taylor_table_fwd tf32 (K1-TF32)",
             "csrc/taylor_fwd_wg.cuh", "pallas_taylor.py:154"),
            ("k2_tf32", "taylor_table_bwd tf32 (K2-TF32)",
             "csrc/taylor_table.cu", "pallas_taylor.py:171"),
            ("k3_tf32", "minimax_step tf32 (K3-TF32)",
             "csrc/minimax_step.cu", "pallas_minimax.py:259")):
        m = meas[key]
        by_path = {tag: int(res["launches"].get(key, 0))
                   for tag, res in paths.items()}
        entries.append({
            "name": name, "route": "cuda",
            "source": f"tensordiffeq_tpu_torch/{source}",
            "replaces": f"tensordiffeq_tpu/ops/{replaces}",
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": m["max_abs_err"], "ms": m["ms"],
            "plain_ms": m["plain_ms"], "bound_ms": m["bound"]["ms"],
            "bound_by": m["bound"]["by"],
            # the TF32 flavors: held to the TF32-emulating plain flavor
            # (phase 16's band), timed beside the 3xTF32 flavor
            **({"scale_rel_err": m["scale_rel_err"],
                "rms_rel": m["rms_rel"], "order_spread": m["spread_max"],
                "f32_ms": m["f32_ms"]} if key.endswith("tf32") else {}),
            # K1's route at the slice's shape (the wgmma route's
            # csrc/taylor_fwd_wg.cuh), and its route for wider layers
            # (csrc/taylor_table.cu), held to the plain flavor and timed
            # in phases 3 and 14 at WIDE_WIDTHS; no main path takes it
            **({"k1_route": m["route"]} if "route" in m else {}),
            **({"wide_route": {
                "source": "tensordiffeq_tpu_torch/csrc/taylor_table.cu",
                "widths": WIDE_WIDTHS,
                "max_abs_err": m["wide"]["max_abs_err"],
                "ms": m["wide"]["ms"], "plain_ms": m["wide"]["plain_ms"],
                "bound_ms": m["wide"]["bound"]["ms"],
                "bound_by": m["wide"]["bound"]["by"]}}
               if "wide" in m else {}),
            # no single PyTorch call computes the Taylor table or the
            # fused minimax step
            "library_ms": None})
    return json.dumps({"kernels": entries})


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="after the slices, an A/B of the two paths in "
                    "eight turns of 50 steps, then profile 20 Adam steps of "
                    "each path, twice, in turns, and 20 L-BFGS iterations")
    ap.add_argument("--keep-nets", metavar="DIR",
                    help="keep phase 14's bf16-trained artifact and phase "
                    "10's f32-trained one under DIR (bf16/, f32/)")
    ap.add_argument("--zoo-only", action="store_true",
                    help="build the kernels and run phase 15 (the zoo) "
                    "alone; prints no result line")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    from tensordiffeq_tpu_torch.ops import cuda_taylor as ct
    t0 = time.perf_counter()
    ct.build()
    nvcc_s = ct.build_seconds or 0.0  # 0 when this checkout had the build
    print(f"[build] kernels ready in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {nvcc_s:.2f} s)", flush=True)

    if args.zoo_only:
        phase_zoo(dev)
        print(card, flush=True)
        return
    meas = phase_kernels(dev)
    meas["k3"] = phase_k3(dev)
    phase_yardstick(dev)
    paths = {"minimax": phase_slice(TF_ITER, minimax=None),
             "unfused": phase_slice(TF_ITER, minimax=False)}
    print(f"[paths] ms/step minimax {paths['minimax']['ms_step']:.3f}, "
          f"unfused {paths['unfused']['ms_step']:.3f}", flush=True)
    paths["lbfgs"] = phase_refine(paths)
    phase_graphs()
    serve = phase_serve(paths["minimax"]["solver"], card)
    resample = phase_resample(dev)
    paths["pool"] = resample["pool"]
    paths["ascent"] = resample["ascent"]
    paths["discovery"] = phase_discovery()
    paths.update(phase_options(paths["minimax"]["ms_step"]))
    meas.update(phase_mixed_kernels(dev))
    mixed = phase_mixed_training(paths)
    paths["minimax-bf16"] = mixed["minimax"]
    paths["lbfgs-bf16"] = dict(launches=mixed["minimax"]["lbfgs_launches"])
    paths["unfused-bf16"] = mixed["unfused"]
    paths["serve-bf16"] = phase_mixed_serve(mixed["minimax"]["solver"],
                                            paths["minimax"]["solver"],
                                            serve, card, args.keep_nets)
    paths["zoo"] = phase_zoo(dev)
    tf32_meas, option_paths = phase_network_options(
        dev, paths["minimax"]["ms_step"])
    meas.update(tf32_meas)
    paths.update(option_paths)
    if args.profile:
        phase_ab(paths)
        # in turns, so a slower stretch of the host does not land on one
        # path's window only
        for tag in ("minimax", "unfused", "unfused", "minimax"):
            phase_profile(paths[tag]["solver"], tag)
        # the refinement: where an L-BFGS iteration's time goes
        phase_profile(paths["minimax"]["solver"], "lbfgs", lbfgs=True)
    print(kernels_line(meas, paths), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
