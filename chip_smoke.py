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
   K2 and K3 take the route K2_ROUTES/K3_ROUTES name (``[route K2 ac]``:
   the persistent wgmma route of ``csrc/wg_backward.cuh`` in its 3xTF32
   flavor at these shapes; another route fails the phase), each a second
   launch equal to the first bit for bit, each timed beside its ms on the
   mma.sync route before (F32_BEFORE_WGMMA_MS).
   Each kernel's time is printed beside two bounds: the route it takes
   (its tensor-core products as 3 TF32 passes over the TF32 peak, the rest
   over the FP32 peak, its bytes over the HBM rate) and, for continuity,
   every operation on the FP32 CUDA cores.  Six ``[yardstick]`` lines time
   the same hidden-layer products as cuBLAS matmuls, f32, TF32 and bf16,
   at widths 128 and 256.
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
   back.  Then the wide paths: AC-SA full at WIDE_WIDTHS, where K2 and K3
   take their NP = 256 design and K1 its kernel beside K2, in the f32
   flavor (``wide``, ``wide-lbfgs``, ``wide-unfused``) and with
   ``neural_net(..., precision=None)`` in the TF32 one (``wide-tf32``,
   ``wide-tf32-lbfgs``, ``wide-tf32-unfused``): WIDE_TF_ITER minimax Adam
   steps (K3 once per step, compile's cross-check beside; no K1/K2),
   graphed and eager bit for bit with one capture and the loss falling,
   K3 held on the path's own tensors to its plain flavor (the TF32 one in
   phase 16's band); WIDE_LBFGS L-BFGS iterations (K3 once per
   evaluation, the best below the Adam leg's last); WIDE_UNFUSED unfused
   steps (K1 and K2 once each per step), graphed and eager bit for bit,
   the loss history within the cross-check rtol of the minimax leg's.
   ``--wide-only`` runs phases 3-5, the yardstick and these paths.
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
   (a) K1-bf16 and K2-bf16 (the AC and mixed request sets, and phase 3's
   2-256x4-1, their routes for wider layers) and K3-bf16 (E = 1, the
   coupled E = 2 system, the ``1/x`` residual at N = 50,001, and the AC
   residual at 2-256x4-1) against their plain bf16 flavors
   (``compute_dtype=torch.bfloat16``); gates: every leaf within the
   reference's bf16 bands (5e-2 values, 1.5e-1 gradients, scale-relative),
   and nearer (RMS) the plain bf16 flavor than the plain f32 one, each bit
   for bit run to run; K2-bf16 and K3-bf16 on the route
   K2_BF16_ROUTES/K3_BF16_ROUTES name (``[route K2-bf16 ac]``: the
   persistent wgmma route of ``csrc/wg_backward.cuh`` in its bf16 flavor up
   to 128 wide, the mma.sync kernels at 2-256x4-1; another route fails the
   phase); each timed over 20 launches beside its f32 flavor and beside
   its times before (the TF32-pass route's, and K1-bf16's, K2-bf16's and
   K3-bf16's before the wgmma route, from PERF.md), with its bound (the
   products at the dense bf16 peak: 1 pass per forward product, 3 per
   cotangent product, the passes its route takes); ``--bf16-only`` runs
   the build, the yardstick and this part alone;
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
   the entry's N_f points within 1e-4 scale-relative, K1, K2 and K3 bit for
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
   2-128x4-1, C = 4, E = 1), at ``burgers``' 2-20x8-1 and at WIDE_WIDTHS,
   each against the TF32-emulating plain flavor
   (``taylor_derivatives(emulate_tf32=True)``) and its float64-summed
   twin: the nearer within TF32_SPREAD times the order spread of the same
   semantics (the two referees' distance, at least 1e-4) by RMS, and by
   max also within TF32_FLIP of the emulation's distance to the IEEE
   flavor; nearer the emulation than the IEEE flavor; bit for bit run to
   run; K2-TF32 and K3-TF32 on the route K2_TF32_ROUTES and
   K3_TF32_ROUTES name for the case (``[route ...]``: the persistent
   wgmma route of ``csrc/wg_backward.cuh`` at the slice and ``burgers``,
   its NP = 256 design, ``csrc/wg_backward_wide.cuh``, at WIDE_WIDTHS;
   another route fails the phase); each timed over 20 launches beside the
   3xTF32 flavor, its one-pass bound and the mma.sync route's earlier ms
   (TF32_BEFORE_WGMMA_MS); at WIDE_WIDTHS the mma.sync kernels the NP =
   256 design replaced, held to the same band on the same inputs and
   timed in turns with it (``[time K3-TF32 wide]``); the distance to the
   IEEE flavor printed.  The f32 (3xTF32) K2 and K3 at the
   same three shapes against the IEEE plain flavor (K2_RTOL, K3_RTOL), on
   the route K2_ROUTES/K3_ROUTES name (wgmma at the slice and ``burgers``,
   mma.sync at WIDE_WIDTHS), bit for bit run to run, timed.
   ``--tf32-only`` runs the build, the yardstick and this part alone.  (b) AC-SA full with
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
17. data parallelism (``compile(dist=...)``, ``tensordiffeq_tpu_torch.
   parallel``).  (a) World 1 over NCCL (a ``file://`` rendezvous) at the
   reference's multi-GPU configuration (``examples/ac_dist.py``: AC-SA at
   N_f = 500,000, 2-128x4-1, ``fused="cuda"``): 200 Adam steps, 20 L-BFGS
   iterations and ``predict`` with K3 once in compile's cross-check, once
   per step and once per evaluation, no K1/K2 in ``fit``, one capture;
   K3 then held to its plain flavor at the full 500,000 rows (the value,
   the parameters' gradients, gw, the per-point λ gradient and gX);
   peak device memory; 50 steps bit for bit against the non-dist solver
   from the same seed and against the same steps run eagerly; ms/step of
   both in the same call and the share of a step in NCCL kernels
   (``torch.profiler``); then 50 steps of ``minimax=False`` (K1 and K2 once
   each per step) and 20 of ``fused_dtype="bfloat16"`` (K3-bf16 per
   step), each path's kernels held to their plain flavor at 500,000 rows
   (K1/K2 at K1_RTOL/K2_RTOL, K3-bf16 within the bf16 bands, on the
   route K3_BF16_ROUTES names).
   (c) ``InferenceEngine(shard=True)`` at world 1 serves ``u`` bit for
   bit like ``shard=False``.  (b) Two processes on the one card over
   gloo (``--dist-worker``; NCCL refuses two ranks on one device) at
   N_f = 50,000: K3 at each rank's 25,000-row block held to its plain
   flavor; one loss-and-gradient evaluation (the value, the parameters'
   gradients and rank 0's per-point λ gradient) within DIST_EVAL_TOL of
   world 1, 20 Adam steps within DIST_TRAJ_RTOL of world 1, K3 once per
   step on each rank, the ranks' parameters bit-identical; their sharded
   checkpoint restored at world 1 for 10 more steps; ms/step, two
   processes sharing one card, not a scaling figure.  The world-1
   reference runs in rank 0's process after its gloo steps, through its
   CUDA graph: one capture, bit for bit its eager run.  (d) The options
   whose statistic spans the ranks at N_f = 50,000: causal weighting (its
   bin sums all-reduced inside the captured step; the unfused path, K1 and
   K2 once per step) and NTK weighting (its residual trace over the global
   subsample; K3 once per step), each 50 steps at world 1 over NCCL bit for
   bit the non-dist solver and its eager steps, one capture; and 20 steps
   of each at world 2 over gloo within DIST_TRAJ_RTOL of world 1, the
   ranks' parameters bit-identical.  Every process runs under
   DIST_TIMEOUT_S.  ``--dist-only`` runs the build and this phase.
18. the operational planes around the K3 training path, on AC-SA full
   (the JAX package's ``examples/ac_resilient.py``).  (a) ``ResilientFit(
   checkpoint_every=50, max_retries=3, resume_on_preemption=True)`` under
   ``Chaos(nan_epoch=150, preempt_epoch=350)`` with a run log, a tracer
   and a flight recorder, 500 Adam steps in chunks of 50 and 20 L-BFGS
   iterations: the plan fires a NaN and a preemption; one rollback, to
   epoch 150, remedy ``lr_backoff``; all 500 epochs, every loss finite,
   the last below the one before the NaN; K3 once per executed Adam step
   and per L-BFGS evaluation, nothing else; at most two Adam captures; the
   divergence's ``trace_id`` names its span tree; ``flight.jsonl`` holds
   the divergence's and the preemption's sections; ``report`` narrates
   them; the rollback's and the flush's seconds.  (b) 300 steps under an
   empty ``Chaos()`` with a tracer and a flight recorder against a plain
   fit: bit for bit, the same K3 count and captures; replay-only ms/step
   of both.  (c) a chaos preemption at 150 resumed by ``auto_resume`` to
   300, bit for bit the plain 300; an L-BFGS leg preempted at its first
   chunk boundary and resumed, bit for bit the leg split there; a child
   process (``--resilience-child``) under ``PreemptionHandler`` gets
   SIGTERM after its first checkpoint, exits 75, and its relaunch resumes
   from the flushed epoch and ends bit for bit the plain 300; flush and
   restore seconds.  (d) the (a) solver's engine behind a
   ``RequestBatcher`` with retry and breaker under ``Chaos(
   serving_fail_rate=0.25, compile_fail_buckets=(512,))``, 2,000 requests:
   retried, none failed or hung, the 512 rung alone quarantined, answers
   bit for bit the chaos-off engine routed alike (within 1e-6 of a clean
   one) and with tracing on, each query's span tree, no K1-K3 launch.
   (e) ``ClusterSupervisor`` over two gloo workers on the card
   (``--cluster-worker``; AC-SA full, 20 steps, checkpoints every 5) under
   ``TDQ_CHAOS=host_loss_at=10``, a tracer and a collector mounted before
   launch: one host lost (rank 1, by its exit), one relaunch at world 1
   ending within DIST_TRAJ_RTOL of an uninterrupted world-1 run; one
   stitched Perfetto trace over the supervisor, both workers and the
   relaunch; ``/metrics`` merges the workers; the killed worker's flight
   ring ends in the chunk it died in; the recovery wall.  (c)'s process
   and (e) run in threads beside (a) and (d); every process under
   RES_TIMEOUT_S.  ``--resilience-only`` runs the build and this phase.
19. the surrogate factory (``tensordiffeq_tpu_torch.factory``).  (a) A
   1-member family at AC-SA full (2-128x4-1, N_f = 50,000, SA λ) on
   ``fused="cuda"``: 200 steps bit for bit its solo solver, K3 once per
   step, one capture.  (b) The JAX package's factory benchmark
   (``bench.py --mode factory``): 64 Allen-Cahn members, theta_m =
   1e-4 (0.5 + m/63), N_f = 2,048 each, 2-64-64-1: K3 over the member axis
   (``k3_minimax_family``) once per family step and tape group (the sweep
   is one group), no member's own K3 and no K1/K2, one capture; 50 steps
   bit for bit the same
   steps run eagerly; a member filled with NaN frozen at epoch 0 and the
   other 63 bit for bit; members 0 and 63 within FAC_SOLO_TOL of
   matched-seed solo solvers over 20 steps; 200 steps in all, the loss
   falling; ms per family step, points/s, and the solo member's ms/step
   x 64, the sequential baseline, both over the same 150 replayed steps
   in chunks of 50 with no capture inside the timed window; then members
   0 and 63's K3, each through its own lowered tape, on their live rows,
   parameters and w = λ², against the plain flavor at K3_RTOL; then the
   member-axis K3 at the same tensors in the f32, bf16 and TF32 flavors
   (``_fac_member_k3``): every member's value, dW/db, gw and gX bit for
   bit its single launch's, bit for bit run to run, members 0 and 63
   within K3_RTOL (f32) or the bf16 bands of the plain flavor (TF32: its
   distances to its emulation and phase 16's band reported); the launch
   and the 64 single launches by CUDA events over 20, its bound, and the
   yardstick (the family's products as ``torch.bmm``, f32).  (c) A pool
   redraw (K1 per member) and an ascent redraw (the member-axis K3 six
   times) at M = 64 in a fit: device
   ms on the redraw stream; then one redraw adopted directly, each
   member's λ and λ moments carried bit for bit.  (d) A checkpoint round
   trip: 10 more steps bit for bit.  (e) Members 0 and 63 served
   (``member_surrogate(m)``): ``u`` within FAC_SERVE_TOL of the member's
   network.  ``--factory-only`` runs the build and this phase.
20. the nineteen ``examples_torch/`` scripts, in this process, with
   ``--quick`` on the card: rc 0 each, its wall.  ``--examples-only`` runs
   the build and this phase.
21. the serving fleet (``tensordiffeq_tpu_torch.fleet``).  (a) The JAX
   package's fleet benchmark (``bench.py --mode fleet``): four AC-SA
   tenants at full width (2-128x4-1, N_f = 50,000, FLEET_STEPS Adam steps
   each), exported at the ladder 256-4096 with the kinds ``u`` and
   ``residual``, served in a fresh process (``--fleet-child``) by a
   ``FleetRouter(max_loaded=3)`` with t2 and t3 loaded with no f_model
   (their residual from the lowered tape: K1's table, then the tape,
   captured as each rung's graph).  Gates: every rung captured once at
   load; the warm tenant's first query captures nothing; the tape within
   the cross-check band of the generic program; K1 at 4,096 rows against
   its plain flavor within K1_RTOL; one tape query per rung launches K1
   once each; 2,000 mixed requests (1-4,096 rows, 70 % u) through the
   batchers behind admission, in segments that evict and reload: 0
   request-time captures (captures beyond the reloads' warm starts),
   every 10th answer (a synchronous query) bit for bit a direct engine
   over the same artifact warm-started alike, the batched answers within
   FLEET_CROSS_RUNG of it, none hung, K1 exactly once per tape-rung run
   (plus three warm-ups per capture) and no K2 or K3; a rate-limit burst
   shed as ``AdmissionRejected``; one tenant through three evict-reload
   cycles, its quarantine kept and its rungs captured again each time;
   two hot swaps while another thread queries, no error, no dropped
   waiter.  Printed: the cold first query (capture included) against the
   warm one, each tenant's load wall, requests/s, the tape rung's replay
   ms against the generic rung's at 4,096.  (b) The JAX package's
   closed-loop benchmark (``bench.py --mode closedloop``): 4 members
   (2-64-64-1, N_f = 2,048), 600 steps, ``export_family``, served; drift
   0.8 in place trips the monitor; a 600-step retrain warm-started from
   the served parameters with pool redraws, and a hot swap of all four.
   Gates: the member-axis K3 once per family step (no member's own K3)
   and K1 4 per redraw in the
   retrain, one capture of the family step, every tenant swapped, the
   probe residual below the drifted one, no capture at request time
   across the cutover.  Printed: queries to trip, detection and retrain
   wall, cutover stall p50, MTTR.  (c) The JAX package's replicated
   benchmark (``bench.py --mode fleetha``): a ``ReplicaGroup`` of two
   replica processes on the card (ladder 64-128), 200 queries through a
   ``FrontRouter`` under ``TDQ_CHAOS=host_loss_at=50,host_loss_rank=1``,
   in a thread beside (b).  Gates: no request lost, answers bit for bit
   direct engines, no request-time capture on the survivor, the slot
   respawned warm at the same endpoint.  Printed: p50/p99 across the
   incident and the respawn wall (two processes on one card: not a
   scaling figure).  Every process under FLEET_TIMEOUT_S.
   ``--fleet-only`` runs the build and this phase.
22. static analysis on the port (``tensordiffeq_tpu_torch.analysis``).
   (a) The AST rules over the checkout, in this process: zero findings.
   (b) Each captured step at full width, captured once more as a
   debug-mode twin (``dispatch_audit.audit_graph``: ``CUDAGraph(keep_graph=
   True)``, ``enable_debug_mode``, ``debug_dump``) and read: AC-SA full's
   minimax Adam step (K3), its unfused step (K1 + K2) and its L-BFGS
   evaluation (K3); the serving rungs ``u`` and ``residual`` at 4,096 and
   the fleet's tape rung (K1, the residual from the lowered tape of a
   surrogate with no f_model); the closed loop's 4-member family,
   2-64-64-1 at N_f = 2,048 (the member-axis K3 once).  One line per
   graph: its
   nodes, the port's kernel nodes by name, memcpy nodes by direction, host
   nodes.  Gates: no host-to-device or device-to-host memcpy node and no
   host node in any graph; each wrapper's kernel nodes equal the launches
   per replay the capture recorded, and those are the step's; a 50-step
   chunk of each Adam step synchronises once (its history read) and 10
   line-search iterations as often as ``lbfgs_minimize.host_syncs`` says
   (``torch.cuda.set_sync_debug_mode``); a device-to-host copy into pinned
   memory planted in a captured toy step is flagged; the phase within
   AUDIT_WALL_S.  ``--audit-only`` runs the build and this phase.
23. a ``{"kernels": [...]}`` line (K1, K2, K3, their bf16 and their TF32
   flavors, each held to its plain version; K1's with the route it took and
   its wide route's measurements as ``wide_route``; the TF32 flavors with
   their distances and the 3xTF32 flavor's ms; K2's and K3's (f32, bf16
   and TF32) with the route they took at the slice (``k2_route``/
   ``k3_route``, ``tf32_route``) and its source, their mma.sync route at
   WIDE_WIDTHS (``old_route``) and their flavor's nine products'
   ``torch.matmul`` ms (``yardstick_ms``: f32, bf16 or TF32);
   ``launches_by_path`` has every
   path's launches, phases 17-22's included), the card line again, and the
   result line.

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
# these shapes: K1 7.6e-6 (4.8e-6 before its wgmma route), K2 3.2e-6 on
# its wgmma route (1.1e-6 on the mma.sync one) (PERF.md).
K1_RTOL = 1e-4
K2_RTOL = 1e-4
# K3 vs its plain flavor, the same measure over the value, every dW/db leaf,
# gw and gX: the same product numerics, another summation order (the value
# and dW/db sum 50,000 points).  The head bias's gradient is one sum over
# every point that cancels, so a drift of the hidden activations toward
# zero shows in it first: the wgmma route's forward sums each weight
# chunk's passes in an accumulator of its own for that reason
# (csrc/wg_backward.cuh, scripts/torch_tc_accumulation_witness.py)
K3_RTOL = 1e-4

AC_REQUESTS = {(), (1,), (0, 0)}
MIXED_REQUESTS = {(), (0,), (1,), (0, 0), (0, 1), (0, 0, 1), (0, 0, 0, 0)}
WIDTHS = [2, 128, 128, 128, 128, 1]
# the slice's net at twice the width: K1's shapes past its wgmma route
# (hidden widths over 128), which take the kernel beside K2; the f32 and
# TF32 K2's and K3's NP = 256 design (csrc/wg_backward_wide.cuh); the bf16
# K2/K3's mma.sync kernels
WIDE_WIDTHS = [2, 256, 256, 256, 256, 1]
# the wide paths (AC-SA full at WIDE_WIDTHS, f32 and TF32): minimax Adam
# steps (two paths share the smoke's time), L-BFGS iterations after them,
# unfused steps
WIDE_TF_ITER, WIDE_LBFGS, WIDE_UNFUSED = 100, 20, 50
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
# K2-bf16's and K3-bf16's ms on the mma.sync kernels, before their wgmma
# route (PERF.md §6, an NVIDIA H100 80GB HBM3 at 700 W), printed beside
# this run's; the same-call comparison is scripts/torch_tf32_time.py's
# --flavor bf16 on an older checkout
BF16_BEFORE_WGMMA_MS = {"K2-bf16 ac": 2.403, "K3-bf16 ac": 2.677,
                        "K3-bf16 system": 2.753}
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
# the route K2-TF32 and K3-TF32 must take in each case of phase 16(a) and
# on the wide TF32 path: the persistent wgmma route at the slice's and
# burgers' shapes (csrc/wg_backward.cuh) and at WIDE_WIDTHS (its NP = 256
# design, csrc/wg_backward_wide.cuh; phase 16(a) times the mma.sync
# kernels it replaced there in turns with it)
K2_TF32_ROUTES = {"ac": "wgmma", "burgers": "wgmma", "wide": "wgmma"}
K3_TF32_ROUTES = {"ac": "wgmma", "burgers": "wgmma", "wide": "wgmma"}
# the route the f32 (3xTF32) K2 and K3 must take in each case of phases 3-5
# and 16(a): the same wgmma route in its f32 flavor at the slice's (the AC
# and mixed request sets; E = 2 and the 1/x residual) and burgers' shapes,
# and at WIDE_WIDTHS its NP = 256 design (csrc/wg_backward_wide.cuh)
K2_ROUTES = {"ac": "wgmma", "mixed": "wgmma", "burgers": "wgmma",
             "wide": "wgmma"}
K3_ROUTES = {"ac": "wgmma", "system": "wgmma", "singular": "wgmma",
             "burgers": "wgmma", "wide": "wgmma"}
# the route K2-bf16 and K3-bf16 must take in each case of phases 14 and 17:
# the wgmma route in its bf16 flavor at the slice's shapes (the AC and
# mixed request sets; E = 2, the 1/x residual, 500,000 rows), the mma.sync
# kernels at WIDE_WIDTHS
K2_BF16_ROUTES = {"ac": "wgmma", "mixed": "wgmma", "wide": "mma"}
K3_BF16_ROUTES = {"ac": "wgmma", "system": "wgmma", "singular": "wgmma",
                  "dist": "wgmma", "wide": "mma"}
ROUTE_SOURCES = {("k2", "wgmma"): "csrc/wg_backward.cuh",
                 ("k3", "wgmma"): "csrc/wg_backward.cuh",
                 ("k2", "mma"): "csrc/taylor_table.cu",
                 ("k3", "mma"): "csrc/minimax_step.cu"}
# each kernel's route at WIDE_WIDTHS in the f32 and TF32 flavors
WIDE_ROUTE_SOURCES = {"k1": "csrc/taylor_table.cu",
                      "k2": "csrc/wg_backward_wide.cuh",
                      "k3": "csrc/wg_backward_wide.cuh"}
# the f32 K2's and K3's ms on the mma.sync route at the slice (PERF.md §6,
# an NVIDIA H100 80GB HBM3 at 700 W), printed beside this run's; the
# same-call comparison is scripts/torch_tf32_time.py's --flavor f32 on an
# older checkout
F32_BEFORE_WGMMA_MS = {"K2 ac": 3.672, "K3 ac": 3.932}
# K2-TF32's and K3-TF32's ms before their wgmma route, on the mma.sync
# kernels (PERF.md §6, an NVIDIA H100 80GB HBM3 at 700 W), printed beside
# this run's; the same-call comparison is scripts/torch_phase_split.py's
# with --tree on an older checkout
TF32_BEFORE_WGMMA_MS = {"K2-TF32 ac": 3.177, "K3-TF32 ac": 3.528,
                        "K2-TF32 burgers": 2.203, "K3-TF32 burgers": 2.381}


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


def _errs(got, want) -> tuple:
    """The largest absolute and scale-relative errors over leaf pairs."""
    worst_a, worst_r = 0.0, 0.0
    for a_k, a_p in zip(got, want):
        a, r = scaled_err(a_k, a_p)
        worst_a, worst_r = max(worst_a, a), max(worst_r, r)
    return worst_a, worst_r


def phase_kernels(dev) -> dict:
    """Phases 3-4: each kernel against its plain flavor, at the slice's
    shapes and on ``WIDE_WIDTHS`` (K1's route for wider layers, K2's NP =
    256 design, timed beside the mma.sync kernel it replaced on the same
    inputs).  Returns the measurements of the Allen-Cahn request set, the
    wide case's under ``k1["wide"]`` and ``k2["wide"]``, K2's mma.sync
    kernel there under ``k2["old_route"]``."""
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
            out[label] = dict(
                k1=dict(max_abs_err=k1_abs, ms=k1_ms, plain_ms=k1_plain_ms,
                        bound=b1, route=route, bit_identical=k1_bits),
                k2=_wide_k2(plan, X, flat, params, pairs, rng, flops,
                            nbytes))
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
        k2_route = _wb_route(plan, "k2", label)
        k2_bits = _bit_identical_run_to_run(
            f"K2 {label}", torch.cat([dflat, dX.reshape(-1)]),
            lambda: torch.cat([t.reshape(-1) for t in
                               ct.k2_backward(plan, X, flat, g)[::-1]]))

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
        was = F32_BEFORE_WGMMA_MS.get(f"K2 {label}")
        print(f"[time {label}] K2 {k2_ms:.3f} ms on the {k2_route} route"
              f"{'' if was is None else f' (mma.sync route: {was:.3f} ms)'}"
              f" (plain fwd+bwd {k2_plain_ms:.3f} ms), "
              f"{bound_text(k2_ms, b2)}", flush=True)
        out[label] = dict(
            k1=dict(max_abs_err=k1_abs, ms=k1_ms, plain_ms=k1_plain_ms,
                    bound=b1, route=route, bit_identical=k1_bits),
            k2=dict(max_abs_err=k2_abs, ms=k2_ms, plain_ms=k2_plain_ms,
                    bound=b2, route=k2_route, bit_identical=k2_bits))
    out["ac"]["k1"]["wide"] = out["wide"]["k1"]
    out["ac"]["k2"]["wide"] = out["wide"]["k2"]
    out["ac"]["k2"]["old_route"] = out["wide"]["k2"].pop("old_route")
    return out["ac"]


def _wide_k2(plan, X, flat, params, pairs, rng, flops, nbytes) -> dict:
    """Phase 4 at WIDE_WIDTHS: K2 on the route K2_ROUTES["wide"] names
    against autograd of the plain flavor (K2_RTOL), bit for bit run to
    run, timed beside its plain flavor and beside the mma.sync kernel on
    the same inputs (``old_route``: held to the same band)."""
    import torch
    from tensordiffeq_tpu_torch.ops import cuda_taylor as ct
    from tensordiffeq_tpu_torch.ops.taylor import taylor_derivatives
    channels = plan.channels
    g = torch.as_tensor(rng.randn(plan.C, N_POINTS, 1), dtype=torch.float32,
                        device=X.device)
    Xg = X.clone().requires_grad_(True)

    def plain_grads():
        t = taylor_derivatives(pairs, Xg, set(channels), flat_matmul=True)
        loss = sum((t[mi] * g[c]).sum() for c, mi in enumerate(channels))
        return torch.autograd.grad(loss, params + [Xg])

    before = ct.k2_backward.launches
    dX, dflat = ct.k2_backward(plan, X, flat, g)
    torch.cuda.synchronize()
    ref = plain_grads()
    k2_abs, k2_rel = _errs(plan.unpack(dflat) + [dX], ref)
    odX, odflat = ct.k2_mma(plan, X, flat, g, 0)
    torch.cuda.synchronize()
    old_abs, old_rel = _errs(plan.unpack(odflat) + [odX], ref)
    print(f"[K2 wide] max_abs_err={k2_abs:.3e} scale_rel_err={k2_rel:.3e}; "
          f"the mma.sync kernel max_abs_err={old_abs:.3e} "
          f"scale_rel_err={old_rel:.3e} (tol {K2_RTOL:g} on each)",
          flush=True)
    if not (k2_rel <= K2_RTOL and old_rel <= K2_RTOL):
        fail("K2 disagrees with autograd of the plain flavor (wide)")
    route = _wb_route(plan, "k2", "wide")
    bits = _bit_identical_run_to_run(
        "K2 wide", torch.cat([dflat, dX.reshape(-1)]),
        lambda: torch.cat([t.reshape(-1) for t in
                           ct.k2_backward(plan, X, flat, g)[::-1]]))
    # in turns: the new route, the mma.sync kernel, twice
    ms, old_ms = [], []
    for _ in range(2):
        ms.append(cuda_ms(lambda: ct.k2_backward(plan, X, flat, g)))
        old_ms.append(cuda_ms(lambda: ct.k2_mma(plan, X, flat, g, 0)))
    plain_ms = cuda_ms(plain_grads, reps=3)
    ct.k2_backward.launches = before  # not the main path's launches
    b2 = bound_ms(flops["k2"], nbytes["k2"])
    print(f"[time wide] K2 {min(ms):.3f} ms on the {route} route (turns "
          f"{', '.join(f'{v:.3f}' for v in ms)}), the mma.sync kernel "
          f"{min(old_ms):.3f} ms ({', '.join(f'{v:.3f}' for v in old_ms)}), "
          f"plain fwd+bwd {plain_ms:.3f} ms; {bound_text(min(ms), b2)}",
          flush=True)
    return dict(max_abs_err=k2_abs, ms=min(ms), plain_ms=plain_ms,
                bound=b2, route=route, bit_identical=bits,
                old_route=dict(route="mma", max_abs_err=old_abs,
                               ms=min(old_ms), plain_ms=plain_ms, bound=b2))


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
    """Phase 5: K3 against its plain flavor, at the slice's shapes and at
    WIDE_WIDTHS (the NP = 256 design, timed beside the mma.sync kernel on
    the same inputs).  Returns the measurements of the Allen-Cahn case (the
    slice's shapes), the wide case's under ``wide``, the mma.sync kernel's
    there under ``old_route``."""
    import torch
    from tensordiffeq_tpu_torch.networks import neural_net
    from tensordiffeq_tpu_torch.ops import cuda_minimax as cm
    from tensordiffeq_tpu_torch.ops.fused import analyze_f_model
    from tensordiffeq_tpu_torch.ops.minimax import build_minimax_sq_fn

    cases = (  # label, residual, widths, N, x range
        ("ac", _ac_residual, WIDTHS, N_POINTS, (-1.0, 1.0)),
        ("system", _coupled_residual, WIDTHS[:-1] + [2], N_POINTS,
         (-1.0, 1.0)),
        ("singular", _singular_residual, WIDTHS, N_POINTS + 1, (0.5, 1.5)),
        ("wide", _ac_residual, WIDE_WIDTHS, N_POINTS, (-1.0, 1.0)))
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
        route = _wb_route(plan, "k3", label)
        bits = _bit_identical_run_to_run(
            f"K3 {label}", torch.cat([t.reshape(-1) for t in
                                      (val, dflat, gw, gX)]),
            lambda: torch.cat([t.reshape(-1) for t in
                               cm.k3_minimax(plan, X, w, flat)]))
        ms = cuda_ms(lambda: cm.k3_minimax(plan, X, w, flat))
        plain_ms = cuda_ms(lambda: sq.plain(flat_layers, w, X), reps=5)
        # comparison launches are not the main path's: restore the count
        cm.k3_minimax.launches = before
        bound = bound_ms(cm.flop_count(plan, n)["k3"],
                         cm.byte_count(plan, n)["k3"])
        was = F32_BEFORE_WGMMA_MS.get(f"K3 {label}")
        print(f"[time K3 {label}] K3 {ms:.3f} ms on the {route} route"
              f"{'' if was is None else f' (mma.sync route: {was:.3f} ms)'}"
              f" (plain fwd+bwd {plain_ms:.3f} ms), {bound_text(ms, bound)}",
              flush=True)
        out[label] = dict(max_abs_err=k3_abs, ms=ms, plain_ms=plain_ms,
                          bound=bound, route=route, bit_identical=bits)
        if label == "wide":
            out[label]["old_route"] = _wide_k3_old(plan, X, w, flat, want,
                                                   ms, plain_ms, bound)
    out["ac"]["wide"] = out["wide"]
    out["ac"]["old_route"] = out["wide"].pop("old_route")
    return out["ac"]


def _wide_k3_old(plan, X, w, flat, want, ms, plain_ms, bound) -> dict:
    """K3's mma.sync kernel at WIDE_WIDTHS on phase 5's inputs: held to the
    plain flavor (K3_RTOL) and timed in turns with the NP = 256 design."""
    import torch
    from tensordiffeq_tpu_torch.ops import cuda_minimax as cm
    val, dflat, gw, gX = cm.k3_mma(plan, X, w, flat, 0)
    torch.cuda.synchronize()
    got = [val.reshape(1)] + [g.reshape(-1) for g in plan.unpack(dflat)] \
        + [gw, gX]
    old_abs, old_rel = _errs(got, want)
    if not old_rel <= K3_RTOL:
        fail(f"K3's mma.sync kernel disagrees with its plain flavor (wide): "
             f"{old_rel:.3e}")
    before = cm.k3_minimax.launches
    new_ms, old_ms = [ms], []
    for _ in range(2):
        old_ms.append(cuda_ms(lambda: cm.k3_mma(plan, X, w, flat, 0)))
        new_ms.append(cuda_ms(lambda: cm.k3_minimax(plan, X, w, flat)))
    cm.k3_minimax.launches = before  # not the main path's launches
    print(f"[time K3 wide] in turns: the NP = 256 design "
          f"{', '.join(f'{v:.3f}' for v in new_ms)} ms, the mma.sync kernel "
          f"{', '.join(f'{v:.3f}' for v in old_ms)} ms (its scale_rel_err "
          f"{old_rel:.3e}, plain fwd+bwd {plain_ms:.3f} ms); "
          f"{bound_text(min(old_ms), bound)}", flush=True)
    return dict(route="mma", max_abs_err=old_abs, ms=min(old_ms),
                plain_ms=plain_ms, bound=bound)


def phase_yardstick(dev) -> dict:
    """What the card's own GEMM does on the hidden-layer products of K2 and
    K3: torch.matmul on [N*C, W] x [W, W] (C = 4), the forward H W, dW =
    H^T dP and dH = dP W^T, three of each as in one K2 or K3 launch (K1
    takes the three forward ones), with TF32 off (the f32 flavors'
    yardstick), on (the TF32 flavor's: one pass), and on bf16 operands
    (the bf16 flavor's), at the slice's W = 128 and at WIDE_WIDTHS' 256
    (the NP = 256 design's, f32 and TF32, and the bf16 mma.sync kernels').
    A yardstick only: the port never calls it."""
    import torch
    g = torch.Generator(device=dev).manual_seed(0)
    rows = N_POINTS * 4
    out = {}
    for width, suffix in ((128, ""), (256, "_wide")):
        H = torch.rand(rows, width, generator=g, device=dev) * 2 - 1
        dP = torch.randn(rows, width, generator=g, device=dev)
        W = torch.randn(width, width, generator=g, device=dev) / width ** 0.5
        for kind in ("f32", "tf32", "bf16"):
            torch.backends.cuda.matmul.allow_tf32 = kind == "tf32"
            h, p, w = ((H, dP, W) if kind != "bf16" else
                       (t.to(torch.bfloat16) for t in (H, dP, W)))
            try:
                fwd = cuda_ms(lambda: [h @ w for _ in range(3)], reps=10)
                dw = cuda_ms(lambda: [h.t() @ p for _ in range(3)], reps=10)
                dh = cuda_ms(lambda: [p @ w.t() for _ in range(3)], reps=10)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
            text = {"f32": "f32 (allow_tf32=False)",
                    "tf32": "TF32 (allow_tf32=True)",
                    "bf16": "bf16 (bf16 operands)"}[kind]
            at = "" if width == 128 else " at WIDE_WIDTHS"
            print(f"[yardstick] torch.matmul {text}, [{rows}, {width}] x "
                  f"[{width}, {width}], three of each: forward {fwd:.3f} ms, "
                  f"dW {dw:.3f} ms, dH {dh:.3f} ms; the nine of K2/K3{at} "
                  f"{fwd + dw + dh:.3f} ms, the three of K1 {fwd:.3f} ms "
                  f"(cuBLAS, not used by the port)", flush=True)
            out[kind + suffix] = dict(fwd_ms=fwd, dw_ms=dw, dh_ms=dh,
                                      nine_ms=fwd + dw + dh)
        del H, dP, W
    return out


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


def phase_wide(tf32: bool = False) -> dict:
    """The wide path: AC-SA full (N_f = 50,000, SA λ) at WIDE_WIDTHS, where
    K3 and K2 take their NP = 256 design (csrc/wg_backward_wide.cuh) and K1
    its kernel beside K2, in the f32 flavor, or (``tf32``) with
    ``neural_net(WIDE_WIDTHS, precision=None)`` in the TF32 one (K3-TF32,
    K2-TF32, K1-TF32).  WIDE_TF_ITER minimax Adam steps (K3 once in
    compile's cross-check and once per step, no K1/K2), graphed and eager
    from one seed, held bit for bit with one capture; then WIDE_LBFGS
    L-BFGS iterations on the graphed solver (K3 once per evaluation, no
    K1/K2); then WIDE_UNFUSED unfused steps (K1 and K2 once per step),
    graphed and eager bit for bit, and their loss history held to the
    minimax leg's over the same steps (one loss by two engines: within
    SERVE_CROSSCHECK_RTOL, the engines' cross-check rtol).  Each leg's
    counts are set to 0 just before it and read just after; the minimax
    leg's loss falls and L-BFGS's best is below it; K3 is held on the
    path's own tensors to its plain flavor (``_held_k3``; the TF32 flavor
    to its emulation in phase 16's band, ``_held_k3_tf32``), and in the
    f32 flavor K1/K2 too (``_held_k1_k2``).  Returns the paths "wide",
    "wide-lbfgs", "wide-unfused" (``tf32``: "wide-tf32", "wide-tf32-lbfgs",
    "wide-tf32-unfused")."""
    import tensordiffeq_tpu_torch as tdqt
    from tensordiffeq_tpu_torch.networks import neural_net
    from tensordiffeq_tpu_torch.ops import cuda_taylor as ct

    flavor, tag = (ct.TF32, "wide-tf32") if tf32 else (None, "wide")
    k1, k2, k3 = (("k1_tf32", "k2_tf32", "k3_tf32") if tf32 else
                  ("k1", "k2", "k3"))
    k2_routes, k3_routes = ((K2_TF32_ROUTES, K3_TF32_ROUTES) if tf32 else
                            (K2_ROUTES, K3_ROUTES))
    compiles = []

    def make(minimax=None):
        def build():
            domain, bcs, f_model, kw = ac_sa_problem()
            s = tdqt.CollocationSolverND(verbose=False, seed=0)
            if tf32:
                kw = dict(kw, network=neural_net(WIDE_WIDTHS, precision=None,
                                                 seed=0))
            before = _counts_all()
            s.compile(WIDE_WIDTHS, f_model, domain, bcs, fused="cuda",
                      minimax=minimax, **kw)
            compiles.append(_nonzero({k: v - before[k] for k, v in
                                      _counts_all().items()}))
            return s
        return build

    out = {}
    r = _graph_vs_eager(f"{tag} minimax", make(), WIDE_TF_ITER, 50,
                        _counts_all)
    solver = r["graph"]
    sq = solver._minimax_sq
    route = None if sq is None else sq.plan.k3_routes.get(flavor)
    loss = np.array([row["Total Loss"] for row in solver.losses])
    ms_step = 1e3 * r["seconds"] / WIDE_TF_ITER
    launches = _nonzero(r["launches"])
    print(f"[{tag} minimax] engine {solver.engine}, "
          f"{k3.upper().replace('_', '-')} on the "
          f"{route} route; compile's launches {compiles[0]}; {WIDE_TF_ITER} "
          f"steps {ms_step:.3f} ms/step (the fit's wall, its capture "
          f"included; replays {_steady_ms(solver, 50):.3f} ms/step); loss "
          f"{loss[0]:.6e} -> {loss[-1]:.6e}; launches {launches}",
          flush=True)
    if solver.engine != "fused-minimax-cuda" or sq.flavor != flavor \
            or route != k3_routes["wide"]:
        fail(f"the {tag} path ran {solver.engine} "
             f"({solver._minimax_fail_reason!r}), K3 on {route}")
    if compiles[0].get(k3) != 1:
        fail(f"{tag} compile: launches {compiles[0]}, not one K3 "
             "cross-check")
    if launches != {k3: WIDE_TF_ITER}:
        fail(f"{tag} minimax: launches {launches}, not {k3} x "
             f"{WIDE_TF_ITER} alone")
    if not (np.all(np.isfinite(loss)) and loss[-1] < loss[0]):
        fail(f"{tag} minimax: the loss did not fall (or is not finite)")
    (_held_k3_tf32 if tf32 else _held_k3)(f"{tag} minimax held", solver)
    out[tag] = dict(launches={k: compiles[0].get(k, 0) + v
                              for k, v in r["launches"].items()},
                    ms_step=ms_step, steady_ms=_steady_ms(solver, 50))
    minimax_loss = loss
    del r
    # the L-BFGS leg after it
    ct.reset_launch_counts()
    e0, _ = _lbfgs_counts()
    n_adam = len(solver.losses)
    t = _timed_fit(solver, newton_iter=WIDE_LBFGS)
    lb = _nonzero(_counts_all())
    evals = _lbfgs_counts()[0] - e0
    iters = len(solver.losses) - n_adam
    hist = np.array([row["Total Loss"] for row in solver.losses[n_adam:]])
    print(f"[{tag} lbfgs] {iters} iterations {1e3 * t / max(iters, 1):.3f} "
          f"ms/iteration, {evals} evaluations; loss {loss[-1]:.6e} (last "
          f"Adam step) -> {hist[-1]:.6e}, best "
          f"{solver.min_loss['l-bfgs']:.6e}; launches {lb}", flush=True)
    if not (evals > 0 and lb == {k3: evals}):
        fail(f"{tag} lbfgs: launches {lb} for {evals} evaluations")
    if not (np.all(np.isfinite(hist))
            and solver.min_loss["l-bfgs"] < loss[-1]):
        fail(f"{tag} lbfgs: the best loss is not below the Adam leg's last")
    out[f"{tag}-lbfgs"] = dict(launches=_counts_all(),
                               ms_iter=1e3 * t / max(iters, 1))
    del solver
    # the unfused steps: K1 (its wide route) and K2 (the NP = 256 design)
    r = _graph_vs_eager(f"{tag} unfused", make(False), WIDE_UNFUSED, 25,
                        _counts_all)
    s2 = r["graph"]
    loss = np.array([row["Total Loss"] for row in s2.losses])
    ms_step = 1e3 * r["seconds"] / WIDE_UNFUSED
    launches = _nonzero(r["launches"])
    plan = ct.build_cuda_table_fn(
        s2._fuse_requests, [tuple(W.shape) for W, _ in s2.net.layers()],
        device=s2.X_f.device).plan
    k2_route = "mma" if plan.wb_route(s2.X_f.device, flavor, s2.X_f.shape[0],
                                      "k2") is None else "wgmma"
    ref = minimax_loss[:WIDE_UNFUSED]
    apart = float(np.max(np.abs(loss - ref) / np.abs(ref)))
    print(f"[{tag} unfused] engine {s2.engine}, "
          f"{k2.upper().replace('_', '-')} on the "
          f"{k2_route} route; {WIDE_UNFUSED} steps {ms_step:.3f} ms/step "
          f"(the fit's wall); loss {loss[0]:.6e} -> {loss[-1]:.6e} (the "
          f"minimax leg {ref[-1]:.6e} at that step; the histories "
          f"{apart:.3e} apart, tol {SERVE_CROSSCHECK_RTOL:g}); launches "
          f"{launches}", flush=True)
    if s2.engine != "fused-cuda" or k2_route != k2_routes["wide"]:
        fail(f"the {tag} unfused path ran {s2.engine}, K2 on {k2_route}")
    if not (np.all(np.isfinite(loss)) and apart <= SERVE_CROSSCHECK_RTOL):
        fail(f"{tag} unfused: the loss history left the minimax leg's (or "
             "is not finite)")
    if launches != {k1: WIDE_UNFUSED, k2: WIDE_UNFUSED}:
        fail(f"{tag} unfused: launches {launches}, not {k1}/{k2} x "
             f"{WIDE_UNFUSED}")
    if not tf32:
        _held_k1_k2(f"{tag} unfused held", s2)
    out[f"{tag}-unfused"] = dict(launches=r["launches"], ms_step=ms_step)
    return out


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
    if "minimax_step" in low or "minimax_wg" in low:
        return "K3 minimax_step_kernel / minimax_wg_kernel"
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
def _fit_counted(solver, counts=_counts, **kw) -> tuple:
    """``fit`` with the launch counts set to 0 just before and read just
    after (by ``counts``: the f32 flavor's, or ``_counts_all``); returns
    (seconds, launches, Adam-step captures in the fit)."""
    from tensordiffeq_tpu_torch.ops import cuda_taylor as ct
    from tensordiffeq_tpu_torch.training import graphs

    c0 = len(graphs.captures)
    ct.reset_launch_counts()
    t = _timed_fit(solver, **kw)
    launches = counts()
    caps = [c for c in graphs.captures[c0:] if c["name"] == "Adam step"]
    return t, launches, len(caps)


def _steady_ms(solver, chunk: int) -> float:
    """ms per Adam step of the last ``fit``'s chunks after its first (the
    first holds the warm-ups and the capture): replays and the chunks'
    history reads."""
    secs = solver._adam_result.chunk_seconds[1:]
    return 1e3 * float(np.mean(secs)) / chunk if secs else float("nan")


def _graph_vs_eager(tag: str, make, steps: int, chunk: int,
                    counts=_counts) -> dict:
    """Two solvers from one seed, ``steps`` Adam steps each, graphed and
    eager: held bit for bit (``_state_diff``); the graphed fit's launches
    read by ``counts``."""
    graph, eager = make(), make()
    t_g, launches, caps = _fit_counted(graph, counts, tf_iter=steps,
                                       chunk=chunk)
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
    return dict(graph=graph, eager=eager, launches=launches, seconds=t_g)


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
            "k2_tf32": ct.k2_backward_tf32, "k3_tf32": cm.k3_minimax_tf32,
            "k3f": cm.k3_minimax_family,
            "k3f_bf16": cm.k3_minimax_family_bf16,
            "k3f_tf32": cm.k3_minimax_family_tf32}


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
    flavors at phases 3-5's shapes and on ``WIDE_WIDTHS`` (their routes for
    wider layers), K2-bf16 and K3-bf16 on the routes K2_BF16_ROUTES and
    K3_BF16_ROUTES name, timed beside their f32 flavors.  The AC case's
    measurements carry the wide case's under ``wide`` (K1-bf16) or
    ``old_route`` (K2-bf16, K3-bf16)."""
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
        wg = K1_BEFORE_WGMMA_MS.get(label, BF16_BEFORE_WGMMA_MS.get(label))
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
        # the wide case draws from a stream of its own, so the other
        # cases' inputs stay as they were
        g = torch.as_tensor(
            (np.random.RandomState(3) if label == "wide" else rng).randn(
                plan.C, N_POINTS, 1), dtype=torch.float32, device=dev)
        Xg = X.clone().requires_grad_(True)

        def plain(dtype):
            t = taylor_derivatives(pairs, Xg, set(channels), flat_matmul=True,
                                   compute_dtype=dtype)
            table = torch.stack([t[mi] for mi in channels])
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
        dX, dflat = ct.k2_backward_bf16(plan, X, flat, g)
        torch.cuda.synchronize()
        mine = plan.unpack(dflat) + [dX]
        k2 = _flavor_check(f"K2-bf16 {label}", mine, list(g16), list(g32),
                           [BF16_GRAD_BAND] * len(mine))
        k2["route"] = _wb_route(plan, "k2", label, bf16)
        k2["bit_identical"] = _bit_identical_run_to_run(
            f"K2-bf16 {label}", torch.cat([dX.reshape(-1), dflat]),
            lambda: torch.cat([t.reshape(-1) for t in
                               ct.k2_backward_bf16(plan, X, flat, g)]))
        k2.update(timed(f"K2-bf16 {label}",
                        lambda: ct.k2_backward_bf16(plan, X, flat, g),
                        cuda_ms(lambda: ct.k2_backward(plan, X, flat, g)),
                        cuda_ms(lambda: plain(bf16), reps=5),
                        flops["k2"], nbytes["k2"], passes["k2"],
                        k2["route"]))
        out[label] = dict(k1=k1, k2=k2)

    k3 = {}
    for label, f_model, widths in (("ac", _ac_residual, WIDTHS),
                                   ("system", _coupled_residual,
                                    WIDTHS[:-1] + [2]),
                                   ("singular", _singular_residual, WIDTHS),
                                   ("wide", _ac_residual, WIDE_WIDTHS)):
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
        Xk = X
        if label in ("singular", "wide"):
            # phase 5's 1/x residual at a ragged N, away from x = 0; its
            # inputs and the wide case's from streams of their own
            sub = np.random.RandomState(5 if label == "wide" else 4)
            lo, hi, n = ((0.5, 1.5, N_POINTS + 1) if label == "singular"
                         else (-1.0, 1.0, N_POINTS))
            Xk = torch.as_tensor(np.stack([sub.uniform(lo, hi, n),
                                           sub.uniform(0, 1, n)], 1),
                                 dtype=torch.float32, device=dev)
            w = torch.as_tensor(sub.rand(n, plan.E) ** 2,
                                dtype=torch.float32, device=dev)
        else:
            w = torch.as_tensor(rng.rand(N_POINTS, plan.E) ** 2,
                                dtype=torch.float32, device=dev)
        fl = [a.detach() if a.ndim == 2 else a.detach().reshape(1, -1)
              for pair in layers for a in pair]
        flat = plan.pack(fl)

        def leaves(res):
            v, d, gw, gX = res
            return [v.reshape(1)] + [t.reshape(-1) for t in d] + [gw, gX]

        first = cm.k3_minimax_bf16(plan, Xk, w, flat)
        torch.cuda.synchronize()
        got = leaves((first[0], plan.unpack(first[1]), first[2], first[3]))
        bands = [BF16_VALUE_BAND] + [BF16_GRAD_BAND] * (len(got) - 3) \
            + [BF16_VALUE_BAND, BF16_GRAD_BAND]
        res = _flavor_check(f"K3-bf16 {label}", got,
                            leaves(sq.plain(fl, w, Xk)),
                            leaves(sq32.plain(fl, w, Xk)), bands)
        res["route"] = _wb_route(plan, "k3", label, bf16)
        res["bit_identical"] = _bit_identical_run_to_run(
            f"K3-bf16 {label}", torch.cat([t.reshape(-1) for t in first]),
            lambda: torch.cat([t.reshape(-1) for t in
                               cm.k3_minimax_bf16(plan, Xk, w, flat)]))
        res.update(timed(f"K3-bf16 {label}",
                         lambda: cm.k3_minimax_bf16(plan, Xk, w, flat),
                         cuda_ms(lambda: cm.k3_minimax(plan, Xk, w, flat)),
                         cuda_ms(lambda: sq.plain(fl, w, Xk), reps=5),
                         cm.flop_count(plan, Xk.shape[0])["k3"],
                         cm.byte_count(plan, Xk.shape[0])["k3"],
                         cm.tensor_passes(plan, bf16), res["route"]))
        k3[label] = res
    # comparison launches are not the main path's: restore the counts
    for fn, key in ((ct.k1_forward, "k1"), (ct.k2_backward, "k2"),
                    (cm.k3_minimax, "k3"), (ct.k1_forward_bf16, "k1_bf16"),
                    (ct.k2_backward_bf16, "k2_bf16"),
                    (cm.k3_minimax_bf16, "k3_bf16")):
        fn.launches = before[key]
    out["ac"]["k1"]["wide"] = out["wide"]["k1"]
    # K2-bf16's and K3-bf16's mma.sync route at WIDE_WIDTHS (no main path
    # takes it), as the kernels line reports the f32 and TF32 flavors'
    out["ac"]["k2"]["old_route"] = out["wide"]["k2"]
    k3["ac"]["old_route"] = k3["wide"]
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
        route=plan3.k3_routes[None],
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
    again = ct.k2_backward(plan, X, flat, g)
    torch.cuda.synchronize()
    if not (torch.equal(again[0], dX) and torch.equal(again[1], dflat2)):
        fail(f"zoo {entry.id}: K2 is not bit-identical run to run")
    flops, nbytes = ct.flop_count(plan, n), ct.byte_count(plan, n)
    with torch.no_grad():
        k1_plain = cuda_ms(plain_table, reps=5)
    out["k1"] = dict(max_abs_err=k1_abs, scale_rel_err=k1_rel, C=plan.C,
                     route=route,
                     ms=cuda_ms(lambda: ct.k1_forward(plan, X, flat)),
                     plain_ms=k1_plain,
                     bound=bound_ms(flops["k1"], nbytes["k1"]))
    out["k2"] = dict(max_abs_err=k2_abs, scale_rel_err=k2_rel, C=plan.C,
                     route=plan.k2_routes[None],
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
                 + f" route {m['route']}")
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
    # K3's kernel on either route (minimax_step_kernel, minimax_wg_kernel)
    k3_records = [ev for ev in events if ev.get("cat") == "kernel"
                  and _kernel_group(str(ev.get("name"))).startswith("K3")]
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
                ieee: list, gate: bool = True) -> dict:
    """A TF32 kernel's leaves against the TF32-emulating plain flavor and
    its float64-summed twin (two referees of the same semantics): each
    leaf's RMS scale-relative distance to the nearer referee within
    TF32_SPREAD times the order spread (the two referees' distance, the
    largest over the leaves; at least TF32_FLOOR), its max distance within
    the larger of that band in the max metric and TF32_FLIP of the
    emulation's own max distance to the IEEE flavor (where one flipped
    operand decides the max), and the whole nearer (RMS) the emulation
    than the IEEE flavor.  Prints the distances to the emulation, to the
    twin and to the IEEE flavor, and the spread.  ``gate=False``: reports
    whether the leaves are within the band (``worst["in_band"]``) and
    does not fail."""
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
    worst["in_band"] = bool(worst["near_max"] <= band_max
                            and worst["near_rms"] <= band_rms
                            and r_emu < r_ieee)
    if gate and not (worst["near_max"] <= band_max
                     and worst["near_rms"] <= band_rms):
        fail(f"{label} is outside the TF32 flavor's band")
    if gate and not r_emu < r_ieee:
        fail(f"{label} is not nearer the TF32 emulation than the IEEE "
             "flavor")
    return worst


def _wb_route(plan, kernel: str, label: str, flavor=None) -> str:
    """The route K2's or K3's last launch in a flavor took (``kernel`` "k2"
    or "k3"; ``flavor`` None, the f32 one, ``ct.TF32`` or
    ``torch.bfloat16``); it must be the one ``K2_ROUTES``/``K3_ROUTES``
    (``K2_TF32_ROUTES``/``K3_TF32_ROUTES``, ``K2_BF16_ROUTES``/
    ``K3_BF16_ROUTES``) names for the case."""
    import torch
    from tensordiffeq_tpu_torch.ops import cuda_taylor as ct
    got = (plan.k2_routes if kernel == "k2" else plan.k3_routes)[flavor]
    routes, tag = {None: ((K2_ROUTES, K3_ROUTES), ""),
                   ct.TF32: ((K2_TF32_ROUTES, K3_TF32_ROUTES), "-TF32"),
                   torch.bfloat16: ((K2_BF16_ROUTES, K3_BF16_ROUTES),
                                    "-bf16")}[flavor]
    want = routes[kernel == "k3"][label]
    name = kernel.upper() + tag
    source = (WIDE_ROUTE_SOURCES[kernel] if label == "wide" and got == "wgmma"
              else ROUTE_SOURCES[(kernel, got)])
    print(f"[route {name} {label}] {got} ({source})", flush=True)
    if got != want:
        fail(f"{name} ({label}) took the {got} route, not the {want} one")
    return got


def _f32_check(label: str, got: list, want: list, tol: float) -> dict:
    """Every leaf of an f32 kernel's output finite and within ``tol``
    scale-relative of the IEEE plain flavor's (``want``)."""
    import torch
    if not all(bool(torch.isfinite(t).all()) for t in got):
        fail(f"{label}: non-finite output")
    errs = [scaled_err(a, b) for a, b in zip(got, want)]
    err_abs, err_rel = max(e[0] for e in errs), max(e[1] for e in errs)
    print(f"[{label}] max_abs_err={err_abs:.3e} scale_rel_err={err_rel:.3e} "
          f"(tol {tol:g} on it)", flush=True)
    if not err_rel <= tol:
        fail(f"{label} disagrees with its plain flavor")
    return dict(max_abs_err=err_abs, scale_rel_err=err_rel)


def phase_tf32_kernels(dev) -> dict:
    """Phase 16(a): K1-TF32, K2-TF32 and K3-TF32 against the
    TF32-emulating plain flavor at the Allen-Cahn slice (N = 50,000,
    2-128x4-1, C = 4, E = 1), at ``burgers``' 2-20x8-1 (K2 and K3 on their
    wgmma route at both) and at WIDE_WIDTHS (their NP = 256 design, and the
    mma.sync kernels it replaced there, held to the same band and timed in
    turns with it), each kernel bit for bit run to run, each timed over 20
    launches beside the 3xTF32 flavor and its one-pass bound.  The 3xTF32
    (f32) K2 and K3 at the same three shapes against the IEEE plain flavor
    (K2_RTOL, K3_RTOL), on the route K2_ROUTES/K3_ROUTES name, bit for bit
    run to run.  Returns the Allen-Cahn measurements, with the wide case's
    K2-TF32/K3-TF32 as ``wide`` and their mma.sync kernels as
    ``old_route``."""
    import torch
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
                                    BURGERS_WIDTHS),
                                   ("wide", _ac_residual, WIDE_WIDTHS)):
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
        k2["route"] = _wb_route(plan, "k2", label, ct.TF32)
        k2["bit_identical"] = _bit_identical_run_to_run(
            f"K2-TF32 {label}", torch.cat([dflat, dX.reshape(-1)]),
            lambda: torch.cat([t.reshape(-1) for t in
                               ct.k2_backward_tf32(plan, X, flat, g)[::-1]]))
        # the f32 (3xTF32) K2 on its route for the case
        dX32, dflat32 = ct.k2_backward(plan, X, flat, g)
        torch.cuda.synchronize()
        k2f = _f32_check(f"K2 {label}", plan.unpack(dflat32) + [dX32],
                         list(gi), K2_RTOL)
        k2f["route"] = _wb_route(plan, "k2", label)
        k2f["bit_identical"] = _bit_identical_run_to_run(
            f"K2 {label}", torch.cat([dflat32, dX32.reshape(-1)]),
            lambda: torch.cat([t.reshape(-1) for t in
                               ct.k2_backward(plan, X, flat, g)[::-1]]))
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
            was = TF32_BEFORE_WGMMA_MS.get(f"{name}-TF32 {label}")
            print(f"[time {name}-TF32 {label}] {res['ms']:.3f} ms on the "
                  f"{res['route']} route"
                  f"{'' if was is None else f' (mma.sync route: {was:.3f} ms)'}"
                  f" beside the 3xTF32 flavor's {res['f32_ms']:.3f} ms (plain "
                  f"TF32 emulation {res['plain_ms']:.3f} ms); "
                  f"{bound_text(res['ms'], res['bound'])}", flush=True)
        k2f.update(ms=k2["f32_ms"], plain_ms=cuda_ms(lambda: plain(False),
                                                     reps=5),
                   bound=bound_ms(flops["k2"], nbytes["k2"]))

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
        k3_refs = (leaves(sq.plain(fl, w, X, emulate_tf32=True)),
                   leaves(sq.plain(fl, w, X, emulate_tf32="float64")),
                   leaves(sq32.plain(fl, w, X)))
        k3 = _tf32_check(
            f"K3-TF32 {label}",
            leaves((got[0], sq.plan.unpack(got[1]), got[2], got[3])),
            *k3_refs)
        k3["route"] = _wb_route(sq.plan, "k3", label, ct.TF32)
        k3["bit_identical"] = _bit_identical_run_to_run(
            f"K3-TF32 {label}", torch.cat([t.reshape(-1) for t in got]),
            lambda: torch.cat([t.reshape(-1) for t in
                               cm.k3_minimax_tf32(sq.plan, X, w, kflat)]))
        # the f32 (3xTF32) K3 on its route for the case
        got32 = cm.k3_minimax(sq.plan, X, w, kflat)
        torch.cuda.synchronize()
        k3f = _f32_check(
            f"K3 {label}",
            leaves((got32[0], sq.plan.unpack(got32[1]), got32[2], got32[3])),
            leaves(sq32.plain(fl, w, X)), K3_RTOL)
        k3f["route"] = _wb_route(sq.plan, "k3", label)
        k3f["bit_identical"] = _bit_identical_run_to_run(
            f"K3 {label}", torch.cat([t.reshape(-1) for t in got32]),
            lambda: torch.cat([t.reshape(-1) for t in
                               cm.k3_minimax(sq.plan, X, w, kflat)]))
        k3["ms"] = cuda_ms(lambda: cm.k3_minimax_tf32(sq.plan, X, w, kflat))
        k3["f32_ms"] = cuda_ms(lambda: cm.k3_minimax(sq.plan, X, w, kflat))
        k3["plain_ms"] = cuda_ms(
            lambda: sq.plain(fl, w, X, emulate_tf32=True), reps=5)
        k3["bound"] = bound_ms(cm.flop_count(sq.plan, N_POINTS)["k3"],
                               cm.byte_count(sq.plan, N_POINTS)["k3"],
                               cm.tensor_passes(sq.plan, ct.TF32))
        k3f.update(ms=k3["f32_ms"],
                   plain_ms=cuda_ms(lambda: sq32.plain(fl, w, X), reps=5),
                   bound=bound_ms(cm.flop_count(sq.plan, N_POINTS)["k3"],
                                  cm.byte_count(sq.plan, N_POINTS)["k3"]))
        for name, m in (("K2", k2f), ("K3", k3f)):
            was = F32_BEFORE_WGMMA_MS.get(f"{name} {label}")
            print(f"[time {name} {label}] {m['ms']:.3f} ms on the "
                  f"{m['route']} route"
                  f"{'' if was is None else f' (mma.sync route: {was:.3f} ms)'}"
                  f" (plain {m['plain_ms']:.3f} ms); "
                  f"{bound_text(m['ms'], m['bound'])}", flush=True)
        was = TF32_BEFORE_WGMMA_MS.get(f"K3-TF32 {label}")
        print(f"[time K3-TF32 {label}] {k3['ms']:.3f} ms on the "
              f"{k3['route']} route"
              f"{'' if was is None else f' (mma.sync route: {was:.3f} ms)'}"
              f" beside the 3xTF32 flavor's {k3['f32_ms']:.3f} ms (plain TF32 "
              f"emulation {k3['plain_ms']:.3f} ms); "
              f"{bound_text(k3['ms'], k3['bound'])}", flush=True)
        if label == "wide":
            # the mma.sync kernels the NP = 256 design replaced there, on
            # the same inputs
            k2["old_route"] = _tf32_old_route(
                "K2-TF32", k2, lambda: ct.k2_mma(plan, X, flat, g, 2),
                lambda: ct.k2_backward_tf32(plan, X, flat, g),
                lambda o: plan.unpack(o[1]) + [o[0]], (ge, gt, gi))
            k3["old_route"] = _tf32_old_route(
                "K3-TF32", k3, lambda: cm.k3_mma(sq.plan, X, w, kflat, 2),
                lambda: cm.k3_minimax_tf32(sq.plan, X, w, kflat),
                lambda o: leaves((o[0], sq.plan.unpack(o[1]), o[2], o[3])),
                k3_refs)
        out[label] = dict(k1_tf32=k1, k2_tf32=k2, k3_tf32=k3, k2=k2f, k3=k3f)
    _set_counts(before)  # comparison launches are not the main path's
    res = {k: out["ac"][k] for k in ("k1_tf32", "k2_tf32", "k3_tf32")}
    for key in ("k2_tf32", "k3_tf32"):
        res[key]["wide"] = out["wide"][key]
        res[key]["old_route"] = out["wide"][key].pop("old_route")
    return res


def _tf32_old_route(name: str, new: dict, old_fn, new_fn, leaves,
                    refs: tuple) -> dict:
    """A TF32 kernel's mma.sync kernel at WIDE_WIDTHS on the inputs its NP
    = 256 design was held on (phase 16(a)): held to the same referees
    (``refs``: the emulation's, its twin's and the IEEE flavor's leaves;
    ``leaves`` turns a launch's outputs into the kernel's) in phase 16's
    band, and timed in turns with the new route (the mma.sync kernel, the
    new route, twice; ``new["ms"]`` becomes the best of the new route's
    turns).  Returns the mma.sync kernel's measurement."""
    import torch
    got = leaves(old_fn())
    torch.cuda.synchronize()
    chk = _tf32_check(f"{name} wide mma.sync", got, *refs)
    old_ms, new_ms = [], [new["ms"]]
    for _ in range(2):
        old_ms.append(cuda_ms(old_fn))
        new_ms.append(cuda_ms(new_fn))
    new["ms"] = min(new_ms)
    print(f"[time {name} wide] in turns: the NP = 256 design "
          f"{', '.join(f'{v:.3f}' for v in new_ms)} ms, the mma.sync kernel "
          f"{', '.join(f'{v:.3f}' for v in old_ms)} ms (its scale_rel_err "
          f"{chk['scale_rel_err']:.3e}); {bound_text(min(old_ms), new['bound'])}",
          flush=True)
    return dict(route="mma", max_abs_err=chk["max_abs_err"],
                scale_rel_err=chk["scale_rel_err"], ms=min(old_ms),
                plain_ms=new["plain_ms"], bound=new["bound"])


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


# phase 17, data parallelism: (a) the reference's multi-GPU configuration
# (examples/ac_dist.py, AC-dist-new.py: AC-SA at N_f = 500,000 on the
# slice's net) at world 1 over NCCL; (b) two processes on the one card over
# gloo (NCCL refuses two ranks on one device) at the slice's N_f; (c) the
# sharded serving engine at world 1
DIST_NF = 500_000
DIST_STEPS, DIST_NEWTON, DIST_BIT = 200, 20, 50
DIST_UNFUSED_STEPS, DIST_BF16_STEPS = 50, 20
DIST_W2_STEPS, DIST_W2_RESUME = 20, 10
# one evaluation at world 2 against world 1: the same products, the sums
# split at another row (scale-relative; the value, the parameters' and the
# per-point λ gradients); the 20 Adam steps' loss against world 1: measured
# at 1.2e-07 on an H100 (PERF.md), the band about a hundred times that
DIST_EVAL_TOL, DIST_TRAJ_RTOL = 1e-5, 1e-5
DIST_TIMEOUT_S = 300
# phase 17(d): the options whose statistic spans the ranks, at the slice's
# N_f: causal weighting (the unfused path: the minimax step declines it)
# and NTK weighting (K3); steps at world 1 over NCCL and at world 2
DIST_OPTIONS = {"causal": dict(causal_eps=1e-2),
                "ntk": dict(Adaptive_type=3, dict_adaptive=None,
                            init_weights=None)}
DIST_OPT_STEPS, DIST_OPT_W2_STEPS = 50, 20


def _params_digest(solver) -> str:
    import hashlib
    h = hashlib.sha256()
    for t in solver.net.params():
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


_DIST_PROBLEMS: dict = {}


def _dist_solver(n_f: int, dist, seed: int = 0, **extra):
    """AC-SA at ``n_f`` points on the slice's net through ``fused="cuda"``,
    data-parallel under ``dist``; the problem (its 500,000-point LHS takes
    seconds on the host) is drawn once per size."""
    import tensordiffeq_tpu_torch as tdqt
    if (n_f, seed) not in _DIST_PROBLEMS:
        _DIST_PROBLEMS[(n_f, seed)] = ac_sa_problem(n_f=n_f, seed=seed)
    domain, bcs, f_model, kw = _DIST_PROBLEMS[(n_f, seed)]
    s = tdqt.CollocationSolverND(verbose=False, seed=seed)
    s.compile(WIDTHS, f_model, domain, bcs, fused="cuda", dist=dist,
              **dict(kw, **extra))
    return s


def _steady_fit_ms(solver, steps: int) -> float:
    """Ms per Adam step of a fit whose step is already captured."""
    return 1e3 * _timed_fit(solver, tf_iter=steps, chunk=steps) / steps


def _allreduce_share(solver, n_steps: int = 20) -> tuple:
    """One profiler window of ``n_steps`` replayed Adam steps: the device
    ms per step and the share of it in NCCL kernels (the all-reduce)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts):  # the profiler's start-up, kept out
        solver.fit(tf_iter=2, chunk=2)
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        solver.fit(tf_iter=n_steps, chunk=n_steps)
        torch.cuda.synchronize()
    busy = nccl = 0.0
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA or getattr(
                evt, "is_user_annotation", False):
            continue
        us = evt.time_range.elapsed_us()
        busy += us
        if "nccl" in evt.name.lower():
            nccl += us
    if busy <= 0:
        fail("the profiler saw no device time in the dist step")
    return busy / 1e3 / n_steps, nccl / busy


def _solver_layers(solver) -> list:
    """The solver's layers as the kernels take them (2-D, detached)."""
    return [a.detach() if a.ndim == 2 else a.detach().reshape(1, -1)
            for pair in solver.net.layers() for a in pair]


def _held_k3(label: str, solver) -> dict:
    """The solver's K3 flavor (f32 or bf16) launched once at the shapes its
    main path gives it (its collocation rows, its parameters, w = λ² of its
    per-point λ) against the plain flavor on the same card tensors: the
    value, every dW/db, gw and its per-point λ gradient 2λ·gw, and gX,
    scale-relative, at K3_RTOL (the bf16 flavor: within the bf16 bands and
    nearer the plain bf16 flavor than the f32 one, on the route
    K3_BF16_ROUTES names for "dist").  The launch is not the main path's:
    the counts are put back."""
    import torch
    from tensordiffeq_tpu_torch.ops import cuda_minimax as cm
    from tensordiffeq_tpu_torch.ops.minimax import build_minimax_sq_fn
    sq, X = solver._minimax_sq, solver.X_f
    lam = solver.lambdas["residual"][0].detach()
    fl = _solver_layers(solver)
    if solver.fused_dtype is None:
        return _k3_against_plain(label, sq, X, lam, fl)
    saved = _counts_all()
    plan = sq.plan
    w = (lam * lam).reshape(-1, 1)
    v, dflat, gw, gX = cm.k3_minimax_bf16(plan, X, w, plan.pack(fl))
    torch.cuda.synchronize()
    _wb_route(plan, "k3", "dist", torch.bfloat16)
    got = _k3_leaves(lam, v, plan.unpack(dflat), gw, gX)
    sq32 = build_minimax_sq_fn(
        solver.f_model, solver.domain.vars, solver.n_out,
        solver._fuse_requests, plan.layer_shapes, device=X.device)
    bands = [BF16_VALUE_BAND] + [BF16_GRAD_BAND] * (len(got) - 4) \
        + [BF16_VALUE_BAND, BF16_VALUE_BAND, BF16_GRAD_BAND]
    res = _flavor_check(f"{label} K3-bf16 at N={X.shape[0]:,}", got,
                        _k3_leaves(lam, *sq.plain(fl, w, X)),
                        _k3_leaves(lam, *sq32.plain(fl, w, X)), bands)
    _set_counts(saved)
    return res


def _held_k3_tf32(label: str, solver) -> dict:
    """The solver's K3-TF32 launched once at the shapes its main path gives
    it (its collocation rows, its parameters, w = λ² of its per-point λ)
    against the TF32-emulating plain flavor, its float64-summed twin and
    the IEEE plain flavor on the same card tensors (``_tf32_check``: phase
    16's band) over the value, every dW/db, gw, the λ gradient 2λ·gw and
    gX, and bit for bit run to run.  The launches are not the main path's:
    the counts are put back."""
    import torch
    from tensordiffeq_tpu_torch.ops import cuda_minimax as cm
    from tensordiffeq_tpu_torch.ops import cuda_taylor as ct
    from tensordiffeq_tpu_torch.ops.minimax import build_minimax_sq_fn
    saved = _counts_all()
    sq, X = solver._minimax_sq, solver.X_f
    plan = sq.plan
    lam = solver.lambdas["residual"][0].detach()
    fl = _solver_layers(solver)
    w = (lam * lam).reshape(-1, 1)
    flat = plan.pack(fl)
    got = cm.k3_minimax_tf32(plan, X, w, flat)
    again = cm.k3_minimax_tf32(plan, X, w, flat)
    torch.cuda.synchronize()
    _set_counts(saved)
    bits = all(torch.equal(a, b) for a, b in zip(got, again))
    sq32 = build_minimax_sq_fn(
        solver.f_model, solver.domain.vars, solver.n_out,
        solver._fuse_requests, plan.layer_shapes, device=X.device)
    res = _tf32_check(
        f"{label} K3-TF32 at N={X.shape[0]:,}",
        _k3_leaves(lam, got[0], plan.unpack(got[1]), got[2], got[3]),
        _k3_leaves(lam, *sq.plain(fl, w, X, emulate_tf32=True)),
        _k3_leaves(lam, *sq.plain(fl, w, X, emulate_tf32="float64")),
        _k3_leaves(lam, *sq32.plain(fl, w, X)))
    print(f"[{label}] K3-TF32 route {plan.k3_routes.get(ct.TF32)}; run to "
          f"run: {'bit-identical' if bits else 'DIFFERENT'}", flush=True)
    if not bits:
        fail(f"{label}: K3-TF32 is not bit-identical run to run")
    return res


def _k3_leaves(lam, v, dW, gw, gX) -> list:
    """K3's outputs as the held checks compare them: the value, every
    dW/db, gw, the per-point λ gradient 2λ·gw and gX."""
    return ([v.reshape(1)] + [t.reshape(-1) for t in dW]
            + [gw, 2.0 * lam * gw, gX])


def _k3_against_plain(label: str, sq, X, lam, fl) -> dict:
    """The f32 K3 of ``sq`` (a ``build_minimax_sq_fn`` function) launched
    once on card tensors (the rows ``X``, w = λ² of the per-point ``lam``,
    the 2-D layers ``fl``) against its plain flavor on the same tensors,
    every leaf of :func:`_k3_leaves` scale-relative at K3_RTOL.  The launch
    is not the main path's: the counts are put back."""
    import torch
    from tensordiffeq_tpu_torch.ops import cuda_minimax as cm
    saved = _counts_all()
    plan = sq.plan
    w = (lam * lam).reshape(-1, 1)
    v, dflat, gw, gX = cm.k3_minimax(plan, X, w, plan.pack(fl))
    torch.cuda.synchronize()
    got = _k3_leaves(lam, v, plan.unpack(dflat), gw, gX)
    want = _k3_leaves(lam, *sq.plain(fl, w, X))
    if not all(bool(torch.isfinite(t).all()) for t in got):
        fail(f"{label}: K3 gave a non-finite output")
    again = cm.k3_minimax(plan, X, w, plan.pack(fl))
    torch.cuda.synchronize()
    bits = all(torch.equal(a, b) for a, b in zip(again, (v, dflat, gw, gX)))
    errs = [scaled_err(a, b) for a, b in zip(got, want)]
    worst = max(errs, key=lambda e: e[1])
    print(f"[{label}] K3 at N={X.shape[0]:,} against its plain flavor: "
          f"value {float(v):.6e} (plain {float(want[0]):.6e}), "
          f"scale_rel_err value {errs[0][1]:.3e}, dW/db "
          f"{max(e[1] for e in errs[1:-3]):.3e}, gw {errs[-3][1]:.3e}, "
          f"λ gradient {errs[-2][1]:.3e}, gX {errs[-1][1]:.3e}; max_abs_err "
          f"{max(e[0] for e in errs):.3e} (tol {K3_RTOL:g}); route "
          f"{plan.k3_routes[None]}; run to run: "
          f"{'bit-identical' if bits else 'DIFFERENT'}", flush=True)
    _set_counts(saved)
    if not worst[1] <= K3_RTOL:
        fail(f"{label}: K3 disagrees with its plain flavor at "
             f"N={X.shape[0]:,}")
    if not bits:
        fail(f"{label}: K3 is not bit-identical run to run at "
             f"N={X.shape[0]:,}")
    return dict(max_abs_err=max(e[0] for e in errs), scale_rel_err=worst[1])


def _held_k1_k2(label: str, solver, seed: int = 0) -> dict:
    """K1 and K2 launched once at the unfused solver's shapes (its
    collocation rows and parameters, a cotangent per table channel drawn
    from ``seed``) against the plain flavor on the same card tensors,
    scale-relative, at K1_RTOL and K2_RTOL.  The launches are not the main
    path's: the counts are put back."""
    import torch
    from tensordiffeq_tpu_torch.ops import cuda_taylor as ct
    from tensordiffeq_tpu_torch.ops.taylor import taylor_derivatives
    saved = _counts_all()
    X = solver.X_f
    flat_layers = [t.detach() for pair in solver.net.layers() for t in pair]
    params = [t.clone().requires_grad_(True) for t in flat_layers]
    pairs = list(zip(params[0::2], params[1::2]))
    plan = ct.build_cuda_table_fn(
        solver._fuse_requests, [tuple(W.shape) for W, _ in pairs],
        device=X.device).plan
    flat = plan.pack(flat_layers)
    channels = plan.channels
    table = ct.k1_forward(plan, X, flat)
    torch.cuda.synchronize()
    with torch.no_grad():
        t = taylor_derivatives(pairs, X, set(channels), flat_matmul=True)
        k1 = [scaled_err(table[c], t[mi]) for c, mi in enumerate(channels)]
    del t, table
    g = torch.as_tensor(np.random.RandomState(seed).randn(
        plan.C, X.shape[0], 1), dtype=torch.float32, device=X.device)
    dX, dflat = ct.k2_backward(plan, X, flat, g)
    torch.cuda.synchronize()
    Xg = X.clone().requires_grad_(True)
    t = taylor_derivatives(pairs, Xg, set(channels), flat_matmul=True)
    ref = torch.autograd.grad(
        sum((t[mi] * g[c]).sum() for c, mi in enumerate(channels)),
        params + [Xg])
    k2 = [scaled_err(a, b) for a, b in zip(plan.unpack(dflat) + [dX], ref)]
    _set_counts(saved)
    k1_rel, k2_rel = max(e[1] for e in k1), max(e[1] for e in k2)
    print(f"[{label}] at N={X.shape[0]:,} against the plain flavor: K1 "
          f"max_abs_err={max(e[0] for e in k1):.3e} scale_rel_err="
          f"{k1_rel:.3e} (tol {K1_RTOL:g}), K2 max_abs_err="
          f"{max(e[0] for e in k2):.3e} scale_rel_err={k2_rel:.3e} (tol "
          f"{K2_RTOL:g})", flush=True)
    if not (k1_rel <= K1_RTOL and k2_rel <= K2_RTOL):
        fail(f"{label}: K1/K2 disagree with the plain flavor at "
             f"N={X.shape[0]:,}")
    return dict(k1=k1_rel, k2=k2_rel)


def _dist_world_1(card: str) -> dict:
    """Phase 17(a): world 1 over NCCL at N_f = 500,000."""
    import torch
    from tensordiffeq_tpu_torch.exact import allen_cahn_solution
    from tensordiffeq_tpu_torch.ops import cuda_taylor as ct
    from tensordiffeq_tpu_torch.training import graphs
    from tensordiffeq_tpu_torch.training.lbfgs import lbfgs_minimize
    import tensordiffeq_tpu_torch as tdqt

    saved = _counts_all()
    x, t, usol = allen_cahn_solution()
    X_star = np.stack(np.meshgrid(x, t, indexing="ij"), -1).reshape(-1, 2)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()

    ct.reset_launch_counts()
    t0 = time.perf_counter()
    s = _dist_solver(DIST_NF, True)
    torch.cuda.synchronize()
    t_compile = time.perf_counter() - t0
    if s.engine != "fused-minimax-cuda" or s.mesh.backend != "nccl" \
            or s.mesh.size != 1:
        fail(f"dist world 1: engine {s.engine}, mesh {s.mesh}")
    at_compile = _counts()
    c0 = len(graphs.captures)
    s.fit(tf_iter=DIST_STEPS, chunk=DIST_STEPS // 2)
    torch.cuda.synchronize()
    at_fit = _counts()
    caps = _captures_since("dist w1", c0)
    if s._adam.graph_eager or s._adam.graph.captures != 1:
        fail(f"dist world 1: the Adam step did not run as one captured "
             f"graph (eager {s._adam.graph_eager}, captures "
             f"{s._adam.graph.captures})")
    ms_w1 = 1e3 * s._adam_result.chunk_seconds[-1] / (DIST_STEPS // 2)
    ev0 = lbfgs_minimize.evaluations
    s.fit(newton_iter=DIST_NEWTON)
    torch.cuda.synchronize()
    evals = lbfgs_minimize.evaluations - ev0
    at_lbfgs = _counts()
    u_pred, f_pred = s.predict(X_star)
    launches = _counts()
    peak = torch.cuda.max_memory_allocated() - base
    in_fit = {k: at_fit[k] - at_compile[k] for k in launches}
    in_lbfgs = {k: at_lbfgs[k] - at_fit[k] for k in launches}
    rel_l2 = tdqt.find_L2_error(u_pred, usol.reshape(-1, 1))
    hist = np.array([r["Total Loss"] for r in s.losses])
    print(f"[dist w1] NCCL world 1, AC-SA N_f={DIST_NF:,}, {WIDTHS}: "
          f"compile {t_compile:.2f} s, {DIST_STEPS} Adam steps "
          f"({ms_w1:.3f} ms/step past the capture), {DIST_NEWTON} L-BFGS "
          f"iterations ({evals} evaluations), loss {hist[0]:.6e} -> "
          f"{hist[-1]:.6e}, rel-L2 vs ETDRK4 {rel_l2:.4f}; captures "
          f"{len(caps)}", flush=True)
    print(f"[dist w1] launches after compile {at_compile}, in fit {in_fit}, "
          f"in L-BFGS {in_lbfgs}, in all {launches}", flush=True)
    print(f"[dist w1] peak device memory {peak / 2 ** 30:.3f} GiB above the "
          f"{base / 2 ** 30:.3f} GiB held before the phase "
          f"(torch.cuda.max_memory_allocated; {card})", flush=True)
    if not (at_compile["k3"] == 1 and in_fit["k3"] == DIST_STEPS
            and in_lbfgs["k3"] == evals and evals >= DIST_NEWTON):
        fail(f"dist w1: K3 launches {launches} are not the cross-check + "
             f"one per step + one per L-BFGS evaluation ({evals})")
    if in_fit["k1"] or in_fit["k2"] or in_lbfgs["k1"] or in_lbfgs["k2"]:
        fail(f"dist w1: K1/K2 ran in fit: {in_fit} {in_lbfgs}")
    if not (np.all(np.isfinite(hist)) and hist[DIST_STEPS - 1] < hist[0]
            and np.all(np.isfinite(u_pred)) and np.all(np.isfinite(f_pred))
            and u_pred.shape == (X_star.shape[0], 1)):
        fail("dist w1: the loss did not fall, or predict is not finite")
    paths = {"dist-w1": dict(launches=launches)}
    _held_k3("dist w1", s)
    _set_counts(saved)

    # 50 steps bit for bit against the non-dist solver, and the graph
    # against the eager step; then ms/step of each, past the capture
    a = _dist_solver(DIST_NF, True)
    b = _dist_solver(DIST_NF, False)
    c = _dist_solver(DIST_NF, True)
    a.fit(tf_iter=DIST_BIT, chunk=DIST_BIT)
    b.fit(tf_iter=DIST_BIT, chunk=DIST_BIT)
    c.fit(tf_iter=DIST_BIT, chunk=DIST_BIT, _graphs=False)
    d_nondist, d_eager = _state_diff(a, b), _state_diff(a, c)
    del c
    ms_a = _steady_fit_ms(a, DIST_BIT)
    ms_b = _steady_fit_ms(b, DIST_BIT)
    ms_a2 = _steady_fit_ms(a, DIST_BIT)
    ms_b2 = _steady_fit_ms(b, DIST_BIT)
    dev_ms, share = _allreduce_share(a)
    print(f"[dist w1] {DIST_BIT} steps against the non-dist solver: "
          f"{'bit-identical' if d_nondist == 0 else d_nondist}; graph "
          f"against eager: {'bit-identical' if d_eager == 0 else d_eager}",
          flush=True)
    print(f"[dist w1] ms/step at N_f={DIST_NF:,}: dist {ms_a:.3f} / "
          f"{ms_a2:.3f}, non-dist {ms_b:.3f} / {ms_b2:.3f} (two turns each, "
          f"{DIST_BIT} replayed steps); NCCL kernels {100 * share:.2f}% "
          f"of {dev_ms:.3f} device ms/step (torch.profiler, 20 steps"
          + ("; none recorded: at one rank NCCL may sum without a kernel"
             if share == 0 else "") + f"); {card}", flush=True)
    if d_nondist != 0 or d_eager != 0:
        fail(f"dist w1: not bit for bit (non-dist {d_nondist}, eager "
             f"{d_eager})")
    del a, b
    _set_counts(saved)

    # the unfused dist path: K1 and K2 once each per step
    ct.reset_launch_counts()
    u = _dist_solver(DIST_NF, True, minimax=False)
    at_compile = _counts()
    u.fit(tf_iter=DIST_UNFUSED_STEPS, chunk=DIST_UNFUSED_STEPS)
    torch.cuda.synchronize()
    launches = _counts()
    in_fit = {k: launches[k] - at_compile[k] for k in launches}
    print(f"[dist w1 unfused] {DIST_UNFUSED_STEPS} steps: launches in fit "
          f"{in_fit}", flush=True)
    if not (in_fit["k1"] == in_fit["k2"] == DIST_UNFUSED_STEPS
            and not launches["k3"]):
        fail(f"dist w1 unfused: K1/K2 not once each per step: {in_fit}")
    paths["dist-w1-unfused"] = dict(launches=launches)
    _held_k1_k2("dist w1 unfused", u)
    del u
    _set_counts(saved)

    # fused_dtype="bfloat16": K3-bf16 per step
    ct.reset_launch_counts()
    h = _dist_solver(DIST_NF, True, fused_dtype="bfloat16")
    at_compile = _counts_all()
    h.fit(tf_iter=DIST_BF16_STEPS, chunk=DIST_BF16_STEPS)
    torch.cuda.synchronize()
    launches = _counts_all()
    in_fit = {k: launches[k] - at_compile[k] for k in launches}
    hb = [r["Total Loss"] for r in h.losses]
    print(f"[dist w1 bf16] {DIST_BF16_STEPS} steps: loss {hb[0]:.6e} -> "
          f"{hb[-1]:.6e}; launches in fit {_nonzero(in_fit)}", flush=True)
    if in_fit["k3_bf16"] != DIST_BF16_STEPS or in_fit["k3"] or not \
            np.all(np.isfinite(hb)):
        fail(f"dist w1 bf16: K3-bf16 not once per step: {in_fit}")
    paths["dist-w1-bf16"] = dict(launches=launches)
    _held_k3("dist w1 bf16", h)
    del h
    _set_counts(saved)
    return dict(paths=paths, solver=s, ms_w1=ms_a, ms_nondist=ms_b,
                share=share, peak=peak)


def _dist_options_w1(card: str) -> dict:
    """Phase 17(d): causal and NTK weighting under ``compile(dist=True)`` at
    world 1 over NCCL: each option's 50 steps bit for bit the non-dist
    solver and its eager steps, one capture, and the kernels of its path
    (K1 and K2 once per step for causal, K3 once per step for NTK)."""
    import torch
    from tensordiffeq_tpu_torch.ops import cuda_taylor as ct

    saved = _counts_all()
    paths = {}
    for tag, extra in DIST_OPTIONS.items():
        ct.reset_launch_counts()
        a = _dist_solver(N_POINTS, True, **extra)
        at_compile = _counts()
        a.fit(tf_iter=DIST_OPT_STEPS, chunk=DIST_OPT_STEPS)
        torch.cuda.synchronize()
        launches = _counts()
        in_fit = {k: launches[k] - at_compile[k] for k in launches}
        ms = 1e3 * a._adam_result.chunk_seconds[-1] / DIST_OPT_STEPS
        # the referees' launches are not the path's
        path_counts = _counts_all()
        b = _dist_solver(N_POINTS, False, **extra)
        b.fit(tf_iter=DIST_OPT_STEPS, chunk=DIST_OPT_STEPS)
        c = _dist_solver(N_POINTS, True, **extra)
        c.fit(tf_iter=DIST_OPT_STEPS, chunk=DIST_OPT_STEPS, _graphs=False)
        d_nondist, d_eager = _state_diff(a, b), _state_diff(a, c)
        _set_counts(path_counts)
        hist = [r["Total Loss"] for r in a.losses]
        if tag == "causal":
            extra_txt = (f"Causal_w_last "
                         f"{a.losses[-1]['Causal_w_last_0']:.4f}")
        else:
            weights = [round(float(v), 4)
                       for v in a.lambdas["BCs"] + a.lambdas["residual"]]
            extra_txt = (f"NTK updates {len(a.ntk_updates)}, weights "
                         f"{weights}")
        print(f"[dist w1 {tag}] NCCL world 1, AC N_f={N_POINTS:,}, engine "
              f"{a.engine}: {DIST_OPT_STEPS} steps, loss {hist[0]:.6e} -> "
              f"{hist[-1]:.6e}, {extra_txt}; launches in fit {in_fit}; "
              f"captures {a._adam.graph.captures}; against the non-dist "
              f"solver: "
              f"{'bit-identical' if d_nondist == 0 else d_nondist}; graph "
              f"against eager: "
              f"{'bit-identical' if d_eager == 0 else d_eager}; "
              f"{ms:.3f} ms/step (the capture's chunk); {card}", flush=True)
        if d_nondist != 0 or d_eager != 0 or a._adam.graph.captures != 1:
            fail(f"dist w1 {tag}: not bit for bit the non-dist solver "
                 f"({d_nondist}) or its eager steps ({d_eager}), or not one "
                 "capture")
        want = ({"k1": DIST_OPT_STEPS, "k2": DIST_OPT_STEPS, "k3": 0}
                if tag == "causal" else
                {"k1": 0, "k2": 0, "k3": DIST_OPT_STEPS})
        if in_fit != want or not np.all(np.isfinite(hist)):
            fail(f"dist w1 {tag}: launches in fit {in_fit}, want {want}")
        paths[f"dist-w1-{tag}"] = dict(launches=launches)
        del a, b, c
    _set_counts(saved)
    return paths


def _dist_serve(solver) -> None:
    """Phase 17(c): ``InferenceEngine(shard=True)`` at world 1 serves ``u``
    bit for bit like ``shard=False``."""
    from tensordiffeq_tpu_torch.exact import allen_cahn_solution
    saved = _counts_all()
    x, t, _ = allen_cahn_solution()
    X = np.stack(np.meshgrid(x, t, indexing="ij"), -1).reshape(-1, 2)
    sur = solver.export_surrogate()
    kw = dict(min_bucket=1024, max_bucket=1 << 17)
    sharded = sur.engine(shard=True, **kw)
    u_sh = sharded.u(X)
    u_pl = sur.engine(**kw).u(X)
    same = np.array_equal(u_sh, u_pl)
    print(f"[dist serve] shard=True at world 1 ({sharded._mesh}): u on "
          f"{X.shape[0]} points {'bit-identical' if same else 'DIFFERS'} "
          f"to shard=False", flush=True)
    if not same:
        fail("dist serve: the sharded engine differs at world 1")
    _set_counts(saved)


def _loss_and_grads(solver) -> tuple:
    """The solver's training loss (its rank's share under ``dist``), its
    gradient at the current parameters and the gradient of its per-point λ
    (the rank's rows): one K3 launch on the card."""
    import torch
    params = [p.detach().clone().requires_grad_(True)
              for p in solver.net.params()]
    lam = solver.lambdas["residual"][0].detach().clone().requires_grad_(True)
    total = solver.loss_fn(params, solver.lambdas["BCs"], [lam],
                           solver.X_f)[0]
    grads = list(torch.autograd.grad(total, params + [lam],
                                     materialize_grads=True))
    return total.detach().reshape(1).clone(), grads[:-1], grads[-1]


def dist_worker(rank: int, world: int, store: str, out: str):
    """Phase 17(b)'s rank: AC-SA at the slice's N_f on the card, world 2
    over gloo; what it measured goes to ``out/rank{r}.json``.  After the
    data-parallel steps (eager: gloo's collectives run on the host), rank
    0 computes the world-1 reference (one evaluation, 20 Adam steps through
    their CUDA graph) in the same process, whose gloo group has moved the
    steps' CUDA tensors (through host copies, :mod:`..parallel`): the
    capture must succeed there, and the graph's steps equal their eager
    run bit for bit."""
    import torch
    from tensordiffeq_tpu_torch import parallel
    from tensordiffeq_tpu_torch.ops import cuda_taylor as ct

    ct.build()
    res = {}
    parallel.initialize_multihost(f"file://{store}/gloo", world, rank,
                                  backend="gloo", timeout_s=120)
    s = _dist_solver(N_POINTS, True)
    res.update(n_local=int(s.X_f.shape[0]), engine=s.engine,
               backend=s.mesh.backend)
    # K3 at this rank's block against its plain flavor
    res["k3_block"] = _held_k3(f"dist w2 rank {rank}", s)
    # one loss-and-gradient evaluation, the ranks' shares summed (the
    # per-point λ gradient stays the rank's own)
    ct.reset_launch_counts()
    total, grads, g_lam = _loss_and_grads(s)
    parallel.all_reduce_(grads + [total], s.mesh)
    res["eval_k3"] = _counts()["k3"]
    # Adam steps at world 2
    ct.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s.fit(tf_iter=DIST_W2_STEPS, chunk=DIST_W2_STEPS)
    torch.cuda.synchronize()
    res["ms_step"] = 1e3 * (time.perf_counter() - t0) / DIST_W2_STEPS
    res["launches"] = _counts_all()
    res["eager"] = bool(s._adam.graph_eager)
    res["hist"] = [r["Total Loss"] for r in s.losses]
    res["params"] = _params_digest(s)
    s.save_checkpoint(os.path.join(store, "ck_w2"))
    # phase 17(d): causal and NTK weighting at world 2, against world 1
    for tag, extra in DIST_OPTIONS.items():
        so = _dist_solver(N_POINTS, True, **extra)
        so.fit(tf_iter=DIST_OPT_W2_STEPS, chunk=DIST_OPT_W2_STEPS)
        res[f"{tag}_hist"] = [r["Total Loss"] for r in so.losses]
        res[f"{tag}_params"] = _params_digest(so)
        if rank == 0:
            ref = _dist_solver(N_POINTS, False, **extra)
            ref.fit(tf_iter=DIST_OPT_W2_STEPS, chunk=DIST_OPT_W2_STEPS)
            res[f"{tag}_ref_hist"] = [r["Total Loss"] for r in ref.losses]
            del ref
        del so
    if rank == 0:
        # the world-1 reference, in this process whose gloo group has
        # moved CUDA tensors: graphed, then its eager twin
        saved = _counts_all()
        ref = _dist_solver(N_POINTS, False)
        rt, rg, rl = _loss_and_grads(ref)
        res["eval_err"] = dict(
            value=abs(float(total) - float(rt)) / abs(float(rt)),
            grads=max(scaled_err(g, h)[1] for g, h in zip(grads, rg)),
            # rank 0 holds rows [0, N/2) of world 1's set
            lam=scaled_err(g_lam, rl[:g_lam.shape[0]])[1])
        ref.fit(tf_iter=DIST_W2_STEPS, chunk=DIST_W2_STEPS)
        twin = _dist_solver(N_POINTS, False)
        twin.fit(tf_iter=DIST_W2_STEPS, chunk=DIST_W2_STEPS, _graphs=False)
        res["ref_hist"] = [r["Total Loss"] for r in ref.losses]
        res["ref_captures"] = ref._adam.graph.captures
        res["ref_graph_eq_eager"] = (
            res["ref_hist"] == [r["Total Loss"] for r in twin.losses]
            and _params_digest(ref) == _params_digest(twin))
        _set_counts(saved)
        del ref, twin
    with open(os.path.join(out, f"rank{rank}.json"), "w") as fh:
        json.dump(res, fh)
    parallel.barrier(s.mesh)


def _dist_world_2(store: str, card: str) -> dict:
    """Phase 17(b): two processes on the one card over gloo, then the
    sharded checkpoint restored at world 1 for 10 more steps."""
    import subprocess
    import torch
    from tensordiffeq_tpu_torch.ops import cuda_taylor as ct

    out = os.path.join(store, "w2")
    os.makedirs(out, exist_ok=True)
    env = {k: v for k, v in os.environ.items()
           if k not in ("LOCAL_RANK", "RANK", "WORLD_SIZE")}
    _release_card("dist w2")
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--dist-worker",
         str(r), "2", store, out], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, env=env) for r in range(2)]
    logs = []
    for r, p in enumerate(procs):
        try:
            text, _ = p.communicate(
                timeout=max(DIST_TIMEOUT_S - (time.perf_counter() - t0), 1))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            for q in procs:
                q.communicate()
            fail(f"dist w2: rank {r} did not finish in {DIST_TIMEOUT_S} s")
        logs.append(text.decode(errors="replace"))
        if p.returncode != 0:
            fail(f"dist w2: rank {r} exited {p.returncode}:\n"
                 f"{logs[-1][-3000:]}")
    wall = time.perf_counter() - t0
    ranks = []
    for r in range(2):
        with open(os.path.join(out, f"rank{r}.json")) as fh:
            ranks.append(json.load(fh))
    r0 = ranks[0]
    traj = np.max(np.abs(np.array(r0["hist"]) - np.array(r0["ref_hist"]))
                  / np.abs(np.array(r0["ref_hist"])))
    ev = r0["eval_err"]
    print(f"[dist w2] K3 at each rank's {r0['n_local']:,}-row block against "
          f"its plain flavor: scale_rel_err "
          f"{[q['k3_block']['scale_rel_err'] for q in ranks]} (tol "
          f"{K3_RTOL:g})", flush=True)
    print(f"[dist w2] two processes on one card over gloo (CUDA tensors; "
          f"the step runs eagerly: {r0['eager']}), AC-SA N_f={N_POINTS:,}, "
          f"{r0['n_local']:,} rows each; one evaluation vs world 1, "
          f"scale-relative: value {ev['value']:.3e}, parameter gradients "
          f"{ev['grads']:.3e}, rank 0's per-point λ gradient "
          f"{ev['lam']:.3e} (band {DIST_EVAL_TOL:g}); "
          f"{DIST_W2_STEPS} Adam steps vs world 1: {traj:.3e} relative "
          f"(band {DIST_TRAJ_RTOL:g}); ranks' parameters "
          f"{'bit-identical' if ranks[0]['params'] == ranks[1]['params'] else 'DIFFER'}"
          f"; K3 per rank in the evaluation {[q['eval_k3'] for q in ranks]}"
          f", in the fit {[q['launches']['k3'] for q in ranks]}; wall "
          f"{wall:.1f} s", flush=True)
    print(f"[dist w2] ms/step {r0['ms_step']:.3f} (rank 0), "
          f"{ranks[1]['ms_step']:.3f} (rank 1): two processes sharing one "
          f"card, not a scaling figure; {card}", flush=True)
    print(f"[dist w2] the world-1 reference in rank 0's gloo process: "
          f"{r0['ref_captures']} capture, graph = eager bit for bit: "
          f"{r0['ref_graph_eq_eager']}", flush=True)
    if not (r0["ref_captures"] == 1 and r0["ref_graph_eq_eager"]):
        fail("dist w2: the world-1 reference did not capture in the gloo "
             "process, or its graph differs from its eager steps")
    if not (max(ev.values()) <= DIST_EVAL_TOL and traj <= DIST_TRAJ_RTOL):
        fail("dist w2: world 2 is outside its bands against world 1")
    if ranks[0]["params"] != ranks[1]["params"] or \
            ranks[0]["hist"] != ranks[1]["hist"]:
        fail("dist w2: the ranks' parameters or histories differ")
    if any(q["eval_k3"] != 1 or q["launches"]["k3"] != DIST_W2_STEPS
           or q["engine"] != "fused-minimax-cuda" for q in ranks):
        fail(f"dist w2: K3 not once per step on each rank: {ranks}")
    if not all(q["eager"] and q["backend"] == "gloo" for q in ranks):
        fail("dist w2: the gloo step did not take its eager route")
    for tag in DIST_OPTIONS:
        got, want = np.array(r0[f"{tag}_hist"]), np.array(
            r0[f"{tag}_ref_hist"])
        err = float(np.max(np.abs(got - want) / np.abs(want)))
        same = (ranks[0][f"{tag}_params"] == ranks[1][f"{tag}_params"]
                and ranks[0][f"{tag}_hist"] == ranks[1][f"{tag}_hist"])
        print(f"[dist w2 {tag}] {DIST_OPT_W2_STEPS} steps at world 2 over "
              f"gloo against world 1: {err:.3e} relative (band "
              f"{DIST_TRAJ_RTOL:g}); ranks' parameters "
              f"{'bit-identical' if same else 'DIFFER'}", flush=True)
        if not (err <= DIST_TRAJ_RTOL and same):
            fail(f"dist w2 {tag}: world 2 is {err:.3e} from world 1, or "
                 "the ranks differ")
    launches = {k: sum(q["launches"][k] for q in ranks)
                for k in r0["launches"]}
    # the world-2 checkpoint at world 1 (no process group): 10 more steps
    saved = _counts_all()
    s = _dist_solver(N_POINTS, True)
    s.restore_checkpoint(os.path.join(store, "ck_w2"))
    ct.reset_launch_counts()
    s.fit(tf_iter=DIST_W2_RESUME, chunk=DIST_W2_RESUME)
    torch.cuda.synchronize()
    k3 = _counts()["k3"]
    hist = [r["Total Loss"] for r in s.losses]
    print(f"[dist w2 restore] the sharded world-2 checkpoint at world 1: "
          f"{int(s.X_f.shape[0]):,} rows, {len(hist)} epochs on record, "
          f"{DIST_W2_RESUME} more steps (K3 {k3}), loss {hist[-1]:.6e}",
          flush=True)
    if not (int(s.X_f.shape[0]) == N_POINTS and k3 == DIST_W2_RESUME
            and len(hist) == DIST_W2_STEPS + DIST_W2_RESUME
            and np.all(np.isfinite(hist))):
        fail("dist w2: the elastic restore at world 1 failed")
    _set_counts(saved)
    return dict(launches=launches, ms_step=r0["ms_step"])


def phase_dist(card: str) -> dict:
    """Phase 17: data parallelism (module docstring)."""
    import shutil
    import tempfile
    import torch.distributed as tdist
    from tensordiffeq_tpu_torch import parallel

    t0 = time.perf_counter()
    store = tempfile.mkdtemp(prefix="tdq_dist_")
    try:
        parallel.initialize_multihost(f"file://{store}/nccl", 1, 0,
                                      backend="nccl", timeout_s=120)
        try:
            w1 = _dist_world_1(card)
            _dist_serve(w1["solver"])
            w1["paths"].update(_dist_options_w1(card))
        finally:
            tdist.destroy_process_group()
        del w1["solver"]
        w2 = _dist_world_2(store, card)
    finally:
        shutil.rmtree(store, ignore_errors=True)
    paths = dict(w1["paths"], **{"dist-w2": dict(launches=w2["launches"])})
    print(f"[dist] phase wall {time.perf_counter() - t0:.1f} s", flush=True)
    return paths


# --------------------------------------------------------------------- #
# phase 18: the operational planes around the K3 training path
# --------------------------------------------------------------------- #
# (a) one supervised run on AC-SA full: checkpoints every 50, a NaN at the
# boundary 150 and a preemption at 350 (the JAX package's resilience demo,
# examples/ac_resilient.py), 500 Adam steps in chunks of 50, then 20 L-BFGS
RES_TF, RES_CHUNK, RES_EVERY, RES_NEWTON = 500, 50, 50, 20
RES_NAN, RES_PREEMPT = 150, 350
# (b) chaos off against a plain fit; (c) a preemption at 150 resumed to
# 300, and the L-BFGS leg preempted at its first chunk boundary (100)
RES_OFF, RES_LBFGS, RES_LBFGS_CUT = 300, 150, 100
# (d) serving under chaos: 2,000 requests of 1-64 points, a flush every 16,
# a quarter of the ops failing, one rung failing its first touch
RES_REQUESTS, RES_FLUSH_EVERY, RES_FAIL_RUNG = 2000, 16, 512
RES_FAIL_RATE = 0.25
# (e) the cluster: two gloo workers on the card (NCCL refuses two ranks on
# one device), 20 Adam steps, a checkpoint every 5, rank 1 lost at 10
CLU_STEPS, CLU_EVERY, CLU_LOSS_AT = 20, 5, 10
RES_TIMEOUT_S = 300  # each process the phase starts
RES_CHILD_SLEEP_S = 0.1  # the real-process child's eval hook, per chunk
PHASE18_TARGET_S = 60


def _adam_captures(since: int) -> int:
    from tensordiffeq_tpu_torch.training import graphs
    return sum(c["name"] == "Adam step" for c in graphs.captures[since:])


def _lam_digest(solver) -> str:
    import hashlib
    h = hashlib.sha256()
    for lam in solver.lambdas["residual"] + solver.lambdas["BCs"]:
        if lam is not None:
            h.update(lam.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def _res_supervised(work: str) -> dict:
    """Phase 18(a): divergence and preemption in one supervised run."""
    import torch
    from tensordiffeq_tpu_torch import telemetry
    from tensordiffeq_tpu_torch.ops import cuda_taylor as ct
    from tensordiffeq_tpu_torch.resilience import Chaos, ResilientFit
    from tensordiffeq_tpu_torch.training import graphs
    from tensordiffeq_tpu_torch.training.lbfgs import lbfgs_minimize

    run_dir = os.path.join(work, "a_run")
    s = _fresh_solver(minimax=None)
    seen = {}
    ct.reset_launch_counts()
    ev0, cap0 = lbfgs_minimize.evaluations, len(graphs.captures)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with telemetry.RunLogger(run_dir, run_id="resilience") as run, \
            telemetry.Tracer(trace_prefix="res"), \
            telemetry.FlightRecorder(run_dir):
        with Chaos(nan_epoch=RES_NAN, preempt_epoch=RES_PREEMPT,
                   seed=0) as chaos:
            rf = ResilientFit(s, os.path.join(work, "a_ck"),
                              checkpoint_every=RES_EVERY, max_retries=3,
                              telemetry=run, resume_on_preemption=True)
            rollback = rf._rollback

            def timed_rollback(exc, attempt):
                seen["exc"] = exc
                t1 = time.perf_counter()
                rollback(exc, attempt)
                torch.cuda.synchronize()
                seen["rollback_s"] = time.perf_counter() - t1

            rf._rollback = timed_rollback
            rf.fit(tf_iter=RES_TF, newton_iter=RES_NEWTON, chunk=RES_CHUNK)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts_all()
    evals = lbfgs_minimize.evaluations - ev0
    events = telemetry.read_events(run_dir)
    steps = sum(e["n_steps"] for e in events
                if e["kind"] == "step_time" and e["phase"] == "adam")
    rollbacks = [e for e in events if e["kind"] == "rollback"]
    remedies = [e.get("remedy") for e in events if e["kind"] == "remedy"]
    preempt = [e for e in events if e["kind"] == "preempt"
               and e.get("flush_s") is not None]
    totals = [r["Total Loss"] for r in s.losses]
    exc = seen.get("exc")
    tree = [] if exc is None or exc.trace_id is None else \
        telemetry.tracing.read_spans(run_dir, trace_id=exc.trace_id)
    reasons = [sec["header"]["reason"]
               for sec in telemetry.flight_sections(run_dir)]
    text = telemetry.report(run_dir)
    lines = [ln for ln in text.splitlines()
             if ln.startswith(("DIVERGED", "RECOVERY", "  remedy",
                               "PREEMPTED", "RESUMED", "HEALED"))]
    adam_caps = _adam_captures(cap0)
    print(f"[resilience a] AC-SA full, {RES_TF} Adam steps in chunks of "
          f"{RES_CHUNK}, checkpoints every {RES_EVERY}, Chaos(nan_epoch="
          f"{RES_NAN}, preempt_epoch={RES_PREEMPT}): fired "
          f"{ {k: v for k, v in chaos.fired.items() if v} }, recoveries "
          f"{rf.recoveries}, resumed {rf.preemptions_resumed}; "
          f"{len(rollbacks)} rollback(s) to epoch "
          f"{[e.get('restored_epoch') for e in rollbacks]}, remedies "
          f"{remedies}; {steps} Adam steps executed, {evals} L-BFGS "
          f"evaluations; launches {_nonzero(counts)}; Adam captures "
          f"{adam_caps}; losses: epoch {RES_NAN - 1} {totals[RES_NAN - 1]:.6e}"
          f", epoch {RES_TF - 1} {totals[RES_TF - 1]:.6e}, after L-BFGS "
          f"{totals[-1]:.6e}; wall {wall:.2f} s", flush=True)
    print(f"[resilience a] rollback {seen.get('rollback_s', float('nan')):.4f}"
          f" s, preemption flush "
          f"{preempt[0]['flush_s'] if preempt else float('nan'):.4f} s; "
          f"TrainingDiverged.trace_id {getattr(exc, 'trace_id', None)} "
          f"({len(tree)} spans in the run log); flight sections {reasons}",
          flush=True)
    for ln in lines:
        print(f"[resilience a report] {ln.strip()}", flush=True)
    if not (chaos.fired["nan"] == 1 and chaos.fired["preempt"] == 1
            and sum(chaos.fired.values()) == 2):
        fail(f"resilience a: the chaos plan fired {chaos.fired}")
    if not (rf.recoveries == 1 and len(rollbacks) == 1
            and rollbacks[0].get("restored_epoch") == RES_NAN
            and remedies == ["lr_backoff(x0.5)"]
            and rf.preemptions_resumed == 1):
        fail(f"resilience a: rollbacks {rollbacks}, remedies {remedies}")
    if not (len(totals) >= RES_TF + 1 and s.newton_done >= 1
            and np.all(np.isfinite(totals))
            and totals[RES_TF - 1] < totals[RES_NAN - 1]):
        fail("resilience a: the run did not complete its budget with "
             "finite losses below the loss before the NaN")
    if not (counts["k3"] == steps + evals and steps > RES_TF
            and sum(v for k, v in counts.items() if k != "k3") == 0):
        fail(f"resilience a: K3 {counts['k3']} against {steps} Adam steps "
             f"+ {evals} L-BFGS evaluations, or another kernel launched "
             f"({_nonzero(counts)})")
    if adam_caps > 2:  # the first capture, and lr_backoff's step
        fail(f"resilience a: {adam_caps} Adam captures (at most 2)")
    if not (exc is not None and exc.trace_id is not None
            and {x["name"] for x in tree} >= {"train.step",
                                               "train.device"}):
        fail("resilience a: the divergence's trace id names no span tree")
    if not ("training_diverged" in reasons and "preempted" in reasons):
        fail(f"resilience a: flight.jsonl sections {reasons}")
    for want in ("DIVERGED", "RECOVERY", "  remedy applied", "PREEMPTED",
                 "RESUMED"):
        if not any(ln.startswith(want) for ln in lines):
            fail(f"resilience a: the report has no {want.strip()} line")
    return dict(launches=counts, solver=s, rollback_s=seen["rollback_s"],
                flush_s=preempt[0]["flush_s"])


def _res_chaos_off(work: str) -> dict:
    """Phase 18(b): the same steps with chaos, tracing and the flight
    recorder on but nothing injected, against a plain fit."""
    import torch
    from tensordiffeq_tpu_torch import telemetry
    from tensordiffeq_tpu_torch.ops import cuda_taylor as ct
    from tensordiffeq_tpu_torch.resilience import Chaos, ResilientFit
    from tensordiffeq_tpu_torch.training import graphs

    out = {}
    for tag in ("plain", "sup"):
        s = _fresh_solver(minimax=None)
        ct.reset_launch_counts()
        cap0 = len(graphs.captures)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if tag == "plain":
            s.fit(tf_iter=RES_OFF, chunk=RES_CHUNK)
        else:
            d = os.path.join(work, "b_run")
            with telemetry.RunLogger(d) as run, telemetry.Tracer(), \
                    telemetry.FlightRecorder(d), Chaos():
                tele = telemetry.TrainingTelemetry(logger=run,
                                                   grad_norm=False)
                ResilientFit(s, os.path.join(work, "b_ck"),
                             checkpoint_every=RES_EVERY,
                             telemetry=tele).fit(tf_iter=RES_OFF,
                                                 chunk=RES_CHUNK)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        chunks = s._adam_result.chunk_seconds[1:]
        out[tag] = dict(solver=s, launches=_counts_all(),
                        captures=_adam_captures(cap0),
                        replay_ms=1e3 * sum(chunks) / (len(chunks)
                                                       * RES_CHUNK),
                        wall_ms=1e3 * wall / RES_OFF)
    p, q = out["plain"], out["sup"]
    diff = _state_diff(p["solver"], q["solver"])
    print(f"[resilience b] chaos off, tracer and flight recorder on, "
          f"ResilientFit with checkpoints every {RES_EVERY}, against a plain "
          f"fit, {RES_OFF} steps: state diff {diff:g} (0: bit for bit); K3 "
          f"{q['launches']['k3']} / {p['launches']['k3']}; Adam captures "
          f"{q['captures']} / {p['captures']}; replay-only ms/step "
          f"{q['replay_ms']:.3f} / {p['replay_ms']:.3f} (chunks past the "
          f"first); whole fit, hooks and checkpoints included, "
          f"{q['wall_ms']:.3f} / {p['wall_ms']:.3f} ms/step", flush=True)
    if diff != 0.0:
        fail(f"resilience b: chaos off differs from the plain fit ({diff})")
    if q["launches"] != p["launches"] or q["captures"] != p["captures"]:
        fail("resilience b: the supervised run launched or captured "
             "otherwise than the plain fit")
    return out


def _res_preempt_in_process(work: str, plain, sup) -> dict:
    """Phase 18(c), in process: a chaos preemption at 150 resumed to 300
    against the plain 300 of (b); the L-BFGS leg preempted at its first
    chunk boundary and resumed, against the leg split there."""
    import torch
    from tensordiffeq_tpu_torch.ops import cuda_taylor as ct
    from tensordiffeq_tpu_torch.resilience import (Chaos, Preempted,
                                                   auto_resume,
                                                   clear_preemption,
                                                   request_preemption)

    ck = os.path.join(work, "c_ck")
    s = _fresh_solver(minimax=None)
    ct.reset_launch_counts()
    with Chaos(preempt_epoch=RES_OFF // 2, seed=0) as chaos:
        try:
            s.fit(tf_iter=RES_OFF, chunk=RES_CHUNK, checkpoint_dir=ck,
                  checkpoint_every=RES_EVERY)
            fail("resilience c: the chaos preemption did not raise")
        except Preempted as e:
            pre = e
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s.restore_checkpoint(ck)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    auto_resume(s, ck, tf_iter=RES_OFF, checkpoint_every=RES_EVERY,
                chunk=RES_CHUNK)
    diff = _state_diff(plain, s)
    # the L-BFGS leg: the reference split at the preempted iteration (its
    # launches are the referee's, not the path's)
    saved = _counts_all()
    plain.fit(newton_iter=RES_LBFGS_CUT)
    plain.fit(newton_iter=RES_LBFGS - RES_LBFGS_CUT)
    _set_counts(saved)
    ck2 = os.path.join(work, "c_ck_lbfgs")
    request_preemption()
    try:
        sup.fit(newton_iter=RES_LBFGS, checkpoint_dir=ck2,
                checkpoint_every=1000)
        fail("resilience c: the L-BFGS preemption did not raise")
    except Preempted as e:
        pre_l = e
    finally:
        clear_preemption()
    auto_resume(sup, ck2, tf_iter=RES_OFF, newton_iter=RES_LBFGS)
    tail = RES_LBFGS - RES_LBFGS_CUT
    same_l = (_params_digest(sup) == _params_digest(plain)
              and _lam_digest(sup) == _lam_digest(plain)
              and [r["Total Loss"] for r in sup.losses[-tail:]]
              == [r["Total Loss"] for r in plain.losses[-tail:]])
    counts = _counts_all()
    print(f"[resilience c] chaos preemption at {pre.phase} epoch "
          f"{pre.epoch} (flush {pre.flush_s:.4f} s), restore "
          f"{restore_s:.4f} s, auto_resume to {RES_OFF}: state diff "
          f"{diff:g} against the uninterrupted run; L-BFGS preempted at "
          f"{pre_l.phase} {pre_l.epoch} (flush {pre_l.flush_s:.4f} s), "
          f"resumed to newton_done {sup.newton_done}: bit for bit the leg "
          f"split there: {same_l}; launches {_nonzero(counts)}", flush=True)
    if not (chaos.fired["preempt"] == 1 and pre.epoch == RES_OFF // 2
            and pre.flush_s is not None and diff == 0.0):
        fail("resilience c: the preempted and resumed Adam leg is not the "
             "uninterrupted one")
    if not (pre_l.phase == "l-bfgs" and pre_l.epoch == RES_LBFGS_CUT
            and sup.newton_done == plain.newton_done and same_l):
        fail("resilience c: the preempted and resumed L-BFGS leg is not the "
             "leg split at its preemption")
    return dict(launches=counts, flush_s=pre.flush_s, restore_s=restore_s)


def _process_age() -> float:
    """Seconds since this process started (Linux ``/proc``; 10 ms
    ticks): where a relaunched process spends its time before it trains."""
    with open("/proc/self/stat") as fh:
        start = int(fh.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as fh:
        up = float(fh.read().split()[0])
    return round(up - start / os.sysconf("SC_CLK_TCK"), 2)


def _slow_eval(phase, step, params):
    time.sleep(RES_CHILD_SLEEP_S)


def resilience_child(ck: str, out: str):
    """Phase 18(c)'s real process: train AC-SA full to RES_OFF epochs under
    a ``PreemptionHandler`` through ``auto_resume``; a SIGTERM flushes at
    the next chunk boundary and exits 75.  Writes ``out`` (JSON) when done,
    ``out.pre`` when preempted."""
    import torch
    from tensordiffeq_tpu_torch import telemetry
    from tensordiffeq_tpu_torch.checkpoint import checkpoint_exists
    from tensordiffeq_tpu_torch.ops import cuda_taylor as ct
    from tensordiffeq_tpu_torch.resilience import (Preempted,
                                                   PreemptionHandler,
                                                   auto_resume,
                                                   handle_preemption)

    torch.cuda.init()
    marks = {"imports_and_cuda_init": _process_age()}
    ct.build()
    s = _fresh_solver(minimax=None)
    marks["build_and_compile"] = _process_age()
    res = {"marks": marks}
    if checkpoint_exists(ck):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s.restore_checkpoint(ck)
        torch.cuda.synchronize()
        res.update(restore_s=time.perf_counter() - t0,
                   resumed_from=len(s.losses))
    run_dir = f"{out}.run{os.getpid()}"
    with telemetry.RunLogger(run_dir) as run, \
            PreemptionHandler(deadline_s=30):
        tele = telemetry.TrainingTelemetry(logger=run, grad_norm=False)
        try:
            auto_resume(s, ck, tf_iter=RES_OFF, checkpoint_every=RES_EVERY,
                        chunk=RES_CHUNK, telemetry=tele, eval_fn=_slow_eval,
                        eval_every=RES_CHUNK)
        except Preempted as e:
            with open(f"{out}.pre", "w") as fh:
                json.dump(dict(res, preempted=e.epoch, flush_s=e.flush_s),
                          fh)
            handle_preemption(e, logger=run)
    marks["done"] = _process_age()
    with open(out, "w") as fh:
        json.dump(dict(res, losses=[r["Total Loss"] for r in s.losses],
                       params=_params_digest(s), lams=_lam_digest(s)), fh)


def _res_real_process(work: str) -> dict:
    """Phase 18(c)'s supervising side, run in a thread: the child gets
    SIGTERM after its first checkpoint (seen through its heartbeat file)
    and must exit 75; its relaunch must resume and finish."""
    import signal

    ck, out = os.path.join(work, "c_real_ck"), os.path.join(work, "c_real")
    hb = os.path.join(work, "c_real.hb")
    env = {k: v for k, v in os.environ.items()
           if k not in ("LOCAL_RANK", "RANK", "WORLD_SIZE", "TDQ_CHAOS")}
    env["TDQ_HEARTBEAT_FILE"] = hb
    argv = [sys.executable, os.path.abspath(__file__), "--resilience-child",
            ck, out]
    res = {}
    _release_card("resilience c")
    t0 = time.perf_counter()
    p = subprocess.Popen(argv, env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT)
    try:
        while True:
            try:
                with open(hb) as fh:
                    if int(fh.read().split()[2]) >= RES_EVERY:
                        break
            except (OSError, IndexError, ValueError):
                pass
            if p.poll() is not None or \
                    time.perf_counter() - t0 > RES_TIMEOUT_S:
                break
            time.sleep(0.01)
        p.send_signal(signal.SIGTERM)
        log = p.communicate(timeout=RES_TIMEOUT_S)[0].decode(
            errors="replace")
    finally:
        if p.poll() is None:
            p.kill()
            p.communicate()
    res.update(rc1=p.returncode, log1=log[-2000:],
               wall1=time.perf_counter() - t0)
    t1 = time.perf_counter()
    try:
        p2 = subprocess.run(argv, env=env, capture_output=True,
                            timeout=RES_TIMEOUT_S)
        res.update(rc2=p2.returncode,
                   log2=p2.stdout.decode(errors="replace")[-2000:])
    except subprocess.TimeoutExpired:
        res.update(rc2=None, log2="timeout")
    res["wall2"] = time.perf_counter() - t1
    for key, path in (("pre", f"{out}.pre"), ("done", out)):
        try:
            with open(path) as fh:
                res[key] = json.load(fh)
        except OSError:
            res[key] = None
    return res


def _res_check_real_process(res: dict, ref: dict):
    from tensordiffeq_tpu_torch.resilience import RESUMABLE_EXIT_CODE
    pre, done = res.get("pre"), res.get("done")
    print(f"[resilience c process] SIGTERM after the first checkpoint: exit "
          f"{res['rc1']} ({res['wall1']:.1f} s), flushed at epoch "
          f"{None if pre is None else pre['preempted']} in "
          f"{None if pre is None else pre['flush_s']} s; relaunch exit "
          f"{res['rc2']} ({res['wall2']:.1f} s), resumed from epoch "
          f"{None if done is None else done.get('resumed_from')}, restore "
          f"{None if done is None else done.get('restore_s')} s; the "
          f"relaunch's process age at each mark, s: "
          f"{None if done is None else done.get('marks')}", flush=True)
    if res["rc1"] != RESUMABLE_EXIT_CODE or pre is None:
        fail(f"resilience c process: exit {res['rc1']}, not "
             f"{RESUMABLE_EXIT_CODE}:\n{res['log1']}")
    if res["rc2"] != 0 or done is None:
        fail(f"resilience c process: the relaunch exited {res['rc2']}:\n"
             f"{res['log2']}")
    if not (done.get("resumed_from") == pre["preempted"]
            and 0 < pre["preempted"] < RES_OFF):
        fail("resilience c process: the relaunch did not resume from the "
             "flushed epoch")
    if not (done["losses"] == ref["losses"] and done["params"]
            == ref["params"] and done["lams"] == ref["lams"]):
        fail("resilience c process: the resumed run is not the "
             "uninterrupted one bit for bit")
    return dict(flush_s=pre["flush_s"], restore_s=done["restore_s"])


def _res_queries(seed: int = 7) -> list:
    rng = np.random.RandomState(seed)
    return [np.stack([rng.uniform(-1, 1, n), rng.uniform(0, 1, n)],
                     -1).astype(np.float32)
            for n in rng.randint(1, 65, RES_REQUESTS)]


def _res_drive(batcher, queries) -> list:
    """Submit every query, flushing every RES_FLUSH_EVERY submits (the same
    batches on every run); the handles."""
    handles = []
    for i, X in enumerate(queries):
        handles.append(batcher.submit(X))
        if (i + 1) % RES_FLUSH_EVERY == 0:
            batcher.flush()
    batcher.flush()
    return handles


def _res_serve(solver, work: str) -> dict:
    """Phase 18(d): serving under chaos on the (a) solver's engine."""
    from tensordiffeq_tpu_torch import telemetry
    from tensordiffeq_tpu_torch.ops import cuda_taylor as ct
    from tensordiffeq_tpu_torch.resilience import (Chaos, CircuitBreaker,
                                                   RetryPolicy)
    from tensordiffeq_tpu_torch.serving import RequestBatcher

    queries = _res_queries()
    sur = solver.export_surrogate()

    def batcher(eng, reg):
        return RequestBatcher(
            eng, max_batch=1 << 20, max_latency_s=1e9,
            retry=RetryPolicy(max_attempts=8, base_delay_s=0.0, jitter=0.0),
            breaker=CircuitBreaker(failure_threshold=10,
                                   reset_timeout_s=1.0, registry=reg),
            sleep=lambda s: None, registry=reg)

    ct.reset_launch_counts()
    reg = telemetry.MetricsRegistry()
    eng = sur.engine(min_bucket=256, max_bucket=4096, registry=reg)
    t0 = time.perf_counter()
    with Chaos(serving_fail_rate=RES_FAIL_RATE,
               compile_fail_buckets=(RES_FAIL_RUNG,), seed=1) as chaos:
        b = batcher(eng, reg)
        handles = _res_drive(b, queries)
    wall = time.perf_counter() - t0
    stats = b.stats()
    hung = sum(not h.done for h in handles)
    got = [h.result() for h in handles]
    quarantined = eng.quarantined_buckets()
    # the same queries with chaos off: on an engine routed as the chaos one
    # is (its quarantine restored: the same rungs, so the same bits), and on
    # a clean engine (another rung for the rerouted chunks: float32 rounding)
    off = sur.engine(min_bucket=256, max_bucket=4096,
                     registry=telemetry.MetricsRegistry())
    off.restore_quarantine(eng.quarantine_snapshot())
    ref = [h.result() for h in _res_drive(
        batcher(off, telemetry.MetricsRegistry()), queries)]
    clean = sur.engine(min_bucket=256, max_bucket=4096,
                       registry=telemetry.MetricsRegistry())
    base = [h.result() for h in _res_drive(
        batcher(clean, telemetry.MetricsRegistry()), queries)]
    d = os.path.join(work, "d_run")
    with telemetry.RunLogger(d) as run, telemetry.Tracer(trace_prefix="q"):
        traced_handles = _res_drive(batcher(off, telemetry.MetricsRegistry()),
                                    queries)
    traced = [h.result() for h in traced_handles]
    spans = telemetry.tracing.read_spans(d)
    by_trace = {}
    for sp in spans:
        by_trace.setdefault(sp["trace"], []).append(sp["name"])
    trees = sum("serving.batcher.enqueue" in by_trace.get(h.trace_id, ())
                for h in traced_handles)
    counts = _counts_all()
    same = all(np.array_equal(a, c) for a, c in zip(got, ref))
    same_t = all(np.array_equal(a, c) for a, c in zip(traced, ref))
    worst = max(float(np.max(np.abs(a - c))) for a, c in zip(got, base))
    scale = max(float(np.max(np.abs(c))) for c in base)
    print(f"[resilience d] {RES_REQUESTS} requests, a flush every "
          f"{RES_FLUSH_EVERY}, Chaos(serving_fail_rate={RES_FAIL_RATE}, "
          f"compile_fail_buckets=({RES_FAIL_RUNG},)): fired "
          f"{ {k: v for k, v in chaos.fired.items() if v} }; batcher "
          f"requests {stats['requests']}, retried_ok {stats['retried_ok']}, "
          f"failed {stats['failed']}, timed_out {stats['timed_out']}, "
          f"rejected {stats['rejected']}, hung {hung}; quarantined "
          f"{quarantined}; answers bit for bit the chaos-off engine routed "
          f"alike: {same}; against a clean engine {worst / scale:.2e} "
          f"scale-relative; traced answers bit for bit: {same_t}, "
          f"{trees}/{RES_REQUESTS} queries with their span tree; launches "
          f"{_nonzero(counts)}; wall {wall:.2f} s", flush=True)
    if not (stats["retried_ok"] > 0 and stats["failed"] == 0 and hung == 0
            and stats["requests"] == RES_REQUESTS):
        fail(f"resilience d: the batcher under chaos: {stats}, hung {hung}")
    if quarantined != {"u": [RES_FAIL_RUNG]} or chaos.fired["compile"] != 1:
        fail(f"resilience d: quarantined {quarantined}, not the failing "
             f"rung {RES_FAIL_RUNG} alone")
    if not (same and same_t and trees == RES_REQUESTS):
        fail("resilience d: chaos or tracing changed a served answer, or a "
             "query left no span tree")
    if worst > 1e-6 * scale:
        fail(f"resilience d: a rerouted answer is {worst / scale:.2e} from "
             "the clean engine's (band 1e-6)")
    if any(counts.values()):
        fail(f"resilience d: the f32 serving programs launched "
             f"{_nonzero(counts)}")
    return dict(launches=counts)


def cluster_worker(pid: int, nproc: int, port: int, ck: str, runs: str):
    """Phase 18(e)'s worker, the JAX package's worker contract
    (``TDQ_HEARTBEAT_FILE``, ``TDQ_CLUSTER_GENERATION``, exit 0 / 75 /
    other): AC-SA full, data-parallel over gloo when the generation has
    more than one process, ``auto_resume`` against the total budget under
    a ``PreemptionHandler``; its own run dir with the inherited trace and a
    flight recorder."""
    import torch
    from tensordiffeq_tpu_torch import parallel, telemetry
    from tensordiffeq_tpu_torch.ops import cuda_taylor as ct
    from tensordiffeq_tpu_torch.resilience import (Preempted,
                                                   PreemptionHandler,
                                                   auto_resume,
                                                   handle_preemption)

    torch.cuda.init()
    marks = {"imports_and_cuda_init": _process_age()}
    ct.build()
    if nproc > 1:
        parallel.initialize_multihost(f"127.0.0.1:{port}", nproc, pid,
                                      backend="gloo", timeout_s=60)
    marks["build_and_group"] = _process_age()
    gen = os.environ["TDQ_CLUSTER_GENERATION"]
    run_dir = os.path.join(runs, f"gen{gen}.w{pid}")
    s = _dist_solver(N_POINTS, True)
    marks["compile"] = _process_age()
    ct.reset_launch_counts()
    with telemetry.RunLogger(run_dir, config={"gen": gen}) as run, \
            telemetry.Tracer.from_env(logger=run), \
            telemetry.FlightRecorder(run_dir, capacity=128):
        # each worker writes its own run dir (its spans and flight ring);
        # the training events are the group's coordinator's
        run.set_writer(True)
        tele = telemetry.TrainingTelemetry(logger=run if pid == 0 else None,
                                           grad_norm=False)
        with PreemptionHandler(deadline_s=30):
            try:
                auto_resume(s, ck, tf_iter=CLU_STEPS,
                            checkpoint_every=CLU_EVERY, chunk=CLU_EVERY,
                            telemetry=tele)
            except Preempted as e:
                handle_preemption(e)
    marks["done"] = _process_age()
    with open(os.path.join(run_dir, "result.json"), "w") as fh:
        json.dump(dict(losses=[r["Total Loss"] for r in s.losses],
                       n_local=int(s.X_f.shape[0]), launches=_counts_all(),
                       marks=marks), fh)


def _res_cluster(work: str) -> dict:
    """Phase 18(e)'s supervising side, run in a thread: the supervisor with
    a tracer and a collector mounted before launch.  Its run logger and
    tracer are not entered (the main thread's legs enter theirs)."""
    import urllib.request
    from tensordiffeq_tpu_torch import telemetry
    from tensordiffeq_tpu_torch.resilience import ClusterSupervisor

    ck, runs = os.path.join(work, "e_ck"), os.path.join(work, "e_runs")
    sup_dir = os.path.join(work, "e_sup_run")
    wdirs = [os.path.join(runs, n) for n in ("gen0.w0", "gen0.w1",
                                             "gen1.w0")]

    def worker_cmd(pid, nproc, port):
        return [sys.executable, os.path.abspath(__file__),
                "--cluster-worker", str(pid), str(nproc), str(port), ck,
                runs]

    env = {k: v for k, v in os.environ.items()
           if k not in ("LOCAL_RANK", "RANK", "WORLD_SIZE")}
    env["TDQ_CHAOS"] = f"host_loss_at={CLU_LOSS_AT}"
    log = telemetry.RunLogger(sup_dir, run_id="cluster")
    tracer = telemetry.Tracer(logger=log, trace_prefix="job")
    sup = ClusterSupervisor(worker_cmd, nproc=2,
                            workdir=os.path.join(work, "e_sup"),
                            heartbeat_timeout_s=120, poll_s=0.05,
                            grace_s=10.0, max_relaunches=2, env=env,
                            tracer=tracer,
                            registry=telemetry.MetricsRegistry())
    coll = sup.serve_metrics(host="card-host", run_dirs=wdirs)
    t0 = time.perf_counter()
    try:
        try:
            result = sup.run(timeout_s=RES_TIMEOUT_S)
        except Exception as e:  # reported by the main thread, which fails
            return dict(error=f"{type(e).__name__}: {e}")
        coll.poll()
        body = urllib.request.urlopen(f"{coll.url}/metrics",
                                      timeout=30).read().decode()
    finally:
        coll.close()
        log.close()
    return dict(result=result, body=body, sup_dir=sup_dir, wdirs=wdirs,
                wall=time.perf_counter() - t0, sup_proc=f"supervisor:"
                f"{os.getpid()}")


def _res_cluster_reference() -> np.ndarray:
    """Phase 18(e)'s reference: the uninterrupted world-1 run of the same
    seed (its launches are not the path's)."""
    ref = _dist_solver(N_POINTS, False)
    saved = _counts_all()
    ref.fit(tf_iter=CLU_STEPS, chunk=CLU_EVERY)
    _set_counts(saved)
    return np.array([r["Total Loss"] for r in ref.losses])


def _res_check_cluster(res: dict, want: np.ndarray) -> dict:
    from tensordiffeq_tpu_torch import telemetry
    from tensordiffeq_tpu_torch.resilience import HOST_LOSS_EXIT_CODE

    if "error" in res:
        fail(f"resilience e: the supervisor raised {res['error']}")
    result, wdirs = res["result"], res["wdirs"]
    gens = result.generations
    with open(os.path.join(wdirs[2], "result.json")) as fh:
        final = json.load(fh)
    traj = float(np.max(np.abs(np.array(final["losses"]) - want)
                        / np.abs(want))) if len(final["losses"]) \
        == CLU_STEPS else float("inf")
    spans = [e for e in telemetry.read_events(res["sup_dir"])
             if e["kind"] == "trace"]
    job = spans[0]["trace"] if spans else None
    stitched = telemetry.tracing.to_perfetto([res["sup_dir"]] + wdirs)
    slices = [e for e in stitched["traceEvents"] if e["ph"] == "X"]
    secs = telemetry.flight_sections(wdirs[1])
    recs = secs[-1]["records"] if secs else []
    ring = [r for r in recs if r.get("kind") == "trace"]
    fault = [r for r in recs if r.get("kind") == "chaos" and "fault" in r]
    body = res["body"]
    merged = all(f'collector_events_total{{host="card-host",process="{w}"}}'
                 in body for w in ("gen0.w0", "gen0.w1", "gen1.w0"))
    print(f"[resilience e] ClusterSupervisor, two gloo workers on one card, "
          f"AC-SA N_f={N_POINTS:,}, {CLU_STEPS} steps, checkpoints every "
          f"{CLU_EVERY}, TDQ_CHAOS=host_loss_at={CLU_LOSS_AT}: ok "
          f"{result.ok}, hosts_lost {result.hosts_lost}, relaunches "
          f"{result.relaunches}, generations {[g.nproc for g in gens]}, "
          f"lost {gens[0].lost if gens else None}, return codes "
          f"{[g.returncodes for g in gens]}; recovery wall "
          f"{result.recovery_wall_s} s; the world-1 relaunch against an "
          f"uninterrupted world-1 run: {traj:.3e} relative (band "
          f"{DIST_TRAJ_RTOL:g}); {len(slices)} spans stitched over "
          f"{len({e['pid'] for e in slices})} processes in "
          f"{len({e['args']['trace_id'] for e in slices})} trace(s); "
          f"/metrics merged the workers: {merged}; the killed worker's "
          f"flight: {secs[-1]['header']['reason'] if secs else None}, last "
          f"span {ring[-1]['name'] if ring else None}; the relaunch's "
          f"launches {_nonzero(final['launches'])}, its process age at "
          f"each mark {final['marks']} s; wall {res['wall']:.1f} s",
          flush=True)
    if not (result.ok and result.hosts_lost == 1 and result.relaunches == 1
            and [g.nproc for g in gens] == [2, 1]
            and gens[0].lost == [(1, "exit")]
            and HOST_LOSS_EXIT_CODE in gens[0].returncodes):
        fail(f"resilience e: the cluster result {result}")
    if traj > DIST_TRAJ_RTOL:
        fail(f"resilience e: the relaunch is {traj:.3e} from world 1")
    if not (job is not None and {e["args"]["trace_id"] for e in slices}
            == {job} and {e["pid"] for e in slices} == {1, 2, 3, 4}):
        fail("resilience e: the stitched trace does not hold the supervisor, "
             "both workers and the relaunch in one trace")
    if not merged or f'process="{res["sup_proc"]}"' not in body:
        fail("resilience e: /metrics did not serve the merged metrics")
    if not (secs and secs[-1]["header"]["reason"] == "host_loss" and ring
            and ring[-1]["name"] == "train.step" and fault
            and recs.index(fault[0]) > recs.index(ring[-1])):
        fail("resilience e: the killed worker's flight.jsonl does not end "
             "in the chunk it died in")
    if final["launches"]["k3"] != CLU_STEPS - CLU_LOSS_AT:
        fail(f"resilience e: the relaunch launched {final['launches']}")
    return dict(launches=final["launches"],
                recovery_s=result.recovery_wall_s[0])


def phase_resilience(card: str) -> dict:
    """Phase 18: the operational planes around the K3 training path (module
    docstring).  The two legs that run processes of their own, (c)'s real
    process and (e)'s cluster, start first, in threads, and run beside (a)
    and (d); (b) and the in-process (c), whose timings are reported, run
    after them."""
    import shutil
    import tempfile
    import threading

    t0 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="tdq_res_")
    bg = {}

    def run(key, fn):
        try:
            bg[key] = fn(work)
        except Exception as e:  # reported by the main thread, which fails
            bg[key] = dict(error=f"{type(e).__name__}: {e}")

    threads = [threading.Thread(target=run, args=(k, fn), daemon=True)
               for k, fn in (("cluster", _res_cluster),
                             ("child", _res_real_process))]
    try:
        for th in threads:
            th.start()
        a = _res_supervised(work)
        d = _res_serve(a.pop("solver"), work)
        want = _res_cluster_reference()
        for th in threads:
            th.join(RES_TIMEOUT_S * 2.5)
            if th.is_alive():
                fail("resilience: a subprocess leg did not finish")
        if "error" in bg["child"]:
            fail(f"resilience c process: {bg['child']['error']}")
        b = _res_chaos_off(work)
        plain, sup = b["plain"]["solver"], b["sup"]["solver"]
        ref = dict(losses=[r["Total Loss"] for r in plain.losses],
                   params=_params_digest(plain), lams=_lam_digest(plain))
        c_proc = _res_check_real_process(bg["child"], ref)
        c = _res_preempt_in_process(work, plain, sup)
        e = _res_check_cluster(bg["cluster"], want)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    wall = time.perf_counter() - t0
    print(f"[resilience] rollback {a['rollback_s']:.4f} s; flush "
          f"{a['flush_s']:.4f} s (a), {c['flush_s']:.4f} s (c), "
          f"{c_proc['flush_s']:.4f} s (c, process); restore "
          f"{c['restore_s']:.4f} s (c), {c_proc['restore_s']:.4f} s (c, "
          f"process); recovery wall {e['recovery_s']:.2f} s (e); hooks "
          f"{b['sup']['replay_ms']:.3f} against plain "
          f"{b['plain']['replay_ms']:.3f} ms/step, replays only; {card}",
          flush=True)
    print(f"[resilience] phase wall {wall:.1f} s (target "
          f"{PHASE18_TARGET_S} s)", flush=True)
    return {"resilience": dict(launches=a["launches"]),
            "resilience-off": dict(launches=b["sup"]["launches"]),
            "resilience-resume": dict(launches=c["launches"]),
            "resilience-serve": dict(launches=d["launches"]),
            "resilience-cluster": dict(launches=e["launches"])}


# --------------------------------------------------------------------- #
# phase 19: the surrogate factory
# --------------------------------------------------------------------- #
# (b)-(e): the JAX package's factory benchmark (bench.py --mode factory):
# 64 Allen-Cahn members, theta_m = 1e-4 (0.5 + m/63), N_f = 2,048 per
# member, 2-64-64-1, SA lambda on the residual (ones)
FAC_M, FAC_NF, FAC_WIDTHS, FAC_STEPS = 64, 2_048, [2, 64, 64, 1], 200
FAC_BIT, FAC_SOLO_STEPS, FAC_CKPT_STEPS, FAC_RESAMPLE_STEPS = 50, 20, 10, 30
FAC_POISONED = 5  # the member (b) fills with NaN
# (b): a member against its matched-seed solo solver, scale-relative over
# 20 steps: the same kernel on the same rows; the BC terms and Adam run on
# the stacked tensors (measured 1.1e-7-1.5e-7 on the CPU)
FAC_SOLO_TOL = 1e-5
# (e): the served u against the member's network on the same points
FAC_SERVE_TOL = 1e-6
# (b): the member-axis K3's flavors, by counter key (the f32 one is the
# family step's; the bf16 and TF32 ones are held at the same tensors)
FAC_FLAVORS = (("k3f", {}), ("k3f_bf16", dict(compute_dtype="bfloat16")),
               ("k3f_tf32", dict(precision="default")))


def _fac_counts() -> dict:
    """``_counts()`` and the member-axis K3's (``k3f``)."""
    from tensordiffeq_tpu_torch.ops import cuda_minimax as cm
    return {**_counts(), "k3f": cm.k3_minimax_family.launches}


def _fac_member_k3(fac, key: str, flavor: dict) -> dict:
    """Phase 19(b): K3 over the member axis in one flavor at the family's
    live tensors (X_f, w = λ², the parameters): every member's outputs bit
    for bit its single launch's, bit for bit run to run, members 0 and M-1
    against the plain flavor (f32 at K3_RTOL, bf16 in the bf16 bands; the
    TF32 flavor's distances to its emulation and phase 16's band for them
    reported, not gated: at this shape K3-TF32's single launch, which the
    member axis equals bit for bit, sits outside that band's RMS for
    member 63); CUDA events over 20 launches of the member-axis
    launch and of the M single launches, the plain flavor over 3, the
    bound (the members' work at the flavor's passes), and in the f32 flavor
    the yardstick: the family's products as ``torch.bmm`` over the members
    (the hidden layer's forward, dH and dW at N·C rows), f32.  Comparison
    launches: the counts are put back."""
    import torch
    from tensordiffeq_tpu_torch.factory.family import _bind
    from tensordiffeq_tpu_torch.ops import cuda_minimax as cm
    from tensordiffeq_tpu_torch.ops.minimax import (build_family_sq_fn,
                                                    build_minimax_sq_fn)
    saved = _counts_all()
    tpl = fac._template
    M, N = fac.n_members, int(fac.X_f.shape[1])
    shapes = [tuple(W.shape) for W, _ in tpl.net.layers()]
    if key == "k3f":
        sqs = [fac._member_sq[m] for m in range(M)]
    else:
        sqs = [build_minimax_sq_fn(
            _bind(fac.f_model, fac.member_thetas[m]), fac.varnames,
            fac.n_out, tpl._fuse_requests, shapes, **flavor)
            for m in range(M)]
    fam = build_family_sq_fn(sqs)
    plan = sqs[0].plan
    launch = cm.FAMILY_FLAVORS[fam.flavor]
    single = cm.FLAVORS[fam.flavor]
    lam = fac.lambdas["residual"][0].detach()
    w = (lam * lam).contiguous()
    X = fac.X_f.contiguous()
    leaves = [p.detach() if p.ndim == 3 else p.detach().reshape(M, 1, -1)
              for p in fac.params]
    flat = torch.cat([t.reshape(M, -1) for t in leaves], 1)
    table = fam.constants[0].to(X.device)
    if fam.groups != [list(range(M))]:
        fail(f"factory {key}: the sweep's tapes are not one group: "
             f"{fam.groups}")
    got = launch(plan, X, w, flat, table)
    again = launch(plan, X, w, flat, table)
    packed = [sqs[m].plan.pack([t[m] for t in leaves]) for m in range(M)]
    Xs = [X[m].contiguous() for m in range(M)]
    ws = [w[m].contiguous() for m in range(M)]
    torch.cuda.synchronize()
    run_bits = all(torch.equal(a, b) for a, b in zip(got, again))
    same = 0
    for m in range(M):
        one = single(sqs[m].plan, Xs[m], ws[m], packed[m])
        same += all(torch.equal(a, b) for a, b in zip(
            (got[0][m], got[1][m], got[2][m], got[3][m]), one))
    bf16, tf32 = key == "k3f_bf16", key == "k3f_tf32"
    errs, worst = [], 0.0
    for m in (0, M - 1):
        fl = [t[m] for t in leaves]
        if tf32:  # the TF32 flavor's referees and band (phase 16), reported

            def four(res):
                v, d, gw_, gX_ = res
                return ([v.reshape(1)] + [t.reshape(-1) for t in d]
                        + [gw_, gX_])

            _tf32_check(
                f"factory {key} member {m}",
                four((got[0][m], sqs[m].plan.unpack(got[1][m]), got[2][m],
                      got[3][m])),
                four(sqs[m].plain(fl, ws[m], Xs[m], emulate_tf32=True)),
                four(sqs[m].plain(fl, ws[m], Xs[m],
                                  emulate_tf32="float64")),
                four(fac._member_sq[m].plain(fl, ws[m], Xs[m])), gate=False)
        want = _k3_leaves(lam[m], *sqs[m].plain(fl, ws[m], Xs[m],
                                                emulate_tf32=tf32))
        mine = _k3_leaves(lam[m], got[0][m], sqs[m].plan.unpack(got[1][m]),
                          got[2][m], got[3][m])
        if not all(bool(torch.isfinite(t).all()) for t in mine):
            fail(f"factory {key}: member {m} has a non-finite output")
        for i, (a, b) in enumerate(zip(mine, want)):
            e = scaled_err(a, b)
            errs.append(e)
            # bf16: the value, gw and the λ gradient 2λ·gw are values
            band = (K3_RTOL if not bf16 else BF16_VALUE_BAND
                    if i in (0, len(want) - 3, len(want) - 2)
                    else BF16_GRAD_BAND)
            worst = max(worst, e[1] / band)
    ms = cuda_ms(lambda: launch(plan, X, w, flat, table))

    def singles():
        for m in range(M):
            single(sqs[m].plan, Xs[m], ws[m], packed[m])

    singles_ms = cuda_ms(singles)
    plain_ms = cuda_ms(lambda: fam.plain(leaves, w, X), reps=3, warmup=1)
    flops = cm.flop_count(plan, N)["k3"]
    flops = {k: M * v for k, v in flops.items()}
    nbytes = M * cm.byte_count(plan, N)["k3"]
    if bf16:
        bound = bound_ms(flops, nbytes, cm.tensor_passes(plan,
                                                         torch.bfloat16),
                         PEAK_BF16_FLOPS)
    else:
        bound = bound_ms(flops, nbytes, 1 if tf32 else TF32_PASSES)
    yard = None
    if key == "k3f":
        rows, width = N * plan.C, shapes[1][0]
        g = torch.Generator(device=X.device).manual_seed(0)
        H = torch.randn(M, rows, width, device=X.device, generator=g)
        dP = torch.randn(M, rows, width, device=X.device, generator=g)
        W = torch.randn(M, width, width, device=X.device, generator=g)

        def products():
            torch.bmm(H, W)
            torch.bmm(dP, W.transpose(1, 2))
            torch.bmm(H.transpose(1, 2), dP)

        yard = cuda_ms(products)
    _set_counts(saved)
    max_abs = max(e[0] for e in errs)
    rel = max(e[1] for e in errs)
    print(f"[factory {key}] K3 over {M} members (N={N:,} each, "
          f"{fac.layer_sizes}, flavor {fam.flavor or 'f32'}): one launch "
          f"{ms:.3f} ms against the {M} single launches {singles_ms:.3f} "
          f"ms ({singles_ms / ms:.2f}x); members bit for bit their single "
          f"launch {same}/{M}; run to run "
          f"{'bit-identical' if run_bits else 'DIFFERENT'}; members 0 and "
          f"{M - 1} against the plain flavor"
          f"{' (its TF32 emulation)' if tf32 else ''}: "
          f"scale_rel_err {rel:.3e}, max_abs_err {max_abs:.3e}; plain "
          f"{plain_ms:.3f} ms; {bound_text(ms, bound)}"
          + ("" if yard is None else
             f"; yardstick (the products as torch.bmm, f32) {yard:.3f} ms"),
          flush=True)
    if same != M or not run_bits:
        fail(f"factory {key}: a member's outputs are not its single "
             "launch's bit for bit, or the launch is not bit-identical run "
             "to run")
    if not tf32 and not worst <= 1.0:
        fail(f"factory {key}: members 0 and {M - 1} disagree with the "
             "plain flavor")
    return dict(max_abs_err=max_abs, scale_rel_err=rel, ms=ms,
                singles_ms=singles_ms, plain_ms=plain_ms, bound=bound,
                yardstick_ms=yard, route=plan.k3_routes[fam.flavor],
                members=M, bit_identical=bool(same == M and run_bits))


def _fac_f_model(u, x, t, th):
    from tensordiffeq_tpu_torch import grad
    uv = u(x, t)
    return (grad(u, "t")(x, t) - th * grad(grad(u, "x"), "x")(x, t)
            + 5.0 * uv ** 3 - 5.0 * uv)


def _fac_problem():
    """bench.py's factory problem: AC on the 512x201 IC/periodic meshes,
    N_f = 2,048, λ_res = 1 per point, no BC λ."""
    domain, bcs, _, _ = ac_sa_problem(n_f=FAC_NF)
    kw = dict(Adaptive_type=1,
              dict_adaptive={"residual": [True], "BCs": [False, False]},
              init_weights={"residual": [np.ones((FAC_NF, 1))],
                            "BCs": [None, None]})
    return domain, bcs, kw


def _fac_thetas():
    return [1e-4 * (0.5 + m / (FAC_M - 1)) for m in range(FAC_M)]


def _fac_build(**extra):
    from tensordiffeq_tpu_torch.factory import SurrogateFactory
    domain, bcs, kw = _fac_problem()
    return SurrogateFactory(FAC_WIDTHS, _fac_f_model, domain, bcs,
                            thetas=_fac_thetas(), fused="cuda",
                            verbose=False, **dict(kw, **extra))


def _fac_bits(tensors) -> list:
    return [t.detach().cpu().numpy().tobytes() for t in tensors]


def _fac_hist(fac, member=None, rows=None) -> np.ndarray:
    rows = fac.losses if rows is None else fac.losses[:rows]
    h = np.stack([r["Total Loss"] for r in rows])
    return h if member is None else h[:, member]


def _fac_one_member(card: str) -> dict:
    """Phase 19(a): a 1-member family at AC-SA full is its solo solver."""
    import torch
    import tensordiffeq_tpu_torch as tdqt
    from tensordiffeq_tpu_torch.factory import SurrogateFactory
    from tensordiffeq_tpu_torch.factory.family import _as_theta
    from tensordiffeq_tpu_torch.ops import cuda_taylor as ct

    domain, bcs, _, kw = ac_sa_problem()
    th = 1e-4
    ct.reset_launch_counts()
    fac = SurrogateFactory(WIDTHS, _fac_f_model, domain, bcs, thetas=[th],
                           fused="cuda", verbose=False, **kw)
    at_compile = _counts()
    fac.fit(tf_iter=TF_ITER, chunk=TF_ITER // 2)
    torch.cuda.synchronize()
    launches = _counts()
    in_fit = {k: launches[k] - at_compile[k] for k in launches}
    saved = _counts_all()
    solo = tdqt.CollocationSolverND(verbose=False, seed=0)
    th0 = _as_theta(th, "cpu")
    solo.compile(WIDTHS, lambda u, x, t: _fac_f_model(u, x, t, th0), domain,
                 bcs, fused="cuda", **kw)
    solo.fit(tf_iter=TF_ITER, chunk=TF_ITER // 2)
    _set_counts(saved)
    tpl = fac._template
    same = (_fac_hist(fac, 0).tolist() == [r["Total Loss"]
                                           for r in solo.losses]
            and _fac_bits(tpl.net.params()) == _fac_bits(solo.net.params())
            and _fac_bits(tpl.lambdas["residual"] + [
                lam for lam in tpl.lambdas["BCs"] if lam is not None])
            == _fac_bits(solo.lambdas["residual"] + [
                lam for lam in solo.lambdas["BCs"] if lam is not None]))
    caps = tpl._adam.graph.captures
    print(f"[factory 1] a 1-member family at AC-SA full ({WIDTHS}, "
          f"N_f={N_POINTS:,}, SA λ): engine {tpl.engine}, {TF_ITER} steps "
          f"against the solo solver: "
          f"{'bit-identical' if same else 'DIFFER'}; launches in fit "
          f"{in_fit}; captures {caps}; loss {_fac_hist(fac, 0)[0]:.6e} -> "
          f"{_fac_hist(fac, 0)[-1]:.6e}", flush=True)
    if not same:
        fail("factory 1: the 1-member family is not its solo solver")
    if in_fit != {"k1": 0, "k2": 0, "k3": TF_ITER} or caps != 1:
        fail(f"factory 1: launches in fit {in_fit}, captures {caps}")
    return dict(launches=launches)


def _fac_carry_check(fac, mode: str) -> float:
    """One family redraw at the current state, timed by CUDA events, then
    adopted: every member's kept rows carry their λ and λ moments bit for
    bit, fresh rows the kept mean and zero moments.  Returns the redraw's
    device ms."""
    import torch
    kw = dict(resample_mode=mode, resample_ascent_steps=5,
              resample_uniform=0.1, resample_pool=4, resample_temp=1.0,
              resample_seed=7)
    sampler = fac._make_sampler(kw, FAC_NF)
    step = fac._step
    lam = fac.lambdas["residual"][0]
    st = fac._opt[1].state[lam]
    before = [lam.detach().clone(), st["exp_avg"].clone(),
              st["exp_avg_sq"].clone()]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    swap = sampler.redraw([p.detach() for p in fac.params], fac.X_f,
                          list(fac._members), 10_000)
    end.record()
    step.adopt(swap.X_new, swap)
    torch.cuda.synchronize()
    ok = True
    for m in range(FAC_M):
        kept = swap.kept[m]
        idx = swap.idx[m][kept]
        for now, old in zip([lam.detach(), st["exp_avg"],
                             st["exp_avg_sq"]], before):
            ok &= bool(torch.equal(now[m][kept], old[m][idx]))
        fresh = ~kept
        if bool(fresh.any()):
            mean = before[0][m][idx].mean(0)
            ok &= bool(torch.allclose(lam.detach()[m][fresh],
                                      mean.expand(int(fresh.sum()), 1),
                                      rtol=1e-6, atol=0.0))
            ok &= bool((st["exp_avg"][m][fresh] == 0).all())
        ok &= bool(torch.equal(fac.X_f[m], swap.X_new[m]))
    if not ok:
        fail(f"factory {mode}: a member's λ or moments were not carried")
    return start.elapsed_time(end)


def phase_factory(card: str) -> dict:
    """Phase 19 (module docstring)."""
    import tempfile
    import torch
    import tensordiffeq_tpu_torch as tdqt
    from tensordiffeq_tpu_torch.factory.family import _as_theta
    from tensordiffeq_tpu_torch.ops import cuda_taylor as ct
    from tensordiffeq_tpu_torch.training import graphs

    t_phase = time.perf_counter()
    paths = {"factory-1": _fac_one_member(card)}

    # (b) the 64-member sweep
    ct.reset_launch_counts()
    t0 = time.perf_counter()
    fac = _fac_build()
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    at_compile = _fac_counts()
    c0 = len(graphs.captures)
    t_first = _timed_fit(fac, tf_iter=FAC_BIT, chunk=FAC_BIT)
    at_bit = _fac_counts()
    in_fit = {k: at_bit[k] - at_compile[k] for k in at_bit}
    caps = _captures_since("factory", c0)
    state_bit = (_fac_bits(fac.params), _fac_hist(fac).copy())
    fam = fac._family_res.family
    n_groups = len(fam.groups)
    print(f"[factory] {FAC_M} members, AC theta 5e-5..1.5e-4, N_f={FAC_NF:,} "
          f"each, {FAC_WIDTHS}: engine {fac._template.engine} "
          f"(family {fac.engine}, tape groups {n_groups}, K3 route "
          f"{fam.k3_routes}), built in {t_build:.2f} s; launches "
          f"after compile {at_compile}, in {FAC_BIT} steps {in_fit}; "
          f"captures {len(caps)}", flush=True)
    if n_groups != 1 or in_fit != {"k1": 0, "k2": 0, "k3": 0,
                                   "k3f": n_groups * FAC_BIT} \
            or fam.k3_routes != {None: "wgmma"}:
        fail(f"factory: the member-axis K3 not once per step, a member's own "
             f"K3 or K1/K2 ran: {in_fit} ({n_groups} tape groups)")
    if len(caps) != 1 or fac._step.graph.captures != 1:
        fail(f"factory: {len(caps)} captures, want one family step")
    saved = _counts_all()
    # graph against eager, and a poisoned member, over FAC_BIT steps
    twin = _fac_build()
    twin.fit(tf_iter=FAC_BIT, chunk=FAC_BIT, _graphs=False)
    d_eager = (twin.losses and _fac_bits(twin.params) == state_bit[0]
               and np.array_equal(_fac_hist(twin), state_bit[1]))
    pois = _fac_build()
    with torch.no_grad():
        for p in pois.params:
            p[FAC_POISONED].fill_(float("nan"))
    pois.fit(tf_iter=FAC_BIT, chunk=FAC_BIT)
    others = [m for m in range(FAC_M) if m != FAC_POISONED]
    h_p = _fac_hist(pois)
    d_pois = (pois.frozen_at == {FAC_POISONED: 0}
              and pois.alive.tolist() == [m != FAC_POISONED
                                          for m in range(FAC_M)]
              and np.array_equal(h_p[:, others], state_bit[1][:, others])
              and all(np.array_equal(
                  p.detach().cpu().numpy()[others],
                  np.frombuffer(b, np.float32).reshape(p.shape)[others])
                  for p, b in zip(pois.params, state_bit[0])))
    print(f"[factory] graph against eager over {FAC_BIT} steps: "
          f"{'bit-identical' if d_eager else 'DIFFER'}; member "
          f"{FAC_POISONED} poisoned with NaN: frozen_at {pois.frozen_at}, "
          f"the other {FAC_M - 1} "
          f"{'bit-identical' if d_pois else 'DIFFER'}", flush=True)
    if not (d_eager and d_pois):
        fail("factory: graph != eager, or a NaN member reached another")
    del pois
    # two members against matched-seed solo solvers
    domain, bcs, kw = _fac_problem()
    rest = FAC_STEPS - FAC_BIT  # the timed window, family and solo alike
    worst, solo_ms, solo_caps = 0.0, None, None
    for m in (0, FAC_M - 1):
        th = _as_theta(_fac_thetas()[m], "cpu")
        solo = tdqt.CollocationSolverND(verbose=False, seed=m)
        solo.compile(FAC_WIDTHS, lambda u, x, t, _t=th: _fac_f_model(
            u, x, t, _t), domain, bcs, fused="cuda", **kw)
        solo.fit(tf_iter=FAC_SOLO_STEPS, chunk=FAC_SOLO_STEPS)
        want = np.array([r["Total Loss"] for r in solo.losses])
        got = state_bit[1][:FAC_SOLO_STEPS, m]
        worst = max(worst, float(np.abs(got - want).max()
                                 / np.abs(want).max()))
        if m == 0:
            # timed as the family step is: a fit in chunks of FAC_BIT first
            # (its history buffer, so its capture), then replays only
            solo.fit(tf_iter=FAC_BIT, chunk=FAC_BIT)
            caps = solo._adam.graph.captures
            solo_ms = 1e3 * _timed_fit(solo, tf_iter=rest,
                                       chunk=FAC_BIT) / rest
            solo_caps = solo._adam.graph.captures - caps
    _set_counts(saved)
    print(f"[factory] members 0 and {FAC_M - 1} against matched-seed solo "
          f"solvers over {FAC_SOLO_STEPS} steps: {worst:.3e} scale-relative "
          f"(band {FAC_SOLO_TOL:g})", flush=True)
    if not worst <= FAC_SOLO_TOL:
        fail("factory: members drift from their solo solvers")
    if solo_caps != 0:
        fail(f"factory: the solo baseline captured {solo_caps} graphs in "
             "its timed window")
    # the rest of the budget: ms per family step past the capture
    # chunks of FAC_BIT: the captured step replays on (a longer chunk would
    # take a larger history buffer and a capture of its own)
    wall = _timed_fit(fac, tf_iter=rest, chunk=FAC_BIT)
    ms = 1e3 * wall / rest
    h = _fac_hist(fac)
    print(f"[factory] {FAC_STEPS} steps: mean member loss {h[0].mean():.6e} "
          f"-> {h[-1].mean():.6e}, all alive {bool(fac.alive.all())}; "
          f"{ms:.3f} ms per family step ({rest} replayed steps in chunks "
          f"of {FAC_BIT}; the first {FAC_BIT}, with the capture, "
          f"{1e3 * t_first / FAC_BIT:.3f}; captures "
          f"{fac._step.graph.captures})"
          f", {FAC_M * FAC_NF / ms * 1e3:.4g} points/s; the solo member "
          f"{solo_ms:.3f} ms/step ({rest} replayed steps in chunks of "
          f"{FAC_BIT}, no capture) x {FAC_M} = {solo_ms * FAC_M:.3f} ms "
          f"sequential ({solo_ms * FAC_M / ms:.2f}x); {card}", flush=True)
    if not (np.all(np.isfinite(h)) and h[-1].mean() < h[0].mean()
            and bool(fac.alive.all())):
        fail("factory: the family's loss did not fall")
    paths["factory"] = dict(launches=_fac_counts(), ms_step=ms)
    # K3 at the family's own shapes: the first and the last member, each
    # through its own lowered tape, on its live rows, parameters and λ
    for m in (0, FAC_M - 1):
        i = fac._local(m)
        _k3_against_plain(
            f"factory member {m}", fac._member_sq[m], fac.X_f[i],
            fac.lambdas["residual"][0][i].detach(),
            [p[i].detach() if p.ndim == 3 else p[i].detach().reshape(1, -1)
             for p in fac.params])
    # the member-axis K3 at the same tensors, in its three flavors
    meas = {key: _fac_member_k3(fac, key, flavor)
            for key, flavor in FAC_FLAVORS}

    # (c) a pool and an ascent redraw at M = 64
    for mode in ("pool", "ascent"):
        ct.reset_launch_counts()
        n0 = len(fac.redraws)
        caps0 = fac._step.graph.captures
        fac.fit(tf_iter=FAC_RESAMPLE_STEPS, chunk=10, resample_every=10,
                resample_mode=mode)
        torch.cuda.synchronize()
        launches = _fac_counts()
        recs = fac.redraws[n0:]
        saved = _counts_all()
        direct_ms = _fac_carry_check(fac, mode)
        _set_counts(saved)
        n_rd = len(recs)
        # the pool redraw scores with K1 per member; the ascent mover's 5
        # steps and last score are one member-axis K3 each
        want = ({"k1": FAC_M * n_rd, "k2": 0, "k3": 0,
                 "k3f": FAC_RESAMPLE_STEPS} if mode == "pool" else
                {"k1": 0, "k2": 0, "k3": 0,
                 "k3f": FAC_RESAMPLE_STEPS + 6 * n_rd})
        print(f"[factory {mode}] {FAC_RESAMPLE_STEPS} steps, redraws "
              + ", ".join(f"at {r['epoch']} (adopted {r['adopted']}, device "
                          f"{r['device_ms'] or float('nan'):.3f} ms on its "
                          f"stream, kept "
                          f"{r['stats']['kept_fraction']:.3f})"
                          for r in recs)
              + f"; launches {launches} (want {want}); dispatch host ms "
              f"{[round(1e3 * r['dispatch_s'], 1) for r in recs]}; one "
              f"redraw alone {direct_ms:.3f} ms, λ and moments carried bit "
              f"for bit; new captures across the swaps "
              f"{fac._step.graph.captures - caps0}", flush=True)
        if launches != want or n_rd != 2 or recs[0]["adopted"] is None \
                or fac._step.graph.captures != caps0:
            fail(f"factory {mode}: launches {launches}, redraws {recs}")
        paths[f"factory-{mode}"] = dict(launches=launches)

    # (d) a checkpoint round trip, then 10 more steps bit for bit
    saved = _counts_all()
    ck = tempfile.mkdtemp(prefix="tdq_factory_")
    t0 = time.perf_counter()
    fac.save_checkpoint(ck)
    t_save = time.perf_counter() - t0
    t0 = time.perf_counter()
    twin.restore_checkpoint(ck)
    t_restore = time.perf_counter() - t0
    for f in (fac, twin):
        f.fit(tf_iter=FAC_CKPT_STEPS, chunk=FAC_CKPT_STEPS)
    same = (_fac_bits(fac.params) == _fac_bits(twin.params)
            and np.array_equal(_fac_hist(fac), _fac_hist(twin)))
    print(f"[factory checkpoint] save {t_save:.3f} s, restore "
          f"{t_restore:.3f} s, {FAC_CKPT_STEPS} more steps "
          f"{'bit-identical' if same else 'DIFFER'}", flush=True)
    if not same:
        fail("factory: the restored family does not resume bit for bit")
    # (e) a member served
    X = np.random.RandomState(3).uniform(
        [-1.0, 0.0], [1.0, 1.0], (4096, 2)).astype(np.float32)
    worst = 0.0
    for m in (0, FAC_M - 1):
        served = np.asarray(fac.member_surrogate(m).engine(
            min_bucket=4096, max_bucket=4096).u(X)).reshape(-1)
        want = fac.apply_fn(fac.member_params(m), torch.from_numpy(X).to(
            fac.device)).detach().cpu().numpy().reshape(-1)
        worst = max(worst, float(np.abs(served - want).max()
                                 / np.abs(want).max()))
    _set_counts(saved)
    print(f"[factory serve] members 0 and {FAC_M - 1}: served u against the "
          f"member's network {worst:.3e} scale-relative (band "
          f"{FAC_SERVE_TOL:g})", flush=True)
    if not worst <= FAC_SERVE_TOL:
        fail("factory: a served member differs from its network")
    print(f"[factory] phase wall {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return paths, meas


# --------------------------------------------------------------------- #
# phase 20: the port's example scripts
# --------------------------------------------------------------------- #
EXAMPLES_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "examples_torch")
N_EXAMPLES = 19


def _run_example(name: str) -> tuple:
    """``examples_torch/<name> --quick`` in this process, on the card:
    ``(rc, output)``, the output captured (the subprocess of
    ``ac_serving.py`` writes to this process's own output)."""
    import contextlib
    import io
    import runpy
    import traceback

    old_argv, old_path = sys.argv, list(sys.path)
    sys.argv = [name, "--quick"]
    sys.path.insert(0, EXAMPLES_DIR)
    buf = io.StringIO()
    rc = 0
    try:
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(buf):
            runpy.run_path(os.path.join(EXAMPLES_DIR, name),
                           run_name="__main__")
    except SystemExit as e:
        rc = 0 if e.code in (None, 0) else (
            e.code if isinstance(e.code, int) else 1)
    except Exception:  # noqa: BLE001 - reported with its traceback
        rc = 1
        buf.write(traceback.format_exc())
    finally:
        sys.argv, sys.path = old_argv, old_path
        for mod in ("_common", "ac_baseline"):
            sys.modules.pop(mod, None)
    return rc, buf.getvalue()


def phase_examples(card: str) -> dict:
    """Phase 20: every ``examples_torch/`` script with ``--quick`` on the
    card, in this process; each must return 0."""
    import torch
    from tensordiffeq_tpu_torch.ops import cuda_taylor as ct

    scripts = sorted(f for f in os.listdir(EXAMPLES_DIR)
                     if f.endswith(".py") and not f.startswith("_"))
    if len(scripts) != N_EXAMPLES:
        fail(f"examples: {len(scripts)} scripts, want {N_EXAMPLES}")
    ct.reset_launch_counts()
    t_phase = time.perf_counter()
    walls = {}
    for name in scripts:
        t0 = time.perf_counter()
        rc, out = _run_example(name)
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        lines = [ln for ln in out.strip().splitlines() if ln.strip()]
        print(f"[example {name}] rc {rc}, {walls[name]:.1f} s: "
              f"{lines[-1][:160] if lines else ''}", flush=True)
        if rc != 0:
            print(out[-4000:], flush=True)
            fail(f"examples: {name} returned {rc}")
    launches = _counts_all()
    print(f"[examples] {len(scripts)} scripts, rc 0 each, wall "
          f"{time.perf_counter() - t_phase:.1f} s; launches "
          f"{_nonzero(launches)}; {card}", flush=True)
    return {"examples": dict(launches=launches)}


# --------------------------------------------------------------------- #
# phase 21: the serving fleet
# --------------------------------------------------------------------- #
# where the phase runs (a CPU rehearsal of the control flow sets "cpu")
FLEET_DEVICE = "cuda"
# (a) the JAX package's fleet benchmark (bench.py --mode fleet): 4 AC-SA
# tenants at full width (2-128x4-1, N_f = 50,000, trained FLEET_STEPS Adam
# steps each so the residuals are not trivial), ladder 256-4096, mixed
# u/residual traffic; t2 and t3 served with no f_model (the lowered tape)
FLEET_TENANTS, FLEET_STEPS = 4, 20
FLEET_LADDER = dict(min_bucket=256, max_bucket=4096)
FLEET_NO_F = ("t2", "t3")
FLEET_MAX_LOADED = 3  # four tenants: the traffic evicts
# 2,000 requests of 1-4,096 rows (log-uniform), 70 % u, in 10 segments of
# 200 over three tenants each (a rotating tenant sits a segment out, so
# each boundary evicts and reloads); every 10th request is a synchronous
# query, alone in its batch (the tenant flushed first), held to the
# direct engine bit for bit
FLEET_REQUESTS, FLEET_SEGMENTS, FLEET_SYNC_EVERY = 2_000, 10, 10
FLEET_U_SHARE = 0.7
# a batched answer against the direct engine: the same program at another
# rung of the ladder (a coalesced batch pads to its own rung), so float32
# rounding apart, not bit for bit
FLEET_CROSS_RUNG = 1e-5
FLEET_RATE, FLEET_BURST, FLEET_BURST_REQUESTS = 100.0, 10.0, 60
FLEET_CYCLES = 3  # evict-reload cycles of one tenant, its quarantine kept
FLEET_TIMEOUT_S = 300  # each process the phase starts
# (b) the JAX package's closed-loop benchmark (bench.py --mode
# closedloop): 4 Allen-Cahn members, theta_m = 0.0009 + 0.0002 m, N_f =
# 2,048, 2-64-64-1, 600 + 600 steps in chunks of 100, drift 0.8 in place;
# the retrain in supervisor chunks of 300, each fit in chunks of 100 with
# a pool redraw dispatched every 100 (two adopted, two discarded)
CL_M, CL_NF, CL_WIDTHS = 4, 2_048, [2, 64, 64, 1]
CL_STEPS, CL_CHUNK, CL_DRIFT = 600, 100, 0.8
CL_RETRAIN_CHUNK, CL_RESAMPLE = 300, 100
# (c) the JAX package's replicated-serving benchmark (bench.py --mode
# fleetha): 2 replica processes, ladder 64-128, 200 queries, rank 1 lost
# at its 50th request; the tenants with no f_model (the tape: a respawned
# replica's warm start then takes no generic program's first run)
HA_LADDER = dict(min_bucket=64, max_bucket=128)
HA_QUERIES, HA_LOSS_AT = 200, 50

HA_BOOT = '''\
"""Replica bootstrap of chip_smoke.py phase 21(c): the tenants with no
f_model (their residual from the artifacts' lowered tape)."""
from tensordiffeq_tpu_torch.fleet import FleetRouter, TenantPolicy

ART = {arts!r}


def make_router(device="cuda"):
    router = FleetRouter(max_loaded=4, device=device)
    for name, art in sorted(ART.items()):
        router.register(name, art, policy=TenantPolicy(
            min_bucket={min_b}, max_bucket={max_b}, max_batch=256,
            max_latency_s=0.005))
    return router
'''


def _fleet_f_model(u, x, t):
    """AC-SA's residual (``ac_sa_problem``'s), at module level: the fleet's
    child process and replicas re-attach it by name."""
    from tensordiffeq_tpu_torch import grad
    u_xx = grad(grad(u, "x"), "x")
    u_t = grad(u, "t")
    uv = u(x, t)
    return u_t(x, t) - 0.0001 * u_xx(x, t) + 5.0 * uv ** 3 - 5.0 * uv


def _sync():
    import torch
    if torch.device(FLEET_DEVICE).type == "cuda":
        torch.cuda.synchronize()


def _fleet_draw(rng, n: int) -> np.ndarray:
    return np.stack([rng.uniform(-1.0, 1.0, n), rng.uniform(0.0, 1.0, n)],
                    -1).astype(np.float32)


def _counter(reg, prefix: str, **labels) -> float:
    """The sum of a registry's counters named ``prefix`` whose labels
    include ``labels``."""
    total = 0.0
    for key, v in reg.as_dict()["counters"].items():
        name, _, rest = key.partition("{")
        if name != prefix:
            continue
        if all(f"{k}={val}" in rest for k, val in labels.items()):
            total += v
    return total


def _leaves_scaled(got, want) -> float:
    """Scale-relative max difference over an answer's arrays."""
    g = got if isinstance(got, tuple) else (got,)
    w = want if isinstance(want, tuple) else (want,)
    worst = 0.0
    for a, b in zip(g, w):
        a, b = np.asarray(a), np.asarray(b)
        worst = max(worst, float(np.abs(a - b).max())
                    / max(float(np.abs(b).max()), 1e-30))
    return worst


def _same_bits(a, b) -> bool:
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    return len(a) == len(b) and all(
        np.asarray(x).tobytes() == np.asarray(y).tobytes()
        for x, y in zip(a, b))


def fleet_child(work: str, out: str):
    """Phase 21(a) in a fresh process: the four artifacts under ``work``
    served by a ``FleetRouter`` (t2 and t3 with no f_model), every gate of
    (a) checked here (``fail`` exits non-zero), the figures written to
    ``out`` as JSON."""
    import threading
    import torch
    from tensordiffeq_tpu_torch import fleet, telemetry
    from tensordiffeq_tpu_torch.checkpoint import resolve_checkpoint_dir
    from tensordiffeq_tpu_torch.fleet.warmstart import TAPE_FILE
    from tensordiffeq_tpu_torch.ops import cuda_taylor as ct
    from tensordiffeq_tpu_torch.ops.fused import crosscheck_residuals
    from tensordiffeq_tpu_torch.resilience import Chaos
    from tensordiffeq_tpu_torch.serving import Surrogate
    from tensordiffeq_tpu_torch.telemetry import MetricsRegistry

    dev = torch.device(FLEET_DEVICE)
    if dev.type == "cuda":
        torch.cuda.init()
    marks = {"imports_and_cuda_init": _process_age()}
    ct.build()
    marks["kernel_library"] = _process_age()
    res = {"marks": marks}
    names = [f"t{i}" for i in range(FLEET_TENANTS)]
    arts = {t: os.path.join(work, t) for t in names}
    fm = {t: (None if t in FLEET_NO_F else _fleet_f_model) for t in names}
    reg = telemetry.default_registry()
    rng = np.random.RandomState(21)

    def compiles(r=reg):
        return _counter(r, "serving.engine.compiles")

    # cold: an engine that was not warm-started, its first query captures
    cold = Surrogate.load(arts["t0"], f_model=_fleet_f_model,
                          device=dev).engine(**FLEET_LADDER)
    Xc = _fleet_draw(rng, FLEET_LADDER["min_bucket"])
    _sync()
    t0 = time.perf_counter()
    cold.u(Xc)
    _sync()
    res["cold_first_query_ms"] = 1e3 * (time.perf_counter() - t0)
    cold.release()
    del cold

    policy = dict(max_batch=FLEET_LADDER["max_bucket"], max_latency_s=0.005,
                  **FLEET_LADDER)
    router = fleet.FleetRouter(max_loaded=FLEET_MAX_LOADED, registry=reg,
                               device=dev)
    for t in names:
        router.register(t, arts[t], f_model=fm[t],
                        policy=fleet.TenantPolicy(**policy))
    ladder = [FLEET_LADDER["min_bucket"] << i for i in range(
        (FLEET_LADDER["max_bucket"] // FLEET_LADDER["min_bucket"])
        .bit_length())]
    res["load_s"], res["warm"] = {}, {}
    for t in names:
        _sync()
        t0 = time.perf_counter()
        lt = router.load(t)
        _sync()
        res["load_s"][t] = time.perf_counter() - t0
        res["warm"][t] = {k: lt.warm[k] for k in ("aot", "jit", "failed")}
        want = ((len(ladder), len(ladder)) if t in FLEET_NO_F
                else (0, 2 * len(ladder)))
        caps = [r.graph.captures if r.graph.make_graph is not None else 1
                for r in lt.engine._rungs.values()]
        if (lt.warm["aot"], lt.warm["jit"]) != want or lt.warm["failed"] \
                or len(caps) != 2 * len(ladder) or set(caps) != {1}:
            fail(f"fleet: tenant {t} loaded with warm {lt.warm}, rung "
                 f"captures {caps} (want tape/own {want}, one capture a "
                 "rung)")
        if t == "t1":
            Xw = _fleet_draw(rng, FLEET_LADDER["min_bucket"])
            pre = compiles()
            _sync()
            t0 = time.perf_counter()
            router.query("t1", Xw)
            _sync()
            res["warm_first_query_ms"] = 1e3 * (time.perf_counter() - t0)
            if compiles() != pre:
                fail("fleet: the warm-started tenant captured at its first "
                     "query")
    print(f"[fleet] {FLEET_TENANTS} AC-SA tenants ({WIDTHS}), ladder "
          f"{ladder}, t2/t3 with no f_model; load wall per tenant "
          + ", ".join(f"{t} {s:.3f} s" for t, s in res["load_s"].items())
          + f"; warm {res['warm']}; every rung captured once at load; "
          f"first query cold {res['cold_first_query_ms']:.2f} ms (capture "
          f"included) against warm {res['warm_first_query_ms']:.3f} ms "
          f"({res['cold_first_query_ms'] / res['warm_first_query_ms']:.1f}"
          f"x); process marks {marks}", flush=True)

    # the referees: a direct engine per tenant over the same artifact,
    # loaded and warm-started alike, each with a registry of its own
    direct, dreg = {}, {}
    for t in names:
        dreg[t] = MetricsRegistry()
        eng = Surrogate.load(arts[t], f_model=fm[t], device=dev).engine(
            registry=dreg[t], **FLEET_LADDER)
        fleet.warm_start(eng, registry=dreg[t])
        direct[t] = eng

    # the tape against the generic program (the same artifact served with
    # its f_model), and K1 at the top rung against its plain flavor
    Xp = _fleet_draw(rng, FLEET_LADDER["max_bucket"])
    top = FLEET_LADDER["max_bucket"]
    saved = _counts_all()
    worst_tape = 0.0
    for t in FLEET_NO_F:
        gen = Surrogate.load(arts[t], f_model=_fleet_f_model,
                             device=dev).engine(**FLEET_LADDER)
        f_gen, f_tape = gen.residual(Xp), direct[t].residual(Xp)
        ok, why = crosscheck_residuals(f_gen, f_tape,
                                       rtol=SERVE_CROSSCHECK_RTOL)
        worst_tape = max(worst_tape, _leaves_scaled(f_tape, f_gen))
        if not ok:
            fail(f"fleet: {t}'s tape residual outside the cross-check "
                 f"band of its generic program: {why}")
        if t == FLEET_NO_F[0] and dev.type == "cuda":
            res["tape_rung_ms"] = cuda_ms(
                direct[t]._rungs[("residual", top)].graph)
            res["generic_rung_ms"] = cuda_ms(
                gen._rungs[("residual", top)].graph)
        gen.release()
    with open(os.path.join(resolve_checkpoint_dir(arts["t2"]),
                           TAPE_FILE)) as fh:
        blob = json.load(fh)
    sur2 = direct["t2"].surrogate
    tab = ct.build_cuda_table_fn({tuple(r) for r in blob["requests"]},
                                 [tuple(W.shape) for W, _ in sur2.params],
                                 device=dev)
    Xd = torch.from_numpy(Xp).to(dev)
    got = tab(sur2.params, Xd)
    plain = tab([(W.cpu(), b.cpu()) for W, b in sur2.params], Xd.cpu())
    k1_err = max(scaled_err(got[mi].cpu(), plain[mi])[1] for mi in plain)
    # through its wrapper, eagerly: the packing of the layers included
    res["k1_ms"] = (cuda_ms(lambda: tab(sur2.params, Xd))
                    if dev.type == "cuda" else None)
    _set_counts(saved)
    res["tape_vs_generic"] = worst_tape
    res["k1_scale_rel_err"] = k1_err
    print(f"[fleet tape] t2/t3's residual from the lowered tape against the "
          f"generic program (f_model attached) on {top} points: "
          f"{worst_tape:.3e} scale-relative (band rtol "
          f"{SERVE_CROSSCHECK_RTOL:g}); rung {top} replay: tape "
          f"{res.get('tape_rung_ms') or float('nan'):.3f} ms against generic "
          f"{res.get('generic_rung_ms') or float('nan'):.3f} ms; K1 at "
          f"{top} rows against its plain flavor {k1_err:.3e} (tol "
          f"{K1_RTOL:g}), {res['k1_ms'] or float('nan'):.3f} ms through "
          "its wrapper, eagerly (packing included)", flush=True)
    if not k1_err <= K1_RTOL:
        fail("fleet: K1 at the top rung disagrees with its plain flavor")

    # K1 once per tape-rung replay: one query at each rung
    ct.reset_launch_counts()
    for b in ladder:
        router.query("t2", _fleet_draw(rng, b), kind="residual")
    _sync()
    per_rung = _counts()
    if per_rung != {"k1": len(ladder), "k2": 0, "k3": 0}:
        fail(f"fleet: one tape query per rung launched {per_rung}")

    # the traffic: admission, batchers, evictions, reloads
    ct.reset_launch_counts()
    pre = {"compiles": compiles(),
           "warm": _counter(reg, "fleet.warmstart.programs"),
           "runs": sum(_counter(reg, "serving.engine.runs", tenant=t,
                                kind="residual") for t in FLEET_NO_F)
           + sum(_counter(dreg[t], "serving.engine.runs", kind="residual")
                 for t in FLEET_NO_F),
           "tape_caps": sum(_counter(reg, "serving.engine.compiles",
                                     tenant=t, kind="residual")
                            for t in FLEET_NO_F),
           "evictions": router.stats()["evictions"]}
    per_seg = FLEET_REQUESTS // FLEET_SEGMENTS
    handles, sync_bad, sync_n = [], 0, 0
    _sync()
    t0 = time.perf_counter()
    for seg in range(FLEET_SEGMENTS):
        active = [t for i, t in enumerate(names)
                  if i != seg % FLEET_TENANTS]
        for j in range(per_seg):
            i = seg * per_seg + j
            t = active[rng.randint(len(active))]
            n = int(min(FLEET_LADDER["max_bucket"], max(1, round(np.exp(
                rng.uniform(0.0, np.log(FLEET_LADDER["max_bucket"])))))))
            kind = "u" if rng.uniform() < FLEET_U_SHARE else "residual"
            X = _fleet_draw(rng, n)
            if i % FLEET_SYNC_EVERY == 0:
                # alone in its batch, so at the rung the direct engine takes
                router.flush(t)
                ans = router.query(t, X, kind=kind)
                sync_n += 1
                sync_bad += not _same_bits(
                    ans, direct[t].op_for(kind)(X))
            else:
                handles.append((t, kind, X, router.submit(t, X, kind=kind)))
                router.poll()
    router.flush()
    _sync()
    wall = time.perf_counter() - t0
    launches = _counts()
    stats = router.stats()
    request_caps = (compiles() - pre["compiles"]
                    - (_counter(reg, "fleet.warmstart.programs")
                       - pre["warm"]))
    tape_runs = (sum(_counter(reg, "serving.engine.runs", tenant=t,
                              kind="residual") for t in FLEET_NO_F)
                 + sum(_counter(dreg[t], "serving.engine.runs",
                                kind="residual") for t in FLEET_NO_F)
                 - pre["runs"])
    tape_caps = (sum(_counter(reg, "serving.engine.compiles", tenant=t,
                              kind="residual") for t in FLEET_NO_F)
                 - pre["tape_caps"])
    hung = sum(not h.done for _, _, _, h in handles)
    worst = 0.0
    for t, kind, X, h in handles:
        if h.done:
            worst = max(worst, _leaves_scaled(h.result(),
                                              direct[t].op_for(kind)(X)))
    want_k1 = tape_runs + 3 * tape_caps  # a capture's three warm-ups
    res.update(requests=FLEET_REQUESTS, wall_s=wall,
               qps=FLEET_REQUESTS / wall, request_time_captures=request_caps,
               evictions=stats["evictions"] - pre["evictions"],
               launches=launches, tape_runs=tape_runs, tape_captures=tape_caps,
               batched_worst=worst, sync_checked=sync_n)
    print(f"[fleet traffic] {FLEET_REQUESTS} requests (1-"
          f"{FLEET_LADDER['max_bucket']:,} rows, {FLEET_U_SHARE:.0%} u) over "
          f"{FLEET_TENANTS} tenants in {wall:.2f} s: {res['qps']:.1f} "
          f"requests/s (host-bound: batchers, admission, "
          f"{res['evictions']} evictions and their reloads included); "
          f"request-time captures {request_caps:g}; {sync_n} synchronous "
          f"answers bit for bit the direct engines ({sync_bad} differ); "
          f"batched answers within {worst:.3e} of them (band "
          f"{FLEET_CROSS_RUNG:g}); hung {hung}; launches {launches} (K1 "
          f"want {want_k1:g}: {tape_runs:g} tape-rung runs + 3 x "
          f"{tape_caps:g} captures' warm-ups)", flush=True)
    if request_caps != 0 or sync_bad or hung or not worst <= FLEET_CROSS_RUNG:
        fail("fleet: request-time captures, a differing answer or a hung "
             "waiter")
    if launches["k2"] or launches["k3"] or launches["k1"] != want_k1 \
            or res["evictions"] < FLEET_SEGMENTS - 1:
        fail(f"fleet: launches {launches}, K1 want {want_k1}, evictions "
             f"{res['evictions']}")

    # a rate-limit burst on one tenant: shed, none hung
    router.register("t0-burst", arts["t0"], f_model=_fleet_f_model,
                    policy=fleet.TenantPolicy(rate_qps=FLEET_RATE,
                                              burst=FLEET_BURST, **policy))
    shed, admitted = [], []
    for _ in range(FLEET_BURST_REQUESTS):
        try:
            admitted.append(router.submit("t0-burst", _fleet_draw(
                rng, int(rng.randint(1, 17)))))
        except fleet.AdmissionRejected as e:
            shed.append(e.reason)
    router.flush()
    print(f"[fleet admission] a burst of {FLEET_BURST_REQUESTS} on one "
          f"tenant at {FLEET_RATE:g}/s (burst {FLEET_BURST:g}): "
          f"{len(shed)} shed as AdmissionRejected ({sorted(set(shed))}), "
          f"{len(admitted)} admitted, "
          f"{sum(not h.done for h in admitted)} hung", flush=True)
    if not shed or set(shed) != {"rate_limit"} \
            or not all(h.done for h in admitted):
        fail("fleet: the burst was not shed as rate_limit, or a waiter hung")

    # one tenant cycled through eviction and reload, its quarantine kept
    dead = ladder[1]
    router.evict("t1")
    with Chaos(compile_fail_buckets=(dead,)):
        lt = router.load("t1")
    quarantined = lt.engine.quarantined_buckets()
    Xq = _fleet_draw(rng, dead - 10)  # routes past the dead rung
    first = router.query("t1", Xq)
    cycles = []
    for _ in range(FLEET_CYCLES):
        router.evict("t1")
        lt = router.load("t1")
        caps = sum(r.graph.captures if r.graph.make_graph is not None else 1
                   for r in lt.engine._rungs.values())
        cycles.append((lt.engine.quarantined_buckets() == quarantined, caps,
                       _same_bits(router.query("t1", Xq), first)))
    print(f"[fleet evict-reload] t1 quarantined {quarantined} at a chaos "
          f"load, then {FLEET_CYCLES} evict-reload cycles: (quarantine "
          f"kept, rungs captured again, answer bit for bit) {cycles}",
          flush=True)
    if quarantined != {"u": [dead], "residual": [dead]} or any(
            c != (True, 2 * len(ladder) - 2, True) for c in cycles):
        fail("fleet: an evict-reload cycle lost the quarantine or did not "
             "capture again")

    # a hot swap while another thread queries the same router
    Xh = _fleet_draw(rng, 1000)
    want = {_fleet_bytes(direct[a].op_for(k)(Xh)) for a in ("t0", "t1")
            for k in ("u", "residual")}
    stop, errs, seen = threading.Event(), [], []

    def hammer():
        i = 0
        try:
            while not stop.is_set():
                kind = ("u", "residual")[i % 2]
                seen.append(_fleet_bytes(router.query("t0", Xh, kind=kind)))
                i += 1
        except Exception as e:  # noqa: BLE001 - reported below
            errs.append(f"{type(e).__name__}: {e}")

    router.load("t0")
    th = threading.Thread(target=hammer, daemon=True)
    th.start()
    verdicts = []
    try:
        for art in (arts["t1"], arts["t0"]):
            v = router.hot_swap("t0", art, f_model=_fleet_f_model,
                                probe_X=_fleet_draw(rng, 256),
                                gate=float("inf"))
            verdicts.append((v["swapped"], round(v.get("cutover_stall_s",
                                                       -1), 6)))
    finally:
        stop.set()
        th.join(timeout=120.0)
    print(f"[fleet swap] two hot swaps of t0 beside a querying thread: "
          f"(swapped, cutover stall s) {verdicts}; {len(seen)} answers "
          f"during them, each one of the two artifacts' own bit for bit: "
          f"{set(seen) <= want}; errors {errs}; pending "
          f"{router.pending_points()}", flush=True)
    if th.is_alive() or errs or not seen or not set(seen) <= want \
            or not all(s for s, _ in verdicts) or router.pending_points():
        fail("fleet: a swap beside live queries failed")
    with open(out, "w") as fh:
        json.dump(res, fh)


def _fleet_bytes(ans) -> bytes:
    return b"".join(np.asarray(a).tobytes() for a in (
        ans if isinstance(ans, tuple) else (ans,)))


def _fleet_train(work: str) -> dict:
    """Phase 21(a)'s training side: four AC-SA tenants at full width,
    FLEET_STEPS Adam steps each, exported at the ladder 256-4096 (and at
    (c)'s 64-128 for the replicas)."""
    import tensordiffeq_tpu_torch as tdqt
    from tensordiffeq_tpu_torch import fleet

    walls = []
    for i in range(FLEET_TENANTS):
        t0 = time.perf_counter()
        domain, bcs, f_model, kw = ac_sa_problem(seed=i)
        s = tdqt.CollocationSolverND(verbose=False, seed=i,
                                     device=FLEET_DEVICE)
        s.compile(WIDTHS, f_model, domain, bcs, fused="cuda", **kw)
        s.fit(tf_iter=FLEET_STEPS, chunk=FLEET_STEPS)
        sur = s.export_surrogate()
        fleet.export_fleet_artifact(sur, os.path.join(work, f"t{i}"),
                                    **FLEET_LADDER)
        if i < 2:
            fleet.export_fleet_artifact(sur, os.path.join(work, f"ha{i}"),
                                        **HA_LADDER)
        walls.append(time.perf_counter() - t0)
    return {"train_export_s": walls}


def _release_card(tag: str):
    """Before a child process starts on the same card: collect the dead
    solvers' reference cycles and return PyTorch's cached, unused device
    blocks to the driver (the caching allocator keeps what every earlier
    phase freed, and a child that finds the card full fails with an
    out-of-memory error); prints the memory the parent holds."""
    import gc
    import torch
    gc.collect()
    before = torch.cuda.memory_reserved()
    torch.cuda.empty_cache()
    print(f"[{tag}] before the child processes: allocated "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB, reserved "
          f"{before / 2 ** 30:.2f} -> {torch.cuda.memory_reserved() / 2 ** 30:.2f}"
          f" GiB", flush=True)


def _fleet_serving(work: str, card: str) -> dict:
    """Phase 21(a): the child process (``--fleet-child``)."""
    out = os.path.join(work, "fleet_child.json")
    env = {k: v for k, v in os.environ.items()
           if k not in ("LOCAL_RANK", "RANK", "WORLD_SIZE", "TDQ_CHAOS")}
    _release_card("fleet")
    t0 = time.perf_counter()
    try:
        p = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--fleet-child", work, out], env=env,
                           timeout=FLEET_TIMEOUT_S)
        rc = p.returncode
    except subprocess.TimeoutExpired:
        rc = None
    wall = time.perf_counter() - t0
    if rc != 0 or not os.path.exists(out):
        fail(f"fleet: the serving child returned {rc} after {wall:.1f} s")
    with open(out) as fh:
        res = json.load(fh)
    res["child_wall_s"] = wall
    print(f"[fleet] serving child: {wall:.1f} s; {card}", flush=True)
    return res


def _cl_problem():
    import tensordiffeq_tpu_torch as tdqt
    from tensordiffeq_tpu_torch import grad

    domain = tdqt.DomainND(["x", "t"], time_var="t")
    domain.add("x", [-1.0, 1.0], 512)
    domain.add("t", [0.0, 1.0], 201)
    domain.generate_collocation_points(CL_NF, seed=0)

    def deriv_model(u, x, t):
        return u(x, t), grad(u, "x")(x, t)

    bcs = [tdqt.IC(domain, [lambda x: x ** 2 * np.cos(np.pi * x)],
                   var=[["x"]]),
           tdqt.periodicBC(domain, ["x"], [deriv_model])]
    return domain, bcs


def _closedloop(work: str, card: str) -> dict:
    """Phase 21(b): the JAX package's closed-loop benchmark on the card."""
    import torch
    from tensordiffeq_tpu_torch import fleet, telemetry
    from tensordiffeq_tpu_torch.factory import SurrogateFactory
    from tensordiffeq_tpu_torch.ops import cuda_taylor as ct

    thetas = [0.0009 + 0.0002 * m for m in range(CL_M)]
    domain, bcs = _cl_problem()
    made = []

    def build_factory(init_params=None):
        fac = SurrogateFactory(CL_WIDTHS, _fac_f_model, domain, bcs, thetas,
                               init_params=init_params, fused="cuda",
                               verbose=False, device=FLEET_DEVICE)
        _sync()
        made.append((fac, _fac_counts()))
        return fac

    reg = telemetry.default_registry()
    rng = np.random.RandomState(4)
    t0 = time.perf_counter()
    factory = build_factory()
    factory.fit(tf_iter=CL_STEPS, chunk=CL_CHUNK)
    v1 = os.path.join(work, "cl_v1")
    factory.export_family(v1, **FLEET_LADDER)
    pre_s = time.perf_counter() - t0
    router = fleet.FleetRouter(max_loaded=CL_M + 1, device=FLEET_DEVICE)
    policy = fleet.TenantPolicy(max_batch=1024, max_latency_s=0.005,
                                **FLEET_LADDER)
    members = router.register_family(
        v1, policy=policy, prefix="m",
        f_models={m: factory.member_f_model(m) for m in range(CL_M)})
    monitor = fleet.DriftMonitor(router, sample_fraction=0.5, window=2,
                                 seed=0)
    probe = _fleet_draw(rng, FLEET_LADDER["min_bucket"])
    for t in members.values():
        router.load(t)
        monitor.attach(t, probe)

    def compiles():
        return _counter(reg, "serving.engine.compiles")

    def probe_residual():
        return float(np.mean([np.mean(np.abs(np.asarray(
            router.load(t).engine.residual(probe))))
            for t in members.values()]))

    # drift: every tenant's served tensors scaled in place
    pre_drift = compiles()
    with torch.no_grad():
        for t in members.values():
            for W, b in router.load(t).surrogate.params:
                W.mul_(1.0 + CL_DRIFT)
                b.mul_(1.0 + CL_DRIFT)
    drifted = probe_residual()
    t0 = time.perf_counter()
    queries = 0
    while not monitor.tripped() and queries < 500:
        monitor.query(list(members.values())[queries % CL_M],
                      _fleet_draw(rng, int(rng.randint(1, 33))))
        queries += 1
    detect_s = time.perf_counter() - t0
    drift_caps = compiles() - pre_drift
    controller = fleet.RetrainController(
        router, monitor, build_factory, members, retrain_iters=CL_STEPS,
        chunk=CL_RETRAIN_CHUNK, fit_chunk=CL_CHUNK,
        resample_every=CL_RESAMPLE, gate_ratio=10.0,
        export_kw=dict(FLEET_LADDER), workdir=work)
    ct.reset_launch_counts()
    pre = compiles()
    cycle = controller.run_cycle()
    _sync()
    fac, at_build = made[-1]
    launches = _fac_counts()
    in_fit = {k: launches[k] - at_build[k] for k in launches}
    cycle_caps = compiles() - pre
    warm_caps = sum(v["warm"]["aot"] + v["warm"]["jit"]
                    for v in cycle["swapped"] + cycle["rolled_back"]
                    if "warm" in v)
    post = probe_residual()
    pre2 = compiles()
    for t in members.values():
        router.query(t, _fleet_draw(rng, 16))
        router.query(t, _fleet_draw(rng, 16), kind="residual")
    after_caps = compiles() - pre2
    stalls = sorted(v["cutover_stall_s"] for v in cycle["swapped"])
    n_rd = len(fac.redraws)
    caps = fac._step.graph.captures if fac._step.graph.make_graph else 1
    res = dict(queries_to_trip=queries, detect_s=detect_s,
               retrain_s=cycle["retrain_wall_s"],
               stall_p50_s=stalls[len(stalls) // 2] if stalls else None,
               mttr_s=detect_s + cycle["retrain_wall_s"] + sum(stalls),
               drifted=drifted, post=post, launches=launches,
               redraws=n_rd, pre_s=pre_s)
    print(f"[closedloop] {CL_M} members ({CL_WIDTHS}, N_f={CL_NF:,}, theta "
          f"{thetas[0]:g}..{thetas[-1]:g}), {CL_STEPS} steps and export in "
          f"{pre_s:.1f} s; drift {CL_DRIFT:g} in place (captures "
          f"{drift_caps:g}); tripped after {queries} queries in "
          f"{detect_s:.3f} s; retrain {cycle['retrain_wall_s']:.2f} s "
          f"({cycle['retrain_epochs']} steps, {n_rd} redraws: "
          f"{[r['adopted'] for r in fac.redraws]}); launches in the retrain's "
          f"fit {in_fit} (the member-axis K3 want {CL_STEPS}, K1 want "
          f"{CL_M * n_rd}); family step captures {caps}; swapped "
          f"{len(cycle['swapped'])}/{CL_M}, cutover stall p50 "
          f"{1e3 * (res['stall_p50_s'] or float('nan')):.3f} ms; probe "
          f"residual {drifted:.4e} drifted -> {post:.4e}; captures in the "
          f"cycle {cycle_caps:g} (the candidates' warm starts "
          f"{warm_caps}), after it {after_caps:g}; MTTR "
          f"{res['mttr_s']:.2f} s; {card}", flush=True)
    if in_fit != {"k1": CL_M * n_rd, "k2": 0, "k3": 0, "k3f": CL_STEPS} \
            or caps != 1 or n_rd < 2:
        fail(f"closedloop: launches in the retrain {in_fit}, family step "
             f"captures {caps}, redraws {n_rd}")
    if len(cycle["swapped"]) != CL_M or not post < drifted \
            or drift_caps or after_caps or cycle_caps != warm_caps:
        fail("closedloop: a tenant not swapped, the residual not healed, or "
             "a request-time capture")
    return {"closedloop": dict(launches=launches), **res}


def _ha_reference(work: str) -> tuple:
    """Phase 21(c)'s queries and the answers of direct engines over the
    replicas' artifacts, computed before any other part of the phase runs
    beside the replicas (their captures would share this process)."""
    from tensordiffeq_tpu_torch import fleet
    from tensordiffeq_tpu_torch.serving import Surrogate
    from tensordiffeq_tpu_torch.telemetry import MetricsRegistry

    rng = np.random.RandomState(50)
    engines = {}
    for i in range(2):
        eng = Surrogate.load(os.path.join(work, f"ha{i}"),
                             device=FLEET_DEVICE).engine(
            registry=MetricsRegistry(), **HA_LADDER)
        fleet.warm_start(eng, registry=MetricsRegistry())
        engines[f"ha{i}"] = eng
    queries = []
    for i in range(HA_QUERIES):
        t = f"ha{i % 2}"
        kind = "u" if i % 3 else "residual"
        X = _fleet_draw(rng, int(rng.randint(1, 129)))
        queries.append((t, kind, X, _fleet_bytes(engines[t].op_for(kind)(X))))
    for eng in engines.values():
        eng.release()
    return queries


def _ha_run(work: str, queries: list, out: dict):
    """Phase 21(c), run in a thread beside (b): a ``ReplicaGroup`` of two
    replica processes on the card under host loss; only HTTP and numpy
    here (never ``fail``: the main thread checks ``out``)."""
    from tensordiffeq_tpu_torch.fleet import FrontRouter, ReplicaGroup
    from tensordiffeq_tpu_torch.telemetry import MetricsRegistry
    from tensordiffeq_tpu_torch.telemetry.collector import SNAPSHOT_FILE

    boot = os.path.join(work, "ha_boot")
    os.makedirs(boot, exist_ok=True)
    with open(os.path.join(boot, "tdqt_fleet_boot.py"), "w") as fh:
        fh.write(HA_BOOT.format(
            arts={f"ha{i}": os.path.join(work, f"ha{i}") for i in range(2)},
            min_b=HA_LADDER["min_bucket"], max_b=HA_LADDER["max_bucket"]))
    root = os.path.dirname(os.path.abspath(__file__))
    env = {"PYTHONPATH": os.pathsep.join([boot, root]),
           "TDQ_CHAOS": f"host_loss_at={HA_LOSS_AT},host_loss_rank=1"}

    def live_caps(run_dir):
        try:
            with open(os.path.join(run_dir, SNAPSHOT_FILE)) as fh:
                snap = json.load(fh)
        except (OSError, ValueError):
            return None
        return sum(v for k, v in snap["metrics"]["counters"].items()
                   if k.startswith("serving.engine.compiles"))

    t0 = time.perf_counter()
    g = ReplicaGroup("tdqt_fleet_boot:make_router", nproc=2,
                     workdir=os.path.join(work, "replicas"),
                     heartbeat_timeout_s=180.0, max_relaunches=1, env=env,
                     registry=MetricsRegistry(), device=FLEET_DEVICE)
    try:
        g.start(timeout_s=FLEET_TIMEOUT_S)
        ready = g.wait_ready(timeout_s=FLEET_TIMEOUT_S)
        out["ready_s"] = time.perf_counter() - t0
        out["warm_at_ready"] = {n: sorted(b["tenants"])
                                for n, b in ready.items()}
        survivor = os.path.join(g.workdir, "replica0.gen0")
        deadline = time.perf_counter() + 60.0
        base = None
        while base is None and time.perf_counter() < deadline:
            base = live_caps(survivor)
            time.sleep(0.1)
        front = FrontRouter(g.endpoints(), deadline_s=60.0,
                            breaker_reset_timeout_s=1.0,
                            registry=MetricsRegistry())
        lat, bad, lost, avail = [], 0, 0, 1.0
        for t, kind, X, want in queries:
            q0 = time.perf_counter()
            try:
                got = front.query(t, X, kind=kind)
            except Exception:  # noqa: BLE001 - a lost request is counted
                lost += 1
                continue
            lat.append(time.perf_counter() - q0)
            bad += _fleet_bytes(got) != want
            avail = min(avail, front.availability())
        out.update(lost=lost, differ=bad, availability_min=avail,
                   p50_ms=1e3 * float(np.percentile(lat, 50)),
                   p99_ms=1e3 * float(np.percentile(lat, 99)),
                   primary={t: front.candidates(t)[0]
                            for t in ("ha0", "ha1")})
        time.sleep(1.0)  # one beat: the survivor's snapshot catches up
        after = live_caps(survivor)
        out["survivor_captures"] = (None if base is None or after is None
                                    else after - base)
        ready = g.wait_ready(timeout_s=FLEET_TIMEOUT_S)
        out["warm_after"] = {n: sorted(b["tenants"])
                             for n, b in ready.items()}
        out["endpoints"] = g.endpoints()
        front.close()
    except Exception as e:  # noqa: BLE001 - checked by the main thread
        out["error"] = f"{type(e).__name__}: {e}"
    finally:
        try:
            result = g.shutdown(timeout_s=120.0)
            out.update(hosts_lost=getattr(result, "hosts_lost", None),
                       relaunches=getattr(result, "relaunches", None),
                       respawn_s=list(getattr(result, "recovery_wall_s",
                                              []) or []),
                       ok=getattr(result, "ok", None))
        except Exception as e:  # noqa: BLE001
            out["shutdown_error"] = f"{type(e).__name__}: {e}"
    out["wall_s"] = time.perf_counter() - t0


def phase_fleet(card: str) -> dict:
    """Phase 21 (module docstring)."""
    import shutil
    import tempfile
    import threading
    from tensordiffeq_tpu_torch.ops import cuda_taylor as ct

    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="tdq_fleet_")
    try:
        saved = _counts_all()
        trained = _fleet_train(work)
        _set_counts(saved)
        print(f"[fleet] {FLEET_TENANTS} tenants trained {FLEET_STEPS} steps "
              f"and exported: "
              f"{[round(s, 2) for s in trained['train_export_s']]} s",
              flush=True)
        paths = {}
        # (a) alone, so its figures are not shared with (b) and (c)
        res_a = _fleet_serving(work, card)
        paths["fleet-residual"] = dict(launches=res_a["launches"])
        # (c) beside (b): its reference answers first, then the replicas
        saved = _counts_all()
        queries = _ha_reference(work)
        _set_counts(saved)
        ha: dict = {}
        _release_card("fleetha")
        th = threading.Thread(target=_ha_run, args=(work, queries, ha),
                              daemon=True)
        th.start()
        ct.reset_launch_counts()
        res_b = _closedloop(work, card)
        paths["closedloop"] = {"launches": res_b["launches"]}
        th.join(timeout=FLEET_TIMEOUT_S + 180)
        print(f"[fleetha] 2 replica processes on the one card (not a "
              f"scaling figure: two processes share one card), ladder "
              f"{HA_LADDER}, {HA_QUERIES} queries through a FrontRouter, "
              f"rank 1 lost at its {HA_LOSS_AT}th request: lost "
              f"{ha.get('lost')}, answers differing from direct engines "
              f"{ha.get('differ')}, availability min "
              f"{ha.get('availability_min')}, p50 "
              f"{ha.get('p50_ms', float('nan')):.3f} ms, p99 "
              f"{ha.get('p99_ms', float('nan')):.3f} ms across the "
              f"incident; survivor request-time captures "
              f"{ha.get('survivor_captures')}; respawn wall "
              f"{ha.get('respawn_s')} s; hosts lost {ha.get('hosts_lost')}, "
              f"relaunches {ha.get('relaunches')}; warm at ready "
              f"{ha.get('warm_at_ready')}, after the respawn "
              f"{ha.get('warm_after')}; group ready in "
              f"{ha.get('ready_s', float('nan')):.1f} s, wall "
              f"{ha.get('wall_s', float('nan')):.1f} s; {card}", flush=True)
        warm = {f"replica{i}": ["ha0", "ha1"] for i in range(2)}
        if th.is_alive() or ha.get("error") or ha.get("shutdown_error") \
                or ha.get("lost") != 0 or ha.get("differ") != 0 \
                or ha.get("survivor_captures") != 0 \
                or ha.get("hosts_lost") != 1 or ha.get("relaunches") != 1 \
                or ha.get("warm_at_ready") != warm \
                or ha.get("warm_after") != warm or not ha.get("ok"):
            fail(f"fleetha: {ha}")
        print(f"[fleet] phase wall {time.perf_counter() - t_phase:.1f} s",
              flush=True)
        return paths
    finally:
        shutil.rmtree(work, ignore_errors=True)

# phase 22, the audit: the serving rungs' bucket, the counted chunk's steps,
# the line-search iterations whose syncs are counted, and the phase's budget
AUDIT_BUCKET = 4_096
AUDIT_CHUNK = 50
AUDIT_LBFGS = 10
AUDIT_WALL_S = 30.0
# each audited graph's kernel launches per replay: the wrappers the step
# must launch, by counter key
AUDIT_EXPECT = {"minimax": {"k3": 1}, "unfused": {"k1": 1, "k2": 1},
                "lbfgs-evaluator": {"k3": 1}, "serve-u": {},
                "serve-residual": {}, "tape-residual": {"k1": 1},
                "family": {"k3f": 1}}


def _audit_gate(tag: str, rep, expect: dict):
    """A graph's gates: no memcpy node across the host boundary, no host
    node, the launches per replay the step must make, the twin's launches
    those of the graph that replays, and each f32 wrapper's kernel nodes
    equal to its launches."""
    print(f"[audit graph {tag}] {rep.line()}", flush=True)
    if any(d != "DtoD" for d in rep.memcpy) or rep.host:
        fail(f"audit {tag}: memcpy {rep.memcpy}, host nodes {rep.host}")
    if rep.launches != expect or rep.captured != rep.launches:
        fail(f"audit {tag}: launches per replay {rep.launches} (the "
             f"twin's {rep.captured}), expected {expect}")
    # a main kernel's nodes are its wrappers' launches (K3's wgmma kernel:
    # k3 and the member axis's k3f)
    nodes = {k: rep.kernel_nodes(k) for k in ("k1", "k2", "k3")}
    if any(nodes[k] != rep.node_launches(k) for k in nodes):
        fail(f"audit {tag}: kernel nodes {nodes} against launches "
             f"{rep.launches}")


def phase_audit(card: str) -> dict:
    """Phase 22: static analysis on the port (module docstring)."""
    import torch
    from tensordiffeq_tpu_torch.analysis import run_analysis
    from tensordiffeq_tpu_torch.analysis import dispatch_audit as da
    from tensordiffeq_tpu_torch.factory import SurrogateFactory
    from tensordiffeq_tpu_torch.fleet.warmstart import _lower, _tape_program
    from tensordiffeq_tpu_torch.serving import Surrogate
    from tensordiffeq_tpu_torch.training import graphs
    from tensordiffeq_tpu_torch.training import lbfgs as lb

    t0 = time.perf_counter()
    # (a) the AST pass over the checkout, in this process
    findings, modules = run_analysis()
    allows = sum(len(m.suppressions) for m in modules)
    print(f"[audit lint] {len(modules)} files, {len(findings)} findings, "
          f"{allows} reasoned allows ({time.perf_counter() - t0:.2f} s)",
          flush=True)
    if findings:
        fail("tdqlint-torch findings:\n" + "\n".join(
            f.format() for f in findings))

    # (b) the steps at full width, each captured, then its debug twin read
    saved = _counts_all()
    _set_counts({k: 0 for k in saved})
    mm = _fresh_solver(minimax=None)
    un = _fresh_solver(minimax=False)
    for s in (mm, un):
        s.fit(tf_iter=AUDIT_CHUNK, chunk=AUDIT_CHUNK)
    syncs = {"minimax": da.chunk_syncs(mm._adam, AUDIT_CHUNK),
             "unfused": da.chunk_syncs(un._adam, AUDIT_CHUNK)}
    n_ls, declared = da.lbfgs_syncs(mm, AUDIT_LBFGS)
    print(f"[audit syncs] a {AUDIT_CHUNK}-step chunk: minimax "
          f"{syncs['minimax']}, unfused {syncs['unfused']} (declared 1: "
          f"the history read); {AUDIT_LBFGS} line-search iterations: "
          f"{n_ls} (declared {declared}: lbfgs_minimize.host_syncs)",
          flush=True)
    if syncs != {"minimax": 1, "unfused": 1} or n_ls != declared:
        fail(f"audit: undeclared syncs {syncs}, L-BFGS {n_ls} vs {declared}")

    reports = {}

    def audit(tag, graph):
        reports[tag] = rep = da.audit_graph(graph)
        _audit_gate(tag, rep, AUDIT_EXPECT[tag])

    audit("minimax", mm._adam.graph)
    audit("unfused", un._adam.graph)
    params = mm.net.params()
    fun = lb.lbfgs_objective(mm.loss_fn, mm.lambdas, mm.X_f,
                             lb.layer_shapes(params))
    x = lb.flatten_layers(params)
    with lb.matmul_precision(mm.precision):
        ev = lb._Evaluator(fun, x)
        ev.aim(x)
        for _ in range(graphs.WARMUP_RUNS + 1):
            ev()
        audit("lbfgs-evaluator", ev.graph)

    rng = np.random.RandomState(22)
    X = (rng.rand(AUDIT_BUCKET, 2) * [2.0, 1.0] - [1.0, 0.0]).astype(
        np.float32)
    sur = mm.export_surrogate()
    eng = sur.engine(min_bucket=AUDIT_BUCKET, max_bucket=AUDIT_BUCKET)
    for kind in ("u", "residual"):
        eng.op_for(kind)(X)
        audit(f"serve-{kind}",
              eng._rungs[(eng.kind_key(kind), AUDIT_BUCKET)].graph)
    bare = Surrogate(sur.net, sur.params, sur.varnames, sur.n_out)
    tape = bare.engine(min_bucket=AUDIT_BUCKET, max_bucket=AUDIT_BUCKET)
    tape.install_program("residual", AUDIT_BUCKET,
                         _tape_program(bare, _lower(sur)))
    tape.residual(X)
    audit("tape-residual",
          tape._rungs[(tape.kind_key("residual"), AUDIT_BUCKET)].graph)

    domain, bcs = _cl_problem()
    fac = SurrogateFactory(CL_WIDTHS, _fac_f_model, domain, bcs,
                           [0.0009 + 0.0002 * m for m in range(CL_M)],
                           fused="cuda", verbose=False)
    fac.fit(tf_iter=5, chunk=5)
    audit("family", fac._step.graph)
    torch.cuda.synchronize()
    launches = _counts_all()
    _set_counts({k: saved[k] + launches[k] for k in saved})
    if not (launches["k1"] and launches["k2"] and launches["k3"]):
        fail(f"audit: the phase's steps launched {launches}")

    # the negative control: a D2H copy into pinned memory, planted in a
    # captured toy step, must be flagged
    dev = torch.device("cuda", 0)
    a = torch.ones(1024, device=dev)
    b = torch.empty_like(a)
    pinned = torch.empty(1024, pin_memory=True)

    def planted():
        b.copy_(a * 2.0)
        pinned.copy_(b, non_blocking=True)

    toy = graphs.StepGraph(planted, lambda: [a, b, pinned], dev,
                           "planted toy step")
    toy.prime()
    rep = da.audit_graph(toy)
    print(f"[audit planted] {rep.line()}: "
          f"{'flagged' if not rep.ok else 'NOT FLAGGED'}", flush=True)
    if rep.ok or rep.memcpy.get("DtoH") != 1:
        fail("audit: the planted device-to-host copy was not flagged")
    wall = time.perf_counter() - t0
    print(f"[audit] {len(reports)} graphs, nodes "
          f"{ {t: r.nodes for t, r in reports.items()} }, phase wall "
          f"{wall:.1f} s ({card})", flush=True)
    if wall > AUDIT_WALL_S:
        fail(f"audit: phase wall {wall:.1f} s over {AUDIT_WALL_S} s")
    return {"audit": {"launches": launches}}


def kernels_line(meas: dict, paths: dict) -> str:
    """``launches`` sums a kernel's launches over the runs of every path
    (``launches_by_path`` splits them: minimax, unfused, lbfgs, the wide
    paths wide, wide-lbfgs and wide-unfused and their TF32 twins
    wide-tf32, wide-tf32-lbfgs and wide-tf32-unfused, pool, ascent,
    discovery, phase 13's autotune, schedules, ntk, causal, remat,
    families, phase 14's minimax-bf16, lbfgs-bf16, unfused-bf16,
    serve-bf16, phase 15's zoo, phase 16's tf32-minimax, tf32-lbfgs,
    tf32-unfused, custom, custom-lbfgs, knob-sin and knob-bf16, phase
    17's dist-w1, dist-w1-unfused, dist-w1-bf16, dist-w1-causal,
    dist-w1-ntk and dist-w2, phase 18's resilience, resilience-off,
    resilience-resume, resilience-serve and resilience-cluster, the last
    the relaunched worker's, phase 19's factory-1, factory, factory-pool
    and factory-ascent (``k3f``, the member-axis K3, on these and on the
    closed loop's and the audit's family step), phase 20's examples, and
    phase 21's
    fleet-residual, the fleet's traffic in its serving process,
    closedloop, the closed loop's retrain, and phase 22's audit, its
    steps at full width)."""
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
             "csrc/wg_backward.cuh", "pallas_taylor.py:171"),
            ("k3_tf32", "minimax_step tf32 (K3-TF32)",
             "csrc/wg_backward.cuh", "pallas_minimax.py:259"),
            ("k3f", "minimax_step member axis (K3 over a family's members)",
             "csrc/wg_backward.cuh", "pallas_minimax.py:259")):
        m = meas[key]
        by_path = {tag: int(res["launches"].get(key, 0))
                   for tag, res in paths.items()}
        if key[:2] in ("k2", "k3") and "route" in m:
            # K2's and K3's route at the slice's shape (f32 and TF32)
            source = ROUTE_SOURCES[(key[:2], m["route"])]
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
            **({"k1_route": m["route"]}
               if "route" in m and key.startswith("k1") else {}),
            # K2's and K3's route at the slice's shape (the wgmma route of
            # csrc/wg_backward.cuh; "k2_route"/"k3_route" for the f32 and
            # bf16 flavors, "tf32_route" for the TF32 one), their mma.sync
            # kernels at WIDE_WIDTHS (held and timed in phases 3-5, 14 and
            # 16(a); in the f32 and TF32 flavors in turns with the NP = 256
            # design that replaced them there; no main path takes them; the
            # bf16 flavor's route there, with its products' torch.matmul
            # time at 256), and the flavor's products' torch.matmul time
            # (the yardstick)
            **({("tf32_route" if key.endswith("tf32") else
                 f"{key[:2]}_route"): m["route"],
                "yardstick_ms": m.get("yardstick_ms"),
                "old_route": {
                    "route": m["old_route"]["route"],
                    "source": "tensordiffeq_tpu_torch/" + ROUTE_SOURCES[
                        (key[:2], m["old_route"]["route"])],
                    "widths": WIDE_WIDTHS,
                    "max_abs_err": m["old_route"]["max_abs_err"],
                    "ms": m["old_route"]["ms"],
                    "plain_ms": m["old_route"]["plain_ms"],
                    "bound_ms": m["old_route"]["bound"]["ms"],
                    "bound_by": m["old_route"]["bound"]["by"],
                    **({"yardstick_ms": m["old_route"]["yardstick_ms"]}
                       if "yardstick_ms" in m["old_route"] else {})}}
               if "old_route" in m else {}),
            # the f32 and TF32 kernels at WIDE_WIDTHS (phases 3-5, 16(a)):
            # K1's kernel beside K2 (csrc/taylor_table.cu), K2's and K3's
            # NP = 256 design (csrc/wg_backward_wide.cuh; the wide paths
            # take it) with its products' torch.matmul time
            **({"wide_route": {
                "source": "tensordiffeq_tpu_torch/"
                          + WIDE_ROUTE_SOURCES[key[:2]],
                "widths": WIDE_WIDTHS,
                "max_abs_err": m["wide"]["max_abs_err"],
                "ms": m["wide"]["ms"], "plain_ms": m["wide"]["plain_ms"],
                "bound_ms": m["wide"]["bound"]["ms"],
                "bound_by": m["wide"]["bound"]["by"],
                **({"route": m["wide"]["route"],
                    "yardstick_ms": m["wide"].get("yardstick_ms")}
                   if key[:2] in ("k2", "k3") else {})}}
               if "wide" in m else {}),
            # the member-axis K3 (phase 19(b), the factory's 64 members):
            # the members' single launches in the same call, and the
            # family's products as torch.bmm (the yardstick)
            **({"members": m["members"], "singles_ms": m["singles_ms"],
                "yardstick_ms": m["yardstick_ms"],
                "scale_rel_err": m["scale_rel_err"]}
               if key == "k3f" else {}),
            # no single PyTorch call computes the Taylor table or the
            # fused minimax step
            "library_ms": None})
    # the member-axis K3's bf16 and TF32 flavors: the same kernel as
    # K3-bf16 / K3-TF32 with a member axis; no entry point trains a bf16 or
    # TF32 family, so they are held and timed in phase 19(b) at the
    # factory's tensors and reported beside their single-network flavor
    by_name = {e["name"]: e for e in entries}
    for key, single_name in (
            ("k3f_bf16", "minimax_step bf16 (K3-bf16)"),
            ("k3f_tf32", "minimax_step tf32 (K3-TF32)")):
        m = meas[key]
        by_name[single_name]["member_axis"] = {
            "launches": sum(int(res["launches"].get(key, 0))
                            for res in paths.values()),
            "members": m["members"], "max_abs_err": m["max_abs_err"],
            "scale_rel_err": m["scale_rel_err"], "ms": m["ms"],
            "singles_ms": m["singles_ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound"]["ms"], "bound_by": m["bound"]["by"],
            "bit_identical": m["bit_identical"], "library_ms": None}
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
    ap.add_argument("--dist-only", action="store_true",
                    help="build the kernels and run phase 17 (data "
                    "parallelism) alone; prints no result line")
    ap.add_argument("--resilience-only", action="store_true",
                    help="build the kernels and run phase 18 (the "
                    "operational planes) alone; prints no result line")
    ap.add_argument("--factory-only", action="store_true",
                    help="build the kernels and run phase 19 (the "
                    "surrogate factory) alone; prints no result line")
    ap.add_argument("--examples-only", action="store_true",
                    help="build the kernels and run phase 20 (the example "
                    "scripts) alone; prints no result line")
    ap.add_argument("--fleet-only", action="store_true",
                    help="build the kernels and run phase 21 (the serving "
                    "fleet) alone; prints no result line")
    ap.add_argument("--audit-only", action="store_true",
                    help="build the kernels and run phase 22 (the audit) "
                    "alone; prints no result line")
    ap.add_argument("--tf32-only", action="store_true",
                    help="build the kernels and run the yardstick and phase "
                    "16(a) (the TF32 kernels, and the f32 K2 and K3, on both "
                    "routes) alone; prints no result line")
    ap.add_argument("--wide-only", action="store_true",
                    help="build the kernels and run phases 3-5 (the kernels "
                    "against their plain flavors, at WIDE_WIDTHS too), the "
                    "yardstick and the wide paths (f32 and TF32) alone; "
                    "prints no result line")
    ap.add_argument("--bf16-only", action="store_true",
                    help="build the kernels and run the yardstick and phase "
                    "14(a) (the bf16 kernels, on both routes) alone; prints "
                    "no result line")
    ap.add_argument("--fleet-child", nargs=2, metavar=("WORK", "OUT"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--dist-worker", nargs=4,
                    metavar=("RANK", "WORLD", "STORE", "OUT"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--resilience-child", nargs=2, metavar=("CK", "OUT"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--cluster-worker", nargs=5,
                    metavar=("PID", "NPROC", "PORT", "CK", "RUNS"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    if args.dist_worker:
        rank, world, store, out = args.dist_worker
        dist_worker(int(rank), int(world), store, out)
        return
    if args.resilience_child:
        resilience_child(*args.resilience_child)
        return
    if args.cluster_worker:
        pid, nproc, port, ck, runs = args.cluster_worker
        cluster_worker(int(pid), int(nproc), int(port), ck, runs)
        return
    if args.fleet_child:
        fleet_child(*args.fleet_child)
        return
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
    if args.dist_only:
        phase_dist(card)
        print(card, flush=True)
        return
    if args.resilience_only:
        phase_resilience(card)
        print(card, flush=True)
        return
    if args.factory_only:
        phase_factory(card)
        print(card, flush=True)
        return
    if args.examples_only:
        phase_examples(card)
        print(card, flush=True)
        return
    if args.fleet_only:
        phase_fleet(card)
        print(card, flush=True)
        return
    if args.audit_only:
        phase_audit(card)
        print(card, flush=True)
        return
    if args.wide_only:
        phase_kernels(dev)
        phase_k3(dev)
        phase_yardstick(dev)
        phase_wide()
        phase_wide(tf32=True)
        print(card, flush=True)
        return
    if args.tf32_only:
        phase_yardstick(dev)
        phase_tf32_kernels(dev)
        print(card, flush=True)
        return
    if args.bf16_only:
        phase_yardstick(dev)
        phase_mixed_kernels(dev)
        print(card, flush=True)
        return
    meas = phase_kernels(dev)
    meas["k3"] = phase_k3(dev)
    yard = phase_yardstick(dev)
    paths = {"minimax": phase_slice(TF_ITER, minimax=None),
             "unfused": phase_slice(TF_ITER, minimax=False)}
    print(f"[paths] ms/step minimax {paths['minimax']['ms_step']:.3f}, "
          f"unfused {paths['unfused']['ms_step']:.3f}", flush=True)
    paths["lbfgs"] = phase_refine(paths)
    paths.update(phase_wide())
    paths.update(phase_wide(tf32=True))
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
    for key in ("k2_tf32", "k3_tf32"):
        tf32_meas[key]["yardstick_ms"] = yard["tf32"]["nine_ms"]
        tf32_meas[key]["wide"]["yardstick_ms"] = yard["tf32_wide"]["nine_ms"]
    for key in ("k2", "k3"):
        meas[key]["yardstick_ms"] = yard["f32"]["nine_ms"]
        meas[key]["wide"]["yardstick_ms"] = yard["f32_wide"]["nine_ms"]
    for key in ("k2_bf16", "k3_bf16"):
        meas[key]["yardstick_ms"] = yard["bf16"]["nine_ms"]
        # the bf16 flavor's route at WIDE_WIDTHS is the mma.sync kernel
        meas[key]["old_route"]["yardstick_ms"] = yard["bf16_wide"]["nine_ms"]
    meas.update(tf32_meas)
    paths.update(option_paths)
    paths.update(phase_dist(card))
    paths.update(phase_resilience(card))
    fac_paths, fac_meas = phase_factory(card)
    paths.update(fac_paths)
    meas.update(fac_meas)
    paths.update(phase_examples(card))
    paths.update(phase_fleet(card))
    paths.update(phase_audit(card))
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
