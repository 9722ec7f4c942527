#!/usr/bin/env python3
"""Drive the PyTorch port (``tpu_jordan_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                 # every phase, as a release check
    python3 chip_smoke.py --phases toolchain,kernel_vs_plain

Phases, each printing one JSON line (any failure raises and exits non-zero):

1. ``toolchain``: torch and CUDA versions, ``nvcc --version``, the card's
   name and power limit; builds every kernel under ``tpu_jordan_torch/csrc``
   (one ``nvcc`` per source, started together) with ``-Xptxas -v``.
2. ``kernel_vs_plain``: each kernel against its plain PyTorch version on the
   card.  Both bodies of the dispatch probe, each through its own entry
   (``gj_probe.cu`` on the schedule ``probe_schedule`` picks: block, cluster
   and global all run, at m = 300 and 1100 among others; and
   ``gj_probe_fused_panel.cu`` at every m with a panel width), on stacks
   that mix random blocks with a zero, a
   rank-deficient and a NaN block, against ``batched_block_inverse``:
   flags equal; on each regular block the kernel's residual ‖B·inv − I‖∞
   within 10× the plain version's plus eps·m, and the relative ∞-norm
   difference of the inverses below REL_LIMIT of the dtype.  The panel
   body is also held against its twin ``gj_fused_panel_plain`` by the same
   rules, and its residual on every regular block to RESIDUAL_RATIO_LIMIT
   times that of ``gj_probe.cu`` on the same stack; its rows split one
   traced call's device time over its three kernels.  The fused update, at
   every UPDATE_CASES shape, t in {0, mid, last} and j in {0, k−1}, in both
   modes: the H block exact, and elsewhere max|kernel − plain| /
   (KM·max|U|·max|P_eff|) below UPDATE_LIMIT.  Each row prints the
   kernel's, the plain version's and a PyTorch call's times (``inv_ex``;
   ``addmm``, in bf16 mode with bf16 operands and an fp32 output), the last
   a yardstick only that the port never calls.  The probe variants, each
   against its own plain twin by the probe's rules, at every fp32
   PROBE_CASES stack with a panel width, at m=48 (a 16-wide panel) and at
   m=768 (v2's l2 schedule; the others run its cluster schedule); each row
   also times both probe bodies on the same stack, and the v2 rows split
   one traced call's device time over v2's kernels.  ``gj_probe.cu`` with a
   global singularity scale (the augmented engine's probe) on the
   SCALED_CASES stacks, one for each of its schedules, against
   ``batched_block_inverse(blocks, scale, eps)`` by the probe's rules, with
   one more block, scaled down, that the global threshold flags and the
   block's own does not.  ``gj_probe.cu``'s complex bodies (complex64 and
   complex128) at the COMPLEX_CASES stacks against the plain probe by the
   same rules (a zero block, a zero row and a NaN in each; (22, 384)
   complex64 with a global scale and its scaled-down block), a forced
   block schedule at complex128 m=128 refused, and a 4096² complex64
   product with TF32 off held to fp32 accuracy (CGEMM_LIMIT, against
   complex128; the reading with TF32 allowed is printed beside it).
3. ``reference``: solves on the card with the kernels against the same
   solves with the plain versions (the engines' ``probe`` and ``update``
   arguments).  The probe at 512/m64 fp32, at 8192/m384 fp64 and at
   3000/m300 fp64 (``gj_probe.cu``'s cluster schedule); the update through
   ``grouped_pallas`` at 512/m64 and 1024/m128 fp32: equal pivot
   sequences, neither singular, inverses within min(eps·n·κ∞, 0.05).  At
   the full width, where fp32 runs part by rounding, the kernel's run is
   checked step by step instead: at 8192/m384 fp32 the plain probe must pick
   the kernel's pivot on every superstep's candidate stack; at 8192/m128,
   in both modes, every group close of the fused update must agree with the
   plain update on the same operands.  The probe variants (v3
   ``gj_probe_inplace``, v2 ``gj_probe_panel``) run inside the engines
   through ``probe=``: the inplace engine at 4096/m128 and the grouped one
   at 8192/m384, rand fp32.  On every superstep's candidate stack the
   variant's plain twin must give equal flags and pick the same pivot; the
   run must pass the solve gate with probe launches = Nr; its warm time is
   printed beside the same engine's with ``gj_probe``.  Those runs, with
   the variants' counts set to 0 just before each and read just after,
   are the variants' path.  The augmented engine (global scale) with the
   kernel against the plain probe at 512/m64 absdiff and 3000/m300 rand
   fp64 (equal pivots, neither singular, inverses within min(eps·n·κ∞,
   0.05)); the batched engine with the kernel against the plain probe at
   B=8, 512², m=64 rand fp32 (per-element pivots equal), and against the
   single in-place engine element by element at B=8, 512², m=128.  The
   lookahead engines (LOOKAHEAD_ROWS) against the engines they reorder,
   both with the kernels: fp64 pivots equal, inverses within min(eps·n·κ∞,
   0.05), and the lookahead run with the kernels against itself with the
   plain probe; fp32 every step's pivot held to the plain probe's on the
   same stack.  The solve engines on WORKLOAD_ROWS' systems with the
   kernels against the plain probe: fp64 pivots equal, X within
   min(eps·n·κ∞, 0.05), and on the pivoting rows the pivot sequence equal
   to the in-place invert engine's; fp32 step by step.  The complex
   engines: the augmented engine at 512/m64 crand complex128 and
   ``block_jordan_solve`` at the same size against the plain probe (pivots
   equal, the solve's also equal to the augmented engine's), complex64
   8192/m384 crand through the augmented engine step by step
   (COMPLEX_STEPWISE_ROW), and the SMW update at 1024/m128 fp64, ranks 16
   and 64, on the card against the same update on the CPU.
4. ``solve``: the main path through ``driver.solve``, each row timed on a
   warm run with the three kernels' launch counts set to 0 just before it
   and read just after: ``engine="auto"`` at 4096/m128/absdiff fp32,
   16384/m128/rand fp32, 1000/m50/rand fp32 and 6000/m300/rand fp32, and
   ``engine="grouped"`` at 8192/m384/absdiff fp64 and 8192/m384/rand fp32
   (the H100 cost model's auto picks the in-place engine there; the tune
   phase drives auto at 8192) (probe launches = Nr, of the
   body the route picks: ``gj_probe_fused_panel`` where m has a panel
   width, ``gj_probe`` at m=50 and m=300; no update launch); ``grouped_pallas`` at 4096/m128 and 8192/m128
   rand fp32 and ``grouped_pallas_bf16`` at 8192/m128 kms and rand (probe
   launches = Nr and update launches = ceil(Nr/k) per engine run).  fp32
   and fp64 rows are held to the gate
   ``rel_residual < min(3·eps·n·κ∞/‖A‖∞, 0.5)``; the bf16 rows to the
   driver's own residual gate, kms with no ladder rung and rand ending on a
   passed rung.  ``engine="augmented"`` at 4096/m128 and 8192/m384 absdiff
   fp64: ``gj_probe`` launches = Nr (the global scale runs ``gj_probe.cu``
   whatever m is), no panel launch.  The batch path, ``driver.solve_batch``
   at 512 × 512² and 512 × 2048², m=128, rand (bench.py's batched tiers,
   in fp64: BATCH_SOLVE_ROWS says why): one probe call a superstep for the
   whole batch (``gj_probe_fused_panel`` launches = Nr); every element's
   rel_residual, from ``batch_metrics`` over the regenerated stack, is held
   to the gate, and an element over it must take the single in-place
   engine's pivots.  absdiff at 8192 runs in fp64: in fp32 it sits on the
   knife edge the JAX package records (benchmarks/PHASES.md), and on this
   card it lands on the singular side with the kernel and with the plain
   probe alike.  The lookahead path: ``driver.solve(engine="lookahead")``
   at every LOOKAHEAD_ROWS row (probe launches = Nr of the routed body,
   the auto rows' gate).  The solve workloads' path: ``linalg.solve_system``
   and ``linalg.lstsq`` with engine="auto" at every WORKLOAD_ROWS row (the
   row's engine, probe launches = Nr of the solved system,
   the backward error under ``solve_gate_threshold``, no ladder rung).
   The complex rows: ``driver.solve`` with crand complex64 at 4096/m128
   (``engine="auto"``, which must run the augmented engine) and 8192/m384
   and complex128 at 4096/m128, ``gj_probe[c64]`` or ``gj_probe[c128]``
   launches = Nr; COMPLEX_WORKLOAD_ROWS (complex64 solve 8192/m384 K=1,
   lstsq 8192 × 4096/m128).  The update path (UPDATE_ROW): the resident
   inverse of 8192/m384 rand fp32 from the in-place engine, then
   ``linalg.solve_update`` at ranks 16 and 64 (the capacitance probe
   ``gj_probe`` at m=8, ``gj_probe_fused_panel`` at m=16, launches = its
   Nr; rel_residual under the update gate; the update's time beside the
   fresh invert's), then 8 chained rank-16 updates under the default
   policy, their drift within the budget and no rung walked.
5. ``tune``: the tuner on the card (``phase_tune``): the card's plan key
   (``cuda-h100|…``), the cost-only picks of AUTO_ROWS with their
   projected seconds beside the JAX package's picks (the card's pick the
   CPU's, but for CARD_ONLY_PICKS: bf16 8192/m384 runs the bf16 fused
   engine on the card, driven once through ``solve``), measured tuning at
   TUNE_POINTS into one temporary plan cache (every trial, the winner, the
   kernels' launches over the run: probe launches > 0, fused-update
   launches > 0 at 8192/m128), the winner solving the row twice from
   the cache with zero measurements, its launches and the row's gate, and
   the cache holding each point's own plan (the card's keys carry m).
6. ``overlap``: ``profile_solve``'s device-time split of OVERLAP_ROWS: the
   lookahead twins must overlap their probe with a GEMM (> 0 ms).
7. ``telemetry``: the observability layer on the card
   (``phase_telemetry``): the 8192/m384 in-place solve traced
   (``Telemetry()``, ``numerics="trace"``) in turns with the same solve
   untraced (the trace's cost; the untraced launches unchanged, no
   bracket; pivots equal; ``elapsed`` equal to the execute span's
   duration), the ``grouped_pallas`` 8192/m128 solve traced (measured
   phase children from kernel brackets: 2 probe and 2 update launches
   above the engine's own), a traced solve and a summary-mode update,
   ``numerics_demo`` at DEMO_CASES through ``tools/check_numerics.py``,
   and the CLI with ``--numerics trace`` and every export through
   ``tools/check_telemetry.py`` (the capacity report's device watermark
   available).
8. ``resilience``: the fault points and checkpoint/resume on the card
   (``phase_resilience``) at 8192/m384 rand fp32: two monolithic in-place
   runs bit-equal; a transient ``execute`` and a transient ``compile``
   fault retried under a policy to the clean inverse's bits; a
   ``result_corrupt_nan`` injection recovered on the ``resolve`` rung; an
   unplanned solve of the solve phase's grouped row launching what it
   launched, its time beside the row's; ``checkpointed_invert``
   (``unrolled``, ``grouped`` k=2, cadence 8) bit-equal to the monolithic
   engine fresh and across a resume from a ``preempt`` at the second
   boundary (zero new segments, the ledger invariant, probe launches = the
   supersteps run), the same for ``checkpointed_solve`` K=1 and a 1000/m50
   invert (``gj_probe.cu``); the bytes and seconds of one checkpoint and
   the checkpointed walls beside the monolithic ones; the CLI's
   ``--sleep`` and ``--precision``.
9. ``serve``: the serving core on the card (``phase_serve``): the CLI's
   ``--serve-demo`` at SERVE_DEMO_ROW (2048/m128 rand, 64 requests, batch
   cap 8: buckets 2048, 1024 and 512) with ``--numerics summary``, in fp32
   and fp64: exit 0, zero builds on the request path and zero plan-cache
   measurements, in fp64 no residual spike (every request's rel_residual
   under eps·n·κ∞; fp32's knife-edge requests are printed, not held),
   panel-probe launches equal to Σ over batches of the
   bucket's Nr (16, 8, 4) and no other kernel (every probe call a launch,
   so no plain-twin call); per bucket the p50/p99 of queue and execute
   seconds, the first batch's execute seconds beside the steady median,
   the mean occupancy.  SERVE_SOLVE_ROWS through ``submit(a, b)`` (2048
   rand fp32 K=16, panel launches = Nr; 1024 crand complex64 K=4,
   ``gj_probe[c64]`` launches = Nr): the backward error under the solve
   gate, X within min(16·eps·n·κ_est, 0.05) of ``linalg.solve_system`` on
   the same element.  ``chaos_demo`` at CHAOS_ROW for CHAOS_SEEDS, each
   report through ``tools/check_chaos.py`` with zero mismatches (bits
   equal to the fault-free replay on the card), and the CLI's
   ``--chaos-demo --quiet`` once (exit 0, the checker).
10. ``handles``: resident handles, update lanes and the capacity budget
   on the card (``phase_handles``).  HANDLES_ROW (8192²/m384 rand fp32):
   per rank (32: the capacitance probe ``gj_probe.cu`` at m = 8; 64: the
   panel body at m = 16, 5 kernel launches a call) a resident invert, one
   update through a second service with a zero drift budget, then a
   stream of 8 cap-1 updates whose middle one makes the capacitance
   exactly singular (``singular_factors``): every update accounted, ≥ 1
   refreshed and ≥ 1 gated, the gated one leaving the handle's bits and
   version unchanged, the first one's inverse within SMW_FP64_TOL of an
   fp64 SMW of the same inputs, the forced one re_inverted, zero builds
   and measurements after warmup, capacitance
   probe calls = k/m an update (plus the invert lane's Nr when a rung ran),
   and the final resident inverse under the gate beside three fresh
   inverts of the mutated matrix through the warm invert lane (their
   execute median printed beside the updates').  HANDLES_BATCH_ROW
   (2048²/m128, rank 32, cap 4): four distinct handles in ONE launch (4
   capacitance probe calls for the batch), then two distinct handles and a
   same-handle follower, each result against the cap-1 lane on the same
   states within BATCH_VS_CAP1_TOL with equal flags and versions.  A complex64
   update at 1024, rank 8 (``gj_probe[c64]``, one call).  The CLI's
   ``--capacity-demo`` at CAPACITY_DEMO_ROW: exit 0 and
   ``tools/check_capacity.py`` exit 0.
11. ``fleet``: the replica fleet on the card (``phase_fleet``):
   ``fleet_demo`` at FLEET_DEMO_ROW (2048/m128 fp32, the mix {2048,
   1024}, 64 requests, batch cap 8, 3 replicas, 2 seeded kills) for
   FLEET_SEEDS, each with ``--slo-report``'s monitor, then the CLI's
   ``--fleet-demo --slo-report --quiet`` once: ``tools/check_fleet.py``
   and ``tools/check_slo.py`` exit 0, every chaos response bit-equal to
   the fault-free replay or typed, zero builds and measurements after
   warmup, warm replacements = deaths, no replica judged wedged, the
   ledger's ``outstanding`` 0, and panel-probe launches = Σ batches × Nr
   plus the warm batches' (every fleet warmup runs one inert batch of
   each lane on each replica's dispatcher thread: Nr panel calls an
   invert or solve lane, one capacitance call an update lane); printed:
   the 1- and 3-replica requests/s, ``scaling_x``, p50/p99 execute by
   bucket, the cross-replica spread.  Then FLEET_UPDATE_ROW: a resident
   2048 handle and 8 rank-1 updates through a 3-replica fleet at the
   default 1.0 s liveness deadline, fault-free and under a seeded
   ``replica_kill``: versions 1..8, every update's inverse and the final
   resident inverse bit-equal to the replay, nothing judged wedged,
   capacitance (``gj_probe``) calls = updates plus the warm batches'.
12. ``lpqp``: the LP/QP drivers on the card (``phase_lpqp``): the CLI's
   ``--lp-demo`` at each of LP_DEMO_ROWS (512 and 48, m 128, fp64, 3
   replicas, 2 kills, batch cap 4) through ``tools/check_lp.py``: at 48
   exit 0; at 512 its only complaints may be the ill QP leg's
   non-convergence and the silent-divergence flag it sets (the
   reference's own driver, ROADMAP.md Queue C).  Held at both, claim by
   claim: the other legs converged, no typed error and no mismatch,
   every update accounted, the zero-budget leg all ``re_inverted``, the
   chaos fingerprint and every iterate equal to the replay with deaths =
   restarts = kills, the batched lane amortizing, zero builds and
   measurements after warmup, nothing outstanding or wedged, and the
   launches: capacitance (``gj_probe``) calls = the updates of every
   leg, panel calls = Nr × (creates + solves + rungs), each plus the
   warm batches'.  Then LP_TIMED_ROW, one ``solve_lp`` of
   ``lp_instance(m=1024)`` through a warm 3-replica fleet at the default
   liveness deadline, ``solve_every=16``: converged, ``obj_rel_err`` ≤
   1e-8, capacitance calls = updates, panel calls = Nr × (1 + solves +
   rungs), each plus the warm batches', and the per-iteration wall's
   median and p90 with its split (the update's round trip and its
   execute, the inverse's copy to the host, the verification solve, the
   host's pricing).
13. ``autoscale``: the CLI's ``--autoscale-demo`` at AUTOSCALE_ROW
   (2048/m128 fp32, ``--replicas 3 --serve-requests 64``): exit 0,
   ``tools/check_autoscale.py`` exit 0, at least one ``scale_up``, the
   fleet back at its floor, ``pre_shed_count`` ≥ 1, one build (the
   warmup's lane) and none after it, panel-probe launches = Σ batches × Nr
   plus the warm batches'.
14. ``update_demo``: the CLI's ``--update-demo`` at UPDATE_DEMO_ROW
   (2048/m128, rank 32, 8 updates, 3 replicas, 1 kill) in fp32 and fp64:
   exit 0 (or exit 1 when ``tools/check_update.py``'s only complaints are
   the two that follow from update ``updates // 2``, the rank-destroying
   one, having been committed, as the report's outcomes show: ROADMAP.md
   Queue C's knife edge); every update accounted in both ledgers, zero
   builds on the warm path and in the chaos leg, the drift rung fired, the
   update beating the re-invert, kills ≥ 1 and deaths ≥ kills, the chaos
   bits equal to the replay, ``outstanding`` 0, and capacitance
   (``gj_probe``) launches = update-lane batches × ⌈k/m⌉ plus the warm
   batches'.  The checker's verdict is printed.
15. ``distributed``: the 1D engines over ``torch.distributed``.  One world
   of 4 ranks sharing the card (``gloo``, by the backend rule: NCCL
   refuses two ranks on one card) runs DIST_ROWS (4096²/m128 absdiff fp32,
   the paper's fixture at the README's size, and 8192²/m384 absdiff fp64)
   through inplace, lookahead, grouped k=2, swapfree and auto, after one
   warm-up run of the row (a rank's first run pays its process's first
   launches), each held: its
   pivots equal to the single-device in-place engine's on the card (the
   padded tail's self-pivots aside), its ring residual under the gate,
   each rank's probe launches equal to the steps at which it held a live
   candidate, and its time (the slowest rank's CUDA events: 4 ranks
   sharing one card on gloo, not a scaling figure) beside the
   single-device engine's.  One world of 1 rank on ``nccl`` at
   DIST_NCCL_ROW (8192²/m384 rand fp32), run twice (the second timed):
   pivots equal, residual under the gate, probe launches = Nr.  The
   CLI's ``4096 128 --workers 4``: exit 0.
16. ``dist_workloads``: the rest of the 1D distributed path on 4 ranks
   sharing the card (gloo).  File input (DIST_FILE_ROW, 4096²/m128
   absdiff fp32): the matrix written to a text file in a temporary
   directory, ``driver.solve(file=..., workers=4, gather=False)``: pivots
   equal to the single-device in-place engine's, the residual under the
   gate, each rank's probe launches equal to its live steps, each rank's
   largest strip ≤ m rows; then the CLI's ``4096 128 <file> --workers 4``
   (exit 0).  The [A | B] solve (DIST_SOLVE_ROW, 8192²/m384 rand fp32,
   K = 1): one world runs ``solve_sharded`` (a warm-up, then timed) and
   ``solve_lookahead`` on each rank's strips, and ``solve_sharded`` on the
   same A and B in fp64, each held to the single-device ``solve_system``
   on the same A and B: the backward error under the solve gate, probe
   launches = live steps, the fp64 pivots equal to the single device's and
   the fp32 engines' pivots equal to each other (fp32 keys may part from
   the single device's at a near tie: ROADMAP.md Queue C); its time (the
   slowest rank's) beside the single-device one; then the CLI's
   ``8192 384 --workload solve --generator rand --workers 4`` (exit 0, its
   printed backward error under its printed gate).  The checkpointed solve
   (DIST_CKPT_ROW, 6000²/m300 rand fp32, K = 16, cadence 5: m = 300 has no
   panel width, so every rank runs ``gj_probe.cu``): uninterrupted, then
   preempted by a seeded fault at the third boundary and resumed; X's bits
   equal, the stored file in the JAX format (key fields, array shapes),
   the launches of the two halves equal to the live steps; checkpoint
   bytes and write seconds recorded.  ``tune=True`` (DIST_TUNE_ROW,
   4096/m128 fp32): the trials (median, spread) and the engine chosen; a
   second call hits the plan cache and measures nothing.
17. ``dist2d``: the 2D block-cyclic path on one world of 4 ranks sharing
   the card (gloo) whose subgroups give the meshes (2, 2), (1, 4) and
   (4, 1).  The invert at DIST2D_ROW (4096²/m128 absdiff fp32) on (2, 2)
   through inplace (both probe layouts, and "auto": owner on gloo),
   grouped k=2, lookahead and swapfree, then inplace on (1, 4) and (4, 1):
   pivots equal to the single-device engine's, the SUMMA residual under
   the gate, on every step the rows probed across the ranks the live
   rows, each by one rank, each rank's probe launches the steps of its
   non-empty slices; the two layouts' inverse shards and swapfree's bit
   for bit equal to inplace's (lookahead's equality printed; its panel and
   trailing GEMMs are other cuBLAS shapes); each run's slowest-rank ms
   beside the single device's.  DIST2D_FP64_ROW (8192²/m384 rand fp64,
   gather=False): pivots equal to the single device's, residual under the
   gate, the corner from the owning blocks (the verbose print) equal to
   the gathered inverse's.  The file row (DIST2D_FILE_ROW): pivots equal
   to the generated run's, every rank's largest strip ≤ m.  The [A | B]
   solve (DIST2D_SOLVE_ROW, 8192²/m384 rand, K = 1: solve_sharded warm and
   timed, solve_lookahead, and solve_sharded in fp64): the backward error
   under the gate, fp64 pivots equal to the single device's, the fp32
   engines' to each other, the pc replicas of X bit for bit equal; then
   the CLI's ``8192 384 --workload solve --generator rand --workers 2x2``.
   The checkpointed invert and solve (DIST2D_CKPT_ROW, 6000²/m300 rand
   fp32, cadence 5: ``gj_probe.cu`` on the ranks), each preempted by a
   seeded fault at the second boundary and resumed: the resumed bits equal
   to the same world's monolithic run, the file in the JAX 2D format
   (``2d:2x2``, swaps (2, 2, Nr)), checkpoint bytes and write seconds
   recorded.  ``tune=True`` (DIST2D_TUNE_ROW) on (2, 2): the trials and
   the pick; a second call hits the plan cache.  Last, the CLI's ``4096
   128 --workers 2x2`` (exit 0).
18. ``observatories``: the communication and work observatories
   (``obs/comm.py``, ``obs/work.py``).  Leg 1, the demos: the CLI's ``48 8
   --comm-demo`` and ``48 8 --work-demo`` in this process, each one world
   of 4 gloo ranks sharing the card (m = 8: ``gj_probe.cu`` on every rank
   of every leg), exit 0, and ``tools/check_comm.py``/``check_work.py`` as
   subprocesses exit 0 on the reports; every comm leg reconciled, the
   drift leg's ``comm_drift`` event recorded, every work leg's counted
   GEMM pin in its band.  Leg 2, full width (OBS_RUNS: 4096²/m128 absdiff
   fp32 inplace on p = 4 and on (2, 2), swapfree on (2, 2) with
   gather=False, solve_sharded 8192²/m384 rand fp32 K = 1 on p = 4) in one
   world of 4 gloo ranks: each run warm, then off, on, on, off with
   recording on or off; the recorded runs reconciled per rank and for the
   world, the totals re-derived from the signatures, the work inventory
   exact and the pin in band, the panel probe on every rank, the drift
   unjudged (gloo), and the mean ms with recording on within OBS_SPREAD of
   the mean with it off; each run's payload bytes, messages, wire bytes,
   achieved GB/s and measured/projected comm ratio printed (4 gloo ranks
   on one card: not link figures).  Leg 3: the CLI's ``4096 128
   --workers 2x2 --comm-report PATH --work-report PATH``: exit 0, both
   files load and carry that solve.
19. ``dist_serve``, the persistent world of ranks, 4 gloo ranks
   sharing the card (not scaling figures). Leg 1: ``serve_demo(4096, 128,
   requests=64, workers=4)`` then ``workers="2x2"`` (fp32 rand; the lane
   budget one byte under the 4096 bucket's single-device projection):
   every 4096 request a ``mesh_admitted`` hop, zero builds and zero world
   starts after warmup, the mesh requests' worst rel_residual under the
   solve gate, the first mesh request's pivots equal the single-device
   engine's, the lane's execute p50/p99 beside its world's start. Leg 2:
   ``JordanSolver(n=4096, block_size=128, workers=4, dtype=float64)``:
   three inverts on one world (one start; the calls' walls), pivots equal
   the single-device engine's, the ring residual on the ranks; then
   ``gather=False`` with ``residual(a, handle)`` on the ranks. Leg 3:
   ``--ckpt-demo`` (DIST_CKPT_DEMO_ROW, fp64, cadence 2, p = 4) through the
   CLI and ``tools/check_ckpt.py`` (exit 0; every leg resumed and
   bit-matched, the replica killed mid-sweep, ``kill_attempts``). Leg 4:
   ``driver.solve(engine="augmented")`` at 4096²/m128 absdiff fp64 on p = 4
   and (2, 2), and ``JordanSolver(engine="augmented")`` at 1000²/m50 rand
   fp32 on p = 4 (``gj_probe.cu`` on the ranks), recorded: fp64 pivots
   equal the single-device in-place engine's, residuals under the gate,
   comm and work reconciled, each rank's launches its live steps (1D).
   Leg 5: the native reader on the 4096² absdiff file (75.8 MB): parsed
   single-device natively and by the Python tokenizer (bit-equal, both
   timed), and streamed to the 4 ranks of leg 4's solver world (each rank
   native, its strip bit-equal); a Python parse fails the phase.
20. ``kernels``: every ported kernel with its launches on its path (the
   solve, tune, telemetry, resilience, serve, handles, fleet, lpqp,
   autoscale, update_demo, distributed, dist_workloads, dist2d,
   observatories and dist_serve rows, the last five counted by the ranks; the variants'
   engine runs of ``reference``),
   the complex bodies of ``gj_probe.cu`` as ``gj_probe[c64]`` and
   ``gj_probe[c128]``; with
   the fleet phase and those after it, each kernel's launches in each of
   them (``launches_by_phase``).

Not run by default: ``--phases toolchain,nccl4`` (on a host with four
cards) runs the distributed phase's 4-rank world with a card a rank,
which the backend rule puts on nccl (every pivot sequence, residual and
launch count held as there), the dist_workloads phase's [A | B] solve leg
in the same way, and the CLI's ``4096 128 --workers 4``; then the dist2d
phase's leg 1 (inplace under "auto", now column, and both layouts) and
its solve leg on (2, 2) over nccl, and the CLI's ``4096 128 --workers
2x2``; then the observatories phase's leg 2 at OBS_NCCL_RUNS (4096²/m128
inplace on p = 4 and on (2, 2)) over nccl, where the drift is judged
("auto"): each run's measured/projected comm ratio and achieved GB/s are
printed, and a ``comm_drift`` event must exist exactly when the ratio is
out of band; then the dist_serve phase's leg 2 at fp32 over nccl (three
inverts on one world, the warm calls' walls).
``--phases knife_edge`` records that fp32 absdiff
8192/m384 elimination through the grouped engine, with the kernel and with
the plain probe: which side of the knife edge each lands on.
``--phases batch_fp32`` runs the batch tiers in fp32 and records the
elements flagged singular and those over the gate.
``--phases cluster_sweep`` times ``gj_probe.cu`` on every schedule that
fits each SWEEP_CASES stack (and v2 on every cluster size), with the
outputs' bits held to the default schedule's.

The script is the subreaper of every process it starts (an orphaned
rank, or a fork server whose program ended, is reparented to it).  Before
the result lines, and on any failure, it closes every world, ends the fork
server and the resource tracker, and ends and reaps any child still left,
naming each on a ``cleanup`` line; a child that outlives SIGKILL fails the
run.

The last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device,
or outside a checkout of the repository, it exits 1 and prints no result.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import signal
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PHASES = ("toolchain", "kernel_vs_plain", "reference", "solve", "tune",
          "overlap", "telemetry", "resilience", "serve", "handles", "fleet",
          "lpqp", "autoscale", "update_demo", "distributed",
          "dist_workloads", "dist2d", "observatories", "dist_serve")
EXTRA_PHASES = ("knife_edge", "cluster_sweep", "batch_fp32", "nccl4")

# Published peaks of one H100 SXM (NVIDIA data sheet, dense, at 700 W):
# fp32 outside the tensor cores, fp64 through the tensor cores (the
# card's highest fp64 rate), and device memory.
PEAK_FLOPS = {"float32": 67e12, "float64": 67e12, "complex64": 67e12,
              "complex128": 67e12}
PEAK_BYTES = 3.35e12

# Largest ratio, on any regular block, of the panel body's residual
# ‖B·inv − I‖∞ to that of gj_probe.cu on the same stack.
RESIDUAL_RATIO_LIMIT = 1.5

# Largest relative ∞-norm difference between the kernel's and the plain
# version's inverse of one regular block.  The readings on these stacks
# stay below 3e-3 (fp32) and 1e-12 (fp64); any inverse of the wrong values
# reads of order 1.
REL_LIMIT = {"float32": 1e-2, "float64": 1e-9, "complex64": 1e-2,
             "complex128": 1e-9}

# (m, nc, dtype): every m the probe meets, at the main path's stack sizes
# (nc = Nr at the first superstep: 32 at 4096/m128, 22 at 8192/m384 in fp32
# and fp64, 128 at 16384/m128).  The first case is the representative for
# the kernels line.
PROBE_CASES = (
    (128, 32, "float32"),
    (64, 16, "float32"),
    (128, 128, "float32"),
    (256, 16, "float32"),
    (384, 22, "float32"),
    (512, 8, "float32"),
    (128, 32, "float64"),
    (384, 22, "float64"),
    (50, 20, "float32"),
    (300, 20, "float32"),
    (300, 20, "float64"),
    (1100, 4, "float32"),
    (8, 16, "float32"),
)
# (8, 16) is the first capacitance stack of the batched update lane (4
# handles × nc = 4 at rank 32, m = 8: gj_probe.cu).
# The stack of the main-path row 1000/m50 (Nr = 20), whose m has no panel
# width, so the probe is gj_probe.cu: the representative of that kernel for
# the kernels line.  m = 300 (6000/m300 and 3000/m300) is its cluster
# schedule, m = 1100 its global one.
RANK1_CASE = (50, 20, "float32")

# (m, nc, dtype): the probe variants' stacks: every fp32 PROBE_CASES stack
# with a panel width (the same seeded stack as its gj_probe row), m=48,
# whose panel is 16 wide, and m=768, beyond v2's cluster schedule.
VARIANT_CASES = tuple(c for c in PROBE_CASES
                      if c[2] == "float32" and c[0] % 8 == 0
                      and c[0] > 8) + (
    (48, 16, "float32"), (768, 4, "float32"))

# (n, m, generator, dtype, engine): the probe variants inside the engines
# (probe=), checked step by step against their plain twins.
VARIANT_ENGINE_ROWS = ((4096, 128, "rand", "float32", "inplace"),
                       (8192, 384, "rand", "float32", "grouped"))

# (n, m, generator, dtype, engine): the kernel's solves held against the
# plain probe's.  8192/m384 is the main path's grouped row; 3000/m300 fp64
# runs gj_probe.cu's cluster schedule.
REFERENCE_ROWS = ((512, 64, "rand", "float32", "inplace"),
                  (512, 64, "rand", "float32", "grouped"),
                  (8192, 384, "absdiff", "float64", "grouped"),
                  (3000, 300, "rand", "float64", "inplace"))
# (n, m, generator, dtype): the kernel's run checked step by step.
STEPWISE_ROW = (8192, 384, "rand", "float32")

# (m, nc, dtype): gj_probe.cu with a global singularity scale, on the
# PROBE_CASES stacks (the same seeds) that reach its block, cluster and
# global schedules, with one more block: a copy of block 0 scaled down by
# SCALE_DOWN.  The scale GLOBAL_SCALE puts the threshold eps·scale (1e-8 in
# fp64, 1e-2 in fp32) above every pivot of that block (≤ 5e-10 and 5e-4:
# its entries are at most 5·SCALE_DOWN) and below every pivot of the
# regular ones (≥ 0.06 and 0.39 on these stacks), so the global threshold
# flags it and each block's own does not.
SCALED_CASES = ((128, 32, "float64"), (384, 22, "float32"),
                (1100, 4, "float32"))
SCALE_DOWN = {"float64": 1e-10, "float32": 1e-4}
GLOBAL_SCALE = {"float64": 1e7, "float32": 2e4}

# (m, nc, dtype, global scale): gj_probe.cu's complex bodies against the
# plain probe on the card: (32, 128) complex64 on the block schedule and
# complex128 beyond its register limit (m ≤ 64 in complex128), (20, 50)
# complex64, (22, 384) complex64 with a global scale (the augmented
# engine's first superstep at 8192/m384, with a copy of block 0 scaled
# down by SCALE_DOWN["float32"] that only the global threshold flags) and
# complex128.  Each stack holds a zero block, a zero row and a NaN
# (make_stack).  The first stack of each dtype is its representative for
# the kernels line.
COMPLEX_CASES = ((128, 32, "complex64", None), (128, 32, "complex128", None),
                 (50, 20, "complex64", None), (384, 22, "complex64", 2e4),
                 (384, 22, "complex128", None))
# Largest max |A·B (complex64, TF32 off) − A·B (complex128)|, over Σ|A||B|
# of the entry, of a 4096² complex product: on the card fp32 products read
# 3.7e-7 and with TF32 allowed 2.4e-5.
CGEMM_LIMIT = 2e-6

# (n, m, generator, dtype): the augmented engine (global scale) with the
# kernel held against the same engine with the plain probe; 3000/m300 runs
# gj_probe.cu's cluster schedule.
AUGMENTED_REFERENCE_ROWS = ((512, 64, "absdiff", "float64"),
                            (3000, 300, "rand", "float64"),
                            (512, 64, "crand", "complex128"))
# (n, m, generator, dtype): the complex augmented engine's run with the
# kernels checked step by step against the plain probe (the complex64 twin
# of STEPWISE_ROW: the main path's complex row).
COMPLEX_STEPWISE_ROW = (8192, 384, "crand", "complex64")
# (B, n, m, generator, dtype): the batched engine with the kernel against
# the plain probe (per-element pivots), and against the single in-place
# engine element by element.
BATCHED_REFERENCE_ROW = (8, 512, 64, "rand", "float32")
BATCHED_VS_SINGLE_ROW = (8, 512, 128, "rand", "float32")

# (n, m, generator): grouped_pallas (fp32, k=2) with the fused update kernel
# held against the same engine with the plain update.
PALLAS_REFERENCE_ROWS = ((512, 64, "rand"), (1024, 128, "rand"))
# (n, m, generator): the fused update kernel checked at every group close of
# a grouped_pallas run, in both modes.
PALLAS_STEPWISE_ROW = (8192, 128, "rand")

# (n, m, generator, dtype, engine): the main path through driver.solve.
# "auto" rows are the paper's program; the fused-update rows are the repo's
# own bench rows for those engines (bench.py:948-958).  The 8192/m384 rows
# name the grouped engine: the H100 cost model ranks the in-place engine
# first there (the tune phase prints both), and these rows keep the
# grouped engine driven at the full width.
# m=50 and m=300 have no panel width, so their probe is gj_probe.cu (on its
# block and cluster schedules).  The augmented reference-parity engine runs
# gj_probe.cu with the global scale at every superstep, whatever m is.
SOLVE_ROWS = ((4096, 128, "absdiff", "float32", "auto"),
              (8192, 384, "absdiff", "float64", "grouped"),
              (8192, 384, "rand", "float32", "grouped"),
              (16384, 128, "rand", "float32", "auto"),
              (1000, 50, "rand", "float32", "auto"),
              (6000, 300, "rand", "float32", "auto"),
              (4096, 128, "rand", "float32", "grouped_pallas"),
              (8192, 128, "rand", "float32", "grouped_pallas"),
              (8192, 128, "kms", "float32", "grouped_pallas_bf16"),
              (8192, 128, "rand", "float32", "grouped_pallas_bf16"),
              (4096, 128, "absdiff", "float64", "augmented"),
              (8192, 384, "absdiff", "float64", "augmented"),
              (4096, 128, "crand", "complex64", "auto"),
              (8192, 384, "crand", "complex64", "augmented"),
              (4096, 128, "crand", "complex128", "augmented"))
# (n, m, generator, dtype, group): the probe-ahead engines through
# driver.solve(engine="lookahead"): the in-place twin at the README's size
# on the paper's fixture, the grouped twin (k=2) at the 8192 rows of the
# auto engine.  Probe launches = Nr a run, of the routed body.
LOOKAHEAD_ROWS = ((4096, 128, "absdiff", "float32", 0),
                  (8192, 384, "rand", "float32", 2),
                  (8192, 384, "absdiff", "float64", 2))
# (n, m, generator, dtype, workload, K, engine): the solve workloads
# through linalg.solve_system ("solve"; "spd" under assume="spd") and
# linalg.lstsq on the CLI's inputs (B = the rand window of n × K at row
# offset n; lstsq's A is n × n//2, so its Gram system is 4096² at m=128),
# with the engine linalg's auto rule must pick: 16384/m128 has Nr = 128 >
# MAX_UNROLL_NR, so solve_fori.  Probe launches = Nr of the solved system a
# run.
WORKLOAD_ROWS = ((8192, 384, "rand", "float32", "solve", 1, "solve_aug"),
                 (8192, 384, "rand", "float64", "solve", 512, "solve_aug"),
                 (16384, 128, "rand", "float32", "solve", 16, "solve_fori"),
                 (8192, 384, "kms", "float64", "spd", 1, "solve_spd"),
                 (8192, 128, "rand", "float64", "lstsq", 1, "solve_spd"))
# The complex workloads on the main path (the JAX CLI's --dtype complex64
# --generator crand; B = the crand window): solve at 8192/m384, K=1, and
# lstsq's 8192 × 4096 fit (its Gram system 4096² at m=128, Hermitian
# positive definite).
COMPLEX_WORKLOAD_ROWS = (
    (8192, 384, "crand", "complex64", "solve", 1, "solve_aug"),
    (8192, 128, "crand", "complex64", "lstsq", 1, "solve_spd"))
# The complex solve engine held against the plain probe (pivots equal) and
# against the complex augmented invert engine's pivots.
COMPLEX_REFERENCE_WORKLOAD_ROWS = (
    (512, 64, "crand", "complex128", "solve", 1, "solve_aug"),)
# (n, m, generator, dtype, ranks, chained): the SMW update of a resident
# inverse (linalg.solve_update): the in-place engine's inverse of the
# 8192/m384 rand fp32 row, updated at rank 16 (capacitance probe
# gj_probe.cu, m=8) and 64 (the panel body, m=16), then `chained` updates
# of rank 16 threaded through the drift budget.  The factors are
# profile_solve.update_factors'.
UPDATE_ROW = (8192, 384, "rand", "float32", (16, 64), 8)

# The telemetry phase: the in-place row traced (Telemetry(), numerics=
# "trace") in turns with the same solve untraced, TELEMETRY_TURNS each;
# the fp32 fused engine's row traced once (its measured phase brackets);
# the numerics demo (n, m, κ decades, the rungs it must walk as (rung,
# passed) pairs) at the JAX default and at m = 128 below the bf16 fused
# engine's auto range, where the in-place engine probes with the panel
# kernel.  The fp32 re-solve's rel residual grows with n·κ against the
# gate's 0.5 cap: at n = 512 κ 10^3.9 refine diverges and the re-solve
# passes (the JAX package walks the same rungs there on the CPU,
# tests/test_torch_numerics.py); at n = 2048 κ 10^3.5 refine recovers,
# and the default κ 10^4.5 exhausts the ladder (ResidualGateError).
TELEMETRY_ROW = (8192, 384, "rand", "float32")
TELEMETRY_PALLAS_ROW = (8192, 128, "rand", "float32")
TELEMETRY_TURNS = 3
_RESOLVED = (("refine", False), ("resolve", True))
DEMO_CASES = ((16, 8, 4.5, _RESOLVED), (512, 128, 3.9, _RESOLVED),
              (2048, 128, 3.5, (("refine", True),)),
              (2048, 128, 4.5, (("refine", False), ("resolve", False))))
# (n, m, generator, dtype, ranks): the SMW update on the card against the
# same update on the CPU.
UPDATE_REFERENCE_ROW = (1024, 128, "rand", "float64", (16, 64))
# The resilience phase: fault points and checkpoint/resume at the 8192 row
# (Nr = 22; cadence 8 writes at supersteps 8 and 16, the grouped engine
# with k = 2), the checkpointed solve with K = 1, and 1000/m50 so that
# gj_probe.cu runs through segments.
RESILIENCE_ROW = (8192, 384, "rand", "float32")
CKPT_CADENCE = 8
CKPT_GROUP = 2
CKPT_SMALL_ROW = (1000, 50, "rand", "float32")
# driver.solve's seconds of each solve-phase row, by (n, m, gen, dtype,
# engine): the resilience phase prints its unplanned solve beside them.
SOLVE_SECONDS: dict = {}
# (n, m, generator, dtype, engine, group): the rows whose device time
# profile_solve splits for the overlap check: the lookahead twins and the
# grouped engine they reorder, at 8192/m384 rand fp32.
OVERLAP_ROWS = ((8192, 384, "rand", "float32", "lookahead", 0),
                (8192, 384, "rand", "float32", "lookahead", 2),
                (8192, 384, "rand", "float32", "grouped", 2))
# (n, m, dtype, workload, the JAX package's cost-only pick): the auto rows
# of PERF.md §4, whose cost-only picks the tune phase prints with each
# candidate's projected seconds on the H100 model (the JAX picks are the
# JAX registry's, on its v5e model, as the JAX package gives them: this
# script imports none of it).  lstsq's rows are its Gram systems.
AUTO_ROWS = ((4096, 128, "float32", "invert", "inplace"),
             (8192, 384, "float64", "invert", "grouped2"),
             (8192, 384, "float32", "invert", "grouped2"),
             (16384, 128, "float32", "invert", "grouped2"),
             (1000, 50, "float32", "invert", "inplace"),
             (6000, 300, "float32", "invert", "inplace"),
             (4096, 128, "complex64", "invert", "augmented"),
             (8192, 384, "float32", "solve", "solve_aug"),
             (8192, 384, "float64", "solve", "solve_aug"),
             (16384, 128, "float32", "solve", "solve_fori"),
             (8192, 384, "float64", "solve_spd", "solve_spd"),
             (4096, 128, "float64", "solve_spd", "solve_spd"),
             (8192, 384, "complex64", "solve", "solve_aug"),
             (4096, 128, "complex64", "solve_spd", "solve_spd"),
             (8192, 384, "bfloat16", "invert", "grouped2"))
# AUTO_ROWS rows whose card pick is not the CPU's, as (card, CPU): the
# fused-update engines are priced only where their kernel runs, so at a
# sub-fp32 storage point with m % 128 == 0 from n = 8192 on the card picks
# the bf16 fused engine and the CPU the in-place engine.
CARD_ONLY_PICKS = {(8192, 384, "bfloat16", "invert"):
                   ("grouped_pallas_bf16", "inplace")}
# (n, m, generator, dtype, workload, survivors): the points the tune phase
# measures on the card, TUNE_SAMPLES timed calls a candidate: the 8192 row;
# 4096/m128, a host-bound row (its survivors in-place, lookahead and
# augmented, so gj_probe.cu is measured too); 8192/m128 with every legal
# invert engine measured, grouped_pallas (fused_update.cu) included; the
# solve at 8192/m384, K=1.  The tuner measures on rand (the JAX tuner's
# fixture); the winner then solves the row's input.
TUNE_POINTS = ((8192, 384, "rand", "float32", "invert", 3),
               (4096, 128, "rand", "float32", "invert", 3),
               (8192, 128, "rand", "float32", "invert", 5),
               (8192, 384, "rand", "float32", "solve", 3))
TUNE_SAMPLES = 5
# (B, n, m, generator, dtype): driver.solve_batch, bench.py's two batched
# tiers (bench.py:403-425; BASELINE.md's batch north star), one probe call
# a superstep for the whole batch.  They run in fp64: in fp32 the rand
# windows of these tiers hold elements that fp32 cannot carry (κ∞·eps of
# order 1), and whether one is flagged singular, which makes solve_batch
# refuse the whole batch as the JAX one does, is a knife edge: on the CPU
# each package flags an element of the 512² tier, not the same one, and
# the card flags none.  ``--phases batch_fp32`` records the fp32 tiers on
# the card.
BATCH_SOLVE_ROWS = ((512, 512, 128, "rand", "float64"),
                    (512, 2048, 128, "rand", "float64"))
# Elements a batch_metrics call takes (bounds the verification's memory).
METRICS_CHUNK = 64

# What the bf16 rows' residual-gate ladder must do: kms (κ∞ ≈ 2.8) passes
# the gate at bf16 eps with no rung; rand (κ·eps_bf16 ≫ 1) must walk the
# ladder and end on a passed rung.
LADDER_EXPECT = {"kms": "no_rungs", "rand": "recovered"}

# (N, m, k): the fused update's shapes.  N = 8192 and 4096 at m=128, k=2
# are the grouped_pallas solve rows; KM = k·m = 1536 at (1536, 384, 4); N =
# 240 is not a multiple of the kernel's 128-wide tile; N = 250 is not a
# multiple of 4, so the kernel reads V, U and P one value at a time (as in
# a solve at n = 150, m = 50).  Each runs at t in {0, mid, last} and j in
# {0, k-1}, in both modes.
UPDATE_CASES = ((8192, 128, 2), (4096, 128, 2), (1536, 384, 4),
                (240, 48, 2), (250, 50, 2))

# Largest max|kernel − plain| / (KM·max|U|·max|P_eff|) the fused update may
# read against its plain version of the same mode, outside the H block
# (which must be exact).
UPDATE_LIMIT = 1e-6

# Peak rate for the fused update's bound: fp32 outside the tensor cores,
# and the bf16 tensor-core rate for bf16 operands (data sheet, dense).
UPDATE_PEAK = {"fp32": 67e12, "bf16": 989e12}

KERNELS = {
    "gj_probe_fused_panel": {
        "route": "cuda",
        "source": "tpu_jordan_torch/csrc/gj_probe_fused_panel.cu",
        "replaces": "tpu_jordan/ops/pallas_block_inverse.py:363",
    },
    "gj_probe": {
        "route": "cuda",
        "source": "tpu_jordan_torch/csrc/gj_probe.cu",
        "replaces": "tpu_jordan/ops/pallas_block_inverse.py:74",
    },
    "fused_update": {
        "route": "cuda",
        "source": "tpu_jordan_torch/csrc/fused_update.cu",
        "replaces": "tpu_jordan/ops/pallas_update.py:86",
    },
    "gj_probe_inplace": {
        "route": "cuda",
        "source": "tpu_jordan_torch/csrc/gj_probe.cu",
        "replaces": "tpu_jordan/ops/pallas_block_inverse.py:159",
    },
    "gj_probe_panel": {
        "route": "cuda",
        "source": "tpu_jordan_torch/csrc/gj_probe_panel.cu",
        "replaces": "tpu_jordan/ops/pallas_block_inverse.py:250",
    },
    # gj_probe.cu's complex bodies (the JAX package probes complex blocks
    # with its plain batched_block_inverse through XLA).
    "gj_probe[c64]": {
        "route": "cuda",
        "source": "tpu_jordan_torch/csrc/gj_probe.cu",
        "replaces": "tpu_jordan/ops/pallas_block_inverse.py:74",
    },
    "gj_probe[c128]": {
        "route": "cuda",
        "source": "tpu_jordan_torch/csrc/gj_probe.cu",
        "replaces": "tpu_jordan/ops/pallas_block_inverse.py:74",
    },
}

# The serve phase (PR 12): the CLI's --serve-demo at (n, m, requests,
# batch_cap), rand fp32; the solve lanes (n, m, generator, dtype, K); the
# chaos demo at (n, requests, batch_cap) and its seeds.
SERVE_DEMO_ROW = (2048, 128, 64, 8)
# fp32 is the CLI's default; its stream holds knife-edge fixtures (request
# 39: κ∞ 5.0e6, κ∞·eps32 ≈ 0.6, rel_residual 0.53 on the card, PR 12), so
# the gate is held on every request in fp64, as the batch rows are (PR 6).
SERVE_DEMO_DTYPES = ("float32", "float64")
SERVE_SOLVE_ROWS = ((2048, 128, "rand", "float32", 16),
                    (1024, 128, "crand", "complex64", 4))
CHAOS_ROW = (512, 64, 8)
CHAOS_SEEDS = (0, 1, 2)

# The handles phase: the cap-1 update lanes at (n, m, generator,
# dtype, ranks, updates a stream); the batched lane at (n, m, rank, cap);
# the complex update at (n, m, rank); the CLI's capacity demo at (n, m).
HANDLES_ROW = (8192, 384, "rand", "float32", (32, 64), 8)
HANDLES_BATCH_ROW = (2048, 128, 32, 4)
HANDLES_COMPLEX_ROW = (1024, 128, 8)
#: The served 8192 update against an fp64 SMW of the same inputs, relative
#: to the correction's ∞-norm (fp32 rounding reads ≈ 1e-6 at 2048 on the
#: host; a missing or transposed correction ≈ 1).
SMW_FP64_TOL = 1e-3
#: The batched lane against the cap-1 lane, relative ∞-norm (the same
#: products in another grouping; the card read 4.2e-8).
BATCH_VS_CAP1_TOL = 1e-5
CAPACITY_DEMO_ROW = (2048, 128)

# The fleet phase: fleet_demo at (n, m, requests, batch_cap, replicas,
# kills), fp32, on the chaos demo's seeded standard-normal stream of sizes
# {n, n/2} (the serve demo's width), for FLEET_SEEDS, then the CLI's
# --fleet-demo once.
FLEET_DEMO_ROW = (2048, 128, 64, 8, 3, 2)
FLEET_SEEDS = (0, 1)
# A resident handle's update stream through the fleet at (n, m, updates,
# kills), rand fp32, fault-free and under seeded replica_kill.
FLEET_UPDATE_ROW = (2048, 128, 8, 1)
# The lpqp phase: the CLI's --lp-demo at each of LP_DEMO_ROWS (n, m,
# replicas, kills, batch_cap, the driver legs allowed not to converge),
# fp64; one solve_lp at LP_TIMED_ROW (m, cond, solve_every, replicas), fp64.
# The reference's active-set driver stops short of its own KKT gate on the
# ill QP family from n = 64 on (both packages on the CPU at 64 and 128:
# tests/test_torch_lpqp.py; ROADMAP.md Queue C), so at 512 tools/check_lp.py
# may complain of qp_ill's non-convergence and of the silent-divergence
# flag it sets, and of nothing else: the phase holds every other claim the
# flag summarizes itself.  At 48 every leg converges and the checker exits 0.
LP_DEMO_ROWS = ((512, 128, 3, 2, 4, ("qp_ill",)),
                (48, 128, 3, 2, 4, ()))
LP_TIMED_ROW = (1024, "well", 16, 3)

# The autoscale phase: the CLI's --autoscale-demo at (n, m, replicas,
# requests), fp32 (the fleet demo's width).
AUTOSCALE_ROW = (2048, 128, 3, 64)
# The update_demo phase: --update-demo at (n, m, rank, updates, replicas,
# kills), the JAX CLI's defaults, in each of UPDATE_DEMO_DTYPES.
UPDATE_DEMO_ROW = (2048, 128, 32, 8, 3, 1)
UPDATE_DEMO_DTYPES = ("float32", "float64")
# check_update.py's complaints that follow from the rank-destroying update
# having been committed (the recipe's knife edge, ROADMAP.md Queue C).
UPDATE_KNIFE_EDGE = ("shows no gated/typed outcome",)
# The distributed phase: (n, m, generator, dtype) through each engine on 4
# ranks sharing the card, and one rank on nccl.
DIST_ROWS = ((4096, 128, "absdiff", "float32"),
             (8192, 384, "absdiff", "float64"))
DIST_ENGINES = ("inplace", "lookahead", "grouped", "swapfree", "auto")
DIST_WORKERS = 4
DIST_NCCL_ROW = (8192, 384, "rand", "float32")
DIST_DEADLINE_S = 600
# The dist_workloads phase on DIST_WORKERS ranks: the paper's file input at
# the README's size (n, m, generator of the file's values, dtype); the
# [A | B] solve at the CLI's --workload solve width (n, m, generator,
# dtype, K); the checkpointed solve at an m with no panel width (n, m,
# generator, dtype, K, cadence, the boundary at which the seeded preempt
# fires); tune=True at (n, m, dtype).
DIST_FILE_ROW = (4096, 128, "absdiff", "float32")
DIST_SOLVE_ROW = (8192, 384, "rand", "float32", 1)
DIST_CKPT_ROW = (6000, 300, "rand", "float32", 16, 5, 3)
DIST_TUNE_ROW = (4096, 128, "float32")
# The dist2d phase: one world of DIST_WORKERS ranks sharing the card whose
# subgroups give the meshes (2, 2), (1, 4) and (4, 1).  The invert at the
# README's size through each engine (engine, k, probe layout; "auto" is
# owner on gloo, column on nccl), then inplace on the other meshes; the
# fp64 gather=False row; the file row; the [A | B] solve (n, m, generator,
# dtype, K); the checkpointed invert and solve at an m with no panel width
# (n, m, generator, dtype, K, cadence, the boundary at which the seeded
# preempt fires); tune=True at (n, m, dtype).
DIST2D_MESH = (2, 2)
DIST2D_ROW = (4096, 128, "absdiff", "float32")
DIST2D_RUNS = (("inplace", 0, "auto"), ("inplace", 0, "column"),
               ("inplace", 0, "owner"), ("grouped", 2, "auto"),
               ("lookahead", 0, "auto"), ("swapfree", 0, "auto"))
DIST2D_MESHES = ((1, 4), (4, 1))
DIST2D_FP64_ROW = (8192, 384, "rand", "float64")
DIST2D_FILE_ROW = (4096, 128, "absdiff", "float32")
DIST2D_SOLVE_ROW = (8192, 384, "rand", "float32", 1)
DIST2D_CKPT_ROW = (6000, 300, "rand", "float32", 16, 5, 2)
DIST2D_TUNE_ROW = (4096, 128, "float32")

# The observatories phase: the two demos through the CLI at (n, m) (m = 8:
# gj_probe.cu on every rank); the full-width runs under recording in one
# world of DIST_WORKERS ranks, each (name, workload, n, m, generator, dtype,
# workers, engine, gather, K); the snapshot flags on the CLI's
# ``4096 128 --workers 2x2``.  OBS_SPREAD: the largest ratio allowed
# between the slowest rank's ms with recording on and with it off, the
# row's known spread within one call (one card ran the same (2, 2) owner
# configuration of 4096²/m128 at 374.5 and 530.3 ms in one call, 1.42×:
# PERF.md §6).
OBS_DEMO_ROW = (48, 8)
OBS_RUNS = (("1d_p4_inplace", "invert", 4096, 128, "absdiff", "float32", 4,
             "inplace", True, 0),
            ("2d_2x2_inplace", "invert", 4096, 128, "absdiff", "float32",
             (2, 2), "inplace", True, 0),
            ("2d_2x2_swapfree_sharded", "invert", 4096, 128, "absdiff",
             "float32", (2, 2), "swapfree", False, 0),
            ("1d_p4_solve_sharded", "solve", 8192, 384, "rand", "float32", 4,
             "solve_sharded", True, 1))
OBS_NCCL_RUNS = OBS_RUNS[:2]
OBS_SPREAD = 1.5
OBS_CLI_ROW = (4096, 128, "2x2")

# The probe variants: (kernel launch counter key, wrapper, plain twin).
VARIANTS = {"gj_probe_inplace": ("inplace", "gj_probe_inplace",
                                 "gj_inplace_plain"),
            "gj_probe_panel": ("panel", "gj_probe_panel", "gj_panel_plain")}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def become_subreaper() -> None:
    """Make this process the reaper of its orphaned descendants
    (``PR_SET_CHILD_SUBREAPER``), so :func:`end_children` finds them."""
    libc = ctypes.CDLL(None, use_errno=True)
    if libc.prctl(36, 1, 0, 0, 0) != 0:
        raise OSError(ctypes.get_errno(), "prctl(PR_SET_CHILD_SUBREAPER)")


def _children() -> dict:
    """{pid: (state, command line)} of this process's children."""
    me, out = os.getpid(), {}
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
            with open(f"/proc/{name}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
        except OSError:
            continue
        if int(fields[1]) == me:
            out[int(name)] = (fields[0], cmd.strip()[:160])
    return out


def end_children(grace_s: float = 10.0) -> list:
    """Close every world, end the fork server and the resource tracker,
    then kill and reap every child left (orphans of the script's
    descendants included, this process being their subreaper).  Returns
    the command lines of the children it had to kill; raises when one
    outlives SIGKILL for ``grace_s``."""
    if "tpu_jordan_torch.parallel.world" in sys.modules:
        sys.modules["tpu_jordan_torch.parallel.world"]._close_all()
    if "tpu_jordan_torch.parallel.launch" in sys.modules:
        sys.modules["tpu_jordan_torch.parallel.launch"].stop_rank_server()
    killed, sent = [], set()
    deadline = time.monotonic() + grace_s
    while True:
        kids = _children()
        if not kids:
            return killed
        for pid, (state, cmd) in kids.items():
            if state != "Z" and pid not in sent:
                killed.append(cmd)
                sent.add(pid)
                os.kill(pid, signal.SIGKILL)
            try:
                os.waitpid(pid, os.WNOHANG)
            except ChildProcessError:
                pass
        if time.monotonic() > deadline:
            raise RuntimeError(f"children outlived SIGKILL: {_children()}")
        time.sleep(0.05)


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` back-to-back calls, by
    CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def phase_toolchain(torch):
    from tpu_jordan_torch import _build

    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip()
    names = sorted(p[:-3] for p in os.listdir(_build.CSRC)
                   if p.endswith(".cu"))
    t0 = time.perf_counter()
    logs = _build.build(names, verbose=True)
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for text in logs.values()
             for ln in text.splitlines()
             if "registers" in ln or "spill" in ln
             or "entry function" in ln]
    emit({"phase": "toolchain", "python": sys.version.split()[0],
          "torch": torch.__version__, "torch_cuda": torch.version.cuda,
          "nvcc": nvcc.splitlines()[-1], "gpu": smi(),
          "kernels_built": names, "build_s": round(build_s, 3),
          "ptxas": ptxas})


# Stacks whose rank-deficient block is a zero row, not a duplicated one:
# at (300, 20) in fp32 the rounding of a duplicated row leaves its last
# pivot above eps·‖block‖∞, and the plain probe and the kernels alike
# invert it to values of order 1e6.
ZERO_ROW_STACKS = {(300, 20, "float32")}


def make_stack(torch, nc: int, m: int, dtype, seed: int):
    """Random blocks with a zero block (1), a duplicated row (2, rank
    m-1; a zero row at ZERO_ROW_STACKS and in a complex stack, whose real
    and imaginary parts are both random) and a NaN (3) mixed in; made with
    numpy from ``seed``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    b = rng.standard_normal((nc, m, m))
    if dtype.is_complex:
        b = b + 1j * rng.standard_normal((nc, m, m))
    b[1] = 0.0
    b[2, m - 1] = b[2, 0]
    if (m, nc, str(dtype).split(".")[-1]) in ZERO_ROW_STACKS or (
            dtype.is_complex):
        b[2, m - 1] = 0.0
    b[3, m // 2, m // 3] = np.nan
    return torch.from_numpy(b).to(device="cuda", dtype=dtype)


def block_residuals(torch, blocks, inv, ok):
    """‖B·inv − I‖∞ of each block selected by ``ok``."""
    from tpu_jordan_torch.ops import block_inf_norms

    eye = torch.eye(blocks.shape[-1], dtype=inv.dtype, device="cuda")
    return block_inf_norms(blocks[ok].to(inv.dtype) @ inv[ok] - eye)


def compare_probe(torch, blocks, out_k, out_p, dname: str, flagged=(1, 2, 3)):
    """A probe kernel's (inv, sing) against its plain version's on a
    make_stack stack: flags equal and raised on the blocks ``flagged``
    only; on each regular block the kernel's residual within 10x the plain
    one's plus eps·m, and the relative ∞-norm difference within REL_LIMIT.
    Returns (readings, within)."""
    from tpu_jordan_torch.ops import block_inf_norms

    (inv_k, sing_k), (inv_p, sing_p) = out_k, out_p
    torch.cuda.synchronize()
    nc, m, _ = blocks.shape
    expected = torch.zeros(nc, dtype=torch.bool, device="cuda")
    expected[list(flagged)] = True
    ok = ~sing_p
    eps = torch.finfo(inv_k.dtype).eps
    res_k = block_residuals(torch, blocks, inv_k, ok)
    res_p = block_residuals(torch, blocks, inv_p, ok)
    rel = (block_inf_norms(inv_k[ok] - inv_p[ok])
           / block_inf_norms(inv_p[ok]))
    readings = {"flags_equal": bool(torch.equal(sing_k, sing_p)),
                "flags_expected": bool(torch.equal(sing_k, expected)),
                "max_rel_err": float(rel.max()),
                "rel_limit": REL_LIMIT[dname],
                "max_residual": [float(res_k.max()), float(res_p.max())],
                "max_residual_ratio": float((res_k / res_p).max()),
                "max_abs_err": float((inv_k[ok] - inv_p[ok]).abs().max())}
    within = bool((res_k <= 10 * res_p + eps * m).all()
                  and (rel <= REL_LIMIT[dname]).all())
    return readings, (readings["flags_equal"] and readings["flags_expected"]
                      and within)


def probe_bound(m: int, nc: int, dname: str, elem: int):
    """(bound_ms, bound_by) of inverting an (nc, m, m) stack: 2m³ flops a
    block at the dtype's peak (8m³ real flops for a complex one: a complex
    multiply-add is four real ones), against the stack read and the
    inverses and flags written once."""
    flops = (8.0 if dname.startswith("complex") else 2.0) * m**3
    t_ops = flops * nc / PEAK_FLOPS[dname]
    t_bytes = (2.0 * nc * m * m * elem + nc) / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def phase_kernel_vs_plain(torch):
    """Both bodies of the dispatch probe, each through its own entry, at
    every PROBE_CASES stack (module docstring).  Emits every row, then fails
    if any check failed.  Returns {kernel name: rows}."""
    from tpu_jordan_torch.config import eps_for
    from tpu_jordan_torch.ops import batched_block_inverse
    from tpu_jordan_torch.ops import gj_fused_panel_plain
    from tpu_jordan_torch.ops.gj_fused_panel import launch_fused_panel
    from tpu_jordan_torch.ops.gj_fused_panel import takes_panel_body
    from tpu_jordan_torch.ops.gj_probe import launch_kernel, schedule_for

    # The library yardstick first: one run of this phase aborted inside
    # inv_ex (magma_queue::setup_ptrArray) when its first call came after
    # the kernels had run.
    torch.linalg.inv_ex(torch.eye(128, device="cuda").expand(32, 128, 128)
                        .contiguous())
    torch.cuda.synchronize()
    rows = {"gj_probe_fused_panel": [], "gj_probe": []}
    bad = []
    for i, (m, nc, dname) in enumerate(PROBE_CASES):
        dtype = getattr(torch, dname)
        eps = eps_for(dtype)
        blocks = make_stack(torch, nc, m, dtype, seed=i)
        plain = batched_block_inverse(blocks)
        out_r = launch_kernel(blocks, eps)
        reps = 20 if m <= 256 else 5
        elem = blocks.element_size()
        bound_ms, bound_by = probe_bound(m, nc, dname, elem)
        common = {"phase": "kernel_vs_plain", "m": m, "nc": nc,
                  "dtype": dname,
                  "plain_ms": cuda_ms(torch,
                                      lambda: batched_block_inverse(blocks),
                                      2),
                  "library_ms": cuda_ms(torch,
                                        lambda: torch.linalg.inv_ex(blocks),
                                        20),
                  "bound_ms": bound_ms, "bound_by": bound_by}
        readings, ok = compare_probe(torch, blocks, out_r, plain, dname)
        rank1_ms = cuda_ms(torch, lambda: launch_kernel(blocks, eps), reps)
        row = {"kernel": "gj_probe", **common,
               "schedule": list(schedule_for(blocks)),
               **readings, "ms": rank1_ms}
        emit(row)
        rows["gj_probe"].append(row)
        if not ok:
            bad.append(row)
        if not takes_panel_body(m):
            continue
        out_f = launch_fused_panel(blocks, eps)
        twin = gj_fused_panel_plain(blocks, eps)
        readings, ok = compare_probe(torch, blocks, out_f, plain, dname)
        twin_readings, twin_ok = compare_probe(torch, blocks, out_f, twin,
                                               dname)
        regular = ~plain[1]
        ratio = (block_residuals(torch, blocks, out_f[0], regular)
                 / block_residuals(torch, blocks, out_r[0], regular))
        twin_ratio = (block_residuals(torch, blocks, twin[0], regular)
                      / block_residuals(torch, blocks, out_r[0], regular))
        row = {"kernel": "gj_probe_fused_panel", **common, **readings,
               "ms": cuda_ms(torch, lambda: launch_fused_panel(blocks, eps),
                             reps),
               "gj_probe_ms": rank1_ms,
               "plain_ms": cuda_ms(torch,
                                   lambda: gj_fused_panel_plain(blocks, eps),
                                   1),
               "batched_block_inverse_ms": common["plain_ms"],
               "vs_twin": twin_readings,
               "residual_ratio_vs_gj_probe": {
                   "max": float(ratio.max()), "mean": float(ratio.mean()),
                   "limit": RESIDUAL_RATIO_LIMIT},
               "twin_residual_ratio_vs_gj_probe": {
                   "max": float(twin_ratio.max()),
                   "mean": float(twin_ratio.mean())},
               "split_ms": split_ms(torch, lambda: launch_fused_panel(
                   blocks, eps), "gj_probe_fused_panel_",
                   ("micro", "update", "store"))}
        emit(row)
        rows["gj_probe_fused_panel"].append(row)
        if not (ok and twin_ok
                and float(ratio.max()) <= RESIDUAL_RATIO_LIMIT):
            bad.append(row)
        del out_f, twin
    if bad:
        raise AssertionError(f"a probe body disagrees with its plain "
                             f"version: {bad}")
    served = {r["schedule"][0] for r in rows["gj_probe"]}
    if served != {"block", "cluster", "global"}:
        raise AssertionError(f"gj_probe.cu ran only the schedules "
                             f"{sorted(served)}")
    return rows


def phase_scaled_vs_plain(torch):
    """gj_probe.cu with a global scale at every SCALED_CASES stack against
    ``batched_block_inverse(blocks, scale, eps)`` by compare_probe's rules,
    the scaled-down last block flagged by both and not by the kernel
    without the scale.  Emits every row, then fails if any check failed or
    the rows did not run all three schedules.  Returns the rows."""
    from tpu_jordan_torch.config import eps_for
    from tpu_jordan_torch.ops import batched_block_inverse
    from tpu_jordan_torch.ops.gj_probe import launch_kernel, schedule_for

    rows, bad = [], []
    for case in SCALED_CASES:
        m, nc, dname = case
        dtype = getattr(torch, dname)
        eps = eps_for(dtype)
        stack = make_stack(torch, nc, m, dtype, seed=PROBE_CASES.index(case))
        blocks = torch.cat([stack, stack[:1] * SCALE_DOWN[dname]])
        scale = torch.tensor(GLOBAL_SCALE[dname], dtype=dtype, device="cuda")
        plain = batched_block_inverse(blocks, scale, eps)
        out = launch_kernel(blocks, eps, scale=scale)
        readings, ok = compare_probe(torch, blocks, out, plain, dname,
                                     flagged=(1, 2, 3, nc))
        own = launch_kernel(blocks, eps)[1]
        reps = 20 if m <= 256 else 5
        bound_ms, bound_by = probe_bound(m, nc + 1, dname,
                                         blocks.element_size())
        row = {"phase": "kernel_vs_plain", "kernel": "gj_probe",
               "m": m, "nc": nc + 1, "dtype": dname,
               "global_scale": GLOBAL_SCALE[dname],
               "scale_down": SCALE_DOWN[dname],
               "schedule": list(schedule_for(blocks)), **readings,
               "scaled_block_flagged": [bool(out[1][nc]),
                                        bool(plain[1][nc])],
               "scaled_block_flagged_by_own_norm": bool(own[nc]),
               "ms": cuda_ms(torch, lambda: launch_kernel(
                   blocks, eps, scale=scale), reps),
               "plain_ms": cuda_ms(torch, lambda: batched_block_inverse(
                   blocks, scale, eps), 2),
               "library_ms": cuda_ms(torch,
                                     lambda: torch.linalg.inv_ex(blocks), 20),
               "bound_ms": bound_ms, "bound_by": bound_by}
        emit(row)
        rows.append(row)
        if not ok or row["scaled_block_flagged_by_own_norm"]:
            bad.append(row)
    if bad:
        raise AssertionError(f"gj_probe.cu with a global scale disagrees "
                             f"with the plain version: {bad}")
    served = {r["schedule"][0] for r in rows}
    if served != {"block", "cluster", "global"}:
        raise AssertionError(f"gj_probe.cu with a global scale ran only "
                             f"the schedules {sorted(served)}")
    return rows


def phase_complex_vs_plain(torch):
    """gj_probe.cu's complex bodies at every COMPLEX_CASES stack against
    ``batched_block_inverse`` (with the case's global scale) by
    compare_probe's rules, each row with the kernel's, the plain probe's
    and ``inv_ex``'s times and the bound; the scaled-down block flagged by
    the global threshold and not by the block's own; a forced block
    schedule at complex128 m=128 refused (KernelLaunchError); and a
    complex64 product with TF32 off at fp32 accuracy (CGEMM_LIMIT against
    a complex128 product).  Emits every row, then fails if any check
    failed.  Returns {kernel name: rows}."""
    from tpu_jordan_torch.config import eps_for, real_dtype
    from tpu_jordan_torch.errors import KernelLaunchError
    from tpu_jordan_torch.ops import batched_block_inverse
    from tpu_jordan_torch.ops.gj_probe import (COMPLEX_BODIES, launch_kernel,
                                               schedule_for)

    rows = {f"gj_probe[{b}]": [] for b in COMPLEX_BODIES.values()}
    bad = []
    for i, (m, nc, dname, scale) in enumerate(COMPLEX_CASES):
        dtype = getattr(torch, dname)
        eps = eps_for(dtype)
        blocks = make_stack(torch, nc, m, dtype, seed=300 + i)
        flagged, kw = (1, 2, 3), {}
        if scale is not None:
            blocks = torch.cat([blocks, blocks[:1] * SCALE_DOWN["float32"]])
            flagged += (nc,)
            kw["scale"] = torch.tensor(scale, dtype=real_dtype(dtype),
                                       device="cuda")
        plain = batched_block_inverse(blocks, kw.get("scale"), eps)
        out = launch_kernel(blocks, eps, **kw)
        readings, ok = compare_probe(torch, blocks, out, plain, dname,
                                     flagged=flagged)
        reps = 20 if m <= 256 else 5
        bound_ms, bound_by = probe_bound(m, len(blocks), dname,
                                         blocks.element_size())
        name = f"gj_probe[{COMPLEX_BODIES[dtype]}]"
        row = {"phase": "kernel_vs_plain", "kernel": name, "m": m,
               "nc": len(blocks), "dtype": dname, "global_scale": scale,
               "schedule": list(schedule_for(blocks)), **readings,
               "ms": cuda_ms(torch, lambda: launch_kernel(blocks, eps, **kw),
                             reps),
               "plain_ms": cuda_ms(torch, lambda: batched_block_inverse(
                   blocks, kw.get("scale"), eps), 2),
               "library_ms": cuda_ms(torch,
                                     lambda: torch.linalg.inv_ex(blocks), 20),
               "bound_ms": bound_ms, "bound_by": bound_by}
        if scale is not None:
            row["scaled_block_flagged"] = [bool(out[1][nc]),
                                           bool(plain[1][nc])]
            row["scaled_block_flagged_by_own_norm"] = bool(
                launch_kernel(blocks, eps)[1][nc])
            ok = ok and not row["scaled_block_flagged_by_own_norm"]
        if dname == "complex128" and m > 64:
            try:
                launch_kernel(blocks, eps, ("block", 1))
                row["block_schedule_refused"] = False
            except KernelLaunchError:
                row["block_schedule_refused"] = True
            ok = ok and row["block_schedule_refused"]
        emit(row)
        rows[name].append(row)
        if not ok:
            bad.append(row)
        del blocks, plain, out
    gen = torch.Generator(device="cuda").manual_seed(7)
    x, y = (torch.randn(4096, 4096, dtype=torch.complex128, device="cuda",
                        generator=gen) for _ in range(2))
    ref = x @ y
    scale = x.abs() @ y.abs()

    def cgemm_err():
        got = (x.to(torch.complex64) @ y.to(torch.complex64)).to(ref.dtype)
        return float(((got - ref).abs() / scale).max())

    err = cgemm_err()
    torch.backends.cuda.matmul.allow_tf32 = True
    err_tf32 = cgemm_err()
    torch.backends.cuda.matmul.allow_tf32 = False
    row = {"phase": "kernel_vs_plain", "check": "cgemm_precision",
           "shape": [4096, 4096, 4096], "max_rel_err": err,
           "max_rel_err_tf32_allowed": err_tf32, "limit": CGEMM_LIMIT}
    emit(row)
    del x, y, ref, scale
    if not err <= CGEMM_LIMIT:
        bad.append(row)
    if bad:
        raise AssertionError(f"gj_probe.cu's complex bodies or the complex "
                             f"products failed their checks: {bad}")
    return rows


def split_ms(torch, fn, prefix: str, parts):
    """Device ms of one warm call of ``fn`` under ``torch.profiler``,
    summed over the kernels named ``prefix + part`` for each of ``parts``,
    with their launch counts."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    split = {}
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for part in parts:
            if prefix + part in evt.name:
                ms, n = split.get(part, (0.0, 0))
                split[part] = (ms + (evt.time_range.end
                                     - evt.time_range.start) / 1e3, n + 1)
    return {part: {"ms": ms, "launches": n}
            for part, (ms, n) in split.items()}


def phase_variants_vs_plain(torch):
    """Each probe variant's kernel against its own plain twin at every
    VARIANT_CASES stack, by compare_probe's rules; each row also times
    ``inv_ex`` and both bodies of the dispatch probe on the same stack (the
    probe kernel shootout of benchmarks/PHASES.md, taken on this card).
    Returns {kernel name: rows}."""
    from tpu_jordan_torch import ops
    from tpu_jordan_torch.ops.gj_fused_panel import launch_fused_panel
    from tpu_jordan_torch.ops.gj_probe import launch_kernel

    eps = 5e-7  # eps_for(float32): the wrappers' default
    rows = {name: [] for name in VARIANTS}
    for i, case in enumerate(VARIANT_CASES):
        m, nc, dname = case
        # The gj_probe row's own stack where there is one.
        seed = PROBE_CASES.index(case) if case in PROBE_CASES else 100 + i
        blocks = make_stack(torch, nc, m, getattr(torch, dname), seed=seed)
        lib_ms = cuda_ms(torch, lambda: torch.linalg.inv_ex(blocks), 20)
        reps = 20 if m <= 256 else 5
        probe_ms = cuda_ms(torch, lambda: launch_kernel(blocks, eps), reps)
        panel_ms = cuda_ms(torch, lambda: launch_fused_panel(blocks, eps),
                           reps)
        bound_ms, bound_by = probe_bound(m, nc, dname, 4)
        for name, (_, wrapper, twin) in VARIANTS.items():
            kernel, plain = getattr(ops, wrapper), getattr(ops, twin)
            readings, ok = compare_probe(torch, blocks, kernel(blocks),
                                         plain(blocks, eps), dname)
            row = {"phase": "kernel_vs_plain", "kernel": name, "m": m,
                   "nc": nc, "dtype": dname,
                   "panel_width": ops.panel_width(m), **readings,
                   "ms": cuda_ms(torch, lambda: kernel(blocks),
                                 20 if m <= 256 else 5),
                   "plain_ms": cuda_ms(torch, lambda: plain(blocks, eps), 2),
                   "library_ms": lib_ms, "gj_probe_ms": probe_ms,
                   "gj_probe_fused_panel_ms": panel_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by}
            if name == "gj_probe_panel":
                row["schedule"] = list(ops.probe_variants.panel_schedule(m))
                row["split_ms"] = split_ms(
                    torch, lambda: kernel(blocks), "gj_probe_panel_",
                    ("init", "micro", "update", "cluster"))
            emit(row)
            if not ok:
                raise AssertionError(f"{name} disagrees with its plain "
                                     f"twin: {row}")
            rows[name].append(row)
    served = {r["schedule"][0] for r in rows["gj_probe_panel"]}
    if served != {"cluster", "l2"}:
        raise AssertionError(f"gj_probe_panel.cu ran only the schedules "
                             f"{sorted(served)}")
    return rows


def update_operands(torch, N: int, m: int, k: int, t: int, j: int,
                    seed: int):
    """Random operands to the caller contract of the fused update, as
    ``tests/test_pallas_update.py::_operands`` builds them: U's pivot rows
    zero, P's slot j zero, P's earlier pivot-column block zero."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device="cuda")

    KM = k * m
    V, U, P = randn(N, N), randn(N, KM), randn(KM, N)
    U[t * m:(t + 1) * m] = 0
    P[j * m:(j + 1) * m] = 0
    P[:j * m, t * m:(t + 1) * m] = 0
    return V, U, P, randn(m, m), randn(m, N)


def compare_update(torch, out_k, out_p, U, P, H, t: int, j: int, m: int):
    """The kernel's output against the plain version's: the H block
    exact in both, and the max abs difference elsewhere scaled by
    KM·max|U|·max|P_eff|.  Returns (h_exact, scaled, max_abs)."""
    s = slice(t * m, (t + 1) * m)
    h_exact = bool(torch.equal(out_k[s, s], H)
                   and torch.equal(out_p[s, s], H))
    p_eff = P.clone()
    p_eff[j * m:(j + 1) * m] = out_p[s]
    scale = U.shape[1] * U.abs().max() * p_eff.abs().max()
    max_abs = float((out_k - out_p).abs().max())
    return h_exact, max_abs / float(scale), max_abs


def update_bound(N: int, KM: int, m: int, mode: str):
    """(bound_ms, bound_by) of one group close: prow and the update's
    flops at the mode's peak, against V read and written once and U, P,
    H and rows_p read once."""
    t_ops = (2.0 * N * N * KM + 2.0 * m * m * N) / UPDATE_PEAK[mode]
    t_bytes = 4.0 * (2 * N * N + 2 * N * KM + m * m + m * N) / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def phase_update_vs_plain(torch):
    """The fused update kernel against its plain version of the same mode
    at every UPDATE_CASES shape and (t, j); times at t = mid, j = k-1.
    Emits one line per shape and mode, then fails if any disagreed."""
    from tpu_jordan_torch.ops import (fused_normalize_eliminate,
                                      fused_normalize_eliminate_plain)

    rows, bad = [], []
    for i, (N, m, k) in enumerate(UPDATE_CASES):
        Nr, KM = N // m, k * m
        for mode in ("fp32", "bf16"):
            readings = []
            for t in sorted({0, Nr // 2, Nr - 1}):
                for j in sorted({0, k - 1}):
                    V, U, P, H, rows_p = update_operands(
                        torch, N, m, k, t, j, seed=1000 * i + 10 * t + j)
                    kw = {"t": t, "j": j, "m": m, "mode": mode}
                    out_k = fused_normalize_eliminate(V.clone(), U, P, H,
                                                      rows_p, **kw)
                    out_p = fused_normalize_eliminate_plain(V.clone(), U, P,
                                                            H, rows_p, **kw)
                    torch.cuda.synchronize()
                    readings.append((t, j) + compare_update(
                        torch, out_k, out_p, U, P, H, t, j, m))
                    del out_k, out_p
            # Times at the middle pivot row, closing slot (the engine's j).
            t, j = Nr // 2, k - 1
            V, U, P, H, rows_p = update_operands(torch, N, m, k, t, j,
                                                 seed=7)
            kw = {"t": t, "j": j, "m": m, "mode": mode}
            ms = cuda_ms(torch, lambda: fused_normalize_eliminate(
                V, U, P, H, rows_p, **kw), 20)
            plain_ms = cuda_ms(torch, lambda: fused_normalize_eliminate_plain(
                V, U, P, H, rows_p, **kw), 3)
            p_eff = P.clone()
            p_eff[j * m:(j + 1) * m] = V[t * m:(t + 1) * m]
            lib_note = "torch.addmm(V, U, P_eff, alpha=-1)"
            if mode == "fp32":
                lib_ms = cuda_ms(torch, lambda: torch.addmm(
                    V, U, p_eff, alpha=-1), 20)
            else:
                # The same work: bf16 operands, V read and written in fp32.
                ub, pb = U.bfloat16(), p_eff.bfloat16()
                lib_note = ("torch.addmm(V, bf16 U, bf16 P_eff, alpha=-1, "
                            "out_dtype=torch.float32)")
                try:
                    lib_ms = cuda_ms(torch, lambda: torch.addmm(
                        V, ub, pb, alpha=-1, out_dtype=torch.float32), 20)
                except (RuntimeError, TypeError, NotImplementedError) as exc:
                    lib_ms, lib_note = None, (f"{lib_note} is not available "
                                              f"in this torch: {exc}")[:300]
            bound_ms, bound_by = update_bound(N, KM, m, mode)
            row = {"phase": "kernel_vs_plain", "kernel": "fused_update",
                   "N": N, "m": m, "k": k, "KM": KM, "mode": mode,
                   "tj": [[r[0], r[1]] for r in readings],
                   "h_exact": all(r[2] for r in readings),
                   "max_scaled_err": max(r[3] for r in readings),
                   "limit": UPDATE_LIMIT,
                   "max_abs_err": max(r[4] for r in readings),
                   "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                   "library_call": lib_note,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "tflops": (2.0 * N * N * KM + 2.0 * m * m * N)
                   / ms / 1e9,
                   "split_ms": split_ms(
                       torch, lambda: fused_normalize_eliminate(
                           V, U, P, H, rows_p, **kw), "fused_update_",
                       ("prow", "to_bf16", "bf16", "fp32"))}
            emit(row)
            rows.append(row)
            if not (row["h_exact"] and row["max_scaled_err"] <= UPDATE_LIMIT):
                bad.append(row)
            del V, U, P, H, rows_p, p_eff
            torch.cuda.empty_cache()
    if bad:
        raise AssertionError(f"fused_update disagrees with the plain "
                             f"version: {bad}")
    return rows


def phase_reference(torch):
    """Engines on the card with the kernel against the same engines with
    the plain probe: equal pivot sequences, neither singular, inverses
    within min(eps·n·κ∞, 0.05) (eps of the dtype, κ∞ from the plain
    probe's inverse).  The readings stay below 0.1·eps·n·κ∞ and 3e-3; the
    cap keeps the check from passing X = 0, whose difference reads 1."""
    from tpu_jordan_torch.ops import batched_block_inverse, generate
    from tpu_jordan_torch.ops import block_jordan_invert_inplace
    from tpu_jordan_torch.ops import block_jordan_invert_inplace_grouped
    from tpu_jordan_torch.ops import condition_inf, inf_norm, probe_blocks
    from tpu_jordan_torch.ops.jordan_inplace import _select as select

    def plain(cands, eps):
        return batched_block_inverse(cands, None, eps)

    engines = {"inplace": block_jordan_invert_inplace,
               "grouped": block_jordan_invert_inplace_grouped}
    for n, m, gen, dname, name in REFERENCE_ROWS:
        dtype = getattr(torch, dname)
        a = generate(gen, (n, n), dtype, device="cuda")
        eng = engines[name]
        kw = {"group": 2} if name == "grouped" else {}
        x_k, s_k, st_k = eng(a, block_size=m, collect_stats=True, **kw)
        x_p, s_p, st_p = eng(a, block_size=m, collect_stats=True,
                             probe=plain, **kw)
        pivots_equal = bool(torch.equal(st_k["pivot_block"],
                                        st_p["pivot_block"]))
        kappa = float(condition_inf(a, x_p))
        rel = float(inf_norm(x_k - x_p) / inf_norm(x_p))
        limit = min(torch.finfo(dtype).eps * n * kappa, 0.05)
        row = {"phase": "reference", "engine": name, "n": n, "m": m,
               "generator": gen, "dtype": dname,
               "pivots_equal": pivots_equal,
               "singular": [bool(s_k), bool(s_p)], "kappa_inf": kappa,
               "rel_diff": rel, "limit": limit}
        emit(row)
        del x_k, x_p, a
        torch.cuda.empty_cache()
        if not (pivots_equal and rel <= limit and not (s_k or s_p)):
            raise AssertionError(f"kernel and plain probe disagree: {row}")

    n, m, gen, dname = STEPWISE_ROW
    picks = []

    def both(cands, eps):
        invs, sing = probe_blocks(cands, eps)
        picks.append([int(select(i, s, 0)[1])
                      for i, s in (batched_block_inverse(cands, None, eps),
                                   (invs, sing))])
        return invs, sing

    a = generate(gen, (n, n), getattr(torch, dname), device="cuda")
    _, singular = block_jordan_invert_inplace_grouped(a, block_size=m,
                                                      group=2, probe=both)
    row = {"phase": "reference", "engine": "grouped", "n": n, "m": m,
           "generator": gen, "dtype": dname, "stepwise": True,
           "steps": len(picks),
           "pivots_equal": all(p == k for p, k in picks),
           "singular": bool(singular)}
    emit(row)
    del a
    torch.cuda.empty_cache()
    if not (row["pivots_equal"] and row["steps"] == -(-n // m)
            and not row["singular"]):
        raise AssertionError(f"kernel and plain probe disagree: {row}")
    phase_reference_update(torch)


def recording_probe(pivots, inner=None):
    """``inner`` (default the engines' probe), recording each step's pivot
    block by the engines' own key argmin (the call index is the step)."""
    from tpu_jordan_torch.ops import probe_blocks
    from tpu_jordan_torch.ops.jordan_inplace import _select as select

    inner = inner or probe_blocks

    def probe(cands, eps, **kw):
        invs, sing = inner(cands, eps, **kw)
        pivots.append(int(select(invs, sing, len(pivots))[1]))
        return invs, sing
    return probe


def batch_recording_probe(B, steps, inner=None):
    """``inner`` (default the engines' probe) on the batched engine's folded
    (B·nc, m, m) stack, recording each element's pivot block per superstep
    in ``steps`` (one list of B a call)."""
    from tpu_jordan_torch.ops import block_inf_norms, probe_blocks

    inner = inner or probe_blocks

    def probe(cands, eps):
        invs, sing = inner(cands, eps)
        key = block_inf_norms(invs).masked_fill(sing, float("inf"))
        steps.append((key.view(B, -1).argmin(dim=1) + len(steps)).tolist())
        return invs, sing
    return probe


def phase_reference_engines(torch):
    """The engines this slice brings, on the card: the augmented engine
    (global scale) with the kernel against itself with the plain probe at
    every AUGMENTED_REFERENCE_ROWS row (equal pivot sequences, neither
    singular, inverses within min(eps·n·κ∞, 0.05)); the batched engine with
    the kernel against itself with the plain probe (per-element pivot
    sequences equal, no element singular) and against the single in-place
    engine element by element (pivot sequences equal)."""
    from tpu_jordan_torch.ops import (
        batched_block_inverse, batched_jordan_invert, block_jordan_invert,
        block_jordan_invert_inplace, condition_inf, generate, generate_batch,
        inf_norm)

    def plain(cands, eps, scale=None):
        return batched_block_inverse(cands, scale, eps)

    for n, m, gen, dname in AUGMENTED_REFERENCE_ROWS:
        dtype = getattr(torch, dname)
        a = generate(gen, (n, n), dtype, device="cuda")
        piv_k, piv_p = [], []
        x_k, s_k = block_jordan_invert(a, block_size=m, global_scale=True,
                                       probe=recording_probe(piv_k))
        x_p, s_p = block_jordan_invert(a, block_size=m, global_scale=True,
                                       probe=recording_probe(piv_p, plain))
        kappa = float(condition_inf(a, x_p))
        rel = float(inf_norm(x_k - x_p) / inf_norm(x_p))
        limit = min(torch.finfo(dtype).eps * n * kappa, 0.05)
        row = {"phase": "reference", "engine": "augmented",
               "global_scale": True, "n": n, "m": m, "generator": gen,
               "dtype": dname, "pivots_equal": piv_k == piv_p,
               "steps": len(piv_k), "singular": [bool(s_k), bool(s_p)],
               "kappa_inf": kappa, "rel_diff": rel, "limit": limit}
        emit(row)
        del x_k, x_p, a
        torch.cuda.empty_cache()
        if not (row["pivots_equal"] and row["steps"] == -(-n // m)
                and rel <= limit and not (s_k or s_p)):
            raise AssertionError(f"kernel and plain probe disagree in the "
                                 f"augmented engine: {row}")

    B, n, m, gen, dname = BATCHED_REFERENCE_ROW
    a = generate_batch(gen, n, B, getattr(torch, dname), device="cuda")
    steps_k, steps_p = [], []
    _, s_k = batched_jordan_invert(a, block_size=m,
                                   probe=batch_recording_probe(B, steps_k))
    _, s_p = batched_jordan_invert(
        a, block_size=m, probe=batch_recording_probe(B, steps_p, plain))
    row = {"phase": "reference", "engine": "batched", "batch": B, "n": n,
           "m": m, "generator": gen, "dtype": dname,
           "steps": len(steps_k), "pivots_equal": steps_k == steps_p,
           "singular": [int(s_k.sum()), int(s_p.sum())]}
    emit(row)
    if not (row["pivots_equal"] and row["steps"] == -(-n // m)
            and row["singular"] == [0, 0]):
        raise AssertionError(f"kernel and plain probe disagree in the "
                             f"batched engine: {row}")

    B, n, m, gen, dname = BATCHED_VS_SINGLE_ROW
    a = generate_batch(gen, n, B, getattr(torch, dname), device="cuda")
    steps = []
    x_b, s_b = batched_jordan_invert(a, block_size=m,
                                     probe=batch_recording_probe(B, steps))
    single, rel = [], []
    for b in range(B):
        x_s, s_s, stats = block_jordan_invert_inplace(a[b], block_size=m,
                                                      collect_stats=True)
        single.append((stats["pivot_block"].tolist(), bool(s_s)))
        rel.append(float(inf_norm(x_b[b] - x_s) / inf_norm(x_s)))
    per_elem = [[s[b] for s in steps] for b in range(B)]
    row = {"phase": "reference", "engine": "batched", "against": "inplace",
           "batch": B, "n": n, "m": m, "generator": gen, "dtype": dname,
           "pivots_equal": all(per_elem[b] == single[b][0]
                               for b in range(B)),
           "singular": [int(s_b.sum()), sum(s for _, s in single)],
           "max_rel_diff": max(rel)}
    emit(row)
    del a, x_b
    torch.cuda.empty_cache()
    if not (row["pivots_equal"] and row["singular"] == [0, 0]):
        raise AssertionError(f"the batched engine disagrees with the "
                             f"in-place engine: {row}")


def phase_reference_update(torch):
    """grouped_pallas on the card with the fused update kernel against
    the same engine with the plain update: equal pivot sequences, neither
    singular, inverses within min(eps·n·κ∞, 0.05).  At the path's full
    width the runs may part by rounding, so there every group close of
    the kernel's run is held against the plain update on the same
    operands instead, in both modes, within UPDATE_LIMIT."""
    from tpu_jordan_torch.ops import (
        block_jordan_invert_inplace_grouped_pallas as engine,
        condition_inf, fused_normalize_eliminate,
        fused_normalize_eliminate_plain, generate, inf_norm)

    for n, m, gen in PALLAS_REFERENCE_ROWS:
        a = generate(gen, (n, n), torch.float32, device="cuda")
        piv_k, piv_p = [], []
        x_k, s_k = engine(a, block_size=m, group=2,
                          probe=recording_probe(piv_k))
        x_p, s_p = engine(a, block_size=m, group=2,
                          probe=recording_probe(piv_p),
                          update=fused_normalize_eliminate_plain)
        kappa = float(condition_inf(a, x_p))
        rel = float(inf_norm(x_k - x_p) / inf_norm(x_p))
        limit = min(torch.finfo(torch.float32).eps * n * kappa, 0.05)
        row = {"phase": "reference", "engine": "grouped_pallas", "n": n,
               "m": m, "generator": gen, "dtype": "float32",
               "pivots_equal": piv_k == piv_p, "steps": len(piv_k),
               "singular": [bool(s_k), bool(s_p)], "kappa_inf": kappa,
               "rel_diff": rel, "limit": limit}
        emit(row)
        del x_k, x_p, a
        torch.cuda.empty_cache()
        if not (row["pivots_equal"] and row["steps"] == n // m
                and rel <= limit and not (s_k or s_p)):
            raise AssertionError(f"kernel and plain update disagree: {row}")

    n, m, gen = PALLAS_STEPWISE_ROW
    a = generate(gen, (n, n), torch.float32, device="cuda")
    for mode in ("fp32", "bf16"):
        readings = []

        def checked(V, U, P, H, rows_p, *, t, j, m, mode):
            ref = fused_normalize_eliminate_plain(V.clone(), U, P, H, rows_p,
                                                  t=t, j=j, m=m, mode=mode)
            out = fused_normalize_eliminate(V, U, P, H, rows_p, t=t, j=j,
                                            m=m, mode=mode)
            readings.append(compare_update(torch, out, ref, U, P, H, t, j,
                                           m))
            return out

        _, singular = engine(a, block_size=m, group=2, mode=mode,
                             update=checked)
        row = {"phase": "reference", "engine": "grouped_pallas", "n": n,
               "m": m, "generator": gen, "dtype": "float32", "mode": mode,
               "stepwise": True, "closes": len(readings),
               "h_exact": all(r[0] for r in readings),
               "max_scaled_err": max(r[1] for r in readings),
               "limit": UPDATE_LIMIT, "singular": bool(singular)}
        emit(row)
        torch.cuda.empty_cache()
        if not (row["closes"] == -(-(n // m) // 2) and row["h_exact"]
                and row["max_scaled_err"] <= UPDATE_LIMIT
                and not row["singular"]):
            raise AssertionError(f"kernel and plain update disagree: {row}")
    del a
    torch.cuda.empty_cache()


def phase_reference_variants(torch):
    """Each probe variant inside the engines through ``probe=`` at every
    VARIANT_ENGINE_ROWS row.  On every superstep's candidate stack of the
    variant's run its plain twin must give equal flags and pick the same
    pivot; the run must not be singular, must pass the solve gate
    rel_residual < min(3·eps·n·κ∞/‖A‖∞, 0.5) and launch the variant's
    kernel Nr times.  The warm engine time is printed beside the same
    engine's with ``gj_probe``.  Each checked run is the variant's path:
    its count is set to 0 just before the run and read just after.
    Returns the counts summed over the rows."""
    from tpu_jordan_torch import ops
    from tpu_jordan_torch.ops import probe_variants as pv
    from tpu_jordan_torch.ops.jordan_inplace import _select as select

    engines = {"inplace": ops.block_jordan_invert_inplace,
               "grouped": ops.block_jordan_invert_inplace_grouped}
    totals = {name: 0 for name in VARIANTS}
    for n, m, gen, dname, engine in VARIANT_ENGINE_ROWS:
        dtype = getattr(torch, dname)
        a = ops.generate(gen, (n, n), dtype, device="cuda")
        eng = engines[engine]
        kw = {"group": 2} if engine == "grouped" else {}
        nr = -(-n // m)
        norm_a = float(ops.inf_norm(a))
        base_ms = cuda_ms(torch, lambda: eng(a, block_size=m, **kw), 1)
        for name, (key, wrapper, twin) in VARIANTS.items():
            kernel, plain = getattr(ops, wrapper), getattr(ops, twin)
            steps = []

            def checked(cands, eps):
                out = kernel(cands, eps)
                inv_t, sing_t = plain(cands, eps)
                steps.append((bool(torch.equal(out[1], sing_t)),
                              int(select(*out, 0)[1]),
                              int(select(inv_t, sing_t, 0)[1])))
                return out

            pv.reset_launches()
            x, singular = eng(a, block_size=m, probe=checked, **kw)
            torch.cuda.synchronize()
            launches = pv.launches[key]
            totals[name] += launches
            kappa = float(ops.condition_inf(a, x))
            rel = float(ops.residual_inf_norm(a, x)) / norm_a
            gate = min(3.0 * torch.finfo(dtype).eps * n * kappa / norm_a,
                       0.5)
            del x
            ms = cuda_ms(torch, lambda: eng(a, block_size=m, probe=kernel,
                                            **kw), 1)
            row = {"phase": "reference", "engine": engine, "probe": name,
                   "n": n, "m": m, "generator": gen, "dtype": dname,
                   "stepwise": True, "steps": len(steps),
                   "flags_equal": all(f for f, _, _ in steps),
                   "pivots_equal": all(k == p for _, k, p in steps),
                   "singular": bool(singular), "kappa_inf": kappa,
                   "rel_residual": rel, "gate": gate,
                   "probe_launches": launches, "expected_launches": nr,
                   "ms": ms, "gj_probe_ms": base_ms}
            emit(row)
            torch.cuda.empty_cache()
            if not (row["flags_equal"] and row["pivots_equal"]
                    and row["steps"] == nr and not row["singular"]
                    and rel < gate and launches == nr):
                raise AssertionError(f"{name} inside the {engine} engine "
                                     f"failed its checks: {row}")
        del a
        torch.cuda.empty_cache()
    return totals


def stepwise_probe(torch, picks):
    """The engines' probe, recording on each call whether the plain probe
    on the same stack picks the kernel's pivot block (the call index is the
    step)."""
    from tpu_jordan_torch.ops import batched_block_inverse, probe_blocks
    from tpu_jordan_torch.ops.jordan_inplace import _select as select

    def probe(cands, eps):
        invs, sing = probe_blocks(cands, eps)
        t = len(picks)
        picks.append(int(select(invs, sing, t)[1])
                     == int(select(*batched_block_inverse(cands, None, eps),
                                   t)[1]))
        return invs, sing
    return probe


def plain_probe(cands, eps):
    from tpu_jordan_torch.ops import batched_block_inverse

    return batched_block_inverse(cands, None, eps)


def phase_reference_lookahead(torch):
    """The lookahead engines on the card (LOOKAHEAD_ROWS) against the
    engines they reorder, run with the kernels: in fp64 equal pivot
    sequences and inverses within min(eps·n·κ∞, 0.05), and the lookahead
    run with the kernels against itself with the plain probe by the same
    rules; in fp32, where a column-sliced GEMM may round a knife-edge step
    the other way, every step's pivot is held to the plain probe's on the
    same stack, and the pivots and difference from the reordered engine
    are printed (held to the same rules where the pivots are equal)."""
    from tpu_jordan_torch import ops

    for n, m, gen, dname, group in LOOKAHEAD_ROWS:
        dtype = getattr(torch, dname)
        a = ops.generate(gen, (n, n), dtype, device="cuda")
        kw = {"group": group} if group else {}
        twin = (ops.block_jordan_invert_inplace_grouped if group
                else ops.block_jordan_invert_inplace)
        la = (ops.block_jordan_invert_inplace_grouped_lookahead if group
              else ops.block_jordan_invert_inplace_lookahead)
        x_t, s_t, st_t = twin(a, block_size=m, collect_stats=True, **kw)
        x_l, s_l, st_l = la(a, block_size=m, collect_stats=True, **kw)
        nr = -(-n // m)
        kappa = float(ops.condition_inf(a, x_t))
        limit = min(torch.finfo(dtype).eps * n * kappa, 0.05)
        pivots_equal = bool(torch.equal(st_t["pivot_block"],
                                        st_l["pivot_block"]))
        rel = float(ops.inf_norm(x_l - x_t) / ops.inf_norm(x_t))
        row = {"phase": "reference", "engine": "lookahead", "group": group,
               "n": n, "m": m, "generator": gen, "dtype": dname,
               "pivots_equal_to_reordered": pivots_equal,
               "singular": [bool(s_l), bool(s_t)], "kappa_inf": kappa,
               "rel_diff_to_reordered": rel, "limit": limit}
        ok = not (row["singular"][0] or row["singular"][1])
        if dname == "float64":
            x_p, s_p, st_p = la(a, block_size=m, collect_stats=True,
                                probe=plain_probe, **kw)
            row["plain_pivots_equal"] = bool(torch.equal(
                st_l["pivot_block"], st_p["pivot_block"]))
            row["plain_rel_diff"] = float(ops.inf_norm(x_l - x_p)
                                          / ops.inf_norm(x_p))
            ok = (ok and pivots_equal and rel <= limit and not bool(s_p)
                  and row["plain_pivots_equal"]
                  and row["plain_rel_diff"] <= limit)
            del x_p
        else:
            picks = []
            la(a, block_size=m, probe=stepwise_probe(torch, picks), **kw)
            row["stepwise_steps"] = len(picks)
            row["stepwise_pivots_equal"] = all(picks)
            ok = (ok and all(picks) and len(picks) == nr
                  and (rel <= limit or not pivots_equal))
        emit(row)
        del a, x_t, x_l
        torch.cuda.empty_cache()
        if not ok:
            raise AssertionError(f"the lookahead engine failed its "
                                 f"checks: {row}")


def workload_inputs(torch, n: int, gen: str, dtype, workload: str, k: int):
    """(A, B) of a WORKLOAD_ROWS row on the card, as the CLI makes them;
    for lstsq, the (A, B) of its full-column-rank n × n//2 fit."""
    from tpu_jordan_torch.ops import generate
    from tpu_jordan_torch.profile_solve import rhs_generator

    b = generate(rhs_generator(dtype), (n, k), dtype, row_offset=n,
                 device="cuda")
    cols = n // 2 if workload == "lstsq" else n
    return generate(gen, (n, cols), dtype, device="cuda"), b


def phase_reference_workloads(torch):
    """The solve engines on the card (WORKLOAD_ROWS' systems; lstsq's Gram
    system) with the kernels against the plain probe.  fp64: equal pivot
    sequences, neither singular, X within min(eps·n·κ∞, 0.05) (κ∞ from the
    in-place invert engine's inverse), and on the pivoting rows the pivot
    sequence equal to the in-place invert engine's (the augmented one's for
    complex128, COMPLEX_REFERENCE_WORKLOAD_ROWS).  fp32: every step's
    pivot held to the plain probe's on the same stack."""
    from tpu_jordan_torch import ops
    from tpu_jordan_torch.linalg.api import solve_engine_fn

    for n, m, gen, dname, workload, k, engine in (
            WORKLOAD_ROWS + COMPLEX_REFERENCE_WORKLOAD_ROWS):
        dtype = getattr(torch, dname)
        a, b = workload_inputs(torch, n, gen, dtype, workload, k)
        if workload == "lstsq":
            a, b = a.T @ a, a.T @ b
        size = a.shape[0]
        nr = -(-size // m)
        solve = solve_engine_fn(engine, m)
        row = {"phase": "reference", "workload": workload, "engine": engine,
               "n": size, "m": m, "k": k, "generator": gen, "dtype": dname}
        if dname in ("float64", "complex128"):
            piv_k, piv_p = [], []
            x_k, s_k = solve(a, b, probe=recording_probe(piv_k))
            x_p, s_p = solve(a, b, probe=recording_probe(piv_p, plain_probe))
            if a.is_complex():
                piv_i = []
                x_i, s_i = ops.block_jordan_invert(
                    a, block_size=m, global_scale=True,
                    probe=recording_probe(piv_i))
            else:
                x_i, s_i, st_i = ops.block_jordan_invert_inplace(
                    a, block_size=m, collect_stats=True)
                piv_i = st_i["pivot_block"].tolist()
            kappa = float(ops.condition_inf(a, x_i))
            limit = min(torch.finfo(dtype).eps * size * kappa, 0.05)
            row.update({
                "pivots_equal": piv_k == piv_p, "steps": len(piv_k),
                "singular": [bool(s_k), bool(s_p)], "kappa_inf": kappa,
                "rel_diff": float(ops.inf_norm(x_k - x_p)
                                  / ops.inf_norm(x_p)),
                "limit": limit})
            ok = (row["pivots_equal"] and len(piv_k) == nr
                  and row["rel_diff"] <= limit and not (s_k or s_p))
            if engine != "solve_spd":
                row["pivots_equal_to_invert"] = piv_k == piv_i
                ok = ok and row["pivots_equal_to_invert"] and not bool(s_i)
            del x_k, x_p, x_i
        else:
            picks = []
            _, singular = solve(a, b, probe=stepwise_probe(torch, picks))
            row.update({"stepwise": True, "steps": len(picks),
                        "pivots_equal": all(picks),
                        "singular": bool(singular)})
            ok = all(picks) and len(picks) == nr and not bool(singular)
        emit(row)
        del a, b
        torch.cuda.empty_cache()
        if not ok:
            raise AssertionError(f"the {workload} engine disagrees with "
                                 f"the plain probe: {row}")


def phase_reference_complex(torch):
    """The complex augmented engine at COMPLEX_STEPWISE_ROW with the kernels,
    step by step: on every superstep's candidate stack the plain probe
    (with the same global scale) picks the kernel's pivot, and the run is
    not singular.  Then the SMW update at UPDATE_REFERENCE_ROW on the card
    against the same update on the CPU: neither singular, the updated
    inverses within min(eps·n·κ∞, 0.05) of each other (κ∞ of the mutated
    matrix's inverse on the CPU)."""
    from tpu_jordan_torch.linalg import smw_update
    from tpu_jordan_torch.ops import (
        batched_block_inverse, block_jordan_invert,
        block_jordan_invert_inplace, condition_inf, generate, inf_norm,
        probe_blocks)
    from tpu_jordan_torch.ops.jordan_inplace import _select as select
    from tpu_jordan_torch.profile_solve import update_factors

    n, m, gen, dname = COMPLEX_STEPWISE_ROW
    picks = []

    def both(cands, eps, scale=None):
        invs, sing = probe_blocks(cands, eps, scale=scale)
        picks.append([int(select(i, s, 0)[1])
                      for i, s in (batched_block_inverse(cands, scale, eps),
                                   (invs, sing))])
        return invs, sing

    a = generate(gen, (n, n), getattr(torch, dname), device="cuda")
    _, singular = block_jordan_invert(a, block_size=m, global_scale=True,
                                      probe=both)
    row = {"phase": "reference", "engine": "augmented", "n": n, "m": m,
           "generator": gen, "dtype": dname, "stepwise": True,
           "steps": len(picks),
           "pivots_equal": all(p == k for p, k in picks),
           "singular": bool(singular)}
    emit(row)
    del a
    torch.cuda.empty_cache()
    if not (row["pivots_equal"] and row["steps"] == -(-n // m)
            and not row["singular"]):
        raise AssertionError(f"kernel and plain probe disagree in the "
                             f"complex augmented engine: {row}")

    n, m, gen, dname, ranks = UPDATE_REFERENCE_ROW
    dtype = getattr(torch, dname)
    a = generate(gen, (n, n), dtype, device="cuda")
    inv = block_jordan_invert_inplace(a, block_size=m)[0]
    for k in ranks:
        u, v = update_factors(n, k, dtype)
        x_k, s_k = smw_update(inv, u, v)
        x_c, s_c = smw_update(inv.cpu(), u.cpu(), v.cpu())
        kappa = float(condition_inf((a + u @ v.T).cpu(), x_c))
        rel = float(inf_norm(x_k.cpu() - x_c) / inf_norm(x_c))
        limit = min(torch.finfo(dtype).eps * n * kappa, 0.05)
        row = {"phase": "reference", "engine": "smw_update", "n": n,
               "m": m, "k": k, "generator": gen, "dtype": dname,
               "against": "cpu", "singular": [bool(s_k), bool(s_c)],
               "kappa_inf": kappa, "rel_diff": rel, "limit": limit}
        emit(row)
        if not (rel <= limit and not (bool(s_k) or bool(s_c))):
            raise AssertionError(f"the SMW update on the card disagrees "
                                 f"with the CPU's: {row}")
    del a, inv
    torch.cuda.empty_cache()


class BodyCounter:
    """The launch count of one complex body of ``csrc/gj_probe.cu``
    (``gj_probe.complex_launches``), with a module counter's interface."""

    def __init__(self, mod, body: str):
        self.mod, self.body = mod, body

    @property
    def launches(self) -> int:
        return self.mod.complex_launches[self.body]

    def reset_launches(self) -> None:
        self.mod.reset_launches()


def launch_counters() -> dict:
    """The launch counters of the main path's kernels, by kernel name."""
    from tpu_jordan_torch.ops import fused_update as update_mod
    from tpu_jordan_torch.ops import gj_fused_panel as panel_mod
    from tpu_jordan_torch.ops import gj_probe as probe_mod

    return {"gj_probe_fused_panel": panel_mod, "gj_probe": probe_mod,
            "fused_update": update_mod,
            **{f"gj_probe[{b}]": BodyCounter(probe_mod, b)
               for b in probe_mod.COMPLEX_BODIES.values()}}


def expected_launches(torch, counters, n: int, m: int, dtype, engine: str,
                      group: int, runs: int = 1) -> dict:
    """The launches of ``runs`` engine runs of driver.solve at (n, m):
    Nr probe calls of the body the route picks (gj_probe.cu for the
    augmented engine's global scale on a real dtype), and for the
    fused-update engines ceil(Nr/k) group closes."""
    from tpu_jordan_torch.driver import PALLAS_ENGINES
    from tpu_jordan_torch.ops import gj_probe as probe_mod

    nr = -(-n // m)
    expected = dict.fromkeys(counters, 0)
    if engine in PALLAS_ENGINES:
        expected["fused_update"] = -(-nr // group) * runs
    body = ("gj_probe" if engine == "augmented" and not dtype.is_complex
            else probe_mod.probe_body(m, dtype))
    expected[body] = nr * runs
    return expected


def phase_solve(torch):
    """The main path: every SOLVE_ROWS row through driver.solve, warm.
    Each row runs with both kernels' counts set to 0 just before it and
    read just after; returns the counts summed over the rows."""
    from tpu_jordan_torch.driver import solve
    from tpu_jordan_torch.resilience import DEFAULT_POLICY, gate_threshold

    # Warm runs first (kernel loading, cuBLAS handles, the allocator).
    for n, m, gen, dname, engine in SOLVE_ROWS:
        solve(n, m, generator=gen, dtype=dname, engine=engine,
              device="cuda")
        torch.cuda.empty_cache()
    counters = launch_counters()
    totals = dict.fromkeys(counters, 0)
    for n, m, gen, dname, engine in SOLVE_ROWS:
        eps = float(torch.finfo(getattr(torch, dname)).eps)
        for mod in counters.values():
            mod.reset_launches()
        wall0 = time.perf_counter()
        res = solve(n, m, generator=gen, dtype=dname, engine=engine,
                    device="cuda")
        wall = time.perf_counter() - wall0
        launches = {name: mod.launches for name, mod in counters.items()}
        # The engine ran once, and once more for a re-solve rung.
        runs = 1 + sum(r["rung"] == "resolve" for r in res.recovery)
        nr = -(-n // m)
        expected = expected_launches(torch, counters, n, m,
                                     getattr(torch, dname), res.engine,
                                     res.group, runs)
        if engine == "grouped_pallas_bf16":
            # The driver's own gate: bf16 eps for the bf16 result, fp32
            # for a refined or re-solved one.
            gate = gate_threshold(DEFAULT_POLICY, n, res.kappa,
                                  "float32" if res.recovery else "bfloat16")
            expect = LADDER_EXPECT[gen]
            ladder_ok = (res.recovery == () if expect == "no_rungs"
                         else bool(res.recovery)
                         and res.recovery[-1]["passed"])
        else:
            gate = min(3.0 * eps * n * res.kappa / res._norm_a, 0.5)
            expect, ladder_ok = "no_rungs", res.recovery == ()
        row = {"phase": "solve", "n": n, "m": m, "generator": gen,
               "dtype": dname, "engine": res.engine,
               "group": res.group, "seconds": res.elapsed,
               "gflops": res.gflops, "wall_s": wall,
               "rel_residual": res.rel_residual, "kappa_inf": res.kappa,
               "gate": gate, "recovery": list(res.recovery),
               "ladder_expected": expect, "supersteps": nr,
               "launches": launches, "expected_launches": expected,
               "finite": bool(torch.isfinite(res.inverse).all()),
               "shape": list(res.inverse.shape)}
        emit(row)
        SOLVE_SECONDS[(n, m, gen, dname, engine)] = res.elapsed
        del res
        torch.cuda.empty_cache()
        if not (row["rel_residual"] < gate and launches == expected
                and ladder_ok and row["finite"] and row["shape"] == [n, n]):
            raise AssertionError(f"solve failed its checks: {row}")
        for name in totals:
            totals[name] += launches[name]
    for phase in (phase_solve_batch, phase_solve_lookahead,
                  phase_solve_workloads, phase_solve_update):
        for name, count in phase(torch, counters).items():
            totals[name] += count
    return totals


def phase_solve_lookahead(torch, counters):
    """The lookahead engines' path: every LOOKAHEAD_ROWS row through
    driver.solve(engine="lookahead"), warm, with the kernels' counts set to
    0 just before the timed run and read just after: probe launches = Nr of
    the routed body, no update launch, the gate min(3·eps·n·κ∞/‖A‖∞, 0.5)
    of the auto rows.  Returns the counts summed over the rows."""
    from tpu_jordan_torch.driver import solve
    from tpu_jordan_torch.ops import gj_probe as probe_mod

    totals = dict.fromkeys(counters, 0)
    for n, m, gen, dname, group in LOOKAHEAD_ROWS:
        eps = float(torch.finfo(getattr(torch, dname)).eps)
        solve(n, m, generator=gen, dtype=dname, engine="lookahead",
              group=group, device="cuda")
        torch.cuda.empty_cache()
        for mod in counters.values():
            mod.reset_launches()
        wall0 = time.perf_counter()
        res = solve(n, m, generator=gen, dtype=dname, engine="lookahead",
                    group=group, device="cuda")
        wall = time.perf_counter() - wall0
        launches = {name: mod.launches for name, mod in counters.items()}
        nr = -(-n // m)
        expected = dict.fromkeys(counters, 0)
        expected[probe_mod.probe_body(m)] = nr
        gate = min(3.0 * eps * n * res.kappa / res._norm_a, 0.5)
        row = {"phase": "solve", "n": n, "m": m, "generator": gen,
               "dtype": dname, "engine": res.engine, "group": res.group,
               "seconds": res.elapsed, "gflops": res.gflops, "wall_s": wall,
               "rel_residual": res.rel_residual, "kappa_inf": res.kappa,
               "gate": gate, "supersteps": nr, "launches": launches,
               "expected_launches": expected,
               "finite": bool(torch.isfinite(res.inverse).all()),
               "shape": list(res.inverse.shape)}
        emit(row)
        del res
        torch.cuda.empty_cache()
        if not (row["rel_residual"] < gate and launches == expected
                and row["finite"] and row["shape"] == [n, n]
                and row["engine"] == "lookahead" and row["group"] == group):
            raise AssertionError(f"lookahead solve failed its checks: {row}")
        totals = {name: totals[name] + launches[name] for name in totals}
    return totals


def phase_solve_workloads(torch, counters):
    """The solve workloads' path: every WORKLOAD_ROWS row through
    linalg.solve_system / linalg.lstsq with engine="auto", warm, with the
    kernels' counts set to 0 just before the timed run and read just after:
    the row's engine, probe launches = Nr of the solved
    system (of the routed body; the spd path probes a stack of one), no
    update launch, the backward error under
    ``solve_gate_threshold(DEFAULT_POLICY, n, dtype)``, no ladder rung, X
    finite of shape (n, K).  Returns the counts summed over the rows."""
    from tpu_jordan_torch.linalg import lstsq, solve_system
    from tpu_jordan_torch.ops import gj_probe as probe_mod
    from tpu_jordan_torch.resilience import (DEFAULT_POLICY,
                                             solve_gate_threshold)

    totals = dict.fromkeys(counters, 0)
    for n, m, gen, dname, workload, k, engine in (WORKLOAD_ROWS
                                                  + COMPLEX_WORKLOAD_ROWS):
        dtype = getattr(torch, dname)
        a, b = workload_inputs(torch, n, gen, dtype, workload, k)

        def run():
            if workload == "lstsq":
                return lstsq(a, b, block_size=m, device="cuda")
            return solve_system(a, b, block_size=m, device="cuda",
                                assume="spd" if workload == "spd"
                                else "general")
        run()
        torch.cuda.empty_cache()
        for mod in counters.values():
            mod.reset_launches()
        wall0 = time.perf_counter()
        out = run()
        wall = time.perf_counter() - wall0
        launches = {name: mod.launches for name, mod in counters.items()}
        res = out.inner if workload == "lstsq" else out
        nr = -(-res.n // m)
        expected = dict.fromkeys(counters, 0)
        expected[probe_mod.probe_body(m, dtype)] = nr
        gate = solve_gate_threshold(DEFAULT_POLICY, res.n, dtype)
        row = {"phase": "solve", "workload": workload, "n": n, "m": m,
               "k": k, "generator": gen, "dtype": dname,
               "engine": res.engine, "system_n": res.n,
               "seconds": res.elapsed, "gflops": res.gflops, "wall_s": wall,
               "rel_residual": res.rel_residual, "gate": gate,
               "kappa_est": res.kappa_est, "recovery": list(res.recovery),
               "supersteps": nr, "launches": launches,
               "expected_launches": expected,
               "finite": bool(torch.isfinite(out.x).all()),
               "shape": list(out.x.shape)}
        if workload == "lstsq":
            row.update({"lstsq_residual": out.residual,
                        "rank_deficient": out.rank_deficient})
        emit(row)
        del out, res, a, b
        torch.cuda.empty_cache()
        if not (row["rel_residual"] < gate and launches == expected
                and row["engine"] == engine and row["recovery"] == []
                and row["finite"] and row["shape"] == [row["system_n"], k]):
            raise AssertionError(f"{workload} failed its checks: {row}")
        totals = {name: totals[name] + launches[name] for name in totals}
    return totals


def phase_solve_update(torch, counters):
    """The update path at UPDATE_ROW: the resident inverse of the row's
    matrix from the in-place engine (its warm time is the fresh invert's),
    then ``linalg.solve_update`` at each rank with the kernels' counts set
    to 0 just before the timed update and read just after: the capacitance
    solve's probe launches = its Nr of the body its m routes to (m = 8:
    ``gj_probe``; m = 16: ``gj_probe_fused_panel``), the update's
    rel_residual under the update gate ``gate_threshold(DEFAULT_POLICY, n,
    κ∞, dtype)`` with no ladder rung, the result finite.  Then `chained`
    rank-16 updates under the default policy, each on the last one's
    matrix and inverse with its drift threaded through: the drift within
    the budget (``drift_budget``) and no rung walked.  Returns the counts
    summed over the timed updates."""
    from tpu_jordan_torch.config import default_block_size
    from tpu_jordan_torch.linalg import drift_budget, smw_update, solve_update
    from tpu_jordan_torch.ops import block_jordan_invert_inplace, generate
    from tpu_jordan_torch.ops import gj_probe as probe_mod
    from tpu_jordan_torch.profile_solve import update_factors
    from tpu_jordan_torch.resilience import DEFAULT_POLICY, gate_threshold

    n, m, gen, dname, ranks, chained = UPDATE_ROW
    dtype = getattr(torch, dname)
    a = generate(gen, (n, n), dtype, device="cuda")
    fresh_ms = cuda_ms(torch, lambda: block_jordan_invert_inplace(
        a, block_size=m), 1)
    inv, singular = block_jordan_invert_inplace(a, block_size=m)
    if bool(singular):
        raise AssertionError("the resident inverse of the update row is "
                             "singular")
    totals = dict.fromkeys(counters, 0)
    for k in ranks:
        u, v = update_factors(n, k, dtype)
        solve_update(a, inv, u, v, device="cuda")
        for mod in counters.values():
            mod.reset_launches()
        res = solve_update(a, inv, u, v, device="cuda")
        launches = {name: mod.launches for name, mod in counters.items()}
        mk = min(default_block_size(k), k)
        body = probe_mod.probe_body(mk, dtype)
        expected = dict.fromkeys(counters, 0)
        expected[body] = -(-k // mk)
        gate = gate_threshold(DEFAULT_POLICY, n, res.kappa, dtype)
        row = {"phase": "solve", "workload": "update", "n": n, "m": m,
               "k": k, "generator": gen, "dtype": dname,
               "engine": res.engine, "seconds": res.elapsed,
               "gflops": res.gflops, "fresh_invert_ms": fresh_ms,
               "smw_update_ms": cuda_ms(torch, lambda: smw_update(
                   inv, u, v), 3),
               "rel_residual": res.rel_residual, "kappa_inf": res.kappa,
               "gate": gate, "capacitance_m": mk,
               "capacitance_probe": body, "launches": launches,
               "expected_launches": expected,
               "finite": bool(torch.isfinite(res.inverse).all()),
               "shape": list(res.inverse.shape)}
        emit(row)
        del res
        if not (row["rel_residual"] < gate and launches == expected
                and row["finite"] and row["shape"] == [n, n]):
            raise AssertionError(f"update failed its checks: {row}")
        totals = {name: totals[name] + launches[name] for name in totals}
    cur_a, cur_inv, drift, rels = a, inv, 0.0, []
    for step in range(chained):
        u, v = update_factors(n, 16, dtype, step=step + 1)
        res = solve_update(cur_a, cur_inv, u, v, drift=drift,
                           policy=DEFAULT_POLICY, device="cuda")
        if res.recovery:
            raise AssertionError(f"chained update {step} walked the "
                                 f"ladder: {res.recovery}")
        cur_a, cur_inv, drift = res.a_new, res.inverse, res.drift
        rels.append(res.rel_residual)
    budget = drift_budget(gate_threshold(DEFAULT_POLICY, n, res.kappa,
                                         dtype))
    row = {"phase": "solve", "workload": "update", "n": n, "m": m,
           "k": 16, "chained": chained, "rel_residuals": rels,
           "drift": drift, "budget": budget}
    emit(row)
    del a, inv, cur_a, cur_inv, res
    torch.cuda.empty_cache()
    if not drift <= budget:
        raise AssertionError(f"the chained updates' drift passed its "
                             f"budget: {row}")
    return totals


def check_tool(tool: str, *paths, stdin: str | None = None) -> str:
    """Run ``tools/<tool>`` of the checkout on ``paths`` (or on ``stdin``
    with ``-``); raises unless it exits 0.  Returns its output."""
    args = [sys.executable, os.path.join(ROOT, "tools", tool)]
    args += list(paths) if paths else ["-"]
    out = subprocess.run(args, input=stdin, capture_output=True, text=True)
    if out.returncode != 0:
        raise AssertionError(f"{tool} exited {out.returncode}: "
                             f"{out.stdout}{out.stderr}")
    return out.stdout.strip()


def phase_telemetry(torch, counters):
    """Observability on the card, every row warm; each run with the
    kernels' counts set to 0 just before it and read just after.

    (a) TELEMETRY_ROW through ``driver.solve`` (inplace), untraced and
    with ``Telemetry()`` and ``numerics="trace"`` in turns: the untraced
    run launches what the solve phase's rows launch (Nr panel probes, no
    bracket), the traced one Nr records whose pivots equal an untraced
    engine run's (recorded by its probe), and ``elapsed == execute``'s
    duration exactly in both.  (b) TELEMETRY_PALLAS_ROW through
    ``grouped_pallas``, traced: measured phase children, and the probe and
    update counts rise by the brackets' 2 + 2 above the engine's Nr and
    ceil(Nr/k); the bracket walls are printed.  (c) the solve K=1 at
    TELEMETRY_ROW with ``numerics="trace"`` (Nr records) and the update
    k=16 with telemetry and ``numerics="summary"``.  (d) ``numerics_demo``
    at DEMO_CASES, each walking its listed rungs, each report through
    ``tools/check_numerics.py`` (an exhausted ladder raises
    ``ResidualGateError`` and leaves no report to check).  (e)
    the CLI at TELEMETRY_ROW with ``--numerics trace`` and every export,
    the Prometheus text and the Chrome trace through
    ``tools/check_telemetry.py``, the capacity report's device watermark
    available with a peak of at least A's bytes.  Returns the counts
    summed over the runs."""
    import tempfile

    from tpu_jordan_torch.__main__ import main as cli
    from tpu_jordan_torch.driver import solve
    from tpu_jordan_torch.linalg import solve_system, solve_update
    from tpu_jordan_torch.obs import Telemetry
    from tpu_jordan_torch.obs.numerics import numerics_demo
    from tpu_jordan_torch.ops import block_jordan_invert_inplace, generate
    from tpu_jordan_torch.ops import fused_update as update_mod
    from tpu_jordan_torch.ops import gj_probe as probe_mod
    from tpu_jordan_torch.profile_solve import update_factors
    from tpu_jordan_torch.resilience import ResidualGateError

    totals = dict.fromkeys(counters, 0)

    def counted(fn):
        for mod in counters.values():
            mod.reset_launches()
        out = fn()
        got = {name: mod.launches for name, mod in counters.items()}
        for name in totals:
            totals[name] += got[name]
        return out, got

    def elapsed_is_execute(res):
        return res.trace is None or res.elapsed == res.trace.find(
            "execute").duration

    # (a) traced and untraced in turns.
    n, m, gen, dname = TELEMETRY_ROW
    nr = -(-n // m)
    body = probe_mod.probe_body(m, getattr(torch, dname))
    expected = dict.fromkeys(counters, 0)
    expected[body] = nr
    solve(n, m, generator=gen, dtype=dname, engine="inplace",
          device="cuda", numerics="trace", telemetry=Telemetry())
    a = generate(gen, (n, n), getattr(torch, dname), device="cuda")
    picks = []
    block_jordan_invert_inplace(a, block_size=m,
                                probe=recording_probe(picks))
    del a
    times = {"untraced": [], "traced": []}
    bad = []
    for _ in range(TELEMETRY_TURNS):
        for mode in ("untraced", "traced"):
            kw = ({"telemetry": Telemetry(), "numerics": "trace"}
                  if mode == "traced" else {})
            res, got = counted(lambda: solve(
                n, m, generator=gen, dtype=dname, engine="inplace",
                device="cuda", **kw))
            times[mode].append(res.elapsed)
            rep = res.numerics
            ok = (got == expected and elapsed_is_execute(res)
                  and (mode == "untraced" or (
                      len(rep.pivot_block) == nr
                      and rep.pivot_block == picks
                      and res.trace.find("pivot").attrs.get("modeled"))))
            if not ok:
                bad.append({"mode": mode, "launches": got,
                            "pivots": rep and rep.pivot_block})
            del res
    torch.cuda.empty_cache()
    med = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
    emit({"phase": "telemetry", "row": "trace_cost", "n": n, "m": m,
          "generator": gen, "dtype": dname, "engine": "inplace",
          "seconds": times, "median_s": med,
          "trace_cost_ms": (med["traced"] - med["untraced"]) * 1e3,
          "pivots": picks, "launches_each": expected, "failures": bad})
    if bad:
        raise AssertionError(f"traced/untraced solves failed: {bad}")

    # (b) the fused engine's measured phases.
    n, m, gen, dname = TELEMETRY_PALLAS_ROW
    nr, k = -(-n // m), 2
    solve(n, m, generator=gen, dtype=dname, engine="grouped_pallas",
          device="cuda")
    update_mod._PHASE_CACHE.clear()
    res, got = counted(lambda: solve(
        n, m, generator=gen, dtype=dname, engine="grouped_pallas",
        device="cuda", telemetry=Telemetry(), numerics="trace"))
    body = probe_mod.probe_body(m, getattr(torch, dname))
    expected = dict.fromkeys(counters, 0)
    expected[body] = nr + 2
    expected["fused_update"] = -(-nr // k) + 2
    esp = res.trace.find("execute")
    phases = {c.name: dict(c.attrs) for c in esp.children}
    row = {"phase": "telemetry", "row": "measured_phases", "n": n, "m": m,
           "engine": res.engine, "seconds": res.elapsed,
           "phases": phases,
           "bracket_ms": {p: a["bracket_seconds"] * 1e3
                          for p, a in phases.items()
                          if "bracket_seconds" in a},
           "records": len(res.numerics.pivot_block),
           "rel_residual": res.rel_residual, "launches": got,
           "expected_launches": expected}
    emit(row)
    if not (got == expected and elapsed_is_execute(res)
            and len(phases) == 3 and row["records"] == nr
            and all(a.get("measured") and not a.get("modeled")
                    for a in phases.values())):
        raise AssertionError(f"measured phases failed their checks: {row}")
    del res
    torch.cuda.empty_cache()

    # (c) the solve and the update rows.
    n, m, gen, dname = TELEMETRY_ROW
    dtype = getattr(torch, dname)
    nr, body = -(-n // m), probe_mod.probe_body(m, dtype)
    a, b = workload_inputs(torch, n, gen, dtype, "solve", 1)
    solve_system(a, b, block_size=m, device="cuda", numerics="trace")
    out, got = counted(lambda: solve_system(
        a, b, block_size=m, device="cuda", numerics="trace",
        telemetry=Telemetry()))
    rows = [{"phase": "telemetry", "row": "solve", "n": n, "m": m, "k": 1,
             "engine": out.engine, "seconds": out.elapsed,
             "records": len(out.numerics.pivot_block),
             "rel_residual": out.rel_residual,
             "spans": [sp.name for sp in out.trace.walk()],
             "launches": got}]
    ok = (len(out.numerics.pivot_block) == nr and got[body] == nr
          and elapsed_is_execute(out))
    del out, b
    inv, _ = block_jordan_invert_inplace(a, block_size=m)
    u, v = update_factors(n, 16, dtype)
    tel = Telemetry()
    out, got = counted(lambda: solve_update(
        a, inv, u, v, device="cuda", telemetry=tel, numerics="summary"))
    upd = tel.find("solve_update")
    rows.append({"phase": "telemetry", "row": "update", "n": n, "k": 16,
                 "seconds": out.elapsed,
                 "numerics": out.numerics.to_json(),
                 "spans": [sp.name for sp in upd.walk()],
                 "launches": got})
    ok = ok and (out.numerics.mode == "summary"
                 and out.elapsed == upd.find("execute").duration
                 and got["gj_probe"] == 2)
    for r in rows:
        emit(r)
    del out, a, inv, u, v
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError(f"traced solve or update failed: {rows}")

    # (d) the numerics demo.
    for dn, dm, decades, rungs in DEMO_CASES:
        t0 = time.perf_counter()

        def demo():
            try:
                return numerics_demo(n=dn, block_size=dm,
                                     kappa_decades=decades, device="cuda")
            except ResidualGateError as e:
                return {"engine": None, "recovery": list(e.recovery),
                        "spike_count": None, "rung_count": None}

        report, got = counted(demo)
        verdict = (check_tool("check_numerics.py", stdin=json.dumps(report))
                   if report["engine"] is not None else None)
        walked = tuple((r["rung"], r["passed"]) for r in report["recovery"])
        row = {"phase": "telemetry", "row": "numerics_demo", "n": dn,
               "m": dm, "kappa_decades": decades, "engine": report["engine"],
               "recovery": report["recovery"],
               "spike_count": report["spike_count"],
               "rung_count": report["rung_count"],
               "check_numerics": verdict, "launches": got,
               "wall_s": time.perf_counter() - t0}
        emit(row)
        if walked != rungs:
            raise AssertionError(
                f"numerics_demo walked {walked}, expected {rungs}: {row}")

    # (e) the CLI with every export.
    n, m, gen, dname = TELEMETRY_ROW
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        paths = {k: os.path.join(tmp, k) for k in (
            "metrics.prom", "trace.json", "capacity.json", "blackbox.json")}
        rc, got = counted(lambda: cli([
            str(n), str(m), "--generator", gen, "--numerics", "trace",
            "--trace-json", paths["trace.json"],
            "--metrics-out", paths["metrics.prom"],
            "--capacity-report", paths["capacity.json"],
            "--blackbox-out", paths["blackbox.json"]]))
        verdict = check_tool("check_telemetry.py", paths["metrics.prom"],
                             paths["trace.json"])
        with open(paths["capacity.json"]) as f:
            device = json.load(f)["components"]["device"]
        with open(paths["blackbox.json"]) as f:
            blackbox = json.load(f)
    row = {"phase": "telemetry", "row": "cli", "n": n, "m": m, "rc": rc,
           "check_telemetry": verdict, "device_capacity": device,
           "blackbox_events": blackbox["recorded_total"],
           "launches": got}
    emit(row)
    if not (rc == 0 and device.get("available")
            and device.get("peak_bytes_in_use", 0) >= n * n * 4
            and blackbox.get("metric") == "blackbox"
            and got[probe_mod.probe_body(m, getattr(torch, dname))] == nr):
        raise AssertionError(f"the CLI's exports failed their checks: {row}")
    return totals


def phase_tune(torch):
    """The tuner on the card.  Prints the point 8192/m384 fp32 as the card
    makes it (its plan key must begin with ``cuda-h100|``); the cost-only
    pick at every AUTO_ROWS row with each candidate's projected seconds
    and the JAX package's pick beside it (the card's ranking must equal
    the CPU's: one model); then at every TUNE_POINTS point a measured
    tuning run (``tuning.Tuner``, the point's survivors, TUNE_SAMPLES
    timed calls each) into one temporary plan cache, with every trial and
    the kernels' launches over the run (probe launches > 0; at 8192/m128
    the fused update's too), and the winner through the entry point twice
    with the same cache
    (``driver.solve`` or ``linalg.solve_system`` with ``engine="auto"``,
    first with ``tune=True``, then with the cache alone): zero
    measurements, the plan's engine, the launches of one run of it, the
    row's gate; last, the shared cache holds one plan a point, each the
    point's own winner.  Returns the launch counts summed over the
    phase."""
    import math
    import tempfile

    from tpu_jordan_torch.driver import solve
    from tpu_jordan_torch.linalg import solve_system
    from tpu_jordan_torch.ops import gj_probe as probe_mod
    from tpu_jordan_torch.resilience import (DEFAULT_POLICY, gate_threshold,
                                             solve_gate_threshold)
    from tpu_jordan_torch.tuning import (PlanCache, Tuner, TunePoint,
                                         candidates, plan_key,
                                         select_by_cost)
    from tpu_jordan_torch.tuning.tuner import _M_MEASUREMENTS

    point = TunePoint.create(8192, 384, "float32", device="cuda")
    row = {"phase": "tune", "step": "point", "backend": point.backend,
           "chip": point.chip, "plan_key": plan_key(point)}
    emit(row)
    if not row["plan_key"].startswith("cuda-h100|"):
        raise AssertionError(f"the card's point is not an H100 one: {row}")
    for n, m, dname, workload, jax_pick in AUTO_ROWS:
        p = TunePoint.create(n, m, dname, workload=workload, device="cuda")
        pick = select_by_cost(p).name
        row = {"phase": "tune", "step": "cost_only", "n": n, "m": m,
               "dtype": dname, "workload": workload, "pick": pick,
               "jax_pick": jax_pick, "differs": pick != jax_pick,
               "projected_s": {c.name: (None if math.isinf(c.cost(p))
                                        else c.cost(p))
                               for c in candidates(p)}}
        emit(row)
        cpu = TunePoint.create(n, m, dname, workload=workload, device="cpu")
        cpu_pick = select_by_cost(cpu).name
        expect = CARD_ONLY_PICKS.get((n, m, dname, workload),
                                     (cpu_pick, cpu_pick))
        if (pick, cpu_pick) != expect:
            raise AssertionError(f"the card's pick against the CPU's "
                                 f"({cpu_pick}) is not {expect}: {row}")

    counters = launch_counters()
    totals = dict.fromkeys(counters, 0)

    def reset():
        for mod in counters.values():
            mod.reset_launches()

    def read():
        counts = {name: mod.launches for name, mod in counters.items()}
        for name in totals:
            totals[name] += counts[name]
        return counts

    # A card-only pick through the entry point: the bf16 fused engine on
    # kms (κ∞ ≈ 2.8), under the driver's own gate at bf16 eps, no rung.
    for (n, m, dname, workload), (card_pick, _) in CARD_ONLY_PICKS.items():
        for counted in (False, True):       # a warm run first
            reset()
            res = solve(n, m, generator="kms", dtype=dname, engine="auto",
                        device="cuda")
        launches = read()
        expected = expected_launches(torch, counters, n, m, torch.float32,
                                     res.engine, res.group)
        row = {"phase": "tune", "step": "card_only_pick", "n": n, "m": m,
               "generator": "kms", "dtype": dname, "engine": res.engine,
               "plan_source": res.plan.source, "seconds": res.elapsed,
               "rel_residual": res.rel_residual,
               "gate": gate_threshold(DEFAULT_POLICY, n, res.kappa, dname),
               "recovery": list(res.recovery), "launches": launches,
               "expected_launches": expected,
               "finite": bool(torch.isfinite(res.inverse.float()).all())}
        emit(row)
        del res
        torch.cuda.empty_cache()
        if not (row["engine"] == card_pick and launches == expected
                and row["rel_residual"] < row["gate"]
                and row["recovery"] == [] and row["finite"]):
            raise AssertionError(f"the card-only pick failed its "
                                 f"checks: {row}")

    with tempfile.TemporaryDirectory() as tmp:
        # One cache for every point: the card's keys carry the block
        # size, so 8192/m384 and 8192/m128 each keep a plan of their own.
        path = os.path.join(tmp, "plans.json")
        winners = {}
        for n, m, gen, dname, workload, survivors in TUNE_POINTS:
            dtype = getattr(torch, dname)
            p = TunePoint.create(n, m, dname, workload=workload,
                                 device="cuda")
            finite = [c.name for c in candidates(p)
                      if not math.isinf(c.cost(p))]
            tuner = Tuner(cache=PlanCache.load(path), measure=True,
                          survivors=survivors, samples=TUNE_SAMPLES)
            reset()
            t0 = time.perf_counter()
            plan = tuner.select(p)
            tune_s = time.perf_counter() - t0
            launches = read()
            row = {"phase": "tune", "step": "measured", "n": n, "m": m,
                   "generator": "rand", "dtype": dname,
                   "workload": workload, "survivors": survivors,
                   "samples": TUNE_SAMPLES, "trials": list(plan.trials),
                   "winner": plan.config, "engine": plan.engine,
                   "group": plan.group, "seconds": plan.seconds,
                   "drift": plan.drift,
                   "variance_flag": plan.variance_flag,
                   "measurements": tuner.measurements, "tune_s": tune_s,
                   "launches": launches}
            emit(row)
            probes = sum(v for k, v in launches.items()
                         if k != "fused_update")
            measured = [t["config"] for t in plan.trials]
            fused_ok = ((n, m) != (8192, 128)
                        or ("grouped_pallas" in measured
                            and launches["fused_update"] > 0))
            if not (plan.source == "measured" and probes > 0 and fused_ok
                    and tuner.measurements == min(survivors, len(finite))
                    and measured == finite[:survivors]):
                raise AssertionError(f"tuning failed its checks: {row}")
            winners[plan_key(p)] = plan

            for tune in (True, False):
                before = _M_MEASUREMENTS.total()
                reset()
                if workload == "invert":
                    res = solve(n, m, generator=gen, dtype=dname,
                                engine="auto", tune=tune, plan_cache=path,
                                device="cuda")
                    eps = float(torch.finfo(dtype).eps)
                    gate = min(3.0 * eps * n * res.kappa / res._norm_a, 0.5)
                    out = res.inverse
                    expected = expected_launches(torch, counters, n, m,
                                                 dtype, res.engine,
                                                 res.group)
                else:
                    a, b = workload_inputs(torch, n, gen, dtype, "solve", 1)
                    res = solve_system(a, b, block_size=m, tune=tune,
                                       plan_cache=path, device="cuda")
                    gate = solve_gate_threshold(DEFAULT_POLICY, n, dtype)
                    out = res.x
                    expected = dict.fromkeys(counters, 0)
                    expected[probe_mod.probe_body(m, dtype)] = -(-n // m)
                    del a, b
                launches = read()
                row = {"phase": "tune", "step": "winner" if tune else "warm",
                       "n": n, "m": m, "generator": gen, "dtype": dname,
                       "workload": workload, "tune": tune,
                       "engine": res.engine,
                       "plan_source": res.plan.source,
                       "measurements": _M_MEASUREMENTS.total() - before,
                       "seconds": res.elapsed,
                       "rel_residual": res.rel_residual, "gate": gate,
                       "recovery": list(res.recovery),
                       "launches": launches, "expected_launches": expected,
                       "finite": bool(torch.isfinite(out).all())}
                emit(row)
                del res, out
                torch.cuda.empty_cache()
                if not (row["measurements"] == 0
                        and row["engine"] == plan.engine
                        and row["plan_source"] == "measured"
                        and launches == expected and row["finite"]
                        and row["rel_residual"] < gate
                        and row["recovery"] == []):
                    raise AssertionError(
                        f"the tuned solve failed its checks: {row}")
        plans = {k: (v.config, v.seconds)
                 for k, v in PlanCache.load(path).plans.items()}
        row = {"phase": "tune", "step": "shared_cache", "plans": plans}
        emit(row)
        if (plans != {k: (v.config, v.seconds) for k, v in winners.items()}
                or len(plans) != len(TUNE_POINTS)):
            raise AssertionError(f"the shared cache does not hold each "
                                 f"point's own plan: {row}")
    return totals


def phase_resilience(torch, counters):
    """The resilience layer on the card, at RESILIENCE_ROW unless said;
    each engine run with the kernels' counts set to 0 just before it and
    read just after.  (1) Two monolithic in-place runs must be bit-equal
    (``torch.equal``): every bit-match below rests on it.  (2) A transient
    ``execute`` fault, then a transient ``compile`` fault, each retried
    under a policy to an inverse bit-equal to the clean solve.  (3) A
    ``result_corrupt_nan`` injection fails the gate and the ladder
    recovers on its ``resolve`` rung (bit-equal to the clean solve).  (4)
    An unplanned, untraced solve of the solve phase's grouped row launches
    what that row launched; its time is printed beside the row's.  (5)
    ``checkpointed_invert`` (``unrolled`` and ``grouped`` k=CKPT_GROUP,
    cadence CKPT_CADENCE): bit-equal to the monolithic engine; a
    ``preempt`` at the second boundary raises PreemptedError at the
    durable step 16; the resume is bit-equal, runs [(16, Nr)] with no new
    segment; the ledger invariant holds; probe launches = the supersteps
    run.  ``checkpointed_solve`` K=1 and the 1000/m50 invert the same way.
    Prints the bytes of a checkpoint, the seconds of one write (the copy to
    the host, then npz, sha256 and the file) and each checkpointed run's
    wall against the monolithic run's.  (6) The CLI: ``--sleep 1`` and
    ``--precision highest`` exit 0, ``--precision high`` exits 1.  Returns
    the counts summed over the runs."""
    import contextlib
    import io
    import tempfile

    from tpu_jordan_torch.__main__ import main as cli
    from tpu_jordan_torch.driver import solve
    from tpu_jordan_torch.linalg import block_jordan_solve
    from tpu_jordan_torch.ops import (block_jordan_invert_inplace,
                                      block_jordan_invert_inplace_grouped,
                                      generate, pad_with_identity)
    from tpu_jordan_torch.ops import gj_probe as probe_mod
    from tpu_jordan_torch.resilience import (
        CheckpointKey, CheckpointStore, FaultPlan, FaultSpec,
        PreemptedError, ResiliencePolicy, RetryPolicy, activate,
        checkpointed_invert, checkpointed_solve)
    from tpu_jordan_torch.resilience import checkpoint as ckpt_mod

    totals = dict.fromkeys(counters, 0)

    def counted(fn):
        for mod in counters.values():
            mod.reset_launches()
        try:
            return fn()
        finally:
            for name in totals:
                counted.last[name] = counters[name].launches
                totals[name] += counted.last[name]

    counted.last = {}

    def walled(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def only(body, count):
        want = dict.fromkeys(counters, 0)
        want[body] = count
        return counted.last == want

    n, m, gen, dname = RESILIENCE_ROW
    dtype = getattr(torch, dname)
    nr, body = -(-n // m), probe_mod.probe_body(m, dtype)
    failures = []

    # (1) determinism of the monolithic engine.
    a = generate(gen, (n, n), dtype, device="cuda")
    x1, _ = block_jordan_invert_inplace(a, block_size=m)
    x2, _ = block_jordan_invert_inplace(a, block_size=m)
    same = bool(torch.equal(x1, x2))
    emit({"phase": "resilience", "check": "determinism", "n": n, "m": m,
          "generator": gen, "dtype": dname, "bit_equal": same})
    if not same:
        raise AssertionError("two monolithic in-place runs differ: the "
                             "bit-match checks below have no footing")
    del x2

    # (2) retries and (3) corruption, through driver.solve.
    clean = solve(n, m, generator=gen, dtype=dname, engine="inplace",
                  device="cuda")
    if not torch.equal(clean.inverse, x1):
        failures.append("driver.solve's inverse is not the engine's")
    pol = ResiliencePolicy(retry=RetryPolicy(max_retries=2, backoff_s=0.0))
    for point, mode, runs in (("execute", "transient", 1),
                              ("compile", "transient", 1),
                              ("result_corrupt_nan", "corrupt", 2)):
        plan = FaultPlan([FaultSpec(point, (1,), mode)])
        with activate(plan):
            res = counted(lambda: solve(n, m, generator=gen, dtype=dname,
                                        engine="inplace", policy=pol,
                                        device="cuda"))
        rungs = [r["rung"] for r in res.recovery]
        row = {"phase": "resilience", "check": point, "mode": mode,
               "injections": plan.injections, "calls": plan.calls(),
               "recovery": list(res.recovery),
               "rel_residual": res.rel_residual,
               "bit_equal_clean": bool(torch.equal(res.inverse,
                                                   clean.inverse)),
               "launches": dict(counted.last), "seconds": res.elapsed}
        emit(row)
        ok = (plan.injected_total == 1 and row["bit_equal_clean"]
              and only(body, nr * runs)
              and (rungs == ["refine", "resolve"]
                   and res.recovery[-1]["passed"]
                   and not res.recovery[0]["passed"]
                   if mode == "corrupt" else rungs == []))
        if not ok:
            failures.append(row)
        del res
    del clean
    torch.cuda.empty_cache()

    # (4) the unplanned, untraced solve of the solve phase's row.
    res = counted(lambda: solve(n, m, generator=gen, dtype=dname,
                                engine="grouped", device="cuda"))
    row = {"phase": "resilience", "check": "no_plan", "n": n, "m": m,
           "engine": res.engine, "group": res.group,
           "seconds": res.elapsed,
           "solve_phase_seconds": SOLVE_SECONDS.get(
               (n, m, gen, dname, "grouped")),
           "launches": dict(counted.last)}
    emit(row)
    if not only(body, nr):
        failures.append(row)
    del res

    # (5) checkpoint/resume.
    nbytes = write_s = None
    with tempfile.TemporaryDirectory() as root:
        store = CheckpointStore(root)
        kw = dict(store=store, cadence=CKPT_CADENCE, group=CKPT_GROUP,
                  device="cuda")
        cases = (
            ("unrolled", a, m, body, nr,
             lambda: block_jordan_invert_inplace(a, block_size=m)),
            ("grouped", a, m, body, nr,
             lambda: block_jordan_invert_inplace_grouped(
                 a, block_size=m, group=CKPT_GROUP)))
        sn, sm, sgen, sdname = CKPT_SMALL_ROW
        small = generate(sgen, (sn, sn), getattr(torch, sdname),
                         device="cuda")
        snr = -(-sn // sm)
        cases += (("unrolled", small, sm,
                   probe_mod.probe_body(sm, small.dtype), snr,
                   lambda: block_jordan_invert_inplace(small,
                                                       block_size=sm)),)
        for engine, mat, bm, pbody, steps, mono in cases:
            run = f"smoke:{engine}:{mat.shape[0]}"
            # The preempt fires at the third segment's start, after the
            # second boundary's write.
            tail = (2 * CKPT_CADENCE, steps)
            (ref, _), mono_s = walled(mono)
            (inv, sing, info), ck_s = walled(lambda: counted(
                lambda: checkpointed_invert(mat, bm, run_id=run,
                                            engine=engine, **kw)))
            fresh = dict(counted.last)
            ok = (bool(torch.equal(inv, ref)) and not sing
                  and only(pbody, steps) and info["ckpt_written"] == 2)
            with activate(FaultPlan([FaultSpec("preempt", (3,),
                                               "permanent")])):
                try:
                    counted(lambda: checkpointed_invert(
                        mat, bm, run_id=run + ":p", engine=engine, **kw))
                    step = None
                except PreemptedError as e:
                    step = e.step
            (inv2, _, info2), resume_s = walled(lambda: counted(
                lambda: checkpointed_invert(
                    mat, bm, run_id=run + ":p", engine=engine,
                    resume_from=run + ":p", **kw)))
            ok = (ok and step == tail[0] and bool(torch.equal(inv2, ref))
                  and info2["segments_run"] == [tail]
                  and info2["segment_compiles"] == 0
                  and only(pbody, tail[1] - tail[0])
                  and store.ledger()["invariant_holds"])
            row = {"phase": "resilience", "check": "checkpoint",
                   "workload": "invert", "engine": engine,
                   "n": int(mat.shape[0]), "m": bm, "cadence": info["cadence"],
                   "bit_equal": bool(torch.equal(inv, ref)),
                   "preempted_at": step, "resume": info2["segments_run"],
                   "resume_bit_equal": bool(torch.equal(inv2, ref)),
                   "segment_compiles": info2["segment_compiles"],
                   "launches": fresh, "resume_launches": dict(counted.last),
                   "ckpt_bytes": info["ckpt_bytes_last"],
                   "ckpt_written": info["ckpt_written"],
                   "monolithic_s": mono_s, "checkpointed_s": ck_s,
                   "resume_s": resume_s, "ledger": store.ledger()}
            emit(row)
            if not ok:
                failures.append(row)
            del ref, inv, inv2
        del small

        # The solve, K = 1.
        b = generate("rand", (n, 1), dtype, row_offset=n, device="cuda")
        (ref, _), mono_s = walled(lambda: block_jordan_solve(
            a, b, block_size=m))
        (x, sing, info), ck_s = walled(lambda: counted(
            lambda: checkpointed_solve(a, b, m, run_id="smoke:solve",
                                       store=store, cadence=CKPT_CADENCE,
                                       device="cuda")))
        row = {"phase": "resilience", "check": "checkpoint",
               "workload": "solve", "n": n, "m": m, "k": 1,
               "bit_equal": bool(torch.equal(x, ref)),
               "launches": dict(counted.last),
               "ckpt_bytes": info["ckpt_bytes_last"],
               "ckpt_written": info["ckpt_written"],
               "monolithic_s": mono_s, "checkpointed_s": ck_s,
               "ledger": store.ledger()}
        emit(row)
        if not (row["bit_equal"] and not sing and only(body, nr)
                and info["ckpt_written"] == 2
                and row["ledger"]["invariant_holds"]):
            failures.append(row)
        del b, ref, x

        # One boundary's cost, split: the copy to the host, then the
        # store's npz, sha256 and file.
        state = {"V": pad_with_identity(a, nr * m),
                 "singular": torch.zeros((), dtype=torch.bool,
                                         device="cuda"),
                 "swaps": torch.zeros(nr, dtype=torch.int64,
                                      device="cuda")}
        key = CheckpointKey(run_id="smoke:write", workload="invert",
                            engine="unrolled", topology="single", n=n, m=m,
                            Nr=nr, dtype=dname, nrhs=0,
                            cadence=CKPT_CADENCE)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        host = ckpt_mod._state_to_host(state)
        t1 = time.perf_counter()
        nbytes = store.write(key, CKPT_CADENCE, host)
        t2 = time.perf_counter()
        store.discard("smoke:write")
        write_s = {"d2h_s": t1 - t0, "store_write_s": t2 - t1,
                   "total_s": t2 - t0}
        del state, host
    emit({"phase": "resilience", "check": "checkpoint_write", "n": n,
          "m": m, "dtype": dname, "bytes": nbytes, **write_s})
    del a, x1
    torch.cuda.empty_cache()

    # (6) the CLI flags.
    rcs = {}
    for flags in (["--sleep", "1"], ["--precision", "highest"],
                  ["--precision", "high"]):
        out = io.StringIO()
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(io.StringIO()):
            rcs[" ".join(flags)] = cli(["1000", "50", "--generator", "rand",
                                        *flags])
        if flags[0] == "--sleep" and "sleeping 1s" not in out.getvalue():
            failures.append({"cli": flags, "stdout": out.getvalue()})
    emit({"phase": "resilience", "check": "cli", "exit_codes": rcs})
    if rcs != {"--sleep 1": 0, "--precision highest": 0,
               "--precision high": 1}:
        failures.append({"cli": rcs})
    if failures:
        raise AssertionError(f"resilience failed its checks: {failures}")
    return totals


def phase_serve(torch, counters):
    """The serving core on the card (the module docstring's phase 9); each
    driven path with the kernels' counts set to 0 just before it and read
    just after.  Returns the counts summed over the paths."""
    import contextlib
    import io
    import statistics
    import tempfile

    from tpu_jordan_torch.__main__ import main as cli
    from tpu_jordan_torch.linalg import solve_system
    from tpu_jordan_torch.obs.metrics import REGISTRY
    from tpu_jordan_torch.obs.recorder import RECORDER
    from tpu_jordan_torch.ops import generate
    from tpu_jordan_torch.ops import gj_probe as probe_mod
    from tpu_jordan_torch.resilience import (DEFAULT_POLICY,
                                             solve_gate_threshold)
    from tpu_jordan_torch.serve import JordanService, chaos_demo

    totals = dict.fromkeys(counters, 0)
    failures = []

    def counted(fn):
        for mod in counters.values():
            mod.reset_launches()
        try:
            return fn()
        finally:
            counted.last = {k: counters[k].launches for k in totals}
            for k in totals:
                totals[k] += counted.last[k]

    def run_cli(args):
        out = io.StringIO()
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(io.StringIO()):
            rc = cli(args)
        lines = out.getvalue().strip().splitlines()
        return rc, (json.loads(lines[-1]) if rc == 0 and lines else None)

    # (1) the serve demo through the CLI, in each SERVE_DEMO_DTYPES dtype.
    n, m, requests, cap = SERVE_DEMO_ROW
    exec_hist = REGISTRY.histogram("tpu_jordan_torch_serve_execute_seconds")

    for dname in SERVE_DEMO_DTYPES:
        seen = {k: len(v.samples) for k, v in exec_hist.series().items()}
        spike_mark = RECORDER.total
        t0 = time.perf_counter()
        rc, rep = counted(lambda: run_cli([
            str(n), str(m), "--serve-demo", "--generator", "rand",
            "--dtype", dname, "--serve-requests", str(requests),
            "--batch-cap", str(cap), "--numerics", "summary"]))
        wall = time.perf_counter() - t0
        got = counted.last
        if rc != 0 or rep is None:
            raise AssertionError(f"--serve-demo --dtype {dname} exited {rc}")
        spikes = [e for e in RECORDER.since(spike_mark)
                  if e["kind"] == "numerics_spike"]
        want = dict.fromkeys(counters, 0)
        buckets = {}
        for lane, st in rep["stats"]["buckets"].items():
            mm = min(m, int(lane))
            nr = -(-int(lane) // mm)
            want[probe_mod.probe_body(mm, getattr(torch, dname))] += (
                st["batches"] * nr)
            samples = next((res.samples[seen.get(key, 0):]
                            for key, res in exec_hist.series().items()
                            if dict(key).get("bucket") == lane), [])
            buckets[lane] = {
                "requests": st["requests"], "batches": st["batches"],
                "mean_occupancy": st["mean_occupancy"], "nr": nr,
                "queue_ms": st["queue_ms"], "execute_ms": st["execute_ms"],
                "first_batch_ms": samples[0] * 1e3,
                "steady_median_ms": (statistics.median(samples[1:]) * 1e3
                                     if len(samples) > 1 else None)}
        emit({"phase": "serve", "check": "serve_demo", "n": n, "m": m,
              "dtype": dname, "requests": requests, "batch_cap": cap,
              "exit": rc,
              "compiles_on_request_path": rep["compiles_on_request_path"],
              "plan_cache_measurements": rep["plan_cache_measurements"],
              "worst_rel_residual": rep["worst_rel_residual"],
              "residual_spikes": [(e["value"], e["threshold"])
                                  for e in spikes],
              "elapsed_s": rep["elapsed_s"], "wall_s": wall,
              "requests_per_s": requests / rep["elapsed_s"],
              "device_memory": rep["device_memory"], "buckets": buckets,
              "launches": got, "expected": want})
        if rep["compiles_on_request_path"] or rep["plan_cache_measurements"]:
            failures.append(f"the warm serve path built or measured "
                            f"({dname})")
        if rep["singular"] or (spikes and dname != "float32"):
            failures.append({"dtype": dname, "residual_spikes": spikes[:3],
                             "singular": rep["singular"]})
        if got != want:
            failures.append({"serve_demo_launches": got, "expected": want,
                             "dtype": dname})

    # (2) the solve lanes, one request each.
    for n, m, gen, dname, k in SERVE_SOLVE_ROWS:
        dtype = getattr(torch, dname)
        a = generate(gen, (n, n), dtype, device="cpu")
        b = generate(gen, (n, k), dtype, row_offset=n, device="cpu")
        with JordanService(dtype=dtype, batch_cap=cap, block_size=m) as svc:
            svc.warmup(solve_shapes=[(n, k)])
            res = counted(lambda: svc.solve_system(a, b, timeout=600))
            got = counted.last
        direct = solve_system(a.cuda(), b.cuda(), block_size=m,
                              device="cuda")
        x, ref = res.solution, direct.x
        eps = torch.finfo(dtype).eps
        tol = min(16 * eps * n * res.kappa, 0.05)
        diff = float((x - ref).abs().sum(-1).max()
                     / ref.abs().sum(-1).max())
        gate = solve_gate_threshold(DEFAULT_POLICY, n, dtype)
        want = dict.fromkeys(counters, 0)
        want[probe_mod.probe_body(m, dtype)] = -(-n // m)
        emit({"phase": "serve", "check": "solve_lane", "n": n, "m": m,
              "generator": gen, "dtype": dname, "rhs": k,
              "rel_residual": res.rel_residual, "solve_gate": gate,
              "x_rel_diff": diff, "tolerance": tol,
              "execute_s": res.execute_seconds, "launches": got})
        if not res.rel_residual < gate or not diff <= tol or got != want:
            failures.append({"solve_lane": (n, dname), "launches": got,
                             "expected": want})
        del a, b, x, ref, direct
        torch.cuda.empty_cache()

    # (3) chaos on the card, then the CLI once.
    n, requests, cap = CHAOS_ROW
    with tempfile.TemporaryDirectory() as tmp:
        for seed in CHAOS_SEEDS:
            rep = counted(lambda: chaos_demo(n=n, requests=requests,
                                             batch_cap=cap, seed=seed))
            path = os.path.join(tmp, f"chaos{seed}.json")
            with open(path, "w") as f:
                json.dump(rep, f)
            verdict = check_tool("check_chaos.py", path)
            emit({"phase": "serve", "check": "chaos_demo", "n": n,
                  "requests": requests, "batch_cap": cap, "seed": seed,
                  "accounting": rep["accounting"],
                  "injected_by_point": rep["faults"]["injected_by_point"],
                  "matched_bitwise": rep["matched_bitwise"],
                  "mismatches": rep["mismatches"],
                  "elapsed_s": rep["elapsed_s"], "check_chaos": verdict,
                  "launches": counted.last})
            if rep["mismatches"]:
                failures.append({"chaos_seed": seed,
                                 "mismatches": rep["mismatches"][:3]})
        rc, rep = counted(lambda: run_cli([
            str(n), "64", "--chaos-demo", "--quiet",
            "--serve-requests", str(requests), "--batch-cap", str(cap)]))
        verdict = (check_tool("check_chaos.py", stdin=json.dumps(rep))
                   if rc == 0 else None)
        emit({"phase": "serve", "check": "chaos_cli", "exit": rc,
              "check_chaos": verdict})
        if rc != 0:
            failures.append({"chaos_cli": rc})
    if failures:
        raise AssertionError(f"serve failed its checks: {failures}")
    return totals


def singular_factors(inv_row0, n: int, rank: int, np_dtype):
    """Rank-destroying factors against the committed inverse X, given its
    row 0: u = −e_j / X[0, j] in column 0, v = e₀, zero columns to rank k,
    for the first j where fl(X[0, j]·(1/X[0, j])) = 1.  The capacitance
    I + VᵀX·U then has a zero row and column in floating point (each GEMM
    entry is one product, rounded once), so the probe flags it whatever
    the products' order.  The JAX update demo's recipe (zero column 0 of
    A, ``tpu_jordan/serve/update_demo.py::_singular_factors``) leaves a
    capacitance singular only to eps·κ∞, which at this row's κ∞·eps ≈ 0.3
    the card's runs of identical inputs judged both ways (ROADMAP.md
    Queue C)."""
    import numpy as np

    row = np.asarray(inv_row0, np_dtype)[:n]
    for j, x in enumerate(row):
        c = np_dtype.type(1) / x
        if x != 0 and np_dtype.type(c * x) == 1:
            break
    u = np.zeros((n, rank), np_dtype)
    v = np.zeros((n, rank), np_dtype)
    u[j, 0] = -c
    v[0, 0] = 1
    return u, v


def phase_handles(torch, counters):
    """Resident handles, update lanes and the capacity budget on the card
    (the module docstring's phase 10); each driven path with the kernels'
    counts set to 0 just before it and read just after.  Returns the counts
    summed over the paths."""
    import contextlib
    import io
    import statistics

    import numpy as np

    from tpu_jordan_torch.__main__ import main as cli
    from tpu_jordan_torch.config import default_block_size
    from tpu_jordan_torch.driver import batch_metrics
    from tpu_jordan_torch.obs.metrics import REGISTRY
    from tpu_jordan_torch.ops import block_jordan_invert, generate
    from tpu_jordan_torch.ops import gj_probe as probe_mod
    from tpu_jordan_torch.ops.gj_fused_panel import panel_width
    from tpu_jordan_torch.resilience import DEFAULT_POLICY, gate_threshold
    from tpu_jordan_torch.serve import (ExecutorStore, HandleState,
                                        HandleStore, JordanService,
                                        bucket_for)

    totals = dict.fromkeys(counters, 0)
    failures = []
    compiles = REGISTRY.counter("tpu_jordan_torch_compiles_total")
    measured = REGISTRY.counter("tpu_jordan_torch_tuner_measurements_total")
    rungs = REGISTRY.counter("tpu_jordan_torch_recovery_rungs_total")

    def reset():
        for mod in counters.values():
            mod.reset_launches()

    def read():
        got = {k: counters[k].launches for k in totals}
        for k in totals:
            totals[k] += got[k]
        return got

    def capacitance(k, dtype):
        """(probe body, probe calls a solve, kernel launches a call) of the
        k × k capacitance solve."""
        mk = min(default_block_size(k), k)
        body = probe_mod.probe_body(mk, dtype)
        per_call = (2 * mk // panel_width(mk) + 1
                    if body == "gj_probe_fused_panel" else 1)
        return body, k // mk, per_call

    def want(**bodies):
        out = dict.fromkeys(counters, 0)
        for name, count in bodies.items():
            out[name] += count
        return out

    def inv_diff(x, ref):
        return float((x - ref).abs().sum(-1).max()
                     / ref.abs().sum(-1).max())

    def smw_vs_fp64(inv0, inv1, u, v):
        """The served update's inverse ``inv1`` against an fp64 SMW of the
        same committed inverse ``inv0`` and factors on the card (plain
        torch, ``torch.linalg.solve`` for the capacitance), as ∞-norms
        relative to the correction ‖X_ref − X₀‖∞: a missing or transposed
        correction reads ≈ 1, fp32 rounding ≈ 1e-6."""
        x0 = inv0.double()
        ud, vd = (torch.from_numpy(f).to(x0.device, torch.float64)
                  for f in (u, v))
        w = x0 @ ud
        s = torch.eye(ud.shape[1], dtype=x0.dtype, device=x0.device)
        y = torch.linalg.solve(s + vd.T @ w, vd.T @ x0)
        corr = w @ y
        c = float(corr.abs().sum(-1).max())
        err = float((inv1.double() - (x0 - corr)).abs().sum(-1).max())
        del x0, w, y, corr
        return {"vs_fp64_over_correction": err / c,
                "correction_over_inverse": c / float(
                    inv0.double().abs().sum(-1).max())}

    # (a) the cap-1 update lanes at the 8192 row, one handle a rank.
    n, m, gen, dname, ranks, updates = HANDLES_ROW
    dtype = getattr(torch, dname)
    np_dtype = np.dtype(dname)
    a_host = generate(gen, (n, n), dtype, device="cpu")
    inv_body, inv_nr = probe_mod.probe_body(m, dtype), -(-n // m)
    for k in ranks:
        body, nr_cap, per_call = capacitance(k, dtype)
        kw = dict(dtype=dtype, batch_cap=1, block_size=m,
                  shared_handles=HandleStore(),
                  shared_executors=ExecutorStore())
        t0 = time.perf_counter()
        with JordanService(**kw) as svc, JordanService(
                update_drift_budget_factor=0.0, **kw) as forced:
            for s in (svc, forced):
                s.warmup(update_shapes=[(n, k)])
            c0, m0 = compiles.total(), measured.total()
            reset()
            ref = svc.invert(a_host, resident=True, handle_id=f"u{k}",
                             timeout=600)
            got_create = read()
            rng = np.random.default_rng(k)
            scale = 1.0 / np.sqrt(float(n) * k)
            outcomes, exec_ms, rels, bad_launches = [], [], [], []
            gated_kept = smw_check = None
            # The forced rung first, then the stream: the final resident
            # inverse carries the stream's SMW updates.
            for i in range(-1, updates):
                st = svc.handles.get(ref.handle_id)
                # A commit replaces the state's tensors, never edits them.
                inv_before = st.inverse
                target = forced if i < 0 else svc
                if i == updates // 2:
                    u, v = singular_factors(st.inverse[0].cpu().numpy(), n,
                                            k, np_dtype)
                    kept = (st.version, st.a.clone(), st.inverse.clone())
                else:
                    u, v = ((rng.standard_normal((n, k)) * scale)
                            .astype(np_dtype) for _ in range(2))
                    kept = None
                r0 = rungs.total()
                reset()
                res = target.submit_update(ref, u, v).result(600)
                got = read()
                fired = int(rungs.total() - r0)
                expect = want(**{body: nr_cap})
                expect[inv_body] += fired * inv_nr
                if got != expect:
                    bad_launches.append({"update": i, "launches": got,
                                         "expected": expect})
                outcomes.append(res.update_outcome)
                rels.append(res.rel_residual)
                if res.update_outcome == "refreshed":
                    exec_ms.append(res.execute_seconds * 1e3)
                if i == 0:
                    smw_check = smw_vs_fp64(
                        inv_before, svc.handles.get(ref.handle_id).inverse,
                        u, v)
                del inv_before
                if kept is not None:
                    st = svc.handles.get(ref.handle_id)
                    gated_kept = (res.update_outcome == "gated"
                                  and st.version == kept[0]
                                  and torch.equal(st.a, kept[1])
                                  and torch.equal(st.inverse, kept[2]))
                    del kept
            # The final resident inverse against a fresh invert of the
            # mutated matrix through the warm invert lane.
            st = svc.handles.get(ref.handle_id)
            met = batch_metrics(st.a[None], st.inverse[None])
            res_rel = float(met["rel_residual"][0])
            kappa = float(met["kappa"][0])
            reset()
            fresh = [svc.submit(st.a[:n, :n]).result(600) for _ in range(3)]
            got_fresh = read()
            diff = inv_diff(st.inverse[:n, :n], fresh[0].inverse)
            gate = gate_threshold(DEFAULT_POLICY, n, kappa, dtype)
            stats = svc.stats()
            builds = int(compiles.total() - c0)
            measurements = int(measured.total() - m0)
            handle = stats["handles"][ref.handle_id]
        applied = sum(o != "gated" for o in outcomes)
        row = {"phase": "handles", "check": "update_lane", "n": n, "m": m,
               "rank": k, "generator": gen, "dtype": dname,
               "outcomes": outcomes, "rel_residuals": rels,
               "update_execute_ms_median": statistics.median(exec_ms),
               "reinvert_execute_ms_median": statistics.median(
                   r.execute_seconds * 1e3 for r in fresh),
               "capacitance_probe": body, "capacitance_calls": nr_cap,
               "kernel_launches_per_call": per_call,
               "resident_rel_residual": res_rel, "gate": gate,
               "kappa_inf": kappa, "fresh_rel_residual": max(
                   r.rel_residual for r in fresh),
               "resident_vs_fresh": diff, "gated_kept_bits": gated_kept,
               "smw_check": smw_check,
               "version": handle["version"], "drift": handle["drift"],
               "builds_after_warmup": builds,
               "measurements": measurements,
               "update_requests": stats["workloads"]["update"]["requests"],
               "create_launches": got_create, "fresh_launches": got_fresh,
               "bad_launches": bad_launches,
               "seconds": time.perf_counter() - t0}
        emit(row)
        checks = {
            "accounted": (len(outcomes) == updates + 1
                          and row["update_requests"] == updates),
            "refreshed": "refreshed" in outcomes[1:],
            "gated": "gated" in outcomes[1:],
            "gated_kept_bits": bool(gated_kept),
            "forced_rung": outcomes[0] == "re_inverted",
            "smw_vs_fp64": (outcomes[1] == "refreshed" and smw_check[
                "vs_fp64_over_correction"] <= SMW_FP64_TOL),
            "version": handle["version"] == applied,
            "warm": builds == 0 and measurements == 0,
            "launches": not bad_launches
                        and got_create == want(**{inv_body: inv_nr})
                        and got_fresh == want(**{inv_body: 3 * inv_nr}),
            "resident_gate": res_rel < gate and all(
                r.rel_residual < gate for r in fresh),
        }
        if not all(checks.values()):
            failures.append({"update_lane": k, "checks": checks})
        del ref, st, fresh, met
        torch.cuda.empty_cache()
    del a_host

    # (b) the batched lane: distinct handles in one launch, a follower.
    n, m, k, cap = HANDLES_BATCH_ROW
    body, nr_cap, _ = capacitance(k, dtype)
    store, executors = HandleStore(), ExecutorStore()
    kw = dict(dtype=dtype, block_size=m, shared_handles=store,
              shared_executors=executors)
    mats = [generate("rand", (n, n), dtype, row_offset=i * n,
                     col_offset=i * n, device="cpu") for i in range(cap)]
    with JordanService(batch_cap=cap, **kw) as svc:
        svc.warmup(update_shapes=[(n, k)])
        reset()
        refs = [svc.invert(x, resident=True, handle_id=f"b{i}",
                           timeout=600) for i, x in enumerate(mats)]
        got_create = read()
    twin = HandleStore()
    for r in refs:
        st = store.get(r.handle_id)
        twin.create(HandleState(r.handle_id, st.n, st.bucket_n, st.dtype,
                                st.a.clone(), st.inverse.clone()))
    rng = np.random.default_rng(cap)
    scale = 1.0 / np.sqrt(float(n) * k)
    rounds = ((0, 1, 2, 3), (1, 2, 1))
    ups = [[tuple((rng.standard_normal((n, k)) * scale).astype(np_dtype)
                  for _ in range(2)) for _ in rnd] for rnd in rounds]
    batched, batch_got, batch_ms = [], [], []
    for rnd, factors in zip(rounds, ups):
        with JordanService(batch_cap=cap, autostart=False, **kw) as svc:
            svc.warmup(update_shapes=[(n, k)])
            futs = [svc.submit_update(refs[t], u, v)
                    for t, (u, v) in zip(rnd, factors)]
            reset()
            svc.start()
            batched.append([f.result(600) for f in futs])
            batch_got.append(read())
            lane = svc.stats()["buckets"][f"update:{n}:k{k}"]
            batch_ms.append(lane["execute_ms"])
    single, single_ms = [], []
    with JordanService(batch_cap=1, shared_handles=twin, dtype=dtype,
                       block_size=m, shared_executors=executors) as svc:
        svc.warmup(update_shapes=[(n, k)])
        reset()
        for rnd, factors in zip(rounds, ups):
            single.append([svc.update(refs[t], u, v, timeout=600)
                           for t, (u, v) in zip(rnd, factors)])
        single_got = read()
        single_ms = [r.execute_seconds * 1e3 for rr in single for r in rr]
    agree = []
    for rr_b, rr_1 in zip(batched, single):
        for b, one in zip(rr_b, rr_1):
            agree.append({"outcome": (b.update_outcome, one.update_outcome),
                          "singular": (b.singular, one.singular),
                          "version": (b.handle_version, one.handle_version),
                          "diff": inv_diff(b.inverse, one.inverse),
                          "tolerance": BATCH_VS_CAP1_TOL})
    follower_ok = (batched[1][2].handle_version
                   == batched[1][0].handle_version + 1)
    row = {"phase": "handles", "check": "batched_lane", "n": n, "m": m,
           "rank": k, "batch_cap": cap, "rounds": rounds,
           "create_launches": got_create, "launches": batch_got,
           "cap1_launches": single_got,
           "batch_execute_ms": batch_ms,
           "cap1_execute_ms_median": statistics.median(single_ms),
           "agreement": agree, "follower_version_ok": follower_ok}
    emit(row)
    n_updates = sum(len(r) for r in rounds)
    # Each resident invert is its own batch: Nr probe calls.
    create_want = want(**{probe_mod.probe_body(m, dtype): cap * (n // m)})
    if not (got_create == create_want
            and batch_got == [want(**{body: nr_cap}),
                          want(**{body: 2 * nr_cap})]
            and single_got == want(**{body: n_updates * nr_cap})
            and follower_ok
            and all(a["outcome"][0] == a["outcome"][1]
                    and a["singular"][0] == a["singular"][1]
                    and a["version"][0] == a["version"][1]
                    and a["diff"] <= a["tolerance"] for a in agree)):
        failures.append({"batched_lane": row})
    del refs, batched, single, mats, store, twin
    torch.cuda.empty_cache()

    # The complex update: a complex64 handle (from the augmented engine;
    # the invert lanes are real, as in the JAX package) through the update
    # lane's complex capacitance solve.
    n, m, k = HANDLES_COMPLEX_ROW
    cdtype = torch.complex64
    a = generate("crand", (n, n), cdtype, device="cuda")
    inv, sing = block_jordan_invert(a, block_size=m, global_scale=True)
    bucket = bucket_for(n)
    a_pad = torch.eye(bucket, dtype=cdtype, device="cuda")
    inv_pad = a_pad.clone()
    a_pad[:n, :n], inv_pad[:n, :n] = a, inv
    store = HandleStore()
    ref = store.create(HandleState("c", n, bucket, "complex64", a_pad,
                                   inv_pad))
    rng = np.random.default_rng(n)
    u, v = ((rng.standard_normal((n, k)) + 1j * rng.standard_normal((n, k)))
            .astype(np.complex64) / np.sqrt(float(n) * k) for _ in range(2))
    c_body, c_nr, _ = capacitance(k, cdtype)
    with JordanService(dtype=cdtype, batch_cap=1, block_size=m,
                       shared_handles=store) as svc:
        # The complex invert lanes are refused, so the update lane alone.
        svc.executors.get(bucket, 1, m, workload="update", rhs=k)
        reset()
        res = svc.update(ref, u, v, timeout=600)
        got = read()
    gate = gate_threshold(DEFAULT_POLICY, n, res.kappa, cdtype)
    row = {"phase": "handles", "check": "complex_update", "n": n, "m": m,
           "rank": k, "dtype": "complex64", "singular_invert": bool(sing),
           "outcome": res.update_outcome, "rel_residual": res.rel_residual,
           "gate": gate, "execute_ms": res.execute_seconds * 1e3,
           "launches": got}
    emit(row)
    if (bool(sing) or res.update_outcome != "refreshed"
            or not res.rel_residual < gate
            or got != want(**{c_body: c_nr})):
        failures.append({"complex_update": row})
    del a, inv, a_pad, inv_pad, store, ref, res
    torch.cuda.empty_cache()

    # (c) the CLI's capacity demo, through its checker.
    n, m = CAPACITY_DEMO_ROW
    out = io.StringIO()
    reset()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = cli([str(n), str(m), "--capacity-demo"])
    got = read()
    lines = out.getvalue().strip().splitlines()
    rep = json.loads(lines[-1]) if rc == 0 and lines else {}
    verdict = (check_tool("check_capacity.py", stdin=json.dumps(rep))
               if rc == 0 else None)
    # Three resident inverts (the fourth is refused before any launch) and
    # one rank-8 update (the one of the evicted handle fails typed).
    expect = want(**{probe_mod.probe_body(m, dtype): 3 * (-(-n // m))})
    expect[capacitance(8, dtype)[0]] += 1
    row = {"phase": "handles", "check": "capacity_demo", "n": n, "m": m,
           "exit": rc, "check_capacity": verdict,
           "budget_evictions": rep.get("budget_evictions"),
           "handles_alive": rep.get("handles_alive"),
           "compiles_on_capacity_path": rep.get("compiles_on_capacity_path"),
           "elapsed_s": rep.get("elapsed_s"), "launches": got,
           "expected": expect}
    emit(row)
    if rc != 0 or got != expect:
        failures.append({"capacity_demo": row})
    if failures:
        raise AssertionError(f"handles failed its checks: {failures}")
    return totals


def _wedged_deaths(counter) -> float:
    """Replica deaths the supervisor's liveness deadline caused, so far."""
    return sum(v for k, v in counter.series().items()
               if dict(k).get("reason") == "wedged")


def _warm_series() -> dict:
    """The inert warm batches run so far, by lane (the series of
    ``tpu_jordan_torch_serve_warm_batches_total``)."""
    from tpu_jordan_torch.obs.metrics import REGISTRY

    return dict(REGISTRY.counter(
        "tpu_jordan_torch_serve_warm_batches_total").series())


def _warm_launches(torch, counters, before: dict) -> dict:
    """The kernel launches of the inert warm batches run since ``before``
    (``_warm_series()`` then): Nr probe calls a warm invert or solve
    batch, ceil(k / m) capacitance calls a warm update batch."""
    from tpu_jordan_torch.config import default_block_size
    from tpu_jordan_torch.ops import gj_probe as probe_mod

    want = dict.fromkeys(counters, 0)
    for key, v in _warm_series().items():
        count = int(v - before.get(key, 0))
        if not count:
            continue
        lb = dict(key)
        dtype = getattr(torch, lb["dtype"])
        if lb["workload"] == "update":
            rows = int(lb["rhs"])
            mm = min(default_block_size(rows), rows)
        else:
            rows = int(lb["bucket"])
            mm = min(int(lb["block"]), rows)
        want[probe_mod.probe_body(mm, dtype)] += count * -(-rows // mm)
    return want


def _execute_samples(series_before: dict, hist) -> tuple[dict, dict]:
    """The execute-seconds samples each lane's histogram series gained
    since ``series_before`` (its counts then): ({bucket: samples pooled
    over the replicas}, {"bucket@r<slot>": the series' largest, ms})."""
    out: dict = {}
    worst: dict = {}
    for key, res in hist.series().items():
        new = res.count - series_before.get(key, 0)
        if new > 0:
            labels = dict(key)
            fresh = res.samples[-new:]
            out.setdefault(labels.get("bucket"), []).extend(fresh)
            worst[f"{labels.get('bucket')}@r{labels.get('replica')}"] = (
                max(fresh) * 1e3)
    return out, worst


def phase_fleet(torch, counters):
    """The replica fleet on the card (the module docstring's phase 11):
    ``fleet_demo`` at FLEET_DEMO_ROW for FLEET_SEEDS and the CLI's
    ``--fleet-demo --slo-report --quiet`` once, each run with the kernels'
    counts set to 0 just before it and read just after.  Returns the counts
    summed over the runs."""
    import contextlib
    import io
    import tempfile

    from tpu_jordan_torch.__main__ import main as cli
    from tpu_jordan_torch.fleet import fleet_demo
    from tpu_jordan_torch.obs.metrics import REGISTRY, percentiles
    from tpu_jordan_torch.obs.recorder import RECORDER
    from tpu_jordan_torch.ops import gj_probe as probe_mod

    n, m, requests, cap, replicas, kills = FLEET_DEMO_ROW
    totals = dict.fromkeys(counters, 0)
    failures = []
    exec_hist = REGISTRY.histogram("tpu_jordan_torch_serve_execute_seconds")
    batches = REGISTRY.counter("tpu_jordan_torch_serve_batches_total")
    deaths = REGISTRY.counter("tpu_jordan_torch_fleet_replica_deaths_total")

    def run(fn):
        """One driven run: counts reset before, read after; the batches it
        dispatched per bucket, its execute samples and its wedge verdicts."""
        for mod in counters.values():
            mod.reset_launches()
        seen = {k: r.count for k, r in exec_hist.series().items()}
        b0 = dict(batches.series())
        wedged0 = _wedged_deaths(deaths)
        warm0 = _warm_series()
        mark = RECORDER.total
        t0 = time.perf_counter()
        try:
            out = fn()
        finally:
            got = {k: counters[k].launches for k in totals}
            for k in totals:
                totals[k] += got[k]
        wall = time.perf_counter() - t0
        per_bucket: dict = {}
        for key, v in batches.series().items():
            d = v - b0.get(key, 0.0)
            if d and "workload" not in dict(key):      # invert lanes
                bucket = int(dict(key)["bucket"])
                per_bucket[bucket] = per_bucket.get(bucket, 0) + int(d)
        warm = _warm_launches(torch, counters, warm0)
        want = dict(warm)
        for bucket, count in per_bucket.items():
            mm = min(m, bucket)
            want[probe_mod.probe_body(mm, torch.float32)] += (
                count * -(-bucket // mm))
        wedged = _wedged_deaths(deaths) - wedged0
        stale = [e for e in RECORDER.since(mark)
                 if e["kind"] == "heartbeat_stale"]
        samples, worst = _execute_samples(seen, exec_hist)
        execute = {b: {k: (None if v is None else v * 1e3)
                       for k, v in percentiles(s).items() if k != "p95"}
                   for b, s in sorted(samples.items())}
        return out, {"launches": got, "expected": want,
                     "warm_launches": warm,
                     "batches": per_bucket, "wall_s": wall,
                     "wedged_deaths": wedged, "heartbeat_stale": len(stale),
                     "execute_ms": execute, "execute_max_ms": worst}

    def verdicts_of(tag, *args, **kw):
        """Both checkers' verdicts; a failed one is recorded, not raised,
        so the row still prints."""
        out = {}
        for tool in ("check_fleet.py", "check_slo.py"):
            try:
                out[tool] = check_tool(tool, *args, **kw)
            except AssertionError as e:
                out[tool] = f"FAILED: {e}"[:2000]
                failures.append({tag: out[tool]})
        return out

    def judge(rep, tag):
        chaos = rep["chaos"]
        typed = sum(rep["typed_errors"].values())
        checks = {
            "bits_or_typed": (not rep["mismatches"]
                              and rep["matched_bitwise"] + typed
                              == rep["requests"]),
            "zero_builds_after_warmup":
                chaos["compiles_delta_after_warmup"] == 0,
            "zero_measurements": rep["plan_cache"]["measurements"] == 0,
            "replacements_equal_deaths":
                chaos["restarts"] == chaos["deaths"] >= kills,
            "outstanding_zero": rep["ledger"]["outstanding"] == 0,
        }
        bad = [k for k, ok in checks.items() if not ok]
        if bad:
            failures.append({tag: bad})
        return checks

    with tempfile.TemporaryDirectory() as tmp:
        for seed in FLEET_SEEDS:
            rep, info = run(lambda: fleet_demo(
                n=n, replicas=replicas, requests=requests, batch_cap=cap,
                kills=kills, seed=seed, block_size=m, dtype=torch.float32,
                slo_report=True))
            path = os.path.join(tmp, f"fleet{seed}.json")
            with open(path, "w") as f:
                json.dump(rep, f)
            verdicts = verdicts_of(f"seed {seed}", path)
            thr, chaos = rep["throughput"], rep["chaos"]
            emit({"phase": "fleet", "check": "fleet_demo", "n": n, "m": m,
                  "requests": requests, "batch_cap": cap,
                  "replicas": replicas, "kills": kills, "seed": seed,
                  "single_rps": thr["single_rps"],
                  "fleet_rps": thr["fleet_rps"],
                  "scaling_x": thr["scaling_x"],
                  "scaling_floor": thr["scaling_floor"],
                  "p99_ms": {k: thr[k] for k in ("single_p99_ms",
                                                 "fleet_p99_ms",
                                                 "chaos_p99_ms",
                                                 "p99_bound_ms")},
                  "exec_spread": {
                      "p99_spread": thr["exec_spread"]["p99_spread"],
                      "p99_ms": {r: d["exec_ms"]["p99"] for r, d in
                                 thr["exec_spread"]["replicas"].items()}},
                  "execute_ms_by_bucket": info["execute_ms"],
                  "execute_max_ms_by_lane": info["execute_max_ms"],
                  "batches": info["batches"],
                  "kills_injected": chaos["kills_injected"],
                  "deaths": chaos["deaths"], "restarts": chaos["restarts"],
                  "reroutes": chaos["reroutes"],
                  "matched_bitwise": rep["matched_bitwise"],
                  "typed_errors": rep["typed_errors"],
                  "singular_flagged": rep["singular_flagged"],
                  "ledger": rep["ledger"],
                  "checks": judge(rep, f"seed {seed}"),
                  "wedged_deaths": info["wedged_deaths"],
                  "heartbeat_stale": info["heartbeat_stale"],
                  "slo_healthy": rep["slo"]["healthy"],
                  "elapsed_s": rep["elapsed_s"], "wall_s": info["wall_s"],
                  "launches": info["launches"],
                  "expected": info["expected"],
                  "warm_launches": info["warm_launches"],
                  "verdicts": verdicts})
            if info["launches"] != info["expected"]:
                failures.append({"seed": seed,
                                 "launches": info["launches"],
                                 "expected": info["expected"]})
            if info["wedged_deaths"] or info["heartbeat_stale"]:
                failures.append({"seed": seed, "wedged": info})

    def cli_run():
        out = io.StringIO()
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(io.StringIO()):
            rc = cli([str(n), str(m), "--fleet-demo", "--slo-report",
                      "--quiet"])
        return rc, out.getvalue().strip().splitlines()

    def update_stream(plan):
        """FLEET_UPDATE_ROW's stream: a resident invert through a warm
        fleet, then rank-1 updates, under ``plan`` (None: fault-free);
        (each update's outcome, version and inverse bytes, the final
        resident inverse's bytes, the injections)."""
        import contextlib as _ctx

        import numpy as np

        from tpu_jordan_torch.fleet import JordanFleet
        from tpu_jordan_torch.ops import generate
        from tpu_jordan_torch.resilience import (ResiliencePolicy,
                                                 RetryPolicy, activate)

        nu, mu, count, _ = FLEET_UPDATE_ROW
        rng = np.random.default_rng(nu)
        muts = [(rng.standard_normal((nu, 1)).astype(np.float32) * 0.01,
                 rng.standard_normal((nu, 1)).astype(np.float32) * 0.01)
                for _ in range(count)]
        a = generate("rand", (nu, nu), torch.float32, device="cpu")
        with JordanFleet(replicas=replicas, dtype=torch.float32,
                         batch_cap=1, block_size=mu, stable_after_s=0.2,
                         policy=ResiliencePolicy(retry=RetryPolicy(
                             max_retries=4, backoff_s=0.0))) as fleet:
            fleet.warmup([nu], update_shapes=[(nu, 1)])
            with (activate(plan) if plan is not None
                  else _ctx.nullcontext()):
                ref = fleet.invert(a, resident=True, timeout=600)
                outs = []
                for u, v in muts:
                    res = fleet.update(ref, u, v, timeout=600)
                    outs.append((res.update_outcome, res.handle_version,
                                 res.inverse.cpu().numpy().tobytes()))
            final = fleet.handles.get(ref.handle_id).inverse
            final = final.cpu().numpy().tobytes()
            ledger = fleet.stats()["ledger"]
        return outs, final, ledger

    from tpu_jordan_torch.resilience import FaultPlan

    nu, mu, count, kills_u = FLEET_UPDATE_ROW
    (base, base_final, _), info_b = run(lambda: update_stream(None))
    plan = FaultPlan.seeded(0, points={"replica_kill": (kills_u,
                                                        count + 1)})
    (chaos, chaos_final, ledger), info_c = run(lambda: update_stream(plan))
    rungs = sum(o[0] == "re_inverted" for o in base + chaos)
    from tpu_jordan_torch.serve import bucket_for

    nr = -(-bucket_for(nu) // mu)
    want = {k: info_b["warm_launches"][k] + info_c["warm_launches"][k]
            for k in counters}
    want["gj_probe"] += 2 * count
    want[probe_mod.probe_body(mu, torch.float32)] += (2 + rungs) * nr
    got = {k: info_b["launches"][k] + info_c["launches"][k] for k in want}
    row = {"phase": "fleet", "check": "fleet_update", "n": nu, "m": mu,
           "liveness_deadline_s": 1.0,
           "updates": count, "kills_injected": plan.injected_total,
           "outcomes": [o[0] for o in chaos],
           "versions": [o[1] for o in chaos],
           "bits_equal_replay": (chaos == base
                                 and chaos_final == base_final),
           "ledger": ledger, "launches": got, "expected": want,
           "wall_s": info_b["wall_s"] + info_c["wall_s"],
           "wedged_deaths": info_b["wedged_deaths"]
           + info_c["wedged_deaths"]}
    emit(row)
    if not (row["bits_equal_replay"] and plan.injected_total == kills_u
            and row["versions"] == list(range(1, count + 1))
            and ledger["outstanding"] == 0 and got == want
            and not row["wedged_deaths"]):
        failures.append({"fleet_update": {k: row[k] for k in (
            "kills_injected", "versions", "bits_equal_replay", "launches",
            "expected", "wedged_deaths")}})

    (rc, lines), info = run(cli_run)
    rep = json.loads(lines[-1]) if rc == 0 and lines else None
    verdicts = (verdicts_of("cli", stdin=lines[-1]) if rep is not None
                else None)
    emit({"phase": "fleet", "check": "fleet_cli", "exit": rc,
          "scaling_x": rep and rep["throughput"]["scaling_x"],
          "checks": rep and judge(rep, "cli"),
          "launches": info["launches"], "expected": info["expected"],
          "wall_s": info["wall_s"], "verdicts": verdicts})
    if rc != 0 or info["launches"] != info["expected"]:
        failures.append({"fleet_cli": rc, "launches": info["launches"],
                         "expected": info["expected"]})
    if not (totals["gj_probe_fused_panel"] and totals["gj_probe"]):
        failures.append({"fleet_launches": totals})
    if failures:
        raise AssertionError(f"fleet failed its checks: {failures}")
    return totals


def phase_lpqp(torch, counters):
    """The LP/QP drivers on the card (the module docstring's phase 12): the
    CLI's ``--lp-demo`` at each of LP_DEMO_ROWS through
    ``tools/check_lp.py``, then LP_TIMED_ROW's ``solve_lp`` through a warm
    fleet, each with the kernels' counts set to 0 just before it and read
    just after.  Returns the counts summed over the runs."""
    import contextlib
    import io
    import statistics

    import numpy as np

    from tpu_jordan_torch.__main__ import main as cli
    from tpu_jordan_torch.config import default_block_size
    from tpu_jordan_torch.fleet import JordanFleet
    from tpu_jordan_torch.lpqp import lp_instance, solve_lp
    from tpu_jordan_torch.obs.metrics import REGISTRY
    from tpu_jordan_torch.ops import gj_probe as probe_mod
    from tpu_jordan_torch.serve import bucket_for, k_bucket_for

    totals = dict.fromkeys(counters, 0)
    failures = []
    deaths = REGISTRY.counter("tpu_jordan_torch_fleet_replica_deaths_total")

    def counted(fn):
        for mod in counters.values():
            mod.reset_launches()
        w0 = _wedged_deaths(deaths)
        warm0 = _warm_series()
        try:
            return fn()
        finally:
            counted.last = {k: counters[k].launches for k in totals}
            counted.wedged = _wedged_deaths(deaths) - w0
            counted.warm = _warm_launches(torch, counters, warm0)
            for k in totals:
                totals[k] += counted.last[k]

    # (1) the CLI's demo through its checker, at each row.
    for n, m, replicas, kills, cap, may_fail in LP_DEMO_ROWS:
        def demo():
            out = io.StringIO()
            with contextlib.redirect_stdout(out), \
                    contextlib.redirect_stderr(io.StringIO()):
                rc = cli([str(n), str(m), "--lp-demo", "--dtype", "float64",
                          "--replicas", str(replicas), "--kills",
                          str(kills), "--batch-cap", str(cap), "--quiet"])
            return rc, out.getvalue().strip().splitlines()

        t0 = time.perf_counter()
        rc, lines = counted(demo)
        wall = time.perf_counter() - t0
        got = counted.last
        rep = json.loads(lines[-1]) if rc in (0, 2) and lines else None
        if rep is None:
            failures.append({"lp_demo": n, "exit": rc})
            continue
        out = subprocess.run(
            [sys.executable, os.path.join(ROOT, "tools", "check_lp.py"),
             "-"], input=lines[-1], capture_output=True, text=True)
        complaints = [ln for ln in out.stderr.splitlines() if ln.strip()]
        allowed = {f"FAIL -: {leg}: driver did not converge"
                   for leg in may_fail}
        if may_fail:
            allowed.add("SILENT-DIVERGENCE -: silent_divergence flagged "
                        "by the demo itself")
        legs, bat, chaos = rep["legs"], rep["batched"], rep["chaos"]
        drift = rep["drift_probe"]
        # What the silent-divergence flag summarizes, held here claim by
        # claim, so an allowed leg's non-convergence is all it can carry.
        claims = {
            "checker": (out.returncode in ((0, 2) if may_fail else (0,))
                        and set(complaints) <= allowed),
            "other_legs_converged": all(
                leg["converged"] for name, leg in legs.items()
                if name not in may_fail),
            "no_errors_or_mismatches": (not rep["errors"]
                                        and not rep["mismatches"]),
            "updates_accounted": all(
                sum(r["ledger"].values()) == r["updates"]
                for r in (*legs.values(), drift)),
            "drift_all_re_inverted": (drift["converged"]
                                      and drift["ledger"]["re_inverted"]
                                      == drift["updates"] > 0),
            "chaos_bits_equal": (chaos["fingerprint_bitmatch"]
                                 and chaos["iterates_matched"]
                                 == chaos["iterates_total"]
                                 and chaos["kills_injected"] == kills
                                 and chaos["deaths"] == chaos["restarts"]
                                 == kills),
            "batched_amortizes": (bat["occupancy"] > 1
                                  and bat["amortized_beats_one_per_launch"]),
            "zero_builds_and_measurements": (
                rep["compiles_after_warmup"] == 0
                and rep["measurements_after_warmup"] == 0
                and chaos["compiles_delta_after_warmup"] == 0
                and bat["compiles_delta"] == 0),
            "outstanding_zero": rep["fleet_ledger"]["outstanding"] == 0,
            "nothing_wedged": counted.wedged == 0,
        }
        # Launches.  The capacitance probe (k bucket 8) once a launched
        # update: every driver leg, the drift probe, the chaos replay and
        # chaos runs (equal streams), the batched leg's cap-1 updates and
        # one call a batched launch.  The panel probe Nr times a resident
        # invert, a verification solve or a re_invert rung: each leg's
        # create, solves and rungs (an LP verifies every pivot, so the
        # drift and chaos legs' solves are their updates), and the batched
        # leg's cap creates.  Plus the fleets' inert warm batches.
        bucket = bucket_for(n)
        mb = min(m, bucket)
        nr = -(-bucket // mb)
        chaos_updates = sum(chaos["ledger"].values())
        want_cap = (sum(leg["updates"] for leg in legs.values())
                    + drift["updates"] + 2 * chaos_updates
                    + bat["rounds"] * (bat["batch_cap"] + 1))
        want_panel = nr * (
            sum(1 + leg["solves"] + leg["ledger"]["re_inverted"]
                for leg in legs.values())
            + 1 + drift["updates"] + drift["ledger"]["re_inverted"]
            + 2 * (1 + chaos_updates + chaos["ledger"]["re_inverted"])
            + bat["batch_cap"])
        kb = k_bucket_for(1)
        want = dict(counted.warm)
        want[probe_mod.probe_body(min(default_block_size(kb), kb),
                                  torch.float64)] += want_cap
        want[probe_mod.probe_body(mb, torch.float64)] += want_panel
        claims["launches"] = got == want
        emit({"phase": "lpqp", "check": "lp_demo", "n": n, "m": m,
              "replicas": replicas, "kills": kills, "batch_cap": cap,
              "exit": rc,
              "legs": {k: {f: v[f] for f in (
                  "converged", "iterations", "updates", "solves", "ledger",
                  "obj_rel_err", "kkt_rel_final", "kkt_threshold")}
                  for k, v in legs.items()},
              "drift_probe": drift,
              "chaos": {k: v for k, v in chaos.items() if k != "faults"},
              "batched": bat,
              "compiles_after_warmup": rep["compiles_after_warmup"],
              "measurements_after_warmup":
                  rep["measurements_after_warmup"],
              "fleet_ledger": rep["fleet_ledger"],
              "silent_divergence": rep["silent_divergence"],
              "wedged_deaths": counted.wedged,
              "elapsed_s": rep["elapsed_s"], "wall_s": wall,
              "launches": got, "expected": want,
              "warm_launches": counted.warm,
              "check_lp": {"exit": out.returncode,
                           "out": out.stdout.strip(),
                           "complaints": complaints,
                           "allowed": sorted(allowed)},
              "claims": claims})
        if not all(claims.values()):
            failures.append({"lp_demo": n, "claims": [
                k for k, ok in claims.items() if not ok]})

    # (2) one timed LP through a warm fleet at the default liveness
    # deadline.
    mt, cond, solve_every, replicas_t = LP_TIMED_ROW
    prob = lp_instance(m=mt, cond=cond)

    def timed():
        with JordanFleet(replicas=replicas_t, dtype=torch.float64,
                         batch_cap=1, max_wait_ms=0.5,
                         stable_after_s=0.2) as fleet:
            fleet.warmup([mt], update_shapes=[(mt, 1)],
                         solve_shapes=[(mt, 1)])
            t0 = time.perf_counter()
            report = solve_lp(prob, fleet, solve_every=solve_every)
            return report, time.perf_counter() - t0, fleet.stats()["ledger"]

    report, wall, ledger = counted(timed)
    got = counted.last
    d = report.to_dict()
    tm = {k: np.asarray(v) * 1e3 for k, v in report.timing.items()}
    it_ms = tm["iteration_s"]
    # Probe calls: one capacitance call (k bucket 8: gj_probe.cu) an
    # update; Nr of the lanes' block size for the resident invert, each
    # verification solve and each re_invert rung; the warm batches.
    mb = min(default_block_size(mt), mt)
    want = dict(counted.warm)
    want["gj_probe"] += report.updates
    want[probe_mod.probe_body(mb, torch.float64)] += (
        1 + report.solves + report.ledger["re_inverted"]) * -(-mt // mb)
    row = {"phase": "lpqp", "check": "lp_timed", "m": mt, "cond": cond,
           "dtype": "float64", "replicas": replicas_t,
           "solve_every": solve_every, "liveness_deadline_s": 1.0,
           "converged": report.converged, "iterations": report.iterations,
           "updates": report.updates, "solves": report.solves,
           "ledger": report.ledger, "obj_rel_err": d["obj_rel_err"],
           "kkt_rel_final": report.kkt_rel_final,
           "kkt_threshold": report.kkt_threshold,
           "iteration_ms": {"median": float(np.median(it_ms)),
                            "p90": float(np.percentile(it_ms, 90))},
           "split_median_ms": {k: float(np.median(tm[k])) for k in (
               "update_s", "execute_s", "copy_s", "verify_s", "host_s")},
           "split_sum_ms": {k: float(tm[k].sum()) for k in tm},
           "verify_median_ms": (float(statistics.median(
               v for v in tm["verify_s"] if v > 0))
               if report.solves else None),
           "wall_s": wall, "fleet_ledger": ledger,
           "wedged_deaths": counted.wedged,
           "launches": got, "expected": want}
    emit(row)
    if not (report.converged and d["obj_rel_err"] <= 1e-8
            and ledger["outstanding"] == 0 and not counted.wedged
            and got == want):
        failures.append({"lp_timed": {k: row[k] for k in (
            "converged", "obj_rel_err", "launches", "expected",
            "wedged_deaths")}})
    if failures:
        raise AssertionError(f"lpqp failed its checks: {failures}")
    return totals


def _run_cli(argv) -> tuple[int, list]:
    """The CLI in this process, its stdout captured: (exit code, lines)."""
    import contextlib
    import io

    from tpu_jordan_torch.__main__ import main as cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = cli([str(a) for a in argv])
    return rc, out.getvalue().strip().splitlines()


def _batches_since(before: dict) -> dict:
    """The serve batches dispatched since ``before`` (the batches counter's
    series then), by (workload, lane label)."""
    from tpu_jordan_torch.obs.metrics import REGISTRY

    out: dict = {}
    for key, v in REGISTRY.counter(
            "tpu_jordan_torch_serve_batches_total").series().items():
        d = int(v - before.get(key, 0.0))
        if d:
            lb = dict(key)
            lane = (lb.get("workload", "invert"), lb["bucket"])
            out[lane] = out.get(lane, 0) + d
    return out


def _warm_lanes(before: dict) -> int:
    """The distinct lanes whose inert warm batches ran since ``before``."""
    lanes = set()
    for key, v in _warm_series().items():
        if v - before.get(key, 0):
            lb = dict(key)
            lb.pop("replica", None)
            lanes.add(tuple(sorted(lb.items())))
    return len(lanes)


def phase_autoscale(torch, counters):
    """The CLI's ``--autoscale-demo`` on the card (the module docstring's
    phase 13), with the kernels' counts set to 0 just before it and read
    just after.  Returns the counts."""
    from tpu_jordan_torch.obs.metrics import REGISTRY
    from tpu_jordan_torch.ops import gj_probe as probe_mod

    n, m, replicas, requests = AUTOSCALE_ROW
    builds = REGISTRY.counter("tpu_jordan_torch_compiles_total")
    b0 = dict(REGISTRY.counter(
        "tpu_jordan_torch_serve_batches_total").series())
    warm0 = _warm_series()
    c0 = builds.total()
    for mod in counters.values():
        mod.reset_launches()
    t0 = time.perf_counter()
    rc, lines = _run_cli([n, m, "--autoscale-demo", "--replicas", replicas,
                          "--serve-requests", requests])
    wall = time.perf_counter() - t0
    got = {k: counters[k].launches for k in counters}
    want = _warm_launches(torch, counters, warm0)
    batches = _batches_since(b0)
    for (workload, bucket), count in batches.items():
        mm = min(m, int(bucket))
        want[probe_mod.probe_body(mm, torch.float32)] += (
            count * -(-int(bucket) // mm))
    rep = json.loads(lines[-1]) if rc == 0 and lines else None
    try:
        verdict = check_tool("check_autoscale.py", stdin=lines[-1])
    except (AssertionError, IndexError) as e:
        verdict = f"FAILED: {e}"[:2000]
    warm_lanes = _warm_lanes(warm0)
    kinds = rep["actions_by_kind"] if rep else {}
    checks = {
        "exit_0": rc == 0,
        "checker_0": not verdict.startswith("FAILED"),
        "scale_up": kinds.get("scale_up", 0) >= 1,
        "drained_to_floor": bool(rep) and kinds.get("drain", 0) >= 1
        and rep["ready_trajectory"][-1] == rep["floor"],
        "pre_shed": bool(rep) and rep["pre_shed_count"] >= 1,
        "builds_after_warmup_0": builds.total() - c0 == warm_lanes,
        "launches": got == want,
    }
    emit({"phase": "autoscale", "row": list(AUTOSCALE_ROW), "exit": rc,
          "checks": checks, "verdict": verdict,
          "actions_by_kind": kinds,
          "ready_trajectory": rep and rep["ready_trajectory"],
          "pre_shed_count": rep and rep["pre_shed_count"],
          "builds": builds.total() - c0, "warm_lanes": warm_lanes,
          "batches": {f"{w}:{b}": c for (w, b), c in batches.items()},
          "launches": got, "expected": want, "wall_s": wall,
          "elapsed_s": rep and rep["elapsed_s"]})
    if not all(checks.values()):
        raise AssertionError(f"autoscale failed its checks: {checks}")
    return got


def phase_update_demo(torch, counters):
    """The CLI's ``--update-demo`` on the card in each of
    UPDATE_DEMO_DTYPES (the module docstring's phase 14), the kernels'
    counts set to 0 just before each run and read just after.  Returns the
    counts summed over the runs."""
    from tpu_jordan_torch.config import default_block_size
    from tpu_jordan_torch.obs.metrics import REGISTRY
    from tpu_jordan_torch.ops import gj_probe as probe_mod
    from tpu_jordan_torch.serve.executors import k_bucket_for

    n, m, rank, updates, replicas, kills = UPDATE_DEMO_ROW
    kb = k_bucket_for(rank)
    mk = min(default_block_size(kb), kb)
    totals = dict.fromkeys(counters, 0)
    failures = []
    for dt in UPDATE_DEMO_DTYPES:
        dtype = getattr(torch, dt)
        b0 = dict(REGISTRY.counter(
            "tpu_jordan_torch_serve_batches_total").series())
        warm0 = _warm_series()
        for mod in counters.values():
            mod.reset_launches()
        t0 = time.perf_counter()
        rc, lines = _run_cli([n, m, "--update-demo", "--rank", rank,
                              "--updates", updates, "--replicas", replicas,
                              "--kills", kills, "--dtype", dt, "--quiet"])
        wall = time.perf_counter() - t0
        got = {k: counters[k].launches for k in counters}
        for k in totals:
            totals[k] += got[k]
        warm = _warm_launches(torch, counters, warm0)
        batches = _batches_since(b0)
        upd = sum(c for (w, _), c in batches.items() if w == "update")
        inv = {b: c for (w, b), c in batches.items() if w == "invert"}
        body = probe_mod.probe_body(mk, dtype)
        want_cap = warm[body] + upd * -(-kb // mk)
        rep = json.loads(lines[-1]) if rc == 0 and lines else None
        if rep is None:
            failures.append({dt: f"exit {rc}"})
            emit({"phase": "update_demo", "dtype": dt, "exit": rc})
            continue
        out = subprocess.run(
            [sys.executable, os.path.join(ROOT, "tools", "check_update.py"),
             "-"], input=lines[-1], capture_output=True, text=True)
        complaints = [ln for ln in out.stderr.splitlines()
                      if ln.startswith(("FAIL", "STALE"))]
        mid = updates // 2
        committed = any(rep[leg]["outcomes"][mid][1]
                        in ("refreshed", "re_inverted")
                        for leg in ("serve", "chaos"))
        knife_edge_only = (out.returncode == 1 and committed and all(
            any(p in c for p in UPDATE_KNIFE_EDGE) for c in complaints))
        serve, chaos = rep["serve"], rep["chaos"]
        checks = {
            "exit_0": rc == 0,
            "checker": out.returncode == 0 or knife_edge_only,
            "ledgers": all(sum(rep[leg]["ledger"].values()) == updates
                           for leg in ("serve", "chaos")),
            "builds_0": (serve["compiles_on_update_path"] == 0
                         and serve["measurements"] == 0
                         and chaos["compiles_delta_after_warmup"] == 0),
            "drift_rung": (serve["drift_rung"]["outcome"] == "re_inverted"
                           and serve["drift_rung"]["rungs_fired"] >= 1),
            "update_beats_reinvert":
                rep["latency"]["update_beats_reinvert"],
            "kills": (chaos["kills_injected"] >= 1
                      and chaos["deaths"] >= chaos["kills_injected"]),
            "bits_equal_replay": (chaos["final_inverse_bitmatch_replay"]
                                  and not rep["mismatches"]),
            "outstanding_0": rep["fleet_ledger"]["outstanding"] == 0,
            "capacitance_launches": got[body] == want_cap,
        }
        emit({"phase": "update_demo", "dtype": dt,
              "row": list(UPDATE_DEMO_ROW), "exit": rc, "checks": checks,
              "checker_exit": out.returncode, "checker_complaints":
              complaints, "mid_update_committed": committed,
              "serve_outcomes": serve["outcomes"],
              "chaos_ledger": chaos["ledger"], "latency": rep["latency"],
              "verification": rep["verification"],
              "kills": chaos["kills_injected"], "deaths": chaos["deaths"],
              "update_batches": upd, "invert_batches": inv,
              "launches": got, "capacitance_expected": want_cap,
              "warm_launches": warm, "wall_s": wall,
              "elapsed_s": rep["elapsed_s"]})
        if not all(checks.values()):
            failures.append({dt: checks})
    if failures:
        raise AssertionError(f"update_demo failed its checks: {failures}")
    return totals


def _live_steps(Nr: int, p: int, k: int, engine: str, pivots) -> list:
    """The supersteps at which rank k holds a live candidate: a row >= t
    (swap engines), or a row not yet retired (swap-free: the physical rows
    its swap-coordinate pivots retire)."""
    bpw = Nr // p
    if engine != "swapfree":
        return [t for t in range(Nr) if (bpw - 1) * p + k >= t]
    rows, retired, out = list(range(Nr)), 0, []
    for t, s in enumerate(pivots):
        if retired < bpw:
            out.append(t)
        if rows[s] % p == k:
            retired += 1
        rows[t], rows[s] = rows[s], rows[t]
    return out


def phase_distributed(torch, counters, own_cards: bool = False):
    """The 1D engines over torch.distributed on the card (the module
    docstring's phase 15); with ``own_cards`` (``--phases nccl4``, on four
    cards) the same world with a card a rank, which the backend rule puts
    on nccl, and the CLI, without the 1-rank world.  The launches are
    counted by the ranks (each rank's counts are read before and after its
    engine run); returns them summed over the ranks."""
    from tpu_jordan_torch.driver import resolve_invert_engine
    from tpu_jordan_torch.ops import block_jordan_invert_inplace, generate
    from tpu_jordan_torch.ops import gj_probe as probe_mod
    from tpu_jordan_torch.parallel import run_calls, run_workers
    from tpu_jordan_torch.parallel.dist_solve import (DistSpec,
                                                      solve_rank_summary)
    from tpu_jordan_torch.parallel.layout import CyclicLayout
    from tpu_jordan_torch.resilience import DEFAULT_POLICY, gate_threshold

    p = DIST_WORKERS
    phase = "nccl4" if own_cards else "distributed"
    if own_cards and torch.cuda.device_count() < p:
        raise AssertionError(f"nccl4 needs {p} cards, found "
                             f"{torch.cuda.device_count()}")
    want_backend = "nccl" if own_cards else "gloo"
    world = f"{p} ranks, " + ("a card each" if own_cards else "one card")
    totals = dict.fromkeys(counters, 0)
    failures = []
    refs = {}
    for row in DIST_ROWS + (() if own_cards else (DIST_NCCL_ROW,)):
        n, m, gen, dt = row
        a = generate(gen, (n, n), getattr(torch, dt), device="cuda")
        block_jordan_invert_inplace(a, block_size=m)          # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, sing, st = block_jordan_invert_inplace(a, block_size=m,
                                                  collect_stats=True)
        torch.cuda.synchronize()
        refs[row] = (st["pivot_block"].tolist(), bool(sing),
                     (time.perf_counter() - t0) * 1e3)
        del a, st
    torch.cuda.empty_cache()

    def judge(row, engine, ranks, world_p):
        n, m, gen, dt = row
        dtype = getattr(torch, dt)
        lay = CyclicLayout.create(n, m, world_p)
        ref_piv = refs[row][0]
        head = ranks[0]
        body = probe_mod.probe_body(m, dtype)
        kappa = head["norm_a"] * head["norm_x"]
        rel = head["residual"] / head["norm_a"]
        gate = gate_threshold(DEFAULT_POLICY, n, kappa, dtype)
        pivots_ok = all(r["pivots"] == head["pivots"] for r in ranks) and (
            head["pivots"] == ref_piv + list(range(len(ref_piv), lay.Nr)))
        steps_ok = all(
            r["probe_steps"] == _live_steps(lay.Nr, world_p, r["rank"],
                                            engine, head["pivots"])
            and r["launches"].get(body, 0) == len(r["probe_steps"])
            and sum(r["launches"].values()) == len(r["probe_steps"])
            for r in ranks)
        for r in ranks:
            for k, c in r["launches"].items():
                totals[k] += c
        checks = {"not_singular": not head["singular"],
                  "pivots_equal_single": pivots_ok,
                  "residual_gate": rel <= gate,
                  "probe_launches_live_steps": steps_ok}
        row_out = {"n": n, "m": m, "generator": gen, "dtype": dt,
                   "engine": engine, "ranks": world_p,
                   "backend": head["backend"],
                   "backend_reason": head["backend_reason"],
                   "checks": checks, "rel_residual": rel, "gate": gate,
                   "kappa": kappa, "ms": head["elapsed"] * 1e3,
                   "single_device_ms": refs[row][2],
                   "launches": [r["launches"].get(body, 0) for r in ranks]}
        if not all(checks.values()):
            failures.append(row_out)
        return row_out

    calls, labels = [], []
    for row in DIST_ROWS:
        n, m, gen, dt = row
        # A first, warm-up run of the row: a rank's first engine run pays
        # its process's first launches (cuBLAS handles, module loads).
        for eng in ("warm",) + DIST_ENGINES:
            engine, grp = eng, (2 if eng == "grouped" else 0)
            if eng == "warm":
                engine = "inplace"
            if eng == "auto":
                engine, grp, _ = resolve_invert_engine(
                    "auto", 0, n, m, getattr(torch, dt), workers=p,
                    device="cuda")
            calls.append((solve_rank_summary,
                          (DistSpec(n, m, gen, dt, engine, grp,
                                    gather=False),)))
            labels.append((row, eng, engine))
    t0 = time.perf_counter()
    results = run_workers(p, run_calls, calls, deadline_s=DIST_DEADLINE_S,
                          device_type="cuda")
    world_s = time.perf_counter() - t0
    for i, (row, eng, engine) in enumerate(labels):
        out = judge(row, engine, [results[r][i] for r in range(p)], p)
        if out["backend"] != want_backend:
            failures.append({"backend": out["backend"], "want":
                             want_backend})
        emit({"phase": phase, "world": world, "requested": eng, **out})
    emit({"phase": phase, "world_s": world_s,
          "note": ("ms: the slowest rank's CUDA events; "
                   + ("a card a rank over nccl" if own_cards else
                      "4 ranks share one card over gloo, not a scaling "
                      "figure"))})
    if own_cards:
        _dist_solve_leg(torch, p, totals, failures, phase)
        return _distributed_cli(phase, p, totals, failures)

    t0 = time.perf_counter()
    n, m, gen, dt = DIST_NCCL_ROW
    spec = DistSpec(n, m, gen, dt, "inplace", 0, gather=False)
    (res,) = run_workers(1, run_calls, [(solve_rank_summary, (spec,))] * 2,
                         deadline_s=DIST_DEADLINE_S, device_type="cuda")
    warm = judge(DIST_NCCL_ROW, "inplace", res[:1], 1)
    out = judge(DIST_NCCL_ROW, "inplace", res[1:], 1)
    out["warm_ms"] = warm["ms"]
    if out["backend"] != "nccl":
        failures.append({"nccl_world": out["backend"]})
    emit({"phase": "distributed", "world": "1 rank", **out,
          "world_s": time.perf_counter() - t0})

    return _distributed_cli(phase, p, totals, failures)


def _distributed_cli(phase: str, p: int, totals: dict, failures: list):
    """The CLI's ``4096 128 --workers p`` (exit 0), then the phase's
    verdict; returns ``totals``."""
    t0 = time.perf_counter()
    rc, lines = _run_cli([4096, 128, "--workers", p])
    emit({"phase": phase, "check": "cli", "argv":
          f"4096 128 --workers {p}", "exit": rc, "out": lines[-4:],
          "wall_s": time.perf_counter() - t0})
    if rc != 0:
        failures.append({"cli": rc, "out": lines[-4:]})
    if failures:
        raise AssertionError(f"{phase} failed its checks: {failures}")
    return totals


def _rank_checks(ranks, Nr: int, p: int, body: str, ref_piv=None):
    """(pivots_ok, steps_ok) of one world's rank outcomes: one pivot
    sequence on every rank, equal to ``ref_piv`` (the single-device
    engine's) plus the padded tail's self-pivots when given; each rank's
    probe steps the steps at which it held a live candidate, and its
    launches of ``body`` those steps, of no other kernel none."""
    head = ranks[0]
    pivots_ok = all(r.get("pivots") == head.get("pivots") for r in ranks)
    if ref_piv is not None:
        pivots_ok = pivots_ok and (
            head["pivots"] == ref_piv + list(range(len(ref_piv), Nr)))
    steps_ok = all(
        r["probe_steps"] == _live_steps(Nr, p, r["rank"], "inplace", None)
        and r["launches"].get(body, 0) == len(r["probe_steps"])
        and sum(r["launches"].values()) == len(r["probe_steps"])
        for r in ranks)
    return pivots_ok, steps_ok


def _add_launches(totals: dict, ranks) -> None:
    for r in ranks:
        for k, c in r["launches"].items():
            totals[k] = totals.get(k, 0) + c


def _dist_file_leg(torch, p: int, tmp: str, totals: dict, failures: list):
    """Leg 1: the matrix written to a text file, then driver.solve(file=,
    workers=p, gather=False) and the CLI on it."""
    from tpu_jordan_torch.driver import solve
    from tpu_jordan_torch.io import write_matrix_file
    from tpu_jordan_torch.ops import block_jordan_invert_inplace, generate
    from tpu_jordan_torch.ops import gj_probe as probe_mod
    from tpu_jordan_torch.parallel.launch import last_world
    from tpu_jordan_torch.parallel.layout import CyclicLayout
    from tpu_jordan_torch.resilience import DEFAULT_POLICY, gate_threshold

    n, m, gen, dt = DIST_FILE_ROW
    dtype = getattr(torch, dt)
    path = os.path.join(tmp, f"{gen}{n}.txt")
    t0 = time.perf_counter()
    write_matrix_file(path, generate(gen, (n, n), torch.float64).numpy())
    write_s = time.perf_counter() - t0
    a = generate(gen, (n, n), dtype, device="cuda")
    _, sing, st = block_jordan_invert_inplace(a, block_size=m,
                                              collect_stats=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    block_jordan_invert_inplace(a, block_size=m)
    torch.cuda.synchronize()
    single_ms = (time.perf_counter() - t0) * 1e3
    ref_piv = st["pivot_block"].tolist()
    del a, st
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = solve(n, m, file=path, workers=p, gather=False)
    wall = time.perf_counter() - t0
    split = last_world()
    lay = CyclicLayout.create(n, m, p)
    body = probe_mod.probe_body(m, dtype)
    pivots_ok, steps_ok = _rank_checks(res.ranks, lay.Nr, p, body, ref_piv)
    gate = gate_threshold(DEFAULT_POLICY, n, res.kappa, dtype)
    _add_launches(totals, res.ranks)
    checks = {"single_not_singular": not bool(sing),
              "pivots_equal_single": pivots_ok,
              "residual_gate": res.rel_residual <= gate,
              "probe_launches_live_steps": steps_ok,
              "strip_rows_le_m": all(0 < r["strip_rows_max"] <= m
                                     for r in res.ranks)}
    out = {"phase": "dist_workloads", "leg": "file", "n": n, "m": m,
           "generator": gen, "dtype": dt, "ranks": p,
           "backend": res.ranks[0]["backend"], "checks": checks,
           "file_bytes": os.path.getsize(path), "write_s": write_s,
           "strip_rows_max": [r["strip_rows_max"] for r in res.ranks],
           "rel_residual": res.rel_residual, "gate": gate,
           "kappa": res.kappa, "ms": res.elapsed * 1e3,
           "single_device_ms": single_ms, "world_wall_s": wall,
           "world_split_s": split,
           "launches": [r["launches"].get(body, 0) for r in res.ranks]}
    t0 = time.perf_counter()
    rc, lines = _run_cli([n, m, path, "--workers", p])
    out["cli"] = {"argv": f"{n} {m} <file> --workers {p}", "exit": rc,
                  "out": lines[-3:], "wall_s": time.perf_counter() - t0}
    checks["cli_exit_0"] = rc == 0
    emit(out)
    if not all(checks.values()):
        failures.append(out)


def _parting_step(piv, ref_piv):
    """The first superstep at which two pivot sequences part (None when
    equal over the reference's length)."""
    return next((t for t, (x, y) in enumerate(zip(piv, ref_piv)) if x != y),
                None)


def _dist_solve_leg(torch, p: int, totals: dict, failures: list,
                    phase: str):
    """Leg 2: one world of p ranks runs solve_sharded (a warm-up, then
    timed) and solve_lookahead at DIST_SOLVE_ROW, and solve_sharded on the
    same A and B in fp64; each held to the single-device solve on the same
    A and B.  Then the CLI's --workload solve --workers p."""
    from tpu_jordan_torch.linalg import block_jordan_solve, solve_system
    from tpu_jordan_torch.ops import generate
    from tpu_jordan_torch.ops import gj_probe as probe_mod
    from tpu_jordan_torch.ops.padding import pad_with_identity
    from tpu_jordan_torch.ops.residual import solve_residual_stats
    from tpu_jordan_torch.parallel import run_calls, run_workers
    from tpu_jordan_torch.parallel.dist_solve import (DistSolveSpec,
                                                      solve_system_rank)
    from tpu_jordan_torch.parallel.launch import last_world
    from tpu_jordan_torch.parallel.layout import CyclicLayout
    from tpu_jordan_torch.parallel.sharded_inplace import (
        gather_solution_1d, scatter_rhs_1d)
    from tpu_jordan_torch.resilience import (DEFAULT_POLICY,
                                             solve_gate_threshold)
    from tpu_jordan_torch.resilience.degrade import backward_error

    n, m, gen, dt, k = DIST_SOLVE_ROW
    lay = CyclicLayout.create(n, m, p)
    runs = (("solve_sharded", dt), ("solve_sharded", dt),
            ("solve_lookahead", dt), ("solve_sharded", "float64"))
    ops, refs, per_rank = {}, {}, [([],) for _ in range(p)]
    for dname in (dt, "float64"):
        dtype = getattr(torch, dname)
        A = generate(gen, (n, n), dtype, device="cuda")
        B = generate(gen, (n, k), dtype, row_offset=n, device="cuda")
        solve_system(A, B, block_size=m)                          # warm
        ref = solve_system(A, B, block_size=m)
        _, _, st = block_jordan_solve(A, B, block_size=m,
                                      collect_stats=True)
        refs[dname] = (ref, st["pivot_block"].tolist())
        ops[dname] = (A, B)
        ap = pad_with_identity(A.cpu(), lay.N).reshape(lay.Nr, m, lay.N)
        bh = B.cpu()
        for r in range(p):
            a_r = ap[r::p].contiguous().numpy()
            b_r = scatter_rhs_1d(bh, lay, r).numpy()
            per_rank[r][0].extend(
                (solve_system_rank, (DistSolveSpec(n, m, dname, e), a_r,
                                     b_r))
                for e, d in runs if d == dname)
        del ap, bh, st
    # Rank-call order follows the dtype loop: the fp32 runs, then fp64.
    runs = tuple(sorted(runs, key=lambda ed: ed[1] != dt))
    t0 = time.perf_counter()
    results = run_workers(p, run_calls, per_rank=per_rank,
                          deadline_s=DIST_DEADLINE_S, device_type="cuda")
    world_s = time.perf_counter() - t0
    split = last_world()
    pivots = {}
    for i, (engine, dname) in enumerate(runs):
        dtype = getattr(torch, dname)
        A, B = ops[dname]
        ref, ref_piv = refs[dname]
        ranks = [results[r][i] for r in range(p)]
        body = probe_mod.probe_body(m, dtype)
        x = gather_solution_1d([r["x_blocks"] for r in ranks], lay,
                               n).to("cuda")
        rel = backward_error(*solve_residual_stats(A, x, B))
        gate = solve_gate_threshold(DEFAULT_POLICY, n, dtype)
        same_piv, steps_ok = _rank_checks(ranks, lay.Nr, p, body)
        piv = ranks[0]["pivots"]
        pivots.setdefault(dname, piv)
        _add_launches(totals, ranks)
        checks = {"not_singular": not any(r["singular"] for r in ranks),
                  "pivots_equal_across_ranks": same_piv,
                  "backward_error_gate": rel <= gate,
                  "probe_launches_live_steps": steps_ok}
        if dname == "float64":
            # fp64 keys carry ~1e-16·κ(block) of noise, far under their
            # spread: the pivots are the single-device engine's exactly.
            checks["pivots_equal_single"] = (
                piv == ref_piv + list(range(len(ref_piv), lay.Nr)))
        else:
            # fp32 keys carry ~1e-7·κ(block): two runs whose GEMMs round
            # differently (a rank's strip is another cuBLAS shape) may part
            # at a near tie.  Held: both engines take the same pivots.
            checks["pivots_equal_across_engines"] = piv == pivots[dname]
        out = {"phase": phase, "leg": "solve", "engine": engine,
               "warm_up": i == 0, "n": n, "m": m, "generator": gen,
               "dtype": dname, "k": k, "ranks": p,
               "backend": ranks[0]["backend"], "checks": checks,
               "pivots_part_from_single_at": _parting_step(piv, ref_piv),
               "rel_residual": rel, "gate": gate,
               "ms": ranks[0]["elapsed"] * 1e3,
               "single_device_ms": ref.elapsed * 1e3,
               "single_device_engine": ref.engine,
               "single_rel_residual": ref.rel_residual,
               "x_max_rel_diff": float((x - ref.x).abs().max()
                                       / ref.x.abs().max()),
               "launches": [r["launches"].get(body, 0) for r in ranks]}
        emit(out)
        if not all(checks.values()):
            failures.append(out)
    emit({"phase": phase, "leg": "solve", "world_s": world_s,
          "world_split_s": split,
          "note": "ms: the slowest rank's CUDA events"
                  + ("" if phase == "nccl4" else
                     "; 4 ranks share one card over gloo, not a scaling "
                     "figure")})
    del ops, refs
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    argv = [n, m, "--workload", "solve", "--generator", gen, "--workers",
            p]
    rc, lines = _run_cli(argv)
    rel_line = next((ln for ln in lines if ln.startswith("rel_residual")),
                    "")
    gate_ok = False
    if rel_line:
        val, cli_gate = rel_line.split()[1], rel_line.split()[-1].rstrip(")")
        gate_ok = float(val) <= float(cli_gate)
    out = {"phase": phase, "leg": "solve", "check": "cli",
           "argv": " ".join(map(str, argv)), "exit": rc, "out": lines[-4:],
           "wall_s": time.perf_counter() - t0,
           "world_split_s": last_world()}
    emit(out)
    if rc != 0 or not gate_ok:
        failures.append(out)


def _dist_ckpt_leg(torch, p: int, tmp: str, totals: dict, failures: list):
    """Leg 3: the checkpointed distributed solve, uninterrupted, then
    preempted by a seeded fault at one boundary and resumed."""
    from tpu_jordan_torch.ops import generate
    from tpu_jordan_torch.ops import gj_probe as probe_mod
    from tpu_jordan_torch.ops.residual import solve_residual_stats
    from tpu_jordan_torch.parallel.launch import last_world
    from tpu_jordan_torch.parallel.layout import CyclicLayout
    from tpu_jordan_torch.resilience import (DEFAULT_POLICY, FaultPlan,
                                             FaultSpec, activate,
                                             solve_gate_threshold)
    from tpu_jordan_torch.resilience.checkpoint import (
        CheckpointStore, PreemptedError, checkpointed_solve)
    from tpu_jordan_torch.resilience.degrade import backward_error

    n, m, gen, dt, k, cad, hit = DIST_CKPT_ROW
    dtype = getattr(torch, dt)
    A = generate(gen, (n, n), dtype, device="cuda")
    B = generate(gen, (n, k), dtype, row_offset=n, device="cuda")
    lay = CyclicLayout.create(n, m, p)
    body = probe_mod.probe_body(m, dtype)
    store = CheckpointStore(os.path.join(tmp, "ckpt"))
    kw = dict(store=store, cadence=cad, engine="fori", workers=p)
    t0 = time.perf_counter()
    x0, sing0, info0 = checkpointed_solve(A, B, m, run_id="dist_u", **kw)
    wall0 = time.perf_counter() - t0
    splits = {"uninterrupted": last_world()}
    checks = {"body_is_gj_probe": body == "gj_probe",
              "not_singular": not sing0}
    ranks0 = info0["ranks"]
    _, checks["probe_launches_live_steps"] = _rank_checks(
        [dict(r, pivots=None) for r in ranks0], lay.Nr, p, body)
    _add_launches(totals, ranks0)
    rel = backward_error(*solve_residual_stats(A, x0, B))
    gate = solve_gate_threshold(DEFAULT_POLICY, n, dtype)
    checks["backward_error_gate"] = rel <= gate
    plan = FaultPlan([FaultSpec("preempt", (hit,), "permanent")])
    step, info_p = None, None
    t0 = time.perf_counter()
    with activate(plan):
        try:
            checkpointed_solve(A, B, m, run_id="dist_p", **kw)
        except PreemptedError as e:
            step, info_p = e.step, getattr(e, "info", None)
    wall_p = time.perf_counter() - t0
    splits["preempted"] = last_world()
    checks["preempted_at_boundary"] = step == (hit - 1) * cad
    key, stored_step, arrays = store.peek("dist_p")
    checks["jax_format"] = (
        key.topology == f"1d:{p}" and key.workload == "solve"
        and key.engine == "fori" and (key.n, key.m, key.Nr, key.nrhs)
        == (n, m, lay.Nr, k) and key.dtype == dt
        and stored_step == step
        and arrays["W"].shape == (lay.Nr, m, lay.N)
        and arrays["X"].shape == (lay.Nr, m, k)
        and arrays["singular"].shape == (p,)
        and str(arrays["W"].dtype) == dt and "swaps" not in arrays)
    t0 = time.perf_counter()
    x1, _, info1 = checkpointed_solve(A, B, m, run_id="dist_p",
                                      resume_from="dist_p", **kw)
    wall1 = time.perf_counter() - t0
    splits["resumed"] = last_world()
    checks["resume_bits_equal"] = bool(torch.equal(x0, x1))
    checks["resumed_at_step"] = (info1["start_step"] == step
                                 and info1["resumed"])
    # The preempted and the resumed worlds probed every live step once.
    parts = [r for info in (info_p, info1) if info for r in info["ranks"]]
    for r in parts:
        for kk, c in r["launches"].items():
            totals[kk] = totals.get(kk, 0) + c
    checks["split_launches_live_steps"] = all(
        sorted(sum((q["probe_steps"] for q in parts if q["rank"] == rk),
                   [])) == _live_steps(lay.Nr, p, rk, "inplace", None)
        and sum(q["launches"].get(body, 0) for q in parts
                if q["rank"] == rk) == len(_live_steps(lay.Nr, p, rk,
                                                       "inplace", None))
        for rk in range(p))
    checks["ledger_invariant"] = store.ledger()["invariant_holds"]
    out = {"phase": "dist_workloads", "leg": "checkpoint", "n": n, "m": m,
           "generator": gen, "dtype": dt, "k": k, "ranks": p,
           "cadence": cad, "preempt_call": hit, "checks": checks,
           "rel_residual": rel, "gate": gate,
           "ckpt_bytes": info0["ckpt_bytes_last"],
           "ckpt_writes": info0["ckpt_written"],
           "ckpt_write_s": info0["ckpt_write_seconds"],
           "wall_s": {"uninterrupted": wall0, "preempted": wall_p,
                      "resumed": wall1},
           "world_split_s": splits,
           "launches": [r["launches"].get(body, 0) for r in ranks0]}
    emit(out)
    if not all(checks.values()):
        failures.append(out)


def _dist_tune_leg(torch, p: int, tmp: str, totals: dict, failures: list):
    """Leg 4: driver.solve(tune=True) at p ranks, then the same call again,
    which must hit the plan cache and measure nothing."""
    from tpu_jordan_torch.driver import solve
    from tpu_jordan_torch.parallel.launch import last_world
    from tpu_jordan_torch.resilience import DEFAULT_POLICY, gate_threshold
    from tpu_jordan_torch.tuning import tuner as tuner_mod

    n, m, dt = DIST_TUNE_ROW
    cache = os.path.join(tmp, "plans.json")
    out = {"phase": "dist_workloads", "leg": "tune", "n": n, "m": m,
           "dtype": dt, "ranks": p, "calls": []}
    results = []
    for _ in range(2):
        meas0 = tuner_mod._M_MEASUREMENTS.total()
        hits0 = tuner_mod._M_HITS.total()
        t0 = time.perf_counter()
        res = solve(n, m, dtype=dt, workers=p, tune=True, plan_cache=cache)
        results.append(res)
        _add_launches(totals, res.ranks)
        out["calls"].append({
            "engine": res.engine, "source": res.plan.source,
            "measurements": tuner_mod._M_MEASUREMENTS.total() - meas0,
            "cache_hits": tuner_mod._M_HITS.total() - hits0,
            "ms": res.elapsed * 1e3, "wall_s": time.perf_counter() - t0,
            "world_split_s": last_world()})
    first, second = out["calls"]
    out["trials"] = [{"config": t["config"],
                      "median_ms": t["measured"] * 1e3,
                      "spread_pct": t["spread_pct"],
                      "projected_ms": (None if t["projected"] is None
                                       else t["projected"] * 1e3)}
                     for t in results[0].plan.trials]
    out["checks"] = {
        "measured": first["source"] == "measured"
        and first["measurements"] == len(out["trials"]) > 0,
        "second_call_hits_cache": second["cache_hits"] == 1
        and second["measurements"] == 0
        and second["engine"] == first["engine"],
        "residual_gate": all(
            r.rel_residual <= gate_threshold(DEFAULT_POLICY, n, r.kappa,
                                             getattr(torch, dt))
            for r in results)}
    emit(out)
    if not all(out["checks"].values()):
        failures.append(out)


def phase_dist_workloads(torch, counters):
    """The rest of the 1D distributed path on DIST_WORKERS ranks sharing
    the card (gloo): the file input, the [A | B] solves, the checkpointed
    solve and tune=True (the module docstring's phase 16).  Returns the
    ranks' launches summed."""
    import shutil
    import tempfile

    p = DIST_WORKERS
    totals = dict.fromkeys(counters, 0)
    failures = []
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    try:
        t0 = time.perf_counter()
        _dist_file_leg(torch, p, tmp, totals, failures)
        legs = {"file": time.perf_counter() - t0}
        _dist_solve_leg(torch, p, totals, failures, "dist_workloads")
        legs["solve"] = time.perf_counter() - t0 - sum(legs.values())
        _dist_ckpt_leg(torch, p, tmp, totals, failures)
        legs["checkpoint"] = time.perf_counter() - t0 - sum(legs.values())
        _dist_tune_leg(torch, p, tmp, totals, failures)
        legs["tune"] = time.perf_counter() - t0 - sum(legs.values())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "dist_workloads", "legs_s": legs})
    if failures:
        raise AssertionError(f"dist_workloads failed its checks: "
                             f"{failures}")
    return totals


def _live_rows_2d(Nr: int, engine: str, pivots) -> list:
    """The rows live at each step of a 2D run: rows >= t (swap engines),
    or the physical rows not yet retired (swap-free: its swap-coordinate
    pivots replayed)."""
    if engine != "swapfree":
        return [list(range(t, Nr)) for t in range(Nr)]
    pos, ipos, retired, out = list(range(Nr)), list(range(Nr)), set(), []
    for t, piv_pos in enumerate(pivots):
        out.append(sorted(set(range(Nr)) - retired))
        g, x = ipos[piv_pos], ipos[t]
        retired.add(g)
        pos[x], pos[g] = piv_pos, t
        ipos[t], ipos[piv_pos] = g, x
    return out


def _probe_checks_2d(ranks, Nr: int, engine: str, body: str):
    """(probed_once, launches_ok) of one 2D world's rank outcomes: at every
    step the rows probed across the ranks are the live rows, each by one
    rank; each rank launched ``body`` once at each step of a non-empty
    slice, and no other kernel."""
    by_step = {}
    for r in ranks:
        for t, rows in r["probed"]:
            by_step.setdefault(t, []).extend(rows)
    probed_once = ([sorted(by_step.get(t, [])) for t in range(Nr)]
                   == _live_rows_2d(Nr, engine, ranks[0]["pivots"]))
    launches_ok = all(
        r["launches"].get(body, 0) == len(r["probe_steps"])
        == sum(r["launches"].values())
        and r["probe_steps"] == [t for t, rows in r["probed"] if rows]
        for r in ranks)
    return probed_once, launches_ok


def _dist2d_world(torch, p: int, own_cards: bool, tmp: str, refs: dict):
    """One world of ``p`` ranks for the 2D legs 1-5's rank work: the invert
    runs, the fp64 gather=False row, the file row, the solves and the
    checkpoint leg's monolithic runs (the nccl4 phase: leg 1's inplace
    runs and the solves).  Returns (labels, per-rank results, wall s)."""
    from tpu_jordan_torch.io import write_matrix_file
    from tpu_jordan_torch.ops import generate
    from tpu_jordan_torch.parallel import run_calls, run_workers
    from tpu_jordan_torch.parallel.dist_solve import (
        DistSolveSpec, DistSpec, solve_rank, solve_rank_summary,
        solve_system_rank)
    from tpu_jordan_torch.parallel.jordan2d import _own_blocks
    from tpu_jordan_torch.parallel.jordan2d_inplace import scatter_rhs_2d
    from tpu_jordan_torch.parallel.layout import CyclicLayout2D
    from tpu_jordan_torch.ops.padding import pad_with_identity

    mesh = DIST2D_MESH
    n, m, gen, dt = DIST2D_ROW
    common, labels = [], []

    def add(label, fn, *args):
        common.append((fn, args))
        labels.append(label)

    runs = (DIST2D_RUNS if not own_cards
            else tuple(r for r in DIST2D_RUNS if r[0] == "inplace"))
    add(("warm",), solve_rank_summary,
        DistSpec(n, m, gen, dt, "inplace", gather=False, mesh=mesh))
    for engine, k, layout in runs:
        add(("invert", mesh, engine, k, layout), solve_rank_summary,
            DistSpec(n, m, gen, dt, engine, k, gather=False, mesh=mesh,
                     probe_layout=layout))
    if not own_cards:
        for shape in DIST2D_MESHES:
            add(("invert", shape, "inplace", 0, "auto"), solve_rank_summary,
                DistSpec(n, m, gen, dt, "inplace", gather=False,
                         mesh=shape))
        n2, m2, gen2, dt2 = DIST2D_FP64_ROW
        add(("fp64",), solve_rank,
            DistSpec(n2, m2, gen2, dt2, "inplace", gather=False, mesh=mesh))
        nf, mf, genf, dtf = DIST2D_FILE_ROW
        path = os.path.join(tmp, f"{genf}{nf}.txt")
        t0 = time.perf_counter()
        write_matrix_file(path, generate(genf, (nf, nf),
                                         torch.float64).numpy())
        refs["file_write_s"] = time.perf_counter() - t0
        refs["file_bytes"] = os.path.getsize(path)
        add(("file",), solve_rank_summary,
            DistSpec(nf, mf, genf, dtf, "inplace", gather=False,
                     file=path, mesh=mesh))
        nc, mc, genc, dtc, kc_, _, _ = DIST2D_CKPT_ROW
        add(("ckpt_invert",), solve_rank,
            DistSpec(nc, mc, genc, dtc, "inplace", gather=True, mesh=mesh))
    # The solves: each rank's own shards of [A | B] (run_workers(per_rank)).
    per_rank = [([],) for _ in range(p)]
    solve_labels = []
    ns, ms, gens, dts, ks = DIST2D_SOLVE_ROW
    solves = [((ns, ms, gens, d, ks), e) for d, e in (
        (dts, "solve_sharded"), (dts, "solve_sharded"),
        (dts, "solve_lookahead"), ("float64", "solve_sharded"))]
    if not own_cards:
        nc, mc, genc, dtc, kc_, _, _ = DIST2D_CKPT_ROW
        solves.append(((nc, mc, genc, dtc, kc_), "solve_sharded"))
    shards = {}
    for (nn, mm, g, d, kk), engine in solves:
        if (nn, d) not in shards:
            dtype = getattr(torch, d)
            A = generate(g, (nn, nn), dtype, device="cuda")
            B = generate(g, (nn, kk), dtype, row_offset=nn, device="cuda")
            refs.setdefault("ops", {})[(nn, d)] = (A, B)
            lay = CyclicLayout2D.create(nn, mm, *mesh)
            ap = pad_with_identity(A.cpu(), lay.N).reshape(
                lay.Nr, mm, lay.Nr, mm)
            shards[(nn, d)] = [
                (_own_blocks(ap, lay, *divmod(r, mesh[1])).numpy(),
                 scatter_rhs_2d(B.cpu(), lay, r // mesh[1]).numpy())
                for r in range(p)]
            del ap
        for r in range(p):
            a_r, b_r = shards[(nn, d)][r]
            per_rank[r][0].append((solve_system_rank, (DistSolveSpec(
                nn, mm, d, engine, mesh=mesh), a_r, b_r)))
        solve_labels.append(("solve", nn, d, engine))
    shards.clear()
    for r in range(p):
        per_rank[r][0][:0] = common
    t0 = time.perf_counter()
    results = run_workers(p, run_calls, per_rank=per_rank,
                          deadline_s=DIST_DEADLINE_S, device_type="cuda")
    return labels + solve_labels, results, time.perf_counter() - t0


def _single_refs(torch, refs: dict, own_cards: bool) -> None:
    """The single-device references of the 2D legs: the in-place engine's
    pivots and warm ms at the invert rows, the solve engine's pivots and
    solve_system's ms at the solve rows."""
    from tpu_jordan_torch.linalg import block_jordan_solve, solve_system
    from tpu_jordan_torch.ops import block_jordan_invert_inplace, generate

    rows = [DIST2D_ROW] + ([] if own_cards else [DIST2D_FP64_ROW])
    for n, m, gen, dt in rows:
        a = generate(gen, (n, n), getattr(torch, dt), device="cuda")
        inv, sing, st = block_jordan_invert_inplace(a, block_size=m,
                                                    collect_stats=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        block_jordan_invert_inplace(a, block_size=m)
        torch.cuda.synchronize()
        refs[("invert", n, dt)] = (st["pivot_block"].tolist(), bool(sing),
                                   (time.perf_counter() - t0) * 1e3,
                                   inv[:10, :10].cpu())
        del a, inv, st
    n, m, gen, dt, k = DIST2D_SOLVE_ROW
    for d in (dt, "float64"):
        dtype = getattr(torch, d)
        A = generate(gen, (n, n), dtype, device="cuda")
        B = generate(gen, (n, k), dtype, row_offset=n, device="cuda")
        solve_system(A, B, block_size=m)                          # warm
        ref = solve_system(A, B, block_size=m)
        _, _, st = block_jordan_solve(A, B, block_size=m,
                                      collect_stats=True)
        refs[("solve", d)] = (ref, st["pivot_block"].tolist())
        del A, B, st
    torch.cuda.empty_cache()


def _dist2d_invert_legs(torch, labels, results, refs, p, totals, failures,
                        phase):
    """Legs 1-3 (the nccl4 phase: leg 1's inplace runs) from the world's
    results."""
    from tpu_jordan_torch.ops import gj_probe as probe_mod
    from tpu_jordan_torch.parallel.jordan2d_inplace import (
        gather_inverse_inplace_2d, inverse_corner_2d)
    from tpu_jordan_torch.parallel.layout import CyclicLayout2D
    from tpu_jordan_torch.resilience import DEFAULT_POLICY, gate_threshold

    def ranks_of(label):
        i = labels.index(label)
        return [results[r][i] for r in range(p)]

    n, m, gen, dt = DIST2D_ROW
    dtype = getattr(torch, dt)
    ref_piv, ref_sing, single_ms, _ = refs[("invert", n, dt)]
    body = probe_mod.probe_body(m, dtype)
    base = {}
    for label in labels:
        if label[0] != "invert":
            continue
        _, shape, engine, k, layout = label
        ranks = ranks_of(label)
        head = ranks[0]
        lay = CyclicLayout2D.create(n, m, *shape)
        kappa = head["norm_a"] * head["norm_x"]
        rel = head["residual"] / head["norm_a"]
        gate = gate_threshold(DEFAULT_POLICY, n, kappa, dtype)
        probed_once, launches_ok = _probe_checks_2d(ranks, lay.Nr, engine,
                                                    body)
        _add_launches(totals, ranks)
        piv = head["pivots"]
        checks = {
            "not_singular": not head["singular"] and not ref_sing,
            "pivots_equal_across_ranks": all(r["pivots"] == piv
                                             for r in ranks),
            "pivots_equal_single": piv == ref_piv + list(
                range(len(ref_piv), lay.Nr)),
            "residual_gate": rel <= gate,
            "probed_once_live": probed_once,
            "probe_launches_nonempty_steps": launches_ok}
        digests = [r["inverse_sha256"] for r in ranks]
        if shape == DIST2D_MESH and engine == "inplace":
            base.setdefault(layout, digests)
        out = {"phase": phase, "leg": "invert", "mesh": list(shape),
               "n": n, "m": m, "generator": gen, "dtype": dt,
               "engine": engine, "group": k, "probe_layout": layout,
               "backend": head["backend"], "checks": checks,
               "rel_residual": rel, "gate": gate, "kappa": kappa,
               "ms": head["elapsed"] * 1e3, "single_device_ms": single_ms,
               "launches": [r["launches"].get(body, 0) for r in ranks],
               "digests": digests}
        if shape == DIST2D_MESH and engine in ("lookahead", "swapfree"):
            out["bits_equal_inplace"] = digests == base.get("auto")
            if engine == "swapfree":
                checks["bits_equal_inplace"] = out["bits_equal_inplace"]
        emit(out)
        if not all(checks.values()):
            failures.append(out)
    if "column" in base and "owner" in base:
        ok = base["column"] == base["owner"]
        emit({"phase": phase, "leg": "invert", "check": "layouts_bitmatch",
              "ok": ok})
        if not ok:
            failures.append({"layouts_bitmatch": False})
    if ("fp64",) in labels:
        n2, m2, gen2, dt2 = DIST2D_FP64_ROW
        dtype2 = getattr(torch, dt2)
        ref_piv2, _, single2, ref_corner = refs[("invert", n2, dt2)]
        ranks = ranks_of(("fp64",))
        head = ranks[0]
        lay = CyclicLayout2D.create(n2, m2, *DIST2D_MESH)
        blocks = [r["blocks"] for r in ranks]
        corner = inverse_corner_2d(blocks, lay, n2)
        full = gather_inverse_inplace_2d(blocks, lay, n2)
        kappa = head["norm_a"] * head["norm_x"]
        rel = head["residual"] / head["norm_a"]
        gate = gate_threshold(DEFAULT_POLICY, n2, kappa, dtype2)
        body2 = probe_mod.probe_body(m2, dtype2)
        probed_once, launches_ok = _probe_checks_2d(ranks, lay.Nr,
                                                    "inplace", body2)
        _add_launches(totals, ranks)
        checks = {"not_singular": not head["singular"],
                  "pivots_equal_single": head["pivots"] == ref_piv2 + list(
                      range(len(ref_piv2), lay.Nr)),
                  "residual_gate": rel <= gate,
                  "corner_equals_gathered": bool(torch.equal(
                      corner, full[:10, :10])),
                  "corner_near_single": float(
                      (corner - ref_corner).abs().max()
                      / ref_corner.abs().max()) <= 1e-9,
                  "probed_once_live": probed_once,
                  "probe_launches_nonempty_steps": launches_ok}
        del full, blocks
        out = {"phase": phase, "leg": "fp64_no_gather", "mesh":
               list(DIST2D_MESH), "n": n2, "m": m2, "generator": gen2,
               "dtype": dt2, "checks": checks, "rel_residual": rel,
               "gate": gate, "kappa": kappa, "ms": head["elapsed"] * 1e3,
               "single_device_ms": single2,
               "launches": [r["launches"].get(body2, 0) for r in ranks]}
        emit(out)
        if not all(checks.values()):
            failures.append(out)
    if ("file",) in labels:
        nf, mf, genf, dtf = DIST2D_FILE_ROW
        ranks = ranks_of(("file",))
        gen_ranks = ranks_of(("invert", DIST2D_MESH, "inplace", 0, "auto"))
        head = ranks[0]
        lay = CyclicLayout2D.create(nf, mf, *DIST2D_MESH)
        kappa = head["norm_a"] * head["norm_x"]
        rel = head["residual"] / head["norm_a"]
        gate = gate_threshold(DEFAULT_POLICY, nf, kappa, getattr(torch, dtf))
        probed_once, launches_ok = _probe_checks_2d(ranks, lay.Nr,
                                                    "inplace", body)
        _add_launches(totals, ranks)
        checks = {"not_singular": not head["singular"],
                  "pivots_equal_generated": head["pivots"]
                  == gen_ranks[0]["pivots"],
                  "residual_gate": rel <= gate,
                  "strip_rows_le_m": all(0 < r["strip_rows_max"] <= mf
                                         for r in ranks),
                  "probed_once_live": probed_once,
                  "probe_launches_nonempty_steps": launches_ok}
        out = {"phase": phase, "leg": "file", "mesh": list(DIST2D_MESH),
               "n": nf, "m": mf, "generator": genf, "dtype": dtf,
               "checks": checks, "file_bytes": refs["file_bytes"],
               "write_s": refs["file_write_s"],
               "strip_rows_max": [r["strip_rows_max"] for r in ranks],
               "rel_residual": rel, "gate": gate,
               "ms": head["elapsed"] * 1e3,
               "launches": [r["launches"].get(body, 0) for r in ranks]}
        emit(out)
        if not all(checks.values()):
            failures.append(out)


def _dist2d_solve_leg(torch, labels, results, refs, p, totals, failures,
                      phase):
    """Leg 4 from the world's results, then the CLI's --workload solve on
    the mesh."""
    from tpu_jordan_torch.ops import gj_probe as probe_mod
    from tpu_jordan_torch.ops.residual import solve_residual_stats
    from tpu_jordan_torch.parallel.jordan2d_inplace import gather_solution_2d
    from tpu_jordan_torch.parallel.launch import last_world
    from tpu_jordan_torch.parallel.layout import CyclicLayout2D
    from tpu_jordan_torch.resilience import (DEFAULT_POLICY,
                                             solve_gate_threshold)
    from tpu_jordan_torch.resilience.degrade import backward_error

    n, m, gen, dt, k = DIST2D_SOLVE_ROW
    lay = CyclicLayout2D.create(n, m, *DIST2D_MESH)
    pivots = {}
    first = True
    for i, label in enumerate(labels):
        if label[0] != "solve" or label[1] != n:
            continue
        _, _, dname, engine = label
        ranks = [results[r][i] for r in range(p)]
        dtype = getattr(torch, dname)
        A, B = refs["ops"][(n, dname)]
        ref, ref_piv = refs[("solve", dname)]
        body = probe_mod.probe_body(m, dtype)
        x = gather_solution_2d([r["x_blocks"] for r in ranks], lay,
                               n).to("cuda")
        rel = backward_error(*solve_residual_stats(A, x, B))
        gate = solve_gate_threshold(DEFAULT_POLICY, n, dtype)
        piv = ranks[0]["pivots"]
        pivots.setdefault(dname, piv)
        probed_once, launches_ok = _probe_checks_2d(
            [dict(r, pivots=piv) for r in ranks], lay.Nr, "inplace", body)
        _add_launches(totals, ranks)
        checks = {"not_singular": not any(r["singular"] for r in ranks),
                  "pivots_equal_across_ranks": all(r["pivots"] == piv
                                                   for r in ranks),
                  "backward_error_gate": rel <= gate,
                  "x_replicas_bits_equal": all(bool(torch.equal(
                      r["x_blocks"], ranks[r["kr"] * DIST2D_MESH[1]][
                          "x_blocks"])) for r in ranks),
                  "probed_once_live": probed_once,
                  "probe_launches_nonempty_steps": launches_ok}
        if dname == "float64":
            checks["pivots_equal_single"] = (
                piv == ref_piv + list(range(len(ref_piv), lay.Nr)))
        else:
            checks["pivots_equal_across_engines"] = piv == pivots[dname]
        out = {"phase": phase, "leg": "solve", "mesh": list(DIST2D_MESH),
               "engine": engine, "warm_up": first, "n": n, "m": m,
               "generator": gen, "dtype": dname, "k": k,
               "backend": ranks[0]["backend"], "checks": checks,
               "pivots_part_from_single_at": _parting_step(piv, ref_piv),
               "rel_residual": rel, "gate": gate,
               "ms": ranks[0]["elapsed"] * 1e3,
               "single_device_ms": ref.elapsed * 1e3,
               "launches": [r["launches"].get(body, 0) for r in ranks]}
        first = False
        emit(out)
        if not all(checks.values()):
            failures.append(out)
    t0 = time.perf_counter()
    argv = [n, m, "--workload", "solve", "--generator", gen, "--workers",
            f"{DIST2D_MESH[0]}x{DIST2D_MESH[1]}"]
    rc, lines = _run_cli(argv)
    rel_line = next((ln for ln in lines if ln.startswith("rel_residual")),
                    "")
    gate_ok = False
    if rel_line:
        val, cli_gate = rel_line.split()[1], rel_line.split()[-1].rstrip(")")
        gate_ok = float(val) <= float(cli_gate)
    out = {"phase": phase, "leg": "solve", "check": "cli",
           "argv": " ".join(map(str, argv)), "exit": rc, "out": lines[-4:],
           "wall_s": time.perf_counter() - t0,
           "world_split_s": last_world()}
    emit(out)
    if rc != 0 or not gate_ok:
        failures.append(out)


def _dist2d_ckpt_leg(torch, labels, results, refs, p, tmp, totals,
                     failures):
    """Leg 5: the checkpointed invert and solve on the mesh, each
    preempted by a seeded fault at one boundary and resumed; the resumed
    bits against the world's monolithic runs of the same engine (the
    uninterrupted run), the stored file in the JAX 2D format."""
    from tpu_jordan_torch.ops import gj_probe as probe_mod
    from tpu_jordan_torch.parallel.jordan2d_inplace import gather_solution_2d
    from tpu_jordan_torch.parallel.launch import last_world
    from tpu_jordan_torch.parallel.layout import CyclicLayout2D
    from tpu_jordan_torch.resilience import FaultPlan, FaultSpec, activate
    from tpu_jordan_torch.resilience.checkpoint import (
        CheckpointStore, PreemptedError, checkpointed_invert,
        checkpointed_solve)

    n, m, gen, dt, k, cad, hit = DIST2D_CKPT_ROW
    dtype = getattr(torch, dt)
    lay = CyclicLayout2D.create(n, m, *DIST2D_MESH)
    body = probe_mod.probe_body(m, dtype)
    A, B = refs["ops"][(n, dt)]
    mono_inv = results[0][labels.index(("ckpt_invert",))]["inverse"]
    i = labels.index(("solve", n, dt, "solve_sharded"))
    mono_x = gather_solution_2d([results[r][i]["x_blocks"]
                                 for r in range(p)], lay, n)
    store = CheckpointStore(os.path.join(tmp, "ckpt2d"))
    topo = f"2d:{DIST2D_MESH[0]}x{DIST2D_MESH[1]}"
    for workload, fn, args, mono in (
            ("invert", checkpointed_invert, (A, m), mono_inv),
            ("solve", checkpointed_solve, (A, B, m), mono_x)):
        run_id = f"dist2d_{workload}"
        kw = dict(store=store, cadence=cad, engine="fori",
                  workers=DIST2D_MESH)
        plan = FaultPlan([FaultSpec("preempt", (hit,), "permanent")])
        step, info_p = None, None
        t0 = time.perf_counter()
        with activate(plan):
            try:
                fn(*args, run_id=run_id, **kw)
            except PreemptedError as e:
                step, info_p = e.step, getattr(e, "info", None)
        wall_p = time.perf_counter() - t0
        split_p = last_world()
        key, stored_step, arrays = store.peek(run_id)
        fmt = (key.topology == topo and key.workload == workload
               and (key.n, key.m, key.Nr) == (n, m, lay.Nr)
               and key.dtype == dt and stored_step == step
               and arrays["W"].shape == (lay.Nr, m, lay.N)
               and arrays["singular"].shape == DIST2D_MESH
               and str(arrays["W"].dtype) == dt)
        if workload == "invert":
            fmt = fmt and arrays["swaps"].shape == DIST2D_MESH + (lay.Nr,)
        else:
            fmt = (fmt and arrays["X"].shape == (lay.Nr, m, k)
                   and "swaps" not in arrays)
        t0 = time.perf_counter()
        out_r, sing_r, info_r = fn(*args, run_id=run_id,
                                   resume_from=run_id, **kw)
        wall_r = time.perf_counter() - t0
        split_r = last_world()
        parts = [q for info in (info_p, info_r) if info
                 for q in info["ranks"]]
        _add_launches(totals, parts)
        launches = sum(q["launches"].get(body, 0) for q in parts)
        steps = sum(len(q["probe_steps"]) for q in parts)
        writes = (info_p or {}).get("ckpt_write_seconds", []) + info_r[
            "ckpt_write_seconds"]
        checks = {"body_is_gj_probe": body == "gj_probe",
                  "preempted_at_boundary": step == (hit - 1) * cad,
                  "jax_2d_format": fmt,
                  "resumed_at_step": info_r["start_step"] == step
                  and info_r["resumed"],
                  "not_singular": not sing_r,
                  "resume_bits_equal_uninterrupted": bool(torch.equal(
                      out_r.cpu(), mono.to(out_r.dtype))),
                  "launches_equal_probe_steps": launches == steps > 0,
                  "ledger_invariant": store.ledger()["invariant_holds"]}
        out = {"phase": "dist2d", "leg": "checkpoint", "workload": workload,
               "mesh": list(DIST2D_MESH), "n": n, "m": m, "generator": gen,
               "dtype": dt, "k": k if workload == "solve" else 0,
               "cadence": cad, "preempt_call": hit, "checks": checks,
               "ckpt_bytes": info_r["ckpt_bytes_last"],
               "ckpt_writes": len(writes), "ckpt_write_s": writes,
               "wall_s": {"preempted": wall_p, "resumed": wall_r},
               "world_split_s": {"preempted": split_p, "resumed": split_r},
               "launches": launches}
        emit(out)
        if not all(checks.values()):
            failures.append(out)


def _dist2d_tune_leg(torch, tmp: str, totals: dict, failures: list):
    """Leg 6: driver.solve(tune=True) on the mesh, then the same call
    again, which must hit the plan cache and measure nothing."""
    from tpu_jordan_torch.driver import solve
    from tpu_jordan_torch.parallel.launch import last_world
    from tpu_jordan_torch.resilience import DEFAULT_POLICY, gate_threshold
    from tpu_jordan_torch.tuning import tuner as tuner_mod

    n, m, dt = DIST2D_TUNE_ROW
    cache = os.path.join(tmp, "plans2d.json")
    out = {"phase": "dist2d", "leg": "tune", "n": n, "m": m, "dtype": dt,
           "mesh": list(DIST2D_MESH), "calls": []}
    results = []
    for _ in range(2):
        meas0 = tuner_mod._M_MEASUREMENTS.total()
        hits0 = tuner_mod._M_HITS.total()
        t0 = time.perf_counter()
        res = solve(n, m, dtype=dt, workers=DIST2D_MESH, tune=True,
                    plan_cache=cache)
        results.append(res)
        _add_launches(totals, res.ranks)
        out["calls"].append({
            "engine": res.engine, "source": res.plan.source,
            "measurements": tuner_mod._M_MEASUREMENTS.total() - meas0,
            "cache_hits": tuner_mod._M_HITS.total() - hits0,
            "ms": res.elapsed * 1e3, "wall_s": time.perf_counter() - t0,
            "world_split_s": last_world()})
    first, second = out["calls"]
    out["trials"] = [{"config": t["config"],
                      "median_ms": t["measured"] * 1e3,
                      "spread_pct": t["spread_pct"],
                      "projected_ms": (None if t["projected"] is None
                                       else t["projected"] * 1e3)}
                     for t in results[0].plan.trials]
    out["checks"] = {
        "measured": first["source"] == "measured"
        and first["measurements"] == len(out["trials"]) > 0,
        "second_call_hits_cache": second["cache_hits"] == 1
        and second["measurements"] == 0
        and second["engine"] == first["engine"],
        "residual_gate": all(
            r.rel_residual <= gate_threshold(DEFAULT_POLICY, n, r.kappa,
                                             getattr(torch, dt))
            for r in results)}
    emit(out)
    if not all(out["checks"].values()):
        failures.append(out)


def phase_dist2d(torch, counters, own_cards: bool = False):
    """The 2D block-cyclic path (the module docstring's phase 17) on one
    world of DIST_WORKERS ranks whose subgroups give the meshes (2, 2),
    (1, 4) and (4, 1): sharing the card over gloo, or with ``own_cards``
    (the nccl4 phase) a card a rank over nccl, leg 1's inplace runs and
    leg 4 only.  Returns the ranks' launches summed."""
    import shutil
    import tempfile

    from tpu_jordan_torch.parallel.launch import last_world

    p = DIST_WORKERS
    phase = "nccl4" if own_cards else "dist2d"
    totals = dict.fromkeys(counters, 0)
    failures = []
    refs = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dist2d_")
    legs = {}
    try:
        t0 = time.perf_counter()
        _single_refs(torch, refs, own_cards)
        legs["single_refs"] = time.perf_counter() - t0
        labels, results, world_s = _dist2d_world(torch, p, own_cards, tmp,
                                                 refs)
        backend = results[0][0]["backend"]
        emit({"phase": phase, "world_s": world_s, "backend": backend,
              "world_split_s": last_world(),
              "note": "ms: the slowest rank's CUDA events; " + (
                  "a card a rank over nccl" if own_cards else
                  "4 ranks share one card over gloo, not a scaling "
                  "figure")})
        if backend != ("nccl" if own_cards else "gloo"):
            failures.append({"backend": backend})
        legs["world"] = time.perf_counter() - t0 - sum(legs.values())
        _dist2d_invert_legs(torch, labels, results, refs, p, totals,
                            failures, phase)
        _dist2d_solve_leg(torch, labels, results, refs, p, totals, failures,
                          phase)
        legs["solve_cli"] = time.perf_counter() - t0 - sum(legs.values())
        if not own_cards:
            _dist2d_ckpt_leg(torch, labels, results, refs, p, tmp, totals,
                             failures)
            legs["checkpoint"] = (time.perf_counter() - t0
                                  - sum(legs.values()))
            _dist2d_tune_leg(torch, tmp, totals, failures)
            legs["tune"] = time.perf_counter() - t0 - sum(legs.values())
        del results
        refs.clear()
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        argv = [4096, 128, "--workers", f"{DIST2D_MESH[0]}x{DIST2D_MESH[1]}"]
        rc, lines = _run_cli(argv)
        emit({"phase": phase, "check": "cli", "argv": " ".join(map(str,
                                                                  argv)),
              "exit": rc, "out": lines[-4:],
              "wall_s": time.perf_counter() - t1})
        if rc != 0:
            failures.append({"cli": rc, "out": lines[-4:]})
        legs["invert_cli"] = time.perf_counter() - t0 - sum(legs.values())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": phase, "mesh_legs_s": legs})
    if failures:
        raise AssertionError(f"{phase} (2D) failed its checks: {failures}")
    return totals


def _obs_world(torch, own_cards: bool):
    """Leg 2's world of DIST_WORKERS ranks: each OBS_RUNS run (OBS_NCCL_RUNS
    with ``own_cards``) warm with recording off, then off, on, on, off.
    Returns (labels, per-rank results, wall s)."""
    from tpu_jordan_torch.obs.comm import run_leg
    from tpu_jordan_torch.parallel import run_calls, run_workers

    calls, labels = [], []
    for name, workload, n, m, gen, dt, workers, engine, gather, k in (
            OBS_NCCL_RUNS if own_cards else OBS_RUNS):
        kw = dict(n=n, m=m, workers=workers, engine=engine, gather=gather,
                  dtype=dt, generator=gen)
        if workload == "solve":
            kw["k"] = k
        for turn in ("warm", "off", "on", "on", "off"):
            calls.append((run_leg, (workload, name,
                                    dict(kw, record=turn == "on"))))
            labels.append((name, turn))
    t0 = time.perf_counter()
    results = run_workers(DIST_WORKERS, run_calls, calls,
                          deadline_s=DIST_DEADLINE_S, device_type="cuda")
    return labels, results, time.perf_counter() - t0


def _obs_totals_ok(comm: dict) -> bool:
    """The comm report's totals re-derive from its signatures (shape ×
    width × launches), as tools/check_comm.py re-derives them."""
    width = {"float32": 4, "float64": 8, "int64": 8, "bfloat16": 2,
             "float16": 2, "int32": 4}
    payload = messages = 0
    for sg in comm["sigs"]:
        nb = width[sg["dtype"]]
        for d in sg["shape"]:
            nb *= d
        if nb != sg["payload_bytes"]:
            return False
        payload += nb * sg["executed"]
        messages += 0 if sg["implicit"] else sg["executed"]
    return (comm["totals"]["payload_bytes"] == payload
            and comm["totals"]["messages"] == messages)


def _obs_rank_launches(leg: dict, rank: int) -> dict:
    """Rank ``rank``'s launches in a leg as that rank returned it (all the
    ranks' when recorded, its own otherwise)."""
    ls = leg["launches"]
    return ls[rank] if len(ls) > 1 else ls[0]


def _obs_full_width(torch, own_cards: bool, totals: dict, failures: list):
    """Leg 2: the full-width runs under recording (module docstring)."""
    from tpu_jordan_torch.ops.gj_probe import probe_body

    phase = "nccl4" if own_cards else "observatories"
    labels, results, world_s = _obs_world(torch, own_cards)
    for r, legs in enumerate(results):
        for leg in legs:
            for kname, c in _obs_rank_launches(leg, r).items():
                totals[kname] = totals.get(kname, 0) + c
    head = results[0]
    runs = {}
    for (name, turn), leg in zip(labels, head):
        runs.setdefault(name, {}).setdefault(turn, []).append(leg)
    for run in (OBS_NCCL_RUNS if own_cards else OBS_RUNS):
        name, workload, n, m, gen, dt, workers, engine, gather, k = run
        on, off = runs[name]["on"], runs[name]["off"]
        on_ms = [leg["elapsed_s"] * 1e3 for leg in on]
        off_ms = [leg["elapsed_s"] * 1e3 for leg in off]
        ratio_ms = (sum(on_ms) / len(on_ms)) / (sum(off_ms) / len(off_ms))
        body = probe_body(m, getattr(torch, dt))
        checks = {"reconciled": all(leg["comm"]["reconciled"] is True
                                    and not leg["comm"]["mismatches"]
                                    for leg in on),
                  "totals_rederive": all(_obs_totals_ok(leg["comm"])
                                         for leg in on + off),
                  "work_exact": all(leg["work"]["totals"]["exact"]
                                    for leg in on + off),
                  "pin_in_band": all((leg["work"]["xla"] or {}).get("within")
                                     for leg in on),
                  "probe_on_every_rank": all(
                      ls.get(body, 0) > 0 for leg in on
                      for ls in leg["launches"]),
                  "off_path_within_spread":
                      1.0 / OBS_SPREAD <= ratio_ms <= OBS_SPREAD}
        drifts = [leg["comm"]["drift"] for leg in on + off]
        if own_cards:
            checks["judged"] = all(d["judged"] for d in drifts)
            checks["event_iff_out_of_band"] = all(
                d["event_recorded"] == d["out_of_band"]
                and bool(leg["drift_events"]) == d["out_of_band"]
                for d, leg in zip(drifts, on + off))
        else:
            checks["unjudged_on_gloo"] = all(not d["judged"]
                                             and not d["event_recorded"]
                                             for d in drifts)
        c0 = on[0]["comm"]
        row = {"phase": phase, "leg": "full_width", "run": name, "n": n,
               "m": m, "dtype": dt, "engine": engine,
               "workers": workers if isinstance(workers, int)
               else list(workers), "gather": gather, "k": k,
               "backend": head[0]["comm"]["drift"]["backend"],
               "payload_bytes": c0["totals"]["payload_bytes"],
               "engine_payload_bytes": sum(
                   sg["payload_bytes"] * sg["executed"] for sg in c0["sigs"]
                   if sg["section"] == "engine"),
               "messages": c0["totals"]["messages"],
               "engine_wire_bytes": c0["totals"]["engine_wire_bytes"],
               "ms_on": on_ms, "ms_off": off_ms,
               "on_over_off": ratio_ms,
               "drift": [{key: d[key] for key in (
                   "comm_vs_projected", "achieved_gbps", "projected_comm_s",
                   "projected_compute_s", "residue_s", "judged",
                   "out_of_band", "event_recorded")} for d in drifts],
               "pin": [leg["work"]["xla"]["xla_vs_model"] for leg in on],
               "skew": on[0]["work"]["totals"]["skew"],
               "checks": checks}
        emit(row)
        if not all(checks.values()):
            failures.append(row)
    emit({"phase": phase, "leg": "full_width", "world_s": world_s,
          "note": "ms: the slowest rank's CUDA events; " + (
              "a card a rank over nccl" if own_cards else
              "4 gloo ranks share one card: not link figures")})


def _obs_demo(torch, flag: str, tool: str, tmp: str, totals: dict,
              failures: list):
    """Leg 1: ``python -m tpu_jordan_torch 48 8 <flag>`` in this process
    (one world of 4 gloo ranks sharing the card), its checker as a
    subprocess (exit 0), and the report's own checks."""
    n, m = OBS_DEMO_ROW
    t0 = time.perf_counter()
    rc, lines = _run_cli([n, m, flag])
    wall = time.perf_counter() - t0
    if rc != 0 or not lines:
        failures.append({"demo": flag, "exit": rc, "out": lines[-4:]})
        return
    rep = json.loads(lines[-1])
    path = os.path.join(tmp, f"{tool}.json")
    with open(path, "w") as f:
        f.write(lines[-1])
    try:
        verdict = check_tool(tool, path)
    except AssertionError as e:
        verdict = None
        failures.append({"demo": flag, "checker": str(e)})
    legs = rep["legs"] + ([rep["drift_leg"]] if "drift_leg" in rep else [])
    for leg in legs:
        for ls in leg["launches"]:
            for kname, c in ls.items():
                totals[kname] = totals.get(kname, 0) + c
    checks = {"exit_0": rc == 0, "checker_exit_0": verdict is not None,
              "backend_gloo": rep["backend"] == "gloo",
              "probe_on_every_rank": all(
                  len(leg["launches"]) == DIST_WORKERS
                  and all(ls.get("gj_probe", 0) > 0
                          for ls in leg["launches"]) for leg in legs)}
    if flag == "--comm-demo":
        checks["every_leg_reconciled"] = all(
            leg["comm"]["reconciled"] is True for leg in legs)
        checks["drift_event_recorded"] = (
            rep["drift_leg"]["comm"]["drift"]["event_recorded"]
            and rep["drift_events"] >= 1)
        summary = {"drift_ratio": rep["drift_leg"]["comm"]["drift"][
            "comm_vs_projected"], "drift_events": rep["drift_events"]}
    else:
        checks["pins_in_band"] = all(leg["work"]["xla"]["within"]
                                     for leg in legs)
        summary = {"pins": {leg["name"]: leg["work"]["xla"]["xla_vs_model"]
                            for leg in legs},
                   "straggler_events": rep["straggler_events"]}
    row = {"phase": "observatories", "leg": "demo", "argv": f"{n} {m} "
           f"{flag}", "exit": rc, "checker": verdict, "wall_s": wall,
           "legs": len(legs), **summary, "checks": checks}
    emit(row)
    if not all(checks.values()):
        failures.append(row)


def _obs_reports(tmp: str, failures: list):
    """Leg 3: ``--comm-report``/``--work-report`` on the CLI's OBS_CLI_ROW;
    both files load and carry that solve."""
    n, m, mesh = OBS_CLI_ROW
    cp, wp = (os.path.join(tmp, f"{k}.json") for k in ("comm", "work"))
    t0 = time.perf_counter()
    rc, lines = _run_cli([n, m, "--workers", mesh, "--comm-report", cp,
                          "--work-report", wp])
    checks = {"exit_0": rc == 0}
    try:
        with open(cp) as f:
            c = json.load(f)["last_solve"]
        with open(wp) as f:
            w = json.load(f)["last_solve"]
        checks["comm_last_solve"] = (c["n"] == n and c["mesh"] == mesh
                                     and c["totals"]["payload_bytes"] > 0)
        checks["work_last_solve"] = (w["n"] == n and w["mesh"] == mesh
                                     and w["totals"]["exact"])
    except (OSError, ValueError, KeyError, TypeError) as e:
        checks["files_load"] = False
        c = w = {"error": str(e)}
    row = {"phase": "observatories", "leg": "reports",
           "argv": f"{n} {m} --workers {mesh} --comm-report "
                   f"--work-report", "exit": rc, "out": lines[-4:],
           "comm_totals": c.get("totals"), "work_totals": w.get("totals"),
           "wall_s": time.perf_counter() - t0, "checks": checks}
    emit(row)
    if not all(checks.values()):
        failures.append(row)


def phase_observatories(torch, counters, own_cards: bool = False):
    """The communication and work observatories (the module docstring's
    phase 18): the demos, the full-width runs under recording, the
    snapshot flags; with ``own_cards`` (the nccl4 phase) the full-width
    4096²/m128 inplace runs on p = 4 and (2, 2) over nccl, judged.
    Returns the ranks' launches summed."""
    import shutil
    import tempfile

    totals = dict.fromkeys(counters, 0)
    failures = []
    legs = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_obs_")
    try:
        t0 = time.perf_counter()
        if not own_cards:
            _obs_demo(torch, "--comm-demo", "check_comm.py", tmp, totals,
                      failures)
            _obs_demo(torch, "--work-demo", "check_work.py", tmp, totals,
                      failures)
            legs["demos"] = time.perf_counter() - t0
        _obs_full_width(torch, own_cards, totals, failures)
        legs["full_width"] = time.perf_counter() - t0 - sum(legs.values())
        if not own_cards:
            _obs_reports(tmp, failures)
            legs["reports"] = time.perf_counter() - t0 - sum(legs.values())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "nccl4" if own_cards else "observatories",
          "legs_s": legs})
    if failures:
        raise AssertionError(f"observatories failed its checks: {failures}")
    return totals


# The persistent-world phase (dist_serve): mesh lanes, the distributed
# JordanSolver, the checkpoint demo, the augmented engines, the native
# reader.  Ranks share the card over gloo: not scaling figures.
DIST_SERVE_ROW = (4096, 128, 64)
DIST_SERVE_MESHES = (4, "2x2")
DIST_SOLVER_ROW = (4096, 128, "rand", "float64", 4)
DIST_CKPT_DEMO_ROW = (4096, 128)
DIST_AUG_ROWS = ((4096, 128, "absdiff", "float64", 4),
                 (4096, 128, "absdiff", "float64", (2, 2)),
                 (1000, 50, "rand", "float32", 4))
NATIVE_ROW = (4096, 128, 4)


def _ref_pivots(torch, n: int, m: int, gen: str, dt: str, Nr: int):
    """The single-device in-place engine's pivots on generator ``gen``'s
    matrix, its padded tail's self-pivots appended to ``Nr`` steps."""
    from tpu_jordan_torch.ops import block_jordan_invert_inplace, generate

    a = generate(gen, (n, n), getattr(torch, dt), device="cuda")
    _, sing, st = block_jordan_invert_inplace(a, block_size=m,
                                              collect_stats=True)
    piv = st["pivot_block"].tolist()
    del a, st
    torch.cuda.empty_cache()
    return piv + list(range(len(piv), Nr)), bool(sing)


def _dist_serve_lanes(torch, totals: dict, failures: list) -> None:
    """Leg 1: serve_demo with one mesh lane (p4, then 2x2): the 4096
    requests ride the lane (a mesh_admitted hop each), zero builds and
    zero world starts after warmup, the mesh requests' worst rel_residual
    under the solve gate (the single-device lanes' rand fp32 requests may
    spike past it, as in the serve phase), the first mesh request's pivots
    equal the single-device engine's; the lane's execute p50/p99 beside
    its world's start."""
    from tpu_jordan_torch.obs.recorder import RECORDER
    from tpu_jordan_torch.ops import gj_probe as probe_mod
    from tpu_jordan_torch.parallel.layout import CyclicLayout
    from tpu_jordan_torch.resilience import (DEFAULT_POLICY,
                                             solve_gate_threshold)
    from tpu_jordan_torch.serve import serve_demo

    n, m, requests = DIST_SERVE_ROW
    ref, _ = _ref_pivots(torch, n, m, "rand", "float32",
                         CyclicLayout.create(n, m, 4).Nr)
    body = probe_mod.probe_body(m, torch.float32)
    gate = solve_gate_threshold(DEFAULT_POLICY, n, torch.float32)
    for w in DIST_SERVE_MESHES:
        mark = RECORDER.total
        t0 = time.perf_counter()
        rep = serve_demo(n, m, requests=requests, workers=w,
                         dtype=torch.float32, generator="rand")
        wall = time.perf_counter() - t0
        label = rep["mesh"]
        hops = [e for e in RECORDER.since(mark) if e.get("kind") == "journey"
                and e.get("event") == "mesh_admitted"]
        lane = rep["mesh_world"][0]
        big = sum(1 for i in range(requests)
                  if rep["request_sizes"][i % len(rep["request_sizes"])] == n)
        row = rep["stats"]["buckets"][f"{n}@{label}"]
        for k, c in lane["launches"].items():
            totals[k] = totals.get(k, 0) + c
        checks = {
            "mesh_admitted_each": (len(hops) == big == rep["mesh_requests"]
                                   and all(e["mesh"] == label
                                           for e in hops)),
            "zero_builds_after_warmup": rep["compiles_on_request_path"] == 0,
            "zero_world_starts_after_warmup": (
                rep["world_starts_on_request_path"] == 0
                and lane["starts"] == 1),
            "mesh_worst_rel_under_gate": (
                float(rep["mesh_worst_rel_residual"]) <= gate),
            "pivots_equal_single": lane["first_request_pivots"] == ref,
            "rank_launches": (lane["launches"].get(body, 0) > 0
                              and sum(lane["launches"].values())
                              == lane["launches"].get(body, 0)),
            "not_singular": rep["singular"] == 0}
        out = {"phase": "dist_serve", "leg": "serve", "mesh": label,
               "n": n, "m": m, "requests": requests, "mesh_requests": big,
               "checks": checks, "world_start_s": lane["start_s"],
               "world_jobs": lane["jobs"], "execute_ms": row["execute_ms"],
               "queue_ms": row["queue_ms"], "elapsed_s": rep["elapsed_s"],
               "wall_s": wall, "worst_rel_residual": rep["worst_rel_residual"],
               "mesh_worst_rel_residual": rep["mesh_worst_rel_residual"],
               "gate": gate, "rank_launches": lane["launches"]}
        emit(out)
        if not all(checks.values()):
            failures.append(out)


def _dist_serve_solver(torch, totals: dict, failures: list,
                       own_cards: bool) -> None:
    """Leg 2: JordanSolver on one world: three inverts (one world start,
    the calls' walls), pivots equal the single-device engine's, the ring
    residual on the ranks under the gate; then gather=False with
    residual(a, handle) on the ranks.  On four cards (nccl) fp32, the
    gather=True leg alone."""
    from tpu_jordan_torch.models import JordanSolver
    from tpu_jordan_torch.ops import generate
    from tpu_jordan_torch.parallel.world import world_starts
    from tpu_jordan_torch.resilience import DEFAULT_POLICY, gate_threshold

    n, m, gen, dt, p = DIST_SOLVER_ROW
    if own_cards:
        dt = "float32"
    dtype = getattr(torch, dt)
    mats = [generate(gen, (n, n), dtype, row_offset=i * n,
                     col_offset=i * n, device="cuda") for i in range(3)]
    ref, _ = _ref_pivots(torch, n, m, gen, dt, n // m)
    starts = world_starts()
    walls, res = [], []
    with JordanSolver(n=n, block_size=m, workers=p, dtype=dtype) as s:
        for i, a in enumerate(mats):
            t0 = time.perf_counter()
            inv, sing = s.invert(a)
            walls.append(time.perf_counter() - t0)
            if i == 0:
                piv = s.ranks[0]["pivots"]
            for r in s.ranks:
                for k, c in r["launches"].items():
                    totals[k] = totals.get(k, 0) + c
            res.append(s.residual(a, inv) if not own_cards or i == 0
                       else None)
        one_world = s.world.starts == 1
        start_s, backend = s.world.start_s, s.ranks[0]["backend"]
    norm = float(mats[0].abs().sum(1).amax())
    kappa = norm * float(inv.abs().sum(1).amax())
    gate = gate_threshold(DEFAULT_POLICY, n, kappa, dtype)
    # The gate on ‖A·X − I‖∞ / ‖A‖∞ (SolveResult.rel_residual).
    checks = {"one_world_start": one_world and world_starts() - starts == 1,
              "pivots_equal_single": piv == ref,
              "residual_gate": all(r is None or r / norm <= gate
                                   for r in res),
              "not_singular": not bool(sing)}
    out = {"phase": "nccl4" if own_cards else "dist_serve", "leg": "solver",
           "n": n, "m": m, "dtype": dt, "ranks": p, "backend": backend,
           "world_start_s": start_s, "invert_wall_s": walls,
           "residual": res, "checks": checks}
    del inv
    if not own_cards:
        t0 = time.perf_counter()
        with JordanSolver(n=n, block_size=m, workers=p, dtype=dtype,
                          gather=False) as s:
            handle, sing = s.invert(mats[0])
            for r in s.ranks:
                for k, c in r["launches"].items():
                    totals[k] = totals.get(k, 0) + c
            r_blocks = s.residual(mats[0], handle)
            checks["no_gather_pivots"] = s.ranks[0]["pivots"] == ref
            checks["no_gather_residual_gate"] = r_blocks / norm <= gate
        out["no_gather"] = {"residual": r_blocks,
                            "wall_s": time.perf_counter() - t0}
    emit(out)
    if not all(checks.values()):
        failures.append(out)


def _dist_serve_ckpt(torch, failures: list) -> None:
    """Leg 3: ``--ckpt-demo`` at DIST_CKPT_DEMO_ROW through the CLI (fp64,
    cadence 2, p = 4), its report through tools/check_ckpt.py: every leg
    resumed and bit-matched with zero resume compiles, the fleet leg's
    replica killed mid-sweep."""
    n, m = DIST_CKPT_DEMO_ROW
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_jordan_torch", str(n), str(m),
         "--ckpt-demo", "--quiet"], cwd=ROOT, capture_output=True, text=True)
    wall = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    rep = json.loads(lines[-1]) if proc.returncode == 0 and lines else None
    checks = {"exit_0": proc.returncode == 0}
    out = {"phase": "dist_serve", "leg": "ckpt_demo", "n": n, "m": m,
           "wall_s": wall, "checks": checks}
    if rep is not None:
        try:
            out["checker"] = check_tool("check_ckpt.py", stdin=lines[-1])
            checks["checker_exit_0"] = True
        except AssertionError as e:
            checks["checker_exit_0"] = False
            out["checker"] = str(e)[-400:]
        legs = rep["legs"]
        checks["every_leg_resumed_bit_match"] = all(
            leg["resumed"] and leg["bit_match"]
            and leg["resume_compiles"] == 0 for leg in legs.values())
        kill = legs["fleet_kill"]
        checks["killed_mid_sweep"] = bool(kill["killed_replicas"]) and (
            0 < kill["resume_start_step"] < kill["Nr"])
        out.update({
            "legs": {k: {f: v.get(f) for f in (
                "preempt_step", "resume_start_step", "resumed", "bit_match",
                "resume_compiles", "kill_attempts", "killed_replicas")}
                for k, v in legs.items()},
            "kill_attempts": kill["kill_attempts"],
            "ledger": rep["ledger"], "elapsed_s": rep["elapsed_s"]})
    else:
        out["stderr"] = proc.stderr[-1500:]
    emit(out)
    if not all(checks.values()):
        failures.append(out)


def _aug_checks(ranks, lay, w, body) -> dict:
    """Each rank's probe launches its live steps (1D) or the steps of its
    non-empty slices (2D)."""
    if isinstance(w, tuple):
        steps_ok = all(r["launches"].get(body, 0) == len(r["probe_steps"])
                       for r in ranks) and sum(
            len(r["probe_steps"]) for r in ranks) >= lay.Nr
    else:
        steps_ok = all(
            r["probe_steps"] == _live_steps(lay.Nr, w, r["rank"], "inplace",
                                            None)
            and r["launches"].get(body, 0) == len(r["probe_steps"])
            for r in ranks)
    return {"probe_launches_live_steps": steps_ok}


def _dist_serve_augmented(torch, totals: dict, failures: list,
                          native_file) -> None:
    """Leg 4: the augmented engines, recorded: ``driver.solve(engine=
    "augmented")`` on p = 4 and (2, 2) at 4096²/m128 fp64, and
    ``JordanSolver(engine="augmented", workers=4)`` at 1000²/m50 fp32
    (gj_probe.cu on the ranks), whose world then streams the native
    leg's file to its 4 ranks.  Pivots equal the single-device in-place
    engine's in fp64 (fp32 ones may part at a near tie, ROADMAP.md Queue
    C: the parting step is printed), the residual under the gate, comm
    and work reconciled, each rank's launches its live steps (1D)."""
    from tpu_jordan_torch.driver import solve
    from tpu_jordan_torch.models import JordanSolver
    from tpu_jordan_torch.obs import comm as _comm
    from tpu_jordan_torch.ops import generate
    from tpu_jordan_torch.ops import gj_probe as probe_mod
    from tpu_jordan_torch.parallel.layout import CyclicLayout, CyclicLayout2D
    from tpu_jordan_torch.parallel.scatter_stream import stream_strip_rank
    from tpu_jordan_torch.resilience import DEFAULT_POLICY, gate_threshold

    for n, m, gen, dt, w in DIST_AUG_ROWS:
        dtype = getattr(torch, dt)
        lay = (CyclicLayout2D.create(n, m, *w) if isinstance(w, tuple)
               else CyclicLayout.create(n, m, w))
        ref, _ = _ref_pivots(torch, n, m, gen, dt, lay.Nr)
        body = probe_mod.probe_body(m, dtype)
        t0 = time.perf_counter()
        extra = {}
        if dt == "float64":
            with _comm.recording():
                res = solve(n, m, generator=gen, workers=w,
                            engine="augmented", dtype=dtype)
            ranks, ms, comm, work = (res.ranks, res.elapsed * 1e3, res.comm,
                                     res.work)
            rel, kappa = res.rel_residual, res.kappa
        else:
            a = generate(gen, (n, n), dtype, device="cuda")
            with JordanSolver(n=n, block_size=m, workers=w, dtype=dtype,
                              engine="augmented") as s:
                with _comm.recording():
                    inv, _ = s.invert(a)
                ranks, comm, work = s.ranks, s.comm, s.work
                ms = max(r["elapsed"] for r in ranks) * 1e3
                norm = float(a.abs().sum(1).amax())
                kappa = norm * float(inv.abs().sum(1).amax())
                rel = s.residual(a, inv) / norm
                path, nn, mm, _ = native_file
                t1 = time.perf_counter()
                extra["stream"] = s.world.run(stream_strip_rank, path, nn, mm)
                extra["stream_wall_s"] = time.perf_counter() - t1
            del a, inv
        wall = time.perf_counter() - t0
        _add_launches(totals, ranks)
        gate = gate_threshold(DEFAULT_POLICY, n, kappa, dtype)
        checks = {"pivots_equal_single": (dt != "float64"
                                          or ranks[0]["pivots"] == ref),
                  "residual_gate": rel <= gate,
                  "comm_reconciled": bool(comm.reconciled),
                  "work_pin_in_band": bool(work.xla and work.xla["within"]),
                  **_aug_checks(ranks, lay, w, body)}
        out = {"phase": "dist_serve", "leg": "augmented", "n": n, "m": m,
               "generator": gen, "dtype": dt, "workers": str(w),
               "entry": "JordanSolver" if extra else "driver.solve",
               "backend": ranks[0]["backend"], "checks": checks, "ms": ms,
               "wall_s": wall, "rel_residual": rel, "gate": gate,
               "pivots_part_at": _parting_step(ranks[0]["pivots"], ref),
               "comm_bytes": comm.total_bytes(),
               "comm_messages": comm.total_messages(), "kernel": body,
               "launches": [r["launches"].get(body, 0) for r in ranks]}
        emit(out)
        if not all(checks.values()):
            failures.append(out)
        native_file[3].update(extra)


def _dist_serve_native_file(torch, tmp: str):
    """The native leg's file: the 4096² absdiff matrix written by the
    native writer (the dist_workloads file's format, %.17g), parsed
    single-device by the native reader and by the Python tokenizer (both
    timed).  Returns [path, n, m, record]; the augmented leg streams it to
    4 ranks into the record."""
    from tpu_jordan_torch import io as tio
    from tpu_jordan_torch import native
    from tpu_jordan_torch.ops import generate

    n, m, _ = NATIVE_ROW
    path = os.path.join(tmp, f"absdiff{n}.txt")
    t0 = time.perf_counter()
    native.write_matrix_text(path, generate("absdiff", (n, n),
                                            torch.float64).numpy())
    rec = {"write_s": time.perf_counter() - t0,
           "file_bytes": os.path.getsize(path)}
    tio.reset_strip_peak()
    t0 = time.perf_counter()
    rec["full"] = tio.read_matrix_file(path, n)
    rec["native_parse_s"] = time.perf_counter() - t0
    rec["parser"] = tio.parser_in_use()
    t0 = time.perf_counter()
    py = tio._read_tokens_python(path, n).reshape(n, n)
    rec["python_parse_s"] = time.perf_counter() - t0
    rec["bit_equal_python"] = bool((rec["full"] == py).all())
    return [path, n, m, rec]


def _dist_serve_native(torch, native_file, failures: list) -> None:
    """Leg 5: the native reader's checks: the single-device parse native
    and bit-equal to the Python tokenizer's; each of the 4 ranks (the
    augmented solver's world) streamed its strip with the native reader,
    bit-equal to the single-device parse's strip."""
    import hashlib

    from tpu_jordan_torch.parallel.dist_solve import split_strips
    from tpu_jordan_torch.parallel.layout import CyclicLayout

    path, n, m, rec = native_file
    ranks = rec.get("stream", [])
    lay = CyclicLayout.create(n, m, NATIVE_ROW[2])
    want = [hashlib.sha256(x.contiguous().numpy().tobytes()).hexdigest()
            for x in split_strips(torch.from_numpy(rec["full"]), lay)]
    checks = {"parser_native": rec["parser"] == "native",
              "bit_equal_python": rec["bit_equal_python"],
              "ranks_native": bool(ranks) and all(r["parser"] == "native"
                                                  for r in ranks),
              "rank_strips_bit_equal": [r["sha256"] for r in ranks] == want,
              "strip_rows_le_m": bool(ranks) and all(
                  0 < r["strip_rows_max"] <= m for r in ranks)}
    out = {"phase": "dist_serve", "leg": "native", "n": n,
           "file_bytes": rec["file_bytes"], "write_s": rec["write_s"],
           "native_parse_s": rec["native_parse_s"],
           "python_parse_s": rec["python_parse_s"],
           "rank_stream_s": [r["seconds"] for r in ranks],
           "stream_job_wall_s": rec.get("stream_wall_s"), "checks": checks}
    emit(out)
    if not all(checks.values()):
        failures.append(out)


def phase_dist_serve(torch, counters, own_cards: bool = False):
    """The persistent world of ranks (the module docstring's phase 19):
    mesh lanes, the distributed JordanSolver, the checkpoint demo, the
    augmented engines, the native reader; with ``own_cards`` (nccl4) leg 2
    at fp32 over nccl.  Every count is set to 0 before the phase and read
    after; the ranks' own launches are added.  Returns the launches
    summed."""
    for mod in counters.values():
        mod.reset_launches()
    totals = dict.fromkeys(counters, 0)
    failures = []
    legs = {}
    t0 = time.perf_counter()
    if not own_cards:
        _dist_serve_lanes(torch, totals, failures)
        legs["serve"] = time.perf_counter() - t0
    _dist_serve_solver(torch, totals, failures, own_cards)
    legs["solver"] = time.perf_counter() - t0 - sum(legs.values())
    if not own_cards:
        import shutil
        import tempfile

        _dist_serve_ckpt(torch, failures)
        legs["ckpt_demo"] = time.perf_counter() - t0 - sum(legs.values())
        tmp = tempfile.mkdtemp(prefix="chip_smoke_native_")
        try:
            native_file = _dist_serve_native_file(torch, tmp)
            legs["native_file"] = (time.perf_counter() - t0
                                   - sum(legs.values()))
            _dist_serve_augmented(torch, totals, failures, native_file)
            legs["augmented"] = (time.perf_counter() - t0
                                 - sum(legs.values()))
            _dist_serve_native(torch, native_file, failures)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    for k in totals:
        totals[k] += counters[k].launches
    emit({"phase": "nccl4" if own_cards else "dist_serve", "legs_s": legs,
          "launches": totals})
    if failures:
        raise AssertionError(f"dist_serve failed its checks: {failures}")
    return totals


def phase_overlap(torch):
    """profile_solve's device-time split of the OVERLAP_ROWS rows: the
    probe, GEMM and other ms, the idle share and the overlap (the kernels'
    summed time less the union of their intervals).  Fails unless each
    lookahead row overlaps (> 0 ms)."""
    from tpu_jordan_torch.profile_solve import profile_row

    bad = []
    for n, m, gen, dname, engine, group in OVERLAP_ROWS:
        row = {"phase": "overlap", **profile_row(
            n, m, gen, getattr(torch, dname), engine, group=group)}
        emit(row)
        torch.cuda.empty_cache()
        if engine == "lookahead" and not row["overlap_ms"] > 0:
            bad.append(row)
    if bad:
        raise AssertionError(f"no probe overlapped a GEMM: {bad}")


def stack_metrics(torch, a, x):
    """batch_metrics of the (B, n, n) stacks a and x, METRICS_CHUNK
    elements a call, concatenated."""
    from tpu_jordan_torch.driver import batch_metrics

    parts = [batch_metrics(a[c:c + METRICS_CHUNK], x[c:c + METRICS_CHUNK])
             for c in range(0, a.shape[0], METRICS_CHUNK)]
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def batch_gate(torch, met, n: int, eps: float):
    """The solve rows' gate min(3·eps·n·κ∞/‖A‖∞, 0.5), per element."""
    return (3.0 * eps * n * met["norm_x"]).clamp(max=0.5)


def phase_solve_batch(torch, counters):
    """The batch path: every BATCH_SOLVE_ROWS row through
    driver.solve_batch, warm, with the kernels' counts set to 0 just before
    the timed run and read just after.  One probe call a superstep for the
    whole batch: gj_probe_fused_panel launches = Nr.  Every element's
    rel_residual, from batch_metrics over the regenerated stack, is held to
    the gate min(3·eps·n·κ∞/‖A‖∞, 0.5).  The reference algorithm misses
    that gate on some rand elements (the JAX package's in-place engine
    too, on the CPU: PERF.md), so an element over it must be the main
    path's result: the single in-place engine on that element must take
    the same pivots, and is printed beside it.  Returns the counts summed
    over the rows."""
    from tpu_jordan_torch.driver import solve_batch
    from tpu_jordan_torch.ops import (batched_jordan_invert,
                                      block_jordan_invert_inplace,
                                      generate_batch, inf_norm,
                                      residual_inf_norm)
    from tpu_jordan_torch.ops import gj_probe as probe_mod

    totals = dict.fromkeys(counters, 0)
    for B, n, m, gen, dname in BATCH_SOLVE_ROWS:
        dtype = getattr(torch, dname)
        eps = float(torch.finfo(dtype).eps)
        solve_batch(n, m, batch=B, generator=gen, dtype=dname,
                    device="cuda")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for mod in counters.values():
            mod.reset_launches()
        wall0 = time.perf_counter()
        res = solve_batch(n, m, batch=B, generator=gen, dtype=dname,
                          device="cuda")
        wall = time.perf_counter() - wall0
        launches = {name: mod.launches for name, mod in counters.items()}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        nr = -(-n // m)
        expected = dict.fromkeys(counters, 0)
        expected[probe_mod.probe_body(m)] = nr
        inv = res.inverse
        a = generate_batch(gen, n, B, dtype, device="cuda")
        met = stack_metrics(torch, a, inv)
        gate = batch_gate(torch, met, n, eps)
        ratio = met["rel_residual"] / gate
        over = []
        for b in (ratio >= 1).nonzero().flatten().tolist():
            steps = []
            batched_jordan_invert(a[b:b + 1], block_size=m,
                                  probe=batch_recording_probe(1, steps))
            x_s, s_s, stats = block_jordan_invert_inplace(
                a[b], block_size=m, collect_stats=True)
            over.append({
                "element": b, "rel_residual": float(met["rel_residual"][b]),
                "gate": float(gate[b]), "kappa_inf": float(met["kappa"][b]),
                "single_rel_residual": float(residual_inf_norm(a[b], x_s)
                                             / inf_norm(a[b])),
                "single_singular": bool(s_s),
                "pivots_equal": ([p[0] for p in steps]
                                 == stats["pivot_block"].tolist())})
        del a
        row = {"phase": "solve", "engine": "batched", "batch": B, "n": n,
               "m": m, "generator": gen, "dtype": dname,
               "seconds": res.elapsed, "gflops": res.gflops, "wall_s": wall,
               "peak_gb": peak_gb,
               "elements_under_gate": int((ratio < 1).sum()),
               "max_rel_residual": float(met["rel_residual"].max()),
               "max_rel_residual_over_gate": float(ratio.max()),
               "max_kappa_inf": float(met["kappa"].max()),
               "over_gate": over,
               "supersteps": nr, "launches": launches,
               "expected_launches": expected,
               "finite": bool(torch.isfinite(inv).all()),
               "shape": list(inv.shape)}
        emit(row)
        del res, inv, met
        torch.cuda.empty_cache()
        if not (launches == expected and row["finite"]
                and row["shape"] == [B, n, n]
                and all(o["pivots_equal"] and not o["single_singular"]
                        for o in over)):
            raise AssertionError(f"solve_batch failed its checks: {row}")
        totals = {name: totals[name] + launches[name] for name in totals}
    return totals


def phase_batch_fp32(torch):
    """bench.py's batched tiers in fp32 (BATCH_SOLVE_ROWS' shapes) through
    the batched engine: how many elements are flagged singular and how
    many miss the gate, with their κ∞ (solve_batch refuses a batch with a
    flagged element, so the engine is called directly)."""
    from tpu_jordan_torch.ops import batched_jordan_invert, generate_batch

    for B, n, m, gen, _ in BATCH_SOLVE_ROWS:
        a = generate_batch(gen, n, B, torch.float32, device="cuda")
        inv, singular = batched_jordan_invert(a, block_size=m)
        met = stack_metrics(torch, a, inv)
        ratio = met["rel_residual"] / batch_gate(
            torch, met, n, float(torch.finfo(torch.float32).eps))
        over = (ratio >= 1).nonzero().flatten().tolist()
        emit({"phase": "batch_fp32", "batch": B, "n": n, "m": m,
              "generator": gen, "dtype": "float32",
              "singular": singular.nonzero().flatten().tolist(),
              "singular_kappa_inf": met["kappa"][singular].tolist(),
              "over_gate": over,
              "over_gate_ratio": ratio[over].tolist(),
              "over_gate_kappa_inf": met["kappa"][over].tolist(),
              "max_kappa_inf": float(met["kappa"].max())})
        del a, inv, met
        torch.cuda.empty_cache()


def phase_knife_edge(torch):
    """absdiff 8192/m384 in fp32 through the grouped engine, once with the
    kernel and once with the plain probe on the card: which side of the
    fp32 knife edge each lands on, and the first superstep at which every
    candidate was flagged singular (-1 if none)."""
    from tpu_jordan_torch.ops import batched_block_inverse, generate
    from tpu_jordan_torch.ops import block_jordan_invert_inplace_grouped
    from tpu_jordan_torch.ops import probe_blocks

    def plain(cands, eps):
        return batched_block_inverse(cands, None, eps)

    n, m = 8192, 384
    a = generate("absdiff", (n, n), torch.float32, device="cuda")
    nc = torch.arange(-(-n // m), 0, -1)
    for name, probe in (("kernel", probe_blocks), ("plain", plain)):
        _, singular, stats = block_jordan_invert_inplace_grouped(
            a, block_size=m, group=2, collect_stats=True, probe=probe)
        flagged = (stats["singular_candidates"].cpu() == nc).nonzero()
        emit({"phase": "knife_edge", "probe": name, "n": n, "m": m,
              "generator": "absdiff", "dtype": "float32",
              "engine": "grouped", "singular": bool(singular),
              "first_all_singular_step": (int(flagged[0]) if len(flagged)
                                          else -1),
              "pivot_inv_norm": [float(v)
                                 for v in stats["pivot_inv_norm"]]})


def bits_equal(torch, x, y) -> bool:
    """Whether two float tensors hold the same bits (NaNs included)."""
    ints = {4: torch.int32, 8: torch.int64}[x.element_size()]
    return bool(torch.equal(x.view(ints), y.view(ints)))


# (m, nc, dtype): the stacks at which cluster_sweep times every schedule.
# (300, 80) fp32 and (384, 44) fp64 run in no wave of clusters that hold W
# (the card holds 66 clusters of 2 blocks, 17 of 6), so probe_schedule
# takes the fewest waves there: Nr at n = 24000 and at n = 16896.
SWEEP_CASES = ((50, 20, "float32"), (128, 32, "float32"),
               (256, 16, "float32"), (300, 20, "float32"),
               (300, 20, "float64"), (384, 22, "float32"),
               (384, 22, "float64"), (512, 8, "float32"),
               (1100, 4, "float32"), (300, 80, "float32"),
               (384, 44, "float64"))


def phase_cluster_sweep(torch):
    """gj_probe.cu on every schedule that fits each SWEEP_CASES stack (the
    block one where it fits, every cluster size 2..16 whose shared memory
    holds W, and the global one over 2, 4, 5, 8 and 16 blocks where part of
    W spills to L2) and v2 on every
    cluster size that fits each VARIANT_CASES stack: the time, the clusters
    the card holds at once, and whether the outputs' bits equal those of
    the default schedule (the per-element arithmetic is the same on every
    schedule)."""
    from tpu_jordan_torch.config import eps_for
    from tpu_jordan_torch.ops import gj_probe_panel, probe_variants
    from tpu_jordan_torch.ops import gj_probe as gp

    for m, nc, dname in SWEEP_CASES:
        dtype = getattr(torch, dname)
        eps = eps_for(dtype)
        elem = torch.finfo(dtype).bits // 8
        blocks = make_stack(torch, nc, m, dtype, seed=500 + m)
        ref = gp.launch_kernel(blocks, eps)
        default = gp.schedule_for(blocks)
        options = [("block", 1)] if m <= gp.REG_MAX_M else []
        options += [("cluster", c) for c in range(2, gp.MAX_CLUSTER + 1)
                    if gp.probe_smem_bytes(m, elem, c, -(-m // c))
                    <= gp.SMEM_LIMIT]
        if m >= 300:
            options += [("global", c) for c in (2, 4, 5, 8, 16)
                        if 0 < gp.smem_rows(m, elem, c) < -(-m // c)]
        for sched in options:
            active = gp.active_clusters(m, elem, *sched)
            row = {"phase": "cluster_sweep", "kernel": "gj_probe", "m": m,
                   "nc": nc, "dtype": dname, "schedule": list(sched),
                   "default": list(default), "active_clusters": active}
            if sched[1] > 1 and active == 0:
                emit(row)
                continue
            out = gp.launch_kernel(blocks, eps, sched)
            torch.cuda.synchronize()
            emit({**row, "bits_equal": bits_equal(torch, out[0], ref[0])
                  and bool(torch.equal(out[1], ref[1])),
                  "ms": cuda_ms(torch, lambda: gp.launch_kernel(
                      blocks, eps, sched), 20 if m <= 256 else 5)})
    for m, nc, dname in VARIANT_CASES:
        blocks = make_stack(torch, nc, m, torch.float32, seed=600 + m)
        b = probe_variants.panel_width(m)
        for c in (1, 2, 4, 8, 12, 16):
            if (probe_variants.panel_smem_bytes(m, b, c) > gp.SMEM_LIMIT
                    or m > 640 or c > m):
                continue
            sched = ("cluster", c)
            emit({"phase": "cluster_sweep", "kernel": "gj_probe_panel",
                  "m": m, "nc": nc, "dtype": dname, "schedule": list(sched),
                  "default": list(probe_variants.panel_schedule(m)),
                  "ms": cuda_ms(torch, lambda: gj_probe_panel(
                      blocks, schedule=sched), 20 if m <= 256 else 5)})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of "
                         + ",".join(PHASES + EXTRA_PHASES))
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    unknown = set(phases) - set(PHASES + EXTRA_PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, "tpu_jordan_torch")):
        print("chip_smoke: run from a checkout of the repository (no "
              "tpu_jordan_torch/ beside this script)", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    become_subreaper()
    try:
        return run_phases(torch, phases)
    finally:
        end_children()


def run_phases(torch, phases: list) -> int:
    """Every phase of ``phases``, then the result lines (module
    docstring); 0 on success, raising on any failure."""
    start = time.perf_counter()
    phase_toolchain(torch)
    seconds = {"toolchain": time.perf_counter() - start}
    rows = {name: [] for name in KERNELS}
    if "kernel_vs_plain" in phases:
        rows.update(phase_kernel_vs_plain(torch))
        rows["gj_probe"] += phase_scaled_vs_plain(torch)
        rows.update(phase_complex_vs_plain(torch))
        rows["fused_update"] = phase_update_vs_plain(torch)
        rows.update(phase_variants_vs_plain(torch))
    seconds["kernel_vs_plain"] = time.perf_counter() - start - sum(
        seconds.values())
    launches = {}
    if "reference" in phases:
        phase_reference(torch)
        phase_reference_engines(torch)
        phase_reference_lookahead(torch)
        phase_reference_workloads(torch)
        phase_reference_complex(torch)
        launches.update(phase_reference_variants(torch))
    seconds["reference"] = time.perf_counter() - start - sum(
        seconds.values())
    if "solve" in phases:
        launches.update(phase_solve(torch))
    seconds["solve"] = time.perf_counter() - start - sum(seconds.values())
    if "tune" in phases:
        for name, count in phase_tune(torch).items():
            launches[name] = launches.get(name, 0) + count
    seconds["tune"] = time.perf_counter() - start - sum(seconds.values())
    if "overlap" in phases:
        phase_overlap(torch)
    seconds["overlap"] = time.perf_counter() - start - sum(seconds.values())
    if "telemetry" in phases:
        for name, count in phase_telemetry(torch,
                                           launch_counters()).items():
            launches[name] = launches.get(name, 0) + count
    seconds["telemetry"] = time.perf_counter() - start - sum(
        seconds.values())
    if "resilience" in phases:
        for name, count in phase_resilience(torch,
                                            launch_counters()).items():
            launches[name] = launches.get(name, 0) + count
    seconds["resilience"] = time.perf_counter() - start - sum(
        seconds.values())
    if "serve" in phases:
        for name, count in phase_serve(torch, launch_counters()).items():
            launches[name] = launches.get(name, 0) + count
    seconds["serve"] = time.perf_counter() - start - sum(seconds.values())
    if "handles" in phases:
        for name, count in phase_handles(torch, launch_counters()).items():
            launches[name] = launches.get(name, 0) + count
    seconds["handles"] = time.perf_counter() - start - sum(seconds.values())
    by_phase = {}
    for name, phase in (("fleet", phase_fleet), ("lpqp", phase_lpqp),
                        ("autoscale", phase_autoscale),
                        ("update_demo", phase_update_demo),
                        ("distributed", phase_distributed),
                        ("dist_workloads", phase_dist_workloads),
                        ("dist2d", phase_dist2d),
                        ("observatories", phase_observatories),
                        ("dist_serve", phase_dist_serve)):
        if name in phases:
            by_phase[name] = phase(torch, launch_counters())
            for kernel, count in by_phase[name].items():
                launches[kernel] = launches.get(kernel, 0) + count
        seconds[name] = time.perf_counter() - start - sum(seconds.values())
    if "nccl4" in phases:
        by_phase["nccl4"] = phase_distributed(torch, launch_counters(),
                                              own_cards=True)
        for phase in (phase_dist2d, phase_observatories, phase_dist_serve):
            for kernel, count in phase(torch, launch_counters(),
                                       own_cards=True).items():
                by_phase["nccl4"][kernel] = (
                    by_phase["nccl4"].get(kernel, 0) + count)
        for kernel, count in by_phase["nccl4"].items():
            launches[kernel] = launches.get(kernel, 0) + count
        seconds["nccl4"] = time.perf_counter() - start - sum(
            seconds.values())
    if "knife_edge" in phases:
        phase_knife_edge(torch)
    if "cluster_sweep" in phases:
        phase_cluster_sweep(torch)
    if "batch_fp32" in phases:
        phase_batch_fp32(torch)

    # Each kernel's representative row: the probes at 4096/m128's first
    # superstep (gj_probe.cu at 1000/m50's), the update at 8192/m128 fp32
    # (the full width of its path).
    kernels = []
    for name, info in KERNELS.items():
        own = [r for r in rows[name] if name != "gj_probe"
               or (r["m"], r["nc"], r["dtype"]) == RANK1_CASE]
        rep = own[0] if own else {}
        shape = ([rep.get("N"), rep.get("KM"), rep.get("m")]
                 if name == "fused_update"
                 else [rep.get("nc"), rep.get("m"), rep.get("m")])
        kernels.append({
            "name": name, **info, "launches": launches.get(name),
            "max_abs_err": max((r["max_abs_err"] for r in rows[name]),
                               default=None),
            "ms": rep.get("ms"), "plain_ms": rep.get("plain_ms"),
            "bound_ms": rep.get("bound_ms"),
            "bound_by": rep.get("bound_by"),
            "library_ms": rep.get("library_ms"),
            "shape": shape, "dtype": rep.get("dtype", rep.get("mode")),
            **({"launches_by_phase": {p: c.get(name, 0)
                                      for p, c in by_phase.items()}}
               if by_phase else {})})
    emit({"phase": "cleanup", "killed": end_children()})
    emit({"phase": "wall", "seconds": seconds,
          "total_s": time.perf_counter() - start})
    print(smi(), flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
