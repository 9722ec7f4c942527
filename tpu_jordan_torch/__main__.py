"""Command line: ``python -m tpu_jordan_torch n m [file]``.

Mirrors the reference's ``argv = n m [file]`` surface (main.cpp:66-127) and
the JAX package's exit codes: 0 ok, 1 usage, 2 runtime error (missing or
unreadable file, singular matrix, a rank-deficient lstsq, an exhausted
residual-gate ladder, no CUDA device).  ``--precision`` takes the JAX
package's choices, of which only ``highest`` runs here (the others exit
1); ``--sleep SECONDS`` prints the pid and sleeps before any device work
(the reference's ``-DSLEEP`` hook).

``--workload solve`` solves A·X = B (B = the ``rand`` window of n × K at
row offset n, ``--rhs K``; ``crand`` for a complex dtype) with no inverse
formed, ``--assume spd`` on the pivot-free path; ``--workload lstsq`` fits
an n × n//2 generated A to that B through the normal equations.  Both print
the backward error beside the solve gate
(``resilience.solve_gate_threshold`` of the default policy).

``--dtype complex64`` runs the complex path (with ``--generator crand``,
the deterministic complex uniform, which a real ``--dtype`` refuses with
exit 1): invert on the augmented engine, and both workloads.

``--engine auto`` (the default) resolves through the tuner: a plan from
``--plan-cache PATH``, else the cost ranking, else with ``--tune`` a
measurement of the cost-pruned engines at this point; the plan's source
(and a variance flag of its measurement) is printed beside the engine.

Observability: ``--numerics off|summary|trace`` (the per-solve health
record), ``--numerics-demo`` (the observatory's acceptance run, one JSON
line for ``tools/check_numerics.py``; ``--chaos-seed`` seeds it),
``--metrics-out`` (Prometheus text), ``--trace-json`` (Chrome trace of the
run's spans), ``--blackbox-out`` (the flight recorder) and
``--capacity-report`` (the capacity ledger).  The exports are written on
every exit path and never change the exit code; on exit 2 the flight
recorder is dumped to ``<tmp>/tpu_jordan_torch_blackbox.json`` unless
``--blackbox-out`` names a path.  ``--trace-json`` adds one lane per
served request (its journey).

Serving: ``--serve-demo`` streams ``--serve-requests`` mixed-size invert
requests (n, n/2, n/4) through a warmed ``serve.JordanService``
(``--batch-cap``, ``--max-wait-ms``) and prints one JSON line (exit 2 when
a request was singular); ``--chaos-demo`` serves one seeded stream twice,
fault-free and under a ``FaultPlan`` (``--chaos-seed``), and prints one
JSON line for ``tools/check_chaos.py`` (exit 2 on silent corruption).
``--capacity-demo`` runs one warmed service under a resident-handle byte
budget (n the handle size, m the block size, ``--chaos-seed`` the fixtures)
and prints one JSON line for ``tools/check_capacity.py`` (exit 2 on
unmetered residency or a silent eviction).
``--fleet-demo`` serves one seeded stream through a 1-replica and a
``--replicas``-replica ``fleet.JordanFleet``, then again under ``--kills``
seeded ``replica_kill`` faults, and prints one JSON line for
``tools/check_fleet.py`` (exit 2 on silent loss; ``--scaling-floor`` the
fleet/single throughput floor, ``--slo-report`` embeds the burn-rate SLO
evaluation for ``tools/check_slo.py``).  ``--lp-demo`` runs the LP/QP
drivers (``lpqp.lp_demo``) through a replica fleet and prints one JSON line
for ``tools/check_lp.py`` (exit 2 on silent divergence; ``--dtype
float64`` required, ``--batch-cap`` sizes the batched update leg).
``--autoscale-demo`` drives a burst → idle → recovery trace through a
floor-sized fleet under ``fleet.FleetAutoscaler`` (``--replicas`` the
ceiling) and prints one JSON line for ``tools/check_autoscale.py`` (exit 2
on a silent p99 breach); ``--update-demo`` streams ``--updates``
rank-``--rank`` updates of a resident inverse through a service and a
fleet under ``--kills`` seeded kills and prints one JSON line for
``tools/check_update.py`` (exit 2 on a silently stale inverse).

Distributed: ``--workers p`` runs the 1D row-block-cyclic engines
(``engine`` inplace, lookahead, grouped with ``--group``, swapfree, or
auto) on p ranks of ``torch.distributed``, spawned here, one card each
where there are enough (``parallel/launch.py``); ``--no-gather`` leaves
the inverse in the ranks' cyclic blocks and prints its corner.  With a
``file`` each rank streams its own strips from it; ``--tune`` measures the
distributed engines, each in one world of ranks; ``--workload solve
--workers p [--no-gather]`` solves on the ranks (``--workload lstsq`` stays
single-device, exit 1).  ``--distributed`` joins a world launched outside
(``torchrun``: ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``)
as one of its ranks instead of spawning (the invert path).  ``--workers
PRxPC`` runs the same engines on a (pr, pc) mesh of the 2D block-cyclic
layout (pr·pc ranks; each holds an (N/pr)×(N/pc) shard), with a file,
``--no-gather``, ``--tune`` and ``--workload solve`` alike; ``--engine
augmented`` runs the pre-shard_map reference-parity engines there.
``--serve-demo --workers W|PRxPC`` serves the largest size through a mesh
lane on a persistent world of ranks.  ``--ckpt-demo`` runs the
preemption-safety demo's four legs over one checkpoint store (``--ckpt-dir
PATH`` keeps it) and prints one JSON line for ``tools/check_ckpt.py``
(exit 2 on silent checkpoint loss).  ``--comm-demo`` and
``--work-demo`` run the communication and work observatories' acceptance
legs in one world of 4 ranks and print one JSON line each for
``tools/check_comm.py`` and ``tools/check_work.py`` (exit 2 on an
unaccounted collective, a silent drift, unaccounted work or an unsupported
straggler verdict); ``--comm-report PATH`` and ``--work-report PATH``
write this process's snapshot of the last distributed solve on exit.
``--quiet`` drops the bulky parts of the demos' reports (the per-lane
stats, the fault log, the per-handle rows); elsewhere it is the default,
non-verbose output.  The serving flags apply to the serve, chaos and
fleet demos (``--batch-cap`` also to the LP demo).
"""

from __future__ import annotations

import argparse
import os
import sys

from .errors import DeviceUnavailableError, SingularMatrixError, UsageError
from .parallel.group import MeshSizeError
from .parallel.launch import WorkerError
from .tuning.registry import ENGINES
from .io import MatrixReadError
from .resilience.policy import ResidualGateError
from .serve.batcher import ServiceClosedError, ServiceOverloadedError

_USAGE = "usage: python -m tpu_jordan_torch n m [<file>]"

#: The demo modes: each runs single-device services of its own.
_DEMOS = ("autoscale_demo", "update_demo", "capacity_demo", "lp_demo",
          "fleet_demo", "numerics_demo", "chaos_demo", "serve_demo")


def _workers_arg(s: str):
    """'8' -> 8 ranks of the 1D layout; '2x4' -> a (2, 4) mesh of the 2D
    layout (the JAX CLI's vocabulary)."""
    if "x" in s:
        pr, pc = s.split("x", 1)
        return (int(pr), int(pc))
    return int(s)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m tpu_jordan_torch",
        usage="python -m tpu_jordan_torch n m [file]",
        description="Block Gauss-Jordan matrix inversion on one NVIDIA GPU.")
    ap.add_argument("n", type=int, help="matrix dimension")
    ap.add_argument("m", type=int, help="pivot block size")
    ap.add_argument("file", nargs="?", default=None, help="matrix file")
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "float64", "bfloat16", "float16",
                             "complex64"],
                    help="storage dtype (complex64: the augmented invert "
                         "engine and --workload solve/lstsq)")
    ap.add_argument("--precision", default="highest",
                    choices=["highest", "high", "default", "mixed"],
                    help="matmul precision of the elimination; the JAX "
                         "package's choices, of which only 'highest' (true "
                         "fp32 or fp64 products) exists here: the others "
                         "exit 1")
    ap.add_argument("--generator", default="absdiff",
                    choices=["absdiff", "hilbert", "rand", "kms", "crand"],
                    help="matrix generator when no file is given (crand = "
                         "deterministic complex uniform, complex dtypes "
                         "only)")
    ap.add_argument("--workload", default="invert",
                    choices=["invert", "solve", "lstsq"],
                    help="invert = A^-1; solve = X = A^-1 B by Gauss-Jordan "
                         "on [A | B], no inverse formed; lstsq = argmin "
                         "||Ax - b|| via the normal equations (A is "
                         "n x n//2)")
    ap.add_argument("--rhs", type=int, default=1, metavar="K",
                    help="--workload solve/lstsq: right-hand-side columns")
    ap.add_argument("--assume", default="general",
                    choices=["general", "spd"],
                    help="--workload solve: 'spd' promises a symmetric "
                         "positive definite A and skips the pivot probe "
                         "(pair with --generator kms)")
    ap.add_argument("--refine", type=int, default=0,
                    help="Newton-Schulz refinement steps")
    ap.add_argument("--engine", default="auto",
                    choices=list(ENGINES),
                    help="elimination engine: 'auto' = autotuned "
                         "selection (plan cache -> registry cost "
                         "ranking -> --tune measured tuning); 'swapfree' "
                         "= the implicit-permutation distributed engine "
                         "(--workers p only)")
    ap.add_argument("--group", type=int, default=0,
                    help="delayed-group size for the grouped engines "
                         "(default 2)")
    ap.add_argument("--tune", action="store_true",
                    help="--engine auto only: measure the registry's "
                         "cost-pruned engine candidates at this "
                         "(n, dtype, mesh, gather) point with the robust "
                         "core (median-of-k, IQR outlier rejection) and "
                         "run the fastest; combine with --plan-cache to "
                         "persist the plan")
    ap.add_argument("--plan-cache", default=None, metavar="PATH",
                    help="--engine auto only: versioned JSON plan cache "
                         "consulted before any cost ranking or "
                         "measurement (a warm hit performs zero "
                         "measurements) and updated after selection; "
                         "corrupt/version-stale files fall back to "
                         "cost-model ranking")
    ap.add_argument("--batch", type=int, default=1,
                    help="invert a batch of B generated matrices through "
                         "the batched engine (generator input only; "
                         "element b at index offset b*n)")
    ap.add_argument("--numerics", default="off",
                    choices=["off", "summary", "trace"],
                    help="per-solve numerical health record: 'summary' "
                         "reports rel_residual/kappa from what the solve "
                         "already returns; 'trace' adds the full "
                         "per-superstep record (chosen pivot block, its "
                         "inverse inf-norm — the paper's selection "
                         "criterion — candidate spread, element-growth "
                         "watermark) from the instrumented unrolled "
                         "engines (--workload solve traces the [A | B] "
                         "elimination the same way; the SPD fast path "
                         "has no probe to trace and refuses typed).  Both "
                         "mirror into the tpu_jordan_torch_pivot_"
                         "condition/growth_factor/residual histograms and "
                         "spike the flight recorder before any recovery "
                         "rung; 'off' (default) costs nothing")
    ap.add_argument("--numerics-demo", action="store_true",
                    help="run the numerics-observatory acceptance demo "
                         "(obs/numerics.numerics_demo): one seeded "
                         "ill-conditioned bf16 solve, traced — the "
                         "residual gate fails, refine diverges, the fp32 "
                         "re-solve recovers — and print ONE JSON line "
                         "proving every degradation rung was causally "
                         "preceded by a numerics_spike event in the "
                         "flight recorder (exit 2 on an unexplained rung; "
                         "tools/check_numerics.py validates the report).  "
                         "n is the fixture size, m the block size; "
                         "--chaos-seed seeds the fixture")
    ap.add_argument("--serve-demo", action="store_true",
                    help="run the dynamic-batching service demo "
                         "(tpu_jordan_torch.serve.JordanService): mixed "
                         "request sizes n, n/2, n/4 across >= 3 shape "
                         "buckets, micro-batched through the bucketed "
                         "executor cache, then print ONE JSON line of "
                         "per-bucket stats (occupancy, latency "
                         "percentiles, build and plan-cache measurement "
                         "counters); n is the largest request size, m the "
                         "block size; generator input only")
    ap.add_argument("--chaos-demo", action="store_true",
                    help="serve the SAME deterministic mixed request "
                         "stream twice, fault-free and under a seeded "
                         "FaultPlan (build failures, transient execute "
                         "errors, NaN result corruption, plan-cache write "
                         "failures), and print ONE JSON line proving every "
                         "response bit-matched the fault-free replay or "
                         "carried a typed error, with every injected fault "
                         "accounted for (exit 2 on silent corruption; "
                         "tools/check_chaos.py validates the report)")
    ap.add_argument("--capacity-demo", action="store_true",
                    help="run the capacity acceptance demo "
                         "(obs/capacity.capacity_demo): a warmed service "
                         "under a resident-handle byte budget — lane bytes "
                         "projected before any build, resident creates "
                         "fill the budget, the next create evicts the "
                         "least-recently-served handle (journey hop and "
                         "capacity_eviction event), an all-pinned "
                         "admission is the typed CapacityExceededError at "
                         "submit, and the ledger reconciles bytes_created "
                         "== bytes_live + bytes_evicted per class; prints "
                         "ONE JSON line (exit 2 = unmetered residency or a "
                         "silent eviction; tools/check_capacity.py "
                         "validates).  n is the handle size, m the block "
                         "size; --chaos-seed seeds the fixtures")
    ap.add_argument("--fleet-demo", action="store_true",
                    help="run the supervised replica-pool demo "
                         "(tpu_jordan_torch.fleet.fleet_demo): "
                         "single-replica vs --replicas-replica throughput "
                         "on one deterministic mixed stream, then the SAME "
                         "stream under --kills seeded replica_kill faults "
                         "(the supervisor warm-replaces each victim from "
                         "the shared executor store and read-only plan "
                         "cache: zero builds, zero measurements; the "
                         "router re-queues its queued work); prints ONE "
                         "JSON line proving every response bit-matched "
                         "the fault-free replay or carried a typed error "
                         "(exit 2 on silent loss; tools/check_fleet.py "
                         "validates)")
    ap.add_argument("--lp-demo", action="store_true",
                    help="run the LP/QP driver demo "
                         "(tpu_jordan_torch.lpqp.lp_demo): four seeded "
                         "driver runs (LP well/ill by revised simplex, QP "
                         "well/ill by primal active set) streaming "
                         "resident-invert + rank-k update + verification "
                         "solve traffic through a warmed replica fleet, a "
                         "zero-drift-budget probe, a seeded replica_kill "
                         "run that must bit-match its fault-free replay, "
                         "and the batched update lane at --batch-cap "
                         "distinct handles; prints ONE JSON line (exit 2 "
                         "on silent divergence; tools/check_lp.py "
                         "validates).  n is the LP/QP dimension, m the "
                         "block size; requires --dtype float64")
    ap.add_argument("--autoscale-demo", action="store_true",
                    help="run the SLO-driven autoscaler demo "
                         "(tpu_jordan_torch.fleet.autoscale_demo): a seeded "
                         "burst -> idle -> recovery trace through a "
                         "1-replica fleet whose FleetAutoscaler scales up "
                         "on burn (to --replicas), pre-sheds typed before "
                         "a breach and drains to the floor when idle; "
                         "prints ONE JSON line carrying every decision "
                         "with its burn evidence (exit 2 on a silent p99 "
                         "breach; tools/check_autoscale.py validates)")
    ap.add_argument("--update-demo", action="store_true",
                    help="run the resident-inverse update demo "
                         "(tpu_jordan_torch.serve.update_demo): a warmed "
                         "service streams --updates rank---rank updates of "
                         "one resident inverse (one rank-destroying, one "
                         "through a zero drift budget), times the warm "
                         "update against a warm re-invert, then replays "
                         "the stream through a --replicas fleet under "
                         "--kills seeded replica kills; prints ONE JSON "
                         "line (exit 2 on a silently stale inverse; "
                         "tools/check_update.py validates)")
    ap.add_argument("--rank", type=int, default=32, metavar="K",
                    help="--update-demo: the rank k of each update "
                         "(default 32; k <= n/8)")
    ap.add_argument("--updates", type=int, default=8, metavar="M",
                    help="--update-demo: updates in the stream (default "
                         "8; >= 3)")
    ap.add_argument("--replicas", type=int, default=3, metavar="N",
                    help="--fleet-demo/--lp-demo: replica slots in the "
                         "pool (default 3; >= 2)")
    ap.add_argument("--kills", type=int, default=2, metavar="K",
                    help="--fleet-demo/--lp-demo: seeded replica_kill "
                         "injections (default 2)")
    ap.add_argument("--scaling-floor", type=float, default=None,
                    metavar="X",
                    help="--fleet-demo: the minimum fleet/single "
                         "throughput ratio the checker enforces (default "
                         "0.6: replicas share one device)")
    ap.add_argument("--slo-report", action="store_true",
                    help="--fleet-demo: embed a multi-window burn-rate SLO "
                         "evaluation (availability per bucket and "
                         "fleet-wide, demo-scaled window pairs) in the "
                         "report, validated by tools/check_slo.py")
    ap.add_argument("--workers", type=_workers_arg, default=1,
                    help="ranks of the 1D row-block-cyclic layout (the "
                         "reference's mpirun -np): p processes of "
                         "torch.distributed, one card each where there are "
                         "enough; PRxPC: a (pr, pc) mesh of the 2D "
                         "block-cyclic layout, pr*pc processes")
    ap.add_argument("--gather", default=True,
                    action=argparse.BooleanOptionalAction,
                    help="--no-gather keeps the inverse as the ranks' "
                         "cyclic blocks (distributed runs): the verbose "
                         "print shows its corner from the owning blocks")
    ap.add_argument("--distributed", action="store_true",
                    help="join a torch.distributed world launched outside "
                         "(torchrun: RANK, WORLD_SIZE, MASTER_ADDR, "
                         "MASTER_PORT) as one of its ranks instead of "
                         "spawning --workers ranks (the analog of "
                         "MPI_Init, main.cpp:69); rank 0 prints")
    ap.add_argument("--chaos-seed", type=int, default=0, metavar="S",
                    help="--numerics-demo/--capacity-demo: the fixtures' "
                         "seed; --chaos-demo/--fleet-demo/--lp-demo: the "
                         "FaultPlan and request-stream seed (default 0; "
                         "same seed = the same run)")
    ap.add_argument("--serve-requests", type=int, default=64, metavar="R",
                    help="--serve-demo/--chaos-demo/--fleet-demo: requests "
                         "to submit (default 64)")
    ap.add_argument("--batch-cap", type=int, default=8, metavar="B",
                    help="--serve-demo/--chaos-demo/--fleet-demo: max "
                         "requests fused into one lane run; --lp-demo: the "
                         "batched update leg's handles (default 8)")
    ap.add_argument("--max-wait-ms", type=float, default=2.0, metavar="MS",
                    help="--serve-demo/--chaos-demo/--fleet-demo: how long "
                         "the oldest request waits for batch-mates "
                         "(default 2.0)")
    ap.add_argument("--comm-demo", action="store_true",
                    help="run the communication-observatory acceptance "
                         "demo (obs/comm.comm_demo): nine distributed "
                         "solves in one world of 4 ranks (1D p=4 and 2x2, "
                         "both gather modes, grouped/swapfree/lookahead "
                         "and the solve engines, a ragged n) whose "
                         "observed collectives must equal the analytical "
                         "inventory per rank and for the world, then a "
                         "forced drift leg; prints ONE JSON line (exit 2 = "
                         "an unaccounted collective or a silent drift; "
                         "tools/check_comm.py validates).  n, m: the "
                         "fixture size and block size")
    ap.add_argument("--work-demo", action="store_true",
                    help="run the work-observatory acceptance demo "
                         "(obs/work.work_demo): 1D and 2D invert and solve "
                         "legs in one world of 4 ranks, whose per-worker "
                         "shares must sum exactly to the convention total "
                         "and whose counted GEMM FLOPs must sit in the "
                         "band around the executed model, then the "
                         "fleet-skew legs; prints ONE JSON line (exit 2 = "
                         "unaccounted work or an unsupported straggler "
                         "verdict; tools/check_work.py validates)")
    ap.add_argument("--ckpt-demo", action="store_true",
                    help="run the preemption-safety acceptance demo "
                         "(resilience/ckpt_demo.ckpt_demo): four legs over "
                         "one checkpoint store — a single-device invert "
                         "and a 1D solve on 4 ranks each preempted "
                         "mid-sweep by the seeded preempt fault and "
                         "resumed from the last durable superstep, a "
                         "resumable LP stream replayed to its identical "
                         "kkt fingerprint trail, and a fleet leg whose "
                         "serving replica is KILLED mid-sweep (the router "
                         "re-queues with a ckpt_resume hop) — every resume "
                         "must bit-match the uninterrupted run with zero "
                         "segment compiles and the store ledger must add "
                         "up; prints ONE JSON line (exit 2 = silent loss; "
                         "tools/check_ckpt.py validates).  n is the "
                         "problem size, m the block size; --chaos-seed "
                         "seeds fixtures and the preempt schedule")
    ap.add_argument("--ckpt-dir", default=None, metavar="PATH",
                    help="--ckpt-demo: directory for the checkpoint store "
                         "(default: a temp dir deleted after); pass a path "
                         "to inspect the checkpoint files and ledger.json "
                         "afterwards")
    ap.add_argument("--comm-report", default=None, metavar="PATH",
                    help="write the process-wide communication snapshot "
                         "(the last distributed solve's collective "
                         "inventory, reconciliation and drift record, and "
                         "the tpu_jordan_torch_comm_* counters) as one "
                         "JSON document on exit")
    ap.add_argument("--work-report", default=None, metavar="PATH",
                    help="write the process-wide work snapshot (the last "
                         "distributed solve's per-worker FLOP shares, "
                         "skew, ragged penalty and counted pin, and the "
                         "tpu_jordan_torch_work_* gauges) as one JSON "
                         "document on exit")
    ap.add_argument("--quiet", action="store_true",
                    help="--serve-demo/--chaos-demo: drop the per-lane "
                         "stats and the fault log from the report")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the process-wide tpu_jordan_torch_* "
                         "metrics registry (solves, plan-cache hits/"
                         "misses, retries, numerics histograms, capacity "
                         "gauges) as Prometheus text format on exit")
    ap.add_argument("--trace-json", default=None, metavar="PATH",
                    help="record the run's span tree (solve: select/load/"
                         "execute/residual, the engine's measured steps "
                         "and hot-loop phases under execute, and the "
                         "ladder's recover rungs) and write it as Chrome "
                         "trace-event JSON — open in Perfetto "
                         "(ui.perfetto.dev) or chrome://tracing")
    ap.add_argument("--blackbox-out", default=None, metavar="PATH",
                    help="dump the always-on flight recorder (the "
                         "bounded ring of structured events: recovery "
                         "rungs, numerics spikes, retries, injected "
                         "faults, plan-cache write failures) as one JSON "
                         "document on exit; without this flag the dump "
                         "still happens automatically on any exit-2 path")
    ap.add_argument("--capacity-report", default=None, metavar="PATH",
                    help="write the process-wide capacity snapshot "
                         "(tpu_jordan_torch_capacity_*: plan cache, "
                         "flight-recorder ring, device live-bytes "
                         "watermark — with high-water marks and the "
                         "per-class created == live + evicted "
                         "reconciliation) as one JSON document on exit")
    ap.add_argument("--sleep", type=int, default=0, metavar="SECONDS",
                    help="print the pid, then sleep before any device work: "
                         "a window to attach a debugger (the reference's "
                         "-DSLEEP startup hook, main.cpp:8,70-72)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="print the corners of A and of its inverse")
    return ap


def _write_telemetry(metrics_out, trace_json, telemetry) -> None:
    """``--metrics-out``/``--trace-json``, on every exit path; a write
    failure warns on stderr and never masks the run's exit code."""
    try:
        if metrics_out:
            from .obs.export import write_metrics

            write_metrics(metrics_out)
        if trace_json and telemetry is not None:
            from .obs.export import write_chrome_trace
            from .obs.recorder import RECORDER

            # The journey slice rides the span trace: one lane per served
            # request, from the flight recorder.
            write_chrome_trace(
                trace_json, telemetry,
                journey_events=RECORDER.events(kind="journey"))
    except OSError as e:
        print(f"warning: telemetry export failed: {e}", file=sys.stderr)


def _write_capacity(path) -> None:
    """``--capacity-report``, on every exit path, with the same
    discipline."""
    if not path:
        return
    try:
        from .obs.capacity import write_report

        write_report(path)
    except OSError as e:
        print(f"warning: capacity report failed: {e}", file=sys.stderr)


def _write_observatory(path, module: str) -> None:
    """``--comm-report``/``--work-report`` (``module`` "comm" or "work"),
    on every exit path, with the same discipline."""
    if not path:
        return
    try:
        import importlib

        importlib.import_module(f"tpu_jordan_torch.obs.{module}"
                                ).write_report(path)
    except OSError as e:
        print(f"warning: {module} report failed: {e}", file=sys.stderr)


def _write_blackbox(path) -> None:
    """Dump the flight recorder (``--blackbox-out``, and on every exit
    2), with the same discipline."""
    try:
        from .obs.recorder import RECORDER

        RECORDER.write(path)
        print(f"flight recorder dumped to {path} "
              f"({RECORDER.total} events recorded)", file=sys.stderr)
    except OSError as e:
        print(f"warning: blackbox dump failed: {e}", file=sys.stderr)


def main(argv=None) -> int:
    """Run the command line; on the way out dump the flight recorder when
    ``--blackbox-out`` asked for it or the run ends in exit 2."""
    state: dict = {"blackbox_out": None}
    rc = _main(argv, state)
    if state["blackbox_out"] or rc == 2:
        import tempfile

        _write_blackbox(state["blackbox_out"]
                        or os.path.join(tempfile.gettempdir(),
                                        "tpu_jordan_torch_blackbox.json"))
    return rc


def _main(argv, state) -> int:
    try:
        args = _parser().parse_args(argv)
        if args.n <= 0 or args.m <= 0:
            raise ValueError("n and m must be positive")
        if args.refine < 0 or args.rhs < 1:
            raise ValueError("--refine must be non-negative, --rhs "
                             "positive")
        if args.serve_requests < 1 or args.batch_cap < 1:
            raise ValueError("--serve-requests/--batch-cap must be >= 1")
        if args.max_wait_ms < 0:
            raise ValueError("--max-wait-ms must be non-negative")
        w = args.workers
        if (w <= 0 if isinstance(w, int) else w[0] <= 0 or w[1] <= 0):
            raise ValueError("workers must be positive")
        if args.rank < 1 or args.updates < 3:
            raise ValueError("--rank must be >= 1 and --updates >= 3")
    except SystemExit as e:
        if e.code == 0:      # --help is not a usage error
            return 0
        print(_USAGE, file=sys.stderr)
        return 1
    except ValueError:
        print(_USAGE, file=sys.stderr)
        return 1

    state["blackbox_out"] = args.blackbox_out
    if args.sleep > 0:
        # The reference's -DSLEEP hook (main.cpp:8,70-72).
        import time

        print(f"pid {os.getpid()} sleeping {args.sleep}s", flush=True)
        time.sleep(args.sleep)
    from .driver import solve, solve_batch
    from .ops.refine import resolve_precision

    if args.distributed:
        # Joins the world before any device work (MPI_Init being argv's
        # first consumer, main.cpp:69).
        from .parallel.group import distributed_init

        try:
            distributed_init(args.device)
        except MeshSizeError as e:
            print(e, file=sys.stderr)
            return 2

    telemetry = None
    if args.metrics_out or args.trace_json:
        # One span collector for the whole run.
        from .obs.spans import Telemetry

        telemetry = Telemetry()
    try:
        resolve_precision(args.precision, args.refine)
        if args.quiet and args.verbose:
            raise UsageError("--quiet and --verbose contradict each other")
        if args.ckpt_dir is not None and not args.ckpt_demo:
            raise UsageError("--ckpt-dir applies to --ckpt-demo (the "
                             "preemption-safety acceptance run's "
                             "checkpoint store location)")
        if args.ckpt_demo:
            return _ckpt_demo(args)
        if args.comm_demo or args.work_demo:
            return _observatory_demo(args)
        demo = next((f"--{name.replace('_', '-')}" for name in _DEMOS
                     if getattr(args, name)), None)
        if args.serve_demo and (args.file is not None or not args.gather
                                or args.distributed):
            raise UsageError(
                "--serve-demo requires generator input (gathered "
                "output); --workers W serves the LARGEST size through a "
                "W-device mesh lane")
        if (demo is not None and not args.serve_demo
                and (args.workers != 1 or not args.gather
                     or args.distributed)):
            raise UsageError(
                f"{demo} runs on a single device (gathered output, "
                f"deterministic seeded fixtures); --workers, --no-gather "
                f"and --distributed do not apply")
        if not args.update_demo and (args.rank != 32 or args.updates != 8):
            raise UsageError("--rank/--updates apply to --update-demo (the "
                             "resident-inverse update run)")
        if args.autoscale_demo:
            return _autoscale_demo(args, telemetry)
        if args.update_demo:
            return _update_demo(args, telemetry)
        if args.capacity_demo:
            return _capacity_demo(args)
        if args.lp_demo:
            return _lp_demo(args, telemetry)
        if args.fleet_demo:
            return _fleet_demo(args, telemetry)
        if args.slo_report:
            raise UsageError("--slo-report is a --fleet-demo leg (the "
                             "burn-rate monitor evaluates the fleet's "
                             "request-outcome series)")
        if args.numerics_demo:
            if args.serve_demo or args.chaos_demo:
                raise UsageError("--numerics-demo, --chaos-demo and "
                                 "--serve-demo are distinct modes; pick "
                                 "one")
            return _numerics_demo(args)
        if args.chaos_demo:
            return _chaos_demo(args, telemetry)
        if args.serve_demo:
            return _serve_demo(args, telemetry)
        if (args.serve_requests != 64 or args.batch_cap != 8
                or args.max_wait_ms != 2.0):
            raise UsageError("--serve-requests/--batch-cap/--max-wait-ms "
                             "apply to --serve-demo/--chaos-demo")
        if args.workload == "invert" and args.assume != "general":
            raise UsageError("--assume applies to --workload solve "
                             "(the pivot-free SPD fast path)")
        if args.workload == "invert" and args.rhs != 1:
            raise UsageError("--rhs applies to --workload solve/lstsq")
        if args.generator == "crand" and not args.dtype.startswith(
                "complex"):
            raise UsageError("--generator crand is complex-valued; a real "
                             "--dtype would silently discard the imaginary "
                             "part (use --dtype complex64)")
        if args.workload != "invert":
            return _workload(args, telemetry)
        if args.batch > 1:
            if args.file is not None or args.workers != 1 or not args.gather:
                raise UsageError("--batch requires generator input on a "
                                 "single device (gathered output)")
            if args.engine != "auto" or args.group != 0:
                raise UsageError("--batch uses the batched engine; "
                                 "--engine/--group do not apply")
            if args.tune or args.plan_cache:
                raise UsageError("--batch uses the batched engine; "
                                 "--tune/--plan-cache do not apply")
            if args.numerics != "off":
                raise UsageError("--numerics applies to single solves "
                                 "(the batched engine is one fused "
                                 "vmapped executable — no per-superstep "
                                 "host visibility)")
            result = solve_batch(n=args.n, block_size=args.m,
                                 batch=args.batch, generator=args.generator,
                                 dtype=args.dtype, refine=args.refine,
                                 precision=args.precision,
                                 verbose=args.verbose, device=args.device,
                                 telemetry=telemetry)
        else:
            result = solve(n=args.n, block_size=args.m, file=args.file,
                           generator=args.generator, dtype=args.dtype,
                           refine=args.refine, precision=args.precision,
                           device=args.device, workers=args.workers,
                           gather=args.gather,
                           verbose=args.verbose, engine=args.engine,
                           group=args.group, tune=args.tune,
                           plan_cache=args.plan_cache, telemetry=telemetry,
                           numerics=args.numerics)
    except FileNotFoundError:
        print(f"cannot open {args.file}")
        return 2
    except MatrixReadError:
        print(f"cannot read {args.file}")
        return 2
    except SingularMatrixError:
        print("singular matrix")
        return 2
    except ResidualGateError as e:
        print(e, file=sys.stderr)
        return 2
    except DeviceUnavailableError as e:
        print(e, file=sys.stderr)
        return 2
    except (MeshSizeError, WorkerError) as e:
        # A world that cannot launch or a rank that failed: the analog of
        # mpirun failing, a runtime error.
        print(e, file=sys.stderr)
        return 2
    except (ServiceOverloadedError, ServiceClosedError) as e:
        # Serving runtime failures are runtime errors, not usage.
        print(e, file=sys.stderr)
        return 2
    except UsageError as e:
        print(e, file=sys.stderr)
        return 1
    finally:
        _write_telemetry(args.metrics_out, args.trace_json, telemetry)
        _write_capacity(args.capacity_report)
        _write_observatory(args.comm_report, "comm")
        _write_observatory(args.work_report, "work")
    if result.rank != 0:
        return 0      # a --distributed rank other than 0 prints nothing
    if not args.verbose:
        print(f"glob_time: {result.elapsed:.2f}")
        print(f"residual: {result.residual:e}")
    _print_engine(result)
    return 0


def _print_numerics(result) -> None:
    """One line of the numerics record, when one was asked for."""
    rep = getattr(result, "numerics", None)
    if rep is None:
        return
    steps = (f", {len(rep.pivot_block)} supersteps traced"
             if rep.pivot_block is not None else "")
    print(f"numerics: {rep.mode}{steps}, {len(rep.spikes)} spikes")


def _ckpt_demo(args) -> int:
    """``--ckpt-demo``: one JSON line; exit 2 on silent checkpoint loss.
    The JAX CLI's flag contract."""
    import json

    if (any(getattr(args, name) for name in _DEMOS) or args.comm_demo
            or args.work_demo):
        raise UsageError("--ckpt-demo, --lp-demo, --work-demo, "
                         "--comm-demo, --capacity-demo, --update-demo, "
                         "--fleet-demo, --chaos-demo, --serve-demo and "
                         "--numerics-demo are distinct modes; pick one")
    if (args.file is not None or args.workers != 1 or not args.gather
            or args.distributed):
        raise UsageError(
            "--ckpt-demo builds its own world of 4 ranks and fleet; file "
            "input, --workers and --no-gather do not apply")
    if args.batch > 1 or args.tune or args.group != 0:
        raise UsageError("--ckpt-demo takes no --batch/--tune/--group")
    if args.engine != "auto" or args.refine:
        raise UsageError("--ckpt-demo runs a fixed engine-leg set (fori "
                         "single-device and 1D sharded); --engine/--refine "
                         "do not apply")
    if args.workload != "invert":
        raise UsageError("--ckpt-demo checkpoints both workloads on its "
                         "own legs; --workload does not apply")
    if args.numerics != "off":
        raise UsageError("--ckpt-demo's bit-match semantics are pinned; "
                         "--numerics does not apply")
    if args.slo_report or args.plan_cache is not None:
        raise UsageError("--slo-report/--plan-cache do not apply to "
                         "--ckpt-demo")
    if (args.serve_requests != 64 or args.batch_cap != 8
            or args.max_wait_ms != 2.0):
        raise UsageError("--ckpt-demo runs checkpointed sweeps, not the "
                         "batched service; --serve-requests/--batch-cap/"
                         "--max-wait-ms do not apply")
    if (args.replicas != 3 or args.kills != 2
            or args.scaling_floor is not None):
        raise UsageError("--replicas/--kills/--scaling-floor are "
                         "--fleet-demo/--update-demo flags; --ckpt-demo's "
                         "kill leg is fixed at one kill on a 2-replica "
                         "fleet")
    if args.dtype.startswith("complex"):
        raise UsageError("--ckpt-demo checkpoints the DISTRIBUTED engines "
                         "and complex dtypes run single-device; use a real "
                         "dtype")
    from .resilience.ckpt_demo import ckpt_demo

    report = ckpt_demo(n=args.n, block_size=args.m, seed=args.chaos_seed,
                       ckpt_dir=args.ckpt_dir, device=args.device)
    if args.quiet:
        report["blackbox"]["events"] = [
            e for e in report["blackbox"]["events"]
            if str(e.get("kind", "")).startswith(
                ("ckpt_", "fault_", "replica_"))]
    print(json.dumps(report))
    if report["silent_loss"]:
        print(f"silent checkpoint loss: legs="
              f"{ {k: v['bit_match'] for k, v in report['legs'].items()} }, "
              f"ledger={report['ledger']}", file=sys.stderr)
        return 2
    return 0


def _observatory_demo(args) -> int:
    """``--comm-demo``/``--work-demo``: one JSON line; exit 2 on a silent
    accounting violation.  The JAX CLI's flag contract."""
    import json

    flag = "--comm-demo" if args.comm_demo else "--work-demo"
    if (args.comm_demo and args.work_demo) or any(
            getattr(args, name) for name in _DEMOS):
        raise UsageError("--comm-demo, --work-demo, --capacity-demo, "
                         "--update-demo, --fleet-demo, --chaos-demo, "
                         "--serve-demo and --numerics-demo are distinct "
                         "modes; pick one")
    if args.file is not None or args.workers != 1 or not args.gather:
        raise UsageError(
            f"{flag} builds its own world of 4 ranks (1D p=4 and a 2x2 "
            f"mesh); file input, --workers and --no-gather do not apply")
    if args.batch > 1 or args.tune or args.group != 0:
        raise UsageError(f"{flag} takes no --batch/--tune/--group")
    if args.engine != "auto" or args.refine:
        raise UsageError(f"{flag} runs a fixed engine-leg set (both "
                         f"layouts); --engine/--refine do not apply")
    if args.comm_demo and args.workload != "invert":
        raise UsageError("--comm-demo reconciles the distributed invert "
                         "and solve engines on its own legs; --workload "
                         "does not apply")
    if args.work_demo and (args.workload != "invert" or args.rhs != 1):
        raise UsageError("--work-demo accounts both workloads on its own "
                         "legs; --workload/--rhs do not apply")
    if args.numerics != "off":
        raise UsageError(f"{flag}'s reconciliation semantics are pinned; "
                         f"--numerics does not apply")
    if args.slo_report or args.plan_cache is not None:
        raise UsageError(f"--slo-report/--plan-cache do not apply to "
                         f"{flag}")
    if (args.serve_requests != 64 or args.batch_cap != 8
            or args.max_wait_ms != 2.0):
        raise UsageError(f"{flag} runs driver solves, not the service; "
                         f"--serve-requests/--batch-cap/--max-wait-ms do "
                         f"not apply")
    if (args.replicas != 3 or args.kills != 2
            or args.scaling_floor is not None):
        raise UsageError(f"--replicas/--kills/--scaling-floor are "
                         f"--fleet-demo/--update-demo flags; {flag} runs "
                         f"one world")
    # --dtype and --generator are honored (the inventories' bytes scale
    # with the dtype; complex is a typed refusal inside the demo).
    if args.comm_demo:
        from .obs.comm import comm_demo as demo

        silent_key = "silent_comm"
    else:
        from .obs.work import work_demo as demo

        silent_key = "silent_work"
    report = demo(n=args.n, block_size=args.m, seed=args.chaos_seed,
                  dtype=args.dtype, generator=args.generator,
                  device=args.device)
    print(json.dumps(report))
    if report[silent_key]:
        if args.comm_demo:
            print(f"silent communication accounting violation: "
                  f"unreconciled={report['unreconciled']}, "
                  f"mismatches={len(report['mismatches'])}, "
                  f"drift_events={report['drift_events']}",
                  file=sys.stderr)
        else:
            print(f"silent work accounting violation: "
                  f"unaccounted={report['unaccounted']}, "
                  f"xla_unreconciled={report['xla_unreconciled']}, "
                  f"verdict_wrong={report['verdict_wrong']}",
                  file=sys.stderr)
        return 2
    return 0


def _numerics_demo(args) -> int:
    """``--numerics-demo``: one JSON line; exit 2 on an unexplained rung."""
    import json

    from .obs.numerics import numerics_demo

    if args.file is not None:
        raise UsageError("--numerics-demo runs on a single device "
                         "(gathered output, seeded built-in "
                         "ill-conditioned fixture)")
    if args.batch > 1 or args.tune or args.group != 0:
        raise UsageError("--numerics-demo takes no --batch/--tune/--group")
    report = numerics_demo(n=args.n, block_size=args.m, seed=args.chaos_seed,
                           workload=args.workload, device=args.device)
    print(json.dumps(report))
    if report["silent_rung"]:
        print(f"unexplained degradation rung(s): "
              f"{report['unexplained_rungs']} — no causally preceding "
              f"numerics_spike", file=sys.stderr)
        return 2
    return 0


def _capacity_demo(args) -> int:
    """``--capacity-demo``: one JSON line; exit 2 on unmetered residency or
    a silent eviction.  The JAX CLI's flag contract."""
    import json

    if (args.serve_demo or args.chaos_demo or args.numerics_demo
            or args.fleet_demo or args.lp_demo):
        raise UsageError("--capacity-demo, --fleet-demo, --lp-demo, "
                         "--chaos-demo, --serve-demo and --numerics-demo "
                         "are distinct modes; pick one")
    if args.file is not None:
        raise UsageError("--capacity-demo runs on a single device "
                         "(gathered output, deterministic seeded fixtures)")
    if args.batch > 1 or args.tune or args.group != 0:
        raise UsageError("--capacity-demo takes no --batch/--tune/--group")
    if args.workload != "invert":
        raise UsageError("--capacity-demo streams resident-invert + update "
                         "requests; --workload does not apply")
    if args.numerics != "off":
        raise UsageError("--capacity-demo's ledger semantics are pinned; "
                         "--numerics does not apply")
    if args.slo_report:
        raise UsageError("--slo-report is a --fleet-demo leg (the burn-rate "
                         "monitor evaluates the fleet's request-outcome "
                         "series)")
    if args.plan_cache is not None:
        raise UsageError("--capacity-demo resolves its lanes through the "
                         "cost-only ladder; --plan-cache does not apply")
    if (args.serve_requests != 64 or args.batch_cap != 8
            or args.max_wait_ms != 2.0):
        raise UsageError("--capacity-demo streams its own fixed "
                         "resident-invert/update mix (cap-1 lanes); "
                         "--serve-requests/--batch-cap/--max-wait-ms do not "
                         "apply")
    if (args.replicas != 3 or args.kills != 2
            or args.scaling_floor is not None):
        raise UsageError("--replicas/--kills/--scaling-floor are "
                         "--fleet-demo/--lp-demo flags; --capacity-demo runs "
                         "one service under a handle budget")
    from .obs.capacity import capacity_demo

    report = capacity_demo(n=args.n, block_size=args.m, seed=args.chaos_seed,
                           dtype=args.dtype, device=args.device)
    if args.quiet:
        # The checker needs the ledger and the black-box slice; the
        # per-handle rows are operator color.
        report.pop("handles", None)
    print(json.dumps(report))
    if report["silent_capacity"]:
        print(f"silent capacity violation: unmetered="
              f"{report['unmetered_components']}, budget_evictions="
              f"{report['budget_evictions']} vs {len(report['evictions'])} "
              f"recorded events", file=sys.stderr)
        return 2
    return 0


def _autoscale_demo(args, telemetry) -> int:
    """``--autoscale-demo``: one JSON line; exit 2 on a silent p99 breach.
    The JAX CLI's flag contract."""
    import json

    from .fleet.autoscaler import autoscale_demo

    if (args.serve_demo or args.chaos_demo or args.fleet_demo
            or args.numerics_demo or args.update_demo or args.capacity_demo
            or args.lp_demo):
        raise UsageError("--autoscale-demo is a distinct mode; pick one "
                         "demo")
    if args.file is not None:
        raise UsageError("--autoscale-demo runs single-device replicas "
                         "against its own seeded burst trace; file input "
                         "does not apply")
    if args.batch > 1 or args.tune or args.group != 0:
        raise UsageError("--autoscale-demo takes no --batch/--tune/--group")
    if args.engine != "auto" or args.refine:
        raise UsageError("--autoscale-demo resolves engines through the "
                         "cost-only ladder; --engine/--refine do not apply")
    if args.workload != "invert" or args.rhs != 1:
        raise UsageError("--autoscale-demo streams invert requests; "
                         "--workload/--rhs do not apply")
    if args.numerics != "off":
        raise UsageError("--autoscale-demo's burn-evidence semantics are "
                         "pinned; --numerics does not apply")
    if args.slo_report or args.plan_cache is not None:
        raise UsageError("--slo-report/--plan-cache do not apply to "
                         "--autoscale-demo (it builds its own demo-scaled "
                         "monitor)")
    if args.replicas < 2:
        raise UsageError("--autoscale-demo needs --replicas >= 2 (the "
                         "scale-up ceiling; the floor is 1)")
    if args.kills != 2 or args.scaling_floor is not None:
        raise UsageError("--kills/--scaling-floor are --fleet-demo flags; "
                         "the autoscaler demo injects no faults")
    report = autoscale_demo(
        n=args.n, requests=args.serve_requests, floor=1,
        ceiling=args.replicas, batch_cap=args.batch_cap,
        max_wait_ms=args.max_wait_ms, seed=args.chaos_seed,
        block_size=args.m, dtype=args.dtype, telemetry=telemetry,
        device=args.device)
    if args.quiet:
        report.pop("slo_final", None)
    print(json.dumps(report))
    if report["silent_p99_breach"]:
        print("silent p99 breach: a tick saw risk signals with pre-shed "
              "off and no capacity action", file=sys.stderr)
        return 2
    return 0


def _update_demo(args, telemetry) -> int:
    """``--update-demo``: one JSON line; exit 2 on a silently stale
    inverse.  The JAX CLI's flag contract."""
    import json

    from .serve.update_demo import update_demo

    if (args.serve_demo or args.chaos_demo or args.fleet_demo
            or args.numerics_demo):
        raise UsageError("--update-demo, --fleet-demo, --chaos-demo, "
                         "--serve-demo and --numerics-demo are distinct "
                         "modes; pick one")
    if args.file is not None:
        raise UsageError("--update-demo runs on a single device (gathered "
                         "output, deterministic seeded fixtures)")
    if args.batch > 1 or args.tune:
        raise UsageError("--update-demo takes no --batch/--tune")
    if args.group != 0 or args.engine == "swapfree":
        raise UsageError("--update-demo engines are single-device (auto "
                         "resolution); --group does not apply")
    if args.workload != "invert":
        raise UsageError("--update-demo streams resident-invert + update "
                         "requests; --workload does not apply")
    if args.numerics != "off":
        raise UsageError("--update-demo's replay-compare semantics are "
                         "pinned; --numerics does not apply")
    if args.slo_report:
        raise UsageError("--slo-report is a --fleet-demo leg (the burn-rate "
                         "monitor evaluates the fleet's request-outcome "
                         "series)")
    if (args.serve_requests != 64 or args.batch_cap != 8
            or args.max_wait_ms != 2.0):
        raise UsageError("--update-demo streams --updates sequential "
                         "mutations (cap-1 lanes); --serve-requests/"
                         "--batch-cap/--max-wait-ms do not apply")
    if args.plan_cache is not None or args.scaling_floor is not None:
        raise UsageError("--update-demo resolves its lanes through the "
                         "cost-only ladder and measures update-vs-reinvert "
                         "latency directly; --plan-cache/--scaling-floor do "
                         "not apply")
    if args.replicas < 2:
        raise UsageError("--update-demo needs --replicas >= 2")
    if args.kills < 1:
        raise UsageError("--update-demo needs --kills >= 1")
    if args.rank > args.n // 8:
        raise UsageError("--update-demo needs --rank <= n/8 (the documented "
                         "regime where the update's FLOPs beat the fresh "
                         "invert's)")
    report = update_demo(
        n=args.n, block_size=args.m, rank=args.rank, updates=args.updates,
        replicas=args.replicas, kills=args.kills, seed=args.chaos_seed,
        dtype=args.dtype, telemetry=telemetry, device=args.device)
    if args.quiet:
        report["chaos"]["faults"].pop("log", None)
    print(json.dumps(report))
    if report["silent_stale"]:
        print(f"silently stale resident inverse: "
              f"{len(report['mismatches'])} mismatches, gate_passes="
              f"{report['verification']['gate_passes']}", file=sys.stderr)
        return 2
    return 0


def _fleet_demo(args, telemetry) -> int:
    """``--fleet-demo``: one JSON line; exit 2 on silent loss.  The JAX
    CLI's flag contract."""
    import json

    from .fleet import fleet_demo

    if args.serve_demo or args.chaos_demo or args.numerics_demo:
        raise UsageError("--fleet-demo, --chaos-demo, --serve-demo and "
                         "--numerics-demo are distinct modes; pick one")
    if args.numerics != "off":
        raise UsageError("--fleet-demo's replay-compare semantics are "
                         "pinned; --numerics does not apply (use "
                         "--serve-demo --numerics summary, or solve with "
                         "--numerics)")
    if args.workload != "invert":
        raise UsageError("--fleet-demo streams invert requests; --workload "
                         "does not apply")
    if args.file is not None:
        raise UsageError("--fleet-demo runs on a single device (gathered "
                         "output, deterministic built-in fixtures)")
    if args.batch > 1 or args.tune:
        raise UsageError("--fleet-demo takes no --batch/--tune")
    if args.group != 0 or args.engine == "swapfree":
        raise UsageError("--fleet-demo engines are single-device (auto "
                         "resolution); --group does not apply")
    if args.replicas < 2:
        raise UsageError("--fleet-demo needs --replicas >= 2")
    if args.kills < 1:
        raise UsageError("--fleet-demo needs --kills >= 1")
    report = fleet_demo(
        n=args.n, replicas=args.replicas, requests=args.serve_requests,
        batch_cap=args.batch_cap, max_wait_ms=args.max_wait_ms,
        kills=args.kills, seed=args.chaos_seed, block_size=args.m,
        dtype=args.dtype, plan_cache=args.plan_cache,
        scaling_floor=args.scaling_floor, telemetry=telemetry,
        slo_report=args.slo_report, device=args.device)
    if args.quiet:
        report["chaos"]["faults"].pop("log", None)
    print(json.dumps(report))
    if report["silent_loss"]:
        print(f"silent loss under replica_kill chaos: "
              f"{len(report['mismatches'])} mismatches, ledger "
              f"{report['ledger']}", file=sys.stderr)
        return 2
    return 0


def _lp_demo(args, telemetry) -> int:
    """``--lp-demo``: one JSON line; exit 2 on silent divergence.  The JAX
    CLI's flag contract."""
    import json

    from .lpqp.demo import lp_demo

    if (args.serve_demo or args.chaos_demo or args.fleet_demo
            or args.numerics_demo):
        raise UsageError("--lp-demo, --capacity-demo, --fleet-demo, "
                         "--chaos-demo, --serve-demo and --numerics-demo "
                         "are distinct modes; pick one")
    if args.file is not None:
        raise UsageError("--lp-demo runs on a single device against its "
                         "own seeded LP/QP instances; file input, "
                         "--workers and --no-gather do not apply")
    if args.batch > 1 or args.tune or args.group != 0:
        raise UsageError("--lp-demo takes no --batch/--tune/--group")
    if args.engine != "auto" or args.refine:
        raise UsageError("--lp-demo resolves its lanes through the "
                         "cost-only ladder; --engine/--refine do not apply")
    if args.workload != "invert" or args.rhs != 1:
        raise UsageError("--lp-demo streams its own resident-invert + "
                         "update + solve mix; --workload/--rhs do not apply")
    if args.numerics != "off":
        raise UsageError("--lp-demo's convergence re-derivation semantics "
                         "are pinned; --numerics does not apply")
    if args.slo_report or args.plan_cache is not None:
        raise UsageError("--slo-report/--plan-cache do not apply to "
                         "--lp-demo")
    if args.serve_requests != 64 or args.max_wait_ms != 2.0:
        raise UsageError("--lp-demo issues the drivers' own sequential "
                         "request stream; --serve-requests/--max-wait-ms do "
                         "not apply (--batch-cap IS honored: it sizes the "
                         "batched update lane)")
    if args.scaling_floor is not None:
        raise UsageError("--scaling-floor is a --fleet-demo flag (the "
                         "throughput-ratio floor); --lp-demo measures "
                         "batched-lane amortization instead")
    if args.replicas < 2:
        raise UsageError("--lp-demo needs --replicas >= 2")
    if args.kills < 1:
        raise UsageError("--lp-demo needs --kills >= 1")
    if args.batch_cap < 2:
        raise UsageError("--lp-demo's batched update lanes measure "
                         "amortization at occupancy > 1; --batch-cap must "
                         "be >= 2")
    if args.dtype != "float64":
        raise UsageError("--lp-demo iterates Bland pricing / active-set "
                         "multipliers on the resident inverse; float32 "
                         "reduced-cost noise makes the termination tests "
                         "ill-posed — pass --dtype float64")
    report = lp_demo(n=args.n, block_size=args.m, seed=args.chaos_seed,
                     replicas=args.replicas, kills=args.kills,
                     batch_cap=args.batch_cap, dtype=args.dtype,
                     telemetry=telemetry, device=args.device)
    if args.quiet:
        report["chaos"]["faults"].pop("log", None)
    print(json.dumps(report))
    if report["silent_divergence"]:
        print(f"silent divergence: errors={report['errors']}, "
              f"mismatches={len(report['mismatches'])}", file=sys.stderr)
        return 2
    return 0


def _chaos_demo(args, telemetry) -> int:
    """``--chaos-demo``: one JSON line; exit 2 on silent corruption."""
    import json

    from .serve import chaos_demo

    if args.serve_demo:
        raise UsageError("--chaos-demo and --serve-demo are distinct "
                         "modes; pick one")
    if args.file is not None:
        raise UsageError("--chaos-demo runs on a single device (gathered "
                         "output, deterministic built-in fixtures)")
    if args.batch > 1 or args.tune:
        raise UsageError("--chaos-demo takes no --batch/--tune")
    if args.numerics != "off":
        raise UsageError("--chaos-demo's replay-compare semantics are "
                         "pinned; --numerics does not apply (use "
                         "--serve-demo --numerics summary, or solve with "
                         "--numerics)")
    if args.group != 0 or args.engine != "auto":
        raise UsageError("--chaos-demo engines are single-device (auto "
                         "resolution); --engine/--group do not apply")
    if args.workload != "invert":
        raise UsageError("--chaos-demo streams invert requests; "
                         "--workload does not apply")
    report = chaos_demo(n=args.n, block_size=args.m,
                        requests=args.serve_requests,
                        batch_cap=args.batch_cap,
                        max_wait_ms=args.max_wait_ms, seed=args.chaos_seed,
                        dtype=args.dtype, plan_cache=args.plan_cache,
                        telemetry=telemetry, device=args.device)
    if args.quiet:
        report["faults"].pop("log", None)
    print(json.dumps(report))
    if report["silent_corruption"]:
        print(f"silent corruption under chaos: "
              f"{len(report['mismatches'])} mismatches, "
              f"{report['accounting']['unaccounted']} unaccounted faults",
              file=sys.stderr)
        return 2
    return 0


def _serve_demo(args, telemetry) -> int:
    """``--serve-demo``: one JSON line; exit 2 when a request was
    singular."""
    import json

    from .serve import serve_demo

    if args.file is not None:
        raise UsageError("--serve-demo requires generator input")
    if args.batch > 1:
        raise UsageError("--serve-demo and --batch are distinct modes; "
                         "pick one")
    if args.tune:
        raise UsageError("--serve-demo resolves engines through the "
                         "cost-only ladder (optionally a --plan-cache); "
                         "--tune does not apply")
    if args.group != 0 or args.engine == "swapfree":
        raise UsageError("--serve-demo engines are single-device "
                         "(auto/inplace/grouped/augmented); --group does "
                         "not apply")
    if args.workload != "invert":
        raise UsageError("--serve-demo streams invert requests; submit(a, "
                         "b) is the solve serve surface")
    report = serve_demo(n=args.n, block_size=args.m,
                        requests=args.serve_requests,
                        batch_cap=args.batch_cap,
                        max_wait_ms=args.max_wait_ms, engine=args.engine,
                        plan_cache=args.plan_cache, dtype=args.dtype,
                        generator=args.generator, telemetry=telemetry,
                        numerics=args.numerics, device=args.device,
                        workers=args.workers)
    if args.quiet:
        report.pop("stats", None)
    print(json.dumps(report))
    if report["singular"]:
        print(f"singular matrix ({report['singular']} requests flagged)",
              file=sys.stderr)
        return 2
    return 0


def _print_engine(result) -> None:
    """The engine that ran, and where an auto plan chose it, the ladder
    rung that did (so --engine auto is never a black box)."""
    _print_numerics(result)
    print(f"engine: {result.engine} on {result.device}")
    plan = getattr(result, "plan", None)
    if plan is not None:
        print(f"plan: {plan.config} (auto, {plan.source} plan)")
        if plan.variance_flag:
            print(f"plan variance_flag: {plan.variance_flag}")


def _workload(args, telemetry=None) -> int:
    """``--workload solve`` / ``lstsq`` (the JAX CLI's flag contract)."""
    from .interop import resolve_device, resolve_dtype
    from .linalg import lstsq, solve_system
    from .ops import generate
    from .resilience import DEFAULT_POLICY, solve_gate_threshold

    if args.batch > 1:
        raise UsageError("--workload solve/lstsq and --batch are distinct "
                         "modes; pick one")
    if args.workload == "lstsq" and (args.workers != 1 or not args.gather):
        raise UsageError("--workload lstsq runs on a single device "
                         "(gathered output); --workload solve is the "
                         "distributed one")
    if args.engine != "auto" or args.group != 0:
        raise UsageError("--workload solve/lstsq resolve their engine "
                         "through the workload-scoped auto ladder "
                         "(optionally --tune/--plan-cache); --engine/"
                         "--group name invert engines and do not apply")
    if args.refine:
        raise UsageError("--refine is Newton-Schulz on an INVERSE; the "
                         "solve workloads gate on ||AX - B|| and recover "
                         "via their own ladder (attach a policy)")
    dtype = resolve_dtype(args.dtype)
    dev = resolve_device(args.device)
    bmat = generate("crand" if dtype.is_complex else "rand",
                    (args.n, args.rhs), dtype, row_offset=args.n, device=dev)
    if args.workload == "solve":
        if args.file is not None:
            from .interop import from_numpy
            from .io import read_matrix_file

            amat = from_numpy(read_matrix_file(args.file, args.n), dev,
                              dtype)
        else:
            amat = generate(args.generator, (args.n, args.n), dtype,
                            device=dev)
        result = solve_system(amat, bmat, block_size=args.m,
                              assume=args.assume, tune=args.tune,
                              workers=args.workers, gather=args.gather,
                              plan_cache=args.plan_cache, device=dev,
                              telemetry=telemetry, numerics=args.numerics,
                              verbose=args.verbose)
        lsq = None
    else:
        if args.file is not None:
            raise UsageError("--workload lstsq is generator-input only "
                             "(the matrix file format is square)")
        if args.assume != "general":
            raise UsageError("--assume applies to --workload solve "
                             "(lstsq's normal equations are SPD by "
                             "construction)")
        amat = generate(args.generator, (args.n, max(1, args.n // 2)),
                        dtype, device=dev)
        lsq = lstsq(amat, bmat, block_size=args.m, tune=args.tune,
                    plan_cache=args.plan_cache, device=dev,
                    telemetry=telemetry, numerics=args.numerics,
                    verbose=args.verbose)
        if lsq.rank_deficient:
            print("rank deficient (singular normal equations)",
                  file=sys.stderr)
            return 2
        result = lsq.inner
    if not args.verbose:
        print(f"glob_time: {result.elapsed:.2f}")
        print(f"residual: {result.residual:e}")
    gate = solve_gate_threshold(DEFAULT_POLICY, result.n, dtype)
    print(f"rel_residual: {result.rel_residual:e} (solve gate {gate:e})")
    if lsq is not None:
        print(f"lstsq residual: {lsq.residual:e}")
    _print_engine(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
