"""Command line: ``python -m tpu_jordan_torch n m [file]``.

Mirrors the reference's ``argv = n m [file]`` surface (main.cpp:66-127) and
the JAX package's exit codes: 0 ok, 1 usage, 2 runtime error (missing or
unreadable file, singular matrix, a rank-deficient lstsq, an exhausted
residual-gate ladder, no CUDA device).

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
"""

from __future__ import annotations

import argparse
import sys

from .driver import LATER_ENGINES
from .errors import DeviceUnavailableError, SingularMatrixError, UsageError
from .tuning.registry import ENGINES
from .io import MatrixReadError
from .resilience.policy import ResidualGateError

_USAGE = "usage: python -m tpu_jordan_torch n m [<file>]"


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
                    choices=list(ENGINES) + list(LATER_ENGINES),
                    help="elimination engine: 'auto' = autotuned "
                         "selection (plan cache -> registry cost "
                         "ranking -> --tune measured tuning); the names "
                         "of a later slice are refused with exit 1")
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
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="print the corners of A and of its inverse")
    return ap


def main(argv=None) -> int:
    try:
        args = _parser().parse_args(argv)
        if args.n <= 0 or args.m <= 0:
            raise ValueError("n and m must be positive")
        if args.refine < 0 or args.rhs < 1:
            raise ValueError("--refine must be non-negative, --rhs "
                             "positive")
    except SystemExit as e:
        if e.code == 0:      # --help is not a usage error
            return 0
        print(_USAGE, file=sys.stderr)
        return 1
    except ValueError:
        print(_USAGE, file=sys.stderr)
        return 1

    from .driver import solve, solve_batch

    try:
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
            return _workload(args)
        if args.batch > 1:
            if args.file is not None:
                raise UsageError("--batch requires generator input")
            if args.engine != "auto" or args.group != 0:
                raise UsageError("--batch uses the batched engine; "
                                 "--engine/--group do not apply")
            if args.tune or args.plan_cache:
                raise UsageError("--batch uses the batched engine; "
                                 "--tune/--plan-cache do not apply")
            result = solve_batch(n=args.n, block_size=args.m,
                                 batch=args.batch, generator=args.generator,
                                 dtype=args.dtype, refine=args.refine,
                                 verbose=args.verbose, device=args.device)
        else:
            result = solve(n=args.n, block_size=args.m, file=args.file,
                           generator=args.generator, dtype=args.dtype,
                           refine=args.refine, device=args.device,
                           verbose=args.verbose, engine=args.engine,
                           group=args.group, tune=args.tune,
                           plan_cache=args.plan_cache)
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
    except UsageError as e:
        print(e, file=sys.stderr)
        return 1
    if not args.verbose:
        print(f"glob_time: {result.elapsed:.2f}")
        print(f"residual: {result.residual:e}")
    _print_engine(result)
    return 0


def _print_engine(result) -> None:
    """The engine that ran, and where an auto plan chose it, the ladder
    rung that did (so --engine auto is never a black box)."""
    print(f"engine: {result.engine} on {result.device}")
    plan = getattr(result, "plan", None)
    if plan is not None:
        print(f"plan: {plan.config} (auto, {plan.source} plan)")
        if plan.variance_flag:
            print(f"plan variance_flag: {plan.variance_flag}")


def _workload(args) -> int:
    """``--workload solve`` / ``lstsq`` (the JAX CLI's flag contract)."""
    from .interop import resolve_device, resolve_dtype
    from .linalg import lstsq, solve_system
    from .ops import generate
    from .resilience import DEFAULT_POLICY, solve_gate_threshold

    if args.batch > 1:
        raise UsageError("--workload solve/lstsq and --batch are distinct "
                         "modes; pick one")
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
                              plan_cache=args.plan_cache, device=dev,
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
