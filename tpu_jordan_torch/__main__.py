"""Command line: ``python -m tpu_jordan_torch n m [file]``.

Mirrors the reference's ``argv = n m [file]`` surface (main.cpp:66-127) and
the JAX package's exit codes: 0 ok, 1 usage, 2 runtime error (missing or
unreadable file, singular matrix, an exhausted residual-gate ladder, no
CUDA device).
"""

from __future__ import annotations

import argparse
import sys

from .errors import DeviceUnavailableError, SingularMatrixError, UsageError
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
                    choices=["float32", "float64", "bfloat16", "float16"])
    ap.add_argument("--generator", default="absdiff",
                    choices=["absdiff", "hilbert", "rand", "kms"],
                    help="matrix generator when no file is given")
    ap.add_argument("--refine", type=int, default=0,
                    help="Newton-Schulz refinement steps")
    ap.add_argument("--engine", default="auto",
                    help="auto | inplace | grouped | augmented | "
                         "grouped_pallas | grouped_pallas_bf16")
    ap.add_argument("--group", type=int, default=0,
                    help="delayed-group size for the grouped engines "
                         "(default 2)")
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
        if args.refine < 0:
            raise ValueError("--refine must be non-negative")
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
        if args.batch > 1:
            if args.file is not None:
                raise UsageError("--batch requires generator input")
            if args.engine != "auto" or args.group != 0:
                raise UsageError("--batch uses the batched engine; "
                                 "--engine/--group do not apply")
            result = solve_batch(n=args.n, block_size=args.m,
                                 batch=args.batch, generator=args.generator,
                                 dtype=args.dtype, refine=args.refine,
                                 verbose=args.verbose, device=args.device)
        else:
            result = solve(n=args.n, block_size=args.m, file=args.file,
                           generator=args.generator, dtype=args.dtype,
                           refine=args.refine, device=args.device,
                           verbose=args.verbose, engine=args.engine,
                           group=args.group)
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
    print(f"engine: {result.engine} on {result.device}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
