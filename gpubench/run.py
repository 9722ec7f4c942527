#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json on the card this process sees.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device`` and, last,
``checks`` (each number compared with its limit, also the last lines of
standard error).  Exits 2 without a result where no CUDA device, too few
cards, a file the cell names, or a module that no run may load is found.
Run it from the root of a checkout; what the program builds stays in the
checkout.
"""

import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".gpubench_cache")
# Build caches of the toolchains, at fixed paths inside the checkout.
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
# The script's own folder goes off the path (its modules would shadow the
# standard library's ``trace``); the checkout's root goes on.
sys.path[0] = ROOT

from gpubench.core import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
