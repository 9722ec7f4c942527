"""``setup_s`` (end to end, host clock): process start to the first timed
call: imports, the kernels' load (and build, in a checkout's first run),
the solver's construction, the seeded inputs and the warm calls."""


def read(run):
    return run.setup_s
