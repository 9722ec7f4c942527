"""``gflops`` (end to end, host clock): the useful work of every call
completed in the window (2n³ a matrix, × batch) over the window's
seconds, first call's start to last call's end."""


def read(run):
    w = run.window
    if not w.calls or w.window_s <= 0:
        return None
    return w.calls * run.work_per_call / w.window_s / 1e9
