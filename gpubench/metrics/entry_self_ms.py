"""``entry_self_ms`` (layer: entry): host ms a call inside the program's
``tj::invert``/``tj::invert_batch`` profiler ranges and outside their
``tj::execute`` child (input conversion, fault points, the policy call,
the final cast), summed over the traced stretch and divided by its
calls: the program's own split of ``entry_host_ms``.  None where the
program opens no such range."""

ENTRIES = ("tj::invert", "tj::invert_batch")


def read(run):
    p = run.profile
    if p is None or not p.calls:
        return None
    entries = [(a, b) for name, a, b in p.host if name in ENTRIES]
    if not entries:
        return None
    execs = [(a, b) for name, a, b in p.host if name == "tj::execute"]
    self_us = 0.0
    for a, b in entries:
        self_us += (b - a) - sum(min(b, d) - max(a, c) for c, d in execs
                                 if c < b and d > a)
    return self_us / 1e3 / p.calls
