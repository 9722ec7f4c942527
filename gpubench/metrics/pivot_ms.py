"""``pivot_ms`` (layer: probe): device ms a call of the program's own
``pivot`` spans (candidate copy, probe, selection; a probe-ahead's on its
side stream), summed over the entry spans (``invert``/``invert_batch``)
of the traced stretch's calls in the program's process-wide span sink
(``tpu_jordan_torch.obs.spans.PROFILED``), each from its CUDA event
pair.  None where the program keeps no such sink or span."""

import sys

PHASE = "pivot"


def read(run):
    p = run.profile
    spans = sys.modules.get("tpu_jordan_torch.obs.spans")
    sink = getattr(spans, "PROFILED", None)
    if p is None or not p.calls or sink is None:
        return None
    roots = [r for r in sink.roots
             if r.name in ("invert", "invert_batch")][-p.calls:]
    seconds = [sp.device_seconds for r in roots for sp in r.walk()
               if sp.name == PHASE]
    seconds = [s for s in seconds if s is not None]
    if not seconds:
        return None
    return sum(seconds) * 1e3 / len(roots)
