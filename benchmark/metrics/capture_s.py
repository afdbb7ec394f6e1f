"""Seconds the process spent capturing the resident driver's steps: its
``resident.capture`` spans (eager run, check capture and graph capture;
the window replays cached steps, so these are set-up's), less the native
builds and loads that ran inside them (a kernel's library is built at its
first call, which may come in a capture's eager run; ``native_s`` counts
that time). None where the program records no such span."""


def _union(intervals):
    merged = []
    for lo, hi in sorted(intervals):
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    return merged


def read(ctx):
    try:
        from lbfgs_ffnn_torch.utils import profiling
    except ImportError:
        return None
    spans = getattr(profiling, "spans", None)
    found = spans("resident.capture") if spans is not None else []
    if not found:
        return None
    native = _union((s.start_ns, s.end_ns) for s in spans("native.build", "native.load"))
    total = 0
    for lo, hi in _union((s.start_ns, s.end_ns) for s in found):
        total += hi - lo - sum(max(0, min(hi, b) - max(lo, a)) for a, b in native)
    return total / 1e9
