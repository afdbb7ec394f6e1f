"""Seconds the process spent building and loading the program's native
libraries: the union of its ``native.build`` and ``native.load`` spans
(the hash check, nvcc or g++, the ctypes load; builds may run side by side
in threads, and a load holds its build). None where the program records
no such span."""


def read(ctx):
    try:
        from lbfgs_ffnn_torch.utils import profiling
    except ImportError:
        return None
    spans = getattr(profiling, "spans", None)
    found = spans("native.build", "native.load") if spans is not None else []
    if not found:
        return None
    total, reach = 0, None
    for lo, hi in sorted((s.start_ns, s.end_ns) for s in found):
        if reach is None or lo > reach:
            total, reach = total + hi - lo, hi
        elif hi > reach:
            total, reach = total + hi - reach, hi
    return total / 1e9
