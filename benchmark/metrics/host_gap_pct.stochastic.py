"""The traced solve's device idle time that the program measured itself,
% of its ``solve`` span: the sum of the gaps its recorded trace found
(intervals in which the card had finished the last replay and waited for
the host), each put down to a host span. None where the solve's result
carries no trace with device times."""


def read(ctx):
    result = None if ctx.trace is None else ctx.trace.get("result")
    trace = getattr(result, "trace", None)
    span = getattr(trace, "span", None)
    if span is None or not getattr(trace, "device", None):
        return None
    gaps = sum(g.end_ns - g.start_ns for g in trace.gaps)
    return 100.0 * gaps / (span.end_ns - span.start_ns)
