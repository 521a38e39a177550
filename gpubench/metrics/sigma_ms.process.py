"""Device milliseconds a micrograph of the sigma net (span ``spr.sigma``
of `Denoiser._noise_estimate`, a user annotation: the profiler's device
event of that name runs from the start of the first kernel launched
inside the span to the end of the last), from the trace of the traced
requests.  None where the program opens no such span."""

SPAN = "spr.sigma"


def read(ctx):
    t = ctx["trace"]
    if not t:
        return None
    s = t["kernels"].get(SPAN, 0.0)
    if s <= 0:
        return None
    return 1e3 * s / ctx["traced_requests"]
