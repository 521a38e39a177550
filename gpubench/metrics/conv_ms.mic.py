"""Device milliseconds a micrograph of the kernels that PyTorch's
convolution ops launched, from the trace of the traced requests."""


def read(ctx):
    t = ctx["trace"]
    if not t:
        return None
    s = sum(v for k, v in t["ops"].items() if "convolution" in k)
    if s <= 0:
        return None
    return 1e3 * s / ctx["traced_requests"]
