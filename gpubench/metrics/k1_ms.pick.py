"""Device milliseconds a micrograph of K1 (`csrc/nms.cu`: its pre-pass
and greedy-chain kernels, the cap retry's call included), from the trace
of the traced requests."""

K1_KERNELS = ("nms_prepass_kernel", "nms_greedy_kernel")


def read(ctx):
    t = ctx["trace"]
    if not t:
        return None
    s = sum(v for k, v in t["kernels"].items()
            if any(n in k for n in K1_KERNELS))
    if s <= 0:
        return None
    return 1e3 * s / ctx["traced_requests"]
