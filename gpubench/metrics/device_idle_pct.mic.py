"""The device's idle share over the traced requests: wall time less the
union of its operations' intervals, as a share of wall time."""


def read(ctx):
    t = ctx["trace"]
    if not t or t["window_s"] <= 0 or t["device_ops"] == 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
