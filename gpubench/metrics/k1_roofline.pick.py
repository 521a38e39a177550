"""K1's share of its roofline: the least time the card could take for the
work K1 does on one micrograph's map (`k1_bound_s` of the configuration's
counts: the map read once and the picks written once at the HBM rate, or
its comparisons at the float32 rate), over K1's device time a micrograph.
A map with more picks than the pick buffer holds (`max_peaks`) is run
again with the buffer doubled; that second call counts in K1's time, and
not in its least time.  The picks counted are the table's, inside the
border frame: a few percent fewer than K1 writes, a few kB of 4 MB."""

K1_KERNELS = ("nms_prepass_kernel", "nms_greedy_kernel")


def read(ctx):
    t = ctx["trace"]
    if not t:
        return None
    s = sum(v for k, v in t["kernels"].items()
            if any(n in k for n in K1_KERNELS))
    sizes = ctx["traced_sizes"]
    if s <= 0 or not sizes:
        return None
    cell = ctx["cell"]
    radius = int(cell.config["cfg"]["NMS"])
    h, w = int(cell.traffic["height"]), int(cell.traffic["width"])
    picks = int(sum(sizes) / len(sizes))
    bound = cell.counts.k1_bound_s(h, w, picks, radius, ctx["peaks"])
    return 100.0 * bound / (s / ctx["traced_requests"])
