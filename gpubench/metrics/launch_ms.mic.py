"""Host milliseconds a micrograph of `Picker._forward` (span
``spr.forward``: pad, stack, the copy to the device and the enqueue of
the dense forward, which the device runs on after it), the median over
the run's requests."""

import statistics


def run_spans(ctx):
    """The spans of this run: those from the newest ``spr.open`` on (each
    run opens one `Picker`).  None off the card (there the forward runs
    inside ``spr.forward`` and ``spr.fetch`` waits for nothing), or where
    the program records no spans."""
    t = ctx["trace"]
    if not t or not t["device_ops"]:
        return None
    from spr_pick_tpu_torch.utils import profiling

    spans = getattr(profiling, "spans", None)
    if spans is None:
        return None
    recs = spans()
    opens = [r.start_ns for r in recs if r.name == "spr.open"]
    if not opens:
        return None
    return [r for r in recs if r.start_ns >= max(opens)]


def per_micrograph(recs, name, value):
    """The median over the run's requests (root ``spr.request`` spans) of
    ``value`` summed over a request's ``name`` spans, over its
    micrographs; None where no request has such a span."""
    mics = {r.span_id: r.attrs.get("micrographs", 0) for r in recs
            if r.name == "spr.request" and r.parent is None}
    total = {}
    for r in recs:
        if r.name == name and mics.get(r.request):
            total[r.request] = total.get(r.request, 0) + value(r)
    if not total:
        return None
    return statistics.median(v / mics[q] for q, v in total.items())


def read(ctx):
    recs = run_spans(ctx)
    if not recs:
        return None
    return per_micrograph(recs, "spr.forward",
                          lambda r: (r.end_ns - r.start_ns) / 1e6)
