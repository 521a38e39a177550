"""The share of the U-Net's conv steps that ran on the channels-last route
through the hand-written epilogue (counters ``conv.fused`` and
``conv.plain`` of each inference forward of
`models/unet.py:BlindspotUNet`, kept on each request's root span): the
run's fused steps over all its steps.  1.0 where every step of every
forward took the route; None on a program without the counters."""


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


def read(ctx):
    recs = run_spans(ctx)
    roots = [r for r in recs or ()
             if r.name == "spr.request" and r.parent is None]
    fused = sum(r.attrs.get("conv.fused", 0) for r in roots)
    plain = sum(r.attrs.get("conv.plain", 0) for r in roots)
    if not fused + plain:
        return None
    return fused / (fused + plain)
