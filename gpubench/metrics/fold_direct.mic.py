"""The share of the U-Net's hand-offs between conv steps that their
producers wrote in place, kept on each request's root span: counter
``fold.direct`` (each destination that an epilogue or the fold's input
launch writes in a conv's input buffer, counted at the launch in
`ops/conv_epilogue.py`) over it plus ``fold.staged`` (each conv input that
a copy pass of its own writes: the two-lane fold's un-rotation, the NCHW
route's pads).  1.0 where no such copy pass wrote a conv's input; None on a
program without the counters."""


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
    direct = sum(r.attrs.get("fold.direct", 0) for r in roots)
    staged = sum(r.attrs.get("fold.staged", 0) for r in roots)
    if not direct + staged:
        return None
    return direct / (direct + staged)
