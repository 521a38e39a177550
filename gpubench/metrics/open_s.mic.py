"""Seconds of the run's `Picker` open (span ``spr.open`` around
`Picker.__init__`'s evaluator: checkpoint read, model build, weights to
the device)."""


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
    if not recs:
        return None
    r = next(r for r in recs if r.name == "spr.open")
    return (r.end_ns - r.start_ns) / 1e9
