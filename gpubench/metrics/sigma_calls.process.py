"""Sigma-net forwards a micrograph (counter ``sigma.calls`` of
`Denoiser._noise_estimate`, kept on each request's root span): the run's
forwards over its micrographs.  None where the program keeps no such
counter."""


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
    calls = sum(r.attrs.get("sigma.calls", 0) for r in roots)
    mics = sum(r.attrs.get("micrographs", 0) for r in roots)
    if not calls or not mics:
        return None
    return calls / mics
