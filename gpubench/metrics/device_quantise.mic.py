"""The share of micrographs whose MRC min-max quantise ran on the device
(counter ``load.device_quantise`` of `Picker._forward`, kept on each
request's root span): the run's count over its micrographs.  1.0 where
every request's MRC took the device path, 0 where the host decoded all."""


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
    from spr_pick_tpu_torch.data import loader

    # A program without the device quantise has no such counter to read.
    if not recs or not hasattr(loader, "minmax_quantize_device"):
        return None
    roots = [r for r in recs if r.name == "spr.request" and r.parent is None]
    mics = sum(r.attrs.get("micrographs", 0) for r in roots)
    if not mics:
        return None
    return sum(r.attrs.get("load.device_quantise", 0) for r in roots) / mics
