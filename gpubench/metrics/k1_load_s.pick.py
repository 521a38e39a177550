"""Seconds of the run's load of K1's library (span ``spr.k1.load`` in
`ops/nms_cuda.py:_Library.get`: the source's hash, nvcc when no library
of that source is built, ``ctypes.CDLL``).  None when an earlier run in
the process loaded it."""


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
    loads = [r for r in recs or () if r.name == "spr.k1.load"]
    if not loads:
        return None
    return sum(r.end_ns - r.start_ns for r in loads) / 1e9
