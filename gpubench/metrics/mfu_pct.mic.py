"""The whole dense forward's share of the card's bf16 peak: the model's
operations a micrograph (`gpubench/counts/<config>.py`, convolutions from
shapes) times the micrographs a second the window completed, over the peak
(`gpubench/peaks.json`)."""


def read(ctx):
    rate = ctx["rate"]
    if not rate:
        return None
    cell = ctx["cell"]
    h, w = int(cell.traffic["height"]), int(cell.traffic["width"])
    flops = cell.counts.mic_flops(cell.config["model"], h, w)
    return 100.0 * flops * rate / ctx["peaks"]["bf16_flops_per_s"]
