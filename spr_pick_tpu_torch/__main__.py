"""`python -m spr_pick_tpu_torch pick|eval ...`."""

from spr_pick_tpu_torch.cli.cli import start

if __name__ == "__main__":
    start()
