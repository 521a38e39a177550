"""Console + file logging setup.

The PyTorch port's copy of `spr_pick_tpu/utils/logging_helper.py` (stdlib
logging only; ANSI colours on a terminal).
"""

from __future__ import annotations

import logging
import os
import sys

LOG_FORMAT = "%(asctime)s [%(levelname)s] %(message)s"
DATE_FORMAT = "%H:%M:%S"

_COLORS = {
    "DEBUG": "\033[36m",
    "INFO": "\033[32m",
    "WARNING": "\033[33m",
    "ERROR": "\033[31m",
    "CRITICAL": "\033[41m",
}
_RESET = "\033[0m"


class _ColorFormatter(logging.Formatter):
    def format(self, record):
        msg = super().format(record)
        if sys.stderr.isatty():
            return f"{_COLORS.get(record.levelname, '')}{msg}{_RESET}"
        return msg


def setup(log_dir: str = None, filename: str = "log.txt", level=logging.INFO):
    root = logging.getLogger()
    root.setLevel(level)
    # Avoid duplicate handlers across repeated setup() calls.
    for h in list(root.handlers):
        if getattr(h, "_spr_pick_tpu_torch", False):
            root.removeHandler(h)
            h.close()

    console = logging.StreamHandler()
    console.setFormatter(_ColorFormatter(LOG_FORMAT, DATE_FORMAT))
    console._spr_pick_tpu_torch = True
    root.addHandler(console)

    if log_dir is not None:
        os.makedirs(log_dir, exist_ok=True)
        fileh = logging.FileHandler(os.path.join(log_dir, filename))
        fileh.setFormatter(logging.Formatter(LOG_FORMAT, DATE_FORMAT))
        fileh._spr_pick_tpu_torch = True
        root.addHandler(fileh)
    return root
