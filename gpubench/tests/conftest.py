"""Shared fixtures of the benchmark's CPU tests: a copy of the benchmark's
files (BENCHMARK.json and gpubench/) whose traffic mixes are cut to a size
the CPU runs in a second."""

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def copy_benchmark(dest: str) -> str:
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dest)
    shutil.copytree(os.path.join(ROOT, "gpubench"),
                    os.path.join(dest, "gpubench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return dest


@pytest.fixture
def tiny_root(tmp_path):
    """A benchmark copy whose mixes make 128^2 micrographs, two a pool, and
    whose detector's maps are denser, so such a map has picks inside its
    border frame as a 1024^2 one does."""
    root = copy_benchmark(str(tmp_path))
    configs = os.path.join(root, "gpubench", "configs")
    for name in os.listdir(configs):
        path = os.path.join(configs, name)
        with open(path) as f:
            conf = json.load(f)
        if "picks_per_mpx" in conf["model"]:
            conf["model"]["picks_per_mpx"] = 3000
        with open(path, "w") as f:
            json.dump(conf, f)
    traffic = os.path.join(root, "gpubench", "traffic")
    for name in os.listdir(traffic):
        path = os.path.join(traffic, name)
        with open(path) as f:
            mix = json.load(f)
        mix.update(height=128, width=128, pool=2, warmup=1, checked=2,
                   traced_requests=2)
        with open(path, "w") as f:
            json.dump(mix, f)
    return root
