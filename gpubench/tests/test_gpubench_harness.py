"""The harness finds a cell's configuration, traffic mix, entry, counts,
limits and per-layer readers by name, so new ones are files and entries
only."""

import io
import json
import os

import pytest

from gpubench.bench import run_cell
from gpubench.harness import find_cell, metric_applies, read_per_layer


def test_cells_of_the_benchmark_resolve():
    for name, e2e in (("pick1k.joint_r8", {"mic_rate", "setup_s"}),
                      ("denoise1k.dn_ssdn",
                       {"mic_rate", "mic_p95_ms", "setup_s"})):
        cell = find_cell(name)
        assert cell.chips == 1
        assert {m["name"] for m in cell.end_to_end} == e2e
        assert cell.limits, name
        assert set(cell.readers) == {m["name"] for m in cell.per_layer}
    pick = {m["name"] for m in find_cell("pick1k.joint_r8").per_layer}
    den = {m["name"] for m in find_cell("denoise1k.dn_ssdn").per_layer}
    assert {"k1_ms.pick", "k1_roofline.pick"} <= pick
    assert not {"k1_ms.pick", "k1_roofline.pick"} & den


def test_new_config_mix_and_metric_from_files_alone(tiny_root):
    """A dummy configuration, mix and metric dropped into a copy, with
    entries in its BENCHMARK.json: found with no code edited."""
    here = os.path.join(tiny_root, "gpubench")
    with open(os.path.join(here, "configs", "joint_r8.json")) as f:
        conf = json.load(f)
    conf["name"] = "dummy_cfg"
    with open(os.path.join(here, "configs", "dummy_cfg.json"), "w") as f:
        json.dump(conf, f)
    with open(os.path.join(here, "counts", "dummy_cfg.py"), "w") as f:
        f.write("def mic_flops(model, h, w):\n    return 7 * h * w\n")
    with open(os.path.join(here, "traffic", "pick1k.json")) as f:
        mix = json.load(f)
    mix["pool"] = 3
    with open(os.path.join(here, "traffic", "dummy_mix.json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(here, "metrics", "dummy_metric.x.py"), "w") as f:
        f.write("def read(ctx):\n    return 2.0 * ctx['traced_requests']\n")
    with open(os.path.join(here, "metrics", "silent.x.py"), "w") as f:
        f.write("def read(ctx):\n    return None\n")
    spec_path = os.path.join(tiny_root, "BENCHMARK.json")
    with open(spec_path) as f:
        spec = json.load(f)
    spec["configs"].append({"name": "dummy_cfg", "source": "https://example.org",
                            "file": "gpubench/configs/dummy_cfg.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "dummy_mix.dummy_cfg",
                              "config": "dummy_cfg", "traffic": "dummy_mix",
                              "chips": 1, "why": "test"})
    for name in ("dummy_metric.x", "silent.x"):
        spec["per_layer"].append({"name": name, "unit": "ms",
                                  "better": "lower", "source": "device_trace",
                                  "layer": "test", "moves": "mic_rate",
                                  "workloads": ["dummy_mix.dummy_cfg"]})
    with open(spec_path, "w") as f:
        json.dump(spec, f)

    cell = find_cell("dummy_mix.dummy_cfg", tiny_root)
    assert cell.config["name"] == "dummy_cfg"
    assert cell.traffic["pool"] == 3
    assert cell.counts.mic_flops(cell.config["model"], 2, 3) == 42
    assert set(cell.readers) == {"dummy_metric.x", "silent.x"}
    got = read_per_layer(cell, {"traced_requests": 5})
    assert got == {"dummy_metric.x": {"value": 10.0, "unit": "ms"}}
    # The old cells still resolve in the copy, without the new metrics.
    old = find_cell("pick1k.joint_r8", tiny_root)
    assert "dummy_metric.x" not in old.readers


def _edit_spec(root, edit):
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        spec = json.load(f)
    edit(spec)
    with open(path, "w") as f:
        json.dump(spec, f)


ECHO = '''"""A dummy entry: each request doubles a number."""

EXACT = ("odd",)


class Prepared:
    def __init__(self, seed):
        self.items = [seed % 7 + i for i in range(3)]
        self.program = lambda x: 2 * x

    def release(self):
        self.program = None


def prepare(cell, seed, device, tmp):
    return Prepared(seed)


def call(program, item):
    return program(item)


def size(answer):
    return 1


def end_to_end(latencies, sizes, window_s, err):
    return {"echo_rate": len(latencies) / window_s}


def judge(cell, prep, index, answer, device):
    want = 2 * prep.items[index]
    return {"gap": abs(answer - want) / want, "odd": float(answer % 2)}


def control(cell, prep, index, device):
    return 2 * prep.items[index] + 1
'''


def test_new_entry_from_files_alone(tiny_root):
    """A new entry module and a mix that names it, with a cell, an
    end-to-end metric and limits: run with no code edited."""
    here = os.path.join(tiny_root, "gpubench")
    with open(os.path.join(here, "entries", "echo.py"), "w") as f:
        f.write(ECHO)
    with open(os.path.join(here, "traffic", "echo3.json"), "w") as f:
        json.dump({"entry": "echo", "warmup": 1, "checked": 2,
                   "traced_requests": 1}, f)
    with open(os.path.join(here, "limits", "echo3.dn_ssdn.json"), "w") as f:
        json.dump({"gap": {"limit": 0.01}}, f)

    def edit(spec):
        spec["workloads"].append({"name": "echo3.dn_ssdn", "config": "dn_ssdn",
                                  "traffic": "echo3", "chips": 1,
                                  "why": "test"})
        spec["end_to_end"].append({"name": "echo_rate", "unit": "1/s",
                                   "better": "higher", "bound": 0.1,
                                   "source": "host_clock",
                                   "workloads": ["echo3.dn_ssdn"]})
    _edit_spec(tiny_root, edit)

    cell = find_cell("echo3.dn_ssdn", tiny_root)
    out, err = io.StringIO(), io.StringIO()
    res = run_cell(cell, 2 ** 31 + 11, 0.2, False, "cpu", out=out, err=err)
    assert res["correct"] is True, res["checks"]
    assert set(res["metrics"]) == {"echo_rate", "setup_s"}
    assert res["checks"] == {"gap": {"value": 0.0, "limit": 0.01},
                             "odd": {"value": 0.0, "limit": 0.0}}
    # The old cells still resolve in the copy, without the new metric.
    assert "echo_rate" not in {m["name"] for m in
                               find_cell("pick1k.joint_r8",
                                         tiny_root).end_to_end}


def test_precision_without_a_judge_is_refused(tiny_root):
    """A configuration whose compute precision the reference has no
    yardstick and control for stops the run before its window."""
    path = os.path.join(tiny_root, "gpubench", "configs", "dn_ssdn.json")
    with open(path) as f:
        conf = json.load(f)
    conf["cfg"]["COMPUTE_DTYPE"] = "f32"
    with open(path, "w") as f:
        json.dump(conf, f)
    out = io.StringIO()
    with pytest.raises(ValueError, match="COMPUTE_DTYPE 'f32'"):
        run_cell(find_cell("denoise1k.dn_ssdn", tiny_root), 1, 0.2, False,
                 "cpu", out=out, err=io.StringIO())
    assert out.getvalue() == ""


def test_metric_applies():
    assert metric_applies({"name": "m", "layer": "l", "workloads": ["a"]},
                          "a")
    assert not metric_applies({"name": "m", "layer": "l",
                               "workloads": ["a"]}, "b")
    assert metric_applies({"name": "setup_s", "bound": 0.25}, "b")
    with pytest.raises(ValueError, match="lists no workloads"):
        metric_applies({"name": "m", "layer": "l", "moves": "x"}, "b")
