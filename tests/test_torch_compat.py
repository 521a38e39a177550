"""Reference PyTorch checkpoints: the port's reader against the JAX
package's.

Synthetic reference files are written with ``torch.save``, as
`tests/test_compat.py:189-209` does: the full reference name set (the
5-level denoise branch, the detector's input BatchNorm, ResNet8 and 1x1
classifier, the 3-level sigma estimator and ``l_params.estimated_sigma``,
with ``num_batches_tracked`` entries), built from seeded random port
modules and named through the JAX converter's own maps.  The cfg (and a
`.training`'s state, with a history object) is pickled under
``spr_pick.params`` names from a stand-in ``spr_pick`` package written into
a temporary directory: its ConfigValue has the reference's ``JOINT_LR =
1e-5`` between two runs of ``auto()``, and one member the enum table
cannot place.  The JAX loader imports the stand-in; the port never does
(it is dropped from ``sys.modules`` before every port load, and must not
come back).

Each file is read in both packages, as a zip `.wt`, a `.training`, a
legacy (non-zip) `.wt` and a `.wt` without a detector: the port's tensors
equal the JAX tree after HWIO -> OIHW bit for bit, and the cfg (the LR
1e-5 -> 1e-4 rule included), the mode (a file without a detector loads in
"denoise" mode with a warning) and the iteration are equal.  The port's
Picker on the CPU picks what the JAX Picker picks from the same reference
file (float32: a reference cfg records no compute dtype, so both packages'
defaults are set to float32 for that test; the A half of ``out_conv``
zeroed so z == mu, scores within 1e-5).  Beside: both ``auto()`` value
runs of the reference's ConfigValue place, an unplaced value is dropped
with a warning, a file naming ``os.system`` or a jax global is refused,
and a file written by the port's `save_reference_checkpoint` reads back
the same in both packages.
"""

import io
import logging
import os
import pickle
import sys
import textwrap

import numpy as np
import pytest
import torch

from spr_pick_tpu import cfg as jax_cfg
from spr_pick_tpu import compat as jcompat
from spr_pick_tpu.api import Picker as JPicker
from spr_pick_tpu.utils import checkpoint as jckpt
from spr_pick_tpu_torch import cfg as cfg_mod
from spr_pick_tpu_torch import compat, weights
from spr_pick_tpu_torch.api import Picker
from spr_pick_tpu_torch.data import mrc
from spr_pick_tpu_torch.models import BlindspotUNet, JointNetwork
from spr_pick_tpu_torch.params import ConfigValue
from spr_pick_tpu_torch.utils import checkpoint as ckpt
from spr_pick_tpu_torch.utils import ref_pickle
from tests.test_torch_api import assert_same_picks
from tests.test_torch_models import randomize

ITERATION = 1234

STAND_IN_PARAMS = textwrap.dedent('''
    from enum import Enum, auto


    class NoiseAlgorithm(Enum):
        SELFSUPERVISED_DENOISING = "ssdn"
        SELFSUPERVISED_DENOISING_MEAN_ONLY = "ssdn_u_only"
        NOISE_TO_NOISE = "n2n"
        NOISE_TO_CLEAN = "n2c"
        NOISE_TO_VOID = "n2v"


    class NoiseValue(Enum):
        UNKNOWN_CONSTANT = "const"
        UNKNOWN_VARIABLE = "var"
        KNOWN = "known"


    class Pipeline(Enum):
        MSE = "mse"
        SSDN = "ssdn"
        MASK_MSE = "mask_mse"


    class ConfigValue(Enum):
    ''') + "".join(
    f"    {name} = auto()\n" for name in """
    INFER_CFG ALGORITHM BLINDSPOT PIPELINE IMAGE_CHANNELS
    NOISE_STYLE BB LEARNING_RATE LR_RAMPUP_FRACTION LR_RAMPDOWN_FRACTION
    DETECTLOSS NOISE_VALUE DIAGONAL_COVARIANCE NMS
    EVAL_INTERVAL PRINT_INTERVAL SNAPSHOT_INTERVAL ITERATIONS
    DATALOADER_WORKERS
    TRAIN_DATASET_NAME TRAIN_DATASET_TYPE TRAIN_GT_PATH TRAIN_DATA_PATH
    TRAIN_LABEL_PATH TRAIN_PATCH_SIZE TRAIN_MINIBATCH_SIZE
    TEST_GT_PATH TEST_DATASET_NAME TEST_DATASET_TYPE TEST_DATA_PATH
    TEST_LABEL_PATH TEST_MINIBATCH_SIZE PIN_DATA_MEMORY""".split()
) + textwrap.dedent('''
        JOINT_LR = 1e-5
        ALPHA = auto()
        FRACTION = auto()
        NUM_EVAL = auto()
        TAU = auto()
        FUTURE_KEY = 99


    class DatasetType(Enum):
        HDF5 = auto()
        FOLDER = auto()
        TXT = auto()


    class StateValue(Enum):
        INITIALISED = auto()
        MODE = auto()
        ITERATION = auto()
        REFERENCE = auto()
        HISTORY = auto()


    class HistoryValue(Enum):
        TRAIN = auto()
        EVAL = auto()
        TIMINGS = auto()
    ''').replace("\n        ", "\n    ")

STAND_IN_UTILS = textwrap.dedent('''
    from collections import OrderedDict


    class MetricDict(OrderedDict):
        pass


    class Metric:
        def __init__(self):
            self.total, self.n = 1.5, 3
    ''')


def _drop_stand_in():
    for name in [m for m in sys.modules
                 if m == "spr_pick" or m.startswith("spr_pick.")]:
        del sys.modules[name]


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The stand-in reference package on sys.path, for this module."""
    root = tmp_path_factory.mktemp("reference")
    pkg = root / "spr_pick"
    pkg.mkdir()
    (pkg / "__init__.py").write_text("")
    (pkg / "params.py").write_text(STAND_IN_PARAMS)
    (pkg / "utils.py").write_text(STAND_IN_UTILS)
    sys.path.insert(0, str(root))
    try:
        yield stand_in
    finally:
        sys.path.remove(str(root))
        _drop_stand_in()


def stand_in():
    """(params, utils) of the stand-in, imported anew if a port load
    dropped it: a class pickles only as the module's current object."""
    import spr_pick.params as params
    import spr_pick.utils as utils

    return params, utils


def port_load(path, mode="joint"):
    """The port's loader, with no reference module importable in
    ``sys.modules``; it must not import one."""
    _drop_stand_in()
    state = ckpt.load(path, mode=mode)
    assert not [m for m in sys.modules if m.split(".")[0] == "spr_pick"]
    return state


def jax_load(path, ref, mode="joint"):
    ref()  # the stand-in, imported again
    return jckpt.load(path, mode=mode)


def _inverse(name_map):
    return {ours: theirs for theirs, ours in name_map.items()}


def reference_state_dict(detector=True, sigma=True, zero_a=False, seed=0):
    """Reference names (through the JAX converter's maps) -> seeded random
    tensors of the port's module shapes."""
    net = randomize(JointNetwork(), seed=seed)
    if zero_a:
        head = net.denoise_branch.out_conv.conv
        with torch.no_grad():
            head.weight[1:] = 0.0
            head.bias[1:] = 0.0
            net.detector.classifier.classifier.weight.mul_(20)
    unet5 = _inverse(jcompat._UNET5)
    mp = "models.denoiser_model."
    sd = {}
    for key, t in net.state_dict().items():
        parts = key.split(".")
        if parts[0] == "denoise_branch":
            sd[f"{mp}denoise_branch.{unet5[parts[1]]}.{parts[-1]}"] = t
        elif not detector:
            continue
        elif parts[1] == "input_bn":
            sd[f"{mp}detector.m.{parts[-1]}"] = t
        elif parts[1] == "features":
            i = jcompat._RESNET_LAYER.index(parts[2])
            rest = ".".join(parts[3:])
            sd[f"{mp}detector.detector.features.features.{i}.{rest}"] = t
        else:
            sd[f"{mp}detector.detector.classifier.{parts[-1]}"] = t
    if sigma:
        unet3 = _inverse(jcompat._UNET3)
        net3 = randomize(BlindspotUNet(out_channels=1, levels=3), seed=seed + 1)
        for key, t in net3.state_dict().items():
            name, _, leaf = key.split(".")
            sd[f"models.sigma_estimation_model.{unet3[name]}.{leaf}"] = t
    sd["l_params.estimated_sigma"] = torch.full((1, 1, 1, 1), 0.3)
    return sd


def reference_cfg(params):
    cv = params.ConfigValue
    cfg = {
        cv.ALGORITHM: params.NoiseAlgorithm.SELFSUPERVISED_DENOISING,
        cv.NOISE_STYLE: "gauss",
        cv.NOISE_VALUE: params.NoiseValue.UNKNOWN_CONSTANT,
        cv.PIPELINE: params.Pipeline.SSDN,
        cv.LEARNING_RATE: 1e-5,
        cv.JOINT_LR: 1e-5,
        cv.ALPHA: 0.75,
        cv.TAU: 0.05,
        cv.NUM_EVAL: 2,
        cv.NMS: 9,
        cv.TRAIN_DATASET_TYPE: params.DatasetType.TXT,
        cv.TRAIN_MINIBATCH_SIZE: 8,
    }
    return cfg


FORMS = ["wt", "training", "legacy", "denoise_only"]


def write_reference(path, ref, form, zero_a=False):
    params, utils = ref()
    sd = reference_state_dict(detector=form != "denoise_only",
                              sigma=form != "denoise_only", zero_a=zero_a)
    sd["cfg"] = reference_cfg(params)
    obj = sd
    if form == "training":
        history = utils.MetricDict()
        history["loss"] = utils.Metric()
        obj = {"denoiser": sd,
               "optimizer": {"state": {}, "param_groups": [{"lr": 1e-4}]},
               "state": {params.StateValue.ITERATION: ITERATION,
                         params.StateValue.HISTORY: {
                             params.HistoryValue.TRAIN: history}}}
    torch.save(obj, path, _use_new_zipfile_serialization=form != "legacy")
    return path


@pytest.fixture(scope="module")
def files(ref, tmp_path_factory):
    d = tmp_path_factory.mktemp("files")
    return {form: write_reference(str(d / f"{form}.wt"), ref, form)
            for form in FORMS}


def comparable(cfg):
    """cfg -> {key name: value}, enum values as (class name, member)."""
    def norm(v):
        return (type(v).__name__, v.name) if hasattr(v, "name") else v

    return {k.name: norm(v) for k, v in cfg.items()}


def assert_trees_bit_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            assert_trees_bit_equal(a[k], b[k])
        else:
            x, y = np.asarray(a[k]), np.asarray(b[k])
            assert x.dtype == y.dtype and np.array_equal(x, y), k


@pytest.mark.parametrize("form", FORMS)
def test_tensors_match_jax_converter(form):
    sd = reference_state_dict(detector=form != "denoise_only",
                              sigma=form != "denoise_only")
    jt, js = jcompat.trainable_static_from_reference(sd)
    want = weights.flax_to_state(jt, js)
    got = compat.convert_reference_state_dict(sd)
    assert got.keys() == want.keys()
    for group in want:
        w = {k: v for k, v in want[group].items()
             if not k.endswith("num_batches_tracked")}
        assert got[group].keys() == w.keys(), group
        for k, t in w.items():
            assert torch.equal(got[group][k], t), (group, k)
    if form != "denoise_only":
        assert {"model", "sigma", "l_params"} == set(got)
        # Every leaf of the port's model, and no BatchNorm counters.
        assert set(got["model"]) == {
            k for k in JointNetwork().state_dict()
            if not k.endswith("num_batches_tracked")}


@pytest.mark.parametrize("form", FORMS)
def test_load_matches_jax(form, files, ref, caplog):
    with caplog.at_level(logging.WARNING):
        want = jax_load(files[form], ref)
        got = port_load(files[form])
    assert got["format"] == want["format"]
    assert got["mode"] == want["mode"]
    assert got["mode"] == ("denoise" if form == "denoise_only" else "joint")
    if form == "denoise_only":
        assert sum("no detector weights" in r.getMessage()
                   for r in caplog.records) == 2
    assert got.get("iteration") == want.get("iteration")
    if form == "training":
        assert got["iteration"] == ITERATION
        assert got["opt_state"] is None and got["rng_key"] is None
        assert got["extra"] == {}
    assert comparable(got["cfg"]) == comparable(want["cfg"])
    assert got["cfg"][ConfigValue.LEARNING_RATE] == 1e-4
    assert got["cfg"][ConfigValue.ALPHA] == 0.75
    assert got["cfg"][ConfigValue.TAU] == 0.05
    assert_trees_bit_equal(got["trainable"], want["trainable"])
    assert_trees_bit_equal(got["static"], want["static"])


def test_unplaced_value_is_dropped_with_a_warning(files, ref, caplog):
    params, _ = ref()
    path = files["wt"].replace("wt.wt", "future.wt")
    sd = reference_state_dict(sigma=False)
    sd["cfg"] = reference_cfg(params)
    sd["cfg"][params.ConfigValue.FUTURE_KEY] = 1
    torch.save(sd, path)
    with caplog.at_level(logging.WARNING, logger="compat"):
        got = port_load(path)
    msgs = [r.getMessage() for r in caplog.records
            if "not in the enum table" in r.getMessage()]
    assert len(msgs) == 1 and "ConfigValue(99)" in msgs[0]
    assert got["cfg"][ConfigValue.NMS] == 9


@pytest.mark.parametrize("name,values", [
    ("ALPHA", (1e-5 + 1, 34)), ("FRACTION", (1e-5 + 1 + 1, 35)),
    ("NUM_EVAL", (1e-5 + 1 + 1 + 1, 36)), ("TAU", (1e-5 + 1 + 1 + 1 + 1, 37)),
])
def test_both_auto_runs_of_config_value_place(ref, name, values):
    """A file pickled on Python <= 3.10 stores ALPHA as 1e-5 + 1; one from
    3.11 on stores 34 (the stand-in, on this Python, gives the latter)."""
    params, _ = ref()
    assert getattr(params.ConfigValue, name).value == values[1]
    for value in values:
        data = pickle.dumps({"k": _as_ref_enum(params, value)}, protocol=2)
        got = ref_pickle.load(io.BytesIO(data))["k"]
        assert got is ConfigValue[name], (value, got)


def _as_ref_enum(params, value):
    """An object that pickles as ``spr_pick.params.ConfigValue(value)``."""

    class Stored:
        def __reduce__(self):
            return params.ConfigValue, (value,)

    return Stored()


@pytest.mark.parametrize("payload", ["os_system", "jax_global"])
def test_foreign_globals_are_refused(tmp_path, payload):
    import jax

    obj = os.system if payload == "os_system" else jax.random.PRNGKey
    path = str(tmp_path / "bad.wt")
    torch.save({"cfg": {"x": obj}, "w": torch.zeros(2)}, path)
    with pytest.raises(ckpt.CheckpointError, match="does not load"):
        ckpt.load(path)


def test_picker_matches_jax_picker(ref, tmp_path, monkeypatch):
    def f32(base, key):
        def wrapped():
            c = base()
            c[key] = "f32"
            return c
        return wrapped

    monkeypatch.setattr(jax_cfg, "base",
                        f32(jax_cfg.base, jax_cfg.ConfigValue.COMPUTE_DTYPE))
    monkeypatch.setattr(cfg_mod, "base",
                        f32(cfg_mod.base, ConfigValue.COMPUTE_DTYPE))
    path = write_reference(str(tmp_path / "ref.wt"), ref, "wt", zero_a=True)
    rng = np.random.RandomState(0)
    mic = str(tmp_path / "mic.mrc")
    mrc.write(mic, (rng.randn(128, 128) * 3 + 10).astype(np.float32))
    jpicker = JPicker(path)
    _drop_stand_in()
    picker = Picker(path, device="cpu")
    assert picker.denoiser.compute_dtype is None
    assert picker.nms_radius == 9
    jpicker.border = picker.border = 0
    assert_same_picks(picker.pick(mic), jpicker.pick(mic))


@pytest.mark.parametrize("legacy", [False, True], ids=["zip", "legacy"])
def test_port_writer_reads_back_in_both_packages(ref, tmp_path, legacy):
    state = port_load(write_reference(str(tmp_path / "a.training"), ref,
                                      "training"))
    path = str(tmp_path / "b.training")
    compat.save_reference_checkpoint(path, state["trainable"], state["static"],
                                     state["cfg"], iteration=ITERATION,
                                     legacy=legacy)
    got = port_load(path)
    want = jax_load(path, ref)
    assert got["iteration"] == want["iteration"] == ITERATION
    assert comparable(got["cfg"]) == comparable(want["cfg"])
    assert comparable(got["cfg"]) == comparable(state["cfg"])
    assert_trees_bit_equal(got["trainable"], state["trainable"])
    assert_trees_bit_equal(want["trainable"], state["trainable"])
    assert_trees_bit_equal(got["static"], want["static"])


def test_train_resume_loads_a_reference_training_file(files):
    """`train resume`'s loader takes a reference `.training` as it is: the
    iteration from its state, the weights, and Adam started fresh (the
    reference optimizer state is not carried over)."""
    from spr_pick_tpu_torch.train import DenoiserTrainer

    _drop_stand_in()
    trainer = DenoiserTrainer(None, device="cpu")
    trainer.load_state_dict(files["training"])
    assert trainer.iteration == ITERATION
    assert trainer.train_state.step == ITERATION // 8  # the cfg's batch 8
    assert trainer.train_state.opt.count == 0
    assert not any(t.any() for t in trainer.train_state.opt.mu)
    got, _ = trainer.denoiser.variables()
    want = port_load(files["training"])["trainable"]
    # The file's sigma estimator is unused with a `const` noise s.d.
    assert set(want) - set(got) == {"sigma"}
    assert_trees_bit_equal(got, {k: want[k] for k in got})
