"""Checkpoints written by the JAX package load in the PyTorch port.

The JAX package writes a `.wt` and a `.training` of a freshly initialised
joint model (ssdn, gauss, var: U-Net, detector with BatchNorm statistics,
sigma net); the port's loader must return bit-equal arrays, the cfg keyed by
its own enums, and refuse any global it does not map.
"""

import os
import pickle

import jax
import numpy as np
import pytest

from spr_pick_tpu import cfg as jax_cfg
from spr_pick_tpu.denoiser import Denoiser as JDenoiser
from spr_pick_tpu.params import ConfigValue as JCV
from spr_pick_tpu.params import NoiseAlgorithm as JNoiseAlgorithm
from spr_pick_tpu.params import NoiseValue as JNoiseValue
from spr_pick_tpu.steps import make_optimizer
from spr_pick_tpu.utils import checkpoint as jax_ckpt
from spr_pick_tpu_torch import params, weights
from spr_pick_tpu_torch.api import Picker
from spr_pick_tpu_torch.denoiser import Denoiser
from spr_pick_tpu_torch.utils import checkpoint as ckpt


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def assert_trees_bit_equal(a, b):
    fa, fb = dict(_flat(a)), dict(_flat(b))
    assert fa.keys() == fb.keys()
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and fa[k].shape == fb[k].shape, k
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=str(k))


@pytest.fixture(scope="module")
def jax_state(tmp_path_factory):
    cfg = jax_cfg.base()
    cfg[JCV.ALGORITHM] = JNoiseAlgorithm.SELFSUPERVISED_DENOISING
    cfg[JCV.NOISE_STYLE] = "gauss"
    cfg[JCV.NOISE_VALUE] = JNoiseValue.UNKNOWN_VARIABLE
    den = JDenoiser(cfg, mode="joint")
    variables = jax.jit(lambda: den.init_variables(seed=0))()
    trainable, static = JDenoiser.split_trainable(variables)
    trainable = jax.tree_util.tree_map(np.asarray, trainable)
    static = jax.tree_util.tree_map(np.asarray, static)
    d = tmp_path_factory.mktemp("ckpt")
    wt = str(d / "model.wt")
    training = str(d / "model.training")
    jax_ckpt.save_weights(wt, trainable, static, cfg, "joint")
    jax_ckpt.save_training(
        training, trainable, static, make_optimizer().init(trainable), cfg,
        "joint", 12, rng_key=jax.random.PRNGKey(3),
    )
    return dict(cfg=cfg, trainable=trainable, static=static, wt=wt,
                training=training)


def test_jax_wt_loads_bit_equal(jax_state):
    state = ckpt.load(jax_state["wt"])
    assert state["format"] == "spr_pick_tpu.wt.v1"
    assert state["mode"] == "joint"
    assert_trees_bit_equal(state["trainable"], jax_state["trainable"])
    assert_trees_bit_equal(state["static"], jax_state["static"])
    cfg = state["cfg"]
    assert all(isinstance(k, params.ConfigValue) for k in cfg)
    assert {k.name for k in cfg} == {k.name for k in jax_state["cfg"]}
    assert cfg[params.ConfigValue.NOISE_VALUE] is params.NoiseValue.UNKNOWN_VARIABLE
    assert (cfg[params.ConfigValue.ALGORITHM]
            is params.NoiseAlgorithm.SELFSUPERVISED_DENOISING)
    assert cfg[params.ConfigValue.NMS] == 15


def test_jax_training_loads_with_optax_stand_in(jax_state):
    state = ckpt.load(jax_state["training"])
    assert state["iteration"] == 12
    assert_trees_bit_equal(state["trainable"], jax_state["trainable"])
    assert_trees_bit_equal(state["static"], jax_state["static"])
    opt = state["opt_state"]
    assert isinstance(opt, ckpt.OptState)
    assert opt.optax_name == "ScaleByAdamState"
    count, mu, nu = opt
    assert int(count) == 0
    assert_trees_bit_equal(mu, jax.tree_util.tree_map(np.zeros_like,
                                                       jax_state["trainable"]))


def test_weights_round_trip_bit_equal(jax_state):
    trainable = dict(jax_state["trainable"])
    trainable["l_params"] = {"estimated_sigma": np.full((1, 1, 1, 1), 0.25,
                                                        np.float32)}
    states = weights.flax_to_state(trainable, jax_state["static"])
    kernel = jax_state["trainable"]["model"]["denoise_branch"]["dec1_conv0"][
        "conv"]["kernel"]
    w = states["model"]["denoise_branch.dec1_conv0.conv.weight"]
    assert tuple(w.shape) == (96, 144, 3, 3)
    np.testing.assert_array_equal(w.numpy(), kernel.transpose(3, 2, 0, 1))
    back_t, back_s = weights.state_to_flax(states)
    assert_trees_bit_equal(back_t, trainable)
    assert_trees_bit_equal(back_s, jax_state["static"])


def test_denoiser_loads_jax_weights(jax_state):
    state = ckpt.load(jax_state["wt"])
    den = Denoiser(state["cfg"], device="cpu")
    den.load_variables(state["trainable"], state["static"])
    trainable, static = den.variables()
    assert_trees_bit_equal(trainable, jax_state["trainable"])
    assert_trees_bit_equal(static, jax_state["static"])


def test_picker_loads_training_and_wt_alike(jax_state):
    a = Picker(jax_state["training"], device="cpu").denoiser.variables()
    b = Picker(jax_state["wt"], device="cpu").denoiser.variables()
    assert_trees_bit_equal(a[0], b[0])
    assert_trees_bit_equal(a[1], b[1])


def test_port_writer_round_trip(jax_state, tmp_path):
    state = ckpt.load(jax_state["wt"])
    path = str(tmp_path / "port.wt")
    ckpt.save_weights(path, state["trainable"], state["static"], state["cfg"],
                      "joint")
    again = ckpt.load(path)
    assert again["format"] == state["format"]
    assert again["cfg"] == state["cfg"]
    assert_trees_bit_equal(again["trainable"], state["trainable"])


@pytest.mark.parametrize("payload", ["jax_function", "os_call", "zip"])
def test_foreign_checkpoint_is_refused(tmp_path, payload):
    """A pickle naming a global the loader does not map is refused; so is
    a truncated torch zip archive, which the loader hands to the reference
    reader (`compat.py`, `tests/test_torch_compat.py`)."""
    path = str(tmp_path / "bad.wt")
    if payload == "zip":
        with open(path, "wb") as f:
            f.write(b"PK\x03\x04not-a-pickle")
        match = "not a readable PyTorch checkpoint"
    else:
        obj = jax_cfg.base if payload == "jax_function" else os.getcwd
        with open(path, "wb") as f:
            pickle.dump({"trainable": {}, "cfg": obj}, f, protocol=4)
        match = "does not load"
    with pytest.raises(ckpt.CheckpointError, match=match):
        ckpt.load(path)
