"""The port's bf16 path against the JAX package's bf16 path, stage by stage.

bf16 is the compute dtype both packages default to.  Chained, two bf16
networks drift apart by rounding amplified with depth (x2-3 an encoder
level), so an end-to-end tolerance would hide a wrong cast.  Here every
stage of the port is fed the JAX stage's own bf16 input, recorded by
wrapping the JAX functions inside the test (`_shift_conv_xla`, `_leaky`,
`_dense_backbone`, and flax's `intercept_methods` over the modules), and
computes it in bf16 on the CPU.

The model is a JAX-initialised joint model at full width (U-Net 48/96,
ResNet8) with every parameter perturbed from a seed: nonzero biases,
BatchNorm scale, bias, mean and var away from 1/0, the A head nonzero.  It
is carried to the port with `weights.flax_to_state`.

Tolerances (bf16 stages, fed the same input): at most FRAC_ULP = 1e-3 of
the elements may differ, by at most MAX_ULP = 2 bf16 ulps, the ulp taken
at the magnitude where the stage rounded (`ulp_stats`).  What is left is
accumulation order, oneDNN's float32 sums against XLA's, each rounded
once to bf16.  Measured after the repairs: at most 1.6e-4 of a conv
stage's elements and 7.5e-4 of a train-mode BatchNorm's (batch
statistics summed in another order), 2 ulp at most.  Before them, each
blind-spot conv + LeakyReLU differed in 30-34% of elements: the bias fused
into the conv rounds once where JAX rounds the conv and then the bf16
sum, and the slope was 0.1 in float32 where JAX's is bf16(0.1) =
0.10009765625.  Pools, upsamples, concatenations, the residual add, the
ReLUs, the sample and the LeakyReLU fed JAX's own pre-activation are
exact.  The classifier's logits are a float32 conv of bf16 features:
rtol RTOL_F32.  The clamped sigmoid is float32: 1 ulp (XLA's logistic
and torch's sigmoid round apart in ~0.5% of elements).

Chained tolerances, only where stated: the dense folds (stage 3) as whole
functions, and one joint train step (stage 9), are bounded by JAX's own
bf16-against-float32 distance on the same input (FOLD_SHARE and
STEP_SHARE of it; the flip-consistency term through the detector outputs
it is made from).  Each stage prints its float32 distance for scale (the
port's float32 stage against JAX's bf16 stage): run with ``-s``.
"""

from __future__ import annotations

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

import spr_pick_tpu.ops.dense_unet as jdu
from spr_pick_tpu import cfg as jcfg_mod
from spr_pick_tpu import losses as jlosses
from spr_pick_tpu.denoiser import Denoiser as JDenoiser
from spr_pick_tpu.models import blindspot as jbs
from spr_pick_tpu.models.unet import BlindspotUNet as JUNet
from spr_pick_tpu.params import ConfigValue as JCV
from spr_pick_tpu.params import NoiseAlgorithm as JNA
from spr_pick_tpu.params import NoiseValue as JNV
from spr_pick_tpu.params import PipelineOutput as JPO
from spr_pick_tpu_torch import cfg as cfg_mod
from spr_pick_tpu_torch import losses, weights
from spr_pick_tpu_torch.denoiser import Denoiser
from spr_pick_tpu_torch.models import blindspot as tbs
from spr_pick_tpu_torch.models import resnet as tresnet
from spr_pick_tpu_torch.models.unet import BlindspotUNet
from spr_pick_tpu_torch.ops.dense_unet import dense_blindspot_unet
from spr_pick_tpu_torch.params import ConfigValue, NoiseAlgorithm, NoiseValue
from spr_pick_tpu_torch.params import PipelineOutput

FRAC_ULP = 1e-3
MAX_ULP = 2
RMS_FLOOR = 2.0 ** -8
RTOL_F32 = 1e-5
FOLD_SHARE = 0.75
STEP_SHARE = 1.5
SIZE = 64
B_TRAIN = 4
ALPHA, TAU = 0.75, 0.05
TARGET = np.array([0.9, -1.0, 0.0, 1.0], np.float32)
FLIP_KEY = 0

U_CONVS = (["enc1_conv0", "enc1_conv1"]
           + [f"enc{i}_conv0" for i in range(2, 6)] + ["enc_bottom_conv0"]
           + [f"dec{s}_conv{i}" for s in range(4) for i in range(2)]
           + ["dec_final_conv0", "dec_final_conv1"])
HEAD = ["out_block_conv0", "out_block_conv1", "out_conv"]
SIGMA_CONVS = (["enc1_conv0", "enc1_conv1", "enc2_conv0", "enc3_conv0",
                "enc_bottom_conv0"]
               + [f"dec{s}_conv{i}" for s in range(2) for i in range(2)]
               + ["dec_final_conv0", "dec_final_conv1"] + HEAD)
# The detector's modules in the order of its forward (flax paths).
DET_BLOCKS = ["layer0", "layer1", "layer2", "layer3", "layer4"]


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------

def _t(a) -> torch.Tensor:
    """A JAX/numpy array as a torch tensor of the same dtype (bf16 too)."""
    a = jnp.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(np.asarray(a.astype(jnp.float32))).bfloat16()
    return torch.from_numpy(np.array(a))


def nchw(a) -> torch.Tensor:
    return _t(a).permute(0, 3, 1, 2)


def nhwc(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 2, 3, 1)


def ulp_stats(got: torch.Tensor, want: torch.Tensor,
              scale: torch.Tensor | None = None):
    """(fraction of elements that differ, largest distance in bf16 ulps).

    The ulp is taken at the magnitude where the stage rounded: the larger
    of |want|, RMS_FLOOR of the stage's RMS, and ``scale``.  A float32 sum
    (a conv, a BatchNorm) that cancels to a value far below its terms
    keeps float32's rounding of them, which bf16 then shows as several
    ulps of the small result (up to 128 measured, all below the floor).
    A conv stage passes |conv before its bias| as ``scale``: the bias add
    can cancel most of a value, and one ulp of the conv is then many ulps
    of the small sum."""
    assert got.dtype == want.dtype == torch.bfloat16, (got.dtype, want.dtype)
    assert got.shape == want.shape, (got.shape, want.shape)
    mag = torch.maximum(want.float().abs(),
                        RMS_FLOOR * want.float().pow(2).mean().sqrt())
    if scale is not None:
        mag = torch.maximum(mag, scale.float().abs())
    ulp = torch.exp2(torch.floor(torch.log2(mag.clamp(min=2.0 ** -126))) - 7)
    d = (got.float() - want.float()).abs() / ulp
    return float((d > 0).float().mean()), float(d.max())


def conv_scale(want: torch.Tensor, bias: torch.Tensor, c_dim: int):
    """|conv before its bias| of a conv stage's output ``want``."""
    shape = [1] * want.ndim
    shape[c_dim] = -1
    return want.float() - bias.detach().bfloat16().float().reshape(shape)


def rel_l2(got, want) -> float:
    got = torch.as_tensor(got).double()
    want = torch.as_tensor(want).double()
    return float(torch.linalg.vector_norm(got - want)
                 / torch.linalg.vector_norm(want))


def assert_stage(name: str, got: torch.Tensor, want: torch.Tensor,
                 got32: torch.Tensor | None = None,
                 scale: torch.Tensor | None = None) -> None:
    frac, worst = ulp_stats(got, want, scale)
    f32 = "" if got32 is None else \
        f", float32 stage vs JAX bf16 rel L2 {rel_l2(got32.float(), want.float()):.2e}"
    print(f"{name}: {frac:.2e} of elements differ, max {worst:g} ulp{f32}")
    assert frac <= FRAC_ULP and worst <= MAX_ULP, (name, frac, worst)


def record(fn, *args, **kwargs):
    """Run ``fn`` under flax's method interceptor: (its result, a dict of
    module path -> list of (module, input, output)) for every __call__."""
    recs: dict = {}

    def interceptor(next_fun, a, kw, ctx):
        y = next_fun(*a, **kw)
        if ctx.method_name == "__call__":
            recs.setdefault(ctx.module.path, []).append((ctx.module, a[0], y))
        return y

    with fnn.intercept_methods(interceptor):
        out = fn(*args, **kwargs)
    return out, recs


def perturb(tree, rng):
    """Every leaf moved from its init: biases, BatchNorm scale/mean/var."""
    out = {}
    for k in sorted(tree):
        a = tree[k]
        if isinstance(a, dict):
            out[k] = perturb(a, rng)
            continue
        a = np.array(a, np.float32)
        r = rng.randn(*a.shape).astype(np.float32)
        if k == "bias":
            a = a + 0.1 * r
        elif k == "scale":
            a = 1.0 + 0.1 * r
        elif k == "mean":
            a = 0.1 * r
        elif k == "var":
            a = (0.5 + rng.rand(*a.shape)).astype(np.float32)
        out[k] = a
    return out


def cfgs(dtype: str):
    c = cfg_mod.base()
    c[ConfigValue.ALGORITHM] = NoiseAlgorithm.SELFSUPERVISED_DENOISING
    c[ConfigValue.NOISE_STYLE] = "gauss"
    c[ConfigValue.NOISE_VALUE] = NoiseValue.UNKNOWN_CONSTANT
    c[ConfigValue.COMPUTE_DTYPE] = dtype
    j = jcfg_mod.base()
    j[JCV.ALGORITHM] = JNA.SELFSUPERVISED_DENOISING
    j[JCV.NOISE_STYLE] = "gauss"
    j[JCV.NOISE_VALUE] = JNV.UNKNOWN_CONSTANT
    j[JCV.COMPUTE_DTYPE] = dtype
    return c, j


class Fixed:
    """``jax.random.normal`` replaced by seeded arrays, in order."""

    def __init__(self, arrays):
        self.queue = list(arrays)

    def __enter__(self):
        self.normal = jax.random.normal

        def fixed(key, shape, dtype=jnp.float32):
            got = self.queue.pop(0)
            assert got.shape == tuple(shape), (got.shape, shape)
            return jnp.asarray(got, dtype)

        jax.random.normal = fixed
        return self

    def __exit__(self, *exc):
        jax.random.normal = self.normal


# ---------------------------------------------------------------------------
# Fixtures
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model():
    """The JAX denoisers (bf16, f32) and the port's (bf16, f32) on one set
    of perturbed full-width weights."""
    c16, j16 = cfgs("bf16")
    c32, j32 = cfgs("f32")
    jden = JDenoiser(j16, mode="joint", fold_tta=True)
    variables = jax.jit(lambda: jden.init_variables(seed=0))()
    trainable, static = JDenoiser.split_trainable(variables)
    rng = np.random.RandomState(7)
    trainable, static = perturb(trainable, rng), perturb(static, rng)
    trainable["l_params"]["estimated_sigma"] = np.float32(0.3) + \
        0 * trainable["l_params"]["estimated_sigma"]
    ports = {}
    for name, c in (("bf16", c16), ("f32", c32)):
        den = Denoiser(c, device="cpu", fold_tta=True)
        den.load_variables(trainable, static)
        ports[name] = den.train(False)
    return dict(jax16=jden, jax32=JDenoiser(j32, mode="joint", fold_tta=True),
                trainable=trainable, static=static, port=ports["bf16"],
                port32=ports["f32"])


@pytest.fixture(scope="module")
def dense(model):
    """The JAX bf16 dense path on one 64^2 micrograph, every stage
    recorded: each blind-spot conv's input and output, each LeakyReLU's
    input and output, the backbone's output, the sample's noise and the
    detector's modules."""
    rng = np.random.RandomState(11)
    x = (rng.randn(1, SIZE, SIZE, 1) * 2 + 1).astype(np.float32)
    eps = rng.randn(1, SIZE, SIZE, 1).astype(np.float32)
    convs, leaky, backbone = [], [], []
    orig_conv, orig_leaky, orig_bb = (jdu._shift_conv_xla, jdu._leaky,
                                      jdu._dense_backbone)

    def conv(x_, w, b, blindspot=True, k=3, cdtype=jnp.bfloat16):
        y = orig_conv(x_, w, b, blindspot, k, cdtype)
        convs.append((x_, y))
        return y

    def leaky_(y):
        out = orig_leaky(y)
        leaky.append((y, out))
        return out

    def bb(*a, **kw):
        out = orig_bb(*a, **kw)
        backbone.append(out)
        return out

    jdu._shift_conv_xla, jdu._leaky, jdu._dense_backbone = conv, leaky_, bb
    try:
        variables = model["jax16"].merge_variables(model["trainable"],
                                                   model["static"])
        with Fixed([eps]):
            ((out_stats, logits), _), det = record(
                model["jax16"]._apply_model_fused, variables["model"],
                jnp.asarray(x), jax.random.PRNGKey(0))
    finally:
        jdu._shift_conv_xla, jdu._leaky, jdu._dense_backbone = (
            orig_conv, orig_leaky, orig_bb)
    assert len(convs) == len(U_CONVS) and len(leaky) == len(U_CONVS) + 2
    return dict(x=x, eps=eps, convs=dict(zip(U_CONVS, convs)), leaky=leaky,
                backbone=backbone[0], out_stats=out_stats, logits=logits,
                det={("detector",) + p: r for p, r in det.items()})


@pytest.fixture(scope="module")
def train_recs(model):
    """The flax joint model in train mode (bf16, batch 2, 64^2): every
    module's input and output."""
    rng = np.random.RandomState(13)
    x = rng.rand(2, SIZE, SIZE, 1).astype(np.float32)
    eps = rng.randn(2, SIZE, SIZE, 1).astype(np.float32)
    variables = model["jax16"].merge_variables(model["trainable"],
                                               model["static"])
    with Fixed([eps]):
        _, recs = record(model["jax16"]._apply_model, variables["model"],
                         jnp.asarray(x), jax.random.PRNGKey(0), True, False)
    return recs


# ---------------------------------------------------------------------------
# Stage 1: each ShiftConv + LeakyReLU of the blind-spot U-Net
# ---------------------------------------------------------------------------

def _shift_conv_leaky(den, name, x):
    m = getattr(den.model.denoise_branch, name)
    with torch.no_grad():
        return tbs.leaky_relu(m(nchw(x)))


@pytest.mark.parametrize("name", U_CONVS)
def test_shift_conv_leaky_dense(model, dense, name):
    """Against `_shift_conv_xla` + `_leaky`, fed the JAX conv's input."""
    x, y = dense["convs"][name]
    want = _t(jdu._leaky(y))
    got = nhwc(_shift_conv_leaky(model["port"], name, x))
    got32 = nhwc(_shift_conv_leaky(model["port32"], name, x))
    bias = getattr(model["port"].model.denoise_branch, name).conv.bias
    assert_stage(f"dense {name}", got, want, got32,
                 conv_scale(_t(y), bias, -1))


@pytest.mark.parametrize("name", U_CONVS)
def test_shift_conv_leaky_train(model, train_recs, name):
    """Against flax's ShiftConv + `nn.leaky_relu`, in the train-mode
    forward of the flax joint model (the rot4 fold of the module)."""
    (_, x, y), = train_recs[("denoise_branch", name)]
    want = _t(jbs.leaky_relu(y))
    got = nhwc(_shift_conv_leaky(model["port"], name, x))
    bias = getattr(model["port"].model.denoise_branch, name).conv.bias
    assert_stage(f"train {name}", got, want, scale=conv_scale(_t(y), bias, -1))


def test_leaky_relu_alone_is_exact(dense):
    """Each LeakyReLU fed JAX's own bf16 pre-activation: the slope is
    bf16(0.1) in both packages.  With 0.1 in float32 ~20% differ."""
    for i, (y, out) in enumerate(dense["leaky"]):
        got = tbs.leaky_relu(_t(y))
        assert got.dtype == torch.bfloat16
        frac, worst = ulp_stats(got, _t(out))
        print(f"LeakyReLU {i}: {frac:.2e} of elements differ")
        assert (frac, worst) == (0.0, 0.0)


# ---------------------------------------------------------------------------
# Stage 2: the shifted pool, the upsample and the concatenations (exact)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op", ["pool", "upsample", "concat_skip",
                                "concat_input"])
def test_pool_upsample_concat_exact(model, dense, op):
    unet = model["port"].model.denoise_branch
    h = dense["leaky"][1][1]  # enc1_conv1's activation, bf16
    if op == "pool":
        got, want = unet._pool(nchw(h)), nchw(jdu._pool_shifted(h))
    elif op == "upsample":
        got = tbs.upsample_nearest_2x(nchw(h))
        want = nchw(jnp.repeat(jnp.repeat(h, 2, axis=1), 2, axis=2))
    elif op == "concat_skip":
        skip = jdu._pool_shifted(h)
        low = jdu._pool_shifted(skip)
        up = jnp.repeat(jnp.repeat(low, 2, axis=1), 2, axis=2)
        got = torch.cat([nchw(up), nchw(skip)], dim=1)
        want = nchw(jnp.concatenate([up, skip], axis=-1))
    else:
        x4 = jbs.rot4_stack(jnp.asarray(dense["x"]))
        got = torch.cat([nchw(h), nchw(x4).to(torch.bfloat16)], dim=1)
        want = nchw(jnp.concatenate([h, x4.astype(h.dtype)], axis=-1))
    assert got.dtype == torch.bfloat16
    assert ulp_stats(got, want) == (0.0, 0.0)


# ---------------------------------------------------------------------------
# Stage 3: the rot4 fold and the two-lane rectangular fold (chained)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(SIZE, SIZE), (SIZE, 2 * SIZE)],
                         ids=["rot4", "rect"])
def test_fold_chained(model, shape):
    """The whole dense U-Net fed one bf16-exact input.  Bound: FOLD_SHARE
    of JAX's own bf16-against-float32 distance.  Rounding drifts through
    the 20 convs (measured 0.51 and 0.56 of it); with the bias or the
    slope rounded as before, 1.01 and 1.09."""
    rng = np.random.RandomState(17)
    x = np.asarray(jnp.asarray(rng.randn(1, *shape, 1) * 2 + 1)
                   .astype(jnp.bfloat16).astype(jnp.float32))
    p = model["trainable"]["model"]["denoise_branch"]
    want, want32 = (jax.jit(lambda p_, x_, cd=cd: jdu.dense_blindspot_unet(
        p_, x_, 2, cdtype=cd))(p, jnp.asarray(x))
        for cd in (jnp.bfloat16, jnp.float32))
    with torch.no_grad():
        got = dense_blindspot_unet(model["port"].model.denoise_branch,
                                   _t(x))
    assert got.dtype == torch.float32
    d_port = rel_l2(got, _t(want))
    d_jax = rel_l2(_t(want), _t(want32))
    print(f"fold {shape}: port bf16 vs JAX bf16 {d_port:.2e}, "
          f"JAX bf16 vs f32 {d_jax:.2e}")
    assert d_port <= FOLD_SHARE * d_jax, (d_port, d_jax)


# ---------------------------------------------------------------------------
# Stage 4: the head's 1x1 chain, float32 out
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", HEAD)
def test_head(model, dense, name):
    unet = model["port"].model.denoise_branch
    unet32 = model["port32"].model.denoise_branch
    head_in = {"out_block_conv0": jbs.rot4_unstack(dense["backbone"]),
               "out_block_conv1": dense["leaky"][-2][1],
               "out_conv": dense["leaky"][-1][1]}[name]
    with torch.no_grad():
        if name == "out_conv":
            got = nhwc(unet.out_conv(nchw(head_in)).float())
            got32 = nhwc(unet32.out_conv(nchw(head_in)).float())
            want = _t(dense["out_stats"])
            assert got.dtype == want.dtype == torch.float32
            # The head rounds to bf16 before its float32 cast.
            got, want = got.bfloat16(), want.bfloat16()
            assert (got.float() == nhwc(unet.out_conv(nchw(head_in))).float()
                    ).all()
        else:
            got = nhwc(unet._conv(name, nchw(head_in)))
            got32 = nhwc(unet32._conv(name, nchw(head_in)))
            y, out = dense["leaky"][-2 if name.endswith("0") else -1]
            want = _t(out)
    pre = want if name == "out_conv" else _t(y)
    bias = getattr(unet, name).conv.bias
    assert_stage(f"head {name}", got, want, got32, conv_scale(pre, bias, -1))


# ---------------------------------------------------------------------------
# Stage 5: the sample, and the dtype that reaches the detector
# ---------------------------------------------------------------------------

def test_sample_exact(model, dense):
    (_, z, _), = dense["det"][("detector",)]
    got = model["port"].model.sample(_t(dense["out_stats"]),
                                     eps=_t(dense["eps"]))
    assert got.dtype == torch.float32 and z.dtype == jnp.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(z))


# ---------------------------------------------------------------------------
# Stage 6: the detector, module by module (dense eval and train mode)
# ---------------------------------------------------------------------------

def _det_cases():
    cases = ["input_bn"]
    for blk in DET_BLOCKS:
        if blk in ("layer0", "layer4"):
            cases += [f"{blk}/conv", f"{blk}/bn", f"{blk}/relu"]
        else:
            cases += [f"{blk}/conv0", f"{blk}/bn0", f"{blk}/relu0",
                      f"{blk}/conv1", f"{blk}/add", f"{blk}/bn1",
                      f"{blk}/relu1"]
            if blk == "layer2":
                cases.append(f"{blk}/proj")
    return cases + ["classifier"]


def _det_case(den, recs, case, train):
    """(got, want, got32-or-None) of one detector module, fed its flax
    input."""
    det = den.model.detector
    parts = case.split("/")
    if case == "input_bn":
        path = ("detector", "input_bn")
    elif case == "classifier":
        path = ("detector", "classifier", "classifier")
    else:
        path = ("detector", "features", *parts)
    blk = None if len(parts) == 1 else det.features.get_submodule(parts[0])

    def rec(p):
        (mod, x, y), = recs[p]
        return mod, x, y

    base = ("detector", "features", parts[0])
    op = parts[-1]
    if op.startswith("relu"):
        # relu(bn out) is the next conv's input; a block's last relu is
        # the block's output.
        _, _, bn_out = rec(base + ("bn" + op[4:],))
        if op in ("relu", "relu1"):
            _, _, want = rec(base)
        else:
            _, want, _ = rec(base + ("conv1",))
        return torch.relu(nchw(bn_out)), nchw(want), None
    if op == "add":
        _, _, conv1 = rec(base + ("conv1",))
        _, bn1_in, _ = rec(base + ("bn1",))
        if blk.proj is not None:
            _, _, skip = rec(base + ("proj",))
        else:
            (_, x, _), = recs[base]
            e = blk.dense_factor * (1 + blk.dilation) if not train else \
                1 + blk.dilation
            skip = x[:, e:-e, e:-e, :]
        return nchw(conv1) + nchw(skip), nchw(bn1_in), None
    mod, x, y = rec(path)
    sub = den.model.get_submodule(".".join(path))
    if isinstance(sub, torch.nn.BatchNorm2d):
        bn = copy.deepcopy(sub).train(train)
        with torch.no_grad():
            got = tresnet.batch_norm(nchw(x), bn, den.compute_dtype)
        return got, nchw(y), None
    dt = den.compute_dtype if mod.dtype is not None else None

    def first(v):
        return v[0] if isinstance(v, (tuple, list)) else (v or 1)

    with torch.no_grad():
        got = tbs.conv2d(nchw(x), sub, dt, stride=first(mod.strides),
                         dilation=first(mod.kernel_dilation))
    return got, nchw(y), None


@pytest.mark.parametrize("case", _det_cases())
@pytest.mark.parametrize("mode", ["dense", "train"])
def test_detector(model, dense, train_recs, case, mode):
    recs = dense["det"] if mode == "dense" else train_recs
    got, want, _ = _det_case(model["port"], recs, case, mode == "train")
    assert got.dtype == want.dtype, (case, got.dtype, want.dtype)
    if got.dtype == torch.float32:  # the classifier: a float32 conv
        print(f"{mode} {case}: rel L2 {rel_l2(got, want):.2e}")
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL_F32,
                                   atol=RTOL_F32 * float(want.abs().max()))
    else:
        assert_stage(f"{mode} {case}", got, want)


def test_dense_logits_dtype(model, dense):
    """The dense detector hands back float32 logits in both packages."""
    with torch.no_grad():
        _, logits = model["port"]._apply_model(_t(dense["x"]),
                                               eps=_t(dense["eps"]))
    assert logits.dtype == torch.float32 == _t(dense["logits"]).dtype
    assert logits.shape == tuple(dense["logits"].shape)


# ---------------------------------------------------------------------------
# Stage 7: the clamped sigmoid and the heatmap handed to NMS (exact)
# ---------------------------------------------------------------------------

def test_clamped_sigmoid_heatmap_exact(dense):
    logits = dense["logits"]
    got = losses.clamped_sigmoid(_t(logits))
    want = np.asarray(jlosses.clamped_sigmoid(logits))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    # XLA's logistic and torch's sigmoid round differently: 1 float32 ulp
    # apart in ~0.5% of elements.
    np.testing.assert_array_max_ulp(got.numpy(), want, maxulp=1)
    # The evaluator's score map: the first image's channel 0, cropped.
    assert got[0, :50, :60, 0].shape == want[0, :50, :60, 0].shape


# ---------------------------------------------------------------------------
# Stage 8: the `var` sigma U-Net (plain convs, 3 levels)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sigma():
    jnet = JUNet(in_channels=1, out_channels=1, blindspot=False, levels=3,
                 dtype=jnp.bfloat16)
    rng = np.random.RandomState(19)
    x = (rng.randn(2, SIZE, SIZE, 1) * 2 + 1).astype(np.float32)
    params = jax.jit(lambda: jnet.init(jax.random.PRNGKey(1),
                                       jnp.asarray(x)))()["params"]
    params = perturb(params, rng)
    states = weights.flax_to_state({"sigma": params}, {})
    ports = {}
    for name, dt in (("bf16", torch.bfloat16), ("f32", None)):
        net = BlindspotUNet(1, 1, blindspot=False, levels=3, dtype=dt)
        net.load_state_dict(states["sigma"])
        ports[name] = net.eval()
    out, recs = record(jnet.apply, {"params": params}, jnp.asarray(x))
    return dict(recs=recs, out=out, port=ports["bf16"], port32=ports["f32"])


@pytest.mark.parametrize("name", SIGMA_CONVS)
def test_sigma_unet_stage(sigma, name):
    (_, x, y), = sigma["recs"][(name,)]
    with torch.no_grad():
        m, m32 = getattr(sigma["port"], name), getattr(sigma["port32"], name)
        if name == "out_conv":
            got, got32, want = m(nchw(x)), m32(nchw(x)), nchw(y)
        else:
            got = tbs.leaky_relu(m(nchw(x)))
            got32 = tbs.leaky_relu(m32(nchw(x)))
            want = nchw(jbs.leaky_relu(y))
    assert_stage(f"sigma {name}", got, want, got32,
                 conv_scale(nchw(y), m.conv.bias, 1))


# ---------------------------------------------------------------------------
# Stage 9: one bf16 joint train step (batch 4, 64^2)
# ---------------------------------------------------------------------------

def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree, np.float32)


@pytest.fixture(scope="module")
def step(model):
    """The folded flip-TTA joint step of both packages in bf16, and of JAX
    in float32, on the same weights, crops, labels and draws."""
    rng = np.random.RandomState(23)
    inp = rng.rand(B_TRAIN, SIZE, SIZE, 1).astype(np.float32)
    eps = rng.randn(2 * B_TRAIN, SIZE, SIZE, 1).astype(np.float32)
    batch = {"inp": jnp.asarray(inp), "target": jnp.asarray(TARGET)}
    key = jax.random.PRNGKey(FLIP_KEY)
    _, k_flip, _ = jax.random.split(key, 3)
    flip_p = float(jax.random.uniform(k_flip))

    def jax_step(jden):
        def loss_fn(tr):
            with Fixed([eps]):
                return jden.joint_pipeline(tr, model["static"], batch, key,
                                           ALPHA, TAU, train=True)
        (loss, (outs, _)), grads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(model["trainable"])
        return dict(outs={k: np.asarray(v) for k, v in outs.items()},
                    dtypes={k: str(v.dtype) for k, v in outs.items()},
                    grads=dict(_leaves(grads)))

    j16, j32 = jax_step(model["jax16"]), jax_step(model["jax32"])
    c16, _ = cfgs("bf16")
    den = Denoiser(c16, device="cpu", fold_tta=True)
    den.load_variables(model["trainable"], model["static"])
    den.train()
    dtypes = {}
    def hook(name):
        def note(module, args, out):
            if isinstance(out, torch.Tensor):
                dtypes.setdefault(name, str(out.dtype))
        return note

    hooks = [m.register_forward_hook(hook(n))
             for n, m in den.model.named_modules() if n]
    t_loss, t_outs = den.joint_train_pipeline(
        {"inp": torch.from_numpy(inp), "target": torch.from_numpy(TARGET)},
        ALPHA, TAU, eps=torch.from_numpy(eps), flip_p=torch.tensor(flip_p))
    for h in hooks:
        h.remove()
    t_loss.backward()
    t_grads = dict(_leaves(weights.named_to_flax(
        (g, k, t.grad) for g, k, t in den.named_trainable())))
    return dict(j16=j16, j32=j32, port_outs=t_outs, port_grads=t_grads,
                port_dtypes=dtypes)


LOSS_TERMS = [(PipelineOutput.LOSS, JPO.LOSS),
              (PipelineOutput.DENOISE_LOSS, JPO.DENOISE_LOSS),
              (PipelineOutput.DETECT_LOSS, JPO.DETECT_LOSS),
              (PipelineOutput.AUG_LOSS, JPO.AUG_LOSS),
              (PipelineOutput.DETECT, JPO.DETECT),
              (PipelineOutput.IMG_MU, JPO.IMG_MU)]


@pytest.mark.parametrize("term", LOSS_TERMS, ids=lambda t: t[0].name)
def test_step_loss_terms(step, term):
    """Each term within STEP_SHARE of JAX's own bf16-vs-float32 distance."""
    tk, jk = term
    got = step["port_outs"][tk].detach().double().numpy()
    want, want32 = step["j16"]["outs"][jk], step["j32"]["outs"][jk]
    d_port = float(np.linalg.norm(got - want))
    d_jax = float(np.linalg.norm(want - want32))
    bound = STEP_SHARE * d_jax
    if tk == PipelineOutput.AUG_LOSS:
        # mean((p - p_f)^2) over B crops squares a difference of two
        # detector outputs, so it is bounded through them: |d AUG| <= (2 /
        # B) ||p - p_f|| (||dp|| + ||dp_f||), each output within STEP_SHARE
        # of JAX's bf16-vs-f32 distance of the detector output (DETECT).
        d_det = float(np.linalg.norm(step["j16"]["outs"][JPO.DETECT]
                                     - step["j32"]["outs"][JPO.DETECT]))
        bound = 4 * np.sqrt(float(want) / B_TRAIN) * STEP_SHARE * d_det
    print(f"step {tk.name}: port vs JAX bf16 {d_port:.3e}, "
          f"JAX bf16 vs f32 {d_jax:.3e}, bound {bound:.3e}")
    assert d_port <= bound, (tk, d_port, bound)


def test_step_gradients(step):
    """Every leaf's gradient: ||port - JAX bf16|| <= STEP_SHARE * ||JAX
    bf16 - JAX f32|| (relative L2 on both sides, the same leaf norm)."""
    want, want32 = step["j16"]["grads"], step["j32"]["grads"]
    got = step["port_grads"]
    assert got.keys() == want.keys()
    worst = 0.0
    for name, w in want.items():
        d_port = float(np.linalg.norm(got[name] - w))
        d_jax = float(np.linalg.norm(w - want32[name]))
        worst = max(worst, d_port / max(d_jax, 1e-30))
        assert d_port <= STEP_SHARE * d_jax, (name, d_port, d_jax)
    print(f"step gradients: largest port/JAX-bf16-vs-f32 share {worst:.2f}")


def test_step_dtype_table(step, train_recs):
    """The dtype of every intermediate both packages expose: the pipeline
    outputs, and each module output the two share by path."""
    want = {tk.name: step["j16"]["dtypes"][jk] for tk, jk in LOSS_TERMS}
    got = {tk.name: str(step["port_outs"][tk].dtype).replace("torch.", "")
           for tk, _ in LOSS_TERMS}
    assert got == want
    flax = {".".join(p): str(r[0][2].dtype) for p, r in train_recs.items()
            if hasattr(r[0][2], "dtype")}
    port = {n: d.replace("torch.", "") for n, d in step["port_dtypes"].items()}
    shared = sorted(flax.keys() & port.keys())
    assert len(shared) >= len(U_CONVS) + len(HEAD) + len(DET_BLOCKS)
    table = {n: (port[n], flax[n]) for n in shared}
    for n, (p, f) in table.items():
        print(f"dtype {n}: port {p}, JAX {f}")
    assert all(p == f for p, f in table.values()), table
