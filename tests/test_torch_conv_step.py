"""The U-Net's conv step on the channels-last route (`models/unet.py`
`backbone_cl`/`head_cl`, `ops/conv_epilogue.py`) against the NCHW route.

The epilogue's plain version is held bit for bit to the port's two-op chain
(`models/blindspot.py:conv2d`'s bf16 bias add, `leaky_relu`, then the next
`ShiftConv`'s pad) fed the same conv.  The whole dense fold (rot4 and
two-lane) and the sigma net's forward on the channels-last route are held
to the NCHW route.  On the CPU the one difference is the zero channels
that widen dec_final_conv0's input (97 -> 128): oneDNN groups that conv's
float32 sums otherwise, each rounded once to bf16 (on the card it is
cuDNN's choice of kernel for a channels-last input; `chip_smoke.py` phase
17).  Bound: ROUTE_SHARE of the NCHW route's own bf16-against-float32
distance (relative L2) on the same input; measured 0.18 (fold) and 0.03
(sigma net), with 12% and 0.5% of the outputs apart.  The route predicate
(gradients off and bf16) and the counters ``conv.fused`` / ``conv.plain``
are checked too.
The file imports nothing of JAX; its ``cuda`` tests run on the card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_conv_step.py -q
"""

from pathlib import Path
from unittest import mock

import pytest
import torch
import torch.nn.functional as F

from spr_pick_tpu_torch.models import blindspot as bs
from spr_pick_tpu_torch.models.unet import BlindspotUNet
from spr_pick_tpu_torch.ops import conv_epilogue as ce
from spr_pick_tpu_torch.ops.dense_unet import dense_blindspot_unet
from spr_pick_tpu_torch.utils import profiling

BF16 = torch.bfloat16
SLOPE = bs._slope_in(0.1, BF16)
ROUTE_SHARE = 0.25
PADS = {"blindspot": (2, 0, 1, 1), "symmetric": (1, 1, 1, 1),
        "none": (0, 0, 0, 0)}


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two intra-op threads: beside five other test workers on the same
    cores, torch's default of one thread a core oversubscribes them (this
    file took 147 s instead of 5, and starved the gloo ranks of
    tests/test_torch_ddp.py past their time limit)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int16)


def _net(blindspot: bool, levels: int, out_channels: int, seed: int,
         dtype=BF16) -> BlindspotUNet:
    """A seeded U-Net at the published widths with nonzero biases."""
    g = torch.Generator().manual_seed(seed)
    net = BlindspotUNet(1, out_channels, blindspot=blindspot, levels=levels,
                        dtype=dtype)
    net.reset_parameters(g)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.Conv2d):
                m.bias.copy_(0.2 * torch.randn(m.bias.shape, generator=g))
    return net.eval()


def _delta(names=("conv.fused", "conv.plain")):
    before = profiling.counters()

    def done():
        now = profiling.counters()
        return {n: now.get(n, 0) - before.get(n, 0) for n in names}
    return done


# ---------------------------------------------------------------------------
# The epilogue's plain version against the two-op chain
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("channels", [48, 96, 384])
@pytest.mark.parametrize("act", [True, False], ids=["leaky", "bias_only"])
@pytest.mark.parametrize("k", [3, 1])
@pytest.mark.parametrize("pad", sorted(PADS))
def test_plain_epilogue_is_the_chain(pad, k, act, channels):
    """A conv with ``k`` taps (bf16), then today's `conv2d` bias add and
    LeakyReLU and the consumer's `F.pad`, against the same conv's output
    through `conv_epilogue_plain`: bit for bit."""
    g = torch.Generator().manual_seed(channels + 7 * k)
    conv = torch.nn.Conv2d(16, channels, k)
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=g) * 0.3)
        conv.bias.copy_(torch.randn(channels, generator=g))
    x = torch.randn(2, 16, 9 + k, 11 + k, generator=g)
    top, bottom, left, right = PADS[pad]
    want = bs.conv2d(x, conv, BF16)
    if act:
        want = bs.leaky_relu(want)
    want = F.pad(want, (left, right, top, bottom)).permute(0, 2, 3, 1)
    y = F.conv2d(x.to(BF16), conv.weight.to(BF16)).permute(0, 2, 3, 1)
    got = ce.conv_epilogue(y, conv.bias.to(BF16), PADS[pad],
                           SLOPE if act else None)
    assert got.dtype == BF16 and got.is_contiguous()
    assert got.shape == want.shape
    assert torch.equal(_bits(got), _bits(want))


def test_plain_bias_f32_is_the_last_conv():
    """The channels-last head's last conv (96 -> out, its bias added in
    plain PyTorch, float32 out) and the whole 1x1 chain before it are the
    NCHW head's `conv2d` bf16 bias add, then float32, bit for bit."""
    g = torch.Generator().manual_seed(3)
    net = _net(True, 3, 2, seed=3)
    with torch.no_grad():
        net.out_conv.conv.bias.fill_(0.37)
        h = torch.randn(2, 8, 12, 4 * 96, generator=g).to(BF16)
        got = net.head_cl(h)
        want = net.head(h.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.dtype == torch.float32 and torch.equal(got, want)


@pytest.mark.parametrize("channels", [48, 96, 384])
def test_plain_epilogue_rounds_a_float32_bias(channels):
    """The epilogue takes the layer's float32 bias and rounds it to bf16
    as `conv2d` casts it: the same bits as the bias cast first."""
    g = torch.Generator().manual_seed(channels)
    y = (torch.randn(2, 5, 7, channels, generator=g) * 3).to(BF16)
    b = torch.randn(channels, generator=g) / 3  # not bf16 values
    assert not torch.equal(b, b.to(BF16).float())
    for slope in (SLOPE, None):
        got = ce.conv_epilogue(y, b, PADS["blindspot"], slope)
        want = ce.conv_epilogue(y, b.to(BF16), PADS["blindspot"], slope)
        assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("case", ["dtype", "bias_width", "bias_dtype",
                                  "negative_pad", "short_pad"])
def test_epilogue_rejects_bad_arguments(case):
    y = torch.zeros(1, 4, 4, 48, dtype=BF16)
    b = torch.zeros(48, dtype=BF16)
    pad = (0, 0, 0, 0)
    if case == "dtype":
        y = y.float()
    elif case == "bias_width":
        b = b[:40]
    elif case == "bias_dtype":
        b = b.half()
    elif case == "negative_pad":
        pad = (-1, 0, 0, 0)
    else:
        pad = (1, 1)
    err = ValueError if "pad" in case else TypeError
    with pytest.raises(err):
        ce.conv_epilogue(y, b, pad, SLOPE)


@pytest.mark.parametrize("case", ["width", "strided_pixels", "cpu"])
def test_kernel_wrapper_rejects_what_the_kernel_cannot_read(case):
    """The kernel takes 8-channel groups that divide its block, pixels
    and channels contiguous, and CUDA tensors; the wrapper raises first."""
    c = 40 if case == "width" else 48
    y = torch.zeros(1, 4, 6, c, dtype=BF16)
    b = torch.zeros(c, dtype=BF16)
    if case == "strided_pixels":
        y = torch.zeros(1, 4, 12, c, dtype=BF16)[:, :, ::2]
    if case == "cpu":
        with pytest.raises(ValueError, match="CUDA"):
            ce.conv_epilogue_cuda.epilogue(y, b, ce.NO_PAD, SLOPE)
        return
    with pytest.raises(ValueError):
        ce._check_kernel_layout(y, b)


def test_epilogue_library_load_is_a_span(monkeypatch):
    """The epilogue's library loads once, as span ``spr.conv.load``."""
    lib = ce._Library()
    monkeypatch.setattr(lib, "build", lambda: (Path("libspr_conv.so"), True))
    monkeypatch.setattr(ce.ctypes, "CDLL", lambda path: mock.Mock())
    first = lib.get()
    assert lib.get() is first
    loads = [r for r in profiling.spans() if r.name == "spr.conv.load"]
    assert loads and loads[-1].attrs == {"built": True}


# ---------------------------------------------------------------------------
# The whole route against the NCHW route
# ---------------------------------------------------------------------------

def _nchw_route(net: BlindspotUNet, x: torch.Tensor,
                rect: bool = False) -> torch.Tensor:
    """Today's NCHW route, called directly (the route predicate aside)."""
    xc = x.permute(0, 3, 1, 2)
    if not net.blindspot:
        return net.head(net.backbone(xc)).permute(0, 2, 3, 1)
    if not rect:
        return net.head(net.rot4_fold(xc)).permute(0, 2, 3, 1)
    with torch.enable_grad():  # the fold's own NCHW route
        return dense_blindspot_unet(net, x, force_rect=True).detach()


@pytest.mark.parametrize("case", ["rot4", "rect", "rect_input",
                                  "module_forward", "sigma"])
def test_channels_last_route_matches_nchw_route(case):
    """The dense fold (rot4, the two-lane fold forced and on a rectangle),
    the blind-spot module's own forward and the sigma net's forward: the
    channels-last route within ROUTE_SHARE of the NCHW route's bf16
    rounding, and its conv steps counted in ``conv.fused`` once a
    forward."""
    sigma = case == "sigma"
    shape = (1, 64, 96, 1) if case == "rect_input" else (2, 64, 64, 1)
    x = torch.randn(shape, generator=torch.Generator().manual_seed(5))
    rect = case in ("rect", "rect_input")
    with torch.no_grad():
        want32 = _nchw_route(_net(not sigma, 3 if sigma else 5,
                                  1 if sigma else 2, seed=11, dtype=None),
                             x, rect)
        net = _net(not sigma, 3 if sigma else 5, 1 if sigma else 2, seed=11)
        want = _nchw_route(net, x, rect)
        counted = _delta()
        if case in ("module_forward", "sigma"):
            got = net(x)
        else:
            got = dense_blindspot_unet(net, x, force_rect=case == "rect")
        counts = counted()
    assert got.dtype == torch.float32 and got.shape == want.shape
    gap = float((got - want).norm() / want.norm())
    bf16 = float((want - want32).norm() / want32.norm())
    assert gap <= ROUTE_SHARE * bf16, (gap, bf16)
    steps = {"rect": 37, "rect_input": 37, "sigma": 14}.get(case, 20)
    assert counts == {"conv.fused": steps, "conv.plain": 0}


def test_counters_land_on_the_root_span():
    """One fold and one sigma-net forward under one root span: the
    counters of both forwards (their conv steps and the destinations their
    launches wrote) are the root's attributes."""
    fold, sigma = _net(True, 5, 2, seed=1), _net(False, 3, 1, seed=2)
    x = torch.rand(1, 32, 32, 1)
    with torch.inference_mode():
        with profiling.span("test.conv.root"):
            dense_blindspot_unet(fold, x)
            sigma(x)
    root = [r for r in profiling.spans() if r.name == "test.conv.root"][-1]
    assert root.attrs == {"conv.fused": 34, "conv.plain": 0,
                          "fold.direct": 42}


@pytest.mark.parametrize("case", ["grad", "float32"])
def test_route_predicate(monkeypatch, case):
    """With gradients on (training), or in float32, the forward takes the
    NCHW route: the epilogue never runs.  A training forward counts
    nothing; a float32 inference counts its steps in ``conv.plain``."""
    def refuse(*a, **k):
        raise AssertionError("the epilogue ran")

    import spr_pick_tpu_torch.models.unet as unet_mod
    monkeypatch.setattr(unet_mod, "conv_epilogue", refuse)
    dtype = BF16 if case == "grad" else None
    net = _net(True, 5, 2, seed=4, dtype=dtype)
    x = torch.rand(1, 32, 32, 1)
    counted = _delta()
    if case == "grad":
        out = net(x)
        assert out.requires_grad
        out.sum().backward()
        assert net.enc1_conv0.conv.weight.grad is not None
        assert counted() == {"conv.fused": 0, "conv.plain": 0}
    else:
        with torch.inference_mode():
            net(x)
            dense_blindspot_unet(net, x)
        assert counted() == {"conv.fused": 0, "conv.plain": 40}


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the conv epilogue is a CUDA kernel "
                    "with no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("pad", sorted(PADS))
@pytest.mark.parametrize("channels", [48, 96, 384])
def test_kernel_equals_plain_version(cuda, pad, channels):
    g = torch.Generator(device=cuda).manual_seed(channels)
    y = (torch.randn(2, 40, 56, channels, device=cuda, generator=g) * 3
         ).to(BF16)
    b32 = torch.randn(channels, device=cuda, generator=g)  # the layer's
    for b in (b32, b32.to(BF16)):
        for slope in (SLOPE, None):
            before = ce.conv_epilogue_cuda.launches
            got = ce.conv_epilogue(y, b, PADS[pad], slope)
            torch.cuda.synchronize()
            assert ce.conv_epilogue_cuda.launches == before + 1
            want = ce.conv_epilogue_plain(y, b, PADS[pad], slope)
            assert torch.equal(_bits(got), _bits(want))


@pytest.mark.cuda
def test_route_on_the_card_runs_no_layout_kernel(cuda):
    from torch.profiler import ProfilerActivity, profile

    net = _net(True, 5, 2, seed=6).to(cuda)
    x = torch.rand(1, 128, 128, 1, device=cuda)
    with torch.inference_mode():
        dense_blindspot_unet(net, x)
        before = ce.conv_epilogue_cuda.launches
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            dense_blindspot_unet(net, x)
            torch.cuda.synchronize()
    # One launch a conv step of the fold's 20 but the last conv's.
    assert ce.conv_epilogue_cuda.launches == before + 19
    names = {e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA}
    assert not [n for n in names if "nchwToNhwc" in n or "nhwcToNchw" in n]
    assert any("conv_epilogue_kernel" in n for n in names)
