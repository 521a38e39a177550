"""The U-Net fold's hand-offs written in place (`models/unet.py`
`_backbone_cl`, `ops/conv_epilogue.py`) against the staged composition it
replaced: each conv step's epilogue writing a padded buffer of its own
width, then `shift_down`, `F.max_pool2d`, the upsample's broadcast copy,
`_padded_cat`'s copies into fresh padded buffers and
`rot4_stack`/`rot4_unstack` as passes of their own (`staged_backbone`
below, the route as it was).

The direct route must give the staged route's bits: every value it moves
is an exact copy, a max or a rotation, and the convs read buffers of the
same shapes.  Held here on the CPU (plain versions) for the square rot4
fold of a 5-level blind-spot U-Net, the rectangular two-lane fold and the
plain 3-level sigma net, with every new buffer filled with NaN first so an
element no producer writes shows; each destination's plain version against
the staged ops; the pool's scan (the kernel's rule) against `F.max_pool2d`
on +0/-0/NaN ties; and the counters ``fold.direct``/``fold.staged``.
The file imports nothing of JAX; its ``cuda`` tests (each destination of
the kernel against its plain version at the U-Net's widths, the whole fold
at 1024^2 and at a 1216^2 window against the staged route) run on the card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_fold_direct.py -q
"""

import contextlib
from typing import List

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
P3 = {True: (2, 0, 1, 1), False: (1, 1, 1, 1)}  # BlindspotUNet.pad3
COUNTERS = ("fold.direct", "fold.staged")


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two intra-op threads beside the other test workers (as in
    tests/test_torch_conv_step.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int16)


def _net(blindspot: bool, levels: int, out_channels: int, seed: int,
         device="cpu", dtype=BF16) -> BlindspotUNet:
    """A seeded U-Net at the published widths with nonzero biases."""
    g = torch.Generator().manual_seed(seed)
    net = BlindspotUNet(1, out_channels, blindspot=blindspot, levels=levels,
                        dtype=dtype)
    net.reset_parameters(g)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.Conv2d):
                m.bias.copy_(0.2 * torch.randn(m.bias.shape, generator=g))
    return net.to(device).eval()


# ---------------------------------------------------------------------------
# The staged route, as the channels-last route ran before its hand-offs were
# written in place
# ---------------------------------------------------------------------------

def padded_cat(parts: List[torch.Tensor], pad, multiple: int = 1
               ) -> torch.Tensor:
    """The channel concatenation of NHWC ``parts``, cast to bf16, inside a
    zero pad; zero channels after the parts up to a multiple of
    ``multiple``."""
    n, h, w = parts[0].shape[:3]
    c = sum(p.shape[3] for p in parts)
    cp = -(-c // multiple) * multiple
    top, bottom, left, right = pad
    buf = torch.empty((n, h + top + bottom, w + left + right, cp),
                      dtype=BF16, device=parts[0].device)
    buf[:, :top].zero_()
    buf[:, top + h:].zero_()
    inner = buf[:, top:top + h]
    inner[:, :, :left].zero_()
    inner[:, :, left + w:].zero_()
    inner = inner[:, :, left:left + w]
    inner[..., c:].zero_()
    at = 0
    for p in parts:
        inner[..., at:at + p.shape[3]].copy_(p)
        at += p.shape[3]
    return buf


def upsample(h: torch.Tensor) -> torch.Tensor:
    n, hh, ww, c = h.shape
    return h[:, :, None, :, None, :].expand(n, hh, 2, ww, 2, c).reshape(
        n, 2 * hh, 2 * ww, c)


def staged_backbone(net: BlindspotUNet, x: torch.Tensor,
                    widen: bool = True) -> torch.Tensor:
    """`backbone_cl` as it was: each epilogue writes its own buffer, every
    hand-off a pass of its own.  ``widen``: the input channels widened to
    8 and 128 (False: not, for a card reading of what that changes)."""
    p3, no_pad = net.pad3, ce.NO_PAD
    many = (lambda m: m) if widen else (lambda m: 1)

    def step(name, xp, pad):
        return net._step_cl(name, xp, pad)

    def pool(h):
        if net.blindspot:
            h = bs.shift_down(h, 1, h_dim=1)
        return F.max_pool2d(h.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)

    skips = []
    h = step("enc1_conv0", padded_cat([x], p3, many(8)), p3)
    h = pool(step("enc1_conv1", h, no_pad))
    skips.append(h)
    for i in range(2, net.levels + 1):
        h = pool(step(f"enc{i}_conv0", padded_cat([h], p3), no_pad))
        skips.append(h)
    h = step("enc_bottom_conv0", padded_cat([h], p3), no_pad)
    h = upsample(h)
    for stage, skip in enumerate(reversed(skips[:-1])):
        h = step(f"dec{stage}_conv0", padded_cat([h, skip], p3), p3)
        h = upsample(step(f"dec{stage}_conv1", h, no_pad))
    h = step("dec_final_conv0", padded_cat([h, x], p3, many(32)), p3)
    h = step("dec_final_conv1", h, no_pad)
    if net.blindspot:
        h = bs.shift_down(h, 1, h_dim=1)
    return h


@contextlib.contextmanager
def staged(net: BlindspotUNet, widen: bool = True):
    """``net``'s channels-last backbone and rot4 fold on the staged route
    (instance attributes over the methods, removed on exit)."""
    net.backbone_cl = lambda x: staged_backbone(net, x, widen)
    net.rot4_fold_cl = lambda x: bs.rot4_unstack(
        staged_backbone(net, bs.rot4_stack(x), widen))
    try:
        yield net
    finally:
        del net.backbone_cl, net.rot4_fold_cl


def forward(net: BlindspotUNet, x: torch.Tensor, case: str):
    """The backbone's (fold's) bf16 output and the float32 output."""
    with torch.inference_mode():
        if case == "sigma":
            return net.backbone_cl(x), net(x)
        if case == "rot4":
            return net.rot4_fold_cl(x), dense_blindspot_unet(net, x)
        lanes = torch.cat([x, bs.rotate(x, 180)], dim=0)
        return (net.backbone_cl(lanes),
                dense_blindspot_unet(net, x, force_rect=case == "rect"))


@contextlib.contextmanager
def nan_filled_buffers():
    """Every `torch.empty` filled with NaN, so an element that no producer
    writes shows in the output."""
    empty = torch.empty

    def nan_empty(*size, **kw):
        if len(size) == 1 and not isinstance(size[0], int):
            size = size[0]
        return torch.full(size, float("nan"), **kw)

    torch.empty = nan_empty
    try:
        yield
    finally:
        torch.empty = empty


# ---------------------------------------------------------------------------
# On the CPU: the whole route
# ---------------------------------------------------------------------------

CASES = {"rot4": (True, 5, 2, (2, 64, 64, 1)),
         "rect": (True, 5, 2, (1, 64, 64, 1)),
         "rect_input": (True, 5, 2, (1, 64, 96, 1)),
         "sigma": (False, 3, 1, (2, 32, 48, 1))}


@pytest.mark.parametrize("case", sorted(CASES))
def test_direct_route_is_the_staged_route(case):
    """The square rot4 fold of a 5-level blind-spot U-Net, the two-lane
    fold (forced on a square and on a rectangle) and the plain 3-level
    sigma net: the direct route's backbone output and final output equal
    the staged route's bit for bit, with every new buffer NaN first."""
    blindspot, levels, out_channels, shape = CASES[case]
    net = _net(blindspot, levels, out_channels, seed=21)
    x = torch.randn(shape, generator=torch.Generator().manual_seed(22))
    with nan_filled_buffers():
        got = forward(net, x, case)
        with staged(net):
            want = forward(net, x, case)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert not torch.isnan(g).any()
        assert torch.equal(_bits(g) if g.dtype == BF16 else g,
                           _bits(w) if w.dtype == BF16 else w)


# ---------------------------------------------------------------------------
# On the CPU: each destination of the plain version
# ---------------------------------------------------------------------------

def _conv_output(n, h, w, c, seed, device="cpu"):
    g = torch.Generator(device=device).manual_seed(seed)
    y = (torch.randn(n, h, w, c, generator=g, device=device) * 3).to(BF16)
    b = torch.randn(c, generator=g, device=device)
    return y, b


def _chain(y, b, slope):
    z = y + b.to(BF16)
    return F.leaky_relu(z, slope) if slope is not None else z


def _sentinel(shape, seed, device="cpu"):
    """A buffer of random values: the slots an epilogue must leave alone
    keep them."""
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=g, device=device).to(BF16)


# (handoff, shift, c, destination channels, with skip slot)
DESTINATIONS = {
    "copy_shift": ("copy", True, 96, 96, None),
    "pool_shift_skip48": ("pool", True, 48, 48, (96, 48)),
    "pool_skip96": ("pool", False, 48, 48, (144, 96)),
    "pool_deepest": ("pool", True, 48, 48, None),
    "upsample48_into96": ("upsample", False, 48, 96, None),
    "upsample96_into144": ("upsample", False, 96, 144, None),
    "upsample96_into128": ("upsample", False, 96, 128, None),
    "unrotate_shift384": ("unrotate", True, 96, 384, None),
}


def _destination_case(name, device="cpu", size=(8, 12, 12)):
    """A conv output, its bias, a sentinel-filled destination and skip
    buffer, and the epilogue's keywords for destination ``name``."""
    handoff, shift, c, dch, skip = DESTINATIONS[name]
    n, h, w = size
    if handoff == "unrotate":
        w = h
    y, b = _conv_output(n, h, w, c, seed=len(name), device=device)
    moved = ce._moved_shape(y, handoff)
    pad = ce.NO_PAD if handoff == "unrotate" else P3[shift]
    out = _sentinel(ce._padded(moved[:3] + (dch,), pad), 1, device)
    kw = dict(handoff=handoff, shift=shift, out=out)
    if skip:
        sbuf = _sentinel(ce._padded(moved[:3] + (skip[0],), P3[shift]), 2,
                         device)
        kw["skip"] = ce.Slot(sbuf, P3[shift], skip[1])
    return y, b, pad, kw


@pytest.mark.parametrize("slope", [SLOPE, None], ids=["leaky", "bias_only"])
@pytest.mark.parametrize("name", sorted(DESTINATIONS))
def test_plain_destination_is_the_staged_ops(name, slope):
    """Each destination of the plain epilogue against the staged ops on
    the same buffers: the values moved by `shift_down`, `F.max_pool2d`,
    the broadcast upsample or `rot4_unstack` in their slot, zeros in the
    border of ``out`` (every channel), the rest of both buffers as it
    was."""
    y, b, pad, kw = _destination_case(name)
    out, skip = kw["out"], kw.get("skip")
    want_out = out.clone()
    want_skip = None if skip is None else skip.buf.clone()
    z = _chain(y, b, slope)
    if kw["shift"]:
        z = bs.shift_down(z, 1, h_dim=1)
    if kw["handoff"] == "pool":
        z = F.max_pool2d(z.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
    elif kw["handoff"] == "upsample":
        z = upsample(z)
    elif kw["handoff"] == "unrotate":
        z = bs.rot4_unstack(z)
    top, bottom, left, right = pad
    h, w = z.shape[1:3]
    border = torch.ones(want_out.shape[1:3], dtype=torch.bool)
    border[top:top + h, left:left + w] = False
    want_out[:, border] = 0
    want_out[:, top:top + h, left:left + w, :z.shape[3]] = z
    if skip is not None:
        st, _, sl, _ = skip.pad
        want_skip[:, st:st + h, sl:sl + w,
                  skip.channel:skip.channel + z.shape[3]] = z
    got = ce.conv_epilogue(y, b, pad, slope, **kw)
    assert got is out
    assert torch.equal(_bits(out), _bits(want_out))
    if skip is not None:
        assert torch.equal(_bits(skip.buf), _bits(want_skip))


@pytest.mark.parametrize("rot4", [True, False], ids=["rot4", "lanes"])
def test_plain_fold_input_is_padded_cat(rot4):
    """The input launch's plain version: the first buffer is
    `padded_cat([rot4_stack(x)], pad, 8)`, and the last stage's buffer gets
    x then zeros in channels [96, 128) of its interior, its other channels
    as they were."""
    x = torch.randn(2, 16, 16, 1, generator=torch.Generator().manual_seed(4))
    lanes = bs.rot4_stack(x) if rot4 else x
    pad = P3[True]
    last = _sentinel(ce._padded((lanes.shape[0], 16, 16, 128), pad), 5)
    want_last = last.clone()
    want_last[:, 2:18, 1:17, 96:] = F.pad(lanes.to(BF16), (0, 31))
    first = ce.fold_input(x, pad, 8, ce.Slot(last, pad, 96), rot4)
    assert torch.equal(_bits(first), _bits(padded_cat([lanes], pad, 8)))
    assert torch.equal(_bits(last), _bits(want_last))


def scan_pool(z: torch.Tensor) -> torch.Tensor:
    """The kernel's pool, written with PyTorch ops: the 2x2 taps in order
    (row 2i: columns 2j, 2j + 1; then row 2i + 1), a tap replacing the
    max where it is greater or NaN, the winner's bits kept."""
    taps = [z[:, r::2, q::2] for r in (0, 1) for q in (0, 1)]
    m = taps[0]
    for t in taps[1:]:
        m = torch.where((t > m) | torch.isnan(t), t, m)
    return m


def _nan_as_one(t: torch.Tensor) -> torch.Tensor:
    """The bits of ``t`` with every NaN as 0x7fc0: PyTorch's CPU kernels
    write a NaN's payload as their vector or scalar conversion does (0xffff
    or 0x7fc0), whatever the input's; the card's keep one pattern."""
    return torch.where(torch.isnan(t), torch.tensor(0x7fc0, dtype=torch.int16),
                       _bits(t))


@pytest.mark.parametrize("shift", [True, False], ids=["shift", "no_shift"])
@pytest.mark.parametrize("slope", [SLOPE, None], ids=["leaky", "bias_only"])
def test_pool_ties_resolve_as_max_pool(shift, slope):
    """+0/-0 and NaN ties (a bias of -0.0 keeps -0 through the add): the
    kernel's scan equals `F.max_pool2d` after the shifted-in +0 row, and
    the plain pooled epilogue equals both, bit for bit but for the payload
    of a NaN (the card's test holds that too)."""
    g = torch.Generator().manual_seed(6)
    values = torch.tensor([0.0, -0.0, float("nan"), 1.0, -1.0, -0.0])
    y = values[torch.randint(0, 6, (2, 8, 10, 48), generator=g)].to(BF16)
    b = torch.full((48,), -0.0)
    z = _chain(y, b, slope)
    if shift:
        z = bs.shift_down(z, 1, h_dim=1)
    want = F.max_pool2d(z.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
    assert torch.equal(_nan_as_one(scan_pool(z)), _nan_as_one(want))
    got = ce.conv_epilogue(y, b, ce.NO_PAD, slope, handoff="pool",
                           shift=shift)
    assert torch.equal(_nan_as_one(got), _nan_as_one(want))
    signs = torch.signbit(want.float()) & (want == 0)
    assert signs.any() and (want == 0).logical_and(~signs).any()
    assert torch.isnan(want).any()


@pytest.mark.parametrize("case", ["handoff", "skip_not_pool", "odd_pool",
                                  "unrotate_lanes", "out_shape",
                                  "out_channels", "skip_shape", "input_rect",
                                  "upsample_shift"])
def test_destinations_reject_bad_arguments(case):
    y = torch.zeros(4, 6, 6, 48, dtype=BF16)
    b = torch.zeros(48)
    kw = {}
    if case == "handoff":
        kw = dict(handoff="transpose")
    elif case == "skip_not_pool":
        kw = dict(skip=ce.Slot(torch.zeros(4, 6, 6, 48, dtype=BF16)))
    elif case == "odd_pool":
        y, kw = y[:, :5], dict(handoff="pool")
    elif case == "unrotate_lanes":
        y, kw = y[:3], dict(handoff="unrotate")
    elif case == "out_shape":
        kw = dict(out=torch.zeros(4, 7, 6, 48, dtype=BF16))
    elif case == "out_channels":
        kw = dict(out=torch.zeros(4, 6, 6, 40, dtype=BF16))
    elif case == "upsample_shift":
        kw = dict(handoff="upsample", shift=True)
    elif case == "skip_shape":
        kw = dict(handoff="pool",
                  skip=ce.Slot(torch.zeros(4, 4, 3, 96, dtype=BF16)))
    else:
        with pytest.raises(ValueError):
            ce.fold_input(torch.zeros(1, 8, 12, 1), P3[True], 8,
                          ce.Slot(torch.zeros(4, 10, 14, 128, dtype=BF16),
                                  P3[True], 96), rot4=True)
        return
    with pytest.raises(ValueError):
        ce.conv_epilogue(y, b, ce.NO_PAD, SLOPE, **kw)


# ---------------------------------------------------------------------------
# The counters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["rot4_and_sigma", "rect", "float32"])
def test_fold_counters_land_on_the_root_span(case):
    """Each destination a launch writes counts in ``fold.direct``: a rot4
    fold's 19 epilogues, 4 skip slots and the input launch's 2, a 3-level
    sigma net's 13, 2 and 2; the two-lane fold's two backbones and head
    (2 x 23 + 2) and its head's input, a PyTorch un-rotation, in
    ``fold.staged``; a float32 forward (NCHW route: each step's input a
    pad's copy) all 20 steps in ``fold.staged``."""
    fold = _net(True, 5, 2, seed=1,
                dtype=None if case == "float32" else BF16)
    x = torch.rand(1, 32, 32, 1)
    name = f"test.fold.{case}"
    with torch.inference_mode():
        with profiling.span(name):
            dense_blindspot_unet(fold, x, force_rect=case == "rect")
            if case == "rot4_and_sigma":
                _net(False, 3, 1, seed=2)(x)
    root = [r for r in profiling.spans() if r.name == name][-1]
    want = {"rot4_and_sigma": (42, 0), "rect": (48, 1), "float32": (0, 20)}
    assert tuple(root.attrs.get(k, 0) for k in COUNTERS) == want[case]


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
@pytest.mark.parametrize("slope", [SLOPE, None], ids=["leaky", "bias_only"])
@pytest.mark.parametrize("name", sorted(DESTINATIONS))
def test_kernel_destination_equals_plain(cuda, name, slope):
    """Each destination of the kernel at the U-Net's widths (48 and 96
    channels moved into 48-, 96-, 144-, 128- and 384-wide buffers) equals
    its plain version on the same sentinel-filled buffers."""
    y, b, pad, kw = _destination_case(name, cuda, size=(8, 40, 56))
    plain_kw = dict(kw, out=kw["out"].clone())
    if "skip" in kw:
        plain_kw["skip"] = kw["skip"]._replace(buf=kw["skip"].buf.clone())
    before = ce.conv_epilogue_cuda.launches
    ce.conv_epilogue(y, b, pad, slope, **kw)
    torch.cuda.synchronize()
    assert ce.conv_epilogue_cuda.launches == before + 1
    ce.conv_epilogue_plain(y, b, pad, slope, **plain_kw)
    assert torch.equal(_bits(kw["out"]), _bits(plain_kw["out"]))
    if "skip" in kw:
        assert torch.equal(_bits(kw["skip"].buf),
                           _bits(plain_kw["skip"].buf))


@pytest.mark.cuda
@pytest.mark.parametrize("shift", [True, False], ids=["shift", "no_shift"])
def test_kernel_pool_ties_equal_max_pool(cuda, shift):
    """+0/-0/NaN ties on the card: the kernel's pool against the staged
    epilogue, `shift_down` and `F.max_pool2d` on the card, bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(7)
    values = torch.tensor([0.0, -0.0, float("nan"), 1.0, -1.0, -0.0],
                          device=cuda)
    y = values[torch.randint(0, 6, (2, 40, 56, 48), generator=g,
                             device=cuda)].to(BF16)
    b = torch.full((48,), -0.0, device=cuda)
    z = ce.conv_epilogue(y, b, ce.NO_PAD, SLOPE)
    if shift:
        z = bs.shift_down(z, 1, h_dim=1)
    want = F.max_pool2d(z.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
    got = ce.conv_epilogue(y, b, P3[shift], SLOPE, handoff="pool",
                           shift=shift)
    top, _, left, _ = P3[shift]
    assert torch.equal(_bits(got[:, top:top + 20, left:left + 28]),
                       _bits(want))


@pytest.mark.cuda
@pytest.mark.parametrize("rot4", [True, False], ids=["rot4", "lanes"])
def test_kernel_fold_input_equals_plain(cuda, rot4):
    g = torch.Generator(device=cuda).manual_seed(8)
    x = torch.randn(2, 48, 48, 1, generator=g, device=cuda)
    n = 8 if rot4 else 2
    last = _sentinel((n, 50, 50, 128), 9, cuda)
    plain_last = last.clone()
    before = ce.conv_epilogue_cuda.inputs
    got = ce.fold_input(x, P3[True], 8, ce.Slot(last, P3[True], 96), rot4)
    torch.cuda.synchronize()
    assert ce.conv_epilogue_cuda.inputs == before + 1
    want = ce.fold_input_plain(x, P3[True], 8,
                               ce.Slot(plain_last, P3[True], 96), rot4)
    assert torch.equal(_bits(got), _bits(want))
    assert torch.equal(_bits(last), _bits(plain_last))


def _garbage_cache(device):
    """Leave NaN in the caching allocator's free blocks, so a buffer that
    no producer fills shows."""
    junk = torch.full((3 << 30,), float("nan"), dtype=BF16, device=device)
    del junk


@pytest.mark.cuda
@pytest.mark.parametrize("size", [1024, 1216])
def test_fold_on_the_card_equals_the_staged_route(cuda, size):
    """The whole rot4 fold of a 5-level blind-spot U-Net at 1024^2 and at
    a 1216^2 window (and the sigma net at 1024^2): the direct route's
    output equals the staged route's bit for bit, with 19 epilogue
    launches and one input launch a fold."""
    net = _net(True, 5, 2, seed=10, device=cuda)
    x = torch.rand((1, size, size, 1),
                   generator=torch.Generator().manual_seed(11)).to(cuda)
    with torch.inference_mode():
        _garbage_cache(cuda)
        before = (ce.conv_epilogue_cuda.launches, ce.conv_epilogue_cuda.inputs)
        got = dense_blindspot_unet(net, x)
        torch.cuda.synchronize()
        after = (ce.conv_epilogue_cuda.launches, ce.conv_epilogue_cuda.inputs)
        with staged(net):
            want = dense_blindspot_unet(net, x)
        assert (after[0] - before[0], after[1] - before[1]) == (19, 1)
        assert torch.equal(got, want)
        if size == 1024:
            sigma = _net(False, 3, 1, seed=12, device=cuda)
            _garbage_cache(cuda)
            got = sigma(x)
            with staged(sigma):
                want = sigma(x)
            assert torch.equal(got, want)


@pytest.mark.cuda
def test_fold_on_the_card_runs_no_copy_pass(cuda):
    """A direct rot4 fold's trace holds the epilogue and the input launch
    and none of the staged passes: no `torch.cat` copy, max pool, flip or
    cuDNN layout kernel."""
    from torch.profiler import ProfilerActivity, profile

    net = _net(True, 5, 2, seed=13, device=cuda)
    x = torch.rand(1, 256, 256, 1, device=cuda)
    with torch.inference_mode():
        dense_blindspot_unet(net, x)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            dense_blindspot_unet(net, x)
            torch.cuda.synchronize()
    names = {e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA}
    staged_kernels = [n for n in names if any(
        k in n for k in ("CatArrayBatchedCopy", "max_pool", "flip",
                         "index_elementwise", "nchwToNhwc", "nhwcToNchw"))]
    assert not staged_kernels
    assert any("conv_epilogue_kernel" in n for n in names)
    assert any("fold_input_kernel" in n for n in names)
