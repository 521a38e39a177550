"""The operation and byte counts against hand counts at small shapes."""

import torch
import torch.nn.functional as F

from gpubench.counts import convs, dn_ssdn, joint_r8
from gpubench.reference import model as ref

MODEL = dict(levels=5, enc_features=48, dec_features=96, in_channels=1,
             out_channels=2, detector="resnet8", detector_units=[32, 64, 128],
             estimated_sigma_raw=4.5413)


def test_unet_lane_by_hand_at_32():
    # 32^2: enc1 two convs at 1024 px, enc2..5 at 256, 64, 16, 4, the
    # bottom at 1; decoder stages at 4, 16, 64, 256; the final pair at 1024.
    px = 32 * 32
    want = (2 * 1 * 48 * 9 * px + 2 * 48 * 48 * 9 * px
            + 2 * 48 * 48 * 9 * (256 + 64 + 16 + 4 + 1)
            + (2 * 96 * 96 * 9 + 2 * 96 * 96 * 9) * 4
            + (2 * 144 * 96 * 9 + 2 * 96 * 96 * 9) * (16 + 64 + 256)
            + (2 * 97 * 96 * 9 + 2 * 96 * 96 * 9) * px)
    assert convs.unet_lane_flops(MODEL, 32, 32) == want
    head = 2 * (384 * 384 + 384 * 96 + 96 * 2) * px
    assert convs.unet_fold_flops(MODEL, 32, 32) == 4 * want + head
    assert dn_ssdn.mic_flops(MODEL, 32, 32) == 4 * want + head


def _traced_flops(fn):
    """2 * cin * cout * k^2 * output pixels of every conv ``fn`` runs."""
    total = [0]
    real = F.conv2d

    def counting(x, w, *a, **kw):
        y = real(x, w, *a, **kw)
        total[0] += 2 * w.shape[1] * w.shape[0] * w.shape[2] * w.shape[3] \
            * y.shape[0] * y.shape[2] * y.shape[3]
        return y

    F.conv2d = counting
    try:
        fn()
    finally:
        F.conv2d = real
    return total[0]


def test_counts_match_the_reference_forward():
    w = ref.make_weights(MODEL, 3, "cpu")
    net = ref.Net(w, MODEL)
    img = torch.rand(64, 64)
    eps = torch.zeros(64, 64)
    traced = _traced_flops(lambda: net.heatmap(img, eps))
    assert traced == joint_r8.mic_flops(MODEL, 64, 64)
    assert _traced_flops(lambda: net.denoised(img)) == dn_ssdn.mic_flops(
        MODEL, 64, 64)


def test_k1_bound():
    peaks = {"hbm_bytes_per_s": 2.0, "f32_flops_per_s": 1.0}
    assert joint_r8.k1_bytes(4, 5, 3) == 4 * 5 * 4 + 3 * 12 + 4
    assert joint_r8.k1_ops(4, 5, 3, 1) == 20 + 3 * 9
    assert joint_r8.k1_bound_s(4, 5, 3, 1, peaks) == 120 / 2.0
    assert joint_r8.k1_bound_s(4, 5, 3, 4, peaks) == 20 + 3 * 81
