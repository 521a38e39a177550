from spr_pick_tpu_torch.models.blindspot import (
    ShiftConv,
    rot4_stack,
    rot4_unstack,
    rotate,
    shift_down,
)
from spr_pick_tpu_torch.models.unet import BlindspotUNet
from spr_pick_tpu_torch.models.resnet import (
    BasicConv2d,
    LinearClassifier,
    MaxPoolLayer,
    ResidA,
    ResNet6,
    ResNet8,
    ResNet16,
)
from spr_pick_tpu_torch.models.joint import Detector, JointNetwork

__all__ = [
    "ShiftConv",
    "rot4_stack",
    "rot4_unstack",
    "rotate",
    "shift_down",
    "BlindspotUNet",
    "BasicConv2d",
    "LinearClassifier",
    "MaxPoolLayer",
    "ResidA",
    "ResNet6",
    "ResNet8",
    "ResNet16",
    "Detector",
    "JointNetwork",
]
