"""Networks of the port (counterpart of ``loans_tpu.models``)."""

from loans_tpu_torch.models.assessor import (
    DownResBlock1,
    DownResBlock2,
    DownResBlock3,
    ResnetAssessor,
)
from loans_tpu_torch.models.localizer import Localizer
from loans_tpu_torch.models.resnet import (
    BasicA,
    BasicB,
    BasicStage,
    BottleNeckA,
    BottleNeckB,
    BottleNeckStage,
    ConvBN,
    ResNet,
)
from loans_tpu_torch.models.ssd import SSD, SSD300, SSD512

__all__ = [
    "BasicA",
    "BasicB",
    "BasicStage",
    "BottleNeckA",
    "BottleNeckB",
    "BottleNeckStage",
    "ConvBN",
    "DownResBlock1",
    "DownResBlock2",
    "DownResBlock3",
    "Localizer",
    "ResNet",
    "ResnetAssessor",
    "SSD",
    "SSD300",
    "SSD512",
]
