"""The paper's own classification models (Table 2): ResNet-50 / ResNet-101
on Flower-102-like data, SGD momentum 0.9, lr 0.01, decay 5e-4.

A copy of the JAX package's ``configs/resnet50.py``: the same fields and
values, so a config built here sizes the same network there."""
import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    name: str
    kind: str  # "resnet" | "unet"
    num_classes: int = 102
    image_size: int = 224
    in_channels: int = 3
    stage_sizes: Tuple[int, ...] = (3, 4, 6, 3)
    width: int = 64
    # U-Net
    out_channels: int = 1
    depth: int = 4
    source: str = ""


def config() -> CNNConfig:
    return CNNConfig(name="resnet50", kind="resnet", num_classes=102,
                     image_size=224, stage_sizes=(3, 4, 6, 3), width=64,
                     source="paper §4.2.2; He et al. 2016")


def config_101() -> CNNConfig:
    return CNNConfig(name="resnet101", kind="resnet", num_classes=102,
                     image_size=224, stage_sizes=(3, 4, 23, 3), width=64,
                     source="paper §4.2.2; He et al. 2016")


def reduced() -> CNNConfig:
    return CNNConfig(name="resnet-mini", kind="resnet", num_classes=8,
                     image_size=24, stage_sizes=(1, 1), width=16,
                     source="reduced smoke variant")
