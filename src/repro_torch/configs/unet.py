"""The paper's segmentation model (Table 5): U-Net on Carvana-like data,
Adam lr 0.01 decay 5e-4, BCE+Dice loss (the JAX package's
``configs/unet.py``)."""
from .resnet50 import CNNConfig


def config() -> CNNConfig:
    return CNNConfig(name="unet", kind="unet", image_size=384,
                     out_channels=1, depth=4, width=64,
                     source="paper §4.2.2; Ronneberger et al. 2015")


def reduced() -> CNNConfig:
    return CNNConfig(name="unet-mini", kind="unet", image_size=32,
                     out_channels=1, depth=2, width=8,
                     source="reduced smoke variant")
