"""VGG-19 (CIFAR-10 variant) — one of the paper's four evaluation CNNs.

[arXiv:1409.1556 config E; verified] 143M params at ImageNet scale; the
CIFAR variant used by LTP-style studies drops the 4096-wide FC head.
"""
from repro_torch.configs.base import CNNConfig, ConvSpec, register

CONFIG = register(CNNConfig(
    name="vgg19",
    family="cnn",
    convs=(
        ConvSpec(64), ConvSpec(64, pool=True),
        ConvSpec(128), ConvSpec(128, pool=True),
        ConvSpec(256), ConvSpec(256), ConvSpec(256), ConvSpec(256, pool=True),
        ConvSpec(512), ConvSpec(512), ConvSpec(512), ConvSpec(512, pool=True),
        ConvSpec(512), ConvSpec(512), ConvSpec(512), ConvSpec(512, pool=True),
    ),
    fc=(),
    num_classes=10,
    source="[arXiv:1409.1556; verified]",
))
