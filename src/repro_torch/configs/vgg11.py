"""VGG-11 (CIFAR-10 variant) — one of the paper's four evaluation CNNs.

[arXiv:1409.1556 config A; verified] Conv widths 64-128-256x2-512x4,
classifier 512->10 (CIFAR convention: single FC head, 2x2 maxpools).
"""
from repro_torch.configs.base import (CNNConfig, ConvSpec, register,
                                scaled_down_cnn)

CONFIG = register(CNNConfig(
    name="vgg11",
    family="cnn",
    convs=(
        ConvSpec(64, pool=True),
        ConvSpec(128, pool=True),
        ConvSpec(256), ConvSpec(256, pool=True),
        ConvSpec(512), ConvSpec(512, pool=True),
        ConvSpec(512), ConvSpec(512, pool=True),
    ),
    fc=(),
    num_classes=10,
    source="[arXiv:1409.1556; verified]",
))

# the registry's reduced smoke CNN as a first-class arch: CI and the
# recipe benchmarks address the tiny model by name instead of relying
# on the --scale tiny reduction of a full config
register(scaled_down_cnn(CONFIG, name="scaled_down_cnn"))
