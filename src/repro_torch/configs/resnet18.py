"""ResNet-18 (CIFAR-10 variant) — the paper's Fig. 8 model (C1-C17).

[arXiv:1512.03385; verified] stem conv + 8 basic blocks (2 convs each)
= 17 conv layers, widths 64-64x4-128x4-256x4-512x4, FC 512->10.
Strided (stride=2) residual stage transitions, as in the paper.
"""
from repro_torch.configs.base import CNNConfig, ConvSpec, register

CONFIG = register(CNNConfig(
    name="resnet18",
    family="cnn",
    convs=(
        ConvSpec(64),                             # C1 stem
        ConvSpec(64, residual=True), ConvSpec(64),          # block 1
        ConvSpec(64, residual=True), ConvSpec(64),          # block 2
        ConvSpec(128, stride=2, residual=True), ConvSpec(128),  # block 3
        ConvSpec(128, residual=True), ConvSpec(128),        # block 4
        ConvSpec(256, stride=2, residual=True), ConvSpec(256),  # block 5
        ConvSpec(256, residual=True), ConvSpec(256),        # block 6
        ConvSpec(512, stride=2, residual=True), ConvSpec(512),  # block 7
        ConvSpec(512, residual=True), ConvSpec(512),        # block 8
    ),
    fc=(),
    num_classes=10,
    source="[arXiv:1512.03385; verified]",
))
