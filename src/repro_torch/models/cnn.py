"""CNNs for the paper's own experiments: VGG-11/16/19 and ResNet-18
(port of ``repro.models.cnn``).

Activations are NHWC and conv kernels HWIO, as in the reference: masks,
``core.crossbar``'s im2col unroll to the (IC·K·K, OC) crossbar matrix
and the on-disk ticket format all assume that layout.  ``conv2d``
permutes to torch's NCHW/OIHW only at the call (an NHWC tensor viewed as
NCHW is channels-last, which cuDNN takes as it is) and pads explicitly
to XLA's ``SAME``: for a stride-2 3×3 conv on an even size that is
(0, 1), not torch's (1, 1).

BatchNorm is the reference's functional form with its state dict: the
biased variance over (N, H, W), running stats kept as ``0.9·old +
0.1·new``, ``eps`` inside the rsqrt, no update in eval.  The FC layers
and the head go through ``plan_matmul``, so a ticket whose FC weights
tile at 128 retrains them through the block-sparse kernels.

Float32 convs on the card follow torch's global cuDNN setting
(``torch.backends.cudnn.allow_tf32``, True by default: TF32).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch._bridge import resolve_device
from repro_torch.configs.base import CNNConfig, ConvSpec
from repro_torch.kernels.bsmm import plan_matmul
from repro_torch.models.layers import softmax_cross_entropy, xavier


def conv_init(gen, spec: ConvSpec, in_channels: int, dtype=torch.float32,
              device="cuda"):
    k = spec.kernel
    w = xavier(gen, (k, k, in_channels, spec.out_channels), dtype, device,
               in_axis=2, out_axis=3)
    return {"w": w}


def bn_init(channels: int, dtype=torch.float32, device="cuda"):
    return {"scale": torch.ones((channels,), dtype=dtype, device=device),
            "bias": torch.zeros((channels,), dtype=dtype, device=device)}


def bn_state_init(channels: int, device="cuda"):
    return {"mean": torch.zeros((channels,), dtype=torch.float32,
                                device=device),
            "var": torch.ones((channels,), dtype=torch.float32,
                              device=device)}


def batchnorm(params, state, x, train: bool, momentum: float = 0.9,
              eps: float = 1e-5):
    if train:
        mean = x.mean(dim=(0, 1, 2))
        var = x.var(dim=(0, 1, 2), correction=0)
        new_state = {
            "mean": momentum * state["mean"] + (1 - momentum) * mean.detach(),
            "var": momentum * state["var"] + (1 - momentum) * var.detach(),
        }
    else:
        mean, var = state["mean"], state["var"]
        new_state = state
    y = (x - mean) * torch.rsqrt(var + eps)
    return y * params["scale"] + params["bias"], new_state


def _same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's ``SAME`` padding of one spatial axis: (low, high)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv2d(w, x, stride: int = 1):
    """x (N, H, W, C) ⊛ w (KH, KW, C, OC) → (N, H', W', OC), SAME."""
    ph = _same_pads(x.shape[1], w.shape[0], stride)
    pw = _same_pads(x.shape[2], w.shape[1], stride)
    xn = x.permute(0, 3, 1, 2)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        pad = (ph[0], pw[0])
    else:
        xn = F.pad(xn, (pw[0], pw[1], ph[0], ph[1]))
        pad = 0
    y = F.conv2d(xn, w.permute(3, 2, 0, 1), stride=stride, padding=pad)
    return y.permute(0, 2, 3, 1)


def maxpool2(x):
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


def init_params(gen: torch.Generator, cfg: CNNConfig, dtype=torch.float32,
                device="cuda"):
    """(params, BN state) drawn from ``gen`` (a generator on ``device``;
    the reference draws with jax.random, so values differ by design and
    distributions match).  Keys and nesting are the reference's."""
    dev = resolve_device(device)
    params = {"convs": [], "bns": [], "shortcuts": {}}
    state = {"bns": [], "shortcut_bns": {}}
    ic = cfg.in_channels
    for i, spec in enumerate(cfg.convs):
        params["convs"].append(conv_init(gen, spec, ic, dtype, dev))
        params["bns"].append(bn_init(spec.out_channels, dtype, dev))
        state["bns"].append(bn_state_init(spec.out_channels, dev))
        if spec.residual and (spec.stride != 1 or spec.out_channels != ic):
            # 1x1 projection shortcut
            params["shortcuts"][str(i)] = {
                "w": xavier(gen, (1, 1, ic, spec.out_channels), dtype, dev,
                            in_axis=2, out_axis=3)}
            params["bns_sc_" + str(i)] = bn_init(spec.out_channels, dtype,
                                                 dev)
            state["shortcut_bns"][str(i)] = bn_state_init(spec.out_channels,
                                                          dev)
        ic = spec.out_channels
    feat = ic
    params["fc"] = []
    for f in cfg.fc:
        params["fc"].append(
            {"w": xavier(gen, (feat, f), dtype, dev),
             "b": torch.zeros((f,), dtype=dtype, device=dev)})
        feat = f
    params["head"] = {
        "w": xavier(gen, (feat, cfg.num_classes), dtype, dev),
        "b": torch.zeros((cfg.num_classes,), dtype=dtype, device=dev)}
    return params, state


def forward(params, state, cfg: CNNConfig, images, train: bool = False,
            plans=None):
    """images: (B, H, W, C) → logits (B, num_classes), new_state.

    ``ConvSpec.residual`` marks the FIRST conv of a 2-conv basic block
    (ResNet-18); plain convs (VGG) apply conv→BN→ReLU→(pool).
    ``plans`` (from ``train.plans.cnn_train_plan``) routes the FC and
    head products of a pruned ticket through the block-sparse kernels,
    forward and backward: {"fc": [TilePlan|None, ...], "head":
    TilePlan|None}.
    """
    plans = plans or {}
    fc_plans = list(plans.get("fc") or ())
    fc_plans += [None] * (len(params["fc"]) - len(fc_plans))
    x = images.to(params["head"]["w"].dtype)
    new_state = {"bns": [dict(s) for s in state["bns"]],
                 "shortcut_bns": dict(state["shortcut_bns"])}
    i = 0
    while i < len(cfg.convs):
        spec = cfg.convs[i]
        if spec.residual:
            res = x
            y = conv2d(params["convs"][i]["w"], x, spec.stride)
            y, new_state["bns"][i] = batchnorm(
                params["bns"][i], state["bns"][i], y, train)
            y = torch.relu(y)
            y = conv2d(params["convs"][i + 1]["w"], y, cfg.convs[i + 1].stride)
            y, new_state["bns"][i + 1] = batchnorm(
                params["bns"][i + 1], state["bns"][i + 1], y, train)
            if str(i) in params["shortcuts"]:
                res = conv2d(params["shortcuts"][str(i)]["w"], res,
                             spec.stride)
                res, new_state["shortcut_bns"][str(i)] = batchnorm(
                    params["bns_sc_" + str(i)], state["shortcut_bns"][str(i)],
                    res, train)
            x = torch.relu(y + res)
            if cfg.convs[i + 1].pool:
                x = maxpool2(x)
            i += 2
        else:
            y = conv2d(params["convs"][i]["w"], x, spec.stride)
            y, new_state["bns"][i] = batchnorm(
                params["bns"][i], state["bns"][i], y, train)
            x = torch.relu(y)
            if spec.pool:
                x = maxpool2(x)
            i += 1
    # global average pool (CIFAR ResNet/VGG-small convention)
    x = x.mean(dim=(1, 2))
    for fc, fp in zip(params["fc"], fc_plans):
        x = plan_matmul(x, fc["w"], fp, bias=fc["b"], act="relu")
    logits = plan_matmul(x, params["head"]["w"], plans.get("head"),
                         bias=params["head"]["b"])
    return logits, new_state


def loss_fn(params, state, cfg: CNNConfig, batch, train: bool = True,
            plans=None):
    logits, new_state = forward(params, state, cfg, batch["images"], train,
                                plans=plans)
    ce = softmax_cross_entropy(logits, batch["labels"])
    return ce, (new_state, logits)


def accuracy(params, state, cfg: CNNConfig, images, labels) -> torch.Tensor:
    logits, _ = forward(params, state, cfg, images, train=False)
    return ((logits.argmax(-1) == labels).float()).mean()
