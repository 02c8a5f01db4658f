"""Architecture configs for the PyTorch port.

A copy of ``repro.configs.base``: ``ArchConfig`` (with its analytic
``param_count``/``active_param_count``) and the dataclasses its fields
name, the shape cells (``ShapeSpec``, ``TRAIN_4K``, ``PREFILL_32K``,
``DECODE_32K``, ``LONG_500K``, ``ALL_SHAPES``, ``get_shape``), the CNN
configs ``ConvSpec``/``CNNConfig``, ``MXU_TILE``, ``scaled_down``,
``scaled_down_cnn`` and the registries.  ``VMEM_BUDGET_BYTES`` and
``vmem_budget`` stay out: they are a TPU VMEM budget, and the port's K
rules bound each CUDA launch through ``kernels/spec.py`` instead.  The port keeps its own copy instead of
importing ``repro``: the card's machine has no JAX, and importing any
``repro`` module pulls it in.  Field names, defaults and derived
properties match the reference one for one, so a config built by either
package describes the same model.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple

# block kinds: global attention (GQA or MLA), sliding-window attention,
# RG-LRU, and xLSTM's mLSTM and sLSTM
ATTN = "attn"
LOCAL_ATTN = "local"
RGLRU = "rglru"
MLSTM = "mlstm"
SLSTM = "slstm"

# The paper's 128x128 ReRAM crossbar: the unit every TilePlan skips.
# Kernels may block inside a tile however suits the card, but a plan
# always means 128x128 weight tiles.
MXU_TILE = 128


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 0
    d_ff_shared: int = 0
    first_moe_layer: int = 0
    moe_every: int = 1
    router_noise: float = 0.0
    capacity_factor: float = 1.25

    def is_moe_layer(self, i: int) -> bool:
        return i >= self.first_moe_layer and (i - self.first_moe_layer) % self.moe_every == 0


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-style Multi-head Latent Attention dims."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class ShapeSpec:
    """One assigned input-shape cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


TRAIN_4K = ShapeSpec("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeSpec("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeSpec("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeSpec("long_500k", 524288, 1, "decode")
ALL_SHAPES: Tuple[ShapeSpec, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


def get_shape(name: str) -> ShapeSpec:
    for s in ALL_SHAPES:
        if s.name == name:
            return s
    raise KeyError(f"unknown shape {name!r}; known: {[s.name for s in ALL_SHAPES]}")


@dataclass(frozen=True)
class PruneConfig:
    """ReaLPrune / baseline pruning configuration (paper Algorithm 1)."""
    method: str = "realprune"
    prune_fraction: float = 0.25
    max_iters: int = 20
    epochs_per_iter: int = 1
    xbar_rows: int = MXU_TILE
    xbar_cols: int = MXU_TILE
    accuracy_tolerance: float = 0.0
    granularities: Tuple[str, ...] = ("filter", "channel", "index")
    recipe: Optional[str] = None


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    mlp_bias: bool = False
    tie_embeddings: bool = False
    norm: str = "rmsnorm"
    act: str = "silu"
    gated_mlp: bool = True
    rope_theta: float = 10_000.0
    local_window: Optional[int] = None
    block_pattern: Optional[Tuple[str, ...]] = None
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    rnn_width: Optional[int] = None
    conv1d_width: int = 4
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_seq_len: int = 1500
    num_patch_tokens: int = 0
    subquadratic: bool = False
    dtype: str = "bfloat16"
    prune: PruneConfig = field(default_factory=PruneConfig)
    source: str = ""

    @property
    def head_dim_(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // self.n_heads

    @property
    def blocks(self) -> Tuple[str, ...]:
        if self.block_pattern is None:
            return tuple([ATTN] * self.n_layers)
        pat = self.block_pattern
        return tuple(pat[i % len(pat)] for i in range(self.n_layers))

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 2048 (16 shards x 128 lanes)."""
        mult = 2048
        return ((self.vocab_size + mult - 1) // mult) * mult

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + norms)."""
        d, v = self.d_model, self.padded_vocab
        total = v * d  # embed
        if not self.tie_embeddings:
            total += v * d
        for i, kind in enumerate(self.blocks):
            total += self._block_params(kind, layer=i)
        total += d  # final norm
        if self.is_encoder_decoder:
            for _ in range(self.n_encoder_layers):
                total += self._block_params(ATTN, cross=False)
            total += d
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed top-k + shared)."""
        if self.moe is None:
            return self.param_count()
        d = self.d_model
        m = self.moe
        total = self.param_count()
        n_moe_layers = sum(
            1 for i, _k in enumerate(self.blocks) if m.is_moe_layer(i)
        )
        ff_mult = 3 if self.gated_mlp else 2
        dense_all = n_moe_layers * m.num_experts * ff_mult * d * m.d_ff_expert
        dense_active = n_moe_layers * m.top_k * ff_mult * d * m.d_ff_expert
        return total - dense_all + dense_active

    def _block_params(self, kind: str, cross: bool = False, layer: int = 10**9) -> int:
        d = self.d_model
        hd = self.head_dim_
        nq, nkv = self.n_heads, self.n_kv_heads
        p = 2 * d  # two norms
        if kind in (ATTN, LOCAL_ATTN):
            if self.mla is not None:
                m = self.mla
                qk_hd = m.qk_nope_head_dim + m.qk_rope_head_dim
                p += d * m.q_lora_rank + m.q_lora_rank * nq * qk_hd
                p += d * (m.kv_lora_rank + m.qk_rope_head_dim)
                p += m.kv_lora_rank * nq * (m.qk_nope_head_dim + m.v_head_dim)
                p += nq * m.v_head_dim * d
            else:
                p += d * nq * hd + 2 * d * nkv * hd + nq * hd * d
                if self.qkv_bias:
                    p += (nq + 2 * nkv) * hd
        elif kind == RGLRU:
            w = self.rnn_width or d
            p += d * w * 2 + w * d        # in (x,gate) + out proj
            p += w * self.conv1d_width    # temporal conv
            p += 3 * w                    # a-gate, input-gate params, a_param
        elif kind == MLSTM:
            w = self.rnn_width or 2 * d
            p += d * w * 2 + w * d        # up (x2) + down
            p += 3 * (w // max(self.n_heads, 1)) * w  # q,k,v per-head proj approx
            p += 3 * w                    # i,f,o gates (per-channel)
        elif kind == SLSTM:
            w = self.rnn_width or d
            p += 4 * d * w + 4 * w * w    # ifzo input + recurrent
            p += d * w * 2 + w * d        # up/down proj
        # FFN
        if kind in (ATTN, LOCAL_ATTN, RGLRU) and self.d_ff > 0:
            mlt = 3 if self.gated_mlp else 2
            if self.moe is not None and self.moe.is_moe_layer(layer):
                m = self.moe
                p += d * m.num_experts  # router
                p += m.num_experts * mlt * d * m.d_ff_expert
                p += m.num_shared_experts * mlt * d * (m.d_ff_shared or m.d_ff_expert)
            else:
                p += mlt * d * self.d_ff
        if cross:
            p += d + d * nq * hd + 2 * d * nkv * hd + nq * hd * d  # cross-attn + norm
        return p


# ---------------------------------------------------------------------------
# CNN configs (the paper's own models: VGG-11/16/19, ResNet-18 on CIFAR-10)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ConvSpec:
    out_channels: int
    kernel: int = 3
    stride: int = 1
    pool: bool = False       # 2x2 maxpool after this conv (VGG style)
    residual: bool = False   # start of a ResNet basic block


@dataclass(frozen=True)
class CNNConfig:
    name: str
    family: str
    convs: Tuple[ConvSpec, ...]
    fc: Tuple[int, ...]
    num_classes: int = 10
    in_channels: int = 3
    image_size: int = 32
    prune: PruneConfig = field(default_factory=PruneConfig)
    source: str = ""

    def param_count(self) -> int:
        total, ic = 0, self.in_channels
        for c in self.convs:
            total += c.out_channels * ic * c.kernel * c.kernel
            ic = c.out_channels
        feat = ic
        for f in self.fc:
            total += feat * f
            feat = f
        total += feat * self.num_classes
        return total


_ARCH_REGISTRY = {}
_CNN_REGISTRY = {}


def register(cfg):
    if isinstance(cfg, ArchConfig):
        _ARCH_REGISTRY[cfg.name] = cfg
    elif isinstance(cfg, CNNConfig):
        _CNN_REGISTRY[cfg.name] = cfg
    else:
        raise TypeError(type(cfg))
    return cfg


def get_arch(name: str) -> ArchConfig:
    _ensure_loaded()
    if name not in _ARCH_REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_ARCH_REGISTRY)}")
    return _ARCH_REGISTRY[name]


def get_cnn(name: str) -> CNNConfig:
    _ensure_loaded()
    if name not in _CNN_REGISTRY:
        raise KeyError(f"unknown cnn {name!r}; known: {sorted(_CNN_REGISTRY)}")
    return _CNN_REGISTRY[name]


def list_archs() -> Sequence[str]:
    _ensure_loaded()
    return sorted(_ARCH_REGISTRY)


def list_cnns() -> Sequence[str]:
    _ensure_loaded()
    return sorted(_CNN_REGISTRY)


def _ensure_loaded():
    # configs register themselves on import
    import repro_torch.configs.command_r_35b  # noqa: F401
    import repro_torch.configs.deepseek_v3_671b  # noqa: F401
    import repro_torch.configs.llama3_2_3b  # noqa: F401
    import repro_torch.configs.llama4_maverick_400b  # noqa: F401
    import repro_torch.configs.phi3_vision_4_2b  # noqa: F401
    import repro_torch.configs.qwen2_72b  # noqa: F401
    import repro_torch.configs.recurrentgemma_2b  # noqa: F401
    import repro_torch.configs.resnet18  # noqa: F401
    import repro_torch.configs.vgg11  # noqa: F401
    import repro_torch.configs.vgg16  # noqa: F401
    import repro_torch.configs.vgg19  # noqa: F401
    import repro_torch.configs.whisper_tiny  # noqa: F401
    import repro_torch.configs.xlstm_125m  # noqa: F401
    import repro_torch.configs.yi_6b  # noqa: F401


def scaled_down_cnn(cfg: CNNConfig, *, max_channels: int = 16,
                    max_fc: int = 64, **overrides) -> CNNConfig:
    """Reduced same-structure CNN config for CPU tests: the conv stack
    keeps its depth/stride/pool/residual pattern with channel counts
    capped, so the crossbar unrolls stay family-shaped."""
    convs = tuple(dataclasses.replace(c, out_channels=min(c.out_channels,
                                                          max_channels))
                  for c in cfg.convs)
    small = dict(convs=convs, fc=tuple(min(f, max_fc) for f in cfg.fc),
                 name=cfg.name + "-smoke")
    small.update(overrides)
    return dataclasses.replace(cfg, **small)


def scaled_down(cfg: ArchConfig, **overrides) -> ArchConfig:
    """Reduced same-family config for CPU tests (same defaults as the
    reference's ``scaled_down``)."""
    moe = cfg.moe
    if moe is not None:
        moe = dataclasses.replace(
            moe,
            num_experts=min(moe.num_experts, 8),
            top_k=min(moe.top_k, 2),
            d_ff_expert=64,
            d_ff_shared=64 if moe.num_shared_experts else 0,
            first_moe_layer=min(moe.first_moe_layer, 1),
        )
    mla = cfg.mla
    if mla is not None:
        mla = MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                        qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16)
    small = dict(
        n_layers=min(cfg.n_layers, 4 if cfg.block_pattern is None
                     else max(4, len(cfg.block_pattern))),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        d_ff=256 if cfg.d_ff > 0 else 0,
        head_dim=32,
        vocab_size=512,
        rnn_width=128 if cfg.rnn_width else None,
        local_window=min(cfg.local_window, 64) if cfg.local_window else None,
        n_encoder_layers=min(cfg.n_encoder_layers, 2),
        encoder_seq_len=min(cfg.encoder_seq_len, 64),
        num_patch_tokens=min(cfg.num_patch_tokens, 16),
        moe=moe,
        mla=mla,
        name=cfg.name + "-smoke",
    )
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
