from repro_torch.configs.base import (  # noqa: F401
    ALL_SHAPES, ATTN, LOCAL_ATTN, MLSTM, MXU_TILE, RGLRU, SLSTM,
    ArchConfig, CNNConfig, ConvSpec, MLAConfig, MoEConfig, PruneConfig,
    ShapeSpec, TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K,
    get_arch, get_cnn, get_shape, list_archs, list_cnns, register, scaled_down,
    scaled_down_cnn,
)
