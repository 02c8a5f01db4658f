from repro_torch.configs.base import (  # noqa: F401
    ATTN, LOCAL_ATTN, MLSTM, MXU_TILE, RGLRU, SLSTM,
    ArchConfig, CNNConfig, ConvSpec, MLAConfig, MoEConfig, PruneConfig,
    get_arch, get_cnn, list_archs, list_cnns, register, scaled_down,
    scaled_down_cnn,
)
