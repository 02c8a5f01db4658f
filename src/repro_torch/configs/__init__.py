from repro_torch.configs.base import (  # noqa: F401
    ATTN, LOCAL_ATTN, MXU_TILE, RGLRU,
    ArchConfig, MLAConfig, MoEConfig, PruneConfig,
    get_arch, register, scaled_down,
)
