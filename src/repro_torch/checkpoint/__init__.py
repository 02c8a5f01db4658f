from repro_torch.checkpoint.manager import (  # noqa: F401
    CheckpointManager, load_pytree, pack_json, save_pytree, unpack_json,
)
