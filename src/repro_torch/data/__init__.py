from repro_torch.data.pipeline import DataPipeline  # noqa: F401
from repro_torch.data.synthetic import (  # noqa: F401
    SyntheticAudio, SyntheticImages, SyntheticLM, cifar_like_batch, lm_batch,
)
