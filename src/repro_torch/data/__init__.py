from repro_torch.data.pipeline import DataPipeline  # noqa: F401
from repro_torch.data.synthetic import SyntheticImages, SyntheticLM  # noqa: F401
