from repro_torch.api.adapters import LMAdapter, ModelAdapter  # noqa: F401
