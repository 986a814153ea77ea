from repro_torch.models.config import ModelConfig  # noqa: F401
