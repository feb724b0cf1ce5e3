"""Model configs. Arch modules register themselves with
``repro_torch.models.registry`` and are loaded lazily by it."""
from .base import ModelConfig

__all__ = ["ModelConfig"]
