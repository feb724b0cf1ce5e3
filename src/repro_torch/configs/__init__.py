"""Model configs (one module per architecture, copied from the JAX
package with their values unchanged). Arch modules register themselves
with ``repro_torch.models.registry`` and are loaded lazily by it
(``configs/archs.py``)."""
from .base import (SHAPES, SHAPES_BY_NAME, ModelConfig, ShapeConfig,
                   cell_applicable)

ALL_ARCHS = (
    "llava-next-34b", "whisper-small", "xlstm-125m", "zamba2-7b",
    "qwen2-72b", "granite-3-2b", "qwen2.5-3b", "smollm-135m",
    "llama4-scout-17b-a16e", "mixtral-8x7b",
)

__all__ = ["ALL_ARCHS", "SHAPES", "SHAPES_BY_NAME", "ModelConfig",
           "ShapeConfig", "cell_applicable"]
