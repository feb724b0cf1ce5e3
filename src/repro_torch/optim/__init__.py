from .adamw import AdamW, OptState, cosine_schedule, global_norm

__all__ = ["AdamW", "OptState", "cosine_schedule", "global_norm"]
