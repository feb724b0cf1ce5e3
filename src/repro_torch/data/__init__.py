from .synthetic import SyntheticLM, make_batch

__all__ = ["SyntheticLM", "make_batch"]
