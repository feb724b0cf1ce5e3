"""Importing this module registers all architecture configs."""
from . import (granite_3_2b, llama4_scout, llava_next_34b, mixtral_8x7b,
               qwen2_5_3b, qwen2_72b, smollm_135m, whisper_small,
               xlstm_125m, zamba2_7b)  # noqa: F401
