"""Tiny same-family versions of the cells for the CPU tests: the cell's
own configuration file and mix with the widths cut (float32), run on
the CPU through the plain kernel versions against the cell's limits.
The serving model keeps the published vocabulary: the float8 control's
gaps come from near ties among the top logits, which a small vocabulary
does not have."""
from __future__ import annotations

import time

from . import common
from .run import Run

TINY = {
    "zamba2-7b-l6": dict(n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
                         head_dim=16, d_ff=128, vocab_size=128, ssm_state=16,
                         ssm_headdim=16, hybrid_attn_every=2,
                         sliding_window=16, dtype="float32"),
    "mixtral-8x7b-l8": dict(n_layers=4, d_model=128, n_heads=4, n_kv_heads=2,
                            head_dim=32, d_ff=256, vocab_size=32000,
                            n_experts=4, sliding_window=None,
                            moe_group_size=32, dtype="float32"),
}
MIX = {
    "train_churn": dict(global_batch=2, seq=32, cycle=6,
                        churn=[[0, "join"], [2, "leave"]], pool_batches=6),
    "serve_code": dict(batch=4, window=32, rate_per_s=20.0, prompt_median=8,
                       prompt_sigma=0.5, prompt_min=3, prompt_max=16,
                       new_median=5, new_sigma=0.5, new_min=2, new_max=12,
                       vocab=32000, warm_lengths=[4, 8, 16],
                       warm_groups=[1, 2, 4], check_requests=4,
                       check_steps=16),
}


def run_for(cell_name: str, seed: int, seconds: float = 1.0,
            trace: bool = False, fault=None) -> Run:
    common.import_program()
    cell = common.workload(cell_name)
    cfg_file = common.config(cell["config"])
    cfg_file["port"]["dims"].update(TINY[cell["config"]])
    m = common.mix(cell["traffic"])
    m.update(MIX[cell["traffic"]])
    return Run(cell=cell, cfg_file=cfg_file,
               cfg=common.model_config(cfg_file), mix=m,
               limits=common.limits(cell_name), seed=seed, seconds=seconds,
               trace=trace, device="cpu", t_start_perf=time.perf_counter(),
               fault=fault)
