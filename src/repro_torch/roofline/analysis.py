"""Three-term roofline from a compiled (AOT) artifact.

  compute term    = HLO_FLOPs / (chips x peak_FLOP/s)
  memory term     = HLO_bytes / (chips x HBM_bw)
  collective term = collective_bytes / (chips x link_bw)

``cost_analysis()`` provides flops/bytes; collective bytes are NOT in
cost_analysis, so we parse the optimized HLO text and sum operand sizes of
every all-gather / all-reduce / reduce-scatter / all-to-all /
collective-permute op.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

_DTYPE_BYTES = {
    "pred": 1, "s4": 1, "u4": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2,
    "s32": 4, "u32": 4, "s64": 8, "u64": 8, "f8e4m3fn": 1, "f8e5m2": 1,
    "bf16": 2, "f16": 2, "f32": 4, "f64": 8, "c64": 8, "c128": 16,
}

_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")
_COLL_RE = re.compile(
    r"^\s*(?:ROOT\s+)?%?[\w.\-]+\s*=\s*(\([^)]*\)|[a-z0-9]+\[[0-9,]*\][^ ]*)\s*"
    r"(all-gather|all-reduce|reduce-scatter|all-to-all|collective-permute|"
    r"all-gather-start|all-reduce-start|collective-permute-start)\(",
    re.M)


def _shape_bytes(shape_str: str) -> int:
    """bytes of 'bf16[8,128]{1,0}' or tuple '(f32[2,2], u32[])'."""
    total = 0
    for m in _SHAPE_RE.finditer(shape_str):
        dt, dims = m.group(1), m.group(2)
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def collective_bytes(hlo_text: str) -> Dict[str, int]:
    """Sum of *output* operand sizes per collective kind (proxy for bytes
    moved; reduce-scatter/all-gather outputs reflect the data landed on
    each participant group)."""
    out: Dict[str, int] = {}
    for m in _COLL_RE.finditer(hlo_text):
        shape_str, kind = m.group(1), m.group(2)
        kind = kind.replace("-start", "")
        out[kind] = out.get(kind, 0) + _shape_bytes(shape_str)
    return out


@dataclass
class Roofline:
    flops: float
    hbm_bytes: float
    coll_bytes: float
    chips: int
    peak_flops: float
    hbm_bw: float
    ici_bw: float
    coll_detail: Dict[str, int] = field(default_factory=dict)
    out_bytes: float = 0.0

    @property
    def t_compute(self) -> float:
        return self.flops / (self.chips * self.peak_flops)

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / (self.chips * self.hbm_bw)

    @property
    def t_collective(self) -> float:
        # HLO shapes are global under SPMD: per-chip landed bytes ~ total/chips
        return self.coll_bytes / (self.chips * self.ici_bw)

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def step_time(self) -> float:
        """Perfect-overlap model: max of the three terms."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    def fraction_of_roofline(self, model_flops: float) -> float:
        """useful_FLOPs / (chips*peak*step_time): the score we report."""
        denom = self.chips * self.peak_flops * self.step_time
        return model_flops / denom if denom else 0.0

    def to_dict(self) -> Dict:
        return {
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "coll_bytes": self.coll_bytes, "chips": self.chips,
            "t_compute": self.t_compute, "t_memory": self.t_memory,
            "t_collective": self.t_collective,
            "bottleneck": self.bottleneck, "step_time": self.step_time,
            "coll_detail": self.coll_detail,
        }


def analyze_compiled(compiled, chips: int, hw: Dict,
                     hlo_text: Optional[str] = None) -> Roofline:
    """cost_analysis() and the partitioned HLO report PER-DEVICE numbers
    (the SPMD module is the program one device runs); we store GLOBAL
    totals (x chips) and divide by chips in the term formulas."""
    ca = compiled.cost_analysis()
    if isinstance(ca, list):
        ca = ca[0]
    flops = float(ca.get("flops", 0.0)) * chips
    byt = float(ca.get("bytes accessed", 0.0)) * chips
    text = hlo_text if hlo_text is not None else compiled.as_text()
    cd = {k: v * chips for k, v in collective_bytes(text).items()}
    return Roofline(
        flops=flops, hbm_bytes=byt, coll_bytes=float(sum(cd.values())),
        chips=chips, peak_flops=hw["peak_flops_bf16"], hbm_bw=hw["hbm_bw"],
        ici_bw=hw["ici_bw"], coll_detail=cd)


def roofline_terms(compiled, chips: int, hw: Dict) -> Dict:
    return analyze_compiled(compiled, chips, hw).to_dict()


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6·N·D (dense) or 6·N_active·D (MoE); decode: D=batch
    tokens (one step), train: full batch x seq x 3 (fwd+bwd)."""
    n = cfg.param_count(active_only=True)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch          # decode: one token each
