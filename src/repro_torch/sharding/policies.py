"""Per-architecture sharding policies for the production mesh. Port of
``repro/sharding/policies.py`` on PyTorch's ``DeviceMesh``, with the
reference's logic and rule tables unchanged.

Mesh axes: single-pod ("data", "model") = (16, 16); multi-pod adds a
leading "pod" axis folded into data parallelism. Policy knobs:

* TP      — attention heads / ff / vocab over "model" (always on)
* FSDP    — parameters additionally sharded over "data" on the non-TP dim
            (ZeRO-3 style); enabled for >= ~6B-param archs by default
* EP      — MoE expert dim over "model" when n_experts divides the axis,
            otherwise TP inside each expert (Mixtral: 8 experts on a
            16-way axis would pad half the devices idle)
* head constraints are only emitted when the head count divides the TP
  axis (llava's 56 heads / smollm's 9 heads propagate from the weight
  shardings instead of forcing padded activation shardings)
"""
from __future__ import annotations

import re
from typing import Dict, Optional, Tuple

from ..configs.base import ModelConfig
from ..utils import tree_flatten, tree_unflatten
from .rules import ShardingRules


def axis_size(mesh, name) -> int:
    if name is None:
        return 1
    if isinstance(name, (tuple, list)):
        out = 1
        for n in name:
            out *= axis_size(mesh, n)
        return out
    return mesh.size(mesh.mesh_dim_names.index(name))


def make_rules(mesh, cfg: ModelConfig, *,
               fsdp: Optional[bool] = None,
               moe_mode: Optional[str] = None,
               seq_shard: bool = False,
               dp_over_model: bool = False) -> ShardingRules:
    """Build the rule set for (mesh, arch).

    ``dp_over_model``: fold the model axis into data parallelism (pure
    DP-256/512, parameters replicated). The right policy for small models
    whose head counts don't divide the TP axis — TP would replicate their
    attention compute 16x."""
    multi_pod = "pod" in mesh.mesh_dim_names
    dp = ("pod", "data") if multi_pod else ("data",)
    tp = "model"
    tp_size = axis_size(mesh, tp)
    if dp_over_model:
        dp = dp + ("model",)
        tp = None
        tp_size = 1
    if fsdp is None:
        fsdp = cfg.param_count() >= 6e9
    fs = "data" if fsdp else None
    if moe_mode is None:
        moe_mode = "ep" if (cfg.n_experts and tp_size > 1 and
                            cfg.n_experts % tp_size == 0) else "tp"

    logical = {
        "batch": dp,
        "heads": tp if tp and cfg.n_heads % tp_size == 0 else None,
        "kv_heads": tp if tp and cfg.n_kv_heads % tp_size == 0 else None,
        "ff": tp,
        # non-divisible vocabs (granite 49155, whisper 51865) replicate the
        # embedding rather than padding the table (config kept exact)
        "vocab": tp if tp and cfg.vocab_size % tp_size == 0 else None,
        "experts": tp if moe_mode == "ep" else None,
        # expert-internal ff dim: TP'd only when experts are NOT the EP
        # axis (a spec may use each mesh axis once)
        "expert_ff": None if moe_mode == "ep" else tp,
        "seq": tp if seq_shard else None,
    }

    ex = ("experts" if moe_mode == "ep" else None)
    moe_inner_tp = (None if moe_mode == "ep" else "ff")
    params: Tuple = (
        # --- attention ---
        (r"blocks/attn/w[qkv]$", ("layers", "fsdp", "ff")),
        (r"blocks/attn/wo$", ("layers", "ff", "fsdp")),
        (r"blocks/attn/b[qkv]$", ("layers", "ff")),
        (r"shared/attn/w[qkv]$", ("fsdp", "ff")),
        (r"shared/attn/wo$", ("ff", "fsdp")),
        (r"shared/attn/b[qkv]$", ("ff",)),
        (r"(enc_blocks|dec_blocks)/x?attn/w[qkv]$", ("layers", "fsdp", "ff")),
        (r"(enc_blocks|dec_blocks)/x?attn/wo$", ("layers", "ff", "fsdp")),
        (r"(enc_blocks|dec_blocks)/x?attn/b[qkv]$", ("layers", "ff")),
        # --- dense mlp ---
        (r"blocks/mlp/(gate|up)$", ("layers", "fsdp", "ff")),
        (r"blocks/mlp/down$", ("layers", "ff", "fsdp")),
        (r"shared/mlp/(gate|up)$", ("fsdp", "ff")),
        (r"shared/mlp/down$", ("ff", "fsdp")),
        (r"(enc_blocks|dec_blocks)/mlp/(gate|up)$", ("layers", "fsdp", "ff")),
        (r"(enc_blocks|dec_blocks)/mlp/down$", ("layers", "ff", "fsdp")),
        # --- moe ---
        (r"blocks/moe/router$", ("layers", "fsdp", None)),
        (r"blocks/moe/(gate|up)$", ("layers", ex, "fsdp", moe_inner_tp)),
        (r"blocks/moe/down$", ("layers", ex, moe_inner_tp, "fsdp")),
        # --- mamba2 ---
        (r"blocks/ssm/in_proj$", ("layers", "fsdp", "ff")),
        (r"blocks/ssm/out_proj$", ("layers", "ff", "fsdp")),
        (r"blocks/ssm/conv_w$", ("layers", None, "ff")),
        (r"blocks/ssm/(A_log|D|dt_bias)$", ("layers", None)),
        (r"blocks/ssm/norm_w$", ("layers", "ff")),
        # --- xlstm ---
        (r"blocks/[ms]lstm/(up|wq|wk|wv)$", ("layers", "fsdp", "ff")),
        (r"blocks/[ms]lstm/(down|wx)$", ("layers", "ff", "fsdp")),
        (r"blocks/mlstm/w[if]$", ("layers", "fsdp", None)),
        (r"blocks/slstm/wr$", ("layers", None, "ff", None)),
        (r"blocks/[ms]lstm/norm_w$", ("layers", "ff")),
        (r"blocks/[ms]lstm/(fb|b)$", ("layers", None)),
        # --- embeddings ---
        (r"^(embed|lm_head)$", ("vocab", "fsdp")),
        # norms etc. fall through -> replicated
    )
    logical = dict(logical)
    logical["layers"] = None
    logical["fsdp"] = fs
    return ShardingRules(mesh=mesh, logical=logical, params=params)


# ---------------------------------------------------------------------------
# Pipeline-parallel 2-D mesh
# ---------------------------------------------------------------------------
def stage_data_mesh(n_stages: int, n_data: int, *,
                    data_axis: str = "data", stage_axis: str = "stage",
                    ranks=None, device_type="cuda"):
    """The 2-D (stage x data) mesh of the pipeline subsystem
    (``pipeline_exec``): ``n_stages`` model-parallel pipeline rows, each
    a full data-parallel team of ``n_data``. Ranks fill stage-major — a
    data column's stages sit on CONSECUTIVE ranks, so the per-wave
    activation hop goes between neighbours while the data-axis
    collective spans the stride. ``ranks`` defaults to the default
    group's ``0 .. world_size - 1``."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    ranks = (list(ranks) if ranks is not None
             else list(range(dist.get_world_size())))
    need = n_stages * n_data
    if len(ranks) < need:
        raise ValueError(f"need {n_stages}x{n_data}={need} ranks for the "
                         f"({stage_axis!r}, {data_axis!r}) mesh, have "
                         f"{len(ranks)}")
    arr = torch.tensor(ranks[:need]).reshape(n_data, n_stages).T
    return DeviceMesh(device_type, arr.contiguous(),
                      mesh_dim_names=(stage_axis, data_axis))


# ---------------------------------------------------------------------------
# Batch / decode-state shardings
# ---------------------------------------------------------------------------
def batch_specs(rules: ShardingRules, batch: Dict) -> Dict:
    """Spec per input field: batch dim over dp, rest replicated."""
    paths, leaves = tree_flatten(batch)
    return tree_unflatten(paths, [
        (rules.logical["batch"],) + (None,) * (leaf.ndim - 1)
        for leaf in leaves])


_STATE_RULES: Tuple = (
    # (regex on the state-tree path; axes are left-padded with None for
    # any extra leading stack dims)
    (r"slstm/", (None, "batch", "ssm_heads", None)),  # c/n/m/h (G,B,nh,hd)
    (r"mlstm/m$", ("batch", "ssm_heads")),            # (G,k-1,B,nh)
    (r"(^|/)conv$", (None, "batch", None, "ff")),
    (r"(^|/)(k|v)$", (None, "batch", "window", "kv_heads", None)),
    (r"(^|/)pos$", (None, "batch", "window")),
    (r"(^|/)cross_(k|v)$", (None, "batch", None, "kv_heads", None)),
    (r"(^|/)h$", (None, "batch", "ssm_heads", None, None)),
    (r"(^|/)C$", (None, "batch", "ssm_heads", None, None)),
    (r"(^|/)n$", (None, "batch", "ssm_heads", None)),
    (r"(^|/)m$", (None, "batch", "ssm_heads")),
    (r"(^|/)c$", (None, "batch", "ssm_heads", None)),
)


def decode_state_specs(rules: ShardingRules, cfg: ModelConfig, state_tree,
                       mesh, batch: Optional[int] = None,
                       split_k: bool = False) -> Dict:
    """Decode-state specs. When the request batch does not divide the
    dp axes (long-context, batch=1), the KV-cache WINDOW dim is sharded
    over 'data' instead (sequence-sharded cache — the serving analogue of
    ring attention).

    ``split_k``: shard the window dim over the MODEL axis (mesh-level
    FlashDecoding split-K): non-divisible kv-head counts otherwise leave
    the cache replicated 16x over the model axis, making cache reads the
    decode bottleneck."""
    from ..models.ssm import ssm_dims
    tp_size = axis_size(mesh, "model")
    if cfg.family in ("ssm", "hybrid") and not cfg.slstm_every:
        nh = ssm_dims(cfg.d_model, cfg.ssm_expand, cfg.ssm_headdim)[1]
    else:
        nh = cfg.n_heads
    logical = dict(rules.logical)
    logical["ssm_heads"] = "model" if nh % tp_size == 0 else None
    dp_size = axis_size(mesh, logical.get("batch"))
    batch_ok = batch is None or (batch % dp_size == 0)
    logical["window"] = "model" if split_k else None
    if split_k:
        logical["kv_heads"] = None    # window takes the model axis
    if not batch_ok:
        logical["batch"] = None
        logical["window"] = ("data", "model") if split_k else "data"
    r2 = ShardingRules(mesh=mesh, logical=logical, params=rules.params)

    def spec_for(p, leaf):
        for pat, axes in _STATE_RULES:
            if re.search(pat, p):
                fit = tuple(axes)
                if len(fit) < leaf.ndim:   # extra LEADING stack dims
                    fit = (None,) * (leaf.ndim - len(fit)) + fit
                return r2.resolve(*fit[:leaf.ndim])
        return (None,) * leaf.ndim

    paths, leaves = tree_flatten(state_tree)
    return tree_unflatten(paths, [spec_for("/".join(p), leaf)
                                  for p, leaf in zip(paths, leaves)])
