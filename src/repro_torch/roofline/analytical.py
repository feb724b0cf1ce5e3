"""Analytical (kernelized-path) roofline terms per (arch x shape).

Copied from the JAX package with its arithmetic unchanged. The traced
terms of ``launch/dryrun.py`` count every dispatched op's inputs and
outputs as device-memory traffic, and the plain PyTorch layers
materialize intermediates that the hand-written kernels keep in shared
memory and registers, so they overstate the traffic. This module
computes the minimum-traffic terms of the kernelized path from
closed-form per-family models: the numbers a well-implemented run is
bounded by, given the ``hw`` constants it is passed (the port's are
``launch.mesh.HW``, the H100's).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

from ..configs.base import ModelConfig, ShapeConfig
from .analysis import model_flops


def analytic_terms(cfg: ModelConfig, shape: ShapeConfig, hw: Dict,
                   chips: int, *, remat: bool = True, tp: int = 16,
                   dp_replicated_attention: bool = False) -> Dict:
    P = cfg.param_count()
    D, F, V, L = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.n_layers
    hd, H, Kh = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    B, S = shape.global_batch, shape.seq_len
    mf = model_flops(cfg, shape)

    if shape.kind in ("train", "prefill"):
        tokens = B * S
        S_eff = min(S, cfg.sliding_window or S)
        # attention score+value flops (causal ~ S_eff/2 average context)
        attn = 4.0 * L * tokens * (S_eff / 2) * H * hd
        if cfg.family == "hybrid":
            attn = attn / cfg.hybrid_attn_every   # shared block every k
        if cfg.attention_free or (cfg.family == "ssm" and cfg.slstm_every):
            attn = 0.0
        moe_disp = 0.0
        if cfg.is_moe and cfg.moe_group_size:
            moe_disp = (3.0 * 2 * cfg.top_k * cfg.capacity_factor
                        * cfg.moe_group_size * D * tokens * L)
        passes = 3.0 if shape.kind == "train" else 1.0
        recompute = 4.0 / 3.0 if (remat and shape.kind == "train") else 1.0
        flops = (mf + passes * attn + passes * moe_disp) * recompute
        if dp_replicated_attention:
            flops += (tp - 1) * passes * attn
        # HBM: params (fwd + bwd reads bf16, adam rw f32), activations
        # (per layer ~6 D-wide + 4 F-wide materializations, x2 with remat
        # re-reads), logits
        p_traffic = P * (2 * passes + (16 if shape.kind == "train" else 0))
        act = tokens * L * (6 * D + 4 * (F or 2 * D)) * 2 * \
            (2 if shape.kind == "train" else 1)
        logits = tokens * V * (6 if shape.kind == "train" else 2)
        kv_write = tokens * L * Kh * hd * 2 * 2 \
            if shape.kind == "prefill" else 0
        hbm = p_traffic + act + logits + kv_write
        # collectives: TP 2 all-reduce/layer each direction (tokens x D),
        # DP grad sync ~2 x P bf16 (reduce-scatter + all-gather)
        coll = 0.0
        if tp > 1:
            coll += 2 * passes * L * tokens * D * 2
        if shape.kind == "train":
            coll += 4.0 * P
    else:  # decode: one token per sequence
        tokens = B
        W_eff = min(S, cfg.sliding_window or S)
        p_traffic = P * 2                        # weights read once/step
        kv = 0.0
        if not cfg.attention_free:
            n_attn = (L if cfg.family not in ("hybrid",)
                      else L // cfg.hybrid_attn_every)
            if cfg.family == "ssm" and cfg.slstm_every:
                n_attn = 0
            kv = n_attn * B * W_eff * Kh * hd * 2 * 2
        state = 0.0
        if cfg.family in ("ssm", "hybrid") or cfg.slstm_every:
            from ..models.ssm import ssm_dims
            if cfg.slstm_every:
                d_in = 2 * D
                state = L * B * (d_in // cfg.n_heads) * d_in * 4 * 2
            else:
                d_inner, nh = ssm_dims(D, cfg.ssm_expand, cfg.ssm_headdim)
                state = L * B * nh * cfg.ssm_headdim * cfg.ssm_state * 4 * 2
        if cfg.is_encdec:
            kv += L * B * cfg.encoder_seq * Kh * hd * 2 * 2
        hbm = p_traffic + kv + state
        flops = mf + 2 * (kv / 2)                # ~1 MAC per cache byte/2
        coll = 2 * L * B * D * 2 * (1 if tp > 1 else 0)

    t_c = flops / (chips * hw["peak_flops_bf16"])
    t_m = hbm / (chips * hw["hbm_bw"])
    t_x = coll / (chips * hw["ici_bw"])
    step = max(t_c, t_m, t_x)
    return {
        "flops": flops, "hbm_bytes": hbm, "coll_bytes": coll,
        "t_compute": t_c, "t_memory": t_m, "t_collective": t_x,
        "bottleneck": max([("compute", t_c), ("memory", t_m),
                           ("collective", t_x)], key=lambda kv: kv[1])[0],
        "step_time": step,
        "mfu": mf / (chips * hw["peak_flops_bf16"] * step) if step else 0.0,
    }
