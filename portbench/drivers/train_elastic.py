"""Elastic data-parallel training: the port's ``TrainLoop`` with an
``ElasticPhaserRuntime``, its team churned on a repeating schedule.

Set-up makes the weights from the seed and hands them to one loop,
which runs the checked steps (the first through ``run(1)``, so its
optimizer state can be read, then the rest), then warms up through
whole churn cycles, every epoch's step built and run. The window opens
at a cycle boundary on ``torch.cuda.synchronize()`` and closes on one
after the first step that ends ``--seconds`` later; every step in it
counts. After the window the program's state is freed and the reference
follows the checked steps from the same weights and batches.
"""
from __future__ import annotations

import gc
import time
from typing import Dict

import torch

from .. import flops, trace, weights
from ..generators import BatchPool
from ..reference import hybrid as REF
from ..reference.common import Precision, no_tf32


class Churn:
    """The loop's ``elastic_events``: the mix's (position, kind) pairs at
    every ``cycle`` steps; ``offset`` maps a ``run`` call's step index to
    the run's global step."""

    def __init__(self, cycle: int, churn):
        self.cycle, self.offset = cycle, 0
        self.at = {}
        for pos, kind in churn:
            self.at.setdefault(pos, []).append((kind, None))

    def get(self, step, default=None):
        return self.at.get((step + self.offset) % self.cycle, default or [])


class _Closed(Exception):
    pass


def _flat(tree) -> Dict:
    return {p: t for p, t in weights.leaves(tree)}


def matmul_params(d: Dict) -> int:
    """Matmul parameters a token passes through: every Mamba2 layer's
    in- and out-projections, the shared block at each application, and
    the head."""
    D, F, V, L = d["d_model"], d["d_ff"], d["vocab_size"], d["n_layers"]
    H, Kh = d["n_heads"], d["n_kv_heads"]
    hd = d["head_dim"] or D // H
    d_in = d["ssm_expand"] * D
    nh = d_in // d["ssm_headdim"]
    mamba = D * (2 * d_in + 2 * d["ssm_state"] + nh) + d_in * D
    shared = 2 * D * H * hd + 2 * D * Kh * hd + 3 * D * F
    return L * mamba + (L // d["hybrid_attn_every"]) * shared + V * D


def model_flops_per_token(cfg_file: Dict) -> float:
    """Training FLOPs a token: 3x the forward's (2 per matmul parameter
    applied, the shared block's causal attention, the chunked SSD)."""
    d = cfg_file["port"]["dims"]
    D, L, H = d["d_model"], d["n_layers"], d["n_heads"]
    hd = d["head_dim"] or D // H
    N, P = d["ssm_state"], d["ssm_headdim"]
    nh = d["ssm_expand"] * D // P
    apps = L // d["hybrid_attn_every"]
    params = matmul_params(d)
    S = cfg_file["seq"]
    attn = apps * flops.attention_fwd_flops(1, H, S, S, hd, True,
                                            d["sliding_window"]) / S
    ssd = L * nh * flops.ssd_chunk_flops_per_token(
        P, N, cfg_file["port"]["ssd_chunk"])
    return 3 * (2 * params + attn + ssd)


def run(r) -> Dict:
    """``r``: the run (``portbench.run.Run``). Returns the window's
    numbers, the traced readings, and under ``kept`` what ``check``
    holds against the reference."""
    from repro_torch.models.registry import get_api
    from repro_torch.obs.timeline import Timeline
    from repro_torch.optim import AdamW
    from repro_torch.runtime_elastic import ElasticPhaserRuntime
    from repro_torch.train.loop import TrainLoop

    m, dev = r.mix, r.device
    hp = m["optimizer"]
    api = get_api(r.cfg)
    spec = api.param_spec()
    data = BatchPool(r.cfg.vocab_size, m["global_batch"], m["seq"], r.seed,
                     m["pool_batches"], m["markov_branch"])
    params = weights.make(spec, r.seed, dev)
    opt = AdamW(lr=hp["lr"], b1=hp["b1"], b2=hp["b2"], eps=hp["eps"],
                weight_decay=hp["weight_decay"], clip_norm=hp["clip_norm"],
                warmup=hp["warmup"], total_steps=hp["total_steps"])
    churn = Churn(m["cycle"], m["churn"])
    tl = Timeline()
    loop = TrainLoop(api=api, opt=opt, data=data,
                     runtime=ElasticPhaserRuntime(
                         m["workers"], seed=m["sync_seed"],
                         kind=m["sync_kind"]),
                     elastic_events=churn, timeline=tl, device=dev,
                     remat=m["remat"])
    if r.fault is not None:
        r.fault(loop)
    calls = {"pb.mamba2_scan_bwd": [], "pb.flash_attention_bwd": []}
    rec = {"on": False}
    marks = []
    if r.trace:
        from repro_torch.kernels import flash_attention as FA
        from repro_torch.kernels import mamba2_scan as MS

        def scan_call(x, Bm, Cm, a, dt, dy, **k):
            if rec["on"]:
                B, NH, S, P = x.shape
                calls["pb.mamba2_scan_bwd"].append(
                    (flops.scan_bwd_flops(B, NH, S, P, Bm.shape[-1]),
                     flops.scan_bwd_bytes(B, NH, S, P, Bm.shape[-1],
                                          x.element_size(),
                                          Bm.element_size())))

        def attn_call(q, k, v, out, dout, lse, causal=True,
                      sliding_window=None):
            if rec["on"]:
                B, H, Sq, hd = q.shape
                Kh, Sk = k.shape[1], k.shape[2]
                calls["pb.flash_attention_bwd"].append(
                    (flops.attention_bwd_flops(B, H, Sq, Sk, hd, causal,
                                               sliding_window),
                     flops.attention_bwd_bytes(B, H, Kh, Sq, Sk, hd,
                                               q.element_size(),
                                               dout.element_size())))
        marks = [(MS, "mamba2_scan_bwd", "pb.mamba2_scan_bwd", scan_call),
                 (FA, "flash_attention_bwd", "pb.flash_attention_bwd",
                  attn_call)]

    losses = []

    def keep(step, p, metrics):
        losses.append(metrics["loss"])

    k = m["check_steps"]
    warm_end = m["cycle"] * m["warmup_cycles"]
    st = {"n": 0, "t0": None, "prof": None, "tl0": 0.0}
    seq_tokens = m["global_batch"] * m["seq"]

    def window(step, p, metrics):
        g = step + churn.offset
        if st["t0"] is None:
            if g + 1 == warm_end:
                if dev != "cpu":
                    torch.cuda.synchronize(dev)
                if r.trace:
                    st["prof"] = trace.profiler()
                    st["prof"].__enter__()
                    rec["on"] = True
                st["tl0"] = tl.now()
                st["t0"] = time.perf_counter()
            return
        st["n"] += 1
        if time.perf_counter() - st["t0"] >= r.seconds:
            if dev != "cpu":
                torch.cuda.synchronize(dev)
            st["t1"] = time.perf_counter()
            st["tl1"] = tl.now()
            rec["on"] = False
            raise _Closed

    with trace.marked(marks):
        p1, o1 = loop.run(1, params=params, on_step=keep)
        grad = {path: float(t.float().norm()) / (1 - hp["b1"])
                for path, t in weights.leaves(o1.mu)}
        churn.offset = 1
        p3, o3 = loop.run(k - 1, params=p1, opt_state=o1, on_step=keep)
        change = {path: float((t.float() - params_leaf.float()).norm())
                  for (path, t), (_, params_leaf) in
                  zip(weights.leaves(p3), weights.leaves(params))}
        del p1, o1, params
        churn.offset = k
        try:
            if r.seconds > 0:
                loop.run(10**9, params=p3, opt_state=o3, on_step=window)
        except _Closed:
            pass
        finally:
            from repro_torch.obs import timeline as obs_timeline
            obs_timeline.deactivate()
    del p3, o3
    prof = st["prof"]
    if prof is not None:
        prof.__exit__(None, None, None)
    if r.seconds <= 0:          # a check-only run (the limits' readings)
        st.update(t0=0.0, t1=1.0)
    win = st["t1"] - st["t0"]
    out = {"attempted": st["n"], "failed": 0,
           "e2e": {"train_tokens_per_s": st["n"] * seq_tokens / win,
                   "setup_s": st["t0"] - r.t_start_perf},
           "window_s": win}
    out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                                if dev != "cpu" else 0)
    if prof is not None:
        red = trace.reduce(prof)
        spans = [e for e in tl.events if e.get("ph") == "X"
                 and st["tl0"] <= e["ts"] <= st["tl1"]]
        out["ctx"] = {"window_s": win, "trace": red, "spans": spans,
                      "calls": calls, "steps": st["n"],
                      "tokens": st["n"] * seq_tokens,
                      "model_flops_per_token": model_flops_per_token(
                          {**r.cfg_file, "seq": m["seq"]})}
        out["breakdown"] = red["breakdown"]
        out["busy_s"] = red["busy_s"]
        del prof
    loss_prog = [float(x) for x in losses[:k]]
    del loop, data, losses
    gc.collect()
    if dev != "cpu":
        torch.cuda.empty_cache()
    out["kept"] = {"loss": loss_prog, "grad": grad, "change": change}
    return out


def reference(r, prec: Precision, rows=None) -> Dict:
    """The reference's three steps from the seed's weights and batches."""
    from repro_torch.models.registry import get_api
    no_tf32()
    m = r.mix
    d = {**r.cfg_file["port"]["dims"], "ssd_chunk":
         r.cfg_file["port"]["ssd_chunk"]}
    spec = get_api(r.cfg).param_spec()
    flat = _flat(weights.make(spec, r.seed, r.device))
    pool = BatchPool(r.cfg.vocab_size, m["global_batch"], m["seq"], r.seed,
                     m["check_steps"], m["markov_branch"])
    batches = [{k: torch.tensor(v, device=r.device) for k, v in b.items()}
               for b in pool.batches]
    return REF.train(flat, batches, d, m["optimizer"], prec, rows=rows)


def compare(prog: Dict, ref: Dict) -> Dict:
    """The three numbers the check holds: the worst step's loss gap, and
    by the worst leaf the gap between the two sides' norms of the first
    clipped gradient and of the change over the steps, each against the
    reference's norm of that leaf or of the median leaf, whichever is
    larger. Leaves whose reference gradient is under a thousandth of the
    median leaf's are left out of the change (Adam moves them by
    round-off alone)."""
    import statistics
    loss = max(abs(a - b) for a, b in zip(prog["loss"], ref["loss"]))
    med_g = statistics.median(ref["grad"].values())
    med_c = statistics.median(ref["change"].values())
    grad = max(abs(prog["grad"][k] - v) / max(v, med_g)
               for k, v in ref["grad"].items())
    raw_med = statistics.median(ref["grad_raw"].values())
    moved = [k for k, v in ref["grad_raw"].items() if v >= 1e-3 * raw_med]
    change = max(abs(prog["change"][k] - ref["change"][k])
                 / max(ref["change"][k], med_c) for k in moved)
    return {"loss_gap": loss, "grad_norm_gap": grad,
            "change_norm_gap": change}


def check(r, kept: Dict) -> Dict:
    return compare(kept, reference(r, Precision("f32")))


def calibrate(r, controls: bool) -> Dict:
    """The program's numbers, and with ``controls`` the float8 control's
    and the faults' (half of the batch left out, the mean over the rest;
    the exchange between ranks left out reads the same: each rank keeps
    its own half), all against one float32 reference."""
    res = run(r)
    ref = reference(r, Precision("f32"))
    out = {"program": {**compare(res["kept"], ref),
                       "memory_peak_bytes": res["memory_peak_bytes"]}}
    if controls:
        out["control_fp8"] = compare(reference(r, Precision("fp8")), ref)
        out["fault_half_batch"] = compare(
            reference(r, Precision("f32"), rows=[0]), ref)
    return out
