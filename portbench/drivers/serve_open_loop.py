"""Serving an open loop: the port's ``ServeEngine`` fed by a generator
that submits each request at its due time, whatever the engine is
doing, so a stall counts against every request behind it.

The mix fixes the rate, the length distributions and the slots. Every
seed replays the same schedule of request sizes and arrivals (one draw
from the mix's own ``shape_seed`` for ``rate x seconds`` requests, the
gaps scaled to fill the window), with token ids drawn from the run's
seed. Set-up makes the weights from the seed, builds the
engine and runs every (length bucket, group bucket) prefill shape and
the decode step once, then gives the engine a fresh cache (zeros, every
position empty, every slot at position 0): the window starts from the
state a new engine has. The window opens on ``torch.cuda.synchronize()``;
a request is timed from its due time to the host's read of its first
token (the end of its admission group's prefill), and each later token
to the host's read of it.

What the check compares (``reference/moe.py``, float32), once the engine
has drained and its state is freed: the window's first ``check_steps``
engine steps, replayed by the reference from that fresh cache. Each
step's admissions run through the reference's own prefill of the rows
that shared their capacity groups (the admission group as the harness
recorded it: requests, rows, bucket), which gives each admitted
request's first token and the K/V spliced into its slot; then every
slot decodes the recorded tokens at the recorded positions (idle slots
too: they take expert capacity). Besides, the first token of a sample
of the other finished requests, drawn from the seed with the longest
prompt among them. A token's gap is how far its logit lies below the
reference's best, in units of the standard deviation of the
reference's logits at that position; the number compared is the mean
gap over every compared token.
(The widest gap swings from run to run by its nature here: a routing
decision near a tie, top-k or a capacity cut-off, goes one way in bf16
and the other in float32 for a few tokens a run; see PERF.md.)
"""
from __future__ import annotations

import gc
import math
import time
from typing import Dict, List

import numpy as np
import torch

from .. import flops, trace, weights
from ..reference import moe as REF
from ..reference.common import Precision, no_tf32


def requests(m: Dict, seed: int, seconds: float) -> List[Dict]:
    """The window's requests. Their schedule (sizes, answer lengths,
    arrival gaps) is one fixed draw of the mix, from its ``shape_seed``,
    for ``rate x seconds`` requests with the gaps scaled to fill the
    window: every seed replays the same schedule. The run's seed draws
    the prompts' token ids (and the weights): the same work, other
    inputs. (Drawn in another order per seed, the p95s swung with the
    order by 19-24% across seeds against 0.3-5% between two runs of one
    seed; see PERF.md.)"""
    n = max(1, int(round(m["rate_per_s"] * seconds)))
    shape = np.random.default_rng(m["shape_seed"])
    gaps = shape.exponential(1.0, size=n)
    gaps *= seconds / gaps.sum()

    def lengths(med, sigma, lo, hi):
        v = np.exp(np.log(med) + sigma * shape.standard_normal(n))
        return np.clip(np.rint(v), lo, hi).astype(np.int64)
    plen = lengths(m["prompt_median"], m["prompt_sigma"], m["prompt_min"],
                   m["prompt_max"])
    new = lengths(m["new_median"], m["new_sigma"], m["new_min"],
                  m["new_max"])
    rng = np.random.default_rng(seed)
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    return [{"rid": i, "due": float(due[i]),
             "prompt": rng.integers(1, m["vocab"], size=int(plen[i]),
                                    dtype=np.int64).astype(np.int32),
             "max_new": int(new[i])} for i in range(n)]


def active_params(d: Dict) -> int:
    """Matmul parameters a token passes through in the decoder layers:
    attention's projections, its top-k experts and the router."""
    D, F_ = d["d_model"], d["d_ff"]
    H, Kh = d["n_heads"], d["n_kv_heads"]
    hd = d["head_dim"] or D // H
    return d["n_layers"] * (2 * D * H * hd + 2 * D * Kh * hd
                            + d["top_k"] * 3 * D * F_ + D * d["n_experts"])


def prefill_flops(d: Dict, L: int) -> float:
    """Model FLOPs of one prompt of L tokens: 2 per matmul parameter
    applied (attention, the top-k experts, the router) at every prompt
    token, the head once (the next token), and the causal windowed
    attention."""
    D, V, H = d["d_model"], d["vocab_size"], d["n_heads"]
    hd = d["head_dim"] or D // H
    attn = d["n_layers"] * flops.attention_fwd_flops(
        1, H, L, L, hd, True, d["sliding_window"])
    return 2 * active_params(d) * L + 2 * D * V + attn


def decode_flops(d: Dict, n_ctx: int) -> float:
    """Model FLOPs of one decode token over ``n_ctx`` visible keys."""
    D, V, H = d["d_model"], d["vocab_size"], d["n_heads"]
    hd = d["head_dim"] or D // H
    return 2 * active_params(d) + 2 * D * V + d["n_layers"] * \
        flops.decode_flops(H, hd, n_ctx)


class _Rec:
    """What the harness records around the engine (host side)."""

    def __init__(self):
        self.groups = []          # admission groups, in order
        self.steps = []           # check steps: (token_b, pos_b, active,
                                  # admission groups so far)
        self.window_groups = 0    # admission groups before the window
        self.checking = False
        self.check_steps = 0
        self.timing = False       # inside the window
        self.admit_s = []         # window admission groups' host seconds
        self.first = {}           # rid -> host time of its first token


def run(r) -> Dict:
    from repro_torch.models.registry import get_api
    from repro_torch.serve.engine import Request, ServeEngine

    m, dev = r.mix, r.device
    d = r.cfg_file["port"]["dims"]
    api = get_api(r.cfg)
    params = weights.make(api.param_spec(), r.seed, dev)
    eng = ServeEngine(api, params, batch=m["batch"], window=m["window"])
    if r.fault is not None:
        r.fault(eng)
    rec = _Rec()
    sync = (lambda: torch.cuda.synchronize(dev)) if dev != "cpu" else (
        lambda: None)

    admit = eng._admit_bulk

    def admit_bulk(group, bucket):
        t = time.perf_counter()
        admit(group, bucket)
        now = time.perf_counter()
        rec.groups.append({"bucket": bucket,
                           "rows": eng._bucket_group(len(group)),
                           "rids": [q.rid for _, q in group],
                           "slots": [s for s, _ in group]})
        for _, q in group:
            rec.first.setdefault(q.rid, now)
        if rec.timing:
            rec.admit_s.append(now - t)
    eng._admit_bulk = admit_bulk
    dispatch = eng._dispatch

    def dispatch_rec(token_b, pos_b):
        if rec.checking and len(rec.steps) < rec.check_steps:
            act = [(i, q.rid, len(q.out)) for i, q in
                   enumerate(eng.slot_req) if q is not None]
            rec.steps.append((token_b.copy(), pos_b.copy(), act,
                              len(rec.groups)))
        return dispatch(token_b, pos_b)
    eng._dispatch = dispatch_rec

    # set-up: every (length bucket, group bucket) prefill shape, then the
    # decode step, once each
    rid = -1
    warm_rng = np.random.default_rng(0)
    for L in m["warm_lengths"]:
        for g in m["warm_groups"]:
            for _ in range(g):
                eng.submit(Request(rid=rid, prompt=warm_rng.integers(
                    1, m["vocab"], size=L, dtype=np.int64).astype(np.int32),
                    max_new=2))
                rid -= 1
            eng.step()
            while any(q is not None for q in eng.slot_req) or eng.queue:
                eng.step()
    # the window starts from a fresh cache, which the reference rebuilds
    # without reading the program's (the warm-up's stale slots would
    # take expert capacity in every decode step)
    eng.state = None
    eng.state = api.init_decode_state(m["batch"], m["window"], dev)
    eng.slot_pos[:] = 0
    sync()
    reqs = requests(m, r.seed, r.seconds)
    by_rid = {q["rid"]: q for q in reqs}
    objs: Dict[int, Request] = {}
    times: Dict[int, List[float]] = {}
    lag = []
    queue = []                # the queue's length before each step
    step_s = []               # (host seconds, admitted this step)
    calls = {"pb.flash_attention": [], "pb.flash_decode": []}
    nvalid = []
    marks = []
    if r.trace:
        from repro_torch.models import attention as A
        from repro_torch.models import moe as MOE

        def fa_call(q, k, v, causal=True, sliding_window=None):
            if rec.timing:
                B, H, Sq, hd = q.shape
                Kh, Sk = k.shape[1], k.shape[2]
                calls["pb.flash_attention"].append(
                    (flops.attention_fwd_flops(B, H, Sq, Sk, hd, causal,
                                               sliding_window),
                     flops.attention_fwd_bytes(B, H, Kh, Sq, Sk, hd,
                                               q.element_size())))

        def fd_call(q, k, v, valid):
            if rec.timing:
                nvalid.append((q.shape, k.shape, q.element_size(),
                               valid.sum()))
        marks = [(A, "flash_attention", "pb.flash_attention", fa_call),
                 (A, "flash_decode", "pb.flash_decode", fd_call),
                 (MOE, "moe_apply", "pb.moe", None)]
    n = len(reqs)
    last_due = reqs[-1]["due"]
    rec.check_steps = m["check_steps"]
    prof = None
    with trace.marked(marks):
        if r.trace:
            prof = trace.profiler()
            prof.__enter__()
        sync()
        t0 = time.perf_counter()
        rec.timing = rec.checking = True
        rec.window_groups = len(rec.groups)
        i = 0
        deadline = r.seconds + m["drain_limit_s"]
        while True:
            now = time.perf_counter() - t0
            while i < n and reqs[i]["due"] <= now:
                q = reqs[i]
                o = Request(rid=q["rid"], prompt=q["prompt"],
                            max_new=q["max_new"])
                objs[q["rid"]] = o
                times[q["rid"]] = []
                eng.submit(o)
                lag.append(now - q["due"])
                i += 1
            busy = eng.queue or any(q is not None for q in eng.slot_req)
            if not busy:
                if i == n:
                    break
                time.sleep(max(0.0, min(reqs[i]["due"] - now, 0.002)))
                continue
            if now > deadline:
                break
            g0 = len(rec.groups)
            queue.append((now, len(eng.queue)))
            ts = time.perf_counter()
            eng.step()
            te = time.perf_counter()
            step_s.append((te - ts, len(rec.groups) > g0))
            for rid_, o in objs.items():
                tl = times[rid_]
                while len(tl) < len(o.out):
                    tl.append(rec.first[rid_] if not tl else te)
        sync()
        t_end = time.perf_counter()
        rec.timing = False
    out = {"memory_peak_bytes": (torch.cuda.max_memory_allocated(dev)
                                 if dev != "cpu" else 0)}
    ttft, tpot, failed = [], [], 0
    for q in reqs:
        o, tl = objs.get(q["rid"]), times.get(q["rid"], [])
        if o is None or len(tl) < q["max_new"]:
            failed += 1
            ttft.append(math.inf)
            continue
        ttft.append(tl[0] - (t0 + q["due"]))
        tpot.extend(np.diff(tl).tolist())
    out["attempted"], out["failed"] = n, failed
    out["e2e"] = {"ttft_p95_ms": 1e3 * _p95(ttft),
                  "tpot_p95_ms": 1e3 * _p95(tpot),
                  "setup_s": t0 - r.t_start_perf}
    out["window_s"] = t_end - t0
    last = max((tl[-1] for tl in times.values() if tl), default=t_end)
    out["load"] = {"done_per_s": (n - failed) / (last - t0),
                   "queue_max": max((q for _, q in queue), default=0),
                   "queue_at_last_due": max([q for t, q in queue
                                             if t <= last_due][-1:] or [0]),
                   "drain_s": t_end - t0 - last_due,
                   "decode_step_ms": 1e3 * float(np.median(
                       [s_ for s_, adm in step_s if not adm] or [0.0]))}
    if prof is not None:
        prof.__exit__(None, None, None)
        red = trace.reduce(prof)
        dec = []
        for qs, ks, isz, nv in nvalid:
            v = int(nv)
            B, H, hd = qs
            Kh, Wk = ks[1], ks[2]
            dec.append((flops.decode_flops(H, hd, v),
                        flops.decode_bytes(B, H, Kh, Wk, hd, v, isz)))
        calls["pb.flash_decode"] = dec
        pf = sum(prefill_flops(d, len(by_rid[x]["prompt"]))
                 for g in rec.groups for x in g["rids"] if x >= 0)
        dsteps = [s for s, adm in step_s if not adm]
        dtok = 0.0
        for q in reqs:
            o = objs.get(q["rid"])
            if o is None:
                continue
            L = len(q["prompt"])
            for j in range(1, len(o.out)):
                dtok += decode_flops(d, min(L + j, d["sliding_window"]
                                            or math.inf))
        out["ctx"] = {"window_s": out["window_s"], "trace": red,
                      "calls": calls, "admit_s": rec.admit_s,
                      "decode_only_s": dsteps, "lag_s": lag,
                      "prefill_flops": pf, "decode_flops": dtok,
                      "step_s": [s for s, _ in step_s]}
        out["breakdown"] = red["breakdown"]
        out["busy_s"] = red["busy_s"]
        del prof
    served = {q: list(o.out) for q, o in objs.items()}
    steps, groups, g0 = rec.steps, rec.groups, rec.window_groups
    del eng, params, objs, rec
    gc.collect()
    if dev != "cpu":
        torch.cuda.empty_cache()
    out["kept"] = {"by_rid": by_rid, "served": served, "groups": groups,
                   "steps": steps, "window_groups": g0}
    return out


def _p95(v: List[float]) -> float:
    if not v:
        return math.inf
    return float(np.percentile(np.asarray(v, dtype=np.float64), 95))


def _blocks(g: Dict, by_rid: Dict, group_size: int):
    """Admission group ``g``'s rows in the blocks that share capacity
    groups, as the token matrix the engine built (prompts left-aligned,
    zero ids after them and in the pad rows): [(tokens, [(row within
    the block, rid, slot)])] for every block that holds a request."""
    bucket, rows = g["bucket"], g["rows"]
    mat = np.zeros((rows, bucket), np.int32)
    for j, x in enumerate(g["rids"]):
        p = by_rid[x]["prompt"]
        mat[j, :len(p)] = p
    T = rows * bucket
    per = max(1, min(group_size or T, T) // bucket)   # rows a group spans
    members = list(zip(g["rids"], g["slots"]))
    return [(mat[lo:lo + per],
             [(j - lo, x, s) for j, (x, s) in enumerate(members)
              if lo <= j < lo + per])
            for lo in range(0, len(members), per)]


def sample(by_rid: Dict, served: Dict, groups: List[Dict], n: int,
           seed: int) -> List[int]:
    """``n`` finished requests drawn from the seed, the longest prompt
    among the finished always in."""
    done = [g_rid for g in groups for g_rid in g["rids"]
            if g_rid >= 0 and len(served.get(g_rid, ())) ==
            by_rid[g_rid]["max_new"]]
    if not done:
        return []
    longest = max(done, key=lambda x: len(by_rid[x]["prompt"]))
    rng = np.random.default_rng(seed + 7)
    rest = [x for x in done if x != longest]
    pick = list(rng.choice(rest, size=min(n - 1, len(rest)),
                           replace=False)) if rest else []
    return [longest] + [int(x) for x in pick]


def _first_gaps(params, d, by_rid, served, g, dev, ref, ctl, only=None):
    """The first token of each request of admission group ``g`` (or of
    those in ``only``): {rid: its gap}, and {rid: per layer (k, v)} of
    the reference's prefill and of ``ctl``'s (where given: it then picks
    the token compared)."""
    gaps, kv, kv_ctl = {}, {}, {}
    for mat, mem in _blocks(g, by_rid, d["moe_group_size"]):
        mem = [m_ for m_ in mem if only is None or m_[1] in only]
        if not mem:
            continue
        tok = torch.tensor(mat, device=dev)
        want = [(row, len(by_rid[x]["prompt"]) - 1) for row, x, _ in mem]
        rows = tuple(row for row, _, _ in mem)
        lg, kv_r = REF.prefill(params, tok, want, d, ref, keep_kv=rows)
        if ctl is not None:
            lc, kc_r = REF.prefill(params, tok, want, d, ctl, keep_kv=rows)
            pick = torch.argmax(lc, dim=-1)
        else:
            pick = torch.tensor([served[x][0] for _, x, _ in mem],
                                device=dev)
        for i, (row, x, _) in enumerate(mem):
            gaps[x] = float(REF.gap(lg[i][None], pick[i][None])[0])
            kv[x] = kv_r[row]
            if ctl is not None:
                kv_ctl[x] = kc_r[row]
    return gaps, kv, kv_ctl


def check(r, kept: Dict, control: bool = False, gaps_out=None) -> Dict:
    """The numbers compared (see the module's docstring). With
    ``control``, the gaps are of the tokens the float8 reference puts
    first at the same positions, the float8 reference replaying the
    steps. ``gaps_out`` (a dict) receives every token's gap."""
    by_rid, served, groups = kept["by_rid"], kept["served"], kept["groups"]
    from repro_torch.models.registry import get_api
    no_tf32()
    dev = r.device
    d = r.cfg_file["port"]["dims"]
    params = weights.make(get_api(r.cfg).param_spec(), r.seed, dev)
    ctl = Precision("fp8") if control else None
    first, dec = _replay(params, d, by_rid, served, groups, kept["steps"],
                         kept["window_groups"], r.mix["window"], dev,
                         Precision("f32"), ctl)
    group_of = {x: g for g in groups for x in g["rids"]}
    for rid in sample(by_rid, served, groups, r.mix["check_requests"],
                      r.seed):
        if rid not in first:
            first.update(_first_gaps(params, d, by_rid, served,
                                     group_of[rid], dev, Precision("f32"),
                                     ctl, only=(rid,))[0])
    if gaps_out is not None:
        gaps_out.update(first=list(first.values()), decode=dec,
                        tokens=len(first) + len(dec))
    every = list(first.values()) + dec
    return {"mean_token_gap": sum(every) / max(len(every), 1)}


def _replay(params, d, by_rid, served, groups, steps, g0, W, dev, ref,
            ctl):
    """The reference's run of the window's first recorded engine steps,
    from the fresh cache the window starts with (float32 K/V of zeros,
    every position empty): ({rid: first token's gap} of the requests
    admitted in them, [every decoded token's gap]). With ``ctl``, the
    control's prefills and decodes fill its own cache and pick the
    tokens compared."""
    if not steps:
        return {}, []
    B = len(steps[0][0])
    H, Kh = d["n_heads"], d["n_kv_heads"]
    hd = d["head_dim"] or d["d_model"] // H

    def empty():
        return [{"k": torch.zeros(B, W, Kh, hd, device=dev),
                 "v": torch.zeros(B, W, Kh, hd, device=dev),
                 "pos": torch.full((B, W), -1, dtype=torch.int32,
                                   device=dev)}
                for _ in range(d["n_layers"])]
    caches = {"ref": empty()}
    if ctl is not None:
        caches["ctl"] = empty()
    first, gaps = {}, []
    done_groups = g0
    for token_b, pos_b, act, n_groups in steps:
        # admissions at this step's boundary: the reference's prefill,
        # each request's K/V spliced into its slot
        for g in groups[done_groups:n_groups]:
            g_first, kv_ref, kv_ctl = _first_gaps(
                params, d, by_rid, served, g, dev, ref, ctl)
            first.update(g_first)
            for rid, slot in zip(g["rids"], g["slots"]):
                Lp = len(by_rid[rid]["prompt"])
                for name, src in (("ref", kv_ref), ("ctl", kv_ctl)):
                    if name not in caches:
                        continue
                    for l, (k, v) in enumerate(src[rid]):
                        c = caches[name][l]
                        c["k"][slot, :k.shape[0]] = k
                        c["v"][slot, :v.shape[0]] = v
                        c["pos"][slot] = -1
                        c["pos"][slot, :Lp] = torch.arange(
                            Lp, dtype=c["pos"].dtype, device=dev)
        done_groups = n_groups
        tok = torch.tensor(token_b, device=dev)
        t = torch.tensor(pos_b, device=dev)
        lg = REF.decode(params, caches["ref"], tok, t, d, ref)
        if ctl is not None:
            lc = REF.decode(params, caches["ctl"], tok, t, d, ctl)
        for slot, rid, n_out in act:
            if n_out >= len(served[rid]):
                continue
            want = (torch.argmax(lc[slot]) if ctl is not None
                    else torch.tensor(served[rid][n_out], device=dev))
            gaps.append(float(REF.gap(lg[slot][None], want[None])[0]))
    return first, gaps


def _gap_summary(g: Dict) -> Dict:
    every = sorted(g["first"] + g["decode"], reverse=True)
    return {"tokens": g["tokens"], "first_tokens": len(g["first"]),
            "nonzero": sum(1 for x in every if x > 0), "widest": every[:10]}


def calibrate(r, controls: bool) -> Dict:
    """The program's numbers, and with ``controls`` the float8 control's,
    from one run's records, with how many tokens were compared and the
    widest gaps."""
    res = run(r)
    g = {}
    out = {"program": {**check(r, res["kept"], gaps_out=g),
                       "memory_peak_bytes": res["memory_peak_bytes"],
                       "attempted": res["attempted"],
                       "failed": res["failed"], **res["e2e"],
                       **res["load"]}}
    out["program_gaps"] = _gap_summary(g)
    if controls:
        g = {}
        out["control_fp8"] = check(r, res["kept"], control=True, gaps_out=g)
        out["control_gaps"] = _gap_summary(g)
    return out
