"""Batched serving engine: prefill -> decode with KV-cache handoff.
Port of ``repro/serve/engine.py``.

Continuous-batching-lite with a **phase-gated** slot refill: the decode
batch is a phaser team — every decode step is one phase, each occupied
slot is a participant, and batch-membership changes ride the same epoch
mechanism as elastic training:

* a request entering a free slot is a JOIN (the paper's eager insertion:
  prefill + cache splice happen immediately, at the step boundary, and
  no running request is disturbed);
* a finished request is a LEAVE (deletion: the phase completes without
  it and the slot is reclaimed);
* the runtime's epoch index versions the batch composition — the swap is
  observable only at phase boundaries, so a step never sees a
  half-admitted batch.

Admission is **bulk**: all free slots are filled at the same phase
boundary, grouped by prompt length padded up to a power-of-two bucket,
with the group size padded up to a power-of-two row bucket too (clamped
to the slot count), so the prefill sees one shape per (length bucket,
group bucket). Each group runs one full-logits prefill over the padded
prompts; causality keeps every position below a request's true length
unaffected by the pad tail, so the engine reads each request's next
token at its own ``len - 1`` and splices the bucket's KV into the slot's
cache region with only the first ``len`` positions marked valid. Prompts
longer than the cache window take the token-by-token path.

An MoE prompt token's output depends on the other rows of its
admission group (the pad rows included): experts have a per-group
capacity, as in the reference, whose engine pads and groups the same
way.

Families whose decode state is a **recurrence** (plain ssm, hybrid)
cannot splice a full-logits prefill's caches: their state is the carry
after the prompt, not a per-position buffer. They get their own bulk
path (``ModelAPI.prefill_state_fn``): one length-masked decode pass over
the padded group (a row's state freezes at its true length), spliced
into the admitted slots with one indexed write per state leaf.
Enc-dec and the VLM backbone admit token by token from a zero state, as
the reference's engine does: it never fills the cross K/V nor passes
patches (their meaningful runs go through ``ModelAPI``'s prefill, then
decode).

The port updates the decode cache IN PLACE (the decode step writes its
slot; the splice writes the admitted slots' regions), where the JAX
engine builds a new state each time. Inputs are copied to the device
from a fresh snapshot of the host buffer, which the engine mutates right
after dispatch.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.registry import ModelAPI
from ..obs.metrics import MetricsRegistry
from ..obs.timeline import span
from ..runtime_elastic.elastic_phaser import ElasticPhaserRuntime


@dataclass
class Request:
    rid: int
    prompt: np.ndarray              # (S,) int32
    max_new: int = 16
    out: List[int] = field(default_factory=list)
    done: bool = False
    t_submit: float = 0.0           # stamped by submit(); queue-wait base


def _tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


class ServeEngine:
    def __init__(self, api: ModelAPI, params, *, batch: int = 4,
                 window: int = 256, seed: int = 0):
        self.api = api
        self.cfg = api.cfg
        self.params = params
        self.device = params["embed"].device
        self.batch = batch
        self.window = window
        self.state = api.init_decode_state(batch, window, self.device)
        self.slot_req: List[Optional[Request]] = [None] * batch
        self.slot_pos = np.zeros((batch,), np.int32)
        self.queue: List[Request] = []
        # control plane: occupied slots are phaser participants; admission
        # keys are monotone (a slot reused by a later request is a new
        # participant — phaser keys are never recycled)
        self.gate = ElasticPhaserRuntime(0, seed=seed, axis_name="slots")
        self.slot_key: List[Optional[int]] = [None] * batch
        self.finished: List[Request] = []
        # per-engine metrics shard: prefill shapes, admission kinds,
        # retire counts, decode occupancy and latency histograms.
        # ``serve.prefill.traces`` counts distinct prefill shapes (the
        # JAX engine's lowerings), so the name means the same in both.
        self.metrics = MetricsRegistry()
        self._prefill_shapes = set()
        self._prefill_state_shapes = set()
        # per-leaf batch dim: splices a slot without touching the others
        self._bdim = api.decode_state_bdims(batch, window)
        # KV bulk admission (dense and MoE: their decode state is the
        # stacked KV cache the prefill's caches splice into); recurrent
        # families take the length-masked decode-pass bulk path; enc-dec
        # and the VLM backbone admit token by token, as in the reference
        self._bulk = self.cfg.family in ("dense", "moe")
        self._kv_window = (self.state["layers"]["k"].shape[2] if self._bulk
                           else 0)
        self._bulk_rec = self.cfg.family in ("ssm", "hybrid")

    @property
    def prefill_traces(self) -> int:
        """Compat view: distinct full-logits prefill shapes."""
        return self.metrics.counter("serve.prefill.traces").value

    @property
    def epoch(self) -> int:
        """Batch-membership epoch (bumps at the boundary after any
        admit/retire, exactly like the training runtime)."""
        return self.gate.epoch.index

    def _to_device(self, buf: np.ndarray) -> torch.Tensor:
        """A fresh snapshot of a host buffer the caller mutates next."""
        return torch.tensor(np.array(buf, dtype=np.int32, copy=True),
                            device=self.device)

    def _splice_slot(self, old_state, new_state, slot: int):
        """Keep ``new_state`` only at ``slot``; other slots keep ``old``
        (admitting a request must not disturb running ones). Builds new
        tensors, so neither input is aliased by the result."""
        def f(o, n, d):
            idx = torch.arange(o.shape[d], device=o.device)
            shape = [1] * o.ndim
            shape[d] = -1
            return torch.where((idx == slot).view(shape), n, o)
        return _tree_map(f, old_state, new_state, self._bdim)

    def _dispatch(self, token_b: np.ndarray, pos_b: np.ndarray):
        return self.api.decode_fn(
            self.params, self.state,
            {"token": self._to_device(token_b), "t": self._to_device(pos_b)})

    # ------------------------------------------------------------- intake
    def submit(self, req: Request) -> None:
        req.t_submit = time.perf_counter()
        self.queue.append(req)

    @staticmethod
    def _bucket_len(length: int) -> int:
        """Prompt lengths pad up to power-of-two buckets."""
        return 1 << max(0, (length - 1)).bit_length()

    def _bucket_group(self, n: int) -> int:
        """Admission group sizes pad up to power-of-two ROW buckets,
        clamped to the slot count."""
        return min(self._bucket_len(max(1, n)), self.batch)

    def _admit(self) -> None:
        """Phase-boundary refill: fill ALL free slots from the queue at
        this boundary (JOIN = eager insertion). Groups of one length
        bucket run one padded prefill (KV families) or one length-masked
        decode pass (recurrent families) each and splice their states
        in; prompts beyond the window take token-by-token admission."""
        admits: List[Tuple[int, Request]] = []
        for slot in range(self.batch):
            if self.slot_req[slot] is None and self.queue:
                admits.append((slot, self.queue.pop(0)))
        groups: Dict[Tuple[str, int], List[Tuple[int, Request]]] = {}
        for slot, req in admits:
            # clamp to the window so a non-pow2 window keeps its largest
            # admissible prompts on the bulk path
            L = len(req.prompt)
            if self._bulk and L <= self._kv_window:
                bucket = min(self._bucket_len(L), self._kv_window)
                groups.setdefault(("kv", bucket), []).append((slot, req))
            elif self._bulk_rec and L <= self.window:
                bucket = min(self._bucket_len(L), self.window)
                groups.setdefault(("rec", bucket), []).append((slot, req))
            else:
                self.metrics.inc("serve.admit.sequential")
                self._admit_sequential(slot, req)
        for (kind, bucket), group in sorted(groups.items()):
            self.metrics.inc(f"serve.admit.{kind}", len(group))
            self.metrics.observe("serve.admit.group_size", len(group))
            if kind == "kv":
                self._admit_bulk(group, bucket)
            else:
                self._admit_bulk_recurrent(group, bucket)

    def _admit_bulk(self, group: List[Tuple[int, "Request"]],
                    bucket: int) -> None:
        """One padded prefill forward over the whole group (rows padded
        to the pow2 group bucket), then splice each slot's cache region
        (running slots untouched; the pad rows never reach the cache)."""
        G = len(group)
        lengths = [len(r.prompt) for _, r in group]
        tokens = np.zeros((self._bucket_group(G), bucket), np.int32)
        for g, (_, r) in enumerate(group):
            tokens[g, :lengths[g]] = r.prompt
        if tokens.shape not in self._prefill_shapes:
            self._prefill_shapes.add(tokens.shape)
            self.metrics.inc("serve.prefill.traces")
        with span("serve.prefill"):
            logits, caches = self.api.prefill_full_fn(
                self.params, {"tokens": self._to_device(tokens)})
        with span("serve.splice"):
            self._splice_prefill(caches, [s for s, _ in group], lengths)
        with span("serve.first_read"):
            # next token at each request's own last REAL position
            last = logits[torch.arange(G, device=self.device),
                          torch.tensor(lengths, device=self.device) - 1]
            nxt = torch.argmax(last, dim=-1).cpu().numpy()
        for g, (slot, req) in enumerate(group):
            self._occupy(slot, req, int(nxt[g]), lengths[g])

    def _splice_prefill(self, caches, slots: List[int],
                        lengths: List[int]) -> None:
        """Write the prefilled per-layer KV into the admitted slots'
        cache regions, in place, one indexed write per tensor over the
        whole group: k/v take the entire padded bucket, and the pos mask
        validates only 0..len_i-1 per slot, so the pad tail's KV stays
        masked out of attention exactly as if it were never written."""
        st = self.state["layers"]
        pf = caches["layers"]
        G = len(slots)
        bucket = pf["k"].shape[2]
        sl = torch.tensor(slots, device=self.device)
        pos = torch.arange(bucket, dtype=torch.int32, device=self.device)
        valid = pos[None] < torch.tensor(lengths, dtype=torch.int32,
                                         device=self.device)[:, None]
        st["k"][:, sl, :bucket] = pf["k"][:, :G].to(st["k"].dtype)
        st["v"][:, sl, :bucket] = pf["v"][:, :G].to(st["v"].dtype)
        # invalidate the slot's WHOLE window first: a reused slot whose
        # previous prompt was longer than this bucket would otherwise
        # keep stale attendable pos rows beyond the new region
        st["pos"][:, sl] = -1
        st["pos"][:, sl, :bucket] = torch.where(
            valid, pos[None], torch.full_like(pos[None], -1)).expand(
                st["pos"].shape[0], G, bucket)

    def _admit_bulk_recurrent(self, group: List[Tuple[int, "Request"]],
                              bucket: int) -> None:
        """Bulk admission for recurrent-state families: ONE length-masked
        decode pass over the padded group (``prefill_state_fn``) gives
        every request's final state and its next-token logits at its own
        ``len - 1``; the states splice into the admitted slots (running
        slots untouched). The group pads to the pow2 group bucket (pad
        rows run length-1 dummies and are sliced away)."""
        G = len(group)
        Gp = self._bucket_group(G)
        lengths = [len(r.prompt) for _, r in group]
        tokens = np.zeros((Gp, bucket), np.int32)
        for g, (_, r) in enumerate(group):
            tokens[g, :lengths[g]] = r.prompt
        pad_lens = np.ones((Gp,), np.int32)
        pad_lens[:G] = lengths
        if tokens.shape not in self._prefill_state_shapes:
            self._prefill_state_shapes.add(tokens.shape)
            self.metrics.inc("serve.prefill_state.traces")
        with span("serve.prefill"):
            logits, gstate = self.api.prefill_state_fn(
                self.params, self._to_device(tokens),
                self._to_device(pad_lens), window=self.window)
        with span("serve.splice"):
            self._splice_state_group(gstate, [s for s, _ in group])
        with span("serve.first_read"):
            nxt = torch.argmax(logits[:G], dim=-1).cpu().numpy()
        for g, (slot, req) in enumerate(group):
            self._occupy(slot, req, int(nxt[g]), lengths[g])

    def _splice_state_group(self, gstate, slots: List[int]) -> None:
        """Write a group-batched decode state (its batch = the group, pad
        rows after it) into the live state's admitted slots, in place,
        one indexed write per leaf along its batch dim."""
        sl = torch.tensor(slots, device=self.device)

        def f(o, n, d):
            o.index_copy_(d, sl, n.narrow(d, 0, len(slots)).to(o.dtype))
        _tree_map(f, self.state, gstate, self._bdim)

    def _admit_sequential(self, slot: int, req: "Request") -> None:
        """Admission for prompts beyond the cache window (and for every
        prompt when bulk admission is off): prefill via decode steps
        over the whole batch (the other slots decode token 0 at their
        positions, as in the reference), then keep only this slot's new
        state."""
        old_state = self.state
        # a REUSED slot still holds the previous request's state: a
        # recurrent carry or stale KV pos rows would leak into this
        # prefill, so reset the slot to a fresh init first
        self.state = self._splice_slot(
            old_state,
            self.api.init_decode_state(self.batch, self.window, self.device),
            slot)
        token_b = np.zeros((self.batch,), np.int32)
        logits = None
        for t, tok in enumerate(req.prompt):
            token_b[slot] = tok
            logits, self.state = self._dispatch(token_b,
                                                self._pos_with(slot, t))
        self.state = self._splice_slot(old_state, self.state, slot)
        self._occupy(slot, req, int(torch.argmax(logits[slot])),
                     len(req.prompt))

    def _occupy(self, slot: int, req: "Request", first_tok: int,
                length: int) -> None:
        # admission completes here: submit -> first token in a slot is
        # the request's queue wait (histogram buckets give p50/p99)
        if req.t_submit:
            self.metrics.observe("serve.admit.queue_wait_seconds",
                                 time.perf_counter() - req.t_submit)
        req.out.append(first_tok)
        with span("serve.join"):
            self.slot_key[slot] = self.gate.request_join()
        self.slot_req[slot] = req
        self.slot_pos[slot] = length
        if len(req.out) >= req.max_new:
            req.done = True
            self._retire(slot)

    def _retire(self, slot: int) -> None:
        """LEAVE: the finished request's participant deregisters; the
        slot is reclaimed for the next boundary's refill."""
        self.finished.append(self.slot_req[slot])
        self.metrics.inc("serve.retired")
        with span("serve.leave"):
            self.gate.request_leave(self.slot_key[slot])
        self.slot_key[slot] = None
        self.slot_req[slot] = None

    def _pos_with(self, slot: int, t: int) -> np.ndarray:
        pos = self.slot_pos.copy()
        pos[slot] = t
        return pos

    # -------------------------------------------------------------- serve
    def step(self) -> int:
        """One decode step == one phase over the live batch; returns the
        number of active slots. Membership changes (admits at the leading
        boundary, retires at the trailing one) land as gate epochs.
        Inactive slots decode too (token 0 at their stale position), as
        in the reference, so both engines' caches evolve alike.

        Its spans: ``serve.step`` around it, made of ``serve.admit``
        (the refill: per group ``serve.prefill``, ``serve.splice`` and
        ``serve.first_read``, the host's wait for the first tokens),
        ``serve.decode`` (``serve.decode.launch``, the enqueue of the
        decode step; ``serve.decode.read``, the host's wait for its
        tokens; the slots' bookkeeping) and ``serve.advance`` (the
        gate's phase); ``serve.join`` and ``serve.leave`` wherever a
        slot joins or leaves the gate."""
        with span("serve.step"):
            with span("serve.admit"):
                self._admit()
            with span("serve.decode"):
                n = self._decode()
            # a step that decoded nothing still lands the churn of
            # requests admitted and retired inside _admit (e.g. max_new
            # reached at prefill) as an epoch at this boundary
            if n or self.gate.pending_churn:
                # the step's phase: every live participant signals, the
                # advance marks the boundary where this step's churn
                # becomes the new epoch
                with span("serve.advance"):
                    self.gate.advance()
        return n

    def _decode(self) -> int:
        """The decode step over every slot, its tokens read back and
        each active slot's request advanced (retired when done)."""
        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        self.metrics.set("serve.occupancy", len(active))
        self.metrics.observe("serve.active_slots", len(active))
        if not active:
            return 0
        token_b = np.zeros((self.batch,), np.int32)
        for i in active:
            r = self.slot_req[i]
            token_b[i] = r.out[-1] if r.out else r.prompt[-1]
        self.metrics.inc("serve.decode.steps")
        t0 = time.perf_counter()
        with span("serve.decode.launch"):
            logits, self.state = self._dispatch(token_b, self.slot_pos)
        with span("serve.decode.read"):
            nxt = torch.argmax(logits, dim=-1).cpu().numpy()
        # the copy to the host waited for the device: this is the real
        # per-token decode latency of the whole batch
        self.metrics.observe("serve.decode.token_seconds",
                             time.perf_counter() - t0)
        for i in active:
            r = self.slot_req[i]
            r.out.append(int(nxt[i]))
            self.slot_pos[i] += 1
            if len(r.out) >= r.max_new:
                r.done = True
                self._retire(i)     # slot freed -> next boundary refills
        return len(active)

    def run_until_drained(self, max_steps: int = 10_000) -> List[Request]:
        """Drive steps until queue and batch are empty; returns the
        requests finished during the drain, in completion order."""
        mark = len(self.finished)
        for _ in range(max_steps):
            n = self.step()
            if n == 0 and not self.queue:
                break
        return self.finished[mark:]
