"""While-aware analyzer for optimized (post-SPMD) HLO text.

XLA's ``cost_analysis()`` counts while-loop bodies ONCE, which makes its
flops/bytes meaningless for scan-over-layers programs (a deliberate design
choice of this framework: scans keep the 512-device compile tractable).
This module re-derives the three roofline inputs from the module text,
multiplying through the loop nest using the ``known_trip_count`` backend
config XLA attaches to compiled scans:

* flops            — 2 * prod(dot output dims) * prod(contracted dims),
                     summed over every dot, x trip counts
* hbm bytes        — fusion-boundary traffic: for every materializing op,
                     output bytes + operand bytes (post-fusion HLO, so
                     fusion internals are free, as on a real backend)
* collective bytes — output-shape bytes per collective kind

All numbers are PER-DEVICE (the SPMD module is one device's program);
callers multiply by chip count for global totals.

Copied from the JAX package for parity. The port compiles no HLO, so
nothing in it feeds this parser: ``launch/dryrun.py`` counts its terms
from the dispatched ops of a traced step instead.
"""
from __future__ import annotations

import json
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

_DTYPE_BYTES = {
    "pred": 1, "s4": 1, "u4": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2,
    "s32": 4, "u32": 4, "s64": 8, "u64": 8, "f8e4m3fn": 1, "f8e5m2": 1,
    "bf16": 2, "f16": 2, "f32": 4, "f64": 8, "c64": 8, "c128": 16,
}

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# ops that don't materialize new HBM buffers / are bookkeeping
_SKIP_BYTES = {
    "parameter", "constant", "tuple", "get-tuple-element", "bitcast",
    "while", "conditional", "call", "after-all", "partition-id",
    "replica-id", "iota",
}

_SHAPE_ATOM = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")
_INSTR = re.compile(
    r"^\s*(?:ROOT\s+)?%([\w.\-]+)\s*=\s*"
    r"((?:\(.*?\))|(?:[a-z0-9]+\[[0-9,]*\](?:\{[^}]*\})?))\s*"
    r"([\w\-]+)\(")   # tuple shapes may contain /*index=N*/ comments
# column-0 line '(ENTRY )%name (args...) -> shape {' — args may contain
# nested tuple parens, so key on the prefix only
_COMP_HDR = re.compile(r"^(?:ENTRY\s+)?%([\w.\-]+)\s*\(")
_TRIP = re.compile(r'known_trip_count[":{]+n[":]+(\d+)')


def _shape_bytes(shape_str: str) -> int:
    total = 0
    for m in _SHAPE_ATOM.finditer(shape_str):
        dt, dims = m.group(1), m.group(2)
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def _shape_dims(shape_str: str) -> List[int]:
    m = _SHAPE_ATOM.search(shape_str)
    if not m or not m.group(2):
        return []
    return [int(d) for d in m.group(2).split(",")]


@dataclass
class Instr:
    name: str
    shape: str
    opcode: str
    rest: str           # full line tail after opcode (operands + attrs)
    operands: List[str] = field(default_factory=list)


@dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    coll: Dict[str, float] = field(default_factory=dict)

    def add(self, other: "Cost", mult: float = 1.0) -> None:
        self.flops += other.flops * mult
        self.bytes += other.bytes * mult
        for k, v in other.coll.items():
            self.coll[k] = self.coll.get(k, 0.0) + v * mult

    @property
    def coll_bytes(self) -> float:
        return sum(self.coll.values())


class HloModule:
    def __init__(self, text: str):
        self.computations: Dict[str, List[Instr]] = {}
        self.entry: Optional[str] = None
        self._parse(text)
        self._memo: Dict[str, Cost] = {}

    # ------------------------------------------------------------- parsing
    def _parse(self, text: str) -> None:
        cur: Optional[str] = None
        for line in text.splitlines():
            if not line.startswith(" "):        # computation headers only
                hdr = _COMP_HDR.match(line)
                if hdr and line.rstrip().endswith("{") and "->" in line:
                    cur = hdr.group(1)
                    self.computations[cur] = []
                    if line.startswith("ENTRY"):
                        self.entry = cur
                    continue
            m = _INSTR.match(line)
            if m and cur is not None:
                name, shape, opcode = m.group(1), m.group(2), m.group(3)
                rest = line[m.end() - 1:]
                ins = Instr(name=name, shape=shape, opcode=opcode,
                            rest=rest)
                ins.operands = self._operand_names(rest)
                self.computations[cur].append(ins)
        if self.entry is None and self.computations:
            # entry is usually the last computation in the dump
            self.entry = list(self.computations)[-1]

    @staticmethod
    def _operand_names(rest: str) -> List[str]:
        """Names inside the first balanced (...) group."""
        depth = 0
        out = []
        buf = []
        for ch in rest:
            if ch == "(":
                depth += 1
                if depth == 1:
                    continue
            elif ch == ")":
                depth -= 1
                if depth == 0:
                    break
            if depth >= 1:
                buf.append(ch)
        args = "".join(buf)
        for m in re.finditer(r"%([\w.\-]+)", args):
            out.append(m.group(1))
        return out

    # ------------------------------------------------------------ analysis
    def shape_of(self, comp: str, name: str) -> str:
        for ins in self.computations.get(comp, ()):
            if ins.name == name:
                return ins.shape
        return ""

    def cost(self, comp: Optional[str] = None) -> Cost:
        comp = comp if comp is not None else self.entry
        if comp in self._memo:
            return self._memo[comp]
        total = Cost()
        self._memo[comp] = total      # guards recursion
        for ins in self.computations.get(comp, ()):
            op = ins.opcode
            if op == "while":
                trip = 1
                t = _TRIP.search(ins.rest)
                if t:
                    trip = int(t.group(1))
                body = re.search(r"body=%?([\w.\-]+)", ins.rest)
                cond = re.search(r"condition=%?([\w.\-]+)", ins.rest)
                if body:
                    total.add(self.cost(body.group(1)), trip)
                if cond:
                    total.add(self.cost(cond.group(1)), trip + 1)
                continue
            if op == "conditional":
                branches = re.findall(
                    r"(?:true_computation|false_computation|"
                    r"branch_computations=\{[^}]*)=?%?([\w.\-]+)", ins.rest)
                costs = [self.cost(b) for b in branches
                         if b in self.computations]
                if costs:
                    mx = max(costs, key=lambda c: c.flops + c.bytes)
                    total.add(mx)
                continue
            if op == "fusion":
                called = re.search(r"calls=%?([\w.\-]+)", ins.rest)
                if called:
                    inner = self.cost(called.group(1))
                    total.flops += inner.flops      # dots inside fusions
                # boundary bytes
                total.bytes += _shape_bytes(ins.shape)
                for o in ins.operands:
                    total.bytes += _shape_bytes(self.shape_of(comp, o))
                continue
            if op == "dot":
                total.flops += self._dot_flops(comp, ins)
                total.bytes += _shape_bytes(ins.shape)
                for o in ins.operands:
                    total.bytes += _shape_bytes(self.shape_of(comp, o))
                continue
            if op in COLLECTIVES or any(
                    op == c + "-start" for c in COLLECTIVES):
                kind = op.replace("-start", "")
                b = _shape_bytes(ins.shape)
                total.coll[kind] = total.coll.get(kind, 0.0) + b
                total.bytes += b
                continue
            if op in _SKIP_BYTES or op.endswith("-done"):
                continue
            # generic materializing op (copy, convert, reduce, ...)
            total.bytes += _shape_bytes(ins.shape)
            for o in ins.operands:
                total.bytes += _shape_bytes(self.shape_of(comp, o))
        self._memo[comp] = total
        return total

    def _dot_flops(self, comp: str, ins: Instr) -> float:
        out_dims = _shape_dims(ins.shape)
        lhs_shape = self.shape_of(comp, ins.operands[0]) \
            if ins.operands else ""
        lhs_dims = _shape_dims(lhs_shape)
        cdims = re.search(r"lhs_contracting_dims=\{([0-9,]*)\}", ins.rest)
        contracted = 1
        if cdims and cdims.group(1) and lhs_dims:
            for d in cdims.group(1).split(","):
                contracted *= lhs_dims[int(d)]
        n_out = 1
        for d in out_dims:
            n_out *= d
        return 2.0 * n_out * contracted


def analyze_text(text: str) -> Cost:
    return HloModule(text).cost()
