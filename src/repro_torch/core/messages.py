"""Message vocabulary for the distributed-phaser protocol.

The poster's Table 1 names eight message classes used during eager insertion
(TUS, TDS, MURS, MULS-1/2/3, AT, ENSP) without expanding the acronyms; we
define a concrete protocol with the same structure (DESIGN.md §10) and keep the
acronyms. Additional classes cover signaling (SIG), phase advance (ADV),
registration accounting (ENSP/DEREG deltas), deletion (UNL), neighbor updates
(PRV) and combine-set maintenance (CHILD_ADD / CHILD_DEL).

``lid`` selects the list: 0 = SCSL (signal collection), 1 = SNSL (signal
notification). Every message is a frozen dataclass so the model checker can
hash states.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class Msg:
    """Base class. ``src``/``dst`` are participant ids (ranks)."""

    src: int
    dst: int

    @property
    def kind(self) -> str:
        return type(self).__name__

    def replace(self, **kw) -> "Msg":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Search phase of eager insertion (paper Fig. 2 steps 1-2).
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class TUS(Msg):
    """Traverse-Up-Search: ascend express lanes toward the insertion region."""

    key: int          # key (rank) of the node being inserted
    new_id: int       # id of the joining node
    lid: int = 0


@dataclass(frozen=True)
class TDS(Msg):
    """Traverse-Down-Search: descend toward the level-0 predecessor."""

    key: int
    level: int
    new_id: int
    lid: int = 0


# ---------------------------------------------------------------------------
# Splice phase ("fast single-link-modify", Fig. 2 steps 3-5).
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class MURS(Msg):
    """Modify-Right-Splice: ask predecessor ``dst`` to set next0 := new node.
    (In our flow the search terminates at the predecessor, which splices
    locally; MURS appears explicitly when the search initiator is already the
    predecessor's neighbor.)"""

    new_id: int
    lid: int = 0


@dataclass(frozen=True)
class MURS_ACK(Msg):
    """Predecessor's reply to the new node: old successor at level 0 plus the
    phase the new node first participates in (assigned by the predecessor —
    its lowest unclosed phase — which makes head accounting race-free)."""

    new_id: int
    succ: Optional[int]
    first_phase: int
    released: int
    lid: int = 0


@dataclass(frozen=True)
class AT(Msg):
    """Attach-Task: new node notifies its async parent that the eager insert
    finished and it is signal-capable."""

    new_id: int
    first_phase: int
    lid: int = 0


@dataclass(frozen=True)
class ENSP(Msg):
    """Enable-Next-Signal-Propagation: activates the new node's signal edge
    and carries its +1 registration delta toward the head (routed eagerly
    along parent edges, so it precedes the node's first SIG on every shared
    FIFO channel)."""

    phase: int
    delta: int
    lid: int = 0


# ---------------------------------------------------------------------------
# Lazy promotion ("lazy multi-link-modify", hand-over-hand).
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class MULS1(Msg):
    """Step 1: ask candidate predecessor ``dst`` to splice ``new_id`` in at
    ``level``. A node not present on ``level`` forwards the walk left
    (hand-over-hand)."""

    level: int
    new_id: int
    lid: int = 0


@dataclass(frozen=True)
class MULS2(Msg):
    """Step 2: predecessor grants the splice; carries its old successor at
    that level (None == tail)."""

    level: int
    succ: Optional[int]
    lid: int = 0


@dataclass(frozen=True)
class MULS3(Msg):
    """Step 3: new node confirms; predecessor commits next_level := new and
    releases its hand-over-hand latch for the level. ``commit=False`` aborts
    (the walk found a closer predecessor spliced concurrently)."""

    level: int
    new_id: int
    commit: bool = True
    lid: int = 0


# ---------------------------------------------------------------------------
# Deletion (level-by-level unlink, top down).
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class UNL(Msg):
    """Ask predecessor ``dst`` at ``level`` to bypass the departing node."""

    level: int
    node: int
    succ: Optional[int]
    lid: int = 0


@dataclass(frozen=True)
class UNL_ACK(Msg):
    level: int
    node: int
    lid: int = 0


@dataclass(frozen=True)
class DEREG(Msg):
    """-1 registration delta effective from ``phase`` (flows toward head)."""

    phase: int
    delta: int
    lid: int = 0


# ---------------------------------------------------------------------------
# Neighbor / combine-set maintenance.
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class NXT(Msg):
    """'Your nxt pointer at ``level`` is now ``nxt``.' Used by the level-0
    unlink repair: a splice that landed at a departing node after its UNL
    snapshot was sent is handed over to the predecessor (structure only;
    the accounting moves via the new node's own re-parent handshake)."""

    level: int
    nxt: int
    lid: int = 0


@dataclass(frozen=True)
class PRV(Msg):
    """'Your prv pointer at ``level`` is now ``prv``.' If the receiver's top
    level equals ``level`` its signal-edge parent changed: it re-parents
    effective max(``effective``, closed+1)."""

    level: int
    prv: int
    effective: int
    lid: int = 0


@dataclass(frozen=True)
class CHILD_ADD(Msg):
    """Receiver gains a combine-set child from ``from_phase``. The child is
    ``child`` if set, else ``src`` (departed relays forward the request
    toward their own parent, so src may be a relay). SCSL receivers reply
    CHILD_ADD_ACK with the granted start phase; SNSL receivers adopt the
    child immediately and send a catch-up ADV."""

    from_phase: int
    child: Optional[int] = None
    lid: int = 0


@dataclass(frozen=True)
class CHILD_ADD_ACK(Msg):
    """Re-parent grant (SCSL handshake). The granting parent accepted the
    child from ``granted`` = max(requested, parent.closed+1): phases below
    the grant stay with the child's old parent, whose book is still open.
    This preserves the chain invariant (an open interval covering phase k
    implies its parent has not closed k) that makes the head's
    report-gated release race-free against in-flight registration
    deltas."""

    granted: int
    lid: int = 0


@dataclass(frozen=True)
class CHILD_DEL(Msg):
    """Receiver loses ``src`` as a combine-set child from ``from_phase``."""

    from_phase: int
    lid: int = 0


# ---------------------------------------------------------------------------
# Synchronization traffic.
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class SIG(Msg):
    """Partial signal count for ``phase`` flowing toward the head-signaler."""

    phase: int
    count: int
    closing: bool = True  # True: sender's once-per-phase aggregate report;
    #                       False: pass-through relay (not in anyone's books)
    lid: int = 0


@dataclass(frozen=True)
class ADV(Msg):
    """Phase-advance notification diffusing through the SNSL. Carries the
    highest released phase (monotone), so a single ADV catches a node up."""

    phase: int
    lid: int = 1


ALL_KINDS: Tuple[str, ...] = (
    "TUS", "TDS", "MURS", "MURS_ACK", "AT", "ENSP",
    "MULS1", "MULS2", "MULS3", "UNL", "UNL_ACK", "DEREG",
    "PRV", "NXT", "CHILD_ADD", "CHILD_ADD_ACK", "CHILD_DEL", "SIG", "ADV",
)

STRUCTURAL_KINDS: Tuple[str, ...] = (
    "TUS", "TDS", "MURS", "MURS_ACK", "AT", "ENSP",
    "MULS1", "MULS2", "MULS3", "UNL", "UNL_ACK", "DEREG",
    "PRV", "NXT", "CHILD_ADD", "CHILD_ADD_ACK", "CHILD_DEL",
)

SYNC_KINDS: Tuple[str, ...] = ("SIG", "ADV")
