"""The benchmark's frozen work counts: the H100's published peaks, each
kernel's operations and bytes from its call's shapes, and each
configuration's model FLOPs per token.

These are copies, not imports: the program's own helpers
(``kernels/*::*_flops``, ``roofline/analysis.py::model_flops``,
``launch/mesh.py::HW``) may change in a later change, the yardstick may
not. A roofline's least time is the larger of operations over the bf16
peak and bytes over the HBM peak; bytes count each input read once and
each output written once.
"""
from __future__ import annotations

import math
from typing import Optional

# NVIDIA H100 SXM data sheet, dense (no sparsity), at the 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

SCAN_BWD_CHUNK = 64          # the scan backward kernel's chunk rows


def least_seconds(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


def bound_by(flops: float, nbytes: float) -> str:
    return ("operations" if flops / PEAK_BF16_FLOPS
            >= nbytes / PEAK_HBM_BYTES else "bytes")


# ----------------------------------------------------------- attention
def visible_pairs(Sq: int, Sk: int, causal: bool,
                  window: Optional[int]) -> int:
    """(query, key) pairs the masks leave visible: causal row ``i`` sees
    ``min(i + 1, window)`` keys (queries aligned to the last keys)."""
    if not causal:
        return Sq * Sk
    w = min(window or Sq, Sq)
    return w * (w + 1) // 2 + (Sq - w) * w


def attention_fwd_flops(B, H, Sq, Sk, hd, causal, window) -> int:
    """q kᵀ and P v over the visible pairs."""
    return 4 * B * H * hd * visible_pairs(Sq, Sk, causal, window)


def attention_bwd_flops(B, H, Sq, Sk, hd, causal, window) -> int:
    """q kᵀ again, dO vᵀ, Pᵀ dO, dS k and dSᵀ q over the visible pairs."""
    return 10 * B * H * hd * visible_pairs(Sq, Sk, causal, window)


def attention_fwd_bytes(B, H, Kh, Sq, Sk, hd, itemsize) -> int:
    """q, k, v read; the output written."""
    return itemsize * (2 * B * H * Sq * hd + 2 * B * Kh * Sk * hd)


def attention_bwd_bytes(B, H, Kh, Sq, Sk, hd, itemsize,
                        dout_itemsize) -> int:
    """q, k, v, out, dout and the f32 LSE read; dq, dk, dv written."""
    q = B * H * Sq * hd
    kv = B * Kh * Sk * hd
    return (itemsize * (2 * q + 2 * kv) + dout_itemsize * q + 4 * B * H * Sq
            + itemsize * (q + 2 * kv))


# -------------------------------------------------------------- decode
def decode_flops(H, hd, n_valid) -> int:
    """q kᵀ and P v over the valid slots (``n_valid`` over all rows)."""
    return 4 * H * hd * n_valid


def decode_bytes(B, H, Kh, W, hd, n_valid, itemsize) -> int:
    """q read, the valid slots' k and v read, the int32 mask read, the
    output written."""
    return itemsize * (2 * B * H * hd + 2 * Kh * hd * n_valid) + 4 * B * W


# ------------------------------------------------------------ SSD scan
def scan_bwd_flops(B, NH, S, P, N) -> int:
    """The scan backward's products at 64-row chunks: the forward sweep's
    state update; C Bᵀ and dy xdtᵀ, Wᵀ dy, dG B, dGᵀ C (each 2 c² of N
    or P); B dh1ᵀ, dy h0, xdt dh1 and the dh update (each 2 c N P)."""
    c = SCAN_BWD_CHUNK
    per_chunk = (2 * c * N * P + 2 * c * c * (N + P) + 2 * c * c * (P + 2 * N)
                 + 4 * 2 * c * N * P)
    return B * NH * math.ceil(S / c) * per_chunk


def scan_bwd_bytes(B, NH, S, P, N, x_itemsize, bc_itemsize) -> int:
    """x, B, C (in their dtype), a and dt (f32), dy (f32) read; dx, dB,
    dC, da, ddt written in their inputs' dtypes."""
    x = B * NH * S * P
    bc = 2 * B * S * N
    ad = 2 * B * NH * S
    return 2 * (x * x_itemsize + bc * bc_itemsize + ad * 4) + 4 * x


def ssd_chunk_flops_per_token(P: int, N: int, chunk: int) -> int:
    """One head's chunked SSD forward per token at ``chunk`` rows: C Bᵀ,
    its mask, W (x dt), the incoming state's term and the state
    update."""
    c = chunk
    return 2 * c * N + c + 2 * c * P + 4 * N * P
