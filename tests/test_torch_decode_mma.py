"""The tensor-core decode's arithmetic on the CPU: ``_decode_mma_emulated``
is the bf16 route of ``csrc/flash_decode.cu`` for groups of 4 to 16
query heads (``flash_decode_kernel_mma``) in plain torch, in the
kernel's structure and with its rounding points. The cache's 64-key
tiles go to ``splits`` blocks (the kernel's split rule); a block's four
warps each take 16 keys of every tile with their own online softmax in
log2 units (scores scaled by 1/sqrt(hd) * log2(e), exp2); q and K are
exact bf16 operands and q K^T sums in f32, as the mma accumulator does;
P is rounded to bf16, and that rounded P is both the operand of P V
(summed in f32) and what the row sum l adds; the warps' and then the
blocks' states merge in a fixed order with natural-log weights, and the
output is O / max(l, 1e-30) rounded to bf16. A key past W scores -inf,
an invalid one -inf, or -1e30 in a row with no valid key at all (which
then returns the mean of v).

Held against the exact decode (f64, ``_decode_exact``, itself checked
against ``repro.kernels.ref.decode_ref``) within the card's bf16 bounds,
2e-2 absolute and 1e-2 of each output row's L2 norm (``TOL`` and
``FAM_ROW_TOL`` in ``chip_smoke.py``), at reduced mixtral (g 4, a ring
with holes, hd 128) and llava (g 7, the first slots valid, hd 128)
shapes and at g 16, hd 64, W <= 512 and not a multiple of 64, with a
row that has no valid key. Unrounded, the decomposition equals the
exact decode within 1e-5.
"""
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.kernels import ref

TILE, WARPS, KEYS = 64, 4, 16       # keys a tile, warps a block, keys a warp
MAX_SPLIT, MAX_BLOCKS = 8, 66       # the kernel's split rule
LOG2E, LN2 = 1.4426950408889634, 0.6931471805599453
ABS_TOL, ROW_TOL = 2e-2, 1e-2


def splits(pairs: int, ntiles: int) -> int:
    """The kernel's split rule: the most splits, at most 8 (a cluster),
    that keep the grid to 66 blocks, and no more than the tiles."""
    ns = 1
    while 2 * ns <= MAX_SPLIT and 2 * ns * pairs <= MAX_BLOCKS:
        ns *= 2
    while ns > ntiles:
        ns //= 2
    return ns


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _decode_mma_emulated(q, k, v, valid, rnd=True):
    """q: (B, H, hd) f32 holding bf16 values; k/v: (B, Kh, W, hd) the
    same; valid: (B, W) int -> (B, H, hd) f32 (bf16 values when rnd)."""
    B, H, hd = q.shape
    Kh, W = k.shape[1], k.shape[2]
    g = H // Kh
    ntiles = (W + TILE - 1) // TILE
    ns = splits(B * Kh, ntiles)
    f32 = torch.float32
    sl2 = torch.tensor(1.0 / math.sqrt(hd), dtype=f32) * LOG2E
    pad = ntiles * TILE - W
    kp = torch.nn.functional.pad(k, (0, 0, 0, pad))
    vp = torch.nn.functional.pad(v, (0, 0, 0, pad))
    inr = torch.arange(ntiles * TILE) < W
    ok = torch.nn.functional.pad(valid > 0, (0, pad))        # (B, Wp)
    row_any = (valid > 0).any(-1)                            # (B,)
    rp = (lambda x: _bf16(x)) if rnd else (lambda x: x)
    out = torch.zeros((B, H, hd), dtype=f32)
    for b in range(B):
        masked = torch.where(inr & ~row_any[b], torch.tensor(-1e30),
                             torch.tensor(-math.inf)).to(f32)
        for kh in range(Kh):
            qg = q[b, kh * g:(kh + 1) * g]                   # (g, hd)
            blocks = []
            for rank in range(ns):
                t0, t1 = rank * ntiles // ns, (rank + 1) * ntiles // ns
                warps = []
                for w in range(WARPS):
                    m = torch.full((g,), -math.inf, dtype=f32)
                    l = torch.zeros((g,), dtype=f32)
                    o = torch.zeros((g, hd), dtype=f32)
                    for t in range(t0, t1):
                        j = slice(t * TILE + w * KEYS, t * TILE + (w + 1) * KEYS)
                        s = (qg @ kp[b, kh, j].T) * sl2          # (g, 16)
                        x = torch.where(ok[b, j], s, masked[j])
                        mn = torch.maximum(m, x.max(-1).values)
                        alpha = torch.where(m == -math.inf, torch.zeros_like(m),
                                            torch.exp2(m - mn))
                        p = torch.where(x == -math.inf, torch.zeros_like(x),
                                        torch.exp2(x - mn[:, None]))
                        p = rp(p)
                        l = l * alpha + p.sum(-1)
                        o = o * alpha[:, None] + p @ vp[b, kh, j]
                        m = mn
                    warps.append((m * LN2, l, o))
                blocks.append(_merge(warps))
            M, L, O = _merge(blocks)
            res = O / torch.clamp(L, min=1e-30)[:, None]
            out[b, kh * g:(kh + 1) * g] = rp(res)
    return out


def _merge(states):
    """Softmax states (m in natural log units, l, o) merged in order."""
    M = states[0][0]
    for m, _, _ in states[1:]:
        M = torch.maximum(M, m)
    L = torch.zeros_like(states[0][1])
    O = torch.zeros_like(states[0][2])
    for m, l, o in states:
        wt = torch.where(m == -math.inf, torch.zeros_like(m), torch.exp(m - M))
        L = L + l * wt
        O = O + o * wt[:, None]
    return M, L, O


def _decode_exact(q, k, v, valid):
    """decode_ref's semantics in f64."""
    B, H, hd = q.shape
    g = H // k.shape[1]
    kr = k.double().repeat_interleave(g, dim=1)
    vr = v.double().repeat_interleave(g, dim=1)
    s = torch.einsum("bhd,bhwd->bhw", q.double(), kr) / math.sqrt(hd)
    s = torch.where(valid[:, None, :] > 0, s, torch.full_like(s, -1e30))
    return torch.einsum("bhw,bhwd->bhd", torch.softmax(s, -1), vr)


# (label, B, H, Kh, W, hd, mask): mixtral's heads over a ring with holes,
# llava's over a cache whose first slots are valid, g 16 at hd 64
CASES = [("mixtral ring", 2, 8, 2, 500, 128, "ring"),
         ("llava prefix", 2, 14, 2, 384, 128, 300),
         ("g16 hd64", 2, 16, 1, 200, 64, "ring")]


def _case(B, H, Kh, W, hd, mask, seed=0):
    rng = np.random.default_rng(seed)
    q = _bf16(torch.from_numpy(rng.standard_normal((B, H, hd),
                                                   dtype=np.float32)))
    k = _bf16(torch.from_numpy(rng.standard_normal((B, Kh, W, hd),
                                                   dtype=np.float32)))
    v = _bf16(torch.from_numpy(rng.standard_normal((B, Kh, W, hd),
                                                   dtype=np.float32)))
    if mask == "ring":
        valid = torch.from_numpy(rng.integers(0, 2, (B, W)).astype(np.int32))
    else:
        valid = (torch.arange(W) < mask).to(torch.int32).expand(B, W)
        valid = valid.contiguous()
    valid[-1] = 0                       # a row with no valid key: mean of v
    return q, k, v, valid


@pytest.fixture(scope="module", params=CASES, ids=[c[0] for c in CASES])
def case(request):
    _, B, H, Kh, W, hd, mask = request.param
    q, k, v, valid = _case(B, H, Kh, W, hd, mask)
    return q, k, v, valid, _decode_exact(q, k, v, valid)


def test_exact_decode_is_the_reference_oracle(case):
    q, k, v, valid, exact = case
    want = np.asarray(ref.decode_ref(q.numpy(), k.numpy(), v.numpy(),
                                     valid.numpy()))
    np.testing.assert_allclose(exact.numpy(), want, rtol=1e-5, atol=1e-5)


def test_decode_mma_decomposition_unrounded_equals_exact(case):
    q, k, v, valid, exact = case
    got = _decode_mma_emulated(q, k, v, valid, rnd=False)
    assert (got.double() - exact).abs().max().item() <= 1e-5


def test_decode_mma_rounding_fits_the_bf16_bounds(case):
    q, k, v, valid, exact = case
    got = _decode_mma_emulated(q, k, v, valid).double()
    assert torch.isfinite(got).all()
    e_abs = (got - exact).abs().max().item()
    e_row = ((got - exact).norm(dim=-1)
             / exact.norm(dim=-1).clamp_min(1e-30)).max().item()
    assert e_abs <= ABS_TOL and e_row <= ROW_TOL, (e_abs, e_row)


def _kernel_constants() -> dict:
    """The integer constants of ``csrc/flash_decode.cu``'s file scope and
    of its ``tc`` namespace (the tensor-core kernel's), tc's winning."""
    src = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
           / "csrc" / "flash_decode.cu").read_text()
    pat = re.compile(r"^constexpr int (\w+) = (\d+);", re.M)
    top = dict(pat.findall(src.split("namespace tc {", 1)[0]))
    tc = dict(pat.findall(src.split("namespace tc {", 1)[1]))
    return {k: int(v) for k, v in {**top, **tc}.items()}


@pytest.mark.parametrize("name,value", [
    ("TILE", TILE), ("CONSUMERS", WARPS), ("MAX_SPLIT", MAX_SPLIT),
    ("MAX_BLOCKS", MAX_BLOCKS)])
def test_emulation_constants_are_the_kernels(name, value):
    """The emulation splits and tiles the cache as the kernel does: its
    tile, warps a block and split rule's limits are the source's."""
    assert _kernel_constants()[name] == value
