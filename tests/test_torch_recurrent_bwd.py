"""The tensor-core backward kernels' decomposition and rounding points on
the CPU: ``_mlstm_bwd_tc_emulated`` and ``_scan_bwd_tc_emulated`` are the
bf16 routes of ``csrc/mlstm_chunkwise_bwd.cu`` and
``csrc/mamba2_scan_bwd.cu`` in plain torch, in the kernels' three parts:
a state pass forward over the chunks (C0 and n0, or h0), a state pass in
reverse (dC and dn, or dh), and every other gradient chunk by chunk from
those states. Each product operand is rounded to bf16 where the kernel
rounds it (one bf16 operand each: the kernels keep no lo product) and
every sum is f32, as the wgmma accumulators are.

Held against the plain backwards (``mlstm_chunkwise_bwd_plain``,
``mamba2_scan_bwd_plain``, which ``test_torch_recurrent_train.py`` holds
against ``jax.vjp`` of the reference's oracles) on bf16 inputs: within
the card's bf16 bound, 2e-2 of each gradient's largest |value|
(``chip_smoke.BWD_TOL``); unrounded, the decomposition equals the plain
backward within 1e-5. Why no lo product stays: dropping every one of
them still holds the bound with room (about 5e-3 here), and keeping them
all moves the readings only to about 3e-3, where the bf16 rounding of
the stored gradients themselves sits.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import mamba2_scan as MS
from repro_torch.kernels import mlstm_kernel as MK
from repro_torch.kernels.mamba2_scan import _chunked

CH = 64          # the kernels' chunk rows
BF16_TOL = 2e-2  # chip_smoke.BWD_TOL["bfloat16"]
MLSTM_LO = ("rk", "gq", "c0", "dc", "dnum", "ds", "w")
SCAN_LO = ("xd", "dye", "h0", "dh", "dy", "dg", "w")


def _r(x, name, lo, rnd):
    """x as the kernel feeds it to a product: bf16 (plus its bf16 lo part
    where ``name`` is in ``lo``), or x itself when ``rnd`` is off."""
    if not rnd:
        return x
    hi = x.to(torch.bfloat16).float()
    return hi + (x - hi).to(torch.bfloat16).float() if name in lo else hi


def _mlstm_gates(ic, fc, c, causal):
    i_i = ic[:, :, c]
    lf = torch.cumsum(fc[:, :, c], -1)
    seg = lf[..., :, None] - lf[..., None, :] + i_i[..., None, :]
    logD = torch.where(causal, seg, torch.full_like(seg, -1e30))
    m = torch.maximum(logD.amax(-1), lf)
    return (lf, m, torch.exp(logD - m[..., None]), torch.exp(lf - m),
            torch.exp(lf[..., -1:] - lf + i_i), torch.exp(lf[..., -1]))


def _mlstm_bwd_tc_emulated(q, k, v, logi, logf, y, dy, lo=(), rnd=True):
    """The bf16 mLSTM backward kernel's five launches: (dq, dk, dv,
    dlogi, dlogf), dq/dk/dv rounded to bf16 as the kernel stores them."""
    B, NH, S, hd = q.shape
    qc, kc, vc, dyc, yc = (_chunked(t, 2, CH) for t in (q, k, v, dy, y))
    ic, fc = _chunked(logi, 2, CH), _chunked(logf, 2, CH)
    nch = qc.shape[2]
    idx = torch.arange(CH)
    causal = idx[:, None] >= idx[None, :]
    gates = [_mlstm_gates(ic, fc, c, causal) for c in range(nch)]
    # 1. forward state pass: C0 (stored bf16) and n0 (f32)
    C = torch.zeros(B, NH, hd, hd)
    n = torch.zeros(B, NH, hd)
    C0s, n0s = [], []
    for c in range(nch):
        r, eend = gates[c][4], gates[c][5]
        C0s.append(_r(C, "c0", lo, rnd))
        n0s.append(n)
        rk = (kc[:, :, c] * r[..., None]).transpose(-1, -2)
        C = eend[..., None, None] * C + _r(rk, "rk", lo, rnd) @ vc[:, :, c]
        n = eend[..., None] * n + rk.sum(-1)
    # 2. chunk-local terms: W, den, d, delta, dden, dnum, dS, M's sums
    loc = []
    for c in range(nch):
        lf, m, E, g, r, eend = gates[c]
        q_i, k_i, v_i = qc[:, :, c], kc[:, :, c], vc[:, :, c]
        W = (q_i @ k_i.transpose(-1, -2)) * E
        qn0 = (q_i * n0s[c][..., None, :]).sum(-1)
        den = W.sum(-1) + g * qn0
        emin = torch.exp(-m)
        d = torch.maximum(den.abs(), emin)
        delta = (dyc[:, :, c] * yc[:, :, c]).sum(-1)
        dden = torch.where(den.abs() > emin, -torch.sign(den) * delta / d,
                           torch.zeros_like(den))
        dnum = _r(dyc[:, :, c] / d[..., None], "dnum", lo, rnd)
        dW = (dnum @ v_i.transpose(-1, -2) + dden[..., None]) * causal
        M = dW * W
        loc.append(dict(W=_r(W, "w", lo, rnd), dS=_r(dW * E, "ds", lo, rnd),
                        dnum=dnum, dden=dden, qn0=qn0, rowM=M.sum(-1),
                        colM=M.sum(-2)))
    # 3. reverse state pass: dC at each chunk's end (stored bf16), dn
    dC = torch.zeros(B, NH, hd, hd)
    dn = torch.zeros(B, NH, hd)
    dCs, dns = [None] * nch, [None] * nch
    for c in reversed(range(nch)):
        g, eend = gates[c][3], gates[c][5]
        dCs[c], dns[c] = _r(dC, "dc", lo, rnd), dn
        gq = (qc[:, :, c] * g[..., None]).transpose(-1, -2)
        dC = eend[..., None, None] * dC + _r(gq, "gq", lo, rnd) @ loc[c]["dnum"]
        dn = eend[..., None] * dn + (
            qc[:, :, c] * (g * loc[c]["dden"])[..., None]).sum(-2)
    # 4, 5. chunk by chunk: dq, dk; dv and the gates' gradients
    dqs, dks, dvs, dis, dfs = [], [], [], [], []
    for c in range(nch):
        lf, m, E, g, r, eend = gates[c]
        L = loc[c]
        q_i, k_i, v_i = qc[:, :, c], kc[:, :, c], vc[:, :, c]
        accq = L["dnum"] @ C0s[c].transpose(-1, -2)
        dqs.append(g[..., None] * accq + L["dS"] @ k_i
                   + (g * L["dden"])[..., None] * n0s[c][..., None, :])
        dks.append(r[..., None] * (v_i @ dCs[c].transpose(-1, -2))
                   + L["dS"].transpose(-1, -2) @ q_i
                   + r[..., None] * dns[c][..., None, :])
        accv = k_i @ dCs[c]
        dvs.append(r[..., None] * accv
                   + L["W"].transpose(-1, -2) @ L["dnum"])
        dr = (v_i * accv).sum(-1) + (k_i * dns[c][..., None, :]).sum(-1)
        dg = (q_i * accq).sum(-1) + L["dden"] * L["qn0"]
        dlf = L["rowM"] - L["colM"] + g * dg - r * dr
        dlf[..., -1] += (r * dr).sum(-1) + eend * (
            (dCs[c] * C0s[c]).sum((-1, -2)) + (dns[c] * n0s[c]).sum(-1))
        dis.append(L["colM"] + r * dr)
        dfs.append(torch.flip(torch.cumsum(torch.flip(dlf, (-1,)), -1),
                              (-1,)))

    def merge(parts, dtype):
        t = torch.stack(parts, 2).flatten(2, 3).narrow(2, 0, S)
        return t.to(dtype).float() if rnd else t
    return (merge(dqs, torch.bfloat16), merge(dks, torch.bfloat16),
            merge(dvs, torch.bfloat16), merge(dis, torch.float32),
            merge(dfs, torch.float32))


def _scan_bwd_tc_emulated(x, Bm, Cm, a, dt, dy, lo=(), rnd=True):
    """The bf16 scan backward kernel's launches: (dx, dB, dC, da, ddt),
    dx/dB/dC rounded to bf16 as the kernel stores them."""
    B, NH, S, P = x.shape
    N = Bm.shape[-1]
    xc, dyc = _chunked(x, 2, CH), _chunked(dy, 2, CH)
    nch = xc.shape[2]
    Bc, Cc = _chunked(Bm, 1, CH), _chunked(Cm, 1, CH)
    ac, dtc = _chunked(a, 2, CH, 1.0), _chunked(dt, 2, CH)
    idx = torch.arange(CH)
    causal = idx[:, None] >= idx[None, :]
    gates = []
    for c in range(nch):
        la = torch.cumsum(torch.log(ac[:, :, c] + 1e-20), -1)
        seg = la[..., :, None] - la[..., None, :]
        L = torch.exp(torch.where(causal, seg, torch.full_like(seg, -1e30)))
        gates.append((L, torch.exp(la[..., -1:] - la), torch.exp(la),
                      torch.exp(la[..., -1])))
    # 1. forward state pass: h0 (stored bf16)
    h = torch.zeros(B, NH, P, N)
    h0s = []
    for c in range(nch):
        L, dec, ela, eend = gates[c]
        h0s.append(_r(h, "h0", lo, rnd))
        xd = (xc[:, :, c] * (dtc[:, :, c] * dec)[..., None]).transpose(-1, -2)
        h = eend[..., None, None] * h + _r(xd, "xd", lo, rnd) @ Bc[:, c, None]
    # 2. reverse state pass: dh at each chunk's end (stored bf16)
    dh = torch.zeros(B, NH, P, N)
    dhs = [None] * nch
    for c in reversed(range(nch)):
        L, dec, ela, eend = gates[c]
        dhs[c] = _r(dh, "dh", lo, rnd)
        dye = (dyc[:, :, c] * ela[..., None]).transpose(-1, -2)
        dh = eend[..., None, None] * dh + _r(dye, "dye", lo, rnd) @ Cc[:, c,
                                                                       None]
    # 3. chunk by chunk, dB and dC summed over the heads
    dxs, dBs, dCs, das, ddts = [], [], [], [], []
    for c in range(nch):
        L, dec, ela, eend = gates[c]
        x_i, dt_i = xc[:, :, c], dtc[:, :, c]
        B_i, C_i = Bc[:, c, None], Cc[:, c, None]
        dy_i = _r(dyc[:, :, c], "dy", lo, rnd)
        W = (C_i @ B_i.transpose(-1, -2)) * L
        dW = (dy_i @ x_i.transpose(-1, -2)) * dt_i[..., None, :] * causal
        dG = _r(dW * L, "dg", lo, rnd)
        M = dW * W
        dxdt = dec[..., None] * (B_i @ dhs[c].transpose(-1, -2)) \
            + _r(W, "w", lo, rnd).transpose(-1, -2) @ dy_i
        dC_state = ela[..., None] * (dy_i @ h0s[c])
        dB_state = (dt_i * dec)[..., None] * (x_i @ dhs[c])
        dCs.append(dG @ B_i + dC_state)
        dBs.append(dG.transpose(-1, -2) @ C_i + dB_state)
        Q = (B_i * dB_state).sum(-1)
        dla = M.sum(-1) - M.sum(-2) + (C_i * dC_state).sum(-1) - Q
        dla[..., -1] += eend * (dhs[c] * h0s[c]).sum((-1, -2)) + Q.sum(-1)
        dl = torch.flip(torch.cumsum(torch.flip(dla, (-1,)), -1), (-1,))
        das.append(dl / (ac[:, :, c] + 1e-20))
        ddts.append((dxdt * x_i).sum(-1))
        dxs.append(dxdt * dt_i[..., None])

    def merge(parts, dim, dtype):
        t = torch.stack(parts, dim).flatten(dim, dim + 1).narrow(dim, 0, S)
        return t.to(dtype).float() if rnd else t
    return (merge(dxs, 2, torch.bfloat16),
            merge([t.sum(1) for t in dBs], 1, torch.bfloat16),
            merge([t.sum(1) for t in dCs], 1, torch.bfloat16),
            merge(das, 2, torch.float32), merge(ddts, 2, torch.float32))


def _bf16(t):
    return torch.tensor(t).to(torch.bfloat16).float()


def _mlstm_case(S=1024, hd=384, seed=0):
    """One head at the xlstm width, bf16 q/k/v (the reference kernel
    test's distributions), the forward's f32 y, a random cotangent."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((1, 1, S, hd)) for _ in range(3))
    q, k, v = _bf16(q), _bf16(k / math.sqrt(hd)), _bf16(v)
    logi = torch.tensor(0.5 * rng.standard_normal((1, 1, S)),
                        dtype=torch.float32)
    logf = torch.nn.functional.logsigmoid(torch.tensor(
        rng.standard_normal((1, 1, S)) + 2.0, dtype=torch.float32))
    dy = torch.tensor(rng.standard_normal((1, 1, S, hd)),
                      dtype=torch.float32)
    ins = (q, k, v, logi, logf)
    y = MK.mlstm_chunkwise_plain(*ins, chunk=CH, out_dtype=torch.float32)
    return ins, y, dy, MK.mlstm_chunkwise_bwd_plain(*ins, dy, chunk=CH)


def _scan_case(S=2048, NH=2, seed=0):
    """Two heads at zamba2's P = N = 64, bf16 x, B and C."""
    rng = np.random.default_rng(seed)
    x = _bf16(rng.standard_normal((1, NH, S, 64)))
    bc = _bf16(0.5 * rng.standard_normal((1, S, 128)))
    sp = lambda t: torch.nn.functional.softplus(
        torch.tensor(t, dtype=torch.float32))
    dt = sp(rng.standard_normal((1, NH, S)))
    a = torch.exp(-sp(rng.standard_normal((1, NH, S))))
    dy = torch.tensor(rng.standard_normal((1, NH, S, 64)),
                      dtype=torch.float32)
    ins = (x, bc[..., :64], bc[..., 64:], a, dt)
    return ins, dy, MS.mamba2_scan_bwd_plain(*ins, dy, chunk=CH)


def _readings(got, want):
    return [(g - w.float()).abs().max().item() / w.float().abs().max().item()
            for g, w in zip(got, want)]


@pytest.fixture(scope="module")
def mlstm_case():
    torch.set_num_threads(2)
    return _mlstm_case()


@pytest.fixture(scope="module")
def scan_case():
    torch.set_num_threads(2)
    return _scan_case()


def test_mlstm_bwd_tc_decomposition_unrounded_equals_plain(mlstm_case):
    ins, y, dy, want = mlstm_case
    got = _mlstm_bwd_tc_emulated(*ins, y, dy, rnd=False)
    assert max(_readings(got, want)) <= 1e-5


def test_scan_bwd_tc_decomposition_unrounded_equals_plain(scan_case):
    ins, dy, want = scan_case
    got = _scan_bwd_tc_emulated(*ins, dy, rnd=False)
    assert max(_readings(got, want)) <= 1e-5


def test_mlstm_bwd_tc_rounding_fits_the_bf16_bound(mlstm_case):
    """One bf16 operand each (the kernel's): every gradient within 2e-2
    of its largest |value| (a reading near 5e-3)."""
    ins, y, dy, want = mlstm_case
    errs = _readings(_mlstm_bwd_tc_emulated(*ins, y, dy), want)
    print("mlstm bwd, bf16 operands: (dq, dk, dv, dlogi, dlogf) "
          + ", ".join(f"{e:.3e}" for e in errs))
    assert max(errs) <= BF16_TOL


def test_scan_bwd_tc_rounding_fits_the_bf16_bound(scan_case):
    ins, dy, want = scan_case
    errs = _readings(_scan_bwd_tc_emulated(*ins, dy), want)
    print("scan bwd, bf16 operands: (dx, dB, dC, da, ddt) "
          + ", ".join(f"{e:.3e}" for e in errs))
    assert max(errs) <= BF16_TOL


@pytest.mark.parametrize("kind", ["mlstm", "scan"])
def test_bwd_tc_lo_products_are_not_needed(kind, mlstm_case, scan_case):
    """Why the kernels keep no lo product: with one bf16 operand each the
    readings sit under a third of the 2e-2 bound, and all the lo products
    together lower them only a little (the bf16 gradients' own rounding
    stays), so no case fails the bound for want of one."""
    if kind == "mlstm":
        ins, y, dy, want = mlstm_case
        emu = lambda **kw: _mlstm_bwd_tc_emulated(*ins, y, dy, **kw)
        names = MLSTM_LO
    else:
        ins, dy, want = scan_case
        emu = lambda **kw: _scan_bwd_tc_emulated(*ins, dy, **kw)
        names = SCAN_LO
    none = max(_readings(emu(), want))
    every = max(_readings(emu(lo=names), want))
    print(f"{kind} bwd: no lo product {none:.3e}, every lo product "
          f"{every:.3e} (bf16 outputs)")
    assert none <= BF16_TOL / 3
    assert every < none
