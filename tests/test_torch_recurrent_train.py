"""Training of the recurrent families in the port against the JAX
package: the plain backwards of the SSD scan and the mLSTM (what the
hand-written backward kernels compute) against ``jax.vjp`` of the
reference's oracles (``repro.kernels.ref``) and against autograd of the
plain forwards; the stabiliser m's zero gradient; the autograd
Functions' wiring and their meta rules; and the train CLI on reduced
zamba2 and xLSTM against the reference's CLI from the same parameters.

Tolerances: the plain backwards 1e-4 of each gradient's largest value
(f32; the chunked form sums in another order than the oracle's
recurrence); detaching m 1e-5; the Functions' gradients 1e-5 against
autograd of the same plain forward; the CLIs' losses 1e-4 relative.
"""
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import mamba2_ref, mlstm_ref
from repro.models.registry import get_api as ref_get_api
from repro.models.registry import get_config as ref_get_config
from repro_torch.interop import params_from_jax
from repro_torch.kernels import mamba2_scan as MS
from repro_torch.kernels import meta
from repro_torch.kernels import mlstm_kernel as MK
from repro_torch.launch import train as launch_train
from repro_torch.models import registry
from repro_torch.models.registry import get_config

ROOT = Path(__file__).resolve().parents[1]


def _scan_inputs(rng, B, NH, S, P, N):
    x = rng.standard_normal((B, NH, S, P)).astype(np.float32)
    Bm = (0.5 * rng.standard_normal((B, S, N))).astype(np.float32)
    Cm = (0.5 * rng.standard_normal((B, S, N))).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, NH, S)))).astype(np.float32)
    a = np.exp(-np.log1p(np.exp(rng.standard_normal((B, NH, S))))
               ).astype(np.float32)
    dy = rng.standard_normal((B, NH, S, P)).astype(np.float32)
    return (x, Bm, Cm, a, dt), dy


def _mlstm_inputs(rng, B, NH, S, hd, ishift=0.0):
    q, k, v = (rng.standard_normal((B, NH, S, hd)).astype(np.float32)
               for _ in range(3))
    k = k / np.sqrt(hd)
    logi = (0.5 * rng.standard_normal((B, NH, S)) + ishift).astype(np.float32)
    logf = -np.log1p(np.exp(-(rng.standard_normal((B, NH, S)) + 2.0))
                     ).astype(np.float32)
    dy = rng.standard_normal((B, NH, S, hd)).astype(np.float32)
    return (q, k, v, logi, logf), dy


def _close(got, want, rel):
    for i, (g, w) in enumerate(zip(got, want)):
        g = g.detach().float().numpy() if torch.is_tensor(g) else g
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape, i
        err = np.abs(g - w).max()
        assert err <= rel * np.abs(w).max(), (i, err, np.abs(w).max())


def _autograd(fwd, ins, dy, **kw):
    ts = [torch.tensor(t, requires_grad=True) for t in ins]
    fwd(*ts, **kw).backward(torch.tensor(dy))
    return [t.grad for t in ts]


# (B, NH, S, P, N, chunk): whole chunks, a ragged tail, S < chunk
SCAN_CASES = [(2, 3, 96, 16, 32, 32), (1, 2, 70, 32, 16, 32),
              (2, 2, 10, 16, 16, 64)]


@pytest.mark.parametrize("case", SCAN_CASES, ids=str)
def test_mamba2_scan_bwd_plain_matches_reference_vjp(case):
    B, NH, S, P, N, chunk = case
    ins, dy = _scan_inputs(np.random.default_rng(1), B, NH, S, P, N)
    _, vjp = jax.vjp(mamba2_ref, *map(jnp.asarray, ins))
    got = MS.mamba2_scan_bwd_plain(*map(torch.tensor, ins), torch.tensor(dy),
                                   chunk=chunk)
    _close(got, vjp(jnp.asarray(dy)), 1e-4)
    # and autograd of the plain forward
    _close(got, _autograd(MS.mamba2_scan_plain, ins, dy, chunk=chunk), 1e-4)


# (B, NH, S, hd, chunk, shift of logi)
MLSTM_CASES = [(2, 3, 96, 16, 32, 0.0), (1, 2, 70, 32, 32, 0.0),
               (2, 2, 10, 16, 64, 0.0)]


@pytest.mark.parametrize("case", MLSTM_CASES, ids=str)
def test_mlstm_bwd_plain_matches_reference_vjp(case):
    B, NH, S, hd, chunk, shift = case
    ins, dy = _mlstm_inputs(np.random.default_rng(2), B, NH, S, hd, shift)
    _, vjp = jax.vjp(mlstm_ref, *map(jnp.asarray, ins))
    got = MK.mlstm_chunkwise_bwd_plain(*map(torch.tensor, ins),
                                       torch.tensor(dy), chunk=chunk)
    _close(got, vjp(jnp.asarray(dy)), 1e-4)
    _close(got, _autograd(MK.mlstm_chunkwise_plain, ins, dy, chunk=chunk),
           1e-4)


def _abs_den(q, k, logi, logf):
    """|q_t . n_t| in the absolute frame, by the recurrence in f64: the
    floor max(|q n|, 1) binds where it is below 1."""
    B, NH, S, hd = q.shape
    n = np.zeros((B, NH, hd))
    out = np.zeros((B, NH, S))
    for t in range(S):
        n = np.exp(logf[..., t])[..., None] * n \
            + np.exp(logi[..., t])[..., None] * k[:, :, t]
        out[..., t] = np.abs(np.sum(q[:, :, t] * n, axis=-1))
    return out


def test_mlstm_bwd_plain_where_the_floor_binds_on_some_rows():
    """Negative logi: the floor max(|den|, 1) binds on some rows and not
    on others (both branches of dden), and the plain backward still
    matches the reference's vjp and autograd."""
    ins, dy = _mlstm_inputs(np.random.default_rng(3), 2, 2, 80, 16, -1.0)
    den = _abs_den(*(x.astype(np.float64) for x in
                     (ins[0], ins[1], ins[3], ins[4])))
    assert (den > 1.05).any() and (den < 0.95).any()
    _, vjp = jax.vjp(mlstm_ref, *map(jnp.asarray, ins))
    got = MK.mlstm_chunkwise_bwd_plain(*map(torch.tensor, ins),
                                       torch.tensor(dy), chunk=32)
    _close(got, vjp(jnp.asarray(dy)), 1e-4)
    _close(got, _autograd(MK.mlstm_chunkwise_plain, ins, dy, chunk=32),
           1e-4)


@pytest.mark.parametrize("shift", [0.0, -3.0])
def test_mlstm_stabiliser_carries_no_gradient(shift, monkeypatch):
    """Detaching m in the plain forward leaves every gradient unchanged
    (the proof in ``kernels/mlstm_kernel.py``'s docstring)."""
    ins, dy = _mlstm_inputs(np.random.default_rng(4), 2, 2, 70, 16, shift)
    with_m = _autograd(MK.mlstm_chunkwise_plain, ins, dy, chunk=32)
    gates = MK._gates
    monkeypatch.setattr(MK, "_gates",
                        lambda i, f, causal, stop: gates(i, f, causal, True))
    stopped = _autograd(MK.mlstm_chunkwise_plain, ins, dy, chunk=32)
    _close(stopped, [g.numpy() for g in with_m], 1e-5)


def _wired(monkeypatch, mod, fwd_plain, bwd_name, bwd_plain):
    """The module's launchers replaced by its plain versions, each call
    of the backward recorded."""
    calls = []

    def bwd(*a, **kw):
        calls.append(a)
        return bwd_plain(*(a[:5] + a[-1:]), **kw)

    monkeypatch.setattr(mod, "_forward", fwd_plain)
    monkeypatch.setattr(mod, bwd_name, bwd)
    return calls


def test_mamba2_scan_function_wiring_on_cpu(monkeypatch):
    """``Mamba2ScanFn`` with the launchers monkeypatched to the plain
    versions: its gradients equal autograd of the plain forward (dB and
    dC summed over the heads, in (B, S, N)), the backward runs once, and
    the non-tensor arguments get None."""
    calls = _wired(monkeypatch, MS,
                   lambda x, Bm, Cm, a, dt, chunk, od: MS.mamba2_scan_plain(
                       x, Bm, Cm, a, dt, chunk=chunk, out_dtype=od),
                   "mamba2_scan_bwd", MS.mamba2_scan_bwd_plain)
    ins, dy = _scan_inputs(np.random.default_rng(5), 2, 3, 70, 16, 16)
    ts = [torch.tensor(t, requires_grad=True) for t in ins]
    MS.Mamba2ScanFn.apply(*ts, 32, torch.float32).backward(torch.tensor(dy))
    assert len(calls) == 1
    assert ts[1].grad.shape == (2, 70, 16) and ts[2].grad.shape == (2, 70, 16)
    _close([t.grad for t in ts],
           [g.numpy() for g in _autograd(MS.mamba2_scan_plain, ins, dy,
                                         chunk=32)], 1e-5)
    ctx = types.SimpleNamespace(saved_tensors=tuple(map(torch.tensor, ins)),
                                chunk=32)
    out = MS.Mamba2ScanFn.backward(ctx, torch.tensor(dy))
    assert len(out) == 7 and out[5] is None and out[6] is None


def test_mlstm_function_wiring_on_cpu(monkeypatch):
    """``MlstmChunkwiseFn`` likewise: y saved for the backward, gradients
    equal autograd of the plain forward, out_dtype's gradient None."""
    calls = _wired(monkeypatch, MK,
                   lambda q, k, v, li, lf, od: MK.mlstm_chunkwise_plain(
                       q, k, v, li, lf, out_dtype=od),
                   "mlstm_chunkwise_bwd", MK.mlstm_chunkwise_bwd_plain)
    ins, dy = _mlstm_inputs(np.random.default_rng(6), 2, 2, 70, 32)
    ts = [torch.tensor(t, requires_grad=True) for t in ins]
    y = MK.MlstmChunkwiseFn.apply(*ts, torch.float32)
    y.backward(torch.tensor(dy))
    assert len(calls) == 1 and torch.equal(calls[0][5], y.detach())
    _close([t.grad for t in ts],
           [g.numpy() for g in _autograd(MK.mlstm_chunkwise_plain, ins,
                                         dy)], 1e-5)
    saved = tuple(map(torch.tensor, ins)) + (y.detach(),)
    out = MK.MlstmChunkwiseFn.backward(
        types.SimpleNamespace(saved_tensors=saved), torch.tensor(dy))
    assert len(out) == 6 and out[5] is None


def test_meta_rules_run_forward_and_backward():
    """On ``meta`` tensors that need a gradient, both wrappers go through
    their Function: gradients of the inputs' shapes (the model's strided
    views), and the forward's and the backward's work recorded."""
    B, NH, S, P, N, hd = 2, 3, 100, 16, 32, 64
    xbc = torch.empty((B, S, NH * P + 2 * N), device="meta",
                      requires_grad=True)
    ad = torch.empty((B, S, 2 * NH), device="meta", requires_grad=True)
    x = xbc[..., :NH * P].unflatten(-1, (NH, P)).transpose(1, 2)
    with meta.count_work() as work:
        y = MS.mamba2_scan(x, xbc[..., NH * P:NH * P + N],
                           xbc[..., NH * P + N:], ad[..., :NH].transpose(1, 2),
                           ad[..., NH:].transpose(1, 2),
                           out_dtype=torch.float32)
        y.sum().backward()
    assert xbc.grad.shape == xbc.shape and ad.grad.shape == ad.shape
    assert work["mamba2_scan_bwd"]["calls"] == 1
    assert work["mamba2_scan_bwd"]["flops"] == MS.scan_bwd_flops(
        B, NH, S, P, N)
    qkv = torch.empty((B, S, NH, 3 * hd), device="meta", requires_grad=True)
    g = torch.empty((B, S, NH, 2), device="meta", requires_grad=True)
    with meta.count_work() as work:
        y = MK.mlstm_chunkwise(*(qkv[..., i * hd:(i + 1) * hd].transpose(1, 2)
                                 for i in range(3)),
                               g[..., 0].transpose(1, 2),
                               g[..., 1].transpose(1, 2),
                               out_dtype=torch.float32)
        y.sum().backward()
    assert qkv.grad.shape == qkv.shape and g.grad.shape == g.shape
    assert work["mlstm_chunkwise_bwd"]["calls"] == 1
    assert work["mlstm_chunkwise_bwd"]["flops"] == MK.mlstm_bwd_cost(
        B, NH, S, hd, 4)[1]
    assert MS.mamba2_scan_bwd.launches == MK.mlstm_chunkwise_bwd.launches == 0


def test_meta_rules_allocate_the_kernels_scratch(monkeypatch):
    """On ``meta`` tensors each backward allocates its route's scratch, as
    the kernel's wrapper does on the card (so the dry-run's peak follows
    the kernel): bf16 at the models' widths (scan P = N = 64, mLSTM hd
    384) the tensor-core route's bf16 states and its small f32 parts, f32
    the CUDA-core route's f32 states; the recorded work is the same on
    both routes."""
    seen = []
    for mod in (MS, MK):
        real = mod._bwd_scratch
        monkeypatch.setattr(mod, "_bwd_scratch", lambda route, *a, _r=real:
                            seen.append((route, _r(route, *a))) or seen[-1][1])
    B, NH, S = 2, 9, 100
    nch = 2                                   # 64-row chunks
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.empty((B, NH, S, 64), device="meta", dtype=dtype,
                        requires_grad=True)
        bc = torch.empty((B, S, 64), device="meta", dtype=dtype,
                         requires_grad=True)
        ad = torch.empty((B, NH, S), device="meta", requires_grad=True)
        with meta.count_work() as work:
            MS.mamba2_scan(x, bc, bc, ad, ad,
                           out_dtype=torch.float32).sum().backward()
        assert work["mamba2_scan_bwd"]["flops"] == MS.scan_bwd_flops(
            B, NH, S, 64, 64)
        qkv = torch.empty((B, NH, S, 384), device="meta", dtype=dtype,
                          requires_grad=True)
        gt = torch.empty((B, NH, S), device="meta", requires_grad=True)
        with meta.count_work() as work:
            MK.mlstm_chunkwise(qkv, qkv, qkv, gt, gt,
                               out_dtype=torch.float32).sum().backward()
        assert work["mlstm_chunkwise_bwd"]["flops"] == MK.mlstm_bwd_cost(
            B, NH, S, 384, dtype.itemsize)[1]
    shapes = [(route, [(tuple(t.shape), t.dtype) for t in ts])
              for route, ts in seen]
    b16, f32 = torch.bfloat16, torch.float32
    ng = -(-NH // MS.TC_GROUP)
    assert shapes == [
        ("tc", [((B, NH, nch, 64, 64), b16)] * 2
         + [((B, ng, S, 64), f32)] * 2),
        ("tc", [((B, NH, nch, 384, 384), b16)] * 2
         + [((B, NH, nch, 384), f32)] * 2 + [((B, NH, S, 384), b16),
                                             ((B, NH, nch, 3, 64, 64), b16),
                                             ((B, NH, S, 6), f32),
                                             ((B, NH, nch, 2), f32)]),
        ("f32", [((B, NH, nch, 64, 64), f32), ((B, NH, S, 64), f32),
                 ((B, NH, S, 64), f32)]),
        ("f32", [((B, NH, S), f32), ((B, NH, nch, 384, 384), f32),
                 ((B, NH, 6, nch, 384), f32)] + [((B, NH, 6, S, 384), f32)] * 2
         + [((B, NH, 6, S), f32)] * 2)]


def test_meta_scan_backward_on_dtensors_with_heads_sharded():
    """On the dry-run's DTensors with batch and heads sharded, the scan's
    gradients keep x's placements, and Bmat's and Cmat's (no head dim)
    are partial over the mesh dim that shards the heads, one rank's work
    recorded."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.launch.mesh import fake_world, make_production_mesh
    with fake_world(256):
        mesh = make_production_mesh(device_type="cpu")

        def dt(local, pl, shape):
            return DTensor.from_local(
                torch.empty(*local, device="meta", requires_grad=True),
                mesh, pl, run_check=False, shape=shape,
                stride=torch.empty(shape).stride())
        hp = [Shard(0), Shard(1)]            # batch over data, heads over model
        x = dt((2, 2, 64, 16), hp, (32, 32, 64, 16))
        bc = dt((2, 64, 16), [Shard(0), Replicate()], (32, 64, 16))
        ad = dt((2, 2, 64), hp, (32, 32, 64))
        with meta.count_work() as work:
            y = MS.mamba2_scan(x, bc, bc, ad, ad, out_dtype=torch.float32)
            dB, dx = torch.autograd.grad(y.sum(), (bc, x))
        assert tuple(y.placements) == tuple(hp)
        assert tuple(dx.placements) == tuple(hp)
        assert dB.shape == bc.shape
        assert work["mamba2_scan_bwd"]["flops"] == MS.scan_bwd_flops(
            2, 2, 64, 16, 16)
    assert MS.meta.partial_over(hp, keep=(0,)) == (Shard(0), Partial())


# ------------------------------------------------------------------ CLI
CLI = ["--reduced", "--steps", "3", "--batch", "2", "--seq", "40",
       "--seed", "0"]
REF_CLI = """
import sys
from repro.launch.train import main
sys.exit(main(sys.argv[1:]))
"""


class _Runs:
    """The reference's train CLI for both archs, each in its own
    subprocess, started with the module (they compile while the tests
    above run) and waited for at first use."""

    def __init__(self):
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   JAX_PLATFORMS="cpu")
        self.procs = {arch: subprocess.Popen(
            [sys.executable, "-c", REF_CLI, "--arch", arch, *CLI], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for arch in ("zamba2-7b", "xlstm-125m")}
        self.out = {}

    def __getitem__(self, arch):
        if arch not in self.out:
            p = self.procs[arch]
            out, err = p.communicate(timeout=600)
            assert p.returncode in (0, 1), err[-4000:]
            self.out[arch] = out
        return self.out[arch]

    def close(self):
        for p in self.procs.values():
            if p.poll() is None:
                p.kill()
            p.communicate()


@pytest.fixture(scope="module", autouse=True)
def reference_cli():
    runs = _Runs()
    yield runs
    runs.close()


@pytest.fixture
def few_threads():
    """Two intra-op threads: the reduced models' small ops run several
    times faster than on every core of a shared host."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _losses(out: str):
    return [json.loads(l)["loss"] for l in out.splitlines()
            if l.startswith("{") and '"step"' in l and '"loss"' in l]


@pytest.mark.parametrize("arch", ["zamba2-7b", "xlstm-125m"])
def test_train_cli_matches_reference(arch, reference_cli, monkeypatch,
                                     capsys, few_threads):
    """``python -m repro_torch.launch.train --arch <arch> --reduced
    --device cpu``, from the reference's initial parameters (its
    ``init_params(key(0))``, as its loop draws them): the same losses as
    ``python -m repro.launch.train`` with the same flags."""
    ref_cfg = ref_get_config(arch).reduced()
    ref_params = jax.tree_util.tree_map(
        np.asarray, ref_get_api(ref_cfg).init_params(jax.random.key(0)))
    params = params_from_jax(ref_params, get_config(arch).reduced(),
                             device="cpu")
    monkeypatch.setattr(registry.ModelAPI, "init_params",
                        lambda self, gen, device="cuda": params)
    rc = launch_train.main(["--arch", arch, "--device", "cpu", *CLI])
    got = _losses(capsys.readouterr().out)
    want = _losses(reference_cli[arch])
    assert rc in (0, 1) and len(got) == len(want) == 2
    np.testing.assert_allclose(got, want, rtol=1e-4)
