"""The port's CUDA kernels, model, engine and train step on the card,
held against their plain PyTorch versions (the CPU path) on the same
inputs. Beyond the shapes ``chip_smoke.py`` checks, these sweep every
head dim the kernels take, group sizes 1 to 16, ragged lengths, sliding
windows, holes in the decode mask, unaligned and contiguous layouts,
the attention backward, the bucket combine over strided group views, and
one gradient-sync step per schedule kind.

They need an NVIDIA Hopper GPU and ``nvcc``, and skip without a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: a kernel against its plain version, bf16 2e-2 and f32 1e-4
(sums in another order; the backward's relative to max(1, max|ref|));
the SSD scan the reference kernel test's 3e-2 and 1e-3 (relative and
absolute: its cumulative log-decay makes its f32 sums less exact); the
mLSTM kernel 2e-4 with y in f32 (the reference kernel test's) and 2e-2
with y in bf16, relative to max(1, max|ref|);
the bucket combine bitwise; the f32 model on the card against the CPU,
1e-4, and its gradients 1e-4 of each leaf's largest value; a train
step's parameters 1e-4 (Adam's first step divides each gradient by its
own magnitude, so rounding in a near-zero gradient shows). f32 matmuls
run without TF32.
"""
import numpy as np
import pytest
import torch

from repro_torch.collective_exec import build_gradsync_program
from repro_torch.core.collective import (ALLREDUCE_KINDS, PhaserCollective,
                                        RankStack)
from repro_torch.data import make_batch
from repro_torch.kernels import bucket_combine as BC
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import flash_decode as FD
from repro_torch.kernels import mamba2_scan as MS
from repro_torch.kernels import mlstm_kernel as MK
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models.registry import get_api, get_config
from repro_torch.optim import AdamW
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.utils import tree_flatten

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture(autouse=True)
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = tf32


def _randn(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def _err(got, want) -> float:
    torch.cuda.synchronize()
    return (got.float() - want.float()).abs().max().item()


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("B,H,Kh,S,hd,win,causal", [
    (1, 4, 4, 1, 16, None, True),       # a one-token prompt bucket
    (2, 9, 3, 7, 64, None, True),       # smollm heads, ragged tail
    (2, 9, 3, 100, 64, 5, True),        # sliding window
    (1, 8, 2, 256, 32, 128, True),      # window across whole tiles
    (1, 2, 1, 130, 128, None, True),    # hd 128: over 48 KB of smem
    (2, 16, 1, 65, 64, None, True),     # one KV head for 16 heads
    (1, 6, 2, 70, 64, None, False),     # not causal
    (2, 32, 32, 70, 112, None, True),   # zamba2's shared block, hd 112
    (1, 32, 32, 200, 112, 64, True),    # hd 112 with a window
])
def test_flash_attention_matches_plain(B, H, Kh, S, hd, win, causal, dtype):
    gen = torch.Generator("cuda").manual_seed(S)
    # the model's layout: (B, S, heads, hd) projections as transposed views
    q = _randn(gen, (B, S, H, hd), dtype).transpose(1, 2)
    k = _randn(gen, (B, S, Kh, hd), dtype).transpose(1, 2)
    v = _randn(gen, (B, S, Kh, hd), dtype).transpose(1, 2)
    n = FA.flash_attention.launches
    got = FA.flash_attention(q, k, v, causal=causal, sliding_window=win)
    assert FA.flash_attention.launches == n + 1
    assert got.shape == q.shape and got.dtype == dtype
    want = FA.attention_ref(q, k, v, causal=causal, sliding_window=win)
    assert _err(got, want) <= TOL[dtype]
    # contiguous (B, H, S, hd) inputs: other strides, the same arithmetic
    again = FA.flash_attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), causal=causal,
                               sliding_window=win)
    assert _err(again, got) == 0


def _cache_view(gen, B, W, Kh, hd, dtype, aligned):
    """k or v in the model's cache layout (B, W, Kh, hd), returned as the
    kernel's (B, Kh, W, hd) permuted view. Unaligned: one element into a
    wider buffer, so no row starts on 16 bytes (the scalar-load path)."""
    if aligned:
        buf = _randn(gen, (B, W, Kh, hd), dtype)
    else:
        buf = _randn(gen, (B, W, Kh, hd + 1), dtype)[..., 1:]
    return buf.permute(0, 2, 1, 3)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("B,H,Kh,W,hd,aligned", [
    (1, 4, 4, 1, 16, True),             # a one-slot cache
    (3, 9, 3, 100, 64, True),           # the CLI's ragged window
    (2, 8, 2, 63, 32, True),            # one split, not full
    (2, 16, 1, 130, 128, True),         # g = 16, hd 128
    (8, 9, 3, 1024, 64, True),          # the served shape
    (2, 9, 3, 100, 64, False),
    (2, 4, 2, 65, 16, False),
    (4, 32, 32, 256, 112, True),        # zamba2's shared block, hd 112
    (2, 32, 32, 70, 112, False),
])
def test_flash_decode_matches_plain(B, H, Kh, W, hd, aligned, dtype):
    gen = torch.Generator("cuda").manual_seed(W)
    q = _randn(gen, (B, H, hd), dtype)
    k = _cache_view(gen, B, W, Kh, hd, dtype, aligned)
    v = _cache_view(gen, B, W, Kh, hd, dtype, aligned)
    # holes anywhere (a ring buffer's validity), and one row with no
    # valid slot at all: the mean of v, never NaN
    valid = torch.randint(0, 2, (B, W), generator=gen, device="cuda",
                          dtype=torch.int32)
    valid[0] = 0
    n = FD.flash_decode.launches
    got = FD.flash_decode(q, k, v, valid)
    assert FD.flash_decode.launches == n + 1
    assert got.shape == q.shape and got.dtype == dtype
    assert torch.isfinite(got.float()).all()
    assert _err(got, FD.decode_ref(q, k, v, valid)) <= TOL[dtype]


def test_kernels_reject_what_they_cannot_take():
    q = torch.zeros((1, 4, 8, 48), device="cuda")        # hd 48
    kv = torch.zeros((1, 2, 8, 48), device="cuda")
    with pytest.raises(ValueError, match="shapes"):
        FA.flash_attention(q, kv, kv)
    q = torch.zeros((1, 4, 64), device="cuda")
    kv = torch.zeros((1, 2, 8, 64), device="cuda")
    with pytest.raises(TypeError, match="dtypes"):
        FD.flash_decode(q, kv, kv, torch.ones((1, 8), dtype=torch.int64,
                                              device="cuda"))
    with pytest.raises(ValueError, match="tensors on"):
        FD.flash_decode(q, kv.cpu(), kv, torch.ones((1, 8), dtype=torch.int32,
                                                    device="cuda"))


@pytest.mark.parametrize("overrides", [
    {}, {"n_heads": 6, "n_kv_heads": 2}, {"sliding_window": 5}],
    ids=["dense", "g3", "swa"])
def test_model_on_card_matches_cpu(overrides):
    """Prefill logits and caches, then decode steps past the window (a
    full cache drops the write, a ring buffer wraps), in f32."""
    cfg = get_config("smollm-135m").reduced(**overrides)
    api = get_api(cfg)
    params = api.init_params(torch.Generator().manual_seed(0), "cpu")
    tokens = torch.tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (3, 13)))
    outs = {}
    for dev in ("cpu", "cuda"):
        p = _to(params, dev)
        logits, caches = api.prefill_full_fn(p, {"tokens": tokens.to(dev)})
        state = api.init_decode_state(2, 7, dev)
        got = [logits, caches["layers"]["k"], caches["layers"]["v"]]
        for s in range(9):
            t = torch.tensor([s, s + 2], dtype=torch.int32, device=dev)
            lg, state = api.decode_fn(p, state, {"token": tokens[:2, s]
                                                 .to(dev), "t": t})
            got.append(lg)
        outs[dev] = got + list(state["layers"].values())
    for a, b in zip(outs["cpu"], outs["cuda"]):
        assert b.is_cuda and torch.isfinite(b.float()).all()
        torch.testing.assert_close(b.cpu(), a, rtol=1e-4, atol=1e-4)


def test_engine_on_card_serves_what_the_cpu_serves():
    """Bulk buckets, a prompt past the window (the sequential path) and
    slot reuse: the same tokens and epochs on both devices, and only the
    card's run launches the kernels."""
    cfg = get_config("smollm-135m").reduced()
    api = get_api(cfg)
    params = api.init_params(torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 30, 1, 12, 40, 3, 17, 8)]
    runs = {}
    for dev in ("cpu", "cuda"):
        eng = ServeEngine(api, _to(params, dev), batch=4, window=32)
        reqs = [Request(i, p, max_new=5) for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        before = (FA.flash_attention.launches, FD.flash_decode.launches)
        eng.run_until_drained()
        launched = (FA.flash_attention.launches - before[0],
                    FD.flash_decode.launches - before[1])
        runs[dev] = ([r.out for r in reqs], eng.epoch, launched)
    assert runs["cuda"][:2] == runs["cpu"][:2]
    assert runs["cpu"][2] == (0, 0) and min(runs["cuda"][2]) > 0


def test_launch_serve_cli_on_card(capsys):
    rc = launch_serve.main(["--arch", "smollm-135m", "--reduced",
                            "--requests", "5", "--batch", "2",
                            "--window", "16", "--prompt-len", "20",
                            "--max-new", "3"])
    assert rc == 0
    assert "served 5/5 requests" in capsys.readouterr().out


# ------------------------------------------------------ SSM and hybrid
SCAN_TOL = {torch.float32: 1e-3, torch.bfloat16: 3e-2}


def _scan_inputs(gen, B, NH, S, P, N, dtype):
    """The model's layout: x a (B, NH, S, P) view of (B, S, NH, P), B
    and C slices of one wider (B, S, 2N + 8) tensor, a and dt (B, NH, S)
    views of (B, S, NH) f32."""
    x = _randn(gen, (B, S, NH, P), dtype).transpose(1, 2)
    bc = (_randn(gen, (B, S, 2 * N + 8), dtype) * 0.5)
    dt = torch.nn.functional.softplus(
        torch.randn((B, S, NH), generator=gen, device="cuda"))
    a = torch.exp(-torch.nn.functional.softplus(
        torch.randn((B, S, NH), generator=gen, device="cuda")))
    return (x, bc[..., 8:8 + N], bc[..., 8 + N:], a.transpose(1, 2),
            dt.transpose(1, 2))


@pytest.mark.parametrize("out", ["same", "f32"])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("B,NH,S,P,N", [
    (2, 2, 256, 64, 16), (1, 4, 512, 32, 64), (2, 1, 128, 64, 64),
    (1, 3, 1, 16, 16),                  # one row
    (2, 5, 100, 16, 16),                # ragged: one partial chunk
    (1, 8, 1000, 64, 64),               # ragged: 15 chunks + 40 rows
])
def test_mamba2_scan_matches_plain(B, NH, S, P, N, dtype, out):
    gen = torch.Generator("cuda").manual_seed(S + P)
    ins = _scan_inputs(gen, B, NH, S, P, N, dtype)
    out_dtype = torch.float32 if out == "f32" else dtype
    n = MS.mamba2_scan.launches
    got = MS.mamba2_scan(*ins, out_dtype=out_dtype)
    assert MS.mamba2_scan.launches == n + 1
    assert got.shape == (B, NH, S, P) and got.dtype == out_dtype
    want = MS.mamba2_scan_plain(*ins, out_dtype=out_dtype)
    torch.cuda.synchronize()
    tol = SCAN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    # contiguous inputs: other strides, the same arithmetic; and a second
    # run: no atomics, so bitwise the same
    again = MS.mamba2_scan(*(t.contiguous() for t in ins),
                           out_dtype=out_dtype)
    assert torch.equal(again, got)


def test_mamba2_scan_ragged_tail_reads_nothing_past_s():
    """A ragged S cut from a longer sequence: the rows past S (which
    would change every later output) are never read."""
    gen = torch.Generator("cuda").manual_seed(7)
    full = _scan_inputs(gen, 2, 4, 300, 64, 64, torch.bfloat16)
    x, Bm, Cm, a, dt = full
    cut = (x[:, :, :130], Bm[:, :130], Cm[:, :130], a[..., :130],
           dt[..., :130])
    got = MS.mamba2_scan(*cut, out_dtype=torch.float32)
    want = MS.mamba2_scan(*(t.contiguous() for t in cut),
                          out_dtype=torch.float32)
    assert torch.equal(got, want)
    head = MS.mamba2_scan(*full, out_dtype=torch.float32)[:, :, :130]
    torch.testing.assert_close(head, got, rtol=1e-5, atol=1e-5)


def test_mamba2_scan_refuses_what_it_cannot_take():
    gen = torch.Generator("cuda").manual_seed(8)
    x, Bm, Cm, a, dt = _scan_inputs(gen, 1, 2, 64, 64, 64, torch.float32)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        MS.mamba2_scan(x.requires_grad_(True), Bm, Cm, a, dt)
    x = x.detach()
    with pytest.raises(ValueError, match="shapes"):
        MS.mamba2_scan(x[..., :48], Bm, Cm, a, dt)
    with pytest.raises(TypeError, match="dtypes"):
        MS.mamba2_scan(x, Bm, Cm, a.double(), dt)
    with torch.no_grad():                  # no gradient wanted: runs
        MS.mamba2_scan(x.requires_grad_(True), Bm, Cm, a, dt)


HYBRID = {"zamba2": {}, "ssm": {"family": "ssm", "hybrid_attn_every": 0}}


@pytest.mark.parametrize("variant", sorted(HYBRID))
def test_hybrid_model_on_card_matches_cpu(variant):
    """Reduced zamba2 (and its plain-ssm family) in f32: prefill logits
    and caches, 12 decode steps through a wrapping ring buffer, and the
    length-masked admission pass's logits and state."""
    cfg = get_config("zamba2-7b").reduced(**HYBRID[variant])
    api = get_api(cfg)
    params = api.init_params(torch.Generator().manual_seed(0), "cpu")
    tokens = torch.tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 40)))
    outs = {}
    for dev in ("cpu", "cuda"):
        p = _to(params, dev)
        n = MS.mamba2_scan.launches
        logits, caches = api.prefill_full_fn(p, {"tokens": tokens.to(dev)})
        assert (MS.mamba2_scan.launches - n) == (cfg.n_layers if dev == "cuda"
                                                 else 0)
        got = [logits] + (tree_flatten(caches)[1] if caches["layers"]
                          else [])
        state = api.init_decode_state(2, 8, dev)
        for s in range(12):
            t = torch.tensor([s, s + 3], dtype=torch.int32, device=dev)
            lg, state = api.decode_fn(p, state, {"token": tokens[:, s]
                                                 .to(dev), "t": t})
            got.append(lg)
        nxt, pstate = api.prefill_state_fn(p, tokens.to(dev), [40, 23],
                                           window=48)
        outs[dev] = (got + tree_flatten(state)[1] + [nxt]
                     + tree_flatten(pstate)[1])
    for a, b in zip(outs["cpu"], outs["cuda"]):
        assert b.is_cuda and torch.isfinite(b.float()).all()
        torch.testing.assert_close(b.cpu(), a, rtol=1e-4, atol=1e-4)


def test_hybrid_engine_on_card_serves_what_the_cpu_serves():
    """Recurrent bulk groups, a prompt past the window and slot reuse:
    the same tokens and epochs on both devices; the card's run launches
    flash_decode, the CPU's nothing."""
    cfg = get_config("zamba2-7b").reduced()
    api = get_api(cfg)
    params = api.init_params(torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 30, 1, 12, 40, 3, 17, 8)]
    runs = {}
    for dev in ("cpu", "cuda"):
        eng = ServeEngine(api, _to(params, dev), batch=4, window=32)
        reqs = [Request(i, p, max_new=5) for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        before = FD.flash_decode.launches
        eng.run_until_drained()
        runs[dev] = ([r.out for r in reqs], eng.epoch,
                     FD.flash_decode.launches - before,
                     eng.metrics.snapshot()["counters"])
    assert runs["cuda"][:2] == runs["cpu"][:2]
    assert runs["cuda"][3] == runs["cpu"][3]
    assert runs["cpu"][2] == 0 and runs["cuda"][2] > 0


def test_launch_serve_cli_hybrid_on_card(capsys):
    rc = launch_serve.main(["--arch", "zamba2-7b", "--reduced",
                            "--requests", "5", "--batch", "2",
                            "--window", "16", "--prompt-len", "20",
                            "--max-new", "3"])
    assert rc == 0
    assert "served 5/5 requests" in capsys.readouterr().out


# ----------------------------------------------------------------- xLSTM
# y in f32: within 2e-4 of max(1, max|ref|); y in bf16: element-wise,
# 2e-2 of each |ref| plus 1e-2 (one bf16 rounding either side)
MLSTM_TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}


def _mlstm_inputs(gen, B, NH, S, hd, dtype):
    """The model's layout: q, k, v (B, NH, S, hd) views of (B, S, NH, hd)
    slices of one wider projection, logi and logf (B, NH, S) views of
    (B, S, NH) f32; the reference kernel test's distributions."""
    qkv = _randn(gen, (B, S, NH, 3 * hd + 8), torch.float32)
    q = qkv[..., :hd].to(dtype)
    k = (qkv[..., hd:2 * hd] / hd ** 0.5).to(dtype)
    v = qkv[..., 2 * hd:3 * hd].to(dtype)
    logi = 0.5 * torch.randn((B, S, NH), generator=gen, device="cuda")
    logf = torch.nn.functional.logsigmoid(
        torch.randn((B, S, NH), generator=gen, device="cuda") + 2.0)
    return tuple(t.transpose(1, 2) for t in (q, k, v, logi, logf))


def _mlstm_close(got, want, out_dtype):
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    if out_dtype == torch.bfloat16:
        got, want = got.float(), want.float()
        assert ((got - want).abs() <= MLSTM_TOL[out_dtype] * want.abs()
                + 1e-2).all()
        return
    scale = max(1.0, want.float().abs().max().item())
    assert _err(got, want) <= MLSTM_TOL[out_dtype] * scale


@pytest.mark.parametrize("out", ["same", "f32"])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("B,NH,S,hd", [
    (2, 2, 256, 64), (1, 4, 512, 32),   # the reference kernel test's
    (1, 3, 1, 32),                      # one row
    (2, 2, 100, 64),                    # ragged: one chunk + 36 rows
    (1, 4, 1000, 384),                  # xlstm-125m's hd, 15 chunks + 40
    (2, 1, 40, 384),                    # one short chunk
])
def test_mlstm_chunkwise_matches_plain(B, NH, S, hd, dtype, out):
    gen = torch.Generator("cuda").manual_seed(S + hd)
    ins = _mlstm_inputs(gen, B, NH, S, hd, dtype)
    out_dtype = torch.float32 if out == "f32" else dtype
    n = MK.mlstm_chunkwise.launches
    got = MK.mlstm_chunkwise(*ins, out_dtype=out_dtype)
    assert MK.mlstm_chunkwise.launches == n + 1
    assert got.shape == (B, NH, S, hd) and got.dtype == out_dtype
    _mlstm_close(got, MK.mlstm_chunkwise_plain(*ins, out_dtype=out_dtype),
                 out_dtype)
    # contiguous inputs: other strides, the same arithmetic; and a second
    # run: no atomics, so bitwise the same
    again = MK.mlstm_chunkwise(*(t.contiguous() for t in ins),
                               out_dtype=out_dtype)
    assert torch.equal(again, got)


def test_mlstm_chunkwise_ragged_tail_reads_nothing_past_s():
    """A ragged S cut from a longer sequence: the rows past S (which
    would change every later output) are never read."""
    gen = torch.Generator("cuda").manual_seed(9)
    full = _mlstm_inputs(gen, 2, 4, 300, 384, torch.bfloat16)
    cut = tuple(t[:, :, :130] for t in full)
    got = MK.mlstm_chunkwise(*cut, out_dtype=torch.float32)
    want = MK.mlstm_chunkwise(*(t.contiguous() for t in cut),
                              out_dtype=torch.float32)
    assert torch.equal(got, want)
    head = MK.mlstm_chunkwise(*full, out_dtype=torch.float32)[:, :, :130]
    torch.testing.assert_close(head, got, rtol=1e-5, atol=1e-5)


def test_mlstm_chunkwise_refuses_what_it_cannot_take():
    gen = torch.Generator("cuda").manual_seed(10)
    q, k, v, li, lf = _mlstm_inputs(gen, 1, 2, 64, 64, torch.float32)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        MK.mlstm_chunkwise(q.requires_grad_(True), k, v, li, lf)
    q = q.detach()
    with pytest.raises(ValueError, match="shapes"):
        MK.mlstm_chunkwise(q[..., :48], k[..., :48], v[..., :48], li, lf)
    with pytest.raises(TypeError, match="dtypes"):
        MK.mlstm_chunkwise(q, k, v, li.double(), lf)
    with pytest.raises(TypeError, match="dtypes"):
        MK.mlstm_chunkwise(q.half(), k.half(), v.half(), li, lf)
    with pytest.raises(ValueError, match="tensors on"):
        MK.mlstm_chunkwise(q, k, v.cpu(), li, lf)
    with torch.no_grad():                  # no gradient wanted: runs
        MK.mlstm_chunkwise(q.requires_grad_(True), k, v, li, lf)


def test_xlstm_model_on_card_matches_cpu():
    """Reduced xlstm-125m in f32: prefill logits (S = 300, two of the
    plain version's chunks), 12 decode steps, and the length-masked
    admission pass's logits and state."""
    cfg = get_config("xlstm-125m").reduced()
    api = get_api(cfg)
    params = api.init_params(torch.Generator().manual_seed(0), "cpu")
    tokens = torch.tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 300)))
    outs = {}
    for dev in ("cpu", "cuda"):
        p = _to(params, dev)
        n = MK.mlstm_chunkwise.launches
        logits, caches = api.prefill_full_fn(p, {"tokens": tokens.to(dev)})
        assert caches == {"layers": None}
        G = cfg.n_layers // cfg.slstm_every
        assert (MK.mlstm_chunkwise.launches - n) == (
            G * (cfg.slstm_every - 1) if dev == "cuda" else 0)
        got = [logits]
        state = api.init_decode_state(2, 8, dev)
        for s in range(12):
            t = torch.tensor([s, s + 3], dtype=torch.int32, device=dev)
            lg, state = api.decode_fn(p, state, {"token": tokens[:, s]
                                                 .to(dev), "t": t})
            got.append(lg)
        nxt, pstate = api.prefill_state_fn(p, tokens[:, :40].to(dev),
                                           [40, 23], window=48)
        outs[dev] = (got + tree_flatten(state)[1] + [nxt]
                     + tree_flatten(pstate)[1])
    for a, b in zip(outs["cpu"], outs["cuda"]):
        assert b.is_cuda and torch.isfinite(b.float()).all()
        torch.testing.assert_close(b.cpu(), a, rtol=1e-4, atol=1e-4)


def test_xlstm_engine_on_card_serves_what_the_cpu_serves():
    """Recurrent bulk groups, a prompt past the window (the sequential
    path's fresh-slot reset) and slot reuse: the same tokens, epochs and
    counters on both devices."""
    cfg = get_config("xlstm-125m").reduced()
    api = get_api(cfg)
    params = api.init_params(torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 30, 1, 12, 40, 3, 17, 8)]
    runs = {}
    for dev in ("cpu", "cuda"):
        eng = ServeEngine(api, _to(params, dev), batch=4, window=32)
        reqs = [Request(i, p, max_new=5) for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run_until_drained()
        runs[dev] = ([r.out for r in reqs], eng.epoch,
                     eng.metrics.snapshot()["counters"])
    assert runs["cuda"] == runs["cpu"]
    assert runs["cuda"][2]["serve.admit.sequential"] == 1


def test_launch_serve_cli_xlstm_on_card(capsys):
    rc = launch_serve.main(["--arch", "xlstm-125m", "--reduced",
                            "--requests", "5", "--batch", "2",
                            "--window", "16", "--prompt-len", "20",
                            "--max-new", "3"])
    assert rc == 0
    assert "served 5/5 requests" in capsys.readouterr().out


# ------------------------------------------------------------ training
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("B,H,Kh,S,hd,win", [
    (3, 9, 3, 1, 64, None),             # one token
    (3, 9, 3, 7, 64, None),             # ragged tail
    (3, 9, 3, 100, 64, 5),              # sliding window
    (2, 9, 3, 300, 64, 200),            # window across tiles
    (1, 4, 1, 130, 128, None),          # hd 128, g = 4
    (2, 4, 4, 65, 16, None),            # hd 16, no grouping
    (1, 16, 2, 90, 32, 33),             # g = 8
    (1, 32, 32, 130, 112, None),        # hd 112 (zamba2's shared block)
])
def test_flash_attention_backward_matches_plain(B, H, Kh, S, hd, win,
                                                dtype):
    """Through autograd: ``flash_attention`` on tensors that need a
    gradient runs ``FlashAttentionFn``; its dq/dk/dv against autograd of
    the plain version, in the layout of the inputs."""
    gen = torch.Generator("cuda").manual_seed(S + hd)
    q = _randn(gen, (B, S, H, hd), dtype).transpose(1, 2)
    k = _randn(gen, (B, S, Kh, hd), dtype).transpose(1, 2)
    v = _randn(gen, (B, S, Kh, hd), dtype).transpose(1, 2)
    do = _randn(gen, (B, S, H, hd), dtype).transpose(1, 2)
    leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
    n = (FA.flash_attention.launches, FA.flash_attention_bwd.launches)
    out = FA.flash_attention(*leaves, causal=True, sliding_window=win)
    out.backward(do)
    assert (FA.flash_attention.launches, FA.flash_attention_bwd.launches) \
        == (n[0] + 1, n[1] + 1)
    want = FA.attention_bwd_ref(q, k, v, do, causal=True,
                                sliding_window=win)
    for x, w in zip(leaves, want):
        g = x.grad
        assert g.dtype == dtype and g.stride() == x.stride()
        assert _err(g, w) <= TOL[dtype] * max(1.0, w.float().abs().max()
                                              .item())


@pytest.mark.parametrize("op", ["add", "copy"])
def test_bucket_combine_matches_plain_bitwise(op):
    gen = torch.Generator("cuda").manual_seed(1)
    acc = _randn(gen, (6, 12, 1024), torch.float32)
    y = _randn(gen, (6, 5, 1024), torch.float32)
    gate = torch.tensor([1, 0, 1, 1, 0, 1], dtype=torch.int32,
                        device="cuda")
    n = BC.bucket_combine.launches
    for a in (acc[:, 3:8], acc[:, :5].contiguous()):   # group view, whole
        got = BC.bucket_combine(a, y, gate, op=op)
        assert torch.equal(got, BC.combine_ref(a, y, gate, op=op))
    flat = acc[0, :5]                                  # one rank, 2-D
    got = BC.bucket_combine(flat, y[0], gate[:1], op=op)
    assert torch.equal(got, BC.combine_ref(flat, y[0], gate[0], op=op))
    odd = _randn(gen, (3, 2, 130), torch.float32)[:, :, 1:129]
    with pytest.raises(ValueError, match="contiguous"):
        BC.bucket_combine(odd, odd, gate[:3], op=op)
    with pytest.raises(ValueError, match="gate"):
        BC.bucket_combine(acc, acc, gate.cpu(), op=op)
    assert BC.bucket_combine.launches == n + 3


@pytest.mark.parametrize("shape", [(5, 256), (3, 33)], ids=str)
@pytest.mark.parametrize("kind", ["phaser_scsl", "recursive_doubling"])
def test_all_reduce_on_card_launches_the_kernel(kind, shape):
    """The public all-reduce of a card stack runs every round's combine
    through the kernel, one launch a round, bitwise the CPU's result."""
    n = 6
    x = torch.randn((n,) + shape, generator=torch.Generator().manual_seed(2))
    pc = PhaserCollective(n, "data", kind=kind, seed=0)
    before = BC.bucket_combine.launches
    got = pc.all_reduce(x.cuda(), RankStack(n, "cuda"))
    assert BC.bucket_combine.launches == before + pc.stats()["rounds"]
    assert torch.equal(got.cpu(), pc.all_reduce(x, RankStack(n, "cpu")))
    mean = pc.pmean(x.cuda(), RankStack(n, "cuda"))
    assert BC.bucket_combine.launches == before + 2 * pc.stats()["rounds"]
    assert torch.equal(mean, got / n)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_model_grads_on_card_match_cpu(remat):
    cfg = get_config("smollm-135m").reduced(n_heads=6, n_kv_heads=2)
    api = get_api(cfg)
    params = api.init_params(torch.Generator().manual_seed(0), "cpu")
    b = make_batch(cfg.vocab_size, 3, 40, seed=0, step=0)
    out = {}
    for dev in ("cpu", "cuda"):
        bt = {k: torch.tensor(v, device=dev) for k, v in b.items()}
        out[dev] = api.value_and_grad(_to(params, dev), bt, remat=remat)
    (lc, _), gc = out["cpu"]
    (lg, _), gg = out["cuda"]
    assert abs(lc.item() - lg.item()) <= 1e-4
    for a, w in zip(tree_flatten(gg)[1], tree_flatten(gc)[1]):
        assert a.is_cuda
        assert (a.cpu() - w).abs().max() <= 1e-4 * w.abs().max()


@pytest.mark.parametrize("kind", ALLREDUCE_KINDS)
def test_program_step_on_card_matches_cpu(kind):
    """One gradient-sync step at n = 6 with a departed worker, on the
    card (kernels) and on the CPU (plain versions); the pipelined round
    order is bitwise eager on the card."""
    cfg = get_config("smollm-135m").reduced()
    api = get_api(cfg)
    opt = AdamW(lr=1e-3, warmup=2, total_steps=10)
    params = api.init_params(torch.Generator().manual_seed(0), "cpu")
    b = make_batch(cfg.vocab_size, 12, 16, seed=0, step=0)
    res = {}
    for dev, ov in (("cpu", "eager"), ("cuda", "eager"),
                    ("cuda", "pipelined")):
        prog = build_gradsync_program(
            api, opt, PhaserCollective(6, "data", kind=kind, seed=0),
            device=dev, overlap=ov)
        p = _to(params, dev)
        alive = torch.tensor([1, 1, 0, 1, 1, 1], dtype=torch.float32,
                             device=dev)
        n = BC.bucket_combine.launches
        newp, _, pm = prog.step(p, opt.init(p), {
            k: torch.tensor(v, device=dev) for k, v in b.items()}, alive)
        if dev == "cuda" and kind in ("phaser_scsl", "recursive_doubling"):
            assert BC.bucket_combine.launches > n
        res[(dev, ov)] = (tree_flatten(newp)[1], prog.reduce_metrics(pm))
    for a, w in zip(res[("cuda", "eager")][0], res[("cpu", "eager")][0]):
        assert (a.cpu() - w).abs().max() <= 1e-4
    for a, w in zip(res[("cuda", "eager")][0], res[("cuda", "pipelined")][0]):
        assert torch.equal(a, w)
    assert abs(res[("cuda", "eager")][1]["loss"].item()
               - res[("cpu", "eager")][1]["loss"].item()) <= 1e-4


def test_launch_train_cli_on_card(capsys):
    rc = launch_train.main(["--arch", "smollm-135m", "--reduced",
                            "--workers", "3", "--batch", "12", "--seq",
                            "32", "--steps", "8", "--elastic",
                            "join@2,fail@5"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert out.count('{"epoch_boundary"') == 2
