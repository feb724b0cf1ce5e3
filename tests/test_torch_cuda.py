"""The port's CUDA kernels, model, engine and train step on the card,
held against their plain PyTorch versions (the CPU path) on the same
inputs. Beyond the shapes ``chip_smoke.py`` checks, these sweep every
head dim the kernels take, group sizes 1 to 16, ragged lengths, sliding
windows, holes in the decode mask, unaligned and contiguous layouts,
the attention backward, the bucket combine over strided group views,
one gradient-sync step per schedule kind, the 2-D pipeline step
(against the CPU and the single-axis program, and its kernel launches),
the remaining families: both attention kernels at their shapes
(cross-attention's Sq != Sk, g 5 and 7, mixtral's window across S 4608,
its 4096-slot ring, whisper's 1500 cross keys), one full-width mixtral
MoE layer in bf16 against f32 on the CPU, and the reduced MoE, enc-dec
and VLM models against the CPU; and the multi-host runtime: an
in-process cluster of 3 hosts x 2 ranks on the card against the same
run on the CPU, and the hierarchical step's ``bucket_combine`` launches
against its local schedule.

They need an NVIDIA Hopper GPU and ``nvcc``, and skip without a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: a kernel against its plain version, bf16 2e-2 and f32 1e-4
(sums in another order; the backward's relative to max(1, max|ref|));
the SSD scan 1e-3, relative and absolute (f32 x the reference kernel
test's, its cumulative log-decay making its f32 sums less exact; bf16 x
the tensor-core kernel's, set from its readings of about 1.2e-4, plus
one bf16 step of |y| when y is bf16); the
mLSTM kernel 2e-4 with y in f32 (the reference kernel test's) and 2e-2
with y in bf16, relative to max(1, max|ref|);
the attention kernels in bf16 at the remaining families' shapes also
within 1e-2 of every output row's L2 norm (``FAM_ROW_TOL``, as in
``chip_smoke.py``: about twice the largest sound reading, where 2e-2
absolute is about a typical output);
the bucket combine bitwise; a full-width MoE layer in bf16 against f32
on the CPU, 2e-2 of max(1, max|ref|) (the router and the routing are
f32 on both); the f32 model on the card against the CPU,
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


FAM_ROW_TOL = 1e-2


def _row_err(got, want) -> float:
    """The largest over output rows (one query's hd values) of
    |got - want|_2 / |want|_2."""
    got, want = got.float(), want.float()
    return ((got - want).norm(dim=-1)
            / want.norm(dim=-1).clamp_min(1e-30)).max().item()


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
    # the bf16 kernel's 128-row q tiles and 128-key tiles: their edges
    (2, 9, 3, 127, 64, None, True),
    (2, 9, 3, 128, 64, None, True),
    (2, 9, 3, 129, 64, None, True),
    (1, 9, 3, 1000, 64, None, True),
    (2, 32, 32, 1, 112, None, True),
    (1, 32, 32, 129, 112, None, True),
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


def _decode_mask(gen, B, W, mask):
    """``holes``: valid slots anywhere (a ring buffer's validity);
    ``prefix``: each row valid up to a random length, so whole 64-key
    tiles past it hold no valid key (the tiles the kernel skips). Row 0
    has no valid slot at all either way: the mean of v, never NaN."""
    if mask == "holes":
        valid = torch.randint(0, 2, (B, W), generator=gen, device="cuda",
                              dtype=torch.int32)
    else:
        lengths = torch.randint(1, W + 1, (B,), generator=gen,
                                device="cuda")
        valid = (torch.arange(W, device="cuda")[None] < lengths[:, None])
        valid = valid.to(torch.int32)
    valid[0] = 0
    return valid


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("B,H,Kh,W,hd,aligned,mask", [
    (1, 4, 4, 1, 16, True, "holes"),      # a one-slot cache
    (3, 9, 3, 100, 64, True, "holes"),    # the CLI's ragged window
    (2, 8, 2, 63, 32, True, "holes"),     # one split, not full
    (2, 16, 1, 130, 128, True, "holes"),  # g = 16, hd 128
    (8, 9, 3, 1024, 64, True, "holes"),   # the served shape
    (2, 9, 3, 100, 64, False, "holes"),
    (2, 4, 2, 65, 16, False, "holes"),
    (4, 32, 32, 256, 112, True, "holes"),  # zamba2's shared block, hd 112
    (2, 32, 32, 70, 112, False, "holes"),
    # prefix masks: whole empty tiles past each row's length
    (8, 9, 3, 1024, 64, True, "prefix"),
    (4, 32, 32, 4096, 112, True, "prefix"),
    (3, 32, 32, 300, 112, False, "prefix"),
    # g = 16 at one slot and at one slot past a tile
    (2, 16, 1, 1, 64, True, "holes"),
    (2, 16, 1, 65, 64, True, "prefix"),
])
def test_flash_decode_matches_plain(B, H, Kh, W, hd, aligned, mask, dtype):
    gen = torch.Generator("cuda").manual_seed(W)
    q = _randn(gen, (B, H, hd), dtype)
    k = _cache_view(gen, B, W, Kh, hd, dtype, aligned)
    v = _cache_view(gen, B, W, Kh, hd, dtype, aligned)
    valid = _decode_mask(gen, B, W, mask)
    n = FD.flash_decode.launches
    got = FD.flash_decode(q, k, v, valid)
    assert FD.flash_decode.launches == n + 1
    assert got.shape == q.shape and got.dtype == dtype
    assert torch.isfinite(got.float()).all()
    assert _err(got, FD.decode_ref(q, k, v, valid)) <= TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("B,H,Kh,W,hd", [
    (8, 9, 3, 1024, 64),                # smollm: 8 splits a cluster
    (4, 32, 32, 256, 112),              # zamba2's shared block
])
def test_flash_decode_is_deterministic(B, H, Kh, W, hd, dtype):
    """The splits merge in a fixed order: two runs are bitwise equal, and
    so are the model's permuted cache view and a contiguous copy."""
    gen = torch.Generator("cuda").manual_seed(hd)
    q = _randn(gen, (B, H, hd), dtype)
    k = _cache_view(gen, B, W, Kh, hd, dtype, True)
    v = _cache_view(gen, B, W, Kh, hd, dtype, True)
    valid = _decode_mask(gen, B, W, "holes")
    got = FD.flash_decode(q, k, v, valid)
    assert torch.equal(FD.flash_decode(q, k, v, valid), got)
    assert torch.equal(
        FD.flash_decode(q, k.contiguous(), v.contiguous(), valid), got)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("B,H,Kh,S,hd,win,causal", [
    (2, 9, 3, 129, 64, None, True),     # smollm heads, past one q tile
    (1, 32, 32, 200, 112, 64, True),    # zamba2's hd 112, a window
    (1, 4, 2, 70, 16, None, False),     # hd 16, not causal
])
def test_flash_attention_lse_matches_plain(B, H, Kh, S, hd, win, causal,
                                           dtype):
    """The per-row log-sum-exp the forward keeps for the backward
    (natural log) against ``attention_lse_ref``: 1e-3 in bf16, 1e-5 in
    f32 (the same scores, summed in another order)."""
    gen = torch.Generator("cuda").manual_seed(S + hd)
    q = _randn(gen, (B, S, H, hd), dtype).transpose(1, 2)
    k = _randn(gen, (B, S, Kh, hd), dtype).transpose(1, 2)
    v = _randn(gen, (B, S, Kh, hd), dtype).transpose(1, 2)
    out, lse = FA._forward(q, k, v, causal, win, want_lse=True)
    assert lse.shape == (B, H, S) and lse.dtype == torch.float32
    want = FA.attention_lse_ref(q, k, causal=causal, sliding_window=win)
    assert _err(lse, want) <= {torch.bfloat16: 1e-3,
                               torch.float32: 1e-5}[dtype]
    assert _err(out, FA.attention_ref(q, k, v, causal=causal,
                                      sliding_window=win)) <= TOL[dtype]


def test_kernels_reject_what_they_cannot_take():
    q = torch.zeros((1, 4, 8, 48), device="cuda")        # hd 48
    kv = torch.zeros((1, 2, 8, 48), device="cuda")
    with pytest.raises(ValueError, match="shapes"):
        FA.flash_attention(q, kv, kv)
    # bf16 reads through TMA: a base one element (2 bytes) off 16 bytes
    buf = torch.zeros((1 + 4 * 8 * 64,), dtype=torch.bfloat16, device="cuda")
    q = buf[1:].view(1, 4, 8, 64)
    kv = torch.zeros((1, 2, 8, 64), dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="16-byte-aligned base"):
        FA.flash_attention(q, kv, kv)
    q = torch.zeros((1, 4, 64), device="cuda")
    kv = torch.zeros((1, 2, 8, 64), device="cuda")
    with pytest.raises(TypeError, match="dtypes"):
        FD.flash_decode(q, kv, kv, torch.ones((1, 8), dtype=torch.int64,
                                              device="cuda"))
    with pytest.raises(ValueError, match="tensors on"):
        FD.flash_decode(q, kv.cpu(), kv, torch.ones((1, 8), dtype=torch.int32,
                                                    device="cuda"))


def test_cuda_calls_launch_beside_the_meta_rules():
    """The dry-run's meta rules take only meta tensors: a CUDA call of
    each wrapper still launches its kernel (its counter rises by one)
    and reports the same closed-form work as the meta rule does; a meta
    call counts no launch."""
    from repro_torch.kernels import meta
    gen = torch.Generator("cuda").manual_seed(0)
    q = _randn(gen, (1, 4, 64, 64), torch.bfloat16).requires_grad_(True)
    kv = _randn(gen, (1, 2, 64, 64), torch.bfloat16).requires_grad_(True)
    x = _randn(gen, (1, 2, 64, 64), torch.float32)
    bc = _randn(gen, (1, 64, 64), torch.float32)
    ad = torch.rand((1, 2, 64), generator=gen, device="cuda")
    acc = _randn(gen, (2, 3, 64), torch.float32)
    gate = torch.tensor([1, 0], dtype=torch.int32, device="cuda")
    calls = [
        (FA.flash_attention, lambda: FA.flash_attention(q, kv, kv).sum()
         .backward()),
        (FD.flash_decode, lambda: FD.flash_decode(
            q[:, :, 0].detach(), kv.detach(), kv.detach(),
            torch.ones((1, 64), dtype=torch.int32, device="cuda"))),
        (MS.mamba2_scan, lambda: MS.mamba2_scan(x, bc, bc, ad, ad)),
        (MK.mlstm_chunkwise, lambda: MK.mlstm_chunkwise(
            x, x, x, ad, ad)),
        (BC.bucket_combine, lambda: BC.bucket_combine(acc, acc, gate)),
    ]
    for fn, call in calls:
        n = fn.launches
        with meta.count_work() as work:
            call()
        torch.cuda.synchronize()
        assert fn.launches == n + 1, fn.__name__
        assert work[fn.__name__]["calls"] == 1
    assert FA.flash_attention_bwd.launches > 0
    n = FA.flash_attention.launches
    with meta.count_work() as mwork:
        FA.flash_attention(q.detach().to("meta"), kv.detach().to("meta"),
                           kv.detach().to("meta"))
    assert FA.flash_attention.launches == n
    with meta.count_work() as cwork:
        FA.flash_attention(q.detach(), kv.detach(), kv.detach())
    assert mwork["flash_attention"] == cwork["flash_attention"]


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
# bf16 x: the tensor-core kernel's hi/lo operands read about 1.2e-4 of
# 1 + |y|; without the lo products of h and x it reads 2.9e-2, so the
# reference kernel test's 3e-2 would not see a fault there
SCAN_TOL = {torch.float32: 1e-3, torch.bfloat16: 1e-3}


def _scan_inputs(gen, B, NH, S, P, N, dtype, off=8):
    """The model's layout: x a (B, NH, S, P) view of (B, S, NH, P), B
    and C slices of one wider (B, S, 2N + 8) tensor from element `off`
    (an odd one: rows not 16-byte aligned), a and dt (B, NH, S) views
    of (B, S, NH) f32."""
    x = _randn(gen, (B, S, NH, P), dtype).transpose(1, 2)
    bc = (_randn(gen, (B, S, 2 * N + 8), dtype) * 0.5)
    dt = torch.nn.functional.softplus(
        torch.randn((B, S, NH), generator=gen, device="cuda"))
    a = torch.exp(-torch.nn.functional.softplus(
        torch.randn((B, S, NH), generator=gen, device="cuda")))
    return (x, bc[..., off:off + N], bc[..., off + N:off + 2 * N],
            a.transpose(1, 2), dt.transpose(1, 2))


SCAN_CASES = [
    (2, 2, 256, 64, 16), (1, 4, 512, 32, 64), (2, 1, 128, 64, 64),
    (1, 3, 1, 16, 16),                  # one row
    (2, 5, 100, 16, 16),                # ragged: one partial chunk
    (1, 8, 1000, 64, 64),               # ragged: 15 chunks + 40 rows
    (1, 4, 63, 64, 64), (1, 4, 64, 64, 64), (1, 4, 65, 64, 64),  # chunk edges
    (2, 112, 2048, 64, 64),             # zamba2-7b's full prefill shape
]


@pytest.mark.parametrize("out", ["same", "f32"])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("B,NH,S,P,N,off", [
    *(pytest.param(*c, 8, id="-".join(map(str, c))) for c in SCAN_CASES),
    # B and C rows not 16-byte aligned: the tensor-core kernel's scalar
    # copy into its swizzled tiles, a ragged S
    pytest.param(1, 4, 1000, 64, 64, 1, id="unaligned-1-4-1000-64-64"),
])
def test_mamba2_scan_matches_plain(B, NH, S, P, N, off, dtype, out):
    gen = torch.Generator("cuda").manual_seed(S + P)
    ins = _scan_inputs(gen, B, NH, S, P, N, dtype, off=off)
    out_dtype = torch.float32 if out == "f32" else dtype
    n = MS.mamba2_scan.launches
    got = MS.mamba2_scan(*ins, out_dtype=out_dtype)
    assert MS.mamba2_scan.launches == n + 1
    assert got.shape == (B, NH, S, P) and got.dtype == out_dtype
    want = MS.mamba2_scan_plain(*ins, out_dtype=out_dtype)
    torch.cuda.synchronize()
    tol = SCAN_TOL[dtype]
    # bf16 x and y: the two results of about 1.2e-4 apart may round to
    # neighbouring bf16 values, one step (at most 2^-7 of |y|) apart
    rtol = tol + (2 ** -7 if dtype == out_dtype == torch.bfloat16 else 0.)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=tol)
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


def test_mlstm_chunkwise_full_xlstm_shape_matches_plain():
    """The model's prefill call at full width: B=8, NH=4, S=2048, hd=384,
    q/k/v bf16, y f32 (the tensor-core kernel), one launch."""
    gen = torch.Generator("cuda").manual_seed(11)
    ins = _mlstm_inputs(gen, 8, 4, 2048, 384, torch.bfloat16)
    n = MK.mlstm_chunkwise.launches
    got = MK.mlstm_chunkwise(*ins, out_dtype=torch.float32)
    assert MK.mlstm_chunkwise.launches == n + 1
    assert got.shape == (8, 4, 2048, 384) and got.dtype == torch.float32
    _mlstm_close(got, MK.mlstm_chunkwise_plain(*ins,
                                               out_dtype=torch.float32),
                 torch.float32)


def test_mlstm_chunkwise_full_xlstm_shape_is_deterministic():
    """No atomics on data: two runs at the full prefill shape are bitwise
    equal."""
    gen = torch.Generator("cuda").manual_seed(12)
    ins = _mlstm_inputs(gen, 8, 4, 2048, 384, torch.bfloat16)
    first = MK.mlstm_chunkwise(*ins, out_dtype=torch.float32)
    second = MK.mlstm_chunkwise(*ins, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_mlstm_chunkwise_ragged_chunk_cut_from_longer_is_bitwise():
    """S = 2000, not a multiple of the 64-row chunk, cut from 2048 rows:
    bitwise equal to its contiguous copy (nothing past S is read), and
    within the tolerance of the plain version."""
    gen = torch.Generator("cuda").manual_seed(13)
    full = _mlstm_inputs(gen, 2, 4, 2048, 384, torch.bfloat16)
    cut = tuple(t[:, :, :2000] for t in full)
    got = MK.mlstm_chunkwise(*cut, out_dtype=torch.float32)
    want = MK.mlstm_chunkwise(*(t.contiguous() for t in cut),
                              out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    _mlstm_close(got, MK.mlstm_chunkwise_plain(*cut,
                                               out_dtype=torch.float32),
                 torch.float32)


def test_mlstm_chunkwise_refuses_a_layout_tma_cannot_read():
    """bf16 at hd 384 reads q, k, v through TMA: an outer stride that is
    not a multiple of 16 bytes raises, it does not fall back."""
    gen = torch.Generator("cuda").manual_seed(14)
    q, k, v, li, lf = _mlstm_inputs(gen, 1, 2, 64, 384, torch.bfloat16)
    wide = torch.zeros((1, 64, 2, 384 + 4), dtype=torch.bfloat16,
                       device="cuda")
    wide[..., :384] = q.transpose(1, 2)
    with pytest.raises(ValueError, match="TMA"):
        MK.mlstm_chunkwise(wide[..., :384].transpose(1, 2), k, v, li, lf)


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
    (2, 9, 3, 129, 64, None),           # past two 64-row tiles
    (1, 9, 3, 1024, 64, None),          # the train cell's length
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


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_flash_attention_backward_is_deterministic(dtype):
    """Three launches and no atomics: two backward runs on the same
    inputs give bitwise equal gradients."""
    gen = torch.Generator("cuda").manual_seed(7)
    q = _randn(gen, (2, 300, 9, 64), dtype).transpose(1, 2)
    k = _randn(gen, (2, 300, 3, 64), dtype).transpose(1, 2)
    v = _randn(gen, (2, 300, 3, 64), dtype).transpose(1, 2)
    do = _randn(gen, (2, 300, 9, 64), dtype).transpose(1, 2)
    out, lse = FA._forward(q, k, v, True, None, want_lse=True)
    first = FA.flash_attention_bwd(q, k, v, out, do, lse)
    again = FA.flash_attention_bwd(q, k, v, out, do, lse)
    for a, b in zip(first, again):
        assert torch.equal(a, b)


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


# the two cases of chip_smoke's pipeline reference phase: (stages,
# microbatches, interleave, overlap, block_groups, layers)
PIPE_CASES = {"S2M2v1": (2, 2, 1, "eager", None, 2),
              "S2M2v2-piped": (2, 2, 2, "pipelined", 2, 4)}


def _pipe_step(api, opt, params, dev, case, kind="phaser_scsl"):
    from repro_torch.pipeline_exec import build_pipeline_program
    S, M, v, ov, bg, _ = case
    pc = PhaserCollective(3, "data", kind=kind, seed=0)
    prog = build_pipeline_program(api, opt, pc, n_stages=S, interleave=v,
                                  device=dev, microbatches=M, overlap=ov,
                                  block_groups=bg)
    b = make_batch(api.cfg.vocab_size, 12, 16, seed=0, step=0)
    p = _to(params, dev)
    alive = torch.tensor([1, 0, 1], dtype=torch.float32, device=dev)
    newp, _, pm = prog.step(p, opt.init(p), {
        k: torch.tensor(x, device=dev) for k, x in b.items()}, alive)
    return prog, tree_flatten(newp)[1], prog.reduce_metrics(pm)


@pytest.mark.parametrize("name", sorted(PIPE_CASES))
def test_pipeline_step_on_card_matches_cpu(name):
    """Reduced smollm in f32, team 3 with a departed worker: the 2-D
    step on the card against the CPU (loss and params 1e-4) and against
    the card's single-axis ``xla_psum`` program (loss rtol 1e-5, params
    rtol 2e-4 / atol 2e-5)."""
    case = PIPE_CASES[name]
    api = get_api(get_config("smollm-135m").reduced(n_layers=case[-1]))
    opt = AdamW(lr=1e-3, warmup=10, total_steps=20)
    params = api.init_params(torch.Generator().manual_seed(0), "cpu")
    _, card, m = _pipe_step(api, opt, params, "cuda", case)
    _, cpu, mc = _pipe_step(api, opt, params, "cpu", case)
    assert abs(m["loss"].item() - mc["loss"].item()) <= 1e-4
    for a, w in zip(card, cpu):
        assert a.is_cuda and (a.cpu() - w).abs().max() <= 1e-4
    ref = build_gradsync_program(
        api, opt, PhaserCollective(3, "data", kind="xla_psum"),
        device="cuda")
    p = _to(params, "cuda")
    b = make_batch(api.cfg.vocab_size, 12, 16, seed=0, step=0)
    p2, _, pm2 = ref.step(p, opt.init(p), {
        k: torch.tensor(x, device="cuda") for k, x in b.items()},
        torch.tensor([1.0, 0.0, 1.0], device="cuda"))
    m2 = ref.reduce_metrics(pm2)
    np.testing.assert_allclose(m["loss"].item(), m2["loss"].item(),
                               rtol=1e-5, atol=1e-6)
    for a, w in zip(card, tree_flatten(p2)[1]):
        np.testing.assert_allclose(a.cpu().numpy(), w.cpu().numpy(),
                                   rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("name", sorted(PIPE_CASES))
def test_pipeline_path_launches_the_kernels(name, monkeypatch):
    """On the card the 2-D step launches the attention forward (forward
    waves and recomputes), its backward, and ``bucket_combine`` once a
    round (per readiness group when pipelined: the stage rows fold into
    one launch), and never a plain version."""
    case = PIPE_CASES[name]

    def plain(*a, **k):
        raise AssertionError("a plain version ran on the card")
    for mod, fn in ((FA, "attention_ref"), (FA, "attention_bwd_ref"),
                    (BC, "combine_ref")):
        monkeypatch.setattr(mod, fn, plain)
    api = get_api(get_config("smollm-135m").reduced(n_layers=case[-1]))
    params = api.init_params(torch.Generator().manual_seed(0), "cpu")
    before = (FA.flash_attention.launches, FA.flash_attention_bwd.launches,
              BC.bucket_combine.launches)
    prog, _, _ = _pipe_step(api, AdamW(), params, "cuda", case)
    fwd, bwd, comb = (a - b for a, b in zip(
        (FA.flash_attention.launches, FA.flash_attention_bwd.launches,
         BC.bucket_combine.launches), before))
    S, M, v, ov, _, L = case
    # per rank: each layer's forward once in its forward wave and once in
    # its recompute, its backward once, for each microbatch
    assert fwd == 3 * 2 * M * L and bwd == 3 * M * L, (fwd, bwd)
    groups = prog.layout.n_groups if ov == "pipelined" else 1
    assert comb == len(prog.pc.unified_schedule().rounds) * groups


# ------------------------------------------------ the remaining families
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("B,H,Kh,Sq,Sk,hd,win,causal", [
    (4, 12, 12, 448, 1500, 64, None, False),   # whisper's cross-attention
    (2, 12, 12, 50, 300, 64, None, False),     # Sq < 128 < Sk, ragged
    (1, 12, 12, 1500, 1500, 64, None, False),  # whisper's encoder
    (1, 40, 8, 300, 300, 128, None, True),     # hd 128, g = 5 (llama4)
    (1, 56, 8, 300, 300, 128, None, True),     # hd 128, g = 7 (llava)
    (1, 32, 8, 4608, 4608, 128, 4096, True),   # mixtral's window across S
])
def test_flash_attention_family_shapes_match_plain(B, H, Kh, Sq, Sk, hd,
                                                   win, causal, dtype):
    gen = torch.Generator("cuda").manual_seed(Sq + Sk)
    q = _randn(gen, (B, Sq, H, hd), dtype).transpose(1, 2)
    k = _randn(gen, (B, Sk, Kh, hd), dtype).transpose(1, 2)
    v = _randn(gen, (B, Sk, Kh, hd), dtype).transpose(1, 2)
    n = FA.flash_attention.launches
    got = FA.flash_attention(q, k, v, causal=causal, sliding_window=win)
    assert FA.flash_attention.launches == n + 1
    assert got.shape == q.shape and got.dtype == dtype
    want = FA.attention_ref(q, k, v, causal=causal, sliding_window=win)
    assert _err(got, want) <= TOL[dtype]
    if dtype == torch.bfloat16:
        assert _row_err(got, want) <= FAM_ROW_TOL


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("B,H,Kh,W,hd,mask", [
    (4, 32, 8, 4096, 128, "ring"),   # mixtral's ring, g = 4, with holes
    (4, 12, 12, 1500, 64, "all"),    # whisper's cross keys, g = 1
])
def test_flash_decode_family_shapes_match_plain(B, H, Kh, W, hd, mask,
                                                dtype):
    gen = torch.Generator("cuda").manual_seed(W)
    q = _randn(gen, (B, H, hd), dtype)
    k = _cache_view(gen, B, W, Kh, hd, dtype, True)
    v = _cache_view(gen, B, W, Kh, hd, dtype, True)
    if mask == "all":
        valid = torch.ones((B, W), dtype=torch.int32, device="cuda")
    else:
        valid = torch.randint(0, 2, (B, W), generator=gen, device="cuda",
                              dtype=torch.int32)
    got = FD.flash_decode(q, k, v, valid)
    assert torch.isfinite(got.float()).all()
    want = FD.decode_ref(q, k, v, valid)
    assert _err(got, want) <= TOL[dtype]
    if dtype == torch.bfloat16:
        assert _row_err(got, want) <= FAM_ROW_TOL


def test_moe_layer_full_width_bf16_on_card_matches_cpu_f32():
    """One mixtral-8x7b MoE layer at full width (d_model 4096, d_ff
    14336, 8 experts, top 2) over 256 tokens in groups of 128 with a
    padded tail: bf16 on the card against f32 on the CPU from the same
    values (x and the experts rounded to bf16 once; the router f32, so
    both route alike). Within 2e-2 of max(1, max|ref|); the aux loss,
    f32 on both, within 1e-5."""
    from repro_torch.models import moe
    cfg = get_config("mixtral-8x7b")
    gen = torch.Generator().manual_seed(0)
    p = moe.moe_init(gen, cfg.d_model, cfg.d_ff, cfg.n_experts, layers=None,
                     dtype=torch.bfloat16, device="cpu")
    x = torch.randn((2, 123, cfg.d_model), generator=gen).to(torch.bfloat16)
    kw = dict(top_k=cfg.top_k, capacity_factor=cfg.capacity_factor,
              group_size=128)
    want, want_aux = moe.moe_apply({k: v.float() for k, v in p.items()},
                                   x.float(), **kw)
    got, aux = moe.moe_apply(_to(p, "cuda"), x.cuda(), **kw)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    scale = max(1.0, want.abs().max().item())
    assert _err(got, want.cuda()) <= TOL[torch.bfloat16] * scale
    assert abs(aux.item() - want_aux.item()) <= 1e-5


@pytest.mark.parametrize("name", ["mixtral-8x7b", "llama4-scout-17b-a16e",
                                  "whisper-small", "llava-next-34b"])
def test_family_model_on_card_matches_cpu(name):
    """Reduced f32: prefill logits (with frames or patches), the aux loss
    and decode steps (whisper's with the prefill's cross K/V) on the card
    against the CPU, within 1e-4; the card's run launches both attention
    kernels."""
    cfg = get_config(name).reduced(moe_group_size=16)
    api = get_api(cfg)
    params = api.init_params(torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.tensor(rng.integers(0, cfg.vocab_size,
                                                 (2, 13)))}
    if cfg.is_encdec:
        batch["frames"] = torch.tensor(rng.standard_normal(
            (2, cfg.encoder_seq, cfg.d_model)), dtype=torch.float32)
    if cfg.family == "vlm":
        batch["patches"] = torch.tensor(rng.standard_normal(
            (2, cfg.vision_tokens, cfg.d_model)), dtype=torch.float32)
    outs = {}
    for dev in ("cpu", "cuda"):
        p = _to(params, dev)
        b = _to(batch, dev)
        before = (FA.flash_attention.launches, FD.flash_decode.launches)
        logits, caches = api.prefill_full_fn(p, b)
        (_, metrics), _ = api.value_and_grad(p, {**b, "targets":
                                                 b["tokens"]})
        state = api.init_decode_state(2, 20, dev)
        if cfg.is_encdec:
            state["cross_k"].copy_(caches["cross_k"])
            state["cross_v"].copy_(caches["cross_v"])
        got = [logits, metrics["aux"]]
        for s in range(24):
            t = torch.tensor([s, s + 1], dtype=torch.int32, device=dev)
            lg, state = api.decode_fn(p, state, {
                "token": b["tokens"][:, s % 13], "t": t})
            got.append(lg)
        launched = (FA.flash_attention.launches - before[0],
                    FD.flash_decode.launches - before[1])
        outs[dev] = (got + list(state["layers"].values()), launched)
    for a, b in zip(outs["cpu"][0], outs["cuda"][0]):
        assert b.is_cuda and torch.isfinite(b.float()).all()
        torch.testing.assert_close(b.cpu(), a, rtol=1e-4, atol=1e-4)
    assert outs["cpu"][1] == (0, 0) and min(outs["cuda"][1]) > 0


@pytest.mark.parametrize("name", ["mixtral-8x7b", "whisper-small",
                                  "llava-next-34b"])
def test_launch_serve_cli_families_on_card(name, capsys):
    rc = launch_serve.main(["--arch", name, "--reduced", "--requests", "5",
                            "--batch", "2", "--window", "32",
                            "--prompt-len", "20", "--max-new", "3"])
    assert rc == 0
    assert "served 5/5 requests" in capsys.readouterr().out


# ------------------------------------------------------ multi-host runtime
def _hier_data(device):
    return {"arch": "smollm-135m", "reduced": True, "layers": 2,
            "batch": 2, "seq": 64, "lr": 3e-3, "warmup": 2, "steps": 6,
            "devices": 2, "device": device, "local_kind": "phaser_scsl"}


def test_inproc_cluster_on_card_matches_cpu():
    """3 hosts x 2 ranks stacked on the card, in-process, a join then a
    cooperative failure (reduced smollm, f32): every step's per-host loss
    and the final loss probes within 1e-4 of the same run on the CPU,
    and the probes bitwise equal across the card's hosts."""
    from repro_torch.runtime_dist import DistCoordinator, InprocCluster
    res = {}
    for dev in ("cpu", "cuda"):
        rt = DistCoordinator(InprocCluster(), 3, seed=0,
                             data_for=lambda pid, dev=dev: _hier_data(dev))
        losses = []
        for step in range(6):
            if step == 2:
                rt.request_join(step=step)
            if step == 4:
                rt.request_leave(1, fail=True, step=step)
            out = rt.train_step(step)
            losses.append({p: r["loss"] for p, r in out.items()})
            rt.advance(step=step)
        probes = {p: rt.cluster.call(p, {"op": "loss_probe"})["loss"]
                  for p in sorted(rt.live)}
        rt.close()
        res[dev] = (losses, probes)
    (cl, cp), (gl, gp) = res["cpu"], res["cuda"]
    assert [sorted(x) for x in gl] == [sorted(x) for x in cl]
    for a, b in zip(gl, cl):
        for p in b:
            assert abs(a[p] - b[p]) <= 1e-4, (p, a, b)
    for p in cp:
        assert abs(gp[p] - cp[p]) <= 1e-4, (gp, cp)
    assert len(set(gp.values())) == 1, gp


@pytest.mark.parametrize("m,kind", [(2, "phaser_scsl"), (3, "phaser_scsl"),
                                    (4, "recursive_doubling")])
def test_hier_step_launches_bucket_combine_per_local_round(m, kind):
    """One hierarchical step on the card: ``local_grads`` launches
    ``bucket_combine`` once per round of the local schedule (the whole
    stacked buffer in one launch a round) and ``apply`` none; every row
    holds the local sum."""
    from repro_torch.collective_exec import build_hier_gradsync_program
    api = get_api(get_config("smollm-135m").reduced(n_layers=2))
    opt = AdamW()
    params = api.init_params(torch.Generator("cuda").manual_seed(0), "cuda")
    st = opt.init(params)
    prog = build_hier_gradsync_program(
        api, opt, PhaserCollective(3, "data", kind="phaser_scsl",
                                   keys=(0, 1, 2)),
        local_ranks=m, device="cuda", local_kind=kind)
    bs = [make_batch(api.cfg.vocab_size, 2, 32, seed=r, step=0)
          for r in range(m)]
    batch = {k: torch.tensor(np.stack([b[k] for b in bs]), device="cuda")
             for k in bs[0]}
    torch.cuda.synchronize()
    BC.bucket_combine.launches = 0
    flat, _ = prog.local_grads(params, st, batch, torch.ones(m))
    rounds = len(prog.pc_local.unified_schedule().rounds)
    assert BC.bucket_combine.launches == rounds
    prog.apply(params, st, flat)
    assert BC.bucket_combine.launches == rounds
    red, stacked = prog.last["reduced"], prog.last["stacked"]
    for r in range(m):
        assert torch.equal(red[r], red[0])
    assert _err(red[0], stacked.sum(0)) <= 1e-5 * max(
        1.0, stacked.sum(0).abs().max().item())
