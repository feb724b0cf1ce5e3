"""The kernels' plain versions in the port against the JAX package: the
Pallas kernels run with ``interpret=True`` and the ``kernels/ref.py``
oracles, on the same numpy inputs, in f32 (tolerance 2e-5, as
``test_kernels.py``). CPU tensors take the plain path, so the launch
counters stay 0."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils.cpp_extension as cpp_ext

from repro.kernels import ref
from repro.kernels.ops import flash_attention_op, flash_decode_op
from repro_torch.kernels import bucket_combine as BC
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import flash_decode as FD
from repro_torch.kernels import mamba2_scan as MS
from repro_torch.kernels import mlstm_kernel as MK

TOL = dict(rtol=2e-5, atol=2e-5)


def _np(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _check(got: torch.Tensor, *wants):
    for w in wants:
        np.testing.assert_allclose(got.numpy(), np.asarray(w), **TOL)


@pytest.fixture(autouse=True)
def _no_launches():
    a, d = FA.flash_attention.launches, FD.flash_decode.launches
    yield
    assert FA.flash_attention.launches == a
    assert FD.flash_decode.launches == d


@pytest.mark.parametrize("B,H,Kh,S,hd,win", [
    (2, 4, 4, 256, 64, None),          # MHA causal
    (1, 8, 2, 256, 64, None),          # GQA 4:1
    (2, 4, 2, 512, 32, 128),           # GQA + sliding window
    (1, 2, 1, 128, 128, None),         # head_dim 128
    (2, 9, 3, 128, 64, None),          # smollm: GQA 3:1
    (1, 4, 4, 256, 112, None),         # zamba2's shared block: hd 112
])
def test_flash_attention_plain_vs_pallas_and_ref(B, H, Kh, S, hd, win):
    rng = np.random.default_rng(0)
    q, k, v = (_np(rng, (B, H, S, hd)), _np(rng, (B, Kh, S, hd)),
               _np(rng, (B, Kh, S, hd)))
    got = FA.flash_attention(torch.tensor(q), torch.tensor(k),
                             torch.tensor(v), causal=True,
                             sliding_window=win)
    pallas = flash_attention_op(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=True,
                                sliding_window=win, block_q=128,
                                block_k=128, interpret=True)
    oracle = ref.attention_ref(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=True,
                               sliding_window=win)
    _check(got, pallas, oracle)


@pytest.mark.parametrize("Sq", [1, 7, 100])
@pytest.mark.parametrize("win", [None, 5])
def test_flash_attention_plain_ragged_vs_ref(Sq, win):
    """Prefill buckets are 1, 2, 4, ...: lengths no tile divides (the
    Pallas kernel asserts divisibility, so only the oracle is held)."""
    rng = np.random.default_rng(Sq)
    q, k, v = (_np(rng, (2, 9, Sq, 64)), _np(rng, (2, 3, Sq, 64)),
               _np(rng, (2, 3, Sq, 64)))
    got = FA.flash_attention(torch.tensor(q), torch.tensor(k),
                             torch.tensor(v), sliding_window=win)
    _check(got, ref.attention_ref(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), sliding_window=win))


def test_flash_attention_strided_views_take_the_model_layout():
    """The model passes (B,S,H,hd) projections as transposed views."""
    rng = np.random.default_rng(3)
    q = torch.tensor(_np(rng, (2, 10, 9, 64)))
    k = torch.tensor(_np(rng, (2, 10, 3, 64)))
    v = torch.tensor(_np(rng, (2, 10, 3, 64)))
    got = FA.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2))
    want = FA.attention_ref(q.transpose(1, 2).contiguous(),
                            k.transpose(1, 2).contiguous(),
                            v.transpose(1, 2).contiguous())
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def _lse_f64(q, k, causal, win):
    """Natural-log sum of exp over each row's masked scores, float64."""
    B, H, Sq, hd = q.shape
    Kh, Sk = k.shape[1], k.shape[2]
    kr = np.repeat(k.astype(np.float64), H // Kh, axis=1)
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64), kr) / np.sqrt(hd)
    qpos, kpos = np.arange(Sq)[:, None], np.arange(Sk)[None, :]
    mask = np.ones((Sq, Sk), dtype=bool)
    if causal:
        mask &= kpos <= qpos
    if win is not None:
        mask &= qpos - kpos < win
    s = np.where(mask, s, FA.NEG_INF)
    m = s.max(axis=-1, keepdims=True)
    return (m + np.log(np.exp(s - m).sum(axis=-1, keepdims=True)))[..., 0]


@pytest.mark.parametrize("B,H,Kh,Sq,Sk,hd,win,causal", [
    (2, 4, 4, 64, 64, 64, None, True),     # causal
    (1, 9, 3, 100, 100, 64, 5, True),      # GQA 3:1, sliding window
    (2, 8, 2, 7, 7, 32, None, True),       # ragged, GQA 4:1
    (1, 4, 1, 33, 50, 112, None, False),   # Sq != Sk, not causal, hd 112
])
def test_attention_lse_ref_vs_float64(B, H, Kh, Sq, Sk, hd, win, causal):
    """The plain version of the LSE the forward kernel saves for the
    backward: natural log, masked keys as the kernel masks them."""
    rng = np.random.default_rng(Sq + hd)
    q, k = _np(rng, (B, H, Sq, hd)), _np(rng, (B, Kh, Sk, hd))
    got = FA.attention_lse_ref(torch.tensor(q), torch.tensor(k),
                               causal=causal, sliding_window=win)
    assert got.shape == (B, H, Sq) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _lse_f64(q, k, causal, win),
                               rtol=1e-5, atol=1e-5)


def _bf16_view(shape, perm=None, offset=0):
    """A bf16 CPU tensor of ``shape``, viewed through ``perm`` and
    ``offset`` elements into its buffer."""
    n = int(np.prod(shape))
    buf = torch.zeros(n + 8, dtype=torch.bfloat16)
    t = buf[offset:offset + n].view(shape)
    return t.permute(*perm) if perm else t


@pytest.mark.parametrize("case,ok", [
    # smollm's (B, S, 9, 64) and (B, S, 3, 64) projections as (B,H,S,hd)
    (lambda: _bf16_view((4, 1024, 9, 64), (0, 2, 1, 3)), True),
    (lambda: _bf16_view((4, 1024, 3, 64), (0, 2, 1, 3)), True),
    # zamba2's (B, S, 32, 112) shared-block projections
    (lambda: _bf16_view((2, 2048, 32, 112), (0, 2, 1, 3)), True),
    (lambda: _bf16_view((2, 9, 100, 64)), True),           # contiguous
    (lambda: _bf16_view((1, 4, 1, 16)), True),              # one token
    # a base one element (2 bytes) off 16 bytes
    (lambda: _bf16_view((2, 9, 100, 64), offset=1), False),
    # a row stride of 68 elements: 136 bytes, not a multiple of 16
    (lambda: _bf16_view((2, 100, 3, 68), (0, 2, 1, 3))[..., :64], False),
    # the last dim not contiguous
    (lambda: _bf16_view((2, 64, 9, 100), (0, 2, 3, 1)), False),
], ids=["smollm-q", "smollm-kv", "zamba2", "contiguous", "one-token",
        "base-off-16", "stride-not-16", "last-dim-strided"])
def test_tma_layout_check(case, ok):
    """The bf16 kernels read through TMA; the wrapper's pure layout check
    takes what the models pass and refuses what TMA cannot read."""
    t = case()
    assert FA._tma_layout_ok(t.shape, t.stride(), t.data_ptr(),
                             t.element_size()) is ok


def _decode_inputs(B, H, Kh, W, hd, seed, all_invalid_row=False):
    rng = np.random.default_rng(seed)
    q, k, v = (_np(rng, (B, H, hd)), _np(rng, (B, Kh, W, hd)),
               _np(rng, (B, Kh, W, hd)))
    lengths = rng.integers(1, W, (B,))
    valid = (np.arange(W)[None, :] < lengths[:, None]).astype(np.int32)
    if all_invalid_row:
        valid[0] = 0
    return q, k, v, valid


@pytest.mark.parametrize("B,H,Kh,W,hd,all_invalid", [
    (2, 4, 4, 512, 64, False), (2, 8, 2, 1024, 64, False),
    (1, 4, 1, 256, 128, False), (3, 9, 3, 100, 64, False),
    (2, 9, 3, 256, 64, True), (2, 4, 4, 256, 112, False)])
def test_flash_decode_plain_vs_pallas_and_ref(B, H, Kh, W, hd,
                                              all_invalid):
    q, k, v, valid = _decode_inputs(B, H, Kh, W, hd, W, all_invalid)
    got = FD.flash_decode(torch.tensor(q), torch.tensor(k),
                          torch.tensor(v), torch.tensor(valid))
    jq, jk, jv, jval = map(jnp.asarray, (q, k, v, valid))
    pallas = flash_decode_op(jq, jk, jv, jval, block_k=256, interpret=True)
    oracle = ref.decode_ref(jq, jk, jv, jval)
    _check(got, pallas, oracle)
    if all_invalid:
        # no valid slot: the uniform mean of v, never NaN
        want = v[0].mean(axis=1).repeat(H // Kh, axis=0)
        np.testing.assert_allclose(got[0].numpy(), want, **TOL)


def _decode_split_ref(q, k, v, valid, tile=64, splits=8):
    """The CUDA kernel's algorithm in plain f32 (tests only): W cut into
    64-key tiles, the tiles spread over at most 8 splits; a tile with no
    valid key is skipped when its row has a valid key elsewhere (a row
    with none scores every slot -1e30); each split keeps an online
    softmax state (m, l, acc), and the splits merge by log-sum-exp in
    split order. Returns the output and the number of tiles read."""
    B, H, hd = q.shape
    Kh, W = k.shape[1], k.shape[2]
    kr = k.repeat_interleave(H // Kh, dim=1)
    vr = v.repeat_interleave(H // Kh, dim=1)
    scores = torch.einsum("bhd,bhwd->bhw", q, kr) / np.sqrt(hd)
    ntiles = -(-W // tile)
    splits = min(splits, ntiles)
    out, read = torch.empty_like(q), 0

    def weight(m, top):
        return torch.where(m == -np.inf, torch.zeros_like(m),
                           torch.exp(m - top))

    for b in range(B):
        row_any = bool((valid[b] > 0).any())
        parts = []
        for r in range(splits):
            m = torch.full((H,), -np.inf)
            l, acc = torch.zeros(H), torch.zeros(H, hd)
            for t in range(r * ntiles // splits, (r + 1) * ntiles // splits):
                cut = slice(t * tile, min(W, (t + 1) * tile))
                ok = valid[b, cut] > 0
                if row_any and not ok.any():
                    continue
                read += 1
                sc = torch.where(ok, scores[b, :, cut],
                                 torch.tensor(-np.inf if row_any else -1e30))
                top = torch.maximum(m, sc.max(-1).values)
                alpha, p = weight(m, top), weight(sc, top[:, None])
                l = l * alpha + p.sum(-1)
                acc = (acc * alpha[:, None]
                       + torch.einsum("hw,hwd->hd", p, vr[b, :, cut]))
                m = top
            parts.append((m, l, acc))
        top = torch.stack([m for m, _, _ in parts]).max(0).values
        l_all = sum(l * weight(m, top) for m, l, _ in parts)
        o_all = sum(acc * weight(m, top)[:, None] for m, _, acc in parts)
        out[b] = o_all / torch.clamp(l_all, min=1e-30)[:, None]
    return out, read


@pytest.mark.parametrize("B,H,Kh,W,hd,mask", [
    (2, 9, 3, 1024, 64, "holes"),      # smollm's served shape
    (2, 9, 3, 1024, 64, "prefix"),     # whole empty tiles past the length
    (3, 4, 4, 300, 112, "prefix"),     # hd 112, ragged W: a part tile
    (2, 16, 1, 65, 64, "prefix"),      # g = 16, one slot past a tile
    (2, 8, 2, 100, 32, "none"),        # no valid slot anywhere
    (1, 4, 4, 1, 16, "holes"),         # one slot
])
def test_flash_decode_split_ref_vs_plain_and_pallas(B, H, Kh, W, hd, mask):
    """Skipping the tiles with no valid key and merging the splits'
    states by log-sum-exp is exact: it matches ``decode_ref`` and the
    Pallas kernel, including a row with no valid slot (mean of v)."""
    rng = np.random.default_rng(W + hd)
    q, k, v = (_np(rng, (B, H, hd)), _np(rng, (B, Kh, W, hd)),
               _np(rng, (B, Kh, W, hd)))
    if mask == "holes":
        valid = rng.integers(0, 2, (B, W))
    else:                               # valid up to at most half of W
        lengths = rng.integers(1, W // 2 + 2, (B, 1))
        valid = np.arange(W)[None, :] < lengths * (mask == "prefix")
    valid = valid.astype(np.int32)
    valid[0] = 0                        # and a row with no valid slot
    tq, tk, tv, tval = map(torch.tensor, (q, k, v, valid))
    got, read = _decode_split_ref(tq, tk, tv, tval)
    if mask == "prefix":                # tiles past each length skipped
        assert read < B * -(-W // 64)
    jq, jk, jv, jval = map(jnp.asarray, (q, k, v, valid))
    pallas = flash_decode_op(jq, jk, jv, jval,
                             block_k=256 if W % 256 == 0 else W,
                             interpret=True)
    _check(got, FD.decode_ref(tq, tk, tv, tval).numpy(), pallas,
           ref.decode_ref(jq, jk, jv, jval))


def test_flash_decode_plain_reads_the_cache_as_a_permuted_view():
    q, k, v, valid = _decode_inputs(2, 9, 3, 40, 64, 5)
    cache_k = torch.tensor(k).permute(0, 2, 1, 3).contiguous()  # (B,W,Kh,hd)
    cache_v = torch.tensor(v).permute(0, 2, 1, 3).contiguous()
    got = FD.flash_decode(torch.tensor(q), cache_k.permute(0, 2, 1, 3),
                          cache_v.permute(0, 2, 1, 3), torch.tensor(valid))
    want = FD.decode_ref(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                         torch.tensor(valid))
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_a_non_cpu_tensor_never_takes_the_plain_version(monkeypatch):
    """No fallback: only a CPU tensor reaches the plain version. A
    ``meta`` tensor (the dry-run's) takes the meta rule: empty outputs,
    no plain computation and no launch counted."""
    def plain(*a, **k):
        raise AssertionError("a meta tensor reached the plain version")
    for mod, name in ((FA, "attention_ref"), (FA, "attention_bwd_ref"),
                      (FD, "decode_ref"), (MS, "mamba2_scan_plain"),
                      (MK, "mlstm_chunkwise_plain"), (BC, "combine_ref")):
        monkeypatch.setattr(mod, name, plain)
    counts = [f.launches for f in (FA.flash_attention, FD.flash_decode,
                                   MS.mamba2_scan, MK.mlstm_chunkwise,
                                   BC.bucket_combine)]
    q = torch.empty((1, 9, 4, 64), device="meta")
    kv = torch.empty((1, 3, 4, 64), device="meta")
    outs = [FA.flash_attention(q, kv, kv)]
    outs.append(FD.flash_decode(q[:, :, 0], kv, kv,
                                torch.empty((1, 4), dtype=torch.int32,
                                            device="meta")))
    x = torch.empty((1, 2, 8, 16), device="meta")
    bc = torch.empty((1, 8, 16), device="meta")
    ad = torch.empty((1, 2, 8), device="meta")
    outs.append(MS.mamba2_scan(x, bc, bc, ad, ad))
    qkv = torch.empty((1, 2, 8, 32), device="meta")
    outs.append(MK.mlstm_chunkwise(qkv, qkv, qkv, ad, ad))
    acc = torch.empty((2, 3, 8), device="meta")
    outs.append(BC.bucket_combine(acc, acc, torch.empty(
        (2,), dtype=torch.int32, device="meta")))
    assert all(o.device.type == "meta" for o in outs)
    assert counts == [f.launches for f in (
        FA.flash_attention, FD.flash_decode, MS.mamba2_scan,
        MK.mlstm_chunkwise, BC.bucket_combine)]


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    assert build.sources() == ["bucket_combine", "flash_attention",
                               "flash_attention_bwd", "flash_decode",
                               "mamba2_scan", "mamba2_scan_bwd",
                               "mlstm_chunkwise", "mlstm_chunkwise_bwd"]
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(build.shutil, "which", lambda _: None)
    monkeypatch.setattr(cpp_ext, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build_all()
    assert not (tmp_path / "kernels").exists()
