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


def test_flash_decode_plain_reads_the_cache_as_a_permuted_view():
    q, k, v, valid = _decode_inputs(2, 9, 3, 40, 64, 5)
    cache_k = torch.tensor(k).permute(0, 2, 1, 3).contiguous()  # (B,W,Kh,hd)
    cache_v = torch.tensor(v).permute(0, 2, 1, 3).contiguous()
    got = FD.flash_decode(torch.tensor(q), cache_k.permute(0, 2, 1, 3),
                          cache_v.permute(0, 2, 1, 3), torch.tensor(valid))
    want = FD.decode_ref(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                         torch.tensor(valid))
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_a_non_cpu_tensor_never_takes_the_plain_version():
    """No fallback: only a CPU tensor reaches the plain version; any
    other device goes to the kernel or raises."""
    q = torch.empty((1, 9, 4, 64), device="meta")
    kv = torch.empty((1, 3, 4, 64), device="meta")
    with pytest.raises(ValueError, match="meta"):
        FA.flash_attention(q, kv, kv)
    with pytest.raises(ValueError, match="meta"):
        FD.flash_decode(q[:, :, 0], kv, kv,
                        torch.empty((1, 4), dtype=torch.int32,
                                    device="meta"))
    x = torch.empty((1, 2, 8, 16), device="meta")
    bc = torch.empty((1, 8, 16), device="meta")
    ad = torch.empty((1, 2, 8), device="meta")
    with pytest.raises(ValueError, match="meta"):
        MS.mamba2_scan(x, bc, bc, ad, ad)
    qkv = torch.empty((1, 2, 8, 32), device="meta")
    with pytest.raises(ValueError, match="meta"):
        MK.mlstm_chunkwise(qkv, qkv, qkv, ad, ad)


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    assert build.sources() == ["bucket_combine", "flash_attention",
                               "flash_attention_bwd", "flash_decode",
                               "mamba2_scan", "mlstm_chunkwise"]
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(build.shutil, "which", lambda _: None)
    monkeypatch.setattr(cpp_ext, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build_all()
    assert not (tmp_path / "kernels").exists()
