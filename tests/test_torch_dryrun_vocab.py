"""The dry-run's vocab-parallel loss and embedding lookup, and attention
on q's own head shards, on DTensors.

Where the vocabulary divides the model axis, the reference keeps its
logits sharded ("batch", None, "vocab") and its lookup's output in
("batch", None, None); where the query heads divide it and the KV heads
do not, it shards q over "heads" and replicates k and v. The port's
per-rank loss reduces a max and a sum over the vocab's shards instead of
gathering them, its lookup reads each rank's own table rows, and its
attention runs each rank's query heads over the KV heads they read.

Checked on the values (a reduced model's loss and gradients on real CPU
shards of an 8-rank thread mesh, against the plain tensors), on the
operations DTensor is asked to run (a multi-pod train trace) and on a
full-width cell's peak. No test leaves a default group behind. CPU
only."""
import threading

import torch
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import ShapeConfig
from repro_torch.kernels import flash_attention as FA
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import HW, make_mesh
from repro_torch.models.registry import get_api, get_config
from repro_torch.optim import AdamW
from repro_torch.sharding import use_rules
from repro_torch.sharding.policies import make_rules
from repro_torch.train.step import build_train_step
from repro_torch.utils import tree_flatten, tree_unflatten
from test_torch_dryrun_hybrid import (MESH, _dtensor, _on_threads,  # noqa: F401
                                      no_group_left_behind)
from test_torch_dryrun_values import ATOL, RTOL


class _LocalShapes(TorchDispatchMode):
    """The last dims of every local op's outputs in this thread (DTensor
    ops are left to DTensor, which runs their local ops inside)."""

    def __init__(self):
        super().__init__()
        self.last = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor) and t.ndim:
                self.last.add(t.shape[-1])
        return out


def test_gqa_vocab_sharded_loss_and_grads_are_the_plain_tensors(monkeypatch):
    """Reduced qwen2.5-3b, one layer, 4 query heads and 1 KV head, vocab
    160 (a tied table; a width no other dim has), batch 4 x 16 tokens,
    tensor-parallel only on the (2, 2, 2) thread mesh: the loss and
    every parameter's gradient, gathered, within ``RTOL`` / ``ATOL`` of
    the plain tensors'. Each rank's attention runs on its own 2 query
    heads (a rule that kept q in k's layout would run all 4), and no
    local op makes a tensor whose last dim is the whole vocabulary (a
    loss that gathered the vocabulary would)."""
    cfg = get_config("qwen2.5-3b").reduced(n_layers=1, n_kv_heads=1,
                                            vocab_size=160)
    api = get_api(cfg)
    params = api.init_params(torch.Generator().manual_seed(0), device="cpu")
    batch = api.make_inputs(ShapeConfig("t", 16, 4, "train"), seed=1,
                            device="cpu")
    (want_loss, _), want = api.value_and_grad(params, batch)
    paths, leaves = tree_flatten(params)
    want = tree_flatten(want)[1]
    heads, lock = [], threading.Lock()
    plain = FA.attention_ref

    def attention_ref(q, k, v, **kw):
        with lock:
            heads.append((q.shape[1], k.shape[1]))
        return plain(q, k, v, **kw)
    monkeypatch.setattr(FA, "attention_ref", attention_ref)

    def rank(_):
        mesh = make_mesh(*MESH, device_type="cpu")
        rules = make_rules(mesh, cfg, fsdp=False)
        ts = build_train_step(api, AdamW(), rules=rules, remat=False)
        dparams = tree_unflatten(paths, [
            _dtensor(x, mesh, pl)
            for x, pl in zip(leaves, tree_flatten(ts.param_sh)[1])])
        bpaths, bleaves = tree_flatten(batch)
        dbatch = tree_unflatten(bpaths, [
            _dtensor(x, mesh, pl, grad=False)
            for x, pl in zip(bleaves, tree_flatten(ts.batch_sh)[1])])
        with use_rules(rules), implicit_replication(), _LocalShapes() as seen:
            (loss, _), grads = api.value_and_grad(dparams, dbatch)
        return (loss.full_tensor(),
                [g.full_tensor() for g in tree_flatten(grads)[1]], seen.last)
    for loss, grads, last in _on_threads(8, rank):
        torch.testing.assert_close(loss, want_loss, rtol=RTOL, atol=ATOL)
        for path, got, exp in zip(paths, grads, want):
            torch.testing.assert_close(got, exp, rtol=RTOL, atol=ATOL,
                                       msg=lambda m: f"{path}: {m}")
        assert cfg.vocab_size not in last
    assert heads and set(heads) == {(2, 1)}, heads


def test_multi_pod_lookup_asks_dtensor_for_no_sharded_index(monkeypatch):
    """smollm-135m x train_4k on 2x16x16 (its 49152-row table sharded
    over "model"): the trace asks DTensor for no ``aten.index``,
    ``aten.embedding`` or ``aten.gather`` of an operand sharded on the
    dim it indexes (the card's DTensor has no rule for the lookup's), and
    reads ``ok``. The ops are read where the dry-run's ``Ledger`` (the
    innermost dispatch mode) hands DTensor's ops on to DTensor."""
    from torch.distributed.tensor import DTensor
    aten = torch.ops.aten
    dims = {aten.index.Tensor: lambda a: next(
                i for i, x in enumerate(a[1]) if x is not None),
            aten.embedding.default: lambda a: 0,
            aten.gather.default: lambda a: a[1] % a[0].ndim}
    found, seen, plain = [], {"ops": 0}, dryrun.Ledger.__torch_dispatch__

    def watched(self, func, types, args=(), kwargs=None):
        if isinstance(args[0], DTensor):
            seen["ops"] += 1
            if func in dims and any(p.is_shard(dims[func](args))
                                    for p in args[0].placements):
                found.append((str(func), args[0].placements))
        return plain(self, func, types, args, kwargs)
    monkeypatch.setattr(dryrun.Ledger, "__torch_dispatch__", watched)
    res = dryrun.run_cell("smollm-135m", "train_4k", multi_pod=True,
                          device_type="cpu")
    assert res["status"] == "ok", res.get("error")
    assert seen["ops"] > 0 and found == []


def test_qwen2_5_3b_train_cell_fits():
    """qwen2.5-3b x train_4k on 16x16 (16 sequences a data rank, the
    151936-row tied table over "model"): the peak fits 80 GB a GPU and
    lies under a closed form of what the reference's layout holds live
    at the loss's backward, 0.1 GB of per-token vectors aside: the
    arguments; remat's saved inputs of the 36 layers and of the final
    norm, 37 x (16, 4096, 2048) bf16 (replicated over "model", as the
    reference's ``h`` is), and two f32 tensors of that shape; the rank's
    logits shard (16, 4096, 9496) bf16, its gradient, and the one f32
    copy of it that the loss exponentiates. A loss that gathered the
    whole vocabulary peaked at 137.4 GB."""
    res = dryrun.run_cell("qwen2.5-3b", "train_4k", device_type="cpu")
    assert res["status"] == "ok", res.get("error")
    cfg = get_config("qwen2.5-3b")
    rows, S, D = 256 // 16, 4096, cfg.d_model
    shard = rows * S * (cfg.vocab_size // 16)
    closed = (res["argument_bytes"] + (cfg.n_layers + 1) * rows * S * D * 2
              + 2 * rows * S * D * 4 + shard * (2 + 2 + 4) + 1e8)
    print(f"peak {res['peak_bytes'] / 1e9:.3f} GB, closed form "
          f"{closed / 1e9:.3f} GB")
    assert res["fits"] and res["peak_bytes"] <= HW["hbm_bytes"]
    assert res["peak_bytes"] <= closed
