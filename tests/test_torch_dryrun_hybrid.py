"""The per-rank projections on the dry-run's DTensors
(``sharding.project``): every tensor-parallel projection of every family
(the Mamba2 blocks' ``in_proj`` / ``out_proj``, the attention's ``wq`` /
``wk`` / ``wv`` / ``wo``, the MLPs, the xLSTM blocks', the unembedding)
runs ``x @ w`` and both its gradients on the local shards, with declared
placements, instead of DTensor's ``matmul``, whose backward turned a
sequence sharded over "model" into a strided shard of the flattened
token dim (a graph-searched redistribution plan each, minutes a
multi-pod train cell).

The projection is checked on an 8-rank ("pod", "data", "model") =
(2, 2, 2) mesh of threads in this process (torch's threaded process
group: real collectives on real CPU shards), with the rules' layouts of
``x`` and of the weight's parameter, FSDP off and on; gathered, the
output and both gradients are the plain product's bits. Dry-run cells of
the full-width zamba2-7b and qwen2-72b pin what the products cost a
rank. Reduced models' train steps are traced on a fake (2, 2, 4) mesh,
the smallest found on which DTensor's own products plan strided shards.
No test leaves a default group behind. CPU only."""
import threading

import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset

from repro_torch.configs import SHAPES, ShapeConfig
from repro_torch.kernels.flash_attention import attention_flops
from repro_torch.kernels.mamba2_scan import scan_flops
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_world, make_mesh
from repro_torch.models.registry import get_api, get_config
from repro_torch.optim import AdamW
from repro_torch.sharding import (param_shardings, project,
                                  spec_to_placements, use_rules)
from repro_torch.sharding.policies import make_rules
from repro_torch.sharding.rules import _divisible

MESH = ((2, 2, 2), ("pod", "data", "model"))
S0, S1, S2, R, P = Shard(0), Shard(1), Shard(2), Replicate(), Partial()
# case -> (fsdp, x's (batch, seq)); then per "column" / "row" the
# placements of the output, dx and dw as the gradients come back to the
# leaves (x in the rules' layout, w in its parameter's): FSDP gathers w
# where the batch is sharded and reduces dw to w's shard; a decode-sized
# x (fewer elements than w) moves instead, as does a batch of 2 that
# (pod, data) does not divide
CASES = {"tp": (False, (4, 6)), "fsdp": (True, (4, 6)),
         "fsdp-decode": (True, (4, 1)), "fsdp-batch2": (True, (2, 6))}
DECLARED = {
    ("column", "tp"): ((S0, S0, S2), (S0, S0, P), (P, P, S1)),
    ("column", "fsdp"): ((S0, S0, S2), (S0, S0, P), (R, S0, S1)),
    ("column", "fsdp-decode"): ((S0, P, S2), (S0, S0, R), (P, S0, S1)),
    ("column", "fsdp-batch2"): ((R, P, S2), (R, R, R), (R, S0, S1)),
    ("row", "tp"): ((S0, S0, P), (S0, S0, S2), (P, P, S0)),
    ("row", "fsdp"): ((S0, S0, P), (S0, S0, S2), (R, S1, S0)),
    ("row", "fsdp-decode"): ((S0, S2, P), (S0, S0, S2), (P, S1, S0)),
    ("row", "fsdp-batch2"): ((R, S2, P), (R, P, S2), (R, S1, S0)),
}


@pytest.fixture(autouse=True)
def no_group_left_behind():
    assert not dist.is_initialized()
    yield
    assert not dist.is_initialized()


def _on_threads(world_size, fn):
    """``fn(rank)`` on each rank of a threaded process group, one thread
    a rank; the results by rank. The group is destroyed on every rank."""
    from torch.testing._internal.distributed import multi_threaded_pg as mt
    mt._install_threaded_pg()
    torch._C._distributed_c10d._set_thread_isolation_mode(True)
    store, out, errors = dist.HashStore(), [None] * world_size, []

    def worker(rank):
        dist.init_process_group("threaded", rank=rank,
                                world_size=world_size, store=store)
        try:
            out[rank] = fn(rank)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)
            mt.ProcessLocalGroup.exception_handle(e)
        finally:
            dist.destroy_process_group()
    threads = [threading.Thread(target=worker, args=(r,))
               for r in range(world_size)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        torch._C._distributed_c10d._set_thread_isolation_mode(False)
        mt._uninstall_threaded_pg()
    if errors:
        raise errors[0]
    return out


def _exact(gen, *shape):
    """Values k/4, |k| <= 4: every product and sum at these sizes is
    exact in f32, so the per-rank sums have the plain product's bits
    whatever their order."""
    return torch.randint(-4, 5, shape, generator=gen).float() / 4


def _window(shape, mesh, pl):
    local, off = compute_local_shape_and_global_offset(shape, mesh, pl)
    return tuple(slice(o, o + n) for o, n in zip(off, local))


def _dtensor(full, mesh, pl, grad=True):
    """This rank's shard of ``full`` as a DTensor."""
    local = full[_window(full.shape, mesh, pl)].clone()
    return DTensor.from_local(local.requires_grad_(grad), mesh, pl,
                              run_check=False)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("parallel", ["column", "row"])
def test_project_per_rank_is_the_plain_product(parallel, case):
    """On every rank of the (2, 2, 2) mesh, ``x`` in the rules' layout
    (the batch over (pod, data) where it divides; for "row" the last dim
    over "ff") and ``w`` in its parameter's (the shared MLP's gate or
    down, from ``param_shardings``): the declared placements of the
    output and of both gradients, and, gathered, the bits of ``x @ w``
    and its gradients on plain tensors; ``dw`` reduced to the
    parameter's layout is the plain gradient's shard."""
    fsdp, (batch, seq) = CASES[case]
    g = torch.Generator().manual_seed(0)
    x, w, gy = _exact(g, batch, seq, 8), _exact(g, 8, 12), \
        _exact(g, batch, seq, 12)
    xp, wp = x.clone().requires_grad_(), w.clone().requires_grad_()
    yp = xp @ wp
    dxp, dwp = torch.autograd.grad(yp, (xp, wp), gy)
    name = "gate" if parallel == "column" else "down"
    cfg = get_config("zamba2-7b").reduced()

    def rank(_):
        mesh = make_mesh(*MESH, device_type="cpu")
        rules = make_rules(mesh, cfg, fsdp=fsdp)
        wpl = param_shardings({"shared": {"mlp": {name: w}}},
                              rules)["shared"]["mlp"][name]
        xspec = ("batch", None, None if parallel == "column" else "ff")
        xpl = spec_to_placements(
            _divisible(rules.resolve(*xspec), x.shape, mesh), mesh)
        xd, wd = _dtensor(x, mesh, xpl), _dtensor(w, mesh, wpl)
        with use_rules(rules):
            y = project(xd, wd, parallel)
        gpl = tuple(R if p.is_partial() else p for p in y.placements)
        dx, dw = torch.autograd.grad(y, (xd, wd),
                                     _dtensor(gy, mesh, gpl, grad=False))
        return ((tuple(y.placements), tuple(dx.placements),
                 tuple(dw.placements)),
                [t.full_tensor() for t in (y, dx, dw)],
                dw.redistribute(mesh, wpl).to_local(),
                dwp[_window(w.shape, mesh, wpl)])
    for placements, full, dw_shard, want_shard in _on_threads(8, rank):
        assert placements == DECLARED[parallel, case]
        for got, want in zip(full, (yp.detach(), dxp, dwp)):
            assert torch.equal(got, want)
        assert torch.equal(dw_shard, want_shard)


def test_project_without_rules_or_dtensors_is_matmul():
    g = torch.Generator().manual_seed(1)
    x, w = torch.randn(2, 3, 4, generator=g), torch.randn(4, 5, generator=g)
    assert torch.equal(project(x, w, "column"), x @ w)
    with fake_world(8):
        mesh = make_mesh(*MESH, device_type="cpu")
        with use_rules(make_rules(mesh, get_config("zamba2-7b").reduced())):
            assert torch.equal(project(x, w, "row"), x @ w)


# arch -> (config overrides, sequence length, the backward kernel its
# trace must reach, its calls)
STRIDED = {"zamba2-7b": ({"n_layers": 2}, 16, "mamba2_scan_bwd", 2),
           "smollm-135m": ({}, 64, "flash_attention_bwd", 2),
           "xlstm-125m": ({}, 16, "mlstm_chunkwise_bwd", 2),
           "whisper-small": ({}, 16, "flash_attention_bwd", 6)}


@pytest.mark.parametrize("arch", list(STRIDED))
def test_reduced_hybrid_train_trace_plans_no_strided_shard(monkeypatch,
                                                           arch):
    """A reduced model's train step (forward with remat and backward, as
    ``build_train_step`` runs them under its rules) on a fake ("pod",
    "data", "model") = (2, 2, 4) mesh: no redistribution plan DTensor
    makes has a ``_StridedShard`` in its source or target (counted at
    the planner, its cache cleared first). Two batch rows a (pod, data)
    rank do not divide the model axis, so a sequence sharded over it is
    strided in the flattened token dim. With DTensor's own ``matmul``
    for the projections these traces make strided plans, a graph search
    each: the hybrid's in_proj / gate / up 1,560 (the first ~10 s in),
    the others' from their attention, MLP, xLSTM and unembedding
    products (counts in CHANGES.md); on (2, 2, 2) the model axis takes
    the two rows and no plan is strided either way."""
    from torch.distributed.tensor import _redistribute as RD
    from torch.distributed.tensor.placement_types import _StridedShard

    from repro_torch.train.step import build_train_step
    seen = {"calls": 0, "strided": 0}
    plan = RD._gen_transform_infos_non_cached

    def counted(src, dst, *a, **kw):
        seen["calls"] += 1
        if any(isinstance(p, _StridedShard)
               for p in (*src.placements, *dst.placements)):
            seen["strided"] += 1
            raise AssertionError(f"a strided plan: {src} -> {dst}")
        return plan(src, dst, *a, **kw)
    monkeypatch.setattr(RD, "_gen_transform_infos_non_cached", counted)
    RD._gen_transform_infos.cache_clear()
    over, seq, kernel, calls = STRIDED[arch]
    cfg = get_config(arch).reduced(**over)
    api = get_api(cfg)
    try:
        with fake_world(16):
            mesh = make_mesh((2, 2, 4), MESH[1], device_type="cpu")
            rules = make_rules(mesh, cfg)
            ts = build_train_step(api, AdamW(), rules=rules, remat=True)
            params = dryrun._distribute(api.param_spec(), ts.param_sh, mesh)
            batch = dryrun._distribute(
                api.input_specs(ShapeConfig("t", seq, 8, "train")),
                ts.batch_sh, mesh)

            def value_and_grad(params, batch):
                with use_rules(rules):
                    return api.value_and_grad(params, batch, remat=True)
            tr = dryrun.trace_step(value_and_grad, (params, batch))
    finally:
        RD._gen_transform_infos.cache_clear()
    assert seen["calls"] > 0 and seen["strided"] == 0
    assert tr.kernels[kernel]["calls"] == calls


def test_dry_run_hybrid_prefill_cell_runs_the_rules_shards():
    """zamba2-7b x prefill_32k on the 16x16 mesh: ``model_flops_ratio``
    within 2% of a closed form of what a rank runs, 2 sequences of
    32768 tokens (the batch over "data"): every Mamba2 layer's
    ``in_proj`` at its rules' shard of 911 columns and ``out_proj`` at
    448 rows; each shared-block application's ``gate`` / ``up`` at 896
    columns, ``down`` at 896 rows, ``wq`` / ``wk`` / ``wv`` at 224
    columns and ``wo`` at 224 rows; the unembedding at 2000 of the 32000
    vocab rows; the scan at 7 of 112 heads and the attention at 2 of 32.
    With DTensor's own ``matmul`` for ``wq`` / ``wk`` / ``wv`` and the
    unembedding, those four ran at full width on every "model" rank:
    2.3 times these FLOPs; with it for every product, ``in_proj``,
    ``gate`` and ``up`` too, and the first scan on every head: 10.3
    times."""
    from repro_torch.models.transformer import n_shared_apps
    res = dryrun.run_cell("zamba2-7b", "prefill_32k", device_type="cpu")
    assert res["status"] == "ok", res.get("error")
    cfg = get_config("zamba2-7b")
    shape = next(s for s in SHAPES if s.name == "prefill_32k")
    tp = dp = 16
    rows, S, D = shape.global_batch // dp, shape.seq_len, cfg.d_model
    d_inner, nh = cfg.ssm_expand * D, cfg.ssm_expand * D // cfg.ssm_headdim
    hd = D // cfg.n_heads
    in_proj = 2 * d_inner + 2 * cfg.ssm_state + nh
    qkvo = (2 * cfg.n_heads + 2 * cfg.n_kv_heads) * hd
    L, A = cfg.n_layers, n_shared_apps(cfg)
    cols = (L * (in_proj + d_inner) // tp
            + A * (3 * cfg.d_ff + qkvo) // tp + cfg.vocab_size // tp)
    scan = L * scan_flops(rows, nh // tp, S, cfg.ssm_headdim, cfg.ssm_state)
    attn = A * attention_flops(rows, cfg.n_heads // tp, S, S, hd, True,
                               cfg.sliding_window)
    per_rank = 2 * rows * S * D * cols + scan + attn
    expect = res["model_flops"] / (tp * dp * per_rank)
    print(f"model_flops_ratio {res['model_flops_ratio']:.4f}, closed form "
          f"{expect:.4f}")
    assert 0.98 * expect <= res["model_flops_ratio"] <= 1.02 * expect
    assert res["kernels"]["mamba2_scan"]["flops"] == scan


def test_dry_run_dense_prefill_cell_runs_the_rules_shards():
    """qwen2-72b x prefill_32k on the 16x16 mesh (64 heads and the
    152064-row vocab both divide the model axis): ``model_flops_ratio``
    within 2% of a closed form of what a rank runs, 2 sequences of 32768
    tokens (the batch over "data"): every layer's ``wq`` / ``wo`` at 512
    of 8192 columns / rows, ``wk`` / ``wv`` at 64 of 1024 columns,
    ``gate`` / ``up`` / ``down`` at 1848 of 29568; the unembedding at
    9504 vocab rows; the attention on 4 of the 64 query heads, q's own
    shard (its 8 KV heads do not divide the model axis: each rank reads
    the one its 4 heads share). DTensor's own ``matmul`` placed these
    products at the same shards."""
    res = dryrun.run_cell("qwen2-72b", "prefill_32k", device_type="cpu")
    assert res["status"] == "ok", res.get("error")
    cfg = get_config("qwen2-72b")
    shape = next(s for s in SHAPES if s.name == "prefill_32k")
    tp = dp = 16
    rows, S, D, hd = shape.global_batch // dp, shape.seq_len, cfg.d_model, \
        cfg.hd
    qkvo = (2 * cfg.n_heads + 2 * cfg.n_kv_heads) * hd
    L = cfg.n_layers
    cols = L * (3 * cfg.d_ff + qkvo) // tp + cfg.vocab_size // tp
    attn = L * attention_flops(rows, cfg.n_heads // tp, S, S, hd, True,
                               cfg.sliding_window)
    per_rank = 2 * rows * S * D * cols + attn
    expect = res["model_flops"] / (tp * dp * per_rank)
    print(f"model_flops_ratio {res['model_flops_ratio']:.4f}, closed form "
          f"{expect:.4f}")
    assert 0.98 * expect <= res["model_flops_ratio"] <= 1.02 * expect
    assert res["kernels"]["flash_attention"]["flops"] == attn
