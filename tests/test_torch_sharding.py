"""The port's sharding rules on a ``DeviceMesh`` and its dry-run, held
against the JAX package's rules on an ``AbstractMesh`` of the same
shape (built here: no devices, no subprocess). The port's meshes are a
``"fake"`` process group of 256 or 512 ranks (``launch.mesh.fake_world``);
no test leaves a default group behind. CPU only."""
import math

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh, PartitionSpec as P

from repro.configs import SHAPES_BY_NAME as J_SHAPES
from repro.models.registry import get_api as j_get_api
from repro.optim import AdamW as JAdamW
from repro.roofline.analysis import model_flops as j_model_flops
from repro.sharding import policies as JP
from repro.sharding.rules import param_specs as j_param_specs
from repro_torch.configs import ALL_ARCHS, SHAPES_BY_NAME, ShapeConfig
from repro_torch.kernels import bucket_combine as BC
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import flash_decode as FD
from repro_torch.kernels import mamba2_scan as MS
from repro_torch.kernels import meta as kmeta
from repro_torch.kernels import mlstm_kernel as MK
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_world, make_production_mesh
from repro_torch.models.registry import get_api, get_config
from repro_torch.sharding import (ShardingRules, constrain, param_specs,
                                  spec_to_placements, use_rules)
from repro_torch.sharding import policies
from repro_torch.utils import tree_flatten

MESHES = [False, True]
MESH_IDS = ["16x16", "2x16x16"]


@pytest.fixture(autouse=True)
def no_group_left_behind():
    assert not dist.is_initialized()
    yield
    assert not dist.is_initialized()


def _abstract(multi_pod):
    if multi_pod:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


def _norm(spec):
    """A spec entry as a name, a tuple of names, or None (a one-name
    tuple is its name, as a ``PartitionSpec`` treats it)."""
    out = []
    for e in tuple(spec):
        if isinstance(e, (tuple, list)):
            e = e[0] if len(e) == 1 else tuple(e)
        out.append(e)
    return tuple(out)


def _jspecs(tree):
    """path -> normalized spec of a reference spec tree."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): _norm(s) for path, s in flat}


def _tspecs(tree):
    paths, specs = tree_flatten(tree)
    return {"/".join(p): _norm(s) for p, s in zip(paths, specs)}


def _divides(shape, spec, sizes):
    for d, e in enumerate(spec):
        for a in ((e,) if isinstance(e, str) else (e or ())):
            if shape[d] % sizes[a]:
                return False
    return True


# ------------------------------------------------------------------ specs
@pytest.mark.parametrize("multi_pod", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_and_batch_specs_match_reference(arch, multi_pod):
    """Every parameter's spec, and every shape's batch specs, as the
    reference derives them; every spec divides its dim."""
    am, japi, api = _abstract(multi_pod), j_get_api(arch), get_api(arch)
    jrules = JP.make_rules(am, japi.cfg)
    sizes = dict(am.shape)
    with fake_world(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        rules = policies.make_rules(mesh, api.cfg)
        got = _tspecs(param_specs(api.param_spec(), rules))
        want = _jspecs(j_param_specs(japi.param_spec(), jrules))
        assert got == want
        for p, x in zip(*tree_flatten(api.param_spec())):
            assert _divides(x.shape, got["/".join(p)], sizes), p
        for name, shape in SHAPES_BY_NAME.items():
            assert _tspecs(policies.batch_specs(
                rules, api.input_specs(shape))) == _jspecs(JP.batch_specs(
                    jrules, japi.input_specs(J_SHAPES[name])))


@pytest.mark.parametrize("multi_pod", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_decode_state_specs_match_reference(arch, multi_pod):
    am, japi, api = _abstract(multi_pod), j_get_api(arch), get_api(arch)
    jrules = JP.make_rules(am, japi.cfg)
    sizes = dict(am.shape)
    with fake_world(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        rules = policies.make_rules(mesh, api.cfg)
        for batch, window in ((128, 32768), (1, 8192)):
            st = api.decode_state_spec(batch, window)
            for split_k in (False, True):
                got = _tspecs(policies.decode_state_specs(
                    rules, api.cfg, st, mesh, batch=batch, split_k=split_k))
                want = _jspecs(JP.decode_state_specs(
                    jrules, japi.cfg, japi.decode_state_spec(batch, window),
                    am, batch=batch, split_k=split_k))
                assert got == want, (batch, split_k)
                for p, x in zip(*tree_flatten(st)):
                    assert _divides(x.shape, got["/".join(p)], sizes), p


def test_small_model_dp_over_model_replicates_params():
    """As the reference's test of the same name: the model axis folds
    into data parallelism and every parameter is replicated."""
    cfg = get_config("smollm-135m")
    with fake_world(256):
        mesh = make_production_mesh(device_type="cpu")
        rules = policies.make_rules(mesh, cfg, dp_over_model=True)
        assert rules.logical["batch"] == ("data", "model")
        assert rules.logical["heads"] is None
        assert rules.logical["ff"] is None
        specs = _tspecs(param_specs(get_api(cfg).param_spec(), rules))
        assert all(all(e is None for e in s) for s in specs.values())
    jr = JP.make_rules(_abstract(False), cfg, dp_over_model=True)
    assert jr.logical == rules.logical


class _Dev:
    """A stand-in device for the reference's mesh constructor."""

    def __init__(self, i):
        self.id = i


@pytest.mark.parametrize("stages,data", [(3, 2), (2, 4)])
def test_stage_data_mesh_layout_matches_reference(stages, data):
    want = JP.stage_data_mesh(stages, data,
                              devices=[_Dev(i) for i in range(8)])
    with fake_world(8):
        got = policies.stage_data_mesh(stages, data, device_type="cpu")
        assert got.mesh_dim_names == want.axis_names
        assert got.mesh.tolist() == [[d.id for d in row]
                                     for row in want.devices]


def test_spec_to_placements_and_constrain():
    from torch.distributed.tensor import DTensor, Replicate, Shard
    x = torch.ones(4, 4)
    assert constrain(x, "batch", None) is x              # no rules: no-op
    with use_rules(ShardingRules(mesh=None)):
        assert constrain(x, "batch", None) is x
    with fake_world(512):
        mesh = make_production_mesh(multi_pod=True, device_type="cpu")
        assert spec_to_placements((("pod", "data"), None, "model"),
                                  mesh) == (Shard(0), Shard(0), Shard(2))
        assert spec_to_placements((), mesh) == (Replicate(),) * 3
        with pytest.raises(ValueError, match="order"):
            spec_to_placements((("data", "pod"),), mesh)
        with pytest.raises(ValueError, match="twice"):
            spec_to_placements(("data", "data"), mesh)
        rules = policies.make_rules(mesh, get_config("qwen2.5-3b"))
        t = DTensor.from_local(torch.empty(32, 8, 16, device="meta"), mesh,
                               [Replicate()] * 3, run_check=False)
        with use_rules(rules):
            out = constrain(t, "batch", None, "ff")
            # a batch of 2 is not divided by pod x data (32): unsharded
            small = constrain(t[:2], "batch", None, "ff")
        assert out.placements == (Shard(0), Shard(0), Shard(2))
        assert out.to_local().shape == (1, 8, 1)
        assert small.placements == (Replicate(), Replicate(), Shard(2))


# -------------------------------------------------------------- meta rules
def _meta_cases():
    """(name, call, CPU inputs): each wrapper at a small shape."""
    g = torch.Generator().manual_seed(0)

    def r(*s, dtype=torch.float32):
        return torch.randn(*s, generator=g).to(dtype)
    return [
        ("flash_attention", lambda q, k, v: FA.flash_attention(
            q, k, v, causal=True, sliding_window=3),
         (r(2, 4, 8, 16, dtype=torch.bfloat16),
          r(2, 2, 8, 16, dtype=torch.bfloat16),
          r(2, 2, 8, 16, dtype=torch.bfloat16))),
        ("flash_decode", FD.flash_decode,
         (r(2, 4, 16), r(2, 2, 8, 16), r(2, 2, 8, 16),
          torch.ones(2, 8, dtype=torch.int32))),
        ("mamba2_scan", lambda *t: MS.mamba2_scan(
            *t, chunk=4, out_dtype=torch.float32),
         (r(2, 3, 8, 16), r(2, 8, 16), r(2, 8, 16), r(2, 3, 8).sigmoid(),
          r(2, 3, 8).exp())),
        ("mlstm_chunkwise", lambda *t: MK.mlstm_chunkwise(
            *t, out_dtype=torch.bfloat16),
         (r(2, 3, 8, 32), r(2, 3, 8, 32), r(2, 3, 8, 32), r(2, 3, 8),
          r(2, 3, 8))),
        ("bucket_combine", lambda a, y, gt: BC.bucket_combine(a, y, gt),
         (r(2, 3, 8), r(2, 3, 8), torch.tensor([1, 0], dtype=torch.int32))),
    ]


@pytest.mark.parametrize("case", range(5))
def test_meta_rule_matches_plain_shapes_and_dtypes(case):
    """A meta input gives the plain version's output shape and dtype,
    reports the kernel's work once and counts no launch."""
    name, call, ins = _meta_cases()[case]
    want = call(*ins)
    fn = {"flash_attention": FA.flash_attention,
          "flash_decode": FD.flash_decode, "mamba2_scan": MS.mamba2_scan,
          "mlstm_chunkwise": MK.mlstm_chunkwise,
          "bucket_combine": BC.bucket_combine}[name]
    n = fn.launches
    with kmeta.count_work() as work:
        got = call(*(t.to("meta") for t in ins))
    assert got.device.type == "meta"
    assert (got.shape, got.dtype) == (want.shape, want.dtype)
    assert fn.launches == n
    assert work[name]["calls"] == 1 and work[name]["flops"] > 0
    if name == "flash_attention":
        assert work[name]["flops"] == FA.attention_flops(
            2, 4, 8, 8, 16, True, 3)


def test_meta_attention_backward_and_dtensor_inputs():
    """The attention's meta rule under autograd (its backward reports
    2.5x the forward's products) and on DTensors through ``local_map``:
    heads stay sharded where the KV heads divide, and q's stay sharded
    where only the query heads do (k and v replicated, each rank reading
    the KV head its query heads share); the work is one rank's."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    q = torch.empty(2, 4, 8, 16, device="meta", requires_grad=True)
    kv = torch.empty(2, 2, 8, 16, device="meta", requires_grad=True)
    with kmeta.count_work() as work:
        FA.flash_attention(q, kv, kv).sum().backward()
    assert q.grad.shape == q.shape and kv.grad.shape == kv.shape
    assert work["flash_attention_bwd"]["flops"] == \
        2.5 * work["flash_attention"]["flops"]
    with fake_world(256):
        mesh = make_production_mesh(device_type="cpu")

        def dt(local, pl, shape):
            return DTensor.from_local(torch.empty(*local, device="meta"),
                                      mesh, pl, run_check=False,
                                      shape=shape,
                                      stride=torch.empty(shape).stride())
        pl = [Shard(0), Shard(1)]
        qd = dt((2, 2, 64, 16), pl, (32, 32, 64, 16))
        kd = dt((2, 1, 64, 16), pl, (32, 16, 64, 16))
        with kmeta.count_work() as work:
            out = FA.flash_attention(qd, kd, kd)
        assert out.shape == qd.shape and tuple(out.placements) == tuple(pl)
        assert work["flash_attention"]["flops"] == FA.attention_flops(
            2, 2, 64, 64, 16, True, None)
        # 32 query heads over 8 KV heads: the KV heads do not divide 16,
        # so q keeps its 2 heads a rank and k / v come replicated, of
        # which the rank reads the one KV head its 2 heads share
        kd8 = dt((2, 8, 64, 16), [Shard(0), Replicate()], (32, 8, 64, 16))
        with kmeta.count_work() as work:
            out = FA.flash_attention(qd, kd8, kd8)
        assert tuple(out.placements) == tuple(pl)
        assert work["flash_attention"]["flops"] == FA.attention_flops(
            2, 2, 64, 64, 16, True, None)
        # f32 bytes of q, of k and v (one KV head each), of the output
        assert work["flash_attention"]["bytes"] == 4 * 64 * 16 * (
            2 * 2 + 2 * 2 * 1 + 2 * 2)


def test_count_work_sees_calls_on_other_threads():
    """Autograd runs a CUDA backward on a thread of its own: a kernel call
    there counts toward the step that started it."""
    import threading
    q = torch.empty(1, 2, 4, 16, device="meta")
    with kmeta.count_work() as work:
        t = threading.Thread(target=FA.flash_attention, args=(q, q, q))
        t.start()
        t.join(timeout=30)
    assert not t.is_alive()
    assert work["flash_attention"]["calls"] == 1
    assert not kmeta.counting()


# ---------------------------------------------------------- model, no rules
def test_model_with_rules_off_is_unchanged(monkeypatch):
    """With no rules, every ``constrain`` returns its input: a reduced
    smollm's loss and gradients are bitwise those of the same model with
    the hints taken out, through ``build_train_step(rules=None)`` as
    through the API; RoPE over (1, S) positions is bitwise RoPE over the
    batch-expanded ones."""
    from repro_torch.models import (attention, encdec, layers, moe, ssm,
                                    transformer, xlstm)
    from repro_torch.models.layers import apply_rope
    from repro_torch.optim import AdamW
    from repro_torch.train.step import build_train_step
    cfg = get_config("smollm-135m").reduced()
    api = get_api(cfg)
    params = api.init_params(torch.Generator().manual_seed(0), device="cpu")
    batch = api.make_inputs(ShapeConfig("t", 16, 2, "train"), seed=1,
                            device="cpu")
    (loss, metrics), grads = api.value_and_grad(params, batch)
    step = build_train_step(api, AdamW(), rules=None, remat=False)
    assert step.param_sh is None
    _, _, m = step.fn(params, AdamW().init(params), batch)
    assert torch.equal(m["loss"], metrics["loss"])
    for mod in (attention, encdec, layers, moe, ssm, transformer, xlstm):
        monkeypatch.setattr(mod, "constrain", lambda x, *a: x)
    (loss2, _), grads2 = api.value_and_grad(params, batch)
    assert torch.equal(loss, loss2)
    for a, b in zip(tree_flatten(grads)[1], tree_flatten(grads2)[1]):
        assert torch.equal(a, b)
    x = torch.randn(3, 5, 2, 8)
    pos = torch.arange(5, dtype=torch.int32)[None]
    assert torch.equal(apply_rope(x, pos, 1e4),
                       apply_rope(x, pos.expand(3, 5), 1e4))


@pytest.mark.parametrize("over", [{}, {"family": "ssm",
                                       "hybrid_attn_every": 0}],
                         ids=["hybrid", "ssm"])
def test_hybrid_with_rules_off_is_the_plain_product(monkeypatch, over):
    """With no rules, the hybrid's and the plain ssm's per-rank
    projections (``sharding.project``) are ``x @ w``: a reduced zamba2's
    logits, loss and gradients are bitwise those of the same model with
    every projection written ``x @ w`` (the unembedding ``x @ w.t()``)
    and the hints taken out."""
    from repro_torch.models import attention, layers, ssm, transformer
    cfg = get_config("zamba2-7b").reduced(**over)
    api = get_api(cfg)
    params = api.init_params(torch.Generator().manual_seed(0), device="cpu")
    batch = api.make_inputs(ShapeConfig("t", 16, 2, "train"), seed=1,
                            device="cpu")

    def run():
        return (transformer.forward(cfg, params, batch["tokens"])[0],
                api.value_and_grad(params, batch))
    want = run()
    for mod in (attention, layers, ssm, transformer):
        monkeypatch.setattr(mod, "constrain", lambda x, *a: x)
    for mod in (attention, layers, ssm):
        monkeypatch.setattr(mod, "project", lambda x, w, parallel: x @ (
            w.t() if parallel == "vocab" else w))
    (logits, ((loss, _), grads)), (logits2, ((loss2, _), grads2)) = \
        want, run()
    assert torch.equal(logits, logits2) and torch.equal(loss, loss2)
    for a, b in zip(tree_flatten(grads)[1], tree_flatten(grads2)[1]):
        assert torch.equal(a, b)


# ----------------------------------------------------------------- dry-run
def _ref_local_bytes(tree, specs, sizes):
    """Rank 0's bytes of ``tree`` (reference shape/dtype leaves) laid out
    by the reference's ``specs``."""
    leaves = jax.tree_util.tree_leaves(tree)
    flat = jax.tree_util.tree_leaves(specs,
                                     is_leaf=lambda x: isinstance(x, P))
    assert len(leaves) == len(flat)
    total = 0
    for x, s in zip(leaves, flat):
        shape = list(x.shape)
        for d, e in enumerate(_norm(s)):
            for a in ((e,) if isinstance(e, str) else (e or ())):
                assert shape[d] % sizes[a] == 0
                shape[d] //= sizes[a]
        total += math.prod(shape) * np.dtype(x.dtype).itemsize
    return total


def test_dry_run_train_cell_matches_reference_layout():
    """smollm-135m x train_4k on the 16x16 mesh: ok; argument bytes are
    exactly the reference's specs' (parameters, f32 moments, the step,
    the batch); model FLOPs are the reference's; the head split that
    DTensor cannot keep sharded (9 heads over 16) shows as all-gathers.

    ``model_flops_ratio`` band: per rank, the sharded matmuls are
    (8/6) x model_flops / 256 (remat runs the forward twice), and the
    attention runs replicated over the 16 model ranks (9 heads do not
    divide 16): 16 sequences x 9 heads x 30 layers of the kernels' closed
    forms, forward twice and the backward once. The ratio is within
    [0.75, 1.25] of model_flops over 256 times that sum: the rest is the
    optimizer's and the norms' small products and DTensor's
    redistributions, which the closed form leaves out."""
    res = dryrun.run_cell("smollm-135m", "train_4k", device_type="cpu")
    assert res["status"] == "ok", res.get("error")
    am, japi = _abstract(False), j_get_api("smollm-135m")
    jrules = JP.make_rules(am, japi.cfg)
    sizes = dict(am.shape)
    shape = J_SHAPES["train_4k"]
    pspec = japi.param_spec()
    psh = j_param_specs(pspec, jrules)
    ospec = jax.eval_shape(JAdamW().init, pspec)
    want = (_ref_local_bytes(pspec, psh, sizes)
            + _ref_local_bytes(ospec.mu, psh, sizes)
            + _ref_local_bytes(ospec.nu, psh, sizes)
            + np.dtype(ospec.step.dtype).itemsize
            + _ref_local_bytes(japi.input_specs(shape),
                               JP.batch_specs(jrules,
                                              japi.input_specs(shape)),
                               sizes))
    assert res["argument_bytes"] == want
    assert res["model_flops"] == j_model_flops(japi.cfg, shape)
    cfg = get_config("smollm-135m")
    attn = 30 * (2 * FA.attention_flops(16, 9, 4096, 4096, 64, True, None)
                 + FA.attention_bwd_flops(16, 9, 4096, 4096, 64, True,
                                          None))
    expect = res["model_flops"] / (256 * (8 / 6 * res["model_flops"] / 256
                                          + attn))
    print(f"model_flops_ratio {res['model_flops_ratio']:.4f}, closed form "
          f"{expect:.4f}")
    assert 0.75 * expect <= res["model_flops_ratio"] <= 1.25 * expect
    assert cfg.n_heads % 16 and res["roofline"]["coll_detail"][
        "all-gather"] > 0
    assert res["collective_counts"]["all_gather_into_tensor"] > 0
    assert res["peak_bytes"] > res["argument_bytes"]


def test_dry_run_decode_cell_with_window_sharded_cache():
    """zamba2-7b x long_500k (batch 1): the batch does not divide the dp
    axis, so the KV window is sharded over "data"; ok, its argument
    bytes the reference's specs' (parameters, decode state, token and
    position), its model FLOPs the reference's."""
    res = dryrun.run_cell("zamba2-7b", "long_500k", device_type="cpu")
    assert res["status"] == "ok", res.get("error")
    am, japi = _abstract(False), j_get_api("zamba2-7b")
    jrules = JP.make_rules(am, japi.cfg)
    sizes = dict(am.shape)
    shape = J_SHAPES["long_500k"]
    st = japi.decode_state_spec(shape.global_batch, shape.seq_len)
    stsp = JP.decode_state_specs(jrules, japi.cfg, st, am,
                                 batch=shape.global_batch)
    assert any("data" in (e if isinstance(e, tuple) else (e,))
               for s in _jspecs(stsp).values() for e in s if e)
    pspec = japi.param_spec()
    want = (_ref_local_bytes(pspec, j_param_specs(pspec, jrules), sizes)
            + _ref_local_bytes(st, stsp, sizes)
            + 2 * 4 * shape.global_batch)       # token, t: int32, replicated
    assert res["argument_bytes"] == want
    assert res["model_flops"] == j_model_flops(japi.cfg, shape)
    assert res["kernels"]["flash_decode"]["calls"] > 0
    assert res["fits"]


def test_dry_run_skips_and_records_errors(monkeypatch):
    """A cell the assignment rules skip is ``skipped``; xLSTM training,
    an error cell until the mLSTM kernel had a backward, traces ``ok``
    (the mLSTM's backward work recorded); a cell whose step raises is
    ``error`` with the exception (a kernel's meta rule made to raise)."""
    res = dryrun.run_cell("smollm-135m", "long_500k", device_type="cpu")
    assert res["status"] == "skipped" and "quadratic" in res["why"]
    res = dryrun.run_cell("xlstm-125m", "train_4k", device_type="cpu")
    assert res["status"] == "ok", res.get("error")
    assert res["kernels"]["mlstm_chunkwise_bwd"]["calls"] > 0

    def refuse(*args, **kw):
        raise NotImplementedError("mlstm_chunkwise: planted refusal")
    monkeypatch.setattr(MK, "_forward", refuse)
    res = dryrun.run_cell("xlstm-125m", "train_4k", device_type="cpu")
    assert res["status"] == "error"
    assert res["error"].startswith("NotImplementedError: mlstm_chunkwise")
