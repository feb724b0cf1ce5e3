"""The dry-run's per-rank model on real CPU shards: a reduced model's
loss and gradients, computed on DTensors under the sharding rules (every
tensor-parallel projection per rank through ``sharding.project``, the
kernels per rank on their shards), gathered, are the plain tensors'.

A meta trace checks only shapes and placements; a wrong placement in a
per-rank product (a shard taken for the whole, a partial sum never
reduced) shows only in the values. Each case runs on an 8-rank ("pod",
"data", "model") = (2, 2, 2) mesh of threads in this process (torch's
threaded process group: real collectives on real CPU shards), with the
parameters and the batch in the layouts ``build_train_step`` gives them,
FSDP off and on. No test leaves a default group behind. CPU only, about
a minute a case (DTensor's planning, once per rank's mesh)."""
import pytest
import torch
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs import ShapeConfig
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.registry import get_api, get_config
from repro_torch.optim import AdamW
from repro_torch.sharding import use_rules
from repro_torch.sharding.policies import make_rules
from repro_torch.train.step import build_train_step
from repro_torch.utils import tree_flatten, tree_unflatten
from test_torch_dryrun_hybrid import (MESH, _dtensor, _on_threads,  # noqa: F401
                                      no_group_left_behind)

# f32 throughout: the per-rank sums (a row-parallel product's partials,
# a weight gradient's reduce over the batch ranks) add in another order
# than the plain product's, a few ulps of the loss and the gradients
RTOL, ATOL = 1e-5, 1e-6
# arch -> config overrides (one group of blocks; the reduced widths)
CASES = {"smollm-135m": {"n_layers": 1}, "xlstm-125m": {"n_layers": 2}}


@pytest.mark.parametrize("fsdp", [False, True], ids=["tp", "fsdp"])
@pytest.mark.parametrize("arch", list(CASES))
def test_sharded_loss_and_grads_are_the_plain_tensors(arch, fsdp):
    """``value_and_grad`` of a reduced model, batch 4 x 16 tokens, on
    every rank of the (2, 2, 2) mesh: the loss and every parameter's
    gradient, gathered, within ``RTOL`` / ``ATOL`` of the same call on
    the plain tensors."""
    cfg = get_config(arch).reduced(**CASES[arch])
    api = get_api(cfg)
    params = api.init_params(torch.Generator().manual_seed(0), device="cpu")
    batch = api.make_inputs(ShapeConfig("t", 16, 4, "train"), seed=1,
                            device="cpu")
    (want_loss, _), want = api.value_and_grad(params, batch)
    paths, leaves = tree_flatten(params)
    want = tree_flatten(want)[1]

    def rank(_):
        mesh = make_mesh(*MESH, device_type="cpu")
        rules = make_rules(mesh, cfg, fsdp=fsdp)
        ts = build_train_step(api, AdamW(), rules=rules, remat=False)
        pls = tree_flatten(ts.param_sh)[1]
        dparams = tree_unflatten(paths, [_dtensor(x, mesh, pl)
                                         for x, pl in zip(leaves, pls)])
        bpaths, bleaves = tree_flatten(batch)
        dbatch = tree_unflatten(bpaths, [
            _dtensor(x, mesh, pl, grad=False)
            for x, pl in zip(bleaves, tree_flatten(ts.batch_sh)[1])])
        with use_rules(rules), implicit_replication():
            (loss, _), grads = api.value_and_grad(dparams, dbatch)
        return loss.full_tensor(), [g.full_tensor()
                                    for g in tree_flatten(grads)[1]]
    for loss, grads in _on_threads(8, rank):
        torch.testing.assert_close(loss, want_loss, rtol=RTOL, atol=ATOL)
        for path, got, exp in zip(paths, grads, want):
            torch.testing.assert_close(got, exp, rtol=RTOL, atol=ATOL,
                                       msg=lambda m: f"{path}: {m}")
