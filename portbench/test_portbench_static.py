"""The benchmark's data and yardstick, without a run: the generators'
determinism per seed, the frozen work counts against their closed
forms, the files every cell names, and the import rule."""
import ast
import json
from pathlib import Path

import pytest

from portbench import common, flops, generators
from portbench.drivers import serve_open_loop as S
from portbench.drivers import train_elastic as T

HERE = Path(__file__).resolve().parent


def test_lm_stream_is_deterministic_per_seed():
    a = generators.lm_batch(32000, 2, 64, seed=2**31 + 3, step=5)
    b = generators.lm_batch(32000, 2, 64, seed=2**31 + 3, step=5)
    c = generators.lm_batch(32000, 2, 64, seed=2**31 + 4, step=5)
    assert all((a[k] == b[k]).all() for k in a)
    assert (a["tokens"] != c["tokens"]).any()
    assert (a["tokens"][:, 1:] == a["targets"][:, :-1]).all()


def test_open_loop_same_schedule_other_inputs():
    m = common.mix("serve_code")
    a = S.requests(m, 2**31 + 9, 30.0)
    b = S.requests(m, 2**31 + 9, 30.0)
    c = S.requests(m, 5, 30.0)
    assert len(a) == round(m["rate_per_s"] * 30.0) == len(c)
    assert all((x["prompt"] == y["prompt"]).all() for x, y in zip(a, b))
    # every seed: the same schedule, other token ids
    for x, y in zip(a, c):
        assert x["due"] == y["due"] and x["max_new"] == y["max_new"]
        assert len(x["prompt"]) == len(y["prompt"])
    assert any((x["prompt"] != y["prompt"]).any() for x, y in zip(a, c))
    assert a[0]["due"] == 0.0 and a[-1]["due"] < 30.0
    for q in a:
        assert m["prompt_min"] <= len(q["prompt"]) <= m["prompt_max"]
        assert m["new_min"] <= q["max_new"] <= m["new_max"]


def test_zamba2_matmul_params_closed_form():
    d = common.config("zamba2-7b-l6")["port"]["dims"]
    mamba = 3584 * (2 * 7168 + 2 * 64 + 112) + 7168 * 3584
    shared = 4 * 3584 * 3584 + 3 * 3584 * 14336
    assert mamba == 77_930_496 and shared == 205_520_896
    assert T.matmul_params(d) == 6 * mamba + 2 * shared + 32000 * 3584 \
        == 993_312_768


def test_mixtral_active_params_closed_form():
    d = common.config("mixtral-8x7b-l8")["port"]["dims"]
    layer = 2 * 4096 * 4096 + 2 * 4096 * 1024 + 2 * 3 * 4096 * 14336 \
        + 4096 * 8
    assert S.active_params(d) == 8 * layer == 3_154_378_752


@pytest.mark.parametrize("S_,w", [(4096, 4096), (4096, None), (4608, 4096),
                                  (100, 7)])
def test_visible_pairs_closed_form(S_, w):
    ww = min(w or S_, S_)
    want = sum(min(i + 1, ww) for i in range(S_))
    assert flops.visible_pairs(S_, S_, True, w) == want
    assert flops.attention_fwd_flops(2, 3, S_, S_, 64, True, w) == \
        4 * 2 * 3 * 64 * want
    assert flops.attention_bwd_flops(2, 3, S_, S_, 64, True, w) == \
        10 * 2 * 3 * 64 * want


def test_kernel_bytes_and_bounds():
    # the decode reads the valid slots' K and V once
    assert flops.decode_bytes(1, 32, 8, 4096, 128, 4096, 2) == \
        2 * (2 * 32 * 128 + 2 * 8 * 128 * 4096) + 4 * 4096
    # the scan backward: x, B, C, a, dt, dy read and five grads written
    B, NH, S_, P, N = 1, 112, 4096, 64, 64
    x, bc, ad = B * NH * S_ * P, 2 * B * S_ * N, 2 * B * NH * S_
    assert flops.scan_bwd_bytes(B, NH, S_, P, N, 2, 2) == \
        2 * (2 * x + 2 * bc + 4 * ad) + 4 * x
    c = 64
    assert flops.scan_bwd_flops(B, NH, S_, P, N) == B * NH * (S_ // c) * (
        2 * c * N * P + 2 * c * c * (N + P) + 2 * c * c * (P + 2 * N)
        + 8 * c * N * P)
    assert flops.bound_by(1e12, 1.0) == "operations"
    assert flops.least_seconds(989e12, 0) == pytest.approx(1.0)
    assert flops.least_seconds(0, 3.35e12) == pytest.approx(1.0)


def test_every_cell_finds_its_files():
    b = json.loads((common.ROOT / "BENCHMARK.json").read_text())
    cfgs = {c["name"]: c for c in b["configs"]}
    for w in b["workloads"]:
        c = cfgs[w["config"]]
        f = common.config(w["config"])
        assert (common.ROOT / c["file"]).exists()
        assert f["source"] == c["source"] and f["reduced"] == c["reduced"]
        assert common.mix(w["traffic"])["kind"] in ("train_elastic",
                                                    "serve_open_loop")
        lim = common.limits(w["name"])
        assert lim and all(v >= 0 for v in lim.values())
    for m in b["per_layer"]:
        assert (HERE / "metrics" / f"{m['name']}.py").exists(), m["name"]
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_jax_or_reference_package_imported():
    for p in HERE.rglob("*.py"):
        for mod in _imports(p):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "repro",
                               "benchmarks"), (p, mod)
            if "reference" in p.parts:
                assert top != "repro_torch", (p, mod)


def test_forbidden_modules_compare_whole_names():
    import sys
    assert "repro_torch" not in common.forbidden_modules()
    sys.modules["repro_fake_probe"] = sys
    try:
        assert "repro_fake_probe" not in common.forbidden_modules()
    finally:
        del sys.modules["repro_fake_probe"]


def test_marked_kernel_keeps_counting_its_calls():
    """A wrapped function that counts its calls on itself, by its
    module's name (as the port's kernels do), still counts, and the
    count stays the function's once the wrapper is gone."""
    import types
    from portbench import trace
    mod = types.ModuleType("pb_probe")
    exec("def k(x):\n    k.launches += 1\n    return x\nk.launches = 0",
         mod.__dict__)
    orig = mod.k
    with trace.marked([(mod, "k", "pb.k", None)]):
        assert mod.k is not orig and mod.k(3) == 3
    assert mod.k is orig and orig.launches == 1


@pytest.mark.parametrize("where", [
    "repro_torch.kernels.flash_attention:flash_attention_bwd",
    "repro_torch.kernels.mamba2_scan:mamba2_scan_bwd"])
def test_marked_program_kernels_keep_their_counters(where):
    import importlib
    from portbench import trace
    common.import_program()
    name, fn = where.split(":")
    mod = importlib.import_module(name)
    n = getattr(mod, fn).launches
    with trace.marked([(mod, fn, "pb.x", None)]):
        getattr(mod, fn).launches += 1
    assert getattr(mod, fn).launches == n + 1
    getattr(mod, fn).launches = n
