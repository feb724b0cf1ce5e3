"""Parity of the port's tooling copies with the JAX package's: the perf
sentry (``obs/regress``), the roofline (``roofline/``) and int8 gradient
compression with error feedback (``optim/compression``). CPU only."""
import hashlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ALL_ARCHS as J_ARCHS, SHAPES as J_SHAPES
from repro.models.registry import get_config as j_get_config
from repro.obs import regress as j_regress
from repro.optim import compression as j_comp
from repro.roofline import analysis as j_analysis
from repro.roofline import analytical as j_analytical
from repro.roofline import hlo_parse as j_hlo
from repro_torch.configs import ALL_ARCHS, SHAPES
from repro_torch.launch.mesh import HW
from repro_torch.models.registry import get_config
from repro_torch.obs import regress
from repro_torch.optim import compression as comp
from repro_torch.roofline import analysis, analytical, hlo_parse

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------- regress
def _sentry_run(mod, tmp_path, capsys):
    """The reference's synthetic-regression scenario
    (``tests/test_flight_live.py``) through ``mod``: each step's exit code
    and the regressions its ``--json`` report lists."""
    fresh = tmp_path / "fresh"
    fresh.mkdir()
    base = str(tmp_path / "BENCH_BASELINE.json")
    bench = {"schema_version": 1,
             "ms_per_step": {"eager": 100.0, "overlapped": 80.0},
             "eager_over_overlapped": 1.25,
             "overlapped_bitwise_equals_eager": True}
    out = []

    def step(*extra):
        (fresh / "BENCH_collective.json").write_text(json.dumps(bench))
        rep = str(tmp_path / "diff.json")
        rc = mod.main(["--fresh", str(fresh), "--baseline", base,
                       "--json", rep, *extra])
        regs = [(r["metric"], r.get("delta_pct"), r["why"])
                for r in json.load(open(rep))["regressions"]]
        out.append((rc, regs, "REGRESSION" in capsys.readouterr().out))

    (fresh / "BENCH_collective.json").write_text(json.dumps(bench))
    assert mod.main(["--fresh", str(fresh), "--baseline", base,
                     "--seed"]) == 0
    step()                                        # self-compare clean
    bench["ms_per_step"]["overlapped"] = 96.0     # +20%: beyond 15%
    step()
    step("--warn-only")
    bench["ms_per_step"]["overlapped"] = 64.0     # faster: improvement
    step()
    bench["ms_per_step"]["overlapped"] = 80.0     # boolean flip
    bench["overlapped_bitwise_equals_eager"] = False
    step()
    bench["overlapped_bitwise_equals_eager"] = True
    bench["schema_version"] = 2                   # schema bump: warning
    step()
    out.append(mod.main(["--fresh", str(fresh), "--baseline",
                         str(tmp_path / "nope.json")]))
    return out


def test_regress_scenario_matches_reference(tmp_path, capsys):
    for d in ("port", "ref"):
        (tmp_path / d).mkdir()
    got = _sentry_run(regress, tmp_path / "port", capsys)
    want = _sentry_run(j_regress, tmp_path / "ref", capsys)
    assert got == want
    assert [r[0] for r in got[:-1]] == [0, 1, 0, 0, 1, 0] and got[-1] == 2
    assert got[1][1][0][0] == "ms_per_step.overlapped"
    assert got[1][1][0][1] == pytest.approx(20.0)


def test_regress_committed_artifacts_read_only():
    """The committed BENCH_*.json against the committed baseline: the
    same clean report from both packages, through ``compare`` and the
    CLI, and the baseline file untouched."""
    base = os.path.join(REPO, "BENCH_BASELINE.json")
    digest = hashlib.sha256(open(base, "rb").read()).hexdigest()
    baseline = json.load(open(base))
    got = regress.compare(baseline, REPO)
    assert got == j_regress.compare(baseline, REPO)
    assert got["ok"] and got["compared"] > 20, got["regressions"]
    assert regress.main(["--fresh", REPO]) == 0
    assert hashlib.sha256(open(base, "rb").read()).hexdigest() == digest


# --------------------------------------------------------------- roofline
def test_model_flops_and_analytic_terms_match_reference():
    assert tuple(ALL_ARCHS) == tuple(J_ARCHS)
    n = 0
    for arch in ALL_ARCHS:
        cfg, jcfg = get_config(arch), j_get_config(arch)
        for shape, jshape in zip(SHAPES, J_SHAPES):
            assert shape.name == jshape.name
            assert analysis.model_flops(cfg, shape) == pytest.approx(
                j_analysis.model_flops(jcfg, jshape), rel=1e-12)
            for kw in ({"chips": 256}, {"chips": 512},
                       {"chips": 256, "tp": 1, "remat": False},
                       {"chips": 256, "dp_replicated_attention": True}):
                got = analytical.analytic_terms(cfg, shape, HW, **kw)
                want = j_analytical.analytic_terms(jcfg, jshape, HW, **kw)
                assert got.keys() == want.keys()
                for k, v in want.items():
                    if isinstance(v, str):
                        assert got[k] == v, (arch, shape.name, k)
                    else:
                        assert got[k] == pytest.approx(v, rel=1e-12), \
                            (arch, shape.name, k)
                n += 1
    assert n == len(ALL_ARCHS) * len(SHAPES) * 4


# a module with every collective kind the parsers read (XLA's CPU backend
# emits none for a one-device program)
_COLL_HLO = """HloModule coll, entry_computation_layout={()->f32[8,16]}

%add (a: f32[], b: f32[]) -> f32[] {
  %a = f32[] parameter(0)
  %b = f32[] parameter(1)
  ROOT %s = f32[] add(f32[] %a, f32[] %b)
}

ENTRY %main (p: f32[8,16]) -> f32[8,16] {
  %p = f32[8,16]{1,0} parameter(0)
  %ag = f32[32,16]{1,0} all-gather(f32[8,16]{1,0} %p), dimensions={0}
  %ar = f32[8,16]{1,0} all-reduce(f32[8,16]{1,0} %p), to_apply=%add
  %rs = bf16[2,16]{1,0} reduce-scatter(f32[8,16]{1,0} %p), dimensions={0}, to_apply=%add
  %cp = f32[8,16]{1,0} collective-permute(f32[8,16]{1,0} %ar), source_target_pairs={{0,1}}
  %a2a = (f32[4,16], f32[4,16]) all-to-all(f32[4,16] %p, f32[4,16] %p)
  ROOT %out = f32[8,16]{1,0} add(f32[8,16]{1,0} %cp, f32[8,16]{1,0} %ar)
}
"""


def _jitted_hlo() -> str:
    """The compiled HLO of a small program with a scanned dot (a while
    loop with a known trip count) and a dot outside it."""
    def f(x, w):
        def body(c, _):
            return jnp.tanh(c @ w), None
        y, _ = jax.lax.scan(body, x, None, length=5)
        return (y @ w.T).sum()
    x = jnp.ones((16, 32), jnp.float32)
    w = jnp.ones((32, 32), jnp.float32)
    return jax.jit(f).lower(x, w).compile().as_text()


@pytest.mark.parametrize("which", ["jitted", "collectives"])
def test_hlo_parse_and_collective_bytes_match_reference(which):
    text = _jitted_hlo() if which == "jitted" else _COLL_HLO
    got, want = hlo_parse.analyze_text(text), j_hlo.analyze_text(text)
    assert (got.flops, got.bytes, got.coll) == (want.flops, want.bytes,
                                                 want.coll)
    assert analysis.collective_bytes(text) == \
        j_analysis.collective_bytes(text)
    if which == "jitted":
        # five trips of a 16x32x32 dot inside the loop, one outside
        assert got.flops >= 6 * 2 * 16 * 32 * 32
    else:
        assert set(got.coll) == {"all-gather", "all-reduce",
                                 "reduce-scatter", "collective-permute",
                                 "all-to-all"}
        assert analysis.collective_bytes(text)["all-gather"] == 32 * 16 * 4


def test_roofline_object_matches_reference():
    kw = dict(flops=3.1e18, hbm_bytes=2.2e15, coll_bytes=5.5e14, chips=256,
              peak_flops=HW["peak_flops_bf16"], hbm_bw=HW["hbm_bw"],
              ici_bw=HW["ici_bw"], coll_detail={"all-reduce": 5.5e14})
    got, want = analysis.Roofline(**kw), j_analysis.Roofline(**kw)
    assert got.to_dict() == want.to_dict()
    assert got.fraction_of_roofline(1e18) == want.fraction_of_roofline(1e18)


# ------------------------------------------------------------ compression
def _tree(rng):
    return {"w": rng.standard_normal((64, 33)).astype(np.float32),
            "blocks": {"b": (rng.standard_normal(17) * 1e-3).astype(
                np.float32),
                "z": np.zeros((4, 4), np.float32)}}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


def test_compression_matches_reference_over_error_feedback():
    """Three steps of error feedback on the same seeded trees: scales to
    1e-7 relative, q equal except where x/scale lies within one f32 ulp
    of a .5 rounding boundary (the division may round to either side),
    residuals to 1e-6."""
    rng = np.random.default_rng(0)
    grads = [_tree(rng) for _ in range(3)]
    st = comp.init_ef_state({k: torch.tensor(v) for k, v in
                             _flat(grads[0]).items()})
    jst = j_comp.init_ef_state(jax.tree_util.tree_map(jnp.asarray,
                                                      grads[0]))
    for g in grads:
        tg = {k: torch.tensor(v) for k, v in _flat(g).items()}
        corrected = {k: v.numpy() + st.residual[k].numpy()
                     for k, v in tg.items()}
        q, s, st = comp.compress(tg, st)
        jq, js, jst = j_comp.compress(
            jax.tree_util.tree_map(jnp.asarray, g), jst)
        jq, js, jr = _flat(jq), _flat(js), _flat(jst.residual)
        for k in tg:
            np.testing.assert_allclose(s[k].numpy(), js[k], rtol=1e-7)
            x = corrected[k] / np.float32(s[k].numpy())
            frac = np.abs(x - np.floor(x) - 0.5)
            near = frac <= np.spacing(np.abs(x).astype(np.float32))
            assert q[k].dtype == torch.int8
            assert np.array_equal(q[k].numpy()[~near], jq[k][~near]), k
            np.testing.assert_allclose(st.residual[k].numpy(), jr[k],
                                       atol=1e-6)
        back = comp.decompress(q, s)
        jback = _flat(j_comp.decompress(*(jax.tree_util.tree_map(
            jnp.asarray, t) for t in (_unflat(jq), _unflat(js)))))
        for k in back:
            np.testing.assert_allclose(back[k].numpy(), jback[k],
                                       rtol=1e-6, atol=1e-9)
    assert comp.compressed_bytes({k: torch.tensor(v) for k, v in
                                  _flat(grads[0]).items()}) == \
        j_comp.compressed_bytes(grads[0])


def _unflat(flat):
    out = {}
    for path, v in flat.items():
        node = out
        keys = path.strip("/").split("/")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = v
    return out


def test_compression_bf16_grads_and_flat_buffer_shape():
    """bf16 gradients are compressed from their f32 value, and the
    multi-host flat buffer's layout (rows x 65536 f32) round-trips within
    half a quantization step."""
    g = torch.randn((3, 65536), generator=torch.Generator().manual_seed(1))
    q, s, st = comp.compress(g, comp.init_ef_state(g))
    back = comp.decompress(q, s)
    assert q.shape == g.shape and s.shape == ()
    assert float((back - g).abs().max()) <= float(s) / 2 + 1e-7
    torch.testing.assert_close(st.residual, g - back, rtol=0, atol=0)
    gb = {"w": g.to(torch.bfloat16)}
    qb, sb, _ = comp.compress(gb, comp.init_ef_state(gb))
    q32, s32, _ = comp.compress({"w": gb["w"].float()},
                                comp.init_ef_state(gb))
    assert torch.equal(qb["w"], q32["w"]) and torch.equal(sb["w"], s32["w"])
