"""The port stands alone: ``repro_torch`` imports with ``jax`` and
``repro`` blocked, and no file of it (nor ``chip_smoke.py``) imports
either. The module list covers every subpackage: serving, kernels,
optim, data, collective_exec, train, checkpoint, both launchers, the
SSM/hybrid slice (models.ssm, the mamba2_scan kernel, the zamba2
config) and the xLSTM slice (models.xlstm, the mlstm_chunkwise kernel,
the xlstm-125m config), the protocol layer (creation, model checker,
bounds, point-to-point phasers, the live watermarks), the pipeline slice
(``pipeline_exec``), the examples, whose import runs nothing, and the
remaining families (models.moe, models.encdec, every config of
``configs.archs``) and the multi-host runtime (``runtime_dist``, the
obs plane's trace, recorder, hub and CLIs), and the planning and tooling
layer (the perf sentry ``obs.regress``, ``roofline``, int8 compression,
the production mesh, the sharding rules, the dry-run, the kernels'
meta rules, and ``train.step``'s serve-step builders).

The multi-host runtime keeps the reference's control plane free of the
array library: a control-only worker (``data: None``) never imports
``torch``, which a socket cluster proves with ``torch`` made
unimportable in the coordinator and in every worker it spawns."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _modules():
    mods = []
    for p in sorted(PKG.rglob("*.py")):
        rel = p.relative_to(PKG.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_every_module_imports_with_jax_and_repro_blocked():
    mods = _modules()
    for m in ("repro_torch.serve.engine", "repro_torch.kernels.flash_decode",
              "repro_torch.kernels.bucket_combine", "repro_torch.utils",
              "repro_torch.optim.adamw", "repro_torch.data.synthetic",
              "repro_torch.obs.timeline", "repro_torch.collective_exec",
              "repro_torch.collective_exec.buckets",
              "repro_torch.collective_exec.executor",
              "repro_torch.collective_exec.program",
              "repro_torch.collective_exec.cache",
              "repro_torch.train.step", "repro_torch.train.loop",
              "repro_torch.checkpoint.manager",
              "repro_torch.launch.train", "repro_torch.models.ssm",
              "repro_torch.kernels.mamba2_scan",
              "repro_torch.configs.zamba2_7b", "repro_torch.models.xlstm",
              "repro_torch.kernels.mlstm_kernel",
              "repro_torch.configs.xlstm_125m",
              "repro_torch.core.creation", "repro_torch.core.complexity",
              "repro_torch.core.modelcheck", "repro_torch.core.p2p",
              "repro_torch.obs.live",
              "repro_torch.runtime_elastic.membership",
              "repro_torch.pipeline_exec",
              "repro_torch.pipeline_exec.schedule",
              "repro_torch.pipeline_exec.stage_program",
              "repro_torch.examples", "repro_torch.examples.quickstart",
              "repro_torch.examples.serve_decode",
              "repro_torch.examples.modelcheck_demo",
              "repro_torch.examples.elastic_train",
              "repro_torch.models.moe", "repro_torch.models.encdec",
              "repro_torch.configs.archs",
              "repro_torch.configs.mixtral_8x7b",
              "repro_torch.configs.llama4_scout",
              "repro_torch.configs.whisper_small",
              "repro_torch.configs.llava_next_34b",
              "repro_torch.configs.granite_3_2b",
              "repro_torch.configs.qwen2_5_3b",
              "repro_torch.configs.qwen2_72b",
              "repro_torch.runtime_dist",
              "repro_torch.runtime_dist.agent",
              "repro_torch.runtime_dist.coordinator",
              "repro_torch.runtime_dist.exchange",
              "repro_torch.runtime_dist.failure",
              "repro_torch.runtime_dist.plane",
              "repro_torch.runtime_dist.transport",
              "repro_torch.runtime_dist.worker",
              "repro_torch.obs.trace", "repro_torch.obs.recorder",
              "repro_torch.obs.hub", "repro_torch.obs.check",
              "repro_torch.obs.watch", "repro_torch.obs.regress",
              "repro_torch.roofline", "repro_torch.roofline.analysis",
              "repro_torch.roofline.analytical",
              "repro_torch.roofline.hlo_parse",
              "repro_torch.optim.compression", "repro_torch.launch.mesh",
              "repro_torch.sharding", "repro_torch.sharding.rules",
              "repro_torch.sharding.policies", "repro_torch.launch.dryrun",
              "repro_torch.kernels.meta"):
        assert m in mods, m
    code = ("import sys, importlib\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "from repro_torch.train.step import (build_decode_step,\n"
            "    build_prefill_step, build_train_step)\n"
            "bad = [m for m, mod in sys.modules.items() if mod is not None"
            " and m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("ok")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_neither_jax_nor_repro(path):
    roots = set(_imported_roots(path))
    assert not roots & {"jax", "jaxlib", "repro"}, (path, roots)


CONTROL_ONLY = r"""
import os, sys
from repro_torch.runtime_dist import DistCoordinator, SocketCluster
rt = DistCoordinator(SocketCluster(control_only=True,
                                   failure_timeout=300.0), 2, seed=0)
rt.advance(step=0)
assert rt.epoch.live == (0, 1)
st = rt.control_stats()
assert st["remote_frames"] > 0, st
rt.close()
assert "torch" not in sys.modules
print("ok")
"""


def test_control_only_worker_never_imports_torch(tmp_path):
    """A socket cluster of control-only workers (``python -m
    repro_torch.runtime_dist.worker``, ``data: None``) boots and advances
    a phase with ``torch`` unimportable: a stub that records the attempt
    and raises stands first on the path of the coordinator and of every
    worker."""
    stub = tmp_path / "stub" / "torch"
    stub.mkdir(parents=True)
    marker = tmp_path / "torch_imported"
    (stub / "__init__.py").write_text(
        f"open({str(marker)!r}, 'a').write('x')\n"
        "raise ImportError('torch imported by the control plane')\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(tmp_path / "stub")]))
    r = subprocess.run([sys.executable, "-c", CONTROL_ONLY], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().endswith("ok")
    assert not marker.exists()
