"""The port stands alone: ``repro_torch`` imports with ``jax`` and
``repro`` blocked, and no file of it (nor ``chip_smoke.py``) imports
either. The module list covers every subpackage: serving, kernels,
optim, data, collective_exec, train, checkpoint, both launchers, the
SSM/hybrid slice (models.ssm, the mamba2_scan kernel, the zamba2
config) and the xLSTM slice (models.xlstm, the mlstm_chunkwise kernel,
the xlstm-125m config)."""
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
              "repro_torch.configs.xlstm_125m"):
        assert m in mods, m
    code = ("import sys, importlib\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
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
