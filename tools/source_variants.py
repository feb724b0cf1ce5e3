"""Variants of a kernel source for same-card A/B runs: each variant is
``csrc/<name>.cu`` with textual substitutions, compiled with the build's
``nvcc`` flags into ``build/repro_torch/variants/`` (all at once, one
``nvcc`` each) and loaded by ``ctypes``. Used by ``attn_variants.py``
and ``decode_scan_variants.py``; needs ``nvcc``.
"""
import ctypes
import subprocess

from repro_torch.kernels import build


def build_variants(name: str, edits: dict, entry: str, summary) -> dict:
    """Compile every variant of csrc/<name>.cu; {variant: (entry point,
    summary(ptxas log))}. Every substitution is checked before any
    build; a variant with no substitutions is the source as it is."""
    src = (build.CSRC / f"{name}.cu").read_text()
    vdir = build.BUILD_DIR / "variants"
    vdir.mkdir(parents=True, exist_ok=True)
    texts = {}
    for var, subs in edits.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"variant {var}: {old!r} not in {name}.cu")
            text = text.replace(old, new)
        texts[var] = text
    jobs = {}
    for var, text in texts.items():
        cu, so = vdir / f"{name}_{var}.cu", vdir / f"{name}_{var}.so"
        cu.write_text(text)
        jobs[var] = (subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-I",
             str(build.CSRC), "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    got = {}
    for var, (proc, so) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"variant {var}: nvcc failed\n{log}")
        got[var] = (getattr(ctypes.CDLL(str(so)), entry), summary(log))
    return got
