"""Same-card comparison of the bf16 attention forward with two variants
of its own source, the evidence for two choices in
``src/repro_torch/csrc/flash_attention.cu``:

    main     the kernel as built: 384 threads, the producer warpgroup
             handing registers to the two consumer warpgroups
             (setmaxnreg 24 / 240), 64-key tiles at hd 112 and 128
    no_regs  288 threads (two consumer warpgroups and one producer
             warp), no setmaxnreg
    kv128    128-key tiles at every head dim

Each variant is the source with a textual substitution, compiled with
the build's ``nvcc`` flags into ``build/repro_torch/variants/`` and
swapped in for the wrapper's bf16 entry point
(``source_variants.py``). Prints the card, ptxas'
registers and spills of ``fa_fwd_wgmma<64>`` and ``<112>`` for each
build, the error against the plain version, and device ms per call
(``chip_smoke.time_ms``) at the serve (hd 64) and hybrid (hd 112)
timing shapes, in the order main, the variants, the variants reversed,
main.

    python3 tools/attn_variants.py

Needs one CUDA card and ``nvcc``.
"""
import ctypes
import os
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as CS  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from source_variants import build_variants  # noqa: E402

EDITS = {
    "no_regs": [
        ("__launch_bounds__(384, 1)", "__launch_bounds__(288, 1)"),
        ("THREADS = 384;", "THREADS = 288;"),
        ("if (warp >= 8) {", "if (warp == 8) {"),
        ("    hopper::regs_dec<24>();", ""),
        ("if (warp == 8 && lane == 0) {", "if (lane == 0) {"),
        ("    hopper::regs_inc<240>();", ""),
    ],
    "kv128": [("BKV = HDP == 64 ? 128 : 64;", "BKV = 128;")],
}
SHAPES = {64: dict(B=8, S=1024, H=9, Kh=3),
          112: dict(B=2, S=2048, H=32, Kh=32)}


def ptxas_summary(log: str) -> dict:
    """{head dim: 'N registers, S bytes spilled'} of fa_fwd_wgmma."""
    out = {}
    for hd in SHAPES:
        m = re.search(rf"fa_fwd_wgmmaILi{hd}E.*?\n\s*(\d+) bytes stack "
                      rf"frame, (\d+) bytes spill stores.*?\n.*?Used (\d+) "
                      rf"registers", log)
        if m:
            out[hd] = f"{m.group(3)} registers, {m.group(2)} bytes spilled"
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    print(CS.card_line())
    main_log = build.build_all(["flash_attention"]).get("flash_attention")
    main_fn = FA._kernel("flash_attention", torch.bfloat16)
    fns = {"main": (main_fn, ptxas_summary(main_log) if main_log
                    else "built earlier")}
    for name, (fn, info) in build_variants(
            "flash_attention", EDITS, "flash_attention_bf16",
            ptxas_summary).items():
        fn.argtypes, fn.restype = main_fn.argtypes, ctypes.c_int
        fns[name] = (fn, info)
    for name, (_, info) in fns.items():
        print(f"ptxas {name}: {info}")
    gen = torch.Generator("cuda").manual_seed(0)
    ins = {hd: CS._attn_inputs(sh["B"], sh["S"], torch.bfloat16, gen,
                               H=sh["H"], Kh=sh["Kh"], hd=hd)
           for hd, sh in SHAPES.items()}
    order = ["main", *EDITS, *reversed(list(EDITS)), "main"]
    for name in order:
        FA._fns["flash_attention"][torch.bfloat16] = fns[name][0]
        row = []
        for hd, (q, k, v) in ins.items():
            err = (FA.flash_attention(q, k, v).float() - FA.attention_ref(
                q, k, v).float()).abs().max().item()
            ms, _ = CS.time_ms(lambda: FA.flash_attention(q, k, v),
                               kernels=CS.ATTN_FWD_BF16)
            row.append(f"hd {hd}: {ms:.4f} ms (err {err:.3e})")
        print(f"{name}: " + "; ".join(row))
    FA._fns["flash_attention"][torch.bfloat16] = main_fn


if __name__ == "__main__":
    main()
