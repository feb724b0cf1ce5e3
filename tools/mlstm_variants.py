"""Same-card comparison of the bf16 mLSTM kernel with variants of its own
source, the evidence for the choices in
``src/repro_torch/csrc/mlstm_chunkwise.cu``:

    main         the kernel as built: wgmma, hi/lo bf16 operands, three
                 warpgroups (the rest; two carrying C), two k16 steps a
                 batch of q C, setmaxnreg: warpgroup 0 down to 120
                 registers, the C warpgroups up to 192
    regs_168     168 registers for every thread (no setmaxnreg): ptxas
                 serializes the wgmma for want of registers
    regs_b       warpgroup 0 down to 104, the C warpgroups up to 200
    kb1          one k16 step a batch of q C (fewer registers in flight)
    kb4          four k16 steps a batch of q C
    no_lo        one bf16 operand each (the three lo products dropped):
                 faster and less exact (fails the f32 limit)
    first        the first port's CUDA-core kernel (mlstm_kernel): the
                 design this one replaces, at the same 64-row chunk and
                 64-column value tile (wgmma's M of 64 and C held in
                 registers fix both here)
    no_store     diagnostic, wrong results: y is not stored, so ptxas
                 drops every product of warpgroup 0 (their results go
                 unused): the C warpgroups' chain nearly alone
    no_state     diagnostic, wrong results: no state update products
    no_load      diagnostic, wrong results: no loads after the third
                 chunk (the barriers complete on stale tiles)
    no_qc        diagnostic, wrong results: no q C products
    no_nupd      diagnostic, wrong results: no n update
    no_wexp      diagnostic, wrong results: W = q k^T masked, no exp

Each variant is the source with a textual substitution, compiled with
the build's ``nvcc`` flags into ``build/repro_torch/variants/`` and
swapped in for the wrapper's bf16 -> f32 entry point (``main``, the
source as it is, is built the same way; ``source_variants.py``). Prints
the card, ptxas' registers, spills and performance remarks of the
tensor-core kernel (``mlstm_tc_kernel<float>``) for each build, each
variant's error against the plain version (whether it holds the 2e-4 of
max(1, max|y|) that ``chip_smoke.py`` holds the kernel to), and device ms
per call by CUDA events over back-to-back calls at the xlstm prefill's
shape (B=8, NH=4, S=2048, hd=384, q/k/v bf16, y f32), in the order main,
the variants, the variants reversed, main. Then main at B=4 (96 blocks,
one wave) and B=1: whether a block's chunk loop or the waves bound it.

    python3 tools/mlstm_variants.py

Needs one CUDA card and ``nvcc``.
"""
import ctypes
import os
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke as CS  # noqa: E402  (before torch: it sets TEARDOWN_CUPTI)
import torch  # noqa: E402
from decode_scan_variants import event_ms  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import mlstm_kernel as MK  # noqa: E402
from source_variants import build_variants  # noqa: E402

_REGS = ("constexpr int REGS_REST = 120;\nconstexpr int REGS_CHAIN = 192;")
EDITS = {
    "main": [],
    "regs_168": [(_REGS, "constexpr int REGS_REST = 168;\n"
                         "constexpr int REGS_CHAIN = 168;")],
    "regs_b": [(_REGS, "constexpr int REGS_REST = 104;\n"
                       "constexpr int REGS_CHAIN = 200;")],
    "kb1": [("constexpr int KB = 2;", "constexpr int KB = 1;")],
    "kb4": [("constexpr int KB = 2;", "constexpr int KB = 4;")],
    "no_lo": [
        ("        hopper::wgmma_rs(yacc, wo[kk], vd);\n", ""),
        ("            hopper::wgmma_rs_kmajor(yacc, fl[u], qd);\n", ""),
        ("        hopper::wgmma_rs(st, al[kk], kd);\n", "")],
    "first": [("      if constexpr (sizeof(TI) == 2)\n"
               "        return tc::launch<TO>(g, B, stream);",
               "      if constexpr (false)\n"
               "        return tc::launch<TO>(g, B, stream);")],
    "no_store": [("            store2(yr + 8 * k,",
                  "            if (a0 < 0) store2(yr + 8 * k,")],
    "no_state": [("        hopper::wgmma_rs(st, ah[kk], kd);\n"
                  "        hopper::wgmma_rs(st, al[kk], kd);\n", "")],
    "no_load": [("      if (next < nchunk) {\n",
                 "      if (next < nchunk && next >= 3) {\n"
                 "        hopper::mbar_arrive(which == 0 ? full_q\n"
                 "                                       : &full_kv[next & 1]);\n"
                 "      } else if (next < nchunk) {\n")],
    "no_qc": [("            hopper::wgmma_rs_kmajor(yacc, fh[u], qd);\n"
               "            hopper::wgmma_rs_kmajor(yacc, fl[u], qd);\n", "")],
    "no_nupd": [("for (int r = 16 * qr; r < 16 * qr + 16; ++r) {",
                 "for (int r = 16 * qr; r < 16 * qr; ++r) {")],
    "no_wexp": [("sacc[idx] * __expf(va[i] + vb[j]) : 0.f;",
                 "sacc[idx] : 0.f;")],
}
KERNEL = r"mlstm_tc_kernelIfE"       # the main path's instantiation


def ptxas_summary(log: str) -> str:
    """Registers and spills of the bf16 -> f32 tensor-core kernel, and
    ptxas' performance remarks on it (wgmma serialized, C75xx)."""
    out = []
    m = re.search(KERNEL + r".*?\n.*?(\d+) bytes spill stores.*?\n"
                  r".*?Used (\d+) registers", log)
    if m:
        out.append(f"{m.group(2)} registers, {m.group(1)} bytes spilled")
    out += [line.split("Potential Performance Loss: ")[-1].split(
            " for the function")[0] for line in log.splitlines()
            if KERNEL in line and "C75" in line]
    return "; ".join(out)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    print(CS.card_line())
    build.build_all(["mlstm_chunkwise"])
    key = (torch.bfloat16, torch.float32)
    main_fn = MK._kernel(*key)
    fns = {}
    for var, (fn, info) in build_variants(
            "mlstm_chunkwise", EDITS, "mlstm_chunkwise_bf16_f32",
            ptxas_summary).items():
        fn.argtypes, fn.restype = main_fn.argtypes, ctypes.c_int
        fns[var] = (fn, info)
    for var, (_, info) in fns.items():
        print(f"ptxas {var}: {info}")
    gen = torch.Generator("cuda").manual_seed(0)
    ins = CS._mlstm_inputs(gen, 8, 4, 2048, 384, torch.bfloat16)
    want = MK.mlstm_chunkwise_plain(*ins, out_dtype=torch.float32)
    limit = CS.MLSTM_TOL["float32"] * max(1.0, want.abs().max().item())
    order = list(EDITS)
    for var in order + order[::-1]:
        MK._fns[key] = fns[var][0]
        got = MK.mlstm_chunkwise(*ins, out_dtype=torch.float32)
        err = (got - want).abs().max().item()
        held = "held" if err <= limit else "FAILS"
        ms = event_ms(lambda: MK.mlstm_chunkwise(*ins,
                                                 out_dtype=torch.float32))
        print(f"mlstm {var}: {ms:.4f} ms (max |err| {err:.3e}, {held} "
              f"{limit:.3e})")
    MK._fns[key] = main_fn
    for B in (4, 1):
        ins = CS._mlstm_inputs(gen, B, 4, 2048, 384, torch.bfloat16)
        ms = event_ms(lambda: MK.mlstm_chunkwise(*ins,
                                                 out_dtype=torch.float32))
        print(f"mlstm main at B={B} NH=4 S=2048 hd=384 ({6 * 4 * B} "
              f"blocks): {ms:.4f} ms")


if __name__ == "__main__":
    main()
