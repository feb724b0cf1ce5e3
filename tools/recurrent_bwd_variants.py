"""Same-card comparison of the two bf16 backward kernels with variants of
their own sources and with the CUDA-core kernels they replace, the
evidence for the choices in ``src/repro_torch/csrc/mlstm_chunkwise_bwd.cu``
and ``src/repro_torch/csrc/mamba2_scan_bwd.cu``:

mlstm_chunkwise_bwd (tensor cores, five launches):

    main       the kernel as built: the state passes' blocks one 64-column
               value tile wide (SJ = 1), three stages of C0 / dC tiles in
               mlstm_bwd_dqdk, two of dC tiles in mlstm_bwd_dv
    cuda_core  the CUDA-core kernel (mlstm_bwd_kernel, which f32 and hd 32
               and 64 keep), called at hd 384: the design this one
               replaces
    sj2, sj3   state-pass blocks two or three value tiles wide
    dqdk_st2   two stages of streamed tiles in mlstm_bwd_dqdk
    dv_st3     three stages in mlstm_bwd_dv
    no_states  diagnostic, wrong results: no state passes (C0 and dC are
               what the scratch held, so the first call may still find
               the last variant's states and hold): the chunk-parallel
               launches alone

mamba2_scan_bwd (tensor cores, three launches):

    main       the kernel as built: a block of ssd_bwd_chunk sums dB and
               dC over G = 4 heads on chip
    cuda_core  the CUDA-core kernel (ssd_bwd_kernel, which f32 and the
               other P, N keep), called at P = N = 64
    g1         one head a block: every head's dB and dC through device
               memory, as the CUDA-core kernel reduced them
    g8, g16    eight or sixteen heads a block
    no_states  diagnostic, wrong results: no state pass

No variant drops a lo product: the kernels keep none (one bf16 operand a
product; tests/test_torch_recurrent_bwd.py shows why). Each variant is the
source with a textual substitution, compiled with the build's ``nvcc``
flags into ``build/repro_torch/variants/`` and swapped in for the
wrapper's tensor-core entry point (``source_variants.py``). Prints the
card, ptxas' registers and spills of each build's kernels, each variant's
worst gradient error against the plain backward (and whether it holds
``chip_smoke.BWD_TOL``'s 2e-2), and device ms per call by CUDA events
over back-to-back calls at the table's and the train paths' shapes (mLSTM
B=8 and B=2, NH=4, S=2048 and 1024, hd 384; scan B=2, NH=112, S=2048 and
B=1, S=4096, P=N=64), in the order main, cuda_core, the variants, the
same reversed, main.

    python3 tools/recurrent_bwd_variants.py

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
from repro_torch.kernels import mamba2_scan as MS  # noqa: E402
from repro_torch.kernels import mlstm_kernel as MK  # noqa: E402
from source_variants import build_variants  # noqa: E402

MLSTM_EDITS = {
    "main": [],
    "sj2": [("constexpr int SJ = 1;", "constexpr int SJ = 2;")],
    "sj3": [("constexpr int SJ = 1;", "constexpr int SJ = 3;")],
    "dqdk_st2": [("constexpr int NST_DQDK = 3;",
                  "constexpr int NST_DQDK = 2;")],
    "dv_st3": [("constexpr int NST_DV = 2;", "constexpr int NST_DV = 3;")],
    "no_states": [
        ("  t::mlstm_bwd_fstate<<<", "  if (S < 0) t::mlstm_bwd_fstate<<<"),
        ("  t::mlstm_bwd_rstate<<<", "  if (S < 0) t::mlstm_bwd_rstate<<<")],
}
SCAN_EDITS = {
    "main": [],
    "g1": [("constexpr int G = 4;", "constexpr int G = 1;")],
    "g8": [("constexpr int G = 4;", "constexpr int G = 8;")],
    "g16": [("constexpr int G = 4;", "constexpr int G = 16;")],
    "no_states": [("  t::ssd_bwd_state<<<", "  if (S < 0) t::ssd_bwd_state<<<")],
}
MAIN_GROUP = MS.TC_GROUP
GROUP = {"g1": 1, "g8": 8, "g16": 16}   # the scratch's head groups


def ptxas_summary(log: str) -> str:
    """Registers and spills of each tensor-core kernel of a build."""
    out = []
    for m in re.finditer(r"Function properties for \S*tcb[0-9]+(\w+?)E\S*\n"
                         r".*?(\d+) bytes spill stores.*?\n"
                         r".*?Used (\d+) registers", log):
        out.append(f"{m.group(1)} {m.group(3)} regs {m.group(2)} B spilled")
    return "; ".join(out)


def worst(got, want) -> float:
    torch.cuda.synchronize()
    return max((g.float() - w.float()).abs().max().item()
               / w.float().abs().max().item() for g, w in zip(got, want))


def compare(what, fns, key, table, call, cases, order):
    """Each variant's error and ms at each case, in ``order``."""
    main_fn = table[key]
    for label, args, want in cases:
        for var in order:
            if var == "cuda_core":
                fn = lambda: call(args, "bf16")
                err = worst(fn(), want)
                ms = event_ms(fn, iters=3)
            else:
                table[key] = fns[var][0]
                MS.TC_GROUP = GROUP.get(var, MAIN_GROUP)
                fn = lambda: call(args, "tc")
                err = worst(fn(), want)
                ms = event_ms(fn)
            held = "held" if err <= CS.BWD_TOL["bfloat16"] else "FAILS"
            print(f"{what} {label} {var}: {ms:.4f} ms (worst gradient error "
                  f"{err:.3e}, {held} {CS.BWD_TOL['bfloat16']})", flush=True)
    table[key] = main_fn
    MS.TC_GROUP = MAIN_GROUP


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    print(CS.card_line())
    build.build_all(["mlstm_chunkwise", "mlstm_chunkwise_bwd",
                     "mamba2_scan_bwd"])
    gen = torch.Generator("cuda").manual_seed(23)

    MK._bwd_kernel("tc")
    fns = build_variants("mlstm_chunkwise_bwd", MLSTM_EDITS,
                         "mlstm_chunkwise_bwd_tc", ptxas_summary)
    for var, (fn, info) in fns.items():
        fn.argtypes = MK._bwd_fns["tc"].argtypes
        fn.restype = ctypes.c_int
        print(f"ptxas mlstm {var}: {info}")
    cases = []
    for B, S in ((8, 2048), (2, 1024)):
        ins = CS._mlstm_inputs(gen, B, 4, S, 384, torch.bfloat16)
        y = MK.mlstm_chunkwise(*ins, out_dtype=torch.float32)
        dy = torch.randn((B, 4, S, 384), generator=gen, device="cuda")
        cases.append((f"B={B} NH=4 S={S} hd=384", (*ins, y, dy),
                      MK.mlstm_chunkwise_bwd_plain(*ins, dy)))
    order = ["main", "cuda_core"] + list(MLSTM_EDITS)[1:]
    compare("mlstm_chunkwise_bwd", fns, "tc", MK._bwd_fns,
            lambda a, route: MK._bwd(*a, route), cases,
            order + order[::-1])
    del cases

    MS._bwd_kernel("tc")
    fns = build_variants("mamba2_scan_bwd", SCAN_EDITS, "mamba2_scan_bwd_tc",
                         ptxas_summary)
    for var, (fn, info) in fns.items():
        fn.argtypes = MS._bwd_fns["tc"].argtypes
        fn.restype = ctypes.c_int
        print(f"ptxas scan {var}: {info}")
    cases = []
    for B, S in ((2, 2048), (1, 4096)):
        ins = CS._scan_inputs(gen, B, 112, S, torch.bfloat16)
        dy = torch.randn((B, 112, S, 64), generator=gen, device="cuda")
        cases.append((f"B={B} NH=112 S={S} P=N=64", (*ins, dy),
                      MS.mamba2_scan_bwd_plain(*ins, dy)))
    order = ["main", "cuda_core"] + list(SCAN_EDITS)[1:]
    compare("mamba2_scan_bwd", fns, "tc", MS._bwd_fns,
            lambda a, route: MS._bwd(*a, route), cases,
            order + order[::-1])


if __name__ == "__main__":
    main()
