"""Same-card comparison of flash_decode and the bf16 SSD scan with
variants of their own sources, the evidence for the choices in
``src/repro_torch/csrc/flash_decode.cu`` and ``csrc/mamba2_scan.cu``.
The CUDA-core decode kernel (f32, and bf16 groups of 1 to 3 heads) at
smollm's and zamba2's shapes:

    decode main      the kernel as built: splits for at least 132 blocks,
                     at most 8 a cluster, tiles with no valid key not read
    decode more      splits for at least 264 blocks
    decode split16   at most 16 splits a cluster (a non-portable size),
                     for at least 528 blocks
    decode no_skip   every slot read, valid key or not
    decode zfill     also the empty 32-key half of a tile that is read
                     zero-filled instead of read
    decode tile128   128-key tiles over 8 warps (256 threads)

the tensor-core decode kernel (bf16 groups of 4 to 16 heads,
``flash_decode_kernel_mma``) at mixtral's ring (B=4, H=32, Kh=8,
W=4096, hd 128, 8 layers' caches cycled) and llava's cache (B=2, H=56,
Kh=8, W=1152 with the first 1100 slots valid, 16 layers), beside SDPA:

    mma main         the kernel as built: mma.sync m16n8k16, a TMA ring of
                     4 (K, V) tile pairs fed by a producer warp, the most
                     splits (at most 8 a cluster) that keep the grid to
                     66 blocks, half the SMs in one wave (2 splits at
                     mixtral's 32 (row, KV head) pairs, 4 at llava's 16)
    mma stages2      a ring of 2 tile pairs
    mma stages3      a ring of 3 tile pairs
    mma blocks33     at most 33 blocks (1 split at mixtral's shape)
    mma blocks132    at most 132 blocks, one an SM (4 splits at mixtral's;
                     3 stages)
    mma blocks264    at most 264 blocks, two an SM (8 splits at mixtral's;
                     3 stages, so two blocks fit an SM)
    mma split16      at most 16 splits a cluster (a non-portable size), at
                     most 528 blocks (16 at mixtral's shape; 3 stages)
    mma cuda_cores   the CUDA-core kernel's 16-head bucket instead (the
                     decode before this kernel: spare heads computed on
                     zeros)

and each variant's floor, one 64-key tile a row at mixtral's heads.
(``wgmma`` with the heads as 64 padded rows was not built: m16 already
holds every group.) Then the SSD scan:

    scan main        the kernel as built: wgmma, hi/lo bf16 operands, two
                     warpgroups (the chain through h; the rest)
    scan no_lo       one bf16 operand each (the lo products dropped):
                     faster and less exact (fails the bf16 limit)
    scan lo_w_only   the lo operand for W only (fails the bf16 limit)
    scan no_store    diagnostic, wrong results: y is computed, not stored
    scan no_load     diagnostic, wrong results: no loads after the
                     third chunk
    scan no_prefix   diagnostic, wrong results: the chunk vectors (warp
                     0's prefix sum) computed for the first chunk only
    scan no_state    diagnostic, wrong results: no state update products
    scan no_wx       diagnostic, wrong results: no W x products

Each variant is the source with a textual substitution, compiled with
the build's ``nvcc`` flags into ``build/repro_torch/variants/`` and
swapped in for the wrapper's bf16 entry point (``main``, the source as
it is, is built the same way; ``source_variants.py``). Prints the card,
ptxas' registers, spills and performance remarks of the main-path
instantiations for each build, the error against the plain version (for
the scan, whether it holds ``chip_smoke.SCAN_TOL``'s bf16 limit), and
device ms per call
at ``chip_smoke.py``'s timing shapes, in the order main, the variants,
the variants reversed, main: the decode's by ``chip_smoke.time_ms``
(profiler device time), the scan's by CUDA events over back-to-back
calls (at 0.1 ms and more a call the launch rate does not show), and
the decode's floor: main at one 128-key tile a row (W=128, 24 blocks).

    python3 tools/decode_scan_variants.py [decode|mma|scan]

(one part only when named). Beside the variants, the scan as built at
B=1 (112 blocks, at most one an SM) and at S=1024: whether a block's
chunk loop or the SM's throughput bounds it. Needs one CUDA card and
``nvcc``.
"""
import ctypes
import functools
import os
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import chip_smoke as CS  # noqa: E402  (before torch: it sets TEARDOWN_CUPTI)
import torch  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_decode as FD  # noqa: E402
from repro_torch.kernels import mamba2_scan as MS  # noqa: E402
from source_variants import build_variants  # noqa: E402

DECODE_EDITS = {
    "main": [],
    "more": [("MIN_BLOCKS = 132;", "MIN_BLOCKS = 264;")],
    "split16": [
        ("MAX_SPLIT = 8;      // blocks in a cluster (portable limit)",
         "MAX_SPLIT = 16;"),
        ("MIN_BLOCKS = 132;", "MIN_BLOCKS = 528;"),
        ("  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a);",
         "  if (ns > 8) cudaFuncSetAttribute(kernel, "
         "cudaFuncAttributeNonPortableClusterSizeAllowed, 1);\n"
         "  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a);")],
    "no_skip": [("return !row_any || qflag[grp];", "return true;")],
    "zfill": [("        const bool ok = j < n;\n        const long long row = ok",
               "        const bool ok = j < n && wanted(QUARTERS * tl + j / 32);"
               "\n        const long long row = ok")],
    "tile128": [("TILE = 64;", "TILE = 128;"), ("THREADS = 128;",
                                                 "THREADS = 256;")],
}
ST4 = "STAGES = 4;                       // (K, V) tile pairs"
MMA_LAUNCH = "  if ((err = (int)cudaLaunchKernelEx(&cfg, kernel, km, vm, a)))"
MMA_EDITS = {
    "main": [],
    "stages2": [(ST4, ST4.replace("4", "2"))],
    "stages3": [(ST4, ST4.replace("4", "3"))],
    "blocks33": [("MAX_BLOCKS = 66;", "MAX_BLOCKS = 33;")],
    "blocks132": [("MAX_BLOCKS = 66;", "MAX_BLOCKS = 132;"),
                  (ST4, ST4.replace("4", "3"))],
    "blocks264": [("MAX_BLOCKS = 66;", "MAX_BLOCKS = 264;"),
                  (ST4, ST4.replace("4", "3"))],
    "split16": [("MAX_SPLIT = 8;                    // blocks in a cluster",
                 "MAX_SPLIT = 16;                    // blocks in a cluster"),
                ("MAX_BLOCKS = 66;", "MAX_BLOCKS = 528;"),
                (ST4, ST4.replace("4", "3")),
                (MMA_LAUNCH, "  if (ns > 8 && (err = (int)cudaFuncSetAttribute(\n"
                 "          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed,"
                 " 1)))\n    return err;\n" + MMA_LAUNCH)],
    "cuda_cores": [("if (a.g > 3 && tc::tma_ok(a, B))",
                    "if (a.g > MAX_G && tc::tma_ok(a, B))")],
}
SCAN_EDITS = {
    "main": [],
    "no_lo": [
        ("part < 2;", "part < 1;"),
        ("        hopper::wgmma_rs(hacc, al[kk], bd);\n", ""),
        ("        hopper::wgmma_rs(yacc, wl[kk], xd);\n", "")],
    "lo_w_only": [
        ("part < 2;", "part < 1;"),
        ("        hopper::wgmma_rs(hacc, al[kk], bd);\n", "")],
    "no_store": [("            store2(yr + 8 * k,",
                  "            if (a0 < 0) store2(yr + 8 * k,")],
    "no_load": [("if (c + TC_STAGES - 1 < nchunk)",
                 "if (c + TC_STAGES - 1 < TC_STAGES)")],
    "no_prefix": [("if (warp == 0 && c + 1 < nchunk) {",
                   "if (warp == 0 && c + 1 < 0) {")],
    "no_state": [("        hopper::wgmma_rs(hacc, ah[kk], bd);\n"
                  "        hopper::wgmma_rs(hacc, al[kk], bd);\n", "")],
    "no_wx": [("        hopper::wgmma_rs(yacc, wa[kk], xd);\n"
               "        hopper::wgmma_rs(yacc, wl[kk], xd);\n", "")],
}
# the main paths' instantiations: decode <bf16, hd, G>, scan <f32 y, P, N>
PTXAS = {"flash_decode": (r"flash_decode_kernelI13__nv_bfloat16Li64ELi3E",
                          r"flash_decode_kernelI13__nv_bfloat16Li112ELi1E",
                          r"flash_decode_kernel_mmaILi128E",
                          r"flash_decode_kernelI13__nv_bfloat16Li128ELi16E"),
         "mamba2_scan": (r"ssd_tc_kernelIfLi64ELi64E",)}


def ptxas_summary(name: str, log: str) -> str:
    """Registers and spills of the main-path instantiations, and ptxas'
    performance remarks on them (wgmma serialized, C75xx)."""
    out = []
    for pat in PTXAS[name]:
        m = re.search(pat + r".*?\n(?:.*?(\d+) bytes spill stores.*?\n)?"
                      r".*?Used (\d+) registers", log)
        if m:
            out.append(f"{pat.split('_kernel')[1]}: {m.group(2)} registers,"
                       f" {m.group(1) or 0} bytes spilled")
        out += [line.split("Potential Performance Loss: ")[-1].split(
                " for the function")[0] for line in log.splitlines()
                if re.search(pat, line) and "C75" in line]
    return "; ".join(out)


def event_ms(fn, iters: int = 20) -> float:
    """Device ms per call by CUDA events over back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def decode_cases(gen):
    """chip_smoke.py's two decode timing shapes: (name, calls, inputs)."""
    out = []
    for hd, B, W, L, heads in ((64, 8, 1024, 30, {}),
                               (112, 4, 256, 27, CS.SHARED)):
        q, k, v, valid = CS._decode_inputs(B, W, torch.bfloat16, gen, L=L,
                                           **heads)
        valid[0] = 1
        views = [(k[i].permute(0, 2, 1, 3), v[i].permute(0, 2, 1, 3))
                 for i in range(L)]
        out.append((f"hd {hd}", q, views, valid))
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    print(CS.card_line())
    build.build_all(["flash_decode", "mamba2_scan"])
    gen = torch.Generator("cuda").manual_seed(0)
    parts = sys.argv[1:] or ["decode", "mma", "scan"]
    if "decode" in parts:
        decode_variants(gen)
    if "mma" in parts:
        mma_variants(gen)
    if "scan" in parts:
        scan_variants(gen)


def decode_variants(gen) -> None:
    main_fn = FD._kernel(torch.bfloat16)
    fns = {}
    for var, (fn, info) in build_variants(
            "flash_decode", DECODE_EDITS, "flash_decode_bf16",
            functools.partial(ptxas_summary, "flash_decode")).items():
        fn.argtypes, fn.restype = main_fn.argtypes, ctypes.c_int
        fns[var] = (fn, info)
    for var, (_, info) in fns.items():
        print(f"ptxas decode {var}: {info}")
    cases = decode_cases(gen)
    order = list(DECODE_EDITS)
    for var in order + order[::-1]:
        FD._lib[torch.bfloat16] = fns[var][0]
        row = []
        for what, q, views, valid in cases:
            err = max((FD.flash_decode(q, kk, vv, valid).float()
                       - FD.decode_ref(q, kk, vv, valid).float()).abs().max()
                      .item() for kk, vv in views[:2])
            ms, _ = CS.time_ms(lambda: [FD.flash_decode(q, kk, vv, valid)
                                        for kk, vv in views],
                               calls=len(views), kernels=CS.DECODE)
            row.append(f"{what}: {ms:.4f} ms (err {err:.3e})")
        print(f"decode {var}: " + "; ".join(row))
    FD._lib[torch.bfloat16] = main_fn
    q, k, v, valid = CS._decode_inputs(8, 128, torch.bfloat16, gen, L=30)
    valid[0] = 1
    views = [(k[i].permute(0, 2, 1, 3), v[i].permute(0, 2, 1, 3))
             for i in range(30)]
    ms, _ = CS.time_ms(lambda: [FD.flash_decode(q, kk, vv, valid)
                                for kk, vv in views],
                       calls=len(views), kernels=CS.DECODE)
    print(f"decode main floor (B=8 H=9 Kh=3 W=128 hd=64): {ms:.4f} ms")


def mma_cases(gen):
    """chip_smoke.py's two grouped-query decode timing shapes, and the
    floor: (name, q, the layers' (k, v) views, valid)."""
    out = []
    for what, B, H, W, L, mask in (("mixtral", 4, 32, 4096, 8, "ring"),
                                   ("llava", 2, 56, 1152, 16, 1100),
                                   ("floor", 4, 32, 64, 8, "all")):
        q, views, valid = CS._fam_decode_inputs(gen, B, H, 8, W, 128, L,
                                                mask, torch.bfloat16)
        out.append((what, q, views, valid))
    return out


def mma_variants(gen) -> None:
    main_fn = FD._kernel(torch.bfloat16)
    fns = {}
    for var, (fn, info) in build_variants(
            "flash_decode", MMA_EDITS, "flash_decode_bf16",
            functools.partial(ptxas_summary, "flash_decode")).items():
        fn.argtypes, fn.restype = main_fn.argtypes, ctypes.c_int
        fns[var] = (fn, info)
    for var, (_, info) in fns.items():
        print(f"ptxas mma {var}: {info}")
    cases = mma_cases(gen)
    row = []
    for what, q, views, valid in cases:
        q4, mask = q[:, :, None, :], (valid[:, None, None, :] > 0)
        ms = event_ms(lambda: [torch.nn.functional.scaled_dot_product_attention(
            q4, kk, vv, attn_mask=mask, enable_gqa=True)
            for kk, vv in views], iters=10) / len(views)
        row.append(f"{what}: {ms:.4f} ms")
    print("mma SDPA (CUDA events): " + "; ".join(row))
    order = list(MMA_EDITS)
    for var in order + order[::-1]:
        FD._lib[torch.bfloat16] = fns[var][0]
        row = []
        for what, q, views, valid in cases:
            got = FD.flash_decode(q, *views[0], valid)
            want = FD.decode_ref(q, *views[0], valid)
            err = (got.float() - want.float()).abs().max().item()
            ms, _ = CS.time_ms(lambda: [FD.flash_decode(q, kk, vv, valid)
                                        for kk, vv in views],
                               calls=len(views), kernels=CS.DECODE)
            row.append(f"{what}: {ms:.4f} ms (err {err:.3e}, row "
                       f"{CS._row_err(got, want):.3e})")
        print(f"mma {var}: " + "; ".join(row))
    FD._lib[torch.bfloat16] = main_fn


def scan_variants(gen) -> None:
    key = (torch.bfloat16, torch.float32)
    main_fn = MS._kernel(*key)
    fns = {}
    for var, (fn, info) in build_variants(
            "mamba2_scan", SCAN_EDITS, "mamba2_scan_bf16_f32",
            functools.partial(ptxas_summary, "mamba2_scan")).items():
        fn.argtypes, fn.restype = main_fn.argtypes, ctypes.c_int
        fns[var] = (fn, info)
    for var, (_, info) in fns.items():
        print(f"ptxas scan {var}: {info}")
    ins = CS._scan_inputs(gen, 2, 112, 2048, torch.bfloat16)
    want = MS.mamba2_scan_plain(*ins, out_dtype=torch.float32)
    tol = CS.SCAN_TOL["bfloat16"]
    order = list(SCAN_EDITS)
    for var in order + order[::-1]:
        MS._fns[key] = fns[var][0]
        got = MS.mamba2_scan(*ins, out_dtype=torch.float32)
        err = ((got - want).abs() / (1 + want.abs())).max().item()
        held = "held" if err <= tol else "FAILS"
        ms = event_ms(lambda: MS.mamba2_scan(*ins, out_dtype=torch.float32))
        print(f"scan {var}: {ms:.4f} ms (max |err| / (1 + |y|) {err:.3e},"
              f" {held} {tol:g})")
    MS._fns[key] = main_fn
    for B, S in ((1, 2048), (2, 1024)):
        ins = CS._scan_inputs(gen, B, 112, S, torch.bfloat16)
        ms = event_ms(lambda: MS.mamba2_scan(*ins, out_dtype=torch.float32))
        print(f"scan main at B={B} NH=112 S={S}: {ms:.4f} ms")


if __name__ == "__main__":
    main()
