"""Same-card comparison of the bf16 attention kernels with variants of
their own sources: the forward, the evidence for two choices in
``src/repro_torch/csrc/flash_attention.cu``:

    main     the kernel as built: 384 threads, the producer warpgroup
             handing registers to the two consumer warpgroups
             (setmaxnreg 24 / 240), 64-key tiles at hd 112 and 128
    no_regs  288 threads (two consumer warpgroups and one producer
             warp), no setmaxnreg
    kv128    128-key tiles at every head dim

and the backward's dK / dV pass at HDP 128 (hd 112 and 128), the
evidence for the route ``src/repro_torch/csrc/flash_attention_bwd.cu``
takes:

    main     the kernel as built: 128-key tiles (``fa_dkdv_wide``), 256
             threads, no producer warp: warpgroup w the whole 64 x 128 dK
             and dV of key rows 64 w .. 64 w + 63, both from one (Q, dO)
             stage a pair, so each tile streamed serves 128 key rows
    no_mma   diagnostic, wrong results: main without its four products
             (ptxas then drops the arithmetic feeding them too)
    feed_only diagnostic, wrong results: main without its products and
             its exp and dS arithmetic: the TMA feed and the ring alone
    together main with both warpgroups starting at once (as built,
             warpgroup 1 starts once warpgroup 0 has issued its first
             products, so that their arithmetic phases fall between the
             other's products)
    stages3  main with a ring of 3 (Q, dO) stages (4 as built)
    cols     64-key tiles split by columns (``fa_dkdv_split``, spliced
             in from ``tools/fa_dkdv_split.cuh``), 288 threads:
             warpgroup 0 P^T, warpgroup 1 dS^T, handed over as bf16
             tiles; each warpgroup dK and dV of one 64-column panel
    regs     the register split (the HDP 64 pass's ``fa_dkdv_wgmma`` at
             HDP 128 and 384 threads): a producer warpgroup at setmaxnreg
             24, the two consumer warpgroups at 240, each the whole
             64 x 128 dK and dV on alternate (head, q tile) pairs
    alt      ``fa_dkdv_wgmma`` at HDP 128 and 288 threads, no setmaxnreg
             (the pass before this redesign: 64-key tiles, the two
             warpgroups on alternate pairs)

timed at the hybrid train path's shape (B=1, H=Kh=32, S=4096, hd 112,
causal) and at the hd-64 train cell's (B=4, H=9, Kh=3, S=1024, which
every variant runs alike: the HDP 64 pass is ``fa_dkdv_wgmma`` at 288
threads), beside SDPA's autograd backward. The whole backward (three
launches) is timed by CUDA events over back-to-back calls (at the hd-64
shape, 0.1 ms a call, that reading includes the host's time to build
four tensor maps a call); each variant's error is against the plain
gradient at B=1, H=Kh=32, S=1024, hd 112; for main, the device ms of
each CUDA function at the hybrid shape (profiler).

Each variant is the source with a textual substitution, compiled with
the build's ``nvcc`` flags into ``build/repro_torch/variants/`` and
swapped in for the wrapper's bf16 entry point
(``source_variants.py``). Prints the card, ptxas' registers and spills
of the variants' CUDA functions (``fa_fwd_wgmma<64>`` and ``<112>``;
the dK / dV pass at hd 112 and 128), the error against the plain
version, and device ms per call, the forward's by ``chip_smoke.time_ms``
at the serve (hd 64) and hybrid (hd 112) timing shapes, in the order
main, the variants, the variants reversed, main.

    python3 tools/attn_variants.py [fwd|bwd]

(one part only when named).

Needs one CUDA card and ``nvcc``.
"""
import ctypes
import os
import re
import sys
from pathlib import Path

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
# the losing routes, built from the source as it is: the 64-key
# fa_dkdv_wgmma at HDP 128 in place of fa_dkdv_wide, then with the
# register split, and fa_dkdv_split spliced in from fa_dkdv_split.cuh
WIDE_LAUNCH = ("  if constexpr (C::HDP == 128) {\n"
               "    if ((err = set_smem(fa_dkdv_wide<HD>, Wide::SMEM))) return err;\n")
ALT = [(WIDE_LAUNCH, WIDE_LAUNCH.replace("C::HDP == 128", "false"))]
REGS = ALT + [
    ("static constexpr int KV_THREADS = 288;",
     "static constexpr int KV_THREADS = HDP == 128 ? 384 : 288;"),
    ("  if (warp == 8) {                         // producer\n",
     "  if constexpr (HDP == 128) {\n"
     "    if (warp >= 8) hopper::regs_dec<24>();\n"
     "  }\n"
     "  if (warp == 8) {                         // producer\n"),
    ("  } else {\n    // consumer warpgroups",
     "  } else if (warp < 8) {\n"
     "    if constexpr (HDP == 128) hopper::regs_inc<240>();\n"
     "    // consumer warpgroups")]
LAUNCH = "template <int HD>\nint launch_wgmma("
COLS = [(LAUNCH, (Path(__file__).parent / "fa_dkdv_split.cuh").read_text()
         + "\n" + LAUNCH),
        ("fa_dkdv_wide<HD>, Wide::SMEM", "fa_dkdv_split<HD>, Split::SMEM"),
        ("(unsigned)((a.Sk + 127) / 128)", "(unsigned)((a.Sk + 63) / 64)"),
        ("fa_dkdv_wide<HD><<<grid_wide, Wide::THREADS, Wide::SMEM",
         "fa_dkdv_split<HD><<<grid_wide, Split::THREADS, Split::SMEM")]
WIDE_MMA = [("    tile_nt<128>(st, Kw, qd);              // S^T = K Q^T\n"
             "    tile_nt<128>(dpt, Vw, dod);            // dP^T = V dO^T\n", ""),
            ("    tile_nn(dv_acc, pf, dod);              // dV += P^T dO\n"
             "    tile_nn(dk_acc, df, qd);               // dK += dS^T Q\n", "")]
BWD_EDITS = {
    "main": [],
    "no_mma": WIDE_MMA,
    "feed_only": WIDE_MMA + [
        ("        float p = exp2f(st[4 * i + j] * sl2 - lc[c]);\n"
         "        if (edge && !visible(q0 + c, kr + (j >> 1) * 8, a)) p = 0.f;\n"
         "        st[4 * i + j] = p;\n"
         "        dpt[4 * i + j] = p * (dpt[4 * i + j] - dc[c]);\n", "")],
    "together": [("  if (wg == 1 && npairs > 0) hopper::bar_sync(3, 256);\n", ""),
                 ("    if (wg == 0 && n == 0) hopper::bar_arrive(3, 256);\n", "")],
    "stages3": [("  static constexpr int STAGES = 4;\n"
                 "  static constexpr int RING = STAGES * 2 * TILE;     // (Q, dO) stages\n"
                 "  static constexpr int TILES = 4 * TILE + RING;",
                 "  static constexpr int STAGES = 3;\n"
                 "  static constexpr int RING = STAGES * 2 * TILE;     // (Q, dO) stages\n"
                 "  static constexpr int TILES = 4 * TILE + RING;")],
    "cols": COLS,
    "regs": REGS,
    "alt": ALT,
}
BWD_SHAPES = {"hybrid train": dict(B=1, S=4096, H=32, Kh=32, hd=112),
              "hd 64 train": dict(B=4, S=1024, H=9, Kh=3, hd=64)}


def ptxas_summary(log: str, func: str = "fa_fwd_wgmma",
                  hds=tuple(SHAPES)) -> dict:
    """{head dim: 'N registers, S bytes spilled'} of ``func``."""
    out = {}
    for hd in hds:
        m = re.search(rf"{func}ILi{hd}E.*?\n\s*(\d+) bytes stack "
                      rf"frame, (\d+) bytes spill stores.*?\n.*?Used (\d+) "
                      rf"registers", log)
        if m:
            out[hd] = f"{m.group(3)} registers, {m.group(2)} bytes spilled"
    return out


def bwd_ptxas(log: str) -> dict:
    """The dK / dV pass's registers and spills at hd 112 and 128, under
    whichever of its two CUDA functions the build launches there."""
    return {f: ptxas_summary(log, f, (112, 128))
            for f in ("fa_dkdv_wide", "fa_dkdv_split", "fa_dkdv_wgmma")
            if ptxas_summary(log, f, (112, 128))}


def bwd_variants() -> None:
    import torch.nn.functional as F
    main_fn = FA._kernel("flash_attention_bwd", torch.bfloat16)
    fns = {}
    for name, (fn, info) in build_variants(
            "flash_attention_bwd", BWD_EDITS, "flash_attention_bwd_bf16",
            bwd_ptxas).items():
        fn.argtypes, fn.restype = main_fn.argtypes, ctypes.c_int
        fns[name] = (fn, info)
    for name, (_, info) in fns.items():
        print(f"ptxas bwd {name}: {info}")
    gen = torch.Generator("cuda").manual_seed(0)
    ins = {}
    for what, sh in BWD_SHAPES.items():
        q, k, v = CS._attn_inputs(sh["B"], sh["S"], torch.bfloat16, gen,
                                  H=sh["H"], Kh=sh["Kh"], hd=sh["hd"])
        do = torch.randn((sh["B"], sh["S"], sh["H"], sh["hd"]),
                         generator=gen, device="cuda").to(
                             torch.bfloat16).transpose(1, 2)
        out, lse = FA._forward(q, k, v, True, None, want_lse=True)
        ins[what] = (q, k, v, out, do, lse)
        sq = [x.detach().requires_grad_(True) for x in (q, k, v)]
        so = F.scaled_dot_product_attention(*sq, is_causal=True,
                                            enable_gqa=sh["H"] != sh["Kh"])
        lib, _ = CS.time_ms(lambda: torch.autograd.grad(
            so, sq, do, retain_graph=True))
        print(f"bwd SDPA {what}: {lib:.4f} ms")
        del sq, so
    small = CS._attn_inputs(1, 1024, torch.bfloat16, gen, H=32, Kh=32,
                            hd=112)
    dsm = torch.randn((1, 32, 1024, 112), generator=gen,
                      device="cuda").to(torch.bfloat16)
    want = FA.attention_bwd_ref(*small, dsm)
    osm, lsm = FA._forward(*small, True, None, want_lse=True)
    order = list(BWD_EDITS)
    for name in order + order[::-1]:
        FA._fns["flash_attention_bwd"][torch.bfloat16] = fns[name][0]
        got = FA.flash_attention_bwd(*small, osm, dsm, lsm)
        err = max((g.float() - w.float()).abs().max().item()
                  for g, w in zip(got, want))
        row = []
        for what, args in ins.items():
            sh = BWD_SHAPES[what]
            ms = event_ms(lambda: FA.flash_attention_bwd(*args))
            fl = FA.attention_bwd_flops(sh["B"], sh["H"], sh["S"], sh["S"],
                                        sh["hd"], True, None)
            row.append(f"{what}: {ms:.4f} ms ({fl / ms / 1e9:.1f} TFLOP/s)")
        print(f"bwd {name}: " + "; ".join(row) + f" (err {err:.3e})")
        if name == "main":
            print("bwd main, hybrid train, device ms a call by CUDA "
                  "function: " + kernel_split(ins["hybrid train"]))
    FA._fns["flash_attention_bwd"][torch.bfloat16] = main_fn


def event_ms(fn, iters: int = 20) -> float:
    """Device ms per call by CUDA events over back-to-back calls (at 0.1
    ms and more a call the launch rate does not show)."""
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


def kernel_split(args, iters: int = 5) -> str:
    """Device ms a call of each CUDA function of the backward."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            FA.flash_attention_bwd(*args)
        torch.cuda.synchronize()
    by = {}
    for name, ms in CS.cuda_kernels(prof):
        key = next((m for m in CS.ATTN_BWD_BF16 if m in name), name[:30])
        by[key] = by.get(key, 0.0) + ms / iters
    return ", ".join(f"{k} {v:.4f}" for k, v in by.items())


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    print(CS.card_line())
    parts = sys.argv[1:] or ["fwd", "bwd"]
    if "fwd" in parts:
        fwd_variants()
    if "bwd" in parts:
        bwd_variants()


def fwd_variants() -> None:
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
