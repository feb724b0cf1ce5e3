"""How often does torch.profiler lose kernel records on this card?

Repeats the pattern that ``chip_smoke.py`` profiles in: one large
profiler session (6000 elementwise launches and one ``mlstm_chunkwise``
launch), the plain mLSTM between, then ``time_ms``'s session of ten
``mlstm_chunkwise`` launches. Prints each session whose kernel count
falls short, the counts of short sessions, and the wall time of the
large workload unprofiled afterwards.

    python3 tools/profiler_loss.py default 40     # kineto's defaults
    python3 tools/profiler_loss.py noteardown 40  # TEARDOWN_CUPTI=0

Needs one CUDA card; builds the mLSTM kernel from ``src/repro_torch``.
"""
import os
import sys
import time

MODE, ROUNDS = sys.argv[1], int(sys.argv[2])
if MODE == "noteardown":
    os.environ["TEARDOWN_CUPTI"] = "0"      # keep CUPTI across sessions
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as CS  # noqa: E402
from repro_torch.kernels import mlstm_kernel as MK  # noqa: E402

LARGE = 6000


def main() -> None:
    gen = torch.Generator("cuda").manual_seed(5)
    ins = CS._mlstm_inputs(gen, 8, 4, 2048, 384, torch.bfloat16)
    x = torch.randn(1024, 1024, device="cuda")

    def kernel():
        MK.mlstm_chunkwise(*ins, out_dtype=torch.float32)

    def large():
        y = x
        for _ in range(LARGE):
            y = y * 1.0001
        kernel()

    def session(fn, iters):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        ks = CS.cuda_kernels(prof)
        return len(ks), sum("mlstm_kernel" in n for n, _ in ks)

    kernel()
    torch.cuda.synchronize()
    short_large = short_kernel = 0
    for r in range(ROUNDS):
        a = session(large, 1)
        MK.mlstm_chunkwise_plain(*ins, out_dtype=torch.float32)
        torch.cuda.synchronize()
        b = session(kernel, 10)
        if a[0] != LARGE + 1:
            short_large += 1
            print(f"{MODE} round {r}: large session {a[0]} of "
                  f"{LARGE + 1} kernels")
        if b != (10, 10):
            short_kernel += 1
            print(f"{MODE} round {r}: kernel session {b[1]} of 10 "
                  f"mlstm_kernel launches ({b[0]} kernels)")
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        large()
        torch.cuda.synchronize()
        walls.append(round(1e3 * (time.perf_counter() - t0), 2))
    print(f"{MODE}: {short_large} of {ROUNDS} large sessions and "
          f"{short_kernel} of {ROUNDS} kernel sessions short; the large "
          f"workload unprofiled afterwards {walls} ms")


if __name__ == "__main__":
    main()
