"""The paper's §4 verification, reproduced: model-check eager insertion
with message-based state-space decomposition, and show the blowup the
decomposition avoids (Table 1 analog). Pure Python (no device).

  PYTHONPATH=src python -m repro_torch.examples.modelcheck_demo
"""
from ..core import modelcheck as mc


def main() -> int:
    scenario = mc.scenario_eager_insert(3, signals=2)

    print("== decomposed (the paper's method): one pass per message "
          "class ==")
    total = 0
    for s in mc.check_decomposed(scenario, max_states=50_000):
        total += s.states
        print(f"  focus={s.focus:<30} states={s.states:>7} "
              f"quiescent={s.quiescent:>4} violations={len(s.violations)}")
    print(f"  total decomposed states: {total}")

    print("\n== straightforward joint exploration (what blew up SPIN) ==")
    full = mc.check_full(scenario, max_states=50_000)
    print(f"  states={full.states} truncated={full.truncated}")
    print(f"\nblowup factor vs decomposition: "
          f"{full.states / max(total, 1):.1f}x"
          f"{' (and the joint run hit its state cap)' if full.truncated else ''}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
