"""The control of the check that decides ``correct``, run on the card.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \
        --seconds 3

For each seed, one run of the cell at its own size and load with its
driver's control in the program's place (for the ``CompiledDesign``
drivers, the reference's int32-column sums in the place of
``Bank.execute``; see ``reference.py``); prints each number compared
and its limit.  Every
seed must come out not correct.  The benchmark's own runs never run it.
"""
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path[0] = str(REPO)
sys.path.insert(1, str(REPO / "src"))

from portbench import harness  # noqa: E402


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(prog="portbench/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    bench = harness.load_benchmark()
    all_wrong = True
    for seed in (int(s) for s in args.seeds.split(",")):
        res = harness.run_cell(bench, args.workload, seed, args.seconds,
                               False, t_start=time.perf_counter(),
                               control=True)
        all_wrong &= not res["correct"]
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control_correct": res["correct"],
                          "attempted": res["attempted"],
                          "failed": res["failed"],
                          "calls": res["record"].n_calls,
                          "checks": res["checks"]}), flush=True)
    return 0 if all_wrong else 1


if __name__ == "__main__":
    sys.exit(main())
