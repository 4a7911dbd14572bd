#!/usr/bin/env python3
"""The correctness check's readings on the card, for setting its limits.

    python3 port_bench/control.py --workload <cell> --seeds 1,2,3 --seconds 10

For each seed, one run of the cell as `run.py` makes it (set-up, a window of
`--seconds`, the kept scenes), then the readings of each number compared:
the program's against the plain reference, and the control's (the reference
one precision below the configuration's, in the program's place, on the same
kept states).  One JSON line a seed.  The benchmark's own runs never run the
control.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from port_bench import run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    bench = run.load_json(run.ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    run.require_card(cells[args.workload]["chips"])
    for seed in (int(s) for s in args.seeds.split(",")):
        out, checks, found = run.run_cell(bench, args.workload, seed, args.seconds, False,
                                          control=True)
        print(json.dumps(dict(workload=args.workload, seed=seed, correct=out["correct"],
                              failed=out["failed"], metrics=out["metrics"],
                              program={k: c["value"] for k, c in checks.items()},
                              control=found.get("control"), samples=found["samples"])),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
