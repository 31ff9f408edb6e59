#!/usr/bin/env python3
"""The check's numbers under each fault that a cell's kind of check plants
underneath the timed path (the ``FAULTS`` of ``checks/<kind>.py``, each a
context manager that patches the port while it is open). The check must
come out not correct under each fault a cell can have; the tests plant
them at a small size on the CPU, and

    python3 benchmark/faults.py --workload <cell> --seeds <n> [<n> ...] [--seconds 5] [--faults ...]

reads their numbers at the cell's own size, one JSON line a fault and
seed. The benchmark's runs plant none.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import manifest  # noqa: E402
from benchmark import run as harness  # noqa: E402


def main(argv=None) -> int:
    """Read each fault's numbers at the cell's own size: ``--workload``,
    ``--seeds``, ``--seconds`` (the window before the check), ``--faults``
    (every fault of the cell's kind by default)."""
    p = argparse.ArgumentParser(description="the check's numbers under each planted fault")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--faults", nargs="+")
    a = p.parse_args(argv)
    faults = manifest.check(ROOT, manifest.cell(ROOT, a.workload).config).FAULTS
    unknown = sorted(set(a.faults or ()) - set(faults))
    if unknown:
        p.error(f"the cell's check has no fault {', '.join(unknown)}; it has {', '.join(faults)}")
    for fault in a.faults or list(faults):
        for seed in a.seeds:
            with faults[fault]():
                res = harness.run(a.workload, seed, a.seconds, False, "cuda")
            print(json.dumps({"workload": a.workload, "fault": fault, "seed": seed,
                              "correct": res["correct"], "checked": res["checked"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
