#!/usr/bin/env python3
"""The control of a cell's correctness check: the reference, put in the
port's place and computed in the precision below the configuration's
(the ``control`` of the check that the configuration names; training:
TF32 for float32 with TF32 off, float8 e4m3 operands for bfloat16), held
to the reference as a run holds the port (that check's ``compare``).

    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...] [--epochs 3]

For each seed it prints one JSON line: the numbers of the check's
``NUMBERS``, where each read its worst, and the cell's limits. A limit is
sound only where the control reads over it. The benchmark's own runs
never run this; it needs a GPU (the tests call ``readings`` on the CPU).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from benchmark import gen, manifest  # noqa: E402


def readings(cell, seed: int, device, epochs: int = 3) -> tuple[dict, dict]:
    """(numbers, where) of the control on the cell's first request of
    ``seed``, at the cell's own sizes."""
    kind = manifest.check(ROOT, cell.config)
    req = gen.make_request(cell.traffic, cell.config, seed, 0)
    start, steps, answers = kind.control(cell.config, cell.traffic, req, device, epochs)
    return kind.compare(cell.config, cell.traffic, start, steps, answers, device)


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--epochs", type=int, default=3,
                   help="the control's steps before its later step and readout")
    a = p.parse_args(argv)
    cell = manifest.cell(ROOT, a.workload)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    for seed in a.seeds:
        numbers, where = readings(cell, seed, device, a.epochs)
        print(json.dumps({"workload": a.workload, "seed": seed, "control": numbers,
                          "where": where, "limits": cell.limits}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
