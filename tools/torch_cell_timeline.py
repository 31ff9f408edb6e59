#!/usr/bin/env python3
"""One run of a benchmark cell with the host's clock read at every epoch's
return, every request's start and every readout: where a run's window
went, epoch by epoch.

    python3 tools/torch_cell_timeline.py OUT.json --workload gan-part2-hole2s \
        --seed 3018000201 --seconds 30 --trace 0     # from the repository root

The arguments after OUT.json are ``benchmark/run.py``'s; the run is that
script's own, its result line printed as it prints it. The class that
``benchmark/manifest.py`` gives the cell is wrapped so that ``start``,
``epoch`` and ``finish`` note ``time.perf_counter()`` around each call;
nothing else changes. OUT.json gets the marks, as
``[kind, seconds]`` pairs (``s0``/``s1`` around a request's start, ``e``
after an epoch, ``f0``/``f1`` around a readout), and a summary, printed
to stderr: the epochs' spacing (median, 10th and 90th percentile, ms) and
each start's and readout's seconds. Where the host sets an epoch's pace the
spacing is the host's time an epoch; where the device does, the device's.
It needs a GPU, as the benchmark does; it imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time
from types import SimpleNamespace

sys.path.insert(0, os.getcwd())
from benchmark import manifest  # noqa: E402
import benchmark.run as run  # noqa: E402

MARKS: list[tuple[str, float]] = []


def _mark(kind: str) -> None:
    MARKS.append((kind, time.perf_counter()))


def timed_driver(driver):
    """``manifest.driver`` with the marks around the job's calls."""

    def wrapped(root, cfg):
        mod = driver(root, cfg)

        class Driver(mod.Driver):
            def start(self, req):
                _mark("s0")
                job = super().start(req)
                _mark("s1")
                epoch, finish = job.epoch, job.finish

                def timed_epoch(*a, **kw):
                    out = epoch(*a, **kw)
                    _mark("e")
                    return out

                def timed_finish(*a, **kw):
                    _mark("f0")
                    out = finish(*a, **kw)
                    _mark("f1")
                    return out

                job.epoch, job.finish = timed_epoch, timed_finish
                return job

        return SimpleNamespace(Driver=Driver)

    return wrapped


def summary(marks: list[tuple[str, float]]) -> dict:
    """The epochs' spacing in ms and the seconds of each start and readout."""
    ends = [t for kind, t in marks if kind == "e"]
    gaps = [(b - a) * 1e3 for a, b in zip(ends, ends[1:])]
    spans = {"s": [], "f": []}
    for (k0, t0), (k1, t1) in zip(marks, marks[1:]):
        if k0 in ("s0", "f0") and k1 == k0[0] + "1":
            spans[k0[0]].append(t1 - t0)
    deciles = statistics.quantiles(gaps, n=10) if len(gaps) > 1 else [None] * 9
    return {"epochs": len(ends), "spacing_ms_median": statistics.median(gaps) if gaps else None,
            "spacing_ms_p10": deciles[0], "spacing_ms_p90": deciles[-1],
            "start_s": spans["s"], "readout_s": spans["f"]}


def main(argv: list[str]) -> int:
    out, args = argv[0], argv[1:]
    manifest.driver = timed_driver(manifest.driver)
    rc = run.main(args)
    res = summary(MARKS)
    with open(out, "w") as f:
        json.dump({"marks": MARKS, "summary": res}, f)
    print(json.dumps(res), file=sys.stderr)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
