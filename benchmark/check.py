"""The comparison that decides ``correct``: what every kind of check
shares.

A configuration names its kind of check as it names its driver:
``"check": "<kind>"`` is the module ``checks/<kind>.py``
(``manifest.check``), which exports

- ``NUMBERS``: the names of the numbers it compares, which a cell's
  limits file (``limits/<cell>.json``) chooses from;
- ``compare(config, traffic, start, steps, answers, device)``: the
  numbers for what a run hands over, and where each read its worst (two
  dicts by name), the plain reference (``reference/``, which imports
  nothing of the port) deriving each request's inputs again from its host
  inputs and seed;
- ``control(config, traffic, req, device, epochs)``: what the control,
  the reference one precision lower in the port's place, hands over for
  the request ``req``, as a run does: (``Start``, [``Step``],
  [``Answer``]), the later step taken after ``epochs`` steps;
- ``FAULTS``: {name: a context manager that plants the fault underneath
  the timed path while it is open}; the check must come out not correct
  under each.

A step is whatever the driver's ``job.epoch()`` runs: a training epoch, or
one denoising evaluation; ``traffic["epochs"]`` counts the steps of a
request. A state is whatever ``job.states()`` reads for the kind's check,
one entry a clip. What a run hands over (from the port, or, for the
control, from the reference):

- ``Start``: the first request's first three steps, as set-up drove them
  through the window's own ``epoch`` call: each step's return as
  ``job.losses`` reads it, and the states at the start, after step 1 and
  after step 3;
- ``Step``: one step taken after the window from the state that the
  window left (the stage the start does not see): the state before, the
  step's return and the state after;
- ``Answer``: a request read out and synthesised to audio: the state it
  was read from and the audio.

A cell compares the numbers that its limits file names (see PERF.md for
why a cell leaves one out); the others are shown with the limit null.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Start:
    req: object
    losses: list          # per step, (G, kinds): each step's return on the host
    s0: list              # per clip states: at the start
    s1: list              # after step 1
    s3: list              # after step 3


@dataclass
class Step:
    req: object
    before: list
    losses: np.ndarray    # (G, kinds)
    after: list


@dataclass
class Answer:
    req: object
    state: list
    audio: np.ndarray     # (G, n)


def judge(numbers: dict[str, float], limits: dict[str, float]) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): correct when every number that
    has a limit is finite and at most its limit; a number without one is
    shown with the limit null."""
    checked = {k: {"value": v, "limit": limits.get(k)} for k, v in numbers.items()}
    ok = all(np.isfinite(v["value"]) and v["value"] <= v["limit"]
             for v in checked.values() if v["limit"] is not None)
    return ok, checked
