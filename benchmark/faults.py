"""Faults planted in the port underneath the timed path, each a context
manager that patches the port while it is open. The check must come out
not correct under each fault a cell can have; the tests plant them at a
small size on the CPU, and ``python3 benchmark/faults.py`` reads their
numbers at the cell's own size. The benchmark's runs plant none.

- ``unchanged``: every optimizer step returns the state it was given;
- ``half_batch``: the second half of every clip's frames leaves the
  training loss, whose mean is taken over the rest;
- ``altered_answer``: each readout's composite comes out scaled by 0.9
  where it is produced.

One cell runs on one chip, so no cell has an exchange between chips to
leave out.
"""

from __future__ import annotations

import contextlib
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from audio_inpainting_torch.methods.neural import GANTrainer, UNetTrainer  # noqa: E402


@contextlib.contextmanager
def _patched(owner, name, make):
    orig = getattr(owner, name)
    setattr(owner, name, make(orig))
    try:
        yield
    finally:
        setattr(owner, name, orig)


@contextlib.contextmanager
def unchanged():
    with _patched(torch.optim.Adam, "step", lambda orig: lambda self, closure=None: None):
        yield


def _halve(trainer) -> None:
    half = torch.ones_like(trainer.vld)
    half[..., half.shape[-1] // 2:] = 0.0
    trainer.vld = trainer.vld * half
    if isinstance(trainer, UNetTrainer):
        trainer.inv = trainer.inv * half
        trainer.denom = trainer.vld.sum(dim=(0, 2, 3)).clamp_min(1.0)
    else:
        trainer.rec_inv = trainer.rec_inv * half
        trainer.rec_denom = trainer.vld.sum(dim=(0, 2, 3)).clamp_min(1.0)


@contextlib.contextmanager
def half_batch():
    def init(orig):
        def wrapped(self, *args, **kwargs):
            orig(self, *args, **kwargs)
            _halve(self)
        return wrapped

    with _patched(UNetTrainer, "__init__", init), _patched(GANTrainer, "__init__", init):
        yield


@contextlib.contextmanager
def altered_answer():
    def unet(orig):
        return lambda self: tuple(x * 0.9 if i == 0 else x for i, x in enumerate(orig(self)))

    with _patched(UNetTrainer, "restore", unet), \
            _patched(GANTrainer, "restore", lambda orig: lambda self: orig(self) * 0.9):
        yield


FAULTS = {"unchanged": unchanged, "half_batch": half_batch, "altered_answer": altered_answer}


def main(argv=None) -> int:
    """Read each fault's numbers at the cell's own size: ``--workload``,
    ``--seeds``, ``--seconds`` (the window before the check)."""
    import argparse
    import json

    from benchmark import run as harness

    p = argparse.ArgumentParser(description="the check's numbers under each planted fault")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--faults", nargs="+", default=list(FAULTS))
    a = p.parse_args(argv)
    for fault in a.faults:
        for seed in a.seeds:
            with FAULTS[fault]():
                res = harness.run(a.workload, seed, a.seconds, False, "cuda")
            print(json.dumps({"workload": a.workload, "fault": fault, "seed": seed,
                              "correct": res["correct"], "checked": res["checked"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
