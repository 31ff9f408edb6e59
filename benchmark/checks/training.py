"""The check of a configuration whose requests are restored by per-clip
training (``"check": "training"``): a step is a training epoch, a state
is a clip's weights, BatchNorm statistics, Adam's moments and step count
(``drivers/base.py`` ``Job.states``), and a step's return is its losses.

The reference derives each request's inputs and each clip's initial
weights again from the host inputs and the seed, follows the first
three steps from its own start, takes the later step from the given state
and reads out from the given state. The numbers, each the worst over
clips and steps:

- ``loss_gap``: |loss - reference loss| / |reference loss| over the first
  three steps; ``step_loss_gap`` the same of the later step;
- ``grad_gap``: the first gradient as Adam holds it after step 1 (its
  first moment over 1 - beta1), per leaf: |norm - reference norm| / the
  larger of the reference's norm and its median leaf's, the worst leaf;
  ``grad_gap_median`` the median leaf's;
- ``change_gap``, ``change_gap_median``: the same of the parameters'
  change over the three steps, leaving out the still leaves: those whose
  first gradient in a float32 step of the reference is under a thousandth
  of the median leaf's (a conv bias in front of a BatchNorm, whose
  gradient is nought but for round-off, moves under Adam by round-off
  alone);
- ``step_gap``, ``step_gap_median``: the same of the later step's
  change, the same leaves left out;
- ``step_gap_mid``, ``step_gap_median_mid``: each clip's ``step_gap``
  and ``step_gap_median``, the median clip's in place of the worst (the
  lower middle one of an even number): one clip's later step can sit
  where fp32 rounding, on either side, moves it far more than the
  others' (see PERF.md);
- ``readout_gap``: max |audio - reference audio| / max |reference audio|.

The control is the reference at the precision below the configuration's
(TF32 for float32 with TF32 off, float8 e4m3 operands for bfloat16). The
faults, each a context manager that patches the port while it is open:

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
import statistics

import numpy as np
import torch

from ..check import Answer, Start, Step
from ..reference import entries, nets

NUMBERS = ("loss_gap", "step_loss_gap", "grad_gap", "grad_gap_median", "change_gap",
           "change_gap_median", "step_gap", "step_gap_median", "step_gap_mid",
           "step_gap_median_mid", "readout_gap")
# a leaf whose reference gradient is under this share of the median leaf's
# moves by round-off alone: out of the changes compared
STILL_LEAF = 1e-3


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.detach().double()))


def leaf_gaps(prog: dict, ref: dict, keep=None) -> tuple[tuple[float, str], float]:
    """Each leaf's |norm - reference norm| over the larger of the
    reference's norm and its median leaf's: (the worst and its leaf's name,
    the median); ``keep``: the leaves compared (all by default)."""
    ref_n = {k: _norm(v) for k, v in ref.items()}
    med = float(np.median(list(ref_n.values())))
    keys = ref_n if keep is None else keep
    gaps = [(abs(_norm(prog[k].to(ref[k].device)) - ref_n[k]) / max(ref_n[k], med, 1e-30), k)
            for k in keys]
    return max(gaps, default=(0.0, "")), float(np.median([g for g, _ in gaps] or [0.0]))


def moving(grads: dict) -> list[str]:
    """The leaves whose gradient norm is at least STILL_LEAF of the median
    leaf's."""
    n = {k: _norm(v) for k, v in grads.items()}
    med = float(np.median(list(n.values())))
    return [k for k, v in n.items() if v >= STILL_LEAF * med]


def moving_leaves(net, step, x: dict, device) -> list[str]:
    """``moving`` of the first gradient of a float32 step of the reference
    from its own start on the clip ``x``: which leaves the mathematics
    moves, whatever precision computes it."""
    return moving(step(net, net.init(x["seed"], device), x, "fp32")[1])


def _delta(a: dict, b: dict) -> dict:
    return {k: a["params"][k].to(b["params"][k].device) - b["params"][k] for k in b["params"]}


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def reference_fns(config: dict, traffic: dict):
    """(Net, its step, its readout) for the configuration's driver."""
    net = nets.Net(config)
    if config["driver"] == "unet":
        return net, nets.unet_step, nets.unet_readout
    return net, nets.gan_step, (lambda n, s, x, p: nets.gan_readout(n, s, x, p, traffic["epochs"]))


def _to(state: dict, device) -> dict:
    out = dict(state)
    for key in ("params", "buffers", "m", "v", "ema"):
        if state.get(key) is not None:
            out[key] = {k: v.to(device) for k, v in state[key].items()}
    return out


def compare(config: dict, traffic: dict, start: Start | None, steps: list[Step],
            answers: list[Answer], device) -> tuple[dict[str, float], dict[str, str]]:
    """The numbers of NUMBERS for what a run hands over, and where each
    read its worst; the reference computes in the configuration's
    precision."""
    net, step, readout = reference_fns(config, traffic)
    prec = nets.reference_precision(config)
    b1 = config["optimizer"]["betas"][0]
    out = dict.fromkeys(NUMBERS, 0.0)
    where = dict.fromkeys(NUMBERS, "")
    entry, driver = traffic["entry"], config["driver"]

    def worst(name, value, at):
        if isinstance(value, tuple):
            value, leaf = value
            at = f"{at}, {leaf}"
        value = float(value)
        if not np.isfinite(value):
            out[name], where[name] = float("nan"), at
        elif value > out[name] or not where[name]:
            out[name], where[name] = max(out[name], value), at

    keep = None
    if start is not None:
        for i, x in enumerate(entries.analyse(entry, driver, start.req, config, device)):
            keep = keep or moving_leaves(net, step, x, device)
            s0 = net.init(x["seed"], device)
            st, g1 = s0, None
            for k in range(3):
                losses, grads, st = step(net, st, x, prec)
                g1 = grads if g1 is None else g1
                for j, (a, b) in enumerate(zip(start.losses[k][i], losses)):
                    worst("loss_gap", _rel(a, b), f"request {start.req.index}, clip {i}, "
                          f"step {k + 1}, loss {j}: {float(a)!r} against {b!r}")
            at = f"request {start.req.index}, clip {i}"
            top, med = leaf_gaps({k: m / (1 - b1) for k, m in start.s1[i]["m"].items()}, g1)
            worst("grad_gap", top, at)
            worst("grad_gap_median", med, at)
            top, med = leaf_gaps(_delta(start.s3[i], start.s0[i]), _delta(st, s0), keep)
            worst("change_gap", top, at)
            worst("change_gap_median", med, at)
    for s in steps:
        tops, meds = [], []
        for i, x in enumerate(entries.analyse(entry, driver, s.req, config, device)):
            before = _to(s.before[i], device)
            keep = keep or moving_leaves(net, step, x, device)
            losses, _, after = step(net, before, x, prec)
            at = f"request {s.req.index}, clip {i}, step {before['step'] + 1}"
            for j, (a, b) in enumerate(zip(s.losses[i], losses)):
                worst("step_loss_gap", _rel(a, b), f"{at}, loss {j}: {float(a)!r} against {b!r}")
            top, med = leaf_gaps(_delta(_to(s.after[i], device), before), _delta(after, before),
                                 keep)
            worst("step_gap", top, at)
            worst("step_gap_median", med, at)
            tops.append(top[0])
            meds.append(med)
        at = f"request {s.req.index}, step {before['step'] + 1}, the median of {len(meds)} clips"
        worst("step_gap_mid", statistics.median_low(tops), at)
        worst("step_gap_median_mid", statistics.median_low(meds), at)
    for a in answers:
        for i, x in enumerate(entries.analyse(entry, driver, a.req, config, device)):
            y = entries.synthesise(readout(net, _to(a.state[i], device), x, prec), x, config)
            worst("readout_gap", float(np.max(np.abs(a.audio[i] - y)) / max(np.max(np.abs(y)), 1e-30)),
                  f"request {a.req.index}, clip {i}")
    return out, where


def control(config: dict, traffic: dict, req, device, epochs: int = 3):
    """What the control hands over in the port's place: the reference at
    the precision below the configuration's (Start over three steps, a
    Step from the state after ``epochs``, an Answer from the state after
    it)."""
    net, step, readout = reference_fns(config, traffic)
    low = nets.control_precision(config)
    xs = entries.analyse(traffic["entry"], config["driver"], req, config, device)
    losses, s0, s1, s3, before, after, mid, audio = ([] for _ in range(8))
    for x in xs:
        st = net.init(x["seed"], device)
        s0.append(st)
        clip = []
        for k in range(epochs):
            ls, _, st = step(net, st, x, low)
            clip.append(ls)
            if k == 0:
                s1.append(st)
            if k == 2:
                s3.append(st)
        losses.append(clip)
        before.append(st)
        ls, _, st = step(net, st, x, low)
        mid.append(ls)
        after.append(st)
        audio.append(entries.synthesise(readout(net, st, x, low), x, config))
    per_step = [np.array([clip[k] for clip in losses]) for k in range(3)]
    return (Start(req, per_step, s0, s1, s3), [Step(req, before, np.array(mid), after)],
            [Answer(req, after, np.stack(audio))])


def _trainers():
    """The port's (UNetTrainer, GANTrainer), imported only when a fault is
    planted: importing the port turns on cuDNN's deterministic algorithms
    (``audio_inpainting_torch/__init__.py``), which the control's reference
    would then run under too."""
    from audio_inpainting_torch.methods.neural import GANTrainer, UNetTrainer

    return UNetTrainer, GANTrainer


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
    if isinstance(trainer, _trainers()[0]):
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

    UNetTrainer, GANTrainer = _trainers()
    with _patched(UNetTrainer, "__init__", init), _patched(GANTrainer, "__init__", init):
        yield


@contextlib.contextmanager
def altered_answer():
    def unet(orig):
        return lambda self: tuple(x * 0.9 if i == 0 else x for i, x in enumerate(orig(self)))

    UNetTrainer, GANTrainer = _trainers()
    with _patched(UNetTrainer, "restore", unet), \
            _patched(GANTrainer, "restore", lambda orig: lambda self: orig(self) * 0.9):
        yield


FAULTS = {"unchanged": unchanged, "half_batch": half_batch, "altered_answer": altered_answer}
