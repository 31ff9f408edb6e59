"""The check of a configuration whose requests are restored by a denoising
loop (``"check": "denoising"``): Stable Diffusion v1 / Riffusion
masked-latent inpainting (``drivers/riffusion.py``). A step is one
evaluation of the loop (the UNet at batch 2 for both guidance branches,
the guidance, the PLMS step and the composite), its return the guided
noise estimate, and a clip's state the latents, the PLMS history
(``ets``, ``counter``, ``cur_sample``), the next evaluation's ``index``
and the ``weights_seed`` the run's weights and prompt encoding were drawn
from (``sd_inputs``).

The reference (``reference/sd.py``) derives each request's analysis,
canvas, clean latents, hole mask and draws again from its host inputs and
seed, with the weights drawn again from the seed, follows the first three
evaluations from its own start, takes the later evaluation from the given
state and reads out from the given state. The numbers, each the worst
over steps and requests, a gap being max |port - reference| over the
reference's largest magnitude:

- ``eps_gap``, ``latent_gap``: the guided estimate of evaluations 1-3, and
  the latents at the start and after evaluations 1-3;
- ``step_eps_gap``, ``step_latent_gap``: the same of the evaluation taken
  after the window from the port's state;
- ``readout_gap``: each readout, decoded and synthesised to audio.

The control is the reference one precision lower (TF32 for float32 with
TF32 off), or at ``prec``: "bf16" where there is no TF32, "fp64" to read
how far a sound float32 computation may stand from the reference. The
faults, each a context manager that patches the port while it is open:

- ``unchanged``: every evaluation leaves the latents as they were;
- ``unguided``: the guidance is dropped (scale 1: the conditional
  estimate alone);
- ``no_composite``: the region outside the hole is not snapped back;
- ``altered_answer``: each readout's audio comes out scaled by 0.9.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from ..check import Answer, Start, Step
from ..reference import sd as ref

NUMBERS = ("eps_gap", "latent_gap", "step_eps_gap", "step_latent_gap", "readout_gap")
CONTROL = {"float32": "tf32"}


def gap(a, b) -> float:
    """max |a - b| over max |b|."""
    a, b = (torch.as_tensor(x).double().cpu().reshape(-1) for x in (a, b))
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


class _Reference:
    """The reference's model, by weight seed, and each request's analysis
    and fixed loop inputs, by request, made once each."""

    def __init__(self, config: dict, device, prec: str = "fp32"):
        self.config, self.device, self.prec = config, torch.device(device), prec
        self.model, self.seed, self.requests = None, None, {}

    def of(self, req, weights_seed: int):
        if self.seed != weights_seed:
            self.model, self.seed, self.requests = None, weights_seed, {}
            self.model = ref.Model(self.config, weights_seed, self.device, self.prec)
        if req.index not in self.requests:
            a = ref.analyse(req.damaged[0], self.config, self.device)
            self.requests[req.index] = a, ref.prepare(self.model, a, req.seed)
        return self.requests[req.index]


def _as(state: dict, to) -> dict:
    """A loop state with its tensors moved or cast ``to`` a device or dtype."""
    move = (lambda t: None if t is None else t.to(to))
    return {**state, "latents": move(state["latents"]), "ets": [move(e) for e in state["ets"]],
            "cur_sample": move(state["cur_sample"])}


def compare(config: dict, traffic: dict, start: Start | None, steps: list[Step],
            answers: list[Answer], device) -> tuple[dict[str, float], dict[str, str]]:
    """The numbers of NUMBERS for what a run hands over, and where each
    read its worst."""
    out = dict.fromkeys(NUMBERS, 0.0)
    where = dict.fromkeys(NUMBERS, "")
    r = _Reference(config, device)

    def worst(name, value, at):
        if not np.isfinite(value):
            out[name], where[name] = float("nan"), at
        elif value > out[name] or not where[name]:
            out[name], where[name] = max(out[name], value), at

    if start is not None:
        (s0,), (s1,), (s3,) = start.s0, start.s1, start.s3
        _, fixed = r.of(start.req, s0["weights_seed"])
        st = fixed["start"]
        at = f"request {start.req.index}"
        worst("latent_gap", gap(s0["latents"], st["latents"]), f"{at}, at the start")
        for k in range(3):
            eps, st = ref.evaluate(r.model, fixed, st)
            worst("eps_gap", gap(start.losses[k][0], eps), f"{at}, evaluation {k + 1}")
            if k in (0, 2):
                got = (s1 if k == 0 else s3)["latents"]
                worst("latent_gap", gap(got, st["latents"]), f"{at}, after evaluation {k + 1}")
    for s in steps:
        (before,), (after,) = s.before, s.after
        _, fixed = r.of(s.req, before["weights_seed"])
        st = _as(before, r.device)
        if st["index"] >= len(fixed["table"]):    # the request's sample was done: a new one
            st = fixed["start"]
        eps, st = ref.evaluate(r.model, fixed, st)
        at = f"request {s.req.index}, evaluation {st['index']}"
        worst("step_eps_gap", gap(s.losses[0], eps), at)
        worst("step_latent_gap", gap(after["latents"], st["latents"]), at)
    for ans in answers:
        (state,) = ans.state
        a, _ = r.of(ans.req, state["weights_seed"])
        y = ref.synthesise(ref.decode(r.model, state["latents"].to(r.device)), a, config,
                           ans.req.seed, r.device)
        worst("readout_gap", gap(ans.audio[0], y),
              f"request {ans.req.index}, after evaluation {state['index']}")
    return out, where


def control(config: dict, traffic: dict, req, device, epochs: int = 3, prec: str | None = None):
    """What the control hands over in the port's place: the reference at
    ``prec`` (by default one precision below the configuration's) with
    the weights drawn from the request's seed, as a run draws them from
    its first request's (Start over three evaluations, a Step from the
    state after ``epochs``, an Answer from the state after it)."""
    r = _Reference(config, device, prec or CONTROL[config["dtype"]])
    a, fixed = r.of(req, req.seed)
    states, eps = [fixed["start"]], []
    for _ in range(epochs + 1):
        e, st = ref.evaluate(r.model, fixed, states[-1])
        states.append(st)
        eps.append(e.double().cpu().reshape(1, -1).numpy())
    seeded = [[{**_as(st, torch.float32), "weights_seed": req.seed}] for st in states]
    audio = ref.synthesise(ref.decode(r.model, states[-1]["latents"]), a, config, req.seed,
                           r.device)
    return (Start(req, eps[:3], seeded[0], seeded[1], seeded[3]),
            [Step(req, seeded[epochs], eps[epochs], seeded[epochs + 1])],
            [Answer(req, seeded[epochs + 1], audio[None])])


def _sampler():
    """The port's InpaintSampler and methods.diffusion, imported only when
    a fault is planted (importing the port turns on cuDNN's deterministic
    algorithms, which the control's reference would then run under too)."""
    from audio_inpainting_torch.methods import diffusion
    from audio_inpainting_torch.models.sd import InpaintSampler

    return InpaintSampler, diffusion


@contextlib.contextmanager
def _patched(owner, name, make):
    orig = getattr(owner, name)
    setattr(owner, name, make(orig))
    try:
        yield
    finally:
        setattr(owner, name, orig)


def _after_init(change):
    def make(orig):
        def init(self, *args, **kwargs):
            orig(self, *args, **kwargs)
            change(self)
        return init
    return make


@contextlib.contextmanager
def unchanged():
    def make(orig):
        def step(self):
            latents = self.latents
            eps = orig(self)
            self.latents = latents
            return eps
        return step

    with _patched(_sampler()[0], "step", make):
        yield


@contextlib.contextmanager
def unguided():
    def drop(s):
        s.cfg = dataclasses.replace(s.cfg, guidance_scale=1.0)

    with _patched(_sampler()[0], "__init__", _after_init(drop)):
        yield


@contextlib.contextmanager
def no_composite():
    def whole(s):
        s.hole_mask = torch.ones_like(s.hole_mask)

    with _patched(_sampler()[0], "__init__", _after_init(whole)):
        yield


@contextlib.contextmanager
def altered_answer():
    make = (lambda orig: lambda *args, **kwargs: orig(*args, **kwargs) * np.float32(0.9))
    with _patched(_sampler()[1], "riffusion_synthesis", make):
        yield


FAULTS = {"unchanged": unchanged, "unguided": unguided, "no_composite": no_composite,
          "altered_answer": altered_answer}
