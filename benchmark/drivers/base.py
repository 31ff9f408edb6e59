"""What every driver shares: a request's job (``epoch``, ``finish``) and the
reading of its state for the correctness check.

A driver (``drivers/<kind>.py``, named by a configuration's ``driver``)
exports ``Driver``; ``Driver(config, traffic, device, span).start(req)``
analyses a ``gen.Request`` and builds its trainer or sampler, as the
entry point named by ``traffic["entry"]`` does, and returns a ``Job``.
The harness calls ``job.epoch()``, one step (a training epoch, or one
denoising evaluation), until ``traffic["epochs"]`` steps, then
``job.finish()`` (the readout and the synthesis back to audio). ``span``
wraps each stage (``analysis``, ``trainer_build``, ``readout``,
``synthesis``) in a profiler range when the run is traced.

``job.losses`` and ``job.states`` give what the configuration's check
(``checks/<kind>.py``) reads: a step's return on the host, and each
clip's state. The defaults here are the training kind's: losses, and
weights with Adam's state; a job of another kind gives its own.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch


class Job:
    def __init__(self, driver, req):
        self.driver = driver
        self.req = req
        self.clips = req.damaged.shape[0]
        self.trainer = None

    def epoch(self):
        """One step; returns what the port's step returns."""
        raise NotImplementedError

    def finish(self) -> np.ndarray:
        """The restored audio, (G, n) float32 on the host."""
        raise NotImplementedError

    def nets(self) -> dict:
        """{name prefix: (module, its Adam)} of the port's trainer."""
        raise NotImplementedError

    def ema(self) -> dict | None:
        """The port's weight EMA by parameter name, or None."""
        return None

    def losses(self, ret) -> np.ndarray:
        """``epoch()``'s return as (G, kinds) float64 on the host."""
        parts = ret if isinstance(ret, tuple) else (ret,)
        return np.stack([p.detach().double().cpu().reshape(-1).numpy() for p in parts], axis=1)

    def states(self, clone: bool = True) -> list[dict]:
        """The state of each clip that the check reads; here the training
        state in the reference's form (see reference/nets.py): the grouped
        tensors split by clip on their first axis, Adam's moments (zeros
        before the first step) and step count. ``clone``: copies, else
        views of the live tensors."""
        g = self.clips
        out = [{"params": {}, "buffers": {}, "m": {}, "v": {}, "step": 0, "ema": None}
               for _ in range(g)]

        def split(name, t, key):
            for i, part in enumerate(t.detach().chunk(g)):
                out[i][key][name] = part.clone() if clone else part

        for prefix, (model, opt) in self.nets().items():
            for name, p in model.named_parameters():
                st = opt.state.get(p, {})
                split(prefix + name, p, "params")
                split(prefix + name, st.get("exp_avg", torch.zeros_like(p)), "m")
                split(prefix + name, st.get("exp_avg_sq", torch.zeros_like(p)), "v")
                step = int(float(st["step"])) if "step" in st else 0
                for s in out:
                    s["step"] = step
            for name, b in model.named_buffers():
                split(prefix + name, b, "buffers")
        ema = self.ema()
        if ema is not None:
            for s in out:
                s["ema"] = {}
            for name, e in ema.items():
                split(name, e, "ema")
        return out


class Driver:
    Job = Job

    def __init__(self, config: dict, traffic: dict, device: torch.device, span=None):
        self.config = config
        self.traffic = traffic
        self.entry = traffic["entry"]
        self.device = device
        self.span = span or (lambda name: contextlib.nullcontext())

    def start(self, req):
        return self.Job(self, req)
