"""PNDM (PLMS) and DDIM schedulers in the SD v1 configuration.

The port of audio_inpainting_tpu/models/sd/scheduler.py. The reference's
``StableDiffusionInpaintPipeline('riffusion/riffusion-model-v1')``
(main_diffusion_gap.py:16-19) runs the checkpoint's PNDM scheduler: 1000
train steps, scaled-linear betas in [0.00085, 0.012], steps_offset=1,
skip_prk_steps=True (pure PLMS multistep). The JAX package keeps the
scheduler state in a pytree and branches with ``jnp.where`` so that its
loop compiles into one program; here the denoise loop is a Python loop,
so ``plms_step`` branches on the host-side counter and the state is a
plain object.

Every coefficient is computed in float32 from the float32 table, as the
JAX package computes it, and applied as a Python number.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch


@dataclass(frozen=True)
class SchedulerConfig:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    steps_offset: int = 1
    # SD v1: set_alpha_to_one=False -> final alpha_cumprod is acp[0]
    set_alpha_to_one: bool = False


def alphas_cumprod(cfg: SchedulerConfig = SchedulerConfig()) -> torch.Tensor:
    """Scaled-linear beta schedule -> cumulative alpha products, (T,)
    float32 on the CPU."""
    betas = np.linspace(cfg.beta_start ** 0.5, cfg.beta_end ** 0.5,
                        cfg.num_train_timesteps, dtype=np.float64) ** 2
    return torch.tensor(np.cumprod(1.0 - betas), dtype=torch.float32)


def plms_timesteps(num_inference_steps: int,
                   cfg: SchedulerConfig = SchedulerConfig()) -> np.ndarray:
    """The PLMS evaluation timetable (the model is called len(result) times).

    Mirrors diffusers PNDMScheduler.set_timesteps with skip_prk_steps=True:
    base grid arange(n)*ratio + offset, with the second-to-last entry
    duplicated (the counter==1 re-evaluation) and reversed to descending.
    """
    ratio = cfg.num_train_timesteps // num_inference_steps
    base = (np.arange(0, num_inference_steps) * ratio).round().astype(
        np.int64) + cfg.steps_offset
    seq = np.concatenate([base[:-1], base[-2:-1], base[-1:]])[::-1]
    return seq.copy()


@dataclass
class PLMSState:
    ets: list = field(default_factory=list)   # the last <= 4 eps predictions
    counter: int = 0                          # step counter (diffusers semantics)
    cur_sample: torch.Tensor | None = None    # stashed for the counter==1 correction


def plms_init() -> PLMSState:
    return PLMSState()


def _f32(x: torch.Tensor) -> float:
    return float(x.to(torch.float32))


def _acp_at(acp: torch.Tensor, t: int, cfg: SchedulerConfig) -> torch.Tensor:
    """acp[t], or the final value for t < 0 (1 with set_alpha_to_one,
    else acp[0])."""
    if t >= 0:
        return acp[t]
    return torch.tensor(1.0) if cfg.set_alpha_to_one else acp[0]


def _prev_sample(sample, t: int, t_prev: int, eps, acp, cfg: SchedulerConfig):
    a_t = acp[t]
    a_prev = _acp_at(acp, t_prev, cfg)
    b_t = 1.0 - a_t
    b_prev = 1.0 - a_prev
    sample_coeff = torch.sqrt(a_prev / a_t)
    denom = a_t * torch.sqrt(b_prev) + torch.sqrt(a_t * b_t * a_prev)
    return _f32(sample_coeff) * sample - _f32(a_prev - a_t) * eps / _f32(denom)


def plms_step(state: PLMSState, sample, eps, t: int, num_inference_steps: int,
              acp, cfg: SchedulerConfig = SchedulerConfig()):
    """One PLMS update. Returns (state, prev_sample); ``state`` is updated
    in place.

    ``t`` is the entry of plms_timesteps for this call. The second call
    (counter 1) is the correction: it re-evaluates at t + ratio from the
    sample stashed by the first, and its eps joins no history.
    """
    ratio = cfg.num_train_timesteps // num_inference_steps
    counter = state.counter
    is_second = counter == 1
    t_prev = t if is_second else t - ratio
    t_eval = t + ratio if is_second else t
    if not is_second:
        state.ets = (state.ets + [eps])[-4:]
    e = state.ets[::-1]                        # newest first
    if len(e) == 1 and counter == 0:
        eps_prime = e[0]
    elif len(e) == 1 and is_second:
        eps_prime = (eps + e[0]) / 2.0
    elif len(e) == 2:
        eps_prime = (3.0 * e[0] - e[1]) / 2.0
    elif len(e) == 3:
        eps_prime = (23.0 * e[0] - 16.0 * e[1] + 5.0 * e[2]) / 12.0
    else:
        eps_prime = (55.0 * e[0] - 59.0 * e[1] + 37.0 * e[2] - 9.0 * e[3]) / 24.0
    use_sample = state.cur_sample if is_second else sample
    if counter == 0:
        state.cur_sample = sample
    state.counter = counter + 1
    return state, _prev_sample(use_sample, t_eval, t_prev, eps_prime, acp, cfg)


def ddim_timesteps(num_inference_steps: int,
                   cfg: SchedulerConfig = SchedulerConfig()) -> np.ndarray:
    ratio = cfg.num_train_timesteps // num_inference_steps
    return ((np.arange(0, num_inference_steps) * ratio).round().astype(
        np.int64) + cfg.steps_offset)[::-1].copy()


def ddim_step(sample, eps, t: int, num_inference_steps: int, acp,
              cfg: SchedulerConfig = SchedulerConfig()):
    """Deterministic DDIM (eta=0) update, diffusers convention."""
    ratio = cfg.num_train_timesteps // num_inference_steps
    a_t = acp[t]
    a_prev = _acp_at(acp, t - ratio, cfg)
    x0 = (sample - _f32(torch.sqrt(1.0 - a_t)) * eps) / _f32(torch.sqrt(a_t))
    return _f32(torch.sqrt(a_prev)) * x0 + _f32(torch.sqrt(1.0 - a_prev)) * eps


def add_noise(original, noise, t: int, acp):
    a = acp[t]
    return _f32(torch.sqrt(a)) * original + _f32(torch.sqrt(1.0 - a)) * noise
