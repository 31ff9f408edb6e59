"""Diffusion spectrogram inpainting (the reference's Riffusion role).

The port of audio_inpainting_tpu/methods/diffusion.py's native DDPM
engine. The reference pipes a log-spectrogram image through riffusion's
Stable Diffusion inpainting pipeline (main_diffusion_gap.py); this engine
keeps the reference's exact spectrogram <-> image codec and inpainting
contract:

- codec: power spectrogram (n_fft=2048, hop=512, power=2) -> log-dB
  ``20*log10(clamp(s, 1e-5)) - 20`` clamped at -100 -> min-max uint8 image,
  flipud (main_diffusion_gap.py:22-41); mask = pixels < 10; Griffin-Lim
  (power=1) back to audio. The image functions are host numpy, copied.
- engine: the DiffusionUNet (models/diffusion_unet.py), either trained per
  clip on random patches of the clip's own image (eager Adam steps) or
  loaded from a checkpoint such as the committed corpus prior
  (``PRIOR_DIR``), then DDIM (eta = 0) with RePaint composites over the
  masked region at full resolution.

With a local riffusion checkpoint (diffusers layout; the weights are not
in the repository), ``riffusion_restore_audio`` runs the reference's own
pipeline instead: the SD port in models/sd/ (UNet2DCondition + VAE + CLIP
text encoder + PLMS), 50 steps, strength 1.0, on a 512x512 canvas that
``resize_image`` makes as PIL's bicubic resize does, bit for bit. Its
glue is ``riffusion_analysis`` and ``riffusion_synthesis``, around the
sampler.

Random draws come from seeded CPU generators behind ``_draw_init``,
``_draw_train`` and ``_draw_sample``, so every device sees the same
numbers; the tests replace them with the JAX package's draws.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from ..corrupt import mask_to_bad_columns
from ..device import host_to_device, resolve_device, seeded_generator
from ..models.diffusion_unet import DiffusionUNet
from ..ops.griffin_lim import griffin_lim
from ..ops.stft import power_spectrogram
from ..utils.checkpoint import load_params, save_params
from ..utils.profiling import span
from .neural import _adam

# the 48-clip corpus prior, converted from the JAX package's Orbax
# checkpoint (its MANIFEST.json names the source and the command)
PRIOR_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "weights", "diffusion_prior")

# ------------------------------------------------------------- codec -------


def wav_to_logspec(x: torch.Tensor) -> torch.Tensor:
    """(n,) waveform -> log-dB spectrogram (1025, frames), on x's device;
    reference :22-27."""
    s = power_spectrogram(x, 2048, 512)
    ls = 20.0 * torch.log10(s.clamp_min(1e-5)) - 20.0
    return ls.clamp_min(-100.0)


def logspec_to_image(logspec: np.ndarray) -> tuple[np.ndarray, float, float]:
    """Min-max -> uint8, flipud. Returns (img (H, W) uint8, smin, smax)."""
    logspec = np.asarray(logspec)
    smin, smax = float(logspec.min()), float(logspec.max())
    data = (logspec - smin) / max(smax - smin, 1e-12)
    return np.flipud((data * 255.0).astype(np.uint8)), smin, smax


def image_to_linear_spec(img: np.ndarray, smin: float, smax: float) -> np.ndarray:
    """uint8 image -> linear magnitude spectrogram (reference :36-41)."""
    data = np.flipud(np.asarray(img, np.float32)).copy() / 255.0
    logspec = data * (smax - smin) + smin
    return np.power(10.0, (logspec + 20.0) / 20.0)


def mask_from_image(img: np.ndarray, threshold: int = 10) -> np.ndarray:
    """255 where the image is near-black (damaged), else 0 (reference :52-55)."""
    return np.where(np.asarray(img) < threshold, 255, 0).astype(np.uint8)


def _bicubic(x: np.ndarray) -> np.ndarray:
    """Pillow's bicubic filter (a = -0.5) with support 2."""
    a = -0.5
    x = np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                    np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


_PRECISION_BITS = 32 - 8 - 2


def _resample_taps(in_size: int, out_size: int) -> tuple[np.ndarray, np.ndarray]:
    """Pillow's precompute_coeffs + normalize_coeffs_8bpc for one axis:
    the input index of every tap (out_size, ksize), clamped into range,
    and its fixed-point weight (0 past the output's last tap)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    # C's (int) cast truncates toward zero
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64), in_size) - xmin
    tap = np.arange(ksize)
    w = _bicubic((tap[None, :] + xmin[:, None] - center[:, None] + 0.5) / filterscale)
    w = np.where(tap[None, :] < xmax[:, None], w, 0.0)
    ww = w.sum(axis=1, keepdims=True)
    w = np.where(ww != 0.0, w / np.where(ww != 0.0, ww, 1.0), w)
    fixed = w * (1 << _PRECISION_BITS)
    fixed = np.where(w < 0, np.trunc(fixed - 0.5), np.trunc(fixed + 0.5)).astype(np.int64)
    return np.minimum(xmin[:, None] + tap[None, :], in_size - 1), fixed


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One 8-bit pass of Pillow's separable resample along ``axis``: a
    fixed-point sum with rounding bias, clipped to uint8."""
    idx, fixed = _resample_taps(img.shape[axis], out_size)
    taps = np.take(img.astype(np.int64), idx, axis=axis)   # axis -> (out, ksize)
    shape = [1] * taps.ndim
    shape[axis], shape[axis + 1] = fixed.shape
    acc = (taps * fixed.reshape(shape)).sum(axis=axis + 1) + (1 << (_PRECISION_BITS - 1))
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_image(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """PIL's default (bicubic) resize of a uint8 (H, W) or (H, W, C) image
    to ``size`` = (width, height), as the reference resizes through PIL,
    bit for bit: Pillow's ImagingResample for 8-bit images, a horizontal
    pass then a vertical one, each skipped where its size is unchanged."""
    img = np.asarray(img, np.uint8)
    width, height = size
    if img.shape[1] != width:
        img = _resample_axis(img, width, 1)
    if img.shape[0] != height:
        img = _resample_axis(img, height, 0)
    return img


# ----------------------------------------------------- DDPM machinery ------

T = 1000
# corpus pretraining moves to the next image after this many steps (the
# JAX package's default steps per device program)
STEPS_PER_IMAGE = 250
_RUNS = {"clip": 0, "corpus": 1}


def _schedule() -> torch.Tensor:
    """Cumulative products of alpha, (T,) float32 on the CPU: betas
    linspace(1e-4, 0.02)."""
    betas = torch.linspace(1e-4, 0.02, T, dtype=torch.float32)
    return torch.cumprod(1.0 - betas, 0)


def _alpha_roots() -> tuple[torch.Tensor, torch.Tensor]:
    """sqrt(acp) and sqrt(1 - acp), float32 on the CPU."""
    acp = _schedule()
    return acp.sqrt(), (1.0 - acp).sqrt()


@dataclass(frozen=True)
class DiffusionConfig:
    """The JAX package's DiffusionConfig without ``scan_chunk``, its
    training steps per device program; here every step is eager."""

    train_steps: int = 1500
    batch: int = 8
    patch: int = 128
    lr: float = 2e-4
    sample_steps: int = 50   # DDIM steps (reference num_inference_steps=50)
    base_channels: int = 32
    # Fill-energy calibration: scale the Griffin-Lim'd gap fill so its power
    # is this fraction of the surrounding audio's. A hallucinated fill is
    # uncorrelated with the truth, so its local SNR is -10*log10(1 + a) at
    # energy ratio a; the JAX package's sweep with the corpus prior chose
    # 0.12 (LSD flat over 0.08-0.5, waveform SNR rising as the ratio
    # falls). None disables calibration.
    fill_energy_ratio: float | None = 0.12


def _draw_init(seed: int, run: str, base: int) -> dict[str, torch.Tensor]:
    """Initial DiffusionUNet weights (CPU state dict) of a per-clip
    (``run="clip"``) or corpus (``"corpus"``) training run."""
    return DiffusionUNet(base, generator=seeded_generator(seed, _RUNS[run], 0)).state_dict()


def _draw_train(seed: int, run: str, step: int, cfg: DiffusionConfig,
                shape: tuple[int, int]):
    """Training step ``step``'s draws, CPU tensors: patch origins ys, xs
    (B,) uniform in [0, H - P) and [0, W - P) (0 where the image is not
    larger than the patch), times t (B,) in [0, T), noise eps (B, 1, P, P)."""
    gen = seeded_generator(seed, _RUNS[run], 1, step)
    (h, w), p, b = shape, cfg.patch, cfg.batch
    return (torch.randint(0, max(h - p, 1), (b,), generator=gen),
            torch.randint(0, max(w - p, 1), (b,), generator=gen),
            torch.randint(0, T, (b,), generator=gen),
            torch.randn((b, 1, p, p), generator=gen))


def _draw_sample(seed: int, shape: tuple[int, ...], n_steps: int):
    """The sampler's draws, CPU tensors of ``shape``: the initial x, then
    the re-noising of the known region at each of the ``n_steps`` steps."""
    gen = seeded_generator(seed, 2)
    for _ in range(n_steps + 1):
        yield torch.randn(shape, generator=gen)


def new_model(state: dict[str, torch.Tensor], base: int, device) -> DiffusionUNet:
    """A DiffusionUNet of width ``base`` holding ``state`` on ``device``."""
    model = DiffusionUNet(base, generator=torch.Generator())
    model.load_state_dict(state)
    return model.to(device)


def train_steps(model: DiffusionUNet, opt: torch.optim.Optimizer,
                img: torch.Tensor, keep: torch.Tensor, cfg: DiffusionConfig,
                seed: int, run: str, steps: range) -> torch.Tensor:
    """Adam steps ``steps`` of DDPM training on random patches of one image.

    img: (H, W) in [-1, 1]; keep: (H, W), 1 = trustworthy pixel (the loss
    is masked so the model never learns the damaged hole as data). Patch
    indices past the image edge are clamped, as the JAX package's gather
    clamps them. Returns the losses (len(steps),) on img's device.
    """
    dev = img.device
    h, w = img.shape
    sqrt_a, sqrt_1ma = (r.to(dev) for r in _alpha_roots())
    span = torch.arange(cfg.patch, device=dev)
    losses = []
    for step in steps:
        # asynchronous copies: the host draws the next step while the card works
        ys, xs, t, eps = (host_to_device(a, dev)
                          for a in _draw_train(seed, run, step, cfg, (h, w)))
        rows = (ys[:, None] + span).clamp(max=h - 1)[:, :, None]
        cols = (xs[:, None] + span).clamp(max=w - 1)[:, None, :]
        x0, wgt = img[rows, cols][:, None], keep[rows, cols][:, None]
        xt = sqrt_a[t][:, None, None, None] * x0 + sqrt_1ma[t][:, None, None, None] * eps
        pred = model(xt, t.to(torch.float32))
        loss = (wgt * (pred - eps) ** 2).sum() / wgt.sum().clamp_min(1.0)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    return torch.stack(losses) if losses else torch.zeros(0, device=dev)


def _adam_for(model: DiffusionUNet, cfg: DiffusionConfig) -> torch.optim.Adam:
    # optax.adam(lr)'s defaults: b1 0.9, b2 0.999, eps 1e-8
    return _adam(model, cfg.lr, (0.9, 0.999), next(model.parameters()).device)


@torch.no_grad()
def ddim_repaint(model: DiffusionUNet, img: torch.Tensor, keep: torch.Tensor,
                 seed: int, cfg: DiffusionConfig) -> torch.Tensor:
    """DDIM (eta = 0) sampling with RePaint composites: at every step the
    known region is re-noised from the data and the hole comes from the
    model; x0 is clipped to [-1, 1]; a final composite keeps the known
    pixels verbatim. img, keep: (H, W) -> (H, W) in [-1, 1]."""
    dev = img.device
    sqrt_a, sqrt_1ma = (r.tolist() for r in _alpha_roots())
    n = cfg.sample_steps
    ts = [(n - i) * (T // n) - 1 for i in range(n)]          # T-1 .. ~0
    x0, keep4 = img[None, None], keep[None, None]
    hole = 1.0 - keep4
    draws = _draw_sample(seed, tuple(x0.shape), n)
    x = host_to_device(next(draws), dev)
    for i, t in enumerate(ts):
        noise = host_to_device(next(draws), dev)
        x = keep4 * (sqrt_a[t] * x0 + sqrt_1ma[t] * noise) + hole * x
        eps = model(x, torch.full((1,), float(t), device=dev))
        x0_pred = ((x - sqrt_1ma[t] * eps) / sqrt_a[t]).clamp(-1.0, 1.0)
        if i + 1 < n:
            x = sqrt_a[ts[i + 1]] * x0_pred + sqrt_1ma[ts[i + 1]] * eps
        else:                                   # to t = 0: a_next = 1
            x = x0_pred
    return (keep4 * x0 + hole * x)[0, 0]


def train_spectrogram_ddpm(images_u8, cfg: DiffusionConfig = DiffusionConfig(),
                           key: int = 0, checkpoint_dir: str | None = None,
                           masks_u8=None, device=None,
                           losses: list | None = None) -> dict[str, torch.Tensor]:
    """Pretrain the spectrogram DDPM on a corpus of log-spec images.

    images_u8: (H, W) uint8 spectrogram images, each at least cfg.patch in
    both axes (heights may differ); training moves to the next image every
    STEPS_PER_IMAGE steps. masks_u8 (optional, one per image, 255 =
    damaged) keeps damaged pixels out of the loss. Returns the trained
    state dict, on ``device`` (cuda by default), and writes it with
    ``save_params`` when ``checkpoint_dir`` is given. ``losses``, where
    given, receives each image's per-step losses (device tensors) as the
    steps are queued.
    """
    dev = resolve_device(device)
    model = new_model(_draw_init(key, "corpus", cfg.base_channels),
                      cfg.base_channels, dev)
    opt = _adam_for(model, cfg)
    imgs = [torch.tensor(np.ascontiguousarray(im), dtype=torch.float32, device=dev) / 127.5 - 1.0
            for im in images_u8]
    keeps = ([torch.ones_like(im) for im in imgs] if masks_u8 is None else
             [torch.tensor(np.asarray(m) == 0, dtype=torch.float32, device=dev)
              for m in masks_u8])
    done = i = 0
    while done < cfg.train_steps:
        n = min(STEPS_PER_IMAGE, cfg.train_steps - done)
        run = train_steps(model, opt, imgs[i % len(imgs)], keeps[i % len(imgs)], cfg, key,
                          "corpus", range(done, done + n))
        if losses is not None:
            losses.append(run)
        done += n
        i += 1
    state = model.state_dict()
    if checkpoint_dir:
        save_params(state, checkpoint_dir,
                    {"trainer": "audio_inpainting_torch.methods.diffusion."
                                "train_spectrogram_ddpm",
                     "images": len(imgs), "train_steps": cfg.train_steps,
                     "base_channels": cfg.base_channels, "key": key})
    return state


def diffusion_inpaint_image(img_u8: np.ndarray, mask_u8: np.ndarray,
                            cfg: DiffusionConfig = DiffusionConfig(),
                            key: int = 0, params=None, device=None) -> np.ndarray:
    """Inpaint the masked region of a uint8 grayscale spectrogram image.

    mask_u8: 255 = damaged. The image is padded to multiples of 4 with
    pixel 0 (-1) and keep 0. Trains the per-clip DDPM on the undamaged
    pixels unless ``params`` (a DiffusionUNet state dict) are given.
    Returns the uint8 image. Runs on ``device`` (cuda by default).
    """
    dev = resolve_device(device)
    h, w = img_u8.shape
    ph, pw = (-h) % 4, (-w) % 4
    img = torch.tensor(np.pad(img_u8, ((0, ph), (0, pw))), dtype=torch.float32,
                       device=dev) / 127.5 - 1.0
    keep = torch.tensor(np.pad(mask_u8 == 0, ((0, ph), (0, pw)), constant_values=False),
                        dtype=torch.float32, device=dev)
    if params is None:
        model = new_model(_draw_init(key, "clip", cfg.base_channels),
                          cfg.base_channels, dev)
        train_steps(model, _adam_for(model, cfg), img, keep, cfg, key, "clip",
                    range(cfg.train_steps))
    else:
        model = new_model(params, cfg.base_channels, dev)
    out = ddim_repaint(model, img, keep, key, cfg)
    out_u8 = np.rint(((out + 1.0) * 127.5).clamp(0, 255).cpu().numpy()).astype(np.uint8)
    return out_u8[:h, :w]


def diffusion_restore_audio(damaged: np.ndarray, sr: int,
                            cfg: DiffusionConfig = DiffusionConfig(),
                            key: int = 0, composite: bool = True,
                            checkpoint_dir: str | None = None,
                            params=None, sample_mask=None, device=None) -> np.ndarray:
    """The reference pipeline: wav -> log-spec image -> inpaint the masked
    (near-black) region -> linear spectrogram -> Griffin-Lim -> waveform.

    ``composite=True`` (default) crossfades the Griffin-Lim reconstruction
    into the original waveform so only the damaged span is replaced;
    ``composite=False`` returns the whole Griffin-Lim waveform, as the
    reference does (main_diffusion_gap.py:72-74).

    ``params`` (a DiffusionUNet state dict) or ``checkpoint_dir`` (a
    ``save_params`` directory, such as PRIOR_DIR) skips the per-clip
    training. ``sample_mask`` (optional per-sample bool array, True =
    valid): explicit damage spans override the image's near-black scan;
    the hole is the image columns the mask maps to
    (``corrupt.mask_to_bad_columns`` at hop 512). Runs on ``device`` (cuda
    by default); returns float32 numpy.
    """
    dev = resolve_device(device)
    damaged = np.asarray(damaged, np.float32)
    if params is None and checkpoint_dir is not None:
        params = load_params(checkpoint_dir, dev)
    logspec = wav_to_logspec(torch.tensor(damaged, device=dev)).cpu().numpy()
    img, smin, smax = logspec_to_image(logspec)
    if sample_mask is not None:
        mask = np.zeros_like(img)
        mask[:, mask_to_bad_columns(sample_mask, img.shape[1], 512, device=dev)] = 255
    else:
        mask = mask_from_image(img)
    inpainted = diffusion_inpaint_image(img, mask, cfg, key, params=params, device=dev)
    linear = image_to_linear_spec(inpainted, smin, smax)
    out = griffin_lim(linear, n_fft=2048, hop=512, n_iter=32, length=len(damaged),
                      power=1.0, seed=key, device=dev).cpu().numpy()
    if cfg.fill_energy_ratio is not None:
        out = _calibrate_fill_energy(damaged, out, mask, cfg.fill_energy_ratio)
    if not composite:
        return out
    return _composite_time_domain(damaged, out, mask)


@dataclass(frozen=True)
class RiffusionAnalysis:
    """What the Riffusion path derives from a damaged clip before SD
    (``riffusion_analysis``): the clip, its log-spectrogram image (H, W)
    uint8 with the image's dB range, the damage mask (255 = damaged), and
    both resized onto the square SD canvas, the image as RGB."""

    damaged: np.ndarray
    image: np.ndarray
    smin: float
    smax: float
    mask: np.ndarray
    canvas: np.ndarray
    canvas_mask: np.ndarray


def riffusion_analysis(damaged: np.ndarray, image_size: int = 512,
                       device=None) -> RiffusionAnalysis:
    """wav -> log-spec image and mask (the reference's codec, :22-55) ->
    RGB image_size^2 canvas and its mask (PIL's bicubic resize,
    :58-59). The spectrogram runs on ``device`` (cuda by default); the
    span ``riffusion.analysis`` holds it."""
    dev = resolve_device(device)
    with span("riffusion.analysis", image_size=image_size):
        damaged = np.asarray(damaged, np.float32)
        logspec = wav_to_logspec(torch.tensor(damaged, device=dev)).cpu().numpy()
        img, smin, smax = logspec_to_image(logspec)
        mask = mask_from_image(img)
        size = (image_size, image_size)
        return RiffusionAnalysis(damaged, img, smin, smax, mask,
                                 resize_image(np.repeat(img[:, :, None], 3, axis=2), size),
                                 resize_image(mask, size))


def riffusion_synthesis(a: RiffusionAnalysis, inpainted_rgb_u8: np.ndarray, key: int = 0,
                        composite: bool = True, fill_energy_ratio: float | None = 0.12,
                        device=None) -> np.ndarray:
    """The inpainted canvas back to audio: resized to the image's size,
    grey, the known region kept exact, the linear spectrogram through
    Griffin-Lim (32 iterations, phase seeded by ``key``, on ``device``),
    the fill's energy calibrated, and with
    ``composite`` only the damaged span replaced (see
    ``diffusion_restore_audio``). The span ``riffusion.synthesis`` holds
    it. Returns float32 numpy."""
    dev = resolve_device(device)
    with span("riffusion.synthesis"):
        damaged, img, mask = a.damaged, a.image, a.mask
        h, w = img.shape
        gray = np.asarray(resize_image(inpainted_rgb_u8, (w, h)), np.float32).mean(axis=2)
        inpainted = np.rint(np.clip(gray, 0, 255)).astype(np.uint8)
        # the known region is trustworthy in the source image; keep it exact
        inpainted = np.where(mask == 255, inpainted, img)
        linear = image_to_linear_spec(inpainted, a.smin, a.smax)
        out = griffin_lim(linear, n_fft=2048, hop=512, n_iter=32, length=len(damaged),
                          power=1.0, seed=key, device=dev).cpu().numpy()
        if fill_energy_ratio is not None:
            out = _calibrate_fill_energy(damaged, out, mask, fill_energy_ratio)
        if not composite:
            return out
        return _composite_time_domain(damaged, out, mask)


def riffusion_restore_audio(damaged: np.ndarray, sr: int,
                            checkpoint_root: str | None = None,
                            prompt: str | None = None, steps: int = 50,
                            key: int = 0, composite: bool = True,
                            fill_energy_ratio: float | None = 0.12,
                            bundle: dict | None = None, image_size: int = 512,
                            device=None) -> np.ndarray:
    """Reference-exact Riffusion inpainting from a LOCAL checkpoint.

    ``riffusion_analysis`` (wav -> log-spec image -> RGB image_size^2),
    the SD masked-latent inpaint (models/sd/pipeline.py; prompt, steps and
    strength as in main_diffusion_gap.py:58-67), ``riffusion_synthesis``
    (resize back -> Griffin-Lim), in turn. Raises FileNotFoundError when
    neither ``checkpoint_root`` nor ``bundle`` is given or the checkpoint
    is absent.

    bundle: a ``load_riffusion`` dict, loaded once and reused per clip; it
    runs where its modules are. A bundle may hold a precomputed prompt
    encoding under ``context`` ((2, 77, 768), [uncond; cond]) in place of
    its tokenizer and text encoder; ``prompt`` is then not read.
    image_size: the SD canvas (512 is the reference's resize,
    main_diffusion_gap.py:58-59; tests shrink it). The codec, the
    checkpoint load and Griffin-Lim run on ``device`` (cuda by default).
    Returns float32 numpy.
    """
    from ..models.sd import PROMPT, InpaintConfig, load_riffusion, riffusion_inpaint_image

    dev = resolve_device(device)
    if bundle is None:
        if checkpoint_root is None:
            raise FileNotFoundError(
                "riffusion_restore_audio needs checkpoint_root or bundle")
        bundle = load_riffusion(checkpoint_root, device=dev)
    a = riffusion_analysis(damaged, image_size, dev)
    out = riffusion_inpaint_image(bundle, a.canvas, a.canvas_mask, prompt or PROMPT,
                                  InpaintConfig(steps=steps), key=key)
    return riffusion_synthesis(a, out, key, composite, fill_energy_ratio, dev)


def _calibrate_fill_energy(damaged: np.ndarray, out: np.ndarray,
                           mask: np.ndarray, ratio: float) -> np.ndarray:
    """Scale ``out`` so the fill's power in the damaged span equals
    ``ratio`` x the surrounding audio's power (see DiffusionConfig)."""
    bad_cols = np.flatnonzero((mask == 255).mean(axis=0) > 0.95)
    if bad_cols.size == 0:
        return out
    gs = int(bad_cols.min()) * 512
    ge = min(len(out), (int(bad_cols.max()) + 1) * 512)
    span = ge - gs
    ctx = np.concatenate([damaged[max(0, gs - span):gs],
                          damaged[ge:ge + span]])
    e_ctx = float(np.mean(ctx ** 2)) if ctx.size else 0.0
    e_fill = float(np.mean(out[gs:ge] ** 2))
    # a np.float32 gain: a np.float64 one would upcast the waveform
    return out * np.float32(np.sqrt(ratio * e_ctx / max(e_fill, 1e-12)))


def _composite_time_domain(damaged: np.ndarray, out: np.ndarray,
                           mask: np.ndarray) -> np.ndarray:
    """Replace only fully-damaged image columns (hop=512 frames) in the
    waveform, with a 1024-sample crossfade at each boundary."""
    bad_cols = np.flatnonzero((mask == 255).mean(axis=0) > 0.95)
    if bad_cols.size == 0:
        return damaged
    weight = np.zeros(len(damaged), np.float32)
    for c in bad_cols:  # bad col spans samples [c*512-1024, c*512+1024) centered
        lo = max(0, c * 512 - 1024)
        hi = min(len(damaged), c * 512 + 1024)
        weight[lo:hi] = 1.0
    xfade = 1024
    kernel = np.ones(xfade, np.float32) / xfade
    weight = np.convolve(weight, kernel, mode="same")
    return np.asarray(damaged * (1.0 - weight) + out * weight, np.float32)
