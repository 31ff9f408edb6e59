"""What each entry point derives from a request before it trains, and how
it turns a composite back into audio, written out again from the entry
points' documented behaviour.

- ``serve`` (``run_serve --method unet`` over a directory, one grouped
  net for the batch): blind damage from silent STFT columns (more than 90 % of the
  hop window under 1e-4), every spectrogram padded to the batch's frame
  count (a multiple of 32) and to F % 4, the pad kept. U-Net: each clip's magnitude over
  its peak; training on synthetic stripes over the intact columns
  (``training_stripes`` seeded with the clip's seed), the loss over the
  valid, intact cells, the composite over the real damage.
- ``facade`` (``restore(method="unet")``, one clip): columns whose hop
  window is over 80 % under 0.01 are damage; stripes seeded with the
  request's seed; the magnitude over its maximum.
- ``part2`` (Part 2's GAN leg, one clip): min-max [-1, 1] magnitudes of the
  damaged clip, the mask ``norm > keep_threshold``, trained against the
  clean clip's spectrogram in the damaged clip's range.

Every output is the iSTFT of the composite's magnitude with the damaged
clip's phase, at the clip's length.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..gen import training_stripes
from .stft import istft, stft


def clip_seed(seed: int, index: int) -> int:
    """Clip ``index``'s seed under a batch's ``seed``: the pair mixed by
    numpy's SeedSequence (the serving entry's per-clip seeds)."""
    state = np.random.SeedSequence([seed & (2**64 - 1), index]).generate_state(1, np.uint64)
    return int(state[0] >> 1)


def silent_columns(x: np.ndarray, n_frames: int, hop: int, threshold: float,
                   fraction: float) -> np.ndarray:
    """bool (n_frames,): the hop window around each frame centre (cut at
    the clip's ends) holds more than ``fraction`` samples under
    ``threshold``."""
    n = len(x)
    quiet = np.concatenate([[0], np.cumsum(np.abs(x) < threshold)])
    centres = np.arange(n_frames) * hop
    w0 = np.clip(centres - hop // 2, 0, n)
    w1 = np.minimum(centres + hop // 2, n)
    return (quiet[w1] - quiet[w0]) / np.maximum(w1 - w0, 1) > fraction


def _pad(a: torch.Tensor, value: float) -> torch.Tensor:
    """(F, T) to F % 4 and T % 32."""
    f, t = a.shape
    return F.pad(a, (0, (-t) % 32, 0, (-f) % 4), value=value)


def _grid(a) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float32)[None, None]


def _unet_inputs(tgt, msk, vld, cmsk, device, **synth) -> dict:
    x = {k: _grid(v).to(device) for k, v in
         (("tgt", tgt), ("msk", msk), ("vld", vld), ("cmsk", cmsk))}
    x["inp"] = x["tgt"] * x["msk"]
    x["inv"] = (1 - x["msk"]) * x["vld"]
    x["denom"] = x["vld"].sum().clamp_min(1.0)
    x.update(synth)
    return x


def _gan_inputs(inp, real, msk, vld, device, **synth) -> dict:
    x = {k: _grid(v).to(device) for k, v in
         (("inp", inp), ("real", real), ("msk", msk), ("vld", vld))}
    x["inv"] = 1 - x["msk"]
    x["rec_inv"] = x["inv"] * x["vld"]
    x["rec_denom"] = x["vld"].sum()
    x.update(synth)
    return x


def analyse(entry: str, driver: str, req, config: dict, device) -> list[dict]:
    """The per-clip training inputs of ``req`` (a ``gen.Request``) at
    ``entry``, on ``device``, each with what its synthesis needs and its
    init ``seed``."""
    n_fft, hop = config["stft"]["n_fft"], config["stft"]["hop"]
    spectra = [stft(torch.from_numpy(x).to(device), n_fft, hop) for x in req.damaged]
    n = req.damaged.shape[1]
    f, t = spectra[0].shape
    out = []
    if entry == "serve" and driver == "unet":
        tp = t + (-t) % 32
        fp = f + (-f) % 4
        for i, (x, z) in enumerate(zip(req.damaged, spectra)):
            bad = silent_columns(x, t, hop, 1e-4, 0.9)
            mag = np.zeros((fp, tp), np.float32)
            mag[:f, :t] = z.abs().cpu().numpy()
            keep = np.ones((fp, tp), np.float32)
            keep[:f, :t] = ~bad
            extent = np.zeros((fp, tp), np.float32)
            extent[:f, :t] = 1.0
            synth = {"phase": z.angle(), "n": n, "f": f, "t": t, "seed": clip_seed(req.seed, i)}
            peak = max(float(mag.max()), 1e-12)
            syn = np.ones(tp, np.float32)
            syn[:t] = training_stripes(torch.Generator().manual_seed(synth["seed"]), t,
                                       keep[0, :t] > 0)
            out.append(_unet_inputs(mag / peak, keep * syn[None], extent * keep, keep,
                                    device, scale=(peak, 0.0), **synth))
        return out
    (x,), (z,) = req.damaged, spectra
    mag = z.abs()
    synth = {"phase": z.angle(), "n": n, "f": f, "t": t, "seed": req.seed}
    extent = _pad(torch.ones(f, t, device=device), 0.0)
    if entry == "facade" and driver == "unet":
        bad = silent_columns(x, t, hop, 0.01, 0.8)
        keep = torch.as_tensor(~bad, dtype=torch.float32, device=device)[None].expand(f, t)
        syn = training_stripes(torch.Generator().manual_seed(req.seed), t, ~bad)
        peak = mag.max().clamp_min(1e-12)
        return [_unet_inputs(_pad(mag / peak, 0.0), _pad(keep * torch.as_tensor(syn, device=device), 1.0),
                             extent * _pad(keep, 0.0), _pad(keep, 1.0), device,
                             scale=(peak, 0.0), **synth)]
    if entry == "part2" and driver == "gan":
        lo, hi = mag.min(), mag.max()
        norm = (mag - lo) / (hi - lo) * 2 - 1
        keep = (norm > config["keep_threshold"]).to(torch.float32)
        real = (stft(torch.from_numpy(req.original[0]).to(device), n_fft, hop).abs() - lo) / (hi - lo) * 2 - 1
        return [_gan_inputs(_pad(norm, -1.0), _pad(real, -1.0), _pad(keep, 1.0), extent, device,
                            scale=((hi - lo) / 2, (hi + lo) / 2), **synth)]
    raise ValueError(f"no reference for entry {entry!r} with driver {driver!r}")


def synthesise(composite: torch.Tensor, x: dict, config: dict) -> np.ndarray:
    """The clip's audio from the composite of its padded grid: the
    magnitude scaled back (x scale + offset), cropped to the clip's (F, T),
    with the damaged clip's phase."""
    scale, offset = x["scale"]
    mag = composite[:x["f"], :x["t"]] * scale + offset
    z = torch.polar(mag.to(torch.float32), x["phase"])
    return istft(z, config["stft"]["n_fft"], config["stft"]["hop"], x["n"]).cpu().numpy()
