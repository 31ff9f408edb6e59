"""Uniform restoration API: ``restore(damaged, sr, method) -> restored``.

    from audio_inpainting_torch import restore
    fixed = restore(damaged, sr, method="ar")                  # on the GPU
    fixed = restore(damaged, sr, method="ar", device="cpu")

The port's counterpart of audio_inpainting_tpu/api.py, with all of its
methods: linear, ar, nmf, gp, unet, gan and diffusion. Blind damage
detection (threshold scans) runs when ``gaps`` / ``mask`` are not
supplied. GP is only sensible on short segments (the reference restricts
it to 0.05 s windows).
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .utils.profiling import span

# The facade's AR posture: the reference's multi-gap texture setup
# (main3_AR_text_mask.py — order 30, Ridge alpha 0.5, 1000-sample contexts,
# progressive context reuse ~ passes=2).
AR_DEFAULTS = {"order": 30, "alpha": 0.5, "texture": True,
               "context_len": 1000, "passes": 2}


def restore(damaged, sr: int, method: str = "ar", *, gaps=None, mask=None,
            threshold: float = 1e-4, seed: int = 0, original=None,
            device=None, **cfg_kwargs) -> np.ndarray:
    """Restore a damaged mono float32 signal in [-1, 1]. Returns same length.

    gaps: optional [(start, end)] damaged spans; detected by threshold scan
    when omitted. mask: optional bool array (True = valid sample),
    alternative to gaps. original: the clean clip, used only by the gan
    method, which trains against it (main_gan_gap.py:103-108). device: where
    the work runs, cuda by default; RuntimeError when no GPU is present and
    none is named. Other keywords configure the method (ARConfig,
    NMFConfig, GPConfig, UNetTrainConfig, GANTrainConfig, DiffusionConfig);
    diffusion also takes ``checkpoint_dir``, trained weights that replace
    its per-clip training. The call is one ``api.restore`` span
    (utils/profiling.py) with its ``method``.
    Returns float32 numpy on the host.
    """
    with span("api.restore", method=method):
        from .corrupt import find_gaps, mask_to_bad_columns, silent_frame_columns
        from .ops import istft, magphase, polar, stft, torch_stft_config

        dev = resolve_device(device)
        damaged = np.asarray(damaged, np.float32)
        n = len(damaged)

        def _mask():
            if mask is not None:
                return np.asarray(mask, bool)
            if gaps is not None:
                # explicit damage spans beat the threshold scan: naturally quiet
                # passages stay untouched
                m = np.ones(n, bool)
                for s, e in gaps:
                    m[max(0, int(s)):min(n, int(e))] = False
                return m
            return np.abs(damaged) > threshold

        def _gaps():
            if gaps is not None:
                return [(int(s), int(e)) for s, e in gaps]
            return find_gaps(damaged, threshold=max(threshold, 0.01), min_len=100)

        if method == "linear":
            # host np.interp: a zero-FLOP O(n) fill gains nothing on the GPU
            from .methods.linear import linear_interp_masked_host

            return linear_interp_masked_host(damaged, _mask())

        if method == "ar":
            from .methods.ar import ARConfig, ar_restore_gaps

            cfg = ARConfig(**{**AR_DEFAULTS, **cfg_kwargs})
            out = ar_restore_gaps(torch.tensor(damaged, device=dev), _gaps(), cfg,
                                  seed)
            return out.cpu().numpy()

        if method == "gp":
            from .methods.gp import GPConfig, gp_restore

            out, _ = gp_restore(damaged, _mask(), sr, GPConfig(**cfg_kwargs),
                                seed, device=dev)
            return out

        if method == "diffusion":
            from .methods.diffusion import DiffusionConfig, diffusion_restore_audio

            # per-clip training unless a checkpoint (e.g. methods.diffusion.
            # PRIOR_DIR) is named; explicit damage spans override the codec's
            # near-black image scan
            ckpt = cfg_kwargs.pop("checkpoint_dir", None)
            sample_mask = _mask() if gaps is not None or mask is not None else None
            return diffusion_restore_audio(damaged, sr, DiffusionConfig(**cfg_kwargs),
                                           key=seed, checkpoint_dir=ckpt,
                                           sample_mask=sample_mask, device=dev)

        if method not in ("nmf", "unet", "gan"):
            raise ValueError(f"unknown method {method!r}")
        if method == "gan" and original is None:
            # without the clean clip the training target would be the damaged
            # spectrogram, i.e. the hole being filled (the reference trains
            # against the ground truth, main_gan_gap.py:103-108)
            raise ValueError(
                "restore(method='gan') requires original=<clean signal>: the "
                "GAN trains against the ground-truth clip's spectrogram")

        # the spectral methods
        scfg = torch_stft_config(1024, 256)
        mag, phase = magphase(stft(torch.tensor(damaged, device=dev), scfg))

        def _bad_columns(thr: float) -> np.ndarray:
            """Column damage indicator of the spectral methods. Explicit damage
            goes through the blind path's hop-window criterion (a column is bad
            when >= 80% of its window is damaged); blind otherwise (reference
            main4_NMF_gap.py:28-40)."""
            n_cols = mag.shape[1]
            if gaps is not None or mask is not None:
                return mask_to_bad_columns(_mask(), n_cols, 256, device=dev)
            bad = np.zeros(n_cols, bool)
            bad[silent_frame_columns(damaged, n_cols, 256, threshold=thr,
                                     silent_fraction=0.8, device=dev)] = True
            return bad

        def _keep_columns(bad: np.ndarray) -> torch.Tensor:
            return torch.as_tensor(~bad, dtype=torch.float32,
                                   device=dev)[None, :].expand(mag.shape)

        if method == "nmf":
            from .methods.nmf import NMFConfig, nmf_inpaint_columns

            out_mag = nmf_inpaint_columns(
                mag, torch.as_tensor(_bad_columns(threshold), device=dev),
                NMFConfig(**cfg_kwargs), seed)
            return istft(polar(out_mag, phase), scfg, n).cpu().numpy()

        if method == "unet":
            from .corrupt import training_stripes
            from .methods.neural import UNetTrainConfig, unet_train_restore

            # an all-silent input has max 0: a zero spectrogram, not 0/0
            mag_max = mag.max().clamp_min(1e-12)
            bad = _bad_columns(max(threshold, 0.01))
            keep = _keep_columns(bad)
            # Self-supervised on blind damage: train on synthetic stripes hidden
            # over the intact columns and keep the real holes out of the loss
            # (their targets are the damaged, silent columns, which would teach
            # the net to fill holes with silence); composite over the real damage
            syn = training_stripes(torch.Generator().manual_seed(seed),
                                   mag.shape[1], ~bad)
            train_mask = keep * torch.as_tensor(syn, device=dev)[None, :]
            final, _, _ = unet_train_restore(mag / mag_max, train_mask,
                                             UNetTrainConfig(**cfg_kwargs), seed,
                                             valid=keep, composite_mask=keep)
            return istft(polar(final * mag_max, phase), scfg, n).cpu().numpy()

        # method == "gan"
        from .methods.neural import GANTrainConfig, gan_train_restore

        mag_min, mag_max = mag.min(), mag.max()
        scale = (mag_max - mag_min).clamp_min(1e-12)   # constant input: no NaN
        norm = (mag - mag_min) / scale * 2.0 - 1.0
        if gaps is not None or mask is not None:
            # explicit damage spans beat the pixel-brightness scan
            keep = _keep_columns(_bad_columns(threshold))
        else:
            keep = (norm > -0.95).to(torch.float32)
        clean = torch.tensor(np.asarray(original, np.float32)[:n], device=dev)
        real = (magphase(stft(clean, scfg))[0] - mag_min) / scale * 2.0 - 1.0
        final, _, _ = gan_train_restore(norm, real, keep,
                                        GANTrainConfig(**cfg_kwargs), seed)
        final_mag = (final + 1.0) / 2.0 * (mag_max - mag_min) + mag_min
        return istft(polar(final_mag, phase), scfg, n).cpu().numpy()
