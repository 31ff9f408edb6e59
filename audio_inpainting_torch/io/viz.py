"""Waveform diagnostic figures (L4), in the reference's style.

The port of audio_inpainting_tpu/io/viz.py's waveform figures:
- GP: ground truth + gap span + restoration + 95% confidence band
  (main1_gp.py:126-159)
- AR: ground truth + fwd/bwd prediction overlays + blended result
  (main2_AR.py:134-152), and the texture-injected variant
  (main3_AR_text.py:138-149)
- NMF: waveform overlay + restored-spectrogram pcolormesh subplot
  (main4_NMF.py:139-161)
(The U-Net's three-panel figure is io/render.py's ``unet_panels_viz``.)

They draw host numpy arrays with matplotlib (Agg), imported when a figure
is drawn; where matplotlib is not installed each function draws nothing
and returns None, as the JAX package's do.
"""

from __future__ import annotations

import os

import numpy as np


def _pyplot():
    """matplotlib.pyplot on the Agg backend, or None without matplotlib."""
    try:
        import matplotlib
    except ImportError:
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _save(plt, fig, path: str) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=300, bbox_inches="tight")
    plt.close(fig)
    return path


def gp_waveform_viz(t, signal, restored, sigma, gap: tuple[int, int],
                    path: str) -> str | None:
    plt = _pyplot()
    if plt is None:
        return None
    gs, ge = gap
    fig = plt.figure(figsize=(12, 6))
    plt.plot(t, signal, "gray", alpha=0.5, label="Ground Truth")
    plt.axvspan(t[gs], t[min(ge, len(t) - 1)], color="red", alpha=0.1,
                label="Missing Gap")
    gap_t = t[gs:ge]
    gap_r = restored[gs:ge]
    plt.plot(gap_t, gap_r, "r-", linewidth=2, label="GP Restoration")
    plt.fill_between(gap_t, gap_r - 1.96 * sigma, gap_r + 1.96 * sigma,
                     color="red", alpha=0.2, label="95% Confidence")
    plt.title("Audio Inpainting: Gaussian Process with Periodic Kernel")
    plt.xlabel("Time (s)")
    plt.ylabel("Amplitude")
    plt.legend(loc="upper right")
    return _save(plt, fig, path)


def ar_waveform_viz(t, signal, restored, pred_fwd, pred_bwd,
                    gap: tuple[int, int], path: str, order: int) -> str | None:
    plt = _pyplot()
    if plt is None:
        return None
    gs, ge = gap
    fig = plt.figure(figsize=(12, 6))
    plt.plot(t, signal, "gray", alpha=0.4, label="Ground Truth")
    plt.axvspan(t[gs], t[min(ge, len(t) - 1)], color="red", alpha=0.1)
    gap_t = t[gs:ge]
    plt.plot(gap_t, pred_fwd, "b--", alpha=0.5, linewidth=1, label="Forward Pred")
    plt.plot(gap_t, pred_bwd, "g--", alpha=0.5, linewidth=1, label="Backward Pred")
    plt.plot(gap_t, restored[gs:ge], "r-", linewidth=2.5,
             label="Bidirectional AR (Final)")
    plt.title(f"Voice Inpainting: Bidirectional AR (Order={order})")
    plt.legend()
    return _save(plt, fig, path)


def ar_texture_waveform_viz(t, signal, restored, gap: tuple[int, int],
                            path: str) -> str | None:
    """Ground truth in gray, the restored gap segment in red over a shaded
    gap span."""
    plt = _pyplot()
    if plt is None:
        return None
    gs, ge = gap
    fig = plt.figure(figsize=(12, 6))
    plt.plot(t, signal, "gray", alpha=0.3, label="Ground Truth")
    plt.plot(t[gs:ge], restored[gs:ge], "r-", linewidth=1,
             label="Restored (with Texture)")
    plt.axvspan(t[gs], t[min(ge, len(t) - 1)], color="red", alpha=0.1)
    plt.title("Final Result: Bidirectional AR + Noise Injection")
    plt.legend()
    return _save(plt, fig, path)


def nmf_waveform_viz(signal, restored, gap: tuple[int, int], sr: int,
                     restored_mag, path: str) -> str | None:
    plt = _pyplot()
    if plt is None:
        return None
    gs, ge = gap
    fig = plt.figure(figsize=(14, 8))
    plt.subplot(2, 1, 1)
    plt.plot(signal, "gray", alpha=0.5, label="Original")
    plt.plot(restored, "b--", alpha=0.8, linewidth=1, label="NMF Restored")
    plt.axvspan(gs, ge, color="red", alpha=0.1, label="Gap")
    plt.legend()
    plt.title("Time Domain: Waveform")
    plt.subplot(2, 1, 2)
    plt.pcolormesh(np.asarray(restored_mag), shading="gouraud", cmap="inferno")
    plt.title("Frequency Domain: Restored Spectrogram")
    plt.ylabel("Frequency bin")
    plt.xlabel("Frame")
    plt.tight_layout()
    return _save(plt, fig, path)
