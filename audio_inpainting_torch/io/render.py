"""L4 artifact rendering: spectrogram PNGs in the reference's house style.

The reference renders every artifact with
``plt.specgram(audio, NFFT=1024, Fs=sr, noverlap=512, cmap='inferno')``,
axes off, tight layout (e.g. main1_gp.py:11-19). Those PNGs are part of the
demo's file contract. matplotlib draws them where it is installed. Where
it is not, a stdlib writer (``zlib`` + ``struct``) encodes the same
log-power spectrogram through an inferno colormap, so every artifact is
written either way. The U-Net's three-panel figure always goes through the
stdlib writer (its PDF twin needs matplotlib).
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np


def save_spectrogram_png(audio: np.ndarray, sr: int, path: str,
                         nfft: int = 1024, noverlap: int = 512) -> str:
    """Save the reference-style inferno spectrogram PNG for ``audio``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    audio = np.asarray(audio, dtype=np.float32)
    try:
        import matplotlib
    except ImportError:
        _write_png(path, _spectrogram_rgb(audio, nfft, noverlap))
        return path
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(10, 4))
    plt.specgram(audio, NFFT=nfft, Fs=sr, noverlap=noverlap, cmap="inferno")
    plt.axis("off")
    plt.tight_layout(pad=0)
    plt.savefig(path, bbox_inches="tight", pad_inches=0)
    plt.close(fig)
    return path


def save_image_png(array2d: np.ndarray, path: str, cmap: str = "inferno",
                   origin: str = "lower") -> str:
    """Save a 2-D array as a colormapped PNG (raw magnitude views), by the
    stdlib writer: min-max scaled through the inferno colormap, row 0 at
    the bottom with ``origin="lower"`` (imshow's), at the top with
    ``"upper"``. ValueError for any other colormap or origin."""
    if cmap != "inferno" or origin not in ("lower", "upper"):
        raise ValueError(f"save_image_png draws cmap 'inferno' with origin 'lower' or "
                         f"'upper', not {cmap!r} with {origin!r}")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    return _write_png(path, _inferno_image(np.asarray(array2d, np.float32), origin))


def _inferno_image(a: np.ndarray, origin: str = "lower") -> np.ndarray:
    """(H, W, 3) uint8: ``a`` min-max scaled through inferno, row 0 at the
    bottom for ``origin="lower"``."""
    rgb = _colormap_inferno(_minmax01(a))
    return rgb[::-1] if origin == "lower" else rgb


def unet_panels_viz(input_mag, pred_mag, target_mag, path: str) -> str:
    """The U-Net figure: input, prediction and ground truth magnitudes side
    by side (low frequencies at the bottom, each scaled to its own range,
    as ``imshow`` does), written as one PNG by the stdlib writer, and as a
    matplotlib PDF beside it where matplotlib exists."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    mags = [np.asarray(m, np.float32) for m in (input_mag, pred_mag, target_mag)]
    gap = np.full((mags[0].shape[0], 4, 3), 255, np.uint8)
    panels = [_inferno_image(m) for m in mags]
    _write_png(path, np.concatenate([panels[0], gap, panels[1], gap, panels[2]],
                                    axis=1))
    _panels_pdf(mags, os.path.splitext(path)[0] + ".pdf")
    return path


def _panels_pdf(mags, path: str) -> None:
    try:
        import matplotlib
    except ImportError:
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(15, 6))
    for i, (title, m) in enumerate(zip(
            ("Input (Randomly Masked)", "U-Net Prediction", "Ground Truth"), mags)):
        plt.subplot(1, 3, i + 1)
        plt.title(title)
        plt.imshow(m, aspect="auto", origin="lower", cmap="inferno")
        plt.axis("off")
    plt.tight_layout()
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)


def _minmax01(a: np.ndarray) -> np.ndarray:
    lo, hi = float(a.min()), float(a.max())
    return (a - lo) / (hi - lo) if hi > lo else np.zeros_like(a)


def _colormap_inferno(x01: np.ndarray) -> np.ndarray:
    # Coarse 8-anchor approximation of matplotlib's inferno, linearly blended.
    anchors = np.array(
        [(0, 0, 4), (40, 11, 84), (101, 21, 110), (159, 42, 99),
         (212, 72, 66), (245, 125, 21), (250, 193, 39), (252, 255, 164)],
        dtype=np.float32,
    )
    pos = np.clip(x01, 0.0, 1.0) * (len(anchors) - 1)
    i0 = np.floor(pos).astype(np.int32)
    i1 = np.minimum(i0 + 1, len(anchors) - 1)
    w = (pos - i0)[..., None]
    rgb = anchors[i0] * (1 - w) + anchors[i1] * w
    return rgb.astype(np.uint8)


def _spectrogram_rgb(audio: np.ndarray, nfft: int, noverlap: int) -> np.ndarray:
    """(n_bins, n_frames, 3) uint8 inferno image of the log-power
    spectrogram, low frequencies at the bottom."""
    hop = nfft - noverlap
    n_frames = max(1, 1 + (len(audio) - nfft) // hop)
    win = np.hanning(nfft).astype(np.float32)
    idx = np.arange(n_frames)[:, None] * hop + np.arange(nfft)[None, :]
    frames = audio[np.minimum(idx, len(audio) - 1)] * win
    spec = np.abs(np.fft.rfft(frames, axis=-1)) ** 2
    logspec = 10.0 * np.log10(np.maximum(spec.T, 1e-12))
    return _inferno_image(logspec)


def _write_png(path: str, rgb: np.ndarray) -> str:
    """Encode an (H, W, 3) uint8 image as an 8-bit RGB PNG."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    h, w, _ = rgb.shape
    # every scanline starts with filter byte 0 (None)
    rows = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)],
                          axis=1)

    def chunk(tag: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))

    png = (b"\x89PNG\r\n\x1a\n"
           + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
           + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
           + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)
    return path
