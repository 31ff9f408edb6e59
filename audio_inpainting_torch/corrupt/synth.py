"""Procedural music-like clip synthesis, seeded.

A copy of ``audio_inpainting_tpu/corrupt/synth.py``: the same seed gives
the same clip, bit for bit. The port's tests and ``chip_smoke.py`` restore
these clips, since no recorded clip ships with the repository.

The generator draws per-clip STYLE, KEY and TEMPO: four instrumentation
modes (block chords, arpeggiated melody over a beat grid, percussion-led
rhythm, sustained drone) over a random major/minor key and a 70-150 BPM
grid.

Purely deterministic per (seed, style) (np.random.default_rng), host-side
numpy.
"""

from __future__ import annotations

import numpy as np

STYLES = ("chords", "arpeggio", "percussive", "drone")

_MAJOR = (0, 2, 4, 5, 7, 9, 11)
_MINOR = (0, 2, 3, 5, 7, 8, 10)


def _scale_freqs(rng: np.random.Generator) -> np.ndarray:
    """Note frequencies of a random key across ~2.5 octaves."""
    root = rng.uniform(70.0, 260.0)
    degrees = _MAJOR if rng.random() < 0.5 else _MINOR
    semis = [d + 12 * octave for octave in range(3) for d in degrees]
    return root * 2.0 ** (np.asarray(semis, np.float64) / 12.0)


def _tone(t: np.ndarray, f0: float, rng: np.random.Generator, sr: int,
          n_harm: int, vib_hz: float, vib_dev: float) -> np.ndarray:
    """One harmonic note with vibrato; caller applies the envelope."""
    vib = vib_dev * np.sin(2 * np.pi * vib_hz * t + rng.uniform(0, 2 * np.pi))
    phase = 2 * np.pi * np.cumsum(np.full_like(t, f0) + vib) / sr
    out = np.zeros_like(t)
    for h in range(1, n_harm + 1):
        out += rng.uniform(0.2, 1.0) / h * np.sin(h * phase
                                                  + rng.uniform(0, 2 * np.pi))
    return out


def _noise_bed(rng: np.random.Generator, n: int, lo: float,
               hi: float) -> np.ndarray:
    noise = rng.standard_normal(n)
    k = int(rng.integers(8, 64))
    noise = np.convolve(noise, np.ones(k) / k, mode="same")
    return rng.uniform(lo, hi) * noise / (np.abs(noise).max() + 1e-9)


def _transient(rng: np.random.Generator, dur: int, kind: str,
               sr: int) -> np.ndarray:
    """One percussive hit: 'kick' = decaying low sine thump, 'hat' =
    decaying noise burst."""
    env = np.exp(-np.arange(dur) / (dur / 5.0))
    if kind == "kick":
        f = rng.uniform(45.0, 90.0)
        sweep = f * (1.0 + 2.0 * env)          # pitch drop
        return env * np.sin(2 * np.pi * np.cumsum(sweep) / sr)
    return env * rng.standard_normal(dur)


def synth_music_clip(seed: int, sr: int = 44100, seconds: float = 10.0,
                     style: str | None = None) -> np.ndarray:
    """One music-like mono clip in [-1, 1], peak-normalized.

    style: one of STYLES, or None to draw it from the seed. Every other
    parameter (key, tempo, voicing, percussion density, noise bed) is
    drawn from the seed too.
    """
    rng = np.random.default_rng(seed)
    if style is None:
        style = STYLES[int(rng.integers(0, len(STYLES)))]
    n = int(seconds * sr)
    t = np.arange(n) / sr
    out = np.zeros(n, np.float64)
    freqs = _scale_freqs(rng)
    beat = int(sr * 60.0 / rng.uniform(70.0, 150.0))   # samples per beat

    if style == "chords":
        # 2-4 chord segments, each a 2-4 note voicing from the key
        n_seg = int(rng.integers(2, 5))
        bounds = np.linspace(0, n, n_seg + 1).astype(int)
        for s0, s1 in zip(bounds[:-1], bounds[1:]):
            seg_t = t[s0:s1]
            for f0 in rng.choice(freqs, size=int(rng.integers(2, 5)),
                                 replace=False):
                env = 0.5 + 0.5 * np.sin(
                    2 * np.pi * rng.uniform(0.1, 1.5) * seg_t
                    + rng.uniform(0, 2 * np.pi))
                out[s0:s1] += env * _tone(seg_t, f0, rng, sr,
                                          int(rng.integers(3, 8)),
                                          rng.uniform(3.0, 7.0),
                                          rng.uniform(0.0, 6.0))
    elif style == "arpeggio":
        # melody notes on an eighth/sixteenth-note grid
        step = beat // int(rng.integers(2, 5))
        dur = int(step * rng.uniform(0.8, 1.6))
        for p in range(0, n - dur, step):
            if rng.random() < 0.15:
                continue                              # rests
            f0 = float(rng.choice(freqs))
            seg_t = t[:dur]
            env = np.exp(-np.arange(dur) / (dur / rng.uniform(2.0, 5.0)))
            out[p:p + dur] += 0.8 * env * _tone(
                seg_t, f0, rng, sr, int(rng.integers(2, 6)),
                rng.uniform(3.0, 7.0), rng.uniform(0.0, 4.0))
        # soft sustained root under the melody
        out += 0.25 * _tone(t, float(freqs[0]), rng, sr, 3, 4.0, 1.0)
    elif style == "percussive":
        # beat-grid kicks + off-beat hats, sparse tonal stabs
        for b in range(0, n - beat, beat):
            if rng.random() < 0.9:
                dur = int(rng.integers(sr // 40, sr // 12))
                out[b:b + dur] += rng.uniform(0.5, 0.9) * _transient(
                    rng, dur, "kick", sr)
            h = b + beat // 2
            if h + sr // 50 < n and rng.random() < 0.7:
                dur = int(rng.integers(sr // 200, sr // 50))
                out[h:h + dur] += rng.uniform(0.15, 0.4) * _transient(
                    rng, dur, "hat", sr)
        for _ in range(int(rng.integers(3, 9))):      # tonal stabs
            p = int(rng.integers(0, n - beat))
            dur = int(beat * rng.uniform(0.3, 0.9))
            env = np.exp(-np.arange(dur) / (dur / 3.0))
            out[p:p + dur] += 0.4 * env * _tone(
                t[:dur], float(rng.choice(freqs)), rng, sr,
                int(rng.integers(2, 5)), 5.0, 2.0)
    else:                                             # drone
        for f0 in rng.choice(freqs[:7], size=int(rng.integers(1, 3)),
                             replace=False):
            detune = rng.uniform(0.5, 2.0)
            swell = 0.6 + 0.4 * np.sin(2 * np.pi * rng.uniform(0.03, 0.15) * t
                                       + rng.uniform(0, 2 * np.pi))
            out += swell * _tone(t, float(f0), rng, sr,
                                 int(rng.integers(4, 9)), 0.5, detune)

    out += _noise_bed(rng, n, 0.02, 0.10)
    if style != "percussive":                         # light percussion
        for _ in range(int(rng.integers(4, 16))):
            p = int(rng.integers(0, max(1, n - sr // 10)))
            dur = int(rng.integers(sr // 100, sr // 20))
            out[p:p + dur] += rng.uniform(0.1, 0.5) * _transient(
                rng, dur, "hat", sr)

    return (out / max(np.abs(out).max(), 1e-9)).astype(np.float32)
