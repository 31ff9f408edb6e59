"""The benchmark's input generators, frozen copies of the port's.

- ``synth_music_clip``: ``audio_inpainting_torch/corrupt/synth.py`` (the
  same seed gives the same clip, bit for bit), since no recorded clip
  ships with the repository.
- ``random_frame_mask`` and ``training_stripes``:
  ``audio_inpainting_torch/corrupt/masks.py`` (Part 1's SpecAugment-style
  frame dropouts, reference main5_UNet_mask.py:111-127, and the facade's
  and serve's self-supervised training stripes), on a CPU generator.
- ``center_gap_bounds``: Part 2's centred 2 s hole (reference
  generate_part2_data.py:36-41).

The copies are the yardstick: a change to the port's generators does not
change the benchmark's inputs. ``make_request`` turns a traffic mix and a
seed into the host inputs of one request: damaged (and, where the traffic
gives originals, clean) mono clips as a WAV on disk would hold them.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

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


def _stamp_intervals(starts: np.ndarray, ends: np.ndarray, n: int) -> np.ndarray:
    """bool[n], True over the union of the [start, end) intervals."""
    out = np.zeros(n, bool)
    for s, e in zip(starts, ends):
        out[s:e] = True
    return out


def random_frame_mask(generator: torch.Generator, n_freq: int, n_frames: int,
                      mask_ratio: float = 0.3, min_time_mask: int = 5,
                      max_time_mask: int = 30, min_segments: int = 0) -> np.ndarray:
    """SpecAugment-style full-band frame dropouts: float32 (n_freq,
    n_frames), 1 = keep. num_segments = max(min_segments, n_frames * ratio
    / max * 2), widths uniform in [min, max), starts uniform in [0,
    n_frames - width); the same draws from ``generator`` as the port's."""
    num = max(min_segments, int(n_frames * mask_ratio / max_time_mask * 2))
    lens = torch.randint(min_time_mask, max_time_mask, (num,), generator=generator)
    u = torch.rand(num, generator=generator, dtype=torch.float64)
    starts = (u * (n_frames - lens)).long().clamp_min(0)
    ends = (starts + lens).clamp_max(n_frames)
    keep = ~_stamp_intervals(starts.numpy(), ends.numpy(), n_frames)
    return np.repeat(keep.astype(np.float32)[None, :], n_freq, axis=0)


def training_stripes(generator: torch.Generator, n_frames: int, intact) -> np.ndarray:
    """The synthetic stripe keep-row (float32 (n_frames,), 1 = keep) hidden
    over a blindly damaged clip's intact columns: stripe widths clamped for
    short clips, at least one stripe, up to 8 draws until a stripe covers
    an intact column; under 4 frames the middle column alone."""
    if n_frames < 4:
        m = np.ones(n_frames, np.float32)
        m[n_frames // 2] = 0.0
        return m
    mt = min(30, max(2, n_frames // 2))
    mn = max(1, min(5, mt - 1))
    intact = np.asarray(intact, bool)
    for _ in range(8):
        m = random_frame_mask(generator, 1, n_frames, min_time_mask=mn,
                              max_time_mask=mt, min_segments=1)[0]
        if ((m == 0) & intact).any() or not intact.any():
            break
    return m


def center_gap_bounds(n_samples: int, sr: int, half_seconds: float = 1.0) -> tuple[int, int]:
    """Part 2's centred hole: [center - half, center + half)."""
    center = n_samples // 2
    half = int(half_seconds * sr)
    return center - half, center + half


def wav_chain(x: np.ndarray) -> np.ndarray:
    """``x`` as written to an int16 WAV (clipped to [-1, 1], x 32767,
    truncated) and read back peak-normalized, as the port's
    ``save_wav_int16`` and ``load_mono_normalized`` leave it."""
    q = (np.clip(np.asarray(x, np.float32), -1.0, 1.0) * 32767.0).astype(np.int16)
    y = q.astype(np.float32)
    peak = np.max(np.abs(y))
    return y / peak if peak > 0 else y


@dataclass
class Request:
    """One request's host inputs: ``damaged`` (G, n) float32 clips, the
    clean ``original`` (G, n) where the traffic gives it, and the ``seed``
    that the entry point is called with."""

    index: int
    damaged: np.ndarray
    original: np.ndarray | None
    seed: int
    sample_rate: int


def _frame_dropouts(clip: np.ndarray, damage: dict, gen: torch.Generator,
                    n_fft: int, hop: int) -> np.ndarray:
    """Part 1's corruption: the clip's STFT magnitude times a random frame
    mask, back through the iSTFT with the clip's phase."""
    from .reference.stft import istft, stft

    z = stft(torch.from_numpy(clip), n_fft, hop)
    keep = torch.from_numpy(random_frame_mask(
        gen, z.shape[0], z.shape[1], damage["mask_ratio"], damage["min_frames"],
        damage["max_frames"]))
    return istft(torch.polar(z.abs() * keep, z.angle()), n_fft, hop, len(clip)).numpy()


def make_request(traffic: dict, config: dict, seed: int, index: int) -> Request:
    """Request ``index`` of a run seeded ``seed``: ``clips_per_request``
    synthetic clips of ``clip_seconds`` at ``sample_rate``, each through
    the WAV chain, damaged as ``traffic["damage"]`` says and through the
    chain again; every draw from (seed, index)."""
    g = traffic["clips_per_request"]
    sr = traffic["sample_rate"]
    n = int(round(traffic["clip_seconds"] * sr))
    draws = np.random.SeedSequence([seed, index]).generate_state(2 * g + 1, np.uint32)
    damage = traffic["damage"]
    damaged, original = [], []
    for i in range(g):
        clean = wav_chain(synth_music_clip(int(draws[i]), sr, n / sr))[:n]
        if damage["kind"] == "frame_dropouts":
            gen = torch.Generator().manual_seed(int(draws[g + i]))
            hurt = _frame_dropouts(clean, damage, gen, config["stft"]["n_fft"],
                                   config["stft"]["hop"])
        elif damage["kind"] == "centre_hole":
            s, e = center_gap_bounds(n, sr, damage["half_seconds"])
            hurt = clean.copy()
            hurt[s:e] = 0.0
        else:
            raise ValueError(f"unknown damage kind {damage['kind']!r}")
        damaged.append(wav_chain(hurt))
        original.append(clean)
    return Request(index, np.stack(damaged), np.stack(original) if traffic["originals"] else None,
                   int(draws[2 * g] >> 1), sr)
