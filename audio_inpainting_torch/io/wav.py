"""L0 audio I/O: RIFF/WAV codec + the reference's normalization conventions.

A copy of ``audio_inpainting_tpu/io/wav.py`` without its optional native
codec: pure numpy, byte-for-byte the same files. Behavioral contract
mirrors the duplicated helpers in the reference scripts:

- load: ``wavfile.read`` -> mono mix -> peak-normalize to [-1, 1]
  (reference main1_gp.py:40-44, main2_AR.py:41-43, main4_NMF_gap.py:21-25)
- save: clip to [-1, 1], scale by 32767, int16
  (reference main1_gp.py:21-24, main3_AR_text_gap.py:125-128)

The int16 quantize -> renormalize-on-reload round-trip is load-bearing: the
reference chains methods through WAV files on disk, so parity SNRs depend
on replicating this quantization in the data flow.
"""

from __future__ import annotations

import os
import struct

import numpy as np

_WAVE_FORMAT_PCM = 0x0001
_WAVE_FORMAT_IEEE_FLOAT = 0x0003
_WAVE_FORMAT_EXTENSIBLE = 0xFFFE


def read_wav(path: str) -> tuple[int, np.ndarray]:
    """Read a WAV file. Returns (sample_rate, data).

    Data keeps its on-disk dtype (int16/int32/float32) and channel layout
    (n_frames,) mono or (n_frames, n_channels), matching scipy.io.wavfile.
    """
    with open(path, "rb") as f:
        raw = f.read()
    if len(raw) < 12 or raw[0:4] != b"RIFF" or raw[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")

    pos = 12
    fmt = None
    data = None
    while pos + 8 <= len(raw):
        chunk_id = raw[pos : pos + 4]
        (chunk_size,) = struct.unpack_from("<I", raw, pos + 4)
        body = raw[pos + 8 : pos + 8 + chunk_size]
        if chunk_id == b"fmt " and len(body) >= 16:
            # length-check against the TRUNCATED body (not the declared
            # chunk_size) so a cut-short file raises ValueError below, not
            # struct.error here
            (audio_format, n_channels, sample_rate, _byte_rate, block_align,
             bits_per_sample) = struct.unpack_from("<HHIIHH", body, 0)
            if audio_format == _WAVE_FORMAT_EXTENSIBLE and len(body) >= 26:
                # True format lives in the first 2 bytes of the SubFormat GUID.
                (audio_format,) = struct.unpack_from("<H", body, 24)
            fmt = (audio_format, n_channels, sample_rate, block_align, bits_per_sample)
        elif chunk_id == b"data":
            data = body
        pos += 8 + chunk_size + (chunk_size & 1)  # chunks are word-aligned

    if fmt is None or data is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    audio_format, n_channels, sample_rate, _block_align, bits = fmt

    if audio_format == _WAVE_FORMAT_PCM and bits == 24:
        # scipy.io.wavfile semantics: 24-bit samples land in the HIGH three
        # bytes of an int32 (value << 8), so downstream normalization code
        # sees the int32 full-scale range.
        b = np.frombuffer(data, dtype=np.uint8)
        b = b[: (len(b) // 3) * 3].reshape(-1, 3)
        arr = np.zeros(len(b), dtype=np.int32)
        arr.view(np.uint8).reshape(-1, 4)[:, 1:] = b  # little-endian
        if n_channels > 1:
            arr = arr[: (len(arr) // n_channels) * n_channels]
            arr = arr.reshape(-1, n_channels)
        return sample_rate, arr

    if audio_format == _WAVE_FORMAT_PCM:
        dtype = {8: np.uint8, 16: np.int16, 32: np.int32}.get(bits)
        if dtype is None:
            raise ValueError(f"{path}: unsupported PCM bit depth {bits}")
    elif audio_format == _WAVE_FORMAT_IEEE_FLOAT:
        dtype = {32: np.float32, 64: np.float64}.get(bits)
        if dtype is None:
            raise ValueError(f"{path}: unsupported float bit depth {bits}")
    else:
        raise ValueError(f"{path}: unsupported WAV format 0x{audio_format:04x}")

    arr = np.frombuffer(data, dtype=dtype)
    if n_channels > 1:
        arr = arr[: (len(arr) // n_channels) * n_channels]
        arr = arr.reshape(-1, n_channels)
    return sample_rate, arr


def write_wav(path: str, sample_rate: int, data: np.ndarray) -> None:
    """Write a WAV file (int16/int32/float32), matching scipy.io.wavfile.write."""
    data = np.asarray(data)
    if data.dtype == np.float64:
        data = data.astype(np.float32)
    if data.dtype not in (np.int16, np.int32, np.float32, np.uint8):
        raise ValueError(f"unsupported dtype {data.dtype}")
    n_channels = 1 if data.ndim == 1 else data.shape[1]
    bits = data.dtype.itemsize * 8
    audio_format = _WAVE_FORMAT_IEEE_FLOAT if data.dtype == np.float32 else _WAVE_FORMAT_PCM
    body = data.tobytes()
    byte_rate = sample_rate * n_channels * (bits // 8)
    block_align = n_channels * (bits // 8)
    with open(path, "wb") as f:
        f.write(b"RIFF")
        f.write(struct.pack("<I", 36 + len(body)))
        f.write(b"WAVE")
        f.write(b"fmt ")
        f.write(struct.pack("<IHHIIHH", 16, audio_format, n_channels,
                            sample_rate, byte_rate, block_align, bits))
        f.write(b"data")
        f.write(struct.pack("<I", len(body)))
        f.write(body)
        if len(body) & 1:
            f.write(b"\x00")


def to_float_mono(data: np.ndarray) -> np.ndarray:
    """Mono-mix (channel mean) and cast to float32 without normalizing."""
    data = np.asarray(data)
    if data.ndim > 1:
        data = data.mean(axis=1)
    return data.astype(np.float32)


def peak_normalize(x: np.ndarray) -> np.ndarray:
    """Divide by max |x| (no-op on all-zero input), the reference's convention."""
    x = np.asarray(x, dtype=np.float32)
    peak = np.max(np.abs(x))
    if peak > 0:
        x = x / peak
    return x


def load_mono_normalized(path: str) -> tuple[int, np.ndarray]:
    """The reference's canonical load: read -> mono mix -> peak-normalize.

    Mirrors main2_AR.py:41-43 / main3_AR_text_gap.py:26-31 exactly
    (mean over channels first, then divide by the post-mix peak).
    """
    sr, data = read_wav(path)
    return sr, peak_normalize(to_float_mono(data))


def save_wav_int16(audio: np.ndarray, sr: int, path: str, clip: float = 1.0) -> str:
    """The reference's canonical save: clip to [-clip, clip], x32767, int16.

    ``clip`` is 1.0 everywhere except the U-Net scripts, which clip to 0.99
    (reference main5_UNet_mask.py:231, 237).
    """
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    audio = np.clip(np.asarray(audio, dtype=np.float32), -clip, clip)
    write_wav(path, sr, (audio * 32767.0).astype(np.int16))
    return path
