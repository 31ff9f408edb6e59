from .stft import (StftConfig, scipy_stft_config, torch_stft_config, stft,
                   istft, frame_signal, power_spectrogram, magphase, polar,
                   hann_window)
from .ar_scan import ar_extrapolate, ar_extrapolate_ref
from .bn_leaky import bn_leaky_train

__all__ = [
    "StftConfig",
    "scipy_stft_config",
    "torch_stft_config",
    "stft",
    "istft",
    "frame_signal",
    "power_spectrogram",
    "magphase",
    "polar",
    "hann_window",
    "ar_extrapolate",
    "ar_extrapolate_ref",
    "bn_leaky_train",
]
