from .wav import (read_wav, write_wav, to_float_mono, peak_normalize,
                  load_mono_normalized, save_wav_int16)
from .render import save_spectrogram_png, unet_panels_viz

__all__ = [
    "unet_panels_viz",
    "read_wav",
    "write_wav",
    "to_float_mono",
    "peak_normalize",
    "load_mono_normalized",
    "save_wav_int16",
    "save_spectrogram_png",
]
