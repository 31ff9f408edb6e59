"""audio_inpainting_torch — the PyTorch/CUDA port of audio_inpainting_tpu.

It grows slice by slice beside the JAX package, which stays the reference.
It imports torch and numpy and nothing of JAX. Layering, as in the JAX
package:
  io/        L0  WAV read/write, normalization, PNG rendering, the
                 waveform figures (matplotlib, where installed)
  ops/       L1  STFT/iSTFT (torch.stft), the AR recurrence kernel wrapper,
                 the train-mode BatchNorm + LeakyReLU kernels' wrapper
  corrupt/   L2  mask generators + blind damage detectors
  models/    L3  the spectrogram U-Net, GAN generator and discriminator,
                 the diffusion U-Net; models/sd/ Stable Diffusion v1 /
                 Riffusion (UNet2DCondition, AutoencoderKL, PLMS, the
                 masked-latent inpaint, the checkpoint loader)
  methods/   L3  linear, AR, masked NMF, OLA gain equalization, GP, and the
                 per-clip U-Net and GAN training loops; the uniform
                 ``restore`` API; the windowed and streaming engines over it;
                 Riffusion restore from a local checkpoint
  metrics/   L4  SNR / local SNR / LSD
  parallel/  L5  batched per-clip training: G clips' U-Nets or GANs as
                 one grouped net
  pipelines/ L6  Part 0 / 1 / 2 scenario pipelines, the demo_assets
                 contract, corpus serving
  demo/          the artifact gallery and the live HTTP restore API
  cli/           the ``restore`` (``--window-s``), ``stream``, ``serve``,
                 ``score``, ``part0``/``part1``/``part2``/``all``,
                 ``unet-gap``, ``check`` and ``demo`` commands
  csrc/          CUDA C++ kernels for Hopper (sm_90a); kernels/ builds them

Entry points run on the GPU unless called with device="cpu".

Float32 matrix products run in full fp32: TF32 is turned off here, once,
for cuBLAS and cuDNN, matching the JAX package's Precision.HIGH on the
Ridge fit, the STFT, the NMF updates and the GP Cholesky. The neural
methods' fp32 convolutions follow it; their pipelines run the convs in
bf16.

cuDNN runs its deterministic algorithms, also set here once: with its
free choice a seeded training run on the GPU parts from its own rerun
(the backward of the convolutions sums in an order that varies from run
to run), and the persistent stream U-Net would then give other bytes
under another chunking. The JAX package's seeded runs repeat themselves.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cudnn.deterministic = True

__version__ = "0.1.0"

from .api import restore  # noqa: E402  (uniform L3 contract)
from .methods.windowed import restore_windowed  # noqa: E402
from .methods.streaming import StreamRestorer, restore_stream  # noqa: E402

__all__ = ["restore", "restore_windowed", "StreamRestorer", "restore_stream"]
