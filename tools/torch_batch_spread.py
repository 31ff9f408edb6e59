#!/usr/bin/env python3
"""Where the port's batched per-clip training parts from single clips on
one CUDA GPU, and how far the single path parts from a rerun of itself.

    python3 tools/torch_batch_spread.py        # from the repository root

1. Per-epoch losses, 20 fp32 epochs, on chip_smoke.py's four corpus
   spectrograms at full size (513, 1723): the grouped trainer (G = 4)
   against single trainers on clips 0 and 3, and each single trainer
   against a rerun of itself, for the GAN and the U-Net, with cuDNN's
   default kernels and with ``torch.backends.cudnn.deterministic``.
2. The bf16 GAN of ``run_serve(method="gan", epochs=300)`` on chip_smoke's
   serve corpus: each clip's fill SNR from the batch, a rerun of the
   batch, and two single runs from the same init.

Each part prints one JSON line. It needs a GPU; it imports nothing of JAX.
"""

from __future__ import annotations

import json
import sys
import tempfile
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from audio_inpainting_torch import parallel  # noqa: E402
from audio_inpainting_torch.methods import neural  # noqa: E402
from audio_inpainting_torch.pipelines.serve import run_serve  # noqa: E402

EPOCHS = 20
CLIPS = (0, 3)


def losses(trainer, n: int) -> torch.Tensor:
    """n epochs' losses: (n, G) (U-Net), (n, G, 2) (GAN; D, G); no G axis
    for one clip."""
    out = []
    for _ in range(n):
        x = trainer.epoch()
        out.append(torch.stack(x, -1) if isinstance(x, tuple) else x)
    return torch.stack(out).double().cpu()


def rel_by_epoch(a: torch.Tensor, b: torch.Tensor) -> list[float]:
    err = ((a - b).abs() / b.abs()).reshape(len(a), -1)
    return err.max(dim=1).values.tolist()


def traces(dev) -> None:
    mags, masks = cs.corpus_spectrograms(cs.SERVE_CLIPS)
    mags, masks = mags.to(dev), masks.to(dev)
    seeds = [100 + g for g in range(cs.SERVE_CLIPS)]
    gcfg = neural.GANTrainConfig(epochs=EPOCHS, ema_decay=0.99, ema_scope="gap")
    ucfg = neural.UNetTrainConfig(epochs=EPOCHS)
    makers = {"gan": lambda m, k, s: neural.GANTrainer(*cs.gan_inputs(m, k), gcfg, s),
              "unet": lambda m, k, s: neural.UNetTrainer(m, k, ucfg, s)}
    for kind, make in makers.items():
        for deterministic in (False, True):
            torch.backends.cudnn.deterministic = deterministic
            batch = losses(make(mags, masks, seeds), EPOCHS)
            rows = {}
            for g in CLIPS:
                one = losses(make(mags[g], masks[g], seeds[g]), EPOCHS)
                two = losses(make(mags[g], masks[g], seeds[g]), EPOCHS)
                rows[g] = {"batch_vs_single": rel_by_epoch(batch[:, g], one),
                           "single_vs_rerun": rel_by_epoch(two, one)}
            print(json.dumps({"part": "loss_rel_err_by_epoch", "kind": kind,
                              "cudnn_deterministic": deterministic, "clips": rows}),
                  flush=True)
    torch.backends.cudnn.deterministic = False


def gan_fill_spread(dev) -> None:
    seen, real = {}, parallel.restore_clips_gan

    def keep(norm, rnorm, masks, cfg, seed, **kw):
        out = real(norm, rnorm, masks, cfg, seed, **kw)
        seen.update(norm=norm, rnorm=rnorm, masks=masks, cfg=cfg, seed=seed, kw=kw,
                    out=out[0])
        return out

    with tempfile.TemporaryDirectory() as tmp:
        din, dclean = cs.serve_corpus(Path(tmp))
        parallel.restore_clips_gan = keep
        try:
            res = run_serve(str(din), str(Path(tmp) / "out"), method="gan",
                            epochs=cs.SERVE_GAN_EPOCHS, originals_dir=str(dclean))
        finally:
            parallel.restore_clips_gan = real
    f, t = 513, next(iter(res["files"].values()))["frames"]
    seeds = parallel.clip_seeds(seen["seed"], cs.SERVE_CLIPS)
    clip_args = [[seen[k][g, :f, :t] for k in ("norm", "rnorm", "masks")]
                 for g in range(cs.SERVE_CLIPS)]
    rerun = real(seen["norm"], seen["rnorm"], seen["masks"], seen["cfg"], seen["seed"],
                 **seen["kw"])[0]
    rows = {"batch": [], "batch_rerun": [], "single": [], "single_rerun": []}
    for g, args in enumerate(clip_args):
        rows["batch"].append(cs.fill_snr_db(seen["out"][g, :f, :t], *args[1:]))
        rows["batch_rerun"].append(cs.fill_snr_db(rerun[g, :f, :t], *args[1:]))
        for key in ("single", "single_rerun"):
            one = neural.gan_train_restore(*args, seen["cfg"], seeds[g], device=dev)[0]
            rows[key].append(cs.fill_snr_db(one, *args[1:]))
    print(json.dumps({"part": "bf16_gan_fill_snr_db", "epochs": cs.SERVE_GAN_EPOCHS,
                      "clips": rows}), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_batch_spread: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    print(cs.gpu_name_and_power(), flush=True)
    traces(dev)
    gan_fill_spread(dev)
    print(json.dumps({"seconds": time.perf_counter() - t0}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
