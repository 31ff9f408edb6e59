"""Command line of the port: the ``restore`` command.

  python -m audio_inpainting_torch restore damaged.wav fixed.wav --method ar
  python -m audio_inpainting_torch restore damaged.wav fixed.wav --device cpu

It reads the WAV through the int16 chain, restores it with the facade and
writes an int16 WAV. It runs on the GPU unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import time


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="audio_inpainting_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    cmd = sub.add_parser("restore", help="restore one WAV with any method")
    cmd.add_argument("input_wav")
    cmd.add_argument("output_wav")
    cmd.add_argument("--method", default="ar",
                     choices=["linear", "ar", "nmf", "gp", "unet", "gan",
                              "diffusion"])
    cmd.add_argument("--threshold", type=float, default=1e-4,
                     help="damage-detection amplitude threshold; note that "
                          "naturally quiet passages below it are treated as "
                          "damage and rewritten (reference semantics)")
    cmd.add_argument("--seed", type=int, default=0)
    cmd.add_argument("--device", default="cuda",
                     help="torch device to run on (default cuda)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    t_start = time.time()
    if args.cmd == "restore":
        from ..api import restore
        from ..io import load_mono_normalized, save_wav_int16

        sr, damaged = load_mono_normalized(args.input_wav)
        out = restore(damaged, sr, method=args.method,
                      threshold=args.threshold, seed=args.seed,
                      device=args.device)
        save_wav_int16(out, sr, args.output_wav)
        print(f"restored {args.input_wav} -> {args.output_wav} "
              f"({args.method}, {args.device}, {time.time() - t_start:.1f}s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
