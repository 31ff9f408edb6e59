"""Command line of the port.

  python -m audio_inpainting_torch restore damaged.wav fixed.wav --method ar
  python -m audio_inpainting_torch restore damaged.wav fixed.wav --device cpu
  python -m audio_inpainting_torch restore damaged.wav fixed.wav --method gan \
      --original clean.wav
  python -m audio_inpainting_torch restore long.wav fixed.wav --window-s 2
  python -m audio_inpainting_torch stream --sr 44100 --method ar --warmup \
      < damaged.f32 > fixed.f32
  python -m audio_inpainting_torch serve damaged_dir/ restored_dir/ --method unet
  python -m audio_inpainting_torch score restored_dir/ clean_dir/
  python -m audio_inpainting_torch part0|part1|part2|all --input clip.wav
  python -m audio_inpainting_torch unet-gap --input clip.wav --epochs 600
  python -m audio_inpainting_torch check [--assets-dir demo_assets]
  python -m audio_inpainting_torch demo [--assets-dir demo_assets] [--device cpu]

``restore`` reads the WAV through the int16 chain, restores it with the
facade (or, with ``--window-s``, with the windowed engine: only windows of
that many seconds around the damage) and writes an int16 WAV. ``stream``
restores raw little-endian float32 mono PCM from stdin to stdout with the
streaming engine. ``serve`` restores every WAV of a directory (unet and
gan train all clips as one grouped net; ``--originals`` names the clean
WAVs the gan trains against; ``--devices N`` serves on N GPUs, one rank
each) and ``score`` gives the SNR and LSD of
restored WAVs against the originals of the same names.
``part0``/``part1``/``part2``/``all`` run
the scenario pipelines, write the demo_assets set and print each leg's
metrics; Part 2's diffusion leg samples from the committed corpus prior
unless ``--diffusion-checkpoint`` names another (``none``: train per
clip). ``unet-gap`` runs the U-Net overfit demo (pipelines/extras.py).
``check`` verifies the demo_assets contract (every file of ASSET_REGISTRY
exists; exit 1 and the list of missing files otherwise) and ``demo``
serves the gallery and the live restore API (demo/app.py).
Everything runs on the GPU unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _add_device(p):
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda)")


def _add_common(p):
    p.add_argument("--input", default="vocals_accompaniment_10s.wav",
                   help="source clip (the reference's 10 s WAV)")
    p.add_argument("--assets-dir", default="demo_assets")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--json", action="store_true", help="print metrics as JSON")
    _add_device(p)


def _add_gp(p):
    p.add_argument("--gp-restarts", type=int, default=5)
    p.add_argument("--gp-steps", type=int, default=20)


def _add_diffusion(p):
    p.add_argument("--diffusion-steps", type=int, default=1500,
                   help="per-clip DDPM training steps (when no checkpoint)")
    p.add_argument("--diffusion-checkpoint", default=None,
                   help="save_params directory of DDPM weights (default: the "
                        "committed corpus prior; 'none': train per clip)")


def _diffusion_checkpoint(arg: str | None) -> str | None:
    """The Part 2 diffusion leg's weights: the committed corpus prior by
    default, as the JAX package's CLI does; None ('none') trains per clip.
    A named directory must exist."""
    from ..methods.diffusion import PRIOR_DIR

    if arg is not None and arg.lower() == "none":
        return None
    path = PRIOR_DIR if arg is None else arg
    if not os.path.isdir(path):
        raise FileNotFoundError(f"diffusion checkpoint {path!r} does not exist")
    if arg is None:
        print(f"diffusion: using corpus prior at {os.path.normpath(path)} "
              "(--diffusion-checkpoint none to force per-clip)", file=sys.stderr)
    return path


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
    cmd.add_argument("--original", default=None,
                     help="clean reference WAV (GAN method only)")
    cmd.add_argument("--window-s", type=float, default=None,
                     help="windowed long-clip mode: restore only fixed "
                          "windows of this many seconds around the detected "
                          "damage (O(damage) work; clean audio passes "
                          "through exactly)")
    _add_device(cmd)

    st = sub.add_parser("stream", help="restore a raw little-endian float32 "
                                       "mono PCM stream, stdin -> stdout "
                                       "(bounded latency, O(damage) work)")
    st.add_argument("--sr", type=int, required=True,
                    help="sample rate of the incoming PCM")
    st.add_argument("--method", default="linear",
                    choices=["linear", "ar", "nmf", "gp", "unet"],
                    help="per-window restore method (gan and diffusion need "
                         "clean references or checkpoints: not streamable)")
    st.add_argument("--window-s", type=float, default=None,
                    help="restore window seconds (default: per method, "
                         "linear/gp 0.5, ar/unet 2, else 10)")
    st.add_argument("--adapt-epochs", type=int, default=100,
                    help="unet: warm-window adaptation budget of the "
                         "per-stream persistent net (the first window "
                         "trains the full --epochs budget)")
    st.add_argument("--fresh-net", action="store_true",
                    help="unet: train a fresh net per window instead of "
                         "carrying one net per stream")
    st.add_argument("--epochs", type=int, default=None,
                    help="unet: cold-window training epochs (default 400)")
    st.add_argument("--chunk", type=int, default=65536,
                    help="samples per stdin read")
    st.add_argument("--margin", type=int, default=50)
    st.add_argument("--threshold", type=float, default=1e-4)
    st.add_argument("--seed", type=int, default=0)
    st.add_argument("--warmup", action="store_true",
                    help="run representative windows BEFORE reading stdin "
                         "(StreamRestorer.warmup), so the first gap pays "
                         "no one-time cost (the kernel build, cuDNN setup)")
    st.add_argument("--max-gap-s", type=float, default=None,
                    help="longest expected damage span, bounds --warmup's "
                         "windows (default: everything up to the window cap)")
    _add_device(st)

    ps = sub.add_parser("serve", help="batch-restore a directory of WAVs "
                                      "(per-clip nets, trained as one batch)")
    ps.add_argument("input_dir")
    ps.add_argument("output_dir")
    ps.add_argument("--method", default="unet",
                    choices=["unet", "gan", "linear", "ar", "nmf", "gp",
                             "diffusion"],
                    help="unet/gan train all clips as one batch; the rest "
                         "run the per-clip facade")
    ps.add_argument("--epochs", type=int, default=400)
    ps.add_argument("--originals", default=None,
                    help="dir of clean WAVs, same names (GAN method only)")
    ps.add_argument("--devices", type=int, default=1,
                    help="GPUs to serve on (>= 1): one rank per card, "
                         "cuda:0 .. cuda:N-1 over NCCL, clamped to the cards "
                         "present (with --device cpu: gloo ranks, clamped to "
                         "the clips); each rank serves and writes its share "
                         "of the clips")
    ps.add_argument("--seed", type=int, default=0)
    ps.add_argument("--window-s", type=float, default=None,
                    help="long-file mode: per clip, restore only fixed "
                         "windows around the detected damage (unet windows "
                         "batch per window size)")
    ps.add_argument("--json", action="store_true")
    _add_device(ps)

    psc = sub.add_parser("score", help="SNR/LSD of restored WAVs vs originals")
    psc.add_argument("restored_dir")
    psc.add_argument("originals_dir")
    psc.add_argument("--json", action="store_true")
    _add_device(psc)

    p0 = sub.add_parser("part0", help="0.05 s segment: GP, AR, AR+texture, NMF")
    _add_common(p0)
    _add_gp(p0)
    p1 = sub.add_parser("part1", help="random frame dropouts: linear, AR, NMF, "
                                      "U-Net")
    _add_common(p1)
    p1.add_argument("--unet-epochs", type=int, default=400)
    p2 = sub.add_parser("part2", help="2 s hole: linear, AR, NMF, GAN, diffusion")
    _add_common(p2)
    p2.add_argument("--gan-epochs", type=int, default=1500)
    _add_diffusion(p2)
    pa = sub.add_parser("all", help="run all three scenario pipelines")
    _add_common(pa)
    _add_gp(pa)
    pa.add_argument("--unet-epochs", type=int, default=400)
    pa.add_argument("--gan-epochs", type=int, default=1500)
    _add_diffusion(pa)
    pu = sub.add_parser("unet-gap", help="main5_UNet_gap overfit demo variant")
    _add_common(pu)
    pu.add_argument("--epochs", type=int, default=600)

    pd = sub.add_parser("demo", help="launch the demo UI over the assets")
    pd.add_argument("--assets-dir", default="demo_assets")
    pd.add_argument("--share", action="store_true")
    _add_device(pd)

    pc = sub.add_parser("check", help="verify the demo asset contract")
    pc.add_argument("--assets-dir", default="demo_assets")
    return ap


def _emit(name: str, results: dict, as_json: bool):
    if as_json:
        print(json.dumps({name: results}))
        return
    print(f"== {name} ==")
    for method, vals in results.items():
        if isinstance(vals, dict):
            row = "  ".join(f"{k}={v:.2f}" if isinstance(v, float) else f"{k}={v}"
                            for k, v in vals.items())
            print(f"  {method:12s} {row}")
        else:
            print(f"  {method:12s} {vals}")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.cmd == "check":
        return _check(args.assets_dir)
    if args.cmd == "demo":
        from ..demo.app import launch

        launch(args.assets_dir, share=args.share, device=args.device)
        return 0
    t_start = time.time()
    if args.cmd == "restore":
        from ..api import restore
        from ..io import load_mono_normalized, save_wav_int16

        sr, damaged = load_mono_normalized(args.input_wav)
        original = (load_mono_normalized(args.original)[1]
                    if args.original else None)
        kw = dict(method=args.method, threshold=args.threshold,
                  seed=args.seed, original=original, device=args.device)
        if args.window_s is not None:
            from ..methods.windowed import restore_windowed

            out = restore_windowed(damaged, sr, window_s=args.window_s, **kw)
        else:
            out = restore(damaged, sr, **kw)
        save_wav_int16(out, sr, args.output_wav)
        print(f"restored {args.input_wav} -> {args.output_wav} "
              f"({args.method}, {args.device}, {time.time() - t_start:.1f}s)")
        return 0
    if args.cmd == "stream":
        return _stream(args, t_start)
    if args.cmd == "score":
        _emit("score", _score(args.restored_dir, args.originals_dir, args.device),
              args.json)
        return 0
    if args.cmd == "serve":
        from ..pipelines.serve import run_serve

        res = run_serve(args.input_dir, args.output_dir, method=args.method,
                        epochs=args.epochs, originals_dir=args.originals,
                        seed=args.seed, devices=args.devices,
                        window_s=args.window_s, device=args.device)
        _emit("serve", res if args.json else res["files"], args.json)
        print(f"{res['clips']} clips -> {args.output_dir} "
              f"({res['wall_s']}s)", file=sys.stderr)
        return 0
    if args.cmd == "unet-gap":
        from ..pipelines.extras import run_unet_gap

        _emit("unet-gap", {"unet_gap": run_unet_gap(
            args.input, args.assets_dir, epochs=args.epochs, seed=args.seed,
            device=args.device)}, args.json)
        return 0
    from ..pipelines import run_part0, run_part1, run_part2

    if args.cmd in ("part2", "all"):
        # before any leg runs: a named checkpoint that is missing fails fast
        dckpt = _diffusion_checkpoint(args.diffusion_checkpoint)
    if args.cmd in ("part0", "all"):
        from ..methods.gp import GPConfig

        gp_cfg = GPConfig(n_restarts=args.gp_restarts, opt_steps=args.gp_steps)
        _emit("part0", run_part0(args.input, args.assets_dir, seed=args.seed,
                                 gp_cfg=gp_cfg, device=args.device), args.json)
    if args.cmd in ("part1", "all"):
        _emit("part1", run_part1(args.input, args.assets_dir, seed=args.seed,
                                 unet_epochs=args.unet_epochs,
                                 device=args.device), args.json)
    if args.cmd in ("part2", "all"):
        from ..methods.diffusion import DiffusionConfig

        _emit("part2", run_part2(
            args.input, args.assets_dir, seed=args.seed, gan_epochs=args.gan_epochs,
            diffusion_cfg=DiffusionConfig(train_steps=args.diffusion_steps),
            diffusion_checkpoint=dckpt, device=args.device), args.json)
    print(f"total wall: {time.time() - t_start:.1f}s", file=sys.stderr)
    return 0


def _check(assets_dir: str) -> int:
    """0 when every artifact of ASSET_REGISTRY exists under ``assets_dir``;
    else 1, after listing the missing files."""
    from ..pipelines.registry import ASSET_REGISTRY

    missing = [os.path.join(assets_dir, rel)
               for methods in ASSET_REGISTRY.values()
               for kinds in methods.values() for rel in kinds.values()
               if not os.path.exists(os.path.join(assets_dir, rel))]
    if missing:
        print(f"MISSING {len(missing)} artifacts:")
        for m in missing:
            print(" ", m)
        return 1
    print("asset contract complete")
    return 0


def _score(restored_dir: str, originals_dir: str, device) -> dict:
    """Per restored WAV: SNR and LSD against the original of the same name
    (both cut to the shorter), or "no original"."""
    import glob

    from ..io import load_mono_normalized
    from ..metrics import lsd_db, snr_db

    rows = {}
    for path in sorted(glob.glob(os.path.join(restored_dir, "*.wav"))):
        name = os.path.basename(path)
        opath = os.path.join(originals_dir, name)
        if not os.path.exists(opath):
            rows[name] = "no original"
            continue
        _, got = load_mono_normalized(path)
        _, ref = load_mono_normalized(opath)
        n = min(len(got), len(ref))
        rows[name] = {"snr_db": round(float(snr_db(ref[:n], got[:n], device)), 2),
                      "lsd_db": round(float(lsd_db(ref[:n], got[:n], device=device)), 2),
                      "samples": int(n)}
    return rows


def _stream(args, t_start: float) -> int:
    """The ``stream`` command: stdin PCM through a StreamRestorer."""
    import numpy as np

    from ..methods.streaming import StreamRestorer

    kw = {}
    if args.method == "unet":
        kw["persist"] = not args.fresh_net
        kw["adapt_epochs"] = args.adapt_epochs
        if args.epochs is not None:
            kw["epochs"] = args.epochs
    rest = StreamRestorer(args.sr, method=args.method, window_s=args.window_s,
                          margin=args.margin, threshold=args.threshold,
                          seed=args.seed, device=args.device, **kw)
    if args.warmup:
        t0 = time.time()
        n_warm = rest.warmup(args.max_gap_s)
        print(f"warmup: {n_warm} windows in {time.time() - t0:.1f}s",
              file=sys.stderr)
    stdin, stdout = sys.stdin.buffer, sys.stdout.buffer
    carry = b""   # pipe reads can split a sample's 4 bytes
    total_in = total_out = 0

    def write(out):
        nonlocal total_out
        if len(out):
            total_out += len(out)
            stdout.write(np.asarray(out, "<f4").tobytes())
            stdout.flush()

    while buf := stdin.read(args.chunk * 4):
        carry += buf
        usable = len(carry) - len(carry) % 4
        if not usable:
            continue
        x = np.frombuffer(carry[:usable], "<f4")
        carry = carry[usable:]
        total_in += len(x)
        write(rest.feed(x))
    if carry:
        print(f"warning: {len(carry)} trailing bytes are not a whole "
              "float32 sample; dropped", file=sys.stderr)
    write(rest.flush())
    print(f"streamed {total_in} samples in, {total_out} out "
          f"({args.method}, {args.device}, {time.time() - t_start:.1f}s)",
          file=sys.stderr)
    return 0


def entry() -> None:
    """`audio-inpainting-torch` console entry point (pyproject [project.scripts])."""
    raise SystemExit(main())


if __name__ == "__main__":
    raise SystemExit(main())
