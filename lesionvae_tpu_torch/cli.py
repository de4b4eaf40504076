"""Command-line entry point of the PyTorch port:

    python -m lesionvae_tpu_torch lesion [--strict] [--device {cuda,cpu}] ...
    python -m lesionvae_tpu_torch vae    --tract atr_left [--no-plots] ...
    python -m lesionvae_tpu_torch score  --checkpoint DIR --normative NPZ --tract T --timepoint TP

Ported so far: the lesion SH + heme stage, the single-tract VAE stage and
serving a saved VAE; the other stages of ``python -m lesionvae_tpu`` come
with their slices.  Every stage runs on the card unless ``--device cpu`` is
given; there is no automatic fallback.
"""

from __future__ import annotations

import argparse
import contextlib
import sys
import time
from pathlib import Path

from .core.config import load_config
from .utils import profiling
from .utils.logging import get_logger

log = get_logger("cli")


def _add_common(p: argparse.ArgumentParser):
    p.add_argument("--config", default=None, help="tract_config.json path")
    p.add_argument("--base-path", default=None)
    p.add_argument("--data-dir", default=None)
    p.add_argument("--output-dir", default=None)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the device stage runs (cpu: the kernels' "
                        "plain versions)")
    p.add_argument("--trace", nargs="?", const="lesionvae_trace",
                   default=None, metavar="DIR",
                   help="write a torch.profiler Chrome trace of the stage "
                        "to DIR/trace.json")


def _resolve(args):
    config = load_config(args.config)
    base = Path(args.base_path or config.base_path)
    data_dir = Path(args.data_dir) if args.data_dir else base / "data"
    out_root = Path(args.output_dir) if args.output_dir else base / "results"
    return config, base, data_dir, out_root


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="lesionvae_tpu_torch")
    sub = parser.add_subparsers(dest="stage", required=True)

    p = sub.add_parser("lesion", help="lesion SH + heme analysis")
    _add_common(p)
    p.add_argument("--strict", action="store_true",
                   help="strict variant (skip missing lesions, extra figures)")
    p.add_argument("--max-l", type=int, default=6)
    p.add_argument("--num-samples", type=int, default=2000)

    p = sub.add_parser("vae", help="VAE training + z-score analysis")
    _add_common(p)
    p.add_argument("--tract", required=True)
    p.add_argument("--latent-dim", type=int, default=10)
    p.add_argument("--epochs", type=int, default=40)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--no-plots", action="store_true")

    p = sub.add_parser("score",
                       help="serving: z-score subjects against a saved "
                            "normative model (no retraining)")
    _add_common(p)
    p.add_argument("--checkpoint", required=True,
                   help="directory written by train.checkpoint.save_vae")
    p.add_argument("--normative", required=True,
                   help="zscores_*.npz holding norm_mean/norm_std")
    p.add_argument("--tract", required=True)
    p.add_argument("--timepoint", required=True)
    p.add_argument("--subjects", nargs="*", default=None,
                   help="default: all config subjects")

    args = parser.parse_args(argv)
    config, base, data_dir, out_root = _resolve(args)
    t0 = time.perf_counter()
    with (profiling.trace(args.trace, args.device) if args.trace
          else contextlib.nullcontext()):
        if args.stage == "lesion":
            from .pipeline.lesion_run import (run_lesion_analysis,
                                              run_lesion_shape_descriptors)
            if args.strict:
                run_lesion_shape_descriptors(
                    config, data_dir, out_root / "lesion_sh_descriptors_cleaned",
                    max_l=args.max_l, num_samples=args.num_samples,
                    seed=args.seed, device=args.device)
            else:
                run_lesion_analysis(
                    config, data_dir, out_root / "lesion_sh_heme_comprehensive",
                    max_l=args.max_l, num_samples=args.num_samples,
                    seed=args.seed, device=args.device)

        elif args.stage == "vae":
            from .pipeline.vae_run import run_vae_analysis
            run_vae_analysis(args.tract, latent_dim=args.latent_dim,
                             epochs=args.epochs, batch_size=args.batch_size,
                             lr=args.lr, config=config, base_path=base,
                             output_dir=out_root / "vae_analysis" / args.tract,
                             seed=args.seed, make_plots=not args.no_plots,
                             device=args.device)

        elif args.stage == "score":
            from .pipeline.infer import load_normative, score_subjects
            norm = load_normative(args.normative)
            subjects = args.subjects or [
                s for subs in config.subjects_by_group().values() for s in subs]
            summary = score_subjects(args.checkpoint, norm["mean"], norm["std"],
                                     base, args.tract, args.timepoint, subjects,
                                     config=config, seed=args.seed,
                                     device=args.device)
            out = out_root / "serving"
            out.mkdir(parents=True, exist_ok=True)
            csv = out / f"scores_{args.tract}_{args.timepoint}.csv"
            summary.to_csv(csv, index=False)
            log.info("wrote %d subject scores -> %s", len(summary), csv)
    log.info("stage %s done in %.2fs", args.stage, time.perf_counter() - t0)

    rep = profiling.report()
    if rep:
        width = max(len(k) for k in rep)
        print("\n== stage wall-clock ==")
        for name, dt in rep.items():
            print(f"  {name:<{width}}  {dt:8.2f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
