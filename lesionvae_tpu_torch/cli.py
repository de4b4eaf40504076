"""Command-line entry point of the PyTorch port:

    python -m lesionvae_tpu_torch geometry [--max-streamlines N] [--upload {f32,u16d}] ...
    python -m lesionvae_tpu_torch lesion [--strict] [--device {cuda,cpu}] ...
    python -m lesionvae_tpu_torch vae    --tract atr_left [--no-plots] ...
    python -m lesionvae_tpu_torch score  --checkpoint DIR --normative NPZ --tract T --timepoint TP
    python -m lesionvae_tpu_torch vae-cohort   [--tracts ...] [--store bf16] [--save-checkpoints] ...
    python -m lesionvae_tpu_torch score-cohort [--cohort-dir DIR] [--subjects ...]
    python -m lesionvae_tpu_torch synth  [--n-streamlines N] [--volume V]

Ported so far: the tract-geometry stage, the lesion SH + heme stage, the
single-tract VAE stage, serving a saved VAE, the cohort forms of both (the
whole (tract x timepoint) fleet trained and served as one program), and the
synthetic cohort; ``classify``, ``correlate`` and ``all`` of
``python -m lesionvae_tpu`` come with their slices.  Every stage runs on the card unless ``--device cpu`` is
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

    p = sub.add_parser("geometry", help="tract geometry metrics")
    _add_common(p)
    p.add_argument("--max-streamlines", type=int, default=100)
    p.add_argument("--upload", choices=["f32", "u16d"], default="f32",
                   help="point upload codec: u16d copies u16 delta codes "
                        "(half the bytes; torsion recomputed exactly on the "
                        "host; ops.geo_codec)")

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

    p = sub.add_parser("vae-cohort",
                       help="train the whole (tract x timepoint) VAE fleet "
                            "as one program")
    _add_common(p)
    p.add_argument("--tracts", nargs="*", default=None,
                   help="default: config geometry tracts")
    p.add_argument("--latent-dim", type=int, default=10)
    p.add_argument("--epochs", type=int, default=40)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--store", choices=["f32", "bf16"], default="f32",
                   help="storage dtype of weights and Adam moments: bf16 "
                        "halves the optimizer's memory streams, written back "
                        "with stochastic rounding (train.lowmem)")
    p.add_argument("--quantize-upload", action="store_true",
                   help="upload the raw tensors as uint16 fixed-point codes "
                        "(train.quantize)")
    p.add_argument("--save-z", action="store_true",
                   help="also fetch and store the full per-streamline z-score "
                        "block per member (default: z stays on the device, "
                        "per-subject summaries are stored)")
    p.add_argument("--dtype", choices=["f32", "bf16"], default="f32",
                   help="fleet compute dtype (bf16 = mixed precision)")
    p.add_argument("--save-checkpoints", action="store_true",
                   help="save every member with its normalization stats: the "
                        "serving bundles of score and score-cohort")

    p = sub.add_parser("score-cohort",
                       help="serving: z-score subjects against every saved "
                            "(tract x timepoint) member in one pass")
    _add_common(p)
    p.add_argument("--cohort-dir", default=None,
                   help="run_vae_cohort output dir with checkpoints/ "
                        "(default: <output>/vae_cohort)")
    p.add_argument("--subjects", nargs="*", default=None,
                   help="default: all config subjects")

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

    p = sub.add_parser("synth", help="generate a synthetic cohort")
    _add_common(p)
    p.add_argument("--n-streamlines", type=int, default=30)
    p.add_argument("--volume", type=int, default=32)

    args = parser.parse_args(argv)
    config, base, data_dir, out_root = _resolve(args)
    t0 = time.perf_counter()
    with (profiling.trace(args.trace, args.device) if args.trace
          else contextlib.nullcontext()):
        if args.stage == "geometry":
            from .pipeline.geometry_run import run_geometry
            run_geometry(config, data_dir, out_root / "comprehensive_tract_geometry",
                         max_streamlines=args.max_streamlines, upload=args.upload,
                         device=args.device)

        elif args.stage == "synth":
            from .io.synth import generate_cohort
            generate_cohort(base, config, seed=args.seed,
                            n_streamlines=args.n_streamlines,
                            volume_shape=(args.volume,) * 3, with_profiles=True,
                            with_bundles=True)

        elif args.stage == "lesion":
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

        elif args.stage == "vae-cohort":
            import torch

            from .pipeline.vae_run import run_vae_cohort
            bf16 = {"f32": None, "bf16": torch.bfloat16}
            run_vae_cohort(args.tracts or list(config.geometry_tracts),
                           latent_dim=args.latent_dim, epochs=args.epochs,
                           batch_size=args.batch_size, lr=args.lr, config=config,
                           base_path=base, output_dir=out_root / "vae_cohort",
                           seed=args.seed, save_z=args.save_z,
                           compute_dtype=bf16[args.dtype],
                           store_dtype=bf16[args.store],
                           quantize_upload=args.quantize_upload,
                           save_checkpoints=args.save_checkpoints,
                           device=args.device)

        elif args.stage == "score-cohort":
            from .pipeline.infer import score_cohort
            cohort_dir = (Path(args.cohort_dir) if args.cohort_dir
                          else out_root / "vae_cohort")
            subjects = args.subjects or [
                s for subs in config.subjects_by_group().values() for s in subs]
            out = score_cohort(cohort_dir, base, subjects, config=config,
                               seed=args.seed, output_dir=out_root / "serving",
                               device=args.device)
            csv = out_root / "serving" / "cohort_scores.csv"
            if len(out):
                log.info("wrote %d member-subject scores -> %s", len(out), csv)
            else:
                log.warning("no members scored; empty %s written", csv)

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
