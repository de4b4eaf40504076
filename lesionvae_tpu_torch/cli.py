"""Command-line entry point of the PyTorch port:

    python -m lesionvae_tpu_torch geometry [--max-streamlines N] [--upload {f32,u16d}] ...
    python -m lesionvae_tpu_torch lesion [--strict] [--device {cuda,cpu}] ...
    python -m lesionvae_tpu_torch vae    --tract atr_left [--no-plots] ...
    python -m lesionvae_tpu_torch score  --checkpoint DIR --normative NPZ --tract T --timepoint TP
    python -m lesionvae_tpu_torch vae-cohort   [--tracts ...] [--store bf16] [--upload-chunks {N,auto}] ...
    python -m lesionvae_tpu_torch score-cohort [--cohort-dir DIR] [--subjects ...]
    python -m lesionvae_tpu_torch classify  [--geometry-csv CSV] [--no-plots]
    python -m lesionvae_tpu_torch correlate [--geometry-csv CSV] [--lesion-csv CSV] [--no-plots]
    python -m lesionvae_tpu_torch all    [--with-vae] [--epochs N] [--no-plots]
                                         (geometry -> lesion -> [vae-cohort] -> classify -> correlate)
    python -m lesionvae_tpu_torch synth  [--n-streamlines N] [--volume V]

Every subcommand of ``python -m lesionvae_tpu`` is here, with its flags and
default paths.  Every device stage runs on the card unless ``--device cpu``
is given; there is no automatic fallback.  ``classify`` and ``correlate``
are host work (sklearn, scipy) on the CSVs the device stages wrote;
``--no-plots`` (also on ``all``) leaves out their matplotlib figures.  A
stage that needs a host package the machine lacks (sklearn for
``classify``, matplotlib and seaborn for figures) raises an ImportError
naming it before anything runs; ``all`` checks them all before its first
stage.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
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


#: host packages each analysis stage imports, and those of its figures
NEEDS = {"classify": ("sklearn",), "correlate": ("scipy",)}
FIGURES_NEED = ("matplotlib", "seaborn")


def require_host_packages(stages, make_plots: bool) -> None:
    """Raise ImportError naming every host package that ``stages`` need and
    this machine lacks (an import check: nothing is run)."""
    need = [m for st in stages for m in NEEDS[st]]
    if make_plots:
        need += FIGURES_NEED
    missing = sorted({m for m in need if importlib.util.find_spec(m) is None})
    if missing:
        hint = " (--no-plots leaves out the figures)" if make_plots else ""
        raise ImportError(f"{' and '.join(stages)} need {', '.join(missing)}, not "
                          f"installed here; nothing was run{hint}", name=missing[0])


def build_parser() -> argparse.ArgumentParser:
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
    p.add_argument("--upload-chunks", default="1",
                   help="member-axis launch chunks, each its own copy to the "
                        "device and its own training run ('auto' = the "
                        "largest divisor of the fleet size <= 8; "
                        "train.batched)")
    p.add_argument("--save-z", action="store_true",
                   help="also fetch and store the full per-streamline z-score "
                        "block per member (default: z stays on the device, "
                        "per-subject summaries are stored)")
    p.add_argument("--dtype", choices=["f32", "bf16"], default="f32",
                   help="fleet compute dtype (bf16 = mixed precision)")
    p.add_argument("--save-checkpoints", action="store_true",
                   help="save every member with its normalization stats: the "
                        "serving bundles of score and score-cohort")

    p = sub.add_parser("classify", help="TBI-vs-PTE classification (sklearn)")
    _add_common(p)
    p.add_argument("--geometry-csv", default=None)
    p.add_argument("--no-plots", action="store_true")

    p = sub.add_parser("correlate", help="lesion-tract correlation (scipy)")
    _add_common(p)
    p.add_argument("--geometry-csv", default=None)
    p.add_argument("--lesion-csv", default=None)
    p.add_argument("--no-plots", action="store_true")

    p = sub.add_parser("all", help="full pipeline: geometry -> lesion -> "
                                   "[vae-cohort] -> classify -> correlate")
    _add_common(p)
    p.add_argument("--max-streamlines", type=int, default=100)
    p.add_argument("--num-samples", type=int, default=2000)
    p.add_argument("--with-vae", action="store_true",
                   help="also train the (tract x timepoint) VAE fleet "
                        "(run_vae_cohort) as part of the pipeline")
    p.add_argument("--epochs", type=int, default=40,
                   help="VAE epochs when --with-vae is set")
    p.add_argument("--no-plots", action="store_true")

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

    return parser


def _geometry_csv(out_root: Path) -> Path:
    return (out_root / "comprehensive_tract_geometry"
            / "comprehensive_tract_geometry_metrics.csv")


def _lesion_csv(out_root: Path) -> Path:
    return (out_root / "lesion_sh_heme_comprehensive"
            / "lesion_sh_heme_comprehensive.csv")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.stage in ("classify", "correlate", "all"):
        require_host_packages(("classify", "correlate") if args.stage == "all"
                              else (args.stage,), not args.no_plots)
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
                           upload_chunks=(args.upload_chunks
                                          if args.upload_chunks == "auto"
                                          else int(args.upload_chunks)),
                           save_checkpoints=args.save_checkpoints,
                           device=args.device)

        elif args.stage == "classify":
            from .pipeline.classification import run_classification
            run_classification(Path(args.geometry_csv) if args.geometry_csv
                               else _geometry_csv(out_root),
                               out_root / "tbi_pte_classification",
                               make_plots=not args.no_plots)

        elif args.stage == "correlate":
            from .pipeline.correlation import run_correlation
            run_correlation(Path(args.lesion_csv) if args.lesion_csv
                            else _lesion_csv(out_root),
                            Path(args.geometry_csv) if args.geometry_csv
                            else _geometry_csv(out_root),
                            out_root / "lesion_tract_correlations",
                            make_plots=not args.no_plots)

        elif args.stage == "all":
            from .pipeline.classification import run_classification
            from .pipeline.correlation import run_correlation
            from .pipeline.geometry_run import run_geometry
            from .pipeline.lesion_run import run_lesion_analysis
            run_geometry(config, data_dir, _geometry_csv(out_root).parent,
                         max_streamlines=args.max_streamlines, device=args.device)
            run_lesion_analysis(config, data_dir, _lesion_csv(out_root).parent,
                                num_samples=args.num_samples, seed=args.seed,
                                device=args.device)
            if args.with_vae:
                from .pipeline.vae_run import run_vae_cohort
                run_vae_cohort(list(config.geometry_tracts), epochs=args.epochs,
                               config=config, base_path=base,
                               output_dir=out_root / "vae_cohort", seed=args.seed,
                               device=args.device)
            run_classification(_geometry_csv(out_root),
                               out_root / "tbi_pte_classification",
                               make_plots=not args.no_plots)
            run_correlation(_lesion_csv(out_root), _geometry_csv(out_root),
                            out_root / "lesion_tract_correlations",
                            make_plots=not args.no_plots)

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
