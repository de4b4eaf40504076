"""The port stands alone: no module of lesionvae_tpu_torch, and not
chip_smoke.py, imports JAX or the JAX package, and its entry points target
the card unless the caller asks for the CPU."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "lesionvae_tpu")

_IMPORT_ALL = """
import importlib, pkgutil, sys
import lesionvae_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in {forbidden!r})
print(len(names), bad)
"""


def test_importing_every_module_loads_no_jax():
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL.format(forbidden=set(FORBIDDEN))],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    n, bad = proc.stdout.strip().split(" ", 1)
    assert int(n) >= 15 and bad == "[]", proc.stdout


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO)) for p in
    [*(REPO / "lesionvae_tpu_torch").rglob("*.py"), REPO / "chip_smoke.py"]))
def test_source_imports_no_jax(path):
    tree = ast.parse((REPO / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots = [node.module.split(".")[0]]
        else:
            continue
        assert not set(roots) & set(FORBIDDEN), (path, ast.dump(node))


def test_the_cohort_fleet_modules_are_on_the_list():
    """The modules of the cohort fleet are among the sources checked above."""
    checked = {str(p.relative_to(REPO / "lesionvae_tpu_torch"))
               for p in (REPO / "lesionvae_tpu_torch").rglob("*.py")}
    assert {"train/batched.py", "train/lowmem.py", "train/quantize.py",
            "ops/sr_adam.py", "ops/adam.py", "models/fleet.py"} <= checked


def test_the_geometry_modules_are_on_the_list():
    """The modules of the tract-geometry stage are among the sources checked
    above."""
    checked = {str(p.relative_to(REPO / "lesionvae_tpu_torch"))
               for p in (REPO / "lesionvae_tpu_torch").rglob("*.py")}
    assert {"io/vtk.py", "io/vtk_native.py", "ops/geometry.py", "ops/geo_codec.py",
            "pipeline/geometry_run.py"} <= checked


def test_geometry_entry_points_default_to_cuda(tmp_path):
    """``run_geometry`` and ``launch_geometry``, called without ``device``,
    target the card: a CUDA error on a host without one, and float64 is
    refused there as the CPU's parity route."""
    import inspect

    import torch

    from lesionvae_tpu_torch.io import synth
    from lesionvae_tpu_torch.pipeline import geometry_run

    for fn in (geometry_run.run_geometry, geometry_run.launch_geometry,
               geometry_run.launch_all_tracts, geometry_run.launch_bundle_metrics,
               geometry_run.metrics_dataframe):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    if torch.cuda.is_available():
        pytest.skip("a card is present; this checks the CPU-only host")
    cfg = synth.tiny_config(n_per_group=1, tracts=["atr_left"])
    root = synth.generate_cohort(tmp_path, cfg, seed=2, n_streamlines=4,
                                 volume_shape=(4, 4, 4), subjects={"TBI": ["9101"]},
                                 with_bundles=True)
    with pytest.raises((AssertionError, RuntimeError), match="CUDA|accelerator"):
        geometry_run.run_geometry(cfg, data_dir=root / "data",
                                  output_dir=tmp_path / "out")
    with pytest.raises(ValueError, match="float32 on cuda"):
        geometry_run.launch_geometry(cfg, data_dir=root / "data",
                                     output_dir=tmp_path / "out", dtype=torch.float64)


def test_entry_point_defaults_to_cuda(tmp_path):
    """Called without ``device``, the stage targets the card: on a host
    without one that is a CUDA error, never a quiet CPU run."""
    import torch

    from lesionvae_tpu_torch.io import synth
    from lesionvae_tpu_torch.pipeline import lesion_run

    if torch.cuda.is_available():
        pytest.skip("a card is present; this checks the CPU-only host")
    cfg = synth.tiny_config(n_per_group=1)
    root = synth.generate_cohort(tmp_path, cfg, seed=2,
                                 volume_shape=(20, 20, 20),
                                 subjects={"TBI": ["9101"]})
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        lesion_run.analyze_single_lesion("9101", "9d", root / "data",
                                         num_samples=200,
                                         rng=np.random.default_rng(0))
    with pytest.raises(ValueError, match="float32 on cuda"):
        lesion_run.run_lesion_analysis(cfg, data_dir=root / "data",
                                       output_dir=tmp_path / "out",
                                       dtype=torch.float64)


def test_the_pipeline_modules_are_on_the_list():
    """The modules of the whole pipeline (classify, correlate, all, the flat
    optimizer, chunked launches and the native host readers) are among the
    sources checked above."""
    checked = {str(p.relative_to(REPO / "lesionvae_tpu_torch"))
               for p in (REPO / "lesionvae_tpu_torch").rglob("*.py")}
    assert {"pipeline/classification.py", "pipeline/correlation.py",
            "viz/classify_viz.py", "viz/correlation_viz.py",
            "io/profiles_native.py", "utils/native.py", "ops/padding.py",
            "train/quantize.py", "train/lowmem.py", "train/batched.py",
            "cli.py"} <= checked


@pytest.mark.parametrize("stage", ["classify", "correlate", "all"])
def test_analysis_stages_default_to_cuda(stage):
    """``classify``, ``correlate`` and ``all`` take ``--device`` with the
    card as its default, as every stage of the CLI does."""
    from lesionvae_tpu_torch import cli

    args = cli.build_parser().parse_args([stage])
    assert args.device == "cuda" and args.no_plots is False


def test_all_defaults_to_cuda(tmp_path):
    """``all`` without ``--device`` starts its geometry stage on the card: a
    CUDA error on a host without one, never a quiet CPU run."""
    import json

    import torch

    from lesionvae_tpu_torch import cli
    from lesionvae_tpu_torch.io import synth

    if torch.cuda.is_available():
        pytest.skip("a card is present; this checks the CPU-only host")
    cfg = synth.tiny_config(n_per_group=1, tracts=["atr_left"])
    root = synth.generate_cohort(tmp_path, cfg, seed=2, n_streamlines=4,
                                 volume_shape=(4, 4, 4), subjects={"TBI": ["9101"]},
                                 with_bundles=True)
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(cfg.to_json_dict()))
    with pytest.raises((AssertionError, RuntimeError), match="CUDA|accelerator"):
        cli.main(["all", "--config", str(cfg_path), "--base-path", str(root),
                  "--no-plots"])
    assert not (root / "results" / "lesion_sh_heme_comprehensive").exists()


def test_the_parallel_modules_are_on_the_list():
    """The multi-rank layer and the card's accounting utilities are among the
    sources checked above."""
    checked = {str(p.relative_to(REPO / "lesionvae_tpu_torch"))
               for p in (REPO / "lesionvae_tpu_torch").rglob("*.py")}
    assert {"parallel/mesh.py", "parallel/sharded.py", "parallel/ranks.py",
            "utils/cost_model.py", "utils/device_trace.py"} <= checked


def test_a_spawned_rank_loads_no_jax():
    """A rank started by ``parallel.mesh.spawn`` (the ``spawn`` start method
    imports the module of its function afresh) has neither JAX nor the JAX
    package in ``sys.modules``."""
    from lesionvae_tpu_torch.parallel import mesh, ranks

    for (modules, _counts), in mesh.spawn(ranks.run, 2, "gloo", "cpu",
                                         [("imported", 1, {})]):
        assert "torch" in modules and "lesionvae_tpu_torch" in modules
        assert not set(modules) & set(FORBIDDEN), sorted(set(modules) & set(FORBIDDEN))


def test_the_mesh_and_its_entry_points_default_to_cuda(tmp_path):
    """``make_mesh`` and every entry point that takes ``mesh=`` target the
    card unless told otherwise, and refuse a mesh on another device type;
    on a host without a card the mesh is a CUDA error, never a CPU mesh."""
    import inspect

    import torch
    import torch.distributed as dist

    from lesionvae_tpu_torch.parallel import mesh
    from lesionvae_tpu_torch.pipeline import geometry_run, infer, vae_run
    from lesionvae_tpu_torch.train import batched, trainer

    assert inspect.signature(mesh.make_mesh).parameters["device"].default == "cuda"
    assert inspect.signature(mesh.spawn).parameters["device"].default == "cuda"
    for fn in (batched.launch_many_vaes, trainer.train_lesion_vae,
               vae_run.run_vae_analysis, infer.score_cohort,
               geometry_run.launch_bundle_metrics, geometry_run.batched_bundle_metrics):
        params = inspect.signature(fn).parameters
        assert params["device"].default == "cuda" and params["mesh"].default is None, fn
    with pytest.raises(ValueError, match="the mesh's rank holds cpu, the call asks for cuda"):
        geometry_run.batched_bundle_metrics([[np.zeros((4, 3))]],
                                            mesh=mesh.Mesh(1, 1, 0, "cpu"))
    if torch.cuda.is_available():
        pytest.skip("a card is present; this checks the CPU-only host")
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh.spawn(print, 2)
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            mesh.make_mesh()
        cpu = mesh.make_mesh(device="cpu")
        assert cpu.device == torch.device("cpu") and cpu.shape == {"data": 1, "model": 1}
        with pytest.raises(ValueError, match="2 devices asked, 1 ranks"):
            mesh.make_mesh(2, device="cpu")
    finally:
        dist.destroy_process_group()
