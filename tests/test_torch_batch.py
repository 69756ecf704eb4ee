"""The port's batch launchers (colormipsearch_tpu_torch.scripts.cds_batch
and .ga_batch) against the JAX package's scripts/cds_batch.py and
scripts/ga_batch.py, on the CPU.

Every command line the port's launchers print equals the JAX script's
line with the module name changed and ``--device D`` put right after
``-od <dir>``; their job indices, tile isolation, merge note and error
exits are the JAX scripts'. A ``--device`` among the forwarded arguments
is refused. ``--run`` tiles the workload of
tests/test_cli_surface.py::test_cds_batch_target_split_tiles_merge (one
mask, two targets, one tile each; PNGs from testing.py) through the JAX
CLI and through the port's (``--device cpu``) in subprocesses on the same
paths, and the two merged trees must be byte-identical; so must the
``ga_batch --run`` trees over that result.
"""

import importlib.util
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from colormipsearch_tpu_torch import testing
from colormipsearch_tpu_torch.dataio.json_io import write_neurons_json
from colormipsearch_tpu_torch.scripts import cds_batch as tcds
from colormipsearch_tpu_torch.scripts import ga_batch as tga

REPO = Path(__file__).resolve().parents[1]


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_scripts_{name}", REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


jcds = _jax_script("cds_batch")
jga = _jax_script("ga_batch")


def _call(main, argv, capsys):
    """(exit code, stdout lines, stderr lines) of one in-process run."""
    try:
        rc = main(argv)
    except SystemExit as e:
        rc = e.code
    out, err = capsys.readouterr()
    return rc, out.splitlines(), err.splitlines()


def _ported(line: str, device: str) -> str:
    """A JAX launcher line as the port's launcher prints it."""
    words = line.split(" ")
    words = ["colormipsearch_tpu_torch.cli.main"
             if w == "colormipsearch_tpu.cli.main" else w for w in words]
    i = words.index("-od") + 2
    return " ".join(words[:i] + ["--device", device] + words[i:])


def _same_run(jax_run, port_run, device):
    """The port's run equals the JAX run but for the lines' module name,
    --device and the merge note's command."""
    (jrc, jout, jerr), (rc, out, err) = jax_run, port_run
    assert rc == jrc
    assert out == [_ported(line, device) for line in jout]
    if jrc != 0:
        # usage differs by --device; the error line is the same
        assert err[-1] == jerr[-1]
        return
    jnote, note = json.loads(jerr[-1]), json.loads(err[-1])
    jmerge, merge = jnote.pop("merge", None), note.pop("merge", None)
    assert note == jnote
    assert (merge is None) == (jmerge is None)
    if merge is not None:
        assert merge.split(" --merge-only ")[1] == \
            jmerge.split(" --merge-only ")[1]
        assert "-m colormipsearch_tpu_torch.scripts.cds_batch" in merge


CDS_GRIDS = {
    "target_split": ["--total-masks", "10", "--total-targets", "7",
                     "--masks-per-job", "5", "--targets-per-job", "4"],
    "mask_split": ["--total-masks", "10", "--total-targets", "4",
                   "--masks-per-job", "3"],
    "one_tile": ["--total-masks", "3", "--total-targets", "3"],
    "job_range": ["--total-masks", "10", "--total-targets", "7",
                  "--masks-per-job", "5", "--targets-per-job", "4",
                  "--first-job", "2", "--last-job", "3"],
    "job_first": ["--total-masks", "10", "--total-targets", "7",
                  "--masks-per-job", "5", "--targets-per-job", "4",
                  "--job", "1"],
    "job_last": ["--total-masks", "10", "--total-targets", "7",
                 "--masks-per-job", "5", "--targets-per-job", "4",
                 "--job", "4"],
    "job_0": ["--total-masks", "10", "--total-targets", "7",
              "--masks-per-job", "5", "--targets-per-job", "4",
              "--job", "0"],
    "job_past_end": ["--total-masks", "10", "--total-targets", "7",
                     "--masks-per-job", "5", "--targets-per-job", "4",
                     "--job", "5"],
    "last_job_past_end": ["--total-masks", "3", "--total-targets", "3",
                          "--last-job", "3"],
    "no_subdirs_target_split": ["--total-masks", "10", "--total-targets",
                                "7", "--masks-per-job", "5",
                                "--targets-per-job", "4",
                                "--no-tile-subdirs"],
    "no_subdirs_mask_split": ["--total-masks", "10", "--total-targets", "4",
                              "--masks-per-job", "3", "--no-tile-subdirs"],
    "missing_totals": [],
}
CDS_EXTRA = {"none": [], "per_target": ["--", "--perTargetSubdir", "t",
                                        "--maskThreshold", "20"]}


@pytest.mark.parametrize("extra", sorted(CDS_EXTRA))
@pytest.mark.parametrize("grid", sorted(CDS_GRIDS))
def test_cds_batch_lines_equal_jax(tmp_path, capsys, grid, extra):
    argv = ["--masks", "m.json", "--targets", "t.json", *CDS_GRIDS[grid],
            "-od", str(tmp_path / "out"), "--print", *CDS_EXTRA[extra]]
    jax_run = _call(jcds.main, argv, capsys)
    _same_run(jax_run, _call(tcds.main, ["--device", "cpu", *argv], capsys),
              "cpu")
    _same_run(jax_run, _call(tcds.main, argv, capsys), "cuda")
    if grid in ("job_0", "job_past_end", "last_job_past_end",
                "missing_totals"):
        assert jax_run[0] == 2
    if grid == "no_subdirs_target_split":
        assert jax_run[0] == 2 and "--no-tile-subdirs" in jax_run[2][-1]


GA_GRIDS = {
    "three_jobs": ["--mask-files-per-job", "2"],
    "one_job": [],
    "job_range": ["--mask-files-per-job", "2", "--first-job", "2",
                  "--last-job", "3"],
    "job_last": ["--mask-files-per-job", "2", "--job", "3"],
    "job_0": ["--mask-files-per-job", "2", "--job", "0"],
    "job_past_end": ["--mask-files-per-job", "2", "--job", "4"],
    "with_flags": ["--mask-files-per-job", "4", "--", "--maskThreshold",
                   "20", "--mirrorMask"],
}


@pytest.mark.parametrize("grid", sorted(GA_GRIDS))
def test_ga_batch_lines_equal_jax(tmp_path, capsys, grid):
    d = tmp_path / "m"
    d.mkdir()
    for i in range(5):
        (d / f"mask{i}.json").write_text("{}")
    (d / "notes.txt").write_text("")
    argv = ["--matches-dir", str(d), "-od", str(tmp_path / "out"),
            "--print", *GA_GRIDS[grid]]
    jax_run = _call(jga.main, argv, capsys)
    _same_run(jax_run, _call(tga.main, ["--device", "cpu", *argv], capsys),
              "cpu")
    _same_run(jax_run, _call(tga.main, argv, capsys), "cuda")
    if grid.startswith("job_") and grid != "job_last" \
            and grid != "job_range":
        assert jax_run[0] == 2


def test_ga_batch_empty_dir_equals_jax(tmp_path, capsys):
    argv = ["--matches-dir", str(tmp_path), "-od", str(tmp_path / "o")]
    jax_run = _call(jga.main, argv, capsys)
    assert jax_run[:2] == (0, [])
    _same_run(jax_run, _call(tga.main, argv, capsys), "cuda")


@pytest.mark.parametrize("launcher", ["cds", "ga"])
@pytest.mark.parametrize("flag", [["--device", "cpu"], ["--device=cuda"]])
def test_forwarded_device_is_refused(tmp_path, capsys, launcher, flag):
    if launcher == "cds":
        main = tcds.main
        argv = ["--masks", "m.json", "--targets", "t.json",
                "--total-masks", "2", "--total-targets", "2"]
    else:
        main = tga.main
        argv = ["--matches-dir", str(tmp_path)]
    rc, out, err = _call(main, [*argv, "-od", str(tmp_path / "o"),
                                "--print", "--", "--maskThreshold", "20",
                                *flag], capsys)
    assert rc == 2 and out == []
    assert "--device among the forwarded arguments" in err[-1]
    assert "launcher's own --device {cuda,cpu}" in err[-1]


def test_launcher_device_choices(capsys):
    rc, _, err = _call(tcds.main, ["--device", "cuda:1", "-od", "o"],
                       capsys)
    assert rc == 2 and "invalid choice" in err[-1]
    for main in (tcds.main, tga.main):
        rc, out, _ = _call(main, ["--help"], capsys)
        assert rc == 0 and "CUDA_VISIBLE_DEVICES" in "\n".join(out)


def test_module_entry_point_equals_jax_script(tmp_path):
    """`python -m colormipsearch_tpu_torch.scripts.cds_batch` prints the
    JAX script's lines (run as a file) but for module and device, and a
    merge note that names the port's module."""
    argv = ["--masks", "m.json", "--targets", "t.json",
            *CDS_GRIDS["target_split"], "-od", str(tmp_path / "o"),
            "--print"]
    env = dict(os.environ, PYTHONPATH=str(REPO))
    jax_run = subprocess.run(
        [sys.executable, str(REPO / "scripts" / "cds_batch.py"), *argv],
        capture_output=True, text=True, env=env, timeout=120)
    port_run = subprocess.run(
        [sys.executable, "-m", "colormipsearch_tpu_torch.scripts.cds_batch",
         "--device", "cpu", *argv],
        capture_output=True, text=True, env=env, timeout=120)
    _same_run(*[(r.returncode, r.stdout.splitlines(), r.stderr.splitlines())
                for r in (jax_run, port_run)], "cpu")
    assert len(port_run.stdout.splitlines()) == 4


# --- --run: the merged trees -----------------------------------------------

CDS_FLAGS = ["--maskThreshold", "20", "--dataThreshold", "20",
             "--pixColorFluctuation", "2.0", "--xyShift", "2",
             "--no-name-labels", "--no-colormap-labels",
             "--perMaskSubdir", "pm", "--cdsConcurrency", "2"]
GS_FLAGS = ["--maskThreshold", "20", "--no-name-labels",
            "--no-colormap-labels", "--negativeRadius", "4",
            "--perMaskSubdir", "masks", "--cdsConcurrency", "2"]


def _run_both(jax_main, port_main, argv, out_dir):
    """Each launcher's --run on the same paths: {name: snapshot}."""
    trees = {}
    for name, main in (("jax", jax_main), ("port", port_main)):
        shutil.rmtree(out_dir, ignore_errors=True)
        assert main(list(argv)) == 0, name
        trees[name] = testing.snapshot(out_dir)
    return trees


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    """tests/test_cli_surface.py's target-split workload as PNGs: one
    mask, two targets that are the mask's image (every tile matches),
    with gradient and z-gap variants for the shape pass."""
    tmp = tmp_path_factory.mktemp("batch")
    rng = np.random.default_rng(3)
    h, w = 40, 64
    img = np.zeros((h, w, 3), np.uint8)
    n = 400
    img[rng.integers(0, h, n), rng.integers(0, w, n)] = \
        rng.integers(0, 256, (n, 3))
    targets = testing.write_neuron_images(
        tmp / "lib", [img, img], "t",
        gradients=[testing.synthetic_gradient(rng, img) for _ in range(2)],
        zgaps=[testing.synthetic_zgap(img, radius=4)] * 2, threads=2)
    masks = testing.write_neuron_images(tmp / "lib", [img], "mask",
                                        threads=2)
    write_neurons_json(masks, tmp / "masks.json")
    write_neurons_json(targets, tmp / "targets.json")
    return tmp


@pytest.fixture(scope="module")
def cds_trees(workload):
    env = {"PYTHONPATH": str(REPO), "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=2"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        od = workload / "out"
        argv = ["--masks", str(workload / "masks.json"),
                "--targets", str(workload / "targets.json"),
                "--total-masks", "1", "--total-targets", "2",
                "--masks-per-job", "1", "--targets-per-job", "1",
                "-od", str(od), "--run", "--", *CDS_FLAGS]
        trees = _run_both(jcds.main,
                          lambda a: tcds.main(["--device", "cpu", *a]),
                          argv, od)
        gs_od = workload / "gs"
        gs_argv = ["--matches-dir", str(od / "pm"),
                   "--mask-files-per-job", "1", "-od", str(gs_od),
                   "--run", "--", *GS_FLAGS]
        gs_trees = _run_both(jga.main,
                             lambda a: tga.main(["--device", "cpu", *a]),
                             gs_argv, gs_od)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return trees, gs_trees


def test_cds_batch_run_tree_equals_jax(cds_trees):
    trees, _ = cds_trees
    assert trees["port"] == trees["jax"]
    tree = trees["port"]
    assert {"tiles/tile_1/pm/mask-00000.json",
            "tiles/tile_2/pm/mask-00000.json",
            "pm/mask-00000.json", "cdsParameters.json"} <= set(tree)
    doc = json.loads(tree["pm/mask-00000.json"])
    # both target tiles' matches in the merged per-mask file, ordered
    assert {r["image"]["mipId"] for r in doc["results"]} == \
        {"t-00000", "t-00001"}
    scores = [r["matchingPixels"] for r in doc["results"]]
    assert scores == sorted(scores, reverse=True)


def test_ga_batch_run_tree_equals_jax(cds_trees):
    _, gs_trees = cds_trees
    assert gs_trees["port"] == gs_trees["jax"]
    doc = json.loads(gs_trees["port"]["masks/mask-00000.json"])
    assert len(doc["results"]) == 2
    assert all(r["gradientAreaGap"] >= 0 for r in doc["results"])
