"""The port's normalizeGradientScores command against the JAX CLI.

The port's colorDepthSearch and gradientScores (``--device cpu``) make
the input: per-mask match files with shape scores, of which the
gradientScores run scored only the best lines. Then both packages
normalize copies of that tree under each of the command's three names,
with and without the --pctPositivePixels gate, and every file must be
byte-identical. The command is host only: it takes no --device.
"""

import json
import shutil

import numpy as np
import pytest
import torch

from colormipsearch_tpu.cli import main as jax_main
from colormipsearch_tpu_torch import testing
from colormipsearch_tpu_torch.cli import main as torch_main
from colormipsearch_tpu_torch.dataio.json_io import write_neurons_json

torch.set_num_threads(2)
H, W = 48, 72
CDS_FLAGS = ["--maskThreshold", "20", "--dataThreshold", "20",
             "--pixColorFluctuation", "1.0", "--xyShift", "2",
             "--mirrorMask", "--no-name-labels", "--no-colormap-labels",
             "--pctPositivePixels", "0", "--cdsConcurrency", "2"]
NAMES = ("normalizeGradientScores", "mormalizeGradientScores",
         "normalizeScores")


def _tree(root):
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*.json")) if p.is_file()}


@pytest.fixture(scope="module")
def scored(tmp_path_factory):
    """A gradientScores result tree of the port: 4 masks x 12 targets,
    the best 2 lines of each mask rescored, every normalizedScore 0."""
    tmp = tmp_path_factory.mktemp("norm")
    rng = np.random.default_rng(63)
    targets = [testing.synthetic_cdm(rng, H, W, fg_fraction=0.08)
               for _ in range(12)]
    # targets 4-11 share their left two thirds with one of targets 0-3,
    # so a mask cut from one of those matches several targets
    for k in range(4, 12):
        targets[k][:, :2 * W // 3] = targets[k % 4][:, :2 * W // 3]
    masks = [testing.cut_mask(rng, targets[k], shift=(0, 0), mirror=k == 2)
             for k in range(4)]
    write_neurons_json(testing.write_neuron_images(
        tmp / "lib", targets, "t",
        gradients=[testing.synthetic_gradient(rng, t) for t in targets],
        zgaps=[testing.synthetic_zgap(t, radius=4) for t in targets],
        threads=2), tmp / "targets.json")
    write_neurons_json(testing.write_neuron_images(
        tmp / "lib", masks, "m", threads=2), tmp / "masks.json")
    assert torch_main.main([
        "colorDepthSearch", "-m", str(tmp / "masks.json"), "-i",
        str(tmp / "targets.json"), "--device", "cpu", "-od",
        str(tmp / "gs"), "--perMaskSubdir", "masks", *CDS_FLAGS]) == 0
    assert torch_main.main([
        "gradientScores", "--matches", str(tmp / "gs" / "masks"),
        "--device", "cpu", "-od", str(tmp / "gs"), "--perMaskSubdir",
        "masks", "--maskThreshold", "20", "--mirrorMask",
        "--no-name-labels", "--no-colormap-labels", "--negativeRadius", "4",
        "--nBestLines", "2", "--cdsConcurrency", "2"]) == 0
    # zero every normalizedScore, so the rows the command rescores show
    for path in (tmp / "gs" / "masks").glob("*.json"):
        doc = json.loads(path.read_text())
        for row in doc["results"]:
            row["normalizedScore"] = 0.0
        path.write_text(json.dumps(doc, indent=2))
    tree = _tree(tmp / "gs" / "masks")
    assert len(tree) == 4
    assert all(b'"gradientAreaGap"' in doc for doc in tree.values())
    return tmp / "gs"


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("pct", [None, "80"])
def test_normalize_identical_to_jax(scored, tmp_path, name, pct):
    trees = {}
    for side, main in (("port", torch_main.main), ("jax", jax_main.main)):
        root = tmp_path / side
        shutil.copytree(scored, root)
        argv = [name, "--matches", str(root / "masks"), "-od", str(root),
                "--perMaskSubdir", "masks"]
        if pct is not None:
            argv += ["--pctPositivePixels", pct]
        assert main(argv) == 0
        trees[side] = _tree(root)
    assert trees["port"].keys() == trees["jax"].keys()
    for k in trees["port"]:
        assert trees["port"][k] == trees["jax"][k], k
    rescored = b"".join(trees["port"].values())
    # every row written is rescored; the files keep only eligible rows, so
    # the one below the gate (a matchingPixelsRatio of 0.73) goes
    assert b'"normalizedScore": 0.0' not in rescored
    assert (b'"t-00004"' in rescored) == (pct is None)


def test_normalize_needs_an_output_dir(scored, capsys):
    assert torch_main.main(["normalizeGradientScores", "--matches",
                            str(scored / "masks")]) == 2
    assert "--outputDir is required" in capsys.readouterr().err
