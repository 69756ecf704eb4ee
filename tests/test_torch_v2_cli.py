"""The port's v2 file-pipeline commands against the JAX CLI.

searchFromJSON, searchLocalFiles (with and without the fused shape
pass), gradientScore, gradientScoresFromMatchedResults and mergeResults
run in both packages on the same synthetic library (``--device cpu``
for the port: the kernels' plain versions), and every result file must
be byte-identical. The JAX fused shape pass meshes over the tests' 8
virtual CPU devices; the port scores on one device, and the files agree
all the same.
"""

import json
import os

import numpy as np
import pytest
import torch

from colormipsearch_tpu.cli import main as jax_main
from colormipsearch_tpu.dataio import v2_io as jax_v2
from colormipsearch_tpu_torch import testing
from colormipsearch_tpu_torch.cli import main as torch_main

torch.set_num_threads(2)
H, W = 48, 72
FLAGS = ["--maskThreshold", "20", "--dataThreshold", "20",
         "--pixColorFluctuation", "1.0", "--xyShift", "2", "--mirrorMask",
         "--no-name-labels", "--no-colormap-labels", "--cdsConcurrency", "2"]
# the shape flags of gradientScore (it takes no pixel-match flags)
GS_FLAGS = ["--maskThreshold", "20", "--mirrorMask", "--no-name-labels",
            "--no-colormap-labels", "--negativeRadius", "4",
            "--cdsConcurrency", "2"]
DEVICE_COMMANDS = ("searchFromJSON", "searchLocalFiles", "gradientScore")


def _tree(root):
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def _both(tmp_path, *argv):
    """Run one command in both packages with -od tmp_path/{port,jax};
    the two result trees must be byte-identical. Returns the port's."""
    argv = [str(a) for a in argv]
    device = ["--device", "cpu"] if argv[0] in DEVICE_COMMANDS else []
    assert torch_main.main([*argv, *device,
                            "-od", str(tmp_path / "port")]) == 0
    assert jax_main.main([*argv, "-od", str(tmp_path / "jax")]) == 0
    port, ref = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    assert port.keys() == ref.keys()
    for name in port:
        assert port[name] == ref[name], name
    return port


def _results(tree):
    """{file: rows} of the v2 result files of a tree (no cdsparams)."""
    return {name: json.loads(doc)["results"] for name, doc in tree.items()
            if not name.endswith("cdsparams.json")}


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    """12 targets with gradient and z-gap variants (target 5 without a
    z-gap: the dilation fallback) and 5 masks, as PNGs; their v2 MIP
    lists; and, from the JAX CLI, a pixel-only searchLocalFiles result
    directory and a fused one with per-target files (the reverse
    results of the transfer)."""
    tmp = tmp_path_factory.mktemp("v2")
    rng = np.random.default_rng(63)
    targets = [testing.synthetic_cdm(rng, H, W, fg_fraction=0.08)
               for _ in range(12)]
    # targets 4-11 share their left two thirds with one of targets 0-3,
    # so a mask cut from one of those matches several targets
    for k in range(4, 12):
        targets[k][:, :2 * W // 3] = targets[k % 4][:, :2 * W // 3]
    masks = [testing.cut_mask(rng, targets[k], shift=(0, 0), mirror=k == 2)
             for k in range(4)]
    masks.append(testing.synthetic_cdm(rng, H, W, fg_fraction=0.03))
    testing.write_neuron_images(
        tmp / "targets", targets, "t",
        gradients=[testing.synthetic_gradient(rng, t) for t in targets],
        zgaps=[testing.synthetic_zgap(t, radius=4) for t in targets],
        threads=2)
    os.remove(tmp / "targets" / "zgap" / "t00005_20pxRGB.png")
    testing.write_neuron_images(tmp / "masks", masks, "m", threads=2)
    for name in ("targets", "masks"):
        assert jax_main.main(["createColorDepthSearchJSONInput", "-i",
                              str(tmp / name), "-od",
                              str(tmp / "lists")]) == 0
    assert jax_main.main(["searchLocalFiles", "-m", str(tmp / "masks"),
                          "-i", str(tmp / "targets"), *FLAGS,
                          "-od", str(tmp / "pixel")]) == 0
    assert jax_main.main(["searchLocalFiles", "-m", str(tmp / "masks"),
                          "-i", str(tmp / "targets"), *FLAGS,
                          "--with-grad-scores",
                          "-gp", str(tmp / "targets" / "grad"),
                          "-zgp", str(tmp / "targets" / "zgap"),
                          "--negativeRadius", "4",
                          "--perLibrarySubdir", "bylib",
                          "-od", str(tmp / "fused")]) == 0
    assert len(_results(_tree(tmp / "pixel"))) >= 4
    return tmp


@pytest.mark.parametrize("case", ["inline", "index"])
def test_search_from_json_identical_to_jax(lib, tmp_path, case):
    """searchFromJSON with an inline :offset:length on the lists, and
    with --masks-index / --masks-length / --images-index applied to lists
    without one."""
    masks, targets = lib / "lists" / "masks.json", \
        lib / "lists" / "targets.json"
    if case == "inline":
        spec = ["-m", f"{masks}:1:3", "-i", f"{targets}:2:9"]
    else:
        spec = ["-m", masks, "--masks-index", "1", "--masks-length", "2",
                "-i", targets, "--images-index", "1"]
    port = _both(tmp_path, "searchFromJSON", *spec, *FLAGS)
    assert any(_results(port).values())
    assert "masks-targets-cdsparams.json" in port


@pytest.mark.parametrize("case", ["pixel", "fused"])
def test_search_local_files_identical_to_jax(lib, tmp_path, case):
    """searchLocalFiles alone and with the fused shape pass, the per-target
    files of --perLibrarySubdir and a --search-name record."""
    extra = []
    if case == "fused":
        extra = ["--with-grad-scores", "-gp", lib / "targets" / "grad",
                 "-zgp", lib / "targets" / "zgap", "--negativeRadius", "4",
                 "--perLibrarySubdir", "bylib", "--search-name",
                 "fused-cdsparams.json"]
    port = _both(tmp_path, "searchLocalFiles", "-m", f"{lib / 'masks'}:0:3",
                 "-i", lib / "targets", *FLAGS, *extra)
    rows = [r for rs in _results(port).values() for r in rs]
    assert rows
    if case == "fused":
        assert "fused-cdsparams.json" in port
        assert any(k.startswith("bylib/") for k in port)
        assert all(r["gradientAreaGap"] >= 0 for r in rows)
    else:
        assert not any("gradientAreaGap" in r for r in rows)
        assert _tree(lib / "pixel").keys() >= {
            k for k in port if not k.endswith("cdsparams.json")}


@pytest.mark.parametrize("case", ["device", "oracle", "store", "border",
                                  "top"])
def test_gradient_score_identical_to_jax(lib, tmp_path, case):
    """gradientScore through the split kernel's plain version, the float64
    oracle (--no-use-device), the packed-variant store (built by the first
    run, read by the second), --border and the top-* selection; the
    device route writes what the oracle writes."""
    variants = ["-gp", lib / "targets" / "grad", "-zgp",
                lib / "targets" / "zgap"]
    src = ["-rd", lib / "pixel"]
    extra = {"device": [], "oracle": ["--no-use-device"], "border":
             ["--border", "3"], "store": [], "top": [
                 "--topPublishedNameMatches", "2",
                 "--topPublishedSampleMatches", "1",
                 "--topMatchesPerSample", "1"]}[case]
    if case == "top":
        src = ["-rd", f"{lib / 'pixel'}:0:2"]
    if case == "store":
        for name in ("port", "jax"):
            main = torch_main.main if name == "port" else jax_main.main
            device = ["--device", "cpu"] if name == "port" else []
            for run in ("first", "second"):
                assert main([str(a) for a in (
                    "gradientScore", *src, *variants, *GS_FLAGS,
                    "--packed-variants-store", tmp_path / f"{name}_store",
                    "-od", tmp_path / f"{name}_{run}")] + device) == 0
            assert _tree(tmp_path / f"{name}_first") == \
                _tree(tmp_path / f"{name}_second")
        assert _tree(tmp_path / "port_second") == \
            _tree(tmp_path / "jax_second")
        return
    port = _both(tmp_path, "gradientScore", *src, *variants, *GS_FLAGS,
                 *extra)
    rows = [r for rs in _results(port).values() for r in rs]
    assert any(r.get("gradientAreaGap", -1) >= 0 for r in rows)
    if case == "oracle":
        _both(tmp_path / "device", "gradientScore", *src, *variants,
              *GS_FLAGS)
        assert _tree(tmp_path / "device" / "port") == port
    if case == "top":
        # 2 lines x 1 sample x 1 match a mask: the rest is not written
        pixel = _results(_tree(lib / "pixel"))
        assert all(len(rs) <= 2 for rs in _results(port).values())
        assert max(len(pixel[k]) for k in _results(port)) > 2


def test_gradient_score_files_flag_takes_precedence(lib, tmp_path):
    """-rf names the files to rescore even when -rd is given too."""
    first = sorted((lib / "pixel").glob("m*.json"))[0]
    port = _both(tmp_path, "gradientScore", "-rd", lib / "pixel", "-rf",
                 first, "-gp", lib / "targets" / "grad", *GS_FLAGS)
    assert list(port) == [first.name]


@pytest.mark.parametrize("top", [False, True])
def test_reverse_transfer_identical_to_jax(lib, tmp_path, top):
    """gradientScoresFromMatchedResults copies the shape scores of the
    fused run's per-target files into the pixel-only files; with a top-*
    flag only the selected rows get a transfer and every row is still
    written."""
    extra = ["--topPublishedNameMatches", "1"] if top else []
    port = _both(tmp_path, "gradientScoresFromMatchedResults", "-rd",
                 lib / "pixel", "-revd", lib / "fused" / "bylib", *extra)
    pixel = _results(_tree(lib / "pixel"))
    got = _results(port)
    assert got.keys() == pixel.keys()
    assert all(len(got[k]) == len(pixel[k]) for k in got)
    transferred = sum("gradientAreaGap" in r for rs in got.values()
                      for r in rs)
    assert transferred > 0
    if not top:
        fused = _results(_tree(lib / "fused"))
        assert transferred == sum(len(rs) for k, rs in fused.items()
                                  if not k.startswith("bylib/"))


def _merge_inputs(lib, tmp_path):
    """Two halves of the target list searched apart, one rescored
    directory and a file with a row of matchingRatio 0."""
    targets = lib / "lists" / "targets.json"
    for name, spec in (("a", f"{targets}:0:6"), ("b", f"{targets}:6:6")):
        assert jax_main.main(["searchFromJSON", "-m",
                              str(lib / "lists" / "masks.json"), "-i",
                              spec, *FLAGS,
                              "-od", str(tmp_path / name)]) == 0
    g = jax_v2.read_cds_matches(sorted((tmp_path / "a").glob("m*.json"))[0])
    g.results[0].matchingRatio = 0.0
    jax_v2.write_cds_matches(g, tmp_path / "zero" / "m00000.json")
    return tmp_path / "a", tmp_path / "b", tmp_path / "zero"


@pytest.mark.parametrize("case", ["dirs", "cleanup", "files", "gate",
                                  "pct"])
def test_merge_results_identical_to_jax(lib, tmp_path, case):
    """mergeResults over -rd directories, with --cleanup and
    --excluded-names, with -rf files (which take precedence over -rd),
    and the ratio gate: a matchingRatio 0 row drops at the default 0.0,
    and --pctPositivePixels drops more."""
    a, b, zero = _merge_inputs(lib, tmp_path / "in")
    if case == "dirs":
        argv = ["-rd", a, b]
    elif case == "cleanup":
        pixel = _results(_tree(lib / "pixel"))
        first = next(r for rs in pixel.values() for r in rs)
        argv = ["-rd", a, b, lib / "fused", "--cleanup", "--excluded-names",
                first["publishedName"]]
    elif case == "files":
        argv = ["-rd", a, "-rf", *sorted(b.glob("m*.json")),
                lib / "fused" / "m00000.json"]
    elif case == "gate":
        argv = ["-rd", zero]
    else:
        argv = ["-rd", a, b, "--pctPositivePixels", "1.5"]
    port = _both(tmp_path, "mergeResults", *argv)
    merged = _results(port)
    assert merged and any(merged.values())
    if case == "dirs":
        # the halves merge back into the whole list's search
        assert jax_main.main(["searchFromJSON", "-m",
                              str(lib / "lists" / "masks.json"), "-i",
                              str(lib / "lists" / "targets.json"), *FLAGS,
                              "-od", str(tmp_path / "whole")]) == 0
        whole = _results(_tree(tmp_path / "whole"))

        def rows(res):
            return {k: sorted((r["id"], r["matchingPixels"], r.get("mirrored"))
                              for r in rs) for k, rs in res.items()}
        assert rows(merged) == rows(whole)
    if case == "files":
        assert set(merged) <= {p.name for p in b.glob("m*.json")} | {
            "m00000.json"}
    if case == "gate":
        zero_rows = _results(_tree(zero))["m00000.json"]
        assert len(merged["m00000.json"]) == len(zero_rows) - 1


def test_merge_without_inputs_and_cuda_without_gpu_fail(lib, tmp_path):
    with pytest.raises(SystemExit):
        torch_main.main(["mergeResults", "-od", str(tmp_path)])
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: --device cuda is valid here")
    for argv in (["searchLocalFiles", "-m", str(lib / "masks"), "-i",
                  str(lib / "targets")],
                 ["gradientScore", "-rd", str(lib / "pixel")]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            torch_main.main([*argv, "--device", "cuda",
                             "-od", str(tmp_path / "o")])
