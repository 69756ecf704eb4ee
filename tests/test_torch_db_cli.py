"""The port's commands with the DB storage backend against the JAX CLI.

One synthetic library with gradient and z-gap variants (testing.py):
the targets as two libraries of the store, the masks as a third and as
a zip. Each case runs the same commands through the JAX CLI and the
port's (``--device cpu``), each on a store of its own that starts from
the same stage (empty, after createColorDepthSearchDataInput, after the
colorDepthSearch), and the two stores must be equal in canonical form
(testing.canonical_store). The cases cover the selector scope of the JAX
tests/test_cli_db_pipeline.py: mask published names, target libraries,
match tags, processing tags on the neurons, windows, the re-run upsert,
zip entries, and the normalize of a DB run against the same command on
files.
"""

import shutil
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch

from colormipsearch_tpu.cli import main as jax_main
from colormipsearch_tpu_torch import testing
from colormipsearch_tpu_torch.cli import main as torch_main

torch.set_num_threads(2)
MAINS = {"jax": jax_main.main, "port": torch_main.main}
DEVICE_COMMANDS = ("colorDepthSearch", "gradientScores")
CDS = ["--maskThreshold", "20", "--dataThreshold", "20",
       "--pixColorFluctuation", "2.0", "--xyShift", "2", "--mirrorMask",
       "--no-name-labels", "--no-colormap-labels", "--pctPositivePixels",
       "0", "--cdsConcurrency", "1"]
GS = ["--maskThreshold", "20", "--mirrorMask", "--no-name-labels",
      "--no-colormap-labels", "--negativeRadius", "4", "--cdsConcurrency",
      "1"]
N_TARGETS, N_MASKS = 12, 6


def _run(pkg: str, argv, cfg: Path, env=None, monkeypatch=None) -> None:
    argv = [str(a) for a in argv] + ["--config", str(cfg)]
    if pkg == "port" and argv[0] in DEVICE_COMMANDS:
        argv += ["--device", "cpu"]
    if env:
        for k, v in env.items():
            monkeypatch.setenv(k, v)
    try:
        assert MAINS[pkg](argv) == 0, argv
    finally:
        for k in env or ():
            monkeypatch.delenv(k)


def _config(path: Path, store: Path) -> Path:
    path.write_text(f"Store.Type=sqlite\nStore.Path={store}\n")
    return path


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    """The library's files, and for each package the stores after the
    inputs, the search and the shape pass: {stage: {pkg: store path}}."""
    root = tmp_path_factory.mktemp("dbcli")
    rng = np.random.default_rng(23)
    images = testing.synthetic_library(rng, N_TARGETS, N_MASKS - 1, 48, 72,
                                       target_fg=0.3, mask_fg=0.1)
    corner = np.zeros_like(images.targets[3])
    corner[-14:, -18:] = images.targets[3][-14:, -18:]
    images.masks.append(corner)
    testing.write_neuron_images(
        root / "targets", images.targets, "t",
        gradients=[testing.synthetic_gradient(rng, t)
                   for t in images.targets],
        zgaps=[testing.synthetic_zgap(t, radius=4)
               for t in images.targets[:-1]] + [images.targets[-1]],
        threads=2)
    # the last target's z-gap is missing: the shape pass dilates instead
    (root / "targets" / "zgap" / f"t{N_TARGETS - 1:05d}_20pxRGB.png") \
        .unlink()
    testing.write_neuron_images(root / "masks", images.masks, "m",
                                threads=2)
    with zipfile.ZipFile(root / "masks.zip", "w") as z:
        for p in sorted((root / "masks").glob("*.png")):
            z.write(p, f"inner/{p.name}")
    stages, previous = {}, None
    for stage, steps in (("inputs", INPUT_STEPS), ("searched", SEARCH),
                         ("scored", [[*GSDB, "--processing-tag", "g1"]])):
        stages[stage] = {}
        for pkg in MAINS:
            store = root / f"{stage}_{pkg}.sqlite"
            if previous:
                shutil.copy(stages[previous][pkg], store)
            cfg = _config(root / f"{stage}_{pkg}.properties", store)
            for argv in steps:
                _run(pkg, _in(argv, root), cfg)
            stages[stage][pkg] = store
        previous = stage
    return root, stages


def _in(argv, root: Path, tmp: Path | None = None, pkg: str = ""):
    """`argv` with "@lib/" the library's directory, "@tmp/" a directory
    of the package's own and "{pkg}" the package's name."""
    out = []
    for a in argv:
        if a.startswith("@lib/"):
            a = str(root / a[5:])
        elif a.startswith("@tmp/"):
            a = str(tmp / pkg / a[5:])
        out.append(a.replace("{pkg}", pkg))
    return out


VARIANTS = ["--gradients-location", "@lib/targets/grad", "--zgap-location",
            "@lib/targets/zgap"]
INPUT_STEPS = [
    ["createColorDepthSearchDataInput", "-i", "@lib/targets:0:7", "-l",
     "tlibA", "--alignment-space", "AS", *VARIANTS, "--mips-storage",
     "DB"],
    ["createColorDepthSearchDataInput", "-i", "@lib/targets:7:5", "-l",
     "tlibB", "--alignment-space", "AS", *VARIANTS, "--tag", "late",
     "--mips-storage", "DB"],
    ["createColorDepthSearchDataInput", "-i", "@lib/masks", "-l", "mlib",
     "--alignment-space", "AS", "--tag", "mt", "--mips-storage", "DB"],
]
SEARCH = [["colorDepthSearch", "-m", "mlib", "-i", "tlibA", "tlibB",
           "--mips-storage", "DB", "--results-storage", "DB",
           "--processing-tag", "r1", *CDS]]
GSDB = ["gradientScores", "--matches", "mlib", "--results-storage", "DB",
        *GS]
NORM = ["normalizeGradientScores", "--matches", "mlib",
        "--results-storage", "DB"]


def _matches(store) -> dict:
    return testing.store_match_rows(store)


def _scored(store) -> set:
    return {k for k, v in _matches(store).items() if "gradientAreaGap" in v}


def _tagged(store, ptype: str, tag: str) -> set:
    return {d["mipId"] for d in testing.store_collections(store)
            ["neuronMetadata"] if tag in (d.get("processedTags") or {})
            .get(ptype, ())}


def _ids(store) -> dict:
    cols = testing.store_collections(store)
    return {name: sorted(str(d["_id"]) for d in docs)
            for name, docs in cols.items()}


def check_inputs(root, stores, before):
    neurons = testing.canonical_store(stores["port"])["neuronMetadata"]
    assert len(neurons) == N_TARGETS + N_MASKS
    late = [n for n in neurons if n["libraryName"] == "tlibB"]
    assert len(late) == 5 and all(n["tags"] == ["late"] for n in late)
    assert sum("ZGapImage" in n["computeFiles"] for n in neurons) == \
        N_TARGETS - 1


def check_rerun_keeps_ids(root, stores, before):
    """A second run upserts: no new row, every id kept, bookkeeping
    kept."""
    assert _ids(stores["port"]) == _ids(before["port"])


def check_zip(root, stores, before):
    neurons = testing.canonical_store(stores["port"])["neuronMetadata"]
    zipped = [n for n in neurons if n["libraryName"] == "zlib"]
    assert len(zipped) == N_MASKS
    assert all(isinstance(n["computeFiles"]["InputColorDepthImage"], dict)
               for n in zipped)
    # the re-import kept the tags the shape pass stored
    assert any("GradientScore" in (n.get("processedTags") or {})
               for n in zipped)


def check_search(root, stores, before):
    rows = _matches(stores["port"])
    assert len(rows) >= 10 and len({k[0] for k in rows}) >= 3
    assert all(r["tags"] == ["r1"] for r in rows.values())


def check_search_scope(root, stores, before):
    masks = {k[0][0] for k in _matches(stores["port"])}
    targets = {k[1][1] for k in _matches(stores["port"])}
    assert masks and masks <= {"m00001", "m00002"} and targets == {"tlibB"}


def check_fs_mips(root, stores, before):
    neurons = testing.canonical_store(stores["port"])["neuronMetadata"]
    # the neurons of the matches, stored by the flush; no duplicate
    keys = [(n["mipId"], n["libraryName"]) for n in neurons]
    assert len(keys) == len(set(keys)) and len(_matches(stores["port"]))


def check_all_scored(root, stores, before):
    rows = _matches(stores["port"])
    assert _scored(stores["port"]) == set(rows)
    assert _tagged(stores["port"], "GradientScore", "g1") == \
        {m for pair in rows for m, _lib in pair}


def check_mask_names_scope(root, stores, before):
    scored = _scored(stores["port"])
    assert scored and {k[0][0] for k in scored} == {"m00000"}
    assert {k[1][0] for k in scored} == {"t00006"}


def check_target_libraries(root, stores, before):
    scored = _scored(stores["port"])
    assert scored and {k[1][1] for k in scored} == {"tlibA"}


def check_match_tags(root, stores, before):
    assert not _scored(stores["port"])


def check_processing_tag_scope(root, stores, before):
    """The second run reaches only the masks the first run tagged."""
    second = _tagged(stores["port"], "GradientScore", "g2")
    first = _tagged(stores["port"], "GradientScore", "g1")
    assert {m for m in second if m.startswith("m")} == {"m00000"}
    assert {m for m in first if m.startswith("m")} == {"m00000"}


def check_window(root, stores, before):
    masks = {k[0][0] for k in _scored(stores["port"])}
    assert masks and len(masks) <= 2 and "m00000" not in masks


def check_normalized(root, stores, before):
    rows = _matches(stores["port"])
    eligible = [r for r in rows.values() if r.get("gradientAreaGap", -1)
                >= 0]
    assert eligible and all("normalizedScore" in r for r in eligible)
    assert _tagged(stores["port"], "NormalizeGradientScore", "n1")


def check_normalize_scope(root, stores, before):
    """Only m00000's rows and neurons are touched."""
    changed = {k[0][0] for k, r in _matches(stores["port"]).items()
               if r.get("normalizedScore")
               != _matches(before["port"])[k].get("normalizedScore")}
    assert changed <= {"m00000"}
    assert {m for m in _tagged(stores["port"], "NormalizeGradientScore",
                               "n2") if m.startswith("m")} == {"m00000"}


# name: (stage the stores start from, steps, environment, check)
CASES = {
    "data_input": (None, INPUT_STEPS, None, check_inputs),
    "data_input_rerun": ("inputs", INPUT_STEPS[2:], None,
                         check_rerun_keeps_ids),
    "data_input_zip_twice": ("inputs", [
        ["createColorDepthSearchDataInput", "-i", "@lib/masks.zip", "-l",
         "zlib", "--mips-storage", "DB"],
        ["colorDepthSearch", "-m", "zlib", "-i", "tlibA", "tlibB",
         "--mips-storage", "DB", "--results-storage", "DB", *CDS],
        [*GSDB[:2], "zlib", *GSDB[3:], "--processing-tag", "z1"],
        ["createColorDepthSearchDataInput", "-i", "@lib/masks.zip", "-l",
         "zlib", "--mips-storage", "DB"]], None, check_zip),
    "search": ("inputs", SEARCH, None, check_search),
    "search_rerun": ("searched", SEARCH, None, check_rerun_keeps_ids),
    "search_scope": ("inputs", [
        ["colorDepthSearch", "-m", "mlib:1:4", "-i", "tlibA", "tlibB",
         "--masks-length", "2", "--targets-tags", "late",
         "--mips-storage", "DB", "--results-storage", "DB", *CDS]],
        None, check_search_scope),
    "search_fs_mips_db_results": (None, [
        ["createColorDepthSearchDataInput", "-i", "@lib/targets", "-l",
         "tlib", *VARIANTS, "-od", "@tmp/", "--output-filename",
         "t.json"],
        ["createColorDepthSearchDataInput", "-i", "@lib/masks", "-l",
         "mlib", "-od", "@tmp/", "--output-filename", "m.json"],
        ["colorDepthSearch", "-m", "@tmp/m.json", "-i", "@tmp/t.json",
         "--results-storage", "DB", *CDS]], None, check_fs_mips),
    "gradient_scores": ("searched", [[*GSDB, "--processing-tag", "g1"]],
                        None, check_all_scored),
    "gradient_scores_device_store": ("searched", [
        [*GSDB, "--processing-tag", "g1", "--packed-variants-store",
         "@tmp/store"]], {"CDS_SHAPE_STORE_DEVICE": "1"},
        check_all_scored),
    "gs_mask_and_target_names": ("searched", [
        [*GSDB, "--masks-published-names", "m00000",
         "--targets-published-names", "t00006", "--match-tags", "r1"]],
        None, check_mask_names_scope),
    "gs_target_libraries": ("searched", [
        [*GSDB, "--targets-libraries", "tlibA"]], None,
        check_target_libraries),
    "gs_match_tags": ("searched", [[*GSDB, "--match-tags", "no-such-run"]],
                      None, check_match_tags),
    "gs_masks_processing_tags": ("searched", [
        [*GSDB, "--masks-published-names", "m00000", "--processing-tag",
         "g1"],
        [*GSDB, "--masks-processing-tags", "GradientScore:g1;other",
         "--processing-tag", "g2"]], None, check_processing_tag_scope),
    "gs_window": ("searched", [
        [*GSDB[:2], "mlib:1:3", *GSDB[3:], "--matches-length", "2"]],
        None, check_window),
    "normalize": ("scored", [[*NORM, "--processing-tag", "n1"]], None,
                  check_normalized),
    "normalize_scope": ("scored", [
        [*NORM, "--masks-published-names", "m00000", "--pctPositivePixels",
         "1", "--processing-tag", "n2"]], None, check_normalize_scope),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_db_commands_equal_jax(lib, case, tmp_path, monkeypatch):
    root, stages = lib
    start, steps, env, check = CASES[case]
    stores, before = {}, {}
    for pkg in MAINS:
        store = tmp_path / f"{pkg}.sqlite"
        if start is not None:
            shutil.copy(stages[start][pkg], store)
            before[pkg] = tmp_path / f"{pkg}_before.sqlite"
            shutil.copy(store, before[pkg])
        cfg = _config(tmp_path / f"{pkg}.properties", store)
        for argv in steps:
            _run(pkg, _in(argv, root, tmp_path, pkg), cfg, env, monkeypatch)
        stores[pkg] = store
    assert testing.canonical_store(stores["port"]) == \
        testing.canonical_store(stores["jax"])
    check(root, stores, before)


def test_normalize_on_db_equals_normalize_on_files(lib, tmp_path):
    """gradientScores then normalizeGradientScores on the DB give the
    scores the same commands give on files (float32 round trips
    included), row for row, in both packages."""
    root, stages = lib
    for pkg, main in MAINS.items():
        dev = ["--device", "cpu"] if pkg == "port" else []
        store = tmp_path / f"{pkg}.sqlite"
        shutil.copy(stages["scored"][pkg], store)
        cfg = _config(tmp_path / f"{pkg}.properties", store)
        _run(pkg, [*NORM, "--pctPositivePixels", "1"], cfg)
        # the same commands on files, from the store's neurons
        fs = tmp_path / f"{pkg}_fs"
        for name, lib_name in (("targets", "tlibA"), ("masks", "mlib")):
            argv = ["createColorDepthSearchDataInput", "-i",
                    str(root / name), "-l", lib_name, "--alignment-space",
                    "AS", "-od", str(fs), "--output-filename",
                    f"{name}.json"]
            if name == "targets":
                argv += _in(VARIANTS, root)
            assert main(argv) == 0
        out = ["-od", str(fs), "--perMaskSubdir", "masks"]
        assert main(["colorDepthSearch", "-m", str(fs / "masks.json"),
                     "-i", str(fs / "targets.json"), "--processing-tag",
                     "r1", *CDS, *out, *dev]) == 0
        assert main(["gradientScores", "--matches", str(fs / "masks"),
                     *GS, *out, *dev]) == 0
        assert main(["normalizeGradientScores", "--matches",
                     str(fs / "masks"), "--pctPositivePixels", "1",
                     *out]) == 0
        def eligible(rows):
            return {k: v for k, v in rows.items()
                    if v.get("gradientAreaGap", -1) >= 0
                    and v["matchingPixelsRatio"] >= 0.01}

        files = eligible(testing.fs_match_rows(fs / "masks", key="image"))
        db = eligible(testing.store_match_rows(store, key="image"))
        assert db and files == db, pkg
