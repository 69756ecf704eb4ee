"""The port's admin commands against the JAX CLI, and the CLI's surface.

legacyImport (to files and into a store), validateDBData (files and the
store), copyToMipsStore, copyMIPSegmentation and precomputeVariants run
through both CLIs on the same synthetic inputs (testing.py, seeded with
numpy) and the same paths (testing.run_clis). Result and metadata files
are compared byte for byte, stores in canonical form
(testing.canonical_store), validateDBData's summary line as printed, and
precomputeVariants' PNGs by their names and decoded pixels (PIL, which
writes the JAX package's, chooses its own zlib level and row filters).
The cases cover those of the JAX tests/test_cli_admin_commands.py
(legacy import to files, to a store and its tags; validation of files,
the selector and the gradient-file skip; the copy to a store). The
surface test holds the port's parser to the JAX one: the same
subcommands and aliases, each with its help.
"""

import argparse
import json
import os
import shutil
import sqlite3
from pathlib import Path

import numpy as np
import pytest

import colormipsearch_tpu.model as j_model
import colormipsearch_tpu.persist as j_persist
import colormipsearch_tpu_torch.model as t_model
import colormipsearch_tpu_torch.persist as t_persist
from colormipsearch_tpu.cli import main as jax_main
from colormipsearch_tpu.io.image import read_image as jax_read_image
from colormipsearch_tpu_torch import testing
from colormipsearch_tpu_torch.cli import main as torch_main
from colormipsearch_tpu_torch.dataio.json_io import write_neurons_json
from colormipsearch_tpu_torch.io.image import read_image
from colormipsearch_tpu_torch.io.png import write_png

MAINS = {"jax": jax_main.main, "port": torch_main.main}
MODELS = {"jax": j_model, "port": t_model}
PERSIST = {"jax": j_persist, "port": t_persist}
NEW_COMMANDS = ("legacyImport", "validateDBData", "copyToMipsStore",
                "uploadData", "groupMIPsByPublishedName",
                "replaceAttributes", "mergeMips", "copyMIPSegmentation",
                "precomputeVariants")


def _same(runs: dict) -> tuple:
    """The port's (exit code, stdout, outputs), which must equal JAX's."""
    assert runs["port"] == runs["jax"]
    return runs["port"]


def _config(path: Path, store: Path) -> Path:
    path.write_text(f"Store.Type=sqlite\nStore.Path={store}\n")
    return path


# -------------------------------------------------------------------------
# legacyImport
# -------------------------------------------------------------------------


@pytest.fixture(scope="module")
def v2_results(tmp_path_factory):
    root = tmp_path_factory.mktemp("v2")
    files = testing.write_v2_results(root, np.random.default_rng(5), 6, 9)
    return root, files


LEGACY_FS_CASES = {
    "files": lambda f: ["-rf", *f[:4]],
    "dir": lambda f: ["-rd", os.path.dirname(f[0])],
    "results_spec": lambda f: ["-r", f"{os.path.dirname(f[0])}:1:3", f[5]],
    "libraries_tag": lambda f: ["-rf", *f, "--mask-library", "flyem_other",
                                "--target-library", "Split GAL4",
                                "--alignment-space", "JRC2018_VNC",
                                "--tag", "v2-import"],
    "no_tag_compact": lambda f: ["-rd", os.path.dirname(f[0]), "--tag", "",
                                 "--no-pretty-print", "-ps", "7"],
}


@pytest.mark.parametrize("case", sorted(LEGACY_FS_CASES))
def test_legacy_import_fs_identical_to_jax(v2_results, tmp_path, case):
    """v2 result files (current and legacy shape) -> per-mask v3 match
    files, byte for byte."""
    _, files = v2_results
    out = tmp_path / "v3"
    rc, _, (tree,) = _same(testing.run_clis(
        MAINS, ["legacyImport", *LEGACY_FS_CASES[case](files), "-od", out],
        outputs=[out]))
    assert rc == 0 and tree
    doc = json.loads(next(iter(tree.values())))
    assert doc["inputImage"]["class"].endswith("EMNeuronEntity")
    assert all(r["image"]["class"].endswith("LMNeuronEntity")
               for r in doc["results"])
    scores = [r["normalizedScore"] for r in doc["results"]]
    assert scores == sorted(scores, reverse=True)
    assert any(r.get("gradientAreaGap") for r in doc["results"])


def _seed_store(pkg: str, cfg: Path, known: list) -> None:
    """Neurons already in the store before the import: `known` (mipId,
    library, tags) of the v2 masks and targets."""
    m = MODELS[pkg]
    daos = PERSIST[pkg].DaosProvider(PERSIST[pkg].Config(str(cfg)))
    for mip, lib, tags in known:
        cls = m.EMNeuron if lib.startswith("flyem") else m.LMNeuron
        daos.neuron_metadata_dao.create_or_update(cls(
            mip_id=mip, library_name=lib, published_name=mip.upper(),
            tags=set(tags)))
    daos.store.close()


LEGACY_DB_CASES = {
    "empty_store": ([], []),
    "known_neurons": ([("em0", "flyem_hemibrain_1_2_1", ()),
                       ("em1", "flyem_hemibrain_1_2_1", ()),
                       ("lm0", "FlyLight Gen1 MCFO", ()),
                       ("lm1", "FlyLight Gen1 MCFO", ("seed",)),
                       ("lm2", "FlyLight Gen1 MCFO",
                        ("Created by import",))], []),
    "custom_tags": ([("em2", "flyem_hemibrain_1_2_1", ())],
                    ["--imported-neuron-tag", "new", "--suspicious-match-tag",
                     "check", "--tag", "v2"]),
}


@pytest.mark.parametrize("case", sorted(LEGACY_DB_CASES))
def test_legacy_import_db_identical_to_jax(v2_results, tmp_path, case):
    """Into a store: the stores are equal in canonical form; the neurons
    the store lacked carry the import tag, and exactly the matches with
    such a neuron the suspicious-match tag."""
    known, flags = LEGACY_DB_CASES[case]
    _, files = v2_results
    canon = {}
    for pkg, main in MAINS.items():
        cfg = _config(tmp_path / f"{pkg}.properties",
                      tmp_path / f"{pkg}.sqlite")
        _seed_store(pkg, cfg, known)
        assert main(["legacyImport", "-rf", *files, "--results-storage",
                     "DB", "--config", str(cfg), *flags]) == 0
        canon[pkg] = testing.canonical_store(tmp_path / f"{pkg}.sqlite")
    assert canon["port"] == canon["jax"]
    imported = "new" if flags else "Created by import"
    suspicious = "check" if flags else "Suspicious match"
    fresh = {n["mipId"] for n in canon["port"]["neuronMetadata"]
             if imported in n.get("tags", ())}
    was_known = {mip for mip, _, tags in known
                 if "Created by import" not in tags}
    assert fresh and not fresh & was_known
    matches = canon["port"]["cdMatches"]
    assert len(matches) == len(files) * 9
    for m in matches:
        sides = {m["maskImageRefId"][0], m["matchedImageRefId"][0]}
        assert (suspicious in m.get("tags", ())) == bool(sides & fresh)


# -------------------------------------------------------------------------
# validateDBData
# -------------------------------------------------------------------------


@pytest.fixture(scope="module")
def neuron_files(tmp_path_factory):
    """Neuron JSONs of a small library with gradient and z-gap variants:
    one z-gap and one gradient file deleted, one neuron listed twice,
    one neuron without a library (copyToMipsStore's UNKNOWN)."""
    root = tmp_path_factory.mktemp("lib")
    rng = np.random.default_rng(9)
    lib = testing.synthetic_library(rng, 6, 0, 12, 16, target_fg=0.2)
    grads = [testing.synthetic_gradient(rng, t) for t in lib.targets]
    zgaps = [testing.synthetic_zgap(t, radius=2) for t in lib.targets]
    neurons = testing.write_neuron_images(
        root / "lib", lib.targets, "t", gradients=grads, zgaps=zgaps,
        threads=2)
    for n in neurons[:4]:
        n.alignment_space = "JRC2018_Unisex_20x_HR"
    neurons[5].library_name = None
    os.remove(root / "lib" / "zgap" / "t00002_20pxRGB.png")
    os.remove(root / "lib" / "grad" / "t00004_gradient.png")
    write_neurons_json(neurons + [neurons[1]], root / "targets.json")
    write_neurons_json(neurons[:2], root / "few.json")
    return root


VALIDATE_FS_CASES = {
    "default": [],
    "no_grad_files": ["--no-grad-files-check"],
    "no_check_files": ["--no-check-files"],
    "two_inputs": ["@few.json"],  # a second file after -i's first
    "error_tags": ["--apply-error-tags", "--error-tag", "broken"],
}


@pytest.mark.parametrize("case", sorted(VALIDATE_FS_CASES))
def test_validate_fs_identical_to_jax(neuron_files, tmp_path, case):
    """The summary line, and the neuron file (rewritten with
    --apply-error-tags), are the JAX CLI's."""
    src, few = tmp_path / "targets.json", tmp_path / "few.json"
    shutil.copy(neuron_files / "targets.json", src)
    shutil.copy(neuron_files / "few.json", few)
    flags = [str(few) if a == "@few.json" else a
             for a in VALIDATE_FS_CASES[case]]
    rc, out, (data,) = _same(testing.run_clis(
        MAINS, ["validateDBData", "-i", src, *flags], inputs=[src, few],
        outputs=[src]))
    assert rc == 0
    summary = json.loads(out.strip().splitlines()[-1])
    # t00002 (z-gap) and t00004 (gradient) miss a file; t00001 is listed
    # twice
    want = {"no_grad_files": 1, "no_check_files": 1}.get(case, 3)
    assert summary["neuronsWithErrors"] == want
    assert summary["neuronsChecked"] == 7 + 2 * (case == "two_inputs")
    tagged = sum("broken" in d.get("tags", ()) for d in json.loads(data))
    assert tagged == (3 if case == "error_tags" else 0)


@pytest.fixture(scope="module")
def imported_store(v2_results, tmp_path_factory):
    """A store made by the port's legacyImport of the v2 results (equal
    to the JAX import's: test_legacy_import_db_identical_to_jax); the
    image of every fourth LM target is missing."""
    root = tmp_path_factory.mktemp("store")
    _, files = v2_results
    cfg = _config(root / "c.properties", root / "nb.sqlite")
    assert torch_main.main(["legacyImport", "-rf", *files,
                            "--results-storage", "DB", "--config",
                            str(cfg)]) == 0
    return root / "nb.sqlite"


VALIDATE_DB_CASES = {
    "default": [],
    "library": ["-l", "FlyLight Gen1 MCFO"],
    "excluded_library": ["--excluded-libraries", "FlyLight Gen1 MCFO"],
    "page": ["--offset", "2", "--size", "5"],
    "names": ["--validated-names", "LM1", "LM2", "EM0"],
    "tags": ["--validated-tags", "Created by import", "-as",
             "JRC2018_Unisex_20x_HR"],
    "no_check_files": ["--no-check-files"],
    "error_tags": ["--apply-error-tags", "--error-tag", "bad",
                   "--apply-error-tag-to-em-cdmatches",
                   "--apply-error-tag-to-lm-cdmatches"],
    "error_tags_lm": ["--apply-error-tags",
                      "--apply-error-tag-to-lm-cdmatches", "--jacs-url",
                      "http://localhost:1", "--read-batch-size", "7"],
    "dangling": [],
}


@pytest.mark.parametrize("case", sorted(VALIDATE_DB_CASES))
def test_validate_db_identical_to_jax(imported_store, tmp_path, case):
    """On a copy of one store: the summary line, and the store after the
    run in canonical form, are the JAX CLI's ("dangling": one neuron's
    document deleted, so its matches reference nothing)."""
    out, canon = {}, {}
    for pkg, main in MAINS.items():
        store = tmp_path / f"{pkg}.sqlite"
        shutil.copy(imported_store, store)
        if case == "dangling":
            with sqlite3.connect(store) as conn:
                conn.execute("DELETE FROM neuronMetadata WHERE json_extract("
                             "doc, '$.mipId') = 'lm3'")
        cfg = _config(tmp_path / f"{pkg}.properties", store)
        runs = testing.run_clis(
            {pkg: main}, ["validateDBData", "--results-storage", "DB",
                          "--config", cfg, *VALIDATE_DB_CASES[case]])
        rc, out[pkg], _ = runs[pkg]
        assert rc == 0
        canon[pkg] = testing.canonical_store(store)
    assert out["port"] == out["jax"]
    assert canon["port"] == canon["jax"]
    summary = json.loads(out["port"].strip().splitlines()[-1])
    assert summary["danglingMatchRefs"] == (6 if case == "dangling" else 0)
    if case == "default":
        # lm1 and lm5 lack their image
        assert (summary["neuronsChecked"], summary["neuronsWithErrors"]) \
            == (15, 2)
    if case == "error_tags":
        assert summary["errorTaggedMatches"] == 2 * 6
        assert sum("bad" in m.get("tags", ())
                   for m in canon["port"]["cdMatches"]) == 12


# -------------------------------------------------------------------------
# copyToMipsStore / copyMIPSegmentation
# -------------------------------------------------------------------------


COPY_CASES = {
    "default": [],
    "dry_run": ["--dry-run"],
    "filter": ["--mipsFilter", "T-00001", "t00003"],
    "no_update": ["--no-update-metadata"],
    "file_types": ["--file-types", "InputColorDepthImage",
                   "SourceColorDepthImage", "GradientImage"],
    "existing": [],
    "existing_force": ["--force", "--lmIgnoreMissingSegmentation"],
}


@pytest.mark.parametrize("case", sorted(COPY_CASES))
def test_copy_to_mips_store_identical_to_jax(neuron_files, tmp_path, case):
    """The store's files and the rewritten neuron file are the JAX
    CLI's ("existing": one file is already in the store)."""
    src = tmp_path / "targets.json"
    shutil.copy(neuron_files / "targets.json", src)
    store = tmp_path / "store"
    inputs = [src]
    if case.startswith("existing"):
        old = store / "JRC2018_Unisex_20x_HR" / "synthetic" / "cdm" / \
            "t00000.png"
        old.parent.mkdir(parents=True)
        old.write_bytes(b"older")
        inputs.append(old)
    rc, _, (tree, data) = _same(testing.run_clis(
        MAINS, ["copyToMipsStore", "-i", src, "--store-dir", store,
                *COPY_CASES[case]], inputs=inputs, outputs=[store, src]))
    assert rc == 0
    n_files = {"dry_run": 0, "filter": 6, "file_types": 11}.get(case, 16)
    assert len(tree or {}) == n_files
    if case == "default":
        assert "UNKNOWN/synthetic/grad/t00005_gradient.png" not in tree
        assert "UNKNOWN/UNKNOWN/zgap/t00005_20pxRGB.png" in tree
    if case == "existing":
        assert tree["JRC2018_Unisex_20x_HR/synthetic/cdm/t00000.png"] == \
            b"older"
    rewritten = str(store) in data.decode()
    assert rewritten == (case not in ("dry_run", "no_update"))


@pytest.fixture(scope="module")
def mip_list(neuron_files, tmp_path_factory):
    """The library's v2 MIP list (by the port's
    createColorDepthSearchJSONInput)."""
    out = tmp_path_factory.mktemp("lists")
    assert torch_main.main(["createColorDepthSearchJSONInput", "-i",
                            str(neuron_files / "lib"), "-od",
                            str(out)]) == 0
    return out / "lib.json"


SEGMENTATION_CASES = {
    "gradients": ["--source-dirs", "@grad", "--variant-suffix",
                  "_gradient"],
    "zgaps_filter": ["--source-dirs", "@zgap", "@grad", "--variant-suffix",
                     "_20pxRGB", "--mipsFilter", "t00001", "T00002",
                     "t00003"],
    "dry_run": ["--source-dirs", "@zgap", "--variant-suffix", "_20pxRGB",
                "--dry-run", "--injective-variants", "x"],
    "no_suffix": ["--source-dirs", "@lib"],
}


@pytest.mark.parametrize("case", sorted(SEGMENTATION_CASES))
def test_copy_mip_segmentation_identical_to_jax(neuron_files, mip_list,
                                                tmp_path, case):
    lib = neuron_files / "lib"
    flags = [str(lib / a[1:]) if a in ("@grad", "@zgap") else
             str(lib) if a == "@lib" else a
             for a in SEGMENTATION_CASES[case]]
    out = tmp_path / "variants"
    rc, _, (tree,) = _same(testing.run_clis(
        MAINS, ["copyMIPSegmentation", "-i", mip_list, *flags, "-od", out],
        outputs=[out]))
    assert rc == 0
    n = {"gradients": 5, "zgaps_filter": 2, "dry_run": 0, "no_suffix": 6}
    assert len(tree or {}) == n[case]


# -------------------------------------------------------------------------
# precomputeVariants
# -------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cdm_dir(tmp_path_factory):
    """Small CDMs, one with nothing above the threshold, one row 70,000
    pixels wide with one bright pixel at its left end (distances past
    0xFFFF, clamped), and a file that is no image."""
    root = tmp_path_factory.mktemp("cdms")
    rng = np.random.default_rng(13)
    for i in range(3):
        write_png(root / f"c{i}.png",
                  testing.synthetic_cdm(rng, 23, 37, fg_fraction=0.1))
    write_png(root / "dark.png", np.full((9, 11, 3), 20, np.uint8))
    wide = np.zeros((1, 70000, 3), np.uint8)
    wide[0, 0] = 255
    write_png(root / "wide.png", wide)
    (root / "broken.png").write_bytes(b"\x89PNG\r\n\x1a\nno image")
    return root


PRECOMPUTE_CASES = {
    "default": [],
    "no_gradient": ["--no-gradient", "--zgap-subdir", "z",
                    "--zgap-suffix", "_z", "--negativeRadius", "3"],
    "no_zgap": ["--no-zgap", "--gradient-subdir", "g", "--gradient-suffix",
                "", "--maskThreshold", "100"],
}


def _decoded(tree: dict, root: Path) -> dict:
    """{name: (port's decoded pixels, JAX's)} of a tree's PNGs."""
    out = {}
    for name in tree:
        path = root / name
        out[name] = (read_image(str(path)).pixels,
                     jax_read_image(str(path)).pixels)
    return out


@pytest.mark.parametrize("case", sorted(PRECOMPUTE_CASES))
def test_precompute_variants_pixels_equal_jax(cdm_dir, tmp_path, case):
    """The same files, decoded to the same pixels by the port's reader
    and by the JAX package's; the z-gap variant is
    dilate_rgb(mask_rgb(cdm)), the gradient the rounded distance
    clamped to 0xFFFF."""
    from colormipsearch_tpu_torch.oracle.shape import dilate_rgb, mask_rgb

    out = tmp_path / "variants"
    pixels = {}
    for pkg, main in MAINS.items():
        rc, _, (tree,) = testing.run_clis(
            {pkg: main}, ["precomputeVariants", "-i", cdm_dir, "-od", out,
                          *PRECOMPUTE_CASES[case]], outputs=[out])[pkg]
        assert rc == 0
        pixels[pkg] = _decoded(tree, out)
    assert pixels["port"].keys() == pixels["jax"].keys()
    for name, (port_read, jax_read) in pixels["port"].items():
        np.testing.assert_array_equal(port_read, jax_read)
        for got in pixels["jax"][name]:
            np.testing.assert_array_equal(got, port_read)
    stems = {Path(n).stem.split("_")[0] for n in pixels["port"]}
    assert stems == {"c0", "c1", "c2", "dark", "wide"}
    if case == "default":
        wide = pixels["port"]["grad/wide_gradient.png"][0]
        assert wide[0, 0] == 0 and wide[0, 1] == 1
        assert wide[0, 65535] == wide[0, -1] == 0xFFFF
        assert wide[0, 65534] == 65534
        cdm = read_image(str(cdm_dir / "c1.png")).pixels
        np.testing.assert_array_equal(
            pixels["port"]["zgap/c1_20pxRGB.png"][0],
            dilate_rgb(mask_rgb(cdm, 20), 20))


def _png_case(case: str) -> np.ndarray:
    rng = np.random.default_rng(len(case))
    if case == "rgb_1px":
        return np.array([[[7, 200, 255]]], np.uint8)
    if case.startswith("rgb_"):
        h, w = map(int, case[4:].split("x"))
        return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    if case == "gray16_1px":
        return np.array([[0xFFFF]], np.uint16)
    if case == "gray16_clamped":
        # what precomputeVariants stores: the rounded distance, clamped
        dist = np.array([[0.0, 255.5, 256.49, 65534.6, 65535.0, 9e6,
                          1e12]])
        return np.minimum(np.rint(dist), 0xFFFF).astype(np.uint16)
    h, w = map(int, case[7:].split("x"))
    return rng.integers(0, 0x10000, (h, w), dtype=np.uint16)


@pytest.mark.parametrize("case", ["rgb_1px", "rgb_3x8", "rgb_7x13",
                                  "gray16_1px", "gray16_5x11",
                                  "gray16_clamped"])
def test_png_writer_round_trip(tmp_path, case):
    """io/png.py's files decode to the written array through the port's
    reader and through PIL (the JAX package's read_image): 8-bit RGB and
    16-bit gray, widths that are not a multiple of 8, one pixel, values
    above 255 and the 0xFFFF clamp."""
    img = _png_case(case)
    path = tmp_path / "x.png"
    write_png(path, img)
    for reader in (read_image, jax_read_image):
        got = reader(str(path)).pixels
        assert got.dtype == img.dtype
        np.testing.assert_array_equal(got, img)
    if case == "gray16_clamped":
        assert img.tolist() == [[0, 256, 256, 65535, 65535, 65535, 65535]]
    with pytest.raises(ValueError):
        write_png(path, img.astype(np.int32))


# -------------------------------------------------------------------------
# the CLI's surface
# -------------------------------------------------------------------------


def _subcommands(main) -> dict:
    sub = next(a for a in main.build_parser()._actions
               if isinstance(a, argparse._SubParsersAction))
    return sub.choices


def test_subcommands_and_aliases_equal_jax():
    """The port registers every subcommand and alias of the JAX CLI, in
    its order (24 subcommands, 3 aliases)."""
    port, ref = _subcommands(torch_main), _subcommands(jax_main)
    assert list(port) == list(ref)
    assert len({id(p) for p in port.values()}) == 24
    for alias, name in (("importV2CDMatches", "legacyImport"),
                        ("mormalizeGradientScores",
                         "normalizeGradientScores"),
                        ("normalizeScores", "normalizeGradientScores")):
        assert port[alias] is port[name]


def _actions(parser) -> list:
    return [(a.option_strings, a.dest, a.default, a.choices, a.nargs,
             getattr(a.type, "__name__", a.type), a.required, a.const)
            for a in parser._actions]


@pytest.mark.parametrize("command", sorted(
    {p.prog.split()[-1] for p in _subcommands(jax_main).values()}))
def test_subcommand_help_and_options(command, capsys):
    """Each subcommand prints its help; its parser has every option of
    the JAX one (the commands that run the device add --device), and the
    commands of this slice exactly the JAX parser's actions."""
    with pytest.raises(SystemExit) as e:
        torch_main.main([command, "--help"])
    assert e.value.code == 0
    assert f"usage: colormipsearch-tpu-torch {command}" in \
        capsys.readouterr().out
    port = _actions(_subcommands(torch_main)[command])
    ref = _actions(_subcommands(jax_main)[command])
    if command in NEW_COMMANDS:
        assert port == ref
    port_options = {o for a in port for o in a[0]}
    assert {o for a in ref for o in a[0]} <= port_options
    assert port_options - {o for a in ref for o in a[0]} <= {"--device"}
