"""The port's colorDepthSearch command as a whole.

* slice: the port (``--device cpu``) and the JAX package's CLI write
  byte-identical result trees from the same neuron JSONs;
* isolation: the port imports and runs with jax and PIL unimportable,
  as on the GPU hosts;
* policy: ``--device cuda`` without a GPU is an error, and every
  configuration outside the slice raises NotImplementedError.

The JAX engine reads CDS_SPLIT_PLANES when it is imported, so the tests
that set it for the port patch the JAX engine's flag too.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from colormipsearch_tpu.cli import main as jax_main
from colormipsearch_tpu.engine import cds as jcds
from colormipsearch_tpu.model import neuron_from_json as jax_neuron
from colormipsearch_tpu_torch import testing
from colormipsearch_tpu_torch.cli import main as torch_main
from colormipsearch_tpu_torch.dataio.json_io import write_neurons_json
from colormipsearch_tpu_torch.engine.cds import CDSearchEngine, CDSParams
from colormipsearch_tpu_torch.io.image import decode_png_rgb8, read_image
from colormipsearch_tpu_torch.ops import pixel_match as tpm

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parent.parent
FLAGS = ["--maskThreshold", "20", "--dataThreshold", "20",
         "--pixColorFluctuation", "1.0", "--xyShift", "2", "--mirrorMask",
         "--no-name-labels", "--no-colormap-labels", "--perMaskSubdir",
         "masks", "--perTargetSubdir", "targets", "--processing-tag", "t1",
         "--cdsConcurrency", "2"]


def _inputs(tmp_path, seed=41, n_targets=24, n_masks=5):
    rng = np.random.default_rng(seed)
    lib = testing.synthetic_library(rng, n_targets, n_masks, 48, 72,
                                    target_fg=0.08, mask_fg=0.03)
    write_neurons_json(testing.write_neuron_images(
        tmp_path / "lib", lib.targets, "t", threads=2),
        tmp_path / "targets.json")
    write_neurons_json(testing.write_neuron_images(
        tmp_path / "lib", lib.masks, "m", threads=2),
        tmp_path / "masks.json")
    return ["-m", str(tmp_path / "masks.json"),
            "-i", str(tmp_path / "targets.json")]


def _tree(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def _split_on(monkeypatch) -> dict:
    """CDS_SPLIT_PLANES=1 for the port and the JAX engine; returns how
    often each scored a batch on split planes, {"port": n, "jax": n}."""
    monkeypatch.setenv("CDS_SPLIT_PLANES", "1")
    monkeypatch.setattr(jcds, "_USE_SPLIT", True)
    calls = {"port": 0, "jax": 0}
    # the port's split-plane kernel, and the JAX engine's split-pair
    # accessor, which its single-device and mesh paths both call per
    # batch
    for key, owner, attr in (
            ("port", tpm, "score_query_batch_split"),
            ("jax", jcds.CDSearchEngine, "_split_planes")):
        def counted(*a, _fn=getattr(owner, attr), _key=key, **kw):
            calls[_key] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(owner, attr, counted)
    return calls


@pytest.mark.parametrize("pct", ["1.0", "0.0"])
def test_slice_result_files_identical_to_jax(tmp_path, pct):
    """Every per-mask and per-target result file and cdsParameters.json
    are byte-identical. No field is per-run generated on this path
    (no entity or session ids without a DB), so nothing is dropped."""
    args = _inputs(tmp_path)
    flags = FLAGS + ["--pctPositivePixels", pct]
    assert torch_main.main(["colorDepthSearch", *args, "--device", "cpu",
                            "-od", str(tmp_path / "port"), *flags]) == 0
    assert jax_main.main(["colorDepthSearch", *args,
                          "-od", str(tmp_path / "jax"), *flags]) == 0
    port, ref = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    assert "cdsParameters.json" in port
    assert any(k.startswith("masks/") for k in port)
    assert any(k.startswith("targets/") for k in port)
    assert port.keys() == ref.keys()
    for name in port:
        assert port[name] == ref[name], name


@pytest.mark.parametrize("form", [
    (["--use-union-keys", "off"], False), (["--use-key-planes"], False),
    (["--use-union-keys", "x"], False),
    (["--use-union-keys", "x", "--xyShift", "4"], False),
    (["--use-union-keys", "off"], True),
])
def test_kernel_forms_result_files_identical_to_jax(tmp_path, form,
                                                    monkeypatch):
    """The packed path (banded kernel, flagged pairs rescored), the same
    with CDS_SPLIT_PLANES=1 (the split-plane kernel), the classic key
    kernel and the x-union form (and its fallback at xyShift 4) write the
    JAX CLI's result trees byte for byte."""
    form, split = form
    calls = _split_on(monkeypatch) if split else None
    args = _inputs(tmp_path, seed=47, n_targets=16, n_masks=3)
    flags = FLAGS + ["--pctPositivePixels", "0.0", *form]
    assert torch_main.main(["colorDepthSearch", *args, "--device", "cpu",
                            "-od", str(tmp_path / "port"), *flags]) == 0
    assert jax_main.main(["colorDepthSearch", *args,
                          "-od", str(tmp_path / "jax"), *flags]) == 0
    port, ref = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    assert any(k.startswith("masks/") for k in port)
    assert port == ref
    if split:
        assert calls["port"] == calls["jax"] > 0


def test_port_runs_without_jax_and_pil(tmp_path):
    """Import every port module and run a tiny CPU colorDepthSearch in a
    process where jax and PIL cannot be imported."""
    args = _inputs(tmp_path, seed=43, n_targets=6, n_masks=2)
    script = textwrap.dedent(f"""
        import importlib, pkgutil, sys
        sys.modules["jax"] = None
        sys.modules["PIL"] = None
        sys.path.insert(0, {str(REPO)!r})
        import colormipsearch_tpu_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(
            pkg.__path__, pkg.__name__ + ".")]
        for name in names:
            importlib.import_module(name)
        assert not any(m == "jax" or m.startswith(("jax.", "PIL"))
                       for m in sys.modules if sys.modules[m] is not None)
        from colormipsearch_tpu_torch.cli.main import main
        rc = main(["colorDepthSearch", *{args!r}, "--device", "cpu",
                   "-od", {str(tmp_path / "out")!r}, *{FLAGS!r},
                   "--pctPositivePixels", "1.0"])
        print("MODULES", len(names))
        sys.exit(rc)
    """)
    env = dict(os.environ, OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", script], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert int(proc.stdout.split("MODULES")[1]) >= 15
    assert (tmp_path / "out" / "cdsParameters.json").exists()
    assert list((tmp_path / "out" / "masks").glob("*.json"))


def test_png_reader_round_trip_and_rejections(tmp_path):
    """The numpy PNG reader (the fallback when neither the native decoder
    nor PIL is available) reads the port's PNGs and PIL's (adaptive
    filters) bit-exactly and refuses what does not decode to RGB."""
    rng = np.random.default_rng(2)
    img = testing.synthetic_cdm(rng, 33, 47, fg_fraction=0.2)
    data = testing.encode_png(img)
    np.testing.assert_array_equal(decode_png_rgb8(data), img)
    np.testing.assert_array_equal(read_image(data).pixels, img)
    from PIL import Image

    Image.fromarray(img).save(tmp_path / "pil.png")  # adaptive filters
    np.testing.assert_array_equal(
        decode_png_rgb8((tmp_path / "pil.png").read_bytes()), img)
    Image.fromarray(img[..., 0]).save(tmp_path / "gray.png")
    with pytest.raises(ValueError):
        decode_png_rgb8((tmp_path / "gray.png").read_bytes())
    with pytest.raises(ValueError):
        decode_png_rgb8(b"GIF89a")


def test_device_cuda_without_gpu_is_an_error(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: --device cuda is valid here")
    args = _inputs(tmp_path, seed=44, n_targets=2, n_masks=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_main.main(["colorDepthSearch", *args, "--device", "cuda",
                         "-od", str(tmp_path / "out"), *FLAGS])
    with pytest.raises(RuntimeError):
        CDSearchEngine(CDSParams(), device="cuda")


@pytest.mark.parametrize("setting", [
    dict(use_mesh=True),
    dict(use_key_planes=False, env=("CDS_SPLIT_PLANES", "1")),
    dict(env=[("CDS_SPLIT_PLANES", "1"), ("CDS_UNION_KEYS", "0")]),
])
def test_outside_the_slice_raises(setting, tmp_path, monkeypatch):
    """A group of processes that parallel.mesh.init_distributed did not
    make raises: the mesh would not know this process's devices, and
    without the global mesh every rank would write every column (the
    mesh across processes: tests/test_torch_multiprocess.py).
    CDS_SPLIT_PLANES=1 on the packed path without a top-k (chosen by
    use_key_planes=False or by CDS_UNION_KEYS=0) is inside the slice: the
    engine runs the split-plane kernel and finds the JAX engine's
    matches."""
    setting = dict(setting)
    env = setting.pop("env", [])
    if setting.get("use_mesh"):
        import torch.distributed as dist

        monkeypatch.setattr(dist, "is_initialized", lambda: True)
        monkeypatch.setattr(dist, "get_world_size", lambda *a, **k: 2)
        with pytest.raises(RuntimeError, match="init_distributed"):
            CDSearchEngine(CDSParams(), device="cpu",
                           **setting).find_all_matches([], [])
        with pytest.raises(ValueError, match="global mesh"):
            CDSearchEngine(CDSParams(), device="cpu", use_mesh=False)
        return
    calls = _split_on(monkeypatch)
    for name, value in [env] if isinstance(env, tuple) else env:
        monkeypatch.setenv(name, value)
    rng = np.random.default_rng(48)
    lib = testing.synthetic_library(rng, 10, 2, 40, 56, target_fg=0.08,
                                    mask_fg=0.03)
    masks = testing.write_neuron_images(tmp_path, lib.masks, "m", threads=2)
    targets = testing.write_neuron_images(tmp_path, lib.targets, "t",
                                          threads=2)
    params = dict(mask_threshold=20, data_threshold=20, xy_shift=2,
                  pix_color_fluctuation=1.0, mirror_mask=True)

    def tuples(matches):
        return sorted((m.mask_image.mip_id, m.matched_image.mip_id,
                       m.matching_pixels, m.mirrored,
                       m.matching_pixels_ratio) for m in matches)

    port = CDSearchEngine(CDSParams(**params), device="cpu", **setting)
    # the JAX engine reads CDS_UNION_KEYS at import: the same choice as
    # an argument
    ref = jcds.CDSearchEngine(jcds.CDSParams(**params), use_mesh=False,
                              use_key_planes=setting.get("use_key_planes"),
                              use_union_keys=False)
    got = tuples(port.find_all_matches(masks, targets))
    want = tuples(ref.find_all_matches(
        [jax_neuron(m.to_json()) for m in masks],
        [jax_neuron(t.to_json()) for t in targets]))
    assert got == want and got
    assert not port.use_key_planes
    assert calls["port"] == calls["jax"] > 0


def test_split_planes_outside_the_packed_path_runs(tmp_path, monkeypatch):
    """CDS_SPLIT_PLANES=1 changes nothing on the default (full-union)
    path, nor on the packed path with a top-k, as in the JAX engine."""
    args = _inputs(tmp_path, seed=46, n_targets=8, n_masks=2)
    monkeypatch.setenv("CDS_SPLIT_PLANES", "1")
    for name, extra in (("default", []), ("topk", [
            "--use-union-keys", "off", "--max-matches-per-mask", "3"])):
        flags = FLAGS + ["--pctPositivePixels", "1.0", *extra]
        assert torch_main.main(["colorDepthSearch", *args, "--device", "cpu",
                                "-od", str(tmp_path / name), *flags]) == 0
        monkeypatch.delenv("CDS_SPLIT_PLANES")
        assert torch_main.main(["colorDepthSearch", *args, "--device", "cpu",
                                "-od", str(tmp_path / f"{name}0"),
                                *flags]) == 0
        monkeypatch.setenv("CDS_SPLIT_PLANES", "1")
        assert _tree(tmp_path / name) == _tree(tmp_path / f"{name}0")
        assert any(k.startswith("masks/") for k in _tree(tmp_path / name))


def test_unknown_union_form_is_a_value_error(monkeypatch):
    monkeypatch.setenv("CDS_UNION_KEYS", "y")
    with pytest.raises(ValueError, match="use_union_keys"):
        CDSearchEngine(CDSParams(), device="cpu")


def _db_library(tmp_path):
    """A library with gradient and z-gap variants: 2 masks, then 6
    targets, in one directory (lib:0:2 and lib:2:6)."""
    rng = np.random.default_rng(48)
    lib = testing.synthetic_library(rng, 6, 2, 48, 72, target_fg=0.3,
                                    mask_fg=0.1)
    testing.write_neuron_images(tmp_path / "lib", lib.masks, "m", threads=2)
    testing.write_neuron_images(
        tmp_path / "lib", lib.targets, "t",
        gradients=[testing.synthetic_gradient(rng, t) for t in lib.targets],
        zgaps=[testing.synthetic_zgap(t, radius=4) for t in lib.targets],
        threads=2)
    return tmp_path / "lib"


def _db_steps(lib: Path, out: Path, command: str, flag: str) -> list:
    """The commands of a DB case: the inputs (in the store, or as JSON
    under `out`), then the case's command with `flag` DB."""
    variants = ["--gradients-location", str(lib / "grad"),
                "--zgap-location", str(lib / "zgap")]
    inputs = [["createColorDepthSearchDataInput", "-i", f"{lib}:0:2", "-l",
               "masks"], ["createColorDepthSearchDataInput", "-i",
                          f"{lib}:2:6", "-l", "targets", *variants]]
    db_inputs = [[*argv, "--mips-storage", "DB"] for argv in inputs]
    fs_inputs = [[*argv, "-od", str(out), "--output-filename",
                  f"{argv[4]}.json"] for argv in inputs]
    cds = ["colorDepthSearch", "--maskThreshold", "20", "--dataThreshold",
           "20", "--pixColorFluctuation", "2.0", "--xyShift", "2",
           "--mirrorMask", "--no-name-labels", "--no-colormap-labels",
           "--pctPositivePixels", "0", "--cdsConcurrency", "2"]
    db_cds = [*cds, "-m", "masks", "-i", "targets", "--mips-storage", "DB",
              "--results-storage", "DB"]
    gs = ["gradientScores", "--matches", "masks", "--results-storage", "DB",
          "--maskThreshold", "20", "--mirrorMask", "--no-name-labels",
          "--no-colormap-labels", "--negativeRadius", "4",
          "--processing-tag", "g1"]
    if command == "createColorDepthSearchDataInput":
        return db_inputs
    if command == "colorDepthSearch" and flag == "--mips-storage":
        return db_inputs + [[*db_cds[:-2], "-od", str(out),
                             "--perMaskSubdir", "masks"]]
    if command == "colorDepthSearch" and flag == "--results-storage":
        return fs_inputs + [[*cds, "-m", str(out / "masks.json"), "-i",
                             str(out / "targets.json"),
                             "--results-storage", "DB"]]
    if command == "colorDepthSearch":
        return db_inputs + [db_cds]
    if command == "gradientScores":
        return db_inputs + [db_cds, gs]
    return db_inputs + [db_cds, gs, [
        "normalizeGradientScores", "--matches", "masks",
        "--results-storage", "DB", "--processing-tag", "n1"]]


@pytest.mark.parametrize("path", [
    ("createColorDepthSearchDataInput", "--mips-storage"),
    ("colorDepthSearch", "--mips-storage"),
    ("colorDepthSearch", "--results-storage"),
    ("colorDepthSearch", "both"),
    ("gradientScores", "--results-storage"),
    ("normalizeGradientScores", "--results-storage"),
], ids=lambda p: f"{p[0]}{p[1]}")
def test_db_storage_completes_and_equals_jax(tmp_path, path):
    """Each command completes with the DB storage and leaves the store
    (and, for --mips-storage DB alone, the result files) the JAX CLI
    leaves, in canonical form (testing.canonical_store)."""
    command, flag = path
    lib = _db_library(tmp_path)
    stores, trees = {}, {}
    for name, main in (("jax", jax_main.main), ("port", torch_main.main)):
        store = tmp_path / f"{name}.sqlite"
        cfg = tmp_path / f"{name}.properties"
        cfg.write_text(f"Store.Type=sqlite\nStore.Path={store}\n")
        out = tmp_path / f"{name}_out"
        for argv in _db_steps(lib, out, command, flag):
            if name == "port" and argv[0] in ("colorDepthSearch",
                                              "gradientScores"):
                argv = [*argv, "--device", "cpu"]
            assert main([*argv, "--config", str(cfg)]) == 0, argv
        stores[name] = testing.canonical_store(store)
        if (out / "masks").is_dir():
            trees[name] = testing.fs_match_rows(out / "masks")
    assert stores["port"] == stores["jax"]
    neurons = stores["port"]["neuronMetadata"]
    if (command, flag) == ("colorDepthSearch", "--results-storage"):
        # from files, the search stores only the neurons of its matches
        assert len(neurons) == len({m[ref] for m in stores["port"]
                                    ["cdMatches"] for ref in
                                    ("maskImageRefId", "matchedImageRefId")})
    else:
        assert len(neurons) == 8
    if command != "createColorDepthSearchDataInput":
        rows = trees["port"] if "port" in trees \
            else testing.store_match_rows(tmp_path / "port.sqlite")
        assert rows and trees.get("port") == trees.get("jax")
    if command in ("gradientScores", "normalizeGradientScores"):
        assert any("gradientAreaGap" in m
                   for m in stores["port"]["cdMatches"])
        assert any(n.get("processedTags") for n in
                   stores["port"]["neuronMetadata"])


def test_file_pipeline_runs_without_jax_and_pil(tmp_path):
    """In a process where jax and PIL cannot be imported, the port alone
    makes its inputs, searches, rescores and normalizes (v3), then makes
    the v2 lists, searches from them, rescores, transfers the scores of
    the reverse files and merges: the whole file pipeline on the CPU;
    then the v3 steps again on the DB storage (a sqlite store)."""
    script = textwrap.dedent(f"""
        import os, sys
        sys.modules["jax"] = None
        sys.modules["PIL"] = None
        sys.path.insert(0, {str(REPO)!r})
        import numpy as np
        from colormipsearch_tpu_torch import testing
        from colormipsearch_tpu_torch.cli.main import main

        os.chdir({str(tmp_path)!r})
        rng = np.random.default_rng(49)
        lib = testing.synthetic_library(rng, 6, 2, 40, 56, target_fg=0.08,
                                        mask_fg=0.03)
        testing.write_neuron_images(
            "targets", lib.targets, "t",
            gradients=[testing.synthetic_gradient(rng, t)
                       for t in lib.targets],
            zgaps=[testing.synthetic_zgap(t, radius=4) for t in lib.targets],
            threads=2)
        testing.write_neuron_images("masks", lib.masks, "m", threads=2)
        cds = {FLAGS[:10]!r} + ["--no-name-labels", "--no-colormap-labels",
                                "--device", "cpu"]
        gs = ["--maskThreshold", "20", "--mirrorMask", "--no-name-labels",
              "--no-colormap-labels", "--negativeRadius", "4"]
        variants = ["-gp", "targets/grad", "-zgp", "targets/zgap"]
        with open("store.properties", "w") as f:
            f.write("Store.Type=sqlite\\nStore.Path=nb.sqlite\\n")
        db = ["--config", "store.properties"]
        steps = [
            ["createColorDepthSearchDataInput", "-i", "targets",
             "--gradients-location", "targets/grad", "--zgap-location",
             "targets/zgap", "-od", "in"],
            ["createColorDepthSearchDataInput", "-i", "masks", "-od", "in"],
            ["colorDepthSearch", "-m", "in/masks.json", "-i",
             "in/targets.json", *cds, "--pctPositivePixels", "0",
             "-od", "v3", "--perMaskSubdir", "masks"],
            ["gradientScores", "--matches", "v3/masks", *gs, "--device",
             "cpu", "-od", "v3", "--perMaskSubdir", "masks"],
            ["normalizeGradientScores", "--matches", "v3/masks",
             "--pctPositivePixels", "1", "-od", "v3",
             "--perMaskSubdir", "masks"],
            ["createColorDepthSearchJSONInput", "-i", "targets", "-od",
             "lists"],
            ["createColorDepthSearchJSONInput", "-i", "masks", "-od",
             "lists"],
            ["searchFromJSON", "-m", "lists/masks.json", "-i",
             "lists/targets.json:0:3", *cds, "-od", "a"],
            ["searchFromJSON", "-m", "lists/masks.json", "-i",
             "lists/targets.json:3:3", *cds, "-od", "b"],
            ["searchLocalFiles", "-m", "masks", "-i", "targets", *cds,
             "--with-grad-scores", *variants, "--perLibrarySubdir",
             "bylib", "-od", "fused"],
            ["gradientScore", "-rd", "a", *variants, *gs, "--device", "cpu",
             "-od", "a_gs"],
            ["gradientScoresFromMatchedResults", "-rd", "b", "-revd",
             "fused/bylib", "-od", "b_rev"],
            ["mergeResults", "-rd", "a_gs", "b_rev", "-od", "merged"],
            ["createColorDepthSearchDataInput", "-i", "targets",
             "--gradients-location", "targets/grad", "--zgap-location",
             "targets/zgap", "--mips-storage", "DB", *db],
            ["createColorDepthSearchDataInput", "-i", "masks",
             "--mips-storage", "DB", *db],
            ["colorDepthSearch", "-m", "masks", "-i", "targets", *cds,
             "--pctPositivePixels", "0", "--mips-storage", "DB",
             "--results-storage", "DB", *db],
            ["gradientScores", "--matches", "masks", *gs, "--device", "cpu",
             "--results-storage", "DB", "--processing-tag", "g1", *db],
            ["normalizeGradientScores", "--matches", "masks",
             "--pctPositivePixels", "1", "--results-storage", "DB", *db],
        ]
        for argv in steps:
            rc = main(argv)
            if rc:
                sys.exit(f"{{argv[0]}} exited {{rc}}")
        assert not any(m == "jax" or m.startswith(("jax.", "PIL",
                                                    "colormipsearch_tpu."))
                       for m in sys.modules if sys.modules[m] is not None)
        print("STEPS", len(steps))
    """)
    env = dict(os.environ, OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", script], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert int(proc.stdout.split("STEPS")[1]) == 18
    v3 = list((tmp_path / "v3" / "masks").glob("*.json"))
    assert v3 and any(b'"normalizedScore"' in p.read_bytes() for p in v3)
    assert list((tmp_path / "fused" / "bylib").glob("*.json"))
    merged = list((tmp_path / "merged").glob("*.json"))
    assert merged and all(b'"results"' in p.read_bytes() for p in merged)
    # the DB run stores the rows the file run wrote
    stored = testing.store_match_rows(tmp_path / "nb.sqlite", key="image")
    files = testing.fs_match_rows(tmp_path / "v3" / "masks", key="image")
    assert files and {k: stored[k] for k in files} == files


@pytest.mark.parametrize("path", [
    ("mesh", None, 3),
    ("daos", "ppp_matches_dao", 5),
    ("daos", "published_lm_images_dao", 5),
    ("createColorDepthSearchDataInput", "--jacs-url", 7),
    ("createColorDepthSearchJSONInput", "--jacs-url", 7),
], ids=lambda p: f"{p[0]}{p[1] or ''}")
def test_not_ported_names_its_roadmap_item(tmp_path, monkeypatch, path):
    """Every configuration the port raises NotImplementedError for names
    its item of ROADMAP.md §1: the DAOs of the export and tagging
    commands (5), the JACS input (7). The cross-process mesh is ported;
    the shape pass across processes, which the JAX package fails too,
    names ROADMAP.md §3."""
    command, flag, item = path
    match = rf"ROADMAP\.md §1, port item {item}\)"
    if command == "daos":
        from colormipsearch_tpu_torch.persist import Config, DaosProvider

        daos = DaosProvider(Config(overrides={
            "Store.Path": str(tmp_path / "nb.sqlite")}))
        with pytest.raises(NotImplementedError, match=match):
            getattr(daos, flag)
        daos.store.close()
        return
    if command == "mesh":
        import torch.distributed as dist

        from colormipsearch_tpu_torch.engine.gradscore import (
            GradScoreEngine,
        )

        monkeypatch.setattr(dist, "is_initialized", lambda: True)
        monkeypatch.setattr(dist, "get_world_size", lambda *a, **k: 2)
        with pytest.raises(NotImplementedError, match=r"ROADMAP\.md §3"):
            GradScoreEngine(CDSParams(), device="cpu")
        return
    with pytest.raises(NotImplementedError, match=match):
        torch_main.main([command, "-i", str(tmp_path), flag,
                         "http://localhost:1", "-od", str(tmp_path / "o")])
