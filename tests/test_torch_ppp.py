"""The port's PatchPerPix (PPP) layer against the JAX package's.

io/ppp.py function by function (every list form of the raw results,
mismatched counts, the name parsers, the scans, the screenshots), the
publish DTO of a PPP match, then importPPPResults (to files and to the
DB), convertPPPResults and copyPPPMatches through both CLIs on the same
synthetic results (testing.write_ppp_results). Files are compared byte
for byte, the ids importPPPResults mints replaced by their ordinal of
first appearance (testing.canonical_ids); stores in canonical form
(testing.canonical_store).
"""

import json
from pathlib import Path

import numpy as np
import pytest

import colormipsearch_tpu.io.ppp as j_ppp
import colormipsearch_tpu.model as j_model
import colormipsearch_tpu.persist as j_persist
import colormipsearch_tpu_torch.io.ppp as t_ppp
import colormipsearch_tpu_torch.model as t_model
import colormipsearch_tpu_torch.persist as t_persist
from colormipsearch_tpu.cli import main as jax_main
from colormipsearch_tpu.model import dto as j_dto
from colormipsearch_tpu_torch import testing
from colormipsearch_tpu_torch.cli import main as torch_main
from colormipsearch_tpu_torch.dataio.json_io import write_neurons_json
from colormipsearch_tpu_torch.model import dto as t_dto

MAINS = {"jax": jax_main.main, "port": torch_main.main}
MODELS = {"jax": j_model, "port": t_model}
PERSIST = {"jax": j_persist, "port": t_persist}
LM_LIBRARY = "FlyLight Gen1 MCFO"
N_BODIES, N_MATCHES = 8, 12


def _run(pkg: str, argv) -> None:
    assert MAINS[pkg]([str(a) for a in argv]) == 0, argv


def _tree(root: Path, ordinals=None) -> dict:
    """{relative path: bytes} of a directory; with `ordinals`, each file's
    minted ids by their ordinal of first appearance in the tree."""
    out = {}
    for p in sorted(root.rglob("*")):
        if p.is_file():
            data = p.read_bytes()
            if ordinals is not None:
                data = testing.canonical_ids(data.decode(),
                                             ordinals).encode()
            out[str(p.relative_to(root))] = data
    return out


def _json(x) -> str:
    """A value as JSON: 1 and 1.0 differ, as they do in the files."""
    return json.dumps(x, sort_keys=True, default=str)


@pytest.fixture(scope="module")
def ppp(tmp_path_factory):
    """The synthetic PPP results (8 bodies x 12 matches, 3 with
    screenshots, strays), and the EM bodies as neuron JSON."""
    root = tmp_path_factory.mktemp("ppp")
    res = testing.write_ppp_results(
        root / "results", np.random.default_rng(5), N_BODIES, N_MATCHES,
        rank_step=60.0, shot_bodies=3, shots_every=2, strays=True)
    write_neurons_json(res.em_neurons, root / "em_neurons.json")
    return root, res


# ---------------------------------------------------------------------------
# io/ppp.py
# ---------------------------------------------------------------------------

LISTS = [
    None, "", "   ", "abc", "[]", "[1, 2, 3]", "[1.5, 0.93]",
    "[[31, 245, 16], [1, 2, 3]]", "[  379  5477]", "[ 0.5 -1.  2.25]",
    "[1e-05 2.5e+03]", "[   5  322  639 ... 5394 5711 6028]",
    "[   5  322  639  956 1273 1590 1907\n 2224 2541 2858 3175 3492]",
    "[[ 0  1  2]\n [ 3  4  5]\n ...\n [54 55 56]\n [57 58 59]]",
    "[[1 2 3] [4 5 6]]", "[1, 2, x, 3]", "[a b 7 ...]", " [7 8]  ",
    "[[1.5, 2], [3, 4.25]]", "[0.1,\n 0.2]",
]


@pytest.mark.parametrize("text", LISTS, ids=range(len(LISTS)))
def test_parse_np_list_equals_jax(text):
    assert _json(t_ppp._parse_np_list(text)) == \
        _json(j_ppp._parse_np_list(text))


@pytest.mark.parametrize("only_best", [True, False])
@pytest.mark.parametrize("skeletons", [True, False])
def test_read_raw_ppp_matches_equals_jax(ppp, only_best, skeletons):
    _, res = ppp
    for f in res.files:
        got, want = (
            [_json(m.to_json()) for m in mod.read_raw_ppp_matches(
                f, only_best_matches=only_best,
                include_skeletons=skeletons)]
            for mod in (t_ppp, j_ppp))
        assert got == want and len(got) == N_MATCHES
    if skeletons:
        ms = t_ppp.read_raw_ppp_matches(res.files[1],
                                        only_best_matches=only_best,
                                        include_skeletons=True)
        assert any(s.color is None for m in ms for s in m.skeleton_matches)
        assert any(s.color for m in ms for s in m.skeleton_matches)


@pytest.mark.parametrize("where", ["best", "all"])
@pytest.mark.parametrize("only_best", [True, False])
def test_mismatched_skeleton_counts_raise_in_both(tmp_path, where,
                                                  only_best):
    prefix = "" if where == "best" else "all_"
    raw = {"cov_score": -3.0, "rank": 1.0, "skel_ids": "[1 2]",
           "nblast_scores": "[0.5 0.25]"}
    raw.update({f"{prefix}skel_ids": "[1 2 3]",
                f"{prefix}nblast_scores": "[0.5 0.25]"})
    path = tmp_path / "cov_scores_1-T-R.json"
    path.write_text(json.dumps({"1-T-R": {"L-s_REG_UNISEX_40x": raw}}))
    raises = where == "best" or not only_best
    for mod in (t_ppp, j_ppp):
        if raises:
            with pytest.raises(ValueError, match="counts differ"):
                mod.read_raw_ppp_matches(path, only_best_matches=only_best,
                                         include_skeletons=True)
        else:
            assert len(mod.read_raw_ppp_matches(
                path, only_best_matches=only_best,
                include_skeletons=True)[0].skeleton_matches) == 2


NAMES = ["1599747200-PFNp_c-RT_18U", "577720000--RT_18U", "hemibrain_x",
         "12-a-b-c", "BJD_115G11_AE_01-20190507_62_F1_REG_UNISEX_40x",
         "GMR_80D06_AE_01-20190426_64_C1_REG_UNISEX_VNC",
         "GMR_80D06_AE_01-20190426_64_C1_reg_unisex_Brain",
         "R1-s_REG_UNISEX_63X", "no_reg_marker_name", "line_only-"]


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("area", [None, "Brain", "VNC", "vnc"])
def test_name_parsers_equal_jax(name, area):
    kw = dict(library="lib", alignment_space="AS")
    assert t_ppp.em_neuron_from_ppp_name(name, **kw).to_json() == \
        j_ppp.em_neuron_from_ppp_name(name, **kw).to_json()
    assert t_ppp.lm_neuron_from_ppp_name(
        name, anatomical_area=area, **kw).to_json() == \
        j_ppp.lm_neuron_from_ppp_name(name, anatomical_area=area,
                                      **kw).to_json()
    assert t_ppp.lm_sample_name(name) == j_ppp.lm_sample_name(name)
    assert t_dto._lm_sample_info(name) == j_dto._lm_sample_info(name)
    assert t_dto._lm_sample_info(None) == j_dto._lm_sample_info(None)


SCANS = {
    "default": {},
    "sub_dir": {"sub_dir": testing.PPP_SUB_DIR},
    "other_sub_dir": {"sub_dir": "other_run"},
    "prefix": {"prefix": "other_scores_"},
    "prefix_and_sub_dir": {"prefix": "other_scores_",
                           "sub_dir": testing.PPP_SUB_DIR},
}


@pytest.mark.parametrize("scan", sorted(SCANS))
def test_find_ppp_result_files_equals_jax(ppp, scan):
    root, res = ppp
    dirs = [str(root / "results"), res.files[2], str(root / "absent")]
    got = t_ppp.find_ppp_result_files(dirs, **SCANS[scan])
    assert got == j_ppp.find_ppp_result_files(dirs, **SCANS[scan])
    assert len(got) > 1


def test_find_screenshots_equals_jax(ppp):
    _, res = ppp
    found = 0
    for f in res.files:
        shots = Path(f).parent / "screenshots"
        em = next(iter(json.loads(Path(f).read_text())))
        for lm in json.loads(Path(f).read_text())[em]:
            got = t_ppp.find_screenshots(shots, em, lm)
            assert got == j_ppp.find_screenshots(shots, em, lm)
            found += bool(got)
            assert not got or set(got) == {k for k, _ in
                                           t_ppp.SCREENSHOT_TYPES}
    assert found == 3 * N_MATCHES // 2
    assert t_ppp.SCREENSHOT_TYPES == j_ppp.SCREENSHOT_TYPES


def test_file_types_equal_jax():
    assert [(t.name, t.value) for t in t_model.FileType] == \
        [(t.name, t.value) for t in j_model.FileType]
    assert {k.value: v for k, v in
            t_model.entities.PPP_FILE_SUFFIXES.items()} == \
        {k.value: v for k, v in j_model.entities.PPP_FILE_SUFFIXES.items()}


def _dto_rows(mod, model, dto, path) -> list:
    rows = []
    for m in mod.read_raw_ppp_matches(path, include_skeletons=True):
        m.matched_image = mod.lm_neuron_from_ppp_name(m.source_lm_name,
                                                      library=LM_LIBRARY)
        m.source_lm_library = LM_LIBRARY
        rows.append(_json(dto.ppp_match_to_dto(m).to_json()))
    rows.append(_json(dto.ppp_match_to_dto(
        model.PPPMatch(rank=2.0)).to_json()))
    rows.append(_json(dto.neuron_metadata(
        mod.em_neuron_from_ppp_name(m.source_em_name)).to_json()))
    return rows


def test_ppp_match_dto_equals_jax(ppp):
    """dto.ppp_match_to_dto and neuron_metadata of every imported match,
    and the truncated score of PPPMatchEntityTest."""
    _, res = ppp
    for f in res.files[:3]:
        assert _dto_rows(t_ppp, t_model, t_dto, f) == \
            _dto_rows(j_ppp, j_model, j_dto, f)
    m = t_model.PPPMatch(source_lm_name="L-s_REG_UNISEX_VNC",
                         coverage_score=-83.89210580042597)
    row = t_dto.ppp_match_to_dto(m)
    assert (row.score, row.source_objective) == (83, "40x")


# ---------------------------------------------------------------------------
# importPPPResults
# ---------------------------------------------------------------------------

BASE = ["--em-library", testing.PPP_EM_LIBRARY, "--lm-library", LM_LIBRARY,
        "-as", testing.PPP_ALIGNMENT_SPACE]
IMPORTS = {
    "default": ["-rd", "@results", *BASE],
    "sub_dir": ["-rd", "@results", *BASE, "--neuron-matches-sub-dir",
                testing.PPP_SUB_DIR],
    "prefix": ["-rd", "@results", "--matches-prefix", "other_scores_"],
    "files_over_dirs": ["-rd", "@results", "-rf", "@file0", "@file3",
                        *BASE],
    "best_skeletons": ["-rd", "@results", *BASE,
                       "--only-best-skeleton-matches"],
    "area_tags_compact": ["-rd", "@results", *BASE, "--anatomical-area",
                          "VNC", "--em-tags", "t1", "t2", "--processing-tag",
                          "ppp1", "--no-pretty-print"],
    "screenshots_dir": ["-rd", "@results", *BASE, "--screenshots-dir",
                        "absent", "--include-raw-skeleton-matches"],
}


def _args(argv, root: Path, res) -> list:
    out = []
    for a in argv:
        if a == "@results":
            a = root / "results"
        elif a.startswith("@file"):
            a = res.files[int(a[5:])]
        out.append(str(a))
    return out


@pytest.mark.parametrize("case", sorted(IMPORTS))
def test_import_ppp_files_identical_to_jax(ppp, tmp_path, case):
    root, res = ppp
    trees = {}
    for pkg in MAINS:
        out = tmp_path / pkg
        _run(pkg, ["importPPPResults", *_args(IMPORTS[case], root, res),
                   "-od", out])
        trees[pkg] = _tree(out, {})
    assert trees["port"] == trees["jax"]
    docs = [json.loads(b) for b in trees["port"].values()]
    assert len(docs) == {"prefix": 1, "files_over_dirs": 2}.get(case,
                                                                N_BODIES)
    assert all(d["results"] for d in docs)
    if case == "default":
        ranks = [r["rank"] for r in docs[0]["results"]]
        assert ranks == sorted(ranks)
        assert any(r.get("sourceImageFiles") for d in docs
                   for r in d["results"])


def _config(path: Path) -> Path:
    cfg = path.with_suffix(".properties")
    cfg.write_text(f"Store.Type=sqlite\nStore.Path={path}\n")
    return cfg


def _register(pkg: str, cfg: Path, docs: list) -> None:
    """The neurons `docs` into the package's store through its DAO."""
    daos = PERSIST[pkg].DaosProvider(PERSIST[pkg].Config(str(cfg)))
    for d in docs:
        daos.neuron_metadata_dao.create_or_update(
            MODELS[pkg].neuron_from_json(d))
    daos.store.close()


DB_IMPORTS = {
    "mips_and_results": ["--mips-storage", "DB", "--results-storage", "DB",
                         "--processing-tag", "ppp1", "--em-tags", "e1"],
    "results_only": ["--results-storage", "DB", "--processing-tag", "ppp1"],
    "mips_only": ["--mips-storage", "DB", "--processing-tag", "ppp1"],
    "mips_no_tag": ["--mips-storage", "DB", "--results-storage", "DB"],
}


@pytest.mark.parametrize("case", sorted(DB_IMPORTS))
def test_import_ppp_db_identical_to_jax(ppp, tmp_path, case):
    """The EM bodies but the last are in the store (and a neuron of
    another library with a body's published name); the import resolves
    the masks there, tags them, and stores its rows."""
    root, res = ppp
    docs = json.loads((root / "em_neurons.json").read_text())[:-1]
    docs.append(dict(docs[0], mipId="other", libraryName="other_lib"))
    trees, stores = {}, {}
    for pkg in MAINS:
        store = tmp_path / f"{pkg}.sqlite"
        cfg = _config(store)
        _register(pkg, cfg, docs)
        out = tmp_path / pkg
        _run(pkg, ["importPPPResults", "-rd", root / "results", *BASE,
                   "--neuron-matches-sub-dir", testing.PPP_SUB_DIR,
                   *DB_IMPORTS[case], "--config", cfg, "-od", out])
        trees[pkg] = _tree(out, {})
        stores[pkg] = testing.canonical_store(store)
    assert trees["port"] == trees["jax"]
    assert stores["port"] == stores["jax"]
    rows = stores["port"].get("pppMatches", [])
    assert len(rows) == (N_BODIES * N_MATCHES
                         if "--results-storage" in DB_IMPORTS[case] else 0)
    tagged = [n for n in stores["port"]["neuronMetadata"]
              if "PPPMatch" in (n.get("processedTags") or {})]
    assert len(tagged) == (N_BODIES - 1 if "--mips-storage"
                           in DB_IMPORTS[case] and "--processing-tag"
                           in DB_IMPORTS[case] else 0)


def test_import_and_convert_without_inputs_exit(tmp_path):
    for pkg in MAINS:
        for cmd in ("importPPPResults", "convertPPPResults"):
            with pytest.raises(SystemExit, match="no inputs"):
                MAINS[pkg]([cmd, "-od", str(tmp_path / pkg)])
        with pytest.raises(SystemExit, match="no inputs"):
            MAINS[pkg](["copyPPPMatches", "-od", str(tmp_path / pkg)])


# ---------------------------------------------------------------------------
# convertPPPResults, copyPPPMatches
# ---------------------------------------------------------------------------

CONVERTS = {
    "default": ["-rd", "@results"],
    "sub_dir": ["-rd", "@results", "--neuron-matches-sub-dir",
                testing.PPP_SUB_DIR],
    "files": ["-rd", "@results", "-rf", "@file1", "@file2",
              "--matches-prefix", "x"],
    "best_skeletons": ["-rd", "@results", "--only-best-skeleton-matches"],
    "libraries": ["-rd", "@results", "--em-library", "emlib",
                  "--lm-library", "lmlib", "--em-dataset", "vnc",
                  "--em-dataset-version", "0.9"],
    "dataset": ["-rd", "@results", "--em-dataset", "manc",
                "--em-dataset-version", "1.0.1", "-as",
                "JRC2018_VNC_Unisex_40x_DS", "--anatomical-area", "VNC"],
    "compact_no_shots": ["-rd", "@results", "--no-pretty-print",
                         "--screenshots-dir", "absent", "--jacs-url", "a",
                         "b"],
}


@pytest.mark.parametrize("case", sorted(CONVERTS))
def test_convert_ppp_identical_to_jax(ppp, tmp_path, case):
    root, res = ppp
    trees = {}
    for pkg in MAINS:
        out = tmp_path / pkg
        _run(pkg, ["convertPPPResults", *_args(CONVERTS[case], root, res),
                   "-od", out])
        trees[pkg] = _tree(out)
    assert trees["port"] == trees["jax"] and len(trees["port"]) > 1


@pytest.fixture(scope="module")
def converted(ppp, tmp_path_factory):
    """convertPPPResults' files (the port's), one of them with no
    screenshots, one with no results list."""
    root, _ = ppp
    out = tmp_path_factory.mktemp("converted")
    _run("port", ["convertPPPResults", "-rd", root / "results",
                  "--neuron-matches-sub-dir", testing.PPP_SUB_DIR,
                  "-od", out])
    (out / "extra.json").write_text(json.dumps({"maskPublishedName": "x"}))
    (out / "notes.txt").write_text("not a result file")
    return out


COPIES = {
    "input_dir": ["-i", "@in"],
    "results_dir_top": ["-rd", "@in", "--top", "3"],
    "files_filter": ["-i", "@in", "-rf", "@in/0", "@in/1",
                     "--filterInternalFields"],
    "truncate": ["-rd", "@in", "--truncatePartialResults"],
    "truncate_filter_top": ["-rd", "@in", "--truncatePartialResults",
                            "--filterInternalFields", "--top", "2"],
    "datasets": ["-rd", "@in", "--emDatasetMapping", "hemibrain:v1.2.1",
                 "--lmDatasetMapping", "split_gal4:v2.2", "-ps", "5"],
}


@pytest.mark.parametrize("case", sorted(COPIES))
def test_copy_ppp_identical_to_jax(converted, tmp_path, case):
    names = sorted(p.name for p in converted.glob("*.json"))
    argv = []
    for a in COPIES[case]:
        if a == "@in":
            a = str(converted)
        elif a.startswith("@in/"):
            a = str(converted / names[int(a[4:])])
        argv.append(a)
    trees = {}
    for pkg in MAINS:
        out = tmp_path / pkg
        _run(pkg, ["copyPPPMatches", *argv, "-od", out])
        trees[pkg] = _tree(out)
    assert trees["port"] == trees["jax"] and trees["port"]
    if "--filterInternalFields" in argv:
        for data in trees["port"].values():
            for r in json.loads(data).get("results", ()):
                assert not set(r) & {"sampleName", "sourceImageFiles",
                                     "skeletonMatches"}
    if "--truncatePartialResults" in argv:
        assert len(trees["port"]) < len(names)

