"""The port's exportData against the JAX CLI, and the parsers of the five
PPP and publish commands.

One synthetic set of neurons and color depth matches (EM masks against
LM targets and LM masks against EM targets: tags, terms, libraries,
alignment spaces, samples, duplicate pairs, ties in the normalized
score, rows without a gradient score, rows the validating skip drops)
is written as per-mask match files and put into a sqlite store of each
package through its own DAOs, with the publish collections the export
reads beside it (publishedURL, publishedLMImage with Gen1 GAL4/LexA
rows, pppMatches and pppmURL: testing.py). Each case runs one exportData
through both CLIs, each on a copy of its own store, and the two output
trees must be byte-identical. The cases cover every result type from
files and from the DB and the filters and enrichments of the JAX
tests/test_cli_aux_commands.py that read no reference fixture.
"""

import json
import shutil
from pathlib import Path

import numpy as np
import pytest

import colormipsearch_tpu.model as j_model
import colormipsearch_tpu.persist as j_persist
import colormipsearch_tpu_torch.model as t_model
import colormipsearch_tpu_torch.persist as t_persist
from colormipsearch_tpu.cli import main as jax_main
from colormipsearch_tpu_torch import testing
from colormipsearch_tpu_torch.cli import main as torch_main
from colormipsearch_tpu_torch.dataio.json_io import write_neurons_json

MAINS = {"jax": jax_main.main, "port": torch_main.main}
MODELS = {"jax": j_model, "port": t_model}
PERSIST = {"jax": j_persist, "port": t_persist}
AS = "JRC2018_Unisex_20x_HR"
AS_VNC = "JRC2018_VNC_Unisex_40x_DS"
ALIAS = "JRC2018_Unisex_20x_HR_ALIAS"
EM_LIB = "flyem_hemibrain_1_2_1"
MCFO = "flylight_gen1_mcfo_published"
SPLIT = "flylight_split_gal4_drivers"
PORT_COMMANDS = ("exportData", "importPPPResults", "tag",
                 "convertPPPResults", "copyPPPMatches")


def _neurons() -> tuple[list, list]:
    """(EM neurons, LM neurons) of the port, without ids: every field the
    export reads or filters on varies."""
    em = []
    for i in range(6):
        em.append(t_model.EMNeuron(
            mip_id=f"em{i}", library_name=EM_LIB, alignment_space=AS,
            published_name=f"N{min(i, 3)}" if i != 5 else None,
            source_ref_id=f"Body#{i}", neuron_type=f"T{i % 2}",
            neuron_instance=f"T{i % 2}_R" if i % 2 else None,
            state="traced" if i < 3 else None,
            tags=set([("validated",), ("validated", "old"), (),
                      ("validated",), ("old",), ()][i]),
            neuron_terms=[["t1"], ["t2"], None, ["t1", "t3"], None,
                          None][i]))
    lm = []
    for i in range(10):
        lm.append(t_model.LMNeuron(
            mip_id=f"lm{i}", library_name=(MCFO, SPLIT, MCFO, MCFO, SPLIT,
                                           MCFO, MCFO, None, MCFO, SPLIT)[i],
            alignment_space=AS if i != 6 else AS_VNC,
            published_name=f"R{i % 6}" if i != 8 else None,
            slide_code=f"2019050{i}_62_F1", gender="fm"[i % 2],
            objective=("40x", "63x", None)[i % 3], channel=1 + i % 2,
            anatomical_area=("Brain", "VNC")[i % 2],
            mounting_protocol="DPX PBS Mounting" if i % 4 == 0 else None,
            sample_ref=f"Sample#{i}" if i % 5 != 4 else None,
            tags={"good"} if i % 3 == 0 else ({"bad"} if i == 4 else set()),
            neuron_terms=["t1"] if i % 4 == 1 else None))
    return em, lm


def _match_rows(masks, targets, rng) -> list:
    """(mask index, target index, match fields) rows: most pairs, one
    pair twice, ties in normalizedScore, rows without or with a negative
    gradient score, a suspicious and a scoreless row."""
    rows = []
    for a in range(len(masks)):
        for b in range(len(targets)):
            if (a + b) % 4 == 3:
                continue
            px = int(rng.integers(20, 400))
            fields = {
                "mirrored": bool((a + b) % 2),
                "matchingPixels": px,
                "matchingPixelsRatio": float(np.float32(px / 4000)),
                "normalizedScore": float((a * 7 + b * 3) % 5 * 100 + 50),
                "gradientAreaGap": (None, -1, 0, 1200, 350)[(a + b) % 5],
                "highExpressionArea": (None, -1, 4, 80, 9)[(a + b) % 5],
            }
            if (a, b) == (1, 2):
                fields["tags"] = ["suspicious"]
            if (a, b) == (2, 5):
                fields["matchingPixels"] = None
            if b % 3 == 1:
                fields["files"] = {
                    "CDMInput": f"https://s3.amazonaws.com/b/v3/in/{a}.png",
                    "CDMMatch": f"/nrs/local/match/{a}-{b}.png"}
            rows.append((a, b, fields))
            if (a, b) == (0, 1):
                rows.append((a, b, dict(fields, mirrored=not
                                        fields["mirrored"],
                                        normalizedScore=999.0)))
    return rows


def _match(model, mask, target, fields):
    m = model.CDMatch.from_json(
        {k: v for k, v in fields.items() if v is not None}, mask_image=mask)
    m.matched_image = target
    return m


def _write_match_files(out: Path, masks, targets, rows) -> None:
    """Per-mask match files in the v3 shape, rows in `rows`' order."""
    out.mkdir(parents=True)
    by_mask: dict = {}
    for a, b, fields in rows:
        m = _match(t_model, masks[a], targets[b], fields)
        row = m.to_json()
        row.pop("maskImage", None)
        by_mask.setdefault(a, []).append(row)
    for a, results in by_mask.items():
        (out / f"{masks[a].mip_id}.json").write_text(json.dumps(
            {"inputImage": masks[a].to_json(), "results": results},
            indent=2))


def _populate(pkg: str, cfg: Path, em, lm, rows, lm_rows, ppp_dir):
    """The package's store, through its own DAOs and CLI: the neurons,
    both match sets (one row per pair), the publish collections and the
    PPP matches of importPPPResults plus three with LM samples."""
    model, persist = MODELS[pkg], PERSIST[pkg]
    daos = persist.DaosProvider(persist.Config(str(cfg)))
    ndao = daos.neuron_metadata_dao
    ems = [ndao.save(model.neuron_from_json(n.to_json())) for n in em]
    lms = [ndao.save(model.neuron_from_json(n.to_json())) for n in lm]
    seen = set()
    for masks, targets, rs in ((ems, lms, rows), (lms[:3], ems, lm_rows)):
        ms = []
        for a, b, fields in rs:
            if (id(masks), a, b) in seen:
                continue
            seen.add((id(masks), a, b))
            m = _match(model, masks[a], targets[b], fields)
            m.mask_image_ref_id = masks[a].entity_id
            m.matched_image_ref_id = targets[b].entity_id
            ms.append(m)
        daos.cd_matches_dao.create_or_update_all(ms)
    daos.store.collection("publishedURL").insert_many(
        testing.published_url_docs(ems + lms))
    daos.published_lm_images_dao.save_all(
        [model.PublishedLMImage.from_json(d)
         for d in testing.published_lm_image_docs(lms, ALIAS)])
    daos.store.close()
    assert MAINS[pkg](["importPPPResults", "-rd", str(ppp_dir),
                       "--em-library", EM_LIB, "--lm-library", MCFO, "-as",
                       AS, "--results-storage", "DB", "--processing-tag",
                       "ppp1", "--config", str(cfg)]) == 0
    daos = persist.DaosProvider(persist.Config(str(cfg)))
    extra = []
    for i, lm_n in enumerate(lms[:3]):
        extra.append(model.PPPMatch(
            mask_image=ems[0], matched_image=lm_n,
            mask_image_ref_id=ems[0].entity_id,
            source_em_name="5555-T0-RT_18U",
            source_lm_name=f"{lm_n.published_name}-{lm_n.slide_code}"
                           f"_REG_UNISEX_{('40x', 'Brain', '63x')[i]}",
            coverage_score=-12.75 * (i + 1), aggregate_coverage=2.5 * i,
            rank=float(3 - i), source_em_library=EM_LIB,
            source_lm_library=MCFO,
            source_image_files={"CH": f"s{i}_5_ch.png",
                                "SKEL": f"s{i}_3_skel.png"}))
    daos.ppp_matches_dao.save_all(extra)
    daos.store.collection("pppmURL").insert_many(
        testing.pppm_url_docs(daos.ppp_matches_dao.find_all()))
    daos.store.close()


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """The inputs: match files, neuron files, URL and library maps,
    imported PPP files, and each package's populated store."""
    root = tmp_path_factory.mktemp("export")
    rng = np.random.default_rng(11)
    em, lm = _neurons()
    rows = _match_rows(em, lm, rng)
    lm_rows = _match_rows(lm[:3], em, rng)
    _write_match_files(root / "em_masks", em, lm, rows)
    _write_match_files(root / "lm_masks", lm[:3], em, lm_rows)
    write_neurons_json(em, root / "em_neurons.json")
    write_neurons_json(lm, root / "lm_neurons.json")
    (root / "urls.json").write_text(json.dumps(
        testing.published_url_map(em + lm)))
    (root / "libmap.json").write_text(json.dumps({"config": {
        EM_LIB: {"name": "FlyEM_Hemibrain_v1.2.1"},
        MCFO: {"name": "FlyLight Gen1 MCFO"},
        SPLIT: {"other": "no name"}, "x": "not a map"}}))
    (root / "badmap.json").write_text(json.dumps({"config": ["a"]}))
    ppp = testing.write_ppp_results(
        root / "ppp", np.random.default_rng(12), 4, 9, rank_step=90.0,
        shot_bodies=2, shots_every=2)
    assert torch_main.main([
        "importPPPResults", "-rd", str(root / "ppp"), "--em-library",
        EM_LIB, "--lm-library", MCFO, "-as", AS,
        "-od", str(root / "ppp_files")]) == 0
    stores = {}
    for pkg in MAINS:
        store = root / f"{pkg}.sqlite"
        cfg = store.with_suffix(".properties")
        cfg.write_text(f"Store.Type=sqlite\nStore.Path={store}\n")
        _populate(pkg, cfg, em, lm, rows, lm_rows, root / "ppp")
        stores[pkg] = store
    canon = {pkg: testing.canonical_store(s) for pkg, s in stores.items()}
    assert canon["port"] == canon["jax"]
    assert {"publishedURL", "publishedLMImage", "pppMatches",
            "pppmURL"} <= set(canon["port"])
    return root, stores


def _tree(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def _export(data, tmp_path, argv) -> dict:
    """exportData `argv` through both CLIs ("@x" a file of the inputs,
    the DB cases on a copy of each package's store); their output
    trees, which must be equal."""
    root, stores = data
    trees = {}
    for pkg in MAINS:
        args = []
        for a in argv:
            if a.startswith("file://@"):
                a = "file://" + str(root / a[8:])
            elif a.startswith("@"):
                a = str(root / a[1:])
            args.append(a)
        if "DB" in args:
            store = tmp_path / f"{pkg}.sqlite"
            shutil.copy(stores[pkg], store)
            cfg = store.with_suffix(".properties")
            cfg.write_text(f"Store.Type=sqlite\nStore.Path={store}\n")
            args += ["--config", str(cfg)]
        out = tmp_path / pkg
        assert MAINS[pkg](["exportData", *args, "-od", str(out)]) == 0
        trees[pkg] = _tree(out)
    assert trees["port"] == trees["jax"]
    assert trees["port"], "the export wrote no file"
    return {k: json.loads(v) for k, v in trees["port"].items()}


EM_CD = ["--exported-result-type", "EM_CD_MATCHES", "-md", "@em_masks"]
URLS = ["--published-urls", "@urls.json", "--default-relative-url-index",
        "2", "--relative-url-indexes-by-filetype", "CDMThumbnail:1:true",
        "CDMInput:0", "--default-image-store", "brain-store",
        "--image-stores-per-neuron-meta", f"{AS},{MCFO}:mcfo-store",
        f"{AS_VNC}:vnc-store"]
FS_CASES = {
    "default": [*EM_CD],
    "ignore_grad_scores": [*EM_CD, "--ignore-grad-scores"],
    "pct_positive_pixels": [*EM_CD, "--pctPositivePixels", "1.0"],
    "pct_without_grad": [*EM_CD, "--pctPositivePixels", "5.5",
                         "--ignore-grad-scores"],
    "neuron_filters": [*EM_CD, "--ignore-grad-scores", "--neuron-tags",
                       "validated", "--target-library", MCFO,
                       "--excluded-matches-tags", "suspicious"],
    "tag_term_filters": [*EM_CD, "--ignore-grad-scores",
                         "--excluded-neuron-tags", "old", "--target-tags",
                         "good", "bad", "--excluded-target-tags", "bad",
                         "--neuron-terms", "t1", "t3"],
    "term_exclusions": [*EM_CD, "--ignore-grad-scores",
                        "--excluded-neuron-terms", "t2", "--target-terms",
                        "t1", "--excluded-target-terms", "t9"],
    "offset_size": [*EM_CD, "--ignore-grad-scores", "--offset", "1",
                    "--size", "2"],
    "exported_mips": [*EM_CD, "--ignore-grad-scores", "--exported-mips",
                      "em3", "em1"],
    "urls_and_stores": [*EM_CD, *URLS],
    "library_names": [*EM_CD, "--ignore-grad-scores", "--config-url",
                      "file://@libmap.json",
                      "--image-stores-per-neuron-meta",
                      f"{AS},{EM_LIB}:em-store"],
    "library_names_unreadable": [*EM_CD, "--config-url",
                                 "file://@badmap.json"],
    "library_names_absent": [*EM_CD, "--config-url", "file://@absent.json"],
    "compact_subdir": [*EM_CD, "--no-pretty-print", "--subdir", "v3.0",
                       "--jacs-url", "http://localhost:1", "--authorization",
                       "x", "-ps", "10", "--read-batch-size", "5"],
    "lm_cd_matches": ["--exported-result-type", "LM_CD_MATCHES", "-md",
                      "@lm_masks", "--ignore-grad-scores", *URLS],
    "em_mips": ["--exported-result-type", "EM_MIPS", "--mips",
                "@em_neurons.json", "@lm_neurons.json"],
    "lm_mips_urls": ["--exported-result-type", "LM_MIPS", "--mips",
                     "@lm_neurons.json", *URLS, "--config-url",
                     "file://@libmap.json"],
    "ppp_files": ["--exported-result-type", "EM_PPP_MATCHES", "-md",
                  "@ppp_files", "--default-relative-url-index", "3"],
    "ppp_files_compact": ["--exported-result-type", "EM_PPP_MATCHES",
                          "--matches", "@ppp_files", "--no-pretty-print",
                          *URLS],
}


@pytest.mark.parametrize("case", sorted(FS_CASES))
def test_export_from_files_identical_to_jax(data, tmp_path, case):
    docs = _export(data, tmp_path, FS_CASES[case])
    text = json.dumps(docs)
    if case == "library_names":
        assert "FlyEM_Hemibrain_v1.2.1" in text and "em-store" in text
    if case.startswith("library_names_"):
        assert EM_LIB in text
    if case == "urls_and_stores":
        assert "mcfo-store" in text and "brain-store" in text
        assert '"cdm/em0.png"' in text  # an https URL from component 2
    if case == "offset_size":
        assert sorted(docs) == ["N1.json", "N2.json"]
    if case.startswith("ppp"):
        rows = [r for d in docs.values() for r in d["results"]]
        assert len(rows) == 4 * 9 and any("files" in r for r in rows)


DB = ["--results-storage", "DB"]
DB_CASES = {
    "em_cd": [*EM_CD, *DB, "-l", EM_LIB],
    "em_cd_alias": [*EM_CD, *DB, "--ignore-grad-scores",
                    "--published-alignment-space-alias", f"{AS}={ALIAS}",
                    f"{AS_VNC}:{ALIAS},other"],
    "em_cd_selectors": [*EM_CD, *DB, "-as", AS, "--exported-names", "N1",
                        "N3", "--neuron-tags", "validated",
                        "--ignore-grad-scores", "--target-library", MCFO,
                        "--pctPositivePixels", "1"],
    "em_cd_stores": [*EM_CD, *DB, "--ignore-grad-scores", *URLS],
    "em_cd_same_store": [*EM_CD, *DB, "--ignore-grad-scores",
                         "--default-image-store", "one-store",
                         "--config-url", "file://@libmap.json"],
    "lm_cd": ["--exported-result-type", "LM_CD_MATCHES", *DB, "-l", MCFO,
              SPLIT, "--ignore-grad-scores", "--offset", "1"],
    "em_mips": ["--exported-result-type", "EM_MIPS", *DB, "-l", EM_LIB,
                "--default-relative-url-index", "4"],
    "lm_mips": ["--exported-result-type", "LM_MIPS", *DB, "-as", AS,
                "--exported-names", "R0", "R1", "R2", "R3",
                "--published-alignment-space-alias", f"{AS}={ALIAS}"],
    "lm_mips_tags": ["--exported-result-type", "LM_MIPS", *DB,
                     "--neuron-tags", "good"],
    "ppp": ["--exported-result-type", "EM_PPP_MATCHES", *DB],
    "ppp_alias": ["--exported-result-type", "EM_PPP_MATCHES", *DB,
                  "--published-alignment-space-alias", f"{AS}={ALIAS}",
                  "--default-relative-url-index", "2"],
}


@pytest.mark.parametrize("case", sorted(DB_CASES))
def test_export_from_db_identical_to_jax(data, tmp_path, case):
    docs = _export(data, tmp_path, DB_CASES[case])
    text = json.dumps(docs)
    if case in ("em_cd", "em_cd_stores"):
        assert "CDMInput" in text and "searchable" in text
    if case in ("em_cd_alias", "lm_mips"):
        assert "VisuallyLosslessStack" in text and "Gal4Expression" in text
    if case == "ppp_alias":
        assert "VisuallyLosslessStack" in text and "CDMBestThumbnail" in text


@pytest.mark.parametrize("command", PORT_COMMANDS)
def test_parser_equals_jax(command):
    """Option strings, destinations, defaults, choices, nargs, types and
    required flags of the command's parser are the JAX CLI's."""
    def actions(main):
        sub = next(a for a in main.build_parser()._actions
                   if a.__class__.__name__ == "_SubParsersAction")
        return [(a.option_strings, a.dest, a.default, a.choices, a.nargs,
                 getattr(a.type, "__name__", a.type), a.required, a.const)
                for a in sub.choices[command]._actions]

    assert actions(torch_main) == actions(jax_main)
