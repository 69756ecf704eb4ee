"""The port's tag command against the JAX CLI.

The same neurons (differing in every field a selector reads: published
name, library, mip id, source reference, alignment space, tags, dataset
labels, processing tags) as neuron JSON files, which tag rewrites in
place (each package on a copy of its own; the files must be
byte-identical after), and in a sqlite store of each package, filled
through its own DAOs (the two stores must be equal in canonical form
after, testing.canonical_store).
"""

import json
import shutil

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


def _neurons() -> list:
    """Twelve neurons of the port, EM and LM, without ids."""
    out = []
    for i in range(12):
        cls = t_model.EMNeuron if i < 5 else t_model.LMNeuron
        n = cls(mip_id=f"n{i}", published_name=f"P{i % 7}",
                library_name=("libA", "libB", "libC")[i % 3],
                alignment_space="AS" if i % 4 else "AS_VNC",
                source_ref_id=f"Ref#{i % 5}",
                tags=set([("good",), ("old",), (), ("good", "old")][i % 4]),
                dataset_labels={f"d{i % 3}"} if i % 2 else set())
        n.set_compute_file(t_model.ComputeFileType.InputColorDepthImage,
                           f"/imgs/n{i}.png")
        if i % 3 == 0:
            n.add_processed_tags(t_model.ProcessingType.GradientScore,
                                 ["gs1"])
        if i % 4 == 1:
            n.add_processed_tags(t_model.ProcessingType.ColorDepthSearch,
                                 ["cds1", "cds2"])
        out.append(n)
    return out


SELECTORS = {
    "published_names": ["--published-names", "P1", "P3"],
    "libraries": ["-l", "libA", "libC", "--tag", "t2"],
    "mip_ids": ["--mip-ids", "n1", "n7", "n11"],
    "source_refs": ["--source-refs", "Ref#1", "Ref#4"],
    "alignment_space": ["--alignment-space", "AS_VNC"],
    "data_tags": ["--data-tags", "good"],
    "excluded_data_tags": ["--excluded-data-tags", "old"],
    "data_labels": ["--data-labels", "d1", "d2"],
    "processing_type": ["--processing-type", "GradientScore", "-l", "libB"],
    "processing_tags": ["--processing-tags", "GradientScore=gs1",
                        "ColorDepthSearch=cds2", "malformed"],
    "combined": ["-l", "libA", "libB", "--data-tags", "good",
                 "--excluded-data-tags", "old", "--published-names", "P0",
                 "P1", "P4", "-as", "AS_VNC", "--processing-type",
                 "ColorDepthSearch"],
    "everything": [],
}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("tag")
    ns = _neurons()
    write_neurons_json(ns[:7], root / "a.json")
    write_neurons_json(ns[7:], root / "b.json", pretty=False)
    return root


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("case", sorted(SELECTORS))
def test_tag_files_identical_to_jax(files, tmp_path, case, compact):
    trees = {}
    for pkg in MAINS:
        d = tmp_path / pkg
        shutil.copytree(files, d)
        argv = ["tag", "-i", str(d / "a.json"), str(d / "b.json"),
                "--tag", "t1", *SELECTORS[case]]
        if compact:
            argv.append("--no-pretty-print")
        assert MAINS[pkg](argv) == 0
        trees[pkg] = {p.name: p.read_bytes() for p in sorted(d.iterdir())}
    assert trees["port"] == trees["jax"]
    if case != "processing_tags":  # FS tagging ignores that selector
        changed = [name for name, data in trees["port"].items()
                   if data != (files / name).read_bytes()]
        assert changed


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """Each package's store holding the neurons."""
    root = tmp_path_factory.mktemp("tagdb")
    out = {}
    for pkg in MAINS:
        store = root / f"{pkg}.sqlite"
        daos = PERSIST[pkg].DaosProvider(PERSIST[pkg].Config(overrides={
            "Store.Path": str(store)}))
        for n in _neurons():
            daos.neuron_metadata_dao.create_or_update(
                MODELS[pkg].neuron_from_json(n.to_json()))
        daos.store.close()
        out[pkg] = store
    return out


@pytest.mark.parametrize("case", sorted(SELECTORS))
def test_tag_db_identical_to_jax(stores, tmp_path, case):
    canon = {}
    for pkg in MAINS:
        store = tmp_path / f"{pkg}.sqlite"
        shutil.copy(stores[pkg], store)
        cfg = tmp_path / f"{pkg}.properties"
        cfg.write_text(f"Store.Type=sqlite\nStore.Path={store}\n")
        assert MAINS[pkg](["tag", "--tag", "t1", *SELECTORS[case],
                           "--config", str(cfg)]) == 0
        canon[pkg] = testing.canonical_store(store)
    assert canon["port"] == canon["jax"]
    assert canon["port"] != testing.canonical_store(stores["port"])


def test_tag_rewrites_only_the_selected(files, tmp_path):
    """--published-names tags exactly the named neurons (the JAX
    tests/test_cli_aux_commands.py scope), in both packages."""
    for pkg in MAINS:
        d = tmp_path / pkg
        shutil.copytree(files, d)
        assert MAINS[pkg](["tag", "-i", str(d / "a.json"), "--tag", "v1",
                           "--published-names", "P2"]) == 0
        tagged = {n["mipId"] for n in json.loads(
            (d / "a.json").read_text()) if "v1" in n.get("tags", ())}
        assert tagged == {"n2"}, pkg
