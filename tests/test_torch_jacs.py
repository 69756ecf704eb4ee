"""The port's JACS client (io/jacs.py) and the commands that read it,
against the JAX package.

The client runs on its file:// transport, a directory of page dumps
(testing.write_jacs_dump of testing.jacs_mip_records): no test opens a
socket. Paging, the record -> neuron mapping and the library and MIP
filters are compared function by function; createColorDepthSearchDataInput,
createColorDepthSearchJSONInput and groupMIPsByPublishedName with
--jacs-url, and importPPPResults with its JACS sample lookup, run
through both CLIs on the same dump and paths, and their files must be
byte-identical (stores in canonical form, the ids importPPPResults mints
by their ordinal: testing.canonical_ids). The cases cover those of the
JAX tests/test_jacs_ingest.py: paging, the EM/LM mapping, the three JACS
inputs, grouping from JACS, the library and MIP filters, --for-update,
custom directories and the library-name map.
"""

import json
import shutil
from pathlib import Path

import numpy as np
import pytest

import colormipsearch_tpu.io.jacs as j_jacs
import colormipsearch_tpu_torch.io.jacs as t_jacs
from colormipsearch_tpu.cli import main as jax_main
from colormipsearch_tpu_torch import testing
from colormipsearch_tpu_torch.cli import main as torch_main

MAINS = {"jax": jax_main.main, "port": torch_main.main}
JACS = {"jax": j_jacs, "port": t_jacs}
LM_LIB = "FlyLight Gen1 MCFO"
EM_LIB = "flyem_hemibrain_1_2_1"


def _same(runs: dict) -> tuple:
    assert runs["port"] == runs["jax"]
    return runs["port"]


def _libraries(i: int) -> list:
    return [["libX", "libY"], ["libX"], ["libX", "libZ"], []][i % 4]


@pytest.fixture(scope="module")
def jacs(tmp_path_factory):
    """A library of 9 LM images with gradient and z-gap variants (one
    z-gap missing), its JACS records as an LM dump (one page, and paged
    by 4) and as an EM dump, segmented images for some LM records, and a
    library-name map."""
    root = tmp_path_factory.mktemp("jacs")
    rng = np.random.default_rng(21)
    lib = testing.synthetic_library(rng, 9, 0, 10, 14, target_fg=0.2)
    neurons = testing.write_neuron_images(
        root / "lib", lib.targets, "t",
        gradients=[testing.synthetic_gradient(rng, t) for t in lib.targets],
        zgaps=[testing.synthetic_zgap(t, radius=2) for t in lib.targets],
        threads=2)
    (root / "lib" / "zgap" / "t00004_20pxRGB.png").unlink()
    lm = testing.jacs_mip_records(neurons, libraries=_libraries)
    lm.append(dict(lm[1], id="t-dup"))  # a duplicate of t-00001's key
    testing.write_jacs_dump(root / "lm", lm)
    testing.write_jacs_dump(root / "paged", lm, page_size=4)
    testing.write_jacs_dump(root / "em", testing.jacs_mip_records(
        neurons, em=True, libraries=_libraries))
    seg = root / "seg"
    seg.mkdir()
    for i in (0, 1, 2, 5):
        r = lm[i]
        ch = r["channelNumber"] if r["channelNumber"].isdigit() else "1"
        for extra in ("a", "b")[:1 + (i == 5)]:
            (seg / f"{r['sample']['slideCode']}-{extra}-{r['objective']}"
             f"_ch{ch}_CDM.png").write_bytes(b"png")
    (root / "libmap.json").write_text(json.dumps({"config": {
        LM_LIB: {"name": "FlyLight Gen1 MCFO Published"},
        EM_LIB: {"name": "FlyEM Hemibrain v1.2.1"}}}))
    return root


def _args(root: Path, argv: list) -> list:
    """@x -> a path under the fixture's root, file://@x -> its URL."""
    out = []
    for a in argv:
        if a.startswith("file://@"):
            a = f"file://{root / a[8:]}"
        elif a.startswith("@"):
            a = str(root / a[1:])
        out.append(a)
    return out


@pytest.mark.parametrize("page_size", [1, 4, 5, 10000])
def test_client_paging_equals_jax(jacs, page_size):
    """The client reads every page (the last one short, or empty past a
    full one) and maps each record as the JAX client does."""
    recs = {}
    for pkg, mod in JACS.items():
        client = mod.JacsClient(f"file://{jacs / 'paged'}/", page_size=4)
        client.page_size = page_size
        recs[pkg] = list(client.color_depth_mips_with_samples(
            library=LM_LIB, alignment_space="AS", datasets=["d"],
            releases=["r", ""], mips=["x"]))
    # pages are of 4 records: another page size ends early or reads on
    want = {1: 10, 4: 10, 5: 4, 10000: 4}[page_size]
    assert recs["port"] == recs["jax"] and len(recs["port"]) == want


RECORDS = {
    "em_with_files": ({"id": "x", "filepath": "/f.png", "bodyId": 12345,
                       "alignmentSpace": "AS", "emBodyRef": "EMBody#1",
                       "emBody": {"neuronType": "PFL1", "neuronInstance":
                                  "PFL1_R", "files": {
                                      "SkeletonSWC": "/swc/107.swc",
                                      "SkeletonOBJ": "/obj/107.obj"}}},
                      EM_LIB),
    "em_no_body": ({"_id": 17, "filepath": "/g.png",
                    "emBody": {"_id": "b1", "name": "named"}}, EM_LIB),
    "lm_sample": ({"id": "y", "filepath": "/g.png", "objective": "40x",
                   "anatomicalArea": "VNC", "channelNumber": "2",
                   "sampleRef": "Sample#3",
                   "sample": {"publishingName": "R10A07", "slideCode": "sc",
                              "gender": "m", "name": "s3", "line": "L3",
                              "mountingProtocol": "DPX"}}, LM_LIB),
    "lm_bad_channel": ({"id": "z", "filepath": "/h.png",
                        "channelNumber": "ch?"}, LM_LIB),
    "lm_unpublished": ({"id": 5, "filepath": "/i.png", "channelNumber": 3,
                        "sample": {"line": "internal"}}, LM_LIB),
    "no_filepath": ({"id": "w"}, LM_LIB),
}


@pytest.mark.parametrize("case", sorted(RECORDS))
def test_record_to_neuron_equals_jax(case):
    rec, library = RECORDS[case]
    got = {pkg: mod.mip_record_to_neuron(rec, library)
           for pkg, mod in JACS.items()}
    if case == "no_filepath":
        assert got == {"jax": None, "port": None}
        return
    assert got["port"].to_json() == got["jax"].to_json()
    assert type(got["port"]).__name__ == type(got["jax"]).__name__
    if case == "em_with_files":
        from colormipsearch_tpu_torch.model import ComputeFileType

        n = got["port"]
        assert type(n).__name__ == "EMNeuron" and n.published_name == "12345"
        assert n.compute_file(ComputeFileType.SkeletonSWC).name == \
            "/swc/107.swc"
    if case == "lm_sample":
        assert got["port"].published_name == "R10A07"
        assert got["port"].gender == "m" and got["port"].channel == 2


LOAD_CASES = {
    "all": {},
    "included": {"included_libraries": ["libX", "libY"]},
    "excluded": {"excluded_libraries": ["libZ"]},
    "mips": {"mips": ["t-00002", "t-00007", ""]},
    "variants": {"variant_locations": {
        "GradientImage": ["@lib/grad"], "ZGapImage": ["@lib/zgap"],
        "Bogus": ["@lib"]}, "variant_suffixes": {
        "GradientImage": "_gradient", "ZGapImage": "_20pxRGB"}},
}


@pytest.mark.parametrize("case", sorted(LOAD_CASES))
def test_load_library_neurons_equals_jax(jacs, case):
    kw = json.loads(json.dumps(LOAD_CASES[case]))
    for locs in (kw.get("variant_locations") or {}).values():
        locs[:] = _args(jacs, locs)
    got = {}
    for pkg, mod in JACS.items():
        client = mod.JacsClient(f"file://{jacs / 'lm'}", page_size=4)
        got[pkg] = [n.to_json() for n in mod.load_library_neurons(
            client, library=LM_LIB, **kw)]
    assert got["port"] == got["jax"]
    ids = [n["mipId"] for n in got["port"]]
    want = {"included": ["t-00000", "t-00004", "t-00008"],
            "excluded": ["t-00000", "t-00001", "t-00003", "t-00004",
                         "t-00005", "t-00007", "t-00008", "t-dup"],
            "mips": ["t-00002", "t-00007"]}
    if case in want:
        assert ids == want[case]
    if case == "variants":
        assert sum("ZGapImage" in n["computeFiles"] for n in got["port"]) \
            == 9  # t00004's is missing, the duplicate has t00001's


DATA_INPUT_CASES = {
    "default": ["-l", LM_LIB, "--alignment-space", "JRC2018_Unisex_20x_HR"],
    "variants": ["-l", LM_LIB, "--libraries-variants",
                 "GradientImage:@lib/grad:_gradient",
                 "ZGapImage:@lib/zgap:_20pxRGB", "bad"],
    "filters": ["-l", LM_LIB, "--included-libraries", "libX",
                "--excluded-libraries", "libZ", "--mips", "t-00001",
                "t-00003", "t-00004", "t-00005", "--tag", "jacs", "batch"],
    "neuron_filters": ["-l", LM_LIB, "--excluded-neurons", "t-00002",
                       "t00003", "--datasets", "d1", "--releases", "r1"],
    "included_neurons": ["-l", LM_LIB, "--included-neurons", "t00005",
                         "t-00006", "--authorization", "token"],
    "em": ["-l", EM_LIB, "--jacs-url", "file://@em", "--no-pretty-print"],
    "for_update": ["-l", LM_LIB, "--mips", "t-00000", "t-00001",
                   "--for-update", "--tag", "again"],
}


@pytest.mark.parametrize("case", sorted(DATA_INPUT_CASES))
def test_create_data_input_from_jacs_identical_to_jax(jacs, tmp_path, case):
    out = tmp_path / "inputs"
    target = out / "jacs.json"
    inputs = []
    if case == "for_update":
        # an earlier output of the whole library, updated in place
        assert torch_main.main(_args(jacs, [
            "createColorDepthSearchDataInput", "--jacs-url", "file://@lm",
            "-l", LM_LIB, "-od", str(out), "--output-filename",
            "jacs.json"])) == 0
        inputs.append(target)
    argv = _args(jacs, ["createColorDepthSearchDataInput", "--jacs-url",
                        "file://@lm", *DATA_INPUT_CASES[case], "-od",
                        str(out), "--output-filename", "jacs.json"])
    rc, _, (data,) = _same(testing.run_clis(MAINS, argv, inputs=inputs,
                                            outputs=[target]))
    assert rc == 0
    docs = json.loads(data)
    n = {"filters": 3, "neuron_filters": 8, "included_neurons": 2, "em": 9}
    assert len(docs) == n.get(case, 10)
    if case == "default":
        assert docs[0]["class"].endswith("LMNeuronEntity")
        assert docs[1]["channel"] == 2 and "channel" not in docs[0]
        assert "SourceColorDepthImage" in docs[0]["computeFiles"]
    if case == "em":
        assert docs[0]["class"].endswith("EMNeuronEntity")
    if case == "for_update":
        assert [d.get("tags") for d in docs[:3]] == \
            [["again"], ["again"], None]


def test_create_data_input_from_jacs_into_the_store(jacs, tmp_path):
    """--mips-storage DB: the stores are equal in canonical form."""
    canon = {}
    for pkg, main in MAINS.items():
        cfg = tmp_path / f"{pkg}.properties"
        cfg.write_text(f"Store.Type=sqlite\nStore.Path="
                       f"{tmp_path / pkg}.sqlite\n")
        assert main(_args(jacs, [
            "createColorDepthSearchDataInput", "--jacs-url", "file://@lm",
            "-l", LM_LIB, "--libraries-variants",
            "GradientImage:@lib/grad:_gradient", "--mips-storage", "DB",
            "--config", str(cfg)])) == 0
        canon[pkg] = testing.canonical_store(tmp_path / f"{pkg}.sqlite")
    assert canon["port"] == canon["jax"]
    assert len(canon["port"]["neuronMetadata"]) == 10


JSON_INPUT_CASES = {
    "relative_urls": ["--alignment-space", "JRC2018_Unisex_20x_HR",
                      "--urls-relative-to", "1", "--excluded-names",
                      "t00002"],
    "segmented_only": ["--segmented-mips-variant", "@seg",
                       "--segmented-image-handling", "0x2"],
    "segmented_default": ["--segmented-mips-variant", "@seg"],
    "segmented_with_original": ["--segmented-mips-variant", "@seg",
                                "--segmented-image-handling", "0x1",
                                "--segmentation-channel-base", "0"],
    "segmented_and_original": ["--segmented-mips-variant", "@seg",
                               "--segmented-image-handling", "0x4"],
    "variant_segmentation": ["--librariesVariants",
                             f"{LM_LIB}:segmentation:@seg",
                             f"{LM_LIB}:grad:@lib/grad:_gradient"],
    "unpublished_dups": ["--include-mips-without-publishing-name",
                         "--keep-dups", "--default-gender", "x",
                         "--excluded-mips", "t-00003"],
    "library_filters": ["--included-libraries", "libX",
                        "--excluded-libraries", "libY", "--datasets", "d",
                        "--releases", "r"],
    "library_map": ["--config-url", "file://@libmap.json",
                    "--no-pretty-print"],
    "em": ["--jacs-url", "file://@em", "-l", EM_LIB, "--urls-relative-to",
           "0"],
}


@pytest.mark.parametrize("case", sorted(JSON_INPUT_CASES))
def test_create_json_input_from_jacs_identical_to_jax(jacs, tmp_path, case):
    out = tmp_path / "v2"
    flags = JSON_INPUT_CASES[case]
    lib = [] if "-l" in flags else ["-l", LM_LIB]
    argv = _args(jacs, ["createColorDepthSearchJSONInput", "--jacs-url",
                        "file://@lm", *lib, *flags, "--output-filename",
                        "lib.json", "-od", str(out)])
    rc, _, (data,) = _same(testing.run_clis(MAINS, argv,
                                            outputs=[out / "lib.json"]))
    assert rc == 0
    mips = json.loads(data)
    names = [m.get("publishedName") for m in mips]
    if case == "relative_urls":
        assert "t00002" not in names and "t00006" not in names
        # the file's path from its second component on
        assert all(m["imageURL"] == "/".join(m["cdmPath"].split("/")[2:])
                   for m in mips)
    if case == "segmented_only":
        assert names == ["t00000", "t00001", "t00002", "t00005", "t00005"]
        assert all("_CDM.png" in m["imageName"] for m in mips)
    if case == "segmented_and_original":
        # the 9 published MIPs and the 5 segmented images of 4 of them
        assert len(mips) == 9 + 5
    if case == "unpublished_dups":
        # the duplicate kept, t-00003 excluded
        assert len(mips) == 9 and names.count("t00001") == 2
    if case == "library_map":
        assert {m["libraryName"] for m in mips} == \
            {"FlyLight Gen1 MCFO Published"}


def test_create_json_input_from_jacs_appends(jacs, tmp_path):
    """--append-output merges into the existing list without duplicating
    ids."""
    out = tmp_path / "v2"
    first = _args(jacs, ["createColorDepthSearchJSONInput", "--jacs-url",
                         "file://@lm", "-l", LM_LIB, "--excluded-names",
                         "t00002", "t00003", "--output-filename", "lib.json",
                         "-od", str(out)])
    assert torch_main.main(first) == 0
    argv = _args(jacs, ["createColorDepthSearchJSONInput", "--jacs-url",
                        "file://@lm", "-l", LM_LIB, "--append-output",
                        "--output-filename", "lib.json", "-od", str(out)])
    rc, _, (data,) = _same(testing.run_clis(
        MAINS, argv, inputs=[out / "lib.json"], outputs=[out / "lib.json"]))
    ids = [m["id"] for m in json.loads(data)]
    assert rc == 0 and len(ids) == len(set(ids)) == 9


GROUP_CASES = {
    "default": [],
    "custom_dirs_and_map": ["--config-url", "file://@libmap.json",
                            "--lines-directory", "lines", "--keep-dups"],
    "em": ["--jacs-url", "file://@em", "-l", EM_LIB,
           "--skeletons-directory", "bodies", "--urls-relative-to", "1"],
    "filters": ["--included-libraries", "libX", "--excluded-libraries",
                "libZ", "--include-mips-without-publishing-name",
                "--no-pretty-print"],
    "two_libraries": ["-l", LM_LIB, EM_LIB, "--datasets", "d"],
}


@pytest.mark.parametrize("case", sorted(GROUP_CASES))
def test_group_mips_from_jacs_identical_to_jax(jacs, tmp_path, case):
    out = tmp_path / "grouped"
    flags = GROUP_CASES[case]
    lib = [] if "-l" in flags else ["-l", LM_LIB]
    argv = _args(jacs, ["groupMIPsByPublishedName", "--jacs-url",
                        "file://@lm", *lib, *flags, "-od", str(out)])
    rc, _, (tree,) = _same(testing.run_clis(MAINS, argv, outputs=[out]))
    assert rc == 0 and tree
    if case == "default":
        # t00006's sample has no publishing name: its line names it
        assert sorted(tree) == ["by_line/line6.json"] + [
            f"by_line/t0000{i}.json" for i in (0, 1, 2, 3, 4, 5, 7, 8)]
    if case == "custom_dirs_and_map":
        doc = json.loads(tree["lines/t00001.json"])
        assert len(doc) == 2
        assert doc[0]["libraryName"] == "FlyLight Gen1 MCFO Published"
    if case == "em":
        assert all(k.startswith("bodies/") for k in tree)
    if case == "two_libraries":
        assert {k.split("/")[0] for k in tree} == {"by_line", "by_body"}


def test_group_mips_without_libraries_is_an_error(jacs, tmp_path):
    argv = _args(jacs, ["groupMIPsByPublishedName", "--jacs-url",
                        "file://@lm", "-od", str(tmp_path)])
    runs = testing.run_clis(MAINS, argv)
    assert runs["port"] == runs["jax"] and runs["port"][0] == 1


def test_import_ppp_with_jacs_samples_identical_to_jax(tmp_path):
    """importPPPResults --jacs-url: the LM samples looked up by name
    (a file:// samples dump) set the matched neurons' published names
    and slide codes."""
    from colormipsearch_tpu_torch.io import ppp as ppp_io

    ppp = testing.write_ppp_results(tmp_path / "ppp",
                                    np.random.default_rng(3), 3, 12,
                                    shot_bodies=1, shots_every=3)
    names = sorted({ppp_io.lm_sample_name(lm) for f in ppp.files
                    for lm in next(iter(json.load(open(f)).values()))})
    samples = [{"name": n, "publishingName": f"PUB_{i}" if i % 3 else None,
                "slideCode": f"SC_{i}" if i % 4 else None}
               for i, n in enumerate(names[::2])]
    samples.append({"publishingName": "nameless"})
    testing.write_jacs_dump(tmp_path / "jacs", samples,
                            endpoint=testing.JACS_SAMPLES_ENDPOINT)
    out = tmp_path / "imported"
    trees = {}
    for pkg, main in MAINS.items():
        shutil.rmtree(out, ignore_errors=True)
        assert main(["importPPPResults", "-rd", str(tmp_path / "ppp"),
                     "--jacs-url", f"file://{tmp_path / 'jacs'}",
                     "--authorization", "t", "-od", str(out)]) == 0
        ordinals: dict = {}
        trees[pkg] = {p.name: testing.canonical_ids(p.read_text(), ordinals)
                      for p in sorted(out.glob("*.json"))}
    assert trees["port"] == trees["jax"] and len(trees["port"]) == 3
    text = "".join(trees["port"].values())
    assert '"publishedName": "PUB_1"' in text and '"SC_1"' in text
