"""The port's v2 list commands (groupMIPsByPublishedName in local mode,
replaceAttributes, mergeMips) against the JAX CLI.

Each case runs one command line through both CLIs on the same synthetic
MIP lists and result files (testing.py, seeded with numpy) and the same
paths (testing.run_clis); the files each writes must be byte-identical.
The JACS mode of groupMIPsByPublishedName is in test_torch_jacs.py. The
cases cover the JAX tests/test_cli_aux_commands.py
test_merge_mips_and_group.
"""

import json
from pathlib import Path

import numpy as np
import pytest

from colormipsearch_tpu.cli import main as jax_main
from colormipsearch_tpu_torch import testing
from colormipsearch_tpu_torch.cli import main as torch_main
from colormipsearch_tpu_torch.dataio import v2_io

MAINS = {"jax": jax_main.main, "port": torch_main.main}


def _same(runs: dict) -> tuple:
    assert runs["port"] == runs["jax"]
    return runs["port"]


def _mip(i: int, name, image: str, **kw) -> v2_io.MIPMetadata:
    return v2_io.MIPMetadata(id=str(i), publishedName=name, imageName=image,
                             libraryName="FlyLight Gen1 MCFO", **kw)


@pytest.fixture(scope="module")
def lists(tmp_path_factory):
    """Three MIP lists that overlap by (id, imageName), one MIP without a
    published name (its image name names it), names with characters a
    file name cannot hold; v2 result files and one v3 per-mask file (the
    port's legacyImport of them) for replaceAttributes; replacement maps
    as {id: fields} and as a MIP list."""
    root = tmp_path_factory.mktemp("lists")
    a = [_mip(1, "n1", "x/1.tif", gender="f"), _mip(2, "n2", "x/2.tif"),
         _mip(4, None, "x/R12A01_AE_01-20190101_1.tif")]
    b = [_mip(2, "n2", "x/2.tif"), _mip(3, "n1", "x/3.tif"),
         _mip(2, "n2", "x/2b.tif", slideCode="s2")]
    c = [_mip(5, "odd/name x", "y/5.tif", objective="40x"),
         _mip(1, "n1", "x/1.tif")]
    (root / "dir").mkdir()
    for name, mips in (("a", a), ("b", b), ("dir/c", c), ("dir/b", b)):
        v2_io.write_mips_json(mips, root / f"{name}.json")
    files = testing.write_v2_results(root / "v2", np.random.default_rng(8),
                                     3, 4)
    assert torch_main.main(["legacyImport", "-rf", files[0], "-od",
                            str(root / "v3")]) == 0
    (root / "repl.json").write_text(json.dumps({
        "1": {"gender": "m", "slideCode": "new1", "id": "1"},
        "lm2": {"publishedName": "LM2-renamed", "objective": "63x"},
        "em0": {"neuronType": "patched"},
        "lm1": {"gender": None}}))
    v2_io.write_mips_json([_mip(2, "n2-new", "z/2.tif", gender="m"),
                           _mip(3, "n3", "z/3.tif")],
                          root / "repl_list.json")
    return root


def _args(root: Path, argv: list) -> list:
    return [str(root / a[1:]) if a.startswith("@") else a for a in argv]


MERGE_CASES = {
    "inputs": ["-i", "@a.json", "@b.json"],
    "files_win_over_dirs": ["-rf", "@b.json", "-rd", "@dir"],
    "dirs": ["-rd", "@dir", "-i", "@a.json", "--no-pretty-print"],
}


@pytest.mark.parametrize("case", sorted(MERGE_CASES))
def test_merge_mips_identical_to_jax(lists, tmp_path, case):
    out = tmp_path / "merged.json"
    rc, _, (data,) = _same(testing.run_clis(
        MAINS, ["mergeMips", *_args(lists, MERGE_CASES[case]),
                "--output-filename", "merged.json", "-od", tmp_path],
        outputs=[out]))
    assert rc == 0
    keys = [(m["id"], m["imageName"]) for m in json.loads(data)]
    assert len(keys) == len(set(keys))
    want = {"inputs": 5, "files_win_over_dirs": 3, "dirs": 6}[case]
    assert len(keys) == want


def test_merge_mips_and_group_identical_to_jax(lists, tmp_path):
    """The JAX test's flow: merge two lists, then group the merged list
    by published name."""
    merged = tmp_path / "merged.json"
    _same(testing.run_clis(
        MAINS, ["mergeMips", "-i", lists / "a.json", lists / "b.json",
                "--output-filename", "merged.json", "-od", tmp_path],
        outputs=[merged]))
    out = tmp_path / "grouped"
    rc, _, (tree,) = _same(testing.run_clis(
        MAINS, ["groupMIPsByPublishedName", "-i", merged, "-od", out],
        outputs=[out]))
    assert rc == 0
    assert sorted(m["id"] for m in json.loads(tree["n1.json"])) == ["1", "3"]
    assert "R12A01.json" in tree


GROUP_CASES = {
    "one_list": ["-i", "@a.json"],
    "several_lists": ["-i", "@a.json", "@b.json", "@dir/c.json",
                      "--no-pretty-print"],
}


@pytest.mark.parametrize("case", sorted(GROUP_CASES))
def test_group_mips_local_identical_to_jax(lists, tmp_path, case):
    out = tmp_path / "grouped"
    rc, _, (tree,) = _same(testing.run_clis(
        MAINS, ["groupMIPsByPublishedName", *_args(lists, GROUP_CASES[case]),
                "-od", out], outputs=[out]))
    assert rc == 0
    if case == "several_lists":
        assert "odd_name_x.json" in tree
        assert len(json.loads(tree["n2.json"])) == 3


def test_group_mips_local_without_input_is_an_error(tmp_path):
    runs = testing.run_clis(MAINS, ["groupMIPsByPublishedName", "-od",
                                    tmp_path])
    assert runs["port"] == runs["jax"] and runs["port"][0] == 1


REPLACE_CASES = {
    "by_id": ["-i", "@a.json", "@dir/c.json", "-av", "@repl.json"],
    "mip_list": ["--input-files", "@a.json", "@b.json",
                 "--new-mips-attributes", "@repl_list.json"],
    "fields": ["-i", "@b.json", "-attrs", "@repl_list.json",
               "--fields-toUpdate", "publishedName:name", "gender",
               "--no-pretty-print"],
    "mapped_id": ["-i", "@a.json", "-av", "@repl_list.json", "--id-field",
                  "id:id"],
    "nested_v2": ["--input-dirs", "@v2/results", "-av", "@repl.json"],
    "nested_v3": ["--input-dirs", "@v3", "-av", "@repl.json",
                  "--id-field", "id:mipId"],
}


@pytest.mark.parametrize("case", sorted(REPLACE_CASES))
def test_replace_attributes_identical_to_jax(lists, tmp_path, case):
    out = tmp_path / "replaced"
    rc, _, (tree,) = _same(testing.run_clis(
        MAINS, ["replaceAttributes", *_args(lists, REPLACE_CASES[case]),
                "-od", out], outputs=[out]))
    assert rc == 0 and tree
    text = "".join(v.decode() for v in tree.values())
    want = {"by_id": '"new1"', "mip_list": "n2-new", "fields": '"name"',
            "mapped_id": "z/2.tif", "nested_v2": "LM2-renamed",
            "nested_v3": "LM2-renamed"}[case]
    assert want in text


@pytest.mark.parametrize("command", ["mergeMips", "replaceAttributes"])
def test_list_commands_without_inputs_exit(tmp_path, command):
    extra = {"mergeMips": ["--output-filename", "m.json"],
             "replaceAttributes": ["-av", str(tmp_path / "r.json")]}
    for main in MAINS.values():
        with pytest.raises(SystemExit, match="no inputs"):
            main([command, *extra[command], "-od", str(tmp_path)])
