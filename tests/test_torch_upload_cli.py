"""The port's uploadData against the JAX CLI: the plan, the manifest,
the dry run and the run through a fake upload command.

No case contacts S3 or any network: the dry run only prints, and --run
goes through --upload-command, here a Python script that records its
arguments. Each case runs through both CLIs on the same data tree and
paths (testing.run_clis); the manifest, the printed plan and the
recorded calls must be identical. The cases cover the JAX
tests/test_cli_upload.py.
"""

import sys

import pytest

from colormipsearch_tpu.cli import main as jax_main
from colormipsearch_tpu_torch import testing
from colormipsearch_tpu_torch.cli import main as torch_main

MAINS = {"jax": jax_main.main, "port": torch_main.main}


def _same(runs: dict) -> tuple:
    assert runs["port"] == runs["jax"]
    return runs["port"]


def _mk_tree(root):
    """An exportData-shaped local data tree (upload-data.sh layout)."""
    for region in ("brain", "vnc"):
        for sub, direction in (("cdmatches", "em-vs-lm"),
                               ("cdmatches", "lm-vs-em"),
                               ("pppmatches", "em-vs-lm")):
            d = root / region / sub / direction
            d.mkdir(parents=True)
            (d / "m1.json").write_text("{}")
    for mt in ("lmlines", "embodies"):
        d = root / "brain+vnc" / "mips" / mt
        d.mkdir(parents=True)
        (d / "a.json").write_text("{}")
        (d / "b.json").write_text('{"x": 1}')
    (root / "config.json").write_text("{}")
    (root / "schemas").mkdir()
    (root / "schemas" / "match.json").write_text("{}")
    (root / "current.txt").write_text("v3_0_0")


PLAN_CASES = {
    "everything": ["--bucket", "test-bucket", "--data-version", "v9_9_9",
                   "--with-config", "--with-schemas", "--with-version"],
    "defaults": [],
    "subsets": ["--mips-types", "embodies", "by_line", "--match-regions",
                "vnc", "--matches", "cdm:em-vs-lm", "pppm:em-vs-lm",
                "--mips-regions", "brain+vnc", "brain"],
    "renamed_dirs": ["--mips-dir", "nomips", "--cds-results-dir",
                     "pppmatches", "--upload-command", "echo cp"],
}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_plan_manifest_and_dry_run_identical_to_jax(tmp_path, case):
    data = tmp_path / "data"
    _mk_tree(data)
    manifest = tmp_path / "out" / "manifest.json"
    rc, out, (plan,) = _same(testing.run_clis(
        MAINS, ["uploadData", "--local-data-dir", data, *PLAN_CASES[case],
                "--manifest", manifest], outputs=[manifest]))
    assert rc == 0 and plan
    assert "DRY-RUN: " in out or case == "renamed_dirs"
    if case == "everything":
        assert b"s3://test-bucket/next.txt" in plan
        assert out.count("DRY-RUN: aws s3 cp") == 12
        assert out.count("--recursive") == 9


def test_missing_sources_skipped_identical_to_jax(tmp_path):
    (tmp_path / "brain" / "cdmatches" / "em-vs-lm").mkdir(parents=True)
    manifest = tmp_path / "manifest.json"
    rc, out, (plan,) = _same(testing.run_clis(
        MAINS, ["uploadData", "--local-data-dir", tmp_path, "--manifest",
                manifest], outputs=[manifest]))
    assert rc == 0 and out.count("DRY-RUN") == 1
    assert b'"exists": false' in plan and b'"exists": true' in plan


@pytest.mark.parametrize("fail", [False, True])
def test_run_through_the_upload_command_identical_to_jax(tmp_path, fail):
    """--run calls the upload command once per existing entry; a failing
    command makes the exit code its own."""
    _mk_tree(tmp_path / "data")
    log = tmp_path / "calls.txt"
    fake = tmp_path / "fakeaws.py"
    fake.write_text(
        "import sys\n"
        f"open({str(log)!r}, 'a').write(' '.join(sys.argv[1:]) + '\\n')\n"
        f"sys.exit({3 if fail else 0} if 'config.json' in sys.argv[1] "
        "else 0)\n")
    rc, _, (calls,) = _same(testing.run_clis(
        MAINS, ["uploadData", "--local-data-dir", tmp_path / "data",
                "--bucket", "b", "--run", "--with-config",
                "--upload-command", f"{sys.executable} {fake}"],
        outputs=[log]))
    assert rc == (3 if fail else 0)
    lines = calls.decode().splitlines()
    # 2 mips trees + 2 regions x (2 cds + 1 ppp) match tables + config
    assert len(lines) == 9
    assert sum("--recursive" in c for c in lines) == 8


@pytest.mark.parametrize("spec", ["bogus", "cds:", "s3:em-vs-lm"])
def test_bad_matches_spec_exits(tmp_path, spec):
    _mk_tree(tmp_path)
    for main in MAINS.values():
        with pytest.raises(SystemExit, match="bad --matches entry"):
            main(["uploadData", "--local-data-dir", str(tmp_path),
                  "--matches", spec])
