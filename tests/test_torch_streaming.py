"""colorDepthSearch's streamed result writes hold less memory than
accumulate-all, through the port's streaming check
(colormipsearch_tpu_torch.scripts.streaming_rss_check) on the CPU.

Peak RSS at a size this suite can afford is noise, so the test calls the
check's functions at a small size and reads tracemalloc's peak over each
search (Python allocations, after a one-pair run has built the process's
cached tables). 16 masks x 512 targets at 64 x 96, every pair a match,
in target tiles of 32 (CDS_TARGET_TILE): the engine yields 16 chunks of
8 x 32 matches, so streaming (1,024 a flush) holds at most ~1,280 match
entities at once where accumulate-all holds 8,192.
"""

import json
import tempfile

import numpy as np
import pytest

from colormipsearch_tpu_torch import testing
from colormipsearch_tpu_torch.io.image import read_image
from colormipsearch_tpu_torch.scripts import streaming_rss_check as check

N_MASKS, N_TARGETS = 16, 512
# tracemalloc peak of accumulate-all minus streaming's, a match: 505.97,
# 506.37, 506.57 and 514.14 B in four runs of this workload on a 8-core
# x86 CPU host (run_both with trace_python=True, --device cpu)
SAVED_BYTES_PER_MATCH = 506


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("streaming"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CDS_TARGET_TILE", "32")
        masks, targets = check.synthesize(root, N_TARGETS, N_MASKS)
        acc, streamed = check.run_both(root, masks, targets, "cpu",
                                       trace_python=True)
    return root, acc, streamed


def test_both_runs_write_every_match(runs):
    root, acc, streamed = runs
    assert acc["matches"] == streamed["matches"] == N_MASKS * N_TARGETS
    # the flush cadence changes no byte of the result files
    tree = testing.snapshot(f"{root}/res_{check.ACCUMULATE_ALL}/masks")
    assert len(tree) == N_MASKS
    assert testing.snapshot(f"{root}/res_{check.STREAMING}/masks") == tree


def test_streaming_peak_is_below_accumulate_all(runs):
    _, acc, streamed = runs
    saved = acc["traced_peak"] - streamed["traced_peak"]
    assert saved >= SAVED_BYTES_PER_MATCH / 2 * N_MASKS * N_TARGETS, \
        (acc["traced_peak"], streamed["traced_peak"])


def test_synthesized_pairs_all_match():
    """Every target is the mask rolled by 0-6 columns: the workload's
    match count is masks x targets by construction."""
    with tempfile.TemporaryDirectory() as root:
        masks, targets = check.synthesize(root, 9, 2)
        t = [read_image(n["computeFiles"]["InputColorDepthImage"]).as_rgb()
             for n in json.load(open(targets))]
        m = [read_image(n["computeFiles"]["InputColorDepthImage"]).as_rgb()
             for n in json.load(open(masks))]
    assert len(m) == 2 and len(t) == 9
    np.testing.assert_array_equal(m[0], m[1])
    for i, img in enumerate(t):
        np.testing.assert_array_equal(img, np.roll(m[0], i % 7, axis=1))
    assert (m[0].max(-1) > 20).sum() > 300


@pytest.mark.parametrize("acc_rss,str_rss,acc_n,str_n,failures", [
    (200 << 20, 100 << 20, 1024, 1024, 0),
    (100 << 20, (100 << 20) - 50 * 1024 + 1, 1024, 1024, 1),
    (200 << 20, 100 << 20, 1024, 1023, 1),
    (100 << 20, 200 << 20, 1000, 1024, 2),
])
def test_check_exit_code(monkeypatch, capsys, acc_rss, str_rss, acc_n,
                         str_n, failures):
    """main exits 1 on a failed rule (matches, or < 50 B saved a match)
    and 0 otherwise; the runs are stubbed."""
    def fake_both(root, masks, targets, device, *, trace_python=False):
        assert device == "cpu" and not trace_python
        return ({"rss_bytes": acc_rss, "matches": acc_n, "seconds": 1.0},
                {"rss_bytes": str_rss, "matches": str_n, "seconds": 1.0})

    monkeypatch.setattr(check, "synthesize", lambda root, t, m: ("m", "t"))
    monkeypatch.setattr(check, "run_both", fake_both)
    rc = check.main(["--device", "cpu", "--targets", "32", "--masks", "32"])
    out, err = capsys.readouterr()
    assert rc == (1 if failures else 0)
    assert err.count("FAILED") == failures
    assert ("STREAMING RSS OK" in out) == (not failures)
