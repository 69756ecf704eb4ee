"""The port's mesh across processes (torch.distributed, gloo on the CPU).

Real processes through the port's launcher
(colormipsearch_tpu_torch.parallel.launch), each with jax and PIL
unimportable, 2 CPU shards each unless a test says otherwise, meeting by
``file://`` rendezvous in the test's tmp_path:

  * the launcher's selftest at 2 ranks on the JAX selftest's seeded
    inputs (scripts/run_multihost.py:47-61): every sharded step equal in
    every output and global max to the JAX single-device functions run
    here on the same numpy inputs, and the same in both ranks;
  * the port's colorDepthSearch at 2 and 4 ranks on the library of
    tests/test_multiprocess.py (60 targets): each rank writes some rows
    but not all, and the union of the ranks' rows equals the JAX CLI's
    single-process rows (default path, the packed path with a per-shard
    top-k, the threshold-emit selection over column shards);
  * a global mesh of 3 shards refused before any scoring, and a failing
    rank failing every rank well within the timeout.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from colormipsearch_tpu.cli import main as jax_main
from colormipsearch_tpu.ops import common as jcommon
from colormipsearch_tpu.ops import pixel_match as jpm
from colormipsearch_tpu.ops import shape_score as jss
from colormipsearch_tpu_torch import testing
from colormipsearch_tpu_torch.parallel import launch
from colormipsearch_tpu_torch.parallel import mesh as tmesh

REPO = Path(__file__).resolve().parent.parent
TIMEOUT = 60  # the launcher's rendezvous and collective timeout, seconds
# run the launcher with jax and PIL unimportable (the GPU hosts have
# neither); importing the JAX package would fail with them
LAUNCHER = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['PIL'] = None; import runpy; "
            "runpy.run_module('colormipsearch_tpu_torch.parallel.launch', "
            "run_name='__main__')")


def _launch(rdv: Path, n_ranks: int, rank_args, devices: str = "cpu,cpu",
            env_extra: dict | None = None):
    """Start n_ranks launcher processes; rank_args(rank) -> the arguments
    after the group options. Returns [(returncode, stderr)] in rank
    order; every process is killed if one outlives the deadline."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
               **(env_extra or {}))
    procs = [subprocess.Popen(
        [sys.executable, "-c", LAUNCHER, "--init-method", f"file://{rdv}",
         "--world-size", str(n_ranks), "--rank", str(r), "--backend",
         "gloo", "--local-devices", devices, "--timeout", str(TIMEOUT),
         *[str(a) for a in rank_args(r)]],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(n_ranks)]
    results = []
    try:
        for p in procs:
            _out, err = p.communicate(timeout=TIMEOUT + 60)
            results.append((p.returncode, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return results


def _assert_ok(results):
    for rc, err in results:
        assert rc == 0, err[-3000:]


# --- the selftest against the JAX single-device functions ---------------


def _jax_selftest_outputs(n_shards: int) -> dict:
    """Every selftest step's whole outputs from the JAX single-device
    functions on selftest_inputs, with per-shard jax.lax.top_k for the
    top-k steps (the JAX mesh's layout)."""
    inp = launch.selftest_inputs(n_shards, "small")
    cfg = launch.SELFTEST_SIZES["small"]
    h, w, t_pad = cfg["h"], cfg["w"], inp["t_pad"]
    n_px = h * w
    width = t_pad // n_shards
    k = min(cfg["top_k"], width)
    masks, targets = inp["masks"], inp["targets"]

    def padded(planes):
        return np.pad(planes, ((0, 0), (0, t_pad - planes.shape[1])))

    packed = padded(np.asarray(jcommon.pack_target_planes(
        jnp.asarray(targets))))
    folded = np.where((packed & 0xFF) > 20, packed, 0)
    keys = jcommon.key_planes_from_packed(jnp.asarray(folded),
                                          jcommon.rank_lut_device())
    kw = dict(mirror=True, xy_shift=2, pix_color_fluctuation=cfg["flu"])
    plans = [jpm.build_query_plan(m, 20, **kw) for m in masks]
    q_pad = max(p.positions.shape[1] for p in plans)
    plans = [jpm.build_query_plan(m, 20, pad_to=q_pad, **kw) for m in masks]
    pargs = [jnp.asarray(np.stack([getattr(p, f) for p in plans]))
             for f in ("positions", "q_cls", "q_s", "q_p")]
    zkw = dict(ztol_num=plans[0].ztol_num, ztol_den=plans[0].ztol_den,
               n_straight=plans[0].n_straight)

    def topk(best, mirrored, flags):
        best, mirrored, flags = (np.asarray(x) for x in
                                 (best, mirrored, flags))
        parts = []
        for s in range(n_shards):
            cols = slice(s * width, (s + 1) * width)
            sk, ik = (np.asarray(x) for x in
                      jax.lax.top_k(jnp.asarray(best[:, cols]), k))
            parts.append((sk, ik + s * width,
                          np.take_along_axis(mirrored[:, cols], ik, 1),
                          np.take_along_axis(flags[:, cols], ik, 1)))
        return [np.concatenate([p[i] for p in parts], 1) for i in range(4)] \
            + [best.max(-1), (flags > 0).sum(-1)]

    out = {}

    def both(name, best, mirrored, flags=None):
        flags = np.zeros_like(np.asarray(best)) if flags is None else flags
        out[name] = [best, mirrored, flags, np.asarray(best).max(-1)]
        out[f"{name}_topk"] = topk(best, mirrored, flags)

    one = jpm.score_query_batch(jnp.asarray(packed), *[a[:1] for a in pargs],
                                target_threshold=20, **zkw)
    one = [np.asarray(x)[0] for x in one]
    out["search"] = one + [one[0].max()]
    sk, ik, *_ = topk(*[x[None] for x in one])
    out["search_topk"] = out["search"] + [sk[0], ik[0]]
    both("batch", *jpm.score_query_batch(jnp.asarray(packed), *pargs,
                                         target_threshold=20, **zkw))
    sp, c8 = jcommon.split_planes_from_packed(jnp.asarray(folded))
    out["batch_split"] = list(jpm.score_query_batch_split(sp, c8, *pargs,
                                                          **zkw))
    out["batch_split"].append(np.asarray(out["batch_split"][0]).max(-1))
    kplans = [jpm.key_plan_from_query_plan(p, n_px, cfg["flu"])
              for p in plans]
    both("batch_keys", *jpm.score_query_batch_keys(
        keys, *[jnp.asarray(np.stack([getattr(kp, f) for kp in kplans]))
                for f in ("positions", "lo", "span")],
        n_straight=plans[0].n_straight)[:2])
    for form, build in (("x", jpm.build_union_key_plan),
                        ("full", jpm.build_full_union_key_plan)):
        *arrs, u2 = jpm.stack_union_plan_args(
            [build(m, 20, **kw) for m in masks], n_px)
        both(f"batch_union_keys_{form}", *jpm.score_query_batch_union_keys(
            keys, *[jnp.asarray(a) for a in arrs], u2)[:2])
    qplans = [jpm.build_full_union_key_plan(
        m, 20, mirror=True, xy_shift=2, pix_color_fluctuation=1.0)
        for m in masks]
    *qarrs, qu2 = jpm.stack_union_qkey_args(qplans, n_px)
    tabs = jpm.interval_table_arrays(0.01)
    both("batch_union_qkeys", *jpm.score_query_batch_union_qkeys(
        keys, *[jnp.asarray(a) for a in (*qarrs, *tabs)], qu2)[:2])
    out["shape"] = list(jss.shape_score_pairs(
        jnp.asarray(inp["t_dense"][0]), jnp.asarray(inp["q_dense"][0])))
    out["shape_both"] = list(jss.shape_score_pairs_both(
        jnp.asarray(inp["t_dense"]), jnp.asarray(inp["q_dense"])))
    out["shape_split"] = list(jss.shape_score_pairs_split(
        *[jnp.asarray(inp[n]) for n in ("t_gap", "q_gap", "t_he", "q_he")]))
    return {name: [np.asarray(x).astype(np.int64) for x in xs]
            for name, xs in out.items()}


def test_selftest_inputs_are_the_jax_selftests():
    """The small selftest's images are scripts/run_multihost.py's."""
    rng = np.random.default_rng(0)
    imgs = np.zeros((10, 40, 64, 3), np.uint8)
    for img in imgs:
        img[rng.integers(0, 40, 400), rng.integers(0, 64, 400)] = \
            rng.integers(0, 256, (400, 3))
    inp = launch.selftest_inputs(4)
    np.testing.assert_array_equal(inp["masks"], imgs[:2])
    np.testing.assert_array_equal(inp["targets"], imgs[2:])
    assert inp["t_pad"] == 8 and inp["t_gap"].shape == (2, 64, 8)


def test_selftest_at_two_ranks_equals_jax(tmp_path):
    results = _launch(tmp_path / "rdv", 2,
                      lambda r: ["--selftest", tmp_path / f"r{r}.json"])
    _assert_ok(results)
    docs = [json.loads((tmp_path / f"r{r}.json").read_text())
            for r in range(2)]
    for r, doc in enumerate(docs):
        assert doc["ok"] and all(doc["checks"].values()), doc["checks"]
        assert (doc["rank"], doc["world_size"], doc["n_global_shards"]) \
            == (r, 2, 4)
        assert all(doc["step_calls"].values()), doc["step_calls"]
        calls = doc["collective_calls"]
        assert calls["all_reduce"] > 0 and calls["all_gather"] > 0
        assert calls["host_staged"] == 0  # CPU tensors need no staging
    # both ranks hold the same whole outputs and global maxima
    assert docs[0]["outputs"] == docs[1]["outputs"]
    assert docs[0]["global_max"] == docs[1]["global_max"]
    assert docs[0]["scores"] == [row[:8] for row in
                                 docs[0]["outputs"]["batch"][0]]
    want = _jax_selftest_outputs(4)
    assert sorted(want) == sorted(docs[0]["outputs"])
    for name, arrays in want.items():
        got = docs[0]["outputs"][name]
        assert len(got) == len(arrays), name
        for g, w in zip(got, arrays):
            np.testing.assert_array_equal(np.asarray(g), w, err_msg=name)
    assert np.asarray(docs[0]["outputs"]["batch"][0]).max() > 0


# --- colorDepthSearch through the launcher ------------------------------


SEARCH_FLAGS = ["--maskThreshold", "20", "--dataThreshold", "20",
                "--pixColorFluctuation", "2.0", "--xyShift", "2",
                "--mirrorMask", "--no-name-labels", "--no-colormap-labels",
                "--cdsConcurrency", "1"]
# the CLI runs: extra flags, and the environment of the port's ranks
MODES = {
    "default": ([], {}),
    # the packed kernel with a per-shard top-k of 10 (of a shard's 16
    # columns at 2 ranks); maxMatchesPerMask above every mask's match
    # count at 1.5%, so no trim drops a row
    "packed_topk": (["--use-union-keys", "off", "--max-matches-per-mask",
                     "10", "--pctPositivePixels", "1.5"], {}),
    # the threshold-emit selection over column shards: k = 2 of a shard's
    # 8 or 16 columns, and at 5% no second-best pair of a shard emits
    "emit_select": (["--pctPositivePixels", "5"], {"CDS_EMIT_TOPK": "2"}),
}


@pytest.fixture(scope="module")
def cli_library(tmp_path_factory):
    """The library of tests/test_multiprocess.py: 60 random 40x64 targets
    (t_pad 64); its neuron JSONs. The masks are 4 of the targets, one in
    each quarter of the columns, so every rank at 2 and 4 ranks has a
    self-match to write."""
    tmp = tmp_path_factory.mktemp("mp_cli")
    rng = np.random.default_rng(7)
    lib = tmp / "lib"
    lib.mkdir()
    for i in range(60):
        img = np.zeros((40, 64, 3), np.uint8)
        img[rng.integers(0, 40, 400), rng.integers(0, 64, 400)] = \
            rng.integers(0, 256, (400, 3))
        testing.write_png(lib / f"n{i:02d}.png", img)
    assert jax_main.main(["createColorDepthSearchDataInput", "-i", str(lib),
                          "-l", "mp", "-od", str(tmp), "--output-filename",
                          "all.json"]) == 0
    neurons = json.loads((tmp / "all.json").read_text())
    (tmp / "masks.json").write_text(json.dumps(
        [neurons[i] for i in (0, 20, 40, 59)]))
    (tmp / "targets.json").write_text(json.dumps(neurons))
    return tmp


@pytest.fixture(scope="module")
def jax_rows(cli_library):
    """mode -> the JAX CLI's single-process rows, one run a mode."""
    cache = {}

    def rows(mode, args):
        if mode not in cache:
            ref = cli_library / f"ref_{mode}"
            assert jax_main.main([str(a) for a in args] + [
                "-od", str(ref), "--perMaskSubdir", "pm"]) == 0
            cache[mode] = _tree_rows(ref / "pm")
        return cache[mode]

    return rows


def _rows(path: Path) -> set:
    doc = json.loads(path.read_text())
    return {(r["image"]["mipId"], r["matchingPixels"], r["mirrored"],
             r["matchingPixelsRatio"]) for r in doc["results"]}


def _tree_rows(root: Path) -> dict:
    return {f.name: _rows(f) for f in sorted(root.glob("*.json"))}


@pytest.mark.parametrize("n_ranks,mode", [
    (2, "default"), (4, "default"), (2, "packed_topk"), (4, "packed_topk"),
    (2, "emit_select")])
def test_cli_union_of_ranks_equals_jax(cli_library, jax_rows, tmp_path,
                                       n_ranks, mode):
    flags, env = MODES[mode]
    args = ["colorDepthSearch", "-m", cli_library / "masks.json", "-i",
            cli_library / "targets.json", *SEARCH_FLAGS, *flags]
    want = jax_rows(mode, args)
    total = sum(len(v) for v in want.values())
    assert len(want) == 4 and total >= 4
    if mode == "packed_topk":
        assert max(len(v) for v in want.values()) < 10

    _assert_ok(_launch(
        tmp_path / "rdv", n_ranks,
        lambda r: ["--", *args, "--device", "cpu", "-od",
                   tmp_path / f"r{r}", "--perMaskSubdir", "pm"],
        env_extra=env))
    merged: dict = {}
    counts = []
    for r in range(n_ranks):
        got = _tree_rows(tmp_path / f"r{r}" / "pm")
        counts.append(sum(len(v) for v in got.values()))
        for name, rows in got.items():
            assert not rows & merged.get(name, set()), "a row written twice"
            merged.setdefault(name, set()).update(rows)
    # the target columns really split: every rank wrote some rows, none all
    assert sum(counts) == total, (counts, total)
    assert all(0 < c < total for c in counts), counts
    assert merged == want


# --- colorDepthSearch into one DB store at 2 ranks -----------------------


MASK_MIPS = ["n00", "n20", "n40", "n59"]


def _store_config(path: Path, store: Path, context: int = 0) -> Path:
    """A --config file naming the store; concurrent writers each take a
    TimebasedId.Context of their own, or their time-based ids can
    coincide within a millisecond (model/ids.py) and one writer's
    upsert replaces the other's document."""
    path.write_text(f"Store.Type=sqlite\nStore.Path={store}\n"
                    f"TimebasedId.Context={context}\n")
    return path


def _db_inputs(main, cli_library, store: Path) -> None:
    """The library's neurons in `store`: all as library "mp", the four
    masks also as library "mpmasks"."""
    cfg = _store_config(store.with_suffix(".properties"), store)
    lib = str(cli_library / "lib")
    for extra in (["-l", "mp"], ["-l", "mpmasks", "--mips", *MASK_MIPS]):
        assert main(["createColorDepthSearchDataInput", "-i", lib, *extra,
                     "--mips-storage", "DB", "--config", str(cfg)]) == 0


def test_db_search_at_two_ranks_equals_jax(cli_library, tmp_path):
    """colorDepthSearch --mips-storage DB --results-storage DB at 2 ranks
    into one sqlite file: each rank upserts its own columns' matches, and
    the store equals the JAX CLI's one process's in canonical form; the
    neurons keep their ids."""
    from colormipsearch_tpu_torch.cli import main as torch_main

    args = ["colorDepthSearch", "-m", "mpmasks", "-i", "mp",
            "--mips-storage", "DB", "--results-storage", "DB",
            *SEARCH_FLAGS]
    ref = tmp_path / "jax.sqlite"
    _db_inputs(jax_main.main, cli_library, ref)
    assert jax_main.main([*args, "--config", str(_store_config(
        tmp_path / "jax.properties", ref))]) == 0
    shared = tmp_path / "shared.sqlite"
    _db_inputs(torch_main.main, cli_library, shared)
    before = testing.store_collections(shared)["neuronMetadata"]
    _assert_ok(_launch(
        tmp_path / "rdv", 2,
        lambda r: ["--", *args, "--device", "cpu", "--config",
                   _store_config(tmp_path / f"r{r}.properties", shared, r)]))
    want = testing.canonical_store(ref)
    assert len(want["cdMatches"]) >= 8
    assert testing.canonical_store(shared) == want
    assert sorted(map(str, (d["_id"] for d in before))) == sorted(
        str(d["_id"]) for d in
        testing.store_collections(shared)["neuronMetadata"])


def _jax_ranks(tmp_path: Path, rank_args) -> list:
    """The JAX CLI at 2 processes x 2 CPU devices through
    scripts/run_multihost.py; [(returncode, stderr)]."""
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO),
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    procs = [subprocess.Popen(
        [sys.executable, str(REPO / "scripts" / "run_multihost.py"),
         "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
         "--process-id", str(r), "--platform", "cpu", "--",
         *[str(a) for a in rank_args(r)]],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    results = []
    try:
        for p in procs:
            _out, err = p.communicate(timeout=TIMEOUT + 60)
            results.append((p.returncode, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return results


def test_fs_mips_db_results_at_two_ranks_in_both_packages(cli_library,
                                                          tmp_path):
    """colorDepthSearch --mips-storage FS --results-storage DB at 2 ranks
    in each package: every rank's flush stores the neurons it has no id
    for with a find-then-save that is not atomic across processes, in
    both packages alike. What holds in both: every pair of the one
    process's rows stored once, no dangling reference, and at most one
    more document a mask (a mask both ranks stored at once); the targets
    split over the ranks, so none is stored twice."""
    args = ["colorDepthSearch", "-m", cli_library / "masks.json", "-i",
            cli_library / "targets.json", "--results-storage", "DB",
            *SEARCH_FLAGS]
    ref = tmp_path / "one.sqlite"
    assert jax_main.main([str(a) for a in args] + ["--config", str(
        _store_config(tmp_path / "one.properties", ref))]) == 0
    want = testing.store_match_rows(ref)
    runs = {"port": lambda store, cfg: _assert_ok(_launch(
                tmp_path / "rdv", 2,
                lambda r: ["--", *args, "--device", "cpu", "--config",
                           cfg(r)])),
            "jax": lambda store, cfg: _assert_ok(_jax_ranks(
                tmp_path, lambda r: [*args, "--config", cfg(r)]))}
    for name, run in runs.items():
        store = tmp_path / f"{name}.sqlite"
        run(store, lambda r: _store_config(
            tmp_path / f"{name}{r}.properties", store, r))
        cols = testing.store_collections(store)
        ids = {str(d["_id"]) for d in cols["neuronMetadata"]}
        assert all(str(m[ref_]) in ids for m in cols["cdMatches"]
                   for ref_ in ("maskImageRefId", "matchedImageRefId"))
        keys = [d["mipId"] for d in cols["neuronMetadata"]]
        twice = {k for k in keys if keys.count(k) > 1}
        assert twice <= set(MASK_MIPS) and all(keys.count(k) == 2
                                               for k in twice), name
        assert set(keys) == {k[i][0] for k in want for i in (0, 1)}
        # match rows by mipId: a doubled mask's rows land under either
        # of its documents, once
        rows = {}
        by_id = {str(d["_id"]): d for d in cols["neuronMetadata"]}
        for m in cols["cdMatches"]:
            pair = tuple(testing.neuron_key(by_id[str(m[ref_])])
                         for ref_ in ("maskImageRefId", "matchedImageRefId"))
            assert pair not in rows, name
            rows[pair] = {k: v for k, v in m.items() if k not in (
                "_id", "entityId", "maskImageRefId", "matchedImageRefId")}
        assert rows == want, name


# --- refusals and failures ----------------------------------------------


def test_mesh_of_three_shards_is_refused_before_scoring(tmp_path):
    """3 ranks x 1 shard: no power of two divides the padded target axis,
    so every rank refuses at the rendezvous, before any scoring."""
    t0 = time.time()
    results = _launch(tmp_path / "rdv", 3,
                      lambda r: ["--selftest", tmp_path / f"r{r}.json"],
                      devices="cpu")
    for rc, err in results:
        assert rc == 2, err[-2000:]
        assert "power-of-two size: 3 ranks x 1 devices" in err
    assert not list(tmp_path.glob("r*.json"))
    assert time.time() - t0 < TIMEOUT


def test_failing_rank_fails_every_rank(cli_library, tmp_path):
    """Rank 1's command fails at once (its mask list is missing); rank 0
    fails at its first collective instead of waiting out the timeout."""
    def rank_args(r):
        masks = cli_library / ("masks.json" if r == 0 else "missing.json")
        return ["--", "colorDepthSearch", "-m", masks, "-i",
                cli_library / "targets.json", *SEARCH_FLAGS, "--device",
                "cpu", "-od", tmp_path / f"r{r}"]

    t0 = time.time()
    results = _launch(tmp_path / "rdv", 2, rank_args)
    assert time.time() - t0 < TIMEOUT
    assert results[1][0] == 2, results[1][1][-2000:]
    assert results[0][0] != 0
    assert "peer" in results[0][1].lower() or "closed" in results[0][1], \
        results[0][1][-2000:]


# --- the mesh's cross-process rules, in this process ----------------------


def test_mesh_across_processes_counts_every_rank():
    mesh = tmesh.Mesh((torch.device("cpu"),) * 2, rank=1, world_size=4,
                      backend="gloo")
    assert (mesh.size, mesh.first_shard) == (8, 2)
    with pytest.raises(ValueError, match="power-of-two"):
        tmesh.Mesh((torch.device("cpu"),) * 3, rank=0, world_size=2,
                   backend="gloo")
    # one process: any size, as before
    assert tmesh.Mesh((torch.device("cpu"),) * 3).size == 3


def test_placement_and_pulls_keep_this_ranks_columns(monkeypatch):
    """Rank 1 of 2 (2 shards each): shard_target_planes copies global
    shards 2 and 3, local_target_mask marks the second half, and
    pull_target_cols zeroes the first."""
    import torch.distributed as dist

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda *a, **k: 2)
    monkeypatch.setattr(dist, "get_rank", lambda *a, **k: 1)
    mesh = tmesh.Mesh((torch.device("cpu"),) * 2, rank=1, world_size=2,
                      backend="gloo")
    planes = torch.arange(3 * 8, dtype=torch.int32).reshape(3, 8)
    shards = tmesh.shard_target_planes(mesh, planes)
    assert [s.tolist() for s in shards] == [planes[:, 4:6].tolist(),
                                            planes[:, 6:8].tolist()]
    host = tmesh.shard_target_planes(mesh, planes.numpy().astype(np.uint32))
    assert all(torch.equal(a, b) for a, b in zip(host, shards))
    mask = tmesh.local_target_mask(None, 8)
    np.testing.assert_array_equal(mask, np.arange(8) >= 4)
    pulled = tmesh.pull_target_cols(planes)
    np.testing.assert_array_equal(pulled[:, 4:], planes[:, 4:].numpy())
    assert not pulled[:, :4].any()
    with pytest.raises(ValueError, match="processes"):
        tmesh.local_target_mask(None, 7)


def test_resolve_mesh_refuses_a_local_mesh_across_processes(monkeypatch):
    """With several processes only the global mesh may score: a local
    mesh, no mesh, or use_mesh=False would write every column in every
    rank."""
    import torch.distributed as dist

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda *a, **k: 2)
    cpu = torch.device("cpu")
    for use_mesh in (tmesh.create_mesh(["cpu"] * 2), False):
        with pytest.raises(ValueError, match="global"):
            tmesh.resolve_mesh(use_mesh, cpu)
    glob = tmesh.Mesh((cpu,) * 2, rank=0, world_size=2, backend="gloo")
    assert tmesh.resolve_mesh(glob, cpu) is glob
    with pytest.raises(RuntimeError, match="init_distributed"):
        tmesh.resolve_mesh(True, cpu)


def test_init_distributed_checks_its_arguments():
    with pytest.raises(ValueError, match="backend"):
        tmesh.init_distributed("file:///nowhere", 1, 0, "mpi", ["cpu"])
    with pytest.raises(ValueError, match="nccl"):
        tmesh.init_distributed("file:///nowhere", 1, 0, "nccl", ["cpu"])
    with pytest.raises(ValueError, match="at least one"):
        tmesh.init_distributed("file:///nowhere", 1, 0, "gloo", [])


def test_one_process_group_meshes_over_its_local_shards(tmp_path):
    """A group of one (the one-card host's NCCL form, here on gloo):
    create_mesh() and resolve_mesh(None) give the global mesh of the
    local shards, whose steps run their collectives."""
    mesh = tmesh.init_distributed(f"file://{tmp_path / 'rdv'}", 1, 0,
                                  "gloo", ["cpu"] * 2, timeout=TIMEOUT)
    try:
        assert (mesh.size, mesh.backend) == (2, "gloo")
        assert tmesh.create_mesh().devices == mesh.devices
        assert tmesh.resolve_mesh(None, torch.device("cpu")).backend \
            == "gloo"
        tmesh.reset_step_calls()
        best = torch.tensor([[3, 0, 5, 1]], dtype=torch.int32)
        per = [(best[:, :2], best[:, :2] > 0, torch.zeros_like(best[:, :2])),
               (best[:, 2:], best[:, 2:] > 0, torch.zeros_like(best[:, 2:]))]
        out = tmesh._finish_batched_step(mesh, per, 1)
        assert out[0].tolist() == [[3, 5]] and out[1].tolist() == [[0, 2]]
        assert out[4].tolist() == [5] and out[5].tolist() == [0]
        assert tmesh.collective_calls["all_reduce"] == 2
        assert tmesh.collective_calls["all_gather"] == 4
    finally:
        tmesh.shutdown_distributed()
    assert not tmesh._GROUP


def test_engine_refuses_columns_that_do_not_divide_across_processes(
        tmp_path, monkeypatch):
    """A shard whose padded width (32) does not divide over a 64-shard
    mesh of 2 processes would run on one device in every rank and write
    every column twice: the engine raises instead."""
    import torch.distributed as dist

    from colormipsearch_tpu_torch.engine.cds import CDSearchEngine, CDSParams

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda *a, **k: 2)
    monkeypatch.setattr(dist, "get_rank", lambda *a, **k: 0)
    rng = np.random.default_rng(3)
    lib = testing.synthetic_library(rng, 3, 1, 24, 32, target_fg=0.1,
                                    mask_fg=0.05)
    targets = testing.write_neuron_images(tmp_path, lib.targets, "t",
                                          threads=1)
    masks = testing.write_neuron_images(tmp_path, lib.masks, "m", threads=1)
    mesh = tmesh.Mesh((torch.device("cpu"),) * 32, rank=0, world_size=2,
                      backend="gloo")
    engine = CDSearchEngine(CDSParams(mask_threshold=20, data_threshold=20),
                            device="cpu", use_mesh=mesh,
                            decode_concurrency=1)
    with pytest.raises(ValueError, match="do not divide over the 64 shards"):
        engine.find_all_matches(masks, targets)
