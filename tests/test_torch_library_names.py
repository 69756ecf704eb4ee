"""The port's library names against the JAX package's, and the names the
port gained last held equal to their JAX twins on the CPU.

The name check parses both packages with ``ast`` and imports neither:
module by module, every top-level name a JAX module defines (``def``,
``class``, an assignment, also inside a top-level ``if``/``try``) must
exist at the top level of the port's counterpart, defined or imported,
and each JAX ``__init__``'s ``__all__`` must be a subset of the port's.
A JAX name that the port lacks on purpose stands in ALLOWED with its
reason; a new JAX name the port lacks fails the check. Names the JAX
module only imports are skipped.

The parity tests feed both packages the same inputs, made with numpy
from a seed: ``results.partition_collection``,
``ops.shape_score.pack_target_rows_split``, the native decoder's TIFF
entry points (on TIFFs written with PIL, as tests/test_native_decoder.py
writes them) and ``utils.metrics.maybe_profile``.
"""

import ast
import io
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from colormipsearch_tpu.io import native_decoder as jnative
from colormipsearch_tpu.ops import shape_score as jss
from colormipsearch_tpu.oracle import shape as jshape
from colormipsearch_tpu.results import grouping as jgrouping
from colormipsearch_tpu_torch import testing
from colormipsearch_tpu_torch.io import native_decoder as tnative
from colormipsearch_tpu_torch.ops import shape_score as tss
from colormipsearch_tpu_torch.utils import metrics as tmetrics

REPO = Path(__file__).resolve().parents[1]
JAX_PKG = REPO / "colormipsearch_tpu"
PORT_PKG = REPO / "colormipsearch_tpu_torch"

_RAW = "jit-bound raw form, folded into the port's CUDA kernel"
_PRIVATE = "private helper of the JAX module"
# (module, name): why the port has no such top-level name
ALLOWED = {
    ("cli/main.py", "_enable_compilation_cache"): "XLA only: the JAX persistent compilation cache",
    ("ops/pixel_match.py", "score_query_against_planes_raw"): _RAW + " K9",
    ("ops/pixel_match.py", "score_query_against_split_planes_raw"): _RAW + " K11",
    ("ops/pixel_match.py", "score_query_against_key_planes_raw"): _RAW + " K10",
    ("ops/pixel_match.py", "score_query_union_keys_raw"): _RAW + " K3",
    ("ops/pixel_match.py", "score_query_union_keys_splitk_raw"): _RAW + " K13",
    ("ops/pixel_match.py", "score_query_union_qkeys_raw"): _RAW + " row 14",
    ("ops/pixel_match.py", "score_query_against_planes"): "jit-bound one-mask form of K9; the port scores batches",
    ("ops/pixel_match.py", "reduce_variants_device"): "jit-bound variant reduction, folded into K3/K9/K10/K11",
    ("ops/shape_score.py", "shape_score_pairs_raw"): _RAW + " row 18b",
    ("ops/shape_score.py", "shape_score_pairs_both_raw"): _RAW + " row 18b",
    ("ops/shape_score.py", "shape_score_pairs_split_raw"): _RAW + " K5",
    ("ops/shape_score.py", "_write_rows"): "jit-bound store row write, folded into K7",
    ("ops/shape_score.py", "_upload_pixel_major"): "jit-bound pixel-major upload, folded into K7",
    ("ops/common.py", "rank_lut_device"): "renamed to take a device: rank_lut_tensor(device)",
    ("io/image.py", "Image"): "PIL's Image module, which the port does not need",
    ("cli/commands.py", "_update_normalized_scores"): _PRIVATE + ": the port calls engine/gradscore.update_normalized_scores",
    ("engine/cds.py", "_USE_KEYS"): _PRIVATE + ": an import-time flag; the port reads its knobs per engine",
    ("engine/cds.py", "_USE_SPLIT"): _PRIVATE + ": an import-time flag; the port reads its knobs per engine",
    ("engine/cds.py", "_USE_UNION"): _PRIVATE + ": an import-time flag; the port reads its knobs per engine",
    ("engine/cds.py", "_decode_or_none"): _PRIVATE + ": PIL's per-image fallback decode",
    ("ops/common.py", "_SCATTER_CHUNK"): _PRIVATE + ": XLA's scatter chunk; K1 scatters in one launch",
    ("ops/common.py", "_scatter_key_chunk"): _PRIVATE + ": the jitted scatter chunk, K1",
    ("ops/pixel_match.py", "_map_vmap_chunks"): _PRIVATE + ": chunks a jax.vmap",
    ("ops/pixel_match.py", "_union_chunk_bounds"): _PRIVATE + ": XLA's union chunks; K3 splits the union over its grid",
    ("ops/shape_score.py", "_GRAD_BITS"): _PRIVATE + ": the dense jit form's bit width",
    ("ops/shape_score.py", "_shape_tile_device"): _PRIVATE + ": the jitted tile build, K6",
    ("parallel/mesh.py", "_batched_out_specs"): _PRIVATE + ": shard_map output specs",
    ("parallel/mesh.py", "shard_map"): "JAX's shard_map, picked by JAX version; the port shards by hand",
}


def _top_level(path: Path) -> tuple[set, set, list | None]:
    """(names the module defines, names it imports, its __all__)."""
    defined, imported, all_ = set(), set(), None

    def visit(stmts):
        nonlocal all_
        for n in stmts:
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)):
                defined.add(n.name)
            elif isinstance(n, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                targets = n.targets if isinstance(n, ast.Assign) \
                    else [n.target]
                for t in targets:
                    for e in ast.walk(t):
                        if isinstance(e, ast.Name):
                            defined.add(e.id)
                    if isinstance(t, ast.Name) and t.id == "__all__":
                        all_ = ast.literal_eval(n.value)
            elif isinstance(n, (ast.Import, ast.ImportFrom)):
                for a in n.names:
                    imported.add((a.asname or a.name).split(".")[0])
            elif isinstance(n, ast.If):
                visit(n.body)
                visit(n.orelse)
            elif isinstance(n, ast.Try):
                visit(n.body)
                for h in n.handlers:
                    visit(h.body)
                visit(n.orelse)
                visit(n.finalbody)

    visit(ast.parse(path.read_text()).body)
    return defined, imported, all_


JAX_MODULES = sorted(str(p.relative_to(JAX_PKG))
                     for p in JAX_PKG.rglob("*.py"))
JAX_INITS = [m for m in JAX_MODULES if m.endswith("__init__.py")]


@pytest.mark.parametrize("module", JAX_MODULES)
def test_port_defines_every_jax_name(module):
    port = PORT_PKG / module
    assert port.is_file(), f"the port has no {module}"
    jax_defined, _, _ = _top_level(JAX_PKG / module)
    port_defined, port_imported, _ = _top_level(port)
    missing = sorted(n for n in jax_defined - port_defined - port_imported
                     if (module, n) not in ALLOWED)
    assert not missing, f"{module}: the port lacks {missing}"


@pytest.mark.parametrize("module", JAX_INITS)
def test_port_exports_every_jax_export(module):
    _, _, jax_all = _top_level(JAX_PKG / module)
    _, _, port_all = _top_level(PORT_PKG / module)
    missing = sorted(set(jax_all or ()) - set(port_all or ()))
    assert not missing, f"{module}: __all__ lacks {missing}"


def test_allowed_names_are_still_missing():
    """Each allowed name is a top-level name of its JAX module that the
    port's module lacks: an entry whose name came or went is stale."""
    stale = []
    for module, name in ALLOWED:
        jd, ji, _ = _top_level(JAX_PKG / module)
        pd, pi, _ = _top_level(PORT_PKG / module)
        if name not in jd | ji or name in pd | pi:
            stale.append((module, name))
    assert not stale


def test_names_imported_from_the_packages():
    import colormipsearch_tpu.parallel as jparallel
    import colormipsearch_tpu.results as jresults
    import colormipsearch_tpu_torch.parallel as tparallel
    import colormipsearch_tpu_torch.results as tresults
    from colormipsearch_tpu_torch.parallel import mesh as tmesh
    from colormipsearch_tpu_torch.results import grouping as tgrouping

    assert set(jresults.__all__) <= set(tresults.__all__)
    assert set(jparallel.__all__) <= set(tparallel.__all__)
    assert tresults.ScoredEntry is tgrouping.ScoredEntry
    assert tresults.partition_collection is tgrouping.partition_collection
    assert tparallel.make_sharded_search_step is \
        tmesh.make_sharded_search_step


# --- results.partition_collection ----------------------------------------


@pytest.mark.parametrize("n,size", [(0, 3), (1, 3), (7, 3), (9, 3),
                                    (5, 1), (5, 0), (5, -2), (4, 10)])
def test_partition_collection_equals_jax(n, size):
    from colormipsearch_tpu_torch.results import partition_collection

    items = np.random.default_rng(n * 31 + size).integers(0, 99, n).tolist()
    got = partition_collection(iter(items), size)
    assert got == jgrouping.partition_collection(iter(items), size)
    assert [x for chunk in got for x in chunk] == items


# --- ops.shape_score.pack_target_rows_split -------------------------------


@pytest.mark.parametrize("mirror,excluded", [(True, True), (False, True),
                                             (True, False), (False, False)])
def test_pack_target_rows_split_equals_jax(mirror, excluded):
    rng = np.random.default_rng(16)
    h, w = 40, 56
    region = np.zeros((h, w), bool)
    region[: h // 4, : w // 3] = True
    q = testing.scattered_pixels(rng, h, w, 240)
    qp = tss.pack_query(q, excluded_region=region)
    pos_gap, pos_he = tss.support_split(qp)
    n_gap = tss.support_bucket(pos_gap.size, minimum=64)
    n_he = tss.he_words(pos_he.size, minimum=4)
    ts = [testing.scattered_pixels(rng, h, w, 450) for _ in range(6)]
    grads = [rng.integers(0, 400, (h, w)).astype(np.uint16) for _ in ts]
    zgaps = [jshape.dilate_rgb(jshape.mask_rgb(t, 20), 4) for t in ts]
    kw = dict(mask_threshold=20, excluded=region if excluded else None,
              mirror=mirror)
    args = (ts, grads, zgaps, pos_gap, n_gap, pos_he, n_he)
    got = tss.pack_target_rows_split(*args, **kw)
    want = jss.pack_target_rows_split(*args, **kw)
    n_or = 2 if mirror else 1
    assert got[0].shape == (n_or, n_gap, len(ts))
    assert got[1].shape == (n_or, n_he, len(ts))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    empty = tss.pack_target_rows_split([], [], [], *args[3:], **kw)
    for a, b in zip(empty, jss.pack_target_rows_split([], [], [], *args[3:],
                                                      **kw)):
        assert a.shape == b.shape and a.dtype == b.dtype


# --- io.native_decoder: the TIFF entry points -----------------------------


@pytest.fixture(scope="module")
def native():
    if not (tnative.available() and jnative.available()):
        pytest.skip("native decoder unavailable (no toolchain)")


def _tiff(arr, compression=None) -> bytes:
    buf = io.BytesIO()
    kw = {"compression": compression} if compression else {}
    Image.fromarray(arr).save(buf, format="TIFF", **kw)
    return buf.getvalue()


def _cdm(rng, h, w, n=800):
    arr = np.zeros((h, w, 3), np.uint8)
    arr[rng.integers(0, h, n), rng.integers(0, w, n)] = \
        rng.integers(1, 256, (n, 3))
    return arr


TIFF_FORMS = {
    "rgb_raw": lambda rng: _tiff(_cdm(rng, 120, 160)),
    "rgb_packbits": lambda rng: _tiff(_cdm(rng, 120, 160), "packbits"),
    "gray8_packbits": lambda rng: _tiff(
        rng.integers(0, 256, (61, 77)).astype(np.uint8), "packbits"),
    "gray16_raw": lambda rng: _tiff(
        rng.integers(0, 1 << 16, (33, 45)).astype(np.uint16)),
    "not_a_tiff": lambda rng: testing.encode_png(_cdm(rng, 8, 8)),
    "truncated": lambda rng: _tiff(_cdm(rng, 120, 160))[:100],
}


@pytest.mark.parametrize("form", sorted(TIFF_FORMS))
def test_decode_tiff_equals_jax(native, form):
    data = TIFF_FORMS[form](np.random.default_rng(len(form)))
    info = tnative.tiff_info(data)
    assert info == jnative.tiff_info(data)
    got = tnative.decode_tiff(data)
    want = jnative.decode_tiff(data)
    if want is None:
        assert got is None
        assert form in ("not_a_tiff", "truncated")
        return
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    h = info[1]
    for y0, y1 in ((10, 42), (0, 1), (h - 1, h), (0, h), (5, 5), (3, h + 1)):
        part = tnative.decode_tiff(data, y0=y0, y1=y1)
        jpart = jnative.decode_tiff(data, y0=y0, y1=y1)
        if jpart is None:
            assert part is None
            continue
        np.testing.assert_array_equal(part, jpart)
        np.testing.assert_array_equal(part, got[y0:y1])


@pytest.mark.parametrize("offset,start,end", [(0, 0, 0), (0, 3, 6),
                                              (2, 0, 0), (0, 5, 8)])
def test_packbits_uncompress_equals_jax(native, offset, start, end):
    # literal run of 3 + replicate run of 4 + literal 1, then a random
    # literal run
    rng = np.random.default_rng(offset * 7 + start + end)
    tail = rng.integers(0, 256, 20).astype(np.uint8).tobytes()
    encoded = bytes([2, 1, 2, 3, 0xFD, 9, 0, 7, 19]) + tail
    got = np.zeros(40, np.uint8)
    want = np.zeros(40, np.uint8)
    n = tnative.packbits_uncompress(encoded, got, offset, start, end)
    assert n == jnative.packbits_uncompress(encoded, want, offset, start,
                                            end)
    np.testing.assert_array_equal(got, want)


def test_decode_tiff_batch_equals_jax(native):
    """Same-shape TIFFs (raw and PackBits) decode in one arena; a blob of
    another shape and one that is no TIFF are flagged not ok, in both
    packages alike."""
    rng = np.random.default_rng(29)
    h, w = 120, 160
    imgs = [_cdm(rng, h, w) for _ in range(4)]
    blobs = [_tiff(imgs[0]), _tiff(imgs[1], "packbits"),
             _tiff(_cdm(rng, h + 8, w)), _tiff(imgs[2], "packbits"),
             b"not a tiff", _tiff(imgs[3])]
    got = tnative.decode_tiff_batch(blobs, width=w, height=h, channels=3,
                                    n_threads=3)
    want = jnative.decode_tiff_batch(blobs, width=w, height=h, channels=3,
                                     n_threads=3)
    np.testing.assert_array_equal(got[1], want[1])
    assert got[1].tolist() == [True, True, False, True, False, True]
    for i, ok in enumerate(got[1]):
        if ok:
            np.testing.assert_array_equal(got[0][i], want[0][i])
    np.testing.assert_array_equal(got[0][[0, 1, 3, 5]], np.stack(imgs))


def test_decode_img_batch_unchanged(native):
    """The shared batch helper keeps decode_img_batch's contract: PNGs
    and TIFFs of one shape in one arena, another shape flagged."""
    rng = np.random.default_rng(30)
    h, w = 40, 56
    imgs = [_cdm(rng, h, w, 200) for _ in range(3)]
    blobs = [testing.encode_png(imgs[0]), _tiff(imgs[1]),
             testing.encode_png(_cdm(rng, h, w + 1, 200)),
             testing.encode_png(imgs[2])]
    arena, ok = tnative.decode_img_batch(blobs, width=w, height=h,
                                         channels=3)
    jarena, jok = jnative.decode_img_batch(blobs, width=w, height=h,
                                           channels=3)
    assert ok.tolist() == jok.tolist() == [True, True, False, True]
    np.testing.assert_array_equal(arena[ok], jarena[jok])
    np.testing.assert_array_equal(arena[ok], np.stack(imgs))


# --- utils.metrics.maybe_profile ------------------------------------------


def test_maybe_profile_writes_a_trace(tmp_path, monkeypatch):
    trace_dir = tmp_path / "profile" / "nested"
    monkeypatch.setenv("COLORMIPSEARCH_TPU_PROFILE_DIR", str(trace_dir))
    x = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    with tmetrics.maybe_profile():
        y = (x @ x).sum()
    assert float(y) == float((x.double() @ x.double()).sum())
    files = list(trace_dir.iterdir())
    assert len(files) == 1 and files[0].suffix == ".json"
    events = json.loads(files[0].read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert any(n and "mm" in n for n in names), sorted(map(str, names))[:20]


def test_maybe_profile_takes_an_explicit_directory(tmp_path, monkeypatch):
    monkeypatch.delenv("COLORMIPSEARCH_TPU_PROFILE_DIR", raising=False)
    with tmetrics.maybe_profile(str(tmp_path / "p")):
        torch.ones(3).add_(1)
    assert len(list((tmp_path / "p").glob("*.json"))) == 1


def test_maybe_profile_without_a_directory_does_nothing(tmp_path,
                                                        monkeypatch):
    monkeypatch.delenv("COLORMIPSEARCH_TPU_PROFILE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    started = []
    monkeypatch.setattr(torch.profiler, "profile",
                        lambda *a, **k: started.append(a) or None)
    with tmetrics.maybe_profile():
        value = torch.ones(2).sum()
    assert float(value) == 2.0
    assert not started and not os.listdir(tmp_path)
