"""The port's shape pass (gradientScores' engine and its parts) against
the JAX package, on the CPU: the kernels' plain versions, the host
packers, the store format, the float64 oracle and the engine as a whole.

Every input is made with numpy from a seed and handed to both packages;
equality is exact unless a test says otherwise.
"""

import numpy as np
import pytest
import torch

from colormipsearch_tpu.engine import cds as jcds
from colormipsearch_tpu.engine import gradscore as jgs
from colormipsearch_tpu.io import shape_pack as jpack
from colormipsearch_tpu.model import CDMatch as JCDMatch
from colormipsearch_tpu.model import neuron_from_json as jax_neuron
from colormipsearch_tpu.ops import shape_score as jss
from colormipsearch_tpu.ops import slice_lut as jlut
from colormipsearch_tpu.oracle import shape as jshape
from colormipsearch_tpu_torch import convert, testing
from colormipsearch_tpu_torch.engine import cds as tcds
from colormipsearch_tpu_torch.engine import gradscore as tgs
from colormipsearch_tpu_torch.io import native_decoder as tnative
from colormipsearch_tpu_torch.io import shape_pack as tpack
from colormipsearch_tpu_torch.model import CDMatch
from colormipsearch_tpu_torch.ops import shape_score as tss
from colormipsearch_tpu_torch.ops import slice_lut as tlut
from colormipsearch_tpu_torch.oracle import shape as tshape

torch.set_num_threads(2)
CPU = torch.device("cpu")


def _cdm(rng, h, w, n):
    """Scattered random colors (every class, ties, dim pixels)."""
    return testing.scattered_pixels(rng, h, w, n)


def _corner(rng, h, w, n):
    """Random colors in the bottom-right 10 x 12 box only (clear of
    _region): the r=20..60 high-expression ring then covers much of a
    small image."""
    img = np.zeros((h, w, 3), np.uint8)
    img[-10:, -12:] = _cdm(rng, 10, 12, n)
    return img


def _region(h, w):
    region = np.zeros((h, w), bool)
    region[: h // 4, : w // 3] = True
    return region


def _t(a):
    return convert.as_tensor(a, CPU)


# --- slice table, oracle ------------------------------------------------


def test_slice_table_shared_with_jax():
    """Both packages load one table (the same cache file) and agree with
    the port's float64 slice_numbers on random colors and black."""
    assert tlut._cache_dir() == jlut._cache_dir()
    lut = tlut.get_slice_lut()
    np.testing.assert_array_equal(lut, jlut.get_slice_lut())
    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 256, (4000, 1, 3)).astype(np.uint8)
    rgb[0] = 0
    want = tshape.slice_numbers(rgb)
    np.testing.assert_array_equal(tlut.slice_numbers_lut(rgb), want)
    np.testing.assert_array_equal(jlut.slice_numbers_lut(rgb), want)


@pytest.mark.parametrize("mirror", [True, False])
@pytest.mark.parametrize("roi", [False, True])
@pytest.mark.parametrize("region", [False, True])
def test_oracle_equals_jax(mirror, roi, region):
    rng = np.random.default_rng(7)
    h, w = 40, 56
    q = _corner(rng, h, w, 60)
    kw = dict(mirror=mirror, negative_radius=6,
              excluded_region=_region(h, w) if region else None,
              roi_mask_rgb=_cdm(rng, h, w, 900) if roi else None)
    port = tshape.ShapeMatchOracle(q, 20, **kw)
    ref = jshape.ShapeMatchOracle(q, 20, **kw)
    for i in range(3):
        t = _cdm(rng, h, w, 500)
        grad = rng.integers(0, 400, (h, w)).astype(np.uint16)
        zgap = None if i == 2 else tshape.dilate_rgb(
            tshape.mask_rgb(t, 20), 4)
        got, want = port.score(t, grad, zgap), ref.score(t, grad, zgap)
        assert (got.gradient_area_gap, got.high_expression_area,
                got.mirrored) == (want.gradient_area_gap,
                                  want.high_expression_area, want.mirrored)
        assert got.high_expression_area > 0 or roi
    assert tshape.normalized_score(87, 1234, 55, 90, 4000) == \
        jshape.normalized_score(87, 1234, 55, 90, 4000)


# --- host packers ---------------------------------------------------------


@pytest.mark.parametrize("mirror", [True, False])
def test_host_packers_equal_jax(tmp_path, mirror):
    rng = np.random.default_rng(11)
    h, w = 44, 60
    region = _region(h, w)
    q = _cdm(rng, h, w, 260)
    q[5, 5] = (1, 1, 2)  # a dim pixel: the exact per-channel ring path
    roi = (_cdm(rng, h, w, 1500).sum(-1) > 0)
    np.testing.assert_array_equal(tss.high_expression_ring(q),
                                  jss.high_expression_ring(q))
    for kw in (dict(excluded_region=region),
               dict(excluded_region=region, roi_keep=roi)):
        np.testing.assert_array_equal(tss.pack_query(q, **kw),
                                      jss.pack_query(q, **kw))
    qp = tss.pack_query(q, excluded_region=region)
    qpm = tss.pack_query(q, excluded_region=region, roi_keep=roi[:, ::-1])
    for args in ((qp,), (qp, qpm)):
        for a, b in zip(tss.support_split(*args), jss.support_split(*args)):
            np.testing.assert_array_equal(a, b)
    pos_gap, pos_he = tss.support_split(qp)
    for n in (0, 5, 4096, 4097, 9000):
        assert tss.support_bucket(n, minimum=64) == \
            jss.support_bucket(n, minimum=64)
        assert tss.he_words(n, minimum=4) == jss.he_words(n, minimum=4)
    n_gap = tss.support_bucket(pos_gap.size, minimum=64)
    n_he = tss.he_words(pos_he.size, minimum=4)
    for a, b in zip(tss.sparse_query_split(qp, pos_gap, n_gap, pos_he, n_he),
                    jss.sparse_query_split(qp, pos_gap, n_gap, pos_he, n_he)):
        np.testing.assert_array_equal(a, b)

    plan = tss.split_gather_plan(pos_gap, pos_he, w, mirror=mirror,
                                 excluded=region)
    for a, b in zip(plan, jss.split_gather_plan(
            pos_gap, pos_he, w, mirror=mirror, excluded=region)):
        np.testing.assert_array_equal(a, b)
    cols, rows = [], []
    store = tpack.ShapePackStore(tmp_path / "s", h, w)
    for i in range(5):
        t = _cdm(rng, h, w, 500)
        grad = rng.integers(0, 400, (h, w)).astype(np.uint16)
        zgap = tshape.dilate_rgb(tshape.mask_rgb(t, 20), 4)
        kw = dict(mask_threshold=20, excluded=region, mirror=mirror)
        got = tss.select_target_cols_split(t, grad, zgap, pos_gap, n_gap,
                                           pos_he, n_he, **kw)
        for a, b in zip(got, jss.select_target_cols_split(
                t, grad, zgap, pos_gap, n_gap, pos_he, n_he, **kw)):
            np.testing.assert_array_equal(a, b)
        cols.append(got)
        fields = tpack.build_row_fields(t, grad, zgap, mask_threshold=20)
        for a, b in zip(fields, jpack.build_row_fields(
                t, grad, zgap, mask_threshold=20)):
            np.testing.assert_array_equal(a, b)
        from_row = tss.select_target_cols_split_from_row(
            *fields, pos_gap, n_gap, n_he, plan, mirror=mirror)
        for a, b in zip(from_row, got):
            np.testing.assert_array_equal(a, b)
        rows.append(store.append(f"k{i}", *fields))
    want = jss.assemble_target_rows_split(cols, n_gap, n_he, mirror=mirror)
    got = tss.assemble_target_rows_split(cols, n_gap, n_he, mirror=mirror)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    tile = tss.select_target_tile_from_store(store, rows, pos_gap, n_gap,
                                             n_he, plan, mirror=mirror)
    for a, b in zip(tile, want):
        np.testing.assert_array_equal(a, b)


def test_store_tile_numpy_path_and_native_row_fields(tmp_path,
                                                      monkeypatch):
    """The numpy fallbacks of the store gather and the row build equal
    the native library's output (where it builds here)."""
    rng = np.random.default_rng(13)
    h, w = 37, 53
    q = _cdm(rng, h, w, 240)
    pos_gap, pos_he = tss.support_split(tss.pack_query(q))
    n_gap = tss.support_bucket(pos_gap.size, minimum=64)
    n_he = tss.he_words(pos_he.size, minimum=4)
    plan = tss.split_gather_plan(pos_gap, pos_he, w, mirror=True,
                                 excluded=_region(h, w))
    store = tpack.ShapePackStore(tmp_path / "s", h, w)
    images = []
    for i in range(4):
        t = _cdm(rng, h, w, 420)
        grad = rng.integers(0, 1 << 16, (h, w)).astype(np.uint16)
        zgap = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        images.append((t, grad, zgap))
        store.append(f"k{i}", *tpack.build_row_fields(
            t, grad, zgap, mask_threshold=20))
    first = tss.select_target_tile_from_store(store, [3, 0, 2], pos_gap,
                                              n_gap, n_he, plan)
    native_rows = [tpack.build_row_fields(*im, mask_threshold=20)
                   for im in images]
    monkeypatch.setattr(tnative, "available", lambda: False)
    second = tss.select_target_tile_from_store(store, [3, 0, 2], pos_gap,
                                               n_gap, n_he, plan)
    for a, b in zip(first, second):
        np.testing.assert_array_equal(a, b)
    for im, row in zip(images, native_rows):
        for a, b in zip(tpack.build_row_fields(*im, mask_threshold=20),
                        row):
            np.testing.assert_array_equal(a, b)


def test_store_format_shared_with_jax(tmp_path):
    """A store written by either package reads in the other: same rows,
    same keys, same file identities."""
    rng = np.random.default_rng(3)
    h, w = 20, 30
    rows = [(rng.integers(0, 257, h * w).astype(np.uint16),
             rng.integers(0, 400, h * w).astype(np.uint16),
             rng.integers(0, 256, -(-h * w // 8)).astype(np.uint8))
            for _ in range(3)]
    for writer, reader in ((jpack, tpack), (tpack, jpack)):
        root = tmp_path / writer.__name__.split(".")[0]
        store = writer.ShapePackStore(root, h, w)
        keys = [store.entry_key(cdm_id=f"c{i}", grad_id="g", zgap_id=None,
                                mask_threshold=20, fallback_desc="d")
                for i in range(3)]
        for k, fields in zip(keys, rows):
            store.append(k, *fields)
        other = reader.ShapePackStore(root, h, w)
        assert len(other) == 3
        for i, k in enumerate(keys):
            assert other.entry_key(cdm_id=f"c{i}", grad_id="g",
                                   zgap_id=None, mask_threshold=20,
                                   fallback_desc="d") == k
            assert other.lookup(k) == i
            for a, b in zip(other.row(i), rows[i]):
                np.testing.assert_array_equal(a, b)
    f = tmp_path / "f.png"
    f.write_bytes(b"123")
    from colormipsearch_tpu.model import FileData as JFileData
    from colormipsearch_tpu_torch.model import FileData

    assert tpack.file_identity(FileData(str(f), "e")) == \
        jpack.file_identity(JFileData(str(f), "e"))


# --- K5 -------------------------------------------------------------------


def _edge_planes(rng, n_or, sg, n_words, t):
    """Gap planes whose words hit every branch edge: grad 0xFFFF, slice
    256, slice gaps of exactly 79 and 80, black z-gap, zero pad rows."""
    z = rng.integers(0, 257, (n_or, sg, t))
    grad = rng.integers(0, 1 << 16, (n_or, sg, t))
    q_sl = rng.integers(0, 257, (n_or, sg))
    q_bits = rng.integers(0, 4, (n_or, sg)) << 9          # nz, sig
    q_sl[:, :4] = 100
    z[:, 0, :] = 179                                     # gap 79
    z[:, 1, :] = 180                                     # gap 80
    z[:, 2, :] = 256
    z[:, 3, :] = 0
    grad[:, :, 0] = 0xFFFF
    q = (q_sl | q_bits).astype(np.int32)
    q[:, -3:] = 0                                        # pad rows
    t_gap = ((z << 16) | grad).astype(np.uint32)
    t_gap[:, -3:] = 0
    t_he = rng.integers(0, 1 << 32, (n_or, n_words, t), dtype=np.uint64) \
        .astype(np.uint32)
    q_he = rng.integers(0, 1 << 32, (n_or, n_words), dtype=np.uint64) \
        .astype(np.uint32)
    q_he[:, -1] = 0
    return t_gap, q, t_he, q_he


@pytest.mark.parametrize("n_or", [1, 2])
@pytest.mark.parametrize("random_bits", [False, True])
def test_k5_plain_equals_jax(n_or, random_bits):
    rng = np.random.default_rng(5 + n_or)
    t_gap, q_gap, t_he, q_he = _edge_planes(rng, n_or, 300, 9, 37)
    if random_bits:  # every bit pattern, the int32 semantics included
        t_gap = rng.integers(0, 1 << 32, t_gap.shape,
                             dtype=np.uint64).astype(np.uint32)
        q_gap = rng.integers(-(1 << 31), 1 << 31, q_gap.shape,
                             dtype=np.int64).astype(np.int32)
    want = jss.shape_score_pairs_split_raw(t_gap, q_gap, t_he, q_he)
    got = tss.shape_score_pairs_split(_t(t_gap), _t(q_gap), _t(t_he),
                                      _t(q_he))
    for a, b in zip(got, want):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # the row chunking of the plain version changes nothing
    small = tss.shape_score_pairs_split_plain(
        _t(t_gap), _t(q_gap), _t(t_he), _t(q_he), chunk=7)
    for a, b in zip(small, got):
        assert torch.equal(a, b)
    # mirror selection: lower negative score wins, straight on ties
    for a, b in zip(tss.score_shape_batch_split(t_gap, t_he, q_gap, q_he,
                                                device=CPU),
                    jss.score_shape_batch_split(t_gap, t_he, q_gap, q_he)):
        np.testing.assert_array_equal(a, b)


def test_k5_rejects_bad_inputs():
    z = torch.zeros
    with pytest.raises(TypeError):
        tss.shape_score_pairs_split(z((2, 4, 3), dtype=torch.int64),
                                    z((2, 4), dtype=torch.int32),
                                    z((2, 1, 3), dtype=torch.int32),
                                    z((2, 1), dtype=torch.int32))
    with pytest.raises(ValueError):
        tss.shape_score_pairs_split(z((3, 4, 3), dtype=torch.int32),
                                    z((3, 4), dtype=torch.int32),
                                    z((3, 1, 3), dtype=torch.int32),
                                    z((3, 1), dtype=torch.int32))
    with pytest.raises(ValueError):
        tss.shape_score_pairs_split(z((2, 4, 3), dtype=torch.int32),
                                    z((2, 5), dtype=torch.int32),
                                    z((2, 1, 3), dtype=torch.int32),
                                    z((2, 1), dtype=torch.int32))


# --- K6, K7 ---------------------------------------------------------------


def _jax_store(tmp_path, rng, h, w, n):
    store = jpack.ShapePackStore(tmp_path / "jstore", h, w)
    for i in range(n):
        t = _cdm(rng, h, w, 420)
        grad = rng.integers(0, 1 << 16, (h, w)).astype(np.uint16)
        zgap = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        store.append(f"k{i}", *jpack.build_row_fields(
            t, grad, zgap, mask_threshold=20))
    return store


@pytest.mark.parametrize("mirror", [True, False])
@pytest.mark.parametrize("with_region", [True, False])
def test_k6_plain_equals_jax(tmp_path, mirror, with_region):
    """K6's plain version on a store the JAX package wrote and the port
    reads equals the JAX device tile and the host tile gather."""
    rng = np.random.default_rng(19)
    h, w = 37, 53
    _jax_store(tmp_path, rng, h, w, 6)
    jstore = jpack.ShapePackStore(tmp_path / "jstore", h, w)
    store = tpack.ShapePackStore(tmp_path / "jstore", h, w)
    region = _region(h, w) if with_region else None
    q = _cdm(rng, h, w, 240)
    pos_gap, pos_he = tss.support_split(tss.pack_query(
        q, excluded_region=region))
    n_gap = tss.support_bucket(pos_gap.size, minimum=64)
    n_he = tss.he_words(pos_he.size, minimum=4)
    plan = tss.split_gather_plan(pos_gap, pos_he, w, mirror=mirror,
                                 excluded=region)
    kw = dict(n_gap_pad=n_gap, n_he_words=n_he)
    tp = tss.tile_positions(pos_gap, *plan, mirror=mirror, device=CPU,
                            **kw)
    jfields = jss.device_store_fields(jstore)
    for rows, fields, jf in (
            ([5, 0, 2, 2, 4], tss.device_store_fields(store, CPU), jfields),
            ([2, 0, 1], tss.device_store_fields(store, CPU, rows=[4, 1, 3]),
             jss.device_store_fields(jstore, rows=[4, 1, 3]))):
        rows_sel = torch.tensor(rows, dtype=torch.int32)
        got = tss.shape_tile_device(fields, rows_sel, tp, **kw)
        want = jss.shape_tile_device(jf, rows, pos_gap, *plan,
                                     mirror=mirror, **kw)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy().view(np.uint32),
                                          np.asarray(b))
    host = tss.select_target_tile_from_store(store, [5, 0, 2, 2, 4],
                                             pos_gap, n_gap, n_he, plan,
                                             mirror=mirror)
    got = tss.shape_tile_device(tss.device_store_fields(store, CPU),
                                torch.tensor([5, 0, 2, 2, 4],
                                             dtype=torch.int32), tp, **kw)
    for a, b in zip(got, host):
        np.testing.assert_array_equal(a.numpy().view(np.uint32), b)
    small = tss.shape_tile_device_plain(
        tss.device_store_fields(store, CPU),
        torch.tensor([5, 0, 2, 2, 4], dtype=torch.int32), tp,
        chunk_words=1, **kw)
    for a, b in zip(small, got):
        assert torch.equal(a, b)


def test_k6_rejects_bad_inputs(tmp_path):
    rng = np.random.default_rng(2)
    h, w = 16, 24
    store = tpack.ShapePackStore(tmp_path / "s", h, w)
    for i in range(2):
        store.append(f"k{i}", *tpack.build_row_fields(
            _cdm(rng, h, w, 50), rng.integers(0, 400, (h, w)).astype(
                np.uint16), _cdm(rng, h, w, 80), mask_threshold=20))
    fields = tss.device_store_fields(store, CPU)
    tp = tss.tile_positions(np.array([3, 9], np.int32),
                            np.array([3, 9], np.int32),
                            np.array([1], np.int32), None, n_gap_pad=4,
                            n_he_words=1, mirror=False, device=CPU)
    kw = dict(n_gap_pad=4, n_he_words=1)
    good = torch.tensor([1, 0], dtype=torch.int32)
    tss.shape_tile_device(fields, good, tp, **kw)
    with pytest.raises(ValueError):  # a store row that does not exist
        tss.shape_tile_device(fields, torch.tensor([2], dtype=torch.int32),
                              tp, **kw)
    with pytest.raises(TypeError):
        tss.shape_tile_device(fields, good.long(), tp, **kw)
    with pytest.raises(ValueError):  # planes narrower than the positions
        tss.shape_tile_device(fields, good, tp, n_gap_pad=8, n_he_words=1)
    with pytest.raises(ValueError):
        tss.tile_positions(np.arange(5, dtype=np.int32),
                           np.arange(5, dtype=np.int32),
                           np.array([1], np.int32), None, n_gap_pad=4,
                           n_he_words=1, mirror=False, device=CPU)


@pytest.mark.parametrize("dtype", [np.uint16, np.uint8])
def test_k7_plain_equals_jax(dtype):
    """The chunked pixel-major upload (several chunks, a ragged last one)
    equals the JAX package's upload, bit for bit."""
    rng = np.random.default_rng(0)
    field = rng.integers(0, np.iinfo(dtype).max + 1, (7, 1003)).astype(dtype)
    want = np.asarray(jss._upload_pixel_major(field, chunk_bytes=4096))
    for chunk_bytes in (4096, 7 * 1003 * 2, 1):
        got = tss.upload_pixel_major(field, CPU, chunk_bytes=chunk_bytes)
        np.testing.assert_array_equal(got.numpy().view(dtype), want)
    buf = torch.zeros((10, 3), dtype=torch.int16)
    with pytest.raises(ValueError):  # past the buffer's end
        tss.upload_pixel_major_chunk(buf, torch.ones((3, 4),
                                                     dtype=torch.int16), 8)
    with pytest.raises(TypeError):
        tss.upload_pixel_major_chunk(buf, torch.ones((3, 4),
                                                     dtype=torch.uint8), 0)


# --- the engine -----------------------------------------------------------


@pytest.fixture(scope="module")
def shape_library(tmp_path_factory):
    """4 masks (two cut from targets, one independent, one corner) x 10
    targets with
    gradient and z-gap variants, as PNGs; two targets lack the z-gap
    variant (the dilation fallback) and one the gradient (unscored)."""
    tmp = tmp_path_factory.mktemp("shape")
    rng = np.random.default_rng(17)
    h, w = 48, 72
    lib = testing.synthetic_library(rng, 10, 3, h, w, target_fg=0.08,
                                    mask_fg=0.03)
    corner = np.zeros_like(lib.targets[4])
    corner[:12, :16] = lib.targets[4][:12, :16]
    lib.masks.append(corner)  # a query with a wide high-expression ring
    grads = [testing.synthetic_gradient(rng, t) for t in lib.targets]
    zgaps = [testing.synthetic_zgap(t, radius=4) for t in lib.targets]
    targets = testing.write_neuron_images(tmp / "t", lib.targets, "t",
                                          gradients=grads, zgaps=zgaps,
                                          threads=2)
    from colormipsearch_tpu_torch.model import ComputeFileType

    for t in targets[:2]:
        t.compute_files.pop(ComputeFileType.ZGapImage)
    targets[2].compute_files.pop(ComputeFileType.GradientImage)
    masks = testing.write_neuron_images(tmp / "m", lib.masks, "m",
                                        threads=2)
    return tmp, masks, targets


def _matches(masks, targets, cls=CDMatch, conv=lambda n: n):
    out = []
    for i, m in enumerate(masks):
        mm = conv(m)
        for j, t in enumerate(targets):
            out.append(cls(mask_image=mm, matched_image=conv(t),
                           matching_pixels=10 + (7 * i + 3 * j) % 13,
                           matching_pixels_ratio=0.1))
    return out


def _scores(matches):
    return [(m.mask_image.mip_id, m.matched_image.mip_id,
             m.gradient_area_gap, m.high_expression_area,
             m.normalized_score) for m in matches]


@pytest.mark.parametrize("mode", ["default", "store", "device_store",
                                  "oracle"])
def test_engine_equals_jax(shape_library, tmp_path, monkeypatch, mode):
    tmp, masks, targets = shape_library
    params = dict(mask_threshold=20, data_threshold=20, mirror_mask=True,
                  negative_radius=4, border_size=2)
    store_kw = {}
    if mode in ("store", "device_store"):
        store_kw = dict(pack_store=str(tmp_path / "store"))
    if mode == "device_store":
        monkeypatch.setenv("CDS_SHAPE_STORE_DEVICE", "1")
    use_device = mode != "oracle"
    roi = testing.scattered_pixels(np.random.default_rng(1), 48, 72, 2500)
    # the store runs twice: the first builds the rows, the second reads
    # them (from the device-resident fields in device_store mode)
    for _ in range(2 if store_kw else 1):
        port = tgs.GradScoreEngine(tcds.CDSParams(**params), device="cpu",
                                   use_device=use_device, decode_workers=2,
                                   **store_kw)
        ref = jgs.GradScoreEngine(jcds.CDSParams(**params), use_mesh=False,
                                  use_device=use_device, decode_workers=2,
                                  **store_kw)
        for roi_rgb in (None, roi):
            got = port.score_matches(_matches(masks, targets),
                                     roi_rgb=roi_rgb)
            want = ref.score_matches(
                _matches(masks, targets, JCDMatch,
                         lambda n: jax_neuron(n.to_json())),
                roi_rgb=roi_rgb)
            assert len(got) == 4 * 9
            assert _scores(got) == _scores(want)
            assert any(m.high_expression_area > 0 for m in got)
    if mode == "device_store":
        assert port._dev_store_cache
    if mode == "store":
        assert port._pack_store.hits > 0


def test_engine_refuses_what_is_not_ported(monkeypatch):
    """The shape pass across processes (torch.distributed with more than
    one rank) raises, as the JAX package has none either (ROADMAP.md §3);
    a CUDA engine without a GPU is an error."""
    import torch.distributed as dist

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda *a, **k: 2)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tgs.GradScoreEngine(tcds.CDSParams(), device="cpu", use_mesh=True)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tgs.GradScoreEngine(tcds.CDSParams(), device="cuda")
