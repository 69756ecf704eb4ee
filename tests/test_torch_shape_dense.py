"""Row 18b (the dense-row shape scoring, one orientation or both) with its
host packers, and row 15 (slice numbers by the integer LUT scan), of the
PyTorch port against the JAX package.

On the CPU every wrapper runs its plain PyTorch version; the same inputs,
made with numpy from a seed, go through the JAX function (on JAX's CPU
backend) and the port. All outputs are integers, so the tolerance is 0:
exact equality. The CUDA kernels are compared with their plain versions
in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from colormipsearch_tpu.ops import shape_score as jss
from colormipsearch_tpu_torch import convert, testing
from colormipsearch_tpu_torch.kernels import build as kbuild
from colormipsearch_tpu_torch.ops import shape_score as tss
from colormipsearch_tpu_torch.ops import slice_lut as tlut

torch.set_num_threads(2)
CPU = torch.device("cpu")
H, W = 40, 64


def _library(rng, t=9):
    """Targets, 16-bit gradients and z-gap images (every class, black)."""
    targets = [testing.scattered_pixels(rng, H, W, 600) for _ in range(t)]
    grads = [testing.synthetic_gradient(rng, x) for x in targets]
    zgaps = [testing.synthetic_zgap(x) for x in targets]
    return targets, grads, zgaps


def _query(rng):
    q = np.zeros((H, W, 3), np.uint8)
    q[-14:, -20:] = testing.scattered_pixels(rng, 14, 20, 120)
    return q


# --- row 15 --------------------------------------------------------------


def test_row15_slice_numbers_equals_jax():
    """The plain version equals slice_numbers_device exactly on every
    class, black and the channel ties, for any leading shape; against the
    float64 table it differs only at exact ties, by one slice."""
    rng = np.random.default_rng(3)
    rgb = rng.integers(0, 256, (128, 128, 3)).astype(np.uint8)
    rgb[0, :4] = [(0, 0, 0), (255, 255, 255), (7, 7, 0), (0, 9, 9)]
    want = np.asarray(jss.slice_numbers_device(jnp.asarray(rgb)))
    got = tss.slice_numbers_device(torch.from_numpy(rgb))
    assert got.dtype == torch.int32 and tuple(got.shape) == rgb.shape[:2]
    np.testing.assert_array_equal(got.numpy(), want)
    flat = tss.slice_numbers_device(torch.from_numpy(rgb.reshape(-1, 3)))
    np.testing.assert_array_equal(flat.numpy(), want.reshape(-1))
    ref = tlut.slice_numbers_lut(rgb)
    bad = got.numpy() != ref
    assert np.abs(got.numpy()[bad] - ref[bad]).max(initial=0) <= 1
    assert bad.mean() < 0.005
    assert got[0, 0] == 0


def test_row15_lut_tables_equal_jax():
    for g, w in zip(tss._lut_tables(), jss._lut_tables()):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_row15_validates_and_never_counts_on_the_cpu():
    kbuild.reset_launches()
    tss.slice_numbers_device(torch.zeros((5, 3), dtype=torch.uint8))
    assert kbuild.launches["slice_numbers_device"] == 0
    with pytest.raises(TypeError):
        tss.slice_numbers_device(torch.zeros((5, 3), dtype=torch.int32))
    with pytest.raises(ValueError):
        tss.slice_numbers_device(torch.zeros((5, 4), dtype=torch.uint8))


# --- the dense packers -----------------------------------------------------


def test_pack_targets_equals_jax():
    rng = np.random.default_rng(11)
    targets, grads, zgaps = _library(rng, t=5)
    want = jss.pack_targets(np.stack(targets), np.stack(grads),
                            np.stack(zgaps), mask_threshold=20)
    got = tss.pack_targets(np.stack(targets), np.stack(grads),
                           np.stack(zgaps), mask_threshold=20)
    for g, w in zip(got, want):
        assert g.dtype == np.uint32
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("mirror", [True, False])
@pytest.mark.parametrize("excluded", [False, True])
def test_support_rows_pack_equals_jax(mirror, excluded):
    rng = np.random.default_rng(13)
    targets, grads, zgaps = _library(rng)
    q_img = _query(rng)
    q_pack = tss.pack_query(q_img)
    np.testing.assert_array_equal(q_pack, jss.pack_query(q_img))
    pos = tss.support_positions(q_pack)
    np.testing.assert_array_equal(pos, jss.support_positions(q_pack))
    n_pad = tss.support_bucket(pos.size, minimum=512)
    np.testing.assert_array_equal(tss.sparse_query(q_pack, pos, n_pad),
                                  jss.sparse_query(q_pack, pos, n_pad))
    region = None
    if excluded:
        region = np.zeros((H, W), bool)
        region[-6:, -30:] = True
    kw = dict(mask_threshold=20, excluded=region, mirror=mirror)
    got = tss.pack_target_rows(targets, grads, zgaps, pos, n_pad, **kw)
    want = np.asarray(jss.pack_target_rows(targets, grads, zgaps, pos,
                                           n_pad, **kw))
    assert got.dtype == np.uint32 and got.shape == (
        2 if mirror else 1, n_pad, len(targets))
    np.testing.assert_array_equal(got, want)


# --- row 18b ---------------------------------------------------------------


def _random_pack(rng, rows=300, t=24):
    """Target words over the whole 32-bit range and query words with
    every field, zero rows included."""
    t_pack = rng.integers(0, 1 << 32, (rows, t), dtype=np.uint64) \
        .astype(np.uint32)
    t_pack[:5, 0] = [(179 << 16) | (1 << 25), (180 << 16) | (1 << 25),
                     (256 << 16) | 0xFFFF, 1 << 26, 0]
    q_pack = rng.integers(0, 1 << 12, rows).astype(np.int32)
    q_pack[:5] = [100 | (3 << 9), 100 | (3 << 9), 0x7FF, 1 << 11, 0]
    q_pack[-20:] = 0
    return t_pack, q_pack


def test_row18b_pairs_equals_jax():
    rng = np.random.default_rng(5)
    t_pack, q_pack = _random_pack(rng)
    want = jss.shape_score_pairs(jnp.asarray(t_pack), jnp.asarray(q_pack))
    got = tss.shape_score_pairs(convert.shape_planes(t_pack, CPU),
                                convert.as_tensor(q_pack, CPU))
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and tuple(g.shape) == (24,)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_row18b_both_equals_jax_and_the_split_rows():
    """Both orientations on real packs equal JAX's
    shape_score_pairs_both, and, after the mirror selection, the split-row
    form (K5's plain version) on the same mask and targets."""
    rng = np.random.default_rng(17)
    targets, grads, zgaps = _library(rng)
    q_pack = tss.pack_query(_query(rng))
    pos = tss.support_positions(q_pack)
    n_pad = tss.support_bucket(pos.size, minimum=512)
    rows = tss.pack_target_rows(targets, grads, zgaps, pos, n_pad,
                                mask_threshold=20)
    q2 = np.stack([tss.sparse_query(q_pack, pos, n_pad)] * 2)
    want = jss.shape_score_pairs_both(jnp.asarray(rows), jnp.asarray(q2))
    got = tss.shape_score_pairs_both(convert.shape_planes(rows, CPU),
                                     convert.as_tensor(q2, CPU))
    for g, w in zip(got, want):
        assert tuple(g.shape) == (2, len(targets))
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    dense = tss.score_shape_batch_stacked(rows, q2[0], mirror=True,
                                          device=CPU)
    assert dense[0].max() > 0 and dense[1].max() > 0
    pos_gap, pos_he = tss.support_split(q_pack)
    n_gap_pad = tss.support_bucket(pos_gap.size, minimum=256)
    n_he_w = tss.he_words(pos_he.size, minimum=8)
    cols = [tss.select_target_cols_split(t, g, z, pos_gap, n_gap_pad,
                                         pos_he, n_he_w, mask_threshold=20)
            for t, g, z in zip(targets, grads, zgaps)]
    t_gap, t_he = tss.assemble_target_rows_split(cols, n_gap_pad, n_he_w)
    q = tss.sparse_query_split(q_pack, pos_gap, n_gap_pad, pos_he, n_he_w)
    split = tss.score_shape_batch_split(
        t_gap, t_he, np.stack([q[0]] * 2), np.stack([q[1]] * 2), device=CPU)
    for d, s in zip(dense, split):
        np.testing.assert_array_equal(d, s)


@pytest.mark.parametrize("mirror", [True, False])
def test_score_shape_batch_forms_equal_jax(mirror):
    """score_shape_batch (two dense planes, two calls) and
    score_shape_batch_stacked (one call) equal the JAX functions."""
    rng = np.random.default_rng(19)
    targets, grads, zgaps = _library(rng, t=6)
    q_pack = tss.pack_query(_query(rng))
    flat, flat_m = tss.pack_targets(np.stack(targets), np.stack(grads),
                                    np.stack(zgaps), mask_threshold=20)
    want = jss.score_shape_batch(jnp.asarray(flat), jnp.asarray(flat_m),
                                 q_pack, mirror=mirror)
    got = tss.score_shape_batch(flat, flat_m, q_pack, mirror=mirror,
                                device=CPU)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    pos = tss.support_positions(q_pack)
    rows = tss.pack_target_rows(targets, grads, zgaps, pos, pos.size,
                                mask_threshold=20, mirror=mirror)
    q = tss.sparse_query(q_pack, pos, pos.size)
    want = jss.score_shape_batch_stacked(jnp.asarray(rows), q,
                                         mirror=mirror)
    got = tss.score_shape_batch_stacked(rows, q, mirror=mirror, device=CPU)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_row18b_validates_and_never_counts_on_the_cpu():
    t = torch.zeros((2, 5, 7), dtype=torch.int32)
    q = torch.zeros((2, 5), dtype=torch.int32)
    kbuild.reset_launches()
    tss.shape_score_pairs_both(t, q)
    tss.shape_score_pairs(t[0], q[0])
    assert kbuild.launches["shape_score_pairs"] == 0
    with pytest.raises(ValueError):
        tss.shape_score_pairs(t, q)
    with pytest.raises(ValueError):
        tss.shape_score_pairs_both(t, q[:, :4])
    with pytest.raises(ValueError):
        tss.shape_score_pairs_both(torch.zeros((3, 5, 7), dtype=torch.int32),
                                   torch.zeros((3, 5), dtype=torch.int32))
    with pytest.raises(ValueError):
        convert.shape_planes(np.zeros((5, 7), np.int32), CPU)
