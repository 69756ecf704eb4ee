"""Row 15 (slice numbers) and K8's split mode at their edge shapes, and
over every (class, p, s) the classifications produce, against the JAX
package.

On the CPU the wrappers run their plain versions; the inputs are
testing.SLICE_NUMBERS_EDGE_CASES and testing.PACK_SPLIT_EDGE_CASES, the
shapes at which chip_smoke.py and tests/test_torch_cuda.py hold the
kernels to those plain versions on the card. Integer outputs: exact
equality. The JAX functions run under jax.jit on JAX's CPU backend; JAX's
pack_target_planes_split has no t_pad, so the port's columns >= T must be
zero. The port holds the uint16 plane as int16 with the same bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colormipsearch_tpu.ops import common as jcommon
from colormipsearch_tpu.ops import shape_score as jss
from colormipsearch_tpu_torch import testing
from colormipsearch_tpu_torch.constants import SLICE_LUT_RANGES
from colormipsearch_tpu_torch.ops import common as tcommon
from colormipsearch_tpu_torch.ops import shape_score as tss

torch.set_num_threads(2)
CPU = torch.device("cpu")
_jax_slices = jax.jit(jss.slice_numbers_device)


def _split_equals_jax(got, stack, thr):
    t = stack.shape[0]
    sp, c8 = (np.asarray(x) for x in jcommon.pack_target_planes_split(
        jnp.asarray(stack), thr))
    assert got[0].dtype == torch.int16 and got[1].dtype == torch.uint8
    np.testing.assert_array_equal(got[0].numpy().view(np.uint16)[:, :t], sp)
    np.testing.assert_array_equal(got[1].numpy()[:, :t], c8)
    for plane in got:
        assert not plane[:, t:].any()


@pytest.mark.parametrize("case", testing.SLICE_NUMBERS_EDGE_CASES,
                         ids=[c[0] for c in testing.SLICE_NUMBERS_EDGE_CASES])
def test_row15_edge_cases_equal_jax(case):
    rng = np.random.default_rng(sum(map(ord, case[0])))
    rgb, view = testing.slice_numbers_edge_input(rng, case, CPU)
    got = tss.slice_numbers_device(view)
    assert got.dtype == torch.int32 and tuple(got.shape) == case[1]
    want = np.asarray(_jax_slices(jnp.asarray(rgb)))
    np.testing.assert_array_equal(got.numpy(), want)
    if case[2] == "black":
        assert not got.any()
    if case[2] == "dense":
        assert got.min() > 0


@pytest.mark.parametrize("case", testing.PACK_SPLIT_EDGE_CASES,
                         ids=[c[0] for c in testing.PACK_SPLIT_EDGE_CASES])
def test_k8_split_edge_cases_equal_jax(case):
    rng = np.random.default_rng(sum(map(ord, case[0])))
    stack, view, thr, t_pad = testing.pack_split_edge_input(rng, case, CPU)
    got = tcommon.pack_target_planes_split(view, thr, t_pad=t_pad)
    n_px = stack.shape[1] * stack.shape[2]
    assert all(tuple(x.shape) == (n_px, t_pad) for x in got)
    _split_equals_jax(got, stack, thr)
    if thr == 255:
        assert not got[0].any() and not got[1].any()


def test_every_class_p_s_equals_jax():
    """Every (class, p, s) of the >=-tie classification (p 1-255, s
    0-p), every two- and three-way channel tie and the 0/1/254/255
    extremes: row 15 equals JAX's slice_numbers_device, and K8's split
    mode (its strict classification) JAX's pack_target_planes_split, at
    three thresholds."""
    px = testing.slice_class_triples()
    cls = testing.slice_class(px)
    p = px.max(1).astype(int)
    s = np.sort(px, 1)[:, 1].astype(int)
    for c in range(1, 7):
        hit = {(a, b) for a, b in zip(p[cls == c], s[cls == c])}
        smin = 0 if c in (5, 4, 1) else 1
        want = {(a, b) for a in range(1, 256) for b in range(smin, a + 1)
                if not (c in (4, 1, 2) and b == a)}
        assert want <= hit, c
    got = tss.slice_numbers_device(torch.from_numpy(px))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(_jax_slices(jnp.asarray(px))))
    n = px.shape[0] // 8 * 8
    stack = px[:n].reshape(8, -1, 1, 3)
    for thr in (0, 20, 254):
        _split_equals_jax(tcommon.pack_target_planes_split(
            torch.from_numpy(stack), thr, t_pad=9), stack, thr)


def test_lut_rows_strictly_monotone():
    """The kernel's binary search needs every class row strictly
    monotone over its true length (_lut_tables asserts it too)."""
    rows, _ = tss._lut_tables()
    lens = tss._lut_lengths()
    assert lens == [hi - lo + 1 for lo, hi in (SLICE_LUT_RANGES[c]
                                               for c in range(1, 7))]
    for row, n in zip(rows, lens):
        step = np.diff(row[:n].astype(np.int64))
        assert (step > 0).all() or (step < 0).all()
        assert (row[n:] == 1 << 20).all()
