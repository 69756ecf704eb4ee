"""The port's host tables and union plans equal the JAX package's.

Rank table, interval tables (bisected against the float64 oracle) and
full-union plans are copied code; these tests pin them array-equal to
the JAX package so both packages score identical inputs.
"""

import dataclasses

import numpy as np
import pytest
import torch

from colormipsearch_tpu.ops import common as jcommon
from colormipsearch_tpu.ops import pixel_match as jpm
from colormipsearch_tpu_torch import convert, testing
from colormipsearch_tpu_torch.ops import common as tcommon
from colormipsearch_tpu_torch.ops import pixel_match as tpm

torch.set_num_threads(2)


def _assert_same(a, b, what):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and isinstance(b, np.ndarray), what
        assert a.dtype == b.dtype and a.shape == b.shape, what
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert a == b, what


def test_ratio_rank_table_equal():
    jv, jr = jcommon.ratio_rank_table()
    tv, tr = tcommon.ratio_rank_table()
    _assert_same(tv, jv, "vals")
    _assert_same(tr, jr, "rank")
    _assert_same(tcommon._rank_lut_flat(), jcommon._rank_lut_flat(), "lut")


@pytest.mark.parametrize("z_tol", [0.01, 0.02])
def test_interval_tables_equal(z_tol):
    for got, want in zip(tpm._key_interval_table2(z_tol),
                         jpm._key_interval_table2(z_tol)):
        _assert_same(got, want, f"_key_interval_table2({z_tol})")
    for got, want in zip(tpm.interval_table_arrays(z_tol),
                         jpm.interval_table_arrays(z_tol)):
        _assert_same(got, want, f"interval_table_arrays({z_tol})")
    # carried across bit-exact: uint32 -> int32 tensors with equal bits
    for t, a in zip(convert.interval_tables(
            jpm.interval_table_arrays(z_tol), torch.device("cpu")),
            jpm.interval_table_arrays(z_tol)):
        assert t.dtype == torch.int32
        np.testing.assert_array_equal(t.numpy().view(np.uint32), a)


@pytest.mark.parametrize("light", [False, True])
@pytest.mark.parametrize("mirror", [False, True])
@pytest.mark.parametrize("xy_shift", [0, 2, 4])
def test_full_union_plan_fields_equal(xy_shift, mirror, light):
    rng = np.random.default_rng(100 + xy_shift)
    h, w = 36, 52
    region = np.zeros((h, w), bool)
    region[:5, :7] = True
    img = testing.scattered_pixels(rng, h, w, 300)
    kw = dict(mirror=mirror, xy_shift=xy_shift, pix_color_fluctuation=1.0,
              excluded_region=region, light=light)
    got = tpm.build_full_union_key_plan(img, 20, **kw)
    want = jpm.build_full_union_key_plan(img, 20, **kw)
    for f in dataclasses.fields(want):
        _assert_same(getattr(got, f.name), getattr(want, f.name), f.name)


@pytest.mark.parametrize("xy_shift", [2, 4])
def test_batch_stackers_equal(xy_shift):
    """stack_union_plan_args / stack_union_pos_args (the plan tensors the
    engine uploads) equal the JAX package's for a mixed-size batch."""
    rng = np.random.default_rng(7 + xy_shift)
    h, w = 30, 44
    imgs = [testing.scattered_pixels(rng, h, w, n) for n in (260, 40, 150)]
    kw = dict(mirror=True, xy_shift=xy_shift, pix_color_fluctuation=1.0)
    tplans = [tpm.build_full_union_key_plan(i, 20, light=True, **kw)
              for i in imgs]
    jplans = [jpm.build_full_union_key_plan(i, 20, light=True, **kw)
              for i in imgs]
    for stacker in ("stack_union_plan_args", "stack_union_pos_args"):
        got = getattr(tpm, stacker)(tplans, h * w)
        want = getattr(jpm, stacker)(jplans, h * w)
        assert len(got) == len(want)
        for i, (g, x) in enumerate(zip(got, want)):
            _assert_same(g, x, f"{stacker}[{i}]")
