"""K6 and K5 at their edge shapes: the plain versions against the JAX
functions, exactly.

K6 (shape_tile_device) with no gap rows, no ring rows, a ring that is not
a multiple of 32, one orientation, ring rows out of raster order and
store rows unsorted with repeats; K5 (shape_score_pairs_split) at T 1, 3
and 13 (not multiples of the 4 columns a kernel thread takes), with
every query word zero and with one orientation. The same shapes hold
the kernels to these plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py phase 2).
"""

import numpy as np
import pytest
import torch

from colormipsearch_tpu.ops import shape_score as jss
from colormipsearch_tpu_torch import convert, testing
from colormipsearch_tpu_torch.ops import shape_score as tss

CPU = torch.device("cpu")


@pytest.mark.parametrize("case", testing.TILE_EDGE_CASES,
                         ids=[c[0] for c in testing.TILE_EDGE_CASES])
def test_k6_edge_shapes_equal_jax(case):
    rng = np.random.default_rng(sum(map(ord, case[0])))
    c = testing.tile_edge_case(rng, case)
    fields, rows, tp, kw = testing.tile_edge_inputs(c, CPU)
    got = tss.shape_tile_device(fields, rows, tp, **kw)
    want = jss.shape_tile_device((c["zsl"], c["grad"], c["tfg"]),
                                 c["rows"], c["pos_gap"], c["g_pos"],
                                 c["h_pos"], c["keep"], mirror=c["mirror"],
                                 **kw)
    n_or = 2 if c["mirror"] else 1
    assert got[0].shape == (n_or, c["n_gap_pad"], c["rows"].size)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy().view(np.uint32),
                                      np.asarray(b))
    # the pad rows are zero, and so is every word of an empty part
    assert not got[0][:, case[1]:].any() and not got[1][:, -(-case[2]
                                                           // 32):].any()


@pytest.mark.parametrize("case", testing.SPLIT_EDGE_CASES,
                         ids=[c[0] for c in testing.SPLIT_EDGE_CASES])
def test_k5_edge_shapes_equal_jax(case):
    rng = np.random.default_rng(sum(map(ord, case[0])))
    t_gap, q_gap, t_he, q_he = testing.split_edge_case(rng, case)
    got = tss.shape_score_pairs_split(*(convert.as_tensor(a, CPU) for a in
                                        (t_gap, q_gap, t_he, q_he)))
    want = jss.shape_score_pairs_split_raw(t_gap, q_gap, t_he, q_he)
    for a, b in zip(got, want):
        assert a.shape == (case[2], case[1])
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if case[3] == "zero":
        assert not any(x.any() for x in got)
