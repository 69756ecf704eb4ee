"""K3's least time, worked by hand for one fixed shape."""

import numpy as np

from cdsbench import reference as R, roofline


def test_k3_least_time_by_hand():
    # 8 masks of 8,000 query pixels, 9 shifts x 2 orientations, 4,096
    # columns, 400,000 distinct target pixels read
    n_bytes, ops = roofline.k3_work([8000] * 8, 18, 400_000, 4096)
    assert ops == 8 * 8000 * 18 * 4096 * 3 == 14_155_776_000
    assert n_bytes == 400_000 * 4096 * 3 + 8 * 4096 * 5 == 4_915_363_840
    b = roofline.bound(n_bytes, ops)
    # bytes: 4.91536384e9 / 3.35e12 = 1.46727e-3 s; operations:
    # 1.4155776e10 / (64 * 132 * 1.98e9 = 1.6727e13) = 8.4630e-4 s
    assert b["bound_by"] == "bytes"
    assert abs(b["seconds"] - 1.467272e-3) < 1e-9


def test_distinct_rows_of_a_query():
    mask = np.zeros((8, 10, 3), np.uint8)
    mask[4, 5] = (200, 30, 10)
    q = R.Query(mask, 20, None, 2, True)
    # 9 shifted positions of one pixel, each mirrored: x 3, 5, 7 mirror
    # to 6, 4, 2 in a width of 10
    assert q.size == 1
    assert q.rows().size == 18
