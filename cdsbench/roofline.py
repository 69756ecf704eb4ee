"""The card's peaks and K3's least time, counted from the problem.

Frozen yardstick code. The peaks and the bound are copied from
``chip_smoke.py:419-428`` (``HBM_BYTES_PER_S``, ``INT_OPS_PER_S``) and
``chip_smoke.py:569`` (``bound``): NVIDIA's H100 SXM data sheet gives
3.35 TB/s of HBM; 132 SMs at up to 1.98 GHz issue 64 int32 lane
operations a clock each, 16.7e12 integer operations a second.

K3's work is counted from the search, not from the port's lane tables,
so a redesign of the kernel reads the same least time for the same
masks and columns:

* operations: every query pixel is tested against one target pixel per
  shift variant and orientation and target column; a test is
  ``OPS_PER_PIXEL_TEST`` integer operations (a subtraction and an
  unsigned compare against the pixel's accepted window, and an add into
  the variant's count);
* bytes: every target pixel that some variant of some mask of the
  launch reads, once a column, at ``BYTES_PER_TARGET_PIXEL`` (its RGB,
  the width of the input CDM), plus one score (4 bytes) and one mirrored
  flag (1 byte) written a mask and column.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 64 * 132 * 1.98e9
OPS_PER_PIXEL_TEST = 3
BYTES_PER_TARGET_PIXEL = 3
BYTES_PER_RESULT = 4 + 1


def bound(n_bytes: float, int_ops: float) -> dict:
    """The least time the card could take, and what sets it."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = int_ops / INT_OPS_PER_S
    return {"seconds": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def k3_work(query_pixels: list, tests_per_pixel: int, distinct_rows: int,
            columns: int) -> tuple:
    """(bytes, integer operations) of one K3 launch: the masks' query
    pixel counts, the shift variants times orientations a pixel is
    tested in, the distinct target positions the launch reads and the
    target columns."""
    ops = sum(query_pixels) * tests_per_pixel * columns * OPS_PER_PIXEL_TEST
    n_bytes = (distinct_rows * columns * BYTES_PER_TARGET_PIXEL
               + len(query_pixels) * columns * BYTES_PER_RESULT)
    return n_bytes, ops
