"""K1 and K2 at their edge shapes against the JAX package, and the
orders their kernels rely on.

On the CPU the wrappers run their plain versions; the inputs are
testing.SCATTER_EDGE_CASES and testing.EXPAND_EDGE_CASES, the shapes at
which chip_smoke.py and tests/test_torch_cuda.py hold the kernels to
those plain versions on the card. Integer outputs: exact equality.

K1's kernel walks each target's COO segment with one cursor, so it needs
`pos` to rise within each target, as coo_foreground returns it from the
native select and from np.nonzero. K2's kernel finds a pixel's row by
searching q_pos, so it needs each mask's q_pos to rise strictly with its
pads (= P) last, as stack_union_pos_args builds it, segmented plans
(u2 >= 0) included. Both orders are pinned here.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from colormipsearch_tpu.ops import common as jcommon
from colormipsearch_tpu.ops import pixel_match as jpm
from colormipsearch_tpu_torch import testing
from colormipsearch_tpu_torch.io import native_decoder as tnative
from colormipsearch_tpu_torch.ops import common as tcommon
from colormipsearch_tpu_torch.ops import pixel_match as tpm

torch.set_num_threads(2)
CPU = torch.device("cpu")


@pytest.mark.parametrize("case", testing.SCATTER_EDGE_CASES,
                         ids=[c[0] for c in testing.SCATTER_EDGE_CASES])
def test_k1_edge_shapes_equal_jax(case):
    rng = np.random.default_rng(sum(map(ord, case[0])))
    (pos, rgb, cum, lut), kw = testing.scatter_edge_inputs(rng, case, 23,
                                                           37, CPU)
    got = tcommon.scatter_key_planes(pos, rgb, cum, lut, **kw).numpy()
    n_px, t_pad = kw["n_px"], kw["t_pad"]
    want = np.asarray(jcommon._scatter_key_chunk(
        jnp.zeros((n_px + 1, t_pad), jnp.int32), jnp.asarray(pos.numpy()),
        jnp.asarray(rgb.numpy()), jnp.asarray(cum.numpy()), 0,
        jcommon.rank_lut_device(), t_pad=t_pad, n_px=n_px))
    np.testing.assert_array_equal(got, want)
    assert (got[-1] == 0).all()
    n = pos.shape[0]
    if case[3] == "black":
        assert n == 0 and not got.any()
    if case[3] == "full":
        assert (np.diff(cum.numpy()) == n_px).any()


@pytest.mark.parametrize("case", testing.EXPAND_EDGE_CASES,
                         ids=[c[0] for c in testing.EXPAND_EDGE_CASES])
def test_k2_edge_shapes_equal_jax(case):
    rng = np.random.default_rng(sum(map(ord, case[0])))
    args, kw = testing.expand_edge_inputs(rng, case, CPU)
    got = tpm.expand_union_tables_from_pos(*args, **kw)
    want = jpm.expand_union_tables_from_pos(
        *[jnp.asarray(a.numpy()) for a in args[:3]],
        *[jnp.asarray(a.numpy().view(np.uint32)) for a in args[3:]], **kw)
    for g, wnt in zip(got, want):
        np.testing.assert_array_equal(g.numpy().view(np.uint32),
                                      np.asarray(wnt))
    lo = got[0].numpy().view(np.uint32)
    assert lo.shape == (case[3], len(kw["offsets"]), 2, case[6])
    if case[7] == "far":
        # every src leaves the image: every lane takes the inactive key
        tab_lo = args[3].numpy().view(np.uint32)
        assert (lo[:, :, 0] == tab_lo[0, 0]).all()


@pytest.mark.parametrize("path", ["native", "nonzero"])
def test_coo_foreground_pos_rises_within_each_target(path, monkeypatch):
    """K1's precondition, on both of coo_foreground's paths: the
    elements come target-major and, within each target, with strictly
    rising pos; cum counts them."""
    rng = np.random.default_rng(5)
    stack = np.stack([testing.scattered_pixels(rng, 40, 50, 300)
                      for _ in range(9)])
    stack[4] = 0
    stack[6] = rng.integers(21, 256, (40, 50, 3))
    if path == "native":
        if not tnative.available():
            pytest.skip("the native decoder did not build here")
    else:
        monkeypatch.setattr(tnative, "coo_select", lambda *a: None)
    pos, rgb, cum = tcommon.coo_foreground(stack, 20, 12)
    assert cum.shape == (12,) and cum[-1] == pos.size
    starts = np.concatenate([[0], cum[:-1]])
    for t in range(12):
        seg = pos[starts[t]:cum[t]]
        assert (np.diff(seg) > 0).all(), t
        want = np.flatnonzero(stack[t].max(-1) > 20) if t < 9 else []
        np.testing.assert_array_equal(seg, want)
        np.testing.assert_array_equal(
            rgb[starts[t]:cum[t]],
            stack[t].reshape(-1, 3)[want] if t < 9 else rgb[:0])


@pytest.mark.parametrize("xy_shift,segmented", [(2, False), (2, True),
                                                 (4, True), (0, False)])
def test_stack_union_pos_args_q_pos_rises(xy_shift, segmented):
    """K2's precondition: every mask's q_pos rises strictly and its pads
    (= P) come last, for plans with and without the slot-2 segmentation
    (u2 >= 0 at 0.37%, where a second interval window occurs)."""
    rng = np.random.default_rng(6 + xy_shift)
    h, w = 40, 50
    queries = [testing.scattered_pixels(rng, h, w, n)
               for n in (300, 40, 150)]
    flu = 0.37 if segmented else 1.0
    plans = [tpm.build_full_union_key_plan(
        q, 20, mirror=True, xy_shift=xy_shift, pix_color_fluctuation=flu,
        light=True) for q in queries]
    if segmented:
        assert any(p.u2 >= 0 for p in plans)
    q_pos = tpm.stack_union_pos_args(plans, h * w)[2]
    for b, q in enumerate(queries):
        real = np.flatnonzero(q.max(-1) > 20)
        np.testing.assert_array_equal(q_pos[b, :real.size], real)
        assert (np.diff(q_pos[b, :real.size]) > 0).all()
        assert (q_pos[b, real.size:] == h * w).all()
