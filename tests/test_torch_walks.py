"""The redesigned union and banded walks' decompositions against the JAX
package, at the shapes where a decomposition can go wrong.

K3, K13 and row 14 now split the union over the grid: each block counts
one chunk of it, the counts are summed into a [B, 2, S, L, T] scratch,
and only then is the max over lanes and sets taken. Their plain walk
(ops/pixel_match._union_walk_plain) takes the same decomposition and must
equal the JAX score_query_batch_union_keys at any chunk size: a union that is
not a multiple of the chunk, the slot-2 prefix u2 inside a chunk and on
its edges, 17 and 25 lanes (xyShift 4 and 6, more than one lane group
of 9), no mirror
sets, a column count that is not a multiple of 256, one mask.

K9 and K11 now take four columns a thread: the plain versions hold them
to JAX at a column count that is not a multiple of the columns per
thread and a query that is not a multiple of the chunk. The kernels
themselves are compared with the same plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 2).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from colormipsearch_tpu.ops import common as jcommon
from colormipsearch_tpu.ops import pixel_match as jpm
from colormipsearch_tpu_torch import convert, testing
from colormipsearch_tpu_torch.ops import common as tcommon
from colormipsearch_tpu_torch.ops import pixel_match as tpm

torch.set_num_threads(2)
CPU = torch.device("cpu")


def _union_inputs(seed, *, xy_shift=2, mirror=True, batch=3, n_cols=300,
                  h=40, w=50):
    rng = np.random.default_rng(seed)
    queries = [testing.scattered_pixels(rng, h, w, 160)
               for _ in range(batch)]
    targets = [testing.scattered_pixels(rng, h, w, 150)
               for _ in range(n_cols - 1)] + [queries[0]]
    planes = np.asarray(jcommon.pack_target_planes_keys(
        jnp.asarray(np.stack(targets)), 20, jcommon.rank_lut_device()))
    plans = [jpm.build_full_union_key_plan(
        q, 20, mirror=mirror, xy_shift=xy_shift, pix_color_fluctuation=1.0)
        for q in queries]
    *arrs, u2 = jpm.stack_union_plan_args(plans, h * w)
    return planes, arrs, u2


def _jax_union(planes, arrs, u2):
    jb, jm, _ = jpm.score_query_batch_union_keys(
        jnp.asarray(planes), *[jnp.asarray(a) for a in arrs], u2=u2)
    return np.asarray(jb), np.asarray(jm)


def _chunked(planes, arrs, u2, chunk):
    p = convert.key_planes(planes, CPU)
    u_pos, mu_pos, lo, sp = convert.stacked_args(arrs, CPU)
    best, mirrored = tpm._union_walk_plain(
        lambda rows: p.index_select(0, rows).long(), p.shape[1], CPU, u_pos,
        mu_pos, lo, sp, u2, chunk)
    return best.numpy(), mirrored.numpy()


# (case, chunk): the union pads to 1,024 elements here, so 100, 7, 13, 5
# and 37 leave a ragged last chunk; a chunk given as "u2", "u2+1", "u2-1"
# or "u2/2" is taken relative to the batch's slot-2 prefix, so that u2
# falls on a chunk's first element, inside a chunk, and on its last
@pytest.mark.parametrize("case, chunk", [
    ("segmented", 128), ("segmented", 100), ("segmented", 7),
    ("segmented", "u2"),
    ("segmented", "u2+1"), ("segmented", "u2-1"), ("segmented", "u2/2"),
    ("xy_shift_4", 128), ("xy_shift_6", 128), ("xy_shift_6", 13),
    ("no_mirror", 128), ("no_mirror", 5),
    ("batch_1", 128), ("batch_1", 1000000),
    ("unsegmented", 37),
])
def test_chunked_union_walk_equals_jax(case, chunk):
    kw = dict(xy_shift={"xy_shift_4": 4, "xy_shift_6": 6}.get(case, 2),
              mirror=case != "no_mirror", batch=1 if case == "batch_1" else 3)
    planes, arrs, u2 = _union_inputs(71, **kw)
    n_u = arrs[0].shape[2]
    assert planes.shape[1] % 256
    if case.startswith("xy_shift"):
        assert arrs[2].shape[1] == {"xy_shift_4": 17, "xy_shift_6": 25}[case]
    if case == "no_mirror":
        assert arrs[1].shape[1] == 0
    if case == "unsegmented":
        u2 = None
    else:
        assert arrs[2].shape[2] == 2 and 0 < u2 < n_u
    if isinstance(chunk, str):
        chunk = {"u2": u2, "u2+1": u2 + 1, "u2-1": u2 - 1,
                 "u2/2": max(1, u2 // 2)}[chunk]
    want = _jax_union(planes, arrs, u2)
    got = _chunked(planes, arrs, u2, chunk)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert want[0].max() > 0
    # and the wrapper (the plain walk at its own chunk on the CPU) agrees
    wrapped = tpm.score_query_batch_union_keys(
        convert.key_planes(planes, CPU), *convert.stacked_args(arrs, CPU),
        u2)
    np.testing.assert_array_equal(wrapped[0].numpy(), want[0])


def test_chunked_qkey_walk_equals_the_wrapper():
    """Row 14's segmented walk with the prefix at the whole union (u2 =
    U), taken in chunks of any size, equals the plain walk at its default
    chunk."""
    planes, arrs, _ = _union_inputs(72, batch=2)
    u_pos, mu_pos, lo, sp = convert.stacked_args(arrs, CPU)
    p = convert.key_planes(planes, CPU)
    n_u = u_pos.shape[2]

    def gather(rows):
        return p.index_select(0, rows).long()

    want = tpm._union_walk_plain(gather, p.shape[1], CPU, u_pos, mu_pos, lo,
                                 sp, n_u, 4096, seg=True)
    for chunk in (9, 128, n_u):
        got = tpm._union_walk_plain(gather, p.shape[1], CPU, u_pos, mu_pos,
                                    lo, sp, n_u, chunk, seg=True)
        torch.testing.assert_close(got, want, rtol=0, atol=0)


# --- K9 / K11 at ragged shapes --------------------------------------------


@pytest.mark.parametrize("n_cols, q_pad", [(13, 300), (6, 257), (1, 511)])
@pytest.mark.parametrize("flu", [1.0, 0.37])
def test_banded_walks_at_ragged_shapes_equal_jax(n_cols, q_pad, flu):
    """K9's and K11's plain versions equal the JAX score_query_batch,
    flags included, at a column count that is not a multiple of the
    columns a thread takes and a padded query that is not a multiple of
    the kernel's query chunk (256)."""
    rng = np.random.default_rng(n_cols + q_pad)
    h, w = 30, 40
    stack = np.stack([testing.scattered_pixels(rng, h, w, 250)
                      for _ in range(n_cols)])
    queries = [testing.scattered_pixels(rng, h, w, 200), stack[0].copy()]
    planes = np.asarray(jcommon.pack_target_planes(jnp.asarray(stack),
                                                   data_threshold=20))
    plans = [jpm.build_query_plan(q, 20, mirror=True, xy_shift=2,
                                  pix_color_fluctuation=flu, pad_to=q_pad)
             for q in queries]
    args = [np.stack([getattr(p, f) for p in plans])
            for f in ("positions", "q_cls", "q_s", "q_p")]
    assert args[0].shape[2] == q_pad
    kw = dict(ztol_num=plans[0].ztol_num, ztol_den=plans[0].ztol_den,
              n_straight=plans[0].n_straight)
    want = [np.asarray(x) for x in jpm.score_query_batch(
        jnp.asarray(planes), *(jnp.asarray(a) for a in args),
        target_threshold=-1, **kw)]
    t_args = [convert.as_tensor(a, CPU) for a in args]
    got = tpm.score_query_batch(convert.as_tensor(planes, CPU), *t_args,
                                target_threshold=-1, **kw)
    sp, c8 = tcommon.split_planes_from_packed(convert.as_tensor(planes, CPU))
    got11 = tpm.score_query_batch_split(sp, c8, *t_args, **kw)
    for g, g11, wnt in zip(got, got11, want):
        np.testing.assert_array_equal(g.numpy(), wnt)
        np.testing.assert_array_equal(g11.numpy(), wnt)
    assert want[0].max() > 0


@pytest.mark.parametrize("case", testing.UNION_EDGE_CASES,
                         ids=[c[0] for c in testing.UNION_EDGE_CASES])
def test_union_edge_cases_chunked_equal_one_pass(case):
    """The edge-shape batches that tests/test_torch_cuda.py and
    chip_smoke.py give the kernels: K3's and row 14's plain walks at
    their default chunk equal the walk at the case's chunk (128 where the
    kernel chooses), and both wrappers run on the CPU."""
    rng = np.random.default_rng(81)
    h, w = 60, 80
    stack = np.stack([testing.scattered_pixels(rng, h, w, 400)
                      for _ in range(37)])
    planes = tcommon.pack_target_planes_keys(
        torch.from_numpy(stack), 20, tcommon.rank_lut_tensor(CPU))
    batch = testing.union_edge_batch(rng, case, h, w, CPU)
    chunk = batch["chunk"] or 128

    def gather(rows):
        return planes.index_select(0, rows).long()

    args = batch["union"]
    want = tpm.score_query_batch_union_keys(planes, *args)
    got = tpm._union_walk_plain(gather, planes.shape[1], CPU, *args, chunk)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert int(want[0].max()) > 0
    u_pos, mu_pos, qidx, key_list, tab_lo, tab_span, u2 = batch["qkeys"]
    want14 = tpm.score_query_batch_union_qkeys(planes, *batch["qkeys"])
    lo, sp = tpm.expand_union_tables_plain(qidx, key_list, tab_lo, tab_span)
    got14 = tpm._union_walk_plain(gather, planes.shape[1], CPU, u_pos,
                                  mu_pos, lo, sp, u2, chunk, seg=True)
    torch.testing.assert_close(got14, want14, rtol=0, atol=0)
