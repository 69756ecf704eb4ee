"""K4 and K7 at their edge shapes against the JAX package.

On the CPU the wrappers run their plain versions; the inputs are
testing.TOPK_EDGE_CASES and testing.PIXEL_MAJOR_EDGE_CASES, the shapes at
which chip_smoke.py and tests/test_torch_cuda.py hold the kernels to
those plain versions on the card. Integer outputs: exact equality.

K4's JAX counterpart is the tail of score_query_batch_union_keys_topk
(and of the mesh's _finish_batched_step): jax.lax.top_k of the scores,
then the mirrored flags (and pair flags) taken at the chosen columns.
K7's is _upload_pixel_major, cut into chunks of the case's n by its
chunk_bytes, the last chunk ragged.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colormipsearch_tpu.ops import shape_score as jss
from colormipsearch_tpu_torch import testing
from colormipsearch_tpu_torch.ops import pixel_match as tpm
from colormipsearch_tpu_torch.ops import shape_score as tss

torch.set_num_threads(2)
CPU = torch.device("cpu")


@pytest.mark.parametrize("case", testing.TOPK_EDGE_CASES,
                         ids=[c[0] for c in testing.TOPK_EDGE_CASES])
def test_k4_edge_shapes_equal_jax(case):
    rng = np.random.default_rng(sum(map(ord, case[0])))
    best, mirrored, flags, k = testing.topk_edge_inputs(rng, case, CPU)
    got = tpm.union_keys_topk(best, mirrored, k, flags)
    scores, idx = jax.lax.top_k(jnp.asarray(best.numpy()), k)
    want = [scores, idx, jnp.take_along_axis(jnp.asarray(mirrored.numpy()),
                                             idx, axis=1)]
    if flags is not None:
        want.append(jnp.take_along_axis(jnp.asarray(flags.numpy()), idx,
                                        axis=1))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == (case[1], k)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if case[4] == "equal" and case[1]:
        # every score ties: the lowest columns, in order
        np.testing.assert_array_equal(got[1].numpy(),
                                      np.tile(np.arange(k), (case[1], 1)))


@pytest.mark.parametrize("case", testing.PIXEL_MAJOR_EDGE_CASES,
                         ids=[c[0] for c in testing.PIXEL_MAJOR_EDGE_CASES])
def test_k7_edge_shapes_equal_jax(case):
    rng = np.random.default_rng(sum(map(ord, case[0])))
    c = testing.pixel_major_edge_case(rng, case)
    field, n, p0 = c["field"], c["n"], c["p0"]
    want = np.asarray(jss._upload_pixel_major(field, c["chunk_bytes"]))
    got = tss.upload_pixel_major(field, CPU, chunk_bytes=c["chunk_bytes"])
    np.testing.assert_array_equal(got.numpy().view(field.dtype), want)
    # the one chunk of the case into a buffer of another value: only its
    # rows change
    view = np.int16 if field.dtype == np.uint16 else np.uint8
    buf = torch.full((field.shape[1], field.shape[0]), 3,
                     dtype=torch.int16 if view == np.int16 else torch.uint8)
    chunk = torch.from_numpy(np.ascontiguousarray(
        field[:, p0:p0 + n]).view(view))
    tss.upload_pixel_major_chunk(buf, chunk, p0)
    out = buf.numpy().view(field.dtype)
    np.testing.assert_array_equal(out[p0:p0 + n], want[p0:p0 + n])
    assert (np.delete(out, np.s_[p0:p0 + n], axis=0) == 3).all()
