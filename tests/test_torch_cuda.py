"""The CUDA kernels against their plain PyTorch versions on the card.

Marked `cuda`: without a GPU every test here skips (the kernels have no
CPU mode; their plain versions are held to the JAX package in
test_torch_kernels.py). This file imports no jax, so it also runs on the
GPU hosts, which have none:

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest

(--noconftest: tests/conftest.py imports jax.)
"""

import numpy as np
import pytest
import torch

from colormipsearch_tpu_torch import convert, testing
from colormipsearch_tpu_torch.kernels import build as kbuild
from colormipsearch_tpu_torch.oracle.pixel import shift_offsets
from colormipsearch_tpu_torch.ops import common as tcommon
from colormipsearch_tpu_torch.ops import pixel_match as tpm


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU "
                    "mode (their plain versions are tested above)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_kernels_equal_plain_versions(cuda_device):
    """Each kernel against its plain version on the card (small shapes;
    chip_smoke.py repeats this at the production shapes)."""
    rng = np.random.default_rng(3)
    h, w, t_pad = 30, 40, 64
    stack = np.stack([testing.scattered_pixels(rng, h, w, 200)
                      for _ in range(37)])
    lut = tcommon.rank_lut_tensor(cuda_device)
    pos, rgb, cum = tcommon.coo_foreground(stack, 20, t_pad)
    k1 = [torch.from_numpy(a).to(cuda_device) for a in (pos, rgb, cum)]
    planes = tcommon.scatter_key_planes(*k1, lut, n_px=h * w, t_pad=t_pad)
    assert torch.equal(planes, tcommon.scatter_key_planes_plain(
        *k1, lut, n_px=h * w, t_pad=t_pad))
    queries = [testing.scattered_pixels(rng, h, w, n) for n in (250, 90)]
    plans = [tpm.build_full_union_key_plan(
        q, 20, mirror=True, xy_shift=2, pix_color_fluctuation=1.0,
        light=True) for q in queries]
    u_pos, mu_pos, q_pos, key_list, u2 = tpm.stack_union_pos_args(plans,
                                                                   h * w)
    k2 = [convert.as_tensor(a, cuda_device) for a in (u_pos, q_pos,
                                                       key_list)]
    tabs = convert.interval_tables(tpm.interval_table_arrays(0.01),
                                   cuda_device)
    kw = dict(offsets=tuple(shift_offsets(2)), w=w, h=h)
    lo, sp = tpm.expand_union_tables_from_pos(*k2, *tabs, **kw)
    for a, b in zip((lo, sp), tpm.expand_union_tables_from_pos_plain(
            *k2, *tabs, **kw)):
        assert torch.equal(a, b)
    k3 = (planes, k2[0], convert.as_tensor(mu_pos, cuda_device), lo, sp,
          u2)
    best, mirrored = tpm.score_query_batch_union_keys(*k3)
    for a, b in zip((best, mirrored),
                    tpm.score_query_batch_union_keys_plain(*k3)):
        assert torch.equal(a, b)
    for a, b in zip(tpm.union_keys_topk(best, mirrored, 16),
                    tpm.union_keys_topk_plain(best, mirrored, 16)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_kernels_count_their_launches(cuda_device):
    """A launch counts once per wrapper call on CUDA tensors; wrong
    inputs raise before anything launches."""
    kbuild.reset_launches()
    best = torch.randint(0, 5, (2, 100), dtype=torch.int32,
                         device=cuda_device)
    mirrored = best > 2
    tpm.union_keys_topk(best, mirrored, 10)
    assert kbuild.launches["union_keys_topk"] == 1
    with pytest.raises(ValueError):
        tpm.union_keys_topk(best, mirrored, 101)
    with pytest.raises(ValueError):
        tpm.union_keys_topk(torch.zeros((1, 20000), dtype=torch.int32,
                                        device=cuda_device),
                            torch.zeros((1, 20000), dtype=torch.bool,
                                        device=cuda_device), 5)
    assert kbuild.launches["union_keys_topk"] == 1
