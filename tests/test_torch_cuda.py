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


def _shape_inputs(rng, device, n_or=2, sg=700, n_words=37, t=300):
    """K5 inputs at small shapes, with edge words (grad 0xFFFF, slice
    256, slice gaps 79 and 80) and zero pad rows."""
    z = rng.integers(0, 257, (n_or, sg, t))
    z[:, 0], z[:, 1], z[:, 2] = 179, 180, 256
    grad = rng.integers(0, 1 << 16, (n_or, sg, t))
    grad[:, :, 0] = 0xFFFF
    q = rng.integers(0, 257, (n_or, sg)) | (rng.integers(0, 4, (n_or, sg))
                                            << 9)
    q[:, :3] = 100 | (3 << 9)
    q[:, -5:] = 0
    t_gap = ((z << 16) | grad).astype(np.uint32)
    t_he = rng.integers(0, 1 << 32, (n_or, n_words, t), dtype=np.uint64) \
        .astype(np.uint32)
    q_he = rng.integers(0, 1 << 32, (n_or, n_words), dtype=np.uint64) \
        .astype(np.uint32)
    return [convert.as_tensor(a, device) for a in
            (t_gap, q.astype(np.int32), t_he, q_he)]


def _store_fields(rng, device, n_px=1500, n_r=70):
    """Random pixel-major store fields [n_px, R] (uint16 bits as int16)."""
    zsl = torch.from_numpy(rng.integers(0, 257, (n_px, n_r))
                           .astype(np.int16)).to(device)
    grad = torch.from_numpy(rng.integers(0, 1 << 16, (n_px, n_r))
                            .astype(np.uint16).view(np.int16)).to(device)
    tfg = torch.from_numpy(rng.integers(0, 256, (-(-n_px // 8), n_r))
                           .astype(np.uint8)).to(device)
    return zsl, grad, tfg


@pytest.mark.cuda
def test_cuda_shape_kernels_equal_plain_versions(cuda_device):
    """K5, K6 and K7 against their plain versions on the card (small
    shapes; chip_smoke.py repeats this at the production shapes)."""
    from colormipsearch_tpu_torch.ops import shape_score as tss

    rng = np.random.default_rng(5)
    for n_or in (1, 2):
        args = _shape_inputs(rng, cuda_device, n_or=n_or)
        for a, b in zip(tss.shape_score_pairs_split(*args),
                        tss.shape_score_pairs_split_plain(*args)):
            assert torch.equal(a, b)
    fields = _store_fields(rng, cuda_device)
    n_px, n_r = fields[0].shape
    for mirror in (True, False):
        n_or = 2 if mirror else 1
        pos_gap = rng.choice(n_px, 90, replace=False).astype(np.int32)
        pos_he = rng.choice(n_px, 150, replace=False).astype(np.int32)
        g_pos = np.concatenate([pos_gap] * n_or)
        h_pos = np.concatenate([pos_he] * n_or)
        keep = rng.integers(0, 2, h_pos.size).astype(bool)
        kw = dict(n_gap_pad=128, n_he_words=8)
        tp = tss.tile_positions(pos_gap, g_pos, h_pos, keep, mirror=mirror,
                                device=cuda_device, **kw)
        rows = torch.tensor(rng.integers(0, n_r, 200), dtype=torch.int32,
                            device=cuda_device)
        for a, b in zip(tss.shape_tile_device(fields, rows, tp, **kw),
                        tss.shape_tile_device_plain(fields, rows, tp, **kw)):
            assert torch.equal(a, b)
    for dtype, hi in ((np.uint16, 1 << 16), (np.uint8, 256)):
        field = rng.integers(0, hi, (70, 1003)).astype(dtype)
        got = tss.upload_pixel_major(field, cuda_device, chunk_bytes=4096)
        want = tss.upload_pixel_major(field, torch.device("cpu"))
        assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_cuda_shape_kernels_count_and_refuse(cuda_device):
    """One launch per wrapper call on CUDA tensors; wrong dtypes or
    shapes raise before anything launches."""
    from colormipsearch_tpu_torch.ops import shape_score as tss

    rng = np.random.default_rng(6)
    kbuild.reset_launches()
    args = _shape_inputs(rng, cuda_device)
    tss.shape_score_pairs_split(*args)
    assert kbuild.launches["shape_score_pairs_split"] == 1
    with pytest.raises(TypeError):
        tss.shape_score_pairs_split(args[0].long(), *args[1:])
    with pytest.raises(ValueError):
        tss.shape_score_pairs_split(args[0], args[1][:, :-1], *args[2:])
    assert kbuild.launches["shape_score_pairs_split"] == 1

    fields = _store_fields(rng, cuda_device)
    pos = np.arange(10, dtype=np.int32)
    tp = tss.tile_positions(pos, pos, pos, None, n_gap_pad=16,
                            n_he_words=1, mirror=False, device=cuda_device)
    rows = torch.arange(5, dtype=torch.int32, device=cuda_device)
    tss.shape_tile_device(fields, rows, tp, n_gap_pad=16, n_he_words=1)
    assert kbuild.launches["shape_tile_device"] == 1
    with pytest.raises(TypeError):
        tss.shape_tile_device(fields, rows.long(), tp, n_gap_pad=16,
                              n_he_words=1)
    with pytest.raises(ValueError):  # a store row past the fields
        tss.shape_tile_device(fields, rows + 1000, tp, n_gap_pad=16,
                              n_he_words=1)
    assert kbuild.launches["shape_tile_device"] == 1

    buf = torch.zeros((100, 7), dtype=torch.int16, device=cuda_device)
    chunk = torch.ones((7, 30), dtype=torch.int16, device=cuda_device)
    tss.upload_pixel_major_chunk(buf, chunk, 70)
    assert kbuild.launches["upload_pixel_major"] == 1
    with pytest.raises(ValueError):
        tss.upload_pixel_major_chunk(buf, chunk, 71)
    with pytest.raises(TypeError):
        tss.upload_pixel_major_chunk(buf, chunk.to(torch.uint8), 0)
    assert kbuild.launches["upload_pixel_major"] == 1
