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


@pytest.mark.cuda
def test_cuda_classic_kernels_equal_plain_versions(cuda_device):
    """K8 (both modes), K9 (the exact and the banded same-class branch,
    folded and unfolded threshold, with and without mirror) and K10
    against their plain versions on the card, flags included (small
    shapes; chip_smoke.py repeats this at the production shapes)."""
    rng = np.random.default_rng(7)
    h, w, t, t_pad = 30, 40, 37, 64
    stack = np.stack([testing.scattered_pixels(rng, h, w, 300)
                      for _ in range(t)])
    rgb = torch.from_numpy(stack).to(cuda_device)
    lut = tcommon.rank_lut_tensor(cuda_device)
    for thr in (None, 20):
        planes = tcommon.pack_target_planes(rgb, thr, t_pad=t_pad)
        assert torch.equal(planes, tcommon.pack_target_planes_plain(
            rgb, thr, t_pad=t_pad))
    keys = tcommon.pack_target_planes_keys(rgb, 20, lut, t_pad=t_pad)
    assert torch.equal(keys, tcommon.pack_target_planes_keys_plain(
        rgb, 20, lut, t_pad=t_pad))
    queries = [testing.scattered_pixels(rng, h, w, n) for n in (250, 90)]
    queries.append(stack[5].copy())
    for flu, xy, mirror in ((1.0, 2, True), (0.37, 2, True),
                            (2.0, 4, False)):
        plans = [tpm.build_query_plan(q, 20, mirror=mirror, xy_shift=xy,
                                      pix_color_fluctuation=flu, pad_to=640)
                 for q in queries]
        args = [convert.as_tensor(np.stack([getattr(p, f) for p in plans]),
                                  cuda_device)
                for f in ("positions", "q_cls", "q_s", "q_p")]
        kw = dict(ztol_num=plans[0].ztol_num, ztol_den=plans[0].ztol_den,
                  n_straight=plans[0].n_straight)
        for thr, pl in ((-1, tcommon.pack_target_planes(rgb, 20,
                                                        t_pad=t_pad)),
                        (20, tcommon.pack_target_planes(rgb, None,
                                                        t_pad=t_pad))):
            got = tpm.score_query_batch(pl, *args, target_threshold=thr,
                                        **kw)
            want = tpm.score_query_batch_plain(pl, *args,
                                               target_threshold=thr, **kw)
            for a, b in zip(got, want):
                assert torch.equal(a, b), (flu, xy, mirror, thr)
            assert int(got[0].max()) > 0
        kplans = [tpm.key_plan_from_query_plan(p, h * w, flu)
                  for p in plans]
        kargs = [convert.as_tensor(np.stack([getattr(p, f) for p in kplans]),
                                   cuda_device)
                 for f in ("positions", "lo", "span")]
        got = tpm.score_query_batch_keys(keys, *kargs,
                                         n_straight=kw["n_straight"])
        want = tpm.score_query_batch_keys_plain(keys, *kargs,
                                                n_straight=kw["n_straight"])
        for a, b in zip(got, want):
            assert torch.equal(a, b), (flu, xy, mirror)


@pytest.mark.cuda
def test_cuda_classic_kernels_count_and_refuse(cuda_device):
    """One launch per wrapper call on CUDA tensors; wrong inputs raise
    before anything launches."""
    kbuild.reset_launches()
    rgb = torch.zeros((3, 10, 12, 3), dtype=torch.uint8, device=cuda_device)
    lut = tcommon.rank_lut_tensor(cuda_device)
    planes = tcommon.pack_target_planes(rgb, 20, t_pad=32)
    keys = tcommon.pack_target_planes_keys(rgb, 20, lut, t_pad=32)
    with pytest.raises(ValueError):
        tcommon.pack_target_planes(rgb, 20, t_pad=2)
    pos = torch.zeros((2, 3, 16), dtype=torch.int32, device=cuda_device)
    q = torch.ones((2, 16), dtype=torch.int32, device=cuda_device)
    kw = dict(target_threshold=-1, ztol_num=1, ztol_den=100)
    tpm.score_query_batch(planes, pos, q, q, q, n_straight=3, **kw)
    with pytest.raises(ValueError):
        tpm.score_query_batch(planes, pos, q, q, q, n_straight=4, **kw)
    lo = torch.zeros((2, 3, 16), dtype=torch.int32, device=cuda_device)
    tpm.score_query_batch_keys(keys, pos, lo, lo, n_straight=1)
    with pytest.raises(TypeError):
        tpm.score_query_batch_keys(keys, pos.long(), lo, lo, n_straight=1)
    assert {k: kbuild.launches[k] for k in (
        "pack_target_planes", "pack_target_planes_keys",
        "score_query_batch", "score_query_batch_keys")} == dict.fromkeys(
        ("pack_target_planes", "pack_target_planes_keys",
         "score_query_batch", "score_query_batch_keys"), 1)


@pytest.mark.cuda
def test_cuda_banded_kernel_band_edges(cuda_device):
    """K9 against its plain version where the f32 rounding decides: each
    mask repeats one query pixel over every achievable target ratio of
    every class; the first, (BR, 2/11), meets (BG, 109/205) with |g|
    inside the 0.37% band only when g is rounded once, as XLA rounds it."""
    rng = np.random.default_rng(9)
    sv, pv = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    ok = (pv >= 1) & (sv < pv)
    t_s, t_p = sv[ok].astype(np.int64), pv[ok].astype(np.int64)
    cls = np.arange(1, 7)
    planes = convert.as_tensor(
        ((cls[None] << 24) | (t_p[:, None] << 16) | (t_s[:, None] << 8)
         | t_p[:, None]).astype(np.uint32), cuda_device)
    batch, n_q = 24, t_s.size
    q_p = np.r_[11, rng.integers(1, 256, batch - 1)]
    q_s = np.r_[2, np.minimum(rng.integers(0, 255, batch - 1), q_p[1:] - 1)]
    q_cls = np.r_[1, rng.integers(1, 7, batch - 1)]
    per_q = [convert.as_tensor(np.repeat(x[:, None], n_q, 1)
                               .astype(np.int32), cuda_device)
             for x in (q_cls, q_s, q_p)]
    pos = convert.as_tensor(np.tile(np.arange(n_q, dtype=np.int32),
                                    (batch, 1, 1)), cuda_device)
    sp, c8 = tcommon.split_planes_from_packed(planes)
    for num, den in ((1, 100), (37, 10000)):
        kw = dict(target_threshold=-1, ztol_num=num, ztol_den=den,
                  n_straight=1)
        got = tpm.score_query_batch(planes, pos, *per_q, **kw)
        want = tpm.score_query_batch_plain(planes, pos, *per_q, **kw)
        for a, b in zip(got, want):
            assert torch.equal(a, b), (num, den)
        assert int(got[2].sum()) > 0
        # K11 on the split pair of the same planes: K9's counts and flags
        del kw["target_threshold"]
        split = tpm.score_query_batch_split(sp, c8, pos, *per_q, **kw)
        for a, b, c in zip(split, tpm.score_query_batch_split_plain(
                sp, c8, pos, *per_q, **kw), got):
            assert torch.equal(a, b) and torch.equal(a, c), (num, den)


@pytest.mark.cuda
def test_cuda_split_kernels_equal_plain_versions(cuda_device):
    """K8's split mode, K12 in its three modes (the quad-vector and the
    one-element loops), K11 (exact and banded same-class branch, with and
    without mirror) and K13 (segmented and OR forms) against their plain
    versions on the card, and against the kernels they re-encode: K8's
    other modes, K9 and K3 (small shapes; chip_smoke.py repeats this at
    the production shapes)."""
    rng = np.random.default_rng(10)
    h, w, t, t_pad = 30, 40, 37, 64
    stack = np.stack([testing.scattered_pixels(rng, h, w, 300)
                      for _ in range(t)])
    rgb = torch.from_numpy(stack).to(cuda_device)
    lut = tcommon.rank_lut_tensor(cuda_device)
    for thr in (0, 20):
        pair = tcommon.pack_target_planes_split(rgb, thr, t_pad=t_pad)
        for a, b in zip(pair, tcommon.pack_target_planes_split_plain(
                rgb, thr, t_pad=t_pad)):
            assert torch.equal(a, b), thr
    planes = tcommon.pack_target_planes(rgb, 20, t_pad=t_pad)
    sp, c8 = tcommon.split_planes_from_packed(planes)
    assert torch.equal(sp, pair[0]) and torch.equal(c8, pair[1])
    keys = tcommon.key_planes_from_packed(planes, lut)
    assert torch.equal(keys, tcommon.pack_target_planes_keys(
        rgb, 20, lut, t_pad=t_pad))
    words = torch.from_numpy(rng.integers(0, 1 << 32, (37, 7),
                                          dtype=np.uint64)
                             .astype(np.uint32).view(np.int32))
    for src in (planes, keys, words.to(cuda_device)):  # 259 words: 1 a thread
        for fn, plain in (
                (tcommon.split_planes_from_packed,
                 tcommon.split_planes_from_packed_plain),
                (tpm.split_key_planes, tcommon.split_key_planes_plain),
                (lambda x: tcommon.key_planes_from_packed(x, lut),
                 lambda x: tcommon.key_planes_from_packed_plain(x, lut))):
            got, want = fn(src), plain(src)
            for a, b in zip(got if isinstance(got, tuple) else (got,),
                            want if isinstance(want, tuple) else (want,)):
                assert torch.equal(a, b), tuple(src.shape)

    queries = [testing.scattered_pixels(rng, h, w, n) for n in (250, 90)]
    queries.append(stack[5].copy())
    for flu, xy, mirror in ((1.0, 2, True), (0.37, 2, True),
                            (2.0, 4, False)):
        plans = [tpm.build_query_plan(q, 20, mirror=mirror, xy_shift=xy,
                                      pix_color_fluctuation=flu, pad_to=640)
                 for q in queries]
        args = [convert.as_tensor(np.stack([getattr(p, f) for p in plans]),
                                  cuda_device)
                for f in ("positions", "q_cls", "q_s", "q_p")]
        kw = dict(ztol_num=plans[0].ztol_num, ztol_den=plans[0].ztol_den,
                  n_straight=plans[0].n_straight)
        got = tpm.score_query_batch_split(sp, c8, *args, **kw)
        want = tpm.score_query_batch_split_plain(sp, c8, *args, **kw)
        k9 = tpm.score_query_batch(planes, *args, target_threshold=-1, **kw)
        for a, b, c in zip(got, want, k9):
            assert torch.equal(a, b) and torch.equal(a, c), (flu, xy)
        assert int(got[0].max()) > 0

    uplans = [tpm.build_full_union_key_plan(
        q, 20, mirror=True, xy_shift=2, pix_color_fluctuation=1.0)
        for q in queries]
    *arrs, u2 = convert.stacked_args(
        tpm.stack_union_plan_args(uplans, h * w), cuda_device)
    rank, cls = tpm.split_key_planes(keys)
    for seg_u2 in (u2, None):
        got = tpm.score_query_batch_union_keys_splitk(rank, cls, *arrs,
                                                      seg_u2)
        want = tpm.score_query_batch_union_keys_splitk_plain(
            rank, cls, *arrs, seg_u2)
        k3 = tpm.score_query_batch_union_keys(keys, *arrs, seg_u2)
        for a, b, c in zip(got, want, k3):
            assert torch.equal(a, b) and torch.equal(a, c), seg_u2
        assert int(got[0].max()) > 0


@pytest.mark.cuda
def test_cuda_split_kernels_count_and_refuse(cuda_device):
    """One launch per wrapper call on CUDA tensors; wrong dtypes (int32
    planes where int16 are due, and back), shapes and devices raise
    before anything launches."""
    kbuild.reset_launches()
    rgb = torch.zeros((3, 10, 12, 3), dtype=torch.uint8, device=cuda_device)
    lut = tcommon.rank_lut_tensor(cuda_device)
    sp, c8 = tcommon.pack_target_planes_split(rgb, 20, t_pad=32)
    planes = tcommon.pack_target_planes(rgb, 20, t_pad=32)
    tcommon.split_planes_from_packed(planes)
    keys = tcommon.key_planes_from_packed(planes, lut)
    rank, cls = tpm.split_key_planes(keys)
    with pytest.raises(TypeError):
        tcommon.split_planes_from_packed(sp)
    with pytest.raises(TypeError):
        tpm.split_key_planes(rank)
    with pytest.raises(ValueError):
        tcommon.key_planes_from_packed(planes, lut.cpu())
    pos = torch.zeros((2, 3, 16), dtype=torch.int32, device=cuda_device)
    q = torch.ones((2, 16), dtype=torch.int32, device=cuda_device)
    kw = dict(ztol_num=1, ztol_den=100, n_straight=3)
    tpm.score_query_batch_split(sp, c8, pos, q, q, q, **kw)
    with pytest.raises(TypeError):
        tpm.score_query_batch_split(planes, c8, pos, q, q, q, **kw)
    with pytest.raises(ValueError):
        tpm.score_query_batch_split(sp, c8, pos.cpu(), q, q, q, **kw)
    lane = torch.zeros((2, 9, 2, 16), dtype=torch.int32, device=cuda_device)
    tpm.score_query_batch_union_keys_splitk(rank, cls, pos[:, :1].contiguous(),
                                            pos[:, :0].contiguous(), lane,
                                            lane)
    with pytest.raises(TypeError):
        tpm.score_query_batch_union_keys_splitk(
            keys, cls, pos[:, :1].contiguous(), pos[:, :0].contiguous(),
            lane, lane)
    names = ("pack_target_planes_split", "split_planes_from_packed",
             "key_planes_from_packed", "split_key_planes",
             "score_query_batch_split", "score_query_batch_union_keys_splitk")
    assert {k: kbuild.launches[k] for k in names} == dict.fromkeys(names, 1)


@pytest.mark.cuda
def test_cuda_qkey_kernels_and_topk_flags_equal_plain_versions(cuda_device):
    """Rows 13 and 14 and K4's flag gather against their plain versions
    on the card, and against the kernels they stand beside: row 13 equals
    K2 on the same batch's positional form, row 14 equals K3 on the
    expanded tables, at every slot-2 prefix (small shapes; chip_smoke.py
    repeats this at the production shapes)."""
    rng = np.random.default_rng(11)
    h, w, t_pad = 30, 40, 64
    stack = np.stack([testing.scattered_pixels(rng, h, w, 250)
                      for _ in range(37)])
    lut = tcommon.rank_lut_tensor(cuda_device)
    keys = tcommon.pack_target_planes_keys(
        torch.from_numpy(stack).to(cuda_device), 20, lut, t_pad=t_pad)
    queries = [testing.scattered_pixels(rng, h, w, n) for n in (250, 90)]
    queries.append(stack[4].copy())
    for xy in (2, 4):
        plans = [tpm.build_full_union_key_plan(
            q, 20, mirror=True, xy_shift=xy, pix_color_fluctuation=1.0,
            light=True) for q in queries]
        u_pos, mu_pos, qidx, key_list, u2 = tpm.stack_union_qkey_args(
            plans, h * w)
        tabs = convert.interval_tables(tpm.interval_table_arrays(0.01),
                                       cuda_device)
        qargs = (convert.qidx(qidx, cuda_device),
                 convert.as_tensor(key_list, cuda_device), *tabs)
        lo, sp = tpm.expand_union_tables(*qargs)
        for a, b in zip((lo, sp), tpm.expand_union_tables_plain(*qargs)):
            assert torch.equal(a, b), xy
        _u, _m, q_pos, kl, _ = tpm.stack_union_pos_args(plans, h * w)
        pos_form = tpm.expand_union_tables_from_pos(
            *[convert.as_tensor(a, cuda_device) for a in (u_pos, q_pos, kl)],
            *tabs, offsets=tuple(shift_offsets(xy)), w=w, h=h)
        assert torch.equal(lo, pos_form[0]) and torch.equal(sp, pos_form[1])
        ups = [convert.as_tensor(a, cuda_device) for a in (u_pos, mu_pos)]
        for prefix in (u2, None, 0, u_pos.shape[2]):
            got = tpm.score_query_batch_union_qkeys(keys, *ups, *qargs,
                                                    prefix)
            want = tpm.score_query_batch_union_qkeys_plain(keys, *ups,
                                                           *qargs, prefix)
            for a, b in zip(got, want):
                assert torch.equal(a, b), (xy, prefix)
        k3 = tpm.score_query_batch_union_keys(keys, *ups, lo, sp, u2)
        got = tpm.score_query_batch_union_qkeys(keys, *ups, *qargs, u2)
        assert torch.equal(got[0], k3[0]) and torch.equal(got[1], k3[1])
        assert int(got[0].max()) > 0
    best = torch.randint(0, 4, (3, 300), dtype=torch.int32,
                         device=cuda_device)
    flags = torch.randint(0, 9, (3, 300), dtype=torch.int32,
                          device=cuda_device)
    for a, b in zip(tpm.union_keys_topk(best, best > 1, 40, flags),
                    tpm.union_keys_topk_plain(best, best > 1, 40, flags)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_shape_dense_and_slice_kernels_equal_plain_versions(
        cuda_device):
    """Row 18b in both modes and row 15 against their plain versions on
    the card (small shapes; chip_smoke.py repeats this at the production
    shapes)."""
    from colormipsearch_tpu_torch.ops import shape_score as tss

    rng = np.random.default_rng(12)
    t_pack = convert.as_tensor(rng.integers(0, 1 << 32, (2, 700, 300),
                                            dtype=np.uint64)
                               .astype(np.uint32), cuda_device)
    q = rng.integers(0, 1 << 12, (2, 700)).astype(np.int32)
    q[:, ::3] = 0
    q_pack = convert.as_tensor(q, cuda_device)
    for a, b in zip(tss.shape_score_pairs_both(t_pack, q_pack),
                    tss.shape_score_pairs_both_plain(t_pack, q_pack)):
        assert torch.equal(a, b)
    for a, b in zip(tss.shape_score_pairs(t_pack[1], q_pack[1]),
                    tss.shape_score_pairs_plain(t_pack[1], q_pack[1])):
        assert torch.equal(a, b)
    rgb = torch.from_numpy(rng.integers(0, 256, (97, 131, 3))
                           .astype(np.uint8)).to(cuda_device)
    rgb[0, :3] = 0
    got = tss.slice_numbers_device(rgb)
    assert torch.equal(got, tss.slice_numbers_device_plain(rgb))
    assert int(got[0, 0]) == 0 and tuple(got.shape) == (97, 131)


@pytest.mark.cuda
def test_cuda_slice_kernels_count_and_refuse(cuda_device):
    """One launch per wrapper call on CUDA tensors (both modes of row 18b
    count as shape_score_pairs); wrong inputs raise before anything
    launches."""
    from colormipsearch_tpu_torch.ops import shape_score as tss

    kbuild.reset_launches()
    t = torch.zeros((2, 5, 7), dtype=torch.int32, device=cuda_device)
    q = torch.zeros((2, 5), dtype=torch.int32, device=cuda_device)
    tss.shape_score_pairs_both(t, q)
    tss.shape_score_pairs(t[0], q[0])
    with pytest.raises(ValueError):
        tss.shape_score_pairs_both(t, q.cpu())
    tss.slice_numbers_device(torch.zeros((4, 3), dtype=torch.uint8,
                                         device=cuda_device))
    with pytest.raises(ValueError):
        tss.slice_numbers_device(torch.zeros((4, 2), dtype=torch.uint8,
                                             device=cuda_device))
    qidx = torch.zeros((1, 9, 16), dtype=torch.int32, device=cuda_device)
    kl = torch.zeros((1, 4), dtype=torch.int32, device=cuda_device)
    tab = torch.zeros((2, 8), dtype=torch.int32, device=cuda_device)
    tpm.expand_union_tables(qidx, kl, tab, tab)
    with pytest.raises(TypeError):
        tpm.expand_union_tables(qidx.long(), kl, tab, tab)
    assert {k: kbuild.launches[k] for k in (
        "shape_score_pairs", "slice_numbers_device",
        "expand_union_tables")} == {"shape_score_pairs": 2,
                                    "slice_numbers_device": 1,
                                    "expand_union_tables": 1}


@pytest.mark.cuda
def test_cuda_mesh_steps_equal_single_device(cuda_device):
    """The mesh steps at 4 shards of one card equal the single-device
    kernels, and launch their kernels once a shard."""
    from colormipsearch_tpu_torch.ops import shape_score as tss
    from colormipsearch_tpu_torch.parallel import mesh as tmesh

    rng = np.random.default_rng(13)
    h, w, t_pad = 30, 40, 64
    stack = np.stack([testing.scattered_pixels(rng, h, w, 250)
                      for _ in range(t_pad)])
    lut = tcommon.rank_lut_tensor(cuda_device)
    keys = tcommon.pack_target_planes_keys(
        torch.from_numpy(stack).to(cuda_device), 20, lut, t_pad=t_pad)
    mesh = tmesh.create_mesh([cuda_device] * 4)
    shards = tmesh.shard_target_planes(mesh, keys)
    plans = [tpm.build_full_union_key_plan(
        q, 20, mirror=True, xy_shift=2, pix_color_fluctuation=1.0,
        light=True) for q in (stack[3], stack[40])]
    u_pos, mu_pos, qidx, key_list, u2 = tpm.stack_union_qkey_args(plans,
                                                                  h * w)
    qargs = (convert.as_tensor(u_pos, cuda_device),
             convert.as_tensor(mu_pos, cuda_device),
             convert.qidx(qidx, cuda_device),
             convert.as_tensor(key_list, cuda_device),
             *convert.interval_tables(tpm.interval_table_arrays(0.01),
                                      cuda_device))
    kbuild.reset_launches()
    got = tmesh.make_sharded_batch_step_union_qkeys(mesh, u2=u2)(shards,
                                                                 *qargs)
    assert kbuild.launches["score_query_batch_union_qkeys"] == 4
    want = tpm.score_query_batch_union_qkeys(keys, *qargs, u2)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    top = tmesh.make_sharded_batch_step_union_qkeys(mesh, top_k=5, u2=u2)(
        shards, *qargs)
    assert kbuild.launches["union_keys_topk"] == 4
    assert tuple(top[0].shape) == (2, 20) and int(top[1].max()) < t_pad
    t_pack = convert.as_tensor(rng.integers(0, 1 << 27, (2, 500, t_pad))
                               .astype(np.uint32), cuda_device)
    q_pack = convert.as_tensor(rng.integers(0, 1 << 12, (2, 500))
                               .astype(np.int32), cuda_device)
    both = tmesh.make_sharded_shape_step(mesh, both=True)(
        tmesh.shard_target_planes(mesh, t_pack), q_pack)
    for a, b in zip(both, tss.shape_score_pairs_both(t_pack, q_pack)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("case", testing.SCATTER_EDGE_CASES,
                         ids=[c[0] for c in testing.SCATTER_EDGE_CASES])
def test_cuda_k1_at_edge_shapes(cuda_device, case):
    """K1 at testing.SCATTER_EDGE_CASES (held to JAX on the CPU in
    test_torch_k1k2_edges.py) equals its plain version, at a small image
    and at the production one (many row tiles a block)."""
    for h, w in ((23, 37), (566, 1210)):
        rng = np.random.default_rng(sum(map(ord, case[0])))
        args, kw = testing.scatter_edge_inputs(rng, case, h, w, cuda_device)
        assert torch.equal(tcommon.scatter_key_planes(*args, **kw),
                           tcommon.scatter_key_planes_plain(*args, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("case", testing.EXPAND_EDGE_CASES,
                         ids=[c[0] for c in testing.EXPAND_EDGE_CASES])
def test_cuda_k2_at_edge_shapes(cuda_device, case):
    """K2 at testing.EXPAND_EDGE_CASES (held to JAX on the CPU in
    test_torch_k1k2_edges.py) equals its plain version."""
    rng = np.random.default_rng(sum(map(ord, case[0])))
    args, kw = testing.expand_edge_inputs(rng, case, cuda_device)
    for a, b in zip(tpm.expand_union_tables_from_pos(*args, **kw),
                    tpm.expand_union_tables_from_pos_plain(*args, **kw)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_union_kernels_at_edge_shapes(cuda_device):
    """K3, K13 and row 14, which split the union over the grid, against
    their plain versions at every testing.UNION_EDGE_CASES shape (17 and
    25 lanes, no mirror sets, one mask, a ragged union, the slot-2 prefix
    on, past, before and inside a chunk's edge), on 300 target columns (not
    a multiple of the 256 a block takes), each at the case's chunk and at
    the kernel's own choice."""
    rng = np.random.default_rng(12)
    h, w = 60, 80
    stack = np.stack([testing.scattered_pixels(rng, h, w, 400)
                      for _ in range(300)])
    lut = tcommon.rank_lut_tensor(cuda_device)
    planes = tcommon.pack_target_planes_keys_plain(
        torch.from_numpy(stack).to(cuda_device), 20, lut, t_pad=300)
    rank, cls = tcommon.split_key_planes_plain(planes)
    for case in testing.UNION_EDGE_CASES:
        batch = testing.union_edge_batch(rng, case, h, w, cuda_device)
        args, qargs = batch["union"], batch["qkeys"]
        want = tpm.score_query_batch_union_keys_plain(planes, *args)
        want13 = tpm.score_query_batch_union_keys_splitk_plain(rank, cls,
                                                               *args)
        want14 = tpm.score_query_batch_union_qkeys_plain(planes, *qargs)
        assert int(want[0].max()) > 0, case[0]
        for chunk in {batch["chunk"], 0}:
            got = tpm.score_query_batch_union_keys(planes, *args,
                                                   chunk=chunk)
            got13 = tpm.score_query_batch_union_keys_splitk(
                rank, cls, *args, chunk=chunk)
            got14 = tpm.score_query_batch_union_qkeys(planes, *qargs,
                                                      chunk=chunk)
            for g, wnt in ((got, want), (got13, want13), (got14, want14)):
                for a, b in zip(g, wnt):
                    assert torch.equal(a, b), (case[0], chunk)


@pytest.mark.cuda
def test_cuda_banded_kernels_at_edge_shapes(cuda_device):
    """K9 and K11 against their plain versions, flags included: at column
    counts that are and are not a multiple of the four columns a thread
    takes (vector and one-by-one loads) and a padded query of 300 (not a
    multiple of the 256-pixel chunk), at both same-class branches."""
    rng = np.random.default_rng(13)
    h, w = 30, 40
    for n_cols in (13, 301, 302, 304):
        stack = np.stack([testing.scattered_pixels(rng, h, w, 300)
                          for _ in range(n_cols)])
        planes = tcommon.pack_target_planes_plain(
            torch.from_numpy(stack).to(cuda_device), 20, t_pad=n_cols)
        sp, c8 = tcommon.split_planes_from_packed_plain(planes)
        queries = [testing.scattered_pixels(rng, h, w, 260),
                   stack[1].copy()]
        for flu in (1.0, 0.37):
            plans = [tpm.build_query_plan(q, 20, mirror=True, xy_shift=2,
                                          pix_color_fluctuation=flu,
                                          pad_to=300) for q in queries]
            args = [convert.as_tensor(np.stack([getattr(p, f)
                                                for p in plans]),
                                      cuda_device)
                    for f in ("positions", "q_cls", "q_s", "q_p")]
            kw = dict(ztol_num=plans[0].ztol_num,
                      ztol_den=plans[0].ztol_den,
                      n_straight=plans[0].n_straight)
            want = tpm.score_query_batch_plain(planes, *args,
                                               target_threshold=-1, **kw)
            want11 = tpm.score_query_batch_split_plain(sp, c8, *args, **kw)
            assert int(want[0].max()) > 0
            got = tpm.score_query_batch(planes, *args, target_threshold=-1,
                                        **kw)
            got11 = tpm.score_query_batch_split(sp, c8, *args, **kw)
            for g, wnt in ((got, want), (got11, want11)):
                for a, b in zip(g, wnt):
                    assert torch.equal(a, b), (n_cols, flu)


@pytest.mark.cuda
@pytest.mark.parametrize("case", testing.TILE_EDGE_CASES,
                         ids=[c[0] for c in testing.TILE_EDGE_CASES])
def test_cuda_k6_at_edge_shapes(cuda_device, case):
    """K6 at testing.TILE_EDGE_CASES (held to JAX on the CPU in
    test_torch_shape_edges.py) equals its plain version."""
    from colormipsearch_tpu_torch.ops import shape_score as tss

    rng = np.random.default_rng(sum(map(ord, case[0])))
    fields, rows, tp, kw = testing.tile_edge_inputs(
        testing.tile_edge_case(rng, case), cuda_device)
    want = tss.shape_tile_device_plain(fields, rows, tp, **kw)
    # the store rows on the card, and on the host as the engine gives them
    for rows_sel in (rows, rows.cpu()):
        for a, b in zip(tss.shape_tile_device(fields, rows_sel, tp, **kw),
                        want):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("case", testing.SPLIT_EDGE_CASES,
                         ids=[c[0] for c in testing.SPLIT_EDGE_CASES])
def test_cuda_k5_at_edge_shapes(cuda_device, case):
    """K5 at testing.SPLIT_EDGE_CASES, through its 16-byte and its scalar
    loader (planes one word past 16-byte alignment), equals its plain
    version."""
    from colormipsearch_tpu_torch.ops import shape_score as tss

    rng = np.random.default_rng(sum(map(ord, case[0])))
    args = [convert.as_tensor(a, cuda_device)
            for a in testing.split_edge_case(rng, case)]
    want = tss.shape_score_pairs_split_plain(*args)
    for a, b in zip(tss.shape_score_pairs_split(*args), want):
        assert torch.equal(a, b)
    # the same planes one word into a buffer: not 16-byte aligned
    shifted = list(args)
    for k in (0, 2):
        buf = torch.zeros(args[k].numel() + 1, dtype=torch.int32,
                          device=cuda_device)
        shifted[k] = buf[1:].view(args[k].shape)
        shifted[k].copy_(args[k])
    assert shifted[0].data_ptr() % 16
    for a, b in zip(tss.shape_score_pairs_split(*shifted), want):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("case", testing.TOPK_EDGE_CASES,
                         ids=[c[0] for c in testing.TOPK_EDGE_CASES])
def test_cuda_k4_at_edge_shapes(cuda_device, case):
    """K4 at testing.TOPK_EDGE_CASES (held to JAX on the CPU in
    test_torch_k4k7_edges.py) equals its plain version, flag gather
    included."""
    testing.check_topk_edge(case, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("case", testing.PIXEL_MAJOR_EDGE_CASES,
                         ids=[c[0] for c in testing.PIXEL_MAJOR_EDGE_CASES])
def test_cuda_k7_at_edge_shapes(cuda_device, case):
    """K7 at testing.PIXEL_MAJOR_EDGE_CASES (held to JAX on the CPU in
    test_torch_k4k7_edges.py) equals its plain version, also with the
    chunk one element past an aligned base (narrower loads)."""
    testing.check_pixel_major_edge(case, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("case", testing.SLICE_NUMBERS_EDGE_CASES,
                         ids=[c[0] for c in testing.SLICE_NUMBERS_EDGE_CASES])
def test_cuda_row15_at_edge_shapes(cuda_device, case):
    """Row 15 at testing.SLICE_NUMBERS_EDGE_CASES (held to JAX on the CPU
    in test_torch_row15_k8split_edges.py) equals its plain version:
    ragged tails, bases 3-24 bytes in (narrower loads), all-black warps,
    every class, dense pixels."""
    testing.check_slice_numbers_edge(case, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("case", testing.PACK_SPLIT_EDGE_CASES,
                         ids=[c[0] for c in testing.PACK_SPLIT_EDGE_CASES])
def test_cuda_k8_split_at_edge_shapes(cuda_device, case):
    """K8's split mode at testing.PACK_SPLIT_EDGE_CASES (held to JAX on the
    CPU in test_torch_row15_k8split_edges.py) equals its plain version:
    every t_pad and base alignment, ragged pixels, both thresholds."""
    testing.check_pack_split_edge(case, cuda_device)


@pytest.mark.cuda
def test_cuda_row15_and_k8_split_over_every_class_p_s(cuda_device):
    """Row 15 and K8's split mode equal their plain versions on every
    (class, p, s), tie and extreme of testing.slice_class_triples."""
    from colormipsearch_tpu_torch.ops import shape_score as tss

    px = torch.from_numpy(testing.slice_class_triples()).to(cuda_device)
    assert torch.equal(tss.slice_numbers_device(px),
                       tss.slice_numbers_device_plain(px))
    n = px.shape[0] // 8 * 8
    stack = px[:n].reshape(8, -1, 1, 3)
    for thr in (0, 20, 254):
        for a, b in zip(tcommon.pack_target_planes_split(stack, thr,
                                                         t_pad=16),
                        tcommon.pack_target_planes_split_plain(
                            stack, thr, t_pad=16)):
            assert torch.equal(a, b), thr


@pytest.mark.cuda
def test_cuda_v2_commands_write_the_cpu_files(cuda_device, tmp_path):
    """searchLocalFiles --with-grad-scores and gradientScore on the card
    (K1-K5) write the files of the same commands with --device cpu. K4
    runs only under a positive --pctPositivePixels and where its k (256)
    is below the shard's width: 320 targets."""
    from colormipsearch_tpu_torch.cli import main as cli_main

    rng = np.random.default_rng(67)
    lib = testing.synthetic_library(rng, 320, 4, 48, 72, target_fg=0.08,
                                    mask_fg=0.03)
    testing.write_neuron_images(
        tmp_path / "targets", lib.targets, "t",
        gradients=[testing.synthetic_gradient(rng, t) for t in lib.targets],
        zgaps=[testing.synthetic_zgap(t, radius=4) for t in lib.targets],
        threads=2)
    testing.write_neuron_images(tmp_path / "masks", lib.masks, "m",
                                threads=2)
    flags = ["--maskThreshold", "20", "--dataThreshold", "20",
             "--pixColorFluctuation", "1.0", "--xyShift", "2",
             "--mirrorMask", "--no-name-labels", "--no-colormap-labels",
             "--negativeRadius", "4", "--pctPositivePixels", "1.0"]
    variants = ["-gp", str(tmp_path / "targets" / "grad"),
                "-zgp", str(tmp_path / "targets" / "zgap")]
    trees = {}
    for device in ("cuda", "cpu"):
        out = tmp_path / device
        kbuild.reset_launches()
        assert cli_main.main([
            "searchLocalFiles", "-m", str(tmp_path / "masks"), "-i",
            str(tmp_path / "targets"), *flags, "--with-grad-scores",
            *variants, "--device", device, "-od", str(out / "search")]) == 0
        assert cli_main.main([
            "gradientScore", "-rd", str(out / "search"), *variants,
            "--maskThreshold", "20", "--mirrorMask", "--no-name-labels",
            "--no-colormap-labels", "--negativeRadius", "4",
            "--device", device, "-od", str(out / "gs")]) == 0
        if device == "cuda":
            assert all(kbuild.launches[k] > 0 for k in (
                "scatter_key_planes", "expand_union_tables_from_pos",
                "score_query_batch_union_keys", "union_keys_topk",
                "shape_score_pairs_split"))
        trees[device] = {str(p.relative_to(out)): p.read_bytes()
                         for p in sorted(out.rglob("*.json"))}
    assert any(k.startswith("gs/") for k in trees["cpu"])
    assert trees["cuda"] == trees["cpu"]
