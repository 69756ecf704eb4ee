"""Shape (gradient-area-gap) scoring: host packers and the device kernels
K5-K7, the dense-row kernel and the slice-number scan.

The host side (query pack, support split, per-target column selection,
the packed-store gathers, the mirror selection) is carried over from the
JAX package's ops/shape_score.py unchanged, so both packages build
identical planes. The device side replaces the package's jitted
functions with hand-written CUDA kernels (kernels/csrc), each beside its
plain PyTorch version:

  * K5 ``shape_score_pairs_split``: split-row scoring of one query
    against T targets, both orientations (shape_split.cu),
  * K6 ``shape_tile_device``: dispatch planes built on the device from
    device-resident store fields (shape_tile.cu),
  * K7 ``upload_pixel_major_chunk``: one [R, n] row slice of a store
    field transposed into the pixel-major [n_px, R] device buffer
    (pixel_major.cu), driven chunk by chunk by ``upload_pixel_major``,
  * row 18b ``shape_score_pairs`` / ``shape_score_pairs_both``: the dense
    row form of the pair scoring, one orientation or both, on the packs
    of ``pack_targets`` / ``pack_target_rows`` (shape_dense.cu); only the
    mesh's shape step (parallel/mesh.make_sharded_shape_step) runs it,
  * row 15 ``slice_numbers_device``: z-slice numbers of RGB pixels by the
    exact integer LUT scan, a binary search on the card
    (slice_numbers.cu); no engine path runs it
    (both engines read the slice table, ops/slice_lut.py).

Planes that hold uint32 bits travel as int32 tensors with the same bits,
and store fields that hold uint16 values as int16 tensors with the same
bits, because torch's unsigned types lack most operations.

Reference semantics: ShapeMatchColorDepthSearchAlgorithm:191-240 (gap
fold) and :221-238 (high-expression fold); mirror selection :172-179.
"""

from __future__ import annotations

import functools
import typing

import numpy as np
import torch

from colormipsearch_tpu_torch.constants import (
    DEFAULT_COLOR_FLUX,
    GAP_THRESHOLD,
    RAINBOW_LUT,
    SLICE_LUT_RANGES,
)
from colormipsearch_tpu_torch.kernels import build as kbuild
from colormipsearch_tpu_torch.oracle import shape as shape_oracle

# field layout (keep in sync with pack_query, pack_targets and the gap
# planes below)
_SL_SHIFT = 16
_ZNZ_SHIFT = 25
_TFG_SHIFT = 26

_Q_SL_MASK = 0x1FF
_Q_NZ_SHIFT = 9
_Q_SIG_SHIFT = 10
_Q_HE_SHIFT = 11


# -------------------------------------------------------------------------
# row 15: slice numbers by the exact integer LUT scan
# -------------------------------------------------------------------------


def _lut_tables():
    """Per-class padded integer LUT tables for the exact argmin.

    Every in-range LUT entry has a dominant channel value of 255
    (asserted below), so the nearest-ratio comparison
        |s/p - S_i/255|  ->  argmin_i |255*s - S_i*p|
    is EXACT in int32 (max magnitude 255*255*255 ~ 1.66e7), reproducing
    the float64 oracle's first-minimum tie-breaks except at exact
    rational ties. Every row is strictly monotone (asserted below), which
    the kernel's binary search needs. Returns (secondaries int32 [6, L]
    padded with 2^20, starts int32 [6]); the true row lengths are
    _lut_lengths()."""
    lut = RAINBOW_LUT
    r, g, b = lut[:, 0], lut[:, 1], lut[:, 2]
    r_dom = (r >= g) & (r >= b)
    g_dom = ~r_dom & (g >= r) & (g >= b)
    prim = np.where(r_dom, r, np.where(g_dom, g, b))
    sec = np.where(r_dom, np.maximum(g, b),
                   np.where(g_dom, np.maximum(r, b), np.maximum(r, g)))
    rows, starts = [], []
    max_len = max(_lut_lengths())
    for cid in range(1, 7):
        lo, hi = SLICE_LUT_RANGES[cid]
        assert (prim[lo:hi + 1] == 255).all(), \
            "LUT dominant channel must be 255 for the exact integer scan"
        s_row = sec[lo:hi + 1].astype(np.int64)
        step = np.diff(s_row)
        assert (step > 0).all() or (step < 0).all(), \
            "LUT rows must be strictly monotone for the kernel's search"
        pad = np.full(max_len - s_row.size, 1 << 20, np.int64)
        rows.append(np.concatenate([s_row, pad]))
        starts.append(lo)
    return (np.asarray(rows, np.int32), np.asarray(starts, np.int32))


def _lut_lengths() -> list[int]:
    """The true lengths of the six class rows of _lut_tables."""
    return [hi - lo + 1 for lo, hi in (SLICE_LUT_RANGES[c]
                                       for c in range(1, 7))]


@functools.lru_cache(maxsize=None)
def _lut_tensors(device: torch.device) -> tuple:
    """(rows, starts, lengths) int32 tensors of _lut_tables on `device`,
    made once per device (the kernel's wrapper is called per stack)."""
    rows, starts = _lut_tables()
    return tuple(torch.from_numpy(np.asarray(a, np.int32)).to(device)
                 for a in (rows, starts, _lut_lengths()))


def slice_numbers_device_plain(rgb: torch.Tensor, *,
                               chunk: int = 1 << 22) -> torch.Tensor:
    """Plain PyTorch version of row 15 (see slice_numbers_device), in
    `chunk`-pixel slices so the [chunk, L] scan stays bounded."""
    rows, starts = (torch.from_numpy(a).to(rgb.device)
                    for a in _lut_tables())
    flat = rgb.reshape(-1, 3)
    out = torch.empty(flat.shape[0], dtype=torch.int32, device=rgb.device)
    idx = torch.arange(rows.shape[1], dtype=torch.int32, device=rgb.device)
    for c0 in range(0, flat.shape[0], chunk):
        r, g, b = (flat[c0:c0 + chunk, c].to(torch.int32) for c in range(3))
        r_dom = (r >= g) & (r >= b)
        g_dom = ~r_dom & (g >= r) & (g >= b)
        cls = torch.where(
            r_dom, torch.where(g >= b, 5, 6),
            torch.where(g_dom, torch.where(r >= b, 4, 3),
                        torch.where(r >= g, 1, 2))).to(torch.int64)
        p = torch.where(r_dom, r, torch.where(g_dom, g, b))
        s = torch.where(r_dom, torch.maximum(g, b),
                        torch.where(g_dom, torch.maximum(r, b),
                                    torch.maximum(r, g)))
        keys = (255 * s[:, None] - rows[cls - 1] * p[:, None]).abs()
        # the first minimum: the smallest index among the minima
        first = torch.where(keys == keys.min(-1, keepdim=True).values, idx,
                            rows.shape[1]).min(-1).values
        black = (r == 0) & (g == 0) & (b == 0)
        out[c0:c0 + chunk] = torch.where(black, 0,
                                         starts[cls - 1] + first + 1)
    return out.reshape(rgb.shape[:-1])


def slice_numbers_device(rgb: torch.Tensor) -> torch.Tensor:
    """Row 15: int32 z-slice numbers (1..256; 0 for black) of uint8
    [..., 3] pixels: >=-tie classification (R, G, B priority), the
    nearest-ratio scan with first-minimum tie-breaking, in exact integer
    arithmetic (_lut_tables).

    At EXACT rational ties between two LUT distances this takes the
    first minimum, whereas the reference's float64 arithmetic lets
    rounding pick a side; ops.slice_lut.slice_numbers_lut (the table
    built from the float64 oracle) is the bit-exact form, and what both
    engines use. CPU tensors run the plain version; CUDA tensors launch
    kernels/csrc/slice_numbers.cu or raise."""
    kbuild.check_tensor(rgb, "rgb", torch.uint8)
    if rgb.dim() < 1 or rgb.shape[-1] != 3:
        raise ValueError(f"expected [..., 3] pixels, got {tuple(rgb.shape)}")
    if rgb.device.type == "cpu":
        return slice_numbers_device_plain(rgb)
    kbuild.require_cuda(rgb)
    rows, starts, lens = _lut_tensors(rgb.device)
    out = torch.empty(rgb.shape[:-1], dtype=torch.int32, device=rgb.device)
    if not out.numel():
        return out
    lib = kbuild.load_library()
    kbuild.check(lib.cmst_slice_numbers(
        rgb.data_ptr(), out.numel(), rows.data_ptr(), starts.data_ptr(),
        lens.data_ptr(), rows.shape[1], out.data_ptr(),
        kbuild.stream_of(rgb)), "slice_numbers_device")
    kbuild.count_launch("slice_numbers_device")
    return out


# -------------------------------------------------------------------------
# query packing
# -------------------------------------------------------------------------


def high_expression_ring(q: np.ndarray, *, fg: np.ndarray | None = None,
                         fg_sums: np.ndarray | None = None) -> np.ndarray:
    """Exact high-expression ring mask [H, W] bool — bit-identical to
    the reference's rgb_signal(combine2(maxFilter60(q), maxFilter20(q),
    drop-where-20-present), 0) but ~12x cheaper
    (ColorDepthSearchAlgorithmProviderFactory.java:113-131).

    Derivation: signal-0 of a pixel of the r=60 per-channel-max dilation
    is 1 iff the sum of its per-channel maxes s' satisfies
    (2*((2s'+3)//6)+3)//6 > 0  <=>  s' >= 5; the r=20 drop term only
    tests any-foreground.  Both reduce to disk reachability because the
    ImageJ footprint is exactly the integer disk dy^2+dx^2 <= int(r^2)+1
    (oracle.shape.binary_dilate_disk): one Euclidean distance transform
    answers "foreground within r" for every radius at once.  A BRIGHT
    pixel (channel sum >= 5) in the 60-disk guarantees s' >= 5 since
    sum_c max_p >= max_p sum_c; only DIM foreground pixels (sum 1..4 —
    absent from real CDMs, where content is either black or saturated)
    need the true per-channel max, computed on the dim pixels alone.
    """
    if fg is None:
        fg = q.any(axis=-1)
    if not fg.any():
        return np.zeros(q.shape[:2], bool)
    if fg_sums is None:
        fg_sums = q.reshape(-1, 3)[fg.reshape(-1)].astype(np.int32) \
            .sum(axis=1)
    d = shape_oracle.ndimage.distance_transform_edt(~fg)
    # d is sqrt of an exact integer squared distance: comparing d to
    # sqrt(r2 + 0.5) is exactly d^2 <= r2 (gap between adjacent sqrt-of-
    # integer values >> f64 rounding), saving two full-plane float passes
    not20 = d > 20.0374  # sqrt(401.5), r2 = int(20^2)+1
    if not (fg_sums < 5).any():
        return (d <= 60.0125) & not20  # sqrt(3601.5), r2 = int(60^2)+1
    s = q.astype(np.int32).sum(axis=-1)
    bright60 = shape_oracle.binary_dilate_disk(s >= 5, 60)
    dim = fg & (s < 5)
    dim_img = np.where(dim[..., None], q, 0).astype(np.uint8)
    s60dim = shape_oracle.dilate_rgb(dim_img, 60).astype(np.int32) \
        .sum(axis=-1)
    return (bright60 | (s60dim >= 5)) & not20


def pack_query(q_rgb: np.ndarray, *, excluded_region=None,
               roi_keep=None) -> np.ndarray:
    """Query-side int32 [P] plane (host precompute, once per mask):
    bits 0..8 slice number, 9 nonzero, 10 signal (intensity >= threshold
    2), 11 high-expression-ring bit.

    Uses the oracle's exact integer signal formulas; the high-expression
    ring (r=60/r=20 — factory :113-131) runs through the exact EDT fast
    path, and the per-pixel fields are computed only at the sparse
    foreground (CDMs are ~98% black).
    """
    from colormipsearch_tpu_torch.ops.slice_lut import slice_numbers_lut

    q = shape_oracle.clear_region(q_rgb, excluded_region)
    h, w = q.shape[:2]
    flat_rgb = q.reshape(-1, 3)
    fg = q.any(axis=-1)
    fg_flat = fg.reshape(-1)
    idx = np.flatnonzero(fg_flat)
    vals = flat_rgb[idx].astype(np.int32)
    sums = vals.sum(axis=1)
    # sl/nz/sig are zero off-foreground (slice 0 for black; nz = fg;
    # sig requires gray16 signal > 2): gather/compute at support only
    sl_vals = slice_numbers_lut(flat_rgb[idx]).astype(np.int32)
    v16 = (2 * sums + 3) // 6
    sig_vals = ((2 * v16 + 3) // 6 > 2)
    he = high_expression_ring(q, fg=fg, fg_sums=sums)
    word = np.zeros(h * w, np.int32)
    word[idx] = (sl_vals | (1 << _Q_NZ_SHIFT)
                 | (sig_vals.astype(np.int32) << _Q_SIG_SHIFT))
    if roi_keep is not None:
        # nz/sig bits are gated by the ROI; the slice field is not (it
        # only ever multiplies against those bits in the kernel)
        word[idx] &= np.where(
            roi_keep.reshape(-1)[idx], -1,
            ~((1 << _Q_NZ_SHIFT) | (1 << _Q_SIG_SHIFT))).astype(np.int32)
        he &= roi_keep
    word |= he.reshape(-1).astype(np.int32) << _Q_HE_SHIFT
    return word


# -------------------------------------------------------------------------
# dense (one word a row) target packing: row 18b's inputs
# -------------------------------------------------------------------------
#
# Target words (uint32): bits 0..15 gradient (pre-thresholded), 16..24
# z-gap slice number, 25 z-gap nonzero, 26 target foreground. The mirror
# pack flips the gradient and foreground fields horizontally and keeps the
# z-gap fields in place: flipping the query and the target z-gap plane
# (the reference's quirk, ShapeMatchColorDepthSearchAlgorithm:214-221) is
# equivalent.


def pack_targets(t_rgb: np.ndarray, grad: np.ndarray,
                 zgap_rgb: np.ndarray, *, mask_threshold: int):
    """uint8 [T,H,W,3] x uint16 [T,H,W] x uint8 [T,H,W,3] -> (straight,
    mirror) packed uint32 [P, T] host planes. Slice numbers come from the
    exact full-RGB table (ops/slice_lut.py)."""
    from colormipsearch_tpu_torch.ops.slice_lut import slice_numbers_lut

    t = t_rgb.shape[0]
    sl = slice_numbers_lut(zgap_rgb).astype(np.uint32)
    znz = (zgap_rgb.astype(np.int32).sum(axis=-1) > 0).astype(np.uint32)
    tfg = (t_rgb > mask_threshold).any(axis=-1).astype(np.uint32)
    # pre-threshold the gradient (ShapeMatch zeroes values <= GAP_THRESHOLD
    # :219): the slice-gap branch can never fall below it (sg - 40 >= 40)
    grad_thr = np.where(grad > GAP_THRESHOLD, grad, 0)
    word = (grad_thr.astype(np.uint32)
            | (sl << _SL_SHIFT) | (znz << _ZNZ_SHIFT) | (tfg << _TFG_SHIFT))
    grad_fg = word & np.uint32(0xFFFF | (1 << _TFG_SHIFT))
    z_part = word & np.uint32((0x1FF << _SL_SHIFT) | (1 << _ZNZ_SHIFT))
    mirror = z_part | grad_fg[:, :, ::-1]
    flat = np.ascontiguousarray(word.reshape(t, -1).T)
    flat_m = np.ascontiguousarray(mirror.reshape(t, -1).T)
    return flat, flat_m


def support_positions(q_pack: np.ndarray,
                      q_pack_mirror: np.ndarray | None = None) -> np.ndarray:
    """int32 flat pixel indices whose query word is nonzero (union with
    the mirror-ROI pack when given) — the only rows that can contribute
    to any score term."""
    word = q_pack if q_pack_mirror is None else (q_pack | q_pack_mirror)
    return np.flatnonzero(word).astype(np.int32)


def sparse_query(q_pack: np.ndarray, pos: np.ndarray,
                 n_pad: int) -> np.ndarray:
    """Query plane sliced to the padded support rows (pad word = 0, which
    zeroes every contribution of the pad rows)."""
    out = np.zeros(n_pad, np.int32)
    out[:pos.size] = q_pack[pos]
    return out


def pack_target_rows(t_rgbs, grads, zgap_rgbs, pos: np.ndarray,
                     n_pad: int, *, mask_threshold: int,
                     excluded: np.ndarray | None = None,
                     mirror: bool = True):
    """Column-sliced pack_targets: ONE uint32 [2, S_pad, T] host plane
    (index 0 straight, 1 mirror; [1, S_pad, T] when mirror=False) holding
    only the query-support rows `pos`, so both orientations score in one
    call (shape_score_pairs_both).

    Accepts sequences (or stacks) of per-target [H, W(, 3)] images and
    slices the support columns per image. The mirror plane keeps z-gap
    fields in place and takes gradient/foreground from the horizontally
    mirrored pixel. `excluded`: optional bool [H, W] ignored region; it
    only clears the foreground bit (grad/zgap are packed uncleaned)."""
    from colormipsearch_tpu_torch.ops.slice_lut import slice_numbers_lut

    t = len(t_rgbs)
    w = t_rgbs[0].shape[1]
    both = np.concatenate([pos, _mirror_of(pos, w)]) if mirror else pos

    zsel = np.stack([z.reshape(-1, 3)[pos] for z in zgap_rgbs])
    sl = slice_numbers_lut(zsel).astype(np.uint32)
    znz = (zsel.astype(np.int32).sum(axis=-1) > 0).astype(np.uint32)
    z_part = (sl << _SL_SHIFT) | (znz << _ZNZ_SHIFT)   # [T, S]

    # straight + mirrored gradient/foreground columns in one slice pass
    tsel = np.stack([i.reshape(-1, 3)[both] for i in t_rgbs])
    gsel = np.stack([g.reshape(-1)[both] for g in grads])
    tfg = (tsel > mask_threshold).any(axis=-1).astype(np.uint32)
    if excluded is not None:
        tfg &= (~excluded.reshape(-1)[both]).astype(np.uint32)
    g_thr = np.where(gsel > GAP_THRESHOLD, gsel, 0).astype(np.uint32)
    grad_fg = g_thr | (tfg << _TFG_SHIFT)              # [T, (1|2)S]

    n = pos.size
    n_or = 2 if mirror else 1
    out = np.zeros((n_or, n_pad, t), np.uint32)
    out[0, :n] = (z_part | grad_fg[:, :n]).T
    if mirror:
        out[1, :n] = (z_part | grad_fg[:, n:]).T
    return out


# -------------------------------------------------------------------------
# split (gap-row / he-row) packing
# -------------------------------------------------------------------------
#
# Every term of the shape score has a query-side factor, so rows whose
# packed query word is 0 never contribute, and the support rows split
# into two DISJOINT classes:
#   * gap rows — query pixel non-black (q_sl != 0): the only rows where
#     the slice-gap / gradient term can be nonzero.  They never carry
#     the high-expression bit, because the HE ring is d60 MINUS d20 and
#     d20 contains every non-black query pixel.
#   * he rows — ring bit set (necessarily q_sl == 0): contribute only
#     `targetIsFG` to highExpressionArea; the gap term is identically 0
#     there (no overlap, no signal).
#
# Field layout (gap planes):
#   target uint32: bits 0..15 gradient (pre-thresholded), 16..24 z-gap
#                  slice number.  z_nz is implied by slice != 0 (the
#                  slice LUT maps exactly the black pixel to 0).
#   query  int32:  bits 0..8 slice, 9 nz, 10 signal (same as pack_query
#                  minus the he bit).
# He planes bitpack 32 ring rows per uint32 word (little-endian).


def support_split(q_pack: np.ndarray,
                  q_pack_mirror: np.ndarray | None = None):
    """(pos_gap, pos_he) int32 flat indices: rows with a nonzero query
    slice (gap rows) and rows with the high-expression ring bit in
    either pack (he rows).  Disjoint by construction (see above)."""
    word = q_pack if q_pack_mirror is None else (q_pack | q_pack_mirror)
    sl = word & _Q_SL_MASK
    he = (word >> _Q_HE_SHIFT) & 1
    pos_gap = np.flatnonzero(sl).astype(np.int32)
    pos_he = np.flatnonzero(he & (sl == 0)).astype(np.int32)
    return pos_gap, pos_he


def support_bucket(s: int, minimum: int = 4096) -> int:
    """Support sizes pad to the {1,1.25,1.5,1.75} x 2^k ladder so plane
    shapes are reused across masks."""
    from colormipsearch_tpu_torch.ops.pixel_match import _bucket

    return _bucket(s, minimum=minimum)


def he_words(n_he_rows: int, minimum: int = 128) -> int:
    """Padded uint32 word count for n_he_rows bitpacked ring rows."""
    return support_bucket(-(-n_he_rows // 32), minimum=minimum)


def _packbits32(bits: np.ndarray, n_words: int) -> np.ndarray:
    """bool [..., S] -> uint32 [..., n_words]: bit b of word w is row
    32*w + b (little-endian packbits), zero-padded."""
    b = np.packbits(bits, axis=-1, bitorder="little")
    pad = n_words * 4 - b.shape[-1]
    if pad < 0:
        raise ValueError(f"{bits.shape[-1]} rows exceed {n_words} words")
    if pad:
        b = np.pad(b, [(0, 0)] * (b.ndim - 1) + [(0, pad)])
    return np.ascontiguousarray(b).view(np.uint32)


def sparse_query_split(q_pack: np.ndarray, pos_gap: np.ndarray,
                       n_gap_pad: int, pos_he: np.ndarray,
                       n_he_words: int):
    """(q_gap int32 [n_gap_pad], q_he uint32 [n_he_words]) query-side
    planes for the split kernel.  Gap pad rows are 0 (neutral); he rows
    bitpack 32 ring-row gates per word (see he_words)."""
    q_gap = np.zeros(n_gap_pad, np.int32)
    q_gap[:pos_gap.size] = q_pack[pos_gap] & ~(1 << _Q_HE_SHIFT)
    q_he = _packbits32(
        ((q_pack[pos_he] >> _Q_HE_SHIFT) & 1).astype(bool), n_he_words)
    return q_gap, q_he


def _mirror_of(pos: np.ndarray, w: int) -> np.ndarray:
    y, x = pos // w, pos % w
    return y * w + (w - 1 - x)


def select_target_cols_split(t_rgb, grad, zgap_rgb,
                             pos_gap: np.ndarray, n_gap_pad: int,
                             pos_he: np.ndarray, n_he_words: int, *,
                             mask_threshold: int,
                             excluded: np.ndarray | None = None,
                             mirror: bool = True):
    """ONE target's split-pack columns: (gap_cols uint32 [n_or, Sg_pad],
    he_cols uint32 [n_or, n_he_words]) with n_or = 2 (straight, mirror)
    or 1.

    Gap rows carry gradient|slice (z-gap fields stay in place across
    orientations; the gradient comes from the mirrored column for the
    mirror plane).  He rows carry ONLY the target-foreground bit,
    masked by the excluded region.  The engine's decode workers call
    this right after decoding, so the multi-MB images are dropped per
    target; assemble_target_rows_split stacks the columns."""
    from colormipsearch_tpu_torch.ops.slice_lut import slice_numbers_lut

    w = t_rgb.shape[1]
    n_or = 2 if mirror else 1
    sg = pos_gap.size

    # gap rows: slice part once, gradient per orientation
    zsel = zgap_rgb.reshape(-1, 3)[pos_gap]
    z_part = slice_numbers_lut(zsel).astype(np.uint32) << _SL_SHIFT
    g_pos = (np.concatenate([pos_gap, _mirror_of(pos_gap, w)]) if mirror
             else pos_gap)
    gsel = grad.reshape(-1)[g_pos]
    g_thr = np.where(gsel > GAP_THRESHOLD, gsel, 0).astype(np.uint32)
    gap_cols = np.zeros((n_or, n_gap_pad), np.uint32)
    gap_cols[0, :sg] = z_part | g_thr[:sg]
    if mirror:
        gap_cols[1, :sg] = z_part | g_thr[sg:]

    # he rows: foreground bit only, bitpacked 32 rows/word
    h_pos = (np.concatenate([pos_he, _mirror_of(pos_he, w)]) if mirror
             else pos_he)
    tsel = t_rgb.reshape(-1, 3)[h_pos]
    tfg = (tsel > mask_threshold).any(axis=-1)
    if excluded is not None:
        tfg &= ~excluded.reshape(-1)[h_pos]
    sh = pos_he.size
    he_cols = np.empty((n_or, n_he_words), np.uint32)
    he_cols[0] = _packbits32(tfg[:sh], n_he_words)
    if mirror:
        he_cols[1] = _packbits32(tfg[sh:], n_he_words)
    return gap_cols, he_cols


def split_gather_plan(pos_gap: np.ndarray, pos_he: np.ndarray, w: int, *,
                      mirror: bool = True,
                      excluded: np.ndarray | None = None):
    """Once-per-mask-group precompute for the packed-store gather path
    (io/shape_pack.py): the straight+mirror gradient/foreground gather
    indices and the per-he-row region gate."""
    g_pos = (np.concatenate([pos_gap, _mirror_of(pos_gap, w)]) if mirror
             else pos_gap)
    h_pos = (np.concatenate([pos_he, _mirror_of(pos_he, w)]) if mirror
             else pos_he)
    keep_he = None
    if excluded is not None:
        keep_he = ~excluded.reshape(-1)[h_pos]
    return g_pos, h_pos, keep_he


def select_target_cols_split_from_row(zsl: np.ndarray, grad_thr: np.ndarray,
                                      tfg_bits: np.ndarray,
                                      pos_gap: np.ndarray, n_gap_pad: int,
                                      n_he_words: int, gather_plan, *,
                                      mirror: bool = True):
    """select_target_cols_split from a persisted store row (full-plane
    zsl/grad_thr/tfg fields, io/shape_pack.ShapePackStore.row): no
    decode, no dilation, no slice LUT — column gathers only."""
    g_pos, h_pos, keep_he = gather_plan
    n_or = 2 if mirror else 1
    sg = pos_gap.size

    z_part = zsl[pos_gap].astype(np.uint32) << _SL_SHIFT
    g = grad_thr[g_pos].astype(np.uint32)
    gap_cols = np.zeros((n_or, n_gap_pad), np.uint32)
    gap_cols[0, :sg] = z_part | g[:sg]
    if mirror:
        gap_cols[1, :sg] = z_part | g[sg:]

    tfg = ((tfg_bits[h_pos >> 3] >> (h_pos & 7)) & 1).astype(bool)
    if keep_he is not None:
        tfg &= keep_he
    sh = h_pos.size // n_or
    he_cols = np.empty((n_or, n_he_words), np.uint32)
    he_cols[0] = _packbits32(tfg[:sh], n_he_words)
    if mirror:
        he_cols[1] = _packbits32(tfg[sh:], n_he_words)
    return gap_cols, he_cols


def select_target_tile_from_store(store, rows, pos_gap: np.ndarray,
                                  n_gap_pad: int, n_he_words: int,
                                  gather_plan, *, mirror: bool = True):
    """Whole-dispatch-tile pack straight from a ShapePackStore: ONE
    threaded native pass (or, without the native library, one
    vectorized 2D gather per field) for T store rows, producing the
    assembled (t_gap uint32 [n_or, Sg_pad, T], t_he uint32
    [n_or, W, T]) host planes.  Both paths are bit-identical
    (tests/test_torch_shape.py)."""
    g_pos, h_pos, keep_he = gather_plan
    n_or = 2 if mirror else 1
    t = len(rows)
    sg = pos_gap.size
    sh = h_pos.size // n_or

    from colormipsearch_tpu_torch.io import native_decoder

    if native_decoder.available():
        zsl_mm, grad_mm, tfg_mm = store.field_maps()
        native = native_decoder.shape_tile_from_store(
            zsl_mm, grad_mm, tfg_mm, np.asarray(rows, np.int64),
            pos_gap, g_pos, h_pos, keep_he, n_or, n_gap_pad,
            n_he_words, _SL_SHIFT)
        if native is not None:
            return native

    zsl = store.gather("zsl", rows, pos_gap)           # [T, Sg]
    grad = store.gather("grad", rows, g_pos)           # [T, n_or*Sg]
    tbytes = store.gather("tfg", rows, h_pos >> 3)     # [T, n_or*Sh]
    tfg = ((tbytes >> (h_pos & 7)[None, :]) & 1).astype(bool)
    if keep_he is not None:
        tfg &= keep_he[None, :]

    z_part = zsl.astype(np.uint32) << _SL_SHIFT
    t_gap = np.zeros((n_or, n_gap_pad, t), np.uint32)
    t_gap[0, :sg] = (z_part | grad[:, :sg]).T
    if mirror:
        t_gap[1, :sg] = (z_part | grad[:, sg:]).T
    t_he = np.empty((n_or, n_he_words, t), np.uint32)
    t_he[0] = _packbits32(tfg[:, :sh], n_he_words).T
    if mirror:
        t_he[1] = _packbits32(tfg[:, sh:], n_he_words).T
    return t_gap, t_he


def assemble_target_rows_split(cols: list, n_gap_pad: int,
                               n_he_words: int, *, mirror: bool = True):
    """Stack per-target select_target_cols_split outputs into the
    (t_gap uint32 [n_or, Sg_pad, T], t_he uint32 [n_or, W, T]) host
    planes shape_score_pairs_split consumes."""
    n_or = 2 if mirror else 1
    if not cols:
        return (np.zeros((n_or, n_gap_pad, 0), np.uint32),
                np.zeros((n_or, n_he_words, 0), np.uint32))
    t_gap = np.stack([c[0] for c in cols], axis=2)
    t_he = np.stack([c[1] for c in cols], axis=2)
    return t_gap, t_he


def pack_target_rows_split(t_rgbs, grads, zgap_rgbs,
                           pos_gap: np.ndarray, n_gap_pad: int,
                           pos_he: np.ndarray, n_he_words: int, *,
                           mask_threshold: int,
                           excluded: np.ndarray | None = None,
                           mirror: bool = True):
    """Split-plane target pack: (t_gap uint32 [n_or, Sg_pad, T],
    t_he uint32 [n_or, n_he_words, T]) with n_or = 2 (straight,
    mirror) or 1.

    Composition of select_target_cols_split + assemble_target_rows_split
    (the engine calls those directly from its decode workers)."""
    cols = [select_target_cols_split(
                t, g, z, pos_gap, n_gap_pad, pos_he, n_he_words,
                mask_threshold=mask_threshold, excluded=excluded,
                mirror=mirror)
            for t, g, z in zip(t_rgbs, grads, zgap_rgbs)]
    return assemble_target_rows_split(cols, n_gap_pad, n_he_words,
                                      mirror=mirror)


# -------------------------------------------------------------------------
# helpers of the plain versions
# -------------------------------------------------------------------------


def _wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 modulo 2^32 (the wrap of an int32 sum)."""
    return (((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int32 word (as uint32), int64."""
    x = x.long() & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (x * 0x01010101 & 0xFFFFFFFF) >> 24


# -------------------------------------------------------------------------
# K5: split-row pair scoring
# -------------------------------------------------------------------------


def shape_score_pairs_split_plain(t_gap, q_gap, t_he, q_he, *,
                                  chunk: int = 2048):
    """Plain PyTorch version of K5 (see shape_score_pairs_split). Walks
    the rows in `chunk`-row slices so its int64 intermediates stay
    bounded at production shapes."""
    n_or, sg, t = t_gap.shape
    n_words = t_he.shape[1]
    dev = t_gap.device
    lo = torch.zeros((n_or, t), dtype=torch.int64, device=dev)
    hi = torch.zeros_like(lo)
    he = torch.zeros_like(lo)
    for o in range(n_or):
        for r0 in range(0, sg, chunk):
            w = t_gap[o, r0:r0 + chunk].long()   # sign-extended int32
            grad = w & 0xFFFF
            z_sl = w >> _SL_SHIFT                # nothing above the slice
            q = q_gap[o, r0:r0 + chunk, None].long()
            q_sl = q & _Q_SL_MASK
            q_nz = (q >> _Q_NZ_SHIFT) & 1
            q_sig = (q >> _Q_SIG_SHIFT) & 1
            d = (q_sl - z_sl).abs()
            cond = (q_nz == 1) & (z_sl > 0) & (d >= 2 * DEFAULT_COLOR_FLUX)
            val = torch.where(cond, d - DEFAULT_COLOR_FLUX,
                              torch.where(q_sig == 1, grad,
                                          torch.zeros_like(grad)))
            lo[o] += (val & 0x3FF).sum(0)
            hi[o] += (val >> 10).sum(0)
        for r0 in range(0, n_words, chunk):
            gated = t_he[o, r0:r0 + chunk] & q_he[o, r0:r0 + chunk, None]
            he[o] += _popcount32(gated).sum(0)
    return _wrap_int32(hi), _wrap_int32(lo), _wrap_int32(he)


def shape_score_pairs_split(t_gap, q_gap, t_he, q_he, *,
                            stacked: bool = False):
    """K5: split-row scoring of one query against T targets, both
    orientations in one call.

    t_gap int32 [n_or, Sg, T] (uint32 bits: gradient | slice << 16),
    q_gap int32 [n_or, Sg] (query slice | nz | sig), t_he int32
    [n_or, W, T] (bitpacked ring-row foreground bits), q_he int32
    [n_or, W] (bitpacked ring-row gates), n_or 2 (straight, mirror) or
    1. Returns (gap_hi, gap_lo, high_expr) int32 [n_or, T], or with
    `stacked` the three as one int32 [3, n_or, T] (the mesh steps
    concatenate their shards' once); the gradient area gap is gap_hi *
    1024 + gap_lo (combine_gap). CPU tensors run the plain version; CUDA
    tensors launch kernels/csrc/shape_split.cu or raise.
    """
    if t_gap.dim() != 3 or t_he.dim() != 3:
        raise ValueError(f"expected [n_or, rows, T] planes, got t_gap "
                         f"{tuple(t_gap.shape)}, t_he {tuple(t_he.shape)}")
    n_or, sg, t = t_gap.shape
    n_words = t_he.shape[1]
    kbuild.check_tensor(t_gap, "t_gap", torch.int32)
    kbuild.check_tensor(q_gap, "q_gap", torch.int32, (n_or, sg))
    kbuild.check_tensor(t_he, "t_he", torch.int32, (n_or, n_words, t))
    kbuild.check_tensor(q_he, "q_he", torch.int32, (n_or, n_words))
    kbuild.same_device(t_gap, q_gap, t_he, q_he)
    if n_or not in (1, 2):
        raise ValueError(f"n_or={n_or}: expected 1 or 2 orientations")
    if t_gap.device.type == "cpu":
        got = shape_score_pairs_split_plain(t_gap, q_gap, t_he, q_he)
        return torch.stack(got) if stacked else got
    kbuild.require_cuda(t_gap)
    out = torch.empty((3, n_or, t), dtype=torch.int32, device=t_gap.device)
    lib = kbuild.load_library()
    kbuild.check(lib.cmst_shape_split(
        t_gap.data_ptr(), q_gap.data_ptr(), t_he.data_ptr(),
        q_he.data_ptr(), n_or, sg, n_words, t, out.data_ptr(),
        kbuild.stream_of(t_gap)), "shape_score_pairs_split")
    kbuild.count_launch("shape_score_pairs_split")
    return out if stacked else tuple(out.unbind(0))


# -------------------------------------------------------------------------
# row 18b: dense-row pair scoring
# -------------------------------------------------------------------------


def _shape_dense_plain(t_pack, q_pack, *, chunk: int = 2048):
    """[n_or, S, T] x [n_or, S] -> 3 x int32 [n_or, T], in `chunk`-row
    slices so the int64 intermediates stay bounded."""
    n_or, n_rows, t = t_pack.shape
    dev = t_pack.device
    hi = torch.zeros((n_or, t), dtype=torch.int64, device=dev)
    lo = torch.zeros_like(hi)
    he = torch.zeros_like(hi)
    for o in range(n_or):
        for r0 in range(0, n_rows, chunk):
            w = t_pack[o, r0:r0 + chunk].long()      # sign-extended int32
            grad = w & 0xFFFF
            z_sl = (w >> _SL_SHIFT) & 0x1FF
            z_nz = (w >> _ZNZ_SHIFT) & 1
            t_fg = (w >> _TFG_SHIFT) & 1
            q = q_pack[o, r0:r0 + chunk, None].long()
            q_sl = q & _Q_SL_MASK
            q_nz = (q >> _Q_NZ_SHIFT) & 1
            q_sig = (q >> _Q_SIG_SHIFT) & 1
            q_he = (q >> _Q_HE_SHIFT) & 1
            sg = torch.where((q_sl == 0) | (z_sl == 0), z_sl,
                             (q_sl - z_sl).abs())
            overlap = (q_nz & z_nz) == 1
            grad_term = torch.where(q_sig == 1, grad, torch.zeros_like(grad))
            val = torch.where(overlap & (sg >= 2 * DEFAULT_COLOR_FLUX),
                              sg - DEFAULT_COLOR_FLUX, grad_term)
            lo[o] += (val & 0x3FF).sum(0)
            hi[o] += (val >> 10).sum(0)
            he[o] += (q_he & t_fg).sum(0)
    return _wrap_int32(hi), _wrap_int32(lo), _wrap_int32(he)


def _shape_dense(t_pack, q_pack, name: str, stacked: bool):
    """Validate and run row 18b on [n_or, S, T] planes: three int32
    [n_or, T], or one [3, n_or, T] when `stacked`."""
    n_or, n_rows, t = t_pack.shape
    kbuild.check_tensor(t_pack, "t_pack", torch.int32)
    kbuild.check_tensor(q_pack, "q_pack", torch.int32, (n_or, n_rows))
    kbuild.same_device(t_pack, q_pack)
    if n_or not in (1, 2):
        raise ValueError(f"n_or={n_or}: expected 1 or 2 orientations")
    if t_pack.device.type == "cpu":
        got = _shape_dense_plain(t_pack, q_pack)
        return torch.stack(got) if stacked else got
    kbuild.require_cuda(t_pack)
    out = torch.empty((3, n_or, t), dtype=torch.int32, device=t_pack.device)
    lib = kbuild.load_library()
    kbuild.check(lib.cmst_shape_dense(
        t_pack.data_ptr(), q_pack.data_ptr(), n_or, n_rows, t,
        out.data_ptr(), kbuild.stream_of(t_pack)), name)
    kbuild.count_launch("shape_score_pairs")
    return out if stacked else tuple(out.unbind(0))


def _dims(x, n: int, name: str) -> None:
    if x.dim() != n:
        raise ValueError(f"{name}: expected {n} dimensions, got "
                         f"{tuple(x.shape)}")


def shape_score_pairs_plain(t_pack, q_pack):
    """Plain PyTorch version of row 18b (see shape_score_pairs)."""
    return tuple(x[0] for x in _shape_dense_plain(t_pack[None],
                                                  q_pack[None]))


def shape_score_pairs(t_pack, q_pack, *, stacked: bool = False):
    """Row 18b: one query against T targets on dense packs.

    t_pack int32 [S, T] (uint32 bits of pack_targets' words, or the
    support rows of pack_target_rows), q_pack int32 [S] (pack_query's
    words at the same rows). Returns (gap_hi, gap_lo, high_expr) int32
    [T], or with `stacked` one int32 [3, T]; the gradient area gap is
    gap_hi * 1024 + gap_lo (combine_gap). CPU tensors run the plain
    version; CUDA tensors launch kernels/csrc/shape_dense.cu or raise."""
    _dims(t_pack, 2, "t_pack")
    out = _shape_dense(t_pack[None], q_pack[None], "shape_score_pairs",
                       True)[:, 0]
    return out if stacked else tuple(out.unbind(0))


def shape_score_pairs_both_plain(t_pack2, q_pack2):
    """Plain PyTorch version of row 18b's two-orientation form."""
    return _shape_dense_plain(t_pack2, q_pack2)


def shape_score_pairs_both(t_pack2, q_pack2, *, stacked: bool = False):
    """Row 18b, both orientations in one launch: int32 [2, S, T] stacked
    (straight, mirror) planes x int32 [2, S] query planes -> (gap_hi,
    gap_lo, high_expr) int32 [2, T] each, or with `stacked` one int32
    [3, 2, T]. CPU tensors run the plain version; CUDA tensors launch
    kernels/csrc/shape_dense.cu or raise."""
    _dims(t_pack2, 3, "t_pack2")
    return _shape_dense(t_pack2, q_pack2, "shape_score_pairs_both", stacked)


def combine_gap(gap_hi: np.ndarray, gap_lo: np.ndarray) -> np.ndarray:
    return gap_hi.astype(np.int64) * 1024 + gap_lo.astype(np.int64)


def _select_orientation(hi, lo, he):
    """Reference mirror selection on stacked [2, T] (or [1, T]) scores:
    lower negative score wins, straight on ties
    (ShapeMatchColorDepthSearchAlgorithm:172-179)."""
    gap = combine_gap(hi, lo)
    he = he.astype(np.int64)
    if gap.shape[0] == 1:
        return gap[0], he[0], np.zeros(gap.shape[1], bool)
    neg = gap + he // 2
    use_m = neg[1] < neg[0]
    return (np.where(use_m, gap[1], gap[0]),
            np.where(use_m, he[1], he[0]), use_m)


def _on_device(arrays, device: torch.device) -> list:
    """Host (numpy) arrays uploaded to `device`; tensors as they are."""
    from colormipsearch_tpu_torch import convert

    return [a if isinstance(a, torch.Tensor) else convert.as_tensor(a, device)
            for a in arrays]


def _pull(outs) -> list:
    return [a.cpu().numpy() for a in outs]


def score_shape_batch(t_pack, t_pack_mirror, q_pack, *, mirror: bool,
                      device: torch.device, q_pack_mirror=None,
                      pairs_fn=None):
    """Dense-row scoring of one query vs T targets, both orientations, with
    the reference's mirror selection: the orientation with the LOWER
    negative score wins, straight on ties
    (ShapeMatchColorDepthSearchAlgorithm:172-179). Returns
    (gradient_area_gap int64 [T], high_expression_area int64 [T],
    mirrored bool [T]).

    q_pack_mirror: only needed with an ROI mask (the query packed with a
    flipped ROI); without ROI both orientations share q_pack. pairs_fn:
    the (t_pack, q_pack) -> (hi, lo, he) step, given the target planes
    as they are and the query on `device` (the mesh's
    make_sharded_shape_step plugs in here after cutting the planes);
    default shape_score_pairs on the planes uploaded to `device`."""
    if pairs_fn is None:
        def pairs_fn(t, q):
            return shape_score_pairs(*_on_device((t,), device), q)

    def run(t, q):
        hi, lo, he = _pull(pairs_fn(t, *_on_device((q,), device)))
        return combine_gap(hi, lo), he.astype(np.int64)

    gap_s, he_s = run(t_pack, q_pack)
    if not mirror:
        return gap_s, he_s, np.zeros(gap_s.shape, bool)
    gap_m, he_m = run(t_pack_mirror,
                      q_pack if q_pack_mirror is None else q_pack_mirror)
    neg_s = gap_s + he_s // 2
    neg_m = gap_m + he_m // 2
    use_m = neg_m < neg_s
    return (np.where(use_m, gap_m, gap_s), np.where(use_m, he_m, he_s),
            use_m)


def score_shape_batch_stacked(t_rows, q_pack, *, mirror: bool,
                              device: torch.device, q_pack_mirror=None,
                              pairs_both_fn=None, pairs_fn=None):
    """Stacked-plane form of score_shape_batch: t_rows is the [2, S, T]
    (or [1, S, T] when mirror=False) output of pack_target_rows; both
    orientations score in ONE call (shape_score_pairs_both). Same mirror
    selection semantics."""
    if not mirror:
        return score_shape_batch(t_rows[0], None, q_pack, mirror=False,
                                 device=device, pairs_fn=pairs_fn)
    if pairs_both_fn is None:
        def pairs_both_fn(t, q):
            return shape_score_pairs_both(*_on_device((t,), device), q)
    q2 = np.stack([q_pack, q_pack if q_pack_mirror is None
                   else q_pack_mirror])
    return _select_orientation(*_pull(pairs_both_fn(
        t_rows, *_on_device((q2,), device))))


def score_shape_batch_split(t_gap, t_he, q_gap, q_he, *,
                            device: torch.device, pairs_split_fn=None):
    """Split-row scoring of one query vs T targets with the reference's
    mirror selection.  Host (numpy) planes upload to `device`; tensors
    already there (the device-store path) are used as they are.  q_gap /
    q_he are the stacked [n_or, ...] query planes.  pairs_split_fn: the
    (t_gap, q_gap, t_he, q_he) -> (hi, lo, he) step (the mesh's
    make_sharded_shape_split_step plugs in here, and takes the target
    planes as they are); default shape_score_pairs_split.  Returns
    (gradient_area_gap int64 [T], high_expression_area int64 [T],
    mirrored bool [T])."""
    if pairs_split_fn is None:
        def pairs_split_fn(t_g, q_g, t_h, q_h):
            t_g, t_h = _on_device((t_g, t_h), device)
            return shape_score_pairs_split(t_g, q_g, t_h, q_h)
    q_gap, q_he = _on_device((q_gap, q_he), device)
    return _select_orientation(*_pull(pairs_split_fn(t_gap, q_gap, t_he,
                                                     q_he)))


# -------------------------------------------------------------------------
# K7: device-resident store fields, uploaded pixel-major
# -------------------------------------------------------------------------

# numpy dtype of a store field -> (torch dtype of the same bits, numpy view)
_FIELD_TYPES = {np.dtype(np.uint16): (torch.int16, np.int16),
                np.dtype(np.uint8): (torch.uint8, np.uint8)}


def upload_pixel_major_chunk_plain(buf, chunk, p0: int) -> None:
    """Plain PyTorch version of K7: buf[p0:p0+n] = chunk.T."""
    buf[p0:p0 + chunk.shape[1]] = chunk.T


def upload_pixel_major_chunk(buf, chunk, p0: int) -> None:
    """K7: write one [R, n] row slice of a store field, transposed, into
    the pixel-major [n_px, R] buffer at pixel offset p0 (in place).
    int16 (uint16 bits) or uint8, both on one device. CPU tensors run the
    plain version; CUDA tensors launch kernels/csrc/pixel_major.cu or
    raise."""
    if buf.dim() != 2 or chunk.dim() != 2:
        raise ValueError(f"expected 2-d tensors, got buf "
                         f"{tuple(buf.shape)}, chunk {tuple(chunk.shape)}")
    n_px, n_r = buf.shape
    n = chunk.shape[1]
    if buf.dtype not in (torch.int16, torch.uint8):
        raise TypeError(f"buf: expected int16 or uint8, got {buf.dtype}")
    kbuild.check_tensor(buf, "buf", buf.dtype)
    kbuild.check_tensor(chunk, "chunk", buf.dtype, (n_r, n))
    kbuild.same_device(buf, chunk)
    if not 0 <= p0 <= n_px - n:
        raise ValueError(f"pixels [{p0}, {p0 + n}) outside [0, {n_px})")
    if buf.device.type == "cpu":
        upload_pixel_major_chunk_plain(buf, chunk, p0)
        return
    kbuild.require_cuda(buf)
    if n == 0 or n_r == 0:
        return
    lib = kbuild.load_library()
    kbuild.check(lib.cmst_pixel_major(
        chunk.data_ptr(), n_r, n, buf.data_ptr(), n_px, p0,
        buf.element_size(), kbuild.stream_of(buf)),
        "upload_pixel_major_chunk")
    kbuild.count_launch("upload_pixel_major")


def upload_pixel_major(field_mm: np.ndarray, device: torch.device,
                       chunk_bytes: int = 256 << 20) -> torch.Tensor:
    """A [R, n_px] store field (memmap) -> its pixel-major [n_px, R]
    tensor on `device`, in slices of at most `chunk_bytes`.

    Each [R, n] row slice is copied as it is (no host transpose) and K7
    transposes it into place. On a CUDA device the slices pass through
    ONE pinned host buffer of chunk size: the next slice is read from
    the memmap while the card transposes the previous one, and the host
    pins at most one chunk whatever the store's size."""
    n_r, n_px = field_mm.shape
    t_dtype, np_view = _FIELD_TYPES[np.dtype(field_mm.dtype)]
    device = torch.device(device)
    buf = torch.empty((n_px, n_r), dtype=t_dtype, device=device)
    if n_r == 0 or n_px == 0:
        return buf
    itemsize = field_mm.dtype.itemsize
    rows_per = min(n_px, max(1, int(chunk_bytes // (n_r * itemsize))))
    src = field_mm.view(np_view)
    if device.type != "cuda":
        for p0 in range(0, n_px, rows_per):
            chunk = np.array(src[:, p0:p0 + rows_per])  # a writable copy
            upload_pixel_major_chunk(buf, torch.from_numpy(chunk), p0)
        return buf
    host = torch.empty(n_r * rows_per, dtype=t_dtype, pin_memory=True)
    host_np = host.numpy()
    staged = torch.empty(n_r * rows_per, dtype=t_dtype, device=device)
    copied = None
    for p0 in range(0, n_px, rows_per):
        n = min(rows_per, n_px - p0)
        if copied is not None:
            copied.synchronize()  # the pinned buffer is free again
        np.copyto(host_np[:n_r * n].reshape(n_r, n), src[:, p0:p0 + n])
        chunk = staged[:n_r * n].view(n_r, n)
        chunk.copy_(host[:n_r * n].view(n_r, n), non_blocking=True)
        copied = torch.cuda.Event()
        copied.record()
        upload_pixel_major_chunk(buf, chunk, p0)
    copied.synchronize()
    return buf


def device_store_fields(store, device: torch.device, rows=None):
    """Upload a ShapePackStore's query-independent fields ONCE as
    pixel-major tensors on `device`: (zsl int16 [n_px, R], grad int16
    [n_px, R], tfg uint8 [ceil(n_px/8), R]), uint16 values held as int16
    bits.  With the fields resident, each mask's dispatch planes are
    built on the device (shape_tile_device) from the mask's support
    positions alone.  ``rows`` restricts the upload to a subset of store
    rows (the device tile then indexes positions WITHIN that subset)."""
    zsl_mm, grad_mm, tfg_mm = store.field_maps()
    if rows is not None:
        rows = np.asarray(rows)
        zsl_mm = zsl_mm[rows]
        grad_mm = grad_mm[rows]
        tfg_mm = tfg_mm[rows]
    return tuple(upload_pixel_major(f, device)
                 for f in (zsl_mm, grad_mm, tfg_mm))


# -------------------------------------------------------------------------
# K6: dispatch planes from device-resident store fields
# -------------------------------------------------------------------------


class TilePositions(typing.NamedTuple):
    """A mask's support positions padded to the plane sizes, on the
    device (tile_positions): pad entries are index 0 and are zeroed by
    the live counts sg / sh."""
    pos_gap: torch.Tensor     # int32 [n_gap_pad]
    g_pos: torch.Tensor       # int32 [n_or * n_gap_pad]
    h_pos: torch.Tensor       # int32 [n_or * n_he_words * 32]
    keep_he: torch.Tensor     # uint8 [n_or * n_he_words * 32]
    sg: int
    sh: int
    n_or: int
    max_px: int               # largest pixel index referenced (-1: none)


def tile_positions(pos_gap: np.ndarray, g_pos: np.ndarray,
                   h_pos: np.ndarray, keep_he: np.ndarray | None, *,
                   n_gap_pad: int, n_he_words: int, mirror: bool,
                   device: torch.device) -> TilePositions:
    """Pad a mask's gather plan (split_gather_plan) to the plane sizes
    and upload it once per mask group."""
    n_or = 2 if mirror else 1
    sg = pos_gap.size
    sh = h_pos.size // n_or
    shp = n_he_words * 32
    if sg > n_gap_pad or sh > shp:
        raise ValueError(f"{sg} gap rows / {sh} ring rows exceed "
                         f"{n_gap_pad} / {shp}")
    pos_gap_p = np.zeros(n_gap_pad, np.int32)
    pos_gap_p[:sg] = pos_gap
    g_pos_p = np.zeros(n_or * n_gap_pad, np.int32)
    h_pos_p = np.zeros(n_or * shp, np.int32)
    keep_p = np.zeros(n_or * shp, np.uint8)
    for o in range(n_or):
        g_pos_p[o * n_gap_pad:o * n_gap_pad + sg] = \
            g_pos[o * sg:(o + 1) * sg]
        h_pos_p[o * shp:o * shp + sh] = h_pos[o * sh:(o + 1) * sh]
        keep_p[o * shp:o * shp + sh] = \
            1 if keep_he is None else keep_he[o * sh:(o + 1) * sh]
    used = [a for a in (pos_gap, g_pos, h_pos) if a.size]
    max_px = max((int(a.max()) for a in used), default=-1)
    if used and min(int(a.min()) for a in used) < 0:
        raise ValueError("negative pixel position in the gather plan")
    return TilePositions(*(torch.from_numpy(a).to(device)
                           for a in (pos_gap_p, g_pos_p, h_pos_p, keep_p)),
                         sg, sh, n_or, max_px)


def shape_tile_device_plain(fields, rows_sel, tp: TilePositions, *,
                            n_gap_pad: int, n_he_words: int,
                            chunk_words: int = 256):
    """Plain PyTorch version of K6 (see shape_tile_device). Packs the
    ring words in `chunk_words` slices so its intermediates stay bounded
    at production shapes."""
    zsl, grad, tfg = fields
    rows = rows_sel.long()
    t = rows.shape[0]
    dev = zsl.device
    live_g = (torch.arange(n_gap_pad, device=dev) < tp.sg)[:, None]
    zs = zsl.index_select(0, tp.pos_gap.long()).index_select(1, rows)
    z_part = (zs.to(torch.int32) & 0xFFFF) << _SL_SHIFT      # [Sgp, T]
    g = grad.index_select(0, tp.g_pos.long()).index_select(1, rows) \
        .to(torch.int32) & 0xFFFF                          # [n_or*Sgp, T]
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    t_gap = torch.stack([
        torch.where(live_g, z_part | g[o * n_gap_pad:(o + 1) * n_gap_pad],
                    zero) for o in range(tp.n_or)])

    shp = n_he_words * 32
    shifts = torch.arange(32, dtype=torch.int64, device=dev)[None, :, None]
    t_he = torch.empty((tp.n_or, n_he_words, t), dtype=torch.int32,
                       device=dev)
    for o in range(tp.n_or):
        for w0 in range(0, n_he_words, chunk_words):
            w1 = min(n_he_words, w0 + chunk_words)
            j = torch.arange(w0 * 32, w1 * 32, device=dev)
            hp = tp.h_pos[o * shp + j].long()
            tb = tfg.index_select(0, hp >> 3).index_select(1, rows).long()
            bits = (tb >> (hp & 7)[:, None]) & 1
            bits = bits * tp.keep_he[o * shp + j].long()[:, None]
            bits = torch.where((j < tp.sh)[:, None], bits,
                               torch.zeros_like(bits))
            words = (bits.reshape(w1 - w0, 32, t) << shifts).sum(1)
            t_he[o, w0:w1] = _wrap_int32(words)
    return t_gap, t_he


def shape_tile_device(fields, rows_sel, tp: TilePositions, *,
                      n_gap_pad: int, n_he_words: int):
    """K6: the (t_gap int32 [n_or, n_gap_pad, T], t_he int32
    [n_or, n_he_words, T]) dispatch planes (uint32 bits) of T store rows
    built from device-resident fields (device_store_fields), bit-identical
    to select_target_tile_from_store on the same rows; pad rows are zero.
    rows_sel int32 [T] indexes the fields' R axis; on the fields' device,
    or on the host, where its range is checked without waiting for the
    card before it is copied over. CPU fields run the plain version;
    CUDA fields launch kernels/csrc/shape_tile.cu or raise."""
    zsl, grad, tfg = fields
    if zsl.dim() != 2:
        raise ValueError(f"zsl: expected [n_px, R], got {tuple(zsl.shape)}")
    n_px, n_r = zsl.shape
    t = rows_sel.shape[0] if rows_sel.dim() == 1 else -1
    shp = n_he_words * 32
    kbuild.check_tensor(zsl, "zsl", torch.int16)
    kbuild.check_tensor(grad, "grad", torch.int16, (n_px, n_r))
    kbuild.check_tensor(tfg, "tfg", torch.uint8, (-(-n_px // 8), n_r))
    kbuild.check_tensor(rows_sel, "rows_sel", torch.int32, (t,))
    kbuild.check_tensor(tp.pos_gap, "pos_gap", torch.int32, (n_gap_pad,))
    kbuild.check_tensor(tp.g_pos, "g_pos", torch.int32,
                        (tp.n_or * n_gap_pad,))
    kbuild.check_tensor(tp.h_pos, "h_pos", torch.int32, (tp.n_or * shp,))
    kbuild.check_tensor(tp.keep_he, "keep_he", torch.uint8,
                        (tp.n_or * shp,))
    kbuild.same_device(zsl, grad, tfg, tp.pos_gap, tp.g_pos, tp.h_pos,
                       tp.keep_he)
    if rows_sel.device.type != "cpu":
        kbuild.same_device(zsl, rows_sel)
    if tp.n_or not in (1, 2) or not 0 <= tp.sg <= n_gap_pad \
            or not 0 <= tp.sh <= shp:
        raise ValueError(f"positions (n_or {tp.n_or}, sg {tp.sg}, sh "
                         f"{tp.sh}) do not fit the planes")
    if tp.max_px >= n_px:
        raise ValueError(f"pixel {tp.max_px} outside the fields' {n_px}")
    if t:
        lo, hi = (int(v) for v in torch.aminmax(rows_sel))
        if lo < 0 or hi >= n_r:
            raise ValueError(f"rows_sel outside the fields' {n_r} rows")
    if zsl.device.type == "cpu":
        return shape_tile_device_plain(fields, rows_sel, tp,
                                       n_gap_pad=n_gap_pad,
                                       n_he_words=n_he_words)
    kbuild.require_cuda(zsl)
    dev = zsl.device
    # rows on the host were range-checked there, without reading the card
    rows_sel = rows_sel.to(dev, non_blocking=True)
    t_gap = torch.empty((tp.n_or, n_gap_pad, t), dtype=torch.int32,
                        device=dev)
    t_he = torch.empty((tp.n_or, n_he_words, t), dtype=torch.int32,
                       device=dev)
    lib = kbuild.load_library()
    kbuild.check(lib.cmst_shape_tile(
        zsl.data_ptr(), grad.data_ptr(), tfg.data_ptr(), n_r,
        rows_sel.data_ptr(), t, tp.pos_gap.data_ptr(), tp.g_pos.data_ptr(),
        tp.h_pos.data_ptr(), tp.keep_he.data_ptr(), tp.n_or, n_gap_pad,
        n_he_words, tp.sg, tp.sh, t_gap.data_ptr(), t_he.data_ptr(),
        kbuild.stream_of(zsl)), "shape_tile_device")
    kbuild.count_launch("shape_tile_device")
    return t_gap, t_he
