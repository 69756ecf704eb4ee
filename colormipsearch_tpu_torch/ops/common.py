"""Target planes: pixel classification and the K1 and K8 packs.

Targets are packed into pixel-major planes, so that a query-position row
read yields the lane-contiguous words of all T targets (the JAX
package's ops/common.py):

  * rank-key planes, int32 [P+1, T]: each foreground pixel (any channel
    above the data threshold) holds the key (cls << KEY_RANK_BITS) |
    rank, where ``rank`` is the index of its hue ratio s/p in the sorted
    list of ALL achievable ratios; every other element, and the sentinel
    row P, is 0;
  * summary planes, [P, T] words (cls << 24) | (p << 16) | (s << 8) |
    maxch, held as int32 with the bits of the JAX package's uint32, for
    the banded predicate (ops/pixel_match.score_query_batch);
  * split planes, the pair uint16 [P, T] (p << 8) | s, held as int16
    with the same bits (torch's uint16 lacks most operations), and uint8
    [P, T] cls, for the split-plane predicate
    (ops/pixel_match.score_query_batch_split).

The default key upload is sparse: only foreground pixels travel to the
device as COO (position, RGB) elements, and the K1 kernel
(kernels/csrc/scatter_keys.cu) classifies and scatters them into the
planes. The dense uint8 stack goes to the device for the summary planes
and, with CDS_DENSE_UPLOAD=1, for the key planes; K8
(kernels/csrc/pack_planes.cu) packs it in any of the three encodings.
K12 (kernels/csrc/repack_planes.cu) re-encodes planes already on the
device: summary planes to the split pair or to key planes, key planes
to the split key pair (ops/pixel_match.split_key_planes).
"""

from __future__ import annotations

import functools
import time
from fractions import Fraction

import numpy as np
import torch

from colormipsearch_tpu_torch.constants import (
    CLASS_BG,
    CLASS_BR,
    CLASS_GB,
    CLASS_GR,
    CLASS_RB,
    CLASS_RG,
)
from colormipsearch_tpu_torch.kernels import build as kbuild

KEY_RANK_BITS = 15


def classify(rgb: torch.Tensor):
    """uint8 [..., 3] -> (cls, s, p, maxch) int32 tensors.

    Same strict-dominance classification as the pixel-match oracle: ties
    (including black) produce class 0 with s = p = 0.
    """
    r = rgb[..., 0].to(torch.int32)
    g = rgb[..., 1].to(torch.int32)
    b = rgb[..., 2].to(torch.int32)
    zero = torch.zeros_like(r)

    b_dom = (b > r) & (b > g)
    g_dom = (g > b) & (g > r)
    r_dom = (r > b) & (r > g)
    rg_gt = r > g
    bg_gt = b > r
    gb_gt = g > b

    cls = torch.where(
        b_dom, torch.where(rg_gt, CLASS_BR, CLASS_BG),
        torch.where(
            g_dom, torch.where(bg_gt, CLASS_GB, CLASS_GR),
            torch.where(r_dom, torch.where(gb_gt, CLASS_RG, CLASS_RB),
                        zero))).to(torch.int32)
    p = torch.where(b_dom, b, torch.where(g_dom, g,
                                          torch.where(r_dom, r, zero)))
    s = torch.where(
        b_dom, torch.where(rg_gt, r, g),
        torch.where(
            g_dom, torch.where(bg_gt, b, r),
            torch.where(r_dom, torch.where(gb_gt, g, b), zero)))
    maxch = torch.maximum(torch.maximum(r, g), b)
    return cls, s, p, maxch


@functools.lru_cache(maxsize=1)
def ratio_rank_table():
    """(vals float64 [R], rank int32 [256, 256]) for ratios s/p, s < p.

    `vals` is sorted ascending (vals[0] == 0.0); rank[s, p] is the index
    of float64(s/p) in vals.  Distinct rationals stay distinct in f64
    (the minimum spacing of fractions with denominators <= 255 is
    ~1.5e-5, ~1e11 ulps), so f64 order == rational order.  Entries with
    s >= p or p == 0 are unreachable (strict dominance) and map to 0.
    """
    sv, pv = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    valid = (pv >= 1) & (sv < pv)
    r = sv / np.maximum(pv, 1)
    vals = np.unique(r[valid])
    assert vals.size < (1 << KEY_RANK_BITS), vals.size
    rank = np.zeros((256, 256), np.int32)
    rank[valid] = np.searchsorted(vals, r[valid]).astype(np.int32)
    return vals, rank


@functools.lru_cache(maxsize=1)
def _rank_lut_flat():
    _, rank = ratio_rank_table()
    return np.ascontiguousarray(rank.reshape(-1))


def rank_lut_tensor(device: torch.device) -> torch.Tensor:
    """The (s << 8) | p -> rank LUT as an int32 [65536] tensor."""
    return torch.from_numpy(_rank_lut_flat()).to(device)


def pack_summary(cls, s, p, maxch) -> torch.Tensor:
    """Pack a classification into the summary word
    (cls << 24) | (p << 16) | (s << 8) | maxch, as int32 (the bits of
    the JAX package's uint32 word: cls < 8, so the sign bit is 0)."""
    return ((cls << 24) | (p << 16) | (s << 8) | maxch).to(torch.int32)


def unpack_summary(packed: torch.Tensor):
    """Summary words -> (cls, s, p, maxch) int32."""
    v = packed.to(torch.int32)
    return (v >> 24) & 0x7, (v >> 8) & 0xFF, (v >> 16) & 0xFF, v & 0xFF


def _lo16_hi8(words: torch.Tensor):
    """int32 words -> (int16 holding the bits of the uint16 bits 0-15,
    uint8 bits 16-23): the two planes of a split encoding."""
    lo = words & 0xFFFF
    return (((lo ^ 0x8000) - 0x8000).to(torch.int16),
            ((words >> 16) & 0xFF).to(torch.uint8))


def _split_rows(src: torch.Tensor, word, rows: int = 1 << 16):
    """_lo16_hi8(word(src)) for int32 [n, cols] planes, `rows` rows at a
    time so that the intermediates stay bounded at production shapes."""
    n, cols = src.shape
    lo = torch.empty((n, cols), dtype=torch.int16, device=src.device)
    hi = torch.empty((n, cols), dtype=torch.uint8, device=src.device)
    for r0 in range(0, n, rows):
        lo[r0:r0 + rows], hi[r0:r0 + rows] = _lo16_hi8(word(src[r0:r0 + rows]))
    return lo, hi


def _packed_columns(rgb_stack: torch.Tensor, t_pad: int | None,
                    sentinel: bool, word, chunk: int = 32) -> torch.Tensor:
    """[P (+1 with `sentinel`), t_pad] int32 planes whose column t is
    word(rgb_stack[t0:t1]) reshaped, taken `chunk` targets at a time so
    that the intermediates stay bounded at production shapes; padding
    columns and the sentinel row are zero."""
    t = rgb_stack.shape[0]
    t_pad = t if t_pad is None else t_pad
    if t_pad < t:
        raise ValueError(f"t_pad {t_pad} < {t} targets")
    n_px = rgb_stack[0, ..., 0].numel() if t else 0
    planes = torch.zeros((n_px + int(sentinel), t_pad), dtype=torch.int32,
                         device=rgb_stack.device)
    for t0 in range(0, t, chunk):
        t1 = min(t, t0 + chunk)
        planes[:n_px, t0:t1] = word(rgb_stack[t0:t1]).reshape(t1 - t0,
                                                              -1).T
    return planes


def pack_target_planes_plain(rgb_stack: torch.Tensor,
                             data_threshold: int | None = None, *,
                             t_pad: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of K8's summary mode (see
    :func:`pack_target_planes`)."""
    def word(rgb):
        cls, s, p, maxch = classify(rgb)
        packed = pack_summary(cls, s, p, maxch)
        if data_threshold is None:
            return packed
        return torch.where(maxch > data_threshold, packed,
                           torch.zeros_like(packed))

    return _packed_columns(rgb_stack, t_pad, False, word)


def pack_target_planes_keys_plain(rgb_stack: torch.Tensor,
                                  data_threshold: int,
                                  rank_lut: torch.Tensor, *,
                                  t_pad: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of K8's key mode (see
    :func:`pack_target_planes_keys`); also the dense reference K1 is
    checked against."""
    def word(rgb):
        cls, s, p, maxch = classify(rgb)
        rank = rank_lut[((s << 8) | p).long()]
        key = (cls << KEY_RANK_BITS) | rank
        return torch.where((maxch > data_threshold) & (cls > 0), key,
                           torch.zeros_like(key)).to(torch.int32)

    return _packed_columns(rgb_stack, t_pad, True, word)


def pack_target_planes_split_plain(rgb_stack: torch.Tensor,
                                   data_threshold: int, *,
                                   t_pad: int | None = None):
    """Plain PyTorch version of K8's split mode (see
    :func:`pack_target_planes_split`)."""
    def word(rgb):
        cls, s, p, maxch = classify(rgb)
        both = (cls << 16) | (p << 8) | s
        return torch.where(maxch > data_threshold, both,
                           torch.zeros_like(both))

    return _split_rows(_packed_columns(rgb_stack, t_pad, False, word),
                       lambda w: w)


# K8's modes (kernels/csrc/pack_planes.cu): (C mode, launch counter)
_PACK_MODES = {"summary": (0, "pack_target_planes"),
               "keys": (1, "pack_target_planes_keys"),
               "split": (2, "pack_target_planes_split")}


def _pack_planes(rgb_stack, data_threshold, t_pad, mode: str,
                 rank_lut=None):
    """K8 (kernels/csrc/pack_planes.cu) in the given mode; CPU tensors
    take the plain version. The launch counts under the mode's public
    function name."""
    c_mode, name = _PACK_MODES[mode]
    if rgb_stack.dim() != 4:
        raise ValueError(f"rgb_stack: expected [T, H, W, 3], got "
                         f"{tuple(rgb_stack.shape)}")
    t, h, w = rgb_stack.shape[:3]
    kbuild.check_tensor(rgb_stack, "rgb_stack", torch.uint8, (t, h, w, 3))
    if mode == "keys":
        kbuild.check_tensor(rank_lut, "rank_lut", torch.int32, (1 << 16,))
        kbuild.same_device(rgb_stack, rank_lut)
    if t_pad is not None and t_pad < t:
        raise ValueError(f"t_pad {t_pad} < {t} targets")
    if rgb_stack.device.type == "cpu":
        if mode == "summary":
            return pack_target_planes_plain(rgb_stack, data_threshold,
                                            t_pad=t_pad)
        if mode == "keys":
            return pack_target_planes_keys_plain(rgb_stack, data_threshold,
                                                 rank_lut, t_pad=t_pad)
        return pack_target_planes_split_plain(rgb_stack, data_threshold,
                                              t_pad=t_pad)
    kbuild.require_cuda(rgb_stack)
    t_pad = t if t_pad is None else t_pad
    n_px = h * w
    dev = rgb_stack.device
    if mode == "split":
        out = (torch.empty((n_px, t_pad), dtype=torch.int16, device=dev),
               torch.empty((n_px, t_pad), dtype=torch.uint8, device=dev))
    else:
        rows = n_px + 1 if mode == "keys" else n_px
        out = (torch.empty((rows, t_pad), dtype=torch.int32, device=dev),)
    if not out[0].numel():
        return out if mode == "split" else out[0]
    thr = -1 if data_threshold is None else int(data_threshold)
    lib = kbuild.load_library()
    kbuild.check(lib.cmst_pack_planes(
        rgb_stack.data_ptr(), t, n_px, t_pad, max(thr, -1),
        c_mode, None if rank_lut is None else rank_lut.data_ptr(),
        out[0].data_ptr(), out[1].data_ptr() if len(out) > 1 else None,
        kbuild.stream_of(rgb_stack)), name)
    kbuild.count_launch(name)
    return out if mode == "split" else out[0]


def pack_target_planes(rgb_stack: torch.Tensor,
                       data_threshold: int | None = None, *,
                       t_pad: int | None = None) -> torch.Tensor:
    """K8, summary mode: uint8 [T, H, W, 3] -> int32 [P, t_pad] summary
    planes (the uint32 words of the JAX package's pack_target_planes,
    held as int32 with the same bits), columns >= T zero.

    With `data_threshold`, below-threshold pixels pack to the zero word
    (class 0 neither matches nor flags), and the scoring kernel runs with
    target_threshold=-1. CPU tensors run the plain version; CUDA tensors
    launch kernels/csrc/pack_planes.cu or raise.
    """
    return _pack_planes(rgb_stack, data_threshold, t_pad, "summary")


def pack_target_planes_keys(rgb_stack: torch.Tensor, data_threshold: int,
                            rank_lut: torch.Tensor, *,
                            t_pad: int | None = None) -> torch.Tensor:
    """K8, key mode: uint8 [T, H, W, 3] -> int32 [P+1, t_pad] rank-key
    planes (dense upload), columns >= T zero.

    The data threshold is ALWAYS folded (key 0 neither matches nor
    flags); row P is an all-zero sentinel so query plans can encode
    padded / out-of-bounds positions as P. CPU tensors run the plain
    version; CUDA tensors launch kernels/csrc/pack_planes.cu or raise.
    """
    return _pack_planes(rgb_stack, int(data_threshold), t_pad, "keys",
                        rank_lut)


def pack_target_planes_split(rgb_stack: torch.Tensor, data_threshold: int,
                             *, t_pad: int | None = None):
    """K8, split mode: uint8 [T, H, W, 3] -> (int16 [P, t_pad], the bits
    of the JAX package's uint16 (p << 8) | s; uint8 [P, t_pad] cls), the
    pair of pack_target_planes_split, columns >= T zero.

    The data threshold is ALWAYS folded (a dead pixel zeroes both
    planes). CPU tensors run the plain version; CUDA tensors launch
    kernels/csrc/pack_planes.cu or raise.
    """
    return _pack_planes(rgb_stack, int(data_threshold), t_pad, "split")


def split_planes_from_packed_plain(planes: torch.Tensor):
    """Plain PyTorch version of K12's split mode (see
    :func:`split_planes_from_packed`)."""
    return _split_rows(
        planes, lambda v: ((v >> 8) & 0xFFFF) | (((v >> 24) & 0x7) << 16))


def key_planes_from_packed_plain(planes: torch.Tensor,
                                 rank_lut: torch.Tensor, *,
                                 rows: int = 1 << 16) -> torch.Tensor:
    """Plain PyTorch version of K12's key mode (see
    :func:`key_planes_from_packed`), `rows` rows at a time."""
    n, cols = planes.shape
    out = torch.zeros((n + 1, cols), dtype=torch.int32, device=planes.device)
    for r0 in range(0, n, rows):
        r1 = min(n, r0 + rows)  # row n is the sentinel
        cls, s, p, _ = unpack_summary(planes[r0:r1])
        key = (cls << KEY_RANK_BITS) | rank_lut[((s << 8) | p).long()]
        out[r0:r1] = torch.where(cls > 0, key, torch.zeros_like(key))
    return out


def split_key_planes_plain(keys: torch.Tensor):
    """Plain PyTorch version of K12's split-key mode (see
    ops/pixel_match.split_key_planes)."""
    return _split_rows(keys, lambda v: (v & ((1 << KEY_RANK_BITS) - 1))
                       | (((v >> KEY_RANK_BITS) & 0xFF) << 16))


# K12's modes (kernels/csrc/repack_planes.cu): (C mode, plain version)
_REPACK_MODES = {
    "split_planes_from_packed": (0, split_planes_from_packed_plain),
    "key_planes_from_packed": (1, key_planes_from_packed_plain),
    "split_key_planes": (2, split_key_planes_plain),
}


def repack_planes(planes: torch.Tensor, name: str, rank_lut=None):
    """K12 (kernels/csrc/repack_planes.cu) in the mode of the public
    function `name` (a key of _REPACK_MODES); CPU tensors take the plain
    version."""
    mode, plain = _REPACK_MODES[name]
    kbuild.check_tensor(planes, "planes", torch.int32)
    if planes.dim() != 2:
        raise ValueError(f"planes: expected [rows, T], got "
                         f"{tuple(planes.shape)}")
    if rank_lut is not None:
        kbuild.check_tensor(rank_lut, "rank_lut", torch.int32, (1 << 16,))
        kbuild.same_device(planes, rank_lut)
    if planes.device.type == "cpu":
        return plain(planes) if rank_lut is None else plain(planes, rank_lut)
    kbuild.require_cuda(planes)
    rows, cols = planes.shape
    dev = planes.device
    if rank_lut is not None:
        out = (torch.empty((rows + 1, cols), dtype=torch.int32, device=dev),)
    else:
        out = (torch.empty((rows, cols), dtype=torch.int16, device=dev),
               torch.empty((rows, cols), dtype=torch.uint8, device=dev))
    lib = kbuild.load_library()
    kbuild.check(lib.cmst_repack_planes(
        mode, planes.data_ptr(), rows, cols,
        None if rank_lut is None else rank_lut.data_ptr(), out[0].data_ptr(),
        out[1].data_ptr() if len(out) > 1 else None,
        kbuild.stream_of(planes)), name)
    kbuild.count_launch(name)
    return out if len(out) > 1 else out[0]


def split_planes_from_packed(planes: torch.Tensor):
    """K12, split mode: int32 [P, T] summary planes -> the split pair
    (int16 [P, T] with the bits of (p << 8) | s, uint8 [P, T] cls), as
    the JAX package's split_planes_from_packed; a threshold folded into
    the summary words stays folded. CPU tensors run the plain version;
    CUDA tensors launch kernels/csrc/repack_planes.cu or raise."""
    return repack_planes(planes, "split_planes_from_packed")


def key_planes_from_packed(planes: torch.Tensor,
                           rank_lut: torch.Tensor) -> torch.Tensor:
    """K12, key mode: int32 [P, T] summary planes (threshold folded) ->
    int32 [P+1, T] rank-key planes with the zero sentinel row, as the JAX
    package's key_planes_from_packed. CPU tensors run the plain version;
    CUDA tensors launch kernels/csrc/repack_planes.cu or raise."""
    return repack_planes(planes, "key_planes_from_packed", rank_lut)


def scatter_key_planes_plain(pos: torch.Tensor, rgb: torch.Tensor,
                             cum: torch.Tensor, rank_lut: torch.Tensor, *,
                             n_px: int, t_pad: int) -> torch.Tensor:
    """Plain PyTorch version of K1 (see :func:`scatter_key_planes`)."""
    cls, s, p, _ = classify(rgb)
    rank = rank_lut[((s << 8) | p).long()]
    key = torch.where(cls > 0, (cls << KEY_RANK_BITS) | rank,
                      torch.zeros_like(cls)).to(torch.int32)
    gidx = torch.arange(pos.shape[0], dtype=torch.int64, device=pos.device)
    tidx = torch.searchsorted(cum, gidx, right=True).clamp_(max=t_pad - 1)
    planes = torch.zeros((n_px + 1, t_pad), dtype=torch.int32,
                         device=pos.device)
    planes[pos.long(), tidx] = key
    return planes


def scatter_key_planes(pos: torch.Tensor, rgb: torch.Tensor,
                       cum: torch.Tensor, rank_lut: torch.Tensor, *,
                       n_px: int, t_pad: int) -> torch.Tensor:
    """K1: COO foreground elements -> int32 [n_px + 1, t_pad] key planes.

    pos int32 [N] (pixel rows, < n_px), rgb uint8 [N, 3], cum int64
    [t_pad] (cumulative per-target element counts; elements arrive
    target-major), rank_lut int32 [65536]. CPU tensors run the plain
    version; CUDA tensors launch the kernel (kernels/csrc/scatter_keys.cu)
    or raise.

    Precondition of the kernel (not of the plain version): within each
    target's segment pos rises strictly, as coo_foreground returns it
    (the native select orders by (image, pixel), np.nonzero row-major);
    the kernel walks each column's segment with one cursor.
    """
    n = pos.shape[0]
    kbuild.check_tensor(pos, "pos", torch.int32, (n,))
    kbuild.check_tensor(rgb, "rgb", torch.uint8, (n, 3))
    kbuild.check_tensor(cum, "cum", torch.int64, (t_pad,))
    kbuild.check_tensor(rank_lut, "rank_lut", torch.int32, (1 << 16,))
    kbuild.same_device(pos, rgb, cum, rank_lut)
    if n >= 2 ** 31:
        raise ValueError(f"{n} COO elements (>= 2^31): split the shard")
    if pos.device.type == "cpu":
        return scatter_key_planes_plain(pos, rgb, cum, rank_lut,
                                        n_px=n_px, t_pad=t_pad)
    kbuild.require_cuda(pos)
    planes = torch.empty((n_px + 1, t_pad), dtype=torch.int32,
                         device=pos.device)
    lib = kbuild.load_library()
    kbuild.check(lib.cmst_scatter_keys(
        planes.data_ptr(), pos.data_ptr(), rgb.data_ptr(), cum.data_ptr(),
        rank_lut.data_ptr(), n, n_px + 1, t_pad, kbuild.stream_of(pos)),
        "scatter_key_planes")
    kbuild.count_launch("scatter_key_planes")
    return planes


def pack_target_planes_keys_sparse(stack: np.ndarray, data_threshold: int,
                                   rank_lut: torch.Tensor, t_pad: int,
                                   device: torch.device) -> torch.Tensor:
    """Host uint8 [T, H, W, 3] -> int32 [P+1, t_pad] key planes on
    `device` via a sparse COO upload (host foreground select + K1).

    CDMs are ~98% black and the data threshold is folded into the pack,
    so only foreground pixels (any channel > threshold) influence the
    planes; uploading (position, rgb) pairs for those pixels moves ~25x
    fewer bytes than the dense uint8 stack. Bit-identical to
    pack_target_planes_keys (tests/test_torch_kernels.py).
    """
    from colormipsearch_tpu_torch.utils.metrics import GLOBAL as _M

    t0 = time.time()
    pos, rgb, cum = coo_foreground(stack, data_threshold, t_pad)
    _M.add("cds.packSelect.seconds", time.time() - t0)
    t0 = time.time()
    planes = scatter_key_planes(
        torch.from_numpy(pos).to(device), torch.from_numpy(rgb).to(device),
        torch.from_numpy(cum).to(device), rank_lut.to(device),
        n_px=stack.shape[1] * stack.shape[2], t_pad=t_pad)
    synchronize(device)  # honest stage timing
    _M.add("cds.packScatter.seconds", time.time() - t0)
    return planes


def coo_foreground(stack: np.ndarray, data_threshold: int, t_pad: int):
    """K1's host inputs for a uint8 [T, H, W, 3] stack: every pixel with
    a channel above `data_threshold` as (pos int32 [N], rgb uint8 [N, 3]),
    target-major, plus the cumulative per-target counts cum int64
    [t_pad]."""
    from colormipsearch_tpu_torch.io import native_decoder

    t, h, w, _ = stack.shape
    sel = None
    if stack.flags.c_contiguous:
        # threaded native select (~100x the numpy nonzero path)
        sel = native_decoder.coo_select(stack, data_threshold)
    if sel is not None:
        pos, tidx, rgb = sel
    else:
        flat = stack.reshape(t, h * w, 3)
        tidx, pos = np.nonzero(flat.max(axis=2) > data_threshold)
        rgb = flat[tidx, pos]
    cum = np.cumsum(np.bincount(tidx, minlength=t_pad)).astype(np.int64)
    return (np.ascontiguousarray(pos, np.int32),
            np.ascontiguousarray(rgb, np.uint8), cum)


def ztol_fraction(pix_color_fluctuation) -> tuple[int, int]:
    """Exact rational z-tolerance a/b from the CLI fluctuation value
    (the reference computes zTolerance = pixColorFluctuation / 100)."""
    f = Fraction(str(pix_color_fluctuation)) / 100
    return f.numerator, f.denominator


def synchronize(device: torch.device) -> None:
    """Wait for `device`'s queued work (no-op on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
