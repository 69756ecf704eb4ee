"""Float64-exact shape (gradient area gap) scoring oracle.

Re-states the negative/shape scoring semantics of the reference
(cds/ShapeMatchColorDepthSearchAlgorithm.java,
 cds/GradientAreaGapUtils.java,
 cds/ColorDepthSearchAlgorithmProviderFactory.java:77-137) as vectorized
numpy.  Bit-identical to the Java implementation; serves as the oracle for
the shape kernels (ops/shape_score.py).

Key reformulations shared with the device kernels:

  * the z-slice number of a pixel depends only on its RGB value, so slice
    numbers are precomputed as integer planes (the per-pixel LUT scan
    happens once per image, not once per comparison),
  * the gray/signal conversions reduce to exact integer formulas:
      gray16(r,g,b)      = (2*(r+g+b) + 3) // 6          (0 if rgb==0)
      signal(v, thr=2)   = v >= 8   <=>  r+g+b >= 23
      signal(v, thr=0)   = v >= 2   <=>  r+g+b >= 5
  * the mirrored pass flips the query planes AND the target z-gap plane
    but not the gradient/target planes — a quirk of the reference
    (ShapeMatchColorDepthSearchAlgorithm.calculateNegativeScores:214-221)
    preserved for parity.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
from scipy import ndimage

from colormipsearch_tpu_torch.constants import (
    CLASS_BG,
    CLASS_BR,
    CLASS_GB,
    CLASS_GR,
    CLASS_RB,
    CLASS_RG,
    DEFAULT_COLOR_FLUX,
    GAP_THRESHOLD,
    HIGH_EXPRESSION_FACTOR,
    HIGH_NORMALIZED_NEGATIVE_SCORE,
    LOW_NORMALIZED_NEGATIVE_SCORE,
    RAINBOW_LUT,
    SLICE_LUT_RANGES,
)

# ---------------------------------------------------------------------------
# ImageJ-compatible circular structuring element
# ---------------------------------------------------------------------------


def circular_footprint(radius: float) -> np.ndarray:
    """Boolean [k, k] footprint identical to ImageJ RankFilters.

    Mirrors the radius quantization and per-row extents of the reference's
    makeLineRadii (imageprocessing/ImageTransformation.java:549-572).
    """
    radius = _quantize_radius(radius)
    r2 = int(radius * radius) + 1
    k_radius = int(np.sqrt(r2 + 1e-10))
    size = 2 * k_radius + 1
    fp = np.zeros((size, size), dtype=bool)
    for y in range(-k_radius, k_radius + 1):
        dx = int(np.sqrt(r2 - y * y + 1e-10))
        fp[y + k_radius, k_radius - dx:k_radius + dx + 1] = True
    return fp


def row_extents(radius: float) -> list[int]:
    """Per-row half-extents dx for dy = -kRadius..kRadius (same quantization)."""
    fp = circular_footprint(radius)
    k = fp.shape[0] // 2
    return [int(np.flatnonzero(fp[y])[-1] - k) for y in range(fp.shape[0])]


def dilate_rgb(rgb: np.ndarray, radius: float) -> np.ndarray:
    """Per-channel circular max filter (uint8 [H, W, 3] -> same).

    Out-of-image pixels do not participate (equivalent to zero padding for
    non-negative values), matching the reference histogram dilation.

    Decomposes the circular footprint into per-row horizontal windows
    (the same row-extent form as the reference's makeLineRadii,
    ImageTransformation.java:549-572): one O(n) 1-D max filter per
    distinct row extent, then a vertical max over shifted rows — O(k·n)
    instead of the naive O(k^2·n).
    """
    fp = circular_footprint(radius)
    k = fp.shape[0] // 2
    extents = row_extents(radius)  # dx per dy=-k..k
    out = np.zeros_like(rgb)
    # horizontal max per unique window width (C-implemented, O(n))
    by_extent = {}
    for e in set(extents):
        by_extent[e] = ndimage.maximum_filter1d(
            rgb, 2 * e + 1, axis=1, mode="constant", cval=0)
    h = rgb.shape[0]
    for dy, e in zip(range(-k, k + 1), extents):
        if abs(dy) >= h:  # kernel rows beyond the image contribute nothing
            continue
        row_max = by_extent[e]
        # out[y] collects max over rgb[y+dy] rows: shift down by -dy
        if dy < 0:
            out[:h + dy] = np.maximum(out[:h + dy], row_max[-dy:])
        elif dy > 0:
            out[dy:] = np.maximum(out[dy:], row_max[:h - dy])
        else:
            out = np.maximum(out, row_max)
    return out


def binary_dilate_disk(fg: np.ndarray, radius: float) -> np.ndarray:
    """Binary dilation of ``fg`` [H, W] by the ImageJ circular footprint,
    via ONE exact Euclidean distance transform instead of per-row max
    filters.

    Exactness: the quantized footprint of ``circular_footprint`` is
    precisely the integer disk {(dy, dx): dy^2 + dx^2 <= int(r^2) + 1}
    (makeLineRadii's dx = floor(sqrt(r2 - dy^2)), so |dx| <= dx_max iff
    dx^2 + dy^2 <= r2 — proven for all radii in
    tests/test_oracle_shape.py).  Binary dilation by a disk is then
    exactly (squared distance to nearest foreground pixel) <= r2.  The
    float64 sqrt round-trip is exact after rint: the squared distances
    are integers < 2^21, far above the ~1e-9 rounding error.

    This is the hot half of the per-mask query pack (the r=60/r=20
    high-expression ring, ColorDepthSearchAlgorithmProviderFactory
    .java:113-131): one EDT serves every radius, ~12x cheaper than the
    row-extent max-filter decomposition on production-size planes.
    """
    if not fg.any():
        return np.zeros_like(fg, dtype=bool)
    radius = _quantize_radius(radius)
    r2 = int(radius * radius) + 1
    d = ndimage.distance_transform_edt(~fg)
    return np.rint(d * d) <= r2


def _quantize_radius(radius: float) -> float:
    """ImageJ RankFilters radius quantization (makeLineRadii
    ImageTransformation.java:552-556)."""
    if 1.5 <= radius < 1.75:
        return 1.75
    if 2.5 <= radius < 2.85:
        return 2.85
    return radius


# ---------------------------------------------------------------------------
# Z-slice numbers from RGB
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=1)
def lut_ratios() -> np.ndarray:
    """float64 [256] hue ratio of each rainbow LUT entry.

    Uses the strict-dominance logic of findSliceNumberInLUT:160-184 (ties
    leave the ratio at 0).
    """
    lut = RAINBOW_LUT.astype(np.float64)
    r, g, b = lut[:, 0], lut[:, 1], lut[:, 2]
    ratio = np.zeros(256, dtype=np.float64)
    b_dom = (b > r) & (b > g)
    g_dom = (g > r) & (g > b)
    r_dom = (r > g) & (r > b)
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = np.where(b_dom & (r > g), r / np.where(b == 0, 1, b), ratio)
        ratio = np.where(b_dom & (g > r), g / np.where(b == 0, 1, b), ratio)
        ratio = np.where(g_dom & (r > b), r / np.where(g == 0, 1, g), ratio)
        ratio = np.where(g_dom & (b > r), b / np.where(g == 0, 1, g), ratio)
        ratio = np.where(r_dom & (g > b), g / np.where(r == 0, 1, r), ratio)
        ratio = np.where(r_dom & (b > g), b / np.where(r == 0, 1, r), ratio)
    return ratio


def _classify_ge(rgb_flat: np.ndarray):
    """Dominance classification with >= tie-breaking (R, G, B priority).

    This is the *slice-gap* classification (GradientAreaGapUtils
    calculateSliceGap:32-94), which differs from the pixel-match one: ties
    are resolved in favor of red, then green, then blue, and black pixels
    land in the red/green branch with a 0/0 = NaN ratio.
    """
    r = rgb_flat[..., 0].astype(np.int32)
    g = rgb_flat[..., 1].astype(np.int32)
    b = rgb_flat[..., 2].astype(np.int32)

    r_dom = (r >= g) & (r >= b)
    g_dom = ~r_dom & (g >= r) & (g >= b)
    b_dom = ~r_dom & ~g_dom

    cls = np.empty(r.shape, dtype=np.int32)
    p = np.empty(r.shape, dtype=np.int32)
    s = np.empty(r.shape, dtype=np.int32)

    cls[r_dom] = np.where(g[r_dom] >= b[r_dom], CLASS_RG, CLASS_RB)
    p[r_dom] = r[r_dom]
    s[r_dom] = np.maximum(g[r_dom], b[r_dom])

    cls[g_dom] = np.where(r[g_dom] >= b[g_dom], CLASS_GR, CLASS_GB)
    p[g_dom] = g[g_dom]
    s[g_dom] = np.maximum(r[g_dom], b[g_dom])

    cls[b_dom] = np.where(r[b_dom] >= g[b_dom], CLASS_BR, CLASS_BG)
    p[b_dom] = b[b_dom]
    s[b_dom] = np.maximum(r[b_dom], g[b_dom])
    return cls, s, p


def slice_numbers(rgb: np.ndarray) -> np.ndarray:
    """int32 z-slice number (1..256) per pixel; 0 for black pixels.

    Vectorized equivalent of findSliceNumber + findSliceNumberInLUT
    (GradientAreaGapUtils.java:108-198): nearest-ratio scan over the
    class's LUT range with first-minimum tie-breaking.
    """
    flat = rgb.reshape(-1, 3)
    cls, s, p = _classify_ge(flat)
    with np.errstate(invalid="ignore", divide="ignore"):
        ratio = s.astype(np.float64) / p.astype(np.float64)  # NaN for black
    ratios = lut_ratios()
    out = np.zeros(flat.shape[0], dtype=np.int32)
    for cid, (lo, hi) in SLICE_LUT_RANGES.items():
        sel = cls == cid
        if not sel.any():
            continue
        cr = ratio[sel]  # [n]
        gaps = np.abs(cr[:, None] - ratios[None, lo:hi + 1])  # [n, range]
        # NaN gaps (black pixels) select nothing -> slice 0
        valid = ~np.isnan(cr)
        idx = np.zeros(cr.shape, dtype=np.int64)
        if valid.any():
            idx[valid] = np.argmin(gaps[valid], axis=1)  # first min wins
        out[sel] = np.where(valid, lo + idx + 1, 0)
    return out.reshape(rgb.shape[:-1])


def slice_gap(slice1: np.ndarray, slice2: np.ndarray) -> np.ndarray:
    """Gap between slice numbers; if either is 0, the result is slice2."""
    return np.where((slice1 == 0) | (slice2 == 0),
                    slice2, np.abs(slice1 - slice2))


# ---------------------------------------------------------------------------
# Integer-exact gray/signal conversions
# ---------------------------------------------------------------------------


def gray16_no_gamma(rgb: np.ndarray) -> np.ndarray:
    """(2*(r+g+b)+3)//6 — exact value of the reference's RGB->gray."""
    s = rgb.astype(np.int32).sum(axis=-1)
    return (2 * s + 3) // 6


def rgb_signal(rgb: np.ndarray, threshold: int) -> np.ndarray:
    """toGray16WithNoGammaCorrection . gray8Or16ToSignal(threshold).

    signal(v) = (2v+3)//6 > threshold applied to v = gray16(rgb);
    int8 0/1 output.
    """
    v = gray16_no_gamma(rgb)
    return ((2 * v + 3) // 6 > threshold).astype(np.int8)


def mask_rgb(rgb: np.ndarray, threshold: int) -> np.ndarray:
    """ColorTransformation.mask: black out pixels with all channels <= thr."""
    keep = (rgb > threshold).any(axis=-1)
    return np.where(keep[..., None], rgb, 0).astype(np.uint8)


def clear_region(rgb: np.ndarray, region: np.ndarray | None) -> np.ndarray:
    if region is None:
        return rgb
    return np.where(region[..., None], 0, rgb).astype(np.uint8)


# ---------------------------------------------------------------------------
# Shape scoring
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ShapeMatchResult:
    gradient_area_gap: int
    high_expression_area: int
    mirrored: bool

    @property
    def negative_score(self) -> int:
        return negative_score(self.gradient_area_gap, self.high_expression_area)


def negative_score(gradient_area_gap, high_expression_area) -> int:
    """gradientAreaGap + highExpressionArea // 2 with the reference's
    missing-value handling (GradientAreaGapUtils.calculateNegativeScore)."""
    g_ok = gradient_area_gap is not None and gradient_area_gap >= 0
    h_ok = high_expression_area is not None and high_expression_area >= 0
    if g_ok and h_ok:
        return gradient_area_gap + high_expression_area // HIGH_EXPRESSION_FACTOR
    if g_ok:
        return gradient_area_gap
    if h_ok:
        return high_expression_area // HIGH_EXPRESSION_FACTOR
    return -1


def normalized_score(pixel_match: int, gradient_area_gap: int,
                     high_expression_area: int, max_pixel_match: int,
                     max_negative_score: int) -> float:
    """GradientAreaGapUtils.calculateNormalizedScore, float64-exact."""
    if pixel_match == 0 or max_pixel_match == 0 or max_negative_score < 0:
        return float(pixel_match)
    neg = negative_score(gradient_area_gap, high_expression_area)
    if gradient_area_gap < 0 or max_negative_score <= 0 or neg == -1:
        return float(pixel_match)
    normalized_neg = np.float64(neg) / np.float64(max_negative_score)
    bounded = min(max(normalized_neg * 2.5, LOW_NORMALIZED_NEGATIVE_SCORE),
                  HIGH_NORMALIZED_NEGATIVE_SCORE)
    return float(np.float64(pixel_match) / np.float64(max_pixel_match)
                 / bounded * 100)


class ShapeMatchOracle:
    """Exact gradient-area-gap scorer for one query against targets.

    Precomputes the query-side planes built by the reference's provider
    factory (clear labels, intensity signal, high-expression ring mask,
    optional ROI mask) once per query.
    """

    def __init__(self, query_rgb: np.ndarray, query_threshold: int, *,
                 mirror: bool, negative_radius: int = 20,
                 excluded_region: np.ndarray | None = None,
                 roi_mask_rgb: np.ndarray | None = None):
        self.query_threshold = int(query_threshold)
        self.mirror = bool(mirror)
        self.negative_radius = int(negative_radius)
        self.excluded_region = excluded_region

        q = clear_region(query_rgb, excluded_region)
        self.query = q
        self.q_slices = slice_numbers(q)
        self.q_nonzero = q.astype(np.int32).sum(axis=-1) > 0
        self.q_signal = rgb_signal(q, 2).astype(np.int32)

        d60 = dilate_rgb(q, 60)
        d20 = dilate_rgb(q, 20)
        ring = np.where((d20.astype(np.int32).sum(axis=-1) > 0)[..., None],
                        0, d60).astype(np.uint8)
        self.q_high_expr = rgb_signal(ring, 0).astype(np.int32)

        if roi_mask_rgb is not None:
            roi = clear_region(roi_mask_rgb, excluded_region)
            self.roi_keep = roi.astype(np.int32).sum(axis=-1) > 0
        else:
            self.roi_keep = None

    def _zgap_planes(self, target_rgb, zgap_rgb):
        """(nonzero mask, slice numbers) of the z-gap image."""
        if zgap_rgb is None:
            masked = mask_rgb(clear_region(target_rgb, self.excluded_region),
                              self.query_threshold)
            zgap_rgb = dilate_rgb(masked, self.negative_radius)
        nz = zgap_rgb.astype(np.int32).sum(axis=-1) > 0
        return nz, slice_numbers(zgap_rgb)

    def _one_pass(self, q_nz, q_slices, q_sig, q_he, t_rgb, grad, z_nz, z_sl,
                  mirrored: bool) -> ShapeMatchResult:
        if mirrored:
            q_nz, q_slices = q_nz[:, ::-1], q_slices[:, ::-1]
            q_sig, q_he = q_sig[:, ::-1], q_he[:, ::-1]
            z_nz, z_sl = z_nz[:, ::-1], z_sl[:, ::-1]
        if self.roi_keep is not None:
            # ROI mask is applied after mirroring and is itself not mirrored
            q_nz = q_nz & self.roi_keep
            q_sig = np.where(self.roi_keep, q_sig, 0)
            q_he = np.where(self.roi_keep, q_he, 0)

        overlap = q_nz & z_nz
        sg = slice_gap(q_slices, z_sl)
        grad_term = q_sig * grad.astype(np.int64)
        val = np.where(overlap & (sg >= 2 * DEFAULT_COLOR_FLUX),
                       sg.astype(np.int64) - DEFAULT_COLOR_FLUX, grad_term)
        val = np.where(val > GAP_THRESHOLD, val, 0)
        gradient_area_gap = int(val.sum())

        t_fg = (t_rgb > self.query_threshold).any(axis=-1)
        high_expr = int(((q_he == 1) & t_fg).sum())
        return ShapeMatchResult(gradient_area_gap, high_expr, mirrored)

    def score(self, target_rgb: np.ndarray, target_gradient: np.ndarray,
              target_zgap_rgb: np.ndarray | None = None) -> ShapeMatchResult:
        """Shape score vs a target; smaller negative score wins mirror."""
        t = clear_region(target_rgb, self.excluded_region)
        z_nz, z_sl = self._zgap_planes(target_rgb, target_zgap_rgb)
        straight = self._one_pass(self.q_nonzero, self.q_slices, self.q_signal,
                                  self.q_high_expr, t, target_gradient,
                                  z_nz, z_sl, False)
        if not self.mirror:
            return straight
        mirrored = self._one_pass(self.q_nonzero, self.q_slices, self.q_signal,
                                  self.q_high_expr, t, target_gradient,
                                  z_nz, z_sl, True)
        return mirrored if mirrored.negative_score < straight.negative_score \
            else straight
