"""PIL's LAB -> RGB conversion without PIL: the LittleCMS 2 transform
that Image.convert("RGB") builds for a "LAB" image, reproduced value for
value.

PIL converts LAB through ImageCms: a transform from LittleCMS's built-in
Lab identity profile (v2, D50) to its built-in sRGB profile (v4, D65
primaries adapted to D50 by Bradford), perceptual intent, 8 bits in and
out. LittleCMS does not evaluate that pipeline per pixel: it samples it
on a 33 x 33 x 33 grid of 16-bit nodes (its "optimization by
resampling") and interpolates the grid tetrahedrally in 16-bit fixed
point. So the result is that grid's, not the colour science's:
stored (95, 130, 194) gives RGB (0, 121, 189). This module builds the
same grid and interpolates it with the same integer arithmetic:

  * a pixel's 16-bit input is L * 257 and (a ^ 128) * 257, (b ^ 128) *
    257 for the stored L, a*, b* bytes (PIL hands its LAB bytes to
    LittleCMS as unsigned with 128 for zero);
  * each node is the float32 pipeline of LittleCMS at that input: Lab ->
    XYZ (D50, divided by 1 + 32767/32768), the inverse of the sRGB
    colorant matrix (scaled back by the same factor), the inverse sRGB
    tone curve (parametric type -4), then _cmsQuickSaturateWord;
  * TetrahedralInterp16, then FROM_16_TO_8.

tests/test_torch_image_forms.py holds it to PIL on all 2^24 triples.
"""

from __future__ import annotations

import functools

import numpy as np

_GRID = 33
_D50 = (0.9642, 1.0, 0.8249)
_XYZ_ADJ = 1.0 + 32767.0 / 32768.0     # LittleCMS's MAX_ENCODEABLE_XYZ
# IEC 61966-2.1 as LittleCMS's parametric curve type 4
_SRGB = (2.4, 1.0 / 1.055, 0.055 / 1.055, 1.0 / 12.92, 0.04045)


def _inverse(a: list) -> list:
    """_cmsMAT3inverse, in its order of operations."""
    c0 = a[1][1] * a[2][2] - a[1][2] * a[2][1]
    c1 = -a[1][0] * a[2][2] + a[1][2] * a[2][0]
    c2 = a[1][0] * a[2][1] - a[1][1] * a[2][0]
    det = a[0][0] * c0 + a[0][1] * c1 + a[0][2] * c2
    return [[c0 / det, (a[0][2] * a[2][1] - a[0][1] * a[2][2]) / det,
             (a[0][1] * a[1][2] - a[0][2] * a[1][1]) / det],
            [c1 / det, (a[0][0] * a[2][2] - a[0][2] * a[2][0]) / det,
             (a[0][2] * a[1][0] - a[0][0] * a[1][2]) / det],
            [c2 / det, (a[0][1] * a[2][0] - a[0][0] * a[2][1]) / det,
             (a[0][0] * a[1][1] - a[0][1] * a[1][0]) / det]]


def _product(a: list, b: list) -> list:
    return [[a[i][0] * b[0][j] + a[i][1] * b[1][j] + a[i][2] * b[2][j]
             for j in range(3)] for i in range(3)]


def _apply(a: list, v: list) -> list:
    return [a[i][0] * v[0] + a[i][1] * v[1] + a[i][2] * v[2]
            for i in range(3)]


def _srgb_to_xyz() -> list:
    """cmsCreate_sRGBProfile's colorants: _cmsBuildRGB2XYZtransferMatrix
    for the Rec. 709 primaries and D65, adapted to D50 by Bradford."""
    xn, yn = 0.3127, 0.3290
    (xr, yr), (xg, yg), (xb, yb) = (0.64, 0.33), (0.30, 0.60), (0.15, 0.06)
    coef = _apply(_inverse([[xr, xg, xb], [yr, yg, yb],
                            [1 - xr - yr, 1 - xg - yg, 1 - xb - yb]]),
                  [xn / yn, 1.0, (1.0 - xn - yn) / yn])
    m = [[coef[0] * xr, coef[1] * xg, coef[2] * xb],
         [coef[0] * yr, coef[1] * yg, coef[2] * yb],
         [coef[0] * (1.0 - xr - yr), coef[1] * (1.0 - xg - yg),
          coef[2] * (1.0 - xb - yb)]]
    bradford = [[0.8951, 0.2664, -0.1614], [-0.7502, 1.7135, 0.0367],
                [0.0389, -0.0685, 1.0296]]
    src = _apply(bradford, [xn / yn, 1.0, (1 - xn - yn) / yn])
    dst = _apply(bradford, list(_D50))
    cone = [[dst[0] / src[0], 0.0, 0.0], [0.0, dst[1] / src[1], 0.0],
            [0.0, 0.0, dst[2] / src[2]]]
    adapt = _product(_inverse(bradford), _product(cone, bradford))
    return _product(adapt, m)


def _saturate_word(d: np.ndarray) -> np.ndarray:
    """_cmsQuickSaturateWord: d + 0.5, clipped to [0, 65535], then the
    fast floor (the value rounded to 1/65536 first, then floored)."""
    d = np.asarray(d, np.float64) + 0.5
    q = np.floor(np.round((d - 32767.0) * 65536.0) / 65536.0) + 32767.0
    return np.where(d <= 0, 0, np.where(d >= 65535.0, 65535, q)) \
        .astype(np.int64)


def _f_inverse(t: np.ndarray) -> np.ndarray:
    return np.where(t <= 24.0 / 116.0, (108.0 / 841.0) * (t - 16.0 / 116.0),
                    t * t * t)


def _tone(v: np.ndarray) -> np.ndarray:
    """The inverse sRGB curve (parametric type -4) in double -> float32."""
    r = v.astype(np.float64)
    g, a, b, c, d = _SRGB
    disc = (a * d + b) ** g
    with np.errstate(invalid="ignore"):
        high = (np.power(np.maximum(r, 0.0), 1.0 / g) - b) / a
    return np.where(r >= disc, high, r / c).astype(np.float32)


@functools.lru_cache(maxsize=1)
def _grid() -> np.ndarray:
    """The 16-bit grid LittleCMS samples, flat [33 * 33 * 33 * 3] int64
    (L slowest, b fastest, then the three outputs)."""
    m = [[v * _XYZ_ADJ for v in row] for row in _inverse(_srgb_to_xyz())]
    nodes = _saturate_word(np.arange(_GRID) * 65535.0 / (_GRID - 1))
    lab16 = np.stack(np.meshgrid(nodes, nodes, nodes, indexing="ij"), -1)
    x = (lab16.astype(np.float64) / 65535.0).astype(np.float32) \
        .astype(np.float64)
    fy = (x[..., 0] * 100.0 + 16.0) / 116.0
    fx = fy + 0.002 * (x[..., 1] * 255.0 - 128.0)
    fz = fy - 0.005 * (x[..., 2] * 255.0 - 128.0)
    xyz = [(_f_inverse(f) * w / _XYZ_ADJ).astype(np.float32)
           .astype(np.float64) for f, w in zip((fx, fy, fz), _D50)]
    rgb = []
    for row in m:
        t = ((0.0 + xyz[0] * row[0]) + xyz[1] * row[1]) + xyz[2] * row[2]
        rgb.append(_saturate_word(
            _tone(t.astype(np.float32)).astype(np.float64) * 65535.0))
    return np.stack(rgb, -1).reshape(-1)


def _to_fixed_domain(a: np.ndarray) -> np.ndarray:
    return a + (a + 0x7FFF) // 0xFFFF


def lab_to_rgb(lab: np.ndarray, chunk: int = 1 << 20) -> np.ndarray:
    """Stored LAB bytes uint8 [..., 3] (L, signed a*, signed b*) -> RGB
    uint8 [..., 3] as PIL's convert("RGB") gives them."""
    grid = _grid()
    flat = lab.reshape(-1, 3)
    out = np.empty(flat.shape, np.uint8)
    steps = np.array([3 * _GRID * _GRID, 3 * _GRID, 3], np.int64)
    for s in range(0, flat.shape[0], chunk):
        v = flat[s:s + chunk].astype(np.int64)
        v[:, 1:] ^= 128
        v *= 257
        f = _to_fixed_domain(v * (_GRID - 1))
        rest = f & 0xFFFF
        base = (f >> 16) @ steps
        step = np.where(v == 0xFFFF, 0, steps)
        # the vertices of the tetrahedron: the axes in falling order of
        # their rest (the sum is the same for either order of a tie)
        order = np.argsort(-rest, axis=1, kind="stable")
        r = np.take_along_axis(rest, order, 1)
        o1 = np.take_along_axis(step, order[:, :1], 1)[:, 0]
        o2 = o1 + np.take_along_axis(step, order[:, 1:2], 1)[:, 0]
        o3 = step.sum(1)
        for ch in range(3):
            c0 = grid[base + ch]
            c1 = grid[base + ch + o1]
            c2 = grid[base + ch + o2]
            c3 = grid[base + ch + o3]
            t = ((c1 - c0) * r[:, 0] + (c2 - c1) * r[:, 1]
                 + (c3 - c2) * r[:, 2] + 0x8001)
            t = (t + (1 << 31)) % (1 << 32) - (1 << 31)   # int32 sums
            w = (c0 + ((t + (t >> 16)) >> 16)) & 0xFFFF
            out[s:s + chunk, ch] = (w * 65281 + 8388608) >> 24
    return out.reshape(lab.shape)
