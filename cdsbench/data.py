"""The benchmark's inputs, made from the seed: target CDMs, their
placements in the resident shard, and the masks cut from them.

Frozen yardstick code: it imports nothing of the program. The stroke
generator is a copy of ``colormipsearch_tpu_torch/testing.py:1121``
(``synthetic_cdm``) and the cut of ``testing.py:1164`` (``cut_mask``),
rewritten so that every count is exact for every seed:

* every target has exactly ``target_foreground_pixels`` pixels above the
  data threshold; the shard's columns are wrap-around rolls and
  left-right flips of ``distinct_targets`` generated images, which keep
  that count;
* every mask has exactly ``mask_query_pixels`` pixels above the mask
  threshold outside the label regions, cut in ``planted_per_shard``
  compact pieces from as many columns (a small shift in the search's
  own shift set, and every other mask mirrored), so each mask has that
  many planted matches in the shard and chance scores far below the
  emit line;
* a share of each piece's pixels (``tie_fraction``) is recoloured to a
  hue whose ratio lies exactly 1/100 from its source's, the tolerance
  itself, so the float64 decision at the boundary shows in the scores.

A placement is ``np.roll(base[:, ::-1] if flip else base, (ry, rx))``.
Two placements of one base differ in ``ry`` by at least ``_ROLL_GAP``
rows (cyclically), far beyond the search's 2-pixel shifts, so a piece
matches its own column and no other.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import struct
import zlib

import numpy as np

_STROKE_WIDTH = 3
_STROKE_LENGTH = 300
_ROLL_GAP = 8

# the search's own shift set at xyShift 2 (oracle shift_offsets)
_SHIFTS = [(dx, dy) for dx in (-2, 0, 2) for dy in (-2, 0, 2)]


@dataclasses.dataclass
class CellData:
    """Everything one run needs, all of it from the seed."""
    height: int
    width: int
    bases: np.ndarray           # uint8 [n_bases, H, W, 3]
    col_base: np.ndarray        # int64 [C]: the base of each column
    col_flip: np.ndarray        # bool [C]
    col_roll: np.ndarray        # int64 [C, 2]: (ry, rx)
    masks: list                 # uint8 [H, W, 3] each
    planted: list               # per mask: sorted int64 [k] columns
    base_fg: list = dataclasses.field(default_factory=list)

    @property
    def columns(self) -> int:
        return int(self.col_base.size)


def label_regions(height: int, width: int, name_label: bool = True,
                  color_scale: bool = True) -> np.ndarray:
    """The name-label and color-scale regions excluded from the query
    (copy of ``oracle/pixel.py:142`` ``label_regions_mask``)."""
    yy, xx = np.mgrid[0:height, 0:width]
    region = np.zeros((height, width), dtype=bool)
    if color_scale and width > 270:
        region |= (xx >= width - 270) & (yy < 90)
    if name_label:
        region |= (xx < 330) & (yy < 100)
    return region


@functools.cache
def _lut() -> np.ndarray:
    """The colour-depth LUT, int32 [256, 3] (R, G, B): a copy of
    ``colormipsearch_tpu_torch/constants.py:114`` ``RAINBOW_LUT``."""
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "rainbow_lut.json")) as f:
        return np.asarray(json.load(f), np.int32)


def _reflect(z: np.ndarray) -> np.ndarray:
    """Depths folded back into [0, 255] at both ends, which keeps them
    uniform (clipping would pile them up on the end slices)."""
    z = np.abs(z) % 510
    return np.where(z > 255, 510 - z, z)


def _strokes(rng, height, width, n_strokes, z_drift, z_noise):
    """Rendered pixels of `n_strokes` smooth random walks, in draw order
    (flat position, colour), as ``testing.synthetic_cdm`` draws them, but
    with the depth drifting by a normal of `z_drift` slices a step and
    every rendered pixel's depth jittered by a normal of `z_noise`
    slices, as an LM image's colours are noisy."""
    length = max(8, min(_STROKE_LENGTH, (height + width) // 2))
    heading = rng.uniform(0, 2 * np.pi, (n_strokes, 1)) + np.cumsum(
        rng.normal(0, 0.12, (n_strokes, length)), axis=1)
    y = rng.uniform(0, height, (n_strokes, 1)) + np.cumsum(
        np.sin(heading), axis=1)
    x = rng.uniform(0, width, (n_strokes, 1)) + np.cumsum(
        np.cos(heading), axis=1)
    z = (rng.uniform(0, 255, (n_strokes, 1)) + np.cumsum(
        rng.normal(0, z_drift, (n_strokes, length)), axis=1)).ravel()
    gain = np.repeat(rng.uniform(0.55, 1.0, n_strokes), length)
    yy = np.rint(y).astype(np.int64).ravel()
    xx = np.rint(x).astype(np.int64).ravel()
    half = _STROKE_WIDTH // 2
    pos, col = [], []
    for oy in range(-half, _STROKE_WIDTH - half):
        for ox in range(-half, _STROKE_WIDTH - half):
            py, px = yy + oy, xx + ox
            ok = (py >= 0) & (py < height) & (px >= 0) & (px < width)
            zp = _reflect(z[ok] + rng.normal(0, z_noise, int(ok.sum())))
            pos.append(py[ok] * width + px[ok])
            col.append((_lut()[zp.astype(np.int64)]
                        * gain[ok][:, None]).astype(np.uint8))
    return np.concatenate(pos), np.concatenate(col)


def target_cdm(rng, height: int, width: int, fg_pixels: int,
               z_drift: float, z_noise: float) -> np.ndarray:
    """One CDM with exactly `fg_pixels` foreground pixels: strokes until
    the count is reached, then seeded holes down to it. Every stroke
    colour has a channel of at least 140 (the LUT's 255 times a gain of
    0.55 or more), so every drawn pixel is above the data threshold."""
    img = np.zeros((height * width, 3), np.uint8)
    fg = np.zeros(height * width, bool)
    n_strokes = max(1, -(-fg_pixels // (_STROKE_WIDTH * _STROKE_LENGTH)))
    while True:
        pos, col = _strokes(rng, height, width, n_strokes, z_drift,
                            z_noise)
        img[pos] = col
        fg[pos] = True
        count = int(np.count_nonzero(fg))
        if count >= fg_pixels:
            break
        n_strokes = max(1, n_strokes // 4)
    holes = rng.choice(np.flatnonzero(fg), count - fg_pixels, replace=False)
    img[holes] = 0
    return img.reshape(height, width, 3)


def placements(rng, n_columns: int, n_bases: int, height: int, width: int):
    """(base, flip, (ry, rx)) of every column: the bases in a seeded
    order, each used alike often, and the rolls of one base's
    placements at least _ROLL_GAP rows apart."""
    if n_columns % n_bases:
        raise ValueError(f"{n_columns} columns do not divide over "
                         f"{n_bases} distinct targets")
    per_base = n_columns // n_bases
    slots = height // _ROLL_GAP
    if per_base > slots:
        raise ValueError(f"{per_base} placements a target, {slots} slots")
    col_base = rng.permutation(np.repeat(np.arange(n_bases), per_base))
    col_flip = rng.integers(0, 2, n_columns).astype(bool)
    col_roll = np.empty((n_columns, 2), np.int64)
    col_roll[:, 1] = rng.integers(0, width, n_columns)
    for b in range(n_bases):
        cols = np.flatnonzero(col_base == b)
        col_roll[cols, 0] = rng.choice(slots, cols.size,
                                       replace=False) * _ROLL_GAP
    return col_base, col_flip, col_roll


def place(base: np.ndarray, flip: bool, roll) -> np.ndarray:
    """One column of the shard: the base, flipped left-right if `flip`,
    rolled by (ry, rx) with wrap-around."""
    src = base[:, ::-1] if flip else base
    return np.roll(src, (int(roll[0]), int(roll[1])), axis=(0, 1))


def fill_stack(data: CellData) -> np.ndarray:
    """The shard's dense uint8 [C, H, W, 3] stack (the tests' witness of
    the resident pack)."""
    return np.stack([place(data.bases[b], f, r) for b, f, r in zip(
        data.col_base, data.col_flip, data.col_roll)])


def classify(rgb: np.ndarray):
    """(class, s, p) of uint8 [..., 3] pixels: a copy of
    ``oracle/pixel.py:42`` ``classify_rgb``."""
    r = rgb[..., 0].astype(np.int32)
    g = rgb[..., 1].astype(np.int32)
    b = rgb[..., 2].astype(np.int32)
    cls = np.zeros(r.shape, np.int32)
    s = np.zeros(r.shape, np.int32)
    p = np.zeros(r.shape, np.int32)
    b_dom = (b > r) & (b > g)
    g_dom = (g > b) & (g > r)
    r_dom = (r > b) & (r > g)
    for m, cid, sec, prim in ((b_dom & (r > g), 1, r, b),
                              (b_dom & ~(r > g), 2, g, b),
                              (g_dom & (b > r), 3, b, g),
                              (g_dom & ~(b > r), 4, r, g),
                              (r_dom & (g > b), 5, g, r),
                              (r_dom & ~(g > b), 6, b, r)):
        cls = np.where(m, cid, cls)
        s = np.where(m, sec, s)
        p = np.where(m, prim, p)
    return cls, s, p


def _rgb_of(cls: int, s: int, p: int) -> tuple:
    """An RGB pixel of class `cls` with secondary `s` and primary `p`
    (s < p), the third channel 0."""
    rgb = [0, 0, 0]
    prim, sec = {1: (2, 0), 2: (2, 1), 3: (1, 2), 4: (1, 0), 5: (0, 1),
                 6: (0, 2)}[cls]
    rgb[prim], rgb[sec] = p, s
    return tuple(rgb)


@functools.cache
def tie_partners(threshold: int) -> dict:
    """(s, p) -> the (s', p') whose ratio s'/p' lies exactly 1/100 from
    s/p, with 1 <= s' < p' and p' above the threshold."""
    pp = np.arange(threshold + 1, 256)[None, :]
    out: dict = {}
    for p in range(2, 256):
        s = np.arange(1, p)[:, None]
        for sign in (1, -1):
            num = (100 * s + sign * p) * pp  # s' * 100 p
            sp = num // (100 * p)
            ok = (num % (100 * p) == 0) & (sp >= 1) & (sp < pp)
            for i, j in zip(*np.nonzero(ok)):
                out.setdefault((int(s[i, 0]), p), []).append(
                    (int(sp[i, j]), int(pp[0, j])))
    return out


def column_foreground(data: CellData, c: int):
    """(y, x, colour) of column `c`'s foreground, from its base's."""
    h, w = data.height, data.width
    if not data.base_fg:
        for base in data.bases:
            flat = np.flatnonzero(base[..., 0] | base[..., 1]
                                  | base[..., 2]).astype(np.int32)
            data.base_fg.append((flat // w, flat % w,
                                 base.reshape(-1, 3)[flat]))
    y, x, colours = data.base_fg[data.col_base[c]]
    if data.col_flip[c]:
        x = w - 1 - x
    return ((y + data.col_roll[c, 0]) % h).astype(np.int32), \
        ((x + data.col_roll[c, 1]) % w).astype(np.int32), colours


def shifted_union(flat: np.ndarray, height: int, width: int) -> int:
    """How many distinct in-image positions the search's shifts of the
    query positions `flat` reach."""
    x, y = flat % width, flat // width
    parts = [(flat + dx + dy * width)[(x + dx >= 0) & (x + dx < width)
                                      & (y + dy >= 0) & (y + dy < height)]
             for dx, dy in _SHIFTS]
    return int(np.unique(np.concatenate(parts)).size)


def _piece(rng, data, c, n, mirror, taken):
    """Mask positions and colours of a compact piece of column `c`: its
    `n` free pixels nearest a seeded centre, moved by a seeded shift of
    the search's set (and mirrored)."""
    h, w = data.height, data.width
    sy, sx, colours = column_foreground(data, c)
    dx, dy = _SHIFTS[int(rng.integers(len(_SHIFTS)))]
    # the mask position of a source pixel: (x - dx, y - dy), mirrored
    my, mx = sy - dy, sx - dx
    if mirror:
        mx = w - 1 - mx
    ok = (my >= 0) & (my < h) & (mx >= 0) & (mx < w)
    ok[ok] = ~taken[my[ok] * w + mx[ok]]
    cand = np.flatnonzero(ok)
    if cand.size < n:
        raise ValueError(f"column {c}: {cand.size} free pixels, {n} wanted")
    centre = cand[int(rng.integers(cand.size))]
    radius = int(1.5 * np.sqrt(n * h * w / sy.size)) + 4
    while True:
        near = cand[(np.abs(my[cand] - my[centre]) <= radius)
                    & (np.abs(mx[cand] - mx[centre]) <= radius)]
        d2 = ((my[near] - my[centre]).astype(np.int64) ** 2
              + (mx[near] - mx[centre]).astype(np.int64) ** 2)
        if near.size >= n:
            # distinct keys: the nearest n, ties by position
            key = d2 * (h * w) + my[near] * w + mx[near]
            pick = near[np.argpartition(key, n - 1)[:n]]
            if int(d2.max(initial=0)) and int(np.sort(d2)[n - 1]) \
                    <= radius * radius:
                break
        radius *= 2
    return my[pick] * w + mx[pick], colours[pick].copy()


def cut_mask(rng, data: CellData, sources, *, query_pixels: int,
             mirror: bool, excluded: np.ndarray, threshold: int,
             tie_fraction: float):
    """A mask of exactly `query_pixels` query pixels, a compact piece of
    each source column in turn, mirrored left-right when `mirror` (a
    mirror variant then finds it); with its sorted query positions."""
    h, w = data.height, data.width
    mask = np.zeros((h * w, 3), np.uint8)
    taken = excluded.reshape(-1).copy()
    sizes = np.full(len(sources), query_pixels // len(sources))
    sizes[:query_pixels % len(sources)] += 1
    ties = tie_partners(threshold)
    for c, n in zip(sources, sizes):
        dst, colours = _piece(rng, data, c, n, mirror, taken)
        cls, s, p = classify(colours)
        for i in np.flatnonzero(rng.random(n) < tie_fraction):
            partners = ties.get((int(s[i]), int(p[i])))
            if cls[i] and partners:
                s2, p2 = partners[int(rng.integers(len(partners)))]
                colours[i] = _rgb_of(int(cls[i]), s2, p2)
        mask[dst] = colours
        taken[dst] = True
    return mask.reshape(h, w, 3), np.flatnonzero(taken & ~excluded.ravel())


def shard_columns(config: dict) -> int:
    """The resident shard's width: the engine's own shard width, which
    the configuration sets (``engine_settings``' ``CDS_TARGET_TILE``)."""
    return int(config["engine_settings"]["CDS_TARGET_TILE"])


def make_cell_data(seed: int, config: dict, traffic: dict) -> CellData:
    """All of a run's inputs from its seed."""
    h, w = config["image"]["height"], config["image"]["width"]
    rng = np.random.default_rng(seed)
    n_bases = config["distinct_targets"]
    bases = np.stack([target_cdm(rng, h, w,
                                 config["target_foreground_pixels"],
                                 config["depth_drift_slices"],
                                 config["depth_noise_slices"])
                      for _ in range(n_bases)])
    col_base, col_flip, col_roll = placements(
        rng, shard_columns(config), n_bases, h, w)
    data = CellData(h, w, bases, col_base, col_flip, col_roll, [], [])
    p = config["params"]
    excluded = label_regions(h, w, p["withNameLabelRegion"],
                             p["withColorScaleRegion"])
    k = config["planted_per_shard"]
    lo, hi = config["mask_union_range"]
    for m in range(traffic["masks_per_call"]):
        sources = np.sort(rng.choice(data.columns, k, replace=False))
        while True:
            mask, flat = cut_mask(
                rng, data, sources, query_pixels=config["mask_query_pixels"],
                mirror=bool(m % 2), excluded=excluded,
                threshold=config["params"]["maskThreshold"],
                tie_fraction=config["tie_fraction"])
            if lo <= shifted_union(flat, h, w) <= hi:
                break
        data.masks.append(mask)
        data.planted.append(sources)
    return data


def encode_png(rgb: np.ndarray) -> bytes:
    """An 8-bit RGB PNG, filter 0 on every row."""
    h, w = rgb.shape[:2]
    raw = np.zeros((h, 1 + w * 3), np.uint8)
    raw[:, 1:] = rgb.reshape(h, w * 3)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 1))
            + chunk(b"IEND", b""))
