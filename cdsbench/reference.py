"""The plain reference of the pixel-match score, in PyTorch.

A frozen restatement of the reference's positive score
(``cds/PixelMatchColorDepthSearchAlgorithm.java``), copied from the
float64 oracle ``colormipsearch_tpu_torch/oracle/pixel.py`` (the class
rule of ``classify_rgb`` :42, the ratio of ``ratio_f64`` :87, the gap of
``pixel_gap`` :99, the shifts of ``shift_offsets`` :137 and the mirror of
``PixelMatchOracle.__init__`` :229), batched over target columns. It
imports nothing of the program and reads none of its state: it scores
the masks the benchmark made against the columns the benchmark made,
from their pixels.

The target columns are held pixel-major, one int32 code a pixel and
column, ``class << 16 | s << 8 | p`` where the pixel is above the data
threshold and 0 where it is not, with a zero row at index P for every
shifted position that leaves the image. Query pixels are scored a
class at a time, against the target classes that the gap can accept.
``dtype`` float64 is the reference; float32 is the control, the same
arithmetic one precision lower.
"""

from __future__ import annotations

import numpy as np
import torch

from cdsbench import data as D

BR_BG = 0.354862745
BG_GB = 0.996078431
GB_GR = 0.505882353
GR_RG = 0.996078431
RG_RB = 0.505882353

# (query class, target class, query condition, target condition, the
# query's and the target's term of the gap); the gap is their sum, in
# this order of operations (IEEE addition commutes)
_ADJACENT = (
    (1, 2, lambda r: r < 0.44, lambda r: r < 0.54,
     lambda r: r - BR_BG, lambda r: r - BR_BG),
    (2, 1, lambda r: r < 0.54, lambda r: r < 0.44,
     lambda r: r - BR_BG, lambda r: r - BR_BG),
    (2, 3, lambda r: r > 0.8, lambda r: r > 0.8,
     lambda r: BG_GB - r, lambda r: BG_GB - r),
    (3, 2, lambda r: r > 0.8, lambda r: r > 0.8,
     lambda r: BG_GB - r, lambda r: BG_GB - r),
    (3, 4, lambda r: r < 0.7, lambda r: r < 0.7,
     lambda r: r - GB_GR, lambda r: r - GB_GR),
    (4, 3, lambda r: r < 0.7, lambda r: r < 0.7,
     lambda r: r - GB_GR, lambda r: r - GB_GR),
    (4, 5, lambda r: r > 0.8, lambda r: r > 0.8,
     lambda r: GR_RG - r, lambda r: GR_RG - r),
    (5, 4, lambda r: r > 0.8, lambda r: r > 0.8,
     lambda r: GR_RG - r, lambda r: GR_RG - r),
    (5, 6, lambda r: r < 0.7, lambda r: r < 0.7,
     lambda r: r - RG_RB, lambda r: r - RG_RB),
    (6, 5, lambda r: r < 0.7, lambda r: r < 0.7,
     lambda r: r - RG_RB, lambda r: r - RG_RB),
)


def shift_offsets(xy_shift: int) -> list:
    """The shift variants, in the reference's order."""
    if xy_shift <= 0:
        return [(0, 0)]
    out = []
    for i in range(2, xy_shift + 1, 2):
        for dx in (-i, 0, i):
            for dy in (-i, 0, i):
                if (dx, dy) == (0, 0) and i > 2:
                    continue
                out.append((dx, dy))
    return out


def ratio(cls, s, p, dtype):
    """s/p in `dtype`; 0 where the class is none or s is 0."""
    num = s.to(dtype)
    den = torch.where(p == 0, torch.ones_like(p), p).to(dtype)
    return torch.where((cls != 0) & (s != 0), num / den,
                       torch.zeros((), dtype=dtype, device=num.device))


def target_codes(rgb: torch.Tensor, threshold: int) -> torch.Tensor:
    """int32 ``class << 16 | s << 8 | p`` of uint8 [N, 3] target pixels
    above `threshold` (any channel), 0 for the others: the class rule of
    ``classify_rgb`` (ties, black included, have class 0)."""
    r, g, b = (rgb[:, i].to(torch.int32) for i in range(3))
    cls = torch.zeros_like(r)
    s = torch.zeros_like(r)
    p = torch.zeros_like(r)
    b_dom = (b > r) & (b > g)
    g_dom = (g > b) & (g > r)
    r_dom = (r > b) & (r > g)
    for m, cid, sec, prim in ((b_dom & (r > g), 1, r, b),
                              (b_dom & ~(r > g), 2, g, b),
                              (g_dom & (b > r), 3, b, g),
                              (g_dom & ~(b > r), 4, r, g),
                              (r_dom & (g > b), 5, g, r),
                              (r_dom & ~(g > b), 6, b, r)):
        cls = torch.where(m, cid, cls)
        s = torch.where(m, sec, s)
        p = torch.where(m, prim, p)
    fg = (rgb > threshold).any(dim=1)
    return torch.where(fg, (cls << 16) | (s << 8) | p, 0)


class Query:
    """A mask's query pixels and their shifted and mirrored lookups
    (oracle/pixel.py:213-236)."""

    def __init__(self, mask_rgb: np.ndarray, threshold: int,
                 excluded: np.ndarray | None, xy_shift: int, mirror: bool):
        h, w = mask_rgb.shape[:2]
        fg = (mask_rgb > threshold).any(axis=-1)
        if excluded is not None:
            fg &= ~excluded
        self.positions = np.flatnonzero(fg.reshape(-1))
        self.size = int(self.positions.size)
        cls, s, p = D.classify(mask_rgb.reshape(-1, 3)[self.positions])
        self.cls, self.s, self.p = cls, s, p
        x, y = self.positions % w, self.positions // w
        straight = []
        for dx, dy in shift_offsets(xy_shift):
            ok = (x + dx >= 0) & (x + dx < w) & (y + dy >= 0) & (y + dy < h)
            straight.append(np.where(ok, (y + dy) * w + x + dx, -1))
        self.variants = [np.stack(straight)]
        if mirror:
            v = self.variants[0]
            self.variants.append(np.where(v < 0, -1, v + (w - 1)
                                          - 2 * (v % w)))
        self.n_pixels = h * w

    def rows(self) -> np.ndarray:
        """Every distinct target position that a variant reads."""
        v = np.concatenate([a.ravel() for a in self.variants])
        return np.unique(v[v >= 0])


class Reference:
    """Scores of masks against every column of the benchmark's shard."""

    def __init__(self, data: D.CellData, params: dict,
                 device: torch.device, dtype=torch.float64,
                 block_columns: int = 256):
        self.params = params
        self.device = device
        self.dtype = dtype
        h, w = data.height, data.width
        n_px = h * w
        base_codes = torch.cat([
            target_codes(torch.from_numpy(b).to(device).reshape(-1, 3),
                         params["dataThreshold"]) for b in data.bases])
        n_c = data.columns
        self.planes = torch.zeros((n_px + 1, n_c), dtype=torch.int32,
                                  device=device)
        yy = torch.arange(h, device=device).view(1, h, 1)
        xx = torch.arange(w, device=device).view(1, 1, w)
        for c0 in range(0, n_c, block_columns):
            cols = slice(c0, min(c0 + block_columns, n_c))
            base = torch.from_numpy(data.col_base[cols]).to(device)
            flip = torch.from_numpy(data.col_flip[cols]).to(device)
            roll = torch.from_numpy(data.col_roll[cols]).to(device)
            # column[y, x] = base[(y - ry) % H, f((x - rx) % W)], f the flip
            sy = (yy - roll[:, 0].view(-1, 1, 1)) % h
            sx = (xx - roll[:, 1].view(-1, 1, 1)) % w
            sx = torch.where(flip.view(-1, 1, 1), w - 1 - sx, sx)
            idx = base.view(-1, 1, 1) * n_px + sy * w + sx
            self.planes[:n_px, cols] = base_codes[idx.reshape(
                idx.shape[0], -1)].T
        self._tol = torch.tensor(params["pixColorFluctuation"] / 100.0,
                                 dtype=torch.float64).to(dtype).item()

    def query(self, mask_rgb: np.ndarray) -> Query:
        p = self.params
        excluded = D.label_regions(*mask_rgb.shape[:2],
                                   p["withNameLabelRegion"],
                                   p["withColorScaleRegion"])
        return Query(mask_rgb, p["maskThreshold"], excluded,
                     p["xyShift"], p["mirrorMask"])

    def _count(self, rows: torch.Tensor, q_cls: int, r1: torch.Tensor):
        """Matches a column of the query pixels of class `q_cls` (ratios
        r1) whose lookups are `rows`."""
        g = self.planes.index_select(0, rows)
        t_cls = g >> 16
        r2 = ratio(t_cls, (g >> 8) & 255, g & 255, self.dtype)
        tol = self._tol
        r1c = r1.view(-1, 1)
        hit = (t_cls == q_cls) & (r1c > 0) & (r2 > 0) \
            & ((r2 - r1c).abs() <= tol)
        for qc, tc, q_ok, t_ok, q_term, t_term in _ADJACENT:
            if qc != q_cls:
                continue
            hit |= (t_cls == tc) & q_ok(r1c) & t_ok(r2) \
                & ((q_term(r1c) + t_term(r2)) <= tol)
        return hit.sum(dim=0)

    def score(self, q: Query, block_rows: int = 4096):
        """(best int64 [C], mirrored bool [C]): the best variant's count
        of matching pixels, straight against mirrored as the oracle
        decides (mirrored only when strictly better)."""
        dev = self.device
        cls = torch.from_numpy(q.cls).to(dev)
        r = ratio(cls, torch.from_numpy(q.s).to(dev),
                  torch.from_numpy(q.p).to(dev), self.dtype)
        sentinel = q.n_pixels
        best = []
        for variants in q.variants:
            v = torch.from_numpy(variants).to(dev)
            v = torch.where(v < 0, sentinel, v)
            counts = torch.zeros((v.shape[0], self.planes.shape[1]),
                                 dtype=torch.int64, device=dev)
            for k in range(1, 7):
                sel = torch.nonzero(cls == k).view(-1)
                for i0 in range(0, sel.numel(), block_rows):
                    part = sel[i0:i0 + block_rows]
                    for j in range(v.shape[0]):
                        counts[j] += self._count(v[j, part], k, r[part])
            best.append(counts.max(dim=0).values)
        if len(best) == 1:
            return best[0], torch.zeros_like(best[0], dtype=torch.bool)
        return torch.maximum(best[0], best[1]), best[1] > best[0]
