"""Synthetic color depth MIPs and a PNG writer, shared by the tests and
``chip_smoke.py``.

A CDM codes depth as hue: every foreground pixel takes the color of the
rainbow LUT (constants.RAINBOW_LUT) at its z-slice, scaled by an
intensity. The generator draws neuron-like strokes — smooth random walks
a few pixels wide whose depth drifts slowly along their length — until
the requested foreground fraction is covered (about 6% for a target,
like the production libraries). Masks are either independent, sparser
images or cut from a target (a box of it, shifted by a few pixels and
optionally mirrored), so that strong matches exist.

For the shape pass every target can carry the two variants that
``precomputeVariants`` writes beside a CDM: a 16-bit gray GradientImage
(random 0..399, 0 on the foreground) and an RGB ZGapImage (the masked
CDM dilated by a per-channel max; the shape oracle takes the z-gap image
as given, so a square window of the reference's radius stands in for
its disk).

Everything is made from an explicitly seeded ``np.random.Generator``.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import os
import struct
import zlib

import numpy as np

from colormipsearch_tpu_torch.constants import RAINBOW_LUT
from colormipsearch_tpu_torch.model import ComputeFileType, LMNeuron, Neuron

_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"


def _png(rows: np.ndarray, w: int, h: int, depth: int,
         color: int) -> bytes:
    """PNG bytes of uint8 [H, row bytes] rows, each stored under filter
    type 0, non-interlaced."""
    raw = np.zeros((h, 1 + rows.shape[1]), np.uint8)
    raw[:, 1:] = rows

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (_PNG_MAGIC
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color,
                                         0, 0, 0))
            # level 1: mostly-black images compress well even so, and
            # writing a 2,048-image library stays a few seconds
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 1))
            + chunk(b"IEND", b""))


def encode_png(rgb: np.ndarray) -> bytes:
    """uint8 [H, W, 3] -> 8-bit RGB PNG bytes (what
    io/image.decode_png_rgb8 reads)."""
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"expected uint8 [H, W, 3], got {rgb.dtype} "
                         f"{rgb.shape}")
    h, w, _ = rgb.shape
    return _png(rgb.reshape(h, 3 * w), w, h, 8, 2)


def encode_png_gray16(gray: np.ndarray) -> bytes:
    """uint16 [H, W] -> 16-bit gray PNG bytes, big-endian samples (what
    io/image.decode_png_gray16 reads)."""
    if gray.dtype != np.uint16 or gray.ndim != 2:
        raise ValueError(f"expected uint16 [H, W], got {gray.dtype} "
                         f"{gray.shape}")
    h, w = gray.shape
    rows = np.ascontiguousarray(gray.astype(">u2")).view(np.uint8)
    return _png(rows.reshape(h, 2 * w), w, h, 16, 0)


def write_png(path, img: np.ndarray) -> None:
    """uint8 [H, W, 3] as 8-bit RGB, uint16 [H, W] as 16-bit gray."""
    data = encode_png_gray16(img) if img.dtype == np.uint16 \
        else encode_png(img)
    with open(path, "wb") as f:
        f.write(data)


_STROKE_WIDTH = 3
_STROKE_LENGTH = 300


def synthetic_cdm(rng: np.random.Generator, height: int, width: int, *,
                  fg_fraction: float = 0.06) -> np.ndarray:
    """One synthetic CDM, uint8 [height, width, 3], with about
    `fg_fraction` of its pixels covered by hue-coded strokes."""
    img = np.zeros((height, width, 3), np.uint8)
    steps = max(1, int(fg_fraction * height * width / _STROKE_WIDTH))
    length = max(8, min(_STROKE_LENGTH, (height + width) // 2))
    n_strokes = max(1, -(-steps // length))
    # smooth random walks: the heading turns a little at each unit step
    heading = rng.uniform(0, 2 * np.pi, (n_strokes, 1)) + np.cumsum(
        rng.normal(0, 0.12, (n_strokes, length)), axis=1)
    y = rng.uniform(0, height, (n_strokes, 1)) + np.cumsum(
        np.sin(heading), axis=1)
    x = rng.uniform(0, width, (n_strokes, 1)) + np.cumsum(
        np.cos(heading), axis=1)
    # depth drifts slowly along a stroke; intensity is set per stroke
    z = np.clip(rng.uniform(0, 255, (n_strokes, 1)) + np.cumsum(
        rng.normal(0, 0.4, (n_strokes, length)), axis=1), 0, 255)
    gain = rng.uniform(0.55, 1.0, (n_strokes, 1)) * np.ones((1, length))
    color = (RAINBOW_LUT[z.astype(np.int64).ravel()]
             * gain.ravel()[:, None]).astype(np.uint8)
    yy = np.rint(y).astype(np.int64).ravel()
    xx = np.rint(x).astype(np.int64).ravel()
    half = _STROKE_WIDTH // 2
    for oy in range(-half, _STROKE_WIDTH - half):
        for ox in range(-half, _STROKE_WIDTH - half):
            py, px = yy + oy, xx + ox
            ok = (py >= 0) & (py < height) & (px >= 0) & (px < width)
            img[py[ok], px[ok]] = color[ok]
    return img


def scattered_pixels(rng: np.random.Generator, height: int, width: int,
                     n: int) -> np.ndarray:
    """uint8 [height, width, 3] with `n` pixels set to random colors at
    random places (every class, ties and near-threshold values occur)."""
    img = np.zeros((height, width, 3), np.uint8)
    ys = rng.integers(0, height, n)
    xs = rng.integers(0, width, n)
    img[ys, xs] = rng.integers(0, 256, (n, 3))
    return img


def cut_mask(rng: np.random.Generator, target: np.ndarray, *,
             shift: tuple[int, int], mirror: bool = False) -> np.ndarray:
    """A mask cut from `target`: the pixels inside a random box covering
    about 40% of the image, moved by `shift` = (dx, dy) and optionally
    mirrored left-right."""
    h, w = target.shape[:2]
    side = np.sqrt(0.4)
    bh, bw = max(1, int(h * side)), max(1, int(w * side))
    y0 = int(rng.integers(0, h - bh + 1))
    x0 = int(rng.integers(0, w - bw + 1))
    cut = np.zeros_like(target)
    cut[y0:y0 + bh, x0:x0 + bw] = target[y0:y0 + bh, x0:x0 + bw]
    dx, dy = shift
    out = np.zeros_like(target)
    out[max(dy, 0):h + min(dy, 0), max(dx, 0):w + min(dx, 0)] = \
        cut[max(-dy, 0):h + min(-dy, 0), max(-dx, 0):w + min(-dx, 0)]
    return np.ascontiguousarray(out[:, ::-1]) if mirror else out


def synthetic_gradient(rng: np.random.Generator, cdm: np.ndarray, *,
                       mask_threshold: int = 20) -> np.ndarray:
    """A GradientImage variant of `cdm`: uint16 [H, W], random 0..399,
    and 0 on the foreground (any channel above `mask_threshold`), as
    precomputeVariants writes it."""
    grad = rng.integers(0, 400, cdm.shape[:2], dtype=np.uint16)
    grad[(cdm > mask_threshold).any(axis=-1)] = 0
    return grad


def _window_max(a: np.ndarray, radius: int, axis: int,
                step: int = 1) -> np.ndarray:
    """max over the elements i + step * d, |d| <= radius, along `axis`
    (zeros outside): windows doubled by shifted np.maximum, then two
    overlapping ones."""
    def span(m, start, stop):
        idx = [slice(None)] * m.ndim
        idx[axis] = slice(start, stop)
        return m[tuple(idx)]

    n = a.shape[axis]
    size = 2 * radius + 1
    pad = [(0, 0)] * a.ndim
    pad[axis] = (radius * step, radius * step)
    m = np.pad(a, pad)
    k = 1  # m[i] = max of the padded a[i + step * j], 0 <= j < k
    while 2 * k <= size:
        m = np.maximum(span(m, 0, m.shape[axis] - k * step),
                       span(m, k * step, None))
        k *= 2
    return np.maximum(span(m, 0, n),
                      span(m, (size - k) * step, (size - k) * step + n))


def synthetic_zgap(cdm: np.ndarray, *, mask_threshold: int = 20,
                   radius: int = 20) -> np.ndarray:
    """A ZGapImage variant of `cdm`: the masked CDM (channels of pixels
    with none above `mask_threshold` cleared) dilated by a per-channel
    max over a (2 radius + 1)^2 square, uint8 [H, W, 3]: 24 shifted
    np.maximum passes at radius 20, which release the GIL."""
    keep = (cdm > mask_threshold).any(axis=-1)
    out = np.where(keep[..., None], cdm, 0).astype(np.uint8)
    h, w = out.shape[:2]
    # rows of interleaved RGB: a pixel's same channel is 3 bytes away
    rows = _window_max(out.reshape(h, 3 * w), radius, 0)
    return _window_max(rows, radius, 1, step=3).reshape(h, w, 3)


@dataclasses.dataclass
class SyntheticLibrary:
    targets: list[np.ndarray]
    masks: list[np.ndarray]


def synthetic_library(rng: np.random.Generator, n_targets: int,
                      n_masks: int, height: int, width: int, *,
                      target_fg: float = 0.06,
                      mask_fg: float = 0.015) -> SyntheticLibrary:
    """Targets at `target_fg` foreground; masks: every other one (at
    least a third of them) cut from a target with a small even or odd
    shift, one of those mirrored, the rest independent sparser images."""
    targets = [synthetic_cdm(rng, height, width, fg_fraction=target_fg)
               for _ in range(n_targets)]
    masks = []
    shifts = [(0, 0), (2, 0), (0, -2), (-2, 2), (1, 0), (0, 3)]
    for i in range(n_masks):
        if i % 2 == 0 and n_targets:
            src = int(rng.integers(0, n_targets))
            masks.append(cut_mask(rng, targets[src],
                                  shift=shifts[(i // 2) % len(shifts)],
                                  mirror=i == 2))
        else:
            masks.append(synthetic_cdm(rng, height, width,
                                       fg_fraction=mask_fg))
    return SyntheticLibrary(targets, masks)


def write_neuron_images(directory, images: list[np.ndarray], prefix: str, *,
                        gradients: list[np.ndarray] | None = None,
                        zgaps: list[np.ndarray] | None = None,
                        threads: int = 8) -> list[Neuron]:
    """Write `images` as PNGs under `directory` and return one neuron
    per image whose InputColorDepthImage is that file. With `gradients`
    / `zgaps`, each neuron's GradientImage / ZGapImage is the variant
    written under `directory`/grad and `directory`/zgap."""
    directory = str(directory)
    jobs = {ComputeFileType.InputColorDepthImage: (directory, "", images)}
    if gradients is not None:
        jobs[ComputeFileType.GradientImage] = (
            os.path.join(directory, "grad"), "_gradient", gradients)
    if zgaps is not None:
        jobs[ComputeFileType.ZGapImage] = (
            os.path.join(directory, "zgap"), "_20pxRGB", zgaps)
    paths = {}
    for ftype, (d, suffix, imgs) in jobs.items():
        if len(imgs) != len(images):
            raise ValueError(f"{len(imgs)} {ftype.value} variants for "
                             f"{len(images)} images")
        os.makedirs(d, exist_ok=True)
        paths[ftype] = [os.path.join(d, f"{prefix}{i:05d}{suffix}.png")
                        for i in range(len(images))]
    with concurrent.futures.ThreadPoolExecutor(max_workers=threads) as pool:
        for ftype, (_, _, imgs) in jobs.items():
            list(pool.map(write_png, paths[ftype], imgs))
    neurons = []
    for i in range(len(images)):
        n = LMNeuron(mip_id=f"{prefix}-{i:05d}", library_name="synthetic",
                     published_name=f"{prefix}{i:05d}")
        for ftype, ps in paths.items():
            n.set_compute_file(ftype, ps[i])
        neurons.append(n)
    return neurons


# The edge shapes of the union kernels (K3, K13, row 14), which split the
# union into chunks over the grid: (name, xy_shift, mirror, masks in the
# batch, union cut to this many elements or None, slot-2 prefix u2 or
# None for the batch's own, union elements a block (0: the kernel's
# choice)). 17 and 25 lanes take two and three lane groups of 9.
UNION_EDGE_CASES = (
    ("lanes_25", 6, True, 3, None, None, 0),
    ("lanes_17", 4, True, 2, None, None, 256),
    ("no_mirror", 2, False, 3, None, None, 0),
    ("batch_1", 2, True, 1, None, None, 128),
    ("ragged_union", 2, True, 2, 1700, None, 256),
    ("u2_on_chunk_edge", 2, True, 2, None, 512, 256),
    ("u2_past_chunk_edge", 2, True, 2, None, 513, 256),
    ("u2_before_chunk_edge", 2, True, 2, None, 511, 256),
    ("u2_inside_ragged_chunk", 2, True, 2, 1700, 300, 200),
)


def union_edge_batch(rng: np.random.Generator, case: tuple, h: int, w: int,
                     device) -> dict:
    """One UNION_EDGE_CASES batch on `device`, from random masks of h x
    w: {"union": (u_pos, mu_pos, lane_lo, lane_span, u2) for K3 and K13,
    "qkeys": (u_pos, mu_pos, qidx, key_list, tab_lo, tab_span, u2) for
    row 14, "chunk": chunk}. The lane tables are K2's expansion (its
    plain version); a cut union keeps the first elements of every
    array."""
    from colormipsearch_tpu_torch import convert
    from colormipsearch_tpu_torch.oracle.pixel import shift_offsets
    from colormipsearch_tpu_torch.ops import pixel_match as pm

    _, xy, mirror, n_masks, cut, u2, chunk = case
    plans = [pm.build_full_union_key_plan(
        scattered_pixels(rng, h, w, 250), 20, mirror=mirror, xy_shift=xy,
        pix_color_fluctuation=1.0, light=True) for _ in range(n_masks)]
    u_pos, mu_pos, q_pos, key_list, own_u2 = pm.stack_union_pos_args(
        plans, h * w)
    qidx = pm.stack_union_qkey_args(plans, h * w)[2]
    tabs = convert.interval_tables(pm.interval_table_arrays(0.01), device)
    u_t, kl_t = (convert.as_tensor(a, device) for a in (u_pos, key_list))
    lo, sp = pm.expand_union_tables_from_pos_plain(
        u_t, convert.as_tensor(q_pos, device), kl_t, *tabs,
        offsets=tuple(shift_offsets(xy)), w=w, h=h)
    qidx_t = convert.qidx(qidx, device)
    mu_t = convert.as_tensor(mu_pos, device)
    if cut is not None:
        u_t, mu_t, lo, sp, qidx_t = (x[..., :cut].contiguous() for x in (
            u_t, mu_t, lo, sp, qidx_t))
    u2 = own_u2 if u2 is None else u2
    if not 0 <= u2 < u_t.shape[2]:
        raise ValueError(f"{case[0]}: u2 {u2} outside the union of "
                         f"{u_t.shape[2]}")
    return {"union": (u_t, mu_t, lo, sp, u2),
            "qkeys": (u_t, mu_t, qidx_t, kl_t, *tabs, u2), "chunk": chunk}
