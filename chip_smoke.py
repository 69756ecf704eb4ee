#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (colormipsearch_tpu_torch) on one GPU.

    python3 chip_smoke.py [--targets 2048] [--masks 32] [--gs-masks 16]
                          [--seed 0]

Phases, in order; any failure raises and the exit code is non-zero:

  0. the card (nvidia-smi name and power limit), torch / CUDA versions
     and the repo commit; exits 1 when CUDA is not available;
  1. builds the seventeen CUDA kernels from kernels/csrc (one nvcc per
     source, all at once, sm_90a);
  2. checks each kernel against its plain PyTorch version on the card at
     the main paths' shapes (production image 566 x 1210; for the
     pixel-match kernels a 2,048-column target shard, a batch of 8 masks,
     top-k 256; K8 on the 2,048-target stack in its three modes, K12 in
     its three modes on those summary planes and on K1's key planes, K9
     and K11 at --pixColorFluctuation 1.0 and 0.37, K10, K13 on the K3
     batch; for the shape kernels the support of the first cut mask,
     both orientations, 2,048 targets and a device store of those 2,048
     targets; rows 13 and 14, the qkey wire form, on K3's batch; row 18b
     in both modes on the dense packs of the first cut mask's support,
     both orientations and 2,048 targets; row 15 on the 2,048-target
     stack and on a dense [64, 566 x 1210] stack of uniform random RGB
     with no black pixel; K4's flag gather on K9's batch): exact equality
     (K9's and K11's ambiguity flags included),
     the median time of each kernel, of its plain version and of the one
     PyTorch call that computes the same function where there is one,
     and each kernel's bound; and each re-encoding against what it
     re-encodes: K12's key planes equal K8's and K1's, K12's split pair
     K8's split mode, K11's counts and flags K9's, K13's scores K3's; row
     13's lane tables K2's, row 14's scores K3's, row 18b's scores after
     the mirror selection K5's, row 15's slice numbers the float64 slice
     table's everywhere but at exact ties (counted); K4's yardstick,
     torch.topk of its own int64 sort keys, with equal indices; and the
     redesigned kernels at their edge shapes (K1 at every
     testing.SCATTER_EDGE_CASES input, K2 at every
     testing.EXPAND_EDGE_CASES input; K3, K13 and row 14 at every
     testing.UNION_EDGE_CASES batch, at the case's union chunk and the
     kernel's own; K9 and K11 at 301 and 300 columns and a query that is
     not a multiple of the chunk; K6 at every testing.TILE_EDGE_CASES
     shape and K5 at every testing.SPLIT_EDGE_CASES shape, through both
     its loaders), each equal to its plain version; K6 also with the
     engine's store rows (a sorted subset of 1,638, timed beside an
     `arange` of as many) and with a permutation of the 2,048, its bound
     from the 32-byte sectors the gathers touch; K4 alone and through its
     wrapper at chip_smoke's k, at the k the engine picks in phase 3 and
     at k = T (its bitonic branch), with the flag gather on K9's batch,
     beside an empty kernel's launch; K4 at every testing.TOPK_EDGE_CASES
     input and K7 at every testing.PIXEL_MAJOR_EDGE_CASES shape (aligned
     and shifted sources); K7's uint8 mode on the whole tfg field (one
     [2,048, ceil(P / 8)] chunk) beside its int16 chunk; row 15 at every
     testing.SLICE_NUMBERS_EDGE_CASES input and K8's split mode at every
     testing.PACK_SPLIT_EDGE_CASES input, both over every (class, p, s)
     and channel tie; both alone (no wrapper) beside their wrapper's
     time;
  3. drives colorDepthSearch end to end through the CLI entry point on a
     synthetic library written as PNGs (default 2,048 targets x 32
     masks, production flags), requires every pixel-match kernel's
     launch counter to grow during that run, and checks the results
     against the float64 PixelMatchOracle;
  4. drives gradientScores end to end through the CLI entry point: a
     colorDepthSearch of the first --gs-masks masks with
     --pctPositivePixels 0 lists every target that scores above 0; a
     gradientScores run with a packed-variant store and the
     device-resident store (CDS_SHAPE_STORE_DEVICE=1: the first mask
     group decodes and writes the store, every later group builds its
     planes on the card from the uploaded store) must launch K7, K6 and
     K5; a second gradientScores run on 2 masks without the store (the
     default path: host planes, then K5) must launch K5;
  5. checks sampled pairs of both phase-4 runs against the float64
     ShapeMatchOracle (gradientAreaGap and highExpressionArea exactly,
     normalizedScore within the JSON's float32 rounding);
  6. drives colorDepthSearch through the CLI on the first 16 masks six
     times: the default path, the packed path
     (--use-union-keys off: K8 + K9, flagged pairs rescored by the
     float64 oracle), the classic key kernel (--use-key-planes: K1 +
     K10), the x-union form (--use-union-keys x: K1 + K3), the dense
     key upload (CDS_DENSE_UPLOAD=1: K8 + K2 + K3) and the split planes
     (--use-union-keys off with CDS_SPLIT_PLANES=1: K8, K12 + K11); every
     result tree must be byte-identical to the default run's, each run
     must launch its kernels, and the split run must rescore as many
     flagged pairs as the packed run. Then color_depth_search(...,
     neg_query=<a mask image>, mirror_neg_query=True, device="cuda") on
     8 masks must launch K10 for its negative pass, a second one with
     CDS_SPLIT_PLANES=1 and CDS_UNION_KEYS=0 K11 for its positive pass
     and K9 for its negative one; both must find the same matches, and
     16 sampled matches must equal the float64 PixelMatchOracle's with
     the negative query;
  7. the device mesh (parallel/mesh.py) at 4 target shards of one card:
     (a) every mesh step on phase 2's shapes, as the JAX package's
     dryrun_multichip drives them (the search, packed, split, key,
     union-key and qkey steps, dense and with a per-shard top-k of 256;
     the dense shape step in both modes; the split shape step): each
     equals the single-device kernels, the top-k steps a per-shard top-k
     of the single-device scores, the qkey step the union-key step fed
     with row 13's expansion; each step's time beside the single-device
     kernel's; (b) CDSearchEngine(use_mesh=create_mesh(["cuda:0"] * 4))
     on the phase-3 library five ways (default, packed and split on 8
     masks, --use-key-planes, default with max_matches_per_mask): every
     match equal to the single-device engine's, every run through its
     mesh step; (c) a negative query on the mesh (8 masks); (d)
     GradScoreEngine over the mesh with the device store on 4 masks of
     phase 4's candidates: every shape score equal to the single-device
     run's. The new kernels' launches in the kernels line are phase 7's;
  8. the image readers that need no PIL (the GPU hosts have none): the
     files of tests/torch_forms (one of every decoded family: JPEGs
     baseline, progressive, block-smoothed, CMYK, arithmetic-coded,
     lossless and with corrupt data; a GIF; TIFFs palette, CCITT Group 4,
     tiled JPEG, RGBA, CMYK, float, CIELab, palette + alpha, signed
     32-bit, 4-bit gray, LZMA, Zstandard and CCITT RLE) decode to the
     pixels pinned beside them; colorDepthSearch on the card over a small
     library with those files among its targets skips none and finds the
     pinned matches; each reader's time for one 566 x 1210 image (CCITT,
     tiled JPEG in TIFF, arithmetic, block smoothing, lossless, LZMA,
     Zstandard (a file libzstd wrote, tests/torch_forms) and CIELab among
     them);
  9. the file pipeline with the port's CLI alone, on phase 3's library:
     (a) createColorDepthSearchDataInput over the targets (with their
     grad/ and zgap/ variants) and the masks writes the compute files
     write_library recorded, and a colorDepthSearch from those inputs on
     the first 8 masks finds phase 3's matches; (b)
     normalizeGradientScores over phase 4's store run writes
     oracle/shape.normalized_score of each file's eligible rows and
     changes no other field; (c) createColorDepthSearchJSONInput, then
     searchFromJSON (8 masks x every target) must launch K1-K4 and find
     (a)'s matches; (d) searchLocalFiles --with-grad-scores must launch
     K1-K5, find (c)'s matches, and 16 sampled rows' shape scores must
     equal the float64 ShapeMatchOracle's; (e) gradientScore over (c)'s
     files must launch K5, 16 sampled rows must equal the oracle's and
     every row (d)'s; (f) searchFromJSON over the two halves of the
     target list, then mergeResults of both, must give (c)'s rows. Each
     step prints its wall seconds, its rate and its launches; phase 9's
     launches stay out of the kernels line;
 10. the mesh across processes (parallel/mesh.py over torch.distributed,
     each rank started by parallel/launch.py): (a) the launcher's
     selftest under NCCL at world size 1 with 4 local shards of cuda:0
     and (b) under gloo at 2 ranks x 2 shards of cuda:0, at phase 2's
     shapes: every sharded step (dense and with a per-shard top-k) equal
     to the single-device kernels in every rank, the collective counters
     grown, gloo's host staging counted; (c) colorDepthSearch through the
     launcher at 2 ranks on phase 9 (a)'s inputs: each rank writes a
     part, the union equals phase 9 (a)'s matches, each rank launched
     K1-K4 and ran its collectives. Each step prints its wall seconds,
     each rank's peak GiB and the step times beside phase 7's; a failing
     rank fails the phase. Phase 10's launches stay out of the kernels
     line;
 11. the DB pipeline (persist/: one sqlite store under build/) with the
     port's CLI on phase 3's library: (a) createColorDepthSearchDataInput
     --mips-storage DB over the targets (with their variants) and the
     masks stores phase 9 (a)'s neurons; (b) colorDepthSearch
     --mips-storage DB --results-storage DB on the first 4 of phase 4's
     masks with phase 3's flags must launch K1-K4 and store phase 3's
     matches, then with phase 4's (--pctPositivePixels 0, no emit top-k)
     K1-K3 and phase 4's candidates, the first run's rows keeping their
     ids; (c)
     gradientScores --results-storage DB with phase 4's packed-variant
     store and the device-resident store and a processing tag must
     launch K5-K7, store phase 4's shape scores and tag exactly the
     scored matches' neurons; (d) normalizeGradientScores
     --results-storage DB must store phase 9 (b)'s normalized scores.
     Each step prints its wall seconds, rows/s, the store's size, the
     seconds of its store writes and reads, its peak GiB and launches;
     the launches of (b) and (c) are added to the kernels line.

The line before the last is the kernels' JSON summary; the last line is
{"ok": true, "device": {...}}. All data is generated from --seed under
the checkout's build/ directory and removed afterwards; the slice table
(2^24 entries, ~14 s of host time the first time) is cached under
build/cache unless COLORMIPSEARCH_TPU_CACHE names another directory.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
H, W = 566, 1210
T_PAD = 2048
BATCH = 8
TOP_K = 256
CLASSIC_MASKS = 16  # phase 6: two batches, ~250 flagged pairs rescored
DEVICE = "cuda"
FLAGS = ["--maskThreshold", "20", "--dataThreshold", "20",
         "--pixColorFluctuation", "1.0", "--xyShift", "2", "--mirrorMask",
         "--pctPositivePixels", "1.0"]
# where each kernel lives and the jitted JAX function it replaces
_CSRC = "colormipsearch_tpu_torch/kernels/csrc"
CDS_KERNELS = {
    "scatter_key_planes": (
        f"{_CSRC}/scatter_keys.cu", "colormipsearch_tpu/ops/common.py:211"),
    "expand_union_tables_from_pos": (
        f"{_CSRC}/expand_tables.cu",
        "colormipsearch_tpu/ops/pixel_match.py:1684"),
    "score_query_batch_union_keys": (
        f"{_CSRC}/union_score.cu",
        "colormipsearch_tpu/ops/pixel_match.py:1366"),
    "union_keys_topk": (
        f"{_CSRC}/topk.cu", "colormipsearch_tpu/ops/pixel_match.py:1517"),
}
GS_KERNELS = {
    "shape_score_pairs_split": (
        f"{_CSRC}/shape_split.cu",
        "colormipsearch_tpu/ops/shape_score.py:816"),
    "shape_tile_device": (
        f"{_CSRC}/shape_tile.cu",
        "colormipsearch_tpu/ops/shape_score.py:633"),
    "upload_pixel_major": (
        f"{_CSRC}/pixel_major.cu",
        "colormipsearch_tpu/ops/shape_score.py:601"),
}
CLASSIC_KERNELS = {
    "pack_target_planes": (
        f"{_CSRC}/pack_planes.cu", "colormipsearch_tpu/ops/common.py:82"),
    "pack_target_planes_keys": (
        f"{_CSRC}/pack_planes.cu", "colormipsearch_tpu/ops/common.py:185"),
    "score_query_batch": (
        f"{_CSRC}/banded_score.cu",
        "colormipsearch_tpu/ops/pixel_match.py:487"),
    "score_query_batch_keys": (
        f"{_CSRC}/key_score.cu",
        "colormipsearch_tpu/ops/pixel_match.py:878"),
}
# K8's split mode, K12 (three modes), K11 and K13
SPLIT_KERNELS = {
    "pack_target_planes_split": (
        f"{_CSRC}/pack_planes.cu", "colormipsearch_tpu/ops/common.py:101"),
    "split_planes_from_packed": (
        f"{_CSRC}/repack_planes.cu", "colormipsearch_tpu/ops/common.py:121"),
    "key_planes_from_packed": (
        f"{_CSRC}/repack_planes.cu", "colormipsearch_tpu/ops/common.py:308"),
    "split_key_planes": (
        f"{_CSRC}/repack_planes.cu",
        "colormipsearch_tpu/ops/pixel_match.py:1544"),
    "score_query_batch_split": (
        f"{_CSRC}/banded_score.cu",
        "colormipsearch_tpu/ops/pixel_match.py:559"),
    "score_query_batch_union_keys_splitk": (
        f"{_CSRC}/union_score.cu",
        "colormipsearch_tpu/ops/pixel_match.py:1612"),
}
# rows 13, 14, 18b (the mesh path's) and 15 (on no path)
MESH_KERNELS = {
    "expand_union_tables": (
        f"{_CSRC}/expand_tables.cu",
        "colormipsearch_tpu/ops/pixel_match.py:1633"),
    "score_query_batch_union_qkeys": (
        f"{_CSRC}/union_score.cu",
        "colormipsearch_tpu/ops/pixel_match.py:1806"),
    "shape_score_pairs": (
        f"{_CSRC}/shape_dense.cu",
        "colormipsearch_tpu/ops/shape_score.py:764"),
    "slice_numbers_device": (
        f"{_CSRC}/slice_numbers.cu",
        "colormipsearch_tpu/ops/shape_score.py:96"),
}
KERNELS = {**CDS_KERNELS, **GS_KERNELS, **CLASSIC_KERNELS, **SPLIT_KERNELS,
           **MESH_KERNELS}
MESH_SHARDS = 4         # phase 7: target shards of the mesh, one card
MESH_MASKS = 16         # phase 7 (b): masks of the engine runs
MESH_RESCORE_MASKS = 8  # phase 7 (b): the packed and split runs (rescore)
MESH_GS_MASKS = 4       # phase 7 (d): mask files of the gradScores runs
P9_MASKS = 8            # phase 9: masks of the file-pipeline searches
P9_SAMPLES = 16         # phase 9 (d), (e): rows held to ShapeMatchOracle
P10_TIMEOUT = 300       # phase 10: the launcher's collective timeout, s
# phase 11 (b)-(d): the first 4 of phase 4's 16 masks (~6,600 stored
# matches): the store commits every row (~3 ms each on an H100 host),
# and at 8 masks phase 11 took 223 s of a 913 s run there
P11_MASKS = 4
P11_TAG = "p11"         # phase 11 (c): the shape pass's processing tag
# phase 10: the selftest's steps whose times phase 7 took (its keys)
P10_PHASE7_STEPS = {"search": "search (K9, one mask)", "batch": "batch (K9)",
                    "batch_split": "batch_split (K11)",
                    "batch_keys": "batch_keys (K10)",
                    "batch_union_keys_full": "batch_union_keys (K3)",
                    "batch_union_qkeys": "batch_union_qkeys (row 14)",
                    "shape": "shape (row 18b)",
                    "shape_both": "shape_both (row 18b)",
                    "shape_split": "shape_split (K5)"}
# the bound of a kernel: the larger of its bytes over the HBM rate and its
# operations over their issue rate (NVIDIA H100 SXM: 3.35 TB/s; 132 SMs at
# up to 1.98 GHz, each issuing 128 f32 and 64 int32 lane operations a
# clock: 33.5e12 f32 operations a second, the data sheet's 67 TFLOP/s with
# an FMA counted as one operation rather than two, and 16.7e12 integer
# and compare operations a second). The two pipes run side by side, so
# the operations take the larger of their two times.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 128 * 132 * 1.98e9
INT_OPS_PER_S = 64 * 132 * 1.98e9
# phase-6 runs of colorDepthSearch on the first CLASSIC_MASKS masks:
# (name, extra CLI flags, environment, the kernels the run must launch)
CLASSIC_RUNS = (
    ("default", [], {}, tuple(CDS_KERNELS)),
    ("packed", ["--use-union-keys", "off"], {},
     ("pack_target_planes", "score_query_batch")),
    ("key_planes", ["--use-key-planes"], {},
     ("scatter_key_planes", "score_query_batch_keys")),
    ("x_union", ["--use-union-keys", "x"], {},
     ("scatter_key_planes", "score_query_batch_union_keys")),
    ("dense_upload", [], {"CDS_DENSE_UPLOAD": "1"},
     ("pack_target_planes_keys", "expand_union_tables_from_pos",
      "score_query_batch_union_keys")),
    ("split", ["--use-union-keys", "off"], {"CDS_SPLIT_PLANES": "1"},
     ("pack_target_planes", "split_planes_from_packed",
      "score_query_batch_split")),
)
# the phase-6 run whose launches each kernel of K8-K13 reports (K8's
# split mode, K12's key and split-key modes and K13 are on no path of
# either engine: their launches stay phase 3's, 0)
CLASSIC_MAIN_RUN = {"pack_target_planes": "packed",
                    "score_query_batch": "packed",
                    "score_query_batch_keys": "key_planes",
                    "pack_target_planes_keys": "dense_upload",
                    "split_planes_from_packed": "split",
                    "score_query_batch_split": "split"}


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def commit() -> str:
    try:
        out = subprocess.run(["git", "-C", REPO, "rev-parse", "HEAD"],
                             capture_output=True, text=True, timeout=60)
        return out.stdout.strip() or "unknown (not a git checkout)"
    except (OSError, subprocess.SubprocessError):
        return "unknown (git unavailable)"


def sync() -> None:
    import torch

    torch.cuda.synchronize()


def reset_peak() -> None:
    import torch

    torch.cuda.reset_peak_memory_stats()


def peak_gib() -> float:
    import torch

    return torch.cuda.max_memory_allocated() / 2**30


def free_cached() -> None:
    import torch

    torch.cuda.empty_cache()


def timed(fn, repeats: int) -> float:
    """Median milliseconds of fn() on the card (CUDA events, after one
    warm-up call)."""
    import torch

    fn()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def timed_loop(fn, repeats: int) -> float:
    """Mean milliseconds of fn() over `repeats` back-to-back calls between
    two CUDA events (after one warm-up call): for a launch of a few
    microseconds, the events' own cost no longer counts."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats


def max_abs_err(got, want) -> int:
    """Largest elementwise difference over matching output tuples, taken
    2^26 elements at a time (the planes hold 1.4e9); raises when shapes
    or dtypes differ."""
    err = 0
    for a, b in zip(got, want):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"output mismatch: {a.shape} {a.dtype} vs "
                                 f"{b.shape} {b.dtype}")
        a, b = a.reshape(-1), b.reshape(-1)
        for i in range(0, a.numel(), 1 << 26):
            d = a[i:i + (1 << 26)].long() - b[i:i + (1 << 26)].long()
            err = max(err, int(d.abs().max()))
    return err


def bound(n_bytes: float, int_ops: float, f32_ops: float = 0) -> dict:
    """The least time the card could take: the larger of the bytes over
    the HBM rate and the operations' time, itself the larger of the
    integer operations over their issue rate and the f32 ones over
    theirs."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(int_ops / INT_OPS_PER_S, f32_ops / F32_OPS_PER_S) * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def entry(err: int, ms: float, plain_ms: float, bound_: dict,
          library_ms: float | None = None) -> dict:
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, **bound_}


def nbytes(*xs) -> int:
    return sum(x.numel() * x.element_size() if hasattr(x, "element_size")
               else x.nbytes for x in xs)


def require_equal(what: str, got, want) -> None:
    """Raise unless the tensors of `got` equal those of `want` exactly."""
    err = max_abs_err(got, want)
    print(f"{what}: max_abs_err {err}", flush=True)
    if err:
        raise AssertionError(f"{what}: the outputs differ")


def report(out: dict) -> None:
    for name, e in out.items():
        lib_ms = ("none" if e["library_ms"] is None
                  else f"{e['library_ms']:.3f} ms")
        print(f"{name}: max_abs_err {e['max_abs_err']}, kernel "
              f"{e['ms']:.3f} ms, plain {e['plain_ms']:.3f} ms, library "
              f"{lib_ms}, bound {e['bound_ms']:.3f} ms ({e['bound_by']})",
              flush=True)
        if e["max_abs_err"] != 0:
            raise AssertionError(f"{name} disagrees with its plain version")


def check_kernels(lib, device) -> tuple[dict, dict]:
    """Phase 2, pixel match: every kernel against its plain version at
    the main path's shapes. Returns ({kernel: entry(...)}, K1's planes
    and K3's batch, inputs, outputs and bound terms, which
    check_classic_kernels re-encodes)."""
    import numpy as np
    import torch

    from colormipsearch_tpu_torch import convert
    from colormipsearch_tpu_torch.kernels import build as kbuild
    from colormipsearch_tpu_torch.oracle.pixel import (
        label_regions_mask,
        shift_offsets,
    )
    from colormipsearch_tpu_torch.ops import common, pixel_match as pm

    out = {}
    n_px = H * W
    stack = np.stack(lib.targets[:T_PAD])
    pos, rgb, cum = common.coo_foreground(stack, 20, T_PAD)
    del stack
    args1 = (torch_from(pos, device), torch_from(rgb, device),
             torch_from(cum, device), common.rank_lut_tensor(device))
    kw1 = dict(n_px=n_px, t_pad=T_PAD)
    planes = common.scatter_key_planes(*args1, **kw1)
    plain = common.scatter_key_planes_plain(*args1, **kw1)
    err = max_abs_err([planes], [plain])
    del plain
    # per element: the classification and key (~16 operations); the
    # planes written once
    out["scatter_key_planes"] = entry(
        err, timed(lambda: common.scatter_key_planes(*args1, **kw1), 5),
        timed(lambda: common.scatter_key_planes_plain(*args1, **kw1), 3),
        bound(nbytes(*args1) + 4 * (n_px + 1) * T_PAD, pos.size * 16))
    # a zero fill of the planes (the cost of writing them once), then
    # the kernel alone (no allocation), which leaves K1's planes again
    fill_ms = timed(planes.zero_, 5)
    kernel_ms = timed(lambda: kbuild.check(kbuild.load_library()
                                           .cmst_scatter_keys(
        planes.data_ptr(), *(a.data_ptr() for a in args1), pos.size,
        n_px + 1, T_PAD, kbuild.stream_of(planes)), "K1 alone"), 5)
    print(f"K1 scatter_key_planes: {pos.size} COO elements -> planes "
          f"{tuple(planes.shape)} ({planes.numel() * 4 / 1e9:.3f} GB); "
          f"kernel alone {kernel_ms:.3f} ms, zero fill of the planes "
          f"(Tensor.zero_) {fill_ms:.3f} ms, through the wrapper "
          f"{out['scatter_key_planes']['ms']:.3f} ms", flush=True)

    region = label_regions_mask(W, H)
    plans = [pm.build_full_union_key_plan(
        m, 20, mirror=True, xy_shift=2, pix_color_fluctuation=1.0,
        excluded_region=region, light=True) for m in lib.masks[:BATCH]]
    u_pos, mu_pos, q_pos, key_list, u2 = pm.stack_union_pos_args(
        plans, n_px)
    args2 = tuple(convert.as_tensor(a, device)
                  for a in (u_pos, q_pos, key_list)) \
        + convert.interval_tables(pm.interval_table_arrays(0.01), device)
    kw2 = dict(offsets=tuple(shift_offsets(2)), w=W, h=H)
    lo, sp = pm.expand_union_tables_from_pos(*args2, **kw2)
    n_lanes, n_u = lo.shape[1], lo.shape[3]
    # ~20 operations per (mask, lane, element): geometry, the search of
    # q_pos, two gathers
    out["expand_union_tables_from_pos"] = entry(
        max_abs_err((lo, sp),
                    pm.expand_union_tables_from_pos_plain(*args2, **kw2)),
        timed(lambda: pm.expand_union_tables_from_pos(*args2, **kw2), 10),
        timed(lambda: pm.expand_union_tables_from_pos_plain(*args2, **kw2),
              3),
        bound(nbytes(*args2, lo, sp), BATCH * n_lanes * n_u * 20))
    k2_offs = pm._host_offsets(kw2["offsets"])
    k2_alone = timed(lambda: kbuild.check(kbuild.load_library()
                                          .cmst_expand_tables(
        args2[0].data_ptr(), u_pos.shape[1] * n_u, args2[1].data_ptr(),
        q_pos.shape[1], args2[2].data_ptr(), key_list.shape[1],
        args2[3].data_ptr(), args2[4].data_ptr(), args2[3].shape[1],
        k2_offs, BATCH, n_lanes, n_u, W, H, lo.data_ptr(), sp.data_ptr(),
        kbuild.stream_of(lo)), "K2 alone"), 10)
    print(f"K2 expand_union_tables_from_pos: lane tables "
          f"{tuple(lo.shape)}, u2 {u2}, q_pos {tuple(q_pos.shape)}; kernel "
          f"alone {k2_alone:.4f} ms, through the wrapper "
          f"{out['expand_union_tables_from_pos']['ms']:.4f} ms", flush=True)

    args3 = (planes, args2[0], convert.as_tensor(mu_pos, device), lo, sp,
             u2)
    best, mirrored = pm.score_query_batch_union_keys(*args3)
    # the key rows the batch gathers, once each; per (orientation,
    # element, column) one gather and 3 operations per lane and live
    # window (the second window on the prefix u < u2 only)
    rows = np.unique(np.concatenate([u_pos.ravel(), mu_pos.ravel()]))
    n_or = 2 if mu_pos.shape[1] else 1
    k3_ops = BATCH * n_or * T_PAD * (n_u * (2 + 3 * n_lanes)
                                     + max(u2, 0) * 3 * n_lanes)
    out["score_query_batch_union_keys"] = entry(
        max_abs_err((best, mirrored),
                    pm.score_query_batch_union_keys_plain(*args3)),
        timed(lambda: pm.score_query_batch_union_keys(*args3), 5),
        timed(lambda: pm.score_query_batch_union_keys_plain(*args3), 1),
        bound(rows.size * T_PAD * 4 + nbytes(*args3[1:5], best, mirrored),
              k3_ops))
    print(f"K3 score_query_batch_union_keys: {BATCH} masks x {T_PAD} "
          f"columns, union {u_pos.shape[2]}, max score "
          f"{int(best.max())}", flush=True)

    # K4's least work: a key and a select compare a column, k log2(k)
    # compares to order the winners; its bytes are ~100 KB, so a launch
    # floor (an empty kernel's event-timed launch) is printed beside it
    log_k = TOP_K.bit_length() - 1
    k4 = pm.union_keys_topk(best, mirrored, TOP_K)
    # the yardstick: torch.topk, smallest first, of K4's own sort keys
    # ~(score ^ 2^31) << 32 | column (distinct, so the order is lax.top_k's
    # exactly; composed outside the timed call); timed only, used nowhere
    if int(best.min()) < 0:
        raise AssertionError("negative scores: the int64 keys would wrap")
    cols = torch.arange(T_PAD, dtype=torch.int64, device=device)
    keys4 = ((~(best.long() ^ (1 << 31)) & 0xFFFFFFFF) << 32) | cols
    lib_idx = torch.topk(keys4, TOP_K, largest=False).indices
    require_equal("K4 vs torch.topk of its int64 keys (indices)",
                  [k4[1].long()], [lib_idx])
    out["union_keys_topk"] = entry(
        max_abs_err(k4, pm.union_keys_topk_plain(best, mirrored, TOP_K)),
        timed(lambda: pm.union_keys_topk(best, mirrored, TOP_K), 20),
        timed(lambda: pm.union_keys_topk_plain(best, mirrored, TOP_K), 20),
        bound(nbytes(best, mirrored) + BATCH * TOP_K * 9,
              BATCH * (2 * T_PAD + TOP_K * log_k)),
        timed(lambda: torch.topk(keys4, TOP_K, largest=False), 20))
    time_topk(best, mirrored, out["union_keys_topk"], device)
    report(out)
    sync()
    kbuild.reset_launches()
    return out, {"planes": planes, "args3": args3, "best": best,
                 "mirrored": mirrored, "rows": rows.size, "ops": k3_ops,
                 "plans": plans}


def topk_alone(best, mirrored, k: int, pair_flags=None,
               timer=None) -> float:
    """K4's time with no wrapper: the library's entry point on outputs
    allocated once (as K1 and K2 are timed alone), by `timer` (timed's
    median of single launches unless given)."""
    import torch

    from colormipsearch_tpu_torch.kernels import build as kbuild

    lib = kbuild.load_library()
    batch, n_cols = best.shape
    outs = [torch.empty((batch, k), dtype=t, device=best.device)
            for t in (torch.int32, torch.int32, torch.bool)]
    flags = (torch.empty((batch, k), dtype=torch.int32, device=best.device)
             if pair_flags is not None else None)

    def launch():
        kbuild.check(lib.cmst_topk(
            best.data_ptr(), mirrored.data_ptr(),
            pair_flags.data_ptr() if flags is not None else None, batch,
            n_cols, k, *(o.data_ptr() for o in outs),
            flags.data_ptr() if flags is not None else None,
            kbuild.stream_of(best)), "K4 alone")

    return (timer or timed)(launch, 20)


def time_topk(best, mirrored, e4: dict, device) -> None:
    """Phase 2, K4 beyond its kernels-line entry: alone and through its
    wrapper at chip_smoke's k, at the k the engine picks in phase 3 and
    at k = T (its bitonic branch), each checked against its plain
    version, beside an empty kernel's launch (the floor of any launch)."""
    import torch

    from colormipsearch_tpu_torch.engine import cds
    from colormipsearch_tpu_torch.ops import pixel_match as pm

    params = cds.CDSParams(mask_threshold=20, data_threshold=20,
                           pix_color_fluctuation=1.0, xy_shift=2,
                           mirror_mask=True, pct_positive_pixels=1.0)
    engine_k = min(cds.CDSearchEngine(params, device=device)
                   ._emit_select_k(0), T_PAD)
    def loop(fn, _repeats):
        return timed_loop(fn, 200)

    empty = lambda: torch.cuda._sleep(0)  # noqa: E731
    floor = (timed(empty, 50), loop(empty, 0))
    cols = torch.arange(T_PAD, dtype=torch.int64, device=device)
    keys = ((~(best.long() ^ (1 << 31)) & 0xFFFFFFFF) << 32) | cols
    parts = []
    for name, k in (("chip_smoke's", TOP_K), ("phase 3's engine", engine_k),
                    ("k = T", T_PAD)):
        require_equal(f"K4 at k {k} vs its plain version",
                      pm.union_keys_topk(best, mirrored, k),
                      pm.union_keys_topk_plain(best, mirrored, k))
        wrapper = lambda: pm.union_keys_topk(best, mirrored, k)  # noqa: E731
        library = lambda: torch.topk(keys, k, largest=False)  # noqa: E731
        parts.append(
            f"{name} k {k}: alone {topk_alone(best, mirrored, k):.4f} / "
            f"{topk_alone(best, mirrored, k, timer=loop):.4f} ms, through "
            f"the wrapper {timed(wrapper, 20):.4f} / {loop(wrapper, 0):.4f} "
            f"ms, torch.topk {timed(library, 20):.4f} / "
            f"{loop(library, 0):.4f} ms")
    print(f"K4 union_keys_topk, {BATCH} masks x {T_PAD} columns (median of "
          f"single launches / mean of 200 back to back): "
          f"{'; '.join(parts)}; an empty kernel's launch {floor[0]:.4f} / "
          f"{floor[1]:.4f} ms; bound {e4['bound_ms']:.5f} ms "
          f"({e4['bound_by']})", flush=True)


def check_qkey_kernels(device, k1: dict) -> dict:
    """Phase 2, rows 13 and 14: K3's batch (`k1`, from check_kernels) in
    its qkey wire form; row 13's lane tables must equal K2's, row 14's
    scores K3's. Returns {kernel: entry(...)}."""
    import numpy as np

    from colormipsearch_tpu_torch import convert
    from colormipsearch_tpu_torch.kernels import build as kbuild
    from colormipsearch_tpu_torch.ops import pixel_match as pm

    out = {}
    u_pos, mu_pos, qidx, key_list, u2 = pm.stack_union_qkey_args(
        k1["plans"], H * W)
    planes, u_t, mu_t, lo2, sp2, u2_pos = k1["args3"]
    if u2 != u2_pos or not np.array_equal(u_pos, u_t.cpu().numpy()):
        raise AssertionError("the qkey and positional stacks differ")
    qargs = (convert.qidx(qidx, device), convert.as_tensor(key_list, device),
             *convert.interval_tables(pm.interval_table_arrays(0.01),
                                      device))
    lo, sp = pm.expand_union_tables(*qargs)
    n_lanes, n_u = lo.shape[1], lo.shape[3]
    # ~10 operations per (mask, lane, element): two clamped index
    # gathers and four table reads
    out["expand_union_tables"] = entry(
        max_abs_err((lo, sp), pm.expand_union_tables_plain(*qargs)),
        timed(lambda: pm.expand_union_tables(*qargs), 10),
        timed(lambda: pm.expand_union_tables_plain(*qargs), 3),
        bound(nbytes(*qargs, lo, sp), BATCH * n_lanes * n_u * 10))
    require_equal("row 13 lane tables vs K2's (positional form)", (lo, sp),
                  (lo2, sp2))
    args14 = (planes, u_t, mu_t, *qargs, u2)
    got = pm.score_query_batch_union_qkeys(*args14)
    # K3's work: the same rows gathered, the same range tests
    out["score_query_batch_union_qkeys"] = entry(
        max_abs_err(got, pm.score_query_batch_union_qkeys_plain(*args14)),
        timed(lambda: pm.score_query_batch_union_qkeys(*args14), 5),
        timed(lambda: pm.score_query_batch_union_qkeys_plain(*args14), 1),
        bound(k1["rows"] * T_PAD * 4 + nbytes(*args14[1:7], *got),
              k1["ops"]))
    require_equal("row 14 vs K3 (best, mirrored)", got,
                  (k1["best"], k1["mirrored"]))
    print(f"rows 13-14 qkey form: qidx {tuple(qidx.shape)}, key lists "
          f"{tuple(key_list.shape)}, u2 {u2}", flush=True)
    report(out)
    sync()
    kbuild.reset_launches()
    return out


def torch_from(arr, device):
    import torch

    return torch.from_numpy(arr).to(device)


class HostFields:
    """In-memory store fields [R, n_px] with the ShapePackStore read
    surface the host tile gather uses (field_maps, gather)."""

    def __init__(self, zsl, grad, tfg):
        self.zsl, self.grad, self.tfg = zsl, grad, tfg

    def field_maps(self):
        return self.zsl, self.grad, self.tfg

    def gather(self, field, rows, cols):
        import numpy as np

        return getattr(self, field)[np.ix_(np.asarray(rows), cols)]


def build_fields(lib, variants, n: int) -> HostFields:
    """The store rows of the first n targets (build_row_fields, threaded),
    stacked into [n, n_px] fields."""
    import numpy as np

    from colormipsearch_tpu_torch.io.shape_pack import build_row_fields

    n_px = H * W
    zsl = np.empty((n, n_px), np.uint16)
    grad = np.empty((n, n_px), np.uint16)
    tfg = np.empty((n, -(-n_px // 8)), np.uint8)

    def one(i):
        g, z = variants[i]
        zsl[i], grad[i], tfg[i] = build_row_fields(
            lib.targets[i], g, z, mask_threshold=20)

    with concurrent.futures.ThreadPoolExecutor(os.cpu_count() or 4) as pool:
        list(pool.map(one, range(n)))
    return HostFields(zsl, grad, tfg)


def check_shape_kernels(lib, variants, device) -> dict:
    """Phase 2, shape pass: K7, K6 and K5 against their plain versions at
    production shapes, and the device-built planes against the host
    tile gather. Returns {kernel: entry(...)}."""
    import numpy as np
    import torch

    from colormipsearch_tpu_torch import convert
    from colormipsearch_tpu_torch.engine.cds import CDSParams
    from colormipsearch_tpu_torch.kernels import build as kbuild
    from colormipsearch_tpu_torch.ops import shape_score as ss

    out = {}
    t0 = time.time()
    region = CDSParams(mask_threshold=20, with_name_label_region=True,
                       with_color_scale_region=True) \
        .shape_excluded_region(H, W)
    q_pack = ss.pack_query(lib.masks[0], excluded_region=region)
    pos_gap, pos_he = ss.support_split(q_pack)
    n_gap_pad = ss.support_bucket(pos_gap.size, minimum=1024)
    n_he_w = ss.he_words(pos_he.size)
    q = [ss.sparse_query_split(q_pack, pos_gap, n_gap_pad, pos_he, n_he_w)
         for _ in range(2)]
    q_gap = convert.as_tensor(np.stack([g for g, _ in q]), device)
    q_he = convert.as_tensor(np.stack([h for _, h in q]), device)
    print(f"query pack of the first cut mask (slice table included) in "
          f"{time.time() - t0:.1f}s: Sg {pos_gap.size}, Sg_pad "
          f"{n_gap_pad}, ring rows {pos_he.size}, ring words {n_he_w}, "
          f"planes {2 * (n_gap_pad + n_he_w) * 4 * T_PAD / 1e6:.1f} MB",
          flush=True)

    t0 = time.time()
    host = build_fields(lib, variants, T_PAD)
    print(f"store rows of {T_PAD} targets built on the host in "
          f"{time.time() - t0:.1f}s", flush=True)

    # K7: one production chunk (<= 256 MB of int16) of the zsl field
    n_r, n_px = host.zsl.shape
    rows_per = min(n_px, (256 << 20) // (n_r * 2))
    p0 = min(rows_per, n_px - rows_per)
    chunk = torch_from(np.array(host.zsl[:, p0:p0 + rows_per]
                                .view(np.int16)), device)
    buf = torch.zeros((n_px, n_r), dtype=torch.int16, device=device)
    ref = torch.zeros_like(buf)
    ss.upload_pixel_major_chunk(buf, chunk, p0)
    ss.upload_pixel_major_chunk_plain(ref, chunk, p0)
    dst = buf[p0:p0 + rows_per]
    out["upload_pixel_major"] = entry(
        max_abs_err([buf], [ref]),
        timed(lambda: ss.upload_pixel_major_chunk(buf, chunk, p0), 10),
        timed(lambda: ss.upload_pixel_major_chunk_plain(ref, chunk, p0), 3),
        bound(2 * nbytes(chunk), 0),
        timed(lambda: dst.copy_(chunk.t()), 10))
    flat = torch.empty_like(chunk)
    copy16 = timed(lambda: flat.copy_(chunk), 10)
    del buf, ref, chunk, dst, flat
    sync()
    # K7's uint8 mode: the whole tfg field, one chunk of [R, ceil(P / 8)]
    n_r8, n_px8 = host.tfg.shape
    chunk = torch_from(np.array(host.tfg), device)
    buf = torch.zeros((n_px8, n_r8), dtype=torch.uint8, device=device)
    ref = torch.zeros_like(buf)
    ss.upload_pixel_major_chunk(buf, chunk, 0)
    ss.upload_pixel_major_chunk_plain(ref, chunk, 0)
    e8 = entry(max_abs_err([buf], [ref]),
               timed(lambda: ss.upload_pixel_major_chunk(buf, chunk, 0), 10),
               timed(lambda: ss.upload_pixel_major_chunk_plain(ref, chunk, 0),
                     3),
               bound(2 * nbytes(chunk), 0),
               timed(lambda: buf.copy_(chunk.t()), 10))
    if e8["max_abs_err"]:
        raise AssertionError("K7's uint8 mode disagrees with its plain "
                             "version")
    # a plain copy of the same bytes (what a transpose can at best reach)
    flat8 = torch.empty_like(chunk)
    copy8 = timed(lambda: flat8.copy_(chunk), 10)
    del flat8
    e16 = out["upload_pixel_major"]
    print(f"K7 upload_pixel_major: int16 chunk [{n_r}, {rows_per}] "
          f"({nbytes(host.zsl[:, :rows_per]) / 1e6:.1f} MB) {e16['ms']:.4f} "
          f"ms, bound {e16['bound_ms']:.4f} ms "
          f"({100 * e16['bound_ms'] / e16['ms']:.0f}%), library "
          f"{e16['library_ms']:.4f} ms, a plain copy of its bytes "
          f"{copy16:.4f} ms; uint8 chunk [{n_r8}, {n_px8}] "
          f"({nbytes(chunk) / 1e6:.1f} MB): max_abs_err 0, kernel "
          f"{e8['ms']:.4f} ms, plain {e8['plain_ms']:.3f} ms, library "
          f"(dst.copy_(src.t())) {e8['library_ms']:.4f} ms, a plain copy of "
          f"its bytes {copy8:.4f} ms, bound {e8['bound_ms']:.4f} ms "
          f"({100 * e8['bound_ms'] / e8['ms']:.0f}%)", flush=True)
    del buf, ref, chunk
    sync()
    t0 = time.time()
    fields = tuple(ss.upload_pixel_major(f, device)
                   for f in host.field_maps())
    sync()
    seconds = time.time() - t0
    n_bytes = sum(f.numel() * f.element_size() for f in fields)
    print(f"K7 upload_pixel_major: [{n_r}, {rows_per}] int16 chunks; the "
          f"device store of {n_r} targets ({n_bytes / 2**30:.2f} GiB) "
          f"uploaded in {seconds:.2f}s ({n_bytes / seconds / 1e9:.2f} "
          "GB/s)", flush=True)

    g_pos, h_pos, keep_he = ss.split_gather_plan(
        pos_gap, pos_he, W, mirror=True, excluded=region)
    kw = dict(n_gap_pad=n_gap_pad, n_he_words=n_he_w)
    tp = ss.tile_positions(pos_gap, g_pos, h_pos, keep_he, mirror=True,
                           device=device, **kw)
    # store rows on the host, as the engine hands them over
    rows_h = torch.arange(T_PAD, dtype=torch.int32)
    rows = rows_h.to(device)
    t_gap, t_he = ss.shape_tile_device(fields, rows_h, tp, **kw)
    # the field rows the plan touches, once each (zsl at each gap pixel,
    # grad at each orientation's, tfg one byte row per 8 ring pixels),
    # and ~10 operations per output word
    field_rows = (np.unique(pos_gap), np.unique(g_pos), np.unique(h_pos // 8))
    k6_ops = 10 * (t_gap.numel() + t_he.numel())
    out["shape_tile_device"] = entry(
        max_abs_err((t_gap, t_he),
                    ss.shape_tile_device_plain(fields, rows, tp, **kw)),
        timed(lambda: ss.shape_tile_device(fields, rows_h, tp, **kw), 10),
        timed(lambda: ss.shape_tile_device_plain(fields, rows, tp, **kw),
              3),
        bound(k6_gather_bytes(field_rows, rows)[0] + nbytes(t_gap, t_he),
              k6_ops))
    check_k6_rows(fields, tp, kw, field_rows)
    t0 = time.time()
    want = ss.select_target_tile_from_store(
        host, np.arange(T_PAD), pos_gap, n_gap_pad, n_he_w,
        (g_pos, h_pos, keep_he), mirror=True)
    host_s = time.time() - t0
    del host
    err = max_abs_err((t_gap, t_he), tuple(
        convert.as_tensor(a, device) for a in want))
    print(f"K6 shape_tile_device: planes {tuple(t_gap.shape)} + "
          f"{tuple(t_he.shape)}; max_abs_err {err} against the host tile "
          f"gather ({host_s:.2f}s on the host)", flush=True)
    if err:
        raise AssertionError("device-built planes differ from the host's")

    args = (t_gap, q_gap, t_he, q_he)
    hi, lo, he = ss.shape_score_pairs_split(*args)
    # ~12 operations per plane word: the gap test and sum, the ring
    # popcount
    out["shape_score_pairs_split"] = entry(
        max_abs_err((hi, lo, he), ss.shape_score_pairs_split_plain(*args)),
        timed(lambda: ss.shape_score_pairs_split(*args), 20),
        timed(lambda: ss.shape_score_pairs_split_plain(*args), 3),
        bound(nbytes(*args, hi, lo, he),
              12 * (t_gap.numel() + t_he.numel())))
    print(f"K5 shape_score_pairs_split: 2 orientations x {T_PAD} targets,"
          f" max gap {int((hi.long() * 1024 + lo.long()).max())}, max "
          f"high-expression {int(he.max())}", flush=True)
    report(out)
    del fields
    sync()
    free_cached()
    kbuild.reset_launches()
    # K5's planes (~0.3 GB) stay for phase 7's split shape step
    return out, {"q_pack": q_pack, "region": region, "k5_args": args,
                 "k5": tuple(x.cpu().numpy() for x in (hi, lo, he))}


def k6_gather_bytes(field_rows, rows) -> tuple[int, int]:
    """K6's field gathers for store rows `rows` (int32 [T]), in 32-byte
    sectors: (the distinct sectors, each read once: what DRAM must move;
    the sectors each warp of 32 columns touches, summed: what L2 serves).
    zsl and grad hold 2 bytes a store row, tfg 1, in rows of R columns;
    `field_rows` are the (zsl, grad, tfg) rows the plan gathers. For an
    `arange` the distinct sectors are the rows' bytes."""
    import numpy as np

    r = rows.cpu().numpy().astype(np.int64)
    pad = -r.size % 32
    warps = np.concatenate([r, np.repeat(r[-1:], pad)]).reshape(-1, 32)
    distinct = requested = 0
    for n, elsize in zip((f.size for f in field_rows), (2, 2, 1)):
        sector = r * elsize // 32
        distinct += n * np.unique(sector).size * 32
        per_warp = sum(np.unique(w * elsize // 32).size for w in warps)
        requested += n * per_warp * 32
    return distinct, requested


def check_k6_rows(fields, tp, kw: dict, field_rows) -> None:
    """Phase 2, K6 with the engine's store rows: the engine gathers a
    mask's candidates, sorted by store row (engine/gradscore.py), so a
    sorted random subset of 1,638 of the 2,048 rows (phase 4's candidates
    per mask), timed beside the `arange` of as many columns; and a
    permutation of all 2,048 rows (what an unsorted caller gives). Each
    equal to the plain version, with the rows on the host and on the
    card; the wrapper's time (rows on the host, as the engine gives them:
    their range checked there, then copied over) beside the kernel's own
    (launched directly); the bound from the distinct sectors the gathers
    touch."""
    import numpy as np
    import torch

    from colormipsearch_tpu_torch.kernels import build as kbuild
    from colormipsearch_tpu_torch.ops import shape_score as ss

    lib = kbuild.load_library()
    device = fields[0].device
    n_r = fields[0].shape[1]
    rng = np.random.default_rng(11)
    n_eng = 1638

    def launch(rows, planes):
        kbuild.check(lib.cmst_shape_tile(
            *(f.data_ptr() for f in fields), n_r, rows.data_ptr(),
            rows.shape[0], tp.pos_gap.data_ptr(), tp.g_pos.data_ptr(),
            tp.h_pos.data_ptr(), tp.keep_he.data_ptr(), tp.n_or,
            kw["n_gap_pad"], kw["n_he_words"], tp.sg, tp.sh,
            planes[0].data_ptr(), planes[1].data_ptr(),
            kbuild.stream_of(fields[0])), "shape_tile_device")

    cases = (
        ("arange 2048", torch.arange(n_r, dtype=torch.int32)),
        ("engine 1638", torch.from_numpy(np.sort(rng.choice(
            n_r, n_eng, replace=False)).astype(np.int32))),
        ("arange 1638", torch.arange(n_eng, dtype=torch.int32)),
        ("permutation 2048", torch.from_numpy(
            rng.permutation(n_r).astype(np.int32))))
    times = {}
    for name, rows_h in cases:
        rows = rows_h.to(device)
        got = ss.shape_tile_device(fields, rows_h, tp, **kw)
        require_equal(f"K6 with rows_sel {name} vs its plain version", got,
                      ss.shape_tile_device_plain(fields, rows, tp, **kw))
        require_equal(f"K6 with rows_sel {name} on the card vs on the host",
                      ss.shape_tile_device(fields, rows, tp, **kw), got)
        wrapped = timed(lambda: ss.shape_tile_device(fields, rows_h, tp,
                                                     **kw), 10)
        alone = timed(lambda: launch(rows, got), 10)
        distinct, requested = k6_gather_bytes(field_rows, rows)
        bound_ = bound(distinct + nbytes(*got), 10 * sum(
            x.numel() for x in got))
        times[name] = wrapped
        print(f"K6 rows_sel {name}: {wrapped:.3f} ms (kernel alone "
              f"{alone:.3f}), bound {bound_['bound_ms']:.3f} ms "
              f"({bound_['bound_by']}: {distinct / 1e6:.1f} MB of distinct "
              f"gather sectors, {requested / 1e6:.1f} MB of sectors the "
              f"warps request)", flush=True)
        del got
    ratio = times["engine 1638"] / times["arange 1638"]
    print(f"K6 engine rows / arange at {n_eng} columns: {ratio:.2f}x",
          flush=True)


def check_dense_shape_kernels(lib, variants, device, ref: dict):
    """Phase 2, row 18b: the dense packs (pack_target_rows, both
    orientations) of the first cut mask's support over 2,048 targets, in
    both modes against the plain versions; after the mirror selection
    they must equal K5's gap, high-expression and mirrored (`ref`, from
    check_shape_kernels). Returns ({kernel: entry(...)}, the host packs
    for phase 7)."""
    import numpy as np

    from colormipsearch_tpu_torch import convert
    from colormipsearch_tpu_torch.kernels import build as kbuild
    from colormipsearch_tpu_torch.ops import shape_score as ss

    q_pack = ref["q_pack"]
    pos = ss.support_positions(q_pack)
    n_pad = ss.support_bucket(pos.size)
    t0 = time.time()

    def pack(start):
        idx = range(start, min(start + 128, T_PAD))
        return ss.pack_target_rows(
            [lib.targets[i] for i in idx], [variants[i][0] for i in idx],
            [variants[i][1] for i in idx], pos, n_pad, mask_threshold=20,
            excluded=ref["region"], mirror=True)

    with concurrent.futures.ThreadPoolExecutor(os.cpu_count() or 4) as pool:
        rows = np.concatenate(list(pool.map(pack, range(0, T_PAD, 128))),
                              axis=2)
    q2 = np.stack([ss.sparse_query(q_pack, pos, n_pad)] * 2)
    print(f"row 18b dense packs: support {pos.size} rows (padded "
          f"{n_pad}), planes {tuple(rows.shape)} "
          f"({rows.nbytes / 2**30:.2f} GiB) packed on the host in "
          f"{time.time() - t0:.1f}s", flush=True)
    t_rows = convert.shape_planes(rows, device)
    q_t = convert.as_tensor(q2, device)
    got = ss.shape_score_pairs_both(t_rows, q_t)
    err = max_abs_err(got, ss.shape_score_pairs_both_plain(t_rows, q_t))
    one = (t_rows[0], q_t[0])
    single = ss.shape_score_pairs(*one)
    err = max(err, max_abs_err(single, ss.shape_score_pairs_plain(*one)))
    require_equal("row 18b one orientation vs the straight half of both",
                  single, [x[0] for x in got])
    # the plane rows a query word selects (the kernel skips the others),
    # read once each; ~15 operations a word read
    n_live = int((q_t != 0).sum())
    out = {"shape_score_pairs": entry(
        err, timed(lambda: ss.shape_score_pairs_both(t_rows, q_t), 10),
        timed(lambda: ss.shape_score_pairs_both_plain(t_rows, q_t), 1),
        bound(n_live * T_PAD * 4 + nbytes(q_t, *got),
              15 * n_live * T_PAD))}
    print(f"row 18b one orientation: kernel "
          f"{timed(lambda: ss.shape_score_pairs(*one), 10):.3f} ms",
          flush=True)
    dense = ss._select_orientation(*(x.cpu().numpy() for x in got))
    split = ss._select_orientation(*ref["k5"])
    for name, a, b in zip(("gap", "high-expression", "mirrored"), dense,
                          split):
        if not np.array_equal(a, b):
            raise AssertionError(f"row 18b's {name} differs from K5's")
    print(f"row 18b after the mirror selection equals K5's gap, "
          f"high-expression and mirrored on {T_PAD} targets "
          f"({int(dense[2].sum())} mirrored)", flush=True)
    report(out)
    del t_rows, q_t, got, single
    sync()
    free_cached()
    kbuild.reset_launches()
    return out, {"rows": rows, "q2": q2}


def slice_numbers_alone(rgb, out, timer=None) -> float:
    """Row 15's time with no wrapper: the library's entry point into an
    output allocated once, with the LUT tensors made once."""
    from colormipsearch_tpu_torch.kernels import build as kbuild
    from colormipsearch_tpu_torch.ops import shape_score as ss

    lib = kbuild.load_library()
    rows, starts, lens = ss._lut_tensors(rgb.device)

    def launch():
        kbuild.check(lib.cmst_slice_numbers(
            rgb.data_ptr(), out.numel(), rows.data_ptr(), starts.data_ptr(),
            lens.data_ptr(), rows.shape[1], out.data_ptr(),
            kbuild.stream_of(rgb)), "row 15 alone")

    return (timer or timed)(launch, 5)


def check_slice_numbers(lib, device, seed: int) -> dict:
    """Phase 2, row 15: slice numbers of the 2,048-target stack against the
    plain version, and against the float64 slice table everywhere but at
    exact ties of two LUT distances (counted); the kernel alone; then a
    dense stack, [64, P, 3] uniform random RGB from the seed with no black
    pixel, against the plain version, timed through the wrapper and alone
    beside its bytes bound. Returns {kernel: entry(...)}."""
    import numpy as np
    import torch

    from colormipsearch_tpu_torch import testing
    from colormipsearch_tpu_torch.kernels import build as kbuild
    from colormipsearch_tpu_torch.ops import shape_score as ss
    from colormipsearch_tpu_torch.ops.slice_lut import get_slice_lut

    rgb = torch_from(np.stack(lib.targets[:T_PAD]), device)
    got = ss.slice_numbers_device(rgb)
    err = max_abs_err([got], [ss.slice_numbers_device_plain(rgb)])
    table = torch.from_numpy(get_slice_lut().view(np.int16)).to(device)
    flat, got_f = rgb.reshape(-1, 3), got.reshape(-1)
    bad_rgb, bad_got, bad_ref = [], [], []
    for c0 in range(0, got_f.numel(), 1 << 26):
        c = flat[c0:c0 + (1 << 26)].long()
        ref = table[(c[:, 0] << 16) | (c[:, 1] << 8) | c[:, 2]].int() \
            & 0xFFFF
        bad = ref != got_f[c0:c0 + (1 << 26)]
        bad_rgb.append(c[bad].cpu().numpy())
        bad_got.append(got_f[c0:c0 + (1 << 26)][bad].cpu().numpy())
        bad_ref.append(ref[bad].cpu().numpy())
    ties = _exact_ties(np.concatenate(bad_rgb), np.concatenate(bad_got),
                       np.concatenate(bad_ref))
    non_black = int((flat.amax(1) > 0).sum())
    # 7 bytes a pixel; ~10 operations a pixel and ~4 per LUT entry scanned
    # (56 at most) for each non-black one
    out = {"slice_numbers_device": entry(
        err, timed(lambda: ss.slice_numbers_device(rgb), 5),
        timed(lambda: ss.slice_numbers_device_plain(rgb), 1),
        bound(nbytes(rgb, got), 10 * got.numel() + 224 * non_black))}
    alone = slice_numbers_alone(rgb, got)
    print(f"row 15 slice_numbers_device: {got.numel()} pixels "
          f"({non_black} not black); {ties} differ from the float64 slice "
          "table, every one an exact tie of two LUT distances; kernel "
          f"alone {alone:.3f} ms, through the wrapper "
          f"{out['slice_numbers_device']['ms']:.3f} ms", flush=True)
    report(out)
    del rgb, got, table, flat, got_f
    sync()
    free_cached()

    rng = np.random.default_rng([seed, 15])
    dense = rng.integers(0, 256, (64, H * W, 3), dtype=np.uint8)
    dense[dense.max(2) == 0, 0] = 1
    classes = np.unique(testing.slice_class(dense[0]))
    rgb = torch_from(dense, device)
    del dense
    got = ss.slice_numbers_device(rgb)
    require_equal(f"row 15 on a dense stack {tuple(rgb.shape)} (classes "
                  f"{classes.tolist()}) vs its plain version", [got],
                  [ss.slice_numbers_device_plain(rgb)])
    ms = timed(lambda: ss.slice_numbers_device(rgb), 10)
    alone = slice_numbers_alone(rgb, got, lambda f, _: timed(f, 10))
    bytes_ms = nbytes(rgb, got) / HBM_BYTES_PER_S * 1e3
    print(f"row 15 on the dense stack: {got.numel()} pixels, none black; "
          f"kernel {ms:.4f} ms through the wrapper, {alone:.4f} ms alone; "
          f"bytes bound {bytes_ms:.4f} ms (no share: the operation count "
          "of the kernels line counts the 56-step scan, which the binary "
          "search no longer runs)", flush=True)
    del rgb, got
    sync()
    free_cached()
    kbuild.reset_launches()
    return out


def _exact_ties(rgb, got, ref) -> int:
    """The pixels where the integer scan and the float64 table differ:
    raise unless each is an exact tie (equal |255*s - S_i*p| at both
    slices of the pixel's class row); returns their count."""
    import numpy as np

    from colormipsearch_tpu_torch.ops import shape_score as ss

    rows, starts = ss._lut_tables()
    for (r, g, b), a, w in zip(rgb.astype(np.int64), got, ref):
        r_dom = r >= g and r >= b
        g_dom = not r_dom and g >= r and g >= b
        if r_dom:
            cls, p, sec = (5 if g >= b else 6), r, max(g, b)
        elif g_dom:
            cls, p, sec = (4 if r >= b else 3), g, max(r, b)
        else:
            cls, p, sec = (1 if r >= g else 2), b, max(r, g)
        ia, iw = a - starts[cls - 1] - 1, w - starts[cls - 1] - 1
        ok = 0 <= iw < rows.shape[1] and abs(255 * sec - rows[cls - 1, ia]
                                            * p) == abs(
            255 * sec - rows[cls - 1, iw] * p)
        if not ok:
            raise AssertionError(f"slice number of {(r, g, b)}: {a}, the "
                                 f"float64 table's {w}, and not a tie")
    return len(got)


def pack_split_alone(rgb, split8) -> float:
    """K8's split mode with no wrapper: the library's entry point into the
    planes `split8` (threshold 20, t_pad their width)."""
    from colormipsearch_tpu_torch.kernels import build as kbuild

    lib = kbuild.load_library()
    n_t, n_px, t_pad = rgb.shape[0], split8[0].shape[0], split8[0].shape[1]

    def launch():
        kbuild.check(lib.cmst_pack_planes(
            rgb.data_ptr(), n_t, n_px, t_pad, 20, 2, None,
            split8[0].data_ptr(), split8[1].data_ptr(),
            kbuild.stream_of(rgb)), "K8 split alone")

    return timed(launch, 5)


def check_classic_kernels(lib, device, k1: dict) -> dict:
    """Phase 2, the classic pixel-match paths and the split encodings: K8
    in its three modes on the 2,048-target stack; K12 in its three modes,
    on those summary planes and on K1's key planes (`k1`, from
    check_kernels); K13 on the split K1 planes with K3's batch; K9 and
    K11 on a batch of 8 masks at --pixColorFluctuation 1.0 (the exact
    same-class branch) and 0.37 (the banded one); K10 on the 1.0 batch's
    key plans; each against its plain version, and each re-encoding
    against what it re-encodes. Returns {kernel: entry(...)}; K9's and
    K11's entries are the 1.0 batch's, their max_abs_err the larger of
    the two."""
    import numpy as np

    from colormipsearch_tpu_torch import convert
    from colormipsearch_tpu_torch.kernels import build as kbuild
    from colormipsearch_tpu_torch.oracle.pixel import label_regions_mask
    from colormipsearch_tpu_torch.ops import common, pixel_match as pm

    out = {}
    n_px = H * W
    rgb = torch_from(np.stack(lib.targets[:T_PAD]), device)
    lut = common.rank_lut_tensor(device)
    # ~20 operations per (pixel, target): the classification and the word
    k8_ops = 20 * T_PAD * n_px
    planes = common.pack_target_planes(rgb, 20, t_pad=T_PAD)
    out["pack_target_planes"] = entry(
        max_abs_err([planes], [common.pack_target_planes_plain(
            rgb, 20, t_pad=T_PAD)]),
        timed(lambda: common.pack_target_planes(rgb, 20, t_pad=T_PAD), 5),
        timed(lambda: common.pack_target_planes_plain(rgb, 20,
                                                      t_pad=T_PAD), 1),
        bound(nbytes(rgb, planes), k8_ops))
    keys = common.pack_target_planes_keys(rgb, 20, lut, t_pad=T_PAD)
    out["pack_target_planes_keys"] = entry(
        max_abs_err([keys], [common.pack_target_planes_keys_plain(
            rgb, 20, lut, t_pad=T_PAD)]),
        timed(lambda: common.pack_target_planes_keys(rgb, 20, lut,
                                                     t_pad=T_PAD), 5),
        timed(lambda: common.pack_target_planes_keys_plain(
            rgb, 20, lut, t_pad=T_PAD), 1),
        bound(nbytes(rgb, lut, keys), k8_ops))
    split8 = common.pack_target_planes_split(rgb, 20, t_pad=T_PAD)
    out["pack_target_planes_split"] = entry(
        max_abs_err(split8, common.pack_target_planes_split_plain(
            rgb, 20, t_pad=T_PAD)),
        timed(lambda: common.pack_target_planes_split(rgb, 20,
                                                      t_pad=T_PAD), 5),
        timed(lambda: common.pack_target_planes_split_plain(
            rgb, 20, t_pad=T_PAD), 1),
        bound(nbytes(rgb, *split8), k8_ops))
    print(f"K8 pack_planes: stack {tuple(rgb.shape)} -> summary planes "
          f"{tuple(planes.shape)}, key planes {tuple(keys.shape)}, split "
          f"planes {tuple(split8[0].shape)}; split mode alone "
          f"{pack_split_alone(rgb, split8):.3f} ms, through the wrapper "
          f"{out['pack_target_planes_split']['ms']:.3f} ms", flush=True)
    require_equal("K8 key planes vs K1's", [keys], [k1["planes"]])
    del rgb
    sync()
    free_cached()

    # K12: ~4 integer operations an element (10 with the LUT read)
    sp, c8 = common.split_planes_from_packed(planes)
    out["split_planes_from_packed"] = entry(
        max_abs_err((sp, c8), common.split_planes_from_packed_plain(planes)),
        timed(lambda: common.split_planes_from_packed(planes), 5),
        timed(lambda: common.split_planes_from_packed_plain(planes), 1),
        bound(nbytes(planes, sp, c8), 4 * planes.numel()))
    require_equal("K12 split pair vs K8's split mode", (sp, c8), split8)
    del split8
    keys12 = common.key_planes_from_packed(planes, lut)
    out["key_planes_from_packed"] = entry(
        max_abs_err([keys12], [common.key_planes_from_packed_plain(
            planes, lut)]),
        timed(lambda: common.key_planes_from_packed(planes, lut), 5),
        timed(lambda: common.key_planes_from_packed_plain(planes, lut), 1),
        bound(nbytes(planes, lut, keys12), 10 * planes.numel()))
    require_equal("K12 key planes vs K8's", [keys12], [keys])
    require_equal("K12 key planes vs K1's", [keys12], [k1["planes"]])
    del keys12
    k1_planes = k1["planes"]
    rank, cls = pm.split_key_planes(k1_planes)
    out["split_key_planes"] = entry(
        max_abs_err((rank, cls), common.split_key_planes_plain(k1_planes)),
        timed(lambda: pm.split_key_planes(k1_planes), 5),
        timed(lambda: common.split_key_planes_plain(k1_planes), 1),
        bound(nbytes(k1_planes, rank, cls), 4 * k1_planes.numel()))
    args13 = (rank, cls, *k1["args3"][1:])
    got = pm.score_query_batch_union_keys_splitk(*args13)
    # K3's work with a 2-byte and a 1-byte gather for its 4-byte one
    out["score_query_batch_union_keys_splitk"] = entry(
        max_abs_err(got, pm.score_query_batch_union_keys_splitk_plain(
            *args13)),
        timed(lambda: pm.score_query_batch_union_keys_splitk(*args13), 5),
        timed(lambda: pm.score_query_batch_union_keys_splitk_plain(*args13),
              1),
        bound(k1["rows"] * T_PAD * 3 + nbytes(*args13[2:6], *got),
              k1["ops"]))
    require_equal("K13 vs K3", got, (k1["best"], k1["mirrored"]))
    print(f"K12 repack_planes: split pair {tuple(sp.shape)}, key planes "
          f"{(planes.shape[0] + 1, planes.shape[1])}, split key "
          f"planes {tuple(rank.shape)}; K13 max score {int(got[0].max())}",
          flush=True)
    del rank, cls, got, args13, k1_planes
    k1.clear()
    sync()
    free_cached()

    region = label_regions_mask(W, H)
    for flu in (1.0, 0.37):
        kw = dict(mirror=True, xy_shift=2, pix_color_fluctuation=flu,
                  excluded_region=region)
        plans = [pm.build_query_plan(m, 20, **kw) for m in lib.masks[:BATCH]]
        q_pad = max(p.positions.shape[1] for p in plans)
        plans = [pm.build_query_plan(m, 20, pad_to=q_pad, **kw)
                 for m in lib.masks[:BATCH]]
        args = tuple(convert.as_tensor(np.stack([getattr(p, f)
                                                 for p in plans]), device)
                     for f in ("positions", "q_cls", "q_s", "q_p"))
        kw11 = dict(ztol_num=plans[0].ztol_num, ztol_den=plans[0].ztol_den,
                    n_straight=plans[0].n_straight)
        kw9 = dict(target_threshold=-1, **kw11)
        got = pm.score_query_batch(planes, *args, **kw9)
        err = max_abs_err(got, pm.score_query_batch_plain(planes, *args,
                                                          **kw9))
        ms = timed(lambda: pm.score_query_batch(planes, *args, **kw9), 5)
        plain_ms = timed(lambda: pm.score_query_batch_plain(
            planes, *args, **kw9), 1)
        got11 = pm.score_query_batch_split(sp, c8, *args, **kw11)
        err11 = max_abs_err(got11, pm.score_query_batch_split_plain(
            sp, c8, *args, **kw11))
        ms11 = timed(lambda: pm.score_query_batch_split(sp, c8, *args,
                                                        **kw11), 5)
        plain11_ms = timed(lambda: pm.score_query_batch_split_plain(
            sp, c8, *args, **kw11), 1)
        pos = np.stack([p.positions for p in plans])
        valid = pos[pos >= 0]
        flagged = (got[2] > 0).sum(1).tolist()
        print(f"K9 score_query_batch at {flu}%: {BATCH} masks x "
              f"{pos.shape[1]} variants x {q_pad} padded query pixels "
              f"({valid.size} valid elements a column) x {T_PAD} columns; "
              f"max_abs_err {err} (flags included), kernel {ms:.3f} ms, "
              f"plain {plain_ms:.3f} ms; query sizes "
              f"{[p.query_size for p in plans]}; flagged pairs per mask "
              f"{flagged}; max score {int(got[0].max())}", flush=True)
        print(f"K11 score_query_batch_split at {flu}%: max_abs_err {err11} "
              f"(flags included), kernel {ms11:.3f} ms, plain "
              f"{plain11_ms:.3f} ms", flush=True)
        require_equal(f"K11 vs K9 at {flu}% (best, mirrored, flags)", got11,
                      got)
        if flu == 1.0:
            # K4's flag gather, the per-shard tail of the packed mesh
            # step, on this batch's flags
            require_equal(
                "K4 with the flag gather (K9's batch at 1.0%) vs its plain "
                "version", pm.union_keys_topk(*got[:2], TOP_K, got[2]),
                pm.union_keys_topk_plain(*got[:2], TOP_K, got[2]))
            print(f"K4 with the flag gather on K9's batch "
                  f"{tuple(got[0].shape)}, k {TOP_K}: through the wrapper "
                  f"""{timed(lambda: pm.union_keys_topk(
                      *got[:2], TOP_K, got[2]), 20):.4f} ms, alone """
                  f"{topk_alone(got[0], got[1], TOP_K, got[2]):.4f} / "
                  f"""{topk_alone(got[0], got[1], TOP_K, got[2],
                                  timer=lambda f, _: timed_loop(f, 200))
                     :.4f} ms (median of single launches / mean of 200 back """
                  "to back)", flush=True)
        # the rows the batch gathers, once each; per valid (mask,
        # variant, query pixel, column) element ~20 integer operations
        # (unpack, class tests, selects, counts) and ~13 f32 ones (two
        # conversions, the exact same-class test's products and compares,
        # the adjacent-class product, FMA and compares)
        n_rows = np.unique(valid).size
        if flu == 1.0:
            n_el = valid.size * T_PAD
            out["score_query_batch"] = entry(
                err, ms, plain_ms,
                bound(n_rows * T_PAD * 4 + nbytes(*args, *got), 20 * n_el,
                      13 * n_el))
            out["score_query_batch_split"] = entry(
                err11, ms11, plain11_ms,
                bound(n_rows * T_PAD * 3 + nbytes(*args, *got11), 20 * n_el,
                      13 * n_el))
            kplans = [pm.key_plan_from_query_plan(p, n_px, flu)
                      for p in plans]
        else:
            for name, e in (("score_query_batch", err),
                            ("score_query_batch_split", err11)):
                out[name]["max_abs_err"] = max(e, out[name]["max_abs_err"])
    del planes, sp, c8
    kargs = tuple(convert.as_tensor(np.stack([getattr(p, f)
                                              for p in kplans]), device)
                  for f in ("positions", "lo", "span"))
    n_straight = kplans[0].n_straight
    got = pm.score_query_batch_keys(keys, *kargs, n_straight=n_straight)
    kpos = np.stack([p.positions for p in kplans])
    # one gather, three range tests and their OR per element
    out["score_query_batch_keys"] = entry(
        max_abs_err(got, pm.score_query_batch_keys_plain(
            keys, *kargs, n_straight=n_straight)),
        timed(lambda: pm.score_query_batch_keys(
            keys, *kargs, n_straight=n_straight), 5),
        timed(lambda: pm.score_query_batch_keys_plain(
            keys, *kargs, n_straight=n_straight), 1),
        bound(np.unique(kpos).size * T_PAD * 4 + nbytes(*kargs, *got),
              9 * kpos.size * T_PAD))
    print(f"K10 score_query_batch_keys: {tuple(kpos.shape)} positions x "
          f"{T_PAD} columns, max score {int(got[0].max())}", flush=True)
    report(out)
    del keys, got
    sync()
    free_cached()
    kbuild.reset_launches()
    return out


def check_edge_shapes(lib, device) -> None:
    """Phase 2, the redesigned kernels at their edge shapes, each against
    its plain version exactly: K1 at every testing.SCATTER_EDGE_CASES
    input (production image size: many 256-row tiles a block, P + 1 not
    a multiple of them), K2 at every testing.EXPAND_EDGE_CASES input;
    K3, K13 and row 14 on every
    testing.UNION_EDGE_CASES batch (random masks at the production image
    size against 300 targets, not a multiple of a block's 256 columns), at
    the case's chunk and at the kernel's own; K9 and K11 at 301 and 300
    target columns (not and a multiple of the four columns a thread; the
    two masks are the last two) with a query padded 37 past the batch's
    largest (not a multiple of the 256-pixel chunk), at
    --pixColorFluctuation 1.0 and 0.37."""
    import numpy as np

    from colormipsearch_tpu_torch import convert, testing
    from colormipsearch_tpu_torch.kernels import build as kbuild
    from colormipsearch_tpu_torch.oracle.pixel import label_regions_mask
    from colormipsearch_tpu_torch.ops import common, pixel_match as pm

    for case in testing.SCATTER_EDGE_CASES:
        rng = np.random.default_rng(sum(map(ord, case[0])))
        args, kw = testing.scatter_edge_inputs(rng, case, H, W, device)
        require_equal(f"edge shape {case[0]}: K1 vs its plain version "
                      f"({args[0].shape[0]} elements, t_pad {kw['t_pad']})",
                      [common.scatter_key_planes(*args, **kw)],
                      [common.scatter_key_planes_plain(*args, **kw)])
    for case in testing.EXPAND_EDGE_CASES:
        rng = np.random.default_rng(sum(map(ord, case[0])))
        args, kw = testing.expand_edge_inputs(rng, case, device)
        require_equal(f"edge shape {case[0]}: K2 vs its plain version "
                      f"(q_pos {tuple(args[1].shape)}, "
                      f"{len(kw['offsets'])} lanes, {kw['h']}x{kw['w']})",
                      pm.expand_union_tables_from_pos(*args, **kw),
                      pm.expand_union_tables_from_pos_plain(*args, **kw))
    del args
    sync()
    free_cached()

    rng = np.random.default_rng(7)
    n_px = H * W
    pos, rgb, cum = common.coo_foreground(np.stack(lib.targets[:300]), 20,
                                          300)
    planes = common.scatter_key_planes_plain(
        torch_from(pos, device), torch_from(rgb, device),
        torch_from(cum, device), common.rank_lut_tensor(device),
        n_px=n_px, t_pad=300)
    del pos, rgb, cum
    rank, cls = common.split_key_planes_plain(planes)
    for case in testing.UNION_EDGE_CASES:
        batch = testing.union_edge_batch(rng, case, H, W, device)
        args, qargs = batch["union"], batch["qkeys"]
        want = pm.score_query_batch_union_keys_plain(planes, *args)
        want13 = pm.score_query_batch_union_keys_splitk_plain(rank, cls,
                                                              *args)
        want14 = pm.score_query_batch_union_qkeys_plain(planes, *qargs)
        for chunk in sorted({batch["chunk"], 0}):
            for name, got, ref in (
                    ("K3", pm.score_query_batch_union_keys(
                        planes, *args, chunk=chunk), want),
                    ("K13", pm.score_query_batch_union_keys_splitk(
                        rank, cls, *args, chunk=chunk), want13),
                    ("row 14", pm.score_query_batch_union_qkeys(
                        planes, *qargs, chunk=chunk), want14)):
                if max_abs_err(got, ref):
                    raise AssertionError(f"{name} at edge shape {case[0]} "
                                         f"(chunk {chunk}) differs from "
                                         "its plain version")
        print(f"edge shape {case[0]}: K3, K13 and row 14 equal their plain "
              f"versions (union {tuple(args[0].shape)}, lanes "
              f"{args[2].shape[1]}, u2 {args[4]}, chunk "
              f"{batch['chunk'] or 'auto'} and auto; max score "
              f"{int(want[0].max())})", flush=True)
    del planes, rank, cls
    sync()
    free_cached()

    region = label_regions_mask(W, H)
    for n_cols in (301, 300):
        # the two masks themselves are the last two columns: strong
        # matches and flagged pairs
        planes = common.pack_target_planes_plain(
            torch_from(np.stack(lib.targets[:n_cols - 2] + lib.masks[:2]),
                       device), 20, t_pad=n_cols)
        sp, c8 = common.split_planes_from_packed_plain(planes)
        for flu in (1.0, 0.37):
            kw = dict(mirror=True, xy_shift=2, pix_color_fluctuation=flu,
                      excluded_region=region)
            plans = [pm.build_query_plan(m, 20, **kw) for m in lib.masks[:2]]
            q_pad = max(p.positions.shape[1] for p in plans) + 37
            plans = [pm.build_query_plan(m, 20, pad_to=q_pad, **kw)
                     for m in lib.masks[:2]]
            args = tuple(convert.as_tensor(np.stack([getattr(p, f)
                                                     for p in plans]),
                                           device)
                         for f in ("positions", "q_cls", "q_s", "q_p"))
            kw11 = dict(ztol_num=plans[0].ztol_num,
                        ztol_den=plans[0].ztol_den,
                        n_straight=plans[0].n_straight)
            want = pm.score_query_batch_plain(planes, *args,
                                              target_threshold=-1, **kw11)
            want11 = pm.score_query_batch_split_plain(sp, c8, *args, **kw11)
            got = pm.score_query_batch(planes, *args, target_threshold=-1,
                                       **kw11)
            got11 = pm.score_query_batch_split(sp, c8, *args, **kw11)
            if max_abs_err(got, want) or max_abs_err(got11, want11):
                raise AssertionError(
                    f"K9/K11 at {n_cols} columns and query {q_pad}, {flu}%: "
                    "differs from the plain version")
            print(f"edge shape {n_cols} columns, query {q_pad}, {flu}%: K9 "
                  f"and K11 equal their plain versions, flags included (max "
                  f"score {int(want[0].max())}, flagged pairs "
                  f"{int((want[2] > 0).sum())})", flush=True)
        del planes, sp, c8
        sync()
        free_cached()
    check_shape_edge_shapes(device)
    check_topk_pixel_major_edge_shapes(device)
    check_slice_pack_split_edge_shapes(device)
    kbuild.reset_launches()


def check_topk_pixel_major_edge_shapes(device) -> None:
    """Phase 2, K4 at every testing.TOPK_EDGE_CASES input (both ordering
    branches, flag gather on and off, batch 0) and K7 at every
    testing.PIXEL_MAJOR_EDGE_CASES shape, also with the chunk one element
    past an aligned base (narrower loads): each equal to its plain
    version."""
    from colormipsearch_tpu_torch import testing

    for case in testing.TOPK_EDGE_CASES:
        testing.check_topk_edge(case, device)
    print(f"K4 equals its plain version at {len(testing.TOPK_EDGE_CASES)} "
          f"edge cases ({', '.join(c[0] for c in testing.TOPK_EDGE_CASES)})",
          flush=True)
    for case in testing.PIXEL_MAJOR_EDGE_CASES:
        testing.check_pixel_major_edge(case, device)
    print(f"K7 equals its plain version at "
          f"{len(testing.PIXEL_MAJOR_EDGE_CASES)} edge shapes (R 1, 31, 33, "
          "1,638, 2,048; n 1, 7, 9, a chunk; at pixel 0 and at the end; "
          "int16 and uint8; aligned and shifted sources)", flush=True)
    sync()


def check_slice_pack_split_edge_shapes(device) -> None:
    """Phase 2, row 15 at every testing.SLICE_NUMBERS_EDGE_CASES input and
    K8's split mode at every testing.PACK_SPLIT_EDGE_CASES input, then
    both over testing.slice_class_triples (every class, p and s, every
    channel tie): each equal to its plain version."""
    import torch

    from colormipsearch_tpu_torch import testing
    from colormipsearch_tpu_torch.ops import common, shape_score as ss

    for case in testing.SLICE_NUMBERS_EDGE_CASES:
        testing.check_slice_numbers_edge(case, device)
    print(f"row 15 equals its plain version at "
          f"{len(testing.SLICE_NUMBERS_EDGE_CASES)} edge cases "
          f"({', '.join(c[0] for c in testing.SLICE_NUMBERS_EDGE_CASES)})",
          flush=True)
    for case in testing.PACK_SPLIT_EDGE_CASES:
        testing.check_pack_split_edge(case, device)
    print(f"K8's split mode equals its plain version at "
          f"{len(testing.PACK_SPLIT_EDGE_CASES)} edge cases "
          f"({', '.join(c[0] for c in testing.PACK_SPLIT_EDGE_CASES)})",
          flush=True)
    px = torch.from_numpy(testing.slice_class_triples()).to(device)
    require_equal(f"row 15 over every (class, p, s) and tie ({px.shape[0]} "
                  "pixels) vs its plain version",
                  [ss.slice_numbers_device(px)],
                  [ss.slice_numbers_device_plain(px)])
    stack = px[:px.shape[0] // 8 * 8].reshape(8, -1, 1, 3)
    for thr in (0, 20, 254):
        require_equal(f"K8's split mode over the same pixels, threshold "
                      f"{thr}, vs its plain version",
                      common.pack_target_planes_split(stack, thr, t_pad=16),
                      common.pack_target_planes_split_plain(stack, thr,
                                                            t_pad=16))
    sync()


def check_shape_edge_shapes(device) -> None:
    """Phase 2, K6 at every testing.TILE_EDGE_CASES shape and K5 at every
    testing.SPLIT_EDGE_CASES shape, K5 also through its scalar loader
    (planes one word past 16-byte alignment): each equal to its plain
    version."""
    import numpy as np
    import torch

    from colormipsearch_tpu_torch import convert, testing
    from colormipsearch_tpu_torch.ops import shape_score as ss

    for case in testing.TILE_EDGE_CASES:
        rng = np.random.default_rng(sum(map(ord, case[0])))
        fields, rows, tp, kw = testing.tile_edge_inputs(
            testing.tile_edge_case(rng, case), device)
        require_equal(f"edge shape {case[0]}: K6 vs its plain version",
                      ss.shape_tile_device(fields, rows, tp, **kw),
                      ss.shape_tile_device_plain(fields, rows, tp, **kw))
    for case in testing.SPLIT_EDGE_CASES:
        rng = np.random.default_rng(sum(map(ord, case[0])))
        args = [convert.as_tensor(a, device)
                for a in testing.split_edge_case(rng, case)]
        want = ss.shape_score_pairs_split_plain(*args)
        require_equal(f"edge shape {case[0]}: K5 vs its plain version",
                      ss.shape_score_pairs_split(*args), want)
        shifted = list(args)
        for k in (0, 2):
            buf = torch.zeros(args[k].numel() + 1, dtype=torch.int32,
                              device=device)
            shifted[k] = buf[1:].view(args[k].shape)
            shifted[k].copy_(args[k])
        require_equal(f"edge shape {case[0]}: K5's scalar loader vs its "
                      "plain version", ss.shape_score_pairs_split(*shifted),
                      want)


def check_pil_free_readers(device, work: str) -> dict:
    """Phase 8, the image readers that need no PIL (io/jpeg.py, io/gif.py,
    io/tiff.py, io/fax.py; the GPU hosts have no PIL): each file of
    tests/torch_forms (one of every family: baseline, progressive, CMYK,
    arithmetic-coded, lossless, corrupt and block-smoothed JPEGs, a GIF,
    palette, CCITT, tiled JPEG, RGBA, CMYK, float, CIELab, palette +
    alpha, signed 32-bit, 4-bit gray, LZMA, Zstandard and CCITT RLE
    TIFFs) decodes to the
    pixels pinned beside it; colorDepthSearch on the card over a small
    library with those files among its targets skips none and finds the
    pinned matches; then each reader's seconds for one 566 x 1210 image
    written by testing's encoders (the Zstandard one by PIL, committed in
    tests/torch_forms). Returns {reader: seconds}."""
    import logging

    import numpy as np

    from colormipsearch_tpu_torch import testing
    from colormipsearch_tpu_torch.engine import cds
    from colormipsearch_tpu_torch.io import gif, image, jpeg, tiff

    pinned = np.load(os.path.join(testing.FORMS_DIR, testing.FORMS_NPZ))
    pixels = {}
    for name in testing.FORM_FILES:
        with open(os.path.join(testing.FORMS_DIR, name), "rb") as f:
            got = image._decode_numpy(f.read())
        if not np.array_equal(got.pixels, pinned[name]):
            raise AssertionError(f"phase 8: {name} decodes to other pixels "
                                 "than PIL's")
        pixels[name] = got.as_rgb()
    print(f"phase 8: {', '.join(testing.FORM_FILES)} decode without PIL to "
          "PIL's pixels", flush=True)

    skipped = []

    class Skips(logging.Handler):
        def emit(self, record):
            if "skipped" in record.getMessage():
                skipped.append(record.getMessage())

    handler = Skips()
    cds.LOG.addHandler(handler)
    try:
        matches = testing.forms_search(pixels, work, device)
    finally:
        cds.LOG.removeHandler(handler)
    if skipped:
        raise AssertionError(f"phase 8: the engine skipped targets: "
                             f"{skipped}")
    if not np.array_equal(matches, pinned["matches"]):
        raise AssertionError(f"phase 8: matches {matches.tolist()} differ "
                             f"from the pinned {pinned['matches'].tolist()}")
    print(f"phase 8: colorDepthSearch on the card over the form files: "
          f"{len(matches)} matches, the pinned ones, no target skipped",
          flush=True)

    rng = np.random.default_rng(8)
    cdm = testing.synthetic_cdm(rng, H, W)
    cube = np.stack(np.meshgrid(*[np.arange(0, 256, 51)] * 3,
                                indexing="ij"), -1).reshape(-1, 3)
    idx = (cdm.astype(np.int64) + 25) // 51
    idx = (idx[..., 0] * 36 + idx[..., 1] * 6 + idx[..., 2]).astype(np.uint8)
    cmap = cube.T.astype(np.uint16) * 257
    cmap = np.pad(cmap, ((0, 0), (0, 256 - cmap.shape[1])))
    files = {
        "jpeg (baseline, 4:2:0, quality 95)": (
            jpeg.decode_jpeg, testing.encode_jpeg(
                cdm, quality=95, sampling=((2, 2), (1, 1), (1, 1)))),
        "gif (216-colour table)": (
            gif.decode_gif, testing.encode_gif(idx, cube)),
        "tiff palette, Deflate": (
            tiff.decode_tiff, testing.encode_tiff(
                idx[..., None], photometric=3, compression=8,
                colormap=cmap, rows_per_strip=64)),
        "tiff RGB, Deflate + predictor": (
            tiff.decode_tiff, testing.encode_tiff(
                cdm, photometric=2, compression=8, predictor=2,
                rows_per_strip=64)),
    }
    bits = (cdm.max(-1) > 40).astype(np.uint8)
    tiles = [testing.encode_jpeg(
        np.pad(cdm[y:y + 256, x:x + 256],
               ((0, max(0, y + 256 - H)), (0, max(0, x + 256 - W)), (0, 0)),
               mode="edge"), quality=95, jfif=False,
        sampling=((2, 2), (1, 1), (1, 1)))
        for y in range(0, H, 256) for x in range(0, W, 256)]
    # the same CDM, written by PIL with libzstd (the GPU hosts have no
    # zstd encoder)
    with open(os.path.join(testing.FORMS_DIR, testing.FORMS_ZSTD_TIMING),
              "rb") as f:
        zstd_file = f.read()
    arith = testing.encode_jpeg(cdm, quality=95, arithmetic=True,
                                progressive=True,
                                sampling=((2, 2), (1, 1), (1, 1)))
    scans = [k for k in range(len(arith) - 1)
             if arith[k] == 0xFF and arith[k + 1] == 0xDA]
    files.update({
        "tiff CCITT Group 4": (tiff.decode_tiff, testing.encode_tiff_chunks(
            [testing.encode_fax(bits, group=4)], w=W, h=H, bits=[1],
            photometric=0, compression=4)),
        "tiff tiled JPEG (YCbCr 4:2:0, 256x256 tiles)": (
            tiff.decode_tiff, testing.encode_tiff_chunks(
                tiles, w=W, h=H, bits=[8, 8, 8], photometric=6,
                compression=7, chunk=(256, 256), tiled=True,
                extra_tags={530: [2, 2]})),
        "jpeg arithmetic, progressive 4:2:0, quality 95": (
            jpeg.decode_jpeg, arith),
        "jpeg progressive cut after 3 scans (block smoothing)": (
            jpeg.decode_jpeg, arith[:scans[3]] + b"\xff\xd9"),
        "jpeg lossless (predictor 4)": (
            jpeg.decode_jpeg, testing.encode_jpeg_lossless(cdm,
                                                          predictor=4)),
        "tiff RGB, LZMA": (tiff.decode_tiff, testing.encode_tiff(
            cdm, photometric=2, compression=34925, rows_per_strip=64)),
        "tiff RGB, Zstandard (libzstd's, tests/torch_forms)": (
            tiff.decode_tiff, zstd_file),
        "tiff CIELab, uncompressed": (tiff.decode_tiff, testing.encode_tiff(
            cdm, photometric=8, rows_per_strip=64)),
    })
    want = {"gif (216-colour table)": cube[idx],
            "tiff palette, Deflate": cube[idx],
            "tiff RGB, Deflate + predictor": cdm,
            "tiff RGB, LZMA": cdm,
            "tiff RGB, Zstandard (libzstd's, tests/torch_forms)": cdm,
            "tiff CCITT Group 4": np.repeat(255 * (1 - bits)[..., None], 3,
                                            -1),
            "jpeg lossless (predictor 4)": cdm}
    seconds = {}
    for name, (decode, data) in files.items():
        t0 = time.time()
        px = decode(data)
        seconds[name] = time.time() - t0
        if px.shape != (H, W, 3) or (name in want
                                     and not np.array_equal(px, want[name])):
            raise AssertionError(f"phase 8: {name} decodes wrongly")
        err = np.abs(px.astype(int) - cdm).mean()
        print(f"phase 8: {name}, {len(data)} bytes, {H}x{W}: decoded in "
              f"{seconds[name]:.3f} s (mean |pixel - source| {err:.2f})",
              flush=True)
    return seconds


def make_variants(lib, seed: int) -> list:
    """(GradientImage, ZGapImage) of every target, from per-target child
    seeds, threaded."""
    import numpy as np

    from colormipsearch_tpu_torch import testing

    seeds = np.random.SeedSequence(seed).spawn(len(lib.targets))

    def one(i):
        rng = np.random.default_rng(seeds[i])
        t = lib.targets[i]
        return testing.synthetic_gradient(rng, t), testing.synthetic_zgap(t)

    with concurrent.futures.ThreadPoolExecutor(os.cpu_count() or 4) as pool:
        return list(pool.map(one, range(len(lib.targets))))


def write_library(lib, variants, work: str):
    """The library as PNGs: targets with their gradient and z-gap
    variants, masks; neuron JSONs beside them."""
    from colormipsearch_tpu_torch import testing
    from colormipsearch_tpu_torch.dataio.json_io import write_neurons_json

    t0 = time.time()
    targets = testing.write_neuron_images(
        os.path.join(work, "targets"), lib.targets, "t",
        gradients=[g for g, _ in variants], zgaps=[z for _, z in variants])
    masks = testing.write_neuron_images(
        os.path.join(work, "masks"), lib.masks, "m")
    write_neurons_json(targets, os.path.join(work, "targets.json"))
    write_neurons_json(masks, os.path.join(work, "masks.json"))
    print(f"wrote the library (targets with variants) as PNGs in "
          f"{time.time() - t0:.1f}s", flush=True)
    return masks, targets


def run_search(work: str, n_masks: int, n_targets: int) -> dict:
    """Phase 3: colorDepthSearch end to end through the CLI entry point.
    Returns the launch counts of the run."""
    from colormipsearch_tpu_torch.cli import main as cli_main
    from colormipsearch_tpu_torch.cli.commands import stage_seconds
    from colormipsearch_tpu_torch.kernels import build as kbuild
    from colormipsearch_tpu_torch.utils.metrics import GLOBAL

    GLOBAL.reset()
    reset_peak()
    kbuild.reset_launches()
    t0 = time.time()
    rc = cli_main.main([
        "colorDepthSearch", "-m", os.path.join(work, "masks.json"),
        "-i", os.path.join(work, "targets.json"), "--device", DEVICE,
        "-od", os.path.join(work, "out"), "--perMaskSubdir", "masks",
        "--perTargetSubdir", "targets", *FLAGS])
    seconds = time.time() - t0
    launches = dict(kbuild.launches)
    if rc != 0:
        raise AssertionError(f"colorDepthSearch exited {rc}")
    missing = [k for k in CDS_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"the main path never launched {missing}")
    pairs = n_masks * n_targets
    print(f"colorDepthSearch: {n_masks} masks x {n_targets} targets "
          f"in {seconds:.2f}s = {pairs / seconds:.0f} pairs/s end to end, "
          f"{pairs / GLOBAL.get('cds.scoreAllPairs.seconds'):.0f} pairs/s "
          "over scoreAllPairs", flush=True)
    print(f"cds stage seconds: {json.dumps(stage_seconds())}", flush=True)
    print(f"peak torch.cuda.max_memory_allocated: {peak_gib():.2f} GiB",
          flush=True)
    print(f"launches in the run: {launches}", flush=True)
    return launches


def check_against_oracle(lib, work: str, n_masks: int, rng) -> None:
    """Every emitted match of 4 masks equals the float64 oracle's
    matchingPixels / mirrored; 32 sampled non-emitted pairs fail the emit
    test under the oracle."""
    from colormipsearch_tpu_torch.oracle.pixel import (
        PixelMatchOracle,
        label_regions_mask,
    )

    region = label_regions_mask(W, H)
    pct = 1.0

    def oracle(mi):
        return PixelMatchOracle(
            lib.masks[mi], 20, mirror=True, target_threshold=20,
            z_tolerance=0.01, xy_shift=2, excluded_region=region)

    emitted: dict[int, dict[int, dict]] = {}
    for mi in range(n_masks):
        path = os.path.join(work, "out", "masks", f"m-{mi:05d}.json")
        rows = json.load(open(path))["results"] \
            if os.path.exists(path) else []
        emitted[mi] = {int(r["image"]["mipId"].split("-")[1]): r
                       for r in rows}
    # the first masks are cut from targets, so they have matches
    checked = [mi for mi in range(n_masks) if emitted[mi]][:4]
    if len(checked) < min(4, n_masks):
        raise AssertionError(f"only masks {checked} emitted any match")
    n_rows = 0
    for mi in checked:
        o = oracle(mi)
        for ti, row in emitted[mi].items():
            res = o.score(lib.targets[ti])
            if (res.matching_pixels, res.mirrored) != \
                    (row["matchingPixels"], row["mirrored"]):
                raise AssertionError(
                    f"mask {mi} target {ti}: emitted "
                    f"{row['matchingPixels']}/{row['mirrored']}, oracle "
                    f"{res.matching_pixels}/{res.mirrored}")
            n_rows += 1
    n_sampled = 0
    while n_sampled < 32:
        mi = int(rng.integers(0, n_masks))
        ti = int(rng.integers(0, len(lib.targets)))
        if ti in emitted[mi]:
            continue
        res = oracle(mi).score(lib.targets[ti])
        if res.matching_pixels > 0 and \
                res.matching_pixels_ratio > pct / 100:
            raise AssertionError(
                f"mask {mi} target {ti} was not emitted but the oracle "
                f"scores {res.matching_pixels} "
                f"({res.matching_pixels_ratio:.4f})")
        n_sampled += 1
    print(f"oracle: {n_rows} emitted matches of masks {checked} agree; "
          f"{n_sampled} sampled non-emitted pairs fail the emit test",
          flush=True)


def _read_results(root: str) -> dict:
    """{mask mipId: [result rows]} of a per-mask result directory."""
    out = {}
    for name in sorted(os.listdir(root)):
        with open(os.path.join(root, name)) as f:
            doc = json.load(f)
        out[doc["inputImage"]["mipId"]] = doc["results"]
    return out


def _gradient_scores(work: str, out: str, *flags) -> tuple[dict, float]:
    """One gradientScores run through the CLI entry point with fresh
    launch counts; returns (launches, seconds)."""
    from colormipsearch_tpu_torch.cli import main as cli_main
    from colormipsearch_tpu_torch.cli.commands import stage_seconds
    from colormipsearch_tpu_torch.kernels import build as kbuild
    from colormipsearch_tpu_torch.utils.metrics import GLOBAL

    shutil.copytree(os.path.join(work, "cds"), out)
    GLOBAL.reset()
    reset_peak()
    kbuild.reset_launches()
    t0 = time.time()
    rc = cli_main.main([
        "gradientScores", "--matches", os.path.join(out, "masks"),
        "--maskThreshold", "20", "--mirrorMask", "--device", DEVICE,
        "-od", out, "--perMaskSubdir", "masks", *flags])
    seconds = time.time() - t0
    launches = dict(kbuild.launches)
    if rc != 0:
        raise AssertionError(f"gradientScores exited {rc}")
    # the match files this run rescored carry shape scores
    pairs = sum("gradientAreaGap" in r for rows in
                _read_results(os.path.join(out, "masks")).values()
                for r in rows)
    print(f"gradientScores {' '.join(flags) or '(default path)'}: {pairs} "
          f"pairs in {seconds:.2f}s = {pairs / seconds:.0f} pairs/s end "
          f"to end; gs stage seconds {json.dumps(stage_seconds('gs'))}; "
          f"store upload {GLOBAL.get('gs.storeUploadBytes') / 2**30:.2f} "
          f"GiB; peak torch.cuda.max_memory_allocated {peak_gib():.2f} "
          f"GiB; launches {launches}", flush=True)
    return launches, seconds


def run_gradient_scores(work: str, n_masks: int) -> dict:
    """Phase 4: colorDepthSearch of the first n_masks masks with
    --pctPositivePixels 0, then gradientScores through the
    device-resident store and through the default path. Returns the
    store run's launch counts."""
    from colormipsearch_tpu_torch.cli import main as cli_main

    t0 = time.time()
    rc = cli_main.main([
        "colorDepthSearch", "-m", f"{os.path.join(work, 'masks.json')}:0:"
        f"{n_masks}", "-i", os.path.join(work, "targets.json"),
        "--device", DEVICE, "-od", os.path.join(work, "cds"),
        "--perMaskSubdir", "masks", *FLAGS[:-2],
        "--pctPositivePixels", "0"])
    if rc != 0:
        raise AssertionError(f"colorDepthSearch exited {rc}")
    pairs = sum(len(r) for r in
                _read_results(os.path.join(work, "cds", "masks")).values())
    print(f"colorDepthSearch of {n_masks} masks with --pctPositivePixels "
          f"0 in {time.time() - t0:.1f}s: {pairs} candidate pairs",
          flush=True)

    os.environ["CDS_SHAPE_STORE_DEVICE"] = "1"
    try:
        launches, _ = _gradient_scores(
            work, os.path.join(work, "gs_store"),
            "--packed-variants-store", os.path.join(work, "store"))
    finally:
        del os.environ["CDS_SHAPE_STORE_DEVICE"]
    missing = [k for k in GS_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"the device-store path never launched "
                             f"{missing}")
    default, _ = _gradient_scores(work, os.path.join(work, "gs_default"),
                                  "--matches-length", "2")
    if default["shape_score_pairs_split"] == 0:
        raise AssertionError("the default path never launched "
                             "shape_score_pairs_split")
    return launches


def check_shape_oracle(lib, variants, work: str, rng) -> None:
    """Phase 5: 8 sampled pairs of each of 4 masks, from both phase-4
    runs, against the float64 ShapeMatchOracle."""
    from colormipsearch_tpu_torch.engine.cds import CDSParams
    from colormipsearch_tpu_torch.oracle.shape import (
        ShapeMatchOracle,
        negative_score,
        normalized_score,
    )

    region = CDSParams(mask_threshold=20, with_name_label_region=True,
                       with_color_scale_region=True) \
        .shape_excluded_region(H, W)
    runs = {name: _read_results(os.path.join(work, name, "masks"))
            for name in ("gs_store", "gs_default")}
    # the default run rescored the first 2 match files only
    runs["gs_default"] = dict(sorted(runs["gs_default"].items())[:2])
    masks = [m for m, rows in runs["gs_store"].items() if rows][:4]
    if len(masks) < 4:
        raise AssertionError(f"only masks {masks} have shape scores")
    jobs = []
    for mip in masks:
        rows = runs["gs_store"][mip]
        for k in rng.choice(len(rows), min(8, len(rows)), replace=False):
            jobs.append((mip, rows[int(k)]["image"]["mipId"]))
    oracles = {mip: ShapeMatchOracle(lib.masks[int(mip.split("-")[1])], 20,
                                     mirror=True, excluded_region=region)
               for mip in masks}

    def score(job):
        mip, tid = job
        ti = int(tid.split("-")[1])
        g, z = variants[ti]
        return oracles[mip].score(lib.targets[ti], g, z)

    with concurrent.futures.ThreadPoolExecutor(os.cpu_count() or 4) as pool:
        results = dict(zip(jobs, pool.map(score, jobs)))
    n_checked = {name: 0 for name in runs}
    for (mip, tid), res in results.items():
        for name, run in runs.items():
            rows = run.get(mip)
            if not rows:
                continue
            row = next(r for r in rows if r["image"]["mipId"] == tid)
            got = (row["gradientAreaGap"], row["highExpressionArea"])
            want = (res.gradient_area_gap, res.high_expression_area)
            if got != want:
                raise AssertionError(f"{name} {mip} x {tid}: shape scores "
                                     f"{got}, oracle {want}")
            max_px = max(r["matchingPixels"] for r in rows)
            max_neg = max(negative_score(r["gradientAreaGap"],
                                         r["highExpressionArea"])
                          for r in rows)
            norm = normalized_score(row["matchingPixels"], *want, max_px,
                                    max_neg)
            if abs(row["normalizedScore"] - norm) > 1e-6 * abs(norm):
                raise AssertionError(f"{name} {mip} x {tid}: normalized "
                                     f"{row['normalizedScore']}, oracle "
                                     f"{norm}")
            n_checked[name] += 1
    if not n_checked["gs_default"]:
        raise AssertionError("no sampled pair of the default run")
    print(f"shape oracle: sampled pairs of masks {masks} agree "
          f"({n_checked})", flush=True)


def _tree(root: str) -> dict:
    """{relative path: bytes} of every file under root."""
    out = {}
    for d, _, files in os.walk(root):
        for name in files:
            path = os.path.join(d, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def run_classic_paths(work: str, n_masks: int) -> dict:
    """Phase 6: colorDepthSearch through the CLI entry point on the first
    n_masks masks, once per CLASSIC_RUNS entry, each with fresh launch
    counts; every result tree must equal the default run's byte for
    byte, and the split run must rescore the packed run's number of
    flagged pairs. Returns {run name: launches}."""
    from colormipsearch_tpu_torch.cli import main as cli_main
    from colormipsearch_tpu_torch.cli.commands import stage_seconds
    from colormipsearch_tpu_torch.kernels import build as kbuild
    from colormipsearch_tpu_torch.utils.metrics import GLOBAL

    runs = {}
    trees = {}
    rescored = {}
    for name, flags, env, kernels in CLASSIC_RUNS:
        out = os.path.join(work, f"classic_{name}")
        os.environ.update(env)
        try:
            GLOBAL.reset()
            reset_peak()
            kbuild.reset_launches()
            t0 = time.time()
            rc = cli_main.main([
                "colorDepthSearch", "-m",
                f"{os.path.join(work, 'masks.json')}:0:{n_masks}",
                "-i", os.path.join(work, "targets.json"), "--device", DEVICE,
                "-od", out, "--perMaskSubdir", "masks", "--perTargetSubdir",
                "targets", *FLAGS, *flags])
            seconds = time.time() - t0
            launches = dict(kbuild.launches)
        finally:
            for k in env:
                del os.environ[k]
        if rc != 0:
            raise AssertionError(f"colorDepthSearch ({name}) exited {rc}")
        missing = [k for k in kernels if launches[k] == 0]
        if missing:
            raise AssertionError(f"the {name} run never launched {missing}")
        trees[name] = _tree(out)
        rescored[name] = GLOBAL.get("cds.rescore.count")
        emit = GLOBAL.get("cds.emit.seconds")
        rescore = GLOBAL.get("cds.rescore.seconds")
        print(f"phase 6 {name} "
              f"{' '.join([*flags, *(f'{k}={v}' for k, v in env.items())])}: "
              f"{GLOBAL.get('pairsScored'):.0f} pairs of {n_masks} masks "
              f"in {seconds:.2f}s; stage seconds "
              f"{json.dumps(stage_seconds())}; emit {emit:.2f}s, of which "
              f"the float64 rescore of {GLOBAL.get('cds.rescore.count'):.0f} "
              f"flagged pairs {rescore:.2f}s; peak "
              f"torch.cuda.max_memory_allocated {peak_gib():.2f} GiB; "
              f"launches { {k: v for k, v in launches.items() if v} }",
              flush=True)
        runs[name] = launches
    ref = trees["default"]
    if not any(k.startswith("masks") for k in ref):
        raise AssertionError("the default run wrote no per-mask results")
    for name, tree in trees.items():
        if tree != ref:
            diff = sorted(k for k in set(tree) | set(ref)
                          if tree.get(k) != ref.get(k))
            raise AssertionError(f"the {name} result tree differs from the "
                                 f"default run's: {diff[:5]}")
    print(f"phase 6: the {len(trees) - 1} other result trees equal the "
          f"default run's byte for byte ({len(ref)} files)", flush=True)
    if rescored["split"] != rescored["packed"]:
        raise AssertionError(f"the split run rescored {rescored['split']} "
                             f"flagged pairs, the packed run "
                             f"{rescored['packed']}")
    print(f"phase 6: the split and packed runs rescored "
          f"{rescored['split']:.0f} flagged pairs each", flush=True)
    return runs


def check_negative_query(lib, work: str, n_masks: int, rng) -> None:
    """Phase 6, negative query: color_depth_search on the first n_masks
    masks against every target with mask 1's image as the negative query
    (mirrored), once on the default engine (positive pass K2 + K3,
    negative pass K10) and once with CDS_SPLIT_PLANES=1 and
    CDS_UNION_KEYS=0 (the packed path: positive pass K12 + K11, negative
    pass K9, flagged pairs rescored); both must find the same matches,
    and 16 sampled matches of each must equal the float64 oracle's."""
    from colormipsearch_tpu_torch import CDSParams, color_depth_search
    from colormipsearch_tpu_torch.dataio.json_io import read_neurons_json
    from colormipsearch_tpu_torch.kernels import build as kbuild
    from colormipsearch_tpu_torch.oracle.pixel import (
        PixelMatchOracle,
        label_regions_mask,
    )
    from colormipsearch_tpu_torch.utils.metrics import GLOBAL

    masks = read_neurons_json(os.path.join(work, "masks.json"))[:n_masks]
    targets = read_neurons_json(os.path.join(work, "targets.json"))
    params = CDSParams(mask_threshold=20, data_threshold=20,
                       pix_color_fluctuation=1.0, xy_shift=2,
                       mirror_mask=True, pct_positive_pixels=1.0,
                       with_name_label_region=True,
                       with_color_scale_region=True)
    neg_png = os.path.join(work, "masks", "m00001.png")
    runs = (("default", {}, ("expand_union_tables_from_pos",
                             "score_query_batch_union_keys",
                             "score_query_batch_keys")),
            ("split", {"CDS_SPLIT_PLANES": "1", "CDS_UNION_KEYS": "0"},
             ("pack_target_planes", "split_planes_from_packed",
              "score_query_batch_split", "score_query_batch")))
    found = {}
    for name, env, kernels in runs:
        os.environ.update(env)
        try:
            GLOBAL.reset()
            reset_peak()
            kbuild.reset_launches()
            t0 = time.time()
            matches = color_depth_search(masks, targets, params,
                                         neg_query=neg_png,
                                         mirror_neg_query=True,
                                         device=DEVICE)
            seconds = time.time() - t0
            launches = dict(kbuild.launches)
        finally:
            for k in env:
                del os.environ[k]
        missing = [k for k in kernels if launches[k] == 0]
        if missing:
            raise AssertionError(f"the {name} negative-query run never "
                                 f"launched {missing}")
        found[name] = {(m.mask_image.mip_id, m.matched_image.mip_id):
                       (m.matching_pixels, m.mirrored,
                        m.matching_pixels_ratio) for m in matches}
        print(f"phase 6 negative query ({name}): {n_masks} masks x "
              f"{len(targets)} targets in {seconds:.2f}s, {len(matches)} "
              f"matches, {GLOBAL.get('cds.rescore.count'):.0f} flagged "
              f"pairs rescored; peak torch.cuda.max_memory_allocated "
              f"{peak_gib():.2f} GiB; launches "
              f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    if found["split"] != found["default"]:
        diff = sorted(set(found["split"].items())
                      ^ set(found["default"].items()))
        raise AssertionError(f"negative query: the split run's matches "
                             f"differ from the default run's: {diff[:5]}")
    if len(found["default"]) < 16:
        raise AssertionError(f"only {len(found['default'])} negative-query "
                             "matches")
    region = label_regions_mask(W, H)
    oracles = {}
    pairs = sorted(found["default"])
    for i in rng.choice(len(pairs), 16, replace=False):
        mask_id, target_id = pairs[int(i)]
        mi = int(mask_id.split("-")[1])
        ti = int(target_id.split("-")[1])
        if mi not in oracles:
            oracles[mi] = PixelMatchOracle(
                lib.masks[mi], 20, mirror=True, target_threshold=20,
                z_tolerance=0.01, xy_shift=2, excluded_region=region,
                neg_query_rgb=lib.masks[1], neg_query_threshold=20,
                mirror_neg_query=True)
        res = oracles[mi].score(lib.targets[ti])
        for name, got in found.items():
            if (res.matching_pixels, res.mirrored) != \
                    got[(mask_id, target_id)][:2]:
                raise AssertionError(
                    f"negative query ({name}), mask {mi} target {ti}: "
                    f"{got[(mask_id, target_id)][:2]}, oracle "
                    f"{res.matching_pixels}/{res.mirrored}")
    print("phase 6 negative query: both runs found the same matches; 16 "
          "sampled equal the float64 oracle's", flush=True)


def run_mesh_steps(lib, device, shape_ref: dict, dense_ref: dict):
    """Phase 7 (a): every step of parallel/mesh.py at MESH_SHARDS shards of
    one card on phase 2's shapes (2,048 targets, 8 masks at 1.0%; the
    first cut mask's dense and split shape planes), each checked against
    the single-device kernels; then each step's time beside theirs.
    Returns ({kernel: launches}, {step: calls}, {step: (mesh ms, single
    ms)}); the launches and calls are those of the steps' own runs (every
    count set to 0 just before each and added up just after)."""
    import numpy as np
    import torch

    from colormipsearch_tpu_torch import convert
    from colormipsearch_tpu_torch.kernels import build as kbuild
    from colormipsearch_tpu_torch.oracle.pixel import (
        label_regions_mask,
        shift_offsets,
    )
    from colormipsearch_tpu_torch.ops import common, pixel_match as pm
    from colormipsearch_tpu_torch.ops import shape_score as ss
    from colormipsearch_tpu_torch.parallel import mesh as pmesh

    mesh = pmesh.create_mesh([device] * MESH_SHARDS)
    w = T_PAD // MESH_SHARDS
    n_px = H * W
    launches = dict.fromkeys(kbuild.launches, 0)
    calls = dict.fromkeys(pmesh.step_calls, 0)
    times = {}

    def driven(fn):
        sync()
        kbuild.reset_launches()
        pmesh.reset_step_calls()
        result = fn()
        sync()
        for k, v in kbuild.launches.items():
            launches[k] += v
        for k, v in pmesh.step_calls.items():
            calls[k] += v
        return result

    def per_shard_topk(best, mirrored, flags):
        parts = []
        for sh in range(MESH_SHARDS):
            cols = slice(sh * w, (sh + 1) * w)
            sk, ik, mk, fk = pm.union_keys_topk_plain(
                best[:, cols].contiguous(), mirrored[:, cols].contiguous(),
                min(TOP_K, w), flags[:, cols].contiguous())
            parts.append((sk, ik + sh * w, mk, fk))
        return tuple(torch.cat([p[i] for p in parts], 1) for i in range(4))

    def check(name, got, single, top_k):
        best, mirrored, flags = single
        if top_k:
            require_equal(f"phase 7 {name} step, top-k {TOP_K}, vs a "
                          "per-shard top-k of the single-device scores",
                          got[:4], per_shard_topk(best, mirrored, flags))
            require_equal(f"phase 7 {name} step, top-k: global max and "
                          "flagged-pair count", got[4:],
                          (best.max(1).values,
                           (flags > 0).sum(1, dtype=torch.int32)))
        else:
            require_equal(f"phase 7 {name} step vs the single-device "
                          "kernel", got, (best, mirrored, flags,
                                          best.max(1).values))

    rgb = torch_from(np.stack(lib.targets[:T_PAD]), device)
    keys = common.pack_target_planes_keys(
        rgb, 20, common.rank_lut_tensor(device), t_pad=T_PAD)
    planes = common.pack_target_planes(rgb, 20, t_pad=T_PAD)
    del rgb
    kw = dict(mirror=True, xy_shift=2, pix_color_fluctuation=1.0,
              excluded_region=label_regions_mask(W, H))
    plans = [pm.build_query_plan(m, 20, **kw) for m in lib.masks[:BATCH]]
    q_pad = max(p.positions.shape[1] for p in plans)
    plans = [pm.build_query_plan(m, 20, pad_to=q_pad, **kw)
             for m in lib.masks[:BATCH]]
    pargs = tuple(convert.as_tensor(np.stack([getattr(p, f) for p in plans]),
                                    device)
                  for f in ("positions", "q_cls", "q_s", "q_p"))
    zkw = dict(ztol_num=plans[0].ztol_num, ztol_den=plans[0].ztol_den,
               n_straight=plans[0].n_straight)
    n_straight = plans[0].n_straight
    kargs = tuple(convert.as_tensor(np.stack([
        getattr(pm.key_plan_from_query_plan(p, n_px, 1.0), f)
        for p in plans]), device) for f in ("positions", "lo", "span"))
    fplans = [pm.build_full_union_key_plan(m, 20, light=True, **kw)
              for m in lib.masks[:BATCH]]
    u_pos, mu_pos, q_pos, key_list, u2 = pm.stack_union_pos_args(fplans, n_px)
    qidx = pm.stack_union_qkey_args(fplans, n_px)[2]
    tabs = convert.interval_tables(pm.interval_table_arrays(0.01), device)
    u_t, mu_t, kl_t = (convert.as_tensor(a, device)
                       for a in (u_pos, mu_pos, key_list))
    lo2, sp2 = pm.expand_union_tables_from_pos(
        u_t, convert.as_tensor(q_pos, device), kl_t, *tabs,
        offsets=tuple(shift_offsets(2)), w=W, h=H)
    qargs = (u_t, mu_t, convert.qidx(qidx, device), kl_t, *tabs)

    # rank-key planes: the K10, K3 and row 14 steps
    k10 = pm.score_query_batch_keys(keys, *kargs, n_straight=n_straight)
    k3 = pm.score_query_batch_union_keys(keys, u_t, mu_t, lo2, sp2, u2)
    zeros = torch.zeros_like(k3[0])
    key_shards = pmesh.shard_target_planes(mesh, keys)
    key_steps = {(name, top_k): make(top_k) for top_k in (0, TOP_K)
                 for name, make in (
                     ("keys", lambda k: pmesh.make_sharded_batch_step_keys(
                         mesh, n_straight=n_straight, top_k=k)),
                     ("union_keys",
                      lambda k: pmesh.make_sharded_batch_step_union_keys(
                          mesh, top_k=k, u2=u2)),
                     ("union_qkeys",
                      lambda k: pmesh.make_sharded_batch_step_union_qkeys(
                          mesh, top_k=k, u2=u2)))}

    def run_key_steps():
        # row 13's expansion feeds the union-key step
        lo, sp = pm.expand_union_tables(*qargs[2:])
        out = {}
        for top_k in (0, TOP_K):
            out["keys", top_k] = key_steps["keys", top_k](key_shards, *kargs)
            out["union_keys", top_k] = key_steps["union_keys", top_k](
                key_shards, u_t, mu_t, lo, sp)
            out["union_qkeys", top_k] = key_steps["union_qkeys", top_k](
                key_shards, *qargs)
        return out

    got = driven(run_key_steps)
    for top_k in (0, TOP_K):
        check("keys (K10)", got["keys", top_k], (*k10, zeros), top_k)
        check("union_keys (K3)", got["union_keys", top_k], (*k3, zeros),
              top_k)
        require_equal(f"phase 7 union_qkeys step (top-k {top_k}) vs the "
                      "union_keys step fed with row 13's expansion",
                      got["union_qkeys", top_k], got["union_keys", top_k])
    times["batch_keys (K10)"] = (
        timed(lambda: key_steps["keys", 0](key_shards, *kargs), 3),
        timed(lambda: pm.score_query_batch_keys(
            keys, *kargs, n_straight=n_straight), 3))
    times["batch_union_keys (K3)"] = (
        timed(lambda: key_steps["union_keys", 0](key_shards, u_t, mu_t,
                                                 lo2, sp2), 3),
        timed(lambda: pm.score_query_batch_union_keys(keys, u_t, mu_t, lo2,
                                                      sp2, u2), 3))
    times["batch_union_qkeys (row 14)"] = (
        timed(lambda: key_steps["union_qkeys", 0](key_shards, *qargs), 3),
        timed(lambda: pm.score_query_batch_union_qkeys(keys, *qargs, u2), 3))
    del keys, key_shards, got, k3, k10, lo2, sp2
    sync()
    free_cached()

    # summary planes: the search and packed steps (K9), the split step
    # (K11)
    k9 = pm.score_query_batch(planes, *pargs, target_threshold=-1, **zkw)
    one = tuple(a[:1].contiguous() for a in pargs)
    k9_one = pm.score_query_batch(planes, *one, target_threshold=-1, **zkw)
    sp, c8 = common.split_planes_from_packed(planes)
    k11 = pm.score_query_batch_split(sp, c8, *pargs, **zkw)
    packed_shards = pmesh.shard_target_planes(mesh, planes)
    sp_shards, c8_shards = (pmesh.shard_target_planes(mesh, x)
                            for x in (sp, c8))
    del sp, c8
    q1 = tuple(a[0] for a in pargs)
    packed_steps = {(name, top_k): make(top_k) for top_k in (0, TOP_K)
                    for name, make in (
                        ("search", lambda k: pmesh.make_sharded_search_step(
                            mesh, target_threshold=-1, top_k=k, **zkw)),
                        ("batch", lambda k: pmesh.make_sharded_batch_step(
                            mesh, target_threshold=-1, top_k=k, **zkw)))}
    split_step = pmesh.make_sharded_batch_step_split(mesh, **zkw)

    def run_packed_steps():
        out = {key: step(packed_shards, *(q1 if key[0] == "search"
                                          else pargs))
               for key, step in packed_steps.items()}
        out["split"] = split_step(sp_shards, c8_shards, *pargs)
        return out

    got = driven(run_packed_steps)
    for top_k in (0, TOP_K):
        check("packed (K9)", got["batch", top_k], k9, top_k)
    check("split (K11)", got["split"], k11, 0)
    require_equal("phase 7 split step vs the single-device K9", got["split"],
                  (*k9, k9[0].max(1).values))
    require_equal("phase 7 search step vs the single-device K9 (one mask)",
                  got["search", 0],
                  (*(x[0] for x in k9_one), k9_one[0].max()))
    ref_k = per_shard_topk(*k9_one)
    require_equal("phase 7 search step, top-k, vs a per-shard top-k",
                  got["search", TOP_K], (*(x[0] for x in k9_one),
                                         k9_one[0].max(), ref_k[0][0],
                                         ref_k[1][0]))
    flagged = int((k9[2] > 0).sum())
    print(f"phase 7 packed top-k step: {flagged} flagged pairs in the "
          f"batch, {int(((got['batch', TOP_K][3] > 0)).sum())} of them "
          "among the per-shard top-k", flush=True)
    times["search (K9, one mask)"] = (
        timed(lambda: packed_steps["search", 0](packed_shards, *q1), 3),
        timed(lambda: pm.score_query_batch(planes, *one, target_threshold=-1,
                                           **zkw), 3))
    times["batch (K9)"] = (
        timed(lambda: packed_steps["batch", 0](packed_shards, *pargs), 3),
        timed(lambda: pm.score_query_batch(planes, *pargs,
                                           target_threshold=-1, **zkw), 3))
    k11_args = (*common.split_planes_from_packed(planes), *pargs)
    times["batch_split (K11)"] = (
        timed(lambda: split_step(sp_shards, c8_shards, *pargs), 3),
        timed(lambda: pm.score_query_batch_split(*k11_args, **zkw), 3))
    del planes, packed_shards, sp_shards, c8_shards, got, k9, k11, k11_args
    sync()
    free_cached()

    # the shape steps: row 18b in both modes, K5
    rows = convert.shape_planes(dense_ref["rows"], device)
    q2 = convert.as_tensor(dense_ref["q2"], device)
    both = ss.shape_score_pairs_both(rows, q2)
    single = ss.shape_score_pairs(rows[0], q2[0])
    t_gap, q_gap, t_he, q_he = shape_ref["k5_args"]
    k5 = ss.shape_score_pairs_split(t_gap, q_gap, t_he, q_he)
    rows_shards = pmesh.shard_target_planes(mesh, rows)
    rows0_shards = pmesh.shard_target_planes(mesh, rows[0])
    gap_shards, he_shards = (pmesh.shard_target_planes(mesh, x)
                             for x in (t_gap, t_he))
    shape_step = pmesh.make_sharded_shape_step(mesh)
    both_step = pmesh.make_sharded_shape_step(mesh, both=True)
    split_shape_step = pmesh.make_sharded_shape_split_step(mesh)
    got = driven(lambda: (
        shape_step(rows0_shards, q2[0]), both_step(rows_shards, q2),
        split_shape_step(gap_shards, q_gap, he_shards, q_he)))
    require_equal("phase 7 shape step (row 18b) vs the single-device "
                  "kernel", got[0], single)
    require_equal("phase 7 shape step, both orientations, vs the "
                  "single-device kernel", got[1], both)
    require_equal("phase 7 split shape step (K5) vs the single-device "
                  "kernel", got[2], k5)
    times["shape (row 18b)"] = (
        timed(lambda: shape_step(rows0_shards, q2[0]), 5),
        timed(lambda: ss.shape_score_pairs(rows[0], q2[0]), 5))
    times["shape_both (row 18b)"] = (
        timed(lambda: both_step(rows_shards, q2), 5),
        timed(lambda: ss.shape_score_pairs_both(rows, q2), 5))
    times["shape_split (K5)"] = (
        timed(lambda: split_shape_step(gap_shards, q_gap, he_shards, q_he),
              5),
        timed(lambda: ss.shape_score_pairs_split(t_gap, q_gap, t_he, q_he),
              5))
    del rows, q2, rows_shards, rows0_shards, gap_shards, he_shards, got
    sync()
    free_cached()
    missing = [k for k, v in calls.items() if v == 0]
    if missing:
        raise AssertionError(f"phase 7 (a) never ran the steps {missing}")
    print(f"phase 7 (a): every mesh step at {MESH_SHARDS} shards equals "
          f"the single-device kernels; step calls {calls}", flush=True)
    return launches, calls, times


def run_mesh_engines(lib, work: str) -> dict:
    """Phase 7 (b)-(d): the engines over a mesh of MESH_SHARDS shards of
    cuda:0 against the single-device engines on the same inputs; every
    match (all fields) or shape score must be equal, and each mesh run
    must go through its mesh step. Returns the mesh runs' launches, each
    run's counts set to 0 just before it and added up just after."""
    from colormipsearch_tpu_torch.cli.commands import stage_seconds
    from colormipsearch_tpu_torch.dataio.json_io import (
        JSONMatchesReader,
        read_neurons_json,
    )
    from colormipsearch_tpu_torch.engine.cds import CDSearchEngine, CDSParams
    from colormipsearch_tpu_torch.engine.gradscore import GradScoreEngine
    from colormipsearch_tpu_torch.kernels import build as kbuild
    from colormipsearch_tpu_torch.parallel import mesh as pmesh
    from colormipsearch_tpu_torch.utils.metrics import GLOBAL

    mesh = pmesh.create_mesh([f"{DEVICE}:0"] * MESH_SHARDS)
    launches = dict.fromkeys(kbuild.launches, 0)
    masks = read_neurons_json(os.path.join(work, "masks.json"))
    targets = read_neurons_json(os.path.join(work, "targets.json"))
    params = CDSParams(mask_threshold=20, data_threshold=20,
                       pix_color_fluctuation=1.0, xy_shift=2,
                       mirror_mask=True, pct_positive_pixels=1.0,
                       with_name_label_region=True,
                       with_color_scale_region=True)

    def run(use_mesh, fn, stage):
        GLOBAL.reset()
        reset_peak()
        kbuild.reset_launches()
        pmesh.reset_step_calls()
        t0 = time.time()
        result = fn(use_mesh)
        sync()
        out = {"result": result, "seconds": time.time() - t0,
               "launches": dict(kbuild.launches),
               "calls": dict(pmesh.step_calls), "peak": peak_gib(),
               "stages": stage_seconds(stage)}
        if use_mesh is not False:
            for k, v in out["launches"].items():
                launches[k] += v
        return out

    def both_ways(label, fn, steps, stage="cds"):
        single = run(False, fn, stage)
        meshed = run(mesh, fn, stage)
        if meshed["result"] != single["result"]:
            diff = sorted(set(meshed["result"]) ^ set(single["result"]))
            raise AssertionError(f"phase 7 {label}: the mesh run differs "
                                 f"from the single-device run: {diff[:5]}")
        missing = [s for s in steps if meshed["calls"][s] == 0]
        if missing or any(single["calls"].values()):
            raise AssertionError(f"phase 7 {label}: mesh steps {missing} "
                                 "never ran (or the single-device run "
                                 "used the mesh)")
        print(f"phase 7 {label}: {len(meshed['result'])} results, identical"
              f"; single-device {single['seconds']:.2f}s (peak "
              f"{single['peak']:.2f} GiB), mesh {meshed['seconds']:.2f}s "
              f"(peak {meshed['peak']:.2f} GiB); mesh stage seconds "
              f"{json.dumps(meshed['stages'])}; mesh step calls "
              f"{ {k: v for k, v in meshed['calls'].items() if v} }",
              flush=True)

    def cds(n_masks, engine_kw=None, **find_kw):
        def fn(use_mesh):
            engine = CDSearchEngine(params, device=DEVICE, use_mesh=use_mesh,
                                    **(engine_kw or {}))
            return sorted((m.mask_image.mip_id, m.matched_image.mip_id,
                           m.matching_pixels, m.mirrored,
                           m.matching_pixels_ratio, m.normalized_score)
                          for m in engine.find_all_matches(
                              masks[:n_masks], targets, **find_kw))
        return fn

    # (b) the engine's configurations, (c) the negative query
    both_ways(f"(b) default, {MESH_MASKS} masks", cds(MESH_MASKS),
              ["batch_union_keys"])
    both_ways(f"(b) packed, {MESH_RESCORE_MASKS} masks",
              cds(MESH_RESCORE_MASKS, dict(use_key_planes=False)), ["batch"])
    both_ways(f"(b) --use-key-planes, {MESH_MASKS} masks",
              cds(MESH_MASKS, dict(use_key_planes=True)), ["batch_keys"])
    os.environ["CDS_SPLIT_PLANES"] = "1"
    try:
        both_ways(f"(b) split (CDS_SPLIT_PLANES=1), {MESH_RESCORE_MASKS} "
                  "masks", cds(MESH_RESCORE_MASKS,
                               dict(use_key_planes=False)), ["batch_split"])
    finally:
        del os.environ["CDS_SPLIT_PLANES"]
    both_ways(f"(b) default with max_matches_per_mask 20, {MESH_MASKS} "
              "masks", cds(MESH_MASKS, max_matches_per_mask=20),
              ["batch_union_keys"])
    both_ways(f"(c) negative query (mask 1, mirrored), {BATCH} masks",
              cds(BATCH, dict(neg_query_rgb=lib.masks[1],
                              neg_query_threshold=20,
                              mirror_neg_query=True)),
              ["batch_union_keys", "batch_keys"])

    # (d) gradScores through the device store
    locs = JSONMatchesReader.list_matches_locations(
        [os.path.join(work, "cds", "masks")], 0, MESH_GS_MASKS)
    gs_params = CDSParams(mask_threshold=20, mirror_mask=True,
                          with_name_label_region=True,
                          with_color_scale_region=True)

    def gs(use_mesh):
        engine = GradScoreEngine(gs_params, device=DEVICE, use_mesh=use_mesh,
                                 pack_store=os.path.join(work, "store"),
                                 device_store=True)
        scored = []
        for loc in locs:
            scored.extend(engine.score_matches(
                JSONMatchesReader.read_matches(loc)))
        return sorted((m.mask_image.mip_id, m.matched_image.mip_id,
                       m.gradient_area_gap, m.high_expression_area,
                       m.normalized_score) for m in scored)

    both_ways(f"(d) gradScores, device store, {len(locs)} masks", gs,
              ["shape_split"], "gs")
    return launches


def _require_same(what: str, got: dict, want: dict) -> None:
    """Raise unless the two {key: value} results are equal, naming the
    first keys that differ."""
    if got != want:
        diff = sorted(k for k in set(got) | set(want)
                      if got.get(k) != want.get(k))
        raise AssertionError(f"{what}: {len(diff)} entries differ, first "
                             f"{[(k, got.get(k), want.get(k)) for k in diff[:3]]}")
    if not got:
        raise AssertionError(f"{what}: nothing to compare")
    print(f"{what}: {len(got)} entries equal", flush=True)


def _cli_step(step: str, argv: list, kernels=(), unit: str = "pairs",
              count=None) -> dict:
    """Phase 9: one command of the port's CLI with fresh launch counts;
    it must exit 0 and launch every kernel in `kernels`. Prints its wall
    seconds, its rate in `unit` (count(), read after the run) and its
    launches on a line of its own; returns the launches."""
    from colormipsearch_tpu_torch.cli import main as cli_main
    from colormipsearch_tpu_torch.kernels import build as kbuild

    argv = [str(a) for a in argv]
    kbuild.reset_launches()
    t0 = time.time()
    rc = cli_main.main(argv)
    seconds = time.time() - t0
    launches = {k: v for k, v in kbuild.launches.items() if v}
    if rc != 0:
        raise AssertionError(f"phase 9 {step}: {argv[0]} exited {rc}")
    missing = [k for k in kernels if not launches.get(k)]
    if missing:
        raise AssertionError(f"phase 9 {step}: {argv[0]} never launched "
                             f"{missing}")
    n = count() if count is not None else 0
    print(f"phase 9 {step}: {argv[0]} in {seconds:.2f}s, {n} {unit} = "
          f"{n / seconds:.0f} {unit}/s; launches {launches}", flush=True)
    free_cached()
    return launches


def _v3_pairs(root: str) -> dict:
    """{(mask file, target file): (matchingPixels, mirrored)} of a v3
    per-mask result directory."""
    out = {}
    for name in sorted(os.listdir(root)):
        with open(os.path.join(root, name)) as f:
            doc = json.load(f)
        mask = doc["inputImage"]["computeFiles"]["InputColorDepthImage"]
        for r in doc["results"]:
            target = r["image"]["computeFiles"]["InputColorDepthImage"]
            out[mask, target] = (r["matchingPixels"], r.get("mirrored",
                                                            False))
    return out


def _v2_rows(root: str) -> dict:
    """{(mask file, target file): row} of the per-mask files of a v2
    result directory (its cds parameters record left out)."""
    out = {}
    for name in sorted(os.listdir(root)):
        path = os.path.join(root, name)
        if not name.endswith(".json") or name.endswith("cdsparams.json"):
            continue
        with open(path) as f:
            for r in json.load(f)["results"]:
                out[r["sourceImageName"], r["imageName"]] = r
    return out


def _v2_pairs(root: str) -> dict:
    """{(mask file, target file): (matchingPixels, mirrored)} of a v2
    result directory."""
    return {k: (r["matchingPixels"], r.get("mirrored", False))
            for k, r in _v2_rows(root).items()}


def _image_index(path: str) -> int:
    """The library index of a phase-3 PNG (t00012.png, m00003.png)."""
    return int(os.path.basename(path)[1:6])


def _check_shape_rows(lib, variants, rows: dict, rng, what: str) -> None:
    """P9_SAMPLES rows of a v2 result (each with shape scores) against
    the float64 ShapeMatchOracle, exactly."""
    from colormipsearch_tpu_torch.engine.cds import CDSParams
    from colormipsearch_tpu_torch.oracle.shape import ShapeMatchOracle

    region = CDSParams(mask_threshold=20, with_name_label_region=True,
                       with_color_scale_region=True) \
        .shape_excluded_region(H, W)
    keys = sorted(k for k, r in rows.items()
                  if r.get("gradientAreaGap", -1) >= 0)
    if not keys:
        raise AssertionError(f"phase 9 {what}: no row has shape scores")
    picks = [keys[int(i)] for i in rng.choice(
        len(keys), min(P9_SAMPLES, len(keys)), replace=False)]
    oracles = {mask: ShapeMatchOracle(lib.masks[_image_index(mask)], 20,
                                      mirror=True, excluded_region=region)
               for mask in sorted({m for m, _ in picks})}

    def score(key):
        ti = _image_index(key[1])
        g, z = variants[ti]
        res = oracles[key[0]].score(lib.targets[ti], g, z)
        return res.gradient_area_gap, res.high_expression_area

    with concurrent.futures.ThreadPoolExecutor(os.cpu_count() or 4) as pool:
        for key, want in zip(picks, pool.map(score, picks)):
            got = (rows[key]["gradientAreaGap"],
                   rows[key]["highExpressionArea"])
            if got != want:
                raise AssertionError(f"phase 9 {what}: {key} shape scores "
                                     f"{got}, oracle {want}")
    print(f"phase 9 {what}: {len(picks)} sampled rows of {len(keys)} equal "
          "the float64 ShapeMatchOracle", flush=True)


def run_file_pipeline(lib, variants, work: str, rng) -> None:
    """Phase 9: the file-pipeline commands of the port's CLI on phase 3's
    library, on the card: (a) the neuron JSONs made by
    createColorDepthSearchDataInput and a colorDepthSearch from them,
    (b) normalizeGradientScores over phase 4's store run, (c) the v2 MIP
    lists and searchFromJSON, (d) searchLocalFiles with the fused shape
    pass, (e) gradientScore over (c)'s files, (f) searchFromJSON over the
    two halves of the targets and mergeResults."""
    import numpy as np

    from colormipsearch_tpu_torch.oracle.shape import (
        negative_score,
        normalized_score,
    )

    p9 = os.path.join(work, "p9")
    targets, masks = os.path.join(work, "targets"), \
        os.path.join(work, "masks")
    variant_flags = ["-gp", os.path.join(targets, "grad"),
                     "-zgp", os.path.join(targets, "zgap")]
    n_targets = len(lib.targets)
    pairs = P9_MASKS * n_targets
    mask_files = {os.path.join(masks, f"m{i:05d}.png")
                  for i in range(P9_MASKS)}

    # (a) inputs by the port's command, then a search from them
    made = os.path.join(p9, "in")

    def n_neurons(name):
        return lambda: len(json.load(open(os.path.join(made, name))))

    _cli_step("(a)", ["createColorDepthSearchDataInput", "-i", targets,
                      "--gradients-location", os.path.join(targets, "grad"),
                      "--zgap-location", os.path.join(targets, "zgap"),
                      "-od", made, "--output-filename", "targets.json"],
              unit="neurons", count=n_neurons("targets.json"))
    _cli_step("(a)", ["createColorDepthSearchDataInput", "-i", masks,
                      "-od", made, "--output-filename", "masks.json"],
              unit="neurons", count=n_neurons("masks.json"))
    for name in ("targets.json", "masks.json"):
        files = []
        for root in (made, work):
            with open(os.path.join(root, name)) as f:
                files.append({n["computeFiles"]["InputColorDepthImage"]:
                              n["computeFiles"] for n in json.load(f)})
        _require_same(f"phase 9 (a): the compute files of {name} vs "
                      "write_library's", *files)
    _cli_step("(a)", ["colorDepthSearch", "-m",
                      f"{os.path.join(made, 'masks.json')}:0:{P9_MASKS}",
                      "-i", os.path.join(made, "targets.json"), "--device",
                      DEVICE, "-od", os.path.join(p9, "cds"),
                      "--perMaskSubdir", "masks", *FLAGS],
              CDS_KERNELS, count=lambda: pairs)
    cds = _v3_pairs(os.path.join(p9, "cds", "masks"))
    phase3 = {k: v for k, v in _v3_pairs(os.path.join(work, "out", "masks"))
              .items() if k[0] in mask_files}
    _require_same("phase 9 (a): the search from the command's inputs vs "
                  "phase 3", cds, phase3)

    # (b) normalize phase 4's store run
    norm = os.path.join(p9, "norm")
    shutil.copytree(os.path.join(work, "gs_store"), norm)
    before = _read_results(os.path.join(norm, "masks"))
    _cli_step("(b)", ["normalizeGradientScores", "--matches",
                      os.path.join(norm, "masks"), "-od", norm,
                      "--perMaskSubdir", "masks"], unit="rows",
              count=lambda: sum(map(len, before.values())))
    after = _read_results(os.path.join(norm, "masks"))
    n_rows = 0
    for mip, rows in before.items():
        eligible = [r for r in rows if r.get("gradientAreaGap", -1) >= 0]
        max_px = max(r["matchingPixels"] or -1 for r in eligible)
        max_neg = max(negative_score(r["gradientAreaGap"],
                                     r["highExpressionArea"])
                      for r in eligible)
        got = {r["image"]["mipId"]: r for r in after[mip]}
        if set(got) != {r["image"]["mipId"] for r in eligible}:
            raise AssertionError(f"phase 9 (b): {mip} holds other rows")
        for r in eligible:
            g = got[r["image"]["mipId"]]
            want = float(np.float32(normalized_score(
                r["matchingPixels"], r["gradientAreaGap"],
                r["highExpressionArea"], max_px, max_neg)))
            if g["normalizedScore"] != want or \
                    {k: v for k, v in g.items() if k != "normalizedScore"} \
                    != {k: v for k, v in r.items()
                        if k != "normalizedScore"}:
                raise AssertionError(f"phase 9 (b): {mip} x "
                                     f"{r['image']['mipId']}: {g}, want "
                                     f"normalizedScore {want} and the "
                                     f"other fields of {r}")
            n_rows += 1
    print(f"phase 9 (b): {n_rows} normalized scores of {len(before)} mask "
          "files equal oracle/shape.normalized_score; every other field "
          "unchanged", flush=True)

    # (c) the v2 lists and searchFromJSON
    lists = os.path.join(p9, "lists")
    for name, src in (("targets", targets), ("masks", masks)):
        _cli_step("(c)", ["createColorDepthSearchJSONInput", "-i", src,
                          "-od", lists], unit="MIPs",
                  count=lambda: len(json.load(open(
                      os.path.join(lists, f"{name}.json")))))
    mask_list = f"{os.path.join(lists, 'masks.json')}:0:{P9_MASKS}"
    target_list = os.path.join(lists, "targets.json")
    _cli_step("(c)", ["searchFromJSON", "-m", mask_list, "-i", target_list,
                      "--device", DEVICE, "-od", os.path.join(p9, "json"),
                      *FLAGS], CDS_KERNELS, count=lambda: pairs)
    v2_json = _v2_rows(os.path.join(p9, "json"))
    _require_same("phase 9 (c): searchFromJSON vs (a)'s colorDepthSearch",
                  _v2_pairs(os.path.join(p9, "json")), cds)

    # (d) searchLocalFiles with the fused shape pass
    local = os.path.join(p9, "local")
    _cli_step("(d)", ["searchLocalFiles", "-m", f"{masks}:0:{P9_MASKS}",
                      "-i", targets, "--with-grad-scores", *variant_flags,
                      "--device", DEVICE, "-od", local, *FLAGS],
              (*CDS_KERNELS, "shape_score_pairs_split"),
              count=lambda: pairs)
    v2_local = _v2_rows(local)
    _require_same("phase 9 (d): searchLocalFiles vs (c)'s searchFromJSON",
                  _v2_pairs(local), _v2_pairs(os.path.join(p9, "json")))
    _check_shape_rows(lib, variants, v2_local, rng, "(d)")

    # (e) gradientScore over (c)'s files
    rescored = os.path.join(p9, "gs")
    _cli_step("(e)", ["gradientScore", "-rd", os.path.join(p9, "json"),
                      *variant_flags, "--maskThreshold", "20",
                      "--mirrorMask", "--device", DEVICE, "-od", rescored],
              ("shape_score_pairs_split",), unit="rows",
              count=lambda: len(v2_json))
    v2_gs = _v2_rows(rescored)
    _check_shape_rows(lib, variants, v2_gs, rng, "(e)")

    def shape(rows):
        return {k: (r.get("gradientAreaGap"), r.get("highExpressionArea"))
                for k, r in rows.items()}
    _require_same("phase 9 (e): gradientScore vs (d)'s fused pass",
                  shape(v2_gs), shape(v2_local))

    # (f) the two halves of the targets, merged
    half = n_targets // 2
    for i, spec in enumerate((f"{target_list}:0:{half}",
                              f"{target_list}:{half}:{n_targets - half}")):
        _cli_step("(f)", ["searchFromJSON", "-m", mask_list, "-i", spec,
                          "--device", DEVICE,
                          "-od", os.path.join(p9, f"half{i}"), *FLAGS],
                  CDS_KERNELS, count=lambda: P9_MASKS * half)
    merged = os.path.join(p9, "merged")
    _cli_step("(f)", ["mergeResults", "-rd", os.path.join(p9, "half0"),
                      os.path.join(p9, "half1"), "-od", merged],
              unit="rows", count=lambda: len(_v2_rows(merged)))

    def scores(rows):
        return {k: (r["matchingPixels"], r.get("mirrored", False),
                    r["matchingRatio"], r["normalizedScore"])
                for k, r in rows.items()}
    _require_same("phase 9 (f): the merged halves vs (c)'s whole run",
                  scores(_v2_rows(merged)), scores(v2_json))
    print(f"phase 9: (c) {len(v2_json)} rows, (d) and (e) shape scores "
          f"equal, (f) the merged halves equal (c)", flush=True)


def _launch_ranks(what: str, n_ranks: int, backend: str, devices: str,
                  rank_args) -> tuple[list, float]:
    """Phase 10: n_ranks processes of the port's launcher
    (parallel/launch.py) on this card; rank_args(rank) gives each rank's
    arguments after the group options. Waits for all of them (killing
    every survivor at the deadline) and raises unless every rank exits 0.
    Returns ([stderr tail of each rank], wall seconds)."""
    import socket

    if n_ranks == 1:
        init = f"file://{os.path.join(REPO, 'build', 'p10_rendezvous')}"
        if os.path.exists(init[len("file://"):]):
            os.remove(init[len("file://"):])
    else:
        with socket.socket() as sk:
            sk.bind(("127.0.0.1", 0))
            init = f"tcp://127.0.0.1:{sk.getsockname()[1]}"
    env = dict(os.environ, PYTHONPATH=REPO)
    t0 = time.time()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "colormipsearch_tpu_torch.parallel.launch",
         "--init-method", init, "--world-size", str(n_ranks), "--rank",
         str(r), "--backend", backend, "--local-devices", devices,
         "--timeout", str(P10_TIMEOUT), *[str(a) for a in rank_args(r)]],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(n_ranks)]
    tails, failed = [], []
    try:
        for r, proc in enumerate(procs):
            _out, err = proc.communicate(timeout=P10_TIMEOUT + 120)
            tails.append(err[-4000:])
            if proc.returncode != 0:
                failed.append((r, proc.returncode))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    seconds = time.time() - t0
    if failed:
        raise AssertionError(f"phase 10 {what}: ranks (rank, exit code) "
                             f"{failed} failed:\n" + "\n".join(tails))
    return tails, seconds


def run_cross_process(work: str, card: str, mesh_times: dict) -> None:
    """Phase 10: the mesh across processes (parallel/mesh.py over
    torch.distributed, started by parallel/launch.py) on this one card:
    (a) the launcher's selftest under NCCL at world size 1 with
    MESH_SHARDS local shards of cuda:0, (b) the same selftest under gloo
    at 2 ranks x 2 shards of cuda:0 (CUDA tensors staged through the
    host), both at phase 2's shapes (production image, 2,048 targets, 8
    masks), every step equal to the single-device kernels in every rank;
    (c) colorDepthSearch through the launcher at 2 ranks (gloo, 2 shards
    of cuda:0 each) on phase 9 (a)'s inputs: each rank writes a part, the
    union of the two trees equals phase 9 (a)'s matches, and each rank
    launched K1-K4 and ran its collectives. NCCL refuses two ranks on one
    card, so NCCL across ranks is not run here."""
    p10 = os.path.join(work, "p10")
    os.makedirs(p10, exist_ok=True)
    free_cached()
    selftests = {}
    for label, n_ranks, backend, devices in (
            ("(a) NCCL, 1 rank x 4 shards", 1, "nccl",
             ",".join([f"{DEVICE}:0"] * MESH_SHARDS)),
            ("(b) gloo, 2 ranks x 2 shards", 2, "gloo",
             f"{DEVICE}:0,{DEVICE}:0")):
        tag = backend
        _tails, seconds = _launch_ranks(
            label, n_ranks, backend, devices,
            lambda r: ["--selftest", os.path.join(p10, f"{tag}{r}.json"),
                       "--selftest-size", "production"])
        docs = []
        for r in range(n_ranks):
            with open(os.path.join(p10, f"{tag}{r}.json")) as f:
                docs.append(json.load(f))
        for doc in docs:
            bad = [k for k, v in doc["checks"].items() if not v]
            idle = [k for k, v in doc["step_calls"].items() if not v]
            colls = doc["collective_calls"]
            if not doc["ok"] or bad or idle or not colls["all_reduce"] \
                    or not colls["all_gather"]:
                raise AssertionError(f"phase 10 {label}: rank "
                                     f"{doc['rank']} failed {bad}, never "
                                     f"ran {idle}, collectives {colls}")
            if (backend == "gloo") != bool(colls["host_staged"]):
                raise AssertionError(f"phase 10 {label}: host staging "
                                     f"{colls['host_staged']} on {backend}")
        if any(d["outputs"] != docs[0]["outputs"] for d in docs):
            raise AssertionError(f"phase 10 {label}: the ranks' whole "
                                 "outputs differ")
        selftests[backend] = docs[0]["ms"]
        launched = {k: v for k, v in docs[0]["launches"].items() if v}
        print(f"phase 10 {label}: {len(docs[0]['checks'])} step checks "
              f"equal the single-device kernels in every rank, "
              f"{docs[0]['n_global_shards']} global shards, t_pad "
              f"{docs[0]['t_pad']}, top-k {docs[0]['top_k']}; "
              f"{seconds:.2f}s wall (each rank's own: "
              f"{[round(d['seconds'], 2) for d in docs]}, set-up "
              f"{[round(d['setup_seconds'], 2) for d in docs]}); peak GiB "
              f"{[round(d['peak_gib'], 2) for d in docs]}; collectives "
              f"{[d['collective_calls'] for d in docs]}; rank 0 step calls "
              f"{docs[0]['step_calls']}; launches {launched} ({card})",
              flush=True)
    rows = {name: (round(selftests["nccl"][name], 3),
                   round(selftests["gloo"][name], 3),
                   *(round(x, 3) for x in mesh_times[key]))
            for name, key in P10_PHASE7_STEPS.items()}
    print("phase 10 step ms (NCCL 1 x 4; gloo 2 x 2, rank 0; phase 7 mesh "
          f"4 shards in one process; single device): {json.dumps(rows)}; "
          f"top-k steps (NCCL; gloo): "
          f"""{json.dumps({k: (round(v, 3), round(selftests['gloo'][k], 3))
                           for k, v in selftests['nccl'].items()
                           if k.endswith('_topk')})} ({card})""",
          flush=True)

    # (c) colorDepthSearch through the launcher at 2 ranks
    made = os.path.join(work, "p9", "in")
    args = ["--", "colorDepthSearch", "-m",
            f"{os.path.join(made, 'masks.json')}:0:{P9_MASKS}", "-i",
            os.path.join(made, "targets.json"), "--device", DEVICE,
            "--perMaskSubdir", "masks", *FLAGS]
    _tails, seconds = _launch_ranks(
        "(c) colorDepthSearch", 2, "gloo", f"{DEVICE}:0,{DEVICE}:0",
        lambda r: ["--counts", os.path.join(p10, f"cds{r}.json"), *args,
                   "-od", os.path.join(p10, f"cds{r}")])
    want = _v3_pairs(os.path.join(work, "p9", "cds", "masks"))
    merged, parts, counts = {}, [], []
    for r in range(2):
        got = _v3_pairs(os.path.join(p10, f"cds{r}", "masks"))
        if set(got) & set(merged):
            raise AssertionError("phase 10 (c): both ranks wrote the pairs "
                                 f"{sorted(set(got) & set(merged))[:3]}")
        merged.update(got)
        parts.append(len(got))
        with open(os.path.join(p10, f"cds{r}.json")) as f:
            counts.append(json.load(f))
    _require_same("phase 10 (c): the union of the 2 ranks' matches vs "
                  "phase 9 (a)", merged, want)
    if not all(0 < n < len(want) for n in parts):
        raise AssertionError(f"phase 10 (c): the ranks wrote {parts} of "
                             f"{len(want)} matches")
    for c in counts:
        missing = [k for k in CDS_KERNELS if not c["launches"][k]]
        colls = c["collective_calls"]
        if missing or not colls["all_reduce"] or not colls["all_gather"]:
            raise AssertionError(f"phase 10 (c): rank {c['rank']} never "
                                 f"launched {missing}; collectives {colls}")
    pairs = P9_MASKS * len(json.load(open(os.path.join(made,
                                                        "targets.json"))))
    print(f"phase 10 (c): colorDepthSearch at 2 ranks x 2 shards (gloo), "
          f"{P9_MASKS} x {pairs // P9_MASKS} in {seconds:.2f}s wall = "
          f"{pairs / seconds:.0f} pairs/s (each rank's own "
          f"{[round(c['seconds'], 2) for c in counts]} s; peak GiB "
          f"{[round(c['peak_gib'], 2) for c in counts]}); rows per rank "
          f"{parts}; launches "
          f"{[{k: v for k, v in c['launches'].items() if v} for c in counts]}"
          f"; step calls "
          f"{[{k: v for k, v in c['step_calls'].items() if v} for c in counts]}"
          f"; collectives {[c['collective_calls'] for c in counts]} ({card})",
          flush=True)


def _db_step(step: str, argv: list, store: str, kernels=(),
             unit: str = "rows", count=None) -> dict:
    """Phase 11: one command of the port's CLI on the DB store with fresh
    launch counts, stage timers and peak memory; it must exit 0 and
    launch every kernel in `kernels`. Prints its wall seconds, its rate
    in `unit` (count(), read after the run), the store's size, the
    seconds of the store's writes (each with its commit) and reads
    (persist/store.py), the peak GiB and the launches on a line of its
    own; returns the launches."""
    from colormipsearch_tpu_torch.cli import main as cli_main
    from colormipsearch_tpu_torch.cli.commands import stage_seconds
    from colormipsearch_tpu_torch.kernels import build as kbuild
    from colormipsearch_tpu_torch.utils.metrics import GLOBAL

    argv = [str(a) for a in argv] + ["--config", store + ".properties"]
    GLOBAL.reset()
    reset_peak()
    kbuild.reset_launches()
    t0 = time.time()
    rc = cli_main.main(argv)
    seconds = time.time() - t0
    launches = {k: v for k, v in kbuild.launches.items() if v}
    if rc != 0:
        raise AssertionError(f"phase 11 {step}: {argv[0]} exited {rc}")
    missing = [k for k in kernels if not launches.get(k)]
    if missing:
        raise AssertionError(f"phase 11 {step}: {argv[0]} never launched "
                             f"{missing}")
    n = count()
    db = stage_seconds("db")
    print(f"phase 11 {step}: {argv[0]} in {seconds:.2f}s, {n} {unit} = "
          f"{n / seconds:.0f} {unit}/s; store {os.path.getsize(store)} "
          f"bytes; db stage seconds {json.dumps(db)} (writes "
          f"{db['write'] / seconds:.0%} of the wall, "
          f"{int(GLOBAL.get('db.commits'))} commits); peak "
          f"torch.cuda.max_memory_allocated {peak_gib():.2f} GiB; launches "
          f"{launches}", flush=True)
    free_cached()
    return launches


def _match_ids(store: str) -> dict:
    """{(mask image, target image): _id} of a store's matches."""
    from colormipsearch_tpu_torch import testing

    cols = testing.store_collections(store)
    image = {str(d["_id"]): testing.neuron_key(d, "image")
             for d in cols["neuronMetadata"]}
    return {(image[str(m["maskImageRefId"])],
             image[str(m["matchedImageRefId"])]): str(m["_id"])
            for m in cols["cdMatches"]}


def run_db_pipeline(work: str, card: str) -> dict:
    """Phase 11: the DB pipeline (persist/, a sqlite store under build/)
    with the port's CLI on phase 3's library: (a)
    createColorDepthSearchDataInput --mips-storage DB over the targets
    (with their variants) and the masks; (b) colorDepthSearch
    --mips-storage DB --results-storage DB on phase 4's first P11_MASKS
    masks, with phase 3's flags and then with phase 4's; (c)
    gradientScores --results-storage DB over those masks with phase 4's
    packed-variant store (warm) and the device-resident store, and a
    processing tag; (d) normalizeGradientScores --results-storage DB.
    After each step the store equals the same command's files on the
    same inputs: (a) phase 9 (a)'s neuron JSONs, (b) phase 3's and then
    phase 4's search, (c) phase 4's store run, (d) phase 9 (b)'s
    normalize, row for row (matches keyed by the image files of their
    neurons). Returns the launches of (b) and (c)."""
    from colormipsearch_tpu_torch import testing

    p11 = os.path.join(work, "p11")
    os.makedirs(p11)
    store = os.path.join(p11, "nb.sqlite")
    with open(store + ".properties", "w") as f:
        f.write(f"Store.Type=sqlite\nStore.Path={store}\n")
    targets, masks = os.path.join(work, "targets"), \
        os.path.join(work, "masks")
    made = os.path.join(work, "p9", "in")

    def neurons():
        return testing.canonical_store(store)["neuronMetadata"]

    # (a) the inputs into the store; the neurons = phase 9 (a)'s JSONs
    _db_step("(a)", ["createColorDepthSearchDataInput", "-i", targets,
                     "--gradients-location", os.path.join(targets, "grad"),
                     "--zgap-location", os.path.join(targets, "zgap"),
                     "--mips-storage", "DB"], store, unit="neurons",
             count=lambda: len(neurons()))
    _db_step("(a)", ["createColorDepthSearchDataInput", "-i", masks,
                     "--mips-storage", "DB"], store, unit="neurons",
             count=lambda: len(neurons()))
    want = []
    for name in ("targets.json", "masks.json"):
        with open(os.path.join(made, name)) as f:
            want.extend(json.load(f))
    _require_same("phase 11 (a): the stored neurons vs phase 9 (a)'s "
                  "neuron JSONs",
                  {n["computeFiles"]["InputColorDepthImage"]: n
                   for n in neurons()},
                  {n["computeFiles"]["InputColorDepthImage"]: n
                   for n in want})
    if len(neurons()) != len(want):
        raise AssertionError(f"phase 11 (a): {len(neurons())} neurons "
                             f"stored, {len(want)} made")
    mask_files = {os.path.join(masks, f"m{i:05d}.png")
                  for i in range(P11_MASKS)}

    def fs_rows(root, keep=lambda row: True):
        return {k: v for k, v in testing.fs_match_rows(root, key="image")
                .items() if k[0] in mask_files and keep(v)}

    def db_rows(keep=lambda row: True):
        return {k: v for k, v in testing.store_match_rows(
            store, key="image").items() if keep(v)}

    # (b) the search from the store into the store: with phase 3's flags
    # (K1-K4) = phase 3's matches of these masks, then with phase 4's
    # (--pctPositivePixels 0: every pair above 0, no emit top-k) = phase
    # 4's search, upserted over the first run's rows, which keep their ids
    search = ["colorDepthSearch", "-m", f"masks:0:{P11_MASKS}", "-i",
              "targets", "--mips-storage", "DB", "--results-storage", "DB",
              "--device", DEVICE]
    launches = _db_step("(b)", [*search, *FLAGS], store, CDS_KERNELS,
                        count=lambda: len(db_rows()))
    _require_same("phase 11 (b): the stored matches vs phase 3's",
                  db_rows(), fs_rows(os.path.join(work, "out", "masks")))
    first_ids = _match_ids(store)
    cands = _db_step("(b)", [*search, *FLAGS[:-2], "--pctPositivePixels",
                             "0"], store, tuple(CDS_KERNELS)[:3],
                     count=lambda: len(db_rows()))
    for k, v in cands.items():
        launches[k] = launches.get(k, 0) + v
    _require_same("phase 11 (b): the stored matches vs phase 4's search",
                  db_rows(), fs_rows(os.path.join(work, "cds", "masks")))
    ids = _match_ids(store)
    if any(ids.get(k) != v for k, v in first_ids.items()):
        raise AssertionError("phase 11 (b): the second search changed the "
                             "ids of the first one's matches")

    # (c) the shape pass through the device store = phase 4's store run
    os.environ["CDS_SHAPE_STORE_DEVICE"] = "1"
    try:
        gs = _db_step("(c)", [
            "gradientScores", "--matches", f"masks:0:{P11_MASKS}",
            "--results-storage", "DB", "--maskThreshold", "20",
            "--mirrorMask", "--device", DEVICE, "--packed-variants-store",
            os.path.join(work, "store"), "--processing-tag", P11_TAG],
            store, GS_KERNELS, count=lambda: len(db_rows(
                lambda r: "gradientAreaGap" in r)))
    finally:
        del os.environ["CDS_SHAPE_STORE_DEVICE"]
    for k, v in gs.items():
        launches[k] = launches.get(k, 0) + v
    scored = db_rows(lambda r: "gradientAreaGap" in r)
    _require_same("phase 11 (c): the scored matches vs phase 4's store run",
                  scored, fs_rows(os.path.join(work, "gs_store", "masks"),
                                  lambda r: "gradientAreaGap" in r))
    tagged = {n["computeFiles"]["InputColorDepthImage"] for n in neurons()
              if P11_TAG in (n.get("processedTags") or {})
              .get("GradientScore", ())}
    involved = {f for pair in scored for f in pair}
    if tagged != involved:
        raise AssertionError(f"phase 11 (c): {len(tagged)} neurons carry "
                             f"the tag, {len(involved)} were scored")
    print(f"phase 11 (c): the tag {P11_TAG} on the {len(tagged)} mask and "
          "target neurons of the scored matches, and on no other",
          flush=True)

    # (d) normalize = phase 9 (b)'s normalize of phase 4's store run
    _db_step("(d)", ["normalizeGradientScores", "--matches",
                     f"masks:0:{P11_MASKS}", "--results-storage", "DB"],
             store, count=lambda: len(scored))

    def eligible(row):
        return row.get("gradientAreaGap", -1) >= 0

    _require_same("phase 11 (d): the normalized matches vs phase 9 (b)'s "
                  "files", db_rows(eligible),
                  fs_rows(os.path.join(work, "p9", "norm", "masks"),
                          eligible))
    print(f"phase 11: store {os.path.getsize(store)} bytes; launches of "
          f"(b) and (c) {launches} ({card})", flush=True)
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--targets", type=int, default=2048)
    ap.add_argument("--masks", type=int, default=32)
    ap.add_argument("--gs-masks", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if args.targets < T_PAD or args.masks < BATCH \
            or not 4 <= args.gs_masks <= args.masks \
            or args.masks < CLASSIC_MASKS:
        ap.error(f"phase 2 needs at least {T_PAD} targets and {BATCH} "
                 "masks, phase 4 between 4 and --masks masks, phase 6 "
                 f"{CLASSIC_MASKS} masks")

    # phase 0
    t_run = time.time()
    card = card_line()
    print(f"card: {card}", flush=True)
    import torch

    if not torch.cuda.is_available():
        print("CUDA is not available: this smoke run needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
          f"{sys.version.split()[0]}, commit {commit()}", flush=True)
    sys.path.insert(0, REPO)
    os.environ.setdefault("COLORMIPSEARCH_TPU_CACHE",
                          os.path.join(REPO, "build", "cache"))
    import numpy as np

    from colormipsearch_tpu_torch import testing
    from colormipsearch_tpu_torch.io import native_decoder
    from colormipsearch_tpu_torch.kernels import build as kbuild

    device = torch.device(DEVICE)
    phases = {}
    # phase 1
    t0 = time.time()
    so = kbuild.build()
    kbuild.load_library()
    phases["1 build"] = time.time() - t0
    print(f"kernels built in {phases['1 build']:.1f}s "
          f"(nvcc {kbuild.build_seconds:.1f}s): {so}; native decoder "
          f"{'available' if native_decoder.available() else 'missing'}",
          flush=True)
    with open(so + ".log") as f:
        print(f.read(), file=sys.stderr)

    rng = np.random.default_rng(args.seed)
    t0 = time.time()
    lib = testing.synthetic_library(rng, args.targets, args.masks, H, W)
    variants = make_variants(lib, args.seed)
    phases["library"] = time.time() - t0
    print(f"synthetic library: {args.targets} targets with gradient and "
          f"z-gap variants, {args.masks} masks at {H}x{W} in "
          f"{phases['library']:.1f}s", flush=True)
    # phase 2
    t0 = time.time()
    checks, k1 = check_kernels(lib, device)
    checks.update(check_qkey_kernels(device, k1))
    shape_out, shape_ref = check_shape_kernels(lib, variants, device)
    checks.update(shape_out)
    dense_out, dense_ref = check_dense_shape_kernels(lib, variants, device,
                                                     shape_ref)
    checks.update(dense_out)
    checks.update(check_slice_numbers(lib, device, args.seed))
    checks.update(check_classic_kernels(lib, device, k1))
    check_edge_shapes(lib, device)
    phases["2 kernel checks"] = time.time() - t0
    work = os.path.join(REPO, "build", "chip_smoke_data")
    shutil.rmtree(work, ignore_errors=True)
    try:
        t0 = time.time()
        write_library(lib, variants, work)
        phases["library PNGs"] = time.time() - t0
        # phase 3
        t0 = time.time()
        launches = run_search(work, args.masks, args.targets)
        check_against_oracle(lib, work, args.masks, rng)
        phases["3 colorDepthSearch"] = time.time() - t0
        # phase 4
        t0 = time.time()
        gs_launches = run_gradient_scores(work, args.gs_masks)
        launches.update({k: gs_launches[k] for k in GS_KERNELS})
        phases["4 gradientScores"] = time.time() - t0
        # phase 5
        t0 = time.time()
        check_shape_oracle(lib, variants, work, rng)
        phases["5 shape oracle"] = time.time() - t0
        # phase 6
        t0 = time.time()
        classic = run_classic_paths(work, CLASSIC_MASKS)
        launches.update({k: classic[run][k]
                         for k, run in CLASSIC_MAIN_RUN.items()})
        check_negative_query(lib, work, BATCH, rng)
        phases["6 classic paths"] = time.time() - t0
        # phase 7
        t0 = time.time()
        step_launches, _calls, mesh_times = run_mesh_steps(
            lib, device, shape_ref, dense_ref)
        del shape_ref, dense_ref
        engine_launches = run_mesh_engines(lib, work)
        launches.update({k: step_launches[k] + engine_launches[k]
                         for k in MESH_KERNELS})
        phases["7 mesh"] = time.time() - t0
        # phase 8
        t0 = time.time()
        readers = check_pil_free_readers(device, os.path.join(work, "forms"))
        phases["8 readers"] = time.time() - t0
        # phase 9
        t0 = time.time()
        run_file_pipeline(lib, variants, work, rng)
        phases["9 file pipeline"] = time.time() - t0
        print(f"phase 9 seconds: {phases['9 file pipeline']:.1f}",
              flush=True)
        # phase 10
        t0 = time.time()
        run_cross_process(work, card, mesh_times)
        phases["10 cross-process mesh"] = time.time() - t0
        print(f"phase 10 seconds: {phases['10 cross-process mesh']:.1f}",
              flush=True)
        # phase 11
        t0 = time.time()
        db_launches = run_db_pipeline(work, card)
        for k in (*CDS_KERNELS, *GS_KERNELS):
            launches[k] += db_launches[k]
        phases["11 DB pipeline"] = time.time() - t0
        print(f"phase 11 seconds: {phases['11 DB pipeline']:.1f}",
              flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    rounded = {k: round(v, 1) for k, v in phases.items()}
    print(f"phase seconds: {json.dumps(rounded)}, total "
          f"{time.time() - t_run:.1f}s", flush=True)
    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": launches[name],
                **{k: checks[name][k] for k in (
                    "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms")}}
               for name, (src, replaces) in KERNELS.items()]
    print("mesh steps at %d shards of one card, ms (mesh, single-device): "
          "%s" % (MESH_SHARDS, json.dumps(mesh_times)), flush=True)
    print(f"PIL-free readers, seconds for one {H}x{W} image: "
          f"{json.dumps(readers)}", flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
