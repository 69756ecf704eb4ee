#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (colormipsearch_tpu_torch) on one GPU.

    python3 chip_smoke.py [--targets 2048] [--masks 32] [--seed 0]

Phases, in order; any failure raises and the exit code is non-zero:

  0. the card (nvidia-smi name and power limit), torch / CUDA versions
     and the repo commit; exits 1 when CUDA is not available;
  1. builds the four CUDA kernels from kernels/csrc (nvcc, sm_90a);
  2. checks each kernel against its plain PyTorch version on the card at
     the main path's shapes (production image 566 x 1210, a 2,048-column
     target shard, a batch of 8 masks, top-k 256): exact equality, and
     the median time of each;
  3. drives colorDepthSearch end to end through the CLI entry point on a
     synthetic library written as PNGs (default 2,048 targets x 32
     masks, production flags), requires every kernel's launch counter to
     grow during that run, and checks the results against the float64
     PixelMatchOracle.

The line before the last is the kernels' JSON summary; the last line is
{"ok": true, "device": {...}}. All data is generated from --seed under
the checkout's build/ directory and removed afterwards.
"""

from __future__ import annotations

import argparse
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
FLAGS = ["--maskThreshold", "20", "--dataThreshold", "20",
         "--pixColorFluctuation", "1.0", "--xyShift", "2", "--mirrorMask",
         "--pctPositivePixels", "1.0"]
# where each kernel lives and the jitted JAX function it replaces
KERNELS = {
    "scatter_key_planes": (
        "colormipsearch_tpu_torch/kernels/csrc/scatter_keys.cu",
        "colormipsearch_tpu/ops/common.py:211"),
    "expand_union_tables_from_pos": (
        "colormipsearch_tpu_torch/kernels/csrc/expand_tables.cu",
        "colormipsearch_tpu/ops/pixel_match.py:1684"),
    "score_query_batch_union_keys": (
        "colormipsearch_tpu_torch/kernels/csrc/union_score.cu",
        "colormipsearch_tpu/ops/pixel_match.py:1366"),
    "union_keys_topk": (
        "colormipsearch_tpu_torch/kernels/csrc/topk.cu",
        "colormipsearch_tpu/ops/pixel_match.py:1517"),
}


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


def max_abs_err(got, want) -> int:
    """Largest elementwise difference over matching output tuples; raises
    when shapes or dtypes differ."""
    err = 0
    for a, b in zip(got, want):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"output mismatch: {a.shape} {a.dtype} vs "
                                 f"{b.shape} {b.dtype}")
        if a.numel():
            err = max(err, int((a.long() - b.long()).abs().max()))
    return err


def check_kernels(lib, device) -> dict:
    """Phase 2: every kernel against its plain version at the main
    path's shapes. Returns {kernel: (max_abs_err, ms, plain_ms)}."""
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
    stack = np.stack(lib.targets[:T_PAD])
    pos, rgb, cum = common.coo_foreground(stack, 20, T_PAD)
    del stack
    args1 = (torch.from_numpy(pos).to(device),
             torch.from_numpy(rgb).to(device),
             torch.from_numpy(cum).to(device),
             common.rank_lut_tensor(device))
    kw1 = dict(n_px=H * W, t_pad=T_PAD)
    planes = common.scatter_key_planes(*args1, **kw1)
    plain = common.scatter_key_planes_plain(*args1, **kw1)
    out["scatter_key_planes"] = [max_abs_err([planes], [plain])]
    del plain
    out["scatter_key_planes"] += [
        timed(lambda: common.scatter_key_planes(*args1, **kw1), 5),
        timed(lambda: common.scatter_key_planes_plain(*args1, **kw1), 3)]
    print(f"K1 scatter_key_planes: {pos.size} COO elements -> planes "
          f"{tuple(planes.shape)}", flush=True)

    region = label_regions_mask(W, H)
    plans = [pm.build_full_union_key_plan(
        m, 20, mirror=True, xy_shift=2, pix_color_fluctuation=1.0,
        excluded_region=region, light=True) for m in lib.masks[:BATCH]]
    u_pos, mu_pos, q_pos, key_list, u2 = pm.stack_union_pos_args(
        plans, H * W)
    args2 = tuple(convert.as_tensor(a, device)
                  for a in (u_pos, q_pos, key_list)) \
        + convert.interval_tables(pm.interval_table_arrays(0.01), device)
    kw2 = dict(offsets=tuple(shift_offsets(2)), w=W, h=H)
    lo, sp = pm.expand_union_tables_from_pos(*args2, **kw2)
    out["expand_union_tables_from_pos"] = [
        max_abs_err((lo, sp),
                    pm.expand_union_tables_from_pos_plain(*args2, **kw2)),
        timed(lambda: pm.expand_union_tables_from_pos(*args2, **kw2), 10),
        timed(lambda: pm.expand_union_tables_from_pos_plain(*args2, **kw2),
              3)]
    print(f"K2 expand_union_tables_from_pos: lane tables "
          f"{tuple(lo.shape)}, u2 {u2}", flush=True)

    args3 = (planes, args2[0], convert.as_tensor(mu_pos, device), lo, sp,
             u2)
    best, mirrored = pm.score_query_batch_union_keys(*args3)
    out["score_query_batch_union_keys"] = [
        max_abs_err((best, mirrored),
                    pm.score_query_batch_union_keys_plain(*args3)),
        timed(lambda: pm.score_query_batch_union_keys(*args3), 5),
        timed(lambda: pm.score_query_batch_union_keys_plain(*args3), 1)]
    print(f"K3 score_query_batch_union_keys: {BATCH} masks x {T_PAD} "
          f"columns, union {u_pos.shape[2]}, max score "
          f"{int(best.max())}", flush=True)

    out["union_keys_topk"] = [
        max_abs_err(pm.union_keys_topk(best, mirrored, TOP_K),
                    pm.union_keys_topk_plain(best, mirrored, TOP_K)),
        timed(lambda: pm.union_keys_topk(best, mirrored, TOP_K), 20),
        timed(lambda: pm.union_keys_topk_plain(best, mirrored, TOP_K), 20)]
    for name, (err, ms, plain_ms) in out.items():
        print(f"{name}: max_abs_err {err}, kernel {ms:.3f} ms, plain "
              f"{plain_ms:.3f} ms", flush=True)
        if err != 0:
            raise AssertionError(f"{name} disagrees with its plain version")
    del planes
    torch.cuda.synchronize()
    kbuild.reset_launches()
    return out


def run_search(lib, work: str, n_masks: int) -> tuple[dict, float]:
    """Phase 3: colorDepthSearch end to end through the CLI entry point.
    Returns the launch counts of the run and its seconds."""
    import torch

    from colormipsearch_tpu_torch import testing
    from colormipsearch_tpu_torch.cli import main as cli_main
    from colormipsearch_tpu_torch.dataio.json_io import write_neurons_json
    from colormipsearch_tpu_torch.kernels import build as kbuild
    from colormipsearch_tpu_torch.utils.metrics import GLOBAL

    t0 = time.time()
    targets = testing.write_neuron_images(
        os.path.join(work, "targets"), lib.targets, "t")
    masks = testing.write_neuron_images(
        os.path.join(work, "masks"), lib.masks[:n_masks], "m")
    write_neurons_json(targets, os.path.join(work, "targets.json"))
    write_neurons_json(masks, os.path.join(work, "masks.json"))
    print(f"wrote the library as PNGs in {time.time() - t0:.1f}s",
          flush=True)

    GLOBAL.reset()
    torch.cuda.reset_peak_memory_stats()
    kbuild.reset_launches()
    t0 = time.time()
    rc = cli_main.main([
        "colorDepthSearch", "-m", os.path.join(work, "masks.json"),
        "-i", os.path.join(work, "targets.json"), "--device", "cuda",
        "-od", os.path.join(work, "out"), "--perMaskSubdir", "masks",
        "--perTargetSubdir", "targets", *FLAGS])
    seconds = time.time() - t0
    launches = dict(kbuild.launches)
    if rc != 0:
        raise AssertionError(f"colorDepthSearch exited {rc}")
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"the main path never launched {missing}")
    pairs = len(masks) * len(targets)
    from colormipsearch_tpu_torch.cli.commands import stage_seconds

    print(f"colorDepthSearch: {len(masks)} masks x {len(targets)} targets "
          f"in {seconds:.2f}s = {pairs / seconds:.0f} pairs/s end to end, "
          f"{pairs / GLOBAL.get('cds.scoreAllPairs.seconds'):.0f} pairs/s "
          "over scoreAllPairs", flush=True)
    print(f"cds stage seconds: {json.dumps(stage_seconds())}", flush=True)
    print(f"peak torch.cuda.max_memory_allocated: "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    print(f"launches in the run: {launches}", flush=True)
    return launches, seconds


def check_against_oracle(lib, work: str, n_masks: int, rng) -> None:
    """Every emitted match of 4 masks equals the float64 oracle's
    matchingPixels / mirrored; 32 sampled non-emitted pairs fail the emit
    test under the oracle."""
    import numpy as np

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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--targets", type=int, default=2048)
    ap.add_argument("--masks", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if args.targets < T_PAD or args.masks < BATCH:
        ap.error(f"phase 2 needs at least {T_PAD} targets and {BATCH} "
                 "masks")

    # phase 0
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
    import numpy as np

    from colormipsearch_tpu_torch import testing
    from colormipsearch_tpu_torch.kernels import build as kbuild

    device = torch.device("cuda")
    # phase 1
    t0 = time.time()
    so = kbuild.build()
    kbuild.load_library()
    print(f"kernels built in {time.time() - t0:.1f}s "
          f"(nvcc {kbuild.build_seconds:.1f}s): {so}", flush=True)
    with open(so + ".log") as f:
        print(f.read(), file=sys.stderr)

    rng = np.random.default_rng(args.seed)
    t0 = time.time()
    lib = testing.synthetic_library(rng, args.targets, args.masks, H, W)
    print(f"synthetic library: {args.targets} targets, {args.masks} masks "
          f"at {H}x{W} in {time.time() - t0:.1f}s", flush=True)
    # phase 2
    checks = check_kernels(lib, device)
    # phase 3
    work = os.path.join(REPO, "build", "chip_smoke_data")
    shutil.rmtree(work, ignore_errors=True)
    try:
        launches, _ = run_search(lib, work, args.masks)
        check_against_oracle(lib, work, args.masks, rng)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": checks[name][0], "ms": checks[name][1],
                "plain_ms": checks[name][2]}
               for name, (src, replaces) in KERNELS.items()]
    print(f"card: {card}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
