#!/usr/bin/env python3
"""Host-stage times of two checkouts of the port on one GPU, interleaved.

    python3 host_stages_ab.py --a DIR --b DIR [--order abba]
                              [--targets 2048] [--masks 32] [--seed 0]

Writes chip_smoke.py's synthetic library (566 x 1210 PNGs from --seed)
once, then runs, in one fresh process per letter of --order (default a,
b, b, a), the colorDepthSearch runs whose host stages chip_smoke.py
phases 3 and 7 report, on that checkout's package: the CLI run of phase 3
(every mask, production flags) and the single-device engine runs of phase
7 with use_key_planes (16 masks) and with the split planes
(CDS_SPLIT_PLANES=1, use_key_planes=False, 8 masks). Each process builds
its checkout's kernels and runs one small search before it times
anything. Prints one JSON line a process with each run's seconds, stage
seconds and a digest of its matches, then one summary line with each
run's seconds per checkout, sorted; exits non-zero when the two
checkouts' matches differ.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
H, W = 566, 1210
DEVICE = "cuda"
FLAGS = ["--maskThreshold", "20", "--dataThreshold", "20",
         "--pixColorFluctuation", "1.0", "--xyShift", "2", "--mirrorMask",
         "--pctPositivePixels", "1.0"]


def child(tree: str, work: str) -> dict:
    """The timed runs on the package of checkout `tree`."""
    sys.path.insert(0, tree)
    import torch

    from colormipsearch_tpu_torch.cli import main as cli_main
    from colormipsearch_tpu_torch.cli.commands import stage_seconds
    from colormipsearch_tpu_torch.dataio.json_io import read_neurons_json
    from colormipsearch_tpu_torch.engine.cds import CDSearchEngine, CDSParams
    from colormipsearch_tpu_torch.io import native_decoder
    from colormipsearch_tpu_torch.kernels import build as kbuild
    from colormipsearch_tpu_torch.utils.metrics import GLOBAL

    kbuild.build()
    kbuild.load_library()
    masks = read_neurons_json(os.path.join(work, "masks.json"))
    targets = read_neurons_json(os.path.join(work, "targets.json"))
    params = CDSParams(mask_threshold=20, data_threshold=20,
                       pix_color_fluctuation=1.0, xy_shift=2,
                       mirror_mask=True, pct_positive_pixels=1.0,
                       with_name_label_region=True,
                       with_color_scale_region=True)

    def engine_run(n_masks, tgts, **kw):
        engine = CDSearchEngine(params, device=DEVICE, use_mesh=False, **kw)
        return sorted((m.mask_image.mip_id, m.matched_image.mip_id,
                       m.matching_pixels, m.mirrored)
                      for m in engine.find_all_matches(masks[:n_masks], tgts))

    def timed(fn):
        GLOBAL.reset()
        t0 = time.time()
        result = fn()
        torch.cuda.synchronize()
        return {"seconds": time.time() - t0, "stages": stage_seconds("cds"),
                "digest": hashlib.sha256(
                    repr(result).encode()).hexdigest()[:16]}

    engine_run(1, targets[:64])                      # warm-up

    def cli_run():
        out = os.path.join(work, "out")
        shutil.rmtree(out, ignore_errors=True)
        rc = cli_main.main([
            "colorDepthSearch", "-m", os.path.join(work, "masks.json"),
            "-i", os.path.join(work, "targets.json"), "--device", DEVICE,
            "-od", out, "--perMaskSubdir", "masks", *FLAGS])
        if rc != 0:
            raise RuntimeError(f"colorDepthSearch exited {rc}")
        root = os.path.join(out, "masks")
        return [(name, open(os.path.join(root, name), "rb").read())
                for name in sorted(os.listdir(root))]

    runs = {"3 colorDepthSearch": timed(cli_run),
            "7 key planes": timed(lambda: engine_run(
                16, targets, use_key_planes=True))}
    os.environ["CDS_SPLIT_PLANES"] = "1"
    runs["7 split"] = timed(lambda: engine_run(8, targets,
                                               use_key_planes=False))
    del os.environ["CDS_SPLIT_PLANES"]
    return {"tree": tree, "native_decoder": native_decoder.available(),
            "runs": runs}


def write_library(work: str, n_targets: int, n_masks: int, seed: int):
    import numpy as np

    sys.path.insert(0, REPO)
    from colormipsearch_tpu_torch import testing
    from colormipsearch_tpu_torch.dataio.json_io import write_neurons_json

    lib = testing.synthetic_library(np.random.default_rng(seed), n_targets,
                                    n_masks, H, W)
    write_neurons_json(testing.write_neuron_images(
        os.path.join(work, "targets"), lib.targets, "t"),
        os.path.join(work, "targets.json"))
    write_neurons_json(testing.write_neuron_images(
        os.path.join(work, "masks"), lib.masks, "m"),
        os.path.join(work, "masks.json"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--a")
    ap.add_argument("--b")
    ap.add_argument("--order", default="abba")
    ap.add_argument("--targets", type=int, default=2048)
    ap.add_argument("--masks", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--work", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print("RESULT " + json.dumps(child(args.child, args.work)),
              flush=True)
        return 0
    if not (args.a and args.b) or set(args.order) - {"a", "b"}:
        ap.error("--a and --b name two checkouts; --order is a string of "
                 "a and b")
    import torch

    if not torch.cuda.is_available():
        print("CUDA is not available", file=sys.stderr)
        return 1
    work = os.path.join(REPO, "build", "host_stages_ab")
    shutil.rmtree(work, ignore_errors=True)
    t0 = time.time()
    write_library(work, args.targets, args.masks, args.seed)
    print(f"library of {args.targets} targets x {args.masks} masks written "
          f"in {time.time() - t0:.1f}s", flush=True)
    trees = {"a": os.path.abspath(args.a), "b": os.path.abspath(args.b)}
    per_tree: dict[str, list] = {"a": [], "b": []}
    try:
        for letter in args.order:
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--child",
                 trees[letter], "--work", work], capture_output=True,
                text=True, timeout=1800, cwd=trees[letter],
                env={**os.environ, "PYTHONPATH": trees[letter]})
            line = [x for x in proc.stdout.splitlines()
                    if x.startswith("RESULT ")]
            if proc.returncode != 0 or not line:
                print(proc.stderr[-4000:], file=sys.stderr)
                raise RuntimeError(f"the run of {letter} exited "
                                   f"{proc.returncode}")
            res = json.loads(line[-1][len("RESULT "):])
            per_tree[letter].append(res)
            print(f"{letter}: {json.dumps(res)}", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    digests = {(name, r["digest"]) for runs in per_tree.values()
               for res in runs for name, r in res["runs"].items()}
    if len(digests) != len(per_tree["a"][0]["runs"]):
        print(f"the checkouts' matches differ: {sorted(digests)}",
              file=sys.stderr)
        return 1
    summary = {}
    for letter, results in per_tree.items():
        for name in results[0]["runs"]:
            secs = sorted(res["runs"][name]["seconds"] for res in results)
            decode = sorted(res["runs"][name]["stages"]["decodeTargets"]
                            for res in results)
            summary.setdefault(name, {})[letter] = {
                "seconds": secs, "decodeTargets": decode}
    print("summary (every process's seconds, sorted): "
          + json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
