"""Peak-memory check of colorDepthSearch's streamed result writes.

The engine streams its matches (`find_all_matches_iter`) and the CLI
writes them every `--write-batch-size` matches instead of holding the
whole match set. This check runs the port's colorDepthSearch CLI in two
subprocesses side by side, on one synthetic workload where every pair
matches (n_masks copies of one mask against n_targets rolled copies of
it): accumulate-all (`--write-batch-size 2^30`) and streaming (1,024),
each sampling its own RSS. Both must write
exactly masks x targets matches, and streaming must save at least
MIN_SAVED_BYTES_PER_MATCH bytes of peak RSS a match. A failed check
exits 1.

    python -m colormipsearch_tpu_torch.scripts.streaming_rss_check \\
        [--device cuda|cpu] [--targets 16384] [--masks 64]
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

H, W = 64, 96
ACCUMULATE_ALL = 1 << 30
STREAMING = 1024
# the JAX package's check asks for 50 MB saved at 1M matches; the same
# rule a match
MIN_SAVED_BYTES_PER_MATCH = 50


def synthesize(root: str, n_targets: int,
               n_masks: int = 1) -> tuple[str, str]:
    """n_masks copies of one mask + n_targets rolled targets (every
    pair matches, so the match count is n_masks * n_targets), written
    as PNGs; returns the masks' and the targets' neuron JSON files."""
    from colormipsearch_tpu_torch.io.png import encode_png

    rng = np.random.default_rng(0)
    img = np.zeros((H, W, 3), np.uint8)
    ys, xs = rng.integers(0, H, 400), rng.integers(0, W, 400)
    img[ys, xs] = rng.integers(30, 256, (400, 3))

    lib = os.path.join(root, "lib")
    os.makedirs(lib)
    mask_png = encode_png(img)
    for j in range(n_masks):
        with open(os.path.join(lib, f"mask{j:03d}_CDM.png"), "wb") as f:
            f.write(mask_png)
    # roll per target: same density, every pair still scores > 0
    rolled = [encode_png(np.roll(img, k, axis=1)) for k in range(7)]
    for i in range(n_targets):
        with open(os.path.join(lib, f"t{i:05d}_CDM.png"), "wb") as f:
            f.write(rolled[i % 7])

    def neuron(name):
        return {"mipId": name, "publishedName": name, "libraryName": "rss",
                "alignmentSpace": "JRC2018_Unisex_20x_HR",
                "computeFiles": {"InputColorDepthImage":
                                 os.path.join(lib, f"{name}_CDM.png"),
                                 "SourceColorDepthImage":
                                 os.path.join(lib, f"{name}_CDM.png")}}

    masks = os.path.join(root, "masks.json")
    targets = os.path.join(root, "targets.json")
    with open(masks, "w") as f:
        json.dump([neuron(f"mask{j:03d}") for j in range(n_masks)], f)
    with open(targets, "w") as f:
        json.dump([neuron(f"t{i:05d}") for i in range(n_targets)], f)
    return masks, targets


def run_search(root: str, masks: str, targets: str, batch_size: int,
               device: str, *, trace_python: bool = False) -> dict:
    """One colorDepthSearch CLI run in a subprocess: {"rss_bytes": its
    peak RSS (VmRSS sampled every 10 ms), "matches": rows written, "seconds": the search's wall time} and,
    with trace_python, "traced_peak": tracemalloc's peak over the search
    (Python allocations only; tracing slows the run)."""
    out = os.path.join(root, f"res_{batch_size}")
    base = ["colorDepthSearch", "-m", masks, "-i", targets,
            "--maskThreshold", "20", "--dataThreshold", "20",
            "--pixColorFluctuation", "1.0", "--xyShift", "2",
            "--mirrorMask", "--pctPositivePixels", "0",
            # the default label regions cover all of a 64x96 image
            # (x < 330 / y < 100: production CDM sizes)
            "--no-name-labels", "--no-colormap-labels",
            "--write-batch-size", str(batch_size), "--device", device,
            "--perMaskSubdir", "masks"]
    argv = base + ["-od", out]
    # a one-pair run first builds the process's cached tables (the
    # key-interval table's bisection), so the traced peak is the
    # search's own
    warm = base + ["-od", out + "_warm", "--masks-length", "1",
                   "--targets-length", "1"]
    # the peak RSS is sampled from VmRSS every 10 ms: the card hosts'
    # /proc has no VmHWM, and ru_maxrss keeps the parent's peak across
    # fork and exec
    code = (
        "import glob, json, sys, threading, time, tracemalloc\n"
        "peak = [0]\n"
        "def sample():\n"
        "    while True:\n"
        "        with open('/proc/self/status') as f:\n"
        "            rss = next(int(line.split()[1]) for line in f\n"
        "                       if line.startswith('VmRSS:')) * 1024\n"
        "        peak[0] = max(peak[0], rss)\n"
        "        time.sleep(0.01)\n"
        "threading.Thread(target=sample, daemon=True).start()\n"
        "from colormipsearch_tpu_torch.cli.main import main\n"
        f"if main({warm!r}) != 0:\n"
        "    sys.exit('the one-pair run failed')\n"
        f"trace = {trace_python!r}\n"
        "if trace:\n"
        "    tracemalloc.start()\n"
        "t0 = time.time()\n"
        f"rc = main({argv!r})\n"
        "seconds = time.time() - t0\n"
        "traced = tracemalloc.get_traced_memory()[1] if trace else None\n"
        "if rc != 0:\n"
        "    sys.exit(rc)\n"
        "time.sleep(0.02)\n"
        f"n = sum(len(json.load(open(f))['results']) "
        f"for f in glob.glob({out!r} + '/masks/*.json'))\n"
        "print(json.dumps({'rss_bytes': peak[0], 'matches': n, "
        "'seconds': seconds, 'traced_peak': traced}))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=1800)
    if r.returncode != 0:
        raise RuntimeError(f"colorDepthSearch --write-batch-size "
                           f"{batch_size} exited {r.returncode}:\n"
                           + r.stderr[-2000:])
    return json.loads(r.stdout.strip().splitlines()[-1])


def run_both(root: str, masks: str, targets: str, device: str, *,
             trace_python: bool = False) -> tuple[dict, dict]:
    """The accumulate-all and the streaming run of one workload, side by
    side (each process's peak is its own). Only the flush cadence
    differs, so the decoded stacks and planes cancel and the difference
    isolates the accumulated match entities."""
    with concurrent.futures.ThreadPoolExecutor(max_workers=2) as pool:
        futs = [pool.submit(run_search, root, masks, targets, b, device,
                            trace_python=trace_python)
                for b in (ACCUMULATE_ALL, STREAMING)]
        return futs[0].result(), futs[1].result()


def check(root: str, n_targets: int, n_masks: int,
          device: str) -> list[str]:
    """Both runs on one workload written under `root`; returns the
    failed checks (none when the streamed writes hold their bound) after
    printing both runs."""
    masks, targets = synthesize(root, n_targets, n_masks)
    acc, streamed = run_both(root, masks, targets, device)
    print(f"accumulate-all: peak RSS {acc['rss_bytes']} B, "
          f"{acc['matches']} matches in {acc['seconds']:.2f}s", flush=True)
    print(f"streaming ({STREAMING} a batch): peak RSS "
          f"{streamed['rss_bytes']} B, {streamed['matches']} matches in "
          f"{streamed['seconds']:.2f}s", flush=True)
    expected = n_targets * n_masks
    saved = acc["rss_bytes"] - streamed["rss_bytes"]
    print(f"streaming saves {saved} B on {expected} matches "
          f"({saved / expected:.1f} B a match)", flush=True)
    failed = []
    if acc["matches"] != expected or streamed["matches"] != expected:
        failed.append(f"matches {acc['matches']} (accumulate-all) and "
                      f"{streamed['matches']} (streaming), expected "
                      f"{expected}")
    if saved < MIN_SAVED_BYTES_PER_MATCH * expected:
        failed.append(f"streaming saved {saved} B, under "
                      f"{MIN_SAVED_BYTES_PER_MATCH} B x {expected} matches")
    return failed


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0])
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--targets", type=int, default=16384)
    p.add_argument("--masks", type=int, default=64)
    args = p.parse_args(argv)
    with tempfile.TemporaryDirectory() as root:
        failed = check(root, args.targets, args.masks, args.device)
    for f in failed:
        print(f"FAILED: {f}", file=sys.stderr)
    if failed:
        return 1
    print("STREAMING RSS OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
