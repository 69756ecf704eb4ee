"""Tile-grid launcher for large all-pairs runs of the port's CLI.

Equivalent of the reference's LSF job-array sharding
(colormipsearch-tools/src/main/scripts/submitCDSBatch.sh + cdsparams.sh):
the (masks x targets) matrix is tiled into rectangles of
MASKS_PER_JOB x TARGETS_PER_JOB; each job index maps to one tile and runs
`colorDepthSearch --masks-index ... --targets-index ... --device D`.

Modes:
  --print     emit the command lines (feed to a scheduler of your choice)
  --run       run tiles sequentially in this process
  --job N     run only tile N (use from a job array: one index per task)

Each line runs `colormipsearch_tpu_torch.cli.main` on --device (cuda by
default). A box with several cards runs one job a card: start each job
with its own CUDA_VISIBLE_DEVICES=<card index>.

    python -m colormipsearch_tpu_torch.scripts.cds_batch --masks m.json \\
        --targets t.json --total-masks 10 --total-targets 7 \\
        --masks-per-job 5 --targets-per-job 4 -od out --print -- <flags>
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

CLI = "colormipsearch_tpu_torch.cli.main"
MODULE = "colormipsearch_tpu_torch.scripts.cds_batch"


def tile_count(total, per_job):
    return (total + per_job - 1) // per_job


def merge_tile_outputs(out_dir) -> int:
    """Merge per-tile output subdirs (`<out>/tiles/tile_<j>/...`) into
    `<out>`: grouped files with the same relative path concatenate
    their `results` (deduped on identical rows — a re-run tile scores
    the same pairs to the same rows) and re-sort by the writer's
    ordering (normalizedScore desc, matchingPixels desc).  Without the
    isolation+merge, tiles that split the target axis would rewrite the
    same per-mask file from scratch and the last tile would silently win
    (the reference guards its concurrent-append case with FileLock+retry,
    cmd_v2/ColorMIPSearchResultsWriter.java:32-58, and in production
    ran one tile per matrix, cdsparams.sh:11-12).  Tile dirs are kept
    (re-runnable provenance).  Returns the number of merged files."""
    out_dir = Path(out_dir)
    tiles_dir = out_dir / "tiles"
    if not tiles_dir.is_dir():
        return 0
    by_rel: dict[Path, list[Path]] = {}
    for tile in sorted(tiles_dir.iterdir()):
        if not tile.is_dir():
            continue
        for f in tile.rglob("*.json"):
            by_rel.setdefault(f.relative_to(tile), []).append(f)
    n = 0
    for rel, paths in sorted(by_rel.items()):
        dest = out_dir / rel
        dest.parent.mkdir(parents=True, exist_ok=True)
        if rel.name == "cdsParameters.json" or len(paths) == 1:
            # session records differ only in index args; keep the
            # first (each tile dir retains its own)
            shutil.copyfile(paths[0], dest)
            n += 1
            continue
        seen: set[str] = set()
        results = []
        head = None
        for p in paths:
            with open(p) as f:
                doc = json.load(f)
            if head is None:
                head = doc
            for r in doc.get("results", ()):
                k = json.dumps(r, sort_keys=True)
                if k not in seen:
                    seen.add(k)
                    results.append(r)
        results.sort(key=lambda r: (
            -(r.get("normalizedScore") or 0.0),
            -(r.get("matchingPixels") or 0)))
        doc = {k: v for k, v in head.items() if k != "results"}
        doc["results"] = results
        tmp = str(dest) + f".tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=2)
        os.replace(tmp, dest)
        n += 1
    return n


def build_tiles(n_masks, n_targets, masks_per_job, targets_per_job):
    tiles = []
    for mi in range(tile_count(n_masks, masks_per_job)):
        for ti in range(tile_count(n_targets, targets_per_job)):
            tiles.append((mi * masks_per_job,
                          min(masks_per_job, n_masks - mi * masks_per_job),
                          ti * targets_per_job,
                          min(targets_per_job,
                              n_targets - ti * targets_per_job)))
    return tiles


def forwarded(p: argparse.ArgumentParser, rest: list) -> list:
    """The arguments after `--`, passed on to the CLI; a --device among
    them is refused (the launcher's own --device puts it on every line)."""
    extra = rest[1:] if rest[:1] == ["--"] else rest
    if any(a == "--device" or a.startswith("--device=") for a in extra):
        p.error("--device among the forwarded arguments: give the "
                "launcher's own --device {cuda,cpu} before --")
    return extra


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--masks", help="masks neuron JSON file")
    p.add_argument("--targets")
    p.add_argument("--total-masks", type=int)
    p.add_argument("--total-targets", type=int)
    p.add_argument("--masks-per-job", type=int, default=5000)
    p.add_argument("--targets-per-job", type=int, default=40000)
    p.add_argument("--first-job", type=int, default=1)
    p.add_argument("--last-job", type=int, default=-1)
    p.add_argument("--job", type=int, default=None,
                   help="run only this 1-based tile index")
    p.add_argument("--print", dest="print_only", action="store_true")
    p.add_argument("--run", action="store_true")
    p.add_argument("--merge-only", action="store_true",
                   help="merge existing <outputDir>/tiles/* into "
                        "<outputDir> (after externally-scheduled tiles "
                        "finish) and exit")
    p.add_argument("--no-tile-subdirs", action="store_true",
                   help="write every tile straight into <outputDir> "
                        "(refused for target-split grids: concurrent "
                        "per-mask rewrites silently drop matches)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="the CLI's --device on every line (default "
                        "cuda); with several cards run one job a card, "
                        "each under its own CUDA_VISIBLE_DEVICES")
    p.add_argument("-od", "--outputDir", required=True)
    p.add_argument("rest", nargs=argparse.REMAINDER,
                   help="extra args passed to colorDepthSearch (prefix "
                        "with --)")
    args = p.parse_args(argv)

    if args.merge_only:
        n = merge_tile_outputs(args.outputDir)
        print(json.dumps({"merged_files": n}), file=sys.stderr)
        return 0
    missing = [f for f in ("masks", "targets", "total_masks",
                           "total_targets")
               if getattr(args, f) is None]
    if missing:
        p.error("required (except with --merge-only): "
                + ", ".join("--" + f.replace("_", "-") for f in missing))

    tiles = build_tiles(args.total_masks, args.total_targets,
                        args.masks_per_job, args.targets_per_job)
    last = args.last_job if args.last_job > 0 else len(tiles)
    selected = range(args.first_job, last + 1)
    if args.job is not None:
        selected = [args.job]
    # tile indices are 1-based (like the reference's LSF job arrays);
    # reject out-of-range instead of letting 0 wrap to the last tile
    bad = [j for j in selected if not 1 <= j <= len(tiles)]
    if bad:
        p.error(f"tile index out of range 1..{len(tiles)}: {bad[:3]}")

    extra = forwarded(p, args.rest)
    # tiles sharing one -od clobber each other's grouped files when
    # more than one tile can write the same file name: target-split
    # grids rewrite per-MASK files, mask-split grids rewrite per-TARGET
    # files (if requested).  Isolate each tile in its own subdir and
    # merge afterwards.
    n_t_tiles = tile_count(args.total_targets, args.targets_per_job)
    n_m_tiles = tile_count(args.total_masks, args.masks_per_job)
    needs_isolation = (n_t_tiles > 1
                       or (n_m_tiles > 1
                           and any("perTargetSubdir" in a
                                   for a in extra)))
    if args.no_tile_subdirs and needs_isolation and n_t_tiles > 1:
        p.error("--no-tile-subdirs with a target-split grid: tiles "
                "would rewrite the same per-mask files and the last "
                "tile would silently win; drop --no-tile-subdirs or "
                "use --targets-per-job >= --total-targets")
    isolate = needs_isolation and not args.no_tile_subdirs
    cmds = []
    for j in selected:
        m_off, m_len, t_off, t_len = tiles[j - 1]
        od = (os.path.join(args.outputDir, "tiles", f"tile_{j}")
              if isolate else args.outputDir)
        cmd = [sys.executable, "-m", CLI,
               "colorDepthSearch",
               "-m", args.masks, "-i", args.targets,
               "--masks-index", str(m_off), "--masks-length", str(m_len),
               "--targets-index", str(t_off), "--targets-length",
               str(t_len), "-od", od, "--device", args.device] + extra
        cmds.append(cmd)

    if args.print_only or not args.run:
        for c in cmds:
            print(" ".join(c))
        note = {"total_tiles": len(tiles)}
        if isolate:
            note["merge"] = (f"after all tiles finish: {sys.executable} -m "
                             f"{MODULE} --merge-only -od {args.outputDir}")
        print(json.dumps(note), file=sys.stderr)
        return 0
    for c in cmds:
        print("+", " ".join(c), file=sys.stderr)
        r = subprocess.run(c)
        if r.returncode != 0:
            return r.returncode
    if isolate:
        n = merge_tile_outputs(args.outputDir)
        print(json.dumps({"merged_files": n}), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
