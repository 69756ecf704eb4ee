"""NeuronBridge S3 publish step.

Python twin of the reference's upload script
(colormipsearch-tools/src/main/scripts/upload-data.sh:16-66): after
`exportData` writes the validated metadata tree, this command ships it
to the janelia-neuronbridge data buckets — MIPs (by_line / by_body),
CDS and PPP match tables (per direction), config.json, schemas, and the
current/next version pointers.

Differences from the bash original, by design:
  * dry-run by default (the original ships with ``AWS="echo aws"`` —
    the same posture), printing the copy plan; ``--run`` executes it
    through the configured uploader command (``aws s3 cp`` unless
    overridden with --upload-command).
  * ``--manifest FILE`` writes the full plan as JSON (src, dest,
    recursive, exists, n_files, bytes) so a publish can be reviewed /
    diffed / resumed without egress — this is also what the tests
    drive (no aws/network needed).
  * missing source directories are reported per entry instead of
    silently producing an empty `aws s3 cp`.
"""

from __future__ import annotations

import json
import logging
import os
import shlex
import subprocess
from pathlib import Path

LOG = logging.getLogger(__name__)

# mips-type aliases -> S3 metadata subdir (upload-data.sh:22-33)
_MIPS_DEST = {
    "lmlines": "by_line", "lm_lines": "by_line", "by_line": "by_line",
    "embodies": "by_body", "em_bodies": "by_body", "by_body": "by_body",
}
# matches-type aliases -> (local subdir, S3 metadata subdir)
# (upload-data.sh:42-55)
_MATCH_DIRS = {
    "cdm": ("cdmatches", "cdsresults"),
    "cdmatches": ("cdmatches", "cdsresults"),
    "cds": ("cdmatches", "cdsresults"),
    "cdsresults": ("cdmatches", "cdsresults"),
    "ppp": ("pppmatches", "pppmresults"),
    "pppm": ("pppmatches", "pppmresults"),
    "pppmatches": ("pppmatches", "pppmresults"),
    "pppmresults": ("pppmatches", "pppmresults"),
}


def configure_upload_data(sp):
    sp.add_argument("--local-data-dir", "--localDataDir",
                    dest="localDataDir", required=True,
                    help="root of the exported data tree "
                         "(upload-data.sh LOCAL_DATA_DIR)")
    sp.add_argument("--bucket", default="janelia-neuronbridge-data-devpre",
                    help="destination S3 bucket (upload-data.sh S3_BUCKET)")
    sp.add_argument("--data-version", "--dataVersion", dest="dataVersion",
                    default="v3_0_0",
                    help="S3 data version prefix (S3_DATA_VERSION)")
    sp.add_argument("--mips-regions", nargs="*", default=["brain+vnc"],
                    help="alignment regions whose MIP trees upload "
                         "(upload-data.sh calls uploadMIPS brain+vnc)")
    sp.add_argument("--match-regions", nargs="*",
                    default=["brain", "vnc"],
                    help="regions whose match tables upload")
    sp.add_argument("--mips-types", nargs="*",
                    default=["lmlines", "embodies"],
                    choices=sorted(_MIPS_DEST),
                    help="MIP trees to upload (lmlines -> by_line, "
                         "embodies -> by_body)")
    sp.add_argument("--matches", nargs="*",
                    default=["cds:em-vs-lm", "cds:lm-vs-em",
                             "ppp:em-vs-lm"],
                    help="TYPE:DIRECTION match uploads (the script runs "
                         "cds both ways + ppp em-vs-lm per region)")
    sp.add_argument("--with-config", action="store_true", default=False,
                    help="also upload config.json")
    sp.add_argument("--with-schemas", action="store_true", default=False,
                    help="also upload the schemas tree")
    sp.add_argument("--with-version", action="store_true", default=False,
                    help="also upload current.txt as current.txt AND "
                         "next.txt (uploadVersion)")
    sp.add_argument("--manifest", default=None,
                    help="write the copy plan as JSON to this file")
    sp.add_argument("--run", action="store_true", default=False,
                    help="execute the uploads (default is dry-run, like "
                         "the script's AWS=\"echo aws\")")
    sp.add_argument("--upload-command", default="aws s3 cp",
                    help="command prefix used for each copy")
    sp.add_argument("--mips-dir", default="mips")
    sp.add_argument("--cds-results-dir", default="cdmatches")
    sp.add_argument("--ppp-results-dir", default="pppmatches")


def _dir_stats(path: Path):
    if not path.exists():
        return 0, 0
    if path.is_file():
        return 1, path.stat().st_size
    n = size = 0
    for root, _dirs, files in os.walk(path):
        for f in files:
            n += 1
            try:
                size += os.path.getsize(os.path.join(root, f))
            except OSError:
                pass
    return n, size


def build_upload_plan(args) -> list[dict]:
    """The ordered copy plan of upload-data.sh's main body (:69-80)."""
    root = Path(args.localDataDir)
    prefix = f"s3://{args.bucket}/{args.dataVersion}"
    plan: list[dict] = []

    def entry(src: Path, dest: str, recursive: bool):
        n, size = _dir_stats(src)
        plan.append({
            "src": str(src), "dest": dest, "recursive": recursive,
            "exists": src.exists(), "n_files": n, "bytes": size,
        })

    for region in args.mips_regions:
        for mt in args.mips_types:
            entry(root / region / args.mips_dir / mt,
                  f"{prefix}/metadata/{_MIPS_DEST[mt]}", True)
    for region in args.match_regions:
        for spec in args.matches:
            mtype, _, direction = spec.partition(":")
            if mtype not in _MATCH_DIRS or not direction:
                raise SystemExit(
                    f"bad --matches entry {spec!r} (want TYPE:DIRECTION, "
                    f"types: {sorted(_MATCH_DIRS)})")
            src_sub, dest_sub = _MATCH_DIRS[mtype]
            entry(root / region / src_sub / direction,
                  f"{prefix}/metadata/{dest_sub}", True)
    if args.with_config:
        entry(root / "config.json", f"{prefix}/config.json", False)
    if args.with_schemas:
        entry(root / "schemas", f"{prefix}/schemas", True)
    if args.with_version:
        entry(root / "current.txt",
              f"s3://{args.bucket}/current.txt", False)
        entry(root / "current.txt", f"s3://{args.bucket}/next.txt", False)
    return plan


def cmd_upload_data(args) -> int:
    plan = build_upload_plan(args)
    missing = [e for e in plan if not e["exists"]]
    for e in missing:
        LOG.warning("source missing, skipping: %s", e["src"])
    if args.manifest:
        Path(args.manifest).parent.mkdir(parents=True, exist_ok=True)
        with open(args.manifest, "w") as f:
            json.dump({"bucket": args.bucket,
                       "dataVersion": args.dataVersion,
                       "entries": plan}, f, indent=1)
        LOG.info("wrote manifest with %d entries to %s",
                 len(plan), args.manifest)
    base = shlex.split(args.upload_command)
    rc = 0
    for e in plan:
        if not e["exists"]:
            continue
        cmd = base + [e["src"], e["dest"]] \
            + (["--recursive"] if e["recursive"] else [])
        if not args.run:
            print("DRY-RUN: " + " ".join(shlex.quote(c) for c in cmd))
            continue
        LOG.info("uploading %s (%d files, %.1f MB) -> %s",
                 e["src"], e["n_files"], e["bytes"] / 1e6, e["dest"])
        res = subprocess.run(cmd)
        if res.returncode != 0:
            LOG.error("upload failed (%d): %s", res.returncode,
                      " ".join(cmd))
            rc = res.returncode
    return rc
