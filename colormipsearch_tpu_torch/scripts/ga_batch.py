"""Batch launcher for the gradient-score (shape) rescoring pass of the
port's CLI.

Equivalent of the reference's submitGABatch.sh / submitGAJob.sh
(colormipsearch-tools/src/main/scripts, cdsparams.sh:56-66): the
per-mask CDS result files are partitioned into jobs of
MASK_FILES_PER_JOB each; every job runs
`gradientScores --matches <its files> --device D`.

Modes mirror cds_batch:
  --print     emit command lines (feed to a scheduler)
  --run       run jobs sequentially in this process
  --job N     run only 1-based job N (job-array style)

Each line runs `colormipsearch_tpu_torch.cli.main` on --device (cuda by
default). A box with several cards runs one job a card: start each job
with its own CUDA_VISIBLE_DEVICES=<card index>.

    python -m colormipsearch_tpu_torch.scripts.ga_batch --matches-dir \\
        cds/masks --mask-files-per-job 200 -od out --print -- <flags>
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

from colormipsearch_tpu_torch.scripts.cds_batch import CLI, forwarded


def build_jobs(files: list[str], per_job: int) -> list[list[str]]:
    return [files[i:i + per_job] for i in range(0, len(files), per_job)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--matches-dir", required=True,
                   help="directory of per-mask CDS result files")
    p.add_argument("--mask-files-per-job", type=int, default=200,
                   help="~100-200 mask files/job in the reference "
                        "(cdsparams.sh:56-66)")
    p.add_argument("--first-job", type=int, default=1)
    p.add_argument("--last-job", type=int, default=-1)
    p.add_argument("--job", type=int, default=None)
    p.add_argument("--print", dest="print_only", action="store_true")
    p.add_argument("--run", action="store_true")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="the CLI's --device on every line (default "
                        "cuda); with several cards run one job a card, "
                        "each under its own CUDA_VISIBLE_DEVICES")
    p.add_argument("-od", "--outputDir", required=True)
    p.add_argument("rest", nargs=argparse.REMAINDER,
                   help="extra args passed to gradientScores (prefix "
                        "with --)")
    args = p.parse_args(argv)

    files = sorted(str(f) for f in Path(args.matches_dir).glob("*.json"))
    jobs = build_jobs(files, args.mask_files_per_job)
    last = args.last_job if args.last_job > 0 else len(jobs)
    selected = range(args.first_job, last + 1)
    if args.job is not None:
        selected = [args.job]
    # job indices are 1-based (like the reference's LSF job arrays);
    # reject out-of-range instead of letting 0 wrap to the last job
    bad = [j for j in selected if not 1 <= j <= len(jobs)]
    if bad:
        p.error(f"job index out of range 1..{len(jobs)}: {bad[:3]}")

    extra = forwarded(p, args.rest)
    cmds = []
    for j in selected:
        cmd = [sys.executable, "-m", CLI,
               "gradientScores", "--matches"] + jobs[j - 1] + \
              ["-od", args.outputDir, "--device", args.device] + extra
        cmds.append(cmd)

    if args.print_only or not args.run:
        for c in cmds:
            print(" ".join(c))
        print(json.dumps({"total_jobs": len(jobs),
                          "total_mask_files": len(files)}),
              file=sys.stderr)
        return 0
    for c in cmds:
        print("+", " ".join(c), file=sys.stderr)
        r = subprocess.run(c)
        if r.returncode != 0:
            return r.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
