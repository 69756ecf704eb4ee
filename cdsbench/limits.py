"""The readings that the limit of ``mismatched_matches`` is set from.

    python3 -m cdsbench.limits --workload <cell> --seeds 1,2,3 \\
        --control-seeds 1,2,3 [--seconds 10]

For each seed of ``--seeds``, one run of the cell as the benchmark runs
it (a shorter window), in this one process: its ``mismatched_matches``
is a lower reading. For each seed of ``--control-seeds``, the control:
the reference put in the program's place, computed in float32, the
precision below the float64 that the configuration's scores are stated
in; its emitted matches of the sampled masks, as one call of one yield,
compared with the float64 reference's by ``check.mismatches``: an upper
reading. One JSON line a reading. Not run by the benchmark's own runs.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def control_reading(config: dict, traffic: dict, seed: int, device,
                    low_dtype) -> dict:
    """mismatched_matches of the reference computed in `low_dtype` in
    the program's place, on the cell's own data and sample."""
    import torch

    from cdsbench import check, data as D, reference as R

    p = config["params"]
    data = D.make_cell_data(seed, config, traffic)
    sample = sorted(np.random.default_rng([seed, 7]).choice(
        len(data.masks), traffic["check_masks"], replace=False).tolist())
    answers = {}
    for dtype in (torch.float64, low_dtype):
        ref = R.Reference(data, p, device, dtype=dtype)
        answers[dtype] = {}
        for m in sample:
            q = ref.query(data.masks[m])
            best, mirrored = (x.cpu().numpy() for x in ref.score(q))
            answers[dtype][m] = check.emitted(best, mirrored, q.size,
                                              p["pctPositivePixels"])
        del ref
        if device.type == "cuda":
            torch.cuda.empty_cache()
    rows = [(m, c, px, mi) for m, got in answers[low_dtype].items()
            for c, (px, mi) in got.items()]
    low = np.array(rows, np.int64).reshape(-1, 4)
    return {"seed": seed, "control": str(low_dtype),
            "mismatched_matches": check.mismatches(
                [(low, 1, True)], answers[torch.float64]),
            "due": sum(len(v) for v in answers[torch.float64].values())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    import torch

    from cdsbench import run

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    cell, config, traffic, bench = run.load_cell(args.workload)
    dev = torch.device("cuda")
    for s in filter(None, args.seeds.split(",")):
        t0 = time.time()
        res = run.run_cell(cell, config, traffic, bench, seed=int(s),
                           seconds=args.seconds, trace=False,
                           device="cuda", t_start=t0)
        print(json.dumps({
            "seed": int(s), "program": True, "correct": res["correct"],
            "mismatched_matches": res["checks"]["mismatched_matches"][
                "value"],
            "work": res["work"],
            "cds_pairs_per_s": res["metrics"]["cds_pairs_per_s"]["value"],
            "seconds": time.time() - t0}), flush=True)
    for s in filter(None, args.control_seeds.split(",")):
        t0 = time.time()
        out = control_reading(config, traffic, int(s), dev, torch.float32)
        out["seconds"] = time.time() - t0
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
