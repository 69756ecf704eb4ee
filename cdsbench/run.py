"""One run of one cell of the port's benchmark.

    python3 -m cdsbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration
(``cdsbench/configs/<config>.json``) and a traffic mix
(``cdsbench/traffic/<traffic>.json``); the per-layer metrics are the
readers ``cdsbench/metrics/<metric>.py``. Set-up makes every input from
the seed, packs the shard's target columns once with the program's own
packer and keeps them on the card, writes the masks as PNG files and
makes one warm call. The engine runs with the configuration's
``engine_settings`` in its environment (the shard width,
``CDS_TARGET_TILE``) and every other knob at its default. The window
is a closed loop of
``CDSearchEngine.find_all_matches_iter`` calls by one caller over the
cell's masks, the target stream of each call being the resident shard
yielded ``shard_yields`` times (the one substitution: the engine's
module-level ``iter_target_shards``). After the window the program's
state is freed and the plain reference (``reference.py``) scores a
seeded sample of the masks against every column; ``check.py`` compares.

The last line of standard output is the result's JSON; the numbers
compared, each beside its limit, are the last lines of standard error.
Without a CUDA card, or with fewer than the cell's chips, it exits 2 and
prints no result; it exits 3, with no result, where the run loaded JAX
or the JAX package, or where a chunk fell back to the dense pull (the
work would then differ from seed to seed).
"""

from __future__ import annotations

import time

_T_START = time.time()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from concurrent.futures import ThreadPoolExecutor  # noqa: E402

import numpy as np  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "colormipsearch_tpu")


def load_cell(name: str) -> tuple:
    """(cell, configuration, traffic, benchmark) of a workload name."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    with open(os.path.join(HERE, "configs", f"{cell['config']}.json")) as f:
        config = json.load(f)
    with open(os.path.join(HERE, "traffic", f"{cell['traffic']}.json")) as f:
        traffic = json.load(f)
    return cell, config, traffic, bench


def forbidden_loaded() -> list:
    """Loaded modules whose top-level name is one the run must not load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN_MODULES))


@dataclasses.dataclass
class Window:
    """What the timed loop saw."""
    seconds: float = 0.0
    chunk_s: list = dataclasses.field(default_factory=list)
    pairs: int = 0
    calls: list = dataclasses.field(default_factory=list)
    masks_prepped: int = 0
    call_s: list = dataclasses.field(default_factory=list)
    # every batch of masks whose K3 ran while the profiler traced
    traced_batches: list = dataclasses.field(default_factory=list)


class Program:
    """The system under test, as the window drives it: the engine with
    the configuration's parameters and engine settings, every other knob
    at its default, and the resident shard behind the engine's target
    stream."""

    def __init__(self, config: dict, traffic: dict, data, mask_paths: list,
                 device):
        import torch

        from cdsbench.data import shard_columns

        from colormipsearch_tpu_torch.engine import cds
        from colormipsearch_tpu_torch.model import (
            ComputeFileType,
            EMNeuron,
            LMNeuron,
        )

        self.cds = cds
        p = config["params"]
        params = cds.CDSParams(
            mask_threshold=p["maskThreshold"],
            data_threshold=p["dataThreshold"],
            pix_color_fluctuation=p["pixColorFluctuation"],
            xy_shift=p["xyShift"], mirror_mask=p["mirrorMask"],
            pct_positive_pixels=p["pctPositivePixels"],
            with_name_label_region=p["withNameLabelRegion"],
            with_color_scale_region=p["withColorScaleRegion"])
        kinds = {"EMNeuron": EMNeuron, "LMNeuron": LMNeuron}
        self.masks = []
        for i, path in enumerate(mask_paths):
            n = kinds[config["mask_neurons"]](mip_id=f"mask-{i:05d}")
            n.set_compute_file(ComputeFileType.InputColorDepthImage, path)
            self.masks.append(n)
        self.targets = [kinds[config["target_neurons"]](
            mip_id=f"target-{c:05d}") for c in range(data.columns)]
        self.mask_index = {id(n): i for i, n in enumerate(self.masks)}
        self.target_index = {id(n): c for c, n in enumerate(self.targets)}
        self.device = torch.device(device)
        self._env = {k: os.environ.get(k)
                     for k in config["engine_settings"]}
        os.environ.update({k: str(v)
                           for k, v in config["engine_settings"].items()})
        self.engine = cds.CDSearchEngine(params, device=self.device,
                                         use_mesh=False)

        class ResidentShard(cds.TargetShard):
            """The shard stays packed across the engine's release()."""

            def release(self) -> None:
                pass

        width = shard_columns(config)
        planes = pack_resident(data, width, p["dataThreshold"], self.device)
        self.shard = ResidentShard(
            self.targets, (data.height, data.width), planes, self.device,
            kind="keys", packed_threshold=p["dataThreshold"], t_pad=width)
        self.yields = traffic["shard_yields"]
        self._saved = cds.iter_target_shards
        cds.iter_target_shards = self._stream

    def _stream(self, targets, *, device, pack_threshold, tile_size,
                plane_kind):
        """The engine's target stream: the resident shard, `yields`
        times. Refuses a request that the resident shard does not
        answer as the engine's own stream would."""
        import torch

        want = (plane_kind, pack_threshold, int(tile_size),
                torch.device(device), len(targets))
        have = ("keys", self.shard.packed_threshold, self.shard.t_pad,
                self.device, self.shard.count)
        if want != have:
            raise ValueError(
                "the engine asks for (planes, threshold, shard width, "
                f"device, targets) {want}; the resident shard holds "
                f"{have}")
        for _ in range(self.yields):
            yield self.shard

    def calls(self):
        """A fresh streaming call over the cell's masks."""
        return self.engine.find_all_matches_iter(self.masks, self.targets)

    def answers(self, chunk) -> np.ndarray:
        """(mask, column, matching pixels, mirrored) of a chunk."""
        return np.array([(self.mask_index[id(m.mask_image)],
                          self.target_index[id(m.matched_image)],
                          m.matching_pixels, m.mirrored) for m in chunk],
                        np.int64).reshape(-1, 4)

    def close(self) -> None:
        self.cds.iter_target_shards = self._saved
        for k, v in self._env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        self.shard.planes = None
        self.engine = None


def pack_resident(data, t_pad: int, threshold: int, device):
    """The shard's key planes, packed by the program's K1
    (``ops/common.scatter_key_planes``) from COO elements that are made
    on the device: each column's foreground (every pixel with a channel
    above `threshold`) in rising position, column after column, as the
    program's host select (``coo_foreground``) lists a stack of the same
    columns. Equal to ``engine/cds._pack_target_stack`` of that stack
    (cdsbench/tests/test_cdsbench_pack.py), without the host stack."""
    import torch

    from colormipsearch_tpu_torch.ops import common

    h, w = data.height, data.width
    bases = torch.from_numpy(data.bases).to(device)
    n_b = bases.shape[0]
    fg = (bases > threshold).any(dim=-1).reshape(n_b, -1)
    n_fg = int(fg[0].sum())
    if not bool((fg.sum(dim=1) == n_fg).all()):
        raise ValueError("the targets' foreground counts differ")
    at = torch.nonzero(fg)
    base_pos = at[:, 1].reshape(n_b, n_fg)
    base_rgb = bases.reshape(n_b, -1, 3)[at[:, 0], at[:, 1]].reshape(
        n_b, n_fg, 3)
    del at, fg, bases
    n_c = data.columns
    pos = torch.empty(n_c * n_fg, dtype=torch.int32, device=device)
    rgb = torch.empty((n_c * n_fg, 3), dtype=torch.uint8, device=device)
    step = 1024
    for c0 in range(0, n_c, step):
        cols = slice(c0, min(c0 + step, n_c))
        b = torch.from_numpy(data.col_base[cols]).to(device)
        flip = torch.from_numpy(data.col_flip[cols]).to(device).view(-1, 1)
        roll = torch.from_numpy(data.col_roll[cols]).to(device)
        y, x = base_pos[b] // w, base_pos[b] % w
        x = torch.where(flip, w - 1 - x, x)
        flat = ((y + roll[:, :1]) % h) * w + (x + roll[:, 1:]) % w
        flat, order = torch.sort(flat, dim=1)
        out = slice(c0 * n_fg, cols.stop * n_fg)
        pos[out] = flat.reshape(-1).to(torch.int32)
        rgb[out] = torch.gather(
            base_rgb[b], 1, order.unsqueeze(-1).expand(-1, -1, 3)
        ).reshape(-1, 3)
    cum = torch.full((t_pad,), n_c * n_fg, dtype=torch.int64, device=device)
    cum[:n_c] = torch.arange(1, n_c + 1, device=device) * n_fg
    planes = common.scatter_key_planes(
        pos, rgb, cum, common.rank_lut_tensor(device), n_px=h * w,
        t_pad=t_pad)
    if device.type == "cuda":
        torch.cuda.synchronize()
    return planes


def _counter(name: str) -> float:
    from colormipsearch_tpu_torch.utils.metrics import GLOBAL
    return GLOBAL.get(name)


COUNTERS = ("cds.prepMasks.seconds", "cds.emit.seconds",
            "cds.planArgs.seconds", "cds.emitSelect.count",
            "cds.emitSelectFallback.count")


def drive_window(program: Program, seconds: float, *, profiler=None,
                 masks_per_call: int) -> tuple:
    """The closed loop: one call after another until `seconds` have
    passed. A chunk counts when it is yielded inside the window; the
    call running at the window's end is closed there."""
    w = Window()
    before = {k: _counter(k) for k in COUNTERS}
    prep_seen = before["cds.prepMasks.seconds"]
    ctx = profiler if profiler is not None else contextlib.nullcontext()
    with ctx:
        t0 = time.time()
        end = t0 + seconds
        over = False
        while not over:
            gen = program.calls()
            answers = []
            t_prev = t_call = time.time()
            for chunk in gen:
                t = time.time()
                got = program.answers(chunk)
                if profiler is not None:
                    w.traced_batches.append(np.unique(got[:, 0]))
                if t > end:
                    over = True
                    gen.close()
                    break
                w.chunk_s.append(t - t_prev)
                w.pairs += len(np.unique(got[:, 0])) * program.shard.count
                answers.append(got)
                prep = _counter("cds.prepMasks.seconds")
                if prep != prep_seen:
                    prep_seen = prep
                    w.masks_prepped += masks_per_call
                t_prev = t
            w.calls.append((np.concatenate(answers) if answers
                            else np.zeros((0, 4), np.int64),
                            program.yields, not over))
            if not over:
                w.call_s.append(time.time() - t_call)
            if time.time() > end:
                over = True
        w.seconds = seconds
    after = {k: _counter(k) for k in COUNTERS}
    return w, {k: after[k] - before[k] for k in COUNTERS}


def warm_call(program: Program, yields: int) -> tuple:
    """One call of `yields` shard yields, consumed whole."""
    saved, program.yields = program.yields, yields
    try:
        answers = [program.answers(c) for c in program.calls()]
    finally:
        program.yields = saved
    return (np.concatenate(answers) if answers
            else np.zeros((0, 4), np.int64), yields, True)


def load_metric(name: str):
    spec = importlib.util.spec_from_file_location(
        f"cdsbench_metric_{name.replace('.', '_')}",
        os.path.join(HERE, "metrics", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
            else "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def run_cell(cell: dict, config: dict, traffic: dict, bench: dict, *,
             seed: int, seconds: float, trace: bool, device: str,
             t_start: float) -> dict:
    """One run; returns the result (its numbers compared included)."""
    import torch

    from cdsbench import check, data as D, reference as R, roofline
    from cdsbench import trace as T

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats()
    phases = {"start": time.time() - t_start}
    data = D.make_cell_data(seed, config, traffic)
    phases["data"] = time.time() - t_start
    tmp = tempfile.mkdtemp(prefix="cdsbench-masks-")
    program = None
    try:
        paths = [os.path.join(tmp, f"mask-{i:05d}.png")
                 for i in range(len(data.masks))]

        def write(i):
            with open(paths[i], "wb") as f:
                f.write(D.encode_png(data.masks[i]))

        with ThreadPoolExecutor(max_workers=8) as pool:
            list(pool.map(write, range(len(paths))))
        program = Program(config, traffic, data, paths, dev)
        phases["packed"] = time.time() - t_start
        fallbacks = _counter("cds.emitSelectFallback.count")
        warm = [warm_call(program, traffic["warm_yields"])]
        if cuda:
            torch.cuda.synchronize()
        setup_s = time.time() - t_start
        phases["warm"] = setup_s

        profiler = None
        if trace:
            acts = [torch.profiler.ProfilerActivity.CUDA] if cuda \
                else [torch.profiler.ProfilerActivity.CPU]
            profiler = torch.profiler.profile(activities=acts)
        window, counters = drive_window(
            program, seconds, profiler=profiler,
            masks_per_call=len(data.masks))
        if cuda:
            torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        fallbacks = _counter("cds.emitSelectFallback.count") - fallbacks
    finally:
        if program is not None:
            program.close()
        program = None
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # the reference, once the program's state is freed
    p = config["params"]
    sample = sorted(np.random.default_rng([seed, 7]).choice(
        len(data.masks), traffic["check_masks"], replace=False).tolist())
    ref = R.Reference(data, p, dev)
    expected = {}
    chance = []
    for m in sample:
        q = ref.query(data.masks[m])
        best, mirrored = (x.cpu().numpy() for x in ref.score(q))
        expected[m] = check.emitted(best, mirrored, q.size,
                                    p["pctPositivePixels"])
        others = np.delete(best, data.planted[m])
        chance.append(float(others.max(initial=0)) / q.size * 100)
    del ref
    if cuda:
        torch.cuda.empty_cache()
    calls = warm + window.calls
    bad = check.mismatches(calls, expected)
    planted = sum(len(x) for x in data.planted)
    complete = [a for a, _y, done in window.calls if done]
    emitted = sorted({len(a) for a in complete})
    work = {
        "masks_per_call": len(data.masks),
        "query_pixels_per_mask": sorted({int(np.count_nonzero(
            m.reshape(-1, 3).max(axis=1))) for m in data.masks}),
        "target_columns": data.columns,
        "shard_yields": traffic["shard_yields"],
        "pairs_per_call": len(data.masks) * data.columns
        * traffic["shard_yields"],
        "planted_per_call": planted * traffic["shard_yields"],
        "emitted_per_complete_call": emitted,
        "complete_calls": len(complete),
        "chunks": len(window.chunk_s),
        "emit_select_chunks": int(counters["cds.emitSelect.count"]),
        "emit_select_fallbacks": int(fallbacks),
        "sampled_masks": len(sample),
        "chance_max_pct": max(chance, default=0.0),
        "setup_phases_s": phases,
        "complete_call_s": window.call_s,
    }
    checks = {"mismatched_matches": {"value": bad, "limit": 0}}
    correct = bad == 0

    if not trace:
        metrics = {
            "cds_pairs_per_s": {"value": window.pairs / window.seconds,
                                "unit": "pairs/s"},
            "cds_chunk_ms_p95": {
                "value": float(np.percentile(window.chunk_s, 95)) * 1e3
                if window.chunk_s else None, "unit": "ms"},
            "peak_device_gib": {"value": peak / 2 ** 30, "unit": "GiB"},
            "setup_s": {"value": setup_s, "unit": "s"},
        }
        summary = None
    else:
        events = T.device_events(profiler) if cuda else []
        summary = T.summarise(events, window.seconds)
        tests = len(R.shift_offsets(p["xyShift"])) \
            * (2 if p["mirrorMask"] else 1)
        queries = {}
        least = 0.0
        for batch in window.traced_batches:
            key = tuple(batch.tolist())
            if key not in queries:
                qs = [R.Query(data.masks[m], p["maskThreshold"],
                              D.label_regions(data.height, data.width,
                                              p["withNameLabelRegion"],
                                              p["withColorScaleRegion"]),
                              p["xyShift"], p["mirrorMask"]) for m in key]
                rows = np.unique(np.concatenate([q.rows() for q in qs]))
                n_bytes, ops = roofline.k3_work(
                    [q.size for q in qs], tests, rows.size, data.columns)
                queries[key] = roofline.bound(n_bytes, ops)["seconds"]
            least += queries[key]
        ctx = {"counters": counters, "chunks": len(window.chunk_s),
               "masks_prepped": window.masks_prepped,
               "window_s": window.seconds, "busy_s": summary["busy_s"],
               "kernel_s": summary["by_name"], "k3_least_s": least}
        metrics = {}
        for m in bench["per_layer"]:
            value = load_metric(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    result = {
        "correct": bool(correct),
        "attempted": len(window.chunk_s),
        "failed": 0 if correct else bad,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
            "count": int(cell["chips"]),
            "memory_peak_bytes": int(peak),
        },
        "work": work,
    }
    if summary is not None:
        result["device"]["busy_s"] = summary["busy_s"]
        result["device"]["window_s"] = window.seconds
        result["device"]["power_limit"] = power_limit() if cuda else None
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
        work["device_op_launches"] = summary["counts"]
    result["checks"] = checks
    return result


def refusal(result: dict, forbidden: list) -> str | None:
    """Why a finished run prints no result: it loaded JAX or the JAX
    package, or a chunk fell back to the dense pull and the host emit,
    which every seed's traffic is made to avoid (the same work for every
    seed). None for a run that may print its result."""
    if forbidden:
        return f"the run loaded {', '.join(forbidden)}"
    n = result["work"]["emit_select_fallbacks"]
    if n:
        return (f"{n} chunk(s) fell back to the dense pull "
                "(cds.emitSelectFallback.count); the work is not the "
                "cell's")
    return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell, config, traffic, bench = load_cell(args.workload)
    # kernel caches at fixed paths inside the checkout
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build",
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
    import torch

    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < int(cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " visible", file=sys.stderr)
        return 2
    result = run_cell(cell, config, traffic, bench, seed=args.seed,
                      seconds=args.seconds, trace=bool(args.trace),
                      device="cuda", t_start=_T_START)
    print("work " + json.dumps(result["work"]), file=sys.stderr)
    why = refusal(result, forbidden_loaded())
    if why:
        print(why, file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        limit = " ".join(f"{k}={v}" for k, v in c.items() if k != "value")
        print(f"check {name}={c['value']} {limit}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
