"""Start one rank of a mesh across processes (torch.distributed).

The counterpart of the JAX package's scripts/run_multihost.py. Start one
copy a host (or a card), each with its rank; every option is explicit:

    python -m colormipsearch_tpu_torch.parallel.launch \\
        --init-method tcp://HOST:PORT --world-size 2 --rank 0 \\
        --backend nccl --local-devices cuda:0 \\
        -- colorDepthSearch -m masks.json -i targets.json -od out0 ...

``--init-method`` is ``tcp://host:port`` or ``file:///path`` (a file on
a filesystem every rank sees); ``--local-devices`` names this rank's mesh
devices, as many in every rank (a device may repeat). The group's global
mesh orders its shards rank-major (parallel/mesh.py), and the engines
mesh over it by default, so each rank scores its block of the target
columns and writes only the matches of its own columns: give each rank
its own ``-od``; the union of the ranks' result trees is the single
process's.

Everything after ``--`` is forwarded to the port's CLI
(colormipsearch_tpu_torch.cli.main). ``--selftest OUT.json`` instead
runs every sharded step of parallel/mesh.py over the group on seeded
inputs and checks each against the single-device functions
(``selftest``). A rank whose command fails exits non-zero at once, which
fails its peers' collectives (gloo reports the closed connection; any
backend gives up after ``--timeout``); a rank that succeeds then waits
for every other rank to succeed before it exits 0.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

import numpy as np
import torch

from colormipsearch_tpu_torch.parallel import mesh as pmesh

# the selftest's sizes: "small" is the JAX selftest's workload
# (scripts/run_multihost.py:47-48, 161), "production" the production image
# at a 2,048-target shard and a batch of 8 masks
SELFTEST_SIZES = {
    "small": dict(h=40, w=64, n_targets=8, n_masks=2, s_gap=64, n_words=4,
                  s_dense=64, flu=2.0, labels=False, top_k=1, repeats=0),
    "production": dict(h=566, w=1210, n_targets=2048, n_masks=8,
                       s_gap=20480, n_words=5120, s_dense=20480, flu=1.0,
                       labels=True, top_k=256, repeats=3),
}


def selftest_inputs(n_shards: int, size: str = "small") -> dict:
    """The selftest's host inputs (numpy), the same in every rank.

    "small" draws, from default_rng(0), exactly the JAX selftest's
    images (400 random pixels each, masks first) and then its split shape
    planes at its padded width; the dense shape packs are drawn after
    them. "production" takes testing.synthetic_library's targets and
    masks. t_pad is n_targets rounded up to a multiple of n_shards."""
    cfg = SELFTEST_SIZES[size]
    h, w = cfg["h"], cfg["w"]
    n_targets, n_masks = cfg["n_targets"], cfg["n_masks"]
    rng = np.random.default_rng(0)
    if size == "small":
        imgs = np.zeros((n_masks + n_targets, h, w, 3), np.uint8)
        for img in imgs:
            n = 400
            img[rng.integers(0, h, n), rng.integers(0, w, n)] = \
                rng.integers(0, 256, (n, 3))
        masks, targets = imgs[:n_masks], imgs[n_masks:]
    else:
        from colormipsearch_tpu_torch import testing

        lib = testing.synthetic_library(rng, n_targets, n_masks, h, w)
        masks, targets = np.stack(lib.masks), np.stack(lib.targets)
    t_pad = -(-n_targets // n_shards) * n_shards
    s_gap, n_w, s_dense = cfg["s_gap"], cfg["n_words"], cfg["s_dense"]

    def words(shape):
        return rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(
            np.uint32)

    out = dict(masks=masks, targets=targets, t_pad=t_pad,
               t_gap=rng.integers(0, 1 << 25, (2, s_gap, t_pad)).astype(
                   np.uint32),
               q_gap=rng.integers(0, 1 << 11, (2, s_gap)).astype(np.int32),
               t_he=words((2, n_w, t_pad)), q_he=words((2, n_w)))
    out.update(t_dense=words((2, s_dense, t_pad)),
               q_dense=words((2, s_dense)).view(np.int32))
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def selftest(mesh: pmesh.Mesh, out_path: str, size: str = "small") -> int:
    """Every sharded step of parallel/mesh.py over `mesh` (the global mesh
    of the process group) on selftest_inputs, each output made whole in
    every rank (process_allgather; the top-k outputs are already every
    rank's) and checked equal to the port's single-device functions on
    mesh.devices[0]: the dense steps to the function, the top-k steps to
    a per-shard top-k of its scores, each dense output also zero outside
    this rank's columns before the gather. Writes OUT.json (rank, world
    size, global shard count, each step's outputs and check, the global
    maxima, the collective and step counts, the kernel launches, each
    step's milliseconds and the peak device memory) and returns 0 when
    every check holds, else 1."""
    from colormipsearch_tpu_torch import convert
    from colormipsearch_tpu_torch.kernels import build as kbuild
    from colormipsearch_tpu_torch.oracle.pixel import label_regions_mask
    from colormipsearch_tpu_torch.ops import common, pixel_match as pm
    from colormipsearch_tpu_torch.ops import shape_score as ss

    cfg = SELFTEST_SIZES[size]
    t0 = time.time()
    dev = mesh.devices[0]
    inp = selftest_inputs(mesh.size, size)
    h, w, t_pad = cfg["h"], cfg["w"], inp["t_pad"]
    n_targets, n_px = len(inp["targets"]), cfg["h"] * cfg["w"]
    width = t_pad // mesh.size
    k = min(cfg["top_k"], width)
    region = label_regions_mask(w, h) if cfg["labels"] else None

    def plans_of(build, flu):
        kw = dict(mirror=True, xy_shift=2, pix_color_fluctuation=flu,
                  excluded_region=region)
        plans = [build(m, 20, **kw) for m in inp["masks"]]
        if build is pm.build_query_plan:
            q_pad = max(p.positions.shape[1] for p in plans)
            plans = [build(m, 20, pad_to=q_pad, **kw) for m in inp["masks"]]
        return plans

    def stacked(objs, fields):
        return tuple(convert.as_tensor(np.stack([getattr(o, f)
                                                 for o in objs]), dev)
                     for f in fields)

    plans = plans_of(pm.build_query_plan, cfg["flu"])
    pargs = stacked(plans, ("positions", "q_cls", "q_s", "q_p"))
    zkw = dict(ztol_num=plans[0].ztol_num, ztol_den=plans[0].ztol_den,
               n_straight=plans[0].n_straight)
    kargs = stacked([pm.key_plan_from_query_plan(p, n_px, cfg["flu"])
                     for p in plans], ("positions", "lo", "span"))
    rgb = torch.from_numpy(inp["targets"]).to(dev)
    packed = common.pack_target_planes(rgb, t_pad=t_pad)
    folded = common.pack_target_planes(rgb, 20, t_pad=t_pad)
    del rgb
    keys = common.key_planes_from_packed(folded, common.rank_lut_tensor(dev))
    t_sp, t_c8 = common.split_planes_from_packed(folded)
    del folded
    union = {}
    for form, build in (("x", pm.build_union_key_plan),
                        ("full", pm.build_full_union_key_plan)):
        *arrs, u2 = pm.stack_union_plan_args(plans_of(build, cfg["flu"]),
                                             n_px)
        union[form] = (convert.stacked_args(arrs, dev), u2)
    # the qkey wire form exists at a 2-slot tolerance (1.0%)
    qplans = plans_of(pm.build_full_union_key_plan, 1.0)
    u_pos, mu_pos, qidx, key_list, qu2 = pm.stack_union_qkey_args(qplans,
                                                                  n_px)
    qargs = (convert.as_tensor(u_pos, dev), convert.as_tensor(mu_pos, dev),
             convert.qidx(qidx, dev), convert.as_tensor(key_list, dev),
             *convert.interval_tables(pm.interval_table_arrays(0.01), dev))
    shape_in = {name: convert.as_tensor(inp[name], dev)
                for name in ("t_gap", "q_gap", "t_he", "q_he", "t_dense",
                             "q_dense")}
    setup_s = time.time() - t0

    checks, outputs, millis, gmax = {}, {}, {}, {}
    launches = dict.fromkeys(kbuild.launches, 0)
    calls = dict.fromkeys(pmesh.step_calls, 0)
    colls = dict.fromkeys(pmesh.collective_calls, 0)

    def counted(fn):
        """fn() with the launches, step and collective calls it made
        added up (the checks' own launches stay out)."""
        _sync(dev)
        kbuild.reset_launches()
        pmesh.reset_step_calls()
        result = fn()
        _sync(dev)
        for total, now in ((launches, kbuild.launches),
                           (calls, pmesh.step_calls),
                           (colls, pmesh.collective_calls)):
            for key, v in now.items():
                total[key] += v
        return result

    def per_shard_topk(best, mirrored, flags):
        parts = []
        for s in range(mesh.size):
            cols = slice(s * width, (s + 1) * width)
            sk, ik, mk, fk = pm.union_keys_topk(
                best[:, cols].contiguous(), mirrored[:, cols].contiguous(),
                k, flags[:, cols].contiguous())
            parts.append((sk, ik + s * width, mk, fk))
        return tuple(torch.cat([p[i] for p in parts], 1) for i in range(4))

    def same(got, want) -> bool:
        return len(got) == len(want) and all(
            g.shape == x.shape and torch.equal(g.cpu(), x.cpu().to(g.dtype))
            for g, x in zip(got, want))

    local = torch.from_numpy(pmesh.local_target_mask(None, t_pad))

    def whole(dense) -> tuple:
        """The dense outputs gathered to every rank, after checking each
        is zero outside this rank's columns."""
        ok = all(not x.cpu()[..., ~local].any() for x in dense)
        return ok, tuple(pmesh.process_allgather(mesh, x) for x in dense)

    def run(name, step, args, single, top_k=False, extra=()):
        """Drive `step`, check it against `single` (the single-device
        outputs (best, mirrored, flags) or, for the shape steps, their
        three outputs; a dense step's outputs after the global max are
        `extra`), then time it."""
        got = counted(lambda: step(*args))
        if top_k:
            best, mirrored, flags = single
            ok = same(got[:4], per_shard_topk(best, mirrored, flags)) \
                and same(got[4:], (best.max(-1).values,
                                   (flags > 0).sum(-1, dtype=torch.int32)))
            gathered = got
        else:
            ok, dense = whole(got[:3])
            gathered = dense + tuple(got[3:])
            want = tuple(single)
            if len(got) > 3:
                want += (single[0].max(-1).values, *extra)
            ok = ok and same(gathered, want)
        checks[name] = bool(ok)
        outputs[name] = [x.cpu().to(torch.int64).tolist() for x in gathered]
        if len(got) > 3:
            gmax[name] = got[4 if top_k else 3].cpu().reshape(-1).tolist()
        timed(name, step, args)

    def timed(name, step, args):
        """The median wall milliseconds of cfg["repeats"] more calls."""
        times = []
        for _ in range(cfg["repeats"]):
            _sync(dev)
            t1 = time.perf_counter()
            step(*args)
            _sync(dev)
            times.append((time.perf_counter() - t1) * 1e3)
        if times:
            millis[name] = float(np.median(times))

    shards = {name: pmesh.shard_target_planes(mesh, x) for name, x in
              (("packed", packed), ("keys", keys), ("sp", t_sp),
               ("c8", t_c8))}
    for name in ("t_gap", "t_he", "t_dense"):
        shards[name] = pmesh.shard_target_planes(mesh, shape_in[name])

    # the search step (one query: mask 0), dense and with a top-k (its
    # candidates after the dense outputs and the global max)
    single = pm.score_query_batch(packed, *(a[:1] for a in pargs),
                                  target_threshold=20, **zkw)
    sk, ik, _mk, _fk = per_shard_topk(*single)
    for top_k in (0, k):
        run(f"search{'_topk' if top_k else ''}",
            pmesh.make_sharded_search_step(mesh, target_threshold=20,
                                           top_k=top_k, **zkw),
            (shards["packed"], *(a[0] for a in pargs)),
            tuple(x[0] for x in single),
            extra=(sk[0], ik[0]) if top_k else ())

    # the batched pixel-match steps
    single = pm.score_query_batch(packed, *pargs, target_threshold=20, **zkw)
    for top_k in (0, k):
        run(f"batch{'_topk' if top_k else ''}",
            pmesh.make_sharded_batch_step(mesh, target_threshold=20,
                                          top_k=top_k, **zkw),
            (shards["packed"], *pargs), single, bool(top_k))
    run("batch_split",
        pmesh.make_sharded_batch_step_split(mesh, **zkw),
        (shards["sp"], shards["c8"], *pargs),
        pm.score_query_batch_split(t_sp, t_c8, *pargs, **zkw))
    best, mirrored = pm.score_query_batch_keys(
        keys, *kargs, n_straight=plans[0].n_straight)
    for top_k in (0, k):
        run(f"batch_keys{'_topk' if top_k else ''}",
            pmesh.make_sharded_batch_step_keys(
                mesh, n_straight=plans[0].n_straight, top_k=top_k),
            (shards["keys"], *kargs),
            (best, mirrored, torch.zeros_like(best)), bool(top_k))
    for form, (uargs, u2) in union.items():
        best, mirrored = pm.score_query_batch_union_keys(keys, *uargs, u2)
        for top_k in (0, k):
            run(f"batch_union_keys_{form}{'_topk' if top_k else ''}",
                pmesh.make_sharded_batch_step_union_keys(mesh, top_k=top_k,
                                                         u2=u2),
                (shards["keys"], *uargs),
                (best, mirrored, torch.zeros_like(best)), bool(top_k))
    best, mirrored = pm.score_query_batch_union_qkeys(keys, *qargs, qu2)
    for top_k in (0, k):
        run(f"batch_union_qkeys{'_topk' if top_k else ''}",
            pmesh.make_sharded_batch_step_union_qkeys(mesh, top_k=top_k,
                                                      u2=qu2),
            (shards["keys"], *qargs),
            (best, mirrored, torch.zeros_like(best)), bool(top_k))
    del single, best, mirrored

    # the shape steps: dense (row 18b) in both modes, split (K5)
    t_dense, q_dense = shape_in["t_dense"], shape_in["q_dense"]
    run("shape", pmesh.make_sharded_shape_step(mesh),
        (tuple(x[0] for x in shards["t_dense"]), q_dense[0]),
        ss.shape_score_pairs(t_dense[0], q_dense[0]))
    run("shape_both", pmesh.make_sharded_shape_step(mesh, both=True),
        (shards["t_dense"], q_dense),
        ss.shape_score_pairs_both(t_dense, q_dense))
    run("shape_split", pmesh.make_sharded_shape_split_step(mesh),
        (shards["t_gap"], shape_in["q_gap"], shards["t_he"],
         shape_in["q_he"]),
        ss.shape_score_pairs_split(shape_in["t_gap"], shape_in["q_gap"],
                                   shape_in["t_he"], shape_in["q_he"]))

    ok = all(checks.values()) and all(calls.values())
    peak = (torch.cuda.max_memory_allocated(dev) / 2**30
            if dev.type == "cuda" else None)
    doc = {"rank": mesh.rank, "world_size": mesh.world_size,
           "n_global_shards": mesh.size, "backend": mesh.backend,
           "devices": [str(d) for d in mesh.devices], "size": size,
           "n_targets": n_targets, "t_pad": t_pad, "top_k": k, "ok": ok,
           "checks": checks,
           "scores": [row[:n_targets] for row in outputs["batch"][0]],
           "global_max": gmax, "outputs": outputs, "step_calls": calls,
           "collective_calls": colls, "launches": launches, "ms": millis,
           "setup_seconds": setup_s, "seconds": time.time() - t0,
           "peak_gib": peak}
    with open(out_path, "w") as f:
        json.dump(doc, f)
    failed = sorted(n for n, v in checks.items() if not v)
    print(f"[launch] rank {mesh.rank}: selftest ok={ok} over "
          f"{mesh.size} shards; failed {failed}; collectives {colls}",
          file=sys.stderr)
    return 0 if ok else 1


def _write_counts(path: str, mesh: pmesh.Mesh, seconds: float) -> None:
    from colormipsearch_tpu_torch.kernels import build as kbuild

    dev = mesh.devices[0]
    with open(path, "w") as f:
        json.dump({"rank": mesh.rank, "world_size": mesh.world_size,
                   "n_global_shards": mesh.size, "seconds": seconds,
                   "launches": dict(kbuild.launches),
                   "step_calls": dict(pmesh.step_calls),
                   "collective_calls": dict(pmesh.collective_calls),
                   "peak_gib": (torch.cuda.max_memory_allocated(dev) / 2**30
                                if dev.type == "cuda" else None)}, f)


def _exit_now(rc: int) -> None:
    """Leave at once: the closed connections fail the peers' pending
    collectives instead of leaving them to wait out the timeout."""
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(rc)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m colormipsearch_tpu_torch.parallel.launch",
        description=__doc__.split("\n\n")[0])
    p.add_argument("--init-method", required=True,
                   help="tcp://host:port or file:///path")
    p.add_argument("--world-size", type=int, required=True)
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--backend", choices=pmesh.BACKENDS, required=True)
    p.add_argument("--local-devices", required=True,
                   help="this rank's mesh devices, comma-separated "
                        "(e.g. cuda:0 or cpu,cpu); as many in every rank")
    p.add_argument("--timeout", type=float, default=120.0,
                   help="seconds before the rendezvous or a collective "
                        "gives up")
    p.add_argument("--selftest", default=None, metavar="OUT_JSON",
                   help="run the mesh selftest and write OUT_JSON instead "
                        "of a CLI command")
    p.add_argument("--selftest-size", choices=sorted(SELFTEST_SIZES),
                   default="small",
                   help="small: the JAX selftest's inputs; production: "
                        "566x1210 images, 2,048 targets, 8 masks")
    p.add_argument("--counts", default=None, metavar="OUT_JSON",
                   help="after the command, write this rank's kernel "
                        "launches, mesh step and collective counts, wall "
                        "seconds and peak device memory to OUT_JSON")
    p.add_argument("rest", nargs=argparse.REMAINDER)
    args = p.parse_args(argv)
    # strip only the leading separator, so a literal "--" can still be
    # forwarded to the CLI
    cli_args = args.rest[1:] if args.rest[:1] == ["--"] else args.rest
    if bool(args.selftest) == bool(cli_args):
        p.error("give either --selftest OUT_JSON or a CLI command after --")

    try:
        mesh = pmesh.init_distributed(
            args.init_method, args.world_size, args.rank, args.backend,
            args.local_devices.split(","), timeout=args.timeout)
    except ValueError as e:
        # the device-count and power-of-two checks read every rank's
        # values, so they fail alike in every rank
        print(f"[launch] rank {args.rank}: {e}", file=sys.stderr)
        pmesh.shutdown_distributed()
        return 2
    print(f"[launch] rank {mesh.rank}/{mesh.world_size} ({mesh.backend}): "
          f"{len(mesh.devices)} local / {mesh.size} global shards on "
          f"{', '.join(str(d) for d in mesh.devices)}", file=sys.stderr)
    t0 = time.time()
    try:
        if args.selftest:
            rc = selftest(mesh, args.selftest, args.selftest_size)
        else:
            from colormipsearch_tpu_torch.cli.main import main as cli_main

            pmesh.reset_step_calls()
            rc = cli_main(cli_args)
        if args.counts:
            _write_counts(args.counts, mesh, time.time() - t0)
    except SystemExit as e:  # the CLI's own exit, e.g. a bad argument
        rc = e.code if isinstance(e.code, int) else 1
    except Exception:  # noqa: BLE001 - any failure ends this rank
        traceback.print_exc()
        rc = 1
    if rc:
        print(f"[launch] rank {mesh.rank}: failed with exit code {rc}",
              file=sys.stderr)
        _exit_now(rc)
    try:
        # every rank reaches this only after its command succeeded; a
        # peer that failed has closed its connections and fails it
        pmesh.barrier(mesh)
    except Exception as e:  # noqa: BLE001 - a peer failed
        print(f"[launch] rank {mesh.rank}: a peer failed: {e}",
              file=sys.stderr)
        _exit_now(1)
    pmesh.shutdown_distributed()
    return 0


if __name__ == "__main__":
    sys.exit(main())
