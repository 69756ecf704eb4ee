"""Target sharding of the all-pairs search over a 1-D device mesh, driven
by one process or by several (torch.distributed).

The port of the JAX package's parallel/mesh.py. The target library (the
packed planes, [..., T]) is cut along its trailing target axis into D
contiguous shards, each a copy on its mesh device; the query arguments
are replicated to every shard's device; each step launches its per-shard
kernel on each shard's device, on that device's current stream.

One process: the collectives of the JAX steps become reductions over the
D per-shard results on the mesh's first device: ``pmax`` a max, ``psum``
a sum, the tiled ``all_gather`` a concatenation in shard order, so every
step returns what the JAX step returns, with the same shapes and the
same layout of the gathered axis (a sharded [B, T] output is one tensor
on ``mesh.devices[0]``). A mesh may name one device several times: D
shards on one card (or on the CPU, where the wrappers run their plain
versions), as the JAX tests run their mesh on eight virtual CPU devices.

Several processes (``init_distributed``; the launcher is
parallel/launch.py): every rank passes the same number of local devices,
and the global mesh orders its shards rank-major, so rank r holds global
shards r * n_local .. (r + 1) * n_local - 1, a contiguous block of the
target columns. Every process holds the full host planes and keeps only
its own shards (JAX ``make_array_from_callback``). A step reduces its
local shards as above, then across processes: the maxima by
``all_reduce(MAX)``, the flagged-pair counts by ``all_reduce(SUM)``, the
per-shard top-k by ``all_gather`` in rank order, so both are replicated
in every rank; a dense [.., T] output comes back full width with only
this rank's columns filled and zeros elsewhere (JAX pull_target_cols),
which is what each process then emits: per-process sharded writes. NCCL
reduces CUDA tensors in place; under gloo, CUDA tensors are staged
through the host explicitly (counted as ``host_staged``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import threading

import numpy as np
import torch

from colormipsearch_tpu_torch.ops import pixel_match, shape_score

TARGET_AXIS = "targets"
BACKENDS = ("nccl", "gloo")

# One plain integer per step, incremented each time the step is called,
# so a run can show that it went through the mesh (the per-shard kernels
# count their own launches in kernels/build.launches); beside them, the
# cross-process collectives the steps issued, and how many of them staged
# a CUDA tensor through the host (gloo).
STEPS = ("search", "batch", "batch_split", "batch_keys", "batch_union_keys",
         "batch_union_qkeys", "shape", "shape_both", "shape_split")
step_calls = dict.fromkeys(STEPS, 0)
collective_calls = dict.fromkeys(("all_reduce", "all_gather", "host_staged"),
                                 0)
_count_lock = threading.Lock()


def _count(name: str, counts: dict = step_calls) -> None:
    with _count_lock:
        counts[name] += 1


def reset_step_calls() -> None:
    """Set every step count and every collective count to 0."""
    with _count_lock:
        for counts in (step_calls, collective_calls):
            for name in counts:
                counts[name] = 0


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """An ordered tuple of torch devices, this process's shards of the
    mesh: its shard s (global shard ``first_shard + s``) lives on
    devices[s]. A device may repeat. ``backend`` is set on the global mesh
    of a process group (init_distributed), whose ``world_size`` ranks each
    hold ``len(devices)`` shards; a mesh of one process has none."""
    devices: tuple
    rank: int = 0
    world_size: int = 1
    backend: str | None = None

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        if self.backend is not None and self.size & (self.size - 1):
            # the engines pad the target axis to a power of two
            # (_target_bucket), which no other mesh size divides: every
            # process would then score and write every column
            raise ValueError(
                f"a mesh across processes needs a power-of-two size: "
                f"{self.world_size} ranks x {len(self.devices)} devices = "
                f"{self.size} shards")

    @property
    def size(self) -> int:
        """The number of shards of the whole mesh (every process's)."""
        return self.world_size * len(self.devices)

    @property
    def first_shard(self) -> int:
        """The global index of this process's first shard."""
        return self.rank * len(self.devices)


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"mesh device {d} requested but CUDA is not "
                               "available")
        if d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
    elif d.type == "cpu":
        d = torch.device("cpu")  # CPU tensors carry no device index
    else:
        raise ValueError(f"unsupported mesh device {d}")
    return d


# the global mesh of the process group init_distributed made
_GROUP: dict = {}


def world_size() -> int:
    """The number of processes of the torch.distributed group (1 without
    one)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def init_distributed(init_method: str, world_size: int, rank: int,
                     backend: str, local_devices, *,
                     timeout: float = 120.0) -> Mesh:
    """Join the process group and return its global mesh.

    init_method: ``tcp://host:port`` or ``file:///path``; backend:
    "nccl" (CUDA devices) or "gloo"; local_devices: this process's mesh
    devices, the same number in every rank. Nothing is read from the
    environment. Collectives and the rendezvous give up after `timeout`
    seconds. Raises ValueError (in every rank) when the ranks pass
    different numbers of devices or the global size is not a power of
    two."""
    import torch.distributed as dist

    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: expected one of {BACKENDS}")
    devices = tuple(_device(d) for d in local_devices)
    if not devices:
        raise ValueError("init_distributed needs at least one local device")
    kinds = {d.type for d in devices}
    if len(kinds) != 1 or (backend == "nccl" and kinds != {"cuda"}):
        raise ValueError(f"local devices {[str(d) for d in devices]} for "
                         f"the {backend} backend (nccl takes CUDA devices "
                         "only; the devices of a process share one type)")
    if _GROUP:
        raise RuntimeError("init_distributed was already called")
    if devices[0].type == "cuda":
        torch.cuda.set_device(devices[0])
    dist.init_process_group(
        backend, init_method=init_method, world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout))
    # every rank learns every rank's device count before any mesh exists
    counts = [None] * world_size
    dist.all_gather_object(counts, len(devices))
    if len(set(counts)) != 1:
        raise ValueError(f"the ranks pass different numbers of local "
                         f"devices: {counts}")
    mesh = Mesh(devices, rank, world_size, backend)
    _GROUP.update(backend=backend, devices=devices)
    return mesh


def shutdown_distributed() -> None:
    """Leave the process group init_distributed joined (a no-op without
    one)."""
    import torch.distributed as dist

    _GROUP.clear()
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def global_mesh() -> Mesh:
    """The mesh over every process's devices (init_distributed)."""
    import torch.distributed as dist

    if not _GROUP:
        raise RuntimeError(
            "no process group from parallel.mesh.init_distributed: the "
            "mesh does not know this process's devices")
    return Mesh(_GROUP["devices"], dist.get_rank(), dist.get_world_size(),
                _GROUP["backend"])


def create_mesh(devices=None) -> Mesh:
    """1-D mesh over `devices` (torch devices or their names, in shard
    order; one may repeat), a mesh of this process alone. With None: the
    global mesh when init_distributed made a process group, else a mesh
    over every visible CUDA card. On a host without CUDA, None is an
    error: the mesh never falls back to the CPU unless it is given CPU
    devices."""
    if devices is None:
        if _GROUP or world_size() > 1:
            return global_mesh()
        if not torch.cuda.is_available():
            raise RuntimeError(
                "create_mesh() spans every visible CUDA card, and CUDA is "
                "not available; pass the devices (e.g. ['cpu'] * 8)")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    return Mesh(tuple(_device(d) for d in devices))


def resolve_mesh(use_mesh, device: torch.device) -> Mesh | None:
    """The engines' ``use_mesh`` rule. None: with a process group, its
    global mesh when that has more than one shard (JAX counts global
    devices), else a mesh over every card when `device` is CUDA and more
    than one card is visible, else none; False: none; True:
    create_mesh(); a Mesh: as given. The mesh's devices must be of the
    engine device's type (a CUDA mesh never runs on the CPU). With more
    than one process, only the global mesh is accepted: any other choice
    would score and write every target column in every process."""
    if isinstance(use_mesh, Mesh):
        mesh = use_mesh
    else:
        if use_mesh is None:
            if _GROUP:
                use_mesh = global_mesh().size > 1
            else:
                use_mesh = device.type == "cuda" \
                    and torch.cuda.device_count() > 1
        mesh = create_mesh() if use_mesh else None
    n_proc = world_size()
    if n_proc > 1 and (mesh is None or mesh.backend is None):
        raise ValueError(
            f"{n_proc} processes share the targets only over the global "
            "mesh of parallel.mesh.init_distributed (use_mesh None or "
            "True); a process-local mesh, or none, would score and write "
            "every target column in every process")
    if mesh is None:
        return None
    kinds = {d.type for d in mesh.devices}
    if kinds != {device.type}:
        raise ValueError(f"a mesh over {sorted(kinds)} devices for an "
                         f"engine on {device}")
    return mesh


def _on(device: torch.device):
    """Make `device` current for a launch (a kernel launches on the
    current device's stream)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _shard_width(mesh: Mesh, t: int) -> int:
    if t % mesh.size:
        raise ValueError(f"{t} target columns do not divide over "
                         f"{mesh.size} shards")
    return t // mesh.size


def shard_target_planes(mesh: Mesh, planes) -> tuple:
    """Cut [..., T] planes (a tensor, or a host numpy array of the
    package's plane types) along the trailing T axis into mesh.size
    contiguous shards and return this process's: shard s a copy on
    mesh.devices[s] (every process holds the full planes and copies only
    its own columns); works for [P, T] planes and the shape pass's
    stacked [2, S, T] planes alike. T must divide by the mesh size. A
    host array uploads shard by shard (convert.as_tensor: uint32 planes
    become int32 with the same bits)."""
    from colormipsearch_tpu_torch import convert

    w = _shard_width(mesh, planes.shape[-1])
    out = []
    for s, dev in enumerate(mesh.devices, mesh.first_shard):
        part = planes[..., s * w:(s + 1) * w]
        if isinstance(part, torch.Tensor):
            copy = torch.empty(part.shape, dtype=part.dtype, device=dev)
            with _on(dev):
                copy.copy_(part)
            out.append(copy)
        else:
            out.append(convert.as_tensor(part, dev))
    return tuple(out)


def local_target_mask(arr, t_pad: int) -> np.ndarray:
    """bool [t_pad]: the trailing-axis columns of a target-sharded array
    (`arr`, kept for JAX's signature) that this process's devices hold:
    all of them with one process, else this rank's contiguous block of
    t_pad / world_size columns. The per-process write split derives from
    this mask."""
    n_proc = world_size()
    mask = np.zeros(t_pad, bool)
    if n_proc == 1:
        mask[:] = True
        return mask
    import torch.distributed as dist

    if t_pad % n_proc:
        raise ValueError(f"{t_pad} target columns do not divide over "
                         f"{n_proc} processes")
    w = t_pad // n_proc
    mask[dist.get_rank() * w:(dist.get_rank() + 1) * w] = True
    return mask


def pull_target_cols(arr) -> np.ndarray:
    """A target-sharded result (one tensor in its global layout, [.., T])
    as a host array. With one process a plain pull; with several, the
    full width with only this process's columns kept and zeros elsewhere
    (score 0 and flag 0 emit nothing), which is what the mesh steps
    already return: per-process sharded writes."""
    out = arr.cpu().numpy() if isinstance(arr, torch.Tensor) \
        else np.array(arr)
    if world_size() > 1:
        out[..., ~local_target_mask(out, out.shape[-1])] = 0
    return out


def process_allgather(mesh: Mesh, arr: torch.Tensor) -> torch.Tensor:
    """A dense [.., T] step output, this rank's columns filled, made whole
    in every rank: each rank's block of columns gathered in rank order
    (JAX multihost_utils.process_allgather(x, tiled=True)). With one
    process the input itself."""
    w = arr.shape[-1] // mesh.world_size
    return _gather_ranks(mesh, arr[..., mesh.rank * w:(mesh.rank + 1) * w])


def barrier(mesh: Mesh) -> None:
    """An all-reduce that every process of the mesh must reach (a no-op
    with one process); it fails once a peer has failed and closed its
    connections."""
    _reduce_ranks(mesh, torch.zeros(1, dtype=torch.int32,
                                    device=mesh.devices[0]), "max")


# --- the collectives across processes ---------------------------------------


def _wire(backend: str, x: torch.Tensor) -> torch.Tensor:
    """`x` as the collective takes it: bools as uint8 (NCCL has no bool),
    CUDA tensors on the host under gloo (counted)."""
    if x.dtype == torch.bool:
        x = x.to(torch.uint8)
    if backend == "gloo" and x.device.type == "cuda":
        _count("host_staged", collective_calls)
        x = x.cpu()
    return x.contiguous()


def _unwire(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return x.to(device=like.device, dtype=like.dtype)


def _reduce_ranks(mesh: Mesh, x: torch.Tensor, op: str) -> torch.Tensor:
    """all_reduce of `x` over the mesh's processes ("max" or "sum"); with
    one process, `x`."""
    if mesh.backend is None:
        return x
    import torch.distributed as dist

    wire = _wire(mesh.backend, x)
    if wire is x:
        wire = x.clone()
    dist.all_reduce(wire, op={"max": dist.ReduceOp.MAX,
                              "sum": dist.ReduceOp.SUM}[op])
    _count("all_reduce", collective_calls)
    return _unwire(wire, x)


def _gather_ranks(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """all_gather of `x` from every process, concatenated along its last
    axis in rank order (every rank's `x` has the same shape); with one
    process, `x`."""
    if mesh.backend is None:
        return x
    import torch.distributed as dist

    wire = _wire(mesh.backend, x)
    parts = [torch.empty_like(wire) for _ in range(mesh.world_size)]
    dist.all_gather(parts, wire)
    _count("all_gather", collective_calls)
    return _unwire(torch.cat(parts, dim=-1), x)


def _place_cols(mesh: Mesh, local: torch.Tensor) -> torch.Tensor:
    """This process's [.., n_local * w] block of a dense output as the
    global [.., T] tensor: zeros outside its columns (one process: the
    block itself)."""
    if mesh.backend is None:
        return local
    n = local.shape[-1]
    out = torch.zeros(local.shape[:-1] + (n * mesh.world_size,),
                      dtype=local.dtype, device=local.device)
    out[..., mesh.rank * n:(mesh.rank + 1) * n] = local
    return out


# --- helpers of the steps -------------------------------------------------


def _check_shards(mesh: Mesh, shards, name: str) -> None:
    if len(shards) != len(mesh.devices):
        raise ValueError(f"{name}: {len(shards)} shards for a mesh of "
                         f"{len(mesh.devices)} devices in this process")
    for x, dev in zip(shards, mesh.devices):
        if x.device != dev:
            raise ValueError(f"{name}: a shard on {x.device}, its mesh "
                             f"device is {dev}")


def _per_shard(mesh: Mesh, shards: tuple, replicated: tuple, fn) -> list:
    """fn(shard, *replicated args on the shard's device) for each shard,
    launched on the shard's device. Replicated tensors are copied once per
    distinct device."""
    copies: dict = {}
    out = []
    for shard, dev in zip(shards, mesh.devices):
        args = copies.get(dev)
        if args is None:
            args = tuple(a.to(dev) if isinstance(a, torch.Tensor) else a
                         for a in replicated)
            copies[dev] = args
        with _on(dev):
            out.append(fn(shard, *args))
    return out


def _cat(mesh: Mesh, parts, dim: int) -> torch.Tensor:
    """Concatenate per-shard results in shard order on devices[0]."""
    dev0 = mesh.devices[0]
    return torch.cat([p.to(dev0) for p in parts], dim=dim)


def _finish_batched_step(mesh: Mesh, per_shard: list, top_k: int):
    """Shared tail of the batched sharded steps (JAX _finish_batched_step).

    per_shard: [(best, mirrored, pair_flags) [B, w]] of this process's
    shards, in shard order. Returns (best, mirrored, pair_flags [B, T],
    global_max [B]) with top_k <= 0 (across processes, only this rank's
    columns filled), else the merged per-shard top-k: (scores, idx,
    mirrored, flags [B, D*k], global_max [B], n_flagged [B]) with k =
    min(top_k, w), each shard's k candidates in jax.lax.top_k's order
    (score descending, lower column first), their indices offset by the
    global shard * w, and n_flagged the count of flagged pairs over all
    shards (the engine pulls dense when flagged pairs fall outside the
    selection); across processes all of these are every rank's."""
    dev0 = mesh.devices[0]
    global_max = _reduce_ranks(mesh, torch.stack([
        best.max(dim=-1).values.to(dev0)
        for best, _, _ in per_shard]).max(0).values, "max")
    if top_k <= 0:
        return tuple(_place_cols(mesh, _cat(mesh, [p[i] for p in per_shard],
                                            1))
                     for i in range(3)) + (global_max,)
    w = per_shard[0][0].shape[1]
    k = min(top_k, w)
    parts = []
    n_flagged = None
    for s, ((best, mirrored, flags), dev) in enumerate(
            zip(per_shard, mesh.devices), mesh.first_shard):
        with _on(dev):
            sk, ik, mk, fk = pixel_match.union_keys_topk(best, mirrored, k,
                                                         flags)
            parts.append((sk, ik + s * w, mk, fk))
            count = (flags > 0).sum(dim=1, dtype=torch.int32).to(dev0)
        n_flagged = count if n_flagged is None else n_flagged + count
    return tuple(_gather_ranks(mesh, _cat(mesh, [p[i] for p in parts], 1))
                 for i in range(4)) + (global_max,
                                       _reduce_ranks(mesh, n_flagged, "sum"))


def _no_flags(best: torch.Tensor) -> torch.Tensor:
    return torch.zeros(best.shape, dtype=torch.int32, device=best.device)


# --- the steps ------------------------------------------------------------


def make_sharded_search_step(mesh: Mesh, *, target_threshold: int,
                             ztol_num: int, ztol_den: int,
                             n_straight: int, top_k: int = 0):
    """One query against every target shard (K9 per shard).

    Returns fn(planes shards [P, w], pos [V, Q], q_cls [Q], q_s [Q],
    q_p [Q]) -> (best [T], mirrored [T], pair_flags [T], global_max [])
    and, with top_k > 0, also (topk_scores [D*k], topk_idx [D*k]): each
    shard's top min(top_k, w) scores and their global target indices
    (every process's shards)."""

    def step(planes, pos, q_cls, q_s, q_p):
        _count("search")
        _check_shards(mesh, planes, "planes")
        per = _per_shard(
            mesh, planes, (pos[None], q_cls[None], q_s[None], q_p[None]),
            lambda shard, *a: tuple(x[0] for x in pixel_match.score_query_batch(
                shard, *a, target_threshold=target_threshold,
                ztol_num=ztol_num, ztol_den=ztol_den,
                n_straight=n_straight)))
        best, mirrored, flags = (_cat(mesh, [p[i] for p in per], 0)
                                 for i in range(3))
        global_max = _reduce_ranks(mesh, best.max(), "max")
        best, mirrored, flags = (_place_cols(mesh, x)
                                 for x in (best, mirrored, flags))
        if top_k <= 0:
            return best, mirrored, flags, global_max
        w = per[0][0].shape[0]
        k = min(top_k, w)
        scores, idx = [], []
        for s, ((b, m, _f), dev) in enumerate(zip(per, mesh.devices),
                                              mesh.first_shard):
            with _on(dev):
                sk, ik, _mk = pixel_match.union_keys_topk(b[None], m[None], k)
            scores.append(sk[0])
            idx.append(ik[0] + s * w)
        return (best, mirrored, flags, global_max,
                _gather_ranks(mesh, _cat(mesh, scores, 0)),
                _gather_ranks(mesh, _cat(mesh, idx, 0)))

    return step


def make_sharded_batch_step(mesh: Mesh, *, target_threshold: int,
                            ztol_num: int, ztol_den: int, n_straight: int,
                            top_k: int = 0):
    """A batch of B classic query plans against every shard of summary
    planes (K9 per shard).

    fn(planes shards, pos [B, V, Q], q_cls, q_s, q_p [B, Q]) ->
    (best, mirrored, pair_flags [B, T], global_max [B]), or with top_k > 0
    the merged per-shard top-k (see _finish_batched_step)."""

    def step(planes, pos, q_cls, q_s, q_p):
        _count("batch")
        _check_shards(mesh, planes, "planes")
        per = _per_shard(
            mesh, planes, (pos, q_cls, q_s, q_p),
            lambda shard, *a: pixel_match.score_query_batch(
                shard, *a, target_threshold=target_threshold,
                ztol_num=ztol_num, ztol_den=ztol_den,
                n_straight=n_straight))
        return _finish_batched_step(mesh, per, top_k)

    return step


def make_sharded_batch_step_split(mesh: Mesh, *, ztol_num: int,
                                  ztol_den: int, n_straight: int):
    """Split-plane twin of make_sharded_batch_step (K11 per shard, no
    top-k): fn(t_sp shards, t_c8 shards, pos, q_cls, q_s, q_p) -> (best,
    mirrored, pair_flags [B, T], global_max [B]); the data threshold is
    folded into the planes."""

    def step(t_sp, t_c8, pos, q_cls, q_s, q_p):
        _count("batch_split")
        _check_shards(mesh, t_sp, "t_sp")
        _check_shards(mesh, t_c8, "t_c8")
        per = _per_shard(
            mesh, tuple(zip(t_sp, t_c8)), (pos, q_cls, q_s, q_p),
            lambda pair, *a: pixel_match.score_query_batch_split(
                *pair, *a, ztol_num=ztol_num, ztol_den=ztol_den,
                n_straight=n_straight))
        return _finish_batched_step(mesh, per, 0)

    return step


def make_sharded_batch_step_keys(mesh: Mesh, *, n_straight: int,
                                 top_k: int = 0):
    """Rank-key twin of make_sharded_batch_step (K10 per shard): fn(t_keys
    shards [P+1, w], pos [B, V, Q], lo, span [B, 3, Q]); the predicate is
    exact, so pair_flags are zeros (kept for the interface)."""

    def step(t_keys, pos, lo, span):
        _count("batch_keys")
        _check_shards(mesh, t_keys, "t_keys")

        def one(shard, *a):
            best, mirrored = pixel_match.score_query_batch_keys(
                shard, *a, n_straight=n_straight)
            return best, mirrored, _no_flags(best)

        return _finish_batched_step(
            mesh, _per_shard(mesh, t_keys, (pos, lo, span), one), top_k)

    return step


def make_sharded_batch_step_union_keys(mesh: Mesh, *, top_k: int = 0,
                                       u2: int | None = None):
    """Union-lane twin of make_sharded_batch_step_keys (K3 per shard):
    fn(t_keys shards, u_pos, mu_pos [B, S, U], lane_lo, lane_span
    [B, L, n_slots, U]); ``u2`` the batch's slot-2 segmentation prefix.
    Flags are zeros."""

    def step(t_keys, u_pos, mu_pos, lane_lo, lane_span):
        _count("batch_union_keys")
        _check_shards(mesh, t_keys, "t_keys")

        def one(shard, *a):
            best, mirrored = pixel_match.score_query_batch_union_keys(
                shard, *a, u2)
            return best, mirrored, _no_flags(best)

        return _finish_batched_step(
            mesh, _per_shard(mesh, t_keys,
                             (u_pos, mu_pos, lane_lo, lane_span), one),
            top_k)

    return step


def make_sharded_batch_step_union_qkeys(mesh: Mesh, *, top_k: int = 0,
                                        u2: int | None = None):
    """Qkey wire-form twin of make_sharded_batch_step_union_keys (row 14
    per shard): fn(t_keys shards, u_pos, mu_pos, qidx [B, L, U], key_list
    [B, KL], tab_lo, tab_span [2, n_keys]); the per-lane bounds are
    gathered on the device from the shared tables. Flags are zeros."""

    def step(t_keys, u_pos, mu_pos, qidx, key_list, tab_lo, tab_span):
        _count("batch_union_qkeys")
        _check_shards(mesh, t_keys, "t_keys")

        def one(shard, *a):
            best, mirrored = pixel_match.score_query_batch_union_qkeys(
                shard, *a, u2)
            return best, mirrored, _no_flags(best)

        return _finish_batched_step(
            mesh, _per_shard(mesh, t_keys, (u_pos, mu_pos, qidx, key_list,
                                            tab_lo, tab_span), one),
            top_k)

    return step


def make_sharded_shape_step(mesh: Mesh, *, both: bool = False):
    """Sharded dense-row shape pass (row 18b per shard): the packed target
    planes sharded on T, the packed query replicated. Scores are per
    (query, target), so nothing is reduced across shards: the outputs
    are the shards' concatenated (across processes, this rank's columns
    of the full width).

    both=False: fn(t_pack shards [P, w], q [P]) -> 3 x int32 [T].
    both=True:  fn(t_pack2 shards [2, S, w], q2 [2, S]) -> 3 x int32
    [2, T] (straight and mirror orientations in one launch a shard)."""
    name = "shape_both" if both else "shape"
    pairs = (shape_score.shape_score_pairs_both if both
             else shape_score.shape_score_pairs)

    def step(t_pack, q_pack):
        _count(name)
        _check_shards(mesh, t_pack, "t_pack")
        per = _per_shard(mesh, t_pack, (q_pack,), pairs)
        return tuple(_place_cols(mesh, _cat(mesh, [p[i] for p in per],
                                            1 if both else 0))
                     for i in range(3))

    return step


def make_sharded_shape_split_step(mesh: Mesh):
    """Sharded split-row shape pass (K5 per shard): gap and he planes both
    sharded on the trailing target axis, query planes replicated;
    fn(t_gap shards [n_or, Sg, w], q_gap [n_or, Sg], t_he shards
    [n_or, W, w], q_he [n_or, W]) -> 3 x int32 [n_or, T]."""

    def step(t_gap, q_gap, t_he, q_he):
        _count("shape_split")
        _check_shards(mesh, t_gap, "t_gap")
        _check_shards(mesh, t_he, "t_he")
        per = _per_shard(
            mesh, tuple(zip(t_gap, t_he)), (q_gap, q_he),
            lambda pair, qg, qh: shape_score.shape_score_pairs_split(
                pair[0], qg, pair[1], qh))
        return tuple(_place_cols(mesh, _cat(mesh, [p[i] for p in per], 1))
                     for i in range(3))

    return step
