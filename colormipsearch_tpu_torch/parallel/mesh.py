"""Target sharding of the all-pairs search over a 1-D device mesh, driven
by one process or by several (torch.distributed).

The port of the JAX package's parallel/mesh.py. The target library (the
packed planes, [..., T]) is cut along its trailing target axis into D
contiguous shards, each a copy on its mesh device; the query arguments
are replicated to every shard's device (one copy a distinct device);
each step launches its per-shard kernel on each shard's device.

On a CUDA mesh each shard's launches run on a side stream of its own (a
pool a device, made at the mesh's first step), which first waits on an
event recorded on its device's current stream; the first device's
current stream (and each other device's, for its own shards) waits on
every shard's finishing event before the step returns. So shards that
share a card run side by side, the shards of several cards overlap, and
no step waits on the host (chip_smoke phase 7 runs every step under
``torch.cuda.set_sync_debug_mode("error")``). The batched steps finish
each shard with one launch of ops/mesh_finish (its top-k written
straight into its column slice of the step's outputs, its per-mask max
and flagged count into a slot) and the step with one reduction of the
slots; the one-mask search step's K9 writes its column slice of the
[T] outputs in place. On the CPU there are no streams: the shards run
one after another through the plain versions.

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

from colormipsearch_tpu_torch.ops import mesh_finish as mf
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
_stream_lock = threading.Lock()


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
    # a CUDA mesh's _SidePool, made at its first step (_side_pool)
    pool: list = dataclasses.field(default_factory=list, init=False,
                                   repr=False, compare=False)

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


class _SidePool:
    """A CUDA mesh's side streams, one a shard (a pool a device of as
    many streams as it holds shards), and the events of a step's fork
    (one a device) and join (one a shard): made once a mesh, reused by
    every step (a wait enqueued on an event holds its record of the
    time, so the next step may record it again)."""

    def __init__(self, devices: tuple):
        self.devices = tuple(dict.fromkeys(devices))
        self.streams = tuple(torch.cuda.Stream(device=d) for d in devices)
        self.ready = {d: torch.cuda.Event() for d in self.devices}
        self.done = tuple(torch.cuda.Event() for _ in devices)


def _side_pool(mesh: Mesh) -> _SidePool | None:
    """The mesh's _SidePool, made at its first step; None on a CPU mesh
    (no streams: the shards run one after another)."""
    if mesh.devices[0].type != "cuda":
        return None
    if not mesh.pool:
        with _stream_lock:
            if not mesh.pool:
                mesh.pool.append(_SidePool(mesh.devices))
    return mesh.pool[0]


class _ShardStreams:
    """The shards of one step, side by side:

        with _ShardStreams(mesh) as shards:
            for s in ...: shards.use(s); <launch shard s>

    On a CUDA mesh, entering makes each shard's side stream wait on its
    device's current stream (an event recorded after the step's
    allocations and copies there, so it sees the step's inputs);
    use(s) makes shard s's side stream current (and its device), where
    its wrappers allocate and launch; leaving restores every device's
    own current stream and the current device, then makes the first
    device's current stream wait on every shard, and each other device's
    on its own shards, so whatever follows on a current stream (the
    step's copies and reductions, the caller's work, the reuse of memory
    freed there) runs after the shards' work. On a CPU mesh use(s) does
    nothing: the shards run one after another."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.pool = _side_pool(mesh)

    def __enter__(self):
        pool = self.pool
        if pool is not None:
            self.device = torch.cuda.current_device()
            self.current = {d: torch.cuda.current_stream(d)
                            for d in pool.devices}
            for dev, ready in pool.ready.items():
                ready.record(self.current[dev])
            for stream, dev in zip(pool.streams, self.mesh.devices):
                stream.wait_event(pool.ready[dev])
        return self

    def use(self, s: int) -> None:
        if self.pool is not None:
            torch.cuda.set_stream(self.pool.streams[s])

    def keep(self, *xs) -> None:
        """Tensors a shard allocated on its side stream that a current
        stream reads after the join (a concatenation, a copy to another
        device): the caching allocator must not hand their memory to the
        side stream again before that read has run. Once an allocation
        (views of one tensor share it)."""
        if self.pool is None:
            return
        seen = set()
        for x in xs:
            if x is None:
                continue
            base = x if x._base is None else x._base
            if id(base) not in seen:
                seen.add(id(base))
                base.record_stream(self.current[base.device])

    def __exit__(self, *exc) -> None:
        pool = self.pool
        if pool is None:
            return
        for dev in pool.devices:
            torch.cuda.set_stream(self.current[dev])
        torch.cuda.set_device(self.device)
        dev0 = self.mesh.devices[0]
        for stream, done, dev in zip(pool.streams, pool.done,
                                     self.mesh.devices):
            done.record(stream)
            self.current[dev0].wait_event(done)
            if dev != dev0:
                self.current[dev].wait_event(done)


def _banded_rules(mesh: Mesh, q_cls, q_s, q_p, ztol_num: int,
                  ztol_den: int) -> tuple:
    """K9's and K11's query-side tables of a batch (pixel_match
    .banded_rules), computed once a step on the first device of a CUDA
    mesh and replicated with the query (computed a shard, they cost more
    host time than the shard's launch); () on the CPU, where the plain
    versions compute their own."""
    if mesh.devices[0].type != "cuda":
        return ()
    with _on(mesh.devices[0]):
        return pixel_match.banded_rules(q_cls, q_s, q_p, ztol_num=ztol_num,
                                        ztol_den=ztol_den)


def _replicate(mesh: Mesh, replicated: tuple) -> dict:
    """The replicated arguments on each distinct mesh device (tensors
    copied once a device, device to device: no host sync)."""
    return {dev: tuple(a.to(dev) if isinstance(a, torch.Tensor) else a
                       for a in replicated)
            for dev in dict.fromkeys(mesh.devices)}


def _runs(mesh: Mesh) -> list:
    """[device, first shard, count] of each run of consecutive shards on
    a device other than the first."""
    runs = []
    for s, dev in enumerate(mesh.devices):
        if dev == mesh.devices[0]:
            continue
        if runs and runs[-1][0] == dev and sum(runs[-1][1:]) == s:
            runs[-1][2] += 1
        else:
            runs.append([dev, s, 1])
    return runs


class _ShardSlices:
    """One step output made of the shards' slices of `width` along one
    axis: the tensor [*lead, n * width, *trail] on the first device, which
    the shards there write in place, and for each run of shards on
    another device a compact block there, copied in once (gather, after
    the join). Allocated before the fork, on the current streams."""

    def __init__(self, mesh: Mesh, runs: list, lead: tuple, width: int,
                 trail: tuple, dtype):
        self.axis, self.width = len(lead), width
        self.full = torch.empty((*lead, len(mesh.devices) * width, *trail),
                                dtype=dtype, device=mesh.devices[0])
        self.where, self.blocks = {}, []
        for dev, s0, m in runs:
            block = torch.empty((*lead, m * width, *trail), dtype=dtype,
                                device=dev)
            self.blocks.append((block, s0, m))
            self.where.update((s0 + j, (block, j)) for j in range(m))

    def slice(self, s: int) -> torch.Tensor:
        t, j = self.where.get(s, (self.full, s))
        return t.narrow(self.axis, j * self.width, self.width)

    def gather(self) -> torch.Tensor:
        for block, s0, m in self.blocks:
            self.full.narrow(self.axis, s0 * self.width,
                             m * self.width).copy_(block)
        return self.full


def _per_shard(mesh: Mesh, shards: tuple, replicated: tuple, fn) -> list:
    """fn(shard, *replicated args on the shard's device) -> a tensor, for
    each shard, on the shard's side stream (CUDA), joined before it
    returns: the shape steps, whose per-shard outputs are concatenated on
    the first device."""
    args = _replicate(mesh, replicated)
    out = []
    with _ShardStreams(mesh) as streams:
        for s, (shard, dev) in enumerate(zip(shards, mesh.devices)):
            streams.use(s)
            got = fn(shard, *args[dev])
            streams.keep(got)
            out.append(got)
    return out


def _cat(mesh: Mesh, parts, dim: int) -> torch.Tensor:
    """Concatenate per-shard results in shard order on devices[0]."""
    dev0 = mesh.devices[0]
    return torch.cat([p.to(dev0) for p in parts], dim=dim)


def _run_batched(mesh: Mesh, shards: tuple, replicated: tuple, fn,
                 top_k: int, batch: int, width: int):
    """The batched steps: for each shard, on its side stream, fn(shard,
    *replicated args) -> (best, mirrored [B, w], pair_flags [B, w] or None
    when the step has no flags), then its finish (ops/mesh_finish) into
    the step's outputs; after the join, the shards' slots reduced on the
    first device and the collectives across processes. Returns what
    _finish_batched_step documents."""
    dev0 = mesh.devices[0]
    k = min(top_k, width) if top_k > 0 else 0
    runs = _runs(mesh)
    args = _replicate(mesh, replicated)
    # [n_slots, D, B]: each shard's row maxima (and flagged counts)
    slots = _ShardSlices(mesh, runs, (2 if k else 1,), 1, (batch,),
                         torch.int32)
    if k:
        # the merged top-k: scores, columns, flags; mirrored
        top = _ShardSlices(mesh, runs, (3, batch), k, (), torch.int32)
        top_m = _ShardSlices(mesh, runs, (batch,), k, (), torch.bool)
    dense = []
    with _ShardStreams(mesh) as streams:
        for s, (shard, dev) in enumerate(zip(shards, mesh.devices)):
            slot = slots.slice(s)[:, 0]
            if k:
                scores, idx, flags = top.slice(s).unbind(0)
                out = (scores, idx, top_m.slice(s), flags, *slot)
            else:
                out = (None, None, None, None, slot[0], None)
            streams.use(s)
            best, mirrored, pair_flags = fn(shard, *args[dev])
            mf.mesh_finish(best, mirrored, k, pair_flags,
                           (mesh.first_shard + s) * width, out=out)
            if not k:
                streams.keep(best, mirrored, pair_flags)
                dense.append((best, mirrored, pair_flags))
    slot_all = slots.gather()
    with _on(dev0):
        global_max, n_flagged = mf.mesh_reduce(*slot_all)
    global_max = _reduce_ranks(mesh, global_max, "max")
    if not k:
        flags = (torch.zeros((batch, len(shards) * width), dtype=torch.int32,
                             device=dev0)
                 if dense[0][2] is None
                 else _cat(mesh, [p[2] for p in dense], 1))
        return (_place_cols(mesh, _cat(mesh, [p[0] for p in dense], 1)),
                _place_cols(mesh, _cat(mesh, [p[1] for p in dense], 1)),
                _place_cols(mesh, flags), global_max)
    scores, idx, flags = top.gather()
    return (*(_gather_ranks(mesh, x)
              for x in (scores, idx, top_m.gather(), flags)),
            global_max, _reduce_ranks(mesh, n_flagged, "sum"))


def _finish_batched_step(mesh: Mesh, per_shard: list, top_k: int):
    """Shared tail of the batched sharded steps (JAX _finish_batched_step)
    on per-shard results already computed.

    per_shard: [(best, mirrored, pair_flags or None) [B, w]] of this
    process's shards, in shard order. Returns (best, mirrored, pair_flags
    [B, T], global_max [B]) with top_k <= 0 (across processes, only this
    rank's columns filled; pair_flags zeros when the shards have none),
    else the merged per-shard top-k: (scores, idx, mirrored, flags
    [B, D*k], global_max [B], n_flagged [B]) with k = min(top_k, w), each
    shard's k candidates in jax.lax.top_k's order (score descending,
    lower column first), their indices offset by the global shard * w,
    and n_flagged the count of flagged pairs over all shards (the engine
    pulls dense when flagged pairs fall outside the selection); across
    processes all of these are every rank's."""
    batch, width = per_shard[0][0].shape
    return _run_batched(mesh, tuple(per_shard), (), lambda p: p, top_k,
                        batch, width)


# --- the steps ------------------------------------------------------------


def make_sharded_search_step(mesh: Mesh, *, target_threshold: int,
                             ztol_num: int, ztol_den: int,
                             n_straight: int, top_k: int = 0):
    """One query against every target shard (K9 per shard).

    Returns fn(planes shards [P, w], pos [V, Q], q_cls [Q], q_s [Q],
    q_p [Q]) -> (best [T], mirrored [T], pair_flags [T], global_max [])
    and, with top_k > 0, also (topk_scores [D*k], topk_idx [D*k]): each
    shard's top min(top_k, w) scores and their global target indices
    (every process's shards). Each shard's K9 writes its column slice of
    the [T] outputs in place (a shard on another device than the first
    writes a block there, copied in once), and its finish (B = 1) its
    slice of the top-k."""
    def step(planes, pos, q_cls, q_s, q_p):
        _count("search")
        _check_shards(mesh, planes, "planes")
        dev0 = mesh.devices[0]
        width = planes[0].shape[-1]
        k = min(top_k, width) if top_k > 0 else 0
        runs = _runs(mesh)
        query = (q_cls[None], q_s[None], q_p[None])
        args = _replicate(mesh, (pos[None], *query, *_banded_rules(
            mesh, *query, ztol_num, ztol_den)))
        dense = _ShardSlices(mesh, runs, (2,), width, (), torch.int32)
        dense_m = _ShardSlices(mesh, runs, (), width, (), torch.bool)
        slots = _ShardSlices(mesh, runs, (), 1, (1,), torch.int32)
        if k:
            top = _ShardSlices(mesh, runs, (2, 1), k, (), torch.int32)
        with _ShardStreams(mesh) as streams:
            for s, (shard, dev) in enumerate(zip(planes, mesh.devices)):
                best, flags = dense.slice(s)[:, None]
                mirrored = dense_m.slice(s)[None]
                streams.use(s)
                pixel_match.score_query_batch(
                    shard, *args[dev][:4], target_threshold=target_threshold,
                    ztol_num=ztol_num, ztol_den=ztol_den,
                    n_straight=n_straight, out=(best, mirrored, flags),
                    rules=args[dev][4:] or None)
                mf.mesh_finish(
                    best, mirrored, k, None, (mesh.first_shard + s) * width,
                    out=(*(top.slice(s).unbind(0) if k else (None, None)),
                         None, None, slots.slice(s)[0], None))
        best, flags = dense.gather()
        mirrored = dense_m.gather()
        with _on(dev0):
            global_max = mf.mesh_reduce(slots.gather())[0].reshape(())
        global_max = _reduce_ranks(mesh, global_max, "max")
        best, mirrored, flags = (_place_cols(mesh, x)
                                 for x in (best, mirrored, flags))
        if not k:
            return best, mirrored, flags, global_max
        scores, idx = top.gather()[:, 0]
        return (best, mirrored, flags, global_max,
                _gather_ranks(mesh, scores), _gather_ranks(mesh, idx))

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
        return _run_batched(
            mesh, planes, (pos, q_cls, q_s, q_p, *_banded_rules(
                mesh, q_cls, q_s, q_p, ztol_num, ztol_den)),
            lambda shard, *a: pixel_match.score_query_batch(
                shard, *a[:4], target_threshold=target_threshold,
                ztol_num=ztol_num, ztol_den=ztol_den,
                n_straight=n_straight, rules=a[4:] or None),
            top_k, pos.shape[0], planes[0].shape[-1])

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
        return _run_batched(
            mesh, tuple(zip(t_sp, t_c8)), (pos, q_cls, q_s, q_p,
                                           *_banded_rules(
                                               mesh, q_cls, q_s, q_p,
                                               ztol_num, ztol_den)),
            lambda pair, *a: pixel_match.score_query_batch_split(
                *pair, *a[:4], ztol_num=ztol_num, ztol_den=ztol_den,
                n_straight=n_straight, rules=a[4:] or None),
            0, pos.shape[0], t_sp[0].shape[-1])

    return step


def make_sharded_batch_step_keys(mesh: Mesh, *, n_straight: int,
                                 top_k: int = 0):
    """Rank-key twin of make_sharded_batch_step (K10 per shard): fn(t_keys
    shards [P+1, w], pos [B, V, Q], lo, span [B, 3, Q]); the predicate is
    exact, so pair_flags are zeros (kept for the interface; the finish
    writes them, no shard makes a zero tensor)."""

    def step(t_keys, pos, lo, span):
        _count("batch_keys")
        _check_shards(mesh, t_keys, "t_keys")
        return _run_batched(
            mesh, t_keys, (pos, lo, span),
            lambda shard, *a: (*pixel_match.score_query_batch_keys(
                shard, *a, n_straight=n_straight), None),
            top_k, pos.shape[0], t_keys[0].shape[-1])

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
        return _run_batched(
            mesh, t_keys, (u_pos, mu_pos, lane_lo, lane_span),
            lambda shard, *a: (*pixel_match.score_query_batch_union_keys(
                shard, *a, u2), None),
            top_k, u_pos.shape[0], t_keys[0].shape[-1])

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
        return _run_batched(
            mesh, t_keys, (u_pos, mu_pos, qidx, key_list, tab_lo, tab_span),
            lambda shard, *a: (*pixel_match.score_query_batch_union_qkeys(
                shard, *a, u2), None),
            top_k, u_pos.shape[0], t_keys[0].shape[-1])

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
        per = _per_shard(mesh, t_pack, (q_pack,),
                         lambda t, q: pairs(t, q, stacked=True))
        return tuple(_place_cols(mesh, x)
                     for x in _cat(mesh, per, -1).unbind(0))

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
                pair[0], qg, pair[1], qh, stacked=True))
        return tuple(_place_cols(mesh, x)
                     for x in _cat(mesh, per, -1).unbind(0))

    return step
