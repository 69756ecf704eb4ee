"""Target sharding of the all-pairs search over a 1-D device mesh, driven
by one process.

The port of the JAX package's parallel/mesh.py for a single process. The
target library (the packed planes, [..., T]) is cut along its trailing
target axis into D contiguous shards, each a copy on its mesh device;
the query arguments are replicated to every shard's device; each step
launches its per-shard kernel on each shard's device, on that device's
current stream. The collectives of the JAX steps become reductions over
the D per-shard results on the mesh's first device: ``pmax`` a max,
``psum`` a sum, the tiled ``all_gather`` a concatenation in shard order,
so every step returns what the JAX step returns, with the same shapes and
the same layout of the gathered axis (a sharded [B, T] output is one
tensor on ``mesh.devices[0]``).

A mesh may name one device several times: D shards on one card (or on
the CPU, where the wrappers run their plain versions), as the JAX tests
run their mesh on eight virtual CPU devices.

Across processes (torch.distributed with a world size above 1) nothing
is ported yet: every entry point raises NotImplementedError there.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading

import numpy as np
import torch

from colormipsearch_tpu_torch.ops import pixel_match, shape_score

TARGET_AXIS = "targets"

# One plain integer per step, incremented each time the step is called,
# so a run can show that it went through the mesh (the per-shard kernels
# count their own launches in kernels/build.launches).
STEPS = ("search", "batch", "batch_split", "batch_keys", "batch_union_keys",
         "batch_union_qkeys", "shape", "shape_both", "shape_split")
step_calls = dict.fromkeys(STEPS, 0)
_count_lock = threading.Lock()


def _count(name: str) -> None:
    with _count_lock:
        step_calls[name] += 1


def reset_step_calls() -> None:
    with _count_lock:
        for name in step_calls:
            step_calls[name] = 0


def _require_single_process() -> None:
    """The cross-process mesh is the next slice of the port."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        from colormipsearch_tpu_torch.engine.cds import not_ported

        raise not_ported("a mesh across processes (torch.distributed with "
                         f"{dist.get_world_size()} ranks)", 2)


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """An ordered tuple of torch devices: shard s of every sharded array
    lives on devices[s]. A device may repeat."""
    devices: tuple

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a mesh needs at least one device")

    @property
    def size(self) -> int:
        return len(self.devices)


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


def create_mesh(devices=None) -> Mesh:
    """1-D mesh over `devices` (torch devices or their names, in shard
    order; one may repeat), or over every visible CUDA card when None. On
    a host without CUDA, None is an error: the mesh never falls back to
    the CPU unless it is given CPU devices."""
    _require_single_process()
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "create_mesh() spans every visible CUDA card, and CUDA is "
                "not available; pass the devices (e.g. ['cpu'] * 8)")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    return Mesh(tuple(_device(d) for d in devices))


def resolve_mesh(use_mesh, device: torch.device) -> Mesh | None:
    """The engines' ``use_mesh`` rule. None: a mesh over every card when
    `device` is CUDA and more than one card is visible, else none; False:
    none; True: create_mesh(); a Mesh: as given. The mesh's devices must
    be of the engine device's type (a CUDA mesh never runs on the CPU)."""
    if isinstance(use_mesh, Mesh):
        _require_single_process()
        mesh = use_mesh
    else:
        if use_mesh is None:
            use_mesh = device.type == "cuda" \
                and torch.cuda.device_count() > 1
        if not use_mesh:
            return None
        mesh = create_mesh()
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


def shard_target_planes(mesh: Mesh, planes) -> tuple:
    """Cut [..., T] planes (a tensor, or a host numpy array of the
    package's plane types) along the trailing T axis into mesh.size
    contiguous shards, shard s a copy on mesh.devices[s]; works for
    [P, T] planes and the shape pass's stacked [2, S, T] planes alike.
    T must divide by the mesh size. A host array uploads shard by shard
    (convert.as_tensor: uint32 planes become int32 with the same bits)."""
    from colormipsearch_tpu_torch import convert

    _require_single_process()
    t = planes.shape[-1]
    if t % mesh.size:
        raise ValueError(f"{t} target columns do not divide over "
                         f"{mesh.size} shards")
    w = t // mesh.size
    out = []
    for s, dev in enumerate(mesh.devices):
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
    that this process's devices hold: all of them with one process (the
    only form ported)."""
    _require_single_process()
    return np.ones(t_pad, bool)


def pull_target_cols(arr) -> np.ndarray:
    """A target-sharded result (one tensor in its global layout) as a
    host array. With one process this is a plain pull."""
    _require_single_process()
    if isinstance(arr, torch.Tensor):
        return arr.cpu().numpy()
    return np.asarray(arr)


# --- helpers of the steps -------------------------------------------------


def _check_shards(mesh: Mesh, shards, name: str) -> None:
    if len(shards) != mesh.size:
        raise ValueError(f"{name}: {len(shards)} shards for a mesh of "
                         f"{mesh.size} devices")
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

    per_shard: [(best, mirrored, pair_flags) [B, w]] in shard order.
    Returns (best, mirrored, pair_flags [B, T], global_max [B]) with
    top_k <= 0, else the merged per-shard top-k: (scores, idx, mirrored,
    flags [B, D*k], global_max [B], n_flagged [B]) with k = min(top_k,
    w), each shard's k candidates in jax.lax.top_k's order (score
    descending, lower column first), their indices offset by shard * w,
    and n_flagged the count of flagged pairs over all shards (the engine
    pulls dense when flagged pairs fall outside the selection)."""
    dev0 = mesh.devices[0]
    global_max = torch.stack([best.max(dim=-1).values.to(dev0)
                              for best, _, _ in per_shard]).max(0).values
    if top_k <= 0:
        return tuple(_cat(mesh, [p[i] for p in per_shard], 1)
                     for i in range(3)) + (global_max,)
    w = per_shard[0][0].shape[1]
    k = min(top_k, w)
    parts = []
    n_flagged = None
    for s, ((best, mirrored, flags), dev) in enumerate(
            zip(per_shard, mesh.devices)):
        with _on(dev):
            sk, ik, mk, fk = pixel_match.union_keys_topk(best, mirrored, k,
                                                         flags)
            parts.append((sk, ik + s * w, mk, fk))
            count = (flags > 0).sum(dim=1, dtype=torch.int32).to(dev0)
        n_flagged = count if n_flagged is None else n_flagged + count
    return tuple(_cat(mesh, [p[i] for p in parts], 1)
                 for i in range(4)) + (global_max, n_flagged)


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
    shard's top min(top_k, w) scores and their global target indices."""

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
        global_max = best.max()
        if top_k <= 0:
            return best, mirrored, flags, global_max
        w = per[0][0].shape[0]
        k = min(top_k, w)
        scores, idx = [], []
        for s, ((b, m, _f), dev) in enumerate(zip(per, mesh.devices)):
            with _on(dev):
                sk, ik, _mk = pixel_match.union_keys_topk(b[None], m[None], k)
            scores.append(sk[0])
            idx.append(ik[0] + s * w)
        return (best, mirrored, flags, global_max, _cat(mesh, scores, 0),
                _cat(mesh, idx, 0))

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
    are the shards' concatenated.

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
        return tuple(_cat(mesh, [p[i] for p in per], 1 if both else 0)
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
        return tuple(_cat(mesh, [p[i] for p in per], 1) for i in range(3))

    return step
