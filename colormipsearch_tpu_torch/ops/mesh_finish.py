"""The mesh finish: the per-shard tail of the sharded steps
(parallel/mesh.py) as one kernel launch a shard, and the reduction of
the shards' per-mask slots as one launch a step.

The port of the tail of the JAX package's parallel/mesh.py
``_finish_batched_step`` (and of the one-mask search step's): each
shard's top-k in jax.lax.top_k's order (score descending, lower column
first), its columns offset by the shard's first global column, the
mirrored bits and pair flags at those columns, the shard's per-mask
maximum and count of flagged pairs; then the maxima's max and the
counts' sum over the shards. CPU tensors run the plain versions; CUDA
tensors launch kernels/csrc/mesh_finish.cu (whose selection is K4's,
topk_select.cuh) or raise.
"""

from __future__ import annotations

import torch

from colormipsearch_tpu_torch.kernels import build as kbuild
from colormipsearch_tpu_torch.ops import pixel_match


def mesh_finish_plain(best, mirrored, k: int, pair_flags=None,
                      col_offset: int = 0):
    """Plain PyTorch version of mesh_finish: (scores int32 [B, k], idx
    int32 [B, k], mirr bool [B, k], flags int32 [B, k], row_max int32
    [B], n_flagged int32 [B]); flags and n_flagged are zeros without
    pair_flags. A stable descending sort gives jax.lax.top_k's order."""
    batch = best.shape[0]
    row_max = best.max(1).values
    if pair_flags is None:
        n_flagged = torch.zeros(batch, dtype=torch.int32, device=best.device)
    else:
        n_flagged = (pair_flags > 0).sum(1, dtype=torch.int32)
    scores, idx = torch.sort(best, dim=1, descending=True, stable=True)
    idx = idx[:, :k]
    flags = (torch.zeros((batch, k), dtype=torch.int32, device=best.device)
             if pair_flags is None else torch.gather(pair_flags, 1, idx))
    return (scores[:, :k].contiguous(), (idx + col_offset).to(torch.int32),
            torch.gather(mirrored, 1, idx), flags, row_max, n_flagged)


_OUT_DTYPES = (torch.int32, torch.int32, torch.bool, torch.int32,
               torch.int32, torch.int32)
_OUT_NAMES = ("scores", "idx", "mirr", "flags", "row_max", "n_flagged")


def _check_out(out, batch: int, k: int) -> int:
    """Validate mesh_finish's `out` and return the row stride of its
    [B, k] outputs (k when B <= 1)."""
    if len(out) != 6:
        raise ValueError(f"out: expected 6 entries {_OUT_NAMES}, got "
                         f"{len(out)}")
    ld = None
    for i, (x, dtype, name) in enumerate(zip(out, _OUT_DTYPES, _OUT_NAMES)):
        if x is None:
            continue
        if not isinstance(x, torch.Tensor) or x.dtype != dtype:
            raise TypeError(f"out {name}: expected a {dtype} tensor")
        if i >= 4:
            kbuild.check_tensor(x, name, dtype, (batch,))
            continue
        if tuple(x.shape) != (batch, k) or (k > 1 and x.stride(1) != 1):
            raise ValueError(f"out {name}: expected [{batch}, {k}] with "
                             f"unit column stride, got {tuple(x.shape)} "
                             f"strides {x.stride()}")
        if batch > 1:
            if ld is None:
                ld = x.stride(0)
            if x.stride(0) != ld or ld < k:
                raise ValueError(f"out {name}: row stride {x.stride(0)}, "
                                 f"expected one stride >= {k} for all")
    if k > 0 and (out[0] is None or out[1] is None):
        raise ValueError("out: scores and idx are needed when k > 0")
    return ld if ld is not None else k


def mesh_finish(best, mirrored, k: int, pair_flags=None,
                col_offset: int = 0, *, out=None):
    """One shard's tail: best int32 [B, w], mirrored bool [B, w] and
    pair_flags int32 [B, w] or None (the step has no flags) -> (scores,
    idx, mirr, flags [B, k], row_max, n_flagged [B]) as
    mesh_finish_plain's, 0 <= k <= w (k = 0: only the last two).

    `out`: six tensors to write into, or None for an output not wanted
    (mirr, flags, row_max, n_flagged may be None; scores and idx are
    needed when k > 0): the [B, k] ones may be column slices of wider
    rows (one row stride for all, unit column stride), the [B] ones
    contiguous; returns `out`. Without `out`, fresh tensors. CPU tensors
    run the plain version; CUDA tensors launch
    kernels/csrc/mesh_finish.cu (w <= 16,384) or raise."""
    batch, n_cols = best.shape
    kbuild.check_tensor(best, "best", torch.int32)
    kbuild.check_tensor(mirrored, "mirrored", torch.bool, (batch, n_cols))
    extra = ()
    if pair_flags is not None:
        kbuild.check_tensor(pair_flags, "pair_flags", torch.int32,
                            (batch, n_cols))
        extra = (pair_flags,)
    if not 0 <= k <= n_cols:
        raise ValueError(f"k={k} outside [0, {n_cols}]")
    if out is None:
        if best.device.type == "cpu":
            return mesh_finish_plain(best, mirrored, k, pair_flags,
                                     col_offset)
        packed = torch.empty((3, batch, k), dtype=torch.int32,
                             device=best.device)
        out = (packed[0], packed[1],
               torch.empty((batch, k), dtype=torch.bool, device=best.device),
               packed[2], *torch.empty((2, batch), dtype=torch.int32,
                                       device=best.device))
    ld = _check_out(out, batch, k)
    kbuild.same_device(best, mirrored, *extra,
                       *(x for x in out if x is not None))
    if best.device.type == "cpu":
        for dst, src in zip(out, mesh_finish_plain(
                best, mirrored, k, pair_flags, col_offset)):
            if dst is not None:
                dst.copy_(src)
        return out
    kbuild.require_cuda(best)
    lib = kbuild.load_library()
    max_cols = pixel_match._topk_max_cols(lib)
    if n_cols > max_cols:
        raise ValueError(f"mesh_finish: {n_cols} columns exceed the "
                         f"kernel's {max_cols}")
    ptrs = [None if x is None else x.data_ptr() for x in out]
    kbuild.check(lib.cmst_mesh_finish(
        best.data_ptr(), mirrored.data_ptr(),
        pair_flags.data_ptr() if extra else None, batch, n_cols, k, ld,
        col_offset, *ptrs, kbuild.stream_of(best)), "mesh_finish")
    kbuild.count_launch("mesh_finish")
    return out


def mesh_reduce_plain(slot_max, slot_flagged=None):
    """Plain PyTorch version of mesh_reduce."""
    return (slot_max.max(0).values,
            None if slot_flagged is None
            else slot_flagged.sum(0, dtype=torch.int32))


def mesh_reduce(slot_max, slot_flagged=None):
    """The shards' slots int32 [D, B] (row maxima; flagged counts or None)
    -> (global_max int32 [B], n_flagged int32 [B] or None): the max and
    the sum over the D shards. CPU tensors run the plain version; CUDA
    tensors launch kernels/csrc/mesh_finish.cu or raise."""
    kbuild.check_tensor(slot_max, "slot_max", torch.int32)
    if slot_max.dim() != 2 or slot_max.shape[0] < 1:
        raise ValueError(f"expected slot_max [D >= 1, B], got "
                         f"{tuple(slot_max.shape)}")
    n_shards, batch = slot_max.shape
    if slot_flagged is not None:
        kbuild.check_tensor(slot_flagged, "slot_flagged", torch.int32,
                            (n_shards, batch))
        kbuild.same_device(slot_max, slot_flagged)
    if slot_max.device.type == "cpu":
        return mesh_reduce_plain(slot_max, slot_flagged)
    kbuild.require_cuda(slot_max)
    out = torch.empty((2, batch), dtype=torch.int32, device=slot_max.device)
    lib = kbuild.load_library()
    kbuild.check(lib.cmst_mesh_reduce(
        slot_max.data_ptr(),
        None if slot_flagged is None else slot_flagged.data_ptr(),
        n_shards, batch, out[0].data_ptr(),
        None if slot_flagged is None else out[1].data_ptr(),
        kbuild.stream_of(slot_max)), "mesh_reduce")
    kbuild.count_launch("mesh_reduce")
    return out[0], None if slot_flagged is None else out[1]
