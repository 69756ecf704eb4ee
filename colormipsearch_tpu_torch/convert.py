"""Carry state across from the JAX package.

There are no weights: the state of a search is the target key planes,
the per-mask plan arrays and the interval and rank tables. These helpers
turn the JAX package's arrays (device arrays or numpy outputs; anything
``np.asarray`` accepts, so jax is never imported here) into the port's
tensors on a given device, bit-exact: uint32 tables become int32 tensors
holding the same bits (torch's uint32 lacks most operations), uint16
index arrays widen to int32 (the qkey form's qidx among them: the
kernels read it as int32), everything else keeps its dtype. The uint16
planes of the split encodings are the exception: the kernels read them
as 16-bit words, so :func:`split_planes` and :func:`split_key_planes`
keep them as int16 tensors with the same bits. A target-sharded JAX
array (the JAX package's mesh steps) is read in its global layout
(``np.asarray`` gathers it in one process), so :func:`as_tensor` makes
it one tensor.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def as_tensor(arr, device: torch.device) -> torch.Tensor:
    """One array -> a contiguous tensor on `device` (see module doc)."""
    a = np.ascontiguousarray(np.asarray(arr))
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    elif a.dtype == np.uint16:
        a = a.astype(np.int32)
    return torch.from_numpy(a).to(device)


def key_planes(planes, device: torch.device) -> torch.Tensor:
    """int32 [P+1, T] rank-key planes (e.g. the JAX package's
    pack_target_planes_keys / pack_target_planes_keys_sparse output)."""
    t = as_tensor(planes, device)
    if t.dtype != torch.int32 or t.dim() != 2:
        raise ValueError(f"expected int32 [P+1, T] planes, got {t.dtype} "
                         f"{tuple(t.shape)}")
    return t


def union_plan(plan, device: torch.device) -> dict:
    """A UnionKeyPlan's array fields (either package's) -> {field: tensor};
    fields that are None on the plan are left out."""
    return {f.name: as_tensor(getattr(plan, f.name), device)
            for f in dataclasses.fields(plan)
            if isinstance(getattr(plan, f.name), np.ndarray)}


def stacked_args(args, device: torch.device) -> tuple:
    """The tuple of stack_union_plan_args / stack_union_pos_args: every
    array -> tensor; the trailing static u2 (an int) passes through."""
    return tuple(a if isinstance(a, (int, np.integer)) or a is None
                 else as_tensor(a, device) for a in args)


def interval_tables(tabs, device: torch.device) -> tuple:
    """interval_table_arrays' (lo, span) uint32 [2, n_keys] -> int32
    tensors with the same bits."""
    return tuple(as_tensor(t, device) for t in tabs)


def _split_pair(hi16, lo8, names: tuple, device: torch.device) -> tuple:
    a = np.ascontiguousarray(np.asarray(hi16))
    b = np.ascontiguousarray(np.asarray(lo8))
    if a.dtype != np.uint16 or b.dtype != np.uint8 or a.ndim != 2 \
            or a.shape != b.shape:
        raise ValueError(f"expected {names[0]} uint16 and {names[1]} uint8 "
                         f"planes of one [rows, T] shape, got {a.dtype} "
                         f"{a.shape} and {b.dtype} {b.shape}")
    return (torch.from_numpy(a.view(np.int16)).to(device),
            torch.from_numpy(b).to(device))


def split_planes(sp, c8, device: torch.device) -> tuple:
    """The JAX package's split planes (uint16 [P, T] (p << 8) | s, uint8
    [P, T] cls; pack_target_planes_split, split_planes_from_packed) ->
    (int16 tensor with the same bits, uint8 tensor)."""
    return _split_pair(sp, c8, ("sp", "c8"), device)


def split_key_planes(rank, cls, device: torch.device) -> tuple:
    """The JAX package's split key planes (uint16 [P+1, T] rank, uint8
    [P+1, T] cls; split_key_planes) -> (int16 tensor with the same bits,
    uint8 tensor)."""
    return _split_pair(rank, cls, ("rank", "cls"), device)


def qidx(arr, device: torch.device) -> torch.Tensor:
    """The qkey form's uint16 [B, L, U] lane indices (stack_union_qkey_args)
    -> an int32 tensor with the same values."""
    a = np.asarray(arr)
    if a.dtype != np.uint16 or a.ndim != 3:
        raise ValueError(f"expected uint16 [B, L, U] indices, got {a.dtype} "
                         f"{a.shape}")
    return as_tensor(a, device)


def shape_planes(arr, device: torch.device) -> torch.Tensor:
    """Dense shape packs (pack_targets' uint32 [P, T], pack_target_rows'
    uint32 [n_or, S, T]) -> int32 tensors with the same bits."""
    a = np.asarray(arr)
    if a.dtype != np.uint32 or a.ndim not in (2, 3):
        raise ValueError(f"expected uint32 [P, T] or [n_or, S, T] planes, "
                         f"got {a.dtype} {a.shape}")
    return as_tensor(a, device)
