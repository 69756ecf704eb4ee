"""Build and load the hand-written CUDA kernels.

Every ``csrc/*.cu`` file is compiled for ``sm_90a`` by its own nvcc
process, all started together, and the objects are linked into one
shared library with a plain C interface, at first use, in the checkout's
``build/colormipsearch_tpu_torch/`` directory (named by a hash of the
sources, so an edited source rebuilds), and loaded with ctypes. Every C entry point takes raw pointers and the CUDA stream as
``c_void_p`` and returns ``cudaGetLastError()``; :func:`check` turns a
non-zero code into an exception.

Nothing is built at import time: the CPU test hosts have no nvcc.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BUILD_DIR = os.path.join(_REPO, "build", "colormipsearch_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None
# seconds nvcc took in this process (0.0 when a built library was reused)
build_seconds = 0.0

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int
_F32 = ctypes.c_float
_SIGNATURES = {
    "cmst_pack_planes": [_P, _I64, _I64, _I64, _I32, _I32, _P, _P, _P, _P],
    "cmst_repack_planes": [_I32, _P, _I64, _I64, _P, _P, _P, _P],
    "cmst_banded_score": [_P, _I64, _P, _I32, _I32, _I32, _I32, _P, _P, _P,
                          _P, _P, _P, _P, _P, _I32, _F32, _F32, _I32, _P,
                          _P, _P, _P, _P],
    "cmst_banded_score_split": [_P, _P, _I64, _P, _I32, _I32, _I32, _I32, _P,
                                _P, _P, _P, _P, _P, _P, _P, _I32, _F32, _F32,
                                _P, _P, _P, _P, _P],
    "cmst_key_score": [_P, _I64, _P, _I32, _I32, _I32, _I32, _P, _P, _P, _P,
                       _P, _P],
    "cmst_scatter_keys": [_P, _P, _P, _P, _P, _I64, _I64, _I64, _P],
    "cmst_expand_tables": [_P, _I64, _P, _I64, _P, _I64, _P, _P, _I64, _P,
                           _I64, _I64, _I64, _I32, _I32, _P, _P, _P],
    "cmst_union_score": [_P, _I64, _P, _P, _I32, _I32, _P, _P, _I32, _I32,
                         _I32, _I32, _I32, _I32, _I32, _P, _P, _P, _P],
    "cmst_union_score_splitk": [_P, _P, _I64, _P, _P, _I32, _I32, _P, _P,
                                _I32, _I32, _I32, _I32, _I32, _I32, _I32, _P,
                                _P, _P, _P],
    "cmst_expand_qkeys": [_P, _P, _I64, _P, _P, _I64, _I64, _I64, _I64, _P,
                          _P, _P],
    "cmst_union_score_qkeys": [_P, _I64, _P, _P, _I32, _I32, _P, _P, _I64,
                               _P, _P, _I64, _I32, _I32, _I32, _I32, _I32,
                               _P, _P, _P, _P],
    "cmst_topk": [_P, _P, _P, _I32, _I64, _I32, _P, _P, _P, _P, _P],
    "cmst_mesh_finish": [_P, _P, _P, _I32, _I64, _I32, _I64, _I32, _P, _P,
                         _P, _P, _P, _P, _P],
    "cmst_mesh_reduce": [_P, _P, _I32, _I32, _P, _P, _P],
    "cmst_shape_dense": [_P, _P, _I32, _I64, _I64, _P, _P],
    "cmst_slice_numbers": [_P, _I64, _P, _P, _P, _I32, _P, _P],
    "cmst_shape_split": [_P, _P, _P, _P, _I32, _I64, _I64, _I64, _P, _P],
    "cmst_shape_tile": [_P, _P, _P, _I64, _P, _I64, _P, _P, _P, _P, _I32,
                        _I32, _I32, _I32, _I32, _P, _P, _P],
    "cmst_pixel_major": [_P, _I64, _I64, _P, _I64, _I64, _I32, _P],
}


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu"))
                  + glob.glob(os.path.join(_CSRC, "*.cuh")))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels of "
        "colormipsearch_tpu_torch are built on the GPU host at first use")


def library_path() -> str:
    digest = hashlib.sha256()
    for src in _sources():
        digest.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            digest.update(f.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libcmst_kernels.{digest.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the kernels if no library for the current sources exists;
    returns its path. Raises with nvcc's output when the build fails."""
    global build_seconds
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.tmp.{os.getpid()}"
    nvcc = _nvcc()
    t0 = time.time()
    # one nvcc per source, all at once: the build's time is the slowest
    # file's, not the sum
    jobs = []
    for src in (s for s in _sources() if s.endswith(".cu")):
        obj = f"{tmp}.{os.path.basename(src)}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", src, "-o", obj]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log = []
    failed = []
    for cmd, _, proc in jobs:
        out = proc.communicate()[0]
        log.append(f"$ {' '.join(cmd)}\n{out}")
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): "
                          f"{' '.join(cmd)}\n{out}")
    objs = [obj for _, obj, _ in jobs]
    try:
        if failed:
            raise RuntimeError("\n".join(failed))
        cmd = [nvcc, "-shared", "-o", tmp, *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{proc.stdout}\n"
                               f"{proc.stderr}")
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    os.replace(tmp, so)
    build_seconds = time.time() - t0
    # keep the ptxas report (registers, shared memory, spills) beside it
    with open(so + ".log", "w") as f:
        f.write("\n".join(log))
    return so


def load_library():
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.cmst_topk_max_cols.argtypes = []
            lib.cmst_topk_max_cols.restype = ctypes.c_int64
            lib.cmst_error_string.argtypes = [ctypes.c_int]
            lib.cmst_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def check(code: int, what: str) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if code != 0:
        message = load_library().cmst_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({message})")


# --- wrapper helpers ------------------------------------------------------
#
# Every wrapper validates its tensors before anything launches, and
# launches on the current stream of the tensors' device.


def check_tensor(x, name: str, dtype, shape: tuple | None = None) -> None:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(x)}")
    if x.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {x.dtype}")
    if shape is not None and tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def same_device(*xs) -> None:
    devices = {x.device for x in xs}
    if len(devices) != 1:
        raise ValueError(f"tensors on different devices: {devices}")


def require_cuda(x) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device} "
                         "(CPU tensors take the plain version)")


def stream_of(x) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)


# --- launch counters --------------------------------------------------
#
# One plain integer per kernel, incremented by its wrapper where it
# launches the kernel (never on the plain CPU path), so a run can show
# that the main path went through every kernel.

KERNELS = ("scatter_key_planes", "expand_union_tables_from_pos",
           "score_query_batch_union_keys", "union_keys_topk",
           "shape_score_pairs_split", "shape_tile_device",
           "upload_pixel_major", "pack_target_planes",
           "pack_target_planes_keys", "score_query_batch",
           "score_query_batch_keys", "pack_target_planes_split",
           "split_planes_from_packed", "key_planes_from_packed",
           "split_key_planes", "score_query_batch_split",
           "score_query_batch_union_keys_splitk", "expand_union_tables",
           "score_query_batch_union_qkeys", "shape_score_pairs",
           "slice_numbers_device", "mesh_finish", "mesh_reduce")
launches = dict.fromkeys(KERNELS, 0)
_count_lock = threading.Lock()


def count_launch(name: str) -> None:
    with _count_lock:
        launches[name] += 1


def reset_launches() -> None:
    with _count_lock:
        for name in launches:
            launches[name] = 0
