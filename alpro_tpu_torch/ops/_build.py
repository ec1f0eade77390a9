"""Build and load the port's CUDA kernels (``alpro_tpu_torch/csrc/*.cu``).

Each source is compiled by its own ``nvcc`` process, all started together,
and the objects are linked into one shared library with a plain C interface,
loaded with ``ctypes``. Nothing here runs at import: the build
happens at the first kernel launch (or an explicit ``build()``), into
``alpro_tpu_torch/_build/<hash>/``, keyed by a hash of the sources and the
flags, so an edited source rebuilds and an unchanged one loads the cached
library. The library is written under a temporary name and renamed into
place, so concurrent processes never load a half-written file.

Every C entry point returns ``cudaGetLastError()`` after its launch;
``check`` raises on a non-zero code (a refused launch — too many threads or
too much shared memory — never runs, and a later synchronize would not
report it).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
LIB_NAME = "libalpro_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_int64
# C signature of every entry point: (argtypes, restype)
_SIGNATURES = {
    # qkv, out, M, S, H, hd, scale, is_bf16, device, stream
    "alpro_spatial_attn": ([_P, _P, _I, _I, _I, _I, _F, _I, _I, _P], _I),
    # S, hd, is_bf16, device
    "alpro_spatial_attn_smem": ([_I, _I, _I, _I], _I),
    # qkv, out, B, T, N, H, hd, scale, is_bf16, device, stream
    "alpro_temporal_attn": ([_P, _P, _I, _I, _I, _I, _I, _F, _I, _I, _P], _I),
    # T, hd, is_bf16, device
    "alpro_temporal_attn_smem": ([_I, _I, _I, _I], _I),
    # x, ln_scale, ln_bias, w1, b1, w2, b2, out, partial, hidden, normed, R, D,
    # Dh, h_split, eps, residual, is_bf16, device, stream
    "alpro_ln_mlp": ([_P] * 11 + [_I, _I, _I, _I, _F, _I, _I, _I, _P], _I),
    # x, w1, b1, w2, b2, ln_scale, ln_bias, out, partial, hidden, R, D, Dh,
    # h_split, eps, is_bf16, device, stream
    "alpro_bert_mlp": ([_P] * 10 + [_I, _I, _I, _I, _F, _I, _I, _P], _I),
    # x, mask, wq, bq, wk, bk, wv, bv, wo, bo, ln_scale, ln_bias, qkv, heads,
    # partial, out, M, S, H, q_split, k_split, scale, eps, is_bf16, vec_bf16,
    # device, stream
    "alpro_bert_attn": ([_P] * 16 + [_I] * 5 + [_F, _F, _I, _I, _I, _P], _I),
    # is_bf16, device
    "alpro_bert_attn_max_seq": ([_I, _I], _I),
    # q, k, v, bias, out, strides (12 int64: the byte strides of the sequence,
    # head and batch axes of q, k, v, out), B, H, Sq, Sk, hd, scale, is_bf16,
    # device, stream
    "alpro_masked_attn": ([_P] * 6 + [_I] * 5 + [_F, _I, _I, _P], _I),
    # Sk, hd, is_bf16, device
    "alpro_masked_attn_smem": ([_I, _I, _I, _I], _I),
    # x, ln_scale, ln_bias, w, b, xn (scratch), out, R, D, F, eps, is_bf16,
    # vec_bf16, device, stream
    "alpro_ln_matmul": ([_P] * 7 + [_I, _I, _I, _F, _I, _I, _I, _P], _I),
    # raw, kernel, bias, rows (scratch), out, frames, H, W, p, D, mean (3),
    # std (3), is_bf16, vec_bf16, device, stream
    "alpro_patchify_embed": ([_P] * 5 + [_I] * 5 + [_F] * 6 + [_I, _I, _I, _P], _I),
    # x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj, scratch, out, M, S, H,
    # q_split, scale, eps, residual, is_bf16, vec_bf16, device, stream
    "alpro_fused_spatial_block": ([_P] * 9 + [_I] * 4 + [_F, _F, _I, _I, _I, _I, _P], _I),
    # S, is_bf16, device
    "alpro_fused_spatial_smem": ([_I, _I, _I], _I),
    # x, ln_scale, ln_bias, wqkv, bqkv, w_eff, b_eff, scratch, out, B, T, N, H,
    # hd, scale, eps, is_bf16, vec_bf16, device, stream
    "alpro_fused_temporal_block": ([_P] * 9 + [_I] * 5 + [_F, _F, _I, _I, _I, _P], _I),
    # qkv_x, qkv_c, out_x, out_c, M, N, T, H, hd, scale, is_bf16, device, stream
    "alpro_spatial_cls_attn": ([_P] * 4 + [_I] * 5 + [_F, _I, _I, _P], _I),
    # qkv, wproj, bproj, heads, out, M, S, H, q_split, scale, is_bf16,
    # vec_bf16, device, stream
    "alpro_spatial_qkv_proj": ([_P] * 5 + [_I] * 4 + [_F, _I, _I, _I, _P], _I),
    # S, is_bf16, device
    "alpro_spatial_qkv_proj_smem": ([_I, _I, _I], _I),
    # qkv, w_eff, b_eff, heads, out, B, T, N, H, hd, scale, is_bf16, vec_bf16,
    # device, stream
    "alpro_temporal_qkv_proj": ([_P] * 5 + [_I] * 5 + [_F, _I, _I, _I, _P], _I),
    # x, scale, bias, out, R, D, eps, in_bf16, out_bf16, device, stream
    "alpro_layernorm": ([_P] * 4 + [_I, _I, _F, _I, _I, _I, _P], _I),
    # x, wqkv, bqkv, wproj, bproj, key mask, scratch, out, B, S, H, q_split,
    # scale, is_bf16, device, stream
    "alpro_block_attn": ([_P] * 8 + [_I] * 4 + [_F, _I, _I, _P], _I),
    # a, w, bias, outputs (array of 5 pointers), M, N, K, split, device, stream
    "alpro_gemm_bf16": ([_P] * 4 + [_I] * 5 + [_P], _I),
    # is_bf16, device
    "alpro_block_attn_max_seq": ([_I, _I], _I),
    # h, g, n, is_bf16, device, stream
    "alpro_gelu_fwd": ([_P, _P, _L, _I, _I, _P], _I),
    # h, dg, dh, n, is_bf16, device, stream
    "alpro_gelu_bwd": ([_P, _P, _P, _L, _I, _I, _P], _I),
    "alpro_error_string": ([_I], ctypes.c_char_p),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def sources() -> list:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    cands = [os.environ.get("CUDACXX")]
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if home:
            cands.append(os.path.join(home, "bin", "nvcc"))
    cands.append(shutil.which("nvcc"))
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked at $CUDACXX, $CUDA_HOME/bin, /usr/local/cuda/bin "
        "and PATH): the CUDA kernels cannot be built"
    )


def _run(procs) -> None:
    """Wait for every (cmd, process); then raise on the failed ones."""
    failed = []
    for cmd, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}\n{err}")
    if failed:
        raise RuntimeError("\n".join(failed))


def build() -> Path:
    """Compile csrc/*.cu, one nvcc process per source all at once, and link
    them into one .so (cached by source hash); returns its path."""
    out_dir = BUILD_ROOT / source_hash()
    lib_path = out_dir / LIB_NAME
    if lib_path.is_file():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc, tag = find_nvcc(), f"{os.getpid()}.tmp"
    objs, procs = [], []
    for src in (p for p in sources() if p.suffix == ".cu"):
        obj = out_dir / f".{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(obj), str(src)]
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.PIPE, text=True)))
        objs.append(obj)
    _run(procs)
    tmp = out_dir / f".{LIB_NAME}.{tag}"
    cmd = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
    _run([(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                 text=True))])
    for obj in objs:
        obj.unlink()
    os.replace(tmp, lib_path)
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = handle
        return _lib


def check_cuda_operand(t, name: str, dtypes, align: int = 16) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of one of ``dtypes``
    whose data pointer is ``align``-byte aligned (the kernels use vector and
    tensor-core loads)."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{name}: data pointer not {align}-byte aligned")


@functools.lru_cache(maxsize=None)
def smem_optin(device) -> int:
    """The shared memory (bytes) a block may opt in to on CUDA ``device``:
    the figure the kernels' limit predicates take (232,448 on an H100).
    Cached: a wrapper reads it on every call."""
    import torch

    return torch.cuda.get_device_properties(device).shared_memory_per_block_optin


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    """The number of SMs of CUDA ``device`` (132 on an H100 SXM), cached."""
    import torch

    return torch.cuda.get_device_properties(device).multi_processor_count


def f32_vectors(name: str, vecs: dict) -> tuple:
    """A kernel's bias and LN vectors as contiguous fp32 CUDA tensors (no
    copy where they already are)."""
    import torch

    out = []
    for key, v in vecs.items():
        v = v.float().contiguous()
        check_cuda_operand(v, f"{name} {key}", (torch.float32,), align=4)
        out.append(v)
    return tuple(out)


def layer_vectors(name: str, x, vecs: dict) -> tuple:
    """(vectors, vec_bf16) for a kernel that takes a layer's bias and LN
    vectors: where x and every vector are bf16, the vectors as they are (the
    kernel widens them on load, which is exact: no cast launch per call),
    vec_bf16 1; else ``f32_vectors`` (exact for every bf16 value), vec_bf16
    0."""
    import torch

    if x.dtype == torch.bfloat16 and all(v.dtype == torch.bfloat16 for v in vecs.values()):
        for key, v in vecs.items():
            check_cuda_operand(v, f"{name} {key}", (torch.bfloat16,), align=2)
        return tuple(vecs.values()), 1
    return f32_vectors(name, vecs), 0


def stream_args(t) -> tuple:
    """(device index, raw handle of the current stream) for a launch on
    ``t``'s device: what ``torch.cuda.current_stream(device).cuda_stream``
    gives, without building a ``torch.cuda.Stream`` per call. Under
    ``torch.cuda.stream(s)`` or a CUDA-graph capture it is that stream."""
    import torch

    dev = t.get_device()
    return dev, torch._C._cuda_getCurrentRawStream(dev)


def refuse_grad(name: str, *tensors) -> None:
    """Raise if autograd would need a gradient through a kernel that has
    none (its JAX counterpart runs only at serving): grad mode on and any
    input requiring grad."""
    import torch

    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} has no backward (a serving kernel): call it under torch.no_grad() or "
            f"torch.inference_mode(), or take the plain path for training"
        )


def check(err: int, name: str) -> None:
    if err != 0:
        msg = lib().alpro_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA launch failed with error {err} ({msg})")
