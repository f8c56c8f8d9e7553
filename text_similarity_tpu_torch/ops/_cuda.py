"""Build and load the hand-written CUDA kernels under ``csrc/``.

At first use the ``.cu`` sources are compiled for Hopper (``sm_90a``) by
``nvcc`` — one process per source, started together — and linked into one
shared library with a plain C interface, loaded with ``ctypes``. The
library lands in ``text_similarity_tpu_torch/_build/`` (git-ignored), named
by a hash of the sources and flags, so an unchanged tree reuses it and an
edited one rebuilds. Nothing is built when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("topk.cu", "ivf_scan.cu", "ivf_tile.cu", "ivf_modes.cu", "flash_fwd.cu", "flash_bwd.cu",
           "packed_attention.cu", "topk_2pass.cu", "topk_select.cu")
HEADERS = ("common.cuh", "flash_common.cuh", "hopper.cuh", "score_tile.cuh", "ivf_tile.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_lib = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    # q, corpus, corpus_bf16, Q, N, D, k, splits, rows_per_split,
    # part_s, part_i, out_s, out_i, stream
    "ts_cosine_topk": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    # q, corpus (int8), scales, Q, N, D, k, splits, rows_per_split,
    # part_s, part_i, out_s, out_i, stream
    "ts_cosine_topk_int8": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    # q, probes, data, data_bf16, ids, B, D, U, C_tot, Mc, block_q, k,
    # width, slots, part_s, part_i, out_s, out_i, stream
    "ts_ivf_scan": [_P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                    _P, _P, _P, _P, _P],
    # q, probes, data (int8), scales, ids, B, D, U, C_tot, Mc, block_q, k,
    # width, slots, part_s, part_i, out_s, out_i, stream
    "ts_ivf_scan_int8": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                         _P, _P, _P, _P, _P],
    # data_kind (0 f32, 1 bf16, 2 int8, 3 bf16 sentinel rows, idless), D, Mc,
    # block_q, k, width, slots, out (5 ints: nq, nwg, n, stages, shared
    # bytes), max_stages (0: the tile's own) → 1 where the wgmma tile runs
    "ts_ivf_scan_tile_plan": [_I, _I, _I, _I, _I, _I, _I, _P, _I],
    # q, probes, data, data_kind (0 f32, 1 bf16, 2 int8), scales (or NULL),
    # ids, B, D, U, C_tot, Mc, block_q, k, part_s, part_i, out_s, out_i, stream
    "ts_ivf_scan_per_probe": [_P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                              _P, _P, _P, _P, _P],
    # q, probes, data, data_kind, scales, ids, B, D, U, C_tot, Mc, block_q,
    # width, slots, out_s, out_i, stream
    "ts_ivf_scan_emit_acc": [_P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                             _P, _P, _P],
    # q, probes, data, data_bf16, zero_tiles (or NULL), counts (or NULL), B,
    # D, U, C_tot, Mc, block_q, k, width, part_s, part_i, out_s, out_i, stream
    "ts_ivf_scan_idless": [_P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                           _P, _P, _P, _P, _P],
    # q, probes, data, data_bf16, ids, B, D, U, C_tot, Mc, block_q, k, width,
    # slots, part_s, part_i, sel_s, sel_i, out_p, stream
    "ts_ivf_scan_packed": [_P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                           _P, _P, _P, _P, _P, _P],
    # s, ids, U, R, Mc, w, out, stream
    "ts_ivf_pack_classes": [_P, _P, _I, _I, _I, _I, _P, _P],
    # q, probes, data, data_bf16, ids, B, D, U, C_tot, Mc, block_q, k,
    # slots, n_buf, part_s, part_i, out_s, out_i, stream
    "ts_ivf_scan_dma": [_P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                        _P, _P, _P, _P, _P],
    # q, probes, data, data_kind, scales, ids, B, D, U, P, C_tot, Mc,
    # block_q, k, part_s, part_i, out_s, out_i, stream
    "ts_ivf_scan_multiprobe": [_P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                               _P, _P, _P, _P, _P],
    # q, k, v, out, lse (or NULL), lengths, bf16, B, S, H, D,
    # q/k/v strides (batch, token, head) in elements, window, global_cls,
    # scale, stream
    "ts_flash_fwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                     _L, _L, _L, _L, _L, _L, _L, _L, _L, _I, _I, _F, _P],
    # q, k, v, do, out, lse, di (written by dq, read by dk/dv), dq,
    # lengths, bf16, B, S, H, D, strides (15 int64: q/k/v/do/out batch,
    # token, head), window, global_cls, scale, stream
    "ts_flash_bwd_dq": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                        _P, _I, _I, _F, _P],
    # the same with dk, dv in place of dq
    "ts_flash_bwd_dkv": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                         _P, _I, _I, _F, _P],
    # q, k, v, out, lengths, bf16, B, S, H, D, q/k/v strides (batch,
    # token, head) in elements, scale, stream
    "ts_packed_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                            _L, _L, _L, _L, _L, _L, _L, _L, _L, _F, _P],
    # bf16, S → 1 where ts_packed_attention runs the one-sweep kernel
    "ts_packed_attention_one_sweep": [_I, _I],
    # q, corpus, corpus_bf16, Q, N, D, k, block_c, splits, blocks_per_split,
    # win_s, win_i, out_s, out_i, stream
    "ts_topk_2pass_fold": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    # q, corpus, corpus_bf16, thr, Q, N, D, splits, rows_per_split, cnt, stream
    "ts_topk_2pass_count": [_P, _P, _I, _P, _I, _I, _I, _I, _I, _P, _P],
    # the fold's arguments, then scores (Q, ld) f32 and ld, then stream
    "ts_topk_2pass_fold_scores": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P,
                                  _P, _I, _P],
    # scores, ld, thr, Q, N, cnt, stream
    "ts_topk_2pass_count_scores": [_P, _I, _P, _I, _I, _P, _P],
    # q, corpus, corpus_bf16, Q, N, D, k_sel, block_c, splits,
    # blocks_per_split, win_s, win_i, cls_s, cls_i, out_s, out_i, work,
    # work_bytes, scores (or NULL), ld, stream
    "ts_topk_2pass_fold_large": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P,
                                 _P, _P, _P, _L, _P, _I, _P],
    # scores, ids (or NULL), R, n, seg_len, seg_stride, row_stride, k,
    # out_s, out_i, work, work_bytes, int_keys, stream
    "ts_topk_select": [_P, _P, _I, _I, _I, _L, _L, _I, _P, _P, _P, _L, _I, _P],
    # q, corpus, corpus_kind (0 f32, 1 bf16, 2 int8), scales (or NULL), Q,
    # N, D, k, splits, rows_per_split, scores, ld, out_s, out_i, work,
    # work_bytes, stream
    "ts_topk_large": [_P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _P, _I, _P, _P, _P, _L, _P],
}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Path:
    """Compile the kernels (if the hashed library is missing) → its path."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    target = BUILD_DIR / f"libts_kernels_{_digest()}.so"
    if target.exists():
        return target
    nvcc = nvcc_path()
    extra = ["-Xptxas", "-v"] if verbose else []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in SOURCES:
            obj = os.path.join(tmp, src + ".o")
            cmd = [nvcc, *NVCC_FLAGS, *extra, "-c", str(CSRC / src), "-o", obj]
            procs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )))
        objs = []
        for cmd, obj, proc in procs:
            out, _ = proc.communicate()
            if verbose and out:
                print(out)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{out}")
            objs.append(obj)
        tmp_so = os.path.join(tmp, target.name)
        link = [nvcc, *NVCC_FLAGS, "-shared", *objs, "-o", tmp_so]
        res = subprocess.run(link, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{res.stdout}{res.stderr}")
        os.replace(tmp_so, target)   # atomic: concurrent builders agree
    return target


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
        return _lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def require_cuda(t: torch.Tensor, name: str, dtypes, ndim: int) -> None:
    """The checks every kernel wrapper makes on a tensor it hands over."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")
