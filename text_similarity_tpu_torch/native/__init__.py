"""The host runtime's C code, bound with ctypes: the WordPiece matcher
(``wordpiece.c``, of which the port binds the whole padded batch split over
pthreads) and the first-fit-decreasing placement of sequence packing
(``pack.c``). Both sources are copies of the JAX package's and stay
byte-exact with the port's Python paths (``data.tokenization``,
``data.packing._ffd_place_py``).

At first use the two sources are compiled with ``cc`` into one shared
library in ``text_similarity_tpu_torch/_build/`` (git-ignored), named by a
hash of the sources and flags, as ``ops._cuda`` names the CUDA library.
Each builder writes its own temporary file and renames it into place, so
processes that build at once never share a half-written file. A build that
fails raises with the compiler's output; nothing falls back to Python.
Nothing is built when the module is imported.

Text that does not encode as UTF-8 (a lone surrogate) crosses as its
``surrogatepass`` bytes, which are all non-ASCII: the batch call flags such
a row for the Python path, as it flags every row with a non-ASCII byte.
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
from typing import Sequence

import numpy as np

_HERE = Path(__file__).resolve().parent
BUILD_DIR = _HERE.parent / "_build"
SOURCES = ("wordpiece.c", "pack.c")
CFLAGS = ("-O3", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_lib = None

_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)
_SIGNATURES = {
    # tokens_buf, offsets (n + 1), n, unk_id, max_token_chars → handle
    "wp_create": (ctypes.c_void_p, [ctypes.c_char_p, _I64P, ctypes.c_int64, ctypes.c_int32,
                                    ctypes.c_int32]),
    "wp_free": (None, [ctypes.c_void_p]),
    # handle, buf, doc_offsets, n_docs, max_len, lowercase, max_word_chars,
    # cls, sep, pad, out_ids, out_mask, out_lens, needs_python, n_threads
    "wp_encode_batch": (ctypes.c_int64, [ctypes.c_void_p, ctypes.c_char_p, _I64P,
                                         ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
                                         ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                                         ctypes.c_int32, _I32P, _I32P, _I32P,
                                         ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32]),
    # lens, n, width, out_row, out_slot, out_off → rows (−1: out of memory)
    "ffd_place": (ctypes.c_int64, [_I32P, ctypes.c_int64, ctypes.c_int32, _I32P, _I32P,
                                   _I32P]),
}


def _utf8(text: str) -> bytes:
    return text.encode("utf-8", "surrogatepass")


def _digest() -> str:
    h = hashlib.sha256(" ".join(CFLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((_HERE / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the library (if the hashed one is missing) → its path.
    Raises with the compiler's output when ``cc`` is missing or fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    target = BUILD_DIR / f"libts_native_{_digest()}.so"
    if target.exists():
        return target
    cc = shutil.which("cc")
    if cc is None:
        raise RuntimeError("no C compiler: `cc` is not on PATH (the native tokenizer and "
                           "packer build with it)")
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, prefix=target.stem + ".", suffix=".tmp")
    os.close(fd)
    try:
        cmd = [cc, *CFLAGS, "-o", tmp, *(str(_HERE / s) for s in SOURCES)]
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if res.returncode != 0:
            raise RuntimeError(f"cc failed ({' '.join(cmd)}):\n{res.stdout}{res.stderr}")
        os.replace(tmp, target)   # atomic: concurrent builders agree
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return target


def get_lib() -> ctypes.CDLL:
    """The loaded native library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.restype = restype
                fn.argtypes = argtypes
            _lib = handle
        return _lib


def ffd_place_native(lens: np.ndarray, width: int):
    """First-fit placement in C (``pack.c``) of lengths already in placement
    (longest-first) order → (n_rows, row, slot, offset), the same arrays as
    ``data.packing._ffd_place_py``."""
    lib = get_lib()
    lens = np.ascontiguousarray(lens, np.int32)
    n = len(lens)
    out_row = np.empty(n, np.int32)
    out_slot = np.empty(n, np.int32)
    out_off = np.empty(n, np.int32)
    r = lib.ffd_place(
        lens.ctypes.data_as(_I32P), n, int(width),
        out_row.ctypes.data_as(_I32P), out_slot.ctypes.data_as(_I32P),
        out_off.ctypes.data_as(_I32P),
    )
    if r < 0:
        raise MemoryError("ffd_place: allocation failed")
    return int(r), out_row, out_slot, out_off


def _offsets(parts: Sequence[bytes]) -> np.ndarray:
    offsets = np.zeros(len(parts) + 1, np.int64)
    np.cumsum([len(p) for p in parts], out=offsets[1:])
    return offsets


class NativeWordPiece:
    """Greedy longest-match-first WordPiece over a fixed vocab, in C.

    The C side numbers the tokens by position; ``vocab`` ids need not be
    dense (a remap turns positions back into ids)."""

    def __init__(self, vocab: dict, unk_id: int, max_word_chars: int = 100):
        self._lib = get_lib()
        tokens = [_utf8(t) for t in vocab]
        ids = list(vocab.values())
        order = sorted(range(len(tokens)), key=lambda i: ids[i])
        self._id_remap = np.asarray([ids[i] for i in order], np.int32)
        toks_sorted = [tokens[i] for i in order]
        offsets = _offsets(toks_sorted)
        self._dense = bool((self._id_remap == np.arange(len(ids))).all())
        self._h = self._lib.wp_create(      # copies the token bytes
            b"".join(toks_sorted), offsets.ctypes.data_as(_I64P), len(toks_sorted),
            self._local(unk_id), max_word_chars,
        )
        if not self._h:
            raise MemoryError("wp_create failed")

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.wp_free(h)
            self._h = None

    def _local(self, gid: int) -> int:
        """A vocab id → its position on the C side."""
        return int(gid) if self._dense else int(np.searchsorted(self._id_remap, gid))

    def _global(self, ids: np.ndarray) -> np.ndarray:
        return ids if self._dense else self._id_remap[ids]

    def encode_batch_padded(
        self,
        texts: Sequence[str],
        max_len: int,
        cls_id: int,
        sep_id: int,
        pad_id: int,
        lowercase: bool = True,
        max_word_chars: int = 100,
        n_threads: int = 0,
    ):
        """Split + WordPiece + [CLS]/[SEP]/padding of a whole batch in one
        pthread-parallel C call → (ids (N, max_len) int32, mask (N,
        max_len) int32, lens (N,) int32, needs_python (N,) bool). A row with
        any non-ASCII byte is left padded and flagged for the caller's
        full-Unicode Python path; every other row is byte-exact with it."""
        n = len(texts)
        if max_len < 2:
            raise ValueError("max_len must be >= 2 ([CLS] + [SEP])")
        if n == 0:
            z = np.zeros((0, max_len), np.int32)
            return z, z.copy(), np.zeros(0, np.int32), np.zeros(0, bool)
        enc = [_utf8(t) for t in texts]
        buf = b"".join(enc)
        offs = _offsets(enc)
        out_ids = np.empty((n, max_len), np.int32)
        out_mask = np.empty((n, max_len), np.int32)
        out_lens = np.empty(n, np.int32)
        needs_py = np.empty(n, np.uint8)
        if n_threads <= 0:
            n_threads = min(8, os.cpu_count() or 1)
        r = self._lib.wp_encode_batch(
            self._h, buf, offs.ctypes.data_as(_I64P), n, max_len, 1 if lowercase else 0,
            max_word_chars, self._local(cls_id), self._local(sep_id), self._local(pad_id),
            out_ids.ctypes.data_as(_I32P), out_mask.ctypes.data_as(_I32P),
            out_lens.ctypes.data_as(_I32P), needs_py.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            n_threads,
        )
        if r == -1 and n_threads > 1:
            # no thread could be spawned: the one-thread path runs inline
            return self.encode_batch_padded(
                texts, max_len, cls_id, sep_id, pad_id, lowercase=lowercase,
                max_word_chars=max_word_chars, n_threads=1,
            )
        if r < 0:
            raise RuntimeError(f"wp_encode_batch failed ({r})")
        return self._global(out_ids), out_mask, out_lens, needs_py.astype(bool)
