"""EmbeddingStore: the device-resident corpus embedding matrix (port of
``text_similarity_tpu.index.store``).

Fixed capacity, append in place, deletion by tombstone mask, npz
save/load in the JAX package's format (bf16 rows persist as a uint16 bit
view plus a ``data_dtype`` tag). The int8 store is not ported yet.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np
import torch

from ..core.precision import resolve_device


def bf16_to_bits(t: torch.Tensor) -> np.ndarray:
    """A bf16 tensor → its uint16 bit pattern as numpy (np.savez cannot
    hold bf16)."""
    return t.detach().cpu().view(torch.int16).numpy().view(np.uint16)


def bits_to_bf16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)


class EmbeddingStore:
    """Append-only (plus tombstones) embedding matrix on ``device``."""

    def __init__(
        self, capacity: int, dim: int, dtype=torch.float32,
        quantized: bool = False, device="cuda",
    ):
        if quantized:
            raise NotImplementedError(
                "the int8 store is not ported yet (ROADMAP queue 1: int8 serving)"
            )
        self.device = resolve_device(device)
        self.capacity = capacity
        self.dim = dim
        self.quantized = False
        self.data = torch.zeros((capacity, dim), dtype=dtype, device=self.device)
        self.alive = torch.zeros((capacity,), dtype=torch.bool, device=self.device)
        self.size = 0

    def add(self, embeddings) -> np.ndarray:
        """Append rows; returns their assigned ids."""
        rows = torch.as_tensor(embeddings).to(self.device, self.data.dtype)
        n = rows.shape[0]
        if self.size + n > self.capacity:
            raise ValueError(
                f"store full: {self.size}+{n} > {self.capacity}; "
                "create with larger capacity or grow()"
            )
        self.data[self.size:self.size + n] = rows
        self.alive[self.size:self.size + n] = True
        ids = np.arange(self.size, self.size + n)
        self.size += n
        return ids

    def mark_deleted(self, ids: Sequence[int]) -> int:
        """Tombstone the given row ids; returns how many were alive."""
        idx = torch.as_tensor(np.asarray(list(ids), dtype=np.int64), device=self.device)
        n_alive = int(self.alive[idx].sum())
        self.alive[idx] = False
        return n_alive

    def grow(self, new_capacity: int) -> None:
        if new_capacity < self.capacity:
            raise ValueError("can only grow")
        pad = new_capacity - self.capacity
        self.data = torch.cat([
            self.data,
            torch.zeros((pad, self.dim), dtype=self.data.dtype, device=self.device),
        ])
        self.alive = torch.cat([
            self.alive, torch.zeros((pad,), dtype=torch.bool, device=self.device),
        ])
        self.capacity = new_capacity

    @property
    def view(self) -> torch.Tensor:
        """(size, dim) view of the filled prefix."""
        return self.data[: self.size]

    @property
    def alive_view(self) -> torch.Tensor:
        return self.alive[: self.size]

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        extra = {}
        if self.data.dtype == torch.bfloat16:
            extra["data_dtype"] = "bfloat16"
            data = bf16_to_bits(self.view)
        else:
            data = self.view.cpu().numpy()
        np.savez(
            path,
            data=data,
            alive=self.alive_view.cpu().numpy(),
            capacity=self.capacity,
            quantized=False,
            **extra,
        )

    @classmethod
    def load(cls, path: str, dtype=torch.float32, device="cuda") -> "EmbeddingStore":
        if not os.path.exists(path) and os.path.exists(path + ".npz"):
            path = path + ".npz"   # np.savez appends the suffix
        with np.load(path) as z:
            if "quantized" in z.files and bool(z["quantized"]):
                raise NotImplementedError(
                    "int8 stores are not ported yet (ROADMAP queue 1: int8 serving)"
                )
            alive = z["alive"]
            capacity = int(z["capacity"])
            if "data_dtype" in z.files and str(z["data_dtype"]) == "bfloat16":
                data = bits_to_bf16(z["data"])
                dtype = torch.bfloat16
            else:
                data = torch.from_numpy(np.asarray(z["data"]))
        store = cls(capacity, data.shape[1], dtype, device=device)
        store.add(data)
        if not alive.all():
            store.alive[: data.shape[0]] = torch.as_tensor(alive).to(store.device)
        return store
