"""EmbeddingStore: the device-resident corpus embedding matrix (port of
``text_similarity_tpu.index.store``).

Fixed capacity, append in place, deletion by tombstone mask, npz
save/load in the JAX package's format (bf16 rows persist as a uint16 bit
view plus a ``data_dtype`` tag). Rows are f32/bf16, or int8 with per-row
f32 scales (``quantized=True``, searched by kernel K3); the scales persist
beside the codes.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np
import torch

from ..compress.quantize import quantize_embeddings_int8
from ..core.precision import resolve_device


def bf16_to_bits(t: torch.Tensor) -> np.ndarray:
    """A bf16 tensor → its uint16 bit pattern as numpy (np.savez cannot
    hold bf16)."""
    return t.detach().cpu().view(torch.int16).numpy().view(np.uint16)


def bits_to_bf16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)


class EmbeddingStore:
    """Append-only (plus tombstones) embedding matrix on ``device``;
    ``quantized=True`` keeps int8 rows plus (capacity,) f32 scales."""

    def __init__(
        self, capacity: int, dim: int, dtype=torch.float32,
        quantized: bool = False, device="cuda",
    ):
        self.device = resolve_device(device)
        self.capacity = capacity
        self.dim = dim
        self.quantized = quantized
        self.data = torch.zeros(
            (capacity, dim), dtype=torch.int8 if quantized else dtype, device=self.device
        )
        self.scales = (
            torch.ones((capacity,), dtype=torch.float32, device=self.device)
            if quantized else None
        )
        self.alive = torch.zeros((capacity,), dtype=torch.bool, device=self.device)
        self.size = 0

    def add(self, embeddings) -> np.ndarray:
        """Append rows (an int8 store quantizes them per row); returns
        their assigned ids."""
        rows = torch.as_tensor(embeddings).to(self.device)
        n = rows.shape[0]
        if self.size + n > self.capacity:
            raise ValueError(
                f"store full: {self.size}+{n} > {self.capacity}; "
                "create with larger capacity or grow()"
            )
        if self.quantized:
            rows, scales = quantize_embeddings_int8(rows)
            self.scales[self.size:self.size + n] = scales
        self.data[self.size:self.size + n] = rows.to(self.data.dtype)
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
        if self.scales is not None:
            self.scales = torch.cat([
                self.scales, torch.ones((pad,), dtype=torch.float32, device=self.device),
            ])
        self.capacity = new_capacity

    @property
    def scales_view(self):
        """(size,) per-row scales of an int8 store, else None."""
        return self.scales[: self.size] if self.scales is not None else None

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
        if self.quantized:
            extra["scales"] = self.scales_view.cpu().numpy()
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
            quantized=self.quantized,
            **extra,
        )

    @classmethod
    def load(cls, path: str, dtype=torch.float32, device="cuda") -> "EmbeddingStore":
        if not os.path.exists(path) and os.path.exists(path + ".npz"):
            path = path + ".npz"   # np.savez appends the suffix
        with np.load(path) as z:
            alive = z["alive"]
            capacity = int(z["capacity"])
            quantized = bool(z["quantized"]) if "quantized" in z.files else False
            scales = z["scales"] if "scales" in z.files else None
            if "data_dtype" in z.files and str(z["data_dtype"]) == "bfloat16":
                data = bits_to_bf16(z["data"])
                dtype = torch.bfloat16
            else:
                data = torch.from_numpy(np.asarray(z["data"]))
        store = cls(capacity, data.shape[1], dtype, quantized=quantized, device=device)
        n = data.shape[0]
        # codes and scales go in as saved (add() would quantize again)
        store.data[:n] = data.to(store.device, store.data.dtype)
        if quantized and scales is not None:
            store.scales[:n] = torch.from_numpy(np.asarray(scales)).to(store.device)
        store.alive[:n] = True
        store.size = n
        if not alive.all():
            store.alive[: data.shape[0]] = torch.as_tensor(alive).to(store.device)
        return store
