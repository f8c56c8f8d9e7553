"""Long-context conversion of an encoder's parameters (port of
``extend_positions`` in ``text_similarity_tpu.models.hf_convert``).

The HuggingFace state-dict mapping of that module is not ported yet.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..compress.quantize import _is_q
from ..core.config import EncoderArch


def extend_positions(params: dict, arch: EncoderArch, new_max: int) -> Tuple[dict, EncoderArch]:
    """Tile the learned position embeddings out to ``new_max`` positions
    (the reference's Longformer conversion: copy the position table k
    times). The first ``arch.position_offset`` rows (RoBERTa's padding
    offset) are kept once, the body rows repeat, and the table is cut to
    ``new_max``. → (params with the new table, arch with ``max_position =
    new_max``); unchanged when ``new_max`` is not larger. Extend before
    quantizing: an int8 table raises."""
    emb = params["embeddings"]["position"]
    if _is_q(emb):
        raise TypeError("extend_positions needs a float position table; extend before to_int8")
    old_max = emb.shape[0]
    if new_max <= old_max:
        return params, arch
    reps = -(-new_max // old_max)
    offset = arch.position_offset
    tiled = torch.cat([emb[:offset]] + [emb[offset:]] * reps, dim=0)[:new_max]
    new_params = dict(params)
    new_params["embeddings"] = dict(params["embeddings"])
    new_params["embeddings"]["position"] = tiled
    return new_params, arch.replace(max_position=new_max)
