"""Int8 item-embedding quantization for the search index
(nann_tpu/index/quantize.py).

Symmetric per-row quantization, row = int8 * scale. The packed table holds
each row's int8 values and its float32 scale in one `[N, d+4]` int8 row (the
scale in the last 4 bytes, little-endian), so one gather fetches both: at
d = 64 a row is 68 bytes against 128 in bfloat16. Only gathered frontier rows
are dequantized, to the scorer's compute type; the frontier-scorer kernel
does it in registers (`kernels/frontier_scorer.py`).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def quantize_embeddings(embs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """fp32 [N, d] -> (int8 values [N, d], fp32 scales [N]).

    np.rint rounds half to even; values are clipped to +-127."""
    embs = np.asarray(embs, np.float32)
    amax = np.abs(embs).max(axis=1)
    scales = (amax / 127.0).astype(np.float32)
    safe = np.where(scales > 0, scales, 1.0)
    q = np.clip(np.rint(embs / safe[:, None]), -127, 127).astype(np.int8)
    return q, scales


def dequantize_rows(q_rows: torch.Tensor, scales: torch.Tensor,
                    dtype=torch.bfloat16) -> torch.Tensor:
    """int8 [..., d] + scales [...] -> dtype [..., d]: one float32 product,
    one rounding to `dtype`."""
    return (q_rows.float() * scales[..., None].float()).to(dtype)


def pack_quantized(embs: np.ndarray) -> torch.Tensor:
    """fp32 [N, d] -> packed int8 [N, d+4] (values + scale bytes), on the
    CPU."""
    q, scales = quantize_embeddings(embs)
    scale_bytes = scales.astype("<f4").view(np.int8).reshape(len(scales), 4)
    return torch.from_numpy(np.concatenate([q, scale_bytes], axis=1))


def unpack_rows(rows: torch.Tensor, dim: int, dtype=torch.bfloat16
                ) -> torch.Tensor:
    """Gathered packed rows [..., dim+4] -> dequantized [..., dim]."""
    q = rows[..., :dim]
    # the 4 scale bytes reinterpreted as one float32 (bitcast_convert_type)
    scales = rows[..., dim:].contiguous().view(torch.float32)[..., 0]
    return dequantize_rows(q, scales, dtype)


class QuantizedTable:
    """A row table in the packed layout: `take` gathers and dequantizes."""

    def __init__(self, embs: np.ndarray, device="cpu"):
        self.packed = pack_quantized(embs).to(device)
        self.dim = np.asarray(embs).shape[1]

    @property
    def shape(self):
        return self.packed.shape

    def take(self, ids: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
        rows = self.packed[ids.long()]
        return unpack_rows(rows, self.dim, dtype)
