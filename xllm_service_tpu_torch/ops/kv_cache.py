"""Paged KV cache (PyTorch port of xllm_service_tpu/ops/kv_cache.py).

The pool is one tensor per cache, `[..., N, Hkv, BS, D]` in the model
dtype, the JAX package's unpacked layout. Block 0 is the reserved garbage
block: masked writes (padding tokens, inactive slots) land there and no
attention path reads it as context. Not ported: the packed-pair rows
(`kv_pack_factor`, a TPU 128-lane artifact) and the int8 pool.

Writes are IN PLACE (JAX returns a new array; the port mutates the pool to
avoid a second copy of it) and return the cache for call-site parity.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def alloc_cache(shape: Tuple[int, ...], dtype: torch.dtype,
                device: torch.device, quantized: bool = False) -> torch.Tensor:
    """A zeroed pool [..., N, H, BS, D]."""
    if quantized:
        raise NotImplementedError("the int8 KV cache is not ported yet")
    return torch.zeros(shape, dtype=dtype, device=device)


def scatter_rows(cache: torch.Tensor, blk: torch.Tensor, offset: torch.Tensor,
                 rows: torch.Tensor) -> torch.Tensor:
    """Write per-token rows [T, Hkv, D] into slots (blk[t], offset[t]) of
    one layer's cache [N, Hkv, BS, D]."""
    cache[blk.long(), :, offset.long()] = rows.to(cache.dtype)
    return cache


def set_blocks(cache: torch.Tensor, ids: torch.Tensor,
               blocks: torch.Tensor) -> torch.Tensor:
    """Write whole blocks [L, P, Hkv, BS, D] at block ids of a stacked pool
    [L, N, Hkv, BS, D]."""
    cache[:, ids.long()] = blocks.to(cache.dtype)
    return cache


def gather_blocks(cache: torch.Tensor, block_table: torch.Tensor,
                  dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Blocks of a table of any shape [...B] -> [...B, Hkv, BS, D]."""
    out = cache[block_table.long()]
    return out if dtype is None else out.to(dtype)
