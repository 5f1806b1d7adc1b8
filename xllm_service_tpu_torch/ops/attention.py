"""Paged attention over the block-structured KV cache (PyTorch port of
xllm_service_tpu/ops/attention.py).

Cache layout (one layer): k_cache, v_cache `[num_blocks, Hkv, BS, D]`, the
JAX package's layout, unpacked (no `kv_pack_factor` rows: those exist only
for the TPU's 128-lane tiles). Block 0 is the reserved garbage block.

Two implementations per op, chosen by the device of the query:

  * plain PyTorch versions (`paged_attention_gather`,
    `prefill_attention_blockwise`), the twins of the JAX oracles of the
    same names, used for CPU tensors (tests) and as the reference the
    CUDA kernels are held against;
  * hand-written CUDA kernels (ops/kernels.py, csrc/), launched for CUDA
    tensors. There is no switch and no fallback: a CUDA tensor goes
    through its kernel or the wrapper raises.
"""

from __future__ import annotations

from typing import Dict, Union

import torch

from xllm_service_tpu_torch.ops import kernels

NEG_INF = -1e30


def gather_context(k_cache, v_cache, block_table):
    """Each sequence's context as [R, MB*BS, Hkv, D] (block_table [R, MB])."""
    k_ctx = k_cache[block_table.long()].transpose(2, 3)  # [R, MB, BS, Hkv, D]
    v_ctx = v_cache[block_table.long()].transpose(2, 3)
    R, MB, BS, H, D = k_ctx.shape
    return k_ctx.reshape(R, MB * BS, H, D), v_ctx.reshape(R, MB * BS, H, D)


def _sdpa(q, k, v, mask, scale: float):
    """q [R, Lq, Hq, D], k/v [R, Lk, Hkv, D], mask [R, Lq, Lk] (True =
    attend); f32 math, output in q's dtype."""
    R, Lq, Hq, D = q.shape
    Hkv = k.shape[2]
    qf = q.float().reshape(R, Lq, Hkv, Hq // Hkv, D)
    scores = torch.einsum("rqhgd,rkhd->rhgqk", qf, k.float()) * scale
    scores = torch.where(mask[:, None, None], scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("rhgqk,rkhd->rqhgd", probs, v.float())
    return out.reshape(R, Lq, Hq, D).to(q.dtype)


def paged_attention_gather(
    q: torch.Tensor,            # [R, Hq, D], one query token per sequence
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    block_table: torch.Tensor,  # [R, MB]
    seq_lens: torch.Tensor,     # [R] context length INCLUDING current token
    scale: float,
    window: int = 0,
) -> torch.Tensor:
    """Decode attention, plain version of csrc/paged_attention.cu: each
    query attends to its first seq_lens cache rows, the last `window` of
    them when window > 0. Rows with seq_lens 0 emit zeros. Returns
    [R, Hq, D]."""
    k_ctx, v_ctx = gather_context(k_cache, v_cache, block_table)
    cols = torch.arange(k_ctx.shape[1], device=q.device)[None, :]
    lens = seq_lens.to(q.device).long()[:, None]
    mask = cols < lens
    if window > 0:
        mask = mask & (cols >= lens - window)
    out = _sdpa(q[:, None], k_ctx, v_ctx, mask[:, None, :], scale)[:, 0]
    # A row with no context is a dead decode slot: zeros, like the kernel
    # (softmax over an all-masked row would average the garbage block).
    return torch.where((lens > 0)[:, :, None], out, torch.zeros_like(out))


def prefill_attention_blockwise(
    q: torch.Tensor,            # [L, Hq, D], one sequence's chunk
    k_cache: torch.Tensor,      # [N, Hkv, BS, D]
    v_cache: torch.Tensor,
    block_table: torch.Tensor,  # [CB], sliced to the context bound
    start_pos: Union[int, torch.Tensor],  # tokens already in the cache
    true_len: Union[int, torch.Tensor],   # valid tokens in this chunk
    scale: float,
    window: int = 0,
) -> torch.Tensor:
    """Flash-style prefill, plain version of csrc/flash_prefill.cu: a loop
    over KV blocks with online-softmax accumulation. Row j (absolute
    position start_pos + j) attends cache positions 0..start_pos + j (the
    last `window` when window > 0); rows j >= true_len emit zeros.
    Returns [L, Hq, D]."""
    L, Hq, D = q.shape
    Hkv, BS = k_cache.shape[1], k_cache.shape[2]
    G = Hq // Hkv
    dev = q.device
    qf = q.float().reshape(L, Hkv, G, D)
    ar = torch.arange(L, device=dev)
    rows = torch.as_tensor(start_pos, device=dev).long() + ar  # absolute
    valid_row = ar < torch.as_tensor(true_len, device=dev).long()
    m = torch.full((L, Hkv, G, 1), NEG_INF, device=dev)
    lsum = torch.zeros((L, Hkv, G, 1), device=dev)
    acc = torch.zeros((L, Hkv, G, D), device=dev)
    for blk_idx, blk_id in enumerate(block_table.long().tolist()):
        k_blk = k_cache[blk_id].float()  # [Hkv, BS, D]
        v_blk = v_cache[blk_id].float()
        cols = blk_idx * BS + torch.arange(BS, device=dev)
        scores = torch.einsum("qhgd,hkd->qhgk", qf, k_blk) * scale
        mask = (cols[None, :] <= rows[:, None]) & valid_row[:, None]
        if window > 0:
            mask = mask & (cols[None, :] > rows[:, None] - window)
        scores = torch.where(mask[:, None, None], scores, torch.full_like(scores, NEG_INF))
        m_new = torch.maximum(m, scores.amax(dim=-1, keepdim=True))
        alpha = torch.where(m <= NEG_INF / 2, torch.zeros_like(m), torch.exp(m - m_new))
        p = torch.exp(scores - m_new)
        p = torch.where(m_new <= NEG_INF / 2, torch.zeros_like(p), p)
        lsum = alpha * lsum + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("qhgk,hkd->qhgd", p, v_blk)
        m = m_new
    out = acc / torch.clamp(lsum, min=1e-30)
    return out.reshape(L, Hq, D).to(q.dtype)


def prefill_attention_plain(q, k_cache, v_cache, block_tables, start_pos, true_len,
                            scale: float, window: int = 0) -> torch.Tensor:
    """Batched plain version ([P, Lpad, Hq, D]): the blockwise loop per row."""
    return torch.stack([
        prefill_attention_blockwise(
            q[i], k_cache, v_cache, block_tables[i], start_pos[i], true_len[i],
            scale, window=window,
        )
        for i in range(q.shape[0])
    ])


def _no_implementation(op: str, device: torch.device):
    return ValueError(f"{op}: no implementation for tensors on {device}")


def paged_attention(q, k_cache, v_cache, block_table, seq_lens, scale,
                    window: int = 0) -> torch.Tensor:
    """Decode paged attention: the CUDA kernel for CUDA tensors, the plain
    gather version for CPU tensors."""
    if q.device.type == "cuda":
        return kernels.paged_attention(
            q, k_cache, v_cache, block_table, seq_lens, scale, window=window
        )
    if q.device.type == "cpu":
        return paged_attention_gather(
            q, k_cache, v_cache, block_table, seq_lens, scale, window=window
        )
    raise _no_implementation("paged_attention", q.device)


def prefill_attention(
    q: torch.Tensor,             # [P, Lpad, Hq, D]
    k_cache, v_cache,
    block_tables: torch.Tensor,  # [P, CB]
    start_pos: torch.Tensor,     # [P]
    true_len: torch.Tensor,      # [P]
    scale: float,
    window: int = 0,
) -> torch.Tensor:
    """Batched chunked-prefill attention: the CUDA flash kernel for CUDA
    tensors, the plain blockwise version per row for CPU tensors."""
    if q.device.type == "cuda":
        return kernels.flash_prefill(
            q, k_cache, v_cache, block_tables, start_pos, true_len, scale,
            window=window,
        )
    if q.device.type == "cpu":
        return prefill_attention_plain(
            q, k_cache, v_cache, block_tables, start_pos, true_len, scale, window=window
        )
    raise _no_implementation("prefill_attention", q.device)


def mixed_attention(
    q_dec: torch.Tensor,        # [R, Hq, D], decode slots (some inactive)
    q_pf: torch.Tensor,         # [P, Lpad, Hq, D], prefill chunk rows
    k_cache, v_cache,
    dec_tables: torch.Tensor,   # [R, CBd]
    dec_seq_lens: torch.Tensor,  # [R] context INCLUDING this token; 0 = off
    pf_tables: torch.Tensor,    # [P, CBp]
    pf_start: torch.Tensor,     # [P]
    pf_len: torch.Tensor,       # [P]
    scale: float,
    window: int = 0,
):
    """Attention for one mixed engine step (models.llama.mixed_step): each
    half through its own dispatcher, as the JAX package does with its
    ragged kernel off (the default). The one-launch ragged kernel is not
    ported yet."""
    dec_out = paged_attention(
        q_dec, k_cache, v_cache, dec_tables, dec_seq_lens, scale, window=window
    )
    pf_out = prefill_attention(
        q_pf, k_cache, v_cache, pf_tables, pf_start, pf_len, scale, window=window
    )
    return dec_out, pf_out


def kernel_report(device: Union[str, torch.device]) -> Dict[str, str]:
    """What the dispatchers run for tensors on `device`."""
    if torch.device(device).type == "cuda":
        return {
            "decode": f"cuda:{kernels.PAGED_ATTENTION.name}",
            "prefill": f"cuda:{kernels.FLASH_PREFILL.name}",
            "mixed": "split",
        }
    return {"decode": "gather", "prefill": "blockwise", "mixed": "split"}
