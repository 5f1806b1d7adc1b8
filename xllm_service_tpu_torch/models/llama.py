"""Llama-family transformer (PyTorch port of xllm_service_tpu/models/llama.py).

Dense GQA models of the registry: llama3, qwen2 (QKV bias), qwen3 (QK-norm),
gemma (GELU-tanh MLP, scaled embeddings, tied head) and sliding-window
attention. Not ported yet: MoE, LoRA, M-RoPE, media embeddings.

Parameters are the JAX package's pytree as a dict of tensors, per-layer
weights STACKED on a leading layer axis with the same layouts (wq
[L, E, Hq*D], wo [L, Hq*D, E], w_gate/w_up [L, E, F], w_down [L, F, E]),
so runtime/weights.params_from_numpy moves JAX parameters over without a
transpose. The layer stack is a Python loop (the JAX package's lax.scan);
the KV pool [L, N, Hkv, BS, D] is updated in place, each layer writing its
own contiguous [N, Hkv, BS, D] slice before attending over it, which makes
fresh, chunked and decode steps one code path. Attention goes through
ops/attention.py: the CUDA kernels for CUDA tensors, the plain versions
for CPU tensors. The dense products are torch.matmul.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from xllm_service_tpu_torch.models.configs import ModelConfig
from xllm_service_tpu_torch.ops import kv_cache as kv_cache_ops
from xllm_service_tpu_torch.ops import rope as rope_ops
from xllm_service_tpu_torch.ops.attention import (
    mixed_attention,
    paged_attention,
    prefill_attention,
)
from xllm_service_tpu_torch.ops.norms import rms_norm

Params = Dict[str, Any]


def check_supported(cfg: ModelConfig) -> None:
    """Raise for model features this port does not serve yet."""
    missing = [
        name for name, on in (
            ("MoE", cfg.is_moe), ("MLA", cfg.is_mla),
            ("M-RoPE", bool(cfg.mrope_section)),
        ) if on
    ]
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported to PyTorch yet"
        )


def _fill_random(out: torch.Tensor, generator: torch.Generator, fan_in: int) -> torch.Tensor:
    """normal / sqrt(fan_in) into `out`, generated in f32 a slice of at
    most 2**27 elements at a time (full-width temporaries would double
    the peak memory of an 8B model)."""
    rows = max(1, (1 << 27) // max(1, out[0].numel()))
    for i in range(0, out.shape[0], rows):
        part = out[i:i + rows]
        part.copy_(
            torch.randn(part.shape, generator=generator, device=out.device)
            / math.sqrt(fan_in)
        )
    return out


def init_params(cfg: ModelConfig, generator: torch.Generator,
                dtype: torch.dtype = torch.bfloat16,
                device="cuda") -> Params:
    """Random parameters with the JAX package's init scales (normal /
    sqrt(fan_in) for matrices, ones for norms, zeros for biases), drawn
    from `generator` (which must live on `device`)."""
    check_supported(cfg)
    E, L = cfg.hidden_size, cfg.num_layers
    Hq, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    Fi, V = cfg.intermediate_size, cfg.vocab_size

    def w(shape, fan_in):
        return _fill_random(torch.empty(shape, dtype=dtype, device=device), generator, fan_in)

    def ones(shape):
        return torch.ones(shape, dtype=torch.float32, device=device)

    layers = {
        "attn_norm": ones((L, E)),
        "wq": w((L, E, Hq * D), E),
        "wk": w((L, E, Hkv * D), E),
        "wv": w((L, E, Hkv * D), E),
        "wo": w((L, Hq * D, E), Hq * D),
        "mlp_norm": ones((L, E)),
        "w_gate": w((L, E, Fi), E),
        "w_up": w((L, E, Fi), E),
        "w_down": w((L, Fi, E), Fi),
    }
    if cfg.attn_bias:
        for name, width in (("bq", Hq * D), ("bk", Hkv * D), ("bv", Hkv * D)):
            layers[name] = torch.zeros((L, width), dtype=dtype, device=device)
    if cfg.qk_norm:
        layers["q_head_norm"] = ones((L, D))
        layers["k_head_norm"] = ones((L, D))
    params: Params = {
        "embed": w((V, E), E),
        "layers": layers,
        "final_norm": ones((E,)),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = w((E, V), E)
    return params


def _embed(params: Params, cfg: ModelConfig, token_ids: torch.Tensor) -> torch.Tensor:
    x = params["embed"][token_ids.long()].to(params["layers"]["wq"].dtype)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.hidden_size**0.5, dtype=x.dtype)
    return x


def _unembed(params: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Final norm + vocab projection -> f32 logits. f32 weights project in
    f32 (the JAX package's math); bf16 weights project in bf16 with f32
    accumulation, so the [E, V] head is never copied to f32."""
    h = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    w = params["embed"].t() if cfg.tie_word_embeddings else params["lm_head"]
    if w.dtype == torch.float32:
        return h.float() @ w
    return (h.to(w.dtype) @ w).float()


def _act(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.mlp_act == "gelu_tanh":
        return F.gelu(x, approximate="tanh")
    return F.silu(x)


def _mlp(lp: Params, layer: int, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU (or GELU-tanh gated) MLP over [..., E]."""
    gate = x @ lp["w_gate"][layer]
    up = x @ lp["w_up"][layer]
    return (_act(cfg, gate) * up) @ lp["w_down"][layer]


def _qkv(lp: Params, layer: int, cfg: ModelConfig, x: torch.Tensor, rope):
    """x [T, E] -> q [T, Hq, D], k/v [T, Hkv, D] with RoPE applied;
    `rope` is the step's (cos, sin) tables for the T positions."""
    T = x.shape[0]
    q = x @ lp["wq"][layer]
    k = x @ lp["wk"][layer]
    v = x @ lp["wv"][layer]
    if cfg.attn_bias:
        q = q + lp["bq"][layer]
        k = k + lp["bk"][layer]
        v = v + lp["bv"][layer]
    q = q.reshape(T, cfg.num_heads, cfg.head_dim)
    k = k.reshape(T, cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(T, cfg.num_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rms_norm(q, lp["q_head_norm"][layer], cfg.rms_norm_eps)
        k = rms_norm(k, lp["k_head_norm"][layer], cfg.rms_norm_eps)
    return rope_ops.rotate(q, *rope), rope_ops.rotate(k, *rope), v


def _attn_out(lp: Params, layer: int, cfg: ModelConfig, attn: torch.Tensor) -> torch.Tensor:
    return attn.reshape(*attn.shape[:-2], -1) @ lp["wo"][layer]


def _decode_coords(block_tables, positions, active, bs):
    """Cache slot (block, offset) and context length per decode row;
    inactive rows write the garbage block 0 and attend nothing."""
    idx = (positions // bs).clamp(0, block_tables.shape[1] - 1).long()
    blk = torch.gather(block_tables, 1, idx[:, None])[:, 0]
    zero = torch.zeros_like(positions)
    blk = torch.where(active, blk, zero.to(blk.dtype))
    offset = torch.where(active, positions % bs, zero)
    seq_lens = torch.where(active, positions + 1, zero).to(torch.int32)
    return blk, offset, seq_lens


def _prefill_coords(block_tables, start_pos, true_len, Lpad, bs):
    """Absolute positions [P, Lpad] and flattened cache slots of a batched
    prefill chunk; padded tokens write the garbage block 0."""
    offsets = torch.arange(Lpad, device=start_pos.device)[None, :]
    positions = start_pos.long()[:, None] + offsets
    valid = offsets < true_len.long()[:, None]
    idx = (positions // bs).clamp(0, block_tables.shape[1] - 1)
    blk = torch.where(valid, torch.gather(block_tables.long(), 1, idx), 0)
    off = torch.where(valid, positions % bs, 0)
    return positions, valid, blk.reshape(-1), off.reshape(-1)


def _last_logits(params, cfg, x, lengths):
    """Logits of each row's last valid position: x [P, Lpad, E]."""
    last = (lengths.long() - 1).clamp(min=0)
    return _unembed(params, cfg, x[torch.arange(x.shape[0], device=x.device), last])


def decode_step(
    params: Params,
    cfg: ModelConfig,
    k_caches: torch.Tensor,      # [L, N, Hkv, BS, D], updated in place
    v_caches: torch.Tensor,
    token_ids: torch.Tensor,     # [R]
    positions: torch.Tensor,     # [R] 0-based position of this token
    block_tables: torch.Tensor,  # [R, MB] int32
    active: torch.Tensor,        # [R] bool
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One generation step for R sequences. Returns (logits [R, V], k, v)."""
    bs = k_caches.shape[3]
    scale = cfg.head_dim**-0.5
    lp = params["layers"]
    x = _embed(params, cfg, token_ids)
    blk, offset, seq_lens = _decode_coords(block_tables, positions, active, bs)
    rope = rope_ops.rope_tables(positions, cfg, cfg.head_dim)
    for layer in range(cfg.num_layers):
        k_l, v_l = k_caches[layer], v_caches[layer]
        h = rms_norm(x, lp["attn_norm"][layer], cfg.rms_norm_eps)
        q, k, v = _qkv(lp, layer, cfg, h, rope)
        kv_cache_ops.scatter_rows(k_l, blk, offset, k)
        kv_cache_ops.scatter_rows(v_l, blk, offset, v)
        attn = paged_attention(
            q, k_l, v_l, block_tables, seq_lens, scale, window=cfg.sliding_window
        )
        x = x + _attn_out(lp, layer, cfg, attn)
        x = x + _mlp(lp, layer, cfg, rms_norm(x, lp["mlp_norm"][layer], cfg.rms_norm_eps))
    return _unembed(params, cfg, x), k_caches, v_caches


def prefill_batch_step(
    params: Params,
    cfg: ModelConfig,
    k_caches: torch.Tensor,
    v_caches: torch.Tensor,
    token_ids: torch.Tensor,     # [P, Lpad] per-sequence chunks, padded
    start_pos: torch.Tensor,     # [P] int32 cached tokens before each chunk
    true_len: torch.Tensor,      # [P] int32 valid tokens per chunk
    block_tables: torch.Tensor,  # [P, CB] int32, sliced to the context bound
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Prefill P sequences' chunks in one step: K/V rows of all P*Lpad
    tokens scatter into the pool (padding into block 0), then attention
    reads prefix and chunk from the cache. Returns (last-token logits
    [P, V], k, v)."""
    bs = k_caches.shape[3]
    scale = cfg.head_dim**-0.5
    lp = params["layers"]
    P, Lpad = token_ids.shape
    x = _embed(params, cfg, token_ids)  # [P, Lpad, E]
    positions, _, blk, off = _prefill_coords(block_tables, start_pos, true_len, Lpad, bs)
    rope = rope_ops.rope_tables(positions.reshape(-1), cfg, cfg.head_dim)
    for layer in range(cfg.num_layers):
        k_l, v_l = k_caches[layer], v_caches[layer]
        h = rms_norm(x, lp["attn_norm"][layer], cfg.rms_norm_eps)
        q, k, v = _qkv(lp, layer, cfg, h.reshape(P * Lpad, -1), rope)
        kv_cache_ops.scatter_rows(k_l, blk, off, k)
        kv_cache_ops.scatter_rows(v_l, blk, off, v)
        attn = prefill_attention(
            q.reshape(P, Lpad, *q.shape[1:]), k_l, v_l, block_tables,
            start_pos, true_len, scale, window=cfg.sliding_window,
        )
        x = x + _attn_out(lp, layer, cfg, attn)
        x = x + _mlp(lp, layer, cfg, rms_norm(x, lp["mlp_norm"][layer], cfg.rms_norm_eps))
    return _last_logits(params, cfg, x, true_len), k_caches, v_caches


def mixed_step(
    params: Params,
    cfg: ModelConfig,
    k_caches: torch.Tensor,
    v_caches: torch.Tensor,
    dec_tokens: torch.Tensor,     # [R] decode-slot input tokens
    dec_positions: torch.Tensor,  # [R]
    dec_tables: torch.Tensor,     # [R, CBd] int32
    dec_active: torch.Tensor,     # [R] bool
    pf_tokens: torch.Tensor,      # [P, Lpad] due prefill chunks
    pf_start: torch.Tensor,       # [P] int32
    pf_len: torch.Tensor,         # [P] int32 (0 = pad row)
    pf_tables: torch.Tensor,      # [P, CBp] int32
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One step for a mixed batch: R decode slots and P chunked-prefill
    rows. Each half keeps the shapes decode_step and prefill_batch_step
    use for its dense products; attention runs through
    ops.attention.mixed_attention (the decode kernel for one half, the
    flash prefill kernel for the other). Decode K/V scatter first, then
    prefill K/V, as in the JAX package. Returns (dec_logits [R, V],
    pf_logits [P, V], k, v)."""
    bs = k_caches.shape[3]
    scale = cfg.head_dim**-0.5
    lp = params["layers"]
    P, Lpad = pf_tokens.shape
    x_dec = _embed(params, cfg, dec_tokens)
    x_pf = _embed(params, cfg, pf_tokens)
    d_blk, d_off, d_lens = _decode_coords(dec_tables, dec_positions, dec_active, bs)
    pf_pos, _, p_blk, p_off = _prefill_coords(pf_tables, pf_start, pf_len, Lpad, bs)
    d_rope = rope_ops.rope_tables(dec_positions, cfg, cfg.head_dim)
    p_rope = rope_ops.rope_tables(pf_pos.reshape(-1), cfg, cfg.head_dim)
    for layer in range(cfg.num_layers):
        k_l, v_l = k_caches[layer], v_caches[layer]
        h_dec = rms_norm(x_dec, lp["attn_norm"][layer], cfg.rms_norm_eps)
        q_dec, k_dec, v_dec = _qkv(lp, layer, cfg, h_dec, d_rope)
        h_pf = rms_norm(x_pf, lp["attn_norm"][layer], cfg.rms_norm_eps)
        q_pf, k_pf, v_pf = _qkv(lp, layer, cfg, h_pf.reshape(P * Lpad, -1), p_rope)
        kv_cache_ops.scatter_rows(k_l, d_blk, d_off, k_dec)
        kv_cache_ops.scatter_rows(v_l, d_blk, d_off, v_dec)
        kv_cache_ops.scatter_rows(k_l, p_blk, p_off, k_pf)
        kv_cache_ops.scatter_rows(v_l, p_blk, p_off, v_pf)
        attn_dec, attn_pf = mixed_attention(
            q_dec, q_pf.reshape(P, Lpad, *q_pf.shape[1:]), k_l, v_l,
            dec_tables, d_lens, pf_tables, pf_start, pf_len, scale,
            window=cfg.sliding_window,
        )
        x_dec = x_dec + _attn_out(lp, layer, cfg, attn_dec)
        x_dec = x_dec + _mlp(
            lp, layer, cfg, rms_norm(x_dec, lp["mlp_norm"][layer], cfg.rms_norm_eps)
        )
        x_pf = x_pf + _attn_out(lp, layer, cfg, attn_pf)
        x_pf = x_pf + _mlp(
            lp, layer, cfg, rms_norm(x_pf, lp["mlp_norm"][layer], cfg.rms_norm_eps)
        )
    dec_logits = _unembed(params, cfg, x_dec)
    return dec_logits, _last_logits(params, cfg, x_pf, pf_len), k_caches, v_caches
