"""Batched token sampling with per-request parameters (PyTorch port of
xllm_service_tpu/ops/sampling.py).

`sample_tokens` keeps the JAX package's fixed order: logit bias, then
presence/frequency penalties, then top-k / top-p / min-p on the
temperature-scaled logits, then the draw. Greedy rows take the argmax
(first index on ties, as jnp.argmax), so greedy decoding matches the JAX
package exactly. Seeded rows draw with a `torch.Generator` seeded from
(seed, step): reproducible in the port, but not the JAX package's
threefry stream (matching it is queued in ROADMAP.md).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch

NEG_INF = -1e30


@dataclass
class SamplingParams:
    """Host-side per-request sampling spec (OpenAI-compatible surface);
    the JAX package's dataclass, field for field."""

    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = 0  # 0 = disabled
    # min_p (vLLM semantics): drop tokens whose probability is below
    # min_p * max-probability. 0 disables.
    min_p: float = 0.0
    seed: int = 0
    logprobs: bool = False
    top_logprobs: int = 0
    max_new_tokens: int = 512
    stop_token_ids: tuple = ()
    ignore_eos: bool = False
    # OpenAI penalties over GENERATED tokens (vLLM semantics).
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    # OpenAI logit_bias: ((token_id, bias), ...) added before filtering.
    logit_bias: tuple = ()

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0


def apply_top_k_top_p(
    logits: torch.Tensor,   # [R, V]
    top_k: torch.Tensor,    # [R] int
    top_p: torch.Tensor,    # [R] float
    min_p: Optional[torch.Tensor] = None,  # [R] float
) -> torch.Tensor:
    """Combined per-row top-k + nucleus + min-p filtering with one sort
    (the JAX order: stable ascending argsort, reversed). top_k <= 0,
    top_p >= 1 and min_p <= 0 disable their filters; the argmax is always
    kept. Filtered logits become NEG_INF."""
    R, vocab = logits.shape
    order = torch.argsort(logits, dim=-1, stable=True).flip(-1)
    sorted_logits = torch.gather(logits, 1, order)
    ranks = torch.arange(vocab, device=logits.device)[None, :]
    k = torch.where(top_k <= 0, torch.full_like(top_k, vocab), top_k.clamp(max=vocab))
    keep_sorted = ranks < k[:, None]
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_sorted &= (cum - probs) < top_p[:, None]
    if min_p is not None:
        floor = torch.where(min_p > 0, min_p, torch.zeros_like(min_p))[:, None] * probs[:, :1]
        keep_sorted &= probs >= floor
    keep_sorted[:, 0] = True
    keep = torch.zeros_like(keep_sorted).scatter(1, order, keep_sorted)
    return torch.where(keep, logits, torch.full_like(logits, NEG_INF))


def apply_penalties(
    logits: torch.Tensor,     # [R, V] f32
    counts: torch.Tensor,     # [R, V] generated-token occurrence counts
    presence: torch.Tensor,   # [R]
    frequency: torch.Tensor,  # [R]
) -> torch.Tensor:
    """OpenAI presence/frequency penalties over generated tokens."""
    if not bool(((presence != 0) | (frequency != 0)).any()):
        return logits
    cf = counts.float()
    seen = (counts > 0).float()
    return logits - presence[:, None] * seen - frequency[:, None] * cf


def _step_seed(seed: int, step: int) -> int:
    """One generator seed per (request seed, generation step)."""
    return (int(seed) * 0x9E3779B97F4A7C15 + int(step)) % (2**63)


def sample_tokens(
    logits: torch.Tensor,        # [R, V]
    temperature: torch.Tensor,   # [R]; <= 0 means greedy
    top_k: torch.Tensor,         # [R] int; 0 disables
    top_p: torch.Tensor,         # [R]; 1.0 disables
    seeds: Optional[Sequence[int]] = None,  # [R] request seeds (host)
    steps: Optional[Sequence[int]] = None,  # [R] generation steps (host)
    counts: Optional[torch.Tensor] = None,     # [R, V] generated-token counts
    presence: Optional[torch.Tensor] = None,   # [R]
    frequency: Optional[torch.Tensor] = None,  # [R]
    bias_ids: Optional[torch.Tensor] = None,   # [R, K] (pad: id 0, bias 0)
    bias_vals: Optional[torch.Tensor] = None,  # [R, K]
    min_p: Optional[torch.Tensor] = None,      # [R]; 0 disables
):
    """Returns (token_ids [R] int64, logprob_of_chosen [R], logprobs [R, V])."""
    logits = logits.float()
    if bias_ids is not None and bias_vals is not None:
        logits = logits.scatter_add(1, bias_ids.long(), bias_vals.float())
    if counts is not None and presence is not None and frequency is not None:
        logits = apply_penalties(logits, counts, presence, frequency)
    logprobs_full = torch.log_softmax(logits, dim=-1)
    token_ids = torch.argmax(logits, dim=-1)

    sampled = (temperature > 0).nonzero().flatten().tolist()
    if sampled:
        if seeds is None or steps is None:
            raise ValueError("sampling with temperature > 0 needs seeds and steps")
        safe_temp = torch.where(temperature > 0, temperature, torch.ones_like(temperature))
        scaled = logits / safe_temp[:, None].float()
        vocab = logits.shape[-1]
        needs_filter = (temperature > 0) & (
            ((top_k > 0) & (top_k < vocab))
            | (top_p < 1.0)
            | ((min_p > 0) if min_p is not None else torch.zeros_like(top_p, dtype=torch.bool))
        )
        if bool(needs_filter.any()):
            scaled = apply_top_k_top_p(scaled, top_k, top_p, min_p)
        tiny = torch.finfo(torch.float32).tiny
        for r in sampled:
            gen = torch.Generator(device=logits.device)
            gen.manual_seed(_step_seed(seeds[r], steps[r]))
            u = torch.rand(vocab, generator=gen, device=logits.device)
            gumbel = -torch.log(-torch.log(u.clamp(min=tiny, max=1.0 - 1e-7)))
            token_ids[r] = torch.argmax(scaled[r] + gumbel)
    chosen = torch.gather(logprobs_full, 1, token_ids[:, None])[:, 0]
    return token_ids, chosen, logprobs_full
