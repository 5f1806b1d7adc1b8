"""OpenAI request parsing (the completions subset of
xllm_service_tpu/api/protocol.py)."""

from __future__ import annotations

import os
from typing import Any, Dict, List, Tuple

from xllm_service_tpu_torch.ops.sampling import SamplingParams


def parse_prompt_field(prompt: Any) -> Tuple[str, List[int], str]:
    """OpenAI `prompt` accepts a string or an array of token ids. Returns
    (text, token_ids, error); exactly one of text/token_ids is filled on
    success."""
    if isinstance(prompt, str):
        return prompt, [], ""
    if isinstance(prompt, list):
        if not prompt:
            return "", [], "prompt is empty"
        if all(isinstance(t, int) for t in prompt):
            return "", [int(t) for t in prompt], ""
        return "", [], "batched string prompts are not supported; send one string"
    return "", [], "prompt must be a string or an array of token ids"


def sampling_from_body(body: Dict[str, Any], max_new_tokens_default: int) -> SamplingParams:
    """OpenAI request body -> SamplingParams. Unseeded sampling draws a
    fresh per-request seed; only an explicit seed gives a repeatable
    stream. Raises ValueError on malformed fields."""
    max_tokens = int(body.get("max_tokens") or 0)
    if max_tokens < 0:
        raise ValueError("max_tokens must be positive")
    raw_seed = body.get("seed")
    seed = int(raw_seed) if raw_seed is not None else int.from_bytes(os.urandom(4), "little")
    raw_bias = body.get("logit_bias") or {}
    if not isinstance(raw_bias, dict):
        raise ValueError("logit_bias must be an object of token_id: bias")
    return SamplingParams(
        temperature=float(body.get("temperature", 1.0)),
        top_p=float(body.get("top_p", 1.0)),
        top_k=int(body.get("top_k", 0) or 0),
        min_p=float(body.get("min_p", 0.0) or 0.0),
        seed=seed,
        logprobs=bool(body.get("logprobs")),
        max_new_tokens=max_tokens or max_new_tokens_default,
        ignore_eos=bool(body.get("ignore_eos", False)),
        presence_penalty=float(body.get("presence_penalty", 0.0) or 0.0),
        frequency_penalty=float(body.get("frequency_penalty", 0.0) or 0.0),
        logit_bias=tuple(
            (int(k), max(-100.0, min(100.0, float(v)))) for k, v in raw_bias.items()
        ),
    )
