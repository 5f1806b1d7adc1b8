"""Model executor: owns parameters and the paged KV pool on one device and
runs the model steps with fused sampling (PyTorch port of
xllm_service_tpu/runtime/executor.py, synchronous surface).

Shapes are bucketed like the JAX executor's: decode always runs the fixed
batch of R slots with its block table sliced to a power-of-two context
bound; a prefill group runs P (power of two, at most PREFILL_GROUP_MAX)
rows padded to a length bucket, with its table sliced to a power-of-two
bound. PyTorch runs eagerly, so the buckets bound kernel shapes rather
than compiles. Every call returns host numpy arrays.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from xllm_service_tpu_torch.common.config import EngineConfig
from xllm_service_tpu_torch.device import resolve_device
from xllm_service_tpu_torch.models import llama
from xllm_service_tpu_torch.models.configs import ModelConfig, get_model_config
from xllm_service_tpu_torch.ops import attention
from xllm_service_tpu_torch.ops import kv_cache as kvc
from xllm_service_tpu_torch.ops import sampling as sampling_ops

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclass
class SamplingBatch:
    """Per-slot sampling parameters of the fixed decode batch (host)."""

    temperature: np.ndarray  # [R] float32
    top_k: np.ndarray  # [R] int32
    top_p: np.ndarray  # [R] float32
    seeds: np.ndarray  # [R] int64
    steps: np.ndarray  # [R] int32 (per-request generated-token count)
    min_p: Optional[np.ndarray] = None  # [R] float32; None = off batch-wide


@dataclass
class PrefillItem:
    """One sequence's prompt chunk for a batched prefill step."""

    token_ids: np.ndarray  # [n] int32
    start_pos: int  # tokens already in the cache before this chunk
    block_table: np.ndarray  # [>= ceil((start_pos + n) / bs)] int32
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0
    step: int = 0
    min_p: float = 0.0


class ModelExecutor:
    # Prefill group-size bucket cap (the JAX executor's).
    PREFILL_GROUP_MAX = 8

    def __init__(
        self,
        engine_cfg: EngineConfig,
        model_cfg: Optional[ModelConfig] = None,
        params: Optional[llama.Params] = None,
        device=None,
        init_seed: int = 0,
    ):
        self.engine_cfg = engine_cfg
        self.device = resolve_device(device)
        self.cfg = model_cfg or get_model_config(engine_cfg.model)
        llama.check_supported(self.cfg)
        if engine_cfg.dtype not in _DTYPES:
            raise ValueError(f"dtype={engine_cfg.dtype!r}: expected one of {sorted(_DTYPES)}")
        if engine_cfg.kv_cache_dtype != "auto":
            raise NotImplementedError(
                f"kv_cache_dtype={engine_cfg.kv_cache_dtype!r}: only 'auto' is ported"
            )
        self.dtype = _DTYPES[engine_cfg.dtype]
        self.R = engine_cfg.max_running_requests
        self.block_size = engine_cfg.block_size
        self.max_blocks_per_seq = math.ceil(engine_cfg.max_seq_len / self.block_size)
        self.prefill_buckets = sorted(engine_cfg.prefill_buckets)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(init_seed)
            params = llama.init_params(self.cfg, gen, self.dtype, self.device)
        self.params = params
        self.num_blocks = self._decide_num_blocks()
        shape = (
            self.cfg.num_layers, self.num_blocks, self.cfg.num_kv_heads,
            self.block_size, self.cfg.head_dim,
        )
        self.k_cache = kvc.alloc_cache(shape, self.dtype, self.device)
        self.v_cache = kvc.alloc_cache(shape, self.dtype, self.device)

    def _decide_num_blocks(self) -> int:
        """The configured pool size, or on CUDA what fits in the free
        device memory above the (1 - hbm_utilization) reserve."""
        if self.engine_cfg.num_blocks > 0:
            return self.engine_cfg.num_blocks
        if self.device.type != "cuda":
            raise ValueError("num_blocks must be set when serving on the CPU")
        c = self.cfg
        elem = torch.tensor([], dtype=self.dtype).element_size()
        block_bytes = 2 * c.num_layers * self.block_size * c.num_kv_heads * c.head_dim * elem
        free, total = torch.cuda.mem_get_info(self.device)
        budget = free - total * (1.0 - self.engine_cfg.hbm_utilization)
        return max(int(budget // block_bytes), 16)

    # ------------------------------------------------------------ buckets

    def bucket_len(self, n: int) -> int:
        for b in self.prefill_buckets:
            if n <= b:
                return b
        return self.prefill_buckets[-1]

    @staticmethod
    def _pow2_bucket(n: int, cap: int) -> int:
        b = 1
        while b < n:
            b *= 2
        return min(b, cap)

    def prefill_groups(self, items: List[PrefillItem]) -> List[List[int]]:
        """Item indices grouped by padded-length bucket, at most
        PREFILL_GROUP_MAX per group (the JAX executor's walk)."""
        order = sorted(range(len(items)), key=lambda i: self.bucket_len(len(items[i].token_ids)))
        groups: List[List[int]] = []
        i = 0
        while i < len(order):
            bucket = self.bucket_len(len(items[order[i]].token_ids))
            group: List[int] = []
            while (
                i < len(order)
                and len(group) < self.PREFILL_GROUP_MAX
                and self.bucket_len(len(items[order[i]].token_ids)) == bucket
            ):
                group.append(order[i])
                i += 1
            groups.append(group)
        return groups

    # ------------------------------------------------------------ helpers

    def _t(self, a, dtype=torch.int32) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a)).to(self.device, dtype)

    def _decode_inputs(self, token_ids, positions, block_tables, active):
        need = 1
        if active.any():
            need = int(np.asarray(positions)[active].max() // self.block_size) + 1
        CB = self._pow2_bucket(need, self.max_blocks_per_seq)
        return (
            self._t(token_ids), self._t(positions),
            self._t(np.asarray(block_tables)[:, :CB]),
            self._t(active, torch.bool),
        )

    def _pf_inputs(self, items: List[PrefillItem]):
        """Padded [P, Lpad] prefill half + its per-row sampling params."""
        n = len(items)
        P = self._pow2_bucket(n, self.PREFILL_GROUP_MAX)
        Lpad = self.bucket_len(max(len(it.token_ids) for it in items))
        bs = self.block_size
        need = max((it.start_pos + len(it.token_ids) + bs - 1) // bs for it in items)
        CB = self._pow2_bucket(max(need, 1), self.max_blocks_per_seq)
        tokens = np.zeros((P, Lpad), np.int32)
        start = np.zeros((P,), np.int32)
        length = np.zeros((P,), np.int32)
        tables = np.zeros((P, CB), np.int32)
        for i, it in enumerate(items):
            k = len(it.token_ids)
            tokens[i, :k] = it.token_ids
            start[i] = it.start_pos
            length[i] = k
            m = min(CB, len(it.block_table))
            tables[i, :m] = np.asarray(it.block_table[:m], np.int32)
        pad = P - n
        batch = SamplingBatch(
            temperature=np.asarray([it.temperature for it in items] + [0.0] * pad, np.float32),
            top_k=np.asarray([it.top_k for it in items] + [0] * pad, np.int32),
            top_p=np.asarray([it.top_p for it in items] + [1.0] * pad, np.float32),
            seeds=np.asarray([it.seed for it in items] + [0] * pad, np.int64),
            steps=np.asarray([it.step for it in items] + [0] * pad, np.int32),
            min_p=(
                np.asarray([it.min_p for it in items] + [0.0] * pad, np.float32)
                if any(it.min_p for it in items) else None
            ),
        )
        return (self._t(tokens), self._t(start), self._t(length), self._t(tables)), batch

    def _sample(self, logits: torch.Tensor, batch: SamplingBatch):
        tokens, logprob, _ = sampling_ops.sample_tokens(
            logits,
            self._t(batch.temperature, torch.float32),
            self._t(batch.top_k),
            self._t(batch.top_p, torch.float32),
            seeds=batch.seeds, steps=batch.steps,
            min_p=(self._t(batch.min_p, torch.float32) if batch.min_p is not None else None),
        )
        return tokens.cpu().numpy().astype(np.int32), logprob.cpu().numpy()

    # ------------------------------------------------------------ steps

    @torch.inference_mode()
    def decode(
        self,
        token_ids: np.ndarray,     # [R] input token per slot
        positions: np.ndarray,     # [R] position of that token
        block_tables: np.ndarray,  # [R, max_blocks_per_seq]
        active: np.ndarray,        # [R] bool
        batch: SamplingBatch,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """One decode step over the R slots: (tokens [R], logprobs [R])."""
        logits, _, _ = llama.decode_step(
            self.params, self.cfg, self.k_cache, self.v_cache,
            *self._decode_inputs(token_ids, positions, block_tables, active),
        )
        return self._sample(logits, batch)

    @torch.inference_mode()
    def prefill_batch(self, items: List[PrefillItem]) -> List[Tuple[int, float]]:
        """Prefill chunks in as few steps as the length buckets allow;
        returns per-item (sampled token, logprob) in input order."""
        results: List[Optional[Tuple[int, float]]] = [None] * len(items)
        for group in self.prefill_groups(items):
            toks, lps = self._prefill_group([items[g] for g in group])
            for j, g in enumerate(group):
                results[g] = (int(toks[j]), float(lps[j]))
        return results  # type: ignore[return-value]

    def _prefill_group(self, group: List[PrefillItem]):
        pf, batch = self._pf_inputs(group)
        logits, _, _ = llama.prefill_batch_step(
            self.params, self.cfg, self.k_cache, self.v_cache, *pf
        )
        return self._sample(logits, batch)

    @torch.inference_mode()
    def mixed(
        self,
        items: List[PrefillItem],  # due prefill chunks of one length bucket
        token_ids: np.ndarray,
        positions: np.ndarray,
        block_tables: np.ndarray,
        active: np.ndarray,
        batch: SamplingBatch,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """One mixed step: the R decode slots plus the prefill rows.
        Returns (tokens, logprobs) of width R + P: slot r at r, prefill
        row j at R + j (the JAX executor's layout). Without items it is a
        decode step; without an active slot the decode half is skipped."""
        R = self.R
        if not items:
            return self.decode(token_ids, positions, block_tables, active, batch)
        if len(items) > self.PREFILL_GROUP_MAX:
            raise ValueError(f"at most {self.PREFILL_GROUP_MAX} prefill rows per step")
        if not np.asarray(active).any():
            pf_tok, pf_lp = self._prefill_group(items)
            return (
                np.concatenate([np.zeros(R, np.int32), pf_tok]),
                np.concatenate([np.zeros(R, np.float32), pf_lp]),
            )
        pf, pf_batch = self._pf_inputs(items)
        dec_logits, pf_logits, _, _ = llama.mixed_step(
            self.params, self.cfg, self.k_cache, self.v_cache,
            *self._decode_inputs(token_ids, positions, block_tables, active), *pf,
        )
        d_tok, d_lp = self._sample(dec_logits, batch)
        p_tok, p_lp = self._sample(pf_logits, pf_batch)
        return np.concatenate([d_tok, p_tok]), np.concatenate([d_lp, p_lp])

    def kernel_report(self) -> Dict[str, str]:
        """The attention implementations this executor's steps run."""
        return attention.kernel_report(self.device)
