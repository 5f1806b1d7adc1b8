"""Engine configuration: the fields of the JAX package's EngineConfig
(xllm_service_tpu/common/config.py) that the port's serving path reads,
with the same names and defaults."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List


@dataclass
class EngineConfig:
    model: str = "llama3-tiny"  # key into models/configs.py registry
    dtype: str = "bfloat16"  # "bfloat16" | "float32"

    # Paged KV cache.
    block_size: int = 128  # tokens per KV block
    num_blocks: int = 0  # 0 = size from free device memory (CUDA only)
    hbm_utilization: float = 0.9  # fraction of device memory the pool may fill
    kv_cache_dtype: str = "auto"  # "auto" = model dtype; int8 not ported

    # Continuous batching.
    max_running_requests: int = 64
    max_prefill_tokens: int = 8192  # per-step prefill token budget
    max_seq_len: int = 8192
    prefill_buckets: List[int] = field(
        default_factory=lambda: [128, 256, 512, 1024, 2048, 4096, 8192]
    )

    # Sampling defaults.
    max_new_tokens_default: int = 512
