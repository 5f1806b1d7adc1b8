"""Paged KV-cache block allocator (the allocation half of
xllm_service_tpu/runtime/block_manager.py).

Block 0 is reserved as the garbage slot for masked scatter writes
(models/llama.py) and is never allocated. The prefix cache (chained-hash
commits, match_prefix, LRU eviction) is not ported yet.
"""

from __future__ import annotations

from typing import List, Sequence


class OutOfBlocksError(RuntimeError):
    pass


class BlockManager:
    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError("need at least 2 blocks (block 0 is reserved)")
        self.num_blocks = num_blocks
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))
        self._ref = [0] * num_blocks

    @property
    def num_free_blocks(self) -> int:
        return len(self._free)

    def can_allocate(self, n: int) -> bool:
        return self.num_free_blocks >= n

    def allocate(self, n: int) -> List[int]:
        if not self.can_allocate(n):
            raise OutOfBlocksError(f"need {n} blocks, only {self.num_free_blocks} free")
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self._ref[b] = 1
        return out

    def free(self, block_ids: Sequence[int]) -> None:
        for b in block_ids:
            if self._ref[b] != 1:
                raise RuntimeError(f"double free of block {b}")
            self._ref[b] = 0
            self._free.append(b)
