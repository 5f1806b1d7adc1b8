"""Where one engine step's time goes in the PyTorch port, on one GPU.

    python3 scripts/torch_step_profile.py

Builds llama3-8b at full width with seeded random bf16 weights, fills
R = 8 decode slots with 1024 tokens of context each, then times (host
clock, each step ended by a device synchronize) 8 decode steps over the
slots and one mixed step (the 8 slots + one 2048-token prefill chunk). A
torch.profiler window over the decode steps gives device time by kernel
and the device's busy share of the wall time. Prints one JSON line.
Refuses to run without CUDA.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
MODEL, R, BS, CTX, CHUNK, STEPS = "llama3-8b", 8, 128, 1024, 2048, 8


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_step_profile: CUDA is not available", file=sys.stderr)
        return 1
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from xllm_service_tpu_torch.common.config import EngineConfig
    from xllm_service_tpu_torch.runtime.executor import ModelExecutor, PrefillItem, SamplingBatch

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    per_seq = (CTX + STEPS + 2 + BS - 1) // BS
    cfg = EngineConfig(model=MODEL, block_size=BS, max_running_requests=R,
                       num_blocks=R * per_seq + (CHUNK + BS - 1) // BS + 1,
                       max_prefill_tokens=CHUNK)
    ex = ModelExecutor(cfg, device="cuda", init_seed=0)
    rng = np.random.default_rng(0)
    tables = np.zeros((R, ex.max_blocks_per_seq), np.int32)
    for r in range(R):
        tables[r, :per_seq] = 1 + r * per_seq + np.arange(per_seq)
    # Prefill every slot's context (untimed set-up).
    ex.prefill_batch([
        PrefillItem(rng.integers(3, ex.cfg.vocab_size, CTX).astype(np.int32), 0, tables[r])
        for r in range(R)
    ])
    active = np.ones((R,), bool)
    batch = SamplingBatch(np.zeros(R, np.float32), np.zeros(R, np.int32),
                          np.ones(R, np.float32), np.zeros(R, np.int64), np.zeros(R, np.int32))
    tokens = rng.integers(3, ex.cfg.vocab_size, R).astype(np.int32)
    pos = np.full((R,), CTX, np.int32)

    def decode():
        nonlocal tokens
        tokens, _ = ex.decode(tokens, pos, tables, active, batch)
        pos[:] += 1
        torch.cuda.synchronize()

    decode()  # warm-up
    times = []
    for _ in range(STEPS):
        t = time.perf_counter()
        decode()
        times.append((time.perf_counter() - t) * 1e3)
    chunk_table = np.zeros((ex.max_blocks_per_seq,), np.int32)
    n_chunk_blocks = (CHUNK + BS - 1) // BS
    chunk_table[:n_chunk_blocks] = R * per_seq + 1 + np.arange(n_chunk_blocks)
    item = PrefillItem(rng.integers(3, ex.cfg.vocab_size, CHUNK).astype(np.int32), 0,
                       chunk_table)
    t = time.perf_counter()
    ex.mixed([item], tokens, pos, tables, active, batch)
    torch.cuda.synchronize()
    mixed_ms = (time.perf_counter() - t) * 1e3
    pos[:] += 1

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(3):
            decode()
        window_ms = (time.perf_counter() - t) * 1e3
    # Device-side events only (kernels, copies): the CPU ops that launched
    # them carry the same device time again.
    rows = sorted(
        ((e.self_device_time_total, e.key, e.count) for e in prof.key_averages()
         if e.device_type == DeviceType.CUDA),
        reverse=True,
    )
    device_ms = sum(r[0] for r in rows) / 1e3
    top = [{"kernel": k[:80], "ms_per_step": us / 1e3 / 3, "calls_per_step": n / 3}
           for us, k, n in rows[:12]]
    result = {
        "card": card, "model": MODEL, "slots": R, "ctx": CTX,
        "decode_step_ms": times, "decode_step_ms_median": float(np.median(times)),
        "mixed_step_ms": mixed_ms, "mixed_chunk_tokens": CHUNK,
        "profiled_window_ms_per_step": window_ms / 3,
        "device_busy_ms_per_step": device_ms / 3,
        "device_idle_share": max(0.0, 1.0 - device_ms / window_ms),
        "device_launches_per_step": sum(r[2] for r in rows) / 3,
        "top_device_kernels": top,
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
