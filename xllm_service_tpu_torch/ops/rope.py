"""Rotary position embeddings (PyTorch port of xllm_service_tpu/ops/rope.py).

Ported scalings: none and "llama3" (HF rope_scaling semantics; the table
math is numpy, as in the JAX package). The other types ("linear",
"dynamic", "longrope", "yarn") are not ported yet and raise.
"""

from __future__ import annotations

import numpy as np
import torch


def _plain_inv_freq(head_dim: int, theta: float) -> np.ndarray:
    exponent = np.arange(0, head_dim, 2, dtype=np.float32) / head_dim
    return (1.0 / theta**exponent).astype(np.float32)


def rope_parameters(head_dim: int, cfg) -> tuple:
    """(inv_freq [head_dim/2] np.float32, output_scale float) for the
    config's rope scaling; `cfg` is any object with the rope_* fields."""
    theta = float(cfg.rope_theta)
    inv = _plain_inv_freq(head_dim, theta)
    typ = getattr(cfg, "rope_scaling_type", "") or ""
    if not typ:
        return inv, 1.0
    factor = float(getattr(cfg, "rope_scaling_factor", 1.0))
    orig = int(getattr(cfg, "rope_original_max_position", 0)) or int(
        cfg.max_position_embeddings
    )
    if typ == "llama3":
        lo = float(getattr(cfg, "rope_low_freq_factor", 1.0))
        hi = float(getattr(cfg, "rope_high_freq_factor", 4.0))
        low_wl, high_wl = orig / lo, orig / hi
        wavelen = 2.0 * np.pi / inv
        scaled = np.where(wavelen > low_wl, inv / factor, inv)
        smooth = (orig / wavelen - lo) / (hi - lo)
        smoothed = (1.0 - smooth) * scaled / factor + smooth * scaled
        medium = (wavelen >= high_wl) & (wavelen <= low_wl)
        return np.where(medium, smoothed, scaled).astype(np.float32), 1.0
    raise NotImplementedError(f"rope_scaling type {typ!r} is not ported yet")


def rope_tables(positions: torch.Tensor, cfg, head_dim: int):
    """(cos, sin) [..., head_dim/2] in f32 for positions [...], with the
    scaling's output scale folded in. A model step computes them once and
    reuses them in every layer."""
    inv, scale = rope_parameters(head_dim, cfg)
    angles = positions[..., None].float() * torch.from_numpy(inv).to(positions.device)
    return scale * torch.cos(angles), scale * torch.sin(angles)


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Split-half rotation of x [..., H, D] by tables [..., D/2]."""
    half = x.shape[-1] // 2
    cos, sin = cos[..., None, :], sin[..., None, :]
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def apply_rope_scaled(x: torch.Tensor, positions: torch.Tensor, cfg) -> torch.Tensor:
    """Rotate x [..., H, D] by positions [...] under the config's rope
    scaling (rope_parameters)."""
    return rotate(x, *rope_tables(positions, cfg, x.shape[-1]))
