"""RMSNorm (PyTorch port of xllm_service_tpu/ops/norms.py): computed in
float32, cast back to the input dtype."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    normed = xf / torch.sqrt(var + eps)
    return (normed * weight.float()).to(x.dtype)
