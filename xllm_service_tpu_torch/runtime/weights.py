"""Parameter bridge from the JAX package's pytree (PyTorch port of the
parameter side of xllm_service_tpu/runtime/weights.py).

`params_from_numpy` takes the JAX package's llama parameters as numpy
arrays (for example `jax.device_get(llama.init_params(...))`) and returns
the port's parameter dict with the same keys and layouts, so both compute
the same function. Loading an HF checkpoint is not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from xllm_service_tpu_torch.models.configs import ModelConfig
from xllm_service_tpu_torch.models.llama import Params, check_supported

# Layer leaves of the dense llama family; norms stay float32, like the
# JAX package's init.
_MATRIX_LEAVES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "bq", "bk", "bv")
_NORM_LEAVES = ("attn_norm", "mlp_norm", "q_head_norm", "k_head_norm")


def _tensor(arr: Any, device, dtype: torch.dtype) -> torch.Tensor:
    a = np.asarray(arr)
    if a.dtype.kind == "V" or a.dtype.name == "bfloat16":
        a = a.astype(np.float32)  # ml_dtypes bfloat16: numpy-only type
    return torch.from_numpy(np.array(a)).to(device=device, dtype=dtype)  # own copy


def params_from_numpy(np_params: Mapping[str, Any], cfg: ModelConfig,
                      device, dtype: torch.dtype) -> Params:
    """JAX llama pytree (numpy leaves) -> the port's parameters on
    `device`: matrices and biases in `dtype`, norm weights in float32."""
    check_supported(cfg)
    layers: Dict[str, torch.Tensor] = {}
    for name, arr in np_params["layers"].items():
        if name in _MATRIX_LEAVES:
            layers[name] = _tensor(arr, device, dtype)
        elif name in _NORM_LEAVES:
            layers[name] = _tensor(arr, device, torch.float32)
        else:
            raise ValueError(f"unexpected layer parameter {name!r} for {cfg.name}")
    params: Params = {
        "embed": _tensor(np_params["embed"], device, dtype),
        "layers": layers,
        "final_norm": _tensor(np_params["final_norm"], device, torch.float32),
    }
    if "lm_head" in np_params:
        params["lm_head"] = _tensor(np_params["lm_head"], device, dtype)
    return params
