"""The port's hand-written CUDA kernels: build, bind, check, launch, count.

Each source under `csrc/` compiles with nvcc for sm_90a into a shared
library with a plain C interface, loaded with ctypes. A library is built at
first use into `build/torch_kernels/` at the repository root (listed in
.gitignore), under a name that carries a hash of its sources and flags, so
an edited source never loads a stale library. `build_all` starts one nvcc
per source at once. Nothing is compiled or loaded at import time: the CPU
tests import this module on machines without nvcc.

Each wrapper checks device, dtype, shape and contiguity and raises on
anything the kernel does not take, launches on PyTorch's current stream,
raises if the launch reports an error, and counts its launches on its
`Kernel` (`launch_counts`). The plain PyTorch version of each kernel lives
beside its dispatcher in ops/attention.py.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import torch

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
_P = ctypes.c_void_p
_I = ctypes.c_int


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


class Kernel:
    """One CUDA source, its C entry point and its launch count."""

    def __init__(self, name: str, source: str, symbol: str, argtypes: Sequence,
                 replaces: str):
        self.name = name
        self.source = _CSRC / source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.replaces = replaces  # the JAX package's Pallas kernel, file:line
        self.launches = 0
        self.build_log = ""
        self._fn = None
        self._err = None
        self._lock = threading.Lock()

    @property
    def library(self) -> Path:
        h = hashlib.sha256()
        for path in (self.source, _CSRC / "common.cuh"):
            h.update(path.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"lib{self.name}-{h.hexdigest()[:16]}.so"

    def start_build(self) -> Optional[subprocess.Popen]:
        """Start nvcc for this source (None when the library exists)."""
        if self.library.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = self.library.with_suffix(f".{os.getpid()}.tmp")
        return subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )

    def finish_build(self, proc: Optional[subprocess.Popen]) -> None:
        if proc is None:
            return
        out, _ = proc.communicate()
        self.build_log = out
        tmp = Path(proc.args[proc.args.index("-o") + 1])
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed for {self.source.name}:\n{out}")
        os.replace(tmp, self.library)

    def function(self):
        """The bound C entry point, building the library if needed."""
        with self._lock:
            if self._fn is None:
                self.finish_build(self.start_build())
                lib = ctypes.CDLL(str(self.library))
                fn = getattr(lib, self.symbol)
                fn.argtypes = self.argtypes
                fn.restype = ctypes.c_int
                err = getattr(lib, f"{self.symbol}_error_string")
                err.argtypes = [ctypes.c_int]
                err.restype = ctypes.c_char_p
                self._fn, self._err = fn, err
            return self._fn

    def launch(self, *args) -> None:
        code = self.function()(*args)
        self.launches += 1
        if code != 0:
            msg = self._err(code).decode()
            raise RuntimeError(f"{self.name} kernel launch failed: {msg} ({code})")


PAGED_ATTENTION = Kernel(
    "paged_attention", "paged_attention.cu", "xllm_paged_attention",
    [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
     ctypes.c_float, _I, _P],
    replaces="xllm_service_tpu/ops/pallas/paged_attention.py:260",
)
FLASH_PREFILL = Kernel(
    "flash_prefill", "flash_prefill.cu", "xllm_flash_prefill",
    [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
     ctypes.c_float, _I, _P],
    replaces="xllm_service_tpu/ops/pallas/flash_prefill.py:226",
)
KERNELS = (PAGED_ATTENTION, FLASH_PREFILL)


def build_all(kernels: Sequence[Kernel] = KERNELS) -> None:
    """Compile every missing library, one nvcc per source, all at once."""
    procs = [(k, k.start_build()) for k in kernels]
    errors: List[str] = []
    for k, proc in procs:
        try:
            k.finish_build(proc)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))


def launch_counts() -> Dict[str, int]:
    return {k.name: k.launches for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


# ------------------------------------------------------------ input checks

_HEAD_DIMS = (64, 128, 256)
_GROUPS = (1, 2, 4, 8)


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(what)


def _check_tensors(kernel: str, device: torch.device, **tensors) -> None:
    for name, t in tensors.items():
        _check(t.device == device, f"{kernel}: {name} is on {t.device}, expected {device}")
        _check(t.is_contiguous(), f"{kernel}: {name} must be contiguous")
        _check(t.data_ptr() % 16 == 0, f"{kernel}: {name} must be 16-byte aligned")


def _check_cache(kernel: str, q: torch.Tensor, k_cache, v_cache):
    _check(k_cache.dim() == 4 and k_cache.shape == v_cache.shape,
           f"{kernel}: caches must both be [N, Hkv, BS, D], got "
           f"{tuple(k_cache.shape)} and {tuple(v_cache.shape)}")
    _check(k_cache.dtype == q.dtype and v_cache.dtype == q.dtype,
           f"{kernel}: cache dtype {k_cache.dtype} != query dtype {q.dtype}")
    N, Hkv, BS, D = k_cache.shape
    Hq = q.shape[-2]
    _check(q.shape[-1] == D, f"{kernel}: head_dim {q.shape[-1]} != cache {D}")
    _check(D in _HEAD_DIMS, f"{kernel}: head_dim {D} not in {_HEAD_DIMS}")
    _check(Hq % Hkv == 0 and Hq // Hkv in _GROUPS,
           f"{kernel}: query heads {Hq} / kv heads {Hkv} not in {_GROUPS}")
    return N, Hkv, BS, D, Hq // Hkv


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# ------------------------------------------------------------ wrappers


def paged_attention(
    q: torch.Tensor,            # [R, Hq, D] bf16 or f32
    k_cache: torch.Tensor,      # [N, Hkv, BS, D]
    v_cache: torch.Tensor,
    block_table: torch.Tensor,  # [R, MB] int32
    seq_lens: torch.Tensor,     # [R] int32, INCLUDING the current token
    scale: float,
    window: int = 0,
) -> torch.Tensor:
    """Decode attention through csrc/paged_attention.cu. Returns [R, Hq, D]."""
    name = PAGED_ATTENTION.name
    _check(q.is_cuda, f"{name}: needs CUDA tensors, got {q.device}")
    _check(q.dtype in (torch.bfloat16, torch.float32),
           f"{name}: dtype {q.dtype} not in (bfloat16, float32)")
    _check(q.dim() == 3, f"{name}: q must be [R, Hq, D], got {tuple(q.shape)}")
    N, Hkv, BS, D, G = _check_cache(name, q, k_cache, v_cache)
    R = q.shape[0]
    _check(block_table.dtype == torch.int32 and seq_lens.dtype == torch.int32,
           f"{name}: block_table and seq_lens must be int32")
    _check(block_table.dim() == 2 and block_table.shape[0] == R
           and tuple(seq_lens.shape) == (R,),
           f"{name}: block_table must be [R, MB] and seq_lens [R] for R={R}")
    _check_tensors(name, q.device, q=q, k_cache=k_cache, v_cache=v_cache,
                   block_table=block_table, seq_lens=seq_lens)
    out = torch.empty_like(q)
    if R == 0:
        return out
    with torch.cuda.device(q.device):
        PAGED_ATTENTION.launch(
            0 if q.dtype == torch.bfloat16 else 1,
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            block_table.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
            R, Hkv, G, D, N, BS, block_table.shape[1], float(scale),
            int(window), _stream(q.device),
        )
    return out


def flash_prefill(
    q: torch.Tensor,             # [P, Lpad, Hq, D] bf16
    k_cache: torch.Tensor,       # [N, Hkv, BS, D]
    v_cache: torch.Tensor,
    block_tables: torch.Tensor,  # [P, MB] int32
    start_pos: torch.Tensor,     # [P] int32
    true_len: torch.Tensor,      # [P] int32
    scale: float,
    window: int = 0,
) -> torch.Tensor:
    """Chunked-prefill attention through csrc/flash_prefill.cu. Returns
    [P, Lpad, Hq, D]."""
    name = FLASH_PREFILL.name
    _check(q.is_cuda, f"{name}: needs CUDA tensors, got {q.device}")
    _check(q.dtype == torch.bfloat16, f"{name}: dtype {q.dtype} is not bfloat16")
    _check(q.dim() == 4, f"{name}: q must be [P, Lpad, Hq, D], got {tuple(q.shape)}")
    N, Hkv, BS, D, G = _check_cache(name, q, k_cache, v_cache)
    P, Lpad = q.shape[0], q.shape[1]
    _check(all(t.dtype == torch.int32 for t in (block_tables, start_pos, true_len)),
           f"{name}: block_tables, start_pos and true_len must be int32")
    _check(block_tables.dim() == 2 and block_tables.shape[0] == P
           and tuple(start_pos.shape) == (P,) and tuple(true_len.shape) == (P,),
           f"{name}: block_tables must be [P, MB], start_pos and true_len [P]"
           f" for P={P}")
    _check_tensors(name, q.device, q=q, k_cache=k_cache, v_cache=v_cache,
                   block_tables=block_tables, start_pos=start_pos,
                   true_len=true_len)
    out = torch.empty_like(q)
    if P == 0 or Lpad == 0:
        return out
    with torch.cuda.device(q.device):
        FLASH_PREFILL.launch(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            block_tables.data_ptr(), start_pos.data_ptr(), true_len.data_ptr(),
            out.data_ptr(), P, Lpad, Hkv, G, D, N, BS, block_tables.shape[1],
            float(scale), int(window), _stream(q.device),
        )
    return out
