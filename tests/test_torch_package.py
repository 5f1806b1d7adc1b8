"""Package rules of the PyTorch port: it imports neither jax nor the JAX
package (statically, and at run time in a subprocess that blocks both),
asking for CUDA without a card raises instead of falling back to the CPU,
and chip_smoke.py refuses to run without CUDA."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from xllm_service_tpu_torch.device import resolve_device  # noqa: E402
from xllm_service_tpu_torch.runtime.block_manager import (  # noqa: E402
    BlockManager,
    OutOfBlocksError,
)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "xllm_service_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "xllm_service_tpu"}


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_no_jax_or_jax_package_imports_in_the_port():
    bad = []
    for path in _port_sources():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.relative_to(ROOT)}:{node.lineno} {n}" for n in names
                    if n.split(".")[0] in FORBIDDEN]
    assert not bad, bad


_BLOCKED_IMPORT = """
import importlib, pkgutil, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {"jax", "jaxlib", "xllm_service_tpu"}:
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, Block())
import xllm_service_tpu_torch as pkg
mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for m in mods:
    importlib.import_module(m)
assert not any(k.split(".")[0] in {"jax", "xllm_service_tpu"} for k in sys.modules)
print("imported", len(mods))
"""


def test_port_imports_with_jax_and_jax_package_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert int(proc.stdout.split()[-1]) >= 15


def test_chip_smoke_refuses_to_run_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU; the refusal needs one without")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          capture_output=True, text=True, timeout=180)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_cuda_is_never_silently_replaced_by_the_cpu():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        for dev in (None, "cuda"):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                resolve_device(dev)


def test_block_manager_keeps_block_zero_reserved():
    bm = BlockManager(5)
    got = bm.allocate(4)
    assert sorted(got) == [1, 2, 3, 4] and bm.num_free_blocks == 0
    with pytest.raises(OutOfBlocksError):
        bm.allocate(1)
    bm.free(got[:2])
    with pytest.raises(RuntimeError, match="double free"):
        bm.free(got[:1])
    assert bm.num_free_blocks == 2 and 0 not in bm.allocate(2)
