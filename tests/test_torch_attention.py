"""The port's plain attention versions (the references its CUDA kernels are
held against on the card) against the JAX package's oracles and its
Pallas kernels in interpret mode, on the same seeded numpy inputs, f32 on
the CPU (atol = rtol = 1e-5). Shapes follow tests/test_pallas_kernels.py
(D 128, BS 16)."""

from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from xllm_service_tpu.ops import attention as jattn  # noqa: E402
from xllm_service_tpu.ops.pallas.flash_prefill import flash_prefill_kernel  # noqa: E402
from xllm_service_tpu.ops.pallas.paged_attention import paged_attention_kernel  # noqa: E402
from xllm_service_tpu_torch.ops import attention as tattn  # noqa: E402
from xllm_service_tpu_torch.ops import kernels  # noqa: E402
from tests.test_torch_ops import no_persistent_jax_cache  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("no_persistent_jax_cache")

TOL = dict(atol=1e-5, rtol=1e-5)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _decode_case(rng, R=4, Hq=8, Hkv=4, D=128, BS=16, MB=8, N=64):
    q = rng.standard_normal((R, Hq, D)).astype(np.float32)
    k = rng.standard_normal((N, Hkv, BS, D)).astype(np.float32)
    v = rng.standard_normal((N, Hkv, BS, D)).astype(np.float32)
    bt = rng.choice(np.arange(1, N), size=(R, MB), replace=False).astype(np.int32)
    return q, k, v, bt


@pytest.mark.parametrize("gqa", [1, 2, 4])
@pytest.mark.parametrize("window", [0, 24])
def test_plain_decode_matches_jax_gather_and_kernel(gqa, window):
    rng = np.random.default_rng(10 + gqa)
    q, k, v, bt = _decode_case(rng, Hq=4 * gqa, Hkv=4)
    seq_lens = np.array([1, 0, 77, 128], np.int32)  # row 1 is a dead slot
    scale = 1.0 / np.sqrt(q.shape[-1])
    got = tattn.paged_attention_gather(_t(q), _t(k), _t(v), _t(bt), _t(seq_lens), scale,
                                       window=window).numpy()
    ref = np.asarray(jattn.paged_attention_gather(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bt),
        jnp.asarray(seq_lens), scale, window=window))
    live = seq_lens > 0  # the JAX gather oracle averages a dead row; ours zeros it
    np.testing.assert_allclose(got[live], ref[live], **TOL)
    kern = np.asarray(paged_attention_kernel(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bt),
        jnp.asarray(seq_lens), scale, interpret=True, window=window))
    np.testing.assert_allclose(got, kern, **TOL)
    assert not got[~live].any()


def _prefill_case(rng, P=3, Lpad=48, Hq=8, Hkv=4, D=128, BS=16, MB=8, N=64):
    q = rng.standard_normal((P, Lpad, Hq, D)).astype(np.float32)
    k = rng.standard_normal((N, Hkv, BS, D)).astype(np.float32)
    v = rng.standard_normal((N, Hkv, BS, D)).astype(np.float32)
    bt = rng.choice(np.arange(1, N), size=(P, MB), replace=False).astype(np.int32)
    return q, k, v, bt


@pytest.mark.parametrize("gqa", [1, 2, 4])
@pytest.mark.parametrize("window", [0, 20])
def test_plain_prefill_matches_jax_blockwise_and_kernel(gqa, window):
    rng = np.random.default_rng(20 + gqa)
    q, k, v, bt = _prefill_case(rng, Hq=4 * gqa, Hkv=4)
    start = np.array([0, 37, 64], np.int32)
    true_len = np.array([48, 13, 0], np.int32)  # ragged; row 2 is padding
    scale = 1.0 / np.sqrt(q.shape[-1])
    got = tattn.prefill_attention(_t(q), _t(k), _t(v), _t(bt), _t(start), _t(true_len),
                                  scale, window=window).numpy()
    for i in range(q.shape[0]):
        ref = np.asarray(jattn.prefill_attention_blockwise(
            jnp.asarray(q[i]), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bt[i]),
            jnp.asarray(start[i]), jnp.asarray(true_len[i]), scale, window=window))
        np.testing.assert_allclose(got[i], ref, **TOL)
        assert not got[i, true_len[i]:].any()  # rows past true_len are zeros
    kern = np.asarray(flash_prefill_kernel(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bt),
        jnp.asarray(start), jnp.asarray(true_len), scale, interpret=True, tile_q=16,
        window=window))
    np.testing.assert_allclose(got, kern, **TOL)


def test_mixed_attention_is_the_two_dispatchers():
    rng = np.random.default_rng(30)
    q_dec, k, v, bt_dec = _decode_case(rng, R=2)
    q_pf, _, _, bt_pf = _prefill_case(rng, P=2, Lpad=16)
    lens = _t(np.array([40, 0], np.int32))
    start, tl = _t(np.array([16, 0], np.int32)), _t(np.array([16, 9], np.int32))
    dec, pf = tattn.mixed_attention(_t(q_dec), _t(q_pf), _t(k), _t(v), _t(bt_dec), lens,
                                    _t(bt_pf), start, tl, 0.1)
    assert torch.equal(dec, tattn.paged_attention(_t(q_dec), _t(k), _t(v), _t(bt_dec), lens, 0.1))
    assert torch.equal(pf, tattn.prefill_attention(_t(q_pf), _t(k), _t(v), _t(bt_pf), start, tl, 0.1))


def test_dispatchers_refuse_other_devices():
    """No silent fallback: a tensor that is neither CPU nor CUDA raises,
    and the kernel wrappers refuse CPU tensors."""
    q = torch.empty((2, 4, 128), device="meta")
    cache = torch.empty((3, 2, 16, 128), device="meta")
    table = torch.empty((2, 2), dtype=torch.int32, device="meta")
    lens = torch.empty((2,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no implementation"):
        tattn.paged_attention(q, cache, cache, table, lens, 0.1)
    with pytest.raises(ValueError, match="needs CUDA"):
        kernels.paged_attention(torch.zeros(2, 4, 128), cache, cache, table, lens, 0.1)
    with pytest.raises(ValueError, match="needs CUDA"):
        kernels.flash_prefill(torch.zeros(1, 4, 4, 128), cache, cache, table, lens, lens, 0.1)


def test_kernel_report_and_sources():
    assert tattn.kernel_report("cpu") == {"decode": "gather", "prefill": "blockwise",
                                          "mixed": "split"}
    assert tattn.kernel_report("cuda")["decode"] == "cuda:paged_attention"
    assert tattn.kernel_report("cuda")["prefill"] == "cuda:flash_prefill"
    root = Path(__file__).resolve().parents[1]
    for k in kernels.KERNELS:
        text = k.source.read_text()
        assert k.symbol in text and "cudaGetLastError" in text
        path, line = k.replaces.split(":")
        src = (root / path).read_text()
        assert "pl.pallas_call" in src
        assert src.splitlines()[int(line) - 1].startswith(f"def {k.name}")
        assert kernels.launch_counts()[k.name] >= 0
