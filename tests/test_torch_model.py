"""The port's llama steps against the JAX package's on tiny configs, through
the parameter bridge: same seeded parameters, same token streams, f32 on
the CPU. Logits and caches agree to 1e-4 (two layers of f32 sums taken in
another order)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from xllm_service_tpu.models import llama as jllama  # noqa: E402
from xllm_service_tpu.models.configs import get_model_config as jax_model_config  # noqa: E402
from xllm_service_tpu_torch.models import llama as tllama  # noqa: E402
from xllm_service_tpu_torch.models.configs import get_model_config  # noqa: E402
from xllm_service_tpu_torch.runtime.weights import params_from_numpy  # noqa: E402
from tests.test_torch_ops import no_persistent_jax_cache  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("no_persistent_jax_cache")

TOL = dict(atol=1e-4, rtol=1e-4)
N_BLOCKS, BS, MB = 24, 16, 4


class Pair:
    """The JAX model and the port, fed the same inputs step by step."""

    def __init__(self, name: str):
        self.jcfg, self.tcfg = jax_model_config(name), get_model_config(name)
        np_params = jax.device_get(jllama.init_params(self.jcfg, jax.random.key(3), jnp.float32))
        self.jp = np_params
        self.tp = params_from_numpy(np_params, self.tcfg, "cpu", torch.float32)
        shape = (self.jcfg.num_layers, N_BLOCKS, self.jcfg.num_kv_heads, BS, self.jcfg.head_dim)
        self.jk = self.jv = jnp.zeros(shape, jnp.float32)
        self.tk, self.tv = torch.zeros(shape), torch.zeros(shape)

    def check_caches(self):
        # Block 0 takes every masked write; which duplicate lands last is
        # unspecified, so it is not compared.
        np.testing.assert_allclose(self.tk[:, 1:].numpy(), np.asarray(self.jk)[:, 1:], **TOL)
        np.testing.assert_allclose(self.tv[:, 1:].numpy(), np.asarray(self.jv)[:, 1:], **TOL)

    def prefill(self, tokens, start, lens, tables):
        args = [np.asarray(a, np.int32) for a in (tokens, start, lens, tables)]
        ref, self.jk, self.jv = jllama.prefill_batch_step(
            self.jp, self.jcfg, self.jk, self.jv, *map(jnp.asarray, args))
        got, _, _ = tllama.prefill_batch_step(
            self.tp, self.tcfg, self.tk, self.tv, *map(torch.from_numpy, args))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
        self.check_caches()

    def decode(self, tokens, positions, tables, active):
        args = [np.asarray(a, np.int32) for a in (tokens, positions, tables)]
        act = np.asarray(active, bool)
        ref, self.jk, self.jv = jllama.decode_step(
            self.jp, self.jcfg, self.jk, self.jv, *map(jnp.asarray, args), jnp.asarray(act))
        got, _, _ = tllama.decode_step(
            self.tp, self.tcfg, self.tk, self.tv, *map(torch.from_numpy, args),
            torch.from_numpy(act))
        # Inactive rows are garbage in both (the port zeros their attention).
        np.testing.assert_allclose(got.numpy()[act], np.asarray(ref)[act], **TOL)
        self.check_caches()

    def mixed(self, dec, pf):
        d = [np.asarray(a, np.int32) for a in dec[:3]]
        act = np.asarray(dec[3], bool)
        p = [np.asarray(a, np.int32) for a in pf]
        ref_d, ref_p, self.jk, self.jv = jllama.mixed_step(
            self.jp, self.jcfg, self.jk, self.jv, *map(jnp.asarray, d), jnp.asarray(act),
            *map(jnp.asarray, p))
        got_d, got_p, _, _ = tllama.mixed_step(
            self.tp, self.tcfg, self.tk, self.tv, *map(torch.from_numpy, d),
            torch.from_numpy(act), *map(torch.from_numpy, p))
        np.testing.assert_allclose(got_d.numpy()[act], np.asarray(ref_d)[act], **TOL)
        np.testing.assert_allclose(got_p.numpy(), np.asarray(ref_p), **TOL)
        self.check_caches()


def _tokens(rng, n, vocab):
    return rng.integers(3, vocab, size=n).astype(np.int32)


@pytest.mark.parametrize("name", ["llama3-tiny", "qwen3-tiny", "gemma-tiny"])
def test_steps_match_jax(name):
    """llama3 (GQA), qwen3 (QK-norm, head_dim 24) and gemma (tied head,
    GELU-tanh, scaled embeddings) through prefill, chunked prefill,
    decode with an inactive slot, and a mixed step."""
    m = Pair(name)
    V = m.tcfg.vocab_size
    rng = np.random.default_rng(0)
    a, b, c = _tokens(rng, 23, V), _tokens(rng, 26, V), _tokens(rng, 9, V)
    ta, tb, tc = [1, 2, 0, 0], [3, 4, 0, 0], [5, 0, 0, 0]
    # Batched prefill: a whole, b's first chunk (padded rows, ragged lengths).
    tok = np.zeros((2, 32), np.int32)
    tok[0, :20], tok[1, :16] = a[:20], b[:16]
    m.prefill(tok, [0, 0], [20, 16], [ta, tb])
    # b's second chunk continues at position 16 (chunked prefill).
    m.prefill(b[None, 16:24], [16], [8], [tb])
    # Decode: a at 20, an inactive slot, b at 24.
    m.decode([a[20], 0, b[24]], [20, 0, 24], [ta, [0] * MB, tb], [True, False, True])
    # Mixed: both decode slots advance while c prefills.
    tok = np.zeros((1, 16), np.int32)
    tok[0, :9] = c
    m.mixed(([a[21], 0, b[25]], [21, 0, 25], [ta, [0] * MB, tb], [True, False, True]),
            (tok, [0], [9], [tc]))
