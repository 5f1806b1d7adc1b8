"""PyTorch port ops against the JAX package's ops on the same seeded numpy
inputs, on the CPU in float32 (atol = rtol = 1e-5)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental.compilation_cache import compilation_cache  # noqa: E402

from xllm_service_tpu.models.configs import get_model_config as jax_model_config  # noqa: E402
from xllm_service_tpu.ops import kv_cache as jkv  # noqa: E402
from xllm_service_tpu.ops import norms as jnorms  # noqa: E402
from xllm_service_tpu.ops import rope as jrope  # noqa: E402
from xllm_service_tpu.ops import sampling as jsampling  # noqa: E402
from xllm_service_tpu_torch.models.configs import ModelConfig, get_model_config  # noqa: E402
from xllm_service_tpu_torch.ops import kv_cache as tkv  # noqa: E402
from xllm_service_tpu_torch.ops import norms as tnorms  # noqa: E402
from xllm_service_tpu_torch.ops import rope as trope  # noqa: E402
from xllm_service_tpu_torch.ops import sampling as tsampling  # noqa: E402


@pytest.fixture(scope="module")
def no_persistent_jax_cache():
    """Run a module's JAX reference programs outside the suite's shared
    persistent compilation cache (tests/conftest.py), then put the cache
    back as it was. The port tests (tests/test_torch_*.py import this)
    compile JAX programs that other test files compile too; this way they
    neither write entries those files would load nor load theirs, so
    adding the port tests leaves what the rest of the suite compiles and
    loads as it was."""
    was = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    compilation_cache.reset_cache()
    yield
    jax.config.update("jax_enable_compilation_cache", was)
    compilation_cache.reset_cache()


pytestmark = pytest.mark.usefixtures("no_persistent_jax_cache")

TOL = dict(atol=1e-5, rtol=1e-5)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_registry_copy_matches_jax():
    """The port's config registry is a copy: same names, same fields."""
    for name in ("llama3-tiny", "llama3-8b", "qwen3-tiny", "gemma-tiny"):
        assert get_model_config(name).__dict__ == jax_model_config(name).__dict__


def test_kv_cache_scatter_gather_set_blocks():
    rng = np.random.default_rng(0)
    N, H, BS, D, T = 6, 2, 4, 8, 9
    cache = rng.standard_normal((N, H, BS, D)).astype(np.float32)
    slots = rng.choice(np.arange(1, N * BS), size=T, replace=False)
    blk, off = (slots // BS).astype(np.int32), (slots % BS).astype(np.int32)
    rows = rng.standard_normal((T, H, D)).astype(np.float32)
    ref = jkv.scatter_rows(jnp.asarray(cache), jnp.asarray(blk), jnp.asarray(off), jnp.asarray(rows))
    got = tkv.scatter_rows(_t(cache.copy()), _t(blk), _t(off), _t(rows))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)

    table = rng.integers(0, N, size=(3, 2)).astype(np.int32)
    np.testing.assert_allclose(
        tkv.gather_blocks(got, _t(table)).numpy(),
        np.asarray(jkv.gather_blocks(ref, jnp.asarray(table))), **TOL,
    )

    pool = rng.standard_normal((2, N, H, BS, D)).astype(np.float32)
    ids = np.array([4, 1], np.int32)
    blocks = rng.standard_normal((2, 2, H, BS, D)).astype(np.float32)
    ref = jkv.set_blocks(jnp.asarray(pool), jnp.asarray(ids), jnp.asarray(blocks))
    got = tkv.set_blocks(_t(pool.copy()), _t(ids), _t(blocks))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_alloc_cache_zeroed_and_int8_refused():
    c = tkv.alloc_cache((2, 3, 2, 4, 8), torch.float32, torch.device("cpu"))
    assert c.shape == (2, 3, 2, 4, 8) and not c.any()
    with pytest.raises(NotImplementedError):
        tkv.alloc_cache((2, 3, 2, 4, 8), torch.float32, torch.device("cpu"), quantized=True)


def test_rms_norm_matches():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((5, 32)).astype(np.float32)
    w = rng.standard_normal((32,)).astype(np.float32)
    ref = jnorms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)
    np.testing.assert_allclose(tnorms.rms_norm(_t(x), _t(w), 1e-5).numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("scaling", ["", "llama3"])
def test_rope_matches(scaling):
    rng = np.random.default_rng(2)
    cfg = ModelConfig(
        name="rope-test", vocab_size=8, hidden_size=64, intermediate_size=8,
        num_layers=1, num_heads=2, num_kv_heads=2, head_dim=32,
        rope_scaling_type=scaling, rope_scaling_factor=8.0,
        rope_original_max_position=64, max_position_embeddings=512,
    )
    x = rng.standard_normal((7, 2, 32)).astype(np.float32)
    pos = rng.integers(0, 500, size=(7,)).astype(np.int32)
    inv_j, scale_j = jrope.rope_parameters(32, cfg)
    inv_t, scale_t = trope.rope_parameters(32, cfg)
    np.testing.assert_allclose(inv_t, inv_j, **TOL)
    assert scale_t == scale_j
    ref = jrope.apply_rope_scaled(jnp.asarray(x), jnp.asarray(pos), cfg)
    got = trope.apply_rope_scaled(_t(x), _t(pos), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5, rtol=1e-5)


def test_unported_rope_scaling_raises():
    cfg = get_model_config("deepseek-v3")  # yarn
    with pytest.raises(NotImplementedError):
        trope.rope_parameters(64, cfg)


def test_top_k_top_p_min_p_masks_match():
    rng = np.random.default_rng(3)
    R, V = 6, 50
    logits = rng.standard_normal((R, V)).astype(np.float32) * 3
    top_k = np.array([0, 5, 1, 50, 3, 0], np.int32)
    # Every row filters: with all three off, both versions keep the tail
    # only up to f32 rounding of the cumulative mass near 1.
    top_p = np.array([0.95, 0.9, 0.5, 0.3, 1.0, 0.7], np.float32)
    min_p = np.array([0.0, 0.0, 0.1, 0.0, 0.2, 0.05], np.float32)
    ref = jsampling.apply_top_k_top_p(
        jnp.asarray(logits), jnp.asarray(top_k), jnp.asarray(top_p), jnp.asarray(min_p)
    )
    got = tsampling.apply_top_k_top_p(_t(logits), _t(top_k), _t(top_p), _t(min_p))
    np.testing.assert_array_equal(got.numpy() > -1e29, np.asarray(ref) > -1e29)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_greedy_sampling_with_bias_and_penalties_matches():
    """Greedy picks, chosen logprobs and the full logprob rows match JAX
    through the bias -> penalties order."""
    rng = np.random.default_rng(4)
    R, V = 5, 40
    logits = rng.standard_normal((R, V)).astype(np.float32)
    counts = rng.integers(0, 3, size=(R, V)).astype(np.int32)
    presence = np.array([0.0, 0.5, 0.0, 1.0, 0.2], np.float32)
    frequency = np.array([0.0, 0.0, 0.3, 0.1, 0.2], np.float32)
    bias_ids = rng.integers(0, V, size=(R, 3)).astype(np.int32)
    bias_vals = rng.standard_normal((R, 3)).astype(np.float32) * 2
    zeros_i = np.zeros((R,), np.int32)
    temp = np.zeros((R,), np.float32)
    top_p = np.ones((R,), np.float32)
    keys = jsampling.make_step_keys(jnp.zeros((R,), jnp.uint32), 0)
    ref_tok, ref_lp, ref_full = jsampling.sample_tokens(
        jnp.asarray(logits), jnp.asarray(temp), jnp.asarray(zeros_i), jnp.asarray(top_p),
        keys, counts=jnp.asarray(counts), presence=jnp.asarray(presence),
        frequency=jnp.asarray(frequency), bias_ids=jnp.asarray(bias_ids),
        bias_vals=jnp.asarray(bias_vals),
    )
    tok, lp, full = tsampling.sample_tokens(
        _t(logits), _t(temp), _t(zeros_i), _t(top_p),
        counts=_t(counts), presence=_t(presence), frequency=_t(frequency),
        bias_ids=_t(bias_ids), bias_vals=_t(bias_vals),
    )
    np.testing.assert_array_equal(tok.numpy(), np.asarray(ref_tok))
    np.testing.assert_allclose(lp.numpy(), np.asarray(ref_lp), **TOL)
    np.testing.assert_allclose(full.numpy(), np.asarray(ref_full), **TOL)


def test_seeded_sampling_is_reproducible_and_respects_filters():
    """Seeded draws repeat for the same (seed, step), move with the step,
    and never leave the top-k set."""
    rng = np.random.default_rng(5)
    R, V = 4, 64
    logits = _t(rng.standard_normal((R, V)).astype(np.float32))
    temp = torch.full((R,), 0.8)
    top_k = torch.full((R,), 4, dtype=torch.int32)
    top_p = torch.ones(R)
    seeds, steps = [7, 7, 8, 9], [0, 1, 0, 0]
    a, _, _ = tsampling.sample_tokens(logits, temp, top_k, top_p, seeds=seeds, steps=steps)
    b, _, _ = tsampling.sample_tokens(logits, temp, top_k, top_p, seeds=seeds, steps=steps)
    assert torch.equal(a, b)
    allowed = torch.topk(logits, 4, dim=-1).indices
    assert all(int(a[r]) in allowed[r].tolist() for r in range(R))
    draws = {
        int(tsampling.sample_tokens(logits[:1], temp[:1], top_k[:1] * 0 + 64, top_p[:1],
                                    seeds=[7], steps=[s])[0][0])
        for s in range(12)
    }
    assert len(draws) > 1
