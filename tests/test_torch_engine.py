"""The port's engine against the JAX package's engine: same llama3-tiny
parameters (bridged), same prompts, greedy, f32 on the CPU. The JAX
engine runs its synchronous mode; the port runs its synchronous mixed
prefill+decode steps. Prompts span several KV blocks and several prefill
chunks, and more requests arrive than there are slots. The emitted token
streams must be equal."""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from xllm_service_tpu.common.config import EngineConfig as JaxEngineConfig  # noqa: E402
from xllm_service_tpu.ops.sampling import SamplingParams as JaxSamplingParams  # noqa: E402
from xllm_service_tpu.runtime.engine import EngineRequest as JaxEngineRequest  # noqa: E402
from xllm_service_tpu.runtime.engine import InferenceEngine as JaxEngine  # noqa: E402
from xllm_service_tpu.runtime.executor import ModelExecutor as JaxExecutor  # noqa: E402
from xllm_service_tpu_torch.common.config import EngineConfig  # noqa: E402
from xllm_service_tpu_torch.models import llama  # noqa: E402
from xllm_service_tpu_torch.models.configs import get_model_config  # noqa: E402
from xllm_service_tpu_torch.ops.sampling import SamplingParams  # noqa: E402
from xllm_service_tpu_torch.runtime.engine import EngineRequest, InferenceEngine  # noqa: E402
from xllm_service_tpu_torch.runtime.executor import ModelExecutor  # noqa: E402
from xllm_service_tpu_torch.runtime.weights import params_from_numpy  # noqa: E402
from tests.test_torch_ops import no_persistent_jax_cache  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("no_persistent_jax_cache")

BS = 16
ENGINE = dict(
    model="llama3-tiny", dtype="float32", block_size=BS, num_blocks=48,
    max_running_requests=4, max_prefill_tokens=40, max_seq_len=256,
    prefill_buckets=[16, 32, 64],
)
LENGTHS = (5, 17, 33, 50, 70, 91)
MAX_NEW = 8


def _prompts():
    rng = np.random.default_rng(123)
    return [rng.integers(3, 512, n).tolist() for n in LENGTHS]


def _run(engine, make_request, sampling):
    """Submit every prompt at once; return {request id: token stream}."""
    streams, events = {}, []
    for i, prompt in enumerate(_prompts()):
        out, ev = [], threading.Event()

        def cb(o, out=out, ev=ev):
            assert o.status.ok(), o.status.message
            for s in o.outputs:
                out.extend(s.token_ids)
            if o.finished:
                ev.set()
            return True

        streams[f"r{i}"] = out
        events.append(ev)
        engine.add_request(make_request(f"r{i}", prompt, sampling, cb))
    engine.start()
    try:
        for ev in events:
            assert ev.wait(120.0)
    finally:
        engine.stop()
    return streams


def _margin(params, cfg, tokens):
    """Top-2 logit margin of the port's model after `tokens`."""
    n_blocks = len(tokens) // BS + 2
    shape = (cfg.num_layers, n_blocks, cfg.num_kv_heads, BS, cfg.head_dim)
    k, v = torch.zeros(shape), torch.zeros(shape)
    i32 = lambda *x: torch.tensor(x, dtype=torch.int32)  # noqa: E731
    logits, _, _ = llama.prefill_batch_step(
        params, cfg, k, v, torch.tensor([tokens]), i32(0), i32(len(tokens)),
        torch.arange(1, n_blocks, dtype=torch.int32)[None])
    top = torch.topk(logits[0], 2)
    return float(top.values[0] - top.values[1]), top.indices.tolist()


def test_port_engine_greedy_streams_equal_jax_sync_engine():
    jex = JaxExecutor(JaxEngineConfig(**ENGINE), init_seed=5)
    jeng = JaxEngine(JaxEngineConfig(**ENGINE, sync_engine=True, enable_mixed_step=True),
                     executor=jex)
    ref = _run(jeng, lambda rid, p, s, cb: JaxEngineRequest(rid, p, s, cb),
               JaxSamplingParams(temperature=0.0, max_new_tokens=MAX_NEW))

    cfg = EngineConfig(**ENGINE)
    params = params_from_numpy(jax.device_get(jex.params), get_model_config(cfg.model),
                               "cpu", torch.float32)
    ex = ModelExecutor(cfg, params=params, device="cpu")
    eng = InferenceEngine(cfg, executor=ex)
    got = _run(eng, lambda rid, p, s, cb: EngineRequest(rid, p, s, cb),
               SamplingParams(temperature=0.0, max_new_tokens=MAX_NEW))
    # Every prompt token was prefilled exactly once, and decode rows rode
    # along with prefill chunks.
    assert eng.prefill_tokens == sum(LENGTHS) and eng.mixed_steps > 0
    prompts = _prompts()
    for i, rid in enumerate(sorted(ref)):
        if got[rid] != ref[rid]:
            j = next(j for j, (a, b) in enumerate(zip(got[rid], ref[rid])) if a != b)
            margin, top2 = _margin(ex.params, ex.cfg, prompts[i] + ref[rid][:j])
            pytest.fail(
                f"{rid}: first differing token at index {j} "
                f"(port {got[rid][j]}, jax {ref[rid][j]}); port top-2 {top2}, "
                f"logit margin {margin:.3g}"
            )
        assert len(got[rid]) == MAX_NEW


def test_port_engine_admission_rejects_and_cancels():
    """Requests the engine cannot serve end with a status instead of
    waiting; a callback returning False cancels and frees the slot and its
    blocks; a request waits while the pool is held and then runs."""
    from xllm_service_tpu_torch.common.types import StatusCode

    cfg = EngineConfig(**dict(ENGINE, num_blocks=8, max_running_requests=2))
    eng = InferenceEngine(cfg, device="cpu")
    finals = {}

    def add(rid, prompt, stop_after=None, **sp):
        seen = []

        def cb(o):
            seen.extend(t for s in o.outputs for t in s.token_ids)
            if o.finished:
                finals[rid] = (o.status.code, len(seen), o.cancelled)
            return stop_after is None or len(seen) < stop_after

        eng.add_request(EngineRequest(rid, prompt, SamplingParams(**sp), cb))

    add("too-long", [5] * 256, temperature=0.0)
    add("too-big", [5] * 100, temperature=0.0, max_new_tokens=100)
    add("penalty", [5] * 4, temperature=0.0, presence_penalty=0.5)
    add("cancel", [5] * 20, stop_after=2, temperature=0.0, max_new_tokens=50)
    add("holds", [6] * 40, temperature=0.0, max_new_tokens=40)  # 5 of 7 blocks
    add("waits", [7] * 40, temperature=0.0, max_new_tokens=20)
    for _ in range(200):
        if not eng.has_work():
            break
        eng.step()
    assert finals["too-long"][0] == StatusCode.INVALID_ARGUMENT
    assert finals["too-big"][0] == StatusCode.RESOURCE_EXHAUSTED
    assert finals["penalty"][0] == StatusCode.INVALID_ARGUMENT
    assert finals["cancel"] == (StatusCode.CANCELLED, 2, True)
    assert finals["holds"] == (StatusCode.OK, 40, False)
    assert finals["waits"] == (StatusCode.OK, 20, False)
    assert eng.block_mgr.num_free_blocks == 7 and len(eng._free_slots) == 2
