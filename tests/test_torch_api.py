"""HTTP round trip through the port's standalone instance on the CPU
(llama3-tiny, f32): /health, and /v1/completions both streamed and not,
which must emit the same greedy tokens."""

import json
import urllib.error
import urllib.request

import pytest

torch = pytest.importorskip("torch")

from xllm_service_tpu_torch.api.instance import InstanceServer  # noqa: E402
from xllm_service_tpu_torch.common.config import EngineConfig  # noqa: E402


@pytest.fixture(scope="module")
def server():
    cfg = EngineConfig(model="llama3-tiny", dtype="float32", block_size=16, num_blocks=32,
                       max_running_requests=2, max_prefill_tokens=32, max_seq_len=128,
                       prefill_buckets=[16, 32])
    srv = InstanceServer(cfg, device="cpu")
    srv.start()
    yield srv
    srv.stop()


def _post(srv, body):
    req = urllib.request.Request(
        f"http://{srv.address}/v1/completions", json.dumps(body).encode(),
        {"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.read().decode()


def test_health(server):
    with urllib.request.urlopen(f"http://{server.address}/health", timeout=30) as r:
        assert json.loads(r.read())["status"] == "ok"


def test_completions_stream_and_not_agree(server):
    body = {"prompt": "the port serves over http", "max_tokens": 6, "temperature": 0,
            "ignore_eos": True}
    full = json.loads(_post(server, body))
    choice = full["choices"][0]
    assert len(choice["token_ids"]) == 6 and choice["finish_reason"] == "length"
    assert full["usage"] == {"prompt_tokens": 25, "completion_tokens": 6, "total_tokens": 31}

    events = [ln[6:] for ln in _post(server, dict(body, stream=True)).splitlines()
              if ln.startswith("data: ")]
    assert events[-1] == "[DONE]"
    chunks = [json.loads(e) for e in events[:-1]]
    ids = [t for c in chunks for ch in c["choices"] for t in ch["token_ids"]]
    assert ids == choice["token_ids"]
    assert "".join(ch["text"] for c in chunks for ch in c["choices"]) == choice["text"]
    assert chunks[-1]["usage"]["completion_tokens"] == 6


def test_token_id_prompt_and_bad_requests(server):
    out = json.loads(_post(server, {"prompt": [5, 6, 7], "max_tokens": 2,
                                    "temperature": 0.8, "seed": 1, "ignore_eos": True}))
    assert len(out["choices"][0]["token_ids"]) == 2
    for bad, code in (({"prompt": []}, 400), ({"prompt": "x", "presence_penalty": 1.0}, 400),
                      ({"prompt": [1] * 200}, 400)):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(server, dict(bad, max_tokens=2))
        assert e.value.code == code
