"""Standalone engine instance over HTTP (PyTorch port of the direct-mode
serving path of xllm_service_tpu/api/instance.py).

Routes: GET /health and POST /v1/completions (OpenAI text completions:
`prompt` as a string or an array of token ids, `max_tokens`,
`temperature`, `top_p`, `top_k`, `min_p`, `seed`, `ignore_eos`,
`logprobs`, and `stream` as server-sent events). Each choice
also carries the generated `token_ids`. Registering with a master and the
chat route are not ported yet.

Run:  python -m xllm_service_tpu_torch.api.instance --model llama3-8b
"""

from __future__ import annotations

import argparse
import json
import logging
import queue
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional

from xllm_service_tpu_torch.api.protocol import parse_prompt_field, sampling_from_body
from xllm_service_tpu_torch.common.config import EngineConfig
from xllm_service_tpu_torch.common.types import RequestOutput, StatusCode
from xllm_service_tpu_torch.runtime.engine import EngineRequest, InferenceEngine
from xllm_service_tpu_torch.tokenizer.tokenizer import (
    IncrementalDetokenizer,
    Tokenizer,
    create_tokenizer,
)

logger = logging.getLogger(__name__)

# A request that produces nothing for this long is cancelled.
GENERATION_TIMEOUT_S = 600.0


def _http_status(code: StatusCode) -> int:
    return {
        StatusCode.INVALID_ARGUMENT: 400,
        StatusCode.RESOURCE_EXHAUSTED: 429,
    }.get(code, 500)


class InstanceServer:
    """One engine behind a threaded HTTP front door."""

    def __init__(self, engine_cfg: EngineConfig, host: str = "127.0.0.1",
                 port: int = 0, device=None,
                 engine: Optional[InferenceEngine] = None,
                 tokenizer: Optional[Tokenizer] = None):
        self.cfg = engine_cfg
        self.tokenizer = tokenizer or create_tokenizer("")
        eos = self.tokenizer.eos_token_id
        self.engine = engine or InferenceEngine(
            engine_cfg, eos_token_ids=(eos,) if eos is not None else (), device=device
        )
        self._httpd = ThreadingHTTPServer((host, port), self._handler_class())
        self._httpd.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"{host}:{port}"

    def start(self) -> None:
        self.engine.start()
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="instance-http", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10)
        self.engine.stop()

    # ------------------------------------------------------------ handler

    def _handler_class(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # route access logs to logging
                logger.debug("%s " + fmt, self.address_string(), *args)

            def do_GET(self):
                if self.path == "/health":
                    server._send_json(self, 200, {"status": "ok", "model": server.cfg.model})
                else:
                    server._send_error(self, 404, f"no route {self.path}")

            def do_POST(self):
                if self.path != "/v1/completions":
                    server._send_error(self, 404, f"no route {self.path}")
                    return
                try:
                    n = int(self.headers.get("Content-Length") or 0)
                    body = json.loads(self.rfile.read(n) or b"{}")
                except (ValueError, json.JSONDecodeError) as e:
                    server._send_error(self, 400, f"bad request body: {e}")
                    return
                server._complete(self, body)

        return Handler

    @staticmethod
    def _send_json(h: BaseHTTPRequestHandler, code: int, payload: Dict[str, Any]) -> None:
        data = json.dumps(payload).encode()
        h.send_response(code)
        h.send_header("Content-Type", "application/json")
        h.send_header("Content-Length", str(len(data)))
        h.end_headers()
        h.wfile.write(data)

    def _send_error(self, h, code: int, msg: str) -> None:
        self._send_json(h, code, {"error": {"message": msg, "code": code}})

    # ------------------------------------------------------------ completions

    def _complete(self, h: BaseHTTPRequestHandler, body: Dict[str, Any]) -> None:
        text, token_ids, err = parse_prompt_field(body.get("prompt", ""))
        if not err and not token_ids:
            token_ids = self.tokenizer.encode(text)
        if not err and not token_ids:
            err = "empty prompt"
        if not err:
            try:
                sampling = sampling_from_body(body, self.cfg.max_new_tokens_default)
            except (TypeError, ValueError) as e:
                err = str(e)
        if err:
            self._send_error(h, 400, err)
            return
        rid = "cmpl-" + uuid.uuid4().hex[:16]
        outputs: "queue.Queue[RequestOutput]" = queue.Queue()

        def callback(out: RequestOutput) -> bool:
            outputs.put(out)
            return True

        self.engine.add_request(EngineRequest(
            request_id=rid, prompt_token_ids=list(token_ids), sampling=sampling,
            callback=callback,
        ))
        base = {
            "id": rid, "object": "text_completion", "created": int(time.time()),
            "model": body.get("model", self.cfg.model),
        }
        detok = IncrementalDetokenizer(self.tokenizer)
        stream = bool(body.get("stream", False))
        if stream:
            h.send_response(200)
            h.send_header("Content-Type", "text/event-stream")
            h.send_header("Cache-Control", "no-cache")
            h.end_headers()
        text_parts: List[str] = []
        gen_ids: List[int] = []
        finish = None
        lps: List[float] = []
        while True:
            try:
                out = outputs.get(timeout=GENERATION_TIMEOUT_S)
            except queue.Empty:
                self.engine.cancel(rid)
                if not stream:
                    self._send_error(h, 504, "generation timeout")
                return
            if not out.status.ok():
                if stream:
                    self._sse(h, {"error": {"message": out.status.message,
                                            "code": int(out.status.code)}})
                else:
                    self._send_error(h, _http_status(out.status.code), out.status.message)
                return
            new_ids = [t for o in out.outputs for t in o.token_ids]
            delta = detok.push(new_ids)
            if out.finished:
                delta += detok.flush()
                finish = next((o.finish_reason.to_string() for o in out.outputs), None)
            gen_ids += new_ids
            lps += [lp.data.logprob for o in out.outputs for lp in o.logprobs]
            if stream:
                ok = self._sse(h, dict(base, choices=[{
                    "index": 0, "text": delta, "token_ids": new_ids,
                    "logprobs": None, "finish_reason": finish,
                }]))
                if not ok:
                    self.engine.cancel(rid)
                    return
            else:
                text_parts.append(delta)
            if out.finished:
                break
        usage = {
            "prompt_tokens": len(token_ids), "completion_tokens": len(gen_ids),
            "total_tokens": len(token_ids) + len(gen_ids),
        }
        if stream:
            self._sse(h, dict(base, choices=[], usage=usage))
            self._sse_done(h)
            return
        choice = {
            "index": 0, "text": "".join(text_parts), "token_ids": gen_ids,
            "logprobs": {"token_logprobs": lps} if sampling.logprobs else None,
            "finish_reason": finish or "stop",
        }
        self._send_json(h, 200, dict(base, choices=[choice], usage=usage))

    @staticmethod
    def _sse(h: BaseHTTPRequestHandler, payload: Dict[str, Any]) -> bool:
        try:
            h.wfile.write(b"data: " + json.dumps(payload).encode() + b"\n\n")
            h.wfile.flush()
            return True
        except OSError:  # client went away
            return False

    @staticmethod
    def _sse_done(h: BaseHTTPRequestHandler) -> None:
        try:
            h.wfile.write(b"data: [DONE]\n\n")
            h.wfile.flush()
        except OSError:
            pass


def main(argv=None) -> None:
    ap = argparse.ArgumentParser("xllm-service-tpu-torch instance")
    ap.add_argument("--model", default="llama3-8b")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=9888)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--num-blocks", type=int, default=0)
    ap.add_argument("--block-size", type=int, default=128)
    ap.add_argument("--max-running-requests", type=int, default=64)
    ap.add_argument("--max-prefill-tokens", type=int, default=8192)
    ap.add_argument("--max-seq-len", type=int, default=8192)
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    cfg = EngineConfig(
        model=args.model, dtype=args.dtype, num_blocks=args.num_blocks,
        block_size=args.block_size, max_running_requests=args.max_running_requests,
        max_prefill_tokens=args.max_prefill_tokens, max_seq_len=args.max_seq_len,
    )
    server = InstanceServer(cfg, host=args.host, port=args.port, device=args.device)
    server.start()
    logger.info("serving %s on http://%s", args.model, server.address)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()


if __name__ == "__main__":
    main()
