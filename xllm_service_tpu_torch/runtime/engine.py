"""Continuous-batching inference engine (PyTorch port of
xllm_service_tpu/runtime/engine.py, synchronous mixed stepping).

Each iteration builds ONE batch: every running decode slot plus the due
chunked-prefill rows (mid-prefill sequences first, then fresh admissions),
runs it as one mixed step (executor.mixed -> models.llama.mixed_step),
and books the results before the next iteration, which is the JAX
engine's sync mode with the mixed step. Prefill is chunked under a strict
per-step token budget (max_prefill_tokens); one step carries the chunks
of one length bucket, as in the JAX engine.

A request is admitted only when a slot is free and the pool can hold its
whole sequence (prompt + max_new_tokens, capped at max_seq_len): the
blocks are reserved at admission, so a running sequence never needs a
block it cannot get and nothing is ever preempted. Not ported yet: the
one-step-late overlap pipeline, preemption, the prefix cache and host/SSD
tiers, speculative and guided decoding, PD handoff, LoRA, media,
penalties and logit bias (requests asking for those are rejected).
"""

from __future__ import annotations

import collections
import logging
import math
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional, Tuple

import numpy as np

from xllm_service_tpu_torch.common.config import EngineConfig
from xllm_service_tpu_torch.common.types import (
    FinishReason,
    LogProb,
    LogProbData,
    RequestOutput,
    SequenceOutput,
    Status,
    StatusCode,
    Usage,
)
from xllm_service_tpu_torch.ops.sampling import SamplingParams
from xllm_service_tpu_torch.runtime.block_manager import BlockManager
from xllm_service_tpu_torch.runtime.executor import (
    ModelExecutor,
    PrefillItem,
    SamplingBatch,
)

logger = logging.getLogger(__name__)


@dataclass
class EngineRequest:
    request_id: str
    prompt_token_ids: List[int]
    sampling: SamplingParams
    # Called on the engine thread once per generated token (and once on
    # finish); return False to cancel.
    callback: Callable[[RequestOutput], bool]
    arrival_time: float = field(default_factory=time.monotonic)


class _Seq:
    __slots__ = ("req", "slot", "tokens", "block_ids", "generated", "prefilled")

    def __init__(self, req: EngineRequest, slot: int, block_ids: List[int]):
        self.req = req
        self.slot = slot
        self.tokens: List[int] = list(req.prompt_token_ids)
        self.block_ids = block_ids
        self.generated: List[Tuple[int, float]] = []  # (token, logprob)
        self.prefilled = 0  # prompt tokens whose K/V are in the cache


def _unsupported(s: SamplingParams) -> str:
    if s.presence_penalty or s.frequency_penalty:
        return "presence/frequency penalties are not supported yet"
    if s.logit_bias:
        return "logit_bias is not supported yet"
    return ""


class InferenceEngine:
    def __init__(
        self,
        engine_cfg: EngineConfig,
        executor: Optional[ModelExecutor] = None,
        eos_token_ids: Tuple[int, ...] = (),
        device=None,
    ):
        self.cfg = engine_cfg
        self.executor = executor or ModelExecutor(engine_cfg, device=device)
        self.eos_token_ids = set(eos_token_ids)
        self.block_size = self.executor.block_size
        self.R = self.executor.R
        self.max_blocks = self.executor.max_blocks_per_seq
        self.block_mgr = BlockManager(self.executor.num_blocks)

        self._lock = threading.Lock()
        self._waiting: Deque[EngineRequest] = collections.deque()  # guarded by _lock
        self._cancelled: set = set()  # guarded by _lock
        self._work = threading.Event()
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        # Engine-thread state.
        self._running: Dict[int, _Seq] = {}     # slot -> decoding seq
        self._prefilling: Dict[str, _Seq] = {}  # request id -> mid-prefill seq (FIFO)
        self._free_slots = list(range(self.R - 1, -1, -1))
        R = self.R
        self._block_tables = np.zeros((R, self.max_blocks), np.int32)
        self._temps = np.zeros((R,), np.float32)
        self._top_k = np.zeros((R,), np.int32)
        self._top_p = np.ones((R,), np.float32)
        self._min_p = np.zeros((R,), np.float32)
        self._seeds = np.zeros((R,), np.int64)
        # Counters (engine thread writes, readers tolerate a stale value).
        self.steps = 0
        self.mixed_steps = 0
        self.prefill_tokens = 0

    # ------------------------------------------------------------ public

    def add_request(self, req: EngineRequest) -> None:
        with self._lock:
            self._waiting.append(req)
        self._work.set()

    def cancel(self, request_id: str) -> None:
        with self._lock:
            self._cancelled.add(request_id)
        self._work.set()

    def has_work(self) -> bool:
        return bool(self._waiting or self._running or self._prefilling)

    def start(self) -> None:
        self._stop = False
        self._thread = threading.Thread(target=self._loop, name="engine", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop = True
        self._work.set()
        if self._thread is not None:
            self._thread.join(timeout=60)
            self._thread = None

    # ------------------------------------------------------------ loop

    def _loop(self) -> None:
        while not self._stop:
            if not self.has_work() and not self._cancelled:
                self._work.wait(timeout=0.05)
                self._work.clear()
                continue
            try:
                if self.step() == 0:
                    # Waiting work that cannot run yet (pool full): sleep
                    # until a finish or a new request sets the event.
                    self._work.wait(timeout=0.05)
                    self._work.clear()
            except Exception as e:  # keep serving: fail what was in the step
                logger.exception("engine step failed")
                self._fail_all(f"engine step failed: {e}")

    def step(self) -> int:
        """One iteration: admit, run one mixed (or decode) step, book it.
        Returns the number of tokens produced plus prefill chunks landed."""
        self._drain_cancelled()
        items_meta: List[Tuple[_Seq, int, int]] = []
        budget = self._continue_prefills(items_meta, self.cfg.max_prefill_tokens)
        self._admit(items_meta, budget)
        if not items_meta and not self._running:
            return 0
        R = self.R
        active = np.zeros((R,), bool)
        tokens_in = np.zeros((R,), np.int32)
        positions = np.zeros((R,), np.int32)
        steps = np.zeros((R,), np.int32)
        for slot, seq in self._running.items():
            active[slot] = True
            tokens_in[slot] = seq.tokens[-1]
            positions[slot] = len(seq.tokens) - 1
            steps[slot] = len(seq.generated)
        batch = SamplingBatch(
            self._temps, self._top_k, self._top_p, self._seeds, steps,
            min_p=self._min_p if self._min_p.any() else None,
        )
        items = [self._prefill_item(seq, start, n) for seq, start, n in items_meta]
        toks, lps = self.executor.mixed(
            items, tokens_in, positions, self._block_tables, active, batch
        )
        self.steps += 1
        self.mixed_steps += bool(items) and bool(active.any())
        produced = 0
        for slot in sorted(self._running):
            seq = self._running[slot]
            self._append(seq, int(toks[slot]), float(lps[slot]))
            produced += 1
        for j, (seq, start, n) in enumerate(items_meta):
            seq.prefilled = start + n
            self.prefill_tokens += n
            produced += 1
            if seq.prefilled < len(seq.tokens):
                continue  # partial chunk: the sampled token is discarded
            del self._prefilling[seq.req.request_id]
            self._install(seq)
            self._append(seq, int(toks[R + j]), float(lps[R + j]))
        return produced

    # ------------------------------------------------------------ admission

    def _continue_prefills(self, items_meta, budget: int) -> int:
        """Next chunk of every mid-prefill seq, FIFO, one length bucket
        per step (a mismatched seq stops the walk and rides the next)."""
        bucket = None
        for seq in self._prefilling.values():
            if budget <= 0 or len(items_meta) >= self.executor.PREFILL_GROUP_MAX:
                break
            chunk = min(len(seq.tokens) - seq.prefilled, budget)
            b = self.executor.bucket_len(chunk)
            if bucket is None:
                bucket = b
            elif b != bucket:
                break
            items_meta.append((seq, seq.prefilled, chunk))
            budget -= chunk
        return budget

    def _admit(self, items_meta, budget: int) -> None:
        """Admit waiting requests while the budget, a slot and the pool
        allow. An admitted seq holds its slot and blocks from here on; its
        first chunk rides this step if it shares the step's bucket."""
        rejects: List[Tuple[EngineRequest, StatusCode, str]] = []
        while budget > 0 and self._free_slots:
            with self._lock:
                if not self._waiting:
                    break
                req = self._waiting[0]
                n_tok = len(req.prompt_token_ids)
                need = math.ceil(
                    min(n_tok + req.sampling.max_new_tokens, self.cfg.max_seq_len)
                    / self.block_size
                )
                err = _unsupported(req.sampling)
                if not n_tok:
                    err = "empty prompt"
                elif n_tok >= self.cfg.max_seq_len:
                    err = "prompt exceeds max_seq_len"
                if err:
                    self._waiting.popleft()
                    rejects.append((req, StatusCode.INVALID_ARGUMENT, err))
                    continue
                if need > self.block_mgr.num_blocks - 1:
                    self._waiting.popleft()
                    rejects.append((req, StatusCode.RESOURCE_EXHAUSTED,
                                    "request needs more KV blocks than the pool holds"))
                    continue
                if not self.block_mgr.can_allocate(need):
                    break  # head-of-line: wait for blocks to free up
                self._waiting.popleft()
            seq = _Seq(req, self._free_slots.pop(), self.block_mgr.allocate(need))
            self._prefilling[req.request_id] = seq
            chunk = min(n_tok, budget)
            budget -= chunk
            if len(items_meta) < self.executor.PREFILL_GROUP_MAX and (
                not items_meta
                or self.executor.bucket_len(chunk)
                == self.executor.bucket_len(items_meta[0][2])
            ):
                items_meta.append((seq, 0, chunk))
        for req, code, msg in rejects:
            self._reject(req, code, msg)

    def _prefill_item(self, seq: _Seq, start: int, n: int) -> PrefillItem:
        s = seq.req.sampling
        final = start + n >= len(seq.tokens)
        table = np.zeros((self.max_blocks,), np.int32)
        table[: len(seq.block_ids)] = seq.block_ids
        return PrefillItem(
            token_ids=np.asarray(seq.tokens[start:start + n], np.int32),
            start_pos=start,
            block_table=table,
            temperature=s.temperature,
            top_k=s.top_k,
            top_p=s.top_p,
            seed=s.seed,
            step=len(seq.generated),
            min_p=s.min_p if final else 0.0,
        )

    # ------------------------------------------------------------ slots

    def _install(self, seq: _Seq) -> None:
        """Prefill done: the seq decodes from its slot from now on."""
        slot = seq.slot
        s = seq.req.sampling
        self._running[slot] = seq
        self._temps[slot] = s.temperature
        self._top_k[slot] = s.top_k
        self._top_p[slot] = s.top_p
        self._min_p[slot] = s.min_p
        self._seeds[slot] = s.seed
        row = self._block_tables[slot]
        row[:] = 0
        row[: len(seq.block_ids)] = seq.block_ids

    def _release(self, seq: _Seq) -> None:
        slot = seq.slot
        if self._running.get(slot) is seq:
            del self._running[slot]
            self._temps[slot] = 0.0
            self._top_k[slot] = 0
            self._top_p[slot] = 1.0
            self._min_p[slot] = 0.0
            self._seeds[slot] = 0
            self._block_tables[slot] = 0
        self._prefilling.pop(seq.req.request_id, None)
        self.block_mgr.free(seq.block_ids)
        seq.block_ids = []
        self._free_slots.append(slot)
        self._work.set()

    # ------------------------------------------------------------ outputs

    def _append(self, seq: _Seq, tok: int, lp: float) -> None:
        seq.generated.append((tok, lp))
        seq.tokens.append(tok)
        finished = self._check_stop(seq)
        s = seq.req.sampling
        out_seq = SequenceOutput(
            index=0, token_ids=[tok], finish_reason=finished or FinishReason.NONE,
        )
        if s.logprobs:
            out_seq.logprobs = [LogProb(data=LogProbData(token_id=tok, logprob=lp))]
        out = RequestOutput(
            request_id=seq.req.request_id,
            outputs=[out_seq],
            usage=Usage(len(seq.req.prompt_token_ids), len(seq.generated)),
            finished=finished is not None,
        )
        try:
            keep_going = seq.req.callback(out)
        except Exception:  # a callback error must not kill the engine loop
            logger.exception("request callback failed")
            keep_going = False
        if finished is not None:
            self._release(seq)
        elif keep_going is False:
            self._release(seq)
            self._notify_cancelled(seq.req)

    def _check_stop(self, seq: _Seq) -> Optional[FinishReason]:
        s = seq.req.sampling
        tok = seq.tokens[-1]
        if not s.ignore_eos and tok in self.eos_token_ids:
            return FinishReason.STOP
        if tok in s.stop_token_ids:
            return FinishReason.STOP
        if len(seq.generated) >= s.max_new_tokens:
            return FinishReason.LENGTH
        if len(seq.tokens) >= self.cfg.max_seq_len:
            return FinishReason.LENGTH
        return None

    @staticmethod
    def _send_final(req: EngineRequest, status: Status, cancelled: bool = False) -> None:
        try:
            req.callback(RequestOutput(
                request_id=req.request_id, status=status, finished=True,
                cancelled=cancelled,
            ))
        except Exception:
            logger.exception("request callback failed")

    def _reject(self, req: EngineRequest, code: StatusCode, msg: str) -> None:
        self._send_final(req, Status(code, msg))

    def _notify_cancelled(self, req: EngineRequest) -> None:
        self._send_final(req, Status(StatusCode.CANCELLED, "cancelled"), cancelled=True)

    def _drain_cancelled(self) -> None:
        with self._lock:
            cancelled, self._cancelled = self._cancelled, set()
            if not cancelled:
                return
            dropped = [r for r in self._waiting if r.request_id in cancelled]
            self._waiting = collections.deque(
                r for r in self._waiting if r.request_id not in cancelled
            )
        live = list(self._prefilling.values()) + list(self._running.values())
        for seq in live:
            if seq.req.request_id in cancelled:
                self._release(seq)
                dropped.append(seq.req)
        for req in dropped:
            self._notify_cancelled(req)

    def _fail_all(self, msg: str) -> None:
        """A step raised: end every admitted and waiting request with an
        error so no client waits on a step that will not come."""
        with self._lock:
            waiting, self._waiting = list(self._waiting), collections.deque()
        live = list(self._prefilling.values()) + list(self._running.values())
        for seq in live:
            self._release(seq)
        for req in [s.req for s in live] + waiting:
            self._send_final(req, Status(StatusCode.UNKNOWN, msg))
