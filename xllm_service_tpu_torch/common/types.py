"""Request-output types of the serving path (copies of the matching
dataclasses in xllm_service_tpu/common/types.py)."""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List, Optional


class StatusCode(enum.IntEnum):
    OK = 0
    CANCELLED = 1
    UNKNOWN = 2
    INVALID_ARGUMENT = 3
    DEADLINE_EXCEEDED = 4
    RESOURCE_EXHAUSTED = 8
    UNAVAILABLE = 14


@dataclass
class Status:
    code: StatusCode = StatusCode.OK
    message: str = ""

    def ok(self) -> bool:
        return self.code == StatusCode.OK


class FinishReason(enum.Enum):
    NONE = None
    STOP = "stop"
    LENGTH = "length"

    def to_string(self) -> Optional[str]:
        return self.value


@dataclass
class Usage:
    num_prompt_tokens: int = 0
    num_generated_tokens: int = 0


@dataclass
class LogProbData:
    token: str = ""
    token_id: int = 0
    logprob: float = 0.0


@dataclass
class LogProb:
    data: LogProbData = field(default_factory=LogProbData)
    top_logprobs: List[LogProbData] = field(default_factory=list)


@dataclass
class SequenceOutput:
    index: int = 0
    text: str = ""
    token_ids: List[int] = field(default_factory=list)
    finish_reason: FinishReason = FinishReason.NONE
    logprobs: List[LogProb] = field(default_factory=list)


@dataclass
class RequestOutput:
    request_id: str = ""
    status: Status = field(default_factory=Status)
    outputs: List[SequenceOutput] = field(default_factory=list)
    usage: Optional[Usage] = None
    finished: bool = False
    cancelled: bool = False

