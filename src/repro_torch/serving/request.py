"""Request lifecycle for the real serving engine."""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

__all__ = ["RequestState", "ServeRequest"]


class RequestState(enum.Enum):
    WAITING = "waiting"
    RUNNING = "running"
    SWAPPED = "swapped"
    FINISHED = "finished"
    ABORTED = "aborted"
    SHED = "shed"          # rejected by gateway load-shedding (terminal)


@dataclass
class ServeRequest:
    request_id: str
    prompt: str
    prompt_tokens: list[int]
    max_new_tokens: int = 512
    eos_token: int = 0
    temperature: float = 0.6          # the paper's default sampling temp
    arrival: float = 0.0

    # SLO deadlines (seconds from arrival); None defers to the gateway's
    # configured defaults.  The bare engine never enforces them — deadline
    # aborts are the gateway's job, so engine-only users see no change.
    ttft_deadline_s: float | None = None
    ttlt_deadline_s: float | None = None
    tenant: str = "default"           # gateway per-tenant queue key
    session_id: str = ""              # multi-turn chain key ("" = one-shot);
                                      # turns of one session share a growing
                                      # prompt prefix the engine's prefix
                                      # index can adopt instead of re-
                                      # prefilling

    state: RequestState = RequestState.WAITING
    output_tokens: list[int] = field(default_factory=list)
    slot: int = -1                    # engine batch slot while RUNNING
    prefill_pos: int = 0              # context tokens whose KV is resident
    ttft: float = float("nan")
    ttlt: float = float("nan")
    n_preemptions: int = 0
    n_swap_restores: int = 0          # readmissions that skipped re-prefill
    finish_reason: str = ""           # why the request reached its terminal
                                      # state ("eos", "length", "truncated",
                                      # "infeasible_prompt", deadline/shed
                                      # reasons, or a caller-supplied one)

    @property
    def input_len(self) -> int:
        return len(self.prompt_tokens)

    @property
    def generated(self) -> int:
        return len(self.output_tokens)

    @property
    def context_len(self) -> int:
        return self.input_len + self.generated

    @property
    def done(self) -> bool:
        return self.state in (RequestState.FINISHED, RequestState.ABORTED,
                              RequestState.SHED)
