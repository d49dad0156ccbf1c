"""Request / task model for the serving scheduler.

A request goes through a prompt-processing task (PT) and a generation task
(GT). Timestamps follow the paper's JCT decomposition (§2.2): waiting,
scheduling, execution, preemption (+ GT queuing, which EconoServe excludes
from "execution").
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Optional


class State(enum.Enum):
    QUEUED_PT = "queued_pt"          # prompt waiting
    RUNNING_PT = "running_pt"        # prompt (chunk) executing
    QUEUED_GT = "queued_gt"          # generation waiting (holds prompt KVC)
    RUNNING_GT = "running_gt"
    PREEMPTED = "preempted"          # paused; may or may not hold KVC
    COMPLETED = "completed"
    ABORTED = "aborted"              # cancelled (deadline, crash, user)


@dataclass(eq=False)          # identity equality: queue membership tests and
class Request:                # removals must not deep-compare every field
    rid: int
    prompt_len: int
    true_rl: int                     # ground-truth response length
    arrival: float
    slo_deadline: float = float("inf")

    # --- prediction / allocation ---------------------------------------
    predicted_rl: int = 0            # raw predictor output (bucketed)
    padded_rl: int = 0               # predicted + sweet-spot padding
    alloc_rl: int = 0                # tokens of RL-space currently allocated

    # --- dynamic state ---------------------------------------------------
    state: State = State.QUEUED_PT
    generated: int = 0               # response tokens produced so far
    prompt_done: int = 0             # prompt tokens processed (chunking)
    occupied_kvc: int = 0            # tokens of KVC currently held
    hosted: bool = False             # running inside lent KVC (KVCPipe)

    # --- accounting -------------------------------------------------------
    t_start_exec: Optional[float] = None
    t_first_token: Optional[float] = None
    t_complete: Optional[float] = None
    waiting_time: float = 0.0
    gt_queue_time: float = 0.0
    exec_time: float = 0.0
    preempt_time: float = 0.0
    sched_time: float = 0.0
    swap_time: float = 0.0
    n_preemptions: int = 0
    n_alloc_failures: int = 0
    _last_event_t: float = 0.0

    def __post_init__(self):
        self._last_event_t = self.arrival

    # ------------------------------------------------------------------ #
    @property
    def remaining_rl(self) -> int:
        return max(0, self.true_rl - self.generated)

    @property
    def remaining_predicted(self) -> int:
        return max(0, self.padded_rl - self.generated)

    @property
    def done(self) -> bool:
        return self.generated >= self.true_rl

    @property
    def jct(self) -> float:
        assert self.t_complete is not None
        return self.t_complete - self.arrival

    @property
    def met_slo(self) -> bool:
        return self.t_complete is not None and self.t_complete <= self.slo_deadline

    def charge(self, t: float) -> None:
        """Attribute the elapsed interval to the current state's bucket."""
        dt = max(0.0, t - self._last_event_t)
        if self.state == State.QUEUED_PT:
            self.waiting_time += dt
        elif self.state == State.QUEUED_GT:
            self.gt_queue_time += dt
        elif self.state in (State.RUNNING_PT, State.RUNNING_GT):
            self.exec_time += dt
        elif self.state == State.PREEMPTED:
            self.preempt_time += dt
        self._last_event_t = t

    def set_state(self, state: State, t: float) -> None:
        self.charge(t)
        self.state = state
