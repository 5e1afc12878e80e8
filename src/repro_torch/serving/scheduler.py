"""Continuous-batching scheduler: FIFO admission over the Engine's slots
(port of ``repro/serving/scheduler.py``)."""
from __future__ import annotations

from collections import deque
from typing import List

from repro_torch.serving.engine import Engine, Request


class Scheduler:
    def __init__(self, engine: Engine):
        self.engine = engine
        self.queue: deque = deque()
        self.done: List[Request] = []

    def submit(self, req: Request):
        self.queue.append(req)

    def run(self, max_steps: int = 10_000) -> List[Request]:
        """Drive until queue and slots drain (or step budget)."""
        steps = 0
        while (self.queue or self.engine.active().any()) and steps < max_steps:
            while self.queue and self.engine.free_slots():
                early = self.engine.admit(self.queue.popleft())
                if early is not None:
                    self.done.append(early)
            self.done.extend(self.engine.step())
            steps += 1
        return self.done
