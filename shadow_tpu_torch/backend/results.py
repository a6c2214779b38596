"""What a run returns: the event log and the counters.

The same records and result shape as the JAX package's CPU engine
(``backend/cpu_engine.py`` ``LogRecord``/``SimResult``), so results of the
two packages compare directly.
"""

from __future__ import annotations

import dataclasses

# event outcomes (the log's last column)
DELIVERED, DROP_LOSS, DROP_CODEL, DROP_QUEUE = 0, 1, 2, 3


@dataclasses.dataclass
class LogRecord:
    time: int
    src: int
    dst: int
    seq: int
    size: int
    outcome: int

    def as_tuple(self) -> tuple[int, int, int, int, int, int]:
        return (self.time, self.src, self.dst, self.seq, self.size, self.outcome)


@dataclasses.dataclass
class SimResult:
    sim_time_ns: int
    wall_seconds: float
    rounds: int
    event_log: list[LogRecord]
    counters: dict[str, int]

    def log_tuples(self) -> list[tuple[int, int, int, int, int, int]]:
        """Canonical ordered event log for determinism diffs."""
        return sorted(r.as_tuple() for r in self.event_log)

    @property
    def sim_seconds_per_wall_second(self) -> float:
        return (self.sim_time_ns / 1e9) / max(self.wall_seconds, 1e-9)
