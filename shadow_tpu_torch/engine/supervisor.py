"""Deadline-bounded pipe reads for the multiprocess hybrid engine.

The JAX package's ``engine/supervisor.py``, trimmed to what
``backend.hybrid.MpHybridEngine`` uses: a parent-side read that polls in
short slices and checks the worker's liveness between them, so that a
worker that dies or hangs surfaces as a diagnostic
:class:`WorkerDiedError` instead of a read that blocks forever, and a
child-side read that exits when the parent is gone.  The hybrid workers
own live managed OS processes, which a respawned worker could not take
over, so there is no respawn and no round replay here (nor the JAX
package's fault-injection knobs).
"""

from __future__ import annotations

import os
from typing import Optional

_POLL_SLICE_S = 0.05  # parent-side liveness poll granularity


class WorkerDiedError(RuntimeError):
    """A multiprocess worker died or missed its reply deadline: which
    worker, which round, what the parent was waiting for, and whether
    the process is dead or merely unresponsive."""

    def __init__(
        self,
        worker_id: int,
        round_no: int,
        last_msg_kind: str,
        reason: str,
        exitcode: Optional[int] = None,
    ) -> None:
        self.worker_id = worker_id
        self.round_no = round_no
        self.last_msg_kind = last_msg_kind
        self.reason = reason
        self.exitcode = exitcode
        detail = f" (exitcode {exitcode})" if exitcode is not None else ""
        super().__init__(
            f"worker {worker_id} {reason}{detail} during round {round_no}"
            f" (awaiting reply to {last_msg_kind!r})"
        )


def recv_with_deadline(
    conn,
    proc,
    timeout_s: float,
    worker_id: int,
    round_no: int,
    last_msg_kind: str,
):
    """Receive one message with liveness checks and a deadline.

    Polls in :data:`_POLL_SLICE_S` slices; between slices the worker
    process's liveness is checked, so a crash surfaces within one slice,
    not after the whole deadline.  ``proc`` may be None (the deadline
    alone)."""
    waited = 0.0
    while True:
        try:
            if conn.poll(_POLL_SLICE_S):
                return conn.recv()
        except (EOFError, OSError) as e:
            raise WorkerDiedError(
                worker_id, round_no, last_msg_kind,
                "closed its pipe",
                proc.exitcode if proc is not None else None,
            ) from e
        if proc is not None and not proc.is_alive():
            # drain a reply that raced the death
            try:
                if conn.poll(0):
                    return conn.recv()
            except (EOFError, OSError):
                pass
            raise WorkerDiedError(
                worker_id, round_no, last_msg_kind, "died", proc.exitcode
            )
        waited += _POLL_SLICE_S
        if waited >= timeout_s:
            raise WorkerDiedError(
                worker_id, round_no, last_msg_kind,
                f"missed its {timeout_s:.1f}s reply deadline (hung)",
            )


def worker_recv(conn):
    """Child-side receive: poll in 1 s slices for as long as it takes (a
    worker idles between rounds), but raise EOFError once the parent is
    gone (the worker is reparented), so a crashed parent strands no
    worker."""
    ppid = os.getppid()
    while True:
        if conn.poll(1.0):
            return conn.recv()
        if os.getppid() != ppid:
            raise EOFError("parent process exited")
