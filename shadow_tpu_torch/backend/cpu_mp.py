"""Worker processes for the multiprocess hybrid engine.

The JAX package's ``backend/cpu_mp.py``, trimmed to the two pieces
``backend.hybrid.MpHybridEngine`` uses: the round-robin partition of the
hosts over the workers and the spawning of the workers.  Each worker
rebuilds a complete, deterministic world replica from the config (same
seeds, addresses and routing, so every replica is identical) and
executes only its own partition.

Workers are started with the ``spawn`` method: the parent holds a CUDA
context and PyTorch's threads by then, and forking such a process is a
documented deadlock.  A spawned child imports the parent's ``__main__``
module again, so a script that runs this engine must do no device work
at module level.  The children never touch the card:
``CUDA_VISIBLE_DEVICES`` is empty in their environment, so even an
accidental CUDA call in one finds no device instead of creating a context
(hundreds of MB of device memory each).
"""

from __future__ import annotations

import multiprocessing as mp
import os


def _partition(n_hosts: int, workers: int) -> list[list[int]]:
    """Round-robin by host index (the reference's per-thread queue
    fill)."""
    return [list(range(w, n_hosts, workers)) for w in range(workers)]


def _worker_entry(target, conn) -> None:
    """A worker's first step: take its arguments from its pipe, then run
    ``target(*args, conn)``.  A large argument (a config of a thousand
    hosts pickles to ~150 KB) passed to ``Process`` is written to the
    child before the child has read anything past the first 64 KB, and
    the child reads on only after it has imported the parent's
    ``__main__`` — so each start would wait for one child's imports in
    turn; through the pipe, the children import side by side."""
    try:
        args = conn.recv()
    except EOFError:  # the parent gave up before sending
        return
    target(*args, conn)


def spawn_cpu_workers(target, arg_tuples):
    """Spawn one daemon worker per argument tuple (``target(*args,
    conn)``), each with its own pipe, by the ``spawn`` start method, with
    ``CUDA_VISIBLE_DEVICES`` set empty around the spawns; the arguments
    go through the pipes once every worker has started.  Returns
    ``(conns, procs)``: the parent's ends of the pipes and the
    processes."""
    ctx = mp.get_context("spawn")
    conns, procs = [], []
    saved = os.environ.get("CUDA_VISIBLE_DEVICES")
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    try:
        for _ in arg_tuples:
            parent_conn, child_conn = ctx.Pipe()
            p = ctx.Process(target=_worker_entry, args=(target, child_conn),
                            daemon=True)
            p.start()
            child_conn.close()
            conns.append(parent_conn)
            procs.append(p)
    finally:
        if saved is None:
            os.environ.pop("CUDA_VISIBLE_DEVICES", None)
        else:
            os.environ["CUDA_VISIBLE_DEVICES"] = saved
    for conn, args in zip(conns, arg_tuples):
        conn.send(args)
    return conns, procs
