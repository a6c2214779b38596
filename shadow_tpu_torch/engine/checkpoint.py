"""The graceful stop of a run at a window boundary.

The JAX package's ``engine/checkpoint.py`` holds the crash-safe
checkpoint container and its resume law; the port has its first piece
only: :class:`GracefulShutdown`, what the facade raises at the first
window boundary after a SIGINT or SIGTERM, and its exit code.  The
checkpoint writes and the resume (``experimental.resume_from``,
``checkpoint_every_windows``, ``checkpoint_dir``, the ``checkpoint`` and
``resume`` console verbs) are ROADMAP item 11; the config refuses their
keys until then.
"""

from __future__ import annotations


class GracefulShutdown(BaseException):
    """SIGINT/SIGTERM landed: the run stopped at a window boundary,
    flushed its artifacts, and is unwinding for a clean exit.

    Derives from ``BaseException`` (like ``KeyboardInterrupt``) so
    engine-level ``except Exception`` paths never swallow an operator's
    stop request.
    """

    #: distinct exit code (EX_TEMPFAIL: the run can be resumed)
    EXIT_CODE = 75

    def __init__(self, signum: int) -> None:
        self.signum = signum
        super().__init__(f"graceful shutdown on signal {signum}")
