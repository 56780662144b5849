"""Exceptions (counterpart of ``metrics_tpu/utils/exceptions.py``, the part this port uses)."""

from typing import Optional, Sequence


class MetricsTPUUserError(Exception):
    """Error raised on wrong usage of the metrics API."""


class SyncError(Exception):
    """Base class for cross-process metric-state synchronization failures.

    Every failure the sync layer detects (schema desync, straggler timeout,
    state corruption) derives from this type, so the ``on_sync_error`` policy
    of :class:`~metrics_tpu_torch.Metric` has one thing to catch.  Programming
    errors (bad arguments) do not derive from it and always propagate.
    """


class SyncDesyncError(SyncError):
    """Raised by the pre-flight schema check when a peer's state registry
    diverges (different state names, shapes or dtypes).

    Attributes:
        rank: the first diverging peer rank (``None`` for a registry-size
            mismatch attributable to several ranks).
        state: the name of the first diverging state (``None`` for
            registry-size mismatches).
    """

    def __init__(self, message: str, *, rank: Optional[int] = None, state: Optional[str] = None):
        super().__init__(message)
        self.rank = rank
        self.state = state


class SyncTimeoutError(SyncError):
    """Raised when a collective does not complete within ``sync_timeout``.

    Attributes:
        state: the metric state being gathered when the watchdog fired.
        timeout: the per-attempt timeout in seconds.
        attempts: how many attempts (1 + retries) were made.
        synced_states: names of the states whose collectives had completed
            before the straggler.
    """

    def __init__(
        self,
        message: str,
        *,
        state: Optional[str] = None,
        timeout: Optional[float] = None,
        attempts: int = 1,
        synced_states: Optional[Sequence[str]] = None,
    ):
        super().__init__(message)
        self.state = state
        self.timeout = timeout
        self.attempts = attempts
        self.synced_states = list(synced_states or [])


class SyncIntegrityError(SyncError):
    """Raised by ``validate_sync=True`` when a pre- or post-sync state holds
    NaN/Inf values or drifted to another dtype through the collective.

    Attributes:
        state: the offending state's name.
        phase: ``"pre-sync"`` or ``"post-sync"``.
        problem: short description (``"non-finite values"``, ``"dtype drift
            float32 -> float64"``).
    """

    def __init__(self, message: str, *, state: str, phase: str, problem: str):
        super().__init__(message)
        self.state = state
        self.phase = phase
        self.problem = problem
