"""Exceptions (counterpart of ``metrics_tpu/utils/exceptions.py``, the part this port uses)."""


class MetricsTPUUserError(Exception):
    """Error raised on wrong usage of the metrics API."""

