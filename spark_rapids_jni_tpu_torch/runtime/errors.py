"""Error types of the ANSI-mode and bounded-width operators (the port's
copy of the JAX package's ``runtime/errors.py``).

``CastException`` carries the offending string and row number, as the
reference's CastException does across the JNI boundary
(CastException.java, CastStringJni.cpp CATCH_CAST_EXCEPTION), so a
caller can report exactly which input row failed a strict-mode cast;
``JsonParsingException`` carries the row and text of the first
malformed from_json document.
"""

from __future__ import annotations


class JsonParsingException(RuntimeError):
    """Malformed JSON input to from_json, carrying the offending row and
    its text (the reference's error-context dump, map_utils.cu
    throw_if_error:109-139, prints +-100 chars around the first error
    token)."""

    def __init__(self, row_with_error: int, context: str):
        super().__init__(
            f"JSON generates parsing errors at row {row_with_error}: {context!r}"
        )
        self.row_with_error = row_with_error
        self.context = context


class CastException(RuntimeError):
    def __init__(self, string_with_error: str, row_with_error: int):
        super().__init__(
            f"Error casting data on row {row_with_error}: {string_with_error!r}"
        )
        self.string_with_error = string_with_error
        self.row_with_error = row_with_error


class CapacityExceededError(ValueError):
    """A bounded contract (a pinned string width, a group or join
    capacity) would drop or truncate rows.

    - ``stage``: which bounded contract tripped (e.g. "string_width").
    - ``needed`` / ``granted``: the exact requirement when known;
      ``needed`` is None when only an overflow count is known.
    - ``breakdown``: per-stage overflow counts, when known.
    """

    def __init__(
        self,
        message: str,
        stage: "str | None" = None,
        needed: "int | None" = None,
        granted: "int | None" = None,
        breakdown: "dict | None" = None,
    ):
        super().__init__(message)
        self.stage = stage
        self.needed = needed
        self.granted = granted
        self.breakdown = breakdown


class RetryOOMError(MemoryError):
    """Adaptive capacity retry exhausted: the task's retry bound or
    byte budget ran out before a plan fit (the terminal form of the
    reference's RetryOOM/SplitAndRetryOOM chain, RmmSpark.java).

    Carries the task's metrics (``.metrics``, a
    ``resource.TaskMetrics``) so the failure is diagnosable: per-op
    attempts, the stage that kept overflowing, and the final capacity
    plan that still did not fit."""

    def __init__(self, message: str, metrics=None):
        super().__init__(message)
        self.metrics = metrics
