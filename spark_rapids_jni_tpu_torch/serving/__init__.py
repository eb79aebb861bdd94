"""Multi-tenant serving driver, PAPER.md's L5 layer (the port's copy of
the JAX package's ``serving/``, over the port's CUDA-graph runtime).

Everything below this package is a library called by one caller at a
time; this package is the front door: a long-lived, in-process driver
multiplexing MANY concurrent ``resource.task`` scopes over ONE
device.

- ``Session`` (session.py): one tenant's handle — per-session knobs
  (scan strategy/batching, capacity feedback), budget, and plan-cache
  accounting, isolated in a ``contextvars.Context`` so two tenants
  interleaved on the shared dispatch thread never observe each
  other's state.
- ``AdmissionController`` (admission.py): prices every arriving job
  from the capacity-feedback observations and admits / queues
  (bounded, deadline-aware) / rejects UP FRONT — overload surfaces at
  the door as ``AdmissionRejected``, not mid-flight as RetryOOMError.
- ``Server`` (server.py): the fair interleaver — one dispatch thread
  round-robins ``Pipeline.stream``-style windows across active
  sessions (dispatch sync-free per the sprtcheck dispatch-path
  contract: a slice copies the chunk into a cached graph's buffers and
  replays it; retirement fans results out to per-session waiters),
  with backpressure on ``/metrics`` and a ``/sessions`` live view.

docs/SERVING.md describes the session model, admission policy,
fairness semantics, and the overload runbook; they hold for the port
unchanged.
"""

from .admission import AdmissionController, AdmissionRejected
from .server import Job, Server, ServerClosedError
from .session import Session

__all__ = [
    "AdmissionController",
    "AdmissionRejected",
    "Job",
    "Server",
    "ServerClosedError",
    "Session",
]
