"""Observability of the port (own copy of deepvision_tpu/obs/, which is
framework-free): span tracing and its exports.

- `obs.trace`: a thread-safe, ring-buffered, sampled span recorder with
  request-id context propagation. One branch when disabled.
- `obs.export`: Chrome trace-event JSON (Perfetto, `chrome://tracing`)
  and the Prometheus text exposition behind `GET /metrics`, with the
  format validators the tests share.
"""

from .trace import Tracer, TraceContext, new_request_id  # noqa: F401
