"""Trace and metrics exposition: Chrome trace-event JSON and Prometheus
text (port of deepvision_tpu/obs/export.py; no dependency beyond the
standard library).

- `chrome_trace(tracer)` / `write_chrome_trace(tracer, path)` render a
  `Tracer`'s ring as Chrome trace-event JSON, loadable in Perfetto
  (https://ui.perfetto.dev) or `chrome://tracing`. Complete ("X") events
  carry every span's args (request_id, bucket, generation, worker, ...);
  flow events ("s"/"f") draw the request→batch arrows. Serving exposes
  this as `GET /trace?secs=N`; the trainers as `--trace-out`.

- `render_prometheus(fleet)` renders a serving fleet's state as
  Prometheus text exposition (format 0.0.4) for `GET /metrics`: lifetime
  counters (`ServingMetrics.totals()`, never reset, so scrapes are
  monotone), gauges (queue depth, dispatcher workers, breaker state,
  active precision, mesh devices), fixed-bucket latency, queue-wait and
  dispatch histograms, and the reload, autoscale and promotion decision
  counters, all labeled by `model`.

`validate_prometheus_text` / `parse_prometheus_text` /
`validate_serve_exposition` are the format validator and sample parser
the tests and chip_smoke.py share.
"""

from __future__ import annotations

import json
import math
import os
import re
from typing import Dict, List, Optional, Tuple

from .trace import Tracer

PREFIX = "deepvision_serve_"

# ServingMetrics.totals() key -> (metric name, help) — every one a lifetime
# counter that survives snapshot(reset=True), so consecutive scrapes are
# monotone by construction
_TOTAL_COUNTERS = (
    ("requests", "requests_total", "Requests answered (batched dispatches)"),
    ("examples", "examples_total", "Examples dispatched to the device"),
    ("shed", "shed_total", "Requests shed by queue backpressure (HTTP 429)"),
    ("admission_rejected", "admission_rejected_total",
     "Requests refused at the door: deadline unmeetable (fast HTTP 503)"),
    ("deadline_expired", "deadline_expired_total",
     "Accepted requests whose deadline expired before a result (HTTP 504)"),
    ("breaker_rejected", "breaker_rejected_total",
     "Requests failed fast while the model's circuit was open (HTTP 503)"),
    ("dispatch_errors", "dispatch_errors_total",
     "Device dispatches that raised (the circuit breaker's evidence)"),
    ("observer_errors", "observer_errors_total",
     "Per-batch observer tap exceptions (counted, never silent)"),
)

_BREAKER_STATES = ("closed", "open", "half_open")
_PRECISIONS = ("bf16", "int8")


# -- Chrome trace-event export -------------------------------------------------

def chrome_trace(tracer: Tracer, since_s: Optional[float] = None) -> dict:
    """Render the tracer's ring as a Chrome trace-event JSON object."""
    spans = tracer.spans(since_s)
    pid = os.getpid()
    tids: Dict[str, int] = {}
    events: List[dict] = [
        {"ph": "M", "pid": pid, "tid": 0, "name": "process_name",
         "args": {"name": f"deepvision_tpu_torch[{pid}]"}},
    ]

    def tid_of(name: str) -> int:
        if name not in tids:
            tids[name] = len(tids) + 1
            events.append({"ph": "M", "pid": pid, "tid": tids[name],
                           "name": "thread_name", "args": {"name": name}})
        return tids[name]

    by_id = {s["id"]: s for s in spans}
    for s in spans:
        ts_us = (s["ts"] - tracer.t0_ns) / 1000.0
        events.append({
            "name": s["name"], "cat": s["cat"], "ph": "X",
            "ts": ts_us, "dur": s["dur"] / 1000.0,
            "pid": pid, "tid": tid_of(s["tid"]),
            "args": {**s["args"], "span_id": s["id"]},
        })
        # request -> batch flow arrow: from the end of a request's
        # queue_wait span to the start of the batch span that served it
        batch = s["args"].get("batch")
        if s["name"] == "queue_wait" and batch in by_id:
            b = by_id[batch]
            events.append({"ph": "s", "id": s["id"], "cat": "flow",
                           "name": "request->batch", "pid": pid,
                           "tid": tid_of(s["tid"]),
                           "ts": ts_us + s["dur"] / 1000.0})
            events.append({"ph": "f", "bp": "e", "id": s["id"],
                           "cat": "flow", "name": "request->batch",
                           "pid": pid, "tid": tid_of(b["tid"]),
                           "ts": (b["ts"] - tracer.t0_ns) / 1000.0})
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            # wall-clock anchor of monotonic ts=0, for lining the trace up
            # with serve.jsonl / train.jsonl timestamps
            "t0_unix": tracer.t0_unix,
            "spans_recorded": tracer.recorded,
            "spans_exported": len(spans),
        },
    }


def write_chrome_trace(tracer: Tracer, path: str,
                       since_s: Optional[float] = None) -> int:
    """Write the Chrome trace JSON to `path`; returns the span count."""
    trace = chrome_trace(tracer, since_s)
    with open(path, "w") as fp:
        json.dump(trace, fp)
    return trace["otherData"]["spans_exported"]


# -- Prometheus text exposition ------------------------------------------------

def _escape(v) -> str:
    return str(v).replace("\\", r"\\").replace('"', r'\"').replace("\n",
                                                                   r"\n")


def _fmt(v) -> str:
    f = float(v)
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _labels(d: Dict[str, str]) -> str:
    if not d:
        return ""
    return "{" + ",".join(f'{k}="{_escape(v)}"' for k, v in d.items()) + "}"


def _emit(lines: List[str], name: str, mtype: str, help_text: str,
          samples) -> None:
    """One metric family: HELP + TYPE, then every sample grouped under it
    (the exposition format requires a family's samples to be contiguous).
    `samples` yields (suffix, labels_dict, value)."""
    lines.append(f"# HELP {name} {help_text}")
    lines.append(f"# TYPE {name} {mtype}")
    for suffix, labels, value in samples:
        lines.append(f"{name}{suffix}{_labels(labels)} {_fmt(value)}")


def render_prometheus(fleet) -> str:
    """Prometheus text exposition (0.0.4) of a ModelFleet's serving state,
    one `model` label per served model. Counters come from never-reset
    lifetime stores (`ServingMetrics.totals()`, reload/autoscale decision
    stats, promotion history), so consecutive scrapes are monotone."""
    models = list(fleet)
    lines: List[str] = []
    totals = {sm.name: sm.metrics.totals() for sm in models}
    for key, name, help_text in _TOTAL_COUNTERS:
        _emit(lines, PREFIX + name, "counter", help_text,
              [("", {"model": sm.name}, totals[sm.name].get(key, 0))
               for sm in models])

    _emit(lines, PREFIX + "queue_depth", "gauge",
          "Examples accepted whose results are not yet delivered",
          [("", {"model": sm.name}, sm.batcher.queue_depth)
           for sm in models])
    _emit(lines, PREFIX + "workers", "gauge",
          "Dispatcher workers in the model's pool (the autoscaler's lever)",
          [("", {"model": sm.name}, sm.batcher.workers) for sm in models])

    breaker_samples = []
    for sm in models:
        state = (sm.breaker.describe()["state"] if sm.breaker is not None
                 else None)
        for s in _BREAKER_STATES:
            breaker_samples.append(
                ("", {"model": sm.name, "state": s},
                 1 if state == s else 0))
    _emit(lines, PREFIX + "breaker_state", "gauge",
          "Circuit breaker state, one-hot over {closed, open, half_open}",
          breaker_samples)

    reload_samples = []
    autoscale_samples = []
    for sm in models:
        with sm.reload_lock:
            reload_stats = dict(sm.reload_stats)
            autoscale_stats = dict(sm.autoscale_stats)
        reload_samples += [("", {"model": sm.name, "outcome": k}, v)
                           for k, v in sorted(reload_stats.items())]
        autoscale_samples += [
            ("", {"model": sm.name, "decision": d},
             autoscale_stats.get(f"{d}s", 0))
            for d in ("scale_up", "scale_down")]
    _emit(lines, PREFIX + "reload_outcomes_total", "counter",
          "Hot weight reload outcomes (swaps, refusals, rollbacks)",
          reload_samples)
    _emit(lines, PREFIX + "autoscale_decisions_total", "counter",
          "Autoscale decisions taken by the shed-driven control loop",
          autoscale_samples)

    promo_samples = []
    for sm in models:
        if sm.promoter is None:
            continue
        counts: Dict[str, int] = {}
        for rec in list(sm.promoter.history):
            d = str(rec.get("decision", "unknown"))
            counts[d] = counts.get(d, 0) + 1
        promo_samples += [("", {"model": sm.name, "decision": d}, n)
                          for d, n in sorted(counts.items())]
    if promo_samples:
        _emit(lines, PREFIX + "promotion_decisions_total", "counter",
              "Accuracy-gated promotion decisions (shadow/canary verdicts)",
              promo_samples)

    # the precision ladder's active rung, one-hot: the rung dispatches that
    # ask for none run at (the int8 gate's outcome as a scrapeable fact);
    # the full-precision rung is named "bf16" as in the JAX package,
    # whatever the config's compute dtype
    precision_samples = []
    for sm in models:
        active = sm.engine.precision
        for p in _PRECISIONS:
            precision_samples.append(
                ("", {"model": sm.name, "precision": p},
                 1 if active == p else 0))
    _emit(lines, PREFIX + "active_precision", "gauge",
          "Active serving precision, one-hot over {bf16, int8}",
          precision_samples)

    # devices each engine's dispatches span: 1 (no mesh serving yet),
    # emitted so a scrape has the family the mesh-serving slice fills in
    _emit(lines, PREFIX + "mesh_devices", "gauge",
          "Devices the engine's dispatches span (1 = single card)",
          [("", {"model": sm.name}, 1) for sm in models])
    # the weight bytes resident on the card per precision (int8 once armed)
    byte_samples = [("", {"model": sm.name, "precision": precision}, nbytes)
                    for sm in models
                    for precision, nbytes in sorted(
                        sm.engine.weight_bytes_per_chip().items())
                    if nbytes is not None]
    _emit(lines, PREFIX + "weight_bytes_per_chip", "gauge",
          "Resident weight bytes on the busiest device, per compiled "
          "precision", byte_samples)

    for hist_name, help_text in (
            ("request_latency_seconds",
             "Request latency, submit to result (fixed buckets, lifetime)"),
            ("queue_wait_seconds",
             "Time from submit acceptance to dispatch start"),
            ("dispatch_seconds",
             "Device dispatch wall time per batch")):
        samples = []
        for sm in models:
            by_precision = sm.metrics.histograms_by_precision().get(
                hist_name, {})
            for precision in sorted(by_precision):
                h = by_precision[precision]
                labels = {"model": sm.name, "precision": precision}
                samples += [("_bucket", {**labels, "le": _fmt(le)}, n)
                            for le, n in h["buckets"]]
                samples.append(("_sum", dict(labels), h["sum"]))
                samples.append(("_count", dict(labels), h["count"]))
        _emit(lines, PREFIX + hist_name, "histogram", help_text, samples)
    return "\n".join(lines) + "\n"


# -- multi-replica exposition merge ------------------------------------------

def merge_expositions(texts: Dict[str, str]) -> str:
    """Merge N replica expositions (`{replica_id: exposition_text}`) into
    ONE valid exposition (what a router in front of several replicas
    serves as its `GET /metrics`). The merge contract:

    - counters and gauges keep one series PER REPLICA, distinguished by an
      added `replica` label — a counter stays monotone because each
      replica's series is its own lifetime store (summing across replicas
      would go BACKWARDS every time a crashed replica restarts at zero);
    - histogram families are SUMMED across replicas per label set (bucket
      counts, `_sum`, `_count`) — the fixed shared bucket edges
      (serve/metrics.LATENCY_BUCKETS_S) exist exactly so replica
      histograms aggregate; the sums stay cumulative and `+Inf == _count`
      by construction. A restart resets the sum, which is the standard
      Prometheus counter-reset semantics scrapers already handle;
    - each family's HELP/TYPE is emitted once, with every sample
      contiguous under it (the format requirement
      `validate_prometheus_text` enforces), in first-seen order.
    """
    order: List[str] = []            # family emission order (first seen)
    meta: Dict[str, Tuple[str, str]] = {}          # family -> (type, help)
    # family -> rows: histogram families aggregate into {key: value} with
    # a parallel first-seen key order; everything else appends per-replica
    hist_vals: Dict[str, Dict[tuple, float]] = {}
    hist_order: Dict[str, List[tuple]] = {}
    rows: Dict[str, List[Tuple[str, Dict[str, str], float]]] = {}

    for replica, text in texts.items():
        types: Dict[str, str] = {}
        helps: Dict[str, str] = {}
        for line in text.splitlines():
            line = line.strip()
            if not line:
                continue
            if line.startswith("# HELP "):
                parts = line[len("# HELP "):].split(" ", 1)
                if parts:
                    helps[parts[0]] = parts[1] if len(parts) > 1 else ""
                continue
            if line.startswith("# TYPE "):
                parts = line[len("# TYPE "):].split()
                if len(parts) == 2:
                    types[parts[0]] = parts[1]
                continue
            if line.startswith("#"):
                continue
            m = _SAMPLE_RE.match(line)
            if m is None:
                continue
            name = m.group("name")
            fam = _family(name, types)
            if fam not in meta:
                if fam not in types:
                    continue   # sample with no TYPE: drop, never corrupt
                meta[fam] = (types[fam], helps.get(fam, ""))
                order.append(fam)
            labels = _parse_labels(m.group("labels"), [], line)
            try:
                value = _parse_value(m.group("value"))
            except ValueError:
                continue
            if meta[fam][0] in ("histogram", "summary"):
                key = (name, tuple(sorted(labels.items())))
                vals = hist_vals.setdefault(fam, {})
                if key not in vals:
                    vals[key] = 0.0
                    # first-seen order preserves ascending le within a
                    # series (every replica renders the same fixed edges)
                    hist_order.setdefault(fam, []).append((key, labels,
                                                           name))
                vals[key] += value
            else:
                rows.setdefault(fam, []).append(
                    (name, {**labels, "replica": replica}, value))

    lines: List[str] = []
    for fam in order:
        mtype, help_text = meta[fam]
        lines.append(f"# HELP {fam} {help_text}")
        lines.append(f"# TYPE {fam} {mtype}")
        if mtype in ("histogram", "summary"):
            vals = hist_vals.get(fam, {})
            for key, labels, name in hist_order.get(fam, []):
                lines.append(f"{name}{_labels(labels)}"
                             f" {_fmt(vals[key])}")
        else:
            for name, labels, value in rows.get(fam, []):
                lines.append(f"{name}{_labels(labels)} {_fmt(value)}")
    return "\n".join(lines) + ("\n" if lines else "")


# -- minimal format validation (shared by the tests and chip_smoke.py) --------

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?"
    r"\s+(?P<value>\S+)(?:\s+(?P<ts>-?\d+))?$")
_LABEL_RE = re.compile(
    r'^(?P<k>[a-zA-Z_][a-zA-Z0-9_]*)="(?P<v>(?:[^"\\]|\\.)*)"$')
_TYPES = ("counter", "gauge", "histogram", "summary", "untyped")


def _parse_labels(raw: Optional[str], errors: List[str],
                  where: str) -> Dict[str, str]:
    labels: Dict[str, str] = {}
    if not raw:
        return labels
    for part in raw.split(","):
        m = _LABEL_RE.match(part.strip())
        if m is None:
            errors.append(f"{where}: bad label pair {part!r}")
            continue
        labels[m.group("k")] = (m.group("v")
                                .replace(r"\"", '"')
                                .replace(r"\n", "\n")
                                .replace("\\\\", "\\"))
    return labels


def _family(name: str, types: Dict[str, str]) -> str:
    """Sample name -> declared family: histogram samples land under their
    base name's TYPE declaration."""
    for suffix in ("_bucket", "_sum", "_count"):
        base = name[:-len(suffix)] if name.endswith(suffix) else None
        if base and types.get(base) in ("histogram", "summary"):
            return base
    return name


def _parse_value(raw: str) -> float:
    if raw == "+Inf":
        return math.inf
    if raw == "-Inf":
        return -math.inf
    return float(raw)  # raises for garbage; "NaN" parses


def parse_prometheus_text(text: str) -> Dict[Tuple[str, tuple], float]:
    """{(sample_name, sorted labels tuple): value} over every sample line —
    what the monotone-across-scrapes checks diff."""
    out: Dict[Tuple[str, tuple], float] = {}
    errors: List[str] = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            continue
        labels = _parse_labels(m.group("labels"), errors, line)
        try:
            out[(m.group("name"), tuple(sorted(labels.items())))] = \
                _parse_value(m.group("value"))
        except ValueError:
            continue
    return out


def validate_prometheus_text(text: str) -> List[str]:
    """Minimal Prometheus text-format (0.0.4) validation; returns a list of
    problems (empty = valid). Checks: metric-name/label charset, every
    sample preceded by its family's TYPE (with a HELP), declared types
    legal, histogram buckets cumulative with an le="+Inf" bucket equal to
    `_count`."""
    errors: List[str] = []
    types: Dict[str, str] = {}
    helps: Dict[str, str] = {}
    # (family, non-le labels) -> [(le_value, count)], plus _count samples
    hist_buckets: Dict[tuple, List[Tuple[float, float]]] = {}
    hist_counts: Dict[tuple, float] = {}

    for i, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# HELP "):
            parts = line[len("# HELP "):].split(" ", 1)
            if not parts or not _NAME_RE.match(parts[0]):
                errors.append(f"line {i}: bad HELP metric name")
            else:
                helps[parts[0]] = parts[1] if len(parts) > 1 else ""
            continue
        if line.startswith("# TYPE "):
            parts = line[len("# TYPE "):].split()
            if len(parts) != 2 or not _NAME_RE.match(parts[0]):
                errors.append(f"line {i}: malformed TYPE line {line!r}")
                continue
            name, mtype = parts
            if mtype not in _TYPES:
                errors.append(f"line {i}: unknown type {mtype!r}")
            if name in types:
                errors.append(f"line {i}: duplicate TYPE for {name}")
            types[name] = mtype
            continue
        if line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line.strip())
        if m is None:
            errors.append(f"line {i}: unparseable sample {line!r}")
            continue
        name = m.group("name")
        if not _NAME_RE.match(name):
            errors.append(f"line {i}: bad metric name {name!r}")
            continue
        labels = _parse_labels(m.group("labels"), errors, f"line {i}")
        try:
            value = _parse_value(m.group("value"))
        except ValueError:
            errors.append(f"line {i}: bad sample value {m.group('value')!r}")
            continue
        fam = _family(name, types)
        if fam not in types:
            errors.append(f"line {i}: sample {name} has no preceding TYPE")
        elif fam not in helps:
            errors.append(f"line {i}: family {fam} has no HELP line")
        if name.endswith("_bucket") and types.get(fam) == "histogram":
            if "le" not in labels:
                errors.append(f"line {i}: histogram bucket without le label")
                continue
            key = (fam, tuple(sorted((k, v) for k, v in labels.items()
                                     if k != "le")))
            try:
                hist_buckets.setdefault(key, []).append(
                    (_parse_value(labels["le"]), value))
            except ValueError:
                errors.append(f"line {i}: bad le value {labels['le']!r}")
        elif name.endswith("_count") and types.get(fam) == "histogram":
            hist_counts[(fam, tuple(sorted(labels.items())))] = value

    for (fam, labels), buckets in hist_buckets.items():
        les = [le for le, _ in buckets]
        counts = [n for _, n in buckets]
        if les != sorted(les):
            errors.append(f"{fam}{dict(labels)}: bucket le values not "
                          f"ascending")
        if any(b > a for b, a in zip(counts, counts[1:])):
            errors.append(f"{fam}{dict(labels)}: bucket counts not "
                          f"cumulative")
        if not les or not math.isinf(les[-1]):
            errors.append(f"{fam}{dict(labels)}: missing le=\"+Inf\" bucket")
        else:
            total = hist_counts.get((fam, labels))
            if total is not None and counts[-1] != total:
                errors.append(f"{fam}{dict(labels)}: +Inf bucket "
                              f"{counts[-1]} != _count {total}")
    return errors


# the serve-exposition labeling contract layered ON TOP of the format
# rules: every dispatch/latency histogram series must carry BOTH the model
# and the precision label (the int8 serving axis — a scrape that loses the
# precision split would average a precision flip away), and the
# active-precision one-hot gauge must be present for every served model.
_PRECISION_LABELED = ("deepvision_serve_request_latency_seconds",
                      "deepvision_serve_queue_wait_seconds",
                      "deepvision_serve_dispatch_seconds")

# gauges with required labels beyond `model` (the mesh-serving slice adds
# its axis and per-chip byte gauges here)
_MESH_LABELED = {"deepvision_serve_mesh_devices": ("model",),
                 "deepvision_serve_weight_bytes_per_chip": ("model",
                                                            "precision")}


def validate_serve_exposition(text: str) -> List[str]:
    """Format validation (`validate_prometheus_text`) PLUS the serving
    fleet's own labeling contract: model+precision labels on every
    dispatch/latency histogram sample, precision values from the ladder,
    the `active_precision` gauge family present, and `mesh_devices`
    carrying its model label. What the tests and chip_smoke.py hold
    `GET /metrics` to."""
    errors = validate_prometheus_text(text)
    saw_active = False
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            continue
        name = m.group("name")
        if name.startswith("deepvision_serve_active_precision"):
            saw_active = True
        if name in _MESH_LABELED:
            labels = _parse_labels(m.group("labels"), errors, line)
            for required in _MESH_LABELED[name]:
                if required not in labels:
                    errors.append(f"{name}: mesh gauge sample missing the "
                                  f"{required!r} label")
            if ("precision" in _MESH_LABELED[name]
                    and labels.get("precision") not in (None, *_PRECISIONS)):
                errors.append(f"{name}: unknown precision label "
                              f"{labels.get('precision')!r}")
            continue
        base = name
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix):
                base = name[:-len(suffix)]
                break
        if base not in _PRECISION_LABELED:
            continue
        labels = _parse_labels(m.group("labels"), errors, line)
        for required in ("model", "precision"):
            if required not in labels:
                errors.append(f"{name}: histogram sample missing the "
                              f"{required!r} label")
        if labels.get("precision") not in (None, *_PRECISIONS):
            errors.append(f"{name}: unknown precision label "
                          f"{labels.get('precision')!r}")
    if "deepvision_serve_requests_total" in text and not saw_active:
        errors.append("serve exposition lacks the "
                      "deepvision_serve_active_precision gauge")
    return errors
