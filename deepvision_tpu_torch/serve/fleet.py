"""Multi-model serving fleet: many engines, one process, one front door
(port of deepvision_tpu/serve/fleet.py without hot reload, promotion,
autoscaling and the circuit breaker, which arrive later).

Each served model gets its OWN `DynamicBatcher` and `ServingMetrics`
(coalescing only ever combines same-model requests), while the card is
shared by every batcher's dispatches.

Routing contract (served by serve/server.py):

    POST /predict            -> the DEFAULT model (first added)
    POST /predict/<name>     -> that model; unknown names get 404 with the
                                served-model list in the body
    GET  /stats[/<name>]     -> per-model ServingMetrics + weight provenance
    GET  /healthz            -> aggregate status, device, per-model records
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional

from .batcher import DynamicBatcher
from .engine import PredictEngine
from .metrics import ServingMetrics


class UnknownModel(KeyError):
    """Routed model name is not served; carries the served list so the
    HTTP 404 body can say what IS available."""

    def __init__(self, name: str, served: List[str]):
        super().__init__(name)
        self.name = name
        self.served = list(served)

    def __str__(self) -> str:
        return (f"unknown model {self.name!r} — served models: "
                f"{', '.join(self.served)}")


class ServedModel:
    """One model's serving unit: engine + its own batcher + its own
    metrics."""

    def __init__(self, engine: PredictEngine, batcher: DynamicBatcher,
                 metrics: ServingMetrics):
        self.engine = engine
        self.batcher = batcher
        self.metrics = metrics

    @property
    def name(self) -> str:
        return self.engine.name

    def submit(self, images, *, deadline_s: Optional[float] = None):
        """Route one request into this model's batcher. `deadline_s` feeds
        admission control (None = the batcher's configured default)."""
        return self.batcher.submit(images, deadline_s=deadline_s)

    def describe(self) -> dict:
        """The /healthz per-model record."""
        return {
            "device": self.engine.device_name,
            "buckets": list(self.engine.buckets),
            "max_batch": self.batcher.max_batch,
            "queue_depth": self.batcher.queue_depth,
            "default_deadline_s": self.batcher.default_deadline_s,
            "weights": self.engine.provenance,
        }

    def snapshot(self) -> dict:
        """The /stats per-model record."""
        return {
            **self.metrics.snapshot(queue_depth=self.batcher.queue_depth),
            "weights": self.engine.provenance,
        }


class ModelFleet:
    """Ordered name -> ServedModel map. The first model added is the
    default (`POST /predict` without a name)."""

    def __init__(self):
        self._models: Dict[str, ServedModel] = {}  # insertion-ordered

    def add(self, engine: PredictEngine, *,
            max_batch: Optional[int] = None,
            max_delay_ms: float = 5.0,
            max_queue_examples: int = 1024,
            default_deadline_s: Optional[float] = None) -> ServedModel:
        """Register an engine under its own name with a fresh batcher and
        metrics accumulator: one model being hammered sheds ITS requests
        (429) without starving the others' queues."""
        if engine.name in self._models:
            raise ValueError(f"model {engine.name!r} already served — one "
                             f"entry per registry name")
        metrics = ServingMetrics()
        batcher = DynamicBatcher(
            engine, max_batch=max_batch, max_delay_ms=max_delay_ms,
            max_queue_examples=max_queue_examples, metrics=metrics,
            default_deadline_s=default_deadline_s)
        sm = ServedModel(engine, batcher, metrics)
        self._models[engine.name] = sm
        return sm

    @property
    def default(self) -> ServedModel:
        if not self._models:
            raise RuntimeError("empty fleet: add at least one model")
        return next(iter(self._models.values()))

    def get(self, name: Optional[str] = None) -> ServedModel:
        """Resolve a routed name (None/'' = default). Raises UnknownModel
        carrying the served list — the 404 body contract."""
        if not name:
            return self.default
        try:
            return self._models[name]
        except KeyError:
            raise UnknownModel(name, self.names()) from None

    def names(self) -> List[str]:
        return list(self._models)

    def __len__(self) -> int:
        return len(self._models)

    def __iter__(self) -> Iterator[ServedModel]:
        return iter(self._models.values())

    @property
    def queue_depth(self) -> int:
        return sum(sm.batcher.queue_depth for sm in self)

    @property
    def draining(self) -> bool:
        return any(sm.batcher.draining for sm in self)

    def describe(self) -> Dict[str, dict]:
        return {sm.name: sm.describe() for sm in self}

    def snapshots(self) -> Dict[str, dict]:
        return {sm.name: sm.snapshot() for sm in self}

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Drain every batcher (reject new work, finish accepted, stop the
        dispatcher threads). True once ALL dispatchers exited."""
        ok = True
        for sm in self:
            ok = sm.batcher.drain(timeout) and ok
        return ok
