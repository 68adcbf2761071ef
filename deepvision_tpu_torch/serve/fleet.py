"""Multi-model serving fleet: many engines, one process, one front door
(port of deepvision_tpu/serve/fleet.py).

Each served model gets its OWN `DynamicBatcher`, `ServingMetrics` and
circuit breaker (coalescing only ever combines same-model requests, and one
model's broken dispatch path fail-fasts its own requests only), while the
card is shared by every batcher's dispatches.

Routing contract (served by serve/server.py):

    POST /predict            -> the DEFAULT model (first added)
    POST /predict/<name>     -> that model; unknown names get 404 with the
                                served-model list in the body
    GET  /stats[/<name>]     -> per-model ServingMetrics + weight provenance
    GET  /healthz            -> aggregate status, device, and per model the
                                provenance, reload outcomes, autoscale
                                decisions, breaker state, workers and the
                                promotion record

Hot weight reload (serve/reload.py) works on the `ServedModel`s that carry
a `workdir`; their `reload_stats` and `autoscale_stats` (guarded by
`reload_lock`, the control-plane lock) surface on /healthz and /metrics.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterator, List, Optional

from ..ops import _build
from .autoscale import CircuitBreaker
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
    metrics, plus the run dir hot reload watches (None = static weights)
    and, when the deployment gates promotions, its PromotionController."""

    def __init__(self, engine: PredictEngine, batcher: DynamicBatcher,
                 metrics: ServingMetrics, workdir: Optional[str] = None):
        self.engine = engine
        self.batcher = batcher
        self.metrics = metrics
        self.workdir = workdir
        # serve/promote.PromotionController when candidates run shadow and
        # canary before going live; None = the direct integrity-verified swap
        self.promoter = None
        # flywheel/controller.FlywheelController when drift-triggered
        # continuous training is armed (--flywheel-every); None = none
        self.flywheel = None
        self.reload_lock = threading.Lock()
        self.reload_stats: Dict[str, float] = {
            "reloads": 0, "refused_corrupt": 0, "refused_incompatible": 0,
            "refused_gate": 0, "rolled_back": 0}
        # the AutoscaleController's decision record (under reload_lock)
        self.autoscale_stats: Dict[str, float] = {
            "scale_ups": 0, "scale_downs": 0, "escalations": 0,
            "wants_scale_out": False,
            "workers": self.batcher.workers}
        # the model's p99 contract (max_delay + one max-bucket compute
        # time, ms), measured by the autoscaler's first sample
        self.p99_bound_ms: Optional[float] = None

    @property
    def name(self) -> str:
        return self.engine.name

    @property
    def breaker(self) -> Optional[CircuitBreaker]:
        return self.batcher.breaker

    def submit(self, images, *, deadline_s: Optional[float] = None,
               precision: Optional[str] = None, trace=None):
        """Route one request into this model's batcher (the promotion
        canary's fraction onto the candidate generation). `deadline_s`
        feeds admission control (None = the batcher's configured default);
        `precision` pins the request to "bf16" or "int8" (None = the
        model's active precision); `trace` is a sampled request's
        TraceContext."""
        return self.submit_routed(images, deadline_s=deadline_s,
                                  precision=precision, trace=trace)[0]

    def submit_routed(self, images, *, deadline_s: Optional[float] = None,
                      precision: Optional[str] = None, trace=None):
        """`submit` plus the routing verdict: `(future, generation)`, the
        generation "candidate" when the promotion controller canary-routed
        this request and "live" otherwise. The generation that computed
        the answer is the future's `generation` (a rollback between the
        routing and the dispatch serves a canary-routed request live)."""
        generation = self.promoter.route() if self.promoter else None
        fut = self.batcher.submit(images, generation=generation,
                                  precision=precision,
                                  deadline_s=deadline_s, trace=trace)
        return fut, (generation or "live")

    def describe(self) -> dict:
        """The /healthz per-model record."""
        with self.reload_lock:
            reload_stats = dict(self.reload_stats)
            autoscale_stats = dict(self.autoscale_stats)
        workers = self.batcher.workers
        autoscale_stats["workers"] = workers
        return {
            "device": self.engine.device_name,
            "buckets": list(self.engine.buckets),
            # the kernel libraries this process loaded, each from the
            # shared build cache (a hit) or built by nvcc (a miss): the
            # tier's warm-boot audit, cache_misses == 0 on a respawn
            "compile": _build.compile_record(),
            "max_batch": self.batcher.max_batch,
            "queue_depth": self.batcher.queue_depth,
            "workers": workers,
            "default_deadline_s": self.batcher.default_deadline_s,
            "weights": self.engine.provenance,
            # the int8 axis: the precision dispatches default to, the
            # gate's last decision (why int8 is on or off) and the weight
            # bytes resident per precision
            "precision": self.engine.precision,
            "quant": self.engine.quant_decision,
            "weight_bytes_per_chip": self.engine.weight_bytes_per_chip(),
            # bucketed dispatches since the engine was built (warmup and
            # shadow evals included), by weight generation and precision
            "dispatches": {"total": self.engine.dispatches,
                           **self.engine.dispatches_by_generation,
                           "by_precision":
                               dict(self.engine.dispatches_by_precision)},
            "hot_reload": bool(self.workdir),
            "reload": reload_stats,
            "autoscale": autoscale_stats,
            "breaker": (self.breaker.describe() if self.breaker else None),
            "promotion": (self.promoter.describe()
                          if self.promoter else None),
            "flywheel": (self.flywheel.describe()
                         if self.flywheel else None),
        }

    def snapshot(self) -> dict:
        """The /stats per-model record."""
        snap = {
            **self.metrics.snapshot(queue_depth=self.batcher.queue_depth),
            "workers": float(self.batcher.workers),
            "weights": self.engine.provenance,
            "precision": self.engine.precision,
        }
        if self.breaker is not None:
            snap["breaker_state"] = self.breaker.describe()["state"]
        if self.promoter is not None:
            snap["promotion"] = self.promoter.describe()
        return snap


class ModelFleet:
    """Ordered name -> ServedModel map. The first model added is the
    default (`POST /predict` without a name)."""

    def __init__(self):
        self._models: Dict[str, ServedModel] = {}  # insertion-ordered

    def add(self, engine: PredictEngine, *,
            workdir: Optional[str] = None,
            max_batch: Optional[int] = None,
            max_delay_ms: float = 5.0,
            max_queue_examples: int = 1024,
            workers: int = 1,
            default_deadline_s: Optional[float] = None,
            breaker_k: int = 5,
            breaker_cooldown_s: float = 5.0) -> ServedModel:
        """Register an engine under its own name with a fresh batcher,
        metrics accumulator and circuit breaker: one model being hammered
        sheds ITS requests (429), one model's broken dispatch path
        fail-fasts ITS requests (503 naming it), and the others keep
        serving. `workers` sizes the initial dispatcher pool (the
        autoscaler resizes it live); `workdir` is the run dir hot reload
        watches."""
        if engine.name in self._models:
            raise ValueError(f"model {engine.name!r} already served — one "
                             f"entry per registry name")
        metrics = ServingMetrics()
        batcher = DynamicBatcher(
            engine, max_batch=max_batch, max_delay_ms=max_delay_ms,
            max_queue_examples=max_queue_examples, metrics=metrics,
            workers=workers, default_deadline_s=default_deadline_s)
        batcher.breaker = CircuitBreaker(engine.name, k=breaker_k,
                                         cooldown_s=breaker_cooldown_s)
        sm = ServedModel(engine, batcher, metrics, workdir=workdir)
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
        dispatcher workers). True once ALL dispatchers exited."""
        ok = True
        for sm in self:
            ok = sm.batcher.drain(timeout) and ok
        return ok
