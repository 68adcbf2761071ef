"""Serving subsystem of the port (counterpart of deepvision_tpu/serve/):

- engine.PredictEngine: shape-bucketed predict on one device (padding
  provably inert), bf16 compute with f32 outputs, two weight generations
  (live and a staged candidate)
- batcher.DynamicBatcher: thread-safe micro-batching with deadline +
  max_batch flush over a pool of dispatcher workers, futures,
  backpressure, admission control, generation-tagged batches
- metrics.ServingMetrics: p50/p99, padding waste, batch fill, shed,
  lifetime totals and fixed-bucket histograms
- autoscale: the per-model CircuitBreaker and the AutoscaleController
- reload.WeightReloader: hot reload of newly verified epochs
- promote.PromotionController: shadow eval, gate, canary, promote or
  roll back
- fleet.ModelFleet: many models behind one process, routed by name
- server.InferenceServer: stdlib HTTP front end (/predict, /healthz,
  /stats, /metrics, /trace, /reload) + graceful SIGTERM drain
- cli: `python -m deepvision_tpu_torch.serve` (HTTP or --smoke)
"""
