"""Serving subsystem of the port (counterpart of deepvision_tpu/serve/):

- engine.PredictEngine: shape-bucketed predict on one device (padding
  provably inert), bf16 compute with f32 outputs
- batcher.DynamicBatcher: thread-safe micro-batching with deadline +
  max_batch flush, futures, backpressure and admission control
- metrics.ServingMetrics: p50/p99, padding waste, batch fill, shed
- fleet.ModelFleet: many models behind one process, routed by name
- server.InferenceServer: stdlib HTTP front end + graceful SIGTERM drain
- cli: `python -m deepvision_tpu_torch.serve` (HTTP or --smoke)
"""
