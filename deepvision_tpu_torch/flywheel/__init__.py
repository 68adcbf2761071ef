"""Flywheel: drift-triggered continuous training (port of
deepvision_tpu/flywheel/).

The loop that closes serve -> train -> serve: `DriftMonitor` (drift.py)
watches one served model's live inputs and watched metric against the
pinned calibration shard, and `FlywheelController` (controller.py) turns a
confirmed drift event into a bounded fine-tune on the engine's device,
re-gates the result through the promotion pipeline, and backs off — or
opens a circuit — when candidates keep failing. Every decision of one
episode carries one `flywheel_id` across the resilience stream, the
spans, the promotion decision record and /healthz.
"""

from .controller import FLYWHEEL_STATES, FlywheelController
from .drift import DriftMonitor

__all__ = ["DriftMonitor", "FlywheelController", "FLYWHEEL_STATES"]
