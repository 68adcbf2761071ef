"""`python -m deepvision_tpu_torch.serve.replica` — one replica of a serving
tier (port of deepvision_tpu/serve/replica.py).

A replica IS the standalone server (serve/cli.py builds it through the
same `build_server`), launched under the contract the tier router
(serve/tier.py) supervises it by:

- **Identity**: `--replica-id` is echoed on `/healthz` (`"replica"`), so
  the router knows which process answers a slot's port.
- **Warm boot**: the kernel libraries of ops/_build.py are built once
  into the checkout's shared cache; every replica on the machine loads
  them from there, and `/healthz` reports per model which libraries this
  process loaded and whether nvcc had to build one (`compile`:
  `cache_misses == 0` on a respawn).
- **Graceful de-admission**: `--drain-grace` defaults to 0.75 s here (the
  standalone CLI's is 0): on SIGTERM `/healthz` flips to "draining" in the
  signal handler and the replica keeps answering for the grace window, so
  the router's health poll de-admits it before the drain refuses anything.
- **Router-driven promotion**: `--promote-gate` stands without
  `--reload-every`: the replica arms the shadow and canary controller but
  never polls for candidates; the router's rolling promotion drives
  `POST /reload` one replica at a time.
- **Fault rehearsal**: `DEEPVISION_FAULT_REPLICA_CRASH` /
  `DEEPVISION_FAULT_REPLICA_WEDGE` (utils/faults.py) are read from the
  environment by the server itself.
- **The device**: `--device` (default `cuda`) is the server's; a replica
  that finds no card exits non-zero unless it was given `--device cpu`.
"""

from __future__ import annotations

from typing import Optional, Sequence

from .cli import build_parser, build_server, validate_args


def build_replica_parser():
    p = build_parser()
    p.prog = "python -m deepvision_tpu_torch.serve.replica"
    p.add_argument("--replica-id", default=None,
                   help="tier slot identity, echoed on /healthz — set by "
                        "the router (serve/tier.py) so it can tell which "
                        "replica answers a supervised slot's port")
    # replicas live behind a health-polling router: give its poll one
    # window to de-admit before the drain refuses work
    p.set_defaults(drain_grace=0.75)
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = build_replica_parser()
    args = parser.parse_args(argv)
    # the router triggers promotion via POST /reload; the replica's own
    # poller stays off unless explicitly armed
    validate_args(parser, args, require_reload_for_gate=False)
    server = build_server(args, replica_id=args.replica_id)
    try:
        server.serve(port=args.port, host=args.host)
    finally:
        server.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
