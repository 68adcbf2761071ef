"""Device time of a kernel call, with no host dispatch cost in it.

A host loop of wrapper calls between CUDA events reads the host's cost
(Python, the wrapper's checks, the launch) whenever the device finishes a
call faster than the host can issue the next one, as a small kernel does.
`graph_ms` captures the calls in one CUDA graph and times a replay, so
the launches run back to back on the device.
"""

from __future__ import annotations

from typing import Callable

import torch


def graph_ms(fn: Callable[[], object], iters: int = 50) -> float:
    """Mean device ms of one call of `fn`: `iters` calls captured in one
    CUDA graph (a kernel launched on the current stream lands in it),
    replayed once to warm up and once between CUDA events. `fn` runs 3
    times on a side stream first, as capture requires, and must not
    synchronize with the host."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters
