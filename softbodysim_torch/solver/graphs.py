"""CUDA graphs of a step's body on its static tables, shared by the
steps that replay one on the card (``xpbd.ColouredStep``: one iteration;
``jacobi_pass.JacobiPassStep``: one substep).

At a key's first use the body runs eagerly on a side stream -- that run
is the step's work for this call, and lazy set-up (allocator pools, the
kernel library's first load) stays out of the capture -- and is then
captured once; later uses replay the graph.  Capture records and does
not run: the kernel wrappers count the launches it records in its tally
(``kernels.capture_tally``), and each replay adds that tally to their
launch counts, so the counts equal an eager run's.  A failed capture
raises.

Threads (server sessions) may capture at the same time.  Each capture
runs on a stream of its own in CUDA's thread-local mode: only the
capturing thread is barred from calls that are unsafe during a capture,
so another thread that allocates, launches or waits on its own streams
meanwhile does not invalidate it.  ``torch.cuda.graph`` is not used: it
synchronizes the device and empties the allocator's cache before it
begins, which another thread's capture in progress forbids.  The launch
tallies are per thread (``kernels.capture_tally``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels import add_launch_counts, capture_tally


class Graph(NamedTuple):
    graph: torch.cuda.CUDAGraph
    out: object            # what ``body()`` returned while captured
    launches: dict         # {wrapper name: kernel launches per replay}

    def replay(self) -> None:
        self.graph.replay()
        add_launch_counts(self.launches)


class GraphCache:
    """At most ``kept`` graphs of one step, by key (the oldest dropped)."""

    def __init__(self, device: torch.device, kept: int):
        self.device, self.kept = device, kept
        self._graphs = {}

    def __len__(self) -> int:
        return len(self._graphs)

    def run(self, key, body):
        """What ``body()`` returns, for ``key``: the replay of its graph
        (the output the capture recorded), or at the key's first use the
        eager run's, after which ``body`` is captured."""
        hit = self._graphs.get(key)
        if hit is not None:
            hit.replay()
            return hit.out
        dev = self.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            out = body()
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with capture_tally() as tally, torch.cuda.stream(
                torch.cuda.Stream(dev)):
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                captured = body()
            except BaseException:
                try:                      # leave the stream usable
                    graph.capture_end()
                except RuntimeError:
                    pass
                raise
            graph.capture_end()
        if len(self._graphs) >= self.kept:
            self._graphs.pop(next(iter(self._graphs)))
        self._graphs[key] = Graph(graph, captured, dict(tally))
        return out
