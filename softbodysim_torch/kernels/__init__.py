"""Hand-written CUDA kernels (``csrc/*.cu``) behind PyTorch wrappers, each
with its plain PyTorch version; ``launch_counts`` reads every wrapper's
count of kernel launches.  A wrapper that launches one of several
instantiations of a kernel (the f32 and the bf16 particle table) counts
each under its own name: the wrapper's for the f32 one, a
``LaunchCounter`` beside it for the other."""

import collections
import contextlib
import threading

import torch

# per thread, the launch tallies of the CUDA graph captures in progress
# (innermost last): a capture records one thread's launches, and threads
# (server sessions) capture at the same time
_local = threading.local()
# the wrappers' counts are shared by every thread
_counts_lock = threading.Lock()


def _captures() -> list:
    stack = getattr(_local, "captures", None)
    if stack is None:
        stack = _local.captures = []
    return stack


class LaunchCounter:
    """The launch count of one instantiation of a wrapper's kernel, under
    its own name (what ``count_launch`` takes besides a wrapper)."""

    def __init__(self, name: str):
        self.__name__ = name
        self.launches = 0


def _wrappers():
    from . import collide, jacobi, sweep

    return (sweep.w_fill, sweep.edge_sweep, sweep.tet_sweep,
            jacobi.jacobi_edge_pass, jacobi.jacobi_tet_pass,
            jacobi.jacobi_edge_pass_collide, jacobi.jacobi_tet_pass_collide,
            collide.collide, sweep.legacy_edge_sweep, sweep.legacy_tet_sweep,
            jacobi.jacobi_edge_accumulate, jacobi.jacobi_tet_accumulate,
            sweep.w_fill_bf16, sweep.edge_sweep_bf16, sweep.tet_sweep_bf16,
            collide.collide_bf16)


def count_launch(fn) -> None:
    """One launch of ``fn``'s kernel (``fn``: a wrapper or a
    ``LaunchCounter``): added to ``fn.launches``, or, while
    the current stream captures a CUDA graph (nothing runs), to this
    thread's innermost capture tally (``capture_tally``), which each
    replay adds."""
    if torch.cuda.is_current_stream_capturing():
        stack = _captures()
        if stack:
            stack[-1][fn.__name__] += 1
    else:
        with _counts_lock:
            fn.launches += 1


@contextlib.contextmanager
def capture_tally():
    """Yields {wrapper name: launches} recorded by this thread's captures
    inside."""
    tally = collections.Counter()
    stack = _captures()
    stack.append(tally)
    try:
        yield tally
    finally:
        stack.pop()


def launch_counts() -> dict:
    """{wrapper name: kernel launches since the last reset}."""
    return {fn.__name__: fn.launches for fn in _wrappers()}


def reset_launch_counts() -> None:
    with _counts_lock:
        for fn in _wrappers():
            fn.launches = 0


def add_launch_counts(counts: dict) -> None:
    """Add ``counts`` ({wrapper name: n}) to the wrappers' counts: a CUDA
    graph's replay launches the kernels its capture recorded."""
    with _counts_lock:
        for fn in _wrappers():
            fn.launches += counts.get(fn.__name__, 0)
