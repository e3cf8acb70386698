"""Hand-written CUDA kernels (``csrc/*.cu``) behind PyTorch wrappers, each
with its plain PyTorch version; ``launch_counts`` reads every wrapper's
count of kernel launches."""


def _wrappers():
    from . import collide, jacobi, sweep

    return (sweep.w_fill, sweep.edge_sweep, sweep.tet_sweep,
            jacobi.jacobi_edge_pass, jacobi.jacobi_tet_pass, collide.collide,
            sweep.legacy_edge_sweep, sweep.legacy_tet_sweep)


def launch_counts() -> dict:
    """{wrapper name: kernel launches since the last reset}."""
    return {fn.__name__: fn.launches for fn in _wrappers()}


def reset_launch_counts() -> None:
    for fn in _wrappers():
        fn.launches = 0
