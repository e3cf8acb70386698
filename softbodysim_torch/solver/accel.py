"""Chebyshev semi-iterative acceleration (Wang 2015), one loop helper for
every jacobi-dialect iteration loop of the port.

The counterpart of ``softbodysim_tpu/solver/accel.py::chebyshev_scan``:

    omega_k = 1 for k < delay;  omega_delay = 2 / (2 - rho^2)
    omega_{k+1} = 4 / (4 - rho^2 * omega_k)
    x_{k+1} = omega (x_jacobi - x_{k-1}) + x_{k-1}

The omega sequence depends on nothing but the iteration index, so it is
computed on the host in float32.  Pinned and dead rows are untouched:
their Jacobi update is the identity, and the blend of three equal values
returns the value.
"""

from __future__ import annotations

import numpy as np


def chebyshev_omegas(params) -> list:
    """The per-iteration blend factors as float32-exact Python floats."""
    f32 = np.float32
    rho2 = f32(float(params.chebyshev_rho) ** 2)
    om, out = f32(1.0), []
    for it in range(params.iterations):
        if it < params.chebyshev_delay:
            om = f32(1.0)
        elif it == params.chebyshev_delay:
            om = f32(2.0) / (f32(2.0) - rho2)
        else:
            om = f32(4.0) / (f32(4.0) - rho2 * om)
        out.append(float(om))
    return out


def chebyshev_loop(iter_fn, x0, params, get=None, set_=None):
    """Run ``params.iterations`` of ``iter_fn`` (x -> x), Chebyshev-blended
    when ``params.chebyshev`` is set.

    get / set_ select the blended position rows inside a larger carry
    (the (V, 4) table of the pass backend blends columns 0:3; ``set_`` may
    write in place and returns the carry); identity by default.  get()
    must return a tensor that the next ``iter_fn`` call does not
    overwrite."""
    if get is None:
        get = lambda x: x                                    # noqa: E731
    if set_ is None:
        set_ = lambda x, p: p                                # noqa: E731
    if not params.chebyshev:
        x = x0
        for _ in range(params.iterations):
            x = iter_fn(x)
        return x
    x_cur, x_prev = x0, get(x0)
    for om in chebyshev_omegas(params):
        cur = get(x_cur)
        x_jac = iter_fn(x_cur)
        x_cur = set_(x_jac, om * (get(x_jac) - x_prev) + x_prev)
        x_prev = cur
    return x_cur
