"""Scatter sums that give the same bits on every run, on either device.

A float ``index_add_`` on a CUDA device adds with atomics, in a different
order on every run, so its sums differ in the last bits run to run.  Here
each value is cut (toward zero) to a multiple of 2^-FIXED_BITS and the
scatter adds int64 values; integer addition is associative, so the sums
are the same bits in any order, run to run, graphed or eager, on either
device.  The cut (< 1e-12 per value) is far below float32's resolution of
the positions the sums move, and each total is rounded once to float32.

A value that the integers cannot hold -- NaN, an infinity, or a magnitude
of 2^23 (8.4e6 m) or more, where x * 2^40 leaves int64 -- makes its row's
sum NaN, as a float scatter would carry a NaN through: each row also
sums, as floats, 0 for every value it takes that fits and NaN for every
one that does not.  Sums of +0 and NaN are the same in any order, and
adding +0 leaves a finite total's bits as they are.

Integers carry no gradient: when gradients are wanted, the sum also
scatters the values as floats and adds ``flt - flt.detach()``, exactly 0
in the forward, so the value stays the integer sum's bit for bit and the
gradient is the float scatter-add's.
"""

from __future__ import annotations

import torch

# values are summed as integers in units of 2^-FIXED_BITS
FIXED_BITS = 40
# the least magnitude whose value in units of 2^-FIXED_BITS leaves int64
LIMIT = float(2 ** (63 - FIXED_BITS))


class FixedSum:
    """Row sums of an (n, k) float32 table on ``device``, added to part by
    part with ``add`` and read with ``total`` (module docstring).
    ``grad``: also carry the float scatter's gradient."""

    def __init__(self, n: int, k: int, device, grad: bool = False):
        self.fixed = torch.zeros((n, k), dtype=torch.int64, device=device)
        self.bad = torch.zeros((n,), dtype=torch.float32, device=device)
        self.flt = (torch.zeros((n, k), dtype=torch.float32, device=device)
                    if grad else None)

    def add(self, index: torch.Tensor, values: torch.Tensor) -> None:
        """values[i] (float32, (M, k)) added to row index[i]."""
        self.fixed.index_add_(
            0, index, (values * float(2 ** FIXED_BITS)).to(torch.int64))
        fits = values.abs().amax(1) < LIMIT          # False for NaN
        self.bad.index_add_(0, index, torch.where(fits, 0.0, float("nan")))
        if self.flt is not None:
            self.flt = self.flt.index_add(0, index, values)

    def total(self) -> torch.Tensor:
        """The (n, k) float32 sums: each converted, then scaled by the
        exact power of two, in one kernel."""
        out = self.fixed * float(2.0 ** -FIXED_BITS) + self.bad[:, None]
        if self.flt is not None:
            out = out + (self.flt - self.flt.detach())
        return out


def index_sum(n: int, parts) -> torch.Tensor:
    """Row sums (n, k) float32 of every ``(index (M,), values (M, k))`` in
    ``parts`` (values float32 on one device): values[i] goes to row
    index[i].  Same bits on every run; under autograd the float scatter's
    gradient (module docstring)."""
    parts = list(parts)
    v0 = parts[0][1]
    acc = FixedSum(n, v0.shape[1], v0.device, grad=torch.is_grad_enabled()
                   and any(v.requires_grad for _, v in parts))
    for index, values in parts:
        acc.add(index, values)
    return acc.total()
