"""Tensor-parallel compute for the layers whose weights the ``model`` axis
splits (Megatron's column- and row-parallel linears).

Under :func:`model_axis` the train step runs the core on each rank's local
shards of the split weights (``partitioning.gather(..., local_model=True)``):
a column-parallel weight (q/k/v, ``c_fc``, ``linear1``) holds this rank's
output rows and a row-parallel one (``out_proj``, ``c_proj``, ``linear2``)
its input columns. A layer sees the split in its weight's shape and calls
:func:`column_linear` / :func:`row_linear`: the input of a column-parallel
linear enters unchanged and its gradient is summed over the axis, and the
output of a row-parallel linear is summed over the axis before its bias is
added. Everything between the two (the heads, the MLP's hidden layer) runs on
this rank's part only, so the axis splits the matmuls as JAX's GSPMD does.
Biases are never split (JAX's ``param_spec``): a column-parallel linear takes
its rows of the full bias, and the bias's gradient is summed over the axis.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

_GROUP = None


@contextlib.contextmanager
def model_axis(group):
    """Run the layers inside on weights split over ``group`` (the mesh's
    ``model`` axis; None: no split)."""
    global _GROUP
    prev, _GROUP = _GROUP, group
    try:
        yield
    finally:
        _GROUP = prev


def _group():
    if _GROUP is None:
        raise RuntimeError("a layer's weight is split over the model axis, but no "
                           "model_axis(group) is active")
    return _GROUP


class _SumGradient(torch.autograd.Function):
    """Identity; the backward sums the gradient over the axis (each rank's
    columns give part of it)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _SumOutput(torch.autograd.Function):
    """The sum over the axis; the backward passes the gradient on (every
    rank holds the whole summed output)."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def local_rows(t: torch.Tensor, n: int) -> torch.Tensor:
    """This rank's ``n`` rows of ``t``, split evenly over the axis."""
    return t.narrow(0, dist.get_rank(_group()) * n, n)


def column_input(x: torch.Tensor) -> torch.Tensor:
    """The input of a column-parallel linear: ``x``, with its gradient
    summed over the axis."""
    return _SumGradient.apply(x, _group())


def column_linear(x: torch.Tensor, weight: torch.Tensor,
                  bias: Optional[torch.Tensor]) -> torch.Tensor:
    """``x`` through this rank's output rows ``weight`` (and their part of
    the full ``bias``, whose gradient is then summed over the axis: each rank
    gives its rows')."""
    if bias is not None:
        bias = local_rows(column_input(bias), weight.shape[0])
    return F.linear(column_input(x), weight, bias)


def row_linear(x: torch.Tensor, weight: torch.Tensor,
               bias: Optional[torch.Tensor]) -> torch.Tensor:
    """This rank's part of the input ``x`` through its input columns
    ``weight``, summed over the axis, plus the full ``bias``."""
    out = _SumOutput.apply(F.linear(x, weight), _group())
    return out if bias is None else out + bias
