"""Keeps a forward-only CUDA launch inside the autograd graph.

A kernel wrapper fills fresh ``torch.empty`` buffers through ctypes, which
autograd cannot see: the result would carry no ``grad_fn``, and a
``loss.backward()`` through it would silently leave the parameters without
gradients. :func:`forward_only` runs the launch inside a
``torch.autograd.Function`` whenever a gradient could flow, so that
``backward()`` raises instead. The JAX kernels differentiate through custom
VJPs that recompute the plain composition; the CUDA backward passes come
with the port's training slice.
"""

from __future__ import annotations

import torch


class _ForwardOnly(torch.autograd.Function):
    @staticmethod
    def forward(ctx, name, launch, *inputs):
        ctx.name = name
        return launch()

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            f"{ctx.name}: the CUDA kernel is forward only; its backward "
            f"comes with the port's training slice. Run the plain version "
            f"(CPU tensors, or the model with its kernel flag off) to "
            f"differentiate.")


def _tensors(inputs):
    for t in inputs:
        if isinstance(t, torch.Tensor):
            yield t
        elif isinstance(t, (list, tuple)):
            yield from _tensors(t)


def forward_only(name, inputs, launch):
    """``launch()``: a tensor or a tuple of tensors. When grad mode is on
    and one of ``inputs`` (tensors, None, or nested lists of them) requires
    grad, the result hangs in the graph under a node whose backward raises
    ``NotImplementedError``; otherwise this is exactly ``launch()``."""
    tensors = [t for t in _tensors(inputs) if t.requires_grad]
    if tensors and torch.is_grad_enabled():
        return _ForwardOnly.apply(name, launch, *tensors)
    return launch()
