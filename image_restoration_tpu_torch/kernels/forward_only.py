"""Keeps a forward-only CUDA launch inside the autograd graph.

A kernel wrapper fills fresh ``torch.empty`` buffers through ctypes, which
autograd cannot see: the result would carry no ``grad_fn``, and a
``loss.backward()`` through it would silently leave the parameters without
gradients. :func:`forward_only` runs the launch inside a
``torch.autograd.Function`` whenever a gradient could flow, so that
``backward()`` raises instead.

The JAX kernel APIs differentiate through custom VJPs, and so do the
port's (``kernels/block.py`` ``RecomputeVJP``: ``fused_block``,
``ln_qkv_dwconv``, ``fused_mdta_core``, ``fused_ln_gdfn``,
``fused_drs_block``, ``fused_mefc_steps``; ``kernels/ska.py`` ``ska``).
What comes here are the passes those APIs are made of, called alone:
``block_front``, ``block_apply_gdfn``, ``attn_acc``, ``attn_apply``,
``drs_apply_msfn`` and ``mefc_step``. JAX has no VJP for them either (its
``run_front`` has none).
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
            f"{ctx.name}: the CUDA kernel called alone is forward only, as "
            f"the JAX pass has no VJP. Differentiate through the kernel API "
            f"it belongs to (fused_block, fused_mdta_core, fused_drs_block, "
            f"fused_mefc_steps), or the plain version (CPU tensors, or the "
            f"model with its kernel flag off).")


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
