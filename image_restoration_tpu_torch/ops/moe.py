"""Mixture-of-experts routing of the MoCE family, eval path
(image_restoration_tpu/ops/moe.py).

The gates are the softmax of the routing logits kept at their top-k
positions and zero elsewhere, so a dense combine of every expert's output
(:func:`dense_moe_combine`) equals the reference's sparse dispatch. Eval
adds no noise: the reference's eval-time gate noise makes eval stochastic,
and the JAX package treats it as a defect. The training path (the noise,
``importance_loss`` and ``load_loss``) is the MoCE family's training slice
(ROADMAP Queue 1 item 4).
"""

from __future__ import annotations

import torch


def topk_lower_index(x, k: int):
    """(values, indices) of the k largest entries along the last axis,
    ties broken toward the lower index (``jax.lax.top_k``'s order), which
    ``torch.topk`` does not promise: a stable descending sort keeps equal
    entries in index order."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def noisy_topk_gates(logits, k: int):
    """The eval path of the JAX ``noisy_topk_gates``: (gates, top_idx,
    top_vals) of (.., E) logits.

    ``gates`` (.., E) holds softmax(logits) at the top-k positions and 0
    elsewhere; ``top_idx`` and ``top_vals`` (.., k) are the picks in
    descending order, ties to the lower index.
    """
    scores = torch.softmax(logits, dim=-1)
    top_vals, top_idx = topk_lower_index(scores, k)
    gates = torch.zeros_like(scores).scatter(-1, top_idx, top_vals)
    return gates, top_idx, top_vals


def dense_moe_combine(gates, expert_outputs):
    """out[b] = sum_e gates[b, e] * expert_outputs[e][b], with the gates
    cast to the outputs' dtype (the JAX ``dense_moe_combine``)."""
    bank = torch.stack(expert_outputs, dim=1)  # (B, E, ...)
    return torch.einsum("be,be...->b...", gates.to(bank.dtype), bank)
