"""Mixture-of-experts routing of the MoCE family
(image_restoration_tpu/ops/moe.py).

The gates are the softmax of the routing logits kept at their top-k
positions and zero elsewhere, so a dense combine of every expert's output
(:func:`dense_moe_combine`) equals the reference's sparse dispatch. Eval
adds no noise: the reference's eval-time gate noise makes eval stochastic,
and the JAX package treats it as a defect. Training adds Gaussian noise to
the logits (drawn by :func:`routing_noise` from an explicit generator) and
two balance losses: :func:`importance_loss`, the CV^2 of the (optionally
complexity-weighted) softmax mass per expert, and :func:`load_loss`, the
CV^2 of the smooth top-k inclusion probability through the normal CDF
(noisy top-k gating, Shazeer et al.). torch's ``std`` is unbiased, as the
reference's, and the JAX package's ``ddof=1``. Inside a data-parallel
step (``parallel/global_batch.py``) the balance losses' batch sums run over
the global batch and the noise is the global batch's draw, as under JAX's
sharded jit.
"""

from __future__ import annotations

import torch

from image_restoration_tpu_torch.parallel import global_batch


def topk_lower_index(x, k: int):
    """(values, indices) of the k largest entries along the last axis,
    ties broken toward the lower index (``jax.lax.top_k``'s order), which
    ``torch.topk`` does not promise: a stable descending sort keeps equal
    entries in index order."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def routing_noise(shape, generator, device=None):
    """A standard normal fp32 draw of ``shape`` from ``generator`` on
    ``device`` (default: the generator's): the training noise of every
    router. There is no fallback to the global RNG: without a generator
    this raises, so an unseeded draw cannot pass for a seeded one."""
    if not isinstance(generator, torch.Generator):
        raise ValueError("training-mode routing needs a torch.Generator for "
                         "its noise (the step's generator, e.g. "
                         "data/degradations.py step_generator(seed, step, "
                         "device, stream=1))")
    gb = global_batch.current()
    if gb is not None:  # the global batch's draw, this rank's rows
        return gb.randn(shape, generator, device)
    return torch.randn(tuple(shape), generator=generator,
                       device=device or generator.device,
                       dtype=torch.float32)


def noisy_topk_gates(logits, k: int, noise_std=None, noise=None):
    """(gates, top_idx, top_vals, noisy) of (.., E) logits (the JAX
    ``noisy_topk_gates``).

    ``noisy`` is ``logits + noise * noise_std`` when ``noise`` is given
    (training), else the logits themselves. ``gates`` (.., E) holds
    softmax(noisy) at the top-k positions and 0 elsewhere; ``top_idx`` and
    ``top_vals`` (.., k) are the picks in descending order, ties to the
    lower index.
    """
    noisy = logits if noise is None else logits + noise * noise_std
    scores = torch.softmax(noisy, dim=-1)
    top_vals, top_idx = topk_lower_index(scores, k)
    gates = torch.zeros_like(scores).scatter(-1, top_idx, top_vals)
    return gates, top_idx, top_vals, noisy


def importance_loss(softmax_logits, complexity=None, tau: float = 1.0):
    """CV^2 of the per-expert softmax mass over the batch (moce_ir.py:
    713-724), weighted by ``complexity * tau`` when given."""
    importance = global_batch.batch_sum(softmax_logits)
    if complexity is not None:
        importance = importance * (complexity * tau)
    return (importance.std() / (importance.mean() + 1e-8)) ** 2


def load_loss(logits, noisy_logits, noise_std: float, k: int):
    """CV^2 of the smooth load (moce_ir.py:726-747): the probability that
    each clean logit, under fresh noise, clears the k-th largest noisy
    logit of its row (the lower index's on ties), through the normal CDF,
    averaged over the rows."""
    kth_idx = topk_lower_index(noisy_logits, k)[1][:, -1:]
    threshold = noisy_logits.gather(-1, kth_idx)
    p = 1.0 - torch.special.ndtr((threshold - logits) / noise_std)
    p_mean = global_batch.batch_mean(p)
    return (p_mean.std() / (p_mean.mean() + 1e-8)) ** 2


def route(logits, k: int, train: bool = False, generator=None,
          complexity=None):
    """(gates, top_idx, top_vals, aux) of a MoCE router's (N, E) fp32
    logits (the JAX ``RoutingFunction`` body, moce_ir.py:193-202). In
    training the logits take :func:`routing_noise` from ``generator`` at
    std 1/E, and ``aux`` is 0.5 x :func:`importance_loss` of the clean
    softmax (weighted by ``complexity`` when given) plus 0.5 x
    :func:`load_loss`; in eval there is no noise and ``aux`` is 0."""
    if not train:
        return (*noisy_topk_gates(logits, k)[:3], 0.0)
    noise_std = 1.0 / logits.shape[-1]
    noise = routing_noise(logits.shape, generator, logits.device)
    gates, top_idx, top_vals, noisy = noisy_topk_gates(logits, k, noise_std,
                                                       noise)
    li = importance_loss(torch.softmax(logits, dim=-1), complexity)
    ll = load_loss(logits, noisy, noise_std, k)
    return gates, top_idx, top_vals, 0.5 * li + 0.5 * ll


def dense_moe_combine(gates, expert_outputs):
    """out[b] = sum_e gates[b, e] * expert_outputs[e][b], with the gates
    cast to the outputs' dtype (the JAX ``dense_moe_combine``)."""
    bank = torch.stack(expert_outputs, dim=1)  # (B, E, ...)
    return torch.einsum("be,be...->b...", gates.to(bank.dtype), bank)
