"""Seeded parameters for the port's tests, without jax (the CUDA test
files import it too)."""

import torch


def seed_biases(model, seed, scale=0.1):
    """Every parameter named ``bias`` drawn as ``scale`` x a standard
    normal from a generator seeded ``seed``. The init's biases are zero, as
    the JAX package's, so a test that needs a bias to exercise a path (a
    load seen to move it, a kernel that must add it) seeds it here."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.copy_(scale * torch.randn(p.shape, generator=gen))


def seed_adaptir(model, seed, x):
    """IPT's or EDT's weights made to exercise every AdaptIR adapter: the
    zero-initialised adapter ``tail``s drawn at lecun's scale, 1 /
    sqrt(hidden), from a generator seeded ``seed`` (at zero no adapter
    reaches the output); IPT's first head conv at 1 / 255 of its init, as
    its input is x255 (at the init's scale the decoder's cross-attention
    softmaxes saturate and fp32 runs agree to ~5e-5 only); the adapters'
    BatchNorm statistics from one ``train=True`` forward of ``x``. The
    phase weights stay at 1: the phase of a real negative rfft2
    coefficient is +-pi by the sign of rounding noise, which only an
    integer weight maps to one angle."""
    from image_restoration_tpu_torch.models.adaptir_ipt import (
        IPT, AdaptIRAdapter,
    )

    gen = torch.Generator().manual_seed(seed)
    adapters = [m for m in model.modules() if isinstance(m, AdaptIRAdapter)]
    with torch.no_grad():
        for m in adapters:
            w = m.tail.weight
            w.copy_(torch.randn(w.shape, generator=gen) * m.hidden ** -0.5)
        if isinstance(model, IPT):
            model.head[str(model.task_idx)][0].weight.div_(model.rgb_range)
        momenta = [m.BN.momentum for m in adapters]
        for m in adapters:
            m.BN.reset_running_stats()
            m.BN.momentum = 1.0  # the running statistics become the batch's
        model(x, train=True)
        for m, momentum in zip(adapters, momenta):
            m.BN.momentum = momentum
