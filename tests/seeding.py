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
    calibrate_batchnorms(model, x)


def calibrate_batchnorms(model, x, **kw):
    """Every BatchNorm2d's statistics set to the batch statistics of one
    ``model(x, train=True, **kw)`` (the models whose BatchNorms follow the
    forward's ``train``), each normalizing what the ones before it
    normalized; nothing without one."""
    from image_restoration_tpu_torch.ops.layernorm import BatchNorm2d

    bns = [m for m in model.modules() if isinstance(m, BatchNorm2d)]
    if not bns:
        return
    momenta = [bn.momentum for bn in bns]
    for bn in bns:
        bn.reset_running_stats()
        bn.momentum = 1.0  # the running statistics become the batch's
    with torch.no_grad():
        model(x, train=True, **kw)
    for bn, momentum in zip(bns, momenta):
        bn.momentum = momentum


def seed_branches(model, seed, x):
    """RectiFormer's, FPN-Restormer's or MyModel's weights made to exercise
    every branch: MyModel's zero-initialised ``beta``/``gamma`` layer
    scales drawn as 0.5 + 0.2 x a standard normal and its AdaptIR
    adapters' zero ``tail``\\ s at lecun's scale, 1 / sqrt(hidden), from a
    generator seeded ``seed`` (at zero no Mix, adapter or decoder mixer
    reaches the output); every BatchNorm's statistics from one
    ``train=True`` forward of ``x`` (the routers' noise from the same
    generator). RectiFormer has neither and is left as it is."""
    from image_restoration_tpu_torch.models.adaptir_ipt import AdaptIRAdapter

    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(("beta", "gamma")):
                p.copy_(0.5 + 0.2 * torch.randn(p.shape, generator=gen))
        for m in model.modules():
            if isinstance(m, AdaptIRAdapter):
                w = m.tail.weight
                w.copy_(torch.randn(w.shape, generator=gen) * m.hidden ** -0.5)
    moe = getattr(type(model), "uses_moe_rng", False)
    calibrate_batchnorms(model, x, **({"generator": gen} if moe else {}))


def write_niqe_params(path, seed=0):
    """Synthetic NIQE pristine parameters at ``path`` (an ``.npz`` of the
    official file's keys; the repo ships none): ``mu_pris_param`` a seeded
    36-vector, ``cov_pris_param`` a seeded 36x36 symmetric positive
    definite matrix, ``gaussian_window`` the 7x7 MATLAB window. Returns
    ``path``."""
    import numpy as np

    from image_restoration_tpu_torch.eval.niqe import matlab_gaussian_window

    rng = np.random.default_rng(seed)
    a = rng.standard_normal((36, 36))
    np.savez(path, mu_pris_param=rng.standard_normal(36),
             cov_pris_param=a @ a.T / 36 + np.eye(36),
             gaussian_window=matlab_gaussian_window())
    return path
