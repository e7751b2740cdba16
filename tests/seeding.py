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
