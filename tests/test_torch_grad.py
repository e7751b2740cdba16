"""Autograd around the kernel wrappers.

The CUDA launches are forward only: ``kernels/forward_only.py`` keeps them
in the graph under a node whose backward raises, so that a
``loss.backward()`` through a CUDA model cannot silently leave its
parameters without gradients (the *_cuda.py files hold that on the card).
Here, on the CPU:

* ``forward_only`` itself, with a stand-in launch: inputs that require grad
  give a result whose ``backward()`` raises ``NotImplementedError`` naming
  the kernel; without such inputs, or under ``torch.no_grad()``, the result
  is the launch's own object (serving is unchanged);
* every wrapper on CPU tensors runs its plain version, which differentiates:
  the input and a parameter get finite, non-zero gradients.

This file imports no jax.
"""

import numpy as np
import pytest
import torch
from test_torch_block_cuda import _params
from test_torch_drs_cuda import drs_params, step_params

from image_restoration_tpu_torch.kernels import attn_core as KA
from image_restoration_tpu_torch.kernels import block as K
from image_restoration_tpu_torch.kernels import drs_block as KD
from image_restoration_tpu_torch.kernels import gdfn as KG
from image_restoration_tpu_torch.kernels import mdta as KM
from image_restoration_tpu_torch.kernels import mefc as M
from image_restoration_tpu_torch.kernels import ska as KS
from image_restoration_tpu_torch.kernels.forward_only import forward_only

CPU = torch.device("cpu")
H, W, C, HEADS = 6, 20, 16, 1


def _leaf(rng, *shape, scale=1.0):
    a = scale * rng.standard_normal(shape)
    return torch.from_numpy(a.astype(np.float32)).requires_grad_()


def _grad_params(p):
    """The same parameters as leaves that require grad."""
    def leaf(t):
        if isinstance(t, list):
            return [leaf(u) for u in t]
        return None if t is None else t.clone().requires_grad_()
    return type(p)(*(leaf(t) for t in p))


def _restormer(seed):
    rng = np.random.default_rng(seed)
    return _grad_params(_params(rng, C, HEADS, "WithBias", CPU)), \
        _leaf(rng, 1, H, W, C)


def _block_front(seed):
    p, x = _restormer(seed)
    v, gram, ss = K.block_front(x, p.front(), HEADS)
    return v.sum() + gram.sum() + ss.sum(), (x, p.qkv_w)


def _block_apply_gdfn(seed):
    p, x = _restormer(seed)
    v = _leaf(np.random.default_rng(seed + 1), 1, H, W, C)
    atw = _leaf(np.random.default_rng(seed + 2), 1, C, C, scale=0.2)
    return K.block_apply_gdfn(v, x, atw, p).sum(), (v, x, atw, p.out_w)


def _fused_ln_gdfn(seed):
    p, x = _restormer(seed)
    return KG.fused_ln_gdfn(x, p.gdfn()).sum(), (x, p.in_w, p.dw2_w)


def _ln_qkv_dwconv(seed):
    p, x = _restormer(seed)
    return KM.ln_qkv_dwconv(x, p.front()).sum(), (x, p.dw_w)


def _attn_core(seed):
    p, x = _restormer(seed)
    qkv = _leaf(np.random.default_rng(seed + 1), 1, H, W, 3 * C)
    gram, ss = KA.attn_acc(qkv, HEADS)
    at = KA.finalize_at(gram, ss, p.temperature, torch.float32)
    out = KA.attn_apply(qkv, x, at, p.proj_w, p.proj_b)
    return out.sum(), (qkv, x, p.proj_w, p.temperature)


def _drs_apply_msfn(seed):
    rng = np.random.default_rng(seed)
    p = _grad_params(drs_params(rng, C, HEADS, 2.66, "WithBias", CPU))
    x, v = _leaf(rng, 1, H, W, C), _leaf(rng, 1, H, W, C)
    atw = _leaf(rng, 1, C, C, scale=0.2)
    return KD.drs_apply_msfn(v, x, atw, p).sum(), (v, x, atw, p.s5_w)


def _mefc_step(seed):
    rng = np.random.default_rng(seed)
    sp = _grad_params(step_params(rng, C, CPU))
    x = _leaf(rng, 1, H, W, C)
    mix = torch.softmax(_leaf(rng, 1, M.NUM_OPS), -1)
    m = M.fold_step(sp, mix, torch.float32)
    return M.mefc_step(x, sp, m).sum(), (x, sp.wcat, sp.sep_dwa[1])


def _ska(seed):
    rng = np.random.default_rng(seed)
    x, w = _leaf(rng, 2, 5, 7, 16), _leaf(rng, 2, 5, 7, 4, 9)
    return KS.ska(x, w).sum(), (x, w)


WRAPPERS = {"block_front": _block_front,
            "block_apply_gdfn": _block_apply_gdfn,
            "fused_ln_gdfn": _fused_ln_gdfn,
            "ln_qkv_dwconv": _ln_qkv_dwconv,
            "attn_acc_attn_apply": _attn_core,
            "drs_apply_msfn": _drs_apply_msfn,
            "mefc_step": _mefc_step,
            "ska": _ska}


@pytest.mark.parametrize("name", list(WRAPPERS))
def test_cpu_wrapper_differentiates(name):
    loss, leaves = WRAPPERS[name](seed=len(name))
    loss.backward()
    for t in leaves:
        assert t.grad is not None and torch.isfinite(t.grad).all()
        assert t.grad.abs().max() > 0


def test_forward_only_backward_raises_and_names_the_kernel():
    x = torch.ones(3, requires_grad=True)
    w = torch.ones(3)
    out = forward_only("some_kernel", (x, None, [w]),
                       lambda: (torch.full((3,), 2.0), torch.zeros(2)))
    assert all(o.requires_grad and o.grad_fn is not None for o in out)
    with pytest.raises(NotImplementedError, match="some_kernel"):
        (out[0].sum() + out[1].sum()).backward()
    assert x.grad is None


def test_forward_only_finds_a_parameter_in_a_nested_list():
    w = torch.ones(3, requires_grad=True)
    out = forward_only("k", (torch.ones(3), [[w], None]),
                       lambda: torch.zeros(3))
    with pytest.raises(NotImplementedError):
        out.sum().backward()


@pytest.mark.parametrize("how", ["no_input_requires_grad", "no_grad",
                                 "inference_mode"])
def test_forward_only_leaves_serving_alone(how):
    made = torch.zeros(3)
    calls = []

    def launch():
        calls.append(1)
        return made

    if how == "no_input_requires_grad":
        out = forward_only("k", (torch.ones(3), None), launch)
    else:
        ctx = torch.no_grad if how == "no_grad" else torch.inference_mode
        with ctx():
            out = forward_only("k", (torch.ones(3, requires_grad=True),),
                               launch)
    assert out is made and not out.requires_grad and calls == [1]
