"""Training through the kernel APIs' VJPs, and the kernel flags
``cli/train.py`` ``build_model`` resolves, on the CPU in fp32.

* The three-kernel Restormer (``fused_attn`` + ``fused_gdfn``: K4, K5/K6,
  K3 on the card) takes the train step ``cli/train.py`` runs
  (``train/trainer.py`` ``make_train_step``) against the JAX step of the
  JAX Restormer with the same flags, whose custom VJPs differentiate the
  same compositions: dim 16, blocks 1/1/1/1, 1 refinement block, the same
  parameters (through ``utils/jax_bridge.py``) and batch. The loss, and
  the step's gradient (Adam's first moment over 1 - b1, as
  tests/test_torch_train.py reads it) at rtol 1e-4 and atol 1e-5 x the
  largest |gradient| of the tensor.
* DRSformer with ``fused_block`` (K1 + K7 per block, K8 per MEFC step on
  the card) against the same model plain: its gradients equal the plain
  model's at the same tolerance. The JAX side of DRSformer's step does not
  fit this file's time budget (its train step compiles for minutes on the
  CPU); tests/test_torch_vjp.py holds the block's and the steps' VJPs to
  the JAX custom VJPs instead.
* ``build_model`` turns off a kernel flag the model cannot run on and
  prints why: every flag with ``--fp32`` (the kernels take bf16), and the
  flag whose kernels do not take a block's head width at
  ``model_kwargs.dim=24`` with heads (1, 2, 4, 8) (tools/learn_run.py's
  configuration), for Restormer and DRSformer; the three-kernel flags at
  width 80 in one head (K5/K6 are built for head widths 16-128, not 80).
  Where every block fits, the flags stay.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train import SMALL, _adam_mu, _assert_tree, _nchw

from image_restoration_tpu.models import get_model as jax_get_model
from image_restoration_tpu.train import schedulers as JS
from image_restoration_tpu.train import trainer as JT
from image_restoration_tpu_torch.cli.train import build_model
from image_restoration_tpu_torch.models import get_model
from image_restoration_tpu_torch.train import schedulers as TS
from image_restoration_tpu_torch.train import trainer as TT
from image_restoration_tpu_torch.utils.jax_bridge import state_dict_from_jax
from image_restoration_tpu_torch.utils.options import parse_options

THREE = dict(fused_attn=True, fused_gdfn=True)


def test_three_kernel_restormer_step_matches_jax():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    jm = jax_get_model("restormer", **SMALL, **THREE)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 16, 16, 3), jnp.float32))["params"]
    rng = np.random.default_rng(3)
    params = jax.tree.map(
        lambda a: jnp.asarray(
            (1.0 if a.ndim == 1 and a.shape[0] > 8 else 0.0)
            + rng.standard_normal(a.shape) * (0.1 if a.ndim == 1 else 0.2),
            jnp.float32), shapes)
    tm = get_model("restormer", **SMALL, **THREE)
    like = tm.state_dict()
    tm.load_state_dict(state_dict_from_jax(params, like))

    kw = dict(loss={"l1": 1.0}, optimizer="adamw")
    jcfg = JT.TrainerConfig(learning_rate=JS.linear_warmup_cosine(2e-3, 2, 10),
                            **kw)
    tcfg = TT.TrainerConfig(learning_rate=TS.linear_warmup_cosine(2e-3, 2, 10),
                            **kw)
    jtx, ttx = JT.make_optimizer(jcfg), TT.make_optimizer(tcfg)
    jstate = JT.TrainState.create(params, jtx)
    tstate = TT.TrainState.create(tm, ttx)
    assert {"_LnQkvDwconvBackward", "_MdtaCoreBackward",
            "_LnGdfnBackward"} <= _grad_fns(tm(torch.zeros(1, 3, 16, 16)))
    gt = rng.random((2, 16, 16, 3)).astype(np.float32)
    lq = np.clip(gt + 0.1 * rng.standard_normal(gt.shape), 0, 1)
    lq = lq.astype(np.float32)
    with jax.default_matmul_precision("highest"):
        jstate, jlogs = JT.make_train_step(jm, jtx, jcfg, donate=False)(
            jstate, {"lq": jnp.asarray(lq), "gt": jnp.asarray(gt)}, None)
    tstate, tlogs = TT.make_train_step(tm, ttx, tcfg)(
        tstate, {"lq": _nchw(lq), "gt": _nchw(gt)})
    np.testing.assert_allclose(float(tlogs["total"]), float(jlogs["total"]),
                               rtol=1e-4, atol=1e-5)
    _assert_tree({k: m / 0.1 for k, m in tstate.opt_state["mu"].items()},
                 jax.tree.map(lambda m: m / 0.1, _adam_mu(jstate)), like,
                 scaled=True)


def _grad_fns(out):
    """The names of the nodes in ``out``'s graph."""
    seen, todo, names = set(), [out.grad_fn], set()
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.add(type(fn).__name__)
        todo.extend(f for f, _ in fn.next_functions)
    return names


def test_drsformer_fused_grads_equal_the_plain_models():
    small = dict(dim=16, num_blocks=(1, 1, 1, 1), heads=(1, 2, 4, 8))
    x = torch.from_numpy(np.random.default_rng(0).random(
        (2, 3, 16, 16)).astype(np.float32))
    grads = []
    for fused in (True, False):
        torch.manual_seed(0)
        model = get_model("drsformer", **small, fused_block=fused)
        out = model(x)
        if fused:
            assert {"_DRSBlockBackward", "_MEFCStepsBackward"} <= \
                _grad_fns(out)
        params = dict(model.named_parameters())
        g = torch.autograd.grad((out * out).mean(), list(params.values()),
                                allow_unused=True)
        grads.append(dict(zip(params, g)))
    for k, want in grads[1].items():
        got = grads[0][k]
        assert (got is None) == (want is None), k
        if want is not None:
            np.testing.assert_allclose(
                got.numpy(), want.numpy(), rtol=1e-4,
                atol=1e-5 * float(want.abs().max()), err_msg=k)


def _flags(model):
    """The kernel flags of the model's blocks, as a set of (flag, value)."""
    return {(f, getattr(m, f)) for m in model.modules()
            for f in ("fused_block", "fused_attn", "fused_gdfn", "fused")
            if isinstance(getattr(m, f, None), bool)}


@pytest.mark.parametrize("model", ["restormer", "drsformer"])
def test_build_model_drops_the_kernel_flags_fp32_and_width_24_rule_out(
        capsys, model):
    small = ["--model", model, "--device", "cpu",
             "--set", "model_kwargs.num_blocks=(1,1,1,1)"]
    fits = build_model(parse_options(small))
    assert capsys.readouterr().out == ""
    assert ("fused_block", True) in _flags(fits)
    assert ("fused_block", False) not in _flags(fits)
    assert model == "restormer" or ("fused", True) in _flags(fits)

    for extra, why in ((["--fp32"], "float32 and the kernels take bfloat16"),
                       (["--set", "model_kwargs.dim=24",
                         "--set", "model_kwargs.heads=(1,2,4,8)"],
                        "C 24 in 1 heads of 24" if model == "restormer"
                        else "MEFC Subnet is 24 wide")):
        built = build_model(parse_options(small + extra))
        said = capsys.readouterr().out
        assert said.count("\n") == 1 and said.startswith(
            "build_model: fused_block off: ") and why in said, said
        assert ("fused_block", True) not in _flags(built)
        assert ("fused", True) not in _flags(built)


def test_build_model_drops_what_the_three_kernel_block_does_not_take(capsys):
    base = ["--device", "cpu", "--set", "model_kwargs.num_blocks=(1,1,1,1)",
            "--set", "model_kwargs.fused_block=False",
            "--set", "model_kwargs.fused_attn=True",
            "--set", "model_kwargs.fused_gdfn=True"]
    built = build_model(parse_options(base))
    assert capsys.readouterr().out == ""
    assert ("fused_attn", True) in _flags(built)
    built = build_model(parse_options(
        base + ["--set", "model_kwargs.dim=80",
                "--set", "model_kwargs.heads=(1,1,1,1)"]))
    said = capsys.readouterr().out.splitlines()
    assert len(said) == 1 and said[0].startswith(
        "build_model: fused_attn off: a block has C 80 in 1 heads of 80")
    assert _flags(built) == {("fused_block", False), ("fused_attn", False),
                             ("fused_gdfn", True)}
