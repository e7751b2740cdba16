"""SFSNiD's conditioning at its init, the port against the JAX package on
the same weights:

    JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/sfsnid_conditioning.py

Each package can also run wholly in float64 (:func:`jax_float64`,
:func:`port_float64`: their fp32 islands computed in float64 for the
context's duration; neither package is edited), which tells the model
apart from its fp32 rounding.

Printed, at ``MODEL_DEFAULTS`` (num_res 3, base 32) with the seed-0 init
and the seeded 64x64 image of chip_smoke.py phase 3q's card-against-CPU
check (:func:`forward_readings`): the two packages' float64 outputs
against each other, each package's fp32 output against its float64 one,
how far a seeded change of the input of 1e-7 a pixel moves each output in
fp32 and in float64, and the port's fp32 against its float64 after each
stage. Then, of ``tests/test_torch_demo_models.py``'s whole-model
gradient case (``TINY`` at 32x32, :func:`gradient_readings`), the
distances between the four gradients (the input's and every parameter's,
concatenated). Distances are relative L2.
"""

import contextlib
import copy
import re

import jax
import jax.numpy as jnp
import numpy as np
import torch

from image_restoration_tpu.models import demo_models as jd
from image_restoration_tpu.utils.torch_import import import_state_dict
from image_restoration_tpu_torch.cli.train import build_model
from image_restoration_tpu_torch.utils.jax_bridge import state_dict_from_jax
from image_restoration_tpu_torch.utils.options import parse_options

# chip_smoke.py phase 3q: the seed of ``_adaptir_cfg`` and of
# ``_serve_one``'s card-against-CPU input
INIT_SEED, INPUT_SEED = 0, 3520
STAGES = (r"SCM\d|feat_extract\.\d|FeatureMerge\d\.merge|(Encoder|Decoder)\.\d"
          r"|Convs\.\d|ConvsOut\.\d")


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


class _Float64Jnp:
    """``jnp`` with ``float32`` meaning ``float64``: the JAX module's fp32
    islands (``astype(jnp.float32)``, ``preferred_element_type``) in
    float64."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


@contextlib.contextmanager
def jax_float64():
    """JAX's SFSNiD wholly in float64: x64 on and the module's ``jnp``
    replaced; feed it float64 parameters and inputs."""
    saved = jd.jnp
    jd.jnp = _Float64Jnp()
    try:
        with jax.enable_x64(True):
            yield
    finally:
        jd.jnp = saved


@contextlib.contextmanager
def port_float64():
    """The port's fp32 islands (``Tensor.float``) in float64, so that a
    model cast with ``.double()`` computes wholly in float64."""
    saved = torch.Tensor.float
    torch.Tensor.float = lambda self, *a, **k: self.double()
    try:
        yield
    finally:
        torch.Tensor.float = saved


def _executable(fn, *args):
    from moe_parity import FAST

    return jax.jit(fn).lower(*args).compile(FAST)


def full_width_pair():
    """(port fp32 model, JAX module, its parameters carried from the port
    by the JAX package's torch importer, (1, 3, 64, 64) input) at
    ``MODEL_DEFAULTS``."""
    from moe_parity import traced_shapes

    cfg = parse_options(["--model", "sfsnid", "--device", "cpu", "--seed",
                         str(INIT_SEED)])
    model = build_model(dict(cfg, bf16=False), device="cpu").eval()
    x = torch.rand((1, 3, 64, 64),
                   generator=torch.Generator().manual_seed(INPUT_SEED))
    jnet = jd.SFSNiD(**cfg["model_kwargs"])
    shapes = traced_shapes(jnet, jnp.zeros((1, 64, 64, 3)))["params"]
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    params = import_state_dict(zeros, model.state_dict(),
                               key_map=jd.sfsnid_key_map)
    return model, jnet, jax.tree.map(np.asarray, params), x


def _run(model, x, stages):
    """(``model(x)`` NHWC in numpy, {stage: its output} when ``stages``)."""
    got = {}
    hooks = [mod.register_forward_hook(
        lambda m, i, o, n=name: got.__setitem__(n, o.double().numpy()))
        for name, mod in model.named_modules()
        if stages and re.fullmatch(STAGES, name)]
    try:
        out = model(x)
    finally:
        for h in hooks:
            h.remove()
    return out.permute(0, 2, 3, 1).numpy(), got


def forward_readings(moves=True):
    """The readings at full width (the module docstring's); without
    ``moves``, only the four outputs' distances."""
    model, jnet, params, x = full_width_pair()
    dx = 1e-7 * torch.randn(x.shape,
                            generator=torch.Generator().manual_seed(1))
    inputs = [x, x + dx] if moves else [x]
    out = {}

    def apply(p, a):
        return jnet.apply({"params": p}, a, train=False)

    with jax.default_matmul_precision("highest"):
        xs = [a.permute(0, 2, 3, 1).numpy() for a in inputs]
        run = _executable(apply, params, xs[0])
        j32 = [np.asarray(run(params, a)) for a in xs]
        with jax_float64():
            p64 = jax.tree.map(lambda a: a.astype(np.float64), params)
            x64 = [a.astype(np.float64) for a in xs]
            run = _executable(apply, p64, x64[0])
            j64 = [np.asarray(run(p64, a)) for a in x64]
    model64 = copy.deepcopy(model).double()
    with torch.inference_mode():
        t32, stages32 = zip(*(_run(model, a, moves) for a in inputs))
        with port_float64():
            t64, stages64 = zip(*(_run(model64, a.double(), moves)
                                  for a in inputs))
    out["port float64 against JAX float64"] = rel(t64[0], j64[0])
    out["JAX fp32 against JAX float64"] = rel(j32[0], j64[0])
    out["port fp32 against port float64"] = rel(t32[0], t64[0])
    out["port fp32 against JAX fp32"] = rel(t32[0], j32[0])
    if moves:
        for tag, pair in (("JAX fp32", j32), ("JAX float64", j64),
                          ("port fp32", t32), ("port float64", t64)):
            out[f"{tag} moved by the 1e-7 change"] = rel(pair[1], pair[0])
        for name, got in stages32[0].items():
            out[f"port fp32 against float64 after {name}"] = rel(
                got, stages64[0][name])
    return out


def gradient_readings():
    """d(sum(full output * g))/d(input, every parameter) of SFSNiD at
    ``TINY`` on 32x32 (``tests/test_torch_demo_models.py``'s seeded
    weights, input and cotangent) in both packages, fp32 and float64:
    the four flattened gradients (JAX's in the port's parameter order)."""
    import test_torch_demo_models as T
    from family_parity import nchw, nhwc, randomized
    from moe_parity import traced_shapes

    _, x, _ = T._jax_sfsnid()
    rng = np.random.default_rng(16)
    params = randomized(traced_shapes(
        jd.SFSNiD(**T.TINY), jnp.asarray(x))["params"], rng)
    g = rng.standard_normal(x.shape)
    jnet = jd.SFSNiD(**T.TINY)

    def loss(p, a, c):
        return jnp.sum(jnet.apply({"params": p}, a) * c)

    grad = jax.grad(loss, argnums=(0, 1))
    with jax.default_matmul_precision("highest"):
        args = (params, x, g.astype(np.float32))
        jgp32, jgx32 = _executable(grad, *args)(*args)
        with jax_float64():
            args = jax.tree.map(lambda a: np.asarray(a, np.float64),
                                (params, x, g))
            jgp64, jgx64 = _executable(grad, *args)(*args)
    model = T._port_sfsnid(params)
    like = {k: v.double() for k, v in model.state_dict().items()}
    names = [k for k, _ in model.named_parameters()]

    def jax_flat(gx, gp):
        sd = state_dict_from_jax(jax.tree.map(
            lambda a: np.array(a, np.float64), gp), like, T.KM)
        return np.concatenate([np.ravel(gx)] + [
            sd[k].numpy().ravel() for k in names])

    def port_flat(m, dtype):
        m.zero_grad(set_to_none=True)
        xt = nchw(x).to(dtype).requires_grad_(True)
        (m(xt) * nchw(g).to(dtype)).sum().backward()
        return np.concatenate([np.ravel(nhwc(xt.grad))] + [
            p.grad.double().numpy().ravel() if p.grad is not None else
            np.zeros(p.numel()) for _, p in m.named_parameters()])

    t32 = port_flat(model, torch.float32)
    with port_float64():
        t64 = port_flat(model.double(), torch.float64)
    return {"jax32": jax_flat(jgx32, jgp32), "jax64": jax_flat(jgx64, jgp64),
            "port32": t32, "port64": t64}


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    print("SFSNiD at MODEL_DEFAULTS (num_res 3, base 32), seed-0 init, "
          "chip_smoke.py phase 3q's 64x64 input, CPU:")
    for key, value in forward_readings().items():
        print(f"  {key}: {value:.4e}")
    grads = gradient_readings()
    print("Whole-model gradients, TINY at 32x32 "
          "(test_sfsnid_gradients_match_jax's case), CPU:")
    for a, b in (("port64", "jax64"), ("jax32", "jax64"),
                 ("port32", "jax64"), ("port32", "jax32")):
        print(f"  {a} against {b}: {rel(grads[a], grads[b]):.4e}")


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    main()
