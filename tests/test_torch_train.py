"""The port's training runtime against the JAX package's, end to end, on
the CPU in fp32 (JAX at "highest" matmul precision).

* ``train/trainer.py`` ``make_train_step`` against JAX's on a small
  Restormer (dim 16, blocks 1/1/1/1, 1 refinement block), plain and with
  ``fused_block`` (the port's autograd Function over the plain passes; JAX's
  custom VJP over ``_reference_block``), from the same parameters (moved by
  ``utils/jax_bridge.py`` ``state_dict_from_jax``) and the same batches:
  the loss of every step, the gradients of the first (each step's own,
  from Adam's first moment (1 - b1) g; JAX's tree through the same
  bridge), and the parameters and EMA after 1 and 3 steps, at rtol 1e-4 and atol 1e-5 (gradients at atol 1e-5 x the largest
  |gradient| of the tensor: sums over the batch's pixels in another
  order). AdamW with weight decay, a warm-up whose first rate is 0, EMA
  0.9.
* ``cli/train.py`` ``main`` on a seeded tree as tests/test_cli_end2end.py
  drives the JAX CLI: 4 steps, ``config.yaml``, ``metrics.jsonl``, the
  checkpoints, validation and ``best``; resume 2 + 2 reaches step 4 and
  restores the saved parameters, optimizer state and EMA exactly; the
  final checkpoint scores through the port's ``cli/test.py --ckpt`` and,
  through the JAX package's ``utils/torch_import``, restores an image in
  the JAX model equal to the port model's.
* What is not ported raises: no device without a GPU, ``--mesh``, MEASNet
  (which the JAX CLI cannot train either); MoCE-IR takes a step through
  ``main`` and logs its balance loss.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from image_restoration_tpu.models import get_model as jax_get_model
from image_restoration_tpu.train import schedulers as JS
from image_restoration_tpu.train import trainer as JT
from image_restoration_tpu.utils import torch_import as JI
from image_restoration_tpu_torch.cli import train as train_cli
from image_restoration_tpu_torch.models import get_model
from image_restoration_tpu_torch.train import schedulers as TS
from image_restoration_tpu_torch.train import trainer as TT
from image_restoration_tpu_torch.train.checkpoint import CheckpointManager
from image_restoration_tpu_torch.utils.jax_bridge import state_dict_from_jax

RTOL, ATOL = 1e-4, 1e-5
SMALL = dict(dim=16, num_blocks=(1, 1, 1, 1), num_refinement_blocks=1,
             heads=(1, 2, 4, 8))
SMALL_ARGS = ["--set", "model_kwargs.dim=16",
              "--set", "model_kwargs.num_blocks=(1,1,1,1)",
              "--set", "model_kwargs.num_refinement_blocks=1"]


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _pair(fused):
    """The JAX model with seeded parameters and the port model with the
    same, through the bridge."""
    jm = jax_get_model("restormer", fused_block=fused, **SMALL)
    x = jnp.zeros((1, 16, 16, 3), jnp.float32)
    shapes = jm.init(jax.random.PRNGKey(0), x)["params"]
    rng = np.random.default_rng(3)
    params = jax.tree.map(
        lambda a: jnp.asarray(
            (1.0 if a.ndim == 1 and a.shape[0] > 8 else 0.0)
            + rng.standard_normal(a.shape) * (0.1 if a.ndim == 1 else 0.2),
            jnp.float32), shapes)
    tm = get_model("restormer", fused_block=fused, **SMALL)
    tm.load_state_dict(state_dict_from_jax(params, tm.state_dict()))
    return jm, params, tm


def _assert_tree(tm_sd, jtree, like, scaled=False):
    want = state_dict_from_jax(jtree, like)
    for k, w in want.items():
        got = tm_sd[k].detach()
        atol = ATOL * float(w.abs().max()) if scaled else ATOL
        np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=RTOL,
                                   atol=atol, err_msg=k)


def _adam_mu(jstate):
    """The first moment in the JAX step's optax state."""
    todo = [jstate.opt_state]
    while todo:
        node = todo.pop()
        if hasattr(node, "mu"):
            return node.mu
        if isinstance(node, tuple):
            todo.extend(node)
    raise AssertionError("no Adam state")


@pytest.mark.parametrize("fused", [False, True])
def test_train_step_matches_jax(fused):
    jm, params, tm = _pair(fused)
    kw = dict(weight_decay=0.01, ema_decay=0.9, loss={"l1": 1.0},
              optimizer="adamw")
    jcfg = JT.TrainerConfig(
        learning_rate=JS.linear_warmup_cosine(2e-3, 2, 10), **kw)
    tcfg = TT.TrainerConfig(
        learning_rate=TS.linear_warmup_cosine(2e-3, 2, 10), **kw)
    jtx, ttx = JT.make_optimizer(jcfg), TT.make_optimizer(tcfg)
    jstate = JT.TrainState.create(params, jtx, ema_decay=0.9)
    tstate = TT.TrainState.create(tm, ttx, ema_decay=0.9)
    jstep = JT.make_train_step(jm, jtx, jcfg, donate=False)
    tstep = TT.make_train_step(tm, ttx, tcfg)
    like = tm.state_dict()
    rng = np.random.default_rng(5)
    with jax.default_matmul_precision("highest"):
        for i in range(3):
            gt = rng.random((2, 16, 16, 3)).astype(np.float32)
            lq = np.clip(gt + 0.1 * rng.standard_normal(gt.shape), 0, 1)
            lq = lq.astype(np.float32)
            jb = {"lq": jnp.asarray(lq), "gt": jnp.asarray(gt)}
            tb = {"lq": _nchw(lq), "gt": _nchw(gt)}
            jstate, jlogs = jstep(jstate, jb, None)
            tstate, tlogs = tstep(tstate, tb)
            np.testing.assert_allclose(float(tlogs["total"]),
                                       float(jlogs["total"]), rtol=RTOL,
                                       atol=ATOL)
            if i == 0:
                # the step's gradient, from Adam's first moment (1 - b1) g
                _assert_tree({k: m / 0.1 for k, m in
                              tstate.opt_state["mu"].items()},
                             jax.tree.map(lambda m: m / 0.1, _adam_mu(jstate)),
                             like, scaled=True)
            if i in (0, 2):
                _assert_tree(dict(tm.named_parameters()), jstate.params, like)
                _assert_tree(tstate.ema_params, jstate.ema_params, like)
    assert tstate.step == 3 and tstate.opt_state["count"] == 3


# ------------------------------------------------------------------ CLI ---

def _save(path, arr):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(arr.astype(np.uint8)).save(path)


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """Seeded five-task AIO tree, a validation pair folder and a
    Rain100L-shaped benchmark."""
    root = str(tmp_path_factory.mktemp("aio"))
    rng = np.random.default_rng(0)
    for i in range(3):
        clean = (rng.random((48, 40, 3)) * 255).astype(np.uint8)
        noisy = np.clip(clean + rng.integers(-30, 30, clean.shape), 0, 255)
        _save(f"{root}/denoising/{i}.png", clean)
        _save(f"{root}/deraining/RainTrainL/gt/norain-{i}.png", clean)
        _save(f"{root}/deraining/RainTrainL/rainy/norain-{i}.png", noisy)
        _save(f"{root}/dehazing/RESIDE/clear/{i}.png", clean)
        _save(f"{root}/dehazing/RESIDE/part1/{i}_0.8_0.1.png",
              clean * 0.7 + 50)
    for i in range(2):
        clean = (rng.random((32, 40, 3)) * 255).astype(np.uint8)
        noisy = np.clip(clean + rng.integers(-30, 30, clean.shape), 0, 255)
        _save(f"{root}/deraining/Rain100L/target/{i}.png", clean)
        _save(f"{root}/deraining/Rain100L/input/{i}.png", noisy)
    return root


def _argv(root, exp, *extra):
    return ["--device", "cpu", "--model", "restormer",
            "--data_file_dir", root, "--patch_size", "32",
            "--batch_size", "2", "--lr", "1e-3", "--warmup_epochs", "0",
            "--ckpt_dir", exp, "--name", "t", "--save_every", "2",
            "--log_every", "1", "--ema_decay", "0.999", "--num_workers", "2",
            "--fp32", *SMALL_ARGS, *extra]


def test_cli_trains_validates_and_saves(data_root, tmp_path):
    val = ["--val_every", "2",
           "--val_lq_dir", f"{data_root}/deraining/Rain100L/input",
           "--val_gt_dir", f"{data_root}/deraining/Rain100L/target"]
    state = train_cli.main(_argv(data_root, str(tmp_path), *val),
                           max_steps_override=4)
    exp = tmp_path / "t"
    assert state.step == 4 and state.model.training
    cfg = (exp / "config.yaml").read_text()
    assert "de_type" in cfg and "ema_decay" in cfg
    logged = [json.loads(line) for line in open(exp / "metrics.jsonl")]
    train = [e for e in logged if "train/total" in e]
    assert [e["step"] for e in train] == [0, 1, 2, 3]
    assert all(np.isfinite(e["train/total"]) for e in train)
    assert any("val/psnr" in e for e in logged)
    assert CheckpointManager(str(exp / "ckpt")).steps() == [2, 4]
    step, psnr = (exp / "ckpt" / "best").read_text().split()
    assert int(step) in (2, 4) and 5 < float(psnr) < 60


def test_cli_resume_restores_exactly(data_root, tmp_path):
    first = train_cli.main(_argv(data_root, str(tmp_path)),
                           max_steps_override=2)
    saved = {k: v.clone() for k, v in first.model.state_dict().items()}
    ema = {k: v.clone() for k, v in first.ema_params.items()}
    mu = {k: v.clone() for k, v in first.opt_state["mu"].items()}

    # restore alone: the newest step, every tensor as it was saved
    fresh = train_cli.build_model(
        {"model": "restormer", "bf16": False, "device": "cpu",
         "model_kwargs": dict(SMALL, fused_block=True)})
    tx = TT.make_optimizer(TT.TrainerConfig())
    state, step = CheckpointManager(str(tmp_path / "t" / "ckpt")).restore(
        TT.TrainState.create(fresh, tx, ema_decay=0.999))
    assert step == 2 and state.step == 2 and state.opt_state["count"] == 2
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, saved[k]), k
    for k, v in state.ema_params.items():
        assert torch.equal(v, ema[k]), k
    for k, v in state.opt_state["mu"].items():
        assert torch.equal(v, mu[k]), k

    resumed = train_cli.main(_argv(data_root, str(tmp_path), "--resume"),
                             max_steps_override=4)
    assert resumed.step == 4 and resumed.opt_state["count"] == 4
    logged = [json.loads(line) for line in open(tmp_path / "t" / "metrics.jsonl")]
    assert [e["step"] for e in logged if "train/total" in e] == [0, 1, 2, 3]


def test_checkpoint_scores_in_both_packages(data_root, tmp_path):
    from image_restoration_tpu_torch.cli import test as test_cli

    state = train_cli.main(_argv(data_root, str(tmp_path)),
                           max_steps_override=2)
    ckpt = str(tmp_path / "t" / "ckpt" / "2.pth")
    out_dir = str(tmp_path / "results")
    results = test_cli.main(["--device", "cpu", "--model", "restormer",
                             "--fp32", "--ckpt", ckpt, "--prefer_ema",
                             "--data_file_dir", data_root, "--benchmarks",
                             "derain", "--output_dir", out_dir, *SMALL_ARGS])
    assert results["derain"]["n"] == 2
    assert np.isfinite(results["derain"]["psnr"])

    # the JAX model imports the same .pth (its EMA parameters)
    jm = jax_get_model("restormer", fused_block=True, **SMALL)
    template = jm.init(jax.random.PRNGKey(0),
                       jnp.zeros((1, 16, 16, 3)))["params"]
    sd = JI.load_torch_checkpoint(ckpt, prefer_ema=True)
    jparams = JI.import_state_dict(template, sd)
    img = np.random.default_rng(1).random((1, 32, 24, 3)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(jm.apply)({"params": jparams},
                                            jnp.asarray(img)))
    model = state.model.eval()
    with torch.no_grad():
        got = torch.func.functional_call(model, state.ema_params,
                                         (_nchw(img),))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=RTOL, atol=ATOL)


def test_what_is_not_ported_raises(data_root, tmp_path, monkeypatch):
    argv = _argv(data_root, str(tmp_path))
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        train_cli.main(argv + ["--mesh", "2"], max_steps_override=1)
    with pytest.raises(NotImplementedError, match="keeps no batch_stats"):
        train_cli.main(argv + ["--model", "measnet"], max_steps_override=1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    no_device = [a for a in argv if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="--device cpu"):
        train_cli.main(no_device, max_steps_override=1)


def test_moce_ir_trains_through_main(data_root, tmp_path):
    """MoCE-IR (its serving defaults, narrowed) takes a CPU step through
    ``main`` with its routing noise and logs the balance loss."""
    argv = _argv(data_root, str(tmp_path), "--model", "moce_ir",
                 "--set", "model_kwargs.num_dec_blocks=(1,1,1)")
    state = train_cli.main(argv, max_steps_override=1)
    assert state.step == 1
    logged = [json.loads(line) for line in open(tmp_path / "t" /
                                                "metrics.jsonl")]
    aux = [e["train/aux"] for e in logged if "train/aux" in e]
    assert len(aux) == 1 and np.isfinite(aux[0]) and aux[0] > 0
    assert np.isfinite(logged[0]["train/total"])


def test_config_yaml_flags_win_and_pyyaml_is_needed(tmp_path, monkeypatch):
    from image_restoration_tpu_torch.utils import options as O

    path = tmp_path / "run.yaml"
    path.write_text("lr: 5.0e-4\nbatch_size: 4\nloss: [l1=1.0, fft=0.1]\n"
                    "model_kwargs: {dim: 16}\n")
    parser = O.build_train_parser()
    cfg = O.parse_options(["--config", str(path), "--batch_size", "2"],
                          parser)
    assert cfg["lr"] == 5e-4 and cfg["batch_size"] == 2
    assert cfg["loss"] == {"l1": 1.0, "fft": 0.1}
    assert cfg["model_kwargs"]["dim"] == 16
    assert cfg["model_kwargs"]["fused_block"] is True  # the port default
    monkeypatch.setattr(O, "yaml", None)
    with pytest.raises(RuntimeError, match="pyyaml"):
        O.parse_options(["--config", str(path)], parser)
    O.dump_effective_config(cfg, str(tmp_path / "c.yaml"))
    assert (tmp_path / "c.yaml").read_text() == repr(cfg)


def test_logging_matches_jax(tmp_path):
    from image_restoration_tpu.utils import logging as JL
    from image_restoration_tpu_torch.utils import logging as TL

    jm = jax_get_model("restormer", **SMALL)
    params = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 16, 16, 3)))["params"]
    tm = get_model("restormer", **SMALL)
    assert TL.count_params(tm) == JL.count_params(params)

    def rows(text):  # (count, MB) per row; names differ by wrapper levels
        # (JAX's ``output/conv`` is the port's ``output``)
        return sorted(tuple(line.split()[-2:]) for line in text.splitlines()[1:])

    assert rows(TL.model_summary(tm)) == rows(JL.model_summary(params))
    logs = {"l1": torch.tensor(0.25), "total": 0.5}
    for mod, sub in ((JL, "jax"), (TL, "port")):
        logger = mod.MessageLogger(str(tmp_path / sub), total_steps=10)
        logger.log(3, logs)
        logger.log(3, {"psnr": 21.5}, prefix="val")
    lines = [(tmp_path / sub / "metrics.jsonl").read_text()
             for sub in ("jax", "port")]
    assert lines[0] == lines[1]
