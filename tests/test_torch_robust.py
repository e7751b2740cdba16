"""The port's classification robustness protocol (eval/robustness.py,
cli/robust.py) against the JAX package's, and the entry points' device
rule.

* ``get_mce_from_accuracy``, ``subset_logit_mask`` and
  ``masked_topk_hits`` against the JAX functions on the same numbers
  (exact: the same arithmetic on the same inputs).
* ``evaluate_folder`` on a tiny ImageFolder written with PIL (3 classes,
  odd image sizes so both the resize and the crop run), the same small
  LSNet in both packages, fp32: the same hit counts, with and without a
  subset mask. ``imagenet_c_eval`` on a two-corruption tree: the same
  accuracies and CEs.
* ``cli/robust.py --device cpu`` end to end writes its JSON; with
  ``--adv FGSM`` and ``--adv PGD`` (the pair's weights through ``--ckpt``)
  it scores the attacked images as JAX's ``evaluate_folder(..., adv=)``
  does: the same hit counts. The attack differentiates every SKA through
  ``kernels/ska.py`` ``_SKA``; PGD starts from the port's seeded draw and
  JAX's ``PRNGKey(0)`` draw, each within the 1/255 ball.
* Entry points run on the GPU unless ``--device cpu`` is given: without a
  GPU, ``build_model`` raises and names ``--device cpu``.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_tpu.eval import robustness as JR
from image_restoration_tpu.models import lsnet as JL
from image_restoration_tpu_torch.cli import robust as cli_robust
from image_restoration_tpu_torch.cli.train import build_model
from image_restoration_tpu_torch.eval import robustness as TR
from image_restoration_tpu_torch.models import get_model
from image_restoration_tpu_torch.models.lsnet import lsnet_key_map
from image_restoration_tpu_torch.utils.jax_bridge import state_dict_from_jax
from image_restoration_tpu_torch.utils.options import parse_options

Image = pytest.importorskip("PIL.Image")

TINY = dict(img_size=32, patch_size=8, num_classes=5,
            embed_dim=(16, 32, 48, 64), key_dim=(8, 8, 8, 8),
            depth=(1, 2, 2, 2), num_heads=(2, 2, 2, 2))
TINY_SET = ["--set", "model_kwargs.img_size=32",
            "--set", "model_kwargs.num_classes=5",
            "--set", "model_kwargs.embed_dim=(16,32,48,64)",
            "--set", "model_kwargs.key_dim=(8,8,8,8)",
            "--set", "model_kwargs.depth=(1,2,2,2)",
            "--set", "model_kwargs.num_heads=(2,2,2,2)"]


def _write_tree(root, rng, classes=("n01", "n02", "n03"), n=3):
    for c in classes:
        os.makedirs(os.path.join(root, c), exist_ok=True)
        for i in range(n):
            h, w = rng.integers(24, 48, 2)
            arr = rng.integers(0, 255, (h, w, 3)).astype(np.uint8)
            Image.fromarray(arr).save(os.path.join(root, c, f"{i}.png"))


@pytest.fixture(scope="module")
def pair():
    """The tiny LSNet in both packages, same weights (fp32, eval)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    jnet = JL.LSNet(**TINY)
    x = jnp.zeros((1, 32, 32, 3))
    # compiled: op by op, the init takes most of this file's time
    variables = jax.jit(jnet.init)(jax.random.PRNGKey(0), x)
    rng = np.random.default_rng(0)
    variables = jax.tree.map(
        lambda a: (np.asarray(a) + 0.1 * rng.standard_normal(a.shape))
        .astype(np.float32), variables)
    tnet = get_model("lsnet", **TINY, use_pallas_ska=True).eval()
    tnet.load_state_dict(state_dict_from_jax(
        variables["params"], tnet.state_dict(), lsnet_key_map,
        variables["batch_stats"]), strict=True)

    def apply_fn(v, imgs):
        with jax.default_matmul_precision("highest"):
            return jnet.apply(v, imgs)

    return apply_fn, variables, tnet


def test_mce_and_subset_mask_match_jax():
    for name, err in JR.CE_ALEXNET.items():
        for acc in (0.0, 37.5, 100.0 - 100.0 * err, 100.0):
            assert TR.get_mce_from_accuracy(acc, err) == \
                JR.get_mce_from_accuracy(acc, err)
    assert TR.CE_ALEXNET == JR.CE_ALEXNET
    assert TR.CORRUPTIONS == JR.CORRUPTIONS
    np.testing.assert_array_equal(TR.IMAGENET_MEAN, JR.IMAGENET_MEAN)
    np.testing.assert_array_equal(TR.IMAGENET_STD, JR.IMAGENET_STD)
    wnids = [f"n{i:03d}" for i in range(12)]
    np.testing.assert_array_equal(
        TR.subset_logit_mask(wnids, wnids[3:9:2]),
        JR.subset_logit_mask(wnids, wnids[3:9:2]))


@pytest.mark.parametrize("masked", [False, True])
def test_masked_topk_hits_matches_jax(masked):
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((16, 12)).astype(np.float32)
    mask = (rng.random(12) < 0.5) if masked else None
    n = int(mask.sum()) if masked else 12
    labels = rng.integers(0, n, 16)
    want = JR.masked_topk_hits(jnp.asarray(logits), jnp.asarray(labels), mask)
    got = TR.masked_topk_hits(torch.from_numpy(logits),
                              torch.from_numpy(labels), mask)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("masked", [False, True])
def test_evaluate_folder_matches_jax(pair, tmp_path, masked):
    apply_fn, variables, tnet = pair
    _write_tree(str(tmp_path), np.random.default_rng(2))
    mask = np.array([True, False, True, True, False]) if masked else None
    kw = dict(batch_size=4, input_size=32, mask=mask)
    want = JR.evaluate_folder(apply_fn, variables, str(tmp_path), **kw)
    got = TR.evaluate_folder(tnet, str(tmp_path), **kw)
    assert got == want and got["n"] == 9


def test_imagenet_c_eval_matches_jax(pair, tmp_path):
    apply_fn, variables, tnet = pair
    rng = np.random.default_rng(3)
    cors = {"Fog": "fog", "Snow": "snow"}
    for folder in cors.values():
        for s in (1, 2):
            _write_tree(str(tmp_path / folder / str(s)), rng, n=2)
    kw = dict(batch_size=4, input_size=32, severities=(1, 2),
              corruptions=cors, log=lambda _: None)
    want = JR.imagenet_c_eval(apply_fn, variables, str(tmp_path), **kw)
    got = TR.imagenet_c_eval(tnet, str(tmp_path), **kw)
    assert got == want


def test_cli_end_to_end_and_adv_refusal(pair, tmp_path):
    """The CLI end to end, and ``--adv``, once refused, now scoring the
    attacked images as the JAX CLI does."""
    _write_tree(str(tmp_path / "a"), np.random.default_rng(4),
                classes=("n01498041", "n01531178", "n99999999"), n=2)
    _write_tree(str(tmp_path / "sk"), np.random.default_rng(5), n=2)
    out = tmp_path / "r.json"
    argv = TINY_SET + ["--device", "cpu", "--batch_size", "4",
                       "--input_size", "32"]
    res = cli_robust.main(argv + ["--ina_path", str(tmp_path / "a"),
                                  "--insk_path", str(tmp_path / "sk"),
                                  "--out_json", str(out)])
    assert res["imagenet_a"]["n"] == 6 and res["imagenet_sketch"]["n"] == 6
    assert json.loads(out.read_text()) == res

    apply_fn, variables, tnet = pair
    ckpt = tmp_path / "lsnet.pth"
    torch.save(tnet.state_dict(), ckpt)
    sk = str(tmp_path / "sk")
    for adv in ("FGSM", "PGD"):
        got = cli_robust.main(argv + ["--insk_path", sk, "--ckpt", str(ckpt),
                                      "--adv", adv])["imagenet_sketch"]
        want = JR.evaluate_folder(apply_fn, variables, sk, batch_size=4,
                                  input_size=32, adv=adv)
        assert got == want and got["n"] == 6, adv


def test_entry_points_need_a_gpu_or_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        build_model(parse_options(["--model", "lsnet"]))
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli_robust.main(TINY_SET)
    model = build_model(parse_options(["--model", "lsnet", "--device", "cpu"]))
    assert next(model.parameters()).device.type == "cpu"
