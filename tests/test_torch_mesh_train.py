"""The port's multi-rank training against one process (and JAX's weights):
``parallel/dryrun.py``'s three checks of ``__graft_entry__.dryrun_multichip``
on 4 gloo CPU ranks, a BatchNorm model (a tiny SFHformer) and the MoE
balance loss on 2 ranks, and ``cli/train.py --mesh 2`` against the same
run in one process.

JAX's multi-device step is the one-device step partitioned by XLA, so the
port's N-rank step must give the one-process step on the same global batch:
loss rtol 1e-4, gradient norm rtol 1e-3, every updated parameter (and
BatchNorm statistic) rtol 1e-3 / atol 1e-6, as JAX's own check holds them
(``__graft_entry__.py:212-227``). The halo forward's interior must equal
the unsharded one within 1e-4, and the stitched output JAX's
``halo_tiled_apply`` on the same weights within 1e-4.

Ranks are spawned processes (``spawn_ranks``: a ``file://`` rendezvous
under ``tmp_path``, so xdist workers never share a port; 60 s a
collective; every rank killed and the test failed at its deadline), each
on one torch thread, their bodies in the jax-free ``tests/mesh_ranks.py``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from mesh_ranks import (cli_rank, mesh_rank, recipe_rank, route_rank,
                        train_step_rank)
from PIL import Image

from image_restoration_tpu_torch.cli import train as train_cli
from image_restoration_tpu_torch.models import get_model
from image_restoration_tpu_torch.parallel import dryrun
from image_restoration_tpu_torch.parallel.dryrun import spawn_ranks
from image_restoration_tpu_torch.parallel.global_batch import GlobalBatch
from image_restoration_tpu_torch.utils.jax_bridge import state_dict_from_jax

DEADLINE = 240.0


def _jax_params(jmod, shape, key, boost=False, zero_temp=False):
    x = jnp.zeros(shape, jnp.float32)
    params = jax.jit(jmod.init)(jax.random.PRNGKey(key), x)["params"]

    def fix(path, leaf):
        keys = "/".join(getattr(p, "key", "") for p in path)
        if boost and ("gate_2" in keys or "freq_gate" in keys):
            return leaf * 100.0
        if zero_temp and keys.endswith("temperature"):
            return jnp.zeros_like(leaf)
        return leaf

    return jax.tree_util.tree_map_with_path(fix, params)


def _state(name, cfg, params):
    like = get_model(name, **cfg).state_dict()
    return {k: v.numpy() for k, v in
            state_dict_from_jax(jax.tree.map(np.asarray, params), like).items()}


def test_dryrun_multichip_four_ranks(tmp_path):
    """The three checks on 4 ranks from JAX's weights: MoCE-IR on a (2, 2)
    data x expert mesh, Restormer on a 4-rank data mesh, the halo forward
    on a (1, 4) data x spatial mesh; then the stitched halo output against
    JAX's ``halo_tiled_apply`` on the 8-device CPU mesh."""
    from jax.sharding import Mesh

    from image_restoration_tpu.models.moce_ir import MoCEIR
    from image_restoration_tpu.models.restormer import Restormer
    from image_restoration_tpu.parallel.halo import halo_tiled_apply

    moce = _jax_params(MoCEIR(**dryrun.TINY_MOCE), (1, 16, 16, 3), 0,
                       boost=True)
    rest = _jax_params(Restormer(**dryrun.TINY_RESTORMER_DP), (1, 16, 16, 3), 1)
    jhalo = Restormer(**dryrun.TINY_RESTORMER_HALO)
    halo_p = _jax_params(jhalo, (1, 32, 16, 3), 2, zero_temp=True)
    res = dryrun.dryrun_multichip(4, str(tmp_path), state_dicts={
        "moce": _state("moce_ir", dryrun.TINY_MOCE, moce),
        "restormer": _state("restormer", dryrun.TINY_RESTORMER_DP, rest),
        "halo": _state("restormer", dryrun.TINY_RESTORMER_HALO, halo_p)},
        timeout=DEADLINE)
    for check in ("moce", "restormer"):
        r = res[check]
        np.testing.assert_allclose(r["loss"], r["loss_one"], rtol=1e-4)
        np.testing.assert_allclose(r["gnorm"], r["gnorm_one"], rtol=1e-3)
        assert r["grad_dist"] < 1e-5, (check, r["grad_dist"])
        for k, v in r["params_one"].items():
            np.testing.assert_allclose(r["params"][k].numpy(), v.numpy(),
                                       rtol=1e-3, atol=1e-6, err_msg=k)
    h = res["halo"]
    assert h["halo"] == 64 and h["interior_err"] < 1e-4
    # JAX's halo_tiled_apply, same weights and image, on a (1, 4) mesh
    x = np.random.default_rng(3).random(
        (1, 3, 4 * 64, 16), dtype=np.float32).transpose(0, 2, 3, 1)
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(1, 4),
                axis_names=("data", "spatial"))

    def fn(img):
        return jhalo.apply({"params": halo_p}, img)

    want = np.asarray(halo_tiled_apply(fn, jnp.asarray(x), mesh, halo=64,
                                       batch_axis="data"))
    got = h["out"].numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_batchnorm_model_two_ranks(tmp_path):
    """A tiny SFHformer (BatchNorms on the batch's statistics in training)
    stepped on a 2-rank data mesh equals one process: its BatchNorms take
    the global batch's statistics, and its running statistics match."""
    cfg = dict(embed_dim=(8, 16, 32, 16, 8), depth=(1, 1, 1, 1, 1))
    res = spawn_ranks(train_step_rank, 2, str(tmp_path), DEADLINE,
                      name="sfhformer", cfg=cfg, mesh_shape=(2,),
                      axes=("data",), batch=4, size=32)
    r = res[0]  # rank 0 compares; rank 1 ran the sharded step alone
    assert r["loss"] == res[1]["loss"]
    np.testing.assert_allclose(r["loss"], r["loss_one"], rtol=1e-4)
    np.testing.assert_allclose(r["gnorm"], r["gnorm_one"], rtol=1e-3)
    assert [k for k in r["params"] if k.endswith("running_var")]
    for k, v in r["params_one"].items():
        np.testing.assert_allclose(r["params"][k].numpy(), v.numpy(),
                                   rtol=1e-3, atol=1e-6, err_msg=k)
        np.testing.assert_array_equal(res[1]["params"][k].numpy(),
                                      r["params"][k].numpy())


def test_moe_balance_loss_two_ranks(tmp_path):
    """The router's balance loss on 2 ranks is the global one, counted
    once: each rank's aux equals the one-process aux, and the gradient of
    the ranks' shares (aux / 2 each) equals the one-process gradient row
    for row; the noisy gates of each rank are the one-process gates of its
    rows (the noise is the global batch's draw)."""
    from image_restoration_tpu_torch.ops.moe import route

    logits = np.random.default_rng(0).standard_normal((8, 6)).astype(np.float32)
    one = torch.from_numpy(logits).clone().requires_grad_()
    gates, _, _, aux = route(one, 2, True, torch.Generator().manual_seed(9))
    aux.backward()
    res = spawn_ranks(route_rank, 2, str(tmp_path), DEADLINE, logits=logits,
                      k=2, seed=9)
    for r, got in enumerate(res):
        np.testing.assert_allclose(got["aux"].numpy(), aux.detach().numpy(),
                                   rtol=1e-5)
        np.testing.assert_allclose(got["grad"].numpy(),
                                   one.grad[r::2].numpy(), rtol=1e-4,
                                   atol=1e-7)
        np.testing.assert_array_equal(got["gates"].numpy(),
                                      gates.detach()[r::2].numpy())


@pytest.mark.parametrize("recipe,kwargs", [
    ("default", {"loss_terms": {"l1": 1.0, "psnr": 0.1}}),
    ("mwformer_style", {"temperature": 0.1})])
def test_recipes_on_two_ranks_equal_one_process(tmp_path, recipe, kwargs):
    """A per-row recipe (L1 + PSNR: each rank's means, averaged) and a
    batch-coupled one (SupCon: its pairs span the ranks, so it sees the
    gathered global batch) give on 2 ranks the one-process logs and
    gradients of the whole batch."""
    from image_restoration_tpu_torch.train.recipes import make_recipe
    from image_restoration_tpu_torch.train.trainer import loss_and_grads

    rng = np.random.default_rng(3)
    x = rng.standard_normal((8, 6)).astype(np.float32)
    y = rng.random((8, 5), dtype=np.float32)
    labels = np.array([0, 1, 2, 0, 1, 2, 0, 1])
    fn = make_recipe(recipe, **kwargs)
    assert fn.per_row == (recipe == "default")
    torch.manual_seed(0)
    model = torch.nn.Linear(6, 5)
    logs, grads = loss_and_grads(model, fn, {
        "lq": torch.from_numpy(x), "gt": torch.from_numpy(y),
        "de_id": torch.from_numpy(labels)})
    res = spawn_ranks(recipe_rank, 2, str(tmp_path), DEADLINE, recipe=recipe,
                      kwargs=kwargs, x=x, y=y, labels=labels)
    for r in res:
        assert sorted(r["logs"]) == sorted(logs)
        for k, v in logs.items():
            np.testing.assert_allclose(r["logs"][k], float(v.detach()),
                                       rtol=1e-5,
                                       err_msg=k)
        for k, g in grads.items():
            np.testing.assert_allclose(r["grads"][k].numpy(), g.numpy(),
                                       rtol=1e-4, atol=1e-7, err_msg=k)


def test_halo_check_in_bf16_two_ranks(tmp_path):
    """``check_halo`` in bf16 (the card's rules: the interior within 3x
    the unsharded bf16 forward's distance from fp32, the unsharded forward
    within 3x the plain bf16 forward's) runs on 2 gloo CPU ranks, strips
    of 128 rows around the halo of 64, where the
    kernels' plain versions make both forwards the plain one."""
    res = spawn_ranks(dryrun.checks_rank, 2, str(tmp_path), DEADLINE,
                      checks=[("halo", (1, 2), ("data", "spatial"),
                               dict(dtype=torch.bfloat16, strip=128))])
    h = res[0]["halo"]
    assert h["full_vs_fp32"] == h["plain_vs_fp32"] > 0
    assert h["interior_err"] <= 3 * h["bf16_vs_fp32"]


def test_rows_are_the_loaders_strided_shard():
    """Rank r of d loads rows r::d of the one-process batch, and
    ``GlobalBatch.randn`` gives it those rows of the one-process draw, for
    per-row and per-token shapes."""
    from image_restoration_tpu_torch.data.pipeline import Loader

    class Idx:
        def __len__(self):
            return 24

        def __getitem__(self, i):
            return {"i": np.asarray([i])}

    one = list(Loader(Idx(), 8, seed=3, num_threads=1).epoch(1))
    for r in range(2):
        mine = list(Loader(Idx(), 4, seed=3, num_threads=1, rank=r,
                           world_size=2).epoch(1))
        assert len(mine) == len(one)
        for a, b in zip(mine, one):
            np.testing.assert_array_equal(a["i"], b["i"][r::2])
    full = torch.randn((8 * 5, 3), generator=torch.Generator().manual_seed(1))
    for r in range(2):
        gb = GlobalBatch(None, 2, r, 4)
        got = gb.randn((4 * 5, 3), torch.Generator().manual_seed(1))
        np.testing.assert_array_equal(
            got.numpy(), full.reshape(8, 5, 3)[r::2].reshape(20, 3).numpy())


def test_make_mesh_on_ranks(tmp_path):
    """``make_mesh``'s default (all ranks on data), a (2, 2) data x expert
    mesh's coordinates, ``local_batch_size`` and the size error."""
    res = spawn_ranks(mesh_rank, 4, str(tmp_path), DEADLINE, shape=(2, 2))
    for r, got in enumerate(res):
        assert got["names"] == ("data", "expert", "spatial")
        assert got["shape"] == (4, 1, 1) and got["data_index"] == r
        assert got["local"] == 2 and got["data_size"] == 2
        assert got["expert_index"] == r % 2
        assert got["error"] == "mesh_shape (5,) != #devices 4"


def _d4_tree(root, n=4, size=32):
    """Clean images that flips and transposes leave unchanged (a function
    of the distance to the centre), so the loader's random crop and
    augmentation cannot tell the ranks' draws from one process's."""
    yy, xx = np.mgrid[:size, :size] - (size - 1) / 2
    r = np.sqrt(yy ** 2 + xx ** 2)
    for i in range(n):
        img = np.stack([np.cos(r * (0.2 + 0.1 * i) + c) for c in range(3)], -1)
        path = root / "denoising" / f"{i}.png"
        path.parent.mkdir(parents=True, exist_ok=True)
        Image.fromarray(((img + 1) * 127.5).astype(np.uint8)).save(path)
    return str(root)


def _argv(root, exp, *extra):
    return ["--device", "cpu", "--model", "restormer",
            "--data_file_dir", root, "--de_type", "denoise_15", "denoise_50",
            "--patch_size", "32", "--batch_size", "4", "--lr", "1e-3",
            "--warmup_epochs", "0", "--ckpt_dir", exp, "--name", "t",
            "--save_every", "0", "--log_every", "1", "--ema_decay", "0.9",
            "--num_workers", "1", "--fp32", "--grad_clip", "1.0", "--mixup",
            "--set", "model_kwargs.dim=8",
            "--set", "model_kwargs.num_blocks=(1,1,1,1)",
            "--set", "model_kwargs.num_refinement_blocks=1", *extra]


def test_cli_mesh_two_ranks_equals_one_process(tmp_path):
    """Three steps of ``cli/train.py --mesh 2`` on 2 ranks (global batch 4:
    the noise, the mixup permutation and the loss of the global batch)
    end with one process's parameters, and rank 0 alone logged the
    one-process losses."""
    root = _d4_tree(tmp_path / "data")
    one = train_cli.main(_argv(root, str(tmp_path / "one")),
                         max_steps_override=3)
    res = spawn_ranks(cli_rank, 2, str(tmp_path / "pg"), DEADLINE,
                      argv=_argv(root, str(tmp_path / "mesh"), "--mesh", "2"),
                      steps=3)
    want = one.model.state_dict()
    for got in res:
        for k, v in want.items():
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-3,
                                       atol=1e-6, err_msg=k)

    def losses(exp):
        lines = [json.loads(x) for x in open(tmp_path / exp / "t" / "metrics.jsonl")]
        return [(e["step"], e["train/total"]) for e in lines]

    got, ref = losses("mesh"), losses("one")
    assert [s for s, _ in got] == [0, 1, 2]
    np.testing.assert_allclose([v for _, v in got], [v for _, v in ref],
                               rtol=1e-4)


def test_cli_mesh_one_process_size_error(tmp_path):
    """``--mesh 2`` in one process raises JAX ``make_mesh``'s ValueError;
    ``--mesh 1`` trains as one process."""
    root = _d4_tree(tmp_path / "data", n=2)
    with pytest.raises(ValueError, match=r"mesh_shape \(2,\) != #devices 1"):
        train_cli.main(_argv(root, str(tmp_path)) + ["--mesh", "2"],
                       max_steps_override=1)
    state = train_cli.main(_argv(root, str(tmp_path)) + ["--mesh", "1"],
                           max_steps_override=1)
    assert state.step == 1
