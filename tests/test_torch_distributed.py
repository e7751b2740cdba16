"""The port's launcher (``core/distributed.py``) and mesh
(``core/mesh.py``) in one process: ``tests/test_distributed.py``'s four
cases with ``torch.distributed.init_process_group`` monkeypatched, and
``make_mesh``'s default, its error and ``local_batch_size`` on a one-rank
gloo group (``file://`` rendezvous under ``tmp_path``). The mesh on 4 ranks
is ``tests/test_torch_mesh_train.py`` ``test_make_mesh_on_ranks``."""

import importlib

import pytest
import torch
import torch.distributed as dist

ENV = ("IR_TPU_MULTIHOST", "IR_TPU_COORDINATOR", "IR_TPU_NUM_PROCESSES",
       "IR_TPU_PROCESS_ID", "WORLD_SIZE")


def _fresh():
    from image_restoration_tpu_torch.core import distributed

    importlib.reload(distributed)
    return distributed


@pytest.fixture
def calls(monkeypatch):
    seen = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda **kw: seen.append(kw))
    for var in ENV:
        monkeypatch.delenv(var, raising=False)
    return seen


def test_noop_without_request(calls):
    d = _fresh()
    assert d.maybe_initialize_distributed(device="cpu") is False
    assert calls == []


def test_explicit_args_init_gloo(calls):
    d = _fresh()
    assert d.maybe_initialize_distributed("host0:1234", 4, 1,
                                          device="cpu") is True
    assert calls == [dict(backend="gloo", init_method="tcp://host0:1234",
                          world_size=4, rank=1)]
    # idempotent: a second call returns True without initialising again
    assert d.maybe_initialize_distributed() is True
    assert len(calls) == 1


def test_slurm_style_env(calls, monkeypatch):
    d = _fresh()
    monkeypatch.setenv("IR_TPU_COORDINATOR", "file:///tmp/pg")
    monkeypatch.setenv("IR_TPU_NUM_PROCESSES", "2")
    monkeypatch.setenv("IR_TPU_PROCESS_ID", "0")
    assert d.maybe_initialize_distributed(device="cpu", timeout=60) is True
    assert calls[0]["world_size"] == 2 and calls[0]["rank"] == 0
    assert calls[0]["init_method"] == "file:///tmp/pg"
    assert calls[0]["timeout"].total_seconds() == 60


def test_auto_mode_is_torchrun_env(calls, monkeypatch):
    d = _fresh()
    monkeypatch.setenv("IR_TPU_MULTIHOST", "1")
    assert d.maybe_initialize_distributed(device="cpu") is True
    assert calls == [dict(backend="gloo", init_method="env://")]


def test_torchrun_world_size_starts_env(calls, monkeypatch):
    """torchrun's WORLD_SIZE above 1 starts the env:// group without
    IR_TPU_MULTIHOST; a one-rank torchrun stays one process."""
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert _fresh().maybe_initialize_distributed(device="cpu") is False
    monkeypatch.setenv("WORLD_SIZE", "2")
    assert _fresh().maybe_initialize_distributed(device="cpu") is True
    assert calls == [dict(backend="gloo", init_method="env://")]


def test_cuda_ranks_take_nccl_and_their_local_rank(calls, monkeypatch):
    d = _fresh()
    picked = []
    monkeypatch.setattr(torch.cuda, "set_device", picked.append)
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert d.maybe_initialize_distributed("h:1", 8, 3) is True
    assert calls[0]["backend"] == "nccl" and picked == [3]
    assert d.maybe_initialize_distributed() is True and len(calls) == 1


def test_one_rank_explicit_is_noop(calls):
    d = _fresh()
    assert d.maybe_initialize_distributed("h:1", 1, 0, device="cpu") is False


def test_make_mesh_default_error_and_local_batch(tmp_path):
    from image_restoration_tpu_torch.core import mesh as M

    # no process group: one rank, no mesh to build
    with pytest.raises(ValueError, match=r"mesh_shape \(2,\) != #devices 1"):
        M.make_mesh((2,), ("data",))
    assert M.make_mesh() is None
    assert M.local_batch_size(8, None) == 8
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        mesh = M.make_mesh()
        assert mesh.mesh_dim_names == ("data", "expert", "spatial")
        assert tuple(mesh.shape) == (1, 1, 1)
        assert M.axis_size(mesh, "data") == 1 and M.axis_index(mesh, "data") == 0
        assert M.data_parallel_mesh().mesh_dim_names == ("data",)
        with pytest.raises(ValueError, match=r"mesh_shape \(2, 1\) != #devices 1"):
            M.make_mesh((2, 1), ("data", "expert"))
        assert M.local_batch_size(6, mesh) == 6
        x = torch.arange(6)
        assert torch.equal(M.batch_sharding(x, mesh), x)
        assert M.replicated(x, mesh) is x
    finally:
        dist.destroy_process_group()


def test_local_batch_size_divisibility():
    from image_restoration_tpu_torch.core import mesh as M

    class Fake:
        mesh_dim_names = ("data", "expert")

        def size(self, i):
            return (4, 2)[i]

        def get_local_rank(self, axis):
            return {"data": 3, "expert": 1}[axis]

    assert M.local_batch_size(8, Fake()) == 2
    assert M.local_batch_size(8, Fake(), "expert") == 4
    with pytest.raises(ValueError, match="not divisible by mesh axis data=4"):
        M.local_batch_size(6, Fake())
    rows = M.batch_sharding({"lq": torch.arange(8), "name": "x"}, Fake())
    assert rows["lq"].tolist() == [3, 7] and rows["name"] == "x"
