"""Multi-process bootstrap: the launcher layer
(image_restoration_tpu/core/distributed.py).

The reference zoo launches multi-process training through SLURM env-var
bootstrap (HOGformer-main/settingI/basicsr/utils/dist_util.py:28-58),
torch.distributed RANK/WORLD_SIZE (:21-25) and mp.spawn
(DarkIR-main/testing.py:81-83), all initialising NCCL process groups. The
port keeps the JAX package's one entry point and its trigger order, and
initialises ``torch.distributed``: NCCL when the ranks compute on CUDA
devices, one device each (``LOCAL_RANK``), gloo when the caller asks for
the CPU (the tests' spawned ranks). Without a request it does nothing, and
one process trains as before.
"""

from __future__ import annotations

import datetime
import os

import torch

_initialized = False


def _init_method(address: str) -> str:
    """``host:port`` -> ``tcp://host:port``; a URL (``tcp://``,
    ``file://``, ``env://``) stays as it is."""
    return address if "://" in address else f"tcp://{address}"


def maybe_initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device: str = "cuda",
    timeout: float | None = None,
) -> bool:
    """Initialise ``torch.distributed`` when multi-process is requested.

    Trigger order (first match wins), as in the JAX package:

    1. explicit arguments (``coordinator_address`` a ``host:port`` or an
       init URL such as ``file:///tmp/pg``);
    2. ``IR_TPU_COORDINATOR`` / ``IR_TPU_NUM_PROCESSES`` /
       ``IR_TPU_PROCESS_ID`` environment variables (the SLURM-style
       launcher: point them at srun's variables);
    3. torchrun's ``env://`` (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
       ``MASTER_PORT``) when its ``WORLD_SIZE`` is above 1, or with
       ``IR_TPU_MULTIHOST=1`` (the JAX package's switch; a one-rank
       torchrun group needs it).

    ``device`` is where the ranks compute: ``"cuda"`` (NCCL, and each rank
    takes the device ``LOCAL_RANK`` names, 0 without it) or ``"cpu"``
    (gloo). ``timeout`` (seconds) bounds every collective of the group;
    torch's default without it.

    Returns True if initialisation happened (or had already happened),
    False for the one-process no-op. Safe to call more than once.
    """
    global _initialized
    dist = torch.distributed
    if _initialized or (dist.is_available() and dist.is_initialized()):
        _initialized = True
        return True

    env = os.environ
    if coordinator_address is None:
        coordinator_address = env.get("IR_TPU_COORDINATOR")
    if num_processes is None and env.get("IR_TPU_NUM_PROCESSES"):
        num_processes = int(env["IR_TPU_NUM_PROCESSES"])
    if process_id is None and env.get("IR_TPU_PROCESS_ID"):
        process_id = int(env["IR_TPU_PROCESS_ID"])

    explicit = coordinator_address is not None and num_processes is not None
    auto = (env.get("IR_TPU_MULTIHOST") == "1"
            or int(env.get("WORLD_SIZE", "1")) > 1)
    if not explicit and not auto:
        return False
    if explicit and num_processes <= 1:
        return False

    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.set_device(int(env.get("LOCAL_RANK", 0)))
    kwargs = {"backend": "nccl" if cuda else "gloo"}
    if timeout is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout)
    if explicit:
        dist.init_process_group(init_method=_init_method(coordinator_address),
                                world_size=num_processes,
                                rank=process_id or 0, **kwargs)
    else:
        dist.init_process_group(init_method="env://", **kwargs)
    _initialized = True
    return True
