"""Multi-process runtime: the process group, host barriers, the local batch.

Port of :mod:`tfkaldi_tpu.parallel.multihost` onto ``torch.distributed``.
The program runs as one process a device under ``torchrun`` (for example
``torchrun --standalone --nproc_per_node N -m tfkaldi_tpu_torch.cli.main
... --device cuda``): :func:`initialize` brings up the process group from
torchrun's ``env://`` variables and does nothing without them, as
``multihost.py:27-50`` does without ``JAX_COORDINATOR_ADDRESS``. The
backend follows the device: NCCL on ``cuda:LOCAL_RANK`` for ``cuda``,
gloo for ``cpu``; ``cuda`` without a card, or without NCCL, raises, and
nothing falls back to the CPU or to gloo. A second, gloo group with a long
timeout carries the host barriers between pipeline steps (rank 0 may
compute features for minutes while the others wait).

There is no global array in torch: each rank keeps its local rows, and the
collectives of :mod:`tfkaldi_tpu_torch.parallel.comm` make the step the
global batch's. :func:`global_batch_from_local` only places the rank's
batch on its device.
"""

from __future__ import annotations

import datetime
import logging
import os

import torch
import torch.distributed as dist

from tfkaldi_tpu_torch.data.batching import PaddedBatch
from tfkaldi_tpu_torch.device import resolve_device

log = logging.getLogger(__name__)

ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
HOST_BARRIER_TIMEOUT = datetime.timedelta(hours=6)
_host_group = None


def launched() -> bool:
    """Whether torchrun (or a caller that set its variables) started this
    process as a rank."""
    return all(k in os.environ for k in ENV)


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def initialize(device: str | torch.device = "cuda") -> tuple[torch.device, bool]:
    """The rank's device and whether this call brought the process group up.

    Under torchrun (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``; ``LOCAL_RANK`` picks the card) ``cuda`` becomes
    ``cuda:LOCAL_RANK`` with an NCCL group and ``cpu`` a gloo group, through
    :func:`~tfkaldi_tpu_torch.device.resolve_device`, which pins TF32 off.
    Without those variables, or with a group already up, it only resolves
    ``device``; ``WORLD_SIZE > 1`` without the others raises (a launch that
    would train one copy a process alone)."""
    global _host_group
    if not launched() and int(os.environ.get("WORLD_SIZE", "1")) > 1:
        missing = [k for k in ENV if k not in os.environ]
        raise RuntimeError(f"WORLD_SIZE {os.environ['WORLD_SIZE']} without {', '.join(missing)}: start the ranks with "
                           f"torchrun, which sets {', '.join(ENV)} and LOCAL_RANK")
    if not launched() or is_initialized():
        dev = torch.device(device)
        if is_initialized() and dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        return resolve_device(dev), False
    kind = torch.device(device).type
    if kind == "cuda":
        local = int(os.environ.get("LOCAL_RANK", 0))
        dev = resolve_device(f"cuda:{local}")  # raises without a card
        if not dist.is_nccl_available():
            raise RuntimeError("--device cuda under torchrun needs NCCL, and this torch has none")
        torch.cuda.set_device(dev)
        backend = "nccl"
    elif kind == "cpu":
        dev = resolve_device("cpu")
        backend = "gloo"
    else:
        raise ValueError(f"unsupported device {device!r} (want cuda or cpu)")
    dist.init_process_group(backend, init_method="env://")
    _host_group = dist.new_group(backend="gloo", timeout=HOST_BARRIER_TIMEOUT)
    log.info("process group up: rank %d of %d, backend %s, device %s", dist.get_rank(),
             dist.get_world_size(), backend, dev)
    return dev, True


def barrier(name: str = "") -> None:
    """Wait until every rank gets here (a no-op without a process group),
    on the gloo host group when :func:`initialize` made one."""
    if not is_initialized():
        return
    log.debug("barrier %s", name)
    dist.barrier(group=_host_group)


def shutdown() -> None:
    """Tear the process group down (after the last collective)."""
    global _host_group
    if is_initialized():
        dist.destroy_process_group()
    _host_group = None


def global_batch_from_local(batch: PaddedBatch, device=None) -> PaddedBatch:
    """The rank's local ``PaddedBatch`` as tensors on its device (``device``,
    or the current CUDA device under NCCL, else the CPU). The ranks must
    have pinned the same padded lengths (``DeviceBatcher(fixed_input_length,
    fixed_target_length)``), since the grid's collectives join tensors of
    the same shapes."""
    if device is None:
        nccl = is_initialized() and dist.get_backend() == "nccl"
        device = torch.device("cuda", torch.cuda.current_device()) if nccl else torch.device("cpu")
    return batch.to(device)
