"""Mesh construction, the counterpart of ``repro.launch.mesh``.

Single pod: 256 ranks as (data=16, model=16).
Multi-pod:  512 ranks as (pod=2, data=16, model=16); the ``pod`` axis
carries the cross-pod gradient all-reduce and HadarE's consolidation.

``make_production_mesh`` builds a ``DeviceMesh`` over the process group
that is open, as the dry run's fake 256- or 512-rank world
(``repro_torch.launch.dryrun``) is: nothing runs on its ranks, so its
device type is ``cpu``.  ``make_host_mesh`` builds a real mesh
and defaults to the card.  Functions, not module constants, so importing
never touches a process group.
"""
from __future__ import annotations

import math

from repro_torch.device import DeviceLike, resolve_device

# Data-sheet figures of the card the port runs on (NVIDIA H100 80GB HBM3,
# SXM, 700 W limit; the smoke prints the card's name and power limit
# beside every number it takes).  The roofline's inputs, as PERF.md's
# kernel bounds use them.
PEAK_FLOPS_BF16 = 989e12        # FLOP/s, dense
HBM_BW = 3.35e12                # bytes/s
NVLINK_BW = 450e9               # bytes/s each way per card (NVLink 4, 18 links)

# The production meshes' ranks are fake (the dry run's world): nothing
# runs on them, as on the JAX package's 512 fake host devices.
PRODUCTION_DEVICE_TYPE = "cpu"


def _mesh(device_type: str, shape, names):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False):
    """(16, 16) ``("data", "model")``, or with ``multi_pod`` (2, 16, 16)
    ``("pod", "data", "model")``, over the open process group, whose world
    must hold 256 or 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(PRODUCTION_DEVICE_TYPE, shape, axes)


def make_host_mesh(data: int = 1, model: int = 1, pod: int = 1,
                   device: DeviceLike = None, pod_axis: bool = False):
    """A mesh of the open process group's ranks, ``("pod", "data",
    "model")`` with ``pod > 1`` or ``pod_axis``, ``("data", "model")``
    otherwise, on ``device`` (default: the card; raises without one
    unless the caller passes ``device="cpu"``)."""
    dev = resolve_device(device)
    if pod > 1 or pod_axis:
        return _mesh(dev.type, (pod, data, model), ("pod", "data", "model"))
    return _mesh(dev.type, (data, model), ("data", "model"))


def mesh_chip_count(mesh) -> int:
    return int(math.prod(tuple(mesh.shape)))


def open_fake_world(world_size: int, rank: int = 0) -> None:
    """A process group of ``world_size`` fake ranks in this process (the
    ``"fake"`` backend of ``torch.testing``): collectives are recorded
    and never run.  A process holds one default group, so a fake one
    cannot live beside a real one: the dry run is a process of its own."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", rank=rank, world_size=world_size,
                            store=FakeStore())


def close_world() -> None:
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()

