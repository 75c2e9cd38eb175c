"""Device meshes (``repro/launch/mesh.py``), on ``torch.distributed``.

JAX drives every device of a mesh from one process; a DTensor mesh is
SPMD, one process per rank, over the current process group.  So:

* :func:`make_production_mesh` lays the reference's production meshes,
  ``(16, 16)`` over ``("data", "model")`` and ``(2, 16, 16)`` over
  ``("pod", "data", "model")``, over a group of 256 or 512 ranks: a fake
  one (``FakeStore``, no devices) in the tests and the dry run.
* :func:`make_host_mesh` lays the serving mesh, ``(data, model)``, over
  the first ``data · model`` ranks of the group.  Every rank of the group
  must call it (building a mesh creates a group per axis, a collective
  call); ranks past ``data · model`` sit the mesh out: they are in none of
  its groups, :func:`in_mesh` is false for them, and they must never call
  a sharded entry point, so they join no collective.
* :func:`process_group` opens the group when none is open: from the
  environment ``torchrun`` sets, or else a one-rank group over an
  in-memory store (no TCP port), so that ``serve.py --sharded`` and a 1 × 1
  mesh need no launcher.  Wider meshes come from ``torchrun`` or
  ``torch.multiprocessing.spawn``, which give every rank the same store.

The device type is ``cuda`` (NCCL) unless the caller asks for ``cpu``
(gloo).  A CUDA mesh whose NCCL group cannot be opened fails: nothing
falls back to gloo or to the CPU.  Functions, not module-level
constants: importing this module opens nothing.
"""

from __future__ import annotations

import contextlib
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

SERVING_AXES = ("data", "model")


def _device_type(device) -> str:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' for a gloo mesh")
    return dev.type


def make_production_mesh(*, multi_pod: bool = False, device="cuda") -> DeviceMesh:
    """The reference's production mesh over the current process group,
    which must have 256 (512 with ``multi_pod``) ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else SERVING_AXES
    return init_device_mesh(_device_type(device), shape, mesh_dim_names=axes)


def make_host_mesh(model: int = 1, data=None, *, device="cuda") -> DeviceMesh:
    """The ``(data, model)`` serving mesh over the group's ranks.  With
    ``data=None`` every rank ``model`` leaves goes to the data axis; a
    smaller ``data`` lays the mesh over the first ``data · model`` ranks
    (a 1 × 1 mesh on a wider group, say), and the others sit it out."""
    n = dist.get_world_size()
    if model < 1 or n % model != 0:
        raise ValueError(f"model axis {model} does not divide the {n} local devices")
    if data is None:
        data = n // model
    if data < 1 or data * model > n:
        raise ValueError(f"mesh ({data}, {model}) needs {data * model} devices, have {n}")
    dev = _device_type(device)
    if dev == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    ranks = torch.arange(data * model).reshape(data, model)
    return DeviceMesh(dev, ranks, mesh_dim_names=SERVING_AXES)


def in_mesh(mesh: DeviceMesh) -> bool:
    """Whether this rank is one of ``mesh``'s."""
    return mesh.get_coordinate() is not None


def mesh_shape(mesh: DeviceMesh) -> dict:
    """{axis name: size}."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


@contextlib.contextmanager
def process_group(device="cuda"):
    """The process group a mesh is laid over, for the ``with`` block.  An
    open group is used as it is (and left open); otherwise one is opened
    from ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``), or else as one rank over an
    in-memory store, and destroyed when the block ends.  NCCL on ``cuda``,
    gloo on ``cpu``."""
    if dist.is_initialized():
        yield
        return
    dev = _device_type(device)
    backend = "nccl" if dev == "cuda" else "gloo"
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        if dev == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend)
    else:
        if dev == "cuda":
            torch.cuda.set_device(0)
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()
