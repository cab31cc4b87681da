"""Mesh construction (counterpart of ``repro.launch.mesh``).

FUNCTIONS, not module-level constants: importing this module never creates
a process group. Single pod: 16x16 = 256 ranks ("data", "model");
multi-pod: 2x16x16 = 512 ranks ("pod", "data", "model"), the leading
"pod" axis spanning the inter-pod links.

The production meshes are for the dry run: where no process group exists,
:func:`make_production_mesh` creates a *fake* one (``torch.testing.
_internal.distributed.fake_pg``, rank 0 of 512, the counterpart of the
reference's 512 fake XLA host devices), whose collectives move nothing,
and builds the mesh on the CPU over its first ranks. :func:`make_host_mesh`
builds a small real mesh: a world of one over the card (``nccl``) or the
CPU (``gloo``) when no group exists, or the existing group's ranks (the
CPU tests' multi-process gloo runs).
"""
from __future__ import annotations

import math

import torch

from repro_torch import resolve_device

FAKE_WORLD = 512


def _mesh(device_type: str, shape, axes, n: int):
    from torch.distributed.device_mesh import DeviceMesh
    ranks = torch.arange(n, dtype=torch.int).reshape(shape)
    return DeviceMesh(device_type, ranks, mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    """The (16, 16) ("data", "model") mesh, or (2, 16, 16) ("pod", "data",
    "model") with ``multi_pod``, over a fake process group of
    :data:`FAKE_WORLD` ranks created here when none exists; raises
    ``RuntimeError`` when an existing group is too small."""
    import torch.distributed as dist
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    if not dist.is_initialized():
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=FAKE_WORLD)
    have = dist.get_world_size()
    if have < n:
        raise RuntimeError(
            f"need {n} ranks for mesh {shape}, have {have}; the dry run "
            f"creates a fake process group of {FAKE_WORLD} ranks when none "
            "exists")
    return _mesh("cpu", shape, axes, n)


def make_host_mesh(shape=(1, 1), axes=("data", "model"), device="cuda"):
    """A mesh of ``shape`` over real ranks on ``device`` (the card unless
    the caller passes ``device="cpu"``; raises without a card): a world of
    one (``HashStore``; ``nccl`` on the card, ``gloo`` on the CPU) created
    here when no group exists, else the existing group's first ranks."""
    import torch.distributed as dist
    dev = resolve_device(device)
    n = math.prod(shape)
    if not dist.is_initialized():
        if n != 1:
            raise RuntimeError(f"a mesh of {n} ranks needs a process group "
                               "of as many; none exists")
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if dev.type == "cuda":
            torch.cuda.set_device(dev.index or 0)
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    if dist.get_world_size() < n:
        raise RuntimeError(f"need {n} ranks for mesh {tuple(shape)}, have "
                           f"{dist.get_world_size()}")
    return _mesh(dev.type, tuple(shape), axes, n)


def destroy() -> None:
    """Destroy the default process group, if one exists."""
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
