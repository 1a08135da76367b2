"""Meshes over ``torch.distributed`` (the reference's ``launch/mesh.py``).

Functions, not constants: importing this module starts no process group.

``make_host_mesh(model=1, device=None)`` is the reference's ``(n //
model, model)`` mesh with axes ``("data", "model")`` over the ranks of the
default process group.  Where no group exists it starts a one-rank group
on an in-process ``HashStore`` (NCCL on the card, gloo when the caller
names the CPU), which needs no network; NCCL's bootstrap is pointed at
the loopback device unless ``NCCL_SOCKET_IFNAME`` is already set.
``device=None`` means the card and raises without CUDA, as every entry
point of the port does.

``make_production_mesh(multi_pod=False)`` is ``(16, 16)`` ``("data",
"model")`` or ``(2, 16, 16)`` ``("pod", "data", "model")`` over the first
256 or 512 ranks of a group of at least that many (the reference takes the
first 256 of its 512 dry-run devices the same way).
"""
from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device


def _device_type(device) -> str:
    return resolve_device(device).type


def ensure_group(device=None) -> None:
    """Start a one-rank default process group where none exists: NCCL for
    the card, gloo for the CPU, on an in-process store."""
    dev = _device_type(device)
    if dist.is_initialized():
        return
    if dev == "cuda":
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        torch.cuda.set_device(0)
    dist.init_process_group("nccl" if dev == "cuda" else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1)


def make_host_mesh(model: int = 1, device=None):
    """A ``(n // model, model)`` ``("data", "model")`` mesh over the
    default group's ``n`` ranks (``model`` capped at ``n``)."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = _device_type(device)
    ensure_group(device)
    n = dist.get_world_size()
    model = min(model, n)
    return init_device_mesh(dev, (n // model, model), mesh_dim_names=("data", "model"))


def make_production_mesh(*, multi_pod: bool = False, device=None):
    from torch.distributed.device_mesh import DeviceMesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    dev = _device_type(device)
    n = math.prod(shape)
    if not dist.is_initialized() or dist.get_world_size() < n:
        raise RuntimeError(f"the {shape} mesh needs a process group of at least {n} ranks")
    return DeviceMesh(dev, torch.arange(n).reshape(shape), mesh_dim_names=axes)
