"""Checkpointing: atomic, async-capable; the reference's files
(``checkpoint/manager.py``) for the port's state.

A state is a tree of dicts (taken in insertion order), ``Params`` modules
(their ``named_parameters()``, in table order) and tensors or numpy
arrays.  The trainer's state flattens to its parameters, then the moments
``m`` and ``v`` in the parameters' order, then ``step``.  Each leaf is
gathered to the host and written as ``leaf_i`` of one
``step_XXXXXXXX.npz`` a step, with a ``step_XXXXXXXX.treedef.json``
sidecar (the leaf count, the leaves' paths, the step).  bfloat16 leaves
are stored as float32 (numpy has no bfloat16).  The ``.npz`` is written to
a ``.tmp`` file and published by rename, so a reader never sees half of
one.

``restore_checkpoint`` writes a checkpoint's leaves into the template's
tensors, in place: each keeps its device and dtype (bfloat16 casts back
from the stored float32).  ``AsyncCheckpointer`` copies the state to the
host synchronously and writes it in a thread, one write in flight, so the
write overlaps the next train step.

Sharded states (the trainer under a mesh): each DTensor leaf is gathered
whole (``full_tensor()``, on the calling thread: every rank takes part)
and rank 0 writes; a sharded save ends with a barrier once the file is
out, so no rank reads a checkpoint before it exists.  The files do not
depend on the mesh.  ``restore_checkpoint`` writes each rank's shard of a
leaf into a DTensor leaf of the template, and ``shardings`` (a tree of
``(mesh, placements)`` beside the template's, None where a leaf stays as
it is) first re-places the template's leaves: a checkpoint written under
one mesh restores under another, or under none (the reference's elastic
restore).
"""
from __future__ import annotations

import json
import pathlib
import threading
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import whole
from repro_torch.models.common import is_dtensor


def flatten(state: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """(path, leaf) pairs of ``state`` in its fixed order."""
    if isinstance(state, torch.nn.Module):
        return [(prefix + n, p) for n, p in state.named_parameters()]
    if isinstance(state, dict):
        return [pair for k, v in state.items() for pair in flatten(v, f"{prefix}{k}/")]
    return [(prefix.rstrip("/"), state)]


def _slots(state: Any, prefix: str = "") -> list[tuple[str, Any, Any]]:
    """(path, leaf, setter) triples in ``flatten``'s order: the setter puts a
    new tensor in the leaf's place (a ``Params`` module's parameter, a dict
    entry)."""
    if isinstance(state, torch.nn.Module):
        out = []
        for n, p in state.named_parameters():
            mod_name, _, leaf = n.rpartition(".")
            mod = state.get_submodule(mod_name) if mod_name else state

            def put(t, mod=mod, leaf=leaf, grad=p.requires_grad):
                mod._parameters[leaf] = torch.nn.Parameter(t, requires_grad=grad)
            out.append((prefix + n, p, put))
        return out
    out = []
    for k, v in state.items():
        if isinstance(v, (dict, torch.nn.Module)):
            out.extend(_slots(v, f"{prefix}{k}/"))
        else:
            out.append((prefix + k, v, lambda t, d=state, k=k: d.__setitem__(k, t)))
    return out


def _writer() -> bool:
    """Whether this process writes: rank 0, or any process outside a group."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _to_host(x) -> np.ndarray:
    """A host copy of ``x``: the trainer updates its tensors in place, so a
    CPU tensor's array must not share its memory while a write is pending.
    A DTensor is gathered whole first (a collective)."""
    if isinstance(x, torch.Tensor):
        x = whole(x.detach())
        if x.dtype == torch.bfloat16:
            x = x.float()   # numpy has no bfloat16
        return x.numpy().copy() if x.device.type == "cpu" else x.cpu().numpy()
    return np.array(x)


def _write(names: list[str], arrays: list[np.ndarray], directory: pathlib.Path,
           step: int) -> pathlib.Path:
    directory.mkdir(parents=True, exist_ok=True)
    tmp = directory / f".tmp_step_{step}.npz"
    final = directory / f"step_{step:08d}.npz"
    with open(tmp, "wb") as f:
        np.savez(f, **{f"leaf_{i}": a for i, a in enumerate(arrays)})
    (directory / f"step_{step:08d}.treedef.json").write_text(
        json.dumps({"n_leaves": len(arrays), "treedef": names, "step": step}))
    tmp.rename(final)   # atomic publish
    return final


def save_checkpoint(state: Any, directory: str | pathlib.Path, step: int) -> pathlib.Path:
    leaves = flatten(state)
    host = [_to_host(x) for _, x in leaves]
    directory = pathlib.Path(directory)
    final = directory / f"step_{step:08d}.npz"
    if _writer():
        final = _write([n for n, _ in leaves], host, directory, step)
    if any(is_dtensor(x) for _, x in leaves):
        dist.barrier()
    return final


def latest_step(directory: str | pathlib.Path) -> int | None:
    directory = pathlib.Path(directory)
    if not directory.exists():
        return None
    steps = sorted(int(p.stem.split("_")[1]) for p in directory.glob("step_*.npz"))
    return steps[-1] if steps else None


@torch.no_grad()
def restore_checkpoint(template: Any, directory: str | pathlib.Path,
                       step: int | None = None, shardings: Any = None) -> Any:
    """Write checkpoint ``step`` (default: the latest) into ``template``'s
    tensors in place, each cast to its dtype on its device (a DTensor's
    local shard on each rank), and return the template.  ``shardings``
    (module doc) re-places the template's leaves first."""
    if shardings is not None:
        _place(template, shardings)
    directory = pathlib.Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    leaves = flatten(template)
    with np.load(directory / f"step_{step:08d}.npz") as data:
        if len(leaves) != len(data.files):
            raise ValueError(f"checkpoint step {step} holds {len(data.files)} leaves, "
                             f"the template {len(leaves)}")
        for i, (name, t) in enumerate(leaves):
            a = data[f"leaf_{i}"]
            if tuple(a.shape) != tuple(t.shape):
                raise ValueError(f"checkpoint leaf {name}: shape {a.shape} != {tuple(t.shape)}")
            full = torch.from_numpy(a).to(t.device, t.dtype)
            if is_dtensor(t):
                from torch.distributed.tensor import distribute_tensor

                full = distribute_tensor(full, t.device_mesh, t.placements,
                                         src_data_rank=None).to_local()
                t = t.to_local()
            t.copy_(full)
    return template


def _place(template: Any, shardings: Any) -> None:
    """Re-place each leaf of ``template`` that ``shardings`` gives a
    ``(mesh, placements)`` for (None: as it is): a DTensor on that mesh, or
    with a mesh of None a plain tensor, its values kept."""
    from torch.distributed.tensor import distribute_tensor

    targets = dict(flatten(shardings))
    for path, t, put in _slots(template):
        target = targets.get(path)
        if target is None:
            continue
        mesh, place = target
        full = whole(t.detach())
        put(full.clone() if mesh is None
            else distribute_tensor(full, mesh, place, src_data_rank=None))


class AsyncCheckpointer:
    """Overlaps checkpoint writes with training (one in flight)."""

    def __init__(self, directory: str | pathlib.Path):
        self.directory = pathlib.Path(directory)
        self._thread: threading.Thread | None = None
        self._sharded = False   # the write in flight is of a sharded state

    def save(self, state: Any, step: int) -> None:
        self.wait()
        # snapshot to host synchronously (cheap vs write), write in thread
        leaves = flatten(state)
        names, host = [n for n, _ in leaves], [_to_host(x) for _, x in leaves]
        self._sharded = any(is_dtensor(x) for _, x in leaves)
        if _writer():
            self._thread = threading.Thread(
                target=_write, args=(names, host, self.directory, step))
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._sharded:
            self._sharded = False
            dist.barrier()
