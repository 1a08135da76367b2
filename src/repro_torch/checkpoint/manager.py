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
"""
from __future__ import annotations

import json
import pathlib
import threading
from typing import Any

import numpy as np
import torch


def flatten(state: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """(path, leaf) pairs of ``state`` in its fixed order."""
    if isinstance(state, torch.nn.Module):
        return [(prefix + n, p) for n, p in state.named_parameters()]
    if isinstance(state, dict):
        return [pair for k, v in state.items() for pair in flatten(v, f"{prefix}{k}/")]
    return [(prefix.rstrip("/"), state)]


def _to_host(x) -> np.ndarray:
    """A host copy of ``x``: the trainer updates its tensors in place, so a
    CPU tensor's array must not share its memory while a write is pending."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
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
    return _write([n for n, _ in leaves], [_to_host(x) for _, x in leaves],
                  pathlib.Path(directory), step)


def latest_step(directory: str | pathlib.Path) -> int | None:
    directory = pathlib.Path(directory)
    if not directory.exists():
        return None
    steps = sorted(int(p.stem.split("_")[1]) for p in directory.glob("step_*.npz"))
    return steps[-1] if steps else None


@torch.no_grad()
def restore_checkpoint(template: Any, directory: str | pathlib.Path,
                       step: int | None = None) -> Any:
    """Write checkpoint ``step`` (default: the latest) into ``template``'s
    tensors in place, each cast to its dtype on its device, and return the
    template."""
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
            t.copy_(torch.from_numpy(a).to(t.device, t.dtype))
    return template


class AsyncCheckpointer:
    """Overlaps checkpoint writes with training (one in flight)."""

    def __init__(self, directory: str | pathlib.Path):
        self.directory = pathlib.Path(directory)
        self._thread: threading.Thread | None = None

    def save(self, state: Any, step: int) -> None:
        self.wait()
        # snapshot to host synchronously (cheap vs write), write in thread
        leaves = flatten(state)
        names, host = [n for n, _ in leaves], [_to_host(x) for _, x in leaves]
        self._thread = threading.Thread(
            target=_write, args=(names, host, self.directory, step))
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
