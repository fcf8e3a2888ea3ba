"""The device mesh of tensor-parallel serving (the port of
``repro.launch.mesh.make_local_mesh``).

The port's serving plan is single-controller, as the reference's is: one
host loop, one scheduler and one KV manager drive every shard, and the
mesh only says where each shard's tensors live.  A shard is a torch
device, so several shards may share one card (or the CPU) when the caller
lists that device several times: the counterpart of the reference's
``XLA_FLAGS=--xla_force_host_platform_device_count``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["Mesh", "make_local_mesh"]


@dataclass(frozen=True)
class Mesh:
    """A (data, model) grid of torch devices."""

    devices: np.ndarray             # (data, model) object array
    axis_names: tuple = ("data", "model")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)


def _normalize(device) -> torch.device:
    d = torch.device(device)
    return torch.device("cuda", 0) if d.type == "cuda" and d.index is None \
        else d


def make_local_mesh(*, tp: int = 1, data: int = 1, devices=None) -> Mesh:
    """(data, model) mesh of ``data * tp`` shards.

    Without ``devices`` it takes the first ``data * tp`` CUDA cards and
    raises when there are fewer: it never falls back to fewer cards, to
    shared cards or to the CPU.  ``devices`` lists the device of every
    shard explicitly (e.g. ``["cuda:0"] * 4`` for four shards on one card,
    or ``["cpu"] * 2``); it must hold ``data * tp`` entries."""
    if tp < 1 or data < 1:
        raise ValueError(f"make_local_mesh: bad axis sizes data={data} "
                         f"tp={tp}")
    need = data * tp
    if devices is None:
        have = torch.cuda.device_count()
        if need > have:
            raise ValueError(
                f"make_local_mesh: data={data} x model={tp} needs {need} "
                f"CUDA cards but torch sees {have}; to put several shards "
                "on one card (or on the CPU), pass devices=[...] "
                "explicitly, e.g. devices=['cuda:0'] * "
                f"{need}")
        devices = [torch.device("cuda", i) for i in range(need)]
    devices = [_normalize(d) for d in devices]
    if len(devices) != need:
        raise ValueError(f"make_local_mesh: data={data} x model={tp} needs "
                         f"{need} devices, got {len(devices)}")
    grid = np.empty(need, dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(data, tp))
