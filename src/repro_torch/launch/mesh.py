"""Device meshes (the port of ``repro.launch.mesh``): the local mesh of
tensor-parallel serving and training, and the production meshes of the
dry-run.

The port's serving plan is single-controller, as the reference's is: one
host loop, one scheduler and one KV manager drive every shard, and the
mesh only says where each shard's tensors live.  A shard is a torch
device, so several shards may share one card (or the CPU) when the caller
lists that device several times: the counterpart of the reference's
``XLA_FLAGS=--xla_force_host_platform_device_count``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["Mesh", "make_production_mesh", "make_local_mesh"]


@dataclass(frozen=True)
class Mesh:
    """A grid of torch devices, one axis per name: (data, model), or
    (pod, data, model) for the multi-pod production mesh."""

    devices: np.ndarray             # object array, one dim per axis name
    axis_names: tuple = ("data", "model")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production meshes, for arithmetic and shape passes
    only: (data 16, model 16) = 256 devices, or (pod 2, data 16, model 16)
    = 512 with ``multi_pod``.  Every entry is ``torch.device("meta")``, so
    nothing can be placed on it and no card is touched.

    On H100s a 16-wide model axis spans two 8-card NVLink nodes; the
    dry-run still prices every collective at NVLink bandwidth
    (``roofline.HW["link_bw"]``), so its collective term is optimistic for
    this axis.  That is a stated limit of the dry-run."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    grid = np.empty(math.prod(shape), dtype=object)
    grid[:] = [torch.device("meta")] * grid.size
    return Mesh(grid.reshape(shape), axes)


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
