"""The production mesh for H100 nodes (the counterpart of
``repro.launch.mesh``).

The reference's TPU pod shapes are (16, 16) and (2, 16, 16).  The port's
are sized for HGX H100 nodes: the ``model`` axis is one node's 8 cards on
NVLink, ``data`` spans 32 nodes over the network, and ``pod`` is a second
group of 32 nodes.  A function (not a module-level constant), so that
importing this module touches no device.
"""
from __future__ import annotations

import math

import torch

from repro_torch.fft.distributed import Mesh

#: (shape, axis names) of the single-pod and the two-pod production mesh.
SINGLE_POD = ((32, 8), ("data", "model"))
MULTI_POD = ((2, 32, 8), ("pod", "data", "model"))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """(32, 8) ``("data", "model")``, 256 cards, or (2, 32, 8) ``("pod",
    "data", "model")``, 512 cards.

    Axes:
      pod    pure data parallelism across pods (the gradient all-reduce
             crosses the network between pods)
      data   data parallelism for training and the batch split for
             serving; also the ZeRO-style second weight-sharding axis
      model  tensor and expert parallelism within one NVLink node

    Every slot is ``meta``: the dry run's mesh, which holds no data.
    """
    shape, axes = MULTI_POD if multi_pod else SINGLE_POD
    return Mesh([torch.device("meta")] * math.prod(shape), shape, axes)


def batch_axes(mesh: Mesh) -> tuple[str, ...]:
    """Mesh axes the global batch is sharded over."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)
