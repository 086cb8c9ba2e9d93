"""Elastic scaling: remap a checkpoint onto a shrunk/grown mesh (the
counterpart of ``repro.runtime.elastic``; pure Python).

At 1000+ nodes, waiting for a replacement node is wasteful; the elastic
plan answers "which mesh do we rebuild with the devices we still have,
and is it worth it":

  * the ``model`` axis is load-bearing (weights are sharded over it) —
    we keep it intact and shrink the ``data``/``pod`` axes, because DP
    replicas are interchangeable;
  * batch invariance: global_batch stays fixed; surviving replicas take
    proportionally more microbatches (gradient accumulation), trading
    step time for numerical identity with the pre-failure run;
  * restore path: ``repro_torch.runtime.checkpoint`` saves a sharded leaf
    gathered and restores it onto the mesh of the ``like`` leaf — the
    manifest is mesh-agnostic.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RemeshPlan:
    old_mesh: tuple[int, ...]
    new_mesh: tuple[int, ...]
    axis_names: tuple[str, ...]
    microbatch_multiplier: int     # extra grad-accum per surviving replica
    throughput_fraction: float     # expected step-rate vs original


def elastic_remesh_plan(mesh_shape: tuple[int, ...],
                        axis_names: tuple[str, ...],
                        n_failed: int) -> RemeshPlan:
    """Shrink the data-parallel axis to absorb ``n_failed`` devices.

    The model axis is preserved (weight shards must remain complete);
    whole DP replicas are retired — each retired replica costs
    ``model_axis`` devices, so we retire ceil(n_failed / model) replicas.
    """
    if "data" not in axis_names:
        raise ValueError(f"elastic re-meshing shrinks the 'data' axis; "
                         f"axes {tuple(axis_names)}")
    data_idx = axis_names.index("data")
    model = 1
    if "model" in axis_names:
        model = mesh_shape[axis_names.index("model")]
    replicas = 1
    for i, a in enumerate(axis_names):
        if a != "model":
            replicas *= mesh_shape[i]

    retired = -(-n_failed // model)            # ceil
    new_replicas = replicas - retired
    if new_replicas < 1:
        raise ValueError("not enough devices left for one replica")

    # fold pods into the data axis if a pod was lost
    new_shape = list(mesh_shape)
    if "pod" in axis_names:
        pod_idx = axis_names.index("pod")
        new_shape[pod_idx] = 1
        new_shape[data_idx] = new_replicas
    else:
        new_shape[data_idx] = new_replicas

    # keep global batch: each survivor accumulates more microbatches
    mult = -(-replicas // new_replicas)
    return RemeshPlan(
        old_mesh=tuple(mesh_shape),
        new_mesh=tuple(new_shape),
        axis_names=axis_names,
        microbatch_multiplier=mult,
        throughput_fraction=new_replicas / replicas,
    )
