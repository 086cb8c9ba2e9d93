"""Roofline analysis per (arch x shape x mesh) from dry-run artifacts (the
counterpart of ``repro.analysis.roofline``).

  compute term    = FLOPs a device / peak FLOP/s
  memory term     = HBM bytes a device / HBM bandwidth
  collective term = model-axis bytes / NVLink bandwidth
                    + data- and pod-axis bytes / network bandwidth

The device is :data:`H100_ROOFLINE`: the H100 SXM record with its dense
bf16 tensor-core peak (``core.hardware.H100_SXM_BF16``) and the NVLink rate
of one direction as its link bandwidth; the network rate is
:data:`NETWORK_BANDWIDTH`.  Both link rates are NVIDIA datasheet values,
not measured ones.  MODEL_FLOPS = 6*N*D (dense) or 6*N_active*D (MoE);
the useful-compute ratio MODEL_FLOPS / counted FLOPs flags remat and
dispatch waste.

The DVFS planner (the paper's technique) consumes these terms:
``repro_torch.core.workloads.roofline_workload`` turns a row of this
table into a WorkloadProfile whose optimal clock and energy saving are
computed just like the paper's per-FFT-length optimum
(:func:`dvfs_plan`).
"""
from __future__ import annotations

import dataclasses
import json

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.core.dvfs import SweepResult, sweep
from repro_torch.core.hardware import H100_SXM_BF16, DeviceSpec
from repro_torch.core.workloads import roofline_workload

#: NVLink 4 of one H100 SXM card, one direction: NVIDIA's datasheet gives
#: 900 GB/s for both directions together.  A datasheet value, not a
#: measured one.
NVLINK_BANDWIDTH = 450e9

#: One 400 Gb/s NDR InfiniBand NIC a card, as in a DGX H100: 50 GB/s a
#: direction.  A datasheet value, not a measured one.
NETWORK_BANDWIDTH = 50e9

#: The roofline's device: the H100 SXM record, bf16 tensor-core peak, and
#: NVLink as its link bandwidth.  ``core.hardware.H100_SXM`` keeps no link
#: rate, so no other pricing in the port moves.
H100_ROOFLINE = dataclasses.replace(H100_SXM_BF16, name="h100-sxm-roofline",
                                    link_bandwidth=NVLINK_BANDWIDTH)


@dataclasses.dataclass(frozen=True)
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float                # per-device FLOPs of one step
    hbm_bytes: float                # per-device HBM traffic
    collective_bytes: float         # per-device collective traffic
    model_flops: float              # 6*N(active)*D tokens, global
    device: DeviceSpec = H100_ROOFLINE
    network_bytes: float = 0.0      # the part of collective_bytes on the
                                    # data and pod axes

    @property
    def compute_s(self) -> float:
        return self.hlo_flops / self.device.peak_flops

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / self.device.hbm_bandwidth

    @property
    def collective_s(self) -> float:
        """The model axis on the link, the batch axes on the network."""
        link = self.collective_bytes - self.network_bytes
        return (link / self.device.link_bandwidth
                + self.network_bytes / NETWORK_BANDWIDTH)

    @property
    def bound(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        """Roofline step time (perfect overlap = max of terms)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_ratio(self) -> float:
        """MODEL_FLOPS / (global counted flops) — remat/dispatch waste."""
        total = self.hlo_flops * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """The model FLOPs' time at peak over the roofline step time."""
        if self.step_s == 0:
            return 0.0
        return (self.model_flops / self.chips / self.device.peak_flops
                ) / self.step_s

    def row(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "compute_ms": round(self.compute_s * 1e3, 3),
            "memory_ms": round(self.memory_s * 1e3, 3),
            "collective_ms": round(self.collective_s * 1e3, 3),
            "bound": self.bound,
            "useful_ratio": round(self.useful_ratio, 3),
            "mfu_roofline": round(self.roofline_fraction, 3),
        }


def model_flops_for(cfg: ArchConfig, shape: ShapeSpec) -> float:
    """6*N*D (6*N_active*D for MoE); D = tokens processed by the step."""
    n = cfg.active_param_count() if cfg.moe is not None else cfg.param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens               # forward only
    tokens = shape.global_batch                # one token per sequence
    return 2.0 * n * tokens


def analytic_memory_bytes(cfg: ArchConfig, shape: ShapeSpec, chips: int
                          ) -> dict[str, float]:
    """First-principles HBM traffic per device per step (bytes): the
    reference's napkin-roofline accounting, term for term (the counted
    bytes of the artifact are an upper bound: every eager op reads and
    writes device memory)."""
    n_params = cfg.param_count()
    tokens = shape.global_batch * (shape.seq_len
                                   if shape.kind in ("train", "prefill")
                                   else 1)
    d, L, V = cfg.d_model, cfg.n_layers, cfg.vocab
    out: dict[str, float] = {}

    if shape.kind == "train":
        out["weights_io"] = 3 * n_params * 2          # read fwd+bwd, write
        out["optimizer_io"] = 24 * n_params           # grads + m/v, f32
        out["activations_io"] = 3 * L * tokens * d * 2
        out["logits_io"] = 4 * tokens * V * 4         # chunked CE fwd+bwd
    elif shape.kind == "prefill":
        out["weights_io"] = n_params * 2
        out["activations_io"] = 2 * L * tokens * d * 2
        out["logits_io"] = shape.global_batch * V * 4
    else:
        out["weights_io"] = n_params * 2
        out["activations_io"] = 2 * L * shape.global_batch * d * 2

    # attention-score traffic (the chunked attention materialises score
    # chunks)
    s = shape.seq_len
    if cfg.family in ("ssm",):
        q = cfg.ssm.chunk
        h = cfg.ssm.expand * d // cfg.ssm.head_dim
        if shape.kind in ("train", "prefill"):
            # L matrices (B, S/Q, H, Q, Q) f32 -> B*S*H*Q elements/pass
            passes = 4 if shape.kind == "train" else 2
            out["ssd_chunk_io"] = (passes * L * shape.global_batch * s * q
                                   * h * 4)
    else:
        n_attn = L
        if cfg.family == "hybrid":
            n_attn = cfg.n_layers // max(cfg.shared_attn_every, 1)
        kv_len = s
        if cfg.sliding_window and cfg.local_per_global:
            # 5 of 6 layers see only the window
            frac_local = cfg.local_per_global / (cfg.local_per_global + 1)
            kv_len = (frac_local * cfg.sliding_window
                      + (1 - frac_local) * s)
        heads = cfg.n_heads
        if shape.kind == "train":
            out["attn_scores_io"] = (4 * n_attn * shape.global_batch
                                     * heads * s * kv_len / 2 * 4)
        elif shape.kind == "prefill":
            out["attn_scores_io"] = (2 * n_attn * shape.global_batch
                                     * heads * s * kv_len / 2 * 4)
        else:
            # decode: read the KV cache once per step
            if cfg.mla is not None:
                per_tok = cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim
                out["kv_cache_io"] = L * shape.global_batch * s * per_tok * 2
            else:
                hd = cfg.resolved_head_dim
                out["kv_cache_io"] = (n_attn * shape.global_batch * s
                                      * 2 * cfg.n_kv_heads * hd * 2)
    if cfg.family == "hybrid" and shape.kind == "decode":
        hd = cfg.resolved_head_dim
        n_sites = cfg.n_layers // max(cfg.shared_attn_every, 1)
        out["kv_cache_io"] = (n_sites * shape.global_batch * s
                              * 2 * cfg.n_kv_heads * hd * 2)

    if cfg.moe is not None and shape.kind in ("train", "prefill"):
        passes = 4 if shape.kind == "train" else 2
        out["moe_dispatch_io"] = (passes * (L - cfg.n_dense_layers) * tokens
                                  * cfg.moe.top_k * 1.25 * d * 2)

    out["total"] = float(sum(out.values()))
    return {k: v / chips for k, v in out.items()}


def roofline_from_artifact(path: str) -> RooflineTerms:
    """The roofline terms of one ``launch.dryrun`` artifact: HBM bytes from
    :func:`analytic_memory_bytes` (a ``launch.fft_dryrun`` pencil, which
    has no model config: the artifact's own), the network's share of the
    collective bytes from its ``collective_by_axis``."""
    from repro_torch.configs import get_arch, get_shape
    with open(path) as f:
        a = json.load(f)
    if a["kind"] == "fft":
        hbm = a["hbm_bytes_per_device"]
    else:
        hbm = analytic_memory_bytes(get_arch(a["arch"]), get_shape(a["shape"]),
                                    a["chips"])["total"]
    by_axis = a.get("collective_by_axis", {})
    return RooflineTerms(
        arch=a["arch"], shape=a["shape"], mesh=a["mesh"],
        chips=a["chips"], hlo_flops=a["flops_per_device"],
        hbm_bytes=hbm,
        collective_bytes=a["collective_bytes_per_device"],
        model_flops=a["model_flops"],
        network_bytes=by_axis.get("data", 0.0) + by_axis.get("pod", 0.0),
    )


def dvfs_plan(t: RooflineTerms) -> SweepResult:
    """The energy-optimal clock of a roofline row on its device, as the
    reference's ``benchmarks/run.py dvfs_cells`` plans it (issue
    efficiency 0.75, a 10 % real-time margin).  ``roofline_workload``
    prices collectives on one link rate: the row's collective time is
    passed as the bytes that take that time on the device's link."""
    prof = roofline_workload(
        f"{t.arch}-{t.shape}", t.device, hlo_flops=t.hlo_flops,
        hbm_bytes=t.hbm_bytes,
        collective_bytes=t.collective_s * t.device.link_bandwidth,
        useful_flops=t.model_flops / t.chips, issue_efficiency=0.75)
    return sweep(prof, t.device, time_budget=0.10)
