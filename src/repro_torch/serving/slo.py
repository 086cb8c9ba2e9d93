"""SLO budgets, admission control and the graceful-degradation ladder
(the counterpart of ``repro.serving.slo``).

The paper's DVFS savings only matter while the pipeline keeps meeting its
real-time deadline (Sec. 2.3: S = t_acquire / t_process >= 1).  Barbosa
et al. (2016) argue SKA-scale power management must be a closed, monitored,
failure-aware control problem — so the serving layer gets an explicit
contract per request kind (:class:`SLO`), an admission controller that
enforces it *before* the p99 budget is blown, and a degradation ladder the
service walks instead of failing:

  rung 0  tuned-dvfs       tuned plan, DVFS-locked at the sweep optimum
  rung 1  boost-heuristic  heuristic plan at the boost clock, sweep skipped
                           (cheapest possible build; the GPU-default cost)
  rung 2  pure-torch       on a CPU slot, the rung-1 plan run under
                           ``repro_torch.fft.plan.kernels_disabled()``: the
                           pure-torch Stockham engine, still at boost (the
                           reference's "pure-jax"); on a card slot, the
                           rung-1 plan with its kernels, since a tensor on
                           the card never leaves them

Admission decisions are **model-predictive and deterministic**: they use
queue depth and the analytic cost model's boost-clock service-time
estimates (from cached sweeps), never wall-clock measurements — so a chaos
run with a fixed fault-plan seed reproduces the exact same admit / degrade
/ shed outcomes.  Every rejected or degraded request still terminates in a
receipt stating why (``RequestReceipt.reason``).
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.hardware import DeviceSpec
from repro_torch.obs.metrics import latency_summary
from repro_torch.serving.request import KIND_FFT, FFTRequest, RequestReceipt

# --------------------------------------------------------------------------
# degradation ladder
# --------------------------------------------------------------------------

RUNG_TUNED_DVFS = 0
RUNG_BOOST_HEURISTIC = 1
RUNG_PURE_TORCH = 2

RUNG_NAMES = ("tuned-dvfs", "boost-heuristic", "pure-torch")


def rung_name(rung: int) -> str:
    return RUNG_NAMES[min(max(rung, 0), len(RUNG_NAMES) - 1)]


def max_rung_for_kind(kind: str) -> int:
    """The deepest rung a kind can degrade to.

    Only plain FFT traffic has a pure-torch twin of its whole plan;
    the science kinds (fdas/pulsar) bottom out at boost-heuristic.
    """
    return RUNG_PURE_TORCH if kind == KIND_FFT else RUNG_BOOST_HEURISTIC


# --------------------------------------------------------------------------
# per-kind SLOs
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SLO:
    """The serving contract for one request kind.

    ``deadline_s`` is the end-to-end (queue + service) deadline the
    admission controller protects using *modelled* backlog time; the
    pressure thresholds are ratios of modelled backlog to that deadline:

      backlog > degrade_at      * deadline  ->  rung 1 (skip sweeps, boost)
      backlog > degrade_hard_at * deadline  ->  rung 2 (pure-torch)
      backlog > shed_at         * deadline  ->  shed ("admission:deadline")

    ``max_queue_transforms`` is a hard per-kind queue-depth cap (sheds
    with "admission:queue-full").  ``p99_latency_s`` and
    ``max_j_per_transform`` are *reporting* budgets — what
    :meth:`SLOPolicy.evaluate` scores receipts against.  Any None field
    disables that control.
    """

    p99_latency_s: float | None = None
    max_j_per_transform: float | None = None
    max_queue_transforms: int | None = None
    deadline_s: float | None = None
    degrade_at: float = 1.0
    degrade_hard_at: float | None = 2.0
    shed_at: float | None = 4.0


@dataclasses.dataclass(frozen=True)
class SLOPolicy:
    """Per-kind SLOs with a default for kinds not explicitly configured."""

    default: SLO = SLO()
    per_kind: dict = dataclasses.field(default_factory=dict)

    def for_kind(self, kind: str) -> SLO:
        return self.per_kind.get(kind, self.default)

    def evaluate(self, receipts: list[RequestReceipt]) -> dict:
        """Score served receipts against the per-kind reporting budgets.

        Returns ``{kind: {"n", "p99_latency_s", "p99_ok",
        "j_per_transform", "energy_ok", "degraded", "retried"}}`` —
        ``*_ok`` is None when the corresponding budget is unset.
        """
        by_kind: dict[str, list[RequestReceipt]] = {}
        for r in receipts:
            if r.status == "served":
                by_kind.setdefault(r.request.kind, []).append(r)
        out = {}
        for kind, rs in sorted(by_kind.items()):
            slo = self.for_kind(kind)
            p99 = latency_summary(r.latency for r in rs).p99
            transforms = sum(r.request.batch for r in rs)
            jpt = sum(r.energy_j for r in rs) / max(transforms, 1)
            out[kind] = {
                "n": len(rs),
                "p99_latency_s": p99,
                "p99_ok": (None if slo.p99_latency_s is None
                           else p99 <= slo.p99_latency_s),
                "j_per_transform": jpt,
                "energy_ok": (None if slo.max_j_per_transform is None
                              else jpt <= slo.max_j_per_transform),
                "degraded": sum(1 for r in rs if r.rung > 0),
                "retried": sum(1 for r in rs if r.retries > 0),
            }
        return out


# --------------------------------------------------------------------------
# admission control
# --------------------------------------------------------------------------

ADMIT = "admit"
DEGRADE = "degrade"
SHED = "shed"


@dataclasses.dataclass(frozen=True)
class AdmissionDecision:
    request: FFTRequest
    action: str                  # "admit" | "degrade" | "shed"
    rung: int                    # degradation rung the request executes at
    reason: str | None           # why it was degraded/shed (None for admit)


class AdmissionController:
    """Queue-depth / modelled-deadline admission control (load shedding).

    The controller walks the pending queue in FIFO order, accumulating the
    *modelled* backlog service time at the boost clock (so estimates never
    assume the energy-optimal slowdown is affordable).  Shapes whose sweep
    is already cached use the cached per-transform time; cold shapes fall
    back to a bandwidth-bound estimate (payload bytes x 4 HBM passes) —
    pessimistic, which is the right bias for admission.
    """

    #: HBM passes assumed for a shape with no cached sweep.
    COLD_PASSES = 4.0

    def __init__(self, policy: SLOPolicy, device: DeviceSpec):
        self.policy = policy
        self.device = device
        # Cumulative decision counters (service-lifetime).
        self.admitted = 0
        self.degraded = 0
        self.shed = 0

    def _estimate_s(self, req: FFTRequest, cache) -> float:
        entry = cache.peek(req.shape_key(self.device.name))
        if entry is not None:
            per_t, _ = entry.per_transform(entry.sweep.boost)
            return per_t * req.batch
        return req.bytes * self.COLD_PASSES / self.device.hbm_bandwidth

    def decide(self, pending: list[FFTRequest], cache
               ) -> list[AdmissionDecision]:
        """One decision per pending request, in FIFO order."""
        decisions: list[AdmissionDecision] = []
        backlog_s = 0.0                       # modelled boost-clock backlog
        depth: dict[str, int] = {}            # admitted transforms per kind
        for req in pending:
            slo = self.policy.for_kind(req.kind)
            est = self._estimate_s(req, cache)
            kind_depth = depth.get(req.kind, 0)
            if (slo.max_queue_transforms is not None
                    and kind_depth + req.batch > slo.max_queue_transforms):
                decisions.append(AdmissionDecision(
                    req, SHED, 0, "admission:queue-full"))
                self.shed += 1
                continue
            rung, reason = RUNG_TUNED_DVFS, None
            if slo.deadline_s is not None and slo.deadline_s > 0:
                ratio = (backlog_s + est) / slo.deadline_s
                if slo.shed_at is not None and ratio > slo.shed_at:
                    decisions.append(AdmissionDecision(
                        req, SHED, 0, "admission:deadline"))
                    self.shed += 1
                    continue
                if (slo.degrade_hard_at is not None
                        and ratio > slo.degrade_hard_at):
                    rung = min(RUNG_PURE_TORCH, max_rung_for_kind(req.kind))
                    reason = "admission:backlog-hard"
                elif ratio > slo.degrade_at:
                    rung = RUNG_BOOST_HEURISTIC
                    reason = "admission:backlog"
            backlog_s += est
            depth[req.kind] = kind_depth + req.batch
            if rung > RUNG_TUNED_DVFS:
                decisions.append(AdmissionDecision(req, DEGRADE, rung,
                                                   reason))
                self.degraded += 1
            else:
                decisions.append(AdmissionDecision(req, ADMIT, rung, None))
                self.admitted += 1
        return decisions
