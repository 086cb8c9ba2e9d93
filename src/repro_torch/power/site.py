"""Fleet-level site power-cap enforcement over governed pipelines (a copy
of ``repro.power.site``).

Barbosa et al. (2016): an SKA site has a *contracted* power envelope;
the computing must fit inside whatever the dishes and cryostats leave.
:class:`SiteBudgetScheduler` enforces a total site cap across a
simulated fleet by trading clock headroom between co-scheduled
pipelines:

  allocation   each active pipeline gets a power target
               ``floor + share`` where ``floor`` is its power at
               ``f_min`` and the remaining budget (after a safety
               ``headroom`` factor) is split in proportion to SLO
               priority, capped at the pipeline's full-boost draw;
  shedding     if even the floors don't fit, pipelines are shed
               lowest-priority-first until they do (a shed pipeline's
               device sits at ``f_min`` drawing idle power);
  feedback     each active device runs its own guarded
               :class:`repro_torch.power.governor.PowerGovernor` against its
               target, fed by watchdog-classified telemetry — a device
               with unhealthy sensors pins to its static sweep optimum
               (the fallback contract), it is not exempt from the cap;
  emergency    if estimated site power still breaches ``hard_cap_w``,
               the emergency rung fires: every active clock floors to
               ``f_min``, the lowest-priority pipeline is shed, and the
               budget is reallocated over the survivors.

Everything is deterministic for a given seed — the run digest hashes
per-tick clocks, health and membership, and must be identical across
fresh runs (a benchmark self-gate).
"""
from __future__ import annotations

import dataclasses
import hashlib

from repro_torch.core.hardware import DeviceSpec
from repro_torch.core.power_model import PowerModel
from repro_torch.power.governor import GovernorConfig, PowerGovernor
from repro_torch.power.sampler import SimulatedPowerSampler
from repro_torch.power.telemetry import FleetTelemetry


@dataclasses.dataclass(frozen=True)
class SitePipeline:
    """One co-scheduled pipeline: a device, a priority, an operating mix.

    ``priority`` ranks SLO importance — HIGHER survives longer under
    budget pressure (shed order is lowest first).  ``fallback_mhz`` is
    the pipeline's cached static sweep optimum (the
    ``dvfs.sweep().optimal`` clock), the governor's never-freewheel
    target.
    """

    name: str
    device_index: int
    priority: int
    fallback_mhz: float
    u_core: float = 1.0
    u_mem: float = 1.0


@dataclasses.dataclass(frozen=True)
class SiteTick:
    """One control tick's outcome for the whole site."""

    t: float
    clocks_mhz: tuple[float, ...]       # per pipeline (input order)
    targets_w: tuple[float, ...]        # 0.0 for shed pipelines
    truth_w: float                      # noiseless model site power
    estimated_w: float                  # telemetry-side site estimate
    active: tuple[str, ...]             # pipeline names still scheduled
    health: tuple[str, ...]             # per pipeline watchdog health
    modes: tuple[str, ...]              # per pipeline governor mode
    converged: bool
    emergency: bool                     # emergency rung fired THIS tick


class SiteBudgetScheduler:
    """Enforce a total site power cap across governed pipelines."""

    def __init__(
        self,
        device: DeviceSpec,
        pipelines: list[SitePipeline],
        *,
        site_cap_w: float,
        hard_cap_w: float | None = None,
        headroom: float = 0.92,
        convergence_tol_w: float = 3.0,
        seed: int = 0,
        noise_frac: float = 0.01,
        drift_w: float = 0.0,
        fault_plan=None,
        telemetry: FleetTelemetry | None = None,
        governor_config: GovernorConfig | None = None,
    ):
        if not pipelines:
            raise ValueError("need at least one pipeline")
        if len({p.device_index for p in pipelines}) != len(pipelines):
            raise ValueError("pipelines must use distinct devices")
        if not 0.0 < headroom <= 1.0:
            raise ValueError(f"headroom must be in (0, 1], got {headroom}")
        self.device = device
        self.pipelines = list(pipelines)
        self.site_cap_w = float(site_cap_w)
        self.hard_cap_w = float(hard_cap_w) if hard_cap_w is not None \
            else float(site_cap_w)
        self.headroom = headroom
        self.convergence_tol_w = convergence_tol_w
        self.power_model = PowerModel(device)
        self.governors = {
            p.name: PowerGovernor(device, target_w=0.0,
                                  fallback_mhz=p.fallback_mhz,
                                  config=governor_config)
            for p in pipelines
        }
        if telemetry is None:
            sampler = SimulatedPowerSampler(
                device, clock_fn=self._clock_of,
                utilisation_fn=self._util_of, seed=seed,
                noise_frac=noise_frac, drift_w=drift_w,
                fault_plan=fault_plan)
            telemetry = FleetTelemetry(device, sampler)
        self.telemetry = telemetry
        self.active: list[SitePipeline] = []
        self.shed: list[SitePipeline] = []
        self.targets: dict[str, float] = {}
        self.history: list[SiteTick] = []
        self.emergencies = 0
        self._tick_index = 0
        self.allocate()

    # ------------------------------------------------------------------ #
    # plant view (what each device is doing right now)
    # ------------------------------------------------------------------ #

    def _by_device(self, device_index: int) -> SitePipeline | None:
        for p in self.pipelines:
            if p.device_index == device_index:
                return p
        return None

    def _is_active(self, p: SitePipeline) -> bool:
        return any(q.name == p.name for q in self.active)

    def _clock_of(self, device_index: int) -> float:
        p = self._by_device(device_index)
        if p is None or not self._is_active(p):
            return self.device.f_min
        return self.governors[p.name].f_mhz

    def _util_of(self, device_index: int) -> tuple[float, float]:
        p = self._by_device(device_index)
        if p is None or not self._is_active(p):
            return (0.0, 0.0)       # shed: idle draw only
        return (p.u_core, p.u_mem)

    def _pipe_power(self, p: SitePipeline, f_mhz: float, *,
                    idle: bool = False) -> float:
        uc, um = (0.0, 0.0) if idle else (p.u_core, p.u_mem)
        return float(self.power_model.power(f_mhz, u_core=uc, u_mem=um))

    def truth_site_w(self) -> float:
        """Noiseless model power of the whole site at current clocks."""
        total = 0.0
        for p in self.pipelines:
            if self._is_active(p):
                total += self._pipe_power(p, self.governors[p.name].f_mhz)
            else:
                total += self._pipe_power(p, self.device.f_min, idle=True)
        return total

    # ------------------------------------------------------------------ #
    # budget allocation + shedding
    # ------------------------------------------------------------------ #

    def _shed_order(self, candidates: list[SitePipeline]) -> SitePipeline:
        """The next victim: lowest priority first, name as tiebreak."""
        return min(candidates, key=lambda p: (p.priority, p.name))

    def allocate(self) -> None:
        """(Re)split the budget over active pipelines; shed if needed."""
        budget = self.headroom * self.site_cap_w
        active = [p for p in self.pipelines
                  if not any(q.name == p.name for q in self.shed)]
        idle_w = {p.name: self._pipe_power(p, self.device.f_min, idle=True)
                  for p in self.pipelines}
        floor_w = {p.name: self._pipe_power(p, self.device.f_min)
                   for p in self.pipelines}
        # Shed until the floors (+ idle draw of shed devices) fit.
        while active:
            committed = (sum(floor_w[p.name] for p in active)
                         + sum(idle_w[p.name] for p in self.pipelines
                               if not any(q.name == p.name for q in active)))
            if committed <= budget or len(active) == 1:
                break
            victim = self._shed_order(active)
            active = [p for p in active if p.name != victim.name]
            self.shed.append(victim)
        self.active = active
        spare = budget - sum(floor_w[p.name] for p in active) \
            - sum(idle_w[p.name] for p in self.pipelines
                  if not self._is_active(p))
        spare = max(spare, 0.0)
        total_priority = sum(p.priority for p in active) or 1
        self.targets = {}
        for p in self.pipelines:
            if not self._is_active(p):
                self.targets[p.name] = 0.0
                continue
            boost = self._pipe_power(p, self.device.f_max)
            share = spare * p.priority / total_priority
            target = min(floor_w[p.name] + share, boost)
            self.targets[p.name] = target
            self.governors[p.name].set_target(target)

    def emergency(self) -> None:
        """Hard-cap breach rung: floor every clock, shed, reallocate."""
        self.emergencies += 1
        for p in self.active:
            gov = self.governors[p.name]
            gov.f_mhz = self.device.f_min
            gov.integral_w = 0.0
        if len(self.active) > 1:
            victim = self._shed_order(self.active)
            self.shed.append(victim)
        self.allocate()

    # ------------------------------------------------------------------ #
    # the control loop
    # ------------------------------------------------------------------ #

    def tick(self, t: float) -> SiteTick:
        """One site control tick at time ``t`` (seconds)."""
        token = self._tick_index
        self._tick_index += 1
        est = 0.0
        for p in self.pipelines:
            gov = self.governors[p.name]
            if not self._is_active(p):
                est += self._pipe_power(p, self.device.f_min, idle=True)
                continue
            tr = self.telemetry.read(p.device_index, t, token=token,
                                     f_mhz=gov.f_mhz, u_core=p.u_core,
                                     u_mem=p.u_mem)
            healthy = self.telemetry.healthy(p.device_index)
            gov.step(tr.measured_w, healthy=healthy)
            # Site estimate: trust fresh measurements, substitute the
            # model at the *pre-step* clock otherwise (never freewheel
            # the cap check on a lying sensor either).
            est += tr.measured_w if tr.measured_w is not None \
                else self._pipe_power(p, gov.f_mhz)
        fired = False
        if est > self.hard_cap_w:
            self.emergency()
            fired = True
            est = self.truth_site_w()   # post-rung model estimate
        truth = self.truth_site_w()
        tick = SiteTick(
            t=t,
            clocks_mhz=tuple(self._clock_of(p.device_index)
                             for p in self.pipelines),
            targets_w=tuple(self.targets[p.name] for p in self.pipelines),
            truth_w=truth,
            estimated_w=est,
            active=tuple(p.name for p in self.pipelines
                         if self._is_active(p)),
            health=tuple(self.telemetry.watchdog(p.device_index).health
                         for p in self.pipelines),
            modes=tuple(self.governors[p.name].mode
                        for p in self.pipelines),
            converged=self._converged(),
            emergency=fired,
        )
        self.history.append(tick)
        return tick

    def _converged(self) -> bool:
        """Every active device settled: on target, pinned, or fallback."""
        for p in self.active:
            gov = self.governors[p.name]
            if gov.in_fallback:
                continue            # pinned to static optimum: settled
            if gov.f_mhz in (self.device.f_min, self.device.f_max):
                continue            # railed at a clock bound: settled
            truth = self._pipe_power(p, gov.f_mhz)
            if abs(truth - self.targets[p.name]) > self.convergence_tol_w:
                return False
        return bool(self.active)

    def run(self, n_ticks: int, dt: float = 0.1) -> list[SiteTick]:
        """Run ``n_ticks`` control ticks; returns the tick history."""
        for k in range(n_ticks):
            self.tick(self._tick_index * dt)
        return self.history

    @property
    def first_converged_tick(self) -> int | None:
        for k, tick in enumerate(self.history):
            if tick.converged:
                return k
        return None

    def digest(self) -> str:
        """Reproducibility digest over the whole run's observable state."""
        h = hashlib.blake2b(digest_size=16)
        for tick in self.history:
            clocks = ",".join(f"{f:.3f}" for f in tick.clocks_mhz)
            h.update(f"{clocks}|{','.join(tick.health)}|"
                     f"{','.join(tick.active)}|{int(tick.emergency)}"
                     .encode())
        return h.hexdigest()
