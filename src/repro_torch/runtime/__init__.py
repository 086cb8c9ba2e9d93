"""repro_torch.runtime — the port's runtime pieces (the counterpart of
``repro.runtime``): checkpoint/restart and straggler handling, the serving
fault plane (fault plans, breakers, retries, host fault domains), the
write-ahead request journal, the work-stealing queue and the elastic
re-mesh planner."""
from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.runtime.elastic import RemeshPlan, elastic_remesh_plan
from repro_torch.runtime.fault import (FaultTolerantDriver, SimulatedFailure,
                                       StragglerMonitor)
from repro_torch.runtime.faults import (CRASH_PROCESS, FAIL_CLOCK_LOCK,
                                        FAIL_PLAN_BUILD, KILL_DEVICE,
                                        KILL_HOST, STALL_WORKER,
                                        CircuitBreaker, ClockLockError,
                                        DeviceLostError, DrainDeadlineError,
                                        FaultError, FaultEvent, FaultPlan,
                                        HostLostError, HostTopology,
                                        PlanBuildError, ProcessCrashError,
                                        RetryPolicy, WorkerStalledError)
from repro_torch.runtime.journal import (JournalRecord, ReplayStats,
                                         RequestJournal, process_incarnation,
                                         read_journal)
from repro_torch.runtime.workqueue import WorkStealingQueue

__all__ = ["CheckpointManager", "CircuitBreaker", "ClockLockError",
           "CRASH_PROCESS", "DeviceLostError", "DrainDeadlineError",
           "elastic_remesh_plan",
           "FAIL_CLOCK_LOCK", "FAIL_PLAN_BUILD", "FaultError", "FaultEvent",
           "FaultPlan", "FaultTolerantDriver", "HostLostError",
           "HostTopology", "JournalRecord", "KILL_DEVICE", "KILL_HOST",
           "PlanBuildError", "ProcessCrashError", "RemeshPlan", "ReplayStats",
           "RequestJournal", "RetryPolicy", "STALL_WORKER",
           "SimulatedFailure", "StragglerMonitor", "WorkerStalledError",
           "process_incarnation", "read_journal", "WorkStealingQueue"]
