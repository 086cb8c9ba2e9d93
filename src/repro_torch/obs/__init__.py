"""repro_torch.obs — the port's observability plane (so far: the launch
ledger, :mod:`repro_torch.obs.ledger`, and the latency summary of
:mod:`repro_torch.obs.metrics`)."""
from repro_torch.obs.ledger import (LaunchLedger, LaunchRecord,
                                    launches_digest, record_launch)

__all__ = ["LaunchLedger", "LaunchRecord", "launches_digest",
           "record_launch"]
