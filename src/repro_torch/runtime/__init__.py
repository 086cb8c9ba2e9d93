"""repro_torch.runtime — the port's runtime pieces (so far: the
work-stealing queue the serving dispatcher balances devices with)."""
from repro_torch.runtime.workqueue import WorkStealingQueue

__all__ = ["WorkStealingQueue"]
