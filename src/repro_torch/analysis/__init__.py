"""The dry run's analysis layer (the counterpart of ``repro.analysis``):
cost counting of a step on ``meta`` tensors (``cost``, in place of the
reference's HLO analysis) and the roofline with its DVFS plan
(``roofline``)."""
from repro_torch.analysis.cost import analyze_step, collective_accounting
from repro_torch.analysis.roofline import (RooflineTerms, dvfs_plan,
                                           roofline_from_artifact)

__all__ = ["RooflineTerms", "analyze_step", "collective_accounting",
           "dvfs_plan", "roofline_from_artifact"]
