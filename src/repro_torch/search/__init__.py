"""Pulsar searching on the port's FFT substrate.

  templates  acceleration responses + TemplateBank (host-side numpy,
             cached; a copy of the reference's)
  fdas       matched-filter plane, power, candidate extraction, and the
             end-to-end fdas_search() acceleration search
  sift       candidate sifting/clustering (threshold, DM/harmonic
             dedupe, top-k) — the pipeline's last stage; pools merged
             across blocks of DM trials; a threshold from a false-alarm
             rate over the searched volume
  pipeline   the full real-time search: dedispersion -> fdas ->
             harmonic sum -> sift, in blocks of DM trials where the grid
             does not fit the card, with per-stage DVFS planning
  reference  a plain float64 torch search, the tests' and the
             benchmark's oracle (imports nothing of the port)

The counterpart of ``repro.search``: the search workload of White, Adámek
& Armour (2022), downstream of the paper's Sec. 5.3 discussion.
"""
from repro_torch.search.fdas import (Candidates, FDASResult,
                                     extract_candidates, fdas_conv_plan,
                                     fdas_search, matched_filter_plane,
                                     power_plane, serving_candidates)
from repro_torch.search.pipeline import (BlockResult, DispersionPlan,
                                         PulsarSearch, PulsarSearchResult,
                                         PulsarStagePlan, plan_pulsar_stages,
                                         pulsar_search, serving_sifted)
from repro_torch.search.sift import (CandidatePool, SiftedCandidates,
                                     merge_pools, sift_candidates,
                                     sift_threshold)
from repro_torch.search.templates import (TemplateBank,
                                          acceleration_response,
                                          matched_filter_taps)

__all__ = [
    "BlockResult", "CandidatePool", "Candidates", "DispersionPlan",
    "FDASResult", "PulsarSearch", "PulsarSearchResult",
    "PulsarStagePlan", "SiftedCandidates", "TemplateBank",
    "acceleration_response", "extract_candidates", "fdas_conv_plan",
    "fdas_search", "matched_filter_plane", "matched_filter_taps",
    "plan_pulsar_stages", "power_plane", "pulsar_search",
    "merge_pools", "serving_candidates", "serving_sifted",
    "sift_candidates", "sift_threshold",
]
