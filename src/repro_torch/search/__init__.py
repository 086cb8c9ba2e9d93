"""Pulsar searching on the port's FFT substrate.

  templates  acceleration responses + TemplateBank (host-side numpy,
             cached; a copy of the reference's)
  fdas       matched-filter plane, power, candidate extraction, and the
             end-to-end fdas_search() acceleration search
  sift       candidate sifting/clustering (threshold, DM/harmonic
             dedupe, top-k) — the pipeline's last stage
  pipeline   the full real-time search: dedispersion -> fdas ->
             harmonic sum -> sift, with per-stage DVFS planning

The counterpart of ``repro.search``: the search workload of White, Adámek
& Armour (2022), downstream of the paper's Sec. 5.3 discussion.
"""
from repro_torch.search.fdas import (Candidates, FDASResult,
                                     extract_candidates, fdas_conv_plan,
                                     fdas_search, matched_filter_plane,
                                     power_plane, serving_candidates)
from repro_torch.search.pipeline import (DispersionPlan, PulsarSearchResult,
                                         PulsarStagePlan, plan_pulsar_stages,
                                         pulsar_search, serving_sifted)
from repro_torch.search.sift import SiftedCandidates, sift_candidates
from repro_torch.search.templates import (TemplateBank,
                                          acceleration_response,
                                          matched_filter_taps)

__all__ = [
    "Candidates", "DispersionPlan", "FDASResult", "PulsarSearchResult",
    "PulsarStagePlan", "SiftedCandidates", "TemplateBank",
    "acceleration_response", "extract_candidates", "fdas_conv_plan",
    "fdas_search", "matched_filter_plane", "matched_filter_taps",
    "plan_pulsar_stages", "power_plane", "pulsar_search",
    "serving_candidates", "serving_sifted", "sift_candidates",
]
