"""Pulsar searching on the port's FFT substrate.

  templates  acceleration responses + TemplateBank (host-side numpy,
             cached; a copy of the reference's)
  fdas       matched-filter plane, power, candidate extraction, and the
             end-to-end fdas_search() acceleration search

The counterpart of ``repro.search`` for the FDAS search of White, Adámek
& Armour (2022).  The reference's ``sift`` and ``pipeline`` (the full
pulsar-search graph) arrive with the pulsar-pipeline slice of the port.
"""
from repro_torch.search.fdas import (Candidates, FDASResult,
                                     extract_candidates, fdas_conv_plan,
                                     fdas_search, matched_filter_plane,
                                     power_plane, serving_candidates)
from repro_torch.search.templates import (TemplateBank,
                                          acceleration_response,
                                          matched_filter_taps)

__all__ = [
    "Candidates", "FDASResult", "TemplateBank", "acceleration_response",
    "extract_candidates", "fdas_conv_plan", "fdas_search",
    "matched_filter_plane", "matched_filter_taps", "power_plane",
    "serving_candidates",
]
