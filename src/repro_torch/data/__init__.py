"""Deterministic synthetic data (numpy copies of ``repro.data``).

  synthetic  token streams; pulsar filterbanks with dispersed,
             accelerated test tones
  arrivals   seeded request arrival times and their drain waves
"""
from repro_torch.data.arrivals import arrival_times, wave_slices
from repro_torch.data.synthetic import (K_DM, FilterbankSpec, InjectedPulsar,
                                        SyntheticTokens, synthetic_batches,
                                        synthetic_filterbank)

__all__ = ["K_DM", "FilterbankSpec", "InjectedPulsar", "SyntheticTokens",
           "arrival_times", "synthetic_batches", "synthetic_filterbank",
           "wave_slices"]
