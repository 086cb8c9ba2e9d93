"""Deterministic synthetic data (numpy copies of ``repro.data``).

  synthetic  pulsar filterbanks with dispersed, accelerated test tones
"""
from repro_torch.data.synthetic import (K_DM, FilterbankSpec, InjectedPulsar,
                                        synthetic_filterbank)

__all__ = ["K_DM", "FilterbankSpec", "InjectedPulsar", "synthetic_filterbank"]
