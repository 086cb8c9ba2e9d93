"""Deterministic synthetic pulsar filterbanks (a numpy copy of the
filterbank half of ``repro.data.synthetic``).

The radio-astronomy front half of the real-time pipeline the paper's
Sec. 5 targets: (nchan, ntime) dynamic spectra whose injected pulsars
arrive with the cold-plasma dispersion delay

    dt(DM, f) = K_DM * DM * (f^-2 - f_ref^-2)     [s, f in MHz]

rounded to integer samples.  Injection uses exactly the rounded delays a
:class:`repro_torch.search.pipeline.DispersionPlan` trial computes, so a
pulsar injected at a trial DM dedisperses back into perfect channel
alignment.  The output is bit-identical to the reference's for a seed.
The token streams of the reference module arrive with the model zoo.
"""
from __future__ import annotations

import dataclasses

import numpy as np

#: Cold-plasma dispersion constant, s * MHz^2 * (pc cm^-3)^-1.
K_DM = 4.148808e3


@dataclasses.dataclass(frozen=True)
class FilterbankSpec:
    """Geometry of one filterbank block (the telescope side of Sec. 2.3).

    ``nchan`` frequency channels spanning [f_lo, f_hi] MHz (channel 0 is
    the highest frequency — the earliest arrival, so all dispersion
    delays are >= 0), sampled every ``tsamp`` seconds for ``ntime``
    samples.  ``t_acquire = ntime * tsamp`` is the real-time budget one
    block must be processed within.
    """

    nchan: int = 32
    ntime: int = 4096
    f_lo: float = 1300.0       # MHz, bottom of the band
    f_hi: float = 1500.0       # MHz, top of the band (reference: no delay)
    tsamp: float = 64e-6       # s per sample

    def __post_init__(self):
        if self.nchan < 1 or self.ntime < 1:
            raise ValueError(
                f"filterbank needs nchan/ntime >= 1, got "
                f"{self.nchan}/{self.ntime}")
        if not 0 < self.f_lo < self.f_hi:
            raise ValueError(
                f"need 0 < f_lo < f_hi, got [{self.f_lo}, {self.f_hi}] MHz")
        if self.tsamp <= 0:
            raise ValueError(f"tsamp must be > 0, got {self.tsamp}")

    @property
    def freqs_mhz(self) -> np.ndarray:
        """(nchan,) channel centres, descending from f_hi to f_lo."""
        return np.linspace(self.f_hi, self.f_lo, self.nchan)

    @property
    def t_acquire(self) -> float:
        """Seconds of sky one block holds (the real-time envelope)."""
        return self.ntime * self.tsamp

    @property
    def dm_step(self) -> float:
        """DM spacing giving ~1 sample of differential delay across the
        band — the classic 'diagonal DM' trial step."""
        span = self.f_lo ** -2 - self.f_hi ** -2
        return self.tsamp / (K_DM * span)

    def delay_seconds(self, dm: float) -> np.ndarray:
        """(nchan,) dispersion delays relative to the top of the band."""
        return K_DM * dm * (self.freqs_mhz ** -2 - self.f_hi ** -2)

    def delay_samples(self, dm: float) -> np.ndarray:
        """(nchan,) integer-sample delays — the grid both injection and
        the dedispersion kernel shift by (so they cancel exactly)."""
        return np.rint(self.delay_seconds(dm) / self.tsamp).astype(np.int64)


@dataclasses.dataclass(frozen=True)
class InjectedPulsar:
    """Ground truth for one injected accelerated pulsar.

    ``k0`` is the spin-frequency Fourier bin at the start of the block
    and ``z`` the Fourier-domain drift in bins over the block (the FDAS
    template axis); ``dm`` should be a DispersionPlan trial value for
    sample-exact dedispersion.
    """

    dm: float                  # pc cm^-3
    k0: int                    # Fourier bin of the spin frequency
    z: float = 0.0             # drift in bins over the block (acceleration)
    amp: float = 0.05          # per-channel tone amplitude
    phase: float = 0.0         # radians


def synthetic_filterbank(
    spec: FilterbankSpec,
    pulsars: tuple[InjectedPulsar, ...] = (),
    *,
    noise: float = 1.0,
    seed: int = 0,
) -> np.ndarray:
    """(nchan, ntime) float32 dynamic spectrum with dispersed test tones.

    Each pulsar is a linear chirp  cos(2*pi*(k0*s + z/2*s^2) + phase)
    with s = (t - delay_c)/ntime per channel — the same waveform in every
    channel, shifted by that channel's rounded integer delay, so
    dedispersing at the pulsar's DM re-aligns all channels exactly.
    ``noise=0`` gives a clean template for kernel parity tests.
    """
    rng = np.random.default_rng(seed)
    x = (noise * rng.standard_normal((spec.nchan, spec.ntime))
         if noise else np.zeros((spec.nchan, spec.ntime)))
    t = np.arange(spec.ntime)[None, :]
    for p in pulsars:
        delays = spec.delay_samples(p.dm)[:, None]
        s = (t - delays) / spec.ntime
        x += p.amp * np.cos(2 * np.pi * (p.k0 * s + 0.5 * p.z * s * s)
                            + p.phase)
    return x.astype(np.float32)
