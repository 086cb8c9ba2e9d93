"""Deterministic synthetic data: token streams and pulsar filterbanks (a
numpy copy of ``repro.data.synthetic``).

Token stream — a seeded, stateless batch generator: batch ``i`` is a pure
function of (seed, i, host), so any host can regenerate any shard and a
restart from a checkpoint needs no data-loader state.  The "text" is a
mixture of Zipf-distributed unigrams and short repeated motifs, enough
signal for loss-goes-down checks.

Filterbank — the radio-astronomy front half of the real-time pipeline the paper's
Sec. 5 targets: (nchan, ntime) dynamic spectra whose injected pulsars
arrive with the cold-plasma dispersion delay

    dt(DM, f) = K_DM * DM * (f^-2 - f_ref^-2)     [s, f in MHz]

rounded to integer samples.  Injection uses exactly the rounded delays a
:class:`repro_torch.search.pipeline.DispersionPlan` trial computes, so a
pulsar injected at a trial DM dedisperses back into perfect channel
alignment.  Every output is bit-identical to the reference's for a seed.
"""
from __future__ import annotations

import dataclasses

import numpy as np

#: Cold-plasma dispersion constant, s * MHz^2 * (pc cm^-3)^-1.
K_DM = 4.148808e3


@dataclasses.dataclass(frozen=True)
class SyntheticTokens:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0

    def batch(self, index: int, *, host_id: int = 0, n_hosts: int = 1
              ) -> np.ndarray:
        """Host-sharded batch ``index`` -> (global_batch/n_hosts, seq+1)."""
        per_host = self.global_batch // n_hosts
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, index, host_id]))
        # Zipf unigrams clipped to vocab
        base = rng.zipf(1.3, size=(per_host, self.seq_len + 1))
        toks = np.minimum(base - 1, self.vocab - 1).astype(np.int32)
        # motif: every sequence repeats a short pattern (learnable signal)
        motif_len = 8
        motif = rng.integers(0, self.vocab, size=(per_host, motif_len))
        reps = (self.seq_len + 1 + motif_len - 1) // motif_len
        tiled = np.tile(motif, (1, reps))[:, : self.seq_len + 1]
        mask = rng.random((per_host, self.seq_len + 1)) < 0.5
        return np.where(mask, tiled, toks).astype(np.int32)


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


def synthetic_batches(vocab: int, seq_len: int, global_batch: int,
                      n_steps: int, *, seed: int = 0, host_id: int = 0,
                      n_hosts: int = 1):
    """Generator of (inputs, labels) numpy pairs."""
    ds = SyntheticTokens(vocab, seq_len, global_batch, seed)
    for i in range(n_steps):
        b = ds.batch(i, host_id=host_id, n_hosts=n_hosts)
        yield b[:, :-1], b[:, 1:]
