"""Fourier-domain acceleration response templates (FDAS).

A numpy-only copy of ``repro.search.templates``: the port keeps its own
copy, and its taps are bit-identical to the reference's.

A binary pulsar's orbital acceleration makes its spin frequency drift
during an observation; in the Fourier domain the power that a plain FFT
would concentrate in one bin smears across ``z`` neighbouring bins, where
``z`` is the number of bins drifted over the observation.  The
correlation technique (Ransom, Eigenbrode & Middleditch 2002; the GPU
formulation is White, Adámek & Armour 2022) recovers it by
matched-filtering the complex spectrum with the known response of an
accelerated tone — one short filter per trial acceleration.

The response for drift ``z`` at bin offset ``u`` is the DFT of a
unit-amplitude linear chirp,

    c(τ) = exp(iπ z τ²),   τ ∈ [0, 1)
    t_z[u] = ∫ c(τ) · exp(-2πi u τ) dτ ,

evaluated here as an ``oversample``-point Riemann sum via one numpy FFT
(the classical Fresnel-integral closed form, without scipy).  Everything
is host-side numpy, memoised per (z, taps, oversample) — the same
discipline as the twiddle and Bluestein caches.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np

#: Default sample count for the chirp DFT; the Riemann-sum error of the
#: response is O(z²/oversample), negligible for |z| << oversample.
DEFAULT_OVERSAMPLE = 4096


@functools.lru_cache(maxsize=None)
def acceleration_response(z: float, taps: int,
                          oversample: int = DEFAULT_OVERSAMPLE) -> np.ndarray:
    """Complex response t_z[u] on the centred window u ∈ [-taps//2, ...).

    A length-n time series whose tone starts at bin k0 and drifts z bins
    has spectrum X[k] ≈ A · t_z[k - k0] (A the tone amplitude times n),
    so correlating X against t_z concentrates the smeared power back into
    one bin.  The window must cover the drift: taps ≥ |z| plus sidelobe
    margin (see :meth:`TemplateBank.linear`).
    """
    if taps < 1:
        raise ValueError(f"template needs >= 1 taps, got {taps}")
    if taps > oversample:
        raise ValueError(
            f"taps={taps} exceeds the chirp resolution ({oversample})")
    tau = np.arange(oversample) / oversample
    chirp = np.exp(1j * np.pi * z * tau * tau)
    spectrum = np.fft.fft(chirp) / oversample
    u = np.arange(taps) - taps // 2                  # centred window
    return spectrum[u % oversample]


def matched_filter_taps(z: float, taps: int,
                        oversample: int = DEFAULT_OVERSAMPLE) -> np.ndarray:
    """Unit-energy convolution taps correlating a spectrum with t_z.

    The conjugate-reversed response window: with the FULL convolution
    ``conv`` of :func:`repro_torch.fft.convolve.overlap_save_conv`,

        conv[b + taps - 1 - taps//2] = Σ_u X[b + u] · conj(t_z[u]) / ||t_z||

    over the whole centred window — consumers trim
    ``taps - 1 - taps//2`` leading points (``TemplateBank.offset``).
    """
    t = acceleration_response(z, taps, oversample)
    h = np.conj(t)[::-1]
    norm = np.sqrt(np.sum(np.abs(h) ** 2))
    return h / max(norm, 1e-30)


@dataclasses.dataclass(frozen=True)
class TemplateBank:
    """A bank of acceleration-trial matched filters.

    Hashable and frozen, so it can key caches; the heavy artefacts (time-domain taps, per-segment-length spectra) live in the
    module-level caches keyed on the bank's defining parameters, never on
    array contents.
    """

    drifts: tuple[float, ...]          # trial drifts z, in Fourier bins
    taps: int                          # filter length, bins
    oversample: int = DEFAULT_OVERSAMPLE

    @classmethod
    def linear(cls, zmax: float, n_templates: int | None = None,
               taps: int | None = None) -> "TemplateBank":
        """Evenly spaced trials over z ∈ [-zmax, zmax].

        Defaults follow the standard search grid: one template per bin of
        drift (2·zmax + 1 trials) and a window wide enough for the
        largest drift plus sidelobes.
        """
        if zmax < 0:
            raise ValueError(f"zmax must be >= 0, got {zmax}")
        if n_templates is None:
            n_templates = 2 * int(round(zmax)) + 1
        if n_templates < 1:
            raise ValueError(f"bank needs >= 1 templates, got {n_templates}")
        if n_templates == 1:
            drifts: tuple[float, ...] = (0.0,)
        else:
            drifts = tuple(float(z) for z in
                           np.linspace(-zmax, zmax, n_templates))
        if taps is None:
            taps = max(32, 2 * int(np.ceil(zmax)) + 16)
        return cls(drifts=drifts, taps=taps)

    @property
    def n_templates(self) -> int:
        return len(self.drifts)

    @property
    def offset(self) -> int:
        """Leading convolution points to trim (the centred-window shift)."""
        return self.taps - 1 - self.taps // 2

    @property
    def key(self) -> tuple:
        """Cache key identifying this bank's tap values."""
        return ("fdas-bank", self.drifts, self.taps, self.oversample)

    def time_domain(self) -> np.ndarray:
        """(T, taps) unit-energy matched-filter taps (host-side numpy)."""
        return np.stack([matched_filter_taps(z, self.taps, self.oversample)
                         for z in self.drifts])
