"""Torch oracles for the harmonic-sum kernels (tests and the chip check).

Definition (zero-padded convention):

  S_h[k] = sum_{j=1..h} P[j*k]   with P[i] = 0 for i >= N

Output levels h = 1, 2, 4, ..., n_harmonics (the standard pulsar-search
doubling ladder), summed by a gather of each rung's harmonics, as the
reference's oracle does.
"""
from __future__ import annotations

import math

import torch


def harmonic_sum_ref(power: torch.Tensor, n_harmonics: int) -> torch.Tensor:
    n = power.shape[-1]
    levels = int(math.log2(n_harmonics)) + 1
    k = torch.arange(n, device=power.device)
    outs = [power]
    acc = power
    h = 1
    for _ in range(levels - 1):
        h *= 2
        js = torch.arange(h // 2 + 1, h + 1, device=power.device)
        idx = js[:, None] * k[None, :]                     # (h/2, n)
        gathered = torch.where(idx < n, power[..., idx.clamp(max=n - 1)],
                               0.0)
        acc = acc + gathered.sum(dim=-2)
        outs.append(acc)
    return torch.stack(outs, dim=-2)


def harmonic_sum_plane_ref(power: torch.Tensor, n_harmonics: int):
    """Oracle for the plane kernel: (best statistic, int32 level index).

    Normalises every ladder level to  z_h = (S_h - h) / sqrt(h)  and
    takes the maximum (the earliest level wins ties).
    """
    ladder = harmonic_sum_ref(power, n_harmonics)          # (..., L, n)
    hs = torch.tensor([2.0 ** lev for lev in range(ladder.shape[-2])],
                      device=power.device)
    z = (ladder - hs[:, None]) / torch.sqrt(hs)[:, None]
    best, best_lev = z.max(dim=-2)
    return best, best_lev.to(torch.int32)
