"""Torch oracle for the fused power-spectrum + stats kernel."""
from __future__ import annotations

import torch


def power_spectrum_stats_ref(re: torch.Tensor, im: torch.Tensor):
    """(B, N) re/im spectrum -> (power (B,N), mean (B,), std (B,)).

    power = |X|^2 / N; mean/std (population) taken over each row.
    """
    n = re.shape[-1]
    p = (re.to(torch.float32) ** 2 + im.to(torch.float32) ** 2) / n
    return p, p.mean(dim=-1), p.std(dim=-1, correction=0)
