"""Torch oracle for the dedispersion kernel (tests and the chip check).

Definition (zero-padded convention):

  out[..., d, t] = sum_c  x[..., c, t + delay[d, c]]   with x[..., c, i] = 0
                                                       for i >= ntime

implemented with one gather of the whole (D, C, N) index set, as the
reference's ``take_along_axis`` oracle does.
"""
from __future__ import annotations

import numpy as np
import torch


def dedisperse_ref(fb: torch.Tensor, delays) -> torch.Tensor:
    """(..., C, N) filterbanks + (D, C) delays -> (..., D, N)."""
    delays = torch.as_tensor(np.asarray(delays, dtype=np.int64),
                             device=fb.device)
    n = fb.shape[-1]
    idx = delays[:, :, None] + torch.arange(n, device=fb.device)  # (D, C, N)
    valid = idx < n
    shape = (*fb.shape[:-2], *idx.shape)                    # (..., D, C, N)
    g = torch.gather(fb[..., None, :, :].expand(shape), -1,
                     idx.clamp(0, n - 1).expand(shape))
    return torch.where(valid, g, 0.0).sum(dim=-2)
