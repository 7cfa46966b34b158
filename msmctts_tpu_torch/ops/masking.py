"""Length-mask utilities (counterpart of ``msmctts_tpu/ops/masking.py``).

``sequence_mask`` is True at *valid* positions; position ids are 1-based
with 0 at padding (reference msmc_vqgan.py:56-58).
"""

from __future__ import annotations

import torch


def sequence_mask(lengths: torch.Tensor, max_len: int, dtype=torch.bool) -> torch.Tensor:
    """[B] lengths -> [B, max_len] mask, True where t < length."""
    pos = torch.arange(max_len, device=lengths.device)[None, :]
    return (pos < lengths.long()[:, None]).to(dtype)


def positions_from_lengths(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """1-based position ids [B, max_len] (int64), 0 at padding."""
    pos = torch.arange(1, max_len + 1, device=lengths.device)[None, :]
    return pos * sequence_mask(lengths, max_len, dtype=torch.long)
