"""Device selection for the port's entry points.

Entry points run on the GPU unless the caller asks for the CPU. With no GPU
and no explicit CPU request they raise instead of continuing on the CPU, so
a run that was meant for the card can never report CPU numbers.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` -> ``cuda`` (raises without a GPU); otherwise the device
    asked for, checked to exist."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (--device cpu) "
            "to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def exact_fp32():
    """Turn TF32 off for matmuls and cuDNN convs: the port's parity paths
    are fp32 (cuDNN defaults convs to TF32, which keeps ~3 digits)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
