"""The port's device rule.

Every entry point takes ``device=None``, which means ``"cuda"``. Without a
card the caller must ask for the CPU explicitly (``device="cpu"``, as the
tests do); the port never carries on quietly on the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``. Raises when CUDA is asked for and missing."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "nornicdb_tpu_torch needs a CUDA device; pass device='cpu' "
                "to run on the CPU")
        # The slice is exact float32 (the mini encoder is f32 and the
        # brute-force tier is exact): TF32 keeps ~3 decimal digits, so it
        # is off for matmuls and for cuDNN alike.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
