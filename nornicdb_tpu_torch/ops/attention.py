"""Exact flash attention: wrapper of ``csrc/flash_attention.cu``.

Counterpart of ``nornicdb_tpu/ops/pallas_attention.py:flash_attention``,
same ``[B, S, H, Dh]`` layout in and out. On a CUDA tensor the wrapper
launches the kernel or raises: bfloat16 inputs go to the tensor-core
kernel, float32 inputs to the exact float32 one, which runs on the FMA
units only. ``reference_attention`` (the materializing softmax) is its
plain version and runs only for tensors on the CPU. Forward only, like
the TPU kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from nornicdb_tpu_torch.ops import _build

NEG_INF = -1e30
HEAD_DIMS = (16, 40, 64)  # compiled head widths: tiny, mini, bge-m3-like encoders


def reference_attention(q, k, v, mask=None):
    """Naive [S, S]-materializing softmax attention in float32."""
    b, s, h, d = q.shape
    if mask is None:
        mask = torch.ones((b, s), dtype=torch.bool, device=q.device)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (d ** -0.5)
    logits = torch.where(mask[:, None, None, :], logits,
                         torch.full_like(logits, NEG_INF))
    weights = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", weights, v.float())
    return out.to(q.dtype)


def _lib() -> ctypes.CDLL:
    return bind(_build.library("flash_attention"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signature of a loaded ``flash_attention`` library."""
    if lib.nornic_flash_attention.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        lib.nornic_flash_attention.argtypes = [
            p, p, p, p, p, i, i, i, i, ctypes.c_float, i, p]
        lib.nornic_flash_attention.restype = ctypes.c_int
    return lib


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Exact attention without the [S, S] matrix. q, k, v: [B, S, H, Dh];
    mask: [B, S] bool over keys (True = attend). Returns [B, S, H, Dh]."""
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError("q, k and v must share one [B, S, H, Dh] shape")
    b, s, h, d = q.shape
    if mask is None:
        mask = torch.ones((b, s), dtype=torch.bool, device=q.device)
    if mask.shape != (b, s):
        raise ValueError(f"mask must be [{b}, {s}], got {tuple(mask.shape)}")
    dev = q.device
    if k.device != dev or v.device != dev or mask.device != dev:
        raise ValueError("q, k, v and mask must be on one device")
    if dev.type == "cpu":
        return reference_attention(q, k, v, mask)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError("q, k and v must all be float32 or all bfloat16")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if b * h > 65535:
        raise ValueError("B*H must be at most 65535")
    if mask.dtype != torch.bool:
        raise ValueError("mask must be bool")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()
            and mask.is_contiguous()):
        raise ValueError("q, k, v and mask must be contiguous")
    out = launch(_lib(), q, k, v, mask)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def launch(lib: ctypes.CDLL, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           mask: torch.Tensor) -> torch.Tensor:
    """One call of ``lib``'s kernel on checked, contiguous CUDA inputs.
    Counts nothing."""
    b, s, h, d = q.shape
    # both kernels load 16 bytes at a time
    q, k, v = (x if x.data_ptr() % 16 == 0 else x.clone() for x in (q, k, v))
    out = torch.empty_like(q)
    err = lib.nornic_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr(),
        b, s, h, d, float(d ** -0.5), int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, "flash_attention kernel")
    return out
