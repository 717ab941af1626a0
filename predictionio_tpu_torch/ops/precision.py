"""The compute types the kernels take: the reference's
``ALSConfig.compute_dtype`` values, and the bfloat16 rounding every kernel
wrapper and plain twin applies where the reference casts (``astype``:
round to nearest, ties to even)."""

from __future__ import annotations

import torch

# the reference's ALSConfig.compute_dtype values
COMPUTE_DTYPES = ("float32", "bfloat16")


def is_bf16(compute_dtype: str) -> bool:
    """Whether ``compute_dtype`` asks for bfloat16 compute; raises for a
    value outside ``COMPUTE_DTYPES``."""
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of {COMPUTE_DTYPES}, got {compute_dtype!r}")
    return compute_dtype == "bfloat16"


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bfloat16 (to nearest, ties to even, as the
    reference's ``astype``) and widened back to float32."""
    return t.to(torch.bfloat16).to(torch.float32)


def in_cdt(t: torch.Tensor, bf16: bool) -> torch.Tensor:
    """``t`` in the compute type: rounded when ``bf16``, else as it is."""
    return round_bf16(t) if bf16 else t
