"""Roundings that emulate a lower precision inside f32 / f64 arithmetic.

`exact` leaves a value as it is. `tf32` keeps 10 mantissa bits, as a
tensor core rounds a TF32 operand, to nearest (ties away from zero), and
returns the input's dtype, so a function that takes `rnd` computes in
that precision wherever it rounds its operands. `bf16` keeps 7 bits the
same way.
"""
from __future__ import annotations

import numpy as np
import torch


def exact(x):
    return x


def _round_bits(x, drop: int):
    """x with the low `drop` bits of its float32 mantissa rounded off."""
    if isinstance(x, torch.Tensor):
        f = x.to(torch.float32).contiguous()
        i = f.view(torch.int32)
        half = 1 << (drop - 1)
        mask = ~((1 << drop) - 1)
        r = ((i + half) & mask).view(torch.float32)
        return r.to(x.dtype)
    a = np.asarray(x)
    f = a.astype(np.float32)
    i = f.view(np.int32)
    r = ((i + np.int32(1 << (drop - 1))) & np.int32(~((1 << drop) - 1))
         ).view(np.float32)
    return r.astype(a.dtype)


def tf32(x):
    return _round_bits(x, 13)


def bf16(x):
    return _round_bits(x, 16)
