"""The rule by which a bf16 kernel output is held to its plain version."""
from __future__ import annotations

import torch


def bf16_ulps(got, want, floor):
    """Largest |got - want| in bf16 units in the last place at each
    element's magnitude (max(|got|, |want|)); a difference within
    ``floor``, the f32 limit, counts as 0: near zero the two f32 results,
    each rounded at the scale of its sum, round to bf16 at a finer grain
    than their own agreement."""
    a, b = got.float(), want.float()
    d = (a - b).abs()
    _, e = torch.frexp(torch.maximum(a.abs(), b.abs()))
    ulp = torch.ldexp(torch.ones_like(d), e - 8)  # 8 significant bits
    return float(torch.where(d <= floor, 0.0, d / ulp).max()) \
        if d.numel() else 0.0
