"""Int8 row quantization and the int4 split-nibble packing, in PyTorch
(counterpart of vector_store_tpu/core/quantize.py).

Symmetric per-row scaling: `q = round(x / scale)`, `scale = max|x| / 127`,
with the scale kept beside the row.  `torch.round` rounds half to even,
as `jnp.round` does, so the codes match the JAX package's.

The int4 codes are derived from the int8 codes (q4 = round(q8 * 7/127),
scale4 = scale8 * 127/7) and packed in the split layout: byte j holds dim j
in its low nibble and dim j + D/2 in its high nibble.  The pool-scan
kernel's packed mode (csrc/ivf_scan.cu) reads that layout.
"""

from __future__ import annotations

import torch

_EPS = 1e-12


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[N, D] f32 -> (values [N, D] int8, scales [N] f32)."""
    x = x.float()
    absmax = torch.amax(torch.abs(x), dim=-1)
    scale = torch.clamp(absmax, min=_EPS) / 127.0
    q = torch.clamp(torch.round(x / scale[:, None]), -127, 127).to(torch.int8)
    return q, scale


def dequantize_rows(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """(values int8, scales) -> f32; scale broadcast over the last dim."""
    return q.float() * scale[..., None]


def pack_int4_from_int8(q8: torch.Tensor) -> torch.Tensor:
    """int8 codes [..., D] (D even) -> packed int4 [..., D/2] uint8."""
    d = q8.shape[-1]
    q4 = torch.clamp(torch.round(q8.float() * (7.0 / 127.0)), -7, 7).to(torch.int32)
    lo = q4[..., : d // 2] & 0x0F
    hi = q4[..., d // 2 :] & 0x0F
    return (lo | (hi << 4)).to(torch.uint8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Packed [..., D/2] uint8 -> int4 codes [..., D] int8 (split layout).

    Each nibble is sign-extended as `(n ^ 8) - 8`, in int32 so no shift
    of a negative int8 is involved."""
    x = packed.to(torch.int32)
    lo = ((x & 0x0F) ^ 8) - 8
    hi = (((x >> 4) & 0x0F) ^ 8) - 8
    return torch.cat([lo, hi], dim=-1).to(torch.int8)


def int4_scale(scale8: torch.Tensor) -> torch.Tensor:
    """Dequant scale of the derived int4 codes."""
    return scale8 * (127.0 / 7.0)
