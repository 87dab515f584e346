"""The exact three-term bf16 split of an f32 tensor (``csrc/bf16_split.cu``).

:func:`tfkaldi_tpu_torch.layers.product`'s tensor-core backward feeds the
f32 cotangent to bf16 GEMMs as three bf16 terms, laid out for them: rows
and columns padded with zeros to multiples of 8 (cuBLAS takes its Hopper
kernels only for contractions and output widths of whole 16 bytes). On a
CUDA tensor :func:`split3` launches the kernel (one pass, 10 bytes an
element); on any other it runs :func:`split3_ref`, the plain version, which
the kernel equals bit for bit.
"""

from __future__ import annotations

import contextlib

import torch

from tfkaldi_tpu_torch.ops import _build

ALIGN = 8  # bf16 elements in 16 bytes
launches_by_route = {"vec4": 0, "scalar": 0}  # kernel launches since the last reset, by how g is read


def padded(size: int) -> int:
    """``size`` rounded up to a multiple of :data:`ALIGN`."""
    return -(-size // ALIGN) * ALIGN


def split3_ref(g: torch.Tensor) -> torch.Tensor:
    """f32 ``g [..., M, N]`` → bf16 ``[..., M8, 3·N8]`` (``M8``, ``N8``:
    :func:`padded`), the blocks ``[g1 | g2 | g3]`` of ``N8`` columns with
    ``g1 = bf16(g)``, ``g2 = bf16(g − g1)``, ``g3 = bf16(g − g1 − g2)`` in
    their first ``M`` rows and ``N`` columns and zeros elsewhere: 24
    significand bits in three of 8, so ``g1 + g2 + g3 == g`` bit for bit
    where every term is a normal bf16 (|g| from 2^-103 up to bf16's largest
    finite value). Each subtraction is exact in f32."""
    *lead, m, n = g.shape
    out = torch.zeros(*lead, padded(m), 3, padded(n), dtype=torch.bfloat16, device=g.device)
    g1, g2, g3 = out[..., :m, :, :n].unbind(-2)
    g1.copy_(g)
    rest = g - g1
    g2.copy_(rest)
    rest.sub_(g2)
    g3.copy_(rest)
    return out.flatten(-2)


def split3(g: torch.Tensor) -> torch.Tensor:
    """:func:`split3_ref`'s result; one kernel launch on a CUDA tensor."""
    if g.device.type != "cuda":
        return split3_ref(g)
    if g.dtype != torch.float32:
        raise ValueError(f"split3: want float32, got {g.dtype}")
    g = g.contiguous()
    *lead, m, n = g.shape
    m8, n8 = padded(m), padded(n)
    out = torch.empty(*lead, m8, 3 * n8, dtype=torch.bfloat16, device=g.device)
    if out.numel() == 0:
        return out
    vec = 4 if n % 4 == 0 and g.data_ptr() % 16 == 0 else 1
    lib = _build._lib or _build.load()
    ctx = (contextlib.nullcontext() if g.device.index == torch.cuda.current_device()
           else torch.cuda.device(g.device))
    with ctx:
        code = lib.tk_split3_bf16(g.data_ptr(), out.data_ptr(), out.numel() // (m8 * 3 * n8), m, n, m8, n8, vec,
                                  torch.cuda.current_stream().cuda_stream)
    _build.check(code, "tk_split3_bf16")
    launches_by_route["vec4" if vec == 4 else "scalar"] += 1
    return out
