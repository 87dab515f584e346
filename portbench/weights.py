"""Seeded weights, made on the device in one draw.

Every tensor of ``shapes`` (in its order) takes its slice of one normal
draw from a generator on ``device``: a matrix ``[fan_in, fan_out]`` scaled
by ``1/sqrt(fan_in)``, a vector by ``0.1``. The same seed gives the same
weights; the benchmark hands them to the program and to the reference.
"""

from __future__ import annotations

import math

import torch


def generator(device, seed: int, stream: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed((int(seed) * 1000003 + int(stream)) % (1 << 63))


def make_weights(shapes: dict[str, tuple], seed: int, device, stream: int = 1) -> dict[str, torch.Tensor]:
    total = sum(math.prod(s) for s in shapes.values())
    flat = torch.randn(total, generator=generator(device, seed, stream), device=device)
    out, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        scale = 1.0 / math.sqrt(shape[0]) if len(shape) == 2 else 0.1
        out[name] = flat[at:at + n].view(shape) * scale
        at += n
    return out


def load_into(model: torch.nn.Module, weights: dict[str, torch.Tensor]) -> None:
    """Copy ``weights`` into the model's parameters of the same names; the
    names and shapes must match the model's exactly."""
    params = dict(model.named_parameters())
    if set(params) != set(weights):
        raise ValueError(f"parameters differ from the reference's: model {sorted(set(params) - set(weights))}, "
                         f"reference {sorted(set(weights) - set(params))}")
    with torch.no_grad():
        for name, p in params.items():
            if tuple(p.shape) != tuple(weights[name].shape):
                raise ValueError(f"{name}: model {tuple(p.shape)}, reference {tuple(weights[name].shape)}")
            p.copy_(weights[name])
