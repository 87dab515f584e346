"""The plain reference model: the BN DNN, in float32.

Written from the recipe's equations, on plain torch operations, with
nothing of the program. Parameters are a dict under the acoustic model's
own names (``hidden.{l}.w`` is ``[fan_in, fan_out]``). Every product goes
through :func:`product`, whose ``mode`` is the precision the comparison
asks for:

- ``f32``: float32 operands, float32 products (TF32 off);
- ``tf32``: both operands rounded to TF32's 10-bit mantissa, as the
  tensor cores read them under TF32, with float32 accumulation;

and the backward's products round their operands the same way.
"""

from __future__ import annotations

import torch

MODES = ("f32", "tf32")


def round_operand(x: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == "f32":
        return x
    x = x.float().contiguous()
    if mode == "tf32":  # round to nearest on the 13 low mantissa bits
        bits = x.view(torch.int32)
        bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
        return bits.view(torch.float32)
    raise ValueError(f"mode {mode!r}: want one of {MODES}")


class _Product(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, mode):
        ctx.save_for_backward(a, b)
        ctx.mode = mode
        return torch.matmul(round_operand(a, mode), round_operand(b, mode))

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        m = ctx.mode
        gq = round_operand(g, m)
        return gq @ round_operand(b, m).transpose(-1, -2), round_operand(a, m).transpose(-1, -2) @ gq, None


def product(a: torch.Tensor, b: torch.Tensor, mode: str = "f32") -> torch.Tensor:
    if mode == "f32":
        return torch.matmul(a, b)
    return _Product.apply(a, b, mode)


# ----------------------------------------------------------------------
# shapes
# ----------------------------------------------------------------------

def dnn_shapes(input_dim: int, layers: int, units: int, labels: int) -> dict[str, tuple]:
    shapes: dict[str, tuple] = {}
    fan_in = input_dim
    for l in range(layers):
        shapes[f"hidden.{l}.w"] = (fan_in, units)
        shapes[f"hidden.{l}.b"] = (units,)
        shapes[f"hidden.{l}.beta"] = (units,)
        fan_in = units
    shapes["out.w"] = (units, labels)
    shapes["out.b"] = (labels,)
    return shapes


# ----------------------------------------------------------------------
# forwards
# ----------------------------------------------------------------------

def dnn_train_logits(p: dict, x: torch.Tensor, layers: int, eps: float, mode: str = "f32") -> torch.Tensor:
    """Logits of the real frames ``x [N, F]`` of one batch in training:
    affine, batch norm over the batch's frames (centred, no scale),
    relu; then the output layer."""
    h = x
    for l in range(layers):
        z = product(h, p[f"hidden.{l}.w"], mode) + p[f"hidden.{l}.b"]
        mean = z.mean(0)
        var = torch.square(z - mean).mean(0)
        h = torch.relu((z - mean) / torch.sqrt(var + eps) + p[f"hidden.{l}.beta"])
    return product(h, p["out.w"], mode) + p["out.b"]


def dnn_eval_logits(p: dict, x: torch.Tensor, moving_mean, moving_var, layers: int, eps: float,
                    mode: str = "f32") -> torch.Tensor:
    """Logits in evaluation: batch norm on the moving statistics."""
    h = x
    for l in range(layers):
        z = product(h, p[f"hidden.{l}.w"], mode) + p[f"hidden.{l}.b"]
        h = torch.relu((z - moving_mean[l]) / torch.sqrt(moving_var[l] + eps) + p[f"hidden.{l}.beta"])
    return product(h, p["out.w"], mode) + p["out.b"]
