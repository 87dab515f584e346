"""The reference's first training steps: loss, gradients, the divide by
frames, the ±1 clip and TF-Adam, in plain torch.

TF-Adam as the recipe writes it: ``lr_t = lr·√(1−β2ᵗ)/(1−β1ᵗ)``,
``m = β1·m + (1−β1)·g``, ``v = β2·v + (1−β2)·g²``, ``p −= lr_t·m/(√v + ε)``
with ε outside the square root, on ``g = clip(∇/frames, −1, 1)``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference import models

B1, B2, EPS = 0.9, 0.999, 1e-8


def steps(weights: dict, batches: list, layers: int, eps: float, *, lr: float, mode: str = "f32") -> dict:
    """Run ``len(batches)`` optimizer steps of the DNN from ``weights`` (not
    changed) on ``batches`` of ``{"x": [N, F] real frames, "y": [N]}``,
    under frame cross-entropy. Returns the loss of each step (summed loss
    / frames, before its update), each leaf's norm of the first step's
    clipped gradient, and each leaf's norm of the change over all the
    steps."""
    p = {n: w.detach().clone().requires_grad_(True) for n, w in weights.items()}
    m = {n: torch.zeros_like(w) for n, w in p.items()}
    v = {n: torch.zeros_like(w) for n, w in p.items()}
    losses, first_grad = [], {}
    for s, batch in enumerate(batches):
        logits = models.dnn_train_logits(p, batch["x"], layers, eps, mode)
        total = F.cross_entropy(logits, batch["y"], reduction="sum")
        frames = float(batch["x"].shape[0])
        grads = torch.autograd.grad(total, list(p.values()), allow_unused=True)
        losses.append(float(total.detach()) / frames)
        t = s + 1
        lr_t = lr * math.sqrt(1 - B2 ** t) / (1 - B1 ** t)
        with torch.no_grad():
            for (name, w), gr in zip(p.items(), grads):
                g = torch.zeros_like(w) if gr is None else torch.clamp(gr.float() / frames, -1.0, 1.0)
                if s == 0:
                    first_grad[name] = float(torch.linalg.vector_norm(g))
                m[name].mul_(B1).add_((1 - B1) * g)
                v[name].mul_(B2).add_((1 - B2) * torch.square(g))
                w.sub_(lr_t * m[name] / (torch.sqrt(v[name]) + EPS))
    change = {n: float(torch.linalg.vector_norm(p[n].detach() - weights[n])) for n in p}
    return {"losses": losses, "first_grad": first_grad, "change": change}
