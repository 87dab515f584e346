"""The Conformer transducer's forward operations and parameters, from its
widths.

Two operations a multiply-add of every product the model needs for one
utterance's real frames: the front end's two convolutions and projection,
each block's two FFNs, attention projections, the relative positions'
projection of the ``2T'-1`` distances, the content and position scores and
the context at the utterance's own ``T'`` (``T'²·d_model`` each), the conv
module's pointwise and depthwise convolutions, the encoder's and the
predictor's output layers and the predictor's LSTM over ``U+1`` positions,
and the joint's product over the ``T'·(U+1)`` real cells of the lattice.
Element-wise work (norms, activations, softmax, the lattice recursion) is
not counted. A training step is three times its forward.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Widths:
    feat_dim: int
    num_labels: int
    num_blocks: int
    d_model: int
    num_heads: int
    ffn_dim: int
    conv_kernel: int
    pred_units: int
    embed_dim: int
    joint_units: int

    @classmethod
    def from_config(cls, config: dict) -> "Widths":
        """From a ``portbench/configs/<c>.json`` of a conformer transducer."""
        n = config["nnet"]
        return cls(feat_dim=int(config["feat_dim"]), num_labels=int(config["num_labels"]),
                   **{k: int(n[k]) for k in ("num_blocks", "d_model", "num_heads", "ffn_dim", "conv_kernel",
                                            "pred_units", "embed_dim", "joint_units")})


def conv2d_out(n: int) -> int:
    return ((n - 1) // 2 - 1) // 2


def forward_flops(w: Widths, frames: int, labels: int) -> float:
    """One utterance of ``frames`` input frames and ``labels`` labels."""
    d, c, j, p = w.d_model, w.d_model, w.joint_units, w.pred_units
    f1, t1 = (w.feat_dim - 1) // 2, (frames - 1) // 2
    f2, t = conv2d_out(w.feat_dim), conv2d_out(frames)
    u1 = labels + 1
    macs = t1 * f1 * c * 9 + t * f2 * c * c * 9 + t * c * f2 * d  # front end
    block = (2 * 2 * t * d * w.ffn_dim  # two FFNs of two products
             + 4 * t * d * d  # q, k, v, out
             + (2 * t - 1) * d * d  # W_R of the distances
             + 3 * t * t * d  # content scores, position scores, context
             + t * d * 2 * d + t * d * w.conv_kernel + t * d * d)  # conv module
    macs += w.num_blocks * block + t * d * j  # the blocks, the encoder's output layer
    macs += u1 * (w.embed_dim * 4 * p + p * 4 * p + p * j)  # predictor
    macs += t * u1 * j * (w.num_labels + 1)  # the joint's product over the real cells
    return 2.0 * macs


def parameters(w: Widths) -> int:
    """The model's parameter count, by hand."""
    d, c, v, p = w.d_model, w.d_model, w.num_labels + 1, w.pred_units
    front = c * 9 + c + c * c * 9 + c + c * conv2d_out(w.feat_dim) * d + d
    ffn = d * w.ffn_dim + w.ffn_dim + w.ffn_dim * d + d
    attn = 4 * (d * d + d) + d * d + 2 * d  # q, k, v, out; W_R; u and v (H × d_h each)
    conv = d * 2 * d + 2 * d + d * w.conv_kernel + 2 * d + d * d + d  # pointwise, depthwise, BN scale and offset
    block = 2 * ffn + attn + conv + 5 * 2 * d  # five layer norms
    enc = front + w.num_blocks * block + 2 * d + d * w.joint_units + w.joint_units
    pred = v * w.embed_dim + w.embed_dim * 4 * p + p * 4 * p + 4 * p + p * w.joint_units + w.joint_units
    return enc + pred + w.joint_units * v + v
