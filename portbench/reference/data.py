"""The reference's own reading of the corpus: arks, CMVN, splicing and the
recipe's batch order.

Plain numpy, written from the Kaldi formats and the recipe's rules, with
nothing of the program: a binary ``FM`` matrix after ``key `` at the scp
offset; ``(x - mean) / sqrt(E[x²] - mean²)`` with the speaker's stats;
±``c`` neighbour frames zero-padded at the edges; the training controller
carving its validation batches from the head of the scp and then reading
batches in order.
"""

from __future__ import annotations

import struct

import numpy as np

def read_scp(path: str) -> dict[str, tuple[str, int]]:
    out = {}
    with open(path) as f:
        for line in f:
            key, loc = line.split()
            ark, off = loc.rsplit(":", 1)
            out[key] = (ark, int(off))
    return out


def read_matrix(ark: str, offset: int) -> np.ndarray:
    with open(ark, "rb") as f:
        f.seek(offset)
        head = f.read(15)
        if head[:5] != b"\x00BFM " or head[5] != 4 or head[10] != 4:
            raise ValueError(f"{ark}:{offset} is not a binary float matrix")
        rows, cols = struct.unpack("<i", head[6:10])[0], struct.unpack("<i", head[11:15])[0]
        return np.frombuffer(f.read(rows * cols * 4), dtype="<f4").reshape(rows, cols)


def read_utt2spk(path: str) -> dict[str, str]:
    with open(path) as f:
        return dict(line.split() for line in f if line.strip())


class Features:
    """CMVN-normalised, spliced features of a corpus directory, read on
    demand."""

    def __init__(self, dirpath: str, context_width: int):
        self.scp = read_scp(f"{dirpath}/feats.scp")
        self.order = list(self.scp)
        cmvn = read_scp(f"{dirpath}/cmvn.scp")
        self.stats = {spk: read_matrix(*loc).astype(np.float64) for spk, loc in cmvn.items()}
        self.utt2spk = read_utt2spk(f"{dirpath}/utt2spk")
        self.c = int(context_width)

    def __call__(self, utt: str) -> np.ndarray:
        x = read_matrix(*self.scp[utt]).astype(np.float64)
        st = self.stats[self.utt2spk[utt]]
        count = st[0, -1]
        mean = st[0, :-1] / count
        std = np.sqrt(st[1, :-1] / count - mean * mean)
        x = (x - mean) / std
        t, d = x.shape
        padded = np.zeros((t + 2 * self.c, d))
        padded[self.c:self.c + t] = x
        return np.concatenate([padded[o:o + t] for o in range(2 * self.c + 1)], axis=1)


def train_batches(order: list[str], batch_size: int, valid_batches: int, steps: int):
    """The utterances of the first ``steps`` training batches: the
    validation head carved off, then ``batch_size`` utterances a step."""
    rest = order[valid_batches * batch_size:]
    return [[rest[(s * batch_size + j) % len(rest)] for j in range(batch_size)] for s in range(steps)]
