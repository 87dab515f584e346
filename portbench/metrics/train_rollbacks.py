"""``train_rollbacks``: the recipe's validation rollbacks in the window (a
validation loss worse than the last validated one: the loader rewound,
the validated state restored, the learning rate halved), counted by the
benchmark's wrapper of the trainer's halving."""


def read(rec):
    if not rec.steps or "rollbacks" not in rec.window:
        return None
    return float(rec.window["rollbacks"])
