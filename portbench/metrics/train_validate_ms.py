"""``train_validate_ms``: the program's ``train.validate`` spans
(``Trainer.evaluate``) in the traced window ÷ its ``train_step`` spans, in
ms."""

from portbench.spans import train_ms_per_step


def read(rec):
    return train_ms_per_step(rec, "train.validate")
