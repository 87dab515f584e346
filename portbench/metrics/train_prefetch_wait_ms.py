"""``train_prefetch_wait_ms``: the program's ``prefetch.next`` spans
(``PrefetchingBatchSource.next``: the wait for the worker's batch and the
enqueue of its copy to the device) in the traced window ÷ its
``train_step`` spans, in ms."""

from portbench.spans import train_ms_per_step


def read(rec):
    return train_ms_per_step(rec, "prefetch.next")
