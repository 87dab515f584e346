"""Input sharding over the scp index for multi-process training and decode.

A copy of :mod:`tfkaldi_tpu.data.sharding` (``shard_scp_lines`` and
``shard_scp``): each process reads its strided slice of the scp, line
``i`` going to shard ``i % n``, so the shards feed themselves with no
coordination beyond their index. Striding (not contiguous blocks) keeps the
speakers interleaved across shards. The defaults read
``torch.distributed`` where the JAX package reads ``jax.process_count()``
and ``jax.process_index()``.
"""

from __future__ import annotations

import os


def shard_scp_lines(
    lines: list[str], num_shards: int, shard_index: int, drop_remainder: bool = False
) -> list[str]:
    """Strided shard of scp lines: line ``i`` goes to shard ``i % num_shards``.

    Shards are disjoint and cover the input; sizes differ by at most 1.
    ``drop_remainder`` first cuts the input to a multiple of ``num_shards``,
    so that every shard has the same size (at most ``num_shards - 1``
    utterances are dropped in all)."""
    if not 0 <= shard_index < num_shards:
        raise ValueError(f"shard_index {shard_index} not in [0, {num_shards})")
    if drop_remainder:
        lines = lines[: len(lines) - len(lines) % num_shards]
    return lines[shard_index::num_shards]


def shard_path(scp_path: str, num_shards: int, shard_index: int) -> str:
    """``<base>.shard{i}of{n}<ext>``: where :func:`shard_scp` writes shard
    ``i`` of ``n`` by default."""
    base, ext = os.path.splitext(scp_path)
    return f"{base}.shard{shard_index}of{num_shards}{ext}"


def shard_scp(
    scp_path: str,
    num_shards: int | None = None,
    shard_index: int | None = None,
    out_path: str | None = None,
    drop_remainder: bool = False,
) -> str:
    """Write shard ``shard_index`` of ``scp_path`` and return its path.

    The defaults are the world size and the rank of the default
    ``torch.distributed`` process group (1 and 0 when none is up). With one
    shard the original path is returned unchanged."""
    if num_shards is None or shard_index is None:
        import torch.distributed as dist

        up = dist.is_available() and dist.is_initialized()
        if num_shards is None:
            num_shards = dist.get_world_size() if up else 1
        if shard_index is None:
            shard_index = dist.get_rank() if up else 0
    if num_shards == 1:
        return scp_path
    with open(scp_path) as f:
        lines = f.readlines()
    shard = shard_scp_lines(lines, num_shards, shard_index, drop_remainder)
    if out_path is None:
        out_path = shard_path(scp_path, num_shards, shard_index)
    with open(out_path, "w") as f:
        f.writelines(shard)
    return out_path
