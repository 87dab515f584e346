"""The launch plans of the recurrences' forward and backward
(``ops.rnn_bidi.fwd_plan``, ``ops.rnn_bidi.bwd_plan``): which route a layer
call takes, its grid and its shared memory, decided from the shape and the
compute dtype alone. Pure arithmetic: it runs on the CPU, with no kernel
and no card.
"""

import pytest
import torch

from tfkaldi_tpu_torch.ops import rnn_bidi
from tfkaldi_tpu_torch.ops.rnn_bidi import bwd_plan, fwd_plan

CD = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# the recurrent layer of the repo's BiLSTM / BiGRU (config_AURORA4_ctc.cfg): batch, hidden
RECIPE_B, RECIPE_H = 128, 512


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("gates", [4, 3])
def test_recipe_shape_takes_the_persistent_route(gates, cd):
    plan = fwd_plan(RECIPE_B, RECIPE_H, gates, CD[cd], 2)
    assert plan.route == "persistent"
    assert plan.smem_bytes <= 232_448  # a Hopper CTA's shared memory
    assert plan.ctas <= 132  # one CTA per SM of an H100
    # 2 directions x 2 row tiles of 64 x 32 tiles of 16 units, no loop over row tiles
    assert (plan.ctas, plan.row_ctas, plan.tiles_per_cta) == (128, 2, 1)


@pytest.mark.parametrize("gates,cd,want", [
    (4, "bfloat16", 512 * 72 * 2 + 8 * 64 * 72 * 2),  # W_h slice 64 KB + padding, h ring of 8 x 64 x 64
    (4, "float32", 512 * 68 * 4 + 4 * 64 * 36 * 4),
    (3, "bfloat16", 512 * 56 * 2 + 8 * 64 * 72 * 2),
    (3, "float32", 512 * 52 * 4 + 4 * 64 * 36 * 4),
])
def test_recipe_shared_memory(gates, cd, want):
    assert rnn_bidi.persistent_smem(gates, RECIPE_H, CD[cd]) == want


@pytest.mark.parametrize("b,tiles_per_cta", [(300, 3), (512, 4), (64, 1), (16, 1), (1, 1)])
def test_batch_beyond_the_grid_loops_inside_a_cta(b, tiles_per_cta):
    plan = fwd_plan(b, RECIPE_H, 4, torch.bfloat16, 2)
    assert plan.route == "persistent"
    assert plan.tiles_per_cta == tiles_per_cta
    assert plan.row_ctas * plan.tiles_per_cta * rnn_bidi.P_ROWS >= b


@pytest.mark.parametrize("b,h,gates,cd,dirs", [
    (513, 512, 4, "bfloat16", 2),  # 9 row tiles over 2 row CTAs: more than 4 a CTA
    (128, 720, 4, "float32", 2),  # the f32 LSTM slice of 720 units does not fit
    (128, 1072, 3, "bfloat16", 2),  # 2 x 67 unit tiles: more CTAs than SMs
])
def test_shapes_the_plan_refuses_take_the_step_route(b, h, gates, cd, dirs):
    assert fwd_plan(b, h, gates, CD[cd], dirs).route == "step"


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("gates", [4, 3])
@pytest.mark.parametrize("dirs", [1, 2])
def test_every_persistent_plan_is_resident(dirs, gates, cd):
    """Over a sweep of shapes, a persistent plan always fits: shared memory,
    one CTA per SM, at most 4 row tiles a CTA, every row covered; and the
    route depends on the shape alone (T does not enter)."""
    for h in (1, 8, 33, 70, 128, 256, 512, 700, 705, 1024, 1056, 1057, 2048):
        for b in (1, 5, 64, 65, 128, 300, 1000, 4096):
            plan = fwd_plan(b, h, gates, CD[cd], dirs)
            if plan.route == "step":
                continue
            assert plan.smem_bytes <= rnn_bidi.SMEM_PER_CTA
            assert plan.ctas == dirs * -(-h // 16) * plan.row_ctas <= rnn_bidi.SMS
            assert 1 <= plan.tiles_per_cta <= rnn_bidi.P_MAXR
            assert plan.row_ctas * plan.tiles_per_cta * 64 >= b


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("gates", [4, 3])
def test_recipe_shape_takes_the_persistent_backward(gates, cd):
    plan = bwd_plan(RECIPE_B, RECIPE_H, gates, CD[cd], 2)
    assert plan.route == "persistent"
    assert plan.smem_bytes <= 232_448
    assert (plan.ctas, plan.row_ctas, plan.tiles_per_cta) == (128, 2, 1)


@pytest.mark.parametrize("gates,cd,want", [
    # W_h's 16 rows [16, 4H + PADN], 1 KB to align the ring, NST stages of two 8 KB boxes and a barrier each
    (4, "bfloat16", 16 * (2048 + 8) * 2 + 1024 + 8 * (16384 + 8)),
    (4, "float32", 16 * (2048 + 4) * 4 + 1024 + 5 * (16384 + 8)),
    (3, "bfloat16", 16 * (1536 + 8) * 2 + 1024 + 8 * (16384 + 8)),
    (3, "float32", 16 * (1536 + 4) * 4 + 1024 + 5 * (16384 + 8)),
])
def test_recipe_backward_shared_memory(gates, cd, want):
    assert rnn_bidi.persistent_bwd_smem(gates, RECIPE_H, CD[cd]) == want
    assert bwd_plan(RECIPE_B, RECIPE_H, gates, CD[cd], 2).smem_bytes == want


@pytest.mark.parametrize("h,gates,cd,want", [
    (2, 4, "bfloat16", 16 * (128 + 8) * 2 + 1024 + 8 * (16384 + 8)),  # G*H rounds up to one chunk
    (33, 3, "float32", 16 * (128 + 4) * 4 + 1024 + 5 * (16384 + 8)),  # 99 columns round up to two chunks of 64
])
def test_backward_shared_memory_rounds_the_depth_up_to_a_chunk(h, gates, cd, want):
    assert rnn_bidi.persistent_bwd_smem(gates, h, CD[cd]) == want


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,tiles_per_cta", [(300, 3), (512, 4), (64, 1), (16, 1), (1, 1)])
def test_backward_batch_beyond_the_grid_loops_inside_a_cta(b, tiles_per_cta, cd):
    plan = bwd_plan(b, RECIPE_H, 4, CD[cd], 2)
    assert plan.route == "persistent"
    assert plan.tiles_per_cta == tiles_per_cta
    assert plan.row_ctas * plan.tiles_per_cta * rnn_bidi.P_ROWS >= b


@pytest.mark.parametrize("b,h,gates,cd,dirs", [
    (513, 512, 4, "bfloat16", 2),  # 9 row tiles over 2 row CTAs: more than 4 a CTA
    (128, 784, 4, "bfloat16", 2),  # W_h's rows [16, 3136] and the ring do not fit
    (128, 592, 4, "float32", 2),  # in f32 the LSTM fits up to H 576
    (128, 1056, 3, "bfloat16", 1),  # the GRU's [16, 3168] bf16 rows do not fit either
    (8, 33, 4, "bfloat16", 2),  # a dgates row of 132 bf16 values is 264 bytes: not whole 16-byte pieces
    (8, 70, 3, "float32", 1),  # 210 f32 values: 840 bytes
    (128, 1072, 3, "bfloat16", 2),  # 2 x 67 unit tiles: more CTAs than SMs (and too much shared memory)
])
def test_shapes_the_backward_plan_refuses_take_the_step_route(b, h, gates, cd, dirs):
    assert bwd_plan(b, h, gates, CD[cd], dirs) == rnn_bidi.STEP_BWD


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("gates", [4, 3])
@pytest.mark.parametrize("dirs", [1, 2])
def test_every_persistent_backward_plan_is_resident(dirs, gates, cd):
    """As for the forward: over a sweep of shapes, a persistent backward plan
    always fits, and it is a :class:`BwdPlan` with the forward's fields."""
    for h in (1, 8, 33, 70, 128, 256, 512, 576, 577, 768, 769, 1024, 1040, 1056, 2048):
        for b in (1, 5, 64, 65, 128, 300, 1000, 4096):
            plan = bwd_plan(b, h, gates, CD[cd], dirs)
            assert isinstance(plan, rnn_bidi.BwdPlan)
            if plan.route == "step":
                continue
            assert plan.smem_bytes == rnn_bidi.persistent_bwd_smem(gates, h, CD[cd]) <= rnn_bidi.SMEM_PER_CTA
            assert gates * h * CD[cd].itemsize % 16 == 0
            assert plan.ctas == dirs * -(-h // 16) * plan.row_ctas <= rnn_bidi.SMS
            assert 1 <= plan.tiles_per_cta <= rnn_bidi.P_MAXR
            assert plan.row_ctas * plan.tiles_per_cta * 64 >= b
