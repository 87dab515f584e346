"""The launch plan of kernel 2 (``ops.frame_preemph.frame_plan``) and the
index math of its tiles, on the CPU with no kernel and no card.

The plan picks the route from the shape and the alignment alone (``bulk``:
16-byte aligned signal and output, S a multiple of 4, even frame length;
else ``edge``), the tile depth, the persistent grid and the shared memory.
:func:`_walk` repeats in numpy what ``csrc/frame_preemph.cu`` does for
every tile, block by block and thread by thread: the tile's utterance and
first frame from one division, the staged range (the halo sample, 16-byte
rounding, the clamp at the real samples), the preemphasised span, and the
incremental (frame, sample) walk of the expansion. It must rebuild the
plain version's frames bit for bit: the staged buffer is NaN outside what
the bulk copy writes, so a read past it would show.
"""

import numpy as np
import pytest
import torch

from tfkaldi_tpu_torch.ops import frame_preemph as fp
from tfkaldi_tpu_torch.ops.frame_preemph import frame_plan

ALIGNED = (1 << 20, 3 << 20)  # two 16-byte aligned data pointers
WL, WS = 400, 160


@pytest.mark.parametrize("s", [80000, 128000, 4000])
def test_recipe_shapes_take_bulk(s):
    """prepare_data pads to whole seconds, so S is a multiple of 16000."""
    t_max = 1 + (s - WL) // WS
    plan = frame_plan(16, s, t_max, WL, WS, ALIGNED)
    assert (plan.route, plan.threads) == ("bulk", fp.THREADS)
    assert plan.frames == min(t_max, fp.TILE_BYTES // (WL * 8))
    assert plan.tiles == 16 * -(-t_max // plan.frames)


@pytest.mark.parametrize("s,wl,ws,why", [
    (22050 * 4, 551, 220, "odd frame length (25 ms at 22.05 kHz)"),
    (80001, WL, WS, "odd S: rows start off 16 bytes"),
    (80002, WL, WS, "S = 2 mod 4"),
])
def test_unaligned_shapes_take_edge(s, wl, ws, why):
    assert frame_plan(4, s, 1 + (s - wl) // ws, wl, ws, ALIGNED).route == "edge", why


@pytest.mark.parametrize("which", [0, 1])
def test_offset_view_takes_edge(which):
    """A view that starts one sample into an aligned buffer can be
    neither the bulk copy's source nor the 16-byte stores' target."""
    base = torch.empty(4 * 4000 + 1)
    view = base[1:].view(4, 4000)
    assert base.data_ptr() % 16 == 0 and view.data_ptr() % 16 != 0
    ptrs = list(ALIGNED)
    ptrs[which] = view.data_ptr()
    assert frame_plan(4, 4000, 23, WL, WS, ptrs).route == "edge"
    assert frame_plan(4, 4000, 23, WL, WS, (base.data_ptr(), ALIGNED[1])).route == "bulk"


def test_bad_shapes_raise():
    with pytest.raises(ValueError, match="shape"):
        frame_plan(4, 4000, 0, WL, WS, ALIGNED)
    with pytest.raises(ValueError, match="32 bits"):
        frame_plan(1, 2 ** 31 - 4, 2 ** 31 // WS, WL, WS, ALIGNED)


@pytest.mark.parametrize("wl,ws", [(400, 160), (200, 80), (551, 220), (1024, 256), (2048, 512), (6000, 10)])
@pytest.mark.parametrize("frames", [None, 64])
@pytest.mark.parametrize("sms", [132, 2])
def test_shared_memory_and_grid(wl, ws, frames, sms):
    """Every default plan fits a block's 227 KB (a long frame at a short
    step gets fewer frames a tile), and every plan puts at most
    CTAS_PER_SM blocks on an SM, each fitting beside the others."""
    s = 64 * wl
    t_max = 1 + (s - wl) // ws
    plan = frame_plan(16, s, t_max, wl, ws, ALIGNED, sms, frames=frames)
    assert plan.smem_bytes == fp.frame_smem(wl, ws, plan.frames, plan.route)
    if frames is not None:
        assert plan.frames == frames
        return
    assert plan.smem_bytes < 227 * 1024 == fp.SMEM_PER_CTA
    assert 1 <= plan.grid <= min(plan.tiles, sms * fp.CTAS_PER_SM)
    per_sm = -(-plan.grid // sms)
    assert per_sm * (plan.smem_bytes + 1024) <= fp.SMEM_PER_SM


def test_shared_memory_layout():
    """16 frames of 400 at step 160: a span of 2800 samples; y 22,400 B;
    two staged spans of 2808 floats; two mbarriers. The edge route keeps
    y alone."""
    assert fp.frame_smem(400, 160, 16, "bulk") == 22_400 + 2 * 2808 * 4 + 16 == 44_880
    assert fp.frame_smem(551, 220, 11, "edge") == -(-(10 * 220 + 551) * 8 // 16) * 16


def _tile(tile, frames, tiles_per_utt, t_max, ws, wl, s, eff):
    """tile_at of csrc/frame_preemph.cu."""
    u = tile // tiles_per_utt
    t0 = (tile - u * tiles_per_utt) * frames
    nf = min(frames, t_max - t0)
    s0 = t0 * ws
    return u, t0, nf, s0, (nf - 1) * ws + wl, max(0, min(int(eff[u]), s)), (u * t_max + t0) * wl


def _blocks(plan):
    """The tiles each block of the persistent grid walks, in its order."""
    return [range(block, plan.tiles, plan.grid) for block in range(plan.grid)]


@pytest.mark.parametrize("b,t_max,frames,grid", [(16, 498, 16, 528), (16, 798, 16, 528), (3, 23, 16, 2),
                                                 (2, 1, 16, 132), (5, 37, 7, 3), (1, 9, 1, 4)])
def test_tiles_cover_every_frame_once(b, t_max, frames, grid):
    tiles_per_utt = -(-t_max // frames)
    plan = fp.FramePlan("bulk", frames, b * tiles_per_utt, min(grid, b * tiles_per_utt), 256, 0)
    seen = np.zeros((b, t_max), np.int64)
    for walk in _blocks(plan):
        for tile in walk:
            u, t0, nf, *_ = _tile(tile, frames, tiles_per_utt, t_max, WS, WL, 10 ** 6, [10 ** 6] * b)
            assert 1 <= nf <= frames
            seen[u, t0:t0 + nf] += 1
    assert (seen == 1).all()


def _walk(sig, eff, c, ws, wl, t_max, plan):
    """The kernel's tile loop in numpy: frames [B, t_max, wl] f64."""
    b, s = sig.shape
    out = np.full((b * t_max * wl,), np.nan)
    tiles_per_utt = -(-t_max // plan.frames)
    span = (plan.frames - 1) * ws + wl
    xs = -(-(span + 8) // 4) * 4
    w = 2 if plan.route == "bulk" else 1  # a 16-byte store, or an 8-byte one
    for walk in _blocks(plan):
        for tile in walk:
            u, t0, nf, s0, length, lim, out0 = _tile(tile, plan.frames, tiles_per_utt, t_max, ws, wl, s, eff)
            row = sig[u]
            if plan.route == "bulk":  # staged_range, and the bulk copy into a NaN-filled buffer
                a0 = max(s0 - 1, 0) & ~3
                a1 = max(a0, min(-(-(s0 + length) // 4) * 4, -(-lim // 4) * 4))
                assert a0 % 4 == 0 and a1 % 4 == 0 and a1 <= s and a1 - a0 <= xs
                x = np.full(xs, np.nan, np.float32)
                x[: a1 - a0] = row[a0:a1]
            else:  # plain loads from the row
                a0, x = 0, row
            y = np.zeros(length)
            for i in range(length):  # preemph_span
                g = s0 + i
                if g < lim:
                    assert 0 <= g - a0 < len(x) and (g == 0 or g - 1 - a0 >= 0)
                    prev = np.float64(x[g - 1 - a0]) if g > 0 else np.float64(0.0)
                    y[i] = np.float64(x[g - a0]) - np.float64(c) * prev  # two roundings
            total = nf * wl
            for thread in range(fp.THREADS):  # expand
                j = w * thread
                f = j // wl
                n = j - f * wl
                k = f * ws + n
                while j < total:
                    out[out0 + j: out0 + j + w] = y[k: k + w]
                    n += w * fp.THREADS
                    k += w * fp.THREADS
                    while n >= wl:
                        n -= wl
                        k += ws - wl
                    j += w * fp.THREADS
    return out.reshape(b, t_max, wl)


WALKS = {
    # name: (seed, B, S, wl, ws, eff lengths (None: S), t_max (None: snip_edges count), forced plan)
    "recipe_tiles": (0, 3, 4000, 400, 160, [4000, 3863, 403], None, {}),
    "eff_len_zero": (1, 3, 4000, 400, 160, [0, 4000, 17], None, {}),
    "s_below_wl": (2, 2, 300, 400, 160, [300, 251], 1, {}),
    "t_max_one": (3, 2, 400, 400, 160, [400, 399], 1, {}),
    "frames_past_s": (4, 2, 1000, 400, 160, None, 5, {}),
    "odd_wl_edge": (5, 2, 3000, 551, 220, [3000, 2013], None, {}),
    "odd_s_edge": (6, 2, 4001, 400, 160, [4001, 3999], None, {}),
    "odd_step": (7, 2, 4000, 400, 147, [4000, 1234], None, {}),
    "odd_frames_two_blocks": (8, 2, 4000, 400, 160, [4000, 2222], None, {"frames": 3, "sms": 1}),
    "one_frame_tiles": (9, 2, 2000, 400, 160, [2000, 1500], None, {"frames": 1, "sms": 1}),
}


@pytest.mark.parametrize("name", sorted(WALKS))
def test_tile_walk_rebuilds_plain_frames(name):
    seed, b, s, wl, ws, eff, t_max, force = WALKS[name]
    rng = np.random.default_rng(seed)
    sig = np.round(rng.standard_normal((b, s)) * 800).astype(np.float32)
    eff = np.asarray(eff if eff is not None else [s] * b, np.int32)
    if t_max is None:
        t_max = 1 + (s - wl) // ws
    force = dict(force)
    sms = force.pop("sms", 132)
    plan = frame_plan(b, s, t_max, wl, ws, ALIGNED, sms, **force)
    assert plan.route == ("edge" if "edge" in name else "bulk")
    want = fp.frame_preemph_ref(torch.from_numpy(sig), torch.from_numpy(eff), preemph=0.97,
                                frame_step=ws, frame_len=wl, t_max=t_max).numpy()
    np.testing.assert_array_equal(_walk(sig, eff, 0.97, ws, wl, t_max, plan), want)
