"""The CUDA deblock kernel's row-pipeline schedule, checked on the CPU.

The kernel (openh264_tpu_torch/csrc/deblock.cu) filters a frame in one
launch: each MB row runs left to right, and each MB in two steps. The
vertical pass of MB x touches only row y's own lines and MB x-1's right
columns, so it runs as soon as row y has finished MB x-1, before any
wait. The horizontal pass of MB x reads the 4 lines above, so it waits
until row y-1 has finished MB x+1 (all of row y-1 when x + 1 = mb_w).
A finished MB is published before the next MB's vertical pass rewrites
its right columns. The kernel itself runs only on a GPU, but this order
can be replayed here through the plain version's `_filter_mbs`: a
seeded scheduler lets each row take its next step with some probability
when that step is allowed, and a tick's vertical steps and its
horizontal steps run as two batches, in a seeded order. That order must
give the same bytes as the diagonal order of `deblock_frame_device`,
and an order that lets row y run the horizontal pass of MB x one MB too
early must not.

The plain version is held against JAX and the Pallas kernel in
test_torch_deblock.py; this file needs no JAX.
"""

import numpy as np
import pytest
import torch

from openh264_tpu_torch.encoder import deblock_torch as dt

GRIDS = [(6, 5), (4, 7), (9, 3), (1, 3)]


def _inputs(mbw, mbh, seed):
    """Flat MBs a few levels apart plus noise (edges the filter acts on),
    bS 0-4 and QP 18-41."""
    rng = np.random.default_rng(seed)

    def plane(size):
        base = rng.integers(80, 120, (mbh, mbw)).repeat(size, 0).repeat(
            size, 1)
        return (base + rng.integers(-3, 4, base.shape)).astype(np.uint8)
    return [torch.from_numpy(a) for a in (
        plane(16), plane(8), plane(8),
        rng.integers(0, 5, (mbh * 4, mbw * 4), np.int32),
        rng.integers(0, 5, (mbh * 4, mbw * 4), np.int32),
        rng.integers(18, 42, mbw * mbh, np.int32),
        rng.integers(18, 42, mbw * mbh, np.int32))]


def _schedule(mbw, mbh, lead, pick, rng=None):
    """Ticks of a row pipeline, each a list of (MB ids, pass) steps. Row
    y runs the vertical pass of its next MB x once it has finished MB
    x-1, and its horizontal pass once row y-1 has finished min(x + lead,
    mb_w) MBs. Each tick, pick(rows with a step allowed) chooses the
    rows that take one; rng, where given, draws which of the tick's two
    batches runs first."""
    v = np.zeros(mbh, np.int64)        # vertical passes done
    h = np.zeros(mbh, np.int64)        # MBs finished (published)
    ticks = []
    while h[-1] < mbw:                 # the last row finishes last
        need = np.minimum(h + lead, mbw)
        can_v = (v == h) & (v < mbw)
        can_h = (v > h) & np.r_[True, h[:-1] >= need[1:]]
        rows = pick(np.flatnonzero(can_v | can_h))
        vr, hr = rows[can_v[rows]], rows[can_h[rows]]
        tick = [(r * mbw + n[r], p) for r, n, p in ((vr, v, "v"),
                                                    (hr, h, "h")) if len(r)]
        if rng is not None and rng.random() < 0.5:
            tick.reverse()
        if tick:
            ticks.append(tick)
        v[vr] += 1
        h[hr] += 1
    return ticks


def _pipeline(mbw, mbh, seed, p=0.5):
    """The kernel's order: each row with a step allowed takes it with
    probability p."""
    rng = np.random.default_rng(seed)
    return _schedule(mbw, mbh, 2,
                     lambda rows: rows[rng.random(len(rows)) < p], rng)


def _too_early(mbw, mbh):
    """Row y runs the horizontal pass of MB x once row y-1 has finished
    only MB x; one step a tick, the lowest row with a step allowed
    first."""
    return _schedule(mbw, mbh, 1, lambda rows: rows[-1:])


def _steps(ticks):
    return [s for t in ticks for s in t]


def _batches(ticks, passes):
    """The MB ids of each tick's `passes` step, sorted, ticks without
    one left out."""
    return [sorted(ids.tolist()) for t in ticks for ids, p in t
            if p == passes]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("mbw,mbh", GRIDS)
def test_row_pipeline_equals_diagonal_order(mbw, mbh, seed):
    args = _inputs(mbw, mbh, 100 + seed)
    ticks = _pipeline(mbw, mbh, seed)
    for passes in "vh":
        done = sorted(sum(_batches(ticks, passes), []))
        assert done == list(range(mbw * mbh))
    if mbw > 1:     # the random stalls give another order than no stalls
        assert _batches(ticks, "h") != \
            _batches(_pipeline(mbw, mbh, seed, p=1.0), "h")
    want = dt.deblock_frame_device(*args, mbw, mbh)
    got = dt._deblock_in_order(*args, mbw, mbh, _steps(ticks))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert not torch.equal(want[0], args[0])     # the filter acted


@pytest.mark.parametrize("mbw,mbh,differs", [(6, 5, True), (4, 7, True),
                                             (9, 3, True), (1, 3, False)])
def test_too_early_schedule_differs(mbw, mbh, differs):
    """Waiting for MB x of the row above instead of MB x+1 misses the
    rewrite of MB x's right columns by MB x+1's left edge. With a single
    MB column there is no MB x+1, and that order is legal."""
    args = _inputs(mbw, mbh, 7)
    want = dt.deblock_frame_device(*args, mbw, mbh)
    got = dt._deblock_in_order(*args, mbw, mbh,
                               _steps(_too_early(mbw, mbh)))
    same = all(torch.equal(g, w) for g, w in zip(got, want))
    assert same != differs


@pytest.mark.parametrize("mbw,mbh", GRIDS)
def test_eager_pipeline_critical_path(mbw, mbh):
    """With no stalls every row runs its first vertical pass at tick 0,
    before any wait. Along a row an MB takes two steps; from row to row
    the hand-off costs three (the wait for MB x+1 above, then MB x's
    horizontal pass), as the vertical pass ran before the wait: the
    horizontal pass of MB (x, y) runs at tick 2x + 3y + 1 (y + 1 with
    one MB column)."""
    ticks = _pipeline(mbw, mbh, 0, p=1.0)
    assert _batches(ticks[:1], "v") == [[y * mbw for y in range(mbh)]]
    tick_h = {int(i): t for t, tick in enumerate(ticks)
              for ids, p in tick if p == "h" for i in ids}
    for i, t in tick_h.items():
        x, y = i % mbw, i // mbw
        assert t == (y + 1 if mbw == 1 else 2 * x + 3 * y + 1)
    assert len(ticks) == (mbh + 1 if mbw == 1
                          else 2 * mbw + 3 * (mbh - 1))
