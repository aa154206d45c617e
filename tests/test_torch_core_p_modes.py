"""Port parity: encode_p_frame's band mode, scroll candidate and per-MB
QP against core_jax.encode_p_frame.

The host encoder's multi-slice path calls the core on one band of MB
rows with whole reference planes (`row_off`), its screen-content path
adds a global scroll candidate (`extra_mv`), and adaptive quant / GOM
rate control pass per-MB `qp`/`qp_c` arrays. Every returned array must
equal the JAX core's exactly.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from openh264_tpu.encoder import core_jax as cj
from openh264_tpu_torch.encoder import core_torch as ct
from openh264_tpu_torch.tables import CHROMA_QP_TABLE

MBW, MBH = 6, 6
W, H = MBW * 16, MBH * 16


def _frame(i, scroll=0, seed=0):
    """Textured content with a drift of 1 px a frame down and right, or,
    with scroll, a whole-frame vertical scroll of `scroll` rows a frame
    (screen content: exact rows, no noise)."""
    tall = np.random.default_rng(seed).integers(0, 256, (4 * H, W + 8))
    yy, xx = np.mgrid[0:4 * H, 0:W + 8]
    tex = (tall // 3 + 60 * np.sin(xx / 5.0) + 40 * np.cos(yy / 7.0)
           + 80).clip(0, 255)
    if scroll:
        y = tex[H + scroll * i:2 * H + scroll * i, :W]
    else:
        y = tex[H + i:2 * H + i, i:i + W]
    cy, cx = np.mgrid[0:H // 2, 0:W // 2]
    u = (cx * 3 + cy + 2 * i) % 256
    v = (200 - cx - 2 * cy + (i * scroll) // 2) % 256
    return tuple(np.clip(a, 0, 255).astype(np.uint8) for a in (y, u, v))


def _check(got, want):
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k])
        g = got[k].numpy()
        assert g.shape == w.shape, (k, g.shape, w.shape)
        np.testing.assert_array_equal(g.astype(np.int64),
                                      w.astype(np.int64), err_msg=k)


def _run(cur, ref, qp, qpc, mb_h, **kw):
    """Both cores on the same inputs; cur may be a band, ref whole."""
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    tkw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray)
               and k.startswith("prev") else v) for k, v in kw.items()}
    jq = jnp.asarray(qp) if isinstance(qp, np.ndarray) else qp
    jqc = jnp.asarray(qpc) if isinstance(qpc, np.ndarray) else qpc
    want = cj.encode_p_frame(*map(jnp.asarray, cur + ref), jq, jqc,
                             mb_w=MBW, mb_h=mb_h, sr=8, **jkw)
    got = ct.encode_p_frame(
        *[torch.from_numpy(np.ascontiguousarray(a)) for a in cur + ref],
        qp, qpc, MBW, mb_h, sr=8, **tkw)
    _check(got, want)
    return got, want


@pytest.mark.parametrize("row_off,chain", [(0, False), (32, True),
                                           (64, True)])
def test_band_mode(row_off, chain):
    """A band of 2 MB rows at row_off against the whole reference: the
    search, the refine and skip windows and chroma MC all read the
    reference at the band's place; with chain, the band carries a
    skip-SAD chain too (an all-false chain is the chain-free case)."""
    ref = _frame(0)
    cur = _frame(2)
    rng = np.random.default_rng(row_off)
    n = 2 * MBW
    sad = rng.integers(0, 500, n).astype(np.int32)
    skip = (rng.random(n) < 0.5) & chain
    r0, r1 = row_off, row_off + 32
    band = (cur[0][r0:r1], cur[1][r0 // 2:r1 // 2], cur[2][r0 // 2:r1 // 2])
    got, want = _run(band, ref, 28, 27, 2, row_off=row_off,
                     prev_skip_sad=sad, prev_skip=skip)
    # the content moves 2 px down and right: most MVs are non-zero
    assert (np.asarray(want["mv"]) != 0).any()


@pytest.mark.parametrize("emv_rows,expect",
                         [(20, "taken"), (40, "partly_outside"),
                          (-13, "loses")])
def test_extra_mv(emv_rows, expect):
    """Content scrolled by 20 rows a frame, beyond the search range. A
    candidate at the true scroll is taken; one at 40 rows leaves the
    padded plane for the bottom MB rows (valid_e false there); one at
    -13 rows loses to the local search everywhere."""
    ref = _frame(0, scroll=20, seed=1)
    cur = _frame(1, scroll=20, seed=1)
    emv = np.array([0, 4 * emv_rows], np.int32)
    got, want = _run(cur, ref, 26, 25, MBH, extra_mv=emv)
    took = (np.asarray(want["mv"]) == emv).all(1)
    if expect == "taken":
        assert took.sum() >= MBW * MBH // 2
    elif expect == "partly_outside":
        # rows whose window would cross the padded plane's bottom edge
        # cannot take it: gy = 24 + 16*mby + 40 must stay <= 96 + 48 - 16
        assert not took.reshape(MBH, MBW)[5:].any()
    else:
        assert not took.any()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_per_mb_qp(seed):
    """Per-MB qp / qp_c arrays (adaptive quant): lambda and quantisers
    broadcast per MB; the ME lambda is their float32 mean."""
    rng = np.random.default_rng(seed)
    ref = _frame(0, seed=seed)
    cur = _frame(1, seed=seed)
    qp = rng.integers(18, 45, MBW * MBH).astype(np.int32)
    qpc = CHROMA_QP_TABLE[np.clip(qp + seed, 0, 51)].astype(np.int32)
    _run(cur, ref, qp, qpc, MBH)


@pytest.mark.parametrize("r0", [1, 3])
def test_per_mb_qp_band_scroll_and_chain(r0):
    """Everything the host encoder can combine: a band of 2 MB rows, a
    scroll candidate, per-MB QP and the skip-SAD chain."""
    rng = np.random.default_rng(9 + r0)
    ref = _frame(0, scroll=20, seed=3)
    cur = _frame(1, scroll=20, seed=3)
    band = (cur[0][16 * r0:16 * r0 + 32], cur[1][8 * r0:8 * r0 + 16],
            cur[2][8 * r0:8 * r0 + 16])
    n = 2 * MBW
    qp = rng.integers(20, 40, n).astype(np.int32)
    qpc = CHROMA_QP_TABLE[qp].astype(np.int32)
    _run(band, ref, qp, qpc, 2, row_off=16 * r0,
         extra_mv=np.array([0, 80], np.int32),
         prev_skip_sad=rng.integers(0, 300, n).astype(np.int32),
         prev_skip=rng.random(n) < 0.4)
