"""Port parity: encoder/core_torch.py against encoder/core_jax.py.

Same numpy frames through both packages; every key of every returned
dict must be equal exactly (an integer codec: "close" is a fault).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from openh264_tpu.encoder import core_jax as cj
from openh264_tpu_torch.encoder import core_torch as ct

MBW, MBH = 6, 5
W, H = MBW * 16, MBH * 16


def _content(rng, i, kind):
    """Frame i of a moving test sequence: 'noise' (random texture rolled
    2 px a frame plus noise) or 'smooth' (a drifting gradient with a
    static region, which gives skips and zero residuals)."""
    yy, xx = np.mgrid[0:H, 0:W]
    if kind == "noise":
        base = np.random.default_rng(5).integers(0, 256, (H, W))
        y = np.roll(base, 2 * i, axis=1) + rng.integers(-3, 4, (H, W))
    else:
        y = (xx * 2 + yy + 3 * i) % 256 + 40 * np.sin((xx - 2 * i) / 9.0)
        y[:, :32] = 100 + (yy[:, :32] // 8)
    cy, cx = np.mgrid[0:H // 2, 0:W // 2]
    u = (cx * 3 + cy + i) % 256
    v = (200 - cx - 2 * cy + rng.integers(-2, 3, cx.shape)) % 256
    return tuple(np.clip(a, 0, 255).astype(np.uint8) for a in (y, u, v))


def _check(got: dict, want: dict, keys=None):
    keys = keys or want.keys()
    assert set(got) >= set(keys)
    for k in keys:
        g = got[k].numpy()
        w = np.asarray(want[k])
        assert g.shape == w.shape, (k, g.shape, w.shape)
        np.testing.assert_array_equal(g.astype(np.int64),
                                      w.astype(np.int64), err_msg=k)
        if w.dtype in (np.uint8, np.bool_):
            assert g.dtype == w.dtype, (k, g.dtype, w.dtype)


def _t(*arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]


@pytest.mark.parametrize("qp,kind", [(26, "noise"), (36, "smooth"),
                                     (18, "smooth")])
def test_encode_i_frame(qp, kind):
    rng = np.random.default_rng(qp)
    y, u, v = _content(rng, 0, kind)
    qpc = max(qp - 2, 0)
    want = cj.encode_i_frame(jnp.asarray(y), jnp.asarray(u), jnp.asarray(v),
                             qp, qpc, mb_w=MBW, mb_h=MBH)
    got = ct.encode_i_frame(*_t(y, u, v), qp, qpc, MBW, MBH)
    _check(got, want)


def test_encode_i_frame_masked_with_init_recon():
    rng = np.random.default_rng(3)
    y, u, v = _content(rng, 1, "noise")
    init = _content(rng, 0, "smooth")
    mask = rng.random(MBW * MBH) < 0.5
    want = cj.encode_i_frame(jnp.asarray(y), jnp.asarray(u), jnp.asarray(v),
                             30, 29, mb_w=MBW, mb_h=MBH,
                             intra_mask=jnp.asarray(mask),
                             init_recon=tuple(map(jnp.asarray, init)))
    tin = _t(*init)
    got = ct.encode_i_frame(*_t(y, u, v), 30, 29, MBW, MBH,
                            intra_mask=torch.from_numpy(mask),
                            init_recon=tuple(tin))
    _check(got, want)
    for t, a in zip(tin, init):            # init_recon is not modified
        np.testing.assert_array_equal(t.numpy(), a)


@pytest.mark.parametrize("seed", [0, 1])
def test_chainfree_mask_and_i16_flat(seed):
    rng = np.random.default_rng(seed)
    y, u, v = _content(rng, 2, "noise")
    init = _content(rng, 1, "smooth")
    raw = rng.random(MBW * MBH) < 0.45
    want_m = cj.chainfree_intra_mask(jnp.asarray(raw), MBW, MBH)
    got_m = ct.chainfree_intra_mask(torch.from_numpy(raw), MBW, MBH)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    want = cj.encode_i16_flat(jnp.asarray(y), jnp.asarray(u), jnp.asarray(v),
                              28, 27, mb_w=MBW, mb_h=MBH, intra_mask=want_m,
                              init_recon=tuple(map(jnp.asarray, init)))
    got = ct.encode_i16_flat(*_t(y, u, v), 28, 27, MBW, MBH,
                             intra_mask=got_m, init_recon=tuple(_t(*init)))
    _check(got, want)


@pytest.mark.parametrize("qp,kind,chain", [(28, "noise", False),
                                           (32, "smooth", False),
                                           (32, "smooth", True),
                                           (22, "noise", True)])
def test_encode_p_frame(qp, kind, chain):
    rng = np.random.default_rng(qp + chain)
    ref = _content(rng, 0, kind)
    cur = _content(rng, 1, kind)
    qpc = qp - 1
    kw_j, kw_t = {}, {}
    if chain:
        sad = rng.integers(0, 400, MBW * MBH).astype(np.int32)
        skip = rng.random(MBW * MBH) < 0.5
        kw_j = dict(prev_skip_sad=jnp.asarray(sad),
                    prev_skip=jnp.asarray(skip))
        kw_t = dict(prev_skip_sad=torch.from_numpy(sad),
                    prev_skip=torch.from_numpy(skip))
    want = cj.encode_p_frame(*map(jnp.asarray, cur + ref), qp, qpc,
                             mb_w=MBW, mb_h=MBH, sr=8, **kw_j)
    got = ct.encode_p_frame(*_t(*(cur + ref)), qp, qpc, MBW, MBH, sr=8,
                            **kw_t)
    _check(got, want)
    if kind == "smooth":
        # the content exercises the skip path
        assert np.asarray(want["skip_mask"]).any()
