"""Port parity: encoder/deblock_torch.py against encoder/deblock_jax.py
and the Pallas kernel (interpret mode). The CUDA kernel's own tests are
in test_torch_cuda.py.

Same numpy inputs through both packages; the uint8 planes and int32 bS
grids must be equal exactly.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from openh264_tpu.encoder import deblock_jax as dj
from openh264_tpu.encoder.deblock_pallas import deblock_frame_pallas
from openh264_tpu.encoder import session_device as jsd
from openh264_tpu_torch.encoder import deblock_torch as dt
from openh264_tpu_torch.encoder import session_device as tsd

GRIDS = [(6, 5, 0), (4, 7, 1), (9, 3, 2)]


def _blocky(rng, mbw, mbh, size):
    """Flat MBs a few levels apart plus noise: edges the filter acts on
    (uniform random pixels rarely pass the alpha/beta tests)."""
    base = rng.integers(80, 120, (mbh, mbw)).repeat(size, 0).repeat(size, 1)
    return (base + rng.integers(-3, 4, base.shape)).astype(np.uint8)


def _inputs(mbw, mbh, seed, blocky=False):
    rng = np.random.default_rng(seed)
    H, W = mbh * 16, mbw * 16
    if blocky:
        planes = (_blocky(rng, mbw, mbh, 16), _blocky(rng, mbw, mbh, 8),
                  _blocky(rng, mbw, mbh, 8))
    else:
        planes = (rng.integers(0, 256, (H, W), np.uint8),
                  rng.integers(0, 256, (H // 2, W // 2), np.uint8),
                  rng.integers(0, 256, (H // 2, W // 2), np.uint8))
    return planes + (
            rng.integers(0, 5, (mbh * 4, mbw * 4), np.int32),
            rng.integers(0, 5, (mbh * 4, mbw * 4), np.int32),
            rng.integers(18, 42, mbw * mbh, np.int32),
            rng.integers(18, 42, mbw * mbh, np.int32))


def _eq(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mbw,mbh,seed", GRIDS)
def test_encoder_bs_matches_jax(mbw, mbh, seed):
    rng = np.random.default_rng(seed)
    n = mbw * mbh
    nz = rng.random((n, 16)) < 0.3
    intra = rng.random(n) < 0.2
    mv = rng.integers(-9, 10, (n, 2)).astype(np.int32)
    mv[rng.random(n) < 0.4] = 0
    want = dj.encoder_bs(jnp.asarray(nz), jnp.asarray(intra),
                         jnp.asarray(mv), mbw, mbh)
    got = dt.encoder_bs(torch.from_numpy(nz), torch.from_numpy(intra),
                        torch.from_numpy(mv), mbw, mbh)
    for g, w in zip(got, want):
        _eq(g, w)


@pytest.mark.parametrize("mbw,mbh,seed,blocky",
                         [g + (False,) for g in GRIDS] + [(6, 5, 10, True),
                                                          (9, 3, 11, True)])
def test_plain_deblock_matches_jax_and_pallas(mbw, mbh, seed, blocky):
    args = _inputs(mbw, mbh, seed, blocky)
    want = dj.deblock_frame_device(*map(jnp.asarray, args), mbw, mbh)
    pallas = deblock_frame_pallas(*map(jnp.asarray, args), mbw, mbh,
                                  interpret=True)
    tin = [torch.from_numpy(a) for a in args]
    got = dt.deblock_frame_device(*tin, mbw, mbh)
    for g, w, p in zip(got, want, pallas):
        _eq(g, w)
        _eq(g, p)
    if blocky:       # the filter changed the planes
        assert not np.array_equal(got[0].numpy(), args[0])
    # inputs untouched, and the CPU dispatch takes the plain version
    for t, a in zip(tin, args):
        np.testing.assert_array_equal(t.numpy(), a)
    for g, a in zip(dt.deblock_frame_auto(*tin, mbw, mbh), got):
        assert torch.equal(g, a)


def test_deblock_ms_idc2_zero_rows():
    """Frame deblock after a multi-slice encode with deblock idc 2: the
    band-top MB rows' horizontal MB edges stay unfiltered."""
    mbw, mbh = 6, 5
    rng = np.random.default_rng(7)
    n = mbw * mbh
    y, u, v = (_blocky(rng, mbw, mbh, s) for s in (16, 8, 8))
    nz = rng.random((n, 16)) < 0.3
    intra = rng.random(n) < 0.3
    mv = rng.integers(-9, 10, (n, 2)).astype(np.int32)
    zero_rows = (2, 4)
    want = jsd._deblock_ms(jnp.asarray(y), jnp.asarray(u), jnp.asarray(v),
                           jnp.asarray(nz), jnp.asarray(intra),
                           jnp.asarray(mv), jnp.int32(30), jnp.int32(29),
                           mbw, mbh, zero_rows)
    got = tsd._deblock_ms(torch.from_numpy(y), torch.from_numpy(u),
                          torch.from_numpy(v), torch.from_numpy(nz),
                          torch.from_numpy(intra), torch.from_numpy(mv),
                          30, 29, mbw, mbh, zero_rows)
    for g, w in zip(got, want):
        _eq(g, w)
    no_zero = tsd._deblock_ms(torch.from_numpy(y), torch.from_numpy(u),
                              torch.from_numpy(v), torch.from_numpy(nz),
                              torch.from_numpy(intra), torch.from_numpy(mv),
                              30, 29, mbw, mbh, ())
    assert not torch.equal(got[0], no_zero[0])

