"""Port parity: encoder/entropy_torch.py against encoder/entropy_jax.py.

Token grids (values and lengths), packed bytes, end bit and overflow
flag must be equal exactly for the same numpy symbols.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from openh264_tpu.encoder import entropy_jax as ej
from openh264_tpu_torch.encoder import entropy_torch as et

MBW, MBH = 6, 5
N = MBW * MBH


def _levels(rng, shape, p_nz, big=False):
    """Sparse signed levels: mostly +-1/+-2 (trailing ones), some large,
    and with `big` a few escape-sized ones (level codes >= 30)."""
    mag = rng.geometric(0.55, shape)
    if big:
        mag = np.where(rng.random(shape) < 0.05,
                       rng.integers(20, 3000, shape), mag)
    sign = np.where(rng.random(shape) < 0.5, -1, 1)
    return (mag * sign * (rng.random(shape) < p_nz)).astype(np.int32)


def _symbols(rng, intra=True, big=False, skip_frac=0.3):
    mv = rng.integers(-24, 25, (N, 2)).astype(np.int32)
    mv[rng.random(N) < 0.3] = 0
    skip = rng.random(N) < skip_frac
    luma = _levels(rng, (N, 16, 16), 0.25, big)
    luma[rng.random((N, 16)) < 0.5] = 0
    cdc = _levels(rng, (N, 2, 4), 0.4, big)
    cac = _levels(rng, (N, 2, 4, 16), 0.15, big)
    cac[rng.random((N, 2)) < 0.5] = 0
    luma[skip], cdc[skip], cac[skip] = 0, 0, 0
    sym = {"mv": mv, "luma_ac": luma, "chroma_dc": cdc, "chroma_ac": cac}
    if intra:
        im = (rng.random(N) < 0.25) & ~skip
        sym.update({
            "intra_mask": im,
            "i16_mode": np.where(im, rng.integers(0, 4, N), 0).astype(
                np.int32),
            "chroma_mode": np.where(im, rng.integers(0, 4, N), 0).astype(
                np.int32),
            "luma_dc": np.where(im[:, None, None],
                                _levels(rng, (N, 4, 4), 0.5, big), 0
                                ).astype(np.int32)})
        sym["luma_ac"][im, :, 0] = 0       # I16 AC blocks carry no DC
    return sym


def _eq(got, want, what):
    g = got.numpy()
    w = np.asarray(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    np.testing.assert_array_equal(g.astype(np.int64), w.astype(np.int64),
                                  err_msg=what)


def _torch(sym):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in sym.items()}


@pytest.mark.parametrize("seed,intra,big,n_valid",
                         [(0, True, False, None), (1, False, False, None),
                          (2, True, True, None), (3, True, False, 20),
                          (4, False, True, 13)])
def test_p_slice_tokens(seed, intra, big, n_valid):
    rng = np.random.default_rng(seed)
    sym = _symbols(rng, intra, big)
    want = ej.p_slice_tokens({k: jnp.asarray(v) for k, v in sym.items()},
                             MBW, MBH, 30, n_valid=n_valid)
    got = et.p_slice_tokens(_torch(sym), MBW, MBH, n_valid=n_valid)
    _eq(got[0], want[0], "vals")
    _eq(got[1], want[1], "lens")
    assert got[1].dtype == torch.uint8


def test_p_slice_tokens_all_skip():
    """No coded MB: the body is one trailing skip run."""
    sym = _symbols(np.random.default_rng(9), intra=False, skip_frac=1.0)
    sym["mv"][:] = 0
    want = ej.p_slice_tokens({k: jnp.asarray(v) for k, v in sym.items()},
                             MBW, MBH, 30)
    got = et.p_slice_tokens(_torch(sym), MBW, MBH)
    _eq(got[0], want[0], "vals")
    _eq(got[1], want[1], "lens")
    assert int((got[1] > 0).sum()) == 1


@pytest.mark.parametrize("seed,big", [(5, False), (6, True)])
def test_i_slice_tokens(seed, big):
    rng = np.random.default_rng(seed)
    sym = _symbols(rng, intra=True, big=big, skip_frac=0.0)
    sym["luma_ac"][:, :, 0] = 0
    sym["i16_mode"] = rng.integers(0, 4, N).astype(np.int32)
    sym["chroma_mode"] = rng.integers(0, 4, N).astype(np.int32)
    sym["luma_dc"] = _levels(rng, (N, 4, 4), 0.5, big)
    want = ej.i_slice_tokens({k: jnp.asarray(v) for k, v in sym.items()},
                             MBW, MBH)
    got = et.i_slice_tokens(_torch(sym), MBW, MBH)
    _eq(got[0], want[0], "vals")
    _eq(got[1], want[1], "lens")


@pytest.mark.parametrize("start_bit,max_bytes,max_tok",
                         [(0, 1 << 14, 1 << 18), (5, 1 << 14, 1 << 18),
                          (3, 1 << 9, 1 << 18), (7, 1 << 14, 200)])
def test_pack_tokens_device(start_bit, max_bytes, max_tok):
    """Large buffers pack the whole slice; a tiny buffer (or token
    budget) overflows, with the out-of-range bytes dropped."""
    rng = np.random.default_rng(start_bit)
    sym = _symbols(rng, intra=True, big=True)
    av, al = ej.p_slice_tokens({k: jnp.asarray(v) for k, v in sym.items()},
                               MBW, MBH, 30)
    want = ej.pack_tokens_device(av, al, start_bit, max_bytes, max_tok)
    got = et.pack_tokens_device(torch.from_numpy(np.asarray(av)),
                                torch.from_numpy(np.asarray(al)),
                                start_bit, max_bytes, max_tok)
    _eq(got[0], want[0], "bytes")
    assert got[0].dtype == torch.uint8
    assert int(got[1]) == int(want[1])
    assert bool(got[2]) == bool(want[2])
    assert bool(got[2]) == (max_bytes < (1 << 14) or max_tok < (1 << 18))


def test_p_slice_tokens_bands_match_per_band_jax():
    """The band-batched tokenizer of the multi-slice step equals the JAX
    tokenizer run on each band with its own n_valid."""
    rng = np.random.default_rng(12)
    bands = [_symbols(rng, intra=True, big=bool(i == 1)) for i in range(3)]
    n_valid = [N, 24, 18]
    stacked = {k: torch.from_numpy(np.stack([b[k] for b in bands]))
               for k in bands[0]}
    got = et.p_slice_tokens_bands(stacked, MBW, MBH,
                                  torch.tensor(n_valid, dtype=torch.int32))
    for i, (b, nv) in enumerate(zip(bands, n_valid)):
        want = ej.p_slice_tokens({k: jnp.asarray(v) for k, v in b.items()},
                                 MBW, MBH, 30, n_valid=nv)
        _eq(got[0][i], want[0], f"vals band {i}")
        _eq(got[1][i], want[1], f"lens band {i}")
