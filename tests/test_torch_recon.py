"""Port parity of the decoder's device modules on the CPU, byte for byte
(tolerance 0):
- ops/recon_torch.py (batched MC) against ops/recon_jax.py on random
  planes and vectors, with blocks far outside the picture and negative
  fractional vectors;
- decoder/recon_batch.py against the JAX package's recon_batch.py on
  random P FrameSymbols: inter MBs over two reference pictures, intra
  MBs, coefficients, explicit weighted prediction per slice;
- encoder/deblock_host.py (the deblock kernel's inputs) plus the plain
  deblock against the JAX oracle, oracle/deblock.py::deblock_frame, on
  random FrameSymbols with per-slice alpha/beta offsets, unequal Cb/Cr
  QP offsets, MBs missing as after a broken slice, and
  disable_deblocking_filter_idc 1 and 2.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from openh264_tpu.decoder import dpb as jdpb
from openh264_tpu.decoder import recon_batch as jrb
from openh264_tpu.decoder.framedata import FrameSymbols as JFS
from openh264_tpu.decoder.wpred import SliceWP as JWP
from openh264_tpu.oracle.deblock import deblock_frame as oracle_deblock
from openh264_tpu.ops import recon_jax
from openh264_tpu_torch.decoder import dpb as tdpb
from openh264_tpu_torch.decoder import recon_batch as trb
from openh264_tpu_torch.decoder.framedata import FrameSymbols as TFS
from openh264_tpu_torch.decoder.wpred import SliceWP as TWP
from openh264_tpu_torch.encoder import deblock_host
from openh264_tpu_torch.ops import recon_torch


@pytest.mark.parametrize("seed,h,w", [(0, 48, 64), (1, 16, 16),
                                      (2, 96, 80)])
def test_mc_matches_recon_jax(seed, h, w):
    rng = np.random.default_rng(seed)
    n = 700
    y = rng.integers(0, 256, (h, w), np.uint8)
    c = rng.integers(0, 256, (h // 2, w // 2), np.uint8)
    x0 = rng.integers(-2, w // 4, n).astype(np.int32) * 4
    y0 = rng.integers(-2, h // 4, n).astype(np.int32) * 4
    # vectors of a few pixels, and far outside the picture either way
    mv = rng.integers(-40, 41, (2, n)).astype(np.int32)
    far = rng.random(n) < 0.2
    mv[:, far] = rng.integers(-2000, 2001, (2, int(far.sum())))
    assert (mv < 0).any() and ((mv & 3) != 0).any()
    want_y = np.asarray(recon_jax._mc_luma_jit(y.astype(np.int32), x0, y0,
                                               mv[0], mv[1]))
    want_c = np.asarray(recon_jax._mc_chroma_jit(
        c.astype(np.int32), x0 // 2, y0 // 2, mv[0], mv[1]))
    t = [torch.from_numpy(a) for a in (x0, y0, mv[0], mv[1])]
    got_y = recon_torch.mc_luma(torch.from_numpy(y), *t)
    got_c = recon_torch.mc_chroma(torch.from_numpy(c), t[0] // 2, t[1] // 2,
                                  t[2], t[3])
    assert got_y.dtype == torch.uint8 and got_y.shape == (n, 4, 4)
    np.testing.assert_array_equal(got_y.numpy(), want_y)
    np.testing.assert_array_equal(got_c.numpy(), want_c)


def _p_symbols(seed, fs_cls, weighted):
    """Random P FrameSymbols of 6x4 MBs in 2 slices: P16x16 / P8x8 MBs
    with per-block vectors and refs 0/1 (DPB pics 5 and 9), a few I16x16
    and I4x4 MBs, random dequantized coefficients behind the cbp bits,
    explicit weights on slice 1 when `weighted`."""
    rng = np.random.default_rng(seed)
    fs = fs_cls(6, 4)
    n = fs.n_mb
    kind = rng.choice([0, 1, 4, 7, 8], n, p=[0.1, 0.1, 0.4, 0.2, 0.2])
    fs.mb_type[:] = kind
    fs.slice_id[:] = np.repeat([0, 1], n // 2)
    intra = kind < 4
    fs.i16_mode[:] = rng.integers(0, 4, n)
    fs.i4_modes[:] = rng.integers(0, 9, (n, 16))
    fs.chroma_mode[:] = rng.integers(0, 4, n)
    fs.mv[:, 0] = rng.integers(-37, 38, (n, 16, 2))
    ref = rng.integers(0, 2, (n, 4))
    fs.refidx[:, 0] = np.where(intra[:, None], -1, ref)
    fs.ref_pic[:, 0] = np.where(intra[:, None], -1, np.where(ref, 9, 5))
    fs.pred_mode[:] = np.where(intra[:, None], -1, 0)
    fs.cbp[:] = rng.integers(0, 48, n)
    coef = rng.integers(-40, 41, (n, 16, 16)) * (rng.random((n, 16, 16))
                                                 < 0.2)
    blk8 = (np.arange(16) // 8) * 2 + (np.arange(16) % 4) // 2
    fs.coeffs_l[:] = coef * ((fs.cbp[:, None] >> blk8[None]) & 1)[..., None]
    cc = rng.integers(-30, 31, (n, 2, 4, 16)) * (rng.random((n, 2, 4, 16))
                                                 < 0.3)
    fs.coeffs_c[:] = cc * ((fs.cbp & 0x30) != 0)[:, None, None, None]
    fs.mb_correct[:] = True
    fs.mb_correct[rng.random(n) < 0.1] = False
    wp = JWP if fs_cls is JFS else TWP
    weights = {(0, r): {"luma_weight": int(rng.integers(-20, 90)),
                        "luma_offset": int(rng.integers(-30, 30)),
                        "chroma_weight": [int(rng.integers(-10, 40)),
                                          int(rng.integers(-10, 40))],
                        "chroma_offset": [int(rng.integers(-20, 20)),
                                          int(rng.integers(-20, 20))]}
               for r in range(2)}
    fs.wp_by_slice = [wp(), wp(1, 5, 3, weights) if weighted else wp()]
    return fs


@pytest.mark.parametrize("seed,weighted", [(0, False), (1, True),
                                           (2, True)])
def test_recon_batch_matches_jax(seed, weighted):
    rng = np.random.default_rng(100 + seed)
    planes = {pid: [rng.integers(0, 256, s, np.uint8)
                    for s in ((64, 96), (32, 48), (32, 48))]
              for pid in (5, 9)}
    jrefs = {p: jdpb.Picture(p, *pl) for p, pl in planes.items()}
    trefs = {p: tdpb.Picture(p, *map(torch.from_numpy, pl))
             for p, pl in planes.items()}
    want = jrb.recon_frame_batch(_p_symbols(seed, JFS, weighted), jrefs)
    got = trb.recon_frame_batch(_p_symbols(seed, TFS, weighted), trefs,
                                False, torch.device("cpu"))
    for c in "yuv":
        np.testing.assert_array_equal(getattr(got, c).numpy(),
                                      getattr(want, c))


def _deblock_symbols(seed, fs_cls, dd):
    """FrameSymbols of 6x4 MBs in 3 slices (MB rows 0-1, 2, 3), each with
    its own alpha/beta offsets: I16 / P16x16 MBs with random motion and
    coefficient counts, QP 16-45, disable_deblock from `dd`, Cb/Cr QP
    offsets (3, -4), and some MBs missing."""
    rng = np.random.default_rng(seed)
    fs = fs_cls(6, 4)
    n = fs.n_mb
    intra = rng.random(n) < 0.25
    fs.mb_type[:] = np.where(intra, 1, 4)
    fs.slice_id[:] = np.repeat([0, 0, 1, 2], 6)
    offs = np.array([[4, -2], [-6, 6], [12, -12]])[fs.slice_id]
    fs.alpha_offset[:] = offs[:, 0]
    fs.beta_offset[:] = offs[:, 1]
    fs.qp[:] = rng.integers(16, 46, n)
    fs.mv[:, 0] = rng.integers(-6, 7, (n, 1, 2)) * (~intra)[:, None, None]
    fs.refidx[:, 0] = np.where(intra, -1, 0)[:, None]
    fs.ref_pic[:, 0] = np.where(intra, -1, 0)[:, None]
    fs.nzc_l[:] = rng.integers(0, 3, fs.nzc_l.shape) * \
        (rng.random(fs.nzc_l.shape) < 0.4)
    fs.disable_deblock[:] = dd(rng, n)
    fs.chroma_qp_offsets = (3, -4)
    missing = rng.random(n) < 0.15
    fs.mb_correct[:] = ~missing
    fs.mb_type[missing & (rng.random(n) < 0.5)] = -1
    return fs


def _blocky_planes(seed):
    rng = np.random.default_rng(seed)

    def plane(size):
        base = rng.integers(70, 130, (4, 6)).repeat(size, 0).repeat(size, 1)
        return (base + rng.integers(-3, 4, base.shape)).astype(np.uint8)
    return plane(16), plane(8), plane(8)


@pytest.mark.parametrize("seed,dd", [
    (0, lambda rng, n: np.zeros(n)),
    (1, lambda rng, n: np.full(n, 2)),
    (2, lambda rng, n: rng.integers(0, 3, n)),
    (3, lambda rng, n: np.where(rng.random(n) < 0.3, 1, 0)),
])
def test_deblock_with_offsets_matches_oracle(seed, dd):
    planes = _blocky_planes(seed)
    st = SimpleNamespace(y=planes[0].copy(), u=planes[1].copy(),
                         v=planes[2].copy())
    oracle_deblock(st, _deblock_symbols(seed, JFS, dd))
    assert not np.array_equal(st.y, planes[0])      # the filter acted
    got = deblock_host.deblock_frame(
        *[torch.from_numpy(p.copy()) for p in planes],
        _deblock_symbols(seed, TFS, dd))
    for g, w in zip(got, (st.y, st.u, st.v)):
        np.testing.assert_array_equal(g.numpy(), w)
    # the offsets and the two chroma QPs change the result
    fs = _deblock_symbols(seed, TFS, dd)
    fs.alpha_offset[:] = fs.beta_offset[:] = 0
    fs.chroma_qp_offsets = (0, 0)
    plain = deblock_host.deblock_frame(
        *[torch.from_numpy(p.copy()) for p in planes], fs)
    assert any(not torch.equal(a, b) for a, b in zip(plain, got))
