"""Port parity of the decoder's recon and deblock inputs for B pictures and
the 8x8 transform, byte for byte (tolerance 0), on the CPU:
- decoder/recon_batch.py against the JAX package's recon_batch.py on
  seeded B FrameSymbols: L0, L1 and BI 4x4 blocks over three reference
  pictures, B16x8 / B8x16 MBs with BI partitions (the reference's
  GetInterBPred behaviour under openh264_compat, both lists by
  default), plain average, explicit and implicit
  weights per slice, inter MBs with the 8x8 transform, and intra MBs
  with I8x8 among them (the Python intra recon) or without (host C);
- encoder/deblock_host.py (the deblock kernel's inputs, 8x8-transform
  MBs' interior luma edges zeroed) plus the plain deblock against the
  JAX oracle, oracle/deblock.py::deblock_frame, on random planes and
  FrameSymbols with random transform8 masks, B motion in both lists,
  the direct / skip interior-bS modes, disable-deblock modes and
  alpha/beta offsets.
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
from openh264_tpu_torch.decoder import dpb as tdpb
from openh264_tpu_torch.decoder import recon_batch as trb
from openh264_tpu_torch.decoder.framedata import FrameSymbols as TFS
from openh264_tpu_torch.decoder.wpred import SliceWP as TWP
from openh264_tpu_torch.encoder import deblock_host

PIDS = (5, 9, 12)


def _b_symbols(seed, fs_cls, wmodes, intra8):
    """Seeded B FrameSymbols of 6x4 MBs in 2 slices with the WP modes
    `wmodes` (0 none, 2 B explicit, 3 B implicit): B16x16 / B16x8 /
    B8x16 / B8x8 / B_Skip / B_Direct MBs with per-quadrant L0/L1/BI and
    refs 0-2 (DPB pics PIDS), the 8x8 transform on some inter MBs, a
    few intra MBs (I8x8 among them when `intra8`), random dequantized
    coefficients behind the cbp bits."""
    rng = np.random.default_rng(seed)
    fs = fs_cls(6, 4)
    n = fs.n_mb
    kinds = [9, 10, 11, 12, 13, 14, 1, 0] + ([3] if intra8 else [])
    p = np.array([0.2, 0.15, 0.15, 0.15, 0.1, 0.1, 0.05, 0.05, 0.05][
        :len(kinds)])
    fs.mb_type[:] = rng.choice(kinds, n, p=p / p.sum())
    fs.mb_type[fs.mb_type == 3] = 0
    fs.mb_type[[8, 9]] = (10, 11)          # B16x8, B8x16 (BI below)
    if intra8:
        fs.mb_type[[7, 19]] = 3            # I8x8 MBs off the slice edges
    intra = fs.mb_type < 4
    mbx, mby = np.arange(n) % 6, np.arange(n) // 6
    edge = (mbx == 0) | (mby % 2 == 0)
    fs.slice_id[:] = np.repeat([0, 1], n // 2)
    fs.i16_mode[:] = np.where(edge, 2, rng.integers(0, 4, n))
    fs.i4_modes[:] = rng.integers(0, 9, (n, 16))
    fs.chroma_mode[:] = np.where(edge, 0, rng.integers(0, 4, n))
    pm = rng.integers(0, 3, (n, 4))
    pm[8:10] = 2
    fs.pred_mode[:] = np.where(intra[:, None], -1, pm)
    for lx in range(2):
        use = ~intra[:, None] & ((pm == lx) | (pm == 2))
        ref = rng.integers(0, 3, (n, 4))
        fs.refidx[:, lx] = np.where(use, ref, -1)
        fs.ref_pic[:, lx] = np.where(use, np.asarray(PIDS)[ref], -1)
        fs.mv[:, lx] = rng.integers(-41, 42, (n, 16, 2))
    fs.cbp[:] = rng.integers(0, 48, n)
    fs.transform8[:] = (~intra & (rng.random(n) < 0.5)) | (fs.mb_type == 3)
    blk8 = (np.arange(16) // 8) * 2 + (np.arange(16) % 4) // 2
    coef = rng.integers(-40, 41, (n, 16, 16)) * (rng.random((n, 16, 16))
                                                 < 0.2)
    fs.coeffs_l[:] = coef * ((fs.cbp[:, None] >> blk8[None]) & 1)[..., None] \
        * ~fs.transform8[:, None, None]
    fs.ensure_coeffs8()
    c8 = rng.integers(-300, 301, (n, 4, 64)) * (rng.random((n, 4, 64)) < 0.1)
    fs.coeffs8[:] = c8 * ((fs.cbp[:, None] >> np.arange(4)) & 1)[..., None] \
        * fs.transform8[:, None, None]
    cc = rng.integers(-30, 31, (n, 2, 4, 16)) * (rng.random((n, 2, 4, 16))
                                                 < 0.3)
    fs.coeffs_c[:] = cc * ((fs.cbp & 0x30) != 0)[:, None, None, None]
    fs.mb_correct[:] = True
    fs.mb_correct[rng.random(n) < 0.08] = False
    fs.mb_correct[[7, 8, 9, 19]] = True
    wp = JWP if fs_cls is JFS else TWP
    wps = []
    for mode in wmodes:
        if mode == 2:
            weights = {(lx, r): {
                "luma_weight": int(rng.integers(-20, 90)),
                "luma_offset": int(rng.integers(-30, 30)),
                "chroma_weight": [int(rng.integers(-10, 40)),
                                  int(rng.integers(-10, 40))],
                "chroma_offset": [int(rng.integers(-20, 20)),
                                  int(rng.integers(-20, 20))]}
                for lx in (0, 1) for r in range(3) if rng.random() < 0.8}
            wps.append(wp(2, 5, 3, weights))
        elif mode == 3:
            wps.append(wp(3, 5, 5, None,
                          rng.integers(-20, 90, (3, 2)).astype(np.int32)))
        else:
            wps.append(wp())
    fs.wp_by_slice = wps
    return fs


@pytest.mark.parametrize("seed,wmodes,intra8", [
    (0, (0, 0), True), (1, (2, 3), True), (2, (3, 2), False),
    (3, (2, 0), True), (4, (3, 3), False)])
def test_recon_batch_b_matches_jax(seed, wmodes, intra8):
    rng = np.random.default_rng(100 + seed)
    planes = {pid: [rng.integers(0, 256, s, np.uint8)
                    for s in ((64, 96), (32, 48), (32, 48))]
              for pid in PIDS}
    jrefs = {p: jdpb.Picture(p, *pl) for p, pl in planes.items()}
    trefs = {p: tdpb.Picture(p, *map(torch.from_numpy, pl))
             for p, pl in planes.items()}
    jfs = _b_symbols(seed, JFS, wmodes, intra8)
    quirk = (jfs.pred_mode == 2).any(1) & np.isin(jfs.mb_type, (10, 11))
    assert quirk.any() and (jfs.transform8 & (jfs.mb_type >= 4)).any()
    assert (jfs.mb_type == 3).any() == intra8
    want = jrb.recon_frame_batch(jfs, jrefs)
    tfs = _b_symbols(seed, TFS, wmodes, intra8)
    tfs.openh264_compat = True      # the JAX module's BI partitions
    got = trb.recon_frame_batch(tfs, trefs, False, torch.device("cpu"))
    for c in "yuv":
        np.testing.assert_array_equal(getattr(got, c).numpy(),
                                      getattr(want, c))
    # by default a BI partition of a B16x8 / B8x16 MB is predicted from
    # both lists (clause 8.4.2): those MBs move, and intra MBs that
    # predict from them, nothing else
    tfs = _b_symbols(seed, TFS, wmodes, intra8)
    plain = trb.recon_frame_batch(tfs, trefs, False, torch.device("cpu"))
    moved = (plain.y.numpy() != want.y).reshape(4, 16, 6, 16).any(
        (1, 3)).reshape(-1)
    assert (moved & quirk).any() and not (moved & ~quirk
                                          & (jfs.mb_type >= 4)).any()


def _deblock_symbols(seed, fs_cls, dd):
    """FrameSymbols of 6x4 MBs in 3 slices with their own alpha/beta
    offsets: I16 / I8x8 / B16x16 / B8x8 / B_Skip / B_Direct MBs with
    random motion in both lists and refs over two DPB pictures, the
    direct interior-bS modes (ibs_mode) and 16x16 promotions, coefficient
    counts, QP 16-45, the 8x8 transform on about half the MBs,
    disable_deblock from `dd`, Cb/Cr QP offsets (2, -3), some MBs
    missing."""
    rng = np.random.default_rng(seed)
    fs = fs_cls(6, 4)
    n = fs.n_mb
    fs.mb_type[:] = rng.choice([1, 3, 9, 12, 13, 14], n)
    intra = fs.mb_type < 4
    fs.slice_id[:] = np.repeat([0, 0, 1, 2], 6)
    offs = np.array([[4, -2], [-6, 6], [12, -12]])[fs.slice_id]
    fs.alpha_offset[:] = offs[:, 0]
    fs.beta_offset[:] = offs[:, 1]
    fs.qp[:] = rng.integers(16, 46, n)
    pm = rng.integers(0, 3, (n, 4))
    fs.pred_mode[:] = np.where(intra[:, None], -1, pm)
    for lx in range(2):
        use = ~intra[:, None] & ((pm == lx) | (pm == 2))
        ref = rng.integers(0, 2, (n, 4))
        fs.refidx[:, lx] = np.where(use, ref, -1)
        fs.ref_pic[:, lx] = np.where(use, ref * 4 + 1, -1)
        fs.mv[:, lx] = rng.integers(-7, 8, (n, 16, 2)) * \
            (rng.random((n, 1, 1)) < 0.7)
    fs.ibs_mode[:] = np.where(fs.mb_type == 13, 2,
                              np.where(fs.mb_type == 14,
                                       rng.integers(0, 2, n), 0))
    fs.mb16[:] = rng.random(n) < 0.3
    fs.nzc_l[:] = rng.integers(0, 3, fs.nzc_l.shape) * \
        (rng.random(fs.nzc_l.shape) < 0.4)
    fs.transform8[:] = (rng.random(n) < 0.5) | (fs.mb_type == 3)
    fs.disable_deblock[:] = dd(rng, n)
    fs.chroma_qp_offsets = (2, -3)
    missing = rng.random(n) < 0.1
    fs.mb_correct[:] = ~missing
    return fs


def _blocky_planes(seed):
    """Planes of 4x4-sample luma (2x2 chroma) blocks with small steps
    between them: every 4-sample edge, interior ones too, has something
    to filter."""
    rng = np.random.default_rng(seed)
    y = rng.integers(60, 140, (16, 24)).repeat(4, 0).repeat(4, 1)
    u = rng.integers(60, 140, (16, 24)).repeat(2, 0).repeat(2, 1)
    v = rng.integers(60, 140, (16, 24)).repeat(2, 0).repeat(2, 1)
    return tuple((p + rng.integers(-2, 3, p.shape)).clip(0, 255).astype(
        np.uint8) for p in (y, u, v))


@pytest.mark.parametrize("seed,dd", [
    (0, lambda rng, n: np.zeros(n)),
    (1, lambda rng, n: np.full(n, 2)),
    (2, lambda rng, n: rng.integers(0, 3, n)),
    (3, lambda rng, n: np.where(rng.random(n) < 0.3, 1, 0)),
])
def test_deblock_8x8_matches_oracle(seed, dd):
    """The plain deblock over deblock_inputs equals the oracle, which
    skips an 8x8-transform MB's interior luma edges (deblock.py:214-216)
    where deblock_inputs zeroes them. Clearing every transform8 flag
    changes the result, both through those edges and through the bS
    that precompute_bs derives from transform8 (its t8g grid)."""
    planes = _blocky_planes(seed)
    st = SimpleNamespace(y=planes[0].copy(), u=planes[1].copy(),
                         v=planes[2].copy())
    oracle_deblock(st, _deblock_symbols(seed, JFS, dd))
    got = deblock_host.deblock_frame(
        *[torch.from_numpy(p.copy()) for p in planes],
        _deblock_symbols(seed, TFS, dd))
    for g, w in zip(got, (st.y, st.u, st.v)):
        np.testing.assert_array_equal(g.numpy(), w)
    fs = _deblock_symbols(seed, TFS, dd)
    bsv, bsh = deblock_host.deblock_inputs(fs)[:2]
    t8 = np.repeat(np.repeat(fs.transform8.reshape(4, 6), 4, 0), 4, 1)
    assert not bsv[:, 1::2][t8[:, 1::2]].any()
    assert not bsh[1::2][t8[1::2]].any()
    fs.transform8[:] = False
    bsv4, bsh4 = deblock_host.deblock_inputs(fs)[:2]
    assert bsv4[:, 1::2][t8[:, 1::2]].any()       # interior edges back
    assert (bsv4[:, 0::2] != bsv[:, 0::2]).any() or \
        (bsh4[0::2] != bsh[0::2]).any()           # t8g changes bS too
    plain = deblock_host.deblock_frame(
        *[torch.from_numpy(p.copy()) for p in planes], fs)
    assert not torch.equal(plain[0], got[0])
