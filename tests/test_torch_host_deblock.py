"""Port parity: the host encoder's deblocking (encoder/deblock_host.py:
FrameSymbols -> bS grids, zeroed slice and disabled edges, QPs -> the
deblock kernel's plain version on the CPU) against the JAX package's
oracle, oracle.deblock.deblock_frame.

The FrameSymbols come from the JAX encoder itself (captured where it
deblocks: intra-in-P MBs, skips, per-MB QP, 3 slices), and from hand-made
grids with disable_deblock 1 and 2 and slice ids. The last tests record
what the JAX decoder makes of two reference faults (ROADMAP.md C): the
encoder's own recon ignores deblock_idc 2 at slice edges and the PPS
chroma QP offset.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from openh264_tpu.decoder import H264Decoder
from openh264_tpu.decoder.framedata import FrameSymbols as JFS
from openh264_tpu.encoder import encoder as jenc
from openh264_tpu.oracle.deblock import deblock_frame as oracle_deblock
from openh264_tpu_torch.decoder.framedata import FrameSymbols as TFS
from openh264_tpu_torch.encoder import deblock_host
from openh264_tpu_torch.encoder.config import EncoderConfig as TCfg
from openh264_tpu_torch.encoder.encoder import H264Encoder as TEnc

W, H = 96, 64


def _frames(n, seed=0):
    rng = np.random.default_rng(seed)
    tall = rng.integers(0, 256, (4 * H, W + 16))
    yy, xx = np.mgrid[0:4 * H, 0:W + 16]
    tex = (tall // 3 + 60 * np.sin(xx / 5.0) + 40 * np.cos(yy / 7.0)
           + 80).clip(0, 255)
    cy, cx = np.mgrid[0:H // 2, 0:W // 2]
    out = []
    for i in range(n):
        y = tex[H + 2 * i:2 * H + 2 * i, i:i + W] + rng.integers(-2, 3,
                                                                 (H, W))
        y[32:48, 16:48] = 40 + 30 * i            # a block that changes
        # chroma: a ramp plus texture, so that chroma edges get filtered
        u = (cx * 3 + cy + 2 * i) % 200 + tall[:H // 2, :W // 2] // 16
        v = (200 - cx - 2 * cy + i) % 200 + tall[H:H + H // 2, :W // 2] // 16
        out.append(tuple(np.clip(a, 0, 255).astype(np.uint8)
                         for a in (y, u, v)))
    return out


def _port_fs(jfs) -> TFS:
    fs = TFS(jfs.mb_w, jfs.mb_h)
    for k, v in vars(jfs).items():
        if isinstance(v, np.ndarray):
            setattr(fs, k, v.copy())
    return fs


def _check(planes, jfs):
    """The port's deblock of `planes` under jfs equals the oracle's."""
    st = SimpleNamespace(y=planes[0].copy(), u=planes[1].copy(),
                         v=planes[2].copy())
    oracle_deblock(st, jfs)
    got = deblock_host.deblock_frame(
        *[torch.from_numpy(p.copy()) for p in planes], _port_fs(jfs))
    for g, w in zip(got, (st.y, st.u, st.v)):
        np.testing.assert_array_equal(g.numpy(), w)
    return [not np.array_equal(w, p) for w, p in zip((st.y, st.u, st.v),
                                                     planes)]


def _captured(kw, n, seed, monkeypatch):
    """(pre-deblock planes, FrameSymbols) of every frame the JAX encoder
    deblocks under kw."""
    seen = []

    def capture(st, fs):
        seen.append(((st.y.copy(), st.u.copy(), st.v.copy()), fs))
        oracle_deblock(st, fs)
    monkeypatch.setattr(jenc, "deblock_frame", capture)
    enc = jenc.H264Encoder(jenc.EncoderConfig(width=W, height=H, **kw))
    for f in _frames(n, seed):
        enc.encode_frame(*f)
    return seen


@pytest.mark.parametrize("name,kw", [
    ("intra_in_p", dict(qp=30)),
    ("per_mb_qp", dict(qp=30, enable_adaptive_quant=True,
                       enable_gom_rc=True)),
    ("slices3", dict(qp=32, num_slices=3)),
])
def test_encoder_frame_symbols(name, kw, monkeypatch):
    seen = _captured(kw, 4, 1, monkeypatch)
    assert len(seen) == 4
    changed = [_check(p, fs) for p, fs in seen]
    assert any(any(c) for c in changed)        # the filter acted
    p_fs = [fs for _p, fs in seen[1:]]
    if name == "intra_in_p":
        assert any((fs.mb_type == 1).any() for fs in p_fs)   # intra MBs
    if name == "per_mb_qp":
        assert any(len(np.unique(fs.qp)) > 1 for fs in p_fs)
    if name == "slices3":
        assert all(set(fs.slice_id) == {0, 1, 2} for _p, fs in seen)


def _random_fs(seed, dd):
    """FrameSymbols of 6x4 MBs: I16 / P16x16 MBs with random motion and
    coefficient counts, QP 20-45 per MB, 3 slices of MB rows, and
    disable_deblock per MB from `dd`."""
    rng = np.random.default_rng(seed)
    fs = JFS(6, 4)
    n = fs.n_mb
    intra = rng.random(n) < 0.25
    fs.mb_type[:] = np.where(intra, 1, 4)
    fs.slice_id[:] = np.repeat([0, 0, 1, 2], 6)
    fs.qp[:] = rng.integers(20, 46, n)
    fs.mv[:, 0] = rng.integers(-6, 7, (n, 1, 2)) * (~intra)[:, None, None]
    fs.refidx[:, 0] = np.where(intra, -1, 0)[:, None]
    fs.ref_pic[:, 0] = np.where(intra, -1, 0)[:, None]
    fs.nzc_l[:] = rng.integers(0, 3, fs.nzc_l.shape) * \
        (rng.random(fs.nzc_l.shape) < 0.4)
    fs.disable_deblock[:] = dd(rng, n)
    return fs


def _blocky_planes(seed):
    rng = np.random.default_rng(seed)

    def plane(size):
        base = rng.integers(70, 130, (4, 6)).repeat(size, 0).repeat(size, 1)
        return (base + rng.integers(-3, 4, base.shape)).astype(np.uint8)
    return plane(16), plane(8), plane(8)


@pytest.mark.parametrize("seed,dd", [
    (0, lambda rng, n: np.full(n, 2)),
    (1, lambda rng, n: np.full(n, 2)),
    (2, lambda rng, n: rng.integers(0, 3, n)),
    (3, lambda rng, n: rng.integers(0, 3, n)),
    (4, lambda rng, n: np.where(rng.random(n) < 0.3, 1, 0)),
])
def test_hand_made_disable_deblock(seed, dd):
    """disable_deblock 2 (no filtering across the slice edges, so the
    MB rows at slice tops keep their top edges) and 1 (no edge of that MB
    filtered), mixed per MB."""
    fs = _random_fs(seed, dd)
    assert any(_check(_blocky_planes(seed), fs))


def test_inputs_zero_the_skipped_edges():
    """deblock_inputs zeroes exactly the slice-top edges of idc-2 MBs and
    every edge of idc-1 MBs; the QPs pass through, the chroma QP with
    offset 0 as one row for both planes, and zero offsets as None."""
    from openh264_tpu_torch.oracle.deblock_bs import precompute_bs
    from openh264_tpu_torch.tables import CHROMA_QP_TABLE
    fs = _port_fs(_random_fs(5, lambda rng, n: np.full(n, 2)))
    fs.disable_deblock[7] = 1                    # MB (1, 1)
    bsv0, bsh0 = precompute_bs(fs)
    bsv, bsh, qp, cqp, ao, bo = deblock_host.deblock_inputs(fs)
    assert ao is None and bo is None
    np.testing.assert_array_equal(qp, fs.qp)
    np.testing.assert_array_equal(cqp, CHROMA_QP_TABLE[fs.qp])
    want_h = bsh0.copy()
    want_h[8, :] = 0                             # slice tops: MB rows 2, 3
    want_h[12, :] = 0
    want_v = bsv0.copy()
    want_v[4:8, 4:8] = 0
    want_h[4:8, 4:8] = 0
    np.testing.assert_array_equal(bsv, want_v)
    np.testing.assert_array_equal(bsh, want_h)


def test_inputs_refuse_offsets():
    """Alpha / beta offsets and two chroma QP offsets, which the kernel
    once refused, now pass through per MB (the decoder's slices carry
    them). The 8x8 transform, which deblock_inputs refused too, is
    covered by test_torch_recon_b.py::test_deblock_8x8_matches_oracle."""
    from openh264_tpu_torch.tables import CHROMA_QP_TABLE
    fs = _port_fs(_random_fs(6, lambda rng, n: np.zeros(n)))
    fs.alpha_offset[:] = 2
    fs.beta_offset[3] = -4
    fs.chroma_qp_offsets = (2, -3)
    _bsv, _bsh, qp, cqp, ao, bo = deblock_host.deblock_inputs(fs)
    np.testing.assert_array_equal(ao, fs.alpha_offset)
    np.testing.assert_array_equal(bo, fs.beta_offset)
    np.testing.assert_array_equal(cqp, CHROMA_QP_TABLE[
        np.clip(np.stack([qp + 2, qp - 3]), 0, 51)])


def _decoder_drift(kw, n=3):
    """Per frame, whether the JAX decoder's picture differs from the
    port encoder's DPB recon of the same frame."""
    enc = TEnc(TCfg(width=W, height=H, **kw), device="cpu")
    bs, recon = [], []
    for f in _frames(n, 2):
        bs.append(enc.encode_frame(*f))
        recon.append([p.numpy().copy() for p in enc.dpb[-1].planes])
    dec = H264Decoder().decode_annexb(b"".join(bs))
    assert len(dec) == n
    return [any(not np.array_equal(getattr(d, c), r)
                for c, r in zip("yuv", rec)) for d, rec in zip(dec, recon)]


def test_reference_fault_idc2_recon_drifts():
    """deblock_idc 2 with 3 slices: the slice header tells the decoder not
    to filter across slice edges, but the encoder's recon is filtered
    there (its FrameSymbols carry disable_deblock 0). The decoder's
    pictures differ from the encoder's reference from the IDR on."""
    assert _decoder_drift(dict(qp=32, num_slices=3, deblock_idc=2)) == \
        [True, True, True]
    assert _decoder_drift(dict(qp=32, num_slices=3, deblock_idc=0)) == \
        [False, False, False]


def test_reference_fault_chroma_offset_recon_drifts():
    """chroma_qp_offset 4: the PPS carries the offset and the decoder
    deblocks chroma with it, while the encoder deblocks chroma with
    offset 0, so their chroma differs from the IDR on."""
    assert _decoder_drift(dict(qp=32, chroma_qp_offset=4)) == \
        [True, True, True]
