"""Port parity: the decoder on CABAC streams, openh264_tpu_torch.decoder.
H264Decoder on the CPU against the JAX package's H264Decoder on both of
its recon paths (the numpy batch and use_jax_recon=True), frame for
frame and byte for byte (tolerance 0); per picture, the parsed
FrameSymbols equal the JAX parser's.

The streams are CABAC from the port's H264Encoder(entropy_cabac=True) and
from the API at 96x64 and 128x96 in the configurations of
test_torch_cabac.py (one slice with an IDR interval, intra-in-P, two and
four fixed slices, rate control with adaptive quant, LTR with a recovery
request; the CABAC writer codes I16x16, P16x16 and P_Skip MBs only, so
the I4x4 setting gives I16x16 there), and each decodes to the encoder's
own reconstruction. Then: the residual bins in C against their Python
twin on seeded bins; a hand-built CABAC I slice with IPCM, I4x4 and
I16x16 MBs; P slices of seeded random bytes, which reach the MB types
and the ref_idx / sub_mb_type / IPCM syntax that no encoder writes; and
CWelsDecoder and the h264dec console on a CABAC stream.
"""

import functools

import numpy as np
import pytest

import openh264_tpu.decoder.decoder as jax_decoder_mod
import openh264_tpu_torch.decoder.decoder as decoder_mod
from openh264_tpu.cli import h264dec as jax_h264dec
from openh264_tpu.decoder import H264Decoder as JaxDecoder
from openh264_tpu_torch.api import (SEncParamExt, WelsCreateDecoder,
                                    WelsCreateSVCEncoder)
from openh264_tpu_torch.bitstream import (BitWriter, NAL_IDR, NAL_PPS,
                                          NAL_SLICE, NAL_SPS,
                                          make_annexb_nal, split_annexb)
from openh264_tpu_torch.cli import h264dec
from openh264_tpu_torch.decoder import H264Decoder
from openh264_tpu_torch.decoder import cabac as C
from openh264_tpu_torch.decoder.decoder import write_yuv
from openh264_tpu_torch.decoder.framedata import MB_I4x4, MB_IPCM
from openh264_tpu_torch.decoder.params import parse_pps, parse_sps
from openh264_tpu_torch.decoder.slice_dec_cabac import (
    CabacResidualC, residual_levels_plain)
from openh264_tpu_torch.encoder.cabac_enc import CabacEncoder, CabacSliceWriter
from openh264_tpu_torch.encoder.config import EncoderConfig
from openh264_tpu_torch.encoder.headers import write_slice_header
from openh264_tpu_torch.encoder.encoder import H264Encoder
from openh264_tpu_torch.tables import ZSCAN_TO_RASTER

from test_torch_decoder import _equal
from test_torch_streams import _frames, _headers, _write_pps

# FrameSymbols fields the two parsers must agree on
FS_FIELDS = ("mb_type", "slice_id", "i16_mode", "chroma_mode", "i4_modes",
             "cbp", "qp", "mv", "refidx", "ref_pic", "pred_mode", "coeffs_l",
             "coeffs_c", "nzc_l", "nzc_c", "disable_deblock", "alpha_offset",
             "beta_offset", "mb_correct", "transform8", "gmv", "gref")
CABAC_FIELDS = ("cbf_dc", "gmvd", "gdirect")


def _new_object(fr, seed):
    """A block of fresh noise that jumps every frame from frame 1 on: no
    reference matches it, so the P pictures code intra MBs there."""
    rng = np.random.default_rng(seed + 100)
    for i in range(1, len(fr)):
        y = fr[i][0]
        x = 16 * i % (y.shape[1] - 16)
        y[16:48, x:x + 32] = rng.integers(0, 256, (32, 32))
    return fr


# name: (encoder settings, frames, (width, height), frame -> call)
STREAMS = {
    "idr_interval": (dict(qp=28, idr_interval=3), 5, (96, 64), {}),
    "intra_in_p": (dict(qp=28), 4, (96, 64), {}),
    "slices2": (dict(qp=27, num_slices=2, idr_interval=3), 4, (96, 64), {}),
    "slices4": (dict(qp=30, num_slices=4), 3, (128, 96), {}),
    "rc_aq": (dict(qp=28, rc_mode=1, target_bitrate=300_000,
                   enable_adaptive_quant=True, enable_gom_rc=True), 4,
              (96, 64), {}),
    "i4x4_setting": (dict(qp=26, enable_i4x4=True), 3, (96, 64), {}),
    "ltr_recovery": (dict(qp=28, enable_ltr=True, ltr_mark_period=2), 6,
                     (96, 64), {4: "ltr_recovery_request"}),
    "api": (dict(iEntropyCodingModeFlag=1, iRCMode=-1, iInitialQp=30), 3,
            (96, 64), {}),
}


@functools.lru_cache(maxsize=None)
def _stream(name):
    """(Annex-B bytes, the encoder's deblocked reconstruction per coded
    frame)."""
    kw, n, (w, h), calls = STREAMS[name]
    fr = _new_object(_frames(n, w, h, seed=len(name)), len(name))
    if name == "api":
        api = WelsCreateSVCEncoder(device="cpu")
        assert api.InitializeExt(SEncParamExt(iPicWidth=w, iPicHeight=h,
                                              **kw)) == 0
        encode, enc = api.EncodeFrame, api._enc
    else:
        enc = H264Encoder(EncoderConfig(width=w, height=h, entropy_cabac=True,
                                        **kw), device="cpu")
        encode = enc.encode_frame
    assert enc.cfg.entropy_cabac
    out, recon = [], []
    for i, f in enumerate(fr):
        if i in calls:
            getattr(enc, calls[i])()
        out.append(encode(*f))
        if out[-1]:
            recon.append([p.numpy().copy() for p in enc.dpb[-1].planes])
    return b"".join(out), recon


def port_symbols(bs, monkeypatch, **kw):
    """The port's frames and each picture's FrameSymbols after its parse."""
    seen = []
    orig = decoder_mod.recon_frame_batch

    def spy(fs, *a, **k):
        seen.append(fs)
        return orig(fs, *a, **k)
    with monkeypatch.context() as m:
        m.setattr(decoder_mod, "recon_frame_batch", spy)
        frames = H264Decoder(device="cpu", **kw).decode_annexb(bs)
    return frames, seen


def jax_symbols(bs, monkeypatch):
    """The JAX decoder's frames and each picture's FrameSymbols."""
    seen = []
    orig = jax_decoder_mod.recon_frame

    def spy(fs, *a, **k):
        seen.append(fs)
        return orig(fs, *a, **k)
    with monkeypatch.context() as m:
        m.setattr(jax_decoder_mod, "recon_frame", spy)
        frames = JaxDecoder().decode_annexb(bs)
    return frames, seen


def same_symbols(got, want, fields=FS_FIELDS):
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        for f in fields:
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f),
                                          err_msg=f"picture {k}: {f}")
        assert sorted(g.ipcm) == sorted(w.ipcm)
        for i in g.ipcm:
            for a, b in zip(g.ipcm[i], w.ipcm[i]):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", list(STREAMS))
def test_cabac_decoder_matches_jax(name, monkeypatch):
    bs, recon = _stream(name)
    kw, n, (w, h), _calls = STREAMS[name]
    got, syms = port_symbols(bs, monkeypatch)
    want, jsyms = jax_symbols(bs, monkeypatch)
    assert len(got) == len(recon) and len(got) >= n - 1
    _equal(got, want)
    _equal(got, JaxDecoder(use_jax_recon=True).decode_annexb(bs))
    same_symbols(syms, jsyms, FS_FIELDS + CABAC_FIELDS)
    # no reference fault of ROADMAP.md §C applies (deblock idc 0, chroma
    # QP offset 0): the port decodes its own CABAC to its encoder's DPB
    for f, rec in zip(got, recon):
        for c, r in zip("yuv", rec):
            np.testing.assert_array_equal(getattr(f, c), r)
    # the stream exercises what its name says
    if name == "intra_in_p":
        assert any((s.mb_type <= 3).any() and (s.mb_type >= 4).any()
                   for s in syms)
    if name == "rc_aq":
        assert any(len(set(s.qp.tolist())) > 1 for s in syms)
    if name in ("slices2", "slices4"):
        assert max(int(s.slice_id.max()) for s in syms) + 1 == \
            int(name[-1])
    if name == "ltr_recovery":
        hdrs = _headers(bs)
        assert any(s.mmco_ops or s.long_term_reference_flag for s in hdrs)
        assert any(s.ref_pic_list_modification[0] for s in hdrs)


def _engine_pair(data, qp):
    """Two engines with their contexts over the same bytes."""
    out = []
    for _ in range(2):
        ctx = C.CabacContexts(False, 1, qp)
        out.append((C.CabacEngine(data, 13), ctx))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_residual_c_equals_python_twin(seed):
    """csrc/cabac_residual.c against the Python bin loop on seeded random
    bytes: every block category (the 8x8 one too), with Python decisions
    between the blocks, so the engine state passes back and forth; the
    levels, counts, engine states and contexts stay equal, runaway codes
    included."""
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, 6000, dtype=np.uint8).tobytes()
    (ea, ca), (eb, cb) = _engine_pair(data, 20 + 7 * seed)
    cres = CabacResidualC(data, ca)
    props = [C.I16_DC, C.I16_AC, C.LUMA_4x4, C.CHROMA_DC, C.CHROMA_AC,
             C.LUMA_8x8]
    blocks = 0
    while eb.pos < 8 * len(data) - 600:
        if rng.random() < 0.3:
            idx = int(rng.integers(0, C.N_CTX))
            assert ea.decision(ca, idx) == eb.decision(cb, idx)
            continue
        prop = props[int(rng.integers(0, len(props)))]
        try:
            want = residual_levels_plain(eb, cb, prop)
        except ValueError:
            with pytest.raises(ValueError):
                cres.levels(ea, prop)
            break
        got = cres.levels(ea, prop)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
        assert (ea.pos, ea.range, ea.offset) == (eb.pos, eb.range, eb.offset)
        blocks += 1
    np.testing.assert_array_equal(ca.state, cb.state)
    np.testing.assert_array_equal(ca.mps, cb.mps)
    assert blocks > 100


# ---------------------------------------------------------------------------
# A hand-built CABAC I slice: IPCM, I4x4 and I16x16 MBs
# ---------------------------------------------------------------------------
_KINDS = "PIDIPDIIPDIP"    # per MB of a 4x3 picture: P IPCM, I I4x4, D I16


def _i4_mode(rng, gx, gy):
    """A 4x4 intra mode whose neighbours exist (one slice)."""
    modes = [2] + ([0, 3, 7] if gy > 0 else []) + \
        ([1, 8] if gx > 0 else []) + ([4, 5, 6] if gx > 0 and gy > 0 else [])
    return int(rng.choice(modes))


def _hand_built_ipcm_slice(seed=0):
    """SPS/PPS of the port's CABAC encoder and one IDR slice of 64x48
    whose MBs are _KINDS: IPCM samples (the engine flushes, the samples
    follow at the next byte, a new engine starts after them), I4x4 with
    seeded modes and no residual, I16x16 DC with a random luma DC block.
    Returns the stream, the IPCM samples per MB and the I4x4 modes."""
    rng = np.random.default_rng(seed)
    mb_w, mb_h, qp = 4, 3, 28
    enc = H264Encoder(EncoderConfig(width=16 * mb_w, height=16 * mb_h, qp=qp,
                                    entropy_cabac=True), device="cpu")
    w = BitWriter()
    write_slice_header(w, enc.cfg, 2, 0, 0, qp, True, 0, disable_deblock=0)
    w.byte_align(1)                      # cabac_alignment_one_bit
    sw = CabacSliceWriter(mb_w, mb_h, qp, is_i=True)
    is_i4 = np.zeros(mb_w * mb_h, bool)
    i4_grid = np.full((4 * mb_h, 4 * mb_w), 2)
    ipcm, modes = {}, {}
    for idx, kind in enumerate(_KINDS):
        mbx, mby = idx % mb_w, idx // mb_w
        left = idx - 1 if mbx > 0 else -1
        top = idx - mb_w if mby > 0 else -1
        inc = sum(1 for n in (left, top) if n >= 0 and not is_i4[n])
        sw.mb_intra[idx] = True
        if kind == "I":
            sw.eng.decision(sw.bctx, C.CTX_MB_TYPE_I + inc, 0)
            is_i4[idx] = True
            m = np.zeros(16, int)
            for k in range(16):
                r = int(ZSCAN_TO_RASTER[k])
                gx, gy = 4 * mbx + r % 4, 4 * mby + r // 4
                pred = 2
                if gx > 0 and gy > 0:
                    pred = min(i4_grid[gy, gx - 1], i4_grid[gy - 1, gx])
                mode = _i4_mode(rng, gx, gy)
                if mode == pred:
                    sw.eng.decision(sw.bctx, C.CTX_IPR, 1)
                else:
                    sw.eng.decision(sw.bctx, C.CTX_IPR, 0)
                    rem = mode if mode < pred else mode - 1
                    for b in range(3):
                        sw.eng.decision(sw.bctx, C.CTX_IPR + 1, (rem >> b) & 1)
                i4_grid[gy, gx] = mode
                m[r] = mode
            modes[idx] = m
            sw.intra_chroma_pred_mode(idx, 0)
            sw.write_cbp(idx, 0)
            sw.last_dqp = 0
        elif kind == "D":
            dc = np.zeros(16, np.int32)
            dc[rng.choice(16, 3, replace=False)] = rng.integers(-9, 10, 3)
            dc[0] = 5
            # mb_type I_16x16_2_0_0 (raw 3): the writer's own context
            # would count I4x4 neighbours, which its encoder never writes
            sw.eng.decision(sw.bctx, C.CTX_MB_TYPE_I + inc, 1)
            sw.eng.terminate(0)
            for ctx_off, bit in ((3, 0), (4, 0), (6, 1), (7, 0)):
                sw.eng.decision(sw.bctx, C.CTX_MB_TYPE_I + ctx_off, bit)
            sw.intra_chroma_pred_mode(idx, 0)
            sw.record_cbp(idx, 0)
            sw.delta_qp(0)
            sw.cbf(idx, C.I16_DC, 1, dc_bit=0)
            sw.residual_levels(C.I16_DC, dc)
        else:
            # mb_type I_PCM: the first bin, then terminate 1 (a flush); the
            # padding to the byte is the pcm_alignment_zero_bits
            sw.eng.decision(sw.bctx, C.CTX_MB_TYPE_I + inc, 1)
            sw.eng.terminate(1)
            sw.eng.write_to(w)
            y = rng.integers(0, 256, (16, 16), dtype=np.uint8)
            u = rng.integers(0, 256, (8, 8), dtype=np.uint8)
            v = rng.integers(0, 256, (8, 8), dtype=np.uint8)
            w.put_bytes(y.tobytes() + u.tobytes() + v.tobytes())
            ipcm[idx] = (y, u, v)
            sw.eng = CabacEncoder()
            sw.cbf_dc[idx] = 7
            sw.nzc_l[4 * mby:4 * mby + 4, 4 * mbx:4 * mbx + 4] = 16
            sw.nzc_c[:, 2 * mby:2 * mby + 2, 2 * mbx:2 * mbx + 2] = 16
            sw.record_cbp(idx, 0x2f)
            sw.last_dqp = 0
        sw.mb_coded[idx] = True
        sw.end_of_slice(idx == len(_KINDS) - 1)
    sw.eng.write_to(w)
    bs = enc.headers_annexb() + make_annexb_nal(3, NAL_IDR, w.get_bytes())
    return bs, ipcm, modes


def test_hand_built_ipcm_i4x4_slice(monkeypatch):
    """Both decoders read the hand-built slice alike; the IPCM samples come
    out unfiltered (QP 0 edges), and the I4x4 modes are those written."""
    bs, ipcm, modes = _hand_built_ipcm_slice()
    got, syms = port_symbols(bs, monkeypatch)
    want, jsyms = jax_symbols(bs, monkeypatch)
    assert len(got) == 1
    _equal(got, want)
    _equal(got, JaxDecoder(use_jax_recon=True).decode_annexb(bs))
    same_symbols(syms, jsyms, FS_FIELDS + CABAC_FIELDS)
    fs = syms[0]
    assert fs.mb_correct.all()
    assert [int(t) for t in fs.mb_type] == [
        {"P": MB_IPCM, "I": MB_I4x4, "D": 1}[k] for k in _KINDS]
    for idx, m in modes.items():
        np.testing.assert_array_equal(fs.i4_modes[idx], m)
    f = got[0]
    for idx, (y, u, v) in ipcm.items():
        mbx, mby = idx % 4, idx // 4
        np.testing.assert_array_equal(
            f.y[16 * mby:16 * mby + 16, 16 * mbx:16 * mbx + 16], y)
        np.testing.assert_array_equal(
            f.u[8 * mby:8 * mby + 8, 8 * mbx:8 * mbx + 8], u)
        np.testing.assert_array_equal(
            f.v[8 * mby:8 * mby + 8, 8 * mbx:8 * mbx + 8], v)


# ---------------------------------------------------------------------------
# P slices of random bytes
# ---------------------------------------------------------------------------
def _random_p_slices(seed, n_pics=3):
    """The idr_interval stream's SPS, PPS (rewritten to 3 active L0
    references) and IDR, then P pictures whose slice data are seeded
    random bytes: the CABAC parse then meets every P and intra MB type,
    sub_mb_type, ref_idx and IPCM."""
    bs, _ = _stream("idr_interval")
    nals = split_annexb(bs)
    sps = parse_sps(next(n for n in nals if n.nal_unit_type == NAL_SPS).rbsp)
    pps = parse_pps(next(n for n in nals if n.nal_unit_type == NAL_PPS).rbsp,
                    {sps.sps_id: sps})
    pps.num_ref_idx_l0_active = 3
    cfg = EncoderConfig(width=96, height=64, qp=28, entropy_cabac=True)
    out = [make_annexb_nal(3, NAL_SPS, next(
               n.rbsp for n in nals if n.nal_unit_type == NAL_SPS)),
           make_annexb_nal(3, NAL_PPS, _write_pps(pps)),
           next(make_annexb_nal(n.nal_ref_idc, n.nal_unit_type, n.rbsp)
                for n in nals if n.nal_unit_type == NAL_IDR)]
    rng = np.random.default_rng(seed)
    for k in range(1, n_pics + 1):
        w = BitWriter()
        write_slice_header(w, cfg, 0, k, 0, 28, False, 0, disable_deblock=0)
        w.byte_align(1)
        w.put_bytes(rng.integers(0, 256, 1500, dtype=np.uint8).tobytes())
        w.rbsp_trailing_bits()
        out.append(make_annexb_nal(2, NAL_SLICE, w.get_bytes()))
    return b"".join(out)


@pytest.mark.parametrize("seed", [0, 1])
def test_random_p_slices_parse_alike(seed, monkeypatch):
    """Seeded random slice data: both parsers take the same MBs (or stop
    at the same error, which both conceal), write the same symbols, and
    both decoders give the same pictures on every recon path."""
    bs = _random_p_slices(seed)
    got, syms = port_symbols(bs, monkeypatch, ec_mode=2)
    want, jsyms = jax_symbols(bs, monkeypatch)
    same_symbols(syms, jsyms, FS_FIELDS + CABAC_FIELDS)
    _equal(got, want)
    _equal(got, JaxDecoder(use_jax_recon=True).decode_annexb(bs))
    types = set(np.concatenate([s.mb_type[s.mb_correct] for s in syms[1:]]))
    assert len(types) >= 4


def test_api_and_console_on_cabac(tmp_path):
    """CWelsDecoder and h264dec give H264Decoder's frames of a CABAC
    stream (the console's file equals the JAX console's too)."""
    bs, _ = _stream("slices2")
    want = H264Decoder(device="cpu").decode_annexb(bs)
    dec = WelsCreateDecoder(device="cpu")
    assert dec.Initialize() == 0
    frames = []
    for k in range(0, len(bs), 700):
        frames += dec.DecodeFrameNoDelay(bs[k:k + 700])[1]
    frames += dec.FlushFrame()[1]
    _equal(frames, want)
    src = tmp_path / "in.264"
    src.write_bytes(bs)
    ours, theirs, direct = (tmp_path / n for n in ("a.yuv", "b.yuv",
                                                     "c.yuv"))
    assert h264dec.main([str(src), str(ours)], device="cpu") == 0
    assert jax_h264dec.main([str(src), str(theirs)]) == 0
    write_yuv(want, direct)
    assert ours.read_bytes() == theirs.read_bytes() == direct.read_bytes()


def _p_picture_without_residual(chroma_offset):
    """An IDR from the port's CABAC encoder with a chroma QP offset, then a
    hand-built CABAC P picture whose MBs are all P16x16 with cbp 0 and
    motion that changes from MB to MB (bS 1 edges): no MB of it parses a
    residual."""
    mb_w, mb_h, qp = 6, 4, 30
    enc = H264Encoder(EncoderConfig(width=16 * mb_w, height=16 * mb_h, qp=qp,
                                    entropy_cabac=True,
                                    chroma_qp_offset=chroma_offset),
                      device="cpu")
    bs = enc.encode_frame(*_frames(1, 16 * mb_w, 16 * mb_h, seed=4)[0])
    w = BitWriter()
    write_slice_header(w, enc.cfg, 0, 1, 0, qp, False, 0, disable_deblock=0)
    w.byte_align(1)                      # cabac_alignment_one_bit
    sw = CabacSliceWriter(mb_w, mb_h, qp, is_i=False)
    for idx in range(mb_w * mb_h):
        gx, gy = 4 * (idx % mb_w), 4 * (idx // mb_w)
        sw.skip_flag(idx, 0)
        sw.mb_type_p16x16()
        mvd = (12 if idx % 2 else -12, 8 * ((idx // mb_w) % 2))
        for comp in (0, 1):
            sw.mvd_comp(idx, comp, gx, gy, mvd[comp])
        sw.mvd[gy:gy + 4, gx:gx + 4] = mvd
        sw.write_cbp(idx, 0)
        sw.last_dqp = 0
        sw.mb_coded[idx] = True
        sw.end_of_slice(idx == mb_w * mb_h - 1)
    sw.eng.write_to(w)
    return bs + make_annexb_nal(2, NAL_SLICE, w.get_bytes())


def test_reference_fault_chroma_offset_without_residual(monkeypatch):
    """A fault of the JAX decoder that the port reproduces: its per-MB
    parsers (CABAC, and the Python CAVLC parser) set the picture's chroma
    QP offsets for the deblock only where an MB parses a residual
    (slice_dec_cabac.py:543-544, slice_dec.py:235-236), while its C
    parser sets them for every slice. A picture with no residual MB is
    deblocked with chroma offset 0 whatever its PPS says. Both decoders
    agree; the PPS's offset would filter its chroma differently."""
    bs = _p_picture_without_residual(6)
    got, syms = port_symbols(bs, monkeypatch)
    _equal(got, jax_symbols(bs, monkeypatch)[0])
    assert len(got) == 2 and (syms[1].cbp == 0).all()
    assert not hasattr(syms[1], "chroma_qp_offsets")
    assert syms[0].chroma_qp_offsets == (6, 6)
    orig = decoder_mod.deblock_frame

    def with_pps_offsets(y, u, v, fs):
        fs.chroma_qp_offsets = (6, 6)
        return orig(y, u, v, fs)
    with monkeypatch.context() as m:
        m.setattr(decoder_mod, "deblock_frame", with_pps_offsets)
        spec = H264Decoder(device="cpu").decode_annexb(bs)
    np.testing.assert_array_equal(spec[1].y, got[1].y)
    assert not np.array_equal(spec[1].u, got[1].u)
