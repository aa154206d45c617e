"""Port parity: the decoder on B pictures and the 8x8 transform,
openh264_tpu_torch.decoder.H264Decoder on the CPU against the JAX
package's H264Decoder, frame for frame and byte for byte (tolerance 0);
per picture, the parsed FrameSymbols equal the JAX parser's (the fields
of test_torch_decoder_cabac.FS_FIELDS, transform8, pred_mode, refidx and
mv of both lists included, with ibs_mode, mb16 and the 8x8
coefficients; for CABAC also cbf_dc, gmvd and gdirect).

The streams (tests/test_torch_streams.py) are IDR and P pictures from
the port's encoder under a High-profile SPS of POC type 0, then, under a
second PPS with transform_8x8_mode:
- CAVLC B pictures from a hand MB writer (CavlcBWriter: B_Skip runs,
  B_Direct_16x16, B_L0/L1/Bi_16x16, B_16x8 / B_8x16 with BI partitions,
  B_8x8 with direct and other sub-MBs, I8x8 and I4x4 MBs, inter MBs
  with and without transform_size_8x8_flag and residual) with spatial
  and temporal direct, num_ref_idx overrides, an L1 modification, and
  weighted_bipred_idc 0, 1 (a pred_weight_table) and 2, one with sent
  4x4 and 8x8 scaling lists; the Python CAVLC parser decodes them;
- CABAC P, I and B pictures of seeded random bins that the port's own
  parser steers (BinChooser), in one slice or several, idc 0 and 2;
- CABAC P, I and B pictures whose slice data are seeded random bytes,
  each after the same IDR and P: both decoders take the same MBs or
  stop at the same error.
Then: the API and the console on a B stream, and two faults of the
reference that the port reproduces (ROADMAP.md §C): chunked input
releases the pictures decoded before the first B slice in decode order
(C8), and the Python intra recon of a picture with I8x8 MBs raises
TypeError on a chroma mode whose neighbour is missing (C7).

The port is held against the JAX package with openh264_compat=True: the
JAX decoder reproduces the OpenH264 decoder's B 16x8 / 8x16 BI
partitions and its deblocking of skipped and direct MBs, where the
port's default follows clause 8 (tests/test_torch_x264_high.py).
"""

import functools

import numpy as np
import pytest

import openh264_tpu.decoder.decoder as jax_decoder_mod
import openh264_tpu_torch.decoder.decoder as decoder_mod
from openh264_tpu.cli import h264dec as jax_h264dec
from openh264_tpu.decoder import H264Decoder as JaxDecoder
from openh264_tpu_torch.api import WelsCreateDecoder
from openh264_tpu_torch.bitstream import (BitWriter, NAL_SLICE,
                                          make_annexb_nal)
from openh264_tpu_torch.cli import h264dec
from openh264_tpu_torch.decoder import H264Decoder
from openh264_tpu_torch.decoder.decoder import write_yuv
from openh264_tpu_torch.decoder.framedata import (MB_BDIRECT, MB_BSKIP,
                                                  MB_B16x16, MB_B16x8,
                                                  MB_B8x16, MB_B8x8,
                                                  MB_I8x8)
from openh264_tpu_torch.decoder.wpred import WP_B_EXPLICIT, WP_B_IMPLICIT
from openh264_tpu_torch.encoder.config import EncoderConfig
from openh264_tpu_torch.encoder.encoder import H264Encoder

from test_torch_decoder import _equal
from test_torch_decoder_cabac import (CABAC_FIELDS, FS_FIELDS, jax_symbols,
                                      port_symbols, same_symbols)
from test_torch_streams import (B_KINDS, _frames, b_stream, cabac_prefix,
                                steered_cabac_stream,
                                write_slice_header_b)

B_FIELDS = FS_FIELDS + ("ibs_mode", "mb16")


def _same(syms, jsyms, fields):
    same_symbols(syms, jsyms, fields)
    for g, w in zip(syms, jsyms):
        assert (g.coeffs8 is None) == (getattr(w, "coeffs8", None) is None)
        if g.coeffs8 is not None:
            np.testing.assert_array_equal(g.coeffs8, w.coeffs8)


def _reached(syms):
    """The B MB kinds, I8x8 and 8x8-transform inter MBs among the
    correctly decoded MBs."""
    t = np.concatenate([s.mb_type[s.mb_correct] for s in syms])
    t8 = np.concatenate([s.transform8[s.mb_correct] for s in syms])
    return {"skip/direct": bool(np.isin(t, (MB_BSKIP, MB_BDIRECT)).any()),
            "16x16": bool((t == MB_B16x16).any()),
            "16x8/8x16": bool(np.isin(t, (MB_B16x8, MB_B8x16)).any()),
            "8x8": bool((t == MB_B8x8).any()),
            "I8x8": bool((t == MB_I8x8).any()),
            "t8 inter": bool((t8 & (t >= 4)).any())}


@pytest.mark.parametrize("idc,scaling", [(0, False), (1, True), (2, False)])
def test_cavlc_b_stream_matches_jax(idc, scaling, monkeypatch):
    bs, plans = b_stream(idc=idc, scaling=scaling, seed=idc)
    got, syms = port_symbols(bs, monkeypatch, ec_mode=0,
                             openh264_compat=True)
    want, jsyms = jax_symbols(bs, monkeypatch)
    _equal(got, want)
    _same(syms, jsyms, B_FIELDS)
    if idc == 2:
        _equal(got, JaxDecoder(use_jax_recon=True).decode_annexb(bs))
    # output in POC order, which is not decode order
    assert [f.poc for f in got] == [0, 2, 8, 14, 16]
    assert all(s.mb_correct.all() for s in syms)
    b_syms = syms[2::2]
    assert all(set(B_KINDS) <= set(p) for p in plans)
    assert all(_reached(b_syms).values())
    assert all(((s.pred_mode == m).any() for m in (0, 1, 2)
                for s in b_syms))
    modes = [s.wp_by_slice[0].mode for s in b_syms]
    assert modes == {0: [0, 0], 1: [WP_B_EXPLICIT] * 2,
                     2: [WP_B_IMPLICIT] * 2}[idc]
    if idc == 2:
        assert (b_syms[0].wp_by_slice[0].implicit_w0 != 32).any()


@functools.lru_cache(maxsize=None)
def _cabac_ip():
    """IDR and P pictures of the port's CABAC encoder at 176x144."""
    enc = H264Encoder(EncoderConfig(width=176, height=144, qp=28,
                                    entropy_cabac=True), device="cpu")
    return b"".join(enc.encode_frame(*f)
                    for f in _frames(2, 176, 144, seed=5))


@pytest.mark.parametrize("idc,scaling,rows", [(0, False, None),
                                              (2, True, None), (2, False, 1)])
def test_steered_cabac_stream_matches_jax(idc, scaling, rows, monkeypatch):
    """P, I and B pictures of random bins steered by the port's parser,
    in one slice or one slice per MB row; the parse must reach every B
    MB kind, I8x8 and 8x8-transform inter MBs."""
    bs = steered_cabac_stream(_cabac_ip(), idc=idc, scaling=scaling,
                              seed=idc + 3 * bool(rows),
                              rows_per_slice=rows)
    got, syms = port_symbols(bs, monkeypatch, ec_mode=0,
                             openh264_compat=True)
    want, jsyms = jax_symbols(bs, monkeypatch)
    _equal(got, want)
    _same(syms, jsyms, B_FIELDS + CABAC_FIELDS)
    assert len(got) == 6 and [f.poc for f in got] == [0, 8, 12, 16, 20, 24]
    assert all(s.mb_correct.all() for s in syms)
    reached = _reached(syms[2:])
    assert all(reached.values()), reached
    if rows:
        assert syms[3].slice_id.max() == 8


def _decode_or_error(bs, monkeypatch, port):
    """(frames or None, each picture's FrameSymbols after its parse, the
    TypeError's type or None) of the port's or the JAX decoder."""
    seen = []
    mod, name, dec = ((decoder_mod, "recon_frame_batch",
                       H264Decoder(device="cpu", openh264_compat=True))
                      if port else
                      (jax_decoder_mod, "recon_frame", JaxDecoder()))
    orig = getattr(mod, name)

    def spy(fs, *a, **k):
        seen.append(fs)
        return orig(fs, *a, **k)
    with monkeypatch.context() as m:
        m.setattr(mod, name, spy)
        try:
            return dec.decode_annexb(bs), seen, None
        except TypeError:
            return None, seen, TypeError


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_bytes_b_and_8x8_parse_alike(seed, monkeypatch):
    """P, I and B pictures (spatial, then temporal direct) whose slice
    data are seeded random bytes under the transform_8x8_mode PPS, each
    after the same IDR and P: both decoders parse the same symbols, and
    give the same pictures or raise the same error (the Python intra
    recon meets random chroma modes, reference fault C7). The parse
    reaches B_Skip / B_Direct, B_X_16x16, B_16x8 / B_8x16, I8x8 and
    8x8-transform inter MBs."""
    prefix, sps, pps1, n_pics = cabac_prefix(_cabac_ip(), 2 * (seed % 2),
                                             False, seed)
    rng = np.random.default_rng(seed)
    last = []
    for k, (stype, ref_idc, poc, spatial) in enumerate(
            ((5, 2, 16, None), (7, 2, 16, None), (6, 0, 4, True),
             (6, 0, 12, False))):
        w = BitWriter()
        write_slice_header_b(w, sps, pps1, n_pics, poc, slice_type=stype,
                             spatial=spatial, mod_l1=0 if spatial else None,
                             nal_ref_idc=ref_idc)
        w.byte_align(1)
        w.put_bytes(rng.integers(0, 256, 1200, dtype=np.uint8).tobytes())
        w.rbsp_trailing_bits()
        bs = prefix + make_annexb_nal(ref_idc, NAL_SLICE, w.get_bytes())
        got, syms, err = _decode_or_error(bs, monkeypatch, True)
        want, jsyms, jerr = _decode_or_error(bs, monkeypatch, False)
        assert err == jerr
        _same(syms, jsyms, B_FIELDS + CABAC_FIELDS)
        if err is None:
            _equal(got, want)
        last.append(syms[-1])
    # B_8x8 (1/64 of random B MBs) is held by the steered streams above
    reached = _reached(last)
    assert all(v for k, v in reached.items() if k != "8x8"), reached


def _chunks(bs, sizes=(1, 7, 133, 4097, 13)):
    pos, k = 0, 0
    while pos < len(bs):
        yield bs[pos:pos + sizes[k % len(sizes)]]
        pos += sizes[k % len(sizes)]
        k += 1


def test_reference_fault_feed_releases_before_first_b():
    """A fault of the JAX decoder that the port reproduces: fed in chunks
    (feed_annexb, and so the API's DecodeFrameNoDelay), it releases in
    decode order every picture decoded before the stream's first B slice
    (decoder.py:198: the POC reorder starts with _has_b_slices, set at
    :235), so the P picture that follows the IDR leaves before the B
    picture that precedes it in output order. decode_annexb and the
    console sort the whole stream. Both decoders give the same frames in
    the same order either way."""
    bs, _ = b_stream(idc=2, seed=7)
    whole = H264Decoder(device="cpu", openh264_compat=True).decode_annexb(bs)
    _equal(whole, JaxDecoder().decode_annexb(bs))
    out = []
    for dec in (H264Decoder(device="cpu", openh264_compat=True),
                JaxDecoder()):
        got = []
        for c in _chunks(bs):
            got += dec.feed_annexb(c)
        out.append(got + dec.flush())
    _equal(*out)
    assert [f.poc for f in out[0]] == [0, 8, 2, 14, 16]
    assert sorted(f.poc for f in out[0]) == [f.poc for f in whole]


def test_api_and_console_on_b_stream(tmp_path):
    """CWelsDecoder in odd-sized chunks gives H264Decoder's frames of a
    CAVLC B + 8x8 stream, and the JAX CWelsDecoder those of
    H264Decoder(openh264_compat=True); h264dec's file holds the former,
    the JAX console's the latter."""
    from openh264_tpu.api.decoder_api import WelsCreateDecoder as jax_api
    bs, _ = b_stream(idc=1, scaling=True, seed=4)
    want = H264Decoder(device="cpu").decode_annexb(bs)
    compat = H264Decoder(device="cpu",
                         openh264_compat=True).decode_annexb(bs)
    out = []
    for dec in (WelsCreateDecoder(device="cpu"), jax_api()):
        assert dec.Initialize() == 0
        frames = []
        for k in range(0, len(bs), 777):
            frames += dec.DecodeFrameNoDelay(bs[k:k + 777])[1]
        out.append(frames + dec.FlushFrame()[1])
    for got, ref in zip(out, (want, compat)):
        assert sorted(f.poc for f in got) == [f.poc for f in ref]
        _equal(sorted(got, key=lambda f: f.poc), ref)
    src = tmp_path / "in.264"
    src.write_bytes(bs)
    ours, theirs, direct, direct_compat = (
        tmp_path / n for n in ("a.yuv", "b.yuv", "c.yuv", "d.yuv"))
    assert h264dec.main([str(src), str(ours)], device="cpu") == 0
    assert jax_h264dec.main([str(src), str(theirs)]) == 0
    write_yuv(want, direct)
    write_yuv(compat, direct_compat)
    assert ours.read_bytes() == direct.read_bytes()
    assert theirs.read_bytes() == direct_compat.read_bytes()


def test_reference_fault_intra_missing_neighbour():
    """A fault of the JAX decoder that the port reproduces under
    openh264_compat: a picture with an I8x8 MB takes the per-MB Python
    intra recon for all its intra MBs (recon_batch.py:221-228), whose
    chroma predictor (oracle/intra.py:219) indexes the missing top row of
    an MB on the picture's top edge that asks for vertical chroma
    prediction: both decoders raise TypeError (out of the recon, which
    is not concealed), where the reference's C refuses the mode and
    conceals. By default the port's host C intra recon takes the picture
    and predicts from zeros, as it does in a picture without I8x8."""
    n_mb = 6 * 4
    plan = ["i8x8"] + ["skip"] * (n_mb - 1)
    bs, _ = b_stream(seed=1, n_pairs=1, plans=[plan], chroma_mode=2)
    with pytest.raises(TypeError):
        H264Decoder(device="cpu", openh264_compat=True).decode_annexb(bs)
    with pytest.raises(TypeError):
        JaxDecoder().decode_annexb(bs)
    assert len(H264Decoder(device="cpu").decode_annexb(bs)) == 3
    # with DC chroma the same picture decodes alike
    bs, _ = b_stream(seed=1, n_pairs=1, plans=[plan], chroma_mode=0)
    _equal(H264Decoder(device="cpu", openh264_compat=True).decode_annexb(bs),
           JaxDecoder().decode_annexb(bs))
