"""Port parity: the decoder's host C CABAC slice parser
(csrc/parse_cabac.c through cbind.parse_cabac_slice_native) against
its Python twin (slice_dec_cabac.decode_slice_mbs_cabac), and the
routing between them.

- Parity: each CABAC slice of a stream, I, P or B, with or without the
  8x8 transform, is parsed once by the C and once, in a second decode,
  by the Python parser in its place. After every slice, every
  FrameSymbols array (the CABAC neighbour grids cbf_dc, gmvd and
  gdirect, the motion grids of both lists, transform8, the 8x8
  coefficients, the direct records sub_direct, mb16 and, under
  openh264_compat, ibs_mode, the IPCM samples and the chroma QP offsets
  included), the end MB and the engine's end bit are equal, and a slice
  that fails raises the same exception class with the same MBs marked
  correct. The streams: every CABAC stream of test_torch_decoder_cabac.py
  (one, two and four slices, intra-in-P, RC with adaptive quant, LTR),
  one under 4x4 scaling lists, the hand-built IPCM / I4x4 / I16x16
  slice, a P picture without residual under a chroma QP offset, seeded
  random-byte P slices (one and three references in the DPB), P pictures
  with a runaway mvd or mb_qp_delta code, and truncated slices; then B
  and the 8x8 transform: the first pictures of both x264 High streams of
  tests/data (B-pyramid, weighted prediction, three references, spatial
  direct), the steered random CABAC P, I and B streams of
  test_torch_streams.py (spatial and temporal direct, with and without
  4x4 and 8x8 scaling lists, one slice a row, direct_8x8_inference 0),
  seeded random-byte B, I and P slices under the transform_8x8_mode PPS,
  a truncated B slice and a steered B picture with a runaway mvd. (The
  tests' b_stream is CAVLC: the steered streams are its CABAC
  counterpart.)
- Routing: every slice without FMO takes the C, B and 8x8 included; FMO
  takes the Python parser. The routing rule (slice_dec.c_parses) says
  so of each slice's header, and the counters cabac_c_mbs, cabac_python_mbs
  and cabac_bins on each decoder.parse span say which, cabac_bins equals
  the bins the Python twin decodes, and nothing is recorded with the
  recorder off.
All comparisons are exact.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import openh264_tpu_torch.decoder.cbind as cbind
import openh264_tpu_torch.decoder.slice_dec_cabac as sdc
from openh264_tpu_torch.bitstream import (BitWriter, NAL_IDR, NAL_PPS,
                                          NAL_SLICE, make_annexb_nal,
                                          split_annexb)
from openh264_tpu_torch.decoder import H264Decoder
from openh264_tpu_torch.decoder.cabac import CTX_MVD, CabacEngine
from openh264_tpu_torch.decoder.framedata import MB_B16x16
from openh264_tpu_torch.decoder.params import parse_pps
from openh264_tpu_torch.decoder.slice_dec import c_parses
from openh264_tpu_torch.encoder.cabac_enc import CabacSliceWriter
from openh264_tpu_torch.encoder.config import EncoderConfig
from openh264_tpu_torch.encoder.encoder import H264Encoder
from openh264_tpu_torch.encoder.headers import write_slice_header
from openh264_tpu_torch.utils import trace

import test_torch_decoder_cabac as tcabac
from test_torch_decoder import _equal
from test_torch_decoder_b import _cabac_ip
from test_torch_streams import (BinChooser, _frames, _headers, _write_pps,
                                cabac_prefix, steered_cabac_stream,
                                with_pps, write_slice_header_b)

DATA = Path(__file__).resolve().parent / "data"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The decodes' CPU recon and deblock run small tensors, which one
    thread runs faster than many."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _truncated(bs, pic, keep):
    """`bs` with the slice NAL of picture `pic` cut to the share `keep`
    of its RBSP."""
    out, k = [], -1
    for n in split_annexb(bs):
        rbsp = n.rbsp
        if n.nal_unit_type in (NAL_IDR, NAL_SLICE):
            k += 1
            if k == pic:
                rbsp = rbsp[:int(len(rbsp) * keep)]
        out.append(make_annexb_nal(n.nal_ref_idc, n.nal_unit_type, rbsp))
    return b"".join(out)


def _runaway_picture(kind, at=5):
    """An IDR from the port's CABAC encoder, then a hand-built CABAC P
    picture of P16x16 MBs (as tcabac._p_picture_without_residual) whose
    MB `at` carries a runaway code, where the parse fails with
    ValueError: an mvd of 2**18 (its exp-Golomb suffix passes order 16)
    or an mb_qp_delta of 60 (its unary code passes 104 bins)."""
    mb_w, mb_h, qp = 6, 4, 30
    enc = H264Encoder(EncoderConfig(width=16 * mb_w, height=16 * mb_h, qp=qp,
                                    entropy_cabac=True), device="cpu")
    bs = enc.encode_frame(*_frames(1, 16 * mb_w, 16 * mb_h, seed=4)[0])
    w = BitWriter()
    write_slice_header(w, enc.cfg, 0, 1, 0, qp, False, 0, disable_deblock=0)
    w.byte_align(1)                      # cabac_alignment_one_bit
    sw = CabacSliceWriter(mb_w, mb_h, qp, is_i=False)
    for idx in range(at + 1):
        gx, gy = 4 * (idx % mb_w), 4 * (idx // mb_w)
        sw.skip_flag(idx, 0)
        sw.mb_type_p16x16()
        mvd = (1 << 18 if (kind, idx) == ("mvd", at) else 12 - 24 * (idx % 2),
               4 * idx)
        for comp in (0, 1):
            sw.mvd_comp(idx, comp, gx, gy, mvd[comp])
        sw.mvd[gy:gy + 4, gx:gx + 4] = mvd
        if (kind, idx) == ("dqp", at):
            sw.write_cbp(idx, 1)
            sw.delta_qp(60)
        else:
            sw.write_cbp(idx, 0)
            sw.last_dqp = 0
        sw.mb_coded[idx] = True
        sw.end_of_slice(idx == at)
    sw.eng.write_to(w)
    return bs + make_annexb_nal(2, NAL_SLICE, w.get_bytes())


def _multiref_random_p(seed, n_pics=3):
    """The port encoder's IDR and P at 176x144 under a High SPS that keeps
    3 references (test_torch_streams.cabac_prefix), a PPS 2 of the
    encoder's with 3 active L0 references, then reference P pictures
    under it of seeded random slice data: ref_idx 1 and 2 name pictures
    of the DPB, so the ref_idx contexts meet references above 0."""
    prefix, sps, _pps1, n_ref = cabac_prefix(_cabac_ip(), 0, False, seed)
    pps0 = parse_pps(next(n.rbsp for n in split_annexb(prefix)
                          if n.nal_unit_type == NAL_PPS), {sps.sps_id: sps})
    pps_rbsp = _write_pps(pps0, pps_id=2, num_ref_idx_l0_active=3)
    pps2 = parse_pps(pps_rbsp, {sps.sps_id: sps})
    out = [prefix, make_annexb_nal(3, NAL_PPS, pps_rbsp)]
    rng = np.random.default_rng(seed)
    for k in range(n_ref, n_ref + n_pics):
        w = BitWriter()
        write_slice_header_b(w, sps, pps2, k, 8 * k, slice_type=5,
                             nal_ref_idc=2)
        w.byte_align(1)
        w.put_bytes(rng.integers(0, 256, 1500, dtype=np.uint8).tobytes())
        w.rbsp_trailing_bits()
        out.append(make_annexb_nal(2, NAL_SLICE, w.get_bytes()))
    return b"".join(out)


def _x264_prefix(name, n_au):
    """The first `n_au` access units of the x264 High stream `name` of
    tests/data: IDR, P and B pictures under x264's 8x8 PPS."""
    aus, cur = [], []
    for n in split_annexb((DATA / f"{name}.264").read_bytes()):
        if n.nal_unit_type in (NAL_IDR, NAL_SLICE) and cur and any(
                m.nal_unit_type in (NAL_IDR, NAL_SLICE) for m in cur):
            aus.append(cur)
            cur = []
        cur.append(n)
    aus.append(cur)
    return b"".join(make_annexb_nal(n.nal_ref_idc, n.nal_unit_type, n.rbsp)
                    for au in aus[:n_au] for n in au)


def _random_8x8(seed, stype, spatial=None):
    """The port encoder's IDR and P under a High SPS (cabac_prefix, PPS 1
    with transform_8x8_mode and two references a list), then one
    non-reference picture of slice type `stype` (6 B, 7 I, 5 P; B with
    spatial or temporal direct) whose slice data are seeded random
    bytes."""
    prefix, sps, pps1, n_pics = cabac_prefix(_cabac_ip(), 2 * (seed % 2),
                                             False, seed)
    rng = np.random.default_rng(seed)
    w = BitWriter()
    write_slice_header_b(w, sps, pps1, n_pics, 8 * n_pics - 4,
                         slice_type=stype, spatial=spatial,
                         mod_l1=0 if spatial else None)
    w.byte_align(1)
    w.put_bytes(rng.integers(0, 256, 1200, dtype=np.uint8).tobytes())
    w.rbsp_trailing_bits()
    return prefix + make_annexb_nal(0, NAL_SLICE, w.get_bytes())


class _RunawayMvd(BinChooser):
    """A BinChooser whose B pictures, from MB `AT` on, code each mvd's
    prefix bins 1 and its exp-Golomb suffix past order 16: the first
    mvd of such an MB raises ValueError in any parser."""
    AT = 30

    def _mb(self):
        f = sys._getframe(2)
        while f is not None and f.f_code.co_name != "decode_slice_mbs_cabac":
            f = f.f_back
        if f is None or f.f_locals["sh"].slice_type != 1:
            return -1
        return f.f_locals["mb_idx"]

    def choose(self, idx):
        if CTX_MVD <= idx < CTX_MVD + 14 and self._mb() >= self.AT:
            return 1
        return super().choose(idx)

    def choose_bypass(self):
        if sys._getframe(2).f_code.co_name == "exp_bypass" and \
                sys._getframe(3).f_code.co_name == "ueg_mv" and \
                self._mb() >= self.AT:
            return 1
        return super().choose_bypass()

    def encode(self, sh):
        """The bins, then more of the runaway's bypass 1s and a final
        end_of_slice_flag, so that the arithmetic code's flush cannot
        cut the runaway short."""
        self.bins += [(1, 0, 1)] * 16 + [(2, 0, 1)]
        return super().encode(sh)


# name -> the stream
PARITY = {
    **{name: (lambda name=name: tcabac._stream(name)[0])
       for name in tcabac.STREAMS},
    "scaling_lists": lambda: with_pps(tcabac._stream("intra_in_p")[0],
                                      scaling=True),
    "hand_built_ipcm": lambda: tcabac._hand_built_ipcm_slice()[0],
    "chroma_offset_no_residual":
        lambda: tcabac._p_picture_without_residual(6),
    "random_p_0": lambda: tcabac._random_p_slices(0),
    "random_p_1": lambda: tcabac._random_p_slices(1),
    "random_p_17": lambda: tcabac._random_p_slices(17),
    "random_multiref_p_0": lambda: _multiref_random_p(0),
    "random_multiref_p_3": lambda: _multiref_random_p(3),
    "truncated_p": lambda: _truncated(tcabac._stream("idr_interval")[0],
                                      1, 0.5),
    "truncated_ipcm": lambda: _truncated(
        tcabac._hand_built_ipcm_slice()[0], 0, 0.6),
    "runaway_mvd": lambda: _runaway_picture("mvd"),
    "runaway_dqp": lambda: _runaway_picture("dqp"),
    # B and the 8x8 transform
    "x264_high": lambda: _x264_prefix("x264_high_320x192", 3),
    "x264_high_pyramid": lambda: _x264_prefix("x264_high_320x192_pyramid",
                                              4),
    "steered_b_scaling": lambda: steered_cabac_stream(
        _cabac_ip(), idc=2, scaling=True, seed=2),
    "steered_b_rows": lambda: steered_cabac_stream(
        _cabac_ip(), idc=2, seed=4, rows_per_slice=1),
    "steered_b_no_direct_8x8": lambda: steered_cabac_stream(
        _cabac_ip(), idc=0, seed=6, direct_8x8=False,
        pictures=(("P", 2, 8, None), ("B", 0, -4, True),
                  ("B", 0, -12, False))),
    "random_b_spatial_0": lambda: _random_8x8(0, 6, True),
    "random_b_temporal_1": lambda: _random_8x8(1, 6, False),
    "random_i8x8_3": lambda: _random_8x8(3, 7),
    "random_p8x8_4": lambda: _random_8x8(4, 5),
    "truncated_b": lambda: _truncated(_x264_prefix("x264_high_320x192", 3),
                                      2, 0.5),
    "runaway_mvd_b": lambda: steered_cabac_stream(
        _cabac_ip(), idc=0, seed=8, pictures=(("B", 0, -4, True),),
        chooser=_RunawayMvd),
}
# the cases decoded under openh264_compat, where apply_direct records
# ibs_mode
COMPAT = {"x264_high_pyramid", "steered_b_scaling", "runaway_mvd_b"}
# the cases whose parsed MBs include B MBs, and those whose include
# 8x8-transform MBs
B_REACH = {"x264_high", "x264_high_pyramid", "steered_b_scaling",
           "steered_b_rows", "steered_b_no_direct_8x8", "random_b_spatial_0",
           "truncated_b", "runaway_mvd_b"}
T8_REACH = B_REACH | {"random_i8x8_3", "random_p8x8_4"}
# the exception each failing case's parse meets, and the MBs of its
# slice parsed before it: random bytes from an engine offset of 510 or
# 511, which no valid stream starts with, grow the offset past int64
# before a residual block; the IPCM samples of MB 8 are cut off
FAILS = {"random_p_1": (OverflowError, 0), "random_p_17": (OverflowError, 0),
         "truncated_ipcm": (ValueError, 8), "runaway_mvd": (ValueError, 5),
         "runaway_dqp": (ValueError, 5),
         "random_b_temporal_1": (OverflowError, 0),
         "runaway_mvd_b": (ValueError, 31)}


def _snapshot(fs):
    """Copies of every FrameSymbols field after a slice."""
    out = {}
    for k, v in vars(fs).items():
        if isinstance(v, np.ndarray):
            out[k] = v.copy()
        elif k == "ipcm":
            out[k] = {i: tuple(p.copy() for p in s) for i, s in v.items()}
        elif k != "wp_by_slice":
            out[k] = v
    return out


def _parse_log(bs, monkeypatch, parse, compat=False):
    """The frames of a decode (H264Decoder's openh264_compat `compat`) in
    which `parse` takes every slice routed to the C, and per such slice
    (the exception's class or None, the result, the FrameSymbols after
    it)."""
    log = []

    def record(rbsp, bitpos, ctx):
        err = res = None
        try:
            res = parse(rbsp, bitpos, ctx)
            return res
        except (EOFError, ValueError, IndexError, OverflowError,
                AttributeError) as e:
            err = type(e)
            raise
        finally:
            log.append((err, res, 8 * len(rbsp), _snapshot(ctx.fs)))
    with monkeypatch.context() as m:
        m.setattr(cbind, "parse_cabac_slice_native", record)
        frames = H264Decoder(device="cpu", ec_mode=2,
                             openh264_compat=compat).decode_annexb(bs)
    return frames, log


def _same_snapshot(got, want, where):
    assert sorted(got) == sorted(want), where
    for k in want:
        if k == "ipcm":
            assert sorted(got[k]) == sorted(want[k]), where
            for i in want[k]:
                for a, b in zip(got[k][i], want[k][i]):
                    np.testing.assert_array_equal(a, b, err_msg=where)
        elif isinstance(want[k], np.ndarray):
            np.testing.assert_array_equal(got[k], want[k],
                                          err_msg=f"{where}: {k}")
        else:
            assert got[k] == want[k], f"{where}: {k}"


@pytest.mark.parametrize("name", list(PARITY))
def test_c_parser_equals_python_twin(name, monkeypatch):
    bs, compat = PARITY[name](), name in COMPAT
    got, c_log = _parse_log(bs, monkeypatch, cbind.parse_cabac_slice_native,
                            compat)
    want, py_log = _parse_log(bs, monkeypatch, sdc.decode_slice_mbs_cabac,
                              compat)
    assert len(c_log) == len(py_log) > 0
    for k, ((c_err, c_res, _n, c_fs), (p_err, p_res, _m, p_fs)) in \
            enumerate(zip(c_log, py_log)):
        assert (c_err, c_res) == (p_err, p_res), f"slice {k}"
        _same_snapshot(c_fs, p_fs, f"slice {k}")
    _equal(got, want)
    # each case reaches what its name says
    failed = [(e, f) for e, _r, _n, f in c_log if e]
    if name in FAILS:
        exc, n_ok = FAILS[name]
        assert [e for e, _f in failed] == [exc]
        assert int(failed[0][1]["mb_correct"].sum()) == n_ok
    else:
        assert not failed
    if name in ("truncated_p", "truncated_b"):  # read past its end
        k = 1 if name == "truncated_p" else 2
        assert c_log[k][1][1] > c_log[k][2]
    parsed = [(f["mb_type"][f["mb_correct"]], f["transform8"][f["mb_correct"]])
              for _e, _r, _n, f in c_log]
    if name in B_REACH:
        assert any((t >= MB_B16x16).any() for t, _t8 in parsed)
    if name in T8_REACH:
        assert any(t8.any() for _t, t8 in parsed)
    if name in COMPAT:
        assert any(f["ibs_mode"].any() for _e, _r, _n, f in c_log)
    if name.endswith("ipcm"):
        ipcm = c_log[0][3]["ipcm"]
        assert len(ipcm) == (2 if name == "truncated_ipcm" else
                             tcabac._KINDS.count("P"))
    if name == "chroma_offset_no_residual":
        assert "chroma_qp_offsets" not in c_log[-1][3]


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------
@pytest.fixture
def recorder_off():
    trace.disable()
    trace.drain()
    yield
    trace.disable()
    trace.drain()


def _parse_counters(bs):
    """Each decoder.parse span's counters of a decode with the recorder
    on, in order."""
    trace.enable()
    try:
        H264Decoder(device="cpu", ec_mode=2).decode_annexb(bs)
    finally:
        trace.disable()
    spans, counters = trace.drain()
    return [(s.attrs.get("mbs"), counters.get(s.id, {}))
            for s in spans if s.name == "decoder.parse"]


def _b_and_8x8():
    """Two pictures under the port encoder's PPS, then a P and a B
    picture under a transform_8x8_mode PPS."""
    return steered_cabac_stream(
        _cabac_ip(), pictures=(("P", 2, 8, None), ("B", 0, -4, True)))


# name -> (the stream, how many of its slices go first to the C (None:
# all), the rest to the Python parser)
ROUTES = {
    # I/P slices of the port's encoder, one and four per picture
    "ip": (lambda: tcabac._stream("idr_interval")[0], None),
    "ip_slices4": (lambda: tcabac._stream("slices4")[0], None),
    "b_and_8x8": (_b_and_8x8, None),
    # x264's I, P and B slices (a reference B among them) under its 8x8
    # PPS
    "x264_pyramid": (lambda: _x264_prefix("x264_high_320x192_pyramid", 4),
                     None),
    # the encoder's slices under a PPS of two slice groups
    "fmo": (lambda: with_pps(tcabac._stream("idr_interval")[0], groups=2),
            0),
}


@pytest.mark.parametrize("name", list(ROUTES))
def test_routing_and_counters(name, recorder_off):
    make, n_c = ROUTES[name]
    bs = make()
    spans = _parse_counters(bs)
    assert spans
    n_c = len(spans) if n_c is None else n_c
    # the one routing rule says the same of every slice
    assert [c_parses(sh) for sh in _headers(bs)] == \
        [k < n_c for k in range(len(spans))]
    for k, (mbs, c) in enumerate(spans):
        if k < n_c:
            assert set(c) == {"cabac_c_mbs", "cabac_bins"}, (k, c)
            assert c["cabac_c_mbs"] == mbs > 0 and c["cabac_bins"] > mbs
        else:
            assert set(c) == {"cabac_python_mbs"}, (k, c)
            assert c["cabac_python_mbs"] > 0
    assert _parse_counters(bs) == spans          # the counts repeat
    H264Decoder(device="cpu", ec_mode=2).decode_annexb(bs)
    assert trace.drain() == ([], {})             # off: nothing recorded


class _Counting(CabacEngine):
    """CabacEngine that counts its bins (on the class, across the
    engines an IPCM MB starts)."""
    bins = 0

    def decision(self, ctx, idx):
        _Counting.bins += 1
        return super().decision(ctx, idx)

    def bypass(self):
        _Counting.bins += 1
        return super().bypass()

    def terminate(self):
        _Counting.bins += 1
        return super().terminate()


# name -> the stream
BINS = {"ip": lambda: (tcabac._stream("slices2")[0] +
                       tcabac._hand_built_ipcm_slice()[0]),
        "b_and_8x8": _b_and_8x8}


@pytest.mark.parametrize("name", list(BINS))
def test_cabac_bins_equal_python_twin_bins(name, recorder_off, monkeypatch):
    """cabac_bins per slice equals the bins the Python twin decodes on
    the same slice, its residual bins in Python too: I/P slices, and P
    and B slices under the 8x8 PPS."""
    bs = BINS[name]()
    c_bins = [c["cabac_bins"] for _m, c in _parse_counters(bs)]
    py_bins = []

    def counted(rbsp, bitpos, ctx):
        _Counting.bins = 0
        try:
            return sdc.decode_slice_mbs_cabac(rbsp, bitpos, ctx)
        finally:
            py_bins.append(_Counting.bins)
    with monkeypatch.context() as m:
        m.setattr(sdc, "CabacEngine", _Counting)
        m.setattr(sdc.CabacSliceDecoder, "residual_levels",
                  lambda self, prop: sdc.residual_levels_plain(
                      self.eng, self.bctx, prop))
        m.setattr(cbind, "parse_cabac_slice_native", counted)
        H264Decoder(device="cpu").decode_annexb(bs)
    assert c_bins == py_bins and min(c_bins) > 0
