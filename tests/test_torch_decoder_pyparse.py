"""Port parity: the decoder's per-MB Python CAVLC parser, FMO and 4x4
scaling lists.

- The Python parser, called in place of the host C parser, writes the C
  parser's FrameSymbols on every stream of test_torch_decoder.STREAMS,
  and the frames stay equal.
- The FMO slice-group maps (types 0-6) and the next-MB table equal the
  JAX package's.
- An FMO stream built from the port's code alone (two slice groups of
  alternating MB rows, map type 0: an IDR whose rows are the encoder's
  one-row bands, then a P picture of skipped MBs), which only the Python
  parser takes, decodes to the JAX decoder's frames on both of its recon
  paths, and with deblocking off to the per-row band reconstructions.
- Streams whose PPS is rewritten to carry 4x4 scaling lists (default and
  sent lists) decode to the JAX decoder's frames through the C parser,
  the Python parser (FMO) and CABAC.
All comparisons are exact (tolerance 0).
"""

import functools

import numpy as np
import pytest
import torch

import openh264_tpu_torch.decoder.cbind as cbind
from openh264_tpu.decoder import H264Decoder as JaxDecoder
from openh264_tpu.decoder import fmo as jfmo
from openh264_tpu_torch.bitstream import (BitWriter, NAL_IDR, NAL_PPS,
                                          NAL_SLICE, NAL_SPS, make_annexb_nal)
from openh264_tpu_torch.decoder import H264Decoder
from openh264_tpu_torch.decoder import fmo as tfmo
from openh264_tpu_torch.decoder.slice_dec import decode_slice_mbs_cavlc
from openh264_tpu_torch.encoder import core_torch
from openh264_tpu_torch.encoder.config import EncoderConfig
from openh264_tpu_torch.encoder.encoder import H264Encoder, _NcTracker
from openh264_tpu_torch.encoder.headers import write_slice_header, write_sps
from openh264_tpu_torch.tables import CHROMA_QP_TABLE

import test_torch_decoder_cabac as tcabac
from test_torch_decoder import _equal
from test_torch_streams import (STREAMS, _headers, _stream, scaling_lists,
                                with_pps)
from test_torch_decoder_cabac import (FS_FIELDS, jax_symbols, port_symbols,
                                      same_symbols)


@pytest.mark.parametrize("name", list(STREAMS))
def test_python_parser_equals_c(name, monkeypatch):
    bs = _stream(name)
    want, c_syms = port_symbols(bs, monkeypatch)
    with monkeypatch.context() as m:
        m.setattr(cbind, "parse_cavlc_slice_native", decode_slice_mbs_cavlc)
        got, py_syms = port_symbols(bs, monkeypatch)
    same_symbols(py_syms, c_syms, FS_FIELDS)
    _equal(got, want)


# ---------------------------------------------------------------------------
# FMO maps
# ---------------------------------------------------------------------------
class _PPS:
    def __init__(self, num, t, m):
        self.num_slice_groups = num
        self.slice_group_map_type = t
        self.slice_group_map = m


class _SPS:
    def __init__(self, w, h):
        self.mb_width, self.mb_height = w, h


MAPS = [
    (2, 0, {"run_length": [3, 3]}, (3, 4), 0),
    (3, 0, {"run_length": [1, 4, 2]}, (5, 3), 0),
    (2, 1, {}, (4, 2), 0),
    (4, 1, {}, (5, 4), 0),
    (3, 2, {"top_left": [5, 0], "bottom_right": [10, 6]}, (4, 4), 0),
    (2, 3, {"change_rate": 4, "change_direction": 0}, (4, 4), 2),
    (2, 3, {"change_rate": 3, "change_direction": 1}, (5, 4), 3),
    (2, 4, {"change_rate": 3, "change_direction": 0}, (4, 2), 2),
    (2, 4, {"change_rate": 5, "change_direction": 1}, (6, 3), 1),
    (2, 5, {"change_rate": 2, "change_direction": 0}, (4, 3), 3),
    (2, 5, {"change_rate": 2, "change_direction": 1}, (4, 3), 4),
    (3, 6, {"explicit": [0, 2, 1, 1, 0, 2, 2, 1]}, (4, 2), 0),
]


@pytest.mark.parametrize("num,t,m,wh,cycle", MAPS)
def test_fmo_maps_equal_jax(num, t, m, wh, cycle):
    pps, sps = _PPS(num, t, m), _SPS(*wh)
    want = jfmo.build_mb_to_slice_group(pps, sps, cycle)
    got = tfmo.build_mb_to_slice_group(pps, sps, cycle)
    np.testing.assert_array_equal(got, want)
    assert set(got.tolist()) != {0} or t in (3, 4, 5)
    np.testing.assert_array_equal(tfmo.next_mb_lut(got),
                                  jfmo.next_mb_lut(want))


# ---------------------------------------------------------------------------
# An FMO stream from the port's code
# ---------------------------------------------------------------------------
def _fmo_pps(cfg, lists=None):
    """PPS 0: CAVLC, two slice groups of alternating MB rows (map type 0,
    one row a run); with `lists` (six 4x4 lists in zigzag order), a
    pic_scaling_matrix that sends them."""
    w = BitWriter()
    w.ue(0)                     # pps_id
    w.ue(0)                     # sps_id
    w.flag(False)               # entropy_coding_mode (CAVLC)
    w.flag(False)               # pic_order_present
    w.ue(1)                     # num_slice_groups_minus1
    w.ue(0)                     # slice_group_map_type 0
    w.ue(cfg.mb_width - 1)      # run_length_minus1 group 0
    w.ue(cfg.mb_width - 1)      # run_length_minus1 group 1
    w.ue(0)                     # num_ref_idx_l0_active_minus1
    w.ue(0)
    w.flag(False)               # weighted_pred
    w.u(2, 0)
    w.se(cfg.pic_init_qp - 26)
    w.se(0)
    w.se(0)                     # chroma_qp_index_offset
    w.flag(True)                # deblocking_filter_control_present
    w.flag(False)
    w.flag(False)
    if lists is not None:
        w.flag(False)           # transform_8x8_mode
        w.flag(True)            # pic_scaling_matrix_present
        for lst in lists:
            w.flag(True)        # the list is sent, as delta_scale codes
            last = 8
            for v in lst:
                w.se((v - last + 128) % 256 - 128)
                last = v
        w.se(0)                 # second_chroma_qp_index_offset
    w.rbsp_trailing_bits()
    return w.get_bytes()


@functools.lru_cache(maxsize=None)
def _fmo_stream(w_, h_, idc, seed=0, lists=None):
    """Two slice groups (alternating MB rows): an IDR whose rows are the
    port's one-row I16 bands (a band has no top neighbour, which is the
    availability of interleaved groups), then a P picture whose two group
    slices are all mb_skip_run. Returns the stream and the per-row band
    reconstruction."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 256, (h_, w_), np.uint8)
    u = rng.integers(0, 256, (h_ // 2, w_ // 2), np.uint8)
    v = rng.integers(0, 256, (h_ // 2, w_ // 2), np.uint8)
    qp = 28
    cfg = EncoderConfig(width=w_, height=h_, qp=qp)
    enc = H264Encoder(cfg, device="cpu")
    mb_w, mb_h = cfg.mb_width, cfg.mb_height
    bs = (make_annexb_nal(3, NAL_SPS, write_sps(cfg)) +
          make_annexb_nal(3, NAL_PPS, _fmo_pps(cfg, lists)))
    rows = []
    for r in range(mb_h):
        out = core_torch.encode_i_frame(
            *(torch.from_numpy(p[r * s:(r + 1) * s].copy())
              for p, s in ((y, 16), (u, 8), (v, 8))),
            qp, int(CHROMA_QP_TABLE[qp]), mb_w=mb_w, mb_h=1)
        rows.append({k: a.numpy() for k, a in out.items()})
    for grp in (0, 1):
        w = BitWriter()
        write_slice_header(w, cfg, 2, 0, grp * mb_w, qp, True, 0,
                           disable_deblock=idc)
        for r in range(grp, mb_h, 2):
            nc = _NcTracker(mb_w, 1)
            for i in range(mb_w):
                enc._write_i16_mb(w, rows[r], i, nc, p_slice=False)
        w.rbsp_trailing_bits()
        bs += make_annexb_nal(3, NAL_IDR, w.get_bytes())
    n_group = (mb_h + 1) // 2 * mb_w, mb_h // 2 * mb_w
    for grp in (0, 1):
        w = BitWriter()
        write_slice_header(w, cfg, 0, 1, grp * mb_w, qp, False, 0,
                           disable_deblock=idc)
        w.ue(n_group[grp])      # mb_skip_run over the whole group
        w.rbsp_trailing_bits()
        bs += make_annexb_nal(2, NAL_SLICE, w.get_bytes())
    recon = tuple(np.concatenate([r[k] for r in rows], 0)
                  for k in ("recon_y", "recon_u", "recon_v"))
    return bs, recon


def test_c_parser_never_takes_fmo(monkeypatch):
    """The host C parser's glue refuses an FMO slice with
    NotImplementedError, which the decoder does not conceal: were the
    routing to send FMO slices there, decoding would stop in every
    error-concealment mode instead of hiding them."""
    import openh264_tpu_torch.decoder.decoder as decoder
    bs, _ = _fmo_stream(96, 64, 1)
    monkeypatch.setattr(decoder, "decode_slice_mbs_cavlc",
                        cbind.parse_cavlc_slice_native)
    for ec in (0, 2, 6):
        with pytest.raises(NotImplementedError):
            H264Decoder(device="cpu", ec_mode=ec).decode_annexb(bs)


@pytest.mark.parametrize("idc", [1, 0, 2])
def test_fmo_stream_matches_jax(idc, monkeypatch):
    """Deblocking off (idc 1): the IDR is the band reconstruction; on
    (idc 0) the row edges between groups are filtered, with idc 2 they
    are not (each group is its own slice)."""
    bs, recon = _fmo_stream(96, 64, idc)
    got, syms = port_symbols(bs, monkeypatch)
    want, jsyms = jax_symbols(bs, monkeypatch)
    assert len(got) == 2
    _equal(got, want)
    _equal(got, JaxDecoder(use_jax_recon=True).decode_annexb(bs))
    same_symbols(syms, jsyms, FS_FIELDS)
    assert syms[0].slice_id.reshape(4, 6)[:, 0].tolist() == [0, 1, 0, 1]
    if idc == 1:
        for c, r in zip("yuv", recon):
            np.testing.assert_array_equal(getattr(got[0], c), r)
    # the skipped P picture copies the IDR
    for c in "yuv":
        np.testing.assert_array_equal(getattr(got[1], c),
                                      getattr(got[0], c))


# ---------------------------------------------------------------------------
# 4x4 scaling lists
# ---------------------------------------------------------------------------
def _scaling_stream(kind):
    if kind == "fmo_sent":
        return _fmo_stream(96, 64, 0, seed=1, lists=scaling_lists(7))[0]
    if kind == "cabac_default":
        return with_pps(tcabac._stream("intra_in_p")[0], scaling=True)
    name = {"constqp_default": "constqp", "idc2_sent": "idc2_slices3",
            "offset_sent": "chroma_offset"}[kind]
    lists = None if kind.endswith("default") else scaling_lists(len(kind))
    return with_pps(_stream(name), scaling=True, scaling_lists=lists)


@pytest.mark.parametrize("kind", ["constqp_default", "idc2_sent",
                                  "offset_sent", "fmo_sent", "cabac_default"])
def test_scaling_lists_match_jax(kind, monkeypatch):
    """The C parser (constqp, idc 2 with 3 slices, a chroma QP offset),
    the Python parser (FMO) and CABAC dequantise with the lists as the
    JAX decoder does."""
    bs = _scaling_stream(kind)
    got, syms = port_symbols(bs, monkeypatch)
    want, jsyms = jax_symbols(bs, monkeypatch)
    _equal(got, want)
    _equal(got, JaxDecoder(use_jax_recon=True).decode_annexb(bs))
    same_symbols(syms, jsyms, FS_FIELDS)
    assert all(h.pps.pic_scaling_matrix_present for h in _headers(bs))
    # the lists change the pictures: the flat decode differs
    flat = (_fmo_stream(96, 64, 0, seed=1)[0] if kind == "fmo_sent"
            else with_pps(bs, scaling=False))
    flat = H264Decoder(device="cpu").decode_annexb(flat)
    assert any(not np.array_equal(a.y, b.y) for a, b in zip(got, flat))
