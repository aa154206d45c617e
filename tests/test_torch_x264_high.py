"""The port's decoder on the High-profile streams that x264 writes (B
pictures with B-pyramid, the 8x8 transform, weighted prediction, several
references), on the CPU, against the benchmark's plain reference
(benchmark/reference/decoder_b.py) and against the MD5 of each picture
that libavcodec's decoder gave when the streams were made
(benchmark/make_x264_streams.py): every picture equal, sample for
sample.

The streams (tests/data): 320x192, 24 pictures, GOPs of 12, 600 kbit/s,
x264 preset medium; on this content x264 puts one B picture between P
pictures, so a second stream asks for three always (b-adapt=0), which
gives reference B pictures. Where the port's default departs from
openh264_compat (the OpenH264 decoder's B 16x8 / 8x16 BI partitions and
its deblocking of skipped and direct MBs), clause 8 is what the
reference and libavcodec agree on. Besides: the POC output order of
feed_annexb from a stream's first picture, the picture and slice spans'
counters and attributes, the control, and the committed 1920x1080
stream of the hls_1080p30_high cell, by its headers.
"""

import functools
import hashlib
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import openh264_tpu_torch.decoder.decoder as decoder_mod  # noqa: E402
from benchmark import streams  # noqa: E402
from benchmark.reference.bits import BitReader  # noqa: E402
from benchmark.reference.decoder_b import ChainDecoder  # noqa: E402
from benchmark.reference.nal import split_annexb  # noqa: E402
from benchmark.reference.params import parse_pps, parse_sps  # noqa: E402
from benchmark.reference.slicehdr import parse_slice_header  # noqa: E402
from openh264_tpu_torch.decoder import H264Decoder  # noqa: E402
from openh264_tpu_torch.decoder.framedata import (  # noqa: E402
    MB_B16x8, MB_B8x16, MB_BDIRECT, MB_BSKIP)
from openh264_tpu_torch.utils import trace  # noqa: E402

DATA = ROOT / "tests" / "data"
STREAMS = ("x264_high_320x192", "x264_high_320x192_pyramid")
B_SLICE = 1


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's CPU recon and deblock run small tensors: one thread
    decodes these streams about three times as fast as eight."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _stream(name):
    """(bytes, manifest) of a test stream; its SHA-256 checked."""
    data = (DATA / f"{name}.264").read_bytes()
    manifest = json.loads((DATA / f"{name}.json").read_text())
    assert hashlib.sha256(data).hexdigest() == manifest["sha256"]
    return data, manifest


def _headers(data):
    """(sps, pps, [(nal_ref_idc, slice header)]) of a stream."""
    sps_map, pps_map, out = {}, {}, []
    for nal in split_annexb(data):
        if nal.nal_unit_type == 7:
            sps = parse_sps(nal.rbsp)
            sps_map[sps.sps_id] = sps
        elif nal.nal_unit_type == 8:
            pps = parse_pps(nal.rbsp, sps_map)
            pps_map[pps.pps_id] = pps
        elif nal.nal_unit_type in (1, 5):
            out.append((nal.nal_ref_idc, parse_slice_header(
                BitReader(nal.rbsp), nal, sps_map, pps_map)))
    return sps, pps, out


@functools.lru_cache(maxsize=None)
def _port(name, compat=False):
    """The port's pictures of a stream fed one access unit per call, the
    pictures each call returned, and (with compat False) the spans and
    counters recorded, with each picture's FrameSymbols. With compat,
    the first GOP only."""
    data, _ = _stream(name)
    if compat:
        data = b"".join(streams.gops(streams.access_units(data))[0])
    seen = []
    orig = decoder_mod.recon_frame_batch

    def spy(fs, *a, **k):
        seen.append(fs)
        return orig(fs, *a, **k)
    decoder_mod.recon_frame_batch = spy
    dec = H264Decoder(device="cpu", openh264_compat=compat)
    if not compat:
        trace.enable()
    try:
        calls = [dec.feed_annexb(au) for au in streams.access_units(data)]
        calls.append(dec.flush())
    finally:
        trace.disable()
        decoder_mod.recon_frame_batch = orig
    spans, counters = trace.drain()
    return [f for c in calls for f in c], calls, spans, counters, seen


@functools.lru_cache(maxsize=None)
def _reference(name, deblock=True, gops=2):
    """(GOP, POC, planes) of the reference's pictures of the stream's
    first `gops` GOPs, in output order."""
    data, _ = _stream(name)
    out = []
    for g, gop in enumerate(streams.gops(streams.access_units(data))[:gops]):
        dec = ChainDecoder(deblock=deblock)
        out += sorted((g, *dec.decode_au(au)) for au in gop)
    return out


def _diff(a, b):
    return max(int(np.abs(x.astype(np.int16) - y.astype(np.int16)).max())
               for x, y in zip(a, b))


def _md5(planes):
    return hashlib.md5(b"".join(p.tobytes() for p in planes)).hexdigest()


@pytest.mark.parametrize("name", STREAMS)
def test_port_equals_the_reference_and_libavcodec(name):
    frames = _port(name)[0]
    ref = _reference(name)
    _, manifest = _stream(name)
    assert len(frames) == len(ref) == manifest["frames"] == 24
    assert [(f.cvs, f.poc) for f in frames] == [(g, p) for g, p, _ in ref]
    for f, (_, _, want), md5 in zip(frames, ref, manifest["libavcodec_md5"]):
        assert f.y.shape == (192, 320)
        assert _diff(f.planes(), want) == 0
        assert _md5(f.planes()) == _md5(want) == md5


@pytest.mark.parametrize("name", STREAMS)
def test_the_streams_work_the_mechanism(name):
    _, calls, spans, counters, _ = _port(name)
    data, _ = _stream(name)
    sps, pps, slices = _headers(data)
    assert sps.profile_idc == 100 and pps.transform_8x8_mode
    assert pps.weighted_pred and pps.weighted_bipred_idc == 2
    pics = [s for s in spans if s.name == "decoder.picture"]
    assert len(pics) == 24
    total = {}
    for p in pics:
        for k, v in counters.get(p.id, {}).items():
            total[k] = total.get(k, 0) + v
    assert all(total[k] > 0 for k in ("direct", "bipred", "t8x8",
                                      "weighted")), total
    b_pics = [p for p in pics if p.attrs["slice_type"] == B_SLICE]
    assert b_pics and all(p.attrs["refs_l1"] >= 1 for p in b_pics)
    assert max(p.attrs["refs_l0"] for p in pics) >= 2
    parses = [s for s in spans if s.name == "decoder.parse"]
    assert sorted({s.attrs["slice_type"] for s in parses}) == [0, 1, 2]
    # every slice is parsed whole by the host C (csrc/parse_cabac.c)
    assert all(counters[s.id]["cabac_c_mbs"] == 240 and
               "cabac_python_mbs" not in counters[s.id] for s in parses)
    assert {s.attrs["python"] for s in spans if s.name == "recon.intra"} \
        <= {False, True}
    if name.endswith("pyramid"):
        # B pictures that are references, with MMCO and reordered lists
        assert any(ref and sh.slice_type == B_SLICE for ref, sh in slices)
        assert any(sh.adaptive_ref_pic_marking for _, sh in slices)
        assert any(sh.ref_pic_list_modification[0] for _, sh in slices)


@pytest.mark.parametrize("name", STREAMS)
def test_feed_returns_poc_order_from_the_first_picture(name):
    """x264's SPS declares reordering (VUI max_num_reorder_frames): the
    P picture after the IDR leaves after the B picture before it, though
    no B slice has been seen when it is decoded."""
    frames, calls, *_ = _port(name)
    sps, _, _ = _headers(_stream(name)[0])
    assert sps.vui["max_num_reorder_frames"] >= 1
    keys = [(f.cvs, f.poc) for f in frames]
    assert keys == sorted(keys)
    assert not any(calls[:3])


def test_control_differs_from_the_program():
    frames = _port(STREAMS[1])[0]
    ctl = _reference(STREAMS[1], deblock=False, gops=1)
    assert max(_diff(f.planes(), c) for f, (_, _, c) in zip(frames, ctl)) > 0


def test_openh264_compat_keeps_the_reference_decoders_departures():
    """The fixes of the default path, each shown where it bites: with
    openh264_compat the port predicts B 16x8 / 8x16 BI partitions and
    deblocks skipped and direct MBs as the OpenH264 decoder does, and
    differs from clause 8 there; without it, ibs_mode stays 0."""
    name = STREAMS[1]
    frames, _, _, _, syms = _port(name)
    cframes, _, _, _, csyms = _port(name, compat=True)
    frames = frames[:len(cframes)]
    assert [(f.cvs, f.poc) for f in cframes] == \
        [(f.cvs, f.poc) for f in frames]
    assert all(not s.ibs_mode.any() for s in syms)
    b = [c for c in csyms if np.isin(c.mb_type, (MB_BSKIP, MB_BDIRECT)).any()]
    assert b and all(c.ibs_mode.any() for c in b)
    bi2 = [np.isin(c.mb_type, (MB_B16x8, MB_B8x16))
           & (c.pred_mode == 2).any(1) for c in csyms]
    assert any(m.any() for m in bi2)
    assert any(_diff(f.planes(), c.planes()) > 0
               for f, c in zip(frames, cframes))


def test_new_counters_cost_nothing_while_the_recorder_is_off(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("counted while the recorder is off")
    monkeypatch.setattr(decoder_mod, "_count_mb_classes", boom)
    monkeypatch.setattr(decoder_mod, "_weighted", boom)
    data, _ = _stream(STREAMS[0])
    aus = streams.access_units(data)[:4]
    assert len(H264Decoder(device="cpu").decode_annexb(b"".join(aus))) == 4
    assert trace.drain() == ([], {})


def test_hls_1080p30_high_stream():
    """The committed stream of the hls_1080p30_high cell, by its manifest
    and headers: High 4.0 at 1920x1080 after its crop, three or more
    references, the 8x8 transform, explicit P and implicit B weights,
    B pictures at least half of the pictures and some of them
    references, about 6000 kbit/s (x264's ABR over 6 s)."""
    g, manifest = streams.load("hls_1080p30_high")
    data = (streams.STREAM_DIR / "hls_1080p30_high.264").read_bytes()
    sps, pps, slices = _headers(data)
    assert (sps.profile_idc, sps.level_idc) == (100, 40)
    assert (sps.width, sps.height) == (1920, 1080)
    assert (sps.mb_width, sps.mb_height) == (120, 68)
    assert sps.max_num_ref_frames >= 3
    assert (pps.transform_8x8_mode, pps.weighted_pred,
            pps.weighted_bipred_idc) == (1, 1, 2)
    b = [ref for ref, sh in slices if sh.slice_type == B_SLICE]
    assert len(slices) == manifest["frames"] == 180 and len(g) == 3
    assert 2 * len(b) >= len(slices) and any(b)
    assert manifest["pictures"]["B"] == len(b)
    rate = 8 * len(data) * 30 / len(slices)
    assert abs(rate - 6_000_000) <= 0.2 * 6_000_000
    assert manifest["bitrate_bps"] == round(rate)
    assert len(manifest["libavcodec_md5"]) == 180
