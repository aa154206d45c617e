"""The port's span recorder (openh264_tpu_torch/utils/trace.py) and the
span tree of the decoder, the host encoder and its API, and the device
session, all on the CPU.

Off, the recorder hands out one shared no-op span, reads no clock,
enters no torch.profiler record_function and keeps nothing. On, spans
nest with parent ids, inherit the frame id, carry counters and drain as
plain tuples and dicts. The decoder's stage_seconds and the session's
last_stats are sums over their spans; under a CPU torch.profiler the
spans are the profile's user annotations, with the same nesting.
"""

import numpy as np
import pytest
import torch

from openh264_tpu_torch.api import SEncParamExt, WelsCreateSVCEncoder
from openh264_tpu_torch.bitstream import split_annexb
from openh264_tpu_torch.decoder import H264Decoder
from openh264_tpu_torch.decoder.decoder import STAGE_SPANS, STAGES
from openh264_tpu_torch.encoder.config import EncoderConfig
from openh264_tpu_torch.encoder.session_device import DeviceSessionEncoder
from openh264_tpu_torch.utils import trace

from test_torch_streams import _frames, _stream


@pytest.fixture(autouse=True)
def _recorder_off():
    trace.disable()
    trace.drain()
    yield
    trace.disable()
    trace.drain()


def _record(fn):
    """(fn's result, spans, counters) with the recorder on during fn."""
    trace.enable()
    try:
        out = fn()
    finally:
        trace.disable()
    return (out,) + trace.drain()


def _children(spans, parent):
    return [s for s in spans if s.parent == parent.id]


def _named(spans, name):
    return [s for s in spans if s.name == name]


class _NoClock:
    def perf_counter_ns(self):
        raise AssertionError("a span read the clock while off")


def test_off_is_one_shared_no_op(monkeypatch):
    monkeypatch.setattr(trace, "time", _NoClock())
    a = trace.span("x", frame=3)
    assert a is trace.NO_SPAN and trace.span("y") is a
    with a as sp:
        sp.set(bits=1)
        sp.count("n", 2)
        trace.count("n", 2)
    assert sp.seconds == 0.0
    assert not trace.enabled()
    assert trace.drain() == ([], {})


def test_off_decoder_and_api_read_no_clock_and_no_profiler(monkeypatch):
    """A whole decode and an API encode with the recorder off: no span
    reads the clock, none enters record_function, none is kept."""
    bs = _stream("intra_in_p")
    frames = _frames(2, 96, 64, seed=5)
    enc = WelsCreateSVCEncoder(device="cpu")
    assert enc.InitializeExt(SEncParamExt(iPicWidth=96, iPicHeight=64,
                                          iRCMode=0)) == 0
    import torch.autograd.profiler as tap

    def no_rf(name):
        raise AssertionError("record_function entered while off")
    monkeypatch.setattr(trace, "time", _NoClock())
    monkeypatch.setattr(tap, "record_function", no_rf)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert len(H264Decoder(device="cpu").decode_annexb(bs)) == 3
        for f in frames:
            assert enc.EncodeFrame(*f)
    assert trace.drain() == ([], {})


def test_clock_span_when_off_times_without_recording():
    with trace.span("x", clock=True) as sp:
        sum(range(1000))
    assert sp is not trace.NO_SPAN and sp.seconds > 0
    assert trace.drain() == ([], {})


def test_nesting_parents_frames_counters_and_drain():
    def work():
        trace.count("outside", 1)
        with trace.span("a", frame=7, idr=True) as a:
            with trace.span("b") as b:
                trace.count("mbs", 3)
                trace.count("mbs", 2)
                with trace.span("c", frame=9):
                    pass
            with trace.span("d") as d:
                d.set(bits=40)
            a.count("bits", 40)
        with trace.span("e"):
            pass
        return a, b
    (a, b), spans, counters = _record(work)
    assert [s.name for s in spans] == ["c", "b", "d", "a", "e"]
    assert all(isinstance(s, tuple) for s in spans)
    by = {s.name: s for s in spans}
    assert by["a"].parent == 0 and by["e"].parent == 0
    assert by["b"].parent == by["d"].parent == by["a"].id
    assert by["c"].parent == by["b"].id
    # the frame id is inherited unless a span sets its own
    assert [by[n].frame for n in "abcde"] == [7, 7, 9, 7, None]
    assert by["a"].attrs == {"idr": True} and by["d"].attrs == {"bits": 40}
    assert counters == {0: {"outside": 1}, by["b"].id: {"mbs": 5},
                        by["a"].id: {"bits": 40}}
    # children lie inside their parent, so self time is never negative
    for s in spans:
        kids = _children(spans, s)
        assert all(s.start_ns <= k.start_ns <= k.end_ns <= s.end_ns
                   for k in kids)
        assert s.end_ns - s.start_ns >= sum(k.end_ns - k.start_ns
                                            for k in kids)
    assert a.seconds == (by["a"].end_ns - by["a"].start_ns) * 1e-9
    assert trace.drain() == ([], {})


def test_spans_of_other_threads_keep_their_own_parents():
    import threading

    def worker():
        with trace.span("t.outer", frame=1):
            with trace.span("t.inner"):
                pass

    def work():
        with trace.span("main"):
            th = threading.Thread(target=worker)
            th.start()
            th.join()
    _, spans, _ = _record(work)
    by = {s.name: s for s in spans}
    assert by["t.outer"].parent == 0
    assert by["t.inner"].parent == by["t.outer"].id
    assert by["t.inner"].frame == 1


@pytest.mark.parametrize("name", ["intra_in_p", "slices4_2tid"])
def test_decoder_picture_spans(name):
    bs = _stream(name)
    dec = H264Decoder(device="cpu")
    frames, spans, counters = _record(lambda: dec.feed_annexb(bs)
                                      + dec.flush())
    pics = _named(spans, "decoder.picture")
    assert len(pics) == len(frames)
    assert [p.frame for p in pics] == list(range(len(frames)))
    assert [p.attrs["idr"] for p in pics] == [f.is_idr for f in frames]
    assert all(p.attrs["entropy"] == "cavlc" for p in pics)
    n_mb = frames[0].y.size // 256
    n_slices = np.bincount(np.cumsum(
        [n.nal_unit_type in (1, 5) and n.rbsp[0] & 0x80 != 0
         for n in split_annexb(bs)]))[1:]
    for p, ns in zip(pics, n_slices):
        kids = [k.name for k in _children(spans, p)]
        assert kids.count("decoder.parse") == ns
        for stage in ("decoder.prepare", "decoder.recon", "decoder.deblock",
                      "decoder.output"):
            assert kids.count(stage) == 1
        parses = [k for k in _children(spans, p)
                  if k.name == "decoder.parse"]
        assert sum(k.attrs["mbs"] for k in parses) == n_mb
        assert all(k.attrs["bytes"] > 0 for k in parses)
        deb = next(k for k in _children(spans, p)
                   if k.name == "decoder.deblock")
        assert [k.name for k in _children(spans, deb)] == ["deblock.bs",
                                                           "deblock.kernel"]
        assert all(k.frame == p.frame for k in _children(spans, p))
        # counters: every MB of the picture in one class, and the B /
        # 8x8 / weighted features (none in these streams)
        c = counters[p.id]
        classes = {"skip", "inter", "i4x4", "i8x8", "i16x16", "pcm"}
        assert sum(c[k] for k in classes) == n_mb
        assert set(c) == classes | {"direct", "bipred", "t8x8", "weighted"}
        assert c["direct"] == c["bipred"] == c["weighted"] == 0
    assert pics[0].attrs["idr"] and counters[pics[0].id]["inter"] == 0
    # the feed span holds the pictures its call finished, flush the rest
    (feed,) = _named(spans, "decoder.feed")
    assert any(p.parent == feed.id for p in pics)
    assert all(p.parent in (0, feed.id) for p in pics)
    recon = _named(spans, "decoder.recon")
    assert {k.name for r in recon for k in _children(spans, r)} <= {
        "recon.inter", "recon.intra"}
    assert _named(spans, "recon.intra") and _named(spans, "recon.inter")


def test_decoder_stage_seconds_are_span_sums():
    bs = _stream("constqp")
    dec = H264Decoder(device="cpu", stage_times=True)
    frames, spans, _ = _record(lambda: dec.decode_annexb(bs))
    assert len(frames) == 4
    assert set(STAGE_SPANS) == set(STAGES)
    for stage in STAGES:
        want = 1e-9 * sum(s.end_ns - s.start_ns for name in STAGE_SPANS[stage]
                          for s in _named(spans, name))
        assert dec.stage_seconds[stage] == pytest.approx(want, rel=1e-9,
                                                         abs=1e-12)
    assert dec.stage_seconds["parse"] > 0
    assert dec.stage_seconds["conceal"] == 0.0
    # and without the recorder, the same stages are timed
    dec2 = H264Decoder(device="cpu", stage_times=True)
    dec2.decode_annexb(bs)
    assert all(dec2.stage_seconds[s] > 0 for s in STAGES[:4])
    assert trace.drain() == ([], {})


def _api(w=96, h=64):
    enc = WelsCreateSVCEncoder(device="cpu")
    assert enc.InitializeExt(SEncParamExt(
        iPicWidth=w, iPicHeight=h, iTargetBitrate=400_000, iRCMode=1,
        fMaxFrameRate=30.0, uiIntraPeriod=16)) == 0
    return enc


def test_api_encoder_span_tree_and_bits():
    enc = _api()
    frames = _frames(4, 96, 64, seed=11)
    out, spans, counters = _record(
        lambda: [enc.EncodeFrame(*f) for f in frames])
    roots = [s for s in spans if s.parent == 0]
    assert [s.name for s in roots] == ["api.encode_frame"] * 4
    assert [s.frame for s in roots] == [0, 1, 2, 3]
    assert [s.attrs["idr"] for s in roots] == [True, False, False, False]
    n_mb = 96 * 64 // 256
    slice_bits = 0
    for r, bs in zip(roots, out):
        (fr,) = [k for k in _children(spans, r) if k.name == "encoder.frame"]
        assert fr.frame == r.frame and fr.attrs["idr"] == r.attrs["idr"]
        kids = [k.name for k in _children(spans, fr)]
        assert kids.count("encoder.write") == 1
        assert kids.count("encoder.deblock") == 1
        assert ("encoder.i4x4" in kids) == r.attrs["idr"]
        if not r.attrs["idr"]:
            assert "encoder.dispatch" in kids and "encoder.fetch" in kids
            c = counters[fr.id]
            assert c["skip"] + c["inter"] + c["intra_p"] == n_mb
        else:
            c = counters[fr.id]
            assert c["i4"] + c["i16"] == n_mb
        assert c["bits"] == 8 * len(bs)
        (w,) = [k for k in _children(spans, fr) if k.name == "encoder.write"]
        assert w.attrs["entropy"] == "cavlc"
        deb = next(k for k in _children(spans, fr)
                   if k.name == "encoder.deblock")
        assert [k.name for k in _children(spans, deb)] == ["deblock.bs",
                                                           "deblock.kernel"]
        slice_bits += 8 * sum(len(n.rbsp) for n in split_annexb(bs)
                              if n.nal_unit_type in (1, 5))
    # the writers' bits are the slices' RBSP: header and body
    assert sum(s.attrs["bits"] for s in _named(spans, "encoder.write")) \
        == slice_bits


def test_session_spans_and_last_stats():
    frames = _frames(10, 96, 64, seed=3)
    sess = DeviceSessionEncoder(EncoderConfig(width=96, height=64, qp=28),
                                fetch_batch=4, device="cpu")
    out, spans, _ = _record(lambda: sess.encode_stream(frames))
    st = sess.last_stats
    assert set(st) == {"launch_s", "fetch_s", "frames"}
    launches = _named(spans, "session.launch")
    assert len(launches) == st["frames"] == len(out) == 10
    assert [s.frame for s in launches] == list(range(10))
    assert [s.attrs["idr"] for s in launches] == [True] + [False] * 9

    def total(name):
        return sum(s.end_ns - s.start_ns for s in _named(spans, name)) * 1e-9
    assert st["launch_s"] == pytest.approx(total("session.launch"),
                                           rel=1e-9)
    assert st["fetch_s"] == pytest.approx(total("session.fetch"), rel=1e-9)
    fetches = _named(spans, "session.fetch")
    assert sum(s.attrs["frames"] for s in fetches) == 10
    assert len(_named(spans, "session.finalize")) == len(fetches)
    for ln in launches:
        kids = [k.name for k in _children(spans, ln)]
        assert kids == ["session.core", "session.entropy", "session.deblock"]
    assert len(_named(spans, "session.wait_input")) == 11
    # off: the same stream, and last_stats still timed
    sess2 = DeviceSessionEncoder(EncoderConfig(width=96, height=64, qp=28),
                                 fetch_batch=4, device="cpu")
    assert sess2.encode_stream(frames) == out
    assert sess2.last_stats["frames"] == 10
    assert sess2.last_stats["launch_s"] > 0
    assert trace.drain() == ([], {})


def test_spans_are_profiler_annotations_with_the_same_nesting():
    from torch.profiler import ProfilerActivity, profile
    enc = _api()
    frames = _frames(2, 96, 64, seed=4)
    enc.EncodeFrame(*frames[0])
    trace.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        enc.EncodeFrame(*frames[1])
    trace.disable()
    spans, _ = trace.drain()
    names = {s.name for s in spans}
    ann = [e for e in prof.events() if e.name in names]
    assert sorted(e.name for e in ann) == sorted(s.name for s in spans)
    assert all(getattr(e, "is_user_annotation", True) for e in ann)

    def ann_parent(e):
        p = e.cpu_parent
        while p is not None and p.name not in names:
            p = p.cpu_parent
        return None if p is None else p.name
    by_id = {s.id: s for s in spans}
    want = sorted((s.name, by_id[s.parent].name if s.parent else None)
                  for s in spans)
    assert sorted((e.name, ann_parent(e)) for e in ann) == want
