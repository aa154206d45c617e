"""The port's CUDA kernels: their contract on the CPU, and their
equality with the plain PyTorch versions on a GPU (with per-MB alpha /
beta offsets and separate Cb / Cr QPs too); the host encoder and the API
(CAVLC and CABAC), threaded simulcast, GOP parallelism, slice-parallel
bands across the GPU and the CPU, the processing functions and the
decoder (CAVLC and CABAC, deblock idc 2, offsets, scaling lists) on a
GPU against the same on the CPU, and the host C build on the GPU's
machine.

This file imports nothing of JAX, so the card's tests also run on a
machine without it:

    python -m pytest -m cuda --noconftest tests/test_torch_cuda.py
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from openh264_tpu_torch.encoder import deblock_cuda as dc
from openh264_tpu_torch.encoder import deblock_torch as dt
from openh264_tpu_torch.tables import ALPHA_TABLE, BETA_TABLE, TC0_TABLE

CSRC = Path(dc.__file__).resolve().parent.parent / "csrc"


def _inputs(mbw, mbh, seed, blocky=False):
    """Planes (uniform random, or flat MBs a few levels apart plus noise,
    whose edges the filter acts on), bS 0-4 and QP 18-41."""
    rng = np.random.default_rng(seed)

    def plane(size):
        if not blocky:
            return rng.integers(0, 256, (size * mbh, size * mbw), np.uint8)
        base = rng.integers(80, 120, (mbh, mbw)).repeat(size, 0).repeat(
            size, 1)
        return (base + rng.integers(-3, 4, base.shape)).astype(np.uint8)
    return [torch.from_numpy(a) for a in (
        plane(16), plane(8), plane(8),
        rng.integers(0, 5, (mbh * 4, mbw * 4), np.int32),
        rng.integers(0, 5, (mbh * 4, mbw * 4), np.int32),
        rng.integers(18, 42, mbw * mbh, np.int32),
        rng.integers(18, 42, mbw * mbh, np.int32))]


def test_cuda_source_tables_match():
    """The kernel's __constant__ tables equal the package's tables."""
    src = (CSRC / "deblock.cu").read_text()

    def table(name):
        m = re.search(name + r"(?:\[\d+\])+ = \{(.*?)\};", src, re.S)
        return [int(x) for x in re.findall(r"\d+", m.group(1))]

    assert table("kAlpha") == list(ALPHA_TABLE)
    assert table("kBeta") == list(BETA_TABLE)
    assert table("kTc0") == list(np.asarray(TC0_TABLE).reshape(-1))


def test_entry_point_declares_pointer_types(monkeypatch):
    """Pointers (the 10 tensors, of which the Cr QPs and the two offsets
    may be null, and the progress scratch) and the stream must go through
    ctypes as void*: with the default int argument type they would be cut
    to 32 bits."""
    import ctypes

    class FakeLib:
        deblock_frame = ctypes.CDLL(None).labs

    monkeypatch.setattr(dc._build, "load", lambda name: FakeLib)
    dc._kernel.cache_clear()
    try:
        fn = dc._kernel()
        assert fn.argtypes == [ctypes.c_void_p] * 11 + [ctypes.c_int] * 2 \
            + [ctypes.c_void_p]
        assert fn.restype is ctypes.c_int
    finally:
        dc._kernel.cache_clear()


def test_wrapper_rejects_cpu_tensors():
    """The wrapper takes CUDA tensors only: it never runs the plain
    version in the kernel's place."""
    n0 = dc.launches
    with pytest.raises(ValueError):
        dc.deblock_frame_cuda(*_inputs(6, 5, 0), 6, 5)
    assert dc.launches == n0


def test_auto_dispatch_on_cpu_is_plain():
    args = _inputs(6, 5, 1, blocky=True)
    n0 = dc.launches
    got = dt.deblock_frame_auto(*args, 6, 5)
    want = dt.deblock_frame_device(*args, 6, 5)
    assert dc.launches == n0
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def _offsets(mbw, mbh, seed):
    """Per-MB alpha / beta offsets (-12..12, even, as slices send them)
    and Cb / Cr QPs 14 apart at most."""
    rng = np.random.default_rng(seed)
    n = mbw * mbh
    return [torch.from_numpy(a) for a in (
        rng.integers(-6, 7, n).astype(np.int32) * 2,
        rng.integers(-6, 7, n).astype(np.int32) * 2,
        rng.integers(18, 42, (2, n)).astype(np.int32))]


def test_plain_offsets_zero_and_equal_chroma_qps_change_nothing():
    """The plain version with zero offsets and a [2, n] chroma QP of two
    equal rows gives what it gives without them, and with offsets it
    gives something else: the encoders pass neither and keep their
    bytes."""
    args = _inputs(6, 5, 13, blocky=True)
    n = 30
    want = dt.deblock_frame_device(*args, 6, 5)
    zero = torch.zeros(n, dtype=torch.int32)
    got = dt.deblock_frame_device(*args[:6], torch.stack([args[6]] * 2),
                                  6, 5, zero, zero)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    ao, bo, cqp2 = _offsets(6, 5, 13)
    other = dt.deblock_frame_device(*args[:6], cqp2, 6, 5, ao, bo)
    assert any(not torch.equal(g, w) for g, w in zip(other, want))


@pytest.mark.cuda
@pytest.mark.parametrize("mbw,mbh,seed", [(6, 5, 20), (80, 45, 21),
                                          (2, 300, 22)])
def test_cuda_kernel_with_offsets_matches_plain(mbw, mbh, seed):
    """The decoder's inputs: per-MB alpha / beta offsets and separate Cb
    and Cr QPs, against the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    args = [a.cuda() for a in _inputs(mbw, mbh, seed, blocky=True)]
    ao, bo, cqp2 = (a.cuda() for a in _offsets(mbw, mbh, seed))
    want = dt.deblock_frame_device(*args[:6], cqp2, mbw, mbh, ao, bo)
    n0 = dc.launches
    got = dc.deblock_frame_cuda(*args[:6], cqp2, mbw, mbh, ao, bo)
    torch.cuda.synchronize()
    assert dc.launches == n0 + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("mbw,mbh,seed,blocky",
                         [(6, 5, 0, False), (4, 7, 1, False),
                          (9, 3, 2, False), (1, 3, 4, True),
                          (6, 5, 5, True), (80, 45, 3, True),
                          (1, 1, 8, True), (2, 300, 9, True),
                          (120, 68, 10, True)])
def test_cuda_kernel_matches_plain(mbw, mbh, seed, blocky):
    """(2, 300) has more MB rows than the card has SMs: blocks take
    several rows by ticket. (120, 68) is the 1080p grid."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    args = [a.cuda() for a in _inputs(mbw, mbh, seed, blocky)]
    before = [a.clone() for a in args]
    want = dt.deblock_frame_device(*args, mbw, mbh)
    n0 = dc.launches
    got = dc.deblock_frame_cuda(*args, mbw, mbh)
    torch.cuda.synchronize()
    assert dc.launches == n0 + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for g, a in zip(got, args[:3]):      # planes filtered in place
        assert g.data_ptr() == a.data_ptr()
    for a, b in zip(args[3:], before[3:]):   # bS and QP only read
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_kernel_repeats_exactly():
    """50 runs on one 80x45 input, each on fresh clones, all equal to the
    plain version: a fault in the progress counters would show only now
    and then."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    args = [a.cuda() for a in _inputs(80, 45, 11, blocky=True)]
    want = dt.deblock_frame_device(*args, 80, 45)
    for _ in range(50):
        got = dc.deblock_frame_cuda(*[a.clone() for a in args[:3]],
                                    *args[3:], 80, 45)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.cuda
def test_cuda_wrapper_rejects_misaligned_planes():
    """The kernel reads whole MB lines (16 bytes of luma, 8 of chroma):
    a plane that starts off that alignment is refused, not launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    args = [a.cuda() for a in _inputs(6, 5, 12)]
    n0 = dc.launches
    y = torch.empty(args[0].numel() + 8, dtype=torch.uint8,
                    device="cuda")[8:].view(args[0].shape)
    with pytest.raises(ValueError):
        dc.deblock_frame_cuda(y, *args[1:], 6, 5)
    assert dc.launches == n0


# ---------------------------------------------------------------------------
# The host encoder (H264Encoder) and the API on the card
# ---------------------------------------------------------------------------
HW, HH = 96, 64


def _host_frames(n, scroll=0, seed=0, size=(HW, HH)):
    """Textured moving content (or, with scroll, content scrolling
    `scroll` rows a frame with rows that repeat exactly), HW x HH unless
    `size` says otherwise."""
    HW, HH = size
    rng = np.random.default_rng(seed)
    tall = rng.integers(0, 256, (4 * HH, HW + 16))
    yy, xx = np.mgrid[0:4 * HH, 0:HW + 16]
    tex = (tall // 3 + 60 * np.sin(xx / 5.0) + 40 * np.cos(yy / 7.0)
           + 80).clip(0, 255)
    cy, cx = np.mgrid[0:HH // 2, 0:HW // 2]
    out = []
    for i in range(n):
        if scroll:
            y = tex[HH + scroll * i:2 * HH + scroll * i, :HW]
        else:
            y = tex[HH + i:2 * HH + i, i:i + HW] + rng.integers(-2, 3,
                                                               (HH, HW))
        u = (cx * 3 + cy + 2 * i) % 256
        v = (200 - cx - 2 * cy + i) % 256
        out.append(tuple(np.clip(a, 0, 255).astype(np.uint8)
                         for a in (y, u, v)))
    return out


_HOST_CONFIGS = {
    "i4x4_intra_in_p": (dict(qp=26, enable_i4x4=True), 0, {}),
    "slices3_rc": (dict(qp=28, num_slices=3, rc_mode=1,
                        target_bitrate=400_000, temporal_layers=2), 0, {}),
    "screen_aq_ltr": (dict(qp=28, usage_type=1, rc_mode=1,
                           target_bitrate=400_000,
                           enable_adaptive_quant=True, enable_gom_rc=True,
                           enable_ltr=True, ltr_mark_period=2),
                      8, {3: "ltr_recovery_request"}),
    "sizelimited": (dict(qp=26, slice_size_constraint=200), 0, {}),
}


def _host_stream(kw, scroll, calls, device):
    from openh264_tpu_torch.encoder.config import EncoderConfig
    from openh264_tpu_torch.encoder.encoder import H264Encoder
    enc = H264Encoder(EncoderConfig(width=HW, height=HH, **kw),
                      device=device)
    out = []
    for i, f in enumerate(_host_frames(5, scroll)):
        if i in calls:
            getattr(enc, calls[i])()
        out.append(enc.encode_frame(*f))
    return out, enc


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(_HOST_CONFIGS))
def test_cuda_host_encoder_matches_cpu(name):
    """H264Encoder on the card writes the CPU path's bytes, keeps the
    same DPB, and launches the deblock kernel once per deblocked
    frame."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    kw, scroll, calls = _HOST_CONFIGS[name]
    want, cpu = _host_stream(dict(kw), scroll, calls, "cpu")
    n0 = dc.launches
    got, gpu = _host_stream(dict(kw), scroll, calls, "cuda")
    assert dc.launches - n0 == sum(1 for b in got if b)
    assert got == want
    for a, b in zip(gpu.dpb, cpu.dpb):
        for p, q in zip(a.planes, b.planes):
            assert p.is_cuda and torch.equal(p.cpu(), q)


@pytest.mark.cuda
def test_cuda_api_matches_cpu():
    """CWelsH264SVCEncoder on the card (one CAVLC slice, so I4x4 in host
    C on the IDR) writes the CPU path's bytes and the same statistics."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from openh264_tpu_torch.api import (ENCODER_OPTION, SEncParamExt,
                                        WelsCreateSVCEncoder)
    res = {}
    for d in ("cpu", "cuda"):
        api = WelsCreateSVCEncoder(device=d)
        assert api.InitializeExt(SEncParamExt(
            iPicWidth=HW, iPicHeight=HH, iRCMode=-1, iInitialQp=26)) == 0
        n0 = dc.launches
        bs = [api.EncodeFrame(*f) for f in _host_frames(4)]
        st = api.GetOption(ENCODER_OPTION.GET_STATISTICS)
        res[d] = (bs, st.fAveragePsnrY, st.iTotalEncodedBytes,
                  dc.launches - n0)
    assert res["cuda"][:3] == res["cpu"][:3]
    assert res["cuda"][3] == 4 and res["cpu"][3] == 0


@pytest.mark.cuda
def test_cuda_machine_builds_host_c():
    """The host C (I4x4 intra decision, bit packer) builds with the card
    machine's host compiler and runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from openh264_tpu_torch import _build
    from openh264_tpu_torch.encoder import cbind
    _build.build("host_native")
    out = np.zeros(8, np.uint8)
    assert cbind.bitpack(np.array([5, 1], np.uint32),
                          np.array([3, 1], np.uint8), out, 0) == 4
    assert out[0] == 0b10110000


# ---------------------------------------------------------------------------
# CABAC, simulcast, GOP parallelism and processing on the card
# ---------------------------------------------------------------------------
@pytest.mark.cuda
def test_cuda_api_cabac_matches_cpu():
    """The API with iEntropyCodingModeFlag=1 on the card writes the CPU
    path's bytes and statistics, one deblock launch per frame."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from openh264_tpu_torch.api import (ENCODER_OPTION, SEncParamExt,
                                        WelsCreateSVCEncoder)
    res = {}
    for d in ("cpu", "cuda"):
        api = WelsCreateSVCEncoder(device=d)
        assert api.InitializeExt(SEncParamExt(
            iPicWidth=HW, iPicHeight=HH, iRCMode=-1, iInitialQp=27,
            iEntropyCodingModeFlag=1)) == 0
        n0 = dc.launches
        bs = [api.EncodeFrame(*f) for f in _host_frames(4, seed=3)]
        st = api.GetOption(ENCODER_OPTION.GET_STATISTICS)
        res[d] = (bs, st.fAveragePsnrY, api.EncodeParameterSets(),
                  dc.launches - n0)
    assert res["cuda"][:3] == res["cpu"][:3]
    assert res["cuda"][3] == 4 and res["cpu"][3] == 0


@pytest.mark.cuda
def test_cuda_threaded_simulcast_matches_cpu():
    """Simulcast with every layer on the card, one thread per layer
    (3 layers of 128x96, the last 32x24), equals the serial CPU run; the
    deblock launches, counted from the threads, equal the layer frames."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from openh264_tpu_torch.encoder.config import EncoderConfig
    from openh264_tpu_torch.parallel import SimulcastEncoder
    rng = np.random.default_rng(4)
    fr = [tuple(rng.integers(0, 256, s, np.uint8)
                for s in ((96, 128), (48, 64), (48, 64))) for _ in range(3)]
    cpu = SimulcastEncoder(EncoderConfig(width=128, height=96, qp=30), 3,
                           device="cpu")
    gpu = SimulcastEncoder(EncoderConfig(width=128, height=96, qp=30), 3,
                           devices=["cuda", "cuda"])
    n0 = dc.launches
    try:
        for f in fr:
            assert gpu.encode_frame(*f) == cpu.encode_frame(*f)
    finally:
        gpu.close()
    assert dc.launches - n0 == 9


@pytest.mark.cuda
def test_cuda_gop_parallel_matches_serial():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from openh264_tpu_torch.encoder.config import EncoderConfig
    from openh264_tpu_torch.encoder.session_device import \
        DeviceSessionEncoder
    from openh264_tpu_torch.parallel import GopParallelEncoder
    fr = _host_frames(6, seed=5)
    cfg = lambda: EncoderConfig(width=HW, height=HH, qp=30,  # noqa: E731
                                idr_interval=3)
    got = GopParallelEncoder(cfg(), devices=["cuda", "cuda"]).encode_stream(
        iter(fr))
    assert got == DeviceSessionEncoder(cfg(), device="cpu").encode_stream(
        iter(fr))


@pytest.mark.cuda
def test_cuda_slice_parallel_across_devices_matches_cpu():
    """Slice-parallel bands on ["cuda:0", "cpu", "cuda:0"]: the reference
    planes go from the card to the CPU band and the CPU band's symbols
    and recon back to the card, the one place where the gather crosses
    devices on a one-GPU machine. The bytes equal ["cpu"] * 3's, the
    merged frame is deblocked by the kernel on the card, once per frame,
    and the DPB planes are equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from openh264_tpu_torch.encoder.config import EncoderConfig
    from openh264_tpu_torch.parallel import SliceParallelEncoder
    fr = _host_frames(4, seed=7, size=(160, 96))
    res = {}
    for name, devs in (("cpu", ["cpu"] * 3),
                       ("mixed", ["cuda:0", "cpu", "cuda:0"])):
        spe = SliceParallelEncoder(EncoderConfig(width=160, height=96, qp=28,
                                                 num_slices=3), devs)
        n0 = dc.launches
        res[name] = ([spe.encode_frame(*f) for f in fr], spe.dpb,
                     dc.launches - n0)
    assert res["mixed"][0] == res["cpu"][0]
    assert res["mixed"][2] == 4 and res["cpu"][2] == 0
    for a, b in zip(res["mixed"][1], res["cpu"][1]):
        for p, q in zip(a.planes, b.planes):
            assert p.is_cuda and torch.equal(p.cpu(), q)


@pytest.mark.cuda
def test_cuda_processing_matches_cpu():
    """Denoise, dyadic and general downsampling, background detection and
    rotation give the CPU's results on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from openh264_tpu_torch import processing as P
    f0, f1 = _host_frames(2, seed=6)
    host = [torch.from_numpy(p) for p in f0] + [torch.from_numpy(f1[0])]
    cases = [
        lambda y, u, v, y1: P.denoise_frame(y, u, v),
        lambda y, u, v, y1: (P.dyadic_downsample(y, 1),
                             P.dyadic_downsample(y, 2),
                             P.dyadic_downsample(y, 3)),
        lambda y, u, v, y1: (P.general_bilinear_downsample(y, 48, 72),
                             P.general_bilinear_downsample(y, 37, 50)),
        lambda y, u, v, y1: tuple(P.background_division(
            P.vaa_calc(y1, y)).values()),
        lambda y, u, v, y1: tuple(P.rotate_image(y, d)
                                  for d in (90, 180, 270)),
    ]
    for fn in cases:
        want = fn(*host)
        got = fn(*[t.cuda() for t in host])
        for g, w in zip(got, want):
            assert g.is_cuda and torch.equal(g.cpu(), w)


# ---------------------------------------------------------------------------
# The decoder on the card
# ---------------------------------------------------------------------------
def _decoder_stream(cut):
    """3 slices a picture, 5 pictures at 96x64 from the port's encoder on
    the CPU; with `cut`, slice 1 of picture 2 cut to half its bytes (the
    decoder conceals it, and pictures 3-4 predict from the concealment)."""
    from openh264_tpu_torch.bitstream import (NAL_IDR, NAL_SLICE,
                                              make_annexb_nal, split_annexb)
    from openh264_tpu_torch.encoder.config import EncoderConfig
    from openh264_tpu_torch.encoder.encoder import H264Encoder
    enc = H264Encoder(EncoderConfig(width=HW, height=HH, qp=28,
                                    num_slices=3), device="cpu")
    bs = b"".join(enc.encode_frame(*f) for f in _host_frames(5, seed=7))
    out, pic, k = [], -1, 0
    for nal in split_annexb(bs):
        rbsp = nal.rbsp
        if nal.nal_unit_type in (NAL_SLICE, NAL_IDR):
            if rbsp[0] & 0x80:
                pic, k = pic + 1, 0
            if cut and (pic, k) == (2, 1):
                rbsp = rbsp[:len(rbsp) // 2]
            k += 1
        out.append(make_annexb_nal(nal.nal_ref_idc, nal.nal_unit_type, rbsp))
    return b"".join(out)


@pytest.mark.cuda
@pytest.mark.parametrize("cut,ec_mode", [(False, 2), (True, 2), (True, 6)])
def test_cuda_decoder_matches_cpu(cut, ec_mode):
    """H264Decoder on the card gives the CPU decode's frames, launching
    the deblock kernel once per picture (the concealed one included);
    the pictures after a concealed one show that the DPB's device planes
    were refreshed from the concealment."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from openh264_tpu_torch.decoder import H264Decoder
    bs = _decoder_stream(cut)
    want = H264Decoder(device="cpu", ec_mode=ec_mode).decode_annexb(bs)
    n0 = dc.launches
    got = H264Decoder(device="cuda", ec_mode=ec_mode).decode_annexb(bs)
    assert dc.launches - n0 == 5
    assert len(got) == len(want) == (4 if cut else 5)
    for g, w in zip(got, want):
        for c in "yuv":
            assert np.array_equal(getattr(g, c), getattr(w, c))


def _decoder_input_stream(kind):
    """Streams whose decode reaches the kernel's decoder-only inputs or
    the decoder's parse layer: deblock idc 2 with 3 slices, a chroma QP
    offset, per-slice alpha/beta offsets (test_torch_streams.STREAMS),
    CABAC from the port's encoder, the idc-2 stream with sent 4x4
    scaling lists; and B pictures with the 8x8 transform: CAVLC from
    test_torch_streams.b_stream (implicit weights, sent 4x4 and 8x8
    scaling lists) and CABAC from steered_cabac_stream over the CABAC
    stream (one slice per MB row)."""
    from test_torch_streams import (_stream, b_stream, scaling_lists,
                                    steered_cabac_stream, with_pps)
    if kind in ("cabac", "b_cabac"):
        from openh264_tpu_torch.encoder.config import EncoderConfig
        from openh264_tpu_torch.encoder.encoder import H264Encoder
        enc = H264Encoder(EncoderConfig(width=HW, height=HH, qp=30,
                                        num_slices=2, entropy_cabac=True),
                          device="cpu")
        bs = b"".join(enc.encode_frame(*f) for f in _host_frames(3, seed=8))
        if kind == "b_cabac":
            return steered_cabac_stream(bs, idc=2, scaling=True, seed=9,
                                        rows_per_slice=1)
        return bs
    if kind == "b_cavlc":
        return b_stream(idc=2, scaling=True, w=HW, h=HH, seed=9)[0]
    if kind == "scaling_lists":
        return with_pps(_stream("idc2_slices3"), scaling=True,
                        scaling_lists=scaling_lists(3))
    return _stream(kind)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["idc2_slices3", "chroma_offset", "offsets",
                                  "cabac", "scaling_lists", "b_cavlc",
                                  "b_cabac"])
def test_cuda_decoder_inputs_match_cpu(kind):
    """Deblock idc 2, a chroma QP offset, non-zero slice alpha/beta
    offsets, CABAC, scaling lists, and B pictures with the 8x8 transform
    in CAVLC and CABAC: H264Decoder on the card gives the CPU decode's
    frames, one deblock launch per picture."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from openh264_tpu_torch.decoder import H264Decoder
    bs = _decoder_input_stream(kind)
    want = H264Decoder(device="cpu").decode_annexb(bs)
    n0 = dc.launches
    got = H264Decoder(device="cuda").decode_annexb(bs)
    assert dc.launches - n0 == len(want) >= 3
    for g, w in zip(got, want):
        for c in "yuv":
            assert np.array_equal(getattr(g, c), getattr(w, c))
