"""Port parity: slice-parallel encoding against the JAX package's.

The JAX module shards the bands of MB rows over a mesh of 3 of the 8
CPU devices that tests/conftest.py makes; the port runs the same bands
on devices ["cpu"] * 3. The steps must equal the JAX steps key by key,
and SliceParallelEncoder the JAX one byte for byte, with equal DPB
planes after every frame. Where the JAX module departs from its own
H264Encoder(num_slices=3) (ROADMAP.md C11), the port departs alike.
One mesh size for the whole file, so the JAX steps compile once.
"""

import numpy as np
import pytest
import torch

from openh264_tpu.decoder import H264Decoder as JDec
from openh264_tpu.encoder.encoder import EncoderConfig as JCfg
from openh264_tpu.encoder.encoder import H264Encoder as JEnc
from openh264_tpu.parallel.slice_parallel import SliceParallelEncoder as JSpe
from openh264_tpu.parallel.slice_parallel import make_mesh as j_make_mesh
from openh264_tpu.parallel.slice_parallel import sliced_i_step as j_i_step
from openh264_tpu.parallel.slice_parallel import sliced_p_step as j_p_step
from openh264_tpu_torch.decoder import H264Decoder as TDec
from openh264_tpu_torch.encoder.config import EncoderConfig as TCfg
from openh264_tpu_torch.encoder.encoder import H264Encoder as TEnc
from openh264_tpu_torch.parallel import (SliceParallelEncoder, make_mesh,
                                         sliced_i_step, sliced_p_step)

W, H = 160, 96
N = 3                       # slices: bands of 2 MB rows
CPUS = ["cpu"] * N


def _frames(n, seed=0, step=1):
    """Textured content moving `step` px a frame down and right, with
    camera noise, and drifting chroma ramps."""
    rng = np.random.default_rng(seed)
    tall = rng.integers(0, 256, (H + step * n + 16, W + step * n + 16))
    yy, xx = np.mgrid[0:tall.shape[0], 0:tall.shape[1]]
    tex = (tall // 3 + 60 * np.sin(xx / 5.0) + 40 * np.cos(yy / 7.0)
           + 80).clip(0, 255)
    cy, cx = np.mgrid[0:H // 2, 0:W // 2]
    out = []
    for i in range(n):
        y = tex[step * i:step * i + H, step * i:step * i + W] + \
            rng.integers(-2, 3, (H, W))
        u = (cx * 3 + cy + 2 * i) % 256
        v = (200 - cx - 2 * cy + i) % 256
        out.append(tuple(np.clip(a, 0, 255).astype(np.uint8)
                         for a in (y, u, v)))
    return out


@pytest.fixture(scope="module")
def mesh():
    return j_make_mesh(N)


def _same_symbols(jout, tout):
    assert sorted(jout) == sorted(tout)
    for k in jout:
        assert tout[k].shape[0] == N, k
        np.testing.assert_array_equal(np.asarray(jout[k]), tout[k].numpy(),
                                      err_msg=k)


def _same_dpb(jspe, tspe):
    jd, td = jspe._host.dpb, tspe.dpb
    assert [(e.frame_num, e.coding_idx, e.temporal_id) for e in jd] == \
        [(e.frame_num, e.coding_idx, e.temporal_id) for e in td]
    for a, b in zip(jd, td):
        for p, q in zip(a.planes, b.planes):
            np.testing.assert_array_equal(np.asarray(p), q.numpy())


def test_steps_match_jax(mesh):
    """The I step, then the P step on its recon, equal the JAX steps key
    by key: every array with a leading slice axis."""
    y, u, v = _frames(2, seed=1)[0]
    yn, un, vn = _frames(2, seed=1)[1]
    kw = dict(mb_w=W // 16, mb_h_band=H // 16 // N)
    ji = j_i_step(y, u, v, 28, 28, mesh=mesh, **kw)
    ti = sliced_i_step(y, u, v, 28, 28, devices=CPUS, **kw)
    _same_symbols(ji, ti)
    ref = [np.array(ji[k]).reshape(-1, ji[k].shape[-1])
           for k in ("recon_y", "recon_u", "recon_v")]
    jp = j_p_step(yn, un, vn, *ref, 30, 29, mesh=mesh, **kw)
    tp = sliced_p_step(yn, un, vn, *ref, 30, 29, devices=CPUS, **kw)
    _same_symbols(jp, tp)
    assert tp["recon_y"].shape == (N, H // N, W)


def _run_pair(mesh, kw, frames):
    """Both slice-parallel encoders on `frames`: bytes and DPB equal after
    every frame. Returns the port's per-frame bytes."""
    jspe = JSpe(JCfg(width=W, height=H, num_slices=N, **kw), mesh)
    tspe = SliceParallelEncoder(TCfg(width=W, height=H, num_slices=N, **kw),
                                CPUS)
    out = []
    for i, f in enumerate(frames):
        a = jspe.encode_frame(*f)
        b = tspe.encode_frame(*f)
        assert a == b, f"frame {i}"
        _same_dpb(jspe, tspe)
        out.append(b)
    return out


_CONFIGS = {
    "cavlc": dict(qp=28),
    "idr_interval_2": dict(qp=28, idr_interval=2),
    "cabac": dict(qp=28, entropy_cabac=True),
    "bitrate_rc": dict(qp=30, rc_mode=1, target_bitrate=200_000),
    "deblock_idc2": dict(qp=30, deblock_idc=2),
    "two_refs": dict(qp=28, num_ref_frames=2),
}


@pytest.mark.parametrize("name", list(_CONFIGS))
def test_encoder_matches_jax(mesh, name):
    """SliceParallelEncoder writes the JAX one's bytes, one slice NAL per
    band, and keeps its DPB."""
    for b in _run_pair(mesh, _CONFIGS[name], _frames(5)):
        heads = _nal_heads(b)
        # SPS and PPS before the slices of an IDR
        assert len(heads) == N + 2 * (heads[0] == 0x67)


def _multislice(kw, frames):
    """H264Encoder(num_slices=3) of both packages; their bytes are equal
    (test_torch_encoder_slices.py holds them), so the port's are
    returned."""
    je = JEnc(JCfg(width=W, height=H, num_slices=N, **kw))
    te = TEnc(TCfg(width=W, height=H, num_slices=N, **kw), device="cpu")
    out = [te.encode_frame(*f) for f in frames]
    assert [je.encode_frame(*f) for f in frames] == out
    return out


def _nal_heads(bs: bytes) -> list:
    """The first byte (nal_ref_idc, nal_unit_type) of each NAL."""
    return [p[0] for p in bs.split(b"\x00\x00\x00\x01")[1:]]


@pytest.mark.parametrize("name", ["temporal_layers", "search_range",
                                  "scene_change", "frame_skip"])
def test_reference_departures_from_multislice(mesh, name):
    """Pins reference fault C11: the JAX module departs from its own
    H264Encoder(num_slices=3), and the port departs alike (equal bytes).
    It codes every frame as a reference from the newest DPB entry
    (temporal layers: H264Encoder writes layer-1 frames with
    nal_ref_idc 0), searches ±8 whatever cfg.search_range says, runs no
    scene-change detection (H264Encoder makes every frame an IDR, fault
    C1) and never lets rate control skip a frame."""
    kw, frames = {
        "temporal_layers": (dict(qp=28, temporal_layers=2), _frames(3)),
        "search_range": (dict(qp=28, search_range=4),
                         _frames(3, seed=1, step=6)),
        "scene_change": (dict(qp=28, enable_scene_change_detect=True),
                         _frames(3)),
        "frame_skip": (dict(qp=30, rc_mode=1, target_bitrate=20_000,
                            enable_frame_skip=True), _frames(5)),
    }[name]
    spe = _run_pair(mesh, kw, frames)
    ms = _multislice(kw, frames)
    assert spe[0] == ms[0] and spe[1:] != ms[1:]
    heads = [_nal_heads(b) for b in spe[1:]]
    # every frame after the IDR: N reference P slices (nal_ref_idc 2)
    assert heads == [[0x41] * N] * len(heads)
    if name == "temporal_layers":
        assert any(_nal_heads(b) == [0x01] * N for b in ms)
    if name == "scene_change":
        assert all(_nal_heads(b)[0] == 0x67 for b in ms)
    if name == "frame_skip":
        assert b"" in ms


def test_ltr_agrees_with_multislice(mesh):
    """LTR marking every 2 frames: H264Encoder(num_slices) never marks a
    multi-slice frame either, so with LTR on the two agree, in both
    packages (checked, not a departure)."""
    kw = dict(qp=28, enable_ltr=True, ltr_mark_period=2, ltr_ref_num=2)
    frames = _frames(4)
    assert _run_pair(mesh, kw, frames) == _multislice(kw, frames)


def test_refusals():
    """mb_height not divisible by the band count raises in both packages;
    without a GPU, make_mesh and CUDA devices raise (nothing falls back
    to the CPU)."""
    cfg = dict(width=W, height=H, num_slices=4)
    with pytest.raises(ValueError, match="not divisible"):
        SliceParallelEncoder(TCfg(**cfg), ["cpu"] * 4)
    with pytest.raises(ValueError, match="not divisible"):
        JSpe(JCfg(**cfg), j_make_mesh(4))
    assert make_mesh(device="cpu") == (torch.device("cpu"),)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            make_mesh(N)
        with pytest.raises(RuntimeError):
            SliceParallelEncoder(TCfg(width=W, height=H), ["cuda:0"] * N)


def test_stream_decodes_to_dpb():
    """The port's stream (deblock idc 0, so reference fault C2 does not
    apply) decodes through both decoders to the encoder's DPB planes,
    frame by frame."""
    spe = SliceParallelEncoder(TCfg(width=W, height=H, qp=28), CPUS)
    bs, dpb = b"", []
    for f in _frames(4, seed=2):
        bs += spe.encode_frame(*f)
        dpb.append([p.numpy().copy() for p in spe.dpb[-1].planes])
    for frames in (JDec().decode_annexb(bs),
                   TDec(device="cpu").decode_annexb(bs)):
        assert len(frames) == 4
        for fr, want in zip(frames, dpb):
            for got, w in zip((fr.y, fr.u, fr.v), want):
                np.testing.assert_array_equal(np.asarray(got), w)


def test_reference_fault_idc2_filters_across_slices():
    """Pins reference fault C2 in the slice-parallel encoders: with
    deblock idc 2 the slice headers forbid filtering across slice edges,
    but the encoder's FrameSymbols carry disable_deblock 0, so its recon
    is filtered there and the decoder's pictures differ from its DPB, in
    both packages alike (test_encoder_matches_jax[deblock_idc2])."""
    spe = SliceParallelEncoder(TCfg(width=W, height=H, qp=32,
                                    deblock_idc=2), CPUS)
    bs = spe.encode_frame(*_frames(1, seed=3)[0])
    dec = TDec(device="cpu").decode_annexb(bs)[0]
    assert not np.array_equal(dec.y, spe.dpb[-1].planes[0].numpy())
