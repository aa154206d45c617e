"""Port parity: CABAC in the host encoder against the JAX package.

The arithmetic engine and the context initialisation on seeded bin
sequences; then H264Encoder with entropy_cabac=True, the port on
device="cpu", writing the JAX encoder's bytes and keeping its DPB in
each of the paths CABAC takes: one slice (IPPP with an IDR interval,
intra-in-P), fixed slices, rate control with adaptive quant (per-MB
delta QP), and a state carried from one encoder into another. The
Main-profile SPS, the refusal of size-limited slicing, the port's and the
JAX decoding engines reading the seeded bins back, and the JAX decoder
reading the port's CABAC stream back are checked too.
"""

import numpy as np
import pytest

from openh264_tpu.bitstream import BitWriter as JWriter
from openh264_tpu.decoder import H264Decoder
from openh264_tpu.decoder import cabac as jcabac
from openh264_tpu.encoder import cabac_enc as jcabac_enc
from openh264_tpu.encoder.encoder import EncoderConfig as JCfg
from openh264_tpu.encoder.encoder import H264Encoder as JEnc
from openh264_tpu_torch.bitstream import BitWriter as TWriter
from openh264_tpu_torch.decoder import cabac as tcabac
from openh264_tpu_torch.encoder import cabac_enc as tcabac_enc
from openh264_tpu_torch.encoder import core_torch
from openh264_tpu_torch.encoder.config import EncoderConfig as TCfg
from openh264_tpu_torch.encoder.encoder import H264Encoder as TEnc

from test_torch_encoder import _frames, _jax_state, _same_dpb

W, H = 96, 64


def test_tables_and_constants_equal():
    for name in ("CTX_INIT_MN", "RANGE_LPS", "STATE_TRANS", "SIG8x8_CTX",
                 "LAST8x8_CTX"):
        np.testing.assert_array_equal(getattr(jcabac, name),
                                      getattr(tcabac, name))
    for name in dir(jcabac):
        if name.isupper() and not name.startswith("_") and \
                hasattr(tcabac, name) and \
                not isinstance(getattr(jcabac, name), np.ndarray):
            assert getattr(jcabac, name) == getattr(tcabac, name), name
    assert tcabac.N_CTX == 460 and tcabac.CTX_ABS_8x8 == 431


@pytest.mark.parametrize("is_i,idc,qp", [(True, 0, 0), (True, 0, 26),
                                         (False, 0, 28), (False, 1, 51),
                                         (False, 2, 17)])
def test_context_init(is_i, idc, qp):
    a = jcabac.CabacContexts(is_i, idc, qp)
    b = tcabac.CabacContexts(is_i, idc, qp)
    np.testing.assert_array_equal(a.state, b.state)
    np.testing.assert_array_equal(a.mps, b.mps)


def _bins(seed, n=3000):
    """A seeded sequence of engine calls: skewed decisions on a few
    contexts, bypass bins, terminate(0), composite binarisations; one
    terminate(1) at the end."""
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(n):
        r = rng.random()
        if r < 0.7:
            ctx = int(rng.integers(0, 460))
            ops.append(("decision", ctx, int(rng.random() < (ctx % 7) / 7)))
        elif r < 0.9:
            ops.append(("bypass", int(rng.integers(0, 2))))
        elif r < 0.93:
            ops.append(("terminate", 0))
        elif r < 0.97:
            ops.append(("ueg_mv", 47, int(rng.integers(0, 40))))
        else:
            ops.append(("ueg_level", 232 + int(rng.integers(0, 5)),
                        int(rng.integers(0, 30))))
    ops.append(("terminate", 1))
    return ops


def _run_engine(enc_mod, cabac_mod, writer, ops, qp):
    eng = enc_mod.CabacEncoder()
    ctx = cabac_mod.CabacContexts(False, 0, qp)
    for op in ops:
        if op[0] in ("decision", "ueg_mv", "ueg_level"):
            getattr(eng, op[0])(ctx, op[1], op[2])
        else:
            getattr(eng, op[0])(op[1])
    w = writer()
    w.u(3, 5)                  # a slice header's bits before the body
    w.byte_align(1)
    eng.write_to(w)
    return w.get_bytes(), ctx


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_engine_bins_equal_and_decode(seed):
    """Both engines write the same bytes for the same bins, and both
    decoding engines, the JAX one and the port's, read the port's
    decisions, bypass bins, terminations and composite binarisations
    back, ending at the same bit position."""
    ops = _bins(seed)
    a, ca = _run_engine(jcabac_enc, jcabac, JWriter, ops, 20 + seed)
    b, cb = _run_engine(tcabac_enc, tcabac, TWriter, ops, 20 + seed)
    assert a == b and len(b) > 100
    np.testing.assert_array_equal(ca.state, cb.state)
    ends = []
    for mod in (jcabac, tcabac):
        dec = mod.CabacEngine(b, 8)
        ctx = mod.CabacContexts(False, 0, 20 + seed)
        for op in ops:
            if op[0] == "decision":
                assert dec.decision(ctx, op[1]) == op[2]
            elif op[0] == "bypass":
                assert dec.bypass() == op[1]
            elif op[0] == "terminate":
                assert dec.terminate() == op[1]
            else:
                assert getattr(dec, op[0])(ctx, op[1]) == op[2]
        ends.append((dec.pos, dec.range, dec.offset, ctx.state.tolist(),
                     ctx.mps.tolist()))
    assert ends[0] == ends[1]


def _pair(kw, frames, calls=None):
    """Both encoders on `frames` with CABAC; calls[i] runs on both before
    frame i. Returns the port's bytes per frame and its encoder."""
    kw = dict(kw, entropy_cabac=True)
    je = JEnc(JCfg(width=W, height=H, **kw))
    te = TEnc(TCfg(width=W, height=H, **kw), device="cpu")
    assert te.cfg.profile_idc == je.cfg.profile_idc == 77
    out = []
    for i, f in enumerate(frames):
        if calls and i in calls:
            calls[i](je)
            calls[i](te)
        a = je.encode_frame(*f)
        b = te.encode_frame(*f)
        assert a == b, f"frame {i}"
        _same_dpb(je, te)
        out.append(b)
    return out, te


def test_constqp_ippp_idr_interval():
    bs, _ = _pair(dict(qp=28, idr_interval=3), _frames(5, seed=7))
    assert [b[4] & 0x1f == 7 for b in bs] == [True, False, False, True,
                                               False]


def _new_object_frames(n, seed):
    """Moving texture with a block of fresh noise that appears in frame 1
    and jumps every frame: no reference matches it, so the P frames
    code intra MBs there."""
    fr = _frames(n, seed=seed)
    rng = np.random.default_rng(seed + 100)
    for i in range(1, n):
        y = fr[i][0]
        y[16:48, 16 * i:16 * i + 32] = rng.integers(0, 256, (32, 32))
    return fr


def test_intra_in_p(monkeypatch):
    """Intra MBs inside P slices: the P writer codes them as I16x16 with
    the P-slice mb_type prefix; the device wavefront runs with a mask."""
    masks = []
    orig = core_torch.encode_i_frame

    def spy(*a, **k):
        if k.get("intra_mask") is not None:
            masks.append(int(k["intra_mask"].sum()))
        return orig(*a, **k)
    monkeypatch.setattr(core_torch, "encode_i_frame", spy)
    _pair(dict(qp=28), _new_object_frames(4, seed=8))
    assert masks and max(masks) > 0


def test_two_fixed_slices():
    """num_slices=2: each MB-row band is its own CABAC slice (its own
    engine and contexts), I and P."""
    bs, _ = _pair(dict(qp=27, num_slices=2, idr_interval=3),
                  _frames(4, seed=9))
    assert all(b.count(b"\x00\x00\x00\x01") == (4 if i % 3 == 0 else 2)
               for i, b in enumerate(bs))


def test_rc_adaptive_quant_delta_qp(monkeypatch):
    """rc_mode=1 with adaptive quant: per-MB QPs reach the P writer, which
    codes their deltas (mb_qp_delta) on MBs with residual."""
    seen = []
    orig = TEnc._write_p_slice_cabac

    def spy(self, w, out, mb_h=None):
        if out.get("mb_qp") is not None:
            seen.append(len(set(out["mb_qp"].tolist())))
        return orig(self, w, out, mb_h)
    monkeypatch.setattr(TEnc, "_write_p_slice_cabac", spy)
    _pair(dict(qp=28, rc_mode=1, target_bitrate=300_000,
               enable_adaptive_quant=True, enable_gom_rc=True),
          _frames(4, seed=10))
    assert seen and max(seen) > 1


def test_state_carried_over():
    """3 CABAC frames in the JAX encoder, its state carried into the port,
    then 3 more frames in both write the same bytes; the port's own
    export_state round-trips too."""
    kw = dict(qp=28, rc_mode=1, target_bitrate=300_000, entropy_cabac=True)
    f = _frames(6, seed=11)
    je = JEnc(JCfg(width=W, height=H, **kw))
    for x in f[:3]:
        je.encode_frame(*x)
    te = TEnc.from_state(TCfg(width=W, height=H, **kw), _jax_state(je),
                         device="cpu")
    _same_dpb(je, te)
    for x in f[3:5]:
        assert je.encode_frame(*x) == te.encode_frame(*x)
        _same_dpb(je, te)
    te2 = TEnc.from_state(TCfg(width=W, height=H, **kw), te.export_state(),
                          device="cpu")
    assert te2.encode_frame(*f[5]) == te.encode_frame(*f[5])


def test_main_profile_sps():
    """CABAC lifts profile_idc from Baseline (66) to Main (77) in the
    config and in the SPS; the PPS carries entropy_coding_mode_flag."""
    cj, ct = (C(width=W, height=H, entropy_cabac=True) for C in (JCfg, TCfg))
    je, te = JEnc(cj), TEnc(ct, device="cpu")
    assert cj.profile_idc == ct.profile_idc == 77
    hdr = te.headers_annexb()
    assert hdr == je.headers_annexb()
    assert hdr[4] & 0x1f == 7 and hdr[5] == 77
    cavlc = TEnc(TCfg(width=W, height=H), device="cpu").headers_annexb()
    assert cavlc[5] == 66 and cavlc != hdr


def test_size_limited_slicing_refused():
    for Enc, Cfg, kw in ((JEnc, JCfg, {}), (TEnc, TCfg, {"device": "cpu"})):
        with pytest.raises(ValueError):
            Enc(Cfg(width=W, height=H, entropy_cabac=True,
                    slice_size_constraint=500), **kw)


def test_jax_decoder_reads_port_stream():
    """The JAX decoder decodes the port's CABAC stream (IDR, P frames
    with intra MBs, a second IDR) to the port encoder's own recon."""
    fr = _new_object_frames(5, seed=12)
    enc = TEnc(TCfg(width=W, height=H, qp=30, idr_interval=4,
                    entropy_cabac=True), device="cpu")
    bs, recon = [], []
    for f in fr:
        bs.append(enc.encode_frame(*f))
        recon.append([p.numpy().copy() for p in enc.dpb[-1].planes])
    dec = H264Decoder().decode_annexb(b"".join(bs))
    assert len(dec) == len(fr)
    for d, rec in zip(dec, recon):
        for c, r in zip("yuv", rec):
            np.testing.assert_array_equal(getattr(d, c), r)
