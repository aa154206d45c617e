"""Port parity: CWelsH264SVCEncoder against the JAX package's.

The same calls go to both API objects (the port's on device="cpu"): the
slice-mode mapping of InitializeExt, EncodeFrame bytes, ForceIntraFrame,
every SetOption / GetOption the JAX class handles, a re-initialisation
at another resolution, and the statistics apart from their wall-time
fields.
"""

import dataclasses

import numpy as np
import pytest

from openh264_tpu.api import encoder_api as japi
from openh264_tpu.api import params as jparams
from openh264_tpu_torch.api import encoder_api as tapi
from openh264_tpu_torch.api import params as tparams
from openh264_tpu_torch.api.options import ENCODER_OPTION

WALL_TIME = {"fAverageFrameSpeedInMs", "fAverageFrameRate",
             "fLatestFrameRate"}


def _frames(n, w=96, h=64, seed=0):
    rng = np.random.default_rng(seed)
    tall = rng.integers(0, 256, (h + n, w + n))
    yy, xx = np.mgrid[0:h + n, 0:w + n]
    tex = (tall // 3 + 60 * np.sin(xx / 5.0) + 40 * np.cos(yy / 7.0)
           + 80).clip(0, 255)
    cy, cx = np.mgrid[0:h // 2, 0:w // 2]
    out = []
    for i in range(n):
        y = tex[i:i + h, i:i + w] + rng.integers(-2, 3, (h, w))
        out.append(tuple(np.clip(a, 0, 255).astype(np.uint8) for a in (
            y, (cx * 3 + cy + 2 * i) % 256, (200 - cx - 2 * cy + i) % 256)))
    return out


def _param(mod, w=96, h=64, slice_mode=None, slice_num=1, **kw):
    """SEncParamExt of the package `mod` (JAX or port params)."""
    qp, size = kw.pop("qp", 26), kw.pop("size", 1500)
    layers = []
    if slice_mode is not None:
        layers = [mod.SSpatialLayerConfig(
            iVideoWidth=w, iVideoHeight=h, iDLayerQp=qp,
            sSliceArgument=mod.SSliceArgument(
                uiSliceMode=slice_mode, uiSliceNum=slice_num,
                uiSliceSizeConstraint=size))]
    return mod.SEncParamExt(iPicWidth=w, iPicHeight=h, sSpatialLayers=layers,
                            **kw)


class _Pair:
    """A JAX and a port API object driven by the same calls."""

    def __init__(self):
        self.j = japi.WelsCreateSVCEncoder()
        self.t = tapi.WelsCreateSVCEncoder(device="cpu")

    def init(self, **kw):
        rj = self.j.InitializeExt(_param(jparams, **kw))
        rt = self.t.InitializeExt(_param(tparams, **kw))
        assert rj == rt
        if rj == 0:
            assert dataclasses.asdict(self.j._enc.cfg) == \
                dataclasses.asdict(self.t._enc.cfg)
        return rt

    def encode(self, frames):
        for i, f in enumerate(frames):
            assert self.j.EncodeFrame(*f) == self.t.EncodeFrame(*f), i
        self.same_stats()

    def set(self, opt, jval, tval=None):
        rj = self.j.SetOption(opt, jval)
        rt = self.t.SetOption(opt, jval if tval is None else tval)
        assert rj == rt
        return rt

    def get(self, opt):
        vj, vt = self.j.GetOption(opt), self.t.GetOption(opt)
        if dataclasses.is_dataclass(vj):
            vj, vt = ({k: x for k, x in dataclasses.asdict(v).items()
                       if k not in WALL_TIME} for v in (vj, vt))
        assert vj == vt
        return vt

    def same_stats(self):
        self.get(ENCODER_OPTION.GET_STATISTICS)


@pytest.mark.parametrize("mode,num,want", [
    (None, 1, dict(num_slices=1, enable_i4x4=True,
                   slice_size_constraint=0)),
    (0, 1, dict(num_slices=1, enable_i4x4=True, slice_size_constraint=0)),
    (1, 3, dict(num_slices=3, enable_i4x4=False, slice_size_constraint=0)),
    # uiSliceMode 4 is size-limited in the reference API, and the
    # SM_SIZELIMITED_SLICE constant (3) gives uiSliceNum slices
    (4, 1, dict(num_slices=1, enable_i4x4=True, slice_size_constraint=700)),
    (3, 2, dict(num_slices=2, enable_i4x4=False,
                slice_size_constraint=0)),
])
def test_initialize_slice_modes(mode, num, want):
    p = _Pair()
    assert p.init(slice_mode=mode, slice_num=num, size=700, qp=30,
                  iRCMode=-1) == 0
    cfg = p.t._enc.cfg
    assert {k: getattr(cfg, k) for k in want} == want
    assert cfg.enable_vui


def test_initialize_rejects_bad_parameters():
    p = _Pair()
    assert p.init(w=0) == tapi.cmInitParaError
    assert p.init(iInitialQp=60) == tapi.cmInitParaError
    assert p.init(iEntropyCodingModeFlag=0, slice_mode=1, slice_num=2,
                  iRCMode=-1) == 0


def test_cabac_is_not_an_init_error():
    """iEntropyCodingModeFlag=1 initialises and encodes CABAC as the JAX
    API does: the same config (Main profile, no I4x4), the same parameter
    sets, frames and statistics; with 2 fixed slices too. Size-limited
    slicing (mode 4) under CABAC is an init-parameter error in both."""
    p = _Pair()
    assert p.init(iEntropyCodingModeFlag=1, iRCMode=-1, iInitialQp=27) == 0
    cfg = p.t._enc.cfg
    assert cfg.entropy_cabac and cfg.profile_idc == 77
    assert not cfg.enable_i4x4
    assert p.j.EncodeParameterSets() == p.t.EncodeParameterSets()
    f = _frames(3, seed=3)
    p.encode(f)
    assert p.init(iEntropyCodingModeFlag=1, slice_mode=1, slice_num=2,
                  iRCMode=1, iTargetBitrate=300_000) == 0
    p.encode(f[:2])
    assert p.init(iEntropyCodingModeFlag=1, slice_mode=4, size=700) == \
        tapi.cmInitParaError


def test_encode_force_idr_and_statistics():
    """One CAVLC slice (I4x4 in host C on the IDR, intra-in-P after),
    ForceIntraFrame, parameter sets, PSNR and the other statistics."""
    p = _Pair()
    assert p.init(iRCMode=-1, iInitialQp=27, uiIntraPeriod=0) == 0
    f = _frames(5)
    p.encode(f[:2])
    assert p.j.ForceIntraFrame(True) == p.t.ForceIntraFrame(True)
    p.encode(f[2:5])
    assert p.j.EncodeParameterSets() == p.t.EncodeParameterSets()
    st = p.t.GetOption(ENCODER_OPTION.GET_STATISTICS)
    assert st.uiIDRReqNum == 1 and st.uiInputFrameCount == 5
    assert st.fAveragePsnrY > 30


def test_options():
    """Every option the JAX class handles, each followed by frames."""
    p = _Pair()
    assert p.init(iRCMode=1, iTargetBitrate=300_000, iInitialQp=28) == 0
    f = _frames(12, seed=1)
    p.encode(f[:2])
    O = ENCODER_OPTION
    for opt, val in [(O.IDR_INTERVAL, 5), (O.FRAME_RATE, 15.0),
                     (O.BITRATE, 200_000), (O.MAX_BITRATE, 400_000),
                     (O.RC_FRAME_SKIP, False), (O.NUMBER_REF, 2),
                     (O.COMPLEXITY, 0), (O.TRACE_LEVEL, 0),
                     (O.STATISTICS_LOG_INTERVAL, 0), (O.DATAFORMAT, 23)]:
        assert p.set(opt, val) == 0
    p.encode(f[2:4])
    for opt in (O.IDR_INTERVAL, O.NUMBER_REF, O.COMPLEXITY,
                O.SVC_ENCODE_PARAM_EXT, O.GET_STATISTICS):
        p.get(opt)
    assert p.set(O.DATAFORMAT, 12) == tapi.cmInitParaError
    assert p.set(O.ENABLE_SSEI, True) == tapi.cmInitParaError
    assert p.set(O.RC_MODE, -1) == 0
    # LTR: switched on mid-stream (forces an IDR), marked every 2 frames,
    # feedback, then a recovery request
    class Ltr:
        bEnableLongTermReference = True
        iLTRRefNum = 1
    assert p.set(O.LTR, Ltr()) == 0
    assert p.set(O.LTR_MARKING_PERIOD, 2) == 0
    p.encode(f[4:7])
    assert p.set(O.LTR_MARKING_FEEDBACK,
                 {"uiFeedbackType": 1, "iLTRFrameNum": 2}) == 0
    assert p.set(O.LTR_RECOVERY_REQUEST, None) == 0
    p.encode(f[7:9])
    calls = []
    assert p.set(O.TRACE_CALLBACK, calls.append) == 0
    assert p.set(O.TRACE_CALLBACK, None) == 0
    # re-initialisation at another resolution through SetOption
    assert p.set(O.SVC_ENCODE_PARAM_EXT, _param(jparams, w=64, h=48,
                                                 iRCMode=-1),
                 _param(tparams, w=64, h=48, iRCMode=-1)) == 0
    p.encode(_frames(3, w=64, h=48, seed=2))


def test_uninitialized_options_refused():
    p = _Pair()
    assert p.set(ENCODER_OPTION.IDR_INTERVAL, 5) == tapi.cmInitParaError
    assert p.get(ENCODER_OPTION.IDR_INTERVAL) == 0
    assert p.t.Uninitialize() == p.j.Uninitialize() == 0


def test_default_device_needs_a_gpu():
    """The API's default device is "cuda": without a GPU it raises."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    with pytest.raises(RuntimeError):
        tapi.WelsCreateSVCEncoder()
