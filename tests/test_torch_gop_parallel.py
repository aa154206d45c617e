"""Port parity: GOP parallelism against the JAX package.

GopParallelEncoder on two CPU "devices" (two threads) must equal the
port's serial session and the JAX serial session: closed GOPs share no
state, and each GOP's session starts at the serial idr_pic_id.
"""

import pytest
import torch

from openh264_tpu.decoder import H264Decoder
from openh264_tpu.encoder.encoder import EncoderConfig as JCfg
from openh264_tpu.encoder.session_device import \
    DeviceSessionEncoder as JSession
from openh264_tpu_torch.encoder.config import EncoderConfig as TCfg
from openh264_tpu_torch.encoder.session_device import \
    DeviceSessionEncoder as TSession
from openh264_tpu_torch.parallel import GopParallelEncoder

from test_torch_parallel import _moving


def test_gop_parallel_matches_serial():
    """3 closed GOPs of 3 frames over two CPU devices: the stitched
    stream equals the port's and the JAX package's serial sessions, and
    decodes to every frame."""
    w, h = 96, 80
    fr = _moving(9, w, h, 1)
    par = GopParallelEncoder(TCfg(width=w, height=h, qp=30, idr_interval=3),
                             devices=["cpu", "cpu"])
    got = par.encode_stream(iter(fr))
    ser = TSession(TCfg(width=w, height=h, qp=30, idr_interval=3),
                   device="cpu").encode_stream(iter(fr))
    jser = JSession(JCfg(width=w, height=h, qp=30,
                         idr_interval=3)).encode_stream(iter(fr))
    assert got == ser == jser
    assert len(H264Decoder().decode_annexb(b"".join(got))) == 9


def test_gop_parallel_refusals():
    with pytest.raises(ValueError):
        GopParallelEncoder(TCfg(width=96, height=80), devices=["cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            GopParallelEncoder(TCfg(width=96, height=80, idr_interval=4))
