"""Port parity: H264Encoder's screen-content and adaptive-quant paths
against the JAX package's.

Bitrate RC with adaptive quant and GOM QP offsets (per-MB QP arrays into
the core, mb_qp_delta in the writer), and screen content whose global
scroll becomes the core's extra_mv candidate. Bytes and DPB planes must
equal the JAX encoder's after every frame; the port runs on the CPU.
"""

import pytest
import torch

from test_torch_encoder import _frames, _run_pair


@pytest.mark.parametrize("aq,gom", [(True, True), (True, False),
                                    (False, True)])
def test_rc_adaptive_quant_gom(aq, gom):
    """rc_mode 1 with adaptive quant and / or GOM offsets: per-MB QP
    arrays reach the core and the writer's mb_qp_delta chain."""
    _run_pair(dict(qp=28, rc_mode=1, target_bitrate=300_000,
                   enable_adaptive_quant=aq, enable_gom_rc=gom),
              _frames(4, seed=9))


def test_constqp_adaptive_quant():
    """AQ without RC: the delta-QP map is not re-centred."""
    _run_pair(dict(qp=30, enable_adaptive_quant=True), _frames(3, seed=10))


def test_screen_scroll_candidate():
    """usage_type 1 on content scrolling 20 rows a frame, beyond the
    search range: the scroll is detected between input frames and
    becomes the core's extra_mv."""
    from openh264_tpu_torch.processing.scroll import detect_scroll
    f = _frames(4, seed=11, scroll=20)
    assert detect_scroll(torch.from_numpy(f[1][0]),
                         torch.from_numpy(f[0][0])) == (True, 20)
    _run_pair(dict(qp=26, usage_type=1), f)
