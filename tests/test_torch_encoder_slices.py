"""Port parity: H264Encoder's slice modes against the JAX package's.

Fixed slice counts (each band of MB rows coded by the core in band mode,
`row_off`, against the whole reference) and SM_SIZELIMITED slicing (per-
MB host writer; IDR slices found by a probe pass). Bytes and DPB planes
must equal the JAX encoder's after every frame; the port runs on the
CPU.
"""


from test_torch_encoder import _frames, _run_pair


def test_three_slices_two_temporal_layers():
    """3 slices (bands of 2, 1 and 1 MB rows) with 2 temporal layers:
    non-reference frames of layer 1, IDR bands coded separately."""
    bs = _run_pair(dict(qp=28, num_slices=3, temporal_layers=2),
                   _frames(5, seed=6))
    # 3 slice NALs per P frame; the IDR adds SPS and PPS
    assert [b.count(b"\x00\x00\x00\x01") for b in bs] == [5, 3, 3, 3, 3]


def test_three_slices_deblock_idc2_rc():
    """deblock_idc 2 and bitrate RC over 3 slices: the encoder's FrameSymbols
    carry disable_deblock 0, so its own recon is filtered across slice
    edges (see test_torch_host_deblock.py)."""
    _run_pair(dict(qp=30, num_slices=3, deblock_idc=2, rc_mode=1,
                   target_bitrate=200_000), _frames(4, seed=7))


def test_size_limited_slices():
    """Slices close at 150 bytes: several slices on the IDR (probe pass,
    then bands) and on every P frame (per-MB writer)."""
    bs = _run_pair(dict(qp=24, slice_size_constraint=150),
                   _frames(4, seed=8))
    n = [b.count(b"\x00\x00\x00\x01") for b in bs]
    assert n[0] >= 2 + 2 and all(k >= 2 for k in n[1:])
