"""Port parity of B direct prediction and of the B weights, exact, on the
CPU:
- decoder/direct.py (copied): distance_scale_factor over POC
  distances that hit its clamps; DirectContext.col_motion,
  temporal_direct, col_zero and spatial_refs on seeded colocated grids
  (intra blocks, L1-only blocks, a long-term L1[0], direct_8x8_inference
  on and off) and seeded neighbour motion, against the JAX package's
  openh264_tpu.decoder.direct;
- decoder/wpred.py: build_slice_wp for B slices (explicit, implicit with
  a long-term reference, the implicit mode that falls back to the plain
  average) and implicit_weights, and the batched recon's vectorized
  lookup (recon_batch._WPLuts.implicit_w0), against the JAX twins.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from openh264_tpu.decoder import direct as jdirect
from openh264_tpu.decoder import dpb as jdpb
from openh264_tpu.decoder import mvpred as jmv
from openh264_tpu.decoder import wpred as jwp
from openh264_tpu.decoder.framedata import FrameSymbols as JFS
from openh264_tpu_torch.decoder import direct as tdirect
from openh264_tpu_torch.decoder import dpb as tdpb
from openh264_tpu_torch.decoder import mvpred as tmv
from openh264_tpu_torch.decoder import recon_batch as trb
from openh264_tpu_torch.decoder import wpred as twp
from openh264_tpu_torch.decoder.framedata import FrameSymbols as TFS

MB_W, MB_H = 3, 2
H4, W4 = 4 * MB_H, 4 * MB_W


def test_distance_scale_factor_matches_jax():
    """Every POC triple in a range wide enough to clamp tb and td at
    -128/127 and the factor at -1024/1023, td 0 included."""
    pocs = list(range(-300, 301, 23)) + [0, 1, -1, 127, 128, -128, -129]
    for cur in pocs[::3]:
        for p0 in pocs:
            for p1 in pocs[::2]:
                assert tdirect.distance_scale_factor(cur, p0, p1) == \
                    jdirect.distance_scale_factor(cur, p0, p1)


def _pictures(rng, long_term):
    """Three reference pictures per package (pic ids 3, 5, 8) with the
    same seeded colocated grids; the first is long-term if asked."""
    out = {"jax": [], "port": []}
    for k, (pid, poc) in enumerate(((3, 4), (5, 16), (8, 10))):
        intra = rng.random((H4, W4)) < 0.2
        ref0 = np.where(rng.random((H4, W4)) < 0.3, -1,
                        rng.integers(0, 3, (H4, W4)))
        grids = dict(
            col_mv0=rng.integers(-6, 7, (H4, W4, 2)).astype(np.int32),
            col_mv1=rng.integers(-6, 7, (H4, W4, 2)).astype(np.int32),
            col_ref0=np.where(intra, -1, ref0).astype(np.int32),
            col_ref1=np.where(intra, -1, rng.integers(0, 2, (H4, W4))
                              ).astype(np.int32),
            col_refpic0=rng.choice([3, 5, 8, 11], (H4, W4)).astype(np.int32),
            col_refpic1=rng.choice([3, 5, 8], (H4, W4)).astype(np.int32),
            col_intra=intra,
            col_mb16=rng.random(MB_W * MB_H) < 0.5)
        for name, mod, plane in (("jax", jdpb, np.zeros),
                                 ("port", tdpb, torch.zeros)):
            p = mod.Picture(pid, plane((16, 16)), plane((8, 8)),
                            plane((8, 8)), poc=poc, is_ref=True,
                            is_long_term=long_term and k == 0)
            for g, a in grids.items():
                setattr(p, g, a.copy())
            out[name].append(p)
    return out


def _motion(rng, fs_cls, mv_mod):
    """A FrameSymbols whose first MB row carries seeded motion in both
    lists (the neighbours of the second row), and its MvContext."""
    fs = fs_cls(MB_W, MB_H)
    fs.slice_id[:] = 0
    mv_mod.ensure_motion_grids(fs)
    fs.gmv[:, :4] = rng.integers(-20, 21, (2, 4, W4, 2))
    fs.gref[:, :4] = rng.integers(-1, 3, (2, 4, W4))
    fs.gwritten[:4] = True
    return fs, mv_mod.MvContext(fs, 0)


@pytest.mark.parametrize("seed,spatial,d8,long_term", [
    (0, False, True, False), (1, False, False, False), (2, True, True, False),
    (3, True, False, True), (4, False, True, True)])
def test_direct_context_matches_jax(seed, spatial, d8, long_term):
    rng = np.random.default_rng(seed)
    pics = _pictures(rng, long_term)
    mrng = np.random.default_rng(seed + 10)
    jfs, jmvc = _motion(mrng, JFS, jmv)
    mrng = np.random.default_rng(seed + 10)
    tfs, tmvc = _motion(mrng, TFS, tmv)
    sh = SimpleNamespace(direct_spatial_mv_pred=spatial,
                         sps=SimpleNamespace(direct_8x8_inference=d8))
    order = [(1, 2), (0,)] if long_term else [(2, 1), (0, 1)]
    ctx = {}
    for name, mod in (("jax", jdirect), ("port", tdirect)):
        p = pics[name]
        l0 = [p[i] for i in order[0]]
        l1 = [p[i] for i in order[1]]
        ctx[name] = mod.DirectContext(sh, l0, l1, 9)
    j, t = ctx["jax"], ctx["port"]
    assert t.dsf == j.dsf and t.colref_to_l0 == j.colref_to_l0
    for by in range(H4):
        for bx in range(W4):
            a, b = t.col_motion(bx, by), j.col_motion(bx, by)
            np.testing.assert_array_equal(a[0], b[0])
            assert a[1:] == b[1:]
            a, b = t.temporal_direct(bx, by), j.temporal_direct(bx, by)
            assert a[:2] == b[:2]
            np.testing.assert_array_equal(np.stack(a[2:]), np.stack(b[2:]))
            assert t.col_zero(bx, by) == j.col_zero(bx, by)
    for mbx in range(MB_W):
        a = t.spatial_refs(tmvc, 4 * mbx, 4, MB_W + mbx)
        b = j.spatial_refs(jmvc, 4 * mbx, 4, MB_W + mbx)
        assert (a[0], a[1], a[4], a[5]) == (b[0], b[1], b[4], b[5])
        np.testing.assert_array_equal(np.stack(a[2:4]), np.stack(b[2:4]))


def _b_header(idc, n0, n1, rng):
    weights = {(lx, r): {"luma_weight": int(rng.integers(-10, 70)),
                         "luma_offset": int(rng.integers(-20, 20)),
                         "chroma_weight": [int(rng.integers(-5, 40))] * 2,
                         "chroma_offset": [int(rng.integers(-9, 9))] * 2}
               for lx in (0, 1) for r in range(2)}
    return SimpleNamespace(
        slice_type=1, pps=SimpleNamespace(weighted_pred=False,
                                          weighted_bipred_idc=idc),
        luma_log2_weight_denom=5, chroma_log2_weight_denom=3,
        weights=weights, pic_order_cnt_lsb=7, num_ref_idx_l0_active=n0,
        num_ref_idx_l1_active=n1)


@pytest.mark.parametrize("idc,n0,n1,cur,long_term", [
    (1, 2, 2, 9, False), (2, 3, 2, 9, False), (2, 3, 3, 9, True),
    (2, 1, 1, 10, False), (2, 2, 3, 300, False), (0, 2, 2, 9, False)])
def test_b_weights_match_jax(idc, n0, n1, cur, long_term):
    """build_slice_wp of a B slice: explicit (idc 1), implicit (idc 2)
    with a long-term reference, the implicit pair whose POCs are
    symmetric about the picture (plain average), POC distances past the
    clamps; implicit_weights and _WPLuts.implicit_w0 on every ref pair,
    out-of-table ones included."""
    rng = np.random.default_rng(idc * 10 + n0)
    sh = _b_header(idc, n0, n1, np.random.default_rng(5))
    pics = _pictures(rng, long_term)
    i0 = {k: [p[i] for i in (0, 2, 1)][:n0] for k, p in pics.items()}
    i1 = {k: [p[i] for i in (1, 2, 0)][:n1] for k, p in pics.items()}
    j = jwp.build_slice_wp(sh, i0["jax"], i1["jax"], cur_poc=cur)
    t = twp.build_slice_wp(sh, i0["port"], i1["port"], cur_poc=cur)
    for f in ("mode", "luma_denom", "chroma_denom", "weights"):
        assert getattr(t, f) == getattr(j, f), f
    if j.implicit_w0 is None:
        assert t.implicit_w0 is None
    else:
        np.testing.assert_array_equal(t.implicit_w0, j.implicit_w0)
    r = np.arange(-1, 5)
    r0, r1 = np.repeat(r, len(r)), np.tile(r, len(r))
    fs = TFS(1, 1)
    fs.wp_by_slice = [t]
    lut = trb._WPLuts(fs).implicit_w0(np.zeros(len(r0), np.int32), r0, r1)
    for a, b, w0 in zip(r0, r1, lut):
        assert twp.implicit_weights(t, a, b) == jwp.implicit_weights(j, a, b)
        if t.mode == twp.WP_B_IMPLICIT:
            assert w0 == twp.implicit_weights(t, a, b)[0]
