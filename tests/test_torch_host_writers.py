"""Port parity: the host encoder's writers and host C against the JAX
package's, on random symbols from a numpy seed: write_residual_block,
write_p_slice_tokens with assemble_rbsp (packed by the port's host C
bitpack), MvContext predictions, and the I-frame I16x16-vs-I4x4 decision
in host C (enc_intra_frame_native). Bytes and arrays must be equal.
"""

import numpy as np
import pytest

from openh264_tpu.bitstream import BitWriter as JBW
from openh264_tpu.decoder.framedata import FrameSymbols as JFS
from openh264_tpu.decoder.mvpred import MvContext as JMvc
from openh264_tpu.encoder import cavlc_enc as jce
from openh264_tpu.encoder import cavlc_vec as jcv
from openh264_tpu.native import enc_intra_frame_native as j_intra
from openh264_tpu_torch import _build
from openh264_tpu_torch.bitstream import BitWriter as TBW
from openh264_tpu_torch.decoder.framedata import FrameSymbols as TFS
from openh264_tpu_torch.decoder.mvpred import MvContext as TMvc
from openh264_tpu_torch.encoder import cavlc_enc as tce
from openh264_tpu_torch.encoder import cbind
from openh264_tpu_torch.encoder import cavlc_vec as tcv


def _levels(rng, shape, density, big=False):
    lev = rng.integers(-3, 4, shape) * (rng.random(shape) < density)
    if big:            # escapes of the level prefix
        lev = lev + (rng.random(shape) < 0.05) * rng.integers(-900, 900,
                                                             shape)
    return lev.astype(np.int32)


@pytest.mark.parametrize("seed", range(4))
def test_write_residual_block(seed):
    """Every nC class (chroma DC -1, 0-1, 2-3, 4-7, 8+) and block size
    (4, 15, 16), sparse to dense, with large levels."""
    rng = np.random.default_rng(seed)
    jw, tw = JBW(), TBW()
    for _ in range(300):
        n = int(rng.choice([4, 15, 16]))
        nc = -1 if n == 4 else int(rng.integers(0, 17))
        c = _levels(rng, n, rng.random(), big=seed >= 2)
        assert jce.write_residual_block(jw, c, nc, n) == \
            tce.write_residual_block(tw, c, nc, n)
    jw.rbsp_trailing_bits()
    tw.rbsp_trailing_bits()
    assert jw.get_bytes() == tw.get_bytes()


def _symbols(rng, mb_w, mb_h, intra_p, with_qp):
    n = mb_w * mb_h
    out = {
        "mv": rng.integers(-24, 25, (n, 2)).astype(np.int32)
        * (rng.random((n, 1)) < 0.7),
        "luma_ac": _levels(rng, (n, 16, 16), 0.05),
        "chroma_dc": _levels(rng, (n, 2, 4), 0.2),
        "chroma_ac": _levels(rng, (n, 2, 4, 16), 0.02),
        "intra_mask": rng.random(n) < intra_p,
        "i16_mode": rng.integers(0, 4, n).astype(np.int32),
        "chroma_mode": rng.integers(0, 4, n).astype(np.int32),
        "luma_dc": _levels(rng, (n, 4, 4), 0.3),
        "slice_qp": 28,
    }
    # skips: no residual at the neighbours' zero MV
    quiet = rng.random(n) < 0.3
    for k in ("luma_ac", "chroma_dc", "chroma_ac"):
        out[k][quiet] = 0
    out["mv"][quiet] = 0
    if with_qp:
        out["mb_qp"] = rng.integers(20, 40, n).astype(np.int32)
    return out


@pytest.mark.parametrize("seed,intra_p,with_qp", [(0, 0.0, False),
                                                  (1, 0.2, False),
                                                  (2, 0.0, True),
                                                  (3, 0.1, True)])
def test_p_slice_tokens_and_rbsp(seed, intra_p, with_qp):
    """The vectorised P-slice writer's token arrays, and the slice bytes
    that the port's host C bit packer makes of them."""
    rng = np.random.default_rng(seed)
    out = _symbols(rng, 7, 5, intra_p, with_qp)
    want = jcv.write_p_slice_tokens(dict(out), 7, 5)
    got = tcv.write_p_slice_tokens(dict(out), 7, 5)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if w is not None:
            np.testing.assert_array_equal(g, w)
    hdr = rng.integers(0, 2, 37).astype(np.uint8)
    groups = [(want[0], want[1])] + ([(want[2], want[3])]
                                     if want[2] is not None else [])
    assert tcv.assemble_rbsp(hdr, groups) == jcv.assemble_rbsp(hdr, groups)


def test_bitpack_appends_msb_first():
    """Tokens of 0-32 bits appended at odd bit offsets, against a bit
    string built in Python."""
    rng = np.random.default_rng(4)
    lens = rng.integers(0, 33, 500).astype(np.uint8)
    vals = rng.integers(0, 1 << 32, 500, dtype=np.uint64).astype(np.uint32)
    out = np.zeros(2200, np.uint8)
    out[0] = 0b10100000
    pos = cbind.bitpack(vals, lens, out, 3)
    bits = "101" + "".join(format(int(v) & ((1 << int(n)) - 1), f"0{n}b")
                           if n else "" for v, n in zip(vals, lens))
    assert pos == len(bits)
    assert np.unpackbits(out)[:pos].tolist() == [int(b) for b in bits]


def _mv_fields(pkg_fs, pkg_mvc, seed, slices):
    """MvContext predictions over a random P16x16 / intra field, in
    raster order as the writers make them."""
    rng = np.random.default_rng(seed)
    mb_w, mb_h = 6, 5
    fs = pkg_fs(mb_w, mb_h)
    fs.slice_id[:] = -1
    preds = []
    mvc = None
    cut = set(rng.choice(np.arange(1, 30), slices - 1, replace=False))
    sidx = 0
    for mb in range(mb_w * mb_h):
        if mvc is None or mb in cut:
            sidx += mvc is not None
            mvc = pkg_mvc(fs, sidx)
        fs.slice_id[mb] = sidx
        gx, gy = (mb % mb_w) * 4, (mb // mb_w) * 4
        fs.gwritten[gy:gy + 4, gx:gx + 4] = False
        preds.append(mvc.pred_skip_mv(gx, gy, mb).tolist())
        preds.append(mvc.pred_mv(gx, gy, 4, 4, 0, 0, mb).tolist())
        if rng.random() < 0.2:                   # intra: unavailable ref
            fs.gmv[:, gy:gy + 4, gx:gx + 4] = 0
            fs.gref[:, gy:gy + 4, gx:gx + 4] = -1
            fs.gwritten[gy:gy + 4, gx:gx + 4] = True
        else:
            mv = rng.integers(-8, 9, 2).astype(np.int32) * \
                (rng.random() < 0.7)
            mvc.set_partition(gx, gy, 4, 4, 0, 0, mv)
    return preds


@pytest.mark.parametrize("seed,slices", [(0, 1), (1, 1), (2, 3), (3, 4)])
def test_mv_context_predictions(seed, slices):
    assert _mv_fields(TFS, TMvc, seed, slices) == \
        _mv_fields(JFS, JMvc, seed, slices)


@pytest.mark.parametrize("seed,qp", [(0, 22), (1, 30), (2, 38)])
def test_enc_intra_frame_native(seed, qp):
    """The port's host C I-frame decision and encode equals the JAX
    package's host C on the same planes and QPs."""
    from openh264_tpu_torch.encoder.core_torch import QP_COST_TABLE
    from openh264_tpu_torch.tables import CHROMA_QP_TABLE
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:48, 0:80]
    y = (rng.integers(0, 256, (48, 80)) * (xx > 32) + 2 * yy + 60
         ).clip(0, 255).astype(np.uint8)
    u = rng.integers(90, 160, (24, 40)).astype(np.uint8)
    v = (u[::-1] // 2 + 40).astype(np.uint8)
    qpc = int(CHROMA_QP_TABLE[qp])
    lam = int(QP_COST_TABLE[qp])
    want = j_intra(y, u, v, qp, qpc, lam)
    got = cbind.enc_intra_frame_native(y, u, v, qp, qpc, lam)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert (got["kind"] == 0).any()


def test_host_c_build_failure_raises(tmp_path, monkeypatch):
    """No fallback: when the host compiler fails, building raises."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CC", "false")
    with pytest.raises(RuntimeError, match="false failed"):
        _build.build("host_native")
