"""Port parity: the h264enc console against the JAX package's.

Both `main` functions get the same arguments on a temporary YUV file
(the port's with device="cpu") and must write the same Annex-B file,
return the same exit code and print the same lines apart from the
timing ones: options alone, a cfg file with a LayerCfg file and
overrides, CAVLC and `-cabac 1`, and the exit-code-1 cases. Two faults
of the reference console are pinned as well (ROADMAP.md, queue C).
"""

import pytest

from openh264_tpu.cli import h264enc as jcli
from openh264_tpu_torch.cli import h264enc as tcli

from test_torch_encoder import _frames

W, H = 96, 64
TIMING = ("encode time:", "FPS:")


@pytest.fixture
def yuv(tmp_path):
    path = tmp_path / "in.yuv"
    with open(path, "wb") as f:
        for y, u, v in _frames(4, seed=21):
            f.write(y.tobytes() + u.tobytes() + v.tobytes())
    return path


def _run(capsys, main, argv, **kw):
    rc = main(argv, **kw)
    out, err = capsys.readouterr()
    return rc, [ln for ln in out.splitlines()
                if not ln.startswith(TIMING)], err


def _both(capsys, tmp_path, argv):
    """Runs both consoles with `argv`, where "{out}" stands for each
    one's output file; returns the port's (rc, stdout lines, stream)."""
    res = []
    for name, main, kw in (("jax", jcli.main, {}),
                           ("port", tcli.main, {"device": "cpu"})):
        out = tmp_path / f"{name}.264"
        rc, lines, err = _run(capsys, main,
                              [a.replace("{out}", str(out)) for a in argv],
                              **kw)
        res.append((rc, lines, err,
                    out.read_bytes() if out.exists() else None))
    assert res[0] == res[1]
    return res[1]


@pytest.mark.parametrize("cabac", ["0", "1"])
def test_options_only(capsys, tmp_path, yuv, cabac):
    rc, lines, _err, bs = _both(capsys, tmp_path, [
        "-org", str(yuv), "-sw", str(W), "-sh", str(H), "-bf", "{out}",
        "-frms", "3", "-rc", "-1", "-iper", "2", "-cabac", cabac])
    assert rc == 0 and lines[:3] == [f"Width:\t\t{W}", f"Height:\t\t{H}",
                                     "Frames:\t\t3"]
    assert bs.startswith(b"\x00\x00\x00\x01") and len(bs) > 500


@pytest.mark.parametrize("cabac", ["0", "1"])
def test_cfg_file_layer_cfg_and_overrides(capsys, tmp_path, yuv, cabac):
    """welsenc.cfg names the input relative to its own directory and a
    LayerCfg file whose keys fill what the rest left unset; the command
    line overrides the file. No FramesToBeEncoded: every frame of the
    file is encoded."""
    (tmp_path / "layer0.cfg").write_text(
        "SliceMode 1\nSliceNum 2  # two fixed slices\nRCMode 0\n")
    (tmp_path / "welsenc.cfg").write_text(
        "// the reference's key-value format\n"
        f"SourceWidth {W}\nSourceHeight {H}\nInputFile in.yuv\n"
        "RCMode 1   # bitrate mode, overridden below\n"
        "TargetBitrate 400\nIntraPeriod 3\nLayerCfg layer0.cfg\n")
    rc, lines, _err, bs = _both(capsys, tmp_path, [
        str(tmp_path / "welsenc.cfg"), "-rc", "-1", "-bf", "{out}",
        "-cabac", cabac])
    assert rc == 0 and lines[2] == "Frames:\t\t4"
    # IDRs (with SPS and PPS) at frames 0 and 3, 2 slices per frame
    assert bs.count(b"\x00\x00\x00\x01") == 2 * (2 + 2) + 2 * 2


@pytest.mark.parametrize("argv", [
    ["-org", "x.yuv", "-sw", "96", "-sh", "64", "-foo", "1"],   # unknown
    ["-org", "x.yuv", "-sw"],                                   # incomplete
    ["-sw", "96", "-sh", "64", "-bf", "{out}"],                 # no input
    ["-org", "x.yuv", "-sh", "64"],                             # no width
])
def test_exit_code_1(capsys, tmp_path, argv):
    rc, lines, err, bs = _both(capsys, tmp_path, argv)
    assert rc == 1 and lines == [] and err and bs is None


def test_help(capsys):
    for main in (jcli.main, tcli.main):
        assert main(["-h"]) == 0
        assert "Usage:" in capsys.readouterr().out


def test_reference_fault_inert_options(capsys, tmp_path, yuv):
    """Pins two faults of the reference console (ROADMAP.md, queue C):
    -denois, -scene, -aq and -bgd are accepted but never read, and -qp
    sets iInitialQp, which the API ignores because the console always
    passes a spatial layer whose iDLayerQp (26) wins. Each leaves the
    stream unchanged, in both packages."""
    base = ["-org", str(yuv), "-sw", str(W), "-sh", str(H), "-bf", "{out}",
            "-frms", "2", "-rc", "-1"]
    plain = _both(capsys, tmp_path, base + ["-qp", "20"])[3]
    for extra in (["-qp", "44"],
                  ["-qp", "20", "-denois", "1", "-scene", "1", "-aq", "1",
                   "-bgd", "1"]):
        assert _both(capsys, tmp_path, base + extra)[3] == plain
    # the layer QP is 26 whatever -qp says: the same stream as the API's
    # at iDLayerQp 26 (the console's SEncParamExt)
    param = tcli.encoder_param(tcli.settings(
        ["-sw", str(W), "-sh", str(H), "-rc", "-1", "-qp", "44"])[0])
    assert param.sSpatialLayers[0].iDLayerQp == 26
    assert param.iInitialQp == 44
    from openh264_tpu_torch.api import WelsCreateSVCEncoder
    api = WelsCreateSVCEncoder(device="cpu")
    assert api.InitializeExt(param) == 0
    assert api._enc.qp == 26
    assert b"".join(api.EncodeFrame(*f) for f in _frames(2, seed=21)) == \
        plain
