"""The plain reference decoder: equal to the port's CPU decoder and to
the JAX package's decoder on small CAVLC and CABAC streams, and to the
port's on the committed streams' first pictures, its control
different, and nothing of the program, the JAX package or JAX imported
by it or by a run."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from benchmark import checks, streams
from benchmark.reference import PlainDecoder
from benchmark.tests.conftest import REPO, run_py


def port_pictures(data: bytes):
    from openh264_tpu_torch.decoder import H264Decoder
    return [f.planes() for f in H264Decoder(device="cpu").decode_annexb(data)]


def plain_pictures(data: bytes, n=None, deblock=True):
    dec = PlainDecoder(deblock=deblock)
    return [dec.decode_au(au) for au in streams.access_units(data)[:n]]


def equal(a, b):
    return all(np.array_equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("stream", ["tiny", "tinycabac"])
def test_plain_decoder_equals_the_port_on_small_streams(tiny_root, stream):
    data = (tiny_root / "benchmark" / "streams" / f"{stream}.264"
            ).read_bytes()
    want = port_pictures(data)
    got = plain_pictures(data)
    assert len(got) == len(want) == 24
    assert all(equal(g, w) for g, w in zip(got, want))
    ctl = plain_pictures(data, deblock=False)
    assert not all(equal(c, w) for c, w in zip(ctl, want))


JAX_WITNESS = """
import json, sys
import numpy as np
from openh264_tpu.decoder import H264Decoder
from benchmark import streams
from benchmark.reference import PlainDecoder
data = open(sys.argv[1], "rb").read()
want = [f.planes() for f in H264Decoder().decode_annexb(data)]
dec = PlainDecoder()
got = [dec.decode_au(au) for au in streams.access_units(data)]
print(json.dumps([len(want), len(got)] + [
    max(int(np.abs(np.asarray(w, np.int16) - g.astype(np.int16)).max())
        for w, g in zip(wp, gp)) for wp, gp in zip(want, got)]))
"""


@pytest.mark.parametrize("stream", ["tiny", "tinycabac"])
def test_plain_decoder_equals_the_jax_package_on_small_streams(tiny_root,
                                                               stream):
    # a second witness beside the port: the JAX package's decoder, in a
    # process of its own (a run of the benchmark never loads it)
    import importlib.util
    if importlib.util.find_spec("jax") is None:
        pytest.skip("the JAX package's decoder needs jax")
    path = tiny_root / "benchmark" / "streams" / f"{stream}.264"
    res = subprocess.run(
        [sys.executable, "-c", JAX_WITNESS, str(path)], cwd=tiny_root,
        env=dict(os.environ, JAX_PLATFORMS="cpu",
                 PYTHONPATH=f"{tiny_root}{os.pathsep}{REPO}"),
        capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    n_want, n_got, *diffs = json.loads(res.stdout.strip().splitlines()[-1])
    assert n_want == n_got == 24
    assert max(diffs) == 0


@pytest.mark.parametrize("stream", ["cbp_720p30", "main_720p30_cabac"])
def test_plain_decoder_equals_the_port_on_committed_streams(stream):
    gops, _ = streams.load(stream)
    data = b"".join(gops[1][:2])         # an IDR and a P picture
    want = port_pictures(data)
    got = plain_pictures(data)
    assert len(got) == len(want) == 2
    assert all(equal(g, w) for g, w in zip(got, want))


def test_stepping_from_given_reference_planes_equals_the_chain(tiny_root):
    data = (tiny_root / "benchmark" / "streams" / "tiny.264").read_bytes()
    aus = streams.access_units(data)
    chain = plain_pictures(data, n=3)
    ps = b"".join(n for t, n in streams.nal_units(aus[0])
                  if t not in streams.SLICE_NAL_TYPES)
    step = PlainDecoder().decode_au(ps + aus[2], ref=chain[1])
    assert equal(step, chain[2])


def test_stream_with_another_hash_is_refused(tiny_root, tmp_path):
    code = ("from benchmark import streams\n"
            "p = streams.STREAM_DIR / 'tiny.264'\n"
            "d = bytearray(p.read_bytes()); d[-1] ^= 1\n"
            "p.write_bytes(bytes(d))\n"
            "try:\n"
            "    streams.load('tiny')\n"
            "except ValueError as e:\n"
            "    print('refused', e)\n")
    import shutil
    root = tmp_path / "copy"
    shutil.copytree(tiny_root, root, symlinks=True)
    res = run_py(root, code)
    assert "refused" in res.stdout, res.stderr[-2000:]


def test_reference_imports_nothing_of_the_program():
    assert checks.reference_violations() == []
    res = subprocess.run(
        [sys.executable, "-c",
         "import sys, json; import benchmark.reference; "
         "print(json.dumps(sorted(sys.modules)))"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    mods = json.loads(res.stdout)
    assert checks.forbidden_loaded(mods, checks.FORBIDDEN_IN_REFERENCE) == []
    assert "torch" not in mods


def test_import_check_compares_whole_top_level_names(tmp_path):
    mods = ["openh264_tpu_torch", "openh264_tpu_torch.decoder", "numpy",
            "jaxtyping", "openh264_tpu_extra"]
    assert checks.forbidden_loaded(mods) == []
    assert checks.forbidden_loaded(mods + ["openh264_tpu.decoder", "jax",
                                           "jaxlib.xla"]) == [
        "jax", "jaxlib.xla", "openh264_tpu.decoder"]
    assert checks.forbidden_loaded(["openh264_tpu_torch.x"],
                                   checks.FORBIDDEN_IN_REFERENCE) == [
        "openh264_tpu_torch.x"]
    ref = tmp_path / "ref"
    ref.mkdir()
    (ref / "a.py").write_text("import numpy\nfrom openh264_tpu_torch "
                              "import decoder\nfrom . import b\n")
    (ref / "b.py").write_text("import openh264_tpu_tools\n")
    assert checks.reference_violations(ref) == ["a.py: openh264_tpu_torch"]
