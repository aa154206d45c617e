"""Port parity: simulcast against the JAX package, and the build / load
of the port's native code from several threads.

SimulcastEncoder, serial and with one thread per layer, must equal the
JAX one, with a layer whose height is not a multiple of 16. GOP
parallelism has its own file (test_torch_gop_parallel.py).
"""

import threading

import numpy as np
import pytest

from openh264_tpu.decoder import H264Decoder
from openh264_tpu.encoder.encoder import EncoderConfig as JCfg
from openh264_tpu.parallel.simulcast import SimulcastEncoder as JSim
from openh264_tpu_torch import _build
from openh264_tpu_torch.encoder.config import EncoderConfig as TCfg
from openh264_tpu_torch.parallel import SimulcastEncoder


def _moving(n, w, h, seed):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h, w), np.uint8)
    u = rng.integers(0, 256, (h // 2, w // 2), np.uint8)
    v = rng.integers(0, 256, (h // 2, w // 2), np.uint8)
    return [((np.roll(base, 2 * i, 1).astype(np.int16)
              + rng.integers(-2, 3, base.shape)).clip(0, 255)
             .astype(np.uint8), u, v) for i in range(n)]


def _sim_cfgs(**kw):
    return (C(width=128, height=96, qp=30, **kw) for C in (JCfg, TCfg))


@pytest.mark.parametrize("threaded", [False, True])
def test_simulcast_matches_jax(threaded):
    """3 layers of 128x96: 64x48 and 32x24, whose height is no multiple of
    16 (the encoder pads to 32 rows and crops in its SPS). Serial and
    threaded (one thread per layer on CPU devices) write the JAX bytes,
    layer by layer."""
    jc, tc = _sim_cfgs(idr_interval=2)
    js = JSim(jc, 3)
    ts = SimulcastEncoder(tc, 3, devices=["cpu"] * 2 if threaded else None,
                          device="cpu")
    assert [e.cfg.height for e in ts.encoders] == [96, 48, 24]
    layers = [b""] * 3
    try:
        for f in _moving(3, 128, 96, 2):
            a, al = js.encode_frame(*f)
            b, bl = ts.encode_frame(*f)
            assert a == b and al == bl
            layers = [x + y for x, y in zip(layers, bl)]
    finally:
        ts.close()
    for k, s in enumerate(layers):
        dec = H264Decoder().decode_annexb(s)
        assert len(dec) == 3 and dec[0].y.shape == (96 >> k, 128 >> k)


def test_simulcast_cabac_and_refusals():
    jc, tc = _sim_cfgs(entropy_cabac=True)
    js, ts = JSim(jc, 2), SimulcastEncoder(tc, 2, device="cpu")
    for f in _moving(2, 128, 96, 3):
        assert js.encode_frame(*f) == ts.encode_frame(*f)
    with pytest.raises(ValueError):
        SimulcastEncoder(TCfg(width=128, height=96), 5, device="cpu")
    with pytest.raises(ValueError):
        SimulcastEncoder(TCfg(width=128, height=96), 4, device="cpu")


def test_native_loads_from_threads(tmp_path, monkeypatch):
    """Six threads load the host C at once into an empty build directory:
    it is built once, every thread gets the same library, no temporary
    file is left, and the library runs."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    _build._load.cache_clear()
    calls = []
    real = _build.subprocess.run

    def run(*a, **k):
        calls.append(a[0])
        return real(*a, **k)
    monkeypatch.setattr(_build.subprocess, "run", run)
    libs, errors = [], []
    start = threading.Barrier(6)

    def worker():
        try:
            start.wait()
            libs.append(_build.load("host_native"))
        except BaseException as e:       # reported below
            errors.append(e)
    threads = [threading.Thread(target=worker) for _ in range(6)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors, errors
        assert len(libs) == 6 and all(lib is libs[0] for lib in libs)
        assert len(calls) == 1
        assert [p.suffix for p in tmp_path.iterdir()] == [".so"]
        lib = _build.bind("host_native")   # the signatures declared
        assert lib is libs[0]
        vals, lens = np.array([5], np.uint32), np.array([3], np.uint8)
        out = np.zeros(4, np.uint8)
        assert lib.bitpack(vals.ctypes.data, lens.ctypes.data, 1,
                           out.ctypes.data, 0) == 3
        assert out[0] == 0b10100000
    finally:
        _build._load.cache_clear()
