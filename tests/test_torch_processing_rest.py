"""Port parity: the rest of processing/ against the JAX package.

Downsampling (dyadic and general bilinear), denoising, background
detection, complexity analysis and rotation: the same planes (numpy,
from a seed) go through the JAX function and its port on the CPU, and
the results must be equal (tolerance 0), dtypes and shapes included.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openh264_tpu.processing as jproc
import openh264_tpu_torch.processing as tproc
from openh264_tpu.processing import background as jbg
from openh264_tpu.processing import complexity as jcx
from openh264_tpu.processing import denoise as jdn
from openh264_tpu.processing import downsample as jds
from openh264_tpu.processing import rotate as jrot
from openh264_tpu.processing import vaa as jvaa
from openh264_tpu_torch.processing import background as tbg
from openh264_tpu_torch.processing import complexity as tcx
from openh264_tpu_torch.processing import denoise as tdn
from openh264_tpu_torch.processing import downsample as tds
from openh264_tpu_torch.processing import rotate as trot
from openh264_tpu_torch.processing import vaa as tvaa

SHAPES = [(64, 96), (72, 88), (63, 97), (48, 16)]


def _plane(shape, seed):
    """Smooth texture plus noise: neighbours mostly within the bilateral
    filter's gray radius, with some edges beyond it."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]]
    p = 120 + 60 * np.sin(xx / 6.0) * np.cos(yy / 9.0) + \
        rng.integers(-20, 21, shape)
    p[rng.random(shape) < 0.05] = 255
    return np.clip(p, 0, 255).astype(np.uint8)


def _same(j, t):
    a = np.asarray(j)
    b = t.numpy()
    assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)


def test_exports_match():
    names = ("vaa_calc", "dyadic_downsample", "general_bilinear_downsample",
             "denoise_frame", "detect_scene_change", "SCENE_CHANGED_LARGE",
             "SCENE_CHANGED_MEDIUM", "SIMILAR", "background_division",
             "adaptive_quant_map", "frame_complexity", "gom_complexity",
             "rotate_image", "detect_scroll")
    for n in names:
        assert hasattr(jproc, n) and hasattr(tproc, n), n
    for n in ("SCENE_CHANGED_LARGE", "SCENE_CHANGED_MEDIUM", "SIMILAR"):
        assert getattr(jproc, n) == getattr(tproc, n)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("ratio_log2", [1, 2, 3])
def test_dyadic_downsample(shape, ratio_log2):
    y = _plane(shape, 1)
    _same(jds.dyadic_downsample(jnp.asarray(y), ratio_log2),
          tds.dyadic_downsample(torch.from_numpy(y), ratio_log2))


@pytest.mark.parametrize("shape,dst", [
    ((64, 96), (48, 72)),        # 3/4, like 1280x720 -> 960x540
    ((64, 96), (32, 64)),        # 2/3 across, 1/2 down
    ((72, 88), (44, 59)),        # odd ratios
    ((63, 97), (62, 96)),        # near 1
    ((48, 16), (17, 5)),
])
def test_general_bilinear_downsample(shape, dst):
    y = _plane(shape, 2)
    _same(jds.general_bilinear_downsample(jnp.asarray(y), *dst),
          tds.general_bilinear_downsample(torch.from_numpy(y), *dst))


def test_gb_indices_equal():
    for src, dst in ((1280, 960), (720, 540), (1280, 640), (720, 352),
                     (97, 59)):
        for a, b in zip(jds._gb_indices(src, dst, 15),
                        tds._gb_indices(src, dst, 15)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shape", SHAPES + [(2, 2), (5, 7)])
def test_bilateral_and_waverage(shape):
    """Interior filtered, border kept; planes too small for an interior
    come back unchanged."""
    y = _plane(shape, 3)
    _same(jdn.bilateral_luma(jnp.asarray(y)),
          tdn.bilateral_luma(torch.from_numpy(y)))
    _same(jdn.waverage_chroma(jnp.asarray(y)),
          tdn.waverage_chroma(torch.from_numpy(y)))


@pytest.mark.parametrize("components", [7, 1, 6, 0])
def test_denoise_frame(components):
    y = _plane((64, 96), 4)
    u, v = _plane((32, 48), 5), _plane((32, 48), 6)
    j = jdn.denoise_frame(*(jnp.asarray(p) for p in (y, u, v)), components)
    t = tdn.denoise_frame(*(torch.from_numpy(p) for p in (y, u, v)),
                          components)
    for a, b in zip(j, t):
        _same(a, b)
    assert (t[0].numpy() != y).any() == bool(components & 1)


def _vaa_pair(seed, h=96, w=128):
    """VAA statistics of two frames, from both packages: static textured
    background with a foreground region of changed pixels that widens
    with the seed."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h, w))
    change = (rng.random((h, w)) < 0.2) * rng.integers(-40, 40, (h, w))
    change = change * (np.arange(w)[None, :] > w * seed / 6)
    cur = np.clip(base + change, 0, 255).astype(np.uint8)
    ref = base.astype(np.uint8)
    vj = jvaa.vaa_calc(jnp.asarray(cur), jnp.asarray(ref))
    vt = tvaa.vaa_calc(torch.from_numpy(cur), torch.from_numpy(ref))
    return vj, vt


@pytest.mark.parametrize("seed", range(6))
def test_background_division(seed):
    vj, vt = _vaa_pair(seed)
    a, b = jbg.background_division(vj), tbg.background_division(vt)
    assert a.keys() == b.keys()
    for k in a:
        _same(a[k], b[k])
    assert b["flag"].dtype == torch.int32


def test_background_division_branches():
    """Over the seeds, both refinement outcomes occur: foreground OUs
    turned background by erosion, and background OUs turned foreground
    by the dilation step."""
    moved_up = moved_down = 0
    for seed in range(6):
        vj, vt = _vaa_pair(seed)
        flag = tbg.background_division(vt)["flag"].numpy()
        sad = vt["sad8x8"].sum(-1).numpy()
        mad = vt["mad8x8"].amax(-1).numpy()
        sd = np.abs(vt["sd8x8"].sum(-1).numpy())
        dsd = (vt["sd8x8"].amax(-1) - vt["sd8x8"].amin(-1)).numpy()
        quiet = ((dsd <= sad >> 3) | (dsd <= 128)) & (sad < 1024)
        sd_ok = np.where(sad < 512, sd < (sad * 3) >> 2, (sd << 1) < sad)
        phase1 = (mad <= 63) & quiet & ((sad <= 128) | sd_ok)
        moved_up += int((flag.astype(bool) & ~phase1).sum())
        moved_down += int((~flag.astype(bool) & phase1).sum())
    assert moved_up > 0 and moved_down > 0


@pytest.mark.parametrize("gom", [4, 5, 48])
def test_complexity(gom):
    vj, vt = _vaa_pair(3)
    flag = tbg.background_division(vt)["flag"].numpy()
    vh = {k: v.numpy() for k, v in vt.items()}
    assert jcx.frame_complexity(vj) == tcx.frame_complexity(vh)
    assert jcx.frame_complexity(vj, flag) == tcx.frame_complexity(vh, flag)
    for bg in (None, flag):
        for a, b in zip(jcx.gom_complexity(vj, gom, bg),
                        tcx.gom_complexity(vh, gom, bg)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_reference_fault_gom_foreground_count():
    """Pins a fault of the reference (ROADMAP.md, queue C): the docstring
    of gom_complexity counts a foreground MB when "any of the MB's four
    8x8 SADs nonzero OR not background", but the code counts "not
    background" only. A background MB with nonzero SAD is not counted;
    the port does the same."""
    vj, vt = _vaa_pair(0)
    vh = {k: v.numpy() for k, v in vt.items()}
    mh, mw = vh["sad8x8"].shape[:2]
    bg = np.ones((mh, mw), np.int32)         # every MB background
    assert (vh["sad8x8"].sum(-1) > 0).all()  # yet every SAD is nonzero
    for mod, v in ((jcx, vj), (tcx, vh)):
        _sad, fg = mod.gom_complexity(v, mw, bg)
        assert (fg == 0).all()


@pytest.mark.parametrize("degrees", [0, 90, 180, 270, 360])
def test_rotate(degrees):
    y = _plane((48, 80), 7)
    _same(jrot.rotate_image(jnp.asarray(y), degrees),
          trot.rotate_image(torch.from_numpy(y), degrees))


def test_rotate_refuses_other_angles():
    for mod, p in ((jrot, jnp.zeros((4, 4))), (trot, torch.zeros(4, 4))):
        with pytest.raises(ValueError):
            mod.rotate_image(p, 45)
