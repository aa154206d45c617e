"""Port parity: the host encoder's pre-processing against the JAX
package's: VAA statistics, the adaptive-quant map, scroll detection and
scene-change detection, on the same planes (numpy, from a seed). Every
array and number must be equal; the port runs on the CPU.
"""

import numpy as np
import pytest
import torch

from openh264_tpu.processing import adaptivequant as jaq
from openh264_tpu.processing import scenechange as jsc
from openh264_tpu.processing import scroll as jscroll
from openh264_tpu.processing import vaa as jvaa
from openh264_tpu_torch.processing import adaptivequant as taq
from openh264_tpu_torch.processing import scenechange as tsc
from openh264_tpu_torch.processing import scroll as tscroll
from openh264_tpu_torch.processing import vaa as tvaa

H, W = 64, 96


def _pair(seed, motion=2, noise=3):
    """A textured plane and the same plane moved by `motion` px with
    noise."""
    rng = np.random.default_rng(seed)
    big = rng.integers(0, 256, (H + 16, W + 16)).astype(np.int32)
    yy, xx = np.mgrid[0:H + 16, 0:W + 16]
    big = (big // 2 + 50 * np.sin(xx / 6.0) + 60).clip(0, 255)
    a = big[:H, :W]
    b = big[motion:motion + H, motion:motion + W] + rng.integers(
        -noise, noise + 1, (H, W))
    return a.clip(0, 255).astype(np.uint8), b.clip(0, 255).astype(np.uint8)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("seed,motion", [(0, 0), (1, 2), (2, 7)])
def test_vaa_calc(seed, motion):
    cur, ref = _pair(seed, motion)
    want = jvaa.vaa_calc(cur, ref)
    got = tvaa.vaa_calc(_t(cur), _t(ref))
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.int32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


@pytest.mark.parametrize("seed,mode", [(0, 0), (3, 0), (4, 1)])
def test_adaptive_quant_map(seed, mode):
    """The map from the port's VAA equals the JAX package's from its own
    VAA, in quality and bitrate mode."""
    cur, ref = _pair(seed, motion=seed % 5)
    cur[:16, :32] = 100                          # flat MBs: low texture
    want = jaq.adaptive_quant_map(jvaa.vaa_calc(cur, ref), mode)
    vaa = {k: v.numpy() for k, v in tvaa.vaa_calc(_t(cur), _t(ref)).items()}
    got = taq.adaptive_quant_map(vaa, mode)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert got.any()


def _scroll_pair(step, seed=5, flat=False):
    rng = np.random.default_rng(seed)
    page = rng.integers(0, 256, (2 * H, W)).astype(np.uint8)
    if flat:
        page[:] = 77
    return page[step:step + H], page[:H]


@pytest.mark.parametrize("case,step", [("scrolled", 9), ("scrolled", -5),
                                       ("flat", 4), ("unscrolled", 0),
                                       ("noise", 3)])
def test_detect_scroll(case, step):
    """A scroll down or up, a flat window (no evidence), no scroll at
    all, and a scroll spoilt by noise (no exact match)."""
    if step < 0:
        ref, cur = _scroll_pair(-step)
    else:
        cur, ref = _scroll_pair(step, flat=case == "flat")
    if case == "noise":
        cur = (cur.astype(np.int32) + np.random.default_rng(6).integers(
            -1, 2, cur.shape)).clip(0, 255).astype(np.uint8)
    want = jscroll.detect_scroll(cur, ref)
    got = tscroll.detect_scroll(_t(cur), _t(ref))
    assert got == (bool(want[0]), int(want[1]))
    if case == "scrolled":
        assert got == (True, step)
    else:
        assert got[0] == (case == "unscrolled")


def _check_scene(cur, ref, **kw):
    want_idc, want = jsc.detect_scene_change(cur, ref, **kw)
    got_idc, got = tsc.detect_scene_change(_t(cur), _t(ref), **kw)
    assert got_idc == want_idc
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], int):
            assert got[k] == want[k], k
        else:
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]), err_msg=k)
    return got_idc, got


@pytest.mark.parametrize("seed,motion,noise", [(7, 0, 1), (8, 3, 2),
                                               (9, 9, 40)])
def test_scene_change_camera(seed, motion, noise):
    _check_scene(*_pair(seed, motion, noise))


def test_scene_change_camera_new_scene():
    rng = np.random.default_rng(10)
    a = rng.integers(0, 256, (H, W)).astype(np.uint8)
    b = rng.integers(0, 256, (H, W)).astype(np.uint8)
    idc, _ = _check_scene(a, b)
    assert idc == tsc.SCENE_CHANGED_LARGE


@pytest.mark.parametrize("scroll_mv", [None, (0, 0), (0, 8), (3, -8)])
def test_scene_change_screen(scroll_mv):
    """Screen content: collocated-static and scrolled-static blocks, with
    and without a scroll vector (the shifted place of some blocks leaves
    the picture)."""
    cur, ref = _scroll_pair(8, seed=11)
    cur = cur.copy()
    cur[:, 48:] = ref[:, 48:]                # a static half
    _, res = _check_scene(cur, ref, screen=True, scroll_mv=scroll_mv)
    if scroll_mv == (0, 8):
        assert (res["static_block_idc"] == tsc.SCROLLED_STATIC).any()
