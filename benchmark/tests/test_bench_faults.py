"""`correct` comes out true for the program as it is and false for each
fault planted under the timed path and for each cell's control, on the
CPU at 128x96 (the look for a card skipped)."""

from __future__ import annotations

import pytest

from benchmark.tests.conftest import cell_result

SEED = 2**31 + 12345


@pytest.mark.parametrize("cell", ["tiny.decode", "tiny.encode",
                                  "tiny.encode_api"])
def test_sound_run_is_correct(tiny_root, cell):
    r = cell_result(tiny_root, cell, SEED, 2.0)
    assert r["correct"], r["checks"]
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("cell,fault", [
    ("tiny.decode", "decode_stale"), ("tiny.decode", "decode_altered"),
    ("tiny.encode", "encode_stale"), ("tiny.encode", "encode_altered"),
    ("tiny.encode_api", "api_stale"), ("tiny.encode_api", "api_altered")])
def test_planted_fault_is_not_correct(tiny_root, cell, fault):
    r = cell_result(tiny_root, cell, SEED, 2.0, fault=fault)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("cell,number", [
    ("tiny.decode", "max_abs_diff"), ("tiny.encode", "recon_max_abs_diff"),
    ("tiny.encode_api", "recon_max_abs_diff")])
def test_control_is_not_correct(tiny_root, cell, number):
    r = cell_result(tiny_root, cell, SEED + 1, 2.0, control=True)
    assert not r["correct"], r["checks"]
    c = r["checks"][number]
    assert c["value"] > c["limit"]


IDR, P = b"\x00\x00\x00\x01\x65\x88\x80", b"\x00\x00\x00\x01\x41\x9a\x00"


def test_decode_check_chains_from_an_idr_on_its_own():
    from types import SimpleNamespace
    from benchmark import run
    entry = run.load_module(run.HERE / "entries" / "decode_feed.py")
    fed = [(0, IDR if i % 8 == 0 else P + bytes([i])) for i in range(30)]
    cell = SimpleNamespace(seed=SEED, control=False, limits={
        "chain_pictures": 5, "sample_pictures": 6})
    s = SimpleNamespace(cell=cell, fed=fed, warm=3, param_sets=b"",
                        pictures=[f"pic{i}" for i in range(29)])
    chain, *steps = entry.jobs(s)
    _, aus, ref, gots = chain
    g = int(gots[0][3:])
    assert ref is None and aus[0] == IDR and len(aus) == 5
    assert g + 5 > s.warm and gots == [f"pic{i}" for i in range(g, g + 5)]
    assert len(steps) == 6
    for _, (au,), ref, (got,) in steps:
        i = int(got[3:])
        assert au == fed[i][1] != IDR and ref == f"pic{i - 1}"
        assert s.warm <= i and not g <= i < g + 5


def test_encode_check_runs_from_the_last_idr_to_the_reconstruction():
    from benchmark import compare
    out = [IDR if i % 8 == 0 else P for i in range(21)] + [b""]
    assert compare.last_run(out) == (16, 20)
    assert compare.last_run(out[:17]) == (16, 16)
    assert compare.last_run(out[:16] + [b""]) == (8, 15)
