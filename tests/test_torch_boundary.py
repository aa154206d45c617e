"""The port's package boundary: openh264_tpu_torch imports neither JAX
nor anything of the JAX package openh264_tpu, and its entry points run
on the GPU unless the caller asks for the CPU."""

import ast
import json
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import openh264_tpu_torch
from openh264_tpu_torch.device import resolve_device
from openh264_tpu_torch.encoder.config import EncoderConfig
from openh264_tpu_torch.encoder.session_device import DeviceSessionEncoder

PKG = Path(openh264_tpu_torch.__file__).resolve().parent
REPO = PKG.parent


def _is_forbidden(name: str) -> bool:
    # exact match or a submodule: the port's own name starts with
    # "openh264_tpu" too
    return any(name == m or name.startswith(m + ".")
               for m in ("jax", "jaxlib", "openh264_tpu"))


def test_forbidden_matches_exactly():
    assert _is_forbidden("openh264_tpu")
    assert _is_forbidden("openh264_tpu.encoder.core_jax")
    assert _is_forbidden("jax.numpy")
    assert not _is_forbidden("openh264_tpu_torch")
    assert not _is_forbidden("openh264_tpu_torch.encoder")
    assert not _is_forbidden("jaxtyping")


def test_import_leaves_jax_out():
    """Importing every module of the port, in a fresh interpreter, loads
    neither jax nor any openh264_tpu module."""
    mods = ["openh264_tpu_torch"] + [
        m.name for m in pkgutil.walk_packages([str(PKG)],
                                              "openh264_tpu_torch.")]
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    loaded = json.loads(res.stdout.strip().splitlines()[-1])
    assert "openh264_tpu_torch.encoder.session_device" in loaded
    bad = [m for m in loaded if _is_forbidden(m)]
    assert not bad, bad


def test_sources_import_no_jax():
    """No source file of the port (nor chip_smoke.py) imports jax or the
    JAX package, at any depth of the file."""
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for n in names:
                assert not _is_forbidden(n), f"{f}: imports {n}"


def test_default_device_raises_without_gpu():
    """The default device is CUDA; without a GPU the entry point raises
    instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    cfg = EncoderConfig(width=96, height=80)
    with pytest.raises(RuntimeError):
        DeviceSessionEncoder(cfg)
    with pytest.raises(RuntimeError):
        resolve_device()
    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(ValueError):
        resolve_device("meta")


def _imports():
    """(file relative to the package, imported module) for every import
    of the port's own modules, at any depth of each file, as dotted
    names inside the package ("decoder.cbind", "_build"); `from x import
    y` gives both x and x.y, since y may be a module."""
    out = []
    for f in sorted(PKG.rglob("*.py")):
        rel = f.relative_to(PKG)
        pkg = list(rel.parent.parts)
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                if node.level:
                    base = pkg[:len(pkg) + 1 - node.level]
                    mod = ".".join(base + [node.module or ""]).strip(".")
                    mod = "openh264_tpu_torch" + ("." + mod if mod else "")
                else:
                    mod = node.module or ""
                mods = [mod] + [f"{mod}.{a.name}" for a in node.names]
            else:
                continue
            for m in mods:
                if m.startswith("openh264_tpu_torch."):
                    out.append((rel, m[len("openh264_tpu_torch."):]))
    assert len(out) > 100
    return out


def _unit(name: str) -> str:
    """A subpackage or root module of the port: "decoder", "_build"."""
    return name.split(".")[0].removesuffix(".py")


def test_layers_import_no_cycle():
    """No two subpackages or root modules import each other, except the
    encoder and the decoder, and those only through the decoder's use
    of the host deblock (decoder/decoder.py -> encoder.deblock_host,
    ROADMAP G6: it moves with a benchmark change, since
    benchmark/profiling.py imports encoder.deblock_cuda)."""
    edges = {}
    for rel, mod in _imports():
        a, b = _unit(rel.parts[0]), _unit(mod)
        if a != b:
            edges.setdefault((a, b), set()).add(f"{rel} -> {mod}")
    cycles = {(a, b) for a, b in edges if (b, a) in edges and a < b}
    assert cycles <= {("decoder", "encoder")}, \
        {c: (edges[c], edges[c[::-1]]) for c in cycles}
    assert edges[("decoder", "encoder")] == \
        {"decoder/decoder.py -> encoder.deblock_host",
         "decoder/decoder.py -> encoder.deblock_host.deblock_frame"}


def test_build_load_called_from_build_and_deblock_only():
    """The host C loads through _build.bind and its one table of
    signatures (_build.SIGNATURES); only the CUDA kernel's launcher
    calls _build.load."""
    callers = set()
    for f in sorted(PKG.rglob("*.py")):
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            if isinstance(node, ast.Attribute) and node.attr == "load" and \
                    isinstance(node.value, ast.Name) and \
                    node.value.id == "_build":
                callers.add(f.relative_to(PKG).as_posix())
            if isinstance(node, ast.ImportFrom) and \
                    (node.module or "").endswith("_build"):
                assert "load" not in [a.name for a in node.names], f
    assert callers == {"encoder/deblock_cuda.py"}


def test_decoder_c_bindings_stay_in_the_decoder():
    """Only decoder/ imports the decoder's host-C bindings."""
    outside = [(rel, mod) for rel, mod in _imports()
               if mod.startswith("decoder.cbind")
               and rel.parts[0] != "decoder"]
    assert not outside, outside


@pytest.mark.parametrize("name", ["parse_cavlc", "parse_cabac"])
def test_header_edit_rebuilds_its_parsers(name, tmp_path, monkeypatch):
    """A library's build is keyed on the csrc headers its source
    includes, so an edited csrc/mb_pred.h never loads a stale parser;
    a library that does not include it keeps its key."""
    from openh264_tpu_torch import _build
    for f in (f"{name}.c", "mb_pred.h", "cabac_residual.c"):
        (tmp_path / f).write_bytes((_build.CSRC / f).read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = {n: _build._target(n) for n in (name, "cabac_residual")}
    with open(tmp_path / "mb_pred.h", "a") as h:
        h.write("/* edited */\n")
    assert _build._target(name) != before[name]
    assert _build._target("cabac_residual") == before["cabac_residual"]
