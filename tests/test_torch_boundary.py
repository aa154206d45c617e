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
