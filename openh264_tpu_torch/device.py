"""Explicit device resolution for the port's entry points.

Every entry point takes a `device` argument whose default is "cuda".
Asking for CUDA on a machine without a GPU raises: the port never
drops to the CPU on its own. Callers that want the CPU (the parity
tests) pass device="cpu".
"""

from __future__ import annotations

import functools

import torch

DEFAULT_DEVICE = "cuda"


def constant_cache(tables: dict):
    """Returns get(name, device) -> the numpy constant tables[name] as a
    tensor on `device`, uploaded once per device and never mutated."""
    @functools.lru_cache(maxsize=None)
    def get(name: str, device: torch.device) -> torch.Tensor:
        return torch.as_tensor(tables[name], device=device)
    return get


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev
