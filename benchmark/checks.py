"""Import checks: the benchmark's process must not hold JAX or the JAX
package, and the plain reference must import nothing of the program.
Names are compared whole, by their top-level part (before the first
dot): the port's package name begins with the JAX package's.
"""

from __future__ import annotations

import ast
from pathlib import Path

FORBIDDEN_IN_RUN = ("jax", "jaxlib", "flax", "openh264_tpu")
FORBIDDEN_IN_REFERENCE = FORBIDDEN_IN_RUN + ("openh264_tpu_torch",)
REFERENCE_DIR = Path(__file__).resolve().parent / "reference"


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden_loaded(modules, forbidden=FORBIDDEN_IN_RUN) -> list[str]:
    """The names among `modules` (e.g. sys.modules) whose top-level name
    is one of `forbidden`."""
    return sorted(m for m in modules if top_level(m) in forbidden)


def imports_of(path: Path) -> list[str]:
    """Absolute module names a Python file imports."""
    tree = ast.parse(path.read_text(), str(path))
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            out.append(node.module)
    return out


def reference_violations(ref_dir: Path = REFERENCE_DIR) -> list[str]:
    """'file: module' for each import under the reference directory of
    a module whose top-level name is forbidden there."""
    return [f"{p.name}: {m}" for p in sorted(ref_dir.rglob("*.py"))
            for m in imports_of(p)
            if top_level(m) in FORBIDDEN_IN_REFERENCE]
