"""What a run may not load.

The benchmark measures ``torcheval_tpu_torch`` alone: the JAX package
beside it (``torcheval_tpu``) and JAX itself are never loaded by a run, and
the plain reference under ``evalbench/reference/`` imports nothing of the
program. Module names are compared by their top-level name (the part
before the first dot) whole: ``torcheval_tpu_torch`` begins with
``torcheval_tpu`` and is not it.
"""

from __future__ import annotations

import ast
import sys
from pathlib import Path
from typing import Iterable, List

BANNED = ("jax", "jaxlib", "flax", "torcheval_tpu")
PROGRAM = "torcheval_tpu_torch"
REFERENCE_DIR = Path(__file__).resolve().parent / "reference"


def _top(name: str) -> str:
    return name.split(".", 1)[0]


def banned_modules(modules: Iterable[str] = None) -> List[str]:
    """Loaded modules (``sys.modules`` by default) whose top-level name is
    banned."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in list(names) if _top(n) in BANNED)


def reference_imports(directory: Path = REFERENCE_DIR) -> List[str]:
    """``file: module`` for every import in the reference's sources whose
    top-level name is the program's or a banned one."""
    found = []
    for path in sorted(Path(directory).rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
                names = [node.module]
            else:
                continue
            found += [f"{path.name}: {n}" for n in names if _top(n) in BANNED + (PROGRAM,)]
    return found


def violations() -> List[str]:
    """Every breach of the rules above, as lines for standard error."""
    out = [f"loaded: {n}" for n in banned_modules()]
    out += [f"reference imports: {n}" for n in reference_imports()]
    return out
