"""What the benchmark may not load.

The benchmark measures the port (``repro_torch``) only: no module of
``jax``, ``jaxlib``, ``flax`` or the JAX package ``repro`` may be loaded in
the process that prints a result, and the plain references may import
nothing of the port either.  Names are compared by their top-level part,
the text before the first dot, as a whole: ``repro_torch`` begins with
``repro`` and is a different name.
"""

from __future__ import annotations

import ast
import sys
from pathlib import Path

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# the reference must not use the program it judges
REFERENCE_FORBIDDEN = FORBIDDEN + ("repro_torch",)


def top(name: str) -> str:
    return name.split(".", 1)[0]


def loaded(forbidden=FORBIDDEN, modules=None) -> list[str]:
    """The forbidden top-level names among ``modules`` (``sys.modules``)."""
    names = {top(m) for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(forbidden))


def imported_by(path: Path) -> set[str]:
    """Top-level names of every absolute import in the source ``path``."""
    out = set()
    for node in ast.walk(ast.parse(Path(path).read_text())):
        if isinstance(node, ast.Import):
            out |= {top(a.name) for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(top(node.module))
    return out


def reference_violations(folder: Path) -> dict[str, list[str]]:
    """Each file of the references' ``folder`` that imports a forbidden
    name, with those names."""
    out = {}
    for path in sorted(Path(folder).glob("*.py")):
        bad = sorted(imported_by(path) & set(REFERENCE_FORBIDDEN))
        if bad:
            out[path.name] = bad
    return out
