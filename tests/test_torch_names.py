"""Every public name of the reference has its counterpart in the port.

For each ``src/repro/**/*.py``, the file of the same path under
``src/repro_torch/`` must exist, and the public top-level names the
reference binds (functions, classes, assignments, and a package's
``__all__``) that the port does not bind (its definitions, imports or
``__all__``) must be exactly the deliberate differences listed here, each
with its reason (ROADMAP.md, section 3).  Both trees are read as source
(``ast``): nothing is imported, so no JAX.
"""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parents[1] / "src"
REF, PORT = SRC / "repro", SRC / "repro_torch"

_TPU_CAPACITY = ("a TPU's VMEM capacity; the port's capacity gate is the "
                 "GPU's shared memory per block (smem_capacity)")
_TPU_COST = ("a TPU cost-model constant; the port's H100 record "
             "(DeviceModel H100) carries the card's own terms")
_HLO = ("the HLO-text parser; torch gives no HLO, so the port counts costs "
        "over a dispatch trace (CostCounter)")
_PALLAS = ("the Pallas entry point; the port's counterparts are the CUDA "
           "kernel's *_launch and the wrapper in kernels/*/ops.py")

DELIBERATE: dict[str, dict[str, str]] = {
    "core/analysis/__init__.py": {"vmem_capacity": _TPU_CAPACITY},
    "core/analysis/diagnostics.py": {"VMEM_CAPACITY": _TPU_CAPACITY,
                                     "vmem_capacity": _TPU_CAPACITY},
    "kernels/costs.py": {"GRID_STEP_S": _TPU_COST, "SEQ_STEP_S": _TPU_COST,
                         "VMEM_BYTES": _TPU_COST, "VPU_FLOPS": _TPU_COST},
    "kernels/flash_attention/flash_attention.py": {
        "flash_attention_fwd": _PALLAS},
    "kernels/mamba_scan/mamba_scan.py": {"mamba_scan_fwd": _PALLAS},
    "kernels/rmsnorm/rmsnorm.py": {"rmsnorm_fwd": _PALLAS},
    "launch/hlo_analysis.py": {"Computation": _HLO, "Op": _HLO,
                               "VMEM_BUDGET": _HLO, "parse_hlo": _HLO},
    "models/attention.py": {
        "blockwise_sdpa": "every full-sequence attention runs on the flash "
                          "kernel, for both attn_impl values"},
}

FILES = sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py"))


def public_names(path: Path, *, imports: bool) -> set[str]:
    """The public names ``path`` binds at its top level: definitions and
    assignments, the entries of ``__all__``, and with ``imports`` the
    names its imports bind."""
    out: set[str] = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for target in targets:
                out |= {n.id for n in ast.walk(target)
                        if isinstance(n, ast.Name)}
            if any(isinstance(t, ast.Name) and t.id == "__all__"
                   for t in targets):
                out |= {e.value for e in node.value.elts}
        elif imports and isinstance(node, (ast.Import, ast.ImportFrom)):
            out |= {(a.asname or a.name).split(".")[0] for a in node.names}
    return {n for n in out if not n.startswith("_")}


def test_every_reference_file_is_walked():
    assert len(FILES) > 50 and "core/deploy/router.py" in FILES
    assert set(DELIBERATE) <= set(FILES)


@pytest.mark.parametrize("rel", FILES)
def test_port_binds_every_public_name(rel):
    port = PORT / rel
    assert port.is_file(), f"no counterpart of src/repro/{rel}"
    missing = (public_names(REF / rel, imports=False)
               - public_names(port, imports=True))
    assert missing == set(DELIBERATE.get(rel, {})), sorted(missing)
