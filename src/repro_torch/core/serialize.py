"""Persistence for GEVO-ML artifacts: IR programs, patch genomes, and the
canonical forms the evaluation engine hashes.

A production deployment needs to ship the winning variant: searches run for
days and their outputs (the Pareto front of patches + the original program)
must survive restarts and be re-appliable elsewhere.  Programs serialize to
JSON with constants in an npz sidecar (weights are large); patches are pure
JSON (they carry their own RNG seeds, so re-application is deterministic).

This module also defines the **canonical form** used by the persistent
fitness cache (`core/evaluator.py`): a patch applied to a program is fully
determined by (program structure + constants, edit list), so
``patch_key(fingerprint, edits)`` is a content address for the variant's
fitness.  Search checkpoints (`core/search.py`) reuse the same edit docs plus
a JSON-able NumPy ``Generator`` state.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np

from .edits import Edit, Patch
from .edits import edit_from_doc as _registry_edit_from_doc
from .edits import edit_to_doc as _registry_edit_to_doc
from .ir import Operation, Program, TensorType

# --------------------------------------------------------------------------
# Canonical program / patch documents
# --------------------------------------------------------------------------


def program_doc(program: Program) -> tuple[dict, dict[str, np.ndarray]]:
    """The program as a JSON-able doc + ndarray constants keyed for an npz
    sidecar.  This is the canonical serialized form: ``save_program`` writes
    it and ``program_fingerprint`` hashes it."""
    consts: dict[str, np.ndarray] = {}
    ops = []
    for i, op in enumerate(program.ops):
        attrs = {}
        for k, v in op.attrs.items():
            if isinstance(v, np.ndarray):
                key = f"c{i}_{k}"
                consts[key] = v
                attrs[k] = {"__npz__": key}
            else:
                attrs[k] = v
        ops.append({"opcode": op.opcode, "operands": list(op.operands),
                    "attrs": attrs, "result": op.result,
                    "type": [list(op.type.shape), op.type.dtype],
                    "uid": op.uid})
    doc = {
        "name": program.name,
        "inputs": [[n, v, [list(t.shape), t.dtype]]
                   for n, v, t in program.inputs],
        "ops": ops,
        "outputs": list(program.outputs),
        "next_value": program._next_value,
        "next_uid": program._next_uid,
    }
    return doc, consts


def _canon(v):
    """JSON-able canonical value: tuples -> lists, numpy scalars -> python."""
    if isinstance(v, dict):
        return {k: _canon(x) for k, x in v.items()}
    if isinstance(v, (tuple, list)):
        return [_canon(x) for x in v]
    if isinstance(v, np.generic):
        return v.item()
    return v


def program_fingerprint(program: Program) -> str:
    """Content hash of a program (structure + constant payloads).

    Identical programs — including identical baked-in weights — hash the
    same across processes and across save/load round-trips, so fitness cache
    entries keyed on it are shareable between runs."""
    doc, consts = program_doc(program)
    h = hashlib.sha256()
    h.update(json.dumps(_canon(doc), sort_keys=True,
                        separators=(",", ":")).encode())
    for k in sorted(consts):
        a = np.ascontiguousarray(consts[k])
        h.update(k.encode())
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def edit_doc(e: Edit) -> dict:
    """JSON doc for one edit, delegated to its registered operator (so a
    custom operator controls its own wire format)."""
    return _registry_edit_to_doc(e)


def edit_from_doc(d: dict) -> Edit:
    return _registry_edit_from_doc(d)


def patch_doc(patch) -> list[dict]:
    return Patch.coerce(patch).to_doc()


def patch_from_doc(docs) -> Patch:
    return Patch.from_doc(docs)


def patch_key(fingerprint: str, patch) -> str:
    """Content address of (program, patch): the persistent fitness cache key.

    Patches are deterministic (each edit carries its own repair seed), so the
    key fully identifies the variant program — and therefore its ``static``
    fitness — across processes, runs, and machines.  Delete/copy-only patch
    docs are byte-identical to the pre-registry format, so persistent caches
    written before the operator registry existed remain valid."""
    return Patch.coerce(patch).key(fingerprint)


# --------------------------------------------------------------------------
# Atomic JSON documents (checkpoints, island manifests)
# --------------------------------------------------------------------------


def atomic_write_json(path: str, doc: dict, *, sort_keys: bool = False,
                      indent: int | None = None) -> None:
    """Write a JSON doc so readers never observe a torn file: serialize to a
    sibling tmp file, then ``os.replace`` (atomic on POSIX).  Search
    checkpoints, island manifests, and deployment artifacts all go through
    this — a crash mid-write leaves the previous snapshot intact.

    ``sort_keys=True`` makes the bytes a canonical function of the doc's
    content (the artifact registry requires byte-identical re-exports);
    ``indent`` trades compactness for a human-auditable file.

    The tmp file is unique per writer (not ``path + ".tmp"``): concurrent
    exporters of the same key must each replace their own snapshot, never
    race on a shared sibling — last writer wins atomically."""
    import tempfile
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d or ".",
                               prefix=os.path.basename(path) + ".",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(doc, f, sort_keys=sort_keys, indent=indent)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


# --------------------------------------------------------------------------
# RNG state (for search checkpoint/resume)
# --------------------------------------------------------------------------


def rng_state_doc(rng: np.random.Generator) -> dict:
    """JSON-able snapshot of a NumPy Generator's bit-generator state."""
    return json.loads(json.dumps(rng.bit_generator.state))


def rng_from_state(state: dict) -> np.random.Generator:
    bg = getattr(np.random, state["bit_generator"])()
    bg.state = state
    return np.random.Generator(bg)


# --------------------------------------------------------------------------
# Programs
# --------------------------------------------------------------------------


def save_program(program: Program, path: str) -> None:
    """Write <path>.json (structure) + <path>.npz (constant payloads)."""
    doc, consts = program_doc(program)
    with open(path + ".json", "w") as f:
        json.dump(doc, f)
    np.savez(path + ".npz", **consts)


def _fix(v):
    """JSON round-trip turns tuples into lists; attrs must be hashable-ish."""
    if isinstance(v, list):
        return tuple(_fix(x) for x in v)
    return v


def load_program(path: str) -> Program:
    doc = json.load(open(path + ".json"))
    consts = np.load(path + ".npz") if os.path.exists(path + ".npz") else {}
    prog = Program(name=doc["name"])
    prog.inputs = [(n, v, TensorType(tuple(t[0]), t[1]))
                   for n, v, t in doc["inputs"]]
    for o in doc["ops"]:
        attrs = {}
        for k, v in o["attrs"].items():
            if isinstance(v, dict) and "__npz__" in v:
                attrs[k] = consts[v["__npz__"]]
            else:
                attrs[k] = _fix(v)
        prog.ops.append(Operation(
            opcode=o["opcode"], operands=list(o["operands"]), attrs=attrs,
            result=o["result"],
            type=TensorType(tuple(o["type"][0]), o["type"][1]),
            uid=o["uid"]))
    prog.outputs = list(doc["outputs"])
    prog._next_value = doc["next_value"]
    prog._next_uid = doc["next_uid"]
    prog.verify()
    return prog


# --------------------------------------------------------------------------
# Patches
# --------------------------------------------------------------------------


def save_patches(patches, path: str,
                 fitnesses: list[tuple] | None = None) -> None:
    doc = [{"edits": patch_doc(patch),
            "fitness": list(fitnesses[i]) if fitnesses else None}
           for i, patch in enumerate(patches)]
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)


def load_patches(path: str) -> list[Patch]:
    doc = json.load(open(path))
    return [patch_from_doc(p["edits"]) for p in doc]
