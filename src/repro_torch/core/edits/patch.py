"""First-class Patch: an immutable, hashable sequence of edits.

A patch IS the genome (Section 4.2): it always applies against the original
program, each edit re-dispatched through the operator registry with its own
seeded RNG, so the same patch always reproduces the same variant.  ``Patch``
replaces the raw ``list[Edit]`` that used to flow through search, crossover,
evaluation, and serialization — it owns application, human description,
canonical hashing (the persistent fitness-cache address), and doc round-trip.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass
from typing import Iterable, Iterator

import numpy as np

from ..ir import Program
from .base import (Edit, describe_edit, edit_from_doc, edit_to_doc,
                   get_edit_op)
from .repair import retype


def apply_edit(prog: Program, edit: Edit) -> None:
    """Apply one edit in place (with repair), dispatched through the
    registry.  Raises EditError if the edit's anchors are gone or repair is
    impossible."""
    rng = np.random.default_rng(edit.seed)
    get_edit_op(edit.kind).apply(prog, edit, rng)
    retype(prog)


@dataclass(frozen=True)
class Patch:
    """An ordered tuple of edits — immutable and hashable, so patches can be
    dict keys, set members, and dataclass fields without copying."""

    edits: tuple[Edit, ...] = ()

    @staticmethod
    def coerce(p) -> "Patch":
        """Normalize a Patch | Edit | iterable-of-Edits to a Patch."""
        if isinstance(p, Patch):
            return p
        if isinstance(p, Edit):
            return Patch((p,))
        return Patch(tuple(p))

    # -- sequence algebra ---------------------------------------------------
    def __len__(self) -> int:
        return len(self.edits)

    def __iter__(self) -> Iterator[Edit]:
        return iter(self.edits)

    def __getitem__(self, i: int) -> Edit:
        return self.edits[i]

    def __add__(self, other) -> "Patch":
        return Patch(self.edits + Patch.coerce(other).edits)

    def append(self, e: Edit) -> "Patch":
        return Patch(self.edits + (e,))

    def without(self, i: int) -> "Patch":
        """The patch with edit ``i`` dropped (used by minimization)."""
        return Patch(self.edits[:i] + self.edits[i + 1:])

    def kinds(self) -> tuple[str, ...]:
        return tuple(e.kind for e in self.edits)

    # -- application --------------------------------------------------------
    def apply(self, original: Program) -> Program:
        """Reapply each edit in sequence to a clone of the original program
        (Section 4.2: patches always apply against the original)."""
        prog = original.clone()
        for e in self.edits:
            apply_edit(prog, e)
        prog.verify()
        return prog

    # -- description --------------------------------------------------------
    def describe(self) -> str:
        """Human-readable mutation analysis line (Sections 6.1/6.2 style)."""
        return "; ".join(describe_edit(e) for e in self.edits) or "<original>"

    # -- doc round-trip + canonical hashing ---------------------------------
    def to_doc(self) -> list[dict]:
        return [edit_to_doc(e) for e in self.edits]

    @staticmethod
    def from_doc(docs: Iterable[dict]) -> "Patch":
        return Patch(tuple(edit_from_doc(d) for d in docs))

    def key(self, fingerprint: str) -> str:
        """Content address of (program, patch): the persistent fitness-cache
        key.  Patches are deterministic (each edit carries its own repair
        seed), so the key fully identifies the variant program — and
        therefore its ``static`` fitness — across processes, runs, and
        machines."""
        blob = json.dumps({"program": fingerprint, "edits": self.to_doc()},
                          sort_keys=True, separators=(",", ":"))
        return hashlib.sha256(blob.encode()).hexdigest()


def apply_patch(original: Program, edits) -> Program:
    """Apply a patch (or any iterable of edits) to the original program."""
    return Patch.coerce(edits).apply(original)
