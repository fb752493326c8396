"""Edit records and the pluggable edit-operator registry.

An :class:`Edit` is a value-semantics record addressed by stable op ``uid``s
and carrying its own RNG ``seed``, so a patch deterministically reproduces an
individual — the GEVO patch representation needed for crossover and for the
content-addressed fitness cache.

Operators are *pluggable*: an :class:`EditOp` subclass decorated with
``@register_edit("name")`` defines how edits of that kind are proposed
(random sampling against a program), applied (in-place mutation + repair),
described, and round-tripped through JSON docs.  The search loop, the
serializer, and the evaluator all dispatch through the registry, so adding an
operator is one class in one file — no search-core changes.

Built-in operators live in :mod:`repro_torch.core.edits.ops` and are registered on
package import.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..ir import Program


class EditError(Exception):
    """An edit cannot be proposed against or applied to the current program
    (e.g. its target op was removed by an earlier edit in the patch).
    Operators must raise this — never an arbitrary exception — on failure."""


@dataclass(frozen=True)
class Edit:
    """One mutation, dispatched to the registered operator named ``kind``.

    ``target_uid``/``dest_uid`` address operations by stable uid;
    ``seed`` drives every random choice inside apply (repair donors, slots),
    so re-applying an edit is deterministic; ``param`` is an operator-owned
    scalar (e.g. the ``const_perturb`` scale factor), 0.0 when unused."""

    kind: str
    target_uid: int
    dest_uid: int = -1
    seed: int = 0
    param: float = 0.0

    def __str__(self) -> str:
        return describe_edit(self)


class EditOp:
    """Base class / protocol for one edit operator.

    Subclass, implement ``propose`` and ``apply``, and decorate with
    ``@register_edit("name")``.  ``describe``/``to_doc``/``from_doc`` have
    generic defaults; override ``to_doc``/``from_doc`` only if the operator
    carries state beyond the :class:`Edit` fields.

    Contract (property-tested in ``tests/test_edits.py``):

    * ``propose(prog, rng)`` returns an Edit valid against ``prog``'s current
      uids, or raises :class:`EditError` (e.g. nothing to target);
    * ``apply(prog, edit, rng)`` mutates ``prog`` in place; it either
      succeeds leaving a type-correct program or raises :class:`EditError` —
      never any other exception; given the same program and the same
      ``(edit, rng-from-seed)`` it must produce the same result;
    * docs round-trip bit-identically: ``from_doc(to_doc(e)) == e``.

    ``universal`` marks operators applicable to arbitrary IR programs; set
    it False for representation-specific operators (e.g. ``attr_tweak``
    targets schedule-knob constants only) so the default
    ``OperatorWeights.all_registered()`` mix skips them — searches over the
    matching representation request them explicitly.
    """

    name: str = "?"
    universal: bool = True

    def propose(self, prog: Program, rng: np.random.Generator) -> Edit:
        raise NotImplementedError

    def apply(self, prog: Program, edit: Edit,
              rng: np.random.Generator) -> None:
        raise NotImplementedError

    def describe(self, edit: Edit) -> str:
        return f"{edit.kind}(uid={edit.target_uid})"

    def to_doc(self, edit: Edit) -> dict:
        doc = {"kind": edit.kind, "target_uid": edit.target_uid,
               "dest_uid": edit.dest_uid, "seed": edit.seed}
        # param omitted at its default keeps pre-registry patch docs (and
        # therefore persistent-cache keys of delete/copy patches) unchanged
        if edit.param != 0.0:
            doc["param"] = edit.param
        return doc

    def from_doc(self, doc: dict) -> Edit:
        return Edit(kind=doc["kind"], target_uid=doc["target_uid"],
                    dest_uid=doc.get("dest_uid", -1),
                    seed=doc.get("seed", 0),
                    param=doc.get("param", 0.0))


_REGISTRY: dict[str, EditOp] = {}


def register_edit(name: str):
    """Class decorator: instantiate the EditOp subclass and register it under
    ``name`` (the Edit.kind it handles).  Re-registering a name replaces the
    previous operator (deliberate: lets tests/plugins override built-ins)."""
    def deco(cls):
        cls.name = name
        _REGISTRY[name] = cls()
        return cls
    return deco


def get_edit_op(kind: str) -> EditOp:
    op = _REGISTRY.get(kind)
    if op is None:
        raise EditError(f"unknown edit kind {kind!r} "
                        f"(registered: {', '.join(sorted(_REGISTRY))})")
    return op


def registered_ops() -> tuple[str, ...]:
    """Names of every currently registered edit operator, sorted for
    determinism — the vocabulary :class:`OperatorWeights` mixes over and
    CLI ``--operators`` specs validate against.  Importing
    :mod:`repro_torch.core.edits` registers the six built-ins; ``@register_edit``
    classes imported afterwards appear here too."""
    return tuple(sorted(_REGISTRY))


def operator_modules() -> tuple[str, ...]:
    """Modules whose import (re)registers the current operators.  Worker
    processes import these before evaluating, so custom ``@register_edit``
    operators defined in importable modules work under ParallelEvaluator."""
    return tuple(sorted({type(op).__module__ for op in _REGISTRY.values()}))


def describe_edit(e: Edit) -> str:
    op = _REGISTRY.get(e.kind)
    return op.describe(e) if op else f"{e.kind}(uid={e.target_uid})"


def edit_to_doc(e: Edit) -> dict:
    """Encode through the registered operator — fail fast on an unknown
    kind rather than silently using the generic schema (a custom operator
    may carry state the generic doc would drop)."""
    return get_edit_op(e.kind).to_doc(e)


def edit_from_doc(d: dict) -> Edit:
    """Decode through the registered operator; raises EditError when the
    kind is unregistered (e.g. a checkpoint written with a plugin operator
    is loaded before the plugin module is imported)."""
    return get_edit_op(d["kind"]).from_doc(d)
