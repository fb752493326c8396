"""The artifact registry: fingerprinted, atomically-written winner manifests.

A search's job ends with a Pareto front; a *deployment's* job starts with a
registry of selected winners that serving paths can resolve at runtime — the
KernelFoundry pattern of keeping tuned kernel variants keyed by workload
shape.  An :class:`Artifact` is one selected genome (a kernel schedule, a
GEVO-Shard distribution plan, or a serving schedule) keyed by
``(kind, name, shape)``; the :class:`ArtifactRegistry` is a directory of
them, one canonical JSON manifest per artifact.

Manifests are **content-fingerprinted** (sha256 over the canonical body,
computed exactly like :func:`repro_torch.core.serialize.program_fingerprint`
hashes programs) and written atomically with sorted keys, so:

* ``export → resolve → export`` is byte-identical (round-trip tested),
* a corrupted or hand-edited manifest fails :meth:`resolve` loudly instead
  of silently serving the wrong schedule,
* two registries holding the same winner hold identical files (rsync-able,
  diff-able, content-addressed).
"""

from __future__ import annotations

import hashlib
import json
import os
import re
from dataclasses import dataclass, field

from ..serialize import _canon, atomic_write_json

MANIFEST_VERSION = 1

KINDS = ("kernel", "plan", "serve")


def _slug(s: str) -> str:
    """Filesystem-safe key component (deterministic, collision-averse for
    the names this repo generates: arch ids, kernel names, shape tags)."""
    return re.sub(r"[^A-Za-z0-9._-]+", "-", str(s)).strip("-") or "x"


def shape_tag(shape) -> str:
    """Canonical shape key: a dict of dims becomes ``k1-v1_k2-v2`` (sorted),
    a string passes through slugged.  ``resolve`` accepts either form."""
    if shape is None:
        raise ValueError("shape is required: a dims dict (e.g. SHAPES[k]) "
                         "or a tag string")
    if isinstance(shape, dict):
        return "_".join(f"{_slug(k)}-{_slug(v)}"
                        for k, v in sorted(shape.items()))
    return _slug(shape)


@dataclass(frozen=True)
class Artifact:
    """One deployable winner: a ``genome`` (JSON-able knob dict) selected for
    ``(kind, name, shape)``, with the fitness it was selected at and free-form
    ``meta`` provenance (source checkpoint, selection rule, fingerprints).

    ``kind`` scopes the namespace: ``"kernel"`` (kernel schedules,
    name = kernel), ``"plan"`` (GEVO-Shard distribution plans, name = arch),
    ``"serve"`` (serving-engine schedules, name = arch)."""

    kind: str
    name: str
    shape: str
    genome: dict
    fitness: tuple[float, float] | None = None
    meta: dict = field(default_factory=dict)

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown artifact kind {self.kind!r}; "
                             f"choose from {KINDS}")

    def key(self) -> str:
        return f"{self.kind}__{_slug(self.name)}__{shape_tag(self.shape)}"

    def body(self) -> dict:
        """The fingerprinted content (everything except the fingerprint)."""
        return _canon({
            "version": MANIFEST_VERSION,
            "kind": self.kind, "name": self.name,
            "shape": shape_tag(self.shape),
            "genome": self.genome,
            "fitness": list(self.fitness) if self.fitness else None,
            "meta": self.meta,
        })

    def fingerprint(self) -> str:
        return hashlib.sha256(
            json.dumps(self.body(), sort_keys=True,
                       separators=(",", ":")).encode()).hexdigest()

    def to_doc(self) -> dict:
        doc = self.body()
        doc["fingerprint"] = self.fingerprint()
        return doc

    @staticmethod
    def from_doc(doc: dict, *, verify: bool = True) -> "Artifact":
        a = Artifact(kind=doc["kind"], name=doc["name"], shape=doc["shape"],
                     genome=dict(doc["genome"]),
                     fitness=(tuple(doc["fitness"])
                              if doc.get("fitness") else None),
                     meta=dict(doc.get("meta", {})))
        if verify:
            got, want = a.fingerprint(), doc.get("fingerprint")
            if got != want:
                raise ValueError(
                    f"artifact fingerprint mismatch ({want and want[:12]}… "
                    f"recorded, {got[:12]}… recomputed) — manifest for "
                    f"{a.key()} is corrupt or was hand-edited")
        return a


class ArtifactRegistry:
    """A directory of artifact manifests, ``<root>/<kind>__<name>__<shape>
    .json`` each written atomically with sorted keys.

    ``export`` is idempotent and safe under concurrent exporters (last
    writer wins atomically; identical artifacts write identical bytes).
    ``resolve`` verifies the fingerprint on every read — serving never acts
    on a torn or tampered manifest."""

    def __init__(self, root: str):
        self.root = root

    def path_for(self, artifact: Artifact) -> str:
        return os.path.join(self.root, artifact.key() + ".json")

    # -- write --------------------------------------------------------------
    def export(self, artifact: Artifact) -> str:
        """Write (or atomically replace) the manifest; returns its path."""
        path = self.path_for(artifact)
        atomic_write_json(path, artifact.to_doc(), sort_keys=True, indent=1)
        return path

    # -- read ---------------------------------------------------------------
    def resolve(self, name: str, shape, *, kind: str | None = None
                ) -> Artifact | None:
        """Look up the winner for ``(name, shape)`` (``shape`` a tag string
        or dims dict).  ``kind=None`` searches all kinds and returns the
        unique match, raising if the key is ambiguous across kinds; returns
        ``None`` when nothing is registered."""
        kinds = (kind,) if kind else KINDS
        hits = []
        for k in kinds:
            p = os.path.join(
                self.root,
                f"{k}__{_slug(name)}__{shape_tag(shape)}.json")
            if os.path.exists(p):
                hits.append(Artifact.from_doc(json.load(open(p))))
        if len(hits) > 1:
            raise ValueError(
                f"ambiguous artifact {name!r}/{shape_tag(shape)}: registered "
                f"under kinds {[h.kind for h in hits]}; pass kind=")
        return hits[0] if hits else None

    def list(self, *, kind: str | None = None) -> list[Artifact]:
        """All registered artifacts (verified), sorted by key."""
        if not os.path.isdir(self.root):
            return []
        out = []
        for fn in sorted(os.listdir(self.root)):
            if not fn.endswith(".json") or "__" not in fn:
                continue
            if kind and not fn.startswith(kind + "__"):
                continue
            out.append(Artifact.from_doc(
                json.load(open(os.path.join(self.root, fn)))))
        return out
