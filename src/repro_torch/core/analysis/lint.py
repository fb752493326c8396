"""The schedule linter: launch gates as per-knob diagnostics with fix hints.

``kernels/costs.py`` enforces its shared-memory/divisibility gates at
evaluation time by raising :class:`~repro_torch.core.fitness.InvalidVariant`
with a one-line message.  This module runs the *same* gates
(``schedule_gates`` — same check order, same message text, sourced from
:mod:`.diagnostics`) over any recorded genome — a registry artifact, a
front member, an autotune result — and turns each failure into a
structured :class:`~.diagnostics.Diagnostic` naming the knob at fault plus
a hint listing the choices that *would* launch on the shape.  The capacity
gate holds each kernel module's ``smem_bytes`` against the shared memory a
block may use on the H100 (232,448 bytes), where the reference holds its
working set against a TPU core's VMEM.  ``python -m
repro_torch.core.analysis lint`` is the CLI face; ``--strict`` exits
non-zero on any error, so an un-launchable schedule cannot sit in a
registry unnoticed.

Everything here imports ``repro_torch.kernels`` lazily so that
``kernels/costs.py`` → ``core.analysis.diagnostics`` never becomes an import
cycle (the package ``__init__`` deliberately does not import this module).
"""

from __future__ import annotations

from .diagnostics import (KNOB_INERT, SCHEDULE_DECODE, Diagnostic,
                          block_divisibility, smem_capacity)


def _kernel_tables():
    from ...kernels.workloads import _JOINT_SPACES, _SPACES, KERNELS, SHAPES
    return KERNELS, SHAPES, _SPACES, _JOINT_SPACES


def parse_shape_tag(tag: str) -> dict:
    """Invert :func:`repro_torch.core.deploy.registry.shape_tag` for dims dicts:
    ``"d-512_rows-512"`` -> ``{"d": 512, "rows": 512}``.  Non-dims tags
    (no ``key-int`` structure) come back empty."""
    dims: dict = {}
    for part in str(tag).split("_"):
        key, sep, val = part.rpartition("-")
        if not sep or not val.lstrip("-").isdigit():
            return {}
        dims[key] = int(val)
    return dims


def _failed_gates(kernel: str, genome: dict, shape: dict):
    from ...kernels.costs import schedule_gates
    return [g for g in schedule_gates(kernel, genome, **shape)
            if not bool(g[1])]


def _launchable_choices(kernel: str, genome: dict, shape: dict,
                        knob: str, choices) -> list:
    """The values of ``knob`` that pass every gate with the rest of the
    genome held fixed — the linter's fix hint."""
    good = []
    for c in choices:
        if not _failed_gates(kernel, dict(genome, **{knob: c}), shape):
            good.append(c)
    return good


def _fmt(values) -> str:
    return ", ".join(str(v) for v in values)


def lint_genome(kernel: str, genome: dict, *, shape: dict | None = None,
                choices: dict | None = None) -> list[Diagnostic]:
    """Diagnostics for one scalar genome of ``kernel`` on ``shape``
    (default: the kernel's evaluation shape).  ``choices`` maps knobs to
    their declared choice lists (default: the kernel's search space) and
    drives both well-formedness checks and the fix hints."""
    _, shapes, spaces, _ = _kernel_tables()
    if kernel not in spaces:
        return [Diagnostic(
            code=SCHEDULE_DECODE, severity="error", subject=kernel,
            message=f"{kernel}: unknown kernel — no schedule space to lint "
                    "against")]
    shape = dict(shapes[kernel], **(shape or {}))
    choices = dict(spaces[kernel]) if choices is None else dict(choices)
    diags: list[Diagnostic] = []
    for knob, opts in choices.items():
        if knob not in genome:
            diags.append(Diagnostic(
                code=SCHEDULE_DECODE, severity="error", subject=kernel,
                message=f"{kernel}: genome is missing knob {knob!r}",
                knob=knob, hint=f"declared choices: {_fmt(opts)}"))
        elif genome[knob] not in opts:
            diags.append(Diagnostic(
                code=SCHEDULE_DECODE, severity="error", subject=kernel,
                message=(f"{kernel}: {knob}={genome[knob]!r} is not among "
                         f"the declared choices"),
                knob=knob, hint=f"declared choices: {_fmt(opts)}"))
    if diags:
        return diags   # gates need a well-formed genome
    if genome.get("impl") == "ref":
        # the reference oracle launches nothing; every other knob is inert
        return [Diagnostic(
            code=KNOB_INERT, severity="info", subject=kernel,
            message=f"{kernel}: impl='ref' ignores {knob}", knob=knob)
            for knob in choices if knob != "impl"]
    for gate in _failed_gates(kernel, genome, shape):
        kind, _ok, *args = gate
        knobs = args[-1]
        hints = []
        for knob in knobs:
            good = _launchable_choices(kernel, genome, shape, knob,
                                       choices.get(knob, ()))
            if good:
                hints.append(f"launchable {knob} choices here: {_fmt(good)}")
        hint = "; ".join(hints) if hints else \
            "no single-knob change launches; set impl='ref'"
        if kind == "block":
            name, dim, block = args[0], int(args[1]), int(args[2])
            diags.append(block_divisibility(name, dim, block,
                                            knob=", ".join(knobs), hint=hint))
        else:   # the kernel's smem_bytes against what a block may use
            from ...kernels.costs import H100
            name, used = args[0], int(args[1])
            diags.append(smem_capacity(name, used, H100.smem_per_block,
                                       knob=", ".join(knobs), hint=hint))
    return diags


def split_joint_genome(genome: dict) -> dict[str, dict] | None:
    """A joint-space genome (``<kernel>.<knob>`` keys) split per kernel, or
    None when the genome is not joint-shaped."""
    if not genome or not all("." in k for k in genome):
        return None
    out: dict[str, dict] = {}
    for key, val in genome.items():
        kernel, _, knob = key.partition(".")
        out.setdefault(kernel, {})[knob] = val
    return out


def lint_any_genome(genome: dict, *, kernel: str | None = None,
                    shape: dict | None = None) -> list[Diagnostic]:
    """Lint a genome of unknown provenance: joint genomes split per kernel
    (linted against the joint choice lists, in kernel order); plain genomes
    need ``kernel``."""
    kernels, _, _, joint_spaces = _kernel_tables()
    sub = split_joint_genome(genome)
    if sub is not None and kernel is None:
        diags: list[Diagnostic] = []
        for k in kernels:
            if k in sub:
                diags.extend(lint_genome(k, sub[k], shape=shape,
                                         choices=joint_spaces[k]))
        for k in sub:
            if k not in kernels:
                diags.extend(lint_genome(k, sub[k], shape=shape))
        return diags
    if kernel is None:
        return [Diagnostic(
            code=SCHEDULE_DECODE, severity="error", subject="genome",
            message="genome: cannot infer which kernel this genome "
                    "schedules; pass --kernel")]
    return lint_genome(kernel, genome, shape=shape)


def lint_artifact(artifact) -> list[Diagnostic]:
    """Diagnostics for one registry :class:`~repro_torch.core.deploy.Artifact`.
    Only ``kind="kernel"`` artifacts have a lint model; other kinds come
    back clean (nothing checkable — not an error)."""
    if artifact.kind != "kernel":
        return []
    return lint_genome(artifact.name, artifact.genome,
                       shape=parse_shape_tag(artifact.shape) or None)


def lint_path(path: str, *, kernel: str | None = None
              ) -> list[tuple[str, list[Diagnostic]]]:
    """Lint every lintable record at ``path`` — a registry directory, one
    artifact manifest, or any front source :meth:`ParetoFront.load`
    understands.  Returns ``(subject, diagnostics)`` pairs; patch-only front
    members are skipped (lint is a schedule check — use ``explain`` with a
    workload for IR patches)."""
    import json
    import os

    from ..deploy import Artifact, ArtifactRegistry, ParetoFront

    if os.path.isdir(path) and not os.path.exists(
            os.path.join(path, "manifest.json")):
        arts = ArtifactRegistry(path).list()
        if not arts:
            raise ValueError(f"{path!r} holds no artifact manifests")
        return [(a.key(), lint_artifact(a)) for a in arts]
    if os.path.isfile(path):
        try:
            doc = json.load(open(path))
        except json.JSONDecodeError:
            doc = None
        if isinstance(doc, dict) and doc.get("kind") in (
                "kernel", "plan", "serve"):
            a = Artifact.from_doc(doc)
            return [(a.key(), lint_artifact(a))]
    front = ParetoFront.load(path)
    out = []
    for i, m in enumerate(front.members):
        if m.genome is None:
            continue
        subject = m.source or f"member[{i}]"
        out.append((f"{subject}#{i}",
                    lint_any_genome(m.genome, kernel=kernel)))
    if not out:
        raise ValueError(
            f"{path!r} has no genome-bearing members to lint (IR patch "
            "members: use `explain` with --workload)")
    return out
