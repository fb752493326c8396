"""CLI for the static-analysis layer:

    python -m repro_torch.core.analysis lint PATH [--kernel K] [--strict]
    python -m repro_torch.core.analysis explain PATH [--member N]
                                                 [--workload W] [--device D]
    python -m repro_torch.core.analysis diff A B [--member-a N] [--member-b M]
                                                 [--workload W] [--device D]

``PATH`` is anything the deploy layer can read: a registry directory or
artifact manifest, a front export, a GevoML checkpoint, an autotune result,
or an island-run directory.

* ``lint``    — run the schedule linter over every genome-bearing record;
  ``--strict`` exits non-zero on any error diagnostic (the CI gate).
* ``explain`` — per-member report: schedule genomes knob-by-knob against the
  shipped baselines with diagnostics; IR patch members (``--workload`` names
  the workload they were searched on) get the patch-effect classifier's
  verdict, dead-op counts, canonical fingerprints, and static-time deltas.
  The workload is built on the GPU unless ``--device`` names another
  device (nothing is executed, but its data lives there).
* ``diff``    — compare two members by canonical form: knob deltas for
  genomes, normal-form fingerprint (+ opcode histogram delta) for patches.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

WORKLOAD_BUILDERS = {
    "twofc": "repro_torch.workloads:build_twofc_training_workload",
    "mobilenet": "repro_torch.workloads:build_mobilenet_prediction_workload",
    "tinyformer": "repro_torch.workloads:build_tinyformer_prediction_workload",
    "rmsnorm": "repro_torch.kernels.workloads:build_kernel_workload",
    "flash_attention": "repro_torch.kernels.workloads:build_kernel_workload",
    "mamba_scan": "repro_torch.kernels.workloads:build_kernel_workload",
    "joint": "repro_torch.kernels.workloads:build_joint_kernel_workload",
}


def _build_workload(name: str, device=None):
    import importlib
    if name not in WORKLOAD_BUILDERS:
        raise SystemExit(f"unknown workload {name!r}; choose from "
                         f"{sorted(WORKLOAD_BUILDERS)}")
    mod, _, attr = WORKLOAD_BUILDERS[name].partition(":")
    fn = getattr(importlib.import_module(mod), attr)
    if name in ("rmsnorm", "flash_attention", "mamba_scan"):
        return fn(name, device=device)
    return fn(device=device)


# -- member loading (fronts, checkpoints, artifacts — one shape) -------------

def _load_members(path: str) -> list:
    """Everything at ``path`` as FrontMembers (artifacts become
    genome-bearing members; fitness/patch/genome carried through)."""
    from ..deploy import ArtifactRegistry, FrontMember, ParetoFront

    def of_artifact(a):
        return FrontMember(fitness=a.fitness or (float("nan"),) * 2,
                           genome=dict(a.genome), source=a.key())

    if os.path.isdir(path) and not os.path.exists(
            os.path.join(path, "manifest.json")):
        arts = ArtifactRegistry(path).list()
        if arts:
            return [of_artifact(a) for a in arts]
    if os.path.isfile(path):
        try:
            doc = json.load(open(path))
        except json.JSONDecodeError:
            doc = None
        if isinstance(doc, dict) and doc.get("kind") in (
                "kernel", "plan", "serve"):
            from ..deploy import Artifact
            return [of_artifact(Artifact.from_doc(doc))]
    return list(ParetoFront.load(path).members)


def _pick(members: list, n: int | None, what: str):
    if n is None:
        return list(enumerate(members))
    if not 0 <= n < len(members):
        raise SystemExit(f"{what} {n} out of range (0..{len(members) - 1})")
    return [(n, members[n])]


# -- lint --------------------------------------------------------------------

def cmd_lint(args) -> int:
    from .lint import lint_path
    try:
        results = lint_path(args.path, kernel=args.kernel)
    except (ValueError, FileNotFoundError) as e:
        raise SystemExit(f"lint: {e}")
    n_err = 0
    for subject, diags in results:
        errs = [d for d in diags if d.is_error]
        n_err += len(errs)
        status = "FAIL" if errs else "ok"
        print(f"{status:>4}  {subject}")
        for d in diags:
            print(f"      {d.format()}")
    print(f"\n{len(results)} record(s) linted, "
          f"{n_err} error diagnostic(s)")
    return 1 if (args.strict and n_err) else 0


# -- explain -----------------------------------------------------------------

def _explain_genome(genome: dict, *, kernel: str | None) -> None:
    from ...kernels.workloads import BASELINES
    from .lint import lint_any_genome, split_joint_genome

    sub = split_joint_genome(genome)
    flat = ({f"{k}.{knob}": v for k, g in sub.items()
             for knob, v in g.items()} if sub else dict(genome))
    base = {}
    if sub:
        base = {f"{k}.{knob}": v for k, g in BASELINES.items()
                for knob, v in g.items() if k in sub}
    elif kernel in BASELINES:
        base = BASELINES[kernel]
    for knob in flat:
        mark = ""
        if knob in base:
            mark = ("  (baseline)" if flat[knob] == base[knob]
                    else f"  (baseline: {base[knob]})")
        print(f"    {knob} = {flat[knob]!r}{mark}")
    for d in lint_any_genome(genome, kernel=kernel):
        print(f"    {d.format()}")


def _explain_patch(patch_docs, workload) -> None:
    from ..edits import Patch
    from ..fitness import static_time
    from .classify import make_screen
    from .dataflow import dead_ops, normalize

    patch = Patch.from_doc(patch_docs)
    kinds = ", ".join(patch.kinds()) or "empty (baseline)"
    print(f"    edits: {len(patch)} ({kinds})")
    screen = make_screen(workload)
    if screen is None:
        print("    (no static model for this workload kind)")
        return
    res = screen.classify(patch)
    if res.label == "invalid":
        print(f"    verdict: invalid — {res.outcome.error}")
        return
    if res.genome is not None:   # kernel workload: report the genome
        label = "noop" if res.canon == screen.baseline_canon else "novel"
        print(f"    verdict: {label} (decoded genome "
              f"{'equals' if label == 'noop' else 'differs from'} baseline)")
        _explain_genome(res.genome, kernel=None)
        return
    canon = res.canon or screen._canon_of(res.program)
    label = ("noop" if canon == screen.baseline_canon
             else "novel (canonical class unseen here)")
    print(f"    verdict: {label}")
    prog = res.program
    norm = normalize(prog)
    print(f"    ops: {len(prog.ops)} total, {len(dead_ops(prog))} dead; "
          f"normal form: {len(norm.ops)}")
    print(f"    canonical: {canon[:16]}…  "
          f"(baseline: {screen.baseline_canon[:16]}…)")
    t, t0 = static_time(prog), static_time(workload.program)
    sign = "+" if t >= t0 else ""
    print(f"    static time/step: {t:.4e} s (baseline {t0:.4e} s, "
          f"{sign}{(t - t0) / t0 * 100:.1f}%)")


def _kernel_hint(member) -> str | None:
    """Kernel name recoverable from an artifact-derived member's source key
    (``kernel__<name>__<shapetag>``)."""
    from ...kernels.workloads import KERNELS
    parts = (member.source or "").split("__")
    if len(parts) == 3 and parts[0] == "kernel" and parts[1] in KERNELS:
        return parts[1]
    return None


def cmd_explain(args) -> int:
    members = _load_members(args.path)
    workload = (_build_workload(args.workload, args.device)
                if args.workload else None)
    if workload is not None and os.path.isfile(args.path):
        from ..evaluator import workload_fingerprint
        try:
            fp = json.load(open(args.path)).get("program_fingerprint")
        except (json.JSONDecodeError, AttributeError):
            fp = None
        if fp and fp != workload_fingerprint(workload):
            print(f"warning: this checkpoint was searched on a different "
                  f"workload configuration than --workload "
                  f"{args.workload!r} builds (fingerprint mismatch) — "
                  f"verdicts and static times below may not match the "
                  f"recorded fitness")
    for i, m in _pick(members, args.member, "--member"):
        fit = (f"fitness=({m.fitness[0]:.4e}, {m.fitness[1]:.4g})"
               if m.fitness == m.fitness else "fitness=unknown")
        src = f" source={m.source}" if m.source else ""
        print(f"member {i}{src} {fit}")
        if m.genome is not None:
            _explain_genome(m.genome,
                            kernel=args.kernel or _kernel_hint(m))
        elif m.patch is not None:
            if workload is None:
                print("    IR patch member — pass --workload "
                      f"({sorted(WORKLOAD_BUILDERS)}) to classify it")
            else:
                _explain_patch(m.patch, workload)
        else:
            print("    (member carries neither patch nor genome)")
    return 0


# -- diff --------------------------------------------------------------------

def _opcode_hist(program) -> dict[str, int]:
    h: dict[str, int] = {}
    for op in program.ops:
        h[op.opcode] = h.get(op.opcode, 0) + 1
    return h


def cmd_diff(args) -> int:
    a = _pick(_load_members(args.path_a), args.member_a, "--member-a")[0][1]
    b = _pick(_load_members(args.path_b), args.member_b, "--member-b")[0][1]
    if a.genome is not None and b.genome is not None:
        knobs = sorted(set(a.genome) | set(b.genome))
        same = True
        for k in knobs:
            va, vb = a.genome.get(k), b.genome.get(k)
            if va != vb:
                same = False
                print(f"  {k}: {va!r} -> {vb!r}")
        print("identical genomes" if same else
              f"genomes differ on {sum(a.genome.get(k) != b.genome.get(k) for k in knobs)} knob(s)")
        return 0
    if a.patch is None or b.patch is None:
        raise SystemExit("diff needs two genome members or two patch "
                         "members (mixing is not comparable)")
    if not args.workload:
        raise SystemExit("diffing patch members needs --workload")
    from ..edits import Patch
    from .dataflow import canonical_fingerprint, normalize
    w = _build_workload(args.workload, args.device)
    progs = []
    for docs in (a.patch, b.patch):
        try:
            progs.append(Patch.from_doc(docs).apply(w.program))
        except Exception as e:
            raise SystemExit(f"patch does not apply to {args.workload}: {e}")
    na, nb = (normalize(p) for p in progs)
    fa, fb = canonical_fingerprint(na), canonical_fingerprint(nb)
    if fa == fb:
        print(f"EQUIVALENT — identical canonical form {fa[:16]}…")
        return 0
    print(f"DIFFERENT — canonical {fa[:16]}… vs {fb[:16]}…")
    ha, hb = _opcode_hist(na), _opcode_hist(nb)
    for oc in sorted(set(ha) | set(hb)):
        if ha.get(oc, 0) != hb.get(oc, 0):
            print(f"  {oc}: {ha.get(oc, 0)} vs {hb.get(oc, 0)}")
    return 0


# -- entry -------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.core.analysis",
        description="Static analysis over recorded search outputs: "
                    "schedule linting, patch-effect explanation, "
                    "canonical-form diffing.")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("lint", help="lint schedule genomes / artifacts")
    p.add_argument("path")
    p.add_argument("--kernel", help="kernel name for plain (non-joint) "
                                    "genomes with no artifact context")
    p.add_argument("--strict", action="store_true",
                   help="exit non-zero on any error diagnostic")
    p.set_defaults(fn=cmd_lint)

    p = sub.add_parser("explain", help="per-member analysis report")
    p.add_argument("path")
    p.add_argument("--member", type=int, default=None)
    p.add_argument("--workload", help="workload the patches were searched "
                                      f"on: {sorted(WORKLOAD_BUILDERS)}")
    p.add_argument("--kernel", help="kernel name for plain genomes")
    p.add_argument("--device", default=None,
                   help="device the workload is built on (default: cuda)")
    p.set_defaults(fn=cmd_explain)

    p = sub.add_parser("diff", help="compare two members by canonical form")
    p.add_argument("path_a")
    p.add_argument("path_b")
    p.add_argument("--member-a", type=int, default=None)
    p.add_argument("--member-b", type=int, default=None)
    p.add_argument("--workload")
    p.add_argument("--device", default=None,
                   help="device the workload is built on (default: cuda)")
    p.set_defaults(fn=cmd_diff)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
