"""Deployment CLI: query recorded fronts and manage the artifact registry.

The counterpart of the reference's ``repro.core.deploy`` CLI; it runs on
the host only (fronts and artifacts are JSON).

  # the paper's rule: fastest member within a 2% error relaxation
  PYTHONPATH=src python -m repro_torch.core.deploy select \
      --front /tmp/run/front.json --minimize time --within 0.02

  # export the constrained winner's genome as a serving artifact
  PYTHONPATH=src python -m repro_torch.core.deploy export \
      --front autotune.json --within 0.02 \
      --artifacts experiments/artifacts --kind plan \
      --name qwen3-0.6b --shape decode_32k

  # what is registered?
  PYTHONPATH=src python -m repro_torch.core.deploy list \
      --artifacts experiments/artifacts
"""

from __future__ import annotations

import argparse
import json

from .front import ParetoFront
from .registry import Artifact, ArtifactRegistry


def _select(front: ParetoFront, args):
    return front.select(args.minimize, within=args.within, on=args.on,
                        relative=args.relative, limit=args.limit)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="repro_torch.core.deploy")
    sub = ap.add_subparsers(dest="cmd", required=True)

    sel = sub.add_parser("select", help="constrained front selection")
    exp = sub.add_parser("export", help="select + export to the registry")
    lst = sub.add_parser("list", help="list registered artifacts")

    for p in (sel, exp):
        p.add_argument("--front", required=True,
                       help="front export, GevoML checkpoint, autotune "
                            "result json, or island run directory")
        p.add_argument("--minimize", default="time")
        p.add_argument("--on", default="error")
        p.add_argument("--within", type=float, default=None,
                       help="slack vs the front's best on --on (the paper "
                            "rule: --within 0.02)")
        p.add_argument("--relative", action="store_true")
        p.add_argument("--limit", type=float, default=None,
                       help="absolute bound on --on")
    exp.add_argument("--artifacts", required=True)
    exp.add_argument("--kind", required=True,
                     choices=("kernel", "plan", "serve"))
    exp.add_argument("--name", required=True)
    exp.add_argument("--shape", required=True)
    lst.add_argument("--artifacts", required=True)

    args = ap.parse_args(argv)
    if args.cmd == "list":
        arts = ArtifactRegistry(args.artifacts).list()
        for a in arts:
            print(f"{a.key()}: genome={a.genome} fitness={a.fitness} "
                  f"fingerprint={a.fingerprint()[:12]}…")
        if not arts:
            print(f"(no artifacts under {args.artifacts})")
        return

    front = ParetoFront.load(args.front)
    m = _select(front, args)
    print(f"front: {len(front)} members from {front.origin}")
    print(f"selected: fitness={list(m.fitness)} source={m.source or '-'}")
    if m.genome is not None:
        print(f"  genome: {m.genome}")
    if m.patch is not None:
        print(f"  patch: {json.dumps(list(m.patch))}")
    if args.cmd == "export":
        if m.genome is None:
            raise SystemExit(
                "selected member records a patch, not a genome — only "
                "schedule-space winners (kernel/plan/serve) export as "
                "registry artifacts")
        art = Artifact(kind=args.kind, name=args.name, shape=args.shape,
                       genome=m.genome, fitness=m.fitness,
                       meta={"front": args.front,
                             "rule": f"min {args.minimize} s.t. {args.on} "
                                     f"within {args.within}"
                                     f"{' (relative)' if args.relative else ''}"})
        path = ArtifactRegistry(args.artifacts).export(art)
        print(f"exported {art.key()} -> {path}")


if __name__ == "__main__":
    main()
