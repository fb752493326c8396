"""Surrogate CLI: train / evaluate / rank over recorded fitness caches.

Works on raw cache JSONL files — no workload rebuild, nothing executed — so a
cache recorded anywhere (a search run, an island epoch, live serving) can be
modeled offline::

    PYTHONPATH=src python -m repro_torch.core.surrogate train \
        --cache experiments/caches/rmsnorm_mini.jsonl --out model.json
    PYTHONPATH=src python -m repro_torch.core.surrogate eval \
        --model model.json --cache other_run.jsonl
    PYTHONPATH=src python -m repro_torch.core.surrogate rank \
        --model model.json --cache candidates.jsonl --top 10

Output is deterministic for a given cache + flags (direct normal-equation
solve, insertion-ordered JSONL reads, index-stable Pareto ordering) — CI's
smoke test trains and ranks twice and diffs the bytes.
"""

from __future__ import annotations

import argparse
import json
import sys

from .dataset import dataset_from_jsonl
from .model import SurrogateModel, pareto_order


def _load(path: str, what: str):
    keys, X, Y = dataset_from_jsonl(path)
    if not keys:
        raise SystemExit(
            f"no feature-bearing measured records in {path}; record the "
            f"cache with a featurizing evaluator to {what}")
    return keys, X, Y


def cmd_train(args) -> int:
    keys, X, Y = _load(args.cache, "train on")
    model = SurrogateModel(l2=args.l2).fit(X, Y)
    if args.out:
        model.save(args.out)
    print(json.dumps({"rows": len(keys), "features": X.shape[1],
                      "l2": args.l2, "out": args.out,
                      "train_metrics": model.metrics(X, Y)},
                     indent=1, sort_keys=True))
    return 0


def cmd_eval(args) -> int:
    keys, X, Y = _load(args.cache, "evaluate against")
    model = SurrogateModel.load(args.model)
    print(json.dumps({"rows": len(keys), "model": args.model,
                      "metrics": model.metrics(X, Y)},
                     indent=1, sort_keys=True))
    return 0


def cmd_rank(args) -> int:
    keys, X, Y = _load(args.cache, "rank")
    model = SurrogateModel.load(args.model)
    preds = model.predict(X)
    order = pareto_order(preds)
    if args.top:
        order = order[: args.top]
    print("| rank | key | pred time s | pred error | meas time s | "
          "meas error |")
    print("|---|---|---|---|---|---|")
    for pos, i in enumerate(order):
        print(f"| {pos} | {keys[i]} | {preds[i][0]:.4g} | "
              f"{preds[i][1]:.4g} | {Y[i][0]:.4g} | {Y[i][1]:.4g} |")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.core.surrogate",
        description="train/evaluate/rank surrogate cost models over "
                    "recorded fitness-cache JSONLs")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("train", help="fit a ridge model from a cache JSONL")
    p.add_argument("--cache", required=True, help="fitness-cache JSONL")
    p.add_argument("--out", default=None, help="model JSON output path")
    p.add_argument("--l2", type=float, default=1e-3)
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("eval", help="score a saved model against a cache")
    p.add_argument("--model", required=True, help="model JSON")
    p.add_argument("--cache", required=True, help="fitness-cache JSONL")
    p.set_defaults(fn=cmd_eval)

    p = sub.add_parser("rank",
                       help="order a cache's records by predicted Pareto "
                            "preference")
    p.add_argument("--model", required=True, help="model JSON")
    p.add_argument("--cache", required=True, help="fitness-cache JSONL")
    p.add_argument("--top", type=int, default=0,
                   help="print only the first N (0 = all)")
    p.set_defaults(fn=cmd_rank)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
