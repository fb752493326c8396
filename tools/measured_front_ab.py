#!/usr/bin/env python3
"""A seeded measured GEVO search on 2fcNet with the ``repro_torch`` of a
given source tree, for comparing two commits' measured fitness on one GPU.

    python3 tools/measured_front_ab.py SRC_DIR [--label NAME]

Builds the 2fcNet training workload at its defaults (784-128-10, 200 SGD
steps) in measured time on the GPU, runs GevoML (pop 12, 2 generations,
seed 0, every operator), and prints one JSON line: the unmutated fitness,
each evaluated variant's fitness by patch, the Pareto front, wall time and
evaluations per second.  Run it for the parent and the change in turns
(parent, change, change, parent) inside one call to the card, and compare
the fronts.
"""

import argparse
import json
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("src", help="the src/ directory holding repro_torch")
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    sys.path.insert(0, args.src)
    import torch
    from repro_torch.core.search import GevoML
    from repro_torch.workloads.twofc import build_twofc_training_workload
    if not torch.cuda.is_available():
        print("measured_front_ab.py: no CUDA device", file=sys.stderr)
        return 2
    w = build_twofc_training_workload(time_mode="measured")
    t0 = time.perf_counter()
    search = GevoML(w, pop_size=12, n_elite=6, seed=0, operators="all")
    res = search.run(generations=2)
    wall = time.perf_counter() - t0
    print(json.dumps({
        "label": args.label, "src": args.src,
        "gpu": torch.cuda.get_device_name(0),
        "original": list(res.original_fitness),
        "population": {i.patch.describe(): list(i.fitness)
                       for i in res.population},
        "pareto": [{"fitness": list(i.fitness), "patch": i.patch.describe()}
                   for i in res.pareto],
        "wall_s": wall, "evaluations": search.n_evals,
        "evaluations_per_s": search.n_evals / wall}))
    search.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
