"""The tensorized engine's front-peeling loop, three ways, on one GPU.

``core/tensor_evo/nsga2.py`` ranks a population by peeling fronts off its
dominance matrix until no lane is left; on torch that loop runs on the
host (``TorchXP.while_loop``) and reads one flag back per front.  This
script times the engine's generation step on the joint kernel workload
with the loop as shipped and with two variants put in its place for the
run, and checks that each ranks every population as the shipped loop
does:

* ``host``      — the shipped loop: one read-back a front;
* ``blocked<k>`` — ``k`` passes of the loop's body a read-back (the
  body is a no-op once every lane is ranked);
* ``graph<k>``  — ``k`` passes captured once per ranking as a CUDA graph,
  replayed until done (each capture gets its own memory pool).

Run it on a machine with the GPU (it builds the kernels on first use):

    PYTHONPATH=src python tools/peeling_ab.py --pop 1024 --steps 20

It prints one JSON line per variant: generations per second, whether the
ranks and the final population equal the shipped loop's, and the device
memory torch holds reserved before and after the timed steps.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.core.tensor_evo import TensorGevoML, nsga2
from repro_torch.core.tensor_evo.xp import TorchXP
from repro_torch.kernels.workloads import build_joint_kernel_workload


def blocked(k: int):
    def loop(cond, body, state):
        while bool(cond(state)):
            for _ in range(k):
                state = body(state)
        return state
    return loop


def graph(k: int):
    stream = torch.cuda.Stream()

    def loop(cond, body, state):
        if not bool(cond(state)):
            return state
        state = body(state)           # one eager pass warms the ops up
        static = tuple(t.clone() for t in state)
        g = torch.cuda.CUDAGraph()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            g.capture_begin()
            cur = static
            for _ in range(k):
                cur = body(cur)
            for s, t in zip(static, cur):
                s.copy_(t)
            g.capture_end()
        torch.cuda.current_stream().wait_stream(stream)
        while bool(cond(static)):
            g.replay()
        out = tuple(t.clone() for t in static)
        g.reset()
        return out
    return loop


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pop", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--k", type=int, nargs="+", default=[8, 16])
    args = ap.parse_args()
    eng = TensorGevoML(build_joint_kernel_workload(), pop_size=args.pop,
                       n_elite=16, seed=0)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    idx = eng.init_pop(gen)
    step = eng.step_fn()
    for _ in range(5):
        idx, _ = step(idx, gen, 0.8, 0.5)
    objs, _ = eng.objectives_fn()(idx)
    shipped = TorchXP.__dict__["while_loop"]
    want_rank, _ = nsga2.rank_crowd(objs, xp=eng.xp)
    want_idx = None
    variants = [("host", shipped)]
    variants += [(f"blocked{k}", staticmethod(blocked(k))) for k in args.k]
    variants += [(f"graph{k}", staticmethod(graph(k))) for k in args.k]
    try:
        for name, loop in variants:
            TorchXP.while_loop = loop
            rank, _ = nsga2.rank_crowd(objs, xp=eng.xp)
            g = torch.Generator(device="cuda")
            g.manual_seed(1)
            x = idx.clone()
            for _ in range(2):
                x, _ = step(x, g, 0.8, 0.5)
            torch.cuda.synchronize()
            reserved = torch.cuda.memory_reserved()
            t = time.perf_counter()
            for _ in range(args.steps):
                x, _ = step(x, g, 0.8, 0.5)
            torch.cuda.synchronize()
            rate = args.steps / (time.perf_counter() - t)
            want_idx = x if want_idx is None else want_idx
            print(json.dumps({
                "variant": name, "pop": args.pop,
                "generations_per_s": rate,
                "rank_equal": bool(torch.equal(rank, want_rank)),
                "population_equal": bool(torch.equal(x, want_idx)),
                "reserved_bytes_before": reserved,
                "reserved_bytes_after": torch.cuda.memory_reserved(),
                "fronts": int(want_rank.max()) + 1}), flush=True)
    finally:
        TorchXP.while_loop = shipped


if __name__ == "__main__":
    main()
