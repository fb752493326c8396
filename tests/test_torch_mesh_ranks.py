"""One rank of the 4-rank gloo group that tests/test_torch_mesh.py starts
once (``launch/mesh.py`` ``launch_ranks``).  It holds no tests: pytest
collects nothing here, and the ranks run it as a program:

    python tests/test_torch_mesh_ranks.py TASK_DIR

It reads ``TASK_DIR/task.npz`` and ``task.json`` (the reference's weights,
batches and inputs, written by the test module), runs every multi-rank
check of the port on ``(2, 2)``, ``(1, 4)`` and ``(4, 1)`` meshes of the
one group (the router's replicas on their submeshes among them), then
the CLIs' own paths on each rank, each in a group of its own:
``launch.train``'s main with ``--mesh smoke --device cpu``, the router's
and ``launch.serve``'s with ``--mesh 2x2 --device cpu``.  It writes what it
found to ``TASK_DIR/rank<r>.npz`` for the test module's parametrised cases
to hold against the reference.  It imports the port only, never JAX.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import sys

import numpy as np
import torch


def _tree(arrays, prefix: str) -> dict:
    """The nested dict of the arrays under ``prefix/`` (keys split on
    '/')."""
    out: dict = {}
    for key in arrays.files:
        if not key.startswith(prefix + "/"):
            continue
        *path, leaf = key[len(prefix) + 1:].split("/")
        node = out
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = arrays[key]
    return out


def _np(t) -> np.ndarray:
    return t.detach().to(torch.float32).numpy()


def drive(router, trace, kill_at: int) -> int:
    """The router CLI's replay of ``trace`` (arrivals at their ticks,
    replica 0 killed at tick ``kill_at``); returns the requests accepted."""
    reqs = trace.requests()
    i = tick = accepted = 0
    while i < len(reqs) or router.busy:
        while i < len(reqs) and trace.items[i].at_tick <= tick:
            accepted += router.try_submit(reqs[i])
            i += 1
        if tick == kill_at and router.n_live > 1:
            router.kill_replica(0)
        router.step()
        tick += 1
    return accepted


def router_tasks(task, meta: dict, meshes: dict, out: dict) -> None:
    """The router's replicas on submeshes: ``replica_meshes``' geometry,
    then each case's meshed router against the unmeshed one on the same
    weights (tokens, stats, and each rank's blocks of the parameters and
    lane caches)."""
    from repro_torch.configs import smoke_config
    from repro_torch.core.deploy import build_router, replica_meshes
    from repro_torch.core.liveloop.traces import synthesize
    from repro_torch.launch.shardings import local_block
    from repro_torch.models.weights import params_from_reference

    rt = meta["router"]
    for name, n in rt["geometry"]:
        subs = replica_meshes(meshes[name], n)
        out[f"router/geo/{name}/{n}"] = np.array(json.dumps(
            [[s.mesh.tolist(), s.get_coordinate()] for s in subs]))
    try:
        replica_meshes(meshes["2x2"], 3)
    except ValueError as e:
        out["router/geo/error"] = np.array(str(e))

    def equal(a, b) -> bool:
        return bool(torch.equal(a, b))

    for case in rt["cases"]:
        tag = f"router/{case['name']}"
        tcfg = smoke_config(case["arch"])
        params = params_from_reference(_tree(task, f"w/{case['weights']}"),
                                       tcfg, "cpu")
        trace = synthesize(vocab=tcfg.vocab, **rt["trace"])
        max_len = case["max_len"] or trace.max_len()
        genome = dict(rt["genome"], replicas=case["replicas"])
        plain = build_router(tcfg, params, genome=genome, max_len=max_len)
        drive(plain, trace, case["kill_at"])
        router = build_router(tcfg, params, genome=genome, max_len=max_len,
                              mesh=meshes[case["mesh"]], device="cpu")
        engine = router.replicas[router.replica].engine.real
        sub = router.submesh
        whole = dict(params.named_parameters())
        out[f"{tag}/params"] = np.array(json.dumps({
            n: [list(p.to_local().shape),
                equal(p.to_local(), local_block(whole[n], sub, p.placements))]
            for n, p in router.placed.named_parameters()}))
        batch = engine.batches["default"]
        out[f"{tag}/caches_at_build"] = np.array(json.dumps({
            k: [list(t.to_local().shape), bool((t.to_local() == 0).all()),
                batch.caches[k].data_ptr() == t._local_tensor.data_ptr()]
            for k, t in batch.placed.items()}))
        with GatherSpy(router.placed) as spy:
            accepted = drive(router, trace, case["kill_at"])
        out[f"{tag}/gathered_over_model"] = np.array(json.dumps(
            sorted(spy.gathered)))
        ref = plain.replicas[router.replica].engine.batches["default"].caches
        after = {}
        for k, t in batch.placed.items():
            got = t.to_local()
            want = local_block(ref[k], sub, t.placements) \
                if ref is not None else torch.zeros_like(got)
            bound = 1e-5 * want.abs() + 1e-5 * max(
                1.0, float(want.abs().max()))
            after[k] = [equal(got, want),
                        bool(((got - want).abs() <= bound).all())]
        out[f"{tag}/caches_after"] = np.array(json.dumps(after))
        out[f"{tag}/submesh"] = np.array(json.dumps(
            [router.replica, sub.mesh.tolist(), list(sub.shape)]))
        out[f"{tag}/tokens"] = np.array(json.dumps(
            {r.uid: list(r.tokens) for r in router.completed}))
        out[f"{tag}/tokens_plain"] = np.array(json.dumps(
            {r.uid: list(r.tokens) for r in plain.completed}))
        out[f"{tag}/stats"] = np.array(json.dumps(router.stats()))
        out[f"{tag}/stats_plain"] = np.array(json.dumps(plain.stats()))
        out[f"{tag}/accepted"] = np.array(accepted)
    router_fault(task, rt, meshes, out)


def router_fault(task, rt: dict, meshes: dict, out: dict) -> None:
    """A fault that one rank of a replica alone hits, mid-step: from the
    fault's tick on, that rank's second layer's attention of a decode step
    raises, after the first layer made its collectives; its peer waits in
    the second layer's sum until the replica's groups time out.  (A
    decode step: a fault in a prefill loses the requests that tick
    admitted, in the reference ``Router`` as in the port's, with or
    without a mesh.)  Records the replay's tokens, stats and seconds, and
    the tick at which this rank raised, if it did."""
    import time

    import torch.distributed as dist

    from repro_torch.configs import smoke_config
    from repro_torch.core.deploy import build_router
    from repro_torch.core.deploy import router as R
    from repro_torch.core.liveloop.traces import synthesize
    from repro_torch.models import transformer as T
    from repro_torch.models.weights import params_from_reference

    f = rt["fault"]
    tcfg = smoke_config(f["arch"])
    params = params_from_reference(_tree(task, f"w/{f['weights']}"), tcfg,
                                   "cpu")
    trace = synthesize(vocab=tcfg.vocab, **rt["trace"])
    default, R.FAULT_TIMEOUT = R.FAULT_TIMEOUT, f["timeout"]
    try:
        router = build_router(tcfg, params, genome=dict(
            rt["genome"], replicas=f["replicas"]), max_len=trace.max_len(),
            mesh=meshes[f["mesh"]], device="cpu")
    finally:
        R.FAULT_TIMEOUT = default
    decode, calls, raised = T.gqa_decode, [], []

    def faulty(*args, **kw):
        if router.n_ticks >= f["at"] and not raised:
            calls.append(router.n_ticks)
            if len(calls) == 2:
                raised.append(router.n_ticks)
                raise RuntimeError("fault injected on this rank alone")
        return decode(*args, **kw)

    if dist.get_rank() == f["rank"]:
        T.gqa_decode = faulty
    try:
        t0 = time.perf_counter()
        accepted = drive(router, trace, -1)
        seconds = time.perf_counter() - t0
    finally:
        T.gqa_decode = decode
    out["router/fault/tokens"] = np.array(json.dumps(
        {r.uid: list(r.tokens) for r in router.completed}))
    out["router/fault/stats"] = np.array(json.dumps(router.stats()))
    out["router/fault/accepted"] = np.array(accepted)
    out["router/fault/seconds"] = np.array(seconds)
    out["router/fault/raised"] = np.array(json.dumps(raised))


class GatherSpy:
    """Records, while it is entered, the parameters that a DTensor
    ``full_tensor`` or ``redistribute`` call gathers over the ``model``
    axis (a ``Shard`` there made ``Replicate``), each known by its local
    storage."""

    def __init__(self, params):
        self.names = {p.to_local().untyped_storage().data_ptr(): n
                      for n, p in params.named_parameters()}
        self.gathered: set = set()

    def _seen(self, x, target) -> None:
        name = self.names.get(x._local_tensor.untyped_storage().data_ptr())
        dim = x.device_mesh.mesh_dim_names.index("model")
        if name is not None and x.placements[dim].is_shard() \
                and not target[dim].is_shard():
            self.gathered.add(name)

    def __enter__(self):
        from torch.distributed.tensor import DTensor, Replicate
        self._saved = (DTensor.full_tensor, DTensor.redistribute)
        full, redistribute = self._saved
        spy = self

        def full_tensor(x, *a, **k):
            spy._seen(x, [Replicate()] * x.device_mesh.ndim)
            return full(x, *a, **k)

        def redistributed(x, device_mesh=None, placements=None, **k):
            if placements is not None:
                spy._seen(x, list(placements))
            return redistribute(x, device_mesh, placements, **k)

        DTensor.full_tensor, DTensor.redistribute = full_tensor, redistributed
        return self

    def __exit__(self, *exc):
        from torch.distributed.tensor import DTensor
        DTensor.full_tensor, DTensor.redistribute = self._saved
        return False


def captured_main(main, argv) -> tuple:
    """``main(argv)``'s value (or its ``SystemExit`` code) and what it
    printed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        try:
            value = main(argv)
        except SystemExit as e:
            value = e.code
    return value, buf.getvalue()


def main() -> None:
    task_dir = sys.argv[1]
    torch.set_num_threads(1)
    import torch.distributed as torch_dist

    from repro_torch.configs import smoke_config
    from repro_torch.launch.mesh import (init_process_group, make_smoke_mesh,
                                         mesh_axes, rank_env)
    from repro_torch.launch.shardings import (distribute, gather,
                                              param_specs, to_shardings)
    from repro_torch.models.common import P, ModelConfig, manual_axes, \
        shard_map
    from repro_torch.models.moe import (_dispatch_local, _route, moe_ep_a2a,
                                        moe_ep_a2a_decode)
    from repro_torch.models.transformer import Dist, init_params
    from repro_torch.models.weights import params_from_reference
    from repro_torch.optim import (adafactor, adamw, compress_tree_psum,
                                   compressed_psum, dequantize_int8,
                                   quantize_int8, sgd_momentum)
    from repro_torch.train import train_step as TS
    from repro_torch.train.checkpoint import (load_latest, restore_like,
                                              save_checkpoint)

    rank, world, init_file = rank_env()
    init_process_group("cpu", rank, world, init_file)
    task = np.load(os.path.join(task_dir, "task.npz"))
    meta = json.load(open(os.path.join(task_dir, "task.json")))
    meshes = {"2x2": make_smoke_mesh(2, 2, device_type="cpu"),
              "1x4": make_smoke_mesh(1, 4, device_type="cpu"),
              "4x1": make_smoke_mesh(4, 1, device_type="cpu")}
    out: dict = {}

    for name, mesh in meshes.items():
        batch_axes, model = mesh_axes(mesh)
        out[f"axes/{name}"] = np.array(json.dumps([batch_axes, model]))

    # ---- expert-parallel MoE on (1, 4) ---------------------------------
    ep = meta["ep"]
    mesh = meshes["1x4"]
    for case in ep["cases"]:
        cfg = ModelConfig(**dict(ep["cfg"], n_experts=case["n_experts"]))
        p = {k: torch.from_numpy(v) for k, v in
             _tree(task, f"ep/{case['name']}/p").items()}
        x = torch.from_numpy(task[f"ep/{case['name']}/x"])
        pspec = {k: P("model") if k.startswith("w_") else P() for k in p}
        cf = case["cf"]
        if case["decode"]:
            fn = shard_map(lambda xb, pp: moe_ep_a2a_decode(
                pp, cfg, xb, capacity_factor=cf), mesh=mesh,
                in_specs=(P(), pspec), out_specs=P())
        else:
            fn = shard_map(lambda xb, pp: moe_ep_a2a(
                pp, cfg, xb, capacity_factor=cf), mesh=mesh,
                in_specs=(P("model"), pspec), out_specs=P("model"))
        leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        xg = x.clone().requires_grad_(True)
        y = fn(xg, leaves)
        cot = torch.from_numpy(task[f"ep/{case['name']}/cot"])
        grads = torch.autograd.grad((y * cot).sum(), [xg, *leaves.values()])
        tag = f"ep/{case['name']}"
        out[f"{tag}/y"] = _np(y)
        out[f"{tag}/gx"] = _np(grads[0])
        for k, g in zip(leaves, grads[1:]):
            out[f"{tag}/g/{k}"] = _np(g)
        if not case["decode"]:  # this rank's drop mask
            blk = x.chunk(4)[rank]
            e_pad = p["w_gate"].shape[0]
            cap = int(math.ceil(blk.shape[0] * cfg.top_k / e_pad * cf / 8.0)
                      * 8)
            w, idx = _route(blk, p["router"], cfg.top_k)
            out[f"{tag}/keep"] = _dispatch_local(
                blk, w, idx, e_pad, cap)[1][2].numpy()

    # ---- compressed psum over "data" on (4, 1) ---------------------------
    mesh = meshes["4x1"]
    xs = torch.from_numpy(task["cp/x"][rank])
    xs2 = torch.from_numpy(task["cp/x2"][rank])
    with manual_axes(mesh, mesh.mesh_dim_names), torch.no_grad():
        q, scale = quantize_int8(xs)
        out["cp/q"] = q.numpy()
        out["cp/scale"] = scale.numpy()
        o, r = compressed_psum(xs, "data")
        o2, r2 = compressed_psum(xs2, "data", r)
        out.update({"cp/out": o.numpy(), "cp/res": r.numpy(),
                    "cp/out2": o2.numpy(), "cp/res2": r2.numpy()})
        out["cp/res_exact"] = np.array(bool(torch.equal(
            r, xs - dequantize_int8(q, scale))))
        to, tr = compress_tree_psum({"a": xs, "b": xs2 * 3}, "data")
        out.update({"cp/tree_a": to["a"].numpy(),
                    "cp/tree_b": to["b"].numpy(),
                    "cp/tree_res_b": tr["b"].numpy()})

    # ---- the sharded and the compressed train steps ----------------------
    opts = {"sgd": lambda: sgd_momentum(lr=0.1),
            "sgd05": lambda: sgd_momentum(lr=0.05),
            "adafactor": lambda: adafactor(), "adamw": lambda: adamw(lr=1e-3),
            "adamw4": lambda: adamw(lr=1e-4, eps=meta["adamw_eps"])}
    for run in meta["steps"]:
        tcfg = smoke_config(run["arch"]).scaled(**run["overrides"])
        tree = _tree(task, f"w/{run['weights']}")
        batch = {k: v for k, v in _tree(task, f"b/{run['batch']}").items()}
        mesh = meshes[run["mesh"]]
        dist = Dist(mesh=mesh, capacity_factor=run.get("cf"))
        opt = opts[run["opt"]]()
        params = params_from_reference(tree, tcfg, "cpu")
        tag = f"step/{run['name']}"
        if run["compress"]:
            state = TS.TrainState(params, opt.init(
                dict(params.named_parameters())))
            step = TS.make_train_step(tcfg, opt, dist, compress_grads=True)
            # this rank's gradients, for the residual's exactness
            blk = {k: torch.from_numpy(v).chunk(4)[rank]
                   for k, v in batch.items()}
            _, g = TS.loss_and_grads(tcfg, params, blk)
            state, m = step(state, batch)
            res_err = 0.0
            for n, gl in g.items():
                qn, sn = quantize_int8(gl.to(torch.float32))
                deq = dequantize_int8(qn, sn)
                res_err = max(res_err, float((state["residuals"][n] - (
                    gl.to(torch.float32) - deq)).abs().max()))
            out[f"{tag}/res_err"] = np.array(res_err)
        else:
            if run.get("tp"):  # the unsharded step on the same weights
                plain = params_from_reference(tree, tcfg, "cpu")
                pst = TS.TrainState(plain, opt.init(
                    dict(plain.named_parameters())))
                pst, pm = TS.make_train_step(tcfg, opt)(pst, batch)
                out[f"{tag}/plain/loss"] = _np(pm["loss"])
                out[f"{tag}/plain/gnorm"] = _np(pm["grad_norm"])
                for n, p in pst["params"].named_parameters():
                    out[f"{tag}/plain/param/{n}"] = _np(p)
            params = distribute(params, to_shardings(
                mesh, param_specs(params, mesh, fsdp=tcfg.fsdp)))
            ost = opt.init(dict(params.named_parameters()))
            ost = distribute(ost, to_shardings(
                mesh, param_specs(ost, mesh, fsdp=tcfg.fsdp)))
            state = TS.TrainState(params, ost)
            if not opt.elementwise:  # the groups it updates on blocks
                split = TS._leaf_split(dict(params.named_parameters()), ost)
                out[f"{tag}/split_groups"] = np.array(json.dumps(
                    sorted(split.axes)))
            loss, grads = TS._sharded_grads(tcfg, dist, params, batch, 1)
            for n, g in grads.items():
                out[f"{tag}/grad/{n}"] = _np(gather(g))
            gs = to_shardings(mesh, param_specs(params, mesh, fsdp=False)) \
                if run["grad_shardings"] else None
            step = TS.make_train_step(tcfg, opt, dist, grad_shardings=gs)
            with GatherSpy(params) as spy:
                state, m = step(state, batch)
            out[f"{tag}/gathered_over_model"] = np.array(json.dumps(
                sorted(spy.gathered)))
            with GatherSpy(state["params"]) as seen:  # the spy sees a gather
                gather(state["params"])
            out[f"{tag}/gathered_by_gather"] = np.array(json.dumps(
                sorted(seen.gathered)))
            out[f"{tag}/local_shapes"] = np.array(json.dumps(
                {n: list(p.to_local().shape)
                 for n, p in state["params"].named_parameters()}))
        out[f"{tag}/loss"] = _np(m["loss"])
        out[f"{tag}/gnorm"] = _np(m["grad_norm"])
        for n, p in gather(state["params"]).items():
            out[f"{tag}/param/{n}"] = _np(p)

    # ---- a checkpoint from (2, 2) restored onto (4, 1) -------------------
    tcfg = smoke_config("qwen3-0.6b")
    params = params_from_reference(_tree(task, "w/qwen3"), tcfg, "cpu")
    opt = adamw(lr=1e-3)
    a = meshes["2x2"]
    params = distribute(params, to_shardings(a, param_specs(params, a)))
    ost = opt.init(dict(params.named_parameters()))
    ost = distribute(ost, to_shardings(a, param_specs(ost, a)))
    state = TS.TrainState(params, ost, step=5)
    batch = _tree(task, "b/qwen3")
    state, _ = TS.make_train_step(tcfg, opt, Dist(mesh=a))(state, batch)
    ckpt = os.path.join(task_dir, "ckpt")
    save_checkpoint(ckpt, state, 6)
    step_no, flat = load_latest(ckpt)
    b = meshes["4x1"]
    fresh = init_params(tcfg, generator=torch.Generator().manual_seed(7),
                        device="cpu")
    fresh = distribute(fresh, to_shardings(b, param_specs(fresh, b)))
    fost = opt.init(dict(fresh.named_parameters()))
    fost = distribute(fost, to_shardings(b, param_specs(fost, b)))
    restored = restore_like(TS.TrainState(fresh, fost), flat)
    want = {**gather(state["params"]),
            **{f"m.{k}": v for k, v in gather(state["opt_state"]["m"]).items()}}
    got = {**gather(restored["params"]),
           **{f"m.{k}": v for k, v in
              gather(restored["opt_state"]["m"]).items()}}
    out["ckpt/bit_equal"] = np.array(all(torch.equal(want[k], got[k])
                                         for k in want))
    out["ckpt/step"] = np.array(step_no)
    out["ckpt/placements"] = np.array(json.dumps(
        {n: str(p.placements) for n, p in restored["params"]
         .named_parameters()}))

    # ---- the router's replicas on submeshes -----------------------------
    router_tasks(task, meta, meshes, out)

    torch_dist.destroy_process_group()

    # ---- launch.train --mesh smoke --device cpu: this rank's path --------
    from repro_torch.core.deploy.router import main as router_main
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.launch.train import main as train_main
    os.environ["MESH_INIT_FILE"] = init_file + "_cli"  # a group of its own
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = train_main(meta["cli"])
    out["cli/printed"] = np.array(buf.getvalue())
    out["cli/losses"] = np.array(res["losses"])

    # ---- the router's and launch.serve's --mesh 2x2 --device cpu ---------
    for name, fn in (("router", router_main), ("serve", serve_main)):
        os.environ["MESH_INIT_FILE"] = f"{init_file}_{name}"
        rc, printed = captured_main(fn, meta["router"]["cli"][name])
        out[f"cli/{name}/rc"] = np.array(0 if rc is None else rc)
        out[f"cli/{name}/printed"] = np.array(printed)
    np.savez(os.path.join(task_dir, f"rank{rank}.npz"), **out)


if __name__ == "__main__":
    main()
