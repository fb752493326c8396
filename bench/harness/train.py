"""The runner of a training mix (``"runner": "train"``).

Set-up builds one train state (the port's model with the harness's
weights, AdamW's state) and one ``step = make_train_step(cfg, adamw)``, and
drives it through the first ``check_steps`` steps on batches of rows that
all differ.  Those steps are what the check compares: each parameter's
gradient at the first step, as AdamW's first moment holds it
(m = (1 - b1) g), and each parameter's change over the steps (each step's
loss is reported beside them).  The same
state and step then run the measured window, batch after batch, until
``--seconds`` have passed; the window ends on a synchronize, so it holds
all the work of its steps.  ``train_tokens_per_s`` is their tokens over
it.  After the window the program's state is freed and the plain reference
(``bench/reference/``) runs the same steps from the same weights.
"""

from __future__ import annotations

import gc
import math
import statistics
import time

from . import flops, program, weights
from .traffic import train_tokens


def _batch(tokens, i: int) -> dict:
    t = tokens[i % tokens.shape[0]]
    return {"tokens": t[:, :-1], "labels": t[:, 1:]}


def _gaps(prog: dict, ref: dict) -> dict:
    """Leaf by leaf, the gap between the program's norm and the
    reference's (of the first gradient, of the change over the steps),
    over the reference's norm of that leaf or of the median leaf,
    whichever is larger: the worst leaf (``grad_gap``, ``change_gap``)
    and the median leaf (``grad_gap_median``, ``change_gap_median``).
    Leaves whose
    reference gradient is under a thousandth of the median leaf's move by
    round-off alone and are left out of the change.  Also the loss's
    largest relative gap over the steps, which is reported and not
    compared: with random weights every row's loss sits near log(vocab),
    and neither the fp8 control nor a fault reads three times what sound
    runs read (``PERF.md``)."""
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog["loss"],
                                                    ref["loss"]))
    g_med = statistics.median(ref["grad"].values())
    moved = [n for n, g in ref["grad"].items() if g >= 1e-3 * g_med]
    c_med = statistics.median(ref["change"][n] for n in moved)

    def leaves(key, names, med):
        return [(abs(prog[key][n] - ref[key][n]) / max(ref[key][n], med), n)
                for n in names]
    g = leaves("grad", list(ref["grad"]), g_med)
    c = leaves("change", moved, c_med)
    (grad, g_leaf), (change, c_leaf) = max(g), max(c)
    return {"loss_gap": loss, "grad_gap": grad, "change_gap": change,
            "grad_gap_median": statistics.median(v for v, _ in g),
            "change_gap_median": statistics.median(v for v, _ in c),
            "grad_leaf": g_leaf, "change_leaf": c_leaf,
            "left_out": sorted(set(ref["grad"]) - set(moved))}


def program_steps(cell, seed: int, device, *, fault=None, marks=None,
                  clock=None):
    """Set-up: the state, the step and the token pool, and the readings
    of the first ``check_steps`` steps (host floats)."""
    import torch
    from repro_torch.optim.optimizers import adamw
    from repro_torch.train.train_step import TrainState, make_train_step
    tr = cell.traffic
    hp = {k: v for k, v in tr["optimizer"].items() if k != "name"}
    cfg = program.port_config(cell.config)
    model = program.model(cell.config, seed, device)
    opt = adamw(**hp)
    state = TrainState(model, opt.init(dict(model.named_parameters())))
    step = make_train_step(cfg, opt)
    if fault is not None:
        step = fault(step)
    tokens = train_tokens(tr, cfg.vocab, seed, device)
    named = dict(model.named_parameters())
    if marks is not None:
        marks.append(("model", clock()))
    start = {n: p.detach().to("cpu", copy=True) for n, p in named.items()}
    got = {"loss": [], "grad": {}, "change": {}}
    for i in range(tr["check_steps"]):
        state, metrics = step(state, _batch(tokens, i))
        got["loss"].append(float(metrics["loss"]))
        if i == 0:
            m = state["opt_state"]["m"]
            got["grad"] = {n: float(m[n].norm()) / (1 - hp["b1"])
                           for n in named}
    with torch.no_grad():
        for n, p in named.items():
            got["change"][n] = float(
                (p.float() - start[n].to(device).float()).norm())
    del start
    if marks is not None:
        marks.append(("first steps", clock()))
    return state, step, tokens, got


def reference_steps(cell, seed: int, device, precision: str = "f32"):
    import torch
    tr = cell.traffic
    hp = {k: v for k, v in tr["optimizer"].items() if k != "name"}
    ref = program.reference(cell.config)
    values = weights.make(ref.param_specs(cell.config), seed, device)
    tokens = train_tokens(tr, cell.config["port"]["vocab"], seed, device)
    batches = [(tokens[i][:, :-1], tokens[i][:, 1:])
               for i in range(tr["check_steps"])]
    out = ref.train(cell.config, hp, values, batches, precision)
    del values, tokens
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return out


def run(cell, *, seed: int, seconds: float, tracer, device, clock,
        fault=None) -> program.Run:
    import torch
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    tr = cell.traffic
    marks = [("imports", clock())]
    state, step, tokens, got = program_steps(cell, seed, device, fault=fault,
                                             marks=marks, clock=clock)
    from repro_torch.train import train_step as ts
    tracer.wrap(ts, "loss_and_grads", "bench.forward_backward")
    tracer.wrap(ts, "grad_norm", "bench.grad_norm")
    tracer.wrap(ts, "_update", "bench.optimizer")
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    out = program.Run(config=cell.config)
    out.e2e["setup_s"] = clock()
    out.notes.append("set-up, seconds since the process started: " + ", ".join(
        f"{k} {v:.3f}" for k, v in marks + [("window", out.e2e["setup_s"])]))
    tracer.start()
    t0 = time.perf_counter()
    n = 0
    while True:
        with tracer.span("bench.train_step"):
            state, _ = step(state, _batch(tokens, tr["check_steps"] + n))
        n += 1
        if time.perf_counter() - t0 >= seconds:
            break
    sync()
    window = time.perf_counter() - t0
    tracer.stop()
    per_step = tr["batch"] * tr["seq"]
    out.e2e["train_tokens_per_s"] = n * per_step / window
    out.attempted, out.units = n, n
    out.model_flops = n * flops.train_step(cell.config["port"], tr["batch"],
                                           tr["seq"])
    out.work_s = window
    out.memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    out.notes.append(f"window {window:.6f} s, {n} steps, "
                     f"{window / n:.6f} s/step, peak allocated "
                     f"{out.memory_peak} B")
    out.trace = tracer.result()
    del state, step, tokens
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = reference_steps(cell, seed, device)
    gaps = _gaps(got, ref)
    out.notes.append(f"the reference in {time.perf_counter() - t_ref:.3f} s")
    out.notes.append(f"losses {got['loss']} reference {ref['loss']}; worst "
                     f"gradient leaf {gaps['grad_leaf']}, worst change leaf "
                     f"{gaps['change_leaf']}; left out of the change "
                     f"(reference gradient under 1e-3 of the median): "
                     f"{gaps['left_out']}")
    out.notes.append(f"loss gap {gaps['loss_gap']!r} (not compared: no fault "
                     f"or control reads three times a sound run's)")
    out.notes.append("not compared: " + ", ".join(
        f"{k} {gaps[k]!r}" for k in ("grad_gap", "change_gap",
                                     "grad_gap_median", "change_gap_median")
        if k not in cell.limits))
    for name in cell.limits:
        v = gaps[name]
        out.checks.append((name, v if math.isfinite(v) else float("inf"),
                           cell.limits[name]))
    return out
