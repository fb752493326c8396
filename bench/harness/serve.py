"""The runner of an open-loop serving mix (``"runner": "serve"``).

Set-up builds the port's ``ServeEngine`` over the harness's weights (its
``engine`` parameters from the traffic file) and warms it with the mix's
longest and shortest prompts.  The window then offers the mix's requests
when each is due (``harness/traffic.py`` ``open_loop``), stepping the
engine whenever it has work and sleeping otherwise; after ``--seconds`` no
more is due.  What happens then is the mix's ``drain``: with ``"all"`` the
engine runs on until every request due in the window has finished, a
minute at most; with ``"admitted"``, for a mix offered above what the
engine sustains, the requests still waiting for a slot at the close are
dropped and the engine finishes those it has admitted.  The requests the
engine took on are the attempted ones; one of them never answered counts
as failed.  ``serve_tokens_per_s`` is the prompt and answer tokens of
every request finished inside the window, over the window.  Each request
is timed from when it was due (its first token's time and its wait for
admission).  After the engine is freed, the plain reference re-computes a
sample of the finished requests, drawn from the seed with the longest
among them, and each served token's logit is held against the reference's
best at its position.
"""

from __future__ import annotations

import gc
import time

import numpy as np

from . import flops, program, seeds, weights
from .traffic import nearest_rank, open_loop

DRAIN_S = 60.0
DRAINS = ("all", "admitted")


def engine_for(cell, seed: int, device):
    from repro_torch.core.deploy.engine import ServeEngine
    eng = cell.traffic["engine"]
    return ServeEngine(program.port_config(cell.config),
                       params=program.model(cell.config, seed, device),
                       max_len=eng["max_len"], max_slots=eng["max_slots"],
                       prefill_chunk=eng["prefill_chunk"], temperature=0.0)


def warm(engine, cell, vocab: int) -> None:
    """Prefill the longest and the shortest prompt of the mix and decode
    from them: the allocator then holds the largest blocks the window
    asks for."""
    from repro_torch.core.deploy.engine import ServeRequest
    lo, hi = cell.traffic["prompt_tokens"]
    rng = np.random.default_rng(0)
    engine.run([ServeRequest(f"warm{n}", rng.integers(0, vocab, n,
                                                      dtype=np.int32), 2)
                for n in (hi, lo)])


def sample(results: dict, requests: list, seed: int, tokens: int) -> list:
    """Finished requests to check: the longest prompt, then others drawn
    from the seed, until ``tokens`` served tokens are in the sample."""
    done = [r for r in requests if r.uid in results]
    if not done:
        return []
    first = max(done, key=lambda r: (len(r.prompt), r.uid))
    rest = [r for r in done if r is not first]
    np.random.default_rng(seeds.stream(seed, "sample")).shuffle(rest)
    out, n = [], 0
    for r in [first] + rest:
        out.append(r)
        n += len(results[r.uid].tokens)
        if n >= tokens:
            break
    return out


def served_rows(req, served: list):
    """The sequence whose logits predict each served token (the prompt
    and all but the last served token), and the rows that predict them."""
    seq = np.concatenate([req.prompt, np.asarray(served[:-1], np.int32)])
    first = len(req.prompt) - 1
    return seq, list(range(first, first + len(served)))


def token_gaps(logits, served):
    """How far each served token's logit lies below the best at its
    row."""
    import torch
    idx = torch.as_tensor(served, device=logits.device)[:, None]
    return (logits.max(-1).values - logits.gather(1, idx)[:, 0]).tolist()


def reference_gap(cell, seed: int, device, checked: list, results: dict,
                  precision: str = "f32") -> tuple[float, float]:
    """(the widest gap of a served token under the float32 reference,
    the widest gap of the token a ``precision`` reference puts first)."""
    import torch
    ref = program.reference(cell.config)
    values = weights.make(ref.param_specs(cell.config), seed, device)
    served_gap = control_gap = 0.0
    for req in checked:
        served = results[req.uid].tokens
        seq, rows = served_rows(req, served)
        ids = torch.as_tensor(seq, device=device, dtype=torch.long)
        exact = ref.logits_at(cell.config, values, ids, rows)
        served_gap = max(served_gap, max(token_gaps(exact, served)))
        if precision != "f32":
            low = ref.logits_at(cell.config, values, ids, rows, precision)
            control_gap = max(control_gap, max(token_gaps(
                exact, low.argmax(-1).tolist())))
    return served_gap, control_gap


def run(cell, *, seed: int, seconds: float, tracer, device, clock,
        fault=None, control: str | None = None, check: bool = True,
        drain_s: float = DRAIN_S) -> program.Run:
    import torch
    from repro_torch.core.deploy.engine import ServeRequest
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    port = cell.config["port"]
    drain = cell.traffic["drain"]
    if drain not in DRAINS:
        raise ValueError(f"unknown drain {drain!r}; have {DRAINS}")
    marks = [("imports", clock())]
    engine = engine_for(cell, seed, device)
    marks.append(("engine", clock()))
    if fault is not None:
        fault(engine)
    warm(engine, cell, port["vocab"])
    marks.append(("warm", clock()))
    requests = open_loop(cell.traffic, port["vocab"], seed, seconds)
    for name in ("_admit", "_decode_dispatch", "_decode_complete"):
        tracer.wrap(engine, name, f"bench.{name.lstrip('_')}")
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    out = program.Run(config=cell.config)
    out.e2e["setup_s"] = clock()
    out.notes.append("set-up, seconds since the process started: " + ", ".join(
        f"{k} {v:.3f}" for k, v in marks + [("window", out.e2e["setup_s"])]))
    steps = []   # (seconds, "prefill" | "decode", prefills, in the window)
    late = []
    pending = list(requests)
    dropped: set[str] = set()
    n_done_before = len(engine.completed)
    tracer.start()
    t0 = time.perf_counter()
    end = t0 + seconds
    traced = True
    while True:
        now = time.perf_counter()
        if traced and now >= end:
            sync()
            tracer.end_window()
            traced = False
            window = time.perf_counter() - t0
            if drain == "admitted":
                dropped = {r.uid for r in pending} | \
                    {r.uid for r in engine.queue}
                pending = []
                engine.queue.clear()
        while pending and t0 + pending[0].due_s <= now:
            r = pending.pop(0)
            engine.submit(ServeRequest(r.uid, r.prompt, r.max_new))
            late.append(now - t0 - r.due_s)
        if engine.busy:
            before = (engine.n_prefill_batches, engine.n_decode_batches)
            s0 = time.perf_counter()
            with tracer.span("bench.engine_step"):
                engine.step()
            prefills = engine.n_prefill_batches - before[0]
            kind = ("prefill" if prefills
                    else "decode" if engine.n_decode_batches > before[1]
                    else None)
            if kind:
                steps.append((time.perf_counter() - s0, kind, prefills,
                              traced))
        elif pending:
            time.sleep(max(0.0, min(t0 + pending[0].due_s, end)
                           - time.perf_counter()))
        elif not traced:
            break
        else:
            time.sleep(max(0.0, end - time.perf_counter()))
        if not traced and time.perf_counter() > end + drain_s:
            break
    sync()
    gave_up = time.perf_counter()
    tracer.stop()
    results = {r.uid: r for r in engine.completed[n_done_before:]}
    taken = [r for r in requests if r.uid not in dropped]
    close = t0 + window
    done = [r for r in taken if r.uid in results
            and results[r.uid].t_done <= close]
    out.e2e["serve_tokens_per_s"] = sum(
        len(r.prompt) + len(results[r.uid].tokens) for r in done) / window
    # one never answered waited at least until the run gave up on it
    ttft = [(results[r.uid].t_first if r.uid in results else gave_up)
            - (t0 + r.due_s) for r in taken]
    waits = [results[r.uid].t_admit - (t0 + r.due_s) for r in taken
             if r.uid in results]
    out.extra["ttft_p90_s"] = nearest_rank(ttft, 90)
    out.attempted = len(taken)
    out.failed = len(taken) - len(results) + engine.n_rejected
    out.memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    out.queue_wait_s = waits
    out.step_ms = {k: [1e3 * s for s, kk, _, _ in steps if kk == k]
                   for k in ("prefill", "decode")}
    out.units = sum(p for _, _, p, w in steps if w)
    out.model_flops = float(sum(
        flops.served(port, len(r.prompt), len(results[r.uid].tokens))
        for r in requests if r.uid in results))
    out.work_s = sum(s for s, _, _, _ in steps)
    out.trace = tracer.result()
    out.notes.append(
        f"window {window:.6f} s: {len(requests)} requests due, "
        f"{len(dropped)} still queued at the close and dropped, "
        f"{len(results)} answered ({len(done)} inside the window, "
        f"{out.e2e['serve_tokens_per_s']:.3f} tokens/s), "
        f"{engine.n_rejected} rejected; ttft "
        f"median {nearest_rank(ttft, 50):.6f} p90 "
        f"{out.extra['ttft_p90_s']:.6f} max {max(ttft):.6f} s; the "
        f"generator ran late by median {nearest_rank(late, 50):.6f} p90 "
        f"{nearest_rank(late, 90):.6f} max {max(late):.6f} s; "
        f"{len(steps)} working steps; peak allocated {out.memory_peak} B")
    out.extra["done_in_window"] = len(done)
    if not check:
        return out
    checked = sample(results, requests, seed, cell.traffic["check_tokens"])
    results = {r.uid: results[r.uid] for r in checked}
    del engine
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    gap, low = reference_gap(cell, seed, device, checked, results,
                             control or "f32")
    if control:
        out.extra["control_gap"] = low
    n_tok = sum(len(results[r.uid].tokens) for r in checked)
    out.notes.append(f"checked {len(checked)} requests, {n_tok} served "
                     f"tokens, prompts {sorted(len(r.prompt) for r in checked)}"
                     f", the reference in {time.perf_counter() - t_ref:.3f} s")
    out.checks.append(("served_token_gap", gap, cell.limits["served_token_gap"]))
    if not checked:
        out.failed = max(out.failed, 1)
    return out
