"""A copy of the benchmark's cells at a size the CPU runs in seconds, in a
root of its own: the same runners, generators, references and readers,
on tiny configurations of the same families."""

from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

TRAIN = "train.mamba1.falcon-mamba-7b-widths.l16.s2048"
SERVE = "serve.qwen3-0.6b.longdoc.overload"

SHRINK = {
    "mamba1.falcon-mamba-7b-widths.l16": {
        "top": {"hidden_size": 64, "intermediate_size": 128,
                "state_size": 8, "time_step_rank": 4, "vocab_size": 512,
                "num_hidden_layers": 2},
        "port": {"n_layers": 2, "d_model": 64, "vocab": 512,
                 "ssm_state": 8, "dtype": "float32"},
        "dtype": "float32",
        "kernel_calls": {"train_step": {"rmsnorm": 3, "mamba_scan": 2}}},
    "qwen3-0.6b": {
        "top": {"hidden_size": 64, "intermediate_size": 128,
                "num_attention_heads": 4, "num_key_value_heads": 2,
                "head_dim": 16, "vocab_size": 512, "num_hidden_layers": 2},
        "port": {"n_layers": 2, "d_model": 64, "n_heads": 4,
                 "n_kv_heads": 2, "head_dim": 16, "d_ff": 128, "vocab": 512,
                 "dtype": "float32"},
        "dtype": "float32",
        "kernel_calls": {"prefill": {"flash_attention": 2, "rmsnorm": 9},
                         "train_step": {"flash_attention": 2,
                                        "rmsnorm": 9}}},
}

TRAFFIC = {
    "pretrain.b2.s2048": {"seq": 64, "distinct_batches": 8},
    "longdoc.overload": {"rate": 8.0, "prompt_tokens": [16, 64],
                "answer_tokens": [2, 4], "check_tokens": 12,
                "engine": {"max_slots": 4, "max_len": 68,
                           "prefill_chunk": 2}},
}


def make_root(dest: Path) -> Path:
    """A checkout-shaped root at ``dest``: ``BENCHMARK.json`` and
    ``bench/`` as the real ones, each configuration and mix shrunk, the
    limits of the real cells."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    shutil.copytree(BENCH, dest / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (dest / "BENCHMARK.json").write_text(json.dumps(spec))
    for conf in spec["configs"]:
        path = dest / conf["file"]
        c = json.loads(path.read_text())
        s = SHRINK[conf["name"]]
        c.update(s["top"])
        c["torch_dtype"] = s["dtype"]
        c["port"].update(s["port"])
        c["kernel_calls"] = s["kernel_calls"]
        path.write_text(json.dumps(c))
    for name, change in TRAFFIC.items():
        path = dest / "bench" / "traffic" / f"{name}.json"
        t = json.loads(path.read_text())
        t.update(copy.deepcopy(change))
        path.write_text(json.dumps(t))
    return dest


def run_cell(root: Path, name: str, *, seed: int = 7, seconds: float = 1.0,
             trace: bool = False, fault=None):
    """One run of the cell ``name`` of ``root`` on the CPU, past the
    harness's look for a card: the runner's ``Run``."""
    import time

    from harness import cells
    from harness.trace import Tracer
    import importlib
    cell = cells.cell(name, root=root)
    runner = importlib.import_module(f"harness.{cell.runner}")
    t0 = time.perf_counter()
    return runner.run(cell, seed=seed, seconds=seconds,
                      tracer=Tracer(trace), device="cpu",
                      clock=lambda: time.perf_counter() - t0, fault=fault)
