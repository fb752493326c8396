"""A new cell is new files and new ``BENCHMARK.json`` entries only: a
configuration, a traffic mix and a per-layer metric with a reader of its
own, added beside the others, run through the same harness while every
file that was there stays byte for byte."""

import hashlib
import json

from harness import cells
from tiny import SERVE, run_cell


def _hashes(root):
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "bench").rglob("*") if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_cell_is_new_files(tmp_path):
    import tiny
    root = tiny.make_root(tmp_path)
    before = _hashes(root)
    spec_text = (root / "BENCHMARK.json").read_text()
    bench = root / "bench"
    conf = json.loads((bench / "configs" / "qwen3-0.6b.json").read_text())
    conf["num_hidden_layers"] = conf["port"]["n_layers"] = 1
    conf["kernel_calls"] = {"prefill": {"flash_attention": 1, "rmsnorm": 5}}
    (bench / "configs" / "qwen3-extra.l1.json").write_text(json.dumps(conf))
    mix = json.loads((bench / "traffic" / "longdoc.overload.json").read_text())
    mix.update(rate=12.0, prompt_tokens=[8, 24], answer_tokens=[3, 6],
               drain="all")
    (bench / "traffic" / "shortchat.json").write_text(json.dumps(mix))
    (bench / "metrics" / "answered.py").write_text(
        '"""Requests answered of those due in the window."""\n\n\n'
        "def read(run, **_):\n"
        "    return run.attempted - run.failed\n")
    (bench / "metrics" / "answered.extra.json").write_text(
        json.dumps({"reader": "answered"}))
    (bench / "limits" / "serve.qwen3-extra.l1.shortchat.json").write_text(
        json.dumps({"limits": {"served_token_gap": 1.0}}))
    spec = json.loads(spec_text)
    spec["configs"].append({"name": "qwen3-extra.l1", "source": "x",
                            "file": "bench/configs/qwen3-extra.l1.json",
                            "reduced": ["num_hidden_layers"], "why": "x"})
    spec["workloads"].append({"name": "serve.qwen3-extra.l1.shortchat",
                              "config": "qwen3-extra.l1",
                              "traffic": "shortchat", "chips": 1,
                              "why": "x"})
    for m in spec["end_to_end"]:
        if m["name"] == "serve_tokens_per_s":
            m["workloads"].append("serve.qwen3-extra.l1.shortchat")
    for m in spec["per_layer"]:
        if m["name"] == "queue_wait_p90_s.serve":
            m["workloads"].append("serve.qwen3-extra.l1.shortchat")
    spec["per_layer"].append({"name": "answered.extra", "unit": "requests",
                              "better": "higher", "source": "host_clock",
                              "layer": "Server", "moves": "serve_tokens_per_s",
                              "workloads": ["serve.qwen3-extra.l1.shortchat"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    after = _hashes(root)
    assert all(after[p] == h for p, h in before.items())

    new = cells.cell("serve.qwen3-extra.l1.shortchat", root=root)
    assert [m["name"] for m in new.per_layer] == ["queue_wait_p90_s.serve",
                                                  "answered.extra"]
    run = run_cell(root, new.name, seconds=0.5)
    assert run.correct and run.attempted == 6
    import run as bench_run
    got = bench_run.per_layer(new, run, root)
    assert got["answered.extra"] == {"value": 6, "unit": "requests"}
    old = cells.cell(SERVE, root=root)
    assert "answered.extra" not in {m["name"] for m in old.per_layer}
