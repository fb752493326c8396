"""``BENCHMARK.json`` against the rules of its format, and the schema of
a run's last line."""

import json
import math
import re

import pytest

from harness import cells
from tiny import BENCH, ROOT, SERVE, TRAIN, run_cell

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
# keys that name a width, which no cut may change
WIDTH = re.compile(r"(hidden_size|intermediate_size|latent|state_size|"
                   r"projection|_dim$|_rank$|expand|experts_per_tok)")


def test_top_level_keys():
    assert list(SPEC) == ["command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"]
    assert SPEC["command"] == ["python3", "bench/run.py"]
    assert SPEC["paths"] == ["bench"]
    assert isinstance(SPEC["run_seconds"], int) and \
        1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_names_units_and_keys():
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in SPEC[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("bench/configs/")
        assert not any(WIDTH.search(k) for k in c["reduced"])
        assert all(NAME.match(k) for k in c["reduced"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
        assert NAME.match(w["traffic"])
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {m["layer"] for m in SPEC["per_layer"]}
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and m["layer"] in layers
        if m["name"].split(".")[0].endswith("roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_resolves(workload):
    """Each cell's files are there, its reference lists the port's
    parameters, and it reports setup_s, another end-to-end metric and a
    per-layer one, each per-layer metric with a reader."""
    cell = cells.cell(workload)
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.per_layer:
        params = cells.metric_params(m["name"])
        assert (BENCH / "metrics" / f"{params['reader']}.py").is_file()
        assert m["moves"] in e2e
    assert (BENCH / "harness" / f"{cell.runner}.py").is_file()
    from harness import program, weights
    from repro_torch.models.transformer import init_params
    specs = program.reference(cell.config).param_specs(cell.config)
    weights.check_skeleton(init_params(program.port_config(cell.config),
                                       device="meta"), specs)


def test_config_matches_its_port_block():
    f = cells.cell(TRAIN).config
    assert (f["port"]["d_model"], f["port"]["vocab"], f["port"]["n_layers"],
            f["port"]["ssm_state"], f["port"]["ssm_conv"]) == (
        f["hidden_size"], f["vocab_size"], f["num_hidden_layers"],
        f["state_size"], f["conv_kernel"])
    assert f["port"]["ssm_expand"] * f["hidden_size"] == \
        f["intermediate_size"]
    assert -(-f["hidden_size"] // 16) == f["time_step_rank"]
    q = cells.cell(SERVE).config
    assert (q["port"]["d_model"], q["port"]["n_heads"],
            q["port"]["n_kv_heads"], q["port"]["head_dim"],
            q["port"]["d_ff"], q["port"]["vocab"], q["port"]["n_layers"],
            q["port"]["rope_theta"], q["port"]["norm_eps"]) == (
        q["hidden_size"], q["num_attention_heads"],
        q["num_key_value_heads"], q["head_dim"], q["intermediate_size"],
        q["vocab_size"], q["num_hidden_layers"], q["rope_theta"],
        q["rms_norm_eps"])


@pytest.mark.parametrize("workload,trace", [(TRAIN, 0), (TRAIN, 1),
                                            (SERVE, 0), (SERVE, 1)])
def test_last_line_schema(tiny_root, monkeypatch, workload, trace):
    import torch

    import run as bench_run
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "test device")
    monkeypatch.setattr(bench_run, "ROOT", tiny_root)
    cell = cells.cell(workload, root=tiny_root)
    run = run_cell(tiny_root, workload, seconds=0.5, trace=bool(trace))
    line = json.loads(json.dumps(bench_run.result(cell, run, bool(trace),
                                                  root=tiny_root)))
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(line)
    assert line["correct"] is True and line["failed"] == 0
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    want = {m["name"]: m["unit"] for m in (cell.per_layer if trace
                                           else cell.end_to_end)}
    for name, m in line["metrics"].items():
        assert want[name] == m["unit"] and math.isfinite(m["value"])
    if not trace:
        assert set(line["metrics"]) == set(want)
    else:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
