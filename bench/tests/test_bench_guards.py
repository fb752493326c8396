"""What a run refuses: no card, a checkout without the port, a module of
JAX or of the JAX package; and what the references may not import."""

import json
import os
import shutil
import subprocess
import sys

from harness import imports
from tiny import BENCH, ROOT, TRAIN

FAKE_CARD = ("import sys, torch; torch.cuda.is_available = lambda: True; "
             "torch.cuda.device_count = lambda: 1; sys.argv = ['run.py', "
             "'--workload', {w!r}, '--seed', '1', '--seconds', '1', "
             "'--trace', '0']; sys.path.insert(0, {b!r}); import run; "
             "sys.exit(run.main())")


def _run(args, cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run(args, cwd=cwd, capture_output=True, text=True,
                          timeout=300, env=env)


def _no_result(proc):
    lines = proc.stdout.strip().splitlines()
    if lines:
        try:
            json.loads(lines[-1])
        except ValueError:
            return True
        return False
    return True


def test_no_card_no_result():
    proc = _run([sys.executable, "bench/run.py", "--workload", TRAIN,
                 "--seed", "1", "--seconds", "1", "--trace", "0"], ROOT)
    assert proc.returncode != 0 and _no_result(proc)
    assert "needs 1 CUDA device" in proc.stderr


def test_checkout_of_the_benchmark_alone_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = FAKE_CARD.format(w=TRAIN, b=str(tmp_path / "bench"))
    proc = _run([sys.executable, "-c", code], tmp_path)
    assert proc.returncode != 0 and _no_result(proc)
    assert "repro_torch" in proc.stderr


def test_top_level_names_compared_whole():
    assert imports.loaded(modules=["repro_torch", "repro_torch.models",
                                   "jaxtyping", "reproducible"]) == []
    assert imports.loaded(modules=["repro.core", "jax.numpy"]) == \
        ["jax", "repro"]
    assert imports.top("repro_torch.kernels.costs") == "repro_torch"


def test_references_import_nothing_of_the_program():
    assert imports.reference_violations(BENCH / "reference") == {}
    code = ("import sys; sys.path.insert(0, {b!r}); "
            "import reference.mamba1, reference.qwen3, reference.common; "
            "print(sorted({{m.split('.')[0] for m in sys.modules}}))")
    proc = _run([sys.executable, "-c", code.format(b=str(BENCH))], ROOT)
    names = set(eval(proc.stdout))
    assert not names & {"repro_torch", "repro", "jax", "jaxlib", "flax"}


def test_a_run_loads_no_jax(tiny_root):
    code = ("import sys; sys.path[:0] = [{t!r}, {b!r}, {s!r}]; "
            "import torch; torch.set_num_threads(2); import tiny, run; "
            "from pathlib import Path; "
            "r = tiny.run_cell(Path({root!r}), tiny.TRAIN, seconds=0.3); "
            "from harness import imports; "
            "print(r.correct, imports.loaded(), "
            "'repro_torch' in sys.modules)")
    proc = _run([sys.executable, "-c", code.format(
        t=str(BENCH / "tests"), b=str(BENCH), s=str(ROOT / "src"),
        root=str(tiny_root))], ROOT)
    assert proc.stdout.split()[-3:] == ["True", "[]", "True"], proc.stderr


def test_reference_check_refuses_a_bad_import(tmp_path):
    (tmp_path / "bad.py").write_text("import repro_torch.models\n"
                                     "from jax import numpy\n"
                                     "from . import common\n")
    assert imports.reference_violations(tmp_path) == {
        "bad.py": ["jax", "repro_torch"]}
