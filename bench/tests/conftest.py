"""The benchmark's own tests (``pytest bench/tests`` from the repository's
root): the harness, its generators, counts, references and readers on the
CPU at tiny sizes; tests marked ``cuda`` decide inside the test whether
there is a card."""

import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
for p in (HERE, HERE.parent, HERE.parents[1] / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    import tiny
    return tiny.make_root(tmp_path_factory.mktemp("tiny"))
