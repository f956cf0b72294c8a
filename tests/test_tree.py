"""The tree runs one plain-XLA path on every backend: no Pallas kernel,
no library branch on the backend's name, nothing left in the Pallas
interpreter."""

import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(ROOT, "quinoa_tpu")

# (pattern, directory it must not occur in)
PATTERNS = {
    "pallas": (re.compile(r"jax\.experimental\.pallas|pallas_call"), ROOT),
    # Scripts may insist on a backend (chip_smoke.py wants the GPU, the
    # known-good regeneration the CPU); the library itself may not fork.
    "backend_branch": (re.compile(
        r"""(default_backend\(\)|\.platform)\s*[!=]=\s*["']"""), PACKAGE),
    "interpret_mode": (re.compile(r"\binterpret\s*="), ROOT),
}


#: where the repository keeps Python code (output directories may hold
#: copies of other trees)
CODE_DIRS = ("quinoa_tpu", "tests", "tools", "native")


def _python_files(top):
    if top == ROOT:
        tops = [os.path.join(ROOT, d) for d in CODE_DIRS]
        paths = [os.path.join(ROOT, f) for f in os.listdir(ROOT)]
    else:
        tops, paths = [top], []
    for t in tops:
        for d, sub, files in os.walk(t):
            sub[:] = [s for s in sub if s != "__pycache__"]
            paths += [os.path.join(d, f) for f in files]
    for path in paths:
        if path.endswith(".py") and path != os.path.abspath(__file__):
            yield path


@pytest.mark.parametrize("name", sorted(PATTERNS))
def test_tree_runs_one_xla_path(name):
    pattern, top = PATTERNS[name]
    hits = []
    for path in _python_files(top):
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f, 1):
                if pattern.search(line):
                    hits.append(f"{os.path.relpath(path, ROOT)}:{i}: "
                                f"{line.strip()}")
    assert not hits, "\n".join(hits)
