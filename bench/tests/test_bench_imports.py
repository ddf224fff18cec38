"""Nothing the benchmark runs loads JAX or the JAX package ``repro``, and
the reference loads nothing of the program either.  Modules are compared
by their whole top-level name: ``repro_torch`` begins with ``repro``."""
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

HARNESS = """
import glob, importlib.util, os, sys
sys.path[:0] = [{root!r}]
import bench.run, bench.harness, bench.program, bench.calibrate
for f in sorted(glob.glob(os.path.join({root!r}, "bench", "metrics", "*.py"))
             + glob.glob(os.path.join({root!r}, "bench", "rooflines", "*.py"))):
    spec = importlib.util.spec_from_file_location("m" + str(abs(hash(f))), f)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
"""
REFERENCE = """
import sys
sys.path[:0] = [{root!r}]
import bench.reference, bench.reference.model, bench.reference.celu
"""
TAIL = """
import json
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level(code: str) -> set:
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code.format(root=ROOT)
                          + TAIL.format()], capture_output=True, text=True,
                         env=env, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("part,banned", [
    ("harness", {"jax", "jaxlib", "flax", "repro"}),
    ("reference", {"jax", "jaxlib", "flax", "repro", "repro_torch"}),
])
def test_no_banned_top_level_module(part, banned):
    loaded = _top_level(HARNESS if part == "harness" else REFERENCE)
    assert not loaded & banned, sorted(loaded & banned)
    if part == "harness":
        assert "repro_torch" in loaded      # the system under test
