"""What a run loads: no module whose top-level name (the part before the
first dot, compared whole) is jax, jaxlib, flax or mugiq_tpu; and the
reference loads nothing of mugiq_tpu_torch."""

import json
import subprocess
import sys

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "mugiq_tpu"}

RUN = """
import json, sys
sys.path.insert(0, {tests!r})
from conftest import tiny_cell
from portbench import session
session.execute(tiny_cell("wilson32-mg.flagship"), 7, 0.1, False, "cpu", 0.0)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCE = """
import json, sys
import portbench.reference.wilson, portbench.reference.loop
import portbench.reference.mg, portbench.check, portbench.gauge
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _top_level(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax_and_no_jax_package():
    mods = _top_level(RUN.format(tests=str(ROOT / "portbench" / "tests")))
    assert "mugiq_tpu_torch" in mods
    assert not mods & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    mods = _top_level(REFERENCE)
    assert not mods & (FORBIDDEN | {"mugiq_tpu_torch"})
