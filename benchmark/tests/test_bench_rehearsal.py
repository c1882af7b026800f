"""Each cell rehearsed on the CPU at a small size through the harness, in
a process of its own: the last line has the contract's shape, the check
passes, and the process holds neither JAX nor the JAX package."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark.tests.small import SMALL  # noqa: E402

SCRIPT = """
import json, sys, time
sys.path.insert(0, {root!r})
from benchmark import harness
spec = harness.load_json(harness.ROOT, "BENCHMARK.json")
cell = harness.Cell(spec, {cell!r}, 2 ** 31 + 77, 0.5, {trace}, device="cpu",
                    overrides={small!r})
harness.run(cell, time.time())
tops = sorted({{m.split(".")[0] for m in sys.modules}})
print(json.dumps({{"modules": tops}}))
"""


def rehearse(cell, trace):
    done = subprocess.run(
        [sys.executable, "-c", SCRIPT.format(root=ROOT, cell=cell, trace=trace,
                                             small=SMALL[cell])],
        capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert done.returncode == 0, done.stderr[-3000:]
    lines = done.stdout.strip().splitlines()
    return json.loads(lines[-2]), json.loads(lines[-1])["modules"], \
        done.stderr


@pytest.mark.parametrize("cell", sorted(SMALL))
@pytest.mark.parametrize("trace", [0, 1])
def test_rehearsal_prints_a_result_of_the_contracts_shape(cell, trace):
    result, modules, err = rehearse(cell, trace)
    keys = list(result)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks"
    assert result["correct"] is True
    for c in result["checks"].values():
        assert c["value"] <= c["limit"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["device"]) >= {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    kind = "per_layer" if trace else "end_to_end"
    allowed = {m["name"] for m in spec[kind]}
    assert set(result["metrics"]) <= allowed
    if not trace:
        assert {"setup_s"} < set(result["metrics"])
    else:
        assert {"busy_s", "window_s"} <= set(result["device"])
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    for name, c in result["checks"].items():
        assert f"check {name} " in err.strip().splitlines()[-len(
            result["checks"]):][list(result["checks"]).index(name)]
    # whole top-level names: the port's name begins with the JAX package's
    assert not {"jax", "jaxlib", "flax", "inverse_flow_tpu"} & set(modules)
    assert "inverse_flow_tpu_torch" in modules
