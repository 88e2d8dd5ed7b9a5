"""bench.py harness correctness on a virtual CPU mesh (BASELINE config 4:
the weak/strong scaling sweep must be ready for real multi-chip hardware —
perf numbers on the fake mesh are meaningless, the JSON contract is not)."""
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_bench(*args):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    proc = subprocess.run(
        [sys.executable, "bench.py", "--cpu-devices", "4", "--nx", "128",
         "--ny", "64", "--chunks", "1", "--chunk-len", "10", "--repeats",
         "1", *args],
        cwd=REPO, env=env, capture_output=True, timeout=560)
    assert proc.returncode == 0, proc.stderr.decode()[-3000:]
    lines = [l for l in proc.stdout.decode().splitlines()
             if l.startswith("{")]
    return [json.loads(l) for l in lines]


def test_default_single_json_line():
    recs = _run_bench()
    assert len(recs) == 1
    r = recs[0]
    for key in ("metric", "value", "unit", "device", "tier"):
        assert key in r, r
    assert r["unit"] == "MLUPS" and r["value"] > 0
    # every number names the device it was taken on
    assert r["device"] == {"platform": "cpu", "kind": "cpu", "count": 1}, r
    assert r["tier"] == "xla"


def test_strong_sweep_one_line_per_device_count():
    recs = _run_bench("--sweep", "strong")
    assert [r["mesh"] for r in recs] == ["1x1", "2x1", "4x1"]
    assert all(r["grid"] == "128x64" for r in recs)
    assert all(r["total_mlups"] > 0 for r in recs)


def test_weak_sweep_grid_grows_with_devices():
    recs = _run_bench("--sweep", "weak")
    assert [r["mesh"] for r in recs] == ["1x1", "2x1", "4x1"]
    assert [r["grid"] for r in recs] == ["128x64", "128x128", "128x256"]


def test_3d_mode():
    recs = _run_bench("--nz", "16", "--nx", "64", "--ny", "32")
    assert len(recs) == 1
    r = recs[0]
    assert "D3Q19" in r["metric"] and "64x32x16" in r["metric"]
    assert r["value"] > 0


def test_explicit_mesh():
    recs = _run_bench("--mesh", "2x2")
    assert len(recs) == 1 and recs[0]["mesh"] == "2x2"
    # per-chip normalization: total = 4x the per-chip value
    assert abs(recs[0]["total_mlups"] - 4 * recs[0]["value"]) < 1.0
