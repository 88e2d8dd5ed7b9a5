"""Test config.

By default the suite runs on the CPU with 8 virtual devices (the
fake-cluster mechanism the reference lacks — SURVEY §4) and x64 enabled so
oracle comparisons can be done in f64. Tests marked `gpu` need the card
and skip there; run them on a GPU machine with
`JAX_PLATFORMS=cuda python -m pytest -m gpu tests/` (chip_smoke.py does).
"""
import os

from tpulbm.utils.hostenv import force_virtual_cpu_devices

ON_CPU = os.environ.get("JAX_PLATFORMS", "cpu") == "cpu"
if ON_CPU:
    force_virtual_cpu_devices(8)

import jax  # noqa: E402

from tpulbm.utils.jaxcache import enable_compilation_cache  # noqa: E402

jax.config.update("jax_enable_x64", True)
enable_compilation_cache()

if ON_CPU:
    assert jax.device_count() == 8, jax.devices()
