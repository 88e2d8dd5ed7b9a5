"""Virtual-device bootstrap for running the sharded paths without hardware.

The fake-cluster mechanism (SURVEY §4): XLA can expose N virtual CPU
devices via --xla_force_host_platform_device_count, which lets every
shard_map/ppermute path run and be tested on one machine. Two subtleties
this helper centralizes (previously copy-pasted across bench.py, main.py,
tests/conftest.py and __graft_entry__.py):

  * the flag must be in XLA_FLAGS before the CPU backend initializes;
  * the platform switch is jax.config.update("jax_platforms", "cpu") made
    after importing jax but before the first device query, which also
    works when jax was imported (and JAX_PLATFORMS read) earlier.
"""
from __future__ import annotations

import os
import re


def add_host_device_count_flag(n: int, env: dict | None = None) -> dict:
    """Ensure --xla_force_host_platform_device_count=n is in XLA_FLAGS.

    Mutates (and returns) `env`, defaulting to os.environ. A count already
    present with a DIFFERENT value (e.g. inherited from a parent shell) is
    replaced — silently keeping it would hand the caller the wrong number
    of devices and fail later with an opaque mesh error."""
    env = os.environ if env is None else env
    flags = env.get("XLA_FLAGS", "")
    pat = r"--xla_force_host_platform_device_count=(\d+)"
    m = re.search(pat, flags)
    if m:
        if int(m.group(1)) != n:
            import warnings
            warnings.warn(
                f"replacing inherited --xla_force_host_platform_device_count="
                f"{m.group(1)} with {n}", stacklevel=2)
        env["XLA_FLAGS"] = re.sub(
            pat, f"--xla_force_host_platform_device_count={n}", flags)
    else:
        env["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={n}").strip()
    return env


def use_cpu_platform() -> None:
    """Switch jax to the CPU platform (must run before backend init)."""
    import jax
    jax.config.update("jax_platforms", "cpu")


def force_virtual_cpu_devices(n: int) -> None:
    """The full bootstrap: N virtual CPU devices on this process."""
    add_host_device_count_flag(n)
    use_cpu_platform()
