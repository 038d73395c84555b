"""Test configuration: run JAX on a virtual 8-device CPU mesh.

JAX_PLATFORMS=cpu keeps every test on the CPU, and XLA's host-platform
device count gives it eight devices for the mesh tests; XLA_FLAGS has
to be set before the CPU backend is created. The persistent compile
cache stays off, so that parallel test workers never share cache files.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_PLATFORMS"] = "cpu"

from finito_tpu.utils import relax_cpu_collective_timeouts
relax_cpu_collective_timeouts()
import jax  # noqa: E402

jax.config.update("jax_enable_compilation_cache", False)
