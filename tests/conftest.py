"""Test configuration: run everything on the CPU with 8 virtual devices so
sharding/multi-device logic is exercised without a multi-GPU host
(SURVEY.md section 4).  Settings go through jax.config, which works even
where jax was imported before this file.

Tests that need an NVIDIA GPU carry the ``gpu`` marker and skip here; the
body of each also runs inside chip_smoke.py on the card.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

from paths_tpu.platform import enable_compile_cache

# The suite is compile-bound (every xdist worker compiles the same
# integrator programs), so executables are cached on disk across workers
# and runs.
enable_compile_cache()

REFERENCE_DIR = "/root/reference"
