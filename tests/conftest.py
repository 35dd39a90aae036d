"""Test configuration: run the suite on a virtual 8-device CPU mesh.

The reference library's tests run single-process on the host CPU
(/root/reference/meson.build:41-54).  Our equivalent test environment is a
virtual multi-device CPU platform so that every sharding/mesh code path is
exercised without an accelerator, per the multi-device test strategy in
SURVEY.md §4.  The GPU path is exercised by chip_smoke.py on the card.
"""

import fcntl
import os
import subprocess

# Must be set before jax is imported anywhere.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

# also when a plugin imported jax before this file ran
jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest

from libzseek_jax import native
from libzseek_jax.testing.corpus import mixed_corpus as _mixed_corpus
from libzseek_jax.utils.compile_cache import enable_compile_cache

enable_compile_cache()


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0xC0FFEE)


@pytest.fixture(scope="session")
def corpus(rng):
    return _mixed_corpus(rng, 1 << 18)  # 256 KiB


@pytest.fixture(scope="session")
def native_lib():
    """The native host runtime, built from zn.cc on first use.  Test
    workers build under an exclusive lock on the Makefile, so one of them
    compiles and the rest find the library up to date."""
    if not native.have_native():
        native_dir = os.path.dirname(native.__file__)
        with open(os.path.join(native_dir, "Makefile")) as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            r = subprocess.run(["make", "-sC", native_dir],
                               capture_output=True, text=True)
        if r.returncode != 0:
            pytest.skip(f"native build unavailable: {r.stderr[-200:]}")
    assert native.have_native()
    return native
