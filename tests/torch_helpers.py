"""Helpers shared by the port's test files (tests/test_torch_*.py).

A test file imports ``one_torch_thread`` (an autouse fixture: importing it
is what turns it on), where it builds models, ``cpu_options``, and where
it computes a JAX reference under jit, ``fast_jit``.
"""

import pytest
import torch

from vitxtgqa_tpu_torch import Options


# a JAX reference's XLA compile without the backend's optimisation passes:
# about half the CPU time of the default, the same function
FAST_XLA = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def fast_jit(fn, *args):
    """``jax.jit(fn)(*args)``, compiled with FAST_XLA."""
    import jax

    return jax.jit(fn).lower(*args).compile(compiler_options=FAST_XLA)(*args)


def cpu_options(**kw) -> Options:
    """Options on the CPU: the port's default device is the card."""
    return Options(device="cpu", **kw)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run the module's torch ops on one CPU thread.  The suite runs
    several pytest workers side by side, and torch's default of one thread
    per core in each of them oversubscribes the cores: its threads then
    wait on each other at every parallel op, which slows these small-shape
    tests far more than one thread does."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
