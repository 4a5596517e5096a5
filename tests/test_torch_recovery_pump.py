"""Capacity recovery through the kernel's twin: the pump engine at pump_k
3 on test_torch_recovery_tgen.py's tgen world (queue 14, outbox 8,
deliver_lanes 8), against the JAX package's pump engine, and against
the port's run started at the grown capacities. A file of its own: the
JAX pump engine compiles at each capacity of the ladder. Exact
equality."""

import pytest

import test_torch_recovery_tgen as tg
from test_torch_recovery_tgen import _one_torch_thread  # noqa: F401 (autouse fixture)


@pytest.mark.parametrize("engine", ["pump3"])
def test_recovered_run_matches_jax(engine):
    tg.test_recovered_run_matches_jax(engine)


@pytest.mark.parametrize("engine", ["pump3"])
def test_recovered_run_matches_the_grown_start(engine):
    tg.test_recovered_run_matches_the_grown_start(engine)
