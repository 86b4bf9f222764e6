"""Shared pieces of the benchmark's CPU tests.

Run them from the checkout's root: ``python -m pytest evalbench/tests -q``.
Tests that need a card carry the ``card`` marker and skip where
``torch.cuda.is_available()`` is false, decided inside the test.
"""

from __future__ import annotations

import pytest

from evalbench.tests.evalbench_tiny import tiny


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA GPU; skips on a machine without one")


@pytest.fixture
def tiny_cell():
    from evalbench import spec

    return lambda name: tiny(spec.cell(name))


@pytest.fixture
def run_tiny():
    """Run a tiny cell on the CPU for ``seconds`` and return its result."""
    import time

    from evalbench import harness

    def go(cell, seconds=1.0, seed=11):
        return harness.run_cell(cell, seed, seconds, False, "cpu", time.perf_counter())

    return go
