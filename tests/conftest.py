"""Shared fixtures.

``no_implicit_transfers`` is the test-side twin of the PIPS004 lint
audit: it holds a block of serving calls under
``jax.transfer_guard("disallow")``, so any host<->device crossing NOT
routed through the declared boundaries (``repro.core.transfers.to_device``
/ ``to_host``, which open local allow-scopes) raises instead of silently
shipping bytes.  Serving-path tests wrap their search calls in it to
prove the path stays implicit-transfer-free as it evolves.
"""
from __future__ import annotations

import contextlib

import pytest


@pytest.fixture
def no_implicit_transfers():
    """Factory fixture: ``with no_implicit_transfers(): sv.search(...)``.

    A factory rather than a plain guard scope so the test controls WHERE
    the guard holds — compilation (first call) is legitimately allowed to
    move constants and must happen outside the guarded block."""
    import jax

    @contextlib.contextmanager
    def guard():
        with jax.transfer_guard("disallow"):
            yield

    return guard


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA card (the CUDA kernels have no CPU mode); "
        "the test skips itself when none is present")
