"""A fixture that runs torch on one thread for the whole of a test module.

The tier-1 suite runs six pytest-xdist workers on an 8-core machine.  At
torch's default pool each worker starts a thread for every core, so the
suite ran 6 × 8 threads on 8 cores, and each thread waited on cores that
the other processes held.  ``test_torch_iconvsr``'s
``test_do_vsr_matches_jax`` takes 52 s alone; six copies at once at the
default pool were all still running at 420 s (load average 47), and six
copies with this fixture passed in 116-118 s each.

The fixture is module-scoped and autouse, and pytest sets up autouse
fixtures first within their scope, so the module-scoped fixtures that
build models and JAX references run on one thread too.  It restores the
old count when the module ends.  Every ``tests/test_torch_*.py`` takes
it with one line, and ``test_torch_imports`` holds that rule::

    from tests.torch_one_thread import oneTorchThread  # noqa: F401  (autouse)
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def oneTorchThread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
