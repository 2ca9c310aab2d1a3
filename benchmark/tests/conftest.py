"""CPU tests of the benchmark (``python -m pytest benchmark/tests``);
those marked ``cuda`` decide in the test whether a card is there."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture(autouse=True)
def fewThreads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"


@pytest.fixture(autouse=True)
def freshModels():
    """The program caches a loaded model by its checkpoint's name; tests
    draw new weights under the same name, so each starts without it."""
    from moephoto_tpu_torch.pipeline import registry

    registry._modelCache.clear()
    registry._paramsCache.clear()
    yield
