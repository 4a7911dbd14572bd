import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA card (skipped without one)")


@pytest.fixture(scope="session")
def bench():
    from port_bench import run

    return run.load_json(run.ROOT / "BENCHMARK.json")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.fixture
def no_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("checks a machine without a CUDA card")


@pytest.fixture
def f32():
    """Leave the port's and the reference's process-wide precision at
    float32 after the test."""
    yield
    from port_bench.reference import precision as rp
    from rapier_tpu_torch import precision

    precision.set_precision("f32")
    rp.set_precision("f32")
