"""Shared sizes of the CPU tests: each cell shrunk to 64x96 frames, two GRU
iterations, one UNet level (the 3-level heads need about 384x512), f32."""
import pytest
import torch

SMALL_MODEL = {"iters": 2, "use_weights": True, "unet_levels": 1,
               "mixed_precision": False, "small": False, "dropout": 0.0}
SMALL = {
    "f2f": {"cfg": {"image_shape": [64, 96], "model": dict(SMALL_MODEL)},
            "mix": {"window": 2, "max_fps": 40, "min_fps": 4,
                    "check_windows": 2, "trace_windows": 1}},
    "train": {"cfg": {"image_shape": [64, 96],
                      "model": dict(SMALL_MODEL, lbgfs_iters=100)},
              "mix": {"batch": 2, "batches": 3}},
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    """The CUDA device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card with "
                    "python3 -m pytest port_bench/tests -m card")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
