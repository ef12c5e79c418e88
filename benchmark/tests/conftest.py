import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture
def cuda():
    """Skips the test unless a CUDA card is present (decided when the test runs)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; run on the chip")
    return torch.device("cuda")


@pytest.fixture
def tmp_env(tmp_path, monkeypatch):
    """A run's TMPDIR of its own, and the environment variables a run sets
    restored afterwards."""
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    for var in ("VFT_CHECKPOINT_DIR", "VFT_METRICS", "VFT_ALLOW_RANDOM_WEIGHTS"):
        monkeypatch.delenv(var, raising=False)
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", None)
    return tmp_path


@pytest.fixture
def cuda_absent():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
