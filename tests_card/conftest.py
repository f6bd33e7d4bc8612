"""Tests of the port's kernels that need a CUDA card: each kernel against
its plain version at the shapes its callers use.  They import no JAX.

Run on the card: ``python3 -m pytest tests_card -m card -q``.  Elsewhere
every test skips with its reason (decided inside the test, not at import).
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skipped with a reason elsewhere")


@pytest.fixture
def card():
    """The card's device, in IEEE f32 (TF32 off); skip unless CUDA is there."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run python3 -m pytest tests_card -m card on the card")
    from tacotronv2_wavernn_chinese_tpu_torch.utils.precision import fp32_precision

    with fp32_precision():
        yield torch.device("cuda")
