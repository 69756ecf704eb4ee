"""The tiny cell on a card: the kernels' path against the reference.
Skips without a card; run on one with
``python -m pytest cdsbench/tests -m cuda``."""

import pytest

from cdsbench.tests.tiny_cell import SEEDS, run_tiny


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
def test_tiny_cell_on_the_card_is_correct(card):
    res = run_tiny(SEEDS[7], device="cuda", trace=True)
    assert res["correct"] is True
    assert res["device"]["busy_s"] > 0
