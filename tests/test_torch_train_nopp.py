"""The port's Trainer against the JAX Trainer(emulate_parts=True) without
use_pp: layer 0 exchanges halos too (the raw features, which carry no
gradient). The same checks and tolerances as test_torch_train.py, whose
helper this file reuses; the two files split the matrix so each stays
well inside the suite's time."""

import pytest

from test_torch_train import MODES, check_against_jax, one_torch_thread

pytestmark = pytest.mark.torch

__all__ = ["one_torch_thread"]  # the module-wide single-thread fixture


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("P", [1, 2, 4])
def test_trainer_matches_jax_emulated_no_pp(P, mode):
    check_against_jax(P, mode, use_pp=False)
