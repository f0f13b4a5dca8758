"""The port's Trainer with model="gcn" against the JAX
Trainer(emulate_parts=True), with test_torch_train_gat.py's checks and
tolerances (themselves those of test_torch_train.py): P in {2, 4} x
{vanilla, pipelined, pipelined + feat/grad corrections}, and the
full-graph eval. GCN scales rows by 1/sqrt(in_deg) before the halo
exchange and the mean by sqrt(in_deg) after it, through the same
mean-aggregation kernels (K1 forward, K3 backward) as GraphSAGE."""

import pytest

from test_torch_train import MODES, one_torch_thread
from test_torch_train_gat import (check_eval_against_jax,
                                  check_model_against_jax)

pytestmark = pytest.mark.torch

__all__ = ["one_torch_thread"]  # the module-wide single-thread fixture


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("P", [2, 4])
def test_gcn_trainer_matches_jax(P, mode):
    check_model_against_jax(P, mode, "gcn")


def test_gcn_full_graph_eval_matches_jax():
    check_eval_against_jax("gcn")
