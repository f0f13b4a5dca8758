"""The port's Trainer with spmm_impl="bucket" (plain path, CPU) against the
JAX Trainer(emulate_parts=True, spmm_impl="bucket") from the same
converted params at dropout 0, with test_torch_train.py's checks and
tolerances: per-epoch losses over 10 epochs (rtol 1e-4), the comm carries
after 3 epochs (rtol 1e-5), params and Adam moments after 10 (rtol 1e-4).
This file runs transport none: P in {1, 2, 4} x {vanilla, pipelined,
pipelined + feat/grad corrections} with use_pp, use_pp off, GCN, the
bucket merge, and rem_dtype under xla (a no-op there, as in JAX);
test_torch_train_bucket_transport.py runs the bf16 and fp8 transports.
``check_bucket_against_jax`` serves both files."""

import jax
import numpy as np
import pytest

from pipegcn_tpu.models.sage import ModelConfig as JaxModelConfig
from pipegcn_tpu.parallel.trainer import TrainConfig as JaxTrainConfig
from pipegcn_tpu.parallel.trainer import Trainer as JaxTrainer
from pipegcn_tpu_torch.models import ModelConfig, first_copy, params_from_jax
from pipegcn_tpu_torch.parallel.trainer import TrainConfig, Trainer
from pipegcn_tpu_torch.tree import tree_leaves
from test_torch_train import (CPU, MODES, SIZES, one_torch_thread,
                              port_sharded, sharded)

pytestmark = pytest.mark.torch

__all__ = ["one_torch_thread"]  # the module-wide single-thread fixture


def make_bucket_pair(P, mode, use_pp=True, model="graphsage", **model_kw):
    sg = sharded(P)
    kw = dict(layer_sizes=SIZES, model=model, use_pp=use_pp, norm="layer",
              dropout=0.0, train_size=sg.n_train_global, spmm_impl="bucket",
              **model_kw)
    jt = JaxTrainer(sg, JaxModelConfig(**kw),
                    JaxTrainConfig(seed=1, emulate_parts=True,
                                   **MODES[mode]))
    params = first_copy(jax.device_get(jt.state["params"]))
    pt = Trainer(port_sharded(sg), ModelConfig(**kw),
                 TrainConfig(seed=1, **MODES[mode]), CPU,
                 params=params_from_jax(params, CPU))
    return jt, pt


def check_bucket_against_jax(jt, pt, before_port_epoch=None,
                             loss_rtol=1e-4, epochs=10):
    """Run both trainers epoch by epoch (JAX first; then
    ``before_port_epoch(e)``, if given, before the port's epoch e) and
    hold the port to JAX: carries after 3 epochs, losses, params and
    moments after ``epochs``. Returns the losses (port, JAX)."""
    jl, pl = [], []
    for e in range(epochs):
        jl.append(jt.train_epoch(e))
        if before_port_epoch is not None:
            before_port_epoch(e)
        pl.append(pt.train_epoch(e))
        if e != 2:
            continue
        js, ps = jax.device_get(jt.state), pt.host_state()
        assert sorted(ps["comm"]) == sorted(js["comm"])
        for grp in js["comm"]:
            for k, want in js["comm"][grp].items():
                np.testing.assert_allclose(ps["comm"][grp][k], want,
                                           rtol=1e-5, atol=1e-6,
                                           err_msg=f"{grp}[{k}]")
    np.testing.assert_allclose(pl, jl, rtol=loss_rtol)
    assert pl[-1] < pl[0]
    js, ps = jax.device_get(jt.state), pt.host_state()
    for name, want, got in (
            ("params", first_copy(js["params"]), ps["params"]),
            ("mu", first_copy(js["opt"]["mu"]), ps["opt"]["mu"]),
            ("nu", first_copy(js["opt"]["nu"]), ps["opt"]["nu"])):
        for w, gv in zip(tree_leaves(want), tree_leaves(got)):
            np.testing.assert_allclose(gv, w, rtol=1e-4,
                                       atol=1e-4 * np.abs(w).max(),
                                       err_msg=name)
    return pl, jl


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("P", [1, 2, 4])
def test_bucket_trainer_matches_jax(P, mode):
    jt, pt = make_bucket_pair(P, mode)
    assert pt.bucket and pt.data.bucket is not None
    assert pt.data.indptr_t is None  # the transpose CSR is not staged
    check_bucket_against_jax(jt, pt)


@pytest.mark.parametrize("case", ["no-pp", "gcn", "merge4"])
def test_bucket_trainer_variants_match_jax(case):
    """use_pp off (layer 0 aggregates the raw features through the
    tables, K9 at the input width), GCN at P = 2 (the 1/sqrt(deg)
    scalings around the bucket mean) and --bucket-merge 4."""
    kw = {"no-pp": dict(use_pp=False),
          "gcn": dict(use_pp=False, model="gcn"),
          "merge4": dict(bucket_merge=4)}[case]
    jt, pt = make_bucket_pair(2, "pipelined", **kw)
    check_bucket_against_jax(jt, pt)


def test_rem_dtype_under_xla_is_a_no_op():
    """JAX's raw-edge path has no transport (make_device_spmm_closure
    returns None under xla): rem_dtype is accepted and changes nothing."""
    sg = port_sharded(sharded(2))
    kw = dict(layer_sizes=SIZES, use_pp=True, dropout=0.0)
    tc = TrainConfig(seed=1, enable_pipeline=True)
    runs = [Trainer(sg, ModelConfig(rem_dtype=r, rem_amax=a, **kw), tc, CPU)
            for r, a in ((None, False), ("float8", True))]
    losses = [[t.train_epoch(e) for e in range(3)] for t in runs]
    assert losses[0] == losses[1]
    assert not runs[1].bucket
    # and against the JAX trainer with the same flags
    jt = JaxTrainer(sharded(2), JaxModelConfig(
        train_size=sg.n_train_global, norm="layer", rem_dtype="float8",
        rem_amax=True, **kw), JaxTrainConfig(
        seed=1, emulate_parts=True, enable_pipeline=True))
    params = first_copy(jax.device_get(jt.state["params"]))
    pt = Trainer(sg, ModelConfig(rem_dtype="float8", rem_amax=True, **kw),
                 tc, CPU, params=params_from_jax(params, CPU))
    np.testing.assert_allclose([pt.train_epoch(e) for e in range(3)],
                               [jt.train_epoch(e) for e in range(3)],
                               rtol=1e-4)
