"""The port's bucket Trainer with the narrowed gather transport (bf16,
fp8, fp8 + amax) against the JAX Trainer(emulate_parts=True,
spmm_impl="bucket") with the same flags, at P = 2 pipelined and P = 4
pipelined + feat/grad corrections.

The casts themselves are bit-exact against JAX (test_torch_bucket.py),
but the two trainers feed them inputs that differ in f32 rounding, and a
value within that rounding of a rounding midpoint of the narrow format
casts to the neighbouring value: a transport flip, which moves that
message by one step of the format (6-12 % at e4m3) — a jump no rounding
tolerance bounds. A pre-activation within that rounding of 0 likewise
flips relu, which passes or stops that element's whole gradient. So the
port's run takes JAX's transported values and relu masks, as the card's
step check shares them between the kernels and the plain versions: the
JAX step's casts and relus are tapped (``jax.debug.callback`` around the
module's ``transport_cast`` / ``amax_transport_cast`` and ``jax.nn.relu``,
once per part), each port cast (``TransportShare``) and relu (the
trainer's ``act``) takes the record whose input is nearest its own, and
counts the elements where its own cast at that record's scale, or its
own relu, would differ. On those shared values every element is held to
test_torch_train.py's tolerances (losses 1e-4, carries 1e-5, params and
moments 1e-4); the counted flips must stay below ``FLIP_FRAC`` of the
elements. A second run on the port's own casts and relus holds its
losses to ``OWN_LOSS_RTOL``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pipegcn_tpu.ops.bucket_spmm as jbs
from pipegcn_tpu_torch.ops.bucket_spmm import TransportShare
from test_torch_bucket import to_torch
from test_torch_train import one_torch_thread
from test_torch_train_bucket import check_bucket_against_jax, make_bucket_pair

pytestmark = pytest.mark.torch

__all__ = ["one_torch_thread"]  # the module-wide single-thread fixture

# transport (relu) flips as a share of the transported (relu) elements: a
# flip needs an input within ~1e-7 relative of a midpoint (of 0), about
# 1e-6 of e4m3 values and 4e-5 of bf16 values at the inputs' differences
FLIP_FRAC = 1e-3
# the port's own casts and relus against JAX's: the losses over 10
# epochs. Their flips compound through Adam (bf16 at P = 2: 27 flips moved
# the losses by up to 1.8e-4; every other case by <= 2e-6). The bound sits
# below the least that any case's transport moves the losses from
# transport none (4.5e-4, bf16 at P = 2; fp8 7.6e-4 to 2e-3), so the
# check tells the transport on from off
OWN_LOSS_RTOL = 2.5e-4


class JaxTap:
    """Records the JAX step's transport casts ``(input, output, inverse
    scale or None)`` and relu inputs, per part, through
    ``jax.debug.callback``."""

    def __init__(self, monkeypatch):
        self.records, self.relus = [], []
        self.relu_flips = self.relu_elements = 0
        cast0, amax0 = jbs.transport_cast, jbs.amax_transport_cast
        relu0 = jax.nn.relu

        def cast(x, dt):
            y = cast0(x, dt)
            if dt is not None:
                jax.debug.callback(self._keep, x, y, jnp.float32(np.nan))
            return y

        def amax_cast(x, dt):
            y, inv = amax0(x, dt)  # bf16: records in cast, inv None
            if inv is not None:
                jax.debug.callback(self._keep, x, y, inv)
            return y, inv

        def relu(h):
            jax.debug.callback(lambda v: self.relus.append((np.array(v),)),
                               h)
            return relu0(h)

        monkeypatch.setattr(jbs, "transport_cast", cast)
        monkeypatch.setattr(jbs, "amax_transport_cast", amax_cast)
        monkeypatch.setattr(jax.nn, "relu", relu)

    def _keep(self, x, y, inv):
        inv = float(inv)
        self.records.append((np.array(x, np.float32), to_torch(np.asarray(y)),
                             None if np.isnan(inv) else inv))

    @staticmethod
    def _nearest(pool, xp, keep=lambda r: True):
        """Pop the record of ``pool`` (its input first) nearest ``xp`` by
        the mean absolute difference (a flip moves one element or one
        row), which must be unambiguous."""
        cands = [i for i, r in enumerate(pool)
                 if keep(r) and np.shape(r[0]) == xp.shape]
        assert cands, xp.shape
        errs = np.array([np.abs(pool[i][0] - xp).mean() for i in cands])
        best = int(np.argmin(errs))
        assert (errs > 10 * errs[best]).sum() == len(cands) - 1, errs
        return pool.pop(cands[best])

    def source(self, x, dt, deg):
        """The recorded cast of each part of ``x`` (/ deg)."""
        xe = x.float() if deg is None else x.float() / deg[..., None]
        recs = [self._nearest(self.records, xe[p].numpy(),
                              lambda r: r[1].dtype == dt)
                for p in range(xe.shape[0])]
        inv = None if recs[0][2] is None else torch.tensor(
            [r[2] for r in recs])
        return torch.stack([r[1] for r in recs]), inv

    def act(self, h):
        """relu of ``h`` on the recorded relu masks, flips counted."""
        m = torch.stack([
            torch.from_numpy(self._nearest(self.relus,
                                           h[p].detach().numpy())[0] > 0)
            for p in range(h.shape[0])])
        self.relu_flips += int((m != (h > 0)).sum())
        self.relu_elements += m.numel()
        return torch.where(m, h, h.new_zeros(()))


CASES = [(2, "pipelined", "bfloat16", False), (2, "pipelined", "float8",
                                               False),
         (2, "pipelined", "float8", True), (4, "corr", "bfloat16", False),
         (4, "corr", "float8", False), (4, "corr", "float8", True)]


@pytest.mark.parametrize("P,mode,rem,amax", CASES,
                         ids=[f"P{c[0]}-{c[1]}-{c[2]}{'-amax' * c[3]}"
                              for c in CASES])
def test_transport_trainer_matches_jax(monkeypatch, P, mode, rem, amax):
    tap = JaxTap(monkeypatch)
    jt, pt = make_bucket_pair(P, mode, rem_dtype=rem, rem_amax=amax)
    pt.act = tap.act
    shares = []

    def share_jax_values(e):
        jax.effects_barrier()
        pt.share = TransportShare(source=tap.source)
        shares.append(pt.share)

    check_bucket_against_jax(jt, pt, before_port_epoch=share_jax_values)
    flips = sum(s.flips for s in shares)
    elements = sum(s.elements for s in shares)
    # every record used: 2 graph layers under use_pp, a cast forward and
    # backward each, and 2 relus, for every part and epoch
    assert elements > 0 and not tap.records and not tap.relus
    assert flips <= FLIP_FRAC * elements, (flips, elements)
    assert tap.relu_flips <= FLIP_FRAC * tap.relu_elements, (
        tap.relu_flips, tap.relu_elements)

    # the port's own casts and relus: losses only
    jt2, own = make_bucket_pair(P, mode, rem_dtype=rem, rem_amax=amax)
    jl = [jt2.train_epoch(e) for e in range(10)]
    pl = [own.train_epoch(e) for e in range(10)]
    np.testing.assert_allclose(pl, jl, rtol=OWN_LOSS_RTOL)
