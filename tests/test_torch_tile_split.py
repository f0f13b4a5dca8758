"""K16's pre-split of f32 rows (``ops/block_spmm.py`` ``tile_split_plain``,
the plain version of ``csrc/block_tma.cu``'s pre-pass) and K11's per-part
amax semantics (``ops/bucket_spmm.py`` ``part_amax_plain``, the plain
version of ``csrc/transport_cast.cu``'s redesigned kernel), on the CPU.

The split. Each f32 row is written once as three bf16 planes, hi, mid and
lo, each the truncation of what the terms before it leave, each carrying
x's sign: ``hi + mid + lo == x`` bit for bit wherever |x| >= 2**-110 (24
significant bits in three 8-bit terms, each exact in bf16) and at +-0;
below 2**-110 the terms hold x truncated toward zero to a multiple of
2**-133, bf16's least subnormal, which no sum of bf16 values undercuts.
The planes are padded to a multiple of 64 columns with zeros (a TMA box).
Through the plain tile products the three planes give the f32 rows' sums
within 1e-5 of the sum of the terms' magnitudes (the products' own
tolerance, ``BLOCK_SUM_RTOL`` on the card), and those are held against
JAX's grouped forward in ``tests/test_torch_block_group.py``.

The amax. K11 keeps the per-element true division of the ``deg`` form;
its plain version is held bit for bit against JAX's expression
(``pipegcn_tpu/ops/bucket_spmm.py:477``, ``max |x|`` in f32, per part as
JAX's vmap runs it) over a bit-pattern sweep with NaN, +-inf, -0.0 and
subnormal inputs and zero, infinite and NaN degrees."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from pipegcn_tpu_torch.ops import block_spmm as pblk
from pipegcn_tpu_torch.ops import bucket_spmm as pbs
from test_torch_train import one_torch_thread

pytestmark = pytest.mark.torch

__all__ = ["one_torch_thread"]  # the module-wide single-thread fixture

TINY = 2.0 ** -110  # the least |x| the three bf16 terms hold exactly
BF16_LEAST = 2.0 ** -133  # bf16's least subnormal


def _sum(planes: torch.Tensor) -> torch.Tensor:
    """hi + mid + lo in f32, in that order, over the planes' first F
    columns (the caller slices)."""
    p = planes.float()
    return (p[0] + p[1]) + p[2]


def _truncated(x: np.ndarray) -> np.ndarray:
    """x truncated toward zero to a multiple of 2**-133 (exact in f64)."""
    xd = x.astype(np.float64)
    return (np.trunc(xd / BF16_LEAST) * BF16_LEAST).astype(np.float32)


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.uint32)


@pytest.mark.parametrize("F,want", [(1, 64), (5, 64), (64, 64), (65, 128),
                                    (256, 256), (602, 640)])
def test_split_width_is_a_whole_tma_box(F, want):
    assert pblk.split_width(F) == want


@pytest.mark.parametrize("F", [256, 602])
@pytest.mark.parametrize("scale", [1.0, 1e-25, 1e30])
def test_split_of_random_rows_is_exact(F, scale):
    """Random rows: three bf16 planes, the pad columns zero, hi + mid + lo
    equal to x bit for bit."""
    rng = np.random.default_rng(F)
    x = (rng.standard_normal((2, 37, F)) * scale).astype(np.float32)
    assert (np.abs(x) >= TINY).all()
    sp = pblk.tile_split_plain(torch.from_numpy(x))
    assert sp.dtype == torch.bfloat16 and sp.shape == (3, 2, 37,
                                                       pblk.split_width(F))
    assert not bool(sp[..., F:].float().any())
    np.testing.assert_array_equal(_bits(_sum(sp)[..., :F]), _bits(x))
    # each plane is the exact truncation of the remainder: hi holds x's
    # top 16 bits, and |mid| < one bf16 ulp of hi
    np.testing.assert_array_equal(
        sp[0, ..., :F].view(torch.int16).numpy().astype(np.uint16),
        (_bits(x) >> 16).astype(np.uint16))
    hi, mid = sp[0, ..., :F].float().numpy(), sp[1, ..., :F].float().numpy()
    assert (np.abs(mid) < np.abs(hi) * 2.0 ** -7).all()


def test_split_of_signed_zeros_and_the_largest_finite():
    """+-0 split into three zeros of x's sign (the sum keeps -0); values
    at and near +-FLT_MAX split without overflow (truncation never rounds
    up to inf), the sum bit-exact."""
    near = np.arange(0x7f7f0000, 0x7f800000, 97, dtype=np.uint32)
    pats = np.concatenate([np.array([0, 0x80000000, 0x7f7fffff,
                                     0xff7fffff], np.uint32), near,
                           near | np.uint32(0x80000000)])
    pats = pats[: pats.size // 8 * 8]
    x = pats.view(np.float32).reshape(1, -1, 8)
    sp = pblk.tile_split_plain(torch.from_numpy(x.copy()))
    assert bool(torch.isfinite(sp.float()).all())
    np.testing.assert_array_equal(_bits(_sum(sp)[..., :8]), _bits(x))
    signs = sp[:, 0, 0, :2].view(torch.int16).numpy().astype(np.uint16)
    np.testing.assert_array_equal(signs, [[0, 0x8000]] * 3)


def test_split_below_two_to_minus_110_truncates_to_bf16s_least_subnormal():
    """Subnormals and normals under 2**-110: the terms' sum is x
    truncated toward zero to a multiple of 2**-133 (x itself where it is
    one); from 2**-110 up, x exactly."""
    rng = np.random.default_rng(4)
    sub = rng.integers(1, 2 ** 23, 200, dtype=np.uint32)  # f32 subnormals
    lowexp = rng.integers(1 << 23, 18 << 23, 200, dtype=np.uint32)
    edge = np.float32(TINY).view(np.uint32) + np.arange(-40, 40,
                                                         dtype=np.int64)
    pats = np.concatenate([sub, lowexp, edge.astype(np.uint32),
                           (np.arange(1, 129) << 16).astype(np.uint32)])
    pats = np.concatenate([pats, pats | np.uint32(0x80000000)])
    pats = pats[: pats.size // 16 * 16]
    x = pats.view(np.float32).reshape(2, -1, 8)
    got = _sum(pblk.tile_split_plain(torch.from_numpy(x.copy())))[..., :8]
    want = _truncated(x)
    np.testing.assert_array_equal(_bits(got) & 0x7fffffff,
                                  _bits(want) & 0x7fffffff)
    big = np.abs(x) >= TINY
    np.testing.assert_array_equal(_bits(got)[big], _bits(x)[big])
    mult = (pats & 0xffff) == 0  # multiples of 2**-133 below 2**-126
    assert mult.any()
    sub_mask = ((pats & 0x7f800000) == 0).reshape(x.shape)
    np.testing.assert_array_equal(
        _bits(got)[sub_mask & mult.reshape(x.shape)],
        _bits(x)[sub_mask & mult.reshape(x.shape)])


@settings(max_examples=200, deadline=None)
@given(st.lists(st.integers(0, 2 ** 32 - 1), min_size=8, max_size=8))
def test_split_of_any_finite_pattern(words):
    """Any finite f32 bit pattern: the sum is x's truncation to a multiple
    of 2**-133 (x itself from 2**-110 up), every term finite."""
    pats = np.array(words, np.uint32)
    pats = np.where((pats & 0x7f800000) == 0x7f800000, pats & 0x807fffff,
                    pats).astype(np.uint32)  # make the non-finite finite
    x = pats.view(np.float32).reshape(1, 1, 8)
    sp = pblk.tile_split_plain(torch.from_numpy(x.copy()))
    assert bool(torch.isfinite(sp.float()).all())
    got = _sum(sp)[..., :8].numpy()
    np.testing.assert_array_equal(np.abs(got), np.abs(_truncated(x)))
    big = np.abs(x) >= TINY
    np.testing.assert_array_equal(_bits(got)[big], _bits(x)[big])


@pytest.mark.parametrize("F", [5, 100, 256])
def test_split_of_bf16_rows_is_one_padded_plane(F):
    """bf16 rows (the bf16 mode's unaligned rows): one plane, the rows as
    they are, the pad zero; the wrapper on CPU tensors is the plain
    version."""
    rng = np.random.default_rng(F)
    x = torch.from_numpy(rng.standard_normal((2, 9, F)).astype(
        np.float32)).to(torch.bfloat16)
    sp = pblk.tile_split(x)
    assert sp.shape == (1, 2, 9, pblk.split_width(F))
    assert torch.equal(sp[0, ..., :F].view(torch.int16), x.view(torch.int16))
    assert not bool(sp[..., F:].float().any())
    assert torch.equal(pblk.tile_split(x.float()).view(torch.int16),
                       pblk.tile_split_plain(x.float()).view(torch.int16))


def test_tile_split_refuses_other_dtypes():
    with pytest.raises(ValueError):
        pblk.tile_split_plain(torch.zeros((1, 2, 3), dtype=torch.float64))


def _hand_groups(T, G, n_out, n_in, seed, enc="bits"):
    """Random union-gather tables of one part on the CPU: every group ~4
    slots of random input tiles, each (slot, tile) a block with
    probability 0.6, the pad otherwise."""
    rng = np.random.default_rng(seed)
    n_out_t, n_in_t = -(-n_out // T), -(-n_in // T)
    n_groups = -(-n_out_t // G)
    B = n_groups * 4 * G
    if enc == "bits":
        a = torch.from_numpy(rng.integers(0, 256, (1, B, T, T // 8),
                                          dtype=np.uint8))
    else:
        a = torch.from_numpy(rng.integers(0, 5, (1, B, T, T),
                                          dtype=np.int8))
    til = rng.integers(0, n_in_t, n_groups * 4)
    blk = np.where(rng.random((n_groups * 4, G)) < 0.6,
                   rng.integers(0, B, (n_groups * 4, G)), B)
    ptr = np.arange(0, n_groups * 4 + 1, 4)
    put = (lambda v: torch.tensor(np.asarray(v)[None],
                                  dtype=torch.int32))  # noqa: E731
    side = pblk.GroupSide(ptr=put(ptr), tile=put(til), blk=put(blk),
                          group=G, n_out=n_out, n_in=n_in,
                          n_out_tiles=n_out_t, transpose=False)
    return pblk.BlockTables(a=a, packed=enc == "bits", tile=T, fwd=side,
                            bwd=side, rem_fwd=None, rem_bwd=None)


@pytest.mark.parametrize("T,G,F,enc", [(32, 2, 602, "bits"),
                                       (96, 4, 5, "bits"),
                                       (64, 16, 64, "i8")])
def test_products_of_the_split_planes_give_the_f32_rows_sums(T, G, F, enc):
    """What K16 computes on the card, on the CPU: the plain grouped
    products of the three planes, summed, hold the products of the f32
    rows within 1e-5 of the sum of the terms' magnitudes; in f64 the
    planes' products sum to the rows' products exactly."""
    tb = _hand_groups(T, G, 3 * G * T - 20, 5 * T - 7, seed=T + G, enc=enc)
    rng = np.random.default_rng(T)
    x = torch.from_numpy(rng.standard_normal((1, tb.fwd.n_in, F)).astype(
        np.float32))
    sp = pblk.tile_split_plain(x)[..., :F].float()
    want = pblk.block_dense_plain(x, tb, tb.fwd)
    mag = pblk.block_dense_plain(x.abs(), tb, tb.fwd)
    parts = [pblk.block_dense_plain(sp[h], tb, tb.fwd) for h in range(3)]
    got = (parts[2] + parts[1]) + parts[0]  # lo, mid, hi: the kernel's
    assert bool((got - want).abs().le(1e-5 * mag + 1e-30).all())
    exact = sum(p.double() for p in parts)
    ref = pblk.block_dense_plain(x.double().float(), tb, tb.fwd).double()
    assert float((exact - ref).abs().max()) <= 1e-4 * float(mag.max())


def _sweep(seed):
    """f32 bit patterns: NaN, +-inf, -0.0, subnormals, random normals."""
    rng = np.random.default_rng(seed)
    pats = np.concatenate([
        np.array([0x7fc00000, 0x7f800000, 0xff800000, 0x80000000, 0, 1,
                  0x807fffff], np.uint32),
        rng.integers(0, 2 ** 32, 2 * 3 * 40 - 7, dtype=np.uint32)])
    return pats.astype(np.uint32).view(np.float32).reshape(2, 3, 40)


def _jax_amax(x, deg=None):
    """JAX's amax expression per part (bucket_spmm.py:477 under vmap)."""
    def one(v, d):
        xf = v.astype(jnp.float32)
        if d is not None:
            xf = xf / d[:, None]
        return jnp.max(jnp.abs(xf))
    if deg is None:
        return np.asarray(jax.vmap(lambda v: one(v, None))(jnp.asarray(x)))
    return np.asarray(jax.vmap(one)(jnp.asarray(x), jnp.asarray(deg)))


def _same_amax(got: torch.Tensor, want: np.ndarray):
    g = got.numpy()
    assert np.array_equal(np.isnan(g), np.isnan(want))
    ok = ~np.isnan(g)
    np.testing.assert_array_equal(g[ok].view(np.uint32),
                                  want[ok].view(np.uint32))


@pytest.mark.parametrize("with_nan", [False, True])
@pytest.mark.parametrize("src", ["f32", "bf16"])
def test_amax_sweep_matches_jax(with_nan, src):
    """The plain form on the sweep (NaN propagates; -0.0 is 0)."""
    x = _sweep(1)
    if not with_nan:
        x = np.where(np.isnan(x), np.float32(0.5), x)
    xt = torch.from_numpy(x.copy())
    xj = x
    if src == "bf16":
        xt = xt.to(torch.bfloat16)
        xj = xt.float().numpy()
    _same_amax(pbs.part_amax_plain(xt), _jax_amax(xj))


@pytest.mark.parametrize("degs", ["positive", "zero", "inf", "nan"])
def test_amax_deg_form_matches_jax(degs):
    """The deg form, x / deg per element: positive degrees, and rows of
    degree 0 (x / 0 is +-inf or NaN), +inf and NaN, with -0.0 and NaN
    inputs."""
    x = np.where(np.isinf(_sweep(2)), np.float32(3.0), _sweep(2))
    rng = np.random.default_rng(5)
    deg = rng.integers(1, 600, (2, 3)).astype(np.float32)
    special = {"positive": None, "zero": 0.0, "inf": np.inf,
               "nan": np.nan}[degs]
    if special is not None:
        deg[1, 2] = special
    got = pbs.part_amax_plain(torch.from_numpy(x.copy()),
                              torch.from_numpy(deg))
    _same_amax(got, _jax_amax(x, deg))
