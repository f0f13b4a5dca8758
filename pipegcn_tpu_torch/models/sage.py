"""The model family — port of ``pipegcn_tpu/models/sage.py``
(``ModelConfig``, ``init_params``, ``_layer_norm``, ``_dropout``,
``_gat_layer`` and ``forward`` on its training, ``halo_eval`` and
full-graph eval (``eval_pp_agg``) paths) for GraphSAGE, GCN and GAT.

Parameters are a plain dict of tensors with the JAX pytree's layout,
``{'layers': [...], 'norms': [...]}``: the use_pp first layer holds
``{'w', 'b'}``, other GraphSAGE layers ``{'w1', 'b1', 'w2', 'b2'}``, GCN
layers ``{'w', 'b'}``, GAT layers ``{'w', 'b', 'a_src', 'a_dst'}``, norms
``{'scale', 'bias'}``; weights are stored ``[in, out]`` (right-multiply).
Activations are stacked over parts, ``[P, rows, F]``.

Only what the ported slices run is here: LayerNorm or no norm, float32
or bfloat16 compute, 32-bit dropout masks, the raw CSR aggregation, the
bucket tables with their narrowed gather transport (GraphSAGE and GCN;
GAT's attention kernels take the same transport) and the block-dense
tiles, per-tile pair lists (``block_group = 1``) or union-gather groups
(``block_group > 1``). BatchNorm, the dense tail, 8-bit dropout masks and
the ``auto`` tuner raise ``NotImplementedError`` naming their ROADMAP
item.

bfloat16 compute is the JAX package's (``ModelConfig.compute_dtype``,
``forward``'s ``dense``): activations, halo rows and aggregation inputs
are bf16; parameters, LayerNorm statistics, aggregation sums, attention
logits and statistics, the logits layer's output and the loss stay f32.
Hidden dense layers multiply bf16 by the bf16-cast weight into bf16 (a
product ``round_bf16`` of the f32 sum) and add the bf16-cast bias in
bf16; the logits layer takes the same bf16 operands into an f32 product
(products of two bf16 values are exact in f32), never rounded to bf16.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..ops.gat import gat_attention
from ..ops.spmm import spmm_mean

Params = Dict[str, List[Dict[str, torch.Tensor]]]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The fields of ``pipegcn_tpu.models.sage.ModelConfig`` the port
    reads; anything it cannot run is refused at construction."""

    layer_sizes: Tuple[int, ...]   # [in_feat, hidden..., n_class]
    model: str = "graphsage"       # 'graphsage' | 'gcn' | 'gat'
    n_heads: int = 4               # GAT attention heads
    leaky_slope: float = 0.2       # GAT LeakyReLU slope
    n_linear: int = 0
    use_pp: bool = False
    norm: Optional[str] = "layer"  # 'layer' | None
    dropout: float = 0.5
    train_size: int = 0            # global n_train (informational here)
    dropout_bits: int = 32
    dtype: str = "float32"
    # 'xla' | 'bucket' | 'block' | 'auto', as the JAX package; gat runs
    # its attention kernels for xla/bucket/auto (the bucket tables are a
    # TPU layout of the same function); graphsage and gcn aggregate by
    # CSR (K1/K3) under xla, through the bucket tables (K9) under bucket
    # and through the dense tiles (K12/K13) plus the bucket remainder
    # under block
    spmm_impl: str = "xla"
    block_tile: int = 256            # dense-tile edge for spmm_impl='block'
    # minimum edges for a (dst, src) tile to go dense; None = the
    # read-cost break-even tile*tile/n_feat (ops/block_spmm.BlockPlan)
    block_nnz: Optional[int] = None
    # union-gather group of the block kernel's dense path; 1 = per-tile
    # pair lists, > 1 = that many consecutive tiles share one gathered
    # union of source tiles
    block_group: int = 1
    # the bucket path's gather transport (ops/bucket_spmm): None |
    # 'bfloat16' | 'float8' (e4m3 activations, e5m2 cotangents); a no-op
    # under xla, as in JAX, whose raw-edge path has no transport
    rem_dtype: Optional[str] = None
    rem_amax: bool = False  # per-part power-of-two fp8 scale (K11)
    bucket_merge: int = 0   # merge ladder rungs narrower than this

    def __post_init__(self):
        if self.model not in ("graphsage", "gcn", "gat"):
            raise ValueError(f"unknown model: {self.model}")
        if self.spmm_impl not in ("xla", "bucket", "block", "auto"):
            raise ValueError(f"unknown spmm_impl: {self.spmm_impl}")
        if self.rem_dtype in ("", "none"):
            object.__setattr__(self, "rem_dtype", None)
        if self.rem_dtype not in (None, "float8", "bfloat16"):
            raise ValueError(f"unknown rem_dtype: {self.rem_dtype!r} "
                             "(none | bfloat16 | float8)")
        if self.bucket_merge < 0:
            raise ValueError(
                f"bucket_merge must be >= 0, got {self.bucket_merge}")
        if self.model in ("gcn", "gat") and self.use_pp:
            raise ValueError("use_pp is a GraphSAGE-only optimization")
        if self.model == "gat":
            if self.n_heads < 1:
                raise ValueError(f"n_heads must be >= 1, got {self.n_heads}")
            if self.spmm_impl not in ("xla", "auto", "bucket"):
                raise ValueError(
                    f"spmm_impl={self.spmm_impl!r} does not apply to gat; "
                    "use 'xla', 'bucket' or 'auto'")
            for i in range(self.n_layers - 1):
                if self.layer_sizes[i + 1] % self.n_heads:
                    raise ValueError(
                        f"gat hidden width {self.layer_sizes[i + 1]} not "
                        f"divisible by n_heads={self.n_heads}")
        elif self.spmm_impl == "auto":
            raise NotImplementedError(
                f"spmm_impl='auto' for {self.model} (the measured tuner) "
                "waits for ROADMAP A6; pass xla, bucket or block")
        if self.n_linear:
            raise NotImplementedError("the dense tail (n_linear > 0) "
                                      "waits for ROADMAP A5")
        if self.norm not in ("layer", None):
            raise NotImplementedError(
                f"norm {self.norm!r} (SyncBN) waits for ROADMAP A5 "
                "(layer | None)")
        if self.dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown dtype: {self.dtype}")
        if self.dropout_bits != 32:
            raise NotImplementedError(
                "8-bit dropout masks (dropout_bits=8) wait for ROADMAP A6")
        if not 0.0 <= self.dropout < 1.0:
            raise ValueError(f"dropout must be in [0, 1), got "
                             f"{self.dropout}")

    @property
    def n_layers(self) -> int:
        return len(self.layer_sizes) - 1

    @property
    def compute_dtype(self) -> torch.dtype:
        """The activations' dtype (the JAX ``compute_dtype``)."""
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: torch.device) -> Params:
    """Fresh parameters with the shapes and U(-1/sqrt(fan_in),
    +1/sqrt(fan_in)) bounds of the JAX ``init_params`` (its use_pp layer's
    fan-in is the 2F concat; GAT's attention vectors U(-1/sqrt(dh),
    +1/sqrt(dh))). Drawn on the CPU from ``generator`` — the
    numbers differ from JAX's, which torch cannot reproduce — then moved
    to ``device``."""

    def uniform(shape, bound):
        t = torch.empty(shape, dtype=torch.float32)
        return t.uniform_(-bound, bound, generator=generator).to(device)

    layers, norms = [], []
    for i in range(cfg.n_layers):
        d_in, d_out = cfg.layer_sizes[i], cfg.layer_sizes[i + 1]
        if cfg.use_pp and i == 0:
            bound = 1.0 / (2 * d_in) ** 0.5
            layers.append({"w": uniform((2 * d_in, d_out), bound),
                           "b": uniform((d_out,), bound)})
        elif cfg.model == "gcn":
            bound = 1.0 / d_in ** 0.5
            layers.append({"w": uniform((d_in, d_out), bound),
                           "b": uniform((d_out,), bound)})
        elif cfg.model == "gat":
            # hidden layers concat H heads of d_out / H; the logits layer
            # averages H heads of d_out
            H = cfg.n_heads
            dh = d_out if i == cfg.n_layers - 1 else d_out // H
            bound = 1.0 / d_in ** 0.5
            layers.append({"w": uniform((d_in, H * dh), bound),
                           "b": uniform((d_out,), bound),
                           "a_src": uniform((H, dh), 1.0 / dh ** 0.5),
                           "a_dst": uniform((H, dh), 1.0 / dh ** 0.5)})
        else:
            bound = 1.0 / d_in ** 0.5
            layers.append({"w1": uniform((d_in, d_out), bound),
                           "b1": uniform((d_out,), bound),
                           "w2": uniform((d_in, d_out), bound),
                           "b2": uniform((d_out,), bound)})
        if i < cfg.n_layers - 1 and cfg.norm is not None:
            norms.append({"scale": torch.ones(d_out, device=device),
                          "bias": torch.zeros(d_out, device=device)})
    return {"layers": layers, "norms": norms}


def _layer_norm(h: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
    # statistics in f32, with the JAX package's op order
    hf = h.float()
    mu = hf.mean(dim=-1, keepdim=True)
    var = ((hf - mu) ** 2).mean(dim=-1, keepdim=True)
    out = (hf - mu) * torch.rsqrt(var + eps) * scale + bias
    return out.to(h.dtype)


def _matmul(x: torch.Tensor, w: torch.Tensor,
            out_dtype: torch.dtype) -> torch.Tensor:
    """``x @ w`` with the f32 weight cast to x's dtype at use (the JAX
    ``dense``): into x's dtype, or, where ``out_dtype`` is wider (the bf16
    logits layer), into an f32 product of the same bf16 operands."""
    w = w.to(x.dtype)
    if out_dtype != x.dtype:
        x, w = x.to(out_dtype), w.to(out_dtype)
    return torch.matmul(x, w)


def _dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
           out_dtype: torch.dtype) -> torch.Tensor:
    return _matmul(x, w, out_dtype) + b.to(out_dtype)


def _dropout(gen: torch.Generator, h: torch.Tensor,
             rate: float) -> torch.Tensor:
    """Inverted dropout with an explicit generator: keep where a uniform
    draw is ``>= rate`` (keep probability ``1 - rate``), scale kept values
    by ``1 / (1 - rate)`` (the JAX ``_dropout`` 32-bit path). The bits
    differ from JAX's; the distribution is the same."""
    if rate <= 0.0:
        return h
    keep = torch.rand(h.shape, generator=gen, device=h.device) >= rate
    # in h's dtype: bf16 activations are scaled and rounded in bf16
    return torch.where(keep, h / (1.0 - rate), h.new_zeros(()))


AttnFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


def _gat_layer(fbuf: torch.Tensor, lp: Dict[str, torch.Tensor], n_dst: int,
               n_heads: int, is_last: bool, attn_fn: AttnFn) -> torch.Tensor:
    """Multi-head edge-softmax attention over P stacked parts (the JAX
    ``_gat_layer``): ``z = fbuf @ w`` as ``[P, R, H, dh]`` (in fbuf's
    dtype on hidden layers, f32 on the logits layer), the f32 logit
    halves ``el = sum(z * a_src)`` over every source row (halo included)
    and ``er = sum(z[:, :n_dst] * a_dst)``, then ``attn_fn(z, el, er)``
    ``[P, n_dst, H, dh]`` f32; heads concatenated on hidden layers,
    averaged on the logits layer, cast to the layer's output dtype (f32 on
    the logits layer, fbuf's on hidden layers), plus the bias."""
    P, R = fbuf.shape[:2]
    out_dtype = torch.float32 if is_last else fbuf.dtype
    z = _matmul(fbuf, lp["w"], out_dtype)
    dh = z.shape[-1] // n_heads
    z = z.reshape(P, R, n_heads, dh)
    zf = z.float()
    el = (zf * lp["a_src"]).sum(-1)
    er = (zf[:, :n_dst] * lp["a_dst"]).sum(-1)
    out = attn_fn(z, el, er)
    out = out.mean(dim=2) if is_last else out.reshape(P, n_dst, n_heads * dh)
    return out.to(out_dtype) + lp["b"].to(out_dtype)


def forward(params: Params, cfg: ModelConfig, h: torch.Tensor,
            indptr: torch.Tensor, src: torch.Tensor, in_deg: torch.Tensor,
            *, comm_update: Optional[Callable[[int, torch.Tensor],
                                              torch.Tensor]] = None,
            spmm_fn: Callable[..., torch.Tensor] = spmm_mean,
            attn_fn: Optional[AttnFn] = None,
            training: bool = False,
            generator: Optional[torch.Generator] = None,
            eval_pp_agg: bool = False,
            act: Callable[[torch.Tensor], torch.Tensor] = torch.relu
            ) -> torch.Tensor:
    """The model stack over P stacked parts; returns logits
    ``[P, n_dst, n_class]`` (f32).

    Partitioned (``comm_update`` given: training, or the sharded eval of
    serving): ``h`` is the per-part input ``[P, n_max, F]`` (under use_pp
    the precomputed ``[feat, mean_neigh]`` concat, so layer 0 is a plain
    dense layer). ``comm_update(i, h)`` returns graph layer i's
    aggregation source buffer ``[P, n_max + H, F]`` (inner rows then halo
    rows); it is skipped for layer 0 under use_pp. With ``training`` the
    per-layer order is comm update -> dropout (``generator``; the whole
    buffer, halo rows included) -> layer -> norm -> relu.

    Full graph (``comm_update`` None, ``training`` False): ``h`` is
    ``[1, N, F]`` and the graph its own source space; with
    ``eval_pp_agg`` the use_pp layer 0 computes ``cat(h, mean(h)) @ W``.

    ``spmm_fn(fbuf, indptr, src, in_deg)`` defaults to the kernel wrapper;
    a trainer passes one that carries the transpose CSR, and a caller
    holding the kernels against their plain versions passes the plain
    one. ``attn_fn(z, el, er)`` is GAT's attention aggregation over the
    same CSR (default: the kernel wrapper, forward only; a trainer passes
    one that carries the transpose CSR). GCN scales the rows by
    ``1 / sqrt(in_deg)`` before the exchange (so the halo ships scaled
    rows) and the mean by ``sqrt(in_deg)`` after it. ``act`` is the
    nonlinearity between layers (relu; a caller holding two runs on the
    same relu masks passes its own). Mirrors the JAX ``forward`` (``h``
    cast to the compute dtype first, f32 logits, LayerNorm + relu between
    layers)."""
    if training and cfg.dropout > 0 and generator is None:
        raise ValueError("training with dropout needs a generator")
    if training and comm_update is None:
        raise ValueError("training runs on the partitioned layout "
                         "(comm_update)")
    n_dst = h.shape[1]
    drop = training and cfg.dropout > 0
    cdt = cfg.compute_dtype
    h = h.to(cdt)
    if cfg.model == "gat" and attn_fn is None:
        def attn_fn(z, el, er):
            return gat_attention(z, el, er, indptr, src,
                                 slope=cfg.leaky_slope)
    if cfg.model == "gcn":
        d_sqrt = torch.sqrt(in_deg)[..., None]
    for i in range(cfg.n_layers):
        lp = params["layers"][i]
        pp_layer = cfg.use_pp and i == 0
        is_last = i == cfg.n_layers - 1
        out_dt = torch.float32 if is_last else cdt
        if cfg.model == "gcn":
            # src side of the symmetric normalisation, on the owner, in f32
            h = (h.float() / d_sqrt).to(cdt)
        if comm_update is not None:
            if not pp_layer:
                h = comm_update(i, h)
            if drop:
                h = _dropout(generator, h, cfg.dropout)
        if cfg.model == "gat":
            h = _gat_layer(h, lp, n_dst, cfg.n_heads, is_last, attn_fn)
        elif cfg.model == "gcn":
            ah = spmm_fn(h, indptr, src, in_deg)
            h = _dense((ah.float() * d_sqrt).to(cdt), lp["w"], lp["b"],
                       out_dt)
        elif pp_layer:
            if comm_update is None:
                if not eval_pp_agg:
                    raise ValueError(
                        "use_pp model evaluated without eval_pp_agg")
                h = torch.cat([h, spmm_fn(h, indptr, src, in_deg).to(cdt)],
                              dim=-1)
            h = _dense(h, lp["w"], lp["b"], out_dt)
        else:
            ah = spmm_fn(h, indptr, src, in_deg)
            # summed in the output dtype (bf16 on hidden layers)
            h = (_dense(h[:, :n_dst], lp["w1"], lp["b1"], out_dt)
                 + _dense(ah.to(cdt), lp["w2"], lp["b2"], out_dt))
        if i < cfg.n_layers - 1:
            if cfg.norm == "layer":
                nrm = params["norms"][i]
                h = _layer_norm(h, nrm["scale"], nrm["bias"])
            h = act(h)
    return h
