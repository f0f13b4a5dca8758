"""GraphSAGE for the serving path — port of ``pipegcn_tpu/models/sage.py``
(``ModelConfig``, ``init_params``, ``_layer_norm``, and ``forward`` on its
``training=False, halo_eval=True`` path).

Parameters are a plain dict of tensors with the JAX pytree's layout,
``{'layers': [...], 'norms': [...]}``: the use_pp first layer holds
``{'w', 'b'}``, other graph layers ``{'w1', 'b1', 'w2', 'b2'}``, norms
``{'scale', 'bias'}``; weights are stored ``[in, out]`` (right-multiply).
Activations are stacked over parts, ``[P, rows, F]``.

Only what this slice runs is ported: graphsage, LayerNorm or no norm,
float32 compute. Training, dropout, GCN, GAT, BatchNorm, the dense tail
and bfloat16 compute raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..ops.spmm import spmm_mean

Params = Dict[str, List[Dict[str, torch.Tensor]]]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The fields of ``pipegcn_tpu.models.sage.ModelConfig`` this slice
    reads; anything it cannot run is refused at construction."""

    layer_sizes: Tuple[int, ...]   # [in_feat, hidden..., n_class]
    model: str = "graphsage"
    n_linear: int = 0
    use_pp: bool = False
    norm: Optional[str] = "layer"  # 'layer' | None
    dtype: str = "float32"

    def __post_init__(self):
        if self.model != "graphsage":
            raise NotImplementedError(
                f"model {self.model!r} waits for a later slice of the "
                "port (graphsage only)")
        if self.n_linear:
            raise NotImplementedError("the dense tail (n_linear > 0) "
                                      "waits for a later slice")
        if self.norm not in ("layer", None):
            raise NotImplementedError(
                f"norm {self.norm!r} waits for a later slice (layer | None)")
        if self.dtype != "float32":
            raise NotImplementedError(
                f"dtype {self.dtype!r} waits for a later slice (float32)")

    @property
    def n_layers(self) -> int:
        return len(self.layer_sizes) - 1


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: torch.device) -> Params:
    """Fresh parameters with the shapes and U(-1/sqrt(fan_in),
    +1/sqrt(fan_in)) bounds of the JAX ``init_params`` (its use_pp layer's
    fan-in is the 2F concat). Drawn on the CPU from ``generator`` — the
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


def _dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x, w) + b


def forward(params: Params, cfg: ModelConfig, h: torch.Tensor,
            indptr: torch.Tensor, src: torch.Tensor, in_deg: torch.Tensor,
            *, comm_update: Callable[[int, torch.Tensor], torch.Tensor],
            spmm_fn: Callable[..., torch.Tensor] = spmm_mean
            ) -> torch.Tensor:
    """Sharded eval of the GraphSAGE stack over P stacked parts; returns
    logits ``[P, n_max, n_class]`` (f32).

    ``h`` is the per-part input ``[P, n_max, F]`` (under use_pp the
    precomputed ``[feat, mean_neigh]`` concat, so layer 0 is a plain
    dense layer). ``comm_update(i, h)`` returns graph layer i's
    aggregation source buffer ``[P, n_max + H, F]`` (inner rows then halo
    rows); it is skipped for layer 0 under use_pp. ``spmm_fn`` defaults to
    the kernel wrapper; a caller holding the kernels against their plain
    versions passes the plain one. Mirrors the JAX ``forward`` with
    ``training=False, halo_eval=True``: no dropout, f32 logits,
    LayerNorm + relu between layers."""
    n_dst = h.shape[1]
    for i in range(cfg.n_layers):
        lp = params["layers"][i]
        if cfg.use_pp and i == 0:
            h = _dense(h, lp["w"], lp["b"])
        else:
            fbuf = comm_update(i, h)
            ah = spmm_fn(fbuf, indptr, src, in_deg)
            h = (_dense(fbuf[:, :n_dst], lp["w1"], lp["b1"])
                 + _dense(ah, lp["w2"], lp["b2"]))
        if i < cfg.n_layers - 1:
            if cfg.norm == "layer":
                nrm = params["norms"][i]
                h = _layer_norm(h, nrm["scale"], nrm["bias"])
            h = torch.relu(h)
    return h
