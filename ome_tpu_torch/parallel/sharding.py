"""Parameter sharding rules (port of ome_tpu/parallel/sharding.py).

Maps the llama param tree onto the tp ranks, as the reference maps it
onto the (dp, pp, tp) mesh:
  * attention heads, MLP hidden, vocab         -> tp (Megatron layout)
  * MoE expert dim                             -> tp (expert parallelism
    over the same group, DeepSpeed-MoE style)
  * stacked-layer leading dim (pipeline mode)  -> pp

The rule tables are the reference's, as data. A spec here is a tuple
with one entry per leading dim ("tp", "pp" or None; dims past its end
are whole), the reference's PartitionSpec without jax. Where the
reference puts a leaf on the mesh (`jax.device_put` with a
NamedSharding), `shard_params(params, rank, tp)` keeps rank `rank`'s
slice of each leaf along its "tp" dim, so a rank holds only its own
bytes; the collectives GSPMD inserts in the reference are the port's
`parallel/comm.py`.

A leaf the rules do not name is refused by name (`UnshardableLeaf`),
where the reference raises a bare KeyError: Phi-3.5-MoE's LayerNorm
biases and gpt-oss's o_proj bias, sinks and expert biases have no rule
in either package.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..models.quant import QTensor

Spec = Tuple[Optional[str], ...]

# spec for each stacked-layer leaf, WITHOUT the leading layer/stage dims.
_LAYER_RULES: Dict[str, Spec] = {
    "attn_norm": (None,),
    "mlp_norm": (None,),
    "q_norm": (None,),
    "k_norm": (None,),
    "attn_post_norm": (None,),   # gemma2 post-block norms
    "mlp_post_norm": (None,),
    "bq": ("tp", None),          # qwen2 attention biases: heads on tp
    "bk": ("tp", None),          # [H|K, Dh] — follows wq/wk/wv
    "bv": ("tp", None),
    "wq": (None, "tp", None),      # [D, H, Dh]
    "wk": (None, "tp", None),
    "wv": (None, "tp", None),
    "wo": ("tp", None, None),      # [H, Dh, D]
    "w_gate": (None, "tp"),        # [D, F]
    "w_up": (None, "tp"),
    "w_down": ("tp", None),        # [F, D]
    "router": (None, None),        # [D, E] replicated
    "we_gate": ("tp", None, None),  # [E, D, F] — experts sharded (EP)
    "we_up": ("tp", None, None),
    "we_down": ("tp", None, None),
    "ws_gate": (None, "tp"),        # shared experts: dense Megatron split
    "ws_up": (None, "tp"),
    "ws_down": ("tp", None),
    # MLA (models/mla.py): heads shard on tp; the latent projections
    # and the shared rope key are replicated (they are tiny, and the
    # latent cache itself is replicated — kv_cache_heads == 1)
    "wq_a": (None, None),           # [D, q_rank]
    "q_a_norm": (None,),
    "wq_b": (None, "tp", None),     # [q_rank, H, qk_dim]
    "wkv_a": (None, None),          # [D, r + rope]
    "kv_a_norm": (None,),
    "w_uk": ("tp", None, None),     # [H, nope, r]
    "w_uv": ("tp", None, None),     # [H, r, v_dim]
    "router_bias": (None,),
}

_TOP_RULES: Dict[str, Spec] = {
    "embed": ("tp", None),         # vocab-sharded
    "final_norm": (None,),
    "lm_head": (None, "tp"),
}

_BLOCKS = ("layers", "dense_layers")


class UnshardableLeaf(KeyError):
    """A parameter leaf no sharding rule names: the tree cannot be
    served with tp > 1 (the reference raises KeyError at the same
    place)."""

    def __init__(self, leaf: str):
        super().__init__(leaf)
        self.leaf = leaf

    def __str__(self) -> str:
        return (f"no tensor-parallel sharding rule for parameter "
                f"{self.leaf!r} (parallel/sharding.py); this model "
                "cannot be served with --tp > 1")


def param_specs(params: Dict[str, Any], pipeline: bool = False
                ) -> Dict[str, Any]:
    """Spec tree matching `params` (reference `param_specs`).

    pipeline=True expects layer leaves reshaped to [pp, L/pp, ...] and
    shards the stage dim on "pp"; otherwise layer leaves are [L, ...].
    A leaf no rule names raises UnshardableLeaf naming it."""
    layer_prefix: Spec = ("pp", None) if pipeline else (None,)
    out: Dict[str, Any] = {}
    for name, leaf in params.items():
        if name in _BLOCKS:
            block = {}
            for k in leaf:
                if k not in _LAYER_RULES:
                    raise UnshardableLeaf(f"{name}.{k}")
                block[k] = layer_prefix + _LAYER_RULES[k]
            out[name] = block
        else:
            if name not in _TOP_RULES:
                raise UnshardableLeaf(name)
            out[name] = _TOP_RULES[name]
    return out


def tp_dim(spec: Spec) -> Optional[int]:
    """The dim a spec shards on "tp", or None (replicated)."""
    return spec.index("tp") if "tp" in spec else None


def shard_slice(t: torch.Tensor, dim: Optional[int], rank: int, tp: int,
                name: str = "") -> torch.Tensor:
    """Rank `rank`'s slice of `t` along `dim`, in storage of its own (the
    whole tensor can be freed). A dim that tp does not divide raises,
    as the reference's placement does."""
    if dim is None or tp == 1:
        return t
    n = t.shape[dim]
    if n % tp:
        raise ValueError(
            f"tp={tp} must divide dim {dim} of parameter {name or '?'} "
            f"(size {n})")
    part = t.narrow(dim, rank * (n // tp), n // tp)
    return part.clone(memory_format=torch.contiguous_format)


def scale_spec(leaf: QTensor, spec: Spec) -> Spec:
    """The spec of a QTensor's scale plane (reference `shard_params`):
    the weight's spec with size-1 (contraction) dims whole, and for
    int4 the group axis whole too."""
    padded = tuple(spec) + (None,) * 8
    gaxis = leaf.axis % leaf.q.dim() if leaf.bits == 4 else None
    return tuple(None if dim == 1 or i == gaxis else ax
                 for i, (ax, dim) in enumerate(zip(padded, leaf.s.shape)))


def shard_leaf(leaf, spec: Spec, rank: int, tp: int, name: str = ""):
    """Rank `rank`'s part of one leaf under `spec`. A QTensor's payload
    shards like the weight; its scale keeps size-1 dims (and int4's
    group axis) whole. int4 leaves pack along a contraction dim that is
    never the tp dim (quantize_params keeps w_down/ws_down/wo at int8),
    so the payload's spec carries over."""
    if isinstance(leaf, QTensor):
        if leaf.bits == 4 and tp_dim(spec) == leaf.axis % leaf.q.dim():
            raise ValueError(f"int4 parameter {name} packs along its "
                             "tensor-parallel dim")
        return QTensor(
            q=shard_slice(leaf.q, tp_dim(spec), rank, tp, name),
            s=shard_slice(leaf.s, tp_dim(scale_spec(leaf, spec)), rank,
                          tp, name),
            bits=leaf.bits, axis=leaf.axis)
    return shard_slice(leaf, tp_dim(spec), rank, tp, name)


def shard_params(params: Dict[str, Any], rank: int, tp: int,
                 pipeline: bool = False) -> Dict[str, Any]:
    """Rank `rank`'s slices of every leaf (reference `shard_params`,
    which puts the tree on the mesh instead). A new tree; the input is
    not modified."""
    specs = param_specs(params, pipeline)
    out: Dict[str, Any] = {}
    for name, leaf in params.items():
        if name in _BLOCKS:
            out[name] = {k: shard_leaf(v, specs[name][k], rank, tp,
                                       f"{name}.{k}")
                         for k, v in leaf.items()}
        else:
            out[name] = shard_leaf(leaf, specs[name], rank, tp, name)
    return out


def leaf_spec(block: Optional[str], name: str) -> Spec:
    """The spec of one leaf by its place in the tree (`block` "layers"
    or "dense_layers" for a stacked leaf, None for a top-level one),
    with the leading layer dim; UnshardableLeaf when no rule names it."""
    if block is None:
        if name not in _TOP_RULES:
            raise UnshardableLeaf(name)
        return _TOP_RULES[name]
    if name not in _LAYER_RULES:
        raise UnshardableLeaf(f"{block}.{name}")
    return (None,) + _LAYER_RULES[name]


def _reshape(leaf, fn):
    if isinstance(leaf, QTensor):
        return QTensor(q=fn(leaf.q), s=fn(leaf.s), bits=leaf.bits,
                       axis=leaf.axis)
    return fn(leaf)


def stack_to_stages(params: Dict[str, Any], pp: int) -> Dict[str, Any]:
    """Reshape stacked layer leaves [L, ...] -> [pp, L/pp, ...]."""
    out = dict(params)
    out["layers"] = {
        k: _reshape(v, lambda x: x.reshape(pp, x.shape[0] // pp,
                                           *x.shape[1:]))
        for k, v in params["layers"].items()}
    return out


def unstack_stages(params: Dict[str, Any]) -> Dict[str, Any]:
    """The inverse of `stack_to_stages`."""
    out = dict(params)
    out["layers"] = {
        k: _reshape(v, lambda x: x.reshape(x.shape[0] * x.shape[1],
                                           *x.shape[2:]))
        for k, v in params["layers"].items()}
    return out


def split_contraction() -> frozenset:
    """The stacked leaves whose tp dim is one their product contracts
    (wo over its heads, w_down and ws_down over the hidden dim): a rank
    quantizing its own slice of one must take its scales' max over the
    ranks (`quant.quantize_params(split_contraction=...)`)."""
    from ..models.quant import _LAYER_CONTRACT
    return frozenset(
        k for k, axes in _LAYER_CONTRACT.items()
        if tp_dim((None,) + _LAYER_RULES[k]) in axes)
