"""Weight-only quantization (int8 per-channel, fp8 per-channel, int4
groupwise) for serving; port of ome_tpu/models/quant.py.

Decode reads every weight once per step, so fewer weight bytes is a
shorter step wherever the step is bound by device memory. Symmetric
per-output-channel int8 (or float8_e4m3fn) stores one byte per weight;
groupwise int4 stores half a byte plus one f32 scale per (group, output
channel).

int4 packing follows the reference exactly, because the kernel
(`ops/int4_matmul.py`, B4) and the tests depend on the bytes: two
nibbles per int8 byte, paired as [first half | second half] of the
WHOLE packing axis — byte j holds row j in its low nibble and row K/2+j
in its high nibble, both two's-complement — so the unpack is two
arithmetic shifts and one concatenate. Scales are per (group x output
channel), groups contiguous along the axis.

`quantize_params` gives the reference's bytes and scales bit for bit:
the same amax, the same f32 division (not a product with 1/127: the
reference quantizes eagerly, outside any compiled program), round half
to even, clip. It quantizes a stacked [L, ...] leaf one layer slab at a
time, which gives the same result (no contraction axis spans layers)
with one layer's fp32 temporaries instead of the whole leaf's.

`QTensor` is a plain dataclass here (the reference registers a pytree);
`t[i]` slices the leading layer axis, which keeps the negative `axis`
valid, as `lax.scan` slicing does in the reference.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Dict, Optional

import torch

Params = Dict[str, Any]


@dataclasses.dataclass
class QTensor:
    """Quantized weight + broadcastable f32 scale.

    bits=8: `q` int8 (or float8_e4m3fn) in the original shape, `s` with
    contraction dims of size 1 (per-output-channel).
    bits=4: `q` int8 carrying two nibbles, with the packing axis
    halved; `s` with the packing axis sized n_groups and other
    contraction dims 1.
    `axis` (bits=4: the packing axis) is stored NEGATIVE, as an offset
    from the last dim, so it survives slicing off leading dims.
    """

    q: torch.Tensor
    s: torch.Tensor
    bits: int = 8
    axis: int = -1

    def dequant(self, dtype=torch.bfloat16) -> torch.Tensor:
        """The weight in `dtype`: each fp32 product of a value and its
        scale rounded once to `dtype`, as in the reference, and written
        straight into the output, so that on a card no fp32 copy of the
        weight is made (a 256-expert DeepSeek-V3 stack would take
        twice its bf16 size in one)."""
        out = torch.empty(self.shape, dtype=dtype, device=self.q.device)
        if self.bits == 4:
            return _unpack4(self.q, self.s, self.axis, out)
        # float8 does not promote with fp32: it is widened first
        q = self.q if self.q.dtype == torch.int8 else self.q.float()
        return torch.mul(q, self.s.float(), out=out)

    def take(self, idx: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
        """Row gather (embedding lookup) without a full dequant."""
        idx = idx.long()
        rows, scales = self.q[idx], self.s[idx]
        if self.bits == 8:
            return (rows.float() * scales).to(dtype)
        return _unpack4(rows, scales, self.axis).to(dtype)

    def __getitem__(self, i) -> "QTensor":
        """Slice of the leading (layer) axis of both planes."""
        return QTensor(q=self.q[i], s=self.s[i], bits=self.bits,
                       axis=self.axis)

    @property
    def device(self) -> torch.device:
        return self.q.device

    @property
    def shape(self):
        sh = list(self.q.shape)
        if self.bits == 4:
            sh[self.axis] *= 2
        return tuple(sh)

    @property
    def size(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n


def _unpack4(q: torch.Tensor, s: torch.Tensor, axis: int,
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dequantize half-packed int4: q [..., K/2, ...] -> [..., K, ...]
    into `out` (fp32 when None).

    Low nibble of byte j is row j, high nibble row K/2 + j, both sign-
    extended (an int8 left shift by 4 then an arithmetic right shift,
    and an arithmetic right shift by 4); s has n_groups contiguous
    groups along the axis. Each product is taken in fp32 and rounded
    once to out's dtype."""
    axis = axis % q.dim()
    n_groups = s.shape[axis]
    half = q.shape[axis]
    K = 2 * half
    shape = tuple(q.shape[:axis]) + (K,) + tuple(q.shape[axis + 1:])
    if out is None:
        out = torch.empty(shape, dtype=torch.float32, device=q.device)
    nib = torch.empty(shape, dtype=torch.int8, device=q.device)
    torch.bitwise_right_shift(torch.bitwise_left_shift(q, 4), 4,
                              out=nib.narrow(axis, 0, half))
    torch.bitwise_right_shift(q, 4, out=nib.narrow(axis, half, half))
    groups = (n_groups, K // n_groups)
    torch.mul(nib.unflatten(axis, groups), s.float().unsqueeze(axis + 1),
              out=out.unflatten(axis, groups))
    return out


def _amax(w32: torch.Tensor, axes) -> torch.Tensor:
    return w32.abs().amax(dim=tuple(axes), keepdim=True)


def quantize_tensor(w: torch.Tensor, contract_axes) -> QTensor:
    """Per-output-channel symmetric int8: scales span `contract_axes`
    (the dims the matmul sums over)."""
    w32 = w.float()
    s = _amax(w32, contract_axes).clamp_min(1e-8) / 127.0
    q = torch.round(w32 / s).clamp(-127, 127).to(torch.int8)
    return QTensor(q=q, s=s, bits=8)


def quantize_tensor_fp8(w: torch.Tensor, contract_axes) -> QTensor:
    """Per-output-channel scaled float8_e4m3fn (one byte per weight, a
    floating 3-bit mantissa), scaled to the format's finite max 448."""
    w32 = w.float()
    s = _amax(w32, contract_axes).clamp_min(1e-8) / 448.0
    q = (w32 / s).to(torch.float8_e4m3fn)
    return QTensor(q=q, s=s, bits=8)


def quantize_tensor_int4(w: torch.Tensor, contract_axes,
                         group: int = 128) -> QTensor:
    """Groupwise symmetric int4, half-packed along the first
    contraction axis. Falls back to one group when the axis does not
    split evenly into even-sized groups."""
    axis = contract_axes[0]
    w32 = w.float()
    K = w32.shape[axis]
    if K % group == 0 and group % 2 == 0:
        n_groups = K // group
    elif K % 2 == 0:
        n_groups = 1  # axis too small/ragged for groups: one scale
    else:
        raise ValueError(f"int4 needs an even packing dim, got {K}")
    gsize = K // n_groups
    pre, post = tuple(w32.shape[:axis]), tuple(w32.shape[axis + 1:])
    wg = w32.reshape(pre + (n_groups, gsize) + post)
    # scales span the group slice plus the OTHER contraction dims
    other = tuple(a + 1 if a > axis else a for a in contract_axes[1:])
    s = _amax(wg, (axis + 1,) + other).clamp_min(1e-8) / 7.0
    qg = torch.round(wg / s).clamp(-7, 7).to(torch.int32)
    lo, hi = qg.reshape(pre + (K,) + post).chunk(2, dim=axis)
    # hi << 4 has zero low bits, so the OR fits an int8 exactly
    packed = ((hi << 4) | (lo & 0x0F)).to(torch.int8)
    return QTensor(q=packed, s=s.squeeze(axis + 1), bits=4,
                   axis=axis - w32.dim())


# contraction axes per stacked-layer leaf ([L, ...]; axis 0 = layer)
_LAYER_CONTRACT = {
    "wq": (1,), "wk": (1,), "wv": (1,),   # [L, D, H, Dh]: sum over D
    "wo": (2, 1),                          # [L, H, Dh, D]: sum over H,Dh
    "w_gate": (1,), "w_up": (1,),          # [L, D, F]
    "w_down": (1,),                        # [L, F, D]
    "we_gate": (2,), "we_up": (2,),        # [L, E, D, F]
    "we_down": (2,),                       # [L, E, F, D]
    "ws_gate": (1,), "ws_up": (1,), "ws_down": (1,),
    "wq_a": (1,), "wq_b": (1,), "wkv_a": (1,),
    "w_uk": (2,), "w_uv": (2,),
}
_TOP_CONTRACT = {
    "embed": (1,),     # per-ROW scales: rows are both lookup outputs
    "lm_head": (0,),   # [D, V]: sum over D
}
# int4 mode keeps these at int8 (the reference's reasons: the down
# projections' pack axis is the tensor-parallel row dim, and wo's pack
# axis sits under the head dim, so its packed rows do not flatten
# contiguously for the kernel)
_INT8_ONLY = {"w_down", "ws_down", "wo"}


def _per_layer(fn, v: torch.Tensor, axes) -> QTensor:
    """`fn(v, axes)` on a stacked [L, ...] leaf, one layer slab at a
    time, into preallocated planes: the same bytes as the whole-leaf
    call, with one layer's temporaries. A slab whose own leading axis
    is not a contraction axis (an expert stack [E, ...], MLA's per-head
    w_uk / w_uv) is cut again along that axis, for the same reason and
    with the same bytes: no scale spans it."""
    inner = tuple(a - 1 for a in axes)

    def one(slab):
        if 0 not in inner and slab.dim() >= 3:
            return _per_layer(fn, slab, inner)
        return fn(slab, inner)
    first = one(v[0])
    q = torch.empty((v.shape[0],) + tuple(first.q.shape),
                    dtype=first.q.dtype, device=v.device)
    s = torch.empty((v.shape[0],) + tuple(first.s.shape),
                    dtype=first.s.dtype, device=v.device)
    q[0], s[0] = first.q, first.s
    for i in range(1, v.shape[0]):
        qt = one(v[i])
        q[i], s[i] = qt.q, qt.s
    return QTensor(q=q, s=s, bits=first.bits, axis=first.axis)


def quantize_params(params: Params, mode: str = "int8",
                    group: int = 128, consume: bool = False) -> Params:
    """Quantize the big matmul weights (the experts of a MoE layer
    included, over D); norms, biases and the MoE router stay full
    precision, as in the reference (tiny, and routing is
    precision-sensitive).

    mode="int8": per-output-channel symmetric int8 everywhere.
    mode="fp8": per-output-channel scaled float8_e4m3fn everywhere.
    mode="int4": groupwise int4 for the layer matmuls; embed/lm_head
    stay int8, and so do w_down/ws_down/wo (`_INT8_ONLY`).
    Returns a new tree. The input tree is not modified unless
    `consume`: then each leaf is removed from it once quantized, so a
    caller that holds no other reference frees the full-precision
    weights leaf by leaf (device memory peaks near the larger of the
    two trees, not their sum)."""
    if mode not in ("int8", "int4", "fp8"):
        raise ValueError(f"unknown quantization mode {mode!r}")
    int4 = mode == "int4"
    base_q = quantize_tensor_fp8 if mode == "fp8" else quantize_tensor
    log = logging.getLogger("ome.models.quant")

    def int4_q(w, axes):
        return quantize_tensor_int4(w, axes, group=group)

    def q_layer(k: str, v):
        if k not in _LAYER_CONTRACT:
            return v
        axes = _LAYER_CONTRACT[k]
        if int4 and k not in _INT8_ONLY:
            try:
                return _per_layer(int4_q, v, axes)
            except ValueError as e:
                log.info("int4: %s falls back to int8 (%s)", k, e)
                return _per_layer(quantize_tensor, v, axes)
        return _per_layer(base_q, v, axes)

    out: Params = {}
    for name in list(params):
        leaf = params[name]
        if name in ("layers", "dense_layers"):
            out[name] = {}
            for k in list(leaf):
                out[name][k] = q_layer(k, leaf[k])
                if consume:
                    del leaf[k]
        elif name in _TOP_CONTRACT:
            out[name] = base_q(leaf, _TOP_CONTRACT[name])
        else:
            out[name] = leaf
        if consume:
            del params[name]
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def quantized_bytes(params: Params) -> int:
    """Weight bytes per full read (a decode step's weight traffic)."""
    total = 0
    for leaf in _leaves(params):
        if isinstance(leaf, QTensor):
            total += leaf.q.numel() * leaf.q.element_size() \
                + leaf.s.numel() * 4
        else:
            total += leaf.numel() * leaf.element_size()
    return total
