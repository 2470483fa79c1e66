"""Checkpoint IO: safetensors parsing + HF weights -> the port's param tree.

Port of ome_tpu/models/checkpoint.py. The format is an 8-byte
little-endian header length, a JSON header of
{name: {dtype, shape, data_offsets}} and the raw little-endian tensor
bytes; it is parsed here with `struct` and `json`, as the reference
does, so neither the `safetensors` package nor `ml_dtypes` is needed.
BF16 is read as uint16 and viewed as `torch.bfloat16`, F8_E4M3 as
uint8 viewed as `torch.float8_e4m3fn`. Reads are lazy and per tensor
(seek + read), and multi-shard checkpoints resolve through
model.safetensors.index.json.

`convert_llama` maps HF names and [out, in] layouts onto the stacked
[L, ...] tree of models/llama.py exactly as the reference does: every
tensor goes through float32 and is rounded once to the target dtype
(round to nearest even, as `ml_dtypes` rounds), so a tree loaded here
equals the reference's `load_params(..., device_put=False)` leaf for
leaf. `load_params` puts the leaves on an explicit device (default
CUDA, through `device.resolve_device`) one layer at a time, and refuses
what the reference's architecture gate refuses (and anything
`params.check_supported` refuses); `convert_llama` keeps the
reference's branches of every family, the MLA family (DeepSeek-V2/V3,
Kimi-K2) included.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

# safetensors dtype -> (numpy dtype of the raw bytes, torch view dtype);
# a None view keeps numpy's own dtype
_DTYPES = {
    "F64": (np.dtype(np.float64), None), "F32": (np.dtype(np.float32), None),
    "F16": (np.dtype(np.float16), None), "I64": (np.dtype(np.int64), None),
    "I32": (np.dtype(np.int32), None), "I16": (np.dtype(np.int16), None),
    "I8": (np.dtype(np.int8), None), "U8": (np.dtype(np.uint8), None),
    "BOOL": (np.dtype(np.bool_), None),
    "BF16": (np.dtype(np.uint16), torch.bfloat16),
    "F8_E4M3": (np.dtype(np.uint8), torch.float8_e4m3fn),
}
_TORCH_NAMES = {
    torch.float64: "F64", torch.float32: "F32", torch.float16: "F16",
    torch.int64: "I64", torch.int32: "I32", torch.int16: "I16",
    torch.int8: "I8", torch.uint8: "U8", torch.bool: "BOOL",
    torch.bfloat16: "BF16", torch.float8_e4m3fn: "F8_E4M3",
}


class SafetensorsError(Exception):
    pass


class SafetensorsFile:
    """Lazy reader for one .safetensors file."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            (hlen,) = struct.unpack("<Q", f.read(8))
            if hlen > 100 * 1024 * 1024:
                raise SafetensorsError(f"{path}: implausible header size")
            header = json.loads(f.read(hlen))
        self._data_start = 8 + hlen
        self._meta = header.pop("__metadata__", {})
        self._tensors: Dict[str, Tuple[str, tuple, int, int]] = {}
        for name, info in header.items():
            if info["dtype"] not in _DTYPES:
                raise SafetensorsError(
                    f"{path}: unsupported dtype {info['dtype']} for {name}")
            start, end = info["data_offsets"]
            self._tensors[name] = (info["dtype"], tuple(info["shape"]),
                                   start, end)

    def keys(self) -> List[str]:
        return list(self._tensors)

    def shape(self, name: str) -> tuple:
        return self._tensors[name][1]

    def read(self, name: str, lazy: bool = False) -> torch.Tensor:
        """The tensor's bytes as a CPU tensor of its stored dtype.
        `lazy`: a view of the file mapped into memory (copy on write),
        so only the bytes a slice of it touches are read from disk — a
        tensor-parallel rank reads its own slices."""
        st, shape, start, end = self._tensors[name]
        dt, view = _DTYPES[st]
        n = int(np.prod(shape)) if shape else 1
        if lazy and n:
            if end - start != n * dt.itemsize:
                raise SafetensorsError(
                    f"{self.path}: short read for {name}")
            mm = np.memmap(self.path, dtype=dt, mode="c",
                           offset=self._data_start + start, shape=shape)
            t = torch.from_numpy(mm)
            return t.view(view) if view is not None else t
        buf = bytearray(end - start)
        with open(self.path, "rb") as f:
            f.seek(self._data_start + start)
            got = f.readinto(buf)
        if got != len(buf) or len(buf) != n * dt.itemsize:
            raise SafetensorsError(f"{self.path}: short read for {name}")
        t = torch.from_numpy(np.frombuffer(buf, dtype=dt).reshape(shape))
        return t.view(view) if view is not None else t


def save_safetensors(path: str, tensors: Dict[str, torch.Tensor],
                     metadata: Optional[Dict[str, str]] = None) -> None:
    """Write a safetensors file (tests, chip_smoke.py, export)."""
    header: Dict[str, Any] = {}
    if metadata:
        header["__metadata__"] = metadata
    offset = 0
    blobs = []
    for name, arr in tensors.items():
        dt = _TORCH_NAMES.get(arr.dtype)
        if dt is None:
            raise SafetensorsError(f"unsupported dtype {arr.dtype}")
        t = arr.detach().cpu().contiguous()
        if t.dtype in (torch.bfloat16, torch.float8_e4m3fn):
            # numpy has neither: their bytes travel as integers
            t = t.view(torch.int16 if t.dtype == torch.bfloat16
                       else torch.uint8)
        blob = t.numpy().tobytes()
        header[name] = {"dtype": dt, "shape": list(arr.shape),
                        "data_offsets": [offset, offset + len(blob)]}
        blobs.append(blob)
        offset += len(blob)
    hbytes = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hbytes)))
        f.write(hbytes)
        for blob in blobs:
            f.write(blob)


class Checkpoint:
    """A model directory's full weight set (single- or multi-shard)."""

    def __init__(self, model_dir: str):
        self.model_dir = model_dir
        index = os.path.join(model_dir, "model.safetensors.index.json")
        self._files: Dict[str, SafetensorsFile] = {}
        self._where: Dict[str, str] = {}
        if os.path.exists(index):
            with open(index) as f:
                weight_map = json.load(f)["weight_map"]
            for name, fname in weight_map.items():
                self._where[name] = fname
        else:
            shards = sorted(fn for fn in os.listdir(model_dir)
                            if fn.endswith(".safetensors"))
            if not shards:
                raise SafetensorsError(
                    f"no .safetensors files in {model_dir}")
            for fname in shards:
                for name in self._file(fname).keys():
                    self._where[name] = fname

    def _file(self, fname: str) -> SafetensorsFile:
        if fname not in self._files:
            self._files[fname] = SafetensorsFile(
                os.path.join(self.model_dir, fname))
        return self._files[fname]

    def keys(self) -> List[str]:
        return list(self._where)

    def __contains__(self, name: str) -> bool:
        return name in self._where

    def read(self, name: str, lazy: bool = False) -> torch.Tensor:
        if name not in self._where:
            raise KeyError(name)
        return self._file(self._where[name]).read(name, lazy=lazy)


# -- HF -> llama.py param tree ---------------------------------------------


class _Stacker:
    """Fills [L, ...] stacked tensors on `device` one layer at a time
    (no 2x peak). With `shard` = (rank, tp), each layer's leaf is cut to
    the rank's slice (`parallel/sharding.py`) before it goes to the
    device; `presliced` leaves (the rank's experts only) are kept as
    given."""

    def __init__(self, num_layers: int, dtype: torch.dtype,
                 device: torch.device, block: str = "layers",
                 shard: Optional[Tuple[int, int]] = None):
        self.L = num_layers
        self.dtype = dtype
        self.device = device
        self.block = block
        self.shard = shard
        self.out: Dict[str, torch.Tensor] = {}

    def put(self, key: str, layer: int, arr: torch.Tensor,
            dtype: Optional[torch.dtype] = None,
            presliced: bool = False) -> None:
        dt = dtype or self.dtype
        if self.shard is not None and not presliced:
            from ..parallel.sharding import leaf_spec, shard_slice, tp_dim
            dim = tp_dim(leaf_spec(self.block, key))
            arr = shard_slice(arr, None if dim is None else dim - 1,
                              *self.shard, name=f"{self.block}.{key}")
        if self.shard is not None:  # widened as convert_llama's take
            arr = arr.to(self.device).float()
        if key not in self.out:
            self.out[key] = torch.empty((self.L,) + tuple(arr.shape),
                                        dtype=dt, device=self.device)
        self.out[key][layer] = arr.to(dt)


def convert_llama(ckpt: Checkpoint, cfg, dtype=None,
                  device: Union[str, torch.device] = "cpu",
                  shard: Optional[Tuple[int, int]] = None
                  ) -> Dict[str, Any]:
    """Map HF checkpoint names/layouts onto the llama.py param tree.

    HF linear weights are [out, in] (y = W x); the model's products take
    [in, out]-shaped factors, so every projection transposes, and
    attention projections reshape the fused head dim into [heads, Dh].
    Each tensor is read, moved to `device`, widened to float32 and
    rounded once to `dtype` (default bfloat16), as the reference does.

    Converts every family of the reference: separate or fused (phi3)
    q/k/v and gate/up projections, q/k/v(/o) biases, the per-head q/k
    norms (Qwen3, command-r-plus), LayerNorm biases (Phi-3.5-MoE),
    Gemma 2's post-block norms, command-r's one shared input norm,
    gpt-oss's sinks, biased router and fused experts (gate and up
    interleaved on the last dim), the head's bias, the Mixtral-style
    `block_sparse_moe` router and experts and the `mlp.gate` /
    `mlp.experts` layout stacked into [E, ...] leaves; and DeepSeek's
    MLA (`q_proj` or `q_a_proj`/`q_a_layernorm`/`q_b_proj`,
    `kv_a_proj_with_mqa`, `kv_a_layernorm`, `kv_b_proj` split into w_uk
    [H, nope, r] and w_uv [H, r, v], `o_proj` as [H, v, D]), its
    selection bias `mlp.gate.e_score_correction_bias` (fp32), its
    shared experts and its first_k_dense leading layers, which go into
    a separate `dense_layers` stack.

    `shard` = (rank, tp) gives a tensor-parallel rank's slices of every
    leaf (`parallel/sharding.py`) and reads only them: tensors are
    mapped from the files, a leaf is cut to the rank's slice before it
    is copied (a stacked expert leaf reads the rank's experts only), so
    no rank ever holds the whole tree. A leaf the rules do not name
    raises `sharding.UnshardableLeaf`.
    """
    dev = torch.device(device)
    if shard is not None and shard[1] == 1:
        shard = None
    t_dt = dtype or torch.bfloat16
    f32 = torch.float32
    L, D, H, K, Dh = (cfg.num_layers, cfg.hidden_size, cfg.num_heads,
                      cfg.num_kv_heads, cfg.head_dim)
    n_dense = cfg.first_k_dense if cfg.is_moe and cfg.first_k_dense else 0
    st_main = _Stacker(L - n_dense, t_dt, dev, "layers", shard)
    st_dense = _Stacker(n_dense, t_dt, dev, "dense_layers", shard) \
        if n_dense else None
    layernorm = cfg.norm_type == "layernorm"

    def take(name: str) -> torch.Tensor:
        if name not in ckpt and name.startswith("model."):
            # bare AutoModel checkpoints (MistralModel/Qwen2Model
            # embedding repos) drop the "model." prefix
            name = name[len("model."):]
        if shard is not None:
            # mapped, in its stored dtype: the rank's slice is cut (and
            # widened) by _Stacker.put / top() before anything is read
            return ckpt.read(name, lazy=True)
        return ckpt.read(name).to(dev).to(f32)

    def top(name: str, t: torch.Tensor) -> torch.Tensor:
        # a top-level leaf: the rank's slice on the device, in float32
        if shard is not None:
            from ..parallel.sharding import leaf_spec, shard_slice, tp_dim
            t = shard_slice(t, tp_dim(leaf_spec(None, name)), *shard,
                            name=name)
        return t.to(dev).to(f32)

    def expert_ids():
        # the experts this rank keeps (all of them without a shard)
        E = cfg.num_experts
        if shard is None:
            return range(E)
        if E % shard[1]:
            raise ValueError(f"tp={shard[1]} must divide dim 1 of "
                             f"parameter layers.we_gate (size {E})")
        n = E // shard[1]
        return range(shard[0] * n, (shard[0] + 1) * n)

    def linear_in_out(name: str) -> torch.Tensor:
        return take(name).t()  # [out,in] -> [in,out]

    for li in range(L):
        p = f"model.layers.{li}."
        st, i = (st_dense, li) if li < n_dense else (st_main, li - n_dense)
        layer_is_moe = cfg.is_moe and li >= n_dense
        st.put("attn_norm", i, take(p + "input_layernorm.weight"))
        if layernorm:  # Phi-3.5-MoE: torch LayerNorm biases ride along
            st.put("attn_norm_bias", i, take(p + "input_layernorm.bias"))
        if cfg.post_block_norms:
            # Gemma 2: post_attention_layernorm normalizes the attention
            # OUTPUT; the MLP's pre-norm is pre_feedforward_layernorm
            st.put("attn_post_norm", i,
                   take(p + "post_attention_layernorm.weight"))
            st.put("mlp_norm", i,
                   take(p + "pre_feedforward_layernorm.weight"))
            st.put("mlp_post_norm", i,
                   take(p + "post_feedforward_layernorm.weight"))
        elif not cfg.parallel_block:  # command-r: one shared input norm
            st.put("mlp_norm", i,
                   take(p + "post_attention_layernorm.weight"))
            if layernorm:
                st.put("mlp_norm_bias", i,
                       take(p + "post_attention_layernorm.bias"))
        if cfg.mla:
            qk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
            nope, r, vd = cfg.qk_nope_head_dim, cfg.kv_lora_rank, \
                cfg.v_head_dim
            if cfg.q_lora_rank:
                st.put("wq_a", i,
                       linear_in_out(p + "self_attn.q_a_proj.weight"))
                st.put("q_a_norm", i,
                       take(p + "self_attn.q_a_layernorm.weight"))
                st.put("wq_b", i,
                       take(p + "self_attn.q_b_proj.weight").t().reshape(
                           cfg.q_lora_rank, H, qk))
            else:
                st.put("wq", i,
                       take(p + "self_attn.q_proj.weight").t().reshape(
                           D, H, qk))
            st.put("wkv_a", i, linear_in_out(
                p + "self_attn.kv_a_proj_with_mqa.weight"))
            st.put("kv_a_norm", i,
                   take(p + "self_attn.kv_a_layernorm.weight"))
            # kv_b_proj [H * (nope + v), r] carries both absorbed factors
            kv_b = take(p + "self_attn.kv_b_proj.weight").reshape(
                H, nope + vd, r)
            st.put("w_uk", i, kv_b[:, :nope])
            st.put("w_uv", i, kv_b[:, nope:].transpose(1, 2))
            st.put("wo", i,
                   take(p + "self_attn.o_proj.weight").t().reshape(
                       H, vd, D))
        elif p + "self_attn.qkv_proj.weight" in ckpt:
            # phi3: fused qkv — rows are [H*Dh | K*Dh | K*Dh]
            qkv = take(p + "self_attn.qkv_proj.weight")
            st.put("wq", i, qkv[:H * Dh].t().reshape(D, H, Dh))
            st.put("wk", i,
                   qkv[H * Dh:(H + K) * Dh].t().reshape(D, K, Dh))
            st.put("wv", i, qkv[(H + K) * Dh:].t().reshape(D, K, Dh))
        else:
            st.put("wq", i,
                   take(p + "self_attn.q_proj.weight").t().reshape(
                       D, H, Dh))
            st.put("wk", i,
                   take(p + "self_attn.k_proj.weight").t().reshape(
                       D, K, Dh))
            st.put("wv", i,
                   take(p + "self_attn.v_proj.weight").t().reshape(
                       D, K, Dh))
        if not cfg.mla:
            st.put("wo", i, take(p + "self_attn.o_proj.weight").t().reshape(
                H, Dh, D))
        if cfg.attn_bias:
            st.put("bq", i,
                   take(p + "self_attn.q_proj.bias").reshape(H, Dh))
            st.put("bk", i,
                   take(p + "self_attn.k_proj.bias").reshape(K, Dh))
            st.put("bv", i,
                   take(p + "self_attn.v_proj.bias").reshape(K, Dh))
            if p + "self_attn.o_proj.bias" in ckpt:
                st.put("bo", i, take(p + "self_attn.o_proj.bias"))
        if cfg.attn_sinks:
            st.put("sinks", i, take(p + "self_attn.sinks"), dtype=f32)
        if cfg.qk_norm:
            st.put("q_norm", i, take(p + "self_attn.q_norm.weight"))
            st.put("k_norm", i, take(p + "self_attn.k_norm.weight"))
        if layer_is_moe and p + "mlp.experts.gate_up_proj" in ckpt:
            # gpt-oss: fused per-expert parameters stored [in, out]
            # already; gate/up INTERLEAVED on the last dim; the router
            # is a biased linear (its bias fp32, as the reference's)
            st.put("router", i, linear_in_out(p + "mlp.router.weight"))
            st.put("router_b", i, take(p + "mlp.router.bias"), dtype=f32)
            gu = take(p + "mlp.experts.gate_up_proj")       # [E, D, 2I]
            st.put("we_gate", i, gu[..., ::2])
            st.put("we_up", i, gu[..., 1::2])
            gub = take(p + "mlp.experts.gate_up_proj_bias")  # [E, 2I]
            st.put("we_gate_b", i, gub[..., ::2])
            st.put("we_up_b", i, gub[..., 1::2])
            st.put("we_down", i, take(p + "mlp.experts.down_proj"))
            st.put("we_down_b", i, take(p + "mlp.experts.down_proj_bias"))
        elif layer_is_moe:
            # Mixtral's and Phi-3.5-MoE's block_sparse_moe (each expert's
            # w1, w3, w2) or the Qwen-MoE/DeepSeek mlp.gate and
            # mlp.experts (gate_proj, up_proj, down_proj): the router,
            # then the experts stacked into [E, ...]
            if p + "block_sparse_moe.gate.weight" in ckpt:
                moe = p + "block_sparse_moe."
                names = (("we_gate", "w1"), ("we_up", "w3"),
                         ("we_down", "w2"))
            elif p + "mlp.gate.weight" in ckpt:
                moe = p + "mlp."
                names = (("we_gate", "gate_proj"), ("we_up", "up_proj"),
                         ("we_down", "down_proj"))
            else:
                raise SafetensorsError(f"no MoE router for layer {li}")
            st.put("router", i, linear_in_out(moe + "gate.weight"))
            if cfg.router_bias:
                # DeepSeek-V3's selection bias stays fp32: bf16
                # rounding could flip expert choices
                st.put("router_bias", i,
                       take(p + "mlp.gate.e_score_correction_bias"),
                       dtype=f32)
            for leaf, hf in names:
                st.put(leaf, i, torch.stack([
                    linear_in_out(f"{moe}experts.{e}.{hf}.weight")
                    for e in expert_ids()]), presliced=True)
            if cfg.num_shared_experts > 0:
                for sn in ("mlp.shared_experts.", "mlp.shared_expert."):
                    if p + sn + "gate_proj.weight" in ckpt:
                        for leaf, hf in (("ws_gate", "gate_proj"),
                                         ("ws_up", "up_proj"),
                                         ("ws_down", "down_proj")):
                            st.put(leaf, i, linear_in_out(
                                p + sn + hf + ".weight"))
                        break
        elif p + "mlp.gate_up_proj.weight" in ckpt:
            # phi3: fused gate|up rows (Phi3MLP chunks in halves)
            guw = take(p + "mlp.gate_up_proj.weight")
            half = guw.shape[0] // 2
            st.put("w_gate", i, guw[:half].t())
            st.put("w_up", i, guw[half:].t())
        else:
            st.put("w_gate", i, linear_in_out(p + "mlp.gate_proj.weight"))
            st.put("w_up", i, linear_in_out(p + "mlp.up_proj.weight"))
        if not layer_is_moe:
            st.put("w_down", i, linear_in_out(p + "mlp.down_proj.weight"))

    params: Dict[str, Any] = {
        "embed": top("embed", take("model.embed_tokens.weight")).to(t_dt),
        "final_norm": top("final_norm", take("model.norm.weight")).to(t_dt),
        "layers": st_main.out,
    }
    if st_dense is not None:
        params["dense_layers"] = st_dense.out
    if layernorm:
        params["final_norm_bias"] = top("final_norm_bias",
                                        take("model.norm.bias")).to(t_dt)
    if not cfg.tie_word_embeddings and "lm_head.weight" in ckpt:
        # some checkpoints omit lm_head despite tie=False in config:
        # the model then falls back to the tied embeddings
        params["lm_head"] = top("lm_head", linear_in_out(
            "lm_head.weight")).to(t_dt).contiguous()
    if cfg.lm_head_bias and "lm_head.bias" in ckpt:
        params["lm_head_bias"] = top("lm_head_bias", take("lm_head.bias"))
    return params


def hf_tensors(params: Dict[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """The inverse of `convert_llama` for the Llama, Qwen2/Qwen3,
    Mixtral and DeepSeek (MLA) layouts (attention biases, qk_norm,
    Mixtral's `block_sparse_moe` experts; DeepSeek's q/kv projections
    with the fused `kv_b_proj`, `mlp.gate` and `mlp.experts`, the
    selection bias, the shared experts and the leading dense layers):
    the param tree as HF-named [out, in] tensors, in the tree's dtypes.
    Used to write checkpoints from seeded weights (tests,
    chip_smoke.py)."""
    D, H, K, Dh = (cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads,
                   cfg.head_dim)
    out: Dict[str, torch.Tensor] = {
        "model.embed_tokens.weight": params["embed"],
        "model.norm.weight": params["final_norm"],
    }
    if "lm_head" in params:
        out["lm_head.weight"] = params["lm_head"].t().contiguous()

    def lin(w):  # [in, out] -> [out, in]
        return w.t().contiguous()
    blocks = [params[n] for n in ("dense_layers", "layers") if n in params]
    i = -1
    for lay in blocks:
        for j in range(next(iter(lay.values())).shape[0]):
            i += 1
            p = f"model.layers.{i}."
            a = p + "self_attn."
            out[p + "input_layernorm.weight"] = lay["attn_norm"][j]
            out[p + "post_attention_layernorm.weight"] = lay["mlp_norm"][j]
            if cfg.mla:
                if "wq_a" in lay:
                    out[a + "q_a_proj.weight"] = lin(lay["wq_a"][j])
                    out[a + "q_a_layernorm.weight"] = lay["q_a_norm"][j]
                    out[a + "q_b_proj.weight"] = lin(
                        lay["wq_b"][j].flatten(1))
                else:
                    out[a + "q_proj.weight"] = lin(lay["wq"][j].flatten(1))
                out[a + "kv_a_proj_with_mqa.weight"] = lin(lay["wkv_a"][j])
                out[a + "kv_a_layernorm.weight"] = lay["kv_a_norm"][j]
                out[a + "kv_b_proj.weight"] = torch.cat(
                    [lay["w_uk"][j], lay["w_uv"][j].transpose(1, 2)],
                    dim=1).flatten(0, 1).contiguous()
                out[a + "o_proj.weight"] = lin(lay["wo"][j].flatten(0, 1))
            else:
                for name, heads in (("q", H), ("k", K), ("v", K)):
                    out[a + f"{name}_proj.weight"] = lin(
                        lay["w" + name][j].reshape(D, heads * Dh))
                    if "b" + name in lay:
                        out[a + f"{name}_proj.bias"] = \
                            lay["b" + name][j].reshape(heads * Dh)
                out[a + "o_proj.weight"] = lin(
                    lay["wo"][j].reshape(H * Dh, D))
            if "bo" in lay:
                out[a + "o_proj.bias"] = lay["bo"][j]
            for name in ("q_norm", "k_norm"):
                if name in lay:
                    out[a + f"{name}.weight"] = lay[name][j]
            if "router" in lay:
                if cfg.mla:  # DeepSeek: mlp.gate / mlp.experts
                    moe = p + "mlp."
                    names = (("we_gate", "gate_proj"), ("we_up", "up_proj"),
                             ("we_down", "down_proj"))
                else:
                    moe = p + "block_sparse_moe."
                    names = (("we_gate", "w1"), ("we_up", "w3"),
                             ("we_down", "w2"))
                out[moe + "gate.weight"] = lin(lay["router"][j])
                if "router_bias" in lay:
                    out[moe + "gate.e_score_correction_bias"] = \
                        lay["router_bias"][j]
                for leaf, hf in names:
                    for e in range(lay[leaf].shape[1]):
                        out[moe + f"experts.{e}.{hf}.weight"] = \
                            lin(lay[leaf][j, e])
                if "ws_gate" in lay:
                    for leaf, hf in (("ws_gate", "gate_proj"),
                                     ("ws_up", "up_proj"),
                                     ("ws_down", "down_proj")):
                        out[p + f"mlp.shared_experts.{hf}.weight"] = \
                            lin(lay[leaf][j])
                continue
            for name in ("gate", "up", "down"):
                out[p + f"mlp.{name}_proj.weight"] = lin(lay["w_" + name][j])
    return out


def save_checkpoint(model_dir: str, tensors: Dict[str, Any],
                    shards: int = 1) -> List[str]:
    """Write `tensors` into `model_dir` as `shards` safetensors files,
    with model.safetensors.index.json when there is more than one (the
    layout huggingface_hub writes: the tensors' bytes in
    `metadata.total_size`, which the config parser turns into an exact
    parameter count). Returns the file names."""
    os.makedirs(model_dir, exist_ok=True)
    names = list(tensors)
    if shards <= 1:
        save_safetensors(os.path.join(model_dir, "model.safetensors"),
                         tensors)
        return ["model.safetensors"]
    per = -(-len(names) // shards)
    files, weight_map = [], {}
    for j in range(shards):
        fname = f"model-{j + 1:05d}-of-{shards:05d}.safetensors"
        part = {n: tensors[n] for n in names[j * per:(j + 1) * per]}
        save_safetensors(os.path.join(model_dir, fname), part)
        files.append(fname)
        weight_map.update({n: fname for n in part})
    total = sum(t.numel() * t.element_size() for t in tensors.values())
    with open(os.path.join(model_dir, "model.safetensors.index.json"),
              "w") as f:
        json.dump({"metadata": {"total_size": total},
                   "weight_map": weight_map}, f)
    return files


# architectures whose math the reference's models/llama.py implements;
# a config.json outside this list is refused. The port serves the
# subset `params.check_supported` admits and refuses the rest by name.
SUPPORTED_ARCHITECTURES = frozenset({
    "LlamaForCausalLM", "MistralForCausalLM", "Qwen2ForCausalLM",
    "Qwen3ForCausalLM", "MixtralForCausalLM", "Gemma2ForCausalLM",
    "DeepseekV2ForCausalLM", "DeepseekV3ForCausalLM",
    "Phi3ForCausalLM", "PhimoeForCausalLM", "PhiMoEForCausalLM",
    "CohereForCausalLM", "Cohere2ForCausalLM", "GptOssForCausalLM",
    "MistralModel", "Qwen2Model", "Qwen3Model",
})


def load_config(model_dir: str):
    """ModelConfig of a HF model directory, behind the reference's
    architecture gate."""
    from .config import ModelConfig
    with open(os.path.join(model_dir, "config.json")) as f:
        hf = json.load(f)
    archs = hf.get("architectures") or []
    if archs and not set(archs) & SUPPORTED_ARCHITECTURES:
        raise SafetensorsError(
            f"architecture {archs} is not faithfully implemented by "
            f"models/llama.py (supported: "
            f"{sorted(SUPPORTED_ARCHITECTURES)})")
    return ModelConfig.from_hf_config(hf)


def load_params(model_dir: str, cfg=None, dtype=None,
                device: Optional[Union[str, torch.device]] = None,
                shard: Optional[Tuple[int, int]] = None
                ) -> Tuple[Dict[str, Any], Any]:
    """Load (params, cfg) from a HF model directory onto `device`
    (default CUDA; 'cpu' only when asked for).

    cfg defaults to ModelConfig.from_hf_config(config.json) behind the
    architecture gate; a configuration the port cannot run
    (`params.check_supported`) is refused before any weight is read.
    `dtype` (a torch dtype; default bfloat16) is the weights' and the
    compute dtype. `shard` = (rank, tp): a tensor-parallel rank's slices
    only (`convert_llama`)."""
    from ..device import resolve_device
    from .params import check_supported
    dev = resolve_device(device)
    if cfg is None:
        cfg = load_config(model_dir)
    check_supported(cfg)
    ckpt = Checkpoint(model_dir)
    params = convert_llama(ckpt, cfg, dtype=dtype, device=dev,
                           shard=shard)
    if dtype is not None:
        cfg = cfg.replace(dtype=dtype)
    return params, cfg
