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
what the reference's architecture gate refuses and what the port does
not serve yet (`params.check_supported`); `convert_llama` keeps the
reference's GQA branches with q/k/v(/o) biases, qk_norm and the
Mixtral-style experts and router.
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

    def read(self, name: str) -> torch.Tensor:
        """The tensor's bytes as a CPU tensor of its stored dtype."""
        st, shape, start, end = self._tensors[name]
        dt, view = _DTYPES[st]
        n = int(np.prod(shape)) if shape else 1
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

    def read(self, name: str) -> torch.Tensor:
        if name not in self._where:
            raise KeyError(name)
        return self._file(self._where[name]).read(name)


# -- HF -> llama.py param tree ---------------------------------------------


class _Stacker:
    """Fills [L, ...] stacked tensors on `device` one layer at a time
    (no 2x peak)."""

    def __init__(self, num_layers: int, dtype: torch.dtype,
                 device: torch.device):
        self.L = num_layers
        self.dtype = dtype
        self.device = device
        self.out: Dict[str, torch.Tensor] = {}

    def put(self, key: str, layer: int, arr: torch.Tensor,
            dtype: Optional[torch.dtype] = None) -> None:
        dt = dtype or self.dtype
        if key not in self.out:
            self.out[key] = torch.empty((self.L,) + tuple(arr.shape),
                                        dtype=dt, device=self.device)
        self.out[key][layer] = arr.to(dt)


def convert_llama(ckpt: Checkpoint, cfg, dtype=None,
                  device: Union[str, torch.device] = "cpu"
                  ) -> Dict[str, Any]:
    """Map HF checkpoint names/layouts onto the llama.py param tree.

    HF linear weights are [out, in] (y = W x); the model's products take
    [in, out]-shaped factors, so every projection transposes, and
    attention projections reshape the fused head dim into [heads, Dh].
    Each tensor is read, moved to `device`, widened to float32 and
    rounded once to `dtype` (default bfloat16), as the reference does.

    Converts the GQA family: separate or fused (phi3) q/k/v and gate/up
    projections, q/k/v(/o) biases (Qwen2), the per-head q/k norms
    (Qwen3) and Mixtral's `block_sparse_moe`: the router and each
    layer's experts stacked into [E, ...] leaves. The reference's other
    families (MLA, shared experts, layernorm, post-block norms, sinks,
    gpt-oss's fused experts) are not converted; `load_params` refuses
    them before any weight is read.
    """
    dev = torch.device(device)
    t_dt = dtype or torch.bfloat16
    f32 = torch.float32
    L, D, H, K, Dh = (cfg.num_layers, cfg.hidden_size, cfg.num_heads,
                      cfg.num_kv_heads, cfg.head_dim)
    st = _Stacker(L, t_dt, dev)

    def take(name: str) -> torch.Tensor:
        if name not in ckpt and name.startswith("model."):
            # bare AutoModel checkpoints (MistralModel/Qwen2Model
            # embedding repos) drop the "model." prefix
            name = name[len("model."):]
        return ckpt.read(name).to(dev).to(f32)

    def linear_in_out(name: str) -> torch.Tensor:
        return take(name).t()  # [out,in] -> [in,out]

    for i in range(L):
        p = f"model.layers.{i}."
        st.put("attn_norm", i, take(p + "input_layernorm.weight"))
        st.put("mlp_norm", i, take(p + "post_attention_layernorm.weight"))
        if p + "self_attn.qkv_proj.weight" in ckpt:
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
        st.put("wo", i,
               take(p + "self_attn.o_proj.weight").t().reshape(H, Dh, D))
        if cfg.attn_bias:
            st.put("bq", i,
                   take(p + "self_attn.q_proj.bias").reshape(H, Dh))
            st.put("bk", i,
                   take(p + "self_attn.k_proj.bias").reshape(K, Dh))
            st.put("bv", i,
                   take(p + "self_attn.v_proj.bias").reshape(K, Dh))
            if p + "self_attn.o_proj.bias" in ckpt:
                st.put("bo", i, take(p + "self_attn.o_proj.bias"))
        if cfg.qk_norm:
            st.put("q_norm", i, take(p + "self_attn.q_norm.weight"))
            st.put("k_norm", i, take(p + "self_attn.k_norm.weight"))
        if cfg.is_moe:
            # Mixtral's block_sparse_moe: the router, then each expert's
            # w1 (gate), w3 (up) and w2 (down), stacked into [E, ...]
            moe = p + "block_sparse_moe."
            st.put("router", i, linear_in_out(moe + "gate.weight"))
            for leaf, hf in (("we_gate", "w1"), ("we_up", "w3"),
                             ("we_down", "w2")):
                st.put(leaf, i, torch.stack([
                    linear_in_out(f"{moe}experts.{e}.{hf}.weight")
                    for e in range(cfg.num_experts)]))
        elif p + "mlp.gate_up_proj.weight" in ckpt:
            # phi3: fused gate|up rows (Phi3MLP chunks in halves)
            guw = take(p + "mlp.gate_up_proj.weight")
            half = guw.shape[0] // 2
            st.put("w_gate", i, guw[:half].t())
            st.put("w_up", i, guw[half:].t())
        else:
            st.put("w_gate", i, linear_in_out(p + "mlp.gate_proj.weight"))
            st.put("w_up", i, linear_in_out(p + "mlp.up_proj.weight"))
        if not cfg.is_moe:
            st.put("w_down", i, linear_in_out(p + "mlp.down_proj.weight"))

    params: Dict[str, Any] = {
        "embed": take("model.embed_tokens.weight").to(t_dt),
        "final_norm": take("model.norm.weight").to(t_dt),
        "layers": st.out,
    }
    if not cfg.tie_word_embeddings and "lm_head.weight" in ckpt:
        # some checkpoints omit lm_head despite tie=False in config:
        # the model then falls back to the tied embeddings
        params["lm_head"] = linear_in_out(
            "lm_head.weight").to(t_dt).contiguous()
    return params


def hf_tensors(params: Dict[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """The inverse of `convert_llama` for the families the port serves
    (attention biases, qk_norm and Mixtral's `block_sparse_moe` experts
    included): the param tree as HF-named [out, in] tensors, in the
    tree's dtypes. Used to write checkpoints from seeded weights (tests,
    chip_smoke.py)."""
    L, D, H, K, Dh = (cfg.num_layers, cfg.hidden_size, cfg.num_heads,
                      cfg.num_kv_heads, cfg.head_dim)
    lay = params["layers"]
    out: Dict[str, torch.Tensor] = {
        "model.embed_tokens.weight": params["embed"],
        "model.norm.weight": params["final_norm"],
    }
    if "lm_head" in params:
        out["lm_head.weight"] = params["lm_head"].t().contiguous()
    for i in range(L):
        p = f"model.layers.{i}."
        out[p + "input_layernorm.weight"] = lay["attn_norm"][i]
        out[p + "post_attention_layernorm.weight"] = lay["mlp_norm"][i]
        for name, heads in (("q", H), ("k", K), ("v", K)):
            out[p + f"self_attn.{name}_proj.weight"] = \
                lay["w" + name][i].reshape(D, heads * Dh).t().contiguous()
            if "b" + name in lay:
                out[p + f"self_attn.{name}_proj.bias"] = \
                    lay["b" + name][i].reshape(heads * Dh)
        out[p + "self_attn.o_proj.weight"] = \
            lay["wo"][i].reshape(H * Dh, D).t().contiguous()
        if "bo" in lay:
            out[p + "self_attn.o_proj.bias"] = lay["bo"][i]
        for name in ("q_norm", "k_norm"):
            if name in lay:
                out[p + f"self_attn.{name}.weight"] = lay[name][i]
        if "router" in lay:
            moe = p + "block_sparse_moe."
            out[moe + "gate.weight"] = lay["router"][i].t().contiguous()
            for leaf, hf in (("we_gate", "w1"), ("we_up", "w3"),
                             ("we_down", "w2")):
                for e in range(lay[leaf].shape[1]):
                    out[moe + f"experts.{e}.{hf}.weight"] = \
                        lay[leaf][i, e].t().contiguous()
            continue
        for name in ("gate", "up", "down"):
            out[p + f"mlp.{name}_proj.weight"] = \
                lay["w_" + name][i].t().contiguous()
    return out


def save_checkpoint(model_dir: str, tensors: Dict[str, Any],
                    shards: int = 1) -> List[str]:
    """Write `tensors` into `model_dir` as `shards` safetensors files,
    with model.safetensors.index.json when there is more than one (the
    layout huggingface_hub writes). Returns the file names."""
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
    with open(os.path.join(model_dir, "model.safetensors.index.json"),
              "w") as f:
        json.dump({"metadata": {}, "weight_map": weight_map}, f)
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
                device: Optional[Union[str, torch.device]] = None
                ) -> Tuple[Dict[str, Any], Any]:
    """Load (params, cfg) from a HF model directory onto `device`
    (default CUDA; 'cpu' only when asked for).

    cfg defaults to ModelConfig.from_hf_config(config.json) behind the
    architecture gate; a configuration the port cannot run
    (`params.check_supported`) is refused before any weight is read.
    `dtype` (a torch dtype; default bfloat16) is the weights' and the
    compute dtype."""
    from ..device import resolve_device
    from .params import check_supported
    dev = resolve_device(device)
    if cfg is None:
        cfg = load_config(model_dir)
    check_supported(cfg)
    ckpt = Checkpoint(model_dir)
    params = convert_llama(ckpt, cfg, dtype=dtype, device=dev)
    if dtype is not None:
        cfg = cfg.replace(dtype=dtype)
    return params, cfg
