"""HF checkpoint directories and the port's own checkpoints (port of
`llama3_quantization_tpu/models/hf_loader.py`: Llama, OPT, Falcon and
RefinedWeb, Mixtral).

`from_hf_checkpoint` reads a local HF directory (config.json and its
safetensors shards, or the torch `.bin` fallback) into the stacked-layer
parameter tree, weights transposed to `[in, out]`; `save_hf_checkpoint`
writes the inverse. The safetensors format is read and written here (an
8-byte little-endian header length, a JSON header, then the raw bytes),
so that neither `safetensors` nor `transformers` is needed; F32, F16 and
BF16 come back as torch tensors (numpy has no bfloat16, torch has).
`config_from_hf` is a copy of the JAX package's (framework-free), held
equal by `tests/test_torch_checkpoint.py`.

`save_checkpoint` / `load_checkpoint` keep JAX's layout: `params.npz`
(`utils/pytree_io.py`, leaf i of the tree in JAX's order as `leaf_{i}`,
QuantizedTensors included) and `manifest.json` with the config, so a
directory either package writes loads in the other. JAX's orbax
checkpoints (`save_checkpoint_orbax`, sharded pod saves) are
`save_checkpoint_sharded` / `load_checkpoint_sharded` here, over
`torch.distributed.checkpoint`: each rank saves and restores its own
shards of a rank-local tree (JAX's orbax directories are not read). As in JAX,
`save_hf_checkpoint` writes the llama and OPT families only.
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..device import resolve_device
from .configs import ModelConfig


def config_from_hf(path: str) -> ModelConfig:
    """Translate a HF config.json into a ModelConfig."""
    with open(os.path.join(path, "config.json")) as f:
        raw = json.load(f)
    mt = raw.get("model_type", "llama")
    # HF `rope_scaling` (Llama-3.1 "llama3" NTK-by-parts, or "linear");
    # ignoring this silently breaks long-context logits parity.
    rs = raw.get("rope_scaling") or {}
    rs_kind = rs.get("rope_type", rs.get("type"))
    if rs_kind == "default":
        rs_kind = None
    rope_scaling_fields = dict(
        rope_scaling_type=rs_kind,
        rope_scaling_factor=rs.get("factor", 1.0),
        rope_low_freq_factor=rs.get("low_freq_factor", 1.0),
        rope_high_freq_factor=rs.get("high_freq_factor", 4.0),
        rope_original_max_pos=rs.get("original_max_position_embeddings", 8192),
    )
    if mt == "llama":
        return ModelConfig(
            arch="llama",
            **rope_scaling_fields,
            vocab_size=raw["vocab_size"],
            hidden_size=raw["hidden_size"],
            intermediate_size=raw["intermediate_size"],
            num_layers=raw["num_hidden_layers"],
            num_heads=raw["num_attention_heads"],
            num_kv_heads=raw.get("num_key_value_heads", raw["num_attention_heads"]),
            max_position_embeddings=raw.get("max_position_embeddings", 8192),
            rope_theta=raw.get("rope_theta", 10000.0),
            rms_norm_eps=raw.get("rms_norm_eps", 1e-5),
            tie_word_embeddings=raw.get("tie_word_embeddings", False),
        )
    if mt == "mixtral":
        return ModelConfig(
            arch="mixtral",
            vocab_size=raw["vocab_size"],
            hidden_size=raw["hidden_size"],
            intermediate_size=raw["intermediate_size"],
            num_layers=raw["num_hidden_layers"],
            num_heads=raw["num_attention_heads"],
            num_kv_heads=raw.get("num_key_value_heads", raw["num_attention_heads"]),
            max_position_embeddings=raw.get("max_position_embeddings", 32768),
            rope_theta=raw.get("rope_theta", 1e6),
            rms_norm_eps=raw.get("rms_norm_eps", 1e-5),
            num_experts=raw.get("num_local_experts", 8),
            num_experts_per_tok=raw.get("num_experts_per_tok", 2),
            tie_word_embeddings=raw.get("tie_word_embeddings", False),
        )
    if mt in ("falcon", "RefinedWeb", "RefinedWebModel"):
        n_heads = raw.get("num_attention_heads", raw.get("n_head"))
        # HF FalconAttention's precedence: `num_kv_heads` only applies under
        # new_decoder_architecture; otherwise multi_query forces 1 KV head
        # (the config still serializes num_kv_heads == num_attention_heads).
        if raw.get("new_decoder_architecture", False):
            n_kv = raw.get("num_kv_heads") or raw.get("n_head_kv") or n_heads
        elif raw.get("multi_query", True):
            n_kv = 1
        else:
            n_kv = n_heads
        return ModelConfig(
            arch="falcon",
            vocab_size=raw["vocab_size"],
            hidden_size=raw["hidden_size"],
            intermediate_size=4 * raw["hidden_size"],
            num_layers=raw.get("num_hidden_layers", raw.get("n_layer")),
            num_heads=n_heads,
            num_kv_heads=n_kv,
            max_position_embeddings=raw.get("max_position_embeddings", 2048),
            rope_theta=raw.get("rope_theta", 10000.0),
            activation="gelu",
            parallel_block=raw.get("parallel_attn", True),
            tie_word_embeddings=raw.get("tie_word_embeddings", False),
        )
    if mt == "opt":
        return ModelConfig(
            arch="opt",
            vocab_size=raw["vocab_size"],
            hidden_size=raw["hidden_size"],
            intermediate_size=raw["ffn_dim"],
            num_layers=raw["num_hidden_layers"],
            num_heads=raw["num_attention_heads"],
            num_kv_heads=raw["num_attention_heads"],
            max_position_embeddings=raw["max_position_embeddings"],
            activation="relu",
            tie_word_embeddings=raw.get("tie_word_embeddings", True),
            do_layer_norm_before=raw.get("do_layer_norm_before", True),
        )
    raise ValueError(f"unsupported model_type {mt}")


# ---------------------------------------------------------------------------
# safetensors: u64 little-endian header length, JSON header, raw bytes
# ---------------------------------------------------------------------------

#: safetensors dtype name -> (torch dtype, numpy dtype of the same bytes)
ST_DTYPES = {
    "F32": (torch.float32, np.float32),
    "F16": (torch.float16, np.float16),
    "BF16": (torch.bfloat16, np.uint16),
}
_ST_NAMES = {t: name for name, (t, _) in ST_DTYPES.items()}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of one safetensors file, as CPU tensors."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    data = np.memmap(path, dtype=np.uint8, mode="r", offset=8 + n)
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in ST_DTYPES:
            raise ValueError(f"{path}: {name} is {info['dtype']}; weights are F32, F16 or BF16")
        tdtype, ndtype = ST_DTYPES[info["dtype"]]
        begin, end = info["data_offsets"]
        arr = np.array(data[begin:end]).view(ndtype).reshape(info["shape"])
        out[name] = torch.from_numpy(arr).view(tdtype)
    del data
    return out


def write_safetensors(tensors: Dict[str, torch.Tensor], path: str) -> None:
    """Write `tensors` as `safetensors.torch.save_file` lays them out: by
    element size (largest first), then by name; a compact JSON header padded
    with spaces to 8 bytes."""
    tensors = {k: v.detach().contiguous().cpu() for k, v in tensors.items()}
    order = sorted(tensors, key=lambda k: (-tensors[k].element_size(), k))
    header, offset = {}, 0
    for name in order:
        t = tensors[name]
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for name in order:
            f.write(tensors[name].reshape(-1).view(torch.uint8).numpy().tobytes())


def _load_tensors(path: str) -> Dict[str, torch.Tensor]:
    """Read all weight shards (safetensors preferred, torch .bin fallback)."""
    tensors: Dict[str, torch.Tensor] = {}
    st_files = sorted(f for f in os.listdir(path) if f.endswith(".safetensors"))
    if st_files:
        for fname in st_files:
            tensors.update(read_safetensors(os.path.join(path, fname)))
        return tensors
    bin_files = sorted(f for f in os.listdir(path) if f.endswith(".bin"))
    if not bin_files:
        raise FileNotFoundError(f"no safetensors/bin shards in {path}")
    for fname in bin_files:
        sd = torch.load(os.path.join(path, fname), map_location="cpu", weights_only=True)
        tensors.update(sd)
    return tensors


# HF parameter name templates: ours -> (template, transpose)
_LLAMA_LAYER = {
    "q": ("model.layers.{i}.self_attn.q_proj.weight", True),
    "k": ("model.layers.{i}.self_attn.k_proj.weight", True),
    "v": ("model.layers.{i}.self_attn.v_proj.weight", True),
    "o": ("model.layers.{i}.self_attn.o_proj.weight", True),
    "gate": ("model.layers.{i}.mlp.gate_proj.weight", True),
    "up": ("model.layers.{i}.mlp.up_proj.weight", True),
    "down": ("model.layers.{i}.mlp.down_proj.weight", True),
    "ln1.w": ("model.layers.{i}.input_layernorm.weight", False),
    "ln2.w": ("model.layers.{i}.post_attention_layernorm.weight", False),
}


_OPT_LAYER = {
    "q": ("model.decoder.layers.{i}.self_attn.q_proj.weight", True),
    "k": ("model.decoder.layers.{i}.self_attn.k_proj.weight", True),
    "v": ("model.decoder.layers.{i}.self_attn.v_proj.weight", True),
    "o": ("model.decoder.layers.{i}.self_attn.out_proj.weight", True),
    "fc1": ("model.decoder.layers.{i}.fc1.weight", True),
    "fc2": ("model.decoder.layers.{i}.fc2.weight", True),
    "q.b": ("model.decoder.layers.{i}.self_attn.q_proj.bias", False),
    "k.b": ("model.decoder.layers.{i}.self_attn.k_proj.bias", False),
    "v.b": ("model.decoder.layers.{i}.self_attn.v_proj.bias", False),
    "o.b": ("model.decoder.layers.{i}.self_attn.out_proj.bias", False),
    "fc1.b": ("model.decoder.layers.{i}.fc1.bias", False),
    "fc2.b": ("model.decoder.layers.{i}.fc2.bias", False),
    "ln1.w": ("model.decoder.layers.{i}.self_attn_layer_norm.weight", False),
    "ln1.b": ("model.decoder.layers.{i}.self_attn_layer_norm.bias", False),
    "ln2.w": ("model.decoder.layers.{i}.final_layer_norm.weight", False),
    "ln2.b": ("model.decoder.layers.{i}.final_layer_norm.bias", False),
}


def _split_falcon_qkv(qkv: torch.Tensor, cfg: ModelConfig, grouped: bool):
    """Split a fused query_key_value weight `[rows, D]` into q/k/v row
    blocks as HF Falcon's `_split_heads` does (`hf_loader.py:174-201`):
    new-decoder-architecture rows grouped per K/V group as
    `[q_1..q_{H/Hkv}, k, v] x Hkv`; multi-query `[all H q heads, k, v]`;
    classic MHA (Hkv == H) interleaved per head `[q, k, v] x H`."""
    hd = cfg.head_dim_
    h, hkv = cfg.num_heads, cfg.num_kv_heads
    d = qkv.shape[1]
    if grouped:
        blocks = qkv.reshape(hkv, h // hkv + 2, hd, d)
        return (blocks[:, :-2].reshape(h * hd, d), blocks[:, -2].reshape(hkv * hd, d),
                blocks[:, -1].reshape(hkv * hd, d))
    if hkv == 1:
        return qkv[: h * hd], qkv[h * hd : (h + 1) * hd], qkv[(h + 1) * hd :]
    blocks = qkv.reshape(h, 3, hd, d)
    return tuple(blocks[:, j].reshape(h * hd, d) for j in range(3))


def _falcon_layers(raw, cfg: ModelConfig, get) -> Dict[str, Any]:
    """Falcon's layer stacks (`hf_loader.py:204-245`): the fused
    query_key_value projection split into q/k/v; the 40B new-decoder
    layout (separate `ln_attn` / `ln_mlp` norms, per-group QKV rows) is
    detected by key and gives `ln2`."""
    new_arch = "transformer.h.0.ln_attn.weight" in raw
    cols: Dict[str, list] = {}
    for i in range(cfg.num_layers):
        pre = f"transformer.h.{i}"
        qkv = raw[f"{pre}.self_attention.query_key_value.weight"].float()
        parts = dict(zip("qkv", _split_falcon_qkv(qkv, cfg, grouped=new_arch)))
        parts["o"] = raw[f"{pre}.self_attention.dense.weight"].float()
        parts["fc1"] = raw[f"{pre}.mlp.dense_h_to_4h.weight"].float()
        parts["fc2"] = raw[f"{pre}.mlp.dense_4h_to_h.weight"].float()
        for name, w in parts.items():
            cols.setdefault(name, []).append(w.T)
        ln1 = "ln_attn" if new_arch else "input_layernorm"
        norms = {"ln1.w": f"{ln1}.weight", "ln1.b": f"{ln1}.bias"}
        if new_arch:
            norms.update({"ln2.w": "ln_mlp.weight", "ln2.b": "ln_mlp.bias"})
        for ours, hf in norms.items():
            cols.setdefault(ours, []).append(raw[f"{pre}.{hf}"].float())
    out: Dict[str, Any] = {}
    for ours, ts in cols.items():
        top, sub = ours.split(".") if "." in ours else (ours, "w")
        out.setdefault(top, {})[sub] = get(torch.stack(ts))
    return out


def _stack_table(table, cfg: ModelConfig, get, skip=()) -> Dict[str, Any]:
    """Layer stacks `[L, ...]` of the `table` entries (`ours.sub` names a
    non-"w" leaf, as `ln1.b`)."""
    layers: Dict[str, Any] = {}
    for ours, (tmpl, tr) in table.items():
        if ours in skip:
            continue
        stacked = torch.stack([get(tmpl.format(i=i), tr) for i in range(cfg.num_layers)])
        top, sub = ours.split(".") if "." in ours else (ours, "w")
        layers.setdefault(top, {})[sub] = stacked
    return layers


def from_hf_checkpoint(path: str, cfg: Optional[ModelConfig] = None, dtype=torch.bfloat16,
                       device="cuda") -> tuple:
    """Load (params, cfg) from a local HF checkpoint directory, each weight
    through float32 into `dtype` on `device` (JAX's `astype(np.float32)`
    then `jnp.asarray(..., dtype)`; `hf_loader.py:248-338`)."""
    cfg = cfg or config_from_hf(path)
    dev = resolve_device(device)
    raw = _load_tensors(path)

    def get(name, transpose=False):
        t = raw[name].float() if isinstance(name, str) else name
        return (t.T if transpose else t).contiguous().to(device=dev, dtype=dtype)

    if cfg.arch == "falcon":
        params = {
            "layers": _falcon_layers(raw, cfg, get),
            "embed": get("transformer.word_embeddings.weight"),
            "norm": {"w": get("transformer.ln_f.weight"), "b": get("transformer.ln_f.bias")},
        }
        if "lm_head.weight" in raw and not cfg.tie_word_embeddings:
            params["lm_head"] = get("lm_head.weight", transpose=True)
        return params, cfg
    if cfg.arch == "mixtral":
        # the llama trunk and `block_sparse_moe`: the router (HF `gate`, [E, D])
        # stays fp at [L, D, E]; experts w1/w3/w2 stack to [L, E, K, N]
        layers = _stack_table(_LLAMA_LAYER, cfg, get, skip=("gate", "up", "down"))
        moe = "model.layers.{i}.block_sparse_moe"
        layers["router"] = {"w": torch.stack(
            [get(f"{moe}.gate.weight".format(i=i), True) for i in range(cfg.num_layers)])}
        layers["experts"] = {
            ours: {"w": torch.stack([
                torch.stack([get(f"{moe}.experts.{{e}}.{hf}.weight".format(i=i, e=e), True)
                             for e in range(cfg.num_experts)])
                for i in range(cfg.num_layers)])}
            for ours, hf in (("gate", "w1"), ("up", "w3"), ("down", "w2"))
        }
        params = {"layers": layers, "embed": get("model.embed_tokens.weight"),
                  "norm": {"w": get("model.norm.weight")}}
        if not cfg.tie_word_embeddings:
            params["lm_head"] = get("lm_head.weight", transpose=True)
        return params, cfg
    params: Dict[str, Any] = {
        "layers": _stack_table(_LLAMA_LAYER if cfg.arch == "llama" else _OPT_LAYER, cfg, get)}
    if cfg.arch == "llama":
        params["embed"] = get("model.embed_tokens.weight")
        params["norm"] = {"w": get("model.norm.weight")}
        if not cfg.tie_word_embeddings:
            params["lm_head"] = get("lm_head.weight", transpose=True)
    else:
        params["embed"] = get("model.decoder.embed_tokens.weight")
        params["pos_embed"] = get("model.decoder.embed_positions.weight")
        ln = "model.decoder.final_layer_norm"
        params["norm"] = {"w": get(f"{ln}.weight"), "b": get(f"{ln}.bias")}
        if not cfg.tie_word_embeddings and "lm_head.weight" in raw:
            params["lm_head"] = get("lm_head.weight", transpose=True)
    return params, cfg


def save_hf_checkpoint(params, cfg: ModelConfig, path: str) -> None:
    """Write an fp parameter tree as a HF-format directory (config.json and
    model.safetensors in float32 with transformers' names), the inverse of
    `from_hf_checkpoint` for the llama and OPT families (`hf_loader.py:
    341-422`); other archs raise, as in JAX."""
    if cfg.arch not in ("llama", "opt"):
        raise NotImplementedError(f"save_hf_checkpoint: arch {cfg.arch}")
    os.makedirs(path, exist_ok=True)
    if cfg.arch == "llama":
        hf_cfg = {
            "model_type": "llama",
            "architectures": ["LlamaForCausalLM"],
            "vocab_size": cfg.vocab_size,
            "hidden_size": cfg.hidden_size,
            "intermediate_size": cfg.intermediate_size,
            "num_hidden_layers": cfg.num_layers,
            "num_attention_heads": cfg.num_heads,
            "num_key_value_heads": cfg.num_kv_heads,
            "max_position_embeddings": cfg.max_position_embeddings,
            "rope_theta": cfg.rope_theta,
            "rms_norm_eps": cfg.rms_norm_eps,
            "tie_word_embeddings": cfg.tie_word_embeddings,
            "torch_dtype": "float32",
        }
        table = _LLAMA_LAYER
        embed_key, norm_key = "model.embed_tokens.weight", "model.norm.weight"
    else:
        hf_cfg = {
            "model_type": "opt",
            "architectures": ["OPTForCausalLM"],
            "vocab_size": cfg.vocab_size,
            "hidden_size": cfg.hidden_size,
            "ffn_dim": cfg.intermediate_size,
            "num_hidden_layers": cfg.num_layers,
            "num_attention_heads": cfg.num_heads,
            "max_position_embeddings": cfg.max_position_embeddings,
            "do_layer_norm_before": cfg.do_layer_norm_before,
            "tie_word_embeddings": cfg.tie_word_embeddings,
            "torch_dtype": "float32",
        }
        table = _OPT_LAYER
        embed_key = "model.decoder.embed_tokens.weight"
        norm_key = "model.decoder.final_layer_norm.weight"
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf_cfg, f, indent=2)

    def leaf(entry, ours):
        if "." in ours:
            top, sub = ours.split(".")
            return entry.get(top, {}).get(sub)
        return entry.get(ours, {}).get("w")

    def fp32(t) -> torch.Tensor:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"save_hf_checkpoint writes fp parameters, got {type(t).__name__}")
        return t.detach().to("cpu", torch.float32)

    tensors: Dict[str, torch.Tensor] = {}
    for ours, (tmpl, tr) in table.items():
        stacked = leaf(params["layers"], ours)
        if stacked is None:  # optional biases absent in this model
            continue
        arr = fp32(stacked)
        for i in range(cfg.num_layers):
            tensors[tmpl.format(i=i)] = (arr[i].T if tr else arr[i]).contiguous()
    tensors[embed_key] = fp32(params["embed"])
    tensors[norm_key] = fp32(params["norm"]["w"])
    if cfg.arch == "opt":
        tensors["model.decoder.embed_positions.weight"] = fp32(params["pos_embed"])
        tensors["model.decoder.final_layer_norm.bias"] = fp32(params["norm"]["b"])
    if "lm_head" in params and not cfg.tie_word_embeddings:
        tensors["lm_head.weight"] = fp32(params["lm_head"]).T.contiguous()
    write_safetensors(tensors, os.path.join(path, "model.safetensors"))


def save_checkpoint(params, cfg: ModelConfig, path: str) -> None:
    """Persist a (possibly quantized) parameter tree with its config
    (`hf_loader.py:425-438`): `params.npz` and `manifest.json`."""
    from ..utils.pytree_io import save_pytree_npz

    os.makedirs(path, exist_ok=True)
    save_pytree_npz(os.path.join(path, "params.npz"), params)
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump({"config": dataclasses.asdict(cfg)}, f)


def load_checkpoint(path: str, params_like) -> Any:
    """Restore leaves into the structure of `params_like` (same tree), each
    on the device and in the dtype of the leaf it replaces."""
    from ..utils.pytree_io import load_pytree_npz

    return load_pytree_npz(os.path.join(path, "params.npz"), params_like)


def _rank_state(params):
    """(this rank's leaves keyed `rank{r}.leaf_{i}`, in JAX's leaf order
    with QuantizedTensor fields; the tree without its `Shard`)."""
    import torch.distributed as dist

    from ..ops.collectives import SHARD_KEY
    from ..utils.pytree_io import tree_leaves

    tree = {k: v for k, v in params.items() if k != SHARD_KEY}
    rank = dist.get_rank() if dist.is_initialized() else 0
    return {f"rank{rank}.leaf_{i}": t for i, t in enumerate(tree_leaves(tree))}, tree


def save_checkpoint_sharded(params, path: str) -> None:
    """Save a parameter tree, rank-local or whole, with
    `torch.distributed.checkpoint` (JAX `save_checkpoint_orbax`,
    `hf_loader.py:448-456`): every rank of the process group calls it and
    writes its own leaves (QuantizedTensor fields included) into `path`."""
    import torch.distributed as dist
    import torch.distributed.checkpoint as dcp

    state, _ = _rank_state(params)
    dcp.save(state, checkpoint_id=os.path.abspath(path), no_dist=not dist.is_initialized())


def load_checkpoint_sharded(path: str, params_like):
    """Restore what `save_checkpoint_sharded` wrote into the structure of
    `params_like` (JAX `load_checkpoint_orbax`, `:459-466`): each rank
    reads its own leaves, on the device and in the dtype of the leaf of
    `params_like` each replaces; a rank-local `params_like` keeps its `Shard`."""
    import torch.distributed as dist
    import torch.distributed.checkpoint as dcp

    from ..ops.collectives import SHARD_KEY
    from ..utils.pytree_io import _unflatten

    like, tree = _rank_state(params_like)
    state = {k: torch.empty_like(v) for k, v in like.items()}
    dcp.load(state, checkpoint_id=os.path.abspath(path), no_dist=not dist.is_initialized())
    out = _unflatten(tree, iter(state[k] for k in like))
    if SHARD_KEY in params_like:
        out[SHARD_KEY] = params_like[SHARD_KEY]
    return out
