"""Parameters carried across from the JAX package, and safetensors I/O.

`params_from_jax` turns a VL-Pythia parameter pytree of numpy arrays (the
JAX package's `vl_pythia.init_params` after `jax.tree.map(np.asarray, ...)`,
or a checkpoint restored to numpy) into this package's state_dict: stacked
`[L, ...]` layer leaves are un-stacked, `[in, out]` matrices transposed to
torch's `[out, in]`, the HWIO patch-embed conv to OIHW, and the names are the
reference's torch names (timm's under `vision_encoder.` for the EVA-02 tower,
HF's under `vision_encoder.vision_model.` for CLIP).

`save_safetensors` / `load_safetensors` write and read the safetensors
format by hand (the `safetensors` package is not needed): an 8-byte
little-endian header length, a JSON header of
{name: {"dtype", "shape", "data_offsets"}} padded with spaces to a multiple
of 8 bytes, then the tensors' raw little-endian bytes.

`load_pretrained` reads a reference-format model directory (config.json and
model.safetensors, sharded *.safetensors or pytorch_model.bin) into a
state_dict of the port's names (`normalize_state_dict`).
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from mafed_tpu_torch.core.config import ModelConfig
from mafed_tpu_torch.models.vl_pythia import VLPythia


def _tensor(x: Any, transpose: bool = False, axes=None) -> torch.Tensor:
    arr = np.asarray(x)
    bf16 = arr.dtype.name == "bfloat16"  # numpy has no bf16: go through f32
    if bf16:
        arr = arr.astype(np.float32)
    if transpose or axes is not None:
        arr = arr.transpose(axes)
    t = torch.tensor(arr)  # a copy: the pytree's arrays may be read-only
    return t.to(torch.bfloat16) if bf16 else t


def params_from_jax(params_np: Dict[str, Any], cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """JAX pytree -> state_dict with the reference torch names. A pytree
    without the `vision` subtree (the trainable split) gives no
    `vision_encoder.*` entries."""
    out: Dict[str, torch.Tensor] = {}
    dec = params_np["decoder"]
    out["gpt_neox.embed_in.weight"] = _tensor(dec["embed_in"]["weight"])
    out["embed_out.weight"] = _tensor(dec["embed_out"]["weight"])
    out["gpt_neox.final_layer_norm.weight"] = _tensor(dec["final_layer_norm"]["weight"])
    out["gpt_neox.final_layer_norm.bias"] = _tensor(dec["final_layer_norm"]["bias"])
    lp = dec["layers"]
    for i in range(cfg.num_hidden_layers):
        base = f"gpt_neox.layers.{i}."
        for norm in ("input_layernorm", "post_attention_layernorm"):
            out[base + f"{norm}.weight"] = _tensor(lp[norm]["weight"][i])
            out[base + f"{norm}.bias"] = _tensor(lp[norm]["bias"][i])
        for group, name in (
            ("attention", "query_key_value"), ("attention", "dense"),
            ("mlp", "dense_h_to_4h"), ("mlp", "dense_4h_to_h"),
        ):
            out[base + f"{group}.{name}.weight"] = _tensor(lp[group][name]["weight"][i], transpose=True)
            out[base + f"{group}.{name}.bias"] = _tensor(lp[group][name]["bias"][i])
    proj = params_np["projector"]
    for idx, name in ((0, "fc1"), (2, "fc2")):
        out[f"vision_embed_tokens.{idx}.weight"] = _tensor(proj[name]["weight"], transpose=True)
        out[f"vision_embed_tokens.{idx}.bias"] = _tensor(proj[name]["bias"])
    if "vision" in params_np:
        tower = _clip_from_jax if cfg.vision.backbone == "clip" else _vision_from_jax
        out.update(tower(params_np["vision"], cfg))
    return out


def _clip_from_jax(vis: Dict[str, Any], cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """The JAX package's CLIP tree (mafed_tpu/models/clip_vit.py) -> HF's
    CLIPVisionModel names under `vision_encoder.vision_model.`."""
    pre = "vision_encoder.vision_model."
    out = {
        pre + "embeddings.class_embedding": _tensor(vis["class_embedding"]),
        pre + "embeddings.patch_embedding.weight": _tensor(vis["patch_embedding"]["weight"], axes=(3, 2, 0, 1)),
        pre + "embeddings.position_embedding.weight": _tensor(vis["position_embedding"]),
    }
    for norm in ("pre_layrnorm", "post_layernorm"):
        out[pre + f"{norm}.weight"] = _tensor(vis[norm]["weight"])
        out[pre + f"{norm}.bias"] = _tensor(vis[norm]["bias"])
    lp = vis["layers"]
    for i in range(cfg.vision.depth):
        base = pre + f"encoder.layers.{i}."
        for norm in ("layer_norm1", "layer_norm2"):
            out[base + f"{norm}.weight"] = _tensor(lp[norm]["weight"][i])
            out[base + f"{norm}.bias"] = _tensor(lp[norm]["bias"][i])
        for group, names in (("self_attn", ("q_proj", "k_proj", "v_proj", "out_proj")), ("mlp", ("fc1", "fc2"))):
            for name in names:
                out[base + f"{group}.{name}.weight"] = _tensor(lp[group][name]["weight"][i], transpose=True)
                out[base + f"{group}.{name}.bias"] = _tensor(lp[group][name]["bias"][i])
    return out


def _vision_from_jax(vis: Dict[str, Any], cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    out = {
        "vision_encoder.patch_embed.proj.weight": _tensor(vis["patch_embed"]["proj"]["weight"], axes=(3, 2, 0, 1)),
        "vision_encoder.patch_embed.proj.bias": _tensor(vis["patch_embed"]["proj"]["bias"]),
        "vision_encoder.cls_token": _tensor(vis["cls_token"]),
        "vision_encoder.pos_embed": _tensor(vis["pos_embed"]),
        "vision_encoder.norm.weight": _tensor(vis["norm"]["weight"]),
        "vision_encoder.norm.bias": _tensor(vis["norm"]["bias"]),
    }
    bp = vis["blocks"]
    for i in range(cfg.vision.depth):
        base = f"vision_encoder.blocks.{i}."
        for norm in ("norm1", "norm2"):
            out[base + f"{norm}.weight"] = _tensor(bp[norm]["weight"][i])
            out[base + f"{norm}.bias"] = _tensor(bp[norm]["bias"][i])
        for group, names in (("attn", ("q_proj", "k_proj", "v_proj", "proj")), ("mlp", ("fc1_g", "fc1_x", "fc2"))):
            for name in names:
                leaf = bp[group][name]
                out[base + f"{group}.{name}.weight"] = _tensor(leaf["weight"][i], transpose=True)
                if "bias" in leaf:  # k_proj has none
                    out[base + f"{group}.{name}.bias"] = _tensor(leaf["bias"][i])
        for group in ("attn", "mlp"):  # the sub-LNs
            out[base + f"{group}.norm.weight"] = _tensor(bp[group]["norm"]["weight"][i])
            out[base + f"{group}.norm.bias"] = _tensor(bp[group]["norm"]["bias"][i])
    return out


_ST_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}
_ST_NAMES = {v: k for k, v in _ST_DTYPES.items()}


def save_safetensors(tensors: Dict[str, torch.Tensor], path: str) -> None:
    """Write `tensors` (any device; names in sorted order) to a safetensors
    file at `path`, atomically."""
    host = {k: tensors[k].detach().to("cpu").contiguous() for k in sorted(tensors)}
    header, offset = {}, 0
    for name, t in host.items():
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape), "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for t in host.values():
            f.write(t.reshape(-1).view(torch.uint8).numpy())
    os.replace(tmp, path)


def load_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a safetensors file, on the CPU, in file order."""
    out: Dict[str, torch.Tensor] = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        header.pop("__metadata__", None)
        start = 8 + n
        for name, meta in sorted(header.items(), key=lambda kv: kv[1]["data_offsets"][0]):
            begin, end = meta["data_offsets"]
            dtype = _ST_DTYPES[meta["dtype"]]
            f.seek(start + begin)
            raw = bytearray(f.read(end - begin))
            if len(raw) != end - begin:
                raise ValueError(f"{path}: tensor {name} is truncated")
            t = torch.frombuffer(raw, dtype=torch.uint8) if raw else torch.empty(0, dtype=torch.uint8)
            out[name] = t.view(dtype).reshape(meta["shape"])
    return out


def _candidates(name: str):
    """The names a reference-format file may give the model's tensor `name`:
    the decoder's with or without the `gpt_neox.` prefix, `embed_out.weight`
    also inside it, the tower's with or without `vision_encoder.` (the JAX
    package's converters, mafed_tpu/models/weights.py:58-199, take the same)."""
    for prefix in ("gpt_neox.", "vision_encoder."):
        if name.startswith(prefix):
            return (name, name[len(prefix):])
    if name == "embed_out.weight":
        return (name, "gpt_neox.embed_out.weight")
    return (name,)


def normalize_state_dict(state_dict: Dict[str, torch.Tensor], cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """A reference-format state_dict under exactly VLPythia's names (the
    first candidate name present wins; other entries are dropped). The
    layouts are torch's already, so nothing is transposed or stacked."""
    out: Dict[str, torch.Tensor] = {}
    for name in VLPythia(cfg, device="meta").state_dict():
        found = next((k for k in _candidates(name) if k in state_dict), None)
        if found is None:
            raise KeyError(f"{name} not in the state dict (tried {list(_candidates(name))})")
        out[name] = state_dict[found]
    return out


def load_torch_pickle(path: str) -> Dict[str, torch.Tensor]:
    """A torch.save'd state_dict (`.bin`, or a Lightning `.ckpt`), read with
    weights_only=True: a pickle that holds anything but tensors and plain
    containers is refused (pickle.UnpicklingError)."""
    return torch.load(path, map_location="cpu", weights_only=True)


def load_pretrained(model_dir: str, cfg: Optional[ModelConfig] = None) -> Tuple[Dict[str, torch.Tensor], ModelConfig]:
    """(state_dict on the CPU, config) of a reference-format model directory,
    with the fallback chain of the JAX package's load_pretrained: a single
    model.safetensors, then the sharded *.safetensors, then
    pytorch_model.bin. The config is `cfg`, else config.json, else
    ModelConfig()."""
    cfg_path = os.path.join(model_dir, "config.json")
    if cfg is None:
        cfg = ModelConfig.from_json(cfg_path) if os.path.exists(cfg_path) else ModelConfig()
    single = os.path.join(model_dir, "model.safetensors")
    shards = sorted(
        f for f in os.listdir(model_dir) if f.endswith(".safetensors") and f != "model.safetensors"
    ) if os.path.isdir(model_dir) else []
    if os.path.exists(single):
        sd = load_safetensors(single)
    elif shards:
        sd = {}
        for shard in shards:
            sd.update(load_safetensors(os.path.join(model_dir, shard)))
    elif os.path.exists(os.path.join(model_dir, "pytorch_model.bin")):
        sd = load_torch_pickle(os.path.join(model_dir, "pytorch_model.bin"))
    else:
        raise FileNotFoundError(f"no weights found under {model_dir}")
    return normalize_state_dict(sd, cfg), cfg
