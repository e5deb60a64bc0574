"""Flax parameter trees <-> the port's ``state_dict``.

The JAX package keeps parameters as a nested dict (``encoder/layer_3/
self_attn/qkv/kernel``); bundles and checkpoints store it flat with
``/``-joined keys. The port's modules use PyTorch layouts, so a leaf is
renamed and re-laid-out on the way in:

============================  ===========================  =================
Flax leaf                     port key                     layout
============================  ===========================  =================
``.../layer_N/...``           ``.../layers.N/...``
``ff/Dense_0``, ``Dense_1``   ``ff.fc1``, ``ff.fc2``
Dense ``kernel [in, out]``    ``weight [out, in]``         transpose
qkv ``kernel [D, 3, H, Dh]``  ``weight [3D, D]``           flatten (3, H, Dh)
q/k/v ``kernel [D, H, Dh]``   ``weight [D, D]``            flatten (H, Dh)
``pos/kernel [D, H, Dh]``     ``pos.weight [D, D]``        flatten (H, Dh)
attn out ``kernel [H, Dh, D]`` ``weight [D, D]``           flatten (H, Dh)
Conv ``kernel`` HWIO          ``weight`` OIHW              permute
depthwise ``kernel [K,1,C]``  ``weight [C, 1, K]``         reverse the axes
``VGGExtractor_0``, ``BLSTM_0``  ``vgg``, ``blstm``
LSTM ``recurrent [H, 4H]``    ``recurrent [H, 4H]``        as it is
``u_bias``/``v_bias [H, Dh]`` ``u_bias``/``v_bias``        as it is
any ``bias``                  ``bias``                     flatten
LayerNorm ``scale``           ``weight``
Embed ``embedding``           ``weight``
============================  ===========================  =================

A Meta-SGD tree ``{"model": ..., "inner_lr": ...}`` (one learned inner rate
per model leaf) converts both ways too: the rates keep their scalar values
and take their leaf's name (:func:`params_to_flax`, :func:`flax_to_params`).

The shallow-fusion LM (``models/lm.py``) keeps the Flax names at the top
level (``embed``, ``input_proj_{i}``, ``recurrent_{i}``, ``out_proj``) and
has its own pair, :func:`flax_to_lm_state_dict` and
:func:`lm_state_dict_to_flax`. A bundle carries it under ``__lm__/...``
beside the ASR model's leaves; :func:`split_lm` takes it off before the
model's tree is converted.
"""

from __future__ import annotations

import re

import numpy as np
import torch

_RENAME = {"Dense_0": "fc1", "Dense_1": "fc2",
           "VGGExtractor_0": "vgg", "BLSTM_0": "blstm"}
# parameters that are not a module's leaf: they keep their names and layout
_BARE_LEAVES = ("recurrent", "u_bias", "v_bias")
_RENAME_BACK = {v: k for k, v in _RENAME.items()}


def flatten_tree(tree, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested dict (or an already flat ``a/b/c`` dict) -> flat dict of
    float32/int numpy arrays. Leaves may be numpy arrays, framework arrays
    that support ``np.asarray``, or bf16 arrays of a foreign numpy dtype."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten_tree(v, key))
        else:
            a = np.asarray(v)
            if a.dtype.kind not in "fiub":  # e.g. a bfloat16 extension dtype
                a = a.astype(np.float32)
            out[key] = a
    return out


def unflatten(flat: dict[str, np.ndarray]) -> dict:
    out: dict = {}
    for key, a in flat.items():
        node = out
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = a
    return out


def _port_key(parts: list[str]) -> str:
    names = []
    for p in parts[:-1]:
        m = re.fullmatch(r"layer_(\d+)", p)
        names.append(f"layers.{m.group(1)}" if m else _RENAME.get(p, p))
    leaf = parts[-1]
    if leaf in _BARE_LEAVES:
        names.append(leaf)
    else:
        names.append("bias" if leaf == "bias" else "weight")
    return ".".join(names)


def _to_torch_layout(module: str, leaf: str, a: np.ndarray) -> np.ndarray:
    if leaf in ("scale", "embedding") + _BARE_LEAVES:
        return a
    if leaf == "bias":
        return a.reshape(-1)
    if module.startswith("conv"):
        return a.transpose(3, 2, 0, 1)
    if module == "depthwise":                    # [K, 1, C] -> [C, 1, K]
        return a.transpose(2, 1, 0)
    if module == "out" and a.ndim == 3:          # attention out [H, Dh, D]
        return a.reshape(-1, a.shape[-1]).T
    return a.reshape(a.shape[0], -1).T


def flax_to_state_dict(tree) -> dict[str, torch.Tensor]:
    """Flax tree (nested or flat) -> the port's ``state_dict`` (fp32)."""
    sd = {}
    for key, a in flatten_tree(tree).items():
        parts = key.split("/")
        module = parts[-2] if len(parts) > 1 else ""
        w = _to_torch_layout(module, parts[-1], a)
        sd[_port_key(parts)] = torch.tensor(w, dtype=torch.float32)
    return sd


def _flax_parts(key: str) -> list[str]:
    """Port key -> the Flax module path (without the leaf name)."""
    names = key.split(".")
    parts = []
    i = 0
    while i < len(names) - 1:
        if names[i] == "layers":
            parts.append(f"layer_{names[i + 1]}")
            i += 2
        else:
            parts.append(_RENAME_BACK.get(names[i], names[i]))
            i += 1
    return parts


def _flax_leaf(key: str) -> str:
    names = key.split(".")
    module, leaf = names[-2], names[-1]
    if leaf in _BARE_LEAVES:
        return leaf
    if module.startswith("norm") or module == "final_norm":
        return "scale" if leaf == "weight" else "bias"
    if module == "embed":
        return "embedding"
    return "bias" if leaf == "bias" else "kernel"


def flax_path(key: str) -> str:
    """Port parameter name -> the reference's '/'-joined Flax path, e.g.
    ``encoder.layers.0.ff.fc1.weight`` -> ``encoder/layer_0/ff/Dense_0/
    kernel`` (what ``adapt_filter`` patterns match against)."""
    return "/".join(_flax_parts(key) + [_flax_leaf(key)])


def params_to_flax(params: dict, num_heads: int) -> dict:
    """The port's parameters (a state_dict, or a Meta-SGD tree of one) ->
    the Flax layout (nested dicts of fp32 numpy)."""
    if set(params) == {"model", "inner_lr"}:
        rates = {flax_path(k): np.asarray(v.detach().to("cpu", torch.float32))
                 for k, v in params["inner_lr"].items()}
        return {"model": state_dict_to_flax(params["model"], num_heads),
                "inner_lr": unflatten(rates)}
    return state_dict_to_flax(params, num_heads)


def flax_to_params(tree: dict) -> dict:
    """Inverse of :func:`params_to_flax` (fp32 tensors on the CPU)."""
    if set(tree) == {"model", "inner_lr"}:
        rates = {_port_key(k.split("/")): torch.tensor(a, dtype=torch.float32)
                 for k, a in flatten_tree(tree["inner_lr"]).items()}
        return {"model": flax_to_state_dict(tree["model"]), "inner_lr": rates}
    return flax_to_state_dict(tree)


def state_dict_to_flax(sd: dict[str, torch.Tensor], num_heads: int) -> dict:
    """Inverse of :func:`flax_to_state_dict` (nested dict of fp32 numpy)."""
    flat = {}
    for key, t in sd.items():
        a = t.detach().to("cpu", torch.float32).numpy()
        names = key.split(".")
        module, leaf = names[-2], names[-1]
        parts = _flax_parts(key)
        if leaf in _BARE_LEAVES:
            flat["/".join(parts + [leaf])] = a
            continue
        if module.startswith("conv"):
            if leaf == "bias":
                flat["/".join(parts + ["bias"])] = a
            else:
                flat["/".join(parts + ["kernel"])] = np.ascontiguousarray(
                    a.transpose(2, 3, 1, 0))
            continue
        if module.startswith("norm") or module == "final_norm":
            flat["/".join(parts + ["scale" if leaf == "weight" else "bias"])] = a
            continue
        if module == "embed":
            flat["/".join(parts + ["embedding"])] = a
            continue
        if leaf == "bias":
            if module == "qkv":
                a = a.reshape(3, num_heads, -1)
            elif module in ("q", "k", "v"):
                a = a.reshape(num_heads, -1)
            flat["/".join(parts + ["bias"])] = a
            continue
        d_in = a.shape[1]
        if module == "qkv":
            k = a.T.reshape(d_in, 3, num_heads, -1)
        elif module in ("q", "k", "v", "pos"):
            k = a.T.reshape(d_in, num_heads, -1)
        elif module == "depthwise":
            k = a.transpose(2, 1, 0)
        elif module == "out":
            k = a.T.reshape(num_heads, -1, a.shape[0])
        else:
            k = a.T
        flat["/".join(parts + ["kernel"])] = np.ascontiguousarray(k)
    return unflatten(flat)


def random_state_dict(model: torch.nn.Module, seed: int) -> dict[str, torch.Tensor]:
    """Seeded random weights for ``model`` (numpy RNG, so the values do not
    depend on the torch build): matrices ~ N(0, 1/fan_in), biases and the
    conformer's per-head ``u_bias``/``v_bias`` ~ N(0, 0.02^2) (the
    reference's initializer for those), LayerNorm scales 1, embeddings ~
    N(0, 1), an LSTM's ``recurrent [H, 4H]`` with orthonormal rows (QR of
    a normal draw)."""
    rng = np.random.default_rng(seed)
    sd = {}
    for key, t in model.state_dict().items():
        shape = tuple(t.shape)
        names = key.split(".")
        if names[-2].startswith("norm") or names[-2] == "final_norm":
            a = np.ones(shape) if names[-1] == "weight" else np.zeros(shape)
        elif names[-2] == "embed":
            a = rng.standard_normal(shape)
        elif names[-1] == "recurrent":
            q, _ = np.linalg.qr(rng.standard_normal(shape[::-1]))
            a = q.T
        elif names[-1] in ("bias", "u_bias", "v_bias"):
            a = 0.02 * rng.standard_normal(shape)
        else:
            fan_in = int(np.prod(shape[1:]))
            a = rng.standard_normal(shape) / np.sqrt(fan_in)
        sd[key] = torch.from_numpy(np.ascontiguousarray(a, np.float32))
    return sd


LM_KEY = "__lm__"   # a bundle's LM subtree, as the reference names it


def split_lm(tree) -> tuple[dict, dict | None]:
    """A bundle's tree (nested or flat) -> (the ASR model's flat tree, the
    LM's nested tree or None when it carries no ``__lm__`` leaves)."""
    flat = flatten_tree(tree)
    prefix = LM_KEY + "/"
    lm = {k[len(prefix):]: a for k, a in flat.items() if k.startswith(prefix)}
    asr = {k: a for k, a in flat.items() if not k.startswith(prefix)}
    return asr, (unflatten(lm) if lm else None)


def flax_to_lm_state_dict(tree) -> dict[str, torch.Tensor]:
    """A Flax-layout LM tree -> ``LSTMLM``'s state_dict: Dense kernels
    [in, out] become contiguous fp32 ``weight [out, in]``, the embedding
    and the recurrent matrices keep their layout."""
    sd = {}
    for key, a in flatten_tree(tree).items():
        parts = key.split("/")
        if parts[-1] == "kernel":
            a, parts[-1] = a.T, "weight"
        elif parts[-1] == "embedding":
            parts[-1] = "weight"
        sd[".".join(parts)] = torch.tensor(np.ascontiguousarray(a),
                                           dtype=torch.float32)
    return sd


def lm_state_dict_to_flax(sd: dict[str, torch.Tensor]) -> dict:
    """Inverse of :func:`flax_to_lm_state_dict` (nested dict of fp32
    numpy)."""
    flat = {}
    for key, t in sd.items():
        a = t.detach().to("cpu", torch.float32).numpy()
        parts = key.split(".")
        if parts[-1] == "weight":
            if parts[0] == "embed":
                parts[-1] = "embedding"
            else:
                a, parts[-1] = np.ascontiguousarray(a.T), "kernel"
        flat["/".join(parts)] = a
    return unflatten(flat)
