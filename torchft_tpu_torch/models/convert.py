"""Weights from the JAX package's flax Llama into the port's state dict.

The only way weights cross between the packages. The caller turns the
flax param tree into numpy arrays (``jax.tree_util.tree_map(np.asarray,
params)``); this module never imports jax.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from torchft_tpu_torch.models.llama import LlamaConfig

__all__ = ["llama_state_dict_from_jax"]


def _tensor(a: Any) -> torch.Tensor:
    a = np.array(a)  # a writable, contiguous copy
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: same bits as torch's
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _block(tree: Mapping[str, Any], dim: int) -> Dict[str, np.ndarray]:
    """One layer's leaves, keyed by the port's names, in torch layouts:
    flax kernels are (in, ..., out); torch Linear weights are (out, in)."""
    attn, mlp = tree["attn"], tree["mlp"]
    return {
        "attn_norm.scale": tree["attn_norm"]["scale"],
        "attn.wq.weight": attn["wq"]["kernel"].reshape(dim, -1).T,  # (dim, h, hd)
        "attn.wk.weight": attn["wk"]["kernel"].reshape(dim, -1).T,  # (dim, kv, hd)
        "attn.wv.weight": attn["wv"]["kernel"].reshape(dim, -1).T,
        "attn.wo.weight": attn["wo"]["kernel"].reshape(-1, dim).T,  # (h, hd, dim)
        "mlp_norm.scale": tree["mlp_norm"]["scale"],
        "mlp.w_gate.weight": mlp["w_gate"]["kernel"].T,  # (dim, ffn)
        "mlp.w_up.weight": mlp["w_up"]["kernel"].T,
        "mlp.w_down.weight": mlp["w_down"]["kernel"].T,  # (ffn, dim)
    }


def llama_state_dict_from_jax(
    params: Mapping[str, Any], config: LlamaConfig
) -> Dict[str, torch.Tensor]:
    """The port's ``Llama`` state dict from a flax ``Llama.init`` tree of
    numpy arrays (with or without the outer ``{"params": ...}``). Handles
    both layer layouts: ``layer_{i}/...`` and the stacked ``layers/block/
    ...`` of ``scan_layers=True``, whose leaves carry a leading layer axis.
    Dtypes are kept as given; ``load_state_dict`` casts into the model."""
    if "params" in params:
        params = params["params"]
    dim = config.dim
    layers = []
    if "layers" in params:
        stacked = params["layers"]["block"]
        for i in range(config.n_layers):
            layers.append(_block(_index_tree(stacked, i), dim))
    else:
        layers = [_block(params[f"layer_{i}"], dim) for i in range(config.n_layers)]
    out = {"tok_embed.weight": params["tok_embed"]["embedding"]}
    for i, leaves in enumerate(layers):
        out.update({f"layers.{i}.{name}": leaf for name, leaf in leaves.items()})
    out["final_norm.scale"] = params["final_norm"]["scale"]
    if not config.tie_embeddings:
        out["lm_head.weight"] = params["lm_head"]["kernel"].T  # (dim, vocab)
    return {name: _tensor(leaf) for name, leaf in out.items()}


def _index_tree(tree: Mapping[str, Any], i: int) -> Dict[str, Any]:
    return {
        key: _index_tree(value, i) if isinstance(value, Mapping) else np.asarray(value)[i]
        for key, value in tree.items()
    }
