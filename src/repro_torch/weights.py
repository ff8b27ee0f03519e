"""The weight bridge: parameter trees of the JAX reference into the port
(the Spikformer trees, and the LM trees with ``lm_from_reference``).

``from_reference`` takes a reference tree — training params, a
``fold_inference_params`` tree or a ``quantize_folded`` tree — whose leaves
are numpy arrays (or anything ``np.asarray`` accepts) and returns the same
nested dict of tensors on ``device``, dtypes kept. Parity tests feed both
packages one tree this way, so a mismatch always points at the datapath.
"""
from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .nn.ssm import ssm_dims
from .nn.transformer import require_ported


def from_reference(tree, device="cpu"):
    if isinstance(tree, dict):
        return {k: from_reference(v, device) for k, v in tree.items()}
    if isinstance(tree, bool):          # a planner flag, not a weight
        return tree
    x = np.array(tree)
    if x.dtype.name == "bfloat16":      # numpy holds it as ml_dtypes'
        return torch.from_numpy(x.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(x).to(device)


def lm_from_reference(tree, cfg, device=None):
    """``repro.nn.transformer.init_model``'s tree, numpy leaves, as the
    port's LM parameters on ``device`` (default: the card). The layout is
    the same in both packages (stacked (L, ...) layers, the SSM and hybrid
    families' too), so this checks the shapes the config implies (the
    norms' scales and biases, the QKV biases and QK-norm scales where the
    config has them, an MoE layer's router, f32, and experts, and the
    dense MLP beside them where ``cfg.dense_parallel``) and copies the
    leaves, dtypes kept."""
    require_ported(cfg)
    device = resolve_device(device)
    n_layers, d = cfg.n_layers, cfg.d_model
    want = {"embed/embedding": (cfg.padded_vocab, d),
            "layers/ln1/scale": (n_layers, d)}
    if cfg.norm == "layernorm":
        want["layers/ln1/bias"] = (n_layers, d)
        want["final_norm/bias"] = (d,)
    if cfg.family != "ssm":
        q_dim = cfg.n_heads * cfg.head_dim
        kv_dim = cfg.n_kv_heads * cfg.head_dim
        want["layers/attn/wq/kernel"] = (n_layers, d, q_dim)
        want["layers/attn/wk/kernel"] = (n_layers, d, kv_dim)
        if cfg.qkv_bias:
            want["layers/attn/wq/bias"] = (n_layers, q_dim)
            want["layers/attn/wk/bias"] = (n_layers, kv_dim)
            want["layers/attn/wv/bias"] = (n_layers, kv_dim)
        if cfg.qk_norm:
            want["layers/attn/q_norm/scale"] = (n_layers, cfg.head_dim)
            want["layers/attn/k_norm/scale"] = (n_layers, cfg.head_dim)
    if cfg.family in ("ssm", "hybrid"):
        d_inner, heads, conv_dim = ssm_dims(cfg)
        gn = cfg.ssm_groups * cfg.ssm_state
        want["layers/ssm/in_proj"] = (n_layers, d,
                                      2 * d_inner + 2 * gn + heads)
        want["layers/ssm/conv_w"] = (n_layers, cfg.ssm_conv, conv_dim)
    if cfg.n_experts:
        e, f = cfg.n_experts, cfg.moe_d_ff
        want["layers/moe/router"] = (n_layers, d, e)
        want["layers/moe/w_gate"] = (n_layers, e, d, f)
        want["layers/moe/w_up"] = (n_layers, e, d, f)
        want["layers/moe/w_down"] = (n_layers, e, f, d)
        if cfg.dense_parallel:
            names = ("gate", "up", "down") if cfg.act == "swiglu" \
                else ("up", "down")
            for name in names:
                shape = (cfg.d_ff, d) if name == "down" else (d, cfg.d_ff)
                want[f"layers/mlp/{name}/kernel"] = (n_layers,) + shape
    for path, shape in want.items():
        leaf = tree
        for key in path.split("/"):
            if key not in leaf:
                raise ValueError(f"{path} is missing, the config {cfg.name} "
                                 f"needs {shape}")
            leaf = leaf[key]
        if tuple(np.shape(leaf)) != shape:
            raise ValueError(f"{path} is {tuple(np.shape(leaf))}, the config "
                             f"{cfg.name} needs {shape}")
    if cfg.n_experts:
        router = np.asarray(tree["layers"]["moe"]["router"])
        if router.dtype != np.float32:
            raise ValueError(f"layers/moe/router is {router.dtype}, the "
                             "router is kept f32 whatever the param dtype")
    return from_reference(tree, device)
