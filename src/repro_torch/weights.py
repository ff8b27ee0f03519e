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


def _mlp_names(cfg):
    return ("gate", "up", "down") if cfg.act == "swiglu" else ("up", "down")


def _mlp_shape(cfg, name):
    return (cfg.d_ff, cfg.d_model) if name == "down" else (cfg.d_model,
                                                           cfg.d_ff)


def lm_from_reference(tree, cfg, device=None):
    """``repro.nn.transformer.init_model``'s tree, numpy leaves, as the
    port's LM parameters on ``device`` (default: the card). The layout is
    the same in both packages (stacked (L, ...) layers, the SSM and hybrid
    families' too), so this checks the shapes the config implies (the
    norms' scales and biases, the QKV biases and QK-norm scales where the
    config has them, an MoE layer's router, f32, and experts, the dense
    MLP beside them where ``cfg.dense_parallel``, an encoder-decoder's
    encoder layers, ``enc_norm`` and each decoder layer's cross-attention
    and ``ln_cross``) and copies the leaves, dtypes kept."""
    require_ported(cfg)
    device = resolve_device(device)
    n_layers, d = cfg.n_layers, cfg.d_model
    want = {"embed/embedding": (cfg.padded_vocab, d),
            "layers/ln1/scale": (n_layers, d)}
    if cfg.norm == "layernorm":
        want["layers/ln1/bias"] = (n_layers, d)
        want["final_norm/bias"] = (d,)
    q_dim = cfg.n_heads * cfg.head_dim
    kv_dim = cfg.n_kv_heads * cfg.head_dim

    def attention(prefix, n):
        want[f"{prefix}/wq/kernel"] = (n, d, q_dim)
        want[f"{prefix}/wk/kernel"] = (n, d, kv_dim)
        want[f"{prefix}/wv/kernel"] = (n, d, kv_dim)
        want[f"{prefix}/wo/kernel"] = (n, q_dim, d)
        if cfg.qkv_bias:
            want[f"{prefix}/wq/bias"] = (n, q_dim)
            want[f"{prefix}/wk/bias"] = (n, kv_dim)
            want[f"{prefix}/wv/bias"] = (n, kv_dim)
        if cfg.qk_norm:
            want[f"{prefix}/q_norm/scale"] = (n, cfg.head_dim)
            want[f"{prefix}/k_norm/scale"] = (n, cfg.head_dim)

    def norm(prefix, lead):
        want[f"{prefix}/scale"] = lead + (d,)
        if cfg.norm == "layernorm":
            want[f"{prefix}/bias"] = lead + (d,)

    if cfg.family != "ssm":
        attention("layers/attn", n_layers)
    if cfg.cross_attention:
        attention("layers/cross", n_layers)
        norm("layers/ln_cross", (n_layers,))
    if cfg.family == "encdec":
        n_enc = cfg.encoder_layers
        attention("enc_layers/attn", n_enc)
        for name in ("ln1", "ln2"):
            norm(f"enc_layers/{name}", (n_enc,))
        for name in _mlp_names(cfg):
            want[f"enc_layers/mlp/{name}/kernel"] = (n_enc,) + _mlp_shape(
                cfg, name)
        norm("enc_norm", ())
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
            for name in _mlp_names(cfg):
                want[f"layers/mlp/{name}/kernel"] = (n_layers,) + _mlp_shape(
                    cfg, name)
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
