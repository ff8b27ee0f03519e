"""The weight bridge: parameter trees of the JAX reference into the port.

``from_reference`` takes a reference tree — training params, a
``fold_inference_params`` tree or a ``quantize_folded`` tree — whose leaves
are numpy arrays (or anything ``np.asarray`` accepts) and returns the same
nested dict of tensors on ``device``, dtypes kept. Parity tests feed both
packages one tree this way, so a mismatch always points at the datapath.
"""
from __future__ import annotations

import numpy as np
import torch


def from_reference(tree, device="cpu"):
    if isinstance(tree, dict):
        return {k: from_reference(v, device) for k, v in tree.items()}
    if isinstance(tree, bool):          # a planner flag, not a weight
        return tree
    return torch.from_numpy(np.array(tree)).to(device)
