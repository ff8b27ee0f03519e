"""Helpers the LM parity tests share: tolerance checks, a reference tree
with its zero biases and unit norm scales made nonzero, and the
gradient, train-step and checkpoint comparisons against the JAX
package. Both sides' batches are built by the caller."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.launch import steps as jsteps
from repro.nn import module as jmodule
from repro.nn import transformer as JT
from repro.optim import adamw as jadamw
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.launch import steps
from repro_torch.nn import module
from repro_torch.nn import transformer as T
from repro_torch.optim import adamw

TOL = 1e-4


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=tol,
                               atol=tol)


def t_(x):
    return torch.from_numpy(np.array(x))


def leaf_paths(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaf_paths(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def nonzero_norms_and_biases(tree, seed):
    """The numpy tree with every ``bias`` leaf drawn from N(0, 0.1^2) and
    every ``scale`` leaf from 1 + N(0, 0.1^2), seeded."""
    r = np.random.default_rng(seed)

    def walk(node):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k == "bias":
                out[k] = (0.1 * r.normal(size=v.shape)).astype(v.dtype)
            elif k == "scale":
                out[k] = (1 + 0.1 * r.normal(size=v.shape)).astype(v.dtype)
            else:
                out[k] = v
        return out
    return walk(tree)


def f32(jcfg, cfg):
    return (dataclasses.replace(jcfg, compute_dtype="float32"),
            dataclasses.replace(cfg, compute_dtype="float32"))


def with_labels(jb, tb):
    """The batches with next-token labels (the tokens rolled by one)."""
    return (dict(jb, labels=jnp.roll(jb["tokens"], -1, axis=1)),
            dict(tb, labels=torch.roll(tb["tokens"], -1, dims=1)))


def check_loss_and_grads(jcfg, cfg, tree, tp, jb, tb):
    """``lm_loss`` in f32 and every gradient leaf against
    ``jax.value_and_grad``: the loss within TOL, each leaf within TOL of
    its largest |g|. Returns the port's gradients by path."""
    jcfg, cfg = f32(jcfg, cfg)
    jb, tb = with_labels(jb, tb)
    (jloss, _), jg = jax.jit(jax.value_and_grad(JT.lm_loss, has_aux=True),
                             static_argnums=2)(tree, jb, jcfg)
    leaves = {p: t.detach().requires_grad_()
              for p, t in module.tree_paths(tp)}
    loss, _ = T.lm_loss(module.map_with_path(lambda p, _: leaves[p], tp),
                        tb, cfg)
    grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                 list(leaves.values()))))
    close(loss.detach(), jloss)
    want = dict(jmodule.tree_paths(jg))
    assert sorted(want) == sorted(grads)
    for path, g in grads.items():
        w = np.asarray(want[path], np.float64)
        scale = max(np.abs(w).max(), 1e-30)
        assert np.abs(g.double().numpy() - w).max() <= TOL * scale, path
    return grads


def check_three_train_steps(jcfg, cfg, tree, tp, batches):
    """Three steps of ``make_train_step`` in f32, microbatches of 2, AdamW
    through warmup and decay, on ``batches(i) -> (jax batch, torch
    batch)``: losses, gradient norms and learning rates within rtol 1e-5,
    then the params and moments within TOL."""
    jcfg, cfg = f32(jcfg, cfg)
    opt = dict(peak_lr=1e-3, warmup_steps=1, decay_steps=4)
    jts = jsteps.TrainSettings(microbatch=2, opt=jadamw.OptConfig(**opt))
    ts = steps.TrainSettings(microbatch=2, opt=adamw.OptConfig(**opt))
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    jo = jadamw.init(jp, jts.opt)
    to = adamw.init(tp, steps.opt_config(cfg, ts))
    jstep = jax.jit(jsteps.make_train_step(jcfg, jts))
    step = steps.make_train_step(cfg, ts)
    for i in range(3):
        jb, tb = with_labels(*batches(i))
        jp, jo, jm = jstep(jp, jo, jb)
        tp, to, m = step(tp, to, tb)
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                                       err_msg=f"step {i} {k}")
    want = dict(jmodule.tree_paths({"p": jp, "o": jo}))
    for path, t in module.tree_paths({"p": tp, "o": to}):
        close(t, want[path])


def check_checkpoint_crosses(cfg, tree, tp, direction, tmp_path):
    """The tree saved by one package's checkpointer restores in the
    other's bit for bit: the port's tree into the reference's (skeleton
    from the numpy tree) or the reference's into the port's (skeleton
    ``steps.abstract_params``)."""
    if direction == "port_to_reference":
        Checkpointer(str(tmp_path)).save(2, tp, extra={"step": 2},
                                         block=True)
        skel = jax.tree_util.tree_map(
            lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), tree)
        got, extra = JCheckpointer(str(tmp_path)).restore(skeleton=skel)
        got = jax.tree_util.tree_map(np.asarray, got)
    else:
        JCheckpointer(str(tmp_path)).save(
            2, jax.tree_util.tree_map(jnp.asarray, tree), extra={"step": 2},
            block=True)
        got, extra = Checkpointer(str(tmp_path)).restore(
            skeleton=steps.abstract_params(cfg))
    assert extra == {"step": 2}
    got = dict(leaf_paths(got))
    assert got.keys() == dict(leaf_paths(tree)).keys()
    for path, want in leaf_paths(tree):
        np.testing.assert_array_equal(np.asarray(got[path]), want,
                                      err_msg=path)
