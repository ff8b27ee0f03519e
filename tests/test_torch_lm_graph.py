"""The LM engine's step bodies, which ``Engine(jit=True)`` captures as CUDA
graphs on the card (decode as one graph, prefill as one a prompt length),
pinned on the CPU, where no capture can run: they make no host read, the
engine's one row cache is reset to what ``init_cache`` makes before each
prefill, and the slot pool, the decode graph's storage, never moves.

The reduced smollm config from a seeded ``init_model``; cache contents and
tokens are compared exactly (the same ops on the same inputs)."""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch.serve import Engine, Request
from repro_torch.nn import attention as attn
from repro_torch.nn import transformer as T

CACHE_LEN = 96


@pytest.fixture(scope="module")
def cfg():
    return get_config("smollm-360m").reduced()


def engine(cfg, **kw):
    return Engine(cfg, slots=2, cache_len=CACHE_LEN, seed=0, device="cpu",
                  **kw)


def prompt(cfg, n, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, n).tolist()


def _host_read(*_args, **_kw):
    raise AssertionError("a host read in a step body")


HOST_READS = ("item", "tolist", "cpu", "numpy", "nonzero", "__int__",
              "__float__", "__index__", "__bool__")


@pytest.mark.parametrize("flash", [True, False])
def test_step_bodies_make_no_host_read(cfg, flash, monkeypatch):
    """The prefill and decode bodies run with every way of reading a
    tensor on the host patched to raise (one decode row past the cache's
    end, which the write drops on the device); the same patch does stop
    the per-row scatter of a multi-token write at tensor positions, which
    the prefill must not reach."""
    eng = engine(cfg, flash=flash)
    tokens = torch.tensor([prompt(cfg, 77, 1)])
    inputs = torch.tensor([[3, 77], [5, CACHE_LEN + 4]])
    want_first = eng._prefill_body(tokens)
    want_next = eng._decode_body(inputs)
    for name in HOST_READS:
        monkeypatch.setattr(torch.Tensor, name, _host_read)
    first = eng._prefill_body(tokens)
    nxt = eng._decode_body(inputs)
    kv = torch.zeros((2, cfg.n_kv_heads, 3, cfg.head_dim))
    with pytest.raises(AssertionError, match="host read"):
        attn.cache_update(attn.init_kv_cache(2, cfg.n_kv_heads, 8,
                                             cfg.head_dim), kv, kv,
                          torch.tensor([0, 2]))
    monkeypatch.undo()
    assert first.shape == (1,) and nxt.shape == (2,)
    assert torch.equal(first, want_first) and torch.equal(nxt, want_next)


def test_row_cache_is_reset_before_each_prefill(cfg):
    """A 77-token prefill and then a 5-token one leave the row cache equal,
    bit for bit, to a 5-token prefill into a fresh ``init_cache``: no slot
    the long prompt filled stays marked valid."""
    eng = engine(cfg)
    short = prompt(cfg, 5, 2)
    eng.prefill(prompt(cfg, 77, 1))
    first = eng.prefill(short)
    fresh = T.init_cache(cfg, 1, CACHE_LEN, device="cpu")
    logits, fresh, _ = T.model_apply(
        eng.params, {"tokens": torch.tensor([short]), "cache_pos": 0}, cfg,
        mode="prefill", cache=fresh, compute_dtype=eng.compute_dtype)
    for name, leaf in fresh["kv"].items():
        assert torch.equal(eng.row["kv"][name], leaf), name
    assert int((eng.row["kv"]["positions"] >= 0).sum()) == 5 * cfg.n_layers
    assert first == int(logits[0, -1].argmax())


def test_slot_pool_storage_never_moves(cfg):
    """The pool dict and its tensors are the same objects at the same
    addresses across ``_admit``, ``step`` and ``run``: a captured decode
    graph keeps writing where the engine reads."""
    eng = engine(cfg)
    pool, row = eng.pool, eng.row

    def addresses():
        return {f"{tree}/{name}": leaf.data_ptr()
                for tree, cache in (("pool", eng.pool), ("row", eng.row))
                for name, leaf in cache["kv"].items()}

    before = addresses()
    for i, n in enumerate((5, 77, 30)):
        eng.submit(Request(rid=i, prompt=prompt(cfg, n, i), max_new=4))
    for advance in (eng._admit, eng.step, eng.run):
        advance()
        assert eng.pool is pool and eng.row is row
        assert addresses() == before
    assert sorted(len(r.out) for r in eng.done) == [4, 4, 4]
