"""The LM engine's step bodies, which ``Engine(jit=True)`` captures as CUDA
graphs on the card (decode as one graph, prefill as one a prompt length),
pinned on the CPU, where no capture can run: they make no host read, the
engine's one row cache is reset to what ``init_cache`` makes before each
prefill, and the slot pool, the decode graph's storage, never moves.

The reduced smollm config from a seeded ``init_model``, then reduced
hymba (per-layer caches: a linear global layer, ring caches, SSM states)
and mamba2 (stacked SSM states); cache contents and tokens are compared
exactly (the same ops on the same inputs)."""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch.serve import Engine, Request, cache_leaves
from repro_torch.nn import attention as attn
from repro_torch.nn import transformer as T
from torch_threads import one_thread  # noqa: F401  (autouse)

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


# ---------------------------------------------------------------------------
# the hybrid and SSM families: per-layer ring caches, SSM states
# ---------------------------------------------------------------------------

SSM_ARCHS = {"hymba-1.5b": dict(n_layers=3), "mamba2-130m": {}}
SSM_CACHE_LEN = 64


def ssm_engine(arch, **kw):
    """An engine on reduced hymba (3 layers: window 32, global layer 0) or
    mamba2, 2 slots, a 64-token cache (hymba's rings: 32 slots)."""
    cfg = get_config(arch).reduced(**SSM_ARCHS[arch])
    return cfg, Engine(cfg, slots=2, cache_len=SSM_CACHE_LEN, seed=0,
                       device="cpu", **kw)


@pytest.mark.parametrize("arch", sorted(SSM_ARCHS))
def test_ssm_row_cache_is_reset_before_each_prefill(arch):
    """A 40- then a 5-token prefill leave every leaf of the row cache (KV,
    ring KV, positions, SSM state, conv window) equal, bit for bit, to a
    5-token prefill into a fresh ``init_cache``."""
    cfg, eng = ssm_engine(arch)
    short = prompt(cfg, 5, 2)
    eng.prefill(prompt(cfg, 40, 1))
    first = eng.prefill(short)
    fresh = T.init_cache(cfg, 1, SSM_CACHE_LEN, device="cpu")
    logits, fresh, _ = T.model_apply(
        eng.params, {"tokens": torch.tensor([short]), "cache_pos": 0}, cfg,
        mode="prefill", cache=fresh, compute_dtype=eng.compute_dtype)
    got, want = list(cache_leaves(eng.row)), list(cache_leaves(fresh))
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, leaf), (_, ref) in zip(got, want):
        assert torch.equal(leaf, ref), name
    assert first == int(logits[0, -1].argmax())


@pytest.mark.parametrize("arch", sorted(SSM_ARCHS))
@pytest.mark.parametrize("flash", [True, False])
def test_ssm_step_bodies_make_no_host_read(arch, flash, monkeypatch):
    """The prefill (a 40-token prompt: past the window) and decode bodies
    run with every way of reading a tensor on the host patched to raise;
    one decode row wraps its rings, the other passes the cache's end."""
    cfg, eng = ssm_engine(arch, flash=flash)
    _, plain = ssm_engine(arch, flash=flash, params=eng.params)
    tokens = torch.tensor([prompt(cfg, 40, 1)])
    inputs = torch.tensor([[3, 40], [5, SSM_CACHE_LEN + 4]])
    # decode advances the SSM states it reads: the reference values come
    # from a second engine's pool
    want_first = plain._prefill_body(tokens)
    want_next = plain._decode_body(inputs)
    for name in HOST_READS:
        monkeypatch.setattr(torch.Tensor, name, _host_read)
    first = eng._prefill_body(tokens)
    nxt = eng._decode_body(inputs)
    monkeypatch.undo()
    assert torch.equal(first, want_first) and torch.equal(nxt, want_next)


@pytest.mark.parametrize("arch", sorted(SSM_ARCHS))
def test_ssm_splice_and_pool_storage(arch):
    """The pool's and the row's tensors keep their addresses across
    ``_admit``, ``step`` and ``run``; a splice copies every leaf of the
    row into its slot (axis 0 of a per-layer list, axis 1 of a stack)."""
    cfg, eng = ssm_engine(arch)

    def addresses():
        return [leaf.data_ptr() for tree in (eng.pool, eng.row)
                for _, leaf in cache_leaves(tree)]
    before = addresses()
    eng.prefill(prompt(cfg, 9, 4))
    eng._splice(1)
    stacked = not isinstance(eng.pool, list)
    for (_, leaf), (_, row) in zip(cache_leaves(eng.pool),
                                   cache_leaves(eng.row)):
        assert torch.equal(leaf[:, 1] if stacked else leaf[1],
                           row[:, 0] if stacked else row[0])
    for i, n in enumerate((5, 40, 12)):
        eng.submit(Request(rid=i, prompt=prompt(cfg, n, i), max_new=4))
    for advance in (eng._admit, eng.step, eng.run):
        advance()
        assert addresses() == before
    assert sorted(len(r.out) for r in eng.done) == [4, 4, 4]


def test_captures_hold_the_cyclic_collector_off():
    """``device._collector_held_off``, around every capture: objects that
    wait in a reference cycle (a failed capture's graph, held by its
    traceback) are not destroyed during the block, however much it
    allocates, since a CUDA graph's destructor run during a capture
    invalidates that capture; the collector is on again after the block,
    also when the block raises, and then destroys them."""
    import gc
    import weakref

    from repro_torch import device

    class Graph:
        pass

    def dead_cycle():
        g = Graph()
        g.self = g
        return weakref.ref(g)

    assert gc.isenabled()
    with device._collector_held_off():
        assert not gc.isenabled()
        dead = dead_cycle()
        junk = [[] for _ in range(20 * gc.get_threshold()[0])]
        assert dead() is not None        # no automatic collection ran
        del junk
    assert gc.isenabled()
    gc.collect()
    assert dead() is None
    with pytest.raises(ValueError):
        with device._collector_held_off():
            raise ValueError("capture failed")
    assert gc.isenabled()
