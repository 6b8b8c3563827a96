"""The port's page allocator and prefix index (``serving/paging.py``)
against the JAX package's on the same operation sequences: the same pages
handed out in the same order, the same refcounts, reservations, lookups
and LRU evictions, and the same errors."""
import numpy as np
import pytest

from paddle_tpu.serving import paging as jpaging
from paddle_tpu_torch.serving import paging as tpaging


def _both(fn):
    """fn(module) run against each package's paging module; results must
    be equal."""
    a, b = fn(jpaging), fn(tpaging)
    assert a == b
    return b


def _pool_trace(m):
    pool = m.PagePool(12, 4)
    out = [pool.capacity, pool.available()]
    got = [pool.alloc() for _ in range(5)]
    out.append(got)
    pool.incref(got[1])
    out.append([pool.decref(got[i]) for i in (1, 1, 3)])
    pool.reserve(3)
    out.append((pool.available(), pool.stats()))
    out.append([pool.alloc(reserved=True) for _ in range(2)])
    pool.release_reservation(1)
    out.append(pool.alloc_many(4))
    out.append((pool.pages_in_use(), [pool.refcount(p) for p in range(12)],
                pool.stats()))
    for bad in (lambda: pool.decref(0), lambda: pool.incref(0),
                lambda: pool.decref(pool._free[-1]),
                lambda: pool.alloc_many(99),
                lambda: pool.release_reservation(5),
                lambda: pool.alloc(reserved=True), lambda: pool.reserve(-1)):
        with pytest.raises((RuntimeError, ValueError)) as ei:
            bad()
        out.append((type(ei.value).__name__, str(ei.value)))
    while pool.available():
        out.append(pool.alloc())
    with pytest.raises(RuntimeError, match="exhausted"):
        pool.alloc()
    return out


def test_page_pool_matches_jax_operation_for_operation():
    _both(_pool_trace)
    for m in (jpaging, tpaging):
        with pytest.raises(ValueError):
            m.PagePool(1, 4)
        with pytest.raises(ValueError):
            m.PagePool(4, 0)


@pytest.mark.parametrize("tokens", [[1, 2, 3], list(range(64)), []])
def test_chain_keys_match_jax(tokens):
    parent = jpaging.chain_key(None, [9, 9])
    assert tpaging.chain_key(None, tokens) == jpaging.chain_key(None, tokens)
    assert tpaging.chain_key(parent, tokens) == jpaging.chain_key(parent,
                                                                  tokens)


def _index_trace(m):
    """Insert two prompts' pages, share a prefix, hit a full prompt, then
    evict under pressure: every lookup, refcount and stat recorded."""
    rng = np.random.RandomState(0)
    ps = 4
    pool = m.PagePool(10, ps)
    index = m.PrefixIndex(pool)
    sys_p = rng.randint(0, 50, 2 * ps)
    a = np.concatenate([sys_p, rng.randint(0, 50, 3)])
    b = np.concatenate([sys_p, rng.randint(0, 50, 6)])
    out = []
    for prompt in (a, b):
        shared, pages, key = index.lookup(prompt)
        out.append((shared, pages, key.hex()))
        for page in pages:  # lookup takes no reference: the caller does
            pool.incref(page)
        own = [pool.alloc() for _ in range(-(-len(prompt) // ps)
                                           - len(pages))]
        held = pages + own
        key = b""
        for i in range(len(prompt) // ps):
            key = index.insert(key, prompt[i * ps:(i + 1) * ps], held[i])
        tail = prompt[(len(prompt) // ps) * ps:]
        if len(tail):
            index.insert(key, tail, held[len(prompt) // ps])
        for p in held:
            pool.decref(p)
        out.append((held, pool.stats(), index.stats(), len(index)))
    out.append(index.lookup(a)[:2])  # a full-prompt hit
    out.append(index.lookup(np.asarray([7, 7, 7])))
    out.append((index.evict_until(8), pool.available(), index.stats()))
    out.append((index.clear(), pool.pages_in_use(), len(index)))
    return out


def test_prefix_index_matches_jax_operation_for_operation():
    got = _both(_index_trace)
    assert got[2][0] == 8  # b shares a's two system pages
    assert got[4][0] == 11  # a repeated whole: a full-prompt hit
