"""The port's SelectedRows (``paddle_tpu_torch/core/selected_rows.py``)
against the JAX package's, on the same numpy inputs from a seed.

``to_dense``, ``merged`` (ids with duplicates, the ``height`` sentinel
and ids past the table), add and scale equal JAX's bit for bit: the CPU
sums each row's duplicates in JAX's order. The row helpers the optimizer
ops use (``gather_rows`` and the in-place ``scatter_rows_`` and
``set_rows_``) equal ``table[rows]`` and
``table.at[rows].add/set(mode="drop")`` bit for bit on every real row,
in cases where every slot, the first slot or no slot is padding.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core.selected_rows import SelectedRows as JSR
from paddle_tpu_torch.core import selected_rows as tsr
from paddle_tpu_torch.core.selected_rows import SelectedRows as TSR

torch.set_num_threads(1)
HEIGHT, D = 40, 6


def _case(seed, n, hot=5, pad_frac=0.2):
    """n row ids, most from a small hot set (many duplicates), some the
    sentinel, and f32 values of mixed magnitude."""
    rng = np.random.RandomState(seed)
    rows = np.where(rng.rand(n) < 0.7, rng.randint(0, hot, n),
                    rng.randint(0, HEIGHT, n))
    rows = np.where(rng.rand(n) < pad_frac, HEIGHT, rows)
    vals = (rng.randn(n, D) * 10.0 ** rng.randint(-3, 3, (n, 1))).astype(
        np.float32)
    return rows.astype(np.int64), vals


def _both(rows, vals):
    return (JSR(jnp.asarray(rows, jnp.int32), jnp.asarray(vals), HEIGHT),
            TSR(torch.from_numpy(rows), torch.from_numpy(vals), HEIGHT))


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("seed,n", [(0, 1), (1, 2), (2, 17), (3, 64),
                                    (4, 257)])
def test_to_dense_and_merged_bit_for_bit(seed, n):
    j, t = _both(*_case(seed, n))
    _eq(t.to_dense(), j.to_dense())
    jm, tm = j.merged(), t.merged()
    assert tm.height == jm.height == HEIGHT
    _eq(tm.rows, jm.rows)
    _eq(tm.values, jm.values)
    _eq(tm.to_dense(), jm.to_dense())
    uniq = sorted(set(t.rows.tolist()) - {HEIGHT})
    if n > 1:
        assert tm.rows[:len(uniq)].tolist() == uniq
        assert (tm.rows[len(uniq):] == HEIGHT).all()


def test_ids_past_the_table_are_dropped():
    rows = np.array([3, HEIGHT + 4, 3, HEIGHT, 0], np.int64)
    vals = np.arange(5 * D, dtype=np.float32).reshape(5, D)
    j, t = _both(rows, vals)
    _eq(t.to_dense(), j.to_dense())
    _eq(t.merged().to_dense(), j.merged().to_dense())


def test_add_and_scale():
    (ja, ta), (jb, tb) = (_both(*_case(s, 9)) for s in (5, 6))
    js, ts = ja + jb, ta + tb
    assert isinstance(ts, TSR) and ts.rows.shape == (18,)
    _eq(ts.to_dense(), js.to_dense())
    dense = np.random.RandomState(7).randn(HEIGHT, D).astype(np.float32)
    _eq(ta + torch.from_numpy(dense), ja + jnp.asarray(dense))
    _eq((0.5 * ta).to_dense(), (0.5 * ja).to_dense())
    _eq(ta.astype(torch.float64).values, np.asarray(ja.values, np.float64))
    assert ta.shape == ta.dense_shape == (HEIGHT, D) and ta.ndim == 2
    with pytest.raises(ValueError, match="height"):
        ta + TSR(tb.rows, tb.values, HEIGHT + 1)
    assert tsr.is_selected_rows(ta) and not tsr.is_selected_rows(dense)
    _eq(tsr.densify(ta), ja.to_dense())


@pytest.mark.parametrize("kind", ["mixed", "first_real_rest_pad",
                                  "all_pad", "no_pad"])
def test_row_helpers_equal_jax_scatters(kind):
    rng = np.random.RandomState(11)
    rows, vals = _case(12, 24, pad_frac={"mixed": 0.3, "no_pad": 0.0,
                                         "all_pad": 1.0,
                                         "first_real_rest_pad": 0.0}[kind])
    if kind == "first_real_rest_pad":
        rows[1:] = HEIGHT
        rows[0] = HEIGHT - 1  # the clamp row is a real row here
    j, t = _both(rows, vals)
    jm, tm = j.merged(), t.merged()
    table = rng.randn(HEIGHT, D).astype(np.float32)
    new = rng.randn(24, D).astype(np.float32)
    jt, tt = jnp.asarray(table), torch.from_numpy(table)
    real = np.asarray(jm.rows) < HEIGHT
    _eq(tsr.gather_rows(tt, tm)[real], jt[jm.rows][real])
    got = tt.clone()
    assert tsr.scatter_rows_(got, tm, torch.from_numpy(new)) is got
    _eq(got, jt.at[jm.rows].add(jnp.asarray(new), mode="drop"))
    got = tt.clone()
    assert tsr.set_rows_(got, tm, torch.from_numpy(new)) is got
    _eq(got, jt.at[jm.rows].set(jnp.asarray(new), mode="drop"))
    # unmerged rows (sgd's rule): duplicates add one after the other
    _eq(tsr.scatter_rows_(tt.clone(), t, torch.from_numpy(vals)),
        jt.at[j.rows].add(j.values, mode="drop"))
    _eq(tt, table)  # the clones took the writes
