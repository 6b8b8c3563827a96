"""SelectedRows: row-sparse gradient values for large embeddings.

Counterpart of ``paddle_tpu/core/selected_rows.py``. A sparse embedding's
gradient is ``rows`` ([n] int64 row ids, possibly repeated, with the
sentinel ``height`` marking a slot to ignore) and ``values`` ([n, D]):
``dense[rows[i]] += values[i]``. n is the number of looked-up ids in the
batch, so nothing here allocates a [height, D] buffer but ``to_dense``.

Every operation keeps its work on the device: the unique count of
``merged`` stays a tensor (the slots past it carry the sentinel), and
``scatter_rows_``/``set_rows_`` write rows into a table in place (the
JAX executor donates the table; a copy of it a step is what the sparse
path exists to avoid) with no host sync, no ``nonzero`` and no
boolean-mask indexing. On the CPU ``merged`` sums each row's duplicates
in the JAX package's order, so its values equal JAX's bit for bit.
"""
from __future__ import annotations

import torch


class SelectedRows:
    """A row-sparse value: ``dense[rows[i]] += values[i]``.

    ``height`` is the dense leading-dim size; a row id outside
    [0, height), the ``height`` sentinel in particular, is padding and
    every consumer drops it.
    """

    __slots__ = ("rows", "values", "height")

    def __init__(self, rows, values, height: int):
        self.rows = rows
        self.values = values
        self.height = int(height)

    # -- tensor-ish surface ------------------------------------------------
    @property
    def dtype(self):
        return self.values.dtype

    @property
    def dense_shape(self):
        return (self.height,) + tuple(self.values.shape[1:])

    @property
    def shape(self):
        """The dense view's shape, as the JAX class gives it."""
        return self.dense_shape

    @property
    def ndim(self):
        return len(self.dense_shape)

    def astype(self, dtype):
        return SelectedRows(self.rows, self.values.to(dtype), self.height)

    def scale(self, s):
        return SelectedRows(self.rows, self.values * s, self.height)

    def valid(self):
        """[n] bool: the slots whose row lies in the table."""
        return (self.rows >= 0) & (self.rows < self.height)

    def to_dense(self):
        """The dense [height, D] tensor (a scatter-add that drops the
        padding slots). For densifying consumers and tests only: the
        optimizer ops never call it."""
        base = torch.zeros(self.dense_shape, dtype=self.values.dtype,
                           device=self.values.device)
        return scatter_rows_(base, self, self.values)

    def merged(self) -> "SelectedRows":
        """Deduplicate rows: a stable sort of the ids and a segment-sum of
        each id's values in sorted order. The length n stays; the slots
        past the unique count carry the ``height`` sentinel and zeros."""
        n = self.rows.shape[0]
        if n <= 1:
            return self
        rows, order = torch.sort(self.rows, stable=True)
        vals = self.values[order]
        seg = torch.cumsum(torch.cat([
            torch.zeros_like(rows[:1]), (rows[1:] != rows[:-1]).long()]), 0)
        # index_add sums a segment's values one after the other in sorted
        # order on the CPU (jax.ops.segment_sum's order, so the sums are
        # JAX's bit for bit); on CUDA it adds them by atomics, in the
        # order they land
        merged_vals = torch.zeros_like(vals).index_add_(0, seg, vals)
        # every duplicate of a segment writes the same id: any order wins
        merged_rows = torch.full_like(rows, self.height).scatter_(
            0, seg, rows)
        return SelectedRows(merged_rows, merged_vals, self.height)

    def __add__(self, other):
        if isinstance(other, SelectedRows):
            if other.height != self.height:
                raise ValueError(
                    f"SelectedRows height mismatch: {self.height} vs "
                    f"{other.height}")
            return SelectedRows(
                torch.cat([self.rows, other.rows]),
                torch.cat([self.values, other.values], 0), self.height)
        # dense + sparse: densify (a fan-out through a dense consumer)
        return self.to_dense() + other

    __radd__ = __add__

    def __mul__(self, s):
        return self.scale(s)

    __rmul__ = __mul__

    def __repr__(self):
        return (f"SelectedRows(n={self.rows.shape[0]}, "
                f"dense_shape={self.dense_shape}, dtype={self.dtype})")


def is_selected_rows(x) -> bool:
    return isinstance(x, SelectedRows)


def densify(x):
    """Dense view of either a SelectedRows or a dense tensor."""
    return x.to_dense() if isinstance(x, SelectedRows) else x


def _redirect(m: SelectedRows):
    """(index, keep): each padding slot points at the first slot's row,
    clamped into the table. A merged value has each real row once, so an
    un-accumulated write through ``index`` touches each real row from one
    slot and the clamp row from the padding slots too, which write there
    what that row must end up with."""
    keep = m.valid()
    first = m.rows[:1].clamp(0, m.height - 1)
    return torch.where(keep, m.rows, first), keep


def gather_rows(table, m: SelectedRows):
    """table[rows] for a merged SelectedRows, padding slots reading the
    first slot's row (JAX clamps them: their values are never kept)."""
    index, _ = _redirect(m)
    return table[index]


def scatter_rows_(table, m: SelectedRows, values):
    """``table.at[rows].add(values, mode="drop")`` in place; returns
    ``table``. Each real slot adds its value to its row, in slot order on
    the CPU (JAX's order), by atomics on CUDA; a padding slot adds an
    exact zero."""
    index, keep = _redirect(m)
    shaped = keep.reshape((-1,) + (1,) * (values.ndim - 1))
    values = torch.where(shaped, values, torch.zeros_like(values))
    return table.index_add_(0, index, values)


def set_rows_(table, m: SelectedRows, values):
    """``table.at[rows].set(values, mode="drop")`` in place for a merged
    SelectedRows; returns ``table``. A padding slot writes to the clamp
    row the value it ends with: the first slot's new value when that slot
    is real, else the row's old value (every slot is padding then)."""
    index, keep = _redirect(m)
    shaped = keep.reshape((-1,) + (1,) * (values.ndim - 1))
    fill = torch.where(shaped[:1], values[:1], table[index[:1]])
    values = torch.where(shaped, values, fill.expand_as(values))
    return table.index_put_((index,), values)
