"""v2 data-type declarations. Counterpart of ``paddle_tpu/v2/data_type.py``
(reference v2/data_type.py -> trainer/PyDataProvider2.py InputType): each
describes one feed slot; ``layer.data`` turns them into typed data
variables.

The sparse types declare padded id-list feeds, as in the JAX package: a
``sparse_binary_vector(dim)`` row is a list of active indices and a
``sparse_float_vector(dim)`` row a list of (index, value) pairs, consumed
by ``layer.fc`` through an embedding sum (weighted by the values). That
embedding's gradient is dense, as the JAX package builds it.
"""


class InputType:
    def __init__(self, dim, seq_type, dtype, sparse=None):
        self.dim = dim
        self.seq_type = seq_type  # 0 = no sequence, 1 = sequence
        self.dtype = dtype
        self.sparse = sparse  # None | "binary" | "float"


def dense_vector(dim):
    return InputType(dim, 0, "float32")


def dense_array(dim):
    return InputType(dim, 0, "float32")


def integer_value(value_range):
    return InputType(value_range, 0, "int64")


def dense_vector_sequence(dim):
    return InputType(dim, 1, "float32")


def integer_value_sequence(value_range):
    return InputType(value_range, 1, "int64")


def sparse_binary_vector(dim):
    """Rows are lists of active indices (multi-hot positions)."""
    return InputType(dim, 0, "int64", sparse="binary")


def sparse_float_vector(dim):
    """Rows are lists of (index, value) pairs."""
    return InputType(dim, 0, "int64", sparse="float")
