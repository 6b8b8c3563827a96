"""PyDataProvider2 compatibility surface.

Counterpart of ``paddle_tpu/v1/data_provider.py``: the decorator API that
reference data-provider modules are written against (reference
python/paddle/trainer/PyDataProvider2.py), the ``@provider`` decorator
plus the input-type declarations. A decorated process function becomes a
:class:`DataProvider` the v1 trainer (``v1/trainer.py``) drives: it makes
a ``settings`` namespace, runs the ``init_hook`` (which may fill
``settings.input_types``, the reference's late-binding idiom), then
iterates the generator over each data file.

The cache and pool knobs of the reference decorator are accepted for
source compatibility; only CACHE_PASS_IN_MEM changes behaviour (the first
pass's rows are kept in memory, the reference semantics). The rest tuned
the C++ trainer's reader threads, which this in-process reader has not.
"""
from __future__ import annotations

from ..v2.data_type import (InputType, dense_vector,  # noqa: F401
                            dense_vector_sequence, integer_value,
                            integer_value_sequence, sparse_binary_vector,
                            sparse_float_vector)

__all__ = [
    "provider", "DataProvider", "ProviderSettings", "CacheType",
    "dense_vector", "dense_array", "dense_vector_sequence",
    "integer_value", "integer_value_sequence", "integer_sequence",
    "sparse_binary_vector", "sparse_binary_vector_sequence",
    "sparse_float_vector", "sparse_float_vector_sequence",
]


def dense_array(dim):
    return dense_vector(dim)


def sparse_binary_vector_sequence(dim):
    """Per-timestep active-index lists (a row is [[ids...], [ids...], ...])."""
    return InputType(dim, 1, "int64", sparse="binary")


def sparse_float_vector_sequence(dim):
    return InputType(dim, 1, "int64", sparse="float")


# reference alias (PyDataProvider2.py: integer_sequence)
integer_sequence = integer_value_sequence


class CacheType:
    NO_CACHE = 0
    CACHE_PASS_IN_MEM = 1


class ProviderSettings:
    """The ``settings`` namespace handed to init_hook and the process
    generator. init_hook conventionally sets ``input_types`` and stashes
    whatever state process() needs (reference PyDataProvider2.py
    DataProvider.__init__)."""

    def __init__(self):
        self.input_types = None
        self.should_shuffle = None

    def __repr__(self):
        return f"ProviderSettings({sorted(self.__dict__)})"


class DataProvider:
    """What ``@provider`` returns: holds the generator + declaration."""

    def __init__(self, fn, input_types=None, init_hook=None,
                 cache=CacheType.NO_CACHE, **kw):
        self.fn = fn
        self.input_types = input_types
        self.init_hook = init_hook
        self.cache = cache
        self.extra = kw
        self.__name__ = getattr(fn, "__name__", "provider")

    def create(self, file_list=None, **args):
        """Instantiate settings (running init_hook with the
        define_py_data_sources2 ``args``); returns the settings object.
        After this, ``input_types`` is resolved (dict keyed by data-layer
        name, or a positional list). ``file_list`` is always passed to
        the hook — the reference contract (PyDataProvider2.py:434:
        init_hook(settings, file_list, **kwargs))."""
        settings = ProviderSettings()
        settings.input_types = self.input_types
        settings.file_list = list(file_list or [])
        if self.init_hook is not None:
            import inspect

            params = inspect.signature(self.init_hook).parameters
            takes_fl = ("file_list" in params
                        or any(p.kind is inspect.Parameter.VAR_KEYWORD
                               for p in params.values()))
            if takes_fl:
                self.init_hook(settings, file_list=settings.file_list,
                               **args)
            else:
                # hooks written against the repo's pre-file_list contract
                self.init_hook(settings, **args)
        return settings

    def __call__(self, settings, filename, *a, **kw):
        """Direct generator access (the undecorated call signature)."""
        return self.fn(settings, filename, *a, **kw)


def provider(input_types=None, init_hook=None, cache=CacheType.NO_CACHE,
             pool_size=-1, min_pool_size=-1, can_over_batch_size=True,
             calc_batch_size=None, check=False, check_fail_continue=False,
             should_shuffle=None, **kw):
    """The PyDataProvider2 decorator. Accepts the full reference keyword
    surface; returns a :class:`DataProvider`. Also usable bare
    (``@provider`` without parentheses)."""
    if callable(input_types) and init_hook is None:  # bare @provider
        return DataProvider(input_types)

    def wrap(fn):
        return DataProvider(fn, input_types=input_types,
                            init_hook=init_hook, cache=cache,
                            should_shuffle=should_shuffle, **kw)

    return wrap
