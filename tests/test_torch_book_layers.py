"""The book plane's layer functions build the JAX package's programs.

``sequence_conv``, ``linear_chain_crf``, ``crf_decoding`` (with a
transition variable, with a ``param_attr`` naming a shared one, and with
``label``), ``chunk_eval`` and ``beam_search_decoder`` (GRU and LSTM) are
each called by one function with ``pt`` set to each package in turn and
the name counters synced: the main, startup and ``for_test`` programs
must be equal as ``program_to_dict`` writes them (the same op types,
attrs, variable names and inferred shapes; int64 read as int32, as JAX
without x64 carries it). Each layer has the reference's signature and
defaults, and the registry holds the six ops of the slice. The
evaluators' programs match too, but for the one ``cast`` a
``ChunkEvaluator`` adds to bring ``chunk_eval``'s int64 counts to its
int32 states (JAX's counts are int32 already).
"""
import inspect

import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as tpt
from test_torch_layers_ops import program_dicts

torch.set_num_threads(1)
LAYERS = ("sequence_conv", "linear_chain_crf", "crf_decoding", "chunk_eval",
          "beam_search_decoder")
OPS = ("sequence_conv", "context_project", "linear_chain_crf",
       "crf_decoding", "chunk_eval", "beam_search_decoder")


def _seq(L, name, dtype="float32", shape=(6,)):
    return L.data(name, shape=list(shape), dtype=dtype, lod_level=1)


def _emission(L):
    return L.fc(_seq(L, "x"), size=5, num_flatten_dims=2)


def _crf(pt):
    L = pt.layers
    em = _emission(L)
    tags = _seq(L, "tags", "int64", (1,))
    cost = L.linear_chain_crf(em, tags)
    L.mean(cost)
    return L, em, tags, cost


def _beam(cell):
    def build(pt):
        L = pt.layers
        G = 3 if cell == "gru" else 4
        h0 = L.data("h0", shape=[8])
        gb = pt.default_main_program().global_block
        declare = lambda name, shape: gb.create_var(  # noqa: E731
            name=name, shape=shape, dtype="float32", persistable=True)
        L.beam_search_decoder(
            h0, declare("emb", [12, 4]),
            (declare("wx", [4, G * 8]), declare("wh", [8, G * 8]),
             declare("b", [G * 8]) if cell == "gru" else None),
            (declare("wout", [8, 12]), declare("bout", [12])),
            beam_size=3, max_len=5, cell=cell,
            init_cell=L.data("c0", shape=[8]) if cell == "lstm" else None)
    return build


BUILDERS = {
    "sequence_conv": lambda pt: pt.layers.sequence_conv(
        _seq(pt.layers, "x"), num_filters=4, filter_size=3, act="tanh"),
    "sequence_conv_5_no_bias": lambda pt: pt.layers.sequence_conv(
        _seq(pt.layers, "x"), num_filters=4, filter_size=5,
        bias_attr=False),
    "linear_chain_crf": _crf,
    "crf_decoding_transition": lambda pt: (lambda L, em, tags, cost:
                                           L.crf_decoding(
                                               em,
                                               transition=cost.transition))(
        *_crf(pt)),
    "crf_decoding_param_attr_label": lambda pt: pt.layers.crf_decoding(
        _emission(pt.layers), param_attr=pt.ParamAttr(name="crfw"),
        label=_seq(pt.layers, "tags", "int64", (1,))),
    "chunk_eval": lambda pt: pt.layers.chunk_eval(
        _seq(pt.layers, "pred", "int64", (1,)),
        _seq(pt.layers, "lab", "int64", (1,)), num_chunk_types=4),
    "beam_search_decoder_gru": _beam("gru"),
    "beam_search_decoder_lstm": _beam("lstm"),
}


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_layer_builds_the_jax_program(name):
    jd, td = program_dicts(BUILDERS[name])
    assert td == jd
    assert td[0]["blocks"][0]["ops"], name


def test_signatures_and_registry():
    for name in LAYERS:
        assert name in tpt.layers.__all__, name
        want = inspect.signature(getattr(jpt.layers, name))
        assert inspect.signature(getattr(tpt.layers, name)) == want, name
    from paddle_tpu.core.registry import _REGISTRY as JAX_REGISTRY
    from paddle_tpu_torch.core.registry import _REGISTRY

    assert not set(OPS) - set(_REGISTRY)
    assert not set(_REGISTRY) - set(JAX_REGISTRY)
    assert len(_REGISTRY) == 180  # with the optimizer plane's eight,
    # the decode plane's six, the sparse plane's ten and the control-flow
    # plane's eight
    for cls in ("Evaluator", "Accuracy", "ChunkEvaluator"):
        for method in ("__init__", "reset", "eval"):
            want = inspect.signature(getattr(getattr(jpt.evaluator, cls),
                                             method))
            got = inspect.signature(getattr(getattr(tpt.evaluator, cls),
                                            method))
            assert got == want, (cls, method)


@pytest.mark.parametrize("kind", ["accuracy", "chunk"])
def test_evaluator_programs(kind):
    def build(pt):
        L = pt.layers
        if kind == "accuracy":
            pt.evaluator.Accuracy(L.data("s", shape=[5]),
                                  L.data("y", shape=[1], dtype="int64"), k=2)
        else:
            pt.evaluator.ChunkEvaluator(
                _seq(L, "pred", "int64", (1,)), _seq(L, "lab", "int64", (1,)),
                num_chunk_types=4)

    jd, td = program_dicts(build)
    if kind == "chunk":  # fold the port's three casts to the int32 states
        for prog in (td[0], td[2]):  # main and its for_test clone
            block = prog["blocks"][0]
            casts = [op for op in block["ops"] if op["type"] == "cast"]
            assert [op["attrs"]["dtype"] for op in casts] == ["int32"] * 3
            src = {op["outputs"]["Out"][0]: op["inputs"]["X"][0]
                   for op in casts}
            block["ops"] = [op for op in block["ops"] if op["type"] != "cast"]
            for op in block["ops"]:
                op["inputs"] = {k: [src.get(n, n) for n in v]
                                for k, v in op["inputs"].items()}
            block["vars"] = [v for v in block["vars"]
                             if v["name"] not in src]
    assert td == jd
