"""Control-flow layers. Counterpart of ``paddle_tpu/layers/control_flow.py``,
cut to ``increment`` (gradient accumulation's step counter) and the fused
``beam_search_decoder``."""
from __future__ import annotations

from .layer_helper import LayerHelper


def increment(x, value=1.0, main_program=None, startup_program=None):
    """x + value, as a new variable."""
    helper = LayerHelper("increment", main_program=main_program,
                         startup_program=startup_program)
    return helper.simple_op("increment", {"X": [x]}, {"step": value})


def beam_search_decoder(init_state, embedding_param, cell_params, out_params,
                        beam_size=4, max_len=32, bos_id=0, eos_id=1,
                        cell="gru", init_cell=None, main_program=None,
                        startup_program=None):
    """Fused beam-search generation (``ops/control_flow_ops.py``
    beam_search_decoder). cell_params = (weight_x, weight_h,
    bias_or_None); out_params = (weight_out, bias_or_None). Returns (ids
    [b, beam, max_len], scores [b, beam], lengths [b, beam])."""
    helper = LayerHelper("beam_search_decoder", main_program=main_program,
                         startup_program=startup_program)
    wx, wh, bias = cell_params
    w_out, b_out = out_params
    ins = {"InitState": [init_state], "Embedding": [embedding_param],
           "WeightX": [wx], "WeightH": [wh], "WeightOut": [w_out]}
    if bias is not None:
        ins["Bias"] = [bias]
    if b_out is not None:
        ins["OutBias"] = [b_out]
    if init_cell is not None:
        ins["InitCell"] = [init_cell]
    outs, _ = helper.append_op(
        "beam_search_decoder", ins, ["Ids", "SeqScores", "SeqLen"],
        {"beam_size": beam_size, "max_len": max_len, "bos_id": bos_id,
         "eos_id": eos_id, "cell": cell})
    return outs["Ids"][0], outs["SeqScores"][0], outs["SeqLen"][0]
