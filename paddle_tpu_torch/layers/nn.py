"""Core NN layers. Counterpart of ``paddle_tpu/layers/nn.py``, cut to
what the training slices build: ``fc``, ``embedding`` (dense),
``conv2d``, ``pool2d``, ``batch_norm``, the fused ``conv1x1_bn_act``,
``layer_norm``, ``rms_norm``, ``dropout`` and
``softmax_with_cross_entropy``."""
from __future__ import annotations

import math

from ..initializer import (ConstantInitializer, NormalInitializer,
                           XavierInitializer)
from .layer_helper import LayerHelper


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, name=None, main_program=None, startup_program=None):
    """Fully-connected layer: mul per input + sum + bias + activation.
    Multiple inputs each get their own weight; ``num_flatten_dims`` may be
    a list (one value per input) whose outputs share one rank."""
    helper = LayerHelper("fc", main_program=main_program,
                         startup_program=startup_program)
    inputs = input if isinstance(input, (list, tuple)) else [input]
    nfds = (list(num_flatten_dims)
            if isinstance(num_flatten_dims, (list, tuple))
            else [num_flatten_dims] * len(inputs))
    if len(nfds) != len(inputs):
        raise ValueError(
            f"fc: num_flatten_dims list has {len(nfds)} entries for "
            f"{len(inputs)} inputs")
    if len({nfd + 1 for nfd in nfds}) > 1:
        raise ValueError(
            "fc: per-input num_flatten_dims produce MIXED partial-sum "
            f"ranks {sorted(nfd + 1 for nfd in nfds)}; use values whose "
            "outputs share one rank, or reshape the lower-rank inputs first")
    mul_results = []
    for inp, nfd in zip(inputs, nfds):
        fan_in = math.prod(inp.shape[nfd:])
        w = helper.create_parameter(
            param_attr, shape=[fan_in, size], dtype=inp.dtype,
            default_initializer=XavierInitializer())
        mul_results.append(
            helper.simple_op("mul", {"X": [inp], "Y": [w]},
                             {"x_num_col_dims": nfd, "y_num_col_dims": 1}))
    if len(mul_results) == 1:
        pre_bias = mul_results[0]
    else:
        pre_bias = helper.simple_op("sum", {"X": mul_results})
    if bias_attr is False:
        pre_act = pre_bias
    else:
        pre_act = helper.append_bias_op(pre_bias, bias_attr, size,
                                        dim_start=nfds[0])
    return helper.append_activation(pre_act, act)


def embedding(input, size, is_sparse=False, padding_idx=None,
              param_attr=None, dtype="float32", main_program=None,
              startup_program=None):
    """Embedding lookup (lookup_table) with a dense gradient. Sparse
    (SelectedRows) gradients are a later slice of the port."""
    if is_sparse:
        raise NotImplementedError(
            "embedding(is_sparse=True) is not ported to paddle_tpu_torch "
            "yet: it lands with the sparse-grad (SelectedRows) slice")
    helper = LayerHelper("embedding", main_program=main_program,
                         startup_program=startup_program)
    w = helper.create_parameter(
        param_attr, shape=list(size), dtype=dtype,
        default_initializer=XavierInitializer())
    if padding_idx is not None and padding_idx < 0:
        # fluid semantics: negative padding_idx counts from the vocab end
        padding_idx = int(size[0]) + int(padding_idx)
    return helper.simple_op(
        "lookup_table", {"W": [w], "Ids": [input]},
        {"padding_idx": padding_idx, "is_sparse": bool(is_sparse)})


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=1, param_attr=None, bias_attr=None, act=None,
           data_format="NCHW", name=None, main_program=None,
           startup_program=None):
    """2-D convolution: OIHW filters for NCHW, HWIO for NHWC, initialised
    N(0, sqrt(2 / fan_in))."""
    helper = LayerHelper("conv2d", main_program=main_program,
                         startup_program=startup_program)
    if isinstance(filter_size, int):
        filter_size = [filter_size, filter_size]
    channel_axis = 1 if data_format == "NCHW" else 3
    num_channels = input.shape[channel_axis]
    if data_format == "NCHW":
        filter_shape = [num_filters, num_channels // groups] + list(filter_size)
    else:  # HWIO for NHWC
        filter_shape = list(filter_size) + [num_channels // groups, num_filters]
    fan_in = (num_channels // groups) * filter_size[0] * filter_size[1]
    std = (2.0 / fan_in) ** 0.5
    w = helper.create_parameter(
        param_attr, shape=filter_shape, dtype=input.dtype,
        default_initializer=NormalInitializer(0.0, std))
    pre_bias = helper.simple_op(
        "conv2d", {"Input": [input], "Filter": [w]},
        {"strides": stride, "paddings": padding, "dilations": dilation,
         "groups": groups, "data_format": data_format},
        out_slot="Output")
    pre_act = helper.append_bias_op(pre_bias, bias_attr,
                                    num_filters, dim_start=channel_axis)
    return helper.append_activation(pre_act, act)


def pool2d(input, pool_size=2, pool_type="max", pool_stride=1, pool_padding=0,
           global_pooling=False, ceil_mode=False, data_format="NCHW",
           main_program=None, startup_program=None):
    """``ceil_mode`` selects the legacy v1 output-size rule
    (ceil((I+2p-F)/S)+1); the default is floor."""
    helper = LayerHelper("pool2d", main_program=main_program,
                         startup_program=startup_program)
    return helper.simple_op(
        "pool2d", {"X": [input]},
        {"pooling_type": pool_type, "ksize": pool_size,
         "strides": pool_stride, "paddings": pool_padding,
         "global_pooling": global_pooling, "ceil_mode": bool(ceil_mode),
         "data_format": data_format})


def _bn_state(helper, channels, param_attr, bias_attr):
    """BN affine and running-stat setup shared by batch_norm and the fused
    conv1x1_bn_act: scale/bias parameters, the persistable ``.mean`` and
    ``.var`` state in both programs (init ops in startup, state in main),
    and the saved-stat tmp outputs. Returns (scale, bias, mean, variance,
    saved_mean, saved_var)."""
    dtype = "float32"
    scale = helper.create_parameter(
        param_attr, shape=[channels], dtype=dtype,
        default_initializer=ConstantInitializer(1.0))
    bias = helper.create_parameter(
        bias_attr, shape=[channels], dtype=dtype, is_bias=True)
    mean_name = scale.name + ".mean"
    var_name = scale.name + ".var"
    block = helper.main_program.global_block
    mean = block.create_var(name=mean_name, shape=[channels], dtype=dtype,
                            persistable=True, stop_gradient=True)
    variance = block.create_var(name=var_name, shape=[channels], dtype=dtype,
                                persistable=True, stop_gradient=True)
    sb = helper.startup_program.global_block
    for name, value in ((mean_name, 0.0), (var_name, 1.0)):
        v = sb.create_var(name=name, shape=[channels], dtype=dtype,
                          persistable=True)
        ConstantInitializer(value)(v, sb)
    saved_mean = helper.create_tmp_variable(dtype, shape=[channels],
                                            stop_gradient=True)
    saved_var = helper.create_tmp_variable(dtype, shape=[channels],
                                           stop_gradient=True)
    return scale, bias, mean, variance, saved_mean, saved_var


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, data_layout="NCHW",
               main_program=None, startup_program=None):
    """Batch normalisation. Mean/Variance are persistable running stats;
    MeanOut/VarianceOut carry their names, so the executor's write-back
    updates them in place."""
    helper = LayerHelper("batch_norm", main_program=main_program,
                         startup_program=startup_program)
    channels = input.shape[1] if data_layout == "NCHW" else input.shape[-1]
    scale, bias, mean, variance, saved_mean, saved_var = _bn_state(
        helper, channels, param_attr, bias_attr)
    y = helper.create_tmp_variable(input.dtype, shape=input.shape)
    helper.append_op(
        "batch_norm",
        {"X": [input], "Scale": [scale], "Bias": [bias],
         "Mean": [mean], "Variance": [variance]},
        {"Y": [y], "MeanOut": [mean], "VarianceOut": [variance],
         "SavedMean": [saved_mean], "SavedVariance": [saved_var]},
        {"momentum": momentum, "epsilon": epsilon, "is_test": is_test,
         "data_layout": data_layout},
    )
    return helper.append_activation(y, act)


def conv1x1_bn_act(input, num_filters, residual=None, act=None,
                   is_test=False, momentum=0.9, epsilon=1e-5,
                   param_attr=None, bn_param_attr=None, bn_bias_attr=None,
                   main_program=None, startup_program=None):
    """Fused NHWC 1x1-conv + batch_norm + activation (+ residual add) as
    one op (``ops/fusion_ops.py``): the epilogue-fusion form of the
    conv2d -> batch_norm -> elementwise_add -> relu chain, built by models
    under ``--fused_conv_epilogue``. Parameters are created in the JAX
    layer's order: filter, then scale and bias."""
    if act not in (None, "", "relu"):
        raise ValueError(
            f"conv1x1_bn_act supports act None or 'relu' (the fused "
            f"kernels implement exactly these), got {act!r}")
    helper = LayerHelper("conv1x1_bn_act", main_program=main_program,
                         startup_program=startup_program)
    channels_in = int(input.shape[-1])
    filt = helper.create_parameter(
        param_attr, shape=[1, 1, channels_in, num_filters],
        dtype=input.dtype,
        default_initializer=NormalInitializer(  # conv2d's init
            0.0, (2.0 / channels_in) ** 0.5))
    scale, bias, mean, variance, saved_mean, saved_var = _bn_state(
        helper, num_filters, bn_param_attr, bn_bias_attr)
    out_shape = list(input.shape[:-1]) + [num_filters]
    y = helper.create_tmp_variable(input.dtype, shape=out_shape)
    conv_out = helper.create_tmp_variable(
        input.dtype, shape=[1, 1] if is_test else out_shape,
        stop_gradient=True)
    ins = {"X": [input], "Filter": [filt], "Scale": [scale],
           "Bias": [bias], "Mean": [mean], "Variance": [variance]}
    if residual is not None:
        ins["Residual"] = [residual]
    helper.append_op(
        "conv1x1_bn_act", ins,
        {"Y": [y], "MeanOut": [mean], "VarianceOut": [variance],
         "SavedMean": [saved_mean], "SavedVariance": [saved_var],
         "ConvOut": [conv_out]},
        {"momentum": momentum, "epsilon": epsilon, "is_test": is_test,
         "act": act or ""})
    return y


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
               main_program=None, startup_program=None):
    helper = LayerHelper("layer_norm", main_program=main_program,
                         startup_program=startup_program)
    norm_shape = [math.prod(input.shape[begin_norm_axis:])]
    inputs = {"X": [input]}
    if scale:
        s = helper.create_parameter(
            param_attr, shape=norm_shape, dtype="float32",
            default_initializer=ConstantInitializer(1.0))
        inputs["Scale"] = [s]
    if shift:
        b = helper.create_parameter(bias_attr, shape=norm_shape,
                                    dtype="float32", is_bias=True)
        inputs["Bias"] = [b]
    outs, _ = helper.append_op("layer_norm", inputs,
                               ["Y", "Mean", "Variance"],
                               {"epsilon": epsilon,
                                "begin_norm_axis": begin_norm_axis})
    return helper.append_activation(outs["Y"][0], act)


def rms_norm(input, scale=True, shift=False, begin_norm_axis=1,
             epsilon=1e-6, param_attr=None, bias_attr=None, act=None,
             main_program=None, startup_program=None):
    """RMSNorm: a learned scale and no shift by default (the modern LM
    convention)."""
    helper = LayerHelper("rms_norm", main_program=main_program,
                         startup_program=startup_program)
    norm_shape = [math.prod(input.shape[begin_norm_axis:])]
    inputs = {"X": [input]}
    if scale:
        s = helper.create_parameter(
            param_attr, shape=norm_shape, dtype="float32",
            default_initializer=ConstantInitializer(1.0))
        inputs["Scale"] = [s]
    if shift:
        b = helper.create_parameter(bias_attr, shape=norm_shape,
                                    dtype="float32", is_bias=True)
        inputs["Bias"] = [b]
    outs, _ = helper.append_op("rms_norm", inputs, ["Y", "InvRms"],
                               {"epsilon": epsilon,
                                "begin_norm_axis": begin_norm_axis})
    return helper.append_activation(outs["Y"][0], act)


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               label_smoothing=0.0, main_program=None,
                               startup_program=None):
    """``label_smoothing`` (hard labels only): train against the target
    (1-eps)*onehot + eps/V."""
    helper = LayerHelper("softmax_with_cross_entropy",
                         main_program=main_program,
                         startup_program=startup_program)
    if soft_label and label_smoothing:
        raise ValueError("label_smoothing applies to hard labels only")
    if not 0.0 <= float(label_smoothing) < 1.0:
        raise ValueError(
            f"label_smoothing must be in [0, 1), got {label_smoothing}")
    outs, _ = helper.append_op(
        "softmax_with_cross_entropy", {"Logits": [logits], "Label": [label]},
        ["Softmax", "Loss"], {"soft_label": soft_label,
                              "label_smoothing": float(label_smoothing)})
    return outs["Loss"][0]


def dropout(x, dropout_prob=0.5, is_test=False, main_program=None,
            startup_program=None):
    helper = LayerHelper("dropout", main_program=main_program,
                         startup_program=startup_program)
    outs, _ = helper.append_op("dropout", {"X": [x]}, ["Out", "Mask"],
                               {"dropout_prob": dropout_prob,
                                "is_test": is_test})
    return outs["Out"][0]
