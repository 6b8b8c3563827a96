"""The control-flow plane (StaticRNN, While, DynamicRNN, the tensor
arrays, cond) against the JAX package's.

Each builder runs with ``pt`` set to each package in turn and the name
counters synced: the forward programs must be equal as
``program_to_dict`` writes them (the serialized bodies included, without
the JAX package's ``_callsite`` attrs), the port's startup draws the JAX
startup's values bit for bit, and the fetched outputs and gradients
agree within ``ULPS`` f32 ulps of each tensor's largest |value|
(measured at most 5, a while's weight gradient: XLA fuses the body's
products and gate arithmetic inside its scan, the port runs them op by
op). Control flow that only moves or counts values (the arrays, the loop
counters, the trip-bound inference, ``cond``'s branch choice) agrees
exactly. Training is held to JAX over its first 5 steps. The cases are
those of ``tests/test_control_flow.py``, each run in both packages.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as tpt
from paddle_tpu.core import program as jprog
from paddle_tpu_torch.core import program as tprog
from test_torch_activation_ops import _ulps
from test_torch_step_units import op_parity
from test_torch_transpiler import program_dict

torch.set_num_threads(1)
ULPS = 8
PKGS = ((jpt, jprog), (tpt, tprog))


def _strip_callsites(d):
    """The JAX package's ``_callsite`` attrs in serialized bodies too."""
    if isinstance(d, dict):
        d.pop("_callsite", None)
        for v in d.values():
            _strip_callsites(v)
    elif isinstance(d, list):
        for v in d:
            _strip_callsites(v)
    return d


def twin(builder, feed, fetch, backward=None, check_programs=True):
    """Build ``builder(pt) -> {key: Variable}`` in both packages (their
    forward programs equal), run its startup and then its main program
    once on ``feed``; ``fetch`` lists the keys and grad names to fetch,
    ``backward`` the key of a loss to append the backward of. Returns
    (JAX values, port values)."""
    start = jprog.Program._uid_counter
    results, dicts, scopes = [], [], []
    for pt, counter in PKGS:
        counter.Program._uid_counter = start
        main, startup = pt.Program(), pt.Program()
        startup.random_seed = main.random_seed = 5
        with pt.program_guard(main, startup):
            vs = builder(pt)
            # the forward's: the backward's names differ by the port's
            # one extra name a grad op (its _vjp_key)
            dicts.append([_strip_callsites(program_dict(pt, p))
                          for p in (main, startup)])
            if backward is not None:
                pt.append_backward(vs[backward])
        scope = pt.Scope()
        exe = pt.Executor(pt.CPUPlace())
        exe.run(startup, scope=scope)
        scopes.append({n: np.asarray(scope.get_numpy(n) if pt is tpt
                                     else scope.get(n))
                       for n in scope.keys() if n != counter.RNG_VAR})
        names = [vs[k].name if k in vs else k for k in fetch]
        outs = exe.run(main, feed=feed, fetch_list=names, scope=scope)
        results.append([np.asarray(o, np.float64) for o in outs])
    if check_programs:
        assert dicts[1] == dicts[0]
    assert sorted(scopes[1]) == sorted(scopes[0])
    for n, want in scopes[0].items():
        np.testing.assert_array_equal(scopes[1][n], want, err_msg=n)
    return results


def assert_pairs_close(jvals, tvals, ulps=ULPS):
    for i, (want, got) in enumerate(zip(jvals, tvals)):
        assert got.shape == want.shape, i
        gap = _ulps(got, want, "float32", at_max=True)
        assert gap <= ulps, (i, gap)


# --- StaticRNN ------------------------------------------------------------
def _recurrence(lod):
    """h_t = tanh([x_t, h_{t-1}] W), its outputs and last step, a loss."""
    def build(pt):
        L = pt.layers
        if lod:
            x = L.data("x", shape=[4], lod_level=1)
        else:
            x = L.data("x", shape=[5, 4])
        h0 = L.data("h0", shape=[6])
        rnn = L.StaticRNN()
        with rnn.step():
            xt = rnn.step_input(x)
            mem = rnn.memory(init=h0)
            nh = L.fc([xt, mem], size=6, act="tanh",
                      bias_attr=pt.ParamAttr(name="rnn_b"))
            rnn.update_memory(mem, nh)
            rnn.step_output(nh)
        out = rnn()
        last = L.sequence_last_step(out)
        return {"out": out, "last": last, "loss": L.mean(last)}
    return build


@pytest.mark.parametrize("lod", [False, True])
def test_static_rnn_forward_and_gradient(lod):
    rng = np.random.RandomState(0)
    feed = {"x": rng.randn(3, 5, 4).astype(np.float32) * 0.5,
            "h0": rng.randn(3, 6).astype(np.float32) * 0.2}
    if lod:
        feed["x@len"] = np.array([5, 2, 3], np.int32)
    fetch = ["out", "last", "rnn_b@GRAD"]
    jv, tv = twin(_recurrence(lod), feed, fetch, backward="loss")
    assert_pairs_close(jv, tv)
    if lod:  # finished rows emit zeros past their length
        assert not tv[0][1, 2:].any() and tv[0][1, 1].any()


def test_static_rnn_weight_gradients_per_input():
    """fc over [x_t, h] makes one weight per input; both gradients."""
    rng = np.random.RandomState(1)
    feed = {"x": rng.randn(2, 5, 4).astype(np.float32),
            "h0": rng.randn(2, 6).astype(np.float32)}
    start = jprog.Program._uid_counter
    grads = []
    for pt, counter in PKGS:
        counter.Program._uid_counter = start
        main, startup = pt.Program(), pt.Program()
        startup.random_seed = 5
        with pt.program_guard(main, startup):
            loss = _recurrence(False)(pt)["loss"]
            pg = pt.append_backward(loss)
        scope = pt.Scope()
        exe = pt.Executor(pt.CPUPlace())
        exe.run(startup, scope=scope)
        names = sorted(g.name for _, g in pg)
        grads.append((names, [np.asarray(o, np.float64) for o in exe.run(
            main, feed=feed, fetch_list=names, scope=scope)]))
    assert grads[1][0] == grads[0][0] and len(grads[0][0]) == 3
    assert_pairs_close(grads[0][1], grads[1][1])


def _accumulator(pt):
    L = pt.layers
    x = L.data("x", shape=[6, 3])
    y = L.data("y", shape=[1])
    acc0 = L.fill_constant_batch_size_like(y, shape=[-1, 1],
                                           dtype="float32", value=0.0)
    rnn = L.StaticRNN()
    with rnn.step():
        xt = rnn.step_input(x)
        acc = rnn.memory(init=acc0)
        new_acc = L.elementwise_add(acc, L.fc(xt, size=1, bias_attr=False))
        rnn.update_memory(acc, new_acc)
        rnn.step_output(new_acc)
    pred = L.sequence_last_step(rnn())
    loss = L.mean(L.square_error_cost(pred, y))
    pt.optimizer.SGDOptimizer(learning_rate=0.1).minimize(loss)
    return {"loss": loss}


def test_static_rnn_trains_as_jax_does():
    """5 SGD steps of a linear recurrence, loss by loss."""
    rng = np.random.RandomState(0)
    w_true = np.array([[0.5], [-1.0], [2.0]], np.float32)
    batches = []
    for _ in range(5):
        xb = rng.randn(8, 6, 3).astype(np.float32)
        batches.append({"x": xb, "y": (xb @ w_true).sum(1)})
    start = jprog.Program._uid_counter
    losses = []
    for pt, counter in PKGS:
        counter.Program._uid_counter = start
        main, startup = pt.Program(), pt.Program()
        startup.random_seed = 5
        with pt.program_guard(main, startup):
            loss = _accumulator(pt)["loss"]
        scope = pt.Scope()
        exe = pt.Executor(pt.CPUPlace())
        exe.run(startup, scope=scope)
        losses.append([float(exe.run(main, feed=b, fetch_list=[loss],
                                     scope=scope)[0]) for b in batches])
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-6)
    assert losses[1][-1] < losses[1][0]


def test_dynamic_rnn_masks_variable_lengths():
    def build(pt):
        L = pt.layers
        seq = L.data("seq", shape=[3], lod_level=1)
        drnn = L.DynamicRNN()
        with drnn.block():
            x_t = drnn.step_input(seq)
            mem = drnn.memory(shape=[3])
            acc = L.sums([x_t, mem])
            drnn.update_memory(mem, acc)
            drnn.output(acc)
        return {"out": drnn()}

    rng = np.random.RandomState(0)
    xv = rng.rand(2, 4, 3).astype(np.float32)
    feed = {"seq": xv, "seq@len": np.array([4, 2], np.int32)}
    (jo,), (to,) = twin(build, feed, ["out"])
    assert_pairs_close([jo], [to])
    np.testing.assert_allclose(to[0, -1], xv[0].sum(0), rtol=1e-6)
    assert not to[1, 2:].any()


# --- While --------------------------------------------------------------
def _sum_of_squares(pt):
    L = pt.layers
    i = L.fill_constant(shape=[], value=0.0, dtype="float32")
    n = L.fill_constant(shape=[], value=5.0, dtype="float32")
    acc = L.fill_constant(shape=[], value=0.0, dtype="float32")
    cond = L.less_than(i, n)
    w = L.While(cond)
    with w.block():
        sq = L.elementwise_mul(i, i)
        L.assign(L.elementwise_add(acc, sq), output=acc)
        L.assign(L.increment(i, 1.0), output=i)
        L.assign(L.less_than(i, n), output=cond)
    return {"acc": acc, "i": i, "cond": cond}


def test_while_sum_of_squares_both_forms():
    """Inferred bound (5 trips, the masked loop) and the dynamic form."""
    jv, tv = twin(_sum_of_squares, {}, ["acc", "i", "cond"])
    assert [float(v) for v in tv] == [float(v) for v in jv] == [30.0, 5.0,
                                                                0.0]

    def dynamic(pt):
        pt.layers.While.__init__.__defaults__  # the same builder, forced
        vs = _sum_of_squares(pt)
        op = [o for o in pt.default_main_program().global_block.ops
              if o.type == "while"][0]
        assert op.attrs["max_iters"] == 5
        op.attrs["max_iters"] = None
        return vs

    jv, tv = twin(dynamic, {}, ["acc", "i"])
    assert [float(v) for v in tv] == [float(v) for v in jv] == [30.0, 5.0]


def test_array_write_read_in_while():
    def build(pt):
        L = pt.layers
        i = L.fill_constant(shape=[], value=0.0, dtype="float32")
        n = L.fill_constant(shape=[], value=4.0, dtype="float32")
        arr = L.create_array([], max_len=4)
        total = L.fill_constant(shape=[], value=0.0, dtype="float32")
        cond = L.less_than(i, n)
        w = L.While(cond, max_iters=0)  # the dynamic form
        with w.block():
            sq = L.elementwise_mul(i, i)
            L.assign(L.array_write(sq, i, arr), output=arr)
            L.assign(L.elementwise_add(total, L.array_read(arr, i)),
                     output=total)
            L.assign(L.increment(i, 1.0), output=i)
            L.assign(L.less_than(i, n), output=cond)
        return {"arr": arr, "total": total, "len": L.array_length(arr)}

    jv, tv = twin(build, {}, ["arr", "total", "len"])
    for want, got in zip(jv, tv):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tv[0], [0.0, 1.0, 4.0, 9.0])
    assert float(tv[1]) == 14.0 and int(tv[2][0]) == 4


@pytest.mark.parametrize("index", [-6, -1, 0, 2, 4, 9])
def test_array_ops_clamp_out_of_range_indices(index):
    """Out-of-range indices take ``lax.dynamic_*_index_in_dim``'s rule:
    a negative index counts from the end, then clamps into the array."""
    rng = np.random.RandomState(index + 10)
    arr = rng.randn(4, 3).astype(np.float32)
    x = rng.randn(3).astype(np.float32)
    i = np.array(index, np.int64)
    outs, grads = op_parity("array_write", {"X": [x], "I": [i],
                                            "Array": [arr]}, {},
                            [("X", 0), ("Array", 0)])
    for want, got in list(outs.values()) + list(grads.values()):
        np.testing.assert_array_equal(got, want)
    outs, grads = op_parity("array_read", {"Array": [arr], "I": [i]}, {},
                            [("Array", 0)])
    for want, got in list(outs.values()) + list(grads.values()):
        np.testing.assert_array_equal(got, want)


def _deep_tanh(n_val, w0=0.8):
    """loss = mean of tanh-scale applied n times (the while's bound 6)."""
    def build(pt):
        L = pt.layers
        x = L.data("x", shape=[4])
        n = L.data("n", shape=[], dtype="float32", append_batch_size=False)
        state = L.fc(x, size=4, bias_attr=False, param_attr=pt.ParamAttr(
            name="while_w",
            initializer=pt.initializer.ConstantInitializer(w0)))
        i = L.fill_constant(shape=[], value=0.0, dtype="float32")
        cond = L.less_than(i, n)
        w = L.While(cond, max_iters=6)
        with w.block():
            L.assign(L.scale(L.tanh(state), 0.9), output=state)
            L.assign(L.increment(i, 1.0), output=i)
            L.assign(L.less_than(i, n), output=cond)
        return {"loss": L.mean(state)}
    return build


@pytest.mark.parametrize("n_val", [0.0, 2.0, 4.0, 6.0])
def test_while_gradient_matches_jax(n_val):
    rng = np.random.RandomState(0)
    feed = {"x": rng.rand(3, 4).astype(np.float32), "n": np.float32(n_val)}
    jv, tv = twin(_deep_tanh(n_val), feed, ["loss", "while_w@GRAD"],
                  backward="loss")
    assert_pairs_close(jv, tv)


def test_dynamic_depth_while_trains_as_jax_does():
    rng = np.random.RandomState(0)
    x_np = rng.rand(8, 4).astype(np.float32)
    start = jprog.Program._uid_counter
    losses = []
    for pt, counter in PKGS:
        counter.Program._uid_counter = start
        main, startup = pt.Program(), pt.Program()
        with pt.program_guard(main, startup):
            loss = _deep_tanh(3.0)(pt)["loss"]
            pt.optimizer.SGDOptimizer(learning_rate=0.5).minimize(loss)
        scope = pt.Scope()
        exe = pt.Executor(pt.CPUPlace())
        exe.run(startup, scope=scope)
        losses.append([float(exe.run(
            main, feed={"x": x_np, "n": np.float32(d)}, fetch_list=[loss],
            scope=scope)[0]) for d in (1.0, 3.0, 2.0, 3.0, 1.0)])
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-6)


def test_grad_of_op_whose_input_is_later_overwritten():
    """A grad op reads its primal input before the while's write-back
    overwrites the name."""
    def build(pt):
        L = pt.layers
        x = L.data("x", shape=[4])
        h = L.fc(x, size=4, bias_attr=False, param_attr=pt.ParamAttr(
            name="clobber_w",
            initializer=pt.initializer.ConstantInitializer(0.6)))
        t = L.tanh(h)
        i = L.fill_constant(shape=[], value=0.0, dtype="float32")
        n = L.fill_constant(shape=[], value=2.0, dtype="float32")
        cond = L.less_than(i, n)
        w = L.While(cond, max_iters=3)
        with w.block():
            L.assign(L.scale(L.sigmoid(h), 0.9), output=h)
            L.assign(L.increment(i, 1.0), output=i)
            L.assign(L.less_than(i, n), output=cond)
        return {"loss": L.mean(L.elementwise_add(h, t))}

    feed = {"x": np.random.RandomState(3).rand(3, 4).astype(np.float32)}
    jv, tv = twin(build, feed, ["loss", "clobber_w@GRAD"], backward="loss")
    assert_pairs_close(jv, tv)


# --- the trip-bound inference (test_control_flow.py:409-552) ----------------
def _decoder(max_len=5, pass_bound=None):
    """Decode-train: per-step outputs written to an array, a loss over
    the array, no max_iters given."""
    def build(pt):
        L = pt.layers
        x = L.data("x", shape=[4])
        state = L.fc(x, size=4, bias_attr=False, param_attr=pt.ParamAttr(
            name="dec_w",
            initializer=pt.initializer.ConstantInitializer(0.5)))
        buf = L.create_array([], max_len)
        i = L.fill_constant(shape=[], value=0.0, dtype="float32")
        n = L.fill_constant(shape=[], value=float(max_len), dtype="float32")
        cond = L.less_than(i, n)
        kw = {} if pass_bound is None else {"max_iters": pass_bound}
        w = L.While(cond, **kw)
        with w.block():
            nxt = L.scale(L.tanh(state), 0.9)
            L.assign(nxt, output=state)
            ii = L.cast(i, "int64")
            L.assign(L.array_write(L.mean(nxt), ii, buf), output=buf)
            L.assign(L.increment(i, 1.0), output=i)
            L.assign(L.less_than(i, n), output=cond)
        return {"loss": L.mean(buf), "buf": buf}
    return build


def _max_iters(pt, builder):
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        builder(pt)
    ops = [op for op in main.global_block.ops if op.type == "while"]
    assert len(ops) == 1
    return ops[0].attrs["max_iters"]


def test_decoder_bound_inferred_and_gradient_matches_jax():
    feed = {"x": np.random.RandomState(1).rand(3, 4).astype(np.float32)}
    assert _max_iters(tpt, _decoder()) == 5
    jv, tv = twin(_decoder(), feed, ["loss", "buf", "dec_w@GRAD"],
                  backward="loss")
    assert_pairs_close(jv, tv)


def test_decoder_forced_dynamic_runs_as_jax_does():
    assert _max_iters(tpt, _decoder(pass_bound=0)) is None
    feed = {"x": np.random.RandomState(2).rand(2, 4).astype(np.float32)}
    jv, tv = twin(_decoder(pass_bound=0), feed, ["loss", "buf"])
    assert_pairs_close(jv, tv)


def _runtime_limit(pt):
    L = pt.layers
    n = L.data("n", shape=[], dtype="float32", append_batch_size=False)
    buf = L.create_array([2], 7)
    i = L.fill_constant(shape=[], value=0.0, dtype="float32")
    cond = L.less_than(i, n)
    w = L.While(cond)
    with w.block():
        val = L.fill_constant(shape=[2], value=1.0, dtype="float32")
        ii = L.cast(i, "int64")
        L.assign(L.array_write(val, ii, buf), output=buf)
        L.assign(L.increment(i, 1.0), output=i)
        L.assign(L.less_than(i, n), output=cond)
    return {"buf": buf, "i": i}


def _non_counter(pt):
    L = pt.layers
    err = L.fill_constant(shape=[], value=9.0, dtype="float32")
    lim = L.fill_constant(shape=[], value=2.0, dtype="float32")
    cond = L.less_than(err, lim)
    w = L.While(cond)
    with w.block():
        L.assign(L.scale(err, 0.5), output=err)
        L.assign(L.less_than(err, lim), output=cond)
    return {"err": err}


def _counter(limit, step):
    def build(pt):
        L = pt.layers
        i = L.fill_constant(shape=[], value=0.0, dtype="float32")
        n = L.fill_constant(shape=[], value=limit, dtype="float32")
        cond = L.less_than(i, n)
        w = L.While(cond)
        with w.block():
            L.assign(L.increment(i, step), output=i)
            L.assign(L.less_than(i, n), output=cond)
        return {"i": i}
    return build


@pytest.mark.parametrize("case,want", [
    ("runtime_limit", None), ("non_counter", None), ("sentinel", None),
    ("fractional_step", None), ("counter", 3)])
def test_trip_bound_inference_matches_jax(case, want):
    builder = {"runtime_limit": _runtime_limit, "non_counter": _non_counter,
               "sentinel": _counter(1e9, 1.0),
               "fractional_step": _counter(3.0, 0.5),
               "counter": _counter(3.0, 1.0)}[case]
    assert _max_iters(tpt, builder) == want
    assert _max_iters(jpt, builder) == want


def test_runtime_limit_runs_past_the_array_as_jax_does():
    """A fed limit past the array's extent: writes clamp to the last
    slot, and the loop runs its 9 trips."""
    jv, tv = twin(_runtime_limit, {"n": np.float32(9.0)}, ["buf", "i"])
    for want, got in zip(jv, tv):
        np.testing.assert_array_equal(got, want)
    assert float(tv[1]) == 9.0


# --- cond ------------------------------------------------------------------
COND_ATTRS = {
    "true_ops": [
        {"type": "scale", "inputs": {"X": ["x"]}, "outputs": {"Out": ["y"]},
         "attrs": {"scale": 2.0}},
        {"type": "tanh", "inputs": {"X": ["y"]}, "outputs": {"Out": ["z"]},
         "attrs": {}}],
    "false_ops": [
        {"type": "elementwise_mul", "inputs": {"X": ["x"], "Y": ["w"]},
         "outputs": {"Out": ["y"]}, "attrs": {}},
        {"type": "sigmoid", "inputs": {"X": ["y"]},
         "outputs": {"Out": ["z"]}, "attrs": {}}],
    "param_names": ["x", "w"],
    "out_names": ["y", "z"],
}


@pytest.mark.parametrize("pred", [True, False])
def test_cond_takes_one_branch_as_jax_does(pred):
    rng = np.random.RandomState(int(pred))
    ins = {"Cond": [np.array(pred)],
           "Param": [rng.randn(5).astype(np.float32),
                     rng.randn(5).astype(np.float32)]}
    outs, grads = op_parity("cond", ins, COND_ATTRS,
                            [("Param", 0), ("Param", 1)])
    assert_pairs_close(*zip(*outs.values()))
    assert_pairs_close(*zip(*grads.values()))
    if pred:  # the untaken branch's read gets a zero gradient
        assert not grads[("Param", 1)][1].any()


def test_body_refuses_random_ops():
    from paddle_tpu_torch.ops.control_flow_ops import run_body

    with pytest.raises(NotImplementedError, match="control-flow body"):
        run_body([{"type": "dropout", "inputs": {"X": ["x"]},
                   "outputs": {"Out": ["y"]}, "attrs": {}}],
                 {"x": torch.ones(2)})


def test_beam_search_decode_raises_as_jax_does():
    """The array-to-sequence conversion of a While-loop beam is served
    by the fused decoders in both packages; the message is JAX's."""
    messages = []
    for pt in (jpt, tpt):
        with pytest.raises(NotImplementedError) as err:
            pt.layers.beam_search_decode(None, None)
        messages.append(str(err.value))
    assert messages[1] == messages[0]
    assert "beam_search_decoder" in messages[1]
