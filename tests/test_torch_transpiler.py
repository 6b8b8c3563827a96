"""The port's transpiler against the JAX package's.

Small programs are built in both packages with the same names (the
port's name counter started where JAX's was), each package runs its own
startup (the port's values equal JAX's bit for bit), and each pass of the inference pipeline,
and the pipeline itself with and without ``--fused_conv_epilogue``, runs
in both. The transpiled programs give equal ``program_to_dict`` output
(the JAX ops' ``_callsite`` attrs and the port backward's ``_vjp_key``
dropped, int64 vars read as the int32 the JAX package holds them as
without x64), and every value a pass writes
into the scope (folded weights and biases, folded constants) is bitwise
equal. The transpiled programs' fetches equal the untranspiled
``for_test`` programs' at rtol 1e-4 / atol 1e-5 (folding changes the
rounding) and the JAX package's transpiled run at the same tolerance.
The programs: a narrow ResNet (``test_torch_resnet``'s net), an fc +
batch_norm + dropout net, a primitive-attention net (which becomes
``scaled_dot_product_attention``) and a constant-folding net.
"""
import json

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as tpt
from paddle_tpu.core import program as jprog
from paddle_tpu_torch.core import program as tprog

torch.set_num_threads(1)
RUN_TOL = dict(rtol=1e-4, atol=1e-5)
B = 3


# --- builders: f(pt, is_test) -> (feeds {name: array}, fetch var) ----------------
def resnet_net(pt, is_test=False):
    from test_torch_resnet import _narrow

    images = pt.layers.data("images", [32, 32, 3])
    return ({"images": np.random.RandomState(3).randn(B, 32, 32, 3)},
            _narrow(pt, images, is_test))


def fc_bn_dropout_net(pt, is_test=False):
    x = pt.layers.data("x", [12])
    h = pt.layers.fc(x, size=16)
    h = pt.layers.batch_norm(h, is_test=is_test)
    h = pt.layers.dropout(h, dropout_prob=0.25, is_test=is_test)
    h = pt.layers.fc(pt.layers.relu(h), size=5)
    return ({"x": np.random.RandomState(4).randn(B, 12)},
            pt.layers.dropout(h, dropout_prob=0.5, is_test=is_test))


def attention_net(pt, is_test=False):
    H, T, D = 2, 8, 16
    q, k, v = (pt.layers.data(n, [H, T, D]) for n in ("q", "k", "v"))
    s = pt.layers.matmul(q, k, transpose_y=True, alpha=0.5)
    s = pt.layers.scale(s, scale=0.5)
    o = pt.layers.matmul(pt.layers.softmax(s), v)
    rs = np.random.RandomState(5)
    return {n: rs.randn(B, H, T, D) for n in ("q", "k", "v")}, o


def const_net(pt, is_test=False):
    x = pt.layers.data("x", [4])
    c = pt.layers.fill_constant([4], "float32", 2.0)
    c = pt.layers.scale(c, scale=3.0, bias=1.0)
    y = pt.layers.elementwise_add(x, c)
    return ({"x": np.random.RandomState(6).randn(B, 4)},
            pt.layers.fc(y, size=3))


# --- shared machinery -----------------------------------------------------------
def program_dict(pt, program):
    """``program_to_dict`` as JSON would carry it, without the metadata
    attrs one package stamps and the other does not (JAX's ``_callsite``,
    the port backward's ``_vjp_key``), int64 vars read as int32."""
    d = json.loads(json.dumps(pt.io.program_to_dict(program)))
    for b in d["blocks"]:
        for op in b["ops"]:
            op["attrs"].pop("_callsite", None)
            op["attrs"].pop("_vjp_key", None)
        for v in b["vars"]:
            if v["dtype"] == "int64":
                v["dtype"] = "int32"
    return d


class Pair:
    """One builder's program in both packages: (main, startup, scope) per
    package, the port's scope holding its own startup's values (the
    JAX startup's, bit for bit)."""

    def __init__(self, builder, fused=False, test_clone=False):
        self.builder = builder
        start = jprog.Program._uid_counter
        built = []
        for pt, counter in ((jpt, jprog), (tpt, tprog)):
            counter.Program._uid_counter = start
            old = pt.flags.FLAGS.fused_conv_epilogue
            pt.flags.FLAGS.fused_conv_epilogue = fused
            try:
                main, startup = pt.Program(), pt.Program()
                startup.random_seed = 5
                with pt.program_guard(main, startup):
                    feeds, fetch = builder(pt)
            finally:
                pt.flags.FLAGS.fused_conv_epilogue = old
            if test_clone:
                main = main.clone(for_test=True)
            built.append((main, startup, fetch.name))
        (self.jmain, jstart, self.fetch), (self.tmain, tstart, tfetch) = built
        assert tfetch == self.fetch
        self.feeds = {k: v.astype(np.float32) for k, v in feeds.items()}
        self.feed_names = sorted(self.feeds)
        self.jscope = jpt.Scope()
        jpt.Executor(jpt.CPUPlace()).run(jstart, scope=self.jscope)
        self.tscope = tpt.Scope()
        tpt.Executor(tpt.CPUPlace()).run(tstart, scope=self.tscope)
        # the port's own startup draws the JAX startup's values, bit for bit
        for n in self.jscope.keys():
            if n != jprog.RNG_VAR:
                np.testing.assert_array_equal(
                    self.tscope.get_numpy(n),
                    np.asarray(self.jscope.get(n)), err_msg=n)

    def transpile(self, make_pm, **ctx):
        """Run ``make_pm(pt)``'s pipeline on clones in both packages, each
        with a child scope; returns ((program, child scope, pm) per
        package)."""
        out = []
        for pt, main, scope in ((jpt, self.jmain, self.jscope),
                                (tpt, self.tmain, self.tscope)):
            child = pt.Scope(parent=scope)
            pm = make_pm(pt)
            prog = pm.run(main.clone(), self.feed_names, [self.fetch],
                          scope=child, **ctx)
            out.append((prog, child, pm))
        return out

    def run(self, pt, program, scope):
        exe = pt.Executor(pt.CPUPlace())
        return np.asarray(exe.run(program, feed=self.feeds,
                                  fetch_list=[self.fetch], scope=scope)[0])


def assert_same(pair, jres, tres):
    """Equal program dicts and bitwise-equal new scope values."""
    (jp, jchild, _), (tp, tchild, _) = jres, tres
    assert program_dict(tpt, tp) == program_dict(jpt, jp)
    assert sorted(tchild.keys()) == sorted(jchild.keys())
    for name in jchild.keys():
        want = np.asarray(jchild.get(name))
        got = tchild.get_numpy(name)
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    return sorted(jchild.keys())


def op_types(program):
    return [op.type for op in program.global_block.ops]


# --- one pass at a time ---------------------------------------------------------
def _single(name, **kw):
    def make(pt):
        return pt.transpiler.PassManager([
            getattr(pt.transpiler, name)(**kw)])
    return make


@pytest.mark.parametrize("builder", [resnet_net, fc_bn_dropout_net,
                                     attention_net, const_net])
def test_expand_recompute_and_is_test_passes_match_jax(builder):
    pair = Pair(builder)
    for name in ("ExpandRecomputeSegments", "CanonicalizeIsTest"):
        jres, tres = pair.transpile(_single(name))
        assert_same(pair, jres, tres)
    assert all(op.attrs.get("is_test", True)
               for op in tres[0].global_block.ops)


def test_expand_recompute_raises_on_a_segment():
    """Recompute segments are ported: the pass inlines a ``seg_fwd``
    into the ops it stands for."""
    prog = tpt.Program()
    sop = {"type": "relu", "attrs": {}, "ins": {"X": ["x"]},
           "outs": {"Out": ["y"]}}
    prog.global_block.append_op("seg_fwd", {"I": ["x"]}, {"O": ["y"]},
                                {"seg_ops": [sop]})
    tpt.transpiler.ExpandRecomputeSegments().apply(
        prog, tpt.transpiler.PassContext([], []))
    op, = prog.global_block.ops
    assert (op.type, op.inputs, op.outputs) == ("relu", {"X": ["x"]},
                                                {"Out": ["y"]})


def test_dropout_to_scale_matches_jax():
    pair = Pair(fc_bn_dropout_net, test_clone=True)
    jres, tres = pair.transpile(_single("DropoutToScale"))
    assert_same(pair, jres, tres)
    types = op_types(tres[0])
    assert "dropout" not in types and types.count("scale") == 2
    np.testing.assert_array_equal(
        pair.run(tpt, tres[0], tres[1]),
        pair.run(tpt, pair.tmain, pair.tscope))


def test_dead_op_elimination_drops_the_training_slice_as_jax_does():
    """A program with loss, backward and SGD updates, pruned to its
    logits."""
    start = jprog.Program._uid_counter
    built = []
    for pt, counter in ((jpt, jprog), (tpt, tprog)):
        counter.Program._uid_counter = start
        main, startup = pt.Program(), pt.Program()
        with pt.program_guard(main, startup):
            _, logits = fc_bn_dropout_net(pt)
            label = pt.layers.data("label", [1], "int64")
            loss = pt.layers.mean(
                pt.layers.softmax_with_cross_entropy(logits, label))
            pt.optimizer.SGDOptimizer(learning_rate=0.1).minimize(loss)
        built.append((main, logits.name))
    progs = []
    for pt, (main, fetch) in zip((jpt, tpt), built):
        n0 = len(main.global_block.ops)
        pm = pt.transpiler.PassManager([pt.transpiler.DeadOpElimination()])
        prog = pm.run(main.clone(), ["x"], [fetch])
        assert len(prog.global_block.ops) < n0
        progs.append(program_dict(pt, prog))
    assert progs[1] == progs[0]


def test_constant_folding_matches_jax():
    pair = Pair(const_net, test_clone=True)
    jres, tres = pair.transpile(_single("ConstantFolding"))
    folded = assert_same(pair, jres, tres)
    assert folded and "fill_constant" not in op_types(tres[0])
    assert "scale" not in op_types(tres[0])
    np.testing.assert_allclose(pair.run(tpt, tres[0], tres[1]),
                               pair.run(tpt, pair.tmain, pair.tscope),
                               **RUN_TOL)


@pytest.mark.parametrize("builder,fused", [(resnet_net, False),
                                           (resnet_net, True),
                                           (fc_bn_dropout_net, False)])
def test_fold_batch_norm_matches_jax(builder, fused):
    pair = Pair(builder, fused=fused, test_clone=True)
    jres, tres = pair.transpile(_single("FoldBatchNorm"))
    folded = assert_same(pair, jres, tres)
    assert "batch_norm" not in op_types(tres[0])
    assert any(n.endswith("@bnfold") for n in folded)
    np.testing.assert_allclose(pair.run(tpt, tres[0], tres[1]),
                               pair.run(tpt, pair.tmain, pair.tscope),
                               **RUN_TOL)


def test_fold_batch_norm_lowers_the_fused_op_as_jax_does():
    pair = Pair(resnet_net, fused=True, test_clone=True)
    jres, tres = pair.transpile(_single("FoldBatchNorm", lower_fused=True))
    assert_same(pair, jres, tres)
    types = op_types(tres[0])
    assert "conv1x1_bn_act" not in types and "batch_norm" not in types
    np.testing.assert_allclose(pair.run(tpt, tres[0], tres[1]),
                               pair.run(tpt, pair.tmain, pair.tscope),
                               **RUN_TOL)


def test_fuse_patterns_epilogue_matches_jax():
    pair = Pair(resnet_net, fused=False, test_clone=True)
    jres, tres = pair.transpile(_single("FusePatterns", epilogue=True))
    assert_same(pair, jres, tres)
    assert op_types(tres[0]).count("conv1x1_bn_act") == 7
    np.testing.assert_allclose(pair.run(tpt, tres[0], tres[1]),
                               pair.run(tpt, pair.tmain, pair.tscope),
                               **RUN_TOL)


def test_fuse_patterns_attention_matches_jax():
    pair = Pair(attention_net, test_clone=True)
    jres, tres = pair.transpile(_single("FusePatterns"))
    assert_same(pair, jres, tres)
    (op,) = tres[0].global_block.ops
    assert op.type == "scaled_dot_product_attention"
    assert op.attrs["sm_scale"] == 0.25 and op.attrs["causal"] is False
    got = pair.run(tpt, tres[0], tres[1])
    np.testing.assert_allclose(got, pair.run(tpt, pair.tmain, pair.tscope),
                               **RUN_TOL)
    np.testing.assert_allclose(got, pair.run(jpt, jres[0], jres[1]),
                               **RUN_TOL)


# --- the pipeline ---------------------------------------------------------------
@pytest.mark.parametrize("builder,fused", [(resnet_net, False),
                                           (resnet_net, True),
                                           (fc_bn_dropout_net, False),
                                           (attention_net, False),
                                           (const_net, False)])
def test_inference_pipeline_matches_jax(builder, fused):
    """With ``--fused_conv_epilogue`` the 1x1 chains become the fused op
    and only the rest folds; without it every conv+BN folds."""
    pair = Pair(builder, fused=fused)
    for pt in (jpt, tpt):
        pt.flags.FLAGS.fused_conv_epilogue = fused
    try:
        jres, tres = pair.transpile(
            lambda pt: pt.transpiler.inference_pipeline())
    finally:
        jpt.flags.FLAGS.fused_conv_epilogue = False
        tpt.flags.reset_flags()
    assert_same(pair, jres, tres)
    types = op_types(tres[0])
    assert "batch_norm" not in types and "dropout" not in types
    if builder is resnet_net:
        assert types.count("conv1x1_bn_act") == (7 if fused else 0)
    test_prog = pair.tmain.clone(for_test=True)
    got = pair.run(tpt, tres[0], tres[1])
    np.testing.assert_allclose(got, pair.run(tpt, test_prog, pair.tscope),
                               **RUN_TOL)
    np.testing.assert_allclose(got, pair.run(jpt, jres[0], jres[1]),
                               **RUN_TOL)
    assert [r["pass"] for r in tres[2].stats()] == \
        [r["pass"] for r in jres[2].stats()]


def test_pass_manager_stats_dumps_and_registry(tmp_path):
    T = tpt.transpiler
    pair = Pair(fc_bn_dropout_net, test_clone=True)
    pm = T.inference_pipeline(dump_hook=T.ir_dump_hook(str(tmp_path)))
    prog = pm.run(pair.tmain.clone(), pair.feed_names, [pair.fetch],
                  scope=tpt.Scope(parent=pair.tscope))
    rows = pm.stats()
    assert [r["pass"] for r in rows] == [
        "expand_recompute_segments", "canonicalize_is_test",
        "dead_op_elimination", "dropout_to_scale", "constant_fold",
        "fuse_patterns", "fold_batch_norm", "dead_op_elimination"]
    m = pm.metrics_dict()
    assert m["transpile/ops_removed"] == (rows[0]["ops_before"]
                                          - len(prog.global_block.ops))
    assert "fold_batch_norm" in pm.format_stats()
    dumps = sorted(p.name for p in tmp_path.iterdir())
    assert dumps and all(d.endswith((".before.txt", ".after.txt"))
                         for d in dumps)
    assert sorted(T.registered_passes()) == sorted(
        r["pass"] for r in rows[:-1])
    assert isinstance(T.get_pass("fold_batch_norm"), T.FoldBatchNorm)
    with pytest.raises(ValueError, match="already registered"):
        T.register_pass(T.FoldBatchNorm)
    with pytest.raises(KeyError):
        T.get_pass("no_such_pass")


def test_later_pieces_raise_naming_the_roadmap():
    T = tpt.transpiler
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        T.inference_pipeline(reduce_peak=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        T.PassManager([], verify_each=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        T.shard_program(None, None, [], [])
