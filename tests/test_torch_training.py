"""Training the stacked transformer LM with the port against the JAX package.

``demos/transformer_lm.py``'s training half at vocab 97, T 32, d 64, 2
layers, 4 heads, batch 4, built in both packages. Each package runs its
own startup (the port's draws the JAX startup's values, checked bit
for bit); then both ``Executor``s run the same feeds. Step one's loss
and every parameter gradient match at rtol 1e-4 / atol 1e-6; the losses of 3 Adam steps at
rtol 1e-4; the parameters after one SGD step at atol 1e-6. (Adam moves
each weight by about lr * sign(g) on its first step, so a gradient that
is zero up to rounding could flip a weight by 2 lr between packages:
parameters are compared after SGD, and ``adam`` is held to JAX's on its
own in ``test_torch_ops.py``.) The port's own startup trains too, running
each layer's forward and backward once per step.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as tpt
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.ops import pipeline_ops

torch.set_num_threads(1)
V, T, D_MODEL, LAYERS, HEADS, BATCH = 97, 32, 64, 2, 4, 4
TOL = dict(rtol=1e-4, atol=1e-6)


def _build(pt, optimizer):
    main, startup = pt.Program(), pt.Program()
    startup.random_seed = 7
    with pt.program_guard(main, startup):
        ids = pt.layers.data("ids", shape=[T], dtype="int64")
        tgt = pt.layers.data("tgt", shape=[T], dtype="int64")
        logits = pt.models.transformer_lm(
            ids, vocab_size=V, d_model=D_MODEL, n_layers=LAYERS,
            num_heads=HEADS, max_len=2 * T, pipeline_stack=True)
        loss = pt.layers.mean(pt.layers.softmax_with_cross_entropy(
            pt.layers.reshape(logits, shape=[-1, V]),
            pt.layers.reshape(tgt, shape=[-1, 1])))
        opt = (pt.optimizer.AdamOptimizer(learning_rate=3e-3)
               if optimizer == "adam"
               else pt.optimizer.SGDOptimizer(learning_rate=0.5))
        params_grads = opt.minimize(loss, startup_program=startup)
    return main, startup, loss, [p.name for p, _ in params_grads]


def _batches(n, seed=0):
    """The demo's learnable language: token t+1 = (3 t + noise) % V."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        x = np.zeros((BATCH, T + 1), np.int64)
        x[:, 0] = rng.randint(0, V, size=BATCH)
        for t in range(T):
            x[:, t + 1] = (3 * x[:, t] + rng.randint(0, 2, size=BATCH)) % V
        out.append({"ids": x[:, :-1], "tgt": x[:, 1:]})
    return out


class _Pair:
    """One program built in both packages, each package's startup run into
    its own scope, the port's on the CPU."""

    def __init__(self, optimizer):
        self.jmain, jstartup, self.jloss, self.params = _build(jpt, optimizer)
        self.tmain, tstartup, self.tloss, tparams = _build(tpt, optimizer)
        assert tparams == self.params
        self.jscope = jpt.Scope()
        self.jexe = jpt.Executor(jpt.CPUPlace())
        self.jexe.run(jstartup, scope=self.jscope)
        self.tscope = tpt.Scope()
        self.texe = tpt.Executor(tpt.CPUPlace())
        self.texe.run(tstartup, scope=self.tscope)
        # the startup programs hold the same ops in the same order: their
        # outputs pair the names (the learning-rate var's differs), and the
        # port's own startup draws the JAX startup's values, bit for bit
        for jop, top in zip(jstartup.global_block.ops,
                            tstartup.global_block.ops):
            for jn, tn in zip(jop.output_names(), top.output_names()):
                np.testing.assert_array_equal(
                    self.tscope.get_numpy(tn), np.asarray(self.jscope.get(jn)),
                    err_msg=tn)

    def run(self, feed, names=()):
        """One step in each package: (JAX fetches, port fetches) of the
        loss and then ``names``."""
        jout = self.jexe.run(self.jmain, feed=feed,
                             fetch_list=[self.jloss.name, *names],
                             scope=self.jscope)
        tout = self.texe.run(self.tmain, feed=feed,
                             fetch_list=[self.tloss.name, *names],
                             scope=self.tscope)
        return [np.asarray(a) for a in jout], tout


def test_step_one_loss_and_every_gradient_match_jax():
    pair = _Pair("adam")
    grads = [f"{p}@GRAD" for p in pair.params]
    jout, tout = pair.run(_batches(1)[0], grads)
    assert len(pair.params) == 15
    for name, j, t in zip(["loss"] + grads, jout, tout):
        assert t.shape == j.shape, name
        np.testing.assert_allclose(t, j, err_msg=name, **TOL)


def test_three_adam_steps_lose_the_same():
    pair = _Pair("adam")
    jl, tl = [], []
    for feed in _batches(3, seed=1):
        jout, tout = pair.run(feed)
        jl.append(float(jout[0]))
        tl.append(float(tout[0]))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[-1] < tl[0]


def test_parameters_after_one_sgd_step_match_jax():
    pair = _Pair("sgd")
    pair.run(_batches(1, seed=2)[0])
    for name in pair.params:
        np.testing.assert_allclose(pair.tscope.get_numpy(name),
                                   np.asarray(pair.jscope.get(name)),
                                   atol=1e-6, rtol=0, err_msg=name)


def test_executor_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CPUPlace"):
        tpt.Executor()
    with pytest.raises(RuntimeError, match="CPUPlace"):
        tpt.Executor(tpt.CUDAPlace(0))
    assert tpt.Executor(tpt.CPUPlace()).device == torch.device("cpu")


def test_port_startup_trains_running_each_layer_once_per_step(monkeypatch):
    """The port's own startup (its generator, seeded from
    ``random_seed``), then 10 Adam steps: the loss falls, and every step
    runs each layer's attention forward and backward exactly once (the
    grad op consumes the forward's recorded vjp instead of recomputing
    it)."""
    main, startup, loss, params = _build(tpt, "adam")
    calls = {"fwd": 0, "bwd": 0}
    attention, backward = pipeline_ops.flash_attention, fa.flash_backward

    def counted_attention(*args, **kw):
        calls["fwd"] += 1
        return attention(*args, **kw)

    def counted_backward(*args, **kw):
        calls["bwd"] += 1
        return backward(*args, **kw)

    monkeypatch.setattr(pipeline_ops, "flash_attention", counted_attention)
    monkeypatch.setattr(fa, "flash_backward", counted_backward)
    scope = tpt.Scope()
    exe = tpt.Executor(tpt.CPUPlace())
    exe.run(startup, scope=scope)
    first = {p: scope.get_numpy(p) for p in params}
    again = tpt.Scope()
    exe.run(startup, scope=again)
    for p in params:  # the same seed draws the same weights
        np.testing.assert_array_equal(again.get_numpy(p), first[p])
    losses = []
    for step, feed in enumerate(_batches(10, seed=3)):
        calls.update(fwd=0, bwd=0)
        lo, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        assert calls == {"fwd": LAYERS, "bwd": LAYERS}, (step, calls)
        losses.append(float(lo))
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0] - 0.2, losses


def test_trained_scope_loads_into_the_serving_model():
    """The trained parameters keep the JAX names, so they load into the
    serving ``TransformerLM`` as they are and generate on the CPU."""
    main, startup, loss, params = _build(tpt, "sgd")
    scope = tpt.Scope()
    exe = tpt.Executor(tpt.CPUPlace())
    exe.run(startup, scope=scope)
    exe.run(main, feed=_batches(1)[0], fetch_list=[loss], scope=scope)
    spec = tpt.LMSpec(vocab_size=V, d_model=D_MODEL, n_layers=LAYERS,
                      num_heads=HEADS, max_len=2 * T)
    model = tpt.TransformerLM(spec, device="cpu")
    model.load_jax_params({p: scope.get_numpy(p) for p in params})
    assert torch.equal(dict(model.named_parameters())["lm_head.w"],
                       scope.get("lm_head.w"))
    eng = tpt.GenerationEngine(spec, model, slots=2, kv_cache="dense",
                               device="cpu")
    out, = eng.generate_all([np.arange(5) % V], max_new_tokens=3)
    assert out.shape == (8,) and ((out >= 0) & (out < V)).all()
