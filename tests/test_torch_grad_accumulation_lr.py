"""Gradient accumulation's gating of the learning-rate counter in the
port, against the JAX package (the port twins of
``tests/test_grad_accumulation.py``'s schedule, clip and dtype tests).

- With a schedule on the shared ``lr_global_step`` counter and
  ``accumulate_steps=k``, the counter advances once an applied step:
  after every micro-batch run it equals JAX's (int32 in both), and so
  does the learning rate the schedule gives, bit for bit; the
  parameters after 2k runs equal JAX's within rtol 1e-5 / atol 1e-6.
- A global-norm clip acts on the accumulated mean: k micro-batches equal
  one step on the whole batch (rtol 1e-6 / atol 5e-6, the JAX test's
  tolerance), and equal JAX's accumulated run within rtol 1e-5 /
  atol 1e-6.
- The warmup + cosine recipe of ``demos/gpt_modern.py`` under k = 4
  steps its schedule once every fourth run, its values equal to JAX's
  bit for bit.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as tpt
from paddle_tpu.core import program as jprog
from paddle_tpu_torch.core import program as tprog
from test_torch_book import scopes
from test_torch_fused_head import trained_dict

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-6)


def _data():
    rng = np.random.RandomState(0)
    return (rng.rand(32, 6).astype("float32"),
            rng.randint(0, 4, (32, 1)).astype("int64"))


def _net(pt):
    L = pt.layers
    x = L.data("x", shape=[6])
    y = L.data("y", shape=[1], dtype="int64")
    logits = L.fc(L.fc(x, size=12, act="tanh"), size=4)
    return L.mean(L.softmax_with_cross_entropy(logits, y))


def _both(make_lr, k, opt="sgd", clip=None):
    """Both packages' (main, startup, loss, lr) from one name counter."""
    start = jprog.Program._uid_counter
    built = []
    for pt, counter in ((jpt, jprog), (tpt, tprog)):
        counter.Program._uid_counter = start
        main, startup = pt.Program(), pt.Program()
        startup.random_seed = 7
        with pt.program_guard(main, startup):
            loss = _net(pt)
            lr = make_lr(pt.learning_rate_decay)
            if clip:
                pt.clip.set_gradient_clip(
                    pt.clip.GradientClipByGlobalNorm(clip))
            cls = {"sgd": pt.optimizer.SGDOptimizer,
                   "adam": pt.optimizer.AdamOptimizer}[opt]
            cls(learning_rate=lr).minimize(loss, startup_program=startup,
                                           accumulate_steps=k)
        built.append((main, startup, loss, lr))
    assert trained_dict(tpt, built[1][0]) == trained_dict(jpt, built[0][0])
    return built


@pytest.mark.parametrize("opt", ["sgd", "adam"])
@pytest.mark.parametrize("k", [2, 3])
def test_schedule_counter_advances_once_an_apply(k, opt):
    (jm, js, jl, jlr), (tm, ts, tl, tlr) = _both(
        lambda d: d.exponential_decay(learning_rate=0.1, decay_steps=1,
                                      decay_rate=0.5, staircase=True), k,
        opt=opt)
    jscope, tscope = scopes(js, ts)
    X, Y = _data()
    jexe, texe = jpt.Executor(jpt.CPUPlace()), tpt.Executor(tpt.CPUPlace())
    for i in range(2 * k):
        q = i % 4
        feed = {"x": X[q * 8:(q + 1) * 8], "y": Y[q * 8:(q + 1) * 8]}
        jv = jexe.run(jm, feed=feed, fetch_list=[jl, jlr], scope=jscope)
        tv = texe.run(tm, feed=feed, fetch_list=[tl, tlr], scope=tscope)
        np.testing.assert_array_equal(np.asarray(tv[1]), np.asarray(jv[1]))
        tc = tscope.get([n for n in tscope.keys()
                         if "lr_global_step" in n][0])
        jc = np.asarray(jscope.get([n for n in jscope.keys()
                                    if "lr_global_step" in n][0]))
        assert tc.dtype == torch.int32 and jc.dtype == np.int32
        assert int(tc) == int(jc[0]) == (i + 1) // k
    for p in tm.global_block.all_parameters():
        np.testing.assert_allclose(tscope.get_numpy(p.name),
                                   np.asarray(jscope.get(p.name)),
                                   err_msg=p.name, **TOL)


def test_global_norm_clip_applies_to_the_mean():
    X, Y = _data()
    const = lambda d: 0.5  # noqa: E731  (a float learning rate)
    (jm, js, jl, _), (tm, ts, tl, _) = _both(const, 4, clip=0.01)
    jscope, tscope = scopes(js, ts)
    for q in range(4):
        feed = {"x": X[q * 8:(q + 1) * 8], "y": Y[q * 8:(q + 1) * 8]}
        jpt.Executor(jpt.CPUPlace()).run(jm, feed=feed, fetch_list=[jl],
                                         scope=jscope)
        tpt.Executor(tpt.CPUPlace()).run(tm, feed=feed, fetch_list=[tl],
                                         scope=tscope)
    # the port's one step on the whole batch, from the same weights (the
    # same draws in the same order)
    (_, jbs, _, _), (bm, bs, bl, _) = _both(const, 1, clip=0.01)
    _, big = scopes(jbs, bs)
    tpt.Executor(tpt.CPUPlace()).run(bm, feed={"x": X, "y": Y},
                                     fetch_list=[bl], scope=big)
    for p, q in zip(tm.global_block.all_parameters(),
                    bm.global_block.all_parameters()):
        np.testing.assert_allclose(tscope.get_numpy(p.name),
                                   big.get_numpy(q.name), rtol=1e-6,
                                   atol=5e-6, err_msg=p.name)
        np.testing.assert_allclose(tscope.get_numpy(p.name),
                                   np.asarray(jscope.get(p.name)),
                                   err_msg=p.name, **TOL)


def test_warmup_cosine_steps_once_every_fourth_run():
    def recipe(d):
        return d.linear_lr_warmup(d.cosine_decay(3e-3, decay_steps=150),
                                  warmup_steps=10, start_lr=3e-4,
                                  end_lr=3e-3)
    (jm, js, jl, jlr), (tm, ts, tl, tlr) = _both(recipe, 4, opt="adam")
    jscope, tscope = scopes(js, ts)
    X, Y = _data()
    lrs = []
    for i in range(12):
        feed = {"x": X[:8], "y": Y[:8]}
        jv = jpt.Executor(jpt.CPUPlace()).run(jm, feed=feed,
                                              fetch_list=[jlr], scope=jscope)
        tv = tpt.Executor(tpt.CPUPlace()).run(tm, feed=feed,
                                              fetch_list=[tlr], scope=tscope)
        np.testing.assert_array_equal(np.asarray(tv[0]), np.asarray(jv[0]))
        lrs.append(float(np.asarray(tv[0]).reshape(())))
    # the schedule reads the counter after its increment and before the
    # gate takes the increment back: 1 on runs 0-3, 2 on 4-7, 3 on 8-11
    assert [len(set(lrs[j:j + 4])) for j in (0, 4, 8)] == [1, 1, 1]
    assert lrs[0] < lrs[4] < lrs[8]
