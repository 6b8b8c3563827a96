"""The GAN and VAE demos' programs (``demos/gan_mnist.py``,
``demos/vae_mnist.py``), built with each package by the same builder,
trained on the CPU from the same startup weights and held against each
other.

The builders below are the demos' own code with ``pt`` set to either
package (Z 64, hidden 256, 784 pixels; the VAE's Z 16), at batch 16.
Each package runs its own startup (the RNG plane draws the same weights,
checked bit for bit), and the JAX startup's values are then carried into
the port's scope with ``scope_from_numpy``, with the port's own RNG key.
The batches are the first images of the synthetic MNIST (the demos'
shuffle is left out, as it draws from Python's global RNG), and the GAN's
noise z comes from ``RandomState(0)``.

GAN: three rounds of one D step and two G steps, as the demo alternates
them (3 D and 6 G steps). Every loss is held at ``LOSS_RTOL`` of JAX's;
each G step leaves every D parameter bitwise unchanged, in both packages;
each program's Adam updates only its own ``parameter_list``. The
parameters after the 9 steps are held by the nudge rule
(``tests/test_torch_zoo_alexnet.py``, ROADMAP): Adam's first updates
move each element by about lr times the sign of its gradient, so an
element whose gradient is near zero moves by up to a whole lr on a last-
bit change of the inputs. The JAX run is repeated with the images nudged
by (1 + 1e-6), and each port parameter's gap to JAX is held within
``NUDGE_MULT`` times that run's own move (or 1e-6 of the parameter's
norm, whichever is larger).

VAE: three steps (the noise drawn by ``gaussian_random_batch_size_like``
from the scope key, bit-exact with ``jax.random``), the losses at
``LOSS_RTOL`` and the parameters by the same rule; the ``for_test``
clone's reconstruction equals JAX's within 8 f32 ulps of its largest
value and lies in [0, 1].
"""
import numpy as np
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as tpt
from paddle_tpu.core import program as jprog
from paddle_tpu_torch.core import program as tprog
from paddle_tpu_torch.dataset import mnist
from test_torch_activation_ops import F32_ULPS, _ulps

torch.set_num_threads(1)
BATCH = 16
Z_DIM, HIDDEN, X_DIM, VAE_Z = 64, 256, 784, 16
G_PARAMS = ["g_fc1_w", "g_fc1_b", "g_fc2_w", "g_fc2_b"]
D_PARAMS = ["d_fc1_w", "d_fc1_b", "d_fc2_w", "d_fc2_b"]
LOSS_RTOL = 1e-5
NUDGE = 1e-6
NUDGE_MULT = 4.0
PARAM_FLOOR = 1e-6


# --- the demos' builders, for either package --------------------------------
def _generator(pt, z):
    P = pt.param_attr.ParamAttr
    h = pt.layers.fc(z, size=HIDDEN, act="relu",
                     param_attr=P(name="g_fc1_w"), bias_attr=P(name="g_fc1_b"))
    return pt.layers.fc(h, size=X_DIM, act="tanh",
                        param_attr=P(name="g_fc2_w"),
                        bias_attr=P(name="g_fc2_b"))


def _discriminator(pt, x):
    P = pt.param_attr.ParamAttr
    h = pt.layers.fc(x, size=HIDDEN, param_attr=P(name="d_fc1_w"),
                     bias_attr=P(name="d_fc1_b"))
    h = pt.layers.leaky_relu(h, alpha=0.2)
    return pt.layers.fc(h, size=1, param_attr=P(name="d_fc2_w"),
                        bias_attr=P(name="d_fc2_b"))


def _bce_mean(pt, logit, target_value):
    target = pt.layers.fill_constant_batch_size_like(
        logit, shape=[-1, 1], value=target_value, dtype="float32")
    return pt.layers.mean(
        pt.layers.sigmoid_cross_entropy_with_logits(logit, target))


def gan_programs(pt):
    """(d_prog, g_prog, startup, d_loss, g_loss), as the demo builds them."""
    startup = pt.Program()
    d_prog = pt.Program()
    with pt.program_guard(d_prog, startup):
        x_real = pt.layers.data("x_real", shape=[X_DIM])
        z = pt.layers.data("z", shape=[Z_DIM])
        fake = _generator(pt, z)
        d_loss = pt.layers.elementwise_add(
            _bce_mean(pt, _discriminator(pt, x_real), 0.9),
            _bce_mean(pt, _discriminator(pt, fake), 0.0))
        pt.optimizer.AdamOptimizer(learning_rate=2e-4, beta1=0.5).minimize(
            d_loss, parameter_list=D_PARAMS, startup_program=startup)
    g_prog = pt.Program()
    with pt.program_guard(g_prog, startup):
        z = pt.layers.data("z", shape=[Z_DIM])
        g_loss = _bce_mean(pt, _discriminator(pt, _generator(pt, z)), 1.0)
        pt.optimizer.AdamOptimizer(learning_rate=2e-4, beta1=0.5).minimize(
            g_loss, parameter_list=G_PARAMS, startup_program=startup)
    startup.random_seed = 7
    return d_prog, g_prog, startup, d_loss, g_loss


def vae_program(pt):
    """(main, startup, infer_prog, loss, recon), as the demo builds them."""
    L = pt.layers
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = L.data("x", shape=[X_DIM])
        h = L.fc(x, size=HIDDEN, act="relu")
        mu = L.fc(h, size=VAE_Z)
        logvar = L.fc(h, size=VAE_Z)
        eps = L.gaussian_random_batch_size_like(
            mu, shape=[-1, VAE_Z], mean=0.0, std=1.0)
        sigma = L.exp(L.scale(logvar, 0.5))
        z = L.elementwise_add(mu, L.elementwise_mul(sigma, eps))
        d = L.fc(z, size=HIDDEN, act="relu")
        x_logits = L.fc(d, size=X_DIM)
        rec = L.reduce_sum(
            L.sigmoid_cross_entropy_with_logits(x_logits, x), dim=[1])
        kl_terms = L.elementwise_sub(
            L.elementwise_add(L.exp(logvar), L.square(mu)),
            L.scale(logvar, 1.0, bias=1.0))
        kl = L.scale(L.reduce_sum(kl_terms, dim=[1]), 0.5)
        loss = L.mean(L.elementwise_add(rec, kl))
        recon = L.sigmoid(x_logits)
        infer_prog = main.clone(for_test=True)
        pt.optimizer.AdamOptimizer(learning_rate=1e-3).minimize(
            loss, startup_program=startup)
    startup.random_seed = 11
    return main, startup, infer_prog, loss, recon


# --- running both packages ----------------------------------------------------
def _images(n_batches):
    it = mnist.train()()
    rows = [next(it)[0] for _ in range(n_batches * BATCH)]
    return np.stack(rows).reshape(n_batches, BATCH, X_DIM)


def _build_both(builder):
    start = jprog.Program._uid_counter
    built = {}
    for pt, counter in ((jpt, jprog), (tpt, tprog)):
        counter.Program._uid_counter = start
        built[pt] = builder(pt)
    return built[jpt], built[tpt]


def _scopes(jstartup, tstartup):
    """(JAX scope, port scope) after each startup; the port's weights
    are JAX's, carried over with ``scope_from_numpy``. The two startups'
    outputs are paired by op position: the learning-rate vars' names
    follow each backward's count of names and differ."""
    jscope = jpt.Scope()
    jpt.Executor(jpt.CPUPlace()).run(jstartup, scope=jscope)
    own = tpt.Scope()
    tpt.Executor(tpt.CPUPlace()).run(tstartup, scope=own)
    jops, tops = jstartup.global_block.ops, tstartup.global_block.ops
    assert [op.type for op in jops] == [op.type for op in tops]
    values = {}
    for jop, top in zip(jops, tops):
        for jn, tn in zip(jop.output_names(), top.output_names()):
            values[tn] = np.asarray(jscope.get(jn))
            # the RNG plane: the port's startup draws the same values
            np.testing.assert_array_equal(own.get_numpy(tn), values[tn],
                                          err_msg=tn)
    tscope = tpt.scope_from_numpy(values, "cpu")
    tscope.set(tprog.RNG_VAR, own.get(tprog.RNG_VAR))
    return jscope, tscope


def _params(pt, scope, names):
    if pt is jpt:
        return {n: np.asarray(scope.get(n)) for n in names}
    return {n: scope.get_numpy(n) for n in names}


def _adam_params(program):
    return sorted(op.input("Param") for op in program.global_block.ops
                  if op.type == "adam")


def _gan_run(pt, built, scope, images):
    d_prog, g_prog, _, d_loss, g_loss = built
    exe = pt.Executor(pt.CPUPlace())
    rng = np.random.RandomState(0)
    losses, frozen = [], []
    for x in images:
        z = rng.randn(BATCH, Z_DIM).astype(np.float32)
        dl, = exe.run(d_prog, feed={"x_real": x, "z": z},
                      fetch_list=[d_loss], scope=scope)
        losses.append(float(np.asarray(dl)))
        for _ in range(2):
            z = rng.randn(BATCH, Z_DIM).astype(np.float32)
            before = _params(pt, scope, D_PARAMS)
            gl, = exe.run(g_prog, feed={"z": z}, fetch_list=[g_loss],
                          scope=scope)
            after = _params(pt, scope, D_PARAMS)
            frozen.append(all(np.array_equal(before[n], after[n])
                              for n in D_PARAMS))
            losses.append(float(np.asarray(gl)))
    return losses, frozen


def _nudge_gate(port, jax_, nudged):
    for name in jax_:
        gap = np.linalg.norm(port[name] - jax_[name])
        move = np.linalg.norm(nudged[name] - jax_[name])
        floor = PARAM_FLOOR * np.linalg.norm(jax_[name])
        assert gap <= max(NUDGE_MULT * move, floor), (name, gap, move)


def test_gan_programs_train_as_jax():
    jbuilt, tbuilt = _build_both(gan_programs)
    for j, t in zip(jbuilt[:2], tbuilt[:2]):
        assert [op.type for op in t.global_block.ops] == \
            [op.type for op in j.global_block.ops]
    # each program's Adam updates its own list only
    for built in (jbuilt, tbuilt):
        assert _adam_params(built[0]) == sorted(D_PARAMS)
        assert _adam_params(built[1]) == sorted(G_PARAMS)
    images = _images(3)
    jscope, tscope = _scopes(jbuilt[2], tbuilt[2])
    nscope, _ = _scopes(jbuilt[2], tbuilt[2])
    jloss, jfrozen = _gan_run(jpt, jbuilt, jscope, images)
    tloss, tfrozen = _gan_run(tpt, tbuilt, tscope, images)
    _gan_run(jpt, jbuilt, nscope, images * np.float32(1 + NUDGE))
    assert all(jfrozen) and all(tfrozen) and len(tfrozen) == 6
    np.testing.assert_allclose(tloss, jloss, rtol=LOSS_RTOL)
    names = D_PARAMS + G_PARAMS
    _nudge_gate(_params(tpt, tscope, names), _params(jpt, jscope, names),
                _params(jpt, nscope, names))


def _vae_run(pt, built, scope, images):
    main, _, infer, loss, recon = built
    exe = pt.Executor(pt.CPUPlace())
    losses = []
    for x in images:
        lo, = exe.run(main, feed={"x": (x + 1.0) / 2.0}, fetch_list=[loss],
                      scope=scope)
        losses.append(float(np.asarray(lo)))
    rec, = exe.run(infer, feed={"x": (images[0][:4] + 1.0) / 2.0},
                   fetch_list=[recon], scope=scope)
    return losses, np.asarray(rec, np.float32)


def test_vae_program_trains_as_jax():
    jbuilt, tbuilt = _build_both(vae_program)
    assert [op.type for op in tbuilt[0].global_block.ops] == \
        [op.type for op in jbuilt[0].global_block.ops]
    images = _images(3)
    jscope, tscope = _scopes(jbuilt[1], tbuilt[1])
    nscope, _ = _scopes(jbuilt[1], tbuilt[1])
    jloss, jrec = _vae_run(jpt, jbuilt, jscope, images)
    tloss, trec = _vae_run(tpt, tbuilt, tscope, images)
    _vae_run(jpt, jbuilt, nscope, images * np.float32(1 + NUDGE))
    np.testing.assert_allclose(tloss, jloss, rtol=LOSS_RTOL)
    assert trec.min() >= 0.0 and trec.max() <= 1.0
    assert _ulps(trec, jrec, "float32", at_max=True) <= F32_ULPS
    names = [p.name for p in tbuilt[0].global_block.all_parameters()]
    assert len(names) == 10
    _nudge_gate(_params(tpt, tscope, names), _params(jpt, jscope, names),
                _params(jpt, nscope, names))
