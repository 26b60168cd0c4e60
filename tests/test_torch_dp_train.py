"""The dp-sharded router training step (``train_router.dp_train_step``)
against the single-device step and the JAX package's mesh step (CPU).

The port's meshes name the CPU eight times; the JAX mesh is the eight
virtual host devices, the batch split as ``__graft_entry__.py``'s dry run
splits it (``P(("dp", "idx"), None)``). Held:

* 24 dp steps over 2x4, dropout on, equal ``train_step`` on the whole batch
  with the same generator: losses within rtol 1e-5, parameters within rtol
  1e-5 and atol 1e-5 (``tests/test_torch_train.py``'s bound: where a
  gradient entry is near Adam's eps of 1e-8, the two sums' f32 orders move
  its step by up to a few 1e-6);
* with dropout off on both sides (as ``tests/test_torch_train.py`` holds the
  trainer), ten dp steps equal the JAX package's loss, gradients and optax
  update jitted over a 2x4 mesh with the batch sharded: losses rtol 1e-5,
  parameters atol 1e-5 (``tests/test_torch_train.py``'s bound);
* uneven batches, and batches with fewer rows than cells, weight each cell
  by its rows and equal ``train_step``;
* ``dropout_masks`` draws ``forward_train``'s uniforms in its order, and
  ``forward`` under their row slices gives ``forward_train``'s rows.
"""

import jax
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh as JMesh, NamedSharding, PartitionSpec as P
from threadpoolctl import threadpool_limits

from ragroute_tpu.router import init_router_params, router_forward
from ragroute_tpu.train import train_router as J
from ragroute_tpu_torch.parallel.mesh import make_mesh
from ragroute_tpu_torch.router import (CorpusRouter, params_from_jax,
                                       params_to_jax)
from ragroute_tpu_torch.router.mlp import dropout_masks
from ragroute_tpu_torch.train import train_router as T

D = 48


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield


def _mesh(dp=2, idx=4):
    return make_mesh(dp, idx, devices=[torch.device("cpu")] * (dp * idx))


def _batches(b, steps, seed=0):
    rng = np.random.default_rng(seed)
    return [(torch.from_numpy(rng.standard_normal((b, D)).astype(np.float32)),
             torch.from_numpy((rng.random(b) < 0.3).astype(np.float32)))
            for _ in range(steps)]


def _pair(seed=3):
    models = [CorpusRouter.from_seed(D, seed) for _ in range(2)]
    return [(m,) + T.make_optimizer(m, 3) for m in models]


def _run_both(b, steps, mesh, dropout: bool, pos_weight=2.0):
    (m1, o1, s1), (m2, o2, s2) = _pair()
    g1 = torch.Generator().manual_seed(1) if dropout else None
    g2 = torch.Generator().manual_seed(1) if dropout else None
    for x, y in _batches(b, steps):
        l1 = T.train_step(m1, o1, s1, x, y, pos_weight, g1)
        l2 = T.dp_train_step(m2, o2, s2, x, y, mesh, pos_weight, g2)
        assert float(l2) == pytest.approx(float(l1), rel=1e-5)
    for (name, a), b_ in zip(m1.state_dict().items(),
                             m2.state_dict().values()):
        torch.testing.assert_close(b_, a, rtol=1e-5, atol=1e-5, msg=name)


def test_masks_drawn_for_the_batch_are_forward_trains():
    # forward_train draws [16, 256] then [16, 128] uniforms from its
    # generator and keeps rand < 0.6; the row slices of masks drawn for the
    # whole batch give the rows of its parts (what each dp cell runs)
    model = CorpusRouter.from_seed(D, 0)
    x = torch.randn(16, D, generator=torch.Generator().manual_seed(0))
    want = model.forward_train(x, torch.Generator().manual_seed(5))
    g = torch.Generator().manual_seed(5)
    drawn = [torch.rand(16, w, generator=g) < 0.6 for w in (256, 128)]
    masks = dropout_masks((16,), torch.Generator().manual_seed(5), "cpu")
    assert all(torch.equal(a, b) for a, b in zip(masks, drawn))
    for lo, hi in [(0, 5), (5, 6), (6, 16)]:
        part = model(x[lo:hi], tuple(m[lo:hi] for m in drawn))
        torch.testing.assert_close(part, want[lo:hi], rtol=1e-6, atol=1e-6)


def test_24_dp_steps_equal_train_step_with_dropout():
    _run_both(64, 24, _mesh(), dropout=True)


@pytest.mark.parametrize("b,shape", [(61, (2, 4)), (5, (2, 4)),
                                     (30, (1, 3)), (9, (4, 2))])
def test_uneven_batches_weight_each_cell_by_its_rows(b, shape):
    _run_both(b, 6, _mesh(*shape), dropout=True)


def test_dp_steps_equal_the_jax_mesh_step_dropout_off():
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual mesh")
    pos_weight, spe = 2.0, 3
    jparams = init_router_params(jax.random.key(3), D)
    model = CorpusRouter(D)
    model.load_state_dict(params_from_jax(jparams))
    opt, sched = T.make_optimizer(model, spe)
    tx = J.make_optimizer(spe)
    jmesh = JMesh(np.asarray(jax.devices()[:8]).reshape(2, 4), ("dp", "idx"))
    repl = NamedSharding(jmesh, P())
    xs = NamedSharding(jmesh, P(("dp", "idx"), None))
    ys = NamedSharding(jmesh, P(("dp", "idx")))

    def loss_fn(p, x, y):
        return J.bce_with_logits(router_forward(p, x), y, pos_weight)

    grad_fn = jax.jit(jax.value_and_grad(loss_fn),
                      in_shardings=(repl, xs, ys))
    jparams = jax.device_put(jparams, repl)
    state = tx.init(jparams)
    mesh = _mesh()
    for x, y in _batches(64, 10, seed=4):
        loss = T.dp_train_step(model, opt, sched, x, y, mesh, pos_weight)
        jloss, grads = grad_fn(jparams, jax.device_put(x.numpy(), xs),
                               jax.device_put(y.numpy(), ys))
        updates, state = tx.update(grads, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    ours = params_to_jax(model.state_dict())
    for layer, fields in ours.items():
        for field, arr in fields.items():
            np.testing.assert_allclose(arr, np.asarray(jparams[layer][field]),
                                       atol=1e-5, err_msg=f"{layer}.{field}")
