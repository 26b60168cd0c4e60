"""The port's router (features, MLP, masks, checkpoints) against JAX.

Router probabilities within ``atol=1e-5``; masks equal except where
``|p - threshold| < 1e-5``; ``random`` routes exactly ``random_subset``
sources per query.
"""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax
import jax.numpy as jnp

from ragroute_tpu.config import get_world
from ragroute_tpu.router import RouterBank as JBank
from ragroute_tpu.router import build_features as jfeatures
from ragroute_tpu.router import init_router_params, router_forward
from ragroute_tpu.router import routing_mask as jmask
from ragroute_tpu.router.torch_import import save_router_npz
from ragroute_tpu_torch.router import (CorpusRouter, RouterBank,
                                       build_features, load_router_npz,
                                       params_from_jax, routing_mask)


@pytest.fixture(autouse=True)
def _one_thread():
    """One thread for torch and for numpy's BLAS: the suite's workers share
    the cores, and oversubscribed ``eigh`` / matmul calls crawl."""
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield


def _inputs(world, bsz, seed):
    rng = np.random.default_rng(seed)
    dims = {s.encoder: s.embed_dim for s in world.sources}
    embs = {e: rng.standard_normal((bsz, d)).astype(np.float32)
            for e, d in dims.items()}
    cents = {s.name: rng.standard_normal(s.embed_dim).astype(np.float32)
             for s in world.sources}
    scaler = None
    if world.uses_scaler:
        scaler = (rng.standard_normal(world.router_input_dim).astype(
            np.float32) * 0.1,
                  rng.uniform(0.5, 2.0, world.router_input_dim).astype(
            np.float32))
    return embs, cents, scaler


def _torch_router(params, input_dim):
    model = CorpusRouter(input_dim)
    model.load_state_dict(params_from_jax(params))
    return model.eval()


@pytest.mark.parametrize("world_name", ["medrag", "wikipedia", "feb4rag"])
def test_features_probs_and_mask_match_jax(world_name):
    world = get_world(world_name)
    embs, cents, scaler = _inputs(world, 16, 0)
    jbank = JBank.create(world, cents, scaler)
    tbank = RouterBank.create(world, cents, scaler)
    jx = jfeatures(world, jbank, {e: jnp.asarray(v) for e, v in embs.items()})
    tx = build_features(world, tbank,
                        {e: torch.from_numpy(v) for e, v in embs.items()})
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-6,
                               atol=1e-6)
    params = init_router_params(jax.random.key(1), world.router_input_dim)
    jp = np.asarray(jax.nn.sigmoid(router_forward(params, jx)))
    with torch.no_grad():
        tp = torch.sigmoid(_torch_router(params, world.router_input_dim)(tx))
    np.testing.assert_allclose(tp.numpy(), jp, atol=1e-5, rtol=0)
    thr = world.router_threshold
    jm = np.asarray(jmask(world, "ragroute", jnp.asarray(jp), None))
    tm = routing_mask(world, "ragroute", tp).numpy()
    near = np.abs(jp - thr) < 1e-5
    np.testing.assert_array_equal(tm[~near], jm[~near])


@pytest.mark.parametrize("strategy", ["all", "none"])
def test_fixed_strategies_equal_jax(strategy):
    world = get_world("medrag")
    probs = np.random.default_rng(2).uniform(size=(5, 4)).astype(np.float32)
    jm = np.asarray(jmask(world, strategy, jnp.asarray(probs), None))
    tm = routing_mask(world, strategy, torch.from_numpy(probs)).numpy()
    np.testing.assert_array_equal(tm, jm)


@pytest.mark.parametrize("world_name", ["medrag", "wikipedia", "feb4rag"])
def test_random_routes_exactly_random_subset_sources(world_name):
    world = get_world(world_name)
    probs = torch.zeros((64, world.num_sources))
    g = torch.Generator().manual_seed(0)
    m1 = routing_mask(world, "random", probs, g)
    m2 = routing_mask(world, "random", probs, g)
    assert (m1.sum(1) == world.random_subset).all()
    assert (m2.sum(1) == world.random_subset).all()
    assert not torch.equal(m1, m2)          # the generator advances
    g2 = torch.Generator().manual_seed(0)
    assert torch.equal(routing_mask(world, "random", probs, g2), m1)


def test_unknown_strategy_and_shape_raise():
    world = get_world("medrag")
    with pytest.raises(ValueError):
        routing_mask(world, "bogus", torch.zeros(2, 4))
    with pytest.raises(ValueError):
        routing_mask(world, "all", torch.zeros(2, 3))


def test_router_npz_round_trip_from_jax_checkpoint(tmp_path):
    world = get_world("wikipedia")
    params = init_router_params(jax.random.key(4), world.router_input_dim)
    mean = np.arange(world.router_input_dim, dtype=np.float32) * 1e-3
    scale = np.full(world.router_input_dim, 2.0, np.float32)
    path = str(tmp_path / "router.npz")
    save_router_npz(path, params, threshold=0.37, scaler=(mean, scale))
    tparams, thr, scaler = load_router_npz(path)
    assert thr == pytest.approx(0.37)
    np.testing.assert_array_equal(scaler[0], mean)
    np.testing.assert_array_equal(scaler[1], scale)
    state = params_from_jax(tparams)
    np.testing.assert_array_equal(state["fc1.weight"].numpy(),
                                  np.asarray(params["fc1"]["w"]).T)
    np.testing.assert_array_equal(state["ln2.weight"].numpy(),
                                  np.asarray(params["ln2"]["scale"]))
    x = np.random.default_rng(5).standard_normal(
        (3, world.router_input_dim)).astype(np.float32)
    with torch.no_grad():
        got = _torch_router(tparams, world.router_input_dim)(
            torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(router_forward(
        params, jnp.asarray(x))), atol=1e-5, rtol=0)


def test_from_seed_is_reproducible_with_linear_default_bounds():
    a = CorpusRouter.from_seed(1540, 7)
    b = CorpusRouter.from_seed(1540, 7)
    for (na, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), na
    bound = 1.0 / np.sqrt(1540)
    assert float(a.fc1.weight.detach().abs().max()) <= bound
    assert torch.equal(a.ln1.weight, torch.ones(256))
    assert not a.training
