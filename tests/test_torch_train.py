"""The port's router trainer against the JAX package's (CPU).

``ragroute_tpu_torch.train.train_router`` is held to
``ragroute_tpu.train.train_router``: the learning-rate schedule at every
step of 150 epochs (rtol 1e-6: float64 against XLA's float32), the loss
(rtol 1e-6), the host helpers (threshold, metrics: equal; scaler: rtol
1e-6), ten Adam steps from the same parameters on the same batches with
dropout off on both sides (losses within rtol 1e-5 at every step,
parameters within atol 1e-5 after the tenth; the JAX side is
composed here from the JAX package's own ``router_forward``,
``bce_with_logits`` and ``make_optimizer``), the dropout masks, and whole
training runs on the JAX test's world (both beat the base rate by 0.1 with
AUC > 0.85, validation accuracies within 0.05, a ``split.json`` of either
package trains the other on its indices, the port's ``router.npz`` gives
the port's logits in the JAX forward within atol 1e-5). The scripts
``train_router`` of both packages write checkpoints both systems load.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax
import jax.numpy as jnp
import optax

from ragroute_tpu.router import init_router_params, router_forward
from ragroute_tpu.router import torch_import as jimport
from ragroute_tpu.train import train_router as J
from ragroute_tpu_torch.index.synthetic import (contribution_labels,
                                                make_synthetic_world,
                                                save_world)
from ragroute_tpu_torch.router import (CorpusRouter, RouterBank,
                                       build_features, params_from_jax,
                                       params_to_jax, save_router_npz)
from ragroute_tpu_torch.router.mlp import (DROPOUT_RATE, dropout,
                                          dropout_masks)
from ragroute_tpu_torch.router.torch_import import load_router
from ragroute_tpu_torch.train import train_router as T


@pytest.fixture(autouse=True)
def _one_thread():
    """One thread for torch and for numpy's BLAS: the suite's workers share
    the cores."""
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield


# ---- pieces of the trainer --------------------------------------------------

@pytest.mark.parametrize("steps_per_epoch", [3, 95])
def test_schedule_equals_the_optax_schedule_at_every_step(steps_per_epoch):
    n = T.NUM_EPOCHS * steps_per_epoch
    want = np.asarray(J.cyclic_then_step_schedule(steps_per_epoch)(
        jnp.arange(n)), np.float64)
    ours = T.cyclic_then_step_schedule(steps_per_epoch)
    got = np.array([ours(s) for s in range(n)])
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # LambdaLR on an lr of 1.0: the i-th optimizer.step() runs at ours(i),
    # as optax's i-th update runs at schedule(count = i)
    model = CorpusRouter(8)
    opt, sched = T.make_optimizer(model, steps_per_epoch)
    for i in range(2 * steps_per_epoch + 5):
        assert opt.param_groups[0]["lr"] == ours(i)
        opt.step()
        sched.step()


@pytest.mark.parametrize("pos_weight", [1.0, 5.0])
def test_bce_with_logits_equals_jax(pos_weight):
    rng = np.random.default_rng(1)
    logits = (3 * rng.standard_normal(256)).astype(np.float32)
    labels = (rng.random(256) < 0.4).astype(np.float32)
    want = float(J.bce_with_logits(jnp.asarray(logits), jnp.asarray(labels),
                                   pos_weight))
    got = float(T.bce_with_logits(torch.from_numpy(logits),
                                  torch.from_numpy(labels), pos_weight))
    assert got == pytest.approx(want, rel=1e-6)


def test_threshold_scaler_and_metrics_equal_jax():
    rng = np.random.default_rng(2)
    labels = rng.random(500) < 0.3
    logits = (rng.standard_normal(500) + 1.5 * labels).astype(np.float32)
    t = T.find_optimal_threshold(logits, labels)
    assert t == J.find_optimal_threshold(logits, labels)
    probs = 1.0 / (1.0 + np.exp(-logits))
    for thr in (t, 0.5):
        assert (T.classification_metrics(probs, labels, thr)
                == J.classification_metrics(probs, labels, thr))
    x = rng.standard_normal((300, 12)).astype(np.float32) * 3 + 1
    x[:, 4] = 2.5                                   # zero variance
    for got, want in zip(T.fit_scaler(x), J.fit_scaler(x)):
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=1e-6)


def test_dropout_keeps_six_tenths_scaled_and_repeats_with_its_seed():
    def masks(seed):
        return dropout_masks((4000,), torch.Generator().manual_seed(seed),
                             "cpu")

    m1, m2 = masks(3)
    assert (m1.shape, m2.shape) == ((4000, 256), (4000, 128))
    keep = 1.0 - DROPOUT_RATE
    for m in (m1, m2):
        h = torch.full(m.shape, 2.0)
        out = dropout(h, m)
        kept = out != 0
        assert torch.equal(kept, m)
        assert abs(kept.float().mean().item() - keep) < 0.01
        assert torch.equal(out[kept], torch.full_like(out[kept], 2.0 / keep))
    assert all(torch.equal(a, b) for a, b in zip((m1, m2), masks(3)))
    assert not any(torch.equal(a, b) for a, b in zip((m1, m2), masks(4)))
    # the train-mode forward draws from the generator it is given; the
    # serving forward draws nothing
    model = CorpusRouter.from_seed(16, 1)
    x = torch.randn(64, 16, generator=torch.Generator().manual_seed(0))
    a = model.forward_train(x, torch.Generator().manual_seed(9))
    b = model.forward_train(x, torch.Generator().manual_seed(9))
    assert torch.equal(a, b) and not torch.equal(a, model(x))
    assert list(model.state_dict()) == [
        "fc1.weight", "fc1.bias", "ln1.weight", "ln1.bias", "fc2.weight",
        "fc2.bias", "ln2.weight", "ln2.bias", "fc3.weight", "fc3.bias"]


@pytest.mark.parametrize("pos_weight", [1.0, 5.0])
def test_ten_adam_steps_equal_optax(pos_weight):
    """Same initial params (carried across with ``params_from_jax``), same
    batches, dropout off on both sides: ten steps of clip + Adam at the
    schedule's rates give parameters within atol 1e-5. Every third batch's
    soft labels sit near the loss's minimum at the current parameters, so
    that the clip leaves those steps and divides the others."""
    d, spe = 48, 3
    jparams = init_router_params(jax.random.key(3), d)
    model = CorpusRouter(d)
    model.load_state_dict(params_from_jax(jparams))
    opt, sched = T.make_optimizer(model, spe)
    tx = J.make_optimizer(spe)
    state = tx.init(jparams)

    def loss_fn(p, x, y):
        return J.bce_with_logits(router_forward(p, x), y, pos_weight)

    grad_fn = jax.jit(jax.value_and_grad(loss_fn))
    rng = np.random.default_rng(4)
    norms = []
    for step in range(10):
        x = rng.standard_normal((64, d)).astype(np.float32)
        y = (rng.random(64) < 0.35).astype(np.float32)
        if step % 3 == 2:
            # the minimiser of BCE with pos_weight at sigmoid(z) = p
            p = np.asarray(jax.nn.sigmoid(router_forward(jparams, x)))
            y = (0.7 * p / (pos_weight * (1 - p) + p) + 0.3 * y).astype(
                np.float32)
        loss = T.train_step(model, opt, sched, torch.from_numpy(x),
                            torch.from_numpy(y), pos_weight)
        jloss, grads = grad_fn(jparams, x, y)
        norms.append(float(optax.global_norm(grads)))
        updates, state = tx.update(grads, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    assert min(norms) < T.GRAD_CLIP < max(norms), norms
    ours = params_to_jax(model.state_dict())
    for layer, fields in ours.items():
        for field, arr in fields.items():
            np.testing.assert_allclose(arr, np.asarray(jparams[layer][field]),
                                       atol=1e-5, err_msg=f"{layer}.{field}")


# ---- whole training ---------------------------------------------------------

@pytest.fixture(scope="module")
def examples():
    """The JAX test's world: contribution labels, serving features."""
    syn = make_synthetic_world("medrag", docs_per_source=512,
                               num_queries=200, seed=7, with_payloads=False)
    labels = contribution_labels(syn)
    bank = RouterBank.create(syn.world, syn.centroids)
    feats = build_features(syn.world, bank, {
        e: torch.from_numpy(v) for e, v in syn.query_embs.items()}).numpy()
    return (feats.reshape(-1, syn.world.router_input_dim),
            labels.reshape(-1).astype(np.float32))


def test_whole_training_matches_jax_and_checkpoints_cross(examples,
                                                          tmp_path):
    x, y = examples
    split = str(tmp_path / "split.json")
    kw = dict(use_scaler=True, num_epochs=25, batch_size=128, seed=0)
    jres = J.train_router(x, y, split_path=split, **kw)      # writes it
    with open(split) as f:
        train_idx = json.load(f)["train"]
    tres = T.train_router(x, y, split_path=split, device="cpu", **kw)
    assert tres.devices == ["cpu"]
    assert tres.steps == 25 * (len(train_idx) // 128)
    base = max(y.mean(), 1 - y.mean())
    for res in (jres, tres):
        assert res.metrics["accuracy"] > base + 0.1, res.metrics
        assert res.metrics["auc"] > 0.85, res.metrics
        assert 0.0 < res.threshold < 1.0
    assert abs(jres.metrics["best_val_acc"]
               - tres.metrics["best_val_acc"]) <= 0.05
    # the port trained on the JAX split's rows: its scaler is their fit
    np.testing.assert_array_equal(tres.scaler[0],
                                  J.fit_scaler(x[train_idx])[0])
    np.testing.assert_array_equal(tres.scaler[1], jres.scaler[1])

    # the port's router.npz in the JAX package's loader and forward
    path = str(tmp_path / "router.npz")
    save_router_npz(path, tres.params, threshold=tres.threshold,
                    scaler=tres.scaler)
    jp, jthr, jsc = jimport.load_router_npz(path)
    assert jthr == pytest.approx(tres.threshold, rel=1e-7)
    np.testing.assert_array_equal(jsc[0], tres.scaler[0])
    xs = ((x[:256] - tres.scaler[0]) / tres.scaler[1]).astype(np.float32)
    model, thr, _ = load_router(path)
    with torch.no_grad():
        ours = model(torch.from_numpy(xs)).numpy()
    np.testing.assert_allclose(np.asarray(router_forward(jp, jnp.asarray(xs))),
                               ours, atol=1e-5)
    assert thr == jthr


def test_a_split_the_port_writes_trains_the_jax_package(examples, tmp_path):
    x, y = examples
    split = str(tmp_path / "split.json")
    train_idx, val_idx = T.split_indices(len(x), seed=5, split_path=split)
    assert sorted(np.concatenate([train_idx, val_idx]).tolist()) == \
        list(range(len(x)))
    # seed 0 would draw another split: the JAX trainer must read this one
    jres = J.train_router(x, y, split_path=split, num_epochs=1,
                          batch_size=128, seed=0)
    np.testing.assert_array_equal(jres.scaler[0],
                                  T.fit_scaler(x[train_idx])[0])
    assert not np.array_equal(train_idx, T.split_indices(len(x), seed=0)[0])


# ---- the scripts ------------------------------------------------------------

def test_train_router_scripts_write_checkpoints_both_systems_load(tmp_path):
    """``scripts/train_router.py`` and ``python -m
    ragroute_tpu_torch.scripts.train_router --device cpu`` on copies of one
    saved world: each ``router.npz`` loads in both systems'
    ``load_world_artifacts`` and gives both forwards the same logits."""
    import scripts.train_router as jscript
    from ragroute_tpu.config import get_world as jworld
    from ragroute_tpu.system import load_world_artifacts as jload
    from ragroute_tpu_torch.config import get_world
    from ragroute_tpu_torch.scripts import train_router as tscript
    from ragroute_tpu_torch.system import load_world_artifacts

    roots = {side: str(tmp_path / side) for side in ("jax", "port")}
    save_world(make_synthetic_world("medrag", docs_per_source=128,
                                    num_queries=48, seed=3), roots["jax"])
    shutil.copytree(roots["jax"], roots["port"])
    jscript.main(["--dataset", "medrag", "--data-root", roots["jax"],
                  "--epochs", "3"])
    result, path = tscript.main(["--dataset", "medrag", "--data-root",
                                 roots["port"], "--epochs", "3",
                                 "--device", "cpu"])
    assert path == os.path.join(roots["port"], "medrag", "router.npz")
    assert len(result.epoch_seconds) == 3 and result.steps % 3 == 0
    x, _ = tscript.world_examples(os.path.join(roots["port"], "medrag"),
                                  get_world("medrag"))
    for side in ("jax", "port"):
        out = load_world_artifacts(roots[side], get_world("medrag"))
        jout = jload(roots[side], jworld("medrag"))
        router, bank, thr = out[1], out[2], out[6]
        jparams, jbank, jthr = jout[1], jout[2], jout[6]
        assert thr == jthr and 0.0 < thr < 1.0
        np.testing.assert_array_equal(bank.scaler_mean.numpy(),
                                      np.asarray(jbank.scaler_mean))
        xs = ((x - bank.scaler_mean.numpy())
              / bank.scaler_scale.numpy()).astype(np.float32)
        with torch.no_grad():
            ours = router(torch.from_numpy(xs)).numpy()
        np.testing.assert_allclose(
            np.asarray(router_forward(jparams, jnp.asarray(xs))), ours,
            atol=1e-5, err_msg=side)
