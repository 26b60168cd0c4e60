"""Learned corpus router: features, the gating MLP, routing masks and
checkpoints."""

from ragroute_tpu_torch.router.features import RouterBank, build_features
from ragroute_tpu_torch.router.mlp import CorpusRouter
from ragroute_tpu_torch.router.strategies import routing_mask
from ragroute_tpu_torch.router.torch_import import (load_router_npz,
                                                    load_sklearn_scaler,
                                                    load_torch_router,
                                                    params_from_jax,
                                                    params_to_jax,
                                                    save_router_npz)

__all__ = ["CorpusRouter", "RouterBank", "build_features", "load_router_npz",
           "load_sklearn_scaler", "load_torch_router", "params_from_jax",
           "params_to_jax", "routing_mask", "save_router_npz"]
