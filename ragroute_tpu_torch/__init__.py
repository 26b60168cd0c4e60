"""PyTorch + CUDA port of ragroute-tpu, for an NVIDIA H100.

The routed serving path of the JAX package ``ragroute_tpu`` (HTTP /query ->
micro-batcher -> router MLP -> routing mask -> per-shard top-k -> cross-shard
merge -> response) in PyTorch: exact search, and the approximate
device-resident modes (cluster-probed IVF, hybrid, low-rank two-stage, int4
stores). The TPU's Pallas kernels on that path are hand-written CUDA kernels
here (``csrc/fused_topk.cu``, ``csrc/stream_topk.cu``,
``csrc/grouped_gains.cu``). Module names and layout follow the JAX package,
which stays the reference the port is held against.

This package imports torch and never jax, and nothing of the JAX package: it
keeps its own copies of the host-side modules it needs (``config``,
``oracle``, ``benchmark``, the server's leaf modules), which
``tests/test_torch_vendored.py`` holds to the originals.
"""

from ragroute_tpu_torch.config import WORLDS, get_world

__all__ = ["WORLDS", "get_world"]
