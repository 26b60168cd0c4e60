"""Subprocess worker of ``test_torch_multihost.py``; not a pytest module.

One process of a two-process cluster of the port (``torch.distributed``
over gloo, each process naming the CPU four times). Imports torch and the
port only.

``search``: builds a synthetic world from a seed, runs
:class:`ShardedSearch` over the global mesh for each layout, and (process
0) saves the outputs as ``.npz`` files under the given directory.
``serve``: runs the CLI (``ragroute_tpu_torch.main``) as one process of a
``--mesh 2x4`` cluster; process 0 serves HTTP, process 1 follows.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

LAYOUTS = (("2x4", "exact", "all"), ("4x2", "exact", "ragroute"),
           ("1x8", "exact", "ragroute"), ("1x8", "ivf", "all"),
           ("2x4", "lowrank", "ragroute"))


def search(pid: int, port: str, out_dir: str) -> None:
    import numpy as np
    import torch

    from ragroute_tpu_torch.parallel import (ShardedSearch,
                                             initialize_multihost,
                                             make_multihost_mesh,
                                             parse_mesh_spec)
    from torch_multihost_world import world_and_engine_parts

    torch.set_num_threads(1)
    initialize_multihost(f"127.0.0.1:{port}", 2, pid, local_device_count=4,
                         device="cpu")
    for spec, impl, strategy in LAYOUTS:
        syn, ss, router, bank = world_and_engine_parts(impl)
        dp, idx = parse_mesh_spec(spec)
        mesh = make_multihost_mesh(dp=dp, idx=idx)
        eng = ShardedSearch(ss, router, bank, mesh, impl=impl)
        out = eng.search(dict(syn.query_embs), strategy=strategy)
        if pid == 0:
            np.savez(os.path.join(out_dir, f"{spec}_{impl}_{strategy}.npz"),
                     **{k: v for k, v in vars(out).items()
                        if isinstance(v, np.ndarray)})
    print(f"process {pid} done", flush=True)


def serve(pid: int, port: str, http_port: str) -> None:
    os.environ["RAGROUTE_LOCAL_DEVICES"] = "4"
    from ragroute_tpu_torch import main as cli

    cli.main(["--dataset", "medrag", "--simulate", "--disable-llm",
              "--device", "cpu", "--dtype", "float32", "--mesh", "2x4",
              "--buckets", "8", "--coordinator", f"127.0.0.1:{port}",
              "--num-processes", "2", "--process-id", str(pid),
              "--port", http_port])


if __name__ == "__main__":
    mode, pid, port, arg = sys.argv[1:5]
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if mode == "search":
        search(int(pid), port, arg)
    else:
        serve(int(pid), port, arg)
