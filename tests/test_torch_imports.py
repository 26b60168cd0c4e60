"""The port imports no jax and nothing of the JAX package, and its CLI
refuses what it does not serve.

``ragroute_tpu_torch`` must run on a machine without jax: a fresh
interpreter imports its entry points and no ``jax``, ``jaxlib`` or ``flax``
module, and no module of ``ragroute_tpu``, may be loaded; no source file of
the port names the JAX package in an import. Every CLI value outside the
ported slices fails at start-up naming its ROADMAP item; the values of the
approximate modes are accepted and reach the engine.
"""

import glob
import os
import re
import subprocess
import sys

import pytest
import torch

from ragroute_tpu_torch.main import parse_args
from ragroute_tpu_torch.system import ServingSystem, check_ported

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_entry_points_import_no_jax():
    code = (
        "import sys\n"
        "import ragroute_tpu_torch.main, ragroute_tpu_torch.system\n"
        "import ragroute_tpu_torch.ops.kernel_checks\n"
        "import ragroute_tpu_torch.index.synthetic\n"
        "import ragroute_tpu_torch.oracle, ragroute_tpu_torch.benchmark\n"
        "from ragroute_tpu_torch.engine.server import FederationServer\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax',\n"
        "                                    'ml_dtypes', 'ragroute_tpu')\n"
        "             or m.startswith('ragroute_tpu_torch._ref_'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_no_source_file_imports_the_jax_package():
    """No file of the port, nor ``chip_smoke.py``, imports ``ragroute_tpu``
    (or a submodule), or loads one of its files by path."""
    files = glob.glob(os.path.join(REPO, "ragroute_tpu_torch", "**", "*.py"),
                      recursive=True) + [os.path.join(REPO, "chip_smoke.py")]
    assert len(files) > 30
    pat = re.compile(r"(?:import|from)\s+ragroute_tpu(?!_torch)\b")
    bad = []
    for path in files:
        with open(path) as f:
            for n, line in enumerate(f, 1):
                if pat.search(line) or "spec_from_file_location" in line:
                    bad.append(f"{os.path.relpath(path, REPO)}:{n}")
    assert not bad, bad
    assert not os.path.exists(
        os.path.join(REPO, "ragroute_tpu_torch", "_reference.py"))


def test_cli_keeps_every_reference_flag_and_default():
    import main as reference_main

    ref = vars(reference_main.parse_args([]))
    ours = vars(parse_args([]))
    assert set(ours) == set(ref) | {"device"}
    assert {k: ours[k] for k in ref} == ref
    assert ours["device"] == "cuda"


@pytest.mark.parametrize("argv", [
    ["--mesh", "2x4"], ["--impl", "stream"], ["--impl", "hostrefine"],
    ["--mutable"], ["--reserve-docs", "8"], ["--embedder", "zoo"],
    ["--llm-backend", "jax"], ["--llm-quant", "int4"],
    ["--llm-serving", "continuous"], ["--frontend", "native"],
    ["--workers", "2"], ["--dtype", "policy"],
    ["--coordinator", "10.0.0.1:1234"], ["--num-processes", "2"],
    ["--hbm-budget-gb", "4"],
])
def test_unported_flag_values_fail_naming_roadmap(argv):
    args = parse_args(["--dataset", "medrag", "--device", "cpu", *argv])
    with pytest.raises(ValueError, match="ROADMAP"):
        check_ported(args)
    with pytest.raises(ValueError, match="ROADMAP"):
        ServingSystem(args)


@pytest.mark.parametrize("argv,impl,dtype,nprobe,lowrank", [
    (["--impl", "ivf"], "ivf", torch.float32, None, False),
    (["--impl", "hybrid"], "hybrid", torch.float32, None, False),
    (["--impl", "lowrank"], "lowrank", torch.float32, None, True),
    (["--dtype", "int4"], "auto", torch.int8, None, False),
    (["--impl", "ivf", "--nprobe", "4"], "ivf", torch.float32, 4, False),
    (["--impl", "lowrank", "--rank", "32"], "lowrank", torch.float32, None,
     True),
])
def test_approximate_mode_flags_reach_the_engine(argv, impl, dtype, nprobe,
                                                 lowrank):
    """Each value of the approximate modes is accepted and the engine the
    system builds carries it: the layouts exist and a search answers."""
    base = ["--dataset", "medrag", "--simulate", "--disable-llm",
            "--device", "cpu", "--ivf-clusters", "8"]
    if "--dtype" not in argv:
        base += ["--dtype", "float32"]
    args = parse_args(base + argv)
    check_ported(args)
    server = ServingSystem(args).build()
    engine = server.engine
    shards = engine.shard_set.shards
    assert engine.impl == impl and engine.nprobe == nprobe
    assert all(s.docs.dtype == dtype for s in shards)
    assert all((s.ivf is not None) == (impl in ("ivf", "hybrid"))
               for s in shards)
    assert engine.shard_set.lowrank_built == lowrank
    if "--rank" in argv:
        assert all(s.lr.rank == 32 for s in shards)
    if "int4" in argv:
        assert all(s.packed4 for s in shards)
    world = engine.world
    embs = {e: server.provider.embed("what is a test?", "")[e][None]
            for e in world.encoders}
    out = engine.search(embs, strategy="all")
    assert out.merged_valid[0] == world.k


def test_slice_flags_pass_and_cuda_request_without_cuda_raises():
    args = parse_args(["--dataset", "medrag", "--routing", "ragroute",
                       "--disable-llm", "--dtype", "int8", "--impl", "pallas",
                       "--device", "cpu", "--port", "0"])
    system = ServingSystem(args)
    assert system.device.type == "cpu" and system.port == 0
    assert not torch.backends.cuda.matmul.allow_tf32
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the CUDA request succeeds")
    with pytest.raises(RuntimeError, match="cuda"):
        ServingSystem(parse_args(["--dataset", "medrag"]))


def test_simulate_builds_and_searches_on_cpu():
    system = ServingSystem(parse_args(
        ["--dataset", "wikipedia", "--simulate", "--disable-llm",
         "--device", "cpu", "--dtype", "float32"]))
    server = system.build()
    world = server.engine.world
    embs = {e: server.provider.embed("what is a test?", "")[e][None]
            for e in world.encoders}
    out = server.engine.search(embs, strategy=server.strategy)
    assert server.strategy == "all" and out.mask.all()
    assert out.merged_valid[0] == world.k
