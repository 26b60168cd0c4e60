"""The port imports no jax and nothing of the JAX package, and its CLI
refuses what it does not serve.

``ragroute_tpu_torch`` must run on a machine without jax: a fresh
interpreter imports its entry points and no ``jax``, ``jaxlib`` or ``flax``
module, no ``transformers`` or ``sklearn`` (the card's machine has
neither), and no module of ``ragroute_tpu``, may be loaded; no source file of
the port names the JAX package in an import. Every value of the JAX CLI
reaches the port's system, and the combinations the JAX package refuses are
refused with its messages; the values of the approximate modes are
accepted and reach the engine.
"""

import glob
import os
import re
import subprocess
import sys

import pytest
import torch
from threadpoolctl import threadpool_limits

from ragroute_tpu_torch.main import parse_args
from ragroute_tpu_torch.system import ServingSystem, check_args

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread():
    """One thread for torch and for numpy's BLAS: the suite's workers share
    the cores, and oversubscribed ``eigh`` / matmul calls crawl."""
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield


def test_entry_points_import_no_jax():
    code = (
        "import sys\n"
        "import ragroute_tpu_torch.main, ragroute_tpu_torch.system\n"
        "import ragroute_tpu_torch.ops.kernel_checks\n"
        "import ragroute_tpu_torch.ops.grouped_topk\n"
        "import ragroute_tpu_torch.index.streamed\n"
        "import ragroute_tpu_torch.engine.streamed\n"
        "import ragroute_tpu_torch.measure\n"
        "import ragroute_tpu_torch.llm, ragroute_tpu_torch.llm.speculative\n"
        "import ragroute_tpu_torch.llm.shapes\n"
        "import ragroute_tpu_torch.ops.decoder_checks\n"
        "import ragroute_tpu_torch.index.synthetic\n"
        "import ragroute_tpu_torch.oracle, ragroute_tpu_torch.benchmark\n"
        "from ragroute_tpu_torch.engine.server import FederationServer\n"
        "import ragroute_tpu_torch.engine.native_frontend\n"
        "import ragroute_tpu_torch.encoders, ragroute_tpu_torch.encoders.zoo\n"
        "import ragroute_tpu_torch.encoders.published\n"
        "import ragroute_tpu_torch.pipeline, ragroute_tpu_torch.eval_metrics\n"
        "import ragroute_tpu_torch.train.train_router\n"
        "import ragroute_tpu_torch.router.torch_import\n"
        "import ragroute_tpu_torch.index.faiss_import\n"
        "import ragroute_tpu_torch.index.reference_layout\n"
        "import ragroute_tpu_torch.scripts.make_synthetic_data\n"
        "import ragroute_tpu_torch.scripts.train_router\n"
        "import ragroute_tpu_torch.scripts.eval_recall\n"
        "import ragroute_tpu_torch.scripts.import_real_data\n"
        "import ragroute_tpu_torch.scripts.profile_http\n"
        "import ragroute_tpu_torch.scripts.profile_captures\n"
        "import ragroute_tpu_torch.parallel, ragroute_tpu_torch.parallel.mesh\n"
        "import ragroute_tpu_torch.parallel.sharded\n"
        "import ragroute_tpu_torch.parallel.streamed_mesh\n"
        "import ragroute_tpu_torch.parallel.multihost\n"
        "import ragroute_tpu_torch.encoders.tokenize\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax',\n"
        "                                    'ml_dtypes', 'ragroute_tpu',\n"
        "                                    'transformers', 'sklearn')\n"
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
    assert any(os.sep + "encoders" + os.sep in f for f in files)
    for sub in ("train", "scripts", "parallel"):
        assert any(os.sep + sub + os.sep in f for f in files), sub
    pat = re.compile(r"(?:import|from)\s+ragroute_tpu(?!_torch)\b")
    # transformers only lazily (inside a function): never at module level
    top = re.compile(r"^(?:import|from)\s+transformers\b")
    bad = []
    for path in files:
        with open(path) as f:
            for n, line in enumerate(f, 1):
                if (pat.search(line) or top.search(line)
                        or "spec_from_file_location" in line):
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


@pytest.mark.parametrize("argv,refused", [
    (["--mesh", "2x4"], None),
    (["--impl", "stream", "--mesh", "1x2"], "SINGLE-chip capacity tier"),
    (["--impl", "hostrefine", "--mesh", "2x4"], None),
    (["--mutable", "--mesh", "2x4"], "--mutable is a single-chip"),
    (["--reserve-docs", "8", "--embedder", "zoo", "--dtype", "policy"],
     None),
    (["--embedder", "zoo", "--mesh", "2x4"], None),
    (["--llm-backend", "jax", "--mesh", "2x4"], None),
    (["--llm-quant", "int4", "--mesh", "1x2"], None),
    (["--llm-serving", "continuous", "--workers", "2", "--mesh", "1x2"],
     None),
    (["--frontend", "native", "--dtype", "policy"], None),
    (["--workers", "2", "--coordinator", "10.0.0.1:1234"], None),
    (["--dtype", "policy"], None),
    (["--coordinator", "10.0.0.1:1234"], None),
    (["--num-processes", "2"], "requires --coordinator"),
    (["--hbm-budget-gb", "4", "--impl", "hostrefine", "--mesh", "1x4"],
     None),
    (["--impl", "hostrefine", "--mesh", "2x4", "--num-processes", "2",
      "--coordinator", "10.0.0.1:1234"], "serves single-process"),
])
def test_unported_flag_values_fail_naming_roadmap(argv, refused):
    """No value of the JAX CLI is unported any more: every combination the
    JAX package serves reaches the port's system (its values on the
    system), and the ones it refuses are refused with its message, at the
    same place (``--num-processes`` without ``--coordinator`` in
    ``main``, the rest when the system is constructed)."""
    import main as jmain
    from ragroute_tpu.system import ServingSystem as JSystem
    from ragroute_tpu_torch import main as tmain

    args = parse_args(["--dataset", "medrag", "--device", "cpu", *argv])
    if refused == "requires --coordinator":
        errs = []
        for m in (tmain, jmain):
            with pytest.raises(SystemExit, match=refused) as e:
                m.main(["--dataset", "medrag", "--device", "cpu", *argv]
                       if m is tmain else ["--dataset", "medrag", *argv])
            errs.append(str(e.value))
        assert errs[0] == errs[1]
        return
    if refused:
        with pytest.raises(ValueError, match=refused) as ours:
            ServingSystem(args)
        with pytest.raises(ValueError) as theirs:
            JSystem(args)
        assert str(ours.value) == str(theirs.value)
        return
    check_args(args)
    system = ServingSystem(args)
    assert system.mesh_spec == args.mesh
    assert system.dtype_name == args.dtype
    assert system.num_processes == args.num_processes
    assert system.impl == args.impl
    JSystem(args)             # the JAX package accepts it too


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
    check_args(args)
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


@pytest.mark.parametrize("argv,tier,dtype,k_refine,nprobe", [
    (["--impl", "stream"], "stream", torch.int8, 128, None),
    (["--impl", "hostrefine"], "hostrefine", torch.int8, 128, None),
    (["--impl", "hostrefine", "--refine-mult", "2", "--nprobe", "3"],
     "hostrefine", torch.int8, 64, 3),
    (["--impl", "stream", "--dtype", "int4"], "stream", "int4", 128, None),
])
def test_host_tier_flags_reach_the_engine(argv, tier, dtype, k_refine, nprobe):
    """``--impl stream | hostrefine`` with ``--hbm-budget-gb`` build the
    host-RAM tiers: the engine carries the tier, the depth and the probe
    count, and a search answers."""
    from ragroute_tpu_torch.engine.streamed import StreamedSearchEngine

    base = ["--dataset", "medrag", "--simulate", "--disable-llm", "--device",
            "cpu", "--hbm-budget-gb", "1e-9"]
    if "--dtype" not in argv:
        base += ["--dtype", "int8"]
    args = parse_args(base + argv)
    check_args(args)
    server = ServingSystem(args).build()
    engine = server.engine
    assert isinstance(engine, StreamedSearchEngine)
    assert engine.tier == engine.shard_set.tier == tier
    assert engine.k_refine == k_refine and engine.nprobe == nprobe
    assert engine.shard_set.packed4 == (dtype == "int4")
    assert engine.supports_pipelined_dispatch == (tier == "hostrefine")
    # --simulate makes 512 docs a source, the least resident prefix, so
    # every source stays resident and exact whatever the budget
    assert all(s.host is None and s.n_res == 512
               for s in engine.shard_set.sources)
    assert engine.shard_set.index_bytes > 0
    world = engine.world
    embs = {e: server.provider.embed("what is a test?", "")[e][None]
            for e in world.encoders}
    out = engine.search(embs, strategy="all", fetch_candidates=False)
    assert out.merged_valid[0] == world.k


@pytest.mark.parametrize("argv,refused", [
    (["--mutable", "--reserve-docs", "600"], None),
    (["--frontend", "native"], None),
    (["--workers", "2"], None),
    (["--mutable", "--impl", "ivf"], "balanced-IVF layout"),
    (["--mutable", "--impl", "lowrank"], "low-rank coarse index"),
    (["--mutable", "--impl", "hostrefine"], "immutable host-tier"),
    (["--mutable", "--impl", "stream"], "immutable host-tier"),
])
def test_serving_surface_flags_reach_the_system(argv, refused):
    """``--mutable`` / ``--reserve-docs``, ``--frontend native`` and
    ``--workers`` are served; a live index is refused with the layouts and
    tiers an update would leave stale (the tiers at construction, the
    layouts by the shard build)."""
    args = parse_args(["--dataset", "medrag", "--simulate", "--disable-llm",
                       "--device", "cpu", "--dtype", "float32", *argv])
    if refused:
        with pytest.raises(ValueError, match=refused):
            ServingSystem(args).build()
        return
    check_args(args)
    system = ServingSystem(args)
    assert system.frontend == args.frontend
    server = system.build()
    ss = server.engine.shard_set
    assert ss.mutable == server.mutable == args.mutable
    if args.mutable:
        assert [s.capacity for s in ss.shards] == [1536] * 4
        assert server.engine._n_docs == (1536,) * 4
        assert type(server.doc_store).__name__ == "OverlayDocStore"


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


@pytest.mark.parametrize("argv,want", [
    ([], dict(cls="GenerationService", max_new_tokens=32,
              cache_dtype=torch.float32, temperature=0.0, top_k=0,
              top_p=1.0)),
    (["--llm-kv-quant", "int8", "--llm-temperature", "0.7", "--llm-top-k",
      "5", "--llm-top-p", "0.9", "--llm-max-new", "8"],
     dict(cls="GenerationService", max_new_tokens=8, cache_dtype="int8",
          temperature=0.7, top_k=5, top_p=0.9)),
    (["--llm-checkpoint", "CKPT", "--llm-quant", "int4", "--llm-max-new",
      "100"], dict(cls="GenerationService", max_new_tokens=100,
                   quantize="int4")),
    (["--llm-checkpoint", "CKPT", "--llm-quant", "int8"],
     dict(cls="GenerationService", max_new_tokens=256, quantize="int8")),
    (["--llm-serving", "continuous", "--llm-prefix-cache",
      "--llm-spec-window", "4", "--llm-kv-quant", "int8"],
     dict(cls="ContinuousGenerationService", max_new_tokens=32,
          spec_window=4, cache_dtype="int8", cache_len=512 + 32 + 4 + 8)),
    (["--llm-serving", "continuous"],
     dict(cls="ContinuousGenerationService", spec_window=0,
          prefix_ids=None, cache_len=512 + 32 + 1 + 8)),
])
def test_llm_flags_reach_the_generation_service(monkeypatch, argv, want):
    """``--llm-backend jax`` builds the port's generation service and every
    ``--llm-*`` flag reaches it (the checkpoint loader is recorded, not
    run: its own test loads a tiny checkpoint)."""
    from ragroute_tpu_torch.llm import service as ts

    seen = {}

    def from_checkpoint(path, quantize=None, device="cpu", **kw):
        seen.update(path=path, quantize=quantize, device=device)
        return ts.demo_service(device=device, **kw)

    monkeypatch.setattr(ts.GenerationService, "from_checkpoint",
                        staticmethod(from_checkpoint))
    args = parse_args(["--dataset", "medrag", "--device", "cpu",
                       "--llm-backend", "jax", *argv])
    check_args(args)
    system = ServingSystem(args)
    svc = system._generation_service()
    want = dict(want)
    assert type(svc).__name__ == want.pop("cls")
    if "quantize" in want:
        assert seen == {"path": "CKPT", "quantize": want.pop("quantize"),
                        "device": torch.device("cpu")}
    for name, value in want.items():
        assert getattr(svc, name) == value, name
    assert svc.device == torch.device("cpu")
    if "--llm-prefix-cache" in argv:
        # the rendered head every medrag prompt shares: a real prompt
        # extends it
        from ragroute_tpu_torch.llm.service import _render_prompt

        n = len(svc.prefix_ids)
        real = svc.tokenizer.encode(_render_prompt(
            svc.tokenizer, system._probe_llm_messages("why so?", True)))
        assert n > 100 and real[:n] == svc.prefix_ids


def test_llm_refusals_name_their_roadmap_item():
    """Generation beside a mesh is served as in the JAX package (its
    decoder on one device: the tensor-parallel decoder of
    ``llm/sharding.py`` is wired to no engine there either); a degenerate
    sampling value is refused."""
    args = parse_args(["--dataset", "medrag", "--device", "cpu",
                       "--llm-backend", "jax", "--mesh", "2x4"])
    check_args(args)
    system = ServingSystem(args)
    assert system.llm_backend == "jax" and system.mesh_spec == "2x4"
    args = parse_args(["--dataset", "medrag", "--device", "cpu",
                       "--llm-backend", "jax", "--llm-top-p", "0"])
    with pytest.raises(ValueError, match="top_p"):
        ServingSystem(args)._generation_service()
