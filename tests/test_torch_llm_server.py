"""The slice as a whole: ``--llm-backend jax`` served by both packages.

One small medrag world is written to disk with a router checkpoint; the JAX
package's ``ServingSystem`` and the port's are built from the same command
line with ``--llm-backend jax`` and no checkpoint, so each serves its demo
decoder. The port's demo weights are the JAX package's, carried across with
``params_from_jax``. The same ``/query`` requests go to both over localhost
and the responses must be the same bytes, generated answers included, apart
from the random query id and the timing fields: through the lockstep
service, the continuous one with a speculative window, and the continuous
one with the shared-prefix KV too (against the JAX server run with the same
flags, since its prompts keep the prefix plus the tail of the suffix).
"""

import asyncio
import json

import aiohttp
import jax
import pytest
import torch
from threadpoolctl import threadpool_limits

import main as reference_main
from ragroute_tpu.index.synthetic import make_synthetic_world, save_world
from ragroute_tpu.llm import model as jm
from ragroute_tpu.llm.service import DEMO_CFG
from ragroute_tpu.router.mlp import init_router_params
from ragroute_tpu.router.torch_import import save_router_npz
from ragroute_tpu.system import ServingSystem as JSystem
from ragroute_tpu_torch.llm import model as tm
from ragroute_tpu_torch.main import parse_args
from ragroute_tpu_torch.system import ServingSystem

TIMING = ("embedding_time", "selection_time", "doc_select_time", "e2e_time",
          "generate_time")
N_QUERIES = 3


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("data"))
    syn = make_synthetic_world("medrag", docs_per_source=300, num_queries=6,
                               seed=2)
    save_world(syn, root)
    save_router_npz(f"{root}/medrag/router.npz",
                    init_router_params(jax.random.key(3),
                                       syn.world.router_input_dim))
    return root, syn


def _free_port() -> int:
    """A port the OS just gave out: the JAX package's system reads port 0
    as its default 8000, which other test files bind too."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _argv(root, *extra):
    return ["--dataset", "medrag", "--routing", "ragroute", "--llm-backend",
            "jax", "--llm-max-new", "16", "--data-root", root, "--port",
            str(_free_port()), "--dtype", "float32", *extra]


def _normalize(text: str) -> str:
    body = json.loads(text)
    body["query_id"] = ""
    md = body["metadata"]
    for f in TIMING:
        assert isinstance(md[f], float), f
        md[f] = 0.0
    md["data_sources_stats"] = {n: dict(s, duration=0.0)
                                for n, s in md["data_sources_stats"].items()}
    return json.dumps(body)


async def _serve(system, syn):
    await system.start()
    out = []
    try:
        async with aiohttp.ClientSession() as s:
            base = f"http://127.0.0.1:{system.server.bound_port}"
            for q in syn.questions[:N_QUERIES]:
                params = {"q": q["question"], "qid": q["qid"],
                          "choices": json.dumps(q["options"])}
                async with s.get(base + "/query", params=params) as r:
                    assert r.status == 200, await r.text()
                    out.append(_normalize(await r.text()))
            async with s.get(base + "/stats") as r:
                stats = await r.json()
    finally:
        await system.stop()
        await system.server.llm.service.stop()
    return out, stats


@pytest.fixture(scope="module")
def jax_answers(world):
    """The JAX server's normalized responses for a flag set (one run each)."""
    root, syn = world
    seen = {}

    def get(extra):
        key = tuple(extra)
        if key not in seen:
            args = reference_main.parse_args(_argv(root, *extra))
            args.buckets = (8,)
            out, _ = asyncio.run(_serve(JSystem(args), syn))
            assert all(json.loads(o)["answer"] for o in out)
            seen[key] = out
        return seen[key]

    return get


@pytest.mark.parametrize("extra,jax_extra", [
    ([], []),
    (["--llm-serving", "continuous", "--llm-spec-window", "4"], []),
    (["--llm-serving", "continuous", "--llm-prefix-cache",
      "--llm-spec-window", "4"], None),
])
def test_port_server_answers_the_jax_servers_bytes(world, jax_answers,
                                                   monkeypatch, extra,
                                                   jax_extra):
    """Lockstep and continuous (speculative) answer the JAX lockstep
    server's bytes; with the shared-prefix KV, whose prompts keep the
    prefix plus the suffix's tail (the prompts here outgrow the largest
    bucket), they answer the JAX server run with the same flags."""
    root, syn = world
    from ragroute_tpu_torch.llm import service as ts

    demo = tm.params_from_jax(jm.init_decoder_params(jax.random.key(0),
                                                     DEMO_CFG))
    monkeypatch.setattr(ts, "init_decoder_params",
                        lambda seed, cfg, device="cpu": demo.to(device))
    args = parse_args(_argv(root, "--device", "cpu", *extra))
    args.buckets = (8,)
    system = ServingSystem(args)
    out, stats = asyncio.run(_serve(system, syn))
    assert out == jax_answers(extra if jax_extra is None else jax_extra)
    llm = stats["llm"]
    assert llm["generated_tokens"] > 0
    if extra:
        assert llm["admissions"] == N_QUERIES and llm["chunks"] > 0
        assert llm["spec_mean_emit"] >= 1.0
        assert bool(system.server.llm.service.prefix_ids) == (
            "--llm-prefix-cache" in extra)
    else:
        assert llm["batches"] == N_QUERIES
