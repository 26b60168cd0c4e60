"""The port's counterpart of ``__graft_entry__.py`` (``ragroute_tpu_torch.
dryrun``), on the CPU.

``dryrun_multichip(8, device="cpu")`` runs over a 2x4 mesh of the CPU named
eight times and passes its own checks (every router dp-trained with a loss
drop, fan-out and non-empty merges on five worlds, the hostrefine,
low-rank and IVF paths over the mesh, one ``/query`` over HTTP, TP
generation equal to one device's and the continuous service's answer);
``entry()``'s forward returns a ``[B, N]`` mask; the command line runs
both over another mesh shape. The JAX package's own dry run is held by
``tests/test_bench_smoke.py``.
"""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from ragroute_tpu_torch import dryrun


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield


def test_dryrun_multichip_over_2x4_passes_its_checks(capsys):
    out = dryrun.dryrun_multichip(8, device="cpu")
    assert out["mesh"] == {"dp": 2, "idx": 4}
    assert set(out["worlds"]) == {
        "medrag/bf16", "medrag/int8", "medrag/int4", "feb4rag/bf16",
        "wikipedia/bf16", "medrag/hostrefine-mesh", "medrag/lowrank",
        "medrag/ivf"}
    for tag, (l0, l1) in out["losses"].items():
        assert l1 < l0, tag
    assert out["served_query"]["n_top_docs"] > 0
    assert len(out["llm_tp_tokens"]) == 4
    assert out["llm_tp_continuous_prefix_chars"] > 0
    assert "dryrun_multichip ok: mesh={'dp': 2, 'idx': 4}" in (
        capsys.readouterr().out)


def test_entry_returns_a_routing_mask_of_batch_by_sources():
    fn, args = dryrun.entry(device="cpu")
    out = fn(*args)
    probs, mask = out[0], out[1]
    assert tuple(mask.shape) == (64, 4) and mask.dtype == torch.bool
    assert tuple(probs.shape) == (64, 4)
    assert np.isfinite(probs.numpy()).all()


def test_command_line_runs_entry_and_a_1x2_dry_run(capsys):
    assert dryrun.main(["2", "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    assert "entry ok: mask (64, 4)" in text
    assert "dryrun_multichip ok: mesh={'dp': 2, 'idx': 1}" in text
