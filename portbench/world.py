"""The benchmark's world, made on the card from seeds.

A world is what a configuration file names under ``world`` and ``docs``: federated
sources of ``[n, d]`` document embeddings with per-source cluster structure,
the per-source centroids the router reads, the router's weights, and a pool
of queries. The construction follows the synthetic medrag world of the port
(``index/synthetic.py``): each encoder gets a random projection from a
shared latent space, each source a latent centre, a document is a noisy
sample of its source's centre (plus one of ``topics`` shared topic offsets
where the world is topical), and a query mixes the centres of the sources
relevant to it: as ``index/synthetic.py`` draws them, a uniform number of
sources in the configuration's ``sources_per_query`` range, chosen
uniformly.

Nothing here imports the program. The corpus, the router and the relevance
sets of the query pool, position by position, come from the configuration's
own seeds, so every run of a cell serves the same deployment and the same
number of queries relevant to each source in each batch; the run's
``--seed`` orders the queries within each batch and draws their topics and
noise. Rows are made in blocks of :data:`BLOCK`, each from a generator of
its own, so the plain reference can make any source again block by block
after the window.
"""

from __future__ import annotations

import contextlib
import hashlib
import math
from typing import Dict, List

import numpy as np
import torch

BLOCK = 1 << 17


def seed_of(*parts) -> int:
    """A 63-bit seed from any parts (the run's seed may pass 32 bits)."""
    digest = hashlib.sha256(repr(parts).encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


@contextlib.contextmanager
def full_f32():
    """f32 products without TF32, whatever the process set: the reference
    makes the same rows again and must get the same bits."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def generator(device, *parts) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed_of(*parts))


class World:
    """The seeded world of one configuration on one device."""

    def __init__(self, cfg: dict, device):
        w = cfg["world"]
        self.cfg = w
        self.device = torch.device(device)
        self.sources: List[dict] = w["sources"]
        self.docs = [cfg["docs"][src["name"]] for src in self.sources]
        self.latent = w["latent_dim"]
        self.noise = w["noise"]
        self.topics = w["topics"]
        self.k = w["k"]
        g = generator(self.device, w["seed"], "basis")
        self.proj = {
            enc["name"]: torch.randn((self.latent, enc["dim"]), generator=g,
                                     device=self.device) / math.sqrt(self.latent)
            for enc in w["encoders"]}
        self.centers = 2.0 * torch.randn((len(self.sources), self.latent),
                                         generator=g, device=self.device)
        self.topic_offsets = None
        if self.topics > 1:
            self.topic_offsets = (0.9 * self.noise) * torch.randn(
                (self.topics, self.latent), generator=g, device=self.device)

    def encoder_of(self, si: int) -> str:
        return self.sources[si]["encoder"]

    def block(self, si: int, b: int) -> torch.Tensor:
        """Rows ``[b * BLOCK, (b + 1) * BLOCK)`` of source ``si``, cut at
        its doc count: ``[rows, d]`` f32 on the device."""
        n = self.docs[si]
        rows = min(BLOCK, n - b * BLOCK)
        g = generator(self.device, self.cfg["seed"], "rows", si, b)
        z = self.noise * torch.randn((BLOCK, self.latent), generator=g,
                                     device=self.device)
        if self.topic_offsets is not None:
            which = torch.randint(0, self.topics, (BLOCK,), generator=g,
                                  device=self.device)
            z = 0.436 * z + self.topic_offsets[which]
        z = z[:rows] + self.centers[si]
        with full_f32():
            return z @ self.proj[self.encoder_of(si)]

    def n_blocks(self, si: int) -> int:
        return -(-self.docs[si] // BLOCK)

    def rows(self, si: int) -> torch.Tensor:
        """All rows of source ``si``, ``[n, d]`` f32 on the device."""
        return torch.cat([self.block(si, b) for b in range(self.n_blocks(si))])

    def host_corpus(self):
        """Every source's rows on the host (the program's build takes numpy
        rows), and the centroids as :meth:`centroids` gives them."""
        rows = {}
        cents = self._padded()
        for si, src in enumerate(self.sources):
            x = self.rows(si)
            cents[si, :x.shape[1]] = _mean(x)
            rows[src["name"]] = x.cpu().numpy()
            del x
        return rows, cents

    def centroids(self) -> torch.Tensor:
        """``[N, d_max]`` f32 centroids on the device: each source's mean
        row, summed in f64, zero-padded to the widest encoder."""
        cents = self._padded()
        for si in range(len(self.sources)):
            x = self.rows(si)
            cents[si, :x.shape[1]] = _mean(x)
        return cents

    def _padded(self) -> torch.Tensor:
        d_max = max(e["dim"] for e in self.cfg["encoders"])
        return torch.zeros((len(self.sources), d_max), device=self.device)

    def router_state(self, centroids: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The router's weights (the port's ``CorpusRouter`` layout), made
        on the device. The hidden layers are drawn from the router's seed
        (uniform in +-1/sqrt(fan_in), LayerNorm scales one and shifts
        zero); the output layer is fitted to the world's own relevance, a
        ridge regression of logits +-``fit_logit`` on the last hidden
        layer over ``fit_queries`` queries from the same seed, so that the
        router sends a query to the sources it mixes, as a trained router
        does, and not to all or none. The fit is solved in f64 on the host."""
        from portbench import router

        r = self.cfg["router"]
        g = generator(self.device, r["seed"], "router")
        dims = [r["input_dim"], *r["hidden"]]
        state = {}
        for i, (fan_in, fan_out) in enumerate(zip(dims[:-1], dims[1:])):
            bound = 1.0 / math.sqrt(fan_in)
            w = torch.rand((fan_out, fan_in + 1), generator=g,
                           device=self.device) * (2 * bound) - bound
            state[f"fc{i + 1}.weight"] = w[:, :fan_in].contiguous()
            state[f"fc{i + 1}.bias"] = w[:, fan_in].contiguous()
            state[f"ln{i + 1}.weight"] = torch.ones(fan_out, device=self.device)
            state[f"ln{i + 1}.bias"] = torch.zeros(fan_out, device=self.device)
        n_fit = r["fit_queries"]
        embs, rel = self._queries(
            generator(self.device, r["seed"], "router", "relevance"),
            generator(self.device, r["seed"], "router", "queries"), n_fit)
        with full_f32():
            x = router.features(r, [embs[s["encoder"]] for s in self.sources],
                                centroids)
            h = router.hidden(r, state, x).reshape(-1, dims[-1])
        a = np.concatenate([h.double().cpu().numpy(),
                            np.ones((h.shape[0], 1))], axis=1)
        y = np.where(rel.reshape(-1).cpu().numpy(), 1.0, -1.0) * r["fit_logit"]
        gram = a.T @ a
        gram += r["fit_ridge"] * np.trace(gram) / gram.shape[0] * np.eye(
            gram.shape[0])
        coef = np.linalg.solve(gram, a.T @ y)
        last = len(dims)
        state[f"fc{last}.weight"] = torch.tensor(
            coef[None, :-1], dtype=torch.float32, device=self.device)
        state[f"fc{last}.bias"] = torch.tensor(
            coef[-1:], dtype=torch.float32, device=self.device)
        return state

    def queries(self, seed: int, count: int, batch: int
                ) -> Dict[str, torch.Tensor]:
        """A pool of ``count`` queries, in batches of ``batch``: each
        position's relevance set from the configuration's seed, the order
        within each batch, the topics (where the world is topical) and the
        noise from the run's ``seed``: ``{encoder: [count, d] f32}`` on the
        device."""
        return self.pool(seed, count, batch)[0]

    def pool(self, seed: int, count: int, batch: int):
        """:meth:`queries` and their ``[count, N]`` relevance."""
        g = generator(self.device, "queries", seed)
        order = torch.argsort(torch.rand((count // batch, batch), generator=g,
                                         device=self.device), dim=1)
        order = (order + batch * torch.arange(
            count // batch, device=self.device)[:, None]).reshape(-1)
        return self._queries(
            generator(self.device, self.cfg["seed"], "relevance", count,
                      batch), g, count, order)

    def relevance(self, g: torch.Generator, count: int) -> torch.Tensor:
        """``[count, N]`` relevance sets as ``index/synthetic.py`` draws
        them: a number of sources uniform in ``sources_per_query`` (at most
        N), the sources chosen uniformly without replacement."""
        lo, hi = self.cfg["relevance"]["sources_per_query"]
        n = len(self.sources)
        many = torch.randint(lo, min(hi, n) + 1, (count, 1), generator=g,
                             device=self.device)
        perm = torch.argsort(torch.rand((count, n), generator=g,
                                        device=self.device), dim=1)
        return perm < many

    def _queries(self, g_rel: torch.Generator, g: torch.Generator,
                 count: int, order: torch.Tensor = None):
        """Queries and their ``[count, N]`` relevance: the sets from
        ``g_rel`` (rearranged by ``order``), the rest from ``g``; a query
        mixes the centres of its relevant sources."""
        rel = self.relevance(g_rel, count)
        if order is not None:
            rel = rel[order]
        mix = (rel.float() @ self.centers) / rel.sum(dim=1, keepdim=True)
        if self.topic_offsets is not None:
            mix = mix + self.topic_offsets[torch.randint(
                0, self.topics, (count,), generator=g, device=self.device)]
        lat = mix + (0.5 * self.noise) * torch.randn(
            (count, self.latent), generator=g, device=self.device)
        with full_f32():
            return {name: lat @ p for name, p in self.proj.items()}, rel


def _mean(x: torch.Tensor) -> torch.Tensor:
    return (x.double().sum(0) / x.shape[0]).float()


def sample_rows(seed: int, pool: int, count: int) -> np.ndarray:
    """The pool rows whose answers are checked, drawn from the run's seed."""
    rng = np.random.default_rng(seed_of(seed, "check") % (1 << 32))
    return np.sort(rng.choice(pool, size=min(count, pool), replace=False))
