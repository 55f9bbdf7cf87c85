"""SpGEMM applications on one engine of the port: multi-source BFS and
A·A powers, on the card by default.

The paper motivates SpGEMM with graph workloads (multi-source BFS, Markov
clustering).  Frontier expansion for many sources at once is a sparse-
sparse product: adjacency (N x N) @ frontier (N x S); Markov clustering's
expansion step is the chained square A·A.  Both are streams of products
over one adjacency matrix, which the engine's plan cache amortizes: the
adjacency's signature repeats every hop, so after the first hop the plans
come from the cache.  The adjacency is the reference example's
(``PRNGKey(0)``).

Run:  PYTHONPATH=src python examples/torch/graph_analytics.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.core import CSR, SpgemmConfig, random_csr
from repro_torch.core.csr import prng_key_seed
from repro_torch.engine import SpgemmEngine

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default="cuda")
device = ap.parse_args().device

N, SOURCES, HOPS = 3000, 32, 4
adj = random_csr(prng_key_seed(0), N, N, avg_nnz_per_row=6.0,
                 distribution="powerlaw", device=device)

engine = SpgemmEngine(SpgemmConfig(method="esc"))

# ---- multi-source BFS: adjacency @ frontier, chained over hops -----------
# Frontiers grow hop over hop; padding them to ONE storage bucket keeps
# every hop on the same plan signature, so the engine reuses one cached
# plan across hops.
FRONTIER_BUCKET = 8192
PLAN_BUCKETS = 32768      # final-hop-sized product/nnz capacity bound


def pad_frontier(f: CSR) -> CSR:
    # with_capacity truncates past the bucket: fail loudly instead (a
    # bigger BFS needs a bigger bucket, not a wrong answer).
    assert int(f.nnz()) <= FRONTIER_BUCKET, (int(f.nnz()), FRONTIER_BUCKET)
    return f.with_capacity(FRONTIER_BUCKET)


rng = np.random.default_rng(0)
srcs = rng.choice(N, SOURCES, replace=False)
dense_f = np.zeros((N, SOURCES), np.float32)
dense_f[srcs, np.arange(SOURCES)] = 1.0
frontier = pad_frontier(CSR.from_dense(dense_f, device=device))

# Ahead-of-time specialization: BFS product sizes grow toward the last
# hop, so the plan takes end-of-BFS-sized buckets up front and every hop,
# the first included, runs the steady state with no regrow.
engine.prewarm(adj, frontier, prod_bucket=PLAN_BUCKETS,
               nnz_bucket=PLAN_BUCKETS)

visited = dense_f > 0
for hop in range(HOPS):
    res = engine.execute(adj, frontier)
    reached = res.C.to_dense().cpu().numpy() > 0
    new = reached & ~visited
    visited |= reached
    frontier = pad_frontier(CSR.from_dense(new.astype(np.float32),
                                           device=device))
    print(f"hop {hop + 1}: frontier nnz={int(frontier.nnz())}, "
          f"visited={int(visited.sum())}/{N * SOURCES} pairs, "
          f"CR={res.compression_ratio:.2f}")

print("multi-source BFS done:", int(visited.any(axis=1).sum()),
      "nodes reached from", SOURCES, "sources")

# ---- chained A·A iteration (Markov-clustering expansion step) ------------
# Each squaring reuses the same adjacency signature on the left, and the
# submit/drain path pipelines the stream through the plan cache (drain
# finalizes in completion order: mixed-size hops do not block each other).
P = adj
for it in range(2):
    uid = engine.submit(adj, P)
    P = engine.drain()[uid].C
    print(f"A^{it + 2}: nnz={int(P.nnz())}")

print()
print(engine.report())

# ---- partition-aware engine: a row-block sharded BFS hop -----------------
# shards=2 splits the adjacency into two flop-balanced row blocks; each
# shard runs an ordinary (cached) SpGEMM and the merged frontier product
# has the same structure.
sharded = SpgemmEngine(SpgemmConfig(method="esc"), shards=2)
cold = sharded.execute(adj, frontier)
hot = sharded.execute(adj, frontier)       # per-shard plans from the cache
assert hot.total_nnz == cold.total_nnz
spec = next(e.plan.shard_spec for _, e in sharded.cache.items()
            if e.plan.shard_spec is not None)
print(f"\nsharded hop: nnz={hot.total_nnz}, row blocks "
      f"{'/'.join(str(b) for b in spec.bounds)} "
      f"({len(sharded.cache)} plans cached)")
