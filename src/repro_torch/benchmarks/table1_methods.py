"""Table 1 (methods comparison): CDSGD vs gossip SGD vs time-varying CDSGD.

The paper's Table 1 contrasts CDSGD with gossip SGD [7] (decentralized but
*unconstrained* random pairwise communication).  This benchmark runs both,
plus the time-varying-topology extension (paper future work §6.ii:
alternating row/column line graphs on a 2x4 grid whose union is
connected), on the synthetic classification task.  Gossip SGD draws its
partners from a torch generator, not JAX's stream, so its row differs
from the JAX package's in its digits.
"""

import numpy as np

from repro_torch.benchmarks.common import emit, run_experiment
from repro_torch.core.topology import Topology, metropolis_pi


def _grid_line_topologies(rows=2, cols=4):
    n = rows * cols

    def adj(edges):
        a = np.zeros((n, n))
        for i, j in edges:
            a[i, j] = a[j, i] = 1.0
        return a

    row_edges = [(r * cols + c, r * cols + c + 1)
                 for r in range(rows) for c in range(cols - 1)]
    col_edges = [(r * cols + c, (r + 1) * cols + c)
                 for r in range(rows - 1) for c in range(cols)]
    return (Topology("grid_rows", metropolis_pi(adj(row_edges))),
            Topology("grid_cols", metropolis_pi(adj(col_edges))))


def run(steps: int = 150, agents: int = 8, *, device=None):
    rows = [
        run_experiment("table1m/cdsgd_ring", "cdsgd", steps=steps,
                       agents=agents, topology="ring", device=device),
        run_experiment("table1m/gossip", "gossip", steps=steps, agents=agents,
                       n_agents=agents, device=device),
        run_experiment("table1m/cdsgd_timevarying", "cdsgd_tv", steps=steps,
                       agents=agents, topologies=_grid_line_topologies(),
                       device=device),
    ]
    emit(rows)
    return rows


if __name__ == "__main__":
    run()
