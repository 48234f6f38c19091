"""NUMA topology model.

Mirrors the paper's testbed (Section 4.1): an 8-socket Intel Xeon E7-8890 v3
machine, 18 cores x 2 hyperthreads per socket, 1 TB DDR4 per socket.  The
topology is parametric so the same simulator drives 4-socket experiments
(webserver / memcached case studies) and the TPU-pod analogue (pods as nodes).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple


@dataclasses.dataclass(frozen=True)
class NumaTopology:
    """A set of NUMA nodes, each with a number of hardware threads."""

    n_nodes: int = 8
    cores_per_node: int = 18
    threads_per_core: int = 2  # hyperthreading enabled on the testbed

    @property
    def hw_threads_per_node(self) -> int:
        return self.cores_per_node * self.threads_per_core

    @property
    def total_hw_threads(self) -> int:
        return self.n_nodes * self.hw_threads_per_node

    def node_of_cpu(self, cpu: int) -> int:
        return cpu // self.hw_threads_per_node

    def cpus_of_node(self, node: int) -> range:
        base = node * self.hw_threads_per_node
        return range(base, base + self.hw_threads_per_node)

    def hops(self, a: int, b: int) -> int:
        """NUMA hop distance between two nodes: 0 on-node, otherwise the
        socket-ring distance capped at 2 (the paper's 8-socket QPI glueless
        topology reaches any socket within two hops; smaller topologies
        degenerate to 0/1 naturally).  Callers pass valid node ids — this
        sits on the per-shootdown hot path, so it does not re-validate."""
        if a == b:
            return 0
        d = a - b if a > b else b - a
        ring = self.n_nodes - d
        if ring < d:
            d = ring
        return 2 if d > 2 else d

    def all_cpus(self) -> range:
        return range(self.total_hw_threads)

    def validate_cpu(self, cpu: int) -> None:
        if not 0 <= cpu < self.total_hw_threads:
            raise ValueError(f"cpu {cpu} out of range [0, {self.total_hw_threads})")

    def validate_node(self, node: int) -> None:
        if not 0 <= node < self.n_nodes:
            raise ValueError(f"node {node} out of range [0, {self.n_nodes})")

    def iter_nodes(self) -> Iterator[int]:
        return iter(range(self.n_nodes))


#: The paper's 8-socket evaluation machine.
PAPER_8SOCKET = NumaTopology(n_nodes=8, cores_per_node=18, threads_per_core=2)

#: 4-socket configuration used for the webserver/memcached case studies.
PAPER_4SOCKET = NumaTopology(n_nodes=4, cores_per_node=18, threads_per_core=2)

#: TPU-pod analogue: each "node" is a pod; "hw threads" are devices.
TPU_2POD = NumaTopology(n_nodes=2, cores_per_node=256, threads_per_core=1)


def socket_pair(topology: NumaTopology, local: int = 0) -> Tuple[int, int]:
    """Return (local, remote) node ids for two-node experiments."""
    topology.validate_node(local)
    remote = (local + 1) % topology.n_nodes
    return local, remote
