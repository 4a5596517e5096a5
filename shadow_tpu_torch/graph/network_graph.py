"""Network topology: nodes with access-link bandwidths, edges with
latency / jitter / packet_loss.

Mirrors the reference's graph semantics (reference:
src/main/network/graph/mod.rs:24-134): GML nodes carry optional
`host_bandwidth_up`/`host_bandwidth_down`; edges require `latency` (> 0) and
accept `jitter` (parsed but unused in routing, as in the reference) and
`packet_loss` in [0,1]. Graphs may be directed or undirected; self-loop
edges define a node's path to itself (graph/mod.rs:212-219).

The adjacency is materialized as dense numpy matrices (latency ns i64,
reliability f32) ready to feed the on-device routing solve.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from shadow_tpu_torch.graph.gml import GmlGraph, parse_gml
from shadow_tpu_torch.simtime import TIME_MAX, parse_time_ns
from shadow_tpu_torch.units import parse_bandwidth_bits_per_sec

# reference: src/main/core/support/configuration.rs:1314-1327
ONE_GBIT_SWITCH_GML = """graph [
  directed 0
  node [
    id 0
    host_bandwidth_up "1 Gbit"
    host_bandwidth_down "1 Gbit"
  ]
  edge [
    source 0
    target 0
    latency "1 ms"
    packet_loss 0.0
  ]
]
"""


@dataclasses.dataclass
class NetworkGraph:
    num_nodes: int
    node_ids: list  # dense index -> original GML id
    id_to_index: dict  # original GML id -> dense index
    bw_up_bits: np.ndarray  # [N] i64 bits/sec, -1 if unspecified
    bw_down_bits: np.ndarray  # [N] i64 bits/sec, -1 if unspecified
    lat_ns: np.ndarray  # [N, N] i64; TIME_MAX where no direct edge
    rel: np.ndarray  # [N, N] f32 reliability (1 - packet_loss); 0 where no edge
    jitter_ns: np.ndarray  # [N, N] i64; 0 where no edge (parsed, unused in routing)
    directed: bool

    @classmethod
    def from_gml(cls, text: str) -> "NetworkGraph":
        return cls.from_parsed(parse_gml(text))

    @classmethod
    def from_file(cls, path) -> "NetworkGraph":
        """Load a GML topology file, transparently decompressing
        .gz/.xz/.bz2 (the reference accepts compressed graphs — its
        compressed-graph suite, src/test/compressed-graph/; xz there)."""
        import pathlib

        p = pathlib.Path(path)
        suffix = p.suffix.lower()
        if suffix == ".gz":
            import gzip

            data = gzip.open(p, "rb").read()
        elif suffix == ".xz":
            import lzma

            data = lzma.open(p, "rb").read()
        elif suffix == ".bz2":
            import bz2

            data = bz2.open(p, "rb").read()
        else:
            data = p.read_bytes()
        return cls.from_gml(data.decode())

    @classmethod
    def one_gbit_switch(cls) -> "NetworkGraph":
        return cls.from_gml(ONE_GBIT_SWITCH_GML)

    # one-time (per process) warning that nonzero edge jitter is parsed
    # but not applied — reference parity (graph/mod.rs parses jitter and
    # routing ignores it too); see docs/architecture.md "network graph"
    _jitter_warned = False

    @classmethod
    def from_parsed(cls, g: GmlGraph) -> "NetworkGraph":
        node_ids = [n["id"] for n in g.nodes]
        if len(set(node_ids)) != len(node_ids):
            raise ValueError("duplicate node ids in graph")
        id_to_index = {nid: i for i, nid in enumerate(node_ids)}
        n = len(node_ids)

        def bw(node, key):
            v = node.get(key)
            return -1 if v is None else parse_bandwidth_bits_per_sec(v)

        bw_up = np.array([bw(nd, "host_bandwidth_up") for nd in g.nodes], dtype=np.int64)
        bw_down = np.array([bw(nd, "host_bandwidth_down") for nd in g.nodes], dtype=np.int64)

        lat = np.full((n, n), TIME_MAX, dtype=np.int64)
        rel = np.zeros((n, n), dtype=np.float32)
        jit = np.zeros((n, n), dtype=np.int64)

        jitter_edges = []
        for e in g.edges:
            s = id_to_index.get(e["source"])
            t = id_to_index.get(e["target"])
            if s is None or t is None:
                raise ValueError(f"edge references unknown node: {e}")
            if "latency" not in e:
                raise ValueError(f"edge missing latency: {e}")
            elat = parse_time_ns(e["latency"])
            if elat <= 0:
                # reference rejects zero latency (graph/mod.rs:107-109): a
                # zero-latency link would collapse the lookahead window.
                raise ValueError(f"edge latency must be > 0: {e}")
            loss = float(e.get("packet_loss", 0.0))
            if not 0.0 <= loss <= 1.0:
                raise ValueError(f"packet_loss not in [0,1]: {e}")
            ejit = parse_time_ns(e.get("jitter", 0)) if "jitter" in e else 0
            if ejit > 0:
                jitter_edges.append((e["source"], e["target"]))
            pairs = [(s, t)] if g.directed else [(s, t), (t, s)]
            for a, b in pairs:
                # keep the better (lower-latency) edge if duplicated
                if elat < lat[a, b]:
                    lat[a, b] = elat
                    rel[a, b] = np.float32(1.0 - loss)
                    jit[a, b] = ejit

        if jitter_edges and not cls._jitter_warned:
            # parsed-but-unused is easy to mistake for applied-but-small:
            # warn ONCE per process, naming the edges, so experiments that
            # rely on jittered latency know it is not being simulated
            # (reference parity — the reference parses and ignores it in
            # routing too; docs/architecture.md)
            cls._jitter_warned = True
            from shadow_tpu_torch.utils.shadow_log import slog

            shown = ", ".join(f"{s}->{t}" for s, t in jitter_edges[:8])
            extra = (
                f" (+{len(jitter_edges) - 8} more)" if len(jitter_edges) > 8 else ""
            )
            slog(
                "warning",
                0,
                "graph",
                f"{len(jitter_edges)} edge(s) declare nonzero jitter "
                f"({shown}{extra}); jitter is parsed but NOT applied to "
                "link latency — reference-parity behavior, see "
                "docs/architecture.md",
            )
        return cls(
            num_nodes=n,
            node_ids=node_ids,
            id_to_index=id_to_index,
            bw_up_bits=bw_up,
            bw_down_bits=bw_down,
            lat_ns=lat,
            rel=rel,
            jitter_ns=jit,
            directed=g.directed,
        )

    def min_latency_ns(self) -> int:
        """Minimum edge latency — the static conservative lookahead bound
        (reference: src/main/core/scheduler/runahead.rs:43-56)."""
        m = self.lat_ns[self.lat_ns < TIME_MAX]
        if m.size == 0:
            raise ValueError("graph has no edges")
        return int(m.min())
