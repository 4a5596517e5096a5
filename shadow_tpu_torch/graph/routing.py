"""All-pairs path properties: tropical (min-plus) matrix squaring (port
of shadow_tpu/graph/routing.py).

D <- min_k(D[i,k] + D[k,j]), log2(N) squarings, each blocked over rows
and scanned over k-chunks in the reference's order, carrying the f32
reliability product along the argmin path. Within a chunk the first
(smallest) k wins a latency tie, and a later chunk replaces the running
best only when strictly shorter — so ties between equal-latency paths
pick `rel` by chunk order, as in the reference.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from shadow_tpu_torch.device import resolve_device
from shadow_tpu_torch.graph.network_graph import NetworkGraph
from shadow_tpu_torch.simtime import TIME_MAX


@dataclasses.dataclass
class RoutingTables:
    """Dense node-to-node path properties, device-resident.

    lat_ns[i, j] == TIME_MAX means unreachable; the engine looks paths up
    as lat_ns[host_node[src], host_node[dst]]."""

    lat_ns: torch.Tensor  # [N, N] i64
    rel: torch.Tensor  # [N, N] f32
    host_node: "torch.Tensor | None" = None  # [H_global] i32
    lookahead_ns: "torch.Tensor | None" = None  # [N] i64

    @property
    def num_nodes(self) -> int:
        return self.lat_ns.shape[0]

    @property
    def num_global_hosts(self) -> int:
        return self.host_node.shape[0]

    def with_hosts(self, host_node) -> "RoutingTables":
        hn = torch.as_tensor(np.asarray(host_node, np.int32), device=self.lat_ns.device)
        if hn.ndim != 1:
            raise ValueError("host_node must be 1-D [num_hosts]")
        return dataclasses.replace(self, host_node=hn)

    def with_lookahead(self) -> "RoutingTables":
        row_min = torch.amin(self.lat_ns, dim=1)
        return dataclasses.replace(
            self, lookahead_ns=torch.clamp(row_min, max=TIME_MAX)
        )

    def to(self, device) -> "RoutingTables":
        return RoutingTables(
            **{
                f.name: None if getattr(self, f.name) is None
                else getattr(self, f.name).to(device)
                for f in dataclasses.fields(self)
            }
        )

    def min_path_latency_ns(self) -> int:
        lat = self.lat_ns.cpu().numpy()
        finite = lat[lat < TIME_MAX]
        if finite.size == 0:
            raise ValueError("routing table has no reachable pairs")
        return int(finite.min())


def _minplus_square_once(lat: torch.Tensor, rel: torch.Tensor, block: int):
    """One squaring step: out[i,j] = min(lat[i,j], min_k lat[i,k]+lat[k,j]),
    blocked over rows and scanned over k-chunks of width `block`."""
    n = lat.shape[0]
    nk = n // block
    out_lat = lat.clone()
    out_rel = rel.clone()
    for rb in range(nk):
        rows = slice(rb * block, (rb + 1) * block)
        best_lat, best_rel = lat[rows].clone(), rel[rows].clone()
        for kc in range(nk):
            ks = slice(kc * block, (kc + 1) * block)
            cand_lat = lat[rows, ks][:, :, None] + lat[ks][None, :, :]  # [B, C, N]
            k_best = torch.argmin(cand_lat, dim=1, keepdim=True)
            cl = torch.gather(cand_lat, 1, k_best)[:, 0, :]
            cand_rel = rel[rows, ks][:, :, None] * rel[ks][None, :, :]
            cr = torch.gather(cand_rel, 1, k_best)[:, 0, :]
            upd = cl < best_lat
            best_lat = torch.where(upd, cl, best_lat)
            best_rel = torch.where(upd, cr, best_rel)
        out_lat[rows], out_rel[rows] = best_lat, best_rel
    return out_lat, out_rel


def _pad_to_multiple(arr: np.ndarray, block: int, fill) -> np.ndarray:
    n = arr.shape[0]
    pad = (-n) % block
    if pad == 0:
        return arr
    out = np.full((n + pad, n + pad), fill, dtype=arr.dtype)
    out[:n, :n] = arr
    return out


def compute_routing(
    graph: NetworkGraph, use_shortest_path: bool = True, block: int = 128, device="cuda"
) -> RoutingTables:
    """Build node-to-node routing tables on `device` (the card unless
    asked for the CPU)."""
    device = resolve_device(device)
    n = graph.num_nodes
    block = min(block, max(8, 1 << (n - 1).bit_length()))
    lat0 = _pad_to_multiple(graph.lat_ns, block, TIME_MAX)
    rel0 = _pad_to_multiple(graph.rel.astype(np.float32), block, np.float32(0.0))

    if not use_shortest_path:
        return RoutingTables(
            lat_ns=torch.as_tensor(lat0[:n, :n].copy(), device=device),
            rel=torch.as_tensor(rel0[:n, :n].copy(), device=device),
        ).with_lookahead()

    np_n = lat0.shape[0]
    diag = np.arange(np_n)
    lat_t = lat0.copy()
    rel_t = rel0.copy()
    lat_t[diag, diag] = 0
    rel_t[diag, diag] = 1.0
    lat = torch.as_tensor(lat_t, device=device)
    rel = torch.as_tensor(rel_t, device=device)
    steps = max(1, (max(n - 1, 1)).bit_length())
    for _ in range(steps):
        lat, rel = _minplus_square_once(lat, rel, block)
        lat = torch.clamp(lat, max=TIME_MAX)

    di = torch.arange(np_n, device=device)
    lat[di, di] = torch.as_tensor(np.ascontiguousarray(np.diagonal(lat0)), device=device)
    rel[di, di] = torch.as_tensor(np.ascontiguousarray(np.diagonal(rel0)), device=device)
    return RoutingTables(
        lat_ns=lat[:n, :n].contiguous(), rel=rel[:n, :n].contiguous()
    ).with_lookahead()
