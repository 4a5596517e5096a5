from shadow_tpu_torch.graph.gml import GmlGraph, parse_gml
from shadow_tpu_torch.graph.ip import IpAssignment
from shadow_tpu_torch.graph.network_graph import ONE_GBIT_SWITCH_GML, NetworkGraph
from shadow_tpu_torch.graph.routing import RoutingTables, compute_routing

__all__ = [
    "GmlGraph",
    "parse_gml",
    "NetworkGraph",
    "ONE_GBIT_SWITCH_GML",
    "RoutingTables",
    "compute_routing",
    "IpAssignment",
]
