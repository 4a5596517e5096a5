"""Overlay-network workload pack (port of shadow_tpu/models/overlay/):
onion (Tor-style circuits and relay cell scheduling over TCP), cdn (a
cache hierarchy, fan-in heavy) and gossip (membership gossip with churn,
fan-out heavy). Registered in models/registry.py as "onion", "cdn" and
"gossip"."""

from shadow_tpu_torch.models.overlay.cdn import CdnModel
from shadow_tpu_torch.models.overlay.gossip import GossipModel
from shadow_tpu_torch.models.overlay.onion import OnionModel

__all__ = ["CdnModel", "GossipModel", "OnionModel"]
