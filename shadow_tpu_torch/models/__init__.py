"""Scripted host models: tgen, phold, bulk-tcp and the overlay pack
(onion, cdn, gossip)."""
