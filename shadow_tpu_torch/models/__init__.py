"""Scripted host models (the port carries tgen)."""
