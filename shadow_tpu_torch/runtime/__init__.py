"""Run-time drivers: scheduler, manager, and the `run` front door."""
