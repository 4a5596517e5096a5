"""Run-time drivers: scheduler, ensemble runner, manager, and the `run`
front door."""
