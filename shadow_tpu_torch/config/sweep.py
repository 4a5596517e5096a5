"""Declarative sweep specs: many jobs over one base scenario (port of
shadow_tpu/config/sweep.py, copied with its imports rewritten).

A sweep spec is a YAML file with a single `sweep` mapping
(docs/service.md):

```yaml
sweep:
  name: phold-seeds          # optional label for the manifest
  output_dir: sweep.data     # manifest + per-job data dirs land here
  base: shadow.yaml          # base scenario config, relative to the spec
  # ...or the scenario inline:
  # config: { general: {...}, hosts: {...} }
  capacity: 8                # max jobs packed into one ensemble batch
  retry_max: 1               # per-job retries after a failed batch splits
  retry_backoff_s: 0.0       # wall backoff base, doubling per attempt
  jobs:
    - name: light            # required, unique per spec
      seeds: [0, 1, 2]       # explicit seed list, and/or
      seed_range: [0, 8]     # the half-open range 0..7
      priority: 0            # higher preempts lower (default 0)
      arrival: 0 s           # sim-time on the service clock (default 0)
      overrides:             # deep-merged over the base config
        experimental: { pump_k: 4 }
```

Each (job entry, seed) pair expands to ONE SweepJob with a fully
resolved, validated ConfigOptions: base ⊕ overrides, `general.seed` set
to the seed, `general.data_directory` pointed at the job's own output
dir. Jobs are single-world configs by construction — the sweep
scheduler owns batching, so `general.replicas` must stay 1 here.

Only expansion and validation live in this module (config layer, no
device imports); packing and execution are runtime/sweep.py. A
`sweep.mesh: RxS` grid runs every packed batch through the mesh plane
(runtime/mesh.py MeshRunner).
"""

from __future__ import annotations

import copy
import dataclasses
import os

import yaml

from shadow_tpu_torch.config.fingerprint import config_fingerprint
from shadow_tpu_torch.config.options import ConfigOptions, deep_merge
from shadow_tpu_torch.simtime import parse_time_ns


@dataclasses.dataclass
class SweepJob:
    """One expanded (job entry, seed) unit of work. `group_key` is the
    config fingerprint modulo seed: jobs sharing it are the same
    compiled world and may batch into one ensemble program."""

    name: str  # "<entry>-s<seed>", unique per sweep
    entry: str  # the spec entry this seed expanded from
    seed: int
    priority: int
    arrival_ns: int
    config: ConfigOptions  # resolved single-world config (replicas=1)
    raw_config: dict  # the merged dict the config was built from
    group_key: str

    @property
    def stop_time_ns(self) -> int:
        return self.config.general.stop_time_ns


@dataclasses.dataclass
class SweepSpec:
    name: str
    output_dir: str
    capacity: int
    jobs: "list[SweepJob]"
    # Degradation ladder (docs/service.md "Retries and quarantine"): a
    # failed multi-job batch is split and its jobs retried individually,
    # each up to retry_max times with retry_backoff_s * 2^(attempt-1)
    # wall seconds between attempts; a job still failing past the budget
    # is quarantined so the rest of the sweep completes.
    retry_max: int = 1
    retry_backoff_s: float = 0.0
    # 2-D mesh batches (docs/parallelism.md "2-D mesh"): "RxS" runs
    # every packed batch through the mesh plane — R replica rows x S
    # host-shards per batch — instead of the single-device ensemble.
    # Packing then prefers batch sizes that fill whole mesh rows
    # (pack_jobs mesh_rows), and a split/retried batch degrades its
    # rows to the largest divisor of its job count (1xS = pure
    # sharded). None = the single-device ensemble plane.
    mesh: "str | None" = None


def _expand_seeds(entry_name: str, d: dict) -> "list[int]":
    seeds = list(d.pop("seeds", []) or [])
    rng = d.pop("seed_range", None)
    if rng is not None:
        if not (isinstance(rng, (list, tuple)) and len(rng) == 2):
            raise ValueError(
                f"sweep.jobs.{entry_name}.seed_range must be [lo, hi]"
            )
        seeds.extend(range(int(rng[0]), int(rng[1])))
    if not seeds:
        raise ValueError(
            f"sweep.jobs.{entry_name}: needs seeds and/or seed_range"
        )
    seeds = [int(s) for s in seeds]
    if len(set(seeds)) != len(seeds):
        raise ValueError(f"sweep.jobs.{entry_name}: duplicate seeds")
    return seeds


def load_sweep_spec(
    raw: dict, spec_dir: str = ".", output_dir: "str | None" = None
) -> SweepSpec:
    """Expand and validate a parsed sweep spec mapping. `spec_dir`
    anchors the relative `base:` path; `output_dir` overrides the
    spec's own (the CLI flag)."""
    if not isinstance(raw, dict) or "sweep" not in raw:
        raise ValueError("sweep spec must be a mapping with a 'sweep' section")
    s = dict(raw["sweep"])
    name = str(s.pop("name", "sweep"))
    out_dir = output_dir or s.pop("output_dir", "sweep.data")
    s.pop("output_dir", None)
    capacity = int(s.pop("capacity", 8))
    if capacity < 1:
        raise ValueError("sweep.capacity must be >= 1")
    retry_max = int(s.pop("retry_max", 1))
    if retry_max < 0:
        raise ValueError("sweep.retry_max must be >= 0")
    retry_backoff_s = float(s.pop("retry_backoff_s", 0.0))
    if retry_backoff_s < 0:
        raise ValueError("sweep.retry_backoff_s must be >= 0")
    mesh = s.pop("mesh", None)
    if mesh is not None:
        from shadow_tpu_torch.config.options import canonical_mesh

        mesh = canonical_mesh(mesh)  # loud on a bad grid spec

    base_cfg = s.pop("config", None)
    base_path = s.pop("base", None)
    if (base_cfg is None) == (base_path is None):
        raise ValueError(
            "sweep needs exactly one of 'base' (a config path) or "
            "'config' (an inline scenario mapping)"
        )
    if base_path is not None:
        path = os.path.join(spec_dir, base_path)
        with open(path) as f:
            base_cfg = yaml.safe_load(f.read())
    if not isinstance(base_cfg, dict):
        raise ValueError("sweep base config must be a mapping")

    entries = s.pop("jobs", None)
    if not entries:
        raise ValueError("sweep needs a non-empty 'jobs' list")
    if s:
        raise ValueError(f"unknown key(s) in sweep: {sorted(s)}")

    jobs: "list[SweepJob]" = []
    seen_entries = set()
    for e in entries:
        e = dict(e)
        ename = str(e.pop("name", ""))
        if not ename:
            raise ValueError("every sweep job entry needs a name")
        if ename in seen_entries:
            raise ValueError(f"duplicate sweep job name {ename!r}")
        seen_entries.add(ename)
        seeds = _expand_seeds(ename, e)
        priority = int(e.pop("priority", 0))
        arrival = e.pop("arrival", 0)
        arrival_ns = parse_time_ns(arrival) if arrival else 0
        overrides = e.pop("overrides", {}) or {}
        if not isinstance(overrides, dict):
            raise ValueError(f"sweep.jobs.{ename}.overrides must be a mapping")
        if "chaos" in overrides:
            raise ValueError(
                f"sweep.jobs.{ename}.overrides: chaos is sweep-global "
                "(the service installs ONE FaultPlan for the whole sweep) "
                "— put the chaos section in the base scenario, or use "
                "target= to restrict a fault to this entry's jobs"
            )
        if e:
            raise ValueError(f"unknown key(s) in sweep.jobs.{ename}: {sorted(e)}")
        merged = deep_merge(base_cfg, overrides)
        for seed in seeds:
            job_raw = copy.deepcopy(merged)
            g = job_raw.setdefault("general", {})
            g["seed"] = seed
            jname = f"{ename}-s{seed}"
            g["data_directory"] = os.path.join(out_dir, "jobs", jname)
            cfg = ConfigOptions.from_dict(copy.deepcopy(job_raw))
            if cfg.general.replicas != 1:
                raise ValueError(
                    f"sweep.jobs.{ename}: jobs are single-world configs; "
                    "the sweep scheduler owns replica batching — drop "
                    "general.replicas from the base/overrides"
                )
            if cfg.general.mesh is not None:
                raise ValueError(
                    f"sweep.jobs.{ename}: jobs are single-world configs; "
                    "the sweep owns the mesh layout — use `sweep.mesh: "
                    "RxS` instead of general.mesh in the base/overrides"
                )
            jobs.append(
                SweepJob(
                    name=jname,
                    entry=ename,
                    seed=seed,
                    priority=priority,
                    arrival_ns=arrival_ns,
                    config=cfg,
                    raw_config=job_raw,
                    group_key=config_fingerprint(cfg, exclude_seed=True),
                )
            )
    return SweepSpec(name=name, output_dir=out_dir, capacity=capacity,
                     jobs=jobs, retry_max=retry_max,
                     retry_backoff_s=retry_backoff_s, mesh=mesh)


def load_sweep_file(path: str, output_dir: "str | None" = None) -> SweepSpec:
    with open(path) as f:
        raw = yaml.safe_load(f.read())
    return load_sweep_spec(
        raw, spec_dir=os.path.dirname(os.path.abspath(path)),
        output_dir=output_dir,
    )
