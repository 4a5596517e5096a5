"""The services' pure seams, port against the JAX package on the same
inputs: the packing decision (runtime/sweep.py pack_jobs), the compile
cache's keying and counting (runtime/compile_cache.py), sweep spec
expansion (config/sweep.py), mirroring tests/test_sweep_pack.py case
for case; the daemon's spool spec and quota-class parsers, the journal
compaction fold, the retry backoff, the percentiles, the failure kinds
and the sweep report. No device, no run. Exact equality."""

import copy

import numpy as np
import pytest
import torch

import shadow_tpu.config.sweep as j_cfg
import shadow_tpu.runtime.compile_cache as j_cc
import shadow_tpu.runtime.daemon as j_daemon
import shadow_tpu.runtime.sweep as j_sweep
import shadow_tpu_torch.config.sweep as t_cfg
import shadow_tpu_torch.runtime.compile_cache as t_cc
import shadow_tpu_torch.runtime.daemon as t_daemon
import shadow_tpu_torch.runtime.sweep as t_sweep

PACKAGES = {"ref": (j_cfg, j_sweep, j_cc, j_daemon), "port": (t_cfg, t_sweep, t_cc, t_daemon)}


def _job(cfg_mod, seed, group="g1", priority=0, arrival=0):
    return cfg_mod.SweepJob(name=f"j-s{seed}", entry="j", seed=seed, priority=priority,
                            arrival_ns=arrival, config=None, raw_config={}, group_key=group)


def _both(fn):
    """fn(package modules) in both packages: (ref, port)."""
    return fn(*PACKAGES["ref"]), fn(*PACKAGES["port"])


def _batches(batches):
    return [(b.group_key, b.priority, b.arrival_ns, b.base_seed, b.replicas, b.stride, b.index,
             [j.name for j in b.jobs]) for b in batches]


# --- pack_jobs (tests/test_sweep_pack.py's eight pack cases) -------------

def _pack_case(name, c, s):
    job = lambda *a, **k: _job(c, *a, **k)  # noqa: E731
    if name == "consecutive_seeds_one_batch":
        out = s.pack_jobs([job(x) for x in range(8)], capacity=8)
        assert len(out) == 1 and (out[0].replicas, out[0].base_seed, out[0].stride) == (8, 0, 1)
    elif name == "caps_at_capacity":
        out = s.pack_jobs([job(x) for x in range(8)], capacity=3)
        assert [b.replicas for b in out] == [3, 3, 2]
        assert [b.base_seed for b in out] == [0, 3, 6]
    elif name == "arithmetic_progression_stride":
        out = s.pack_jobs([job(x) for x in (3, 5, 7)], capacity=8)
        assert len(out) == 1 and (out[0].stride, out[0].base_seed) == (2, 3)
    elif name == "non_progression_splits":
        out = s.pack_jobs([job(x) for x in (1, 4, 6)], capacity=8)
        assert [(b.base_seed, b.replicas, b.stride) for b in out] == [(1, 2, 3), (6, 1, 1)]
    elif name == "groups_by_fingerprint_and_priority":
        out = s.pack_jobs([job(0, "gA"), job(1, "gA"), job(0, "gB"), job(2, "gA", priority=5)],
                          capacity=8)
        assert len(out) == 3 and out[0].priority == 5
    elif name == "deterministic_and_indexed":
        jobs = [job(x) for x in (9, 1, 5, 3, 7)]
        out = s.pack_jobs(jobs, capacity=4)
        again = s.pack_jobs(list(reversed(jobs)), capacity=4)
        assert _batches(out) == _batches(again)
        assert [(b.base_seed, b.replicas) for b in out] == [(1, 4), (9, 1)]
    elif name == "duplicate_seed_across_entries_stays_separate":
        a, b = job(0), job(0)
        b.name, b.entry = "k-s0", "k"
        out = s.pack_jobs([a, b, job(1)], capacity=8)
        assert sorted(x.replicas for x in out) == [1, 2] and all(x.stride >= 1 for x in out)
    elif name == "rejects_bad_capacity":
        with pytest.raises(ValueError, match="capacity") as e:
            s.pack_jobs([job(0)], capacity=0)
        return str(e.value)
    elif name == "mesh_rows_fill_whole_rows":
        out = s.pack_jobs([job(x) for x in range(7)], capacity=5, mesh_rows=2)
        assert [b.replicas for b in out] == [4, 3]
    return _batches(out)


PACK_CASES = ("consecutive_seeds_one_batch", "caps_at_capacity", "arithmetic_progression_stride",
              "non_progression_splits", "groups_by_fingerprint_and_priority",
              "deterministic_and_indexed", "duplicate_seed_across_entries_stays_separate",
              "rejects_bad_capacity", "mesh_rows_fill_whole_rows")


@pytest.mark.parametrize("case", PACK_CASES)
def test_pack_jobs_matches_shadow_tpu(case):
    ref, port = _both(lambda c, s, cc, d: _pack_case(case, c, s))
    assert port == ref


# --- the compile cache's keying and counting ------------------------------

def _np_state(shape=(4, 8)):
    return {"a": np.zeros(shape, np.int64), "b": np.zeros(shape[0], np.float32)}


def _cache_case(name, cc):
    cache = cc.CompileCache()
    built = []

    def build():
        built.append(1)
        return f"exe{len(built)}"

    if name == "counts_hits_and_misses":
        got = [cache.get("k", _np_state(), "cfg", build) for _ in range(2)]
        stats = cache.stats()
        stats.pop("compile_seconds")
        stats.pop("compile_walls")
        return got, cache.misses, cache.hits, stats
    if name == "shape_mismatch_never_aliases":
        got = [cache.get("k", _np_state((4, 8)), "cfg", build),
               cache.get("k", _np_state((4, 16)), "cfg", build),
               cache.get("k", _np_state((4, 8)), "cfg2", build)]
        return got, cache.misses, cache.hits
    # state_signature_covers_shape_and_dtype
    sig = cc.state_signature
    return (sig(_np_state((4, 8))), sig(_np_state((4, 8))) != sig(_np_state((4, 16))),
            sig({"a": np.zeros(4, np.int64)}) != sig({"a": np.zeros(4, np.int32)}))


@pytest.mark.parametrize("case", ("counts_hits_and_misses", "shape_mismatch_never_aliases",
                                  "state_signature_covers_shape_and_dtype"))
def test_compile_cache_matches_shadow_tpu(case):
    ref, port = _both(lambda c, s, cc, d: _cache_case(case, cc))
    assert port == ref


def test_state_signature_of_torch_tensors_names_dtypes_as_numpy_does():
    st = {"a": torch.zeros((4, 8), dtype=torch.int64), "b": torch.zeros(4, dtype=torch.float32)}
    assert t_cc.state_signature(st) == j_cc.state_signature(_np_state())


# --- spec expansion -------------------------------------------------------

BASE = {
    "general": {"stop_time": "100 ms"},
    "hosts": {"peer": {"network_node_id": 0, "quantity": 4, "processes": [
        {"path": "phold", "args": {"min_delay": "2 ms", "max_delay": "9 ms"}}]}},
}


def test_spec_expands_seeds_and_groups_modulo_seed(tmp_path):
    raw = {"sweep": {"name": "t", "output_dir": str(tmp_path / "out"), "config": BASE, "jobs": [
        {"name": "a", "seed_range": [0, 3]},
        {"name": "b", "seeds": [5], "overrides": {"experimental": {"pump_k": 4}}}]}}

    def expand(c, s, cc, d):
        spec = c.load_sweep_spec(copy.deepcopy(raw))
        return [(j.name, j.entry, j.seed, j.priority, j.arrival_ns, j.group_key, j.raw_config,
                 j.config.general.seed, j.config.general.data_directory) for j in spec.jobs], (
                     spec.name, spec.output_dir, spec.capacity, spec.retry_max,
                     spec.retry_backoff_s)

    ref, port = _both(expand)
    assert port == ref
    jobs = port[0]
    assert [j[0] for j in jobs] == ["a-s0", "a-s1", "a-s2", "b-s5"]
    assert len({j[5] for j in jobs[:3]}) == 1 and jobs[3][5] != jobs[0][5]


_BAD_SPECS = {
    "replicas": {"sweep": {"config": {**BASE, "general": {"stop_time": "1 s", "replicas": 2}},
                           "jobs": [{"name": "a", "seeds": [0]}]}},
    "duplicate seeds": {"sweep": {"config": BASE, "jobs": [{"name": "a", "seeds": [0, 0]}]}},
    "duplicate sweep job name": {"sweep": {"config": BASE, "jobs": [
        {"name": "a", "seeds": [0]}, {"name": "a", "seeds": [1]}]}},
    "jobs": {"sweep": {"config": BASE, "jobs": []}},
    "exactly one of": {"sweep": {"jobs": [{"name": "a", "seeds": [0]}]}},
    "chaos is sweep-global": {"sweep": {"config": BASE, "jobs": [
        {"name": "a", "seeds": [0], "overrides": {"chaos": {"faults": [{"kind": "capacity"}]}}}]}},
    "seed_range must be": {"sweep": {"config": BASE, "jobs": [
        {"name": "a", "seed_range": [0, 1, 2]}]}},
    "unknown key": {"sweep": {"config": BASE, "bogus": 1, "jobs": [{"name": "a", "seeds": [0]}]}},
}


@pytest.mark.parametrize("what", sorted(_BAD_SPECS))
def test_spec_refusals_match_shadow_tpu(what):
    def refuse(c, s, cc, d):
        with pytest.raises(ValueError, match=what) as e:
            c.load_sweep_spec(copy.deepcopy(_BAD_SPECS[what]))
        return str(e.value)

    ref, port = _both(refuse)
    assert port == ref


def test_spec_mesh_is_not_yet_ported():
    """`sweep.mesh` is ported: the spec loads with its canonical grid, as
    in the JAX package; a bad grid spec is refused."""
    raw = {"sweep": {"config": BASE, "mesh": "2X4", "jobs": [{"name": "a", "seeds": [0]}]}}
    assert t_cfg.load_sweep_spec(raw).mesh == j_cfg.load_sweep_spec(raw).mesh == "2x4"
    with pytest.raises(ValueError, match="mesh"):
        t_cfg.load_sweep_spec({"sweep": {**raw["sweep"], "mesh": "2by4"}})


# --- the daemon's parsers and the journal fold ---------------------------

def _spool_text(**job):
    import yaml

    spec = {"tenant": "alice", "name": "ph", "seeds": [0, 1], "config": BASE, **job}
    return yaml.safe_dump({"job": {k: v for k, v in spec.items() if v is not None}})


_SPOOL_SPECS = {
    "inline": _spool_text(),
    "seed_range_and_priority": _spool_text(seeds=[4], seed_range=[0, 2], priority=3),
    "overrides": _spool_text(overrides={"experimental": {"pump_k": 4}}),
    "bad_tenant": _spool_text(tenant="../x"),
    "relative_base": _spool_text(config=None, base="rel.yaml"),
    "chaos": _spool_text(overrides={"chaos": {"faults": [{"kind": "capacity"}]}}),
    "unknown_key": _spool_text(bogus=1),
    "not_a_job": "jobs: []\n",
}


@pytest.mark.parametrize("case", sorted(_SPOOL_SPECS))
def test_parse_spool_spec_matches_shadow_tpu(case, tmp_path):
    text = _SPOOL_SPECS[case]

    def parse(c, s, cc, d):
        try:
            tenant, entry, jobs, canon = d.parse_spool_spec(text, str(tmp_path))
        except ValueError as e:
            return "error", str(e)
        return tenant, entry, canon, [(j.name, j.seed, j.priority, j.group_key, j.raw_config)
                                      for j in jobs]

    ref, port = _both(parse)
    assert port == ref


_QUOTA_ARGS = ("alice=device_seconds:120", "bob=device_seconds:0.5,queue:3", "alice", "alice=",
               "alice=queue:3", "a=device_seconds:x", "a=device_seconds:-1",
               "a=device_seconds:1,queue:0", "../a=device_seconds:1")


@pytest.mark.parametrize("arg", _QUOTA_ARGS)
def test_parse_quota_class_matches_shadow_tpu(arg):
    def parse(c, s, cc, d):
        try:
            return d.parse_quota_class(arg)
        except ValueError as e:
            return "error", str(e)

    ref, port = _both(parse)
    assert port == ref


def _records():
    admit = lambda seq, sha, tenant, jobs: {  # noqa: E731
        "seq": seq, "type": "admit", "spec_sha256": sha, "source_sha256": f"src-{sha}",
        "tenant": tenant, "entry": "ph", "jobs": jobs, "seeds": [0, 1], "priority": 0,
        "spec_file": f"{sha}.yaml", "spec": "job: {}\n"}
    return [
        admit(0, "aaa", "alice", ["alice.ph-s0", "alice.ph-s1"]),
        admit(1, "bbb", "bob", ["bob.ph-s0", "bob.ph-s1"]),
        {"seq": 2, "type": "batch-start", "key": "k"},
        {"seq": 3, "type": "job-done", "job": "alice.ph-s0"},
        {"seq": 4, "type": "job-quarantined", "job": "alice.ph-s1"},
        {"seq": 5, "type": "reject", "tenant": "carol", "reason": "quota"},
        {"seq": 6, "type": "job-failed", "job": "bob.ph-s0"},
        {"seq": 7, "type": "reject", "tenant": None, "reason": "parse"},
    ]


@pytest.mark.parametrize("split", (8, 3))
def test_fold_records_matches_shadow_tpu(split):
    """The compaction fold of one tail, and of a snapshot plus a tail."""
    recs = _records()

    def fold(c, s, cc, d):
        prev = d._fold_records(None, recs[:split]) if split < len(recs) else None
        out = d._fold_records(prev, recs[split:] if prev else recs)
        out.pop("wall")
        return out

    ref, port = _both(fold)
    assert port == ref
    assert port["terminal"] == {"alice.ph-s0": "done", "alice.ph-s1": "quarantined",
                                "bob.ph-s0": "failed"}
    assert [f["spec_sha256"] for f in port["folded_admits"]] == ["aaa"]


@pytest.mark.parametrize("base,attempt", ((0.0, 1), (0.5, 1), (0.5, 3), (2.0, 2)))
def test_retry_backoff_matches_shadow_tpu(base, attempt):
    ref, port = _both(lambda c, s, cc, d: [s.retry_backoff_s(base, f"job-{i}", attempt)
                                           for i in range(4)])
    assert port == ref


@pytest.mark.parametrize("samples", ([], [3.0], [float(x) for x in range(1, 101)],
                                     [0.5, 0.25, 2.0, 1.0]))
def test_percentiles_match_shadow_tpu(samples):
    ref, port = _both(lambda c, s, cc, d: d._percentiles(list(samples)))
    assert port == ref


def test_failure_kinds_match_shadow_tpu():
    import shadow_tpu.engine.round as j_round
    import shadow_tpu.runtime.checkpoint as j_ckpt
    import shadow_tpu_torch.engine.round as t_round
    import shadow_tpu_torch.runtime.checkpoint as t_ckpt

    def kinds(rnd, ck, s):
        return [s._failure_kind(e) for e in (
            rnd.CapacityError("x"), rnd.WatchdogExpired(2, 1.0),
            rnd.EngineCompileError("megakernel", RuntimeError("x")), ck.CheckpointError("x"),
            KeyError("x"), RuntimeError("x"))]

    assert kinds(t_round, t_ckpt, t_sweep) == kinds(j_round, j_ckpt, j_sweep)


def _manifest():
    job = lambda name, seed, status, **kw: {  # noqa: E731
        "name": name, "seed": seed, "priority": 0, "batch": 0, "status": status, **kw}
    return {
        "sweep": "s", "jobs_done": 2, "jobs_total": 4, "jobs_failed": 1, "jobs_quarantined": 1,
        "preemptions": 1, "wall_seconds": 12.5,
        "compile_cache": {"compiles": 2, "hits": 1, "hit_rate": 0.3333, "compile_seconds": 1.25},
        "jobs": [job("ph-s0", 0, "done", stats={"events_handled": 238, "packets_sent": 119}),
                 job("ph-s1", 1, "done", stats={"events_handled": 246, "packets_sent": 123}),
                 job("ph-s2", 2, "failed", failure="capacity", error="boom"),
                 job("ph-s3", 3, "quarantined", error="x" * 60)],
        "aggregate": {"ph": {"events_handled": {"mean": 242.0, "stddev": 5.6569,
                                                "ci95": [234.16, 249.84]}}},
    }


def test_render_report_matches_shadow_tpu():
    ref, port = _both(lambda c, s, cc, d: s.render_report(_manifest()))
    assert port == ref
    assert "ph-s2" in port and "[capacity]" in port
