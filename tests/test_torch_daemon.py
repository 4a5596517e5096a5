"""The port's durable daemon (`serve --device cpu`, `submit`) on
tests/test_daemon_cli.py's 8-peer phold world, held against the JAX
package: each job's sim-stats.json equals the JAX package's standalone
`run` of its seed (tests/test_daemon_cli.py::_standalone), modulo
tests/test_sweep_cli.py::_stats's fields and the port's `execution`
section. Where the JAX daemon works on this machine (two tenants drained
clean, admission refusals) the journal's record kinds and order, the
terminal map and the reject records equal its own too. Covered: two
tenants, a SIGKILL mid-batch and at a checkpoint commit replayed with no
job lost, the persistent cache warm (zero builds) and corrupted (a
rebuild with a warning), admission refusals, journal compaction killed
mid-way, a corrupted journal record (`spool-corrupt`), a stolen lease
(`lease-steal`), and the refusal of what belongs to the multi-device
plane. Every subprocess wait has its own timeout."""

import functools
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch
import yaml

from test_torch_slice import _stats

REPO = pathlib.Path(__file__).resolve().parent.parent
WAIT_S = 240  # the bound on every daemon subprocess here
LEASE_S = 2.0

BASE_CONFIG = {
    "general": {"stop_time": "120 ms", "heartbeat_interval": None, "tracker": True,
                "checkpoint_interval": "20 ms"},
    "network": {"graph": {"type": "1_gbit_switch"}},
    "experimental": {"rounds_per_chunk": 4},
    "hosts": {"peer": {"network_node_id": 0, "quantity": 8, "processes": [
        {"path": "phold", "args": {"min_delay": "2 ms", "max_delay": "12 ms"}}]}},
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def spec_file(root, fname, tenant, name, seeds, priority=0) -> pathlib.Path:
    p = pathlib.Path(root) / fname
    p.write_text(yaml.safe_dump({"job": {"tenant": tenant, "name": name, "seeds": list(seeds),
                                         "priority": priority, "config": BASE_CONFIG}}))
    return p


@functools.lru_cache(maxsize=None)
def standalone(root: str, seed: int) -> dict:
    """The JAX package's `run` of one seed of BASE_CONFIG."""
    from shadow_tpu.runtime.cli_run import run_from_config

    d = pathlib.Path(root) / f"alone-s{seed}"
    raw = json.loads(json.dumps(BASE_CONFIG))
    raw["general"].update(seed=seed, data_directory=str(d))
    cfg = d.with_suffix(".yaml")
    cfg.write_text(yaml.safe_dump(raw))
    assert run_from_config(str(cfg)) == 0
    return _stats(d / "sim-stats.json")


@pytest.fixture(scope="module")
def alone(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("alone"))
    return lambda seed: standalone(root, seed)


def journal(spool) -> "list[dict]":
    """The journal's readable records (a damaged one is skipped, as the
    daemon's replay skips it)."""
    recs = []
    for f in sorted((pathlib.Path(spool) / "journal").glob("r*.json")):
        try:
            recs.append(json.loads(f.read_text()))
        except ValueError:  # UnicodeDecodeError and JSONDecodeError
            pass
    return recs


def job_stats(spool, name) -> dict:
    return _stats(pathlib.Path(spool) / "jobs" / name / "sim-stats.json")


def manifest(spool) -> dict:
    return json.loads((pathlib.Path(spool) / "daemon-manifest.json").read_text())


def serve_port(spool, **kw) -> int:
    from shadow_tpu_torch.runtime.cli_run import run_serve

    return run_serve(str(spool), drain=True, device="cpu", **{"lease_s": LEASE_S, **kw})


def serve_subprocess(spool, *args, timeout=WAIT_S):
    """`python -m shadow_tpu_torch serve SPOOL --drain --device cpu` in a
    child process (the SIGKILL target). Its batch claims' leases last
    LEASE_S, so a restart waits that long at most for a killed daemon's
    claim to expire."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "shadow_tpu_torch", "serve", str(spool), "--drain",
         "--device", "cpu", "--lease-s", str(LEASE_S), *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=timeout)


def _record_kinds(recs):
    return [r["type"] for r in recs]


def test_daemon_two_tenants_drain_clean_as_shadow_tpu(tmp_path, alone):
    """Two tenants' specs admit, run and shut down clean, in the JAX
    daemon's journal order, with its terminal map and tenant table."""
    from shadow_tpu.runtime.cli_run import run_serve as j_serve
    from shadow_tpu.runtime.cli_run import run_submit as j_submit
    from shadow_tpu.runtime.daemon import journal_terminal_map as j_terminal
    from shadow_tpu_torch.runtime.cli_run import run_submit
    from shadow_tpu_torch.runtime.daemon import journal_terminal_map

    a = spec_file(tmp_path, "a.yaml", "alice", "ph", [0, 1])
    b = spec_file(tmp_path, "b.yaml", "bob", "ph", [3, 4])
    spools = {"ref": tmp_path / "ref", "port": tmp_path / "port"}
    for spec in (a, b):
        assert j_submit(str(spools["ref"]), str(spec)) == 0
        assert run_submit(str(spools["port"]), str(spec)) == 0
    assert j_serve(str(spools["ref"]), drain=True, cache_dir=str(tmp_path / "ref-cache")) == 0
    prom = tmp_path / "port.prom"
    assert serve_port(spools["port"], metrics_prom=str(prom)) == 0

    recs = {k: journal(v) for k, v in spools.items()}
    assert _record_kinds(recs["port"]) == _record_kinds(recs["ref"])
    assert recs["port"][-1]["type"] == "shutdown" and recs["port"][-1]["clean"] is True
    assert journal_terminal_map(str(spools["port"])) == j_terminal(str(spools["ref"]))
    drop = ("device_seconds",)
    tenants = {k: {t: {f: v for f, v in row.items() if f not in drop}
                   for t, row in manifest(s)["daemon"]["tenants"].items()}
               for k, s in spools.items()}
    assert tenants["port"] == tenants["ref"]
    m = manifest(spools["port"])
    assert m["jobs_done"] == 4 and m["daemon"]["outstanding_jobs"] == 0
    assert m["compile_cache"]["compiles"] == 1 and m["compile_cache"]["hits"] == 1
    assert len(list((spools["port"] / "accepted").iterdir())) == 2
    text = prom.read_text()
    assert 'shadow_tpu_tenant_queue_depth{tenant="alice"} 0' in text
    assert "shadow_tpu_daemon_uptime_seconds" in text
    for name, seed in (("alice.ph-s0", 0), ("alice.ph-s1", 1), ("bob.ph-s3", 3),
                       ("bob.ph-s4", 4)):
        port = job_stats(spools["port"], name)
        assert port == job_stats(spools["ref"], name), name
        if seed == 0:
            assert port == alone(seed), name


def test_daemon_sigkill_mid_batch_loses_no_job(tmp_path, alone):
    """SIGKILL at a chaos-chosen chunk, then the instant a checkpoint
    commits: each restart replays the journal and finishes every admitted
    job (the second from that checkpoint) equal to its standalone run."""
    from shadow_tpu_torch.runtime.cli_run import run_submit

    spool, cache = tmp_path / "spool", str(tmp_path / "cache")
    assert run_submit(str(spool), str(spec_file(tmp_path, "c.yaml", "carol", "ph", [0, 1]))) == 0
    r = serve_subprocess(spool, "--cache-dir", cache, "--chaos-fault", "daemon-kill@2:target=chunk")
    assert r.returncode in (-9, 137), r.stderr[-800:]
    assert journal(spool)[-1]["type"] != "shutdown"
    assert serve_port(spool, cache_dir=cache) == 0
    resume = manifest(spool)["daemon"]["resume"]
    assert resume["crashed"] is True and resume["pending_jobs"] == 2
    assert {j for b in resume["batches"] for j in b["jobs"]} == {"carol.ph-s0", "carol.ph-s1"}

    assert run_submit(str(spool), str(spec_file(tmp_path, "d.yaml", "dave", "ph", [5, 6]))) == 0
    r = serve_subprocess(spool, "--cache-dir", cache,
                         "--chaos-fault", "daemon-kill@1:target=checkpoint")
    assert r.returncode in (-9, 137), r.stderr[-800:]
    assert serve_port(spool, cache_dir=cache) == 0
    resume = manifest(spool)["daemon"]["resume"]
    dave = [b for b in resume["batches"] if "dave.ph-s5" in b["jobs"]]
    assert dave and dave[0]["checkpoint"], resume["batches"]
    recs = journal(spool)
    admitted = {j for r in recs if r["type"] == "admit" for j in r["jobs"]}
    done = [r["job"] for r in recs if r["type"] == "job-done"]
    assert admitted == set(done) == {"carol.ph-s0", "carol.ph-s1", "dave.ph-s5", "dave.ph-s6"}
    for name, seed in (("carol.ph-s0", 0), ("dave.ph-s5", 5)):
        assert job_stats(spool, name) == alone(seed), name


def test_daemon_persistent_cache_warm_then_corrupted(tmp_path, alone):
    """A daemon on a fresh spool over a warm cache directory builds
    nothing; a damaged entry is rebuilt with a warning, never a crash."""
    from shadow_tpu_torch.runtime import chaos
    from shadow_tpu_torch.runtime.cli_run import run_submit

    cache = tmp_path / "cache"
    warm = tmp_path / "warm"
    run_submit(str(warm), str(spec_file(tmp_path, "w.yaml", "w", "w", [0, 1])))
    assert serve_port(warm, cache_dir=str(cache)) == 0
    assert manifest(warm)["compile_cache"]["compiles"] == 1

    spool = tmp_path / "spool"
    run_submit(str(spool), str(spec_file(tmp_path, "a.yaml", "t", "j1", [0, 1])))
    assert serve_port(spool, cache_dir=str(cache)) == 0
    c = manifest(spool)["compile_cache"]
    assert (c["compiles"], c["hits"], c["persistent"]["disk_hits"]) == (0, 1, 1)

    (entry,) = cache.glob("exe-*.bin")
    chaos.damage_file(str(entry), truncate=False)
    run_submit(str(spool), str(spec_file(tmp_path, "c.yaml", "t", "j3", [5, 6])))
    r = serve_subprocess(spool, "--cache-dir", str(cache))
    assert r.returncode == 0, r.stderr[-800:]
    assert "failed its sha-256 integrity check; rebuilding" in r.stderr
    m = manifest(spool)
    c = m["compile_cache"]
    assert c["compiles"] == 1 and c["persistent"]["disk_skips"] >= 1
    assert c["persistent"]["disk_stores"] == 1
    assert m["jobs_failed"] == 0 and m["jobs_done"] == 2
    assert job_stats(spool, "t.j1-s0") == alone(0)
    assert job_stats(spool, "t.j3-s5") == alone(5)


def _rejects(spool):
    return [{k: v for k, v in r.items() if k not in ("seq", "wall", "sha256", "spec_sha256")}
            for r in journal(spool) if r["type"] == "reject"]


def test_daemon_admission_refusals_as_shadow_tpu(tmp_path):
    """Quota, backpressure and parse refusals: the JAX daemon's journaled
    records and reply files, and rejections alone leave the daemon clean;
    then a duplicate (tenant, entry) under a new digest is refused."""
    from shadow_tpu.runtime.cli_run import run_serve as j_serve
    from shadow_tpu.runtime.cli_run import run_submit as j_submit
    from shadow_tpu_torch.runtime.cli_run import run_submit

    spools = {"ref": tmp_path / "ref", "port": tmp_path / "port"}
    for pkg, spool in spools.items():
        submit = j_submit if pkg == "ref" else run_submit
        (spool / "incoming").mkdir(parents=True)
        submit(str(spool), str(spec_file(tmp_path, "a.yaml", "alice", "big", [0, 1, 2])))
        submit(str(spool), str(spec_file(tmp_path, "b.yaml", "bob", "two", [0, 1])))
        (spool / "incoming" / "zz-broken.yaml").write_text("job: [not, a, map]\n")
    assert j_serve(str(spools["ref"]), drain=True, quotas=["alice=1"], max_queue=1) == 0
    assert serve_port(spools["port"], quotas=["alice=1"], max_queue=1) == 0
    got = {k: _rejects(s) for k, s in spools.items()}
    for recs in got.values():
        for r in recs:
            r["file"] = r["file"].split("-", 1)[-1]  # the submit time stamp
    assert got["port"] == got["ref"]
    assert {r["reason"] for r in got["port"]} == {"quota", "backpressure", "parse"}
    port = spools["port"]
    assert len([p for p in (port / "rejected").iterdir() if p.name.endswith(".reason.json")]) == 3
    m = manifest(port)
    assert m["daemon"]["tenants"]["alice"]["rejected_specs"] == 1 and m["jobs_done"] == 0

    run_submit(str(port), str(spec_file(tmp_path, "c.yaml", "carol", "ph", [0, 1])))
    assert serve_port(port) == 0
    run_submit(str(port), str(spec_file(tmp_path, "c2.yaml", "carol", "ph", [0, 5])))
    assert serve_port(port) == 0
    assert any(r["reason"] == "duplicate" for r in _rejects(port))
    assert manifest(port)["daemon"]["tenants"]["carol"]["done"] == 2


def test_daemon_journal_compaction_killed_midway(tmp_path, alone):
    """A SIGKILL the instant a snapshot commits, before the records it
    covers are deleted: the restart replays snapshot plus tail, ignores
    the stale records and finishes every job; the journal stays bounded."""
    from shadow_tpu_torch.runtime.cli_run import run_submit

    spool, cache = tmp_path / "spool", str(tmp_path / "cache")
    run_submit(str(spool), str(spec_file(tmp_path, "a.yaml", "alice", "ph", [0, 1])))
    r = serve_subprocess(spool, "--cache-dir", cache, "--journal-compact-every", "3",
                         "--chaos-fault", "daemon-kill:target=compact")
    assert r.returncode in (-9, 137), r.stderr[-800:]
    jdir = spool / "journal"
    (snap,) = [json.loads(p.read_text()) for p in sorted(jdir.glob("snap-*.json"))[-1:]]
    assert [p for p in jdir.glob("r*.json") if int(p.name[1:9]) <= snap["through_seq"]]
    assert serve_port(spool, cache_dir=cache, journal_compact_every=3) == 0
    t = manifest(spool)["daemon"]["tenants"]["alice"]
    assert t["admitted"] == 2 and t["done"] == 2
    assert job_stats(spool, "alice.ph-s0") == alone(0)

    run_submit(str(spool), str(spec_file(tmp_path, "b.yaml", "bob", "ph", [3, 4])))
    assert serve_port(spool, cache_dir=cache, journal_compact_every=3) == 0
    assert len(list(jdir.glob("r*.json"))) <= 6 and len(list(jdir.glob("snap-*.json"))) <= 2
    newest = json.loads(sorted(jdir.glob("snap-*.json"))[-1].read_text())
    assert "ph" in {f["entry"] for f in newest["folded_admits"]}
    assert not any(r.get("recovered") for r in journal(spool) if r["type"] == "admit")
    assert manifest(spool)["daemon"]["tenants"]["bob"]["done"] == 2


def test_spool_corrupt_record_recovered_from_the_archive(tmp_path, alone):
    """`spool-corrupt` damages the admission's journal record after its
    commit: the restart skips it with a warning, re-journals the
    admission from accepted/, and re-runs nothing already done."""
    from shadow_tpu_torch.runtime.cli_run import run_submit

    spool, cache = tmp_path / "spool", str(tmp_path / "cache")
    run_submit(str(spool), str(spec_file(tmp_path, "a.yaml", "erin", "ph", [0, 1])))
    assert serve_port(spool, cache_dir=cache, chaos_faults=["spool-corrupt@0"]) == 0
    r = serve_subprocess(spool, "--cache-dir", cache)
    assert r.returncode == 0, r.stderr[-800:]
    assert "skipping corrupt journal record" in r.stderr
    resume = manifest(spool)["daemon"]["resume"]
    assert resume["corrupt_skipped"] == 1 and resume["pending_jobs"] == 0
    recs = journal(spool)
    assert [r["recovered"] for r in recs if r["type"] == "admit" and r.get("recovered")] == [True]
    assert sorted(r["job"] for r in recs if r["type"] == "job-done") == ["erin.ph-s0", "erin.ph-s1"]
    assert job_stats(spool, "erin.ph-s0") == alone(0)


def test_lease_steal_parks_the_batch_and_reclaims_it(tmp_path, alone):
    """`lease-steal` rewrites the running batch's claim to a foreign
    owner: the batch parks through a checkpoint, waits out the lease,
    steals it back and resumes, ending as its standalone run."""
    from shadow_tpu_torch.runtime.cli_run import run_submit

    spool = tmp_path / "spool"
    run_submit(str(spool), str(spec_file(tmp_path, "a.yaml", "fay", "ph", [5])))
    assert serve_port(spool, lease_s=1.0, poll_interval=0.1,
                      chaos_faults=["lease-steal@0"]) == 0
    recs = journal(spool)
    park = [r for r in recs if r["type"] == "park"]
    steal = [r for r in recs if r["type"] == "claim-steal"]
    assert [p["reason"] for p in park] == ["lease-lost"]
    assert [s["from_owner"] for s in steal] == ["chaos-thief"]
    starts = [r for r in recs if r["type"] == "batch-start"]
    assert len(starts) == 2 and starts[1]["resume"], starts
    assert job_stats(spool, "fay.ph-s5") == alone(5)
    assert not list((spool / "claims").glob("claim-*.json"))


@pytest.mark.parametrize("flags,what", (
    (["--mesh", "2x2"], "serve --mesh"),
    (["--chaos-fault", "device-loss@0"], "chaos fault kind 'device-loss'"),
))
def test_serve_refuses_the_multi_device_plane(tmp_path, flags, what, capsys):
    """The multi-device plane is ported: `serve --mesh` and a device-loss
    fault are taken (an empty spool drains and the daemon exits 0), as
    the JAX package takes them."""
    from shadow_tpu.cli import main as j_main
    from shadow_tpu_torch.cli import main

    assert j_main(["serve", str(tmp_path / "ref"), "--drain", *flags]) == 0
    assert main(["serve", str(tmp_path / "spool"), "--drain", "--device", "cpu", *flags]) == 0
    err = capsys.readouterr().err
    assert "is not yet ported" not in err and "error" not in err, what
