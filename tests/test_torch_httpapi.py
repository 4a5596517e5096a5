"""The port daemon's HTTP front door and a fleet of port daemons on one
spool, on the CPU (tests/test_httpapi_cli.py's flows): POST /v1/jobs
lands a spec through the spool's atomic drop (202 with the canonical
ids), status, the ndjson event stream closed by its terminal sentinel,
results (the job's sim-stats.json, equal to the JAX package's standalone
run of its seed), metrics; the refusals 400 (parse, a traversal-shaped
id), 404, 409 (duplicate) and 429 (quota class, with Retry-After) carry
the JAX front door's error documents; the `http-drop` fault is a 503;
`submit --wait --http` mirrors the outcome. Two daemons drain one spool,
one of them taking over the claim a SIGKILLed third held: every job
done exactly once. Every wait is bounded."""

import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch
import yaml

from test_torch_daemon import (
    BASE_CONFIG,
    REPO,
    WAIT_S,
    alone,  # noqa: F401 (a fixture)
    job_stats,
    journal,
    serve_subprocess,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spec_text(tenant, name, seeds):
    return yaml.safe_dump({"job": {"tenant": tenant, "name": name, "seeds": list(seeds),
                                   "config": BASE_CONFIG}})


class _Client:
    """A urllib client: non-2xx responses come back as (code, headers,
    body) instead of raising."""

    def __init__(self, addr: str):
        self.base = f"http://{addr}"

    def req(self, method, path, body=None, timeout=60):
        r = urllib.request.Request(self.base + path, method=method,
                                   data=body.encode() if body is not None else None)
        try:
            with urllib.request.urlopen(r, timeout=timeout) as resp:
                return resp.status, dict(resp.headers), resp.read().decode()
        except urllib.error.HTTPError as e:
            return e.code, dict(e.headers), e.read().decode()


class _LiveDaemon:
    """A daemon (either package's DaemonService) on a background thread
    with its front door up; the stop flag is the shutdown switch."""

    def __init__(self, service_cls, spool, **kwargs):
        self.svc = service_cls(str(spool), **kwargs)
        self.result = self.error = None
        self.thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        try:
            self.result = self.svc.run()
        except BaseException as e:  # noqa: BLE001 — surfaced in __exit__
            self.error = e

    def __enter__(self):
        self.thread.start()
        addr_file = os.path.join(self.svc.spool_dir, "http-address")
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and not os.path.exists(addr_file):
            if self.error is not None:
                raise self.error
            time.sleep(0.05)
        with open(addr_file) as f:
            self.client = _Client(f.read().strip())
        return self

    def __exit__(self, *exc):
        self.svc._stop = True
        self.thread.join(timeout=120)
        assert not self.thread.is_alive(), "daemon thread did not stop"
        if self.error is not None and not exc[0]:
            raise self.error


def _port_daemon(spool, **kw):
    from shadow_tpu_torch.runtime.daemon import DaemonService

    return _LiveDaemon(DaemonService, spool, device="cpu", **kw)


def _wait_status(c, jid, want, timeout=WAIT_S):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        code, _, body = c.req("GET", f"/v1/jobs/{jid}")
        if code == 200 and json.loads(body)["status"] in want:
            return json.loads(body)
        time.sleep(0.2)
    raise AssertionError(f"{jid} not {want} within {timeout} s")


def _error_doc(body):
    err = json.loads(body)["error"]
    return {k: v for k, v in err.items() if k not in ("seq", "wall", "sha256", "retry_after_s")}


def test_http_round_trip_and_refusals(tmp_path, alone, capsys):
    from shadow_tpu_torch.runtime.cli_run import run_submit

    spool = tmp_path / "spool"
    with _port_daemon(spool, capacity=8, poll_interval_s=0.2, prom_interval_s=1.0,
                      http="127.0.0.1:0", quota_window_s=120.0,
                      quota_classes={"starved": {"device_seconds": 0.0, "queue": None}},
                      cache_dir=str(tmp_path / "cache")) as live:
        c = live.client
        code, _, body = c.req("POST", "/v1/jobs", body=":-not yaml: [")
        err = json.loads(body)["error"]
        assert code == 400 and (err["type"], err["reason"], err["via"]) == (
            "reject", "parse", "http")
        code, hdr, body = c.req("POST", "/v1/jobs", body=_spec_text("starved", "no", [1]))
        err = json.loads(body)["error"]
        assert code == 429 and err["reason"] == "quota-class"
        assert 0 < int(hdr["Retry-After"]) <= 120 and err["retry_after_s"] > 0

        spec = _spec_text("alice", "ph", [0, 1])
        code, _, body = c.req("POST", "/v1/jobs", body=spec)
        assert code == 202 and json.loads(body)["job_ids"] == ["alice.ph-s0", "alice.ph-s1"]
        _wait_status(c, "alice.ph-s0", ("queued", "running", "done"))
        stream = []

        def _tail():
            code, _, text = c.req("GET", "/v1/jobs/alice.ph-s0/events", timeout=WAIT_S)
            assert code == 200, text
            stream.extend(json.loads(ln) for ln in text.splitlines() if ln)

        tail = threading.Thread(target=_tail, daemon=True)
        tail.start()
        status = _wait_status(c, "alice.ph-s0", ("done", "failed", "quarantined"))
        assert status["status"] == "done" and status["stats"]["events_handled"] > 0
        tail.join(timeout=60)
        assert not tail.is_alive(), "event stream never closed"
        assert stream and stream[-1] == {"job": "alice.ph-s0", "terminal": "done"}

        code, _, body = c.req("POST", "/v1/jobs", body=spec)
        assert code == 409 and json.loads(body)["error"]["reason"] == "duplicate"
        code, _, body = c.req("GET", "/v1/jobs/alice.ph-s0/results")
        assert code == 200
        assert json.loads(body) == json.loads(
            (spool / "jobs" / "alice.ph-s0" / "sim-stats.json").read_text())
        assert c.req("GET", "/v1/jobs/alice.nope-s9")[0] == 404
        assert c.req("GET", "/v1/jobs/..%2F..%2Fetc/results")[0] == 400
        code, _, text = c.req("GET", "/v1/metrics")
        assert code == 200 and text.count("# TYPE shadow_tpu_http_requests_total") == 1
        assert 'shadow_tpu_http_requests_total{route="/v1/jobs",code="202"} 1' in text
        assert 'shadow_tpu_tenant_budget_remaining{tenant="starved"} 0.0' in text

        spec2 = tmp_path / "carol.yaml"
        spec2.write_text(_spec_text("carol", "ph", [5]))
        assert run_submit(str(spool), str(spec2), wait=True, timeout=WAIT_S, http=c.base,
                          poll_s=0.3) == 0
        assert "carol.ph-s5: done" in capsys.readouterr().out
    recs = journal(spool)
    assert {r["reason"] for r in recs if r["type"] == "reject"} == {
        "parse", "quota-class", "duplicate"}
    assert job_stats(spool, "alice.ph-s0") == alone(0)
    assert job_stats(spool, "carol.ph-s5") == alone(5)


def test_http_refusals_carry_the_reference_documents(tmp_path):
    """The 400 and 429 documents of both front doors on the same bodies
    (no job runs), equal but for sequence, wall time and digest."""
    from shadow_tpu.runtime.daemon import DaemonService as JDaemon

    docs = {}
    for pkg in ("ref", "port"):
        kw = dict(poll_interval_s=0.2, http="127.0.0.1:0", quota_window_s=120.0,
                  quota_classes={"starved": {"device_seconds": 0.0, "queue": None}},
                  persist_cache=False)
        live = (_LiveDaemon(JDaemon, tmp_path / pkg, **kw) if pkg == "ref"
                else _port_daemon(tmp_path / pkg, **kw))
        with live:
            got = []
            for body in (":-not yaml: [", _spec_text("starved", "no", [1]),
                         "job: {tenant: ../x, name: a, seeds: [0]}"):
                code, _, text = live.client.req("POST", "/v1/jobs", body=body)
                got.append((code, _error_doc(text)))
            docs[pkg] = got
    assert docs["port"] == docs["ref"]
    assert [c for c, _ in docs["port"]] == [400, 429, 400]


def test_http_drop_fault_is_a_structured_503(tmp_path):
    from shadow_tpu_torch.runtime import chaos

    plan = chaos.FaultPlan(seed=0, faults=[chaos.parse_fault_arg("http-drop@0")])
    with chaos.installed(plan):
        with _port_daemon(tmp_path / "spool", poll_interval_s=0.2, http="127.0.0.1:0",
                          persist_cache=False) as live:
            code, hdr, body = live.client.req("GET", "/v1/metrics")
            assert code == 503 and json.loads(body)["error"]["reason"] == "http-drop"
            assert int(hdr["Retry-After"]) >= 1
            code, _, text = live.client.req("GET", "/v1/metrics")
            assert code == 200 and "shadow_tpu_daemon_uptime_seconds" in text
    assert plan.report()["fired"] == [{"kind": "http-drop", "at": 0}]


def test_fleet_takes_over_a_killed_daemons_claim(tmp_path, alone):
    """A daemon is SIGKILLed holding a batch's claim; two daemons then
    drain the spool together: the claim is stolen once its lease
    expires, and every job ends done exactly once, equal to its
    standalone run."""
    spool = tmp_path / "spool"
    inc = spool / "incoming"
    inc.mkdir(parents=True)
    for i, (tenant, name) in enumerate((("alice", "a"), ("bob", "b"), ("carol", "c"))):
        p = inc / f"{i:020d}-{tenant}.yaml"
        tmp = inc / f".{p.name}.tmp"
        tmp.write_text(_spec_text(tenant, name, [0, 1]))
        os.replace(tmp, p)
    cache = str(tmp_path / "cache")
    r = serve_subprocess(spool, "--cache-dir", cache, "--daemon-id", "fleet-0",
                         "--chaos-fault", "daemon-kill@2:target=chunk")
    assert r.returncode in (-9, 137), r.stderr[-800:]
    assert list((spool / "claims").glob("claim-*.json"))

    env = dict(os.environ, OMP_NUM_THREADS="1")

    def serve(daemon_id):
        return subprocess.Popen(
            [sys.executable, "-m", "shadow_tpu_torch", "serve", str(spool), "--drain",
             "--device", "cpu", "--poll-interval", "0.2", "--lease-s", "2",
             "--daemon-id", daemon_id, "--cache-dir", cache],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    fleet = [serve("fleet-1"), serve("fleet-2")]
    try:
        outs = [d.communicate(timeout=WAIT_S)[0] for d in fleet]
    finally:
        for d in fleet:
            if d.poll() is None:
                d.kill()
                d.wait()
    assert [d.returncode for d in fleet] == [0, 0], [o[-800:] for o in outs]
    recs = journal(spool)
    done = [r["job"] for r in recs if r["type"] == "job-done"]
    want = [f"{t}.{n}-s{s}" for t, n in (("alice", "a"), ("bob", "b"), ("carol", "c"))
            for s in (0, 1)]
    assert sorted(done) == sorted(set(done)) == want
    steals = [r for r in recs if r["type"] == "claim-steal"]
    assert [s["from_owner"] for s in steals] == ["fleet-0"]
    assert steals[0]["owner"] in ("fleet-1", "fleet-2")
    assert not list((spool / "claims").glob("claim-*.json"))
    shutdowns = [r for r in recs if r["type"] == "shutdown"]
    assert len(shutdowns) == 2 and all(r["clean"] for r in shutdowns)
    for name in ("alice.a-s0", "bob.b-s0", "carol.c-s0"):
        assert job_stats(spool, name) == alone(0), name
