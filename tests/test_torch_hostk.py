"""The port's host kernel (shadow_tpu_torch/hostk/) against the JAX
package's: the same guests on the same seed give the same guest stdout
and strace files, the same packet event log, the same pcap bytes and the
same stats, on the serial kernel (no device). Also the threefry helpers
the kernel draws through (uniform_block, raw_bytes, bernoulli) and the
pcap writer. Guest-execution tests skip, with the reason, only when a
trivial guest cannot run under the port's LD_PRELOAD shim here (the probe
tests/conftest.py makes for the JAX package, made through the port)."""

import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadow_tpu import rng as j_rng
from shadow_tpu.graph import NetworkGraph as JNetworkGraph
from shadow_tpu.graph import compute_routing as j_compute_routing
from shadow_tpu.hostk.kernel import NetKernel as JNetKernel
from shadow_tpu.hostk.kernel import ProcessSpec as JProcessSpec
from shadow_tpu.utils import pcap as j_pcap
from shadow_tpu_torch import rng
from shadow_tpu_torch.graph import NetworkGraph, compute_routing
from shadow_tpu_torch.hostk.kernel import NetKernel, ProcessSpec
from shadow_tpu_torch.simtime import NS_PER_MS, NS_PER_SEC
from shadow_tpu_torch.utils import pcap

REPO = pathlib.Path(__file__).resolve().parent.parent
GUESTS = REPO / "tests" / "guests"
W = 1 * NS_PER_MS  # the two-node graph's least latency (the self-loops)

_PROBE = r"""
import pathlib, subprocess, sys, tempfile
sys.path.insert(0, sys.argv[1])
from shadow_tpu_torch.graph import NetworkGraph, compute_routing
from shadow_tpu_torch.hostk.kernel import NetKernel, ProcessSpec
tmp = pathlib.Path(tempfile.mkdtemp(prefix="shim-probe-torch-"))
(tmp / "guest.c").write_text("int main(void) { return 0; }\n")
subprocess.run(["cc", "-O0", "-o", str(tmp / "guest"), str(tmp / "guest.c")], check=True)
graph = NetworkGraph.from_gml(
    'graph [ directed 0 node [ id 0 ] edge [ source 0 target 0 latency "1 ms" ] ]')
tables = compute_routing(graph, device="cpu").with_hosts([0])
k = NetKernel(tables, host_names=["h"], host_nodes=[0], seed=1, data_dir=tmp / "data")
p = k.add_process(ProcessSpec(host="h", args=[str(tmp / "guest")]))
try:
    k.run(1_000_000_000)
finally:
    k.shutdown()
print("GUEST_OK" if p.exit_code == 0
      else f"GUEST_BAD: trivial guest exited {p.exit_code} (state {p.state}) under the shim")
"""


def port_guest_reason() -> "str | None":
    """None when a trivial guest runs under the port's kernel here; else
    the skip reason (a subprocess, so a hung guest cannot wedge the run)."""
    try:
        r = subprocess.run([sys.executable, "-c", _PROBE, str(REPO)], capture_output=True,
                           text=True, timeout=180)
    except subprocess.TimeoutExpired:
        return "managed-guest probe hung (>180s): guest never completed"
    if "GUEST_OK" in r.stdout:
        return None
    bad = [ln for ln in r.stdout.splitlines() if ln.startswith("GUEST_BAD")]
    tail = bad or (r.stdout + r.stderr).strip().splitlines()
    detail = tail[-1][:200] if tail else f"rc={r.returncode}"
    return ("managed-guest (LD_PRELOAD shim) execution does not work in this "
            f"environment: {detail}")


def build_guests(out: pathlib.Path, names) -> dict:
    built = {}
    for name in names:
        dst = out / name
        subprocess.run(["cc", "-O2", "-o", str(dst), str(GUESTS / f"{name}.c")], check=True)
        built[name] = str(dst)
    return built


@pytest.fixture(scope="module")
def bins(tmp_path_factory):
    reason = port_guest_reason()
    if reason is not None:
        pytest.skip(reason)
    return build_guests(tmp_path_factory.mktemp("guests"),
                        ("tcp_echo_server", "tcp_client", "udp_blast"))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def two_node_gml(latency_ms=10, loss=0.0) -> str:
    """tests/topo.py::two_node_graph as GML: 1 ms self-loops and one
    lossy inter-node edge."""
    return "\n".join([
        "graph [", "  directed 0", "  node [ id 0 ]", "  node [ id 1 ]",
        '  edge [ source 0 target 0 latency "1 ms" ]',
        '  edge [ source 1 target 1 latency "1 ms" ]',
        f'  edge [ source 0 target 1 latency "{latency_ms} ms" packet_loss {loss} ]',
        "]",
    ])


def tables_pair(host_nodes, loss=0.0, latency_ms=10):
    """(JAX tables, port tables on the CPU) of the two-node graph."""
    gml = two_node_gml(latency_ms, loss)
    j = j_compute_routing(JNetworkGraph.from_gml(gml)).with_hosts(host_nodes)
    t = compute_routing(NetworkGraph.from_gml(gml), device="cpu").with_hosts(host_nodes)
    return j, t


def data_files(d: pathlib.Path) -> dict:
    """Every file under a data directory (guest stdout/stderr, strace,
    pcap, hosts) by relative path, as bytes."""
    return {str(p.relative_to(d)): p.read_bytes() for p in sorted(d.rglob("*")) if p.is_file()}


def outcome(k, procs, data_dir) -> dict:
    """What a kernel run shows: guest stdout, exit codes and syscall
    sequences, the event log as a time-sorted multiset, the stats, and
    the data directory's files."""
    return {
        "guests": [(p.host.name, p.stdout(), p.exit_code, [s for _, s, _ in p.syscall_log])
                   for p in procs],
        "events": sorted(k.event_log),
        "stats": k.stats(),
        "files": data_files(pathlib.Path(data_dir)),
    }


# --- the threefry helpers -------------------------------------------------


@pytest.mark.parametrize("what", ["uniform_block", "raw_bytes", "bernoulli"])
def test_draw_helpers_match_reference(what):
    """Bit-equal to shadow_tpu/rng.py, counters crossing 2**32 included
    (the reference's counters are u32: a block past 2**32 - 1 wraps)."""
    jkeys, tkeys = j_rng.host_keys(11, 5), rng.host_keys(11, 5)
    starts = (0, 7, 2**32 - 3, 2**32 - 1)
    for h in range(5):
        for c in starts:
            if what == "uniform_block":
                want = np.asarray(j_rng.uniform_block(jkeys[h], jnp.uint32(c), 512))
                got = rng.uniform_block(tkeys[h], c, 512).numpy()
                np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
            elif what == "raw_bytes":
                for n in (1, 16, 257):
                    assert rng.raw_bytes(tkeys[h], c, n) == j_rng.raw_bytes(jkeys[h], c, n)
    if what == "bernoulli":
        ctr = np.array([0, 3, 2**32 - 1, 9, 2**31], np.uint32)
        p = np.array([0.5, 0.1, 0.9, 0.3, 0.97], np.float32)
        want = np.asarray(j_rng.bernoulli(jkeys, jnp.asarray(ctr), jnp.asarray(p)))
        got = rng.bernoulli(tkeys, torch.from_numpy(ctr.astype(np.int64)), torch.from_numpy(p))
        np.testing.assert_array_equal(got.numpy(), want)


def test_pcap_bytes_match_reference(tmp_path):
    """The writer makes the same files: UDP and TCP frames, a payload
    past the IPv4 length limit, times past one second."""

    class Seg:
        src_ip, dst_ip, src_port, dst_port = 0x0B000001, 0x0B000002, 10_000, 80
        seq, ack, flags, wnd, payload = 2**32 + 5, 77, 1 | 2, 70_000, b"hello"

    for mod, name in ((j_pcap, "ref"), (pcap, "port")):
        d = mod.PcapDir(tmp_path / name, ["a", "b"])
        d.udp("a", 1_500_000_123, 0x0B000001, 5, 0x0B000002, 7000, b"x" * 1200)
        d.tcp("b", 2 * NS_PER_SEC + 9, Seg())
        d.udp("a", 3 * NS_PER_SEC, 1, 2, 3, 4, b"y" * 65_520)
        d.udp("nobody", 1, 1, 2, 3, 4, b"z")
        d.close()
    ref, port = data_files(tmp_path / "ref"), data_files(tmp_path / "port")
    assert sorted(ref) == ["a/eth0.pcap", "b/eth0.pcap"]
    assert port == ref


# --- the serial kernel ----------------------------------------------------


def _tcp_world(k, bins, spec_cls, nbytes):
    return [
        k.add_process(spec_cls(host="server", args=[bins["tcp_echo_server"], "8080", "1"])),
        k.add_process(spec_cls(host="client", args=[bins["tcp_client"], "server", "8080",
                                                    str(nbytes)], start_ns=100 * NS_PER_MS)),
    ]


def _blast_world(k, bins, spec_cls, count=50, size=1200):
    return [
        k.add_process(spec_cls(host="server", args=[bins["udp_blast"], "sink", "7000",
                                                    str(count)])),
        k.add_process(spec_cls(host="client", args=[bins["udp_blast"], "send", "11.0.0.1",
                                                    "7000", str(count), str(size)],
                               start_ns=100 * NS_PER_MS)),
    ]


# (loss, seed, bw_down, world, until_s, pcap)
SERIAL_WORLDS = {
    "tcp": (0.0, 1, (0, 0), "tcp", 60, True),
    "tcp_loss": (0.03, 1, (0, 0), "tcp", 120, False),
    "udp_shaped": (0.0, 3, (1_000_000, 0), "blast", 30, True),
}


def run_serial(package, bins, data_dir, world):
    loss, seed, bw_down, kind, until_s, use_pcap = SERIAL_WORLDS[world]
    jt, tt = tables_pair([0, 1], loss)
    kcls, scls, tables = (JNetKernel, JProcessSpec, jt) if package == "ref" else (
        NetKernel, ProcessSpec, tt)
    k = kcls(tables, host_names=["server", "client"], host_nodes=[0, 1], seed=seed,
             data_dir=data_dir, window_ns=W, bw_up_bits=[0, 0], bw_down_bits=list(bw_down),
             pcap=use_pcap)
    procs = (_tcp_world(k, bins, scls, 50_000) if kind == "tcp"
             else _blast_world(k, bins, scls))
    try:
        k.run(until_s * NS_PER_SEC)
    finally:
        k.shutdown()
    return outcome(k, procs, data_dir)


@pytest.mark.parametrize("world", sorted(SERIAL_WORLDS))
def test_serial_kernel_matches_reference(tmp_path, bins, world):
    """tcp echo (with pcap), tcp under 3% loss, a shaped UDP blast (CoDel
    drops, with pcap): every observable equal."""
    want = run_serial("ref", bins, tmp_path / "ref", world)
    got = run_serial("port", bins, tmp_path / "port", world)
    if world.startswith("tcp"):
        assert b"echoed 50000/50000 bytes" in got["guests"][1][1]
    if world == "tcp_loss":
        assert got["stats"]["packets_dropped"] > 0
    if SERIAL_WORLDS[world][5]:
        assert any(name.endswith(".pcap") and len(b) > 24 for name, b in got["files"].items())
    assert got == want
