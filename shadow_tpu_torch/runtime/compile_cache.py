"""Fingerprint-keyed compile cache: N same-shape jobs, one build (port of
shadow_tpu/runtime/compile_cache.py).

The sweep scheduler (runtime/sweep.py) runs many jobs whose configs
differ only in seed: the same world, the same chunk program. The
reference compiles each distinct world once with XLA and reuses the
executable across every batch that shares it. The port has no XLA: what
it does once per distinct world is to prepare the ensemble chunk for
that state signature and static cfg (engine/ensemble.py
lower_ensemble_chunk): resolve the engine, load the pump kernel's
library where the chunk runs the kernel (nvcc at first use, then the
build directory) and check the kernel's launch at those shapes (its
argument struct over the batch's rows and its dynamic shared memory).
That preparation is the "build" this cache times and counts, as the
reference times and counts a compile:

  * the user-facing key is the config fingerprint modulo seed plus
    rounds_per_chunk (what the sweep spec can distinguish);
  * the cache appends the state's shape/dtype signature, the canonical
    static EngineConfig (engine/state.py trace_static_cfg) and the
    state's device to every key, so even a too-coarse caller key never
    aliases two worlds: a regrown replay keys its own entry;
  * `misses` counts builds, `hits` counts prepared chunks reused, and the
    sweep manifest publishes both (8 same-shape jobs: one build).

`CompileCache` is one cache per SweepService. `PersistentCompileCache`
adds a disk tier for the daemon (runtime/daemon.py), keeping the
reference's entry format: a one-line JSON header (`format`, `runtime`,
`sha256` of the payload, `bytes`) and the payload, written atomically;
a corrupt, truncated, wrong-runtime or undeserializable entry is
evicted and rebuilt with a warning, never a crash (the `cache-corrupt`
chaos fault pins this). `runtime` is `torch-<version>/cpu`, or
`torch-<version>/cuda-<card name>-sm<major><minor>-cuda<toolkit>` on the
card: a library built for one card and toolkit is loadable only there.

A mesh batch (runtime/mesh.py) keys its prepared grid chunk
(engine/sharded.py GridChunk, from engine/mesh.py lower_mesh_chunk) under
(key, "mesh", rows, shards, rounds_per_chunk): one build per world and
grid, the kernel's library loaded once for all the grid's shards.

The payload is the pickled prepared chunk (its model, canonical static
cfg, rounds per chunk, engine, and on the card the kernel instance, its
dynamic shared memory and the library's tag: its TCP shape and source
digest) and, where the chunk runs the kernel, the built library's bytes
(the library of the model's shape). A restarted daemon's
disk hit puts those bytes where the kernel loads its library
(engine/megakernel.py install_library) and loads it: no nvcc. On the
CPU there is nothing to load: the entry carries the chunk's record.
"""

from __future__ import annotations

import hashlib
import json
import os
import pickle
import time

import torch

from shadow_tpu_torch.utils.shadow_log import slog

# bumped when the on-disk entry layout changes; a mismatch is a skip
# (rebuild), never an error
CACHE_FORMAT = 1


def _leaves(tree) -> list:
    """The leaves of a state (a dataclass of tensors), a dict (sorted
    keys, as jax.tree.leaves orders them), a list or a tuple."""
    import dataclasses

    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        from shadow_tpu_torch.utils.tree import tree_leaves_with_path

        return [leaf for _, leaf in tree_leaves_with_path(tree)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [] if tree is None else [tree]


def _dtype_name(dtype) -> str:
    # torch spells its dtypes "torch.int64", numpy and jax "int64"
    return str(dtype).removeprefix("torch.")


def state_signature(st) -> tuple:
    """Shape/dtype signature of a state: the part of the cache key the
    fingerprint does not cover once buffers have been regrown past their
    config values (rollback-and-regrow)."""
    sig = []
    for leaf in _leaves(st):
        try:
            sig.append((tuple(leaf.shape), _dtype_name(leaf.dtype)))
        except (AttributeError, TypeError):
            sig.append((None, str(type(leaf).__name__)))
    return tuple(sig)


def _state_device(st) -> "str | None":
    for leaf in _leaves(st):
        if isinstance(leaf, torch.Tensor):
            return leaf.device.type
    return None


class CompileCache:
    """Prepared-chunk cache and build accounting.

    `get(key, st, static_cfg, build)` returns the cached entry for
    (key, static cfg, shapes(st), device of st) or builds one via
    `build()` (timed, counted as a miss). `stats()` is the block the
    sweep manifest publishes.
    """

    def __init__(self):
        self._entries: dict = {}
        self.hits = 0
        self.misses = 0
        self.compile_seconds = 0.0
        self.compile_walls: "list[float]" = []
        # the entries this cache built, for their memory figures
        # (memtrack.compiled_memory: the allocator's peak over the build
        # and the first launch, known only after that launch)
        self._built: list = []

    def _full_key(self, key, st, static_cfg) -> tuple:
        return (key, static_cfg, state_signature(st), _state_device(st))

    def get(self, key, st, static_cfg, build):
        """The entry for this (caller key, static cfg, state shapes,
        device), built at most once per distinct full key. `build()`
        returns it (e.g. lower_ensemble_chunk(...))."""
        from shadow_tpu_torch.runtime import flightrec, memtrack

        fk = self._full_key(key, st, static_cfg)
        exe = self._entries.get(fk)
        if exe is not None:
            self.hits += 1
            flightrec.record_event("compile_cache", hit=True)
            return exe
        exe = self._load_persisted(fk)
        if exe is not None:
            # a disk hit is a hit: zero builds across daemon restarts
            self.hits += 1
            self._entries[fk] = exe
            flightrec.record_event("compile_cache", hit=True, tier="disk")
            return exe
        t0 = time.perf_counter()
        exe = build()
        wall = time.perf_counter() - t0
        self.misses += 1
        self.compile_seconds += wall
        self.compile_walls.append(round(wall, 4))
        self._entries[fk] = exe
        self._built.append(exe)
        # a miss's build wall and, on the card, the allocator's peak over
        # the build (the first launch comes later) are an event in the
        # metrics stream
        ev = {"hit": False, "wall_s": round(wall, 4)}
        mem = memtrack.compiled_memory(exe)
        if mem and mem.get("peak_bytes"):
            ev["peak_hbm_bytes"] = int(mem["peak_bytes"])
        flightrec.record_event("compile_cache", **ev)
        self._persist(fk, exe)
        return exe

    # the disk-tier seams PersistentCompileCache fills in
    def _load_persisted(self, fk):
        return None

    def _persist(self, fk, exe) -> None:
        pass

    @property
    def compiles(self) -> int:
        return self.misses

    @property
    def compile_peaks(self) -> "list[int]":
        """The allocator's peak over each built entry's build and first
        launch, where the card reports it (empty on the CPU)."""
        from shadow_tpu_torch.runtime import memtrack

        peaks = []
        for exe in self._built:
            mem = memtrack.compiled_memory(exe)
            if mem and mem.get("peak_bytes"):
                peaks.append(int(mem["peak_bytes"]))
        return peaks

    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def stats(self) -> dict:
        out = {
            "compiles": self.misses,
            "hits": self.hits,
            "hit_rate": round(self.hit_rate(), 4),
            "compile_seconds": round(self.compile_seconds, 4),
            "compile_walls": self.compile_walls,
        }
        peaks = self.compile_peaks
        if peaks:
            out["peak_hbm_bytes"] = max(peaks)
            out["compile_peaks"] = peaks
        return out


def runtime_version(device) -> str:
    """What a persisted entry is loadable by: the torch version and the
    device, down to the card's name, compute capability and CUDA
    toolkit."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return f"torch-{torch.__version__}/{dev.type}"
    major, minor = torch.cuda.get_device_capability(dev)
    return (f"torch-{torch.__version__}/cuda-{torch.cuda.get_device_name(dev)}"
            f"-sm{major}{minor}-cuda{torch.version.cuda}")


def serialize_chunk(exe) -> bytes:
    """The payload of a prepared chunk (module docstring): the chunk
    itself (an ensemble's, or a mesh's with its grid of logical devices)
    and, where it runs the kernel, the library's bytes."""
    from shadow_tpu_torch.engine.ensemble import EnsembleChunk
    from shadow_tpu_torch.engine.sharded import GridChunk

    if isinstance(exe, GridChunk):
        chunk = GridChunk(exe.model, exe.cfg, exe.rounds_per_chunk, exe.grid, exe.engine)
        chunk.instance, chunk.dynamic_smem = exe.instance, exe.dynamic_smem
        chunk.library_tag = exe.library_tag
    elif isinstance(exe, EnsembleChunk):
        chunk = EnsembleChunk(exe.model, exe.cfg, exe.rounds_per_chunk, exe.engine,
                              exe.instance, exe.dynamic_smem, exe.library_tag)
    else:
        raise TypeError(f"{type(exe).__name__} is not a prepared ensemble or mesh chunk")
    library = None
    if exe.library_tag is not None:
        from shadow_tpu_torch.engine.megakernel import PUMP_KERNEL, tcp_shape

        shape = tcp_shape(exe.model)
        if exe.library_tag != PUMP_KERNEL.tag(shape):
            raise ValueError("the kernel's source changed since this chunk was prepared")
        library = PUMP_KERNEL.library_path(shape).read_bytes()
    return pickle.dumps({"chunk": chunk, "library": library})


def deserialize_and_load(payload: bytes):
    """A persisted chunk, ready to run: its library (when it has one) put
    where the kernel loads it and loaded, so no nvcc runs."""
    doc = pickle.loads(payload)
    chunk, library = doc["chunk"], doc["library"]
    if library is not None:
        from shadow_tpu_torch.engine.megakernel import PUMP_KERNEL, tcp_shape

        shape = tcp_shape(chunk.model)
        if chunk.library_tag != PUMP_KERNEL.tag(shape):
            raise ValueError(
                f"library built from kernel source {chunk.library_tag}, this checkout "
                f"builds {PUMP_KERNEL.tag(shape)}")
        PUMP_KERNEL.install_library(library, shape)
        PUMP_KERNEL.library(shape)
    return chunk


class PersistentCompileCache(CompileCache):
    """CompileCache with a disk tier under `cache_dir` (the daemon's
    cross-restart cache), entries for `device`.

    Entry layout: one file per full key, named by the sha-256 of the
    key's repr: a one-line JSON header (format version, runtime_version,
    the sha-256 of the payload) followed by the payload (serialize_chunk).
    Writes are atomic (tmp + rename).

    Every degradation is survivable by construction: an unreadable,
    truncated, digest-mismatched or runtime-mismatched entry, and an
    entry that does not load, logs one warning and falls back to a
    normal build; a bad entry is also evicted so the rebuild re-stores
    it. A daemon fleet shares one cache_dir: `_persist` keeps a peer's
    already-committed entry instead of overwriting it (a peer skip).
    `stats()` gains a `persistent` block (disk_hits / disk_stores /
    disk_skips / disk_peer_skips)."""

    def __init__(self, cache_dir: str, device="cuda"):
        super().__init__()
        self.cache_dir = cache_dir
        self.disk_hits = 0
        self.disk_stores = 0
        self.disk_skips = 0  # corrupt/mismatched/unserializable entries
        self.disk_peer_skips = 0  # stores skipped: a fleet peer beat us
        self.runtime_version = runtime_version(device)
        os.makedirs(cache_dir, exist_ok=True)

    def _entry_path(self, fk) -> str:
        digest = hashlib.sha256(repr(fk).encode()).hexdigest()
        return os.path.join(self.cache_dir, f"exe-{digest[:32]}.bin")

    def _evict(self, path: str) -> None:
        """Drop a bad entry so the rebuild's `_persist` re-stores a fresh
        copy instead of peer-skipping the corpse (a fleet shares this
        directory: the existence check must mean 'good entry')."""
        try:
            os.remove(path)
        except OSError:
            pass

    def _load_persisted(self, fk):
        path = self._entry_path(fk)
        if not os.path.exists(path):
            return None
        try:
            with open(path, "rb") as f:
                header = json.loads(f.readline())
                payload = f.read()
        except (OSError, ValueError):
            self.disk_skips += 1
            self._evict(path)
            slog("warning", 0, "cache",
                 f"persistent compile-cache entry {path} is unreadable "
                 "(corrupt or truncated); rebuilding")
            return None
        if not isinstance(header, dict):
            header = {}
        if header.get("format") != CACHE_FORMAT or (
            header.get("runtime") != self.runtime_version
        ):
            self.disk_skips += 1
            self._evict(path)
            slog("warning", 0, "cache",
                 f"persistent compile-cache entry {path} was written by "
                 f"{header.get('runtime')!r} format {header.get('format')!r} "
                 f"(this runtime is {self.runtime_version!r} format "
                 f"{CACHE_FORMAT}); rebuilding")
            return None
        if hashlib.sha256(payload).hexdigest() != header.get("sha256"):
            self.disk_skips += 1
            self._evict(path)
            slog("warning", 0, "cache",
                 f"persistent compile-cache entry {path} failed its "
                 "sha-256 integrity check; rebuilding")
            return None
        try:
            exe = deserialize_and_load(payload)
        except Exception as e:  # noqa: BLE001 — any load failure = rebuild
            self.disk_skips += 1
            self._evict(path)
            slog("warning", 0, "cache",
                 f"persistent compile-cache entry {path} failed to "
                 f"deserialize ({type(e).__name__}: {str(e)[:120]}); "
                 "rebuilding")
            return None
        self.disk_hits += 1
        return exe

    def _persist(self, fk, exe) -> None:
        from shadow_tpu_torch.runtime import chaos

        path = self._entry_path(fk)
        if os.path.exists(path):
            # a fleet peer sharing this cache_dir stored the entry while
            # we were building; any existing entry passed its own
            # integrity gates when written, and corrupt ones are evicted
            # on load: keep it
            self.disk_peer_skips += 1
            return
        try:
            payload = serialize_chunk(exe)
        except Exception as e:  # noqa: BLE001 — persistence is best-effort
            self.disk_skips += 1
            slog("warning", 0, "cache",
                 f"entry for key {repr(fk)[:60]}… does not serialize "
                 f"({type(e).__name__}: {str(e)[:120]}); "
                 "it will be rebuilt after a restart")
            return
        header = {
            "format": CACHE_FORMAT,
            "runtime": self.runtime_version,
            "sha256": hashlib.sha256(payload).hexdigest(),
            "bytes": len(payload),
        }
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "wb") as f:
                f.write(json.dumps(header).encode() + b"\n")
                f.write(payload)
            os.replace(tmp, path)
        except OSError as e:
            self.disk_skips += 1
            slog("warning", 0, "cache",
                 f"could not persist compile-cache entry {path}: {e}")
            return
        self.disk_stores += 1
        # chaos seam (runtime/chaos.py `cache-corrupt`): damage lands
        # after the atomic commit, bit-rot on a fully written entry,
        # which is exactly what the sha-256 check must catch
        if chaos.fire("cache-corrupt", at=self.disk_stores - 1) is not None:
            chaos.damage_file(path, truncate=False)

    def stats(self) -> dict:
        out = super().stats()
        out["persistent"] = {
            "dir": self.cache_dir,
            "runtime": self.runtime_version,
            "disk_hits": self.disk_hits,
            "disk_stores": self.disk_stores,
            "disk_skips": self.disk_skips,
            "disk_peer_skips": self.disk_peer_skips,
        }
        return out
