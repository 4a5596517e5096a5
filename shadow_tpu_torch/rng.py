"""Deterministic per-host randomness, counter-based (port of shadow_tpu/rng.py).

Every host owns a threefry key fold_in(key(seed), host_id) and a draw
counter; logical draw #c of host h is a pure function of (seed, h, c).
This module reproduces jax's threefry2x32 bit for bit, as jax 0.9.0 runs
it with `jax_threefry_partitionable=True`:

  key(seed)          = (seed >> 32, seed & 0xFFFFFFFF)
  fold_in(key, d)    = threefry2x32(key, (0, d))
  uniform_f32(key)   = f32 from bits = b0 ^ b1 of threefry2x32(key, (0, 0)):
                       bitcast(bits >> 9 | 0x3F800000) - 1.0

Keys are int64 tensors [..., 2] holding the two u32 key words; u32
arithmetic is emulated in int64 masked to 32 bits. The CUDA kernel
(csrc/pump_megakernel.cu) carries the same functions as device code.
"""

from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k0, k1, x0, x1):
    """The 20-round threefry2x32 block on broadcastable int64 tensors of
    u32 values. Returns (y0, y1)."""
    k2 = (k0 ^ k1 ^ _PARITY) & MASK32
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & MASK32
    x1 = (x1 + k1) & MASK32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK32
    return x0, x1


def key(seed: int, device="cpu") -> torch.Tensor:
    """jax.random.key(seed) as key data: int64 [2]."""
    s = int(seed) % (1 << 64)
    return torch.tensor([s >> 32, s & MASK32], dtype=torch.int64, device=device)


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """[..., 2] keys folded with u32 data (broadcast against keys[..., 0])."""
    if not isinstance(data, torch.Tensor):
        data = torch.as_tensor(data, dtype=torch.int64, device=keys.device)
    d = data.to(torch.int64) & MASK32
    y0, y1 = threefry2x32(keys[..., 0], keys[..., 1], torch.zeros_like(d), d)
    return torch.stack([y0, y1], dim=-1)


def host_keys(seed: int, num_hosts: int, device="cpu") -> torch.Tensor:
    """[H, 2] per-host base keys derived from the global seed."""
    base = key(seed, device)
    hosts = torch.arange(num_hosts, dtype=torch.int64, device=device)
    return fold_in(base.expand(num_hosts, 2), hosts)


def replica_keys(base_seed: int, num_replicas: int, num_hosts: int, stride: int = 1,
                 device="cpu") -> torch.Tensor:
    """[R, H, 2] per-host base keys of an R-replica ensemble: row r is
    exactly host_keys(base_seed + r * stride, H), the one place where a
    replica's seed enters its state."""
    if num_replicas < 1:
        raise ValueError("num_replicas must be >= 1")
    if stride < 1:
        raise ValueError(
            "replica seed stride must be >= 1 (stride 0 would alias every "
            "replica onto the same stream)"
        )
    return torch.stack(
        [host_keys(base_seed + r * stride, num_hosts, device) for r in range(num_replicas)]
    )


def _bits32(keys: torch.Tensor) -> torch.Tensor:
    """random_bits(key, 32, ()) under the partitionable scheme."""
    z = torch.zeros_like(keys[..., 0])
    b0, b1 = threefry2x32(keys[..., 0], keys[..., 1], z, z)
    return b0 ^ b1


def _bits_to_unit_f32(bits: torch.Tensor) -> torch.Tensor:
    fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return fbits.view(torch.float32) - 1.0


def uniform_f32(keys: torch.Tensor, counters: torch.Tensor) -> torch.Tensor:
    """[H] uniforms in [0, 1) for draw #counter of each host."""
    return _bits_to_unit_f32(_bits32(fold_in(keys, counters)))


def uniform_f32_grid(keys: torch.Tensor, counters: torch.Tensor) -> torch.Tensor:
    """[H, L] uniforms: draw #counters[h, l] of host h (same per-counter
    values as uniform_f32)."""
    return _bits_to_unit_f32(_bits32(fold_in(keys[:, None, :], counters)))


def bernoulli(keys: torch.Tensor, counters: torch.Tensor, p) -> torch.Tensor:
    """[H] bools, True with probability p (one draw per host)."""
    return uniform_f32(keys, counters) < p


def uniform_block(key: torch.Tensor, start, n: int) -> torch.Tensor:
    """[n] uniforms for draws #start..start+n of ONE host key ([2]): the
    same values per counter as uniform_f32. The counter is u32, as in the
    reference, so a block that crosses 2**32 wraps to draw #0."""
    start = torch.as_tensor(start, dtype=torch.int64, device=key.device)
    counters = (start + torch.arange(n, dtype=torch.int64, device=key.device)) & MASK32
    return uniform_f32(key.expand(n, 2), counters)


def raw_bytes(key: torch.Tensor, counter: int, n: int) -> bytes:
    """n deterministic bytes for draw #counter of one host key:
    jax.random.bits(fold_in(key, counter), (n,), uint8), whose byte i is
    the low byte of b0 ^ b1 of threefry2x32(k, (0, i))."""
    k = fold_in(key, int(counter) & MASK32)
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    b0, b1 = threefry2x32(k[0], k[1], torch.zeros_like(i), i)
    return ((b0 ^ b1) & 0xFF).to(torch.uint8).cpu().numpy().tobytes()


def uniform_int(keys: torch.Tensor, counters: torch.Tensor, lo, hi) -> torch.Tensor:
    """[H] int64 in [lo, hi): jax.random.randint(fold_in(key, counter),
    (), lo, hi, int64), one draw per host. With Python int bounds whose
    span is below 2**31 (every model's draws) the u64 remainder runs on
    the tensors' device in int64, each product below 2**62; other bounds
    take the same arithmetic in numpy u64 on the host."""
    ks = fold_in(keys, counters)
    z = torch.zeros_like(ks[..., 0])
    one = torch.ones_like(z)
    halves = []
    for c in (z, one):  # split(key) -> counts (0, 0) and (0, 1)
        s0, s1 = threefry2x32(ks[..., 0], ks[..., 1], z, c)
        halves.append(threefry2x32(s0, s1, z, z))
    if isinstance(lo, int) and isinstance(hi, int) and hi - lo < (1 << 31):
        span = hi - lo if hi > lo else 1
        r32 = (1 << 32) % span
        mult = (r32 * r32) % span

        def mod_u64(words):  # (hi32 * 2**32 + lo32) % span
            w_hi, w_lo = words
            return ((w_hi % span) * r32 + w_lo % span) % span

        higher, lower = (mod_u64(w) for w in halves)
        return lo + (higher * mult + lower) % span
    higher, lower = (
        (b0.cpu().numpy().astype(np.uint64) << np.uint64(32)) | b1.cpu().numpy().astype(np.uint64)
        for b0, b1 in halves
    )
    h = ks.shape[0]
    lo_a = np.broadcast_to(np.asarray(lo, np.int64), (h,))
    hi_a = np.broadcast_to(np.asarray(hi, np.int64), (h,))
    with np.errstate(over="ignore"):
        span = (hi_a - lo_a).astype(np.uint64)
        span = np.where(hi_a <= lo_a, np.uint64(1), span)
        mult = np.uint64(1 << 32) % span
        mult = (mult * mult) % span
        off = ((higher % span) * mult + (lower % span)) % span
        out = lo_a + off.astype(np.int64)
    return torch.from_numpy(np.ascontiguousarray(out)).to(ks.device)


def exponential_ns(keys: torch.Tensor, counters: torch.Tensor, mean_ns) -> torch.Tensor:
    """[H] int64 ~ Exp(mean_ns), truncated to ns (one draw per host): the
    f32 Exp(1) draw -log1p(-u) of uniform_f32, times mean_ns in f64.
    f32 log1p is not bit-identical across backends (nor is the
    reference's), so equal within a backend and within 1 ulp of the f32
    draw across them."""
    u = uniform_f32(keys, counters)
    draw = -torch.log1p(-u)  # finite: u < 1
    mean = torch.as_tensor(mean_ns, dtype=torch.float64, device=draw.device)
    return (draw.to(torch.float64) * mean).to(torch.int64)
