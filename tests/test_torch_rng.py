"""threefry2x32 in the port equals jax's bit for bit (jax 0.9.0,
jax_threefry_partitionable=True): host keys, fold_in, the f32 uniforms
and randint, over many counters including ones near 2**32. Exact
equality: every value is an integer or an f32 built by exact ops."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadow_tpu import rng as R
from shadow_tpu_torch import rng as T


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run next to other test processes (pytest-xdist): keep
    torch to one intra-op thread so they do not crowd the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _keys(n, seed):
    return np.random.default_rng(seed).integers(0, 2**32, (n, 2), dtype=np.uint64).astype(np.uint32)


def _counters(n, seed):
    c = np.random.default_rng(seed).integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    c[:6] = [0, 1, 2**31, 2**32 - 3, 2**32 - 2, 2**32 - 1]
    return c


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


@pytest.mark.parametrize("seed", [0, 1, 7, 11, 2**31 + 9, 2**32 + 5, 2**40 + 3])
def test_host_keys(seed):
    want = np.asarray(jax.random.key_data(R.host_keys(seed, 257)))
    got = T.host_keys(seed, 257).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


def test_fold_in():
    kd = _keys(300, 1)
    data = _counters(300, 2)
    keys = jax.random.wrap_key_data(jnp.asarray(kd))
    want = np.asarray(
        jax.random.key_data(jax.vmap(jax.random.fold_in)(keys, jnp.asarray(data)))
    )
    np.testing.assert_array_equal(T.fold_in(_t(kd), _t(data)).numpy(), want.astype(np.int64))


@pytest.mark.parametrize("seed", [3, 11])
def test_uniform_f32(seed):
    keys = R.host_keys(seed, 512)
    c = _counters(512, seed)
    want = np.asarray(R.uniform_f32(keys, jnp.asarray(c)))
    got = T.uniform_f32(T.host_keys(seed, 512), _t(c)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert (got >= 0).all() and (got < 1).all()


def test_uniform_f32_grid():
    keys = R.host_keys(5, 96)
    c = np.stack([_counters(96, s) for s in range(7)], axis=1)
    want = np.asarray(R.uniform_f32_grid(keys, jnp.asarray(c)))
    got = T.uniform_f32_grid(T.host_keys(5, 96), _t(c)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize(
    "lo,hi", [(0, 10), (5, 1_000_003), (-7, 2**40), (3, 3), (9, 2), (0, 2**62)]
)
def test_uniform_int(lo, hi):
    keys = R.host_keys(13, 200)
    c = _counters(200, 4)
    want = np.asarray(R.uniform_int(keys, jnp.asarray(c), lo, hi))
    got = T.uniform_int(T.host_keys(13, 200), _t(c), lo, hi).numpy()
    np.testing.assert_array_equal(got, want)
