"""The port's threefry streams (cge_tpu_torch/ops/rng.py) against
`jax.random`, bit for bit: keys, fold_in, split, uniform and the per-ray
streams of the soft shadows. Every comparison is exact (uint32 words and
float32 bit patterns); there is no tolerance.

The `cuda` case needs no JAX, so it also runs where JAX is not installed,
without the JAX conftest:
`python -m pytest --noconftest tests/test_torch_rng.py -m cuda`.
"""

import numpy as np
import pytest
import torch

from cge_tpu_torch.interop import key_from_numpy
from cge_tpu_torch.ops import rng

torch.set_num_threads(2)

# Random123's known-answer vectors of threefry2x32-20 (kat_vectors)
KAT = [
    ((0x00000000, 0x00000000), (0x00000000, 0x00000000),
     (0x6B200159, 0x99BA4EFE)),
    ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF),
     (0x1CB996FC, 0xBB002BE7)),
    ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3),
     (0xC4923A9C, 0x483DF7A0)),
]


@pytest.mark.parametrize("key,ctr,want", KAT)
def test_threefry_known_answers(key, ctr, want):
    """On host ints and on int64 tensors."""
    assert rng.threefry2x32(key, ctr) == want
    t = rng.threefry2x32(key, (torch.tensor([ctr[0]]), torch.tensor([ctr[1]])))
    assert (int(t[0]), int(t[1])) == want


def _bits(x):
    return np.asarray(x).view(np.uint32)


@pytest.fixture(scope="module")
def jr():
    import jax
    return jax.random


@pytest.mark.parametrize("seed", [0, 1, 7, 2**31 - 1, -1, -2**31, 123456789])
def test_keys_fold_in_and_split_match_jax(jr, seed):
    """PRNGKey, fold_in by ids up to 2^31 - 1, and split into 2 and 3."""
    jk = jr.PRNGKey(seed)
    k = rng.prng_key(seed)
    assert k == tuple(int(x) for x in np.asarray(jk))
    for d in (0, 1, 3, 101, 202, 1000, 2001, 2**31 - 1):
        assert rng.fold_in(k, d) == tuple(
            int(x) for x in np.asarray(jr.fold_in(jk, d)))
    for num in (2, 3):
        want = [tuple(int(x) for x in row)
                for row in np.asarray(jr.split(jk, num))]
        assert rng.split(k, num) == want


@pytest.mark.parametrize("shape", [(1,), (7,), (4, 5, 2), (33, 9, 2),
                                   (1000, 5)])
@pytest.mark.parametrize("seed", [0, 42])
def test_uniform_matches_jax(jr, shape, seed):
    """Both sides draw from one key, handed across by key_from_numpy."""
    jk = jr.fold_in(jr.PRNGKey(seed), 101)
    want = np.asarray(jr.uniform(jk, shape))
    got = rng.uniform(key_from_numpy(np.asarray(jk)), shape, "cpu")
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    assert 0.0 <= float(got.min()) and float(got.max()) < 1.0


def test_uniform_edge_bits():
    """All-zero bits give 0, all-one bits 1 - 2^-23 (the float32 step
    in [1, 2)), the lowest mantissa bit 2^-23."""
    u = rng.bits_to_uniform(torch.tensor([0, 0xFFFFFFFF, 1 << 9]))
    assert u[0] == 0.0 and u[1] == np.float32(1.0 - 2.0 ** -23)
    assert u[2] == np.float32(2.0 ** -23)


@pytest.mark.parametrize("shape", [(25,), (5, 5)])
def test_per_ray_uniform_matches_jax(jr, shape):
    """lights.per_ray_uniform: vmap of fold_in over global ray ids, then
    vmap of uniform; ids up to 2^31 - 1."""
    import jax

    from cge_tpu.render.lights import per_ray_uniform

    ids = np.array([0, 1, 5, 1023, 65535, 65536, 2**20 + 3, 2**31 - 1],
                   np.int32)
    jk = jr.fold_in(jr.PRNGKey(3), 2000)
    want = np.asarray(jax.jit(per_ray_uniform, static_argnums=2)(
        jk, ids, shape))
    got = rng.per_ray_uniform(key_from_numpy(np.asarray(jk)),
                              torch.from_numpy(ids), shape)
    assert tuple(got.shape) == (len(ids), *shape)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_per_ray_uniform_chunks_like_one_batch():
    """Rows depend only on (key, id): chunks of a batch draw its rows."""
    key = rng.fold_in(rng.prng_key(9), 1000)
    ids = torch.arange(5000)
    whole = rng.per_ray_uniform(key, ids, (25,))
    parts = torch.cat([rng.per_ray_uniform(key, ids[s:s + 1024], (25,))
                       for s in range(0, 5000, 1024)])
    assert torch.equal(whole, parts)


def test_key_from_numpy_matches_prng_key(jr):
    assert key_from_numpy(np.asarray(jr.PRNGKey(11))) == rng.prng_key(11)
    with pytest.raises(ValueError):
        key_from_numpy(np.zeros(2, np.int32))


def test_host_key_needs_a_device():
    with pytest.raises(ValueError):
        rng.uniform(rng.prng_key(0), (3,))


@pytest.mark.cuda
def test_card_draws_the_cpu_bits():
    """The card's threefry draws equal the CPU's bit for bit: a frame
    draw, and the per-ray keys and streams of a chunk of ray ids."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    key = rng.fold_in(rng.prng_key(5), 101)
    for shape in ((4096, 9, 2), (333, 7)):
        a = rng.uniform(key, shape, "cuda").cpu()
        b = rng.uniform(key, shape, "cpu")
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    ids = torch.arange(65536, 65536 * 2)
    a = rng.per_ray_uniform(key, ids.cuda(), (25,)).cpu()
    b = rng.per_ray_uniform(key, ids, (25,))
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    ka = rng.fold_in(key, ids.cuda())
    kb = rng.fold_in(key, ids)
    assert all(torch.equal(x.cpu(), y) for x, y in zip(ka, kb))
