"""The port's block hash table against the JAX package's, array for array
(CPU).

The plain versions of H1 (hash_lookup) and H2 (hash_insert) give a
contested free position to the key of largest batch index, the rule by
which XLA:CPU's scatter keeps its last writer. So table_keys, table_slots,
block_coords, n_blocks, overflow and the looked-up slots must equal the
JAX package's bit for bit, slot ids included."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from kimera_semantics_tpu.grid import hash as jhash

from kimera_semantics_tpu_torch.grid import hash as thash
from kimera_semantics_tpu_torch.ops import kernels

EXT = 512
NAMES = ("table_keys", "table_slots", "block_coords", "n_blocks", "overflow")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """This file's many small torch ops on one thread (the test workers'
    thread pools share the CPUs)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def N(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def home(keys, table_size):
    """Each key's first probe position, mix(key) & (table_size - 1)."""
    return thash.mix(torch.from_numpy(keys)).numpy() & (table_size - 1)


def distinct_keys(rng, n, spread):
    """n distinct packed keys of coordinates in [-spread, spread)^3."""
    return thash.sample_keys(rng, n, spread, EXT)


def empty_table(table_size, capacity, n_blocks=0):
    return (np.full(table_size, -1, np.int32),
            np.full(table_size, -1, np.int32),
            np.zeros((capacity, 3), np.int32), np.int32(n_blocks))


def both_insert(state, keys, active, table_size, capacity):
    """JAX insert and the port's insert from the same numpy state; asserts
    every array equal and returns the (numpy) result."""
    rj = jhash.insert(*(jnp.asarray(x) for x in state), jnp.asarray(keys),
                      jnp.asarray(active), table_size, capacity, EXT)
    rt = thash.insert(*(torch.tensor(np.asarray(x)) for x in state),
                      torch.tensor(keys), torch.tensor(active), table_size,
                      capacity, EXT)
    for name, a, b in zip(NAMES, rj, rt):
        np.testing.assert_array_equal(N(b), np.asarray(a), err_msg=name)
    return tuple(np.asarray(a) for a in rj)


def assert_lookups_equal(res, queries, table_size):
    got = thash.lookup(torch.tensor(res[0]), torch.tensor(res[1]),
                       torch.tensor(queries), table_size)
    want = jhash.lookup(jnp.asarray(res[0]), jnp.asarray(res[1]),
                        jnp.asarray(queries), table_size)
    np.testing.assert_array_equal(N(got), np.asarray(want))
    return N(got)


@pytest.mark.parametrize("n,spread,n_blocks", [(300, 8, 0), (900, 30, 17)])
def test_random_keys(n, spread, n_blocks):
    """Random keys, 10% inactive, twice into one table (the second batch
    re-touches half of the first); lookups of inserted and absent keys."""
    rng = np.random.RandomState(n)
    T, cap = 2048, 1024
    keys = distinct_keys(rng, 2 * n, spread)
    state = empty_table(T, cap, n_blocks)
    first = keys[:n]
    state = both_insert(state, first, rng.rand(n) > 0.1, T, cap)[:4]
    second = np.concatenate([first[: n // 2], keys[n:]])
    rng.shuffle(second)
    res = both_insert(state, second, rng.rand(len(second)) > 0.1, T, cap)
    slots = assert_lookups_equal(res, keys, T)
    assert (slots >= 0).sum() > n


def test_forced_collisions():
    """16 groups of 6 keys, each group sharing a home position (a numpy
    search for equal mix(key) & mask) at every 8th position, interleaved,
    so every group's probe chain is contested round after round."""
    rng = np.random.RandomState(1)
    T, cap = 256, 200
    keys = thash.colliding_keys(rng, 96, 6, T, EXT, home_step=8)
    assert len(np.unique(home(keys, T))) == 16
    res = both_insert(empty_table(T, cap), keys, np.ones(len(keys), bool), T,
                      cap)
    assert int(res[3]) == len(keys) and int(res[4]) == 0
    assert_lookups_equal(res, keys, T)


def test_duplicates_within_a_batch():
    """Every key several times in one batch: each claims one position and
    one slot, in both packages."""
    rng = np.random.RandomState(2)
    T, cap = 512, 300
    keys = np.repeat(distinct_keys(rng, 120, 10), 4)
    rng.shuffle(keys)
    active = rng.rand(len(keys)) > 0.3
    res = both_insert(empty_table(T, cap), keys, active, T, cap)
    assert int(res[3]) == len(np.unique(keys[active]))
    assert_lookups_equal(res, keys, T)


def test_three_bidders_largest_batch_index_wins():
    """Three keys with one home position bid for it in the same round: the
    key of the largest batch index takes it in both packages, the others
    the next positions in the rounds after."""
    rng = np.random.RandomState(3)
    T, cap = 64, 32
    pool = distinct_keys(rng, 4000, 20)
    homes = home(pool, T)
    h = np.bincount(homes, minlength=T).argmax()
    trio = pool[homes == h][:3]
    res = both_insert(empty_table(T, cap), trio, np.ones(3, bool), T, cap)
    assert res[0][h] == trio[2]
    assert res[0][(h + 1) % T] == trio[1] and res[0][(h + 2) % T] == trio[0]
    # and with the last bidder inactive, the middle one wins
    res = both_insert(empty_table(T, cap), trio,
                      np.array([True, True, False]), T, cap)
    assert res[0][h] == trio[1]


def test_past_capacity_leaves_tombstones_then_probes_through():
    """A batch past the capacity rolls its last claims back to
    TOMBSTONE_KEY; a second batch, part of it the rolled-back keys, probes
    through the tombstones (and may claim them)."""
    rng = np.random.RandomState(4)
    T, cap = 256, 100
    keys = distinct_keys(rng, 210, 12)
    res = both_insert(empty_table(T, cap), keys[:180], np.ones(180, bool), T,
                      cap)
    assert int(res[3]) == cap and int(res[4]) == 80
    assert (res[0] == thash.TOMBSTONE_KEY).sum() == 80
    second = np.concatenate([keys[150:180], keys[180:]])
    res2 = both_insert(res[:4], second, np.ones(len(second), bool), T, cap)
    assert int(res2[3]) == cap and (res2[0] == thash.TOMBSTONE_KEY).sum() > 0
    assert_lookups_equal(res2, keys, T)
    # the same table in a grid of three times the capacity: the second
    # batch now fits, and some of its keys claim tombstones for good
    grown = (res[0], res[1],
             np.concatenate([res[2], np.zeros((2 * cap, 3), np.int32)]),
             res[3])
    res3 = both_insert(grown, second, np.ones(len(second), bool), T, 3 * cap)
    assert int(res3[4]) == 0
    assert (res3[0] == thash.TOMBSTONE_KEY).sum() < 80
    assert_lookups_equal(res3, keys, T)


def test_nearly_full_table_exhausts_max_probes():
    """A 256-entry table filled to 250 keys, then 40 more: probes run out
    of MAX_PROBES rounds (probe overflow) in both packages."""
    rng = np.random.RandomState(5)
    T, cap = 256, 256
    keys = distinct_keys(rng, 290, 12)
    res = both_insert(empty_table(T, cap), keys[:250], np.ones(250, bool), T,
                      cap)
    res2 = both_insert(res[:4], keys[250:], np.ones(40, bool), T, cap)
    assert int(res2[4]) > 0
    assert_lookups_equal(res2, keys, T)


@pytest.mark.parametrize("rounds", [1, 2, 64])
def test_lookup_bounded_complete(rounds):
    """lookup_bounded in too few rounds reports complete False and -1 for
    the unfinished keys; in enough rounds it equals lookup."""
    rng = np.random.RandomState(6)
    T, cap = 128, 128
    keys = distinct_keys(rng, 150, 10)
    res = both_insert(empty_table(T, cap), keys[:110], np.ones(110, bool), T,
                      cap)
    tk, ts = torch.tensor(res[0]), torch.tensor(res[1])
    slots, complete = thash.lookup_bounded(tk, ts, torch.tensor(keys), T,
                                           rounds)
    full = assert_lookups_equal(res, keys, T)
    # JAX lookup's loop, cut at `rounds`
    idx = home(keys, T)
    done = np.zeros(len(keys), bool)
    want = np.full(len(keys), -1, np.int32)
    for _ in range(rounds):
        k = res[0][idx]
        hit = (k == keys) & ~done
        want[hit] = res[1][idx][hit]
        done |= hit | (k == -1)
        idx = np.where(done, idx, (idx + 1) & (T - 1))
    np.testing.assert_array_equal(N(slots), want)
    assert bool(complete) == bool(done.all())
    if rounds == 64:
        np.testing.assert_array_equal(N(slots), full)
    else:
        assert not bool(complete)


def test_kernel_wrappers_take_the_plain_versions_on_the_cpu():
    """On CPU tensors the wrappers return their plain versions' results
    and launch nothing."""
    rng = np.random.RandomState(7)
    T, cap = 256, 128
    keys = torch.tensor(distinct_keys(rng, 90, 8))
    active = torch.ones(90, dtype=torch.bool)
    state = tuple(torch.tensor(np.asarray(x)) for x in empty_table(T, cap))
    kernels.reset_launches()
    got = kernels.hash_insert(*state, keys, active, T, cap, EXT)
    ref = kernels.hash_insert_plain(*state, keys, active, T, cap, EXT)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    la = kernels.hash_lookup(got[0], got[1], keys, T, 64)
    lb = kernels.hash_lookup_plain(got[0], got[1], keys, T, 64)
    assert torch.equal(la[0], lb[0]) and bool(la[1]) and bool(lb[1])
    assert kernels.launches["hash_insert"] == 0
    assert kernels.launches["hash_lookup"] == 0


@pytest.mark.parametrize("capacity,budget", [(768, 256), (64, 128)])
def test_insert_frame_list_arrays_match(capacity, budget):
    """insert_frame_list over two frames: every returned array equal to the
    JAX package's, the tables and the frame list included; the second case
    overflows the budget and the capacity."""
    rng = np.random.RandomState(8)
    T = 2048
    jstate = tuple(jnp.asarray(x) for x in empty_table(T, capacity))
    tstate = tuple(torch.tensor(np.asarray(x))
                   for x in empty_table(T, capacity))
    for _ in range(2):
        coords = rng.randint(-6, 6, (1500, 3)).astype(np.int32)
        keys = np.asarray(jhash.pack_block_coords(jnp.asarray(coords), EXT))
        active = rng.rand(1500) > 0.2
        rj = jhash.insert_frame_list(*jstate, jnp.asarray(keys),
                                     jnp.asarray(active), T, capacity, EXT,
                                     budget)
        rt = thash.insert_frame_list(*tstate, torch.tensor(keys),
                                     torch.tensor(active), T, capacity, EXT,
                                     budget)
        for i, (a, b) in enumerate(zip(rj, rt)):
            np.testing.assert_array_equal(N(b), np.asarray(a),
                                          err_msg=f"output {i}")
        jstate, tstate = rj[:4], rt[:4]


def test_insert_compacted_arrays_match():
    """insert_compacted of a duplicate-heavy stream with more uniques than
    the capacity: every array equal to the JAX package's."""
    rng = np.random.RandomState(9)
    T, cap = 1024, 300
    coords = rng.randint(-5, 5, (5000, 3)).astype(np.int32)
    keys = np.asarray(jhash.pack_block_coords(jnp.asarray(coords), EXT))
    active = rng.rand(5000) > 0.3
    state = empty_table(T, cap, 11)
    rj = jhash.insert_compacted(*(jnp.asarray(x) for x in state),
                                jnp.asarray(keys), jnp.asarray(active), T,
                                cap, EXT)
    rt = thash.insert_compacted(*(torch.tensor(np.asarray(x))
                                  for x in state), torch.tensor(keys),
                                torch.tensor(active), T, cap, EXT)
    for name, a, b in zip(NAMES, rj, rt):
        np.testing.assert_array_equal(N(b), np.asarray(a), err_msg=name)
    assert int(rj[4]) > 0



def test_key_sets_for_the_checks():
    """grid/hash.py's key sets for the tests and card checks: sample_keys
    gives distinct keys of coordinates in range (unpacked by the JAX
    package); colliding_keys gives interleaved groups whose keys share
    the home position of the JAX package's mix."""
    rng = np.random.RandomState(10)
    keys = thash.sample_keys(rng, 500, 7, EXT)
    assert keys.dtype == np.int32 and len(np.unique(keys)) == 500
    c = np.asarray(jhash.unpack_block_key(jnp.asarray(keys), EXT))
    assert c.min() >= -7 and c.max() < 7
    T = 512
    k = thash.colliding_keys(rng, 40, 5, T, EXT)
    assert len(np.unique(k)) == 40
    homes = np.asarray(jhash.mix(jnp.asarray(k))) & (T - 1)
    groups = homes.reshape(5, 8)     # row r: the r-th key of every group
    assert (groups == groups[0]).all() and len(np.unique(groups[0])) == 8
    with pytest.raises(ValueError):
        thash.colliding_keys(rng, 40, 10 ** 6, T, EXT)


def test_host_sync_witness_on_the_cpu():
    """utils/syncs.py, the profiler witness of the card's host syncs:
    which runtime calls count as syncs, and on the CPU a traced block that
    makes no CUDA call reports no sync and no launch (and did run)."""
    from kimera_semantics_tpu_torch.utils import syncs
    for name in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                 "cudaEventSynchronize", "cudaMemcpy", "cuMemcpyDtoH_v2"):
        assert syncs.is_host_sync(name), name
    for name in ("cudaMemcpyAsync", "cudaLaunchKernel", "cudaEventRecord",
                 "cuMemcpyDtoHAsync_v2", "aten::item"):
        assert not syncs.is_host_sync(name), name
    ran = []
    found, launches = syncs.host_syncs(
        lambda: ran.append(int(torch.ones(3).sum().item())))
    assert ran == [3] and found == {} and launches == 0
