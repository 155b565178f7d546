"""Kernel B2's plain PyTorch version against the Pallas kernel, and the
port's sorter on its fused path against its scan and the JAX XLA scan.

On the CPU the port's fused search runs its plain version, which repeats the
CUDA kernel's arithmetic operation for operation; the kernel itself is held
against it on the card by chip_smoke.py. Inputs: `make_frame_batch(seed)`,
8 frames (G = 16 searches) at n_cones = 64 for the packed comparison, 16
frames for the sorter. Tolerances:
* the integer-coded rows (configs, length, done, last_idx) and `alive` must
  be equal to the Pallas kernel's in interpret mode; the float rows agree to
  1e-5 (the same float32 expressions; XLA's rsqrt and fused multiply-adds
  differ from PyTorch's in the last bits);
* the Cephes atan2 agrees with np.arctan2 to 2e-6, the bar
  tests/test_fused_beam.py holds the Pallas kernel's to, and with the Pallas
  kernel's own to 1e-6;
* sorted cones agree to 1e-5 m and masks exactly, as tests/test_fused_beam.py
  holds the Pallas kernel to the XLA scan;
* a numpy model of the CUDA kernel's rank (its thread-to-pool-entry map, its
  64-bit key, the per-warp bitonic sort and the binary search in every
  warp's sorted list, as csrc/beam_search.cu writes them) gives exactly the
  pairwise rank of the plain version, ties, signed zeros and negative scores
  included.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ft_fsd_path_planning_tpu.config import default_config as jax_config
from ft_fsd_path_planning_tpu.models import sorting as js
from ft_fsd_path_planning_tpu.ops.pallas import beam_search as jbs
from ft_fsd_path_planning_tpu.parallel import scenarios as jscen
from ft_fsd_path_planning_torch.config import default_config as torch_config
from ft_fsd_path_planning_torch.models import sorting as ts
from ft_fsd_path_planning_torch.ops import beam_search as tbs
from ft_fsd_path_planning_torch.parallel import scenarios as tscen

# the port's ops are small tensors: one intra-op thread is as fast here and
# leaves the cores to the other test workers
torch.set_num_threads(1)

N = 64
K, L, C = 32, 12, 5
JCFG = jax_config(n_cones=N)
TCFG = torch_config(n_cones=N)
PACKED_SEEDS = (11, 3)
SORTER_SEEDS = (11, 5)
INT_ROWS = list(range(L)) + [L, L + 1, L + 7]
FLOAT_ROWS = [r for r in range(L + 16) if r not in INT_ROWS]


def _sort(frames, monkeypatch, fused: bool):
    monkeypatch.setenv("FT_FSD_FUSED_BEAM", "1" if fused else "0")
    return ts.run_cone_sorting(TCFG, frames.cones, frames.mask, frames.position, frames.direction)


@pytest.fixture(scope="module")
def packed():
    """Per seed: the packed (node_table, feats0, alive0, params) the port's
    sorter hands to the fused search, with the search's keyword arguments,
    the plain version's result and the Pallas kernel's (interpret mode)."""
    captured = {}
    original = ts.bs.fused_beam_search

    def recording(*args, **kwargs):
        captured["call"] = (args, kwargs)
        return original(*args, **kwargs)

    pallas = None
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ts.bs, "fused_beam_search", recording)
        for seed in PACKED_SEEDS:
            _sort(tscen.make_frame_batch(TCFG, 8, seed=seed, device="cpu"), mp, fused=True)
            args, kwargs = captured["call"]
            if pallas is None:
                pallas = jax.jit(
                    lambda *a: jbs.fused_beam_search(*a, n=N, interpret=True, **kwargs)  # noqa: B023
                )
            theirs = pallas(*(jnp.asarray(a.numpy()) for a in args))
            ours = tbs.fused_beam_search_plain(*args, **kwargs)
            out[seed] = (args, kwargs, ours, jax.tree.map(np.asarray, theirs))
    return out


@pytest.mark.parametrize("seed", PACKED_SEEDS)
def test_plain_search_matches_pallas_interpret(packed, seed):
    args, kwargs, (feats, alive), (jfeats, jalive) = packed[seed]
    assert args[0].shape == (16, N, 4 * C) and args[1].shape == (16, L + 16, K)
    assert (kwargs["k"], kwargs["l"], kwargs["c"]) == (K, L, C)
    np.testing.assert_array_equal(alive.numpy(), jalive)
    np.testing.assert_array_equal(feats[:, INT_ROWS].numpy(), jfeats[:, INT_ROWS])
    np.testing.assert_allclose(feats[:, FLOAT_ROWS].numpy(), jfeats[:, FLOAT_ROWS], atol=1e-5)
    # the searches did something: most of them end on a config of several cones
    assert alive[:, 0].sum() >= 12 and feats[:, L].max() >= 6


@pytest.mark.parametrize("seed", PACKED_SEEDS)
def test_fused_dispatch_takes_plain_on_cpu(packed, seed):
    args, kwargs, (feats, alive), _ = packed[seed]
    tbs.reset_launch_count()
    got_feats, got_alive = tbs.fused_beam_search(*args, **kwargs)
    assert tbs.launch_count == 0  # CPU tensors take the plain version
    assert torch.equal(got_feats, feats) and torch.equal(got_alive, alive)


def _atan2_cases():
    rng = np.random.default_rng(0)
    y = rng.normal(0, 3, (64, 128)).astype(np.float32)
    x = rng.normal(0, 3, (64, 128)).astype(np.float32)
    # axis and degenerate cases
    y[0, :] = 0.0
    x[1, :] = 0.0
    y[2, :], x[2, :] = 0.0, 0.0
    return y, x


def test_plain_atan2_matches_numpy():
    y, x = _atan2_cases()
    got = tbs.atan2_plain(torch.tensor(y), torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, np.arctan2(y, x), atol=2e-6)
    assert (got[2] == 0.0).all()  # atan2(0, 0) = 0


def test_plain_atan2_matches_pallas_helper():
    y, x = _atan2_cases()
    got = tbs.atan2_plain(torch.tensor(y), torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jbs._atan2(jnp.asarray(y), jnp.asarray(x))), atol=1e-6)


@pytest.fixture(scope="module")
def jax_sorter():
    return jax.jit(jax.vmap(
        lambda f: js.run_cone_sorting(JCFG, f.cones, f.mask, f.position, f.direction)
    ))


@pytest.mark.parametrize("seed", SORTER_SEEDS)
def test_sorter_fused_matches_scan_and_jax(jax_sorter, monkeypatch, seed):
    frames = tscen.make_frame_batch(TCFG, 16, seed=seed, device="cpu")
    tbs.reset_launch_count()
    fused = _sort(frames, monkeypatch, fused=True)
    scan = _sort(frames, monkeypatch, fused=False)
    theirs = jax.tree.map(np.asarray, jax_sorter(jscen.make_frame_batch(JCFG, 16, seed=seed)))
    assert tbs.launch_count == 0
    for name in fused._fields:
        f, s, j = getattr(fused, name).numpy(), getattr(scan, name).numpy(), getattr(theirs, name)
        if f.dtype == bool:
            np.testing.assert_array_equal(f, s, err_msg=name)
            np.testing.assert_array_equal(f, j, err_msg=name)
        else:
            np.testing.assert_allclose(f, s, atol=1e-5, err_msg=name)
            np.testing.assert_allclose(f, j, atol=1e-5, err_msg=name)
    assert theirs.left_mask.sum() > 3 * 16 and theirs.right_mask.sum() > 3 * 16


@pytest.mark.parametrize(
    "device,flag,want",
    [("cpu", None, False), ("cpu", "0", False), ("cpu", "1", True),
     ("cuda", None, True), ("cuda", "1", True), ("cuda", "0", False)],
)
def test_switch(monkeypatch, device, flag, want):
    if flag is None:
        monkeypatch.delenv("FT_FSD_FUSED_BEAM", raising=False)
    else:
        monkeypatch.setenv("FT_FSD_FUSED_BEAM", flag)
    assert ts._use_fused_beam(torch.device(device)) is want


def test_gate_items_match_jax():
    assert ts._gate_items(TCFG.sorting) == js._gate_items(JCFG.sorting)
    assert set(tbs.GATE_NAMES) == {name for name, _ in ts._gate_items(TCFG.sorting)}
    assert tbs.N_PARAMS == jbs.N_PARAMS


def test_cuda_wrapper_refuses_what_the_kernel_does_not_take(packed):
    args, kwargs, _, _ = packed[PACKED_SEEDS[0]]
    tbs.reset_launch_count()
    with pytest.raises(ValueError, match="CUDA"):
        tbs.fused_beam_search_cuda(*args, **kwargs)
    with pytest.raises(ValueError, match="feats0"):
        tbs.fused_beam_search_plain(args[0], args[1][:, :-1], args[2], args[3], **kwargs)
    assert tbs.launch_count == 0


def test_cost_counters():
    assert (K, L, C) in tbs.KERNEL_SHAPES
    one = tbs.search_bytes(1, 128, K, L, C)
    assert one == 4 * (128 * 20 + 2 * (28 * 32 + 32) + 6)
    assert tbs.search_bytes(512, 128, K, L, C) == 512 * one
    # the table row is indexed, not searched: N does not change the work
    assert tbs.search_flops(128, K, L, C) == tbs.search_flops(256, K, L, C)
    # the bound counts a comparison top-K, not an O(P^2) pairwise rank: the
    # children's gates dominate, and the whole stays below one pairwise rank
    pool = tbs.pool_size(K, C)
    steps = L - 1
    assert tbs.search_flops(128, K, L, C) > steps * K * C * 300
    assert tbs.search_flops(128, K, L, C) < steps * 4 * pool * pool
    assert tbs.search_flops(128, K, L, C) == steps * (K * C * 428 + K * 68 + pool * 8)


# --- the CUDA kernel's rank, modelled in numpy (csrc/beam_search.cu) -------

GROUP = 8  # lanes per beam: C children, the parent, the rest hold nothing
NO_ENTRY = np.uint64(0xFFFFFFFFFFFFFFFF)


def _thread_pool_index(tid: int) -> int | None:
    """Pool index of the entry thread ``tid`` holds, as the kernel maps it."""
    warp, lane = divmod(tid, 32)
    slot = lane % GROUP
    beam = warp * (32 // GROUP) + lane // GROUP
    if slot < C:
        return K + slot * K + beam
    return beam if slot == C else None


def _rank_key(score: np.float32, pool_index: int) -> np.uint64:
    score = np.float32(0.0) if score == 0.0 else np.float32(score)  # -0.0 -> +0.0
    bits = int(np.array(score, np.float32).view(np.uint32))
    ordered = (~bits & 0xFFFFFFFF) if bits & 0x80000000 else bits | 0x80000000
    return np.uint64((ordered << 32) | pool_index)


def _warp_sort(keys: np.ndarray) -> np.ndarray:
    """The kernel's bitonic network: 32 keys, one a lane, exchanged by xor-shuffles."""
    keys = keys.copy()
    lanes = np.arange(32)
    k = 2
    while k <= 32:
        j = k >> 1
        while j > 0:
            other = keys[lanes ^ j]
            keep_min = ((lanes & j) == 0) == ((lanes & k) == 0)
            keys = np.where(keep_min == (keys < other), keys, other)
            j >>= 1
        k <<= 1
    return keys


def _count_below(sorted_keys: np.ndarray, key: np.uint64) -> int:
    n, step = 0, 16
    while step > 0:
        if sorted_keys[n + step - 1] < key:
            n += step
        step >>= 1
    return n


def _kernel_rank(scores: np.ndarray) -> np.ndarray:
    """rank[p] of every pool entry p as the kernel finds it."""
    threads = K * GROUP
    keys = np.full(threads, NO_ENTRY, np.uint64)
    for tid in range(threads):
        p = _thread_pool_index(tid)
        if p is not None:
            keys[tid] = _rank_key(scores[p], p)
    lists = [_warp_sort(keys[w * 32 : (w + 1) * 32]) for w in range(threads // 32)]
    for srt in lists:
        assert (np.diff(srt.astype(object)) >= 0).all() and srt[-1] == NO_ENTRY
    rank = np.empty(K + K * C, np.int64)
    for tid in range(threads):
        p = _thread_pool_index(tid)
        if p is not None:
            rank[p] = sum(_count_below(srt, keys[tid]) for srt in lists)
    return rank


def _pairwise_rank(scores: np.ndarray) -> np.ndarray:
    """The plain version's rank: #{q : (s_q, q) < (s_p, p)}."""
    idx = np.arange(len(scores))
    s_p, s_q = scores[:, None], scores[None, :]
    return np.sum((s_q < s_p) | ((s_q == s_p) & (idx[None, :] < idx[:, None])), axis=1)


def test_thread_map_is_a_bijection_onto_the_pool_order():
    held = [_thread_pool_index(t) for t in range(K * GROUP)]
    entries = [p for p in held if p is not None]
    assert sorted(entries) == list(range(K + K * C))  # every pool entry once
    assert held.count(None) == K * (GROUP - C - 1)
    for tid, p in enumerate(held):
        if p is None:
            continue
        warp, lane = divmod(tid, 32)
        beam, slot = warp * 4 + lane // GROUP, lane % GROUP
        # parents first, then the children neighbour-major: the plain version's `jm`
        assert p == (beam if slot == C else K + slot * K + beam)
        # a beam's children and its parent share one aligned group of lanes of one warp
        assert lane // GROUP == (lane - slot) // GROUP and slot <= C


def _rank_cases():
    rng = np.random.default_rng(7)
    pool = K + K * C
    big = np.float32(tbs.BIG)
    cases = {}
    # what a step looks like: most entries tie on BIG, a few real scores
    s = np.full(pool, big, np.float32)
    live = rng.choice(pool, 20, replace=False)
    s[live] = rng.uniform(0.0, 5.0, 20).astype(np.float32)
    cases["mostly BIG"] = s
    cases["all BIG"] = np.full(pool, big, np.float32)
    # signed zeros tie as floats and must not be split by their bit patterns
    s = rng.choice(np.array([0.0, -0.0, 1.0, -1.0], np.float32), pool)
    cases["signed zeros"] = s
    s = rng.normal(0.0, 3.0, pool).astype(np.float32)
    s[rng.choice(pool, 60, replace=False)] = big
    s[rng.choice(pool, 30, replace=False)] = np.float32(-2.5)  # negative ties
    cases["negatives and ties"] = s
    cases["all distinct"] = rng.permutation(pool).astype(np.float32) - 100.0
    s = np.array([1e-45, -1e-45, 0.0, -0.0, 3e38, -3e38], np.float32)  # denormals, extremes
    cases["denormals and extremes"] = np.resize(s, pool)
    return cases


@pytest.mark.parametrize("name", list(_rank_cases()))
def test_kernel_rank_model_matches_pairwise_rank(name):
    scores = _rank_cases()[name]
    rank = _kernel_rank(scores)
    assert sorted(rank) == list(range(len(scores)))  # exactly one entry has each rank
    np.testing.assert_array_equal(rank, _pairwise_rank(scores))


def test_rank_key_orders_as_score_then_index():
    vals = np.array([-3e38, -2.5, -1e-45, -0.0, 0.0, 1e-45, 2.5, 1e30, 3e38], np.float32)
    for a in vals:
        for b in vals:
            for ia, ib in ((3, 7), (7, 3)):
                want = (a < b) or (a == b and ia < ib)
                assert (_rank_key(a, ia) < _rank_key(b, ib)) == want, (a, b, ia, ib)
    assert _rank_key(np.float32(3e38), K + K * C - 1) < NO_ENTRY
