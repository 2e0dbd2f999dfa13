"""The sharded KV writes of a mesh (``chatglm2.write_rows_sharded`` on a
T-shard of the dense cache, ``paged_kv.write_pages_sharded`` on a
model-sharded pool) write without ``nonzero``: a masked accumulate on the
bits (``chatglm2.masked_put``), so a CUDA graph can hold them.  On two gloo
CPU ranks of a (1, 2) mesh, each on its own shard, their results are
bit-equal to the ``nonzero`` writes they replace (kept in
tests/torch_dist_workers.py), over random starts (before 0, past the end,
across the shard boundary), with a row map, and in two planted cases: a
row whose out-of-shard positions clamp onto a slot the same call writes,
a call that owns no position at all, which must leave every bit as it was,
and padding rows that share one garbage page (the last write stands, as
the sequential write leaves it)."""
import numpy as np
import pytest

pytest.importorskip("torch")

from chatglm_q_tpu_torch.utils.distributed import run_spmd  # noqa: E402

import torch_dist_workers as W  # noqa: E402

SPAWN_TIMEOUT = 150
G_, D_, T_LOCAL, P = 2, 8, 16, 4


def _rows_cases():
    rng = np.random.default_rng(7)
    cases = {}
    for i in range(12):
        S = int(rng.integers(1, 12))
        B = 3
        cases[f"random{i}"] = ("rows", dict(
            cache=rng.standard_normal((4, G_, T_LOCAL, D_)).astype(np.float32),
            new=rng.standard_normal((B, G_, S, D_)).astype(np.float32),
            start=rng.integers(-4, 2 * T_LOCAL + 4, B).astype(np.int32),
            rows=None if i % 2 else rng.permutation(4)[:B].astype(np.int32)))
    base = rng.standard_normal((4, G_, T_LOCAL, D_)).astype(np.float32)
    # on rank 1 (slots 16-31) the first row's positions 13-18: 13-15 are out
    # of the shard and clamp onto local slot 0, which position 16 writes
    cases["planted_collision"] = ("rows", dict(
        cache=base, new=rng.standard_normal((2, G_, 6, D_)).astype(np.float32),
        start=np.array([13, 26], np.int32), rows=np.array([1, 3], np.int32)))
    # rank 0 holds slots 0-15: positions 20-25 and 26-31 are all rank 1's
    cases["all_out_of_shard"] = ("rows", dict(
        cache=base, new=rng.standard_normal((2, G_, 6, D_)).astype(np.float32),
        start=np.array([20, 40], np.int32), rows=None))
    return cases


def _pages_cases():
    rng = np.random.default_rng(8)
    NP, MP, L = 12, 6, 2  # a global table of 6 blocks: 3 local columns a phase
    tables = [np.array([[1, 2, 3], [4, 5, 6], [7, 8, 9]], np.int32),
              np.array([[2, 3, 4], [5, 6, 7], [8, 9, 10]], np.int32)]
    cases = {}
    for i in range(12):
        S = int(rng.integers(1, 10))
        aligned = bool(i % 3)
        start = (rng.integers(0, MP, 3) * P if aligned and S > 1
                 else rng.integers(0, MP * P + 3, 3)).astype(np.int32)
        cases[f"random{i}"] = ("pages", dict(
            cache=rng.standard_normal((L, NP, G_, P, D_)).astype(np.float32),
            new=rng.standard_normal((3, G_, S, D_)).astype(np.float32), start=start,
            tables=tables, layer=i % L, total=MP * P, aligned=aligned))
    base = rng.standard_normal((L, NP, G_, P, D_)).astype(np.float32)
    # an unaligned write of 9 positions from 18: blocks 4, 5 and past the
    # end (clamped onto 23); block 5's positions are rank 1's, block 4's
    # rank 0's, and the clamped tail lands on the slot the last owned one
    # writes
    cases["planted_collision"] = ("pages", dict(
        cache=base, new=rng.standard_normal((1, G_, 9, D_)).astype(np.float32),
        start=np.array([18], np.int32), tables=[t[:1] for t in tables], layer=1,
        total=MP * P, aligned=False))
    # three padding rows on one garbage table row (page 0 of each rank): all
    # owned, the same slots; the last row's write stands, as sequentially
    garbage = [np.zeros((3, 3), np.int32), np.zeros((3, 3), np.int32)]
    cases["shared_garbage_page"] = ("pages", dict(
        cache=base, new=rng.standard_normal((3, G_, 5, D_)).astype(np.float32),
        start=np.array([2, 2, 6], np.int32), tables=garbage, layer=0, total=MP * P,
        aligned=False))
    # block 1 alone (positions 4-7): phase 1's, none of rank 0's
    cases["all_out_of_shard"] = ("pages", dict(
        cache=base, new=rng.standard_normal((1, G_, 4, D_)).astype(np.float32),
        start=np.array([4], np.int32), tables=[t[:1] for t in tables], layer=0,
        total=MP * P, aligned=True))
    return cases


@pytest.fixture(scope="module")
def ranks():
    cases = {f"rows_{k}": v for k, v in _rows_cases().items()}
    cases.update({f"pages_{k}": v for k, v in _pages_cases().items()})
    return run_spmd(W.sharded_write_cases, 2, "gloo", SPAWN_TIMEOUT, args=(1, 2, cases))


@pytest.mark.parametrize("kind", ["rows", "pages"])
def test_masked_sharded_writes_equal_the_nonzero_writes(ranks, kind):
    n = 0
    for rank, res in enumerate(ranks):
        for name, (got, want, before) in res.items():
            if name.startswith(kind):
                assert np.array_equal(got, want), (rank, name)
                n += int(not np.array_equal(got, before))
    assert n >= 10  # most cases write something on some rank


@pytest.mark.parametrize("kind", ["rows", "pages"])
def test_planted_collision_and_a_call_owning_nothing(ranks, kind):
    got, want, before = ranks[1][f"{kind}_planted_collision"]
    assert np.array_equal(got, want) and not np.array_equal(got, before)
    got, want, before = ranks[0][f"{kind}_all_out_of_shard"]
    assert np.array_equal(got, before) and np.array_equal(want, before)
    if kind == "pages":
        for res in ranks:
            got, want, before = res["pages_shared_garbage_page"]
            assert np.array_equal(got, want) and not np.array_equal(got, before)
