"""Parity of the port's walk (``emqx_tpu_torch.ops.walk_kernel``) and
match epilogues (``emqx_tpu_torch.ops.match_kernel``) with the JAX
reference, on the CPU.

Inputs are made from seeded numpy and handed to both sides as arrays.
Every output is an integer, so the tolerance is exact equality: the raw
accept slots bit for bit (slot order included), and all five
``MatchResult`` fields in compact and flat mode."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from emqx_tpu.ops import compile_filters as ref_compile
from emqx_tpu.ops import encode_topics as ref_encode
from emqx_tpu.ops import nfa_match as ref_nfa_match
from emqx_tpu.ops.compiler import _bucket_hash as ref_bucket_hash
from emqx_tpu.ops.encode import encode_batch as ref_encode_batch
from emqx_tpu.ops.pallas_match import TILE_B, pallas_small_match

from emqx_tpu_torch.ops import compile_filters, encode_topics, nfa_match
from emqx_tpu_torch.ops import walk_kernel
from emqx_tpu_torch.ops.walk_kernel import (
    accept_cols, nfa_walk, nfa_walk_plain)
from emqx_tpu_torch.workload import build_workload

# $SYS, root +/#, empty levels, a literal '+'-free deep branch, and a
# fan of siblings so that A=2 spills
EDGE_FILTERS = [
    "a/b/c", "a/+/c", "a/#", "#", "+", "+/b", "a/b", "b", "$SYS/#",
    "$SYS/+/x", "x//y", "/", "+/+", "+/+/+", "//#", "deep/1/2/3/4/5/6/#",
    "deep/+/2/+/4/+/6/7", "a/+/+/+", "a/b/+/d", "a/+/c/#", "+/b/#",
]
EDGE_TOPICS = [
    "a/b/c", "a/b", "a", "b", "x//y", "/", "//", "$SYS/broker",
    "$SYS/q/x", "$SYS", "deep/1/2/3/4/5/6/7", "deep/1/2/3/4/5/6/7/8/9/10",
    "nomatch/z", "a/q/c", "a/b/c/d", "a/b/c/d/e/f/g/h/i", "q/b/c",
    "unknownword", "a/b/z/d",
]


def _corpus(seed: int, n_filters: int, n_topics: int, depth: int):
    filters, topics = build_workload(np.random.default_rng(seed), n_filters,
                                     n_topics, depth=min(depth, 8))
    filters = sorted(set(filters) | set(EDGE_FILTERS))
    return filters, EDGE_TOPICS + topics


def _inputs(filters, topics, depth, batch):
    """Encoded operands of a walk of ``depth`` steps over a table of depth
    max(depth, 8): the serve core walks short topics at depth 4 over the
    full-depth table the same way."""
    t = ref_compile(filters, depth=max(depth, 8), state_bucket=64)
    words, lens, is_sys = ref_encode_batch(t, topics, batch=batch,
                                           depth=depth)
    return t, (words, lens, is_sys, *t.device_arrays())


def _jax(args):
    return tuple(jnp.asarray(a) for a in args)


def _torch(args):
    return tuple(torch.from_numpy(np.asarray(a)) for a in args)


CASES = [  # (depth, active_slots)
    (8, 8), (8, 2), (4, 16), (16, 16),
    # the kernels' lane layouts: one lane a row, a power of two the
    # frontier does not fill, a whole warp a row
    (8, 1), (16, 12), (8, 32),
]


@pytest.mark.parametrize("depth,A", CASES)
def test_walk_plain_equals_reference_raw(depth, A):
    filters, topics = _corpus(depth * 7 + A, 600, 300, depth)
    _t, args = _inputs(filters, topics, depth, batch=512)
    ref = ref_nfa_match(*_jax(args), active_slots=A, compact_output=False)
    acc, aover = nfa_walk_plain(*_torch(args), active_slots=A)
    assert acc.shape == (512, accept_cols(depth, A))
    np.testing.assert_array_equal(acc.numpy(), np.asarray(ref.matches))
    np.testing.assert_array_equal(aover.numpy(),
                                  np.asarray(ref.active_overflow))
    if A <= 2:
        assert aover.numpy().max() > 0, "the spill case must spill"


@pytest.mark.parametrize("A", [8, 2])
def test_walk_plain_equals_pallas_interpret(A):
    """The reference's Pallas kernel itself, run in interpret mode at a
    multiple of its TILE_B, against the port's plain walk."""
    filters, topics = _corpus(11 + A, 300, TILE_B, 8)
    _t, args = _inputs(filters, topics[:TILE_B], 8, batch=TILE_B)
    acc_ref, aover_ref = pallas_small_match(*_jax(args), depth=8,
                                            active_slots=A, interpret=True)
    acc, aover = nfa_walk(*_torch(args), active_slots=A)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(acc_ref))
    np.testing.assert_array_equal(aover.numpy(), np.asarray(aover_ref))


FIELDS = ("matches", "n_matches", "active_overflow", "match_overflow",
          "row_meta")


def _assert_result_equal(got, ref):
    for f in FIELDS:
        g, r = getattr(got, f), getattr(ref, f)
        if r is None:
            assert g is None, f
            continue
        np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=f)


@pytest.mark.parametrize("depth,A,K,flat_cap", [
    (8, 8, 32, 0),        # compact
    (8, 8, 3, 0),         # compact, K small: match_overflow
    (8, 2, 8, 0),         # compact with active spill
    (8, 8, 32, 4096),     # flat, roomy
    (8, 8, 4, 300),       # flat: K truncation + global-cap truncation
    (8, 2, 6, 150),       # flat with spill and truncation
    (4, 16, 128, 8 * 256),  # the serve shape of the short group
    (16, 16, 128, 8 * 256),  # the serve shape of the long group
    (8, 8, 32, 40),       # flat: the cap drops whole rows
])
def test_nfa_match_equals_reference(depth, A, K, flat_cap):
    filters, topics = _corpus(depth + A + K, 500, 230, depth)
    _t, args = _inputs(filters, topics, depth, batch=256)
    kw = dict(active_slots=A, max_matches=K, flat_cap=flat_cap)
    ref = ref_nfa_match(*_jax(args), **kw)
    got = nfa_match(*_torch(args), **kw)
    _assert_result_equal(got, ref)
    if flat_cap and flat_cap < 8 * 256:
        assert np.asarray(ref.match_overflow).any(), "cap must truncate"
    if flat_cap == 40:
        _assert_rows_dropped(got, K, flat_cap)


def _assert_rows_dropped(got, K: int, flat_cap: int) -> None:
    """Some row with ids has its whole segment past ``flat_cap``."""
    nk = np.minimum(got.n_matches.numpy(), K)
    offs = np.cumsum(nk) - nk
    assert ((offs >= flat_cap) & (nk > 0)).any(), "the cap must drop rows"


def test_nfa_match_raw_mode_equals_reference():
    filters, topics = _corpus(5, 400, 200, 8)
    _t, args = _inputs(filters, topics, 8, batch=256)
    ref = ref_nfa_match(*_jax(args), active_slots=4, max_matches=8,
                        compact_output=False)
    got = nfa_match(*_torch(args), active_slots=4, max_matches=8,
                    compact_output=False)
    _assert_result_equal(got, ref)


def test_port_compiler_and_encoder_equal_reference():
    filters, topics = _corpus(3, 500, 100, 8)
    ref_t = ref_compile(filters, depth=8, state_bucket=64)
    t = compile_filters(filters, depth=8, state_bucket=64)
    for a, b in zip(t.device_arrays(), ref_t.device_arrays()):
        np.testing.assert_array_equal(a, b)
    assert t.vocab == ref_t.vocab
    assert t.accept_filters == ref_t.accept_filters
    for a, b in zip(encode_topics(t, topics, batch=128),
                    ref_encode(ref_t, topics, batch=128)):
        np.testing.assert_array_equal(a, b)


def test_encode_padding_rows_are_inert():
    t = compile_filters(["#", "+", "a/#"], depth=4, state_bucket=8)
    words, lens, is_sys = encode_topics(t, ["a/b"], batch=4)
    assert (lens[1:] == 4 + 2).all() and is_sys[1:].all()
    assert (words[1:] == 0).all()
    res = nfa_match(*_torch((words, lens, is_sys, *t.device_arrays())),
                    active_slots=4, max_matches=4)
    assert (res.n_matches.numpy()[1:] == 0).all()


def test_hash_plain_equals_uint32_hash():
    rng = np.random.default_rng(7)
    state = rng.integers(-2**31, 2**31 - 1, size=4096).astype(np.int32)
    word = rng.integers(-2**31, 2**31 - 1, size=4096).astype(np.int32)
    for seed in (1, 0x7FFFFFFE, 12345):
        for mask in (7, 2**20 - 1, 2**31 - 1):
            want = ref_bucket_hash(state, word, seed, mask)
            got = walk_kernel._hash_plain(
                torch.from_numpy(state).long(), torch.from_numpy(word).long(),
                torch.tensor(seed), mask)
            np.testing.assert_array_equal(got.numpy(), want)


def _good_args(B=64, D=4):
    return [torch.zeros((B, D), dtype=torch.int32),
            torch.full((B,), D + 2, dtype=torch.int32),
            torch.ones(B, dtype=torch.bool),
            torch.full((8, 4), -1, dtype=torch.int32),
            torch.full((8, 8), -1, dtype=torch.int32),
            torch.ones(2, dtype=torch.int32)]


@pytest.mark.parametrize("bad,match", [
    ((0, torch.zeros((64, 4), dtype=torch.int64)), "words"),
    ((1, torch.zeros((32,), dtype=torch.int32)), "length"),
    ((4, torch.full((6, 8), -1, dtype=torch.int32)), "power of two"),
    ((4, torch.full((8, 16), -1, dtype=torch.int32)), "widths"),
    ((3, torch.full((4, 8), -1, dtype=torch.int32)[:, ::2]), "contiguous"),
    ((5, torch.ones(3, dtype=torch.int32)), "seeds"),
])
def test_kernel_wrapper_rejects_bad_operands(bad, match):
    args = _good_args()
    i, t = bad
    args[i] = t
    with pytest.raises(ValueError, match=match):
        walk_kernel._check(*args, A=8)


def test_kernel_wrapper_rejects_too_wide_frontier():
    with pytest.raises(ValueError, match="active_slots"):
        walk_kernel._check(*_good_args(), A=walk_kernel.MAX_ACTIVE_SLOTS + 1)


def test_cpu_walk_runs_plain_and_counts_no_launch():
    before = walk_kernel.launches
    filters, topics = _corpus(1, 50, 10, 4)
    _t, args = _inputs(filters, topics, 4, batch=64)
    nfa_walk(*_torch(args), active_slots=16)
    assert walk_kernel.launches == before


@pytest.mark.parametrize("K,flat_cap", [(32, 8 * 101), (8, 120), (128, 1)])
def test_flat_epilogue_plain_equals_reference(K, flat_cap):
    """The flat epilogue alone on seeded accept slots (rows of every
    density, spills, rows past K, caps that drop rows): the port's
    ``epilogue`` on the CPU (its plain version, no launch) against the
    reference's ``flat_epilogue``."""
    from emqx_tpu.ops.match_kernel import flat_epilogue as ref_flat
    from emqx_tpu_torch.ops import match_kernel as mk

    acc, aover = mk.random_accepts(K + flat_cap, 101, accept_cols(16, 16))
    n = (acc >= 0).sum(axis=1).astype(np.int32)
    before = walk_kernel.flat_launches
    got = mk.epilogue(torch.from_numpy(acc), torch.from_numpy(aover), K,
                      True, flat_cap)
    assert walk_kernel.flat_launches == before
    matches, mover, meta = ref_flat(jnp.asarray(acc), jnp.asarray(n),
                                    jnp.asarray(aover), K, flat_cap)
    for g, w in zip((got.matches, got.n_matches, got.match_overflow,
                     got.row_meta), (matches, n, mover, meta)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (n > K).any() and (aover > 0).any()


def test_flat_epilogue_wrapper_rejects_other_devices():
    """The flat wrappers (the fused walks and the epilogue over raw
    slots) take cuda or cpu tensors and nothing else."""
    from emqx_tpu_torch.ops import match_kernel as mk

    args = [a.to("meta") for a in _good_args()]
    with pytest.raises(ValueError, match="cuda or cpu"):
        walk_kernel.nfa_walk_flat(*args, active_slots=8, max_matches=4,
                                  flat_cap=16)
    with pytest.raises(ValueError, match="cuda or cpu"):
        walk_kernel.join_walk_flat(*args, None, None, active_slots=8,
                                   max_matches=4, flat_cap=16)
    acc = torch.zeros((4, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        mk.epilogue(acc, torch.zeros((4,), dtype=torch.int32,
                                     device="meta"), 4, True, 16)