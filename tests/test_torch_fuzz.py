"""Differential fuzz: oswald_tpu_torch against oswald_tpu on random cases.

One hypothesis property draws a substitution matrix, gap penalties, a small
database (a few length bins of short subjects, packed by the JAX package and
carried across by `from_reference`), a top-k size, a packing budget and
queries of at most 96 residues; it runs once for each mode (`search`,
`search_many` batched and not, `search_stream`), on draws of its own.  Every
shipped matrix has negative entries.  The port runs on the CPU (plain PyTorch scorers), the
reference with its Pallas kernel in interpret mode.  Scores and hit ids,
and so the order of tied hits, must be identical; titles too.

The property is shown to catch a fault first: with the port's masked top-k
breaking ties on the highest slot instead of the lowest, it must fail in
every mode.
"""

import numpy as np
import pytest
import torch
from hypothesis import (HealthCheck, Phase, given, seed, settings,
                        strategies as st)

from oswald_tpu.engine import SearchConfig as JaxConfig
from oswald_tpu.engine import SearchEngine as JaxEngine
from oswald_tpu.io import pack_sequences
from oswald_tpu.submat import MATRIX_NAMES
from oswald_tpu_torch.engine import SearchConfig, SearchEngine
from oswald_tpu_torch.engine import search as torch_search
from oswald_tpu_torch.io import from_reference

MODES = ("search", "search_many", "search_many_unbatched", "search_stream")
EXAMPLES = 3                                # for each mode


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain scorer's tensors are small: one thread is fastest, and the
    test workers do not fight over the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@st.composite
def cases(draw, mode):
    """(database arguments, config arguments, mode, queries)."""
    rng = np.random.default_rng(draw(st.integers(0, 2 ** 32 - 1)))
    # over one group of 1024 lanes, so that the subjects can spread over
    # more than one bin
    n = draw(st.integers(1025, 1600))
    lengths = rng.integers(1, draw(st.integers(8, 100)), size=n)
    flat = rng.integers(0, 23, size=int(lengths.sum())).astype(np.int8)
    bin_cost = draw(st.sampled_from([1, 64]))
    config = dict(matrix=draw(st.sampled_from(MATRIX_NAMES)),
                  open_gap=draw(st.integers(0, 15)),
                  extend_gap=draw(st.integers(0, 4)),
                  top=draw(st.integers(1, 12)),
                  batch_query_pack_rows=draw(st.sampled_from([64, 128,
                                                              1024])),
                  stream_readback_window=draw(st.integers(1, 4)))
    count = 1 if mode == "search" else draw(st.integers(2, 3))
    qlens = draw(st.lists(st.integers(1, 96), min_size=count,
                          max_size=count))
    queries = [rng.integers(0, 23, size=q).astype(np.int8) for q in qlens]
    return (flat, lengths, bin_cost), config, mode, queries


def _run(engine, mode, queries):
    if mode == "search":
        return [engine.search(queries[0])]
    if mode == "search_stream":
        return engine.search_stream(queries)
    return engine.search_many(queries,
                              batch=mode == "search_many")


def check_case(case):
    (flat, lengths, bin_cost), config, mode, queries = case
    jdb = pack_sequences(flat, lengths, [f"s{i}" for i in range(len(lengths))],
                         bin_cost=bin_cost)
    want = _run(JaxEngine(jdb, JaxConfig(**config)), mode, queries)
    got = _run(SearchEngine(from_reference(jdb), SearchConfig(**config),
                            device="cpu"), mode, queries)
    assert len(got) == len(want)
    for a, b in zip(want, got):
        assert b.scores.dtype == a.scores.dtype
        np.testing.assert_array_equal(b.scores, a.scores)
        np.testing.assert_array_equal(np.asarray(b.seq_ids),
                                      np.asarray(a.seq_ids))
        assert b.titles == a.titles


FUZZ = settings(max_examples=EXAMPLES, deadline=None, database=None,
                suppress_health_check=[HealthCheck.too_slow])


def _property(mode, phases=tuple(Phase)):
    """The property over `mode`'s draws, which a fixed seed of its own
    makes the same on every run."""
    return seed(MODES.index(mode))(settings(FUZZ, phases=phases)(
        given(case=cases(mode))(check_case)))


@pytest.mark.parametrize("mode", MODES)
def test_port_equals_reference_on_random_cases(mode):
    _property(mode)()


def _topk_slots_ties_high(scores, valid, k: int):
    """The port's masked top-k with the tie-break reversed: the highest
    slot wins a tie (the fault the property must catch)."""
    slot = torch.arange(scores.shape[-1], device=scores.device,
                        dtype=torch.int64)
    key = torch.where(valid, (scores.to(torch.int64) << 32) | slot, -1)
    top = torch.topk(key, k, dim=-1).values
    return torch.stack([(top >> 32).to(torch.int32),
                        (top & 0xFFFFFFFF).to(torch.int32)], dim=-2)


@pytest.mark.parametrize("mode", MODES)
def test_fuzz_catches_a_seeded_tie_break_fault(monkeypatch, mode):
    """The same property, over the same draws, fails once the port breaks
    ties on the highest slot."""
    monkeypatch.setattr(torch_search, "_topk_slots", _topk_slots_ties_high)
    with pytest.raises(AssertionError, match="Arrays are not equal"):
        _property(mode, phases=[Phase.generate])()
