"""The port's anti-diagonal oracle (oswald_tpu_torch.core.oracle) against
the JAX package's (oswald_tpu.core.oracle) on the same seeded inputs:
scores bit for bit and the int32 dtype, for single pairs and batches, both
gap settings of the parity suite (blosum62 10/2 and pam30 7/1, whose matrix
minimum is negative), queries with DUMMY padding rows, m = 1 and n = 1, and
subjects whose cells past their true length hold residues that must be
masked.  The scalar oracle `sw_score_numpy` of either package is the third
opinion."""

import numpy as np
import pytest
import torch

from oswald_tpu.core import oracle as jax_oracle
from oswald_tpu_torch.alphabet import DUMMY
from oswald_tpu_torch.core import (sw_score_diag, sw_score_diag_batch,
                                   sw_score_numpy)
from oswald_tpu_torch.submat import get_submat

from conftest import random_protein

GAPS = [("blosum62", 10, 2), ("pam30", 7, 1)]


def _same(ours, theirs):
    """Bit for bit, dtype included: int32 on both sides."""
    theirs = np.asarray(theirs)
    assert ours.dtype == torch.int32 and theirs.dtype == np.int32
    np.testing.assert_array_equal(ours.cpu().numpy(), theirs)


@pytest.mark.parametrize("matrix,og,eg", GAPS)
@pytest.mark.parametrize("m,n", [(1, 1), (1, 40), (40, 1), (37, 61),
                                 (96, 23)])
def test_pair_equals_jax(rng, matrix, og, eg, m, n):
    sm = get_submat(matrix)
    a, b = random_protein(rng, m), random_protein(rng, n)
    got = sw_score_diag(a, b, n, sm, og, eg)
    assert got.shape == ()
    _same(got, jax_oracle.sw_score_diag(a, b, n, sm, og, eg))
    assert int(got) == sw_score_numpy(a, b, sm, og, eg)


@pytest.mark.parametrize("matrix,og,eg", GAPS)
def test_dummy_query_rows_are_score_inert(rng, matrix, og, eg):
    """A query padded with DUMMY rows, at its end and in its middle,
    scores as the reference scores it; trailing padding changes nothing."""
    sm = get_submat(matrix)
    core, b = random_protein(rng, 30), random_protein(rng, 50)
    padded = np.concatenate([core, np.full(18, DUMMY, np.int8)])
    inner = np.concatenate([core[:12], np.full(5, DUMMY, np.int8),
                            core[12:]])
    plain = int(sw_score_diag(core, b, 50, sm, og, eg))
    for q in (padded, inner):
        got = sw_score_diag(q, b, 50, sm, og, eg)
        _same(got, jax_oracle.sw_score_diag(q, b, 50, sm, og, eg))
    assert int(sw_score_diag(padded, b, 50, sm, og, eg)) == plain


@pytest.mark.parametrize("matrix,og,eg", GAPS)
def test_batch_with_unequal_lengths_equals_jax(rng, matrix, og, eg):
    """Subjects of unequal true lengths in one [B, n] batch; the cells past
    each n_b hold real residues, not DUMMY, so only the mask hides them.
    Lengths 0 and n are among them."""
    sm = get_submat(matrix)
    B, n = 12, 70
    bs = rng.integers(0, 23, size=(B, n)).astype(np.int32)
    n_bs = np.concatenate([[0, 1, n], rng.integers(1, n, B - 3)]).astype(
        np.int32)
    for m in (1, 45):
        q = random_protein(rng, m)
        got = sw_score_diag_batch(q, bs, n_bs, sm, og, eg)
        assert got.shape == (B,)
        _same(got, jax_oracle.sw_score_diag_batch(q, bs, n_bs, sm, og, eg))
        want = [sw_score_numpy(q, bs[k, :n_bs[k]], sm, og, eg)
                for k in range(B)]
        assert got.tolist() == want
    # the batch equals its rows scored one by one
    one = [int(sw_score_diag(q, bs[k], n_bs[k], sm, og, eg))
           for k in range(B)]
    assert got.tolist() == one


def test_runs_on_the_device_of_its_inputs(rng):
    """Tensors in give the result on their device; numpy in gives the CPU."""
    sm = get_submat("blosum62")
    q = random_protein(rng, 20)
    bs = torch.from_numpy(rng.integers(0, 23, (3, 25)).astype(np.int32))
    got = sw_score_diag_batch(torch.from_numpy(q), bs,
                              torch.tensor([25, 10, 3]), sm)
    assert got.device == bs.device and got.dtype == torch.int32
    assert got.tolist() == sw_score_diag_batch(q, bs.numpy(), [25, 10, 3],
                                               sm).tolist()
