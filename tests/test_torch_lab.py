"""oswald_tpu_torch.kernels.sw_lab against scripts/kernel_lab.py.

`sw_groups_lab_ref` (what `sw_groups_lab` runs on a CPU tensor: plain
PyTorch that carries out each variant's own algebra) is held, variant by
variant, to the JAX lab kernel `sw_chunk_lab` chained over a bin by its
`_scan_bin`, in interpret mode, on the shapes of the lab's own
`check_parity`; `base` and `dpx`, whose recurrence is the shipping one, to
the shipping `sw_chunk` chained the same way.  The same residues go to both
sides: [G, C, 128, 8, 128] chunks for the JAX profile, [G * L, 8, 128]
columns for the port.  Tolerance: exact int32.  The lab kernel has no tail
chunks and no query lengths off its row quantum; the port's variants are
also held to each other there.  The CUDA kernel is checked on a card by
tests/test_torch_gpu.py and, at full size, by chip_smoke.py.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oswald_tpu.alphabet import DUMMY
from oswald_tpu.kernels import build_profile, sw_chunk
from oswald_tpu.submat import get_submat
from oswald_tpu_torch.kernels import sw_lab
from oswald_tpu_torch.kernels.sw_lab import (VARIANTS, ptxas_report,
                                             sw_groups_lab,
                                             sw_groups_lab_ref,
                                             sw_lanes_lab_ref)
from oswald_tpu_torch.kernels.sw_lanes import sw_groups_ref, sw_lanes_ref

from conftest import random_protein

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain scorer's tensors are small: one thread is fastest, and the
    test workers do not fight over the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def kernel_lab():
    """scripts/kernel_lab.py as a module (it is a script, not a package
    member)."""
    spec = importlib.util.spec_from_file_location(
        "kernel_lab", REPO / "scripts" / "kernel_lab.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# (m, G, L, u_rows, group_block, col_unroll): check_parity's shapes
LAB_SHAPES = ((64, 2, 256, 8, 2, 8), (32, 3, 128, 4, 3, 4),
              (24, 2, 128, 8, 1, 2))


def _torch_args(seq, query, sm):
    """[G, L, 8, 128] residues as sw_groups' inputs."""
    G, L = seq.shape[:2]
    return (torch.from_numpy(seq.reshape(G * L, 8, 128)),
            torch.tensor([(g * L, L) for g in range(G)], dtype=torch.int32),
            torch.from_numpy(np.asarray(query, np.int32)),
            torch.from_numpy(np.asarray(sm, np.int32)))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_variant_matches_jax_lab_kernel(kernel_lab, variant):
    rng = np.random.default_rng(1)
    sm = get_submat("blosum62")
    # noadj at the default 10/2 (blosum62's minimum of -4 is its boundary
    # case), the others at an asymmetric 11/1, as check_parity does
    og, eg = (10, 2) if variant == "noadj" else (11, 1)
    for m, G, L, u, gb, cu in LAB_SHAPES:
        C = L // 128
        q = rng.integers(0, 23, m).astype(np.int32)
        seq = rng.integers(0, 23, (G, C, 128, 8, 128)).astype(np.int8)
        prof = jnp.stack([build_profile(jnp.asarray(seq[:, c]),
                                        sm.astype("int8"))
                          for c in range(C)])
        gaps = jnp.asarray([og, eg], jnp.int32)
        if variant in ("base", "dpx"):
            want = kernel_lab._scan_bin(sw_chunk, jnp.asarray(q), gaps, prof,
                                        u, gb, jnp.int32, cu, interpret=True)
        else:
            want = kernel_lab._scan_bin(
                kernel_lab.sw_chunk_lab, jnp.asarray(q), gaps, prof, u, gb,
                jnp.int32, cu, interpret=True, variant=variant)
        got = sw_groups_lab_ref(
            *_torch_args(seq.reshape(G, L, 8, 128), q, sm), og, eg, variant)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _random_bin(rng, G, L):
    res = rng.integers(0, 23, size=(G, L, 8, 128)).astype(np.int8)
    lens = rng.integers(0, L + 1, size=(G, 1, 8, 128))
    return np.where(np.arange(L)[None, :, None, None] < lens, res,
                    np.int8(DUMMY)).astype(np.int8)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_variants_agree_on_tails_and_odd_lengths(variant):
    """Bins with 32/64/96-column tails and query lengths of one row, a
    partial strip and two strips and a row: every variant gives the
    shipping plain version's scores, under three scoring settings."""
    cases = ((32, 1, "blosum62", 10, 2), (96, 9, "pam30", 7, 1),
             (160, 33, "blosum62", 0, 0), (64, 17, "blosum62", 11, 1))
    for L, m, matrix, og, eg in cases:
        rng = np.random.default_rng(L * 100 + m)
        args = _torch_args(_random_bin(rng, 1, L), random_protein(rng, m),
                           get_submat(matrix))
        want = sw_groups_ref(*args, og, eg)
        before = sw_lab.launches_lab
        got = sw_groups_lab(*args, og, eg, variant)     # CPU: plain version
        assert sw_lab.launches_lab == before
        np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_mixed_table_and_subtable():
    """A table mixing group lengths, and one group out of it."""
    rng = np.random.default_rng(5)
    bins = [_random_bin(rng, G, L) for G, L in ((2, 32), (1, 96))]
    res = torch.from_numpy(np.concatenate(
        [b.reshape(-1, 8, 128) for b in bins]))
    table = torch.tensor([(0, 32), (32, 32), (64, 96)], dtype=torch.int32)
    q = torch.from_numpy(random_protein(rng, 20).astype(np.int32))
    sm = torch.from_numpy(get_submat("blosum62").astype(np.int32))
    want = sw_groups_ref(res, table, q, sm, 10, 2)
    for variant in ("fscan", "ks"):
        got = sw_groups_lab_ref(res, table, q, sm, 10, 2, variant)
        np.testing.assert_array_equal(got.numpy(), want.numpy())
        one = sw_groups_lab_ref(res, table[2:3].contiguous(), q, sm, 10, 2,
                                variant)
        np.testing.assert_array_equal(one.numpy(), want[2:3].numpy())


def test_lanes_ref_takes_raw_columns():
    rng = np.random.default_rng(6)
    cols = torch.from_numpy(rng.integers(0, 23, (40, 50)).astype(np.int8))
    q = torch.from_numpy(random_protein(rng, 19).astype(np.int32))
    sm = torch.from_numpy(get_submat("pam30").astype(np.int32))
    want = sw_lanes_ref(cols, q, sm, 7, 1)
    for variant in VARIANTS:
        np.testing.assert_array_equal(
            sw_lanes_lab_ref(cols, q, sm, 7, 1, variant).numpy(),
            want.numpy())


@pytest.mark.parametrize("fn", [sw_groups_lab, sw_groups_lab_ref])
def test_unknown_variant_raises(fn):
    rng = np.random.default_rng(7)
    args = _torch_args(_random_bin(rng, 1, 32), random_protein(rng, 5),
                       get_submat("blosum62"))
    with pytest.raises(ValueError, match="unknown variant 'fast'"):
        fn(*args, 10, 2, "fast")


def test_variant_names_cover_the_jax_lab():
    """Every body of _kernel_lab, the shipping one, and the card's own."""
    assert set(VARIANTS) == {"base", "fscan", "ks", "pmax", "noadj", "pre",
                             "dpx"}
    assert sorted(VARIANTS.values()) == list(range(len(VARIANTS)))
    src = (REPO / "oswald_tpu_torch/kernels/csrc/sw_cell_lab.cuh").read_text()
    for name, index in VARIANTS.items():
        assert f"k{name.capitalize()} = {index}" in src


def test_wrong_inputs_rejected():
    rng = np.random.default_rng(8)
    res, table, q, sm = _torch_args(_random_bin(rng, 1, 32),
                                    random_protein(rng, 5),
                                    get_submat("blosum62"))
    with pytest.raises(ValueError, match="query must be torch.int32"):
        sw_groups_lab(res, table, q.to(torch.int64), sm, 10, 2, "fscan")
    with pytest.raises(ValueError, match="lies outside"):
        sw_groups_lab(res, torch.tensor([[0, 64]], dtype=torch.int32), q, sm,
                      10, 2, "fscan")


def test_ptxas_report_names_variants():
    log = ("ptxas info    : Compiling entry function '_ZN4_GLOBAL__N_20"
           "sw_groups_lab_kernelILi4ELb1EEEvPKa' for 'sm_90a'\n"
           "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill "
           "loads\n"
           "ptxas info    : Used 96 registers, used 1 barriers\n"
           "ptxas info    : Compiling entry function '_ZN4_GLOBAL__N_20"
           "sw_groups_lab_kernelILi0ELb0EEEvPKa' for 'sm_90a'\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
           "loads\n"
           "ptxas info    : Used 80 registers, used 1 barriers\n")
    assert ptxas_report(log) == {
        "ks+ahead": "96 registers, 8 bytes spill stores, 4 bytes spill "
                    "loads",
        "base": "80 registers, 0 bytes spill stores, 0 bytes spill loads"}
    assert ptxas_report(None) == {}
