"""oswald_tpu_torch.kernels.sw_lab against scripts/kernel_lab.py.

`sw_groups_lab_ref` (what `sw_groups_lab` runs on a CPU tensor: plain
PyTorch that carries out each variant's own algebra) and
`sw_groups_lab_tiled_ref` (the same algebra by the kernel's decomposition:
work items, strips dealt to the sets of a pipelined item, column tiles, the
hand-over) are held, variant by variant, to the JAX lab kernel
`sw_chunk_lab` chained over a bin by its `_scan_bin`, in interpret mode, on
the shapes of the lab's own `check_parity`, at its own strip heights u;
`base` and `dpx`, whose recurrence is the shipping one, to the shipping
`sw_chunk` chained the same way.  The same residues go to both sides:
[G, C, 128, 8, 128] chunks for the JAX profile, [G * L, 8, 128] columns for
the port.  Tolerance: exact int32.  The lab kernel has no tail chunks and no
query lengths off its row quantum; there the port's variants are held to
the shipping plain version at the strip heights the kernel is built for.
The CUDA kernel is checked on a card by tests/test_torch_gpu.py and, at
full size, by chip_smoke.py.
"""

import importlib.util
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oswald_tpu.alphabet import DUMMY
from oswald_tpu.kernels import build_profile, sw_chunk
from oswald_tpu.submat import get_submat
from oswald_tpu_torch.kernels import sw_lab
from oswald_tpu_torch.kernels.sw_lab import (BUILT, VARIANTS, label,
                                             ptxas_report, sw_groups_lab,
                                             sw_groups_lab_ref,
                                             sw_groups_lab_tiled_ref,
                                             sw_lanes_lab_ref)
from oswald_tpu_torch.kernels.sw_lanes import (STRIP_ROWS, sw_groups_ref,
                                               sw_lanes_ref, work_table)

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
        args = _torch_args(seq.reshape(G, L, 8, 128), q, sm)
        got = sw_groups_lab_ref(*args, og, eg, variant, strip_rows=u)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        if L == 128:
            # the decomposition on the first group, dealt out as rows (the
            # pipelined role: test_tiled_lab_ref_matches_plain_version)
            one = (args[0][:L], args[1][:1].contiguous(), *args[2:])
            tiled = sw_groups_lab_tiled_ref(*one, og, eg, variant,
                                            work=work_table(one[1], 1 << 30),
                                            strip_rows=u)
            np.testing.assert_array_equal(tiled.numpy(),
                                          np.asarray(want)[:1])


def _random_bin(rng, G, L):
    res = rng.integers(0, 23, size=(G, L, 8, 128)).astype(np.int8)
    lens = rng.integers(0, L + 1, size=(G, 1, 8, 128))
    return np.where(np.arange(L)[None, :, None, None] < lens, res,
                    np.int8(DUMMY)).astype(np.int8)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_variants_agree_on_tails_and_odd_lengths(variant):
    """Bins with 32/64/96-column tails and query lengths of one row, a
    partial strip and two strips and a row: every variant, at every strip
    height it is built for, gives the shipping plain version's scores,
    under three scoring settings."""
    cases = ((32, 1, "blosum62", 10, 2), (96, 9, "pam30", 7, 1),
             (160, 33, "blosum62", 0, 0), (64, 17, "blosum62", 11, 1))
    kernels = sorted((u, a) for v, u, a in BUILT if v == variant)
    for L, m, matrix, og, eg in cases:
        rng = np.random.default_rng(L * 100 + m)
        args = _torch_args(_random_bin(rng, 1, L), random_protein(rng, m),
                           get_submat(matrix))
        want = sw_groups_ref(*args, og, eg)
        before = sw_lab.launches_lab
        for u, ahead in kernels:
            # CPU: the plain version
            got = sw_groups_lab(*args, og, eg, variant, load_ahead=ahead,
                                strip_rows=u)
            np.testing.assert_array_equal(got.numpy(), want.numpy())
        assert sw_lab.launches_lab == before


def _mixed_bins(rng):
    """A table of three groups whose default work table deals the 44-column
    one out as pipelined slabs and the others as rows when long_from is 40;
    lengths below a tile, no multiple of it, and one tail each."""
    bins = [_random_bin(rng, 1, L) for L in (5, 44, 27)]
    res = torch.from_numpy(np.concatenate([b.reshape(-1, 8, 128)
                                           for b in bins]))
    table = torch.tensor([(0, 5), (5, 44), (49, 27)], dtype=torch.int32)
    return res, table


# every variant at every strip height the kernel knows, one query length
# of 1 / 9 / 33 / 65 each in turn (one row, a partial strip, several
# strips), the gaps of the JAX lab's checks
TILED_CASES = [(v, u, (1, 9, 33, 65)[(i + j) % 4])
               for i, v in enumerate(VARIANTS) for j, u in enumerate((8, 16,
                                                                      32))]


@pytest.mark.parametrize("variant,u,m", TILED_CASES)
def test_tiled_lab_ref_matches_plain_version(variant, u, m):
    """sw_groups_lab_tiled_ref, the kernel's decomposition with the
    variant's column update, on a table that mixes rows and pipelined slabs:
    the shipping plain version's scores, exact."""
    rng = np.random.default_rng(m * 10 + u)
    res, table = _mixed_bins(rng)
    q = torch.from_numpy(random_protein(rng, m).astype(np.int32))
    sm = torch.from_numpy(get_submat("blosum62").astype(np.int32))
    og, eg = (10, 2) if variant == "noadj" else (11, 1)
    want = sw_groups_ref(res, table, q, sm, og, eg)
    got = sw_groups_lab_tiled_ref(res, table, q, sm, og, eg, variant,
                                  work=work_table(table, 40), strip_rows=u)
    assert got.dtype == torch.int32 and got.shape == want.shape
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
           "sw_groups_lab_kernelILi16ELi4ELb1EEEvPKa' for 'sm_90a'\n"
           "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill "
           "loads\n"
           "ptxas info    : Used 96 registers, used 1 barriers\n"
           "ptxas info    : Compiling entry function '_ZN4_GLOBAL__N_20"
           "sw_groups_lab_kernelILi32ELi0ELb0EEEvPKa' for 'sm_90a'\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
           "loads\n"
           "ptxas info    : Used 80 registers, used 1 barriers\n"
           "ptxas info    : Compiling entry function '_ZN4_GLOBAL__N_20"
           "sw_groups_kernelILi16EEEvPKa' for 'sm_90a'\n"
           "ptxas info    : Used 120 registers, used 1 barriers\n")
    assert ptxas_report(log) == {
        "ks@16+ahead": "96 registers, 8 bytes spill stores, 4 bytes spill "
                       "loads",
        "base@32": "80 registers, 0 bytes spill stores, 0 bytes spill loads"}
    assert ptxas_report(None) == {}


def test_built_kernels_and_labels():
    """Every variant in both placements at the engine's strip height, base
    and dpx ahead at half and twice it; the C entry dispatches on the same
    strip heights; a kernel that is not built is refused on every device
    before anything runs, naming what is built."""
    assert len(BUILT) == 18
    assert {(v, a) for v, u, a in BUILT if u == STRIP_ROWS} == \
        {(v, a) for v in VARIANTS for a in (False, True)}
    assert {(v, u) for v, u, a in BUILT if u != STRIP_ROWS} == \
        {(v, u) for v in ("base", "dpx") for u in (8, 32)}
    assert label("dpx", 32, True) == "dpx@32+ahead"
    assert label("pre") == "pre@16"
    src = (REPO / "oswald_tpu_torch/kernels/csrc/sw_groups_lab.cu").read_text()
    for u in {u for _, u, _ in BUILT}:
        assert f"SW_LAB_LAUNCH({u}, " in src or f"rows == {u}" in src
    rng = np.random.default_rng(9)
    args = _torch_args(_random_bin(rng, 1, 32), random_protein(rng, 5),
                       get_submat("blosum62"))
    before = sw_lab.launches_lab
    for variant, u, ahead in (("ks", 8, True), ("fscan", 32, True),
                              ("base", 8, False), ("base", 12, True)):
        with pytest.raises(ValueError,
                           match=re.escape(f"{label(variant, u, ahead)} "
                                           "is not built")):
            sw_groups_lab(*args, 10, 2, variant, load_ahead=ahead,
                          strip_rows=u)
    assert sw_lab.launches_lab == before
