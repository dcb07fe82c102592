"""A packed database as the port's device state.

`to_device` turns the host `PackedDB` (oswald_tpu_torch.io.db, possibly
memory-mapped) into what `sw_groups` reads: every group of every bin back
to back in one int8 column buffer, plus a table of (first column, L) per
group, and the kernels' work table for that group table (the launch order,
`kernels.sw_lanes.work_table`, built once here and bound to the table).
Slots (one per lane) run in the same order as the JAX engine's: bins ascending, groups in bin order.  The JAX engine also pads each bin to
a multiple of `group_block` groups; the port has no such padding, so its
slot vector may be shorter, but its valid slots come in the same order,
which keeps "lowest slot" meaning "lowest sorted id" on both sides.

`to_host_stream` is the state of the larger-than-device-memory mode: the
database stays on the host (memory-mapped bins are not copied) and is cut
into slices of whole groups that one search streams through the device.
Slots keep the resident order, so they mean the same in every mode.
"""

import dataclasses

import numpy as np
import torch

from oswald_tpu_torch.io.db import PackedDB, SUBLANES, LANES, db_len_stats
from oswald_tpu_torch.kernels.sw_lanes import (WorkTable, fill_long_from,
                                               work_table)


@dataclasses.dataclass
class DeviceDB:
    residues: torch.Tensor    # int8[C, 8, 128], groups back to back
    groups: torch.Tensor      # int32[G, 2]: (first column, L)
    work: WorkTable           # the kernels' launch order over groups
    ids_flat: np.ndarray      # int32[G * 1024] sorted id per slot, -1 = pad
    valid: torch.Tensor       # bool[G * 1024], ids_flat >= 0
    lnl: torch.Tensor         # float32[G * 1024] ln(subject length), 0 = pad


def _slot_vectors(db: PackedDB, id_parts):
    """(ids_flat int32[n_slots], lnl_flat float32[n_slots]) from the id
    blocks of the groups in slot order."""
    ids_flat = np.concatenate(id_parts) if id_parts else \
        np.zeros(0, np.int32)
    lnl_by_id = db_len_stats(db)[0]
    lnl_flat = np.where(
        ids_flat >= 0,
        lnl_by_id[np.maximum(ids_flat, 0)] if len(lnl_by_id) else 0.0,
        0.0).astype(np.float32)
    return ids_flat, lnl_flat


def _work_table(groups, host, long_from):
    """The launch order of a group table: the default one (kept on the
    tensor) for long_from None, else groups of long_from columns or more
    pipelined, by the same rule of filling the card."""
    if long_from is None:
        return work_table(groups, host=host)
    return work_table(groups, fill_long_from(len(host), long_from), host)


def to_device(db: PackedDB, device, long_from: int = None) -> DeviceDB:
    """The resident state of `db` on `device`; long_from: the work
    table's long-role threshold (None: sw_lanes.LONG_FROM)."""
    device = torch.device(device)
    n_cols = sum(int(db.bins[L]["seq"].shape[0]) * L
                 for L in db.bin_lengths)
    residues = torch.empty((n_cols, SUBLANES, LANES), dtype=torch.int8,
                           device=device)
    table, ids = [], []
    col = 0
    for L in db.bin_lengths:
        seq = db.bins[L]["seq"]                          # [G, L, 8, 128]
        G = int(seq.shape[0])
        # copy: a memory-mapped bin is read-only
        host = np.array(seq, dtype=np.int8).reshape(G * L, SUBLANES, LANES)
        residues[col:col + G * L].copy_(torch.from_numpy(host))
        table.extend((col + g * L, L) for g in range(G))
        ids.append(np.asarray(db.bins[L]["id"], np.int32).reshape(-1))
        col += G * L
    ids_flat, lnl_flat = _slot_vectors(db, ids)
    host = torch.tensor(table, dtype=torch.int32).reshape(-1, 2)
    groups = host.to(device)
    return DeviceDB(
        residues=residues,
        groups=groups,
        work=_work_table(groups, host, long_from),
        ids_flat=ids_flat,
        valid=torch.from_numpy(ids_flat >= 0).to(device),
        lnl=torch.from_numpy(lnl_flat).to(device))


@dataclasses.dataclass
class HostSlice:
    """One transfer unit of the host_stream mode: whole groups of one or
    more bins, back to back in one int8 buffer."""
    spans: list               # [(L, lo, take)]: groups lo..lo+take of bin L
    n_cols: int               # residue columns ([8, 128] each) of the slice
    slot0: int                # first slot of the slice
    groups: torch.Tensor      # int32[Gs, 2]: (first column in the slice, L)
    work: WorkTable           # the kernels' launch order over groups

    @property
    def n_bytes(self) -> int:
        return self.n_cols * SUBLANES * LANES

    @property
    def n_slots(self) -> int:
        return int(self.groups.shape[0]) * SUBLANES * LANES


@dataclasses.dataclass
class HostStreamDB:
    slices: list              # [HostSlice], in slot order
    budget_bytes: int         # the slice budget the cut used
    ids_flat: np.ndarray      # int32[n_slots] sorted id per slot, -1 = pad
    lnl_flat: np.ndarray      # float32[n_slots] ln(subject length), 0 = pad

    @property
    def max_cols(self) -> int:
        return max((s.n_cols for s in self.slices), default=0)


def slice_budget_bytes(total_bytes: int, slice_mb: int) -> int:
    """The slice size for a database of total_bytes under a configured
    host_stream_slice_mb: about an eighth of the database, so that the
    double buffer has slices to overlap, floored at 16 MiB so that the
    cost of one transfer stays small beside its bytes; a smaller
    configured size is always honoured."""
    conf = slice_mb << 20
    budget = min(conf, max(-(-total_bytes // 8), 1))
    return max(budget, min(conf, 16 << 20))


def to_host_stream(db: PackedDB, device, slice_mb: int,
                   long_from: int = None) -> HostStreamDB:
    """Cut the whole database into slices of at most the slice budget.
    A slice holds spans (L, lo, take), windows of whole groups of one bin,
    and may cross bin boundaries; a group larger than the budget is a
    one-span slice of its own.  Only each slice's group table and work table go to
    the device here; the residues stay where the database keeps them.
    long_from is the work tables' long-role threshold, as for to_device."""
    device = torch.device(device)
    lanes = SUBLANES * LANES
    total = sum(int(db.bins[L]["seq"].shape[0]) * L * lanes
                for L in db.bin_lengths)
    budget = slice_budget_bytes(total, slice_mb)
    slices, ids = [], []
    spans, table, cols, slot = [], [], 0, 0

    def close():
        nonlocal spans, table, cols, slot
        if spans:
            host = torch.tensor(table, dtype=torch.int32).reshape(-1, 2)
            groups = host.to(device)
            slices.append(HostSlice(spans, cols, slot, groups,
                                    _work_table(groups, host, long_from)))
            slot += len(table) * lanes
            spans, table, cols = [], [], 0

    for L in db.bin_lengths:
        G = int(db.bins[L]["seq"].shape[0])
        ids_np = np.asarray(db.bins[L]["id"], np.int32)
        lo = 0
        while lo < G:
            room = (budget - cols * lanes) // (L * lanes)
            if room < 1:
                if spans:
                    close()
                    continue
                room = 1             # a group larger than the budget
            take = min(room, G - lo)
            spans.append((L, lo, take))
            table.extend((cols + g * L, L) for g in range(take))
            cols += take * L
            ids.append(ids_np[lo:lo + take].reshape(-1))
            lo += take
    close()
    ids_flat, lnl_flat = _slot_vectors(db, ids)
    return HostStreamDB(slices, budget, ids_flat, lnl_flat)


def fill_slice(db: PackedDB, sl: HostSlice, out: np.ndarray):
    """Copy the slice's residues from the database's bins (possibly
    memory-mapped, read-only) into the flat int8 array `out`."""
    off = 0
    for L, lo, take in sl.spans:
        n = take * L * SUBLANES * LANES
        out[off:off + n] = np.asarray(
            db.bins[L]["seq"][lo:lo + take]).reshape(-1)
        off += n
