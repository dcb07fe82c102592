"""A packed database as the port's device state.

`to_device` turns the host `PackedDB` (oswald_tpu_torch.io.db, possibly
memory-mapped) into what `sw_groups` reads: every group of every bin back
to back in one int8 column buffer, plus a table of (first column, L) per
group.  Slots (one per lane) run in the same order as the JAX engine's:
bins ascending, groups in bin order.  The JAX engine also pads each bin to
a multiple of `group_block` groups; the port has no such padding, so its
slot vector may be shorter, but its valid slots come in the same order,
which keeps "lowest slot" meaning "lowest sorted id" on both sides.
"""

import dataclasses

import numpy as np
import torch

from oswald_tpu_torch.io.db import PackedDB, SUBLANES, LANES, db_len_stats


@dataclasses.dataclass
class DeviceDB:
    residues: torch.Tensor    # int8[C, 8, 128], groups back to back
    groups: torch.Tensor      # int32[G, 2]: (first column, L)
    ids_flat: np.ndarray      # int32[G * 1024] sorted id per slot, -1 = pad
    valid: torch.Tensor       # bool[G * 1024], ids_flat >= 0
    lnl: torch.Tensor         # float32[G * 1024] ln(subject length), 0 = pad


def to_device(db: PackedDB, device) -> DeviceDB:
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
    ids_flat = np.concatenate(ids) if ids else np.zeros(0, np.int32)
    lnl_by_id = db_len_stats(db)[0]
    lnl_flat = np.where(
        ids_flat >= 0,
        lnl_by_id[np.maximum(ids_flat, 0)] if len(lnl_by_id) else 0.0,
        0.0).astype(np.float32)
    groups = torch.tensor(table, dtype=torch.int32).reshape(-1, 2)
    return DeviceDB(
        residues=residues,
        groups=groups.to(device),
        ids_flat=ids_flat,
        valid=torch.from_numpy(ids_flat >= 0).to(device),
        lnl=torch.from_numpy(lnl_flat).to(device))
