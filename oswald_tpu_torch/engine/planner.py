"""Device-memory capacity planner: pick the data mode a database fits in.

The port of oswald_tpu/engine/planner.py, with the port's own arithmetic.
The CUDA kernels read residues and the 24x24 matrix directly, so there is
no 24x score profile, and `precompute` and `stream` are one resident path.
The ladder therefore has two rungs:

  precompute   the packed residues resident on the device (1 byte per
               padded residue) with the kernels' H/F scratch (8 bytes per
               padded residue); `stream` is the same path.
  host_stream  the packed residues stay on the host (memory-mapped) and
               stream through the device in slices, double-buffered under
               the kernels.  Device cost is two slices and one scratch,
               independent of the database's size: the mode for databases
               larger than device memory.

A resident plan counts the residues, the scratch, the per-slot vectors
(sorted id, validity, ln length) and the score and top-k key rows of the
widest packed batch.  None of these grows with the query: the scratch holds
one H and one F row per subject whatever the query's length.  So, unlike
the reference planner, which budgets scan state for the longest accepted
query, `max_query_len` does not move the plan here (a deliberate
difference); it is kept in the Plan for the record.

There is no default device-memory size: a device that reports none (the
CPU) with no `hbm_budget_bytes` configured has no limit, and the plan is
resident.
"""

import dataclasses

import torch

# Fraction of device memory the planner will commit to residency; the rest
# covers the allocator's fragmentation and transient tensors.
SAFETY_FRACTION = 0.8
MAX_QUERY_LEN_DEFAULT = 5478
GROUP_LANES = 1024
# kernel scratch: one int32 H row and one int32 F row per padded residue
SCRATCH_BYTES_PER_RESIDUE = 8
# per slot: int32 sorted id, bool validity, float32 ln length
SLOT_BYTES = 4 + 1 + 4
# per slot and query of a packed batch: the int32 score, the int64 key the
# top-k is taken over with the int64 temporaries that build it, and the
# float32 temporaries of the moments
BATCH_SLOT_BYTES = 4 + 4 * 8 + 4 * 4
# queries of the widest packed launch (engine.search.MIXED_PACK_SEGS)
BATCH_SEGS = 32


def device_hbm_bytes(device=None):
    """Total memory of a CUDA device in bytes; None for a device that
    reports none (the CPU)."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda":
        return None
    return int(torch.cuda.mem_get_info(device)[1])


def db_padded_bytes(db) -> int:
    """Packed residue bytes (1 byte each) over all bins, padding included."""
    total = 0
    for L in db.bin_lengths:
        total += int(db.bins[L]["seq"].shape[0]) * L * GROUP_LANES
    return total


def db_slots(db) -> int:
    """Slots (lanes) over all bins."""
    return sum(int(db.bins[L]["seq"].shape[0]) for L in db.bin_lengths) * \
        GROUP_LANES


def state_bytes(residue_bytes: int, slots: int,
                batch_segs: int = BATCH_SEGS) -> int:
    """Device bytes beside the residues themselves for `residue_bytes` of
    packed residues in `slots` slots: the kernel scratch, the per-slot
    vectors and the widest batch's score and key rows."""
    return (SCRATCH_BYTES_PER_RESIDUE * residue_bytes +
            (SLOT_BYTES + batch_segs * BATCH_SLOT_BYTES) * slots)


@dataclasses.dataclass
class Plan:
    mode: str                 # "precompute" | "host_stream"
    db_bytes: int             # padded residue bytes (per device share)
    profile_bytes: int        # always 0: the port keeps no score profile
    state_bytes: int          # scratch, per-slot vectors, batch rows
    budget_bytes: int | None  # SAFETY_FRACTION * device memory; None = no
                              # limit known
    max_query_len: int = MAX_QUERY_LEN_DEFAULT   # recorded, moves nothing

    @property
    def resident_bytes(self) -> int:
        """What the resident mode needs on the device."""
        return self.db_bytes + self.profile_bytes + self.state_bytes

    def describe(self) -> str:
        gib = 1 << 30
        budget = "no limit" if self.budget_bytes is None else \
            f"{self.budget_bytes / gib:.2f} GiB"
        msg = (f"profile_mode={self.mode} (planner: db "
               f"{self.db_bytes / gib:.2f} GiB packed, profiles "
               f"{self.profile_bytes / gib:.2f} GiB, kernel scratch and "
               f"batch state {self.state_bytes / gib:.2f} GiB, device "
               f"memory budget {budget})")
        if self.mode != "precompute":
            # the degrade is deliberate and visible
            msg += (" — degraded from precompute: the resident database "
                    "with its scratch exceeds the budget, so it streams "
                    "from host memory on every search")
        return msg


def plan_profile_mode(db, hbm_bytes: int | None = None, n_devices: int = 1,
                      max_query_len: int | None = None, config=None) -> Plan:
    """Pick the most resident data mode that fits the device-memory budget.

    hbm_bytes: the device's memory (SearchConfig.hbm_budget_bytes, or
    device_hbm_bytes(device)); None means no limit is known and the plan is
    resident.  n_devices: the group axis shards evenly, so each device
    holds a 1/n share.  max_query_len is recorded only (see module).
    config: the engine's SearchConfig; a config that packs nothing
    (batch_query_pack_rows too small for two row blocks) needs no batch
    rows beyond one query's."""
    mq = max_query_len if max_query_len is not None else \
        MAX_QUERY_LEN_DEFAULT
    n = max(n_devices, 1)
    share = -(-db_padded_bytes(db) // n)
    slots = -(-db_slots(db) // n)
    segs = BATCH_SEGS
    if config is not None and \
            config.batch_query_pack_rows // max(config.u_rows, 1) < 2:
        segs = 1
    state = state_bytes(share, slots, segs)
    budget = None if hbm_bytes is None else int(SAFETY_FRACTION * hbm_bytes)
    mode = "precompute" if budget is None or share + state <= budget \
        else "host_stream"
    return Plan(mode=mode, db_bytes=share, profile_bytes=0,
                state_bytes=state, budget_bytes=budget, max_query_len=mq)


def host_stream_bytes(slice_bytes: int, slice_slots: int,
                      batch_segs: int = BATCH_SEGS) -> int:
    """Device bytes of a host_stream engine whose largest slice holds
    `slice_bytes` of residues in `slice_slots` slots: two slice buffers,
    one scratch, and the score rows of the widest launch for two slices in
    flight."""
    return ((2 + SCRATCH_BYTES_PER_RESIDUE) * slice_bytes +
            2 * batch_segs * 4 * slice_slots)
