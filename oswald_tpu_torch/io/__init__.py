from oswald_tpu_torch.io.fasta import parse_fasta, write_fasta
from oswald_tpu_torch.io.db import (
    PackedDB, pack_sequences, unpack_group, preprocess_db, save_db, load_db,
    load_queries, from_reference, LazyTitles,
    GROUP_LANES, SUBLANES, LANES, LENGTH_QUANTUM,
)
from oswald_tpu_torch.io.device_db import DeviceDB, to_device

__all__ = [
    "parse_fasta", "write_fasta",
    "PackedDB", "pack_sequences", "unpack_group", "preprocess_db", "save_db",
    "load_db", "load_queries", "from_reference", "LazyTitles",
    "GROUP_LANES", "SUBLANES", "LANES", "LENGTH_QUANTUM",
    "DeviceDB", "to_device",
]
