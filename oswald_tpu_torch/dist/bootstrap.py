"""Multi-process bring-up: `torch.distributed` for runs over several ranks;
the counterpart of oswald_tpu/dist/bootstrap.py.

One rank drives one device.  This is the one place that initialises the
process group; everything downstream (the distributed engine's exchange,
the pod server's broadcast) reads `world()`.

Usage, per rank:

    from oswald_tpu_torch.dist import bootstrap
    bootstrap()                        # under torchrun: env:// from its
                                       # MASTER_ADDR/MASTER_PORT/RANK/
                                       # WORLD_SIZE; elsewhere a no-op
    bootstrap("file:///tmp/x/store", 2, rank)    # explicit (tests,
    bootstrap("tcp://host0:29500", 2, rank)      # bare metal)

The backend is gloo, on every device.  A search exchanges O(k) candidates
and four score sums per query, and then two tail counts per query, after
the one readback each search already makes: a few hundred bytes on the
host, which gloo carries between CPU tensors without staging anything on
the card.  gloo is also what lets two ranks share one card (NCCL refuses
two ranks on the same device), which is how the distributed path is
exercised on a one-card host.
"""

import datetime
import os

import torch.distributed as dist

# a collective that waits longer than this fails the rank instead of
# hanging it (a peer that died leaves the others waiting)
TIMEOUT_S = 600

_TORCHRUN_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def is_bootstrapped() -> bool:
    return dist.is_available() and dist.is_initialized()


def world() -> tuple[int, int]:
    """(rank, world size) of this process: (0, 1) without a process
    group."""
    if is_bootstrapped():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def bootstrap(coordinator_address: str | None = None,
              num_processes: int | None = None,
              process_id: int | None = None,
              timeout_s: float = TIMEOUT_S) -> tuple[int, int]:
    """Initialise the gloo process group; returns (rank, world size).

    No arguments: under torchrun (its MASTER_ADDR, MASTER_PORT, RANK and
    WORLD_SIZE in the environment) the group comes up from env://; outside
    such an environment this is a no-op and the process stays a single
    rank.  Explicit arguments (all three): coordinator_address is an init
    method URL (`file://...`, `tcp://host:port`) or a bare `host:port`.
    Idempotent: a second call returns the existing layout."""
    if is_bootstrapped():
        return world()
    given = (coordinator_address, num_processes, process_id)
    timeout = datetime.timedelta(seconds=timeout_s)
    if all(v is None for v in given):
        if not all(k in os.environ for k in _TORCHRUN_ENV):
            return 0, 1
        dist.init_process_group("gloo", init_method="env://",
                                timeout=timeout)
        return world()
    if any(v is None for v in given):
        raise ValueError("bootstrap: pass coordinator_address, "
                         "num_processes and process_id together")
    if not (isinstance(num_processes, int) and num_processes >= 1 and
            isinstance(process_id, int) and
            0 <= process_id < num_processes):
        raise ValueError(f"bootstrap: process_id {process_id!r} is not a "
                         f"rank of a world of {num_processes!r}")
    url = coordinator_address if "://" in coordinator_address else \
        f"tcp://{coordinator_address}"
    dist.init_process_group("gloo", init_method=url,
                            world_size=num_processes, rank=process_id,
                            timeout=timeout)
    return world()


def shutdown() -> None:
    """Tear down the process group (test hygiene; optional in apps)."""
    if is_bootstrapped():
        dist.destroy_process_group()
