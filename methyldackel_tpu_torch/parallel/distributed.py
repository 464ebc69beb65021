"""Multi-host execution scaffolding.

Counterpart of ``methyldackel_tpu/parallel/distributed.py`` under the same
names. The reference's scale-out story ends at pthreads on one machine; this
one spans two levels:

- Host level: genome windows are statically partitioned across hosts
  — host h owns every window w with w % n_hosts == h. Window outputs are
  written per-host and concatenated in window order afterwards (or streamed
  through host 0), so output bytes are identical to a single-host run for
  any host count: the multi-host analogue of the reference's ticket-ordered
  flush (extract.c:514-535).
- Device level: within a host, the (dp, sp) grid of ``parallel.mesh`` shards
  read batches and window coordinates across the local devices.

Mate-pair locality holds by construction: a window's compute consumes every
read overlapping that window (both mates of an overlapping pair are fetched
by the same host), matching the reference's chunk-local overlap handling
(overlaps.c:12-14, common.c:441).

A job is either simulated from independent processes (``MDTPU_NUM_HOSTS`` /
``MDTPU_HOST_ID``; the caller merges with ``merge-shards`` once every host
has exited) or live: a ``torch.distributed`` process group over PyTorch's
own variables (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``,
what ``torchrun`` sets). The group always uses the ``gloo`` backend,
whatever the compute device: the job needs one barrier and moves no tensor,
and two ranks that share one card cannot form an NCCL group. The window
partition, the shard names and the merge (``owned_windows``,
``merge_host_outputs``, ``merge_shards``, ``_main``) hold no device code and
are the JAX package's, line for line.
"""
from __future__ import annotations

import os


def _live() -> bool:
    """This process is a rank of an initialized torch.distributed job."""
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def _shutdown():
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def init_distributed(coordinator: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None):
    """Initialize torch.distributed (gloo) from explicit args or the
    standard env (MASTER_ADDR + MASTER_PORT / WORLD_SIZE / RANK). Returns
    (process_id, num_processes); (0, 1) when not in a multi-host job. The
    group is destroyed when the process exits."""
    if coordinator is None:
        addr = os.environ.get("MASTER_ADDR")
        port = os.environ.get("MASTER_PORT")
        if addr and port:
            coordinator = f"{addr}:{port}"
    if coordinator is None:
        return 0, 1
    num_processes = int(num_processes or os.environ.get("WORLD_SIZE", 1))
    process_id = int(process_id if process_id is not None
                     else os.environ.get("RANK", 0))
    if num_processes <= 1:
        return 0, 1
    import atexit

    import torch.distributed as dist

    if not dist.is_initialized():
        dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                                world_size=num_processes, rank=process_id)
        atexit.register(_shutdown)
    return process_id, num_processes


def owned_windows(windows_iter, process_id: int, num_processes: int):
    """Round-robin static window partition over hosts (host-level sharding
    of the genome cursor). Deterministic: no coordination needed beyond the
    static assignment; outputs reassemble in window order."""
    for i, w in enumerate(windows_iter):
        if i % num_processes == process_id:
            yield i, w


def merge_host_outputs(prefix: str, out_path: str, num_processes: int,
                       n_windows: int) -> None:
    """Concatenate per-host per-window shards (written as
    f"{prefix}.h{h}.w{i}") into one output in window order."""
    with open(out_path, "a") as out:
        for i in range(n_windows):
            shard = f"{prefix}.h{i % num_processes}.w{i}"
            if os.path.exists(shard):
                with open(shard) as fh:
                    out.write(fh.read())
                os.unlink(shard)


def host_role() -> tuple[int, int]:
    """(host_id, n_hosts) for this process. MDTPU_NUM_HOSTS/MDTPU_HOST_ID
    simulate a multi-host job from independent processes (each owning its
    window residue class); else a live torch.distributed job is joined
    (MASTER_ADDR + MASTER_PORT) or, when the caller initialized one already,
    read; else one host."""
    n = os.environ.get("MDTPU_NUM_HOSTS")
    if n:
        return int(os.environ.get("MDTPU_HOST_ID", "0")), int(n)
    if _live():
        import torch.distributed as dist

        return dist.get_rank(), dist.get_world_size()
    if os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        return init_distributed()
    return 0, 1


def merge_shards(out_path: str) -> int:
    """Append every `{out_path}.h{h}.w{i}` shard to out_path in window
    order (the multi-host analogue of the reference's ticket-ordered flush,
    extract.c:514-535) and remove the shards. Returns #shards merged.

    Window ownership is a static residue class per host, so shard names
    never collide and the merged bytes are identical to a single-host run
    for any host count."""
    import glob
    import re

    shards = []
    for p in glob.glob(glob.escape(out_path) + ".h*.w*"):
        m = re.search(r"\.h(\d+)\.w(\d+)$", p)
        if m:
            shards.append((int(m.group(2)), p))
    shards.sort()
    n = 0
    # Exclusive merger lock (flock, auto-released by the kernel if the
    # merger dies — an O_EXCL lockfile would wedge every future merge
    # after a crash): a second concurrent merger bails out instead of
    # interleaving appends into out_path. (The rename claim below only
    # guarantees each shard is consumed once; it cannot order two writers'
    # appends. In a correctly configured job only host 0 merges, so this
    # lock is a belt-and-braces guard.)
    import fcntl

    lock_path = out_path + ".merge.lock"
    lock_fd = os.open(lock_path, os.O_CREAT | os.O_WRONLY)
    try:
        fcntl.flock(lock_fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
    except OSError:
        os.close(lock_fd)
        return 0
    try:
        with open(out_path, "a") as out:
            for _, p in shards:
                # Claim via atomic rename: each shard is consumed exactly
                # once instead of racing glob→open→unlink.
                claimed = p + ".merging"
                try:
                    os.rename(p, claimed)
                except FileNotFoundError:
                    continue
                with open(claimed) as fh:
                    out.write(fh.read())
                os.unlink(claimed)
                n += 1
    finally:
        # closing releases the flock; the (empty) lockfile stays — safe to
        # leave, and unlinking would race a concurrent locker
        os.close(lock_fd)
    return n


def barrier_and_merge(out_paths) -> None:
    """In a live torch.distributed job: block until every host finished its
    windows, then host 0 merges all shards, then every host waits for the
    merge. No-op otherwise (env-simulated hosts are independent processes;
    the caller merges explicitly). A barrier that fails raises."""
    if not _live():
        return
    import torch.distributed as dist

    dist.barrier()
    if dist.get_rank() == 0:
        for p in out_paths:
            if p:
                merge_shards(p)
    dist.barrier()


def _main(argv):
    """`python -m methyldackel_tpu_torch.parallel.distributed merge-shards
    PATH...` finalizes an env-simulated multi-host run after every host
    exits."""
    if len(argv) >= 2 and argv[0] == "merge-shards":
        for p in argv[1:]:
            n = merge_shards(p)
            print(f"merged {n} shards into {p}")
        return 0
    print("usage: python -m methyldackel_tpu_torch.parallel.distributed "
          "merge-shards <out_path>...")
    return 1


if __name__ == "__main__":
    import sys

    raise SystemExit(_main(sys.argv[1:]))
