"""Multi-host data-parallel alignment driver.

Port of salt_tpu/parallel/driver.py.  The reference scales with pthreads
in one process (alnse.c:1268-1310); the equivalent here is data
parallelism over reads across hosts: every host streams its own
deterministic shard of the FASTQ (batch-interleaved), aligns on its local
devices, and writes per-batch part files; any host (or a post step)
concatenates the parts in batch order, preserving the reference's
SAM-records-in-input-order contract (alnse.c:1433-1439).

The processes exchange no tensor, only the directory of part files, so
there is no process group to set up.  The sharding/merge logic is
process-count agnostic and is exercised in tests by running the shards
one after the other in one process.
"""

from __future__ import annotations

import os
from typing import Iterator, List, Optional, Tuple

from ..io.fasta import read_records
from ..utils.metrics import log, progress

BATCH = 100_000


def maybe_init_distributed() -> Tuple[int, int]:
    """(process_id, n_processes) from SALT_TPU_PROCESS_ID and
    SALT_TPU_NUM_PROCESSES.  There is nothing to initialize: processes
    share only the part directory.  SALT_TPU_COORDINATOR is read for the
    log line alone."""
    coord = os.environ.get("SALT_TPU_COORDINATOR")
    npro = int(os.environ.get("SALT_TPU_NUM_PROCESSES", "1"))
    pid = int(os.environ.get("SALT_TPU_PROCESS_ID", "0"))
    if not 0 <= pid < npro:
        raise ValueError(f"SALT_TPU_PROCESS_ID={pid} outside "
                         f"[0, SALT_TPU_NUM_PROCESSES={npro})")
    if npro > 1:
        log(f"process {pid}/{npro}"
            + (f" (coordinator {coord}, not contacted)" if coord else ""))
    return pid, npro


def _batches(records: Iterator, batch_size: int):
    batch: List = []
    idx = 0
    for rec in records:
        batch.append(rec)
        if len(batch) >= batch_size:
            yield idx, batch
            batch = []
            idx += 1
    if batch:
        yield idx, batch


def part_name(out_dir: str, batch_idx: int) -> str:
    return os.path.join(out_dir, f"part_{batch_idx:08d}.sam")


def _write_part(out_dir: str, idx: int, lines) -> None:
    """Crash-safe part write: .tmp then atomic rename, so a part file's
    existence certifies its completeness (checkpoint/resume unit)."""
    final = part_name(out_dir, idx)
    tmp = final + ".tmp"
    with open(tmp, "w") as fh:
        for line in lines:
            fh.write(line)
            fh.write("\n")
    os.replace(tmp, final)


def align_file_sharded(
    aligner,
    fastq: str,
    out_dir: str,
    process_id: int,
    n_processes: int,
    batch_size: int = BATCH,
    fastq2: Optional[str] = None,
    resume: bool = True,
) -> List[int]:
    """Align this host's shard (batches where idx % n == pid); one part
    file per batch.  Works for SE (`align_records`) and PE
    (`align_pairs` when fastq2 given).  Returns the batch indices this
    process produced.

    With `resume` (default), batches whose part file already exists are
    skipped — part files are written atomically, so an interrupted run
    restarts from its last completed batch (the reference's streaming
    batch design made restartable, SURVEY.md §5.3/§5.4)."""
    os.makedirs(out_dir, exist_ok=True)
    mine: List[int] = []
    n_done = 0
    if fastq2 is None:
        stream = _batches(read_records(fastq), batch_size)
        for idx, batch in stream:
            if idx % n_processes != process_id:
                continue
            if resume and os.path.exists(part_name(out_dir, idx)):
                log(f"part {idx} already complete, skipping (resume)")
                mine.append(idx)
                continue
            _write_part(out_dir, idx, aligner.align_records(batch))
            mine.append(idx)
            n_done += len(batch)
            progress(n_done, f"reads (shard {process_id}/{n_processes})")
    else:
        stream = zip(
            _batches(read_records(fastq), batch_size),
            _batches(read_records(fastq2), batch_size),
        )
        for (idx, b1), (_, b2) in stream:
            if idx % n_processes != process_id:
                continue
            if resume and os.path.exists(part_name(out_dir, idx)):
                log(f"part {idx} already complete, skipping (resume)")
                mine.append(idx)
                continue
            _write_part(out_dir, idx, aligner.align_pairs(b1, b2))
            mine.append(idx)
            n_done += len(b1)
            progress(n_done, f"pairs (shard {process_id}/{n_processes})")
    return mine


def merge_parts(out_dir: str, out_fh, header: str) -> int:
    """Concatenate part files in batch order (ordering contract).
    Returns the number of parts merged."""
    parts = sorted(
        f for f in os.listdir(out_dir)
        if f.startswith("part_") and f.endswith(".sam")
    )
    print(header, file=out_fh)
    for p in parts:
        with open(os.path.join(out_dir, p)) as fh:
            for line in fh:
                out_fh.write(line)
    return len(parts)
