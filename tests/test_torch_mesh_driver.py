"""parallel/mesh.py and parallel/driver.py of the port.

The data-parallel step over 1, 2 and 4 CPU "devices" equals the unsplit
ungapped and gapped steps; part files written by 2 and by 3 processes run
one after the other and merged equal align_file / align_files, SE and PE,
and equal what salt_tpu's driver writes from the same files.  Tolerance:
exact."""

import io
import os

import pytest
import torch

from salt_tpu_torch.io.sam import sam_header
from salt_tpu_torch.parallel import driver, mesh
from salt_tpu_torch.pipeline.device_index import to_device_index
from salt_tpu_torch.pipeline.engine import (
    SEAligner,
    SEOptions,
    encode_reads,
    revcomp,
)
from salt_tpu_torch.pipeline.pe_engine import PEAligner, PEOptions
from salt_tpu_torch.pipeline.se import se_gapped, se_ungapped

from torch_fixtures import planted_pairs, port_index, tiny_fixture, tiny_genome

OPTS = dict(l_overlap=1, max_locate=500, print_nm_md=True,
            print_xa_cigar=True, batch_size=32, gap_batch=16)
STEP_KW = dict(l_overlap=1, max_seed=50, max_locate=200, cap=256, u=32,
               k_hits=8)


@pytest.fixture(scope="module")
def tiny():
    idx, records = tiny_fixture()
    return port_index(idx), records[:104]


def _flat(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for field in tree for t in _flat(field)]


@pytest.mark.parametrize("n_devices", [1, 2, 4])
def test_sharded_full_step_equals_unsplit(tiny, n_devices):
    idx, records = tiny
    codes = encode_reads([r.seq for r in records])
    fwd, rev = torch.from_numpy(codes), torch.from_numpy(revcomp(codes))
    dix = to_device_index(idx, "cpu")
    want_u = se_ungapped(dix, fwd, rev, **STEP_KW)
    want_g = se_gapped(dix, fwd, rev, want_u.loci0, want_u.loci1, k=10, u=32,
                       k_hits=8)
    devices = mesh.make_mesh(n_devices, device="cpu")
    assert devices == [torch.device("cpu")] * n_devices
    got_u, got_g = mesh.sharded_full_step(devices, dix, fwd, rev, gap_k=10,
                                          **STEP_KW)
    assert type(got_u) is type(want_u) and type(got_g) is type(want_g)
    for g, w in zip(_flat(got_u) + _flat(got_g), _flat(want_u) + _flat(want_g)):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert (want_g.res.found & ~want_u.res.found).any()   # the gapped path ran
    only = mesh.sharded_se_ungapped(devices, dix, fwd, rev, **STEP_KW)
    for g, w in zip(_flat(only), _flat(want_u)):
        assert torch.equal(g, w)


def test_mesh_rules(tiny):
    idx, _records = tiny
    dix = to_device_index(idx, "cpu")
    copies = mesh.replicate(["cpu", "cpu", "cpu"], dix)
    assert len(copies) == 3 and copies[0] is copies[1] is copies[2]
    assert copies[0].sa_cat.data_ptr() == dix.sa_cat.data_ptr()
    parts = mesh.shard_reads(["cpu"] * 4, torch.arange(24).reshape(12, 2))
    assert [p.shape[0] for p in parts] == [3] * 4
    assert torch.equal(torch.cat(parts), torch.arange(24).reshape(12, 2))
    with pytest.raises(ValueError, match="does not divide"):
        mesh.shard_reads(["cpu"] * 5, torch.zeros(12, 2))
    assert mesh.make_mesh(device="cpu") == [torch.device("cpu")]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh.make_mesh()


def _write_fastq(path, records):
    with open(path, "w") as fh:
        for r in records:
            fh.write(f"@{r.name}\n{r.seq}\n+\n{r.qual}\n")
    return str(path)


def _merged(idx, out_dir):
    buf = io.StringIO()
    n = driver.merge_parts(out_dir, buf, sam_header(idx, "test", None))
    return n, buf.getvalue()


@pytest.fixture(scope="module")
def se_files(tiny, tmp_path_factory):
    idx, records = tiny
    d = tmp_path_factory.mktemp("driver_se")
    fq = _write_fastq(d / "reads.fq", records)
    al = SEAligner(idx, SEOptions(**OPTS), device="cpu")
    whole = io.StringIO()
    al.align_file(fq, whole, cmd="test")
    return idx, al, fq, d, whole.getvalue()


@pytest.mark.parametrize("n_processes", [2, 3])
def test_se_parts_merge_to_align_file(se_files, n_processes):
    idx, al, fq, d, whole = se_files
    out_dir = str(d / f"parts{n_processes}")
    mine = [driver.align_file_sharded(al, fq, out_dir, pid, n_processes,
                                      batch_size=16)
            for pid in range(n_processes)]
    flat = [i for m in mine for i in m]
    assert sorted(flat) == list(range(7)) and len(set(flat)) == 7  # 104 / 16
    assert all(i % n_processes == pid for pid, m in enumerate(mine) for i in m)
    n, text = _merged(idx, out_dir)
    assert n == 7 and text == whole


def test_resume_aligns_nothing_and_ignores_a_stray_tmp(se_files):
    idx, al, fq, d, whole = se_files
    out_dir = d / "resume"
    first = driver.align_file_sharded(al, fq, str(out_dir), 0, 1, batch_size=40)
    assert first == [0, 1, 2]
    os.remove(out_dir / "part_00000001.sam")
    (out_dir / "part_00000001.sam.tmp").write_text("garbage\n")
    stamps = {p: os.stat(out_dir / p).st_mtime_ns for p in os.listdir(out_dir)}

    calls = []

    class Counting:
        def align_records(self, batch):
            calls.append(len(batch))
            return al.align_records(batch)

    again = driver.align_file_sharded(Counting(), fq, str(out_dir), 0, 1,
                                      batch_size=40)
    assert again == [0, 1, 2] and calls == [40]      # only the missing part
    assert not (out_dir / "part_00000001.sam.tmp").exists()
    for p in ("part_00000000.sam", "part_00000002.sam"):
        assert os.stat(out_dir / p).st_mtime_ns == stamps[p]
    calls.clear()
    driver.align_file_sharded(Counting(), fq, str(out_dir), 0, 1, batch_size=40)
    assert calls == []                               # a second run: nothing
    (out_dir / "part_00000009.sam.tmp").write_text("garbage\n")
    assert _merged(idx, str(out_dir)) == (3, whole)
    # resume=False aligns everything again
    driver.align_file_sharded(Counting(), fq, str(out_dir), 0, 1,
                              batch_size=40, resume=False)
    assert calls == [40, 40, 24]


@pytest.fixture(scope="module")
def pe_files(tmp_path_factory):
    idx, genome, _pos, _stype, rng = tiny_genome()
    r1, r2 = planted_pairs(genome, rng, n_pairs=40)
    d = tmp_path_factory.mktemp("driver_pe")
    return (idx, _write_fastq(d / "r1.fq", r1), _write_fastq(d / "r2.fq", r2),
            d)


@pytest.mark.parametrize("n_processes", [2, 3])
def test_pe_parts_merge_to_align_files(pe_files, n_processes):
    jidx, fq1, fq2, d = pe_files
    idx = port_index(jidx)
    al = PEAligner(idx, PEOptions(**OPTS), device="cpu")
    whole = io.StringIO()
    al.align_files(fq1, fq2, whole, cmd="test")
    out_dir = str(d / f"parts{n_processes}")
    mine = [driver.align_file_sharded(al, fq1, out_dir, pid, n_processes,
                                      batch_size=12, fastq2=fq2)
            for pid in range(n_processes)]
    assert sorted(i for m in mine for i in m) == [0, 1, 2, 3]   # 40 / 12
    assert _merged(idx, out_dir) == (4, whole.getvalue())


@pytest.mark.parametrize("paired", [False, True])
def test_parts_equal_salt_tpu_drivers(se_files, pe_files, tmp_path, paired):
    """The same files through salt_tpu's driver and aligners: the same part
    files, byte for byte."""
    from salt_tpu.parallel import driver as jdriver
    from salt_tpu.pipeline.engine import SEAligner as JaxSE
    from salt_tpu.pipeline.engine import SEOptions as JaxSEOptions
    from salt_tpu.pipeline.pe_engine import PEAligner as JaxPE
    from salt_tpu.pipeline.pe_engine import PEOptions as JaxPEOptions

    if paired:
        jidx, fq1, fq2, _d = pe_files
        ours = PEAligner(port_index(jidx), PEOptions(**OPTS), device="cpu")
        theirs = JaxPE(jidx, JaxPEOptions(**OPTS))
        size = 12
    else:
        fq1, fq2 = se_files[2], None
        jidx = tiny_fixture()[0]
        ours, theirs, size = se_files[1], JaxSE(jidx, JaxSEOptions(**OPTS)), 40
    for pid in range(2):
        a = driver.align_file_sharded(ours, fq1, str(tmp_path / "ours"), pid, 2,
                                      batch_size=size, fastq2=fq2)
        b = jdriver.align_file_sharded(theirs, fq1, str(tmp_path / "theirs"),
                                       pid, 2, batch_size=size, fastq2=fq2)
        assert a == b
    names = sorted(os.listdir(tmp_path / "ours"))
    assert names == sorted(os.listdir(tmp_path / "theirs")) and len(names) >= 3
    for p in names:
        assert (tmp_path / "ours" / p).read_bytes() == \
            (tmp_path / "theirs" / p).read_bytes()
        assert driver.part_name("x", int(p[5:13])) == os.path.join("x", p)


def test_maybe_init_distributed_reads_the_environment(monkeypatch):
    for name in ("SALT_TPU_COORDINATOR", "SALT_TPU_NUM_PROCESSES",
                 "SALT_TPU_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    assert driver.maybe_init_distributed() == (0, 1)
    monkeypatch.setenv("SALT_TPU_COORDINATOR", "host0:1234")
    monkeypatch.setenv("SALT_TPU_NUM_PROCESSES", "4")
    monkeypatch.setenv("SALT_TPU_PROCESS_ID", "3")
    assert driver.maybe_init_distributed() == (3, 4)
    monkeypatch.setenv("SALT_TPU_PROCESS_ID", "4")
    with pytest.raises(ValueError, match="outside"):
        driver.maybe_init_distributed()
    batches = list(driver._batches(iter(range(10)), 4))
    assert batches == [(0, [0, 1, 2, 3]), (1, [4, 5, 6, 7]), (2, [8, 9])]
