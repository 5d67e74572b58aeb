"""The port's own host modules (constants, index build and store, FASTA
and SNP readers, SAM assembly, SSW, native loader) against salt_tpu's on
seeded inputs.  Everything is integers or bytes: tolerance 0."""

import dataclasses
import io
import os
import types

import numpy as np
import pytest

import salt_tpu.constants as jconst
import salt_tpu.io.sam as jsam
from salt_tpu.index import build as jbuild
from salt_tpu.index import store as jstore
from salt_tpu.io.fasta import parse_records as jparse
from salt_tpu.io.snp import SnpBlock as JSnpBlock
from salt_tpu.io.snp import read_snp_blocks as jread_snps
from salt_tpu.ops import ssw as jssw
from salt_tpu.pipeline.pe_engine import _End as JEnd
from salt_tpu.utils.rand48 import Rand48 as JRand48

import salt_tpu_torch.constants as tconst
import salt_tpu_torch.io.sam as tsam
from salt_tpu_torch.index import build as tbuild
from salt_tpu_torch.index import store as tstore
from salt_tpu_torch.io.fasta import parse_records as tparse
from salt_tpu_torch.io.snp import SnpBlock as TSnpBlock
from salt_tpu_torch.io.snp import read_snp_blocks as tread_snps
from salt_tpu_torch.ops import ssw as tssw
from salt_tpu_torch.pipeline.pe_engine import _End as TEnd
from salt_tpu_torch.utils import metrics as tmetrics
from salt_tpu_torch.utils import native as tnative
from salt_tpu_torch.utils.rand48 import Rand48 as TRand48

from torch_fixtures import tiny_genome


def _same_index(a, b):
    for f in dataclasses.fields(tbuild.SaltIndex):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if f.name == "contigs":
            assert [dataclasses.astuple(c) for c in va] == \
                [dataclasses.astuple(c) for c in vb]
        elif isinstance(va, np.ndarray) or isinstance(vb, np.ndarray):
            assert va.dtype == vb.dtype and np.array_equal(va, vb), f.name
        else:
            assert va == vb, f.name


@pytest.fixture(scope="module")
def tiny():
    """salt_tpu's index of the tiny genome and the inputs it was built
    from, with an N run and a second contig so N randomization and contig
    offsets are exercised."""
    idx, genome, snp_pos, stype, _rng = tiny_genome()
    genome = genome[:1000] + "N" * 7 + genome[1007:]
    contigs = [("chr1", "synthetic", genome), ("chr2", "(null)", genome[300:900])]
    blocks = [(name, pos, st) for name, pos, st in
              (("chr1", snp_pos, np.array(stype, np.uint8)),
               ("chr2", np.array([17, 250], np.uint32),
                np.array([0x03, 0x2C], np.uint8)))]
    want = jbuild.build_index_from_data(
        contigs, [JSnpBlock(*b) for b in blocks], l_seed=19)
    return want, contigs, blocks


def test_constants_equal():
    names = [n for n in dir(jconst) if n.isupper()]
    assert names and names == [n for n in dir(tconst) if n.isupper()]
    for n in names:
        a, b = getattr(jconst, n), getattr(tconst, n)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), n
        else:
            assert a == b, n


@pytest.mark.parametrize("mode", ["exact", "reference_compat"])
def test_index_build_every_array_equal(tiny, mode):
    _want, contigs, blocks = tiny
    want = jbuild.build_index_from_data(
        contigs, [JSnpBlock(*b) for b in blocks], l_seed=19,
        r_anchor_mode=mode)
    got = tbuild.build_index_from_data(
        contigs, [TSnpBlock(*b) for b in blocks], l_seed=19,
        r_anchor_mode=mode)
    assert isinstance(got, tbuild.SaltIndex)
    _same_index(got, want)


def test_index_from_arrays_round_trip(tiny):
    want = tiny[0]
    got = tbuild.index_from_arrays(want)
    assert isinstance(got, tbuild.SaltIndex)
    assert all(isinstance(c, tbuild.Contig) for c in got.contigs)
    _same_index(got, want)
    assert got.mixref is want.mixref          # arrays are not copied
    offs, lens = got.contig_arrays()
    assert offs.tolist() == [0, 4096] and lens.tolist() == [4096, 600]


@pytest.mark.parametrize("writer", ["port", "salt_tpu"])
def test_save_and_load_index(tiny, tmp_path, writer):
    """Either package's saved index loads in the port, field for field."""
    want = tiny[0]
    prefix = str(tmp_path / "idx")
    if writer == "port":
        tstore.save_index(tbuild.index_from_arrays(want), prefix)
    else:
        jstore.save_index(want, prefix)
    got = tstore.load_index(prefix)
    assert isinstance(got, tbuild.SaltIndex)
    ref = jstore.load_index(prefix)
    _same_index(got, ref)
    for name in ("pac", "mixref", "cbwt", "csa", "rbwt", "r_coord", "lkt"):
        assert np.array_equal(getattr(got, name), getattr(want, name)), name


def test_fasta_snp_readers_and_rand48_equal(tmp_path):
    text = ("@r1/1 c\nACGTNACGT\n+\nIIIIIIIII\n@r2\nTTGA\n+\nII#I\n"
            ">chrA anno\nACGTAC\nGGT\n>chrB\nNNAC\n")
    fields = [(r.name, r.comment, r.seq, r.qual)
              for r in tparse(io.StringIO(text))]
    assert fields == [(r.name, r.comment, r.seq, r.qual)
                      for r in jparse(io.StringIO(text))]
    snps = tmp_path / "snps.txt"
    snps.write_text("chr1\t5\tA/G\tA\nchr1\t90\tC/T\tT\nchr2\t7\tA/C/T\tC\n")
    got = [(b.chrom, b.pos.tolist(), b.stype.tolist())
           for b in tread_snps(str(snps))]
    want = [(b.chrom, b.pos.tolist(), b.stype.tolist())
            for b in jread_snps(str(snps))]
    assert got == want and len(got) == 2
    assert TRand48(11).lrand48_many(20) == JRand48(11).lrand48_many(20)


def test_emit_se_and_md_tags_equal(tiny):
    want_idx = tiny[0]
    idx = tbuild.index_from_arrays(want_idx)
    rng = np.random.default_rng(2)
    L = 60
    pos = rng.integers(0, 4000, 12).astype(np.int64)
    pos[-2:] = [4096 + 10, 4096 + 500]        # on the second contig
    reads = want_idx.pac[pos[:, None] + np.arange(L)].copy()
    reads[rng.random(reads.shape) < 0.05] ^= 1
    tags = tsam.md_nm_tags_batch(idx, pos, reads)
    assert tags == jsam.md_nm_tags_batch(want_idx, pos, reads)
    assert tsam.sam_header(idx, "cmd x", "rg") == \
        jsam.sam_header(want_idx, "cmd x", "rg")
    for i, p in enumerate(pos.tolist()):
        rseq = (3 - reads[i][::-1]).astype(np.uint8)
        for strand, cigar, tag in ((0, f"{L}M", tags[i]), (1, f"{L}M", None),
                                   (0, f"5S{L - 5}M", None)):
            args = (f"r{i}", reads[i], rseq, "I" * L, p, strand, 37, cigar,
                    "", True, "rg")
            kw = dict(seq_start=5 if "S" in cigar else 0, md_tag=tag)
            assert tsam.emit_se(idx, *args, **kw) == \
                jsam.emit_se(want_idx, *args, **kw)
    unmapped = ("u", reads[0], reads[0], None, tconst.UINT32_MAX, 3, 0, "",
                "", True, None)
    assert tsam.emit_se(idx, *unmapped) == jsam.emit_se(want_idx, *unmapped)
    xa = [(0, 30, 1, None), (1, 4096 + 40, 2, "10M1D50M"), (0, 77, 0, None)]
    for print_cigar in (False, True):
        assert tsam.build_xa(idx, 77, L, xa, print_cigar) == \
            jsam.build_xa(want_idx, 77, L, xa, print_cigar)


def _ends(cls, rng, L, l_pac):
    """A seeded pair of PE end states of class `cls`."""
    ends = []
    for _ in (0, 1):
        seq = rng.integers(0, 4, L).astype(np.uint8)
        e = cls("pair", seq, (3 - seq[::-1]).astype(np.uint8), "I" * L)
        if rng.random() < 0.8:
            e.pos = int(rng.integers(0, l_pac - 700))
            e.strand = int(rng.integers(0, 2))
            e.mapq = int(rng.integers(0, 255))
            e.n_diff = int(rng.integers(0, 4))
            if rng.random() < 0.3:
                e.seq_start, e.seq_end = 4, L - 3
                e.cigar = f"{L - 6}M"
            else:
                e.cigar = f"{L}M"
            e.hits = ([(int(rng.integers(0, l_pac - 700)), 1, 0)],
                      [(int(rng.integers(0, l_pac - 700)), 2, 0)])
        ends.append(e)
    if ends[0].pos != tconst.UINT32_MAX and ends[1].pos != tconst.UINT32_MAX:
        ends[1].pos = ends[0].pos + int(rng.integers(-100, 500))
    return ends


def test_emit_pe_equal(tiny):
    want_idx = tiny[0]
    idx = tbuild.index_from_arrays(want_idx)
    n_mapped = 0
    for seed in range(40):
        t0, t1 = _ends(TEnd, np.random.default_rng(seed), 50, idx.l_pac)
        j0, j1 = _ends(JEnd, np.random.default_rng(seed), 50, idx.l_pac)
        for xa_cigar in (False, True):
            got = tsam.emit_pe(idx, t0, t1, 250, 550, xa_cigar, True, "g")
            want = jsam.emit_pe(want_idx, j0, j1, 250, 550, xa_cigar, True, "g")
            assert got == want
        n_mapped += got[0].split("\t")[2] != "*"
    assert n_mapped > 20


def test_contig_offsets_follow_a_reused_id():
    """An index that takes a freed index's id gets its own contig
    offsets, not the cached ones of the index that had the id."""
    def index(offsets):
        return types.SimpleNamespace(contigs=[
            types.SimpleNamespace(offset=o) for o in offsets])

    reused = 0
    for _ in range(50):
        a = index([0])
        assert tsam.contig_offsets(a).tolist() == [0]
        freed = id(a)
        del a
        b = index([0, 4000, 9000])
        reused += id(b) == freed
        assert tsam.contig_offsets(b).tolist() == [0, 4000, 9000]
        assert tsam.coor_pac2real(tsam.contig_offsets(b), 3, 9500) == 2
    assert reused > 0


@pytest.mark.parametrize("mat_name", ["SCORE_MAT16", "SCORE_MAT5"])
def test_ssw_align_equal(mat_name):
    """The port's native SSW (its own build) and its numpy emulation
    against salt_tpu's, result field by field, cigar included."""
    rng = np.random.default_rng(31)
    tmat, jmat = getattr(tssw, mat_name), getattr(jssw, mat_name)
    assert np.array_equal(tmat, jmat)
    snp = mat_name == "SCORE_MAT16"
    for case in range(12):
        L, W = 60, int(rng.integers(70, 200))
        codes = rng.integers(0, 4, W)
        at = int(rng.integers(0, W - L))
        read = list(codes[at : at + L])
        for _ in range(int(rng.integers(0, 5))):
            j = int(rng.integers(0, L))
            read[j] = (read[j] + 1) % 4
        if case % 2:
            del read[20:22]
            read += [0, 1]
        read = np.array(read)
        if snp:
            ref = (1 << codes).astype(np.int8)
            ref[rng.integers(0, W, 3)] |= 1 << int(rng.integers(0, 4))
            q = (1 << read).astype(np.int8)
        else:
            ref, q = codes.astype(np.int8), read.astype(np.int8)
        got = tssw.ssw_align(q, ref, tmat, 3, 1, L // 2)
        want = jssw.ssw_align(q, ref, jmat, 3, 1, L // 2)
        assert dataclasses.astuple(got) == dataclasses.astuple(want)
        assert got.cigar and got.score1 > 20
        if case < 2:
            py = tssw.ssw_align_py(q, ref, tmat, 3, 1, L // 2)
            assert dataclasses.astuple(py) == dataclasses.astuple(got)


def test_native_library_is_the_ports_own():
    """The host library builds from the port's sources into its _build
    directory and exports its helpers."""
    lib = tnative.load_native()
    assert tnative.LIBRARY.parent.name == "_build"
    assert tnative.LIBRARY.parent.parent.name == "salt_tpu_torch"
    assert tnative.LIBRARY.exists()
    assert all(s.parent.name == "csrc" and s.exists() for s in tnative.SOURCES)
    assert hasattr(lib, "salt_sais_u8_i32") and hasattr(lib, "salt_ssw_align")
    assert hasattr(lib, "salt_lv_cigar_batch")


def test_failed_native_build_raises(tmp_path):
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="failed"):
        tnative.build_library(["g++", "-shared", "-fPIC"], (bad,),
                              tmp_path / "out" / "libbad.so")
    with pytest.raises(RuntimeError, match="not found"):
        tnative.build_library(["no-such-compiler-xyz"], (bad,),
                              tmp_path / "out" / "libbad.so")
    assert not (tmp_path / "out" / "libbad.so").exists()


def test_suffix_array_native_and_doubling_agree():
    from salt_tpu.index.suffix import suffix_array as jsa
    from salt_tpu_torch.index.suffix import _suffix_array_doubling, suffix_array

    rng = np.random.default_rng(9)
    text = rng.integers(0, 4, (1 << 16) + 500).astype(np.uint8)   # native
    sa = suffix_array(text)
    assert sa.dtype == np.int32 and np.array_equal(sa, jsa(text))
    small = text[:3000]
    assert np.array_equal(suffix_array(small), _suffix_array_doubling(small))


def test_metrics_stage_registry():
    with tmetrics.device_trace("unset"):     # a no-op without SALT_TPU_TRACE
        pass
    tmetrics.metrics_reset()
    with tmetrics.stage("a"):
        pass
    with tmetrics.stage("a"):
        pass
    tot, cnt = tmetrics.metrics()["a"]
    assert cnt == 2 and tot >= 0
    assert "a" in tmetrics.metrics_report(io.StringIO())
    tmetrics.metrics_reset()
    assert tmetrics.metrics() == {}


def test_package_import_turns_hugepage_hint_off():
    import salt_tpu_torch

    assert callable(salt_tpu_torch._tune_host_alloc)
    if os.environ.get("SALT_TPU_MADVISE_HUGEPAGE") != "1":
        assert os.environ.get("NUMPY_MADVISE_HUGEPAGE") == "0"
    assert isinstance(salt_tpu_torch, types.ModuleType)
