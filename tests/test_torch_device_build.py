"""The device index builders of salt_tpu_torch on the CPU: rank planes
(ops/rank.py: rank_index_on, rank_index_pair_on), packed symbol words
(pipeline/device_index.py: pack_words_into), the sampled locate tables
(sampled_sa_on) and to_device_index as a whole, against salt_tpu's device
builders run under JAX on the CPU and against the port's host route
(build_rank_index, pack_nibbles, _pack4, build_sampled_sa,
host_route_index), on the same numpy-seeded indexes: one with 250 SNPs and
N runs, one with no SNP.  Tolerance: exact (every bit, dtype and shape)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from salt_tpu.index.build import build_index_from_data
from salt_tpu.io.snp import SnpBlock
from salt_tpu.ops import rank as jrank
from salt_tpu.pipeline import device_index as jdi
from salt_tpu_torch.ops import rank
from salt_tpu_torch.pipeline import device_index as tdi
from salt_tpu_torch.pipeline.engine import SEAligner, SEOptions

from torch_fixtures import port_index, tiny_fixture

# chunks of 1, 2, 3 and 37 words cut words, planes and the '#' range at
# odd places; 2^16 is the CPU's default
CHUNKS = (1, 2, 3, 37, 1 << 16)


def _snp_index():
    """tests/test_device_index_builds.py's index: 50,000 bases, 4% N, 250
    SNP positions (those on an N dropped)."""
    rng = np.random.default_rng(11)
    seq = "".join("ACGTN"[c] for c in rng.choice(
        5, 50000, p=[0.24, 0.24, 0.24, 0.24, 0.04]))
    pos = np.sort(rng.choice(50000, 250, replace=False)).astype(np.uint32)
    ref = np.frombuffer(seq.encode(), np.uint8)[pos]
    keep, stype = [], []
    for p, c in zip(pos, ref):
        b = "ACGT".find(chr(c))
        if b >= 0:
            keep.append(p)
            stype.append((1 << b) | (1 << ((b + 1) % 4)) | (b << 4))
    return build_index_from_data(
        [("c1", "t", seq)],
        [SnpBlock("c1", np.array(keep, np.uint32), np.array(stype, np.uint8))],
        l_seed=19)


def _zero_snp_index():
    seq = "".join("ACGT"[c] for c in
                  np.random.default_rng(3).choice(4, 20000))
    return build_index_from_data([("c1", "t", seq)], [], l_seed=19)


@pytest.fixture(scope="module", params=["snp", "zero_snp"])
def index(request):
    """(kind, salt_tpu's index, the port's view of it)."""
    idx = _snp_index() if request.param == "snp" else _zero_snp_index()
    return request.param, idx, port_index(idx)


def _families(idx):
    """(symbols, cfreq) of the C and the R BWT."""
    return {"c": (idx.cbwt, np.append(idx.c_l2, 0)),
            "r": (idx.rbwt, np.append(idx.r_cumfreq, 0))}


def _same(got, want, path="index"):
    """Tensors bit-equal with the same dtype and shape, dataclasses and
    tuples field by field, other values equal."""
    if isinstance(want, torch.Tensor):
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert torch.equal(got, want), path
    elif isinstance(want, tuple):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{path}[{i}]")
    elif dataclasses.is_dataclass(want):
        for f in dataclasses.fields(want):
            _same(getattr(got, f.name), getattr(want, f.name),
                  f"{path}.{f.name}")
    else:
        assert got == want, path


# ------------------------------------------------------------ rank planes


@pytest.mark.parametrize("family", ["c", "r"])
def test_planes_match_salt_tpu_device_builders(index, family):
    """The port's planes equal salt_tpu's build_rank_index_device and its
    whole-genome _device_plane_chunked at chunk 37 (an odd tail chunk),
    both fed _pack4 of the same symbols."""
    _kind, idx, pidx = index
    syms, cfreq = _families(idx)[family]
    n_sym = len(cfreq) - 1
    words = jnp.asarray(jdi._pack4(syms))
    want = jrank.build_rank_index_device(words, len(syms), n_sym, cfreq)
    got = rank.rank_index_on("cpu", *_families(pidx)[family])
    assert (got.n, got.n_words, got.row_off) == (want.n, want.n_words, 0)
    assert got.bc.dtype == torch.int32
    assert np.array_equal(got.bc.numpy(), np.asarray(want.bc))
    chunked = np.concatenate([np.asarray(jrank._device_plane_chunked(
        words, c=c, n=len(syms), n_words=want.n_words, chunk=37))
        for c in range(n_sym)])
    assert np.array_equal(got.bc.numpy(), chunked)
    assert np.array_equal(got.cfreq.numpy(), np.asarray(want.cfreq))


def test_pair_matches_salt_tpu_pair_builder(index):
    """Both families in one plane tensor, C rows first, as salt_tpu's
    build_rank_index_pair_device_chunked writes them."""
    _kind, idx, pidx = index
    (sc, fc), (sr, fr) = _families(idx).values()
    want_c, want_r = jrank.build_rank_index_pair_device_chunked(
        jnp.asarray(jdi._pack4(sc)), len(sc), 5, fc,
        jnp.asarray(jdi._pack4(sr)), len(sr), 6, fr)
    got_c, got_r = rank.rank_index_pair_on(
        "cpu", *_families(pidx)["c"], *_families(pidx)["r"])
    assert got_c.bc is got_r.bc and rank.planes_fused(got_c, got_r)
    assert np.array_equal(got_c.bc.numpy(), np.asarray(want_c.bc))
    assert (got_r.row_off, got_r.n_words, got_c.n_words) == (
        want_r.row_off, want_r.n_words, want_c.n_words)


@pytest.mark.parametrize("chunk", CHUNKS)
def test_planes_match_host_route(index, chunk):
    """Standalone and fused planes at chunk sizes that cut words and
    planes at odd places equal the host's build_rank_index."""
    _kind, _idx, pidx = index
    fams = _families(pidx)
    host = {f: rank.build_rank_index(*fams[f]) for f in fams}
    for f in fams:
        _same(rank.rank_index_on("cpu", *fams[f], chunk=chunk), host[f], f)
    _same(rank.rank_index_pair_on("cpu", *fams["c"], *fams["r"], chunk=chunk),
          rank.fuse_rank_index_pair(host["c"], host["r"]), "pair")


@pytest.mark.parametrize("carry", [0, 2**31 - 3, 2**32 - 2, 3 * 2**32 + 5])
def test_counts_past_2g_wrap_as_numpy_stores_them(carry):
    """Exclusive counts carried past 2^31 and 2^32 keep their low 32 bits
    as numpy's int64 cumsum stored into int32 keeps them; words with bit
    31 set come out as numpy's packbits, little-endian."""
    rng = np.random.default_rng(carry % 97)
    flags = rng.random(32 * 300) < 0.6
    flags[31::32] = True                    # every word's bit 31
    rows = torch.empty((300, 2), dtype=torch.int32)
    bits = rank.flag_words(torch.from_numpy(flags.astype(np.uint8))
                           .view(torch.int64))
    after = rank.write_rows(rows, bits, torch.tensor(carry))
    per_word = flags.reshape(300, 32).sum(1)
    want = np.zeros((300, 2), np.int32)
    want[:, 0] = carry + np.concatenate([[0], np.cumsum(per_word)[:-1]])
    want[:, 1] = np.packbits(flags, bitorder="little").view("<i4")
    assert np.array_equal(rows.numpy(), want)
    assert int(after) == carry + flags.sum()


# ------------------------------------------------------------ packed words


@pytest.mark.parametrize("chunk", CHUNKS)
def test_packed_words_match_host_route(index, chunk):
    """mixRef words (pack_nibbles: two zero words past the end) and BWT
    words (_pack4: one) equal the port's numpy packing and salt_tpu's."""
    _kind, idx, pidx = index
    for vals, pad, host, jax_host in (
            (pidx.mixref, 2, tdi.pack_nibbles, jdi.pack_nibbles),
            (pidx.cbwt, 1, tdi._pack4, jdi._pack4),
            (pidx.rbwt, 1, tdi._pack4, jdi._pack4)):
        want = host(vals)
        out = torch.full(((len(vals) + 7) // 8 + pad,), -1, dtype=torch.int32)
        got = tdi.pack_words_into(vals, out, chunk).numpy().view(np.uint32)
        assert np.array_equal(got, want)
        assert np.array_equal(got, jax_host(vals))


# ------------------------------------------------------- sampled tables


@pytest.mark.parametrize("chunk", [1, 3, 1 << 16])
@pytest.mark.parametrize("intv", [8, 5, 1])
def test_sampled_tables_match_host_route(index, intv, chunk):
    """Every field of SampledSA: the rank-0 quirk, the '#' range with its
    sharp_bases, the select rows, the one-slot dummy of a zero-SNP index
    (intv 5 is no power of two, 1 samples every rank)."""
    kind, idx, pidx = index
    got = tdi.sampled_sa_on(pidx, "cpu", intv, chunk)
    _same(got, tdi.build_sampled_sa(pidx, intv))
    want = jdi.build_sampled_sa(idx, intv)
    for name in ("sel_cat", "samples_cat", "syms_cat"):
        assert np.array_equal(getattr(got, name).numpy().view(np.uint32),
                              np.asarray(getattr(want, name)).view(np.uint32))
    if kind == "zero_snp":
        assert got.samples_cat.shape[0] == got.c_n_samples + 1
        assert got.samples_cat[-1].item() == -2**31    # 0x80000000


def test_sampled_tables_raise_as_host_route(index):
    kind, _idx, pidx = index
    if kind == "snp":
        with pytest.raises(ValueError, match="inconsistent index bundle"):
            tdi.sampled_sa_on(dataclasses.replace(
                pidx, sharp_bases=np.zeros(0, np.uint32)), "cpu")
    with pytest.raises(ValueError, match="missing sharp_bases"):
        tdi.sampled_sa_on(dataclasses.replace(pidx, sharp_bases=None), "cpu")


# ---------------------------------------------------------- whole index


@pytest.mark.parametrize("mode", ["full", "sampled"])
def test_to_device_index_equals_host_route(index, mode):
    """Every tensor of to_device_index on the CPU equals the host route's;
    the table bytes too.  A zero-SNP index loads in both modes."""
    kind, _idx, pidx = index
    got = tdi.to_device_index(pidx, "cpu", mode)
    want = tdi.host_route_index(pidx, "cpu", mode)
    _same(got, want)
    dix = got[0] if mode == "sampled" else got
    assert dix.table_bytes() == (want[0] if mode == "sampled"
                                 else want).table_bytes()
    if mode == "sampled":
        assert got[1].table_bytes() == want[1].table_bytes()
        assert dix.ri_c.bc is dix.ri_r.bc
    elif kind == "zero_snp":
        assert (dix.sa_cat[dix.c_sa_len:] == -1).all()   # r_coord UINT32_MAX


@pytest.mark.parametrize("mode", ["full", "sampled"])
def test_to_device_index_runs_no_host_builder(index, mode, monkeypatch):
    """The numpy plane builder and packers are not on to_device_index's
    path."""
    _kind, _idx, pidx = index
    want = tdi.host_route_index(pidx, "cpu", mode)

    def refuse(*_a, **_k):
        raise AssertionError("host builder called")

    for mod, name in ((rank, "build_rank_index"), (tdi, "build_rank_index"),
                      (tdi, "pack_nibbles"), (tdi, "_pack_words"),
                      (tdi, "_pack4"), (tdi, "_select_rows"),
                      (tdi, "build_sampled_sa"),
                      (tdi, "fuse_rank_index_pair")):
        monkeypatch.setattr(mod, name, refuse)
    _same(tdi.to_device_index(pidx, "cpu", mode), want)


@pytest.mark.parametrize("mode", ["full", "sampled"])
def test_same_sam_on_fixture_reads(mode):
    """SE SAM over the device-built index equals the SAM over the host
    route's index on the tiny fixture's reads."""
    idx, records = tiny_fixture()
    opts = SEOptions(print_nm_md=True, print_xa_cigar=True, batch_size=64,
                     sa_mode=mode)
    al = SEAligner(port_index(idx), opts, device="cpu")
    got = al.align_records(records)
    host = tdi.host_route_index(port_index(idx), "cpu", mode)
    al.dix, al.sampled = host if mode == "sampled" else (host, None)
    want = al.align_records(records)
    assert got == want and any(l.split("\t")[2] != "*" for l in got)


def test_time_index_build_tool(capsys):
    """tools/time_index_build.py holds both routes equal and reports four
    turns; by default it asks for the card, and refuses one that is not
    there."""
    from salt_tpu_torch.tools import time_index_build

    threads = torch.get_num_threads()
    try:
        assert time_index_build.main(["100000", "--device", "cpu"]) == 0
    finally:
        torch.set_num_threads(threads)
    out = capsys.readouterr().out
    assert "bit-equal: True" in out and out.count(" s;") == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA"):
            time_index_build.main(["1000"])
