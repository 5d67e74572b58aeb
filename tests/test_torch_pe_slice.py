"""PE slice parity: salt_tpu_torch's PEAligner on CPU tensors emits SAM
byte-identical to salt_tpu's PEAligner, on wgsim pairs from a repeat
genome and on a tiny genome with planted singleton and far-apart pairs,
with the batched rescue pre-filter off and on, on mixed read lengths,
and through the CLI; the vectorized pairing fast path against the
per-pair path.  Each aligner gets its own package's index.  Tolerance:
exact."""

import io
from contextlib import redirect_stdout

import numpy as np
import pytest

from salt_tpu.io.fasta import SeqRecord
from salt_tpu.pipeline.pe_engine import PEAligner as JaxAligner
from salt_tpu.pipeline.pe_engine import PEOptions as JaxOptions
from salt_tpu_torch.index.store import save_index
from salt_tpu_torch.pipeline.pe_engine import PEAligner, PEOptions
from salt_tpu_torch.utils.metrics import metrics, metrics_reset

from torch_fixtures import planted_pairs, port_index, repeat_fixture, tiny_genome

OPTS = dict(l_overlap=1, max_locate=500, print_nm_md=True,
            print_xa_cigar=True, batch_size=64, gap_batch=16,
            device_sw_min_batch=1)


def _both(jidx, tidx, r1, r2, opts):
    want = JaxAligner(jidx, JaxOptions(**opts)).align_pairs(r1, r2)
    metrics_reset()
    got = PEAligner(tidx, PEOptions(**opts), device="cpu").align_pairs(r1, r2)
    return want, got, metrics()


def _assert_same(want, got):
    assert len(want) == len(got)
    bad = [(a, b) for a, b in zip(want, got) if a != b]
    assert not bad, f"{len(bad)}/{len(want)} records differ; first: {bad[0]}"


@pytest.fixture(scope="module")
def planted():
    idx, genome, _pos, _stype, rng = tiny_genome()
    r1, r2 = planted_pairs(genome, rng)
    return idx, port_index(idx), r1, r2


@pytest.fixture(scope="module")
def repeat(tmp_path_factory):
    idx, r1, r2 = repeat_fixture(str(tmp_path_factory.mktemp("repeat_pe")),
                                 n_reads=96, pairs=True)
    return idx, port_index(idx), r1, r2


@pytest.mark.parametrize("device_sw", ["off", "on"])
def test_planted_pairs_sam_identical(planted, device_sw):
    jidx, tidx, r1, r2 = planted
    want, got, stages = _both(jidx, tidx, r1, r2,
                              dict(OPTS, device_sw=device_sw))
    _assert_same(want, got)
    assert len(got) == 2 * len(r1)
    assert ("device.sw_score" in stages) == (device_sw == "on")
    flags = [int(line.split("\t")[1]) for line in got]
    assert sum(f & 2 > 0 for f in flags) > len(flags) // 2      # proper pairs
    assert any("S" in line.split("\t")[5] for line in got)       # SW rescue
    assert any(f & 8 for f in flags) or any(f & 2 == 0 for f in flags)


def test_planted_pairs_score_both_rescue_modes(planted):
    """With the pre-filter on, the planted pairs reach the batched scorer
    in SNP mode (pair2) and in plain mode (singleton)."""
    _jidx, tidx, r1, r2 = planted
    al = PEAligner(tidx, PEOptions(**dict(OPTS, device_sw="on")), device="cpu")
    seen = []
    real = al._se._sw_scores

    def spy(refs, reads, lens, snp_mode):
        seen.append((snp_mode, refs.shape, reads.shape, refs.dtype))
        return real(refs, reads, lens, snp_mode)

    al._se._sw_scores = spy
    al.align_pairs(r1, r2)
    assert {s[0] for s in seen} == {True, False}
    for _snp, rshape, qshape, dtype in seen:
        assert rshape[1] % 128 == 0 and qshape[1] == 104 and dtype == np.uint8


@pytest.mark.parametrize("device_sw", ["off", "on"])
def test_repeat_genome_pairs_sam_identical(repeat, device_sw):
    jidx, tidx, r1, r2 = repeat
    want, got, stages = _both(jidx, tidx, r1, r2,
                              dict(OPTS, device_sw=device_sw))
    _assert_same(want, got)
    assert stages["device.gapped"][1] > 0
    assert sum(1 for line in got if line.split("\t")[2] != "*") > len(got) // 2


def test_mixed_lengths_sam_identical(repeat):
    jidx, tidx, r1, r2 = repeat
    cut = lambda recs, lens: [
        SeqRecord(r.name, r.comment, r.seq[:L], r.qual[:L])
        for r, L in zip(recs, lens * len(recs))]
    m1, m2 = cut(r1[:48], [70, 100, 85]), cut(r2[:48], [100, 85, 70])
    want, got, _ = _both(jidx, tidx, m1, m2, dict(OPTS, device_sw="on"))
    _assert_same(want, got)
    assert {len(line.split("\t")[9]) for line in got} == {70, 85, 100}


def test_short_last_chunk_and_unequal_inputs(planted):
    """A pair count that is no multiple of the chunk, and mismatched
    input lists."""
    jidx, tidx, r1, r2 = planted
    opts = dict(OPTS, batch_size=32, device_sw="off")
    want, got, _ = _both(jidx, tidx, r1[:37], r2[:37], opts)
    _assert_same(want, got)
    with pytest.raises(ValueError, match="second-end"):
        PEAligner(tidx, PEOptions(**opts), device="cpu").align_pairs(r1, r2[:3])
    with pytest.raises(ValueError, match="Landau"):
        PEAligner(tidx, PEOptions(extend_algo="sw"), device="cpu")


def test_cli_pe_on_saved_index(planted, tmp_path):
    from salt_tpu_torch import cli

    jidx, tidx, r1, r2 = planted
    opts = dict(l_overlap=1, max_locate=500, print_nm_md=True,
                print_xa_cigar=True, batch_size=64, min_tlen=200, max_tlen=600)
    want = JaxAligner(jidx, JaxOptions(**opts)).align_pairs(r1, r2)
    save_index(tidx, str(tmp_path / "idx"))
    paths = []
    for tag, recs in (("1", r1), ("2", r2)):
        paths.append(tmp_path / f"r{tag}.fq")
        paths[-1].write_text("".join(
            f"@{r.name}\n{r.seq}\n+\n{r.qual}\n" for r in recs))
    out = io.StringIO()
    with redirect_stdout(out):
        rc = cli.main(["aln", "--device", "cpu", "-p", "-d", "-c", "-r", "1",
                       "-m", "500", "-a", "200", "-b", "600", "--batch-size",
                       "64", str(tmp_path / "idx"), str(paths[0]),
                       str(paths[1])])
    assert rc == 0
    lines = out.getvalue().split("\n")
    n_head = sum(1 for line in lines if line.startswith("@"))
    assert n_head >= 2 and all(l.startswith("@") for l in lines[:n_head])
    # align_files prints each record, which carries its own newline
    assert "\n".join(lines[n_head:]) == "".join(l + "\n" for l in want)
    with pytest.raises(SystemExit):
        cli.main(["aln", "--device", "cpu", "-p", str(tmp_path / "idx"),
                  str(paths[0])])


def _rand_res(rng, M, K, l_pac):
    found = rng.random(M) < 0.85
    pos = rng.integers(0, l_pac - 120, M).astype(np.uint32)
    return {
        "found": found,
        "pos": pos,
        "strand": rng.integers(0, 2, M),
        "n_diff": rng.integers(0, 4, M),
        "n_hits": rng.integers(0, K + 3, (M, 2)),
        "first_hit_ndiff": rng.integers(0, 4, (M, 2)),
        # position-ascending per strand, as sorted loci give them
        "hits_pos": np.sort(
            (pos[:, None, None]
             + rng.integers(-40, 400, (M, 2, K))).astype(np.uint32), axis=-1),
        "hits_ndiff": rng.integers(0, 4, (M, 2, K)),
    }


def _end_state(e):
    return (e.pos, e.strand, e.n_diff, e.is_gap, e.b0, e.b1, e.mapq,
            e.cigar, e.seq_start, e.seq_end, e.hits)


@pytest.mark.parametrize("seed", [11, 23, 47])
def test_fast_path_matches_make_state(planted, seed):
    """The port's _fill_states_fast against its _make_state, and both
    against salt_tpu's _make_state, on random hit lists."""
    jidx, tidx = planted[0], planted[1]
    al = PEAligner(tidx, PEOptions(min_tlen=250, max_tlen=550), device="cpu")
    jal = JaxAligner(jidx, JaxOptions(min_tlen=250, max_tlen=550))
    rng = np.random.default_rng(seed)
    K, n, L = 8, 64, 100
    res = _rand_res(rng, 2 * n, K, tidx.l_pac)
    codes = [rng.integers(0, 4, L).astype(np.uint8) for _ in range(2 * n)]
    rcodes = [(3 - c[::-1]).astype(np.uint8) for c in codes]
    n_amb = np.zeros(2 * n, np.int64)
    n_amb[rng.random(2 * n) < 0.05] = 99
    names = [f"r{i}" for i in range(2 * n)]
    quals = ["I" * L] * (2 * n)

    def per_pair(aligner, end):
        return [aligner._make_state(
            names[i], names[n + i], quals[i], quals[n + i],
            codes[i], rcodes[i], codes[n + i], rcodes[n + i],
            n_amb[i], n_amb[n + i], end(i), end(n + i)) for i in range(n)]

    # the port's ends are rows of a result table, salt_tpu's row dicts
    table = dict(res, is_gap=np.zeros(2 * n, bool))
    want = per_pair(al, lambda i: (table, i))
    jwant = per_pair(jal, lambda i: ({k: v[i] for k, v in res.items()}, False))
    states = [None] * n
    al._fill_states_fast(states, list(range(n)), 0, n, names, quals, codes,
                         rcodes, n_amb, n, res)
    modes = set()
    for i in range(n):
        for other in (want[i], jwant[i]):
            e0w, e1w, mode_w, reqs_w = other
            e0g, e1g, mode_g, reqs_g = states[i]
            assert mode_g == mode_w, (i, mode_g, mode_w)
            assert _end_state(e0g) == _end_state(e0w), (i, "end0")
            assert _end_state(e1g) == _end_state(e1w), (i, "end1")
            if reqs_w is None:
                assert reqs_g is None, i
            else:
                assert [(r[2], r[3], r[4]) for r in reqs_g] == \
                    [(r[2], r[3], r[4]) for r in reqs_w], i
        modes.add(states[i][2])
    assert modes == {"done", "pair2", "single", "none"}
