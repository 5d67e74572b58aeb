"""The native batched LV CIGAR and MD/NM/XV tag (ops/lv.lv_cigar_batch,
csrc/lv_host.cpp) against their plain versions, ops/lv.lv_cigar_host and
io/sam.md_nm_tag, row for row; then SE finalize through the batched path
against the plain versions row by row and salt_tpu.  Tolerance: exact (integers and
strings)."""

from types import SimpleNamespace

import numpy as np
import pytest

import salt_tpu.io.sam as jsam
from salt_tpu.pipeline.engine import SEAligner as JaxAligner
from salt_tpu.pipeline.engine import SEOptions as JaxOptions
from salt_tpu_torch.constants import LV_MAX_K
from salt_tpu_torch.io.sam import md_nm_tag
from salt_tpu_torch.ops.lv import NT2BIT_NP, lv_cigar_batch, lv_cigar_host
from salt_tpu_torch.pipeline import engine
from salt_tpu_torch.pipeline.engine import SEAligner, SEOptions
from salt_tpu_torch.utils.metrics import counters, metrics, metrics_reset

from torch_fixtures import repeat_fixture

L = 100


def _genome(rng, n, snp_every=20, repeat=None):
    """pac codes and mixref one-hot nibbles with SNP alleles; `repeat`
    tiles a short motif (homopolymers and dinucleotide repeats make the
    X, D and I moves tie on a diagonal)."""
    if repeat is None:
        pac = rng.integers(0, 4, n).astype(np.uint8)
    else:
        pac = np.resize(np.array(repeat, np.uint8), n)
    mix = (1 << pac).astype(np.uint8)
    snp = rng.random(n) < 1.0 / snp_every
    mix[snp] |= (1 << rng.integers(0, 4, int(snp.sum()))).astype(np.uint8)
    return pac, mix


def _read(rng, pac, mix, p, n_edits, n_rate=0.0):
    """The genome from p with n_edits substitutions (half of them to a
    SNP's other allele where there is one), insertions and deletions, cut
    to L; N bases at n_rate."""
    r = list(pac[p : p + L + 40])
    r += [0] * (L + 40 - len(r))
    for _ in range(n_edits):
        j = int(rng.integers(1, L - 1))
        kind = rng.integers(0, 4)
        if kind == 0:
            r.insert(j, int(rng.integers(0, 4)))
        elif kind == 1:
            del r[j]
        else:
            m = mix[min(p + j, len(mix) - 1)]
            alt = [c for c in range(4) if (m >> c) & 1 and c != r[j]]
            r[j] = alt[0] if alt and kind == 2 else (r[j] + 1) % 4
    r = np.array(r[:L], np.uint8)
    r[rng.random(L) < n_rate] = 4
    return r


def _rows(case, seed):
    """(pac, mix, pos, reads, k) for one case of the parity test."""
    rng = np.random.default_rng(seed)
    n, G = 60, 4000
    repeat = {"ties": [0, 0, 0, 1], "ties_dinuc": [0, 1]}.get(case)
    pac, mix = _genome(rng, G, repeat=repeat)
    pos = rng.integers(0, G - L - 50, n)
    edits = rng.integers(0, 11, n)
    k = edits.copy()
    if case == "wide_k":
        edits = rng.integers(8, LV_MAX_K, n)
        k = np.full(n, LV_MAX_K - 1)
    elif case == "past_k":
        k[::2] = np.maximum(edits[::2] - 3, 0)
    elif case == "short_window":
        # windows cut short by the end of the index, to 60..L+3 bases
        # (the plain traceback itself indexes past a shorter one)
        pos = G - rng.integers(60, L + 4, n)
        pos[::4] = rng.integers(G - L - 20, G - L - 4, len(pos[::4]))
    elif case == "random_k":
        k = rng.integers(0, 13, n)
    n_rate = 0.03 if case == "n_bases" else 0.0
    reads = np.stack([_read(rng, pac, mix, int(p), int(e), n_rate)
                      for p, e in zip(pos, edits)])
    if case == "xv_cap":
        # every base an allele of a SNP: random reads align ungapped with
        # about 75 mismatches, each an allele match, past XV's 64
        mix[:] = 15
        reads = rng.integers(0, 4, (n, L)).astype(np.uint8)
    return pac, mix, pos, reads, k


def _plain(index, p, read, k):
    """(e, cigar, tag or the error the plain tag raises)."""
    e, cig = lv_cigar_host(index.mixref[p : p + L + 4],
                           NT2BIT_NP[np.minimum(read, 4)], k)
    try:
        tag = md_nm_tag(index, p, 0, read, read, cig, 0)
    except (IndexError, ValueError) as err:
        tag = err
    return e, cig, tag


@pytest.mark.parametrize("case", ["edits", "wide_k", "past_k", "short_window",
                                  "n_bases", "ties", "ties_dinuc",
                                  "random_k", "xv_cap"])
@pytest.mark.parametrize("seed", [1, 2])
def test_native_matches_plain_row_for_row(case, seed):
    pac, mix, pos, reads, k = _rows(case, seed)
    index = SimpleNamespace(pac=pac, mixref=mix)
    got = lv_cigar_batch(mix, pac, pos, reads, k, np.ones(len(pos), bool))
    handed_back = 0
    for i, (e, cig, tag) in enumerate(got):
        want_e, want_cig, want_tag = _plain(index, int(pos[i]), reads[i],
                                            int(k[i]))
        assert (e, cig) == (want_e, want_cig), i
        if isinstance(want_tag, Exception):
            assert tag is None, i      # handed back: the plain tag raises
        elif tag is None:
            handed_back += 1
        else:
            assert tag == want_tag, i
    # where the plain tag reads past the end of a short window only
    # through numpy's broadcasting, the caller's md_nm_tag makes it
    assert handed_back == 0 or case == "short_window"
    es = [g[0] for g in got]
    if case == "past_k":
        assert -1 in es and any(e > 0 for e in es)
    if case in ("edits", "ties", "ties_dinuc", "n_bases"):
        assert any("I" in g[1] or "D" in g[1] for g in got)
    if case in ("edits", "n_bases"):
        assert any("^" in g[2] for g in got)
    if case == "edits":
        assert any("XV:i:" in g[2] for g in got)
    if case == "xv_cap":
        assert max(g[2].count(",") for g in got) == 63


def test_tags_only_where_asked_and_empty_batch():
    pac, mix, pos, reads, k = _rows("edits", 3)
    want = np.arange(len(pos)) % 2 == 0
    got = lv_cigar_batch(mix, pac, pos, reads, k, want)
    assert [g[2] is not None for g in got] == want.tolist()
    assert lv_cigar_batch(mix, pac, pos[:0], reads[:0], k[:0],
                          want[:0]) == []


def test_rows_past_the_routine_go_to_the_plain_version():
    """A diagonal past -64 (k over 64): the plain version slices the
    bytes before the text from numpy's wrapping index there, so the
    routine hands the row back and lv_cigar_batch runs lv_cigar_host on
    it.  Row 0: 66 inserted C before 34 G that open the text (G * 34, A
    * 70); row 1, an ordinary read."""
    rng = np.random.default_rng(4)
    pac, mix = _genome(rng, 3000)
    pac[:104] = [2] * 34 + [0] * 70
    mix[:104] = 1 << pac[:104]
    pos = np.array([0, 900])
    reads = np.stack([np.array([1] * 66 + [2] * 34, np.uint8),
                      _read(rng, pac, mix, 900, 3)])
    k = np.array([80, 80])
    got = lv_cigar_batch(mix, pac, pos, reads, k, np.ones(2, bool))
    for i in range(2):
        e, cig = lv_cigar_host(mix[pos[i] : pos[i] + L + 4],
                               NT2BIT_NP[reads[i]], 80)
        assert got[i][:2] == (e, cig)
    assert got[0][2] is None and got[1][2] is not None


# ---------------- SE finalize through the batched path ----------------

OPTS = dict(l_overlap=1, max_locate=64, batch_size=64, gap_batch=16)


@pytest.fixture(scope="module")
def repeat(tmp_path_factory):
    idx, records = repeat_fixture(str(tmp_path_factory.mktemp("repeat")))
    yield idx, records
    # salt_tpu caches contig offsets by id(index) alone: leave no entry
    # that a later index of this worker could take over with the id
    jsam._OFFSETS_CACHE.pop(id(idx), None)


@pytest.mark.parametrize("flags", ["d", "cd"])
def test_se_batched_cigars_match_per_read_and_salt_tpu(repeat, flags,
                                                       monkeypatch):
    idx, records = repeat
    opts = dict(OPTS, print_nm_md=True, print_xa_cigar=flags == "cd")
    want = JaxAligner(idx, JaxOptions(**opts)).align_records(records)

    sent = []

    def recorded(mixref, pac, pos, reads, k, want_tag):
        sent.append(len(pos))
        return lv_cigar_batch(mixref, pac, pos, reads, k, want_tag)

    monkeypatch.setattr(engine, "lv_cigar_batch", recorded)
    metrics_reset()
    batched = SEAligner(idx, SEOptions(**opts),
                        device="cpu").align_records(records)
    rows = counters().get("lv.cigar_rows", 0)
    spans = metrics()
    # the same rows through the plain versions one row at a time: each
    # row's lv_cigar_host, its tag left to emit_se's md_nm_tag
    monkeypatch.setattr(engine, "lv_cigar_batch", lambda mixref, pac, pos,
                        reads, k, want_tag: [
        (*lv_cigar_host(mixref[p : p + len(r) + 4],
                        NT2BIT_NP[np.minimum(r, 4)], int(kk)), None)
        for p, r, kk in zip(pos, reads, k)])
    per_read = SEAligner(idx, SEOptions(**opts),
                         device="cpu").align_records(records)

    assert batched == per_read
    assert batched == want
    assert rows == sum(sent) > 0
    assert spans["host.cigar"][1] == len(sent)
    indel = sum(1 for line in batched
                if "I" in line.split("\t")[5] or "D" in line.split("\t")[5])
    assert rows >= indel > 0
