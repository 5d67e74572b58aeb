"""One result table a batch.  SEAligner._complete_batch returns one table
whose rows are the ungapped result, overwritten by the full-width re-run
where a row overflowed and by the gapped check where it had no ungapped
hit.  On the repeat genome, where narrow widths force both, that table
equals salt_tpu's (res, full_res, gap_res) overlaid in the same
precedence, row for row, for Landau-Vishkin, -X 1 (the SW records) and
the PE ends; the SAM equals salt_tpu's; the ungapped step runs once a
batch at full_cap(), and only pairs with a gapped end take the per-pair
state path.  Tolerance: exact."""

import numpy as np
import pytest

from salt_tpu.pipeline.engine import SEAligner as JaxAligner
from salt_tpu.pipeline.engine import SEOptions as JaxOptions
from salt_tpu.pipeline.pe_engine import PEAligner as JaxPE
from salt_tpu.pipeline.pe_engine import PEOptions as JaxPEOptions
from salt_tpu_torch.io.fasta import trim_readno
from salt_tpu_torch.pipeline.engine import SEAligner, SEOptions, encode_reads
from salt_tpu_torch.pipeline.pe_engine import PEAligner, PEOptions
from salt_tpu_torch.utils.metrics import counters, metrics, metrics_reset

from torch_fixtures import repeat_fixture

OPTS = dict(l_overlap=1, max_locate=200, verify_width=16, print_nm_md=True,
            print_xa_cigar=True, batch_size=64, gap_batch=16)
PE_OPTS = dict(min_tlen=200, max_tlen=400, **OPTS)
FIELDS = ("found", "pos", "strand", "n_diff", "n_hits", "first_hit_ndiff",
          "hits_pos", "hits_ndiff")
MODES = {"lv": {}, "x1": dict(extend_algo="sw")}


@pytest.mark.parametrize("max_locate,margin", [
    (1000, 128), (200, 128), (16, 128), (16, 0), (1, 0), (64, 0), (65, 0)])
def test_full_cap_matches_salt_tpu(max_locate, margin):
    kw = dict(max_locate=max_locate, cap_margin=margin)
    cap = SEOptions(**kw).full_cap()
    assert cap == JaxOptions(**kw).full_cap()
    assert cap % 64 == 0 and 0 <= cap - (max_locate + margin) < 64


def _old_rows(res, needs_gap, gap_res, full_res, nb):
    """salt_tpu's batch result overlaid as its finalize reads it: a
    checked-with-gaps row's gapped (or SW) result, else a re-run row's
    full-width result, else the ungapped row.  [(kind, row)]."""
    rows = []
    for i in range(nb):
        if needs_gap[i] and i in gap_res:
            r = gap_res[i]
            rows.append(("sw" if r.get("sw") else "gap", r))
        elif i in full_res:
            rows.append(("plain", full_res[i]))
        else:
            rows.append(("plain", {k: v[i] for k, v in res.items()}))
    return rows


def _table_rows(t, nb):
    return [("sw", t["sw"][i]) if i in t["sw"] else
            ("gap" if t["is_gap"][i] else "plain", {f: t[f][i] for f in FIELDS})
            for i in range(nb)]


def _same_row(want, got):
    (kind_w, w), (kind_g, g) = want, got
    if kind_w != kind_g:
        return False
    if kind_w == "sw":
        return set(w) == set(g) and all(
            w[k] == g[k] if isinstance(w[k], str) else int(w[k]) == int(g[k])
            for k in w)
    return all(np.array_equal(np.asarray(w[f], np.int64),
                              np.asarray(g[f], np.int64)) for f in FIELDS)


def _tables(se, jse, codes, B):
    """Both packages' rows of every batch of `codes` (salt_tpu's padded
    to B rows, as its aligner pads them)."""
    want, got = [], []
    for s0 in range(0, len(codes), B):
        chunk = codes[s0 : s0 + B]
        nb = len(chunk)
        got += _table_rows(se._complete_batch(se._dispatch_batch(chunk)), nb)
        padded = np.zeros((B, codes.shape[1]), np.uint8)
        padded[:nb] = chunk
        want += _old_rows(*jse._run_batch(padded), nb)
    return want, got


@pytest.fixture(scope="module")
def repeat(tmp_path_factory):
    return repeat_fixture(str(tmp_path_factory.mktemp("batch_result")))


@pytest.fixture(scope="module")
def se_runs(repeat):
    """{mode: (salt_tpu's SAM, the port's SAM, the port's _ungapped calls
    (rows, cap, u), the port's counters and spans, salt_tpu's rows, the
    port's table rows, the port's options)}."""
    idx, records = repeat
    codes = encode_reads([r.seq for r in records])
    out = {}
    for mode, extra in MODES.items():
        opts = {**OPTS, **extra}
        jal = JaxAligner(idx, JaxOptions(**opts))
        al = SEAligner(idx, SEOptions(**opts), device="cpu")
        calls, step = [], al._ungapped

        def noting(fwd, rev, cap, u, step=step, calls=calls):
            calls.append((fwd.shape[0], cap, u))
            return step(fwd, rev, cap, u)

        al._ungapped = noting
        metrics_reset()
        sam = al.align_records(records)
        seen = (counters(), metrics())
        del al._ungapped
        want, got = _tables(al, jal, codes, al.opts.batch_size)
        out[mode] = (jal.align_records(records), sam, calls, seen, want, got,
                     al.opts)
    return out


@pytest.mark.parametrize("mode", MODES)
def test_sam_equals_salt_tpu(se_runs, mode):
    want, got = se_runs[mode][:2]
    assert len(want) == len(got)
    bad = [(a, b) for a, b in zip(want, got) if a != b]
    assert not bad, f"{len(bad)}/{len(want)} records differ; first: {bad[0]}"


@pytest.mark.parametrize("mode", MODES)
def test_one_ungapped_pass_a_batch(se_runs, mode):
    """Every batch runs the ungapped step once, at (full_cap(),
    verify_width); its overflow rows are verified again at full width
    without being seeded or located again."""
    _w, sam, calls, (counts, spans), _jw, _g, o = se_runs[mode]
    B = o.batch_size
    assert calls == [(min(B, len(sam) - s0), o.full_cap(), o.verify_width)
                     for s0 in range(0, len(sam), B)]
    assert counts["rows.overflow"] > 0 and spans["device.ungapped_full"][1] > 0
    assert (spans["host.sw_extend" if mode == "x1" else "device.gapped_full"]
            [1] > 0)


@pytest.mark.parametrize("mode", MODES)
def test_table_equals_salt_tpu_overlay(se_runs, mode):
    want, got = se_runs[mode][4:6]
    assert len(want) == len(got)
    bad = [i for i, (w, g) in enumerate(zip(want, got)) if not _same_row(w, g)]
    assert not bad, f"{len(bad)}/{len(want)} rows differ; first: {bad[0]}"
    kinds = {k for k, _r in got}
    assert kinds == ({"plain", "sw"} if mode == "x1" else {"plain", "gap"})


@pytest.fixture(scope="module")
def pe_runs(tmp_path_factory):
    idx, r1, r2 = repeat_fixture(str(tmp_path_factory.mktemp("batch_pe")),
                                 pairs=True)
    pal = PEAligner(idx, PEOptions(**PE_OPTS), device="cpu")
    jpal = JaxPE(idx, JaxPEOptions(**PE_OPTS))
    made, make = [], pal._make_state

    def noting(*args):
        made.append(args[0])
        return make(*args)

    pal._make_state = noting
    metrics_reset()
    sam = pal.align_pairs(r1, r2)
    n_overflow = counters()["rows.overflow"]
    # the ends as the uniform path batches them: a chunk's first ends,
    # then its second ends
    P, n = pal.opts.batch_size // 2, len(r1)
    codes = encode_reads([r.seq for r in r1 + r2])
    want, got = [], []
    gapped_pairs = []
    for p0 in range(0, n, P):
        cnt = min(P, n - p0)
        ends = np.concatenate([codes[p0 : p0 + cnt],
                               codes[n + p0 : n + p0 + cnt]])
        w, g = _tables(pal._se, jpal._se, ends, 2 * cnt)
        want += w
        got += g
        gapped_pairs += [trim_readno(r1[p0 + i].name) for i in range(cnt)
                         if g[i][0] == "gap" or g[cnt + i][0] == "gap"]
    return (jpal.align_pairs(r1, r2), sam, want, got, made, gapped_pairs,
            n_overflow)


def test_pe_table_equals_salt_tpu_overlay(pe_runs):
    want, got = pe_runs[2:4]
    bad = [i for i, (w, g) in enumerate(zip(want, got)) if not _same_row(w, g)]
    assert not bad, f"{len(bad)}/{len(want)} rows differ; first: {bad[0]}"
    assert {k for k, _r in got} == {"plain", "gap"}


def test_pe_sam_and_only_gapped_pairs_take_make_state(pe_runs):
    """Pairs with a re-run end go through _fill_states_fast like any
    other pair without a gapped end; the SAM stays salt_tpu's."""
    want, sam, _w, _g, made, gapped_pairs, n_overflow = pe_runs
    assert sam == want
    assert n_overflow > 0
    assert made == gapped_pairs and made
