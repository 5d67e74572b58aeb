"""The polish tool of salt_tpu_torch against salt_tpu's on the same SAM,
byte for byte (SE and paired, Landau-Vishkin and SSW scoring, through
polish_main and through the CLI), and the form of the LV distance that
polish calls (a byte reference, precoded patterns, k = 13, windows of
exactly the read length) against salt_tpu's and against the host LV.
The SAM is the port's own output on the repeat-genome fixture, with XA
multi-hits, plus hand-made records: a hit whose window the reference end
cuts, reads at distance 13 and 14, an N on the reverse strand (code
3 - 4: salt_tpu's native SSW reads outside its score matrix there, so
for reads with such a code the reference is salt_tpu's numpy SSW, whose
index -1 is the N column).  Tolerance: exact."""

import io
from contextlib import redirect_stdout

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from salt_tpu.ops import ssw as jssw
from salt_tpu.ops.lv import lv_distance_batch as jax_lv
from salt_tpu.polish import polish as jpolish
from salt_tpu_torch import cli
from salt_tpu_torch.index.store import save_index
from salt_tpu_torch.ops.lv import (
    lv_distance_batch,
    lv_distance_host,
    lv_distance_plain,
)
from salt_tpu_torch.pipeline.engine import SEAligner, SEOptions
from salt_tpu_torch.pipeline.pe_engine import PEAligner, PEOptions
from salt_tpu_torch.polish import polish
from salt_tpu_torch.utils.metrics import metrics, metrics_reset

from torch_fixtures import BASES, port_index, repeat_fixture, revcomp_str

ALN_OPTS = dict(l_overlap=1, max_locate=200, max_hits=8, print_nm_md=True,
                print_xa_cigar=True, batch_size=64, gap_batch=16)


def _subst(seq, n, rng):
    s = list(seq)
    for j in np.linspace(3, len(s) - 4, n).astype(int):
        s[j] = BASES[(BASES.index(s[j]) + 1 + int(rng.integers(0, 3))) % 4]
    return "".join(s)


def _sam_line(name, flag, chrom, pos, seq, xa=""):
    tail = f"\tXA:Z:{xa}" if xa else ""
    return (f"{name}\t{flag}\t{chrom}\t{pos}\t37\t{len(seq)}M\t*\t0\t0\t{seq}\t"
            f"{'I' * len(seq)}{tail}")


def _hand_made(idx, rng):
    """Four pairs of records that the aligner would not give: a hit whose
    window is cut by the reference end (host path), reads at distance 13
    (cigar '*') and 14 (unmapped), an N read from the
    reverse strand, with an XA list on both strands, an unmapped record,
    another length."""
    chrom = idx.contigs[0].name
    genome = "".join(BASES[c] for c in idx.pac)
    n = len(genome)
    w = lambda p, l=100: genome[p : p + l]
    rc = revcomp_str(w(700))
    lines = [
        _sam_line("cut/1", 0, chrom, n - 50 + 1, w(n - 50, 50) + w(0, 50),
                  xa=f"{chrom},+{n - 99},100M,0;{chrom},+301,100M,3;"),
        _sam_line("cut/2", 16, chrom, 701,
                  rc[:40] + "N" + rc[41:],
                  xa=f"{chrom},-705,100M,1;{chrom},+701,100M,9;"),
        _sam_line("d13/1", 0, chrom, 1201, _subst(w(1200), 13, rng)),
        _sam_line("d13/2", 0, chrom, 1601, _subst(w(1600), 14, rng),
                  xa=f"{chrom},+1602,100M,2;"),
        _sam_line("un/1", 4, "*", 0, w(2000)),
        _sam_line("un/2", 0, chrom, 2401, w(2400, 70),
                  xa=f"{chrom},+2401,70M,0;{chrom},-2403,70M,4;"),
        _sam_line("ins/1", 0, chrom, 3001, w(3000, 40) + "AC" + w(3040, 58),
                  xa=f"{chrom},-3301,100M,5;"),
        _sam_line("ins/2", 16, chrom, 3401, revcomp_str(w(3400, 55) + w(3457, 45))),
    ]
    return [line + "\n" for line in lines]


@pytest.fixture(scope="module")
def sams(tmp_path_factory):
    """(salt_tpu index, the port's, {(paired, use_sw): SAM path})."""
    d = tmp_path_factory.mktemp("polish")
    idx, r1, r2 = repeat_fixture(str(d), n_reads=64, pairs=True)
    pidx = port_index(idx)
    se = SEAligner(pidx, SEOptions(**ALN_OPTS), device="cpu").align_records(r1)
    pe = PEAligner(pidx, PEOptions(**ALN_OPTS), device="cpu").align_pairs(r1, r2)
    assert sum("XA:Z:" in line for line in se) >= 5
    paths = {}
    for paired, body in ((False, se), (True, pe)):
        for use_sw in (False, True):
            extra = _hand_made(idx, np.random.default_rng(21))
            path = d / f"{'pe' if paired else 'se'}{'_sw' if use_sw else ''}.sam"
            path.write_text("@HD\tVN:1.0\n" + "".join(l + "\n" for l in body)
                            + "".join(extra))
            paths[paired, use_sw] = str(path)
    return idx, pidx, paths


def _polished(fn, idx, path, paired, use_sw, **kw):
    out = io.StringIO()
    fn(idx, path, paired=paired, use_sw=use_sw, out=out, **kw)
    return out.getvalue()


def _reference(idx, path, paired, use_sw):
    """salt_tpu's polish of the same SAM.  For a read with a code outside
    the score matrix (an N on the reverse strand) its SSW is the numpy
    version: the native one reads out of bounds there."""
    n_numpy = []

    def ssw(read, ref, mat, *args, **kw):
        if (np.asarray(read).astype(np.uint8) >= mat.shape[0]).any():
            n_numpy.append(1)
            return jssw.ssw_align_py(read, ref, mat, *args, **kw)
        return jssw.ssw_align(read, ref, mat, *args, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpolish, "ssw_align", ssw)
        out = _polished(jpolish.polish_main, idx, path, paired, use_sw)
    assert bool(n_numpy) == use_sw      # the N record reached the SSW
    return out


@pytest.mark.parametrize("use_sw", [False, True], ids=["lv", "ssw"])
@pytest.mark.parametrize("paired", [False, True], ids=["se", "pe"])
def test_polish_main_matches(sams, paired, use_sw):
    idx, pidx, paths = sams
    path = paths[paired, use_sw]
    want = _reference(idx, path, paired, use_sw)
    metrics_reset()
    got = _polished(polish.polish_main, pidx, path, paired, use_sw,
                    device="cpu")
    assert got == want
    lines = got.splitlines()
    assert len(lines) == 64 * (2 if paired else 1) + 8
    assert {"host.polish_parse", "device.polish_score",
            "host.polish_emit"} <= set(metrics())
    if not use_sw:
        cigars = [l.split("\t")[5] for l in lines]
        assert "*" in cigars[-8:]                     # the read at distance 13
        assert any("I" in c or "D" in c for c in cigars)
    assert any(l.split("\t")[4] == "60" for l in lines)
    assert any(l.endswith("\t") for l in lines)       # the trailing-tab quirk
    assert any(not l.endswith("\t") for l in lines)


def test_polish_quirks_on_the_hand_made_records(sams):
    _idx, pidx, paths = sams
    se_path, pe_path = paths[False, False], paths[True, False]
    se = _polished(polish.polish_main, pidx, se_path, False, False,
                   device="cpu").splitlines()[-8:]
    f = [l.split("\t") for l in se]
    assert f[2][5] == "*" and f[2][2] != "*"          # distance 13: mapped, '*'
    assert f[3][1] == str(0x40 | 0x4)                 # 14 away: unmapped
    assert f[4][1] == str(0x40 | 0x4) and f[4][2] == "*"
    assert f[0][2] != "*"                             # the cut window scored
    pe = _polished(polish.polish_main, pidx, pe_path, True, False,
                   device="cpu").splitlines()[-8:]
    g = [l.split("\t") for l in pe]
    assert g[5][0] == g[4][0] == "un/1"               # the mate takes the name
    assert int(g[5][1]) & 0x4 and not int(g[5][1]) & 0x8   # the flag bug


def test_polisher_batches_hits_by_read_length(sams):
    _idx, pidx, paths = sams
    se_path = paths[False, False]
    p = polish.Polisher(pidx, device="cpu")
    sent = []
    real = p._lv_distances

    def spy(pos, pats):
        sent.append((pos.shape, pats.shape, pats.dtype, pos.dtype))
        return real(pos, pats)

    p._lv_distances = spy
    lines = [l for l in open(se_path) if not l.startswith("@")]
    p.polish_se(lines, io.StringIO())
    assert sorted(s[1][1] for s in sent) == [70, 100]  # one call a length
    assert all(s[2] == np.uint8 and s[3] == np.int64 for s in sent)
    assert p._eq_pac.dtype == torch.uint8 and p._eq_pac.shape == (pidx.l_pac,)
    assert set(np.unique(p._eq_pac.numpy())) <= {1, 2, 4, 8, 16}


def test_polisher_refuses_cuda_without_a_gpu(sams):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        polish.Polisher(sams[1])


@pytest.mark.parametrize("flags", [[], ["-s"], ["-p"], ["-s", "-p"]],
                         ids=["lv-se", "ssw-se", "lv-pe", "ssw-pe"])
def test_cli_polish(sams, tmp_path, flags):
    idx, pidx, paths = sams
    save_index(pidx, str(tmp_path / "idx"))
    path = paths["-p" in flags, "-s" in flags]
    out = io.StringIO()
    with redirect_stdout(out):
        rc = cli.main(["polish", "--device", "cpu"] + flags
                      + [str(tmp_path / "idx"), path])
    assert rc == 0
    assert out.getvalue() == _reference(idx, path, "-p" in flags,
                                        "-s" in flags)


@pytest.mark.parametrize("extra", [[], ["-X", "1"], ["-p"]],
                         ids=["se-lv", "se-sw", "pe"])
def test_cli_aln_sampled(sams, tmp_path, extra):
    """`aln --sa-mode sampled` through main(argv): the SAM of full mode."""
    _idx, pidx, _paths = sams
    save_index(pidx, str(tmp_path / "idx"))
    rng = np.random.default_rng(6)
    genome = "".join(BASES[c] for c in pidx.pac)
    fqs = []
    for e in (1, 2):
        fq = tmp_path / f"r{e}.fq"
        recs = []
        for i in range(24):
            start = int(rng.integers(0, len(genome) - 500))
            s = genome[start : start + 100] if e == 1 else \
                revcomp_str(genome[start + 300 : start + 400])
            recs.append(f"@q{i}/{e}\n{s}\n+\n{'I' * 100}\n")
        fq.write_text("".join(recs))
        fqs.append(str(fq))
        rng = np.random.default_rng(6)                # the same starts
    reads = fqs if "-p" in extra else fqs[:1]
    outs = {}
    for mode in ("full", "sampled"):
        out = io.StringIO()
        with redirect_stdout(out):
            rc = cli.main(["aln", "--device", "cpu", "-d", "-c", "-r", "1",
                           "-m", "100", "--batch-size", "32", "--sa-mode", mode]
                          + extra + [str(tmp_path / "idx")] + reads)
        assert rc == 0
        outs[mode] = [l for l in out.getvalue().splitlines()
                      if not l.startswith("@PG")]
    assert outs["full"] == outs["sampled"]
    # paired records carry the reference's blank line after each
    body = [l for l in outs["sampled"] if l and not l.startswith("@")]
    assert len(body) == 24 * len(reads)
    assert sum(l.split("\t")[2] != "*" for l in body) > len(body) // 2


# ------------------------------------------------------------- the LV form


def _polish_case(rng, N, L, n=4000):
    """A byte reference and precoded reads in polish's seven codes: half
    the reads planted with up to 15 edits, windows at position 0 and
    ending at the last byte."""
    enc = polish._EQ_ENCODE
    pac = rng.integers(0, 4, n).astype(np.uint8)
    pac[rng.random(n) < 0.01] = 4
    ref = enc[pac]
    pos = rng.integers(0, n - L - 16, N).astype(np.int64)
    pos[:2] = [0, n - L]
    raw = rng.integers(0, 4, (N, L)).astype(np.uint8)
    for i in range(0, N, 2):
        r = list(pac[pos[i] : pos[i] + L + 16])
        for _ in range(int(rng.integers(0, 16))):
            j = int(rng.integers(0, L - 1))
            op = rng.integers(0, 3)
            if op == 0:
                r[j] = (r[j] + 1) % 4
            elif op == 1:
                del r[j]
            else:
                r.insert(j, int(rng.integers(0, 4)))
        raw[i] = r[:L]
    raw[1, 5] = 255                     # 3 - N of a reverse-strand read
    raw[3, 9] = 77                      # a stray byte: code 64
    active = rng.random(N) < 0.9
    active[:2] = True
    return ref, pos, active, enc[raw]


@pytest.mark.parametrize("L", [70, 100, 151])
def test_lv_precoded_bytes_matches(L):
    rng = np.random.default_rng(L)
    ref, pos, active, pat = _polish_case(rng, 96, L)
    want = np.asarray(jax_lv(
        jnp.asarray(ref), jnp.asarray(pos.astype(np.int32)), jnp.asarray(active),
        jnp.asarray(pat.astype(np.int32)), k=13, window_pad=0,
        pat_precoded=True))
    args = (torch.from_numpy(ref), torch.from_numpy(pos),
            torch.from_numpy(active), torch.from_numpy(pat))
    got = lv_distance_plain(*args, 13, 0, pat_precoded=True).numpy()
    assert np.array_equal(got, want)
    # CPU tensors take the plain version through the dispatcher too
    assert torch.equal(lv_distance_batch(*args, 13, window_pad=0,
                                         pat_precoded=True),
                       torch.from_numpy(got))
    for i in np.nonzero(active)[0]:
        d = lv_distance_host(ref[pos[i] : pos[i] + L], pat[i], 13)
        assert got[i] == (255 if d == -1 else d), i
    assert (got[~active] == 255).all()
    assert 13 in got or 12 in got or 11 in got
    assert ((got > 0) & (got < 255)).sum() > 10 and (got == 255).sum() > 10
