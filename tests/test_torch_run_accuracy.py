"""salt_tpu_torch/tools/run_accuracy.py (the run_test.sh protocol) at a
tiny genome on the CPU against salt_tpu's tools/run_accuracy.py, loaded
by path and run with sys.argv patched, each with a workdir of its own:
the same SNP count, the same alneval report of SE and of PE, the same
verdict, for the error-free protocol on a uniform genome and for a
repeat-rich genome with sequencing errors and indels.  Sampled mode (SE)
is held against the port's own full mode on the same workdir; the
hapmap conversion, the gate and the vendored simulator's failure against
salt_tpu's.  Tolerance: exact (report lines)."""

import contextlib
import importlib.util
import io
import os
import re
import subprocess
import sys

import pytest
import torch

from salt_tpu_torch.tools import run_accuracy

import torch_fixtures  # noqa: F401  (one torch thread a worker)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = {
    "uniform": ["300", "--genome-synth", "100000", "--genome-config",
                "uniform"],
    "repeat": ["300", "--genome-synth", "120000", "--genome-config", "repeat",
               "--err-rate", "0.01", "--indel-frac", "0.1"],
}
SNP_LINE = re.compile(r"^\[harness\] \d+ pairs simulated, \d+ SNPs$", re.M)
RUN_LINE = re.compile(r"^\[(SE|PE)\] \d+ (reads|pairs) in ")


def salt_tpu_tool():
    spec = importlib.util.spec_from_file_location(
        "salt_tpu_run_accuracy", os.path.join(ROOT, "tools", "run_accuracy.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_salt_tpu(argv, tool=None):
    """(exit code, stdout) of salt_tpu's main() with sys.argv = argv."""
    tool = tool or salt_tpu_tool()
    out = io.StringIO()
    saved = sys.argv
    sys.argv = ["run_accuracy.py"] + argv
    try:
        with contextlib.redirect_stdout(out):
            rc = tool.main()
    finally:
        sys.argv = saved
    return rc, out.getvalue()


def run_port(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run_accuracy.main(argv + ["--device", "cpu"])
    return rc, out.getvalue()


def reports(text):
    """{"SE": lines, "PE": lines} of the alneval reports in `text`."""
    got, cur = {}, None
    for line in text.splitlines():
        m = RUN_LINE.match(line)
        if m:
            cur = got.setdefault(m.group(1), [])
        elif cur is not None:
            cur.append(line)
            if line.startswith("# mapped="):
                cur = None
    return got


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """runs(who, case) -> (exit code, stdout, workdir), each run once."""
    done = {}

    def get(who, case):
        if (who, case) not in done:
            wd = str(tmp_path_factory.mktemp(f"{who}_{case}"))
            argv = CASES[case] + ["--workdir", wd]
            run = run_salt_tpu if who == "salt_tpu" else run_port
            done[who, case] = run(argv) + (wd,)
        return done[who, case]

    return get


@pytest.mark.parametrize("case", sorted(CASES))
def test_snp_count_equals_salt_tpu(runs, case):
    want = SNP_LINE.findall(runs("salt_tpu", case)[1])
    got = SNP_LINE.findall(runs("port", case)[1])
    assert len(want) == 1 and got == want


@pytest.mark.parametrize("case,end", [(c, e) for c in sorted(CASES)
                                      for e in ("SE", "PE")])
def test_alneval_report_equals_salt_tpu(runs, case, end):
    want = reports(runs("salt_tpu", case)[1])[end]
    got = reports(runs("port", case)[1])[end]
    assert want[0].startswith("qual n_wrong") and want[-1].startswith("# mapped=")
    assert got == want


@pytest.mark.parametrize("case", sorted(CASES))
def test_verdict_equals_salt_tpu(runs, case):
    rc, text, _wd = runs("salt_tpu", case)
    rc_port, text_port, _wd = runs("port", case)
    assert rc_port == rc == 0
    assert text_port.splitlines()[-1] == text.splitlines()[-1] == "[harness] PASS"


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_launch_lines(runs, case):
    """A line of launch counts after each run; the CPU launches none."""
    lines = re.findall(r"^\[(SE|PE)\] kernel launches: lv_distance (\d+), "
                       r"sw_score (\d+)$", runs("port", case)[1], re.M)
    assert lines == [("SE", "0", "0"), ("PE", "0", "0")]


@pytest.mark.parametrize("case", sorted(CASES))
def test_sampled_se_equals_full_mode(runs, case):
    _rc, full, wd = runs("port", case)
    rc, sampled = run_port(CASES[case] + ["--workdir", wd, "--se-only",
                                          "--sa-mode", "sampled"])
    assert rc == 0
    assert "PE" not in reports(sampled)
    assert reports(sampled)["SE"] == reports(full)["SE"]


def test_steps_return_sam_and_eval(runs):
    """align_se / align_pe return the SAM and the alneval of the run that
    main reports."""
    _rc, text, wd = runs("port", "uniform")
    args = run_accuracy.parse_args(CASES["uniform"] + ["--workdir", wd])
    prod = run_accuracy.simulate(args)
    idx = run_accuracy.build(args, prod)
    recs1 = list(run_accuracy.read_records(prod.r1))
    recs2 = list(run_accuracy.read_records(prod.r2))
    se = run_accuracy.align_se(idx, recs1, {}, "cpu")
    pe = run_accuracy.align_pe(idx, recs1, recs2, {}, "cpu")
    assert len(se.sam) == len(recs1) and len(pe.sam) == 2 * len(recs1)
    want = reports(text)
    assert se.ev.report().splitlines() == want["SE"]
    assert pe.ev.report().splitlines() == want["PE"]
    assert se.launches == pe.launches == {"lv_distance": 0, "sw_score": 0}


def test_mutations_to_hapmap_equals_salt_tpu(tmp_path):
    text = ("chr1\t10\tA\tG\t-\n"      # substitution
            "chr1\t20\tT\tC\t+\n"      # substitution, alt before ref
            "chr1\t30\tG\t-\t-\n"      # deletion
            "chr1\t40\t-\tAC\t+\n"     # insertion
            "chr1\t50\tC\tAT\t-\n"     # multi-base alt
            "chr1\t60\tC\n"            # short line
            "chr2\t5\tG\tT\t+\n")
    mut = tmp_path / "mutations.txt"
    mut.write_text(text)
    tool = salt_tpu_tool()
    n_want = tool.mutations_to_hapmap(str(mut), str(tmp_path / "want.txt"))
    n_got = run_accuracy.mutations_to_hapmap(str(mut), str(tmp_path / "got.txt"))
    assert n_got == n_want == 3
    assert (tmp_path / "got.txt").read_text() == (tmp_path / "want.txt").read_text()


def test_gate_fails_over_max_err(runs):
    _rc, _text, wd = runs("port", "uniform")
    rc, text = run_port(CASES["uniform"] + ["--workdir", wd, "--se-only",
                                            "--max-err", "-1"])
    assert rc == 1
    assert text.splitlines()[-1].startswith("[harness] FAIL: error rate ")


def test_vendored_sim_raises_without_its_source(tmp_path, monkeypatch):
    """No wgsim binary and no wgsim.c: gcc fails, as in salt_tpu, and
    nothing switches to the internal simulator."""
    genome = tmp_path / "g.fa"
    genome.write_text(">chr1\n" + "ACGT" * 500 + "\n")
    missing = str(tmp_path / "absent" / "wgsim.c")
    tool = salt_tpu_tool()
    monkeypatch.setattr(tool, "WGSIM_SRC", missing)
    monkeypatch.setattr(run_accuracy, "WGSIM_SRC", missing)
    monkeypatch.setattr(run_accuracy, "WGSIM_BIN", str(tmp_path / "absent" / "wgsim"))
    argv = ["10", "--genome", str(genome), "--sim", "vendored"]
    with pytest.raises(Exception) as want:
        run_salt_tpu(argv + ["--workdir", str(tmp_path / "a")], tool)
    with pytest.raises(Exception) as got:
        run_port(argv + ["--workdir", str(tmp_path / "b")])
    assert got.type is want.type
    if want.type is subprocess.CalledProcessError:
        assert got.value.cmd[-3] == missing
    assert not os.path.exists(tmp_path / "b" / "R1_10_0.0_0.0_g.fa.fq")


def test_device_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA"):
        run_accuracy.main(CASES["uniform"] + ["--workdir", str(tmp_path)])
    assert not os.listdir(tmp_path)
