"""The port's batched Smith-Waterman score (ops/sw_batch.py) against
salt_tpu's sw_score_batch, its Pallas kernels in interpret mode, the
naive numpy oracle and the port's SSW.  All scores are integers:
tolerance 0."""

import numpy as np
import pytest
import torch

from salt_tpu.ops.sw_batch import sw_score_batch
from salt_tpu_torch.ops import sw_cuda
from salt_tpu_torch.ops.ssw import SCORE_MAT5, SCORE_MAT16, ssw_align
from salt_tpu_torch.ops.sw_batch import sw_score, sw_score_numpy, sw_score_plain

ONEHOT = np.array([1, 2, 4, 8, 15], dtype=np.int8)


def _rand_case(rng, snp, L=40, W=90):
    """(window, read one-hot, read codes): the window holds a mutated
    copy of the read, sometimes with an indel; SNP windows carry
    multi-bit nibbles."""
    read = rng.integers(0, 4, L).astype(np.int8)
    ref_codes = rng.integers(0, 4, W).astype(np.int8)
    at = int(rng.integers(0, W - L))
    mut = read.copy()
    for _ in range(int(rng.integers(0, 6))):
        p = int(rng.integers(0, L))
        mut[p] = (mut[p] + 1) % 4
    if rng.random() < 0.5:
        p = int(rng.integers(1, L - 1))
        mut = np.concatenate([mut[:p], mut[p + 1 :], [0]]).astype(np.int8)
    ref_codes[at : at + L] = mut[:L]
    if snp:
        ref = ONEHOT[ref_codes].astype(np.int8)
        for _ in range(4):
            ref[int(rng.integers(0, W))] |= 1 << int(rng.integers(0, 4))
        return ref, ONEHOT[read].astype(np.int8), read
    return ref_codes, ONEHOT[read].astype(np.int8), read


def _batch(rng, snp, B, L=40, W=90):
    cases = [_rand_case(rng, snp, L, W) for _ in range(B)]
    refs = np.zeros((B, W), np.int32)
    reads = np.zeros((B, L), np.int32)
    lens = np.zeros(B, np.int32)
    for i, (ref, onehot, read) in enumerate(cases):
        refs[i, : len(ref)] = ref
        reads[i] = onehot if snp else read
        lens[i] = len(ref)
    return cases, refs, reads, lens


def _port(refs, reads, lens, snp, dtype=torch.uint8):
    return sw_score(torch.from_numpy(refs).to(dtype),
                    torch.from_numpy(reads).to(dtype),
                    torch.from_numpy(lens), snp).numpy()


@pytest.mark.parametrize("snp", [True, False])
def test_plain_matches_jax_and_numpy(snp):
    rng = np.random.default_rng(0 if snp else 1)
    cases, refs, reads, lens = _batch(rng, snp, 12)
    lens[3] = 50            # a truncated window
    refs[4, 7] = 0          # reference nibble 0 / code 0
    refs[5, 9] = 15 if snp else 4
    reads[6, 11] = 15 if snp else 4
    got = _port(refs, reads, lens, snp)
    assert got.dtype == np.int32
    want = np.asarray(sw_score_batch(refs, reads, lens, snp_mode=snp))
    assert (got == want).all(), (got, want)
    for i in range(len(cases)):
        assert got[i] == sw_score_numpy(refs[i, : lens[i]], reads[i], snp)
    # int32 inputs, as salt_tpu's engines assemble them, score the same
    assert (_port(refs, reads, lens, snp, torch.int32) == got).all()


@pytest.mark.parametrize("variant", ["wave", "grid", "fori"])
def test_plain_matches_pallas_interpret(variant, monkeypatch):
    from salt_tpu.ops.sw_pallas import sw_score_batch_pallas

    monkeypatch.setenv("SALT_TPU_SW_KERNEL", variant)
    rng = np.random.default_rng(5)
    for snp in (True, False):
        _cases, refs, reads, lens = _batch(rng, snp, 9, L=33, W=70)
        want = np.asarray(sw_score_batch_pallas(
            refs, reads, lens, snp_mode=snp, interpret=True))
        got = _port(refs, reads, lens, snp)
        assert (got == want).all(), (snp, got, want)


def test_padding_is_inert():
    """Columns past ref_len and read padding (0 in SNP mode, 4 in plain
    mode) change nothing."""
    rng = np.random.default_rng(7)
    for snp in (True, False):
        ref, onehot, read = _rand_case(rng, snp)
        q = onehot if snp else read
        refs = rng.integers(1, 4, (1, len(ref) + 64)).astype(np.int32)
        refs[0, : len(ref)] = ref
        reads = np.full((1, len(q) + 8), 0 if snp else 4, np.int32)
        reads[0, : len(q)] = q
        lens = np.array([len(ref)], np.int32)
        assert _port(refs, reads, lens, snp)[0] == sw_score_numpy(ref, q, snp)


@pytest.mark.parametrize("snp", [True, False])
def test_wide_rescue_shape(snp):
    """The PE rescue shape: W = 512, L = 104 (100 bp reads padded to 8)."""
    rng = np.random.default_rng(21 if snp else 22)
    _cases, refs, reads, lens = _batch(rng, snp, 6, L=100, W=512)
    reads = np.concatenate(
        [reads, np.full((6, 4), 0 if snp else 4, np.int32)], 1)
    lens[:] = [512, 301, 400, 512, 1, 0]
    got = _port(refs, reads, lens, snp)
    want = np.asarray(sw_score_batch(refs, reads, lens, snp_mode=snp))
    assert (got == want).all(), (got, want)
    assert got[0] > 60 and got[5] == 0


def test_ref_len_zero_and_empty_batch():
    refs = torch.ones((3, 20), dtype=torch.uint8)
    reads = torch.ones((3, 10), dtype=torch.uint8)
    lens = torch.zeros(3, dtype=torch.int32)
    assert sw_score(refs, reads, lens, True).tolist() == [0, 0, 0]
    out = sw_score(refs[:0], reads[:0], lens[:0], False)
    assert out.shape == (0,) and out.dtype == torch.int32


@pytest.mark.parametrize("snp", [True, False])
def test_textbook_score_bounds_ssw(snp):
    """ssw score <= textbook score (the sound-reject property), and equal
    on realistic cases, with the port's native SSW."""
    rng = np.random.default_rng(42 if snp else 43)
    cases, refs, reads, lens = _batch(rng, snp, 16)
    got = _port(refs, reads, lens, snp)
    n_eq = 0
    for i, (ref, onehot, read) in enumerate(cases):
        q, mat = (onehot, SCORE_MAT16) if snp else (read, SCORE_MAT5)
        r = ssw_align(q.astype(np.int8), ref.astype(np.int8), mat, 3, 1,
                      len(read) // 2, want_cigar=False)
        assert got[i] >= r.score1
        n_eq += int(got[i] == r.score1)
    assert n_eq == len(cases)


def test_cpu_tensors_take_the_plain_version_without_a_launch():
    rng = np.random.default_rng(3)
    _cases, refs, reads, lens = _batch(rng, True, 4)
    before = sw_cuda.SW.launches
    t = [torch.from_numpy(a) for a in (refs, reads, lens)]
    assert torch.equal(sw_score(*t, True), sw_score_plain(*t, True))
    assert sw_cuda.SW.launches == before == 0


def test_cuda_wrapper_refuses_cpu_tensors_and_bad_gaps():
    refs = torch.ones((2, 20), dtype=torch.uint8)
    reads = torch.ones((2, 10), dtype=torch.uint8)
    lens = torch.full((2,), 20, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        sw_cuda.sw_score_cuda(refs, reads, lens, True)
    with pytest.raises(ValueError, match="gap_open"):
        sw_score(refs, reads, lens, True, gap_open=1, gap_extend=2)
    assert sw_cuda.SW.launches == 0
