"""The port's plain LV distance (salt_tpu_torch.ops.lv) against
salt_tpu.ops.lv.lv_distance_batch and the Pallas kernel in interpret
mode, on the same numpy-seeded inputs.  Tolerance: exact (integer
distances).  The CUDA kernel itself is compared with the plain version
on the card by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from salt_tpu.ops.lv import lv_distance_batch as jax_lv
from salt_tpu.ops.lv_pallas import lv_distance_batch_pallas
from salt_tpu.pipeline.device_index import pack_nibbles as jax_pack_nibbles
from salt_tpu_torch.ops import lv_cuda
from salt_tpu_torch.ops.lv import (
    NT2BIT_NP,
    lv_cigar_host,
    lv_distance_batch,
    lv_distance_host,
    lv_distance_plain,
)
from salt_tpu_torch.pipeline.device_index import pack_nibbles


def _case(seed, N=130, L=100, mlen=6000, k=10):
    """Reference nibbles with SNPs (two bits set), candidates with planted
    substitutions and indels, random reads, inactive lanes, and positions
    past the reference end and >= 2^31 (word index clamped)."""
    rng = np.random.default_rng(seed)
    mix = (1 << rng.integers(0, 4, mlen)).astype(np.uint8)
    snp = rng.random(mlen) < 0.05
    mix[snp] |= (1 << rng.integers(0, 4, snp.sum())).astype(np.uint8)
    pos = rng.integers(0, mlen - L - 30, N).astype(np.uint32)
    seq = rng.integers(0, 4, (N, L)).astype(np.int32)
    for i in range(0, N, 2):
        window = mix[pos[i] : pos[i] + L + 8]
        bases = np.array([(int(v) & -int(v)).bit_length() - 1 for v in window])
        r = list(bases[:L])
        for _ in range(int(rng.integers(0, min(k, 4) + 1))):
            j = int(rng.integers(0, len(r) - 1))
            op = rng.integers(0, 3)
            if op == 0:
                r[j] = (r[j] + 1) % 4
            elif op == 1:
                del r[j]
            else:
                r.insert(j, int(rng.integers(0, 4)))
        seq[i] = (r + list(bases[len(r):]))[:L]
    seq[5, 7] = 4                                   # an N base
    pos[-3:] = [mlen - 3, 2**31 + 17, 2**32 - 5]    # clamped / wrapping
    active = rng.random(N) < 0.9
    return mix, pos, active, seq


def _port(mix, pos, active, seq, k, text_words, pat_precoded=False):
    ref = pack_nibbles(mix).view(np.int32) if text_words else mix
    return lv_distance_plain(
        torch.from_numpy(ref), torch.from_numpy(pos.astype(np.int64)),
        torch.from_numpy(active), torch.from_numpy(seq), k,
        pat_precoded=pat_precoded, text_words=text_words).numpy()


@pytest.mark.parametrize("k", [0, 3, 10, 30])
@pytest.mark.parametrize("text_words", [True, False])
def test_plain_matches_jax(k, text_words):
    mix, pos, active, seq = _case(k, k=k)
    ref = jax_pack_nibbles(mix) if text_words else mix
    want = np.asarray(jax_lv(jnp.asarray(ref), jnp.asarray(pos.view(np.int32)),
                             jnp.asarray(active), jnp.asarray(seq), k,
                             text_words=text_words))
    got = _port(mix, pos, active, seq, k, text_words)
    assert (got == want).all(), np.nonzero(got != want)
    assert (got[~active] == 255).all()
    assert len(set(got[active].tolist())) > min(k, 2)


# k=30 runs against the jnp version above only: the Pallas interpreter
# takes over ten minutes for it on the CPU
@pytest.mark.parametrize("k", [0, 3, 10])
def test_plain_matches_pallas_interpret(k):
    mix, pos, active, seq = _case(100 + k, k=k)
    want = np.asarray(lv_distance_batch_pallas(
        jnp.asarray(jax_pack_nibbles(mix)), jnp.asarray(pos.view(np.int32)),
        jnp.asarray(active), jnp.asarray(seq), k, interpret=True,
        text_words=True))
    assert (_port(mix, pos, active, seq, k, True) == want).all()


@pytest.mark.parametrize("k", [3, 10])
def test_pat_precoded_matches_jax(k):
    mix, pos, active, seq = _case(200 + k, k=k)
    codes = NT2BIT_NP[np.minimum(seq, 4)].astype(np.int32)
    codes[::7, ::5] = 3                     # multi-bit AND codes
    want = np.asarray(jax_lv(jnp.asarray(mix), jnp.asarray(pos.view(np.int32)),
                             jnp.asarray(active), jnp.asarray(codes), k,
                             pat_precoded=True))
    assert (_port(mix, pos, active, codes, k, False, pat_precoded=True)
            == want).all()


def test_plain_matches_host_reference():
    """Active in-range lanes agree with the reference-exact host walk."""
    mix, pos, active, seq = _case(7, N=40)
    got = _port(mix, pos, active, seq, 10, True)
    for i in range(len(pos) - 3):
        if not active[i]:
            continue
        e = lv_distance_host(mix[pos[i] : pos[i] + 104],
                             NT2BIT_NP[np.minimum(seq[i], 4)], 10)
        assert got[i] == (255 if e < 0 else e), i


def test_host_cigar_matches_salt_tpu():
    from salt_tpu.ops.lv import lv_cigar_host as jax_cigar

    mix, pos, _active, seq = _case(9, N=30)
    for i in range(0, 30, 2):
        text = mix[pos[i] : pos[i] + 104]
        pat = NT2BIT_NP[np.minimum(seq[i], 4)]
        assert lv_cigar_host(text, pat, 10) == jax_cigar(text, pat, 10)


def test_dispatch_on_cpu_runs_plain_version():
    mix, pos, active, seq = _case(11, N=40)
    before = lv_cuda.LV.launches
    args = (torch.from_numpy(pack_nibbles(mix).view(np.int32)),
            torch.from_numpy(pos.astype(np.int64)), torch.from_numpy(active),
            torch.from_numpy(seq.astype(np.uint8)), 10)
    got = lv_distance_batch(*args, text_words=True)
    assert torch.equal(got, lv_distance_plain(*args, text_words=True))
    assert lv_cuda.LV.launches == before == 0


def test_kernel_wrapper_rejects_cpu_tensors():
    mix, pos, active, seq = _case(12, N=8)
    with pytest.raises(ValueError, match="CUDA"):
        lv_cuda.lv_distance_cuda(
            torch.from_numpy(pack_nibbles(mix).view(np.int32)),
            torch.from_numpy(pos.astype(np.int64)), torch.from_numpy(active),
            torch.from_numpy(seq.astype(np.uint8)), 10, 4)
    assert lv_cuda.LV.launches == 0
