"""SEOptions.fast_cap: a narrow first locate pass whose overflowed reads
are seeded and located again at full_cap().  On the repeat genome the SAM
with fast_cap=64 equals the SAM with fast_cap=0 and salt_tpu's with
fast_cap=64, and the re-locate really ran.  Tolerance: exact."""

import pytest

from salt_tpu.pipeline.engine import SEAligner as JaxAligner
from salt_tpu.pipeline.engine import SEOptions as JaxOptions
from salt_tpu_torch.pipeline.engine import SEAligner, SEOptions

from torch_fixtures import repeat_fixture

OPTS = dict(l_overlap=1, max_locate=200, verify_width=16, print_nm_md=True,
            print_xa_cigar=True, batch_size=64, gap_batch=16)


@pytest.mark.parametrize("fast_cap,max_locate,margin,cap,full", [
    (0, 1000, 128, 1152, 1152), (64, 1000, 128, 64, 1152),
    (65, 1000, 128, 128, 1152), (1, 200, 128, 64, 384),
    (5000, 200, 128, 384, 384), (-3, 16, 128, 192, 192),
    (100, 16, 0, 64, 64)])
def test_cap_rounds_to_64_and_stops_at_full_cap(fast_cap, max_locate, margin,
                                                cap, full):
    kw = dict(fast_cap=fast_cap, max_locate=max_locate, cap_margin=margin)
    o, j = SEOptions(**kw), JaxOptions(**kw)
    assert (o.cap(), o.full_cap()) == (cap, full) == (j.cap(), j.full_cap())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    idx, records = repeat_fixture(str(tmp_path_factory.mktemp("fast_cap")))
    out = {}
    for name, extra in (("one_tier", {}), ("two_tiers", dict(fast_cap=64)),
                        ("two_tiers_x1", dict(fast_cap=64, extend_algo="sw")),
                        ("one_tier_x1", dict(extend_algo="sw"))):
        al = SEAligner(idx, SEOptions(**OPTS, **extra), device="cpu")
        caps, step = [], al._ungapped

        def noting(fwd, rev, cap, u, step=step, caps=caps):
            caps.append((fwd.shape[0], cap, u))
            return step(fwd, rev, cap, u)

        al._ungapped = noting
        out[name] = (al.align_records(records), caps)
    for name, extra in (("jax_two_tiers", dict(fast_cap=64)),
                        ("jax_two_tiers_x1", dict(fast_cap=64,
                                                  extend_algo="sw"))):
        out[name] = (JaxAligner(idx, JaxOptions(**OPTS, **extra))
                     .align_records(records), None)
    return out


def _assert_same(want, got):
    assert len(want) == len(got)
    bad = [(a, b) for a, b in zip(want, got) if a != b]
    assert not bad, f"{len(bad)}/{len(want)} records differ; first: {bad[0]}"


@pytest.mark.parametrize("a,b", [("one_tier", "two_tiers"),
                                 ("jax_two_tiers", "two_tiers"),
                                 ("one_tier_x1", "two_tiers_x1"),
                                 ("jax_two_tiers_x1", "two_tiers_x1")])
def test_fast_cap_sam_identical(runs, a, b):
    _assert_same(runs[a][0], runs[b][0])


@pytest.mark.parametrize("name", ["two_tiers", "two_tiers_x1"])
def test_fast_cap_relocates_overflowed_rows(runs, name):
    """The first pass runs at 64 slots; rows that overflow it go through
    the ungapped step again at full_cap() = 384 slots and width."""
    caps = runs[name][1]
    first = [c for c in caps if c[1:] == (64, 16)]
    again = [c for c in caps if c[1:] == (384, 384)]
    assert first and again and len(first) + len(again) == len(caps)
    assert 0 < sum(c[0] for c in again) < sum(c[0] for c in first)


def test_one_tier_never_relocates(runs):
    assert {c[1:] for c in runs["one_tier"][1]} == {(384, 16)}
