"""The traffic is the same for the same seed and differs for another."""

import numpy as np
import torch

from benchmark import run, train_check
from benchmark.drivers import code_batch, serve_open
from benchmark.images import smooth_images
from benchmark.tests.cpu import full_spec

SPEC = full_spec()


def _traffic(driver):
    return [run.traffic_of(c) for c in SPEC["workloads"]
            if run.traffic_of(c)["driver"] == driver][0]


def test_images_follow_the_seed():
    a = smooth_images(np.random.default_rng(5), 2, 32, 48, "cpu")
    b = smooth_images(np.random.default_rng(5), 2, 32, 48, "cpu")
    c = smooth_images(np.random.default_rng(6), 2, 32, 48, "cpu")
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert float(a.min()) >= -1 and float(a.max()) <= 1 and a.shape == (2, 3, 32, 48)


def test_code_batches_follow_the_seed():
    p = dict(_traffic("code_batch"), size=[64, 96], batch=2)
    (pa, ca), (pb, cb), (pc, cc) = (code_batch.inputs(p, s, "cpu") for s in (3, 3, 4))
    assert ca == cb and all(torch.equal(x, y) for x, y in zip(pa, pb))
    assert not torch.equal(pa[0], pc[0])


def test_serve_schedule_follows_the_seed_with_the_same_work():
    p = _traffic("serve_open")
    a, b, c = (serve_open.schedule(p, s, 10.0) for s in (3, 3, 2 ** 31 + 5))
    assert a == b and a != c
    # every seed: the same gaps, kinds and sizes, in another order
    gaps = lambda s: sorted(np.diff([0.0] + [r[0] for r in s]).round(9).tolist())
    assert len(a) == len(c)
    assert sorted(r[1] for r in a) == sorted(r[1] for r in c)
    assert sorted(r[2] for r in a) == sorted(r[2] for r in c)
    assert np.allclose(gaps(a), gaps(c), atol=1e-8)
    assert a[-1][0] < 10.0


def test_training_crops_follow_the_seed():
    p = dict(_traffic("train"), crop=16, batch=2, threads=2)
    px = np.random.default_rng(0).integers(0, 256, (3, 24, 40, 3), dtype=np.uint8)
    a = train_check.candidate_batches(px, p, 7, 2)
    b = train_check.candidate_batches(px, p, 7, 2)
    c = train_check.candidate_batches(px, p, 8, 2)
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a)
    got = train_check.match_batches([a[(1, 0)], a[(0, 1)], a[(0, 0)] + 1], b)
    assert torch.equal(got[0], a[(1, 0)]) and torch.equal(got[1], a[(0, 1)]) and got[2] is None


def test_seeds_above_32_bits_are_taken():
    p = dict(_traffic("code_batch"), size=[64, 64], batch=1, pool=2, checked=1)
    code_batch.inputs(p, 2 ** 31 + 12345, "cpu")
