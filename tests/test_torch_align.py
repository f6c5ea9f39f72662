"""The port's alignment DPs (ops/align.py) against the JAX package's on the
CPU, with exact equality: the overlap DP on the device with its packed
traceback, decoded, against the JAX package's host f64 DP
(``overlap_alignment``) piece for piece, also for weights past the JAX
device DP's int32 domain; the batched distance DP against the JAX batch and
scalar distances; the host screen and the midpoint against JAX."""

import jax
import numpy as np
import pytest

from autocycler_tpu.commands import trim as jax_trim
from autocycler_tpu.ops import align as jax_align
from autocycler_tpu_torch import device
from autocycler_tpu_torch.commands import trim as port_trim
from autocycler_tpu_torch.ops import align
from autocycler_tpu_torch.utils import reverse_signed_path

from test_trim import W1, W10, W_MIX

# reference trim.rs test paths over W1 (~90-unitig real-scale paths)
REAL_SCALE = [
    [-653, 4876, -3456, 2018, -1913, -1492, -977, 1993, -757, -2640, 4216,
     -2640, 4216, -2640, 728, 1967, -4238, -1552, -4575, -2289, 4875, 1982,
     1637, -1010, 2826, -1667, -1949, -1133, 1105, 2499, 1952, -5191, -2276,
     2937, -3148, 2110, 3578, -2065, 2012, -2148, 2070, 1058],
    [-728, 2640, -4216, 2640, -4216, 2640, 757, -1993, 977, 1492, 1913,
     -2018, 3456, -4876, 653, -1943, -1058, -2070, 2148, -2012, 2065, -3578,
     -2110, 3148, -2937, 2276, 5191, -1952, -2499, -1105, 1133, 1949, 1667,
     -2826, 1010, -1637, -1982, -4875, 2289, 4575, 1552, 4238, -1967, -728,
     2640, -4216, 2640, -4216, 2640, 757, -1993, 977, 1492, 1913, -2018,
     3456, -4876, 653, -1943, -1058, -2070, 2148, -2012, 2065, -3578, -2110,
     3148, -2937, 2276, 5191, -1952, -2499, -1105, 1133, 1949, 1667, -2826,
     1010, -1637, -1982, -4875, 2289, 4575, 1552, 4238],
    [-977, 1993, -757, -2640, 4216, -2640, 4216, -2640, 728, 1967, -4238,
     -1552, -4575, -2289, 4875, 1982, 1637, -1010, 2826, -1667, -1949, -1133,
     1105, 2499, 1952, -5191, -2276, 2937, -3148, 2110, 3578, -2065, 2012,
     -2148, 2070, 1058, 1943, -653, 4876, -3456, 2018, -1913, -1492, -977,
     1993, -757, -2640, 4216, -2640, 4216, -2640, 728, 1967, -4238, -1552,
     -4575, -2289, 4875, 1982, 1637, -1010, 2826, -1667, -1949, -1133, 1105,
     2499, 1952, -5191, -2276, 2937, -3148, 2110, 3578, -2065, 2012, -2148,
     2070, 1058, 1943, -653, -3208, 2018, -1913],
]
HAIRPINS = [
    ([1, 2, 3, 4, 5, -5, -4, -3, -2, -1], W10),
    ([7, 8, 9, 10, -10, -9, -8, -7, -6, -5, -4, -3, -2, -1], W10),
    ([1, 2, 3, 6, 4, 7, 5, -5, 8, 9, 10, -4, -3, -2, -1], W_MIX),
    ([1, 2, 3, 6, 7, 4, 8, 9, 5, -5, -4, -3, -2, 10, -1], W_MIX),
    ([-5, -4, -3, -2, 10, -1, 1, 2, 3, 6, 7, 4, 8, 9, 5], W_MIX),
    ([-9, 3, 2, 1, -1, -2, -3, -4, -5, -6], W_MIX),
    ([-5, -4, -3, -2, -1, 1, 2, 3, 4, 5, 6, 7, 8], W10),
]


def _jobs(path, weights):
    """The three jobs trim builds for one path: start-end, hairpin start,
    hairpin end."""
    rev = reverse_signed_path(path)
    return [(path, path, weights, True), (path, rev, weights, False),
            (rev, path, weights, False)]


def _port_alignments(jobs, max_unitigs, min_identity):
    """Screen on the host, then the device DP (here the CPU) on the rest."""
    keep = [i for i, job in enumerate(jobs)
            if align.overlap_may_be_positive(job, max_unitigs)]
    out = [[] for _ in jobs]
    for i, pieces in zip(keep, align.overlap_tracebacks_batch(
            [jobs[i] for i in keep], max_unitigs, min_identity, "cpu")):
        out[i] = pieces
    return out


def _host_alignments(jobs, max_unitigs, min_identity):
    return [jax_align.overlap_alignment(a, b, w, min_identity, max_unitigs, s)
            for a, b, w, s in jobs]


def _random_path(rng, n, n_units, overlap):
    path = [int(u) * int(s) for u, s in
            zip(rng.integers(1, n_units + 1, size=n),
                rng.choice([-1, 1], size=n))]
    if overlap == "start_end":
        path[-3:] = path[:3]
    elif overlap == "hairpin":
        path[-3:] = reverse_signed_path(path[-6:-3])
    return path


@pytest.mark.parametrize("max_unitigs", [5000, 12, 3, 1])
@pytest.mark.parametrize("weight_range", [(1, 300), (1 << 26, 1 << 27)])
def test_overlap_dp_matches_host_f64_dp(max_unitigs, weight_range):
    """Random paths with start-end and hairpin overlaps, batched together.
    Weights near 2**26 put every job outside the JAX device DP's int32
    domain (traceback_in_domain False); the port runs them all."""
    rng = np.random.default_rng(max_unitigs + weight_range[0])
    jobs = []
    for trial in range(40):
        n_units = int(rng.integers(2, 9))
        w = np.zeros(n_units + 1, np.int64)
        w[1:] = rng.integers(*weight_range, size=n_units)
        path = _random_path(rng, int(rng.integers(1, 60)), n_units,
                            ("start_end", "hairpin", None)[trial % 3])
        jobs += _jobs(path, w)
    if weight_range[0] > 1:
        assert not any(jax_align.traceback_in_domain(job, max_unitigs)
                       for job in jobs if job[0])
    want = _host_alignments(jobs, max_unitigs, 0.6)
    assert _port_alignments(jobs, max_unitigs, 0.6) == want
    assert sum(bool(pieces) for pieces in want) >= 5


@pytest.mark.parametrize("min_identity", [0.95, 0.5])
def test_overlap_dp_real_scale_paths(min_identity):
    jobs = [job for path in REAL_SCALE for job in _jobs(path, W1)] + \
        [job for path, w in HAIRPINS for job in _jobs(path, w)]
    for max_unitigs in (1000, 30):
        want = _host_alignments(jobs, max_unitigs, min_identity)
        assert _port_alignments(jobs, max_unitigs, min_identity) == want
        assert any(want)


def test_overlap_dp_edges_and_bits_match_jax_device_dp():
    """The DP's own outputs against the JAX package's jnp DP, in its int32
    domain: the doubled right-edge scores (the skipped diagonal's cell at
    each package's sentinel) and every unpacked up_ge bit of each job's rows
    and columns 1..k."""
    rng = np.random.default_rng(5)
    jobs = []
    for trial in range(12):
        w = np.zeros(7, np.int64)
        w[1:] = rng.integers(1, 500, size=6)
        path = _random_path(rng, int(rng.integers(1, 150)), 6,
                            ("start_end", "hairpin", None)[trial % 3])
        jobs += _jobs(path, w)
    arrs = align.pack_overlap_jobs(jobs, 100, "cpu")
    edges, bits = (t.numpy() for t in align.overlap_screen_traceback(arrs))
    jax_arrs, _ = jax_align.pack_overlap_jobs(jobs, 100)
    _, jax_edges, jax_bits = jax.jit(jax_align.overlap_screen_traceback)(
        jax_arrs)
    jax_edges, jax_bits = np.asarray(jax_edges, np.int64), np.asarray(jax_bits)
    jax_edges = np.where(jax_edges == jax_align._NEG_BIG, align._NEG_BIG,
                         jax_edges)
    assert (edges == align._NEG_BIG).any()
    K = edges.shape[0]
    col = np.arange(K)
    got = (bits[:, :, col // align.WORD_BITS] >> (col % align.WORD_BITS)) & 1
    want = (jax_bits[:, :, col // 32].astype(np.int64) >> (col % 32)) & 1
    for p, k in enumerate(arrs["k"].tolist()):
        assert np.array_equal(edges[:k, p], jax_edges[:k, p])
        assert np.array_equal(got[:k, p, :k], want[:k, p, :k])


def test_overlap_dp_one_row_and_empty_jobs():
    w = {1: 5, 2: 7}
    jobs = [([1], [1], w, True), ([1], [1], w, False), ([2], [-2], w, False),
            ([], [], w, True)]
    assert _port_alignments(jobs, 5000, 0.5) == _host_alignments(jobs, 5000,
                                                                  0.5)
    assert align.overlap_tracebacks_batch([], 5000, 0.5, "cpu") == []
    assert align.pack_overlap_jobs([([], [], w, True)], 5000, "cpu") is None


def test_trim_paths_match_jax_host_dp():
    """trim_path_* fed the device-decoded alignment against the JAX
    package's, which run the host DP."""
    rng = np.random.default_rng(3)
    cases = [(path, W1, 0.95) for path in REAL_SCALE] + \
        [(path, w, 0.95) for path, w in HAIRPINS]
    for trial in range(30):
        w = np.zeros(8, np.int64)
        w[1:] = rng.integers(1, 300, size=7)
        cases.append((_random_path(rng, int(rng.integers(6, 50)), 7,
                                   ("start_end", "hairpin")[trial % 2]),
                      w, 0.75))
    trimmed = 0
    for path, w, min_identity in cases:
        se, hs, he = _port_alignments(_jobs(path, w), 1000, min_identity)
        got = (port_trim.trim_path_start_end(path, w, se),
               port_trim.trim_path_hairpin_start(path, hs),
               port_trim.trim_path_hairpin_end(path, he))
        want = (jax_trim.trim_path_start_end(path, w, min_identity, 1000),
                jax_trim.trim_path_hairpin_start(path, w, min_identity, 1000),
                jax_trim.trim_path_hairpin_end(path, w, min_identity, 1000))
        assert got == want
        trimmed += sum(r is not None for r in want)
    assert trimmed >= 10


def test_overlap_dp_at_the_5000_unitig_cap():
    """A 6,500-unitig path with a 500-unitig start-end overlap: the DP is
    capped at 5000 x 5000 and still finds the overlap exactly."""
    rng = np.random.default_rng(3)
    n = 6000
    ids = rng.integers(1, 100000, n)
    body = (ids * rng.choice([-1, 1], n)).tolist()
    path = body + body[:500]
    weights = {int(i): int(rng.integers(50, 500)) for i in ids}
    device.reset_counts()
    (se,) = _port_alignments([(path, path, weights, True)], 5000, 0.75)
    assert device.dp_summary("trim_overlap_dp")["rows"] == 5000
    assert se == jax_align.overlap_alignment(path, path, weights, 0.75, 5000,
                                             True)
    assert port_trim.trim_path_start_end(path, weights, se) == \
        jax_trim.trim_path_start_end(path, weights, 0.75, 5000)


def test_host_screen_matches_jax():
    """A job the screen clears finds nothing in the JAX host DP, and every
    job the JAX device screen finds positive passes the screen."""
    rng = np.random.default_rng(8)
    jobs = []
    for trial in range(60):
        w = np.zeros(6, np.int64)
        w[1:] = rng.integers(1, 100, size=5)
        path = _random_path(rng, int(rng.integers(1, 30)), 5,
                            ("start_end", "hairpin", None)[trial % 3])
        jobs += _jobs(path, w)
    for max_unitigs in (5000, 4):
        screened = [align.overlap_may_be_positive(job, max_unitigs)
                    for job in jobs]
        positive = jax_align.overlap_positive_batch(jobs, max_unitigs)
        assert all(s or not p for s, p in zip(screened, positive))
        assert not any(jax_align.overlap_alignment(a, b, w, 0.0, max_unitigs, s)
                       for (a, b, w, s), keep in zip(jobs, screened) if not keep)
        assert 0 < sum(screened) < len(jobs)


def test_find_midpoint_matches_jax():
    jobs = [job for path in REAL_SCALE for job in _jobs(path, W1)]
    for pieces in _host_alignments(jobs, 1000, 0.5):
        if pieces:
            assert align.find_midpoint(pieces, W1) == \
                jax_align.find_midpoint(pieces, W1)


def _pairs(rng, n_pairs, max_len):
    pairs = []
    for _ in range(n_pairs):
        pairs.append(tuple(tuple(int(u) * int(s) for u, s in zip(
            rng.integers(1, 9, size=int(rng.integers(0, max_len + 1))),
            rng.choice([-1, 1], size=max_len))) for _ in range(2)))
    return pairs


@pytest.mark.parametrize("max_len", [1, 20, 64, 65, 150])
def test_distance_batch_matches_jax(max_len):
    rng = np.random.default_rng(max_len)
    weights = {u: int(rng.integers(1, 5000)) for u in range(1, 9)}
    pairs = _pairs(rng, 40, max_len)
    device.reset_counts()
    got = align.global_alignment_distance_batch(pairs, weights, "cpu")
    assert device.dp_summary("resolve_medoid_dp")["pairs"] == len(pairs)
    scalar = [jax_align.global_alignment_distance(a, b, weights)
              for a, b in pairs]
    assert got.tolist() == scalar
    assert jax_align.global_alignment_distance_batch(pairs, weights).tolist() \
        == scalar


def test_distance_batch_empty():
    assert align.global_alignment_distance_batch([], {}, "cpu").shape == (0,)
    assert align.global_alignment_distance_batch(
        [((), ()), ((1,), ())], {1: 9}, "cpu").tolist() == [0, 9]


def test_medoid_pairs_longer_than_64_run_on_the_device():
    """Resolve sends every distinct-path pair to the device DP, in batches
    by length class; a Bridge reads only those distances, and a pair
    missing from them raises instead of running on the host."""
    from autocycler_tpu.commands import resolve as jax_resolve
    from autocycler_tpu_torch.commands import resolve as port_resolve

    rng = np.random.default_rng(2)
    weights = {u: int(rng.integers(1, 5000)) for u in range(1, 9)}
    grouped = {}
    for g, max_len in enumerate((10, 64, 65, 200, 700)):
        grouped[(100 + g, 200 + g)] = [
            [100 + g, *pair[0], 200 + g] for pair in _pairs(rng, 3, max_len)]
    device.reset_counts()
    got = port_resolve._batched_medoid_distances(grouped, weights, "cpu")
    assert got == jax_resolve._batched_medoid_distances(grouped, weights)
    classes = {max(6, (max(len(a), len(b)) - 1).bit_length()) for a, b in got}
    each = device.dp_summary("resolve_medoid_dp")["each"]
    assert len(each) == len(classes) >= 3
    assert all(d["rows"] <= 1 << cls for d, cls in zip(each, sorted(classes)))
    for (start, end), paths in grouped.items():
        bridge = port_resolve.Bridge(start, end, paths, got)
        assert bridge.best_path == jax_resolve.Bridge(
            start, end, paths, weights).best_path
        if len({tuple(p) for p in paths}) > 1:
            with pytest.raises(KeyError):
                port_resolve.Bridge(start, end, paths, {})
