"""The port's minimizer sketches and sketch distances against the JAX
package's on the CPU, with tolerance 0: every compared value is an integer
or the one shared float expression. Sketches (hashed as torch ops on CPU
tensors) and intersection counts are equal bit for bit; from 256 contigs on, cluster's default mode sketches, and
the two packages' clustering files are byte-identical."""

import contextlib
import io
import shutil

import numpy as np
import pytest
import torch

from autocycler_tpu.commands import cluster as jax_cluster_mod
from autocycler_tpu.commands.cluster import cluster as jax_cluster
from autocycler_tpu.commands.compress import compress as jax_compress
from autocycler_tpu.models import UnitigGraph as JaxGraph
from autocycler_tpu.ops import encode as jax_encode
from autocycler_tpu.ops import sketch as jsk
from autocycler_tpu_torch import device
from autocycler_tpu_torch.commands import cluster as cluster_mod
from autocycler_tpu_torch.commands.cluster import cluster
from autocycler_tpu_torch.models import UnitigGraph
from autocycler_tpu_torch.ops import encode
from autocycler_tpu_torch.ops import sketch as sk

from synthetic import mutate_fast, random_genome_fast, revcomp, rotate

SKETCH_KNOBS = ("AUTOCYCLER_SKETCH_DISTANCE", "AUTOCYCLER_SKETCH_MIN_CONTIGS",
                "AUTOCYCLER_SKETCH_K", "AUTOCYCLER_SKETCH_W",
                "AUTOCYCLER_SKETCH_S")


@pytest.fixture(autouse=True)
def _default_knobs(monkeypatch):
    for name in SKETCH_KNOBS:
        monkeypatch.delenv(name, raising=False)


def _quiet(fn, *args, **kwargs):
    with contextlib.redirect_stderr(io.StringIO()):
        return fn(*args, **kwargs)


def _ascii(rng, n: int) -> np.ndarray:
    return np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, size=n)]


def _contigs(rng, window: int):
    """ASCII contigs: random, dot-padded, dotted inside, one base too short
    for a window of ``window`` bases and exactly one window long, poly-A,
    and one with its reverse complement."""
    body = _ascii(rng, 3000)
    dotted = body.copy()
    dotted[rng.integers(0, len(dotted), size=40)] = ord(".")
    padded = np.concatenate([np.full(25, ord("."), np.uint8), body[:1500],
                             np.full(25, ord("."), np.uint8)])
    rc = np.frombuffer(bytes(revcomp(body.tobytes().decode()), "ascii"),
                       np.uint8)
    return {"random": body, "rc": rc, "dotted": dotted, "padded": padded,
            "short": body[:window - 1], "exact_window": body[:window],
            "poly_a": np.full(500, ord("A"), np.uint8),
            "long": _ascii(rng, 20_000)}


def _sketch(fwd, rc, k, w, s):
    """The port's sketch of numpy strands, hashed on the CPU, as the JAX
    package's (uint32 vector, m)."""
    sketch, m = sk.sketch_from_codes(torch.from_numpy(fwd),
                                     torch.from_numpy(rc), k, w, s)
    return sketch.numpy().astype(np.uint32), m


@pytest.mark.parametrize("k,w,s", [(21, 11, 1024), (27, 5, 64), (27, 11, 8),
                                   (4, 1, 16), (15, 5, 256), (11, 20, 1)])
def test_sketch_from_codes_matches_jax(k, w, s):
    contigs = _contigs(np.random.default_rng(k * 1000 + w * 10 + s), k + w - 1)
    got = {}
    for name, seq in contigs.items():
        fwd, rc = encode.encode_both_strands(seq)
        jfwd, jrc = jax_encode.encode_both_strands(seq)
        sketch, m = _sketch(fwd, rc, k, w, s)
        want, want_m = jsk.sketch_from_codes(jfwd, jrc, k, w, s)
        assert m == want_m, name
        assert sketch.dtype == want.dtype == np.uint32
        assert sketch.tobytes() == want.tobytes(), name
        got[name] = (sketch, m)
    assert got["short"][1] == 0
    assert np.all(got["short"][0] == sk.SENTINEL)
    assert got["random"][0].tobytes() == got["rc"][0].tobytes()
    assert got["exact_window"][1] >= 1
    # s-truncation: a smaller s is the prefix of the larger sketch
    if s > 1:
        fwd, rc = encode.encode_both_strands(contigs["long"])
        small, m_small = _sketch(fwd, rc, k, w, s // 2)
        assert small.tobytes() == got["long"][0][:s // 2].tobytes()
        assert m_small == min(got["long"][1], s // 2)


def test_sketch_params_match_jax(monkeypatch):
    for env in ({}, {"AUTOCYCLER_SKETCH_K": "40", "AUTOCYCLER_SKETCH_W": "0",
                     "AUTOCYCLER_SKETCH_S": "-3"},
                {"AUTOCYCLER_SKETCH_K": "2", "AUTOCYCLER_SKETCH_S": "77"},
                {"AUTOCYCLER_SKETCH_K": " 19 ", "AUTOCYCLER_SKETCH_W": ""}):
        for name in SKETCH_KNOBS:
            monkeypatch.delenv(name, raising=False)
        for name, value in env.items():
            monkeypatch.setenv(name, value)
        assert sk.sketch_params() == jsk.sketch_params(), env
    assert sk.SENTINEL == jsk.SENTINEL and sk.MAX_K == jsk.MAX_K


def _compressed_graphs(tmp_path):
    from synthetic import make_assemblies
    asm = make_assemblies(tmp_path, n_assemblies=3, chromosome_len=5000,
                          plasmid_len=700, n_snps=4, seed=21)
    _quiet(jax_compress, asm, tmp_path / "out", 51, threads=1)
    gfa = tmp_path / "out/input_assemblies.gfa"
    return UnitigGraph.from_gfa_file(gfa), JaxGraph.from_gfa_file(gfa)


def test_sketch_matrix_matches_jax_on_a_gfa_loaded_graph(tmp_path):
    (graph, seqs), (jgraph, jseqs) = _compressed_graphs(tmp_path)
    assert all(not s.forward_seq.size for s in seqs)   # rebuilt from paths
    for params in (None, (15, 5, 128)):
        S, valid, ids = sk.sketch_matrix(graph, seqs, params=params,
                                         device="cpu")
        jS, jvalid, jids = jsk.sketch_matrix(jgraph, jseqs, params=params)
        assert S.tobytes() == jS.tobytes()
        assert valid.tobytes() == jvalid.tobytes()
        assert ids == jids
        assert valid.min() > 0


def _grid_rows(n: int = 300, s: int = 96, seed: int = 3) -> np.ndarray:
    """n sorted, sentinel-padded sketch rows with shared values, empty rows,
    full rows, and values near the top of the uint32 range."""
    rng = np.random.default_rng(seed)
    pool = np.unique(np.concatenate([
        rng.integers(0, 4000, size=3000),
        np.array([0, 1, 0xFFFFFFFE, 0xFFFFFFFD])])).astype(np.uint32)
    S = np.full((n, s), sk.SENTINEL, np.uint32)
    for i in range(n):
        if i % 17 == 0:
            continue                                      # empty row
        m = s if i % 5 == 0 else int(rng.integers(1, s + 1))
        S[i, :m] = np.sort(rng.choice(pool, size=m, replace=False))
    S[7] = S[8]                                           # identical rows
    return S


def test_grid_matches_jax_and_host_at_300_rows():
    S = _grid_rows()
    assert S.shape[0] % 64 != 0
    device.reset_counts()
    got = sk.sketch_intersections(S, "cpu")
    host = sk.sketch_intersections_host(S)
    want = jsk._sketch_intersections_jax(S)
    assert got.dtype == host.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, host)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jsk._sketch_intersections_searchsorted(S))
    real = (S != sk.SENTINEL).sum(axis=1)
    np.testing.assert_array_equal(np.diag(got), real)
    assert got[7, 8] == got[8, 7] == real[7]
    assert (got[::17] == 0).all() and (got[:, ::17] == 0).all()
    assert device.dp_summary("cluster_sketch_grid")["each"] == [
        {"n": 300, "s": 96, "lookups": 300 * 300 * 96}]


def test_grid_in_chunks_equals_one_chunk(monkeypatch):
    S = _grid_rows(n=70, s=33, seed=8)
    whole = sk.sketch_intersections(S, "cpu")
    monkeypatch.setattr(sk, "GRID_CHUNK_BYTES", 8 * 70 * 33 * 3)  # 3 targets
    np.testing.assert_array_equal(sk.sketch_intersections(S, "cpu"), whole)
    np.testing.assert_array_equal(whole, sk.sketch_intersections_host(S))


def test_grid_sentinel_and_clamp_edges():
    top = np.uint32(0xFFFFFFFE)
    S = np.array([[1, 5, top], [1, 5, sk.SENTINEL],
                  [7, sk.SENTINEL, sk.SENTINEL], [sk.SENTINEL] * 3],
                 np.uint32)
    got = sk.sketch_intersections(S, "cpu")
    np.testing.assert_array_equal(got, jsk._sketch_intersections_jax(S))
    # row 2's 7 lies above every real value of row 1: no match; row 0's top
    # value against row 1's pad: no match; pads never count
    np.testing.assert_array_equal(got, [[3, 2, 0, 0], [2, 2, 0, 0],
                                        [0, 0, 1, 0], [0, 0, 0, 0]])


def test_containment_to_matrix_bit_identical():
    S = _grid_rows(n=90, s=40, seed=5)
    inter = sk.sketch_intersections_host(S)
    valid = (S != sk.SENTINEL).sum(axis=1).astype(np.int64)
    assert (valid == 0).any()
    got = sk._containment_to_matrix(inter, valid)
    want = jsk._containment_to_matrix(inter, valid)
    assert got.tobytes() == want.tobytes()
    assert sk.sketch_distance_matrix(S, valid, "cpu").tobytes() == \
        jsk.sketch_distance_matrix(S, valid, use_jax=False).tobytes()
    empty = np.flatnonzero(valid == 0)
    assert (got[empty, :][:, valid > 0] == 1.0).all()
    assert (got[empty, empty] == 0.0).all()


@pytest.mark.parametrize("env,n,want", [
    ({"AUTOCYCLER_SKETCH_MIN_CONTIGS": "10"}, 9, "exact"),
    ({"AUTOCYCLER_SKETCH_MIN_CONTIGS": "10"}, 10, "sketch"),
    ({}, 255, "exact"), ({}, 256, "sketch"),
    ({"AUTOCYCLER_SKETCH_MIN_CONTIGS": "x"}, 256, "sketch"),
    *[({"AUTOCYCLER_SKETCH_DISTANCE": raw,
        "AUTOCYCLER_SKETCH_MIN_CONTIGS": "10"}, 3, want)
      for raw, want in (("off", "exact"), ("0", "exact"), ("exact", "exact"),
                        ("on", "sketch"), ("1", "sketch"),
                        ("sketch", "sketch"), ("verify", "verify"),
                        ("auto", "exact"), (" VERIFY ", "verify"))],
])
def test_resolve_distance_mode_matches_jax(monkeypatch, env, n, want):
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    assert cluster_mod.resolve_distance_mode(n) == want
    assert jax_cluster_mod.resolve_distance_mode(n) == want


def make_many_contigs(root, n_assemblies: int = 64, seed: int = 5):
    """n assemblies of a 3,000 bp chromosome and three plasmids of 600,
    1,000 and 1,500 bp: 4 contigs each, 256 for 64 assemblies. Every
    replicon is rotated, the plasmids reverse-complemented in alternate
    assemblies, with one SNP a copy."""
    rng = np.random.default_rng(seed)
    replicons = [random_genome_fast(rng, n) for n in (3000, 600, 1000, 1500)]
    asm = root / "assemblies"
    asm.mkdir(parents=True)
    for i in range(n_assemblies):
        records = []
        for j, replicon in enumerate(replicons):
            seq = rotate(replicon, int(rng.integers(0, len(replicon))))
            if j and i % 2:
                seq = revcomp(seq)
            records.append(f">contig_{j + 1}\n{mutate_fast(rng, seq, 1)}\n")
        (asm / f"assembly_{i + 1}.fasta").write_text("".join(records))
    return asm


@pytest.fixture(scope="module")
def many_contigs(tmp_path_factory):
    root = tmp_path_factory.mktemp("many_contigs")
    asm = make_many_contigs(root)
    _quiet(jax_compress, asm, root / "compressed", 51, threads=1)
    return root / "compressed"


def _clustering_files(root):
    clustering = root / "clustering"
    return {str(p.relative_to(clustering)): p.read_bytes()
            for p in sorted(clustering.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("knob", [None, "on"])
def test_cluster_at_256_contigs_byte_identical_to_jax(tmp_path, monkeypatch,
                                                      many_contigs, knob):
    """The default knob (auto) sketches at 256 contigs, as the forced 'on'
    does; both packages write the same clustering files."""
    if knob is not None:
        monkeypatch.setenv("AUTOCYCLER_SKETCH_DISTANCE", knob)
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    shutil.copytree(many_contigs, jax_dir)
    shutil.copytree(many_contigs, port_dir)
    _quiet(jax_cluster, jax_dir)
    device.reset_counts()
    _quiet(cluster, port_dir, device="cpu")
    assert device.dp_summary("cluster_sketch_grid")["dispatches"] == 1
    want, got = _clustering_files(jax_dir), _clustering_files(port_dir)
    assert sorted(got) == sorted(want)
    assert sum(name.endswith("1_untrimmed.gfa") for name in got) >= 4
    for name in want:
        assert got[name] == want[name], name
    assert got["clustering.tsv"].count(b"\n") == 257
    assert len(list((port_dir / "clustering/qc_pass").iterdir())) == 4


def test_verify_mode_at_256_contigs_matches_jax(tmp_path, monkeypatch,
                                                many_contigs):
    """verify clusters from the exact distances and records the sketch's
    largest error, the same number as the JAX package's record; sketch
    mode's distances differ from the exact ones."""
    gfa = many_contigs / "input_assemblies.gfa"
    graph, seqs = UnitigGraph.from_gfa_file(gfa)
    jgraph, jseqs = JaxGraph.from_gfa_file(gfa)
    monkeypatch.setenv("AUTOCYCLER_SKETCH_DISTANCE", "verify")
    got, record = cluster_mod.compute_distances(graph, seqs, "cpu")
    want, jrecord = jax_cluster_mod.compute_distances(jgraph, jseqs,
                                                      use_jax=False)
    assert record == jrecord
    assert record["mode"] == "verify" and record["sketch_s"] == 1024
    assert 0.0 < record["sketch_max_abs_error"] < 1.0
    assert got == want
    monkeypatch.setenv("AUTOCYCLER_SKETCH_DISTANCE", "exact")
    exact, exact_record = cluster_mod.compute_distances(graph, seqs, "cpu")
    assert exact == got and exact_record == {"mode": "exact",
                                             "sketch_s": 1024}
    monkeypatch.delenv("AUTOCYCLER_SKETCH_DISTANCE")
    sketch, sketch_record = cluster_mod.compute_distances(graph, seqs, "cpu")
    assert sketch_record["mode"] == "sketch"
    assert max(abs(sketch[p] - exact[p]) for p in exact) == \
        record["sketch_max_abs_error"]
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    shutil.copytree(many_contigs, jax_dir)
    shutil.copytree(many_contigs, port_dir)
    monkeypatch.setenv("AUTOCYCLER_SKETCH_DISTANCE", "verify")
    _quiet(jax_cluster, jax_dir)
    _quiet(cluster, port_dir, device="cpu")
    assert _clustering_files(port_dir) == _clustering_files(jax_dir)
