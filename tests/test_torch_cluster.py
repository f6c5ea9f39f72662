"""The port's cluster command against the JAX package's on the CPU: a JAX
compress, then both cluster commands on the same input_assemblies.gfa, must
write byte-identical files under clustering/ (PHYLIP, Newick, TSV, YAML and
every cluster's 1_untrimmed.gfa/.yaml), with automatic and manual clusters.
"""

import contextlib
import io
import re
import shutil

import numpy as np
import pytest

from autocycler_tpu.commands.cluster import cluster as jax_cluster
from autocycler_tpu.commands.compress import compress as jax_compress
from autocycler_tpu.ops import distance as jdist
from autocycler_tpu_torch.commands.cluster import cluster
from autocycler_tpu_torch.models import UnitigGraph
from autocycler_tpu_torch.ops import distance as dist
from autocycler_tpu_torch.utils import AutocyclerError

from synthetic import make_assemblies


def _quiet(fn, *args, **kwargs):
    with contextlib.redirect_stderr(io.StringIO()):
        return fn(*args, **kwargs)


def _files(root):
    return {p.relative_to(root): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def _compressed(tmp_path, **kwargs):
    asm = make_assemblies(tmp_path, **kwargs)
    _quiet(jax_compress, asm, tmp_path / "jax", 51, threads=1)
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    return tmp_path / "jax", tmp_path / "port"


def _same_clustering(jax_dir, port_dir):
    want = _files(jax_dir / "clustering")
    got = _files(port_dir / "clustering")
    assert sorted(got) == sorted(want)
    assert any(p.name == "1_untrimmed.gfa" for p in want)
    for name in want:
        assert got[name] == want[name], name


@pytest.mark.parametrize("seed,n_snps,n_asm", [(42, 0, 4), (13, 5, 5),
                                               (7, 20, 3)])
def test_cluster_byte_identical_to_jax(tmp_path, seed, n_snps, n_asm):
    jax_dir, port_dir = _compressed(tmp_path, seed=seed, n_snps=n_snps,
                                    n_assemblies=n_asm)
    _quiet(jax_cluster, jax_dir)
    _quiet(cluster, port_dir, device="cpu")
    _same_clustering(jax_dir, port_dir)
    assert len(list((port_dir / "clustering/qc_pass").iterdir())) == 2


@pytest.mark.parametrize("options", [dict(cutoff=0.05, min_assemblies=3),
                                     dict(min_assemblies=5)])
def test_cluster_options_byte_identical_to_jax(tmp_path, options):
    jax_dir, port_dir = _compressed(tmp_path, seed=3, n_snps=3)
    _quiet(jax_cluster, jax_dir, **options)
    _quiet(cluster, port_dir, device="cpu", **options)
    _same_clustering(jax_dir, port_dir)


def test_manual_clusters_byte_identical_to_jax(tmp_path):
    jax_dir, port_dir = _compressed(tmp_path, seed=42)
    _quiet(jax_cluster, jax_dir)
    newick = (jax_dir / "clustering/clustering.newick").read_text()
    depth_of = {}                   # internal node id -> nesting depth
    depth = 0
    for m in re.finditer(r"\(|\)(\d+)", newick):
        if m.group(0) == "(":
            depth += 1
        else:
            depth_of[int(m.group(1))] = depth
            depth -= 1
    root = max(depth_of)
    a, b = sorted(n for n, d in depth_of.items() if d == depth_of[root] + 1)
    # the root's two children (chromosomes, plasmids), then one of them
    # alone (the rest fails QC as "not included in manual clusters")
    for manual in (f"{a},{b}", f"{b}"):
        _quiet(jax_cluster, jax_dir, manual=manual)
        _quiet(cluster, port_dir, manual=manual, device="cpu")
        _same_clustering(jax_dir, port_dir)
    with pytest.raises(AutocyclerError, match="cannot be nested"):
        _quiet(cluster, port_dir, manual=f"{root},{a}", device="cpu")


def test_distances_match_jax(tmp_path):
    jax_dir, _ = _compressed(tmp_path, seed=13, n_snps=5)
    graph, sequences = UnitigGraph.from_gfa_file(
        jax_dir / "input_assemblies.gfa")
    M, w, ids = dist.membership_matrix(graph, sequences)
    jM, jw, jids = jdist.membership_matrix(graph, sequences)
    np.testing.assert_array_equal(M, jM)
    np.testing.assert_array_equal(w, jw)
    assert ids == jids
    inter = dist.intersections(M, w, device="cpu")
    np.testing.assert_array_equal(
        inter, (M.astype(np.int64) * w) @ M.T.astype(np.int64))
    D = dist._intersections_to_matrix(inter)
    want = jdist.pairwise_distance_matrix(M, w, use_jax=False)
    assert D.tobytes() == want.tobytes()           # bit-identical floats
    assert dist.pairwise_contig_distances(graph, sequences, device="cpu") == \
        jdist.pairwise_contig_distances(graph, sequences, use_jax=False)
    assert dist.intersections_to_distances(inter, ids) == \
        jdist.intersections_to_distances(inter, ids)


def test_float64_contraction_bound_is_asserted():
    M = np.ones((2, 2), np.uint8)
    w = np.array([2**52, 2**52], np.int64)
    with pytest.raises(ValueError, match="2\\*\\*53"):
        dist.intersections(M, w, device="cpu")
    w = np.array([2**52 - 1, 2**52], np.int64)      # just below: exact
    D = dist._intersections_to_matrix(dist.intersections(M, w, device="cpu"))
    assert D.tobytes() == jdist.pairwise_distance_matrix(
        M, w, use_jax=False).tobytes()


@pytest.mark.parametrize("kwargs,message", [
    (dict(cutoff=0.0), "--cutoff must be between 0 and 1 (exclusive)"),
    (dict(cutoff=1.5), "--cutoff must be between 0 and 1 (exclusive)"),
    (dict(min_assemblies=0), "--min_assemblies must be 1 or greater"),
    (dict(manual="1,x"), "failed to parse 'x' as a node number"),
])
def test_flag_errors_match_jax(tmp_path, kwargs, message):
    from autocycler_tpu.utils import AutocyclerError as JaxError
    jax_dir, port_dir = _compressed(tmp_path, seed=5)
    with pytest.raises(AutocyclerError) as got:
        _quiet(cluster, port_dir, device="cpu", **kwargs)
    with pytest.raises(JaxError) as want:
        _quiet(jax_cluster, jax_dir, **kwargs)
    assert str(got.value) == str(want.value) == message


def test_missing_inputs_match_jax(tmp_path):
    from autocycler_tpu.utils import AutocyclerError as JaxError
    (tmp_path / "empty").mkdir()
    for path in (tmp_path / "missing", tmp_path / "empty"):
        with pytest.raises(AutocyclerError) as got:
            cluster(path, device="cpu")
        with pytest.raises(JaxError) as want:
            jax_cluster(path)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("env", [
    {"AUTOCYCLER_SKETCH_DISTANCE": "on"},
    {"AUTOCYCLER_SKETCH_DISTANCE": "verify"},
    {"AUTOCYCLER_SKETCH_MIN_CONTIGS": "4"},          # auto resolves to sketch
])
def test_sketch_mode_is_refused_not_replaced(tmp_path, monkeypatch, env):
    """The sketch modes run the sketch distances, not the exact ones in
    their place: the files equal the JAX package's under the same knobs,
    and the PHYLIP matrix differs from the exact mode's except in verify,
    which clusters from the exact distances. The port once refused these
    modes; the refusal was removed when sketch distances were ported, and
    the test keeps its name."""
    from autocycler_tpu_torch import device
    jax_dir, port_dir = _compressed(tmp_path, seed=5)
    shutil.copytree(port_dir, tmp_path / "exact")
    monkeypatch.setenv("AUTOCYCLER_SKETCH_DISTANCE", "exact")
    _quiet(cluster, tmp_path / "exact", device="cpu")
    monkeypatch.delenv("AUTOCYCLER_SKETCH_DISTANCE")
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    _quiet(jax_cluster, jax_dir)
    device.reset_counts()
    _quiet(cluster, port_dir, device="cpu")
    _same_clustering(jax_dir, port_dir)
    assert device.dp_summary("cluster_sketch_grid")["dispatches"] == 1
    phylip = "clustering/pairwise_distances.phylip"
    same = (port_dir / phylip).read_bytes() == \
        (tmp_path / "exact" / phylip).read_bytes()
    assert same == (env.get("AUTOCYCLER_SKETCH_DISTANCE") == "verify")


@pytest.mark.parametrize("raw", ["off", "exact", ""])
def test_exact_mode_spellings_run(tmp_path, monkeypatch, raw):
    jax_dir, port_dir = _compressed(tmp_path, seed=9)
    monkeypatch.setenv("AUTOCYCLER_SKETCH_DISTANCE", raw)
    monkeypatch.setenv("AUTOCYCLER_SKETCH_MIN_CONTIGS", "1000")
    _quiet(jax_cluster, jax_dir)
    _quiet(cluster, port_dir, device="cpu")
    _same_clustering(jax_dir, port_dir)


def test_cluster_metrics_yaml_matches_jax(tmp_path):
    from autocycler_tpu import metrics as jm
    from autocycler_tpu_torch import metrics as pm
    got = pm.ClusteringMetrics(pass_contig_count=3, fail_contig_count=1)
    want = jm.ClusteringMetrics(pass_contig_count=3, fail_contig_count=1)
    names = {1: ["a", "b"], 2: ["a", "a", "b"]}
    stats = [(0.01, 2), (0.2, 3)]
    for m in (got, want):
        m.calculate_fractions()
        m.calculate_scores(names, stats)
    got.save_to_yaml(tmp_path / "p.yaml")
    want.save_to_yaml(tmp_path / "j.yaml")
    assert (tmp_path / "p.yaml").read_bytes() == (tmp_path / "j.yaml").read_bytes()
    pm.UntrimmedClusterMetrics.new([5, 7, 9], 0.125).save_to_yaml(tmp_path / "u.yaml")
    jm.UntrimmedClusterMetrics.new([5, 7, 9], 0.125).save_to_yaml(tmp_path / "v.yaml")
    assert (tmp_path / "u.yaml").read_bytes() == (tmp_path / "v.yaml").read_bytes()
