"""The comparison sees a broken timed path: each fault a cell can have is
planted in the program underneath a tiny CPU run, and ``correct`` comes out
false, by the number that should catch it. (The cells run on one chip, so
the fault of a left-out exchange between chips cannot occur.)"""

import shutil

import pytest
import torch

from .helpers import dry_run


def _failed_by(line, name):
    assert line["correct"] is False
    assert line["check"][name]["value"] > line["check"][name]["limit"], line["check"]


def _split_group_and_its_partner(codes, order, gid, starts, k):
    """``gid`` with the group at the middle of the sorted windows split in
    two halves, and the group of its reverse complement too, each half of
    the copies in the same sequences on both strands: the split that leaves
    the graph lossless over valid links. None where that group's partner is
    not among these windows."""
    def run(pos):
        same = (gid == gid[pos]).nonzero().flatten()
        return int(same[0]), int(same[-1]) + 1

    a, b = run(len(gid) // 2)
    window = codes[int(starts[order[a]]):int(starts[order[a]]) + k]
    partner = torch.where(window == 0, window, 5 - window).flip(0)
    hits = [j for j in range(len(order)) if torch.equal(
        codes[int(starts[order[j]]):int(starts[order[j]]) + k], partner)]
    if b - a < 2 or not hits:
        return None
    a2, b2 = run(hits[0])
    gid = gid.clone()
    for lo, hi in sorted([(a, b), (a2, b2)], reverse=True):
        gid[(lo + hi) // 2:] += 1
    return gid


def test_grouping_that_splits_a_group_of_equal_kmers(monkeypatch):
    # the grouping kernel's typical fault, planted in the window's isolates:
    # equal k-mers given two ids. A split that breaks the pairing of the two
    # strands stops the program (a failure); this one does not, and the
    # graph stays lossless over valid links, with a twin segment in it
    from autocycler_tpu_torch.ops import kmers

    from benchmark.lib import window

    real, real_window = kmers.pack_rank, window._window

    def split(codes, starts, k):
        order, gid = real(codes, starts, k)
        if k == 51:
            gid = _split_group_and_its_partner(codes, order, gid, starts, k)
            assert gid is not None
        return order, gid

    def planted(*a, **k):
        monkeypatch.setattr(kmers, "pack_rank", split)
        return real_window(*a, **k)

    monkeypatch.setattr(window, "_window", planted)
    _, line, err = dry_run("ecoli4.clean", seed=30)
    assert "the window failed" not in err
    _failed_by(line, "graph_twin_segments")
    assert line["check"]["graph_contigs_not_spelled"]["value"] == 0
    assert line["check"]["graph_link_faults"]["value"] == 0


def test_trim_that_cuts_what_is_no_overlap(monkeypatch):
    # clean traffic has no start-end overlap: a trim that finds one anyway
    # and cuts each path's last unitig
    from autocycler_tpu_torch.commands import trim

    def cut(sequences, weights, max_unitigs, paths, *a, **k):
        return [(paths[s.id][:-1], sum(weights[abs(u)] for u in paths[s.id][:-1]))
                for s in sequences]

    monkeypatch.setattr(trim, "trim_start_end_overlap", cut)
    _, line, _ = dry_run("ecoli4.clean", seed=31)
    _failed_by(line, "trim_contigs_wrong")


def test_a_stream_that_fails_and_degrades_to_the_in_memory_grouping(monkeypatch):
    # the isolate still comes out right, but off the path its cell measures
    import autocycler_tpu_torch.stream as stream
    from autocycler_tpu_torch.utils.resilience import SpillError

    def fail(*a, **k):
        raise SpillError("planted spill failure")

    monkeypatch.setattr(stream, "stream_group_windows_stats", fail)
    _, line, err = dry_run("kleb24.clean", seed=35)
    _failed_by(line, "isolates_degraded")
    _failed_by(line, "isolates_off_path")
    assert line["failed"] >= 1 and "planted spill failure" in err


@pytest.mark.parametrize("workload", ["ecoli4.clean", "kleb24.clean"])
def test_resolve_that_leaves_its_state_unchanged(monkeypatch, workload):
    from autocycler_tpu_torch.commands import resolve

    real = resolve.resolve

    def unresolved(cluster_dir, *a, **k):
        real(cluster_dir, *a, **k)
        shutil.copyfile(cluster_dir / "2_trimmed.gfa", cluster_dir / "5_final.gfa")

    monkeypatch.setattr(resolve, "resolve", unresolved)
    _, line, _ = dry_run(workload, seed=32)
    _failed_by(line, "consensus_replicon_faults")


def test_half_of_the_assemblies_left_out(monkeypatch):
    from autocycler_tpu_torch.commands import compress

    real = compress.find_all_assemblies
    monkeypatch.setattr(compress, "find_all_assemblies",
                        lambda d: real(d)[:len(real(d)) // 2])
    _, line, _ = dry_run("ecoli4.clean", seed=33)
    _failed_by(line, "graph_contigs_not_spelled")


@pytest.mark.parametrize("workload", ["ecoli4.clean", "kleb24.clean"])
def test_one_consensus_base_altered_where_it_is_written(monkeypatch, workload):
    from autocycler_tpu_torch.commands import combine

    real = combine.combine_clusters

    def altered(in_gfas, combined_gfa, combined_fasta, metrics):
        real(in_gfas, combined_gfa, combined_fasta, metrics)
        lines = open(combined_fasta).read().split("\n")
        seq = lines[1]
        i = len(seq) // 3
        lines[1] = seq[:i] + {"A": "C", "C": "G", "G": "T", "T": "A"}[seq[i]] + seq[i + 1:]
        open(combined_fasta, "w").write("\n".join(lines))

    monkeypatch.setattr(combine, "combine_clusters", altered)
    _, line, _ = dry_run(workload, seed=34)
    _failed_by(line, "consensus_minority_sites")


# ---- the plasmid-rich configuration's path and faults (264 contigs) ----

def test_the_path_check_reads_each_isolates_substages():
    from benchmark.lib import instrument, window

    def isolate(*substages, bins=3):
        rec = instrument.Isolate()
        rec.substages = {name: 0.1 for name in substages}
        rec.stream = {"bins": bins}
        return rec

    product, sketched = "cluster-distance-product", "cluster-sketch-distances"
    assert not window.off_path(isolate(product), True, "exact")
    assert not window.off_path(isolate(sketched), True, "sketch")
    assert window.off_path(isolate(sketched), True, "exact")
    assert window.off_path(isolate(product), True, "sketch")
    # verify mode runs both; a cluster that ran neither ran no path
    assert window.off_path(isolate(product, sketched), True, "sketch")
    assert window.off_path(isolate(product, sketched), True, "exact")
    assert window.off_path(isolate(), True, "exact")
    assert window.off_path(isolate(product, bins=0), True, "exact")
    assert not window.off_path(isolate(product, bins=0), False, "exact")
    assert window.distance_path({}) == "exact"
    assert window.distance_path({"distance": "sketch"}) == "sketch"
    with pytest.raises(ValueError):
        window.distance_path({"distance": "approximate"})


def test_a_sketch_configuration_forced_to_exact_distances():
    from .helpers import PLASMID_RICH, config_run

    forced = dict(PLASMID_RICH, env={"AUTOCYCLER_SKETCH_DISTANCE": "off"})
    line, record = config_run(forced, seed=36)
    _failed_by(line, "isolates_off_path")
    assert line["check"]["isolates_off_path"]["value"] == len(record["isolates"]) >= 1
    assert line["failed"] == len(record["isolates"])
    for r in record["isolates"]:
        assert "cluster-distance-product" in r["substages"]


def test_two_plasmid_clusters_merged(monkeypatch):
    # cluster's distances between the copies of two plasmids planted as
    # near as those within one, and the refinement that would split a
    # cluster with two contigs an assembly left out: both plasmids end in
    # one cluster
    from autocycler_tpu_torch.commands import cluster

    from .helpers import PLASMID_RICH, config_run

    real = cluster.compute_distances

    def merged(graph, sequences, *a, **k):
        dist, rec = real(graph, sequences, *a, **k)
        pair = [s.id for s in sequences
                if s.contig_name().startswith(("plasmid_1_", "plasmid_2_"))]
        for a_ in pair:
            for b in pair:
                dist[(a_, b)] = min(dist[(a_, b)], 0.05)
        return dist, rec

    monkeypatch.setattr(cluster, "compute_distances", merged)
    monkeypatch.setattr(cluster, "refine_auto_clusters",
                        lambda tree, sequences, distances, clusters, *a: clusters)
    line, record = config_run(PLASMID_RICH, seed=37)
    _failed_by(line, "cluster_contigs_misplaced")
    assert [r["qc_pass_clusters"] for r in record["isolates"]] == \
        [10] * len(record["isolates"])


def test_one_plasmid_consensus_base_altered(monkeypatch):
    # the shortest record of the consensus is a plasmid of 2 kb with SNPs
    from autocycler_tpu_torch.commands import combine

    from .helpers import PLASMID_RICH, config_run

    real = combine.combine_clusters

    def altered(in_gfas, combined_gfa, combined_fasta, metrics):
        real(in_gfas, combined_gfa, combined_fasta, metrics)
        lines = open(combined_fasta).read().split("\n")
        i = min(range(1, len(lines), 2), key=lambda j: len(lines[j]) or 1 << 60)
        seq = lines[i]
        j = len(seq) // 3
        lines[i] = seq[:j] + {"A": "C", "C": "G", "G": "T", "T": "A"}[seq[j]] + seq[j + 1:]
        open(combined_fasta, "w").write("\n".join(lines))

    monkeypatch.setattr(combine, "combine_clusters", altered)
    line, _ = config_run(PLASMID_RICH, seed=38)
    _failed_by(line, "consensus_minority_sites")
    assert line["check"]["consensus_replicon_faults"]["value"] == 0


def test_the_reference_finds_eleven_replicons_with_plasmid_snps():
    # the check alone, on the inputs: one replicon per chromosome or
    # plasmid, each holding its 24 copies, and a consensus of each
    # replicon's most common bases reads no minority site where one altered
    # base reads one
    from benchmark.gen import traffic as traffic_gen
    from benchmark.reference import check

    from .helpers import PLASMID_RICH

    config = traffic_gen.scaled(PLASMID_RICH, PLASMID_RICH["cpu_scale"])
    files = traffic_gen.isolate(config, {}, 39, 0)
    inputs = {(name, header): seq for name, records in files for header, seq in records}
    groups = check.replicons_tallied(inputs, config["k"])
    assert len(groups) == 11
    for g in groups:
        kinds = {header.rsplit("_", 1)[0] for _, header in g.members}
        assert len(g.members) == 24 and len(kinds) == 1
        assert len(g.regions) >= 1      # every replicon carries SNPs
        assert g.minority_sites(g.majority) == 0
        j = next(i for i in range(len(g.majority)) if not g.variable[i])
        flipped = g.majority[:j] + "ACGT"[("ACGT".index(g.majority[j]) + 1) % 4] \
            + g.majority[j + 1:]
        assert g.minority_sites(check.revcomp(flipped)) == 1
