"""The frozen generator against the repository's synthetic generator, and
the traffic drawn from it."""

import sys

import numpy as np

from benchmark.gen import synthetic, traffic as traffic_gen
from benchmark.lib import spec

sys.path.insert(0, str(spec.ROOT / "tests"))


def test_byte_equal_to_the_test_generator(tmp_path):
    import synthetic as original

    asm = original.make_assemblies_fast(tmp_path, n_assemblies=4, chromosome_len=30_000,
                                        plasmid_len=3_000, n_snps=7, seed=7)
    files = synthetic.make_assemblies_fast(np.random.default_rng(7), 4, 30_000, 3_000, 7)
    assert [name for name, _ in files] == sorted(p.name for p in asm.iterdir())
    for name, records in files:
        assert (asm / name).read_text() == synthetic.fasta_text(records)


def test_no_plasmid_writes_no_record(tmp_path):
    files = synthetic.make_assemblies_fast(np.random.default_rng(3), 4, 10_000, 0, 5)
    synthetic.write_isolate(files, tmp_path)
    for f in tmp_path.iterdir():
        text = f.read_text()
        assert text.count(">") == 1 and "\n\n" not in text


def test_isolates_are_drawn_from_the_seed_and_index():
    shape = dict(n_assemblies=2, chromosome_len=5_000, plasmid_len=500, n_snps=3)
    a = traffic_gen.isolate(shape, {}, 2**40 + 1, 0)
    assert a == traffic_gen.isolate(shape, {}, 2**40 + 1, 0)
    assert a != traffic_gen.isolate(shape, {}, 2**40 + 1, 1)
    assert a != traffic_gen.isolate(shape, {}, 2**40 + 2, 0)
    assert traffic_gen.isolate(shape, {}, -1, 0)


def test_overlap_traffic_appends_each_contigs_start():
    shape = dict(n_assemblies=3, chromosome_len=20_000, plasmid_len=4_000, n_snps=3)
    traffic = {"overlap": {"chromosome": [200, 2000], "plasmid": [50, 500]}}
    clean = traffic_gen.isolate(shape, {}, 9, 0)
    grown = traffic_gen.isolate(shape, traffic, 9, 0)
    for (_, before), (_, after) in zip(clean, grown):
        for (h0, s0), (h1, s1), (lo, hi) in zip(before, after, [(200, 2000), (50, 500)]):
            extra = len(s1) - len(s0)
            assert h0 == h1 and s1.startswith(s0) and lo <= extra <= hi
            assert s1[len(s0):] == s0[:extra]


def test_every_seed_gives_the_same_sizes():
    cell = spec.cell(spec.load_benchmark(), "ecoli4.clean")
    config = traffic_gen.scaled(cell["config"], 50)
    lengths = {tuple(len(s) for _, recs in traffic_gen.isolate(config, {}, seed, 0)
                     for _, s in recs) for seed in (1, 2, 3)}
    assert len(lengths) == 1
