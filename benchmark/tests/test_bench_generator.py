"""The frozen generator against the repository's synthetic generator, and
the traffic drawn from it."""

import hashlib
import json
import sys

import numpy as np
import pytest

from benchmark.gen import synthetic, traffic as traffic_gen
from benchmark.lib import spec

sys.path.insert(0, str(spec.ROOT / "tests"))


def test_byte_equal_to_the_test_generator(tmp_path):
    import synthetic as original

    asm = original.make_assemblies_fast(tmp_path, n_assemblies=4, chromosome_len=30_000,
                                        plasmid_len=3_000, n_snps=7, seed=7)
    files = synthetic.make_isolate(np.random.default_rng(7), 4, 30_000, [3_000], 7)
    assert [name for name, _ in files] == sorted(p.name for p in asm.iterdir())
    for name, records in files:
        assert (asm / name).read_text() == synthetic.fasta_text(records)


def test_no_plasmid_writes_no_record(tmp_path):
    files = synthetic.make_isolate(np.random.default_rng(3), 4, 10_000, [], 5)
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


def _unflipped(records, i):
    """The plasmids of assembly ``i`` (from 0) on the strand of assembly 0."""
    return [synthetic.revcomp(s) if i % 2 else s for _, s in records[1:]]


def _is_rotation(got, want):
    return len(got) == len(want) and got in want + want


def test_a_plasmid_list_draws_each_plasmid_in_every_assembly():
    lens = [2_500, 4_000, 700, 9_000]
    files = synthetic.make_isolate(np.random.default_rng(11), 6, 20_000, lens, 5)
    first = _unflipped(files[0][1], 0)
    assert [len(s) for s in first] == lens
    starts = [set() for _ in lens]
    for i, (name, records) in enumerate(files):
        headers = [h for h, _ in records]
        assert name == f"assembly_{i + 1}.fasta"
        assert headers == [f"chromosome_{i + 1}"] + [f"plasmid_{j}_{i + 1}"
                                                     for j in range(1, len(lens) + 1)]
        for j, (got, want) in enumerate(zip(_unflipped(records, i), first)):
            assert _is_rotation(got, want)
            # the reverse complement is another sequence: the flip is real
            assert not _is_rotation(synthetic.revcomp(got), want)
            starts[j].add((want + want).index(got))
    # each plasmid starts somewhere else in (nearly) every assembly
    assert all(len(s) >= len(files) - 1 for s in starts)


def test_a_one_element_list_is_the_scalar():
    scalar = dict(n_assemblies=3, chromosome_len=8_000, plasmid_len=900, n_snps=4)
    listed = dict(scalar, plasmid_lens=[900], plasmid_snps_per_mbp=0)
    del listed["plasmid_len"]
    for seed, index in ((5, 0), (2**33, 2), (2**40 + 3, 1)):
        assert traffic_gen.isolate(listed, {}, seed, index) == \
            traffic_gen.isolate(scalar, {}, seed, index)


def test_plasmid_snps_are_placed_on_each_plasmid():
    # one assembly: with and without the rate, every draw before the SNPs
    # is the same, so the copies differ only at the SNPs
    lens = [2_500, 10_000, 30_000]
    plain = synthetic.make_isolate(np.random.default_rng(4), 1, 50_000, lens, 3)
    snpped = synthetic.make_isolate(np.random.default_rng(4), 1, 50_000, lens, 3, 400)
    (_, a), = plain
    (_, b), = snpped
    assert a[0] == b[0]
    for (_, p), (_, q), n in zip(a[1:], b[1:], lens):
        diffs = sum(x != y for x, y in zip(p, q))
        assert diffs == synthetic.plasmid_snps(n, 400) == max(1, round(n * 400 / 1e6))
    assert synthetic.plasmid_snps(2_500, 0) == 0


def test_a_shape_gives_one_plasmid_key():
    shape = dict(n_assemblies=2, chromosome_len=5_000, n_snps=1)
    for bad in ({}, {"plasmid_len": 10, "plasmid_lens": [10]},
                {"plasmid_lens": [0]}, {"plasmid_lens": [500.5]}):
        with pytest.raises(ValueError):
            traffic_gen.isolate(dict(shape, **bad), {}, 1, 0)


def test_scaled_keeps_the_plasmid_floor():
    from .helpers import PLASMID_RICH

    out = traffic_gen.scaled(PLASMID_RICH, 50)
    assert out["plasmid_lens"] == [2_000] * 7 + [2_200, 3_600, 5_000]
    assert out["chromosome_len"] == 106_000 and out["n_snps"] == 10
    assert out["plasmid_snps_per_mbp"] == PLASMID_RICH["plasmid_snps_per_mbp"]
    assert out["warmup"]["plasmid_lens"] == [2_000] * 10
    # a plasmid already under the floor keeps its length
    assert traffic_gen.scaled(dict(PLASMID_RICH, plasmid_lens=[1_500, 900]),
                              10)["plasmid_lens"] == [1_500, 900]
    # the configuration's own env is kept beside the stream's
    env = traffic_gen.scaled(dict(PLASMID_RICH, env={"A": "1"}), 50)["env"]
    assert env == {"A": "1", "AUTOCYCLER_STREAM_KMERS": "on"}
    # the scalar comes out as a list of one, under the same floor; none
    # where it is 0
    kleb = spec.cell(spec.load_benchmark(), "kleb24.clean")["config"]
    small = traffic_gen.scaled(kleb, 40)
    assert "plasmid_len" not in small and small["plasmid_lens"] == [3_000]
    assert small["warmup"]["plasmid_lens"] == [2_000]
    ecoli = spec.cell(spec.load_benchmark(), "ecoli4.clean")["config"]
    assert traffic_gen.scaled(ecoli, 20)["plasmid_lens"] == []


def test_overlaps_on_every_plasmid():
    files = synthetic.make_isolate(np.random.default_rng(2), 2, 9_000, [1_000, 1_500], 2)
    grown = synthetic.append_start_overlaps(files, np.random.default_rng(3), (300, 400),
                                            (20, 40))
    for (_, before), (_, after) in zip(files, grown):
        assert len(after) == 3
        for j, ((_, s0), (_, s1)) in enumerate(zip(before, after)):
            lo, hi = (300, 400) if j == 0 else (20, 40)
            assert lo <= len(s1) - len(s0) <= hi and s1 == s0 + s0[:len(s1) - len(s0)]


def _digest(files):
    h = hashlib.sha256()
    for name, records in files:
        h.update(name.encode() + b"\n")
        h.update(synthetic.fasta_text(records).encode())
    return h.hexdigest()


# computed from the generator of the parent tree, before it took plasmid
# lists: the existing configurations' isolate 0 and warm-up isolate at
# their own size, which the generator may not change
PINS = [
    ("kleb-24x6M", 7, "81b5e72d9e63019f1cac62fc30425ee237a7a74490c7cd2f3a26e26ea40bcee4",
     "af40a33858c95ad90dd614755f6cef5f7ed8de3abddd01b4222c17bee959856b"),
    ("kleb-24x6M", 3418100021, "dab71965386fd6b366ea65f734e4791d32fcf316b3624b0bd20c71649ae733bd",
     "129fff2698bf48df19e52f571682a44ece1b7e7b74fecc0a4b60e2230e41141a"),
    ("ecoli-4x4.6M", 7, "2bc0e368b7baddc6c7ccf430bd86e476f03f7441d1d592030eb74278c6a4f683",
     "58bdb11ef9c0f57b8571944fe87b23c9ce9d8f659533fbdc1891469788ab5fd1"),
    ("ecoli-4x4.6M", 3418100021, "eeb34757da50ce8e6997754f13a92699020b6558d7f4ebc79040ce5af2a8fc56",
     "b501e7c2516fdaa40fc56932ac0caa0e395be4a3d8f70c067e8f612e7afc7c85"),
]


@pytest.mark.parametrize("name,seed,isolate0,warmup", PINS,
                         ids=[f"{p[0]}-{p[1]}" for p in PINS])
def test_the_existing_configurations_keep_their_bytes(name, seed, isolate0, warmup):
    bench = spec.load_benchmark()
    entry = next(c for c in bench["configs"] if c["name"] == name)
    config = json.loads((spec.ROOT / entry["file"]).read_text())
    clean = json.loads((spec.BENCH_DIR / "traffic" / "clean.json").read_text())
    assert _digest(traffic_gen.isolate(config, clean, seed, 0)) == isolate0
    assert _digest(traffic_gen.warmup_isolate(config, clean, seed)) == warmup
