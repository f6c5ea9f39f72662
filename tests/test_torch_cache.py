"""The port's warm-start cache (autocycler_tpu_torch/utils/cache.py) against
the JAX package's: the same cases as tests/test_encode_cache.py, the same
entry names and keys (each package reads what the other wrote), and warm,
cold and JAX compresses writing the same bytes, streamed and in memory, with
no end-repair grouping on a repair hit. A warm sketch-mode cluster writes
the cold one's files."""

import contextlib
import io
import os
from pathlib import Path

import numpy as np
import pytest

from autocycler_tpu.commands.cluster import cluster as jax_cluster
from autocycler_tpu.commands.compress import compress as jax_compress
from autocycler_tpu.utils import cache as jax_cache
from autocycler_tpu_torch.commands import compress as compress_mod
from autocycler_tpu_torch.commands.clean import clean
from autocycler_tpu_torch.commands.cluster import cluster
from autocycler_tpu_torch.commands.compress import compress
from autocycler_tpu_torch.obs import metrics_registry
from autocycler_tpu_torch.ops import sketch
from autocycler_tpu_torch.utils import AutocyclerError
from autocycler_tpu_torch.utils import cache
from autocycler_tpu_torch.utils.knobs import KNOBS as PORT_KNOBS

from synthetic import make_assemblies

KNOBS = ("AUTOCYCLER_CACHE_DIR", "AUTOCYCLER_CACHE_MAX_BYTES",
         "AUTOCYCLER_ENCODE_CACHE", "AUTOCYCLER_STREAM_KMERS",
         "AUTOCYCLER_SKETCH_DISTANCE")
OUTPUTS = ("input_assemblies.gfa", "input_assemblies.yaml")


@pytest.fixture(autouse=True)
def _default_knobs(monkeypatch):
    for name in KNOBS:
        monkeypatch.delenv(name, raising=False)


def _quiet(fn, *args, **kwargs):
    with contextlib.redirect_stderr(io.StringIO()):
        return fn(*args, **kwargs)


def _events(which):
    """{event: count} of the port's cache counters for one cache."""
    reg = metrics_registry.registry()
    return {event: int(reg.value(cache.CACHE_EVENTS, cache=which,
                                 event=event)) for event in ("hit", "miss")}


def _fwd(body: bytes) -> np.ndarray:
    return np.frombuffer(b"." * 25 + body + b"." * 25, np.uint8)


# ---- the JAX package's unit cases, on the port's cache ----

def test_content_hash_change_misses(tmp_path):
    c = cache.EncodeCache(tmp_path / ".cache")
    fwd = _fwd(b"ACGTACGT")
    h1 = cache.content_hash(b">c\nACGTACGT\n")
    c.store_parsed(h1, 51, [("c", fwd, 8)])
    hit = c.load_parsed(h1, 51)
    assert hit is not None and hit[0][0] == "c" and hit[0][2] == 8
    assert np.array_equal(hit[0][1], fwd)
    assert c.load_parsed(cache.content_hash(b">c\nACGTACGA\n"), 51) is None
    assert c.load_parsed(h1, 31) is None


def test_repair_ends_shape_guard(tmp_path):
    c = cache.EncodeCache(tmp_path / ".cache")
    ends = np.ones((3, 2, 50), np.uint8)
    c.store_repair_ends("abc123", 51, ends)
    got = c.load_repair_ends("abc123", 51, 3)
    assert got is not None and np.array_equal(got, ends)
    assert c.load_repair_ends("abc123", 51, 4) is None


def test_sketch_entry_guards(tmp_path):
    c = cache.EncodeCache(tmp_path / ".cache")
    sk = np.arange(8, dtype=np.uint32)
    c.store_sketches(21, 11, 8, [("beef", sk, 5), ("cafe", sk[::-1], 8)])
    got = c.load_sketch("beef", 21, 11, 8)
    assert got is not None and np.array_equal(got[0], sk) and got[1] == 5
    assert c.load_sketch("cafe", 21, 11, 8)[1] == 8
    assert c.load_sketch("beef", 21, 11, 16) is None    # another s


def test_cache_disable_env(tmp_path, monkeypatch):
    monkeypatch.setenv("AUTOCYCLER_ENCODE_CACHE", "0")
    assert cache.open_cache(tmp_path) is None
    monkeypatch.setenv("AUTOCYCLER_ENCODE_CACHE", "1")
    assert cache.open_cache(tmp_path) is not None
    assert cache.open_cache(None) is None


def _store_entry(c, tag, mtime):
    """One parse entry with a controlled mtime (mtime order IS LRU order)."""
    fwd = np.frombuffer(b"." * 50 + b"ACGT" * 250, np.uint8)
    c.store_parsed(tag * 16, 51, [("c", fwd, 1000)])
    path = c._parse_path(tag * 16, 51)
    os.utime(path, (mtime, mtime))
    return path


def test_budget_evicts_lru_keeps_newest(tmp_path):
    c = cache.EncodeCache(tmp_path / ".cache")
    old = _store_entry(c, "a", 1_000)
    mid = _store_entry(c, "b", 2_000)
    new = _store_entry(c, "c", 3_000)
    size = new.stat().st_size
    assert c.enforce_budget(max_bytes=size) == 2
    assert not old.exists() and not mid.exists() and new.exists()
    assert c.enforce_budget(max_bytes=size) == 0
    assert c.enforce_budget(max_bytes=1) == 0     # the newest always stays
    assert new.exists()


def test_budget_hit_refreshes_lru_rank(tmp_path):
    c = cache.EncodeCache(tmp_path / ".cache")
    hot = _store_entry(c, "a", 1_000)
    cold = _store_entry(c, "b", 2_000)
    assert c.load_parsed("a" * 16, 51) is not None
    assert hot.stat().st_mtime > cold.stat().st_mtime
    assert c.enforce_budget(max_bytes=hot.stat().st_size) == 1
    assert hot.exists() and not cold.exists()


@pytest.mark.parametrize("raw,want", [
    (None, PORT_KNOBS["AUTOCYCLER_CACHE_MAX_BYTES"].default), ("12345", 12345),
    ("0", None), ("-1", None), ("junk", PORT_KNOBS["AUTOCYCLER_CACHE_MAX_BYTES"].default)])
def test_cache_max_bytes_env(monkeypatch, raw, want):
    if raw is not None:
        monkeypatch.setenv("AUTOCYCLER_CACHE_MAX_BYTES", raw)
    with contextlib.redirect_stderr(io.StringIO()):
        assert cache.cache_max_bytes() == want
        assert jax_cache.cache_max_bytes() == want


def test_store_enforces_budget(tmp_path, monkeypatch):
    c = cache.EncodeCache(tmp_path / ".cache")
    first = _store_entry(c, "a", 1_000)
    monkeypatch.setenv("AUTOCYCLER_CACHE_MAX_BYTES", str(first.stat().st_size))
    second = _store_entry(c, "b", 2_000)
    assert not first.exists() and second.exists()


def test_budget_eviction_tolerates_racing_evictor(tmp_path, monkeypatch):
    c = cache.EncodeCache(tmp_path / ".cache")
    old = _store_entry(c, "a", 1_000)
    mid = _store_entry(c, "b", 2_000)
    new = _store_entry(c, "c", 3_000)
    real_unlink = Path.unlink

    def racing_unlink(self, *args, **kwargs):
        if self.name == old.name:
            real_unlink(self)
            raise FileNotFoundError(self)
        return real_unlink(self, *args, **kwargs)

    monkeypatch.setattr(Path, "unlink", racing_unlink)
    assert c.enforce_budget(max_bytes=new.stat().st_size) == 1
    assert not old.exists() and not mid.exists() and new.exists()


def test_shared_cache_dir_override(tmp_path, monkeypatch):
    assert cache.shared_cache_dir() is None
    assert cache.open_cache(tmp_path / "job1").dir == \
        tmp_path / "job1" / ".cache"
    monkeypatch.setenv("AUTOCYCLER_CACHE_DIR", str(tmp_path / "shared"))
    assert cache.open_cache(tmp_path / "job1").dir == tmp_path / "shared"
    assert cache.open_cache(tmp_path / "job2").dir == tmp_path / "shared"
    assert cache.open_cache(None).dir == tmp_path / "shared"
    monkeypatch.setenv("AUTOCYCLER_ENCODE_CACHE", "0")
    assert cache.open_cache(tmp_path / "job1") is None


def test_open_cache_sweeps_dead_writer_tmps(tmp_path):
    cache_dir = tmp_path / ".cache"
    cache_dir.mkdir()
    dead = cache_dir / "parse_ab.npz.999999999.x1y2.tmp"
    dead.write_bytes(b"torn")
    live = cache_dir / f"parse_cd.npz.{os.getpid()}.z9z9.tmp"
    live.write_bytes(b"in flight")
    assert cache.open_cache(tmp_path) is not None
    assert not dead.exists() and live.exists()


def test_unreadable_entry_is_a_miss(tmp_path):
    c = cache.EncodeCache(tmp_path / ".cache")
    c.dir.mkdir()
    c._parse_path("ab" * 12, 51).write_bytes(b"not an npz")
    before = _events("parse")
    assert c.load_parsed("ab" * 12, 51) is None
    assert _events("parse")["miss"] == before["miss"] + 1


def test_purge_cache_and_clean(tmp_path):
    autodir = tmp_path / "auto"
    c = cache.EncodeCache(autodir / ".cache")
    _store_entry(c, "a", 1_000)
    _store_entry(c, "b", 2_000)
    keep = autodir / ".cache" / "notes.txt"
    keep.write_text("mine")
    removed, reclaimed = cache.purge_cache(autodir)
    assert removed == 2 and reclaimed > 0 and keep.exists()
    assert cache.purge_cache(autodir) == (0, 0)
    assert cache.purge_cache(tmp_path / "missing") == (0, 0)
    _store_entry(c, "c", 3_000)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        clean(None, None, cache=str(autodir))
    assert list((autodir / ".cache").glob("*.npz")) == []
    assert "Purged warm-start cache" in err.getvalue()
    with pytest.raises(AutocyclerError, match="does not exist"):
        clean(None, None, cache=str(tmp_path / "missing"))
    with pytest.raises(AutocyclerError, match="requires -i and -o"):
        clean(None, str(tmp_path / "out.gfa"))


# ---- each package reads the other's entries ----

@pytest.mark.parametrize("writer", ["jax", "port"])
def test_entries_are_shared_between_packages(tmp_path, writer):
    """One package stores parse, repair and sketch entries; the other
    loads every one of them, equal to what it would compute."""
    store, load = (jax_cache, cache) if writer == "jax" else (cache, jax_cache)
    fwd = _fwd(b"ACGTTGCA" * 4)
    h = store.content_hash(b">c\nACGT\n")
    assert h == load.content_hash(b">c\nACGT\n")
    writer_cache = store.EncodeCache(tmp_path / ".cache")
    writer_cache.store_parsed(h, 51, [("c x", fwd, 32)])
    writer_cache.store_repair_ends(h, 51, np.full((1, 2, 50), 65, np.uint8))
    sk = np.array([1, 2, 3, 2**32 - 1], np.uint32)
    if writer == "jax":
        writer_cache.store_sketch(h, 21, 11, 4, sk, 3)
    else:
        writer_cache.store_sketches(21, 11, 4, [(h, sk, 3)])
    reader = load.EncodeCache(tmp_path / ".cache")
    (header, got, length), = reader.load_parsed(h, 51)
    assert (header, length) == ("c x", 32) and np.array_equal(got, fwd)
    assert reader.load_repair_ends(h, 51, 1).tolist() == [[[65] * 50] * 2]
    sk, m = reader.load_sketch(h, 21, 11, 4)
    assert sk.tolist() == [1, 2, 3, 2**32 - 1] and m == 3


# ---- compress: warm == cold == the JAX package, streamed and in memory ----

@pytest.mark.parametrize("stream", ["off", "on"])
def test_warm_cold_and_jax_compress_write_the_same_bytes(
        tmp_path, monkeypatch, stream):
    asm = make_assemblies(tmp_path, n_assemblies=3, chromosome_len=4000,
                          plasmid_len=700, n_snps=3, seed=5)
    monkeypatch.setenv("AUTOCYCLER_STREAM_KMERS", stream)
    _quiet(jax_compress, asm, tmp_path / "jax", 51, threads=2)
    _quiet(compress, asm, tmp_path / "cold", 51, threads=2, device="cpu")
    before = {w: _events(w) for w in ("parse", "repair")}
    calls = []
    real = compress_mod.sequence_end_repair
    monkeypatch.setattr(compress_mod, "sequence_end_repair",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    for f in asm.iterdir():
        os.utime(f)                      # an mtime-only touch still hits
    _quiet(compress, asm, tmp_path / "cold", 51, threads=2, device="cpu")
    after = {w: _events(w) for w in ("parse", "repair")}
    assert after["parse"]["hit"] - before["parse"]["hit"] == 3
    assert after["repair"]["hit"] - before["repair"]["hit"] == 1
    assert after["parse"]["miss"] == before["parse"]["miss"]
    assert after["repair"]["miss"] == before["repair"]["miss"]
    assert calls == []                   # a repair hit groups nothing
    for name in OUTPUTS:
        want = (tmp_path / "jax" / name).read_bytes()
        assert (tmp_path / "cold" / name).read_bytes() == want, name
    assert sorted(p.name for p in (tmp_path / "cold/.cache").iterdir()) == \
        sorted(p.name for p in (tmp_path / "jax/.cache").iterdir())


def test_repair_hit_patches_both_strands_as_the_repair_did(tmp_path):
    """A repair hit patches the forward strand's ends and the reverse
    strand's swapped ends in place: both strands equal the repaired miss's,
    and the reverse strand stays the forward one's reverse complement."""
    from autocycler_tpu_torch.metrics import InputAssemblyMetrics
    from autocycler_tpu_torch.utils import reverse_complement_bytes
    asm = make_assemblies(tmp_path, n_assemblies=3, chromosome_len=3000,
                          plasmid_len=600, n_snps=3, seed=4)
    c = cache.EncodeCache(tmp_path / ".cache")

    def strands():
        seqs, _ = _quiet(compress_mod.load_sequences, asm, 51,
                         InputAssemblyMetrics(), 1000, threads=1, cache=c,
                         device="cpu")
        return [(s.forward_seq.tobytes(), s.reverse_seq.tobytes())
                for s in seqs]

    before = _events("repair")
    cold = strands()
    warm = strands()
    after = _events("repair")
    assert (after["miss"] - before["miss"], after["hit"] - before["hit"]) \
        == (1, 1)
    assert warm == cold
    for fwd, rev in warm:
        assert rev == reverse_complement_bytes(
            np.frombuffer(fwd, np.uint8)).tobytes()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_compress_warms_from_the_other_package(tmp_path, writer):
    """A compress into a directory the other package compressed into hits
    every parse entry and the repair entry, and writes the same bytes."""
    asm = make_assemblies(tmp_path, n_assemblies=3, chromosome_len=3000,
                          plasmid_len=600, seed=9)
    out = tmp_path / "out"
    if writer == "jax":
        _quiet(jax_compress, asm, out, 51, threads=1)
        before = {w: _events(w) for w in ("parse", "repair")}
        first = {n: (out / n).read_bytes() for n in OUTPUTS}
        _quiet(compress, asm, out, 51, device="cpu")
        after = {w: _events(w) for w in ("parse", "repair")}
    else:
        _quiet(compress, asm, out, 51, device="cpu")
        before = {w: dict(zip(("hit", "miss"), _jax_stats(w)))
                  for w in ("parse", "repair")}
        first = {n: (out / n).read_bytes() for n in OUTPUTS}
        _quiet(jax_compress, asm, out, 51, threads=1)
        after = {w: dict(zip(("hit", "miss"), _jax_stats(w)))
                 for w in ("parse", "repair")}
    assert after["parse"]["hit"] - before["parse"]["hit"] == 3
    assert after["repair"]["hit"] - before["repair"]["hit"] == 1
    assert after["parse"]["miss"] == before["parse"]["miss"]
    assert {n: (out / n).read_bytes() for n in OUTPUTS} == first


def _jax_stats(which):
    stats = jax_cache.cache_stats()
    return stats[f"{which}_hits"], stats[f"{which}_misses"]


def test_cache_stats_view(tmp_path):
    asm = make_assemblies(tmp_path, n_assemblies=2, chromosome_len=3000,
                          plasmid_len=500, seed=4)
    s0 = cache.cache_stats()
    _quiet(compress, asm, tmp_path / "out", 51, device="cpu")
    s1 = cache.cache_stats()
    assert s1["parse_misses"] - s0["parse_misses"] == 2
    assert s1["repair_misses"] - s0["repair_misses"] == 1
    assert s1["parse_hits"] == s0["parse_hits"]


def test_disabled_cache_writes_no_cache_dir(tmp_path, monkeypatch):
    asm = make_assemblies(tmp_path, n_assemblies=2, chromosome_len=3000,
                          plasmid_len=500, seed=4)
    monkeypatch.setenv("AUTOCYCLER_ENCODE_CACHE", "0")
    _quiet(compress, asm, tmp_path / "out", 51, device="cpu")
    assert not (tmp_path / "out/.cache").exists()


def test_shared_cache_dir_serves_a_second_output_dir(tmp_path, monkeypatch):
    asm = make_assemblies(tmp_path, n_assemblies=2, chromosome_len=3000,
                          plasmid_len=500, seed=6)
    monkeypatch.setenv("AUTOCYCLER_CACHE_DIR", str(tmp_path / "shared"))
    _quiet(compress, asm, tmp_path / "a", 51, device="cpu")
    before = _events("repair")
    _quiet(compress, asm, tmp_path / "b", 51, device="cpu")
    assert _events("repair")["hit"] == before["hit"] + 1
    assert not (tmp_path / "a/.cache").exists()
    assert (tmp_path / "a/input_assemblies.gfa").read_bytes() == \
        (tmp_path / "b/input_assemblies.gfa").read_bytes()


# ---- cluster's sketch cache ----

def _all_files(root):
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()
            and ".cache" not in p.parts}


def test_warm_sketch_cluster_writes_the_cold_files(tmp_path, monkeypatch):
    asm = make_assemblies(tmp_path, n_assemblies=3, chromosome_len=3000,
                          plasmid_len=600, seed=12)
    monkeypatch.setenv("AUTOCYCLER_SKETCH_DISTANCE", "on")
    _quiet(compress, asm, tmp_path / "out", 51, device="cpu")
    _quiet(jax_compress, asm, tmp_path / "jax", 51, threads=1)
    _quiet(jax_cluster, tmp_path / "jax")
    before = _events("sketch")
    _quiet(cluster, tmp_path / "out", device="cpu")
    cold = _all_files(tmp_path / "out/clustering")
    mid = _events("sketch")
    assert mid["miss"] - before["miss"] == 6 and mid["hit"] == before["hit"]
    sketched, writes = [], []
    real = sketch.sketch_from_codes
    monkeypatch.setattr(sketch, "sketch_from_codes",
                        lambda *a: sketched.append(1) or real(*a))
    monkeypatch.setattr(cache, "_atomic_write",
                        lambda path, payload: writes.append(path))
    _quiet(cluster, tmp_path / "out", device="cpu")
    assert _events("sketch")["hit"] - mid["hit"] == 6 and sketched == []
    assert writes == []                  # a hit is not stored again
    assert _all_files(tmp_path / "out/clustering") == cold
    assert cold == _all_files(tmp_path / "jax/clustering")
    assert sorted(p.name for p in (tmp_path / "out/.cache").glob("sketch-*")) \
        == sorted(p.name for p in (tmp_path / "jax/.cache").glob("sketch-*"))
