"""The port's streamed k-mer grouping (autocycler_tpu_torch/stream/) against
the JAX package's (autocycler_tpu/stream/) and against the in-memory
grouping, on the CPU, with tolerance 0: the plan and the dispatch, the RLE
codec and the bin reader's verdicts, the bin files (byte for byte at the
same plan, formats 1 and 2, pipelined and synchronous), the grouping's
(gid, order, depth, first_occ), the merge's duplicate guard, visible
degrades on a spill that cannot be trusted (and none on a device error),
and a streamed compress whose files and output tree equal the JAX
package's streamed compress and the port's in-memory compress."""

import contextlib
import dataclasses
import io
import json

import numpy as np
import pytest
import torch

from autocycler_tpu import stream as jst
from autocycler_tpu.commands.compress import compress as jax_compress
from autocycler_tpu.models.sequence import Sequence as JaxSequence
from autocycler_tpu.ops import kmers as jax_kmers
from autocycler_tpu.stream import spill as jax_spill
from autocycler_tpu.utils import resilience as jax_rz
from autocycler_tpu_torch import stream as st
from autocycler_tpu_torch.commands.compress import compress
from autocycler_tpu_torch.models import Sequence
from autocycler_tpu_torch.obs import metrics_registry
from autocycler_tpu_torch.ops import kmers
from autocycler_tpu_torch.stream import binner as binner_mod
from autocycler_tpu_torch.stream import driver, spill
from autocycler_tpu_torch.stream.binner import StreamBinner
from autocycler_tpu_torch.utils import resilience as rz
from autocycler_tpu_torch.utils import timing

from synthetic import make_assemblies

K = 15

KNOBS = ("AUTOCYCLER_STREAM_KMERS", "AUTOCYCLER_STREAM_MEM_MB",
         "AUTOCYCLER_STREAM_AUTO_WINDOWS", "AUTOCYCLER_STREAM_BINS",
         "AUTOCYCLER_STREAM_CHUNK", "AUTOCYCLER_STREAM_SIG_K",
         "AUTOCYCLER_STREAM_RLE", "AUTOCYCLER_STREAM_PIPELINE",
         "AUTOCYCLER_STREAM_FLUSH", "AUTOCYCLER_GROUPING_EXECUTOR",
         "AUTOCYCLER_FAULTS", "AUTOCYCLER_CACHE_DIR")


def _reset():
    st.set_stream_root(None)
    jst.set_stream_root(None)
    rz.reset_degrades()
    jax_rz._reset_degrades_for_tests()
    spill.reset_last_run()
    metrics_registry.reset()


def _metric(name):
    """The port registry's value of one stream family."""
    return metrics_registry.registry().value(name)


@pytest.fixture(autouse=True)
def _clean_stream_state(monkeypatch):
    """The stream root and the degrade record are process-global: every
    test starts and ends with neither set, and with the default knobs."""
    for name in KNOBS:
        monkeypatch.delenv(name, raising=False)
    _reset()
    yield
    _reset()


def _quiet(fn, *args, **kwargs):
    with contextlib.redirect_stderr(io.StringIO()):
        return fn(*args, **kwargs)


def _random_seqs(seed=0, lengths=(500, 333, 801, 64)):
    rng = np.random.default_rng(seed)
    return ["".join(rng.choice(list("ACGT"), size=n)) for n in lengths]


def _adversarial_seqs():
    """Duplication-heavy and plasmid-rich: a repeated block shared across
    contigs (deep groups spanning sequences), many short contigs (window-0
    and dot-padded windows) and exact duplicate contigs."""
    rng = np.random.default_rng(7)
    core = "".join(rng.choice(list("ACGT"), size=400))
    seqs = [core * 3, core[:150] + core[:150], core[::-1]]
    seqs += ["".join(rng.choice(list("ACGT"), size=n))
             for n in (40, 51, 33, 64, 29, 77)]
    seqs += [seqs[3], seqs[4]]
    return seqs


def _objects(seqs, k=K, cls=Sequence):
    return [cls.with_seq(i + 1, s, "t.fa", f"c{i}", k // 2)
            for i, s in enumerate(seqs)]


def _layout(seqs, k=K):
    """(codes, seq_len, fwd_off, rev_off, occ_off, starts) as
    build_kmer_index lays the windows out."""
    bufs, seq_len, fwd_off, rev_off, occ_off = [], [], [], [], []
    pos = occ = 0
    for o in _objects(seqs, k, JaxSequence):
        f, r = o.encoded_strands()
        L = len(f) - k + 1
        seq_len.append(L)
        fwd_off.append(pos)
        bufs.append(f)
        pos += len(f)
        rev_off.append(pos)
        bufs.append(r)
        pos += len(r)
        occ_off.append(occ)
        occ += 2 * L
    arrays = [np.array(a, np.int64)
              for a in (seq_len, fwd_off, rev_off, occ_off)]
    runs = []
    for L, fo, ro in zip(*arrays[:3]):
        runs.append(np.arange(fo, fo + L, dtype=np.int64))
        runs.append(np.arange(ro, ro + L, dtype=np.int64))
    return (np.concatenate(bufs), *arrays, np.concatenate(runs))


# ---------------------------------------------------------------------------
# plan and dispatch
# ---------------------------------------------------------------------------

def _same_plan(plan, jax_plan) -> bool:
    """Every field of the port's plan equals the JAX package's; the JAX
    plan's merge_parts and est_windows have no use in the port (it merges
    in one grouping launch)."""
    want = {key: value for key, value in dataclasses.asdict(jax_plan).items()
            if key not in ("merge_parts", "est_windows")}
    return dataclasses.asdict(plan) == want


@pytest.mark.parametrize("M,k,workers", [
    (100, 15, 1), (1_000_000, 51, 1), (10_000_000, 51, 8),
    (293_762_592, 51, 1), (293_762_592, 51, 8), (400_000_000, 25, 3),
    (5_000_000_000, 101, 2), (5, 11, 2)])
def test_plan_matches_jax(M, k, workers):
    assert _same_plan(st.plan_stream(M, k, workers=workers),
                      jst.plan_stream(M, k, workers=workers))


@pytest.mark.parametrize("env", [
    {"AUTOCYCLER_STREAM_MEM_MB": "1"},
    {"AUTOCYCLER_STREAM_MEM_MB": "64"},
    {"AUTOCYCLER_STREAM_MEM_MB": "not-a-number"},
    {"AUTOCYCLER_STREAM_BINS": "3", "AUTOCYCLER_STREAM_CHUNK": "500",
     "AUTOCYCLER_STREAM_SIG_K": "9"},
    {"AUTOCYCLER_STREAM_SIG_K": "99"},
    {"AUTOCYCLER_STREAM_BINS": "9999", "AUTOCYCLER_STREAM_FLUSH": "17",
     "AUTOCYCLER_STREAM_PIPELINE": "0"},
    {"AUTOCYCLER_STREAM_RLE": "0", "AUTOCYCLER_STREAM_PIPELINE": "99"},
    {"AUTOCYCLER_STREAM_RLE": "off", "AUTOCYCLER_STREAM_CHUNK": " 257 "}])
def test_plan_overrides_match_jax(monkeypatch, env):
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    for M, k, workers in ((1000, 15, 1), (1_000_000, 51, 4),
                          (300_000_000, 21, 1)):
        assert _same_plan(_quiet(st.plan_stream, M, k, workers=workers),
                          _quiet(jst.plan_stream, M, k, workers=workers))


@pytest.mark.parametrize("mode,auto_windows", [
    (None, None), ("auto", "1000"), ("on", None), ("off", "1"),
    (" ON ", None), ("false", None), ("bogus", "1000"), ("", "5")])
def test_resolve_stream_mode_matches_jax(monkeypatch, mode, auto_windows):
    if mode is not None:
        monkeypatch.setenv("AUTOCYCLER_STREAM_KMERS", mode)
    if auto_windows is not None:
        monkeypatch.setenv("AUTOCYCLER_STREAM_AUTO_WINDOWS", auto_windows)
    for M in (0, 1, 999, 1000, 63_999_999, 64_000_000, 293_762_592):
        for k in (1, 2, 51):
            assert st.resolve_stream_mode(M, k) == \
                jst.resolve_stream_mode(M, k), (M, k)


def test_default_dispatch_is_the_jax_threshold():
    assert not st.resolve_stream_mode(63_999_999, 51)
    assert st.resolve_stream_mode(64_000_000, 51)
    assert st.resolve_stream_mode(293_762_592, 51)    # the headline


def test_env_defaults_match_jax_knobs(monkeypatch):
    from autocycler_tpu.utils import knobs
    from autocycler_tpu_torch.utils import knobs as port_knobs
    readers = {"str": port_knobs.knob_str, "int": port_knobs.knob_int,
               "bool": port_knobs.knob_bool, "float": port_knobs.knob_float}
    for name, port_knob in port_knobs.KNOBS.items():
        monkeypatch.delenv(name, raising=False)
        knob = knobs.KNOBS[name]
        assert (port_knob.kind, port_knob.default) == \
            (knob.kind, knob.default), name
        assert readers[knob.kind](name) == knob.default, name
    # no reader falls back on a default of its own for an unlisted knob
    for reader in readers.values():
        with pytest.raises(KeyError):
            reader("AUTOCYCLER_NOT_A_KNOB")


@pytest.mark.parametrize("executor", [None, "pool"])
def test_effective_workers_match_jax(monkeypatch, executor):
    from autocycler_tpu_torch.stream import planner
    if executor:
        monkeypatch.setenv("AUTOCYCLER_GROUPING_EXECUTOR", executor)
    for threads in (None, 0, 1, 3, 8, 64):
        got = planner.effective_workers(planner.resolve_threads(threads))
        assert got == jax_kmers._effective_workers(
            jax_kmers._resolve_threads(threads)), threads


# ---------------------------------------------------------------------------
# the RLE codec and the bin reader
# ---------------------------------------------------------------------------

def test_rle_matches_jax():
    rng = np.random.default_rng(42)
    for _ in range(60):
        n = int(rng.integers(0, 2000))
        occ = np.cumsum(rng.choice([1, 1, 1, 2, 7, 50], size=n)).astype(
            np.int64)
        pairs = st.encode_rle(occ)
        assert pairs.tobytes() == jst.encode_rle(occ).tobytes()
        back, reason = st.decode_rle(pairs)
        assert reason is None and np.array_equal(back, occ)
    assert np.array_equal(st.encode_rle(np.arange(17, 5017)), [17, 5000])
    back, reason = st.decode_rle(np.array([5, 3, 8, 2], np.int64))
    assert reason is None and np.array_equal(back, [5, 6, 7, 8, 9])


@pytest.mark.parametrize("pairs", [[0, 5, 10, 0], [-3, 2], [0, 5, 3, 2],
                                   [9, 1, 2, 1], []])
def test_rle_decode_verdicts_match_jax(pairs):
    pairs = np.array(pairs, np.int64)
    got, reason = st.decode_rle(pairs)
    want, want_reason = jst.decode_rle(pairs)
    assert reason == want_reason
    assert (got is None) == (want is None)
    if got is not None:
        assert np.array_equal(got, want)


def _bin_cases(tmp_path):
    occ = np.concatenate([np.arange(10, 40), np.arange(100, 103),
                          np.array([500])]).astype(np.int64)
    pairs = st.encode_rle(occ).astype("<i8").tobytes()
    raw = occ.astype("<i8").tobytes()
    files = {
        "raw": raw, "rle": pairs,
        "raw torn": raw + b"\x01\x02\x03",
        "rle torn mid-record": pairs[:-8],
        "rle short by one run": pairs[:-16],
        "raw shuffled": np.array([3, 1, 2], "<i8").tobytes(),
        "raw negative": np.array([-1, 2], "<i8").tobytes(),
        "rle bad run": np.array([0, 5, 3, 2], "<i8").tobytes(),
        "rle zero run": np.array([0, 0], "<i8").tobytes(),
        "empty": b"",
    }
    for name, data in files.items():
        (tmp_path / f"{name}.u64").write_bytes(data)
    return occ, files


@pytest.mark.parametrize("fmt", [1, 2, 7, -1])
def test_read_bin_records_verdicts_match_jax(tmp_path, fmt):
    occ, files = _bin_cases(tmp_path)
    for name in list(files) + ["missing"]:
        for expected in (None, len(occ), 3):
            path = tmp_path / f"{name}.u64"
            got, reason = st.read_bin_records(path, expected, fmt)
            want, want_reason = jst.read_bin_records(path, expected, fmt)
            assert reason == want_reason, (name, expected)
            assert (got is None) == (want is None), (name, expected)
            if got is not None:
                assert got.dtype == np.int64
                assert np.array_equal(got, want), (name, expected)
    got, reason = st.read_bin_records(tmp_path / "rle.u64", len(occ), 2)
    assert reason is None and np.array_equal(got, occ)


# ---------------------------------------------------------------------------
# pass 1: the bin files
# ---------------------------------------------------------------------------

def _batch_of_each_chunk(seq_len, occ_off, chunk, cap):
    """(first occurrence of every plan chunk, its pass-1 batch, first
    occurrence of every strand run) for strand runs fed in order."""
    chunk_starts, run_starts = [], []
    for L, base in zip(seq_len.tolist(), occ_off.tolist()):
        for occ0 in (base, base + L):
            run_starts.append(occ0)
            chunk_starts += range(occ0, occ0 + L, chunk)
    chunk_starts = np.array(chunk_starts)
    return chunk_starts, np.arange(len(chunk_starts)) // cap, \
        np.array(run_starts)


def _record_jax_flushes(monkeypatch):
    """Every flush of the JAX binner, as (bin, first occurrence, last
    occurrence) of the records it writes."""
    flushes = []
    real_flush = jst.StreamBinner._flush

    def flush(self, b):
        if self._bufs[b]:
            flushes.append((b, int(self._bufs[b][0][0]),
                            int(self._bufs[b][-1][-1])))
        real_flush(self, b)

    monkeypatch.setattr(jst.StreamBinner, "_flush", flush)
    return flushes


def _case(seqs, bins, chunk, flush, cap=None):
    """A plan of test_bin_files_byte_identical_to_jax under the id that it
    had before the batch cap was a case of it."""
    return pytest.param(seqs, bins, chunk, flush, cap,
                        id="-".join((seqs, bins, chunk, flush)
                                    + ((f"cap{cap}",) if cap else ())))


@pytest.mark.parametrize("rle", ["1", "0"])
@pytest.mark.parametrize("pipeline", ["1", "3"])
@pytest.mark.parametrize("seqs,bins,chunk,flush,cap", [
    _case("random", "8", "4096", "512"), _case("random", "13", "97", "17"),
    _case("adversarial", "5", "257", "0"), _case("adversarial", "1", "33", "1"),
    # the batch cap splits the input into many batches, with flushes whose
    # records span both a batch boundary and a strand-run boundary
    _case("random", "5", "37", "60", cap=2),
    _case("adversarial", "3", "29", "45", cap=3)])
def test_bin_files_byte_identical_to_jax(monkeypatch, tmp_path, seqs, bins,
                                         chunk, flush, cap, rle, pipeline):
    for name, value in (("BINS", bins), ("CHUNK", chunk), ("FLUSH", flush),
                        ("RLE", rle), ("PIPELINE", pipeline)):
        monkeypatch.setenv(f"AUTOCYCLER_STREAM_{name}", value)
    if cap:
        monkeypatch.setattr(binner_mod, "BATCH_CHUNKS", cap)
    flushes = _record_jax_flushes(monkeypatch)
    seqs = _random_seqs(seed=4) if seqs == "random" else _adversarial_seqs()
    codes, seq_len, fwd_off, rev_off, occ_off, _ = _layout(seqs)
    M = int(2 * seq_len.sum())
    plan = st.plan_stream(M, K)
    jplan = jst.plan_stream(M, K)
    assert _same_plan(plan, jplan)
    codes_t = torch.from_numpy(codes)
    ours, theirs = tmp_path / "port", tmp_path / "jax"
    ours.mkdir()
    theirs.mkdir()
    binner = StreamBinner(ours, plan, K)
    jbinner = jst.StreamBinner(theirs, jplan, K)
    for i in range(len(seq_len)):
        L, fo, ro = int(seq_len[i]), int(fwd_off[i]), int(rev_off[i])
        for b, c, base in ((binner, codes_t, occ_off[i]),
                           (jbinner, codes, occ_off[i])):
            b.add_run(c[fo:fo + L + K - 1], int(base))
            b.add_run(c[ro:ro + L + K - 1], int(base) + L)
    summary = binner.close()
    jsummary = jbinner.close()
    chunks = summary.pop("chunks")
    assert chunks >= len(seq_len) * 2
    assert summary == jsummary
    cap = cap or binner_mod.BATCH_CHUNKS
    assert binner.batches == -(-chunks // cap)
    if cap < binner_mod.BATCH_CHUNKS:
        assert binner.batches >= 3
        chunk_starts, batch, run_starts = _batch_of_each_chunk(
            seq_len, occ_off, plan.chunk_windows, cap)

        def where(occ):
            return (batch[np.searchsorted(chunk_starts, occ, "right") - 1],
                    np.searchsorted(run_starts, occ, "right"))

        assert any(where(lo)[0] != where(hi)[0] and where(lo)[1] != where(hi)[1]
                   for _, lo, hi in flushes)
    names = sorted(p.name for p in ours.iterdir())
    assert names == sorted(p.name for p in theirs.iterdir())
    assert "manifest.json" in names and len(names) > 1
    for name in names:
        assert (ours / name).read_bytes() == (theirs / name).read_bytes(), \
            name
    assert _metric(spill.SPILL_BYTES_TOTAL) == summary["spill_bytes"] \
        == sum((ours / n).stat().st_size for n in names
               if n.startswith("bin-"))
    assert summary["records"] == M


# ---------------------------------------------------------------------------
# the streamed grouping
# ---------------------------------------------------------------------------

def _stats_everywhere(seqs, threads):
    codes, seq_len, fwd_off, rev_off, occ_off, starts = _layout(seqs)
    streamed = st.stream_group_windows_stats(
        torch.from_numpy(codes), seq_len, fwd_off, rev_off, occ_off, K,
        threads=threads)
    return streamed, (
        jst.stream_group_windows_stats(codes, seq_len, fwd_off, rev_off,
                                       occ_off, K, use_jax=False,
                                       threads=threads),
        jax_kmers.group_windows_stats(codes, starts, K, False, 1),
        kmers.group_windows_stats(codes, starts, K, device="cpu"))


@pytest.mark.parametrize("threads", [1, 3])
@pytest.mark.parametrize("seqs", ["random", "adversarial"])
@pytest.mark.parametrize("plan", [
    {}, {"BINS": "11", "CHUNK": "257"},
    {"BINS": "13", "CHUNK": "97", "FLUSH": "17", "PIPELINE": "3"},
    {"BINS": "7", "CHUNK": "101", "RLE": "0", "PIPELINE": "1"},
    {"BINS": "1", "CHUNK": "1"},
    {"BINS": "5", "CHUNK": "37", "FLUSH": "60", "cap": 2}])
def test_stream_stats_match_jax_and_in_memory(monkeypatch, tmp_path, threads,
                                              seqs, plan):
    for name, value in plan.items():
        if name == "cap":       # the pass-1 batch cap, a module constant
            monkeypatch.setattr(binner_mod, "BATCH_CHUNKS", value)
        else:
            monkeypatch.setenv(f"AUTOCYCLER_STREAM_{name}", value)
    # the worker count as asked, on any number of cores
    monkeypatch.setenv("AUTOCYCLER_GROUPING_EXECUTOR", "pool")
    st.set_stream_root(tmp_path / ".stream")
    jst.set_stream_root(tmp_path / ".jax_stream")
    seqs = _random_seqs(seed=21) if seqs == "random" else _adversarial_seqs()
    got, wants = _stats_everywhere(seqs, threads)
    for want in wants:
        for name, a, b in zip(("gid", "order", "depth", "first_occ"),
                              got, want):
            assert a.dtype == np.int64, name
            assert np.array_equal(a, b), name
    assert spill.last_run["workers"] == threads
    assert _metric(spill.SPILL_BYTES_GAUGE) == 0          # the run dir is gone
    assert not list((tmp_path / ".stream").glob("run-*"))


def test_pass1_works_in_device_batches(monkeypatch, tmp_path):
    """A streamed grouping at a small plan routes pass 1 in the batches
    that the plan's chunk count and the batch cap imply, counts each in the
    registry and in ``spill.last_run``, copies to the host at most twice a
    batch and appends to each bin at most once a batch."""
    monkeypatch.setattr(binner_mod, "BATCH_CHUNKS", 4)
    for name, value in (("BINS", "6"), ("CHUNK", "50"), ("FLUSH", "40")):
        monkeypatch.setenv(f"AUTOCYCLER_STREAM_{name}", value)
    st.set_stream_root(tmp_path / ".stream")
    codes, seq_len, fwd_off, rev_off, occ_off, starts = _layout(
        _random_seqs(seed=21))
    plan = st.plan_stream(len(starts), K)
    chunks = 2 * sum(-(-int(L) // plan.chunk_windows) for L in seq_len)
    batches = -(-chunks // 4)
    got = st.stream_group_windows_stats(torch.from_numpy(codes), seq_len,
                                        fwd_off, rev_off, occ_off, K)
    copies = metrics_registry.registry().value(
        "autocycler_device_to_host_copies_total", site="stream-bin")
    assert 0 < copies <= 2 * batches
    run = spill.last_run
    assert run["chunks"] == chunks
    assert run["pass1_batches"] == batches >= 3
    assert _metric(binner_mod.PASS1_BATCHES_TOTAL) == batches
    assert 0 < run["appends"] <= plan.n_bins * batches
    want = kmers.group_windows_stats(codes, starts, K, device="cpu")
    for a, b in zip(got, want):
        assert np.array_equal(a, b)


def test_stream_stats_without_wired_root():
    # library callers without compress's wiring stream into a tempdir
    assert st.stream_root() is None
    got, wants = _stats_everywhere(_random_seqs(seed=3, lengths=(120, 80)),
                                   1)
    for want in wants:
        for a, b in zip(got, want):
            assert np.array_equal(a, b)
    assert st.stream_root() is None


def test_occ_byte_starts_matches_jax():
    codes, seq_len, fwd_off, rev_off, occ_off, starts = _layout(
        _adversarial_seqs())
    occ = np.arange(len(starts), dtype=np.int64)
    got = st.occ_byte_starts(*(torch.from_numpy(a) for a in (
        occ, seq_len, fwd_off, rev_off, occ_off)))
    assert np.array_equal(got.numpy(), starts)
    assert np.array_equal(got.numpy(), jst.occ_byte_starts(
        occ, seq_len, fwd_off, rev_off, occ_off))


def test_merge_ranks_ranks_and_refuses_duplicates():
    rng = np.random.default_rng(5)
    codes = rng.integers(1, 5, size=3000).astype(np.uint8)
    codes[1000:1100] = codes[2000:2100]         # one k-mer at two starts
    reps = np.unique(rng.integers(0, 2900, size=400))
    reps = reps[(reps < 990) | (reps > 1100)]   # all distinct k-mers
    got = st.merge_ranks(torch.from_numpy(codes), torch.from_numpy(reps), K)
    want = jst.merge_ranks(codes, reps, K, merge_parts=16)
    assert got.dtype == torch.int64 and np.array_equal(got.numpy(), want)
    assert len(st.merge_ranks(torch.from_numpy(codes),
                              torch.zeros(0, dtype=torch.int64), K)) == 0
    dup = np.concatenate([reps, [1010, 2010]])
    with pytest.raises(rz.SpillError, match="duplicate"):
        st.merge_ranks(torch.from_numpy(codes), torch.from_numpy(dup), K)


INDEX_FIELDS = ("depth", "first_pos", "rep_byte", "rev_kid", "prefix_gid",
                "suffix_gid", "in_count", "out_count", "succ", "occ_kid",
                "first_occ", "occ_sorted", "group_start")


def _index(seqs, monkeypatch, mode, **plan):
    monkeypatch.setenv("AUTOCYCLER_STREAM_KMERS", mode)
    for name, value in plan.items():
        monkeypatch.setenv(f"AUTOCYCLER_STREAM_{name}", value)
    return kmers.build_kmer_index(_objects(seqs), K, device="cpu")


@pytest.mark.parametrize("seqs", ["random", "adversarial"])
def test_build_kmer_index_streamed_equals_in_memory(monkeypatch, tmp_path,
                                                    seqs):
    seqs = _random_seqs(seed=9) if seqs == "random" else _adversarial_seqs()
    mem = _index(seqs, monkeypatch, "off")
    assert not spill.last_run
    st.set_stream_root(tmp_path / ".stream")
    timing.reset()
    streamed = _index(seqs, monkeypatch, "on", BINS="9", CHUNK="333")
    assert not rz.degrade_events()
    for name in INDEX_FIELDS:
        a, b = getattr(mem, name), getattr(streamed, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert set(timing.substage_snapshot()) >= {
        "stream-kmers", "stream-bin", "stream-sort", "stream-merge",
        "stream-stitch", "gram grouping", "adjacency"}
    assert "k-mer grouping" not in timing.substage_snapshot()
    run = spill.last_run
    assert run["n_bins"] == 9 and 0 < run["bins"] <= 9
    assert run["records"] == len(mem.occ_kid)
    assert run["representatives"] == len(mem.depth)
    assert run["rle_ratio"] > 1 and run["format"] == 2
    # counted launches are the card's: the plain version on the CPU is none
    assert run["sort_launches"] == run["merge_launches"] == 0
    assert _metric(spill.SPILL_BYTES_TOTAL) == run["spill_bytes"] > 0
    assert _metric(spill.SPILL_BYTES_GAUGE) == 0
    assert not list((tmp_path / ".stream").glob("run-*"))


def _tear(path):
    path.write_bytes(path.read_bytes() + b"\x01\x02\x03")


def _truncate(path):
    path.write_bytes(path.read_bytes()[:-16])


def _bump_format(run_dir):
    manifest = json.loads((run_dir / "manifest.json").read_text())
    manifest["format"] = 7
    (run_dir / "manifest.json").write_text(json.dumps(manifest))


@pytest.mark.parametrize("corrupt,reason", [
    ("torn", "torn bin file"), ("truncated", "manifest recorded"),
    ("format", "unsupported spill record format 7")])
def test_corrupt_bin_degrades_visibly(monkeypatch, tmp_path, capsys,
                                      corrupt, reason):
    seqs = _random_seqs(seed=5)
    mem = _index(seqs, monkeypatch, "off")
    st.set_stream_root(tmp_path / ".stream")
    real_close = StreamBinner.close

    def close_then_corrupt(self):
        summary = real_close(self)
        victim = self.run_dir / spill.bin_filename(
            int(np.flatnonzero(self.counts)[0]))
        if corrupt == "torn":
            _tear(victim)
        elif corrupt == "truncated":
            _truncate(victim)
        else:
            _bump_format(self.run_dir)
        return summary

    monkeypatch.setattr(StreamBinner, "close", close_then_corrupt)
    capsys.readouterr()
    degraded = _index(seqs, monkeypatch, "on", BINS="5")
    events = rz.degrade_events("stream-kmers")
    assert len(events) == 1
    assert events[0]["from"] == "stream" and events[0]["to"] == "in-memory"
    assert events[0]["reason"].startswith("SpillError: bin ")
    assert reason in events[0]["reason"]
    err = capsys.readouterr().err
    assert "autocycler backend degrade: stream-kmers: stream -> in-memory " \
           "(SpillError: bin " in err
    assert _metric(driver.QUARANTINED_BINS_TOTAL) >= 1
    for name in INDEX_FIELDS:
        assert np.array_equal(getattr(mem, name), getattr(degraded, name)), \
            name
    assert not list((tmp_path / ".stream").glob("run-*"))


def test_a_quarantined_bin_counts_once_whatever_reads_are_in_flight(
        monkeypatch, tmp_path):
    """Pass 2 reads bins ahead of the sorts. The first bad bin in bin order
    is quarantined and ends the pass; a later bin whose read fails while
    it was in flight (here every read fails, the first one last) is not
    counted."""
    import time

    seqs = _random_seqs(seed=5)
    st.set_stream_root(tmp_path / ".stream")
    first = []

    def failing_read(path, expected, fmt):
        if not first:
            first.append(path.name)
            time.sleep(0.3)
        return None, "unreadable bin"

    monkeypatch.setattr(spill, "read_bin_records", failing_read)
    _index(seqs, monkeypatch, "on", BINS="5", PIPELINE="3")
    events = rz.degrade_events("stream-kmers")
    assert len(events) == 1 and events[0]["reason"].startswith(
        "SpillError: bin ")
    assert _metric(driver.QUARANTINED_BINS_TOTAL) == 1


@pytest.mark.parametrize("batch", [1, 2])
def test_write_error_degrades_visibly(monkeypatch, tmp_path, capsys, batch):
    """An append that fails, in pass 1's first batch or (with the batch cap
    at 2 and the fault plan's ``stream_write`` site armed as the second
    batch's appends begin) in a later one, degrades the grouping to in
    memory."""
    seqs = _random_seqs(seed=6)
    mem = _index(seqs, monkeypatch, "off")
    st.set_stream_root(tmp_path / ".stream")
    if batch == 1:
        def fail(self, path, payload):
            raise OSError(f"stream bin write failed: {path.name}")

        monkeypatch.setattr(StreamBinner, "_append", fail)
        reason = "OSError: stream bin"
    else:
        monkeypatch.setattr(binner_mod, "BATCH_CHUNKS", 2)
        real_write = StreamBinner._write
        writes = []

        def write(self, data, jobs):
            writes.append(len(jobs))
            if len(writes) == batch:
                rz.set_fault_plan(rz.FaultPlan.parse("stream_write:bin-::1"))
            real_write(self, data, jobs)

        monkeypatch.setattr(StreamBinner, "_write", write)
        reason = "OSError: fault injection: stream bin write failed"
    try:
        degraded = _index(seqs, monkeypatch, "on", BINS="5",
                          **({} if batch == 1 else {"CHUNK": "100",
                                                    "FLUSH": "30"}))
    finally:
        rz.set_fault_plan(None)
    events = rz.degrade_events("stream-kmers")
    assert events and events[0]["reason"].startswith(reason)
    assert "stream -> in-memory (OSError" in capsys.readouterr().err
    if batch == 2:
        assert len(writes) == 2 and writes[0] > 0
        assert metrics_registry.registry().value(
            rz.FAULT_INJECTIONS_TOTAL, site="stream_write", mode="fail") == 1
    assert np.array_equal(mem.occ_kid, degraded.occ_kid)
    assert not list((tmp_path / ".stream").glob("run-*"))


def test_device_error_does_not_degrade(monkeypatch, tmp_path):
    st.set_stream_root(tmp_path / ".stream")

    def device_fault(*args, **kwargs):
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(driver, "sort_bin", device_fault)
    with pytest.raises(RuntimeError, match="CUDA error"):
        _index(_random_seqs(seed=2), monkeypatch, "on", BINS="3")
    assert not rz.degrade_events()
    assert not list((tmp_path / ".stream").glob("run-*"))


# ---------------------------------------------------------------------------
# compress
# ---------------------------------------------------------------------------

def _tree(root):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*"))


@pytest.mark.parametrize("k,threads,plan", [
    (51, 1, {"BINS": "7", "CHUNK": "129"}),
    (51, 3, {}),
    (11, 1, {"BINS": "8", "CHUNK": "4096", "FLUSH": "512", "RLE": "0"})])
def test_compress_streamed_matches_jax_and_in_memory(monkeypatch, tmp_path,
                                                     k, threads, plan):
    asm = make_assemblies(tmp_path, n_assemblies=3, chromosome_len=4000,
                          plasmid_len=700, n_snps=3, seed=11)
    monkeypatch.setenv("AUTOCYCLER_STREAM_KMERS", "off")
    _quiet(compress, asm, tmp_path / "mem", k, threads=threads, device="cpu")
    monkeypatch.setenv("AUTOCYCLER_STREAM_KMERS", "on")
    for name, value in plan.items():
        monkeypatch.setenv(f"AUTOCYCLER_STREAM_{name}", value)
    _quiet(jax_compress, asm, tmp_path / "jax", k, threads=threads)
    _quiet(compress, asm, tmp_path / "port", k, threads=threads,
           device="cpu")
    assert not rz.degrade_events() and not jax_rz.degrade_events()
    assert spill.last_run["records"] > 0
    for name in ("input_assemblies.gfa", "input_assemblies.yaml"):
        port = (tmp_path / "port" / name).read_bytes()
        assert port == (tmp_path / "jax" / name).read_bytes(), name
        assert port == (tmp_path / "mem" / name).read_bytes(), name
    # both packages' trees, warm-start cache entries included
    cache = [".cache"] + sorted(
        f".cache/{p.name}" for p in (tmp_path / "jax/.cache").iterdir())
    assert [p for p in cache if p.startswith(".cache/asm-")] and \
        [p for p in cache if p.startswith(".cache/repair-")]
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax") == cache + [
        ".stream", "input_assemblies.gfa", "input_assemblies.yaml"]
    assert _tree(tmp_path / "mem") == cache + ["input_assemblies.gfa",
                                               "input_assemblies.yaml"]
    assert st.stream_root() == tmp_path / "port" / ".stream"


@pytest.mark.parametrize("auto_windows", ["1000", "64000000"])
def test_compress_default_mode_streams_where_jax_does(monkeypatch, tmp_path,
                                                      auto_windows):
    asm = make_assemblies(tmp_path, n_assemblies=2, chromosome_len=3000,
                          plasmid_len=500, seed=3)
    monkeypatch.setenv("AUTOCYCLER_STREAM_AUTO_WINDOWS", auto_windows)
    _quiet(jax_compress, asm, tmp_path / "jax", 51, threads=1)
    _quiet(compress, asm, tmp_path / "port", 51, device="cpu")
    streams = auto_windows == "1000"
    assert (tmp_path / "port" / ".stream").is_dir() == streams
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")
    assert (tmp_path / "port/input_assemblies.gfa").read_bytes() == \
        (tmp_path / "jax/input_assemblies.gfa").read_bytes()
    assert bool(spill.last_run) == streams


# ---------------------------------------------------------------------------
# orphan sweep, prepare_stream_root, purge
# ---------------------------------------------------------------------------

def test_sweep_orphan_spills(tmp_path):
    root = tmp_path / ".stream"
    root.mkdir()
    dead = spill.new_run_dir(root)
    spill.write_manifest(dead, K, 11, 4)
    data = json.loads((dead / "manifest.json").read_text())
    data["pid"] = 2**22 + 12345                 # a pid that cannot be alive
    (dead / "manifest.json").write_text(json.dumps(data))
    live = spill.new_run_dir(root)
    spill.write_manifest(live, K, 11, 4)        # our own live pid
    broken = root / "run-99999-deadbeef"
    broken.mkdir()
    (broken / "manifest.json").write_text("{not json")
    assert _quiet(st.sweep_orphan_spills, root) == 2
    assert not dead.exists() and not broken.exists() and live.exists()
    assert _metric(spill.ORPHANS_SWEPT_TOTAL) == 2
    assert st.sweep_orphan_spills(root) == 0    # idempotent
    # the JAX package reads the port's manifest alike
    assert jax_spill.read_manifest(live) == spill.read_manifest(live)


def test_prepare_stream_root_sets_and_sweeps(tmp_path):
    root = tmp_path / ".stream"
    orphan = root / "run-1-aaaa"
    orphan.mkdir(parents=True)
    (orphan / "manifest.json").write_text(json.dumps(
        {"version": 1, "pid": 2**22 + 54321, "k": K, "sig_k": 11,
         "n_bins": 4, "spill_bytes": 0, "counts": None}))
    _quiet(st.prepare_stream_root, tmp_path)
    assert st.stream_root() == root
    assert not orphan.exists()
    st.prepare_stream_root(tmp_path / "elsewhere")  # creates nothing
    assert not (tmp_path / "elsewhere").exists()


def test_purge_stream_spills_variants(tmp_path):
    root = tmp_path / ".stream"
    run = root / "run-1-bbbb"
    run.mkdir(parents=True)
    (run / spill.bin_filename(0)).write_bytes(b"\x00" * 64)
    removed, reclaimed = st.purge_stream_spills(tmp_path)
    assert removed == 1 and reclaimed >= 64
    assert not root.exists()
    (tmp_path / ".cache").mkdir()
    (root / "run-2-cccc").mkdir(parents=True)
    assert st.purge_stream_spills(tmp_path / ".cache")[0] == 1
    assert not root.exists()
    (root / "run-3-dddd").mkdir(parents=True)
    assert st.purge_stream_spills(root)[0] == 1
    assert st.purge_stream_spills(tmp_path) == (0, 0)
