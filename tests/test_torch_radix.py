"""The port's radix-sharded k-mer grouping (``AUTOCYCLER_DEVICE_GROUPING=radix``,
``ops/kmers.py`` ``radix_rank``) against the JAX package's radix path, on
CPU meshes, with tolerance 0: the partition, the layout at 8 devices, the
grouping with its statistics on meshes of 1, 3 and 8 CPU devices, the
mode switch, ``shard_leading_axis`` and a radix compress whose files are
the JAX package's default compress bytes. Inputs come from numpy with a
seed."""

import contextlib
import io

import numpy as np
import pytest
import torch

from autocycler_tpu.commands.compress import compress as jax_compress
from autocycler_tpu.ops import kmers as jax_kmers
from autocycler_tpu_torch import device
from autocycler_tpu_torch.commands.compress import compress
from autocycler_tpu_torch.ops import kmers
from autocycler_tpu_torch.parallel.mesh import shard_leading_axis

from synthetic import make_assemblies

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _default_knobs(monkeypatch):
    for name in ("AUTOCYCLER_DEVICE_GROUPING", "AUTOCYCLER_STREAM_KMERS",
                 "AUTOCYCLER_GROUPING_EXECUTOR", "AUTOCYCLER_HOST_GROUPING"):
        monkeypatch.delenv(name, raising=False)


def _case(seed, n_codes=3000, n_windows=2500, k=21):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 5, size=n_codes).astype(np.uint8)
    starts = rng.integers(0, n_codes - k, size=n_windows).astype(np.int64)
    return codes, starts, k


def _adversarial_cases():
    """The JAX radix tests' inputs: one giant equal-key group, a palindrome
    (every k-mer with its mirror), and fewer windows than partitions."""
    k = 9
    cases = [("all_same", np.full(500, 3, np.uint8),
              np.arange(492, dtype=np.int64), k)]
    half = np.random.default_rng(0).integers(0, 5, size=400).astype(np.uint8)
    pal = np.concatenate([half, half[::-1]])
    cases.append(("palindrome", pal,
                  np.arange(len(pal) - k, dtype=np.int64), k))
    codes, starts, k = _case(3, n_codes=200, n_windows=11, k=5)
    cases.append(("tiny_n", codes, starts, k))
    return cases


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# the partition and the layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("workers,n_parts", [(1, 1), (1, 8), (3, 16),
                                             (4, 64), (8, 15625)])
@pytest.mark.parametrize("k", [1, 5, 13, 21])
def test_partition_equals_jax(k, workers, n_parts):
    """(part, offs) bit for bit; 300,000 windows give the JAX package
    several slabs (one per 65,536 windows, up to the worker count)."""
    codes, starts, _ = _case(40 + k, n_codes=320_000, n_windows=300_000, k=k)
    want_part, want_offs = jax_kmers._radix_partition(codes, starts, k,
                                                      workers, n_parts)
    part, offs = kmers.radix_partition(_t(codes), _t(starts), k, workers,
                                       n_parts)
    np.testing.assert_array_equal(part.numpy(), want_part)
    np.testing.assert_array_equal(offs, want_offs)


@pytest.mark.parametrize("case", _adversarial_cases(), ids=lambda c: c[0])
@pytest.mark.parametrize("workers,n_parts", [(1, 32), (3, 32)])
def test_partition_adversarial_equals_jax(case, workers, n_parts):
    """A key no cut can split, heavy duplicates, and empty chunks dropped
    (11 windows into 32 parts)."""
    _, codes, starts, k = case
    want_part, want_offs = jax_kmers._radix_partition(codes, starts, k,
                                                      workers, n_parts)
    part, offs = kmers.radix_partition(_t(codes), _t(starts), k, workers,
                                       n_parts)
    np.testing.assert_array_equal(part.numpy(), want_part)
    np.testing.assert_array_equal(offs, want_offs)
    assert (np.diff(offs) > 0).all()


@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("seed,n_windows,k", [(0, 2500, 21), (1, 900, 5),
                                              (2, 200_000, 27)])
def test_layout_equals_jax_at_8_devices(monkeypatch, seed, n_windows, k,
                                        threads):
    """rows, b, cb, starts_mat and n_real equal _radix_device_layout's
    over the JAX tests' 8 virtual CPU devices."""
    import jax
    assert len(jax.devices()) == 8
    monkeypatch.setenv("AUTOCYCLER_GROUPING_EXECUTOR", "thread")
    codes, starts, _ = _case(seed, n_codes=n_windows + 1000,
                             n_windows=n_windows, k=k)
    (j_part, j_offs, j_rows, j_b, j_cb, j_mat, j_nreal,
     _) = jax_kmers._radix_device_layout(codes, starts, k, threads)
    part, offs, rows, b, cb, mat, n_real = kmers.radix_device_layout(
        _t(codes), _t(starts), k, 8, threads)
    np.testing.assert_array_equal(part.numpy(), j_part)
    np.testing.assert_array_equal(offs, j_offs)
    assert (rows, b, cb) == (j_rows, j_b, j_cb)
    assert mat.dtype == torch.int32
    np.testing.assert_array_equal(mat.numpy(), j_mat)
    np.testing.assert_array_equal(n_real, j_nreal)


# ---------------------------------------------------------------------------
# the grouping
# ---------------------------------------------------------------------------

def _default_stats(codes, starts, k):
    return kmers.group_windows_stats(codes, starts, k, device="cpu")


def _radix_stats(codes, starts, k, n_dev, threads=2):
    order, gid_sorted, depth, first = kmers.radix_rank(
        _t(codes), _t(starts), k, threads=threads, devices=[CPU] * n_dev,
        stats=True)
    assert order.dtype == gid_sorted.dtype == torch.int32
    return (kmers.scatter_gid(order, gid_sorted).numpy(), order.numpy(),
            depth.numpy(), first.numpy())


@pytest.mark.parametrize("n_dev", [1, 3, 8])
@pytest.mark.parametrize("k", [1, 5, 13, 14, 26, 27, 51])
def test_radix_stats_equal_jax_radix_and_the_default(monkeypatch, k, n_dev):
    """(gid, order, depth, first_occ) equal the JAX package's
    group_windows_stats(use_jax="radix") and the port's default grouping."""
    codes, starts, _ = _case(100 + k, n_codes=6000, n_windows=5000, k=k)
    want = jax_kmers.group_windows_stats(codes, starts, k, use_jax="radix",
                                         threads=2)
    got = _radix_stats(codes, starts, k, n_dev)
    for name, a, b, c in zip(("gid", "order", "depth", "first_occ"), got,
                             want, _default_stats(codes, starts, k)):
        np.testing.assert_array_equal(a, b, err_msg=name)
        np.testing.assert_array_equal(a, c, err_msg=name)


@pytest.mark.parametrize("case", _adversarial_cases(), ids=lambda c: c[0])
@pytest.mark.parametrize("n_dev", [1, 3, 8])
def test_radix_stats_adversarial(case, n_dev):
    _, codes, starts, k = case
    want = jax_kmers.group_windows_stats(codes, starts, k, use_jax="radix",
                                         threads=1)
    for a, b in zip(_radix_stats(codes, starts, k, n_dev, threads=1), want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n_dev", [1, 3, 8])
def test_radix_rank_view_equals_jax_group_windows(n_dev):
    """The (order, gid_sorted) view the gram and end-repair groupings
    take equals the JAX package's radix group_windows."""
    codes, starts, k = _case(14)
    want_order, want_gid_sorted = jax_kmers.group_windows(
        codes, starts, k, use_jax="radix", threads=2)
    order, gid_sorted = kmers.radix_rank(_t(codes), _t(starts), k, threads=2,
                                         devices=[CPU] * n_dev)
    np.testing.assert_array_equal(order.numpy(), want_order)
    np.testing.assert_array_equal(gid_sorted.numpy(), want_gid_sorted)


def test_radix_rank_records_its_dispatch_and_skips_empty_rows():
    """One dispatch under the JAX package's name, with its shape; one
    k-mer throughout makes one bucket of the 8 rows, and the 7 empty rows
    run nothing (the plain version off the card: one block a real row)."""
    _, codes, starts, k = _adversarial_cases()[0]
    device.reset_counts()
    kmers.radix_rank(_t(codes), _t(starts), k, devices=[CPU] * 8,
                     stats=True)
    summary = device.dp_summary(kmers.RADIX_STATS_DISPATCH)
    assert summary["dispatches"] == 1
    assert summary["windows"] == 492 and summary["devices"] == 8
    assert summary["rows"] == 8
    assert device.work_summary()["sortnet_pack_rank"]["blocks"] == 1


# ---------------------------------------------------------------------------
# the mode switch and the placement
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("value,mode,noted", [
    (None, "default", False), ("", "default", False),
    ("radix", "radix", False), (" RADIX ", "radix", False),
    ("0", "default", False), ("false", "default", False),
    ("no", "default", False), ("off", "default", False),
    ("disabled", "default", False), ("1", "default", False),
    ("true", "default", False), ("yes", "default", False),
    ("on", "default", False), ("pallas", "default", False),
    ("bucketed", "default", False), ("lsd", "default", False),
    ("Direct", "default", False), ("radx", "default", True),
    ("host", "default", True)])
def test_mode_switch(monkeypatch, capsys, value, mode, noted):
    if value is not None:
        monkeypatch.setenv("AUTOCYCLER_DEVICE_GROUPING", value)
    assert kmers.grouping_mode() == mode
    err = capsys.readouterr().err
    assert err.count("unrecognised AUTOCYCLER_DEVICE_GROUPING") == \
        (1 if noted else 0)
    # the JAX package's resolution agrees on what is radix and on the note
    if value is not None and value.strip().lower() not in ("1", "true",
                                                           "yes", "on"):
        assert (jax_kmers._resolve_use_jax(None) == "radix") == \
            (mode == "radix")
        assert ("unrecognised" in capsys.readouterr().err) == noted


def test_shard_leading_axis_places_and_never_degrades():
    codes = torch.arange(10, dtype=torch.uint8)
    mat = torch.arange(24).reshape(6, 4)
    n_real = torch.arange(6)
    reps, mats, reals = shard_leading_axis(codes, mat, n_real,
                                           devices=[CPU] * 3)
    assert len(reps) == len(mats) == len(reals) == 3
    assert all(r is reps[0] for r in reps)      # one copy a distinct device
    assert torch.equal(torch.cat(mats), mat)
    assert torch.equal(torch.cat(reals), n_real)
    assert [len(m) for m in mats] == [2, 2, 2]
    with pytest.raises(ValueError, match="do not split"):
        shard_leading_axis(codes, mat, devices=[CPU] * 4)
    with pytest.raises(ValueError, match="no device"):
        shard_leading_axis(codes, mat, devices=[])


# ---------------------------------------------------------------------------
# compress, end to end
# ---------------------------------------------------------------------------

def _quiet(fn, *args, **kwargs):
    with contextlib.redirect_stderr(io.StringIO()):
        return fn(*args, **kwargs)


@pytest.mark.parametrize("k,threads", [(51, 1), (25, 3)])
def test_radix_compress_writes_the_jax_default_bytes(monkeypatch, tmp_path,
                                                     k, threads):
    """An in-memory compress under radix (the k-mer, gram and end-repair
    h-gram groupings all radix-sharded) writes the JAX package's default
    compress bytes."""
    asm = make_assemblies(tmp_path, n_assemblies=3, chromosome_len=4000,
                          plasmid_len=700, n_snps=3, seed=17)
    _quiet(jax_compress, asm, tmp_path / "jax", k, threads=threads)
    monkeypatch.setenv("AUTOCYCLER_STREAM_KMERS", "off")
    monkeypatch.setenv("AUTOCYCLER_DEVICE_GROUPING", "radix")
    device.reset_counts()
    _quiet(compress, asm, tmp_path / "port", k, threads=threads,
           device="cpu")
    # the index's k-mers with statistics; its grams and the end repair's
    # h-grams without
    assert device.dp_summary(kmers.RADIX_STATS_DISPATCH)["dispatches"] == 1
    assert device.dp_summary(kmers.RADIX_DISPATCH)["dispatches"] == 2
    for name in ("input_assemblies.gfa", "input_assemblies.yaml"):
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name


# ---------------------------------------------------------------------------
# the serve scheduler's lock discipline
# ---------------------------------------------------------------------------

def test_scheduler_declares_the_jax_guarded_fields(tmp_path):
    """The scheduler declares the JAX scheduler's _GUARDED_BY, so the
    locks.guarded-field rule binds to it: the shipped class is clean in
    both packages' engines, and a worker-side write of a guarded field
    outside its lock is found."""
    import textwrap
    from pathlib import Path

    from autocycler_tpu import analysis as jax_analysis
    from autocycler_tpu.serve.scheduler import Scheduler as JaxScheduler
    from autocycler_tpu_torch.analysis import LintContext, run_lint
    from autocycler_tpu_torch.serve import scheduler

    assert scheduler.Scheduler._GUARDED_BY == JaxScheduler._GUARDED_BY
    source = Path(scheduler.__file__).read_text()
    unguarded = source + textwrap.indent(textwrap.dedent("""
        def _forget(self, worker):
            self._busy.pop(worker, None)
            self._next_id += 1
    """), "    ")
    for name, text, n_found in (("shipped.py", source, 0),
                                ("unguarded.py", unguarded, 2)):
        (tmp_path / name).write_text(text)
        port, _ = run_lint([tmp_path / name], LintContext(root=tmp_path),
                           selectors=["locks"])
        jax, _ = jax_analysis.run_lint(
            [tmp_path / name], jax_analysis.LintContext(root=tmp_path),
            selectors=["locks"])
        assert [f.to_dict() for f in port] == [f.to_dict() for f in jax]
        assert [f.rule for f in port] == ["locks.guarded-field"] * n_found
        assert all("'Scheduler." in f.message for f in port)
