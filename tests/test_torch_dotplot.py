"""The port's dotplot command against the JAX package's on the CPU: the
same match arrays, element for element and in the same order, from the
sort-join and from the device grid, and byte-identical PNGs for FASTA,
directory and GFA input in both grid modes."""

import contextlib
import io

import numpy as np
import pytest

from autocycler_tpu.commands import dotplot as jdot
from autocycler_tpu.commands.cluster import cluster as jax_cluster
from autocycler_tpu.commands.compress import compress as jax_compress
from autocycler_tpu_torch.commands import dotplot as dot
from autocycler_tpu_torch.utils import AutocyclerError

from synthetic import make_assemblies

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)


def _seq(rng, n):
    return ACGT[rng.integers(0, 4, size=n)]


def _revcomp(s):
    return np.frombuffer(bytes(s[::-1]).translate(
        bytes.maketrans(b"ACGT", b"TGCA")), dtype=np.uint8)


def _pairs():
    rng = np.random.default_rng(11)
    a = _seq(rng, 900)
    repeat = _seq(rng, 40)
    with_repeats = np.concatenate([repeat, a[:300], repeat, _revcomp(repeat),
                                   a[500:800], repeat])
    return {
        "self": (a, a, 12),
        "rotated": (a, np.concatenate([a[400:], a[:400]]), 16),
        "revcomp": (a, _revcomp(a), 32),
        "repeats": (with_repeats, a, 10),
        "poly-T": (np.full(300, ord("T"), np.uint8),
                   np.full(200, ord("T"), np.uint8), 16),
        "shorter than k": (a[:20], a, 32),
    }


def _assert_same(got, want):
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.dtype.is_floating_point is False
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("name", list(_pairs()))
def test_sort_join_matches_jax(name):
    a, b, k = _pairs()[name]
    _assert_same(dot.kmer_match_positions(a, b, k, device="cpu"),
                 jdot.kmer_match_positions(a, b, k))


@pytest.mark.parametrize("name", ["rotated", "revcomp", "poly-T"])
def test_device_grid_matches_jax(name):
    a, b, k = _pairs()[name]
    got = dot.kmer_match_positions_device(a, b, k, device="cpu")
    _assert_same(got, jdot.kmer_match_positions_device(a, b, k))
    # the same matches as the sort-join, in the grid's tile order
    host = dot.kmer_match_positions(a, b, k, device="cpu")
    for g, h in zip((got[:2], got[2:]), (host[:2], host[2:])):
        assert sorted(zip(*[t.tolist() for t in g])) == \
            sorted(zip(*[t.tolist() for t in h]))


def test_device_grid_declines_non_acgt():
    seq = np.frombuffer(b"ACGTNNNNACGTACGTACGT", dtype=np.uint8)
    assert dot.kmer_match_positions_device(seq, seq, 10, device="cpu") is None
    assert jdot.kmer_match_positions_device(seq, seq, 10) is None


def _quiet(fn, *args, **kwargs):
    with contextlib.redirect_stderr(io.StringIO()):
        fn(*args, **kwargs)


def _fasta(tmp_path, seed=5, n=700, rotate=300):
    rng = np.random.default_rng(seed)
    s1 = bytes(_seq(rng, n)).decode()
    fasta = tmp_path / "seqs.fasta"
    fasta.write_text(f">s1\n{s1}\n>s2\n{s1[rotate:] + s1[:rotate]}\n")
    return fasta


def _directory(tmp_path):
    rng = np.random.default_rng(8)
    s = bytes(_seq(rng, 600)).decode()
    d = tmp_path / "asm"
    d.mkdir()
    (d / "a.fasta").write_text(f">x\n{s}\n")
    (d / "b.fasta").write_text(
        f">y\n{bytes(_revcomp(np.frombuffer(s.encode(), np.uint8))).decode()}\n")
    return d


def _gfa(tmp_path):
    asm = make_assemblies(tmp_path, n_assemblies=2, chromosome_len=3000,
                          plasmid_len=600, seed=4)
    _quiet(jax_compress, asm, tmp_path / "out", 51, threads=1)
    _quiet(jax_cluster, tmp_path / "out")
    return tmp_path / "out/clustering/qc_pass/cluster_002/1_untrimmed.gfa"


@pytest.mark.parametrize("source", ["fasta", "directory", "gfa"])
def test_png_byte_identical_to_jax(tmp_path, source):
    path = {"fasta": _fasta, "directory": _directory, "gfa": _gfa}[source](
        tmp_path)
    res, k = 600, 12
    want = tmp_path / "jax.png"
    # the JAX package's device mode writes the same bytes as its host mode
    # (tests/test_dotplot.py); its match arrays are held against the port's
    # in test_device_grid_matches_jax
    _quiet(jdot.dotplot, path, want, res=res, kmer=k, grid_mode="host")
    for mode in ("auto", "host", "device"):
        got = tmp_path / f"port_{mode}.png"
        _quiet(dot.dotplot, path, got, res=res, kmer=k, grid_mode=mode,
               device="cpu")
        assert got.read_bytes() == want.read_bytes(), mode


@pytest.mark.parametrize("kwargs,message", [
    (dict(res=499), "--res cannot be less than 500"),
    (dict(res=10001), "--res cannot be greater than 10000"),
    (dict(kmer=9), "--kmer cannot be less than 10"),
    (dict(kmer=101), "--kmer cannot be greater than 100"),
    (dict(grid_mode="tpu"), "--grid-mode must be auto, host or device"),
])
def test_flag_errors_match_jax(tmp_path, kwargs, message):
    from autocycler_tpu.utils import AutocyclerError as JaxError
    fasta = _fasta(tmp_path)
    with pytest.raises(AutocyclerError) as got:
        dot.dotplot(fasta, tmp_path / "p.png", device="cpu", **kwargs)
    with pytest.raises(JaxError) as want:
        jdot.dotplot(fasta, tmp_path / "q.png", **kwargs)
    assert str(got.value) == str(want.value) == message


def test_input_errors_match_jax(tmp_path):
    from autocycler_tpu.utils import AutocyclerError as JaxError
    bad = tmp_path / "bad.txt"
    bad.write_text("hello\n")
    for path in (bad, tmp_path / "missing"):
        with pytest.raises(AutocyclerError) as got:
            dot.dotplot(path, tmp_path / "p.png", device="cpu")
        with pytest.raises(JaxError) as want:
            jdot.dotplot(path, tmp_path / "q.png")
        assert str(got.value) == str(want.value)


def test_bundled_font_is_the_ports_own(monkeypatch, tmp_path):
    monkeypatch.delenv("AUTOCYCLER_DOTPLOT_FONT", raising=False)
    path = dot._find_font()
    assert path is not None and path.endswith(
        "autocycler_tpu_torch/assets/DejaVuSans.ttf")
    with open(path, "rb") as f, open(jdot._find_font(), "rb") as g:
        assert f.read() == g.read()
    monkeypatch.setenv("AUTOCYCLER_DOTPLOT_FONT", path)
    assert dot._find_font() == path
    monkeypatch.setenv("AUTOCYCLER_DOTPLOT_FONT", str(tmp_path / "none.ttf"))
    assert dot._find_font().endswith("autocycler_tpu_torch/assets/DejaVuSans.ttf")
