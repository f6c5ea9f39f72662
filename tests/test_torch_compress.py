"""The port's compress and decompress as a whole, on the CPU, against the
JAX package: the same synthetic assemblies through both compress commands
must give byte-identical input_assemblies.gfa and .yaml, the port's
decompress must restore the inputs byte for byte, and the port must load a
GFA that the JAX package wrote."""

import contextlib
import io

import pytest

from autocycler_tpu.commands.compress import compress as jax_compress
from autocycler_tpu.commands.decompress import decompress as jax_decompress
from autocycler_tpu_torch.commands.compress import compress
from autocycler_tpu_torch.commands.decompress import decompress
from autocycler_tpu_torch.models import UnitigGraph

from synthetic import make_assemblies

OUTPUTS = ("input_assemblies.gfa", "input_assemblies.yaml")


def _quiet(fn, *args, **kwargs):
    with contextlib.redirect_stderr(io.StringIO()):
        fn(*args, **kwargs)


def _same_dir(a, b):
    """The same tree; the same bytes in every file but the warm-start cache
    entries, whose zip members carry their write time."""
    names = sorted(str(p.relative_to(a)) for p in a.rglob("*"))
    assert names == sorted(str(p.relative_to(b)) for p in b.rglob("*"))
    for n in names:
        if (a / n).is_file() and not n.startswith(".cache"):
            assert (a / n).read_bytes() == (b / n).read_bytes(), n


@pytest.mark.parametrize("k", (51, 11))
@pytest.mark.parametrize("seed,n_snps", [(42, 0), (7, 0), (13, 5)])
def test_compress_byte_identical_to_jax(tmp_path, seed, n_snps, k):
    asm = make_assemblies(tmp_path, seed=seed, n_snps=n_snps)
    _quiet(jax_compress, asm, tmp_path / "jax", k, threads=1)
    _quiet(compress, asm, tmp_path / "port", k, device="cpu")
    for name in OUTPUTS:
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name
    _quiet(decompress, tmp_path / "port" / "input_assemblies.gfa",
           tmp_path / "recon")
    _same_dir(asm, tmp_path / "recon")


def test_port_loads_jax_written_gfa(tmp_path):
    asm = make_assemblies(tmp_path, seed=3, n_snps=3, chromosome_len=4000)
    _quiet(jax_compress, asm, tmp_path / "jax", 51, threads=1)
    gfa = tmp_path / "jax" / "input_assemblies.gfa"
    graph, sequences = UnitigGraph.from_gfa_file(gfa)
    assert graph.gfa_text(sequences) == gfa.read_text()
    _quiet(decompress, gfa, tmp_path / "port_recon")
    _quiet(jax_decompress, gfa, tmp_path / "jax_recon")
    _same_dir(tmp_path / "jax_recon", tmp_path / "port_recon")
    _same_dir(asm, tmp_path / "port_recon")
    _quiet(decompress, gfa, None, tmp_path / "all.fasta")
    _quiet(jax_decompress, gfa, None, tmp_path / "all_jax.fasta")
    assert (tmp_path / "all.fasta").read_bytes() == \
        (tmp_path / "all_jax.fasta").read_bytes()


@pytest.mark.parametrize("kmer,message", [(12, "must be odd"),
                                          (9, "less than 11"),
                                          (503, "greater than 501")])
def test_compress_flag_errors_match_jax(tmp_path, kmer, message):
    from autocycler_tpu.utils import AutocyclerError as JaxError
    from autocycler_tpu_torch.utils import AutocyclerError
    asm = make_assemblies(tmp_path)
    with pytest.raises(AutocyclerError, match=message) as got:
        compress(asm, tmp_path / "out", kmer, device="cpu")
    with pytest.raises(JaxError) as exp:
        jax_compress(asm, tmp_path / "out_jax", kmer, threads=1)
    assert str(got.value) == str(exp.value)


def test_compress_threads_validated_and_inert(tmp_path):
    from autocycler_tpu_torch.utils import AutocyclerError
    asm = make_assemblies(tmp_path, seed=5)
    with pytest.raises(AutocyclerError, match="--threads"):
        compress(asm, tmp_path / "bad", threads=0, device="cpu")
    _quiet(compress, asm, tmp_path / "t1", threads=1, device="cpu")
    _quiet(compress, asm, tmp_path / "t8", threads=8, device="cpu")
    _same_dir(tmp_path / "t1", tmp_path / "t8")
