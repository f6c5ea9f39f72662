"""What the port may not do: import jax or the JAX package, carry on on the
CPU when the CLI finds no CUDA device, or fall back from its kernel to the
plain version for a tensor that is not on the card."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "autocycler_tpu_torch"
FORBIDDEN_IMPORT = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|autocycler_tpu)(?:\.|\s|$)", re.MULTILINE)


def test_port_runs_compress_without_jax(tmp_path):
    from synthetic import make_assemblies
    asm = make_assemblies(tmp_path, n_assemblies=2, chromosome_len=3000,
                          plasmid_len=500)
    code = (
        "import sys\n"
        "from autocycler_tpu_torch.commands.compress import compress\n"
        "from autocycler_tpu_torch.commands.decompress import decompress\n"
        f"compress({str(asm)!r}, {str(tmp_path / 'out')!r}, device='cpu')\n"
        f"decompress({str(tmp_path / 'out' / 'input_assemblies.gfa')!r}, "
        f"{str(tmp_path / 'recon')!r})\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'autocycler_tpu' or m.startswith('autocycler_tpu.')]\n"
        "print('LOADED', bad)\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO)] + ([os.environ["PYTHONPATH"]]
                       if os.environ.get("PYTHONPATH") else [])))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "LOADED []" in res.stdout
    assert (tmp_path / "recon" / "assembly_1.fasta").read_bytes() == \
        (asm / "assembly_1.fasta").read_bytes()


def test_no_port_file_imports_jax_or_the_jax_package():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    offenders = [str(f.relative_to(REPO)) for f in files
                 if FORBIDDEN_IMPORT.search(f.read_text())]
    assert offenders == []


def test_cli_without_cuda_exits_1(tmp_path, monkeypatch, capsys):
    from synthetic import make_assemblies

    from autocycler_tpu_torch import cli
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    asm = make_assemblies(tmp_path, n_assemblies=2, chromosome_len=3000,
                          plasmid_len=500)
    rc = cli.main(["compress", "-i", str(asm), "-a", str(tmp_path / "out")])
    assert rc == 1
    err = capsys.readouterr().err
    assert "Error:" in err and "CUDA" in err
    assert not (tmp_path / "out" / "input_assemblies.gfa").exists()


def test_cli_reports_user_errors(tmp_path, capsys):
    from autocycler_tpu_torch import cli
    rc = cli.main(["decompress", "-i", str(tmp_path / "missing.gfa"),
                   "-o", str(tmp_path / "o")])
    assert rc == 1
    assert "Error: file does not exist" in capsys.readouterr().err


def test_kernel_wrapper_raises_on_cpu_tensor():
    from autocycler_tpu_torch.ops import sortnet
    codes = torch.zeros(100, dtype=torch.uint8)
    starts = torch.arange(10, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        sortnet.pack_rank_cuda(codes, starts, 11)


def test_device_resolution(monkeypatch):
    from autocycler_tpu_torch import device
    from autocycler_tpu_torch.utils import AutocyclerError
    assert device.resolve_device("cpu").type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(AutocyclerError, match="CUDA"):
        device.resolve_device(None)
    with pytest.raises(AutocyclerError, match="CUDA"):
        device.resolve_device("cuda")
    with pytest.raises(AutocyclerError, match="unsupported"):
        device.resolve_device("meta")


def test_build_paths_are_git_ignored():
    from autocycler_tpu_torch.ops import _build
    assert _build.BUILD_DIR.parent == PORT
    ignored = (REPO / ".gitignore").read_text().splitlines()
    assert "autocycler_tpu_torch/_build/" in ignored
    assert (_build.CSRC_DIR / "sortnet.cu").is_file()
