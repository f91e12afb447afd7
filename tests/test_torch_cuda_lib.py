"""The CUDA kernels' build rule: a library is rebuilt when its source or
any header beside it (``csrc/*.cuh``) is newer. Runs without ``nvcc``: a
stand-in compiler records each call and writes the library it is asked
for."""

import os
import stat

from byteps_tpu_torch.ops import _cuda_lib


def test_inputs_hold_the_source_and_every_header():
    got = _cuda_lib.inputs("flash_attention")
    headers = sorted(f for f in os.listdir(_cuda_lib.CSRC)
                     if f.endswith(".cuh"))
    assert "hopper.cuh" in headers
    assert got[0] == os.path.join(_cuda_lib.CSRC, "flash_attention.cu")
    assert sorted(os.path.basename(p) for p in got[1:]) == headers
    assert all(os.path.exists(p) for p in got)


def _stand_in_nvcc(tmp_path):
    calls = tmp_path / "calls"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        'while [ $# -gt 0 ]; do [ "$1" = "-o" ] && out="$2"; shift; done\n'
        f'echo lib > "$out"; echo call >> "{calls}"\n')
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    return str(nvcc), calls


def test_an_edited_header_rebuilds(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    src, header = csrc / "k.cu", csrc / "tiles.cuh"
    src.write_text('#include "tiles.cuh"\n')
    header.write_text("// tiles\n")
    nvcc, calls = _stand_in_nvcc(tmp_path)
    monkeypatch.setenv("NVCC", nvcc)
    monkeypatch.setattr(_cuda_lib, "CSRC", str(csrc))
    monkeypatch.setattr(_cuda_lib, "BUILD_DIR", str(tmp_path / "build"))

    def n_calls():
        return len(calls.read_text().splitlines()) if calls.exists() else 0

    for p in (src, header):  # sources older than any library
        os.utime(p, (1, 1))
    lib = _cuda_lib.build("k")
    assert os.path.exists(lib) and n_calls() == 1
    _cuda_lib.build("k")
    assert n_calls() == 1  # fresh: nothing newer than the library
    later = os.path.getmtime(lib) + 10
    os.utime(header, (later, later))  # the header is edited
    _cuda_lib.build("k")
    assert n_calls() == 2
    later = os.path.getmtime(lib) + 10
    os.utime(src, (later, later))  # and the source
    _cuda_lib.build("k")
    assert n_calls() == 3
