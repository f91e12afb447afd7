"""The build-freshness rule the port's CUDA kernels and C core share:
a library is rebuilt when a source is newer, when the compiler or its
flags change, and when it has no stamp."""

import os

from byteps_tpu_torch.core.build import install, is_fresh


def test_library_is_fresh_only_for_the_same_key_and_older_sources(tmp_path):
    src = tmp_path / "k.cu"
    src.write_text("// source")
    lib = str(tmp_path / "libk.so")
    assert not is_fresh(lib, [str(src)], "nvcc -O3")  # nothing built
    tmp = lib + ".1.tmp"
    with open(tmp, "w") as f:
        f.write("lib")
    os.utime(src, (1, 1))  # the source predates the library
    install(tmp, lib, "nvcc -O3")
    assert not os.path.exists(tmp)
    assert is_fresh(lib, [str(src)], "nvcc -O3")
    assert not is_fresh(lib, [str(src)], "nvcc -O2")  # other flags
    assert not is_fresh(lib, [str(src)], "/other/nvcc -O3")  # other nvcc
    later = os.path.getmtime(lib) + 10
    os.utime(src, (later, later))  # an edited source
    assert not is_fresh(lib, [str(src)], "nvcc -O3")
    os.utime(src, (1, 1))
    os.remove(lib + ".stamp")  # built before stamps were kept
    assert not is_fresh(lib, [str(src)], "nvcc -O3")
