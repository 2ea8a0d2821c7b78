"""`repro_torch.kernels.build`: a kernel's library is named by a digest of
every file in its ``csrc/``, of the shared headers of ``kernels/include/``
it includes and of the compiler flags, so an edited header rebuilds the
kernels that use it and no other; run on copies of the kernel sources
under ``tmp_path`` with a stand-in compiler (there is no ``nvcc`` here)."""
import os
import shutil
import stat
import sys

import pytest

from repro_torch.kernels import build


@pytest.fixture
def kernels(tmp_path, monkeypatch):
    """A kernels directory holding a copy of flash_attention's csrc, and a
    build directory, both under tmp_path."""
    csrc = tmp_path / "kernels" / "flash_attention" / "csrc"
    shutil.copytree(build.KERNELS_DIR / "flash_attention" / "csrc", csrc)
    monkeypatch.setattr(build, "KERNELS_DIR", tmp_path / "kernels")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    return csrc


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """A stand-in compiler that writes its -o target and logs each call."""
    log = tmp_path / "nvcc.log"
    script = tmp_path / "nvcc"
    script.write_text(
        f"#!{sys.executable}\n"
        "import sys\n"
        "args = sys.argv[1:]\n"
        f"open({str(log)!r}, 'a').write(' '.join(args) + '\\n')\n"
        "open(args[args.index('-o') + 1], 'w').write('lib')\n"
        "print('ptxas info    : Used 1 registers')\n")
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(build, "_nvcc", lambda: str(script))
    return log


def _calls(log):
    return log.read_text().splitlines() if log.exists() else []


def test_library_path_digests_every_csrc_file_and_the_flags(kernels,
                                                             monkeypatch):
    assert set(build.sources()) == {"flash_attention"}
    first = build.library_path("flash_attention")
    assert first.parent == build.BUILD_DIR
    assert build.library_path("flash_attention") == first      # stable
    header = kernels / "flash_simt.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    edited = build.library_path("flash_attention")
    assert edited != first
    (kernels / "extra.cuh").write_text("// a new header\n")
    added = build.library_path("flash_attention")
    assert added != edited
    os.replace(kernels / "extra.cuh", kernels / "other.cuh")    # renamed
    assert build.library_path("flash_attention") != added
    monkeypatch.setattr(build, "NVCC_FLAGS",
                        build.NVCC_FLAGS + ("-I/usr/local/cutlass/include",))
    assert build.library_path("flash_attention") not in (first, edited,
                                                         added)


@pytest.fixture
def three_kernels(tmp_path, monkeypatch):
    """A kernels directory holding copies of the flash- and paged-attention
    and vadvc sources and of the shared headers."""
    root = tmp_path / "kernels"
    for name in ("flash_attention", "paged_attention", "vadvc"):
        shutil.copytree(build.KERNELS_DIR / name / "csrc",
                        root / name / "csrc")
    shutil.copytree(build.include_dir(), root / "include")
    monkeypatch.setattr(build, "KERNELS_DIR", root)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    return root


def test_shared_header_edit_changes_only_the_kernels_that_include_it(
        three_kernels):
    names = ("flash_attention", "paged_attention", "vadvc")
    header = three_kernels / "include" / "hopper.cuh"
    for name in ("flash_attention", "paged_attention"):
        assert build.shared_headers(name) == [header]
    assert build.shared_headers("vadvc") == []
    before = {n: build.library_path(n) for n in names}
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: build.library_path(n) for n in names}
    assert after["flash_attention"] != before["flash_attention"]
    assert after["paged_attention"] != before["paged_attention"]
    assert after["vadvc"] == before["vadvc"]


def test_build_all_puts_the_shared_headers_on_the_include_path(
        three_kernels, fake_nvcc):
    build.build_all()
    calls = _calls(fake_nvcc)
    assert len(calls) == 3
    assert all(f"-I {three_kernels / 'include'} " in c for c in calls)


def test_build_all_rebuilds_after_a_header_edit_only(kernels, fake_nvcc):
    libs = build.build_all()
    assert libs["flash_attention"].exists() and len(_calls(fake_nvcc)) == 1
    assert (build.BUILD_DIR / "flash_attention.log").read_text().strip() \
        == "ptxas info    : Used 1 registers"
    assert build.build_all() == libs and len(_calls(fake_nvcc)) == 1
    header = kernels / "flash_simt.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    rebuilt = build.build_all()
    assert len(_calls(fake_nvcc)) == 2
    assert rebuilt["flash_attention"] != libs["flash_attention"]
    assert rebuilt["flash_attention"].exists()
    assert _calls(fake_nvcc)[-1].endswith(
        str(kernels / "flash_attention.cu"))
