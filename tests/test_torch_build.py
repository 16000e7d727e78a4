"""The CUDA build helper's library key (no compiler needed): a library's
path changes when its source or any shared header under ``csrc/``
changes, so an edited header never reuses a stale library."""
import os
import shutil

from repro_torch.kernels import cuda_build


def test_library_path_hashes_source_and_headers(tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC, csrc)
    headers = sorted(p for p in os.listdir(csrc) if p.endswith(".cuh"))
    assert headers, "the kernels share a header under csrc/"
    sources = sorted(p for p in os.listdir(csrc) if p.endswith(".cu"))
    before = {s: cuda_build._library_path(s, str(csrc)) for s in sources}
    # the copy keys like the package's own sources
    assert before == {s: cuda_build._library_path(s) for s in sources}
    with open(csrc / headers[0], "a") as f:
        f.write("\n// edited\n")
    after = {s: cuda_build._library_path(s, str(csrc)) for s in sources}
    assert all(after[s] != before[s] for s in sources)
    with open(csrc / sources[0], "a") as f:
        f.write("\n// edited\n")
    again = cuda_build._library_path(sources[0], str(csrc))
    assert again != after[sources[0]]
    assert cuda_build._library_path(sources[1], str(csrc)) == after[sources[1]]
    assert os.path.basename(again).startswith(
        "lib" + os.path.splitext(sources[0])[0] + "_")
