"""The kernel timing scripts' cut variants
(``scripts/torch_edge_step_split.py``, ``scripts/torch_edge_mlp_time.py``)
against the current kernel sources:
every text edit finds its anchor exactly as often as it expects, over the
source and the package's headers together (``nvcc_build.edited_copy``),
so a kernel change that moves an anchor fails here and not on the card."""

import importlib.util
import os

import pytest

from graphcast_lite_torch.ops import edge_mlp, edge_step, nvcc_build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script(name):
    path = os.path.join(REPO, "scripts", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("script,source,tables", [
    ("torch_edge_step_split", edge_step.SOURCE,
     ("CURRENT_VARIANTS", "F32_VARIANTS")),
    ("torch_edge_mlp_time", edge_mlp.SOURCE,
     ("BF16_VARIANTS", "F32_VARIANTS")),
])
def test_cut_variants_apply_to_the_current_sources(tmp_path, script, source,
                                                   tables):
    mod = _script(script)
    with open(source) as f:
        text = f.read()
    headers = sorted(os.path.basename(p) for p in os.listdir(nvcc_build.CSRC)
                     if p.endswith(".cuh"))
    for table in tables:
        for name, edits in getattr(mod, table).items():
            path = nvcc_build.edited_copy(str(tmp_path), f"{table}_{name}",
                                          text, edits)
            vdir = os.path.dirname(path)
            assert sorted(p for p in os.listdir(vdir)
                          if p.endswith(".cuh")) == headers
            with open(path) as f:
                cut = f.read()
            changed = cut != text or any(
                open(os.path.join(vdir, h)).read()
                != open(os.path.join(nvcc_build.CSRC, h)).read()
                for h in headers)
            assert changed, f"{table} {name} cut nothing"


def test_edited_copy_counts_over_source_and_headers(tmp_path):
    """An anchor in a header counts; one found another number of times
    raises; the original headers stay as they are."""
    text = "#include \"hopper.cuh\"\nint x = 1;\n"
    path = nvcc_build.edited_copy(
        str(tmp_path), "v", text,
        [("int x = 1;", "int x = 2;", 1),
         ("constexpr int kF32Threads = 256;",
          "constexpr int kF32Threads = 128;", 1)])
    vdir = os.path.dirname(path)
    assert open(path).read().endswith("int x = 2;\n")
    assert "kF32Threads = 128;" in open(os.path.join(vdir,
                                                     "hopper.cuh")).read()
    assert "kF32Threads = 256;" in open(os.path.join(nvcc_build.CSRC,
                                                     "hopper.cuh")).read()
    with pytest.raises(RuntimeError, match="found 0 times, not 1"):
        nvcc_build.edited_copy(str(tmp_path), "w", text,
                               [("int y", "int z", 1)])


def test_edited_copy_takes_an_earlier_trees_headers(tmp_path):
    """A source builds with the headers of the directory given (an earlier
    tree's csrc/), and with the package's where that holds none."""
    old = tmp_path / "old"
    old.mkdir()
    (old / "hopper.cuh").write_text("// an earlier hopper.cuh\n")
    path = nvcc_build.edited_copy(str(tmp_path / "out"), "old", "int x;\n",
                                  [], str(old))
    vdir = os.path.dirname(path)
    assert sorted(p for p in os.listdir(vdir) if p.endswith(".cuh")) == [
        "hopper.cuh"]
    assert open(os.path.join(vdir, "hopper.cuh")).read() == (
        "// an earlier hopper.cuh\n")
    path = nvcc_build.edited_copy(str(tmp_path / "out"), "bare", "int x;\n",
                                  [], str(tmp_path / "out"))
    assert "edge_tile.cuh" in os.listdir(os.path.dirname(path))


def test_segment_split_edits_apply_to_the_current_source():
    """``scripts/torch_segment_split.py``: every knob's constant is in the
    current ``segment_sum.cu`` once, and the timeline instrumentation of
    the balanced and narrow kernels finds each of its anchors once."""
    import re

    from graphcast_lite_torch.ops import cuda_segment

    mod = _script("torch_segment_split")
    with open(cuda_segment.SOURCE) as f:
        text = f.read()
    for name in mod._KNOBS.values():
        assert len(re.findall(rf"constexpr int {name} = \d+;", text)) == 1
    timeline = mod._timeline_text(text)
    for anchor, n in (("const unsigned long long t_entry = now_ns();", 2),
                      ("const unsigned long long t_walk = now_ns();", 1),
                      ("if (t_walk == 0) t_walk = now_ns();", 1),
                      ("g_timeline + 5 * blockIdx.x", 1),
                      ("g_timeline + 5 * k", 1)):
        assert timeline.count(anchor) == n, anchor
    assert "gclt_timeline_clear" in timeline
