"""The port's dataset builder (``data.remote``) against the JAX package's,
on the CPU, driven by ``tests/test_remote_etl.py``'s xarray-like fakes.

Both packages write byte-identical ``data.npy``, ``dataset_info.json``,
``coords.npz``, ``variables.json`` and ``scalers.npz`` for a whole build,
for a build cut by a failing read (then ``progress.json`` too) and
resumed, and for ``RegionSource`` cuts (the ARCO and CDS region
builders); ``.npz`` files are compared member by member, byte for byte
(the zip headers carry the time they were written).  ``main``'s four
subcommands run with the network openers monkeypatched, and the gated
openers raise where xarray is missing.  The port's dataset loader reads
what the port wrote as the JAX package's loader does.
"""

import filecmp
import os
import zipfile

import numpy as np
import pytest

import graphcast_lite_tpu.data.remote as jremote
import graphcast_lite_torch.data.remote as premote
from test_remote_etl import FlakySource, make_fake_cds, make_fake_wb2
from torch_port_common import \
    one_torch_thread  # noqa: F401 (an autouse fixture)

PACKAGES = (("port", premote), ("jax", jremote))


def _same_file(a, b):
    if a.endswith(".npz"):
        with zipfile.ZipFile(a) as za, zipfile.ZipFile(b) as zb:
            assert za.namelist() == zb.namelist(), a
            for name in za.namelist():
                assert za.read(name) == zb.read(name), f"{a}:{name}"
    else:
        assert filecmp.cmp(a, b, shallow=False), a


def _same_dirs(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    for name in names:
        _same_file(os.path.join(a, name), os.path.join(b, name))
    return names


def test_whole_build_byte_equal(tmp_path):
    ds = make_fake_wb2()
    out = {}
    for name, mod in PACKAGES:
        out[name] = mod.build_dataset_wb2(
            str(tmp_path / name), open_fn=lambda url, t0, t1: ds,
            time_chunk=5, time_start="2010-01-01", time_end="2010-01-03")
    assert _same_dirs(out["port"], out["jax"]) == [
        "coords.npz", "data.npy", "dataset_info.json", "scalers.npz",
        "variables.json"]


def test_resumed_build_byte_equal(tmp_path):
    """A build cut after two of three chunks, then resumed: the cut
    state (progress.json included) and the finished set are equal."""
    base = {name: mod.WB2Source(make_fake_wb2()) for name, mod in PACKAGES}
    flaky, dirs = {}, {}
    for name, mod in PACKAGES:
        flaky[name] = FlakySource(base[name], fail_at_t0=8)
        dirs[name] = str(tmp_path / name)
        with pytest.raises(ConnectionError):
            mod.stream_build_dataset(flaky[name], dirs[name], time_chunk=4)
    assert _same_dirs(dirs["port"], dirs["jax"]) == ["data.npy",
                                                     "progress.json"]
    for name, mod in PACKAGES:
        flaky[name].fail_at = None
        flaky[name].read_log.clear()
        mod.stream_build_dataset(flaky[name], dirs[name], time_chunk=4,
                                 resume=True)
    assert flaky["port"].read_log == flaky["jax"].read_log
    assert sorted({t0 for _, t0, _ in flaky["port"].read_log}) == [4, 8]
    assert "progress.json" not in _same_dirs(dirs["port"], dirs["jax"])


def test_region_builds_byte_equal(tmp_path):
    wb2, cds = make_fake_wb2(n_lat=16, n_lon=32), make_fake_cds()
    for name, mod in PACKAGES:
        region = mod.RegionSource(mod.WB2Source(wb2), 20.0, 70.0, 60.0,
                                  120.0)
        mod.stream_build_dataset(region, str(tmp_path / name / "cut"),
                                 time_chunk=5)
        mod.build_region_arco(str(tmp_path / name / "arco"),
                              (20, 70, 60, 120),
                              open_fn=lambda a, t0, t1: wb2)
        mod.build_region_cds(str(tmp_path / name / "cds"), (45, 60, 70, 100),
                             open_fn=lambda paths: cds)
    for sub in ("cut", "arco", "cds"):
        _same_dirs(str(tmp_path / "port" / sub), str(tmp_path / "jax" / sub))
    c = np.load(str(tmp_path / "port" / "cut" / "coords.npz"))
    assert (c["latitude"] >= 20).all() and (c["longitude"] <= 120).all()


SUBCOMMANDS = {
    "build-wb2": ("open_wb2", []),
    "build-512x256": ("open_wb2", []),
    "build-region-arco": ("open_arco", ["--area", "20", "70", "60", "120"]),
    "build-region-cds": ("open_cds_netcdf",
                         ["--area", "20", "70", "60", "120", "--nc",
                          "a.nc", "b.nc"]),
}


@pytest.mark.parametrize("cmd", sorted(SUBCOMMANDS))
def test_main_subcommands(cmd, tmp_path, monkeypatch, capsys):
    opener, extra = SUBCOMMANDS[cmd]
    ds = make_fake_wb2(n_lat=16, n_lon=32)
    for name, mod in PACKAGES:
        monkeypatch.setattr(mod, opener, lambda *args: ds)
        out = str(tmp_path / name)
        assert mod.main([cmd, "--out", out, "--time-chunk", "5"]
                        + extra) == 0
    assert f"dataset complete: {tmp_path / 'port'}" in capsys.readouterr().out
    _same_dirs(str(tmp_path / "port"), str(tmp_path / "jax"))

    # Without the network's packages the gated openers raise.
    monkeypatch.undo()
    try:
        import xarray  # noqa: F401
    except ImportError:
        with pytest.raises(RuntimeError, match="zero-egress"):
            premote.main([cmd, "--out", str(tmp_path / "x")] + extra)


def test_port_loader_reads_the_build(tmp_path):
    from graphcast_lite_tpu.data.dataset import \
        load_chunked_datasets as jload
    from graphcast_lite_torch.data.dataset import load_chunked_datasets

    out = premote.build_dataset_512x256(
        str(tmp_path / "wb2"), open_fn=lambda u, t0, t1: make_fake_wb2(),
        time_chunk=5)
    kw = dict(obs_window=2, pred_steps=2, n_features=19)
    port, jax = load_chunked_datasets(out, **kw), jload(out, **kw)
    assert port[3].num_latitudes == 8 and port[3].num_longitudes == 16
    for p_ds, j_ds in zip(port[:3], jax[:3]):
        assert len(p_ds) == len(j_ds)
        for i in range(len(p_ds)):
            for a, b in zip(p_ds.get(i), j_ds.get(i)):
                assert a.shape == (8 * 16, 2 * 19)
                np.testing.assert_array_equal(a, b)
