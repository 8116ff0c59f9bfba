"""The post-processing ladder and the regional pipelines in the port against
the JAX package, on the CPU.

* ``cli.evaluate_pipeline --device cpu`` on ``tests/test_pipeline_ladder.py``'s
  layout (the JAX suite's ``small_experiment``: ConvGCN on 16 x 8, a
  static and a forcing channel, the JAX ``best_model.msgpack``): every
  rung of ``pipeline_eval.json`` against the JAX CLI's at rtol 1e-4,
  without and with ``--unet-exp`` (a ``DownscalerUNet`` saved bare as the
  JAX CLI reads it); the port's own ``best_model.pt`` of a
  ``GridImageModel`` around the same U-Net gives the same rungs bitwise.
  On the planted-drift set the post-processing rungs remove the bias.
* ``crop_region``, ``interpolate_to_region`` and ``blend_with_background``
  are NumPy copies: bitwise equal.  ``cascade_refine`` with the JAX and
  the port ``DownscalerUNet`` on bridged weights: the U-Net's part within
  the forward tolerance of ``tests/test_torch_port_unet.py`` (1e-5 of its
  largest value).
"""

import json
import os

import numpy as np
import pytest
import torch

from torch_port_common import jax_params, \
    one_torch_thread  # noqa: F401 (one_torch_thread: an autouse fixture)

LADDER_RTOL = 1e-4
FWD_RTOL = 1e-5


def _experiment(tmp_path, **data_kw):
    """``small_experiment``'s config and dataset in an experiment
    directory, with the JAX package's random-init params saved."""
    import jax

    from graphcast_lite_tpu.data.synthetic import generate_synthetic_dataset
    from graphcast_lite_tpu.training.checkpoint import save_params
    from test_training import small_experiment

    cfg, model, graphs, _, _, _, meta = small_experiment(tmp_path, max_ar=2)
    data_dir = str(tmp_path / "data")
    if data_kw:
        generate_synthetic_dataset(
            data_dir, n_time=30, n_lon=16, n_lat=8, n_feat=5,
            static_channels=[3], forcing_channels=[4], **data_kw)
    exp = tmp_path / "exp"
    exp.mkdir()
    cfg = cfg.model_copy(update={"data_dir": data_dir})
    (exp / "config.json").write_text(cfg.model_dump_json(indent=1))
    dummy = np.zeros((meta.num_latitudes * meta.num_longitudes, 10),
                     np.float32)
    save_params(str(exp / "best_model.msgpack"),
                model.init(jax.random.PRNGKey(0), dummy, graphs))
    return str(exp), data_dir, meta


def _ladders(exp, argv):
    """pipeline_eval.json of the JAX CLI and of the port's on ``exp``."""
    from graphcast_lite_tpu.cli import evaluate_pipeline as jax_cli
    from graphcast_lite_torch.cli import evaluate_pipeline

    path = os.path.join(exp, "pipeline_eval.json")
    jax_cli.main([exp] + argv)
    with open(path) as f:
        ref = json.load(f)
    port = evaluate_pipeline.main([exp, "--device", "cpu"] + argv)
    with open(path) as f:
        assert json.load(f) == json.loads(json.dumps(port))
    return port, ref


def _assert_ladders(port, ref):
    assert list(port) == list(ref)
    for name, r in ref.items():
        p = port[name]
        for key in ("rmse", "skill", "acc"):
            np.testing.assert_allclose(p[key], r[key], rtol=LADDER_RTOL,
                                       err_msg=f"{name} {key}")
        assert len(p["per_horizon"]) == len(r["per_horizon"])
        for hp, hr in zip(p["per_horizon"], r["per_horizon"]):
            for key in ("rmse", "baseline_rmse", "skill", "acc"):
                np.testing.assert_allclose(hp[key], hr[key],
                                           rtol=LADDER_RTOL,
                                           err_msg=f"{name} {key}")


def test_ladder_matches_jax(tmp_path):
    exp, data_dir, _ = _experiment(tmp_path)
    port, ref = _ladders(exp, [
        "--data-dir", data_dir, "--ar-steps", "2", "--max-samples", "3",
        "--mos-calibration", "2", "--t2m-channel", "0",
        "--zsurf-channel", "3"])
    assert {"raw", "+nudging", "+oi", "+lapse", "+mos", "+idw",
            "+lapse+mos+idw"} == set(port)
    _assert_ladders(port, ref)
    assert all(np.isfinite(r["rmse"]) for r in port.values())


def test_ladder_cascade_matches_jax(tmp_path):
    """The cascade rungs from a bare ``DownscalerUNet`` msgpack (the JAX
    CLI's layout), then from the port's ``best_model.pt`` of a
    ``GridImageModel`` around the same U-Net."""
    from flax import serialization

    from graphcast_lite_tpu.models.unet import DownscalerUNet as JaxUNet
    from graphcast_lite_torch.models.grid_adapter import GridImageModel
    from graphcast_lite_torch.models.unet import DownscalerUNet
    from graphcast_lite_torch.utils.params import from_flax_image_params

    exp, data_dir, meta = _experiment(tmp_path)
    h, w, c = meta.num_latitudes, meta.num_longitudes, 5
    uparams = jax_params(JaxUNet(out_channels=c, base_filters=8),
                         np.zeros((1, h, w, c), np.float32), seed=3)
    unet_dir = os.path.join(exp, "unet")
    os.makedirs(unet_dir)
    with open(os.path.join(unet_dir, "best_model.msgpack"), "wb") as f:
        f.write(serialization.to_bytes(uparams))
    with open(os.path.join(unet_dir, "config.json"), "w") as f:
        json.dump({"base_filters": 8, "num_features": c}, f)
    argv = ["--data-dir", data_dir, "--ar-steps", "2", "--max-samples", "2",
            "--mos-calibration", "1", "--zsurf-channel", "-1",
            "--unet-exp", unet_dir]
    port, ref = _ladders(exp, argv)
    assert {"+cascade", "+cascade+lapse+mos+idw"} <= set(port)
    _assert_ladders(port, ref)
    assert port["+cascade"]["rmse"] != port["raw"]["rmse"]

    pt_dir = os.path.join(exp, "unet_pt")
    os.makedirs(pt_dir)
    grid = GridImageModel(DownscalerUNet(c, c, 8), h, w)
    grid.image_module.load_state_dict(from_flax_image_params(uparams))
    torch.save(grid.state_dict(), os.path.join(pt_dir, "best_model.pt"))
    with open(os.path.join(pt_dir, "config.json"), "w") as f:
        json.dump({"base_filters": 8, "num_features": c}, f)
    from graphcast_lite_torch.cli import evaluate_pipeline

    again = evaluate_pipeline.main(
        [exp, "--device", "cpu"] + argv[:-1] + [pt_dir])
    assert again == port


def test_ladder_rungs_remove_planted_bias(tmp_path):
    """The planted test-period drift of ``tests/test_pipeline_ladder.py``:
    the port's lapse, MOS and IDW rungs each remove part of it, as the JAX
    package's do, and the ladder matches the JAX CLI's."""
    exp, data_dir, _ = _experiment(
        tmp_path, regime_drift_m_per_step=120.0, drift_t2m_channel=0,
        drift_zsurf_channel=4)
    port, ref = _ladders(exp, [
        "--data-dir", data_dir, "--ar-steps", "2", "--max-samples", "3",
        "--mos-calibration", "1", "--obs-sparsity", "0.2",
        "--t2m-channel", "0", "--zsurf-channel", "4"])
    _assert_ladders(port, ref)
    raw = port["raw"]["rmse"]
    for rung in ("+lapse", "+mos", "+idw", "+lapse+mos+idw"):
        assert port[rung]["rmse"] < raw, rung


def test_regional_pipelines_bitwise():
    from graphcast_lite_tpu.inference import regional_pipelines as jr
    from graphcast_lite_torch.inference import regional_pipelines as tr

    rng = np.random.RandomState(0)
    lats, lons = np.linspace(-40, 40, 20), np.linspace(0, 90, 30)
    field = rng.randn(600, 3).astype(np.float32)
    roi = (-10, 10, 30, 60)
    for a, b in zip(tr.crop_region(field, lats, lons, roi),
                    jr.crop_region(field, lats, lons, roi)):
        np.testing.assert_array_equal(a, b)
    dst_lats, dst_lons = np.linspace(-5, 5, 7), np.linspace(40, 50, 9)
    np.testing.assert_array_equal(
        tr.interpolate_to_region(field, lats, lons, dst_lats, dst_lons),
        jr.interpolate_to_region(field, lats, lons, dst_lats, dst_lons))
    reg, bg = rng.randn(12, 14, 3), rng.randn(12, 14, 3)
    for border in (0, 3):
        np.testing.assert_array_equal(
            tr.blend_with_background(reg, bg, border),
            jr.blend_with_background(reg, bg, border))


def test_cascade_refine_with_port_unet(monkeypatch):
    """``cascade_refine`` (crop, bilinear upsample, U-Net delta) with the
    JAX ``DownscalerUNet`` and with the port's through
    ``unet_apply_nhwc`` on the same weights."""
    import jax

    from graphcast_lite_tpu.inference.regional_pipelines import \
        cascade_refine as jax_cascade
    from graphcast_lite_tpu.models.unet import DownscalerUNet as JaxUNet
    from graphcast_lite_torch.inference.regional_pipelines import \
        cascade_refine, interpolate_to_region, unet_apply_nhwc
    from graphcast_lite_torch.models.unet import DownscalerUNet
    from graphcast_lite_torch.utils.params import from_flax_image_params

    c = 5
    rng = np.random.RandomState(1)
    lats, lons = np.linspace(-40, 40, 17), np.linspace(0, 90, 31)
    field = rng.randn(lats.size * lons.size, c).astype(np.float32)
    fine_lats = np.linspace(-8.0, 8.0, 16)
    fine_lons = np.linspace(32.0, 58.0, 24)
    roi = (-10.0, 10.0, 30.0, 60.0)
    jmod = JaxUNet(out_channels=c, base_filters=8)
    params = jax_params(jmod, np.zeros((1, 16, 24, c), np.float32), seed=2)
    ref = jax_cascade(lambda x: jax.jit(jmod.apply)(params, x), field, lats,
                      lons, fine_lats, fine_lons, roi)
    unet = DownscalerUNet(c, c, 8)
    unet.load_state_dict(from_flax_image_params(params))
    out = cascade_refine(unet_apply_nhwc(unet, "cpu"), field, lats, lons,
                         fine_lats, fine_lons, roi)
    assert out.shape == ref.shape == (16, 24, c)
    # The upsampled background is NumPy in both: the U-Net's delta is the
    # part compared.
    from graphcast_lite_torch.inference.regional_pipelines import crop_region

    cropped, rl, ro = crop_region(field, lats, lons, roi)
    up = interpolate_to_region(cropped.reshape(-1, c), rl, ro, fine_lats,
                               fine_lons)
    delta, ref_delta = out - up, np.asarray(ref) - up
    err = np.abs(delta - ref_delta).max()
    assert err <= FWD_RTOL * np.abs(ref_delta).max(), err

    # Without a card, only a call that names the CPU runs.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        unet_apply_nhwc(unet)
