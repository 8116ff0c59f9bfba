"""``cli.train_regional`` on the CPU, for both heads.

* The port's CLI on a ``make_demo`` experiment (32x16 grid, mesh [1, 2])
  over the README's ROI: ``--overfit-test`` (100 steps on one sample, the
  loss falls), one epoch, ``regional_head.pt`` written, ``--evaluate``'s
  report with region metrics, and ``--evaluate-only`` reading the saved
  head to the same report.
* A head the JAX package's CLI trained (``regional_head.msgpack``, over a
  JAX ``best_model.msgpack`` global model): the port's
  ``--evaluate-only`` report matches the JAX CLI's within 1e-4 relative,
  both packages on the plain InteractionNet step (``GCLT_LAZY_EDGE=0``,
  ROADMAP Queue C).
"""

import numpy as np
import pytest

from torch_port_common import one_torch_thread  # noqa: F401 (autouse)

ROI = ["--roi", "20", "60", "60", "140"]
SMALL = ["--reg-level", "3", "--hidden", "32", "--processor-steps", "2"]
REPORT_RTOL = 1e-4


def _report_close(got, expect):
    for name in ("rmse", "mae", "acc", "baseline_rmse", "skill"):
        np.testing.assert_allclose(getattr(got, name), getattr(expect, name),
                                   rtol=REPORT_RTOL, err_msg=name)
    for name in ("rmse", "acc", "skill"):
        np.testing.assert_allclose(got.region[name], expect.region[name],
                                   rtol=REPORT_RTOL, err_msg=name)
    assert got.region["num_nodes"] == expect.region["num_nodes"]
    assert got.num_samples == expect.num_samples


@pytest.mark.parametrize("head", ["dual_mesh", "roi_residual"])
def test_train_regional_cli(tmp_path, capsys, head):
    from graphcast_lite_torch.cli import make_demo, train_regional

    exp = str(tmp_path / "demo")
    make_demo.main([exp])
    args = [exp, "--head", head, "--device", "cpu"] + ROI + SMALL
    report = train_regional.main(args + [
        "--epochs", "1", "--max-steps-per-epoch", "2", "--overfit-test",
        "--evaluate"])
    out = capsys.readouterr().out
    assert "[overfit-test]" in out and "(OK)" in out, out
    assert (tmp_path / "demo" / f"{head}_head" / "regional_head.pt").exists()
    assert report.region is not None and report.region["num_nodes"] > 0
    assert np.isfinite([report.rmse, report.region["rmse"]]).all()
    again = train_regional.main(args + ["--evaluate-only"])
    assert "[regional] loaded head from" in capsys.readouterr().out
    assert again.to_json() == report.to_json()


@pytest.mark.parametrize("head", ["dual_mesh", "roi_residual"])
def test_jax_trained_head_report_matches(tmp_path, monkeypatch, capsys,
                                         head):
    import jax

    from graphcast_lite_tpu.build import build_weather_model as jax_build
    from graphcast_lite_tpu.cli import train_regional as jax_cli
    from graphcast_lite_tpu.cli.make_demo import main as jax_demo
    from graphcast_lite_tpu.config import load_experiment_config as jax_load
    from graphcast_lite_tpu.data.dataset import \
        load_chunked_datasets as jax_data
    from graphcast_lite_tpu.inference import predict as jax_predict
    from graphcast_lite_tpu.training.checkpoint import save_params
    from graphcast_lite_torch.cli import train_regional

    monkeypatch.setenv("GCLT_LAZY_EDGE", "0")
    exp = tmp_path / "demo"
    jax_demo([str(exp)])
    jcfg = jax_load(str(exp / "config.json"))
    _, _, _, jmeta = jax_data(jcfg.data_dir, obs_window=2, pred_steps=1,
                              n_features=jcfg.data.num_features_used)
    jmodel, jgraphs, jgs = jax_build(jcfg, jmeta)
    dummy = np.zeros((jgs.num_grid_nodes,
                      2 * jcfg.data.num_features_used), np.float32)
    save_params(str(exp / "best_model.msgpack"),
                jax.jit(jmodel.init)(jax.random.PRNGKey(3), dummy, jgraphs))

    reports = []
    evaluate = jax_predict.evaluate_model
    monkeypatch.setattr(
        jax_predict, "evaluate_model",
        lambda *a, **k: reports.append(evaluate(*a, **k)) or reports[-1])
    args = [str(exp), "--head", head] + ROI + SMALL
    jax_cli.main(args + ["--epochs", "1", "--max-steps-per-epoch", "2"])
    assert (exp / f"{head}_head" / "regional_head.msgpack").exists()
    jax_cli.main(args + ["--evaluate-only"])
    capsys.readouterr()
    report = train_regional.main(args + ["--evaluate-only", "--device",
                                         "cpu"])
    out = capsys.readouterr().out
    assert "global params from" in out and "best_model.msgpack" in out
    assert "regional_head.msgpack" in out
    _report_close(report, reports[-1])
