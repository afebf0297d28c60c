"""chip_smoke.py's pieces on the CPU: the device gate, the last line,
phase selection, and every phase at a tiny size (the GPU side of the
CPU-vs-GPU check is the CPU here, so it must agree exactly)."""

import json
import os
import sys

import numpy as np
import pytest

import jax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402

TINY = cs.Sizes(num_users=2000, num_items=1000, num_ratings=100_000,
                num_probe=12_500, num_factors=8, rating_epochs=3,
                bpr_epochs=2, bpr_batch=1024, eval_users=200,
                svdpp_ratings=30_000, svdpp_factors=4, cli_users=30,
                cli_items=20, cli_ratings=600, check_events=20_000,
                check_als_rows=200, check_rank_users=100, num_tastes=16,
                seed=3)

H100 = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}


@pytest.fixture(scope="module")
def data():
    return cs.make_data(TINY)


@pytest.fixture()
def report():
    return cs.Report("test-card, 0 W")


@pytest.fixture()
def limit_devices(monkeypatch):
    """Make the package see only the first n devices."""
    real = jax.devices

    def limit(n):
        monkeypatch.setattr(
            jax, "devices",
            lambda backend=None: real(backend)[:n] if backend is None
            else real(backend))
    return limit


def test_main_refuses_cpu(capsys):
    assert cs.main([]) == 2
    out = capsys.readouterr()
    assert "a GPU is required" in out.err
    assert '"ok"' not in out.out


def test_last_line_names_the_device(monkeypatch, capsys):
    runs = []
    monkeypatch.setattr(cs, "require_gpu", lambda: dict(H100))
    monkeypatch.setattr(cs, "describe_gpu",
                        lambda: "gpu: NVIDIA H100 80GB HBM3, 700.00 W")
    monkeypatch.setattr(cs, "run", lambda *a: runs.append(a))
    assert cs.main([]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "gpu: NVIDIA H100 80GB HBM3, 700.00 W"
    assert json.loads(lines[-1]) == {"ok": True, "device": H100}
    (sizes, four, _report), = runs
    assert sizes == cs.Sizes() and not four


@pytest.mark.parametrize("argv,ratings,four", [
    ([], 20_000_000, False),
    (["--ratings", "100480507"], 100_480_507, False),
    (["--four"], 20_000_000, True),
])
def test_parse_args(argv, ratings, four):
    args = cs.parse_args(argv)
    assert (args.ratings, args.four) == (ratings, four)


@pytest.mark.parametrize("four", [False, True])
def test_phase_selection(monkeypatch, report, four):
    called = []
    monkeypatch.setattr(cs, "make_data", lambda s: ("train", "probe"))
    for name, ret in (("rating_phase", "mf"),
                      ("item_phase", ({"BPRMF": "bpr"}, "eval")),
                      ("svdpp_phase", None), ("cli_phase", None),
                      ("check_phase", None), ("four_phase", None)):
        monkeypatch.setattr(
            cs, name, lambda *a, _n=name, _r=ret, **k:
            (called.append(_n), _r)[1])
    cs.run(TINY, four, report)
    if four:
        assert called == ["four_phase"]
    else:
        assert called == ["rating_phase", "item_phase", "svdpp_phase",
                          "cli_phase", "check_phase"]


def test_rating_phase(data, report, capsys):
    m = cs.rating_phase(*data, TINY, report)
    assert m.W_ext.shape[1] == TINY.num_factors + 2
    assert "timing phase=rating" in capsys.readouterr().out


def test_item_phase(data, report, capsys):
    models, (train_pos, test_pos, users) = cs.item_phase(*data, TINY,
                                                         report)
    assert set(models) == {"BPRMF", "WRMF"}
    assert 0 < users.size <= TINY.eval_users
    out = capsys.readouterr().out
    assert "phase=item-BPRMF" in out and "phase=item-WRMF" in out


def test_svdpp_phase(data, report):
    m = cs.svdpp_phase(*data, TINY, report)
    assert len(m.ratings) == TINY.svdpp_ratings


def test_cli_phase(report, capsys):
    cs.cli_phase(TINY, report)
    out = capsys.readouterr().out
    assert cs.RATING_LINE.search(out) and cs.ITEM_LINE.search(out)


def test_check_phase(data, report, capsys):
    rating_model = cs.rating_phase(*data, TINY, report)
    models, eval_data = cs.item_phase(*data, TINY, report)
    cs.check_phase(*data, rating_model, models["BPRMF"], eval_data, TINY,
                   report)
    out = capsys.readouterr().out
    for check in ("sgd", "bpr", "als", "svdpp", "rating-eval RMSE",
                  "ranking AUC"):
        assert f"check {check}" in out


@pytest.mark.parametrize("n", [2, 4])
def test_four_phase(data, report, limit_devices, capsys, n):
    limit_devices(n)
    cs.four_phase(*data, TINY, report, n=n)
    out = capsys.readouterr().out
    assert f"four WRMF: {n}-card factors bit-identical to 1-card: True" \
        in out
    assert f"four ranking: {n}-card metrics identical to 1-card: True" \
        in out


def test_four_phase_needs_its_devices(data, report, limit_devices):
    limit_devices(2)
    with pytest.raises(AssertionError, match="needs 4 devices"):
        cs.four_phase(*data, TINY, report, n=4)


def test_first_card_only_restores_devices():
    before = jax.devices()
    with cs.first_card_only():
        assert jax.devices() == before[:1]
        assert len(jax.devices("cpu")) == len(before)
    assert jax.devices() == before


def test_table_diff_is_relative():
    a = {"x": np.array([1.0, 2.0]), "y": np.array([[10.0]])}
    b = {"x": np.array([1.0, 2.5]), "y": np.array([[11.0]])}
    # the worst array: |2.5 - 2.0| / max(1, 2.5)
    assert cs._table_diff(a, b) == pytest.approx(0.2)
    with pytest.raises(AssertionError):
        cs._table_diff({"x": np.zeros(2)}, {"x": np.zeros(3)})
