"""The device gate, the nvidia-smi reading, the compile-cache helper and
the scaled data generators."""

import os
import subprocess
import sys

import numpy as np
import pytest

import jax

from mymedialite_tpu.data.synthetic import (
    synthetic_ratings_at_scale, write_rating_files,
)
from mymedialite_tpu.utils import compile_cache, device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class TestDevice:
    @pytest.mark.parametrize("text,cards", [
        ("NVIDIA H100 80GB HBM3, 700.00 W\n",
         [("NVIDIA H100 80GB HBM3", "700.00 W")]),
        ("NVIDIA H100 80GB HBM3, 700.00 W\nNVIDIA H100 80GB HBM3, "
         "500.00 W\n", [("NVIDIA H100 80GB HBM3", "700.00 W"),
                        ("NVIDIA H100 80GB HBM3", "500.00 W")]),
        ("NVIDIA H100, PCIe, 350.00 W", [("NVIDIA H100, PCIe", "350.00 W")]),
    ])
    def test_parse_gpu_csv(self, text, cards):
        assert device.parse_gpu_csv(text) == cards

    def test_parse_gpu_csv_rejects_garbage(self):
        with pytest.raises(ValueError):
            device.parse_gpu_csv("no comma here")

    def test_describe_gpu_reads_nvidia_smi(self, monkeypatch):
        seen = {}

        def fake_run(cmd, **kw):
            seen["cmd"] = cmd
            return subprocess.CompletedProcess(
                cmd, 0, stdout="NVIDIA H100 80GB HBM3, 700.00 W\n")
        monkeypatch.setattr(device.subprocess, "run", fake_run)
        assert device.describe_gpu() == \
            "gpu: NVIDIA H100 80GB HBM3, 700.00 W"
        assert seen["cmd"] == device.NVIDIA_SMI_QUERY

    def test_require_gpu_refuses_cpu(self):
        with pytest.raises(RuntimeError, match="a GPU is required"):
            device.require_gpu()

    def test_device_summary(self):
        s = device.device_summary()
        assert s == {"platform": "cpu", "kind": jax.devices()[0].device_kind,
                     "count": len(jax.devices())}


class TestCompileCache:
    def test_env_set_changes_nothing(self, monkeypatch, tmp_path):
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        updates = []
        monkeypatch.setattr(compile_cache.jax.config, "update",
                            lambda *a: updates.append(a))
        assert compile_cache.enable_compile_cache() == str(tmp_path)
        assert updates == []

    def test_env_unset_uses_checkout_dir(self, monkeypatch):
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        updates = []
        monkeypatch.setattr(compile_cache.jax.config, "update",
                            lambda *a: updates.append(a))
        path = compile_cache.enable_compile_cache()
        assert path == os.path.join(REPO, ".jax_cache")
        assert updates == [("jax_compilation_cache_dir", path)]

    @pytest.mark.parametrize("env_set", [True, False])
    def test_cli_cache_location(self, example_files, tmp_path, env_set):
        """A CLI run caches where JAX_COMPILATION_CACHE_DIR says, else in
        the checkout's .jax_cache."""
        train, test = example_files
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0")
        env.pop("JAX_COMPILATION_CACHE_DIR", None)
        env.pop("XLA_FLAGS", None)
        if env_set:
            env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path)
        code = (
            "import jax\n"
            "from mymedialite_tpu.cli import rating_prediction as r\n"
            f"r.main(['--training-file', {train!r}, '--test-file', "
            f"{test!r}, '--recommender', 'BiasedMatrixFactorization', "
            "'--recommender-options', 'num_iter=1'])\n"
            "print('CACHE', jax.config.jax_compilation_cache_dir)\n")
        out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr
        want = str(tmp_path) if env_set else os.path.join(REPO, ".jax_cache")
        assert f"CACHE {want}" in out.stdout
        if env_set:
            assert any(tmp_path.iterdir())


class TestScaledGenerator:
    @pytest.mark.parametrize("users,items,n,probe", [
        (50, 30, 400, 60),
        (500, 200, 20_000, 1_000),
        (2_000, 17_770, 50_000, 0),
    ])
    def test_exact_disjoint_and_in_range(self, users, items, n, probe):
        train, test = synthetic_ratings_at_scale(users, items, n, probe,
                                                 seed=1)
        assert (len(train), len(test)) == (n, probe)
        keys = [d.users.astype(np.int64) * items + d.items
                for d in (train, test)]
        assert np.unique(keys[0]).size == n
        assert not np.intersect1d(keys[0], keys[1]).size
        for d in (train, test):
            assert d.num_users == users and d.num_items == items
            assert (np.diff(d.users) >= 0).all()
            assert set(np.unique(d.values * 2).tolist()) <= \
                set(range(2, 11))

    def test_seeded(self):
        a, _ = synthetic_ratings_at_scale(100, 50, 1_000, seed=4)
        b, _ = synthetic_ratings_at_scale(100, 50, 1_000, seed=4)
        np.testing.assert_array_equal(a.items, b.items)
        np.testing.assert_array_equal(a.values, b.values)

    def test_write_rating_files(self, tmp_path):
        tr, te = str(tmp_path / "a.train"), str(tmp_path / "a.test")
        write_rating_files(tr, te, num_users=40, num_items=30,
                           num_ratings=500, num_test=25, seed=2)
        train = np.loadtxt(tr)
        test = np.loadtxt(te)
        assert test.shape == (25, 3)
        assert set(test[:, 0]) <= set(train[:, 0])
        assert set(test[:, 1]) <= set(train[:, 1])
        pairs = {tuple(r) for r in train[:, :2].tolist()}
        assert not pairs & {tuple(r) for r in test[:, :2].tolist()}
