"""Test configuration: the suite runs on the CPU backend with an
8-device virtual mesh, so the sharded paths are exercised without an
accelerator. The GPU check is ``chip_smoke.py`` at the repo root."""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402


@pytest.fixture(scope="session")
def example_files(tmp_path_factory):
    """Seeded train/test rating files in the reference's example format
    (``user<TAB>item<TAB>rating``); the test file holds 4 ratings."""
    from mymedialite_tpu.data.synthetic import write_rating_files
    d = tmp_path_factory.mktemp("example")
    train, test = str(d / "example.train"), str(d / "example.test")
    write_rating_files(train, test, num_users=30, num_items=40,
                       num_ratings=400, num_test=4, seed=3)
    return train, test
