"""Partitioner invariants (counterpart of reference
Tests/MulticoreTest.cs:17-70 — every index in exactly one block, block
grids well-formed) for the three data-layout preparers."""

import numpy as np

from mymedialite_tpu.data import PosOnlyData, RatingData


def _ratings(n=500, U=37, I=23, seed=0):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, U, n).astype(np.int32)
    i = rng.integers(0, I, n).astype(np.int32)
    v = rng.uniform(1, 5, n).astype(np.float32)
    return u, i, v, U, I


class TestBlockedSGDPartitioning:
    def test_every_rating_in_exactly_one_slot(self):
        from mymedialite_tpu.ops.sgd import prepare_blocked_data
        u, i, v, U, I = _ratings()
        data, meta = prepare_blocked_data(u, i, v, U, batch_size=32,
                                          group_users=8, shuffle_seed=3)
        gu = np.asarray(data["gu"])
        gi = np.asarray(data["gi"])
        gv = np.asarray(data["gv"])
        gw = np.asarray(data["gw"])
        G = meta["group_users"]
        assert gw.sum() == len(u)  # padding has weight 0
        # reconstruct global (user, item, value) multiset from real slots
        got = []
        for g in range(meta["ngroups"]):
            real = gw[g] > 0
            assert (gu[g][real] >= 0).all() and (gu[g][real] < G).all()
            got += list(zip(gu[g][real] + g * G, gi[g][real], gv[g][real]))
        assert sorted(got) == sorted(zip(u.tolist(), i.tolist(), v.tolist()))

    def test_group_locality(self):
        # each group slot only holds ratings of its own user range
        from mymedialite_tpu.ops.sgd import prepare_blocked_data
        u, i, v, U, I = _ratings(seed=1)
        data, meta = prepare_blocked_data(u, i, v, U, batch_size=16,
                                          group_users=16, shuffle_seed=0)
        gw = np.asarray(data["gw"])
        gu = np.asarray(data["gu"])
        for g in range(meta["ngroups"]):
            real = gw[g] > 0
            assert (gu[g][real] < meta["group_users"]).all()


class TestSVDPPGrouping:
    def test_masks_and_history_edges(self):
        from mymedialite_tpu.ops.svdpp import prepare_groups
        u, i, v, U, I = _ratings(seed=2)
        ratings = RatingData(u, i, v, num_users=U, num_items=I)
        data, meta = prepare_groups(ratings, u, i, U, I, group_users=8)
        assert float(np.asarray(data["r_mask"]).sum()) == len(u)
        assert float(np.asarray(data["e_mask"]).sum()) == len(u)
        # inv_sqrt_hist matches per-user edge counts
        counts = np.bincount(u, minlength=U)
        inv = np.asarray(data["inv_sqrt_hist"])[:U]
        expect = np.where(counts > 0, 1 / np.sqrt(np.maximum(counts, 1)), 0)
        np.testing.assert_allclose(inv, expect, atol=1e-6)


class TestShardedBPRSampler:
    def test_device_partitions_cover_all_users(self):
        from mymedialite_tpu.ops.bpr import (
            make_sampler_data, make_sampler_data_sharded,
        )
        u, i, _, U, I = _ratings(seed=4)
        fb = PosOnlyData(u, i, num_users=U, num_items=I)
        n = 8
        data, meta = make_sampler_data_sharded(fb, n)
        g_sampler, g_meta = make_sampler_data(fb)
        U_loc = meta["u_loc"]
        counts = np.asarray(data["counts"])
        g_counts = np.asarray(g_sampler["counts"])
        # per-device counts tile the global per-user counts
        flat = counts.reshape(-1)[:U]
        np.testing.assert_array_equal(flat, g_counts[:U])
        # per-device histories equal the global CSR segments
        hist = np.asarray(data["hist_items"])
        indptr = np.asarray(data["indptr"])
        csr = fb.by_user
        for d in range(n):
            lo, hi = d * U_loc, min((d + 1) * U_loc, U)
            for uu in range(lo, hi):
                local = hist[d][indptr[d][uu - lo]:indptr[d][uu - lo + 1]]
                np.testing.assert_array_equal(csr.secondary(uu), local)
        # valid counts: users with 0 < count < num_items
        vcount = np.asarray(data["valid_count"])
        total_valid = int(((g_counts > 0) & (g_counts < I))[:U].sum())
        assert vcount.sum() == total_valid
        assert meta["search_depth"] == g_meta["search_depth"]


class TestMultiHostScaffolding:
    """parallel/mesh.py multi-host layer (SURVEY §2.9 last row): the
    jax.distributed initialization path with its documented
    single-process fallback, the host-sharded input plan, and
    process-local array assembly."""

    def test_initialize_noop_single_process(self):
        from mymedialite_tpu.parallel.mesh import initialize_distributed
        assert initialize_distributed() is False
        assert initialize_distributed(num_processes=1) is False
        # explicit multi-process config without a coordinator -> no-op
        assert initialize_distributed(coordinator_address=None,
                                      num_processes=4,
                                      process_id=0) is False

    def test_host_local_rows_partition(self):
        from mymedialite_tpu.parallel.mesh import host_local_rows
        # hypothetical 4-host pod, 10 group rows: contiguous cover
        spans = [host_local_rows(10, process_id=p, num_processes=4)
                 for p in range(4)]
        assert spans == [(0, 3), (3, 6), (6, 9), (9, 10)]
        # actual process (single): loads everything
        assert host_local_rows(7) == (0, 7)

    def test_shard_host_local_roundtrip(self):
        import jax
        import numpy as np
        from mymedialite_tpu.parallel.mesh import (
            make_global_mesh, shard_host_local,
        )
        mesh = make_global_mesh()
        assert mesh.devices.size == len(jax.devices())
        rows = np.arange(mesh.devices.size * 6,
                         dtype=np.float32).reshape(-1, 3)
        arr = shard_host_local(mesh, rows)
        assert arr.shape == rows.shape
        np.testing.assert_array_equal(np.asarray(arr), rows)
        # row-sharded over 'data'
        assert len(arr.sharding.device_set) == mesh.devices.size


class TestTwoProcessDistributed:
    """A REAL multi-process jax.distributed run: two
    CPU-backend subprocesses (2 virtual devices each) drive
    initialize_distributed -> make_global_mesh -> host_local_rows ->
    shard_host_local -> one sgd_epoch_blocked_sharded step over Gloo
    collectives, and must agree with each other bit-exactly and with
    the single-process 4-device reference to float tolerance (psum
    reduction order differs across process boundaries)."""

    def test_two_process_matches_single(self, tmp_path):
        import os
        import socket
        import subprocess
        import sys

        drv = os.path.join(os.path.dirname(__file__),
                           "distributed_driver.py")
        s = socket.socket()
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
        s.close()
        env = {k: v for k, v in os.environ.items()
               if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
        env["PYTHONPATH"] = os.path.dirname(os.path.dirname(drv)) + (
            os.pathsep + env["PYTHONPATH"] if "PYTHONPATH" in env else "")
        procs = [subprocess.Popen(
            [sys.executable, drv, "dist", str(port), str(i),
             str(tmp_path / f"p{i}.npy")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for i in range(2)]
        outs = [p.communicate(timeout=300)[0].decode() for p in procs]
        for i, p in enumerate(procs):
            assert p.returncode == 0, f"process {i} failed:\n{outs[i]}"
            assert "driver-ok dist" in outs[i]
        ref = subprocess.run(
            [sys.executable, drv, "single", str(port), "0",
             str(tmp_path / "ref.npy")],
            env=env, capture_output=True, timeout=200)
        assert ref.returncode == 0, ref.stderr.decode()[-2000:]

        a = np.load(tmp_path / "p0.npy")
        b = np.load(tmp_path / "p1.npy")
        r = np.load(tmp_path / "ref.npy")
        np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(a, r, atol=1e-6)
        assert np.abs(a - r).max() > 0 or np.array_equal(a, r)
