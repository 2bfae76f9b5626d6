"""``das_diff_veh_tpu_torch.parallel`` against ``das_diff_veh_tpu.parallel``
on the CPU: the window-sharded stack and the all-pairs ring over 8 CPU slots
(``make_mesh(8, device="cpu")``, the counterpart of the 8 virtual CPU
devices the JAX tests run on), and the cluster helpers.  Every case of
``tests/test_parallel.py`` but its jaxpr pin, which has no torch
counterpart.

Tolerances: the stack at 1e-9 in float64 (the JAX test's bar; the sharded
sum adds the slots' sums in another order).  The ring on the kernel path
(the plain versions of B3 and B4 on the CPU) equals the port's unsharded
call bit for bit: the plain cross-spectra sum one pair's windows in the
same order at any receiver count, and the irfft and lag peak work row by
row.  Against JAX's interpret-mode ring the all-pairs bar, 1e-6
peak-relative (the two packages' FFTs round differently).  The einsum path
sums in another order on a shard than on the whole set, so it is held at
JAX's einsum tolerance (rtol 2e-5)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from das_diff_veh_tpu import config as JC
from das_diff_veh_tpu import parallel as JP
from das_diff_veh_tpu import workloads as JWL
from das_diff_veh_tpu.models import vsg as JV
from das_diff_veh_tpu.parallel.stack import shard_windows as j_shard_windows
from das_diff_veh_tpu.parallel.stack import sharded_stack_pipeline as j_sharded_stack
from das_diff_veh_tpu_torch import config as PC
from das_diff_veh_tpu_torch import parallel as PP
from das_diff_veh_tpu_torch import workloads as PWL
from das_diff_veh_tpu_torch.models import vsg as PV
from das_diff_veh_tpu_torch.ops.all_pairs import xcorr_all_pairs_peak

ALL_PAIRS_BAR = 1e-6


@pytest.fixture(autouse=True)
def one_thread():
    """Several test workers share a few cores: one PyTorch thread a test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _peak_rel(a, b) -> float:
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _tiny_workload(n_windows):
    """Both packages' window batch, geometry and configurations."""
    wkw = dict(wlen_sw=2.0, length_sw=120.0)
    gkw = dict(wlen=0.5, time_window=1.0)
    dkw = dict(freq_step=0.5, vel_step=20.0)
    jbatch, x = JWL.make_window_batch(n_windows=n_windows, fs=50.0,
                                      wcfg=JC.WindowConfig(**wkw), dtype=np.float64)
    pbatch, px = PWL.make_window_batch(n_windows=n_windows, fs=50.0,
                                       wcfg=PC.WindowConfig(**wkw), dtype=np.float64,
                                       device="cpu")
    np.testing.assert_array_equal(px, x)
    jg = JV.VsgGeometry.build(x, 1.0 / 50.0, 700.0, 640.0, 730.0, JC.GatherConfig(**gkw))
    pg = PV.VsgGeometry.build(x, 1.0 / 50.0, 700.0, 640.0, 730.0, PC.GatherConfig(**gkw))
    return (jbatch, jg, JC.GatherConfig(**gkw), JC.DispersionConfig(**dkw),
            pbatch, pg, PC.GatherConfig(**gkw), PC.DispersionConfig(**dkw), x)


def test_sharded_stack_matches_single_device_and_jax():
    jb, jg, jgc, jdc, pb, pg, pgc, pdc, x = _tiny_workload(n_windows=8)
    offs = pg.offsets(x)
    stack1 = PV.stack_gathers(PV.build_gather_batch(pb, pg, pgc), pb.valid)
    img1 = PV.gather_disp_image(stack1, offs, pg.dt, 8.16, pdc, -60.0, 0.0)

    mesh = PP.make_mesh(8, device="cpu")
    shards = PP.shard_windows(pb, mesh)
    assert [s.max_windows for s in shards] == [1] * 8
    stack8, img8 = PP.sharded_stack_pipeline(shards, pg, offs, mesh, pgc, pdc,
                                             disp_start_x=-60.0, disp_end_x=0.0)
    np.testing.assert_allclose(stack8.numpy(), stack1.numpy(), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(img8.numpy(), img1.numpy(), rtol=1e-9, atol=1e-12)
    # one slot is stack_gathers itself
    stack_one, img_one = PP.sharded_stack_pipeline(pb, pg, offs, PP.make_mesh(1, device="cpu"),
                                                   pgc, pdc, disp_start_x=-60.0, disp_end_x=0.0)
    assert torch.equal(stack_one, stack1) and torch.equal(img_one, img1)

    jmesh = JP.make_mesh(8)
    jstack, jimg = j_sharded_stack(j_shard_windows(jb, jmesh), jg, jg.offsets(x), jmesh,
                                   jgc, jdc, disp_start_x=-60.0, disp_end_x=0.0)
    np.testing.assert_allclose(stack8.numpy(), np.asarray(jstack), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(img8.numpy(), np.asarray(jimg), rtol=1e-9, atol=1e-12)


def test_sharded_stack_pads_ragged_batch():
    """A window count that does not divide the mesh is padded with invalid
    slots and gives the same masked mean."""
    *_, pb, pg, pgc, pdc, x = _tiny_workload(n_windows=5)
    offs = pg.offsets(x)
    stack1 = PV.stack_gathers(PV.build_gather_batch(pb, pg, pgc), pb.valid)
    mesh = PP.make_mesh(8, device="cpu")
    shards = PP.shard_windows(pb, mesh)
    assert sum(s.max_windows for s in shards) == 8
    assert int(sum(s.valid.sum() for s in shards)) == 5
    padded = PP.pad_batch(pb, 8)
    assert padded.max_windows == 8 and not padded.valid[5:].any() and not padded.data[5:].any()
    assert PP.pad_batch(pb, 5) is pb
    stack8, _ = PP.sharded_stack_pipeline(shards, pg, offs, mesh, pgc, pdc,
                                          disp_start_x=-60.0, disp_end_x=0.0)
    np.testing.assert_allclose(stack8.numpy(), stack1.numpy(), rtol=1e-9, atol=1e-12)


def test_sharded_all_pairs_win_block_streams():
    """Sharded rows and window-slab streaming compose: a ragged channel count
    over the mesh and a ragged window tail (46 % 8 = 6) match the unsharded,
    unstreamed einsum."""
    rng = np.random.default_rng(7)
    data = torch.from_numpy(rng.standard_normal((26, 1504)).astype(np.float32))
    got = PP.sharded_all_pairs_peak(data, 64, PP.make_mesh(8, device="cpu"),
                                    use_kernel=False, win_block=8, src_chunk=4)
    want = xcorr_all_pairs_peak(data, 64, use_kernel=False, device="cpu")
    assert got.shape == (26, 26)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5, atol=1e-6)


@pytest.mark.parametrize("nch", [26, 32])          # ragged and divisible
def test_ring_all_pairs_bit_exact(nch):
    """The ring (8 slots and the 1-slot ring) equals the port's unsharded
    ``xcorr_all_pairs_peak`` bit for bit on the kernel path, and JAX's
    interpret-mode ring at the all-pairs bar; the einsum path at JAX's
    einsum tolerance."""
    rng = np.random.default_rng(4 + nch)
    data = rng.standard_normal((nch, 512)).astype(np.float32)
    td = torch.from_numpy(data)
    want = xcorr_all_pairs_peak(td, 128, use_kernel=True, src_chunk=4, device="cpu")
    got = PP.sharded_all_pairs_peak(td, 128, PP.make_mesh(8, device="cpu"), use_kernel=True,
                                    src_chunk=4)
    assert got.shape == (nch, nch) and got.dtype == torch.float32
    assert torch.equal(got, want)
    got1 = PP.sharded_all_pairs_peak(td, 128, PP.make_mesh(1, device="cpu"), use_kernel=True,
                                     src_chunk=4)
    assert torch.equal(got1, want)
    jring = JP.sharded_all_pairs_peak(jnp.asarray(data), 128, JP.make_mesh(8),
                                      use_pallas=True, interpret=True, src_chunk=4)
    assert _peak_rel(got.numpy(), jring) <= ALL_PAIRS_BAR
    ein = PP.sharded_all_pairs_peak(td, 128, PP.make_mesh(8, device="cpu"), use_kernel=False)
    ein_want = xcorr_all_pairs_peak(td, 128, use_kernel=False, device="cpu")
    np.testing.assert_allclose(ein.numpy(), ein_want.numpy(), rtol=2e-5, atol=1e-6)


def test_ring_win_block_kernel_bit_exact():
    """The ring with window-slab streaming on the kernel path, bit for bit,
    with a ragged window tail and a ragged channel count."""
    rng = np.random.default_rng(7)
    data = torch.from_numpy(rng.standard_normal((26, 1504)).astype(np.float32))
    want = xcorr_all_pairs_peak(data, 64, use_kernel=True, win_block=8, src_chunk=4,
                                device="cpu")
    got = PP.sharded_all_pairs_peak(data, 64, PP.make_mesh(8, device="cpu"), use_kernel=True,
                                    win_block=8, src_chunk=4)
    assert torch.equal(got, want)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_ring_modes_and_buffering_identical(precision):
    """Every RingConfig execution choice gives the same array on the kernel
    path, in both tiers (the bf16 ring against the unsharded bf16 call);
    an unknown mode is refused."""
    rng = np.random.default_rng(9)
    data = torch.from_numpy(rng.standard_normal((26, 512)).astype(np.float32))
    mesh = PP.make_mesh(8, device="cpu")
    ref = PP.sharded_all_pairs_peak(data, 128, mesh, use_kernel=True, src_chunk=4,
                                    ring=PC.RingConfig(precision=precision))
    assert torch.equal(ref, xcorr_all_pairs_peak(data, 128, use_kernel=True, src_chunk=4,
                                                 precision=precision, device="cpu"))
    for cfg in (PC.RingConfig(mode="replicated", precision=precision),
                PC.RingConfig(double_buffer=False, precision=precision)):
        got = PP.sharded_all_pairs_peak(data, 128, mesh, use_kernel=True, src_chunk=4,
                                        ring=cfg)
        assert torch.equal(got, ref)
    with pytest.raises(ValueError, match="mode"):
        PP.sharded_all_pairs_peak(data, 128, mesh, ring=PC.RingConfig(mode="banana"))


def test_sharded_all_pairs_negative_win_block_rejected():
    data = torch.zeros((8, 256))
    mesh = PP.make_mesh(8, device="cpu")
    with pytest.raises(ValueError, match="win_block"):
        PP.sharded_all_pairs_peak(data, 64, mesh, win_block=-2)
    with pytest.raises(ValueError, match="lagmax_block"):
        PP.sharded_all_pairs_peak(data, 64, mesh, ring=PC.RingConfig(lagmax_block=-1))


def test_ring_config_mirrors_jax_and_converts():
    assert dataclasses.asdict(PC.RingConfig()) == dataclasses.asdict(JC.RingConfig())
    from das_diff_veh_tpu_torch.convert import ring_config_from_dict

    jcfg = JC.RingConfig(mode="replicated", double_buffer=False, win_block=8,
                         precision="bf16")
    assert dataclasses.asdict(ring_config_from_dict(dataclasses.asdict(jcfg))) == \
        dataclasses.asdict(jcfg)


def test_ring_perm_matches_jax():
    for n in (1, 2, 5, 8):
        for shift in (1, 3):
            assert PP.ring_perm(n, shift) == JP.ring_perm(n, shift)


def test_cluster_spec_from_env_conventions():
    """The JAX spelling wins over the torch.distributed one; an empty
    environment gives all None."""
    cases = [{}, {"MASTER_ADDR": "10.0.0.1", "MASTER_PORT": "1234", "WORLD_SIZE": "4",
                  "RANK": "2"},
             {"MASTER_ADDR": "10.0.0.1", "WORLD_SIZE": "4", "RANK": "0"},
             {"JAX_COORDINATOR_ADDRESS": "c:9", "JAX_NUM_PROCESSES": "2",
              "JAX_PROCESS_ID": "1", "MASTER_ADDR": "ignored", "WORLD_SIZE": "8", "RANK": "7"}]
    want = [(None, None, None), ("10.0.0.1:1234", 4, 2), ("10.0.0.1:8476", 4, 0),
            ("c:9", 2, 1)]
    for env, w in zip(cases, want):
        assert PP.cluster_spec_from_env(env) == JP.cluster_spec_from_env(env) == w


_CLUSTER_VARS = ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID",
                 "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "TPU_WORKER_HOSTNAMES")


def test_initialize_cluster_single_host_noop(monkeypatch):
    for var in _CLUSTER_VARS:
        monkeypatch.delenv(var, raising=False)
    assert PP.initialize_cluster() is False
    assert not torch.distributed.is_initialized()


def test_initialize_cluster_partial_spec_noop(monkeypatch, caplog):
    """A stale MASTER_ADDR without WORLD_SIZE/RANK warns and stays
    single-process instead of waiting on a coordinator."""
    import logging

    for var in _CLUSTER_VARS:
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.99")
    with caplog.at_level(logging.WARNING):
        assert PP.initialize_cluster() is False
    assert any("incomplete cluster spec" in r.message for r in caplog.records)
    assert not torch.distributed.is_initialized()


def test_initialize_cluster_one_rank_gloo_and_multi_rank_refused(monkeypatch, tmp_path):
    """A full spec with ``backend="gloo"`` joins a process group (one rank
    here); a mesh then still builds, all its slots local.  Under a group of
    4 ranks (the group's size and this rank faked as 4 and 2) ``make_mesh``
    builds the global layout: 8 slots dealt in contiguous blocks of 2 in
    rank order, slots 4 and 5 local; 6 slots are refused (not divisible by
    4), and so is ``MeshServingEngine``, which serves from one process,
    naming ROADMAP.  The backend must be named, and NCCL without a card
    raises."""
    import torch.distributed as dist

    from das_diff_veh_tpu_torch.parallel import distributed as PD
    from das_diff_veh_tpu_torch.serve.mesh.engine import MeshServingEngine

    for var in _CLUSTER_VARS + (PD.BACKEND_ENV, "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="backend"):
        PP.initialize_cluster(f"file://{tmp_path / 'none'}", 1, 0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="NCCL needs a card"):
            PP.initialize_cluster(f"file://{tmp_path / 'nccl'}", 1, 0, backend="nccl")
    assert not dist.is_initialized()
    assert PP.initialize_cluster(f"file://{tmp_path / 'store'}", 1, 0, backend="gloo",
                                 timeout_s=30) is True
    try:
        assert dist.get_backend() == "gloo" and PP.world_size() == 1 and PP.rank() == 0
        one = PP.make_mesh(2, device="cpu")
        assert one.size == 2 and one.ranks == () and one.local_slots == (0, 1)

        def every_rank_sends_this(out, obj, group=None):
            out[:] = [obj] * len(out)

        monkeypatch.setattr(dist, "get_world_size", lambda *a, **k: 4)
        monkeypatch.setattr(dist, "get_rank", lambda *a, **k: 2)
        monkeypatch.setattr(dist, "all_gather_object", every_rank_sends_this)
        mesh = PP.make_mesh(8, device="cpu")
        assert mesh.ranks == (0, 0, 1, 1, 2, 2, 3, 3) and mesh.multiprocess
        assert mesh.devices == (torch.device("cpu"),) * 8
        assert mesh.local_slots == (4, 5)
        assert PP.make_mesh(device="cpu").ranks == (0, 1, 2, 3)
        with pytest.raises(ValueError, match="evenly"):
            PP.make_mesh(6, device="cpu")
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            MeshServingEngine(None, device="cpu")
    finally:
        monkeypatch.undo()
        dist.destroy_process_group()


def test_make_mesh_cards_of_a_rank_with_two_slots(monkeypatch, tmp_path):
    """2 ranks x 2 slots, as rank 1 sees it (the group faked around a
    one-rank gloo group, 4 cards faked): ``device=None`` gives rank 1 cards
    2 and 3, counted from ``LOCAL_RANK`` 1, and cards 0 and 1 without
    ``LOCAL_RANK`` (one process a host), never from the global rank.  Under
    NCCL a rank drives one slot on the card ``initialize_cluster`` made
    current: 2 slots a rank raise, and so does a slot on another card."""
    import torch.distributed as dist

    from das_diff_veh_tpu_torch.parallel import mesh as PM

    for var in _CLUSTER_VARS + ("LOCAL_RANK",):
        monkeypatch.delenv(var, raising=False)
    assert PP.initialize_cluster(f"file://{tmp_path / 'store'}", 1, 0, backend="gloo",
                                 timeout_s=30) is True
    try:
        def every_rank_sends_this(out, obj, group=None):
            out[:] = [obj] * len(out)

        monkeypatch.setattr(dist, "get_world_size", lambda *a, **k: 2)
        monkeypatch.setattr(dist, "get_rank", lambda *a, **k: 1)
        monkeypatch.setattr(dist, "all_gather_object", every_rank_sends_this)
        monkeypatch.setattr(PM, "resolve_device", lambda d="cuda": torch.device(d))
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
        assert PP.local_rank() == 0 and PP.rank() == 1
        assert PP.make_mesh(4).devices[2:] == (torch.device("cuda", 0), torch.device("cuda", 1))
        monkeypatch.setenv("LOCAL_RANK", "1")
        mesh = PP.make_mesh(4)
        assert mesh.ranks == (0, 0, 1, 1) and mesh.local_slots == (2, 3)
        assert mesh.devices[2:] == (torch.device("cuda", 2), torch.device("cuda", 3))
        assert PP.make_mesh(4, device="cuda").devices[2:] == mesh.devices[2:]
        monkeypatch.setattr(dist, "get_backend", lambda *a, **k: "nccl")
        with pytest.raises(ValueError, match="one card, not 2 slots"):
            PP.make_mesh(4)
        monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
        assert PP.make_mesh(2).devices == (torch.device("cuda", 1),) * 2
        with pytest.raises(ValueError, match="its own card cuda:1, not cuda:0"):
            PP.make_mesh(2, device="cuda:0")
    finally:
        monkeypatch.undo()
        dist.destroy_process_group()


def test_make_mesh_slots_and_refusals():
    mesh = PP.make_mesh(3, device="cpu")
    assert mesh.size == 3 and mesh.axis == "win"
    assert mesh.devices == (torch.device("cpu"),) * 3
    with pytest.raises(ValueError, match="slot"):
        PP.make_mesh(-1, device="cpu")
    with pytest.raises(ValueError, match="axis"):
        PP.sharded_all_pairs_peak(torch.zeros((4, 256)), 64, mesh, axis="rows")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            PP.make_mesh(1)
        with pytest.raises(RuntimeError, match="CUDA"):
            PP.make_mesh(4, device="cuda")


def test_workloads_match_jax():
    """The window batch and the gather geometry: the JAX package's values."""
    jb, x = JWL.make_window_batch(n_windows=3, seed=2)
    pb, px = PWL.make_window_batch(n_windows=3, seed=2, device="cpu")
    np.testing.assert_array_equal(px, x)
    for f in dataclasses.fields(pb):
        got, want = getattr(pb, f.name).numpy(), np.asarray(getattr(jb, f.name))
        np.testing.assert_array_equal(got, want.astype(got.dtype), err_msg=f.name)
    assert pb.data.dtype == pb.traj_t.dtype == torch.float32
    assert pb.t.dtype == pb.x.dtype == pb.traj_x.dtype == torch.float64
    jg = JWL.make_gather_geometry(x)
    pg = PWL.make_gather_geometry(px)
    assert dataclasses.asdict(pg) == dataclasses.asdict(jg)
    assert jax.devices()[0].platform == "cpu"
