"""The port's parallel/ package on CPU meshes against the JAX package's on
tests/conftest.py's 8 virtual CPU devices: the mesh layout, the batch
encoding, the hashed bucket sketch and both distance steps (float32,
bitwise), the batched and the fleet membership contractions (int64,
exact, with an isolate past int32 accumulation), and the fleet planner.
The tolerance is 0 everywhere."""

import numpy as np
import pytest
import torch

from autocycler_tpu.obs import metrics_registry as jax_registry
from autocycler_tpu.parallel import batch as jax_batch
from autocycler_tpu.parallel import fleet as jax_fleet
from autocycler_tpu.parallel import mesh as jax_mesh
from autocycler_tpu.utils.resilience import InputError as JaxInputError
from autocycler_tpu_torch import device
from autocycler_tpu_torch.obs import metrics_registry
from autocycler_tpu_torch.parallel import batch, fleet, mesh
from autocycler_tpu_torch.utils.resilience import InputError

CPU = torch.device("cpu")


def _host_product(M, w):
    return (M.astype(np.int64) * w[None, :]) @ M.astype(np.int64).T


# ---- the mesh ----

@pytest.mark.parametrize("n,seq", [(8, None), (8, 4), (1, None), (7, None),
                                   (6, 4), (4, 4), (2, None), (12, 3)])
def test_mesh_axis_sizes_equal_jax(n, seq):
    try:
        want = jax_mesh.mesh_axis_sizes(n, seq)
    except ValueError:
        with pytest.raises(ValueError):
            mesh.mesh_axis_sizes(n, seq)
        return
    assert mesh.mesh_axis_sizes(n, seq) == want


def test_make_mesh_refuses_to_shrink():
    with pytest.raises(ValueError, match="refusing to silently shrink"):
        jax_mesh.make_mesh(9)
    with pytest.raises(ValueError, match="refusing to silently shrink"):
        mesh.make_mesh(9, devices=[CPU] * 8)
    if not torch.cuda.is_available():
        # the default device list is every CUDA device, and there is none
        with pytest.raises(ValueError):
            mesh.make_mesh(1)
        with pytest.raises(ValueError, match="no device"):
            mesh.make_mesh()
    m = mesh.make_mesh(8, devices=[CPU] * 8)
    assert m.shape == jax_mesh.make_mesh(8).devices.shape == (4, 2)
    assert m.axis_names == jax_mesh.make_mesh(8).axis_names
    assert m.flat() == [CPU] * 8


@pytest.mark.parametrize("n,hosts,seq", [(8, 2, None), (8, 4, None),
                                         (8, 2, 4), (8, 1, 8), (4, 2, 2)])
def test_multihost_layout_equals_jax(n, hosts, seq):
    want = jax_mesh.make_multihost_mesh(n, n_hosts=hosts, seq_parallel=seq)
    got = mesh.make_multihost_mesh(n, n_hosts=hosts, seq_parallel=seq,
                                   devices=[torch.device(f"cpu:{i}")
                                            for i in range(8)])
    assert got.shape == want.devices.shape
    # host-major: the flat order is the device order, as in the JAX mesh
    assert [d.index for d in got.flat()] == \
        [d.id for d in want.devices.ravel()]


@pytest.mark.parametrize("n,hosts,seq,match", [
    (8, 8, 2, "straddle"), (8, 3, None, "not divisible"),
    (8, 4, 4, "straddle")])
def test_multihost_rejects_straddling_seq(n, hosts, seq, match):
    with pytest.raises(ValueError, match=match):
        jax_mesh.make_multihost_mesh(n, n_hosts=hosts, seq_parallel=seq)
    with pytest.raises(ValueError, match=match):
        mesh.make_multihost_mesh(n, n_hosts=hosts, seq_parallel=seq,
                                 devices=[CPU] * 8)


def test_place_leading_axis_pads_and_splits():
    a = np.arange(5 * 3).reshape(5, 3)
    placed = mesh.place_leading_axis(a, [CPU] * 3)
    assert [len(chunk) for chunk in placed] == [2, 2, 2]
    got = torch.cat(placed).numpy()
    assert got.shape == (6, 3)
    np.testing.assert_array_equal(got[:5], a)
    assert not got[5].any()
    with pytest.raises(ValueError):
        mesh.place_leading_axis(a, [])


# ---- encoding and the sketch steps ----

def _genomes(n_isolates, n_assemblies, length, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_isolates):
        g = "".join(rng.choice(list("ACGT"), size=length))
        other = "".join(rng.choice(list("ACGTN.x"), size=length - 7))
        out.append([g, g[50:] + g[:50], other][:n_assemblies])
    return out


def test_encode_batch_equals_jax():
    genomes = _genomes(5, 3, 300, 1)
    np.testing.assert_array_equal(batch.encode_batch(genomes),
                                  jax_batch.encode_batch(genomes))
    np.testing.assert_array_equal(batch.encode_batch(genomes, length=100),
                                  jax_batch.encode_batch(genomes, length=100))
    for bad in ([], [["ACGT"], []], [[""], [""]]):
        with pytest.raises(JaxInputError) as want:
            jax_batch.encode_batch(bad)
        with pytest.raises(InputError) as got:
            batch.encode_batch(bad)
        assert str(got.value) == str(want.value)


def test_mul32_equals_uint32_multiply():
    rng = np.random.default_rng(3)
    x = rng.integers(0, 2**32, size=10_000, dtype=np.uint64)
    x[:3] = [0, 1, 2**32 - 1]
    for m in batch._MIX:
        want = (x.astype(np.uint32) * np.uint32(m)).astype(np.int64)
        got = batch._mul32(torch.from_numpy(x.astype(np.int64)), m).numpy()
        np.testing.assert_array_equal(got, want)
    # the unsplit product of the largest word passes int64
    assert max(batch._MIX) * int(x.max()) > 2**63 - 1


def _codes(n_isolates, n_assemblies, length, seed, wide_codes=False):
    codes = batch.encode_batch(_genomes(n_isolates, n_assemblies, length,
                                        seed), length=length)
    if wide_codes:
        # codes above 7 fill all 32 bits of a word, so the word times a
        # multiplier passes 2**63: the split multiply must still wrap it
        # as uint32 arithmetic does
        rng = np.random.default_rng(seed)
        codes[0, 1] = rng.integers(1, 256, size=length, dtype=np.uint8)
    return codes


@pytest.mark.parametrize("n_dev,seq,wide", [(8, None, False), (8, None, True),
                                            (4, 4, False), (4, 4, True)])
def test_distance_steps_equal_jax(n_dev, seq, wide):
    codes = _codes(8 if seq is None else 2, 3, 512, 5, wide)
    want_single = np.asarray(jax_batch.multi_isolate_distance_step(
        codes, k=21, buckets=512))
    want_sharded = np.asarray(jax_batch.sharded_multi_isolate_step(
        jax_mesh.make_mesh(n_dev, seq_parallel=seq), codes, k=21,
        buckets=512))
    device.reset_counts()
    single = batch.multi_isolate_distance_step(codes, k=21, buckets=512,
                                               device="cpu")
    sharded = batch.sharded_multi_isolate_step(
        mesh.make_mesh(n_dev, seq_parallel=seq, devices=[CPU] * n_dev),
        codes, k=21, buckets=512)
    assert single.dtype == sharded.dtype == np.float32
    np.testing.assert_array_equal(single, want_single)
    np.testing.assert_array_equal(sharded, want_sharded)
    np.testing.assert_array_equal(sharded, single)
    records = device.dp_summary("batch_sketch_step")["each"]
    assert [r["devices"] for r in records] == [1, n_dev]


def test_sketch_without_seq_halo_equals_jax():
    # one seq shard adds no halo (the JAX body's n_seq == 1 branch): the
    # windows do not wrap, unlike the single-device step
    codes = _codes(4, 3, 256, 8)
    want = np.asarray(jax_batch.sharded_multi_isolate_step(
        jax_mesh.make_mesh(4, seq_parallel=1), codes, k=21, buckets=256))
    got = batch.sharded_multi_isolate_step(
        mesh.make_mesh(4, seq_parallel=1, devices=[CPU] * 4), codes, k=21,
        buckets=256)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="do not divide"):
        batch.sharded_multi_isolate_step(
            mesh.make_mesh(4, seq_parallel=4, devices=[CPU] * 4),
            codes[:, :, :254], k=21, buckets=256)


# ---- the membership contractions ----

def _memberships(seed, shapes, big=()):
    rng = np.random.default_rng(seed)
    Ms, ws = [], []
    for i, (s, u) in enumerate(shapes):
        Ms.append((rng.random((s, u)) < 0.4).astype(np.uint8))
        ws.append(rng.integers(1, 5000, size=u).astype(np.int64))
        if i in big:
            # past int32 accumulation: the JAX package takes this isolate
            # to its int64 host product; the port keeps it on the device
            Ms[-1][:] = 1
            ws[-1][:] = 2**28
    return Ms, ws


@pytest.mark.parametrize("n_dev,seq", [(8, None), (8, 4), (4, 1), (1, None)])
def test_batched_membership_intersections_equal_jax(n_dev, seq):
    Ms, ws = _memberships(77, [(3, 10), (5, 89), (2, 3), (4, 64), (5, 40)],
                          big=(3,))
    want = jax_batch.batched_membership_intersections(
        jax_mesh.make_mesh(n_dev, seq_parallel=seq), Ms, ws)
    device.reset_counts()
    got = batch.batched_membership_intersections(
        mesh.make_mesh(n_dev, seq_parallel=seq, devices=[CPU] * n_dev),
        Ms, ws)
    for m, w, a, b in zip(Ms, ws, got, want):
        assert a.dtype == np.int64 and a.shape == (m.shape[0],) * 2
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, _host_product(m, w))
    assert got[3][0, 0] == 64 * 2**28                 # past int32
    (record,) = device.dp_summary("batch_membership_contraction")["each"]
    assert record == {"isolates": 5, "contigs": 5,
                      "unitigs": -(-89 // mesh.mesh_axis_sizes(n_dev, seq)[1])
                      * mesh.mesh_axis_sizes(n_dev, seq)[1],
                      "devices": n_dev}
    assert batch.batched_membership_intersections(
        mesh.make_mesh(devices=[CPU]), [], []) == []


def test_batched_membership_refuses_inexact_float64():
    M = np.ones((2, 4), np.uint8)
    w = np.full(4, 2**51, np.int64)
    with pytest.raises(ValueError, match="2\\*\\*53"):
        batch.batched_membership_intersections(
            mesh.make_mesh(devices=[CPU]), [M], [w])


# ---- the fleet ----

def _skewed_costs():
    costs = {"giant": 6_000_000}
    costs.update({f"plasmid_{i}": 2_000 + i for i in range(7)})
    return costs


@pytest.mark.parametrize("costs,size,buckets", [
    (_skewed_costs(), 4, 4), (_skewed_costs(), 1, 4),
    ({f"iso_{i}": (i * 37) % 11 for i in range(13)}, 3, 2),
    ({f"iso_{i}": 100 - i for i in range(5)}, 2, 1),
    ({"a": 5}, 8, 4), ({}, 2, 4)])
def test_plan_fleet_equals_jax(costs, size, buckets):
    got = fleet.plan_fleet(costs, shard_size=size, n_buckets=buckets)
    want = jax_fleet.plan_fleet(costs, shard_size=size, n_buckets=buckets)
    assert (got.shard_size, got.n_buckets) == (want.shard_size, want.n_buckets)
    assert [(s.index, s.bucket, s.names) for s in got.shards] == \
        [(s.index, s.bucket, s.names) for s in want.shards]


def test_bucket_dim_and_isolate_cost_equal_jax(tmp_path):
    for n in range(0, 300, 7):
        for floor in (1, 8, 64):
            assert fleet.bucket_dim(n, floor) == jax_fleet.bucket_dim(n, floor)
    d = tmp_path / "iso"
    d.mkdir()
    (d / "a.fasta").write_text(">c\n" + "A" * 100 + "\n")
    (d / "b.fa.gz").write_bytes(b"\x1f\x8b" + bytes(30))
    (d / "notes.txt").write_text("ignored")
    for path in (d, tmp_path / "missing"):
        assert fleet.isolate_cost(path) == jax_fleet.isolate_cost(path)
    assert fleet.isolate_cost(d) == 104 + 32


def test_fleet_modes_equal_jax(monkeypatch):
    monkeypatch.delenv("AUTOCYCLER_FLEET_MODE", raising=False)
    assert fleet.resolve_fleet_mode(None) == \
        jax_fleet.resolve_fleet_mode(None) == "off"
    monkeypatch.setenv("AUTOCYCLER_FLEET_MODE", " Auto ")
    assert fleet.resolve_fleet_mode(None) == \
        jax_fleet.resolve_fleet_mode(None) == "auto"
    assert fleet.resolve_fleet_mode("on") == jax_fleet.resolve_fleet_mode("on")
    monkeypatch.setenv("AUTOCYCLER_FLEET_MODE", "warp")
    with pytest.raises(JaxInputError) as want:
        jax_fleet.resolve_fleet_mode(None)
    with pytest.raises(InputError) as got:
        fleet.resolve_fleet_mode(None)
    assert str(got.value) == str(want.value)
    for forced in ("4", "1"):
        monkeypatch.setenv("AUTOCYCLER_FLEET_DEVICES", forced)
        assert fleet.fleet_devices() == jax_fleet.fleet_devices() == int(forced)
        for mode in ("off", "on", "auto"):
            for n in (1, 2, 10):
                assert fleet.fleet_engaged(mode, n) == \
                    jax_fleet.fleet_engaged(mode, n), (forced, mode, n)
    monkeypatch.delenv("AUTOCYCLER_FLEET_DEVICES")
    # without the knob: one device for a CPU run, else the CUDA cards
    assert fleet.fleet_devices("cpu") == 1
    assert fleet.fleet_devices() == torch.cuda.device_count()


@pytest.mark.parametrize("devices", [1, 2, 3, 4])
def test_fleet_membership_intersections_equal_jax(devices):
    Ms, ws = _memberships(5, [(3, 10), (7, 130), (1, 5), (12, 64), (5, 70),
                              (3, 40)], big=(5,))
    want = jax_fleet.fleet_membership_intersections(Ms, ws, devices=devices)
    want_ratio = jax_registry.registry().value(jax_fleet.FLEET_PAD_RATIO)
    device.reset_counts()
    got = fleet.fleet_membership_intersections(Ms, ws, devices=devices,
                                               device="cpu")
    assert metrics_registry.registry().value(fleet.FLEET_PAD_RATIO) == \
        want_ratio
    for m, w, a, b in zip(Ms, ws, got, want):
        assert a.dtype == np.int64
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, _host_product(m, w))
    assert got[5][0, 0] == 40 * 2**28                 # past int32
    (record,) = device.dp_summary("fleet_membership_contraction")["each"]
    assert record == {"isolates": 6, "contigs": 16, "unitigs": 256,
                      "devices": devices}
    assert fleet.fleet_membership_intersections([], [], device="cpu") == \
        jax_fleet.fleet_membership_intersections([], []) == []


def test_fleet_device_list():
    assert fleet.fleet_device_list(3, "cpu") == [CPU] * 3
    if torch.cuda.is_available():
        count = torch.cuda.device_count()
        assert fleet.fleet_device_list(2 * count) == \
            [torch.device(f"cuda:{i % count}") for i in range(2 * count)]
