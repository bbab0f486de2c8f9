"""The port's network model, locality metrics, MTTDL model, `choose_code`,
`DiskBlockStore` and `CheckpointManager.saved_steps` against the
reference's, on the CPU.

Counts, codes and bytes must be equal; link times and MTTDL years agree
within rtol = 1e-12 (both packages run the same float arithmetic, so they
are equal in practice; the tolerance only states the contract).
"""
import dataclasses
import pathlib

import numpy as np
import pytest

from repro.ckpt import DiskBlockStore as RefDiskStore
from repro.ckpt.manager import CheckpointManager as RefManager
from repro.ckpt.store import BlockStore as RefStore
from repro.ckpt.stripe import StripeCodec as RefCodec
from repro.ckpt.stripe import choose_code as ref_choose_code
from repro.core import codec as ref_codec_mod
from repro.core import metrics as ref_metrics
from repro.core import mttdl as ref_mttdl
from repro.core import paper_schemes as ref_paper_schemes
from repro.core import placement as ref_placement
from repro.topo import LinkReservations as RefReservations
from repro.topo import NetworkModel as RefNetwork
from repro.topo import Topology as RefTopology
from repro.topo import flow_rates as ref_flow_rates
from repro_torch.ckpt import (BlockStore, CheckpointManager, DiskBlockStore,
                              StripeCodec, choose_code)
from repro_torch.core import (ALL_SCHEMES, MTTDLParams, code_mttdl_years,
                              effective_block_traffic, locality_metrics,
                              make_unilrc, mttdl_years_topology,
                              paper_schemes, per_block_repair_traffic,
                              plans_for, recovery_locality,
                              topology_repair_hours)
from repro_torch.core.placement import (default_placement,
                                        place_unilrc_relaxed)
from repro_torch.io import NumpyBackend, TorchBackend
from repro_torch.topo import (LinkReservations, NetworkModel, Topology,
                              flow_rates)

RTOL = 1e-12
CODES = [(scheme, name) for scheme in ALL_SCHEMES
         for name in sorted(paper_schemes(scheme))]


def _close(a: float, b: float) -> bool:
    return a == b or abs(a - b) <= RTOL * max(abs(a), abs(b))


def _pair(scheme, name):
    return paper_schemes(scheme)[name], ref_paper_schemes(scheme)[name]


def _topos(code):
    z = default_placement(code).num_clusters
    npc = max(len(default_placement(code).cluster_blocks(c))
              for c in range(z))
    return ((Topology(z, npc, oversubscription=2.0),
             RefTopology(z, npc, oversubscription=2.0)))


def test_codes_are_the_references():
    for scheme, name in CODES:
        code, ref = _pair(scheme, name)
        assert (code.name, code.n, code.k) == (ref.name, ref.n, ref.k)
        assert np.array_equal(code.A, ref.A)


@pytest.mark.parametrize("scheme,name", CODES)
def test_network_schedules_and_times_match(scheme, name):
    code, ref = _pair(scheme, name)
    topo, rtopo = _topos(code)
    asg = default_placement(code).assignment
    assert list(asg) == list(ref_placement.default_placement(ref).assignment)
    plans = plans_for(code)
    rplans = ref_codec_mod.plans_for(ref)
    for net, rnet in ((NetworkModel.from_topology(topo),
                       RefNetwork.from_topology(rtopo)),
                      (NetworkModel.from_repair_pipe(topo, 3.6, 0.1),
                       RefNetwork.from_repair_pipe(rtopo, 3.6, 0.1))):
        assert (net.cross_bw, net.inner_bw, net.core_bw) == \
            (rnet.cross_bw, rnet.inner_bw, rnet.core_bw)
        for p, rp in zip(plans, rplans):
            sched = net.recovery_schedule(asg, p.target, p.sources, plan=p,
                                          block_bytes=1 << 20)
            rsched = rnet.recovery_schedule(asg, rp.target, rp.sources,
                                            plan=rp, block_bytes=1 << 20)
            assert (sched.inner, sched.uplink, sched.down) == \
                (rsched.inner, rsched.uplink, rsched.down)
            assert net.recovery_blocks(asg, p.target, p.sources, plan=p) \
                == rnet.recovery_blocks(asg, rp.target, rp.sources, plan=rp)
            t, link = net.bottleneck(sched)
            rt, rlink = rnet.bottleneck(rsched)
            assert link == rlink and _close(t, rt)
            assert _close(net.pipe_time(sched), rnet.pipe_time(rsched))
            assert net.link_loads(sched) == rnet.link_loads(rsched)
            if t > 0:
                assert flow_rates(net, sched, 2 * t) \
                    == ref_flow_rates(rnet, rsched, 2 * t)


def test_link_reservations_match():
    code, ref = _pair("30-of-42", "UniLRC")
    topo, rtopo = _topos(code)
    net, rnet = NetworkModel.from_topology(topo), RefNetwork.from_topology(
        rtopo)
    led, rled = LinkReservations(net), RefReservations(rnet)
    asg = place_unilrc_relaxed(code, 2).assignment
    held = []
    for p in plans_for(code)[:12]:
        sched = net.recovery_schedule(asg, p.target, p.sources, plan=p)
        rates = led.rates_for(sched, net.transfer_time(sched) * 1.5)
        assert rates == rled.rates_for(sched, net.transfer_time(sched) * 1.5)
        fits = led.admits(rates)
        assert fits == rled.admits(rates)
        if fits:
            led.reserve(rates)
            rled.reserve(rates)
            held.append(rates)
        if len(held) > 2:
            led.release(held[0])
            rled.release(held.pop(0))
        assert (led.admitted, led.busy_links, led.peak_utilization) == \
            (rled.admitted, rled.busy_links, rled.peak_utilization)


@pytest.mark.parametrize("scheme,name", CODES)
def test_locality_metrics_and_mttdl_match(scheme, name):
    code, ref = _pair(scheme, name)
    pl, rpl = default_placement(code), ref_placement.default_placement(ref)
    m = locality_metrics(code, pl)
    rm = ref_metrics.locality_metrics(ref, rpl)
    assert m.row() == rm.row()
    assert recovery_locality(code) == ref_metrics.recovery_locality(ref)
    assert np.array_equal(per_block_repair_traffic(code, pl),
                          ref_metrics.per_block_repair_traffic(ref, rpl))
    assert np.array_equal(effective_block_traffic(code, pl, 0.1),
                          ref_metrics.effective_block_traffic(ref, rpl, 0.1))
    for p in (MTTDLParams(), MTTDLParams(N=200, delta=0.3, T_hours=1.0)):
        rp = ref_mttdl.MTTDLParams(**dataclasses.asdict(p))
        assert _close(code_mttdl_years(code, m, p),
                      ref_mttdl.code_mttdl_years(ref, rm, rp))
    topo, rtopo = _topos(code)
    assert _close(topology_repair_hours(code, pl, topo, MTTDLParams()),
                  ref_mttdl.topology_repair_hours(ref, rpl, rtopo,
                                                  ref_mttdl.MTTDLParams()))
    assert _close(mttdl_years_topology(code, pl, topo),
                  ref_mttdl.mttdl_years_topology(ref, rpl, rtopo))


# (clusters, nodes per cluster, target rate): the reference's rate and
# fallback cases and a grid around the 1e9-year threshold
CHOOSE = [(10, 30, 0.85), (4, 4, 0.85), (2, 3, 0.85), (3, 3, 0.85),
          (4, 3, 0.85), (6, 8, 0.8), (6, 8, 0.9), (8, 12, 0.85),
          (9, 20, 0.85), (5, 30, 0.75), (7, 10, 0.5)]


@pytest.mark.parametrize("z,npc,rate", CHOOSE)
def test_choose_code_matches(z, npc, rate):
    code = choose_code(Topology(z, npc), target_rate=rate)
    ref = ref_choose_code(RefTopology(z, npc), target_rate=rate)
    assert (code.name, code.n, code.k) == (ref.name, ref.n, ref.k)
    assert np.array_equal(code.A, ref.A)
    # the years behind the choice, not only the choice
    years = code_mttdl_years(code, locality_metrics(code,
                                                    default_placement(code)))
    ryears = ref_mttdl.code_mttdl_years(
        ref, ref_metrics.locality_metrics(
            ref, ref_placement.default_placement(ref)))
    assert _close(years, ryears)
    StripeCodec(code, BlockStore(Topology(z, npc)), block_size=64,
                backend=NumpyBackend())             # deployable


def test_choose_code_meets_rate_and_falls_back():
    code = choose_code(Topology(10, 30), target_rate=0.85)
    assert code.k / code.n >= 0.85 and (code.n, code.k) == (210, 180)
    for z, npc in ((2, 3), (3, 3), (4, 3)):
        assert choose_code(Topology(z, npc)).n <= z * npc
    with pytest.raises(ValueError):
        choose_code(Topology(3, 2))
    with pytest.raises(ValueError):
        ref_choose_code(RefTopology(3, 2))
    with pytest.raises(ValueError):
        choose_code(Topology(1, 8))


def _tree(root: pathlib.Path) -> dict[str, bytes]:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_disk_store_layout_and_reopen_across_packages(tmp_path):
    code = choose_code(Topology(4, 6))
    rcode = ref_choose_code(RefTopology(4, 6))
    assert rcode.name == code.name
    payload = np.random.default_rng(5).integers(
        0, 256, 3 * code.k * 256 - 11, dtype=np.uint8).tobytes()
    port = StripeCodec(code, DiskBlockStore(Topology(4, 6), tmp_path / "p"),
                       block_size=256, backend=TorchBackend("cpu"))
    refc = RefCodec(rcode, RefDiskStore(RefTopology(4, 6), tmp_path / "r"),
                    block_size=256, backend="numpy")
    metas, rmetas = port.write(payload), refc.write(payload)
    assert _tree(tmp_path / "p") == _tree(tmp_path / "r")

    # each package reopens the other's directory and reads it back
    mine = DiskBlockStore(Topology(4, 6), tmp_path / "r")
    mine.reopen()
    codec = StripeCodec(code, mine, block_size=256, backend=NumpyBackend())
    assert codec.read_all(metas) == payload
    mine.fail_node(mine.node_of(1, 2))
    assert codec.degraded_read(metas[1], 2) == \
        payload[(code.k + 2) * 256:(code.k + 3) * 256]
    theirs = RefDiskStore(RefTopology(4, 6), tmp_path / "p")
    theirs.reopen()
    assert RefCodec(rcode, theirs, block_size=256,
                    backend="numpy").read_all(rmetas) == payload

    # drops and node-wide deletes remove the same files
    node = port.store.node_of(0, 5)
    for store in (port.store, refc.store):
        store.drop_block(2, 3)
        store.delete_node_blocks(node)
    assert _tree(tmp_path / "p") == _tree(tmp_path / "r")
    assert (2, 3) not in port.store._blocks
    assert not port.store.blocks_on_node(node)


def test_disk_store_roundtrip_through_the_manager(tmp_path):
    """The reference's `test_disk_store_roundtrip`: save, reopen the store
    from disk, restore."""
    topo = Topology(4, 6)
    store = DiskBlockStore(topo, tmp_path / "blocks")
    mgr = CheckpointManager(store, make_unilrc(1, 4), block_size=2048,
                            backend=TorchBackend("cpu"))
    rng = np.random.default_rng(0)
    state = {"w": rng.normal(size=(37, 11)).astype(np.float32),
             "b": (rng.integers(0, 9, (5,)).astype(np.int32),)}
    mgr.save(state, step=5)
    store2 = DiskBlockStore(topo, tmp_path / "blocks")
    store2.reopen()
    assert store2._block_node == store._block_node
    back, _ = mgr.restore(5)
    assert np.array_equal(back["w"].numpy(), state["w"])
    assert np.array_equal(back["b"][0].numpy(), state["b"][0])


def test_saved_steps_match_the_reference():
    state = {"x": np.arange(300, dtype=np.int32)}
    mgr = CheckpointManager(BlockStore(Topology(4, 8)), make_unilrc(1, 4),
                            block_size=512, backend=TorchBackend("cpu"))
    rmgr = RefManager(RefStore(RefTopology(4, 8)),
                      ref_choose_code(RefTopology(4, 8)), block_size=512,
                      backend="numpy")
    assert mgr.saved_steps == rmgr.saved_steps == []
    for step in (7, 2, 5):
        mgr.save(state, step)
        rmgr.save(state, step)
    assert mgr.saved_steps == rmgr.saved_steps == [2, 5, 7]
