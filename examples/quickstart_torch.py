"""Quickstart on the PyTorch port: the paper's UniLRC end to end.

  1. construct UniLRC(42, 30, 6) (alpha=1, z=6: the paper's running
     example),
  2. encode a payload with the GF(2^8) coding kernel (the hand-written
     Hopper kernel on the card, its plain PyTorch version with
     --device cpu),
  3. verify the three locality properties (recovery / topology / XOR),
  4. kill a node, degraded-read through the pure-XOR path,
  5. kill a whole cluster + one more block (d-1 = 7 erasures), full decode.

The port of `examples/quickstart.py`; it imports only `repro_torch`.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.ckpt.store import BlockStore
from repro_torch.ckpt.stripe import StripeCodec
from repro_torch.core.codec import decode_plan, single_recovery_plan
from repro_torch.core.codes import make_unilrc
from repro_torch.core.metrics import locality_metrics
from repro_torch.core.placement import place_unilrc
from repro_torch.io import TorchBackend
from repro_torch.topo import Topology


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    # 1. the paper's running example ------------------------------------
    code = make_unilrc(alpha=1, z=6)
    print(f"code: {code.name}  (n={code.n}, k={code.k}, "
          f"d={code.meta['d']}, groups={len(code.groups)})")

    # 2. encode ----------------------------------------------------------
    topo = Topology(num_clusters=6, nodes_per_cluster=8)
    store = BlockStore(topo)
    codec = StripeCodec(code, store, block_size=1 << 16,
                        backend=TorchBackend(args.device))
    rng = np.random.default_rng(0)
    payload = rng.integers(0, 256, size=code.k << 16, dtype=np.uint8).tobytes()
    metas = codec.write(payload)
    print(f"encoded {len(payload) >> 20} MiB into {len(metas)} stripe(s) "
          f"across {topo.num_nodes} nodes on {codec.backend.device}")

    # 3. unified locality ------------------------------------------------
    m = locality_metrics(code, place_unilrc(code))
    print(f"recovery locality r̄ = {m.ARC} (minimum = r = {code.meta['r']})")
    print(f"topology locality: CDRC = {m.CDRC}, CARC = {m.CARC} "
          f"(zero cross-cluster recovery)")
    print(f"XOR locality: {100 * m.xor_fraction:.0f}% of recoveries XOR-only")
    print(f"normal-read load balance LBNR = {m.LBNR}")

    # 4. single failure -> degraded read (XOR path) ----------------------
    victim = 3                       # a data block
    node = store.node_of(0, victim)
    store.fail_node(node)
    plan = single_recovery_plan(code, victim)
    print(f"\nnode {node} down; recovering block {victim} from "
          f"{plan.cost} group-local blocks, xor_only={plan.xor_only}")
    rec = codec.degraded_read(metas[0], victim,
                              reader_cluster=topo.cluster_of(node))
    expect = payload[victim << 16:(victim + 1) << 16]
    assert rec == expect, "degraded read mismatch"
    print(f"degraded read OK; cross-cluster bytes = "
          f"{store.traffic.cross_bytes} (UniLRC Property 2)")
    store.heal_node(node)

    # 5. cluster failure + one more block: d-1 = 7 erasures --------------
    cluster_blocks = list(code.groups[2])          # one whole local group
    erased = tuple(cluster_blocks[:6] + [0])       # 6 of them + block 0
    dplan = decode_plan(code, erased)
    blocks = {}
    for s in dplan.sources:
        blocks[s] = np.frombuffer(store.get(metas[0].stripe_id, s), np.uint8)
    rec = dplan.apply(blocks)
    for e in erased:
        if e < code.k:
            assert rec[e].tobytes() == payload[e << 16:(e + 1) << 16]
    print(f"\ndecoded {len(erased)} erasures (cluster loss + 1) from "
          f"{len(dplan.sources)} survivors — distance-optimal d = r+2 "
          f"= {code.meta['d']}")
    print("\nquickstart OK")


if __name__ == "__main__":
    main()
