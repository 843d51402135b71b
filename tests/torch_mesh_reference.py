"""The JAX package's single-device chunked route on the node-mesh test
snapshots, for tests/test_torch_mesh.py.

The JAX package reads KTPU_FORCE_CHUNKED when it traces, so this runs in a
fresh process with it pinned:

    KTPU_FORCE_CHUNKED=1 JAX_PLATFORMS=cpu python tests/torch_mesh_reference.py OUT.npz

For each snapshot of SNAPSHOTS it encodes with DeltaEncoder(bucket=False)
(the node count stays as given: one S divides, one no S of the tests
divides), then runs schedule_batch_ordinals_routed without class state (the
dense chunked route) and with HoistCache.ensure's (the class-wave route),
and saves choices, used, ordinals and sweeps under "<snapshot>/<mode>/<field>".

``pinned`` builds the snapshots from either package's types and workloads
(the JAX package's here, the port's in the card's tests): the heterogeneous
cluster of the north star's generator with nodeName pins in every shard of
every mesh size the tests use, and one pin to a node that does not exist.
"""

import dataclasses
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

PINNED = {"KTPU_FORCE_CHUNKED": "1"}
# name -> (nodes, pods): 264 nodes divide into 2, 3 and 8 shards; 265 = 4 * 66 + 1
# into none of them.  Both stay above the class route's 256-entry lists, so
# padding changes no list length and ordinals and sweeps agree too.
SNAPSHOTS = {"divisible": (264, 256), "padded": (265, 256)}
# pinned nodes: one in every shard of 2, 3 and 8 shards of either size (none
# is a tainted accelerator node, i % 5 == 0), and node-264, which exists only
# in the padded cluster
PIN_NODES = (16, 49, 82, 116, 148, 181, 214, 247, 264)


def pinned(types, workloads, n_nodes: int, n_pods: int):
    """workloads.heterogeneous(n_nodes, n_pods) with pod 1 + 11 k pinned to
    PIN_NODES[k] (spec.nodeName)."""
    snap = workloads.heterogeneous(n_nodes, n_pods)
    pods = list(snap.pending_pods)
    for k, node in enumerate(PIN_NODES):
        i = 1 + 11 * k
        pods[i] = dataclasses.replace(pods[i], node_name=f"node-{node}")
    return dataclasses.replace(snap, pending_pods=pods)


def main() -> None:
    out = sys.argv[1]
    for k, v in PINNED.items():
        if os.environ.get(k) != v:
            raise SystemExit(f"run with {k}={v}")
    sys.path.insert(0, os.path.dirname(HERE))
    from __graft_entry__ import force_cpu_platform

    force_cpu_platform(1)
    from kubernetes_tpu.api import types
    from kubernetes_tpu.api.delta import DeltaEncoder
    from kubernetes_tpu.bench import workloads
    from kubernetes_tpu.ops import DEFAULT_SCORE_CONFIG, infer_score_config
    from kubernetes_tpu.ops.assign import schedule_batch_ordinals_routed
    from kubernetes_tpu.ops.incremental import HoistCache

    res = {}
    for name, (n, p) in SNAPSHOTS.items():
        arr, meta = DeltaEncoder(bucket=False).encode(pinned(types, workloads, n, p))
        cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
        for mode in ("dense", "inc"):
            inc = HoistCache().ensure(arr, meta, cfg) if mode == "inc" else None
            c, u, o, s = schedule_batch_ordinals_routed(arr, cfg, donate=False, inc=inc)
            for field, x in (("choices", c), ("used", u), ("ordinals", o), ("sweeps", s)):
                res[f"{name}/{mode}/{field}"] = np.asarray(x)
    np.savez(out, **res)


if __name__ == "__main__":
    main()
